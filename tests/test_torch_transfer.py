"""The port's transfer layer (distributed_ddpg_tpu_torch/transfer/) against
the JAX package's (distributed_ddpg_tpu/transfer/), on the CPU.

- Parity: AdaptiveCoalesce fed one scripted observe_ship sequence takes
  the same cap trajectory in both packages; a TransferScheduler with items
  of every class queued before start() runs them in the same order in
  both (the lockstep lane first, in FIFO order, then byte-fair start-time
  fair queuing between ingest, prefetch and serve); the scheduler's,
  IngestStats' and the pool's snapshots carry JAX's keys.
- The semantics JAX's tests/test_transfer.py pins, on the port's classes:
  results and item failures land in tickets; the lockstep lane is FIFO and
  preempts; the fair queue's anti-starvation bound; a crash of the loop
  (JAX's FaultPlan site as the fault) recovers within the restart budget
  and raises TransferError past it; inline d2h is accounted; close() fails
  pending tickets; the adaptive cap grows on backlog and shrinks on a
  stall; the host pool recycles a buffer only once its fence has
  completed, and allocates when every pooled buffer was lost.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import metrics as jax_metrics
from distributed_ddpg_tpu.faults import FaultPlan, InjectedFault
from distributed_ddpg_tpu.transfer import AdaptiveCoalesce as JaxAdaptive
from distributed_ddpg_tpu.transfer import TransferScheduler as JaxScheduler
from distributed_ddpg_tpu_torch import metrics
from distributed_ddpg_tpu_torch.transfer import (
    AdaptiveCoalesce,
    HostBufferPool,
    TransferError,
    TransferScheduler,
)

torch.set_num_threads(1)


# --- parity with the JAX package ---------------------------------------------------


def test_adaptive_cap_trajectory_matches_jax():
    """One scripted sequence of (blocks, ship time, queue rows): backlog
    growth, a clamp at hi, stalls, idle ships, growth again."""
    rng = np.random.default_rng(0)
    script = [(1, 0.001, 640), (2, 0.002, 640), (4, 0.004, 640), (8, 0.008, 640),
              (8, 0.8, 640), (4, 0.004, 0), (4, 0.2, 0), (2, 0.002, 300)]
    for _ in range(40):
        k = int(2 ** rng.integers(0, 4))
        script.append((k, float(rng.choice([0.001, 0.003, 0.05])) * k,
                       int(rng.integers(0, 12)) * 64))
    for hi, lo in ((8, 1), (16, 2), (6, 1)):
        ours, theirs = AdaptiveCoalesce(hi=hi, block_size=64, lo=lo), JaxAdaptive(
            hi=hi, block_size=64, lo=lo)
        caps = []
        for blocks, ship_s, queue_rows in script:
            ours.observe_ship(blocks, ship_s, queue_rows)
            theirs.observe_ship(blocks, ship_s, queue_rows)
            caps.append((ours.cap(), theirs.cap()))
        assert [a for a, _ in caps] == [b for _, b in caps]
        assert ours.snapshot() == theirs.snapshot()
        assert len({a for a, _ in caps}) > 1


def _queue_mixed(sched, order):
    """Items of every queued class with uneven byte counts; each appends
    its label to `order` when it runs."""
    plan = [("ingest", 4096), ("prefetch", 1024), ("ingest", 512), ("serve", 2048),
            ("lockstep", 0), ("prefetch", 8192), ("serve", 16), ("ingest", 0),
            ("lockstep", 0), ("prefetch", 64), ("serve", 4096), ("ingest", 256),
            ("prefetch", 0), ("lockstep", 0), ("serve", 300), ("ingest", 1 << 20)]
    return [sched.submit(cls, lambda i=i, cls=cls: order.append(f"{cls}{i}"), nbytes=nb)
            for i, (cls, nb) in enumerate(plan)]


def test_prequeued_items_run_in_the_jax_schedulers_order():
    orders = []
    for cls in (TransferScheduler, JaxScheduler):
        order = []
        sched = cls()
        tickets = _queue_mixed(sched, order)
        sched.start()
        try:
            for t in tickets:
                t.result(timeout=10)
        finally:
            sched.close()
        orders.append(order)
    assert orders[0] == orders[1]
    assert orders[0][:3] == ["lockstep4", "lockstep8", "lockstep13"]


def test_snapshots_carry_the_jax_keys():
    ours, theirs = TransferScheduler().start(), JaxScheduler().start()
    try:
        for s in (ours, theirs):
            s.submit("ingest", lambda: 4096).result(timeout=5)
            s.run_inline("d2h", lambda: np.zeros(4, np.float32), nbytes_of=lambda r: r.nbytes)
        a, b = ours.snapshot(), theirs.snapshot()
        assert set(a) == set(b)
        assert {k: a[k] for k in a if not k.endswith(("_ms", "_p95"))} == \
            {k: b[k] for k in b if not k.endswith(("_ms", "_p95"))}
    finally:
        ours.close()
        theirs.close()
    assert set(metrics.IngestStats().snapshot()) == set(jax_metrics.IngestStats().snapshot())
    assert set(HostBufferPool(4).snapshot()) == {"transfer_pool_buffers",
                                                 "transfer_pool_fence_waits"}


# --- the scheduler's semantics --------------------------------------------------------


def test_submit_runs_and_returns_result():
    s = TransferScheduler().start()
    try:
        assert s.submit("ingest", lambda: 41 + 1).result(timeout=5) == 42
        snap = s.snapshot()
        assert snap["transfer_dispatches"] == 1 and snap["transfer_ingest_items"] == 1
        assert snap["transfer_ingest_bytes"] == 42   # an ingest item's int is its bytes
    finally:
        s.close()


def test_item_exception_fails_ticket_not_scheduler():
    s = TransferScheduler().start()
    try:
        with pytest.raises(ZeroDivisionError):
            s.submit("ingest", lambda: 1 / 0).result(timeout=5)
        assert s.submit("prefetch", lambda: "ok").result(timeout=5) == "ok"
        assert s.alive
    finally:
        s.close()


def test_lockstep_lane_is_fifo_and_preempts():
    s = TransferScheduler().start()
    order = []
    gate = threading.Event()
    try:
        s.submit("ingest", lambda: gate.wait(10))   # head of line: the rest queue
        for i in range(4):
            s.submit("ingest", lambda i=i: order.append(("ingest", i)))
        ticks = [s.submit("lockstep", lambda i=i: order.append(("beat", i)))
                 for i in range(3)]
        gate.set()
        for t in ticks:
            t.result(timeout=5)
        beats = [e for e in order if e[0] == "beat"]
        assert beats == [("beat", 0), ("beat", 1), ("beat", 2)]
        assert order[:3] == beats, order
    finally:
        s.close()


def test_fair_queue_anti_starvation():
    """Under a sustained flood of slow ingest items, a prefetch item waits
    about one in-flight item, not the flood."""
    item_s = 0.03
    s = TransferScheduler().start()
    try:
        stop = threading.Event()

        def slow_ingest():
            time.sleep(item_s)
            return 1 << 20

        def keep_flooding():
            for _ in range(200):
                if stop.is_set():
                    return
                while not stop.is_set() and s.queue_depths()["ingest"] >= 8:
                    time.sleep(0.002)
                s.submit("ingest", slow_ingest)

        flooder = threading.Thread(target=keep_flooding, daemon=True)
        flooder.start()
        time.sleep(5 * item_s)
        latencies = []
        for _ in range(5):
            t0 = time.perf_counter()
            s.submit("prefetch", lambda: time.sleep(item_s), nbytes=1 << 20).result(timeout=10)
            latencies.append(time.perf_counter() - t0)
            time.sleep(item_s)
        stop.set()
        flooder.join(timeout=5)
        # A FIFO behind an 8-deep flood would take ~9 items' time.
        assert max(latencies) < 6 * item_s, latencies
    finally:
        s.close()


def test_injected_crash_recovers_transparently_within_budget():
    plan = FaultPlan.parse("transfer:dispatch:crash@1", seed=0)
    s = TransferScheduler(fault=plan.site("transfer", "dispatch"), max_restarts=2).start()
    try:
        assert s.submit("prefetch", lambda: "ran").result(timeout=10) == "ran"
        assert s.restarts == 1 and s.alive
        assert s.submit("ingest", lambda: "more").result(timeout=5) == "more"
        assert s.snapshot()["transfer_restarts"] == 1
    finally:
        s.close()


def test_injected_crash_loop_exhausts_budget_then_transfer_error():
    plan = FaultPlan.parse("transfer:dispatch:crash@1;transfer:dispatch:crash@2;"
                           "transfer:dispatch:crash@3", seed=0)
    s = TransferScheduler(fault=plan.site("transfer", "dispatch"), max_restarts=2).start()
    try:
        t1 = s.submit("ingest", lambda: "never")
        with pytest.raises(InjectedFault):
            t1.result(timeout=10)
        assert s.restarts == 2
        deadline = time.monotonic() + 5
        while s.alive and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not s.alive
        with pytest.raises(TransferError):
            s.submit("ingest", lambda: "refused")
    finally:
        s.close()


def test_run_inline_accounts_d2h():
    s = TransferScheduler().start()
    try:
        out = s.run_inline("d2h", lambda: np.zeros(1024, np.float32),
                           nbytes_of=lambda r: r.nbytes, label="params_d2h")
        assert out.shape == (1024,)
        snap = s.snapshot()
        assert snap["transfer_d2h_items"] == 1 and snap["transfer_d2h_bytes"] == 4096
        assert snap["transfer_dispatches"] == 0
    finally:
        s.close()


def test_close_fails_pending_tickets():
    s = TransferScheduler().start()
    gate, started = threading.Event(), threading.Event()
    running = s.submit("ingest", lambda: (started.set(), gate.wait(10))[1])
    assert started.wait(5)
    t = s.submit("ingest", lambda: "queued")
    s.close(timeout=0.2)
    gate.set()
    with pytest.raises(TransferError):
        t.result(timeout=5)
    assert running.result(timeout=5) is True   # the item in flight ran to its end
    with pytest.raises(TransferError, match="closed"):
        s.submit("ingest", lambda: "late")


def test_unknown_class_is_refused():
    s = TransferScheduler()
    with pytest.raises(ValueError, match="unknown transfer class"):
        s.submit("shard_exchange", lambda: None)


# --- the adaptive cap ----------------------------------------------------------------


def test_adaptive_grows_on_backlog_and_shrinks_on_stall():
    c = AdaptiveCoalesce(hi=8, block_size=64)
    assert c.cap() == 1
    c.observe_ship(1, 0.001, queue_rows=10 * 64)
    assert c.cap() == 2
    c.observe_ship(2, 0.002, queue_rows=10 * 64)
    c.observe_ship(4, 0.004, queue_rows=10 * 64)
    assert c.cap() == 8
    c.observe_ship(8, 0.008, queue_rows=10 * 64)
    assert c.cap() == 8   # clamped at hi
    c.observe_ship(8, 8 * 0.1, queue_rows=10 * 64)
    assert c.cap() == 4
    assert c.grows == 3 and c.shrinks == 1
    for _ in range(5):    # an idle queue keeps the cap
        c.observe_ship(1, 0.001, queue_rows=0)
    assert c.snapshot() == {"transfer_coalesce_cap": 4, "transfer_coalesce_grows": 3,
                            "transfer_coalesce_shrinks": 1}


# --- the host buffer pool -----------------------------------------------------------


class _Fence:
    """A fence that completes when `ev` is set (the port's fences are
    torch.cuda.Event, whose synchronize() blocks until the insert ran)."""

    def __init__(self):
        self.ev = threading.Event()
        self.waited = False

    def synchronize(self):
        self.waited = True
        assert self.ev.wait(5)


def test_host_pool_recycles_after_fence():
    pool = HostBufferPool(width=4, depth=2)
    a = pool.acquire(8)
    b = pool.acquire(8)
    assert a is not b and pool.allocations == 2
    assert a.shape == (8, 4) and a.dtype == np.float32
    fence = _Fence()
    pool.commit(a, fence)
    got = []
    waiter = threading.Thread(target=lambda: got.append(pool.acquire(8)))
    waiter.start()
    time.sleep(0.1)
    assert not got and fence.waited   # at depth: blocked on the oldest fence
    fence.ev.set()
    waiter.join(timeout=5)
    assert got[0] is a and pool.allocations == 2
    pool.commit(b, None)
    assert pool.acquire(8) is b
    d = pool.acquire(16)              # another shape pools on its own
    assert d.shape == (16, 4) and pool.allocations == 3
    assert pool.snapshot() == {"transfer_pool_buffers": 3, "transfer_pool_fence_waits": 1}


def test_host_pool_allocates_when_every_buffer_was_lost():
    pool = HostBufferPool(width=2, depth=1)
    pool.acquire(4)                   # never committed (a failed ship)
    again = pool.acquire(4)           # nothing in flight to wait on: allocate
    assert again.shape == (4, 2) and pool.allocations == 2
    with pytest.raises(ValueError):
        HostBufferPool(width=2, depth=0)
