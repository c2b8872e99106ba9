"""The port's pod layer (parallel/multihost.py, the pod beat of
replay/device.py, the lockstep lane of transfer/scheduler.py) against the
JAX package's, on the CPU.

- Parity on the same inputs, through both packages where the JAX function
  is stdlib or numpy: the deadline cases of tests/test_pod.py (the short
  circuit, the raise at the deadline, an explicit override, a propagated
  exception, the near-miss and slack records, the grant), the resume
  election's rule (_common_step, and elect_resume_step without a pod),
  the pod fault specs parsed and scoped to a process with the same
  validation errors, PodStats' snapshot, the three pod config fields'
  defaults, checks and messages, checkpoint.valid_steps on one directory,
  detect_straggler and PodAggregator on the same gathered matrices, and
  the config field left to refuse (model_axis).
- The port's own: _parse_peer on gloo's and NCCL's error texts, the latch
  after a failed pod collective, end_grant, the backend variable, the
  group's derived timeout; the lockstep lane: a ticket fails at its
  deadline and the lane goes on, a zero timeout pays no wrapper, queued
  tickets fail on abort.
- Two (and four) gloo processes (tests/torch_pod_child.py): the same
  per-node row blocks through the synchronous beat, the background beat
  (the scheduler's lockstep lane) and the forced beat land every rank's
  ring exactly as the JAX replay's _sync_ship_collective lays them out
  (written out in numpy below from distributed_ddpg_tpu/replay/device.py
  :953-1045), uniform and PER, across a wrap, on two nodes of one rank and
  on two nodes of two ranks; and with one node the group has no pod and
  the ring is the one-node group's share_rows ring.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import checkpoint as jax_ckpt
from distributed_ddpg_tpu import faults as jax_faults
from distributed_ddpg_tpu import metrics as jax_metrics
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.obs import aggregate as jax_aggregate
from distributed_ddpg_tpu.parallel import multihost as jax_multihost
from distributed_ddpg_tpu_torch import checkpoint as ckpt
from distributed_ddpg_tpu_torch import config as config_mod
from distributed_ddpg_tpu_torch import faults, metrics
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.obs import aggregate
from distributed_ddpg_tpu_torch.parallel import multihost
from distributed_ddpg_tpu_torch.transfer import TransferError, TransferScheduler

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_pod_child import WIDTH, node_rows  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_pod_child.py")
RANK_TIMEOUT_S = 40.0

BOTH = {
    "jax": (jax_multihost, jax_metrics.PodStats),
    "torch": (multihost, metrics.PodStats),
}


@pytest.fixture(autouse=True)
def _healthy_singletons():
    """A declared peer loss notes `pod_peer_lost` in the process's health
    state (both packages'); reset it around each test, so no later test in
    this process reads a degraded /healthz."""
    from distributed_ddpg_tpu.obs import health as jax_health
    from distributed_ddpg_tpu_torch.obs import health

    health.get().reset()
    jax_health.get().reset()
    yield
    health.get().reset()
    jax_health.get().reset()


@pytest.fixture(params=sorted(BOTH))
def mh(request):
    mod, stats_cls = BOTH[request.param]
    mod.configure_pod(0.0)
    yield mod, stats_cls
    mod.configure_pod(0.0)


# --------------------------------------------------------------------------
# the deadline (tests/test_pod.py:48-131), through both packages
# --------------------------------------------------------------------------


def test_deadline_unconfigured_short_circuits_on_caller_thread(mh):
    mod, _ = mh
    seen = []
    before = threading.active_count()
    assert mod.call_with_deadline(lambda: seen.append(threading.get_ident()) or 42) == 42
    assert seen == [threading.get_ident()]
    assert threading.active_count() == before


def test_hung_fake_collective_raises_pod_peer_lost_at_deadline(mh):
    mod, stats_cls = mh
    stats = stats_cls()
    mod.configure_pod(0.3, stats=stats)
    t0 = time.monotonic()
    with pytest.raises(mod.PodPeerLost) as err:
        mod.call_with_deadline(lambda: time.sleep(10), label="fake_allgather")
    elapsed = time.monotonic() - t0
    assert 0.25 <= elapsed < 5.0, elapsed
    assert err.value.reason == "timeout" and err.value.peer is None
    assert "fake_allgather" in str(err.value)
    assert stats.peer_lost == 1


def test_deadline_explicit_timeout_overrides_default(mh):
    mod, _ = mh
    mod.configure_pod(0.1)
    assert mod.call_with_deadline(lambda: "ok", timeout_s=0) == "ok"
    with pytest.raises(mod.PodPeerLost):
        mod.call_with_deadline(lambda: time.sleep(5), timeout_s=0.2)


def test_deadline_propagates_fn_exception(mh):
    mod, _ = mh
    mod.configure_pod(5.0)
    with pytest.raises(ZeroDivisionError):
        mod.call_with_deadline(lambda: 1 / 0)


def test_deadline_records_near_miss_and_slack(mh):
    mod, stats_cls = mh
    stats = stats_cls()
    mod.configure_pod(0.2, stats=stats)
    mod.call_with_deadline(lambda: time.sleep(0.18))
    mod.call_with_deadline(lambda: None)
    snap = stats.snapshot()
    assert snap["pod_collective_near_misses"] == 1
    assert snap["pod_collective_slack_p95_ms"] > 0
    assert snap["pod_peer_lost"] == 0


def test_grant_extends_deadline_window(mh):
    mod, _ = mh
    mod.configure_pod(0.2)
    mod.grant(5.0)
    assert mod.call_with_deadline(lambda: time.sleep(0.4) or "late-but-fine") == "late-but-fine"
    assert mod.beat_result_timeout_s() > 2 * 0.2 + 30.0
    mod.configure_pod(0.0)
    assert mod.beat_result_timeout_s() == 600.0


def test_end_grant_ends_the_window():
    multihost.configure_pod(0.2)
    try:
        multihost.grant(5.0)
        multihost.end_grant()
        with pytest.raises(multihost.PodPeerLost):
            multihost.call_with_deadline(lambda: time.sleep(2))
    finally:
        multihost.configure_pod(0.0)


def test_a_failed_pod_collective_latches_every_later_gather():
    """Once one pod collective failed, a later gather raises at once without
    touching the transport (its peer is gone); configure_pod clears it."""
    multihost.configure_pod(0.2)
    try:
        with pytest.raises(multihost.PodPeerLost):
            multihost.call_with_deadline(lambda: time.sleep(3), label="beat")
        t0 = time.monotonic()
        with pytest.raises(multihost.PodPeerLost, match="earlier pod collective"):
            multihost.allgather_scalar(np.int64(3), label="env_steps_allgather")
        assert time.monotonic() - t0 < 0.1
    finally:
        multihost.configure_pod(0.0)
    assert multihost.allgather_scalar(np.int64(3)).tolist() == [3]


def test_parse_peer_on_gloo_and_nccl_texts():
    for mod in (multihost, jax_multihost):
        assert mod._parse_peer("coordination service: task 2 failed") == 2
        assert mod._parse_peer("Peer rank 1 closed connection") == 1
        assert mod._parse_peer("connection reset") is None
    cases = {
        # gloo names a dead peer by address only.
        "[gloo/transport/tcp/pair.cc:553] Connection closed by peer [127.0.0.1]:7359. This "
        "is typically caused by a remote worker crashing.": None,
        "[gloo/transport/tcp/unbound_buffer.cc:81] Timed out waiting 5000ms for recv "
        "operation to complete": None,
        # NCCL's watchdog names the reporting rank, not the peer.
        "[Rank 0] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=9, "
        "OpType=ALLREDUCE, NumelIn=1)": None,
        "NCCL error: remote process exited or there was a network error; peer rank 3": 3,
        "[Rank 1] ProcessGroupNCCL: failed to recv from rank: 0": 0,
    }
    for text, want in cases.items():
        assert multihost._parse_peer(text) == want, text


# --------------------------------------------------------------------------
# the election, without a pod and as a rule
# --------------------------------------------------------------------------


ELECTIONS = [
    ([[100, 200, 300, -1], [200, 300, 400, -1], [0, 200, 300, -1]], 300),
    ([[100, -1], [200, -1]], -1),
    ([[100, 200], [-1, -1]], -1),
    ([[7, 9, -1]], 9),
    ([[5, 6, 7], [7, 6, 5]], 7),
]


@pytest.mark.parametrize("gathered,want", ELECTIONS)
def test_common_step_matches_jax(gathered, want):
    assert multihost._common_step(gathered) == jax_multihost._common_step(gathered) == want


@pytest.mark.parametrize("steps", [[], [3], [40, 10, 20], list(range(0, 1000, 40))])
def test_elect_resume_step_on_one_process_matches_jax(steps):
    ours = multihost.elect_resume_step(steps)
    theirs = jax_multihost.elect_resume_step(steps)
    assert ours == theirs == (max(steps) if steps else -1)


# --------------------------------------------------------------------------
# fault specs, stats, config, checkpoints, aggregation
# --------------------------------------------------------------------------


POD_SPECS = ["pod:1:kill@6", "pod:0:hang@2~60", "pod:0:hang@1", "pod:3:slow@4",
             "pod:2:slow@5~0.5", "pod:1:exit@12:77", "pod:0:exit@3:0"]


@pytest.mark.parametrize("seed", [0, 5])
def test_pod_fault_specs_parse_and_scope_as_jax(seed):
    text = ";".join(POD_SPECS)
    ours, theirs = faults.FaultPlan.parse(text, seed=seed), \
        jax_faults.FaultPlan.parse(text, seed=seed)
    assert [dataclasses.astuple(s) for s in ours.specs] == \
        [dataclasses.astuple(s) for s in theirs.specs]
    assert [s.describe() for s in ours.specs] == [s.describe() for s in theirs.specs]
    for proc in range(5):
        assert bool(ours.pod_site(proc)) == bool(theirs.pod_site(proc))
        assert ours.pod_site(proc).target == theirs.pod_site(proc).target == str(proc)
    assert [s.duration_s for s in faults.FaultPlan.parse("pod:0:hang@1").specs] == [3600.0]
    assert DDPGConfig(faults="pod:1:kill@40").fault_plan().pod_site(1)


@pytest.mark.parametrize("spec", ["pod:x:kill@5", "worker:1:kill@5", "pod:0:ioerror@5",
                                  "pod:0:exit@3", "pod:0:exit@3:256", "pod:0:exit@3:x",
                                  "pod:0:kill@0", "pod:0:hang@2~-1"])
def test_pod_fault_spec_validation_matches_jax(spec):
    with pytest.raises(ValueError) as theirs:
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as ours:
        faults.FaultPlan.parse(spec)
    assert str(ours.value) == str(theirs.value)


def test_pod_fault_hang_sleeps_at_beat_ordinal():
    site = faults.FaultPlan.parse("pod:0:hang@2~0.2").pod_site(0)
    t0 = time.monotonic()
    site.tick()
    assert time.monotonic() - t0 < 0.1
    site.tick()
    assert time.monotonic() - t0 >= 0.2
    assert site.fired == ["pod:0:hang@2"]


def test_pod_stats_snapshot_matches_jax():
    ours, theirs = metrics.PodStats(seed=3), jax_metrics.PodStats(seed=3)
    for s in (ours, theirs):
        s.record_peer_lost()
        s.record_abort()
        s.record_resume_elected(120)
        s.note_beat()
        s.record_straggler(1)
        s.record_collective(0.05, 1.0)
        s.record_collective(0.9, 1.0)
    assert ours.snapshot() == theirs.snapshot()
    snap = ours.snapshot()
    assert (snap["pod_peer_lost"], snap["pod_aborts"], snap["pod_resume_step_elected"],
            snap["pod_beats"], snap["pod_collective_near_misses"]) == (1, 1, 120, 1, 1)


POD_FIELDS = ("sync_ship_background", "pod_collective_timeout_s", "pod_startup_grace_s")


def test_pod_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(DDPGConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert {k: ours[k] for k in POD_FIELDS} == {k: theirs[k] for k in POD_FIELDS} == {
        "sync_ship_background": True, "pod_collective_timeout_s": 60.0,
        "pod_startup_grace_s": 300.0}
    for bad in (dict(pod_collective_timeout_s=-1.0), dict(pod_startup_grace_s=-1.0)):
        with pytest.raises(ValueError) as theirs_err:
            JaxConfig(**bad)
        with pytest.raises(ValueError) as ours_err:
            DDPGConfig(**bad)
        assert str(ours_err.value) == str(theirs_err.value)
    assert DDPGConfig(pod_collective_timeout_s=0.0).pod_collective_timeout_s == 0.0
    cfg = DDPGConfig.from_flags(["--sync_ship_background=false", "--pod_collective_timeout_s=8",
                                 "--pod_startup_grace_s=30"])
    assert (cfg.sync_ship_background, cfg.pod_collective_timeout_s,
            cfg.pod_startup_grace_s) == (False, 8.0, 30.0)


def test_only_the_data_plane_fields_are_refused():
    """Every JAX config field is the port's now, model_axis included (the
    tensor-parallel learner), and nothing is refused under model_axis > 1
    that the JAX config takes: serving on a grid runs (the name is kept
    from when it was refused). The sharded replay and its `slice` faults
    are accepted."""
    ours = {f.name for f in dataclasses.fields(DDPGConfig)}
    theirs = {f.name for f in dataclasses.fields(JaxConfig)}
    assert theirs - ours == set()
    assert not hasattr(config_mod, "_NOT_IN_SLICE")
    assert DDPGConfig(model_axis=2).model_axis == 2
    assert DDPGConfig(model_axis=2, serve_actors=True).serve_actors is True
    JaxConfig(model_axis=2, serve_actors=True)
    assert DDPGConfig(replay_sharding="sharded").replay_sharding == "sharded"
    assert [s.describe() for s in faults.FaultPlan.parse("slice:1:corrupt@2").specs] == \
        ["slice:1:corrupt@2"]


def _fake_checkpoint(directory, step: int, payload: bytes) -> None:
    root = os.path.join(directory, f"step_{step}")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "data.bin"), "wb") as f:
        f.write(payload)
    jax_ckpt._write_manifest(directory, step)


def test_valid_steps_match_jax(tmp_path):
    d = str(tmp_path)
    for step, payload in ((10, b"aaaa"), (30, b"bbbb"), (20, b"cccc")):
        _fake_checkpoint(d, step, payload)
    for limit in (None, 1, 2, 5):
        assert ckpt.valid_steps(d, limit) == jax_ckpt.valid_steps(d, limit)
    assert ckpt.valid_steps(d) == [10, 20, 30]
    with open(os.path.join(d, "step_20", "data.bin"), "wb") as f:
        f.write(b"XXXXXXXX")
    assert ckpt.valid_steps(d) == jax_ckpt.valid_steps(d) == [10, 30]
    assert ckpt.valid_steps(d, limit=1) == jax_ckpt.valid_steps(d, limit=1) == [30]
    assert ckpt.valid_steps(str(tmp_path / "missing")) == []
    assert ckpt.valid_steps("") == []
    assert ckpt.pod_dir(d, 0) == d and ckpt.pod_dir(d, 2) == os.path.join(d, "proc2")


STRAGGLER_CASES = [[10.0, 30.0], [10.0, 12.0], [10.0, 10.0, 10.0, 50.0], [1.0, 2.0, 3.0],
                   [5.0], [20.0, 10.0, 11.0, 10.5, 10.2], [0.0, 4.0], [100.0, 100.0, 400.0]]


@pytest.mark.parametrize("beat_ms", STRAGGLER_CASES)
def test_detect_straggler_matches_jax(beat_ms):
    assert aggregate.detect_straggler(beat_ms) == jax_aggregate.detect_straggler(beat_ms)


def test_pod_aggregator_matches_jax():
    rng = np.random.default_rng(0)
    for hosts in (1, 2, 4):
        gathered = rng.integers(0, 10**7, size=(hosts, aggregate.SLOTS)).astype(np.int64)
        gathered[-1, aggregate.SLOT_BEAT_MS] = 10**8   # a straggler
        records, stats = [], []
        for agg_mod, stats_cls in ((aggregate, metrics.PodStats),
                                   (jax_aggregate, jax_metrics.PodStats)):
            s = stats_cls()
            agg = agg_mod.PodAggregator(gather_fn=lambda vec, g=gathered: g, stats=s)
            records.append(agg.collect(beats=10, ingest_rows=1000, transfer_backlog=2))
            stats.append(s.snapshot())
        assert records[0] == records[1]
        assert stats[0] == stats[1]
        if hosts > 1:
            assert records[0]["pod_agg_hosts"] == hosts
            assert records[0]["pod_straggler_host"] == hosts - 1
        else:
            assert records[0] is None


def test_pod_record_is_gauges_on_metrics():
    """The pod record (node 0 logs it on each cadence) is the exporter's
    ddpg_pod_* gauges, as the JAX exporter renders it."""
    from distributed_ddpg_tpu.obs.exporter import render_prometheus as jax_render
    from distributed_ddpg_tpu_torch.obs.exporter import render_prometheus

    agg = aggregate.PodAggregator(gather_fn=lambda vec: np.stack([vec, vec * 3]))
    record = agg.collect(beats=5, ingest_rows=500, transfer_backlog=1)
    latest = {"pod": {"kind": "pod", "step": 7, **record},
              "train": {"kind": "train", "step": 7, **metrics.PodStats().snapshot()}}
    ours, theirs = render_prometheus(latest), jax_render(latest)
    assert ours == theirs
    for name in ("ddpg_pod_beat_ms_max{kind=\"pod\"}", "ddpg_pod_agg_hosts{kind=\"pod\"} 2",
                 "ddpg_pod_straggler_host{kind=\"pod\"}", "ddpg_pod_peer_lost{kind=\"train\"} 0"):
        assert name in ours, name


def test_drain_for_pod_exit_latches_draining_with_the_reasons():
    from distributed_ddpg_tpu_torch import train
    from distributed_ddpg_tpu_torch.obs import health

    health.get().reset()
    try:
        health.get().note("pod_peer_lost:sync_ship_beat")
        train.drain_for_pod_exit(76)
        state, reasons = health.get().state()
        assert state == "draining" and any("pod_peer_lost" in r for r in reasons)
        health.get().reset()
        train.drain_for_pod_exit(76)
        assert health.get().state() == ("draining", ["pod abort (exit 76)"])
    finally:
        health.get().reset()


def test_pod_env_steps_counts_the_resumed_offset_once():
    from distributed_ddpg_tpu_torch.train import pod_env_steps

    assert pod_env_steps(3000, np.array([1000, 2500])) == 6500
    assert pod_env_steps(0, np.array([7])) == 7
    # The JAX trainer's sum over processes of (offset + own count) would
    # give 2 x 3000 + 3500 here: the port's deviation (ROADMAP.md Queue 3).
    assert sum(3000 + r for r in (1000, 2500)) == 9500 != pod_env_steps(3000, [1000, 2500])


def test_each_node_serves_its_exporter_on_obs_port_plus_its_index():
    import socket
    import threading
    import types

    from distributed_ddpg_tpu_torch.metrics import MetricsLogger
    from distributed_ddpg_tpu_torch.train import start_exporter

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
    group = types.SimpleNamespace(is_pod=True, process_index=1, process_count=2)
    log = MetricsLogger("", echo=False)
    server = start_exporter(DDPGConfig(obs_port=base - 1), log, threading.Event(), group)
    try:
        assert server is not None and server.port == base
    finally:
        if server is not None:
            server.stop()
        log.close()


# --------------------------------------------------------------------------
# the backend variable, the group's timeout
# --------------------------------------------------------------------------


def test_backend_variable(monkeypatch):
    monkeypatch.delenv(multihost.BACKEND_ENV, raising=False)
    assert multihost.resolve_backend("cuda") == "nccl"
    assert multihost.resolve_backend("cpu") == "gloo"
    monkeypatch.setenv(multihost.BACKEND_ENV, "gloo")
    assert multihost.resolve_backend("cuda") == "gloo"
    monkeypatch.setenv(multihost.BACKEND_ENV, "NCCL")
    assert multihost.resolve_backend("cpu") == "nccl"
    monkeypatch.setenv(multihost.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="DDPG_DIST_BACKEND"):
        multihost.resolve_backend("cuda")


def test_group_timeout_is_the_deadline_plus_grace(monkeypatch):
    from distributed_ddpg_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    assert multihost.group_timeout_s(60.0, 300.0) == 480.0
    assert multihost.group_timeout_s(8.0, 20.0) == 148.0
    assert multihost.group_timeout_s(0.0, 300.0) == DEFAULT_TIMEOUT_S
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize("cpu", 8.0, 20.0) is None


# --------------------------------------------------------------------------
# the lockstep lane (tests/test_pod.py's three cases)
# --------------------------------------------------------------------------


def test_lockstep_ticket_fails_at_deadline_not_hangs():
    s = TransferScheduler(lockstep_timeout_s=0.3).start()
    try:
        t0 = time.monotonic()
        ticket = s.submit("lockstep", lambda: time.sleep(10), label="beat_1")
        with pytest.raises(multihost.PodPeerLost):
            ticket.result(timeout=10)
        assert time.monotonic() - t0 < 5.0
        assert s.alive
        assert s.submit("lockstep", lambda: "ok").result(timeout=5) == "ok"
        assert s.submit("ingest", lambda: time.sleep(0.5) or 7).result(timeout=5) == 7
    finally:
        s.close()
        multihost.configure_pod(0.0)


def test_lockstep_zero_timeout_pays_no_wrapper():
    s = TransferScheduler().start()
    try:
        # Threads of earlier tests may end meanwhile: what counts is that
        # no thread is started for the item (a deadline wrapper's helper
        # would be alive while the item runs).
        before = set(threading.enumerate())
        seen, started = [], []
        assert s.submit("lockstep", lambda: seen.append(threading.current_thread().name)
                        or started.extend(set(threading.enumerate()) - before)
                        or time.sleep(0.2) or "slow-ok").result(timeout=5) == "slow-ok"
        assert seen == ["transfer-sched"]   # on the lane's own thread, no helper
        assert started == []
    finally:
        s.close()


def test_queued_lockstep_tickets_fail_on_abort():
    s = TransferScheduler().start()
    gate = threading.Event()
    s.submit("lockstep", lambda: gate.wait(10))
    queued = s.submit("lockstep", lambda: "stale beat")
    s.close(timeout=0.2)
    gate.set()
    with pytest.raises(TransferError):
        queued.result(timeout=5)


# --------------------------------------------------------------------------
# the beat, over gloo processes
# --------------------------------------------------------------------------


BLOCK, CAPACITY, COALESCE, SEED = 8, 128, 4, 11
# (rows each node stages, forced?) a beat. The first two nodes' counts;
# more nodes repeat them. Counts differ, so the common minimum moves
# blocks out of order of the staging; the 1st forced beat pads from
# both nodes' remainders; over 400 rows land in a 128-row ring.
SCHEDULE = [((20, 13), False), ((30, 40), False), ((3, 0), True), ((50, 70), False),
            ((9, 2), True), ((33, 21), False), ((70, 66), False), ((1, 17), True)]


def jax_layout(schedule, procs: int, background: bool):
    """The ring that the JAX replay's _sync_ship_collective leaves for this
    schedule (distributed_ddpg_tpu/replay/device.py:953-1045): each beat
    ships the nodes' common minimum of full blocks, k at a time (the
    largest power of two <= min(remaining, max_coalesce, capacity //
    (procs * bs))), node p's block j, row r at ptr + j*(procs*bs) + p*bs
    + r; a forced beat pads each node's remainder (min(count - moved, bs)
    rows) by repetition to one block. A background step takes two beats
    (the child issues two), the second shipping what the first left."""
    storage = np.zeros((CAPACITY, WIDTH), np.float32)
    ptr, size = 0, 0
    queues = [np.zeros((0, WIDTH), np.float32) for _ in range(procs)]

    def land(block):
        nonlocal ptr, size
        idx = (ptr + np.arange(len(block))) % CAPACITY
        storage[idx] = block
        ptr = (ptr + len(block)) % CAPACITY
        size = min(size + len(block), CAPACITY)

    cap_blocks = CAPACITY // (procs * BLOCK)
    for step, (counts, force) in enumerate(schedule):
        for p in range(procs):
            queues[p] = np.concatenate([queues[p], node_rows(SEED, p, step, counts[p % 2])])
        for _ in range(2 if background and not force else 1):
            count = [len(q) for q in queues]
            m = min(count)
            remaining, moved = m // BLOCK, 0
            while remaining:
                k = min(remaining, COALESCE, max(1, cap_blocks))
                k = 1 << (k.bit_length() - 1)
                local = [q[:k * BLOCK] for q in queues]
                queues = [q[k * BLOCK:] for q in queues]
                block = np.zeros((procs * k * BLOCK, WIDTH), np.float32)
                for p in range(procs):
                    for j in range(k):
                        for r in range(BLOCK):
                            block[j * (procs * BLOCK) + p * BLOCK + r] = local[p][j * BLOCK + r]
                land(block)
                moved += k * BLOCK
                remaining -= k
            if force and m % BLOCK:
                parts = []
                for p in range(procs):
                    take = min(count[p] - moved, BLOCK)
                    rows, queues[p] = queues[p][:take], queues[p][take:]
                    parts.append(np.tile(rows, (-(-BLOCK // take), 1))[:BLOCK])
                land(np.concatenate(parts))
    return storage, ptr, size


def run_pod(tmp_path, spec, nodes: int, ranks_per_node: int = 1, name: str = "job"):
    """The spec on nodes x ranks_per_node gloo processes (torch_pod_child.py),
    each with its node in its environment; returns each rank's results."""
    world = nodes * ranks_per_node
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, spec=np.array(json.dumps(spec)))
    init = "file://" + str(tmp_path / f"{name}.rendezvous")
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for key in ("GROUP_RANK", "GROUP_WORLD_SIZE", "LOCAL_RANK"):
            env.pop(key, None)
        if nodes > 1:
            env.update(GROUP_RANK=str(r // ranks_per_node), GROUP_WORLD_SIZE=str(nodes),
                       LOCAL_RANK=str(r % ranks_per_node))
        logs.append(tmp_path / f"{name}.rank{r}.log")
        with open(logs[-1], "wb") as out:
            procs.append(subprocess.Popen([sys.executable, CHILD, path, str(r), str(world), init],
                                          stdout=out, stderr=subprocess.STDOUT, env=env,
                                          cwd=str(tmp_path)))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log.read_text()[-4000:]}"
    return [dict(np.load(path[:-len(".npz")] + f".rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("mode", ["synchronous", "background"])
@pytest.mark.parametrize("per", [False, True])
def test_beats_land_jax_interleaved_layout(mode, per, tmp_path):
    spec = dict(kind="beat", mode=mode, per=per, capacity=CAPACITY, block_size=BLOCK,
                max_coalesce=COALESCE, seed=SEED, schedule=SCHEDULE)
    outs = run_pod(tmp_path, spec, nodes=2)
    want, ptr, size = jax_layout(SCHEDULE, 2, background=mode == "background")
    assert size == CAPACITY and sum(c[0] + c[1] for c, _ in SCHEDULE) > 3 * CAPACITY
    for node, out in enumerate(outs):
        np.testing.assert_array_equal(out["storage"], want)
        assert (int(out["ptr"]), int(out["size"])) == (ptr, size)
        assert int(out["node"]) == node and bool(out["node_lead"])
        if per:
            # Every landed row stamped with the max priority (1 here).
            np.testing.assert_array_equal(out["priorities"], np.ones(CAPACITY, np.float32))
    # Each node's rows were shipped or are still staged, none twice.
    for node, out in enumerate(outs):
        staged = sum(c[node] for c, _ in SCHEDULE)
        assert int(out["shipped"].sum()) + int(out["pending"]) == staged


def test_beats_on_two_nodes_of_two_ranks(tmp_path):
    """Four ranks, two a node: each node's lead stages its node's rows, the
    other rank stages nothing, and all four rings hold the two-node
    layout."""
    spec = dict(kind="beat", mode="synchronous", per=False, capacity=CAPACITY,
                block_size=BLOCK, max_coalesce=COALESCE, seed=SEED, schedule=SCHEDULE)
    outs = run_pod(tmp_path, spec, nodes=2, ranks_per_node=2)
    want, ptr, size = jax_layout(SCHEDULE, 2, background=False)
    assert [bool(o["node_lead"]) for o in outs] == [True, False, True, False]
    assert [int(o["node"]) for o in outs] == [0, 0, 1, 1]
    assert outs[0]["lead_ranks"].tolist() == [0, 2]
    for out in outs:
        np.testing.assert_array_equal(out["storage"], want)
        assert (int(out["ptr"]), int(out["size"])) == (ptr, size)


def test_one_node_keeps_the_share_rows_ring(tmp_path):
    """With one node (no GROUP_WORLD_SIZE) the group has no pod, and two
    ranks' rings are rank 0's rows shared and shipped in order, padded at
    the end: what one DeviceReplay fed the same rows holds."""
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    counts = [20, 13, 30, 40, 3, 50]
    spec = dict(kind="onenode", capacity=CAPACITY, block_size=BLOCK, seed=SEED, counts=counts)
    outs = run_pod(tmp_path, spec, nodes=1, ranks_per_node=2)
    rep = DeviceReplay(CAPACITY, 3, 1, "cpu", block_size=BLOCK)
    for step, n in enumerate(counts):
        rep.add_packed(node_rows(SEED, 0, step, n))
    rep.flush()
    for out in outs:
        assert int(out["process_count"]) == 1 and not bool(out["pod"])
        np.testing.assert_array_equal(out["storage"], rep.storage.numpy())
        assert (int(out["ptr"]), int(out["size"])) == (rep.ptr, rep.size)
    assert [bool(o["node_lead"]) for o in outs] == [True, False]


@pytest.mark.parametrize("force", [False, True])
def test_sync_ship_on_one_process_matches_jax(force):
    """Without a pod sync_ship degrades to the add_packed/flush fast path,
    as JAX's does (distributed_ddpg_tpu/replay/device.py:897-903): every
    full block ships (add_packed already shipped them inline here) and,
    with `force`, the remainder is flushed padded. The rows moved, the ring and the rows left staged equal JAX's
    DeviceReplay.sync_ship on the same rows."""
    from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxDeviceReplay
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    rows = node_rows(SEED, 0, 0, 2 * BLOCK + 3)
    rep = DeviceReplay(CAPACITY, 3, 1, "cpu", block_size=BLOCK)
    ref = JaxDeviceReplay(CAPACITY, 3, 1, block_size=BLOCK, async_ship=False)
    rep.add_packed(rows)
    ref.add_packed(rows)
    moved, ref_moved = rep.sync_ship(force=force), ref.sync_ship(force=force)
    assert moved == ref_moved == (3 if force else 0)
    np.testing.assert_array_equal(rep.storage.numpy(), np.asarray(ref.storage))
    assert (rep.ptr, rep.size) == (int(ref.ptr), int(ref.size))
    assert rep.pending_rows == ref.pending_rows == (0 if force else 3)


def test_sync_ship_begin_without_background_sync_raises_usage_error():
    """sync_ship_begin without background_sync raises JAX's ReplayUsageError
    (distributed_ddpg_tpu/replay/device.py:937-941), still a RuntimeError."""
    from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxDeviceReplay
    from distributed_ddpg_tpu.replay.device import ReplayUsageError as JaxUsageError
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay, ReplayUsageError

    rep = DeviceReplay(CAPACITY, 3, 1, "cpu", block_size=BLOCK)
    with pytest.raises(ReplayUsageError, match="needs background_sync=True") as ours:
        rep.sync_ship_begin()
    with pytest.raises(JaxUsageError) as theirs:
        JaxDeviceReplay(CAPACITY, 3, 1, block_size=BLOCK, async_ship=False).sync_ship_begin()
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, RuntimeError)
