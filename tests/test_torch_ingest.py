"""The port's ingest pipeline and shm transport against the JAX package's,
on the CPU.

- The same seeded ragged inflow (sub-block trickles, exact blocks,
  multi-block bursts, enough to wrap the ring) goes through JAX's
  DeviceReplay / DevicePrioritizedReplay with async_ship=True, a
  TransferScheduler, adaptive_coalesce=True and host_pool=True, and
  through the port's with the same settings (and through the port's
  private shipper, no scheduler). After drain_pending() and flush() the
  storage, ptr, size, priorities and max priority are bit-identical, and
  bit-identical to the port's serial run (max_coalesce=1); so are they
  under an adversarial cap sequence.
- ingest_snapshot() carries JAX's ingest_* keys (the JAX package adds its
  replay_* placement fields, sharded replay's, which the port lacks).
- The semantics JAX's tests/test_ingest_pipeline.py pins: staged rows in
  reward_sample, the ingest counters, shipper death and a failing
  scheduler item raising IngestError after the bounded restarts, close()
  falling back to inline shipping; the staging ring's pop_into and
  peek_cols against JAX's.
- The port's ShmRing against JAX's native.ShmRing on one shared block
  (each pushes, the other pops: the same rows; both wrap and accept part
  of a batch into a full ring alike), and the actor pool on shm (a
  spawned producer, killed and respawned onto its slot's ring) in a child
  process.
- The flags: the JAX package's names, defaults and checks.
- train() on the CPU in a child process: the default flags end on shm with
  the shipper on and the ingest_* and transfer_* fields; the old
  pipeline's flags still run; --max_ingest_ratio caps the env steps.
"""

import math
import multiprocessing as mp
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import native as jax_native
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.replay.device import DevicePrioritizedReplay as JaxPerReplay
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from distributed_ddpg_tpu.replay.staging import HostStagingRing as JaxStagingRing
from distributed_ddpg_tpu.transfer import TransferScheduler as JaxScheduler
from distributed_ddpg_tpu_torch import native
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.replay.device import (
    DevicePrioritizedReplay,
    DeviceReplay,
    IngestError,
)
from distributed_ddpg_tpu_torch.replay.staging import HostStagingRing
from distributed_ddpg_tpu_torch.transfer import TransferScheduler
from distributed_ddpg_tpu_torch.types import packed_width
from test_torch_slice import REPO, train_in_subprocess

torch.set_num_threads(1)

OBS, ACT = 4, 2
W = packed_width(OBS, ACT)
CAP, BLOCK = 1024, 64
INFLOW_SIZES = (30, 400, 64, 7, 999, 128, 1000, 3, 640, 200)


def _inflow(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, W)).astype(np.float32) for n in INFLOW_SIZES]


def _port(per, **kw):
    cls = DevicePrioritizedReplay if per else DeviceReplay
    return cls(CAP, OBS, ACT, "cpu", block_size=BLOCK, **kw)


def _snap_port(rep):
    out = dict(storage=rep.storage.numpy().copy(), ptr=rep.ptr, size=rep.size)
    if hasattr(rep, "priorities"):
        out.update(priorities=rep.priorities.numpy().copy(),
                   max_priority=float(rep.max_priority))
    return out


def _snap_jax(rep):
    out = dict(storage=np.asarray(jax.device_get(rep.storage)),
               ptr=int(jax.device_get(rep.ptr)), size=int(jax.device_get(rep.size)))
    if hasattr(rep, "priorities"):
        out.update(priorities=np.asarray(jax.device_get(rep.priorities)),
                   max_priority=float(jax.device_get(rep.max_priority)))
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
@pytest.mark.parametrize("route", ["scheduler", "shipper"])
def test_pipelined_replay_matches_jax_and_the_serial_one(per, route):
    """JAX's pipelined replay, the port's, and the port's serial run:
    storage, ptr, size (and priorities, max priority) bit for bit."""
    ours_sched, jax_sched = TransferScheduler().start(), JaxScheduler().start()
    kw = dict(async_ship=True, max_coalesce=8, staging_blocks=4)
    if route == "scheduler":
        kw.update(adaptive_coalesce=True, host_pool=True)
    try:
        serial = _port(per, max_coalesce=1)
        ours = _port(per, scheduler=ours_sched if route == "scheduler" else None, **kw)
        jcls = JaxPerReplay if per else JaxDeviceReplay
        theirs = jcls(CAP, OBS, ACT, block_size=BLOCK,
                      scheduler=jax_sched if route == "scheduler" else None, **kw)
        assert (ours._shipper is None) == (route == "scheduler")
        reps = (serial, ours, theirs)
        for i, block in enumerate(_inflow(seed=7 if per else 3)):
            for r in reps:
                r.add_packed(block)
            if per and i == 4:
                # A learner write between inserts: later stamps carry it.
                prios = np.random.default_rng(1).uniform(0.5, 3.0, CAP).astype(np.float32)
                for r in (serial, ours):
                    r.drain_pending()
                    r.set_per_state(torch.from_numpy(prios.copy()), torch.tensor(2.75))
                theirs.drain_pending()
                theirs.set_per_state(jax.numpy.asarray(prios), jax.numpy.float32(2.75))
        ours.drain_pending()
        theirs.drain_pending()
        assert serial.pending_rows == ours.pending_rows == theirs.pending_rows > 0
        for r in reps:
            r.flush()
        want = _snap_jax(theirs)
        _same(_snap_port(ours), want)
        _same(_snap_port(serial), want)
        assert want["size"] == CAP   # the inflow wrapped the ring
        snap = ours.ingest_snapshot()
        assert snap["ingest_coalesce_mean"] > 1.0 and snap["ingest_shipper_restarts"] == 0
        if route == "scheduler":
            assert ours_sched.snapshot()["transfer_ingest_items"] >= 1
            t = ours.transfer_snapshot()
            assert 1 <= t["transfer_coalesce_cap"] <= 8 and t["transfer_pool_buffers"] >= 1
        ours.close()
        theirs.close()
    finally:
        ours_sched.close()
        jax_sched.close()


def test_any_cap_sequence_lands_rows_where_the_serial_one_does():
    class _JitterCap:
        seq = [1, 4, 2, 8, 1, 2, 4, 8]

        def __init__(self):
            self.i = 0

        def cap(self):
            self.i += 1
            return self.seq[self.i % len(self.seq)]

        def observe_ship(self, blocks, ship_s, queue_rows):
            pass

        def snapshot(self):
            return {}

    serial, jittered = _port(True, max_coalesce=1), _port(True, max_coalesce=8)
    jittered._adaptive = _JitterCap()
    for block in _inflow(seed=8):
        serial.add_packed(block)
        jittered.add_packed(block)
    serial.flush()
    jittered.flush()
    _same(_snap_port(jittered), _snap_port(serial))
    assert jittered._adaptive.i > 4


def test_ingest_snapshot_has_the_jax_keys_and_counts():
    ours = _port(False, async_ship=True, max_coalesce=4, staging_blocks=2)
    theirs = JaxDeviceReplay(CAP, OBS, ACT, block_size=BLOCK)
    try:
        rng = np.random.default_rng(3)
        for _ in range(10):
            ours.add_packed(rng.standard_normal((BLOCK, W)).astype(np.float32))
        ours.drain_pending()
        snap = ours.ingest_snapshot()
        assert set(snap) == {k for k in theirs.ingest_snapshot() if k.startswith("ingest_")}
        assert snap["ingest_ship_calls"] >= 1 and snap["ingest_coalesce_mean"] >= 1.0
        assert snap["ingest_rows_staged"] == 10 * BLOCK
        assert snap["ingest_queue_rows"] == 0 and len(ours) == 10 * BLOCK
        assert ours.ingest_snapshot()["ingest_rows_staged"] == 0   # a new interval
    finally:
        ours.close()


def test_reward_sample_counts_staged_rows():
    rng = np.random.default_rng(5)
    ours, theirs = _port(False), JaxDeviceReplay(CAP, OBS, ACT, block_size=BLOCK)
    for n in (100, 10):   # one block ships, 46 rows stay staged
        rows = rng.standard_normal((n, W)).astype(np.float32)
        ours.add_packed(rows)
        theirs.add_packed(rows)
    assert len(ours) == BLOCK and ours.pending_rows == 46
    for max_n in (100_000, 80, 10):
        r, d = ours.reward_sample(max_n)
        jr, jd = theirs.reward_sample(max_n)
        np.testing.assert_array_equal(r, np.asarray(jr))
        np.testing.assert_array_equal(d, np.asarray(jd))
    assert len(ours.reward_sample()[0]) == len(ours) + ours.pending_rows


class _Boom(DeviceReplay):
    def _ship(self, rows):
        raise RuntimeError("boom h2d")


def test_shipper_death_surfaces_named_error():
    rep = _Boom(CAP, OBS, ACT, "cpu", block_size=BLOCK, async_ship=True)
    try:
        rows = np.zeros((BLOCK, W), np.float32)
        with pytest.raises(IngestError, match="shipper thread died"):
            for _ in range(300):
                rep.add_packed(rows)
                time.sleep(0.01)
            pytest.fail("shipper death never surfaced")
        assert rep.ingest_snapshot()["ingest_shipper_restarts"] == 3
    finally:
        rep.close()


def test_scheduler_ingest_failure_bounded_restart():
    sched = TransferScheduler().start()
    try:
        rep = _Boom(CAP, OBS, ACT, "cpu", block_size=BLOCK, async_ship=True,
                    scheduler=sched, host_pool=True)
        rows = np.zeros((BLOCK, W), np.float32)
        with pytest.raises(IngestError, match="shipper thread died"):
            for _ in range(300):
                rep.add_packed(rows)
                time.sleep(0.01)
            pytest.fail("scheduler-path ingest death never surfaced")
        assert rep.ingest_snapshot()["ingest_shipper_restarts"] == 3
        # A failed ship returned its pool buffer: nothing waits on a fence.
        assert rep.transfer_snapshot()["transfer_pool_fence_waits"] == 0
        rep.close()
    finally:
        sched.close()


def test_close_falls_back_to_inline_shipping():
    sched = TransferScheduler().start()
    try:
        for kw in (dict(), dict(scheduler=sched)):
            rep = _port(False, async_ship=True, **kw)
            rep.close()
            rep.add_packed(np.ones((BLOCK, W), np.float32))   # inline after close
            assert len(rep) == BLOCK and rep.pending_rows == 0
    finally:
        sched.close()


def test_staging_ring_pop_into_and_peek_cols_match_jax():
    rows = np.arange(60, dtype=np.float32).reshape(20, 3)
    ours, theirs = HostStagingRing(3, 8), JaxStagingRing(3, 8)
    for ring in (ours, theirs):
        ring.push(rows[:6])
        ring.pop(5)
        ring.push(rows[6:12])   # the head at 5, the tail wrapped
    np.testing.assert_array_equal(ours.peek_cols(1, 2, 100), theirs.peek_cols(1, 2, 100))
    np.testing.assert_array_equal(ours.peek_cols(0, 1, 3), theirs.peek_cols(0, 1, 3))
    a, b = np.empty((6, 3), np.float32), np.empty((6, 3), np.float32)
    assert ours.pop_into(6, a) is a
    theirs.pop_into(6, b)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, rows[5:11])
    with pytest.raises(ValueError):
        ours.pop_into(1, np.empty((2, 3), np.float32))
    with pytest.raises(ValueError):
        ours.pop_into(5, np.empty((5, 3), np.float32))


# --- the shm ring ------------------------------------------------------------------


def test_shm_ring_matches_jax_on_one_shared_block():
    """One anonymous block, the port's ShmRing and JAX's attached to it:
    rows either pushes the other pops unchanged, across the wrap, and a
    batch into a nearly full ring is accepted in part by both alike."""
    if not jax_native.available():
        pytest.skip("the JAX package's native core cannot be built here")
    cap, width = 8, 5
    buf = mp.get_context("spawn").Array("B", native.ShmRing.nbytes(cap, width), lock=False)
    ours = native.ShmRing(buf, cap, width, init=True)
    theirs = jax_native.ShmRing(buf, cap, width)
    assert native.ShmRing.nbytes(cap, width) == jax_native.ShmRing.nbytes(cap, width)
    rng = np.random.default_rng(0)
    sent, got = [], []
    for step in range(12):
        producer, consumer = (ours, theirs) if step % 2 else (theirs, ours)
        rows = rng.standard_normal((int(rng.integers(1, 7)), width)).astype(np.float32)
        free = cap - len(consumer)
        n = producer.push(rows)
        assert n == min(len(rows), free)
        sent.append(rows[:n])
        assert len(ours) == len(theirs)
        got.append(consumer.pop(int(rng.integers(1, 9))))
    got.append(ours.pop(cap))
    assert np.concatenate(sent).tobytes() == np.concatenate(got).tobytes()
    # Full: both accept part of a batch, then nothing.
    for ring in (ours, theirs):
        assert ring.push(np.ones((cap - 3, width), np.float32)) == cap - 3
        assert ring.push(np.ones((5, width), np.float32)) == 3
        assert ring.push(np.ones((1, width), np.float32)) == 0
        assert len(ring.pop(cap)) == cap and len(ring) == 0
    with pytest.raises(ValueError):
        ours.push(np.ones((2, width + 1), np.float32))
    with pytest.raises(ValueError, match="too small"):
        native.ShmRing(buf, cap + 1, width)


# The pool on shm, run in a child process (the pool never starts inside a
# pytest process): a spawned worker fills its ring, is killed, and its
# respawn goes on in the same ring.
SHM_POOL_DRILL = """
import time
import numpy as np
from distributed_ddpg_tpu_torch.actors.policy import decode_version
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make, spec_of

cfg = DDPGConfig(device="cpu", actor_hidden=(16, 16), num_actors=1, shm_ring_rows=256)
spec = spec_of(make("Pendulum-v1"))
pool = ActorPool(cfg, spec).start(np.zeros(sum(i * o + o for i, o in zip(
    [spec.obs_dim, 16, 16], [16, 16, spec.act_dim])), np.float32))
assert pool.transport == "shm", pool.transport
ring = pool._rings[0]
try:
    deadline = time.time() + 60
    while len(ring) < 256 and time.time() < deadline:   # the worker fills its ring
        time.sleep(0.01)
    time.sleep(0.2)
    assert len(ring) == 256   # full: the worker waits (backpressure), nothing lost
    raw = ring.pop(8)
    assert {decode_version(v) for v in raw[:, -1]} == {2}   # the broadcast's version
    batches = pool.drain_batches(max_rows=100)
    assert sum(len(b["reward"]) for b in batches) == 100
    b = batches[0]
    assert b["obs"].shape[1] == spec.obs_dim and b["action"].shape[1] == spec.act_dim
    assert np.all((b["discount"] == 0) | (b["discount"] == np.float32(cfg.gamma)))
    np.testing.assert_array_equal(b["obs"][1:], b["next_obs"][:-1])
    pool._procs[0].kill()
    pool._procs[0].join(timeout=10)
    left = len(ring)   # the dead worker's rows stay in its ring
    assert pool.drain_batches() and pool.steps_received == 100 + left
    # The respawn waits out the slot's backoff (respawn_backoff_s).
    stats = pool.monitor()
    while stats["total_respawns"] == 0 and time.time() < deadline:
        time.sleep(0.05)
        stats = pool.monitor()
    assert stats["total_respawns"] == 1
    before = pool.steps_received
    while pool.steps_received < before + 300 and time.time() < deadline:
        pool.drain_batches()
        time.sleep(0.01)
    assert pool.steps_received >= before + 300   # the respawn pushes into the same ring
finally:
    pool.stop()
assert not any(p.is_alive() for p in pool._procs)
"""


def test_pool_on_shm_spawns_a_producer_and_respawns_it_onto_its_ring():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", SHM_POOL_DRILL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]


def test_shm_raises_with_the_compilers_output_when_the_ring_cannot_build(monkeypatch,
                                                                        tmp_path, capsys):
    from distributed_ddpg_tpu_torch.actors import pool as pool_mod

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "SRC", os.path.join(REPO, "README.md"))   # not C++
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="transport='shm'.*g\\+\\+ failed"):
        pool_mod.resolve_transport("shm")
    assert pool_mod.resolve_transport("auto") == "queue"
    assert "resolved to the queue" in capsys.readouterr().err
    assert pool_mod.resolve_transport("queue") == "queue"


# --- the flags ----------------------------------------------------------------------

NEW_FIELDS = ("ingest_async", "ingest_coalesce", "transfer_scheduler",
              "ingest_coalesce_adaptive", "transfer_host_pool", "shm_ring_rows",
              "max_ingest_ratio", "transport")


def test_the_new_fields_have_the_jax_names_defaults_and_checks():
    ours, theirs = DDPGConfig(), JaxConfig()
    for name in NEW_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    cfg = DDPGConfig.from_flags(["--transport=shm", "--ingest_async=false",
                                 "--ingest_coalesce=4", "--transfer_scheduler=false",
                                 "--ingest_coalesce_adaptive=false",
                                 "--transfer_host_pool=false", "--shm_ring_rows=128",
                                 "--max_ingest_ratio=2.5"])
    assert (cfg.transport, cfg.ingest_async, cfg.ingest_coalesce, cfg.transfer_scheduler,
            cfg.ingest_coalesce_adaptive, cfg.transfer_host_pool, cfg.shm_ring_rows,
            cfg.max_ingest_ratio) == ("shm", False, 4, False, False, False, 128, 2.5)
    for bad in (dict(transport="tcp"), dict(ingest_coalesce=0), dict(max_ingest_ratio=-1.0),
                dict(max_learn_ratio=0.5, max_ingest_ratio=1.5)):
        with pytest.raises(ValueError) as ours_err:
            DDPGConfig(**bad)
        with pytest.raises(ValueError) as theirs_err:
            JaxConfig(**bad)
        assert str(ours_err.value) == str(theirs_err.value), bad
    with pytest.raises(ValueError, match="shm_ring_rows"):
        DDPGConfig(shm_ring_rows=0)


def test_help_lists_the_new_flags():
    res = subprocess.run([sys.executable, "-m", "distributed_ddpg_tpu_torch.train", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    for name in NEW_FIELDS:
        assert f"--{name}" in res.stdout, name


# --- train() ------------------------------------------------------------------------

TINY = ["--num_actors=1", "--actor_hidden=16,16", "--critic_hidden=16,16",
        "--batch_size=16", "--learner_chunk=4", "--replay_min_size=200", "--eval_every=0",
        "--eval_episodes=1"]


def test_train_default_flags_run_on_shm_with_the_shipper(tmp_path):
    records = train_in_subprocess(TINY + ["--total_env_steps=3000"], tmp_path / "m.jsonl")
    final = records[-1]
    assert final["kind"] == "final" and final["step"] >= 3000
    assert final["transport"] == "shm" and final["ingest_async_active"] is True
    trains = [r for r in records if r["kind"] == "train"]
    for rec in trains + [final]:
        assert {"ingest_rows_per_sec", "ingest_coalesce_mean", "ingest_stall_ms",
                "ingest_queue_rows", "transfer_dispatches", "transfer_ingest_items",
                "transfer_coalesce_cap", "transfer_pool_fence_waits"} <= set(rec)
    # The scheduler shipped the steady state's blocks from the pool.
    shipped = sum(r["transfer_ingest_items"] for r in trains + [final])
    assert shipped >= 1 and final["transfer_pool_buffers"] >= 1
    assert final["n_ingest_run"] >= final["chunks"] >= 1
    assert 0.0 <= final["t_ingest_run_max"] and math.isfinite(final["t_ingest_chunk_ms"])
    assert math.isfinite(final["critic_loss"]) and math.isfinite(final["final_return"])


def test_train_with_the_old_pipelines_flags_still_runs(tmp_path):
    records = train_in_subprocess(TINY + ["--total_env_steps=600", "--transport=queue",
                                          "--ingest_async=false",
                                          "--transfer_scheduler=false"],
                                  tmp_path / "m.jsonl")
    final = records[-1]
    assert final["transport"] == "queue" and final["ingest_async_active"] is False
    assert "ingest_rows_per_sec" in final and "transfer_dispatches" not in final
    assert final["chunks"] >= 1 and math.isfinite(final["critic_loss"])


def test_max_ingest_ratio_caps_the_env_steps(tmp_path):
    """Drained env steps <= the warmup fill + ratio * learner steps, at
    every record: the drain takes no more than the budget."""
    records = train_in_subprocess(TINY + ["--total_env_steps=700", "--max_ingest_ratio=2"],
                                  tmp_path / "m.jsonl")
    final = records[-1]
    assert final["step"] >= 700
    for rec in records:
        if rec["kind"] in ("train", "final"):
            assert rec["step"] <= 200 + 2 * rec["learner_steps"], rec
