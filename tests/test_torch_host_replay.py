"""The host replay path of the port against the JAX package, on the CPU at
a small size (obs 3, act 2, nets 32x32, batch 16, K 4).

- SumTree (replay/sum_tree.py) and NativeSumTree (native/replay_core.cpp,
  built with g++ at first use) against the JAX package's SumTree: the same
  tree array after batched sets with duplicate indices, the same leaves
  for the same values, the same stratified draws from one seeded
  generator. Exact (the same float64 arithmetic in the same order).
- UniformReplay and PrioritizedReplay against JAX's after the same adds
  (a wrapping ring), priority updates and beta changes: indices, IS
  weights, gathered rows and state_dict bit-identical; a load_state_dict
  round trip to a smaller fill; make_replay picks the class.
- ChunkPrefetcher against JAX's on the same replays (uniform and PER):
  the same chunks and indices, bit for bit; its scheduler path (the
  prefetch class); stop() with a full queue; an exception on its thread
  raised at next() as PrefetchError; a starved next() as PrefetchTimeout.
- A host-fed chunk through put_chunk / run_chunk_async on both routes
  (the kernel route's plain version and the scan route) against the JAX
  learner's run_chunk (scan route, one device) from one converted state,
  DDPG and D4PG (21 atoms), the rows and PER weights drawn by the two
  prefetchers from identical PER replays: the end state and td within
  rtol 2e-5, atol 1e-6, the metrics within rtol 5e-5
  (tests/fused_parity_util.py's tightest tier, as tests/test_torch_per.py).
- The new config fields (JAX's names and defaults) and the host-replay
  refusals with JAX's messages; host_replay on D > 1 ranks raises naming
  ROADMAP item 10.
- Short `--host_replay=true` CLI runs in child processes: uniform DDPG on
  the kernel route, and README's D4PG command with PER on the scan route
  with the fused update.
"""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.native import NativeSumTree as JaxNativeSumTree
from distributed_ddpg_tpu.native import available as jax_native_available
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.parallel.prefetch import ChunkPrefetcher as JaxPrefetcher
from distributed_ddpg_tpu.replay import PrioritizedReplay as JaxPer
from distributed_ddpg_tpu.replay import UniformReplay as JaxUniform
from distributed_ddpg_tpu.replay.sum_tree import SumTree as JaxSumTree
from distributed_ddpg_tpu_torch import native
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
from distributed_ddpg_tpu_torch.parallel.learner import HostChunk, ShardedLearner
from distributed_ddpg_tpu_torch.parallel.prefetch import (
    ChunkPrefetcher,
    PrefetchError,
    PrefetchTimeout,
)
from distributed_ddpg_tpu_torch.replay import PrioritizedReplay, UniformReplay, make_replay
from distributed_ddpg_tpu_torch.replay.sum_tree import SumTree
from distributed_ddpg_tpu_torch.transfer import TransferScheduler
from test_torch_slice import train_in_subprocess

torch.set_num_threads(1)

OBS, ACT, B, K = 3, 2, 16, 4
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
CAP = 300
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/fused_parity_util.py, DDPG tier


def _fields(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, OBS)).astype(np.float32),
            rng.uniform(-2, 2, (n, ACT)).astype(np.float32),
            (3.0 * rng.standard_normal(n)).astype(np.float32),
            np.where(rng.random(n) < 0.1, 0.0, 0.99).astype(np.float32),
            rng.standard_normal((n, OBS)).astype(np.float32))


def _fill(replays, n, seed):
    for r in replays:
        r.add_batch(*_fields(n, seed))


def _same_dict(a, b, where=""):
    assert set(a) == set(b), where
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), f"{where} {k}")
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, f"{where} {k}"


# --- the sum tree -------------------------------------------------------------


def _trees():
    trees = [("numpy", SumTree)]
    if native.sum_tree_available():
        trees.append(("native", native.NativeSumTree))
    return trees


@pytest.mark.parametrize("kind", ["numpy", "native"])
def test_sum_tree_matches_jax_exactly(kind):
    if kind == "native" and not native.sum_tree_available():
        pytest.skip("g++ cannot build native/replay_core.cpp here")
    cls = dict(_trees())[kind]
    rng = np.random.default_rng(0)
    ours, theirs = cls(1000), JaxSumTree(1000)
    assert ours.capacity == theirs.capacity == 1024 and ours.depth == theirs.depth
    for _ in range(5):
        idx = rng.integers(0, 1000, 300)          # duplicates on purpose
        prios = rng.uniform(0.0, 3.0, 300)
        ours.set(idx, prios)
        theirs.set(idx, prios)
        np.testing.assert_array_equal(ours.tree, theirs.tree)
        values = rng.uniform(0.0, theirs.total, 500)
        np.testing.assert_array_equal(ours.sample(values), theirs.sample(values))
        np.testing.assert_array_equal(ours.get(idx), theirs.get(idx))
    assert ours.total == theirs.total
    g1, g2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        np.testing.assert_array_equal(ours.stratified_sample(64, g1),
                                      theirs.stratified_sample(64, g2))


def test_native_sum_tree_matches_jax_native_tree():
    if not (native.sum_tree_available() and jax_native_available()):
        pytest.skip("g++ cannot build the native sum trees here")
    rng = np.random.default_rng(1)
    ours, theirs = native.NativeSumTree(4096), JaxNativeSumTree(4096)
    idx = rng.integers(0, 4096, 5000)
    prios = rng.uniform(0.0, 1.0, 5000)
    ours.set(idx, prios)
    theirs.set(idx, prios)
    np.testing.assert_array_equal(ours.tree, theirs.tree)
    values = rng.uniform(0.0, ours.total, 2000)
    np.testing.assert_array_equal(ours.sample(values), theirs.sample(values))


def test_make_sum_tree_takes_numpy_when_the_toolchain_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_st_lib", None)
    monkeypatch.setattr(native, "_st_error", None)
    monkeypatch.setattr(native, "SUM_TREE_SRC", str(tmp_path / "missing.cpp"))
    tree = native.make_sum_tree(64)
    assert type(tree) is SumTree
    with pytest.raises(RuntimeError, match="sum tree's native library"):
        native.load_sum_tree()


# --- the host replays ---------------------------------------------------------


def test_uniform_replay_matches_jax():
    ours, theirs = UniformReplay(CAP, OBS, ACT, seed=4), JaxUniform(CAP, OBS, ACT, seed=4)
    _fill((ours, theirs), 200, 0)
    for _ in range(3):
        _same_dict(ours.sample(B), theirs.sample(B), "sample")
    _fill((ours, theirs), 250, 1)                 # wraps the ring
    assert len(ours) == len(theirs) == CAP and ours._ptr == theirs._ptr
    _same_dict(ours.sample(B), theirs.sample(B), "sample after the wrap")
    _same_dict(ours.state_dict(), theirs.state_dict(), "state_dict")
    for a, b in zip(ours.reward_sample(max_n=100), theirs.reward_sample(max_n=100)):
        np.testing.assert_array_equal(a, b)
    ours.add(*(f[0] for f in _fields(1, 9)))
    theirs.add(*(f[0] for f in _fields(1, 9)))
    _same_dict(ours.state_dict(), theirs.state_dict(), "after add")


def test_prioritized_replay_matches_jax():
    kw = dict(alpha=0.6, beta=0.4, eps=1e-6, seed=5)
    ours, theirs = PrioritizedReplay(CAP, OBS, ACT, **kw), JaxPer(CAP, OBS, ACT, **kw)
    _fill((ours, theirs), 250, 2)
    rng = np.random.default_rng(3)
    for i in range(6):
        a, b = ours.sample(B), theirs.sample(B)
        _same_dict(a, b, f"sample {i}")
        td = rng.standard_normal(B).astype(np.float32) * (1 + i)
        ours.update_priorities(a["indices"], td)
        theirs.update_priorities(b["indices"], td)
        ours.set_beta(0.4 + 0.1 * i)
        theirs.set_beta(0.4 + 0.1 * i)
        if i == 2:
            _fill((ours, theirs), 120, 4)         # wraps, stamped at the max
    assert ours.max_priority == theirs._max_priority > 1.0
    _same_dict(ours.state_dict(), theirs.state_dict(), "state_dict")


def test_prioritized_state_dict_round_trip_to_a_smaller_fill():
    src = PrioritizedReplay(CAP, OBS, ACT, seed=6)
    _fill((src,), 80, 5)
    src.update_priorities(np.arange(10), np.linspace(0.1, 3.0, 10))
    saved = src.state_dict()
    ours, theirs = PrioritizedReplay(CAP, OBS, ACT, seed=7), JaxPer(CAP, OBS, ACT, seed=7)
    _fill((ours, theirs), 200, 6)                 # a fuller buffer, then the restore
    ours.load_state_dict(saved)
    theirs.load_state_dict(saved)
    _same_dict(ours.state_dict(), saved, "restored")
    _same_dict(ours.state_dict(), theirs.state_dict(), "restored, JAX")
    assert ours._tree.total == theirs._tree.total
    assert ours.sample(64)["indices"].max() < 80     # no mass past the restored fill


@pytest.mark.parametrize("prioritized", [False, True])
def test_make_replay_matches_jax(prioritized):
    cfg = DDPGConfig(replay_capacity=CAP, prioritized=prioritized, per_alpha=0.7, seed=2,
                     device="cpu")
    jcfg = JaxConfig(replay_capacity=CAP, prioritized=prioritized, per_alpha=0.7, seed=2)
    from distributed_ddpg_tpu.replay import make_replay as jax_make_replay

    ours, theirs = make_replay(cfg, OBS, ACT), jax_make_replay(jcfg, OBS, ACT)
    assert type(ours).__name__ == type(theirs).__name__
    _fill((ours, theirs), 100, 8)
    _same_dict(ours.sample(B), theirs.sample(B))


# --- the prefetcher -----------------------------------------------------------


def _replays(prioritized, seed=3):
    if prioritized:
        return PrioritizedReplay(CAP, OBS, ACT, seed=seed), JaxPer(CAP, OBS, ACT, seed=seed)
    return UniformReplay(CAP, OBS, ACT, seed=seed), JaxUniform(CAP, OBS, ACT, seed=seed)


def _collect(prefetcher, n):
    try:
        return [prefetcher.next(timeout=30.0) for _ in range(n)]
    finally:
        assert prefetcher.stop()


@pytest.mark.parametrize("prioritized", [False, True])
def test_prefetcher_chunks_match_jax(prioritized):
    ours, theirs = _replays(prioritized)
    _fill((ours, theirs), 200, 7)
    mine = _collect(ChunkPrefetcher(ours, lambda c: c, B, K, depth=2).start(), 4)
    ref = _collect(JaxPrefetcher(theirs, lambda c: c, B, K, depth=2).start(), 4)
    for (a, ia), (b, ib) in zip(mine, ref):
        np.testing.assert_array_equal(ia, ib)
        assert ia.shape == (K, B)
        _same_dict(a, b, "chunk")
        assert a["obs"].shape == (K, B, OBS)


def test_prefetcher_submits_its_puts_to_the_scheduler():
    ours, theirs = _replays(True)
    _fill((ours, theirs), 200, 8)
    sched = TransferScheduler().start()
    try:
        mine = _collect(ChunkPrefetcher(ours, lambda c: c, B, K, depth=1,
                                        scheduler=sched).start(), 3)
        snap = sched.snapshot()
    finally:
        sched.close()
    ref = _collect(JaxPrefetcher(theirs, lambda c: c, B, K, depth=1).start(), 3)
    for (a, ia), (b, ib) in zip(mine, ref):
        np.testing.assert_array_equal(ia, ib)
        _same_dict(a, b)
    assert snap["transfer_prefetch_items"] >= 3 and snap["transfer_ingest_items"] == 0


def test_prefetcher_stops_with_a_full_queue():
    rep = UniformReplay(CAP, OBS, ACT)
    _fill((rep,), 100, 9)
    p = ChunkPrefetcher(rep, lambda c: c, B, K, depth=1).start()
    deadline = time.monotonic() + 10.0
    while not p._q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p._q.full()
    t0 = time.monotonic()
    assert p.stop(timeout=5.0)
    assert time.monotonic() - t0 < 5.0 and not p._thread.is_alive()


def test_prefetcher_raises_its_threads_exception_at_next():
    rep = UniformReplay(CAP, OBS, ACT)
    _fill((rep,), 100, 10)

    def put(chunk):
        raise OSError("copy failed")

    p = ChunkPrefetcher(rep, put, B, K).start()
    with pytest.raises(PrefetchError, match="prefetch thread died") as err:
        p.next(timeout=10.0)
    assert isinstance(err.value.__cause__, OSError)
    assert p.stop()


def test_prefetcher_times_out_while_the_replay_starves():
    rep = UniformReplay(CAP, OBS, ACT)
    _fill((rep,), 100, 11)
    lock = threading.Lock()
    lock.acquire()                                # the driver holds the replay
    p = ChunkPrefetcher(rep, lambda c: c, B, K, lock=lock).start()
    try:
        with pytest.raises(PrefetchTimeout):
            p.next(timeout=0.3)
    finally:
        lock.release()
        assert p.stop()


# --- a host-fed chunk against the JAX learner's --------------------------------


FAMILIES = {
    "ddpg": dict(),
    "d4pg": dict(distributional=True, num_atoms=21, v_min=-10.0, v_max=10.0),
}


def _one_device():
    return jax_mesh.make_mesh(1, 1, devices=jax.devices()[:1])


@pytest.fixture(scope="module", params=list(FAMILIES))
def jax_host_chunk(request):
    """One family's JAX run_chunk on a chunk its prefetcher drew from a PER
    replay (with the IS weights in its rows)."""
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                  prioritized=True, **FAMILIES[request.param])
    jcfg = JaxConfig(fused_chunk="off", **common)
    jstate = jax.tree.map(np.asarray, jax_init(jcfg, OBS, ACT, seed=jcfg.seed))
    rep = JaxPer(CAP, OBS, ACT, seed=1)
    rep.add_batch(*_fields(200, 12))
    rep.update_priorities(np.arange(50), np.linspace(0.1, 4.0, 50))
    chunk, idx = _collect(JaxPrefetcher(rep, lambda c: c, B, K).start(), 1)[0]
    assert not np.all(chunk["weight"] == 1.0)
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_one_device(), chunk_size=K, unroll=1)
    jl.state = jax.device_put(jstate, jl._state_sharding)
    out = jl.run_chunk(chunk)
    return dict(cfg=DDPGConfig(device="cpu", **common), jstate=jstate, idx=idx,
                chunk=chunk, out=jax.tree.map(np.asarray, out))


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("route", ["auto", "off"])
def test_host_fed_chunk_matches_jax_run_chunk(jax_host_chunk, route):
    ref, jout = jax_host_chunk, jax_host_chunk["out"]
    cfg = ref["cfg"].replace(fused_chunk=route)
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K,
                             state=train_state_from_numpy(ref["jstate"]))
    assert learner.fused_chunk_active is (route == "auto")
    # The same rows through the port's own prefetcher and put_chunk.
    rep = PrioritizedReplay(CAP, OBS, ACT, seed=1)
    rep.add_batch(*_fields(200, 12))
    rep.update_priorities(np.arange(50), np.linspace(0.1, 4.0, 50))
    device_chunk, idx = _collect(ChunkPrefetcher(rep, learner.put_chunk, B, K).start(), 1)[0]
    np.testing.assert_array_equal(idx, ref["idx"])
    assert isinstance(device_chunk, HostChunk) and device_chunk.ready is None
    assert device_chunk.packed.shape == (K, B, 2 * OBS + ACT + 3)
    out = learner.run_chunk_async(device_chunk)
    state, jstate = learner.state, jout.state
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for i, (lp, lr) in enumerate(zip(getattr(state, group), getattr(jstate, group))):
            for key in ("w", "b"):
                _close(f"{group}[{i}].{key}", lp[key].numpy(), lr[key])
    for opt in ("actor_opt", "critic_opt"):
        o, r = getattr(state, opt), getattr(jstate, opt)
        for i in range(len(o.mu)):
            for key in ("w", "b"):
                _close(f"{opt}.mu[{i}].{key}", o.mu[i][key].numpy(), r.mu[i][key])
                _close(f"{opt}.nu[{i}].{key}", o.nu[i][key].numpy(), r.nu[i][key])
        assert int(o.count) == int(r.count) == K, opt
    assert int(state.step) == int(jstate.step) == K
    _close("td", out.td_errors.numpy(), jout.td_errors)
    for name in METRIC_KEYS:
        _close(name, float(out.metrics[name]), float(jout.metrics[name]), METRIC_RTOL, ATOL)


def test_run_chunk_is_run_chunk_async_of_put_chunk():
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=2,
                     device="cpu")
    rep = UniformReplay(CAP, OBS, ACT, seed=0)
    rep.add_batch(*_fields(100, 13))
    chunk = _collect(ChunkPrefetcher(rep, lambda c: c, B, K).start(), 1)[0][0]
    a = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    b = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K)
    out_a = a.run_chunk(chunk)
    out_b = b.run_chunk_async(b.put_chunk(chunk))
    assert torch.equal(out_a.td_errors, out_b.td_errors)
    for x, y in zip(a.actor_params_to_host(), b.actor_params_to_host()):
        assert x == y


# --- config and refusals ------------------------------------------------------


def test_the_new_fields_have_the_jax_names_and_defaults():
    ours, theirs = DDPGConfig(), JaxConfig()
    for name in ("backend", "host_replay", "prefetch_depth", "strict_sync", "train_every",
                 "replay_sharding"):
        assert getattr(ours, name) == getattr(theirs, name), name
    flags = ["--host_replay=true", "--prefetch_depth=3", "--train_every=2"]
    assert DDPGConfig.from_flags(flags) == DDPGConfig(host_replay=True, prefetch_depth=3,
                                                      train_every=2)


@pytest.mark.parametrize("over, match", [
    (dict(replay_sharding="sharded", host_replay=True), "host_replay has no device ring"),
    (dict(replay_sharding="sharded", backend="native"), "native/ondevice backends"),
    (dict(replay_sharding="bogus"), "replay_sharding must be"),
])
def test_replay_refusals_match_jax(over, match):
    with pytest.raises(ValueError, match=match) as ours:
        DDPGConfig(**over)
    with pytest.raises(ValueError, match=match) as theirs:
        JaxConfig(**over)
    assert str(ours.value) == str(theirs.value)


def test_the_port_refuses_what_it_does_not_port_yet():
    # The sharded device replay is ported (replay/device.py); the host
    # replay on more than one rank is not.
    assert DDPGConfig(replay_sharding="sharded").replay_sharding == "sharded"
    with pytest.raises(ValueError, match="item 10"):
        DDPGConfig(host_replay=True, model_axis=2)
    with pytest.raises(ValueError, match="item 10"):
        DDPGConfig(host_replay=True, data_axis=2)
    with pytest.raises(ValueError, match="prefetch_depth"):
        DDPGConfig(prefetch_depth=0)


def test_host_replay_on_two_ranks_raises_naming_item_10():
    """The run-time refusal, when data_axis=-1 resolves to a group of two
    (a stand-in group: the learner is built, nothing is communicated)."""
    from distributed_ddpg_tpu_torch.train import train

    group = types.SimpleNamespace(world_size=2, rank=0, lead=True, device=torch.device("cpu"))
    cfg = DDPGConfig(device="cpu", host_replay=True, actor_hidden=(8,), critic_hidden=(8, 8),
                     batch_size=4, learner_chunk=2)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 10"):
        train(cfg, echo=False, group=group)


# --- the CLI ------------------------------------------------------------------


TINY = ["--num_actors=1", "--actor_hidden=16,16", "--critic_hidden=16,16",
        "--batch_size=16", "--learner_chunk=4", "--replay_min_size=200",
        "--total_env_steps=600", "--eval_every=0", "--eval_episodes=1",
        "--shm_ring_rows=128"]


def test_host_replay_cli_run(tmp_path):
    records = train_in_subprocess(["--host_replay=true", *TINY], tmp_path / "m.jsonl")
    final = records[-1]
    assert final["kind"] == "final" and final["host_replay"] is True
    assert final["chunks"] >= 1 and final["learner_steps"] == 4 * final["chunks"]
    # The transfer_* fields are an interval's: their sum over the records
    # counts every put the scheduler ran.
    puts = sum(r.get("transfer_prefetch_items", 0) for r in records)
    assert puts >= final["chunks"] and final["transfer_ingest_items"] == 0
    assert final["ingest_async_active"] is False and final["t_sample_wait_run_ms"] >= 0.0
    assert all(np.isfinite(final[k]) for k in (*METRIC_KEYS, "final_return"))


def test_host_replay_d4pg_per_cli_run_on_the_scan_route(tmp_path):
    records = train_in_subprocess([
        "--host_replay=true", "--prioritized=true", "--distributional=true", "--n_step=5",
        "--v_min=auto", "--v_max=auto", "--fused_update=true", *TINY],
        tmp_path / "m.jsonl")
    final = records[-1]
    support = [r for r in records if r["kind"] == "support"]
    assert support and support[0]["reason"] == "warmup"
    assert final["prioritized"] is True and final["max_priority"] >= 1.0
    assert 0.4 <= final["beta"] <= 1.0
    assert final["v_min"] < final["v_max"]
    assert all(np.isfinite(final[k]) for k in (*METRIC_KEYS, "final_return", "beta"))
