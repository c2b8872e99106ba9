"""The port's data parallelism (parallel/mesh.py, parallel/learner.py,
train.py) on two gloo ranks on the CPU, against the JAX package on a
2-device mesh of the conftest's CPU devices.

Each test that needs ranks starts two child processes
(tests/torch_mesh_child.py, which never imports JAX) with a join timeout
of 120 s (torch_mesh_child.run_ranks); a rank that dies fails the test
at once. The JAX side
runs here: its inputs and draws go to the ranks, and their results come
back, through .npz files under tmp_path.

- (a) The mesh launch (fused_mesh_active) against JAX's ShardedLearner
  with fused_chunk='on' (the Pallas kernel in interpret mode) for DDPG,
  TD3, D4PG and SAC: JAX's per-device draws and noise (fold_in(sub, d),
  device_fold=d) are reproduced here and given to each rank; the end
  state, the global td [K, B * D] and the metrics are compared, and both
  ranks' states must be bit-identical (tests/test_fused_mesh.py:81,
  :222).
- (b) The scan route on a mesh (fused_mesh='off') against JAX's scan on
  the same mesh, with the global draw and noise given to both ranks, with
  fused_update off (four families) and on (DDPG, D4PG).
- (c) scale_batch_with_data True and False: global_batch and the td's
  shape, for a uniform chunk and a PER chunk (tests/test_parallel.py:178).
- (d) PER on a mesh against JAX's run_sample_chunk_per on the 2-device
  mesh: on dyadic priorities the port's draw, with JAX's uniforms, gives
  JAX's indices; the chunk, the priorities and max_priority are compared
  and the two ranks' priority vectors are bit-identical.
- (e) train() at D = 2 on the CPU for a few chunks: the replicas end
  bit-identical.
- (f) The route table, in this process (a DataGroup of two ranks without
  a process group decides routes only); a rank that fails ends the other
  with an error; more NCCL ranks than cards raise.

Tolerances: rtol 2e-5, atol 1e-6 for state and td, 5e-5 for the
chunk-mean metrics (test_torch_scan.py's, from test_torch_slice.py);
where JAX runs its Pallas kernel's C51 branch (D4PG in (a)) the kernel
tolerances of test_torch_d4pg.py, rtol 2e-4, atol 1e-5, metrics 5e-4 (its
projection sums in another order).
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.replay.device import DevicePrioritizedReplay as JaxPerReplay
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxReplay
from distributed_ddpg_tpu.replay.device import draw_per_indices as jax_draw
from distributed_ddpg_tpu.types import pack_batch_np

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
from distributed_ddpg_tpu_torch.parallel.mesh import DataGroup, resolve_data_axis
from distributed_ddpg_tpu_torch.replay.device import draw_per_indices
from torch_mesh_child import run_ranks, state_arrays, state_from_arrays

torch.set_num_threads(1)

D, OBS, ACT, B, K, STEP0 = 2, 5, 3, 8, 3, 5
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
CAP, FILL, BLOCK = 512, 256, 128
BETA = 0.6
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5
KERNEL_RTOL, KERNEL_ATOL, KERNEL_METRIC_RTOL = 2e-4, 1e-5, 5e-4
FAMILIES = {
    "ddpg": {},
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=11, v_min=-5.0, v_max=5.0),
    "sac": dict(sac=True),
}


def _configs(family, **extra):
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                  **FAMILIES[family], **extra)
    return JaxConfig(**common), common


def _mesh():
    return jax_mesh.make_mesh(D, 1, devices=jax.devices()[:D])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mid_training(jcfg):
    """The JAX initial state moved to mid-training: step STEP0, offset
    counts and nonzero Adam moments (test_torch_scan.py's _jax_state)."""
    s = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    rng = np.random.default_rng(STEP0)

    def moments(opt, count):
        return opt._replace(
            mu=jax.tree.map(lambda x: jnp.asarray(
                1e-3 * rng.standard_normal(x.shape), jnp.float32), opt.mu),
            nu=jax.tree.map(lambda x: jnp.asarray(
                rng.uniform(1e-6, 1e-4, x.shape), jnp.float32), opt.nu),
            count=jnp.int32(count))

    s = s._replace(step=jnp.int32(STEP0), actor_opt=moments(s.actor_opt, STEP0 + 2),
                   critic_opt=moments(s.critic_opt, STEP0 + 4))
    if jcfg.sac:
        s = s._replace(log_alpha=jnp.float32(math.log(0.3)),
                       alpha_opt=s.alpha_opt._replace(
                           mu=jnp.float32(0.01), nu=jnp.float32(2e-4),
                           count=jnp.int32(STEP0 - 3)))
    return _np(s)


def _rows(seed, n=FILL):
    rng = np.random.default_rng(seed)
    return pack_batch_np({
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "action": rng.uniform(-2, 2, (n, ACT)).astype(np.float32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "discount": np.full(n, 0.99, np.float32),
        "next_obs": rng.standard_normal((n, OBS)).astype(np.float32),
    })


def _noise(jcfg, batch, device_fold=None):
    """JAX's noise for a chunk from STEP0 ({} when the family takes none):
    TD3's eps, SAC's (eps_next, eps_cur), [K, batch, act] each."""
    if jcfg.sac:
        e = jax_fused_chunk.sac_noise_eps(jcfg, jnp.int32(STEP0), K, batch, ACT,
                                          device_fold=device_fold)
        return {"eps_next": np.array(e[0]), "eps_cur": np.array(e[1])}
    if jcfg.twin_critic and jcfg.target_noise > 0:
        return {"eps": np.array(jax_fused_chunk.td3_noise_eps(
            jcfg, jnp.int32(STEP0), K, batch, ACT, device_fold=device_fold))}
    return {}


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol "
                           f"{atol} (max_abs_err {err.max():.3e})")


def _check_ranks(results, jout, rtol=RTOL, atol=ATOL, metric_rtol=METRIC_RTOL):
    """Both ranks' end state, global td and metrics against JAX's, and the
    replicas bit-identical."""
    want = state_arrays(jout.state)
    for r, res in enumerate(results):
        assert bool(res["replicas"]), f"rank {r}: the replicas' states differ"
        for key, value in want.items():
            if key.endswith("count") or key == "state/step":
                assert int(res[key]) == int(value), (r, key)
            else:
                _close(f"rank {r} {key}", res[key], value, rtol, atol)
        _close(f"rank {r} td", res["td"], jout.td_errors, rtol, atol)
        for i, name in enumerate(METRIC_KEYS):
            _close(f"rank {r} {name}", res["metrics"][i], jout.metrics[name], metric_rtol, atol)
    for key in results[0]:
        if key.startswith("state/"):
            np.testing.assert_array_equal(results[0][key], results[1][key], err_msg=key)


def _spec(cfg, **extra):
    return dict(kind="chunk", config=cfg, obs=OBS, act=ACT, k=K, scale=SCALE, offset=OFFSET,
                capacity=CAP, block=BLOCK, **extra)


# --- (a) the mesh launch ------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_launch_matches_jax_fused_mesh(family, tmp_path):
    jcfg, cfg = _configs(family, fused_chunk="on")
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_mesh(), chunk_size=K)
    assert jl.fused_mesh_active and jl.fused_chunk_active
    jstate = _mid_training(jcfg)
    jl.state = jax.device_put(jstate, jl._state_sharding)
    rows = _rows(5)
    jrep = JaxReplay(CAP, OBS, ACT, mesh=jl.mesh, block_size=BLOCK)
    jrep.add_packed(rows)
    # The draws as _make_fused_mesh_fn makes them (parallel/learner.py:795-810).
    _, sub = jax.random.split(jl._key)
    arrays = dict(rows=rows, **state_arrays(jstate))
    for d in range(D):
        arrays[f"idx{d}"] = np.array(jax.random.randint(
            jax.random.fold_in(sub, d), (K, B), 0, FILL))
        arrays.update({f"{k}{d}": v for k, v in _noise(jcfg, B, device_fold=d).items()})
    jout = _np(jl.run_sample_chunk(jrep))
    results = run_ranks(tmp_path, _spec(cfg), arrays)
    assert all(str(res["route"]) == "mesh" for res in results)
    assert jout.td_errors.shape == (K, B * D)
    tol = ((KERNEL_RTOL, KERNEL_ATOL, KERNEL_METRIC_RTOL) if family == "d4pg"
           else (RTOL, ATOL, METRIC_RTOL))
    _check_ranks(results, jout, *tol)


# --- (b) the scan route on a mesh -------------------------------------------------


@pytest.mark.parametrize("family,fused_update", [
    ("ddpg", False), ("td3", False), ("d4pg", False), ("sac", False),
    ("ddpg", True), ("d4pg", True),
])
def test_scan_route_on_a_mesh_matches_jax_scan(family, fused_update, tmp_path):
    extra = dict(fused_mesh="off", fused_update=True) if fused_update else dict(fused_mesh="off")
    jcfg, cfg = _configs(family, **extra)
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_mesh(), chunk_size=K, unroll=1)
    assert not jl.fused_chunk_active and not jl.fused_mesh_active
    jstate = _mid_training(jcfg)
    jl.state = jax.device_put(jstate, jl._state_sharding)
    rows = _rows(6)
    jrep = JaxReplay(CAP, OBS, ACT, mesh=jl.mesh, block_size=BLOCK)
    jrep.add_packed(rows)
    # The replicated global draw (parallel/learner.py:296-302) and the
    # scan step's own noise over the global batch.
    _, sub = jax.random.split(jl._key)
    arrays = dict(rows=rows, idx=np.array(jax.random.randint(sub, (K, B * D), 0, FILL)),
                  **_noise(jcfg, B * D), **state_arrays(jstate))
    jout = _np(jl.run_sample_chunk(jrep))
    results = run_ranks(tmp_path, _spec(cfg), arrays)
    assert all(str(res["route"]) == "scan" for res in results)
    _check_ranks(results, jout)


# --- (c) scale_batch_with_data --------------------------------------------------


@pytest.mark.parametrize("scaled,want_batch", [(True, B * D), (False, B)])
def test_scale_batch_with_data(scaled, want_batch, tmp_path):
    """Per-rank batch semantics: B rows a rank (global B * D), or B in all
    split over the ranks, on a uniform chunk (the mesh launch) and a PER
    chunk (the scan route), as the JAX learner's on its mesh."""
    jcfg, cfg = _configs("ddpg", scale_batch_with_data=scaled)
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_mesh(), chunk_size=K)
    assert jl.global_batch == want_batch
    rows = _rows(7)
    for per in (False, True):
        results = run_ranks(tmp_path, _spec(cfg, per=per, beta=BETA, chunks=2),
                            dict(rows=rows), name=f"per{int(per)}")
        for res in results:
            assert int(res["global_batch"]) == want_batch
            assert res["td"].shape == (K, want_batch)
            assert np.isfinite(res["metrics"]).all()
            assert bool(res["replicas"])
            assert str(res["route"]) == ("scan" if per else "mesh")
        np.testing.assert_array_equal(results[0]["td"], results[1]["td"])
        if per:
            np.testing.assert_array_equal(results[0]["priorities"], results[1]["priorities"])


# --- (d) PER on a mesh --------------------------------------------------------------


def test_per_chunk_on_a_mesh_matches_jax(tmp_path):
    jcfg, cfg = _configs("ddpg")
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_mesh(), chunk_size=K, unroll=1)
    assert not jl.fused_per_active
    jstate = _mid_training(jcfg)
    jl.state = jax.device_put(jstate, jl._state_sharding)
    rows = _rows(8)
    # Dyadic priorities: every running sum is exact, so the draw's indices
    # do not depend on the order of the prefix sum.
    prios = np.zeros(CAP, np.float32)
    prios[:FILL] = np.random.default_rng(9).integers(1, 9, FILL) / 8.0
    jrep = JaxPerReplay(CAP, OBS, ACT, mesh=jl.mesh, block_size=BLOCK)
    jrep.add_packed(rows)
    jrep.set_per_state(jnp.asarray(prios), jnp.float32(1.5))
    # The draw as the learner's PER program makes it (parallel/learner.py:465).
    _, sub = jax.random.split(jl._key)
    idx, weights = jax.jit(jax_draw, static_argnums=3)(
        sub, jnp.asarray(prios), jnp.int32(FILL), (K, B * D), jnp.float32(BETA))
    uniform = np.array(jax.random.uniform(sub, (K, B * D)))
    pidx, pweights = draw_per_indices(torch.from_numpy(prios), FILL, (K, B * D), BETA,
                                      uniform=torch.from_numpy(uniform))
    np.testing.assert_array_equal(pidx.numpy(), np.array(idx))
    _close("weights", pweights.numpy(), np.array(weights), 1e-6, 0.0)
    jout = _np(jl.run_sample_chunk_per(jrep, BETA))
    results = run_ranks(tmp_path, _spec(cfg, per=True, beta=BETA),
                        dict(rows=rows, prios=prios, max_priority=np.float32(1.5),
                             idx=pidx.numpy(), weights=pweights.numpy(),
                             **state_arrays(jstate)))
    _check_ranks(results, jout)
    new_prios = np.asarray(jax.device_get(jrep.priorities))
    for r, res in enumerate(results):
        assert str(res["route"]) == "scan"
        _close(f"rank {r} priorities", res["priorities"], new_prios)
        _close(f"rank {r} max_priority", res["max_priority"], float(jrep.max_priority),
               METRIC_RTOL, ATOL)
    np.testing.assert_array_equal(results[0]["priorities"].view(np.int32),
                                  results[1]["priorities"].view(np.int32))
    assert results[0]["max_priority"].tobytes() == results[1]["max_priority"].tobytes()


# --- (e) train() at D = 2 ---------------------------------------------------------


@pytest.mark.parametrize("extra", [
    dict(),
    dict(distributional=True, n_step=3, v_min=float("nan"), v_max=float("nan"),
         prioritized=True),
], ids=["ddpg-mesh", "d4pg-per-scan"])
def test_train_at_two_ranks_keeps_the_replicas_identical(extra, tmp_path):
    # shm_ring_rows=128: the actor runs at most 128 rows ahead, as on the
    # queue (4 batches of 32), so the run takes more than one chunk.
    cfg = dict(total_env_steps=600, replay_min_size=200, batch_size=16,
               actor_hidden=[16, 16], critic_hidden=[16, 16], learner_chunk=4,
               eval_every=0, eval_episodes=1, shm_ring_rows=128, **extra)
    results = run_ranks(tmp_path, dict(kind="train", config=cfg), {})
    lead, other = (json.loads(str(res["summary"])) for res in results)
    for s in (lead, other):
        assert s["data_axis"] == 2 and s["global_batch"] == 32
        assert s["replicas_identical"] is True
        assert s["learner_steps"] == s["chunks"] * 4 and s["chunks"] >= 2
        assert math.isfinite(s["critic_loss"])
        # The ranks insert on their driver's thread (no shipper), so they
        # insert at the same point of the loop.
        assert s["ingest_async_active"] is False
    assert lead["transport"] == "shm" and other["transport"] is None
    assert lead["route"] == ("scan" if extra else "mesh")
    assert lead["chunks"] == other["chunks"] and lead["env_steps"] == other["env_steps"]
    assert math.isfinite(lead["final_return"]) and other["final_return"] is None
    if extra:
        assert lead["v_min"] == other["v_min"] and lead["v_max"] == other["v_max"]
        assert math.isfinite(lead["v_min"]) and lead["max_priority"] == other["max_priority"]


# --- (f) the route table ---------------------------------------------------------


def _route_learner(world=D, **over):
    cfg = DDPGConfig(device="cpu", actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B,
                     **over)
    group = DataGroup(rank=1, world_size=world, device=torch.device("cpu"))
    return ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, group=group)


@pytest.mark.parametrize("over,uniform,per", [
    (dict(), "mesh", "scan"),
    (dict(fused_mesh="off"), "scan", "scan"),
    (dict(critic_l2=0.01), "scan", "scan"),
    (dict(fused_chunk="off"), "scan", "scan"),
])
def test_route_table_on_two_ranks(over, uniform, per):
    """The JAX learner's rules (:386-414): the mesh launch inside the
    envelope unless fused_mesh='off'; PER on a mesh always on the scan
    route (its kernel program is single-device). JAX takes its kernel off
    the TPU only under fused_chunk='on', so it is asked for it where the
    port's route is the mesh launch."""
    learner = _route_learner(**over)
    assert learner.route() == uniform and learner.route(per=True) == per
    jcfg, _ = _configs("ddpg", **(dict(over, fused_chunk="on") if uniform == "mesh" else over))
    jl = JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_mesh(), chunk_size=K)
    assert jl.fused_mesh_active is learner.fused_mesh_active is (uniform == "mesh")
    assert jl.fused_per_active is learner.fused_per_active is False
    assert learner.global_batch == jl.global_batch == B * D and learner.b_local == B


def test_fused_chunk_on_with_fused_mesh_off_raises_jax_message():
    jcfg, _ = _configs("ddpg", fused_chunk="on", fused_mesh="off")
    with pytest.raises(ValueError, match="fused_chunk='on'") as theirs:
        JaxLearner(jcfg, OBS, ACT, SCALE, OFFSET, mesh=_mesh(), chunk_size=K)
    with pytest.raises(ValueError, match="fused_chunk='on'") as ours:
        _route_learner(fused_chunk="on", fused_mesh="off")
    assert str(ours.value) == str(theirs.value)


def test_a_rank_that_fails_ends_the_other_with_an_error(tmp_path):
    """No quiet fallback: a launch that fails on rank 1 raises there, and
    rank 0, waiting in the chunk's all-reduce, ends with an error once the
    group's timeout (5 s here) runs out, never with exit 0."""
    _, cfg = _configs("ddpg")
    codes = run_ranks(tmp_path, _spec(cfg, fail_rank=1, timeout_s=5.0), dict(rows=_rows(10)),
                      check=False)
    assert codes[1] != 0 and codes[0] not in (0, None), codes


def test_more_nccl_ranks_than_cards_raises(monkeypatch):
    from distributed_ddpg_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no card of its own"):
        mesh.init_data_group("nccl", rank=1, world_size=2)


def test_mesh_fields_and_the_group_size():
    with pytest.raises(ValueError, match="data_axis=4"):
        resolve_data_axis(DDPGConfig(data_axis=4), 2)
    assert resolve_data_axis(DDPGConfig(), 3) == 3
    assert resolve_data_axis(DDPGConfig(data_axis=2), 2) == 2
    with pytest.raises(ValueError, match="not divisible"):
        _route_learner(world=3, scale_batch_with_data=False)
    learner = _route_learner(scale_batch_with_data=False)
    assert learner.global_batch == B and learner.b_local == B // D
    with pytest.raises(ValueError, match="fused_mesh"):
        DDPGConfig(fused_mesh="sometimes")
    with pytest.raises(ValueError, match="fused_mesh") as theirs:
        JaxConfig(fused_mesh="sometimes")
    assert "fused_mesh must be 'auto' or 'off'" in str(theirs.value)


def test_state_arrays_round_trip():
    """The .npz bridge to the ranks keeps every leaf of every family."""
    for family in FAMILIES:
        jcfg, _ = _configs(family)
        state = _mid_training(jcfg)
        back = state_arrays(state_from_arrays(state_arrays(state)))
        want = state_arrays(state)
        assert back.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(back[key], want[key])
