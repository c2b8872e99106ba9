"""The port's tensor parallelism (model_axis > 1: parallel/partition.py,
the rank grid of parallel/mesh.py, the Megatron-split apply of
models/mlp.py, the learner step and ShardedLearner) on gloo ranks on the
CPU, against the JAX package's ShardedLearner on make_mesh(1, 2) and
make_mesh(2, 2) of the conftest's CPU devices (GSPMD splits the same
logical step there).

Each rank test starts D x M child processes (tests/torch_mesh_child.py,
which never imports JAX) with a join timeout of 120 s; JAX's state,
rows and draws go to the ranks, their logical end state, td and
metrics come back (tests/test_torch_mesh.py's pattern).

- (a) A chunk on the scan route at 1 x 2 for DDPG, TD3, D4PG and SAC,
  at both critic shapes of the action-insert layer: act 1 (hidden + 1 =
  33 does not divide 2: the layer is replicated) and act 6 (38 divides:
  row-parallel, cut at 19 while layer 0's columns split at 16). DDPG and
  D4PG also with fused_update (the port's K2 plain version on each
  rank's shards; JAX's interpret-mode K2 on its mesh). The replicated
  leaves are bit-identical across the model group. In bf16 with three
  hidden layers (a column layer whose input gradient is a partial sum over
  the model group: trap 3), the port rounds that sum once, after the
  group's sum, as JAX's step does: at the same tolerances.
- (b) At 2 x 2 with the sharded replay (split over the data axis only):
  a uniform chunk with K2, and a PER chunk on JAX's sharded draw
  (make_sharded_per_draw with the learner's key): state, td, metrics and
  the logical priorities.
- (c) train() at D = 1 x M = 2 for a few chunks: the replicas equal, the
  mesh_* fields of the summary. train() at D = 2 x M = 2 with the sharded
  replay and a checkpoint every chunk: one replay slice a data index
  (written by each model group's first rank), and a run at D = 2 x M = 1
  resumes from its checkpoint and adopts its slices.
- (d) A checkpoint written at M = 1 restored at M = 2 (each rank's shards
  the logical state's blocks), gathered and written again, restored at
  M = 1: bit for bit.
- (e) In this process: MeshStats' four fields against JAX's for the same
  state at M = 1 and 2.

Tolerances: tests/test_torch_mesh.py's, rtol 2e-5 and atol 1e-6 for state
and td, 5e-5 for the chunk-mean metrics.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.replay import device as jax_device
from distributed_ddpg_tpu.types import pack_batch_np

from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    state_items,
    train_state_from_numpy,
    train_state_to_flat,
)
from distributed_ddpg_tpu_torch.metrics import MeshStats
from distributed_ddpg_tpu_torch.parallel import partition
from distributed_ddpg_tpu_torch.parallel.learner import state_tensors
from torch_mesh_child import run_ranks, state_arrays

torch.set_num_threads(1)

OBS, B, K, STEP0 = 5, 8, 3, 5
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
CAP, FILL, BLOCK = 512, 256, 128
BETA = 0.6
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5
FAMILIES = {
    "ddpg": {},
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=11, v_min=-5.0, v_max=5.0),
    "sac": dict(sac=True),
}


def _mid_training(jcfg, act):
    """The JAX initial state at step STEP0 with offset counts and nonzero
    Adam moments (tests/test_torch_mesh.py's _mid_training)."""
    s = jax_init(jcfg, OBS, act, seed=jcfg.seed)
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
    return jax.tree.map(np.asarray, s)


def _rows(seed, act, n=FILL):
    rng = np.random.default_rng(seed)
    return pack_batch_np({
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "action": rng.uniform(-2, 2, (n, act)).astype(np.float32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "discount": np.full(n, 0.99, np.float32),
        "next_obs": rng.standard_normal((n, OBS)).astype(np.float32),
    })


def _noise(jcfg, batch, act):
    if jcfg.sac:
        e = jax_fused_chunk.sac_noise_eps(jcfg, jnp.int32(STEP0), K, batch, act)
        return {"eps_next": np.array(e[0]), "eps_cur": np.array(e[1])}
    if jcfg.twin_critic and jcfg.target_noise > 0:
        return {"eps": np.array(jax_fused_chunk.td3_noise_eps(
            jcfg, jnp.int32(STEP0), K, batch, act))}
    return {}


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol "
                           f"{atol} (max_abs_err {err.max():.3e})")


def _check_ranks(results, jout):
    """Every rank's logical end state, global td and metrics against
    JAX's; the replicas (shards within each data group, the rest across
    all ranks) bit-identical; the logical states the same on every rank."""
    want = state_arrays(jout.state)
    for r, res in enumerate(results):
        assert bool(res["replicas"]), f"rank {r}: the replicas differ"
        assert str(res["route"]) == "scan", r
        for key, value in want.items():
            if key.endswith("count") or key == "state/step":
                assert int(res[key]) == int(value), (r, key)
            else:
                _close(f"rank {r} {key}", res[key], value)
        _close(f"rank {r} td", res["td"], jout.td_errors)
        for i, name in enumerate(METRIC_KEYS):
            _close(f"rank {r} {name}", res["metrics"][i], jout.metrics[name], METRIC_RTOL, ATOL)
    for res in results[1:]:
        for key in res:
            if key.startswith("state/"):
                np.testing.assert_array_equal(res[key], results[0][key], err_msg=key)


def _jax_learner(jcfg, d, m, act, **kw):
    mesh = jax_mesh.make_mesh(d, m, devices=jax.devices()[:d * m])
    return JaxLearner(jcfg, OBS, act, SCALE, OFFSET, mesh=mesh, chunk_size=K, unroll=1, **kw)


def _spec(cfg, act, **extra):
    return dict(kind="chunk", config=cfg, obs=OBS, act=act, k=K, scale=SCALE, offset=OFFSET,
                capacity=CAP, block=BLOCK, **extra)


def _configs(family, d, m, **extra):
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                  **FAMILIES[family], **extra)
    return JaxConfig(model_axis=m, **common), dict(model_axis=m, data_axis=d, **common)


# --- (a) the TP chunk at 1 x 2 ------------------------------------------------------


TP_CASES = [(f, False, a) for f in FAMILIES for a in (1, 6)] + [("ddpg", True, 6),
                                                                   ("d4pg", True, 6)]


@pytest.mark.parametrize("family,fused_update,act", TP_CASES, ids=[
    f"{f}{'-k2' if fu else ''}-{'insert-row' if a == 6 else 'insert-replicated'}"
    for f, fu, a in TP_CASES])
def test_tp_chunk_matches_jax_tp_chunk(family, fused_update, act, tmp_path):
    extra = dict(fused_update=True) if fused_update else {}
    jcfg, cfg = _configs(family, 1, 2, **extra)
    jl = _jax_learner(jcfg, 1, 2, act)
    assert not jl.fused_chunk_active
    jstate = _mid_training(jcfg, act)
    jl.state = jax.device_put(jstate, jl._state_sharding)
    rows = _rows(6, act)
    jrep = jax_device.DeviceReplay(CAP, OBS, act, mesh=jl.mesh, block_size=BLOCK)
    jrep.add_packed(rows)
    _, sub = jax.random.split(jl._key)
    arrays = dict(rows=rows, idx=np.array(jax.random.randint(sub, (K, B), 0, FILL)),
                  **_noise(jcfg, B, act), **state_arrays(jstate))
    jout = jax.tree.map(np.asarray, jl.run_sample_chunk(jrep))
    _check_ranks(run_ranks(tmp_path, _spec(cfg, act), arrays), jout)


def test_tp_bf16_rounds_a_partial_gradient_after_the_model_sum(tmp_path):
    """JAX's step on a (1, 2) mesh in bf16 rounds a column layer's input
    gradient once, over the whole contraction; rounding each rank's
    partial product before the sum instead puts the port's end state
    1.7e-6 off JAX's at these shapes (measured, three 32-wide layers), and
    this test would fail. Rounded after the sum it is 1.5e-8 off."""
    act, hidden = 6, (32, 32, 32)
    jcfg, cfg = _configs("ddpg", 1, 2, compute_dtype="bfloat16")
    jcfg = jcfg.replace(actor_hidden=hidden, critic_hidden=hidden)
    cfg.update(actor_hidden=hidden, critic_hidden=hidden)
    jl = _jax_learner(jcfg, 1, 2, act)
    jstate = _mid_training(jcfg, act)
    jl.state = jax.device_put(jstate, jl._state_sharding)
    rows = _rows(8, act)
    jrep = jax_device.DeviceReplay(CAP, OBS, act, mesh=jl.mesh, block_size=BLOCK)
    jrep.add_packed(rows)
    _, sub = jax.random.split(jl._key)
    arrays = dict(rows=rows, idx=np.array(jax.random.randint(sub, (K, B), 0, FILL)),
                  **state_arrays(jstate))
    jout = jax.tree.map(np.asarray, jl.run_sample_chunk(jrep))
    _check_ranks(run_ranks(tmp_path, _spec(cfg, act), arrays), jout)


# --- (b) 2 x 2 with the sharded replay ------------------------------------------------


def _jax_sharded_draw(mesh, key, phys, n_live, shape):
    """JAX's sharded PER draw as its learner's PER program makes it
    (parallel/learner.py:465), on the priorities' physical layout."""
    draw = jax_device.make_sharded_per_draw(mesh)
    scalar = NamedSharding(mesh, P())
    fn = jax.jit(lambda k, p, s: draw(k, p, s, shape, jnp.float32(BETA)),
                 in_shardings=(scalar, NamedSharding(mesh, P("data")), scalar),
                 out_shardings=(scalar, scalar))
    return fn(key, phys, jnp.int32(n_live))


@pytest.mark.parametrize("per", [False, True], ids=["uniform-k2", "per"])
def test_tp_sharded_replay_chunk_at_2x2_matches_jax(per, tmp_path):
    act, d, m = 6, 2, 2
    extra = dict(replay_sharding="sharded", scale_batch_with_data=False,
                 **(dict(prioritized=True) if per else dict(fused_update=True)))
    jcfg, cfg = _configs("ddpg", d, m, **extra)
    jl = _jax_learner(jcfg, d, m, act, replay_sharding="sharded")
    jstate = _mid_training(jcfg, act)
    jl.state = jax.device_put(jstate, jl._state_sharding)
    rows = _rows(7, act)
    cls = jax_device.DevicePrioritizedReplay if per else jax_device.DeviceReplay
    jrep = cls(CAP, OBS, act, mesh=jl.mesh, block_size=BLOCK, replay_sharding="sharded")
    jrep.add_packed(rows)
    _, sub = jax.random.split(jl._key)
    arrays = dict(rows=rows, **state_arrays(jstate))
    if per:
        idx, weights = _jax_sharded_draw(jl.mesh, sub, jrep.priorities, FILL, (K, B))
        arrays.update(idx=np.array(idx), weights=np.array(weights))
        jout = jax.tree.map(np.asarray, jl.run_sample_chunk_per(jrep, BETA))
    else:
        arrays["idx"] = np.array(jax.random.randint(sub, (K, B), 0, FILL))
        jout = jax.tree.map(np.asarray, jl.run_sample_chunk(jrep))
    results = run_ranks(tmp_path, _spec(cfg, act, per=per, beta=BETA,
                                        replay_sharding="sharded"), arrays, world=d * m)
    _check_ranks(results, jout)
    if per:
        phys = np.asarray(jax.device_get(jrep.priorities))
        logical = phys.reshape(d, -1).T.reshape(-1)
        for r, res in enumerate(results):
            _close(f"rank {r} priorities", res["priorities"], logical)
            _close(f"rank {r} max_priority", res["max_priority"], float(jrep.max_priority))


# --- (c) train() at 1 x 2 ---------------------------------------------------------------


def test_train_at_model_axis_2_keeps_the_replicas_equal(tmp_path):
    config = dict(model_axis=2, total_env_steps=600, replay_min_size=200, batch_size=16,
                  actor_hidden=[16, 16], critic_hidden=[16, 16], learner_chunk=4,
                  eval_every=0, eval_episodes=1, num_actors=1, fused_update=True)
    results = run_ranks(tmp_path, dict(kind="train", config=config), {}, name="train")
    import json

    summaries = [json.loads(str(res["summary"])) for res in results]
    for s in summaries:
        assert s["replicas_identical"] is True
        assert s["learner_steps"] > 0 and s["route"] == "scan"
        assert s["mesh_model_axis"] == 2 and s["mesh_data_axis"] == 1
        assert s["mesh_param_bytes_per_device"] < s["mesh_param_bytes_total"]
        assert all(math.isfinite(s[k]) for k in METRIC_KEYS)
    assert summaries[0]["learner_steps"] == summaries[1]["learner_steps"]


def test_train_2x2_writes_a_slice_a_data_index_and_resumes_at_model_axis_1(tmp_path):
    import json
    import os

    ckpt = str(tmp_path / "ck")
    common = dict(replay_sharding="sharded", fused_update=True, replay_min_size=200,
                  batch_size=16, actor_hidden=[16, 16], critic_hidden=[16, 16],
                  learner_chunk=8, eval_every=0, eval_episodes=1, num_actors=1,
                  checkpoint_dir=ckpt, checkpoint_every=8)
    first = run_ranks(tmp_path, dict(kind="train", config=dict(
        common, data_axis=2, model_axis=2, total_env_steps=1200)), {}, name="tp22", world=4)
    s0 = json.loads(str(first[0]["summary"]))
    assert s0["replicas_identical"] is True and s0["learner_steps"] > 0
    assert (s0["mesh_data_axis"], s0["mesh_model_axis"]) == (2, 2)
    steps = sorted(os.listdir(os.path.join(ckpt, "replay_slices")))
    assert steps and all(
        sorted(f for f in os.listdir(os.path.join(ckpt, "replay_slices", d))
               if f.endswith(".npz")) == ["slice_0_of_2.npz", "slice_1_of_2.npz"]
        for d in steps), steps
    second = run_ranks(tmp_path, dict(kind="train", config=dict(
        common, data_axis=2, model_axis=1, total_env_steps=2400)), {}, name="dp2")
    s1 = json.loads(str(second[0]["summary"]))
    assert s1["resumed_from"] is not None and s1["pod_slices_adopted"] == 1
    assert s1["replicas_identical"] is True and s1["mesh_model_axis"] == 1


# --- (d) checkpoints across model_axis ---------------------------------------------------


def test_checkpoint_round_trip_across_model_axis(tmp_path):
    act = 6
    jcfg, cfg = _configs("td3", 1, 2)
    logical = train_state_from_numpy(_mid_training(jcfg, act))
    port_cfg = DDPGConfig(device="cpu", **cfg)
    ckpt_lib.save(str(tmp_path / "m1"), 7, logical, config=port_cfg.replace(model_axis=1))
    spec = dict(kind="ckpt", config=cfg, obs=OBS, act=act, scale=SCALE, offset=OFFSET,
                src=str(tmp_path / "m1"), dst=str(tmp_path / "m2"))
    results = run_ranks(tmp_path, spec, {}, name="ckpt")
    specs = partition.state_pspec(logical, 2)
    for r, res in enumerate(results):
        assert int(res["step"]) == 7
        mine = dict(state_items(partition.shard_tree(logical, specs, r, 2)))
        for path, shard in mine.items():
            np.testing.assert_array_equal(res[f"shard/{path}"], shard.numpy(), err_msg=path)
    back, step, _ = ckpt_lib.restore(str(tmp_path / "m2"), logical)
    assert step == 7
    want, got = train_state_to_flat(logical), train_state_to_flat(back)
    assert set(want) == set(got)
    for path in want:
        assert want[path].dtype == got[path].dtype and \
            want[path].tobytes() == got[path].tobytes(), path


# --- (e) MeshStats ------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2])
def test_mesh_stats_match_jax(m):
    jstate = jax_init(JaxConfig(actor_hidden=(64, 64), critic_hidden=(64, 64)), OBS, 2, 0)
    mesh = jax_mesh.make_mesh(8 // m, m)
    placed = jax.device_put(jstate, jax_mesh.to_named(mesh, jax_mesh.state_pspec(jstate, mesh)))
    theirs = jax.tree_util.tree_leaves(placed)
    from distributed_ddpg_tpu.metrics import MeshStats as JaxMeshStats

    want = JaxMeshStats(8 // m, m).snapshot(theirs)
    logical = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    specs = partition.state_pspec(logical, m)
    shards = partition.shard_tree(logical, specs, m - 1, m)
    flags = [partition.sharded_dim(s) is not None for s in state_tensors(specs)]
    got = MeshStats(8 // m, m).snapshot(state_tensors(shards), flags)
    assert got == want
