"""The device-side data plane on more than one rank (actors/device_pool.py,
parallel/megastep.py and superstep.py, the guarded chunk of
parallel/learner.py, ondevice.py, train.py) on gloo ranks on the CPU,
against the JAX package's programs on a 2-device CPU mesh
(make_mesh(2, 1) of the conftest's host devices) and against the port on
one rank.

The port's side runs in child processes (tests/torch_mesh_child.py kinds
"dataplane" and "beats", the cases in tests/torch_dataplane_child.py,
which never import JAX); JAX's states, rows and draws go to the ranks,
their results come back. One "dataplane" launch runs every case of the
module fixture, so the ranks start once:

- the rollout at D = 2, the envs sharded (E = 8) and replicated (E = 3),
  with JAX's draws of all E envs against JAX's DeviceActorPool on the
  mesh at rtol 1e-5, atol 1e-5 (tests/test_device_actors.py's tolerance),
  and with the pool's own generator bit for bit a one-rank port pool's
  rows, env blocks and counters; the sharded ring's logical rows are the
  replicated ring's, bit for bit;
- the rollout on a (1, 2) grid (the learner's actor in shards, the
  logical actor gathered) bit for bit the M = 1 pool's;
- the guarded chunk at D = 2 with a non-finite row in each rank's half of
  the global minibatch and numeric:grad:nan at its third step: the
  health word and the bad indices equal JAX's on every rank, exactly,
  the bad indices at the positions the draw predicts, the state and td
  at tests/test_torch_scan.py's tolerances (rtol 2e-5, atol 1e-6);
- the monolith at D = 2 (two chunks of 8 iterations, E = 4 sharded) from
  JAX's OnDeviceDDPG state with its key schedule replayed: the ring, the
  state and each chunk's stats at the same tolerances (metrics rtol 5e-5);
- the multi-rank rules: a failed rollout raises at once (no restart), the
  sidecar is None with the envs sharded and the same on every rank with
  them replicated.

Each fused-beat variant (uniform or PER, replicated or sharded ring,
guarded or not) is a launch of its own: one beat, then a superstep of
B = 2, against JAX's FusedMegastep and FusedSuperstep on the mesh (JAX's
numbers passed in; a PER superstep's from a second JAX stack stepped
beat by beat), the state, ring, priorities and carry at the scan
tolerances, the health word exactly, and each stage bit for bit the
separate sequence (chunk, rollout, insert) on the same ranks.

Three trainer runs on two ranks (train() in each rank's group): the
device actors at D = 2 with guardrails, PER and a B = 2 superstep; the
monolith at D = 2; the device actors with K2 on a (1, 2) grid: each
finishes its budget with the replicas bit-identical. A device-actor run at
D = 2 checkpoints without the rollout sidecar (the envs sharded) and a
longer run resumes from it on both ranks.

The module fixture's launch is made once a test run and shared by the
xdist workers (_once_per_run). Wall time with -n 6: ~85 s (8 fused-beat
launches, each with JAX's programs compiled on the mesh).
"""

from __future__ import annotations

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from filelock import FileLock
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_ddpg_tpu.actors.device_pool import DeviceActorPool as JaxPool
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs.jax_envs import JaxPendulum
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.ondevice import OnDeviceDDPG as JaxOnDevice
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.parallel.learner import ShardedLearner as JaxLearner
from distributed_ddpg_tpu.parallel.megastep import FusedMegastep as JaxMegastep
from distributed_ddpg_tpu.parallel.superstep import FusedSuperstep as JaxSuperstep
from distributed_ddpg_tpu.replay import device as jax_device
from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
from distributed_ddpg_tpu_torch.ops.exploration import StepDraws
from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
from torch_mesh_child import run_ranks, state_arrays

torch.set_num_threads(1)

ROLL_TOL = dict(rtol=1e-5, atol=1e-5)               # tests/test_device_actors.py
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/test_torch_scan.py
HIDDEN = (16, 16)
SCALE, OFFSET = np.array([2.0], np.float32), np.array([0.0], np.float32)
K_ROLL = 2
GUARD_K, GUARD_B = 4, 8
MONO_E, MONO_K, MONO_B = 4, 8, 8


def _mesh2():
    return jax_mesh.make_mesh(2, 1, devices=jax.devices("cpu")[:2])


def _np(x):
    return np.asarray(jax.device_get(x))


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


def _step_draws(key, n_steps, n_envs):
    """JAX's rollout stream from `key` (jax ops/exploration.py: each step
    splits next, ou, env, uniform): the normals, every env's reset values
    and the warmup uniforms, as arrays [n_steps, E, ...]."""
    env = JaxPendulum()
    low, high = jnp.asarray(env.action_low), jnp.asarray(env.action_high)
    noise, reset, uniform = [], [], []
    for _ in range(n_steps):
        key, k_ou, k_env, k_uni = jax.random.split(key, 4)
        fresh = jax.vmap(env.init)(jax.random.split(k_env, n_envs))
        noise.append(np.array(jax.random.normal(k_ou, (n_envs, 1), jnp.float32)))
        reset.append(np.stack([_np(fresh.th), _np(fresh.thdot)], 1))
        uniform.append(np.array(jax.random.uniform(k_uni, (n_envs, 1), jnp.float32,
                                                   minval=low, maxval=high)))
    return key, dict(noise=np.stack(noise), reset=np.stack(reset).astype(np.float32),
                     uniform=np.stack(uniform))


def _init_envs(key, n_envs):
    env = JaxPendulum()
    init = jax.vmap(env.init)(jax.random.split(key, n_envs))
    return np.stack([_np(init.th), _np(init.thdot)], 1).astype(np.float32)


def _as_steps(d, lo=0, hi=None):
    return [StepDraws(torch.from_numpy(d["noise"][s]), torch.from_numpy(d["reset"][s]),
                      torch.from_numpy(d["uniform"][s]))
            for s in range(lo, len(d["noise"]) if hi is None else hi)]


# --- the dataplane launch --------------------------------------------------------------

def _roll_kw(envs, **over):
    kw = dict(env_id="Pendulum-v1", actor_backend="device", num_actors=0,
              device_actor_envs=envs, device_actor_chunk=K_ROLL, actor_hidden=HIDDEN,
              critic_hidden=HIDDEN, replay_capacity=4096, data_axis=2)
    kw.update(over)
    return kw


def _jax_rollout(envs):
    """JAX's pool on the mesh: two rollouts into a JAX DeviceReplay, its
    init values and draws (the pool's key schedule) for the port."""
    jcfg = JaxConfig(**_roll_kw(envs))
    mesh = _mesh2()
    pool = JaxPool(jcfg, mesh=mesh)
    state = jax_init(jcfg, pool.obs_dim, pool.act_dim, jcfg.seed)
    pool.set_params(state.actor_params)
    rep = jax_device.DeviceReplay(jcfg.replay_capacity, pool.obs_dim, pool.act_dim,
                                  mesh=mesh, block_size=64, async_ship=False)
    k_init, key = jax.random.split(jax.random.PRNGKey(jcfg.seed + 0xDA))
    _, draws = _step_draws(key, 2 * K_ROLL, envs)
    for _ in range(2):
        pool.run_chunk(rep)
    n = 2 * K_ROLL * envs
    return (dict(init=_init_envs(k_init, envs), **draws), _np(rep.storage)[:n],
            jax.tree.map(np.asarray, state))


def _guard_inputs():
    """JAX's guarded chunk on the mesh: the rows (two of them non-finite,
    drawn into rank 0's columns at step 0 and rank 1's at step 1), the
    draw its key makes, and its results."""
    kw = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=GUARD_B, data_axis=2,
              guardrails=True, faults="numeric:grad:nan@3", replay_capacity=256)
    jcfg = JaxConfig(**kw)
    mesh = _mesh2()
    jl = JaxLearner(jcfg, 3, 1, SCALE, OFFSET, mesh=mesh, chunk_size=GUARD_K)
    rng = np.random.default_rng(11)
    n = 128
    rows = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(-2, 2, (n, 1)),
                           rng.normal(size=(n, 1)), np.full((n, 1), 0.99),
                           rng.normal(size=(n, 3)), np.ones((n, 1))], 1).astype(np.float32)
    _, sub = jax.random.split(jl._key)
    idx = np.array(jax.random.randint(sub, (GUARD_K, 2 * GUARD_B), 0, n))
    r0, r1 = int(idx[0, 1]), int(idx[1, GUARD_B + 2])
    assert r0 != r1
    rows[r0, 0] = np.nan
    rows[r1, 4] = np.inf
    jrep = jax_device.DeviceReplay(256, 3, 1, mesh=mesh, block_size=16, async_ship=False)
    jrep.add_packed(rows)
    jrep.flush()
    assert int(_np(jrep.size)) == n
    state = jax.tree.map(np.asarray, jl.state)
    out = jl.run_sample_chunk(jrep)
    flat = idx.reshape(-1)
    want_bad = flat[np.isin(flat, [r0, r1])][:32]
    return dict(kw=kw, rows=rows, idx=idx, state=state, health=jl.poll_health(),
                bad=np.asarray(jl.bad_indices()), want_bad=want_bad,
                td=_np(out.td_errors), end=jax.tree.map(np.asarray, jl.state))


def _mono_inputs():
    """JAX's monolith on the mesh, two chunks, and its key schedule: the
    init values, each iteration's draws of all E envs and, once the ring
    holds max(replay_min_size, batch_size) rows, a sample key for the
    global [B * D] indices."""
    kw = dict(num_actors=MONO_E, actor_hidden=HIDDEN, critic_hidden=HIDDEN,
              batch_size=MONO_B, replay_capacity=64, replay_min_size=24,
              backend="jax_ondevice", data_axis=2)
    jcfg = JaxConfig(**kw)
    jod = JaxOnDevice(jcfg, mesh=_mesh2(), chunk_size=MONO_K)
    state = jax.tree.map(np.asarray, jod.state)
    k_init, key = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    init = _init_envs(k_init, MONO_E)
    size, min_fill, gb = 0, max(jcfg.replay_min_size, jcfg.batch_size), jod.global_batch
    draws = {k: [] for k in ("noise", "reset", "uniform")}
    indices = []
    for _ in range(2 * MONO_K):
        key, d = _step_draws(key, 1, MONO_E)
        for k in draws:
            draws[k].append(d[k][0])
        size = min(size + MONO_E, jcfg.replay_capacity)
        if size >= min_fill:
            key, k_sample = jax.random.split(key)
            indices.append(np.array(jax.random.randint(k_sample, (gb,), 0, max(size, 1))))
    stats = [jod.run_chunk() for _ in range(2)]
    stats = [dict(metrics=np.array([float(s.metrics[k]) for k in METRIC_KEYS]),
                  learn_steps=int(s.learn_steps), dones=_np(s.dones),
                  ep_returns=_np(s.ep_returns)) for s in stats]
    return dict(kw=kw, state=state, init=init, draws={k: np.stack(v) for k, v in draws.items()},
                indices=np.stack(indices), stats=stats, gb=gb,
                ring=_np(jod.carry.storage), ptr=int(jod.carry.ptr), size=int(jod.carry.size),
                end=jax.tree.map(np.asarray, jod.state))


def _once_per_run(tmp_path_factory, name, make):
    """make() once per test run, its result shared by the xdist workers (a
    pickle in the run's common temporary directory, made under a file
    lock: a module fixture is otherwise made once a worker); without
    xdist, make() itself."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return make()
    path = tmp_path_factory.getbasetemp().parent / f"{name}-{run}.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            data = make()
            with open(path, "wb") as f:
                pickle.dump(data, f)
            return data
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def dataplane(tmp_path_factory):
    """One launch of every dataplane case on two gloo ranks; the JAX side
    made here. Once a test run."""
    return _once_per_run(tmp_path_factory, "dataplane", lambda: _dataplane(tmp_path_factory))


def _dataplane(tmp_path_factory):
    jax_roll = {e: _jax_rollout(e) for e in (8, 3)}
    state = jax_roll[8][2]
    guard, mono = _guard_inputs(), _mono_inputs()
    cases, arrays = [], dict(state_arrays(state))
    for e in (8, 3):
        inputs = jax_roll[e][0]
        cases.append(dict(case="rollout", name=f"jax{e}", config=_roll_kw(e), chunks=2))
        arrays.update({f"jax{e}/{k}": v for k, v in inputs.items()})
        cases.append(dict(case="rollout", name=f"own{e}", config=_roll_kw(e), chunks=2))
    cases.append(dict(case="rollout", name="grid", chunks=2, config=_roll_kw(
        8, data_axis=-1, model_axis=2, fused_update=True)))
    cases.append(dict(case="guard", name="guard", k=GUARD_K, config=guard["kw"]))
    arrays.update({"guard/rows": guard["rows"], "guard/idx": guard["idx"]})
    cases.append(dict(case="monolith", name="mono", k=MONO_K, chunks=2, config=mono["kw"]))
    arrays.update({"mono/init": mono["init"], "mono/indices": mono["indices"],
                   **{f"mono/{k}": v for k, v in mono["draws"].items()}})
    cases.append(dict(case="rules", name="rules", config=_roll_kw(8)))
    spec = dict(kind="dataplane", cases=cases)
    results = run_ranks(tmp_path_factory.mktemp("dataplane"), spec, arrays, world=2)
    return dict(jax_roll=jax_roll, state=state, guard=guard, mono=mono, results=results)


def _one_rank_pool(envs, state, init=None, draws=None, **over):
    """The port's pool on one rank with the same params (and init values
    and draws): two rollouts; its ring and carry."""
    cfg = DDPGConfig(device="cpu", **dict(_roll_kw(envs, **over), data_axis=-1))
    pool = DeviceActorPool(cfg)
    pool.set_params(train_state_from_numpy(state).actor_params)
    if init is not None:
        es = pool.env.init(torch.from_numpy(init))
        pool._carry = pool.carry._replace(env_state=es, obs=pool.env.observe(es))
    rep = DeviceReplay(cfg.replay_capacity, 3, 1, "cpu")
    for c in range(2):
        pool.run_chunk(rep, draws=None if draws is None else
                       _as_steps(draws, c * K_ROLL, (c + 1) * K_ROLL))
    return rep.storage[:len(rep)].numpy(), pool.carry


@pytest.mark.parametrize("envs", [8, 3], ids=["sharded", "replicated"])
def test_rollout_on_two_ranks_matches_the_jax_mesh_pool(dataplane, envs):
    inputs, want, _ = dataplane["jax_roll"][envs]
    for r, res in enumerate(dataplane["results"]):
        assert bool(res[f"jax{envs}/sharded"]) == (envs == 8)
        np.testing.assert_allclose(res[f"jax{envs}/ring"], want, err_msg=f"rank {r}",
                                   **ROLL_TOL)
        assert int(res[f"jax{envs}/size"]) == 2 * K_ROLL * envs
    # Every rank holds the same rows, bit for bit.
    a, b = (res[f"jax{envs}/ring"] for res in dataplane["results"])
    assert np.array_equal(a, b)


@pytest.mark.parametrize("envs", [8, 3], ids=["sharded", "replicated"])
def test_rank_rows_are_a_one_rank_pools_bit_for_bit(dataplane, envs):
    state = dataplane["state"]
    inputs = dataplane["jax_roll"][envs][0]
    for name, kw in ((f"jax{envs}", dict(init=inputs["init"], draws=inputs)),
                     (f"own{envs}", {})):
        ring, carry = _one_rank_pool(envs, state, **kw)
        for r, res in enumerate(dataplane["results"]):
            assert np.array_equal(res[f"{name}/ring"], ring), (name, r)
            lo, hi = res[f"{name}/env_slice"]
            assert (hi - lo) == (envs // 2 if envs == 8 else envs)
            for i, t in enumerate(carry.env_state):
                assert np.array_equal(res[f"{name}/env_state{i}"], t.numpy()[lo:hi])
            for k in ("obs", "ou", "ep_ret"):
                assert np.array_equal(res[f"{name}/{k}"], getattr(carry, k).numpy()[lo:hi])
            for k in ("steps", "episodes", "ret_sum"):
                assert np.array_equal(res[f"{name}/{k}"], getattr(carry, k).numpy()), k
            assert int(res[f"{name}/host_steps"]) == carry.host_steps
            # The sharded ring's logical rows are the replicated ring's.
            assert np.array_equal(res[f"{name}/ring_sharded"], ring)
            # The gather's time is recorded where the envs are sharded.
            assert (float(res[f"{name}/gather_ms"]) >= 0.0) == (envs == 8)


def test_grid_rollout_rows_are_the_one_model_rank_pools(dataplane):
    ring, _ = _one_rank_pool(8, dataplane["state"], fused_update=True)
    for res in dataplane["results"]:
        assert np.array_equal(res["grid/ring"], ring)
        assert not bool(res["grid/sharded"]) and int(res["grid/local_envs"]) == 8


def test_guarded_chunk_on_two_ranks_matches_jax(dataplane):
    g = dataplane["guard"]
    want_h = [g["health"][k] for k in ("total", "nonfinite", "spikes", "skipped", "bad_rows")]
    assert g["bad"].tolist() == g["want_bad"].tolist()
    for r, res in enumerate(dataplane["results"]):
        assert res["guard/health"].tolist() == want_h, r
        assert res["guard/bad"].tolist() == g["bad"].tolist(), r
        assert bool(res["guard/replicas"])
        _close(f"rank {r} td", res["guard/td"], g["td"])
        for key, want in state_arrays(g["end"]).items():
            _close(f"rank {r} {key}", res[f"guard/{key}"], want)
    # The injected step and the two screened steps were dropped.
    assert want_h[3] >= 3 and want_h[4] == len(g["want_bad"])


def test_monolith_on_two_ranks_matches_the_jax_mesh_monolith(dataplane):
    m = dataplane["mono"]
    for r, res in enumerate(dataplane["results"]):
        assert int(res["mono/global_batch"]) == m["gb"] == 2 * MONO_B
        assert int(res["mono/local_envs"]) == MONO_E // 2
        for c, js in enumerate(m["stats"]):
            pre = f"mono/chunk{c}/"
            assert int(res[pre + "learn_steps"]) == js["learn_steps"]
            np.testing.assert_array_equal(res[pre + "dones"], js["dones"])
            _close(f"rank {r} chunk {c} ep_returns", res[pre + "ep_returns"], js["ep_returns"])
            _close(f"rank {r} chunk {c} metrics", res[pre + "metrics"], js["metrics"],
                   METRIC_RTOL)
        assert (int(res["mono/ptr"]), int(res["mono/size"])) == (m["ptr"], m["size"])
        _close(f"rank {r} ring", res["mono/ring"], m["ring"])
        for key, want in state_arrays(m["end"]).items():
            _close(f"rank {r} {key}", res[f"mono/{key}"], want)


def test_multi_rank_rules_no_restart_and_no_sharded_sidecar(dataplane):
    res0, res1 = dataplane["results"]
    for res in (res0, res1):
        assert "no restart" in str(res["rules/raised"])
        assert int(res["rules/restarts"]) == 0
        assert not bool(res["rules/sidecar8"])
        assert bool(res["rules/sidecar3"])
    keys = [k for k in res0 if k.startswith("rules/sidecar3/")]
    assert keys and all(np.array_equal(res0[k], res1[k]) for k in keys)


# --- the fused beat and superstep ------------------------------------------------------

BEAT_BASE = dict(actor_backend="device", num_actors=0, device_actor_envs=8,
                 device_actor_chunk=2, learner_chunk=2, batch_size=8,
                 actor_hidden=HIDDEN, critic_hidden=HIDDEN, replay_capacity=256,
                 replay_min_size=48, fused_chunk="off", fused_beat="on", superstep_beats=2,
                 data_axis=2)
BEAT_VARIANTS = {
    f"{per}-{ring}-{guard}": dict(prioritized=per == "per", replay_sharding=ring,
                                  guardrails=guard == "guarded")
    for per in ("uniform", "per") for ring in ("replicated", "sharded")
    for guard in ("plain", "guarded")
}
BETAS = np.array([0.5, 0.6, 0.7], np.float32)


def _jax_stack(jcfg):
    mesh = _mesh2()
    pool = JaxPool(jcfg, mesh=mesh)
    learner = JaxLearner(jcfg, pool.obs_dim, pool.act_dim, pool.action_scale,
                         action_offset=pool.action_offset, mesh=mesh,
                         chunk_size=jcfg.learner_chunk, replay_sharding=jcfg.replay_sharding)
    cls = jax_device.DevicePrioritizedReplay if jcfg.prioritized else jax_device.DeviceReplay
    replay = cls(jcfg.replay_capacity, pool.obs_dim, pool.act_dim, mesh=mesh, block_size=16,
                 async_ship=False, replay_sharding=jcfg.replay_sharding)
    pool.set_params(learner.state.actor_params)
    while int(replay.size) < jcfg.replay_min_size:
        pool.run_chunk(replay)
    return learner, pool, replay


def _logical(replay, x):
    x = _np(x)
    return replay._to_logical_rows(x) if replay.sharded else x


def _jax_numbers(jcfg, jl, jp, jr, beta, key=None, carry_key=None, size=None):
    """The numbers JAX's next beat draws: the learner leg's global indices
    (PER: and weights, the sharded draw on a sharded ring) and the
    rollout's draws of all E envs."""
    key = jl._key if key is None else key
    size = int(_np(jr.size)) if size is None else size
    key, sub = jax.random.split(key)
    shape = (jcfg.learner_chunk, jcfg.batch_size * 2)
    out = {}
    if jcfg.prioritized:
        if jr.sharded:
            draw = jax_device.make_sharded_per_draw(jl.mesh)
            scalar = NamedSharding(jl.mesh, P())
            fn = jax.jit(lambda k, p, s: draw(k, p, s, shape, jnp.float32(beta)),
                         in_shardings=(scalar, NamedSharding(jl.mesh, P("data")), scalar),
                         out_shardings=(scalar, scalar))
            idx, w = fn(sub, jr.priorities, jnp.int32(size))
        else:
            idx, w = jax.jit(jax_device.draw_per_indices, static_argnums=3)(
                sub, jr.priorities, jnp.int32(size), shape, jnp.float32(beta))
        out.update(idx=np.array(idx), weights=np.array(w))
    else:
        out["idx"] = np.array(jax.random.randint(sub, shape, 0, max(size, 1)))
    carry_key = jp._carry.key if carry_key is None else carry_key
    carry_key, draws = _step_draws(carry_key, jp.chunk_size, jp.num_envs)
    out.update(draws)
    return out, key, carry_key


def _jax_view(jl, jp, jr):
    out = dict(state_arrays(jax.tree.map(np.asarray, jl.state)))
    out["ring"] = _logical(jr, jr.storage)
    out["ptr"], out["size"] = int(_np(jr.ptr)), int(_np(jr.size))
    if hasattr(jr, "priorities"):
        out["prios"] = _logical(jr, jr.priorities)
        out["max_priority"] = float(_np(jr.max_priority))
    c = jp._carry
    for i, t in enumerate(c.env_state):
        out[f"carry/env_state{i}"] = _np(t)
    for k in ("obs", "ou", "ep_ret", "steps", "episodes", "ret_sum"):
        out[f"carry/{k}"] = _np(getattr(c, k))
    if jl.guard_enabled:
        for k in jl._guard._fields:
            out[f"guard/{k}"] = _np(getattr(jl._guard, k))
    return out


def _assert_stage(stage, res, want, rank, lo, hi):
    for k, v in want.items():
        got = res[f"{stage}/{k}"]
        name = f"rank {rank} {stage} {k}"
        if k.startswith("carry/") and np.ndim(v) >= 1:
            v = v[lo:hi]
        if k in ("ptr", "size") or k.endswith("count") or k.endswith("step") \
                or k in ("carry/steps", "carry/episodes") or (
                k.startswith("guard/") and v.dtype.kind == "i"):
            assert np.array_equal(got, v), name
        else:
            _close(name, got, v)


@pytest.mark.parametrize("variant", list(BEAT_VARIANTS))
def test_beat_and_superstep_on_two_ranks_match_jax(variant, tmp_path):
    kw = dict(BEAT_BASE, **BEAT_VARIANTS[variant])
    jcfg = JaxConfig(**kw)
    per, guard = jcfg.prioritized, jcfg.guardrails
    jl, jp, jr = _jax_stack(jcfg)
    twin = _jax_stack(jcfg) if per else None
    # The port's inputs: JAX's stack as it stands.
    arrays = dict(state_arrays(jax.tree.map(np.asarray, jl.state)))
    arrays["ring"] = _logical(jr, jr.storage)
    arrays["ptr"], arrays["size"] = np.int64(_np(jr.ptr)), np.int64(_np(jr.size))
    if per:
        arrays["prios"] = _logical(jr, jr.priorities)
        arrays["max_priority"] = np.float32(_np(jr.max_priority))
    c = jp._carry
    for i, t in enumerate(c.env_state):
        arrays[f"carry/env_state{i}"] = _np(t)
    for k in ("obs", "ou", "ep_ret", "steps", "episodes", "ret_sum"):
        arrays[f"carry/{k}"] = _np(getattr(c, k))
    arrays["betas"] = BETAS
    # One beat.
    nums, key, carry_key = _jax_numbers(jcfg, jl, jp, jr, BETAS[0])
    arrays.update({f"beat0/{k}": v for k, v in nums.items()})
    jout = JaxMegastep(jcfg, jl, jp, jr).run_beat(float(BETAS[0]) if per else None)
    want = {"beat": dict(_jax_view(jl, jp, jr), td=_np(jout.td_errors),
                         metrics=np.array([float(jout.metrics[k]) for k in METRIC_KEYS]))}
    if guard:
        h = jl.poll_health()
        want["beat"]["health"] = [h[k] for k in ("total", "nonfinite", "spikes", "skipped",
                                                 "bad_rows")]
    # The superstep's numbers: a uniform draw's from the keys and the ring's
    # size, a PER draw's from the twin stack stepped beat by beat.
    size = int(_np(jr.size))
    if per:
        tms = JaxMegastep(jcfg, *twin)
        tms.run_beat(float(BETAS[0]))
    for b in range(2):
        if per:
            nums, _, _ = _jax_numbers(jcfg, *twin, BETAS[1 + b])
            tms.run_beat(float(BETAS[1 + b]))
        else:
            nums, key, carry_key = _jax_numbers(jcfg, jl, jp, jr, None, key=key,
                                                carry_key=carry_key, size=size)
            size = min(size + jp.rows_per_chunk, jcfg.replay_capacity)
        arrays.update({f"super{b}/{k}": v for k, v in nums.items()})
    jout = JaxSuperstep(jcfg, jl, jp, jr).run_superstep(betas=BETAS[1:] if per else None)
    want["super"] = dict(_jax_view(jl, jp, jr),
                         last=np.array([float(jout.metrics[k]) for k in METRIC_KEYS]))
    if guard:
        h = jl.poll_health()
        want["super"]["health"] = [h[k] for k in ("total", "nonfinite", "spikes", "skipped",
                                                  "bad_rows")]
        want["super"]["first_bad_beat"] = h["first_bad_beat"]
    spec = dict(kind="beats", config=kw, sharded=kw["replay_sharding"] == "sharded",
                superstep=2)
    results = run_ranks(tmp_path, spec, arrays, world=2)
    for r, res in enumerate(results):
        lo, hi = r * 4, (r + 1) * 4          # E = 8 envs sharded over 2 ranks
        for stage in ("beat", "super"):
            w = dict(want[stage])
            health = w.pop("health", None)
            first_bad = w.pop("first_bad_beat", None)
            metrics, last = w.pop("metrics", None), w.pop("last", None)
            td = w.pop("td", None)
            _assert_stage(stage, res, w, r, lo, hi)
            if metrics is not None:
                _close(f"rank {r} {stage} metrics", res[f"{stage}/metrics"], metrics,
                       METRIC_RTOL)
                _close(f"rank {r} {stage} td", res[f"{stage}/td"], td)
            if last is not None:
                _close(f"rank {r} {stage} last metrics", res[f"{stage}/metrics"][-1], last,
                       METRIC_RTOL)
            if health is not None:
                assert res[f"{stage}/health"].tolist() == health, (r, stage)
            if first_bad is not None:
                assert int(res[f"{stage}/first_bad_beat"]) == first_bad
            assert bool(res[f"{stage}/same_as_separate"]), (r, stage)
            assert bool(res[f"{stage}/replicas"]), (r, stage)


# --- the trainer on two ranks ----------------------------------------------------------

TINY = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=16, eval_every=0,
            eval_episodes=1, replay_capacity=4096, replay_min_size=128)


@pytest.mark.parametrize("name,config", [
    ("device-guarded-per-superstep", dict(
        TINY, actor_backend="device", num_actors=0, device_actor_envs=16,
        device_actor_chunk=4, learner_chunk=4, total_env_steps=768, data_axis=2,
        guardrails=True, prioritized=True, fused_chunk="off", fused_beat="on",
        superstep_beats=2, fused_update=True)),
    ("ondevice", dict(TINY, backend="jax_ondevice", num_actors=8, total_env_steps=1024,
                      data_axis=2, fused_update=True)),
    ("device-grid-k2", dict(
        TINY, actor_backend="device", num_actors=0, device_actor_envs=16,
        device_actor_chunk=4, learner_chunk=4, total_env_steps=512, model_axis=2,
        fused_update=True)),
])
def test_train_on_two_ranks_finishes_with_identical_replicas(name, config, tmp_path):
    results = run_ranks(tmp_path, dict(kind="train", config=config), {}, world=2)
    summaries = [json.loads(str(r["summary"])) for r in results]
    for s in summaries:
        assert s["env_steps"] >= config["total_env_steps"] and s["learner_steps"] > 0
        if config.get("backend") != "jax_ondevice":
            assert s["replicas_identical"] is True
            assert s["devactor_env_steps"] == s["env_steps"]
    assert summaries[0]["learner_steps"] == summaries[1]["learner_steps"]
    if config.get("superstep_beats", 1) > 1:
        assert summaries[0]["fused_beat_active"] and summaries[0]["fused_superstep_beats"] == 2


def test_device_actor_run_on_two_ranks_resumes_without_a_sharded_sidecar(tmp_path):
    """A device-actor run at D = 2 (16 envs, 8 a rank) checkpoints every
    chunk with no rollout sidecar (no rank holds the whole carry), then a
    longer run resumes from it on both ranks through the resume election."""
    ck = str(tmp_path / "ck")
    base = dict(TINY, actor_backend="device", num_actors=0, device_actor_envs=16,
                device_actor_chunk=4, learner_chunk=4, data_axis=2, checkpoint_dir=ck,
                checkpoint_every=4)
    first = run_ranks(tmp_path, dict(kind="train", config=dict(base, total_env_steps=384)),
                      {}, name="first", world=2)
    steps = sorted(p for p in (tmp_path / "ck").iterdir() if p.name.startswith("step_"))
    assert steps and not any((p / "devactor_carry.npz").exists() for p in steps)
    second = run_ranks(tmp_path, dict(kind="train", config=dict(base, total_env_steps=768)),
                       {}, name="second", world=2)
    done = json.loads(str(first[0]["summary"]))["learner_steps"]
    for r in second:
        s = json.loads(str(r["summary"]))
        assert s["resumed_from"] == done and s["replicas_identical"] is True
        assert s["env_steps"] >= 768


GUARD_DRILL = dict(num_actors=1, actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=16,
                   learner_chunk=8, replay_min_size=200, eval_every=0, eval_episodes=1,
                   guardrails=True, max_learn_ratio=1.0, max_ingest_ratio=1.0, data_axis=2,
                   guardrail_zmax=1000.0)


def test_rollback_drill_on_two_ranks_rolls_both_back_together(tmp_path):
    """README's rollback drill at D = 2 (numeric:grad:nan at guarded steps
    300 and 330, a rollback after two anomalies): both ranks roll back to
    the same step and finish with bit-identical replicas."""
    ck = str(tmp_path / "ck")
    rollback = dict(GUARD_DRILL, fused_update=True, total_env_steps=1000, checkpoint_dir=ck,
                    checkpoint_every=8, checkpoint_keep=8, guardrail_rollback_k=2,
                    faults="numeric:grad:nan@300;numeric:grad:nan@330")
    res = run_ranks(tmp_path, dict(kind="train", config=rollback), {}, name="rollback",
                    world=2)
    s0, s1 = (json.loads(str(r["summary"])) for r in res)
    assert s0["guardrail_rollbacks"] >= 1 and s0["guardrail_nonfinite_steps"] >= 2
    for k in ("guardrail_rollbacks", "guardrail_last_rollback_step", "learner_steps",
              "guardrail_nonfinite_steps"):
        assert s0[k] == s1[k], k
    assert s0["replicas_identical"] is True and s0["env_steps"] >= 1000


def test_poison_drill_on_two_ranks_quarantines_the_source(tmp_path):
    """The poison drill at D = 2 (numeric:replay:inf@300 on two host
    actors): rank 0's rows reach both ranks with their actor slots, both
    count the bad row, rank 0's pool quarantines the slot. Paced by the
    ingest gate (ratio 2: ~1150 learner steps of 32 rows for 2500 env
    steps) so the poisoned row, shipped with its 1024-row block, is drawn
    some ten thousand draws after it lands."""
    poison = dict(GUARD_DRILL, num_actors=2, total_env_steps=2500, guardrail_rollback_k=0,
                  max_learn_ratio=0.0, max_ingest_ratio=2.0,
                  guardrail_source_offenses=1, faults="numeric:replay:inf@300")
    res = run_ranks(tmp_path, dict(kind="train", config=poison), {}, name="poison", world=2)
    s0, s1 = (json.loads(str(r["summary"])) for r in res)
    assert s0["guardrail_bad_rows"] >= 1 and s0["guardrail_bad_rows"] == s1["guardrail_bad_rows"]
    assert s0["guardrail_source_quarantines"] >= 1 and s0["actor_quarantined"] == 1
    assert s0["replicas_identical"] is True
