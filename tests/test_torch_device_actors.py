"""The port's device actors (actors/device_pool.py, ops/exploration.py,
replay/device.py insert_device_rows, the devactor_carry.npz sidecar, the
config fields) against the JAX package's, on the CPU at tiny widths.

- The rollout's rows against the JAX DeviceActorPool's (its scan over
  jax_envs, the rows landed in a JAX DeviceReplay) from one converted
  state, JAX's draws passed in: the pool's key schedule replayed here (the
  init split, then each step's split into next, ou, env and uniform keys:
  the OU or SAC normals, every env's reset values, the warmup uniforms).
  DDPG with OU noise and SAC through its uniform warmup (the first two
  steps uniform, then the Gaussian policy), 2 rollouts each, K = 6, E = 4,
  at rtol 1e-5, atol 1e-5 (tests/test_device_actors.py's tolerance).
- insert_device_rows: the wraparound and PER's max-priority stamp, against
  JAX's DevicePrioritizedReplay (storage, priorities, ptr, size equal).
- The bounded restart, driven by a failing hook (the plan's
  `devactor:rollout` site takes the same place; tests/test_torch_faults.py
  drives it through the CLI): one failure absorbed with the same rows as
  an unfailed pool; four exhaust the budget (DeviceActorError with the
  cause).
- The carry round trip (the resumed pool's next rollout bit-identical to
  the uninterrupted one's; the warmup counter kept, steps_done not) and the
  mismatch fallback (another E, an empty snapshot).
- The sidecar through checkpoint.save / restore (covered by the manifest),
  and a CLI run resumed from its checkpoint that continues its episodes.
- The config: every refusal JAX makes, with JAX's message; D > 1 ranks
  accepted as JAX accepts them (the same fields); resolve_device_actor_chunk.
- Stale params: a rollout after a learner chunk equals a rollout from a
  copy of the learner's NEW actor params, bit for bit, and differs from
  one with the old params.
- The CLI with num_actors=0 (devactor_* in the records, no transfer
  ingest item), and host and device actors side by side.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.actors.device_pool import DeviceActorPool as JaxPool
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs.jax_envs import JaxPendulum
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.parallel import mesh as jax_mesh
from distributed_ddpg_tpu.replay.device import DevicePrioritizedReplay as JaxPER
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxReplay
from distributed_ddpg_tpu_torch import checkpoint as ckpt
from distributed_ddpg_tpu_torch.actors.device_pool import (
    DeviceActorError,
    DeviceActorPool,
    resolve_device_actor_chunk,
)
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import init_train_state, train_state_from_numpy
from distributed_ddpg_tpu_torch.ops.exploration import StepDraws
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
from test_torch_slice import REPO, train_in_subprocess

torch.set_num_threads(1)

E, K = 4, 6
TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_device_actors.py


def _cfgs(**kw):
    base = dict(env_id="Pendulum-v1", actor_backend="device", num_actors=0,
                device_actor_envs=E, device_actor_chunk=K, actor_hidden=(16, 16),
                critic_hidden=(16, 16), replay_capacity=4096)
    base.update(kw)
    return JaxConfig(**base), DDPGConfig(device="cpu", **base)


def _one_device_mesh():
    return jax_mesh.make_mesh(data_axis=1, model_axis=1, devices=jax.devices()[:1])


def _jax_draws(jcfg, n_steps):
    """The JAX pool's key schedule (its __init__ and env_step): the
    initial env state's reset values, then each step's normals, every
    env's reset values and the warmup uniforms, as the port's StepDraws."""
    env = JaxPendulum()
    key = jax.random.PRNGKey(jcfg.seed + 0xDA)
    k_init, key = jax.random.split(key)
    init = jax.vmap(env.init)(jax.random.split(k_init, E))
    low, high = jnp.asarray(env.action_low), jnp.asarray(env.action_high)
    draws = []
    for _ in range(n_steps):
        key, k_ou, k_env, k_uni = jax.random.split(key, 4)
        fresh = jax.vmap(env.init)(jax.random.split(k_env, E))
        draws.append(StepDraws(
            noise=torch.from_numpy(np.array(jax.random.normal(k_ou, (E, 1), jnp.float32))),
            reset=torch.from_numpy(np.stack([np.asarray(fresh.th), np.asarray(fresh.thdot)], 1)),
            uniform=torch.from_numpy(np.array(jax.random.uniform(
                k_uni, (E, 1), jnp.float32, minval=low, maxval=high)))))
    return np.stack([np.asarray(init.th), np.asarray(init.thdot)], 1), draws


def _port_pool(cfg, init, params):
    pool = DeviceActorPool(cfg)
    pool._carry = pool._carry._replace(env_state=pool.env.init(torch.from_numpy(init)))
    pool._carry = pool._carry._replace(obs=pool.env.observe(pool._carry.env_state))
    pool.set_params(params)
    return pool


@pytest.mark.parametrize("family", ["ddpg", "sac-warmup"])
def test_rollout_rows_match_the_jax_pool(family):
    over = dict(sac=True, warmup_uniform_steps=2 * E) if family == "sac-warmup" else {}
    jcfg, cfg = _cfgs(**over)
    mesh = _one_device_mesh()
    jpool = JaxPool(jcfg, mesh=mesh)
    jstate = jax_init(jcfg, jpool.obs_dim, jpool.act_dim, jcfg.seed)
    jpool.set_params(jstate.actor_params)
    jrep = JaxReplay(jcfg.replay_capacity, jpool.obs_dim, jpool.act_dim, mesh=mesh,
                     block_size=64, async_ship=False)
    init, draws = _jax_draws(jcfg, 2 * K)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    pool = _port_pool(cfg, init, state.actor_params)
    rep = DeviceReplay(cfg.replay_capacity, pool.obs_dim, pool.act_dim, device="cpu")
    for c in range(2):
        jpool.set_params(jstate.actor_params)
        assert jpool.run_chunk(jrep) == K * E
        assert pool.run_chunk(rep, draws=draws[c * K:(c + 1) * K]) == K * E
    want = np.asarray(jax.device_get(jrep.storage))[:2 * K * E]
    got = rep.storage[:2 * K * E].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (len(rep), rep.ptr) == (int(jrep.size), int(jrep.ptr)) == (2 * K * E, 2 * K * E)
    if family == "sac-warmup":
        # The first two steps' actions are the warmup uniforms, row for row.
        np.testing.assert_array_equal(got[:2 * E, 3], np.concatenate(
            [draws[0].uniform.numpy()[:, 0], draws[1].uniform.numpy()[:, 0]]))
        assert not np.array_equal(got[2 * E:3 * E, 3], draws[2].uniform.numpy()[:, 0])


def test_insert_device_rows_wraparound_and_per_stamp_match_jax():
    mesh = _one_device_mesh()
    jper = JaxPER(64, 3, 1, mesh=mesh, block_size=16, async_ship=False)
    per = DevicePrioritizedReplay(64, 3, 1, device="cpu", block_size=16)
    width = per.width
    rows = np.arange(48 * width, dtype=np.float32).reshape(48, width)
    for r in (rows, rows + 1000.0):
        jper.insert_device_rows(jax.device_put(jnp.asarray(r)))
        per.insert_device_rows(torch.from_numpy(r))
        assert len(per) == int(jper.size) and per.ptr == int(jax.device_get(jper.ptr))
        np.testing.assert_array_equal(per.storage.numpy(), np.asarray(jax.device_get(jper.storage)))
        np.testing.assert_array_equal(per.priorities.numpy(),
                                      np.asarray(jax.device_get(jper.priorities)))
        # A later max priority stamps the next run.
        per.max_priority.fill_(2.5)
        jper.set_per_state(jper.priorities, jnp.asarray(2.5, jnp.float32))
    assert (len(per), per.ptr) == (64, 32)
    np.testing.assert_array_equal(per.storage[0].numpy(), rows[16] + 1000.0)
    np.testing.assert_array_equal(per.priorities[:32].numpy(), np.full(32, 2.5, np.float32))
    np.testing.assert_array_equal(per.priorities[32:48].numpy(), np.ones(16, np.float32))
    np.testing.assert_array_equal(per.priorities[48:].numpy(), np.full(16, 2.5, np.float32))


def test_device_rows_stamp_the_source_map_untracked():
    rep = DeviceReplay(32, 3, 1, device="cpu", block_size=8, track_sources=True)
    rep.add_packed(np.ones((8, rep.width), np.float32), source=3)
    rep.insert_device_rows(torch.zeros((12, rep.width)))
    rep.add_packed(np.ones((16, rep.width), np.float32), source=5)
    src = rep.sources_of(np.arange(32))
    np.testing.assert_array_equal(src, [5] * 4 + [3] * 4 + [-1] * 12 + [5] * 12)


class _Failing:
    """A fault hook whose tick() raises on the listed calls (1-based)."""

    def __init__(self, at):
        self.at, self.n = set(at), 0

    def tick(self):
        self.n += 1
        if self.n in self.at:
            raise RuntimeError(f"injected rollout failure {self.n}")


class _FailingInsert(DeviceReplay):
    """A replay whose listed insert_device_rows calls (1-based) raise: the
    rollout has already advanced the carry when the insert fails."""

    def __init__(self, at, *a):
        super().__init__(*a)
        self.at, self.n = set(at), 0

    def insert_device_rows(self, rows):
        self.n += 1
        if self.n in self.at:
            raise RuntimeError(f"injected insert failure {self.n}")
        return super().insert_device_rows(rows)


@pytest.mark.parametrize("where", ["before-rollout", "at-insert"])
def test_bounded_restart_absorbs_a_failure_then_exhausts(where):
    _, cfg = _cfgs()
    params = init_train_state(cfg, 3, 1, 0).actor_params
    clean = DeviceActorPool(cfg)
    clean.set_params(params)
    r1 = DeviceReplay(4096, 3, 1, device="cpu")
    if where == "before-rollout":
        failing = DeviceActorPool(cfg, fault=_Failing({2}))
        r2 = DeviceReplay(4096, 3, 1, device="cpu")
    else:
        failing = DeviceActorPool(cfg)
        r2 = _FailingInsert({2}, 4096, 3, 1, "cpu")
    failing.set_params(params)
    for _ in range(2):
        assert clean.run_chunk(r1) == failing.run_chunk(r2) == K * E
    assert failing.restarts == 1 and clean.restarts == 0
    assert failing.snapshot()["devactor_restarts"] == 1
    np.testing.assert_array_equal(r1.storage.numpy(), r2.storage.numpy())
    # The failed dispatch moved nothing: carry and counters as the clean pool's.
    assert failing.carry.host_steps == int(failing.carry.steps) == 2 * K * E
    assert failing.steps_done == clean.steps_done == 2 * K * E
    for x, y in zip(clean._leaves(clean.carry), failing._leaves(failing.carry)):
        assert torch.equal(x, y)
    if where == "at-insert":
        return
    doomed = DeviceActorPool(cfg, fault=_Failing(range(1, 10)))
    doomed.set_params(params)
    with pytest.raises(DeviceActorError) as ei:
        doomed.run_chunk(r2)
    assert isinstance(ei.value.__cause__, RuntimeError) and doomed.restarts == 3
    with pytest.raises(DeviceActorError, match="bind"):
        DeviceActorPool(cfg).run_chunk(r2)


def test_carry_round_trip_continues_the_rollout():
    _, cfg = _cfgs(warmup_uniform_steps=100)
    params = init_train_state(cfg, 3, 1, 0).actor_params
    a = DeviceActorPool(cfg)
    a.set_params(params)
    rep = DeviceReplay(4096, 3, 1, device="cpu")
    a.run_chunk(rep)
    a.run_chunk(rep)
    snap = a.carry_state_dict()
    assert all(isinstance(v, np.ndarray) for v in snap.values())
    b = DeviceActorPool(cfg)
    b.set_params(params)
    assert b.load_carry_state(snap) is True
    cont, rest = DeviceReplay(4096, 3, 1, device="cpu"), DeviceReplay(4096, 3, 1, device="cpu")
    a.run_chunk(cont)
    b.run_chunk(rest)
    np.testing.assert_array_equal(cont.storage.numpy(), rest.storage.numpy())
    assert int(b.carry.steps) == b.carry.host_steps == 3 * K * E
    assert b.steps_done == K * E
    other = DeviceActorPool(_cfgs(device_actor_envs=2 * E)[1])
    assert other.load_carry_state(snap) is False
    assert other.load_carry_state({}) is False


def test_checkpoint_carries_the_sidecar(tmp_path):
    _, cfg = _cfgs()
    state = init_train_state(cfg, 3, 1, 0)
    pool = DeviceActorPool(cfg)
    pool.set_params(state.actor_params)
    rep = DeviceReplay(4096, 3, 1, device="cpu")
    pool.run_chunk(rep)
    d = str(tmp_path)
    ckpt.save(d, 7, state, rep, cfg, env_steps=K * E, devactor_state=pool.carry_state_dict())
    assert os.path.exists(os.path.join(d, "step_7", "devactor_carry.npz"))
    manifest = json.load(open(os.path.join(d, "manifest_7.json")))
    assert "devactor_carry.npz" in manifest["files"]
    assert ckpt.verify_checkpoint(d, 7)[0]
    meta = {}
    _, step, env_steps = ckpt.restore(d, state, DeviceReplay(4096, 3, 1, device="cpu"), meta_out=meta)
    assert (step, env_steps) == (7, K * E) and "devactor_carry" in meta
    fresh = DeviceActorPool(cfg)
    assert fresh.load_carry_state(meta["devactor_carry"]) is True
    assert fresh.carry.host_steps == K * E


DEVICE_FLAGS = ["--actor_backend=device", "--num_actors=0", "--device_actor_envs=8",
                "--device_actor_chunk=4", "--learner_chunk=4", "--batch_size=16",
                "--actor_hidden=16,16", "--critic_hidden=16,16", "--replay_capacity=20000",
                "--replay_min_size=200", "--eval_every=0", "--eval_episodes=1"]


def _cli(flags, log_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-m", "distributed_ddpg_tpu_torch.train",
                          "--device=cpu", *flags, f"--log_path={log_path}"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in open(log_path)], res.stderr


def test_cli_resume_continues_the_rollout(tmp_path):
    d = str(tmp_path / "ck")
    flags = DEVICE_FLAGS + [f"--checkpoint_dir={d}", "--checkpoint_every=40"]
    first, _ = _cli(flags + ["--total_env_steps=1600"], tmp_path / "a.jsonl")
    step = ckpt.latest_step(d)
    assert step is not None and os.path.exists(
        os.path.join(d, f"step_{step}", "devactor_carry.npz"))
    carry = dict(np.load(os.path.join(d, f"step_{step}", "devactor_carry.npz")))
    second, err = _cli(flags + ["--total_env_steps=3200"], tmp_path / "b.jsonl")
    assert f"rollout state restored: {int(carry['leaf_6'])} env steps" in err
    final = second[-1]
    assert final["kind"] == "final" and final["step"] >= 3200
    # Each of the 8 envs ends an episode every 200 of its steps: at 1600
    # and 3200 env steps in all when the episodes go on from the carry; had
    # the resumed run reset them at its start, the second round would end
    # 1600 env steps after the restored step, past 3200.
    assert 0 < int(carry["leaf_6"]) < 1600
    assert final["devactor_episodes"] == 16


def test_cli_device_only_trains_and_ships_nothing(tmp_path):
    records = train_in_subprocess(DEVICE_FLAGS + ["--total_env_steps=1600"],
                                  tmp_path / "m.jsonl")
    final = records[-1]
    assert final["kind"] == "final" and final["learner_steps"] > 0
    assert final["devactor_env_steps"] >= 1600 and final["devactor_restarts"] == 0
    assert {"devactor_rows_per_s", "devactor_chunk_p95"} <= set(final)
    seen = [r["transfer_ingest_items"] for r in records if "transfer_ingest_items" in r]
    assert seen and all(v == 0 for v in seen)
    assert np.isfinite(final["final_return"]) and "fused_beats" not in final


def test_cli_host_and_device_actors_side_by_side(tmp_path):
    flags = [f for f in DEVICE_FLAGS if not f.startswith(("--num_actors", "--device_actor_envs",
                                                          "--device_actor_chunk"))]
    records = train_in_subprocess(flags + ["--num_actors=1", "--device_actor_envs=2",
                                           "--device_actor_chunk=2", "--total_env_steps=1500",
                                           "--shm_ring_rows=128"], tmp_path / "m.jsonl")
    final = records[-1]
    assert final["learner_steps"] > 0 and final["devactor_env_steps"] > 0
    assert final["step"] > final["devactor_env_steps"]


# --- the config ----------------------------------------------------------------

REFUSED = [
    dict(actor_backend="device", env_id="HalfCheetah-v4"),
    dict(actor_backend="device", num_actors=0, device_actor_chunk=8, backend="native"),
    dict(actor_backend="device", num_actors=0, device_actor_chunk=8, n_step=3),
    dict(actor_backend="device", num_actors=0, device_actor_chunk=8, host_replay=True),
    dict(actor_backend="device", num_actors=0, device_actor_chunk=8, strict_sync=True,
         max_learn_ratio=1.0, max_ingest_ratio=1.0),
    dict(actor_backend="device", num_actors=0, device_actor_chunk=8, serve_actors=True),
    dict(num_actors=0),
    dict(actor_backend="gpu"),
    dict(actor_backend="device", device_actor_envs=512, device_actor_chunk=16,
         replay_capacity=4096),
    dict(actor_backend="device", device_actor_envs=0),
    dict(actor_backend="device", device_actor_chunk=-1),
    dict(fused_beat="sometimes"),
    dict(fused_beat="on"),
    dict(fused_beat="on", actor_backend="device", device_actor_chunk=8, fused_chunk="on"),
    dict(fused_beat="on", actor_backend="device", device_actor_chunk=8, max_ingest_ratio=1.0),
    dict(fused_beat="on", backend="native"),
    dict(superstep_beats=0),
    dict(superstep_beats=4, fused_beat="off"),
    dict(backend="jax_ondevice", v_min=float("nan"), v_max=float("nan"), distributional=True),
    dict(backend="jax_ondevice", guardrails=True),
]


@pytest.mark.parametrize("over", REFUSED, ids=[str(i) for i in range(len(REFUSED))])
def test_config_refusals_match_jax(over):
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**over)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(device="cpu", **over)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("over", [
    dict(actor_backend="device", num_actors=0, device_actor_chunk=8),
    dict(backend="jax_ondevice"),
], ids=["device-actors", "ondevice"])
def test_more_than_one_rank_is_refused_citing_item_10(over):
    # Ported since: both run on D > 1 ranks (tests/test_torch_dataplane_ranks.py),
    # and the config takes every JAX field as the JAX package does.
    theirs = JaxConfig(data_axis=2, **over)
    ours = DDPGConfig(device="cpu", data_axis=2, **over)
    for f in dataclasses.fields(JaxConfig):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert a == b or a != a and b != b, f.name   # NaN: an 'auto' field


def test_resolve_device_actor_chunk():
    assert resolve_device_actor_chunk(DDPGConfig(device_actor_chunk=5)) == 5
    assert resolve_device_actor_chunk(DDPGConfig()) == 64
    assert resolve_device_actor_chunk(DDPGConfig(device="cpu")) == 8
    fields = {f: getattr(DDPGConfig(), f) for f in (
        "actor_backend", "device_actor_envs", "device_actor_chunk", "fused_beat",
        "superstep_beats")}
    assert fields == {f: getattr(JaxConfig(), f) for f in fields}


# --- stale params ------------------------------------------------------------------

def test_rollout_after_a_chunk_reads_the_new_params():
    _, cfg = _cfgs(batch_size=16, learner_chunk=4)
    learner = ShardedLearner(cfg, 3, 1, np.array([2.0], np.float32), chunk_size=4)
    rep = DeviceReplay(4096, 3, 1, device="cpu")
    warm = DeviceActorPool(cfg)
    warm.bind(lambda: learner.state.actor_params)
    for _ in range(4):
        warm.run_chunk(rep)
    old = [{k: v.clone() for k, v in layer.items()} for layer in learner.state.actor_params]
    learner.run_sample_chunk(rep)
    new = [{k: v.clone() for k, v in layer.items()} for layer in learner.state.actor_params]
    rows = {}
    for name, params in (("bound", None), ("new", new), ("old", old)):
        pool = DeviceActorPool(cfg)
        if params is None:
            pool.bind(lambda: learner.state.actor_params)
        else:
            pool.set_params(params)
        out = DeviceReplay(4096, 3, 1, device="cpu")
        pool.run_chunk(out)
        rows[name] = out.storage[:K * E].numpy()
    np.testing.assert_array_equal(rows["bound"], rows["new"])
    assert not np.array_equal(rows["bound"], rows["old"])
