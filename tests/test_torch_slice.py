"""The port's slice as a whole, on the CPU at a small size.

- The same rows into both device replays, then the port's
  ShardedLearner.run_sample_chunk(idx=...) with indices drawn by numpy,
  against the JAX package's gather of those indices followed by K calls of
  its make_learner_step (rtol 2e-5, atol 1e-6; chunk-mean metrics 5e-5).
- A tiny run of `distributed_ddpg_tpu_torch.train` (Pendulum, one actor
  process, device="cpu"), in a subprocess with a timeout so that the actor
  pool never starts in the test process, and the keys of its JSONL
  records.
- The actors' numpy policy, loaded from actor_params_to_host, against the
  JAX actor_apply.
- The port imports neither jax nor distributed_ddpg_tpu; asking for the
  card where there is none raises.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import types as jax_types
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.learner import make_learner_step as jax_step
from distributed_ddpg_tpu.models.mlp import actor_apply as jax_actor_apply
from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from distributed_ddpg_tpu_torch.actors.policy import NumpyPolicy, param_layout
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, resolve_learner_chunk
from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT, B, K = 3, 1, 8, 4
HIDDEN = (32, 32)
RTOL, ATOL = 2e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _configs():
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3)
    return JaxConfig(**common), DDPGConfig(device="cpu", **common)


def _rows(rng, n):
    rows = rng.standard_normal((n, 2 * OBS + ACT + 3)).astype(np.float32)
    rows[:, OBS:OBS + ACT] = np.tanh(rows[:, OBS:OBS + ACT]) * 2.0   # actions in the box
    rows[:, OBS + ACT + 1] = 0.99                                     # discount
    rows[:, -1] = 1.0                                                 # uniform weight
    return rows


def test_sample_chunk_matches_jax_gather_and_steps():
    jcfg, cfg = _configs()
    jstate = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    rng = np.random.default_rng(0)
    port_replay = DeviceReplay(64, OBS, ACT, device="cpu", block_size=16)
    jax_replay = JaxDeviceReplay(64, OBS, ACT, block_size=16)
    for n in (20, 30, 40):
        rows = _rows(rng, n)
        port_replay.add_packed(rows)
        jax_replay.add_packed(rows)
    assert len(port_replay) == len(jax_replay) == 64
    idx = rng.integers(0, len(port_replay), (K, B))

    learner = ShardedLearner(cfg, OBS, ACT, 2.0, 0.0, chunk_size=K,
                             state=train_state_from_numpy(jax.tree.map(np.asarray, jstate)))
    out = learner.run_sample_chunk(port_replay, idx=torch.from_numpy(idx))

    storage, _ = jax_replay.device_state()
    packed = storage[jnp.asarray(idx)]
    step = jax.jit(jax_step(jcfg, 2.0))
    tds, metrics = [], []
    for k in range(K):
        jout = step(jstate, jax_types.unpack_batch(packed[k], OBS, ACT))
        jstate = jout.state
        tds.append(np.asarray(jout.td_errors))
        metrics.append(jout.metrics)
    ref = jax.tree.map(np.asarray, jstate)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for lp, lr in zip(getattr(learner.state, group), getattr(ref, group)):
            for key in ("w", "b"):
                _close(lp[key].numpy(), lr[key])
    assert int(learner.state.critic_opt.count) == int(ref.critic_opt.count) == K
    assert int(learner.state.step) == int(ref.step) == K
    _close(out.td_errors.numpy(), np.stack(tds))
    host = learner.metrics_to_host(out)
    for name in METRIC_KEYS:
        _close(host[name], np.mean([float(m[name]) for m in metrics]), 5e-5, ATOL)


def test_run_chunk_matches_run_sample_chunk():
    """Host-fed batches (run_chunk) and the same rows gathered on the
    device (run_sample_chunk) give the same chunk."""
    _, cfg = _configs()
    rng = np.random.default_rng(5)
    replay = DeviceReplay(64, OBS, ACT, device="cpu", block_size=16)
    replay.add_packed(_rows(rng, 64))
    idx = rng.integers(0, 64, (K, B))
    a = ShardedLearner(cfg, OBS, ACT, 2.0, chunk_size=K)
    b = ShardedLearner(cfg, OBS, ACT, 2.0, chunk_size=K)
    out_a = a.run_sample_chunk(replay, idx=torch.from_numpy(idx))
    rows = replay.storage.numpy()[idx]
    o = OBS
    out_b = b.run_chunk({
        "obs": rows[..., :o], "action": rows[..., o:o + ACT],
        "reward": rows[..., o + ACT], "discount": rows[..., o + ACT + 1],
        "next_obs": rows[..., o + ACT + 2:2 * o + ACT + 2], "weight": rows[..., -1],
    })
    np.testing.assert_array_equal(out_a.td_errors.numpy(), out_b.td_errors.numpy())
    np.testing.assert_array_equal(a.actor_params_to_host(), b.actor_params_to_host())


# The pool's respawn drill, run in a child process (see test_pool_respawns_a_killed_worker).
POOL_RESPAWN_DRILL = """
import time
import numpy as np
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make, spec_of

cfg = DDPGConfig(device="cpu", actor_hidden=(16, 16), num_actors=1)
spec = spec_of(make("Pendulum-v1"))
pool = ActorPool(cfg, spec).start(np.zeros(sum(i * o + o for i, o in zip(
    [spec.obs_dim, 16, 16], [16, 16, spec.act_dim])), np.float32))
try:
    deadline = time.time() + 60
    while pool.steps_received == 0 and time.time() < deadline:
        pool.drain_batches()
        time.sleep(0.01)
    assert pool.steps_received > 0
    assert pool.monitor()["respawned"] == 0
    # Killed outright, the worker may die holding a cross-process lock:
    # neither the broadcast nor the respawned worker may wedge on it.
    pool._procs[0].kill()
    pool._procs[0].join(timeout=10)
    pool.broadcast(np.ones_like(np.frombuffer(pool._shared, np.float32)))
    # The respawn waits out the slot's backoff (respawn_backoff_s).
    stats = pool.monitor()
    while stats["total_respawns"] == 0 and time.time() < deadline:
        time.sleep(0.05)
        stats = pool.monitor()
    assert stats["total_respawns"] == 1
    before = pool.steps_received
    while pool.steps_received == before and time.time() < deadline:
        pool.drain_batches()
        time.sleep(0.01)
    assert pool.steps_received > before
finally:
    pool.stop()
assert not any(p.is_alive() for p in pool._procs)
"""


def test_pool_respawns_a_killed_worker():
    """A worker killed outright is respawned, and neither the broadcast nor
    the new worker wedges. In a child process with a timeout, so that the
    actor pool never starts in the test process (its workers exit when
    their parent does)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", POOL_RESPAWN_DRILL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]


def test_actor_params_to_host_drive_numpy_policy():
    jcfg, cfg = _configs()
    jstate = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    learner = ShardedLearner(cfg, OBS, ACT, 2.0, 0.5, chunk_size=K,
                             state=train_state_from_numpy(jax.tree.map(np.asarray, jstate)))
    policy = NumpyPolicy(param_layout(OBS, ACT, HIDDEN), 2.0, 0.5)
    policy.load_flat(learner.actor_params_to_host())
    obs = np.random.default_rng(1).standard_normal((B, OBS)).astype(np.float32)
    _close(policy(obs), jax_actor_apply(jstate.actor_params, obs, 2.0, 0.5), 1e-5, 1e-6)


def train_in_subprocess(flags, log_path, timeout=240):
    """`python -m distributed_ddpg_tpu_torch.train --device=cpu <flags>` in
    a child process with a timeout; returns its JSONL records."""
    cmd = [sys.executable, "-m", "distributed_ddpg_tpu_torch.train", "--device=cpu",
           *flags, f"--log_path={log_path}"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"   # tiny nets: one torch thread, as in the test process
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in log_path.read_text().splitlines()]


def test_tiny_train_run_writes_the_jax_trainers_records(tmp_path):
    records = train_in_subprocess([
        "--env_id=Pendulum-v1", "--num_actors=1", "--actor_hidden=16,16",
        "--critic_hidden=16,16", "--batch_size=16", "--learner_chunk=4",
        "--replay_min_size=100", "--total_env_steps=400", "--eval_every=300",
        "--eval_episodes=1",
    ], tmp_path / "metrics.jsonl")
    kinds = {r["kind"] for r in records}
    assert {"train", "eval", "final"} <= kinds
    train_rec = next(r for r in records if r["kind"] == "train")
    assert set(METRIC_KEYS) <= set(train_rec)
    assert {"env_steps_per_sec", "learner_steps_per_sec"} <= set(train_rec)
    assert "eval_return" in next(r for r in records if r["kind"] == "eval")
    final = records[-1]
    assert final["kind"] == "final"
    assert {"final_return", "env_steps_per_sec", "learner_steps_per_sec", *METRIC_KEYS} <= set(final)
    assert final["chunks"] >= 1
    assert final["learner_steps"] == final["chunks"] * 4
    assert final["step"] >= 400
    assert all(np.isfinite(final[k]) for k in (*METRIC_KEYS, "final_return"))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be exercised")
    from distributed_ddpg_tpu_torch.train import train

    with pytest.raises(RuntimeError, match="cuda"):
        train(DDPGConfig(total_env_steps=10))
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedLearner(DDPGConfig(), OBS, ACT, 2.0)
    assert resolve_learner_chunk(DDPGConfig()) == 800
    assert resolve_learner_chunk(DDPGConfig(device="cpu")) == 8


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter; neither jax
    nor the JAX package may load."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import distributed_ddpg_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'distributed_ddpg_tpu' or m.startswith('distributed_ddpg_tpu.'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_worker_modules_import_no_torch():
    """Actor workers import only actors/, envs/, ops.noise and
    replay.nstep, plus the main module they were spawned from (train.py
    under `python -m`): none of that loads torch (workers never touch
    CUDA, and boot without torch's import time)."""
    code = (
        "import sys\n"
        "import distributed_ddpg_tpu_torch.train\n"
        "import distributed_ddpg_tpu_torch.actors.worker\n"
        "import distributed_ddpg_tpu_torch.actors.pool\n"
        "import distributed_ddpg_tpu_torch.ops.noise, distributed_ddpg_tpu_torch.replay.nstep\n"
        "assert 'torch' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
