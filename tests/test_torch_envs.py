"""The port's environments (distributed_ddpg_tpu_torch/envs/) against the
JAX package's, on the CPU.

- The built-in MountainCarContinuous: obs, rewards and the terminated and
  truncated flags bit-identical to the JAX package's for the same seed and
  numpy action sequence, on random actions, on a bang-bang run that
  reaches the goal (+100, terminated) and on a run of zero force truncated
  at 999 steps; its terminal step leaves the n-step accumulator (as the
  worker feeds it) with discount 0, as the JAX accumulator's does.
- `make` resolves each id to the same kind of env as the JAX `make`, with
  and without prefer_builtin, with gymnasium present and (monkeypatched)
  absent: Pendulum-v1, builtin/Pendulum-v1, MountainCarContinuous-v0 and
  its builtin/ id, LunarLanderContinuous-v2 (-> v3 where gymnasium has
  retired v2, monkeypatched), HalfCheetah-v4 and an unknown id, which
  raises; spec_of is equal. The gymnasium cases skip
  where gymnasium does not import.
- The gymnasium adapter: its first reset (seeded by the constructor), a
  step and a later unseeded reset give the JAX adapter's observations.
- Rows with discount 0 (terminal rows) at MountainCar's shapes (obs 2,
  act 1, rows of 8 columns): the port's chunk on the kernel route (its
  plain version) and on the scan route against the JAX kernel in
  interpret mode (rtol 2e-5, atol 1e-6, metrics 5e-5, as
  tests/test_torch_fused_chunk.py).
- Tiny `--device=cpu` trains (16-wide, batch 16, 600 env steps, one
  actor) on MountainCarContinuous-v0 and, where mujoco imports, on
  HalfCheetah-v4, in child processes: each finishes, and its checkpoint's
  state has the env's obs and act widths.
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

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs import registry as jax_registry
from distributed_ddpg_tpu.envs.mountain_car import MountainCarContinuous as JaxMountainCar
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.replay.nstep import NStepAccumulator as JaxNStep
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import registry
from distributed_ddpg_tpu_torch.envs.mountain_car import MountainCarContinuous
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.parallel.learner import make_scan_chunk_fn
from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator
from distributed_ddpg_tpu_torch.types import pack_batch_np

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5          # tests/test_torch_fused_chunk.py


# --- the built-in MountainCarContinuous ------------------------------------


def _actions(kind, n, rng):
    if kind == "random":
        return rng.uniform(-1.5, 1.5, (n, 1)).astype(np.float32)   # clipped inside
    return np.zeros((n, 1), np.float32)


def _rollout(env, kind, seed, n):
    """(obs, reward, terminated, truncated) of every step from reset(seed);
    'goal' pushes along the velocity (bang-bang), which reaches the goal."""
    rng = np.random.default_rng(seed)
    fixed = _actions(kind, n, rng)
    obs, _ = env.reset(seed=seed)
    out = [(obs, 0.0, False, False)]
    for t in range(n):
        a = (np.array([1.0 if obs[1] >= 0 else -1.0], np.float32) if kind == "goal"
             else fixed[t])
        obs, r, term, trunc, _ = env.step(a)
        out.append((obs, r, term, trunc))
        if term or trunc:
            break
    return out


@pytest.mark.parametrize("kind", ["random", "goal", "truncated"])
def test_mountain_car_is_bit_identical_to_jax(kind):
    n = 1200
    for seed in (0, 5):
        got = _rollout(MountainCarContinuous(seed=seed), kind, seed, n)
        want = _rollout(JaxMountainCar(seed=seed), kind, seed, n)
        assert len(got) == len(want)
        for (o, r, te, tr), (wo, wr, wte, wtr) in zip(got, want):
            assert o.dtype == wo.dtype == np.float32
            assert np.array_equal(o, wo) and r == wr and te == wte and tr == wtr
        last = got[-1]
        if kind == "goal":
            assert last[2] and not last[3] and last[1] > 99.0, last
        elif kind == "truncated":
            assert last[3] and not last[2] and len(got) - 1 == 999


def test_mountain_car_terminal_step_reaches_the_rows_as_discount_0():
    """The worker's n-step feed (actors/worker.py) over a run that reaches
    the goal: the terminal transition and the windows it flushes carry
    discount 0, as the JAX accumulator's do."""
    for n_step in (1, 5):
        acc, jacc = NStepAccumulator(n_step, 0.99), JaxNStep(n_step, 0.99)
        env = MountainCarContinuous(seed=3)
        obs, _ = env.reset(seed=3)
        rows, jrows = [], []
        while True:
            a = np.array([1.0 if obs[1] >= 0 else -1.0], np.float32)
            nxt, r, term, trunc, _ = env.step(a)
            rows += list(acc.push(obs[None], a[None], [r], [term], nxt[None]))
            jrows += list(jacc.push(obs[None], a[None], [r], [term], nxt[None]))
            obs = nxt
            if term or trunc:
                break
        assert term
        assert len(rows) == len(jrows)
        for x, y in zip(rows, jrows):
            for u, v in zip(x, y):
                assert np.array_equal(u, v)
        tail = rows[-min(n_step, len(rows)):]
        assert all(d == 0.0 for _, _, _, d, _ in tail)
        assert all(d > 0.9 ** n_step for _, _, _, d, _ in rows[:-n_step])


# --- make and spec_of -------------------------------------------------------

IDS = ["Pendulum-v1", "builtin/Pendulum-v1", "MountainCarContinuous-v0",
       "builtin/MountainCarContinuous-v0", "LunarLanderContinuous-v2", "HalfCheetah-v4"]


def _kind(env):
    """The env's kind: the built-in's class name, or the gymnasium id behind
    the adapter."""
    inner = getattr(env, "_env", None)
    return type(env).__name__ if inner is None else f"gymnasium:{inner.spec.id}"


def _spec_equal(a, b):
    assert (a.obs_dim, a.act_dim) == (b.obs_dim, b.act_dim)
    assert np.array_equal(a.action_low, b.action_low)
    assert np.array_equal(a.action_high, b.action_high)


def _resolve_both(env_id, prefer_builtin):
    """(port env or exception type, JAX env or exception type)."""
    out = []
    for make in (registry.make, jax_registry.make):
        try:
            out.append(make(env_id, seed=0, prefer_builtin=prefer_builtin))
        except Exception as e:   # the same refusal on both sides
            out.append(type(e))
    return out


@pytest.mark.parametrize("prefer_builtin", [False, True])
@pytest.mark.parametrize("env_id", IDS + ["NoSuchEnv-v0"])
def test_make_resolves_as_jax_does(env_id, prefer_builtin):
    if not (prefer_builtin and env_id in registry._BUILTIN):
        pytest.importorskip("gymnasium")
    if env_id == "HalfCheetah-v4":
        pytest.importorskip("mujoco")
    if env_id.startswith("LunarLander"):
        pytest.importorskip("Box2D")
    port, ref = _resolve_both(env_id, prefer_builtin)
    if env_id == "NoSuchEnv-v0":
        assert isinstance(port, type) and isinstance(ref, type) and port is ref
        return
    assert _kind(port) == _kind(ref)
    if prefer_builtin and env_id in registry._BUILTIN:
        assert type(port).__name__ in ("Pendulum", "MountainCarContinuous")
    _spec_equal(registry.spec_of(port), jax_registry.spec_of(ref))
    for env in (port, ref):
        env.close()


def test_retired_version_takes_its_alias_as_jax_does(monkeypatch):
    """A gymnasium that has retired LunarLanderContinuous-v2 (DeprecatedEnv)
    refuses it: both registries bump it to -v3 (_VERSION_ALIASES)."""
    gymnasium = pytest.importorskip("gymnasium")
    pytest.importorskip("Box2D")
    real = gymnasium.make

    def make(env_id, *args, **kwargs):
        if env_id == "LunarLanderContinuous-v2":
            raise gymnasium.error.DeprecatedEnv(f"{env_id} is retired")
        return real(env_id, *args, **kwargs)

    monkeypatch.setattr(gymnasium, "make", make)
    port, ref = _resolve_both("LunarLanderContinuous-v2", False)
    assert _kind(port) == _kind(ref) == "gymnasium:LunarLanderContinuous-v3"
    _spec_equal(registry.spec_of(port), jax_registry.spec_of(ref))


@pytest.mark.parametrize("env_id", IDS[:4] + ["HalfCheetah-v4"])
def test_make_without_gymnasium_resolves_as_jax_does(env_id, monkeypatch):
    """Where gymnasium does not import (the card's machine): the built-ins
    by either id, and any other id raises the same ValueError."""
    monkeypatch.setattr(registry, "_has_gymnasium", lambda: False)
    monkeypatch.setattr(jax_registry, "_has_gymnasium", lambda: False)
    port, ref = _resolve_both(env_id, False)
    if env_id in registry._BUILTIN:
        assert type(port).__name__ == type(ref).__name__
        _spec_equal(registry.spec_of(port), jax_registry.spec_of(ref))
    else:
        assert port is ref is ValueError


@pytest.mark.parametrize("env_id", ["Pendulum-v1", "MountainCarContinuous-v0"])
def test_gymnasium_adapter_resets_as_jax_does(env_id):
    pytest.importorskip("gymnasium")
    port = registry._GymnasiumAdapter(env_id, seed=11)
    ref = jax_registry._GymnasiumAdapter(env_id, seed=11)
    a = np.full(port.action_dim, 0.3, np.float32)
    for _ in range(2):   # the seeded first reset, then an unseeded one
        po, _ = port.reset()
        ro, _ = ref.reset()
        assert np.array_equal(po, ro)
        ps, rs = port.step(a), ref.step(a)
        assert np.array_equal(ps[0], rs[0]) and ps[1:4] == rs[1:4]
    po, _ = port.reset(seed=2)
    ro, _ = ref.reset(seed=2)
    assert np.array_equal(po, ro)


# --- terminal rows through the learner chunk --------------------------------

OBS, ACT, B, K = 2, 1, 8, 4


def _terminal_batches(seed):
    rng = np.random.default_rng(seed)
    discount = np.full((K, B), 0.99, np.float32)
    discount[rng.random((K, B)) < 0.25] = 0.0
    discount[0, 0] = 0.0
    return pack_batch_np({
        "obs": rng.uniform(-1.2, 0.6, (K, B, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, (K, B, ACT)).astype(np.float32),
        "reward": np.where(discount == 0.0, 100.0, -0.1).astype(np.float32),
        "discount": discount,
        "next_obs": rng.uniform(-1.2, 0.6, (K, B, OBS)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, (K, B)).astype(np.float32),
    })


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_terminal_rows_chunk_matches_jax_kernel(route):
    common = dict(actor_hidden=(32, 32), critic_hidden=(32, 32), batch_size=B, seed=3)
    jcfg, cfg = JaxConfig(**common), DDPGConfig(device="cpu", **common)
    jstate = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    packed = _terminal_batches(9)
    assert (packed[..., OBS + ACT + 1] == 0.0).mean() >= 0.1
    run_jax = jax_fused_chunk.make_fused_chunk_fn(jcfg, OBS, ACT, 1.0, 0.0, chunk_size=K,
                                                  interpret=True)
    jnew, jtd, jmet = jax.jit(run_jax)(jstate, jnp.asarray(packed))
    jnew = jax.tree.map(np.asarray, jnew)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    if route == "kernel":
        run = fc.make_fused_chunk_fn(cfg, OBS, ACT, 1.0, 0.0, chunk_size=K, device="cpu")
        new, td, met = run(state, torch.from_numpy(packed))
    else:
        run = make_scan_chunk_fn(cfg, OBS, ACT, 1.0, 0.0, chunk_size=K)
        new, td, met = run(state, torch.from_numpy(packed), None, step0=0)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for lp, lr in zip(getattr(new, group), getattr(jnew, group)):
            for key in ("w", "b"):
                np.testing.assert_allclose(lp[key].numpy(), lr[key], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=RTOL, atol=ATOL)
    for name in METRIC_KEYS:
        np.testing.assert_allclose(float(met[name]), float(jmet[name]), rtol=METRIC_RTOL,
                                   atol=ATOL)


# --- tiny trains through the CLI ------------------------------------------------


def _train_widths(env_id, tmp_path):
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "distributed_ddpg_tpu_torch.train", "--device=cpu",
           f"--env_id={env_id}", "--num_actors=1", "--actor_hidden=16,16",
           "--critic_hidden=16,16", "--batch_size=16", "--learner_chunk=4",
           "--replay_min_size=200", "--total_env_steps=600", "--eval_every=0",
           "--eval_episodes=1", f"--checkpoint_dir={ck}", "--checkpoint_every=4",
           f"--log_path={tmp_path / 'log.jsonl'}"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    final = [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()][-1]
    assert final["kind"] == "final" and final["learner_steps"] > 0
    assert np.isfinite(final["critic_loss"])
    step = max(int(p.name.split("_")[1]) for p in ck.iterdir() if p.name.startswith("step_"))
    with np.load(ck / f"step_{step}" / "state.npz") as z:
        return z["actor_params/0/w"].shape[0], z["actor_params/2/w"].shape[1]


def test_tiny_train_on_mountain_car(tmp_path):
    assert _train_widths("MountainCarContinuous-v0", tmp_path) == (2, 1)


def test_tiny_train_on_half_cheetah(tmp_path):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    assert _train_widths("HalfCheetah-v4", tmp_path) == (17, 6)
