"""The port's single-process agent and native backend against the JAX
package's, on the CPU at a small size.

- DDPGAgent (agent.py) against the JAX package's DDPGAgent from one
  converted state, on the built-in Pendulum: 160 env steps (D4PG 120) of act,
  observe and train_step, the env stepped with the JAX agent's action and
  both agents observing the same transitions. Each step the port's
  exploring action within rtol 2e-4, atol 1e-5 of JAX's (the OU noise and
  the warmup's uniform actions are numpy from the same seeds: exact; the
  policy is f32 in both); the replays' rows and draws bit-identical and
  the PER priorities within td's rtol 1e-3, atol 1e-4
  (tests/test_native_backend.py); the end state within rtol 2e-4,
  atol 1e-5 and every metric within rtol 5e-4 (tests/fused_parity_util.py's
  D4PG and kernel tier: f32 in two frameworks, each step's sums in
  another order, over ~95 learner steps, D4PG's ~55). For DDPG, for D4PG (21
  atoms, the auto support, 3-step returns) with PER, and for DDPG with
  fused_update=True (K2's plain version here; the JAX kernel in
  interpret mode).
- TD3 (policy_delay 2, smoothing noise) and SAC agents against the JAX
  agent the same way, the JAX agent's draws (the step's noise or normals,
  SAC's exploring normal) passed into the port's, at the same tolerances,
  actor_opt.count and SAC's temperature included.
- make_sample_fn against the JAX Gaussian head with the same normals:
  rtol 1e-5, atol 1e-6.
- NativeLearner (native_backend.py) against the JAX package's on
  tests/test_native_backend.py's cases: bit-identical losses, td and
  params (the same numpy code), and against the port's eager step within
  that test's tolerances (rtol 2e-4 on the losses, rtol 1e-3 / atol 1e-4
  on td, rtol 1e-4 / atol 1e-5 on the params).
- The backend switch: `--backend=native` through the CLI in a child
  process, its refusals with the JAX package's messages, and
  backend='jax_ondevice' refused naming the option where it is outside the
  slice (on more than one rank).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.agent import DDPGAgent as JaxAgent
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.envs import make as jax_make
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.models.mlp import actor_gaussian_apply as jax_gaussian
from distributed_ddpg_tpu.native_backend import NativeLearner as JaxNative
from distributed_ddpg_tpu.ops import fused_chunk as jax_fc
from distributed_ddpg_tpu_torch import DDPGAgent
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import spec_of
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    init_train_state,
    make_learner_step,
    make_sample_fn,
    train_state_from_numpy,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.native_backend import NativeLearner
from distributed_ddpg_tpu_torch.types import Batch
from test_torch_slice import train_in_subprocess

torch.set_num_threads(1)

# tests/fused_parity_util.py's D4PG and kernel tier (tests/test_fused_chunk.py).
RTOL, ATOL, METRIC_RTOL = 2e-4, 1e-5, 5e-4
STEPS = 160
COMMON = dict(actor_hidden=(32, 32), critic_hidden=(32, 32), batch_size=16,
              replay_min_size=64, total_env_steps=STEPS, seed=1)
# D4PG runs 120 env steps: past ~50 learner steps its f32 drift starts to
# flip single rows of the C51 projection (a trial of 160 showed one step's
# critic_loss 1.6e-3 apart, the next step's 7.8e-5 again), as the long
# chunks drift on the card (PERF.md §7, long-chunk parity).
AGENTS = {
    "ddpg": dict(),
    "d4pg-per": dict(distributional=True, num_atoms=21, v_min=float("nan"),
                     v_max=float("nan"), n_step=3, prioritized=True, total_env_steps=120),
    "ddpg-fused-update": dict(fused_update=True),
}


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


def _assert_state(state, jstate, rtol=RTOL, atol=ATOL):
    ours = train_state_to_numpy(state)
    theirs = jax.tree.map(np.asarray, jstate)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for i, (a, b) in enumerate(zip(getattr(ours, group), getattr(theirs, group))):
            for k in ("w", "b"):
                _close(f"{group}[{i}].{k}", a[k], b[k], rtol, atol)
    for opt in ("actor_opt", "critic_opt"):
        assert int(getattr(ours, opt).count) == int(getattr(theirs, opt).count), opt
    assert int(ours.step) == int(theirs.step)


@pytest.mark.parametrize("case", list(AGENTS))
def test_agent_matches_jax_agent(case):
    over = dict(COMMON, **AGENTS[case])
    cfg, jcfg = DDPGConfig(device="cpu", **over), JaxConfig(**over)
    env = jax_make(jcfg.env_id, seed=0, prefer_builtin=True)
    spec = spec_of(env)
    jagent = JaxAgent(jcfg, spec)
    agent = DDPGAgent(cfg, spec)
    agent.state = train_state_from_numpy(jax.tree.map(np.asarray, jagent.state))
    obs, _ = env.reset(seed=0)
    trained = 0
    for t in range(cfg.total_env_steps):
        a_j = np.asarray(jagent.act(obs))
        a_p = agent.act(obs)
        _close(f"action at env step {t}", a_p, a_j)
        next_obs, reward, terminated, truncated, _ = env.step(a_j)
        for ag in (jagent, agent):
            ag.observe(obs, a_j, reward, terminated, next_obs)
        m_j, m_p = jagent.train_step(), agent.train_step()
        assert (m_j is None) == (m_p is None)
        if m_p is not None:
            trained += 1
            for k in m_j:
                _close(f"{k} at env step {t}", m_p[k], m_j[k], METRIC_RTOL)
        obs = next_obs
        if terminated or truncated:
            obs, _ = env.reset()
            jagent.reset_episode()
            agent.reset_episode()
    assert trained == cfg.total_env_steps - cfg.replay_min_size - (cfg.n_step - 1) + 1
    np.testing.assert_array_equal(agent.noise.state, jagent.noise.state)
    _assert_state(agent.state, jagent.state)
    ours, theirs = agent.replay.state_dict(), jagent.replay.state_dict()
    for k in ("obs", "action", "reward", "discount", "next_obs", "ptr", "size"):
        np.testing.assert_array_equal(ours[k], theirs[k], k)
    # The same draws: the generators made the same calls in the same order.
    assert agent.replay._rng.bit_generator.state == jagent.replay._rng.bit_generator.state
    if cfg.prioritized:
        # (|td| + eps)^alpha of the last td of each slot: td's tolerance.
        _close("priorities", ours["priorities"], theirs["priorities"], 1e-3, 1e-4)
        assert agent.replay.beta == jagent.replay.beta
    if cfg.distributional:
        assert agent.config.v_min == pytest.approx(jagent.config.v_min, rel=1e-12)
        assert agent.config.v_max == pytest.approx(jagent.config.v_max, rel=1e-12)
    ret = agent.evaluate(jax_make(jcfg.env_id, seed=5, prefer_builtin=True), episodes=1)
    assert np.isfinite(ret)


@pytest.mark.parametrize("over", [
    dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    dict(sac=True, actor_lr=3e-4, critic_lr=3e-4, tau=0.005),
])
def test_td3_and_sac_agents_train(over):
    """The TD3 (policy_delay 2, smoothing noise) and SAC agents against the
    JAX agent from one converted state, as test_agent_matches_jax_agent
    runs DDPG, with the JAX agent's own draws passed into the port's: TD3's
    smoothing noise and SAC's critic and actor normals of each learner
    step (the JAX ops/fused_chunk.td3_noise_eps / sac_noise_eps at K = 1,
    the learner step's exact stream) and SAC's exploring normal of each
    act (the JAX agent's split of its act key). Actions, metrics and the
    state (actor_opt.count under the delay, SAC's temperature and its Adam
    state) at that test's tolerances."""
    over = dict(COMMON, **over)
    cfg, jcfg = DDPGConfig(device="cpu", **over), JaxConfig(**over)
    env = jax_make(jcfg.env_id, seed=0, prefer_builtin=True)
    spec = spec_of(env)
    jagent = JaxAgent(jcfg, spec)
    agent = DDPGAgent(cfg, spec)
    agent.state = train_state_from_numpy(jax.tree.map(np.asarray, jagent.state))
    B, act = cfg.batch_size, spec.act_dim
    obs, _ = env.reset(seed=0)
    trained = 0
    for t in range(cfg.total_env_steps):
        normal = None
        if cfg.sac and jagent._env_steps >= jagent._warmup_uniform:
            # The JAX agent's act: split its key, sample normal(k, [1, act]).
            _, k = jax.random.split(jagent._act_key)
            normal = np.asarray(jax.random.normal(k, (1, act)))[0]
        a_j = np.asarray(jagent.act(obs))
        a_p = agent.act(obs, normal=normal)
        _close(f"action at env step {t}", a_p, a_j)
        next_obs, reward, terminated, truncated, _ = env.step(a_j)
        for ag in (jagent, agent):
            ag.observe(obs, a_j, reward, terminated, next_obs)
        eps = None
        if jagent.can_train():
            step = int(jagent.state.step)
            if cfg.sac:
                eps = tuple(np.asarray(e)[0] for e in jax_fc.sac_noise_eps(jcfg, step, 1, B, act))
            else:
                eps = np.asarray(jax_fc.td3_noise_eps(jcfg, step, 1, B, act))[0]
        m_j, m_p = jagent.train_step(), agent.train_step(eps=eps)
        assert (m_j is None) == (m_p is None)
        if m_p is not None:
            trained += 1
            for k in m_j:
                _close(f"{k} at env step {t}", m_p[k], m_j[k], METRIC_RTOL)
        obs = next_obs
        if terminated or truncated:
            obs, _ = env.reset()
            jagent.reset_episode()
            agent.reset_episode()
    assert trained == cfg.total_env_steps - cfg.replay_min_size + 1
    _assert_state(agent.state, jagent.state)
    ours, theirs = train_state_to_numpy(agent.state), jax.tree.map(np.asarray, jagent.state)
    if cfg.twin_critic:
        # The delay: the actor stepped on every second critic step.
        assert int(ours.actor_opt.count) == (trained + 1) // 2 == int(theirs.actor_opt.count)
    if cfg.sac:
        _close("log_alpha", ours.log_alpha, theirs.log_alpha)
        _close("alpha_opt.mu", ours.alpha_opt.mu, theirs.alpha_opt.mu)
        _close("alpha_opt.nu", ours.alpha_opt.nu, theirs.alpha_opt.nu)
        assert int(ours.alpha_opt.count) == int(theirs.alpha_opt.count) == trained


def test_make_sample_fn_matches_the_jax_gaussian_head():
    cfg = DDPGConfig(device="cpu", sac=True, actor_hidden=(16, 16))
    jcfg = JaxConfig(sac=True, actor_hidden=(16, 16))
    jstate = jax.tree.map(np.asarray, jax_init(jcfg, 3, 2, seed=0))
    state = train_state_from_numpy(jstate)
    obs = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    sample = make_sample_fn(cfg, 2.0, 0.5)
    got = sample(state.actor_params, torch.from_numpy(obs),
                 torch.Generator().manual_seed(11)).numpy()
    normal = torch.randn((5, 2), generator=torch.Generator().manual_seed(11)).numpy()
    mean, log_std = jax_gaussian(jstate.actor_params, jnp.asarray(obs), cfg.sac_log_std_min,
                                 cfg.sac_log_std_max)
    want = np.tanh(np.asarray(mean) + np.exp(np.asarray(log_std)) * normal) * 2.0 + 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.abs(got - 0.5) <= 2.0)


def test_agent_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be exercised")
    env = jax_make("Pendulum-v1", seed=0, prefer_builtin=True)
    with pytest.raises(RuntimeError, match="cuda"):
        DDPGAgent(DDPGConfig(), spec_of(env))


# --- the native backend ---------------------------------------------------------

OBS, ACT, B = 6, 3, 32


def _np_batch(rng, weighted=False):
    return {
        "obs": rng.standard_normal((B, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
        "reward": rng.standard_normal(B).astype(np.float32),
        "discount": np.full(B, 0.99, np.float32),
        "next_obs": rng.standard_normal((B, OBS)).astype(np.float32),
        "weight": (rng.uniform(0.2, 1.0, B).astype(np.float32) if weighted
                   else np.ones(B, np.float32)),
    }


@pytest.mark.parametrize("l2,weighted,offset", [(0.0, False, 0.0), (0.01, True, 0.5)])
def test_native_learner_matches_jax_and_the_eager_step(l2, weighted, offset):
    over = dict(actor_hidden=(32, 32), critic_hidden=(32, 32), batch_size=B, critic_l2=l2,
                tau=5e-3)
    cfg, jcfg = DDPGConfig(device="cpu", **over), JaxConfig(**over)
    jstate = jax.tree.map(np.asarray, jax_init(jcfg, OBS, ACT, seed=0))
    ours = NativeLearner(cfg, jstate, action_scale=1.5, action_offset=offset)
    theirs = JaxNative(jcfg, jstate, action_scale=1.5, action_offset=offset)
    state = train_state_from_numpy(jstate)
    step = make_learner_step(cfg, 1.5, offset)
    rng = np.random.default_rng(0)
    for i in range(10):
        nb = _np_batch(rng, weighted)
        m, jm = ours.step(nb), theirs.step(nb)
        assert m.keys() == jm.keys()
        for k in m:
            np.testing.assert_array_equal(m[k], jm[k], f"{k} at step {i}")
        out = step(state, Batch(*(torch.from_numpy(nb[f]) for f in Batch._fields)))
        state = out.state
        np.testing.assert_allclose(m["critic_loss"], float(out.metrics["critic_loss"]),
                                   rtol=2e-4, err_msg=f"critic loss at step {i}")
        np.testing.assert_allclose(m["actor_loss"], float(out.metrics["actor_loss"]),
                                   rtol=2e-4, atol=1e-5, err_msg=f"actor loss at step {i}")
        np.testing.assert_allclose(m["td_errors"], out.td_errors.numpy(), rtol=1e-3, atol=1e-4)
    for mine, other in zip((ours.actor, ours.critic, ours.target_actor, ours.target_critic),
                           (theirs.actor, theirs.critic, theirs.target_actor,
                            theirs.target_critic)):
        for a, b in zip(mine, other):
            for k in ("w", "b"):
                np.testing.assert_array_equal(a[k], b[k])
    assert ours.params_close_to(train_state_to_numpy(state), rtol=1e-4, atol=1e-5)
    assert ours.step_count == int(state.step) == 10


def test_native_act_matches_jax():
    cfg, jcfg = (DDPGConfig(device="cpu", actor_hidden=(32, 32), critic_hidden=(32, 32)),
                 JaxConfig(actor_hidden=(32, 32), critic_hidden=(32, 32)))
    jstate = jax.tree.map(np.asarray, jax_init(jcfg, OBS, ACT, seed=1))
    obs = np.random.default_rng(2).standard_normal((5, OBS)).astype(np.float32)
    np.testing.assert_array_equal(NativeLearner(cfg, jstate, action_scale=2.0).act(obs),
                                  JaxNative(jcfg, jstate, action_scale=2.0).act(obs))


def test_native_learner_takes_the_ports_own_state():
    cfg = DDPGConfig(device="cpu", actor_hidden=(8,), critic_hidden=(8, 8))
    state = init_train_state(cfg, OBS, ACT, 0, "cpu")
    native = NativeLearner(cfg, train_state_to_numpy(state), action_scale=1.0)
    assert native.params_close_to(train_state_to_numpy(state), rtol=0.0, atol=0.0)
    with pytest.raises(NotImplementedError):
        NativeLearner(cfg.replace(distributional=True), train_state_to_numpy(state), 1.0)


@pytest.mark.parametrize("over, match", [
    (dict(backend="native", compute_dtype="bfloat16"), "f32 bit-comparability oracle"),
    (dict(backend="native", sac=True), "sac requires a JAX backend"),
    (dict(backend="native", twin_critic=True), "twin_critic requires a JAX backend"),
    (dict(backend="tpu"), "backend must be"),
])
def test_backend_refusals_match_jax(over, match):
    with pytest.raises(ValueError, match=match) as ours:
        DDPGConfig(**over)
    with pytest.raises(ValueError, match=match) as theirs:
        JaxConfig(**over)
    assert str(ours.value) == str(theirs.value)


def test_jax_ondevice_is_refused_naming_the_option():
    # The monolith (ondevice.py) runs on one rank; more are refused by name.
    assert DDPGConfig(backend="jax_ondevice").backend == "jax_ondevice"
    with pytest.raises(ValueError, match="backend='jax_ondevice' with data_axis=2 is not in"):
        DDPGConfig(backend="jax_ondevice", data_axis=2)


def test_native_backend_cli_run(tmp_path):
    records = train_in_subprocess([
        "--backend=native", "--actor_hidden=16,16", "--critic_hidden=16,16",
        "--batch_size=16", "--replay_min_size=200", "--total_env_steps=600",
        "--eval_every=300", "--eval_episodes=1", "--train_every=2"], tmp_path / "m.jsonl")
    kinds = [r["kind"] for r in records]
    # The stream opens with the logger's header record (t_unix_base).
    assert kinds == ["header", "train", "eval", "train", "eval", "final"]
    train = [r for r in records if r["kind"] == "train"]
    assert train[-1]["learner_steps"] == (600 - 200) // 2 + 1
    assert all(np.isfinite(train[-1][k]) for k in ("critic_loss", "actor_loss", "mean_q"))
    assert np.isfinite(records[-1]["final_return"])
