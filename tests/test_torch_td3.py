"""The port's TD3 path against the JAX package's, on the CPU at a small size
(obs 3, act 2, actor 32x32, critic 32x24x16, batch 8).

- config: the TD3 fields' defaults and the JAX package's gates;
- the twin critic ensemble: init shapes and the numpy weight bridge;
- the eager TD3 step and the plain TD3 chunk (fused_chunk_reference)
  against K calls of the JAX make_learner_step, from one JAX-made
  TrainState whose step is odd, with the JAX smoothing noise
  (fused_chunk.td3_noise_eps, the scan path's own stream) passed in, for
  (policy_delay, target_noise) in {(1, 0.0), (2, 0.2)};
- the kernel's task program for TD3, run by the numpy interpreter of
  tests/test_torch_fused_chunk.py (the new epilogues and the skipped
  actor-backward tiles), against the plain chunk, and its stage order;
- the delay schedule carried across two chunks of odd K;
- ShardedLearner's TD3 chunk and a tiny TD3 training run (in a
  subprocess);
- the plain chunk against the JAX kernel in interpret mode.

The kernel against the plain chunk on a card (marker `cuda`) is in
tests/test_torch_on_card.py, one case per branch.

Tolerances: rtol 2e-5, atol 1e-6, as in test_torch_core.py; the chunk-mean
metrics 5e-5 (their sums run in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import types as jax_types
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.learner import make_learner_step as jax_step
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu_torch import types
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    init_train_state,
    make_learner_step,
    train_state_from_numpy,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.models import mlp
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
from test_torch_fused_chunk import _assert_stage_dependencies, _interpret_program
from test_torch_slice import train_in_subprocess

OBS, ACT, B, K = 3, 2, 8, 5
ACTOR, CRITIC = (32, 32), (32, 24, 16)
STEP0, COUNT_A, COUNT_C = 5, 2, 5     # an odd start: the schedule is offset
SCALE, OFFSET = 2.0, 0.5
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5
TD3_CASES = [(1, 0.0), (2, 0.2)]


def _configs(delay=2, noise=0.2, device="cpu"):
    common = dict(actor_hidden=ACTOR, critic_hidden=CRITIC, batch_size=B, seed=3,
                  twin_critic=True, policy_delay=delay, target_noise=noise)
    return JaxConfig(**common), DDPGConfig(device=device, **common)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(jcfg, step0=STEP0):
    s = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    return s._replace(
        step=jnp.int32(step0),
        actor_opt=s.actor_opt._replace(count=jnp.int32(COUNT_A)),
        critic_opt=s.critic_opt._replace(count=jnp.int32(COUNT_C)),
    )


def _batches(seed, k=K):
    rng = np.random.default_rng(seed)
    return types.pack_batch_np({
        "obs": rng.standard_normal((k, B, OBS)).astype(np.float32),
        "action": rng.uniform(-1.5, 2.5, (k, B, ACT)).astype(np.float32),
        "reward": rng.standard_normal((k, B)).astype(np.float32),
        "discount": np.full((k, B), 0.99, np.float32),
        "next_obs": rng.standard_normal((k, B, OBS)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, (k, B)).astype(np.float32),
    })


def _jax_eps(jcfg, step0, k):
    """The JAX package's smoothing noise for steps step0 .. step0+k-1 (the
    scan path's fold_in stream), or None without smoothing."""
    if jcfg.target_noise == 0.0:
        return None
    return np.array(jax_fused_chunk.td3_noise_eps(jcfg, jnp.int32(step0), k, B, ACT))


@functools.lru_cache(maxsize=None)
def _jax_step_fn(jcfg):
    return jax.jit(jax_step(jcfg, SCALE, action_offset=OFFSET))


def _jax_steps(jcfg, jstate, packed):
    """K calls of the JAX make_learner_step (jitted once per config): (end
    state, td[K, B], metrics per step)."""
    step = _jax_step_fn(jcfg)
    tds, mets = [], []
    for k in range(packed.shape[0]):
        out = step(jstate, jax_types.unpack_batch(jnp.asarray(packed[k]), OBS, ACT))
        jstate = out.state
        tds.append(np.asarray(out.td_errors))
        mets.append({n: float(out.metrics[n]) for n in METRIC_KEYS})
    return _np(jstate), np.stack(tds), mets


def _assert_state_matches(state, ref):
    """Every group of the port's state against the JAX numpy state, and
    the counts exactly."""
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        for lp, lr in zip(getattr(state, group), getattr(ref, group)):
            for key in ("w", "b"):
                assert tuple(lp[key].shape) == lr[key].shape
                _close(lp[key].detach().numpy(), lr[key])
    for opt in ("actor_opt", "critic_opt"):
        for tree in ("mu", "nu"):
            for lp, lr in zip(getattr(getattr(state, opt), tree),
                              getattr(getattr(ref, opt), tree)):
                for key in ("w", "b"):
                    _close(lp[key].detach().numpy(), lr[key])
        assert int(getattr(state, opt).count) == int(getattr(ref, opt).count)
    assert int(state.step) == int(ref.step)


# --- config -----------------------------------------------------------------


def test_td3_config_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(DDPGConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for name in ("twin_critic", "policy_delay", "target_noise", "target_noise_clip"):
        assert ours[name] == theirs[name]
    cfg = DDPGConfig.from_flags(["--twin_critic=true", "--policy_delay=2",
                                 "--target_noise=0.2", "--device=cpu"])
    assert (cfg.twin_critic, cfg.policy_delay, cfg.target_noise) == (True, 2, 0.2)
    assert fc.supported(cfg)


@pytest.mark.parametrize("override", [
    dict(policy_delay=0), dict(target_noise=-0.1), dict(target_noise_clip=-0.1),
    dict(policy_delay=2), dict(target_noise=0.2),
    dict(twin_critic=True, distributional=True),
    dict(twin_critic=True, fused_update=True),
    dict(twin_critic=True, sac=True),
])
def test_td3_gates_match_jax(override):
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**override)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(**override)
    assert str(ours.value) == str(theirs.value)


# --- the ensemble and the weight bridge ----------------------------------------


def test_twin_init_shapes_match_jax():
    jcfg, cfg = _configs()
    ref = _np(jax_init(jcfg, OBS, ACT, seed=0))
    state = init_train_state(cfg, OBS, ACT, seed=0)
    for group in ("actor_params", "critic_params", "target_critic_params"):
        assert [tuple(l[k].shape) for l in getattr(state, group) for k in ("w", "b")] == [
            l[k].shape for l in getattr(ref, group) for k in ("w", "b")]
    for tree in ("mu", "nu"):
        assert [tuple(l["w"].shape) for l in getattr(state.critic_opt, tree)] == [
            l["w"].shape for l in getattr(ref.critic_opt, tree)]
    first = state.critic_params[0]["w"]
    assert first.shape[0] == 2 and not torch.equal(first[0], first[1])  # independent
    for t, p in zip(state.target_critic_params, state.critic_params):
        assert torch.equal(t["w"], p["w"]) and torch.equal(t["b"], p["b"])
    assert float(state.critic_params[-1]["w"].abs().max()) <= mlp.FINAL_INIT_SCALE
    assert int(state.critic_opt.count) == int(state.actor_opt.count) == 0


def test_twin_state_round_trip():
    jcfg, _ = _configs()
    ref = _np(_jax_state(jcfg))
    state = train_state_from_numpy(ref)
    assert tuple(state.critic_params[1]["w"].shape) == ref.critic_params[1]["w"].shape
    back = train_state_to_numpy(state)
    leaves, ref_leaves = jax.tree.leaves(back), jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)
    # The kernel's flat layout (member 0's layers, then member 1's) and
    # its strided [2, ...] views give the same state back.
    flat = fc.flatten_state(state)
    again = fc.unflatten_state(flat, state, 0, 0)
    for a, b in zip(jax.tree.leaves(train_state_to_numpy(again)), ref_leaves):
        np.testing.assert_array_equal(a, b)
    n_c = sum(v.size // 2 for layer in ref.critic_params for v in layer.values())
    n_a = sum(v.size for layer in ref.actor_params for v in layer.values())
    member1 = flat[n_a + n_c:n_a + 2 * n_c]
    np.testing.assert_array_equal(member1[:ref.critic_params[0]["w"][1].size].numpy(),
                                  ref.critic_params[0]["w"][1].reshape(-1))


def test_td3_losses_match_jax():
    from distributed_ddpg_tpu.ops import losses as jax_losses
    from distributed_ddpg_tpu_torch.ops import losses

    jcfg, _ = _configs()
    jstate = _jax_state(jcfg)
    state = train_state_from_numpy(_np(jstate))
    packed = _batches(1, k=1)[0]
    jbatch = jax_types.unpack_batch(jnp.asarray(packed), OBS, ACT)
    batch = types.unpack_batch(torch.from_numpy(packed), OBS, ACT)
    key = jax.random.PRNGKey(9)
    jloss, jtd = jax_losses.td3_critic_loss(
        jstate.critic_params, jstate.target_actor_params, jstate.target_critic_params,
        jbatch, SCALE, key, 0.2, 0.5, action_offset=OFFSET)
    eps = np.clip(0.2 * np.asarray(jax.random.normal(key, (B, ACT))), -0.5, 0.5)
    loss, td = losses.td3_critic_loss(
        state.critic_params, state.target_actor_params, state.target_critic_params,
        batch, torch.tensor(SCALE), torch.from_numpy(eps), torch.tensor(OFFSET))
    _close(float(loss), float(jloss))
    _close(td.numpy(), np.asarray(jtd))
    _close(float(losses.td3_actor_loss(state.actor_params, state.critic_params, batch,
                                       torch.tensor(SCALE), torch.tensor(OFFSET))),
           float(jax_losses.td3_actor_loss(jstate.actor_params, jstate.critic_params,
                                           jbatch, SCALE, action_offset=OFFSET)))


# --- the eager step and the plain chunk against the JAX scan ------------------


@pytest.mark.parametrize("delay,noise", TD3_CASES)
def test_eager_td3_steps_match_jax(delay, noise):
    jcfg, cfg = _configs(delay, noise)
    jstate = _jax_state(jcfg)
    packed = _batches(4)
    eps = _jax_eps(jcfg, STEP0, K)
    ref, rtds, rmets = _jax_steps(jcfg, jstate, packed)
    step = make_learner_step(cfg, SCALE, OFFSET)
    state = train_state_from_numpy(_np(jstate))
    for k in range(K):
        out = step(state, types.unpack_batch(torch.from_numpy(packed[k]), OBS, ACT),
                   None if eps is None else torch.from_numpy(eps[k]))
        state = out.state
        _close(out.td_errors.numpy(), rtds[k])
        for name in METRIC_KEYS:
            _close(float(out.metrics[name]), rmets[k][name], METRIC_RTOL, ATOL)
        if delay > 1 and (STEP0 + k) % delay:
            assert float(out.metrics["actor_grad_norm"]) == 0.0
    _assert_state_matches(state, ref)
    assert int(state.actor_opt.count) == COUNT_A + fc.actor_updates(cfg, STEP0, K)


@pytest.mark.parametrize("delay,noise", TD3_CASES)
def test_plain_td3_chunk_matches_jax_steps(delay, noise):
    jcfg, cfg = _configs(delay, noise)
    jstate = _jax_state(jcfg)
    packed = _batches(5)
    eps = _jax_eps(jcfg, STEP0, K)
    ref, rtds, rmets = _jax_steps(jcfg, jstate, packed)
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, device="cpu")
    new, td, met = run(train_state_from_numpy(_np(jstate)), torch.from_numpy(packed),
                       None if eps is None else torch.from_numpy(eps))
    _assert_state_matches(new, ref)
    _close(td.numpy(), rtds)
    for name in METRIC_KEYS:
        _close(float(met[name]), np.mean([m[name] for m in rmets]), METRIC_RTOL, ATOL)


def test_td3_chunks_carry_the_schedule_across_the_boundary():
    """Two chunks of odd K from an odd step: the second starts on the
    other phase of the delay and must pick up the actor count and the
    schedule where the first left them."""
    k = 3
    jcfg, cfg = _configs(2, 0.2)
    jstate = _jax_state(jcfg)
    packed = _batches(6, k=2 * k)
    eps = _jax_eps(jcfg, STEP0, 2 * k)
    ref, rtds, _ = _jax_steps(jcfg, jstate, packed)
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=k, device="cpu")
    state = train_state_from_numpy(_np(jstate))
    tds = []
    for c in range(2):
        sl = slice(c * k, (c + 1) * k)
        state, td, _ = run(state, torch.from_numpy(packed[sl]), torch.from_numpy(eps[sl]))
        tds.append(td.numpy())
    # 5, 6, 7 | 8, 9, 10: updates at 6 | 8, 10.
    assert fc.actor_updates(cfg, STEP0, k) == 1
    assert fc.actor_updates(cfg, STEP0 + k, k) == 2
    _assert_state_matches(state, ref)
    _close(np.concatenate(tds), rtds)


# --- the kernel's program -----------------------------------------------------


@pytest.mark.parametrize("delay,noise", TD3_CASES)
def test_td3_program_matches_plain_chunk(delay, noise):
    jcfg, cfg = _configs(delay, noise)
    state = train_state_from_numpy(_np(_jax_state(jcfg)))
    packed = _batches(11)
    eps = _jax_eps(jcfg, STEP0, K)
    flat, td, met = _interpret_program(cfg, state, packed, SCALE, OFFSET, eps, OBS, ACT)
    new, rtd, rmet = fc.fused_chunk_reference(
        cfg, state, torch.from_numpy(packed), SCALE, OFFSET,
        None if eps is None else torch.from_numpy(eps))
    _close(flat, fc.flatten_state(new).numpy())
    _close(td, rtd.numpy())
    _close(met, torch.stack([rmet[k] for k in METRIC_KEYS]).numpy(), METRIC_RTOL, ATOL)


def test_td3_program_stages_and_skipped_tiles():
    """The twin program keeps DDPG's stage count; on update steps and on
    the steps that skip the actor's backward, every read comes from an
    earlier stage; the skipped tiles are exactly the actor's backward."""
    _, cfg = _configs(2, 0.2)
    prog = fc._plan(cfg, OBS, ACT)
    ddpg = fc._plan(DDPGConfig(device="cpu", actor_hidden=ACTOR, critic_hidden=CRITIC,
                               batch_size=B), OBS, ACT)
    assert len(prog.stage_tiles) == len(ddpg.stage_tiles)
    _assert_stage_dependencies(prog, B, update=True)
    _assert_stage_dependencies(prog, B, update=False)
    assert prog.n_critic == 2 * ddpg.n_critic and prog.n_actor == ddpg.n_actor
    assert ddpg.stage_tiles_skip == ddpg.stage_tiles     # DDPG skips nothing
    skipped = sum(prog.stage_tiles) - sum(prog.stage_tiles_skip)
    actor_bwd_tiles = sum(
        int(r[fc.F_TILES_M] * r[fc.F_TILES_N])
        for s in range(len(prog.stage_tiles))
        for r in prog.tasks[prog.stage_start[s]:prog.stage_start[s + 1]]
        if r[fc.F_TILE0] >= prog.stage_tiles_skip[s])
    assert skipped == actor_bwd_tiles > 0
    assert sum(1 for r in prog.tasks if r[fc.F_EPI] == fc.EPI_TD3) == 1
    assert sum(1 for r in prog.tasks if r[fc.F_EPI] == fc.EPI_TANH_NOISE) == 1


def test_td3_operation_count():
    """The twin program's products are DDPG's plus one more critic forward
    on each path and one more critic backward; the actor's backward is
    the same and counts only on update steps."""
    _, cfg = _configs(2, 0.2)
    dcfg = DDPGConfig(device="cpu", actor_hidden=ACTOR, critic_hidden=CRITIC, batch_size=B)
    prog, ddpg = fc._plan(cfg, OBS, ACT), fc._plan(dcfg, OBS, ACT)
    _, cdims = fc._net_dims(cfg, OBS, ACT)
    fwd = sum(2 * B * i * o for i, o in cdims)
    bwd = sum(2 * B * i * o + 2 * B * o for i, o in cdims)      # weight and bias grads
    bwd += 2 * B * CRITIC[0] * cdims[1][1]                      # dx of layer 1's features
    bwd += sum(2 * B * i * o for i, o in cdims[2:])             # dx of the later layers
    assert prog.matmul_flops - ddpg.matmul_flops == 2 * fwd + bwd
    assert prog.actor_bwd_flops == ddpg.actor_bwd_flops
    per_update = (prog.actor_bwd_flops + fc.ADAM_OPS_PER_PARAM * prog.n_actor
                  + fc.POLYAK_OPS_PER_PARAM * (prog.n_actor + prog.n_critic))
    every = prog.matmul_flops + fc.ADAM_OPS_PER_PARAM * prog.n_critic
    assert fc.ops_per_chunk(cfg, OBS, ACT, K, STEP0) == K * every + 2 * per_update
    assert fc.ops_per_chunk(dcfg, OBS, ACT, K, STEP0) == K * (
        ddpg.matmul_flops + ddpg.actor_bwd_flops
        + (fc.ADAM_OPS_PER_PARAM + fc.POLYAK_OPS_PER_PARAM) * (ddpg.n_actor + ddpg.n_critic))


# --- the learner, the noise stream and the training loop ------------------------


def test_td3_noise_eps_is_clipped_and_keyed_by_step():
    _, cfg = _configs(2, 0.2)
    gen = torch.Generator()
    a = fc.td3_noise_eps(cfg, gen, 7, K, B, ACT)
    assert a.shape == (K, B, ACT) and a.dtype == torch.float32
    assert float(a.abs().max()) <= cfg.target_noise_clip
    assert float((a.abs() == cfg.target_noise_clip).float().mean()) < 0.2
    assert torch.equal(a, fc.td3_noise_eps(cfg, torch.Generator(), 7, K, B, ACT))
    assert not torch.equal(a, fc.td3_noise_eps(cfg, gen, 8, K, B, ACT))


def test_sharded_learner_td3_chunk():
    """run_sample_chunk draws the chunk's noise from the learner's step
    and runs the plain chunk on it; the actor count follows the delay."""
    _, cfg = _configs(2, 0.2)
    rng = np.random.default_rng(2)
    replay = DeviceReplay(64, OBS, ACT, device="cpu", block_size=16)
    replay.add_packed(_batches(3, k=8).reshape(64, -1))
    idx = torch.from_numpy(rng.integers(0, 64, (K, B)))
    start = train_state_from_numpy(_np(_jax_state(_configs()[0])))
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, state=start)
    out = learner.run_sample_chunk(replay, idx=idx)
    eps = fc.td3_noise_eps(cfg, torch.Generator(), STEP0, K, B, ACT)
    ref, rtd, _ = fc.fused_chunk_reference(cfg, start, replay.storage[idx], SCALE, OFFSET, eps)
    np.testing.assert_array_equal(out.td_errors.numpy(), rtd.numpy())
    np.testing.assert_array_equal(fc.flatten_state(learner.state).numpy(),
                                  fc.flatten_state(ref).numpy())
    assert int(learner.state.actor_opt.count) == COUNT_A + 2     # updates at 6, 8
    learner.run_sample_chunk(replay, idx=idx)                    # steps 10 .. 14
    assert int(learner.state.actor_opt.count) == COUNT_A + 5 and int(learner.state.step) == 15


def test_tiny_td3_train_run(tmp_path):
    final = train_in_subprocess([
        "--twin_critic=true", "--policy_delay=2", "--target_noise=0.2",
        "--actor_hidden=16,16", "--critic_hidden=16,16", "--batch_size=16",
        "--learner_chunk=3", "--replay_min_size=100", "--total_env_steps=300",
        "--eval_every=0", "--eval_episodes=1",
    ], tmp_path / "metrics.jsonl")[-1]
    assert final["kind"] == "final" and final["chunks"] >= 1
    assert final["learner_steps"] == final["chunks"] * 3
    assert all(np.isfinite(final[k]) for k in (*METRIC_KEYS, "final_return"))


# --- the JAX kernel --------------------------------------------------


def test_plain_td3_chunk_matches_jax_kernel():
    """The plain chunk against the JAX Pallas kernel's TD3 branch itself,
    in interpret mode (delay 2 with smoothing, from an odd step)."""
    jcfg, cfg = _configs(2, 0.2)
    jstate = _jax_state(jcfg)
    packed = _batches(8)
    eps = _jax_eps(jcfg, STEP0, K)
    run_jax = jax_fused_chunk.make_fused_chunk_fn(
        jcfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, interpret=True)
    jnew, jtd, jmet = jax.jit(run_jax)(jstate, jnp.asarray(packed), jnp.asarray(eps))
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, device="cpu")
    new, td, met = run(train_state_from_numpy(_np(jstate)), torch.from_numpy(packed),
                       torch.from_numpy(eps))
    _assert_state_matches(new, _np(jnew))
    _close(td.numpy(), np.asarray(jtd))
    for name in METRIC_KEYS:
        _close(float(met[name]), float(jmet[name]), METRIC_RTOL, ATOL)
