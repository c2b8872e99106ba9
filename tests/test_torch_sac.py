"""The port's SAC path against the JAX package's, on the CPU at a small size
(obs 3, act 2, actor 32x32, critic 32x24x16, batch 8, K 5).

- config: the SAC fields' defaults and the JAX package's gates
  (tests/test_sac.py::test_sac_config_gates);
- the state: init shapes, the numpy weight bridge with log_alpha and
  alpha_opt, and the kernel's flat layout with the temperature's slots;
- the losses, the eager SAC step and the plain SAC chunk
  (fused_chunk_reference) against K calls of the JAX make_learner_step
  with sac=True, from one JAX-made TrainState, with the JAX normals
  (fused_chunk.sac_noise_eps, the scan path's own stream) passed in:
  the temperature learned and fixed, and from an odd step with every
  count offset;
- both critic members equal, so every row of the min gate ties;
- the kernel's task program for SAC, run by the numpy interpreter of
  tests/test_torch_fused_chunk.py, against the plain chunk, its stage
  order and its operation count;
- the Gaussian NumpyPolicy against the JAX package's, the uniform warmup's
  budget, ShardedLearner's SAC chunk and a tiny SAC training run (in a
  subprocess).

The JAX Pallas kernel's SAC branch in interpret mode is not run here (the
JAX suite marks those cases slow); the JAX scan step is the oracle. The
kernel against the plain chunk on a card (marker `cuda`) is in
tests/test_torch_on_card.py.

Tolerances: rtol 2e-5, atol 1e-6, as in test_torch_core.py; the chunk-mean
metrics 5e-5 (their sums run in another order). The plain chunk writes the
log-prob's Gaussian term as -eps^2 / 2 (the JAX kernel's form), the steps
as ((u - mean) / std)^2: they agree to the ULP, inside these tolerances.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu import types as jax_types
from distributed_ddpg_tpu.actors.policy import NumpyPolicy as JaxNumpyPolicy
from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.learner import make_learner_step as jax_step
from distributed_ddpg_tpu.models.mlp import actor_gaussian_apply as jax_gaussian_apply
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu.ops import losses as jax_losses
from distributed_ddpg_tpu_torch import types
from distributed_ddpg_tpu_torch.actors import policy
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make, spec_of
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    init_train_state,
    make_act_fn,
    make_learner_step,
    train_state_from_numpy,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.models import mlp
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.ops import losses
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
from test_torch_fused_chunk import _assert_stage_dependencies, _interpret_program
from test_torch_slice import train_in_subprocess

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT, B, K = 3, 2, 8, 5
ACTOR, CRITIC = (32, 32), (32, 24, 16)
SCALE, OFFSET = 2.0, 0.5
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5
LR = dict(actor_lr=3e-4, critic_lr=3e-4, tau=0.005)
# (autotune, step0): the temperature learned from step 0, fixed, and
# learned from an odd step with every count offset.
CASES = [(True, 0), (False, 0), (True, 7)]


def _configs(autotune=True, device="cpu", **kw):
    common = dict(actor_hidden=ACTOR, critic_hidden=CRITIC, batch_size=B, seed=3,
                  sac=True, sac_autotune=autotune, **LR, **kw)
    return JaxConfig(**common), DDPGConfig(device=device, **common)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(jcfg, step0=0, tied=False):
    """The JAX package's initial SAC state. From step0 > 0 it is a state in
    mid-training: every count offset (actor, critic and temperature each
    their own) and nonzero Adam moments. (Counts past 1 over zero moments
    make Adam's step sign-like down to gradients of ~1e-8, where the two
    frameworks' rounding differs; no run reaches such a state.) `tied`
    copies critic member 0 over member 1 (online and target)."""
    s = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    if step0:
        rng = np.random.default_rng(step0)

        def moments(opt, count):
            return opt._replace(
                mu=jax.tree.map(lambda x: jnp.asarray(
                    1e-3 * rng.standard_normal(x.shape), jnp.float32), opt.mu),
                nu=jax.tree.map(lambda x: jnp.asarray(
                    rng.uniform(1e-6, 1e-4, x.shape), jnp.float32), opt.nu),
                count=jnp.int32(count))

        s = s._replace(
            step=jnp.int32(step0),
            actor_opt=moments(s.actor_opt, step0 + 2),
            critic_opt=moments(s.critic_opt, step0 + 4),
            log_alpha=jnp.float32(math.log(0.3)),
        )
        if s.alpha_opt is not None:
            s = s._replace(alpha_opt=s.alpha_opt._replace(
                mu=jnp.float32(0.01), nu=jnp.float32(2e-4), count=jnp.int32(step0 - 3)))
    if tied:
        tie = lambda t: jax.tree.map(lambda x: jnp.stack([x[0], x[0]]), t)  # noqa: E731
        s = s._replace(critic_params=tie(s.critic_params),
                       target_critic_params=tie(s.target_critic_params),
                       critic_opt=s.critic_opt._replace(mu=tie(s.critic_opt.mu),
                                                        nu=tie(s.critic_opt.nu)))
    return s


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


def _jax_eps(jcfg, step0, k=K):
    """The JAX package's normals (eps_next, eps_cur) for steps step0 ..
    step0+k-1: the scan path's own fold_in stream."""
    e_next, e_cur = jax_fused_chunk.sac_noise_eps(jcfg, jnp.int32(step0), k, B, ACT)
    return np.array(e_next), np.array(e_cur)


@functools.lru_cache(maxsize=None)
def _jax_step_fn(jcfg):
    return jax.jit(jax_step(jcfg, SCALE, action_offset=OFFSET))


def _jax_steps(jcfg, jstate, packed):
    """K calls of the JAX make_learner_step: (end state, td[K, B], metrics
    per step)."""
    step = _jax_step_fn(jcfg)
    tds, mets = [], []
    for k in range(packed.shape[0]):
        out = step(jstate, jax_types.unpack_batch(jnp.asarray(packed[k]), OBS, ACT))
        jstate = out.state
        tds.append(np.asarray(out.td_errors))
        mets.append({n: float(out.metrics[n]) for n in METRIC_KEYS})
    return _np(jstate), np.stack(tds), mets


def _assert_state_matches(state, ref):
    """Every group of the port's state against the JAX numpy state, the
    temperature with its Adam state, and the counts exactly."""
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
    _close(float(state.log_alpha), float(ref.log_alpha))
    assert (state.alpha_opt is None) == (ref.alpha_opt is None)
    if ref.alpha_opt is not None:
        _close(float(state.alpha_opt.mu), float(ref.alpha_opt.mu))
        _close(float(state.alpha_opt.nu), float(ref.alpha_opt.nu))
        assert int(state.alpha_opt.count) == int(ref.alpha_opt.count)


def _chunk_eps(eps):
    return tuple(torch.from_numpy(e) for e in eps)


# --- config -----------------------------------------------------------------


def test_sac_config_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(DDPGConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for name in ("sac", "sac_alpha", "sac_autotune", "sac_log_std_min", "sac_log_std_max",
                 "warmup_uniform_steps"):
        assert ours[name] == theirs[name], name
    assert math.isnan(ours["target_entropy"]) and math.isnan(theirs["target_entropy"])
    cfg = DDPGConfig.from_flags(["--sac=true", "--actor_lr=3e-4", "--critic_lr=3e-4",
                                 "--tau=0.005", "--device=cpu"])
    jcfg = JaxConfig.from_flags(["--sac=true", "--actor_lr=3e-4", "--critic_lr=3e-4",
                                 "--tau=0.005"])
    assert (cfg.sac, cfg.sac_autotune, cfg.actor_lr, cfg.tau) == (True, True, 3e-4, 0.005)
    assert cfg.resolved_warmup_uniform() == jcfg.resolved_warmup_uniform() == 1000
    for override in (dict(), dict(warmup_uniform_steps=0), dict(warmup_uniform_steps=77),
                     dict(sac=False), dict(sac=False, warmup_uniform_steps=5)):
        assert (cfg.replace(**override).resolved_warmup_uniform()
                == jcfg.replace(**override).resolved_warmup_uniform())
    assert fc.supported(cfg)


@pytest.mark.parametrize("override", [
    dict(sac=True, twin_critic=True), dict(sac=True, distributional=True),
    dict(sac=True, fused_update=True), dict(sac=True, sac_alpha=0.0),
    dict(sac=True, sac_log_std_min=3.0), dict(warmup_uniform_steps=-2),
])
def test_sac_gates_match_jax(override):
    """JAX's test_sac_config_gates cases (the native-backend one has no
    counterpart: the port has no backend switch), with the same messages."""
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**override)
    with pytest.raises(ValueError) as ours:
        DDPGConfig(**override)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("override", [
    dict(serve_actors=True), dict(compute_dtype="float16"),
    dict(guardrails=True, fused_chunk="on"), dict(data_axis=-3),
])
def test_sac_with_options_outside_the_slice_raises(override):
    name = next(iter(override))
    with pytest.raises(ValueError, match=name):
        DDPGConfig(sac=True, **override)


# --- the state, the bridge and the flat layout -----------------------------


@pytest.mark.parametrize("autotune", [True, False])
def test_sac_init_shapes_match_jax(autotune):
    jcfg, cfg = _configs(autotune)
    ref = _np(jax_init(jcfg, OBS, ACT, seed=0))
    state = init_train_state(cfg, OBS, ACT, seed=0)
    for group in ("actor_params", "critic_params", "target_actor_params",
                  "target_critic_params"):
        assert [tuple(l[k].shape) for l in getattr(state, group) for k in ("w", "b")] == [
            l[k].shape for l in getattr(ref, group) for k in ("w", "b")]
    assert tuple(state.actor_params[-1]["w"].shape) == (ACTOR[-1], 2 * ACT)
    first = state.critic_params[0]["w"]
    assert first.shape[0] == 2 and not torch.equal(first[0], first[1])
    assert float(state.actor_params[-1]["w"].abs().max()) <= mlp.FINAL_INIT_SCALE
    np.testing.assert_array_equal(state.log_alpha.numpy(), ref.log_alpha)
    assert (state.alpha_opt is None) == (ref.alpha_opt is None) == (not autotune)
    if autotune:
        assert int(state.alpha_opt.count) == 0 and float(state.alpha_opt.nu) == 0.0


@pytest.mark.parametrize("autotune", [True, False])
def test_sac_state_round_trip_and_flat_layout(autotune):
    jcfg, _ = _configs(autotune)
    ref = _np(_jax_state(jcfg, step0=7))
    state = train_state_from_numpy(ref)
    back = train_state_to_numpy(state)
    leaves, ref_leaves = jax.tree.leaves(back), jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)
    # The kernel's flat state: the 8 groups, then log_alpha (and alpha_opt's
    # moments when learned). Its views give the same values back, with
    # every count (the temperature's too) advanced by the chunk.
    flat = fc.flatten_state(state)
    n = 4 * sum(v.size for g in (ref.actor_params, ref.critic_params)
                for layer in g for v in layer.values())
    alpha = [ref.log_alpha] + ([] if ref.alpha_opt is None else
                               [ref.alpha_opt.mu, ref.alpha_opt.nu])
    assert flat.numel() == n + len(alpha) == fc.state_bytes(_configs(autotune)[1], OBS, ACT) // 4
    np.testing.assert_array_equal(flat[n:].numpy(), alpha)
    again = fc.unflatten_state(flat, state, 4, 4)
    assert torch.equal(fc.flatten_state(again), flat)
    assert float(again.log_alpha) == float(ref.log_alpha)
    assert (int(again.step), int(again.actor_opt.count), int(again.critic_opt.count)) == (
        int(ref.step) + 4, int(ref.actor_opt.count) + 4, int(ref.critic_opt.count) + 4)
    if autotune:
        assert int(again.alpha_opt.count) == int(ref.alpha_opt.count) + 4
    else:
        assert again.alpha_opt is None


# --- the losses, the eager step and the plain chunk against the JAX scan -----


def test_sac_losses_match_jax():
    jcfg, _ = _configs()
    jstate = _jax_state(jcfg, step0=7)
    state = train_state_from_numpy(_np(jstate))
    packed = _batches(1, k=1)[0]
    jbatch = jax_types.unpack_batch(jnp.asarray(packed), OBS, ACT)
    batch = types.unpack_batch(torch.from_numpy(packed), OBS, ACT)
    k_next, k_cur = jax.random.split(jax.random.PRNGKey(9))
    e_next = torch.from_numpy(np.array(jax.random.normal(k_next, (B, ACT))))
    e_cur = torch.from_numpy(np.array(jax.random.normal(k_cur, (B, ACT))))
    alpha = float(np.exp(np.asarray(jstate.log_alpha)))
    lo, hi = jcfg.sac_log_std_min, jcfg.sac_log_std_max
    scale, offset = torch.tensor(SCALE), torch.tensor(OFFSET)
    jloss, jtd = jax_losses.sac_critic_loss(
        jstate.critic_params, jstate.actor_params, jstate.target_critic_params, jbatch,
        SCALE, k_next, alpha, lo, hi, action_offset=OFFSET)
    loss, td = losses.sac_critic_loss(
        state.critic_params, state.actor_params, state.target_critic_params, batch,
        scale, e_next, alpha, lo, hi, offset)
    _close(float(loss), float(jloss))
    _close(td.numpy(), np.asarray(jtd))
    (jaloss, jlp) = jax_losses.sac_actor_loss(
        jstate.actor_params, jstate.critic_params, jbatch, SCALE, k_cur, alpha, lo, hi,
        action_offset=OFFSET)
    aloss, lp = losses.sac_actor_loss(state.actor_params, state.critic_params, batch, scale,
                                      e_cur, alpha, lo, hi, offset)
    _close(float(aloss), float(jaloss))
    _close(float(lp), float(jlp))
    jmean, jlog_std = jax_gaussian_apply(jstate.actor_params, jbatch.obs, lo, hi)
    mean, log_std = mlp.actor_gaussian_apply(state.actor_params, batch.obs, lo, hi)
    _close(mean.numpy(), np.asarray(jmean))
    _close(log_std.numpy(), np.asarray(jlog_std))
    for target, scale_ in ((float("nan"), SCALE), (float("nan"), (1.0, 3.0)), (-0.7, SCALE)):
        assert losses.sac_target_entropy(target, ACT, scale_) == jax_losses.sac_target_entropy(
            target, ACT, scale_)
    assert losses.sac_target_entropy(float("nan"), 1, 2.0) == pytest.approx(-1 + math.log(2))


@pytest.mark.parametrize("autotune,step0", CASES)
def test_eager_sac_steps_match_jax(autotune, step0):
    jcfg, cfg = _configs(autotune)
    jstate = _jax_state(jcfg, step0)
    packed = _batches(4)
    e_next, e_cur = _jax_eps(jcfg, step0)
    ref, rtds, rmets = _jax_steps(jcfg, jstate, packed)
    step = make_learner_step(cfg, SCALE, OFFSET)
    state = train_state_from_numpy(_np(jstate))
    for k in range(K):
        out = step(state, types.unpack_batch(torch.from_numpy(packed[k]), OBS, ACT),
                   (torch.from_numpy(e_next[k]), torch.from_numpy(e_cur[k])))
        state = out.state
        _close(out.td_errors.numpy(), rtds[k])
        for name in METRIC_KEYS:
            _close(float(out.metrics[name]), rmets[k][name], RTOL, ATOL)
    _assert_state_matches(state, ref)
    if autotune:   # the temperature moved
        assert float(state.log_alpha) != float(jstate.log_alpha)


@pytest.mark.parametrize("autotune,step0", CASES)
def test_plain_sac_chunk_matches_jax_steps(autotune, step0):
    jcfg, cfg = _configs(autotune)
    jstate = _jax_state(jcfg, step0)
    packed = _batches(5)
    eps = _jax_eps(jcfg, step0)
    ref, rtds, rmets = _jax_steps(jcfg, jstate, packed)
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, device="cpu")
    new, td, met = run(train_state_from_numpy(_np(jstate)), torch.from_numpy(packed),
                       _chunk_eps(eps))
    _assert_state_matches(new, ref)
    _close(td.numpy(), rtds)
    for name in METRIC_KEYS:
        _close(float(met[name]), np.mean([m[name] for m in rmets]), METRIC_RTOL, ATOL)


def test_tied_critics_split_the_min_gate():
    """Both critic members equal: every row of the min gate ties, and the
    actor's gradient takes half of each member's (jnp.min's gradient; the
    eager step's torch.amin; the plain chunk's 0.5/0.5 gate). The members
    stay equal through the chunk."""
    jcfg, cfg = _configs()
    jstate = _jax_state(jcfg, step0=7, tied=True)
    packed = _batches(12)
    eps = _jax_eps(jcfg, 7)
    ref, rtds, rmets = _jax_steps(jcfg, jstate, packed)
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, device="cpu")
    start = train_state_from_numpy(_np(jstate))
    new, td, met = run(start, torch.from_numpy(packed), _chunk_eps(eps))
    _assert_state_matches(new, ref)
    _close(td.numpy(), rtds)
    for name in METRIC_KEYS:
        _close(float(met[name]), np.mean([m[name] for m in rmets]), METRIC_RTOL, ATOL)
    for layer in new.critic_params:
        assert torch.equal(layer["w"][0], layer["w"][1])
    step = make_learner_step(cfg, SCALE, OFFSET)
    state = start
    for k in range(K):
        state = step(state, types.unpack_batch(torch.from_numpy(packed[k]), OBS, ACT),
                     (torch.from_numpy(eps[0][k]), torch.from_numpy(eps[1][k]))).state
    _close(fc.flatten_state(new).numpy(), fc.flatten_state(state).numpy())


def test_sac_chunks_carry_the_counts_across_the_boundary():
    """Two chunks of K = 3 against six JAX steps: the second picks up the
    step, every count and the temperature where the first left them."""
    k = 3
    jcfg, cfg = _configs()
    jstate = _jax_state(jcfg, step0=7)
    packed = _batches(6, k=2 * k)
    eps = _jax_eps(jcfg, 7, 2 * k)
    ref, rtds, _ = _jax_steps(jcfg, jstate, packed)
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=k, device="cpu")
    state = train_state_from_numpy(_np(jstate))
    tds = []
    for c in range(2):
        sl = slice(c * k, (c + 1) * k)
        state, td, _ = run(state, torch.from_numpy(packed[sl]),
                           (torch.from_numpy(eps[0][sl]), torch.from_numpy(eps[1][sl])))
        tds.append(td.numpy())
    _assert_state_matches(state, ref)
    _close(np.concatenate(tds), rtds)


# --- the kernel's program -----------------------------------------------------


@pytest.mark.parametrize("autotune,tied", [(True, False), (False, False), (True, True)])
def test_sac_program_matches_plain_chunk(autotune, tied):
    jcfg, cfg = _configs(autotune)
    state = train_state_from_numpy(_np(_jax_state(jcfg, step0=7, tied=tied)))
    packed = _batches(11)
    eps = _jax_eps(jcfg, 7)
    flat, td, met = _interpret_program(cfg, state, packed, SCALE, OFFSET, eps, OBS, ACT)
    new, rtd, rmet = fc.fused_chunk_reference(
        cfg, state, torch.from_numpy(packed), SCALE, OFFSET, _chunk_eps(eps))
    _close(flat, fc.flatten_state(new).numpy())
    _close(td, rtd.numpy())
    _close(met, torch.stack([rmet[k] for k in METRIC_KEYS]).numpy(), METRIC_RTOL, ATOL)


def test_sac_program_stages():
    """Every read comes from an earlier stage and no scratch range is
    written twice; the step has 13 stages at two critic hidden layers
    (the Gaussian heads, the samples, the target and online critics at the
    samples, the target and the min gate, the critics' backward beside the
    actor's path to its head cotangent, the actor's backward); four SAC
    row tasks."""
    _, cfg = _configs()
    prog = fc._plan(cfg, OBS, ACT)
    _assert_stage_dependencies(prog, B)
    assert prog.stage_tiles_skip == prog.stage_tiles          # no delay
    two = fc._plan(cfg.replace(critic_hidden=(32, 24)), OBS, ACT)
    assert len(two.stage_tiles) == 13
    _assert_stage_dependencies(two, B)
    epis = [int(r[fc.F_EPI]) for r in prog.tasks if r[fc.F_OP] == fc.OP_ROWS]
    assert sorted(epis) == sorted([fc.EPI_SAC_SAMPLE, fc.EPI_SAC_SAMPLE, fc.EPI_SAC_TD,
                                   fc.EPI_SAC_PI, fc.EPI_SAC_ACT])
    td3 = fc._plan(DDPGConfig(device="cpu", actor_hidden=ACTOR, critic_hidden=CRITIC,
                              batch_size=B, twin_critic=True), OBS, ACT)
    assert prog.n_critic == td3.n_critic
    assert prog.n_actor == td3.n_actor + ACTOR[-1] * ACT + ACT   # the log_std half of the head


def test_sac_operation_count():
    """The SAC program's products: two Gaussian forwards, the four critic
    forwards of both paths, both critics' backward with weight gradients,
    both critics' backward to the action, and the actor's backward from its
    [B, 2 act] head; plus the row tasks and the temperature's Adam."""
    _, cfg = _configs()
    prog = fc._plan(cfg, OBS, ACT)
    adims, cdims = fc._net_dims(cfg, OBS, ACT)
    afwd = sum(2 * B * i * o for i, o in adims)
    cfwd = sum(2 * B * i * o for i, o in cdims)
    shared_h1 = 2 * B * cdims[0][0] * cdims[0][1]           # the actor path reuses layer 0
    cbwd = sum(2 * B * i * o + 2 * B * o for i, o in cdims)
    cbwd += 2 * B * CRITIC[0] * cdims[1][1] + sum(2 * B * i * o for i, o in cdims[2:])
    # Online and target critics on the batch, the online ones at the sample.
    assert prog.matmul_flops == 2 * afwd + 2 * (3 * cfwd - shared_h1) + 2 * cbwd
    to_action = sum(2 * B * i * o for i, o in cdims[2:]) + 2 * B * ACT * cdims[1][1]
    abwd = sum(2 * B * i * o + 2 * B * o for i, o in adims)
    abwd += sum(2 * B * i * o for i, o in adims[1:])
    assert prog.actor_bwd_flops == 2 * to_action + abwd
    assert prog.row_ops == B * (ACT * (2 * fc.SAC_SAMPLE_DIM_OPS + fc.SAC_ACT_DIM_OPS)
                                + fc.SAC_TD_ROW_OPS + fc.SAC_PI_ROW_OPS)
    every = prog.matmul_flops + prog.row_ops + fc.ADAM_OPS_PER_PARAM * (prog.n_critic + 1)
    per_update = (prog.actor_bwd_flops + fc.ADAM_OPS_PER_PARAM * prog.n_actor
                  + fc.POLYAK_OPS_PER_PARAM * (prog.n_actor + prog.n_critic))
    assert fc.ops_per_chunk(cfg, OBS, ACT, K, 7) == K * (every + per_update)
    fixed = cfg.replace(sac_autotune=False)
    assert fc.ops_per_chunk(cfg, OBS, ACT, K) - fc.ops_per_chunk(fixed, OBS, ACT, K) == (
        K * fc.ADAM_OPS_PER_PARAM)


# --- the policy, the warmup, the learner and the training loop -------------------


def test_gaussian_numpy_policy_matches_jax():
    jcfg, cfg = _configs()
    jstate = _jax_state(jcfg)
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K,
                             state=train_state_from_numpy(_np(jstate)))
    flat = learner.actor_params_to_host()
    layout = policy.param_layout(OBS, policy.actor_head_dim(ACT, True), ACTOR)
    assert flat.size == policy.layout_size(layout)
    obs = np.random.default_rng(1).standard_normal((B, OBS)).astype(np.float32)
    for stochastic in (False, True):
        kw = dict(gaussian=True, stochastic=stochastic, seed=11,
                  log_std_min=cfg.sac_log_std_min, log_std_max=cfg.sac_log_std_max)
        ours = policy.NumpyPolicy(layout, SCALE, OFFSET, **kw)
        theirs = JaxNumpyPolicy(layout, SCALE, OFFSET, **kw)
        ours.load_flat(flat)
        theirs.load_flat(flat)
        for _ in range(3):   # the same RNG stream, call after call
            np.testing.assert_array_equal(ours(obs), theirs(obs))
    # The deterministic mode is the Gaussian's mode, tanh(mean), as the
    # port's make_act_fn and the JAX actor_gaussian_apply give it.
    mean, _ = jax_gaussian_apply(jstate.actor_params, obs, cfg.sac_log_std_min,
                                 cfg.sac_log_std_max)
    want = np.tanh(np.asarray(mean)) * SCALE + OFFSET
    det = policy.NumpyPolicy(layout, SCALE, OFFSET, gaussian=True)
    det.load_flat(flat)
    _close(det(obs), want, 1e-5, 1e-6)
    act = make_act_fn(cfg, SCALE, OFFSET)(learner.state.actor_params, torch.from_numpy(obs))
    _close(act.numpy(), want, 1e-5, 1e-6)


@pytest.mark.parametrize("num_actors,override,want", [
    (1, dict(), 1000), (3, dict(), 334), (4, dict(warmup_uniform_steps=10), 3),
    (2, dict(warmup_uniform_steps=0), 0), (2, dict(sac=False), 0),
])
def test_warmup_budget_per_worker(num_actors, override, want):
    """config.resolved_warmup_uniform split evenly (ceil) across the pool,
    net of the env steps already drained (a respawned worker does not put
    random actions into a trained run's replay). The pool is not started."""
    _, cfg = _configs(num_actors=num_actors)
    cfg = cfg.replace(**override)
    pool = ActorPool(cfg, spec_of(make(cfg.env_id)))
    assert pool.warmup_budget_per_worker() == want
    if want:
        pool._steps_received = cfg.resolved_warmup_uniform() - 1
        assert pool.warmup_budget_per_worker() == 1
    pool._steps_received = cfg.resolved_warmup_uniform() + 5
    assert pool.warmup_budget_per_worker() == 0


def test_sac_noise_eps_is_keyed_by_step():
    _, cfg = _configs()
    e_next, e_cur = fc.sac_noise_eps(cfg, torch.Generator(), 7, K, B, ACT)
    assert e_next.shape == e_cur.shape == (K, B, ACT) and e_next.dtype == torch.float32
    assert not torch.equal(e_next, e_cur)
    again = fc.sac_noise_eps(cfg, torch.Generator(), 7, K, B, ACT)
    assert torch.equal(e_next, again[0]) and torch.equal(e_cur, again[1])
    assert not torch.equal(e_next, fc.sac_noise_eps(cfg, torch.Generator(), 8, K, B, ACT)[0])


def test_sharded_learner_sac_chunk():
    """run_sample_chunk draws the chunk's normals from the learner's step
    and runs the plain chunk on them; the actor, critic and temperature
    counts and the step advance by K."""
    jcfg, cfg = _configs()
    rng = np.random.default_rng(2)
    replay = DeviceReplay(64, OBS, ACT, device="cpu", block_size=16)
    replay.add_packed(_batches(3, k=8).reshape(64, -1))
    idx = torch.from_numpy(rng.integers(0, 64, (K, B)))
    start = train_state_from_numpy(_np(_jax_state(jcfg, step0=7)))
    learner = ShardedLearner(cfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, state=start)
    out = learner.run_sample_chunk(replay, idx=idx)
    eps = fc.sac_noise_eps(cfg, torch.Generator(), 7, K, B, ACT)
    ref, rtd, _ = fc.fused_chunk_reference(cfg, start, replay.storage[idx], SCALE, OFFSET, eps)
    np.testing.assert_array_equal(out.td_errors.numpy(), rtd.numpy())
    np.testing.assert_array_equal(fc.flatten_state(learner.state).numpy(),
                                  fc.flatten_state(ref).numpy())
    learner.run_sample_chunk(replay, idx=idx)
    s = learner.state
    assert (int(s.step), int(s.actor_opt.count), int(s.critic_opt.count),
            int(s.alpha_opt.count)) == (7 + 2 * K, 9 + 2 * K, 11 + 2 * K, 4 + 2 * K)
    assert learner.actor_params_to_host().size == policy.layout_size(
        policy.param_layout(OBS, 2 * ACT, ACTOR))
    assert set(learner.metrics_to_host(out)) == set(METRIC_KEYS)


def test_tiny_sac_train_run(tmp_path):
    records = train_in_subprocess([
        "--sac=true", "--actor_lr=3e-4", "--critic_lr=3e-4", "--tau=0.005",
        "--actor_hidden=16,16", "--critic_hidden=16,16", "--batch_size=16",
        "--learner_chunk=4", "--replay_min_size=100", "--total_env_steps=400",
        "--eval_every=300", "--eval_episodes=1",
    ], tmp_path / "metrics.jsonl")
    assert {"train", "eval", "final"} <= {r["kind"] for r in records}
    train_rec = next(r for r in records if r["kind"] == "train")
    assert {"env_steps_per_sec", "learner_steps_per_sec", *METRIC_KEYS} <= set(train_rec)
    final = records[-1]
    assert final["kind"] == "final" and final["chunks"] >= 1
    assert final["learner_steps"] == final["chunks"] * 4
    assert all(np.isfinite(final[k]) for k in (*METRIC_KEYS, "final_return"))
    assert not any("alpha" in r for r in records)   # the JAX trainer records none
