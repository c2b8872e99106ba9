"""Mixed precision (compute_dtype='bfloat16') in the port against the JAX
package, on the CPU at a small size (obs 3, act 2, nets 32x32, batch 8,
K 4, from step 5 with nonzero Adam moments and every count offset), for
DDPG, TD3 (delay 2, smoothing noise), D4PG (21 atoms) and SAC (the
temperature learned).

There are two rounding rules, each in its own place, as in the JAX
package:

- the eager step (models/mlp.py::_Bf16Dense) follows JAX autodiff of
  models/mlp.py::_dense: bf16 operands and an f32 sum forward; backward the
  f32 cotangent times the rounded operand, the product rounded to bf16;
- the plain chunk (ops/fused_chunk.fused_chunk_reference, what the CUDA
  kernel computes) follows the JAX kernel's `cast`: both operands of every
  product rounded, the f32 sum kept, the bias gradients f32 sums of the
  unrounded cotangent.

Checks: the eager step against the JAX scan step (make_learner_step); the
plain chunk against the JAX Pallas kernel in interpret mode; the plain
chunk against K eager steps at the JAX tests' own bf16 tolerances
(tests/test_fused_chunk.py:85, :334), which is where the two rules meet;
the bias-gradient rule; the kernel's task program, run by the numpy
interpreter of tests/test_torch_fused_chunk.py, against the plain chunk;
the config's gate; and a tiny bf16 training run (in a subprocess). Each
family's JAX runs are made once for the module (a fixture). The kernel
against the plain chunk on a card is tests/test_torch_on_card.py.

Tolerances (each measured here first, then stated):
- eager step vs JAX scan step, one step: rtol 2e-5, atol 1e-6, the f32
  oracle tolerance of test_torch_core.py (measured: at most 2.7e-7, D4PG's
  td); the f32 step's td misses the bf16 one beyond it (up to 1.6e-5).
- plain chunk vs JAX kernel, K steps: the same, the metrics 5e-5 (both
  round the same operands; measured: at most 4.2e-7, D4PG's td).
- plain chunk vs eager steps: rtol 3e-2, atol 3e-3, metrics 3e-2 (the JAX
  tests' bf16 tolerances; measured: at most 5.2e-4, SAC's actor gradient
  norm).
- program vs plain chunk: rtol 2e-5, atol 1e-6, metrics 5e-5, as the f32
  interpreter test (measured: at most 2.4e-7).
"""

import math

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
    make_learner_step,
    train_state_from_numpy,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.models.mlp import round_bf16
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from test_torch_fused_chunk import _interpret_program
from test_torch_slice import train_in_subprocess

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT, B, K, STEP0 = 3, 2, 8, 4, 5
HIDDEN = (32, 32)
SCALE, OFFSET = 2.0, 0.0
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5
BF16_TOL = dict(rtol=3e-2, atol=3e-3)        # tests/test_fused_chunk.py:85, :334
BF16_METRIC_RTOL = 3e-2
FAMILIES = {
    "ddpg": {},
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0),
    "sac": dict(sac=True),
}
GROUPS = ("actor_params", "critic_params", "target_actor_params", "target_critic_params")


def _configs(family):
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                  compute_dtype="bfloat16", **FAMILIES[family])
    return JaxConfig(**common), DDPGConfig(device="cpu", **common)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(jcfg):
    """The JAX package's initial state, moved to mid-training: step STEP0,
    every count offset and nonzero Adam moments (over zero moments Adam's
    step turns sign-like, where the two frameworks' rounding differs)."""
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
    return s


def _batches(seed):
    rng = np.random.default_rng(seed)
    return types.pack_batch_np({
        "obs": rng.standard_normal((K, B, OBS)).astype(np.float32),
        "action": rng.uniform(-2, 2, (K, B, ACT)).astype(np.float32),
        "reward": rng.standard_normal((K, B)).astype(np.float32),
        "discount": np.full((K, B), 0.99, np.float32),
        "next_obs": rng.standard_normal((K, B, OBS)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, (K, B)).astype(np.float32),
    })


def _jax_eps(jcfg):
    """The JAX package's noise for steps STEP0 .. STEP0+K-1 (the scan
    path's own stream): TD3's smoothing [K, B, act], SAC's normals
    (eps_next, eps_cur), or None."""
    if jcfg.sac:
        return tuple(np.array(e) for e in jax_fused_chunk.sac_noise_eps(
            jcfg, jnp.int32(STEP0), K, B, ACT))
    if jcfg.twin_critic:
        return np.array(jax_fused_chunk.td3_noise_eps(jcfg, jnp.int32(STEP0), K, B, ACT))
    return None


def _eps_at(eps, k):
    """The port's eps for eager step k (None, TD3's [B, act] or SAC's pair)."""
    if eps is None:
        return None
    if isinstance(eps, tuple):
        return tuple(torch.from_numpy(e[k]) for e in eps)
    return torch.from_numpy(eps[k])


def _chunk_eps(eps):
    if eps is None:
        return None
    if isinstance(eps, tuple):
        return tuple(torch.from_numpy(e) for e in eps)
    return torch.from_numpy(eps)


@pytest.fixture(scope="module", params=list(FAMILIES))
def run(request):
    """One family's inputs and JAX runs, made once: the JAX state, the
    packed batches and noise, the JAX scan step's first step, and the JAX
    kernel's chunk of K steps (interpret mode)."""
    family = request.param
    jcfg, cfg = _configs(family)
    jstate = _jax_state(jcfg)
    packed = _batches(11)
    eps = _jax_eps(jcfg)
    # The scan step draws TD3's and SAC's noise itself, from eps[0]'s stream.
    step_out = jax.jit(jax_step(jcfg, SCALE, action_offset=OFFSET))(
        jstate, jax_types.unpack_batch(jnp.asarray(packed[0]), OBS, ACT))
    run_jax = jax_fused_chunk.make_fused_chunk_fn(
        jcfg, OBS, ACT, SCALE, OFFSET, chunk_size=K, interpret=True)
    jargs = [jstate, jnp.asarray(packed)]
    if eps is not None:
        jargs.append(tuple(map(jnp.asarray, eps)) if jcfg.sac else jnp.asarray(eps))
    kernel_out = jax.jit(run_jax)(*jargs)
    return dict(family=family, jcfg=jcfg, cfg=cfg, jstate=_np(jstate), packed=packed,
                eps=eps, step=_np(step_out), kernel=_np(kernel_out))


def _diff(name, got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    print(f"{name}: max_abs_err {err.max():.3e}, {bad.mean():.2e} beyond rtol {rtol} "
          f"atol {atol}")
    return err.max(), bad


def _assert_close(name, got, want, rtol=RTOL, atol=ATOL):
    _, bad = _diff(name, got, want, rtol, atol)
    assert not bad.any(), f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol}"


def _assert_state(state, ref, rtol=RTOL, atol=ATOL):
    """The port's TrainState against a numpy one: params, targets, both
    Adam moments, the counts, SAC's temperature."""
    for group in GROUPS:
        for i, (lp, lr) in enumerate(zip(getattr(state, group), getattr(ref, group))):
            for key in ("w", "b"):
                _assert_close(f"{group}[{i}].{key}", lp[key].detach().numpy(), lr[key],
                              rtol, atol)
    for opt in ("actor_opt", "critic_opt"):
        for part in ("mu", "nu"):
            for i, (lp, lr) in enumerate(zip(getattr(getattr(state, opt), part),
                                             getattr(getattr(ref, opt), part))):
                for key in ("w", "b"):
                    _assert_close(f"{opt}.{part}[{i}].{key}", lp[key].detach().numpy(),
                                  lr[key], rtol, atol)
        assert int(getattr(state, opt).count) == int(getattr(ref, opt).count)
    assert int(state.step) == int(ref.step)
    if state.log_alpha is not None:
        _assert_close("log_alpha", float(state.log_alpha), float(ref.log_alpha), rtol, atol)
        _assert_close("alpha_opt.mu", float(state.alpha_opt.mu), float(ref.alpha_opt.mu),
                      rtol, atol)
        assert int(state.alpha_opt.count) == int(ref.alpha_opt.count)


def _assert_metrics(met, ref, rtol, atol=ATOL):
    for name in METRIC_KEYS:
        _assert_close(name, float(met[name]), float(ref[name]), rtol, atol)


# --- the config ----------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_is_admitted(family):
    _, cfg = _configs(family)
    assert cfg.compute_dtype == "bfloat16" and fc.supported(cfg)
    assert DDPGConfig.from_flags(["--compute_dtype=bfloat16"]).compute_dtype == "bfloat16"


def test_other_dtypes_raise_as_in_jax():
    with pytest.raises(ValueError) as theirs:
        JaxConfig(compute_dtype="float16")
    with pytest.raises(ValueError) as ours:
        DDPGConfig(compute_dtype="float16")
    assert str(ours.value) == str(theirs.value)


# --- the eager step: JAX autodiff's rounding -------------------------------------


def test_eager_step_matches_jax_scan_step(run):
    cfg = run["cfg"]
    state = train_state_from_numpy(run["jstate"])
    batch = types.unpack_batch(torch.from_numpy(run["packed"][0]), OBS, ACT)
    out = make_learner_step(cfg, SCALE, OFFSET)(state, batch, _eps_at(run["eps"], 0))
    _assert_state(out.state, run["step"].state)
    _assert_close("td", out.td_errors.numpy(), run["step"].td_errors)
    _assert_metrics(out.metrics, run["step"].metrics, METRIC_RTOL)
    # The check sees the rounding: the f32 step's td misses the bf16 one's.
    f32 = make_learner_step(cfg.replace(compute_dtype="float32"), SCALE, OFFSET)(
        state, batch, _eps_at(run["eps"], 0))
    _, bad = _diff("the f32 step's td", f32.td_errors.numpy(), run["step"].td_errors,
                   RTOL, ATOL)
    assert bad.any()


# --- the plain chunk: the JAX kernel's rounding ----------------------------------


def test_plain_chunk_matches_jax_kernel(run):
    new, td, met = fc.fused_chunk_reference(
        run["cfg"], train_state_from_numpy(run["jstate"]), torch.from_numpy(run["packed"]),
        SCALE, OFFSET, _chunk_eps(run["eps"]))
    jnew, jtd, jmet = run["kernel"]
    _assert_state(new, jnew)
    _assert_close("td", td.numpy(), jtd)
    _assert_metrics(met, jmet, METRIC_RTOL)


def test_plain_chunk_tracks_eager_steps(run):
    """The two rounding rules meet only at bf16 level, as the JAX kernel and
    scan path do (tests/test_fused_chunk.py:85, :334)."""
    cfg = run["cfg"]
    state = train_state_from_numpy(run["jstate"])
    packed = torch.from_numpy(run["packed"])
    new, td, met = fc.fused_chunk_reference(cfg, state, packed, SCALE, OFFSET,
                                            _chunk_eps(run["eps"]))
    step = make_learner_step(cfg, SCALE, OFFSET)
    s, tds, mets = state, [], []
    for k in range(K):
        out = step(s, types.unpack_batch(packed[k], OBS, ACT), _eps_at(run["eps"], k))
        s = out.state
        tds.append(out.td_errors)
        mets.append(out.metrics)
    _assert_state(new, train_state_to_numpy(s), **BF16_TOL)
    _assert_close("td", td.numpy(), torch.stack(tds).numpy(), **BF16_TOL)
    mean = {n: float(torch.stack([m[n] for m in mets]).mean()) for n in METRIC_KEYS}
    _assert_metrics(met, mean, BF16_METRIC_RTOL, BF16_TOL["atol"])


def test_program_matches_plain_chunk(run):
    """The kernel's task table, run by the numpy interpreter with the
    kernel's rounding rule, against the plain chunk."""
    cfg = run["cfg"]
    state = train_state_from_numpy(run["jstate"])
    flat, td, met = _interpret_program(cfg, state, run["packed"], SCALE, OFFSET, run["eps"],
                                       OBS, ACT)
    new, rtd, rmet = fc.fused_chunk_reference(cfg, state, torch.from_numpy(run["packed"]),
                                              SCALE, OFFSET, _chunk_eps(run["eps"]))
    _assert_close("state", flat, fc.flatten_state(new).numpy())
    _assert_close("td", td, rtd.numpy())
    _assert_close("metrics", met, torch.stack([rmet[k] for k in METRIC_KEYS]).numpy(),
                  METRIC_RTOL, ATOL)


# --- the bias-gradient rule --------------------------------------------------------


@pytest.mark.parametrize("run", ["ddpg"], indirect=True)
def test_bias_gradients_are_f32_sums(run):
    """A bias gradient is the f32 sum of the unrounded cotangent, in the
    plain chunk as in the JAX kernel: one DDPG step's critic head bias
    gradient is sum(-2/B * w * td), whose terms here round differently in
    bf16; and the program with the bias gradients' operands rounded misses
    the JAX kernel where the kernel's own rule meets it. (The rule is the
    same in every family; DDPG's head shows it plainly.)"""
    cfg = run["cfg"]
    state = train_state_from_numpy(run["jstate"])
    packed = torch.from_numpy(run["packed"])
    new, td, _ = fc.fused_chunk_reference(cfg, state, packed[:1], SCALE, OFFSET)
    w = packed[0, :, -1]
    dz = (-2.0 / B) * w * td[0]
    assert not torch.equal(round_bf16(dz), dz)
    g = dz.sum(0)
    mu0 = state.critic_opt.mu[-1]["b"]
    want = fc.B1 * mu0 + (1.0 - fc.B1) * g
    assert torch.equal(new.critic_opt.mu[-1]["b"], want)
    rounded = fc.B1 * mu0 + (1.0 - fc.B1) * round_bf16(dz).sum(0)
    _, bad = _diff("bias rounded: critic_opt.mu[-1].b after one step", rounded, want,
                   RTOL, ATOL)
    assert bad.all()
    # The whole chunk: the program with every bias gradient rounded misses
    # the JAX kernel in the critic head's bias moment, where the program
    # with the kernel's rule meets it (test_program_matches_plain_chunk,
    # test_plain_chunk_matches_jax_kernel).
    want = run["kernel"][0].critic_opt.mu[-1]["b"]
    for round_bias in (False, True):
        flat, _, _ = _interpret_program(cfg, state, run["packed"], SCALE, OFFSET, None, OBS,
                                        ACT, round_bias=round_bias)
        got = fc.unflatten_state(torch.from_numpy(flat), state, K, K).critic_opt.mu[-1]["b"]
        _, bad = _diff(f"round_bias={round_bias}: critic_opt.mu[-1].b", got.numpy(), want,
                       RTOL, ATOL)
        assert bad.all() == round_bias


# --- the main path ---------------------------------------------------------------


def test_tiny_bf16_train_run(tmp_path):
    records = train_in_subprocess([
        "--compute_dtype=bfloat16", "--num_actors=1", "--actor_hidden=16,16",
        "--critic_hidden=16,16", "--batch_size=16", "--learner_chunk=4",
        "--replay_min_size=100", "--total_env_steps=300", "--eval_every=0",
        "--eval_episodes=1",
    ], tmp_path / "metrics.jsonl")
    final = records[-1]
    assert final["kind"] == "final" and final["compute_dtype"] == "bfloat16"
    assert final["chunks"] >= 1 and final["learner_steps"] == final["chunks"] * 4
    assert all(np.isfinite(final[k]) for k in (*METRIC_KEYS, "final_return"))
