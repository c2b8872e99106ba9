"""The port's route gate for the learner chunk kernel, on the CPU
(distributed_ddpg_tpu_torch/ops/fused_chunk.py).

- The gate: the port's own copy of the JAX kernel's VMEM gate
  (state_vmem_bytes, fits_vmem, VMEM_STATE_BUDGET) equals the JAX
  package's on a grid of configs, and the port's learner takes the kernel
  route exactly where the JAX learner does (supported and fits_vmem);
  fused_chunk='on' outside it raises with the JAX learner's message, and
  make_fused_chunk_fn with the JAX kernel's.
- The configs at the gate's edge run: at the widest uniform nets the gate
  admits and at a skewed one (the widest observation it admits into 2x48
  nets, most of the state in one layer), the learner takes the kernel route and
  the kernel's program, interpreted as in tests/test_torch_fused_chunk.py,
  matches the plain version over a 2-step chunk.
"""

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, init_train_state
from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

from test_torch_fused_chunk import (ATOL, METRIC_RTOL, RTOL, _batches, _close,
                                    _interpret_program)

torch.set_num_threads(1)

FAMILIES = {
    "ddpg": {},
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "c51-51": dict(distributional=True, num_atoms=51, v_min=-10.0, v_max=10.0),
    "c51-256": dict(distributional=True, num_atoms=256, v_min=-10.0, v_max=10.0),
    "sac": dict(sac=True),
}
WIDTHS = ((256, 256), (384, 384), (512, 512))
STEP_FRAC = 1e-3       # chip_smoke.py's TIGHT_FRAC
SHAPES = ((3, 1), (17, 6))


def _pair(family, hidden, **extra):
    common = dict(dict(actor_hidden=hidden, critic_hidden=hidden, batch_size=64,
                       **FAMILIES[family]), **extra)
    return JaxConfig(**common), DDPGConfig(device="cpu", **common)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gate_matches_jax(family):
    for hidden in WIDTHS:
        for obs, act in SHAPES:
            jcfg, cfg = _pair(family, hidden)
            assert fc.state_vmem_bytes(cfg, obs, act) == \
                jax_fused_chunk.state_vmem_bytes(jcfg, obs, act)
            assert fc.fits_vmem(cfg, obs, act) == jax_fused_chunk.fits_vmem(jcfg, obs, act)
    assert fc.VMEM_STATE_BUDGET == jax_fused_chunk.VMEM_STATE_BUDGET


@pytest.mark.parametrize("family", list(FAMILIES))
def test_route_matches_jax_rule(family):
    """'auto' takes the kernel exactly where JAX's rule (supported and
    fits_vmem) holds; 'on' raises outside it; the grid has configs on both
    sides (TD3 at 2x512, obs 17 / act 6: a 13,213,824-byte state)."""
    sides = set()
    for hidden in WIDTHS:
        for obs, act in SHAPES:
            jcfg, cfg = _pair(family, hidden)
            rule = (jax_fused_chunk.supported(jcfg)
                    and jax_fused_chunk.fits_vmem(jcfg, obs, act))
            sides.add(rule)
            learner = ShardedLearner(cfg, obs, act, 2.0, chunk_size=2)
            assert learner.fused_chunk_active == rule
            on = cfg.replace(fused_chunk="on")
            if rule:
                assert ShardedLearner(on, obs, act, 2.0, chunk_size=2).fused_chunk_active
            else:
                with pytest.raises(ValueError, match="small enough for VMEM"):
                    ShardedLearner(on, obs, act, 2.0, chunk_size=2)
                with pytest.raises(ValueError, match="VMEM-resident state would be"):
                    fc.make_fused_chunk_fn(cfg, obs, act, 2.0, chunk_size=2, device="cpu")
    assert sides == {True, False}


def _edge_width(family, obs, act, **extra):
    """The widest uniform 2-layer nets inside the gate, and their config."""
    lo, hi = 8, 2048
    while hi - lo > 1:
        mid = (lo + hi) // 2
        _, cfg = _pair(family, (mid, mid), **extra)
        lo, hi = (mid, hi) if fc.fits_vmem(cfg, obs, act) else (lo, mid)
    return lo, _pair(family, (lo, lo), **extra)[1]


def _program_matches_plain(cfg, obs, act):
    """A 2-step chunk at batch 4: the kernel route is taken, and the
    interpreted program agrees with the plain version."""
    assert ShardedLearner(cfg, obs, act, 2.0, chunk_size=2).fused_chunk_active
    prog = fc._plan(cfg, obs, act)
    state = init_train_state(cfg, obs, act, seed=3)
    packed = _batches(5, k=2, b=cfg.batch_size, obs=obs, act=act)
    eps, eps_np = None, None
    if cfg.twin_critic:
        eps = fc.td3_noise_eps(cfg, torch.Generator().manual_seed(7), 0, 2,
                               cfg.batch_size, act)
        eps_np = eps.numpy()
    elif cfg.sac:
        eps = fc.sac_noise_eps(cfg, torch.Generator().manual_seed(7), 0, 2,
                               cfg.batch_size, act)
        eps_np = tuple(e.numpy() for e in eps)
    flat, td, met = _interpret_program(cfg, state, packed, 2.0, 0.0, eps_np, obs, act)
    new, rtd, rmet = fc.fused_chunk_reference(cfg, state, torch.from_numpy(packed), 2.0,
                                              0.0, eps)
    # Adam divides by sqrt(v): where a gradient sits at the rounding level
    # of its sum, two summation orders take different steps of up to ~lr
    # (chip_smoke.py's STATE_TOL rule). So the state agrees at the strict
    # tolerance on all but a STEP_FRAC share of its elements, and within
    # K * lr everywhere; the moments, which carry the gradients, agree on
    # every element.
    ref = fc.flatten_state(new).numpy()
    lr = max(cfg.actor_lr, cfg.critic_lr)
    off = np.abs(flat - ref) > ATOL + RTOL * np.abs(ref)
    assert off.mean() <= STEP_FRAC, off.mean()
    _close(flat, ref, rtol=0.0, atol=2 * lr)
    moments = slice(2 * (prog.n_actor + prog.n_critic), 4 * (prog.n_actor + prog.n_critic))
    _close(flat[moments], ref[moments])
    _close(td, rtd.numpy())
    _close(met, torch.stack([rmet[k] for k in METRIC_KEYS]).numpy(), METRIC_RTOL, ATOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gate_edge_configs_run(family):
    """The widest uniform nets the gate admits (state within 2% of the
    6 MiB budget) at Pendulum shapes, and the widest observation it admits
    into 2x48 nets (2000-4000 wide), take the kernel route and run its
    program."""
    width, cfg = _edge_width(family, 3, 1, batch_size=4)
    assert fc.state_vmem_bytes(cfg, 3, 1) > 0.98 * fc.VMEM_STATE_BUDGET
    assert not fc.fits_vmem(_pair(family, (width + 1,) * 2, batch_size=4)[1], 3, 1)
    _program_matches_plain(cfg, 3, 1)
    _, skewed = _pair(family, (48, 48), batch_size=4)
    lo, hi = 1, 1 << 16          # the widest observation the gate admits
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fc.fits_vmem(skewed, mid, 1) else (lo, mid)
    assert lo > 1000
    _program_matches_plain(skewed, lo, 1)
