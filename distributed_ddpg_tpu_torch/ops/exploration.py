"""One vectorized exploration step over E envs on the device.

Counterpart of distributed_ddpg_tpu/ops/exploration.py, shared by the two
on-device rollouts: the device-actor pool (actors/device_pool.py) and the
on-device monolith (ondevice.py). Per step, for E envs at once:

- exploration: per-env OU noise, a = clip(mu(s) + ou * scale, box), or
  under SAC a tanh-Gaussian sample of the policy (ops/losses.sac_sample;
  the OU state rides along untouched);
- the optional uniform-warmup override: where the caller's gate is open,
  uniform actions on the box;
- the vectorized env step with auto-reset (envs/vector_envs.py);
- the packed rows in types.pack_batch_np's column order, the discount
  gamma * (1 - terminated) (a time-limit truncation keeps bootstrapping);
- the OU state reset to its mean where an episode ended.

Random numbers: JAX splits its key four ways a step (next, ou, env,
uniform). The port takes one explicit torch.Generator on the envs' device
and draws, in this order, every step: (1) the noise normals [E, act] (OU's,
or SAC's standard normals), (2) the env's reset values [E, R]
(VectorPendulum.draw_reset), (3) with a warmup gate, the warmup uniforms
[E, act], whether or not the gate is open (so the stream does not depend
on it). `draws` (a StepDraws) replaces all three, so a test can pass the
reference's stream in.

On D data-parallel ranks with the envs sharded (actors/device_pool.py,
ondevice.py) a rank steps only its block of envs, but its generator is
seeded as a one-rank rollout's, and every step draws all three for ALL E
envs in that order, then keeps its block (`draw_step(num_envs=, envs=)`,
`slice_draws`). JAX draws E envs' numbers from one replicated key and
shards the result, so a sharded rollout is the one-device rollout; so
are the port's D ranks, bit for bit, at the cost of E x act extra normals
a step; the policy multiplies in fixed row tiles (models/mlp.py's
ROW_TILE) for the same reason.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from distributed_ddpg_tpu_torch.models.mlp import actor_apply, actor_gaussian_apply
from distributed_ddpg_tpu_torch.ops import losses


class StepDraws(NamedTuple):
    """One step's random numbers: `noise` [E, act] standard normals (OU's or
    SAC's), `reset` [E, R] the env's reset values, `uniform` [E, act]
    warmup actions already on the box (None without a warmup gate)."""

    noise: torch.Tensor
    reset: torch.Tensor
    uniform: Optional[torch.Tensor] = None


def slice_draws(d: StepDraws, envs: Optional[slice]) -> StepDraws:
    """A step's draws for the envs `envs` (a slice of the E; None: all)."""
    if envs is None:
        return d
    return StepDraws(d.noise[envs], d.reset[envs],
                     None if d.uniform is None else d.uniform[envs])


def draw_step(env, act_dim: int, generator: torch.Generator, low: torch.Tensor,
              high: torch.Tensor, warmup: bool, num_envs: Optional[int] = None,
              envs: Optional[slice] = None) -> StepDraws:
    """A step's draws from `generator`, in the documented order, for
    `num_envs` envs (env.num_envs by default), of which `envs` are kept (a
    rank's block of a sharded rollout; None: all)."""
    E = env.num_envs if num_envs is None else int(num_envs)
    noise = torch.randn((E, act_dim), generator=generator, device=low.device)
    reset = env.draw_reset(generator, E)
    uniform = None
    if warmup:
        u = torch.rand((E, act_dim), generator=generator, device=low.device)
        uniform = low + u * (high - low)
    return slice_draws(StepDraws(noise, reset, uniform), envs)


def vector_env_step(cfg, env, params, env_state, obs, ou, scale, offset, low, high,
                    draws: StepDraws, warmup_active: bool = False):
    """One exploration step over env.num_envs envs (see the module).
    `scale`, `offset`, `low` and `high` are [act] tensors on the envs'
    device; `warmup_active` is the caller's gate, a host bool (both
    callers know their step counts on the host). Returns (new_ou, action,
    out, rows) with `out` the env's StepOut and `rows` the packed f32
    [E, 2*obs+act+3] block."""
    E = env.num_envs
    with torch.no_grad():
        # The policy in fixed row tiles (models/mlp.py): a rank's block of
        # the envs acts as it would in the whole batch, bit for bit.
        if cfg.sac:
            mean, log_std = actor_gaussian_apply(params, obs, cfg.sac_log_std_min,
                                                 cfg.sac_log_std_max, row_tile=True)
            sampled, _ = losses.sac_sample(mean, log_std, draws.noise, scale, offset)
            action = torch.minimum(torch.maximum(sampled, low), high)
            new_ou = ou
        else:
            new_ou = (ou + cfg.ou_theta * (0.0 - ou) * cfg.ou_dt
                      + cfg.ou_sigma * math.sqrt(cfg.ou_dt) * draws.noise)
            action = actor_apply(params, obs, scale, offset, row_tile=True) + new_ou * scale
            action = torch.minimum(torch.maximum(action, low), high)
        if warmup_active:
            action = draws.uniform
        out = env.step(env_state, action, draws.reset)
        discount = cfg.gamma * (1.0 - out.terminated.to(torch.float32))
        rows = torch.cat([obs, action, out.reward[:, None], discount[:, None], out.boot_obs,
                          torch.ones((E, 1), dtype=torch.float32, device=obs.device)], dim=-1)
        new_ou = torch.where(out.done[:, None], 0.0, new_ou)
    return new_ou, action, out, rows
