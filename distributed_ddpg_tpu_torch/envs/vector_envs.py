"""Vectorized environments on the device: E envs stepped as one batch of tensors.

Counterpart of distributed_ddpg_tpu/envs/jax_envs.py. Pendulum-v1 and
MountainCarContinuous-v0, equation for equation and constant for constant
(the built-in numpy envs, envs/pendulum.py and envs/mountain_car.py, are
the same dynamics one env at a time), batched over a leading E axis on an
explicit device, so the whole rollout (policy, noise, physics, the packed
rows) stays on the card (ops/exploration.py, actors/device_pool.py,
ondevice.py).

API (functional; the state is a NamedTuple of [E] tensors):

  env.init(fresh)             -> state from the reset values `fresh` [E, R]
  env.draw_reset(generator, n=None)
                              -> fresh reset values [n, R] (R = reset_width;
                                 n defaults to E: a rank of a sharded rollout
                                 draws the whole rollout's envs)
  env.step(state, u, fresh)   -> StepOut(state, obs, boot_obs, reward, done,
                                         terminated)
  env.observe(state)          -> obs [E, obs_dim]

Auto-reset: where an episode ends, `state` is already the reset state
(made from that env's row of `fresh`) and `obs` its first observation, what
the policy acts on next; `boot_obs` is the pre-reset next observation, the
bootstrap target of the stored transition. `terminated` (an absorbing state:
discount 0) is separate from `done` (which includes the time limit, where
bootstrapping goes on). As in the JAX envs, a step takes a fresh reset draw
for EVERY env and selects it with `where`, so a test can pass the JAX
stream's reset values in row for row. The reset values are the init
values themselves (Pendulum: theta, theta_dot; MountainCar: position),
drawn uniformly on the JAX init's ranges.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from distributed_ddpg_tpu_torch.devices import require_device


class StepOut(NamedTuple):
    state: object             # post-step state (the reset applied where done)
    obs: torch.Tensor         # [E, obs_dim] observation of `state` (policy input)
    boot_obs: torch.Tensor    # [E, obs_dim] pre-reset next observation (replay next_obs)
    reward: torch.Tensor      # f32 [E]
    done: torch.Tensor        # bool [E] episode boundary (time limit included)
    terminated: torch.Tensor  # bool [E] absorbing state: bootstrap discount 0


class PendulumState(NamedTuple):
    th: torch.Tensor          # f32 [E] angle
    thdot: torch.Tensor       # f32 [E] angular velocity
    t: torch.Tensor           # int32 [E] step in the episode


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    # A floor-mod, as jnp's `%` (and numpy's): torch.fmod would keep the
    # dividend's sign and map negative angles elsewhere.
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class VectorPendulum:
    """Pendulum-v1 over E envs (g=10, m=1, l=1, dt=0.05, max_torque=2,
    max_speed=8, a 200-step time limit; it only truncates)."""

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0
    max_episode_steps = 200

    obs_dim = 3
    act_dim = 1
    reset_width = 2
    action_low = np.array([-2.0], np.float32)
    action_high = np.array([2.0], np.float32)

    def __init__(self, num_envs: int, device="cuda"):
        self.num_envs = int(num_envs)
        self.device = require_device(device)
        self._high = torch.tensor([math.pi, 1.0], dtype=torch.float32, device=self.device)

    def draw_reset(self, generator: torch.Generator, n=None) -> torch.Tensor:
        """[n, 2] (theta, theta_dot) uniform on [-pi, pi] x [-1, 1] (n = E)."""
        n = self.num_envs if n is None else int(n)
        u = torch.rand((n, 2), generator=generator, device=self.device)
        return (2.0 * u - 1.0) * self._high

    def init(self, fresh: torch.Tensor) -> PendulumState:
        return PendulumState(th=fresh[:, 0].contiguous(), thdot=fresh[:, 1].contiguous(),
                             t=torch.zeros(self.num_envs, dtype=torch.int32,
                                           device=fresh.device))

    def observe(self, s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.th), torch.sin(s.th), s.thdot], dim=-1)

    def step(self, s: PendulumState, action: torch.Tensor, fresh: torch.Tensor) -> StepOut:
        u = torch.clamp(action.reshape(-1), -self.max_torque, self.max_torque)
        cost = _angle_normalize(s.th) ** 2 + 0.1 * s.thdot ** 2 + 0.001 * u ** 2
        newthdot = s.thdot + (
            3.0 * self.g / (2.0 * self.l) * torch.sin(s.th)
            + 3.0 / (self.m * self.l ** 2) * u
        ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = s.th + newthdot * self.dt
        t = s.t + 1
        done = t >= self.max_episode_steps
        stepped = PendulumState(th=newth, thdot=newthdot, t=t)
        nxt = PendulumState(
            th=torch.where(done, fresh[:, 0], newth),
            thdot=torch.where(done, fresh[:, 1], newthdot),
            t=torch.where(done, torch.zeros_like(t), t),
        )
        return StepOut(state=nxt, obs=self.observe(nxt), boot_obs=self.observe(stepped),
                       reward=-cost, done=done, terminated=torch.zeros_like(done))


class MountainCarState(NamedTuple):
    pos: torch.Tensor         # f32 [E] position
    vel: torch.Tensor         # f32 [E] velocity
    t: torch.Tensor           # int32 [E] step in the episode


class VectorMountainCar:
    """MountainCarContinuous-v0 over E envs (power 0.0015, gravity term
    0.0025 cos(3x), the goal at x >= 0.45 with vel >= 0 and a +100 terminal
    reward, -0.1 a^2 a step, a 999-step time limit). It truly terminates."""

    power = 0.0015
    gravity = 0.0025
    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07
    goal_position = 0.45
    goal_velocity = 0.0
    max_episode_steps = 999

    obs_dim = 2
    act_dim = 1
    reset_width = 1
    action_low = np.array([-1.0], np.float32)
    action_high = np.array([1.0], np.float32)

    def __init__(self, num_envs: int, device="cuda"):
        self.num_envs = int(num_envs)
        self.device = require_device(device)

    def draw_reset(self, generator: torch.Generator, n=None) -> torch.Tensor:
        """[n, 1] positions uniform on [-0.6, -0.4] (n = E)."""
        n = self.num_envs if n is None else int(n)
        u = torch.rand((n, 1), generator=generator, device=self.device)
        return u * 0.2 - 0.6

    def init(self, fresh: torch.Tensor) -> MountainCarState:
        zeros = torch.zeros(self.num_envs, dtype=torch.float32, device=fresh.device)
        return MountainCarState(pos=fresh[:, 0].contiguous(), vel=zeros,
                                t=torch.zeros(self.num_envs, dtype=torch.int32,
                                              device=fresh.device))

    def observe(self, s: MountainCarState) -> torch.Tensor:
        return torch.stack([s.pos, s.vel], dim=-1)

    def step(self, s: MountainCarState, action: torch.Tensor, fresh: torch.Tensor) -> StepOut:
        force = torch.clamp(action.reshape(-1), -1.0, 1.0)
        vel = s.vel + force * self.power - self.gravity * torch.cos(3.0 * s.pos)
        vel = torch.clamp(vel, -self.max_speed, self.max_speed)
        pos = torch.clamp(s.pos + vel, self.min_position, self.max_position)
        # The left wall stops the car: after the position's clip.
        vel = torch.where((pos <= self.min_position) & (vel < 0.0), 0.0, vel)
        t = s.t + 1
        terminated = (pos >= self.goal_position) & (vel >= self.goal_velocity)
        done = terminated | (t >= self.max_episode_steps)
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force ** 2
        stepped = MountainCarState(pos=pos, vel=vel, t=t)
        nxt = MountainCarState(
            pos=torch.where(done, fresh[:, 0], pos),
            vel=torch.where(done, 0.0, vel),
            t=torch.where(done, torch.zeros_like(t), t),
        )
        return StepOut(state=nxt, obs=self.observe(nxt), boot_obs=self.observe(stepped),
                       reward=reward, done=done, terminated=terminated)


_VECTOR_ENVS = {
    "Pendulum-v1": VectorPendulum,
    "builtin/Pendulum-v1": VectorPendulum,
    "MountainCarContinuous-v0": VectorMountainCar,
    "builtin/MountainCarContinuous-v0": VectorMountainCar,
}


def has_vector_env(env_id: str) -> bool:
    return env_id in _VECTOR_ENVS


def make_vector_env(env_id: str, num_envs: int, device="cuda"):
    if env_id not in _VECTOR_ENVS:
        raise ValueError(
            f"no on-device (JAX) implementation for {env_id!r}; available: "
            f"{sorted(set(_VECTOR_ENVS))} — use --backend=jax_tpu for CPU envs"
        )
    return _VECTOR_ENVS[env_id](num_envs, device)
