"""Built-in MountainCarContinuous environment (MountainCarContinuous-v0 dynamics).

A copy of distributed_ddpg_tpu/envs/mountain_car.py (numpy, no framework):
gymnasium's continuous_mountain_car equations (power=0.0015, gravity term
0.0025*cos(3x), goal at x>=0.45 with vel>=0, +100 terminal reward,
-0.1*a^2 per-step action cost, 999-step time limit), so the second
built-in env -- the first whose episodes truly terminate, where Pendulum
only truncates -- runs with no dependencies.

Gymnasium-style API: reset(seed) -> (obs, info); step(a) -> (obs, reward,
terminated, truncated, info).
"""

from __future__ import annotations

import numpy as np


class MountainCarContinuous:
    power = 0.0015
    gravity = 0.0025
    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07
    goal_position = 0.45
    goal_velocity = 0.0
    max_episode_steps = 999

    observation_dim = 2
    action_dim = 1
    action_low = np.array([-1.0], np.float32)
    action_high = np.array([1.0], np.float32)

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._pos = 0.0
        self._vel = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.array([self._pos, self._vel], np.float32)

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = float(self._rng.uniform(-0.6, -0.4))
        self._vel = 0.0
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        force = float(np.clip(np.asarray(action).reshape(-1)[0], -1.0, 1.0))
        self._vel += force * self.power - self.gravity * np.cos(3.0 * self._pos)
        self._vel = float(np.clip(self._vel, -self.max_speed, self.max_speed))
        self._pos = float(
            np.clip(self._pos + self._vel, self.min_position, self.max_position)
        )
        if self._pos <= self.min_position and self._vel < 0.0:
            self._vel = 0.0
        self._t += 1
        terminated = (
            self._pos >= self.goal_position and self._vel >= self.goal_velocity
        )
        truncated = not terminated and self._t >= self.max_episode_steps
        reward = (100.0 if terminated else 0.0) - 0.1 * force**2
        return self._obs(), reward, terminated, truncated, {}

    def close(self):
        pass
