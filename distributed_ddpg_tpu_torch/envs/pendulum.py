"""Built-in Pendulum environment with Pendulum-v1 dynamics.

A copy of distributed_ddpg_tpu/envs/pendulum.py (numpy, no framework).
Implements the exact classic-control equations (g=10, m=1, l=1, dt=0.05,
max_torque=2, max_speed=8, reward = -(th^2 + 0.1*thdot^2 + 0.001*u^2),
200-step time limit), so the port's main path needs no gymnasium.

Gymnasium-style API: reset(seed) -> (obs, info); step(a) -> (obs, reward,
terminated, truncated, info).
"""

from __future__ import annotations

import numpy as np


def _angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class Pendulum:
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0
    max_episode_steps = 200

    observation_dim = 3
    action_dim = 1
    action_low = np.array([-2.0], np.float32)
    action_high = np.array([2.0], np.float32)

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(2, np.float64)  # (theta, theta_dot)
        self._t = 0

    def _obs(self) -> np.ndarray:
        th, thdot = self._state
        return np.array([np.cos(th), np.sin(th), thdot], np.float32)

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self._state = self._rng.uniform(-high, high)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        th, thdot = self._state
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -self.max_torque, self.max_torque))
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (
            3.0 * self.g / (2.0 * self.l) * np.sin(th) + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        self._state = np.array([newth, newthdot])
        self._t += 1
        truncated = self._t >= self.max_episode_steps
        return self._obs(), -float(cost), False, truncated, {}

    def close(self):
        pass
