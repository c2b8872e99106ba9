"""Ornstein-Uhlenbeck exploration noise, per worker, reset per episode.

A copy of distributed_ddpg_tpu/ops/noise.py (numpy, no framework).

dx = theta * (mu - x) * dt + sigma * sqrt(dt) * N(0, 1)
"""

from __future__ import annotations

import numpy as np


class OUNoise:
    def __init__(
        self,
        shape,
        theta: float = 0.15,
        sigma: float = 0.2,
        mu: float = 0.0,
        dt: float = 1.0,
        seed: int = 0,
    ):
        self.shape = tuple(np.atleast_1d(shape))
        self.theta = theta
        self.sigma = sigma
        self.mu = mu
        self.dt = dt
        self._rng = np.random.default_rng(seed)
        self.state = np.full(self.shape, mu, dtype=np.float32)

    def reset(self):
        self.state[...] = self.mu

    def __call__(self) -> np.ndarray:
        noise = self._rng.standard_normal(self.shape).astype(np.float32)
        self.state = (
            self.state
            + self.theta * (self.mu - self.state) * self.dt
            + self.sigma * np.sqrt(self.dt) * noise
        )
        return self.state
