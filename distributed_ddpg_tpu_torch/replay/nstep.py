"""N-step return accumulator (D4PG, arXiv 1804.08617).

A copy of distributed_ddpg_tpu/replay/nstep.py (numpy, no framework).

Transforms a raw per-env stream of (obs, action, reward, done) into n-step
transitions (obs_t, a_t, sum_{k<n} gamma^k r_{t+k}, gamma^n * (1-done),
obs_{t+n}) before they enter replay, so the learner's TD target stays a
single fused multiply-add regardless of n. Handles episode truncation: on
`done`, all pending partial windows are flushed with their shortened returns.

Vectorized over a batch of envs (one accumulator drives a whole vector env).
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Tuple

import numpy as np


class NStepAccumulator:
    def __init__(self, n: int, gamma: float, num_envs: int = 1):
        self.n = int(n)
        self.gamma = float(gamma)
        self.num_envs = int(num_envs)
        # Per-env deque of (obs, action, reward) awaiting their bootstrap.
        self._pending = [deque() for _ in range(self.num_envs)]

    def push(
        self, obs, action, reward, done, next_obs
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, float, float, np.ndarray]]:
        """Feed one vector-env step; yields completed n-step transitions as
        (obs, action, n_step_reward, discount, bootstrap_obs)."""
        obs = np.atleast_2d(obs)
        action = np.atleast_2d(action)
        reward = np.atleast_1d(reward)
        done = np.atleast_1d(done)
        next_obs = np.atleast_2d(next_obs)
        for e in range(self.num_envs):
            pend = self._pending[e]
            pend.append((obs[e], action[e], float(reward[e])))
            if len(pend) == self.n:
                yield self._emit(pend, next_obs[e], terminal=bool(done[e]), length=self.n)
                pend.popleft()
            if done[e]:
                # Flush remaining partial windows with shortened horizons.
                while pend:
                    yield self._emit(pend, next_obs[e], terminal=True, length=len(pend))
                    pend.popleft()

    def _emit(self, pend, bootstrap_obs, terminal: bool, length: int):
        r = 0.0
        for k in range(length):
            r += (self.gamma ** k) * pend[k][2]
        discount = 0.0 if terminal else self.gamma ** length
        o, a, _ = pend[0]
        return o, a, np.float32(r), np.float32(discount), bootstrap_obs

    def reset(self) -> None:
        for p in self._pending:
            p.clear()
