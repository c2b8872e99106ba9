"""Uniform host replay: a structure-of-arrays numpy ring buffer.

A copy of distributed_ddpg_tpu/replay/uniform.py (numpy, no framework),
trimmed to what the port uses: the host-replay path of train.py (with the
chunk prefetcher, parallel/prefetch.py), DDPGAgent and the native backend.

- Preallocated contiguous arrays, one a field: `sample` is one fancy-index
  gather a field, already laid out for the packed wire format
  (types.pack_batch_np), with no per-sample Python.
- It stores `discount = gamma^n * (1 - done)` as the n-step accumulator
  folds it, so the learner's TD target is one multiply-add.
- `state_dict()`/`load_state_dict()` make the buffer checkpointable under
  the JAX package's keys.
- Its index draws come from a numpy generator seeded with `seed`, so the
  port draws the indices the JAX package draws from the same seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class UniformReplay:
    def __init__(self, capacity: int, obs_dim: int, act_dim: int, seed: int = 0):
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.action = np.zeros((capacity, act_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.discount = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self._ptr = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def reward_sample(self, max_n: int = 100_000):
        """(reward, discount) columns of up to max_n rows, for the C51
        auto support (ops/support_auto.py; discount 0 marks the terminal
        rows). A ring fuller than max_n is read at an even stride over its
        live rows, not as a stale prefix (a fixed stride, so strict-sync
        runs and replicas see the same rows)."""
        n = min(self._size, max_n)
        if n == self._size:
            return self.reward[:n].copy(), self.discount[:n].copy()
        idx = np.linspace(0, self._size - 1, n).astype(np.int64)
        return self.reward[idx], self.discount[idx]

    def add_batch(self, obs, action, reward, discount, next_obs) -> np.ndarray:
        """Insert B transitions; returns the slots written (PER stamps them)."""
        obs = np.atleast_2d(obs)
        b = obs.shape[0]
        idx = (self._ptr + np.arange(b)) % self.capacity
        self.obs[idx] = obs
        self.action[idx] = np.atleast_2d(action)
        self.reward[idx] = np.asarray(reward, np.float32).reshape(b)
        self.discount[idx] = np.asarray(discount, np.float32).reshape(b)
        self.next_obs[idx] = np.atleast_2d(next_obs)
        self._ptr = int((self._ptr + b) % self.capacity)
        self._size = int(min(self._size + b, self.capacity))
        return idx

    def add(self, obs, action, reward, discount, next_obs) -> int:
        return int(self.add_batch(obs[None], action[None], [reward], [discount],
                                  next_obs[None])[0])

    def sample_indices(self, batch_size: int) -> np.ndarray:
        return self._rng.integers(0, self._size, size=batch_size)

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
            "discount": self.discount[idx],
            "next_obs": self.next_obs[idx],
            "weight": np.ones(len(idx), np.float32),
        }

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.sample_indices(batch_size)
        out = self.gather(idx)
        out["indices"] = idx
        return out

    def update_priorities(self, indices, td_errors) -> None:
        """Nothing to do for uniform replay (PER's interface)."""

    # --- checkpoint support ---

    def state_dict(self) -> Dict[str, np.ndarray]:
        n = self._size
        return {
            "obs": self.obs[:n].copy(),
            "action": self.action[:n].copy(),
            "reward": self.reward[:n].copy(),
            "discount": self.discount[:n].copy(),
            "next_obs": self.next_obs[:n].copy(),
            "ptr": np.asarray(self._ptr),
            "size": np.asarray(self._size),
        }

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        n = int(state["size"])
        if n > self.capacity:
            raise ValueError(f"checkpointed size {n} exceeds capacity {self.capacity}")
        self.obs[:n] = state["obs"]
        self.action[:n] = state["action"]
        self.reward[:n] = state["reward"]
        self.discount[:n] = state["discount"]
        self.next_obs[:n] = state["next_obs"]
        self._ptr = int(state["ptr"]) % self.capacity
        self._size = n
