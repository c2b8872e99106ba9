"""Vectorized sum tree for prioritized replay on the host.

A copy of distributed_ddpg_tpu/replay/sum_tree.py (numpy, no framework).
An array-based complete binary tree (1-indexed; leaves at [cap, 2*cap)).
Every operation is batched numpy: the set-and-propagate and the
stratified descent run as O(log C) vector ops, never per-sample Python
loops. The C++ core with the same layout (native/replay_core.cpp,
native.NativeSumTree) draws the same indices; this is the always-available
fallback and its oracle.
"""

from __future__ import annotations

import numpy as np


class SumTree:
    def __init__(self, capacity: int):
        # Rounded up to a power of two, so every descent is as deep.
        self.capacity = 1 << (int(capacity) - 1).bit_length()
        self.depth = self.capacity.bit_length() - 1
        self.tree = np.zeros(2 * self.capacity, np.float64)

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def set(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        """Set leaf priorities and repair all ancestor sums (batched)."""
        indices = np.asarray(indices, np.int64)
        self.tree[self.capacity + indices] = np.asarray(priorities, np.float64)
        nodes = self.capacity + indices
        for _ in range(self.depth):
            nodes = np.unique(nodes >> 1)
            self.tree[nodes] = self.tree[2 * nodes] + self.tree[2 * nodes + 1]

    def get(self, indices: np.ndarray) -> np.ndarray:
        return self.tree[self.capacity + np.asarray(indices, np.int64)]

    def sample(self, values: np.ndarray) -> np.ndarray:
        """Descend the tree for each value in [0, total); returns leaf
        indices. Vectorized over the batch: one comparison a level."""
        v = np.asarray(values, np.float64).copy()
        idx = np.ones(v.shape, np.int64)
        for _ in range(self.depth):
            left = 2 * idx
            left_sum = self.tree[left]
            go_right = v >= left_sum
            v = np.where(go_right, v - left_sum, v)
            idx = np.where(go_right, left + 1, left)
        return idx - self.capacity

    def stratified_sample(self, batch_size: int, rng: np.random.Generator) -> np.ndarray:
        """PER's stratified scheme: one uniform draw per equal-mass segment."""
        bounds = np.linspace(0.0, self.total, batch_size + 1)
        u = rng.uniform(bounds[:-1], bounds[1:])
        # Keep fp roundoff from pushing a draw past `total`.
        u = np.minimum(u, np.nextafter(self.total, 0.0))
        return self.sample(u)
