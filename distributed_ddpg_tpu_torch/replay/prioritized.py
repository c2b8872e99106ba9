"""Proportional prioritized replay on the host.

A copy of distributed_ddpg_tpu/replay/prioritized.py (numpy, no
framework): Schaul et al.'s proportional PER over UniformReplay's arrays.
Priorities p_i = (|td_i| + eps)^alpha live in a sum tree (the C++ core,
native.NativeSumTree, when it builds, else replay/sum_tree.SumTree: the
same draws), drawn stratified; importance weights w_i = (N * P(i))^-beta
over their max. beta anneals on the host through `set_beta`.

New rows enter at the running max priority, so each is drawn at least
once. The learner's td comes back to the host after each chunk and
`update_priorities` writes it: the one device-to-host copy PER costs on
this path. The device sibling is replay/device.DevicePrioritizedReplay.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from distributed_ddpg_tpu_torch.replay.uniform import UniformReplay


class PrioritizedReplay(UniformReplay):
    def __init__(
        self,
        capacity: int,
        obs_dim: int,
        act_dim: int,
        alpha: float = 0.6,
        beta: float = 0.4,
        eps: float = 1e-6,
        seed: int = 0,
    ):
        super().__init__(capacity, obs_dim, act_dim, seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        # Imported here: native imports replay.sum_tree, so a module-level
        # import would close an import cycle when native comes first.
        from distributed_ddpg_tpu_torch.native import make_sum_tree

        self._tree = make_sum_tree(capacity)   # the C++ core, else numpy
        self._max_priority = 1.0

    @property
    def max_priority(self) -> float:
        return self._max_priority

    def set_beta(self, beta: float) -> None:
        self.beta = float(beta)

    def add_batch(self, obs, action, reward, discount, next_obs) -> np.ndarray:
        idx = super().add_batch(obs, action, reward, discount, next_obs)
        self._tree.set(idx, np.full(len(idx), self._max_priority))
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._tree.stratified_sample(batch_size, self._rng)
        # Ring slots past the fill hold no mass; clip anyway.
        idx = np.minimum(idx, self._size - 1)
        out = self.gather(idx)
        prios = self._tree.get(idx)
        probs = prios / max(self._tree.total, 1e-12)
        weights = (self._size * probs) ** (-self.beta)
        weights /= weights.max()
        out["weight"] = weights.astype(np.float32)
        out["indices"] = idx
        return out

    def update_priorities(self, indices, td_errors) -> None:
        prios = (np.abs(np.asarray(td_errors, np.float64)) + self.eps) ** self.alpha
        self._tree.set(np.asarray(indices), prios)
        self._max_priority = max(self._max_priority, float(prios.max(initial=0.0)))

    # --- checkpoint support ---

    def state_dict(self):
        state = super().state_dict()
        state["priorities"] = self._tree.get(np.arange(self._size)).copy()
        state["max_priority"] = np.asarray(self._max_priority)
        return state

    def load_state_dict(self, state) -> None:
        super().load_state_dict(state)
        if "priorities" in state:
            # The whole tree rebuilt, not overlaid: a restore to a smaller
            # fill than the live buffer's (a rollback) must zero the mass of
            # every slot past the restored size, or the draw would keep
            # finding rows the restored state never held.
            prios = np.zeros(self.capacity, np.float64)
            prios[: self._size] = state["priorities"]
            self._tree.set(np.arange(self.capacity), prios)
            self._max_priority = float(state["max_priority"])
