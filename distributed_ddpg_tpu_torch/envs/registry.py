"""Environment registry.

A trimmed copy of distributed_ddpg_tpu/envs/registry.py: `make(env_id,
seed)` builds the built-in pure-numpy Pendulum-v1 (the main path; no
dependencies). The JAX package's gymnasium adapter for other ids comes
with a later slice.

Everything downstream (actors, replay, learner) only sees the EnvSpec and
the gymnasium 5-tuple step API.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from distributed_ddpg_tpu_torch.envs.pendulum import Pendulum

_BUILTIN = {
    "Pendulum-v1": Pendulum,
    "builtin/Pendulum-v1": Pendulum,
}


class EnvSpec(NamedTuple):
    obs_dim: int
    act_dim: int
    action_low: np.ndarray
    action_high: np.ndarray

    @property
    def action_scale(self) -> np.ndarray:
        """Half-width of the action box (the tanh output's scale)."""
        return ((self.action_high - self.action_low) / 2.0).astype(np.float32)

    @property
    def action_offset(self) -> np.ndarray:
        return ((self.action_high + self.action_low) / 2.0).astype(np.float32)


def make(env_id: str, seed: int = 0):
    if env_id not in _BUILTIN:
        raise ValueError(
            f"env_id={env_id!r} is not in the PyTorch port yet (built in: "
            f"{sorted(_BUILTIN)}); the gymnasium adapter comes with a later slice"
        )
    return _BUILTIN[env_id](seed=seed)


def spec_of(env) -> EnvSpec:
    return EnvSpec(
        obs_dim=int(env.observation_dim),
        act_dim=int(env.action_dim),
        action_low=np.asarray(env.action_low, np.float32),
        action_high=np.asarray(env.action_high, np.float32),
    )
