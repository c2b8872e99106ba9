"""Environment registry.

A copy of distributed_ddpg_tpu/envs/registry.py. `make(env_id, seed)`
resolves, in order:

1. the built-in pure-numpy envs (no dependencies: Pendulum-v1 and
   MountainCarContinuous-v0, also under their `builtin/` ids), when
   `prefer_builtin` is set or gymnasium does not import;
2. gymnasium, when it imports (HalfCheetah, LunarLanderContinuous, ...),
   with a retired version bumped to its successor (_VERSION_ALIASES) and
   a built-in id falling back to the built-in if gymnasium refuses it.

So where gymnasium imports, `make("Pendulum-v1")` builds gymnasium's
Pendulum, as the JAX package's does; pass prefer_builtin=True for the
built-in.

Everything downstream (actors, replay, learner) only sees the EnvSpec and
the gymnasium 5-tuple step API.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from distributed_ddpg_tpu_torch.envs.mountain_car import MountainCarContinuous
from distributed_ddpg_tpu_torch.envs.pendulum import Pendulum

_BUILTIN = {
    "Pendulum-v1": Pendulum,
    "builtin/Pendulum-v1": Pendulum,
    "MountainCarContinuous-v0": MountainCarContinuous,
    "builtin/MountainCarContinuous-v0": MountainCarContinuous,
}

# Gymnasium retires env versions (DeprecatedEnv); a pinned id whose version
# is gone is bumped to its successor.
_VERSION_ALIASES = {
    "LunarLanderContinuous-v2": "LunarLanderContinuous-v3",
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


class _GymnasiumAdapter:
    """Wraps a gymnasium env: the first reset without a seed takes the
    constructor's, and the spec fields are read off its spaces."""

    def __init__(self, env_id: str, seed: int = 0):
        import gymnasium

        self._env = gymnasium.make(env_id)
        self._seed = seed
        self._first_reset = True

    def reset(self, seed: int | None = None):
        if seed is None and self._first_reset:
            seed = self._seed
        self._first_reset = False
        return self._env.reset(seed=seed)

    def step(self, action):
        return self._env.step(np.asarray(action, np.float32))

    @property
    def observation_dim(self) -> int:
        return int(np.prod(self._env.observation_space.shape))

    @property
    def action_dim(self) -> int:
        return int(np.prod(self._env.action_space.shape))

    @property
    def action_low(self) -> np.ndarray:
        return np.asarray(self._env.action_space.low, np.float32)

    @property
    def action_high(self) -> np.ndarray:
        return np.asarray(self._env.action_space.high, np.float32)

    def close(self):
        self._env.close()


def make(env_id: str, seed: int = 0, prefer_builtin: bool = False):
    if env_id in _BUILTIN and (prefer_builtin or not _has_gymnasium()):
        return _BUILTIN[env_id](seed=seed)
    if _has_gymnasium():
        try:
            return _GymnasiumAdapter(env_id, seed=seed)
        except Exception:
            if env_id in _VERSION_ALIASES:
                return _GymnasiumAdapter(_VERSION_ALIASES[env_id], seed=seed)
            if env_id in _BUILTIN:
                return _BUILTIN[env_id](seed=seed)
            raise
    if env_id in _BUILTIN:
        return _BUILTIN[env_id](seed=seed)
    raise ValueError(
        f"Unknown env {env_id!r}: not a builtin and gymnasium is unavailable"
    )


def _has_gymnasium() -> bool:
    try:
        import gymnasium  # noqa: F401

        return True
    except ImportError:
        return False


def spec_of(env) -> EnvSpec:
    return EnvSpec(
        obs_dim=int(env.observation_dim),
        act_dim=int(env.action_dim),
        action_low=np.asarray(env.action_low, np.float32),
        action_high=np.asarray(env.action_high, np.float32),
    )
