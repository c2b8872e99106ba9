"""Core state types and the packed-batch wire format.

Counterpart of distributed_ddpg_tpu/types.py. Field names and layouts are
the JAX package's, so the tests compare like with like:

- params are a tuple of {"w": [in, out], "b": [out]} dicts per layer;
- a minibatch crosses host->device as ONE packed [..., B, 2*obs+act+3] f32
  array with the fields in the fixed order obs | action | reward |
  discount | next_obs | weight.

Here the leaves are torch tensors (the numpy helpers stay numpy).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np


class Batch(NamedTuple):
    """A replay minibatch. `discount` already folds gamma^n * (1 - done),
    so the TD target is `r + discount * Q'(s', mu'(s'))`."""

    obs: Any          # f32[B, obs_dim]
    action: Any       # f32[B, act_dim]
    reward: Any       # f32[B]
    discount: Any     # f32[B]
    next_obs: Any     # f32[B, obs_dim]
    weight: Any       # f32[B] (ones for uniform replay)


class OptState(NamedTuple):
    """Adam state for one parameter tree."""

    mu: Any           # first moment, same tree as the params
    nu: Any           # second moment
    count: Any        # int32 scalar tensor: Adam steps taken


class TrainState(NamedTuple):
    """Everything the learner owns. log_alpha (an f32 scalar tensor) is set
    only under SAC, alpha_opt (an OptState of scalars) only when SAC
    autotunes its temperature; both are None otherwise, as in the JAX
    TrainState."""

    actor_params: Any
    critic_params: Any
    target_actor_params: Any
    target_critic_params: Any
    actor_opt: OptState
    critic_opt: OptState
    step: Any         # int32 scalar tensor
    log_alpha: Any = None   # SAC: f32 scalar tensor, log of the temperature
    alpha_opt: Any = None   # SAC with sac_autotune: OptState of scalars


def packed_width(obs_dim: int, act_dim: int) -> int:
    return 2 * obs_dim + act_dim + 3


def pack_batch_np(arrays: Dict[str, np.ndarray]) -> np.ndarray:
    """[..., B, field] dict -> [..., B, D] packed f32 array (host side)."""
    reward = np.asarray(arrays["reward"], np.float32)[..., None]
    discount = np.asarray(arrays["discount"], np.float32)[..., None]
    weight = arrays.get("weight")
    weight = (
        np.ones_like(reward)
        if weight is None
        else np.asarray(weight, np.float32)[..., None]
    )
    return np.concatenate(
        [arrays["obs"], arrays["action"], reward, discount, arrays["next_obs"], weight],
        axis=-1,
        dtype=np.float32,
    )


def unpack_batch(packed, obs_dim: int, act_dim: int) -> Batch:
    """Inverse of pack_batch_np: views (no copies) into a packed tensor."""
    o = obs_dim
    a = act_dim
    return Batch(
        obs=packed[..., :o],
        action=packed[..., o : o + a],
        reward=packed[..., o + a],
        discount=packed[..., o + a + 1],
        next_obs=packed[..., o + a + 2 : 2 * o + a + 2],
        weight=packed[..., 2 * o + a + 2],
    )
