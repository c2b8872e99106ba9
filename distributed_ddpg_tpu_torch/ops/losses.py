"""DDPG, TD3 and D4PG losses.

Counterpart of distributed_ddpg_tpu/ops/losses.py:29-143 (critic_loss,
actor_loss, td3_critic_loss, td3_actor_loss) and :287-369 (the categorical
support and projection, distributional_critic_loss and
distributional_actor_loss). The SAC losses are not ported yet. The TD3
smoothing noise is an input here, drawn by the caller: the JAX package
draws it inside the loss from a key, and the two frameworks' random
streams differ, so the tests pass the JAX draw in.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distributed_ddpg_tpu_torch.models.mlp import (
    actor_apply,
    critic_apply,
    critic_member,
    ensemble_critic_apply,
)
from distributed_ddpg_tpu_torch.types import Batch


def critic_loss(critic_params, target_actor_params, target_critic_params,
                batch: Batch, action_scale, action_offset=0.0):
    """Weighted MSE TD loss against y = r + discount * Q'(s', mu'(s')).
    Returns (loss, td_errors[B])."""
    with torch.no_grad():
        next_action = actor_apply(
            target_actor_params, batch.next_obs, action_scale, action_offset
        )
        next_q = critic_apply(target_critic_params, batch.next_obs, next_action)
        y = batch.reward + batch.discount * next_q
    q = critic_apply(critic_params, batch.obs, batch.action)
    td = y - q
    loss = torch.mean(batch.weight * torch.square(td))
    return loss, td


def actor_loss(actor_params, critic_params, batch: Batch, action_scale,
               action_offset=0.0):
    """DPG loss: -mean(Q(s, mu(s)))."""
    action = actor_apply(actor_params, batch.obs, action_scale, action_offset)
    q = critic_apply(critic_params, batch.obs, action)
    return -torch.mean(q)


def td3_critic_loss(critic_params, target_actor_params, target_critic_params,
                    batch: Batch, action_scale, eps=None, action_offset=0.0):
    """Clipped double-Q TD loss over a [2, ...] critic ensemble. `eps`
    ([B, act], already scaled and clipped to +-target_noise_clip) smooths
    the target action, which is then clipped to the action box; None means
    no smoothing. The loss is the MEAN over [2, B] of w * td^2. Returns
    (loss, the ensemble-mean td[B])."""
    with torch.no_grad():
        next_action = actor_apply(
            target_actor_params, batch.next_obs, action_scale, action_offset
        )
        if eps is not None:
            next_action = torch.clamp(
                next_action + eps, action_offset - action_scale,
                action_offset + action_scale,
            )
        next_q = ensemble_critic_apply(target_critic_params, batch.next_obs, next_action)
        y = batch.reward + batch.discount * torch.min(next_q, dim=0).values
    q = ensemble_critic_apply(critic_params, batch.obs, batch.action)   # [2, B]
    td = y[None, :] - q
    loss = torch.mean(batch.weight[None, :] * torch.square(td))
    return loss, torch.mean(td, dim=0)


def td3_actor_loss(actor_params, critic_params, batch: Batch, action_scale,
                   action_offset=0.0):
    """DPG loss through critic member 0 only (the TD3 convention)."""
    action = actor_apply(actor_params, batch.obs, action_scale, action_offset)
    return -torch.mean(critic_apply(critic_member(critic_params, 0), batch.obs, action))


# --- distributional critic (D4PG) -------------------------------------------


def support_row(v_min: float, v_max: float, num_atoms: int) -> np.ndarray:
    """The C51 support z[num_atoms], computed in float64 and rounded once
    to float32 (the JAX package's f32 jnp.linspace lands within a few ulps
    of the bounds' magnitude of it)."""
    return np.linspace(float(v_min), float(v_max), int(num_atoms)).astype(np.float32)


def categorical_support(v_min: float, v_max: float, num_atoms: int, device="cpu"):
    return torch.from_numpy(support_row(v_min, v_max, num_atoms)).to(device)


def categorical_projection(support, target_probs, rewards, discounts):
    """Project the shifted target distribution back onto `support`, the
    scan path's way: floor/ceil neighbours, all the mass on the atom when
    the shifted point lands on one (the `eq` fix).

    support: f32[A]; target_probs: f32[B, A]; rewards, discounts: f32[B].
    Returns f32[B, A]."""
    v_min, v_max = support[0], support[-1]
    num_atoms = support.shape[0]
    dz = (v_max - v_min) / (num_atoms - 1)
    tz = torch.clamp(rewards[:, None] + discounts[:, None] * support[None, :], v_min, v_max)
    b = (tz - v_min) / dz                 # fractional index in [0, A-1]
    lower, upper = torch.floor(b), torch.ceil(b)
    eq = (upper == lower).to(target_probs.dtype)
    w_lower = (upper - b) + eq            # mass to the lower atom
    w_upper = b - lower
    onehot = torch.eye(num_atoms, dtype=target_probs.dtype, device=target_probs.device)
    proj = torch.einsum("ba,ba,baj->bj", target_probs, w_lower, onehot[lower.long()])
    return proj + torch.einsum("ba,ba,baj->bj", target_probs, w_upper, onehot[upper.long()])


def distributional_critic_loss(critic_params, target_actor_params, target_critic_params,
                               batch: Batch, action_scale, support, action_offset=0.0):
    """Categorical TD loss: the weighted mean cross-entropy of the online
    logits against the projected target distribution. Returns (loss,
    E[Z_target] - E[Z] per row, the td proxy)."""
    with torch.no_grad():
        next_action = actor_apply(
            target_actor_params, batch.next_obs, action_scale, action_offset
        )
        target_probs = F.softmax(
            critic_apply(target_critic_params, batch.next_obs, next_action), dim=-1)
        proj = categorical_projection(support, target_probs, batch.reward, batch.discount)
    logits = critic_apply(critic_params, batch.obs, batch.action)
    ce = -torch.sum(proj * F.log_softmax(logits, dim=-1), dim=-1)
    loss = torch.mean(batch.weight * ce)
    mean_q = torch.sum(F.softmax(logits, dim=-1) * support[None, :], dim=-1)
    mean_target = torch.sum(proj * support[None, :], dim=-1)
    return loss, mean_target - mean_q


def distributional_actor_loss(actor_params, critic_params, batch: Batch, action_scale,
                              support, action_offset=0.0):
    """-mean(E[Z(s, mu(s))]), E[Z] = sum_j softmax(logits)_j z_j."""
    action = actor_apply(actor_params, batch.obs, action_scale, action_offset)
    logits = critic_apply(critic_params, batch.obs, action)
    return -torch.mean(torch.sum(F.softmax(logits, dim=-1) * support[None, :], dim=-1))
