"""DDPG and TD3 losses.

Counterpart of distributed_ddpg_tpu/ops/losses.py:29-143 (critic_loss,
actor_loss, td3_critic_loss, td3_actor_loss). The D4PG and SAC losses are
not ported yet. The TD3 smoothing noise is an input here, drawn by the
caller: the JAX package draws it inside the loss from a key, and the two
frameworks' random streams differ, so the tests pass the JAX draw in.
"""

from __future__ import annotations

import torch

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
