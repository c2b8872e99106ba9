"""DDPG losses: the TD critic loss and the DPG actor loss.

Counterpart of distributed_ddpg_tpu/ops/losses.py:29-70 (critic_loss,
actor_loss). The D4PG, TD3 and SAC losses are not in this slice.
"""

from __future__ import annotations

import torch

from distributed_ddpg_tpu_torch.models.mlp import actor_apply, critic_apply
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
