"""DDPG, TD3, SAC and D4PG losses.

Counterpart of distributed_ddpg_tpu/ops/losses.py:29-143 (critic_loss,
actor_loss, td3_critic_loss, td3_actor_loss), :153-275 (sac_sample,
sac_critic_loss, sac_actor_loss, sac_target_entropy) and :287-369 (the
categorical support and projection, distributional_critic_loss and
distributional_actor_loss). The TD3 smoothing noise and SAC's standard
normals are inputs here, drawn by the caller: the JAX package draws them
inside the loss from a key, and the two frameworks' random streams differ,
so the tests pass the JAX draw in. `mm` is the matmul dtype of every
network apply: None (f32) or torch.bfloat16 (models/mlp.py::_dense), as
the JAX losses' `mm_dtype`. Every loss takes `action_insert_layer`, the
critic layer the action joins at; the DDPG, TD3 and SAC critic losses
take `l2`, the weight decay l2 * sum of w^2 over the critic's weight
leaves (both ensemble members), as the JAX losses do. The JAX D4PG loss
has no such term, so neither has this one. Under tensor parallelism every
loss takes `tp` (parallel/partition.TP: the actor's and the critic's
models/mlp.NetTP) and runs on the rank's shards; its value, td and every
whole output are the logical ones, the same on each rank of the model
group (the weight decay's sum of squares adds the shards' over the
group).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from distributed_ddpg_tpu_torch.models.mlp import (
    actor_apply,
    actor_gaussian_apply,
    critic_apply,
    critic_member,
    ensemble_critic_apply,
    sum_sq,
)
from distributed_ddpg_tpu_torch.types import Batch


def weight_decay(critic_params, l2: float, loss, tp=None):
    """loss + l2 * sum(w^2) over the critic's weight leaves (whole [2, ...]
    leaves for an ensemble); the loss itself when l2 is 0. With `tp` (the
    critic's NetTP) the logical tree's sum (models/mlp.sum_sq)."""
    if l2 <= 0.0:
        return loss
    return loss + l2 * sum_sq(critic_params, tp, keys=("w",))


def critic_loss(critic_params, target_actor_params, target_critic_params,
                batch: Batch, action_scale, action_offset=0.0, mm=None,
                action_insert_layer: int = 1, l2: float = 0.0, tp=None):
    """Weighted MSE TD loss against y = r + discount * Q'(s', mu'(s')),
    plus the weight decay. Returns (loss, td_errors[B])."""
    ail = action_insert_layer
    with torch.no_grad():
        next_action = actor_apply(
            target_actor_params, batch.next_obs, action_scale, action_offset, mm, tp and tp.actor
        )
        next_q = critic_apply(target_critic_params, batch.next_obs, next_action, mm, ail,
                              tp and tp.critic)
        y = batch.reward + batch.discount * next_q
    q = critic_apply(critic_params, batch.obs, batch.action, mm, ail, tp and tp.critic)
    td = y - q
    loss = torch.mean(batch.weight * torch.square(td))
    return weight_decay(critic_params, l2, loss, tp and tp.critic), td


def actor_loss(actor_params, critic_params, batch: Batch, action_scale,
               action_offset=0.0, mm=None, action_insert_layer: int = 1, tp=None):
    """DPG loss: -mean(Q(s, mu(s)))."""
    action = actor_apply(actor_params, batch.obs, action_scale, action_offset, mm, tp and tp.actor)
    q = critic_apply(critic_params, batch.obs, action, mm, action_insert_layer, tp and tp.critic)
    return -torch.mean(q)


def td3_critic_loss(critic_params, target_actor_params, target_critic_params,
                    batch: Batch, action_scale, eps=None, action_offset=0.0, mm=None,
                    action_insert_layer: int = 1, l2: float = 0.0, tp=None):
    """Clipped double-Q TD loss over a [2, ...] critic ensemble. `eps`
    ([B, act], already scaled and clipped to +-target_noise_clip) smooths
    the target action, which is then clipped to the action box; None means
    no smoothing. The loss is the MEAN over [2, B] of w * td^2, plus the
    weight decay over both members. Returns (loss, the ensemble-mean
    td[B])."""
    ail = action_insert_layer
    with torch.no_grad():
        next_action = actor_apply(
            target_actor_params, batch.next_obs, action_scale, action_offset, mm, tp and tp.actor
        )
        if eps is not None:
            next_action = torch.clamp(
                next_action + eps, action_offset - action_scale,
                action_offset + action_scale,
            )
        next_q = ensemble_critic_apply(target_critic_params, batch.next_obs, next_action,
                                       mm, ail, tp and tp.critic)
        y = batch.reward + batch.discount * torch.min(next_q, dim=0).values
    q = ensemble_critic_apply(critic_params, batch.obs, batch.action, mm, ail,
                              tp and tp.critic)   # [2, B]
    td = y[None, :] - q
    loss = torch.mean(batch.weight[None, :] * torch.square(td))
    return weight_decay(critic_params, l2, loss, tp and tp.critic), torch.mean(td, dim=0)


def td3_actor_loss(actor_params, critic_params, batch: Batch, action_scale,
                   action_offset=0.0, mm=None, action_insert_layer: int = 1, tp=None):
    """DPG loss through critic member 0 only (the TD3 convention)."""
    action = actor_apply(actor_params, batch.obs, action_scale, action_offset, mm, tp and tp.actor)
    return -torch.mean(critic_apply(critic_member(critic_params, 0), batch.obs, action, mm,
                                    action_insert_layer, tp and tp.critic))


# --- SAC ---------------------------------------------------------------------

TANH_EPS = 1e-6


def sac_sample(mean, log_std, normal, action_scale, action_offset=0.0):
    """Reparameterized tanh-Gaussian sample on the action box from the
    standard normal `normal` [B, act]. Returns (action [B, act],
    log_prob [B]): the Gaussian log-density of u = mean + std * normal,
    less the squash's log|d action / du| = log(scale * (1 - tanh(u)^2) +
    1e-6), summed over the action dims. Gradients flow through mean and
    log_std."""
    std = torch.exp(log_std)
    u = mean + std * normal
    tanh_u = torch.tanh(u)
    action = tanh_u * action_scale + action_offset
    gauss_lp = -0.5 * (torch.square((u - mean) / std) + 2.0 * log_std + math.log(2.0 * math.pi))
    squash = torch.log(action_scale * (1.0 - torch.square(tanh_u)) + TANH_EPS)
    return action, torch.sum(gauss_lp - squash, dim=-1)


def sac_critic_loss(critic_params, actor_params, target_critic_params, batch: Batch,
                    action_scale, normal, alpha, log_std_min: float, log_std_max: float,
                    action_offset=0.0, mm=None, action_insert_layer: int = 1,
                    l2: float = 0.0, tp=None):
    """Entropy-regularized clipped double-Q TD loss over the [2, ...]
    ensemble: y = r + discount * (min_i Q'_i(s', a') - alpha * log pi(a'|s')),
    a' ~ pi(.|s') from the ONLINE actor (SAC has no target actor) with the
    normal `normal`. Returns (the mean over [2, B] of w * td^2 plus the
    weight decay, the ensemble-mean td [B])."""
    ail = action_insert_layer
    with torch.no_grad():
        mean, log_std = actor_gaussian_apply(actor_params, batch.next_obs, log_std_min,
                                             log_std_max, mm, tp and tp.actor)
        next_action, next_lp = sac_sample(mean, log_std, normal, action_scale, action_offset)
        next_q = torch.min(
            ensemble_critic_apply(target_critic_params, batch.next_obs, next_action, mm, ail,
                                  tp and tp.critic),
            dim=0,
        ).values
        y = batch.reward + batch.discount * (next_q - alpha * next_lp)
    q = ensemble_critic_apply(critic_params, batch.obs, batch.action, mm, ail,
                              tp and tp.critic)   # [2, B]
    td = y[None, :] - q
    loss = torch.mean(batch.weight[None, :] * torch.square(td))
    return weight_decay(critic_params, l2, loss, tp and tp.critic), torch.mean(td, dim=0)


def sac_actor_loss(actor_params, critic_params, batch: Batch, action_scale, normal, alpha,
                   log_std_min: float, log_std_max: float, action_offset=0.0, mm=None,
                   action_insert_layer: int = 1, tp=None):
    """Reparameterized actor objective E[alpha * log pi(a|s) - min_i Q_i(s, a)]
    against the ensemble min (the 1812.05905 convention). Returns (loss,
    mean log-prob), the latter for the temperature's update."""
    mean, log_std = actor_gaussian_apply(actor_params, batch.obs, log_std_min, log_std_max, mm,
                                         tp and tp.actor)
    action, lp = sac_sample(mean, log_std, normal, action_scale, action_offset)
    # amin's gradient splits ties 0.5/0.5, as jnp.min's does (torch.min's
    # goes to one member).
    q = torch.amin(
        ensemble_critic_apply(critic_params, batch.obs, action, mm, action_insert_layer,
                              tp and tp.critic), dim=0)
    return torch.mean(alpha * lp - q), torch.mean(lp)


def sac_target_entropy(target_entropy: float, act_dim: int, action_scale) -> float:
    """The temperature's target as a Python float: an explicit
    target_entropy wins; nan means auto, -act_dim + sum(log scale) (the
    1812.05905 heuristic for unit-box log-probs, shifted because
    sac_sample's densities are in the env's action units)."""
    if not math.isnan(target_entropy):
        return float(target_entropy)
    scale = np.broadcast_to(np.asarray(action_scale, np.float64), (act_dim,))
    return -float(act_dim) + float(np.sum(np.log(scale)))


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
    # A true division, by a tensor, as JAX divides: on the card PyTorch
    # turns a division by a host scalar into a product with its reciprocal,
    # which can leave dz a rounding off JAX's.
    dz = (v_max - v_min) / support.new_full((), num_atoms - 1)
    tz = torch.clamp(rewards[:, None] + discounts[:, None] * support[None, :], v_min, v_max)
    b = (tz - v_min) / dz                 # fractional index, ~[0, A-1]
    lower, upper = torch.floor(b), torch.ceil(b)
    eq = (upper == lower).to(target_probs.dtype)
    w_lower = (upper - b) + eq            # mass to the lower atom
    w_upper = b - lower
    # A rounding can still put b past num_atoms - 1 at the top atom (v_max -
    # v_min = 50 + 7 * 2**-18 at 51 atoms gives b = 50 + 2**-18). The
    # indices are clamped, as JAX's gather clamps them, so both weights
    # land on the top atom and its mass stays 1.
    lo = torch.clamp(lower, 0, num_atoms - 1).long()
    up = torch.clamp(upper, 0, num_atoms - 1).long()
    onehot = torch.eye(num_atoms, dtype=target_probs.dtype, device=target_probs.device)
    proj = torch.einsum("ba,ba,baj->bj", target_probs, w_lower, onehot[lo])
    return proj + torch.einsum("ba,ba,baj->bj", target_probs, w_upper, onehot[up])


def distributional_critic_loss(critic_params, target_actor_params, target_critic_params,
                               batch: Batch, action_scale, support, action_offset=0.0,
                               mm=None, action_insert_layer: int = 1, tp=None):
    """Categorical TD loss: the weighted mean cross-entropy of the online
    logits against the projected target distribution. Returns (loss,
    E[Z_target] - E[Z] per row, the td proxy)."""
    ail = action_insert_layer
    with torch.no_grad():
        next_action = actor_apply(
            target_actor_params, batch.next_obs, action_scale, action_offset, mm, tp and tp.actor
        )
        target_probs = F.softmax(
            critic_apply(target_critic_params, batch.next_obs, next_action, mm, ail,
                         tp and tp.critic), dim=-1)
        proj = categorical_projection(support, target_probs, batch.reward, batch.discount)
    logits = critic_apply(critic_params, batch.obs, batch.action, mm, ail, tp and tp.critic)
    ce = -torch.sum(proj * F.log_softmax(logits, dim=-1), dim=-1)
    loss = torch.mean(batch.weight * ce)
    mean_q = torch.sum(F.softmax(logits, dim=-1) * support[None, :], dim=-1)
    mean_target = torch.sum(proj * support[None, :], dim=-1)
    return loss, mean_target - mean_q


def distributional_actor_loss(actor_params, critic_params, batch: Batch, action_scale,
                              support, action_offset=0.0, mm=None,
                              action_insert_layer: int = 1, tp=None):
    """-mean(E[Z(s, mu(s))]), E[Z] = sum_j softmax(logits)_j z_j."""
    action = actor_apply(actor_params, batch.obs, action_scale, action_offset, mm, tp and tp.actor)
    logits = critic_apply(critic_params, batch.obs, action, mm, action_insert_layer,
                          tp and tp.critic)
    return -torch.mean(torch.sum(F.softmax(logits, dim=-1) * support[None, :], dim=-1))
