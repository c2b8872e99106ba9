"""The DDPG and TD3 learner step, as an eager autograd step — the port's oracle.

Counterpart of distributed_ddpg_tpu/learner.py (the plain-DDPG and TD3
branches of make_learner_step). One step does:

  1. the critic TD update's gradient (TD3: both members of the [2, ...]
     ensemble against the min-over-ensemble target),
  2. the DPG actor gradient through the PRE-update critic (both gradients
     come from the same state, learner.py:347 of the JAX package; TD3:
     through critic member 0),
  3. Adam for both nets, critic first,
  4. Polyak target updates.

With TD3 and policy_delay > 1 the critic steps every call, while the
actor's Adam and BOTH Polyak updates run only when the pre-increment
`state.step % policy_delay == 0` (learner.py:364-416 of the JAX package):
actor_opt.count advances only then, and actor_grad_norm reads 0 on the
other steps. The smoothing noise is an input (`eps`), see ops/losses.py.

The training path runs K of these per dispatch inside the CUDA kernel
(ops/fused_chunk.py); this step is what the kernel and its plain version
are held against.

`train_state_from_numpy` / `train_state_to_numpy` carry weights across the
frameworks: the JAX TrainState, passed as numpy (`jax.tree.map(np.asarray,
s)`), becomes the port's state and back, [2, ...] ensemble leaves
included. Parity always starts from a state the JAX package made, because
the two frameworks' random streams differ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.models.mlp import actor_apply, actor_init, critic_init
from distributed_ddpg_tpu_torch.ops import losses
from distributed_ddpg_tpu_torch.ops.optim import adam_update, tree_leaves, tree_map
from distributed_ddpg_tpu_torch.ops.polyak import polyak_update
from distributed_ddpg_tpu_torch.types import Batch, OptState, TrainState


class StepOutput(NamedTuple):
    state: TrainState
    td_errors: torch.Tensor   # f32[B] (f32[K, B] for a chunk)
    metrics: dict             # METRIC_KEYS -> 0-d f32 tensors


# The exact keys and order of StepOutput.metrics; the kernel writes its
# chunk-mean metric vector in this order.
METRIC_KEYS = (
    "critic_loss",
    "actor_loss",
    "mean_q",
    "td_abs_mean",
    "critic_grad_norm",
    "actor_grad_norm",
)


def optree_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree_leaves(tree)))


def init_train_state(config: DDPGConfig, obs_dim: int, act_dim: int, seed: int,
                     device="cpu") -> TrainState:
    """Params, hard-copied targets and zero Adam state, from a seeded
    torch.Generator. The shapes and init bounds are the JAX package's;
    the numbers are not (the random streams differ). With twin_critic
    two independently drawn critics are stacked on a leading [2, ...]
    axis of every critic leaf, sharing one critic_opt (one count)."""
    gen = torch.Generator().manual_seed(int(seed))
    actor = actor_init(gen, obs_dim, act_dim, tuple(config.actor_hidden), device)
    critic = critic_init(gen, obs_dim, act_dim, tuple(config.critic_hidden), device)
    if config.twin_critic:
        second = critic_init(gen, obs_dim, act_dim, tuple(config.critic_hidden), device)
        critic = tree_map(lambda a, b: torch.stack([a, b]), critic, second)
    zeros = lambda t: tree_map(torch.zeros_like, t)  # noqa: E731
    count = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
    return TrainState(
        actor_params=actor,
        critic_params=critic,
        target_actor_params=tree_map(torch.clone, actor),
        target_critic_params=tree_map(torch.clone, critic),
        actor_opt=OptState(mu=zeros(actor), nu=zeros(actor), count=count()),
        critic_opt=OptState(mu=zeros(critic), nu=zeros(critic), count=count()),
        step=count(),
    )


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_learner_step(config: DDPGConfig, action_scale, action_offset=0.0):
    """Returns (state, batch, eps=None) -> StepOutput, one eager autograd
    step. `eps` is TD3's smoothing noise [B, act] (scaled and clipped), and
    is required exactly when twin_critic and target_noise > 0."""
    twin = bool(config.twin_critic)
    delay = int(config.policy_delay)   # 1 unless TD3 (config gate)

    def step(state: TrainState, batch: Batch, eps=None) -> StepOutput:
        config.check_noise(eps)
        device = batch.obs.device
        scale = _as_tensor(action_scale, device)
        offset = _as_tensor(action_offset, device)

        # --- critic gradient ---
        cp = tree_map(lambda x: x.detach().requires_grad_(True), state.critic_params)
        if twin:
            closs, td = losses.td3_critic_loss(
                cp, state.target_actor_params, state.target_critic_params,
                batch, scale, eps, offset,
            )
            actor_loss = losses.td3_actor_loss
        else:
            closs, td = losses.critic_loss(
                cp, state.target_actor_params, state.target_critic_params,
                batch, scale, offset,
            )
            actor_loss = losses.actor_loss
        cgrads = torch.autograd.grad(closs, tree_leaves(cp))

        # --- actor loss, through the pre-update critic; its gradient only
        # on update steps (every step unless TD3 delays it) ---
        ap = tree_map(lambda x: x.detach().requires_grad_(True), state.actor_params)
        aloss = actor_loss(ap, state.critic_params, batch, scale, offset)
        update = delay == 1 or int(state.step) % delay == 0
        agrads = torch.autograd.grad(aloss, tree_leaves(ap)) if update else None

        with torch.no_grad():
            cgrads = _untree(cgrads, state.critic_params)
            new_critic, critic_opt = adam_update(
                state.critic_params, cgrads, state.critic_opt, config.critic_lr
            )
            if update:
                agrads = _untree(agrads, state.actor_params)
                new_actor, actor_opt = adam_update(
                    state.actor_params, agrads, state.actor_opt, config.actor_lr
                )
                new_target_actor = polyak_update(
                    new_actor, state.target_actor_params, config.tau
                )
                new_target_critic = polyak_update(
                    new_critic, state.target_critic_params, config.tau
                )
                actor_grad_norm = optree_norm(agrads)
            else:
                new_actor, actor_opt = state.actor_params, state.actor_opt
                new_target_actor = state.target_actor_params
                new_target_critic = state.target_critic_params
                actor_grad_norm = torch.zeros((), dtype=torch.float32, device=device)
            closs, aloss, td = closs.detach(), aloss.detach(), td.detach()
            metrics = dict(
                zip(
                    METRIC_KEYS,
                    (
                        closs,
                        aloss,
                        -aloss,
                        torch.mean(torch.abs(td)),
                        optree_norm(cgrads),
                        actor_grad_norm,
                    ),
                )
            )
        new_state = TrainState(
            actor_params=new_actor,
            critic_params=new_critic,
            target_actor_params=new_target_actor,
            target_critic_params=new_target_critic,
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            step=state.step + 1,
        )
        return StepOutput(state=new_state, td_errors=td, metrics=metrics)

    return step


def _untree(leaves, like):
    it = iter(leaves)
    return tuple({k: next(it) for k in ("w", "b")} for _ in like)


def make_act_fn(config: DDPGConfig, action_scale, action_offset=0.0):
    """Deterministic policy mu(s) on the params' device."""

    @torch.no_grad()
    def act(actor_params, obs: torch.Tensor) -> torch.Tensor:
        device = obs.device
        return actor_apply(
            actor_params, obs, _as_tensor(action_scale, device),
            _as_tensor(action_offset, device),
        )

    return act


# --- weights across frameworks --------------------------------------------


def _params_from_numpy(tree, device):
    return tuple(
        {k: torch.tensor(np.asarray(layer[k], np.float32), device=device)
         for k in ("w", "b")}
        for layer in tree
    )


def _count_from_numpy(x, device):
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)


def train_state_from_numpy(tree, device="cpu") -> TrainState:
    """The JAX package's TrainState with numpy leaves (or any object with
    the same field names) -> the port's TrainState on `device`."""
    def opt(o):
        return OptState(
            mu=_params_from_numpy(o.mu, device),
            nu=_params_from_numpy(o.nu, device),
            count=_count_from_numpy(o.count, device),
        )

    return TrainState(
        actor_params=_params_from_numpy(tree.actor_params, device),
        critic_params=_params_from_numpy(tree.critic_params, device),
        target_actor_params=_params_from_numpy(tree.target_actor_params, device),
        target_critic_params=_params_from_numpy(tree.target_critic_params, device),
        actor_opt=opt(tree.actor_opt),
        critic_opt=opt(tree.critic_opt),
        step=_count_from_numpy(tree.step, device),
    )


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's TrainState -> the same structure with numpy leaves (the
    field names and leaf layouts of the JAX package's TrainState)."""
    def params(t):
        return tuple(
            {k: layer[k].detach().cpu().numpy() for k in ("w", "b")} for layer in t
        )

    def opt(o):
        return OptState(
            mu=params(o.mu), nu=params(o.nu),
            count=np.asarray(int(o.count), np.int32),
        )

    return TrainState(
        actor_params=params(state.actor_params),
        critic_params=params(state.critic_params),
        target_actor_params=params(state.target_actor_params),
        target_critic_params=params(state.target_critic_params),
        actor_opt=opt(state.actor_opt),
        critic_opt=opt(state.critic_opt),
        step=np.asarray(int(state.step), np.int32),
    )
