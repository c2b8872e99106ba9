"""The DDPG learner step, as an eager autograd step — the port's oracle.

Counterpart of distributed_ddpg_tpu/learner.py (the plain-DDPG branch of
make_learner_step). One step does:

  1. the critic TD update's gradient,
  2. the DPG actor gradient through the PRE-update critic (both gradients
     come from the same state, learner.py:347 of the JAX package),
  3. Adam for both nets, critic first,
  4. Polyak target updates.

The training path runs K of these per dispatch inside the CUDA kernel
(ops/fused_chunk.py); this step is what the kernel and its plain version
are held against.

`train_state_from_numpy` / `train_state_to_numpy` carry weights across the
frameworks: the JAX TrainState, passed as numpy (`jax.tree.map(np.asarray,
s)`), becomes the port's state and back. Parity always starts from a state
the JAX package made, because the two frameworks' random streams differ.
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
    the numbers are not (the random streams differ)."""
    gen = torch.Generator().manual_seed(int(seed))
    actor = actor_init(gen, obs_dim, act_dim, tuple(config.actor_hidden), device)
    critic = critic_init(gen, obs_dim, act_dim, tuple(config.critic_hidden), device)
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
    """Returns (state, batch) -> StepOutput, one eager autograd step."""

    def step(state: TrainState, batch: Batch) -> StepOutput:
        device = batch.obs.device
        scale = _as_tensor(action_scale, device)
        offset = _as_tensor(action_offset, device)

        # --- critic gradient ---
        cp = tree_map(lambda x: x.detach().requires_grad_(True), state.critic_params)
        closs, td = losses.critic_loss(
            cp, state.target_actor_params, state.target_critic_params,
            batch, scale, offset,
        )
        cgrads = torch.autograd.grad(closs, tree_leaves(cp))

        # --- actor gradient, through the pre-update critic ---
        ap = tree_map(lambda x: x.detach().requires_grad_(True), state.actor_params)
        aloss = losses.actor_loss(ap, state.critic_params, batch, scale, offset)
        agrads = torch.autograd.grad(aloss, tree_leaves(ap))

        with torch.no_grad():
            cgrads = _untree(cgrads, state.critic_params)
            agrads = _untree(agrads, state.actor_params)
            new_critic, critic_opt = adam_update(
                state.critic_params, cgrads, state.critic_opt, config.critic_lr
            )
            new_actor, actor_opt = adam_update(
                state.actor_params, agrads, state.actor_opt, config.actor_lr
            )
            new_target_actor = polyak_update(
                new_actor, state.target_actor_params, config.tau
            )
            new_target_critic = polyak_update(
                new_critic, state.target_critic_params, config.tau
            )
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
                        optree_norm(agrads),
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
