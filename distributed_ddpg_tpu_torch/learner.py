"""The DDPG, TD3, SAC and D4PG learner step, as an eager autograd step — the port's oracle.

Counterpart of distributed_ddpg_tpu/learner.py (the plain-DDPG, TD3 and
D4PG branches of make_learner_step, and its sac_step). One step does:

  1. the critic TD update's gradient (TD3: both members of the [2, ...]
     ensemble against the min-over-ensemble target; D4PG: the
     cross-entropy against the projected target distribution, whose td is
     E[Z_target] - E[Z]),
  2. the DPG actor gradient through the PRE-update critic (both gradients
     come from the same state, learner.py:347 of the JAX package; TD3:
     through critic member 0),
  3. Adam for both nets, critic first,
  4. Polyak target updates.

With TD3 and policy_delay > 1 the critic steps every call, while the
actor's Adam and BOTH Polyak updates run only when the pre-increment
`state.step % policy_delay == 0` (learner.py:364-416 of the JAX package):
actor_opt.count advances only then, and actor_grad_norm reads 0 on the
other steps. The step's index can come from the host (`step_index`), so
that a chunk of steps on the card never reads the count back. The
smoothing noise is an input (`eps`), see ops/losses.py.

With fused_update (DDPG and D4PG; learner.py:417-430 of the JAX package)
Adam and Polyak of each net run as one launch of the fused kernel
(ops/fused_update.py), the critic's first. Every loss takes the config's
action_insert_layer, and the DDPG, TD3 and SAC critic losses its
critic_l2 weight decay.

SAC (`sac_step`, learner.py:181-281 of the JAX package) takes its two
standard-normal streams as inputs, eps = (normal_next, normal_cur): the
critic's target draws a' from the ONLINE actor on next_obs with the
first, the actor's loss draws a on obs with the second, against the
pre-update critics. Both targets trail by Polyak every step (the target
actor's slot too, though SAC's math never reads it), and with
sac_autotune log_alpha takes an Adam step at critic_lr on its own count
from the exact gradient -(mean log-prob + target entropy).

With compute_dtype='bfloat16' every network apply takes `mm` =
torch.bfloat16 (learner.py:159 of the JAX package): bf16-rounded matmul
operands with f32 accumulation, and autodiff's rounding of the weight and
input gradients (models/mlp.py::_Bf16Dense). The CUDA kernel and its plain
version round elsewhere (ops/fused_chunk.py), as the JAX kernel does.
make_act_fn stays f32, as the JAX package's does.

The training path runs K of these per dispatch inside the CUDA chunk
kernel (ops/fused_chunk.py) when the config is in its envelope, else
as K of these steps, the scan route (parallel/learner.py); this step is
what the kernel and its plain version are held against. The step builds
its constants (action scale and offset, the C51 support) on the device
once, so a step on the card copies nothing from the host.

With a data-parallel group (parallel/mesh.py) each rank runs the step on
its own rows, and one collective a step averages what the JAX step's
`_maybe_psum_mean` averages (learner.py:203-270 and :345-462 of the JAX
package): the critic's and (on update steps) the actor's gradients before
the norms and Adam, SAC's mean log-prob before the temperature's
gradient, and the critic loss, actor loss and mean |td| of the metrics;
the gradient norms are then those of the averaged gradients, the same on
every rank. td_errors stay the rank's own rows.

`train_state_from_numpy` / `train_state_to_numpy` carry weights across the
frameworks: the JAX TrainState, passed as numpy (`jax.tree.map(np.asarray,
s)`), becomes the port's state and back, [2, ...] ensemble leaves
included. Parity always starts from a state the JAX package made, because
the two frameworks' random streams differ. `train_state_to_flat` /
`train_state_from_flat` are the same leaves keyed by their path in the
tree, the layout of a checkpoint's state.npz (checkpoint.py).
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from distributed_ddpg_tpu_torch.actors.policy import actor_head_dim
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.models.mlp import (
    actor_apply,
    actor_gaussian_apply,
    actor_init,
    critic_init,
)
from distributed_ddpg_tpu_torch.ops import losses
from distributed_ddpg_tpu_torch.ops.fused_update import fused_adam_polyak
from distributed_ddpg_tpu_torch.ops.optim import adam_update, tree_leaves, tree_map
from distributed_ddpg_tpu_torch.ops.polyak import polyak_update
from distributed_ddpg_tpu_torch.parallel.mesh import all_reduce_mean_
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
    the numbers are not (the random streams differ). With twin_critic or
    sac two independently drawn critics are stacked on a leading [2, ...]
    axis of every critic leaf, sharing one critic_opt (one count). Under
    D4PG the critic's head has num_atoms outputs; under SAC the actor's
    head is [mean | log_std] (2 * act_dim), log_alpha starts at
    log(sac_alpha) and alpha_opt (with sac_autotune) at zero."""
    gen = torch.Generator().manual_seed(int(seed))
    heads = config.num_atoms if config.distributional else 1
    ail = config.action_insert_layer
    actor = actor_init(gen, obs_dim, actor_head_dim(act_dim, config.sac),
                       tuple(config.actor_hidden), device)
    critic = critic_init(gen, obs_dim, act_dim, tuple(config.critic_hidden), device, heads,
                         ail)
    if config.twin_critic or config.sac:
        second = critic_init(gen, obs_dim, act_dim, tuple(config.critic_hidden), device,
                             heads, ail)
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
        log_alpha=(
            torch.log(torch.tensor(config.sac_alpha, dtype=torch.float32, device=device))
            if config.sac else None
        ),
        alpha_opt=(
            OptState(mu=torch.zeros((), device=device), nu=torch.zeros((), device=device),
                     count=count())
            if config.sac and config.sac_autotune else None
        ),
    )


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _mm_dtype(config: DDPGConfig):
    """The matmul operand dtype of the learner step: bf16 or None (f32)."""
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else None


def _device_constants(action_scale, action_offset, config: DDPGConfig):
    """Returns device -> (scale, offset, C51 support or None), each built on
    that device at its first use and kept: a copy from the host waits for
    the card, so a step must not make one."""
    cache = {}

    def get(device):
        key = str(device)
        if key not in cache:
            support = (losses.categorical_support(config.v_min, config.v_max,
                                                  config.num_atoms, device)
                       if config.distributional else None)
            cache[key] = (_as_tensor(action_scale, device), _as_tensor(action_offset, device),
                          support)
        return cache[key]

    return get


def make_sac_step(config: DDPGConfig, action_scale, action_offset=0.0, group=None):
    """Returns (state, batch, eps, step_index=None) -> StepOutput, one eager
    SAC step; eps = (normal_next, normal_cur), two standard-normal [B, act]
    draws. SAC has no delay, so step_index is not read. With `group`, the
    gradients, mean log-prob and losses are averaged over its ranks."""
    lo, hi = config.sac_log_std_min, config.sac_log_std_max
    mm = _mm_dtype(config)
    ail, l2 = config.action_insert_layer, config.critic_l2
    constants = _device_constants(action_scale, action_offset, config)

    def sac_step(state: TrainState, batch: Batch, eps, step_index=None) -> StepOutput:
        config.check_noise(eps)
        normal_next, normal_cur = eps
        scale, offset, _ = constants(batch.obs.device)
        alpha = torch.exp(state.log_alpha)

        cp = tree_map(lambda x: x.detach().requires_grad_(True), state.critic_params)
        closs, td = losses.sac_critic_loss(
            cp, state.actor_params, state.target_critic_params, batch, scale,
            normal_next, alpha, lo, hi, offset, mm, ail, l2)
        cgrads = _untree(torch.autograd.grad(closs, tree_leaves(cp)), state.critic_params)
        # The actor's gradient against the pre-update critics.
        ap = tree_map(lambda x: x.detach().requires_grad_(True), state.actor_params)
        aloss, mean_lp = losses.sac_actor_loss(
            ap, state.critic_params, batch, scale, normal_cur, alpha, lo, hi, offset, mm, ail)
        agrads = _untree(torch.autograd.grad(aloss, tree_leaves(ap)), state.actor_params)

        with torch.no_grad():
            closs, aloss, mean_lp, td = (x.detach() for x in (closs, aloss, mean_lp, td))
            td_abs = torch.mean(torch.abs(td))
            if group is not None:
                all_reduce_mean_([*tree_leaves(cgrads), *tree_leaves(agrads), mean_lp,
                                  closs, aloss, td_abs], group)
            new_critic, critic_opt = adam_update(
                state.critic_params, cgrads, state.critic_opt, config.critic_lr)
            new_actor, actor_opt = adam_update(
                state.actor_params, agrads, state.actor_opt, config.actor_lr)
            new_target_critic = polyak_update(new_critic, state.target_critic_params, config.tau)
            new_target_actor = polyak_update(new_actor, state.target_actor_params, config.tau)
            if config.sac_autotune:
                # J(log_alpha) = -log_alpha * (E[log pi] + target_H): the
                # exact scalar gradient, Adam at critic_lr.
                tgt_h = losses.sac_target_entropy(
                    config.target_entropy, batch.action.shape[-1], action_scale)
                log_alpha, alpha_opt = adam_update(
                    state.log_alpha, -(mean_lp + tgt_h), state.alpha_opt, config.critic_lr)
            else:
                log_alpha, alpha_opt = state.log_alpha, state.alpha_opt
            metrics = dict(zip(METRIC_KEYS, (
                closs,
                aloss,
                alpha * mean_lp - aloss,     # = E[min Q], exactly as the JAX step
                td_abs,
                optree_norm(cgrads),
                optree_norm(agrads),
            )))
        new_state = TrainState(
            actor_params=new_actor,
            critic_params=new_critic,
            target_actor_params=new_target_actor,
            target_critic_params=new_target_critic,
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            step=state.step + 1,
            log_alpha=log_alpha,
            alpha_opt=alpha_opt,
        )
        return StepOutput(state=new_state, td_errors=td, metrics=metrics)

    return sac_step


def make_learner_step(config: DDPGConfig, action_scale, action_offset=0.0, group=None):
    """Returns (state, batch, eps=None, step_index=None) -> StepOutput, one
    eager autograd step. `eps` is TD3's smoothing noise [B, act] (scaled
    and clipped), and is required exactly when twin_critic and
    target_noise > 0; under SAC it is the pair of normals make_sac_step
    takes. `step_index` is state.step as a host int, for TD3's delay test
    (else the step reads state.step back from its device). With `group`
    (parallel/mesh.DataGroup) the gradients and loss metrics are averaged
    over its ranks, one collective a step; without one, nothing is."""
    if config.sac:
        return make_sac_step(config, action_scale, action_offset, group)
    twin = bool(config.twin_critic)
    delay = int(config.policy_delay)   # 1 unless TD3 (config gate)
    mm = _mm_dtype(config)
    ail, l2 = config.action_insert_layer, config.critic_l2
    constants = _device_constants(action_scale, action_offset, config)

    def step(state: TrainState, batch: Batch, eps=None, step_index=None) -> StepOutput:
        config.check_noise(eps)
        device = batch.obs.device
        scale, offset, support = constants(device)

        # --- critic gradient ---
        cp = tree_map(lambda x: x.detach().requires_grad_(True), state.critic_params)
        if config.distributional:
            closs, td = losses.distributional_critic_loss(
                cp, state.target_actor_params, state.target_critic_params,
                batch, scale, support, offset, mm, ail,
            )

            def actor_loss(ap, critic, batch, scale, offset, mm, ail):
                return losses.distributional_actor_loss(ap, critic, batch, scale, support,
                                                        offset, mm, ail)
        elif twin:
            closs, td = losses.td3_critic_loss(
                cp, state.target_actor_params, state.target_critic_params,
                batch, scale, eps, offset, mm, ail, l2,
            )
            actor_loss = losses.td3_actor_loss
        else:
            closs, td = losses.critic_loss(
                cp, state.target_actor_params, state.target_critic_params,
                batch, scale, offset, mm, ail, l2,
            )
            actor_loss = losses.actor_loss
        cgrads = torch.autograd.grad(closs, tree_leaves(cp))

        # --- actor loss, through the pre-update critic; its gradient only
        # on update steps (every step unless TD3 delays it) ---
        ap = tree_map(lambda x: x.detach().requires_grad_(True), state.actor_params)
        aloss = actor_loss(ap, state.critic_params, batch, scale, offset, mm, ail)
        update = delay == 1 or (
            int(state.step) if step_index is None else step_index) % delay == 0
        agrads = torch.autograd.grad(aloss, tree_leaves(ap)) if update else None

        with torch.no_grad():
            closs, aloss, td = closs.detach(), aloss.detach(), td.detach()
            td_abs = torch.mean(torch.abs(td))
            if group is not None:
                all_reduce_mean_([*cgrads, *(agrads if update else ()), closs, aloss, td_abs],
                                 group)
            cgrads = _untree(cgrads, state.critic_params)
            if update:
                agrads = _untree(agrads, state.actor_params)
                actor_grad_norm = optree_norm(agrads)
            if config.fused_update:
                # Adam + Polyak of each net in one kernel launch, critic first.
                new_critic, critic_opt, new_target_critic = fused_adam_polyak(
                    state.critic_params, cgrads, state.critic_opt,
                    state.target_critic_params, config.critic_lr, config.tau,
                )
                new_actor, actor_opt, new_target_actor = fused_adam_polyak(
                    state.actor_params, agrads, state.actor_opt,
                    state.target_actor_params, config.actor_lr, config.tau,
                )
            elif update:
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
            else:
                new_critic, critic_opt = adam_update(
                    state.critic_params, cgrads, state.critic_opt, config.critic_lr
                )
                new_actor, actor_opt = state.actor_params, state.actor_opt
                new_target_actor = state.target_actor_params
                new_target_critic = state.target_critic_params
                actor_grad_norm = torch.zeros((), dtype=torch.float32, device=device)
            metrics = dict(
                zip(
                    METRIC_KEYS,
                    (
                        closs,
                        aloss,
                        -aloss,
                        td_abs,
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
    """Deterministic policy mu(s) on the params' device; under SAC the
    distribution's mode, tanh(mean) onto the box."""
    sac = config is not None and config.sac

    @torch.no_grad()
    def act(actor_params, obs: torch.Tensor) -> torch.Tensor:
        scale = _as_tensor(action_scale, obs.device)
        offset = _as_tensor(action_offset, obs.device)
        if sac:
            mean, _ = actor_gaussian_apply(
                actor_params, obs, config.sac_log_std_min, config.sac_log_std_max)
            return torch.tanh(mean) * scale + offset
        return actor_apply(actor_params, obs, scale, offset)

    return act


def make_sample_fn(config: DDPGConfig, action_scale, action_offset=0.0):
    """SAC's stochastic policy for exploration (the JAX package's
    make_sample_fn): sample(actor_params, obs, generator) -> a ~ pi(.|s),
    the reparameterized tanh-Gaussian sample (ops/losses.sac_sample) from
    standard normals drawn with `generator`, an explicit torch.Generator
    on the params' device (JAX passes a key)."""

    @torch.no_grad()
    def sample(actor_params, obs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        scale = _as_tensor(action_scale, obs.device)
        offset = _as_tensor(action_offset, obs.device)
        mean, log_std = actor_gaussian_apply(actor_params, obs, config.sac_log_std_min,
                                             config.sac_log_std_max)
        normal = torch.randn(mean.shape, generator=generator, device=mean.device,
                             dtype=mean.dtype)
        action, _ = losses.sac_sample(mean, log_std, normal, scale, offset)
        return action

    return sample


# --- weights across frameworks --------------------------------------------


def _params_from_numpy(tree, device):
    return tuple(
        {k: torch.tensor(np.asarray(layer[k], np.float32), device=device)
         for k in ("w", "b")}
        for layer in tree
    )


def _count_from_numpy(x, device):
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)


def _scalar_from_numpy(x, device):
    return torch.tensor(np.asarray(x, np.float32).reshape(()), device=device)


def train_state_from_numpy(tree, device="cpu") -> TrainState:
    """The JAX package's TrainState with numpy leaves (or any object with
    the same field names) -> the port's TrainState on `device`; SAC's
    log_alpha and alpha_opt (scalars) come across when present."""
    def opt(o):
        return OptState(
            mu=_params_from_numpy(o.mu, device),
            nu=_params_from_numpy(o.nu, device),
            count=_count_from_numpy(o.count, device),
        )

    log_alpha = getattr(tree, "log_alpha", None)
    alpha_opt = getattr(tree, "alpha_opt", None)

    return TrainState(
        actor_params=_params_from_numpy(tree.actor_params, device),
        critic_params=_params_from_numpy(tree.critic_params, device),
        target_actor_params=_params_from_numpy(tree.target_actor_params, device),
        target_critic_params=_params_from_numpy(tree.target_critic_params, device),
        actor_opt=opt(tree.actor_opt),
        critic_opt=opt(tree.critic_opt),
        step=_count_from_numpy(tree.step, device),
        log_alpha=None if log_alpha is None else _scalar_from_numpy(log_alpha, device),
        alpha_opt=None if alpha_opt is None else OptState(
            mu=_scalar_from_numpy(alpha_opt.mu, device),
            nu=_scalar_from_numpy(alpha_opt.nu, device),
            count=_count_from_numpy(alpha_opt.count, device),
        ),
    )


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's TrainState -> the same structure with numpy leaves (the
    field names and leaf layouts of the JAX package's TrainState)."""
    def params(t):
        return tuple(
            {k: layer[k].detach().cpu().numpy() for k in ("w", "b")} for layer in t
        )

    def scalar(x):
        return np.asarray(x.detach().cpu().numpy(), np.float32).reshape(())

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
        log_alpha=None if state.log_alpha is None else scalar(state.log_alpha),
        alpha_opt=None if state.alpha_opt is None else OptState(
            mu=scalar(state.alpha_opt.mu), nu=scalar(state.alpha_opt.nu),
            count=np.asarray(int(state.alpha_opt.count), np.int32),
        ),
    )


def state_items(state: TrainState) -> Iterator[Tuple[str, object]]:
    """(path, leaf) of every leaf of a state, in a fixed order: a params
    leaf is "<field>/<layer>/<w|b>" (actor_params/0/w, critic_opt/mu/1/b),
    a count "<field>/count", then "step", SAC's "log_alpha" and
    "alpha_opt/mu", "alpha_opt/nu", "alpha_opt/count" when present."""
    def walk(prefix, node):
        if node is None:
            return
        if isinstance(node, (TrainState, OptState)):
            for name in node._fields:
                yield from walk(f"{prefix}{name}/", getattr(node, name))
        elif isinstance(node, tuple):          # params: one {"w", "b"} a layer
            for i, layer in enumerate(node):
                for k in ("w", "b"):
                    yield f"{prefix}{i}/{k}", layer[k]
        else:
            yield prefix[:-1], node

    return walk("", state)


def state_signature(state: TrainState):
    """[(path, shape, dtype)] of a state's tensors: two states can stand in
    for each other exactly when their signatures are equal."""
    return [(path, tuple(t.shape), t.dtype) for path, t in state_items(state)]


def train_state_to_flat(state: TrainState) -> Dict[str, np.ndarray]:
    """Host copies of the state's leaves keyed by path (state_items): f32
    params, moments and log_alpha, int32 counts and step. The copies are
    the caller's: the learner may go on updating its state."""
    return {path: t.detach().to("cpu", copy=True).numpy() for path, t in state_items(state)}


def train_state_from_flat(flat: Dict[str, np.ndarray], device="cpu") -> TrainState:
    """Inverse of train_state_to_flat, on `device`. A missing path raises
    KeyError; SAC's log_alpha and alpha_opt come across when present."""
    def params(prefix):
        n = 0
        while f"{prefix}/{n}/w" in flat:
            n += 1
        if n == 0:
            raise KeyError(f"{prefix}/0/w")
        return tuple({k: flat[f"{prefix}/{i}/{k}"] for k in ("w", "b")} for i in range(n))

    def opt(prefix):
        return OptState(mu=params(f"{prefix}/mu"), nu=params(f"{prefix}/nu"),
                        count=flat[f"{prefix}/count"])

    tree = TrainState(
        actor_params=params("actor_params"),
        critic_params=params("critic_params"),
        target_actor_params=params("target_actor_params"),
        target_critic_params=params("target_critic_params"),
        actor_opt=opt("actor_opt"),
        critic_opt=opt("critic_opt"),
        step=flat["step"],
        log_alpha=flat.get("log_alpha"),
        alpha_opt=(OptState(flat["alpha_opt/mu"], flat["alpha_opt/nu"], flat["alpha_opt/count"])
                   if "alpha_opt/count" in flat else None),
    )
    return train_state_from_numpy(tree, device)
