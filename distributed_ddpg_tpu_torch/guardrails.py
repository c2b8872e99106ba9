"""Numerical-health guardrails: divergence detection on the device and
bad-batch quarantine for the learner step.

A torch copy of distributed_ddpg_tpu/guardrails.py. A NaN gradient, an
exploding critic or a poisoned replay row corrupts the params, and every
checkpoint written after, long before the host sees a symptom. So the
guarded learner step carries a probe:

  - **finite checks** on the step's td errors, losses and grad norms and
    on the UPDATED actor and critic params: a non-finite anywhere marks
    the step bad;
  - **EWMA z-scores** on the critic loss and the critic grad norm: a
    finite but absurd step (loss spike, gradient explosion) marks the step
    bad once the EWMA has absorbed `warmup` clean steps;
  - **bad-batch quarantine**: a bad step's update is DROPPED (every leaf
    of the state keeps its pre-step value but `step`, which advances, so
    the step-keyed noise streams and TD3's delay never repeat a draw), its
    td errors are zeroed (a NaN td must not reach PER's priorities) and
    its metrics are zeroed out of the chunk mean;
  - **bad-row capture** (`batch_row_health`): rows of the gathered
    minibatch that are themselves non-finite are counted and their replay
    indices recorded (the first GUARD_BAD_IDX a chunk) so the host can
    attribute them to an actor slot (replay/device.py sources_of) and
    quarantine a repeat offender (train.py, actors/pool.py).

Every decision is a tensor operation on the learner's device: no value of
the probe is read back inside a chunk. The state lives in a small
`GuardState` of 0-d tensors threaded through the scan route's steps
(parallel/learner.py); the host reads one int32[5] health word
(HEALTH_KEYS) and, when it shows new bad rows, the int32[GUARD_BAD_IDX]
indices, once a chunk, after the chunk has ended.

On D data-parallel ranks (parallel/learner.py) the screen reads the
global minibatch, which every rank looks up whole (or gathers from a
sharded ring), so its flags, its count and its first bad indices are in
the JAX program's global flat order (step k, then rank 0's columns, rank
1's, ...) on every rank; the probe reads the loss and the gradients after
the step's all-reduce. Every decision is the same on every rank, as JAX's
are computed from replicated inputs: no rank can fork on a guardrail.

Injected faults (faults.py `numeric:*`): `numeric:grad:nan@K` and
`numeric:loss:spike@K` poison the K-th guarded step's minibatch on the
device, keyed on `GuardState.total`, a monotonic step clock that rollback
does not rewind (a fault that re-fired after every rollback would trap the
run in its own repair).

With config.guardrails=False none of this is built: the scan route's
chunk is the unguarded one, unchanged.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from distributed_ddpg_tpu_torch.ops.optim import tree_leaves

# EWMA decay of the running loss and grad-norm statistics (~1/ALPHA steps
# of memory).
EWMA_ALPHA = 0.05

# Bad replay indices captured a chunk (a fixed-size output; -1 pads).
GUARD_BAD_IDX = 32

# Reward scale of the numeric:loss:spike injection: finite but far outside
# any EWMA band, so it trips the z-score detector and only that detector.
SPIKE_SCALE = 1.0e6


class GuardState(NamedTuple):
    """The probe's state, 0-d tensors on the learner's device.

    `total` is the monotonic guarded-step clock (never rewound: the numeric
    fault ordinals and the host's counter deltas key on it). The four EWMA
    fields reset on rollback; the counters are cumulative across
    rollbacks, so the host's deltas never see a counter move backwards."""

    loss_mean: torch.Tensor   # f32: EWMA of critic_loss
    loss_var: torch.Tensor    # f32: EW variance of critic_loss
    gnorm_mean: torch.Tensor  # f32: EWMA of critic_grad_norm
    gnorm_var: torch.Tensor   # f32: EW variance of critic_grad_norm
    warm: torch.Tensor        # i32: clean observations absorbed by the EWMA
    total: torch.Tensor       # i32: guarded steps processed (monotonic)
    nonfinite: torch.Tensor   # i32: steps skipped for a non-finite value
    spikes: torch.Tensor      # i32: steps skipped for a z-score anomaly
    skipped: torch.Tensor     # i32: total updates dropped (>= the two above)
    bad_rows: torch.Tensor    # i32: non-finite sampled replay rows seen


# Order of the per-chunk health word (int32[len(HEALTH_KEYS)]), the one
# read the host makes a chunk. The counters are cumulative; train.py
# differences consecutive reads.
HEALTH_KEYS = ("total", "nonfinite", "spikes", "skipped", "bad_rows")

# The GuardState's int32 fields (the rest are f32).
_INT_FIELDS = ("warm", "total", "nonfinite", "spikes", "skipped", "bad_rows")


def init_guard_state(total: int = 0, nonfinite: int = 0, spikes: int = 0,
                     skipped: int = 0, bad_rows: int = 0,
                     device="cpu") -> GuardState:
    """A fresh probe state on `device`. Rollback passes the counters' values
    so the cumulative contract survives the EWMA reset."""
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def i(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return GuardState(
        loss_mean=f(0.0), loss_var=f(0.0),
        gnorm_mean=f(0.0), gnorm_var=f(0.0),
        warm=i(0), total=i(total),
        nonfinite=i(nonfinite), spikes=i(spikes),
        skipped=i(skipped), bad_rows=i(bad_rows),
    )


def guard_state_from_numpy(g, device="cpu") -> GuardState:
    """The JAX package's GuardState with numpy leaves (or any object with the
    same field names) -> the port's, on `device`."""
    return GuardState(*(
        torch.tensor(getattr(g, name).item(),
                     dtype=torch.int32 if name in _INT_FIELDS else torch.float32,
                     device=device)
        for name in GuardState._fields))


def health_vector(g: GuardState) -> torch.Tensor:
    """The cumulative counters packed into the per-chunk health word."""
    return torch.stack([g.total, g.nonfinite, g.spikes, g.skipped, g.bad_rows]).to(torch.int32)


def _tree_all_finite(leaves) -> torch.Tensor:
    """True (a 0-d bool tensor) iff every float tensor in `leaves` is
    finite; int leaves (counts, step) are finite by construction and
    skipped."""
    flags = [torch.isfinite(t).all() for t in leaves if t.is_floating_point()]
    return torch.stack(flags).all()


def batch_row_health(packed: torch.Tensor, idx: Optional[torch.Tensor]):
    """The screen of the gathered rows before the steps.

    packed: f32[K, B, D] gathered minibatch rows; idx: [K, B] replay indices
    (None on the host-fed path, where the caller owns the rows). Returns
    (pre_bad bool[K], bad_count i32, bad_idx i32[GUARD_BAD_IDX]): per step
    "this step's batch holds a non-finite row", the bad-row count, and the
    replay indices of the first GUARD_BAD_IDX bad rows in flat K x B order
    (-1 padded), as JAX's top_k over the bad mask gives them (ties, lowest
    position first). The first ones are taken by a compaction that needs
    no host read and is the same on every device: a bad row's rank is the
    count of bad rows up to it (an integer prefix sum, exact in any
    order), and the rows ranked below GUARD_BAD_IDX are scattered to their
    rank in a buffer one slot longer, whose last slot takes every other
    row and is dropped."""
    row_bad = torch.logical_not(torch.isfinite(packed).all(dim=-1))   # [K, B]
    pre_bad = row_bad.any(dim=-1)                                       # [K]
    bad_count = row_bad.sum().to(torch.int32)
    if idx is None:
        return pre_bad, bad_count, torch.full((GUARD_BAD_IDX,), -1, dtype=torch.int32,
                                              device=packed.device)
    flat_bad = row_bad.reshape(-1)
    rank = torch.cumsum(flat_bad.to(torch.int32), 0) - 1
    slot = torch.where(flat_bad & (rank < GUARD_BAD_IDX), rank,
                       torch.full_like(rank, GUARD_BAD_IDX)).to(torch.int64)
    got = torch.full((GUARD_BAD_IDX + 1,), -1, dtype=torch.int32, device=packed.device)
    got.scatter_(0, slot, idx.reshape(-1).to(packed.device, torch.int32))
    return pre_bad, bad_count, got[:GUARD_BAD_IDX]


def make_guarded_step(step_fn, zmax: float, warmup: int,
                      inject: Optional[Dict[str, Tuple[int, ...]]] = None):
    """Wrap a learner step (state, batch, eps, step_index) -> StepOutput
    (learner.make_learner_step) with the health probe. Returns

        guarded(state, g, batch, pre_bad, eps=None, step_index=None) ->
            (new_state, new_g, td_errors, metrics)

    where `pre_bad` is this step's row screen from batch_row_health (a 0-d
    bool tensor). The update is dropped when the step is bad; the state's
    step still advances. `inject` maps 'grad'/'loss' to guarded-step
    ordinals (faults.numeric_steps), built into the step; without it the
    injection code does not exist."""
    inject = inject or {}
    zmax = float(zmax)
    warmup = int(warmup)

    def _fires(ordinal, ats):
        fire = ordinal == int(ats[0])
        for at in ats[1:]:
            fire = torch.logical_or(fire, ordinal == int(at))
        return fire

    def guarded(state, g: GuardState, batch, pre_bad, eps=None, step_index=None):
        ordinal = g.total + 1
        if inject.get("grad"):
            fire = _fires(ordinal, inject["grad"])
            batch = batch._replace(
                obs=batch.obs + torch.where(fire, float("nan"), 0.0))
        if inject.get("loss"):
            fire = _fires(ordinal, inject["loss"])
            batch = batch._replace(
                reward=batch.reward * torch.where(fire, SPIKE_SCALE, 1.0))

        out = step_fn(state, batch, eps, step_index=step_index)
        m = out.metrics
        closs = m["critic_loss"]
        gnorm = m["critic_grad_norm"]
        finite_ok = _tree_all_finite(
            [out.td_errors, closs, m["actor_loss"], gnorm, m["actor_grad_norm"],
             *tree_leaves(out.state.actor_params), *tree_leaves(out.state.critic_params)])
        # One-sided z-scores (divergence is always UP), armed after `warmup`
        # clean observations, and never on a non-finite step.
        armed = torch.logical_and(g.warm >= warmup, finite_ok)
        z_loss = (closs - g.loss_mean) * torch.rsqrt(g.loss_var + 1e-12)
        z_g = (gnorm - g.gnorm_mean) * torch.rsqrt(g.gnorm_var + 1e-12)
        spike = torch.logical_and(armed, torch.logical_or(z_loss > zmax, z_g > zmax))
        bad = torch.logical_or(pre_bad, torch.logical_or(torch.logical_not(finite_ok), spike))

        # Drop the update on a bad step: every leaf keeps its pre-step value
        # except the step counter.
        kept = _tree_where(bad, state, out.state)._replace(step=out.state.step)
        td = torch.where(bad, 0.0, out.td_errors)
        metrics = {k: torch.where(bad, 0.0, v) for k, v in m.items()}

        # The EWMA absorbs only clean steps: a spike that updated its own
        # baseline would mask the steps that follow it.
        upd = torch.logical_not(bad)

        def ewma(mean, var, x):
            diff = x - mean
            incr = EWMA_ALPHA * diff
            new_mean = torch.where(upd, mean + incr, mean)
            new_var = torch.where(upd, (1.0 - EWMA_ALPHA) * (var + diff * incr), var)
            return new_mean, new_var

        loss_mean, loss_var = ewma(g.loss_mean, g.loss_var, closs)
        gnorm_mean, gnorm_var = ewma(g.gnorm_mean, g.gnorm_var, gnorm)
        new_g = GuardState(
            loss_mean=loss_mean, loss_var=loss_var,
            gnorm_mean=gnorm_mean, gnorm_var=gnorm_var,
            warm=g.warm + upd.to(torch.int32),
            total=ordinal,
            nonfinite=g.nonfinite + torch.logical_not(finite_ok).to(torch.int32),
            spikes=g.spikes + spike.to(torch.int32),
            skipped=g.skipped + bad.to(torch.int32),
            bad_rows=g.bad_rows,
        )
        return kept, new_g, td, metrics

    return guarded


def _tree_where(bad, old, new):
    """torch.where(bad, old, new) over every tensor of a TrainState (params,
    OptStates, step, SAC's log_alpha and alpha_opt), its structure kept."""
    if isinstance(new, torch.Tensor):
        return torch.where(bad, old, new)
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: _tree_where(bad, old[k], v) for k, v in new.items()}
    if hasattr(new, "_fields"):
        return type(new)(*(_tree_where(bad, o, n) for o, n in zip(old, new)))
    return tuple(_tree_where(bad, o, n) for o, n in zip(old, new))
