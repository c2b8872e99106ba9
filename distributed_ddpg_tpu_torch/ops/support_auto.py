"""Auto-sizing of the C51/D4PG categorical support (numpy only).

The port's own copy of distributed_ddpg_tpu/ops/support_auto.py:96-291
(initial_bounds, replay_data_bounds, _edge_triggered, maybe_expand,
SupportController), with the same constants and rules.
`--v_min=auto --v_max=auto` replaces the per-env support knob with two
rules:

1. **Initial sizing** (`initial_bounds`): once the replay holds warmup
   data, bound the discounted return from the observed (n-step) reward
   statistics: a persistent reward r yields r / (1 - gamma^n), a one-off
   (terminal) reward at most r; robust percentiles guard against single
   outliers, the raw extremes against sparse terminal rewards, and a
   margin keeps the edge atoms from saturating at once.
2. **Running expansion** (`maybe_expand`): when the learner's mean_q
   nears an edge of the support, that edge is pushed out geometrically —
   but only when the rule-1 bound over the replay's CURRENT rewards
   corroborates it (else the expansion is refused and counted: a
   diverging critic, not a grown return scale).

In the port a change of bounds rewrites the kernel's support row and
spacing in place (ShardedLearner.set_value_bounds); nothing is rebuilt.
The critic's logits keep their per-atom meaning while the atom values
stretch, so the critic relearns the mapping over the next steps;
expansion only (never shrink) keeps this transient one-directional and
rare.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Edge-proximity threshold, in units of |mean_q| (NOT support width): the
# high edge counts as "approached" when (v_max - mean_q) < PROXIMITY *
# max(|mean_q|, MIN_HALF_WIDTH), and symmetrically for the low edge. Scaling
# by mean_q instead of the span makes the trigger immune to an oversized
# support: with a width-relative rule, a support accidentally sized
# [-3731, 639] saw the PERFECTLY HEALTHY mean_q of -11.7 as "inside the top
# 30% of the span" and expanded v_max to 5010 (measured, round-5 LunarLander
# v1 run) — growing exactly the resolution problem it was meant to solve.
# The MIN_HALF_WIDTH floor keeps a near-zero edge (Pendulum's v_max ~ 0)
# expandable: mean_q -> 0 from below still closes within the floor. It
# fires BEFORE projection clipping fully saturates the edge atoms (mean_q
# can never exceed v_max, so waiting for equality would be waiting forever).
PROXIMITY = 0.3
# On expansion the approached edge moves to center ± GROWTH * half-range:
# geometric growth => O(log) expansions over any true range.
GROWTH = 3.0
# Learner steps to HOLD after an expansion before re-checking. The stretch
# is affine and the logits are unchanged, so the reinterpreted mean_q lands
# near the NEW edge again (stretched by the same factor as the support) and
# an immediate re-check would re-fire regardless of need, cascading the
# support toward infinity at one expansion per check. Only SGD moves
# mean_q off the edge — TD targets pull the stretched predictions back
# toward the true (unstretched) Q over O(hundreds) of steps — so the
# controller must wait out that relearn horizon. Callers enforce this via
# the steps_since_expansion argument below.
COOLDOWN_STEPS = 2000
# Headroom multiplier on the initial warmup-derived range.
MARGIN = 1.2
# Corroboration strictness: the data bound must exceed the current edge
# by at least this fraction of the span for an expansion to pass the
# gate. This does NOT size the expansion (a corroborated trigger always
# gets at least the geometric step); it sets how far past the edge the
# replay rewards must reach before growth is believed — tightening it
# strengthens the diverged-critic guard, loosening it expands earlier on
# percentile jitter.
MIN_GROWTH = 0.1
# Floor on the support width: degenerate all-equal-reward warmups (e.g.
# zero-reward gridworlds) must still produce a usable support.
MIN_HALF_WIDTH = 1.0


def initial_bounds(
    rewards: np.ndarray,
    gamma: float,
    n_step: int = 1,
    discounts: Optional[np.ndarray] = None,
) -> Tuple[float, float]:
    """Derive [v_min, v_max] from observed (n-step) rewards.

    rewards: the replay's stored reward column — n-step accumulated sums
    when n_step > 1, matching what the Bellman target actually adds.
    discounts: the matching stored discount column, when available. A
    terminal transition (discount == 0) carries a ONE-OFF reward by
    definition — nothing bootstraps through it — so it must not enter the
    persistent-reward bound r/(1-gamma^n): LunarLander's random-policy
    warmup crashes (-100 terminal) are frequent enough to land inside the
    1st percentile, and multiplying them by the ~34-step horizon sized the
    support to [-3731, 639] where the hand value was ±400 (measured,
    round 5). With the terminal mask they only enter via the raw-extreme
    term (a -100 crash must still be inside the support, as ±100 itself).
    """
    r = np.asarray(rewards, np.float64)
    finite = np.isfinite(r)
    if discounts is not None:
        d = np.asarray(discounts, np.float64)
        nonterm = r[finite & (d > 0.0)]
    else:
        nonterm = r[finite]
    r = r[finite]
    if r.size == 0:
        raise ValueError("initial_bounds needs at least one finite reward")
    # Effective per-transition discount: stored n-step rewards bootstrap
    # through gamma^n, so the persistent-reward return bound is r/(1-gamma^n).
    g_eff = float(gamma) ** int(n_step)
    horizon = 1.0 / max(1.0 - g_eff, 1e-6)
    if nonterm.size == 0:
        # All-terminal warmup (bandit-style env): NOTHING bootstraps, true
        # returns ARE the raw rewards — the horizon term would oversize the
        # support ~100x and park the whole value function inside one atom.
        r_lo = r_hi = 0.0
    else:
        r_lo, r_hi = np.percentile(nonterm, [1.0, 99.0])
    # Each side: the persistent-reward bound from the robust percentile OR
    # the raw extreme (sparse terminal rewards are outliers the percentile
    # clips away, but a single +100 landing bonus must still be inside the
    # support). Zero stays inside: returns cross zero whenever rewards do,
    # and an all-negative stream (Pendulum) still has v_max ~ 0 ceilings.
    lo = min(r_lo * horizon if r_lo < 0 else 0.0, float(r.min()), 0.0)
    hi = max(r_hi * horizon if r_hi > 0 else 0.0, float(r.max()), 0.0)
    center = 0.5 * (lo + hi)
    half = max(0.5 * (hi - lo) * MARGIN, MIN_HALF_WIDTH)
    return center - half, center + half


def replay_data_bounds(replay, gamma: float, n_step: int):
    """The rule-1 bound over a replay's CURRENT reward column — the one
    derivation every call site must share (the initial sizing and the
    expansion corroboration in train.py): a drift between
    sites would make the two training paths corroborate against different
    statistics."""
    rewards, discounts = replay.reward_sample()
    return initial_bounds(rewards, gamma, n_step, discounts=discounts)


def _edge_triggered(v_min: float, v_max: float, mean_q: float) -> bool:
    """THE proximity predicate — shared by maybe_expand (the gate) and
    SupportController (refusal classification), so the refusals metric can
    never drift from what the gate actually refuses."""
    if not np.isfinite(mean_q):
        return False
    near = PROXIMITY * max(abs(mean_q), MIN_HALF_WIDTH)
    return v_max - mean_q < near or mean_q - v_min < near


def maybe_expand(
    v_min: float,
    v_max: float,
    mean_q: float,
    steps_since_expansion: Optional[int] = None,
    data_bounds_fn=None,
) -> Optional[Tuple[float, float]]:
    """Edge-triggered expansion. Returns new (v_min, v_max) when mean_q has
    closed to within PROXIMITY * max(|mean_q|, MIN_HALF_WIDTH) of either
    edge AND (when data_bounds_fn is given) the current replay data
    corroborates growth on that edge, else None (no change — the caller
    leaves the support as it is).

    data_bounds_fn: zero-arg callable returning `initial_bounds` over the
    replay's CURRENT reward column (called lazily, only after the proximity
    trigger fires — the column pull is ~100k rows). The data bound GATES:
    a trigger whose data bound does not meaningfully exceed the current
    edge is a diverging critic, not a grown return scale, and is refused
    (module docstring, seed-1 incident). A corroborated trigger grows to
    the LARGER of the data bound and the geometric step — the data is a
    lagging estimator and capping at it measurably throttles healthy runs
    (in-function comment). When None, the legacy uncorroborated geometric
    growth is used.

    steps_since_expansion: learner steps since the caller last applied an
    expansion (None = never). Checks inside COOLDOWN_STEPS are refused —
    see the COOLDOWN_STEPS note: the affine stretch re-places the
    reinterpreted mean_q near the new edge, so without the hold the check
    right after an expansion would re-fire and cascade."""
    if (
        steps_since_expansion is not None
        and steps_since_expansion < COOLDOWN_STEPS
    ):
        return None
    if not _edge_triggered(v_min, v_max, mean_q):
        return None
    center = 0.5 * (v_min + v_max)
    half = 0.5 * (v_max - v_min)
    near = PROXIMITY * max(abs(mean_q), MIN_HALF_WIDTH)
    hi_edge = v_max - mean_q < near
    lo_edge = mean_q - v_min < near
    if data_bounds_fn is None:
        if hi_edge:
            return v_min, center + GROWTH * half
        return center - GROWTH * half, v_max
    lo_d, hi_d = data_bounds_fn()
    min_step = MIN_GROWTH * (v_max - v_min)
    # The data bound GATES the expansion but does not CAP the new edge:
    # the percentile-derived bound is a lagging estimator of achievable
    # return (measured round 5, HalfCheetah seed 0 — capping the edge at
    # the data bound throttled healthy growth to 3672 where the
    # uncorroborated rule reached 5075), so a corroborated trigger gets
    # the full geometric headroom. Runaway stays bounded: the NEXT
    # expansion needs the data to corroborate again above the grown
    # edge, so a diverged critic buys at most one geometric step beyond
    # what the rewards ever supported (vs unbounded chasing pre-guard).
    if hi_edge and hi_d > v_max + min_step:
        return v_min, float(max(hi_d, center + GROWTH * half))
    if lo_edge and lo_d < v_min - min_step:
        return float(min(lo_d, center - GROWTH * half)), v_max
    return None  # trigger fired but the data does not corroborate: refuse


class SupportController:
    """Owns the one piece of expansion state — the learner step of the last
    applied expansion, and the last refusal — so the cooldown bookkeeping
    lives in one place (the training loop in train.py calls it)."""

    def __init__(self):
        self._last_expand_step: Optional[int] = None
        self._last_refusal_step: Optional[int] = None
        # Proximity triggers refused by the data-corroboration gate — a
        # nonzero, growing count in the metrics stream is the diverging-
        # critic signature (mean_q pinned at an edge the data won't let
        # grow), worth an operator's attention even though the support
        # is, correctly, not chasing it.
        self.refusals: int = 0

    def check(
        self,
        v_min: float,
        v_max: float,
        mean_q: float,
        step: int,
        data_bounds_fn=None,
    ) -> Optional[Tuple[float, float]]:
        """maybe_expand with the cooldown applied; records the step when an
        expansion fires. Returns the new bounds or None.

        Refusals are ALSO cooled down: a pinned diverged mean_q would
        otherwise re-fire the trigger on every check and re-pay the
        ~100k-row reward-column pull each time, for the rest of the run —
        the replay contents cannot change faster than COOLDOWN_STEPS
        anyway."""
        since_expand = (
            None
            if self._last_expand_step is None
            else step - self._last_expand_step
        )
        since_refusal = (
            None
            if self._last_refusal_step is None
            else step - self._last_refusal_step
        )
        if since_refusal is not None and since_refusal < COOLDOWN_STEPS:
            return None
        grown = maybe_expand(
            v_min, v_max, mean_q,
            steps_since_expansion=since_expand,
            data_bounds_fn=data_bounds_fn,
        )
        if grown is not None:
            self._last_expand_step = step
            return grown
        if (
            data_bounds_fn is not None
            and (since_expand is None or since_expand >= COOLDOWN_STEPS)
            and _edge_triggered(v_min, v_max, mean_q)
        ):
            self.refusals += 1
            self._last_refusal_step = step
        return None
