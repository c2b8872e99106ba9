"""Deterministic fault injection, the `numeric` component only.

A trimmed copy of distributed_ddpg_tpu/faults.py: `FaultPlan.parse` reads
the JAX package's `--faults` grammar (';'-separated specs,
`component[:target]:kind@at[~seconds]`) and keeps the numeric pairs, the
chaos vectors of the numerical-health guardrails (guardrails.py):

    numeric:grad:nan@K     the K-th guarded learner step computes against a
                           NaN-poisoned minibatch (NaN grads and td): the
                           probe must skip the update and, sustained,
                           roll back
    numeric:replay:inf@K   the K-th ingested env-step row lands in replay
                           with reward=+inf (poisoned on the host at drain
                           time, train.py): the row screen must record it
                           and attribute it to its ingest source
    numeric:loss:spike@K   the K-th guarded learner step sees its rewards
                           scaled by 1e6 (finite, absurd): the EWMA
                           z-score detector's territory

Numeric `at` ordinals count guarded learner steps on a monotonic clock
(guardrails.GuardState.total) that a rollback does not rewind, so a fault
never re-fires after the rollback it caused. They are consumed when the
learner builds its chunk (parallel/learner.py), not through a FaultSite.

Every other component of the JAX grammar (worker, pool, shipper,
prefetch, ckpt, transfer, pod, serve, devactor, slice, front) raises: its
injection sites are not in the port yet (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

COMPONENTS = ("worker", "pool", "shipper", "prefetch", "ckpt", "transfer",
              "pod", "numeric", "serve", "devactor", "slice", "front")
KINDS = ("crash", "crashloop", "hang", "stall", "slow", "ioerror", "kill",
         "nan", "inf", "spike", "corrupt", "exit", "regress")
# Numeric faults are target->kind pairs (each target poisons one specific
# detector of the guardrails probe): grad->nan, replay->inf, loss->spike.
_NUMERIC_PAIRS = {"grad": "nan", "replay": "inf", "loss": "spike"}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    component: str
    target: str
    kind: str
    at: int          # 1-based guarded-step or ingested-row ordinal

    def describe(self) -> str:
        return f"{self.component}:{self.target}:{self.kind}@{self.at}"


class FaultPlan:
    """An immutable schedule of numeric FaultSpecs. Parse once (config
    validation does, so a typo dies at argument parsing), share
    everywhere."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan([{'; '.join(s.describe() for s in self.specs)}])"

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the --faults grammar. Raises ValueError with the offending
        spec named."""
        specs: List[FaultSpec] = []
        for raw in (s.strip() for s in (text or "").strip().split(";")):
            if raw:
                specs.append(_parse_one(raw))
        return cls(specs, seed=seed)

    def numeric_steps(self) -> Dict[str, Tuple[int, ...]]:
        """Guarded-learner-step ordinals of the in-program numeric faults
        ('grad' -> NaN batch, 'loss' -> 1e6-scaled rewards), consumed when
        the learner builds its chunk. 'replay' specs are host-side (see
        numeric_replay_rows) and excluded here."""
        out: Dict[str, List[int]] = {}
        for s in self.specs:
            if s.component == "numeric" and s.target in ("grad", "loss"):
                out.setdefault(s.target, []).append(s.at)
        return {k: tuple(sorted(v)) for k, v in out.items()}

    def numeric_replay_rows(self) -> Tuple[int, ...]:
        """Ingested-row ordinals (1-based) whose reward is poisoned to +inf
        at drain time (train.py)."""
        return tuple(sorted(
            s.at for s in self.specs
            if s.component == "numeric" and s.target == "replay"
        ))


def _parse_one(raw: str) -> FaultSpec:
    def bad(why: str) -> ValueError:
        return ValueError(
            f"bad fault spec {raw!r}: {why} (grammar: "
            "component[:target]:kind@at[~seconds], e.g. "
            "'numeric:grad:nan@500')"
        )

    parts = raw.split(":")
    if len(parts) == 3 and parts[0] == "actor" and "@" not in parts[2]:
        # The JAX package's legacy --inject_fault alias (a worker crash).
        parts = ["worker"]
    component = parts[0]
    if component in COMPONENTS and component != "numeric":
        raise ValueError(
            f"faults={raw!r}: the {component!r} component is not in this "
            "slice of the PyTorch port (ROADMAP.md Queue 1 item 12); only "
            "numeric:grad:nan, numeric:replay:inf and numeric:loss:spike are"
        )
    if len(parts) == 2:
        (component, tail), target = parts, ""
    elif len(parts) == 3:
        component, target, tail = parts
    else:
        raise bad("expected 2 or 3 ':'-separated fields")
    if component not in COMPONENTS:
        raise bad(f"unknown component {component!r} (one of {COMPONENTS})")
    if "@" not in tail:
        raise bad("missing '@<at>' trigger")
    kind, _, at_part = tail.partition("@")
    at_str, _, dur_str = at_part.partition("~")
    if dur_str:
        try:
            duration = float(dur_str)
        except ValueError:
            raise bad(f"bad duration {dur_str!r}") from None
        if duration < 0:
            raise bad("duration must be >= 0")
    try:
        at = int(at_str)
    except ValueError:
        raise bad(f"bad trigger {at_str!r} (integer step/ordinal)") from None
    if at < 1:
        raise bad("trigger must be >= 1")
    if kind not in KINDS:
        raise bad(f"unknown kind {kind!r} (one of {KINDS})")
    if target not in _NUMERIC_PAIRS:
        raise bad(f"numeric target must be one of {tuple(_NUMERIC_PAIRS)}")
    if kind != _NUMERIC_PAIRS[target]:
        raise bad(
            f"numeric:{target} takes kind {_NUMERIC_PAIRS[target]!r} "
            f"(got {kind!r}) — grad:nan, replay:inf, loss:spike"
        )
    return FaultSpec(component, target, kind, at)
