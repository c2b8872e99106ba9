"""Deterministic fault injection: the `numeric`, `serve` and `front`
components.

A trimmed copy of distributed_ddpg_tpu/faults.py: `FaultPlan.parse` reads
the JAX package's `--faults` grammar (';'-separated specs,
`component[:target]:kind@at[~seconds]`) and keeps the numeric, serve and
front specs:

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
    serve:batcher:stall@K~S  the K-th inference-batch dispatch sleeps S
                           before its apply (serve/batcher.py): served
                           clients time out and degrade to their local
                           act() path (also hang and slow)
    serve:dispatch:crash@K the K-th inference-batch apply raises: every
                           request of the batch fails typed, the batcher
                           survives (also slow)
    front:accept:stall@K~S the K-th accepted TCP connection's handler
                           sleeps S before reading frames
                           (serve/front/ingress.py; also slow and hang)
    front:frame:corrupt@K  the K-th decoded request frame is treated as
                           corrupt: a typed bad_frame answer, and the
                           connection survives
    front:canary:regress@K~S every candidate-routed request from the K-th
                           on serves S seconds slower (sustained:
                           front_canary_regressions), which the canary
                           gate must roll back

Numeric `at` ordinals count guarded learner steps on a monotonic clock
(guardrails.GuardState.total) that a rollback does not rewind, so a fault
never re-fires after the rollback it caused. They are consumed when the
learner builds its chunk (parallel/learner.py), not through a FaultSite.
Serve and front `at` ordinals count calls of the instrumented operation:
their consumers hold a FaultSite (`plan.site(component, target)`) and tick
it once per operation. Durations left unspecified are drawn from a PRNG
seeded by the plan's seed and the spec, as the JAX package draws them.

Every other component of the JAX grammar (worker, pool, shipper,
prefetch, ckpt, transfer, pod, devactor, slice) raises: its injection
sites are not in the port yet (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

COMPONENTS = ("worker", "pool", "shipper", "prefetch", "ckpt", "transfer",
              "pod", "numeric", "serve", "devactor", "slice", "front")
KINDS = ("crash", "crashloop", "hang", "stall", "slow", "ioerror", "kill",
         "nan", "inf", "spike", "corrupt", "exit", "regress")
# Numeric faults are target->kind pairs (each target poisons one specific
# detector of the guardrails probe): grad->nan, replay->inf, loss->spike.
_NUMERIC_PAIRS = {"grad": "nan", "replay": "inf", "loss": "spike"}
# Serve faults target one of the batcher's two fault points: the
# collection path (delayed responses, the client-timeout fallback) or the
# batch apply (a failed batch fails typed).
_SERVE_KINDS = {
    "batcher": ("stall", "hang", "slow"),
    "dispatch": ("crash", "slow"),
}
# Front faults target the network serving front: `accept` stalls the K-th
# accepted connection's handler, `frame` corrupts the K-th decoded frame,
# `canary` slows every candidate-routed request from ordinal K on.
_FRONT_KINDS = {
    "accept": ("stall", "slow", "hang"),
    "frame": ("corrupt",),
    "canary": ("regress",),
}
_IN_PORT = ("numeric", "serve", "front")


class InjectedFault(OSError):
    """A scripted fault from a FaultPlan. Subclasses OSError so recovery
    paths written for real IO failures treat an injected failure like the
    genuine article."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    component: str
    target: str
    kind: str
    at: int          # 1-based guarded-step, ingested-row or call ordinal
    duration_s: float = 0.0  # slow/hang/stall/regress; resolved at parse time

    def describe(self) -> str:
        tgt = f":{self.target}" if self.target else ""
        return f"{self.component}{tgt}:{self.kind}@{self.at}"


def _default_duration(kind: str, rng: random.Random) -> float:
    """Seeded default durations (the JAX package's): slowdowns are
    sub-second hiccups, canary regressions a few tens of ms a request,
    hangs and stalls long enough to trip the timeouts they target."""
    if kind == "slow":
        return round(rng.uniform(0.05, 0.25), 3)
    if kind == "regress":
        return round(rng.uniform(0.02, 0.1), 3)
    if kind in ("hang", "stall"):
        return round(rng.uniform(2.0, 5.0), 3)
    return 0.0


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
        text = (text or "").strip()
        if not text:
            return cls((), seed=seed)
        for i, raw in enumerate(s.strip() for s in text.split(";")):
            if raw:
                # The JAX package's per-spec seed: a str seed hashes via
                # sha512, the same in every interpreter.
                specs.append(_parse_one(raw, random.Random(f"{seed}:{i}:{raw}")))
        return cls(specs, seed=seed)

    def site(self, component: str, target: str = "") -> "FaultSite":
        """The injector of one host-side operation (a serve or front
        target): the specs of `component` whose target matches."""
        matches = [s for s in self.specs if s.component == component
                   and (not s.target or not target or s.target == target)]
        return FaultSite(matches, component, target)

    def front_canary_regressions(self) -> Tuple[Tuple[int, float], ...]:
        """(at, seconds) of the `front:canary:regress@K~S` specs: sustained,
        unlike a FaultSite's one shot (the front sleeps S on every
        candidate-routed request from its K-th on), because the canary
        gate trips on a p95 over many samples, not on one outlier."""
        return tuple(sorted((s.at, s.duration_s) for s in self.specs
                            if s.component == "front" and s.kind == "regress"))

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


def _parse_one(raw: str, rng: random.Random) -> FaultSpec:
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
    if component in COMPONENTS and component not in _IN_PORT:
        raise ValueError(
            f"faults={raw!r}: the {component!r} component is not in this "
            "slice of the PyTorch port (ROADMAP.md Queue 1 item 12); only "
            "numeric:grad:nan, numeric:replay:inf, numeric:loss:spike and the "
            "serve and front sites are"
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
    if kind not in KINDS:
        raise bad(f"unknown kind {kind!r} (one of {KINDS})")
    duration: Optional[float] = None
    at_str, _, dur_str = at_part.partition("~")
    if "~" in at_part:
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
    if component == "numeric":
        if target not in _NUMERIC_PAIRS:
            raise bad(f"numeric target must be one of {tuple(_NUMERIC_PAIRS)}")
        if kind != _NUMERIC_PAIRS[target]:
            raise bad(
                f"numeric:{target} takes kind {_NUMERIC_PAIRS[target]!r} "
                f"(got {kind!r}) — grad:nan, replay:inf, loss:spike"
            )
    else:
        table = _SERVE_KINDS if component == "serve" else _FRONT_KINDS
        if target not in table:
            raise bad(f"{component} target must be one of {tuple(table)}")
        if kind not in table[target]:
            raise bad(f"{component}:{target} takes kind in {table[target]} "
                      f"(got {kind!r})")
    if duration is None:
        duration = _default_duration(kind, rng)
    return FaultSpec(component, target, kind, at, duration)


class FaultSite:
    """Call-ordinal injector of one host-side operation: `tick()` once per
    operation; the n-th tick fires every spec scheduled `@n` (`crash` and
    `corrupt` raise InjectedFault, `slow`/`hang`/`stall` sleep their
    duration; `regress` is read by front_canary_regressions, not here).
    Thread-safe. A site with no specs is a no-op."""

    def __init__(self, specs: Sequence[FaultSpec], component: str, target: str = ""):
        self._by_at: Dict[int, List[FaultSpec]] = {}
        for s in specs:
            self._by_at.setdefault(s.at, []).append(s)
        self.component = component
        self.target = target
        self._count = 0
        self._lock = threading.Lock()
        self.fired: List[str] = []

    def __bool__(self) -> bool:
        return bool(self._by_at)

    @property
    def calls(self) -> int:
        return self._count

    def tick(self) -> None:
        if not self._by_at:
            return
        with self._lock:
            self._count += 1
            due = self._by_at.get(self._count, ())
        for s in due:
            self.fired.append(s.describe())
            if s.kind in ("slow", "hang", "stall"):
                time.sleep(s.duration_s)
            elif s.kind in ("crash", "corrupt"):
                raise InjectedFault(f"injected {s.describe()} (call #{self._count})")
