"""Deterministic fault injection: a seeded `FaultPlan` scripted from the
config (`--faults='worker:1:crash@500;ckpt:write:ioerror@2'`) that drives
crashes, hangs, slowdowns and IO errors into every recoverable component
(counterpart of distributed_ddpg_tpu/faults.py).

Every fault fires at a deterministic trigger point (an env step for a
worker, a call ordinal for a host-side site); the plan's seed only fills in
durations left unspecified, each drawn from a PRNG seeded by the plan's seed
and the spec, as the JAX package draws them, so one spec string and seed
give one schedule in either package.

Grammar (';'-separated specs):

    spec      := component [':' target] ':' kind '@' at ['~' seconds]
               | 'pod' ':' proc ':' 'exit' '@' at ':' code
    component := worker | pool | shipper | prefetch | ckpt | transfer | pod
                 | numeric | serve | devactor | slice | front
    kind      := crash | crashloop | hang | stall | slow | ioerror | kill
                 | nan | inf | spike | corrupt | exit | regress

`at` is 1-based: for `worker` the env step inside that worker's first
incarnation (a respawned worker starts clean, except for `crashloop`, which
re-arms on every incarnation), for a host-side site the n-th call of the
instrumented operation; for `pod` it is the n-th steady-state sync_ship
beat of that pod process (node), counted from the warmup's end, the same
ordinal on every node. `~seconds` sets the duration of slow, hang and
stall faults (default: the seeded draw of `_default_duration`; a pod hang
defaults to an hour, to outlast the pod deadline).

    worker:<id>:crash@N      raise at env step N (the process dies; the
                             pool's monitor respawns it as `dead`)
    worker:<id>:crashloop@N  crash at local step N of every incarnation
    worker:<id>:hang@N       freeze without heartbeats (the silent timeout)
    worker:<id>:stall@N      keep heartbeating, produce nothing (the pool's
                             zero-rows detector, --actor_no_progress_s)
    worker:<id>:slow@N~S     sleep S a step for SLOW_FAULT_STEPS env steps
    ckpt:write:ioerror@K     the K-th checkpoint write attempt raises
                             (checkpoint.py's retry)
    ckpt:write:slow@K~S      the K-th write attempt sleeps S first
    shipper:ship:crash@K     the K-th ingest ship raises (replay/device.py's
                             bounded shipper restart)
    shipper:ship:slow@K~S    the K-th ingest ship sleeps S first
    prefetch:sample:hang@K~S the K-th prefetch sample sleeps S
                             (parallel/prefetch.py; also slow, crash)
    pool:broadcast:slow@K~S  the K-th param broadcast sleeps S first
    pool:monitor:slow@K~S    the K-th supervision pass sleeps S first
    transfer:dispatch:crash@K the K-th transfer-scheduler dispatch raises,
                             killing the scheduler thread (its bounded
                             self-restart, transfer/scheduler.py)
    transfer:dispatch:slow@K~S the K-th dispatch sleeps S first
    pod:<proc>:kill@K        pod process <proc> SIGKILLs itself at its K-th
                             sync_ship beat, before the beat's collective:
                             the survivors must see the loss as
                             PodPeerLost (parallel/multihost.py) and exit
                             76
    pod:<proc>:hang@K~S      pod process <proc> freezes S seconds (default
                             an hour) at its K-th beat: the hung-peer
                             flavour, caught by the pod deadline
    pod:<proc>:slow@K~S      pod process <proc> sleeps S at its K-th beat
                             and goes on: a straggler, not a lost peer
                             (the pod aggregator attributes it)
    pod:<proc>:exit@K:<code> pod process <proc> hard-exits with exactly
                             <code> (0..255) at its K-th beat (os._exit):
                             every branch of the exit contract for the
                             supervisor's drills; peers see PodPeerLost
    slice:<proc>:corrupt@K   rank <proc>'s K-th replay-slice write lands torn:
                             the digest sidecar records the intact payload,
                             then the npz is truncated (checkpoint.
                             write_replay_slice); verification must
                             quarantine that slice alone
    slice:<proc>:kill@K      rank <proc> SIGKILLs itself at its K-th slice
                             write, before any byte lands: the step's set
                             stays incomplete and adoption falls back to
                             an older complete one
    devactor:rollout:crash@K the K-th device-actor rollout raises
                             (actors/device_pool.py's bounded restart,
                             devactor_restarts)
    devactor:rollout:slow@K~S the K-th rollout sleeps S first
    numeric:grad:nan@K       the K-th guarded learner step computes against
                             a NaN-poisoned minibatch (the probe must skip
                             the update and, sustained, roll back)
    numeric:replay:inf@K     the K-th ingested env-step row lands with
                             reward=+inf (poisoned at drain time, train.py)
    numeric:loss:spike@K     the K-th guarded learner step sees its rewards
                             scaled by 1e6 (the z-score detector)
    serve:batcher:stall@K~S  the K-th inference-batch dispatch sleeps S
                             before its apply (serve/batcher.py; also hang
                             and slow)
    serve:dispatch:crash@K   the K-th inference-batch apply raises (also
                             slow)
    front:accept:stall@K~S   the K-th accepted TCP connection's handler
                             sleeps S (serve/front/ingress.py; also slow
                             and hang)
    front:frame:corrupt@K    the K-th decoded request frame is treated as
                             corrupt (a typed bad_frame answer)
    front:canary:regress@K~S every candidate-routed request from the K-th on
                             serves S seconds slower (sustained)

Numeric `at` ordinals count guarded learner steps on a monotonic clock
(guardrails.GuardState.total) that a rollback does not rewind; they are
consumed when the learner builds its chunk (parallel/learner.py), not
through a FaultSite.

The legacy hook `--inject_fault=actor:<id>:<step>` (config.py) is an alias
for `worker:<id>:crash@<step>`.

Host-side consumers hold a `FaultSite` (`plan.site(component, target)`) and
tick it once an operation; worker processes receive their picklable fault
tuples through `plan.for_worker(id, incarnation)` and apply them inline
(actors/worker.py). An empty plan's tick is one attribute check.

`slice` targets a rank's all-writer replay-slice writes (plan.slice_site,
ticked once a checkpoint.write_replay_slice call, cadence and emergency
writes alike). Stdlib only: the actor workers import this module and
never import torch.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

COMPONENTS = ("worker", "pool", "shipper", "prefetch", "ckpt", "transfer",
              "pod", "numeric", "serve", "devactor", "slice", "front")
KINDS = ("crash", "crashloop", "hang", "stall", "slow", "ioerror", "kill",
         "nan", "inf", "spike", "corrupt", "exit", "regress")

# Worker `slow` faults throttle this many consecutive env steps, then lift.
SLOW_FAULT_STEPS = 200

# Worker kinds need a process to kill or freeze; site kinds need a call
# site that can raise or sleep inline.
_WORKER_KINDS = ("crash", "crashloop", "hang", "stall", "slow")
_SITE_KINDS = ("crash", "hang", "slow", "ioerror")
# Pod kinds target a whole process (node) of a pod at a beat ordinal.
_POD_KINDS = ("kill", "hang", "slow", "exit")
# Numeric faults are target->kind pairs (each target poisons one detector
# of the guardrails' probe): grad->nan, replay->inf, loss->spike.
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
# Slice faults target one rank's replay-slice writes: `corrupt` tears the
# payload after the digest landed, `kill` dies before any byte does.
_SLICE_KINDS = ("corrupt", "kill")


class InjectedFault(OSError):
    """A scripted fault from a FaultPlan. Subclasses OSError so recovery
    paths written for real IO failures (the checkpoint write's retry) treat
    an injected failure like the genuine article."""


class InjectedCorruption(InjectedFault):
    """A scripted torn write: a slice site's tick() raises it and
    checkpoint.write_replay_slice catches it, then truncates the payload it
    wrote after the sidecar landed. Any other site treats it as the IO
    failure it subclasses."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    component: str
    target: str      # worker id as str, or site name ("write", "ship", ...)
    kind: str
    at: int          # env step (worker) / 1-based call ordinal (site)
    duration_s: float = 0.0  # slow/hang/stall/regress; resolved at parse time
    code: int = 0    # pod exit only: the exit status to die with

    def describe(self) -> str:
        tgt = f":{self.target}" if self.target else ""
        suffix = f":{self.code}" if self.kind == "exit" else ""
        return f"{self.component}{tgt}:{self.kind}@{self.at}{suffix}"


def _default_duration(kind: str, rng: random.Random, component: str = "") -> float:
    """Seeded default durations (the JAX package's): slowdowns are
    sub-second hiccups, canary regressions a few tens of ms a request,
    hangs and stalls long enough to trip the timeouts they target (worker
    hangs ignore this: they freeze until terminated); a pod hang lasts an
    hour, to outlast the pod deadline."""
    if kind == "slow":
        return round(rng.uniform(0.05, 0.25), 3)
    if kind == "regress":
        return round(rng.uniform(0.02, 0.1), 3)
    if kind in ("hang", "stall"):
        if component == "pod":
            return 3600.0
        return round(rng.uniform(2.0, 5.0), 3)
    return 0.0


class FaultPlan:
    """An immutable, seeded schedule of FaultSpecs and the factory of the
    per-component injectors. Parse once (config validation does, so a typo
    dies at argument parsing), share everywhere."""

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

    def for_worker(self, worker_id: int, incarnation: int = 0) -> List[Tuple[str, int, float]]:
        """Picklable (kind, at_step, duration_s) tuples for one worker
        process. The first incarnation gets every scheduled fault; a
        respawn gets only `crashloop` (re-armed as a plain crash), so a
        recovery is observable and a one-shot crash does not re-fire."""
        out = []
        for s in self.specs:
            if s.component != "worker" or s.target != str(worker_id):
                continue
            if s.kind == "crashloop":
                out.append(("crash", s.at, s.duration_s))
            elif incarnation == 0:
                out.append((s.kind, s.at, s.duration_s))
        return sorted(out, key=lambda t: t[1])

    def site(self, component: str, target: str = "") -> "FaultSite":
        """The injector of one host-side operation: the specs of
        `component` whose target matches."""
        matches = [s for s in self.specs if s.component == component
                   and (not s.target or not target or s.target == target)]
        return FaultSite(matches, component, target)

    def pod_site(self, process_index: int) -> "FaultSite":
        """The pod injector of one pod process (node): ticked once a
        steady-state sync_ship beat (replay/device.py), so `@K` is the
        K-th beat after the warmup, the same ordinal on every node."""
        return self.site("pod", str(int(process_index)))

    def slice_site(self, process_index: int) -> "FaultSite":
        """The replay-slice injector of one rank: ticked once a
        checkpoint.write_replay_slice call, so `@K` is that rank's K-th
        slice write, cadence and emergency writes alike."""
        return self.site("slice", str(int(process_index)))

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
            "'worker:2:crash@5000' or 'ckpt:write:ioerror@2')"
        )

    parts = raw.split(":")
    if len(parts) == 3 and parts[0] == "actor" and "@" not in parts[2]:
        # The legacy --inject_fault alias: actor:<id>:<step> is a crash.
        try:
            wid, step = int(parts[1]), int(parts[2])
        except ValueError:
            raise bad("legacy actor:<id>:<step> needs two integers") from None
        return FaultSpec("worker", str(wid), "crash", step, 0.0)
    # Typed-exit injection is the one 4-field spec: the trailing field is
    # the exit status to die with (pod:<proc>:exit@<beat>:<code>).
    code = 0
    has_code = False
    if len(parts) == 4 and parts[0] == "pod" and parts[2].startswith("exit@"):
        has_code = True
        code_str = parts.pop()
        try:
            code = int(code_str)
        except ValueError:
            raise bad(f"bad exit code {code_str!r} (integer 0..255)") from None
        if not 0 <= code <= 255:
            raise bad(f"exit code {code} out of range (0..255)")
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
    if component == "worker":
        if kind not in _WORKER_KINDS:
            raise bad(f"kind {kind!r} does not apply to workers")
        try:
            int(target)
        except ValueError:
            raise bad("worker target must be an integer id") from None
    elif component == "pod":
        if kind not in _POD_KINDS:
            raise bad(f"kind {kind!r} does not apply to pod (one of {_POD_KINDS})")
        if kind == "exit" and not has_code:
            raise bad("exit needs a trailing ':<code>' (pod:<proc>:exit@<beat>:<code>)")
        try:
            int(target)
        except ValueError:
            raise bad("pod target must be an integer process id") from None
    elif component == "slice":
        if kind not in _SLICE_KINDS:
            raise bad(f"kind {kind!r} does not apply to slice (one of {_SLICE_KINDS})")
        try:
            int(target)
        except ValueError:
            raise bad("slice target must be an integer process id") from None
    elif component == "numeric":
        if target not in _NUMERIC_PAIRS:
            raise bad(f"numeric target must be one of {tuple(_NUMERIC_PAIRS)}")
        if kind != _NUMERIC_PAIRS[target]:
            raise bad(
                f"numeric:{target} takes kind {_NUMERIC_PAIRS[target]!r} "
                f"(got {kind!r}) — grad:nan, replay:inf, loss:spike"
            )
    elif component in ("serve", "front"):
        table = _SERVE_KINDS if component == "serve" else _FRONT_KINDS
        if target not in table:
            raise bad(f"{component} target must be one of {tuple(table)}")
        if kind not in table[target]:
            raise bad(f"{component}:{target} takes kind in {table[target]} "
                      f"(got {kind!r})")
    elif kind not in _SITE_KINDS:
        raise bad(f"kind {kind!r} does not apply to host sites")
    if duration is None:
        duration = _default_duration(kind, rng, component)
    return FaultSpec(component, target, kind, at, duration, code)


class FaultSite:
    """Call-ordinal injector of one host-side operation: `tick()` once an
    operation; the n-th tick fires every spec scheduled `@n` (`ioerror`,
    `crash` raise InjectedFault and `corrupt` InjectedCorruption, `slow`/`hang`/`stall` sleep
    their duration, a pod `kill` SIGKILLs this process and a pod `exit`
    os._exits with its code; `regress` is read by
    front_canary_regressions, not here). A pod fault notes its firing on
    stderr with the wall time first. Thread-safe (sites sit on the shipper's, the prefetcher's and
    the saver's threads). A site with no specs is a no-op."""

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
            if s.component in ("pod", "slice"):
                # The drills read when the peer went (the detection latency).
                print(f"[chaos] {s.describe()} fired at {time.time():.6f}",
                      file=sys.stderr, flush=True)
            if s.kind in ("slow", "hang", "stall"):
                time.sleep(s.duration_s)
            elif s.kind == "corrupt":
                # The slice writer catches this after its sidecar landed and
                # truncates the payload: verification must reject it (the
                # front reads it as the InjectedFault it subclasses).
                raise InjectedCorruption(f"injected {s.describe()} (call #{self._count})")
            elif s.kind == "kill":
                # A real death: no cleanup, no exception. The peers must see
                # it through their collective (PodPeerLost).
                os.kill(os.getpid(), signal.SIGKILL)
            elif s.kind == "exit":
                # Exactly the scripted status, no cleanup (os._exit).
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(s.code)
            elif s.kind != "regress":   # ioerror, crash, corrupt
                raise InjectedFault(f"injected {s.describe()} (call #{self._count})")


# The shared empty site: the no-plan path every production call site holds.
NULL_SITE = FaultSite((), "", "")
