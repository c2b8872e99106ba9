"""PodSupervisor: the generation loop that turns the typed exit-code
contract (exits.py) into behaviour (counterpart of
distributed_ddpg_tpu/supervisor/core.py, the same rules).

One *generation* = one spawned set of training processes sharing a
fresh rendezvous port. The supervisor waits for the generation to end,
classifies the exit codes, and acts:

  all 0                     -> done; supervisor exits 0
  any 77 (numeric)          -> params presumed poisoned: REFUSE past the
                               `max_numeric` relaunch budget and raise a
                               typed SupervisorGaveUp (report on disk)
  any 78 (shrink-ready)     -> relaunch at M = members - dead(signal),
                               immediately, no backoff (the sharded
                               replay slices make the shrunk pod
                               productive; their trainer side comes with
                               ROADMAP.md Queue 1 item 10's data-plane
                               half)
  grow resize (self-initiated SIGTERM) -> relaunch at the restored
                               membership
  anything else (70/75/76/untyped) -> relaunch in place with exponential
                               backoff; repeated fast failures trip the
                               crash-loop circuit breaker (the
                               actors/pool.py quarantine-window pattern)
                               -> SupervisorGaveUp

While the pod runs below full strength the HealthProber polls the lost
slots' /healthz; once a slot clears the K-consecutive + hysteresis gate
(and the running generation is at least `grow_defer_s` old, so a resize
does not thrash a generation still starting up), the supervisor does
the checkpoint-boundary stop-the-world resize: SIGTERM the running pod
(each child takes its exit-75 emergency checkpoint), then relaunch at
the grown membership.

Stdlib only; no torch. Every deadline routes through SupervisorConfig.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from distributed_ddpg_tpu_torch import exits
from distributed_ddpg_tpu_torch.metrics import SupervisorStats
from distributed_ddpg_tpu_torch.obs.probe import probe_healthz
from distributed_ddpg_tpu_torch.supervisor.events import EventLog
from distributed_ddpg_tpu_torch.supervisor.prober import HealthProber

# Child-reaping poll cadence (sub-second by design: the loop is also the
# stop-signal and grow-trigger check).
_POLL_S = 0.2


class SupervisorGaveUp(Exception):
    """Typed terminal verdict: the supervisor refuses to keep
    relaunching (crash-loop breaker, numeric budget, or generation
    budget). Carries the structured report it wrote — the CLI exits
    EXIT_SUPERVISOR_GAVE_UP and points at `report_path`."""

    def __init__(self, reason: str, report: Dict[str, Any],
                 report_path: str = ""):
        super().__init__(f"supervisor gave up: {reason}")
        self.reason = reason
        self.report = report
        self.report_path = report_path


@dataclasses.dataclass
class SupervisorConfig:
    """Knobs, grouped by the decision they govern. Durations are seconds;
    every blocking wait in core/prober routes through one of these (the
    timeout-discipline lint rule holds for supervisor code too)."""

    procs: int                       # N: full-strength membership
    # -- relaunch/backoff/breaker (the actors/pool.py quarantine shape) --
    backoff_base_s: float = 1.0      # first backoff; doubles per failure
    backoff_max_s: float = 60.0      # exponential cap
    breaker_failures: int = 5        # >= this many failing generations...
    breaker_window_s: float = 300.0  # ...within this window -> give up
    healthy_run_s: float = 60.0      # generations older than this reset
                                     # the consecutive-failure count
    max_numeric: int = 0             # 77 relaunch budget (default refuse)
    max_generations: int = 0         # hard generation cap (0 = unbounded)
    # -- generation teardown --
    drain_grace_s: float = 60.0      # first exit -> peers get this long
    kill_grace_s: float = 10.0       # SIGTERM -> SIGKILL escalation
    # -- health-gated rejoin --
    probe_host: str = "127.0.0.1"
    probe_port_base: int = 0         # slot i probed at base+i; 0 = no grow
    probe_interval_s: float = 2.0
    probe_healthy_k: int = 3
    probe_hysteresis_s: float = 10.0
    grow_defer_s: float = 30.0       # min generation age before a resize
    # -- artifacts --
    event_log: str = ""              # JSONL event stream ('' = memory only)
    report_path: str = ""            # gave-up report ('' = derive/cwd)
    child_log_dir: str = ""          # per-child stdout+stderr captures


def backoff_for(consecutive: int, base_s: float, max_s: float) -> float:
    """Exponential backoff before relaunch attempt `consecutive` (1-based
    count of consecutive failing generations): base * 2^(n-1), capped."""
    if consecutive <= 0:
        return 0.0
    return min(float(max_s), float(base_s) * (2.0 ** (consecutive - 1)))


def classify_generation(
    codes: Sequence[Optional[int]], grow_pending: bool = False
) -> str:
    """Pure exit-code dispatch for one finished generation -> one of
    'success' | 'numeric' | 'resize' | 'shrink' | 'relaunch'.

    Priority order IS the contract: a numeric abort (77) anywhere
    outranks everything — those params are poisoned no matter what the
    peers report. A self-initiated resize (we sent the SIGTERMs; exits
    carry no new information) outranks shrink. Shrink needs BOTH an
    explicit 78 (a survivor verified a complete slice set) and at least
    one peer actually dead-by-signal — all-78 with nobody dead means the
    whole pod aborted in lockstep and should relaunch at full strength.
    """
    codes = list(codes)
    if any(c == exits.EXIT_NUMERIC for c in codes):
        return "numeric"
    if grow_pending:
        return "resize"
    if all(c == exits.EXIT_OK for c in codes):
        return "success"
    if any(c == exits.EXIT_POD_SHRINK for c in codes):
        dead = sum(1 for c in codes if c is None or c < 0)
        if 0 < dead < len(codes):
            return "shrink"
    return "relaunch"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Child:
    def __init__(self, proc_index: int, popen: subprocess.Popen, log_fh):
        self.proc_index = proc_index
        self.popen = popen
        self.log_fh = log_fh
        self.reported = False  # exit event emitted


# command_builder(proc, nprocs, port, gen) -> (argv, env_overrides)
CommandBuilder = Callable[[int, int, int, int], Tuple[List[str], Dict[str, str]]]


class PodSupervisor:
    """The generation loop (module docstring). `command_builder` renders
    one child's argv + env from (proc_index, nprocs, coordinator_port,
    generation) — the CLI builds it from a `{proc}/{nprocs}/{port}/{gen}`
    template; tests pass closures. `probe_targets` overrides the
    probe_port_base-derived slot->(host, port) map (drills point slots at
    stand-in peers)."""

    def __init__(
        self,
        config: SupervisorConfig,
        command_builder: CommandBuilder,
        *,
        probe_targets: Optional[Dict[int, Tuple[str, int]]] = None,
        probe_fn=probe_healthz,
        events: Optional[EventLog] = None,
        stats: Optional[SupervisorStats] = None,
    ):
        if config.procs < 1:
            raise ValueError(f"procs must be >= 1, got {config.procs}")
        self.cfg = config
        self._build = command_builder
        self.events = events if events is not None else EventLog(config.event_log)
        self.stats = stats if stats is not None else SupervisorStats()
        self._stop = threading.Event()
        self._prober: Optional[HealthProber] = None
        self._probe_fn = probe_fn
        if probe_targets is not None:
            self._probe_targets = dict(probe_targets)
        elif config.probe_port_base:
            self._probe_targets = {
                i: (config.probe_host, config.probe_port_base + i)
                for i in range(config.procs)
            }
        else:
            self._probe_targets = {}

    # -- external control ------------------------------------------------

    def request_stop(self) -> None:
        """Preemption of the supervisor itself (SIGTERM/SIGINT in the
        CLI): SIGTERM the running generation, exit EXIT_PREEMPTED."""
        self._stop.set()

    # -- internals -------------------------------------------------------

    def _emit_probe(self, slot: int, transition: str, result) -> None:
        if transition == "flap":
            self.stats.record_probe_flap()
        elif transition == "ready":
            self.stats.record_probe_ready()
        self.events.emit(
            "probe", slot=slot, transition=transition,
            state=result.state, detail=result.detail[:200],
        )

    def _ensure_prober(self) -> Optional[HealthProber]:
        if self._prober is None and self._probe_targets:
            self._prober = HealthProber(
                self._probe_targets,
                interval_s=self.cfg.probe_interval_s,
                healthy_k=self.cfg.probe_healthy_k,
                hysteresis_s=self.cfg.probe_hysteresis_s,
                probe_fn=self._probe_fn,
                on_transition=self._emit_probe,
            )
            self._prober.start()
        return self._prober

    def _spawn(self, gen: int, members: int, port: int) -> List[_Child]:
        children: List[_Child] = []
        try:
            self._spawn_into(children, gen, members, port)
        except OSError:
            # Partial spawn: never leak the siblings that DID start.
            self._signal_all(children, signal.SIGKILL)
            raise
        self.stats.record_generation(members)
        return children

    def _spawn_into(
        self, children: List[_Child], gen: int, members: int, port: int
    ) -> None:
        for proc in range(members):
            argv, env_over = self._build(proc, members, port, gen)
            env = dict(os.environ)
            env.update(env_over)
            log_fh = None
            out = err = None
            if self.cfg.child_log_dir:
                os.makedirs(self.cfg.child_log_dir, exist_ok=True)
                log_fh = open(
                    os.path.join(
                        self.cfg.child_log_dir,
                        f"gen{gen}_proc{proc}.log",
                    ),
                    "ab",
                )
                out = err = log_fh
            popen = subprocess.Popen(
                argv, env=env, stdout=out, stderr=err,
                start_new_session=True,
            )
            children.append(_Child(proc, popen, log_fh))
            self.events.emit(
                "spawn", gen=gen, proc=proc, members=members, pid=popen.pid
            )

    @staticmethod
    def _signal_all(children: List[_Child], sig: int) -> None:
        for c in children:
            if c.popen.poll() is None:
                try:
                    c.popen.send_signal(sig)
                except OSError:
                    pass  # exited between poll and signal

    def _wait_generation(
        self, children: List[_Child], gen: int, members: int, t_start: float
    ) -> Tuple[List[Optional[int]], bool, int]:
        """Reap one generation. Returns (codes, grow_pending, grow_to).

        Teardown ladder once the first child exits on its own: peers get
        drain_grace_s to take their OWN typed exits (the pod abort
        machinery needs the collective deadline to fire), then SIGTERM,
        then kill_grace_s, then SIGKILL. A self-initiated stop (grow
        resize or request_stop) starts at the SIGTERM rung directly."""
        cfg = self.cfg
        first_exit_t: Optional[float] = None
        term_sent_t: Optional[float] = None
        killed = False
        grow_pending = False
        grow_to = members
        while True:
            alive = 0
            for c in children:
                rc = c.popen.poll()
                if rc is None:
                    alive += 1
                elif not c.reported:
                    c.reported = True
                    if c.log_fh is not None:
                        c.log_fh.close()
                    self.events.emit(
                        "exit", gen=gen, proc=c.proc_index, code=rc,
                        code_name=exits.describe(rc),
                        runtime_s=round(time.monotonic() - t_start, 3),
                    )
            if alive == 0:
                return (
                    [c.popen.returncode for c in children],
                    grow_pending,
                    grow_to,
                )
            now = time.monotonic()
            exited = len(children) - alive
            if exited and first_exit_t is None:
                first_exit_t = now
            # Supervisor preemption: forward the SIGTERM once.
            if self._stop.is_set() and term_sent_t is None:
                self._signal_all(children, signal.SIGTERM)
                term_sent_t = now
            # Health-gated grow: only while running degraded, only once
            # the generation is old enough to own a checkpoint boundary,
            # and never on a generation already winding down.
            if (
                not grow_pending
                and term_sent_t is None
                and exited == 0
                and members < cfg.procs
                and self._prober is not None
                and now - t_start >= cfg.grow_defer_s
            ):
                ready = self._prober.ready_slots()
                if ready:
                    grow_pending = True
                    grow_to = min(cfg.procs, members + len(ready))
                    self.events.emit(
                        "grow_initiated", gen=gen, members=members,
                        target=grow_to, slots=ready,
                    )
                    self._signal_all(children, signal.SIGTERM)
                    term_sent_t = now
            # Escalation ladder.
            if term_sent_t is not None:
                if not killed and now - term_sent_t >= cfg.kill_grace_s:
                    self._signal_all(children, signal.SIGKILL)
                    killed = True
            elif first_exit_t is not None:
                if now - first_exit_t >= cfg.drain_grace_s:
                    self._signal_all(children, signal.SIGTERM)
                    term_sent_t = now
            self._stop.wait(_POLL_S)

    def _give_up(
        self, reason: str, gen: int, members: int,
        codes: Sequence[Optional[int]], detail: str,
    ) -> SupervisorGaveUp:
        report = {
            "reason": reason,
            "detail": detail,
            "generation": gen,
            "members": members,
            "target": self.cfg.procs,
            "last_exit_codes": list(codes),
            "last_exit_names": [exits.describe(c) for c in codes],
            "counters": self.stats.snapshot(),
        }
        path = self.cfg.report_path
        if not path:
            path = (
                self.cfg.event_log + ".gave_up.json"
                if self.cfg.event_log
                else "supervisor_gave_up.json"
            )
        try:
            with open(path, "w") as fh:
                json.dump(report, fh, indent=2)
        except OSError:
            path = ""
        self.events.emit("gave_up", reason=reason, report=path,
                         gen=gen, detail=detail)
        return SupervisorGaveUp(reason, report, path)

    def _finish(self, code: int) -> int:
        if self._prober is not None:
            self._prober.stop()
        self.events.emit(
            "final", code=code, code_name=exits.describe(code),
            **self.stats.snapshot(),
        )
        self.events.close()
        return code

    # -- the generation loop --------------------------------------------

    def run(self) -> int:
        """Supervise until the pod completes (returns 0), the supervisor
        itself is preempted (returns EXIT_PREEMPTED), or a give-up path
        raises SupervisorGaveUp (after emitting final/report)."""
        cfg = self.cfg
        self.events.emit(
            "start", target=cfg.procs,
            config={
                k: getattr(cfg, k)
                for k in (
                    "backoff_base_s", "backoff_max_s", "breaker_failures",
                    "breaker_window_s", "healthy_run_s", "max_numeric",
                    "max_generations", "drain_grace_s", "kill_grace_s",
                    "probe_healthy_k", "probe_hysteresis_s", "grow_defer_s",
                )
            },
        )
        gen = 0
        members = cfg.procs
        consecutive = 0               # consecutive failing generations
        numeric_relaunches = 0
        window: deque = deque()       # failure timestamps (breaker)
        try:
            while True:
                gen += 1
                if cfg.max_generations and gen > cfg.max_generations:
                    self.stats.record_breaker_trip()
                    raise self._give_up(
                        "generation_budget", gen, members, [],
                        f"max_generations={cfg.max_generations} exhausted",
                    )
                if members < cfg.procs:
                    prober = self._ensure_prober()
                    if prober is not None:
                        prober.set_watched(range(members, cfg.procs))
                t_start = time.monotonic()
                try:
                    children = self._spawn(gen, members, _free_port())
                except OSError as e:
                    # A spawn failure is a failing generation, not a
                    # supervisor crash: it feeds backoff + breaker.
                    self.events.emit(
                        "exit", gen=gen, proc=-1, code=None,
                        code_name=f"spawn_error:{e!r}"[:200], runtime_s=0.0,
                    )
                    codes: List[Optional[int]] = [None]
                    grow_pending = False
                    grow_to = members
                else:
                    codes, grow_pending, grow_to = self._wait_generation(
                        children, gen, members, t_start
                    )
                runtime = time.monotonic() - t_start
                if self._stop.is_set():
                    return self._finish(exits.EXIT_PREEMPTED)
                action = classify_generation(codes, grow_pending)
                if action == "success":
                    return self._finish(exits.EXIT_OK)
                if action == "numeric":
                    if numeric_relaunches >= cfg.max_numeric:
                        self.stats.record_numeric_refusal()
                        self.events.emit(
                            "numeric_refusal", gen=gen,
                            budget=cfg.max_numeric,
                        )
                        raise self._give_up(
                            "numeric_abort", gen, members, codes,
                            "exit 77: params presumed poisoned — inspect "
                            "guardrail_* counters before relaunching "
                            f"(budget max_numeric={cfg.max_numeric} spent)",
                        )
                    numeric_relaunches += 1
                    self.stats.record_relaunch()
                    self.events.emit(
                        "relaunch", gen=gen, members=members,
                        reason=f"numeric_abort "
                               f"({numeric_relaunches}/{cfg.max_numeric})",
                    )
                    continue
                if action == "resize":
                    old, members = members, grow_to
                    consecutive = 0
                    self.stats.record_grow()
                    self.events.emit(
                        "grow", gen=gen, members=old, target=members
                    )
                    if self._prober is not None:
                        self._prober.set_watched(
                            range(members, cfg.procs)
                        )
                    continue
                if action == "shrink":
                    dead = sum(1 for c in codes if c is None or c < 0)
                    old, members = members, max(1, members - dead)
                    consecutive = 0
                    self.stats.record_shrink()
                    self.events.emit(
                        "shrink", gen=gen, members=old, target=members
                    )
                    continue
                # relaunch (70/75/76/untyped crash) with backoff+breaker.
                now = time.monotonic()
                if runtime < cfg.healthy_run_s:
                    consecutive += 1
                    window.append(now)
                    while window and now - window[0] > cfg.breaker_window_s:
                        window.popleft()
                    if (
                        cfg.breaker_failures
                        and len(window) >= cfg.breaker_failures
                    ):
                        self.stats.record_breaker_trip()
                        self.events.emit(
                            "breaker", gen=gen,
                            failures=len(window),
                            window_s=cfg.breaker_window_s,
                        )
                        raise self._give_up(
                            "crash_loop", gen, members, codes,
                            f"{len(window)} failing generations within "
                            f"{cfg.breaker_window_s:.0f}s "
                            f"(breaker_failures={cfg.breaker_failures})",
                        )
                else:
                    # A long-lived generation died: fresh incident, not a
                    # crash loop — restart the consecutive count.
                    consecutive = 0
                self.stats.record_relaunch()
                self.events.emit(
                    "relaunch", gen=gen, members=members,
                    reason=",".join(exits.describe(c) for c in codes),
                )
                wait = backoff_for(
                    consecutive, cfg.backoff_base_s, cfg.backoff_max_s
                )
                if wait > 0:
                    self.stats.record_backoff(wait)
                    self.events.emit(
                        "backoff", gen=gen, backoff_s=round(wait, 3),
                        consecutive=consecutive,
                    )
                    if self._stop.wait(wait):
                        return self._finish(exits.EXIT_PREEMPTED)
        except SupervisorGaveUp:
            self._finish(exits.EXIT_SUPERVISOR_GAVE_UP)
            raise
