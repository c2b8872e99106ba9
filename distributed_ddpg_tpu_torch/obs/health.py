"""The typed process-health state machine of the telemetry plane
(counterpart of distributed_ddpg_tpu/obs/health.py).

`/healthz` (obs/exporter.py) needs ONE answer to "should a supervisor keep
this process in rotation"; a boolean is not enough, because the three
answers call for different actions:

  healthy    keep serving, keep training.
  degraded   still making progress but impaired (a guardrail quarantine
             fired, the serve queue is saturated): a canary gate stops
             shifting traffic toward it, a supervisor plans a relaunch.
  draining   terminal: the process is on its way out (a watchdog stall, a
             SIGTERM preemption). Route nothing new; expect the exit.

Degraded conditions are named and reversible (`note(name, active)`).
Draining is latched: the first `drain()` wins, and later condition churn
cannot flap the endpoint while the teardown runs.

Live probes (`register_probe`) are evaluated when /healthz is read, on the
scrape thread: the serve queue's saturation (serve/server.py `overloaded`)
must be the queue as it is now. A probe that raises counts as a degraded
condition (`<name>:probe_error`).

One instance a process (`get()`), as trace.py's recorder: the watchdog's
stall path (watchdog.py) and the SIGTERM handler flip it without a handle
passed through every layer.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Tuple

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"

# Numeric encoding for the /metrics gauge (ddpg_health_code): ordered by
# severity so alert rules can threshold on `> 0`.
CODES = {HEALTHY: 0, DEGRADED: 1, DRAINING: 2}


class HealthState:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._conditions: Dict[str, float] = {}  # name -> unix time flagged
        self._probes: Dict[str, Callable[[], bool]] = {}
        self._draining = ""
        self._since = time.time()

    # -- writers (train loop / watchdog / SIGTERM handler) ---------------

    def note(self, name: str, active: bool = True) -> None:
        """Set (active=True) or clear a named degraded condition. Setting
        an already-active condition keeps its original flag time."""
        with self._lock:
            if active:
                self._conditions.setdefault(name, time.time())
            else:
                self._conditions.pop(name, None)

    def drain(self, reason: str) -> None:
        """Latch the terminal draining state. First reason wins — the
        original cause must survive teardown's condition churn."""
        with self._lock:
            if not self._draining:
                self._draining = reason

    def register_probe(self, name: str, fn: Callable[[], bool]) -> None:
        """Attach a live degraded-condition probe, evaluated at read
        time on the scrape thread. `fn` returns True while degraded."""
        with self._lock:
            self._probes[name] = fn

    def reset(self) -> None:
        """Back to a fresh healthy state (tests; a new run in the same
        interpreter must not inherit the previous run's conditions)."""
        with self._lock:
            self._conditions.clear()
            self._probes.clear()
            self._draining = ""
            self._since = time.time()

    # -- readers (exporter) ---------------------------------------------

    def state(self) -> Tuple[str, List[str]]:
        """(state, reasons). Draining dominates; any active condition or
        truthy probe yields degraded; else healthy with no reasons."""
        with self._lock:
            if self._draining:
                return DRAINING, [self._draining]
            reasons = sorted(self._conditions)
            probes = list(self._probes.items())
        for name, fn in probes:
            try:
                if fn():
                    reasons.append(name)
            except Exception:
                # "Cannot determine health" must gate like "unhealthy".
                reasons.append(f"{name}:probe_error")
        return (DEGRADED, reasons) if reasons else (HEALTHY, [])

    def snapshot(self) -> Dict[str, object]:
        """The /healthz JSON body."""
        state, reasons = self.state()
        return {
            "state": state,
            "code": CODES[state],
            "reasons": reasons,
            "since_unix": round(self._since, 3),
            "t_unix": round(time.time(), 3),
        }


_STATE = HealthState()


def get() -> HealthState:
    """The process-wide health singleton (module docstring)."""
    return _STATE
