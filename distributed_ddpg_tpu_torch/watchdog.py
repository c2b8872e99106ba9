"""Stall watchdog: failure detection for the device-bound hot loop
(counterpart of distributed_ddpg_tpu/watchdog.py).

The actor side has heartbeats and respawn (actors/pool.py). The learner
side fails differently: a wait on the card (`Event.synchronize`, `.item()`,
`.cpu()`, a kernel build's `nvcc`) has no timeout, so a wedged card, driver
or kernel turns the trainer into a silent hang, the worst outcome for a run
nobody watches: a crash gets retried, a hang eats the whole budget.

`Watchdog` turns that hang into a loud crash. When progress stops for
`timeout_s` it:

  1. latches /healthz to `draining` (obs/health.py), then writes
     `stall_report.json` (every thread's stack as JSON, the last progress
     value, the seconds stalled) and, with the flight recorder on
     (trace.py), `stall_trace.json`, the last seconds of every thread's
     timeline, into `stall_dir`. Both writes are best-effort;
  2. dumps every thread's stack to stderr (faulthandler: it shows which
     wait wedged) and exits with `os._exit(EXIT_WATCHDOG_STALL)` (70).
     `os._exit` on purpose: a normal teardown would block on the same
     wedged card (the pool's stop, the saver's wait).

The watchdog thread needs the interpreter lock to notice the stall, so the
waits it watches must release it: torch releases it in
`Event.synchronize`, `.item()` and `.cpu()`, and ctypes releases it around
the kernels' launches (ops/_build.py).

Enabled by `config.watchdog_s > 0`: train.py arms it around train()'s
whole device lifetime (the learner's construction, the first params d2h,
every loop turn and the teardown). The first chunk builds the kernels with
nvcc and gets a one-time `grant()`, as JAX's first dispatch does for its
compile.

It watches the learner. An actor that heartbeats but produces nothing is
the pool's (config.actor_no_progress_s, actors/pool.py), and a whole fleet
that stops delivering rows is train.py's (no ingest for 10x watchdog_s
raises on the healthy learner thread)."""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

from distributed_ddpg_tpu_torch import trace

# EX_SOFTWARE: internal failure, distinguishable from OOM/kill. The code
# itself lives in the one-place exit contract (exits.py).
from distributed_ddpg_tpu_torch.exits import EXIT_WATCHDOG_STALL as _EXIT_CODE

# stop() reap bound for the watchdog thread. The thread polls _stop every
# poll tick, so this only trips when the watchdog itself is wedged mid-
# artifact-write — and then the daemon flag reaps it at exit anyway.
_STOP_JOIN_S = 5.0


def _default_on_stall(timeout_s: float) -> None:
    sys.stderr.write(
        f"\n=== watchdog: no trainer progress for {timeout_s:.0f}s — "
        "dumping all thread stacks and aborting (a blocking device call "
        f"has likely wedged; exit code {_EXIT_CODE}) ===\n"
    )
    sys.stderr.flush()
    faulthandler.dump_traceback(all_threads=True)
    os._exit(_EXIT_CODE)


class Watchdog:
    """Fire `on_stall` if `progress()` stops changing for `timeout_s`.

    `progress` must be cheap, thread-safe, and must never touch the device
    (a device call inside the watchdog would wedge the watchdog with the
    thing it watches) — an int counter bumped by the supervised loop is the
    intended shape.

    `stall_dir`: where the structured stall artifacts land before
    `on_stall` runs (stall_report.json + stall_trace.json — see module
    docstring). None disables artifact writing (unit tests of the bare
    firing logic). `trace_window_s` bounds the exported timeline to the
    run-up to the stall.
    """

    def __init__(
        self,
        timeout_s: float,
        progress: Callable[[], object],
        on_stall: Optional[Callable[[], None]] = None,
        stall_dir: Optional[str] = None,
        trace_window_s: float = 30.0,
    ):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self._timeout_s = timeout_s
        self._progress = progress
        self._on_stall = on_stall or (lambda: _default_on_stall(timeout_s))
        self._stall_dir = stall_dir
        self._trace_window_s = trace_window_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._grant_deadline = 0.0
        self._grant_lock = threading.Lock()
        # Paths written by the stall path; exposed so a custom on_stall
        # (tests, alternative supervisors) can pick the artifacts up.
        self.stall_artifacts: dict = {}

    def grant(self, extra_s: float) -> None:
        """Suppress firing until `extra_s` seconds from NOW (wall-clock
        deadline, not beat-relative): progress beats between grant() and the
        protected long call must not consume the allowance — the caller
        can't always avoid beating in between. Used for the first
        post-warmup chunk, which builds the kernels with nvcc (minutes on
        a cold build) and can outlast a `timeout_s` tuned for steady-state
        chunks; a build killed as a false stall would exit 70 exactly like
        a real wedge."""
        with self._grant_lock:
            self._grant_deadline = max(
                self._grant_deadline, time.monotonic() + float(extra_s)
            )

    def end_grant(self) -> None:
        """End the allowance once the long call it protected has returned
        (the first chunk, its kernels built): the steady state runs on the
        plain timeout_s window again, as the JAX trainer's comment has its
        grant "consumed by the first post-compile beat"."""
        with self._grant_lock:
            self._grant_deadline = 0.0

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=_STOP_JOIN_S)

    def _write_stall_artifacts(self, last_value, stalled_s: float) -> None:
        """Best-effort structured stall dump BEFORE on_stall (which, by
        default, os._exits). trace.stall_report never raises."""
        if self._stall_dir is None:
            return
        self.stall_artifacts = trace.stall_report(
            self._stall_dir,
            reason=(
                f"watchdog: no trainer progress for {self._timeout_s:.0f}s"
            ),
            timeout_s=self._timeout_s,
            window_s=self._trace_window_s,
            extra={
                "last_progress_value": repr(last_value),
                "stalled_s": round(stalled_s, 3),
            },
        )
        if self.stall_artifacts:
            sys.stderr.write(
                "watchdog: stall artifacts written: "
                + ", ".join(sorted(self.stall_artifacts.values()))
                + "\n"
            )
            sys.stderr.flush()

    def _run(self) -> None:
        last = self._progress()
        last_change = time.monotonic()
        # Poll well inside the timeout so a stall is detected within
        # ~1.25x timeout_s worst-case.
        poll = max(0.05, self._timeout_s / 4.0)
        while not self._stop.wait(poll):
            now_val = self._progress()
            now = time.monotonic()
            if now_val != last:
                last = now_val
                last_change = now
            elif now - last_change >= self._timeout_s:
                with self._grant_lock:
                    granted = now < self._grant_deadline
                if not granted:
                    # /healthz first (obs/health.py): it must read
                    # `draining` while the artifacts below are written.
                    # Latched; the broad except because the stall path
                    # must not gain failure modes.
                    try:
                        from distributed_ddpg_tpu_torch.obs import health

                        health.get().drain(
                            "watchdog stall: no trainer progress for "
                            f"{now - last_change:.0f}s"
                        )
                    except Exception:
                        pass
                    self._write_stall_artifacts(last, now - last_change)
                    self._on_stall()
                    return
