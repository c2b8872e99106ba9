"""Flight-recorder tracing: a preallocated ring of span events that the
trainer's threads bracket their work with (counterpart of
distributed_ddpg_tpu/trace.py, ported whole).

The trainer is a machine of several threads (the learner loop, the ingest
shipper, the transfer scheduler, the ChunkPrefetcher, the checkpoint
writer) and N actor processes; point metrics (PhaseTimers' means,
IngestStats) cannot say what every thread was doing in the seconds before
a wedge. This module does, cheaply enough to leave on:

  - `TraceRecorder`: a fixed-size ring of event tuples. Recording is one
    `perf_counter_ns`, one tuple and one list-slot store behind a
    GIL-atomic `itertools.count`: no lock on the hot path, no growth, old
    events overwritten (the last window is always there).
  - `span(name)` / `instant(name)` / `complete(name, t0, dur)`: the
    bracket API. Each event carries its thread, so the exported timeline
    has one track a thread.
  - `export(path)`: Chrome trace-event JSON (`{"traceEvents": [...]}`),
    loadable in Perfetto (ui.perfetto.dev) or chrome://tracing. Exports
    happen on demand (SIGUSR2, install_signal_export; the exporter's
    /trace), on a clean exit, and from the watchdog's stall path
    (watchdog.py), so a hang ships its last seconds beside its stacks.
  - `stall_report(...)`: the structured stall artifact: every thread's
    stack as JSON and the trace's tail.

A module-level singleton, off by default (every `span()` is then one shared
no-op context manager). train.py turns it on with --trace_dir; each actor
worker process enables its own recorder and exports its own file, which
Perfetto merges by pid. Stdlib only: the spawned actors import it and must
stay free of torch.

The ring index advances atomically but slot writes are not fenced against a
concurrent export, which can see a slot from either side of the wrap;
exports sort by timestamp and tolerate a torn tail (diagnostics, not
accounting).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

# Event kinds (Chrome trace "ph" phases we emit).
_SPAN = "X"      # complete event: ts + dur
_INSTANT = "i"   # instant event: ts only


class _Span:
    """Reusable-shape span context manager: records ONE complete event at
    exit (one ring slot per span, not a begin/end pair — halves ring
    pressure and keeps export trivially well-formed)."""

    __slots__ = ("_rec", "_name", "_args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, args):
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        self._rec._record(
            _SPAN, self._name, self._t0, t1 - self._t0, self._args
        )
        return False


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class TraceRecorder:
    def __init__(self, capacity: int = 65_536):
        if capacity < 16:
            raise ValueError(f"capacity must be >= 16, got {capacity}")
        self.capacity = int(capacity)
        # Preallocated slots. Each holds a tuple:
        #   (ph, name, t_ns, dur_ns, thread_name, thread_id, args|None)
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._n = itertools.count()          # GIL-atomic slot allocator
        self._t0_ns = time.perf_counter_ns() # export time origin
        # Thread identity cached per thread: current_thread() each event
        # would be a large share of a span's cost.
        self._tl = threading.local()
        # Wall-clock anchor for correlating trace timestamps with JSONL
        # wall_time and log lines: the absolute wall time of any event is
        # wall_t0 + ts/1e6.
        self._wall_t0 = time.time()
        # Caller-attached export metadata (set_meta), merged into the
        # export's otherData block.
        self._meta: Dict[str, Any] = {}
        self._meta_lock = threading.Lock()

    def set_meta(self, **kv: Any) -> None:
        """Attach key/values to the export's otherData block (merged over
        the defaults). JSON-serializable values only."""
        with self._meta_lock:
            self._meta.update(kv)

    # --- recording (hot path) ---

    def _record(self, ph: str, name: str, t_ns: int, dur_ns: int, args) -> None:
        tl = self._tl
        try:
            tname, tid = tl.info
        except AttributeError:
            t = threading.current_thread()
            tname, tid = tl.info = (t.name, t.ident)
        self._buf[next(self._n) % self.capacity] = (
            ph, name, t_ns, dur_ns, tname, tid, args
        )

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        self._record(_INSTANT, name, time.perf_counter_ns(), 0, args or None)

    def complete(self, name: str, start_s: float, dur_s: float, **args) -> None:
        """Record a span from explicit perf_counter()-based times — for
        sites that already measured a wait/stall and only want to log it
        when it actually happened (e.g. ingest backpressure)."""
        self._record(
            _SPAN, name, int(start_s * 1e9), int(dur_s * 1e9), args or None
        )

    # --- export ---

    def events(self, window_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Chrome trace-event dicts, oldest first. `window_s` keeps only
        events ENDING within the last `window_s` seconds — the stall path's
        "what led up to the wedge" view."""
        n = next(self._n)  # burns one slot index; harmless (diagnostics)
        live = min(n, self.capacity)
        raw = [e for e in self._buf[:live] if e is not None]
        raw.sort(key=lambda e: e[2])
        if window_s is not None:
            cutoff = time.perf_counter_ns() - int(window_s * 1e9)
            raw = [e for e in raw if e[2] + e[3] >= cutoff]
        pid = os.getpid()
        out: List[Dict[str, Any]] = []
        seen_tids = {}
        for ph, name, t_ns, dur_ns, tname, tid, args in raw:
            if tid not in seen_tids:
                seen_tids[tid] = tname
            ev: Dict[str, Any] = {
                "name": name,
                "ph": ph,
                "pid": pid,
                "tid": tid,
                "ts": (t_ns - self._t0_ns) / 1e3,  # microseconds
            }
            if ph == _SPAN:
                ev["dur"] = dur_ns / 1e3
            else:
                ev["s"] = "t"  # instant scope: thread
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        # Thread-name metadata so Perfetto labels tracks "learner",
        # "ingest-ship", "prefetch", ... instead of bare thread ids.
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in seen_tids.items()
        ]
        return meta + out

    def export(self, path: str, window_s: Optional[float] = None) -> int:
        """Write Chrome trace JSON; returns the number of events written.
        Parent directories are created; failures raise (callers on crash
        paths wrap in try/except — see watchdog.py)."""
        events = self.events(window_s=window_s)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with self._meta_lock:
            meta = dict(self._meta)
        with open(path, "w") as f:
            json.dump(
                {
                    "traceEvents": events,
                    "displayTimeUnit": "ms",
                    "otherData": {
                        "wall_t0": self._wall_t0,
                        "pid": os.getpid(),
                        "argv": " ".join(sys.argv[:6]),
                        **meta,
                    },
                },
                f,
            )
        return len(events)


# ---------------------------------------------------------------------------
# Module-level singleton: the recorder every subsystem brackets against.
# Off by default; `configure()` turns it on (train.py, actors/worker.py, tests).
# ---------------------------------------------------------------------------

_recorder: Optional[TraceRecorder] = None


def configure(capacity: int = 65_536) -> TraceRecorder:
    """Enable tracing process-wide (idempotent: reconfiguring replaces the
    ring, so tests get a fresh one)."""
    global _recorder
    _recorder = TraceRecorder(capacity=capacity)
    return _recorder


def disable() -> None:
    global _recorder
    _recorder = None


def enabled() -> bool:
    return _recorder is not None


def get() -> Optional[TraceRecorder]:
    return _recorder


def span(name: str, **args):
    r = _recorder
    if r is None:
        return _NULL_SPAN
    return r.span(name, **args)


def instant(name: str, **args) -> None:
    r = _recorder
    if r is not None:
        r.instant(name, **args)


def complete(name: str, start_s: float, dur_s: float, **args) -> None:
    r = _recorder
    if r is not None:
        r.complete(name, start_s, dur_s, **args)


def export(path: str, window_s: Optional[float] = None) -> int:
    """Export the singleton's ring; 0 events (and no file) when disabled."""
    r = _recorder
    if r is None:
        return 0
    return r.export(path, window_s=window_s)


def set_meta(**kv) -> None:
    """Attach otherData metadata to the singleton's exports (no-op while
    disabled) — the clock-handshake / process-identity hook."""
    r = _recorder
    if r is not None:
        r.set_meta(**kv)


def install_signal_export(path: str) -> bool:
    """Install a SIGUSR2 handler that exports the singleton's ring to
    `path` — the live-run timeline poke (train.py arms it alongside the
    watchdog; the /trace endpoint is the network sibling). Returns True
    when installed; False on platforms without SIGUSR2 or off the main
    thread (embedded callers), where signals cannot be installed. The
    handler never raises: a read-only diagnostic poke must not crash the
    healthy run it inspects."""
    import signal as _signal

    if not hasattr(_signal, "SIGUSR2"):
        return False

    def _export_on_signal(*_):
        try:
            export(path)
        except Exception as e:
            print(f"[trace] SIGUSR2 export failed: {e!r}",
                  file=sys.stderr, flush=True)

    try:
        _signal.signal(_signal.SIGUSR2, _export_on_signal)
    except ValueError:
        return False  # not on the main thread
    return True


# ---------------------------------------------------------------------------
# Stall artifacts (the watchdog's structured crash report)
# ---------------------------------------------------------------------------

STALL_REPORT = "stall_report.json"
STALL_TRACE = "stall_trace.json"


def thread_stacks() -> List[Dict[str, Any]]:
    """Every live thread's stack as structured JSON (the machine-parseable
    complement to faulthandler's stderr dump)."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        out.append(
            {
                "ident": ident,
                "name": t.name if t else f"<unknown-{ident}>",
                "daemon": bool(t.daemon) if t else None,
                "stack": [
                    f"{fs.filename}:{fs.lineno} {fs.name}: {fs.line or ''}"
                    for fs in traceback.extract_stack(frame)
                ],
            }
        )
    return out


def stall_report(
    directory: str,
    reason: str,
    timeout_s: float = 0.0,
    window_s: float = 30.0,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, str]:
    """Write `stall_report.json` (+ `stall_trace.json` when tracing is on)
    into `directory`. Returns {artifact: path}. Never raises — this runs on
    the crash path, where a secondary failure must not mask the stall dump
    (each artifact is attempted independently)."""
    paths: Dict[str, str] = {}
    try:
        os.makedirs(directory, exist_ok=True)
    except Exception:
        return paths
    trace_path = os.path.join(directory, STALL_TRACE)
    n_events = 0
    try:
        n_events = export(trace_path, window_s=window_s)
        if n_events:
            paths["trace"] = trace_path
    except Exception:
        pass
    report_path = os.path.join(directory, STALL_REPORT)
    try:
        report = {
            "reason": reason,
            "timeout_s": timeout_s,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "argv": sys.argv,
            "threads": thread_stacks(),
            "trace_events": n_events,
            "trace_path": paths.get("trace"),
            **(extra or {}),
        }
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
        paths["report"] = report_path
    except Exception:
        pass
    return paths
