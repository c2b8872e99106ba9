"""The supervisor's JSONL event stream (counterpart of
distributed_ddpg_tpu/supervisor/events.py, the same records): one line
per decision-bearing transition, in the training JSONL's file format.

Record shape (every record):

    {"kind": "supervisor", "event": "<name>", "wall_time": <s since
     supervisor start>, "t_unix": <epoch>, ...event fields}

Event names and their extra fields:

    start           target, config (flattened knobs)
    spawn           gen, proc, members, pid
    exit            gen, proc, code, code_name, runtime_s
    shrink          gen, members (old), target (new membership)
    grow_initiated  gen, members, target (stop-the-world SIGTERM sent)
    grow            gen, members (old), target (new membership)
    relaunch        gen, members, reason
    backoff         gen, backoff_s, consecutive
    breaker         gen, failures, window_s
    numeric_refusal gen, budget
    probe           slot, transition (up|flap|ready), state, detail
    gave_up         reason, report (path)
    final           exit code + the full supervisor_* counter snapshot

The final record carries the cumulative `supervisor_*` counters
(metrics.SupervisorStats), so one `tail -1` answers "how turbulent was
this soak". Events are also kept in memory (`self.events`): the
gave-up report's source, with no re-reading of the file.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List


class EventLog:
    """Append-only JSONL writer + in-memory mirror. path='' disables the
    file (events still accumulate in memory). Thread-safe: the prober
    thread emits probe transitions while the generation loop emits
    exits."""

    def __init__(self, path: str = ""):
        self.path = path
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1) if path else None

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "kind": "supervisor",
            "event": event,
            "wall_time": round(time.time() - self._t0, 3),
            "t_unix": round(time.time(), 3),
        }
        rec.update(fields)
        with self._lock:
            self.events.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
        return rec

    def by_event(self, name: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events if e.get("event") == name]

    def close(self) -> None:
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()
