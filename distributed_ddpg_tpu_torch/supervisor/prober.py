"""Background rejoin gate: poll lost peers' /healthz until they are
credibly back (counterpart of distributed_ddpg_tpu/supervisor/prober.py).

A peer slot is READY to rejoin only when BOTH damping conditions hold:

  * K consecutive healthy probes (`healthy_k`) — one lucky scrape of a
    crash-looping host must not trigger a pod-wide stop-the-world resize;
  * the slot has been continuously healthy for `hysteresis_s` — a host
    that flaps at just-under-K cadence still never clears the gate,
    because every unhealthy probe resets BOTH the count and the clock.

The prober only watches the "missing tail" slots the supervisor hands it
(watch/unwatch as membership changes); probing is pull-only and
side-effect-free, so a wedged probe target costs one probe timeout per
interval, nothing more. The thread is a daemon and owns no state the
supervisor's generation loop reads without the lock.

`poll_once()` is the whole decision step, factored out of the thread
loop so tests drive it synchronously with a fake probe_fn — determinism
over sleep-and-hope.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from distributed_ddpg_tpu_torch.obs.probe import ProbeResult, probe_healthz


class _SlotState:
    def __init__(self, now: float):
        self.consecutive = 0          # healthy probes in a row
        self.last_unhealthy = now     # hysteresis clock anchor
        self.was_healthy = False      # for up/flap transition events
        self.ready_reported = False   # emit `ready` once per watch


class HealthProber(threading.Thread):
    """Watch lost-peer slots; `ready_slots()` is the grow gate's input.

    `targets` maps slot index -> (host, port) for every slot of the FULL
    pod; `on_transition(slot, transition, result)` fires on up/flap/ready
    edges only (event-log noise control). `probe_fn` is injectable for
    tests (signature of obs.probe.probe_healthz).
    """

    def __init__(
        self,
        targets: Dict[int, Tuple[str, int]],
        *,
        interval_s: float,
        healthy_k: int,
        hysteresis_s: float,
        probe_fn: Callable[[str, int], ProbeResult] = probe_healthz,
        on_transition: Optional[Callable[[int, str, ProbeResult], None]] = None,
    ):
        super().__init__(name="pod-supervisor-prober", daemon=True)
        self._targets = dict(targets)
        self._interval_s = float(interval_s)
        self._healthy_k = max(1, int(healthy_k))
        self._hysteresis_s = float(hysteresis_s)
        self._probe_fn = probe_fn
        self._on_transition = on_transition
        self._watched: Dict[int, _SlotState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()

    # -- supervisor-facing API (any thread) ------------------------------

    def set_watched(self, slots) -> None:
        """Reconcile the watch set to exactly `slots` (the missing tail
        after a membership change). Newly watched slots start cold;
        slots that remain watched KEEP their damping state."""
        want = set(int(s) for s in slots)
        now = time.monotonic()
        with self._lock:
            for s in list(self._watched):
                if s not in want:
                    del self._watched[s]
            for s in want:
                if s not in self._watched:
                    self._watched[s] = _SlotState(now)

    def ready_slots(self) -> List[int]:
        now = time.monotonic()
        with self._lock:
            return sorted(
                s for s, st in self._watched.items()
                if self._is_ready(st, now)
            )

    def stop(self) -> None:
        self._stop.set()

    # -- decision step ---------------------------------------------------

    def _is_ready(self, st: _SlotState, now: float) -> bool:
        return (
            st.consecutive >= self._healthy_k
            and now - st.last_unhealthy >= self._hysteresis_s
        )

    def poll_once(self) -> None:
        """Probe every watched slot once and update its damping state."""
        with self._lock:
            slots = list(self._watched.keys())
        for slot in slots:
            target = self._targets.get(slot)
            if target is None:
                continue
            result = self._probe_fn(target[0], target[1])
            now = time.monotonic()
            transition = ""
            with self._lock:
                st = self._watched.get(slot)
                if st is None:
                    continue  # unwatched while we probed
                if result.healthy:
                    st.consecutive += 1
                    if not st.was_healthy:
                        transition = "up"
                    st.was_healthy = True
                    if self._is_ready(st, now) and not st.ready_reported:
                        st.ready_reported = True
                        transition = "ready"
                else:
                    if st.was_healthy:
                        transition = "flap"
                    st.consecutive = 0
                    st.last_unhealthy = now
                    st.was_healthy = False
                    st.ready_reported = False
            if transition and self._on_transition is not None:
                self._on_transition(slot, transition, result)

    def run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self._interval_s)
