"""Versioned policy snapshots with canary promote: a copy of
distributed_ddpg_tpu/serve/front/snapshots.py (docs/SERVING.md 'Network
front').

`SnapshotStore` holds immutable named flat param vectors. Exactly one
version is STABLE (serves by default); at most one is the CANDIDATE,
serving `fraction` of traffic through a deterministic canary split —
crc32("tenant:request_id") bucketing, so the same request replays to the
same version and the split is auditable, not random.

`CanaryGate` is the ci_gate pattern applied to live traffic: the
candidate promotes only after BOTH arms have `min_requests` latency
samples (arm-on-first-capture: never promote on thin data) and its p95
is within `threshold` relative regression of stable's — and it
auto-rolls-back the moment either the latency gate or the error-rate
gate trips, without waiting for the sample quota. Rollback is instant
and atomic: the candidate is dropped, routing reverts to 100% stable.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from distributed_ddpg_tpu_torch.metrics import RESERVOIR_K, _Reservoir
from distributed_ddpg_tpu_torch.serve.batcher import ServeClosed

_BUCKETS = 10_000


class SnapshotStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._versions: Dict[str, np.ndarray] = {}
        self._stable: Optional[str] = None
        self._candidate: Optional[str] = None
        self._fraction = 0.0

    # --- publishing / lifecycle ---

    def publish(self, name: str, flat: np.ndarray) -> None:
        """Register an immutable named snapshot (read-only copy — a later
        in-place learner update must not mutate a served version). The
        FIRST published version becomes stable (there is nothing to
        canary against)."""
        if not name:
            raise ValueError("snapshot name must be non-empty")
        frozen = np.array(flat, np.float32, copy=True)
        frozen.setflags(write=False)
        with self._lock:
            if name in self._versions:
                raise ValueError(
                    f"snapshot {name!r} already published (versions are "
                    "immutable — publish under a new name)"
                )
            self._versions[name] = frozen
            if self._stable is None:
                self._stable = name

    def get(self, name: str) -> np.ndarray:
        with self._lock:
            try:
                return self._versions[name]
            except KeyError:
                raise KeyError(f"unknown snapshot {name!r}")

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._versions)

    @property
    def stable(self) -> Optional[str]:
        with self._lock:
            return self._stable

    @property
    def candidate(self) -> Optional[str]:
        with self._lock:
            return self._candidate

    def start_canary(self, name: str, fraction: float) -> None:
        if not 0.0 < fraction < 1.0:
            raise ValueError("canary fraction must be in (0, 1)")
        with self._lock:
            if name not in self._versions:
                raise KeyError(f"unknown snapshot {name!r}")
            if name == self._stable:
                raise ValueError(f"{name!r} is already stable")
            if self._candidate is not None:
                raise ValueError(
                    f"a canary is already running ({self._candidate!r}); "
                    "promote or roll it back first"
                )
            self._candidate = name
            self._fraction = float(fraction)

    def promote(self, name: Optional[str] = None) -> str:
        """Atomically make `name` (default: the current candidate) the
        stable version and clear the canary split."""
        with self._lock:
            target = name if name is not None else self._candidate
            if target is None:
                raise ValueError("no candidate to promote")
            if target not in self._versions:
                raise KeyError(f"unknown snapshot {target!r}")
            self._stable = target
            self._candidate = None
            self._fraction = 0.0
            return target

    def rollback(self) -> Optional[str]:
        """Drop the candidate, reverting to 100% stable. Returns the
        dropped name (None when no canary was running — idempotent)."""
        with self._lock:
            dropped = self._candidate
            self._candidate = None
            self._fraction = 0.0
            return dropped

    # --- routing ---

    def route(self, tenant: str, request_id: int) -> Tuple[str, bool]:
        """(version_name, is_canary) for one request. Deterministic:
        crc32 of "tenant:request_id" into 10k buckets, candidate gets the
        first fraction*10k of them."""
        with self._lock:
            stable, candidate, fraction = (
                self._stable, self._candidate, self._fraction,
            )
        if stable is None:
            # Typed: the service cannot serve yet — the ingress answers
            # this as a `closed` wire error, same as during shutdown.
            raise ServeClosed("no snapshot published yet")
        if candidate is None:
            return stable, False
        bucket = zlib.crc32(f"{tenant}:{request_id}".encode()) % _BUCKETS
        if bucket < int(fraction * _BUCKETS):
            return candidate, True
        return stable, False


class CanaryGate:
    """Live stable-vs-candidate comparison. record() feeds one served
    request's arm/latency/error; verdict() is evaluated after each canary
    request (serve/front/ingress.py):

      'rollback'  candidate p95 regressed past `threshold` relative to
                  stable (both arms populated >= min_requests), OR the
                  candidate's error RATE exceeds stable's by more than
                  5 percentage points with >= min_requests candidate
                  observations — errors don't wait for the latency quota.
      'promote'   both arms have >= min_requests latency samples and
                  neither gate trips.
      None        not enough data yet: keep splitting traffic.
    """

    # Error-rate regression allowance (absolute). Tighter than the
    # latency gate on purpose: a version that ERRORS is broken, not slow.
    ERROR_RATE_SLACK = 0.05

    def __init__(self, min_requests: int, threshold: float, seed: int = 0):
        self.min_requests = max(1, int(min_requests))
        self.threshold = float(threshold)
        self._lock = threading.Lock()
        self._seed = int(seed)
        self._reset()

    def _reset(self) -> None:
        def res(name: str) -> _Reservoir:
            return _Reservoir(
                RESERVOIR_K,
                (zlib.crc32(name.encode()) ^ self._seed) & 0x7FFFFFFF,
            )

        self._lat = {False: res("canary_stable"), True: res("canary_cand")}
        self._seen = {False: 0, True: 0}
        self._errors = {False: 0, True: 0}

    def reset(self) -> None:
        """New canary round: forget the previous candidate's samples."""
        with self._lock:
            self._reset()

    def record(self, is_canary: bool, latency_s: float,
               error: bool = False) -> None:
        with self._lock:
            self._seen[is_canary] += 1
            if error:
                self._errors[is_canary] += 1
            else:
                self._lat[is_canary].add(float(latency_s))

    def stats(self) -> dict:
        with self._lock:
            return {
                "stable_n": self._lat[False].n,
                "candidate_n": self._lat[True].n,
                "stable_p95_ms": round(
                    1000.0 * self._lat[False].percentile(0.95), 3
                ),
                "candidate_p95_ms": round(
                    1000.0 * self._lat[True].percentile(0.95), 3
                ),
                "stable_errors": self._errors[False],
                "candidate_errors": self._errors[True],
            }

    def verdict(self) -> Optional[str]:
        with self._lock:
            cand_seen = self._seen[True]
            if cand_seen >= self.min_requests:
                stable_rate = (
                    self._errors[False] / self._seen[False]
                    if self._seen[False]
                    else 0.0
                )
                cand_rate = self._errors[True] / cand_seen
                if cand_rate > stable_rate + self.ERROR_RATE_SLACK:
                    return "rollback"
            if (
                self._lat[False].n < self.min_requests
                or self._lat[True].n < self.min_requests
            ):
                return None
            stable_p95 = self._lat[False].percentile(0.95)
            cand_p95 = self._lat[True].percentile(0.95)
            if stable_p95 > 0 and (
                (cand_p95 - stable_p95) / stable_p95 > self.threshold
            ):
                return "rollback"
            return "promote"
