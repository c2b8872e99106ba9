"""Pod-level metric aggregation and straggler attribution (counterpart of
distributed_ddpg_tpu/obs/aggregate.py, the same rules and record).

A pod writes one JSONL stream a node. This module joins them at the
source: on each log cadence every node contributes a small fixed-shape
snapshot vector to one all-gather, and node 0 logs one `kind:"pod"`
record with the per-node min/max/spread of the beat time, the ingest
rate and the transfer backlog, a clock-spread gauge and a straggler
attribution. The record is the exporter's `ddpg_pod_*{kind="pod"}`
gauges on /metrics (obs/exporter.py renders the latest record of each
kind).

Transport: the snapshot is a milli-scaled int64 vector of at most
`multihost._UNIFORM_SLOTS` slots, so the gather rides the same uniform
int64[8] pod gather as every other (parallel/multihost.py). The gather
callable is injected (train.py passes `allgather_scalar`), so this
module is testable without a pod.

Straggler detection runs on the gathered beat-time vector, the same on
every node: a z-score test from 4 nodes up; below that a test against
the other nodes' median (two nodes' z-scores are +/-1 by construction).
A flagged node increments `PodStats.record_straggler` (the
`pod_stragglers` / `pod_straggler_host` fields of every later record) and
drops a `pod_straggler` instant on the flight recorder's timeline.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from distributed_ddpg_tpu_torch import trace

# Snapshot vector layout (milli-scaled int64; <= 8 slots so the uniform
# all-gather transport applies — see module docstring).
SLOT_BEAT_MS = 0          # wall ms per learner chunk since last gather
SLOT_INGEST_RATE = 1      # host env-steps ingested per second
SLOT_TRANSFER_BACKLOG = 2  # transfer scheduler queue depth (gauge)
SLOT_UNIX_MS = 3          # this host's wall clock, ms (clock spread)
SLOTS = 4
_SCALE = 1000.0


def detect_straggler(
    beat_ms,
    *,
    z_thresh: float = 3.0,
    rel_thresh: float = 2.0,
    min_abs_ms: float = 5.0,
) -> int:
    """Index of the straggling host in a per-host beat-time vector, or
    -1. Two tests (module docstring): population z-score when >= 4 hosts,
    relative-to-median otherwise; both gated on an absolute floor so
    microsecond jitter on a fast pod never attributes."""
    v = np.asarray(beat_ms, dtype=float)
    if v.size < 2:
        return -1
    worst = int(np.argmax(v))
    # Baseline = median of the OTHER hosts: a median over the full vector
    # would include the suspect, and at 2 hosts that makes the relative
    # test unsatisfiable (worst >= 2*mean(worst, other) needs other <= 0).
    med = float(np.median(np.delete(v, worst)))
    if float(v[worst]) - med < min_abs_ms:
        return -1
    if v.size >= 4:
        std = float(v.std())
        if std > 0.0 and (float(v[worst]) - float(v.mean())) / std >= z_thresh:
            return worst
    if med > 0.0 and float(v[worst]) >= rel_thresh * med:
        return worst
    return -1


class PodAggregator:
    """Builds this host's snapshot vector, gathers all hosts', and
    reduces to the `kind:"pod"` record fields (module docstring).

    `gather_fn(vec)` must return a [process_count, len(vec)] array —
    train.py passes `multihost.allgather_scalar` (with background beats
    it runs on the scheduler's lockstep lane, like every pod
    collective). Rates are computed against the previous collect() call,
    so the first record after warmup reflects the first full interval.
    """

    def __init__(
        self,
        *,
        gather_fn: Callable[[np.ndarray], Any],
        stats=None,
        z_thresh: float = 3.0,
        rel_thresh: float = 2.0,
        min_abs_ms: float = 5.0,
    ):
        self._gather = gather_fn
        self._stats = stats
        self._z = z_thresh
        self._rel = rel_thresh
        self._min_abs = min_abs_ms
        self._last_t = time.perf_counter()
        self._last_beats = 0
        self._last_rows = 0

    def sample(self, *, beats: int, ingest_rows: int,
               transfer_backlog: int) -> np.ndarray:
        """This host's int64 snapshot vector for one gather."""
        now = time.perf_counter()
        dt = max(1e-9, now - self._last_t)
        d_beats = max(0, int(beats) - self._last_beats)
        d_rows = max(0, int(ingest_rows) - self._last_rows)
        self._last_t = now
        self._last_beats = int(beats)
        self._last_rows = int(ingest_rows)
        vec = np.zeros((SLOTS,), np.int64)
        vec[SLOT_BEAT_MS] = round(_SCALE * 1000.0 * dt / max(1, d_beats))
        vec[SLOT_INGEST_RATE] = round(_SCALE * d_rows / dt)
        vec[SLOT_TRANSFER_BACKLOG] = round(_SCALE * max(0, int(transfer_backlog)))
        vec[SLOT_UNIX_MS] = int(time.time() * 1000.0)
        return vec

    def collect(self, *, beats: int, ingest_rows: int,
                transfer_backlog: int = 0) -> Optional[Dict[str, Any]]:
        """One cadence: sample, gather, reduce. Returns the pod record
        fields (every rank gets them — the CALLER logs on rank 0 only),
        or None when the gather yields fewer than 2 hosts."""
        vec = self.sample(beats=beats, ingest_rows=ingest_rows,
                          transfer_backlog=transfer_backlog)
        gathered = np.asarray(self._gather(vec), dtype=np.int64)
        if gathered.ndim != 2 or gathered.shape[0] < 2:
            return None
        beat = gathered[:, SLOT_BEAT_MS] / _SCALE
        rate = gathered[:, SLOT_INGEST_RATE] / _SCALE
        backlog = gathered[:, SLOT_TRANSFER_BACKLOG] / _SCALE
        unix_ms = gathered[:, SLOT_UNIX_MS].astype(float)
        straggler = detect_straggler(
            beat, z_thresh=self._z, rel_thresh=self._rel,
            min_abs_ms=self._min_abs,
        )
        if straggler >= 0:
            if self._stats is not None:
                self._stats.record_straggler(straggler)
            trace.instant(
                "pod_straggler", host=straggler,
                beat_ms=round(float(beat[straggler]), 3),
                median_ms=round(float(np.median(beat)), 3),
            )

        def fam(prefix: str, v: np.ndarray) -> Dict[str, float]:
            lo, hi = float(v.min()), float(v.max())
            return {
                f"{prefix}_min": round(lo, 3),
                f"{prefix}_max": round(hi, 3),
                f"{prefix}_spread": round(hi - lo, 3),
            }

        return {
            "pod_agg_hosts": int(gathered.shape[0]),
            **fam("pod_beat_ms", beat),
            **fam("pod_ingest_rows_per_s", rate),
            **fam("pod_transfer_backlog", backlog),
            "pod_clock_spread_ms": round(
                float(unix_ms.max() - unix_ms.min()), 3
            ),
            "pod_straggler_host": int(straggler),
        }
