"""Counters of the ingest pipeline, the transfer scheduler, the guardrails,
the device actors and the fused beat.

A trimmed copy of distributed_ddpg_tpu/metrics.py: IngestStats and
TransferStats (with the reservoir they keep their tails in),
GuardrailStats, DevActorStats and FusedBeatStats, under the JAX package's snapshot keys letter for letter,
so a record of either trainer reads the same. The port's JSONL log is
train.JsonlLog.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, List


class _Reservoir:
    """A fixed-size uniform sample of durations (Vitter's Algorithm R) and
    their exact running max: the tails of an interval of any length in
    bounded memory. Seeded, so two identical runs keep identical samples."""

    __slots__ = ("k", "n", "buf", "max", "_rng")

    def __init__(self, k: int, seed: int):
        self.k = k
        self.n = 0
        self.buf: List[float] = []
        self.max = 0.0
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        self.n += 1
        if x > self.max:
            self.max = x
        if len(self.buf) < self.k:
            self.buf.append(x)
        else:
            j = self._rng.randrange(self.n)
            if j < self.k:
                self.buf[j] = x

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir (q in [0, 1])."""
        s = sorted(self.buf)
        if not s:
            return 0.0
        return s[min(len(s) - 1, int(q * len(s)))]


class IngestStats:
    """Thread-safe counters of the replay ingest pipeline
    (replay/device.py). Producers call record_push (rows staged, and the
    time they stalled on a full staging ring); the shipper calls
    record_ship (rows and blocks moved to the device in one ship, and its
    wall time). snapshot() returns the `ingest_*` fields and starts a new
    interval:

      ingest_rows_per_sec   rows landed on the device over the interval
      ingest_rows_staged    rows pushed into the staging ring
      ingest_ship_calls     ships (one H2D copy and insert each)
      ingest_coalesce_mean  staged blocks folded into one ship (>= 1)
      ingest_stall_ms       total time producers blocked on backpressure
      ingest_ship_ms        mean wall time a ship
      ingest_queue_rows     staged rows not yet shipped
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._rows_in = 0
        self._rows_shipped = 0
        self._blocks_shipped = 0
        self._ship_calls = 0
        self._stall_s = 0.0
        self._ship_s = 0.0

    def record_push(self, rows: int, stall_s: float = 0.0) -> None:
        with self._lock:
            self._rows_in += int(rows)
            self._stall_s += stall_s

    def record_ship(self, rows: int, blocks: int, ship_s: float = 0.0) -> None:
        with self._lock:
            self._rows_shipped += int(rows)
            self._blocks_shipped += int(blocks)
            self._ship_calls += 1
            self._ship_s += ship_s

    def snapshot(self, pending_rows: int = 0, reset: bool = True) -> Dict[str, float]:
        with self._lock:
            dt = max(time.monotonic() - self._t0, 1e-9)
            calls = self._ship_calls
            out = {
                "ingest_rows_per_sec": round(self._rows_shipped / dt, 1),
                "ingest_rows_staged": self._rows_in,
                "ingest_ship_calls": calls,
                "ingest_coalesce_mean": (
                    round(self._blocks_shipped / calls, 3) if calls else 0.0
                ),
                "ingest_stall_ms": round(1000.0 * self._stall_s, 3),
                "ingest_ship_ms": (
                    round(1000.0 * self._ship_s / calls, 3) if calls else 0.0
                ),
                "ingest_queue_rows": int(pending_rows),
            }
            if reset:
                self._t0 = time.monotonic()
                self._rows_in = 0
                self._rows_shipped = 0
                self._blocks_shipped = 0
                self._ship_calls = 0
                self._stall_s = 0.0
                self._ship_s = 0.0
        return out


class TransferStats:
    """Thread-safe counters of the transfer scheduler
    (transfer/scheduler.py). Per work class it keeps items dispatched,
    bytes moved and dispatch wall time, with a seeded reservoir for the
    tail; queue depths come in at snapshot time. snapshot() returns the
    `transfer_*` fields and starts a new interval (the restart count and
    the depths are cumulative and gauges):

      transfer_dispatches        scheduled items dispatched
      transfer_<cls>_items       dispatches of a class
      transfer_<cls>_bytes       bytes it moved
      transfer_<cls>_ms          mean dispatch wall time an item
      transfer_<cls>_p95         the reservoir's p95 (ms)
      transfer_queue_<cls>       the queue's depth now
      transfer_queue_<cls>_max   the deepest it was this interval
      transfer_restarts          scheduler-thread restarts, cumulative

    The classes are the JAX package's. d2h runs inline on the caller's
    thread and is left out of transfer_dispatches; shard_exchange (sharded
    replay's beats) is accounted but nothing in the port submits it yet.
    """

    SCHEDULED = ("lockstep", "shard_exchange", "ingest", "prefetch", "serve")
    CLASSES = SCHEDULED + ("d2h",)

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = seed
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._items = {c: 0 for c in self.CLASSES}
        self._bytes = {c: 0 for c in self.CLASSES}
        self._time_s = {c: 0.0 for c in self.CLASSES}
        self._res = {
            c: _Reservoir(64, (zlib.crc32(c.encode()) ^ self._seed) & 0x7FFFFFFF)
            for c in self.CLASSES
        }
        self._depth_max = {c: 0 for c in self.SCHEDULED}

    def record_dispatch(self, cls: str, nbytes: int, dur_s: float) -> None:
        with self._lock:
            if cls not in self._items:
                return
            self._items[cls] += 1
            self._bytes[cls] += int(nbytes)
            self._time_s[cls] += dur_s
            self._res[cls].add(dur_s)

    def record_queue_depth(self, cls: str, depth: int) -> None:
        with self._lock:
            if cls in self._depth_max and depth > self._depth_max[cls]:
                self._depth_max[cls] = depth

    def snapshot(self, queue_depths=None, restarts: int = 0,
                 reset: bool = True) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {
                "transfer_dispatches": sum(self._items[c] for c in self.SCHEDULED),
                "transfer_restarts": int(restarts),
            }
            for c in self.CLASSES:
                n = self._items[c]
                out[f"transfer_{c}_items"] = n
                out[f"transfer_{c}_bytes"] = self._bytes[c]
                out[f"transfer_{c}_ms"] = (
                    round(1000.0 * self._time_s[c] / n, 3) if n else 0.0
                )
                out[f"transfer_{c}_p95"] = round(
                    1000.0 * self._res[c].percentile(0.95), 3
                )
            for c, d in (queue_depths or {}).items():
                out[f"transfer_queue_{c}"] = int(d)
            for c, d in self._depth_max.items():
                out[f"transfer_queue_{c}_max"] = int(d)
            if reset:
                self._reset_locked()
        return out


class GuardrailStats:
    """The host's numerical-health counters (guardrails.py): the
    `guardrail_*` fields of every train and final record when guardrails
    are on. Cumulative:

      guardrail_anomalies          anomalous learner steps (nonfinite +
                                   z-score spikes), the rollback trigger's
                                   input
      guardrail_nonfinite_steps    steps skipped for a non-finite td, grad
                                   or param value
      guardrail_loss_spikes        steps skipped by the EWMA z-score
                                   detector (finite but absurd)
      guardrail_skipped_updates    updates dropped on the device
      guardrail_bad_rows           non-finite sampled replay rows seen
      guardrail_rollbacks          checkpoint rollback-repairs taken
      guardrail_last_rollback_step the step the latest rollback restored
                                   (-1 = none)
      guardrail_lr_cooldowns       LR backoff -> restore cycles completed
      guardrail_source_quarantines ingest sources quarantined for
                                   repeatedly feeding non-finite rows

    `absorb(health)` takes the device probe's cumulative counters and
    returns the DELTA since the previous read: the rolling window's input
    for the rollback trigger (train.py)."""

    def __init__(self):
        self.nonfinite = 0
        self.spikes = 0
        self.skipped = 0
        self.bad_rows = 0
        self.total_steps = 0
        self.rollbacks = 0
        self.last_rollback_step = -1
        self.lr_cooldowns = 0
        self.source_quarantines = 0

    def absorb(self, health: Dict[str, int]) -> Dict[str, int]:
        delta = {
            "nonfinite": int(health.get("nonfinite", 0)) - self.nonfinite,
            "spikes": int(health.get("spikes", 0)) - self.spikes,
            "skipped": int(health.get("skipped", 0)) - self.skipped,
            "bad_rows": int(health.get("bad_rows", 0)) - self.bad_rows,
        }
        self.nonfinite = int(health.get("nonfinite", 0))
        self.spikes = int(health.get("spikes", 0))
        self.skipped = int(health.get("skipped", 0))
        self.bad_rows = int(health.get("bad_rows", 0))
        self.total_steps = int(health.get("total", 0))
        delta["anomalies"] = delta["nonfinite"] + delta["spikes"]
        return delta

    def record_rollback(self, step: int) -> None:
        self.rollbacks += 1
        self.last_rollback_step = int(step)

    def record_lr_cooldown(self) -> None:
        self.lr_cooldowns += 1

    def record_source_quarantine(self) -> None:
        self.source_quarantines += 1

    def snapshot(self) -> Dict[str, int]:
        return {
            "guardrail_anomalies": self.nonfinite + self.spikes,
            "guardrail_nonfinite_steps": self.nonfinite,
            "guardrail_loss_spikes": self.spikes,
            "guardrail_skipped_updates": self.skipped,
            "guardrail_bad_rows": self.bad_rows,
            "guardrail_rollbacks": self.rollbacks,
            "guardrail_last_rollback_step": self.last_rollback_step,
            "guardrail_lr_cooldowns": self.lr_cooldowns,
            "guardrail_source_quarantines": self.source_quarantines,
        }


# Durations a reservoir keeps (the JAX package's PhaseTimers.RESERVOIR_K).
RESERVOIR_K = 256


class DevActorStats:
    """The device actors' counters (actors/device_pool.py): the
    `devactor_*` fields of every train and final record when
    actor_backend='device'. Throughput and the dispatch tails are the
    interval's (each snapshot starts a new one); the env steps, episodes
    and restarts are cumulative:

      devactor_rows_per_s   rows landed in the ring over the interval
      devactor_chunks       rollout dispatches in the interval
      devactor_chunk_ms     mean host time a rollout dispatch (its enqueue
                            and the insert's; the device work runs behind
                            it on the stream)
      devactor_chunk_p50/p95/max
                            reservoir tails of the same
      devactor_env_steps    env steps the pool produced
      devactor_episodes     finished episodes
      devactor_episode_return
                            mean return of the episodes finished in the
                            interval
      devactor_restarts     bounded-restart recoveries
    """

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = seed
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._t0 = time.monotonic()
        self._rows = 0
        self._chunks = 0
        self._dur_s = 0.0
        self._res = _Reservoir(RESERVOIR_K,
                               (zlib.crc32(b"devactor_chunk") ^ self._seed) & 0x7FFFFFFF)

    def record_chunk(self, rows: int, dur_s: float) -> None:
        with self._lock:
            self._rows += int(rows)
            self._chunks += 1
            self._dur_s += dur_s
            self._res.add(dur_s)

    def snapshot(self, reset: bool = True) -> Dict[str, float]:
        with self._lock:
            dt = max(time.monotonic() - self._t0, 1e-9)
            n = self._chunks
            out = {
                "devactor_rows_per_s": round(self._rows / dt, 1),
                "devactor_chunks": n,
                "devactor_chunk_ms": round(1000.0 * self._dur_s / n, 3) if n else 0.0,
                "devactor_chunk_p50": round(1000.0 * self._res.percentile(0.50), 3),
                "devactor_chunk_p95": round(1000.0 * self._res.percentile(0.95), 3),
                "devactor_chunk_max": round(1000.0 * self._res.max, 3),
            }
            if reset:
                self._reset_locked()
        return out


class FusedBeatStats:
    """The fused beat's counters (parallel/megastep.py, superstep.py): the
    `fused_*` fields of every train and final record when the beat is
    active, all the interval's:

      fused_beats           beats in the interval
      fused_steps_per_s     learner steps over the interval
      fused_rows_per_s      rollout rows landed over the interval
      fused_beat_ms         mean host time a dispatch (a beat, or a
                            superstep of B beats)
      fused_beat_p50/p95/max
                            reservoir tails of the same
      fused_supersteps      dispatches in the interval (fused_beats / B)
      fused_superstep_beats beats a dispatch (B; 1.0 for the plain beat)
    """

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = seed
        self._total_beats = 0
        self._total_supersteps = 0
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._t0 = time.monotonic()
        self._beats = 0
        self._supersteps = 0
        self._steps = 0
        self._rows = 0
        self._dur_s = 0.0
        self._res = _Reservoir(RESERVOIR_K,
                               (zlib.crc32(b"fused_beat") ^ self._seed) & 0x7FFFFFFF)

    def record_beat(self, learn_steps: int, rows: int, dur_s: float, beats: int = 1) -> None:
        """One call a dispatch: a B-beat superstep records its B beats."""
        with self._lock:
            self._beats += int(beats)
            self._supersteps += 1
            self._total_beats += int(beats)
            self._total_supersteps += 1
            self._steps += int(learn_steps)
            self._rows += int(rows)
            self._dur_s += dur_s
            self._res.add(dur_s)

    def snapshot(self, reset: bool = True) -> Dict[str, float]:
        with self._lock:
            dt = max(time.monotonic() - self._t0, 1e-9)
            n = self._beats
            out = {
                "fused_beats": n,
                "fused_steps_per_s": round(self._steps / dt, 1),
                "fused_rows_per_s": round(self._rows / dt, 1),
                "fused_beat_ms": round(1000.0 * self._dur_s / n, 3) if n else 0.0,
                "fused_beat_p50": round(1000.0 * self._res.percentile(0.50), 3),
                "fused_beat_p95": round(1000.0 * self._res.percentile(0.95), 3),
                "fused_beat_max": round(1000.0 * self._res.max, 3),
                "fused_supersteps": self._supersteps,
                "fused_superstep_beats": (round(n / self._supersteps, 2)
                                          if self._supersteps else 0.0),
            }
            if reset:
                self._reset_locked()
        return out

    def totals(self) -> Dict[str, float]:
        """The whole run's beats and dispatches (the summary's fields)."""
        with self._lock:
            n, d = self._total_beats, self._total_supersteps
            return {"fused_beats": n, "fused_supersteps": d,
                    "fused_superstep_beats": round(n / d, 2) if d else 0.0}
