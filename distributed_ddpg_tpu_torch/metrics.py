"""Structured metrics: the JSONL logger, the per-phase timers and the
counters of the ingest pipeline, the transfer scheduler, the guardrails,
the device actors, the fused beat and the serving stack.

A counterpart of distributed_ddpg_tpu/metrics.py: MetricsLogger (JSONL to
a file and stdout, the latest record of each kind for the exporter's
/metrics, and a TensorBoard sink with tb_dir), PhaseTimers (each phase's
mean, count and reservoir tails, and a flight-recorder span), Timer (the
rate meter), IngestStats and TransferStats (with the reservoir they keep
their tails in), GuardrailStats, DevActorStats, FusedBeatStats, and
ServeStats, FrontStats and TenantStats (serve/), PodStats, SupervisorStats,
ReplayShardStats (the sharded replay's placement) and MeshStats (the rank
grid's placement, `mesh_*`), under the JAX
package's snapshot keys letter for letter, so a record of either trainer
reads the same. Nothing here imports torch at import time.
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
import warnings
import zlib
from contextlib import contextmanager
from typing import Any, Dict, List

from distributed_ddpg_tpu_torch import trace


class MetricsLogger:
    """One JSON object a line to stdout (with `echo`) and, when given, a
    file; the latest record of each kind for the exporter's /metrics
    (obs/exporter.py); with `tb_dir`, every numeric field as a TensorBoard
    scalar `<kind>/<field>`. The stream opens with one `header` record
    carrying the absolute wall-clock base (`t_unix_base`) and the caller's
    `header` fields (the trainer's replay placement): `wall_time` is
    seconds since the logger's creation, so t_unix_base + wall_time is an
    event's absolute time."""

    def __init__(self, path: str = "", echo: bool = True, tb_dir: str = "",
                 header: Dict[str, Any] = None):
        self._file = open(path, "a", buffering=1) if path else None
        self._echo = echo
        self._t0 = time.time()
        # log() may be called from more than one thread; the sinks are
        # serialized so JSONL lines never interleave.
        self._lock = threading.Lock()
        self._latest: Dict[str, Dict[str, Any]] = {}
        self._tb = None
        if tb_dir:
            try:
                # Its event writer needs no tensors for scalars.
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tb_dir)
            except Exception as e:  # JSONL only, said once (the JAX package's rule)
                warnings.warn(f"tb_dir={tb_dir!r} requested but TensorBoard "
                              f"writer unavailable: {e}")
        self.t_unix_base = round(self._t0, 6)
        self.log("header", 0, t_unix_base=self.t_unix_base, pid=os.getpid(), **(header or {}))

    def log(self, kind: str, step: int, **fields: Any) -> Dict[str, Any]:
        rec = {
            "kind": kind,
            "step": step,
            "wall_time": round(time.time() - self._t0, 3),
            **{k: _jsonable(v) for k, v in fields.items()},
        }
        line = json.dumps(rec)
        with self._lock:
            self._latest[kind] = rec
            if self._file:
                self._file.write(line + "\n")
            if self._echo:
                print(line, file=sys.stdout, flush=True)
            if self._tb is not None:
                for k, v in rec.items():
                    if k in ("kind", "step") or not isinstance(v, (int, float)):
                        continue
                    self._tb.add_scalar(f"{kind}/{k}", v, step)
        return rec

    def latest(self) -> Dict[str, Dict[str, Any]]:
        """{kind: the most recent record}, the /metrics render source;
        shallow-copied so the scrape thread iterates a stable dict."""
        with self._lock:
            return dict(self._latest)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


def _jsonable(v):
    """A JSONL field's value: bools and ints pass as their type, numpy and
    torch zero-dim scalars are unwrapped to theirs, other numbers become
    floats rounded to 6 decimals (which bounds a record's size), and
    everything else passes unchanged."""
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return v
    if hasattr(v, "item") and not hasattr(v, "__len__"):
        try:
            return _jsonable(v.item())
        except (TypeError, ValueError):
            return v
    try:
        return round(float(v), 6)
    except (TypeError, ValueError):
        return v


class Timer:
    """Running rate meter on the monotonic clock: a wall-clock jump must
    not spike or zero the reported rate."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t = time.monotonic()
        self._n = 0

    def tick(self, n: int = 1) -> None:
        self._n += n

    def rate(self) -> float:
        dt = time.monotonic() - self._t
        return self._n / dt if dt > 0 else 0.0

    def exclude(self, seconds: float) -> None:
        """Drop off-path work (an inline eval) from the measured window."""
        self._t += seconds


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


class ReplayShardStats:
    """Thread-safe counters of the device replay's placement layer
    (replay/device.py; the JAX package's ReplayShardStats, the same keys):
    the `replay_*` family of every train and final record on the device
    replay's path. Every figure is measured on the rank that reports it:

      replay_ingest_bytes          host-to-device bytes this rank landed
                                   into its storage this interval (the
                                   bytes of the host rows it copied)
      replay_ingest_bytes_per_row  the interval's landed bytes over the
                                   ring rows the ships advanced it by:
                                   width*4 replicated, width*4/D sharded
      replay_shard_count           gauge: the ring's shards (1 = replicated)
      replay_device_storage_bytes  gauge: the bytes of this rank's storage
                                   tensor (capacity*width*4/D sharded)
      replay_shard_fill_min/max    gauge: live rows on the emptiest and the
                                   fullest shard, from each shard's own
                                   count of the rows it landed
      replay_exchange_ms_p50/p95   the interval's ship tails (host clock)
    """

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = seed
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._rows = 0
        self._bytes = 0
        self._res = _Reservoir(RESERVOIR_K,
                               (zlib.crc32(b"replay_exchange") ^ self._seed) & 0x7FFFFFFF)

    def record_ship(self, rows: int, nbytes: int, dur_s: float) -> None:
        with self._lock:
            self._rows += int(rows)
            self._bytes += int(nbytes)
            self._res.add(dur_s)

    def snapshot(self, n_shards: int = 1, device_storage_bytes: int = 0,
                 fill_min: int = 0, fill_max: int = 0,
                 reset: bool = True) -> Dict[str, float]:
        with self._lock:
            rows = self._rows
            out = {
                "replay_ingest_bytes": self._bytes,
                "replay_ingest_bytes_per_row": (
                    round(self._bytes / rows, 2) if rows else 0.0),
                "replay_shard_count": int(n_shards),
                "replay_device_storage_bytes": int(device_storage_bytes),
                "replay_shard_fill_min": int(fill_min),
                "replay_shard_fill_max": int(fill_max),
                "replay_exchange_ms_p50": round(1000.0 * self._res.percentile(0.50), 3),
                "replay_exchange_ms_p95": round(1000.0 * self._res.percentile(0.95), 3),
            }
            if reset:
                self._reset_locked()
        return out


class MeshStats:
    """Placement facts for the (data, model) rank grid (parallel/mesh.py,
    parallel/partition.py): the `mesh_*` family of every train and final
    record (JAX metrics.py:377-430), gauges read from the leaves' shapes
    alone (no device work, no collective):

      mesh_data_axis               the grid's data-parallel degree D
      mesh_model_axis              its tensor-parallel degree M
      mesh_param_bytes_per_device  the TrainState's bytes (params, targets,
                                   both Adam states, counts) this rank holds
      mesh_param_bytes_total       the logical (unsharded) TrainState's bytes

    A rank's leaves are its shards: a sharded leaf's logical bytes are its
    shard's times M, a replicated leaf's its own."""

    def __init__(self, data_axis: int, model_axis: int):
        self._data = int(data_axis)
        self._model = int(model_axis)

    def snapshot(self, state_leaves, sharded=None) -> Dict[str, float]:
        """The four fields for a rank's `state_leaves`; `sharded` marks the
        leaves that are shards (None: every leaf whole)."""
        leaves = list(state_leaves)
        flags = [False] * len(leaves) if sharded is None else list(sharded)
        per_device = total = 0
        for leaf, is_shard in zip(leaves, flags):
            n = 1
            for d in tuple(getattr(leaf, "shape", ())):
                n *= int(d)
            nbytes = n * int(getattr(leaf, "itemsize", None) or leaf.element_size())
            per_device += nbytes
            total += nbytes * (self._model if is_shard else 1)
        return {
            "mesh_data_axis": self._data,
            "mesh_model_axis": self._model,
            "mesh_param_bytes_per_device": per_device,
            "mesh_param_bytes_total": total,
        }


class PodStats:
    """Thread-safe pod-resilience counters (parallel/multihost.py; the
    JAX package's PodStats, the same fields) — the `pod_*` family every
    train/final JSONL record carries on a pod (more than one node). Counters are CUMULATIVE
    (peer loss and aborts are rare, terminal events; interval-resetting
    them would hide the one record that matters):

      pod_peer_lost               collectives declared lost (deadline
                                  timeout or mid-flight transport error)
      pod_aborts                  coordinated clean aborts taken (the
                                  EXIT_POD_DEGRADED path)
      pod_resume_step_elected     the step the coordinated resume election
                                  agreed on (-1 = no election ran / no
                                  common step)
      pod_beats                   heartbeat-bearing lockstep beats gathered
      pod_collective_near_misses  guarded collectives that consumed > 80%
                                  of their deadline (the tune-the-timeout
                                  signal BEFORE a false PodPeerLost)
      pod_collective_slack_p95_ms deadline headroom at the p95-slowest
                                  collective (deadline - p95 elapsed);
                                  trending toward 0 = deadline too tight

    Elastic-pod events (the sharded replay's all-writer slices, adopted
    at a restart; train.py):

      pod_slices_adopted          replay slice sets adopted at restore
                                  (all-writer checkpoints)
      pod_slice_adopted_step      the step the adopted slice set was
                                  written at (-1 = none; may trail the
                                  elected resume step — replay is allowed
                                  to be a few cadences staler)
      pod_shrinks                 restarts that adopted a slice set from
                                  a LARGER world (training continues at
                                  reduced membership -> degraded)
      pod_grows                   restarts that resharded a smaller
                                  world's slices back up (rejoin ->
                                  healthy)
      pod_state_degraded          1 while the pod trains below the slice
                                  set's writer count, 0 once grown back

    Straggler attribution (obs/aggregate.py):

      pod_stragglers              cadences on which the per-host beat-time
                                  detector attributed a straggling host
      pod_straggler_host          the most recently attributed host index
                                  (-1 = never attributed)
    """

    NEAR_MISS_FRAC = 0.8

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.peer_lost = 0
        self.aborts = 0
        self.resume_step_elected = -1
        self.beats = 0
        self.near_misses = 0
        self.slices_adopted = 0
        self.slice_adopted_step = -1
        self.shrinks = 0
        self.grows = 0
        self.degraded = False
        self.stragglers = 0
        self.straggler_host = -1
        self._deadline_s = 0.0
        self._elapsed = _Reservoir(
            64, (zlib.crc32(b"pod_collective") ^ seed) & 0x7FFFFFFF
        )

    def record_collective(self, elapsed_s: float, deadline_s: float) -> None:
        with self._lock:
            self._deadline_s = deadline_s
            self._elapsed.add(elapsed_s)
            if elapsed_s > self.NEAR_MISS_FRAC * deadline_s:
                self.near_misses += 1

    def record_peer_lost(self) -> None:
        with self._lock:
            self.peer_lost += 1

    def record_abort(self) -> None:
        with self._lock:
            self.aborts += 1

    def record_resume_elected(self, step: int) -> None:
        with self._lock:
            self.resume_step_elected = int(step)

    def record_slice_adopted(self, step: int) -> None:
        with self._lock:
            self.slices_adopted += 1
            self.slice_adopted_step = int(step)

    def record_shrink(self) -> None:
        """Adopted a slice set written by a LARGER world: the pod keeps
        training at reduced membership in a typed degraded state."""
        with self._lock:
            self.shrinks += 1
            self.degraded = True

    def record_grow(self) -> None:
        """Resharded a smaller world's slices back up (rejoin): degraded
        clears — the pod is healthy at its new membership."""
        with self._lock:
            self.grows += 1
            self.degraded = False

    def record_straggler(self, host: int) -> None:
        """One straggler attribution from the pod aggregator's per-host
        beat-time detector (obs/aggregate.py)."""
        with self._lock:
            self.stragglers += 1
            self.straggler_host = int(host)

    def elastic_events(self) -> int:
        """Nonzero when any elastic transition happened — the gate for
        surfacing pod_* fields on runs that shrank to one process
        (train_jax logs pod fields when is_multi OR this)."""
        with self._lock:
            return self.slices_adopted + self.shrinks + self.grows

    def note_beat(self) -> None:
        with self._lock:
            self.beats += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            slack_ms = 0.0
            if self._elapsed.buf and self._deadline_s > 0:
                slack_ms = round(
                    1000.0
                    * (self._deadline_s - self._elapsed.percentile(0.95)),
                    3,
                )
            return {
                "pod_peer_lost": self.peer_lost,
                "pod_aborts": self.aborts,
                "pod_resume_step_elected": self.resume_step_elected,
                "pod_beats": self.beats,
                "pod_collective_near_misses": self.near_misses,
                "pod_collective_slack_p95_ms": slack_ms,
                "pod_slices_adopted": self.slices_adopted,
                "pod_slice_adopted_step": self.slice_adopted_step,
                "pod_shrinks": self.shrinks,
                "pod_grows": self.grows,
                "pod_state_degraded": int(self.degraded),
                "pod_stragglers": self.stragglers,
                "pod_straggler_host": self.straggler_host,
            }


class SupervisorStats:
    """Thread-safe pod-supervisor counters (supervisor/core.py; the JAX
    package's SupervisorStats, the same fields) — the `supervisor_*` family
    the supervisor's JSONL event stream carries on its final record, so
    a long soak's whole restart history is auditable from one line.
    CUMULATIVE across generations, like PodStats (every event here is a
    rare, decision-bearing transition):

      supervisor_generations      pod generations launched (gen 1 counts)
      supervisor_spawns           child processes spawned, all generations
      supervisor_relaunches       same-membership relaunches (70/75/76 or
                                  untyped crashes)
      supervisor_shrinks          shrink relaunches taken on exit 78
                                  (membership reduced to the survivors)
      supervisor_grows            health-gated grow relaunches (stop-the-
                                  world resize back toward full strength)
      supervisor_backoffs         exponential-backoff waits served
      supervisor_backoff_wait_s   total seconds spent in those waits
      supervisor_breaker_trips    crash-loop circuit-breaker trips (each
                                  one is terminal: the SupervisorGaveUp
                                  report path)
      supervisor_numeric_refusals numeric aborts (77) refused past the
                                  supervisor_max_numeric budget
      supervisor_probe_ready      lost-peer slots that cleared the
                                  K-consecutive-healthy rejoin gate
      supervisor_probe_flaps      healthy->unhealthy probe regressions
                                  (each restarts that slot's gate)
      supervisor_gave_up          1 once the supervisor exited through
                                  the typed give-up path, else 0
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.generations = 0
        self.spawns = 0
        self.relaunches = 0
        self.shrinks = 0
        self.grows = 0
        self.backoffs = 0
        self.backoff_wait_s = 0.0
        self.breaker_trips = 0
        self.numeric_refusals = 0
        self.probe_ready = 0
        self.probe_flaps = 0
        self.gave_up = False

    def record_generation(self, nprocs: int) -> None:
        with self._lock:
            self.generations += 1
            self.spawns += int(nprocs)

    def record_relaunch(self) -> None:
        with self._lock:
            self.relaunches += 1

    def record_shrink(self) -> None:
        with self._lock:
            self.shrinks += 1

    def record_grow(self) -> None:
        with self._lock:
            self.grows += 1

    def record_backoff(self, wait_s: float) -> None:
        with self._lock:
            self.backoffs += 1
            self.backoff_wait_s = round(self.backoff_wait_s + wait_s, 3)

    def record_breaker_trip(self) -> None:
        with self._lock:
            self.breaker_trips += 1
            self.gave_up = True

    def record_numeric_refusal(self) -> None:
        with self._lock:
            self.numeric_refusals += 1
            self.gave_up = True

    def record_probe_ready(self) -> None:
        with self._lock:
            self.probe_ready += 1

    def record_probe_flap(self) -> None:
        with self._lock:
            self.probe_flaps += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "supervisor_generations": self.generations,
                "supervisor_spawns": self.spawns,
                "supervisor_relaunches": self.relaunches,
                "supervisor_shrinks": self.shrinks,
                "supervisor_grows": self.grows,
                "supervisor_backoffs": self.backoffs,
                "supervisor_backoff_wait_s": self.backoff_wait_s,
                "supervisor_breaker_trips": self.breaker_trips,
                "supervisor_numeric_refusals": self.numeric_refusals,
                "supervisor_probe_ready": self.probe_ready,
                "supervisor_probe_flaps": self.probe_flaps,
                "supervisor_gave_up": int(self.gave_up),
            }


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


class PhaseTimers:
    """Per-phase wall time and tails of the driver's phases (the JAX
    package's PhaseTimers). Phases are whatever the caller brackets; the
    trainer's are dispatch (a chunk's enqueue: on the card a launch
    returns at once, and the wait shows in sync or metrics_d2h), ingest,
    sync (a metrics read), sample_wait, refresh, prio_update, devactor,
    ckpt and eval_snapshot. snapshot() returns the interval's fields and
    starts a new one:

      t_<name>_ms    mean ms a call
      n_<name>       calls in the interval
      t_<name>_p50 / t_<name>_p95 / t_<name>_max
                     reservoir percentiles and the exact max, ms

    Each bracket also opens a flight-recorder span (trace.py) under the
    phase's name. The host's clock: none of these is a device time."""

    RESERVOIR_K = RESERVOIR_K

    def __init__(self, seed: int = 0):
        self._acc: Dict[str, float] = {}
        self._n: Dict[str, int] = {}
        self._res: Dict[str, _Reservoir] = {}
        self._seed = seed

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with trace.span(name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._acc[name] = self._acc.get(name, 0.0) + dt
                self._n[name] = self._n.get(name, 0) + 1
                r = self._res.get(name)
                if r is None:
                    # Seeded from the phase's name with crc32 (str hashing
                    # is salted per interpreter) and the seed, so which
                    # samples the reservoir keeps is the same run to run.
                    r = self._res[name] = _Reservoir(
                        self.RESERVOIR_K,
                        (zlib.crc32(name.encode()) ^ self._seed) & 0x7FFFFFFF,
                    )
                r.add(dt)

    def snapshot(self, reset: bool = True) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, total in self._acc.items():
            n = max(self._n.get(name, 1), 1)
            out[f"t_{name}_ms"] = round(1000.0 * total / n, 3)
            out[f"n_{name}"] = self._n.get(name, 0)
            r = self._res.get(name)
            if r is not None and r.buf:
                out[f"t_{name}_p50"] = round(1000.0 * r.percentile(0.50), 3)
                out[f"t_{name}_p95"] = round(1000.0 * r.percentile(0.95), 3)
                out[f"t_{name}_max"] = round(1000.0 * r.max, 3)
        if reset:
            self._acc.clear()
            self._n.clear()
            self._res.clear()
        return out


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
      devactor_gather_ms    (envs sharded over D > 1 ranks) mean host time
                            of a rollout's gather over the data group, a
                            part of devactor_chunk_ms (under gloo it waits
                            for the rollout's device work it reads)

    The env steps are global on every rank (a rollout's K x E rows, every
    rank's envs); the chunk and gather times are this rank's own.
    """

    def __init__(self, seed: int = 0, gather: bool = False):
        self._lock = threading.Lock()
        self._seed = seed
        self._gather = bool(gather)
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._t0 = time.monotonic()
        self._rows = 0
        self._chunks = 0
        self._dur_s = 0.0
        self._res = _Reservoir(RESERVOIR_K,
                               (zlib.crc32(b"devactor_chunk") ^ self._seed) & 0x7FFFFFFF)
        self._gathers = 0
        self._gather_s = 0.0

    def record_gather(self, dur_s: float) -> None:
        with self._lock:
            self._gathers += 1
            self._gather_s += dur_s

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
            if self._gather:
                out["devactor_gather_ms"] = (round(1000.0 * self._gather_s / self._gathers, 3)
                                             if self._gathers else 0.0)
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


def _seeded_reservoir(name: str, seed: int) -> _Reservoir:
    """A RESERVOIR_K reservoir seeded from its name (crc32, not hash(): str
    hashing is salted per interpreter) and the stats' seed, as the JAX
    package's PhaseTimers seeds its phases."""
    return _Reservoir(RESERVOIR_K, (zlib.crc32(name.encode()) ^ seed) & 0x7FFFFFFF)


class ServeStats:
    """Thread-safe counters of the batched policy-inference service
    (serve/): the `serve_*` fields of every train and final record when
    serving is armed, and the digest of tools/serve_bench.py. The counters
    are cumulative; the latency, batch-fill and queue-depth tails are the
    interval's (each snapshot starts a new one):

      serve_requests        requests accepted by the batcher
      serve_batches         batches dispatched
      serve_overloads       submissions the bounded queue refused
                            (typed ServeOverload backpressure)
      serve_errors          batch dispatches that failed; every request of
                            the batch got a typed error
      serve_param_refreshes params reloaded (broadcast buffer or refresh())
      serve_fill_mean       rows a dispatched batch / max_batch, whole run
      serve_fill_p50/p95    the interval's batch-fill tails
      serve_p50_ms/p95_ms/max_ms
                            the interval's request latency, enqueue to
                            response delivered
      serve_queue_depth     the request queue's depth at snapshot (gauge)
      serve_queue_depth_p95 the interval's p95 of the depth at each submit
    """

    def __init__(self, seed: int = 0, max_batch: int = 1):
        self._lock = threading.Lock()
        self._seed = seed
        self.max_batch = max(1, int(max_batch))
        self.requests = 0
        self.batches = 0
        self.batch_rows = 0
        self.overloads = 0
        self.errors = 0
        self.refreshes = 0
        self._reset_reservoirs()

    def _reset_reservoirs(self) -> None:
        self._lat = _seeded_reservoir("serve_latency", self._seed)
        self._fill = _seeded_reservoir("serve_fill", self._seed)
        self._depth = _seeded_reservoir("serve_depth", self._seed)

    def record_request(self, queue_depth: int) -> None:
        with self._lock:
            self.requests += 1
            self._depth.add(float(queue_depth))

    def record_batch(self, rows: int, latencies_s) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += int(rows)
            self._fill.add(rows / self.max_batch)
            for lat in latencies_s:
                self._lat.add(lat)

    def record_overload(self) -> None:
        with self._lock:
            self.overloads += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_refresh(self) -> None:
        with self._lock:
            self.refreshes += 1

    def snapshot(self, queue_depth: int = 0, reset: bool = True) -> Dict[str, float]:
        with self._lock:
            out = {
                "serve_requests": self.requests,
                "serve_batches": self.batches,
                "serve_overloads": self.overloads,
                "serve_errors": self.errors,
                "serve_param_refreshes": self.refreshes,
                "serve_fill_mean": (
                    round(self.batch_rows / (self.batches * self.max_batch), 4)
                    if self.batches else 0.0
                ),
                "serve_fill_p50": round(self._fill.percentile(0.50), 4),
                "serve_fill_p95": round(self._fill.percentile(0.95), 4),
                "serve_p50_ms": round(1000.0 * self._lat.percentile(0.50), 3),
                "serve_p95_ms": round(1000.0 * self._lat.percentile(0.95), 3),
                "serve_max_ms": round(1000.0 * self._lat.max, 3),
                "serve_queue_depth": int(queue_depth),
                "serve_queue_depth_p95": round(self._depth.percentile(0.95), 3),
            }
            if reset:
                self._reset_reservoirs()
        return out


class FrontStats:
    """Thread-safe counters of the network serving front (serve/front/):
    the `front_*` fields of every train and final record when the front is
    armed, and the digest of tools/serve_bench.py --transport socket. The
    counters are cumulative; the wire-latency tail is the interval's:

      front_requests        frames accepted over TCP
      front_http_requests   requests accepted over the HTTP adapter (not a
                            subset of front_requests)
      front_bad_frames      undecodable or oversized frames, answered with
                            a typed bad_frame error
      front_sheds           requests the per-tenant QoS refused before the
                            batcher (TenantStats splits them by cause)
      front_overloads       requests the batcher's bounded queue refused
                            past QoS admission
      front_timeouts        requests that missed front_timeout_s
      front_errors          dispatch failures surfaced as typed errors
      front_canary_requests requests the canary split routed to the
                            candidate version
      front_promotes        candidates promoted by the live gate
      front_rollbacks       candidates rolled back by the gate
      front_wire_p50_ms/front_wire_p95_ms/front_wire_max_ms
                            the interval's wire latency, frame decoded to
                            response queued
    """

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = seed
        self.requests = 0
        self.http_requests = 0
        self.bad_frames = 0
        self.sheds = 0
        self.overloads = 0
        self.timeouts = 0
        self.errors = 0
        self.canary_requests = 0
        self.promotes = 0
        self.rollbacks = 0
        self._reset_reservoirs()

    def _reset_reservoirs(self) -> None:
        self._wire = _seeded_reservoir("front_wire", self._seed)

    def record_request(self, http: bool = False) -> None:
        with self._lock:
            if http:
                self.http_requests += 1
            else:
                self.requests += 1

    def record_bad_frame(self) -> None:
        with self._lock:
            self.bad_frames += 1

    def record_shed(self) -> None:
        with self._lock:
            self.sheds += 1

    def record_overload(self) -> None:
        with self._lock:
            self.overloads += 1

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_canary_request(self) -> None:
        with self._lock:
            self.canary_requests += 1

    def record_promote(self) -> None:
        with self._lock:
            self.promotes += 1

    def record_rollback(self) -> None:
        with self._lock:
            self.rollbacks += 1

    def record_wire_latency(self, seconds: float) -> None:
        with self._lock:
            self._wire.add(float(seconds))

    def snapshot(self, reset: bool = True) -> Dict[str, float]:
        with self._lock:
            out = {
                "front_requests": self.requests,
                "front_http_requests": self.http_requests,
                "front_bad_frames": self.bad_frames,
                "front_sheds": self.sheds,
                "front_overloads": self.overloads,
                "front_timeouts": self.timeouts,
                "front_errors": self.errors,
                "front_canary_requests": self.canary_requests,
                "front_promotes": self.promotes,
                "front_rollbacks": self.rollbacks,
                "front_wire_p50_ms": round(1000.0 * self._wire.percentile(0.50), 3),
                "front_wire_p95_ms": round(1000.0 * self._wire.percentile(0.95), 3),
                "front_wire_max_ms": round(1000.0 * self._wire.max, 3),
            }
            if reset:
                self._reset_reservoirs()
        return out


class TenantStats:
    """Thread-safe per-tenant QoS counters (serve/front/qos.py): the
    `tenant_*` fields, all cumulative (shed ordering is a contract over
    the run; per_tenant() is its evidence):

      tenant_count          distinct tenants seen
      tenant_served         requests admitted past QoS
      tenant_shed_rate      requests shed by a tenant's token bucket
      tenant_shed_priority  requests shed by priority-ordered overload
                            protection
      tenant_shed_total     the two together
      tenant_errors         typed errors returned after admission
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict[str, int]] = {}

    def _row(self, tenant: str) -> Dict[str, int]:
        row = self._tenants.get(tenant)
        if row is None:
            row = {"served": 0, "shed_rate": 0, "shed_priority": 0, "errors": 0}
            self._tenants[tenant] = row
        return row

    def record_served(self, tenant: str) -> None:
        with self._lock:
            self._row(tenant)["served"] += 1

    def record_shed(self, tenant: str, cause: str) -> None:
        """cause: 'rate' (token bucket) or 'priority' (overload shed)."""
        with self._lock:
            self._row(tenant)["shed_rate" if cause == "rate" else "shed_priority"] += 1

    def record_error(self, tenant: str) -> None:
        with self._lock:
            self._row(tenant)["errors"] += 1

    def per_tenant(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {t: dict(row) for t, row in self._tenants.items()}

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            rows = list(self._tenants.values())
            shed_rate = sum(r["shed_rate"] for r in rows)
            shed_priority = sum(r["shed_priority"] for r in rows)
            return {
                "tenant_count": len(rows),
                "tenant_served": sum(r["served"] for r in rows),
                "tenant_shed_rate": shed_rate,
                "tenant_shed_priority": shed_priority,
                "tenant_shed_total": shed_rate + shed_priority,
                "tenant_errors": sum(r["errors"] for r in rows),
            }
