"""The superstep: B fused beats a dispatch, their stats read back once.

Counterpart of distributed_ddpg_tpu/parallel/superstep.py
(config.superstep_beats). The fused beat (parallel/megastep.py) still
returns to the host once a beat for its health and its metrics; here the
host enqueues B beats in a row (the SAME beat body, so a superstep is
bit-identical to B beats by construction) and stacks each beat's metrics
([B, 6], METRIC_KEYS order) and, guarded, its cumulative health word
([B, 5]) and bad-row captures ([B, 32]) on the device. At the end ONE
device-to-host copy reads the metrics and the health together; the
learner's poll_health then reads that host copy (note_fused_health) and
reports the last row's counters and the first beat whose anomaly count
moved (`first_bad_beat`). Quarantine stays per beat on the device; the
host's rollback and LR cooldown decide once a superstep.

PER's beta anneals per beat: `per_beat_betas` gives the B betas the
sequential loop would have used, in f32 on the host (beat b from
budget + b * rows_per_beat env steps), so the superstep takes the same
numbers. JAX loops in one XLA program (lax.fori_loop); the port's loop is
the host's, enqueueing onto one stream (a CUDA graph of it is held note A).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, StepOutput
from distributed_ddpg_tpu_torch.metrics import FusedBeatStats
from distributed_ddpg_tpu_torch.parallel.megastep import build_beat_body


def per_beat_betas(config: DDPGConfig, budget_now: int, beats: int,
                   rows_per_beat: int) -> np.ndarray:
    """The float32[B] PER betas a B-beat superstep takes: entry b is the
    beta the sequential loop computes before its b-th beat (JAX :83-98)."""
    betas = np.empty((beats,), np.float32)
    for b in range(beats):
        frac = min(1.0, (budget_now + b * rows_per_beat) / config.total_env_steps)
        betas[b] = np.float32(config.per_beta + frac * (config.per_beta_final - config.per_beta))
    return betas


def _nth(xs, b):
    return None if xs is None else xs[b]


class FusedSuperstep:
    """B fused beats a dispatch over the live learner, pool and replay, one
    host read at the end (see the module). train.py builds it in place of
    FusedMegastep when superstep_beats > 1."""

    def __init__(self, config: DDPGConfig, learner, pool, replay,
                 beats: Optional[int] = None):
        self.config = config
        self.learner, self.pool, self.replay = learner, pool, replay
        self.per = bool(config.prioritized)
        self.guard = bool(learner.guard_enabled)
        self.beats = int(beats if beats is not None else config.superstep_beats)
        if self.beats < 1:
            raise ValueError(f"superstep beats must be >= 1, got {beats}")
        self.chunk_size = int(learner.chunk_size)
        self.rows_per_beat = int(pool.rows_per_chunk)
        self._beat = build_beat_body(learner, pool, replay, self.per)
        self._stats = FusedBeatStats(seed=config.seed)
        # The last superstep's per-beat metrics [B, 6] and health [B, 5]
        # (guarded), as the one read left them on the host.
        self.last_metrics: Optional[np.ndarray] = None
        self.last_health: Optional[np.ndarray] = None

    def run_superstep(self, betas: Optional[np.ndarray] = None, idx=None, weights=None,
                      draws=None) -> StepOutput:
        """Enqueue B beats (beat b at betas[b] under PER), then read their
        stacked stats back in one copy. Returns the last beat's StepOutput,
        what B sequential run_beat calls leave. `idx`, `weights` and
        `draws`, lists of B, replace each beat's numbers (build_beat_body)."""
        L, B = self.learner, self.beats
        if self.per:
            betas = np.broadcast_to(np.asarray(betas, np.float32), (B,))
        t0 = time.perf_counter()
        metrics, health, bad = [], [], []
        with self.replay.dispatch_lock:
            with trace.span("superstep", beats=B, rows=B * self.rows_per_beat,
                            steps=B * self.chunk_size):
                for b in range(B):
                    out = self._beat(float(betas[b]) if self.per else None,
                                     _nth(idx, b), _nth(weights, b), _nth(draws, b))
                    metrics.append(torch.stack([out.metrics[k] for k in METRIC_KEYS]))
                    if self.guard:
                        health.append(L._health_cur[0])
                        bad.append(L._health_cur[1])
            L.mark_dispatched()
        stacked = torch.stack(metrics).double()
        if self.guard:
            stacked = torch.cat([stacked, torch.stack(health).double()], dim=1)
        host = stacked.cpu().numpy()        # the superstep's one device-to-host read
        n = len(METRIC_KEYS)
        self.last_metrics = host[:, :n]
        if self.guard:
            self.last_health = host[:, n:].astype(np.int64)
            L.note_fused_health(L._guard, self.last_health, torch.stack(bad))
        dt = time.perf_counter() - t0
        self.pool.absorb_fused_chunk(dt, beats=B)
        self._stats.record_beat(B * self.chunk_size, B * self.rows_per_beat, dt, beats=B)
        return out

    def snapshot(self) -> dict:
        """The fused_* fields; fused_supersteps and fused_superstep_beats
        show the B beats a dispatch."""
        return self._stats.snapshot()

    def totals(self) -> dict:
        """The whole run's fused_beats, fused_supersteps and beats a dispatch."""
        return self._stats.totals()
