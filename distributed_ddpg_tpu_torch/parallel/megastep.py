"""The fused beat: learn, roll out, scatter as one dispatch on one stream.

Counterpart of distributed_ddpg_tpu/parallel/megastep.py
(config.fused_beat). The dispatch-per-phase loop (train.py) dispatches a
learner chunk, then a device-actor rollout, then its insert, with the
driver's Python between them. One beat is that loop iteration in its own
order:

1. sample and learn: the scan route's sampling chunk
   (ShardedLearner.scan_sample_fn: uniform or PER, guarded or not) draws K
   minibatches from the ring as it stands and takes K steps;
2. roll out: the device actors (DeviceActorPool.advance) step E envs for
   K_env steps with the UPDATED actor params (the pool reads the learner's
   state at the dispatch, after the chunk replaced it);
3. scatter: the rows land in the ring (DeviceReplay.insert_device_rows:
   the scatter, under PER the max-priority stamp from the pre-insert
   pointer, then note_device_rows).

JAX traces the three legs into one XLA program. The port enqueues them on
the learner's stream, one after the other under the replay's
dispatch_lock, with no host read between them: each leg is the same code
the separate dispatches run, in the same order with the same generators,
so N beats are bit-identical to the separate sequence
(tests/test_torch_fused_beat.py; chip_smoke.py on the card). Capturing the
beat in a CUDA graph is speed work held for after the bench (ROADMAP held
note A). A guarded beat leaves its health word where the learner's
poll_health reads it, as a guarded chunk does; the rollout rows of a beat
whose learner leg was skipped still land (the pre-update policy's rows are
ordinary replay data, under the same row screen).

'auto' activates the beat (train.py, JAX train.py:1057-1069) when the
device actors feed the device replay, the chunk kernel's route is
inactive (it has no rollout slot), and both ratio gates are 0 (a beat
fixes the rollout:learn ratio); 'on' requires it.

On D data-parallel ranks, and on a (data, model) grid, every rank runs
the same beat in the same order (JAX :82-200 builds every variant on a
mesh): the learner leg is the rank's chunk of the global draw with the
gradient all-reduce of each step (on a grid, the Megatron-split step on
the rank's shards), the rollout steps the rank's envs with the updated
logical actor and gathers every rank's rows over the data group, and the
scatter lands the same global rows in every rank's ring (a sharded ring
keeps its slots of them). Uniform and PER, replicated and sharded,
guarded and not.
"""

from __future__ import annotations

import time
from typing import Optional

from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import StepOutput
from distributed_ddpg_tpu_torch.metrics import FusedBeatStats


def fused_beat_active(config: DDPGConfig, learner, device_actors: bool) -> bool:
    """The activation rule (JAX train.py:1057-1069): the device actors on
    the device replay, fused_beat not 'off', and 'on' or (the chunk
    kernel's route inactive and both ratio gates 0)."""
    if not device_actors or config.host_replay or config.fused_beat == "off":
        return False
    return config.fused_beat == "on" or (
        not learner.fused_chunk_active and config.max_ingest_ratio == 0.0
        and config.max_learn_ratio == 0.0)


def build_beat_body(learner, pool, replay, per: bool):
    """The beat for one (per, guard) variant (the guard is the learner's):
    `beat(beta=None, idx=None, weights=None, draws=None) -> StepOutput`,
    the learner leg's output. `idx` ([K, B]; PER with its `weights`)
    replaces the learner leg's index draw and `draws` (K_env StepDraws) the
    rollout's, so a test can pass a reference's numbers in. The superstep
    (parallel/superstep.py) runs the SAME body B times, so a superstep is
    B beats by construction. The caller holds replay.dispatch_lock."""
    sample = learner.scan_sample_fn(per)

    def beat(beta: Optional[float] = None, idx=None, weights=None,
             draws=None) -> StepOutput:
        if per:
            out = sample(replay, beta, idx=idx, weights=weights)
        else:
            out = sample(replay, idx=idx)
        replay.insert_device_rows(pool.advance(draws))
        return out

    return beat


class FusedMegastep:
    """One beat a dispatch over the live learner, device-actor pool and
    device replay (see the module); train.py builds it when the beat is
    active and calls run_beat where the chunk dispatch sat."""

    beats = 1

    def __init__(self, config: DDPGConfig, learner, pool, replay):
        self.config = config
        self.learner, self.pool, self.replay = learner, pool, replay
        self.per = bool(config.prioritized)
        self.guard = bool(learner.guard_enabled)
        self.chunk_size = int(learner.chunk_size)      # learner steps a beat
        self.rows_per_beat = int(pool.rows_per_chunk)
        self._beat = build_beat_body(learner, pool, replay, self.per)
        self._stats = FusedBeatStats(seed=config.seed)

    def run_beat(self, beta: Optional[float] = None, idx=None, weights=None,
                 draws=None) -> StepOutput:
        """Enqueue one beat: the learner leg, the rollout with the updated
        params, the scatter; returns the learner leg's StepOutput. `idx`,
        `weights` and `draws` replace the generators' numbers
        (build_beat_body)."""
        t0 = time.perf_counter()
        with self.replay.dispatch_lock:
            with trace.span("fused_beat", rows=self.rows_per_beat, steps=self.chunk_size):
                out = self._beat(beta, idx, weights, draws)
            self.learner.mark_dispatched()
        dt = time.perf_counter() - t0
        self.pool.absorb_fused_chunk(dt)
        self._stats.record_beat(self.chunk_size, self.rows_per_beat, dt)
        return out

    def snapshot(self) -> dict:
        """The fused_* fields (metrics.FusedBeatStats)."""
        return self._stats.snapshot()

    def totals(self) -> dict:
        """The whole run's fused_beats, fused_supersteps and beats a dispatch."""
        return self._stats.totals()


# ---------------------------------------------------------------------------
# program-contract analyzer hook (analysis/programs.py)
# ---------------------------------------------------------------------------


def program_specs():
    """The fused beat family at the probe sizes (4 probe envs x rollout
    chunk 2, learner chunk 2, a 64-row ring) on the 2-rank probe group:
    uniform and PER x replicated and sharded x guarded and unguarded, and
    the TP composition on the (2, 2) grid. The guarded and unguarded pair
    of each shape dispatches at the same lockstep site, so they share a
    beat_group; the TP beats keep a group of their own (the model group's
    exchanges are the port's own collectives, parallel/learner.py's hook
    says why)."""
    from distributed_ddpg_tpu_torch.analysis.programs import (
        BuiltProgram,
        ProgramSpec,
        learner_leaves,
        probe_beat_stack,
        replay_leaves,
    )

    OWNER = "parallel/megastep.py"

    def build(guard: bool, per: bool, sharded: bool, tp: bool = False):
        def _build(device: str) -> BuiltProgram:
            config, learner, pool, replay = probe_beat_stack(device, guard, per, sharded, tp)
            ms = FusedMegastep(config, learner, pool, replay)
            return BuiltProgram(lambda: ms.run_beat(0.4 if per else None),
                                lambda: {**learner_leaves(learner), **replay_leaves(replay)})
        return _build

    specs = []
    for per, kind in ((False, "uniform"), (True, "per")):
        for sharded in (False, True):
            shard_tag = ".sharded" if sharded else ""
            for guard in (False, True):
                tag = ".guarded" if guard else ""
                specs.append(ProgramSpec(
                    f"megastep.beat.{kind}{shard_tag}{tag}", OWNER,
                    build(guard, per, sharded),
                    beat_group=f"megastep-beat-{kind}{shard_tag}",
                ))
        specs.append(ProgramSpec(
            f"megastep.beat.{kind}.sharded.tp", OWNER,
            build(False, per, True, tp=True),
            beat_group=f"megastep-beat-{kind}.sharded.tp",
        ))
    return specs
