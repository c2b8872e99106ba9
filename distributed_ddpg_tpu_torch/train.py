"""Training entry point + CLI of the port: D learner processes, N actor processes.

A lean counterpart of distributed_ddpg_tpu/train.py's _train_jax_impl (the
default path: uniform device replay, host actor pool, K learner steps per
dispatch), on one learner process or on D data-parallel ranks, one card
each (parallel/mesh.py). It covers:

- the actor pool's start (on the shm transport whenever its ring can be
  built, config.transport) and the ingest of its rows into DeviceReplay
  through the JAX trainer's default pipeline: rows staged on the host and
  shipped by the transfer scheduler's dispatch thread (--ingest_async,
  --transfer_scheduler), coalesced up to an adaptive cap
  (--ingest_coalesce, --ingest_coalesce_adaptive) from pinned pooled
  buffers (--transfer_host_pool), so the insert's copy queues behind the
  running chunk and the driver only stages rows; on D > 1 ranks the
  ships stay on the driver's thread (every rank inserts at the same
  point). Each drain is capped by --max_ingest_ratio. The scheduler is
  made with the replay and closed after it;
- the replay_min_size warmup;
- chunk dispatch through ShardedLearner.run_sample_chunk (on the card,
  one launch of the hand-written chunk kernel per chunk, or on the scan
  route, for configs outside the kernel's envelope or with
  --fused_chunk=off, K eager steps; with --fused_update=true each runs
  the fused Adam + Polyak kernel twice); train() returns which route ran
  as `fused_chunk_active`;
- the param broadcast (param_refresh_every learner steps, with the
  param_refresh_interval_s wall-clock floor);
- the max_learn_ratio learner-rate cap;
- prioritized replay (--prioritized=true): DevicePrioritizedReplay, each
  chunk through ShardedLearner.run_sample_chunk_per with beta annealed
  linearly from per_beta to per_beta_final over total_env_steps (the JAX
  trainer's rule, its global env-step count being rank 0's pool's);
- D4PG's auto support (--v_min=auto --v_max=auto): sized from the warmup
  replay's rewards before the first chunk, then widened on the 50-chunk
  cadence when mean_q nears an edge and the replay's rewards corroborate
  it (ops/support_auto.py);
- SAC (--sac=true): the actors sample the Gaussian policy after a
  uniform-random warmup of config.resolved_warmup_uniform() env steps
  (replay_min_size by default), the temperature's target entropy is
  resolved in the kernel's wrapper (auto: -act_dim + sum(log scale)), and
  eval acts on the Gaussian's mode, tanh(mean);
- a numpy eval of the deterministic policy;
- JSONL records under the JAX trainer's names: the six learner metrics,
  eval_return, env_steps_per_sec, learner_steps_per_sec (in the final
  record the rates from the warmup's end to the loop's, the teardown
  left out), final_return,
  under D4PG v_min, v_max and support_refusals, and under PER the last
  beta, with max_priority read once, in the final record (the JAX trainer
  records no temperature, so neither does this one; train() returns the
  final alpha under SAC); the ingest_* fields (replay/device.py
  IngestStats) and, with the scheduler, the transfer_* fields in every
  train record and the final one (each an interval's), and in the final
  record and the summary the transport that ran, ingest_async_active,
  and the driver's time in ingest while chunks ran: t_ingest_chunk_ms
  (the mean a chunk), t_ingest_ms (the mean a call), t_ingest_max (the
  longest call), n_ingest (calls).

On D > 1 ranks every rank runs train() with its DataGroup, in lockstep:

- rank 0 alone runs the actor pool, the eval, the log and the param
  broadcast (the replicas end each chunk with the same actor params, so
  rank 0 publishes its own);
- each ingest shares rank 0's drained rows, first their count, then the
  rows, and every rank inserts the same rows into its own replay, so the
  rings (and PER's priorities and stamps) stay identical: the JAX
  package's replicated storage. The rows cross on the control plane (CPU
  tensors over gloo), so the share never waits behind a running chunk in
  the card's stream;
- once a loop turn, and again after the chunk's ingest, rank 0's env-step
  count is shared (beta and the stop test read it, as the JAX trainer's
  global count), and while a chunk runs rank 0's poll of its end decides
  for all; no rank decides anything from its own clock;
- D4PG's warmup bounds and each expansion are rank 0's, shared, and every
  rank calls set_value_bounds with the same numbers (expand_support);
- learner_steps_per_sec counts K a chunk, as the JAX trainer's does; the
  final record adds data_axis, global_batch, the route and whether the
  replicas' states (and priorities) are bit-identical at the end.

Under the CLI the D processes come from torchrun (NCCL, one card a rank):
    torchrun --nproc_per_node=D -m distributed_ddpg_tpu_torch.train --data_axis=D ...

Checkpoint and resume (checkpoint.py), with --checkpoint_dir=DIR:

- on start, with --resume=true (the default), the newest checkpoint under
  DIR that verifies is restored before the actor pool starts (rank 0
  walks the checkpoints newest first, quarantining a corrupt one, and
  every rank restores the step it picked): the state into the learner,
  the replay in place, the learner-step count, and the resolved C51
  bounds (a `support` record with reason "checkpoint"; the warmup sizing
  is skipped). Its env steps count against total_env_steps, beta's
  anneal and the uniform warmup, so a resumed SAC run takes no random
  actions again;
- every checkpoint_every learner steps, at a chunk's end, rank 0
  snapshots the state and the replay and a background thread writes
  them (checkpoint.AsyncSaver); a write that fails raises at the run's
  end;
- SIGTERM sets a flag that the next chunk end reads (on D > 1 ranks
  rank 0's flag rides the env-step share, so every rank stops after the
  same chunk); rank 0 then lands the write in flight and writes one
  emergency checkpoint unless the cadence has just written this step,
  the final eval is skipped, and main() exits EXIT_PREEMPTED (75);
- the final record and the summary carry emergency_ckpt,
  ckpt_write_retries, ckpt_skipped and resumed_from (the step, or None).

With checkpoint_dir="" none of this runs and the records are as before
(a SIGTERM still stops the run after the running chunk, with exit 75).

Numerical-health guardrails (--guardrails=true; guardrails.py, the JAX
trainer's blocks :487-503, :1399-1700), on one rank, on the scan route:

- the learner's guarded chunk drops a bad step's update on the device;
  after each chunk has ended the driver reads its health word once
  (ShardedLearner.poll_health) and takes the delta of its counters
  (metrics.GuardrailStats);
- non-finite sampled rows are traced to the actor slot that produced them
  (the replay's track_sources, the pool's drains with their sources), and
  a slot with guardrail_source_offenses of them is quarantined through
  the pool's breaker;
- guardrail_rollback_k anomalous steps within guardrail_rollback_window
  steps roll the run back: under the replay's dispatch_lock the newest
  valid checkpoint from before the chunk of the window's first anomaly
  (else the newest valid one) is restored (state, replay, C51 bounds),
  then the probe
  is re-armed (reset_guard), the index generator reseeded (0x6A4D + the
  rollback count), both learning rates scaled by guardrail_lr_backoff
  until guardrail_lr_cooldown_steps clean steps pass, the newer
  checkpoints renamed diverged_step_<N> (checkpoint.discard_above) and
  the params rebroadcast;
- past guardrail_max_rollbacks rollbacks, or with nothing to restore, the
  run stops without writing a checkpoint and main() exits EXIT_NUMERIC
  (77);
- --faults=numeric:replay:inf@K poisons the K-th ingested row's reward
  to +inf at drain time; numeric:grad:nan@K and numeric:loss:spike@K
  poison the K-th guarded step on the device (parallel/learner.py);
- every train and final record, and the summary, carry the guardrail_*
  counters, the final record and the summary the pool's actor_respawns,
  actor_quarantined and actor_unquarantined, and the summary
  numeric_failed.

The host replay (--host_replay=true; the JAX trainer's path for a replay
larger than the card's memory), on one rank:

- the replay is make_replay's (replay/uniform.py, or with PER
  replay/prioritized.py over the sum tree, whose C++ core
  native/replay_core.cpp is built at first use), in host memory; one
  replay_lock orders the driver's inserts and priority updates against
  the prefetcher's draws;
- the warmup fills it and sizes D4PG's auto support from it, then a
  ChunkPrefetcher (parallel/prefetch.py) samples K minibatches a chunk on
  its own thread and puts them on the card through
  ShardedLearner.put_chunk (a pinned buffer, a copy on a side stream,
  submitted to the transfer scheduler's prefetch class), up to
  --prefetch_depth chunks ahead;
- each dispatch takes the next chunk (`prefetch.next()`; the wait is the
  final record's t_sample_wait_ms, a chunk) into
  ShardedLearner.run_chunk_async, on the kernel route or the scan route;
- under PER, once the chunk has ended, its td goes back into the sum tree
  and beta anneals, under the lock; chunks the prefetcher drew meanwhile
  keep the priorities they were drawn with, as in the JAX trainer;
- checkpoints save the host replay's state_dict; the prefetcher stops on
  every way out.

Lockstep mode (--strict_sync=true, with both ratio gates): the actors run
inline on the driver's thread (actors/sync_pool.py), the transfer
scheduler, the shipper and the adaptive cap are off, one drain a chunk
takes the whole ratio budget, and the wall-clock floors on the param
refresh and the train records are ignored, so two runs of one config
write the same records but for their wall-clock fields.

Device actors (--actor_backend=device, one rank; JAX :1011-1090,
:1802-1836): after the resume, a DeviceActorPool (actors/device_pool.py)
bound to the learner's live actor params rolls out device_actor_envs
vectorized envs on the card, its rows scattered straight into the device
replay; the warmup fills the ring with its rollouts (and the host pool's
rows, num_actors of them, 0 = none), and one rollout follows every chunk,
queued right behind it (guarded, after the monitor). Its carry rides in
checkpoints (devactor_carry.npz) and comes back on resume and rollback;
the devactor_* fields are in every train and final record and the
summary. Where the fused beat is active (parallel/megastep.py
fused_beat_active: 'auto' with the scan route and both ratio gates 0, or
'on') each dispatch is a beat, the chunk, the rollout and the scatter, or
with superstep_beats=B a superstep of B beats with its stats read once
(PER's betas per beat, per_beat_betas); chunks and learner steps advance
by B, the 50-chunk cadences are crossings, the guardrails' window is two
dispatches wide and their message names a superstep's first bad beat.
The fused_* fields are in the records; the summary has fused_beat_active
and the whole run's fused_beats, fused_supersteps and
fused_superstep_beats.

--serve_actors=true serves the host workers' mu(s) from one
InferenceServer in this process (JAX :1095-1220): the server refreshes
from the pool's broadcast buffer, its batch applies ride the transfer
scheduler's `serve` class, a ServeFront thread moves the workers'
requests into its batcher, and --serve_backend=jax applies the policy on
the card (serve/server.py). It is built and warmed before the workers
start. --front_port / --front_http_port add the network front
(serve/front/): one engine a version, the learner's params published as
"live-0" at the start. The serve_* fields (and front_* and tenant_*) go
into every record, and one snapshot into the final record and the
summary. Teardown: the workers, then the front, then ServeFront, then the
server flushes (JAX :2582-2595). One rank.

--backend=native runs train_native instead: the numpy learner
(native_backend.py) on the CPU, one env and one step a train_every env
steps, the JAX trainer's baseline loop, asked for by name.
--backend=jax_ondevice runs train_ondevice: the on-device monolith
(ondevice.py), num_actors vectorized envs, the ring and the learner on
the card.

Usage:
    python -m distributed_ddpg_tpu_torch.train --total_env_steps=100000
    python -m distributed_ddpg_tpu_torch.train --distributional=true --n_step=5 \
        --prioritized=true --v_min=auto --v_max=auto               # D4PG
    python -m distributed_ddpg_tpu_torch.train --sac=true --actor_lr=3e-4 \
        --critic_lr=3e-4 --tau=0.005                               # SAC
    python -m distributed_ddpg_tpu_torch.train --fused_update=true  # scan route
    python -m distributed_ddpg_tpu_torch.train --critic_l2=0.01     # scan route
    python -m distributed_ddpg_tpu_torch.train --device=cpu ...   # plain versions
    python -m distributed_ddpg_tpu_torch.train --checkpoint_dir=/tmp/ckpt  # resumable
    python -m distributed_ddpg_tpu_torch.train --env_id=MountainCarContinuous-v0 \
        --num_actors=4                                            # built-in env
    python -m distributed_ddpg_tpu_torch.train --guardrails=true --fused_update=true \
        --checkpoint_dir=/tmp/ckpt                                 # guarded
    python -m distributed_ddpg_tpu_torch.train --host_replay=true  # host replay
    python -m distributed_ddpg_tpu_torch.train --strict_sync=true --max_learn_ratio=1 \
        --max_ingest_ratio=1                                       # lockstep
    python -m distributed_ddpg_tpu_torch.train --backend=native    # numpy on the CPU
    python -m distributed_ddpg_tpu_torch.train --actor_backend=device --num_actors=0
    python -m distributed_ddpg_tpu_torch.train --actor_backend=device --num_actors=0 \
        --fused_chunk=off --fused_update=true --superstep_beats=4  # fused beats
    python -m distributed_ddpg_tpu_torch.train --backend=jax_ondevice  # the monolith
    python -m distributed_ddpg_tpu_torch.train --serve_actors=true --serve_backend=jax \
        --num_actors=4                                             # served actors
"""

from __future__ import annotations

import json
import math
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from distributed_ddpg_tpu_torch.actors.policy import NumpyPolicy, actor_head_dim, param_layout
from distributed_ddpg_tpu_torch.actors.pool import ActorPool
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.envs import make, spec_of
from distributed_ddpg_tpu_torch.exits import EXIT_NUMERIC, EXIT_PREEMPTED
from distributed_ddpg_tpu_torch.metrics import GuardrailStats
from distributed_ddpg_tpu_torch.ops import support_auto
from distributed_ddpg_tpu_torch.ops.noise import OUNoise
from distributed_ddpg_tpu_torch.replay import make_replay
from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator
from distributed_ddpg_tpu_torch.types import pack_batch_np, packed_width, unpack_batch


class JsonlLog:
    """One JSON object per line to stdout and, when given, a file."""

    def __init__(self, path: str = "", echo: bool = True):
        self._file = open(path, "a", buffering=1) if path else None
        self._echo = echo
        self._t0 = time.time()

    def log(self, kind: str, step: int, **fields: Any) -> Dict[str, Any]:
        rec = {"kind": kind, "step": int(step),
               "wall_time": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
        if self._echo:
            print(line, flush=True)
        return rec

    def close(self) -> None:
        if self._file:
            self._file.close()


class Timer:
    """Running rate meter on the monotonic clock."""

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


def _eval_numpy(policy, config: DDPGConfig, spec, episodes: Optional[int] = None) -> float:
    env = make(config.env_id, seed=config.seed + 777)
    returns = []
    for ep in range(episodes or config.eval_episodes):
        obs, _ = env.reset(seed=config.seed + 777 + ep)
        done, total = False, 0.0
        while not done:
            action = np.clip(policy(obs)[0], spec.action_low, spec.action_high)
            obs, r, terminated, truncated, _ = env.step(action)
            total += r
            done = terminated or truncated
        returns.append(total)
    return float(np.mean(returns))


def expand_support(learner, controller, out, learn_steps: int, data_bounds,
                   group=None) -> Optional[Dict[str, float]]:
    """The running expansion check of the auto C51 support, as the trainer
    calls it every 50 chunks: on rank 0, mean_q of the last chunk near an
    edge of the support and the replay's current rewards corroborating a
    wider one (support_auto.SupportController, its own rule and
    cooldown); then rank 0's verdict and bounds go to every rank, and
    every rank moves its learner to them. Returns {v_min, v_max, mean_q}
    when the support grew, else None (the same on every rank)."""
    from distributed_ddpg_tpu_torch.parallel import mesh

    verdict = [0.0, math.nan, math.nan, math.nan]
    if group is None or group.lead:
        mean_q = learner.metrics_to_host(out)["mean_q"]
        grown = controller.check(learner.config.v_min, learner.config.v_max, mean_q,
                                 learn_steps, data_bounds_fn=data_bounds)
        if grown is not None:
            verdict = [1.0, *grown, mean_q]
    grew, v_min, v_max, mean_q = mesh.share(verdict, group)
    if not grew:
        return None
    learner.set_value_bounds(v_min, v_max)
    return dict(v_min=v_min, v_max=v_max, mean_q=mean_q)


def resume(config: DDPGConfig, learner, replay, group=None,
           meta_out: Optional[Dict[str, Any]] = None
           ) -> Optional[Tuple[int, int, Optional[Tuple[float, float]]]]:
    """Restore the newest checkpoint under config.checkpoint_dir that
    verifies into `learner` (load_state) and `replay` (in place). Rank 0
    walks the checkpoints (checkpoint.restore's newest-first fallback) and
    shares the step it restored; every other rank restores exactly that
    step. Returns (step, env_steps, v_bounds or None), or None when the
    directory holds no checkpoint. A rank 0 that fails tells the others,
    which raise too. `meta_out` receives checkpoint.restore's meta (the
    device actors' sidecar, "devactor_carry")."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.parallel import mesh

    lead = group is None or group.lead
    meta: Dict[str, Any] = {}
    step = -1
    if lead and ckpt_lib.latest_step(config.checkpoint_dir) is not None:
        try:
            state, step, env_steps = ckpt_lib.restore(
                config.checkpoint_dir, learner.state, replay, config=config, meta_out=meta)
        except Exception:
            mesh.share([-2], group)
            raise
    step = int(mesh.share([step], group)[0])
    if step == -2:
        raise RuntimeError(f"rank 0 could not restore from {config.checkpoint_dir}")
    if step < 0:
        return None
    if not lead:
        state, _, env_steps = ckpt_lib.restore(
            config.checkpoint_dir, learner.state, replay, step=step, config=config,
            meta_out=meta)
    learner.load_state(state)
    if meta_out is not None:
        meta_out.update(meta)
    return step, env_steps, meta.get("v_bounds")


def train(config: DDPGConfig, echo: bool = True, group=None) -> Dict[str, Any]:
    """Trains with `config` and returns the run's summary. With `group` (a
    parallel/mesh.DataGroup of D ranks) every rank calls this: rank 0 runs
    the actors, the eval and the log, and its decisions and rows go to the
    others (see the module's docstring); its summary carries the final
    return, the others' None. backend='native' runs train_native."""
    if config.backend == "native":
        return train_native(config, echo)
    if config.backend == "jax_ondevice":
        return train_ondevice(config, echo, group)
    # torch loads here, not at import: spawned actor workers re-import the
    # main module (this one, under `python -m`) and must stay torch-free.
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.actors.sync_pool import SyncActorPool
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.native import NativeSumTree
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, resolve_learner_chunk
    from distributed_ddpg_tpu_torch.parallel.megastep import FusedMegastep, fused_beat_active
    from distributed_ddpg_tpu_torch.parallel.prefetch import ChunkPrefetcher
    from distributed_ddpg_tpu_torch.parallel.superstep import FusedSuperstep, per_beat_betas
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    lead = group is None or group.lead
    env = make(config.env_id, seed=config.seed)
    spec = spec_of(env)
    chunk = resolve_learner_chunk(config)
    min_fill = max(config.replay_min_size, config.batch_size)
    learner = ShardedLearner(
        config, spec.obs_dim, spec.act_dim, spec.action_scale,
        spec.action_offset, chunk_size=chunk, group=group,
    )
    device = learner.device
    host_replay, strict = config.host_replay, config.strict_sync
    if host_replay and learner.data_size > 1:
        raise ValueError(
            f"host_replay=True on {learner.data_size} ranks is not in this slice of the "
            "PyTorch port: a host replay a rank under the lockstep driver comes with "
            "ROADMAP.md Queue 1 item 10; run the host replay on one rank")
    if config.serve_actors and learner.data_size > 1:
        raise ValueError(
            f"serve_actors=True on {learner.data_size} ranks is not in this slice of the "
            "PyTorch port: serving beside a data-parallel learner comes with ROADMAP.md "
            "Queue 1 item 10; serve on one rank")
    device_actors = config.actor_backend == "device"
    if device_actors and learner.data_size > 1:
        raise ValueError(
            f"actor_backend='device' on {learner.data_size} ranks is not in this slice of "
            "the PyTorch port: the rollout over a data-parallel group comes with "
            "ROADMAP.md Queue 1 item 10; run the device actors on one rank")
    # After every check that can refuse the run, so a refusal leaks no
    # dispatch thread; closed after the replay (teardown below). Off under
    # strict_sync: its dispatch timing would make the records depend on
    # the host's scheduling (and with it the adaptive cap and the pool).
    transfer_sched = (TransferScheduler().start()
                      if config.transfer_scheduler and not strict else None)
    # A shipping thread would make the time an insert lands, relative to
    # the next chunk's draw, depend on each rank's host: the replicas would
    # part, and so would two strict-sync runs. So on D > 1 ranks and under
    # strict_sync the ships stay inline (the pinned pool's non-blocking
    # copy still applies where the scheduler runs).
    ingest_async = (config.ingest_async and learner.data_size == 1 and not strict
                    and not host_replay)
    # Guardrails (see the module docstring): the driver's half of the probe.
    # The host replay keeps no sources (as in the JAX trainer).
    guard_on = config.guardrails
    track_sources = guard_on and config.guardrail_source_offenses > 0 and not host_replay
    gstats = GuardrailStats()
    guard_window: list = []           # (learn_steps at the read, anomalies)
    guard_src_offenses: Dict[int, int] = {}
    numeric_failed = False
    lr_backoff_since = -1             # learn_steps at the LR backoff; -1 = none
    numeric_replay_at = config.fault_plan().numeric_replay_rows()
    ingested_rows = 0
    replay_kwargs = dict(
        block_size=1024,
        async_ship=ingest_async,
        max_coalesce=config.ingest_coalesce,
        scheduler=transfer_sched,
        adaptive_coalesce=transfer_sched is not None and config.ingest_coalesce_adaptive,
        host_pool=transfer_sched is not None and config.transfer_host_pool,
        track_sources=track_sources,
    )
    try:
        if host_replay:
            replay = make_replay(config, spec.obs_dim, spec.act_dim)
        elif config.prioritized:
            replay = DevicePrioritizedReplay(
                config.replay_capacity, spec.obs_dim, spec.act_dim, device,
                alpha=config.per_alpha, eps=config.per_eps, **replay_kwargs,
            )
        else:
            replay = DeviceReplay(config.replay_capacity, spec.obs_dim, spec.act_dim, device,
                                  **replay_kwargs)
    except BaseException:
        if transfer_sched is not None:
            transfer_sched.close()
        raise
    width = packed_width(spec.obs_dim, spec.act_dim)
    # The host replay's one lock: the driver's inserts and priority
    # updates against the prefetcher's draws (the device replay orders its
    # ships on its own dispatch_lock).
    replay_lock = threading.Lock()
    replay_mutex = replay_lock if host_replay else replay.dispatch_lock
    prefetch = None
    sample_wait_s = 0.0               # host replay: the driver's wait for a chunk
    eval_policy = NumpyPolicy(
        param_layout(spec.obs_dim, actor_head_dim(spec.act_dim, config.sac),
                     tuple(config.actor_hidden)),
        spec.action_scale, spec.action_offset, gaussian=config.sac,
    )
    log = JsonlLog(config.log_path if lead else "", echo=echo and lead)
    env_timer, learn_timer = Timer(), Timer()
    learn_steps = chunks = 0
    beta = config.per_beta            # PER's IS exponent, annealed per chunk
    support_controller = support_auto.SupportController()
    n_env = 0                         # the global env-step count (rank 0's pool)
    env_offset = 0                    # env steps of the checkpoint resumed from
    resumed_from = None
    saver = ckpt_lib.AsyncSaver()
    emergency_ckpt = 0
    preempt = threading.Event()       # set by SIGTERM; rank 0's is shared
    stopping = False                  # rank 0's flag, as every rank saw it
    device_pool = None                # actor_backend='device' (actors/device_pool.py)
    megastep = None                   # the fused beat or superstep (parallel/megastep.py)
    resume_meta: Dict[str, Any] = {}

    def support_fields() -> Dict[str, Any]:
        if not config.distributional:
            return {}
        return dict(v_min=learner.config.v_min, v_max=learner.config.v_max,
                    support_refusals=support_controller.refusals)

    def per_fields() -> Dict[str, Any]:
        return dict(prioritized=True, beta=beta) if config.prioritized else {}

    def ckpt_fields() -> Dict[str, Any]:
        if not config.checkpoint_dir:
            return {}
        return dict(emergency_ckpt=emergency_ckpt, ckpt_write_retries=saver.write_retries,
                    ckpt_skipped=saver.skipped, resumed_from=resumed_from)

    def auto_bounds() -> Optional[Tuple[float, float]]:
        """The resolved auto C51 support, which a checkpoint must carry."""
        if config.distributional and config.v_support_auto:
            return learner.config.v_min, learner.config.v_max
        return None

    def ingest_fields() -> Dict[str, Any]:
        """The interval's ingest_* and transfer_* fields (each snapshot
        starts a new interval); the host replay has no ingest pipeline."""
        out = {} if host_replay else replay.ingest_snapshot()
        if transfer_sched is not None:
            out.update(transfer_sched.snapshot())
            if not host_replay:
                out.update(replay.transfer_snapshot())
        return out

    def host_fields() -> Dict[str, Any]:
        """The host replay's record: its prefetch depth, the driver's wait
        for a chunk (ms, a chunk's mean) and under PER which sum tree ran
        (native: the C++ core; numpy: the fallback)."""
        if not host_replay:
            return {}
        tree = {}
        if config.prioritized:
            tree = dict(sum_tree="native" if isinstance(replay._tree, NativeSumTree)
                        else "numpy")
        return dict(host_replay=True, prefetch_depth=config.prefetch_depth,
                    t_sample_wait_ms=1000.0 * sample_wait_s / max(chunks, 1), **tree)

    def mesh_fields() -> Dict[str, Any]:
        if learner.data_size == 1:
            return {}
        return dict(data_axis=learner.data_size, global_batch=learner.global_batch,
                    route=learner.route(per=config.prioritized))

    def data_bounds():
        return support_auto.replay_data_bounds(replay, config.gamma, config.n_step)

    def guardrail_fields() -> Dict[str, Any]:
        return gstats.snapshot() if guard_on else {}

    def recovery_fields() -> Dict[str, Any]:
        return pool.recovery_counters() if pool is not None else {}

    def devactor_fields() -> Dict[str, Any]:
        """The devactor_* fields (metrics.DevActorStats) with the device actors."""
        return device_pool.snapshot() if device_pool is not None else {}

    def fused_fields() -> Dict[str, Any]:
        """The fused_* fields (metrics.FusedBeatStats) while the beat runs."""
        return megastep.snapshot() if megastep is not None else {}

    def devactor_state():
        """The device actors' carry for a checkpoint's sidecar (or None)."""
        return device_pool.carry_state_dict() if device_pool is not None else None

    def serve_fields() -> Dict[str, Any]:
        """The serve_* fields (metrics.ServeStats) and the workers'
        fallbacks while serving; front_* and tenant_* with the front."""
        if serve_server is None:
            return {}
        out = {**serve_server.snapshot(), **pool.serve_counters()}
        if front_server is not None:
            out.update(front_server.snapshot())
        return out

    pool = None
    serve_server = serve_front = front_server = None

    def local_env_steps() -> int:
        """Env steps of this rank's sources: the host pool's, the device
        actors', and the resumed checkpoint's."""
        return (env_offset + pool.steps_received
                + (device_pool.steps_done if device_pool is not None else 0))

    def env_steps() -> int:
        """The global env-step count, as rank 0's sources have it (with the
        resumed checkpoint's), shared; rank 0's SIGTERM flag rides the
        same share and latches `stopping` on every rank at once."""
        nonlocal stopping
        n, flag = mesh.share([local_env_steps(), float(preempt.is_set())]
                             if lead else [0, 0.0], group)
        stopping = stopping or bool(flag)
        return int(n)

    def drain_budget() -> Optional[int]:
        """The rows max_ingest_ratio lets this drain take (None = all):
        env steps <= the warmup fill + ratio * learner steps. It caps each
        drain, so a long gap cannot overshoot it in one call."""
        if config.max_ingest_ratio <= 0.0:
            return None
        allowed = min_fill + config.max_ingest_ratio * learn_steps
        return int(allowed) - local_env_steps()

    def devactor_step() -> int:
        """One device-actor rollout into the ring (JAX :1802-1836), under
        the same ingest-ratio gate as the host drain: while any allowance
        remains it admits one whole rollout (an all-or-nothing gate would
        wedge a warmup whose rollout is larger than the fill)."""
        if device_pool is None:
            return 0
        if config.max_ingest_ratio > 0.0 and local_env_steps() >= (
                min_fill + config.max_ingest_ratio * learn_steps):
            return 0
        rows = device_pool.run_chunk(replay)
        env_timer.tick(rows)
        return rows

    def poison(packed: np.ndarray, source: Optional[int] = None) -> np.ndarray:
        """numeric:replay:inf@K: the K-th ingested row (1-based, counted on
        this rank) lands with reward=+inf, through the real ingest path."""
        nonlocal ingested_rows
        base, m = ingested_rows, len(packed)
        for at in numeric_replay_at:
            if base < at <= base + m:
                packed[at - base - 1, spec.obs_dim + spec.act_dim] = np.inf
                print(f"[chaos] numeric:replay:inf — poisoned ingested row {at} "
                      f"(reward=+inf)" + ("" if source is None else f" from actor {source}"),
                      file=sys.stderr, flush=True)
        ingested_rows = base + m
        return packed

    def insert(rows: np.ndarray, source: int = -1) -> None:
        """Packed rows into the replay: staged for the device ring's ships,
        or added to the host replay under replay_lock."""
        if not host_replay:
            replay.add_packed(rows, source=source)
            return
        b = unpack_batch(rows, spec.obs_dim, spec.act_dim)
        with replay_lock:
            replay.add_batch(b.obs, b.action, b.reward, b.discount, b.next_obs)

    def ingest() -> int:
        rows, pairs = None, []
        if lead:
            budget = drain_budget()
            if budget is None or budget > 0:
                pairs = pool.drain_batches(max_rows=budget, with_sources=True)
            if pairs and not track_sources:
                rows = np.concatenate([pack_batch_np(batch) for _, batch in pairs])
                if numeric_replay_at:
                    rows = poison(rows)
        moved = 0
        if track_sources:
            # One rank (guardrails refuse more): each batch staged with the
            # slot that produced it.
            for wid, batch in pairs:
                packed = pack_batch_np(batch)
                if numeric_replay_at:
                    packed = poison(packed, wid)
                insert(packed, source=wid)
                moved += len(packed)
        else:
            rows = mesh.share_rows(rows, width, group)
            moved = 0 if rows is None else len(rows)
            if moved:
                insert(rows)
        env_timer.tick(moved)
        return moved

    def evaluate(at_step: int) -> float:
        t0 = time.monotonic()
        eval_policy.load_flat(learner.actor_params_to_host())
        ret = _eval_numpy(eval_policy, config, spec)
        learn_timer.exclude(time.monotonic() - t0)
        log.log("eval", at_step, eval_return=ret)
        return ret

    def monitor() -> None:
        nonlocal last_monitor_t
        if lead and time.monotonic() - last_monitor_t >= 1.0:
            last_monitor_t = time.monotonic()
            pool.monitor()

    def emergency_checkpoint() -> int:
        """After SIGTERM: land the write in flight (its failure does not
        cost this save), then rank 0 writes this step unless the cadence
        has just written it. Returns emergency_ckpt's value."""
        try:
            saver.wait()
        except Exception as e:
            print(f"[train] in-flight checkpoint write failed during preemption ({e!r}); "
                  "writing the emergency checkpoint anyway", file=sys.stderr, flush=True)
            saver.errors.clear()
        if not (config.checkpoint_dir and lead):
            return 0
        if ckpt_lib.latest_step(config.checkpoint_dir) != learn_steps:
            ckpt_lib.save(config.checkpoint_dir, learn_steps, learner.state, replay, config,
                          env_steps=n_env, v_bounds=auto_bounds(),
                          keep=config.checkpoint_keep, retries=config.ckpt_write_retries,
                          backoff_s=config.ckpt_retry_backoff_s,
                          devactor_state=devactor_state())
        print(f"[train] emergency checkpoint at learner step {learn_steps} (env step "
              f"{n_env}): resumable", file=sys.stderr, flush=True)
        return 1

    def quarantine_sources() -> None:
        """The bad rows' replay indices (read only now, on the rare path)
        traced to their actor slots; a slot past the offense threshold is
        quarantined through the pool's breaker."""
        idx = learner.bad_indices()
        if not track_sources or not len(idx):
            return
        for src in replay.sources_of(idx):
            src = int(src)
            if src < 0:
                continue   # untracked: restored rows, padding
            guard_src_offenses[src] = guard_src_offenses.get(src, 0) + 1
            if guard_src_offenses[src] >= config.guardrail_source_offenses:
                guard_src_offenses[src] = 0   # a probed comeback counts anew
                if pool.quarantine_source(src, why="numeric"):
                    gstats.record_source_quarantine()

    def numeric_abort(why: str) -> bool:
        """Rollback impossible: stop the run without writing a checkpoint
        (the params are presumed poisoned; the last retained checkpoint
        from before the divergence stays the newest); main() exits 77."""
        nonlocal numeric_failed
        numeric_failed = True
        print(f"[guardrail] NUMERIC ABORT at learner step {learn_steps}: {why}; exiting "
              f"{EXIT_NUMERIC} (no checkpoint written — the last retained pre-divergence "
              "checkpoint stands)", file=sys.stderr, flush=True)
        return True

    def rollback_or_abort() -> bool:
        """Rollback-repair (JAX :1484-1615): restore the newest valid
        checkpoint, re-arm the probe, reseed the draws, back off the
        learning rates, set the diverged checkpoints aside and rebroadcast
        the params; past the budget, or with nothing to restore, abort.
        Returns True either way (the caller skips the rest of the chunk's
        work)."""
        nonlocal learn_steps, last_ckpt, next_refresh, last_refresh_t, lr_backoff_since
        if gstats.rollbacks >= config.guardrail_max_rollbacks:
            return numeric_abort(f"rollback budget exhausted "
                                 f"({gstats.rollbacks}/{config.guardrail_max_rollbacks})")
        if not config.checkpoint_dir:
            return numeric_abort("sustained divergence with no checkpoint_dir to roll back to")
        try:
            saver.wait()   # land (or surface) the write in flight
        except Exception as e:
            print(f"[guardrail] in-flight checkpoint write failed before rollback ({e!r}); "
                  "restoring from the last retained checkpoint", file=sys.stderr, flush=True)
            saver.errors.clear()
        # The divergence began in the chunk of the window's first anomaly:
        # a checkpoint written at or after its start is presumed poisoned,
        # so the restore takes the newest one from before it, and
        # discard_above sets the later ones aside. Where retention kept
        # none from before it, the newest valid one, as the JAX trainer
        # always takes (when its window spans chunks, that is one written
        # after the divergence began).
        before = (guard_window[0][0] if guard_window else learn_steps) - chunk
        meta: Dict[str, Any] = {}
        t0 = time.perf_counter()
        try:
            # No ship (or prefetcher draw) may touch the replay while it is
            # restored.
            with replay_mutex:
                try:
                    state, step, _ = ckpt_lib.restore(config.checkpoint_dir, learner.state,
                                                      replay, config=config, meta_out=meta,
                                                      at_most=before)
                except (FileNotFoundError, RuntimeError):
                    state, step, _ = ckpt_lib.restore(config.checkpoint_dir, learner.state,
                                                      replay, config=config, meta_out=meta)
                learner.load_state(state)
        except (FileNotFoundError, RuntimeError) as e:
            return numeric_abort(f"no restorable checkpoint ({e})")
        restore_ms = 1000.0 * (time.perf_counter() - t0)
        rolled_from = learn_steps
        learn_steps = last_ckpt = step
        if config.distributional and config.v_support_auto and "v_bounds" in meta:
            learner.set_value_bounds(*meta["v_bounds"])
        learner.reset_guard()
        guard_window.clear()
        gstats.record_rollback(step)
        learner.reseed(0x6A4D + gstats.rollbacks)
        if config.guardrail_lr_backoff < 1.0:
            learner.set_lr_scale(config.guardrail_lr_backoff)
            lr_backoff_since = learn_steps
        ckpt_lib.discard_above(config.checkpoint_dir, step)
        pool.broadcast(learner.actor_params_to_host())
        if device_pool is not None and "devactor_carry" in meta:
            # The rollout state rolls back with the learner: its episodes
            # go on from the restored point.
            device_pool.load_carry_state(meta["devactor_carry"])
        next_refresh = learn_steps + config.param_refresh_every
        last_refresh_t = time.perf_counter()
        print(f"[guardrail] ROLLBACK #{gstats.rollbacks}: restored manifest-valid step {step} "
              f"(diverged at ~{rolled_from}) in {restore_ms:.2f} ms; exploration reseeded"
              + (f", LR x{config.guardrail_lr_backoff} until "
                 f"{config.guardrail_lr_cooldown_steps} clean steps pass"
                 if config.guardrail_lr_backoff < 1.0 else ""),
              file=sys.stderr, flush=True)
        return True

    def guardrail_monitor() -> bool:
        """After each chunk (JAX :1618-1700): one read of the health word,
        its delta into the rolling anomaly window, the bad rows traced, and
        the rollback and LR-cooldown transitions. True when the chunk's
        remaining work is to be skipped (a rollback or an abort)."""
        nonlocal lr_backoff_since
        h = learner.poll_health()
        if h is None:
            return False
        delta = gstats.absorb(h)
        if delta["bad_rows"] > 0:
            quarantine_sources()
        if delta["anomalies"] > 0:
            # A superstep's stacked health names its first bad beat (JAX
            # :1632-1648); a chunk's word has no such key.
            first_bad = int(h.get("first_bad_beat", -1))
            print(f"[guardrail] {delta['anomalies']} anomalous learner step(s) in the chunk "
                  f"ending at {learn_steps} (nonfinite {delta['nonfinite']}, z-spikes "
                  f"{delta['spikes']}, bad replay rows {delta['bad_rows']})"
                  + (f", first bad beat {first_bad} of the superstep" if first_bad >= 0
                     else "")
                  + " — update(s) dropped on device", file=sys.stderr, flush=True)
            guard_window.append((learn_steps, delta["anomalies"]))
        # Never narrower than two health reads: one read lands a chunk (a
        # superstep's B chunks).
        lo = learn_steps - max(config.guardrail_rollback_window, 2 * chunk * beats)
        guard_window[:] = [(s, n) for s, n in guard_window if s > lo]
        handled = False
        if (config.guardrail_rollback_k > 0
                and sum(n for _, n in guard_window) >= config.guardrail_rollback_k):
            handled = rollback_or_abort()
        if (not handled and lr_backoff_since >= 0 and not guard_window
                and learn_steps - lr_backoff_since >= config.guardrail_lr_cooldown_steps):
            learner.set_lr_scale(1.0)
            lr_backoff_since = -1
            gstats.record_lr_cooldown()
            print(f"[guardrail] LR cooldown complete at step {learn_steps}: learning rates "
                  "restored", file=sys.stderr, flush=True)
        return handled

    # The handler only sets a flag (no I/O in a signal handler); the loop
    # reads it at a chunk's end. Off the main thread there is none.
    prev_sigterm = None
    try:
        prev_sigterm = signal.signal(signal.SIGTERM, lambda *_: preempt.set())
    except ValueError:
        pass
    ingest_chunk_s = 0.0              # the driver's time in ingest while chunks ran
    ingest_max_s = 0.0
    ingest_calls = 0
    try:
        if config.resume and config.checkpoint_dir:
            restored = resume(config, learner, replay, group, meta_out=resume_meta)
            if restored is not None:
                learn_steps, env_offset, bounds = restored
                resumed_from, n_env = learn_steps, env_offset
                if bounds is not None and config.distributional and config.v_support_auto:
                    learner.set_value_bounds(*bounds)
                    log.log("support", env_offset, reason="checkpoint", **support_fields())
                print(f"resumed from {config.checkpoint_dir} at learner step {learn_steps}, "
                      f"env step {env_offset}", flush=True)
        if lead:
            # strict_sync: inline deterministic actors, the same surface.
            pool = (SyncActorPool if strict else ActorPool)(config, spec,
                                                            env_steps_offset=env_offset)
            if config.serve_actors:
                serve_server, serve_front, front_server = start_serving(
                    config, spec, pool, transfer_sched, learner.actor_params_to_host())
            pool.start(learner.actor_params_to_host())
        if device_actors:
            # After the resume, so the uniform warmup nets out the restored
            # env steps (JAX :1011-1041). The pool reads the learner's live
            # params at each dispatch.
            from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool

            device_pool = DeviceActorPool(config, device=device, warmup_offset=env_offset)
            device_pool.bind(lambda: learner.state.actor_params)
            if "devactor_carry" in resume_meta:
                device_pool.load_carry_state(resume_meta["devactor_carry"])
        if fused_beat_active(config, learner, device_pool is not None):
            # The fused beat (JAX :1043-1090): learn, roll out and scatter
            # in one dispatch; B of them a dispatch under superstep_beats.
            megastep = (FusedSuperstep(config, learner, device_pool, replay)
                        if config.superstep_beats > 1
                        else FusedMegastep(config, learner, device_pool, replay))
        beats = megastep.beats if megastep is not None else 1

        # --- warmup: fill replay to the learning threshold ---
        last_monitor_t = time.monotonic()
        while len(replay) < min_fill:
            moved = ingest() + devactor_step()
            if not host_replay and len(replay) + replay.pending_rows >= min_fill:
                replay.flush()
            monitor()
            if not moved:
                time.sleep(0.01)

        if config.distributional and learner.config.v_support_auto:
            # C51 auto support: [v_min, v_max] from the warmup replay's
            # (n-step) reward statistics, before the first chunk; rank 0's.
            learner.set_value_bounds(*mesh.share(data_bounds() if lead else (0, 0), group))
            n_env = env_steps()
            log.log("support", n_env, reason="warmup", **support_fields())

        if host_replay and not stopping:
            # After the warmup (and the support's sizing): the prefetcher
            # draws from the filled replay, ahead of the learner.
            prefetch = ChunkPrefetcher(
                replay, learner.put_chunk, learner.global_batch, chunk,
                depth=config.prefetch_depth, lock=replay_lock, scheduler=transfer_sched,
            ).start()

        learn_timer.reset()
        env_timer.reset()
        next_refresh = 0
        last_refresh_t = last_log_t = 0.0
        last_eval = 0
        last_ckpt = learn_steps
        out = None
        while True:
            monitor()
            n_env = env_steps()
            if stopping or n_env >= config.total_env_steps and learn_steps > 0:
                break
            if config.max_learn_ratio > 0.0 and learn_steps > 0 and (
                learn_steps + chunk > min_fill + config.max_learn_ratio * n_env
            ):
                # Learner-rate cap: ingest instead of dispatching until env
                # steps catch up with the allowance.
                if not ingest() + devactor_step():
                    time.sleep(0.002)
                continue
            if host_replay:
                t_wait = time.perf_counter()
                device_chunk, indices = prefetch.next()
                sample_wait_s += time.perf_counter() - t_wait
                out = learner.run_chunk_async(device_chunk)
            elif megastep is not None:
                # The fused beat: this chunk, the rollout with its updated
                # params and their scatter in one dispatch (B beats a
                # dispatch for a superstep, its PER betas the sequential
                # loop's, one host read at its end).
                if beats > 1:
                    betas = (per_beat_betas(config, n_env, beats, device_pool.rows_per_chunk)
                             if config.prioritized else None)
                    out = megastep.run_superstep(betas)
                    beta = float(betas[-1]) if config.prioritized else beta
                else:
                    frac = min(1.0, n_env / config.total_env_steps)
                    beta = config.per_beta + frac * (config.per_beta_final - config.per_beta)
                    out = megastep.run_beat(beta if config.prioritized else None)
                env_timer.tick(device_pool.rows_per_chunk * beats)
            elif config.prioritized:
                frac = min(1.0, n_env / config.total_env_steps)
                beta = config.per_beta + frac * (config.per_beta_final - config.per_beta)
                out = learner.run_sample_chunk_per(replay, beta)
            else:
                out = learner.run_sample_chunk(replay)
            prev_chunks = chunks
            chunks += beats
            learn_steps += chunk * beats
            learn_timer.tick(chunk * beats)
            if megastep is None and not guard_on:
                # The rollout with the chunk's updated params, queued right
                # behind the chunk on the learner's stream (the card works
                # it off while the driver ingests); guarded, after the
                # monitor, as the JAX trainer orders them.
                devactor_step()
            # Ingest while the chunk runs. Without this wait the loop would
            # queue chunks far ahead of the card, then block on all of them
            # at its next device read while the actors' bounded queue sits
            # full and undrained. Rank 0's chunk decides when it ends. Under
            # strict_sync one drain a chunk (it takes the whole ratio
            # budget), so the records do not depend on the chunk's time.
            drained = False
            while True:
                done = learner.chunk_done()
                moved = 0
                if not (strict and drained):
                    t_ingest = time.perf_counter()
                    moved = ingest()
                    t_ingest = time.perf_counter() - t_ingest
                    ingest_chunk_s += t_ingest
                    ingest_max_s = max(ingest_max_s, t_ingest)
                    ingest_calls += 1
                    drained = True
                done = bool(mesh.share([done], group)[0])
                if not moved and not done:
                    time.sleep(0.0005)
                if done:
                    break
            n_env = env_steps()
            if guard_on and guardrail_monitor():
                # Rolled back (the params already rebroadcast) or aborted:
                # the rest of this chunk's work is moot.
                if numeric_failed:
                    break
                continue
            if guard_on and megastep is None and devactor_step():
                n_env = env_steps()
            if host_replay and config.prioritized:
                # Host PER (JAX :2152-2160): the chunk's td into the sum
                # tree, then beta, under the lock the prefetcher draws under.
                tds = out.td_errors.cpu().numpy().reshape(-1)
                frac = min(1.0, n_env / config.total_env_steps)
                beta = config.per_beta + frac * (config.per_beta_final - config.per_beta)
                with replay_lock:
                    replay.update_priorities(indices.reshape(-1), tds)
                    replay.set_beta(beta)

            # strict_sync ignores the wall-clock floors on the refresh and
            # the log: they would make which params act and which chunks log
            # depend on the host's timing.
            now = time.perf_counter()
            if lead and learn_steps >= next_refresh and (
                strict or now - last_refresh_t >= config.param_refresh_interval_s
            ):
                pool.broadcast(learner.actor_params_to_host())
                next_refresh = learn_steps + config.param_refresh_every
                last_refresh_t = time.perf_counter()

            # The 50-chunk cadence as a crossing (a superstep moves B chunks).
            on_fifty = prev_chunks // 50 != chunks // 50
            if config.distributional and config.v_support_auto and on_fifty:
                # Running expansion: mean_q near an edge of the support, and
                # the replay's current rewards corroborate a wider one.
                grown = expand_support(learner, support_controller, out, learn_steps,
                                       data_bounds, group)
                if grown is not None:
                    log.log("support", n_env, reason="expanded", mean_q=grown["mean_q"],
                            **support_fields())

            on_cadence = prev_chunks == 0 or on_fifty
            if lead and on_cadence and (strict or now - last_log_t >= 1.0):
                last_log_t = now
                episodes = pool.episode_stats()
                metrics = learner.metrics_to_host(out)
                log.log(
                    "train", n_env,
                    learner_steps=learn_steps,
                    learner_steps_per_sec=learn_timer.rate(),
                    env_steps_per_sec=env_timer.rate(),
                    buffer_fill=len(replay),
                    episode_return=(
                        float(np.mean([e[1] for e in episodes])) if episodes else None
                    ),
                    **metrics,
                    **support_fields(),
                    **per_fields(),
                    **ingest_fields(),
                    **guardrail_fields(),
                    **devactor_fields(),
                    **fused_fields(),
                    **serve_fields(),
                )
            if lead and config.eval_every and n_env - last_eval >= config.eval_every:
                last_eval = n_env
                evaluate(last_eval)
            if config.checkpoint_dir and learn_steps - last_ckpt >= config.checkpoint_every:
                # One writer: the replicas hold the same state and replay.
                # Only the snapshot runs here; the write on the saver's thread.
                if lead:
                    saver.save_async(
                        config.checkpoint_dir, learn_steps, learner.state, replay, config,
                        env_steps=n_env, v_bounds=auto_bounds(),
                        keep=config.checkpoint_keep, retries=config.ckpt_write_retries,
                        backoff_s=config.ckpt_retry_backoff_s,
                        devactor_state=devactor_state())
                last_ckpt = learn_steps
        # The rates end with the loop: the teardown below (the actors'
        # exit, an emergency checkpoint) is not the run's pace.
        rate, env_rate = learn_timer.rate(), env_timer.rate()
        if stopping:
            if lead:
                print(f"[train] SIGTERM: the running chunk finished; exiting {EXIT_PREEMPTED} "
                      "(resumable)", file=sys.stderr, flush=True)
            emergency_ckpt = emergency_checkpoint()
    finally:
        if prefetch is not None:
            prefetch.stop()
        if pool is not None:
            pool.stop()
        # Then the serving stack (no worker can ask any more): the front
        # stops taking external traffic, ServeFront stops feeding the
        # batcher, and the server flushes every accepted request, all
        # before the scheduler under it closes.
        if front_server is not None:
            front_server.stop()
        if serve_front is not None:
            serve_front.stop()
        if serve_server is not None:
            serve_server.close()
        # The shipper stops (later inserts would ship inline), then the
        # scheduler: its pending tickets fail into their waiters.
        if not host_replay:
            replay.close()
        if transfer_sched is not None:
            transfer_sched.close()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    saver.wait()   # a failed cadence write raises here

    metrics = learner.metrics_to_host(out) if out is not None else {}
    if config.prioritized:   # the run's one read of the max priority
        metrics["max_priority"] = float(replay.max_priority)
    replica = {}
    if learner.data_size > 1:
        # Every rank's state (and PER's priorities) against rank 0's, bit
        # for bit: the replicas must not have drifted apart.
        from distributed_ddpg_tpu_torch.parallel.learner import state_tensors

        held = state_tensors(learner.state)
        if config.prioritized:
            held += [replay.priorities, replay.max_priority]
        replica = dict(replicas_identical=mesh.replicas_equal(held, group))
    final_return = None
    # Preempted: checkpoint and get out. Numerically aborted: the params are
    # presumed poisoned, an eval would score garbage.
    if lead and not stopping and not numeric_failed:
        eval_policy.load_flat(learner.actor_params_to_host())
        final_return = _eval_numpy(eval_policy, config, spec)
    ingest_record = dict(
        transport=pool.transport if pool is not None else None,
        ingest_async_active=ingest_async,
        t_ingest_chunk_ms=1000.0 * ingest_chunk_s / max(chunks, 1),
        t_ingest_ms=1000.0 * ingest_chunk_s / max(ingest_calls, 1),
        t_ingest_max=1000.0 * ingest_max_s,
        n_ingest=ingest_calls,
        **ingest_fields(),
    )
    # The summary keeps the scheduler's ingest and prefetch counts and the
    # replay's transfer fields; the final record has every class's.
    kept = {"transfer_ingest_items", "transfer_prefetch_items", "transfer_serve_items",
            *(() if host_replay else replay.transfer_snapshot())}
    ingest_summary = {k: v for k, v in ingest_record.items()
                      if not k.startswith("transfer_") or k in kept}
    devactor_final = devactor_fields()
    fused_final = fused_fields()
    # One serve snapshot for the final record and the summary: a second
    # would report the tails of an empty interval.
    serve_final = serve_fields()
    log.log(
        "final", n_env,
        learner_steps=learn_steps,
        learner_steps_per_sec=rate,
        env_steps_per_sec=env_rate,
        final_return=final_return,
        chunks=chunks,
        compute_dtype=config.compute_dtype,
        **devactor_final,
        **fused_final,
        **metrics,
        **support_fields(),
        **per_fields(),
        **mesh_fields(),
        **replica,
        **ckpt_fields(),
        **ingest_record,
        **host_fields(),
        **guardrail_fields(),
        **(recovery_fields() if guard_on else {}),
        **serve_final,
    )
    log.close()
    return {
        "learner_steps_per_sec": rate,
        "env_steps_per_sec": env_rate,
        "learner_steps": learn_steps,
        "chunks": chunks,
        "chunk_size": chunk,
        "compute_dtype": config.compute_dtype,
        "fused_chunk_active": learner.fused_chunk_active,
        # The fused beat carried the loop (JAX :2702); its whole run's
        # beats and dispatches, and the device actors' counters.
        "fused_beat_active": megastep is not None,
        **(megastep.totals() if megastep is not None else {}),
        **devactor_final,
        **ingest_summary,
        **host_fields(),
        "env_steps": n_env,
        "final_return": final_return,
        **{k: metrics[k] for k in (*METRIC_KEYS, "max_priority") if k in metrics},
        **support_fields(),
        **per_fields(),
        **mesh_fields(),
        **replica,
        **ckpt_fields(),
        "preempted": stopping,
        "numeric_failed": numeric_failed,
        **guardrail_fields(),
        **(recovery_fields() if guard_on else {}),
        **serve_final,
        **({"alpha": float(learner.state.log_alpha.exp())} if config.sac else {}),
    }


def start_serving(config: DDPGConfig, spec, pool, scheduler, flat_params):
    """The serving stack of --serve_actors (JAX train.py:1095-1220): the
    InferenceServer (built, and on the card warmed, here, before any
    worker starts) and its ServeFront over the pool's channels, and with
    front_port / front_http_port the FrontServer, one engine a version,
    the learner's params published as "live-0". A bind failure of the
    front is said on stderr and leaves the run without it (ingress must
    never kill the run it fronts). Returns (server, serve_front, front)."""
    from distributed_ddpg_tpu_torch.serve import InferenceServer, ServeFront

    plan = config.fault_plan()

    def engine(**kw):
        return InferenceServer(
            pool.layout, spec.action_scale, spec.action_offset,
            max_batch=config.serve_max_batch,
            max_latency_s=config.serve_max_latency_ms / 1000.0,
            max_queue=config.serve_queue, backend=config.serve_backend,
            seed=config.seed, sac=config.sac, log_std_min=config.sac_log_std_min,
            log_std_max=config.sac_log_std_max, device=config.device, **kw)

    server = engine(param_source=pool.param_source(), scheduler=scheduler,
                    fault_batcher=plan.site("serve", "batcher") if plan else None,
                    fault_dispatch=plan.site("serve", "dispatch") if plan else None).start()
    serve_front = ServeFront(server, *pool.serve_channels()).start()
    front = None
    if config.front_port or config.front_http_port:
        from distributed_ddpg_tpu_torch.serve.front import FrontServer

        try:
            front = FrontServer(
                engine, port=config.front_port, http_port=config.front_http_port or None,
                timeout_s=config.front_timeout_s,
                canary_fraction=config.front_canary_fraction,
                canary_min_requests=config.front_canary_min_requests,
                canary_threshold=config.front_canary_threshold,
                tenants=config.front_tenants, default_priority=config.front_default_priority,
                shed_start=config.front_shed_start, seed=config.seed,
                fault_accept=plan.site("front", "accept") if plan else None,
                fault_frame=plan.site("front", "frame") if plan else None,
                canary_regressions=plan.front_canary_regressions() if plan else (),
            )
            front.publish("live-0", flat_params)
            front.start()
            print(f"[front] serving ingress on tcp:{front.port} "
                  f"http:{front.http_port or '-'} (stable=live-0)", file=sys.stderr, flush=True)
        except OSError as e:
            front = None
            print(f"[front] ingress disabled (bind failed: {e})", file=sys.stderr, flush=True)
    return server, serve_front, front


def train_native(config: DDPGConfig, echo: bool = True) -> Dict[str, Any]:
    """--backend=native (JAX train.py:111-203): the numpy learner
    (native_backend.NativeLearner) on the CPU, one env stepped with the
    deterministic policy plus OU noise, one learner step on one sampled
    batch every train_every env steps once the replay holds
    max(replay_min_size, batch_size) rows, PER's priorities written from
    the step's td. Every eval_every env steps a train record and (once
    learning) an inline eval, its time left out of the learner rate. The
    params start from the port's init_train_state on the CPU: the only
    torch this path touches, and never the card."""
    from distributed_ddpg_tpu_torch.learner import init_train_state, train_state_to_numpy
    from distributed_ddpg_tpu_torch.native_backend import NativeLearner

    env = make(config.env_id, seed=config.seed)
    spec = spec_of(env)
    state = init_train_state(config, spec.obs_dim, spec.act_dim, config.seed, device="cpu")
    learner = NativeLearner(config, train_state_to_numpy(state), spec.action_scale,
                            spec.action_offset)
    replay = make_replay(config, spec.obs_dim, spec.act_dim)
    noise = OUNoise((spec.act_dim,), config.ou_theta, config.ou_sigma, dt=config.ou_dt,
                    seed=config.seed + 1)
    nstep = NStepAccumulator(config.n_step, config.gamma)
    log = JsonlLog(config.log_path, echo=echo)
    learn_timer = Timer()
    learn_steps = 0
    metrics: Dict[str, float] = {}
    ep_return, ep_returns = 0.0, []

    obs, _ = env.reset(seed=config.seed)
    for step in range(1, config.total_env_steps + 1):
        action = learner.act(obs)[0] + noise() * spec.action_scale
        action = np.clip(action, spec.action_low, spec.action_high).astype(np.float32)
        next_obs, reward, terminated, truncated, _ = env.step(action)
        ep_return += reward
        for tr in nstep.push(obs[None], action[None], [reward], [terminated], next_obs[None]):
            replay.add(*tr)
        obs = next_obs
        if terminated or truncated:
            obs, _ = env.reset()
            noise.reset()
            nstep.reset()
            ep_returns.append(ep_return)
            ep_return = 0.0
        if (len(replay) >= max(config.replay_min_size, config.batch_size)
                and step % config.train_every == 0):
            sample = replay.sample(config.batch_size)
            indices = sample.pop("indices")
            m = learner.step(sample)
            td = m.pop("td_errors")
            if config.prioritized:
                replay.update_priorities(indices, td)
            metrics = m
            learn_steps += 1
            learn_timer.tick()
        if step % max(1, config.eval_every) == 0:
            log.log("train", step, learner_steps=learn_steps,
                    learner_steps_per_sec=learn_timer.rate(), buffer_fill=len(replay),
                    episode_return=float(np.mean(ep_returns)) if ep_returns else None,
                    **metrics)
            ep_returns = []
            if learn_steps:
                # The inline eval is off the learner's path: its time is
                # left out of the rate.
                t_eval = time.monotonic()
                ret = _eval_numpy(learner.act, config, spec)
                learn_timer.exclude(time.monotonic() - t_eval)
                log.log("eval", step, eval_return=ret)
    rate = learn_timer.rate()
    final_return = _eval_numpy(learner.act, config, spec)
    log.log("final", config.total_env_steps, learner_steps_per_sec=rate,
            final_return=final_return)
    log.close()
    return {
        "learner_steps_per_sec": rate,
        "learner_steps": learn_steps,
        "final_return": final_return,
    }


def train_ondevice(config: DDPGConfig, echo: bool = True, group=None) -> Dict[str, Any]:
    """--backend=jax_ondevice (JAX train.py:210-330): the on-device monolith
    (ondevice.OnDeviceDDPG), num_actors vectorized envs, the ring and the
    learner on the card, 64 iterations a chunk (superstep_beats chunks a
    dispatch, their stats read once). A checkpoint holds the state, the
    ring's rows (the monolith's DeviceReplay) and the env steps;
    a run resumes from the newest one that verifies. Evals run the numpy
    policy every eval_every env steps (0 = the final eval only); a `train`
    record is written whenever the env steps cross a multiple of ten
    chunks' worth (a crossing, so a superstep that jumps over one still
    logs). One rank (ROADMAP.md Queue 1 item 10)."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.envs.registry import EnvSpec
    from distributed_ddpg_tpu_torch.ondevice import OnDeviceDDPG

    if group is not None and group.world_size > 1:
        raise ValueError(
            f"backend='jax_ondevice' on {group.world_size} ranks is not in this slice of "
            "the PyTorch port: the monolith over a data-parallel group comes with "
            "ROADMAP.md Queue 1 item 10; run it on one rank")
    trainer = OnDeviceDDPG(config)
    log = JsonlLog(config.log_path, echo=echo)

    env_offset = last_ckpt = 0
    resumed_from = None
    if (config.resume and config.checkpoint_dir
            and ckpt_lib.latest_step(config.checkpoint_dir) is not None):
        state, step, env_offset = ckpt_lib.restore(config.checkpoint_dir, trainer.state,
                                                   trainer.replay, config=config)
        trainer.load_train_state(state)
        trainer._learn_steps = last_ckpt = resumed_from = step
        print(f"resumed from {config.checkpoint_dir} at learner step {step}, env step "
              f"{env_offset}", flush=True)
    env = trainer.env
    spec = EnvSpec(env.obs_dim, env.act_dim, np.asarray(env.action_low, np.float32),
                   np.asarray(env.action_high, np.float32))
    eval_policy = NumpyPolicy(
        param_layout(spec.obs_dim, actor_head_dim(spec.act_dim, config.sac),
                     tuple(config.actor_hidden)),
        spec.action_scale, spec.action_offset, gaussian=config.sac)
    env_timer, learn_timer = Timer(), Timer()

    def env_steps() -> int:
        return env_offset + trainer.env_steps

    beats = max(1, trainer.superstep_beats)
    rows_per_dispatch = trainer.chunk_size * trainer.num_envs * beats
    log_stride = trainer.chunk_size * trainer.num_envs * 10
    episodes_acc, return_acc = 0, []
    last_eval = dispatches = 0
    metrics: Dict[str, float] = {}     # the last dispatch's learner metrics
    while env_steps() < config.total_env_steps:
        before = trainer.learn_steps
        stats = trainer.run_superstep() if beats > 1 else trainer.run_chunk()
        host = trainer.finalize_stats(stats)
        dispatches += 1
        env_timer.tick(rows_per_dispatch)
        learn_timer.tick(trainer.learn_steps - before)
        episodes_acc += host.pop("episodes", 0)
        if "episode_return" in host:
            return_acc.append(host.pop("episode_return"))
        metrics = host
        if config.eval_every and env_steps() - last_eval >= config.eval_every:
            t0 = time.monotonic()
            eval_policy.load_flat(trainer.actor_params_to_host())
            last_eval = env_steps()
            log.log("eval", last_eval, eval_return=_eval_numpy(eval_policy, config, spec))
            learn_timer.exclude(time.monotonic() - t0)
            env_timer.exclude(time.monotonic() - t0)
        if trainer.env_steps // log_stride != (trainer.env_steps - rows_per_dispatch) // log_stride:
            log.log("train", env_steps(), learner_steps=trainer.learn_steps,
                    env_steps_per_sec=env_timer.rate(),
                    learner_steps_per_sec=learn_timer.rate(), episodes=episodes_acc,
                    episode_return=float(np.mean(return_acc)) if return_acc else None,
                    **host)
            episodes_acc, return_acc = 0, []
        if config.checkpoint_dir and trainer.learn_steps - last_ckpt >= config.checkpoint_every:
            ckpt_lib.save(config.checkpoint_dir, trainer.learn_steps, trainer.state,
                          trainer.replay, config, env_steps=env_steps(),
                          keep=config.checkpoint_keep, retries=config.ckpt_write_retries,
                          backoff_s=config.ckpt_retry_backoff_s)
            last_ckpt = trainer.learn_steps
    rate, env_rate = learn_timer.rate(), env_timer.rate()
    eval_policy.load_flat(trainer.actor_params_to_host())
    final_return = _eval_numpy(eval_policy, config, spec)
    log.log("final", env_steps(), learner_steps=trainer.learn_steps,
            env_steps_per_sec=env_rate, learner_steps_per_sec=rate, final_return=final_return,
            dispatches=dispatches, superstep_beats=beats)
    log.close()
    return {
        "env_steps_per_sec": env_rate,
        "learner_steps_per_sec": rate,
        "learner_steps": trainer.learn_steps,
        "env_steps": env_steps(),
        "dispatches": dispatches,
        "chunk_size": trainer.chunk_size,
        "num_envs": trainer.num_envs,
        "final_return": final_return,
        "resumed_from": resumed_from,
        **metrics,
    }


def main(argv=None) -> None:
    config = DDPGConfig.from_flags(argv if argv is not None else sys.argv[1:])
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # Under torchrun: one rank a card over NCCL (gloo on the CPU).
        from distributed_ddpg_tpu_torch.parallel.mesh import init_data_group

        group = init_data_group("nccl" if config.device == "cuda" else "gloo")
    try:
        summary = train(config, group=group)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    if group is None or group.lead:
        print({k: round(v, 3) if isinstance(v, float) else v for k, v in summary.items()})
    if summary.get("numeric_failed"):
        # The guardrails could not repair a sustained divergence: read the
        # guardrail_* counters before spending more on this config.
        sys.exit(EXIT_NUMERIC)
    if summary.get("preempted"):
        # Preempted and resumable: relaunch with the same --checkpoint_dir.
        sys.exit(EXIT_PREEMPTED)


if __name__ == "__main__":
    main()
