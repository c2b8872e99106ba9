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
  and the driver's time in ingest while chunks ran over the whole run:
  t_ingest_chunk_ms (the mean a chunk), t_ingest_run_ms (the mean a
  call), t_ingest_run_max (the longest call), n_ingest_run (calls).
  (t_ingest_ms, t_ingest_max and n_ingest are PhaseTimers' ingest phase
  over the record's interval, as in the JAX trainer's records.)

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

With --model_axis=M > 1 the D x M ranks are the learner's (data, model)
grid (parallel/mesh.make_grid; `torchrun --nproc_per_node=D*M ...
--data_axis=D --model_axis=M`), and the rules above hold over all of
them. The learner holds each rank's shards (parallel/learner.py); at a
checkpoint every rank gathers the logical state over its model group
(learner.logical_state) and rank 0 writes it, a restore loads the logical
state on every rank, and a sharded ring's slices are written by each model
group's first rank, one a data index. On a pod abort under M > 1 a node
lead writes its emergency checkpoint when its model group lies on its
node (torchrun's --nproc_per_node a multiple of M), gathered under the
pod deadline; a group that spans nodes writes none (a lost node's shards
cannot be gathered), and the last cadence checkpoint is then the resume
point. Every train and final record
carries mesh_data_axis, mesh_model_axis, mesh_param_bytes_per_device (this
rank's shards) and mesh_param_bytes_total (the logical state), at M = 1
too (metrics.MeshStats).

Under the CLI the D processes come from torchrun (NCCL, one card a rank):
    torchrun --nproc_per_node=D -m distributed_ddpg_tpu_torch.train --data_axis=D ...

A pod (parallel/multihost.py): ranks of more than one node, as torchrun
starts them under --nnodes=N (each node's ranks under one --node_rank),
or tools/supervise.py --procs N (one rank a node, on one host); the
DDPG_DIST_BACKEND variable names the backend (gloo lets the nodes share
one card). The JAX trainer's multi-process path, mapped onto nodes:

- the bootstrap: the pod deadline armed (configure_pod), the startup
  barrier with pod_startup_grace_s, the clock handshake into the trace's
  metadata; a peer lost here returns at once and main() exits 76;
- each node's lead runs its node's actors and stages their rows; after
  every chunk (and every turn of the warmup, whose beats are waited at
  once and every 20th forced) the sync_ship beat gathers every node's
  staged rows into every rank's replicated ring, in the background on
  the transfer scheduler's lockstep lane with sync_ship_background, and
  the next dispatch waits it (wait_beat); the nodes' env steps are
  summed by a gather every 10th loop turn (the budget and PER's beta
  read it); a node whose staging holds 8 blocks stops draining;
- the resume is the election (elect_and_resume) over the checkpoint
  directory and the node's proc<k> directory; rank 0 writes the cadence
  checkpoints; the pod fault site (pod:<proc>:...) is armed at the
  warmup's end; a PodAggregator gather on each 50-chunk cadence, and
  node 0 logs the `pod` record; the pod_* fields ride every record;
- a PodPeerLost anywhere (a beat's deadline, a transport error) takes
  the coordinated abort: the scheduler's pending tickets fail, each
  node's lead writes one emergency checkpoint (node k into proc<k>),
  nothing touches the process group again, and main() exits 76 through
  pod_degraded_exit (os._exit after node 0's linger). The first chunk's
  kernel build and a support expansion grant the pod deadline
  pod_startup_grace_s (_grant_all). A SIGTERM ends its own node's run
  (exit 75) and its peers' through PodPeerLost (76). With one node none
  of this runs.

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
  sample_wait phase, and over the whole run the final record's
  t_sample_wait_run_ms, a chunk) into
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

The operations layer (the JAX trainer's train_jax and its telemetry):

- --trace_dir: the flight recorder (trace.py, --trace_events slots) for
  the whole device lifetime of train(), written to trace_dir/trace.json
  on the way out and on SIGUSR2; each actor worker writes its own
  trace_actor<k>.json;
- --watchdog_s: the stall watchdog (watchdog.py) over the same lifetime:
  the driver beats it at each milestone (the learner built, the first
  params read, every warmup and loop turn, every teardown stage), the
  first chunk, which builds the kernels with nvcc, gets
  max(300, 2 watchdog_s), as do a rollback and a support expansion; no
  beat for watchdog_s writes stall_report.json and stall_trace.json into
  trace_dir (else checkpoint_dir, else the cwd) and exits 70. No ingested
  row for 10 x watchdog_s, in the warmup or the loop, raises (an
  actor-side stall, on a healthy learner thread);
- --obs_port: the exporter (obs/exporter.py): /metrics from the latest
  record of each kind, /healthz from obs/health.py (draining on SIGTERM
  and on a stall; degraded while a guardrail quarantine holds or the
  serve queue is saturated), /trace;
- PhaseTimers (metrics.py) around the JAX trainer's phases (dispatch,
  sample_wait, ingest, sync, refresh, prio_update, devactor, ckpt,
  eval_snapshot): t_<phase>_ms / n_<phase> / t_<phase>_p50 / _p95 / _max
  over each train record's interval and in the final record, beside the
  actors' staleness_mean / staleness_max (the pool's) in each train
  record. These are host-clock times: `dispatch` on the card is the
  chunk's enqueue, and the wait for the card shows in `sync`;
- --profile_dir: the loop under torch.profiler (CPU and, on the card, CUDA
  activities), written as a Chrome trace to profile_dir/profile.json;
- --tb_dir: every record's numbers as TensorBoard scalars
  (metrics.MetricsLogger), in train_native and train_ondevice too;
- --faults: the plan's sites are wired here: the transfer scheduler's
  `transfer:dispatch`, the shipper's `shipper:ship`, the checkpoint
  writer's `ckpt:write`, the prefetcher's `prefetch:sample`, the device
  actors' `devactor:rollout` and (actors/pool.py) the workers' and the
  pool's; every train and final record carries the recovery counters
  (actor_respawns, actor_quarantined, actor_unquarantined,
  ckpt_write_retries, emergency_ckpt).

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
    DDPG_DIST_BACKEND=gloo python -m distributed_ddpg_tpu_torch.tools.supervise --procs 2 \
        -- python -m distributed_ddpg_tpu_torch.train --checkpoint_dir=/tmp/pod  # a pod
"""

from __future__ import annotations

import contextlib
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
from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.exits import (
    EXIT_NUMERIC,
    EXIT_POD_DEGRADED,
    EXIT_POD_SHRINK,
    EXIT_PREEMPTED,
)
from distributed_ddpg_tpu_torch.metrics import (
    GuardrailStats,
    MeshStats,
    MetricsLogger,
    PhaseTimers,
    PodStats,
    Timer,
)
from distributed_ddpg_tpu_torch.ops import support_auto
from distributed_ddpg_tpu_torch.ops.noise import OUNoise
from distributed_ddpg_tpu_torch.replay import make_replay
from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator
from distributed_ddpg_tpu_torch.types import pack_batch_np, packed_width, unpack_batch


def _enable_faulthandler() -> None:
    """Stack dumps on a hard fault and on demand (kill -USR1 <pid>): a
    wedged driver must be debuggable without a debugger attached."""
    import faulthandler

    faulthandler.enable()
    if hasattr(signal, "SIGUSR1"):
        faulthandler.register(signal.SIGUSR1)


@contextlib.contextmanager
def _profiled(config: DDPGConfig, device):
    """--profile_dir: the block under torch.profiler (CPU activities, and
    CUDA's on the card), exported as a Chrome trace to
    profile_dir/profile.json (the JAX trainer's jax.profiler.trace). It
    holds every event in memory: keep such runs short."""
    if not config.profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        yield
        if on_card:
            # Every kernel of the block ends inside the profiled window.
            torch.cuda.synchronize()
    os.makedirs(config.profile_dir, exist_ok=True)
    path = os.path.join(config.profile_dir, "profile.json")
    prof.export_chrome_trace(path)
    print(f"[profile] -> {path}", file=sys.stderr, flush=True)


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
                config.checkpoint_dir, learner.state_template(), replay, config=config,
                meta_out=meta, device=learner.device)
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
            config.checkpoint_dir, learner.state_template(), replay, step=step, config=config,
            meta_out=meta, device=learner.device)
    learner.load_state(state)
    if meta_out is not None:
        meta_out.update(meta)
    return step, env_steps, meta.get("v_bounds")


def elect_and_resume(config: DDPGConfig, learner, replay, process_index: int, pod_stats,
                     meta_out: Optional[Dict[str, Any]] = None
                     ) -> Optional[Tuple[int, int, Optional[Tuple[float, float]]]]:
    """A pod's coordinated resume (JAX train.py:848-890): every rank
    gathers its node's valid checkpoint steps, those of the checkpoint
    directory and of its own proc<k> directory (checkpoint.pod_dir, where
    a pod abort left node k's emergency checkpoint), and restores the
    greatest step every node holds (multihost.elect_resume_step), from
    the directory that holds it. A collective: every rank calls it,
    whatever it sees on disk. Returns what resume() returns, None when no
    step is common (every node starts fresh)."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.parallel import multihost

    main_steps = set(ckpt_lib.valid_steps(config.checkpoint_dir))
    own_dir = ckpt_lib.pod_dir(config.checkpoint_dir, process_index)
    own_steps = set(ckpt_lib.valid_steps(own_dir)) if own_dir != config.checkpoint_dir else set()
    elected = multihost.elect_resume_step(main_steps | own_steps)
    if elected < 0:
        return None
    meta: Dict[str, Any] = {}
    resume_dir = config.checkpoint_dir if elected in main_steps else own_dir
    state, step, env_steps = ckpt_lib.restore(resume_dir, learner.state_template(), replay,
                                              step=elected, config=config,
                                              meta_out=meta, device=learner.device)
    learner.load_state(state)
    pod_stats.record_resume_elected(elected)
    trace.instant("pod_resume_elected", step=elected)
    print(f"[pod] resume election: step {elected} is the newest checkpoint valid on every "
          f"node (from {resume_dir})", flush=True)
    if meta_out is not None:
        meta_out.update(meta)
    return step, env_steps, meta.get("v_bounds")


def pod_env_steps(offset: int, received) -> int:
    """A pod's global env-step count: the resumed checkpoint's env steps
    (`offset`, a global count) once, plus every node's pool's (`received`,
    one a node). The JAX trainer sums each process's offset plus its pool's
    count, so N processes count a resumed offset N times and a resumed pod
    stops early; here it counts once (ROADMAP.md Queue 3)."""
    return int(offset) + int(np.sum(received))


def slices_adoptable(config: DDPGConfig) -> bool:
    """A complete, verified replay slice set of a sharded run is on disk, so
    a pod that lost a peer may relaunch smaller and adopt it (exit 78, JAX
    _slices_adoptable)."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib

    return bool(config.checkpoint_dir and config.replay_sharding == "sharded"
                and ckpt_lib.latest_complete_slice_step(config.checkpoint_dir) is not None)


def _pod_degraded_early(e: BaseException, pod_stats, config: DDPGConfig) -> Dict[str, Any]:
    """A peer lost in the pod's bootstrap (the startup barrier, the clock
    handshake), before the training stack exists: nothing to checkpoint,
    but main() still exits 76, or 78 when an earlier run left a complete
    slice set (JAX :529-554)."""
    pod_stats.record_abort()
    shrink = slices_adoptable(config)
    print(f"[train] pod peer lost during pod bootstrap: {e}; exiting "
          f"{EXIT_POD_SHRINK if shrink else EXIT_POD_DEGRADED}", file=sys.stderr, flush=True)
    return {"learner_steps_per_sec": 0.0, "learner_steps": 0, "final_return": None,
            "preempted": False, "pod_degraded": True, "pod_shrink_ready": shrink,
            **pod_stats.snapshot()}


def adopt_replay_slices(config: DDPGConfig, replay, group, is_multi: bool, pod_stats,
                        learn_steps: int) -> Optional[int]:
    """The elastic restart's adoption (JAX :934-1010): a sharded run's
    learner checkpoint carried no replay, so the ring comes from the
    newest complete, verified slice set at or below the restored step,
    written by any number of ranks n_prev: the set is elected (every node
    the same step, multihost.elect_slice_step; on one node rank 0's
    answer), merged in logical order and loaded, each rank keeping its own
    positions among today's D (the reshard). D < n_prev is a shrink
    (pod_state_degraded until a grow), D > n_prev a grow. A collective on
    D > 1 ranks. Returns the adopted step, None when there was none (the
    ring resumes empty)."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.parallel import mesh, multihost
    from distributed_ddpg_tpu_torch.replay.device import merge_slice_states

    sstep = ckpt_lib.latest_complete_slice_step(config.checkpoint_dir, at_or_below=learn_steps)
    if is_multi:
        elected = multihost.elect_slice_step(sstep)
    else:
        lead = group is None or group.lead
        elected = int(mesh.share([-1 if sstep is None or not lead else sstep], group)[0])
    if elected < 0:
        print(f"[pod] no verified replay slice set to adopt at or below step {learn_steps}; "
              "the buffer resumes empty", file=sys.stderr, flush=True)
        return None
    slices = ckpt_lib.load_replay_slices(config.checkpoint_dir, elected)
    replay.load_state_dict(merge_slice_states(slices))
    n_prev, now = len(slices), replay.n_shards
    pod_stats.record_slice_adopted(elected)
    trace.instant("pod_slice_adopted", step=elected)
    print(f"[pod] adopted replay slices from step {elected} (written by {n_prev} "
          f"process(es), resharded to {now})", file=sys.stderr, flush=True)
    if now < n_prev:
        pod_stats.record_shrink()
        print(f"[pod] SHRINK: running at {now}/{n_prev} processes with the lost peer's "
              "replay adopted — state degraded until a grow", file=sys.stderr, flush=True)
    elif now > n_prev:
        pod_stats.record_grow()
        print(f"[pod] GROW: resharded {n_prev}-writer replay to {now} processes — state "
              "healthy", file=sys.stderr, flush=True)
    return elected


def train(config: DDPGConfig, echo: bool = True, group=None) -> Dict[str, Any]:
    """Trains with `config` and returns the run's summary. With `group` (a
    parallel/mesh.DataGroup of D ranks) every rank calls this: rank 0 runs
    the actors, the eval and the log, and its decisions and rows go to the
    others (see the module's docstring); its summary carries the final
    return, the others' None. backend='native' runs train_native."""
    _enable_faulthandler()
    if config.backend == "native":
        return train_native(config, echo)
    if config.backend == "jax_ondevice":
        return train_ondevice(config, echo, group)
    return _train_operated(config, echo, group)


def _load_training_stack(config: DDPGConfig) -> None:
    """Import what _train_impl imports (see _train_operated). Workers never
    call this: the module stays torch-free for them."""
    import importlib

    for name in ("torch", "distributed_ddpg_tpu_torch.checkpoint",
                 "distributed_ddpg_tpu_torch.parallel.learner",
                 "distributed_ddpg_tpu_torch.parallel.megastep",
                 "distributed_ddpg_tpu_torch.parallel.prefetch",
                 "distributed_ddpg_tpu_torch.replay.device",
                 "distributed_ddpg_tpu_torch.obs"):
        importlib.import_module(name)
    if config.tb_dir:
        try:
            importlib.import_module("torch.utils.tensorboard")
        except Exception:
            pass   # MetricsLogger says it once when it cannot write


def _train_operated(config: DDPGConfig, echo: bool, group) -> Dict[str, Any]:
    """The flight recorder and the stall watchdog around the whole device
    lifetime of one training run (JAX train_jax): the learner's
    construction, the first params d2h, every loop turn and the teardown.
    The recorder is exported on the way out (and on SIGUSR2); the watchdog
    dies with the call, so it never fires on a process that has already
    left the run through an ordinary exception.

    The one-time imports of the run (torch and the port's training stack,
    and with tb_dir TensorBoard's writer, which pulls in TensorFlow where
    it is installed) load before the watchdog is armed: the watchdog times
    the device lifetime, and on a loaded host an import can take longer
    than watchdog_s (where the JAX trainer has them loaded with its own
    module)."""
    _load_training_stack(config)
    trace_path = ""
    if config.trace_dir:
        trace.configure(capacity=config.trace_events)
        rank = group.rank if group is not None else 0
        trace_path = os.path.join(config.trace_dir,
                                  "trace.json" if rank == 0 else f"trace_rank{rank}.json")
        trace.install_signal_export(trace_path)
    beats = [0]

    def beat() -> None:
        beats[0] += 1

    watchdog = None
    if config.watchdog_s > 0:
        from distributed_ddpg_tpu_torch.watchdog import Watchdog

        # The stall artifacts land beside the trace, else beside the
        # checkpoints, else in the cwd: always somewhere findable.
        watchdog = Watchdog(config.watchdog_s, progress=lambda: beats[0],
                            stall_dir=config.trace_dir or config.checkpoint_dir or ".").start()

    def grant(extra_s: float) -> None:
        """Suspend the watchdog for extra_s seconds, or (extra_s == 0) end
        the allowance (Watchdog.end_grant)."""
        if watchdog is not None:
            if extra_s > 0:
                watchdog.grant(extra_s)
            else:
                watchdog.end_grant()

    try:
        return _train_impl(config, echo, group, beat, grant)
    finally:
        if watchdog is not None:
            watchdog.stop()
        if trace_path:
            try:
                n = trace.export(trace_path)
                print(f"[trace] {n} events -> {trace_path} (load in ui.perfetto.dev)",
                      file=sys.stderr, flush=True)
            except Exception as e:
                # A full disk loses the trace, not the run (nor masks the
                # exception in flight).
                print(f"[trace] export failed: {e!r}", file=sys.stderr, flush=True)
            finally:
                trace.disable()


def _train_impl(config: DDPGConfig, echo: bool, group, _beat, _grant) -> Dict[str, Any]:
    """train() on the jax_tpu backend; `_beat` advances the watchdog's
    progress count, `_grant(s)` suspends it for s seconds and `_grant(0)`
    ends that allowance."""
    # torch loads here, not at import: spawned actor workers re-import the
    # main module (this one, under `python -m`) and must stay torch-free.
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.actors.sync_pool import SyncActorPool
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.native import NativeSumTree
    from distributed_ddpg_tpu_torch.obs import health
    from distributed_ddpg_tpu_torch.obs import PodAggregator
    from distributed_ddpg_tpu_torch.parallel import mesh, multihost
    from distributed_ddpg_tpu_torch.parallel.learner import (
        ShardedLearner,
        resolve_learner_chunk,
        state_tensors,
    )
    from distributed_ddpg_tpu_torch.parallel.megastep import FusedMegastep, fused_beat_active
    from distributed_ddpg_tpu_torch.parallel.prefetch import ChunkPrefetcher
    from distributed_ddpg_tpu_torch.parallel.superstep import FusedSuperstep, per_beat_betas
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    lead = group is None or group.lead
    # The pod (parallel/multihost.py): more than one node. Each node's lead
    # runs its node's actors; with one node rank 0 runs them all.
    is_multi = group is not None and bool(getattr(group, "is_pod", False))
    actor_host = group is None or (group.node_lead if is_multi else group.lead)
    proc_idx = group.process_index if is_multi else 0
    env = make(config.env_id, seed=config.seed)
    spec = spec_of(env)
    chunk = resolve_learner_chunk(config)
    min_fill = max(config.replay_min_size, config.batch_size)
    # A fresh health state (a run in the same interpreter must not inherit
    # the last one's latched `draining`).
    health.get().reset()
    obs_server = None
    fault_plan = config.fault_plan()
    ckpt_fault = fault_plan.site("ckpt", "write") if fault_plan else None
    pod_stats = PodStats(seed=config.seed)
    pod_lost: Optional[BaseException] = None
    if is_multi:
        # The pod's bootstrap (JAX :506-590): arm the collective deadline,
        # then the one-time barrier with its own grace, then the clock
        # handshake, all before anything else talks to the peers.
        multihost.use_group(group)
        multihost.configure_pod(config.pod_collective_timeout_s, stats=pod_stats)
        try:
            multihost.startup_barrier(config.pod_startup_grace_s)
            clocks = multihost.clock_handshake()
            if clocks is not None:
                trace.set_meta(process_index=proc_idx, process_count=group.process_count,
                               clock_offset_ms=clocks["offset_ms"][proc_idx],
                               pod_wall_ms=clocks["wall_ms"])
        except multihost.PodPeerLost as e:
            multihost.configure_pod(0.0)
            return _pod_degraded_early(e, pod_stats, config)

    def _grant_all(extra_s: float) -> None:
        """Extend both stall detectors across a known-long window (the
        first chunk's kernel build, a support expansion): the watchdog by
        extra_s, the pod deadline by pod_startup_grace_s (only the build's
        skew between nodes can delay a pod collective, so the worst-case
        detection stays deadline + grace). _grant_all(0) ends both, once
        the window's chunk has run."""
        _grant(extra_s)
        if is_multi:
            if extra_s > 0:
                multihost.grant(config.pod_startup_grace_s)
            else:
                multihost.end_grant()

    learner = ShardedLearner(
        config, spec.obs_dim, spec.act_dim, spec.action_scale,
        spec.action_offset, chunk_size=chunk, group=group,
    )
    _beat()   # the learner's construction survived
    device = learner.device
    host_replay, strict = config.host_replay, config.strict_sync
    if host_replay and learner.data_size > 1:
        raise ValueError(
            f"host_replay=True on {learner.data_size} ranks is not in this slice of the "
            "PyTorch port: a host replay a rank under the lockstep driver comes with "
            "ROADMAP.md Queue 1 item 10 (its data-plane half); run the host replay on "
            "one rank")
    if config.serve_actors and learner.data_size > 1:
        raise ValueError(
            f"serve_actors=True on {learner.data_size} ranks is not in this slice of the "
            "PyTorch port: serving beside a data-parallel learner comes with ROADMAP.md "
            "Queue 1 item 10 (its data-plane half); serve on one rank")
    if (config.replay_sharding == "sharded" and config.distributional
            and config.v_support_auto and learner.data_size > 1):
        # JAX train.py:616-631 (its n_proc > 1: a rank of the port is a
        # process): the support sizer's reward reads would be cross-rank
        # gathers that only rank 0 makes.
        raise ValueError(
            "v_min/v_max=auto with replay_sharding='sharded' is not "
            "supported multi-process: the support sizer's host-side "
            "reward reads are cross-shard gathers outside the lockstep "
            "lane. Use replicated replay or concrete v_min/v_max.")
    device_actors = config.actor_backend == "device"
    if device_actors and learner.data_size > 1:
        raise ValueError(
            f"actor_backend='device' on {learner.data_size} ranks is not in this slice of "
            "the PyTorch port: the rollout over a data-parallel group comes with "
            "ROADMAP.md Queue 1 item 10 (its data-plane half); run the device actors on "
            "one rank")
    # After every check that can refuse the run, so a refusal leaks no
    # dispatch thread; closed after the replay (teardown below). Off under
    # strict_sync: its dispatch timing would make the records depend on
    # the host's scheduling (and with it the adaptive cap and the pool).
    # On a pod its lockstep lane carries the background beats, each under
    # the pod deadline.
    transfer_sched = (
        TransferScheduler(fault=fault_plan.site("transfer", "dispatch") if fault_plan else None,
                          lockstep_timeout_s=config.pod_collective_timeout_s if is_multi else 0.0)
        .start() if config.transfer_scheduler and not strict else None)
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
    numeric_replay_at = fault_plan.numeric_replay_rows()
    ingested_rows = 0
    replay_kwargs = dict(
        block_size=1024,
        async_ship=ingest_async,
        max_coalesce=config.ingest_coalesce,
        scheduler=transfer_sched,
        adaptive_coalesce=transfer_sched is not None and config.ingest_coalesce_adaptive,
        host_pool=transfer_sched is not None and config.transfer_host_pool,
        track_sources=track_sources,
        fault=fault_plan.site("shipper", "ship") if fault_plan else None,
        pod=group if is_multi else None,
        background_sync=config.sync_ship_background,
        replay_sharding=config.replay_sharding,
        # A sharded ring is split over the data group: the ranks of one
        # model group hold the same slots.
        group=learner.data_group,
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
    # A sharded ring spans the ranks, so no rank can checkpoint it alone:
    # the learner checkpoints carry no replay, and every rank writes its
    # slice of the ring beside them at each cadence and in the emergency
    # save (the all-writer slices, JAX :776-822); a one-rank sharded run
    # writes one slice over the whole ring, so the format never depends on
    # the rank count.
    slice_writer = not host_replay and config.replay_sharding == "sharded"
    # A slice a data index: under model_axis > 1 the ranks of a model group
    # hold the same slots, and its first rank writes them.
    my_rank = learner.rank
    slice_fault = fault_plan.slice_site(my_rank) if (fault_plan and slice_writer) else None
    if slice_writer and lead:
        print("[replay] sharded mode: replay contents are omitted from checkpoints' "
              "learner tree; every process writes its replay slice",
              file=sys.stderr, flush=True)
    log = MetricsLogger(config.log_path if lead else "", echo=echo and lead,
                        tb_dir=config.tb_dir if lead else "",
                        header=({} if host_replay else dict(
                            replay_sharding=config.replay_sharding,
                            replay_shard_count=replay.n_shards,
                            replay_device_storage_bytes=(replay.storage.numel()
                                                         * replay.storage.element_size()))))
    env_timer, learn_timer = Timer(), Timer()
    phases = PhaseTimers(seed=config.seed)
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
        return dict(ckpt_skipped=saver.skipped, resumed_from=resumed_from)

    def auto_bounds() -> Optional[Tuple[float, float]]:
        """The resolved auto C51 support, which a checkpoint must carry."""
        if config.distributional and config.v_support_auto:
            return learner.config.v_min, learner.config.v_max
        return None

    def ingest_fields() -> Dict[str, Any]:
        """The interval's ingest_*, replay_* and transfer_* fields (each
        snapshot starts a new interval); the host replay has no ingest
        pipeline. The shard fill is every rank's, as last gathered."""
        out = {} if host_replay else {**replay.ingest_snapshot(),
                                       **replay.shard_snapshot(shard_fills[0])}
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
                    t_sample_wait_run_ms=1000.0 * sample_wait_s / max(chunks, 1), **tree)

    mesh_stats = MeshStats(learner.data_size, learner.model_axis)

    def mesh_fields() -> Dict[str, Any]:
        """The mesh_* placement facts (metrics.MeshStats, every train and
        final record, JAX :1435-1444), and on more than one rank the grid's
        data axis, global batch and route."""
        out = mesh_stats.snapshot(state_tensors(learner.state), learner.state_sharded())
        if learner.data_size == 1 and learner.model_axis == 1:
            return out
        out.update(data_axis=learner.data_size, global_batch=learner.global_batch,
                   route=learner.route(per=config.prioritized))
        if is_multi:
            out.update(process_index=proc_idx, process_count=group.process_count)
        return out

    def pod_fields() -> Dict[str, Any]:
        """The pod_* counters (metrics.PodStats) of every train and final
        record on a pod; on one node only once an elastic event (a slice
        set adopted, a shrink, a grow) happened, so a pod shrunk to one
        node still shows its degraded state (JAX :1385-1397)."""
        return pod_stats.snapshot() if is_multi or pod_stats.elastic_events() else {}

    def ckpt_replay():
        """The replay a learner checkpoint carries: none for a sharded one."""
        return None if slice_writer else replay

    def write_replay_slices(step: int) -> None:
        """This rank's slice of the sharded ring at `step`, beside the
        learner checkpoint (checkpoint.write_replay_slice). A failed write
        costs the step's set its completeness, never the run: adoption
        falls back to an older complete set. Under model_axis > 1 the model
        group's first rank writes its data index's slice."""
        if not (slice_writer and config.checkpoint_dir) or learner.model_rank != 0:
            return
        try:
            ckpt_lib.write_replay_slice(config.checkpoint_dir, step, my_rank,
                                        learner.data_size, replay.slice_state_dict(),
                                        fault=slice_fault)
        except Exception as e:
            print(f"[pod] replay slice write at step {step} failed ({e!r}); the step's "
                  "slice set stays incomplete", file=sys.stderr, flush=True)

    # Every rank's local fill of a ring sharded over D > 1 ranks, gathered
    # on the 50-chunk cadence (the replay_shard_fill_min/max fields).
    shard_fills: list = [None]

    def gather_shard_fills() -> None:
        if slice_writer and learner.data_size > 1:
            import torch

            mine = torch.tensor([replay.local_fill], dtype=torch.int64, device=device)
            shard_fills[0] = dispatch(lambda: mesh.all_gather(mine, learner.data_group),
                                      "shard_fill_gather").reshape(-1).tolist()

    def dispatch(fn, label: str = "learner_chunk"):
        """A learner-side collective: on a pod a transport error in it is a
        PodPeerLost (multihost.typed_peer_loss), the abort's way out."""
        return multihost.typed_peer_loss(fn, label) if is_multi else fn()

    # --- the pod's beats (JAX :1340-1373) ---
    # With the scheduler on a pod the sync_ship beat after each chunk is a
    # background item of the lockstep lane, and the loop waits it before
    # its next collective (wait_beat). The warmup and a forced beat wait at
    # once: the warmup's loop reads the replicated fill, which every rank
    # must see after the same beat.
    bg_sync = transfer_sched is not None and is_multi and config.sync_ship_background
    pending_beat = [None]
    # The global env-step count of a pod, gathered every 10th loop turn.
    cached_global = [0]

    def wait_beat() -> None:
        """Resolve the outstanding background beat, if any, within
        multihost.beat_result_timeout_s (a PodPeerLost past it)."""
        t = pending_beat[0]
        if t is not None:
            pending_beat[0] = None
            with phases.phase("sync_ship_wait"):
                multihost.wait_beat_ticket(t)

    def ordered(fn, label: str):
        """A pod collective of the training loop's: on the lockstep lane behind the
        queued beats when they run in the background (one collective order
        on every rank), else here."""
        if bg_sync:
            return multihost.wait_beat_ticket(
                transfer_sched.submit("lockstep", fn, label=label), label=label)
        return fn()

    def data_bounds():
        return support_auto.replay_data_bounds(replay, config.gamma, config.n_step)

    def guardrail_fields() -> Dict[str, Any]:
        return gstats.snapshot() if guard_on else {}

    def recovery_fields() -> Dict[str, Any]:
        """The cumulative fault-history counters of every train and final
        record (the JAX trainer's)."""
        return {**(pool.recovery_counters() if pool is not None else {}),
                "ckpt_write_retries": saver.write_retries,
                "emergency_ckpt": emergency_ckpt}

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

    def received() -> int:
        """Env steps this rank's host pool delivered (none without one)."""
        return pool.steps_received if pool is not None else 0

    def local_env_steps() -> int:
        """Env steps of this rank's sources: the host pool's, the device
        actors', and the resumed checkpoint's."""
        return (env_offset + received()
                + (device_pool.steps_done if device_pool is not None else 0))

    def env_steps() -> int:
        """The global env-step count. One node: as rank 0's sources have
        it (with the resumed checkpoint's), shared; rank 0's SIGTERM flag
        rides the same share and latches `stopping` on every rank at once.
        A pod: the last gathered count (global_env_steps, every 10th loop
        turn), and each node's own SIGTERM (JAX: a node that leaves ends
        its peers' run through PodPeerLost)."""
        nonlocal stopping
        if is_multi:
            stopping = stopping or preempt.is_set()
            return cached_global[0]
        n, flag = mesh.share([local_env_steps(), float(preempt.is_set())]
                             if lead else [0, 0.0], group)
        stopping = stopping or bool(flag)
        return int(n)

    def global_env_steps() -> int:
        """A pod's global env-step count (pod_env_steps), all-gathered so
        every rank sees the same number: the loop's stop test and PER's
        beta read it."""
        def gather() -> int:
            return pod_env_steps(env_offset, multihost.allgather_scalar(np.int64(received())))

        cached_global[0] = ordered(gather, "env_steps_allgather")
        return cached_global[0]

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
        with phases.phase("devactor"):
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
        with phases.phase("ingest"):
            return ingest_rows()

    def ingest_rows() -> int:
        rows, pairs = None, []
        if is_multi and replay.pending_rows >= 8 * replay.block_size:
            # Backpressure (JAX :1724-1732): a beat ships the nodes' common
            # minimum, so a node whose actors outpace the slowest would
            # stage without bound; it stops draining and its workers block.
            return 0
        if actor_host:
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
            if not is_multi:
                # One node: rank 0's rows on every rank. A pod's rows leave
                # the node by the beat (ingest_once).
                rows = mesh.share_rows(rows, width, group)
            moved = 0 if rows is None else len(rows)
            if moved:
                insert(rows)
        env_timer.tick(moved)
        return moved

    def ingest_once(force_ship: bool = False, sync_wait: bool = True) -> int:
        """A pod's ingest beat (JAX ingest_once): drain this node's actors
        into the staging ring, then the sync_ship beat that every rank
        issues at the same point; in the background (sync_wait=False,
        bg_sync) it is left pending for wait_beat. One beat at most is
        ever outstanding."""
        moved = ingest()
        wait_beat()
        if bg_sync and not sync_wait and not force_ship:
            pending_beat[0] = replay.sync_ship_begin()
        else:
            replay.sync_ship(force=force_ship)
        return moved

    def evaluate(at_step: int) -> float:
        t0 = time.monotonic()
        with phases.phase("eval_snapshot"):
            flat = learner.actor_params_to_host()
        eval_policy.load_flat(flat)
        ret = _eval_numpy(eval_policy, config, spec)
        learn_timer.exclude(time.monotonic() - t0)
        log.log("eval", at_step, eval_return=ret)
        return ret

    def monitor() -> None:
        nonlocal last_monitor_t
        if actor_host and time.monotonic() - last_monitor_t >= 1.0:
            last_monitor_t = time.monotonic()
            pool.monitor()

    def emergency_logical_state():
        """On a pod abort under model_axis > 1: the logical state, gathered
        over this rank's model group under the pod deadline when the group
        lies on this node (every rank of such a group takes the same
        branch). None, and so no emergency checkpoint from this rank, when
        the group spans nodes (one of them may be the lost one, which the
        pod plane cannot always name) or the gather fails: the last
        cadence checkpoint is then the resume point."""
        if not learner.group.model_on_node:
            print("[train] pod abort with model_axis > 1: this rank's model group spans "
                  "nodes, no emergency checkpoint from it (a lost node's shards cannot be "
                  "gathered)", file=sys.stderr, flush=True)
            return None
        try:
            return multihost.call_with_deadline(learner.logical_state, label="emergency_gather")
        except Exception as e:
            print(f"[train] pod abort with model_axis > 1: the model group's gather failed "
                  f"({e!r}), no emergency checkpoint from it", file=sys.stderr, flush=True)
            return None

    def emergency_checkpoint() -> int:
        """After SIGTERM or a pod abort: land the write in flight (its
        failure does not cost this save), then rank 0 writes this step
        unless the cadence has just written it; on a pod abort every
        surviving node's lead writes one, node k into its proc<k>
        directory (checkpoint.pod_dir), so a relaunched pod can elect a
        common step even where each node keeps its own disk. Returns
        emergency_ckpt's value."""
        try:
            saver.wait()
        except Exception as e:
            print(f"[train] in-flight checkpoint write failed during preemption ({e!r}); "
                  "writing the emergency checkpoint anyway", file=sys.stderr, flush=True)
            saver.errors.clear()
        # Every rank writes its replay slice, into the shared directory (on
        # a pod abort the lost peer's is missing, so this step's set stays
        # incomplete and adoption takes the last complete one). A pod that
        # is whole lands its outstanding beat first, as at the cadence.
        if slice_writer and pod_lost is None:
            wait_beat()
        write_replay_slices(learn_steps)
        if not config.checkpoint_dir:
            return 0
        if learner.model_axis > 1:
            ckpt_state = (learner.logical_state() if pod_lost is None   # every rank
                          else emergency_logical_state())
            if ckpt_state is None:
                return 0
        else:
            ckpt_state = learner.state
        if not (lead or (pod_lost is not None and actor_host)):
            return 0
        my_dir = ckpt_lib.pod_dir(config.checkpoint_dir, proc_idx)
        if ckpt_lib.latest_step(my_dir) != learn_steps:
            with phases.phase("ckpt"):
                ckpt_lib.save(my_dir, learn_steps, ckpt_state, ckpt_replay(), config,
                              env_steps=n_env, v_bounds=auto_bounds(),
                              keep=config.checkpoint_keep, retries=config.ckpt_write_retries,
                              backoff_s=config.ckpt_retry_backoff_s,
                              devactor_state=devactor_state(), fault=ckpt_fault)
        trace.instant("emergency_ckpt", step=learn_steps)
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
        trace.instant("numeric_abort", step=learn_steps)
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
        nonlocal learn_steps, last_ckpt, next_refresh, last_refresh_t, lr_backoff_since, granted
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
                                                      ckpt_replay(), config=config,
                                                      meta_out=meta, at_most=before)
                except (FileNotFoundError, RuntimeError):
                    state, step, _ = ckpt_lib.restore(config.checkpoint_dir, learner.state,
                                                      ckpt_replay(), config=config,
                                                      meta_out=meta)
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
        with phases.phase("refresh"):
            pool.broadcast(learner.actor_params_to_host(), learn_steps)
        if device_pool is not None and "devactor_carry" in meta:
            # The rollout state rolls back with the learner: its episodes
            # go on from the restored point.
            device_pool.load_carry_state(meta["devactor_carry"])
        next_refresh = learn_steps + config.param_refresh_every
        last_refresh_t = time.perf_counter()
        _grant(max(300.0, 2.0 * config.watchdog_s))
        granted = True
        trace.instant("rollback", step=step, rolled_from=rolled_from)
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
            trace.instant("lr_cooldown", step=learn_steps)
            print(f"[guardrail] LR cooldown complete at step {learn_steps}: learning rates "
                  "restored", file=sys.stderr, flush=True)
        return handled

    # The handler only sets a flag (no I/O in a signal handler); the loop
    # reads it at a chunk's end. Off the main thread there is none.
    def on_sigterm(*_) -> None:
        preempt.set()
        # /healthz reads `draining` from the first scrape after the signal.
        health.get().drain("preempted (SIGTERM)")

    prev_sigterm = None
    try:
        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        pass
    ingest_chunk_s = 0.0              # the driver's time in ingest while chunks ran
    ingest_max_s = 0.0
    ingest_calls = 0
    pod_shrink_ready = False          # a pod abort with a complete slice set (exit 78)
    bootstrapped = False              # past the resume: an abort writes a checkpoint
    try:
        if config.resume and config.checkpoint_dir:
            restored = (elect_and_resume(config, learner, ckpt_replay(), proc_idx, pod_stats,
                                         meta_out=resume_meta) if is_multi
                        else resume(config, learner, ckpt_replay(), group,
                                    meta_out=resume_meta))
            if restored is not None:
                learn_steps, env_offset, bounds = restored
                resumed_from, n_env = learn_steps, env_offset
                if bounds is not None and config.distributional and config.v_support_auto:
                    learner.set_value_bounds(*bounds)
                    log.log("support", env_offset, reason="checkpoint", **support_fields())
                print(f"resumed from {config.checkpoint_dir} at learner step {learn_steps}, "
                      f"env step {env_offset}", flush=True)
                if slice_writer and not resume_meta.get("ckpt_has_replay"):
                    adopt_replay_slices(config, replay, group, is_multi, pod_stats,
                                        learn_steps)
        bootstrapped = True
        cached_global[0] = n_env
        if actor_host:
            # strict_sync: inline deterministic actors, the same surface.
            pool = (SyncActorPool if strict else ActorPool)(config, spec,
                                                            env_steps_offset=env_offset)
            if config.serve_actors:
                serve_server, serve_front, front_server = start_serving(
                    config, spec, pool, transfer_sched, learner.actor_params_to_host())
            pool.start(learner.actor_params_to_host())
            _beat()   # the first params d2h survived
            obs_server = start_exporter(config, log, preempt, group)
            if serve_server is not None:
                # /healthz reads the serve queue as of the scrape.
                health.get().register_probe("serve_overloaded", serve_server.overloaded)
        if device_actors:
            # After the resume, so the uniform warmup nets out the restored
            # env steps (JAX :1011-1041). The pool reads the learner's live
            # params at each dispatch.
            from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool

            device_pool = DeviceActorPool(
                config, device=device, warmup_offset=env_offset,
                fault=fault_plan.site("devactor", "rollout") if fault_plan else None)
            device_pool.bind(lambda: learner.state.actor_params)
            if "devactor_carry" in resume_meta:
                device_pool.load_carry_state(resume_meta["devactor_carry"])
            _beat()
        if fused_beat_active(config, learner, device_pool is not None):
            # The fused beat (JAX :1043-1090): learn, roll out and scatter
            # in one dispatch; B of them a dispatch under superstep_beats.
            megastep = (FusedSuperstep(config, learner, device_pool, replay)
                        if config.superstep_beats > 1
                        else FusedMegastep(config, learner, device_pool, replay))
        beats = megastep.beats if megastep is not None else 1

        # --- warmup: fill replay to the learning threshold ---
        # The beat below keeps the watchdog quiet whether or not rows
        # arrive, so an actor-side stall (workers alive, no experience)
        # has a deadline of its own: no rows for 10x watchdog_s raises on
        # this (healthy) thread.
        stall_deadline = 10.0 * config.watchdog_s if config.watchdog_s > 0 else 0.0
        last_moved_t = time.monotonic()

        def check_actor_stall(where: str) -> None:
            if stall_deadline and time.monotonic() - last_moved_t > stall_deadline:
                raise RuntimeError(
                    f"{where}: no experience ingested for {stall_deadline:.0f}s "
                    "(10x watchdog_s) with the learner thread healthy — actor-side "
                    "stall; aborting instead of burning the wall-clock budget")

        last_monitor_t = time.monotonic()
        warm_it = 0
        while len(replay) < min_fill and not (is_multi and preempt.is_set()):
            if is_multi:
                # The pod's lockstep warmup (JAX :2254-2290): the test above
                # reads the replicated fill, so every rank takes the same
                # beats, each waited at once; every 20th pads a block from
                # the remainders, so slow actors still cross the threshold.
                fill = len(replay)
                moved = ingest_once(force_ship=warm_it % 20 == 19) + len(replay) - fill
                warm_it += 1
            else:
                moved = ingest() + devactor_step()
            _beat()
            if (not is_multi and not host_replay
                    and len(replay) + replay.pending_rows >= min_fill):
                replay.flush()
            monitor()
            if moved:
                last_moved_t = time.monotonic()
            else:
                check_actor_stall("warmup")
                time.sleep(0.01)
        trace.instant("warmup_done", buffer_fill=len(replay))
        if is_multi and fault_plan:
            # Armed at the warmup's end, a point every node reaches at the
            # same beat, so `@K` counts steady-state beats (JAX :2295-2302).
            replay.arm_pod_fault(fault_plan.pod_site(proc_idx))
        pod_agg = None
        if is_multi:
            # Each cadence every node's snapshot goes into one gather and
            # node 0 logs the `pod` record (JAX :1886-1893).
            pod_agg = PodAggregator(
                gather_fn=lambda vec: multihost.allgather_scalar(vec, label="pod_obs_gather"),
                stats=pod_stats)

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
                fault=fault_plan.site("prefetch", "sample") if fault_plan else None,
            ).start()

        learn_timer.reset()
        env_timer.reset()
        next_refresh = 0
        last_refresh_t = last_log_t = 0.0
        last_eval = 0
        last_ckpt = learn_steps
        out = None
        last_budget = -1
        first_dispatch_done = False
        # The first chunk builds the kernels with nvcc at their first
        # launch (minutes on a cold build): an allowance, so a slow build is
        # not killed as a stall, ended once that chunk has run (granted).
        _grant_all(max(300.0, 2.0 * config.watchdog_s))
        granted = True
        it = 0
        with _profiled(config, device):
            while True:
                _beat()
                monitor()
                if is_multi and it % 10 == 0:
                    # A pod's global budget, every 10th turn: the cadence is
                    # the same on every rank, and the loop pays one gather
                    # a 10 chunks (JAX :2363-2373).
                    global_env_steps()
                it += 1
                n_env = env_steps()
                if stopping or n_env >= config.total_env_steps and learn_steps > 0:
                    trace.instant("budget_met", env_steps=n_env, learn_steps=learn_steps)
                    break
                # Actor-stall coverage after the warmup: env-step progress is
                # the one sign the actors are alive (the beat above keeps the
                # watchdog quiet either way).
                if n_env > last_budget:
                    last_budget = n_env
                    last_moved_t = time.monotonic()
                else:
                    check_actor_stall("train loop")
                if config.max_learn_ratio > 0.0 and learn_steps > 0 and (
                    learn_steps + chunk > min_fill + config.max_learn_ratio * n_env
                ):
                    # Learner-rate cap: ingest instead of dispatching until env
                    # steps catch up with the allowance.
                    if not (ingest_once(sync_wait=False) if is_multi
                            else ingest() + devactor_step()):
                        time.sleep(0.002)
                    continue
                # A pod's dispatch gate: the last beat has landed on every
                # rank before this rank's next collective.
                wait_beat()
                if host_replay:
                    t_wait = time.perf_counter()
                    with phases.phase("sample_wait"):
                        device_chunk, indices = prefetch.next()
                    sample_wait_s += time.perf_counter() - t_wait
                    with phases.phase("dispatch"):
                        out = learner.run_chunk_async(device_chunk)
                elif megastep is not None:
                    # The fused beat: this chunk, the rollout with its updated
                    # params and their scatter in one dispatch (B beats a
                    # dispatch for a superstep, its PER betas the sequential
                    # loop's, one host read at its end).
                    if beats > 1:
                        betas = (per_beat_betas(config, n_env, beats, device_pool.rows_per_chunk)
                                 if config.prioritized else None)
                        with phases.phase("dispatch"):
                            out = megastep.run_superstep(betas)
                        beta = float(betas[-1]) if config.prioritized else beta
                    else:
                        frac = min(1.0, n_env / config.total_env_steps)
                        beta = config.per_beta + frac * (config.per_beta_final - config.per_beta)
                        with phases.phase("dispatch"):
                            out = megastep.run_beat(beta if config.prioritized else None)
                    env_timer.tick(device_pool.rows_per_chunk * beats)
                elif config.prioritized:
                    frac = min(1.0, n_env / config.total_env_steps)
                    beta = config.per_beta + frac * (config.per_beta_final - config.per_beta)
                    with phases.phase("dispatch"):
                        out = dispatch(lambda: learner.run_sample_chunk_per(replay, beta))
                else:
                    with phases.phase("dispatch"):
                        out = dispatch(lambda: learner.run_sample_chunk(replay))
                if not first_dispatch_done:
                    # The first chunk's kernel build must not count against
                    # the actor-stall clock.
                    first_dispatch_done = True
                    last_moved_t = time.monotonic()
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
                while is_multi:
                    # A pod: each rank polls its own chunk's end (every rank
                    # runs the same chunks, so no collective decides it),
                    # staging its node's rows meanwhile, then the beat.
                    if learner.chunk_done():
                        t_ingest = time.perf_counter()
                        ingest_once(sync_wait=False)
                        t_ingest = time.perf_counter() - t_ingest
                        ingest_chunk_s += t_ingest
                        ingest_max_s = max(ingest_max_s, t_ingest)
                        ingest_calls += 1
                        break
                    if not ingest():
                        time.sleep(0.0005)
                while not is_multi:
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
                if granted:
                    _grant_all(0.0)   # the chunk the allowance covered has run
                    granted = False
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
                    with phases.phase("prio_update"):
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
                if actor_host and learn_steps >= next_refresh and (
                    strict or now - last_refresh_t >= config.param_refresh_interval_s
                ):
                    with phases.phase("refresh"):
                        pool.broadcast(learner.actor_params_to_host(), learn_steps)
                    next_refresh = learn_steps + config.param_refresh_every
                    last_refresh_t = time.perf_counter()

                # The 50-chunk cadence as a crossing (a superstep moves B chunks).
                on_fifty = prev_chunks // 50 != chunks // 50
                if config.distributional and config.v_support_auto and on_fifty:
                    # Running expansion: mean_q near an edge of the support, and
                    # the replay's current rewards corroborate a wider one. On
                    # a pod the last beat lands first, so every rank reads the
                    # same replicated rows.
                    wait_beat()
                    with phases.phase("sync"):
                        grown = expand_support(learner, support_controller, out, learn_steps,
                                               data_bounds, group)
                    if grown is not None:
                        _grant_all(max(300.0, 2.0 * config.watchdog_s))
                        granted = True
                        log.log("support", n_env, reason="expanded", mean_q=grown["mean_q"],
                                **support_fields())

                on_cadence = prev_chunks == 0 or on_fifty
                if on_cadence:
                    gather_shard_fills()
                if guard_on and on_cadence:
                    # Re-sampled every cadence: a lifted quarantine takes
                    # /healthz back to healthy.
                    health.get().note("guardrail_quarantine", gstats.source_quarantines > 0)
                if on_cadence and pod_agg is not None:
                    # The pod's aggregation gather, gated on the cadence alone
                    # (the same on every rank), never on a node's clock.
                    health.get().note("pod_state_degraded", pod_stats.degraded)

                    def pod_collect():
                        return pod_agg.collect(
                            beats=learn_steps // chunk, ingest_rows=received(),
                            transfer_backlog=(sum(transfer_sched.queue_depths().values())
                                              if transfer_sched is not None else 0))

                    with phases.phase("pod_obs"):
                        pod_record = ordered(pod_collect, "pod_obs_allgather")
                    if pod_record is not None and lead:
                        log.log("pod", n_env, **pod_record)
                if lead and on_cadence and (strict or now - last_log_t >= 1.0):
                    last_log_t = now
                    episodes = pool.episode_stats()
                    with phases.phase("sync"):
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
                        **pool.staleness(),
                        **recovery_fields(),
                        **metrics,
                        **support_fields(),
                        **per_fields(),
                        **mesh_fields(),
                        **phases.snapshot(),
                        **ingest_fields(),
                        **guardrail_fields(),
                        **devactor_fields(),
                        **fused_fields(),
                        **serve_fields(),
                        **pod_fields(),
                    )
                if lead and config.eval_every and n_env - last_eval >= config.eval_every:
                    last_eval = n_env
                    evaluate(last_eval)
                if config.checkpoint_dir and learn_steps - last_ckpt >= config.checkpoint_every:
                    # One writer: the replicas hold the same state and replay.
                    # Only the snapshot runs here; the write on the saver's thread.
                    # The logical state: on a grid with model_axis > 1 the
                    # shards gathered over each model group, on every rank.
                    ckpt_state = learner.logical_state()
                    if lead:
                        with phases.phase("ckpt"):
                            saver.save_async(
                                config.checkpoint_dir, learn_steps, ckpt_state,
                                ckpt_replay(), config,
                                env_steps=n_env, v_bounds=auto_bounds(),
                                keep=config.checkpoint_keep, retries=config.ckpt_write_retries,
                                backoff_s=config.ckpt_retry_backoff_s,
                                devactor_state=devactor_state(), fault=ckpt_fault)
                    # A sharded ring's slices: every rank, the same step. On a
                    # pod the outstanding beat lands first, so every node's
                    # slice is of the ring after the same beats (else the set
                    # mixes two ring states and its merge refuses it).
                    if slice_writer and config.checkpoint_dir:
                        wait_beat()
                        with phases.phase("ckpt"):
                            write_replay_slices(learn_steps)
                    last_ckpt = learn_steps
        # The rates end with the loop: the teardown below (the actors'
        # exit, an emergency checkpoint) is not the run's pace.
        rate, env_rate = learn_timer.rate(), env_timer.rate()
        if stopping:
            if lead:
                print(f"[train] SIGTERM: the running chunk finished; exiting {EXIT_PREEMPTED} "
                      "(resumable)", file=sys.stderr, flush=True)
            emergency_ckpt = emergency_checkpoint()
    except multihost.PodPeerLost as e:
        # The coordinated clean abort (JAX :2511-2560): a peer node died or
        # hung in a pod collective, and any further collective would block
        # or fork the pod. This node fails the scheduler's pending tickets
        # (a queued beat must never fire against a degraded pod), writes
        # one emergency checkpoint and leaves; main() exits 76 without
        # touching the process group again, and the relaunched pod's
        # election restores one common step everywhere.
        pod_lost = e
        pod_stats.record_abort()
        preempt.set()
        stopping = True
        _grant_all(max(300.0, 2.0 * config.watchdog_s))
        trace.instant("pod_abort", step=learn_steps)
        print(f"[train] pod peer lost at {time.time():.6f}: {e}; coordinated clean abort: "
              f"draining transfers, emergency checkpoint, exit {EXIT_POD_DEGRADED}",
              file=sys.stderr, flush=True)
        # The outstanding beat's ticket failed (or is failing) under the
        # same deadline: never waited again.
        pending_beat[0] = None
        rate, env_rate = learn_timer.rate(), env_timer.rate()
        if prefetch is not None:
            prefetch.stop()
        if transfer_sched is not None:
            transfer_sched.close()
        if bootstrapped:
            emergency_ckpt = emergency_checkpoint()
        # Shrink-ready (JAX :2536-2556): with a complete, verified slice set
        # on disk the lost peer's replay is recoverable, so the pod may
        # relaunch smaller (exit 78) instead of waiting for it (76).
        pod_shrink_ready = slices_adoptable(config)
        if pod_shrink_ready:
            print(f"[train] complete replay slice set on disk — shrink-ready, exiting "
                  f"{EXIT_POD_SHRINK} (relaunch at any process count adopts it)",
                  file=sys.stderr, flush=True)
    finally:
        _beat()   # each teardown stage gets a fresh allowance
        try:
            # A pod lands its outstanding beat (every rank issued the same
            # beats, so every rank waits here) before the machinery under
            # it goes.
            wait_beat()
        except multihost.PodPeerLost as e:
            # A peer left between the loop's last gate and here: the exit
            # still says 76.
            if pod_lost is None:
                pod_lost = e
                pod_stats.record_abort()
        except Exception:
            pass   # a failing beat must not mask the error in flight
        if prefetch is not None:
            prefetch.stop()
        if pool is not None:
            pool.stop()
        _beat()
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
        _beat()
        if obs_server is not None and not preempt.is_set():
            # A preempted or aborted run keeps answering /healthz
            # (draining, with the abort's reasons) up to its exit; the
            # server's thread is a daemon.
            obs_server.stop()
        if is_multi:
            # Disarmed: a later run in this interpreter on one node keeps
            # the direct path.
            multihost.configure_pod(0.0)
    saver.wait()   # a failed cadence write raises here
    _beat()

    metrics = learner.metrics_to_host(out) if out is not None else {}
    if config.prioritized:   # the run's one read of the max priority
        metrics["max_priority"] = float(replay.max_priority)
    replica = {}
    if (learner.data_size > 1 or learner.model_axis > 1) and pod_lost is None:
        # Every rank's state (and PER's priorities) against rank 0's, bit
        # for bit (a rank's shards against its data group's first rank's):
        # the replicas must not have drifted apart.
        held = state_tensors(learner.state)
        if config.prioritized:
            # A sharded ring's priorities are each rank's own slots: only
            # the max priority is a replica.
            held += ([replay.max_priority] if slice_writer
                     else [replay.priorities, replay.max_priority])
        flags = learner.state_sharded() + [False] * (len(held) - len(learner.state_sharded()))
        replica = dict(replicas_identical=mesh.replicas_equal(held, learner.group, sharded=flags))
        gather_shard_fills()
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
        t_ingest_run_ms=1000.0 * ingest_chunk_s / max(ingest_calls, 1),
        t_ingest_run_max=1000.0 * ingest_max_s,
        n_ingest_run=ingest_calls,
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
        **phases.snapshot(),
        **guardrail_fields(),
        **recovery_fields(),
        **serve_final,
        **pod_fields(),
        **({"pod_shrink_ready": pod_shrink_ready} if pod_lost is not None else {}),
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
        # A pod abort takes the preemption's path but is its own exit (76,
        # not 75): exactly one of the two is reported.
        "preempted": stopping and pod_lost is None,
        "pod_degraded": pod_lost is not None,
        "pod_shrink_ready": pod_shrink_ready,
        **pod_fields(),
        "numeric_failed": numeric_failed,
        **guardrail_fields(),
        **recovery_fields(),
        **serve_final,
        **({"alpha": float(learner.state.log_alpha.exp())} if config.sac else {}),
    }


def start_exporter(config: DDPGConfig, log: MetricsLogger, preempt: threading.Event,
                   group=None):
    """The telemetry ingress of --obs_port (JAX train.py:1221-1252): /metrics
    from the logger's latest record of each kind and the run's counters,
    /healthz from obs/health.py, /trace into trace_dir. None when off. A
    bind failure (the port taken) is said on stderr and leaves the run
    without it: telemetry never kills the run it observes. On a pod each
    node's lead serves one, node k on obs_port + k (the supervisor's
    --probe-port-base convention: slot i at base + i), so nodes that
    share a host do not collide."""
    from distributed_ddpg_tpu_torch.obs import ObsExporter, health

    if config.obs_port <= 0:
        return None
    index = group.process_index if group is not None and group.is_pod else 0
    count = group.process_count if group is not None and group.is_pod else 1
    try:
        server = ObsExporter(
            config.obs_port + index, health=health.get(), latest_fn=log.latest,
            counters_fn=lambda: {"t_unix_base": log.t_unix_base, "process_index": index,
                                 "process_count": count, "preempt": int(preempt.is_set())},
            trace_dir=config.trace_dir or config.checkpoint_dir or ".",
        ).start()
    except OSError as e:
        print(f"[obs] exporter disabled (bind failed: {e})", file=sys.stderr, flush=True)
        return None
    print(f"[obs] telemetry ingress on :{server.port} (/metrics /healthz /trace)",
          file=sys.stderr, flush=True)
    return server


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
    log = MetricsLogger(config.log_path, echo=echo, tb_dir=config.tb_dir)
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
    logs). One rank (ROADMAP.md Queue 1 item 10, its data-plane half). --profile_dir and
    --tb_dir apply as in train()."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.envs.registry import EnvSpec
    from distributed_ddpg_tpu_torch.ondevice import OnDeviceDDPG

    if group is not None and group.world_size > 1:
        raise ValueError(
            f"backend='jax_ondevice' on {group.world_size} ranks is not in this slice of "
            "the PyTorch port: the monolith over a data-parallel group comes with "
            "ROADMAP.md Queue 1 item 10 (its data-plane half); run it on one rank")
    trainer = OnDeviceDDPG(config)
    log = MetricsLogger(config.log_path, echo=echo, tb_dir=config.tb_dir)

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
    # --profile_dir: the loop under torch.profiler (JAX :263-286).
    with _profiled(config, config.device):
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


def pod_degraded_exit(linger_s: float = 10.0, code: int = EXIT_POD_DEGRADED) -> None:
    """Exit `code` the safe way after a pod abort (train() returned
    pod_degraded=True; the emergency checkpoint and the logs have landed),
    as the JAX trainer's pod_degraded_exit does: os._exit, not sys.exit,
    because the abandoned collective's thread is still blocked in the
    transport, and an ordinary interpreter teardown (or
    destroy_process_group) would wait on, or die under, the dead peer.

    Node 0 lingers first (linger_s): it hosts the process group's store,
    and its exit would cut the surviving peers off while they still write
    their own emergency checkpoints. /healthz reads `draining` meanwhile."""
    drain_for_pod_exit(code)
    try:
        from distributed_ddpg_tpu_torch.parallel import multihost

        if multihost.process_count() > 1 and multihost.process_index() == 0:
            time.sleep(linger_s)
    except Exception:
        pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def drain_for_pod_exit(code: int = EXIT_POD_DEGRADED) -> None:
    """Latch /healthz into `draining`, carrying the pod abort's verdict: the
    exporter, left serving through the linger, answers a supervisor's
    scrape with "winding down, and this is why" (the degraded reasons,
    pod_peer_lost among them). drain() is first-wins, so a SIGTERM that
    latched `preempted` first keeps its reason (JAX train.py:2736)."""
    try:
        from distributed_ddpg_tpu_torch.obs import health

        _state, reasons = health.get().state()
        health.get().drain("; ".join(reasons) if reasons else f"pod abort (exit {code})")
    except Exception:
        pass   # diagnostics never block the documented exit


def main(argv=None) -> None:
    config = DDPGConfig.from_flags(argv if argv is not None else sys.argv[1:])
    # Under torchrun (or tools/supervise.py): the process group its
    # environment names, DDPG_DIST_BACKEND's backend (parallel/multihost.py).
    from distributed_ddpg_tpu_torch.parallel import multihost

    group = multihost.initialize(config.device, config.pod_collective_timeout_s,
                                 config.pod_startup_grace_s)
    summary: Dict[str, Any] = {}
    try:
        summary = train(config, group=group)
    finally:
        # Never after a pod abort: the dead peer would hold it.
        if group is not None and not summary.get("pod_degraded"):
            import torch.distributed as dist

            dist.destroy_process_group()
    if group is None or group.lead or (group.is_pod and group.node_lead):
        print({k: round(v, 3) if isinstance(v, float) else v for k, v in summary.items()},
              flush=True)
    if summary.get("pod_degraded"):
        # A peer node was lost: relaunch the whole pod with the same
        # directories; the resume election picks the common step.
        pod_degraded_exit(code=EXIT_POD_SHRINK if summary.get("pod_shrink_ready")
                          else EXIT_POD_DEGRADED)
    if summary.get("numeric_failed"):
        # The guardrails could not repair a sustained divergence: read the
        # guardrail_* counters before spending more on this config.
        sys.exit(EXIT_NUMERIC)
    if summary.get("preempted"):
        # Preempted and resumable: relaunch with the same --checkpoint_dir.
        sys.exit(EXIT_PREEMPTED)


if __name__ == "__main__":
    main()
