"""Chip smoke test of the PyTorch/CUDA port (distributed_ddpg_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises; nothing is caught and passed over):

1. Require CUDA; print the card's name and power limit; turn TF32 off for
   matmul and cuDNN (the kernels and their plain versions are true f32).
2. Build every kernel of the port from csrc/ (one nvcc per source, all
   started together): the learner chunk (fused_chunk.cu) and the fused
   Adam + Polyak update (fused_update.cu); print each one's registers and
   spills.
3. Hold each kernel against its plain PyTorch version on the card, on the
   same inputs. First the fused update (ops/fused_update.py), 3 steps on
   the JAX test's ragged leaves, on leaves of odd lengths (1, 3, 5, 4097),
   on unaligned views, on more leaves than one launch's table holds
   (tools/update_trees.py) and on the Pendulum DDPG critic and actor and the D4PG
   critic of a random state, at tests/test_fused.py's rtol 1e-6, atol
   1e-7, with its largest gap in ULP (0 expected), the inputs left as they
   were and one launch a table; its bias corrections against torch.pow
   for every count to 2^20; one device operation a call on the Pendulum
   critic, counted as the nodes of a CUDA graph that captures the calls;
   then the scan route (parallel/learner.make_scan_chunk_fn, K = 16 on one state
   and draw): with fused_update (DDPG and D4PG) and with critic_l2 on the
   card against the same chunk on the CPU, and with fused_chunk='off'
   against the chunk kernel, under the f32 rule below. Then, from one
   random TrainState carried in with
   train_state_from_numpy: the learner chunk (ops/fused_chunk.py) at
   Pendulum shapes (obs 3, act 1) and at the bench's (obs 17, act 6),
   2x256 nets, batch 64 -- its DDPG branch at K = 16 and K = 800 (the main
   path's chunk), its TD3 branch at K = 16 and 800 with policy_delay=2,
   target_noise=0.2 (one noise stream drawn on the card, given to both)
   and at K = 16 with policy_delay=1, target_noise=0 (no noise input),
   from an odd step so the delay schedule is offset; its D4PG branch
   (51 atoms on [-10, 10], which the random rewards cross and clip at)
   at K = 16 and 800, with 256 atoms (the edge of the envelope) at
   K = 16, one chunk after set_value_bounds moved the support, and at
   K = 16 and 800 on [-1500, 150] with Pendulum's 5-step returns (the
   scale the main path trains at); its SAC branch with the temperature
   learned (K = 16 and 800) and fixed (K = 16), at K = 16 with both
   critic members equal, so every row of the min gate ties, and at K = 16
   with a hot temperature (alpha 4, log_std near the clamp's floor), so
   that alpha * log pi outweighs the critics (two standard-normal streams
   drawn on the card, given to both). Every
   K = 16 batch draws its
   importance weights from [0.5, 1] (WEIGHTED_UP_TO); the K = 800 ones
   carry weights 1. The cases that drift in f32 over K = 800 (TD3 and
   SAC at the bench's shape) may instead be refereed by the chunk in
   float64 (SHARE_RATIO, DRIFT_RATIO; for SAC the f32 spread from the plain
   version on the card and on the CPU). Then every branch again with
   compute_dtype='bfloat16' (bf16 product operands, f32 sums): at K = 16
   at both shapes and at K = 800 at Pendulum shapes, TD3 with delay 2 and
   noise, D4PG at 51 atoms, SAC with the temperature learned; the K = 800
   cases refereed like SAC's above; and one small chunk a family (nets
   32x32, batch 8, K = 4) from a fresh state (FRESH_FRAC). Then
   prioritized replay (replay/device.py, parallel/learner.py
   run_sample_chunk_per): the PER draw on the card against the CPU with
   the same uniforms, on dyadic priorities at the main path's capacity
   (1M; every running sum exact, so the same indices, weights within
   1e-6), and on random ones (the share of indices that differ and the
   card's prefix sum's decreasing neighbours printed); the card's prefix
   sum (replay/device.fixed_order_cumsum) and the draw bit-identical over
   PER_REPEATS runs (torch's 1-D cumsum's repeat printed as context); one PER chunk at
   K = 16 on the chunk kernel's route against the scan route, DDPG and
   D4PG (51 atoms), on the same idx and weights (the state under the f32
   rule, td, the priority vector and max_priority within OUT_TOL); the
   duplicate rule of the priority write (the last draw of a slot wins)
   the same on the card as on the CPU and bit-identical over two runs;
   and no synchronizing call added by the PER chunk over a uniform one,
   or by the priority stamp over a uniform insert (torch.cuda sync
   debug mode). Then the ingest pipeline (replay/device.py, transfer/):
   the main path's (the scheduler's ships, the adaptive cap, the pinned
   pool) against the serial block-at-a-time inserts on a ragged inflow
   that wraps a 16-block ring, uniform and PER, bit for bit
   (check_ingest_parity); 8 blocks staged while a K = 800 K1 (a) chunk
   runs, on the main path's pipeline (uniform, PER), inline from the
   pinned pool with the PER stamp, and on the old pipeline: no
   synchronizing call and the chunk still running for all but the old,
   the driver's time in add_packed of each printed beside the chunk's ms
   (ingest_during_chunk); a chunk queued behind a running one gathers the
   rows as they were before a wrapping insert issued after it
   (check_ingest_wrap); a pinned buffer filled with NaN as it is acquired
   leaves the ring as shipped: the pool waited for the copy's fence
   (check_ingest_fence). Then K1 (a) at MountainCarContinuous-v0's shapes
   (obs 2, act 1, action scale 1) on rows 15% of which are terminal
   (discount 0, reward 100) at K = 16 and 800, under PR 1's f32 rule; and
   the guarded scan chunk (check_guarded_chunk: K = 16, K2 on, Pendulum
   shapes): on healthy rows bit for bit the unguarded chunk, with
   numeric:grad:nan@3 and numeric:loss:spike@9 (warmup 4) exactly those
   steps skipped and bit for bit the chunk with them left out, and a
   screen of more than 32 non-finite rows the same on the card as on the
   CPU.
3b. The mesh phase (mesh_phase): two processes of this script, each one
   rank of a gloo group on the one card (NCCL refuses two ranks on one
   device), MESH_TIMEOUT_S for both, a failing rank failing the phase.
   The ranks' PER draws from the same generator and priorities
   bit-identical; the mesh launch (parallel/learner.py, K-step local
   SGD) against its plain version for DDPG, TD3, D4PG and SAC in f32 and
   DDPG in bf16, at the bench's shape, K = 16, 64 rows a rank: each
   rank's chunk kernel on its own draws plus the state average, against
   the same rank's plain chunk on the CPU from the same draws averaged
   over the group, under the K = 16 f32 rule; after every check both
   ranks' states bit-identical (rank 0 broadcasts, each rank compares);
   device times of K1 a rank (both ranks' kernels on the card, and rank
   0's alone) and of the state average a chunk, labelled as gloo, two
   ranks on one card; one forced expansion of the auto C51 support
   through the trainer's own check (train.expand_support) from a support
   too narrow for Pendulum's returns, the same wider bounds on both
   ranks and the next chunk on them; then two main paths through train()
   at D = 2 (Pendulum, 2x256, 64 rows a rank): DDPG on the mesh launch
   for 5000 env steps (every chunk one DDPG kernel launch a rank) and
   README's whole D4PG command with --prioritized=true, which takes the
   scan route on a mesh, for MESH_PER_ENV_STEPS; each prints its route,
   global_batch, chunks, learner and env steps a second, and both end
   with bit-identical replicas. Then the sharded replay on the same two
   ranks (mesh_sharded): a sharded PER ring of SHARD_RING_ROWS and a
   replicated one fed the same rows through a wrap, the sharded one's
   slots gathered in logical order: both rings' and both priority
   vectors' sha256 equal; each ring's bytes on the card measured with
   torch.cuda.memory_allocated against capacity x width x 4 / D (plus
   the priorities); a sharded uniform chunk on the scan route with K2
   (K = SHARD_K, 2x256, 64 rows a rank) bit for bit the replicated one
   (every state tensor and td); a sharded PER chunk with K2 on one given
   draw, its priorities (gathered) and max priority bit for bit the
   replicated chunk's; then a short sharded main path through train() at
   D = 2 with --fused_update=true (SHARD_K learner steps a chunk, paced by
   --max_ingest_ratio=SHARD_INGEST_RATIO): K2's
   launches = 2 x learner steps and no chunk-kernel launch, the replicas
   bit-identical, the replay_* fields, learner and env steps/s.
3c. Tensor parallelism (tp_phase, on the mesh phase's two ranks as a
   (data, model) grid of D = 1 x M = 2: parallel/mesh.make_grid,
   parallel/partition.py): (a) one chunk of TP_K steps on the scan route
   with K2 at model_axis = 2 against the port's M = 1 chunk on the card
   from one random state on the same rows and draws, DDPG and D4PG with
   PER (each its own copy of the priorities), at the bench's shape (obs
   17, act 6: the critic's action-insert layer row-parallel, cut off
   layer 0's boundaries) and Pendulum's (obs 3, act 1: that layer
   replicated): the logical end state, td, metrics (and priorities and
   max priority) within TP_TOL (tests/test_torch_mesh.py's rtol 2e-5,
   atol 1e-6, D4PG 2e-4, 1e-5), an output outside refereed by the M = 1
   chunk in float64 under SHARE_RATIO and DRIFT_RATIO; K2 twice a step
   and no chunk kernel; the replicated leaves bit-identical across the
   model group; (b) K2 on each rank's critic and actor shards at the
   bench's shape, 3 steps, one launch a call, against the plain version
   (the largest gap in ULP printed) and bit for bit the logical update's
   slice; (d) a checkpoint saved at M = 1, restored at M = 2, gathered,
   saved and restored at M = 1, the logical state's sha256 the same at
   each stage; a rank's learner's bytes on the card
   (torch.cuda.memory_allocated across its construction, tp_memory) at
   M = 2 below M = 1's; then the TP main path through train() at D = 1 x M = 2
   (--model_axis=2 --fused_update=true, TP_K steps a chunk, paced by
   --max_ingest_ratio=TP_INGEST_RATIO): K2 launches = 2 x learner steps,
   no chunk-kernel launch, the replicas bit-identical, the mesh_* fields.
   Beside them, started by rank 0 (TPLaunches): (c) D = 2 x M = 2 through
   the CLI (torchrun --nproc_per_node=4 of this script's --tp-child under
   DDPG_DIST_BACKEND=gloo, --replay_sharding=sharded --fused_update=true):
   exit 0, every rank's K2 launches = 2 x learner steps, the final
   record's mesh_* fields (a rank's bytes below the logical), bit-identical
   replicas; (e) `--model_axis=2 --fused_chunk=on` exits with the
   config's message. Learner steps/s a rank and the phase's seconds are
   printed beside the card's line: gloo ranks time-slicing one card.
4. Drive the main paths, `distributed_ddpg_tpu_torch.train` (Pendulum-v1,
   2x256, batch 64, f32, one actor process, K = 800): DDPG with the
   default flags for 20,000 env steps and TD3 with --twin_critic=true
   --policy_delay=2 --target_noise=0.2 for 5000, then D4PG with
   --distributional=true --n_step=5 --v_min=auto --v_max=auto for 5000
   (51 atoms; the support resolved from the warmup rewards is
   printed) and README's whole D4PG command, the same with
   --prioritized=true, for 20,000 (its final beta and max_priority
   printed), then SAC with --sac=true --actor_lr=3e-4 --critic_lr=3e-4
   --tau=0.005 for 20,000 (its final alpha is printed); then with
   --compute_dtype=bfloat16 DDPG for 20,000 env steps and TD3, D4PG and
   SAC (their flags as above) for 5000 each; then the scan route:
   --fused_update=true for 10,000 env steps, README's D4PG command (with
   --prioritized=true) with --fused_update=true and --critic_l2=0.01 for
   5000 each. DDPG and README's D4PG command also run once with the old
   pipeline's flags (OLD_ENV_STEPS), --transport=queue
   --ingest_async=false --transfer_scheduler=false, and the scan route
   with K2 once with them (OLD_SCAN_ENV_STEPS), each printed beside its
   default-pipeline run with its wall time a chunk (before_after). For
   each, the
   launch counts are zeroed just before and read just after: on the
   kernel route every chunk must have been one launch of that branch's
   kernel and nothing else; on the scan route (fused_chunk_active false)
   no chunk kernel, and the fused update twice a learner step when
   fused_update is on, else never; learner_steps = chunks x K, metrics
   finite; the transport shm and the shipper on (the queue and no
   shipper under the old flags); the driver's ingest time a chunk, the
   longest call, ingest_coalesce_mean, ingest_stall_ms and
   transfer_pool_fence_waits printed beside the rates. The mesh phase's
   paths run rank 0's actors on shm, every rank without a shipper. Then
   MountainCarContinuous-v0 with 4 actors on K1 (a) for MC_ENV_STEPS env
   steps (mountain_car_path: the env's source, rows from every actor, the
   terminal rows ingested and the coalesced ships printed), and the
   guarded scan route, `--guardrails=true --fused_update=true`, for
   10,000 env steps, and with PER for 5000 (guarded_main_paths: the health
   word read once a chunk, no non-finite step, its counters printed).
4b. Checkpoint and resume (checkpoint.py): README's whole D4PG command
   (PER, the auto support) at Pendulum shapes with the 1M-row replay
   full, on the kernel route at K = 800 and on the scan route with
   fused_update at K = RESUME_SCAN_K (check_resume_chunk): two chunks, a
   save through the trainer's AsyncSaver, a third chunk on draws fixed
   here; a fresh learner and replay restored; the restored state,
   priorities, max_priority, rows and bounds equal to the saved ones bit
   for bit, and the resumed third chunk the uninterrupted one's bits, on
   one K1 launch (kernel) or two K2 launches a step (scan); the snapshot,
   write and restore times and the checkpoint's bytes printed with the
   card. Then the CLI drill (resume_drill), each run a child process of
   this script (`--resume-drill`): the DDPG defaults with a save every
   chunk, SIGTERM after the first `train` record and two checkpoints
   (exit 75, "emergency checkpoint", a checkpoint that verifies,
   emergency_ckpt 1), then the same command with more env steps (it
   resumes at that learner step and every chunk is one K1 launch). Then
   the DDPG main path again with a save every chunk (CADENCE_ENV_STEPS),
   its learner steps/s beside the same path's without.
4c. The guardrail drills (guardrail_drills), each `python -m
   distributed_ddpg_tpu_torch.train` as a child at 2x256, K = 100: a
   rollback that restores a step below the first injected NaN step,
   renames the newer checkpoints diverged_step_N and finishes (exit 0,
   the restore's ms printed); an abort (exit 77, no checkpoint from the
   injected step's chunk on); a poisoned row's actor quarantined.
4d. The host replay, lockstep mode and the agent (host_replay_phase):
   the native sum tree (native/replay_core.cpp) must build; PREFETCH_CHUNKS
   chunks of K1 (a) and of K1 (c) at K = 800 through the ChunkPrefetcher
   (depth 1 and 2, the transfer scheduler's prefetch class), put_chunk
   and run_chunk_async, dispatched without waiting, bit for bit what
   run_chunk gives on the same draws from an identical PER replay
   (check_prefetched_chunk); then the main paths with --host_replay=true
   for HOST_ENV_STEPS each: DDPG on K1 (a), README's whole D4PG command
   (PER on the host sum tree, which must be the native one) on K1 (c), and
   --fused_update=true on the scan route (K2), each checked as every main
   path is and printed with the driver's wait for a prefetched chunk;
   then two --strict_sync=true runs (inline actors, both ratios 1) on K1
   (a) and two on the scan route with K2, each pair's records
   bit-identical once the wall-clock fields are stripped (strict_pair);
   then DDPGAgent with fused_update=True for AGENT_ENV_STEPS env steps (K2
   twice a learner step, agent_path).
4e. Device actors, the fused beat, the superstep and the on-device
   monolith (device_actor_phase, Pendulum-v1, 2x256, batch 64, the 1M
   ring, 1024 device envs x 64 steps a rollout): the device actors on K1
   (a) with num_actors=0 through train() (DEVACTOR_ROLLOUTS rollouts, 4
   chunks; transfer_ingest_items 0; the rollout between chunks); the
   rollout timed (device and host ms a dispatch, device busy time,
   launches a rollout step); a rollout on the card against the CPU from
   the same draws, step by step, the rows and the carry (rtol 1e-5, atol
   1e-5; the free-running gap within FREE_RUNNING_BOUND); a rollout after a K1 chunk bit for bit one from a copy of
   the new actor params; 3 fused beats bit-identical to the separate
   sequence at K = BEAT_PARITY_K, uniform and PER; the fused beat's main
   path (--fused_chunk=off --fused_update=true, 3 beats at K = 800, K2
   twice a learner step); one superstep of 4 beats bit-identical to 4
   beats and its host syncs counted (1); the superstep's main path (one
   superstep); --backend=jax_ondevice --fused_update=true for
   ONDEVICE_ENV_STEPS env steps, MountainCar's terminal rows on the
   monolith stored at discount 0, and MountainCar on it for
   ONDEVICE_MC_ENV_STEPS; the device actors resumed from a checkpoint
   continuing their episodes. K2's launches in the kernels' record are
   the fused beat's.
4f. Batched policy serving (serving_phase, SERVE_LIMIT_S of its own, an
   alarm): the device apply (serve/server.py, backend 'jax') on the card
   with TF32 off at Pendulum 2x256 (obs 3, act 1) and at the bench's
   shape (obs 17, act 6), DDPG and SAC's head rows, max_batch 32, n in
   (1, 7, 32), within SERVE_ATOL of the numpy oracle, of the same apply on
   the CPU and of a full batch's rows, with stale values in the pad rows'
   buffer; a seqlock refresh served from the next batch on; no
   synchronizing call; the apply's launches, device time and round trip a
   batch (the checks are tools/serve_checks.py's, shared with the on-card
   tests). Then `--serve_actors=true --serve_backend=jax` through the
   CLI's parser and train() on K1 (a) with 4 actors, twice: for
   SERVE_ENV_STEPS env steps with the learner gated 1:1, and free running
   (README's command) for SERVE_FREE_ENV_STEPS, its served steps behind
   back-to-back chunks; each with JAX's healthy-run checks
   (serve_requests > 0, serve_errors 0, serve_overloads 0,
   transfer_serve_items > 0, serve_client_fallbacks <= 8) and its serve
   tails, env rate and ingest stalls printed. Then FrontServer with
   device engines on ephemeral localhost ports: 50 TCP and 10 HTTP
   requests against the device apply, a candidate canaried and promoted,
   the routing following. Then tools/serve_bench.py's numpy and device
   backends at 1 and 8 clients (SERVE_BENCH_S each), and the device
   backend while K1 (a) chunks run back to back. The kernels' record
   lists each kernel's launches on every path (launches_on_paths).
4g. The operations layer (operations_phase, OPS_LIMIT_S of its own, an
   alarm): the DDPG main path on K1 (a) for OPS_ENV_STEPS env steps
   without, then with --trace_dir --watchdog_s=20 --obs_port --tb_dir
   --log_path, a thread scraping /healthz (200, healthy), /metrics (the
   train record's learner rate) and /trace during the second and sending
   SIGUSR2 once (its export must appear); trace.json with the learner's,
   the ship's and the scheduler's spans, each actor's own file, the train
   records' t_dispatch_*, t_sync_*, t_ingest_* and staleness_* fields,
   and both runs' learner steps/s printed. A short run with --profile_dir
   in a child process: K1's kernel a CUDA kernel event once a chunk in its
   Chrome trace. Three
   CLI fault drills together (fault_drills): OPS_FAULTS on K1 (a) with two
   actors (two respawns, dead and no_rows, a shipper restart, a scheduler
   restart, a checkpoint write retry), the host replay on the scan route
   with K2 and a slow prefetch sample, the device actors with a rollout
   crash (one restart), each exit 0. The stall drill: a child trainer with
   --watchdog_s=5 whose harness enqueues torch.cuda._sleep on the
   learner's stream after the first chunk exits 70 with stall_report.json
   (the main thread in its device read) and stall_trace.json; the seconds
   from the stall to the report and to the process's end printed. The
   kernels' record counts K1 (a)'s launches on the traced main path and
   K2's on the prefetch drill.
4h. The pod layer (pod_phase, POD_LIMIT_S of its own, an alarm), in child
   processes of tools/supervise.py, (a) and (b) side by side, each trainer this script's
   `--pod-child` (train.main with a harness that reads back every beat's
   rows from the ring at the JAX package's offsets and prints the ring's
   sha256 and the launches): (a) one process on K1 (a) under the
   supervisor, SIGTERMed (the child, not the supervisor) once its first
   cadence checkpoint has landed: exit 75, relaunched in place, resumed
   from --checkpoint_dir, exit 0, the supervisor exit 0 with spawn, exit,
   relaunch, spawn and the final 0 in its event log; (b) two nodes of one
   rank each over gloo on the one card (DDPG_DIST_BACKEND=gloo), 1 actor
   each, Pendulum 2x256, batch 64, K = 800, a 1000-row warmup:
   generation 1 with --pod_collective_timeout_s=POD_DEADLINE_S and
   pod:1:hang@POD_HANG_BEAT (--env-first) exits 76 on node 0 within the
   deadline plus POD_SLACK_S of the hang; generation 2 elects the same
   resume step on both, every chunk one K1 launch a process, exit 0, the
   replicas bit-identical, both rings the same bytes and every beat's rows
   where the JAX layout puts them. Printed: the detection latency, the
   elected step, the generations, K1's launches a process, generation 2's
   learner and env steps/s a process (gloo time-slicing one card) and
   node 0's final pod_* fields.
4i. The sharded pod's shrink (ShardedShrink, SHRINK_LIMIT_S of its own, a
   deadline on its supervisor), started before 4h (a) and (b) and
   finished after them: two nodes over gloo on the one card under
   tools.supervise, --replay_sharding=sharded --fused_update=true at
   SHARD_K steps a chunk, a slice set every chunk, paced by
   --max_ingest_ratio=SHRINK_INGEST_RATIO; generation 1's node 1
   SIGKILLs itself at its SHRINK_KILL_BEAT-th beat (pod:1:kill, --env-first),
   node 0 exits 78 with a complete slice set on disk; generation 2 runs
   one node, adopts the two-writer set (pod_shrinks 1,
   pod_state_degraded 1), K2 on every step, and finishes (exit 0).
   Printed: the detection latency, each generation's seconds, the
   adopted step and generation 2's launches and rates.
5. Time each branch of the kernel at the main path's shapes (CUDA events,
   warmed up) beside its plain version (one run, timed where the parity
   phase ran it at these shapes: PLAIN_MS) and its bound; the eager autograd
   step x K is printed as context only. Then break each f32 branch's time,
   and bf16 DDPG's, down into its barriers, its optimizer pass and each
   stage's tiles. The bf16 branches' bound counts their rounded products
   at the bf16 tensor-core peak and the rest at the f32 peak. Then the
   fused update per call at the Pendulum critic's and actor's sizes (its
   wrapper, the kernel alone, an empty kernel with the same table and
   grid, the plain version and the library pair torch._fused_adam_ +
   torch._foreach_lerp_, each as device time in a CUDA graph and as host
   time launched eagerly, beside its bound), and the scan route's chunk
   at K = 800 with fused_update on and off. Then PER's own work a chunk
   at K = 800, B = 64, capacity 1M (the draw, the gather, the weight
   column, the priority write and max), as device time (torch.profiler)
   and as time a chunk with its host enqueue (CUDA events), beside D4PG's
   kernel time a chunk and PER's byte bound; then the draw's prefix sum
   alone at rows of SCAN_BLOCK and of 4x it, and torch's 1-D cumsum, as
   device time in a CUDA graph. Then the guarded scan step's device
   operations and device time against the unguarded one's
   (guard_ops_per_step).

It imports nothing of JAX or of the JAX package. The second-to-last line
is the kernels' JSON record (each kernel's launches on this slice's paths
where it runs on one, else on its main path); the last line is the
device record.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

# An actor process that the pool spawns re-runs this file as __mp_main__
# and needs nothing of torch: its import is ~2-3 s of each main path's
# start-up, on the path the learner waits on.
if __name__ != "__mp_main__":
    import torch

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at the full 700 W
# power limit): f32 on the CUDA cores, bf16 on the tensor cores (dense,
# without sparsity) and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel-vs-plain tolerances. Both are f32 with different summation orders
# (16x16 tiles vs cuBLAS) and FMA contraction, so one step's gradients agree
# to ~1e-7 relative. Adam divides by sqrt(v): where a gradient is itself at
# the rounding level of its sum, the two can take different Adam steps, each
# at most ~lr (1e-3 for the critic). So the end state must agree within
# STATE_TOL everywhere, and within TIGHT_TOL on all but a TIGHT_FRAC share
# of its elements (a wrong kernel misses on most of them, not a few); td
# and the metrics, computed from the drifting params, within OUT_TOL.
STATE_TOL = dict(rtol=1e-4, atol=1e-3)
TIGHT_TOL = dict(rtol=1e-4, atol=1e-5)
TIGHT_FRAC = 1e-3
OUT_TOL = dict(rtol=1e-3, atol=1e-4)
# C51's td is a difference of two expectations over the support, each a
# sum of 51 terms up to the support's scale S: two f32 sums in different
# orders differ by a few rounding units of S (eps * S). On [-1500, 150] an
# H100 (700 W) measured 3.05e-4 = 1.7 eps * S over K = 800 while the state
# agreed to 1.0e-6. TD_ULPS is the allowance in those units.
F32_EPS = float(np.finfo(np.float32).eps)
TD_ULPS = 16
# These hold every check but one. TD3 at the bench's shape (obs 17, act 6)
# over K = 800 steps from step 1001 amplifies rounding: a ReLU mask that
# flips on a rounding difference changes a gradient by a whole upstream
# term, Adam turns that into a step of ~lr, and the gap then grows step
# by step. On an H100 (700 W) the f32 plain version itself ended 6.7e-3 from
# the same chunk in float64 in the critic and 4.0e-3 in td, the kernel
# 1.3e-2 and 2.8e-3, and the two f32 runs differed beyond TIGHT_TOL in
# 11.8% of the state's elements. Whether a run meets such a flip depends on
# the data and the rounding, not on the code being right: on the CPU with
# 64-wide nets the plain DDPG chunk drifts so from its float64 twin and
# TD3 does not. In that one case an output that fails the tolerances above
# is refereed by the exact chunk (the plain version in float64), per state
# group, td and each metric: the share of elements where the kernel misses
# it by more than TIGHT_TOL may be at most SHARE_RATIO times the f32 plain
# version's own share plus TIGHT_FRAC, and no element may miss it by more
# than DRIFT_RATIO times the plain version's largest miss plus TIGHT_TOL.
# Measured there: the kernel's share was at most 0.91x the plain version's
# (critic_mu), its largest miss at most 1.87x (critic). With a critic bias
# correction one step late, target_critic's share rose to 2.8x.
SHARE_RATIO = 1.5
DRIFT_RATIO = 3.0
# SAC at the bench's shape over K = 800 drifts more: two f32 versions part
# from step 0 and their gap doubles every ~100 steps (8.5e-6 at K = 50,
# 5.1e-4 at 400, 4.7e-3 at 800), while the kernel gives the same bits run
# after run. Against the float64 chunk the kernel and the plain version on
# the CPU missed by nearly the same amounts (actor 1.3e-3 and 1.2e-3), the
# plain version on the card by other ones (actor 3.8e-4, critic 4.7e-3
# against 1.9e-3); on two other draws all three agreed (H100, 700 W). One
# f32 version is one sample of where rounding takes the chunk, so in that
# case (`spread_on_cpu`) the f32 spread is the larger miss of the two plain
# versions, on the card and on the CPU; the ratios stay as they are.
# Chunks of up to this many steps draw importance weights from [0.5, 1]:
# they check one step's math exactly, so a kernel that drops or misplaces
# a weight fails there, in every branch. Longer chunks check what
# accumulates over a chunk (counts, bias corrections, Polyak, the delay)
# with weights 1. With weights (or on other draws of the rows) the DDPG
# chunk at Pendulum shapes over K = 800 drifts in f32 as TD3 does at the
# bench's shape. On an H100 (700 W), on two weighted draws, both f32
# versions ended far from the float64 chunk (in the critic, the plain
# version 9.8e-3 and 7.0e-3 with 37.8% and 21.5% of its elements beyond
# TIGHT_TOL, the kernel 5.9e-3 and 6.2e-3 with 39.1% and 23.6%), and the
# float64 referee passed the kernel on one draw and failed it on the other
# (actor_mu): whether such a check passes is down to the draw.
WEIGHTED_UP_TO = 16
# bf16 (compute_dtype='bfloat16'). The kernel and the plain version round
# the same operands to bf16, so they differ by the f32 sums' order, and by
# more only where that order flips one operand's rounding: on an H100
# (700 W) the K = 16 chunks agreed within 6.5e-6 (state) and 1.9e-5 (td),
# inside the f32 rule above, which they keep; the K = 800 ones drift as
# TD3's and SAC's do in f32, so they take the referee with the spread of
# the plain version on the card and on the CPU. Those checks do not see a
# bias gradient whose cotangent is rounded (~2e-4 relative at B = 64,
# hidden by Adam's moments): planted in the kernel, it passed all twelve;
# an unrounded B operand passed D4PG's two at K = 16, whose cotangents
# are small. So each family also runs one small chunk (nets 32x32, batch
# 8, K = 4, as tests/test_torch_on_card.py) from a fresh state (zero Adam
# moments, counts 0), whose first moments then hold the chunk's own
# gradients (mu = 0.1 g after one step) over short sums, where a rounding
# in the wrong place moves a gradient by ~1e-3 relative. Beside the rules
# above, each first moment must be within FRESH_MU_RTOL of itself plus
# FRESH_MU_SCALE of its group's largest: an absolute atol does not fit
# gradients whose scale differs by family. On an H100 (700 W) the kernel
# reached 0.23 of this tolerance (D4PG's critic), the kernel with a
# rounded bias cotangent 10-126x it (its worst group: SAC 10.3, D4PG 17.9,
# TD3 101, DDPG 126). At full width a fresh state does not work: sign-like
# first Adam steps turn near-zero gradients' rounding differences into
# steps of ~lr (1681 elements of the correct D4PG kernel past TIGHT_TOL
# at K = 16).
FRESH_MU_RTOL, FRESH_MU_SCALE = 1e-4, 1e-5
# Operations per element of the fused Adam + Polyak update (csrc/
# fused_update.cu): the first moment 3, the second 4, the param 7 (three
# divides, a multiply, a square root, an add, a subtract), the target 3.
FUSED_UPDATE_OPS = 17
# The scan route's profile (time_scan_chunk): steps profiled, and the
# runtime calls that launch a kernel.
PROFILE_STEPS = 32
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def random_state_np(cfg, obs: int, act: int, seed: int, step: int = 1000,
                    tied: bool = False, hot: bool = False, fresh: bool = False):
    """A TrainState with numpy leaves: random params near the init
    scale, targets near the params, nonzero Adam moments, every count
    1000 and the given step — a state in mid-training rather than at
    init; with `fresh`, zero Adam moments and every count 0, as at init. A TD3 or SAC config gets two independent critics on a [2, ...]
    axis (with `tied`, two equal ones); SAC a temperature near 0.2 (and its
    Adam moments when autotuned), or with `hot` a temperature of 4 over a
    policy whose log_std sits near the clamp's floor, so that alpha * log pi
    (~3.4 a dim) outweighs the critics in the target, the actor's loss and
    its cotangent."""
    from distributed_ddpg_tpu_torch.ops.fused_chunk import _net_dims
    from distributed_ddpg_tpu_torch.types import OptState, TrainState

    rng = np.random.default_rng(seed)
    adims, cdims = _net_dims(cfg, obs, act)

    def net(dims, fn):
        return tuple(
            {"w": fn((i, o), i, j == len(dims) - 1), "b": fn((o,), i, j == len(dims) - 1)}
            for j, (i, o) in enumerate(dims)
        )

    def param(shape, fan_in, final):
        bound = 3e-3 if final else 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def near(tree):
        return tuple({k: (v + 1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
                      for k, v in layer.items()} for layer in tree)

    count = np.int32(0 if fresh else 1000)

    def opt(tree):
        """Adam moments for a tree made by tree(leaf_fn)."""
        if fresh:
            zero = tree(lambda s, i, f: np.zeros(s, np.float32))
            return OptState(mu=zero, nu=zero, count=count)
        return OptState(
            mu=tree(lambda s, i, f: (1e-3 * rng.standard_normal(s)).astype(np.float32)),
            nu=tree(lambda s, i, f: rng.uniform(1e-6, 1e-4, s).astype(np.float32)),
            count=count,
        )

    def critic_net(fn):
        if not (cfg.twin_critic or cfg.sac):
            return net(cdims, fn)
        a = net(cdims, fn)
        b = a if tied else net(cdims, fn)
        return tuple({k: np.stack([la[k], lb[k]]) for k in la} for la, lb in zip(a, b))

    def near_critic(tree):
        if not tied:
            return near(tree)
        one = near(tuple({k: v[0] for k, v in layer.items()} for layer in tree))
        return tuple({k: np.stack([v, v]) for k, v in layer.items()} for layer in one)

    actor, critic = net(adims, param), critic_net(param)
    state = TrainState(actor, critic, near(actor), near_critic(critic),
                       opt(lambda fn: net(adims, fn)), opt(critic_net), np.int32(step))
    if cfg.sac:
        state = state._replace(log_alpha=np.float32(
            math.log(4.0) if hot else math.log(0.2) + 0.1 * rng.standard_normal()))
        if hot:   # log_std_raw ~ -3: log_std ~ min + 0.02
            actor[-1]["b"][act:] = -3.0
        if cfg.sac_autotune and fresh:
            state = state._replace(alpha_opt=OptState(
                mu=np.float32(0.0), nu=np.float32(0.0), count=count))
        elif cfg.sac_autotune:
            state = state._replace(alpha_opt=OptState(
                mu=np.float32(1e-2 * rng.standard_normal()),
                nu=np.float32(rng.uniform(1e-4, 1e-3)), count=count))
    return state


def random_batches(seed: int, k: int, b: int, obs: int, act: int,
                   rewards=None, weighted: bool = True, terminal: float = 0.0) -> torch.Tensor:
    """Random packed rows. Rewards are N(0, 1) with discount 0.99, or with
    `rewards` = (low, high, discount) uniform in [low, high) at that
    discount. Importance weights are drawn from [0.5, 1], so a kernel that
    drops them fails, or are 1 unless `weighted`. The columns are drawn
    in the order obs, action, reward, next_obs, weight, so the default
    rows do not depend on `weighted`. With `terminal` that share of the
    rows (drawn last) are terminal: discount 0, reward 100 (MountainCar's
    goal)."""
    from distributed_ddpg_tpu_torch.types import pack_batch_np

    rng = np.random.default_rng(seed)
    o = rng.standard_normal((k, b, obs))
    a = rng.uniform(-2, 2, (k, b, act))
    if rewards is None:
        reward, disc = rng.standard_normal((k, b)), 0.99
    else:
        reward, disc = rng.uniform(rewards[0], rewards[1], (k, b)), rewards[2]
    fields = {
        "obs": o.astype(np.float32),
        "action": a.astype(np.float32),
        "reward": reward.astype(np.float32),
        "discount": np.full((k, b), disc, np.float32),
        "next_obs": rng.standard_normal((k, b, obs)).astype(np.float32),
        "weight": (rng.uniform(0.5, 1.0, (k, b)) if weighted else np.ones((k, b))
                   ).astype(np.float32),
    }
    if terminal:
        done = rng.random((k, b)) < terminal
        fields["discount"][done] = 0.0
        fields["reward"][done] = 100.0
    return torch.from_numpy(pack_batch_np(fields)).cuda()


def time_ms(fn, reps: int, warmup: bool = True) -> float:
    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def noise_for(cfg, k: int, b: int, act: int, step: int):
    """TD3's smoothing noise or SAC's normals (eps_next, eps_cur) for a
    chunk, drawn on the card, or None."""
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    if cfg.sac:
        return fc.sac_noise_eps(cfg, torch.Generator(device="cuda"), step, k, b, act)
    if not cfg.takes_noise:
        return None
    return fc.td3_noise_eps(cfg, torch.Generator(device="cuda"), step, k, b, act)


def numel(eps) -> int:
    """Elements of a noise input: None, a tensor or SAC's pair."""
    if eps is None:
        return 0
    return sum(e.numel() for e in eps) if isinstance(eps, tuple) else eps.numel()


def tree_map_tensors(fn, tree):
    """fn over the tensors of a TrainState (or any tuple/dict tree)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map_tensors(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def to_double(tree):
    """A TrainState (or any tuple/dict tree of tensors) in float64."""
    return tree_map_tensors(lambda t: t.double() if t.is_floating_point() else t, tree)


STATE_GROUPS = ("actor", "critic", "target_actor", "target_critic",
                "actor_mu", "actor_nu", "critic_mu", "critic_nu", "alpha")


def chunk_outputs(state, td, metrics) -> dict:
    """A chunk's outputs as three flat tensors: the state, td, the metrics."""
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    return {"state": fc.flatten_state(state), "td": td,
            "metrics": torch.stack([metrics[n] for n in METRIC_KEYS])}


def state_cuts(cfg, obs: int, act: int):
    """Offsets of the state groups in fused_chunk.flatten_state's layout."""
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    actor, critic = fc._net_dims(cfg, obs, act)
    n_a = sum(i * o + o for i, o in actor)
    n_c = sum(i * o + o for i, o in critic) * (2 if cfg.twin_critic or cfg.sac else 1)
    return np.cumsum([0] + [n_a, n_c] * 4 + [fc._alpha_slots(cfg)]), STATE_GROUPS


def compare_outputs(label: str, cfg, obs: int, act: int, got_all: dict, want_all: dict,
                    fresh: bool = False):
    """One chunk's outputs against another's under the f32 rule (STATE_TOL,
    TIGHT_TOL within TIGHT_FRAC, OUT_TOL; C51's td also TD_ULPS of the
    support's scale; from a `fresh` state the first moments FRESH_MU_*).
    Logs each output's error; returns (largest error, names that fail)."""
    cuts, groups = state_cuts(cfg, obs, act)
    worst, failed = 0.0, []
    for name in got_all:
        got = got_all[name].double().cpu().numpy()
        want = want_all[name].double().cpu().numpy()
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{label}: non-finite {name}")
        err = np.abs(got - want)
        worst = max(worst, float(err.max()))
        tol = STATE_TOL if name == "state" else OUT_TOL
        if name == "td" and cfg.distributional:
            # td = E_proj[z] - E_p[z] cancels two sums over the support, so
            # its rounding floor is that of the support's scale S, not of
            # td: OUT_TOL's atol, or TD_ULPS rounding units of S if larger
            # (only at scales past ~52, such as the main path's).
            scale = max(abs(cfg.v_min), abs(cfg.v_max))
            tol = dict(OUT_TOL, atol=max(OUT_TOL["atol"], TD_ULPS * F32_EPS * scale))
        ok = bool(np.all(err <= tol["atol"] + tol["rtol"] * np.abs(want)))
        line = f"  {label} {name}: max_abs_err={err.max():.3e}"
        if name == "state":
            loose = err > TIGHT_TOL["atol"] + TIGHT_TOL["rtol"] * np.abs(want)
            frac = float(loose.mean())
            where = {g: int(loose[cuts[i]:cuts[i + 1]].sum()) for i, g in enumerate(groups)
                     if loose[cuts[i]:cuts[i + 1]].any()}
            line += f", outside {TIGHT_TOL}: {frac:.2e} of elements {where}"
            ok = ok and frac <= TIGHT_FRAC
            if fresh:
                mu_ratio = {}
                for i, g in enumerate(groups):
                    m = want[cuts[i]:cuts[i + 1]]
                    if g.endswith("_mu") and m.size:
                        tol_mu = FRESH_MU_RTOL * np.abs(m) + FRESH_MU_SCALE * np.abs(m).max()
                        mu_ratio[g] = float(np.max(err[cuts[i]:cuts[i + 1]]
                                                   / np.maximum(tol_mu, 1e-30)))
                line += ", first moments' error / their tolerance: " + ", ".join(
                    f"{g} {r:.2e}" for g, r in mu_ratio.items())
                ok = ok and max(mu_ratio.values()) <= 1.0
        if not ok:
            failed.append(name)
        log(line + ("" if ok else f" -- outside {tol} or TIGHT_FRAC"))
    return worst, failed


# The plain version's time in each check_fused_chunk run (CUDA events, one
# run), by (cfg, obs, act, K, step, scale): time_branch takes the main
# path's shapes' from here instead of running the K eager steps again.
PLAIN_MS = {}


def check_fused_chunk(cfg, obs: int, act: int, k: int, step: int = 1000,
                      referee: bool = False, bounds=None, rewards=None,
                      tied: bool = False, hot: bool = False,
                      spread_on_cpu: bool = False, fresh: bool = False,
                      terminal: float = 0.0, scale: float = 2.0) -> float:
    """Kernel vs plain version on one random state and batch (and noise);
    returns the largest absolute difference over end state, td and
    metrics. Raises where an output is outside the tolerances; with
    `referee` (a drifting case, see SHARE_RATIO) such an output is held
    against the plain version in float64 instead, the f32 spread measured
    by the plain version on the card, and with `spread_on_cpu` by the
    larger miss of it and the plain version on the CPU. With `bounds` (D4PG)
    the kernel runs one chunk, then set_value_bounds(*bounds) and the
    chunk that is checked, against the plain version under those bounds.
    `rewards` and `terminal` are random_batches', `tied`, `hot` and `fresh`
    random_state_np's; from a `fresh` state (zero Adam moments, counts 0)
    the first moments are also held to FRESH_MU_RTOL and FRESH_MU_SCALE.
    `scale` is the action box's half-width (2 for Pendulum)."""
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    label = (f"fused_chunk_td3 delay={cfg.policy_delay} noise={cfg.target_noise}"
             if cfg.twin_critic else
             f"fused_chunk_d4pg atoms={cfg.num_atoms}" if cfg.distributional else
             f"fused_chunk_sac autotune={cfg.sac_autotune}" if cfg.sac else "fused_chunk")
    label += (f" obs={obs} act={act} K={k}" + (" tied critics" if tied else "")
              + (" hot temperature" if hot else "") + (" fresh state" if fresh else "")
              + (f" {terminal:.0%} terminal rows" if terminal else "")
              + (" bf16" if cfg.compute_dtype == "bfloat16" else ""))
    if cfg.distributional:
        label += f" support=[{cfg.v_min:g}, {cfg.v_max:g}]"
    state = train_state_from_numpy(
        random_state_np(cfg, obs, act, seed=obs, step=step, tied=tied, hot=hot, fresh=fresh),
        "cuda")
    packed = random_batches(seed=100 + obs, k=k, b=cfg.batch_size, obs=obs, act=act,
                            rewards=rewards, weighted=k <= WEIGHTED_UP_TO, terminal=terminal)
    if terminal:
        share = float((packed[..., obs + act + 1] == 0).float().mean())
        label += f" ({share:.1%} at discount 0)"
        if share < terminal * 0.9:
            raise AssertionError(f"{label}: too few terminal rows")
    eps = noise_for(cfg, k, cfg.batch_size, act, step)
    run = fc.make_fused_chunk_fn(cfg, obs, act, scale, 0.0, chunk_size=k, device="cuda")
    if bounds is not None:
        run(state, packed, eps)
        run.set_value_bounds(*bounds)
        cfg = cfg.replace(v_min=bounds[0], v_max=bounds[1])
        label += f" after set_value_bounds{tuple(bounds)}"
    new, td, met = run(state, packed, eps)
    plain = []
    PLAIN_MS[(cfg, obs, act, k, step, scale)] = time_ms(
        lambda: plain.append(fc.fused_chunk_reference(cfg, state, packed, scale, 0.0, eps)),
        reps=1, warmup=False)
    ref, rtd, rmet = plain[0]

    got_all, want_all = chunk_outputs(new, td, met), chunk_outputs(ref, rtd, rmet)
    worst, failed = compare_outputs(label, cfg, obs, act, got_all, want_all, fresh)
    if failed and not referee:
        raise AssertionError(f"{label}: {', '.join(failed)} outside the tolerances")
    if failed:
        exact, etd, emet = fc.fused_chunk_reference(
            cfg, to_double(state), packed.double(), scale, 0.0, to_double(eps))
        exact_all = chunk_outputs(exact, etd, emet)
        cuts, groups = state_cuts(cfg, obs, act)
        spread = [want_all]
        if spread_on_cpu:
            spread.append(chunk_outputs(*fc.fused_chunk_reference(
                cfg, tree_map_tensors(torch.Tensor.cpu, state), packed.cpu(), scale, 0.0,
                tree_map_tensors(torch.Tensor.cpu, eps))))
        bad = []
        for name in failed:
            got = got_all[name].double().cpu().numpy()
            plains = [p[name].double().cpu().numpy() for p in spread]
            ex = exact_all[name].cpu().numpy()
            if name == "state":
                pieces = [(g, slice(cuts[i], cuts[i + 1])) for i, g in enumerate(groups)
                          if cuts[i + 1] > cuts[i]]
            elif name == "td":
                pieces = [("td", slice(None))]
            else:
                pieces = [(n, slice(i, i + 1)) for i, n in enumerate(METRIC_KEYS)]
            for piece, sl in pieces:
                tight = TIGHT_TOL["atol"] + TIGHT_TOL["rtol"] * np.abs(ex[sl])
                e_k = np.abs(got[sl] - ex[sl])
                e_ps = [np.abs(p[sl] - ex[sl]) for p in plains]
                share_k = float((e_k > tight).mean())
                share_p = max(float((e > tight).mean()) for e in e_ps)
                max_p = max(float(e.max()) for e in e_ps)
                ok = (share_k <= SHARE_RATIO * share_p + TIGHT_FRAC
                      and bool(np.all(e_k <= DRIFT_RATIO * max_p + tight)))
                log(f"  {label} {piece} against the float64 chunk: kernel max "
                    f"{e_k.max():.3e}, {share_k:.2e} outside TIGHT_TOL; f32 plain max "
                    + ", ".join(f"{float(e.max()):.3e} ({float((e > tight).mean()):.2e})"
                                for e in e_ps)
                    + ("" if ok else " -- fails SHARE_RATIO or DRIFT_RATIO"))
                if not ok:
                    bad.append(piece)
        if bad:
            raise AssertionError(
                f"{label}: {', '.join(bad)} farther from the float64 chunk than "
                f"SHARE_RATIO and DRIFT_RATIO allow")
    # The actor count advances by the chunk's actor updates (all K, or
    # under TD3's delay f(step0 + K) - f(step0)); the rest by K, SAC's
    # temperature count only when it is learned.
    count0 = 0 if fresh else 1000
    want_a = count0 + fc.actor_updates(cfg, step, k)
    if (int(new.actor_opt.count), int(new.critic_opt.count), int(new.step)) != (
            want_a, count0 + k, step + k) or int(ref.actor_opt.count) != want_a:
        raise AssertionError(
            f"{label}: counts {int(new.actor_opt.count)}, {int(new.critic_opt.count)}, "
            f"{int(new.step)}; expected {want_a}, {count0 + k}, {step + k}")
    if cfg.sac and (new.alpha_opt is None) != (not cfg.sac_autotune) or (
            new.alpha_opt is not None and int(new.alpha_opt.count) != count0 + k):
        raise AssertionError(f"{label}: the temperature's count did not follow the autotune")
    log(f"  {label}: actor count +{want_a - count0} from step {step}")
    return worst


def ulp_gap(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance between two f32 arrays in units in the last
    place (the count of f32 values between them; +0 and -0 are one)."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, np.int64(-2 ** 31) - i, i)

    return int(np.abs(ordered(a) - ordered(b)).max()) if a.size else 0


def update_trees(which: str):
    """(params, opt, targets, grads of step i) for the fused update's checks,
    on the card: a tree of tools/update_trees.SHAPES (the ragged one as the
    JAX test has it: zero moments, count 0; the others with random moments
    from count 999), with grads sin(p + i), laid out as the params are; or
    the critic or actor of a random_state_np state at Pendulum shapes (DDPG,
    or D4PG's 51-atom critic), with gradients drawn from N(0, 1e-2)."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.tools import update_trees as ut

    if which in ut.SHAPES:
        return ut.update_inputs(ut.SHAPES[which], ut.SHIFTS.get(which, ut.NO_SHIFTS),
                                count=0 if which == "ragged" else 999,
                                zero_moments=which == "ragged")
    family, net = which.split("_")
    cfg = DDPGConfig(distributional=family == "d4pg", v_min=-10.0, v_max=10.0)
    state = train_state_from_numpy(random_state_np(cfg, 3, 1, seed=11), "cuda")
    params = getattr(state, f"{net}_params")
    rng = np.random.default_rng(12)
    draws = [tuple({k: torch.from_numpy((1e-2 * rng.standard_normal(tuple(v.shape))
                                         ).astype(np.float32)).cuda()
                    for k, v in layer.items()} for layer in params) for _ in range(3)]
    return (params, getattr(state, f"{net}_opt"), getattr(state, f"target_{net}_params"),
            lambda i, p: draws[i])


def _update_leaves(params, opt, targets):
    from distributed_ddpg_tpu_torch.ops.optim import tree_leaves

    return [x for tree in (params, opt.mu, opt.nu, targets) for x in tree_leaves(tree)] + [
        opt.count]


def check_fused_update(which: str, steps: int = 3) -> float:
    """The fused update kernel against its plain version on the card over
    `steps` steps: each carries its own state from the same start and takes
    the same gradients. Holds every output to tests/test_fused.py's rtol
    1e-6, atol 1e-7 and prints the largest gap in units in the last place
    (0 expected: the kernel repeats the plain version's operations in its
    order and constants); the new count must be the plain version's, each
    call must be one launch a table (ops/fused_update.plan), and the inputs
    must come out as they went in. Returns the largest absolute
    difference."""
    from distributed_ddpg_tpu_torch.ops import fused_update as fu
    from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
    from distributed_ddpg_tpu_torch.ops.optim import tree_leaves

    params, opt, targets, grads_at = update_trees(which)
    p, o, t = params, opt, targets
    rp, ro, rt = params, opt, targets
    n = sum(x.numel() for x in tree_leaves(params))
    per_call = len(fu.plan(tuple(x.shape for x in tree_leaves(params))).launches)
    worst, ulps = 0.0, 0
    for i in range(steps):
        grads = grads_at(i, rp)
        inputs = lambda: _update_leaves(p, o, t) + tree_leaves(grads)  # noqa: E731
        before = [x.clone() for x in inputs()]
        launches = KERNEL_LAUNCHES["fused_update"]
        new = fu.fused_adam_polyak(p, grads, o, t, 1e-3, 0.05)
        made = KERNEL_LAUNCHES["fused_update"] - launches
        if made != per_call:
            raise AssertionError(f"fused_update {which}: {made} launches a call, "
                                 f"expected {per_call}")
        if not all(torch.equal(a, b) for a, b in zip(before, inputs())):
            raise AssertionError(f"fused_update {which} step {i}: an input changed")
        p, o, t = new
        rp, ro, rt = fu.fused_adam_polyak_reference(rp, grads, ro, rt, 1e-3, 0.05)
        torch.cuda.synchronize()
        for name, got, want in (("params", p, rp), ("mu", o.mu, ro.mu), ("nu", o.nu, ro.nu),
                                ("targets", t, rt)):
            a = torch.cat([x.reshape(-1) for x in tree_leaves(got)]).cpu().numpy()
            b = torch.cat([x.reshape(-1) for x in tree_leaves(want)]).cpu().numpy()
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"fused_update {which}: non-finite {name}")
            err = np.abs(a.astype(np.float64) - b)
            worst, ulps = max(worst, float(err.max())), max(ulps, ulp_gap(a, b))
            if not np.all(err <= 1e-7 + 1e-6 * np.abs(b.astype(np.float64))):
                raise AssertionError(
                    f"fused_update {which} step {i}: {name} outside rtol 1e-6, atol 1e-7 "
                    f"(max_abs_err {err.max():.3e})")
        if o.count.dtype != torch.int32 or int(o.count) != int(ro.count):
            raise AssertionError(f"fused_update {which}: count {o.count}, plain {ro.count}")
    if int(o.count) != int(opt.count) + steps:
        raise AssertionError(f"fused_update {which}: count {int(o.count)}")
    log(f"  fused_update {which} ({n} elements, {len(tree_leaves(params))} leaves, {per_call} "
        f"launch(es) a call, {steps} steps): max_abs_err={worst:.3e}, largest gap {ulps} ulp")
    return worst


def check_bias_corrections(counts: int = 2 ** 20) -> None:
    """The kernel's bias corrections 1 - B^c (csrc/fused_update.cu) against
    the plain version's expression, 1.0 - torch.pow(B, c) on the card, for
    every new count c in 1..counts: they must agree bit for bit."""
    from distributed_ddpg_tpu_torch.ops import fused_update as fu
    from distributed_ddpg_tpu_torch.ops.optim import B1, B2

    got = fu.kernel_bias_corrections(counts)
    c = torch.arange(1, counts + 1, dtype=torch.int32, device="cuda").to(torch.float32)
    for name, base, kernel in (("bc1", B1, got[0]), ("bc2", B2, got[1])):
        want = 1.0 - torch.pow(base, c)
        torch.cuda.synchronize()
        a, b = kernel.cpu().numpy(), want.cpu().numpy()
        bad = np.flatnonzero(a.view(np.int32) != b.view(np.int32))
        if bad.size:
            raise AssertionError(
                f"fused_update {name}: the kernel's 1 - powf(B, c) differs from "
                f"1.0 - torch.pow(B, c) at {bad.size} of {counts} counts (first c = "
                f"{bad[0] + 1}, largest gap {ulp_gap(a, b)} ulp)")
    log(f"  fused_update bias corrections: bc1 and bc2 bit-identical to 1.0 - torch.pow(B, c) "
        f"for every count 1..{counts}")


# CUgraphNodeType (cuda.h), by value.
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait event", 7: "event record", 10: "mem alloc", 11: "mem free"}


def captured_nodes(fn, calls: int) -> list:
    """The device operations that `calls` calls of `fn` enqueue: the calls
    are captured in one CUDA graph, and the graph's nodes are read through
    libcuda (cuGraphGetNodes, cuGraphNodeGetType). Every kernel, copy
    and set a call puts on the stream is one node, so the count is exact;
    a synchronizing call fails the capture. `fn` is run once first, on
    the capture's side stream."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}"))
    return kinds


def update_launches_per_call(calls: int = 5) -> float:
    """Device operations (kernels, copies, sets) a call of the fused update's
    wrapper on the Pendulum DDPG critic, counted exactly as the nodes of a
    CUDA graph that captures `calls` calls (captured_nodes): 1 expected, a
    kernel."""
    from distributed_ddpg_tpu_torch.ops import fused_update as fu

    params, opt, targets, grads_at = update_trees("ddpg_critic")
    grads = grads_at(0, params)
    kinds = captured_nodes(lambda: fu.fused_adam_polyak(params, grads, opt, targets, 1e-3, 5e-3),
                           calls)
    per_call = len(kinds) / calls
    log(f"  fused_update wrapper: {per_call:g} device operations a call over {calls} calls "
        f"(the nodes of a CUDA graph of the calls: " + ", ".join(
            f"{kind} x{kinds.count(kind)}" for kind in sorted(set(kinds))) + ")")
    if per_call != 1 or set(kinds) != {"kernel"}:
        raise AssertionError(f"fused_update wrapper: {per_call} device operations a call "
                             f"({sorted(set(kinds))}), expected one kernel launch")
    return per_call


def check_scan_route(cfg, k: int = 16, against_kernel: bool = False) -> None:
    """The scan chunk (parallel/learner.make_scan_chunk_fn) on the card on
    one random state and weighted draw at Pendulum shapes, against the same
    scan chunk on the CPU, or with `against_kernel` against the chunk
    kernel on the card, under the f32 rule (compare_outputs)."""
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import make_scan_chunk_fn

    obs, act, step = 3, 1, 1000
    label = (f"scan route {'d4pg' if cfg.distributional else 'ddpg'} "
             f"fused_update={cfg.fused_update} critic_l2={cfg.critic_l2} K={k} "
             + ("vs the chunk kernel on the card" if against_kernel else
                "on the card vs on the CPU"))
    state_np = random_state_np(cfg, obs, act, seed=21, step=step)
    packed = random_batches(seed=22, k=k, b=cfg.batch_size, obs=obs, act=act)
    state = train_state_from_numpy(state_np, "cuda")
    scan = make_scan_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=k)
    got = chunk_outputs(*scan(state, packed, None, step0=step))
    if against_kernel:
        run = fc.make_fused_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=k, device="cuda")
        want = chunk_outputs(*run(state, packed, None))
    else:
        want = chunk_outputs(*scan(train_state_from_numpy(state_np, "cpu"), packed.cpu(),
                                   None, step0=step))
    torch.cuda.synchronize()
    _, failed = compare_outputs(label, cfg, obs, act, got, want)
    if failed:
        raise AssertionError(f"{label}: {', '.join(failed)} outside the tolerances")


# Prioritized replay's checks and timing: the main path's capacity, the
# rows of the parity phase's replay, and the draw's shape (K x B).
PER_CAPACITY = 1_000_000
PER_FILL = 200_000
PER_K, PER_B = 800, 64
PER_REPEATS = 10          # runs of the card's prefix sum and draw that must agree


def per_priorities(kind: str, n: int, seed: int) -> np.ndarray:
    """n priorities: `dyadic` ones (multiples of 1/8 up to 1, so every
    running sum up to 1M of them is exact in f32, in any order), or ones
    of the main path's kind: (|td| + 1e-6)^0.6 of D4PG-sized td, three in
    ten still at a stamped max."""
    rng = np.random.default_rng(seed)
    if kind == "dyadic":
        return (rng.integers(1, 9, n) / 8.0).astype(np.float32)
    p = (np.abs(5.0 * rng.standard_normal(n)) + 1e-6) ** 0.6
    p[rng.random(n) < 0.3] = p.max()
    return p.astype(np.float32)


def check_per_draw() -> None:
    """draw_per_indices on the card against the CPU with the same uniforms,
    at the main path's capacity and draw: on dyadic priorities the indices
    must be identical and the weights within 1e-6 relative; on the main
    path's kind the share of indices that differ is printed (the two
    prefix sums add in different orders), with the count of decreasing
    neighbours in the card's prefix sum. The card's prefix sum
    (fixed_order_cumsum) must be bit-identical over PER_REPEATS runs, and
    so must the draw; torch's 1-D cumsum on the card is run as often and
    whether it repeated is printed, as context."""
    from distributed_ddpg_tpu_torch.replay.device import draw_per_indices, fixed_order_cumsum

    uniform = torch.from_numpy(
        np.random.default_rng(30).uniform(0, 1, (PER_K, PER_B)).astype(np.float32))
    for kind in ("dyadic", "random"):
        prios = torch.from_numpy(per_priorities(kind, PER_CAPACITY, 31))
        cidx, cw = draw_per_indices(prios.cuda(), PER_CAPACITY, (PER_K, PER_B), 0.4,
                                    uniform=uniform.cuda())
        hidx, hw = draw_per_indices(prios, PER_CAPACITY, (PER_K, PER_B), 0.4, uniform=uniform)
        cum = fixed_order_cumsum(prios.cuda())
        falls = int((cum[1:] < cum[:-1]).sum())
        again = all(torch.equal(cum.view(torch.int32),
                                fixed_order_cumsum(prios.cuda()).view(torch.int32))
                    for _ in range(PER_REPEATS))
        redraws = [draw_per_indices(prios.cuda(), PER_CAPACITY, (PER_K, PER_B), 0.4,
                                    uniform=uniform.cuda()) for _ in range(PER_REPEATS)]
        draw_again = all(torch.equal(i.cpu(), cidx.cpu()) and torch.equal(
            w.cpu().view(torch.int32), cw.cpu().view(torch.int32)) for i, w in redraws)
        lib = torch.cumsum(prios.cuda(), 0)
        lib_again = all(torch.equal(lib.view(torch.int32),
                                    torch.cumsum(prios.cuda(), 0).view(torch.int32))
                        for _ in range(PER_REPEATS))
        cidx, cw = cidx.cpu(), cw.cpu()
        same = cidx == hidx
        rows = same.all(dim=1)    # a row's weights share its max: compare whole rows
        w_err = float(((cw - hw).abs() / hw)[rows].max())
        log(f"  PER draw {kind} priorities, capacity {PER_CAPACITY}, K={PER_K} B={PER_B}: "
            f"{float((~same).double().mean()):.3e} of the indices differ from the CPU's "
            f"({int((~rows).sum())} of {PER_K} rows), weights' largest relative gap in the "
            f"rows that agree {w_err:.3e}; the card's prefix sum (bit-identical when run "
            f"again: {again}, {PER_REPEATS} runs; the draw again: {draw_again}) has {falls} "
            f"decreasing neighbours, total {float(cum[-1]):.6f} on the card, "
            f"{float(torch.cumsum(prios, 0)[-1]):.6f} on the CPU; torch's 1-D cumsum on "
            f"the card bit-identical when run again: {lib_again} (context)")
        if kind == "dyadic" and (not bool(same.all()) or w_err > 1e-6):
            raise AssertionError("PER draw: the card and the CPU differ on exact sums")
        if cidx.max() >= PER_CAPACITY or not bool(torch.isfinite(cw).all()):
            raise AssertionError(f"PER draw {kind}: an index past the fill or a bad weight")
        if not (again and draw_again):
            raise AssertionError(f"PER draw {kind}: not bit-identical when run again")


def per_replay(obs: int, act: int, seed: int):
    """A DevicePrioritizedReplay on the card at the main path's capacity:
    PER_FILL random rows (weight column 1) and priorities of the main
    path's kind, max_priority their largest."""
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay

    rep = DevicePrioritizedReplay(PER_CAPACITY, obs, act, "cuda", block_size=1024)
    rep.add_packed(random_batches(seed, 1, PER_FILL, obs, act, weighted=False)[0].cpu().numpy())
    prios = torch.zeros(PER_CAPACITY, device="cuda")
    prios[:PER_FILL] = torch.from_numpy(per_priorities("random", PER_FILL, seed))
    rep.set_per_state(prios, prios.max())
    return rep


def check_per_chunk(cfg, k: int = 16) -> None:
    """One PER chunk (ShardedLearner.run_sample_chunk_per) on the chunk
    kernel's route against the scan route, on the card, from one random
    state and replay, on the same idx and weights (drawn once at beta
    0.5): the state, td and the metrics under the f32 rule
    (compare_outputs), the priority vector and max_priority within
    OUT_TOL, and the replay's rows untouched."""
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import draw_per_indices

    obs, act, step = 3, 1, 1000
    label = f"PER chunk {'d4pg' if cfg.distributional else 'ddpg'} K={k}, kernel vs scan route"
    state_np = random_state_np(cfg, obs, act, seed=33, step=step)
    rep = per_replay(obs, act, 34)
    p0, m0, rows = rep.priorities.clone(), rep.max_priority.clone(), rep.storage.clone()
    idx, w = draw_per_indices(p0, PER_FILL, (k, cfg.batch_size), 0.5,
                              generator=torch.Generator(device="cuda").manual_seed(35))
    outs = {}
    for route in ("on", "off"):
        c = cfg.replace(prioritized=True, fused_chunk=route)
        learner = ShardedLearner(c, obs, act, 2.0, 0.0, chunk_size=k,
                                 state=train_state_from_numpy(state_np, "cuda"))
        rep.set_per_state(p0.clone(), m0.clone())
        out = learner.run_sample_chunk_per(rep, 0.5, idx=idx, weights=w)
        outs[route] = (chunk_outputs(learner.state, out.td_errors, out.metrics),
                       {"priorities": rep.priorities, "max_priority": rep.max_priority})
    torch.cuda.synchronize()
    if not torch.equal(rep.storage, rows):
        raise AssertionError(f"{label}: the chunk wrote into the replay's rows")
    _, failed = compare_outputs(label, cfg, obs, act, outs["on"][0], outs["off"][0])
    for name in ("priorities", "max_priority"):
        got = outs["on"][1][name].double().cpu().numpy()
        want = outs["off"][1][name].double().cpu().numpy()
        err = np.abs(got - want)
        ok = bool(np.all(err <= OUT_TOL["atol"] + OUT_TOL["rtol"] * np.abs(want)))
        log(f"  {label} {name}: max_abs_err={err.max():.3e}" + ("" if ok else " -- outside"))
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"{label}: {', '.join(failed)} outside the tolerances")


def check_per_duplicates() -> None:
    """The priority write's duplicate rule (scatter_last_wins: the last
    occurrence in flat order wins) on the card, twice, against the CPU and
    a plain loop, on K x B indices over 1000 slots (every slot drawn ~51
    times): bit-identical throughout."""
    from distributed_ddpg_tpu_torch.replay.device import scatter_last_wins

    rng = np.random.default_rng(36)
    idx = rng.integers(0, 1000, PER_K * PER_B)
    vals = rng.standard_normal(PER_K * PER_B).astype(np.float32)
    want = np.zeros(1000, np.float32)
    for i, v in zip(idx.tolist(), vals):
        want[i] = v
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        target = torch.zeros(1000, device=device)
        scatter_last_wins(target, torch.from_numpy(idx).to(device),
                          torch.from_numpy(vals).to(device))
        runs.append(target.cpu().numpy())
    same = [bool(np.array_equal(r.view(np.int32), want.view(np.int32))) for r in runs]
    log(f"  PER duplicate rule over {len(idx)} draws of 1000 slots: card run 1 {same[0]}, "
        f"card run 2 {same[1]}, CPU {same[2]} bit-identical to last-wins")
    if not all(same):
        raise AssertionError("PER duplicate rule: not the last draw on the card or the CPU")


def sync_calls(fn, settle: bool = True) -> int:
    """Synchronizing CUDA calls made by fn() (torch.cuda sync debug mode,
    'warn', its warnings counted, from any thread; the mode's own notice,
    once a process, is not one). With `settle` the card is synchronized
    first; without, work queued before (a running chunk) keeps running."""
    import warnings

    if settle:
        torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def check_per_syncs() -> None:
    """PER adds no synchronizing call: a PER chunk (draw, gather, weights,
    chunk, priority write, max) against a uniform chunk on the same
    learner, and a prioritized insert (rows, then the stamp) against a
    uniform one, at the main path's capacity (DDPG, K = 16)."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    cfg = DDPGConfig(prioritized=True)
    learner = ShardedLearner(cfg, 3, 1, 2.0, 0.0, chunk_size=16, state=train_state_from_numpy(
        random_state_np(cfg, 3, 1, seed=37), "cuda"))
    rep = per_replay(3, 1, 38)
    learner.run_sample_chunk_per(rep, 0.5)          # warm: first calls allocate
    learner.run_sample_chunk(rep)
    per = sync_calls(lambda: learner.run_sample_chunk_per(rep, 0.5))
    uniform = sync_calls(lambda: learner.run_sample_chunk(rep))
    block = random_batches(39, 1, 1024, 3, 1, weighted=False)[0].cpu().numpy()
    plain = DeviceReplay(PER_CAPACITY, 3, 1, "cuda", block_size=1024)
    for r in (rep, plain):
        r.add_packed(block)
    stamped = sync_calls(lambda: rep.add_packed(block))
    unstamped = sync_calls(lambda: plain.add_packed(block))
    log(f"  PER host syncs: a PER chunk {per}, a uniform chunk {uniform}; a prioritized "
        f"insert {stamped}, a uniform insert {unstamped}")
    if per > uniform or stamped > unstamped:
        raise AssertionError("PER adds a synchronizing call (a host read of the device)")


# --- the ingest pipeline (replay/device.py, transfer/) ---

INGEST_BLOCK = 1024       # the main path's block (train.py)
INGEST_BLOCKS = 8         # blocks staged by the driver during one running chunk


def pipeline_kwargs(kind: str, sched=None) -> dict:
    """The replay's pipeline: "main" is the main path's at D = 1 (the
    scheduler's ships, the adaptive cap, the pinned pool), "inline" its
    ships on the caller's thread with the pinned pool (the D > 1 ranks'),
    "old" the pipeline of --ingest_async=false --transfer_scheduler=false
    (inline, pageable), "serial" the block-at-a-time reference."""
    return {
        "main": dict(async_ship=True, scheduler=sched, adaptive_coalesce=True, host_pool=True),
        "inline": dict(host_pool=True),
        "old": dict(),
        "serial": dict(max_coalesce=1),
    }[kind]


def warm_pool(rep, rows: int, n: int = 2) -> None:
    """Allocate the pool's n pinned buffers of a shape up front, so no
    allocation falls inside a measured window."""
    bufs = [rep._pool.acquire(rows) for _ in range(n)]
    for buf in bufs:
        rep._pool.commit(buf, None)


def replay_snapshot(rep) -> dict:
    out = dict(storage=rep.storage.clone(), ptr=rep.ptr, size=rep.size)
    if hasattr(rep, "priorities"):
        out.update(priorities=rep.priorities.clone(), max_priority=rep.max_priority.clone())
    return out


def same_replay(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
               for k in a)


def check_ingest_parity() -> None:
    """The main path's pipeline against the serial block-at-a-time
    sequence on the card, uniform and PER: a ragged inflow at Pendulum's
    width (40 adds of 1-3000 rows) into a ring of 16 blocks, which it
    wraps ~3.7 times, with a priority write between two inserts under
    PER. Storage, ptr, size, priorities and max priority bit for bit."""
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    obs, act, cap = 3, 1, 16 * INGEST_BLOCK
    rng = np.random.default_rng(51)
    inflow = [rng.standard_normal((int(n), 2 * obs + act + 3)).astype(np.float32)
              for n in rng.integers(1, 3000, 40)]
    for per in (False, True):
        cls = DevicePrioritizedReplay if per else DeviceReplay
        sched = TransferScheduler().start()
        try:
            serial = cls(cap, obs, act, "cuda", block_size=INGEST_BLOCK,
                         **pipeline_kwargs("serial"))
            piped = cls(cap, obs, act, "cuda", block_size=INGEST_BLOCK,
                        **pipeline_kwargs("main", sched))
            for i, rows in enumerate(inflow):
                serial.add_packed(rows)
                piped.add_packed(rows)
                if per and i == 20:
                    prios = torch.rand(cap, device="cuda") + 0.5
                    for r in (serial, piped):
                        r.drain_pending()
                        r.set_per_state(prios.clone(), torch.tensor(3.25, device="cuda"))
            piped.drain_pending()
            for r in (serial, piped):
                r.flush()
            torch.cuda.synchronize()
            ok = same_replay(replay_snapshot(piped), replay_snapshot(serial))
            snap, tsnap = piped.ingest_snapshot(), piped.transfer_snapshot()
            log(f"  ingest parity {'PER' if per else 'uniform'}: {sum(map(len, inflow))} rows, "
                f"ptr {piped.ptr}, size {piped.size}, bit-identical to the serial run: {ok}; "
                f"{snap['ingest_ship_calls']} ships, coalesce mean "
                f"{snap['ingest_coalesce_mean']}, cap {tsnap['transfer_coalesce_cap']}, "
                f"pool buffers {tsnap['transfer_pool_buffers']}, fence waits "
                f"{tsnap['transfer_pool_fence_waits']}")
            piped.close()
            if not ok:
                raise AssertionError("the pipelined replay differs from the serial one")
        finally:
            sched.close()


def ingest_during_chunk(card: str) -> dict:
    """The driver's side of an insert while a K = 800 K1 (a) chunk runs
    (Pendulum shapes, 2x256, batch 64): INGEST_BLOCKS blocks staged by
    add_packed, one block a call, on the main path's pipeline (uniform and
    PER) and the old one; then one 8-block add_packed shipped and stamped
    inline from the pinned pool (PER, the D > 1 ranks' pipeline). For
    each: torch's synchronizing calls (sync debug mode) from the first
    add_packed until every ship has been issued, the driver's time in
    add_packed (total and longest call), and whether the chunk was still
    running when the last add_packed returned; the rows then landed. The
    main and inline pipelines must make no synchronizing call and leave
    the chunk running (a ship that waits on a pool fence waits on the
    scheduler's thread, and is counted); the old one's copy waits for the
    chunk."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    cfg, obs, act, k = DDPGConfig(), 3, 1, 800
    learner = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=k, state=train_state_from_numpy(
        random_state_np(cfg, obs, act, seed=53), "cuda"))
    big = DeviceReplay(65536, obs, act, "cuda", block_size=INGEST_BLOCK)
    big.add_packed(random_batches(54, 1, 65536, obs, act, weighted=False)[0].cpu().numpy())
    chunk_ms = time_ms(lambda: learner.run_sample_chunk(big), reps=3)
    rows = random_batches(55, 1, INGEST_BLOCKS * INGEST_BLOCK, obs, act,
                          weighted=False)[0].cpu().numpy()
    out = {"chunk_ms": chunk_ms}
    sched = TransferScheduler().start()
    try:
        for label, per, kind, calls in (("main", False, "main", INGEST_BLOCKS),
                                        ("main PER", True, "main", INGEST_BLOCKS),
                                        ("inline PER", True, "inline", 1),
                                        ("old", False, "old", INGEST_BLOCKS)):
            cls = DevicePrioritizedReplay if per else DeviceReplay
            rep = cls(PER_CAPACITY, obs, act, "cuda", block_size=INGEST_BLOCK,
                      **pipeline_kwargs(kind, sched))
            if kind == "inline":
                rep._adaptive = None   # one 8-block ship, one stamp
            pieces = np.split(rows, calls)
            for _ in range(3):   # warm: the pool's buffers, the cap's first steps
                for piece in pieces:
                    rep.add_packed(piece)
                rep.drain_pending()
            before = rep.size
            waits = rep._pool.fence_waits if rep._pool is not None else None
            times = []

            def stage():
                for piece in pieces:
                    t0 = time.perf_counter()
                    rep.add_packed(piece)
                    times.append(time.perf_counter() - t0)
                running = not learner.chunk_done()
                while rep.pending_rows:   # every ship popped, on whichever thread,
                    time.sleep(0.0002)
                with rep.dispatch_lock:   # and issued
                    pass
                return running

            torch.cuda.synchronize()
            learner.run_sample_chunk(big)     # the running chunk
            running = []
            syncs = sync_calls(lambda: running.append(stage()), settle=False)
            torch.cuda.synchronize()
            landed = rep.size - before == INGEST_BLOCKS * INGEST_BLOCK and torch.equal(
                rep.storage[before:rep.size].cpu(), torch.from_numpy(rows))
            out[label] = dict(total_ms=1000.0 * sum(times), max_ms=1000.0 * max(times),
                              syncs=syncs, running=running[0], landed=landed,
                              fence_waits=None if waits is None
                              else rep._pool.fence_waits - waits)
            log(f"  ingest during a K={k} chunk ({chunk_ms:.3f} ms), {label} pipeline: "
                f"add_packed of {INGEST_BLOCKS} blocks in {calls} calls held the driver "
                f"{out[label]['total_ms']:.3f} ms (longest call {out[label]['max_ms']:.3f}); "
                f"sync calls {syncs}; the chunk still running when the last call returned: "
                f"{running[0]}; rows landed: {landed}; pool fence waits (on the shipping "
                f"thread) {out[label]['fence_waits']} ({card})")
            rep.close()
            if not landed:
                raise AssertionError(f"ingest ({label}): the rows did not land")
            if kind != "old" and (syncs or not running[0]):
                raise AssertionError(f"ingest ({label}): a ship synchronized or waited for "
                                     "the running chunk")
    finally:
        sched.close()
    return out


def check_ingest_wrap() -> None:
    """A ring of 4 blocks, full, gathered by a K = 16 chunk dispatched
    behind a running K = 800 chunk; then 4 new blocks inserted on the main
    path's pipeline (one 4-block ship, the adaptive cap off so that no
    ship waits on a pool fence), which wrap and overwrite the whole ring
    while the gather is still queued. The chunk's gathered rows must be
    the rows before the insert, and the ring must hold the new rows."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    cfg, obs, act, cap = DDPGConfig(), 3, 1, 4 * INGEST_BLOCK
    state = random_state_np(cfg, obs, act, seed=57)
    long = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=800,
                          state=train_state_from_numpy(state, "cuda"))
    short = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=16,
                           state=train_state_from_numpy(state, "cuda"))
    big = DeviceReplay(65536, obs, act, "cuda", block_size=INGEST_BLOCK)
    big.add_packed(random_batches(58, 1, 65536, obs, act, weighted=False)[0].cpu().numpy())
    old = random_batches(59, 1, cap, obs, act, weighted=False)[0].cpu().numpy()
    new = random_batches(60, 1, cap, obs, act, weighted=False)[0].cpu().numpy()
    sched = TransferScheduler().start()
    try:
        rep = DeviceReplay(cap, obs, act, "cuda", block_size=INGEST_BLOCK,
                           **pipeline_kwargs("main", sched))
        rep._adaptive = None
        warm_pool(rep, cap)
        rep.add_packed(old)
        rep.drain_pending()
        idx = torch.randint(0, cap, (16, cfg.batch_size), device="cuda")
        gathered = []
        run = short._run

        def capture(packed, eps, kernel, **kw):
            gathered.append(packed.clone())   # queued right after the gather
            return run(packed, eps, kernel, **kw)

        short._run = capture
        torch.cuda.synchronize()
        long.run_sample_chunk(big)        # occupies the stream ~73 ms
        short.run_sample_chunk(rep, idx=idx)
        queued = not long.chunk_done()
        rep.add_packed(new)
        while rep.pending_rows:
            time.sleep(0.0002)
        with rep.dispatch_lock:
            issued_early = not long.chunk_done()
        torch.cuda.synchronize()
        want = torch.from_numpy(old)[idx.cpu()]
        ok = torch.equal(gathered[0].cpu(), want) and torch.equal(
            rep.storage.cpu(), torch.from_numpy(new))
        log(f"  ingest wrap: a chunk queued before a wrapping insert gathered the rows before "
            f"it: {ok} (the gather queued behind the running chunk: {queued}; the insert "
            f"issued before it ended: {issued_early})")
        rep.close()
        if not (ok and queued and issued_early):
            raise AssertionError("ingest wrap: an insert overtook a queued gather, or the "
                                 "check did not overlap the chunk")
    finally:
        sched.close()


def check_ingest_fence() -> None:
    """The pinned pool hands a buffer out again only after the copy that
    read it has run: 3 inline one-block ships from the pool (depth 2)
    behind a running K = 800 chunk, each buffer filled with NaN right as
    acquire returns it. The third ship must wait for the first's fence,
    and the ring must hold the rows shipped, not the NaN."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    cfg, obs, act = DDPGConfig(), 3, 1
    learner = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=800, state=train_state_from_numpy(
        random_state_np(cfg, obs, act, seed=61), "cuda"))
    big = DeviceReplay(65536, obs, act, "cuda", block_size=INGEST_BLOCK)
    big.add_packed(random_batches(62, 1, 65536, obs, act, weighted=False)[0].cpu().numpy())
    rows = random_batches(63, 1, 3 * INGEST_BLOCK, obs, act, weighted=False)[0].cpu().numpy()
    rep = DeviceReplay(8 * INGEST_BLOCK, obs, act, "cuda", block_size=INGEST_BLOCK,
                       **pipeline_kwargs("inline"))
    warm_pool(rep, INGEST_BLOCK)
    acquire = rep._pool.acquire

    def acquire_and_clobber(n):
        buf = acquire(n)
        buf.fill(np.nan)
        return buf

    rep._pool.acquire = acquire_and_clobber
    learner.run_sample_chunk(big)
    torch.cuda.synchronize()
    learner.run_sample_chunk(big)
    for piece in np.split(rows, 3):
        rep.add_packed(piece)
    torch.cuda.synchronize()
    ok = torch.equal(rep.storage[:3 * INGEST_BLOCK].cpu(), torch.from_numpy(rows))
    waits = rep._pool.fence_waits
    log(f"  ingest fence: 3 pooled ships behind a running chunk, each buffer clobbered as "
        f"acquired: the ring holds the shipped rows: {ok}; fence waits {waits}")
    if not ok or waits != 1:
        raise AssertionError("ingest fence: a pool buffer was reused before its copy ran")


def time_per(card: str, chunk_ms: float) -> None:
    """PER's own work a chunk at the main path's shapes (K = 800, B = 64,
    capacity 1M, D4PG's rows): the draw, the gather into a fresh copy, the
    weight column, then from a td of the chunk's shape the new priorities,
    their write and the max, as run_sample_chunk_per does them around the
    chunk. Device time a chunk from torch.profiler (the card's busy time),
    time a chunk with the host's enqueue from CUDA events, beside the
    chunk kernel's time a chunk and PER's byte bound: the priority vector
    read once, the K x B rows read and written, td read, the K x B
    priorities and the max written. Then the draw's prefix sum alone, by
    row length, beside torch's 1-D cumsum (graph_ms)."""
    from distributed_ddpg_tpu_torch.replay.device import (
        SCAN_BLOCK,
        draw_per_indices,
        fixed_order_cumsum,
        scatter_last_wins,
    )

    rep = per_replay(3, 1, 40)
    gen = torch.Generator(device="cuda").manual_seed(41)
    td = torch.randn(PER_K, PER_B, device="cuda", generator=gen)

    def per_work():
        p, m = rep.priorities, rep.max_priority
        idx, w = draw_per_indices(p, rep.size, (PER_K, PER_B), 0.7, generator=gen)
        packed = rep.storage[idx]
        packed[..., -1] = w
        new_p = (td.abs() + 1e-6) ** 0.6
        scatter_last_wins(p, idx.reshape(-1), new_p.reshape(-1))
        torch.maximum(m, new_p.max(), out=m)

    wall_ms = time_ms(per_work, reps=20)
    device_ms, launches = profiled(per_work)
    width = rep.width
    nbytes = (4 * PER_CAPACITY + 2 * PER_K * PER_B * width * 4 + PER_K * PER_B * 4
              + PER_K * PER_B * 4 + 4)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"[timing] {card}: PER a chunk (K={PER_K}, B={PER_B}, capacity {PER_CAPACITY}): "
        f"device time {device_ms * 1e3:.2f} us ({launches:.1f} kernel launches), "
        f"{wall_ms * 1e3:.2f} us a chunk with the host's enqueue; the D4PG chunk kernel "
        f"{chunk_ms:.3f} ms a chunk, PER's device time {device_ms / chunk_ms:.3%} of it; "
        f"bound {bound_ms * 1e3:.3f} us, bytes ({nbytes / 1e6:.2f} MB)")
    # The draw's prefix sum alone, at the kept row length and at 4x it, and
    # torch's 1-D cumsum (CUB's look-back: faster, not reproducible), as
    # device time in a CUDA graph: after the profiler sessions before it,
    # torch.profiler has reported no device time for CUB's kernels.
    p = rep.priorities
    sums = {f"fixed_order_cumsum rows of {SCAN_BLOCK} (kept)": lambda: fixed_order_cumsum(p),
            f"fixed_order_cumsum rows of {4 * SCAN_BLOCK}":
                lambda: fixed_order_cumsum(p, 4 * SCAN_BLOCK),
            "torch.cumsum 1-D (context)": lambda: torch.cumsum(p, 0)}
    for name, fn in sums.items():
        log(f"[timing] {card}: PER's prefix sum over {PER_CAPACITY} priorities, {name}: "
            f"device time {graph_ms(fn) * 1e3:.2f} us (CUDA graph)")


def profiled(fn, reps: int = 20):
    """Device time (ms) and kernel launches of one call of `fn`, from
    torch.profiler over `reps` calls (the card's busy time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3
    return device_ms, sum(e.count for e in events if e.key in LAUNCH_CALLS) / reps


def graph_ms(fn, calls: int = 50) -> float:
    """Device time of one call of `fn`: `calls` calls captured in one CUDA
    graph, the graph replayed (CUDA events), so that the host's launch rate
    does not enter. `fn` is run once first, on the capture's side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps=20) / calls


def time_fused_update(card: str) -> dict:
    """The fused update at the Pendulum critic's and actor's sizes (DDPG,
    2x256), each as device time in a CUDA graph (graph_ms) and as host
    time a call when launched eagerly (time_ms; the scan step pays this):
    its wrapper (the leaf table, one launch, the output views), as the port
    calls it; as a breakdown of the wrapper, the kernel alone, launched
    directly with a table built once (on the tree's own leaves, warm in L2
    as the scan step leaves them; not counted), and the launch floor, an
    empty kernel with the same table and grid; the plain version; the
    library pair torch._fused_adam_ + torch._foreach_lerp_ (two calls, a
    yardstick only). Beside the bound, 36 bytes an element and the count
    over HBM's rate.
    Returns the critic's fields for the kernels' record: device times in a
    CUDA graph, `ms` the wrapper's."""
    from distributed_ddpg_tpu_torch.ops import fused_update as fu
    from distributed_ddpg_tpu_torch.ops.optim import B1, B2, EPS, tree_leaves

    lib = fu._lib()
    fields = {}
    for net in ("critic", "actor"):
        params, opt, targets, grads_at = update_trees(f"ddpg_{net}")
        grads = grads_at(0, params)
        leaves = [tree_leaves(x) for x in (params, opt.mu, opt.nu, grads, targets)]
        shapes = tuple(x.shape for x in leaves[0])
        n = sum(x.numel() for x in leaves[0])
        in_ptrs = [[x.data_ptr() for x in ls] for ls in leaves]
        layout = fu.plan(shapes)
        (launch,) = layout.launches
        out = torch.empty(4 * layout.stride, device="cuda")
        new_count = torch.empty_like(opt.count)
        table = fu.leaf_table(layout, launch, in_ptrs, out.data_ptr(), opt.count.data_ptr(),
                              new_count.data_ptr(), 1e-3, 1e-3)

        def kernel(empty: int = 0):
            def run():
                fu.check(lib, lib.fused_update_launch(table, launch.blocks, empty,
                                                      torch.cuda.current_stream().cuda_stream))

            return run

        ps, ms_, vs, ts = ([x.clone() for x in ls] for ls in (leaves[0], leaves[1], leaves[2],
                                                             leaves[4]))
        steps = [torch.tensor(1001.0, device="cuda") for _ in ps]

        def library():
            torch._fused_adam_(ps, leaves[3], ms_, vs, [], steps, lr=1e-3, beta1=B1,
                               beta2=B2, weight_decay=0.0, eps=EPS, amsgrad=False,
                               maximize=False)
            torch._foreach_lerp_(ts, ps, 1e-3)

        calls = {
            "wrapper": lambda: fu.fused_adam_polyak(params, grads, opt, targets, 1e-3, 1e-3),
            "kernel alone (breakdown)": kernel(),
            "empty kernel (launch floor)": kernel(empty=1),
            "plain": lambda: fu.fused_adam_polyak_reference(params, grads, opt, targets,
                                                            1e-3, 1e-3),
            "library pair": library,
        }
        device = {name: graph_ms(fn) for name, fn in calls.items()}
        host = {name: time_ms(fn, reps=200) for name, fn in calls.items()}
        nbytes = 36 * n + 8          # 5 reads and 4 writes of f32 an element; the count
        ops = FUSED_UPDATE_OPS * n
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS) * 1e3
        log(f"[timing] {card}: fused_update {net} (n={n}), us a call, device time in a "
            f"CUDA graph / eager launches: " + ", ".join(
                f"{name} {device[name] * 1e3:.2f} / {host[name] * 1e3:.2f}" for name in calls)
            + f"; bound {bound_ms * 1e3:.3f} us, bytes ({nbytes / 1e6:.2f} MB, "
            f"{ops / 1e6:.2f} MFLOP)")
        if net == "critic":
            fields = {"ms": device["wrapper"], "plain_ms": device["plain"],
                      "bound_ms": bound_ms,
                      "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S >= ops / PEAK_F32_FLOPS
                                   else "operations"),
                      "library_ms": device["library pair"]}
    return fields


def time_scan_chunk(card: str, cfg, k: int) -> None:
    """The scan route's time per step at the main path's chunk (Pendulum,
    2x256, K = k), with fused_update on and off: one chunk each, host
    enqueue included (context beside the chunk kernel's time). Then
    torch.profiler over a chunk of PROFILE_STEPS steps: kernel launches a
    step and the card's busy time a step, whose ratio to the K = k step
    time is the card's busy share on this route."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import make_scan_chunk_fn

    state = train_state_from_numpy(random_state_np(cfg, 3, 1, seed=7), "cuda")
    packed = random_batches(seed=8, k=k, b=cfg.batch_size, obs=3, act=1, weighted=False)
    short = packed[:PROFILE_STEPS].contiguous()
    for fused in (True, False):
        c = cfg.replace(fused_update=fused, fused_chunk="off")
        scan = make_scan_chunk_fn(c, 3, 1, 2.0, 0.0, chunk_size=k)
        ms = time_ms(lambda: scan(state, packed, None, step0=1000), reps=1, warmup=False)
        few = make_scan_chunk_fn(c, 3, 1, 2.0, 0.0, chunk_size=PROFILE_STEPS)
        few(state, short, None, step0=1000)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            few(state, short, None, step0=1000)
            torch.cuda.synchronize()
        events = prof.key_averages()
        launches = sum(e.count for e in events if e.key in LAUNCH_CALLS) / PROFILE_STEPS
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA) / PROFILE_STEPS
        step_us = ms * 1e3 / k
        log(f"[timing] {card}: scan route K={k} fused_update={fused}: {ms:.1f} ms/chunk = "
            f"{step_us:.2f} us/step; profiled over {PROFILE_STEPS} steps: {launches:.1f} "
            f"kernel launches and {busy_us:.1f} us of device time a step, the card busy "
            f"{busy_us / step_us:.1%} of a step")


def breakdown(run, state, packed, eps, k: int) -> None:
    """Where the kernel's time goes: the same launch with every stage's
    tiles turned off (barriers + optimizer pass), with the optimizer off
    too (barriers alone), and with one stage's tiles at a time on top of
    the barriers (on update steps and, under TD3's delay, on the steps
    that skip the actor's backward). Restores the launch parameters
    afterwards."""
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    ip, saved = run.ip, run.ip.clone()
    prog = run.program
    n_stages = len(prog.stage_tiles)
    firsts = (fc.IP_STAGE_TILES, fc.IP_STAGE_TILES_SKIP)

    def us_per_step() -> float:
        return time_ms(lambda: run(state, packed, eps), reps=3) * 1e3 / k

    def tiles_off() -> None:
        for first in firsts:
            ip[first:first + n_stages] = 0

    skips = prog.stage_tiles_skip != prog.stage_tiles
    try:
        if skips:   # the actor's backward tiles run on every step
            ip[fc.IP_STAGE_TILES_SKIP:fc.IP_STAGE_TILES_SKIP + n_stages] = \
                saved[fc.IP_STAGE_TILES:fc.IP_STAGE_TILES + n_stages]
            unmasked = us_per_step()
        tiles_off()
        barriers_opt = us_per_step()
        ip[fc.IP_NA] = ip[fc.IP_NC] = 0
        barriers = us_per_step()
        per_stage = []
        for s in range(n_stages):
            tiles_off()
            for first in firsts:
                ip[first + s] = saved[first + s]
            per_stage.append(us_per_step() - barriers)
    finally:
        ip.copy_(saved)
    log(f"[breakdown] us/step: {n_stages + 1} barriers {barriers:.2f} "
        f"({barriers / (n_stages + 1):.2f} each), optimizer pass "
        f"{barriers_opt - barriers:.2f}, stage tiles "
        + ", ".join(f"s{s}({prog.stage_tiles[s]}"
                    + (f"/{prog.stage_tiles_skip[s]}" if skips else "") + f") {t:.2f}"
                    for s, t in enumerate(per_stage))
        + (" (tiles: update step / step without an actor update)" if skips else ""))
    if skips:
        log(f"[breakdown] with the actor's backward tiles run on every step too: "
            f"{unmasked:.2f} us/step")


class ChunkEvents:
    """CUDA events (timing on) recorded just before and just after every
    chunk dispatch of a main path (ShardedLearner.run_sample_chunk,
    run_sample_chunk_per and, for the host replay, run_chunk_async,
    patched for the `with` block). The card is idle
    from a chunk's end event to the next chunk's start event, save for the
    inserts queued in between; `summary()` reads the gaps after a
    synchronize."""

    def __enter__(self):
        from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

        self.events = []
        self._saved = {n: getattr(ShardedLearner, n)
                       for n in ("run_sample_chunk", "run_sample_chunk_per", "run_chunk_async")}
        for n, fn in self._saved.items():
            setattr(ShardedLearner, n, self._timed(fn))
        return self

    def _timed(self, fn):
        def run(learner, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(learner, *args, **kwargs)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((start, end))
            return out
        return run

    def __exit__(self, *exc):
        from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

        for n, fn in self._saved.items():
            setattr(ShardedLearner, n, fn)

    def summary(self) -> dict:
        """The idle gaps between chunks (ms: median, max) and the card's
        busy share from the first chunk's start to the last one's end."""
        torch.cuda.synchronize()
        ev = self.events
        gaps = [ev[i][1].elapsed_time(ev[i + 1][0]) for i in range(len(ev) - 1)]
        busy = sum(a.elapsed_time(b) for a, b in ev)
        span = ev[0][0].elapsed_time(ev[-1][1])
        return dict(gap_median_ms=float(np.median(gaps)) if gaps else None,
                    gap_max_ms=max(gaps) if gaps else None, busy_share=busy / span)


def drive_main_path(flags, name: str, summary_out: dict = None) -> dict:
    """One run of `distributed_ddpg_tpu_torch.train` with these flags (the
    CLI's own parser), with the launch counts zeroed just before and read
    just after. On the kernel route every chunk must be one launch of
    kernel `name`; on the scan route (`name` "scan") no chunk kernel may
    launch, and the fused update twice a learner step when fused_update is
    on, else never. Under --prioritized=true the final beta must lie in
    [per_beta, per_beta_final] and max_priority be at least its start, 1.
    Returns the launch counts; `summary_out` receives train()'s summary."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.train import train

    cfg = DDPGConfig.from_flags(flags)
    fc.KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    with ChunkEvents() as chunk_events:
        summary = train(cfg, echo=False)
    launches = dict(fc.KERNEL_LAUNCHES)
    summary.update(chunk_events.summary())
    if summary_out is not None:
        summary_out.update(summary)
    log(f"[main path {name}] {time.monotonic() - t0:.1f}s: " + json.dumps(summary))
    log(f"[main path {name}] {summary['transport']}, shipper "
        f"{summary['ingest_async_active']}: learner steps/s {summary['learner_steps_per_sec']}, "
        f"env steps/s {summary['env_steps_per_sec']}; the driver's ingest while chunks ran "
        f"{summary['t_ingest_chunk_ms']:.3f} ms a chunk (longest call "
        f"{summary['t_ingest_run_max']:.3f} ms, {summary['n_ingest_run']} calls); since the last "
        f"train record: ingest_coalesce_mean {summary.get('ingest_coalesce_mean')}, "
        f"ingest_stall_ms {summary.get('ingest_stall_ms')}, transfer_pool_fence_waits "
        f"{summary.get('transfer_pool_fence_waits')}; the card idle between chunks "
        f"{summary['gap_median_ms']} ms median (max {summary['gap_max_ms']}), busy "
        f"{100.0 * summary['busy_share']:.2f}% from the first chunk's start to the last's end")
    # Every D = 1 main path runs the JAX trainer's default ingest, unless
    # its flags ask for the old pipeline: 'auto' must not land on the queue.
    # Under strict_sync the actors are inline and nothing ships off the
    # driver's thread; the host replay has no shipper.
    want_transport = ("inline" if cfg.strict_sync else
                      "queue" if "--transport=queue" in flags else "shm")
    want_async = not (cfg.strict_sync or cfg.host_replay or "--ingest_async=false" in flags)
    if summary["transport"] != want_transport or summary["ingest_async_active"] != want_async:
        raise AssertionError(f"main path {name}: transport {summary['transport']}, shipper "
                             f"{summary['ingest_async_active']}")
    if cfg.host_replay:
        log(f"[main path {name}] host replay: the driver's wait for a prefetched chunk "
            f"{summary['t_sample_wait_run_ms']:.3f} ms a chunk (depth {summary['prefetch_depth']})"
            + (f", sum tree {summary['sum_tree']}" if cfg.prioritized else ""))
        if cfg.prioritized and summary["sum_tree"] != "native":
            raise AssertionError(f"main path {name}: the host PER ran the "
                                 f"{summary['sum_tree']} sum tree, not the native one")
    if cfg.distributional:
        with open(cfg.log_path) as f:
            support = [r for r in map(json.loads, f) if r["kind"] == "support"]
        for r in support:
            log(f"[main path {name}] support ({r['reason']}, env step {r['step']}): "
                f"[{r['v_min']}, {r['v_max']}]")
        if not support or support[0]["reason"] != "warmup" or not (
                math.isfinite(summary["v_min"]) and summary["v_min"] < summary["v_max"]):
            raise AssertionError(f"main path {name}: no support resolved from warmup")
    scan = name == "scan"
    if summary["fused_chunk_active"] == scan:
        raise AssertionError(f"main path {name}: fused_chunk_active is "
                             f"{summary['fused_chunk_active']}")
    want = ({"fused_update": 2 * summary["learner_steps"]} if cfg.fused_update else {}) \
        if scan else {name: summary["chunks"]}
    if summary["chunks"] < 1 or launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    # A resumed run's learner steps start at the step it restored.
    if summary["learner_steps"] - (summary.get("resumed_from") or 0) != \
            summary["chunks"] * resolve_learner_chunk(cfg):
        raise AssertionError("learner_steps != chunks x K")
    if summary["compute_dtype"] != cfg.compute_dtype:
        raise AssertionError(f"main path {name} ran in {summary['compute_dtype']}")
    if cfg.sac:
        log(f"[main path {name}] final alpha {summary['alpha']}, final return "
            f"{summary['final_return']}")
    if cfg.prioritized:
        log(f"[main path {name}] prioritized: final beta {summary['beta']}, max_priority "
            f"{summary['max_priority']}")
        if not (summary["prioritized"] and cfg.per_beta <= summary["beta"] <= cfg.per_beta_final
                and summary["max_priority"] >= 1.0):
            raise AssertionError(f"main path {name}: PER's beta or max_priority is wrong")
    for key in (*METRIC_KEYS, "final_return") + (("alpha",) if cfg.sac else ()) + (
            ("beta", "max_priority") if cfg.prioritized else ()):
        if not math.isfinite(summary[key]):
            raise AssertionError(f"main path {name}: {key} = {summary[key]} is not finite")
    return launches


# The ingest before this port's default one: the queue, inline pageable
# inserts, no scheduler.
OLD_PIPELINE = ["--transport=queue", "--ingest_async=false", "--transfer_scheduler=false"]
OLD_ENV_STEPS = 2000       # each kernel-route path on it (a few chunks)
STEADY_ENV_STEPS = 20_000  # the main paths whose rates are recorded
# The scan route on it: its 4 x 32-row queue brings in ~130-220 env steps
# a ~3-5 s chunk, so 1-2 chunks.
OLD_SCAN_ENV_STEPS = 1200


def ms_a_chunk(summary: dict) -> float:
    """A main path's wall time a chunk after its warmup (its learner steps
    over its learner steps/s, over its chunks)."""
    return 1000.0 * summary["learner_steps"] / summary["learner_steps_per_sec"] \
        / summary["chunks"]


def before_after(card: str, path: str, default_run: dict, old_flags, name: str) -> None:
    """A main path on the old pipeline (`old_flags` + OLD_PIPELINE, through
    drive_main_path, which checks the queue and the inline ingest), printed
    beside `default_run`, the same path's summary on the default pipeline:
    each with its rates, its wall time a chunk and the driver's ingest time
    a chunk."""
    old = {}
    drive_main_path(old_flags + OLD_PIPELINE, name, old)
    for kind, s in (("default", default_run), ("old", old)):
        log(f"[ingest] {card}: {path} main path, {kind} pipeline: learner steps/s "
            f"{s['learner_steps_per_sec']}, env steps/s {s['env_steps_per_sec']}, "
            f"{ms_a_chunk(s):.2f} ms a chunk over {s['chunks']} chunks ({s['env_steps']} env "
            f"steps), the card idle between chunks {s['gap_median_ms']} ms median, the "
            f"driver's ingest {s['t_ingest_chunk_ms']:.3f} ms a chunk, longest call "
            f"{s['t_ingest_run_max']:.3f} ms")


def time_branch(cfg, name: str, k: int, step: int, card: str, eager: bool,
                split: bool = True) -> dict:
    """The kernel's time at the main path's shapes (Pendulum, K = k) beside
    its plain version and its bound, then (with `split`) its breakdown.
    Returns the timing fields of the kernel's record."""
    from distributed_ddpg_tpu_torch.learner import make_learner_step, train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.types import unpack_batch

    obs, act, b = 3, 1, cfg.batch_size
    state = train_state_from_numpy(random_state_np(cfg, obs, act, seed=7, step=step), "cuda")
    packed = random_batches(seed=8, k=k, b=b, obs=obs, act=act)
    eps = noise_for(cfg, k, b, act, step)
    run = fc.make_fused_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=k, device="cuda")
    kernel_ms = time_ms(lambda: run(state, packed, eps), reps=10)
    # The plain version: one run of K python-driven steps (seconds), whose
    # first call pays nothing a second would not, so no warm-up run; the
    # parity phase's run at these shapes where it made one.
    plain_ms = PLAIN_MS.get((cfg, obs, act, k, step, 2.0))
    if plain_ms is None:
        plain_ms = time_ms(
            lambda: fc.fused_chunk_reference(cfg, state, packed, 2.0, 0.0, eps), reps=1,
            warmup=False)
    context = ""
    if eager:
        step_fn, eager_steps = make_learner_step(cfg, 2.0), min(50, k)

        def eager_run():
            s = state
            for i in range(eager_steps):
                s = step_fn(s, unpack_batch(packed[i], obs, act)).state

        context = f"; eager autograd step x K {time_ms(eager_run, reps=1) * k / eager_steps:.3f} ms (context)"
    # The bound counts this run's work: the actor's backward, its Adam and
    # the Polyak updates only on the chunk's update steps.
    ops = fc.ops_per_chunk(cfg, obs, act, k, step)
    nbytes = (2 * fc.state_bytes(cfg, obs, act) + packed.numel() * 4
              + numel(eps) * 4 + k * b * 4 + 6 * 4
              + (4 * cfg.num_atoms if cfg.distributional else 0))   # the C51 support
    bound_ops_ms, bound_bytes_ms = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    if cfg.compute_dtype == "bfloat16":
        # The products that take bf16 operands at the tensor cores' peak;
        # the rest (bias gradients, row tasks, optimizer) at the f32 peak.
        rounded = fc.rounded_product_ops(cfg, obs, act, k, step)
        bound_ops_ms = (rounded / PEAK_BF16_FLOPS + (ops - rounded) / PEAK_F32_FLOPS) * 1e3
        context += f"; {rounded / 1e9:.2f} GFLOP of it bf16 products"
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    if cfg.distributional:   # the kernel's A x A projection, beyond what the bound counts
        context += (f"; the kernel's triangular projection does "
                    f"{fc.C51_PAIR_OPS * cfg.num_atoms ** 2 * b * k / 1e9:.2f} GFLOP "
                    f"a chunk, not in the bound")
    log(f"[timing] {card}: {name} K={k} from step {step}: {kernel_ms:.3f} ms/chunk = "
        f"{kernel_ms * 1e3 / k:.2f} us/step; plain {plain_ms:.3f} ms{context}; bound "
        f"{bound_ms:.4f} ms = {bound_ms * 1e3 / k:.3f} us/step ({ops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    if split:
        breakdown(run, state, packed, eps, k)
    return {
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
    }


# --- the mesh phase: two data-parallel ranks over gloo on the one card ------

MESH_RANKS = 2
MESH_TIMEOUT_S = 800      # the whole phase with 3c, both ranks
MESH_K = 16               # the mesh launch's checks (the existing K = 16 rule)
MESH_SUPPORT = (-4.0, 4.0)   # a C51 support far too narrow for Pendulum's returns
MESH_SUPPORT_K = 200      # learner steps a chunk of the forced expansion
MESH_SUPPORT_CHUNKS = 12  # chunks the expansion may take to fire
# README's whole D4PG command with PER at D = 2 takes the scan route: a scan
# chunk of 800 eager steps holds each rank's host ~9 s while the actor
# fills its 4096-row shm ring, so 5000 env steps are 1-2 chunks past the
# 1000-row warmup.
MESH_PER_ENV_STEPS = 5000


def mesh_phase(card: str) -> dict:
    """Starts MESH_RANKS processes of this script (`--mesh-rank`), each one
    rank of a gloo group on the one card, and waits for them; any rank that
    fails fails the phase at once (the other is stopped). Returns rank 0's
    record of the phase (its times and its main paths' summaries)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as out_dir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(r), out_dir, card])
                 for r in range(MESH_RANKS)]
        deadline = time.monotonic() + MESH_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        if codes != [0] * MESH_RANKS:
            raise AssertionError(f"mesh phase: the ranks exited with {codes}")
        with open(os.path.join(out_dir, "rank0.json")) as f:
            return json.load(f)


def mesh_kernel_check(cfg, group, say, obs: int = 17, act: int = 6, k: int = MESH_K,
                      step: int = 1000) -> float:
    """The mesh launch against its plain version: each rank runs the chunk
    kernel on its own draws (idx from a generator seeded by its rank, the
    noise with its rank folded in) through ShardedLearner.run_sample_chunk,
    which averages the state and metrics and gathers td over the group;
    the plain version runs the same rank's chunk on the CPU from the same
    state, rows and noise, and the CPU results are averaged (and td
    gathered) over the same group. Held under the f32 rule of the K = 16
    checks (compare_outputs); then every rank's state against rank 0's,
    bit for bit. Returns the largest absolute difference."""
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import (
        ShardedLearner,
        float_leaves,
        state_tensors,
    )
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    b = cfg.batch_size
    name = ("fused_chunk_d4pg" if cfg.distributional else "fused_chunk_td3"
            if cfg.twin_critic else "fused_chunk_sac" if cfg.sac else "fused_chunk") + (
        "_bf16" if cfg.compute_dtype == "bfloat16" else "")
    label = f"mesh launch {name} D={group.world_size} obs={obs} act={act} K={k} B={b} a rank"
    state_np = random_state_np(cfg, obs, act, seed=obs, step=step)
    rep = DeviceReplay(4096, obs, act, "cuda", block_size=1024)
    rep.add_packed(random_batches(seed=200 + obs, k=1, b=4096, obs=obs, act=act)[0].cpu().numpy())
    learner = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=k, group=group,
                             state=train_state_from_numpy(state_np, "cuda"))
    if not learner.fused_mesh_active:
        raise AssertionError(f"{label}: the mesh launch is not the route")
    gen = torch.Generator(device="cuda").manual_seed(300 + group.rank)
    idx = torch.randint(0, 4096, (k, b), generator=gen, device="cuda")
    eps = None
    if cfg.sac or cfg.takes_noise:
        draw = fc.sac_noise_eps if cfg.sac else fc.td3_noise_eps
        eps = draw(cfg, gen, step, k, b, act, device_fold=group.rank)
    fc.KERNEL_LAUNCHES.clear()
    out = learner.run_sample_chunk(rep, idx=idx, eps=eps)
    torch.cuda.synchronize()
    if dict(fc.KERNEL_LAUNCHES) != {name: 1}:
        raise AssertionError(f"{label}: launches {dict(fc.KERNEL_LAUNCHES)}")
    cpu = tree_map_tensors(torch.Tensor.cpu, eps)
    ref, rtd, rmet = fc.fused_chunk_reference(cfg, train_state_from_numpy(state_np, "cpu"),
                                              rep.storage[idx].cpu(), 2.0, 0.0, cpu)
    full = torch.zeros((k, learner.global_batch))
    full[:, group.rank * b:(group.rank + 1) * b] = rtd
    mesh.all_reduce_mean_(float_leaves(ref) + list(rmet.values()), group, sums=[full])
    worst, failed = compare_outputs(label, cfg, obs, act,
                                    chunk_outputs(learner.state, out.td_errors, out.metrics),
                                    chunk_outputs(ref, full, rmet))
    if failed:
        raise AssertionError(f"{label}: {', '.join(failed)} outside the tolerances")
    same = mesh.replicas_equal(state_tensors(learner.state), group)
    say(f"  {label}: the replicas' states bit-identical: {same}")
    if not same:
        raise AssertionError(f"{label}: the replicas differ")
    return worst


def mesh_per_draw(group, say) -> None:
    """The repaired PER draw on two ranks: each draws the global
    [K, B * D] from the same generator state and the same 1M priorities of
    the main path's kind (as run_sample_chunk_per does on a mesh); both
    ranks' indices and weights must be bit-identical."""
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.replay.device import draw_per_indices

    prios = torch.from_numpy(per_priorities("random", PER_CAPACITY, 31)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(30)
    idx, w = draw_per_indices(prios, PER_CAPACITY, (PER_K, PER_B * group.world_size), 0.4,
                              generator=gen)
    same = mesh.replicas_equal([idx, w], group)
    say(f"  PER draw on {group.world_size} ranks, capacity {PER_CAPACITY}, K={PER_K}, "
        f"B={PER_B * group.world_size}: the ranks' indices and weights bit-identical: {same}")
    if not same:
        raise AssertionError("PER draw: the ranks drew different indices or weights")


def mesh_timing(group, card: str, say) -> dict:
    """Device time (CUDA events) of the mesh launch's two parts at the main
    path's shapes (Pendulum, 2x256, K = 800, 64 rows a rank): K1 a rank,
    with both ranks' kernels on the card at once and with rank 0's alone,
    and the state average a chunk (one all_reduce over the float leaves,
    the metrics and the td gather) over gloo; then a whole mesh chunk,
    draw to average, on the host's clock after a synchronize. Two ranks on
    one card over gloo: not an NCCL figure."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, float_leaves
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    cfg, k, obs, act = DDPGConfig(), 800, 3, 1
    state = train_state_from_numpy(random_state_np(cfg, obs, act, seed=7), "cuda")
    learner = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=k, state=state, group=group)
    rep = DeviceReplay(PER_FILL, obs, act, "cuda", block_size=1024)
    rep.add_packed(random_batches(41, 1, PER_FILL, obs, act, weighted=False)[0].cpu().numpy())
    packed = random_batches(seed=8 + group.rank, k=k, b=cfg.batch_size, obs=obs, act=act)
    run = learner._chunk
    mesh.share([0], group)                         # both ranks start together
    both_ms = time_ms(lambda: run(state, packed, None), reps=3)
    mesh.share([0], group)
    alone_ms = time_ms(lambda: run(state, packed, None), reps=3) if group.lead else math.nan
    mesh.share([0], group)
    new, _, met = run(state, packed, None)
    floats = float_leaves(new) + list(met.values())
    td = torch.zeros((k, learner.global_batch), device="cuda")
    avg_ms = time_ms(lambda: mesh.all_reduce_mean_(floats, group, sums=[td]), reps=10)
    nbytes = sum(t.numel() for t in floats) * 4 + td.numel() * 4
    learner.run_sample_chunk(rep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        learner.run_sample_chunk(rep)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) / 3 * 1e3
    say(f"[timing] {card}: gloo, two ranks on one card, DDPG K={k} at Pendulum shapes, "
        f"64 rows a rank: K1 a rank {both_ms:.3f} ms a chunk with both ranks' kernels on the "
        f"card ({both_ms * 1e3 / k:.2f} us/step)" + (
            f", {alone_ms:.3f} ms with rank 0's alone" if group.lead else "")
        + f"; the state average {avg_ms:.3f} ms a chunk (one all_reduce, "
        f"{nbytes / 1e6:.3f} MB); a whole mesh chunk {chunk_ms:.3f} ms on the host's clock")
    return dict(k1_both_ms=both_ms, k1_alone_ms=alone_ms, average_ms=avg_ms,
                average_mb=nbytes / 1e6, mesh_chunk_ms=chunk_ms)


def mesh_support_expansion(group, say) -> dict:
    """Forces one expansion of the auto C51 support at D = 2 through the
    trainer's own check (train.expand_support, the controller's rule and
    cooldown unchanged): a D4PG learner (Pendulum, 2x256, 64 rows a rank)
    starts from MESH_SUPPORT, far too narrow for Pendulum's returns, on a
    replay of Pendulum transitions from a uniform-random policy that rank 0
    steps and shares as the trainer's ingest does; the check runs after
    every chunk (the trainer's cadence is 50 chunks) until it fires. Then
    both ranks must hold the same, wider bounds, and the next chunk must
    run on them: its mean_q lies below the old v_min, which the old support
    could not express, and the replicas stay bit-identical."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.envs import make, spec_of
    from distributed_ddpg_tpu_torch.ops import support_auto
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
    from distributed_ddpg_tpu_torch.train import expand_support
    from distributed_ddpg_tpu_torch.types import pack_batch_np

    cfg = DDPGConfig(distributional=True, v_min=MESH_SUPPORT[0], v_max=MESH_SUPPORT[1])
    env = make(cfg.env_id, seed=5)
    spec = spec_of(env)
    rows = None
    if group.lead:
        rng = np.random.default_rng(5)
        fields = {k: [] for k in ("obs", "action", "reward", "discount", "next_obs")}
        obs, _ = env.reset(seed=5)
        for _ in range(8192):
            a = rng.uniform(spec.action_low, spec.action_high).astype(np.float32)
            nxt, r, term, trunc, _ = env.step(a)
            for key, v in zip(fields, (obs, a, r, 0.0 if term else cfg.gamma, nxt)):
                fields[key].append(v)
            obs = env.reset()[0] if term or trunc else nxt
        rows = pack_batch_np({k: np.asarray(v, np.float32) for k, v in fields.items()})
    rows = mesh.share_rows(rows, 2 * spec.obs_dim + spec.act_dim + 3, group)
    rep = DeviceReplay(65536, spec.obs_dim, spec.act_dim, "cuda", block_size=1024)
    rep.add_packed(rows)
    learner = ShardedLearner(cfg, spec.obs_dim, spec.act_dim, spec.action_scale,
                             spec.action_offset, chunk_size=MESH_SUPPORT_K, group=group)
    controller = support_auto.SupportController()

    def data_bounds():
        return support_auto.replay_data_bounds(rep, cfg.gamma, cfg.n_step)

    grown, steps = None, 0
    for chunk in range(1, MESH_SUPPORT_CHUNKS + 1):
        out = learner.run_sample_chunk(rep)
        steps += MESH_SUPPORT_K
        grown = expand_support(learner, controller, out, steps, data_bounds, group)
        if grown is not None:
            break
    if grown is None:
        raise AssertionError(f"support expansion: no expansion in {MESH_SUPPORT_CHUNKS} chunks")
    bounds = torch.tensor([learner.config.v_min, learner.config.v_max], device="cuda")
    same = mesh.replicas_equal([bounds], group)
    out = learner.run_sample_chunk(rep)
    mean_q = float(out.metrics["mean_q"])
    replicas = mesh.replicas_equal(state_tensors(learner.state), group)
    say(f"  support expansion at D={group.world_size}: {MESH_SUPPORT} -> "
        f"[{grown['v_min']}, {grown['v_max']}] after chunk {chunk} (mean_q {grown['mean_q']:.4f}, "
        f"refusals {controller.refusals}); the ranks' bounds bit-identical: {same}; the next "
        f"chunk's mean_q {mean_q:.4f}; the replicas bit-identical: {replicas}")
    if not (same and replicas and grown["v_min"] < MESH_SUPPORT[0]
            and grown["v_max"] >= MESH_SUPPORT[1] and math.isfinite(mean_q)
            and mean_q < MESH_SUPPORT[0]):
        raise AssertionError("support expansion: the ranks' bounds differ, did not widen, or "
                             "the next chunk did not run on them")
    return dict(start=list(MESH_SUPPORT), grown=[grown["v_min"], grown["v_max"]],
                chunk=chunk, mean_q_after=mean_q)


def mesh_main_path(flags, group, say, route: str) -> dict:
    """One run of train() at D = 2 (the CLI's parser, `--data_axis=2`) in
    this rank's group, with the launch counts zeroed just before and read
    just after: on the mesh launch every chunk is one launch of the DDPG
    kernel on each rank; on the scan route no chunk kernel launches. The
    record's route, global_batch and replicas (bit-identical states, and
    priorities under PER) are checked."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.train import train

    cfg = DDPGConfig.from_flags(flags + [f"--data_axis={group.world_size}"])
    fc.KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    summary = train(cfg, echo=False, group=group)
    launches = dict(fc.KERNEL_LAUNCHES)
    keys = ("route", "global_batch", "chunks", "learner_steps", "learner_steps_per_sec",
            "env_steps", "env_steps_per_sec", "replicas_identical", "final_return")
    say(f"[mesh path {route}] {time.monotonic() - t0:.1f}s, launches {launches}: "
        + json.dumps({k: summary[k] for k in keys}
                     | {k: summary[k] for k in ("v_min", "v_max", "beta", "max_priority",
                                                "transport", "ingest_async_active",
                                                "t_ingest_chunk_ms", "t_ingest_run_max",
                                                "ingest_coalesce_mean", "ingest_stall_ms",
                                                "transfer_pool_fence_waits")
                        if k in summary}))
    want = {"fused_chunk": summary["chunks"]} if route == "mesh" else {}
    # Rank 0's actors on shm; every rank ships inline (no shipper at D > 1).
    if summary["transport"] != ("shm" if group.lead else None) or summary["ingest_async_active"]:
        raise AssertionError(f"mesh path {route}: transport {summary['transport']}, shipper "
                             f"{summary['ingest_async_active']}")
    if (summary["route"] != route or launches != want or summary["chunks"] < 1
            or summary["global_batch"] != cfg.batch_size * group.world_size
            or summary["learner_steps"] != summary["chunks"] * resolve_learner_chunk(cfg)
            or summary["replicas_identical"] is not True):
        raise AssertionError(f"mesh path {route}: {summary}, launches {launches}")
    for key in METRIC_KEYS:
        if not math.isfinite(summary[key]):
            raise AssertionError(f"mesh path {route}: {key} = {summary[key]}")
    return {k: summary[k] for k in keys if k in summary}


SHARD_RING_ROWS = 262_144   # the sharded ring check's capacity (and 1/4 more rows: a wrap)
SHARD_K = 50                 # the sharded chunk checks' and main paths' learner chunk
SHARD_ENV_STEPS = 3000       # the sharded main path at D = 2 (a few chunks past the warmup)
SHARD_INGEST_RATIO = 8       # its --max_ingest_ratio: 5 chunks of SHARD_K to the budget


def _logical(local, group):
    """A sharded ring's (or priority vector's) slots gathered over the group
    in logical order: logical p is rank p % D's slot p // D."""
    from distributed_ddpg_tpu_torch.parallel import mesh

    stacked = mesh.all_gather(local.contiguous(), group)
    return stacked.transpose(0, 1).reshape(-1, *local.shape[1:])


def _sha(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def mesh_sharded(group, card: str, say) -> dict:
    """The sharded replay on the two ranks (module docstring, 3b): the ring
    against the replicated one, the storage bytes, a uniform and a PER
    chunk on the scan route with K2 bit for bit the replicated ones, then
    the sharded main path. The chunks' K2 launches are checks, not the
    main path's: the count is zeroed before the main path."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, draw_per_indices

    obs, act, cap = 3, 1, SHARD_RING_ROWS
    width = 2 * obs + act + 3
    rows = random_batches(seed=61, k=1, b=cap + cap // 4, obs=obs, act=act,
                          weighted=False)[0].cpu().numpy()
    reps, alloc = {}, {}
    for mode in ("replicated", "sharded"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        rep = DevicePrioritizedReplay(cap, obs, act, "cuda", block_size=1024,
                                      replay_sharding=mode, group=group)
        torch.cuda.synchronize()
        alloc[mode] = torch.cuda.memory_allocated() - before
        for lo in range(0, len(rows), 10_000):
            rep.add_packed(rows[lo:lo + 10_000])
        rep.flush()
        rep.drain_pending()
        reps[mode] = rep
    rr, sr = reps["replicated"], reps["sharded"]
    ring_same = (_sha(_logical(sr.storage, group)) == _sha(rr.storage)
                 and _sha(_logical(sr.priorities, group)) == _sha(rr.priorities)
                 and (sr.ptr, sr.size) == (rr.ptr, rr.size))
    want_bytes = {m: cap * (width + 1) * 4 // d for m, d in
                  (("replicated", 1), ("sharded", group.world_size))}
    bytes_ok = all(abs(alloc[m] - want_bytes[m]) <= 1024 for m in alloc)
    say(f"  sharded ring on {group.world_size} ranks, capacity {cap}, {len(rows)} rows "
        f"(a wrap): sha256 of the logical ring and priorities equal to the replicated "
        f"ring's: {ring_same}; bytes on the card (torch.cuda.memory_allocated, storage and "
        f"priorities) {alloc['sharded']} sharded, {alloc['replicated']} replicated, against "
        f"{want_bytes['sharded']} and {want_bytes['replicated']}")
    if not (ring_same and bytes_ok):
        raise AssertionError(f"sharded ring: the same ring {ring_same}, bytes {alloc}")

    base = DDPGConfig(fused_update=True)
    checks = {}
    for per in (False, True):
        got = {}
        if per:
            gen = torch.Generator(device="cuda").manual_seed(62)
            idx, w = draw_per_indices(rr.priorities, rr.size,
                                      (SHARD_K, base.batch_size * group.world_size), 0.5,
                                      generator=gen)
        for mode in ("replicated", "sharded"):
            cfg = base.replace(replay_sharding=mode, prioritized=per)
            lrn = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=SHARD_K, group=group)
            KERNEL_LAUNCHES.clear()
            out = (lrn.run_sample_chunk_per(reps[mode], 0.5, idx=idx, weights=w) if per
                   else lrn.run_sample_chunk(reps[mode]))
            torch.cuda.synchronize()
            got[mode] = dict(state=state_tensors(lrn.state), td=out.td_errors,
                             launches=dict(KERNEL_LAUNCHES), route=lrn.route(per=per))
            if per:
                prios = _logical(reps[mode].priorities, group) if mode == "sharded" \
                    else reps[mode].priorities
                got[mode]["prios"] = _sha(prios)
                got[mode]["maxp"] = float(reps[mode].max_priority)
        a, b = got["replicated"], got["sharded"]
        same = (all(torch.equal(x, y) for x, y in zip(a["state"], b["state"]))
                and torch.equal(a["td"], b["td"])
                and all(g["launches"] == {"fused_update": 2 * SHARD_K} for g in (a, b))
                and a["route"] == b["route"] == "scan"
                and (not per or (a["prios"] == b["prios"] and a["maxp"] == b["maxp"])))
        name = "PER" if per else "uniform"
        checks[name] = same
        say(f"  sharded {name} chunk, scan route with K2, K={SHARD_K}, 2x256, "
            f"{base.batch_size} rows a rank: every state tensor and td"
            + (", the gathered priorities and max_priority" if per else "")
            + f" bit for bit the replicated chunk's: {same} (K2 launches {b['launches']})")
        if not same:
            raise AssertionError(f"sharded {name} chunk differs from the replicated one")

    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.train import train

    flags = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0", "--eval_episodes=1",
             f"--total_env_steps={SHARD_ENV_STEPS}", f"--learner_chunk={SHARD_K}",
             # Paced: a few chunks, not one chunk after a long warmup.
             f"--max_ingest_ratio={SHARD_INGEST_RATIO}",
             "--replay_sharding=sharded", "--fused_update=true",
             f"--data_axis={group.world_size}"]
    cfg = DDPGConfig.from_flags(flags)
    KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    summary = train(cfg, echo=False, group=group)
    launches = dict(KERNEL_LAUNCHES)
    keys = ("route", "global_batch", "chunks", "learner_steps", "learner_steps_per_sec",
            "env_steps", "env_steps_per_sec", "replicas_identical", "replay_shard_count",
            "replay_device_storage_bytes", "replay_shard_fill_min", "replay_shard_fill_max",
            "replay_ingest_bytes_per_row")
    path = {k: summary[k] for k in keys}
    say(f"[mesh path sharded] {card}: {time.monotonic() - t0:.1f}s, launches {launches}: "
        + json.dumps(path))
    if (summary["route"] != "scan" or summary["chunks"] < 1
            or launches != {"fused_update": 2 * summary["learner_steps"]}
            or summary["learner_steps"] != summary["chunks"] * resolve_learner_chunk(cfg)
            or summary["replicas_identical"] is not True
            or summary["replay_shard_count"] != group.world_size
            or summary["replay_device_storage_bytes"]
            != cfg.replay_capacity * width * 4 // group.world_size):
        raise AssertionError(f"sharded main path: {summary}, launches {launches}")
    return dict(ring_same=ring_same, bytes=alloc, checks=checks,
                path=dict(path, launches=launches["fused_update"]))


# --- 3c. tensor parallelism (tp_phase): model_axis = 2 on the mesh ranks ---

TP_K = 50                # the TP chunk checks' and main paths' learner chunk
TP_ENV_STEPS = 3000      # the TP main paths (a few chunks past the warmup)
TP_INGEST_RATIO = 8      # their --max_ingest_ratio: a few chunks of TP_K to the budget
TP_2X2_RANKS = 4         # (c): D = 2 x M = 2 through the CLI (torchrun, gloo, one card)
TP_2X2_TIMEOUT_S = 420   # (c) from its start to its end, beside the two ranks' checks
# (a)'s tolerances: tests/test_torch_mesh.py's (rtol, atol), D4PG's wider.
TP_TOL = {False: (2e-5, 1e-6), True: (2e-4, 1e-5)}


def _tp_flat(state, td, metrics) -> dict:
    """A chunk's outputs by piece: each state field's leaves flat, td and
    each metric."""
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, state_items

    out = {}
    for path, t in state_items(state):
        if t.is_floating_point():
            field = path.split("/")[0]
            out.setdefault(field, []).append(t.detach().reshape(-1).double().cpu())
    out = {k: torch.cat(v).numpy() for k, v in out.items()}
    out["td"] = td.detach().double().cpu().numpy().reshape(-1)
    for n in METRIC_KEYS:
        out[n] = np.array([float(metrics[n])])
    return out


def tp_chunk_check(cfg, group, obs: int, act: int, per: bool, say) -> dict:
    """(a): one chunk of TP_K steps on the scan route with K2 at
    model_axis = 2 (the two mesh ranks: D = 1 x M = 2) against the port's
    M = 1 chunk on the card, from one random state, on the same rows and
    draws (under PER the same indices and weights, and each its own copy
    of the replay's priorities). The logical end state, td, the metrics
    (and the priorities and max priority) within TP_TOL; an output outside
    is refereed by the same M = 1 chunk in float64 (the stock update:
    K2 is f32), under SHARE_RATIO and DRIFT_RATIO against the M = 1 f32
    chunk's own miss. K2 must have launched twice a step and no chunk
    kernel at all; the replicated leaves bit-identical across the model
    group (replicas_equal with the shards marked)."""
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import (
        ShardedLearner,
        make_scan_chunk_fn,
        state_tensors,
    )
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay

    k, b, fam = TP_K, cfg.batch_size, "d4pg" if cfg.distributional else "ddpg"
    label = (f"TP chunk {fam}{' PER' if per else ''} K2 D=1 M={group.world_size} "
             f"obs={obs} act={act} K={k} B={b}")
    state_np = random_state_np(cfg, obs, act, seed=obs, step=1000)
    rows = random_batches(seed=400 + obs, k=1, b=4096, obs=obs, act=act)[0].cpu().numpy()
    cls = DevicePrioritizedReplay if per else DeviceReplay
    reps = []
    for _ in range(2):
        rep = cls(4096, obs, act, "cuda", block_size=1024)
        rep.add_packed(rows)
        if per:
            g = torch.Generator(device="cuda").manual_seed(401)
            rep.set_per_state(torch.rand(4096, generator=g, device="cuda") + 0.5,
                              torch.tensor(1.5, device="cuda"))
        reps.append(rep)
    gen = torch.Generator(device="cuda").manual_seed(402 + obs)
    idx = torch.randint(0, 4096, (k, b), generator=gen, device="cuda")
    w = torch.rand((k, b), generator=gen, device="cuda") * 0.5 + 0.5
    outs = {}
    for m, rep in zip((group.world_size, 1), reps):
        c = cfg.replace(model_axis=m)
        lrn = ShardedLearner(c, obs, act, 2.0, 0.0, chunk_size=k,
                             group=group if m > 1 else None,
                             state=train_state_from_numpy(state_np, "cuda"))
        KERNEL_LAUNCHES.clear()
        t0 = time.perf_counter()
        out = (lrn.run_sample_chunk_per(rep, 0.5, idx=idx, weights=w) if per
               else lrn.run_sample_chunk(rep, idx=idx))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(KERNEL_LAUNCHES)
        if launches != {"fused_update": 2 * k} or lrn.route(per=per) != "scan":
            raise AssertionError(f"{label} M={m}: route {lrn.route(per=per)}, launches "
                                 f"{launches}")
        outs[m] = dict(lrn=lrn, flat=_tp_flat(lrn.logical_state(), out.td_errors, out.metrics),
                       secs=secs)
        if per:
            outs[m]["flat"]["priorities"] = rep.priorities.double().cpu().numpy()
            outs[m]["flat"]["max_priority"] = np.array([float(rep.max_priority)])
    tp = outs[group.world_size]["lrn"]
    replicas = mesh.replicas_equal(state_tensors(tp.state), tp.group, sharded=tp.state_sharded())
    rtol, atol = TP_TOL[bool(cfg.distributional)]
    got, want = outs[group.world_size]["flat"], outs[1]["flat"]
    worst, failed = 0.0, []
    for name in want:
        err = np.abs(got[name] - want[name])
        worst = max(worst, float(err.max()))
        if not np.all(err <= atol + rtol * np.abs(want[name])):
            failed.append(name)
    if failed:
        # The referee: the M = 1 chunk in float64 on the card (stock update).
        c64 = cfg.replace(fused_update=False)
        run = make_scan_chunk_fn(c64, obs, act, 2.0, 0.0, chunk_size=k)
        packed = reps[1].storage[idx].double().clone() if not per else None
        if per:
            packed = torch.from_numpy(rows).cuda()[idx].double()
            packed[..., -1] = w.double()
        s64 = to_double(train_state_from_numpy(state_np, "cuda"))
        new, td64, met64 = run(s64, packed, None, 1000)
        exact = _tp_flat(new, td64, met64)
        if per:
            from distributed_ddpg_tpu_torch.replay.device import scatter_last_wins

            g = torch.Generator(device="cuda").manual_seed(401)
            prios = (torch.rand(4096, generator=g, device="cuda") + 0.5).double()
            new_p = (td64.abs() + reps[1].eps) ** reps[1].alpha
            scatter_last_wins(prios, idx.reshape(-1), new_p.reshape(-1))
            exact["priorities"] = prios.cpu().numpy()
            exact["max_priority"] = np.array([max(1.5, float(new_p.max()))])
        bad = []
        for name in failed:
            if name not in exact:
                bad.append(name)
                continue
            tight = TIGHT_TOL["atol"] + TIGHT_TOL["rtol"] * np.abs(exact[name])
            e_t, e_1 = np.abs(got[name] - exact[name]), np.abs(want[name] - exact[name])
            share_t, share_1 = float((e_t > tight).mean()), float((e_1 > tight).mean())
            ok = (share_t <= SHARE_RATIO * share_1 + TIGHT_FRAC
                  and bool(np.all(e_t <= DRIFT_RATIO * float(e_1.max()) + tight)))
            say(f"  {label} {name} against the float64 M=1 chunk: TP max {e_t.max():.3e} "
                f"({share_t:.2e} outside TIGHT_TOL), M=1 f32 max {e_1.max():.3e} "
                f"({share_1:.2e})" + ("" if ok else " -- fails SHARE_RATIO or DRIFT_RATIO"))
            if not ok:
                bad.append(name)
        if bad:
            raise AssertionError(f"{label}: {', '.join(bad)} outside rtol {rtol} atol {atol} "
                                 "and the float64 referee")
    say(f"  {label}: the logical end state, td, metrics"
        + (", priorities and max_priority" if per else "")
        + f" against the M=1 chunk on the card: max_abs_err={worst:.3e} (rtol {rtol}, atol "
        f"{atol}{'; refereed: ' + ', '.join(failed) if failed else ''}); K2 launches "
        f"{2 * k} each; the replicated leaves bit-identical across the model group: "
        f"{replicas}; {outs[group.world_size]['secs'] * 1e3:.1f} ms the TP chunk, "
        f"{outs[1]['secs'] * 1e3:.1f} ms the M=1 chunk (host clock, first call)")
    if not replicas:
        raise AssertionError(f"{label}: the replicas differ")
    return dict(max_abs_err=worst, refereed=failed, tp_chunk_ms=outs[group.world_size]["secs"]
                * 1e3, m1_chunk_ms=outs[1]["secs"] * 1e3)


def tp_update_check(group, say) -> dict:
    """(b): K2 on a rank's shards at the bench's shape (2x256, obs 17, act
    6): the critic's and the actor's shard trees of one random state, 3
    steps with the same gradients, one launch a call, against the plain
    version on the same shards (largest gap in ULP printed, 0 expected)
    and against the logical update's slice (shard_tree of K2 on the whole
    tree): bit for bit. The plain version runs on the card, as
    check_fused_update's does."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_update as fu
    from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
    from distributed_ddpg_tpu_torch.ops.optim import tree_leaves
    from distributed_ddpg_tpu_torch.parallel import partition

    m, r = group.world_size, group.rank
    cfg = DDPGConfig()
    logical = train_state_from_numpy(random_state_np(cfg, 17, 6, seed=21), "cuda")
    specs = partition.state_pspec(logical, m)
    rng = np.random.default_rng(22)
    out, ulps, worst = {}, 0, 0.0
    for net in ("critic", "actor"):
        p, o, t = (getattr(logical, f"{net}_params"), getattr(logical, f"{net}_opt"),
                   getattr(logical, f"target_{net}_params"))
        spec = getattr(specs, f"{net}_params")
        grads = [tuple({k: torch.from_numpy((1e-2 * rng.standard_normal(tuple(v.shape))
                                             ).astype(np.float32)).cuda()
                        for k, v in layer.items()} for layer in p) for _ in range(3)]

        def cut(tree):
            return partition.shard_tree(tree, spec, r, m)

        sp, so, st = cut(p), o._replace(mu=cut(o.mu), nu=cut(o.nu)), cut(t)
        rp, ro, rt = sp, so, st
        lp, lo, lt = p, o, t
        shards = sum(x.numel() for x in tree_leaves(sp))
        for i in range(3):
            g = cut(grads[i])
            before = KERNEL_LAUNCHES["fused_update"]
            sp, so, st = fu.fused_adam_polyak(sp, g, so, st, 1e-3, 0.05)
            if KERNEL_LAUNCHES["fused_update"] - before != 1:
                raise AssertionError(f"K2 on {net} shards: "
                                     f"{KERNEL_LAUNCHES['fused_update'] - before} launches a call")
            rp, ro, rt = fu.fused_adam_polyak_reference(rp, g, ro, rt, 1e-3, 0.05)
            lp, lo, lt = fu.fused_adam_polyak(lp, grads[i], lo, lt, 1e-3, 0.05)
        torch.cuda.synchronize()
        same = True
        for name, got, plain, whole in (("params", sp, rp, lp), ("mu", so.mu, ro.mu, lo.mu),
                                        ("nu", so.nu, ro.nu, lo.nu), ("targets", st, rt, lt)):
            a = torch.cat([x.reshape(-1) for x in tree_leaves(got)]).cpu().numpy()
            b = torch.cat([x.reshape(-1) for x in tree_leaves(plain)]).cpu().numpy()
            s = torch.cat([x.reshape(-1) for x in tree_leaves(cut(whole))]).cpu().numpy()
            err = np.abs(a.astype(np.float64) - b)
            worst, ulps = max(worst, float(err.max())), max(ulps, ulp_gap(a, b))
            if not np.all(err <= 1e-7 + 1e-6 * np.abs(b.astype(np.float64))):
                raise AssertionError(f"K2 on {net} shards: {name} outside rtol 1e-6, atol 1e-7 "
                                     f"of the plain version (max_abs_err {err.max():.3e})")
            same = same and a.tobytes() == s.tobytes()
        if not same or int(so.count) != int(o.count) + 3:
            raise AssertionError(f"K2 on {net} shards: not the logical update's slice bit for "
                                 f"bit ({same}), count {int(so.count)}")
        out[net] = shards
        say(f"  K2 on rank {r}'s {net} shards ({shards} elements of "
            f"{sum(x.numel() for x in tree_leaves(p))}), 3 steps, one launch a call: "
            f"bit for bit the logical update's slice: {same}")
    say(f"  K2 on shards against the plain version: max_abs_err={worst:.3e}, largest gap "
        f"{ulps} ulp")
    return dict(max_abs_err=worst, ulp=ulps, shard_elements=out)


def tp_checkpoint(group, out_dir: str, say) -> dict:
    """(d): a random state (TD3, the bench's shape) saved at M = 1 by rank
    0, restored on both ranks at M = 2 (each rank's shards the logical
    blocks), gathered and saved again by rank 0, restored at M = 1: the
    sha256 of the logical state the same at every stage."""
    import hashlib

    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import (
        train_state_from_numpy,
        train_state_to_flat,
    )
    from distributed_ddpg_tpu_torch.parallel import mesh
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

    def sha(state) -> str:
        h = hashlib.sha256()
        for path, a in sorted(train_state_to_flat(state).items()):
            h.update(path.encode())
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    cfg = DDPGConfig(twin_critic=True, policy_delay=2, target_noise=0.2)
    logical = train_state_from_numpy(random_state_np(cfg, 17, 6, seed=23), "cuda")
    src, dst = os.path.join(out_dir, "tp_ckpt_m1"), os.path.join(out_dir, "tp_ckpt_m2")
    if group.lead:
        ckpt_lib.save(src, 9, logical, config=cfg)
    mesh.share([0], group)
    lrn = ShardedLearner(cfg.replace(model_axis=group.world_size), 17, 6, 2.0, 0.0,
                         group=group)
    restored, step, _ = ckpt_lib.restore(src, lrn.state_template(), device=lrn.device)
    lrn.load_state(restored)
    gathered = lrn.logical_state()
    if group.lead:
        ckpt_lib.save(dst, step, gathered, config=cfg)
    mesh.share([0], group)
    back, step2, _ = ckpt_lib.restore(dst, logical)
    shas = dict(saved=sha(logical), at_m2=sha(gathered), back_at_m1=sha(back))
    ok = len(set(shas.values())) == 1 and step == step2 == 9
    say(f"  checkpoint across model_axis (TD3, obs 17, act 6): saved at M=1, restored at "
        f"M={group.world_size}, gathered and saved, restored at M=1: sha256 "
        f"{shas['saved'][:16]}... at every stage: {ok}")
    if not ok:
        raise AssertionError(f"checkpoint across model_axis: {shas}, steps {step} {step2}")
    return dict(sha256=shas["saved"], same=ok)


def tp_memory(group, say) -> dict:
    """A rank's learner on the card (torch.cuda.memory_allocated across its
    construction; DDPG with K2, 2x256, obs 17, act 6): at M = 1 (one rank,
    the whole state) and at M = M_mesh (its shards and the logical actor
    it gathers for the actors). The second must be below the first."""
    import gc

    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors

    cfg = DDPGConfig(fused_update=True, seed=29)
    alloc, held = {}, {}
    for m, g in ((1, None), (group.world_size, group)):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        lrn = ShardedLearner(cfg.replace(model_axis=m), 17, 6, 2.0, 0.0, group=g)
        torch.cuda.synchronize()
        alloc[m] = torch.cuda.memory_allocated() - before
        held[m] = sum(t.numel() * t.element_size() for t in state_tensors(lrn.state))
        del lrn
    m = group.world_size
    say(f"  a rank's learner on the card (torch.cuda.memory_allocated across its "
        f"construction): {alloc[1]} bytes at M=1, {alloc[m]} at M={m}; its state tensors "
        f"{held[1]} and {held[m]} bytes")
    if not alloc[m] < alloc[1]:
        raise AssertionError(f"a rank's learner at M={m} holds {alloc[m]} bytes, not below "
                             f"M=1's {alloc[1]}")
    return dict(alloc_bytes={str(k): v for k, v in alloc.items()},
                state_bytes={str(k): v for k, v in held.items()})


def tp_main_path(group, card: str, say) -> dict:
    """The TP main path through train() at D = 1 x M = 2 (the CLI's parser,
    --model_axis=2 --fused_update=true, Pendulum 2x256, TP_K steps a chunk,
    paced by --max_ingest_ratio=TP_INGEST_RATIO): the launch counts zeroed
    just before and read just after: K2 twice a learner step and no chunk
    kernel; the replicas bit-identical; the mesh_* fields."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.train import train

    flags = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0", "--eval_episodes=1",
             f"--total_env_steps={TP_ENV_STEPS}", f"--learner_chunk={TP_K}",
             f"--max_ingest_ratio={TP_INGEST_RATIO}", "--fused_update=true",
             f"--model_axis={group.world_size}"]
    cfg = DDPGConfig.from_flags(flags)
    KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    summary = train(cfg, echo=False, group=group)
    launches = dict(KERNEL_LAUNCHES)
    keys = ("route", "data_axis", "global_batch", "chunks", "learner_steps",
            "learner_steps_per_sec", "env_steps", "env_steps_per_sec", "replicas_identical",
            "mesh_data_axis", "mesh_model_axis", "mesh_param_bytes_per_device",
            "mesh_param_bytes_total")
    path = {k: summary[k] for k in keys}
    say(f"[tp path D=1 M={group.world_size}] {card}: {time.monotonic() - t0:.1f}s, launches "
        f"{launches}: " + json.dumps(path))
    if (summary["route"] != "scan" or summary["chunks"] < 1
            or launches != {"fused_update": 2 * summary["learner_steps"]}
            or summary["learner_steps"] != summary["chunks"] * resolve_learner_chunk(cfg)
            or summary["replicas_identical"] is not True
            or summary["mesh_model_axis"] != group.world_size
            or not summary["mesh_param_bytes_per_device"] < summary["mesh_param_bytes_total"]
            or not all(math.isfinite(summary[k]) for k in METRIC_KEYS)):
        raise AssertionError(f"TP main path: {summary}, launches {launches}")
    return dict(path, launches=launches["fused_update"], seconds=time.monotonic() - t0)


TP_2X2_FLAGS = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
                "--eval_episodes=1", f"--total_env_steps={TP_ENV_STEPS}",
                f"--learner_chunk={TP_K}", f"--max_ingest_ratio={TP_INGEST_RATIO}",
                "--fused_update=true", "--replay_sharding=sharded", "--data_axis=2",
                "--model_axis=2"]


class TPLaunches:
    """(c) and (e), started beside the two ranks' checks and finished after
    them: (c) D = 2 x M = 2 through the CLI, `torchrun --nproc_per_node=4`
    of this script's `--tp-child` (train.main with the launch counts read
    at its end) under DDPG_DIST_BACKEND=gloo on the one card, with
    TP_2X2_FLAGS; (e) `python -m distributed_ddpg_tpu_torch.train
    --model_axis=2 --fused_chunk=on`, which must exit with the config's
    message."""

    def __init__(self, out_dir: str):
        self.log_path = os.path.join(out_dir, "tp2x2.jsonl")
        self.reports = os.path.join(out_dir, "tp2x2_launches")
        self.out = open(os.path.join(out_dir, "tp2x2.out"), "w+")
        env = dict(os.environ, DDPG_DIST_BACKEND="gloo", TP_CHILD_REPORT=self.reports)
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             f"--nproc_per_node={TP_2X2_RANKS}", f"--master_port={free_port()}",
             os.path.abspath(__file__), "--tp-child", *TP_2X2_FLAGS,
             f"--log_path={self.log_path}"],
            stdout=self.out, stderr=subprocess.STDOUT, env=env)
        self.refusal = subprocess.Popen(
            [sys.executable, "-m", "distributed_ddpg_tpu_torch.train", "--model_axis=2",
             "--fused_chunk=on"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(self, card: str, say) -> dict:
        try:
            _, err = self.refusal.communicate(timeout=120)
            rc = self.proc.wait(timeout=max(1.0, TP_2X2_TIMEOUT_S
                                            - (time.monotonic() - self.t0)))
        finally:
            self.stop()
        secs = time.monotonic() - self.t0
        want = ("model_axis > 1 shards the param tensors the Pallas megakernel needs "
                "VMEM-whole — incompatible with fused_chunk='on'")
        refused = self.refusal.returncode != 0 and want in err
        say(f"  (e) --model_axis=2 --fused_chunk=on: exit {self.refusal.returncode}, the "
            f"config's message: {refused}")
        if not refused:
            raise AssertionError(f"(e) the refusal: exit {self.refusal.returncode}, "
                                 f"{err[-1500:]}")
        self.out.seek(0)
        text = self.out.read()
        children = []
        for r in range(TP_2X2_RANKS):
            path = f"{self.reports}.rank{r}.json"
            if os.path.exists(path):
                with open(path) as f:
                    children.append(json.load(f))
        if rc != 0 or len(children) != TP_2X2_RANKS:
            raise AssertionError(f"(c) D=2 x M=2 through the CLI: exit {rc}, "
                                 f"{len(children)} rank reports:\n{text[-4000:]}")
        with open(self.log_path) as f:
            final = [json.loads(line) for line in f if line.strip()][-1]
        mesh_keys = ("mesh_data_axis", "mesh_model_axis", "mesh_param_bytes_per_device",
                     "mesh_param_bytes_total")
        rec = {k: final[k] for k in mesh_keys + ("route", "learner_steps", "chunks",
                                                   "learner_steps_per_sec", "env_steps_per_sec",
                                                   "replicas_identical", "replay_shard_count")}
        steps = final["learner_steps"]
        ok = (final["kind"] == "final" and final["replicas_identical"] is True
              and final["mesh_data_axis"] == 2 and final["mesh_model_axis"] == 2
              and final["mesh_param_bytes_per_device"] < final["mesh_param_bytes_total"]
              and final["route"] == "scan" and final["replay_shard_count"] == 2
              and all(c["launches"] == {"fused_update": 2 * steps} for c in children))
        say(f"[tp path D=2 M=2 CLI] {card}: exit {rc} in {secs:.1f}s (gloo, four ranks on one "
            f"card), launches a rank {[c['launches'] for c in children]}: " + json.dumps(rec))
        if not ok:
            raise AssertionError(f"(c) D=2 x M=2: {final}, children {children}")
        return dict(rec, launches=children[0]["launches"]["fused_update"], seconds=secs)

    def stop(self) -> None:
        for p in (self.proc, self.refusal):
            if p.poll() is None:
                p.kill()
            p.wait()


def tp_child(flags) -> int:
    """One rank of (c) under torchrun (`--tp-child`): train.main on the
    flags with TF32 off and the launch counts zeroed just before; writes
    {"rank": r, "launches": {...}} after it to $TP_CHILD_REPORT.rank<r>.json
    (a file a rank: the ranks share one stdout)."""
    from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
    from distributed_ddpg_tpu_torch.train import main as train_main

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    KERNEL_LAUNCHES.clear()
    train_main(flags)
    rank = int(os.environ.get("RANK", "0"))
    with open(f"{os.environ['TP_CHILD_REPORT']}.rank{rank}.json", "w") as f:
        json.dump({"rank": rank, "launches": dict(KERNEL_LAUNCHES)}, f)
    return 0


def tp_phase(group, out_dir: str, card: str, say) -> dict:
    """3c (module docstring) on the mesh phase's two ranks at D = 1 x
    M = 2, (c) and (e) beside them on rank 0's side."""
    t0 = time.monotonic()
    launches = TPLaunches(out_dir) if group.lead else None
    try:
        from distributed_ddpg_tpu_torch.config import DDPGConfig

        record = {"chunks": {}}
        d4pg = DDPGConfig(distributional=True, v_min=-10.0, v_max=10.0, fused_update=True,
                          prioritized=True)
        for obs, act in ((17, 6), (3, 1)):
            record["chunks"][f"ddpg_{obs}_{act}"] = tp_chunk_check(
                DDPGConfig(fused_update=True), group, obs, act, False, say)
            record["chunks"][f"d4pg_per_{obs}_{act}"] = tp_chunk_check(
                d4pg, group, obs, act, True, say)
        record["k2_on_shards"] = tp_update_check(group, say)
        record["checkpoint"] = tp_checkpoint(group, out_dir, say)
        record["memory"] = tp_memory(group, say)
        record["path"] = tp_main_path(group, card, say)
        if launches is not None:
            record["cli_2x2"] = launches.finish(card, say)
    finally:
        if launches is not None:
            launches.stop()
    record["seconds"] = time.monotonic() - t0
    say(f"[tp] {card}: the TP phase took {record['seconds']:.1f}s; learner steps/s a rank "
        f"{record['path']['learner_steps_per_sec']} at D=1 M=2"
        + (f", {record['cli_2x2']['learner_steps_per_sec']} at D=2 M=2 (CLI)"
           if "cli_2x2" in record else "")
        + " -- gloo ranks time-slicing one card (NCCL refuses two ranks on one device)")
    return record


def mesh_rank(rank: int, out_dir: str, card: str) -> int:
    """One rank of the mesh phase (see mesh_phase): joins the gloo group on
    the card; holds the mesh launch against its plain version for DDPG,
    TD3, D4PG and SAC in f32 and DDPG in bf16 (K = 16, the bench's shape,
    64 rows a rank), the ranks' PER draws against each other, times the
    mesh launch's parts, forces one support expansion, then drives two
    main paths through train() at D = 2: DDPG on the mesh launch (5000 env
    steps) and README's whole D4PG command with --prioritized=true, which
    takes the scan route on a mesh (MESH_PER_ENV_STEPS). Rank 0 writes its
    record to out_dir/rank0.json."""
    import torch.distributed as dist

    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.mesh import init_data_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = init_data_group("gloo", "cuda",
                            init_method="file://" + os.path.join(out_dir, "rendezvous"),
                            rank=rank, world_size=MESH_RANKS, timeout_s=300.0)

    def say(*args):
        log(f"[mesh r{rank}]", *args)

    t0 = time.monotonic()
    record = {"errs": {}}
    mesh_per_draw(group, say)
    cfg = DDPGConfig()
    for name, c in (("fused_chunk", cfg),
                    ("fused_chunk_td3", cfg.replace(twin_critic=True, policy_delay=2,
                                                    target_noise=0.2)),
                    ("fused_chunk_d4pg", cfg.replace(distributional=True, v_min=-10.0,
                                                     v_max=10.0)),
                    ("fused_chunk_sac", cfg.replace(sac=True, actor_lr=3e-4, critic_lr=3e-4,
                                                    tau=0.005)),
                    ("fused_chunk_bf16", cfg.replace(compute_dtype="bfloat16"))):
        record["errs"][name] = mesh_kernel_check(c, group, say)
    say(f"[phase] mesh checks done at {time.monotonic() - t0:.1f}s")
    record["timing"] = mesh_timing(group, card, say)
    record["expansion"] = mesh_support_expansion(group, say)
    common = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
              "--eval_episodes=2"]
    record["paths"] = {
        "mesh": mesh_main_path(common + ["--total_env_steps=5000"], group, say, "mesh"),
        "scan": mesh_main_path(
            common + [f"--total_env_steps={MESH_PER_ENV_STEPS}", "--distributional=true",
                      "--n_step=5", "--v_min=auto", "--v_max=auto", "--prioritized=true"],
            group, say, "scan"),
    }
    record["sharded"] = mesh_sharded(group, card, say)
    say(f"[phase] mesh phase without TP done at {time.monotonic() - t0:.1f}s")
    record["tp"] = tp_phase(group, out_dir, card, say)
    say(f"[phase] mesh phase done at {time.monotonic() - t0:.1f}s")
    if group.lead:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(record, f)
    dist.destroy_process_group()
    return 0


RESUME_K = 800             # (a): the main path's chunk
RESUME_SCAN_K = 50        # (b): the scan route with K2, a check of the path
CADENCE_ENV_STEPS = 3000   # the DDPG main path with a save every chunk
RESUME_BETA = 0.5
RESUME_WAIT_S = 240       # (c): a drill child's time to its first record, or to its end
RESUME_MORE_ENV_STEPS = 3000


def check_resume_chunk(cfg, k: int, card: str) -> dict:
    """Checkpoint and resume at the learner's level: README's whole D4PG
    command (PER, the auto support sized from the replay's rewards) at
    Pendulum shapes, K = k, the replay at the main path's capacity (1M
    rows, full, Pendulum's 5-step returns, priorities of the main path's
    kind). Two chunks on the learner's own draws, then a save through the
    trainer's AsyncSaver (its snapshot and its write timed apart); a third
    chunk on draws fixed here; then a fresh learner and replay, restore
    and load_state (timed), the same third chunk. The restored state,
    priorities, max_priority, rows and bounds must equal the saved ones
    bit for bit, and the two third chunks must end in the same bits
    (state, td, priorities, max_priority): every input is the same. The
    third chunks' launches are counted: on the kernel route one K1 launch
    each, on the scan route with fused_update two K2 launches a step."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib
    from distributed_ddpg_tpu_torch.learner import train_state_to_flat
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.ops import support_auto
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, draw_per_indices

    obs, act = 3, 1

    def build():
        learner = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=k)
        rep = DevicePrioritizedReplay(PER_CAPACITY, obs, act, "cuda", block_size=1024,
                                      alpha=cfg.per_alpha, eps=cfg.per_eps)
        return learner, rep

    learner, rep = build()
    rep.add_packed(random_batches(21, 1, PER_CAPACITY, obs, act, rewards=(-81.5, 0.0, 0.99 ** 5),
                                  weighted=False)[0].cpu().numpy())
    rep.flush()   # the ring full and wrapped
    prios = torch.from_numpy(per_priorities("random", PER_CAPACITY, 22)).cuda()
    rep.set_per_state(prios, prios.max())
    learner.set_value_bounds(*support_auto.replay_data_bounds(rep, cfg.gamma, cfg.n_step))
    for _ in range(2):
        learner.run_sample_chunk_per(rep, RESUME_BETA)
    torch.cuda.synchronize()
    saved = train_state_to_flat(learner.state)
    saved_rows, saved_prios = rep.storage.clone(), rep.priorities.clone()
    saved_max = rep.max_priority.clone()
    bounds = (learner.config.v_min, learner.config.v_max)
    name = "fused_update" if cfg.fused_update else "fused_chunk_d4pg"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        saver = ckpt_lib.AsyncSaver()
        t0 = time.perf_counter()
        if not saver.save_async(d, learner._step, learner.state, rep, cfg, env_steps=12345,
                                v_bounds=bounds):
            raise AssertionError("resume: the saver skipped the save")
        t1 = time.perf_counter()
        saver.wait()
        t2 = time.perf_counter()
        step_dir = os.path.join(d, f"step_{learner._step}")
        size = sum(os.path.getsize(os.path.join(step_dir, n)) for n in os.listdir(step_dir))
        if ckpt_lib.verify_checkpoint(d, learner._step) != (True, "ok"):
            raise AssertionError("resume: the checkpoint does not verify")
        gen = torch.Generator(device="cuda").manual_seed(23)
        idx, weights = draw_per_indices(rep.priorities, len(rep), (k, cfg.batch_size),
                                        RESUME_BETA, generator=gen)
        fc.KERNEL_LAUNCHES.clear()
        out = learner.run_sample_chunk_per(rep, RESUME_BETA, idx=idx, weights=weights)
        want = [t.clone() for t in state_tensors(learner.state)
                + [out.td_errors, rep.priorities, rep.max_priority]]
        fresh, frep = build()
        meta = {}
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        state, step, env_steps = ckpt_lib.restore(d, fresh.state, frep, config=cfg,
                                                  meta_out=meta)
        fresh.load_state(state)
        fresh.set_value_bounds(*meta["v_bounds"])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        got_flat = train_state_to_flat(fresh.state)
        same = (set(got_flat) == set(saved) and all(
            got_flat[p].dtype == saved[p].dtype and np.array_equal(got_flat[p], saved[p])
            for p in saved))
        if not (same and torch.equal(frep.storage, saved_rows)
                and torch.equal(frep.priorities, saved_prios)
                and torch.equal(frep.max_priority, saved_max)
                and (fresh.config.v_min, fresh.config.v_max) == bounds
                and (step, env_steps, fresh._step, frep.ptr, len(frep))
                == (learner._step - k, 12345, learner._step - k, rep.ptr, len(rep))):
            raise AssertionError(f"resume ({name}): the restored state, replay or bounds "
                                 "differ from the saved ones")
        out = fresh.run_sample_chunk_per(frep, RESUME_BETA, idx=idx, weights=weights)
        got = state_tensors(fresh.state) + [out.td_errors, frep.priorities, frep.max_priority]
        launches = dict(fc.KERNEL_LAUNCHES)
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    gap = max((float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)),
              default=0.0)
    want_launches = {name: 2 * (2 * k if cfg.fused_update else 1)}
    record = dict(route=fresh.route(per=True), k=k, snapshot_ms=1e3 * (t1 - t0),
                  write_ms=1e3 * (t2 - t1), restore_ms=1e3 * (t4 - t3), ckpt_bytes=size,
                  bounds=list(bounds), launches=launches, identical=not differ,
                  max_abs_gap=gap)
    log(f"[resume] {name}, {card}: " + json.dumps(record))
    if launches != want_launches:
        raise AssertionError(f"resume ({name}): launches {launches} != {want_launches}")
    if differ:
        raise AssertionError(f"resume ({name}): the resumed chunk differs from the "
                             f"uninterrupted one in tensors {differ} (largest gap {gap})")
    return record


def resume_drill(card: str) -> dict:
    """The trainer's CLI on the card, preempted and resumed, each run a
    child process of this script (`--resume-drill`, train.main) that
    prints its kernels' launch counts: the DDPG defaults with
    --checkpoint_dir and --checkpoint_every=800 (a save every chunk); after
    its first `train` record and two cadence checkpoints, SIGTERM. It must
    exit 75, say "emergency checkpoint" on stderr, leave a checkpoint that
    verifies at its last learner step, and record emergency_ckpt 1. Then
    the same command with RESUME_MORE_ENV_STEPS more env steps: it must
    say "resumed from DIR at learner step S", end at learner_steps = S +
    chunks x 800 with resumed_from S, and every chunk must have been one
    K1 launch."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib

    with tempfile.TemporaryDirectory(prefix="chip_smoke_drill_") as tmp:
        d = os.path.join(tmp, "ckpt")
        common = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
                  "--eval_episodes=1", f"--checkpoint_dir={d}", "--checkpoint_every=800"]

        def start(flags, tag):
            paths = [os.path.join(tmp, f"{tag}.{x}") for x in ("out", "err", "jsonl")]
            with open(paths[0], "w") as out, open(paths[1], "w") as err:
                proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--resume-drill", *common,
                     *flags, f"--log_path={paths[2]}"], stdout=out, stderr=err)
            return proc, paths[:2], paths[2]

        def finish(proc, files, log_path, tag):
            try:
                proc.wait(timeout=RESUME_WAIT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            out, err = (open(path).read() for path in files)
            with open(log_path) as f:
                records = [json.loads(line) for line in f]
            launches = json.loads(out.split("[launches] ")[-1].splitlines()[0])
            log(f"[resume drill {tag}] exit {proc.returncode}, launches {launches}, final "
                + json.dumps({k: records[-1].get(k) for k in (
                    "step", "learner_steps", "chunks", "emergency_ckpt", "ckpt_skipped",
                    "resumed_from", "learner_steps_per_sec", "env_steps_per_sec")}))
            return proc.returncode, out, err, records[-1], launches

        t0 = time.monotonic()
        proc, files, log_path = start(["--total_env_steps=100000000"], "preempted")
        deadline = time.monotonic() + RESUME_WAIT_S
        while time.monotonic() < deadline and proc.poll() is None:
            if (os.path.exists(log_path) and '"kind": "train"' in open(log_path).read()
                    and len(ckpt_lib.valid_steps(d)) >= 2):
                break
            time.sleep(0.2)
        if proc.poll() is not None:
            raise AssertionError(f"resume drill: the trainer exited {proc.returncode} "
                                 "before SIGTERM")
        proc.send_signal(signal.SIGTERM)
        code, _, err, final, launches = finish(proc, files, log_path, "preempted")
        step = ckpt_lib.latest_step(d)
        if not (code == 75 and "emergency checkpoint" in err and final["emergency_ckpt"] == 1
                and step == final["learner_steps"]
                and ckpt_lib.verify_checkpoint(d, step) == (True, "ok")
                and launches == {"fused_chunk": final["chunks"]}):
            raise AssertionError(f"resume drill: preemption gave exit {code}, checkpoint "
                                 f"step {step}, final {final}; stderr: {err[-2000:]}")
        t1 = time.monotonic()
        proc, files, log_path = start(
            [f"--total_env_steps={final['step'] + RESUME_MORE_ENV_STEPS}"], "resumed")
        code, out, err, final2, launches = finish(proc, files, log_path, "resumed")
        if not (code == 0 and f"resumed from {d} at learner step {step}," in out
                and final2["resumed_from"] == step and final2["chunks"] >= 1
                and final2["learner_steps"] == step + 800 * final2["chunks"]
                and launches == {"fused_chunk": final2["chunks"]}):
            raise AssertionError(f"resume drill: the resumed run gave exit {code}, final "
                                 f"{final2}, launches {launches}; stderr: {err[-2000:]}")
        t2 = time.monotonic()
    record = dict(preempted_at=step, resumed_chunks=final2["chunks"],
                  preempted_run_s=t1 - t0, resumed_run_s=t2 - t1)
    log(f"[resume drill] {card}: " + json.dumps(record))
    return record


def resume_drill_child(argv) -> int:
    """One run of the trainer's CLI (train.main) in this process for
    resume_drill; prints the chunk kernels' launch counts on a line of
    their own, then exits with main()'s code."""
    from distributed_ddpg_tpu_torch import train
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    code = 0
    try:
        train.main(argv)
    except SystemExit as e:
        code = e.code
    print("[launches] " + json.dumps(dict(fc.KERNEL_LAUNCHES)), flush=True)
    return code


# --- environments and guardrails ------------------------------------------------

MC_ACTORS = 4              # the MountainCar main path's actor processes
MC_ENV_STEPS = 20_000
GUARD_K = 16               # the guarded chunk's checks on the card
GUARD_ENV_STEPS = 5000    # the guarded main path (1-2 chunks); with PER 2500 (1)
GUARD_INJECT = {"grad": (3,), "loss": (9,)}   # numeric:grad:nan@3, numeric:loss:spike@9
DRILL_K = 100              # the drills' learner chunk (the widths stay 2x256)
DRILL_TIMEOUT_S = 300


class IngestTally:
    """For the `with` block: the rows each actor slot delivered
    (ActorPool.drain_batches), the rows and terminal rows (discount 0)
    staged into the replay (DeviceReplay.add_packed) and the ships and
    coalesced ships (k > 1 blocks, IngestStats.record_ship). The patched
    methods call the real ones with the same arguments."""

    def __enter__(self):
        from distributed_ddpg_tpu_torch.actors.pool import ActorPool
        from distributed_ddpg_tpu_torch.metrics import IngestStats
        from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

        self.by_actor, self.rows, self.terminal, self.ships, self.coalesced = {}, 0, 0, 0, 0
        self._saved = [(cls, name, getattr(cls, name)) for cls, name in (
            (ActorPool, "drain_batches"), (DeviceReplay, "add_packed"),
            (IngestStats, "record_ship"))]
        drain, add, ship = (fn for _, _, fn in self._saved)
        tally = self

        def drain_batches(pool, max_rows=None, with_sources=False):
            pairs = drain(pool, max_rows=max_rows, with_sources=True)
            for wid, batch in pairs:
                tally.by_actor[wid] = tally.by_actor.get(wid, 0) + len(batch["reward"])
            return pairs if with_sources else [batch for _, batch in pairs]

        def add_packed(rep, block, source=-1):
            tally.rows += len(block)
            tally.terminal += int((block[:, rep.obs_dim + rep.act_dim + 1] == 0).sum())
            return add(rep, block, source=source)

        def record_ship(stats, rows, blocks, ship_s=0.0):
            tally.ships += 1
            tally.coalesced += int(blocks > 1)
            return ship(stats, rows, blocks, ship_s)

        ActorPool.drain_batches = drain_batches
        DeviceReplay.add_packed = add_packed
        IngestStats.record_ship = record_ship
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def mountain_car_path(card: str) -> dict:
    """The MountainCar main path: `--env_id=MountainCarContinuous-v0
    --num_actors=4` at 2x256 on the kernel route (K1 (a), every chunk one
    launch and no scan chunk: drive_main_path), MC_ENV_STEPS env steps.
    Prints the env source, the rates, K1's launches, the terminal rows
    ingested (not a check: early exploration seldom reaches the goal),
    the ships and how many coalesced; fails unless all 4 actors
    delivered rows."""
    from distributed_ddpg_tpu_torch.envs import make

    env = make("MountainCarContinuous-v0")
    source = "gymnasium" if hasattr(env, "_env") else "built-in"
    summary = {}
    with IngestTally() as tally:
        launches = drive_main_path(
            ["--env_id=MountainCarContinuous-v0", f"--num_actors={MC_ACTORS}",
             "--replay_min_size=1000", "--eval_every=0", "--eval_episodes=2",
             f"--total_env_steps={MC_ENV_STEPS}"], "fused_chunk", summary)
    log(f"[mountain car] {card}: env {source}, {MC_ACTORS} actors: learner steps/s "
        f"{summary['learner_steps_per_sec']}, env steps/s {summary['env_steps_per_sec']}, "
        f"K1 launches {launches['fused_chunk']} (= chunks {summary['chunks']}), rows by actor "
        f"{dict(sorted(tally.by_actor.items()))}, terminal rows ingested {tally.terminal} of "
        f"{tally.rows}, ships {tally.ships} ({tally.coalesced} coalesced, k > 1), "
        f"ingest_coalesce_mean {summary['ingest_coalesce_mean']} (last interval), the card "
        f"busy {100.0 * summary['busy_share']:.2f}%")
    if sorted(tally.by_actor) != list(range(MC_ACTORS)) or min(tally.by_actor.values()) <= 0:
        raise AssertionError(f"mountain car: rows came from actors {tally.by_actor}, "
                             f"not all {MC_ACTORS}")
    return dict(summary, terminal_rows=tally.terminal, ships=tally.ships,
                coalesced_ships=tally.coalesced, env_source=source)


def check_guarded_chunk(card: str) -> None:
    """The guarded scan chunk on the card (Pendulum shapes, 2x256, batch 64,
    K = GUARD_K, K2 on): on healthy rows bit for bit the unguarded chunk
    (state, td, metrics), 2 K2 launches a step each; with GUARD_INJECT
    (warmup 4, so the z-scores are armed by step 9) exactly those two steps
    skipped, and state, td and metrics bit for bit the chunk with those two
    updates left out (their step counted, their td and metrics zero); then
    a chunk's rows with more than 32 non-finite ones screened on the card
    give the same count, flags and 32 indices as on the CPU."""
    from distributed_ddpg_tpu_torch import guardrails as gl
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import (METRIC_KEYS, make_learner_step,
                                                    train_state_from_numpy)
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import make_scan_chunk_fn, state_tensors
    from distributed_ddpg_tpu_torch.types import unpack_batch

    # zmax 50: far above a healthy step's z-scores early in the EWMA (~3-5),
    # far below the injected spike's.
    cfg = DDPGConfig(fused_update=True, fused_chunk="off", guardrails=True,
                     guardrail_warmup_steps=4, guardrail_zmax=50.0)
    plain_cfg = cfg.replace(guardrails=False)
    state = train_state_from_numpy(random_state_np(plain_cfg, 3, 1, seed=21), "cuda")
    packed = random_batches(seed=22, k=GUARD_K, b=cfg.batch_size, obs=3, act=1)
    pre_bad, count, _ = gl.batch_row_health(packed, None)
    if bool(pre_bad.any()) or int(count):
        raise AssertionError("guarded chunk: the healthy rows were screened as bad")

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def outputs(state_, td, metrics):
        return state_tensors(state_) + [td] + [metrics[k] for k in METRIC_KEYS]

    fc.KERNEL_LAUNCHES.clear()
    plain = make_scan_chunk_fn(plain_cfg, 3, 1, 2.0, 0.0, chunk_size=GUARD_K)
    want = outputs(*plain(state, packed, None, 1000))
    guarded = make_scan_chunk_fn(cfg, 3, 1, 2.0, 0.0, chunk_size=GUARD_K, guard=True)
    new, g, td, met = guarded.guarded(state, gl.init_guard_state(device="cuda"), packed, None,
                                      1000, pre_bad)
    health = gl.health_vector(g).tolist()
    k2 = fc.KERNEL_LAUNCHES.get("fused_update", 0)
    if not same(outputs(new, td, met), want) or health != [GUARD_K, 0, 0, 0, 0] \
            or k2 != 4 * GUARD_K:
        raise AssertionError(f"guarded chunk on healthy rows: not the unguarded chunk's bits "
                             f"(health {health}, K2 launches {k2})")
    log(f"  guarded chunk K={GUARD_K} with K2, healthy rows: bit for bit the unguarded chunk; "
        f"health word {health}; K2 launches {k2} (2 a step, each chunk)")

    injected = make_scan_chunk_fn(cfg, 3, 1, 2.0, 0.0, chunk_size=GUARD_K, guard=True,
                                  inject=GUARD_INJECT)
    new, g, td, met = injected.guarded(state, gl.init_guard_state(device="cuda"), packed, None,
                                       1000, pre_bad)
    skip = {at for ats in GUARD_INJECT.values() for at in ats}
    step = make_learner_step(plain_cfg, 2.0, 0.0)
    s, tds, metrics = state, [], []
    for k in range(GUARD_K):
        out = step(s, unpack_batch(packed[k], 3, 1), None, step_index=1000 + k)
        if k + 1 in skip:
            s = s._replace(step=out.state.step)
            tds.append(torch.zeros_like(out.td_errors))
            metrics.extend(torch.zeros_like(out.metrics[n]) for n in METRIC_KEYS)
        else:
            s = out.state
            tds.append(out.td_errors)
            metrics.extend(out.metrics[n] for n in METRIC_KEYS)
    means = torch.stack(metrics).view(GUARD_K, len(METRIC_KEYS)).mean(dim=0)
    want = outputs(s, torch.stack(tds), dict(zip(METRIC_KEYS, means.unbind())))
    health = gl.health_vector(g).tolist()
    if not same(outputs(new, td, met), want) or health != [GUARD_K, 1, 1, 2, 0]:
        raise AssertionError(f"guarded chunk with {GUARD_INJECT}: health {health}, or not the "
                             "chunk with those updates left out")
    log(f"  guarded chunk K={GUARD_K} with {GUARD_INJECT} (warmup 4): health word {health} "
        "(total, nonfinite, spikes, skipped, bad_rows); bit for bit the chunk with steps "
        f"{sorted(skip)} left out")

    rng = np.random.default_rng(23)
    bad = packed.clone()
    ks, bs = np.nonzero(rng.random((GUARD_K, cfg.batch_size)) < 0.1)
    cols = rng.integers(0, bad.shape[-1], len(ks))
    bad[torch.from_numpy(ks), torch.from_numpy(bs), torch.from_numpy(cols)] = float("nan")
    idx = torch.from_numpy(rng.integers(0, 1_000_000, (GUARD_K, cfg.batch_size))).cuda()
    on_card = [x.cpu().tolist() for x in gl.batch_row_health(bad, idx)]
    on_cpu = [x.tolist() for x in gl.batch_row_health(bad.cpu(), idx.cpu())]
    if on_card != on_cpu or on_card[1] != len(ks) or len(ks) <= gl.GUARD_BAD_IDX:
        raise AssertionError("guarded chunk: the row screen on the card differs from the CPU")
    log(f"  row screen: {len(ks)} non-finite rows of {GUARD_K * cfg.batch_size}, the same "
        f"count, flags and {gl.GUARD_BAD_IDX} indices on the card as on the CPU")


def guard_ops_per_step(card: str, cfg) -> dict:
    """Device operations (kernel launches) and device time a scan step,
    guarded and not (K2 on), by torch.profiler over PROFILE_STEPS steps at
    the main path's shapes."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_ddpg_tpu_torch import guardrails as gl
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.parallel.learner import make_scan_chunk_fn

    c = cfg.replace(fused_update=True, fused_chunk="off", guardrails=True)
    state = train_state_from_numpy(random_state_np(c, 3, 1, seed=7), "cuda")
    packed = random_batches(seed=8, k=PROFILE_STEPS, b=c.batch_size, obs=3, act=1)
    pre_bad = torch.zeros(PROFILE_STEPS, dtype=torch.bool, device="cuda")
    run = make_scan_chunk_fn(c, 3, 1, 2.0, 0.0, chunk_size=PROFILE_STEPS, guard=True)
    chunks = {
        "unguarded": lambda: run(state, packed, None, 1000),
        "guarded": lambda: run.guarded(state, gl.init_guard_state(device="cuda"), packed,
                                       None, 1000, pre_bad),
    }
    out = {}
    for name, fn in chunks.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        out[name] = dict(
            launches=sum(e.count for e in events if e.key in LAUNCH_CALLS) / PROFILE_STEPS,
            device_us=sum(e.self_device_time_total for e in events
                          if e.device_type == torch.autograd.DeviceType.CUDA) / PROFILE_STEPS,
            host_ms=time_ms(fn, reps=1, warmup=False) / PROFILE_STEPS)
    log(f"[guardrails] {card}: scan step with K2, profiled over {PROFILE_STEPS} steps: "
        + "; ".join(f"{n} {v['launches']:.1f} kernel launches, {v['device_us']:.1f} us of "
                    f"device time, {1e3 * v['host_ms']:.1f} us a step on the host's clock"
                    for n, v in out.items()))
    return out


class HealthReads:
    """Counts ShardedLearner.poll_health calls in the `with` block."""

    def __enter__(self):
        from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

        self.n = 0
        self._fn = ShardedLearner.poll_health
        fn, tally = self._fn, self

        def poll_health(learner):
            tally.n += 1
            return fn(learner)

        ShardedLearner.poll_health = poll_health
        return self

    def __exit__(self, *exc):
        from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

        ShardedLearner.poll_health = self._fn


def guarded_main_paths(card: str) -> dict:
    """`--guardrails=true --fused_update=true` at 2x256, K = 800, for
    GUARD_ENV_STEPS env steps, and with PER for half that: the scan route, 2 K2
    launches a learner step and no K1 (drive_main_path), the health word
    read once a chunk, no non-finite step or row. Prints the rates, the
    health word (the guardrail_* counters) and K2's launches. With
    --guardrail_rollback_k=0: at the default zmax of 8 the z-score
    detector skips healthy steps of this path (13 in its second chunk on
    an H100; the JAX trainer on the CPU skipped 87 of 2400), and 8 within
    a window would roll back a run that has no checkpoint to restore
    (exit 77); rollback is the drills' subject."""
    out = {}
    for per in (False, True):
        name = "guarded" + (" PER" if per else "")
        summary = {}
        flags = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
                 "--eval_episodes=2",
                 f"--total_env_steps={GUARD_ENV_STEPS // 2 if per else GUARD_ENV_STEPS}",
                 "--guardrails=true", "--fused_update=true", "--guardrail_rollback_k=0"] + (
                     ["--prioritized=true"] if per else [])
        with HealthReads() as reads:
            launches = drive_main_path(flags, "scan", summary)
        health = {k: v for k, v in summary.items() if k.startswith("guardrail_")}
        log(f"[guardrails] {card}: {name} main path: learner steps/s "
            f"{summary['learner_steps_per_sec']}, env steps/s {summary['env_steps_per_sec']}, "
            f"{summary['chunks']} chunks, health word read {reads.n} times, K2 launches "
            f"{launches.get('fused_update')}; {json.dumps(health)}")
        if reads.n != summary["chunks"] or health["guardrail_nonfinite_steps"] \
                or health["guardrail_bad_rows"] or launches.get("fused_update", 0) <= 0:
            raise AssertionError(f"{name} main path: {reads.n} health reads for "
                                 f"{summary['chunks']} chunks, {health}, launches {launches}")
        out[name] = dict(summary, health_reads=reads.n, launches=launches)
    return out


def run_cli(flags, tag: str):
    """`python -m distributed_ddpg_tpu_torch.train` with these flags as a
    child process; returns (exit code, stdout, stderr, the final record)."""
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "distributed_ddpg_tpu_torch.train", *flags],
                         capture_output=True, text=True, timeout=DRILL_TIMEOUT_S,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    finals = [json.loads(line) for line in res.stdout.splitlines()
              if line.startswith('{"kind": "final"')]
    final = finals[-1] if finals else {}
    log(f"[drill {tag}] exit {res.returncode} in {time.monotonic() - t0:.1f}s; final "
        + json.dumps({k: final.get(k) for k in (
            "step", "learner_steps", "chunks", "final_return", "learner_steps_per_sec",
            "guardrail_anomalies", "guardrail_nonfinite_steps", "guardrail_bad_rows",
            "guardrail_rollbacks", "guardrail_last_rollback_step",
            "guardrail_source_quarantines", "actor_quarantined")}))
    for line in res.stderr.splitlines():
        if line.startswith(("[guardrail]", "[checkpoint]", "[chaos]", "[pool]")):
            log(f"  {line}")
    return res.returncode, res.stdout, res.stderr, final


def guardrail_drills(card: str) -> dict:
    """The drills through the CLI at 2x256 (K = DRILL_K, the learner and
    ingest ratios at 1 so the env steps and learner steps move together):

    The rollback and abort drills run with --guardrail_zmax=1000: they
    hold the non-finite path, and at the default zmax of 8 healthy steps
    trip the z-score detector too (guarded_main_paths), which would move
    the rollback or the abort to another chunk.

    - rollback: numeric:grad:nan at steps 1450 and 1750 (two chunks),
      guardrail_rollback_k=2 within a 1000-step window, a checkpoint every
      chunk (8 kept): exit 0 at its env budget, one rollback or more to a
      step below 1450, finite params, the checkpoints from 1500 on renamed
      diverged_step_N; the restore's ms printed;
    - abort: guardrail_max_rollbacks=0, numeric:grad:nan@500: exit 77, no
      final return, no checkpoint from the chunk of step 500 on;
    - poison: numeric:replay:inf@1500 from one of 2 actors, 4000 env steps,
      guardrail_source_offenses=1, no rollback: the poisoned actor's slot,
      and only it, quarantined."""
    from distributed_ddpg_tpu_torch import checkpoint as ckpt_lib

    common = ["--replay_min_size=1000", "--eval_every=0", "--eval_episodes=1",
              f"--learner_chunk={DRILL_K}", "--guardrails=true", "--max_learn_ratio=1.0",
              "--max_ingest_ratio=1.0"]
    record = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_guard_") as tmp:
        d = os.path.join(tmp, "rollback")
        code, _, err, final = run_cli(common + [
            "--num_actors=1", "--fused_update=true", "--total_env_steps=3000",
            f"--checkpoint_dir={d}", f"--checkpoint_every={DRILL_K}", "--checkpoint_keep=8",
            "--guardrail_rollback_k=2", "--guardrail_rollback_window=1000",
            "--guardrail_zmax=1000",
            "--faults=numeric:grad:nan@1450;numeric:grad:nan@1750"], "rollback")
        names = os.listdir(d) if os.path.isdir(d) else []
        diverged = sorted(int(n.split("_")[-1]) for n in names if n.startswith("diverged_step_"))
        restored = final.get("guardrail_last_rollback_step", -1)
        ms = [float(x) for x in re.findall(r"\) in ([0-9.]+) ms", err)]
        if not (code == 0 and final.get("guardrail_rollbacks", 0) >= 1 and 0 < restored < 1450
                and final["step"] >= 3000 and math.isfinite(final["final_return"])
                and all(math.isfinite(final[k]) for k in ("critic_loss", "actor_loss"))
                and diverged and min(diverged) >= 1500 and ms):
            raise AssertionError(f"rollback drill: exit {code}, final {final}, diverged "
                                 f"{diverged}; stderr: {err[-3000:]}")
        log(f"[drill rollback] {card}: restored step {restored}, diverged_step_N {diverged}, "
            f"restore {ms} ms")
        record["rollback"] = dict(restored=restored, diverged=diverged, restore_ms=ms)

        d = os.path.join(tmp, "abort")
        code, _, err, final = run_cli(common + [
            "--num_actors=1", "--total_env_steps=100000", f"--checkpoint_dir={d}",
            f"--checkpoint_every={DRILL_K}", "--guardrail_rollback_k=1",
            "--guardrail_max_rollbacks=0", "--guardrail_zmax=1000",
            "--faults=numeric:grad:nan@500"], "abort")
        names = os.listdir(d) if os.path.isdir(d) else []
        steps = [int(n.split("_")[1]) for n in names if n.startswith("step_")]
        if not (code == 77 and "NUMERIC ABORT" in err and final.get("final_return", 0) is None
                and steps and max(steps) < 500 <= final["learner_steps"]
                and ckpt_lib.verify_checkpoint(d, max(steps))[0]):
            raise AssertionError(f"abort drill: exit {code}, checkpoints {sorted(steps)}, final "
                                 f"{final}; stderr: {err[-3000:]}")
        record["abort"] = dict(exit=code, learner_steps=final["learner_steps"],
                               newest_checkpoint=max(steps))

    code, _, err, final = run_cli(common + [
        "--num_actors=2", "--total_env_steps=4000", "--guardrail_rollback_k=0",
        "--guardrail_source_offenses=1", "--faults=numeric:replay:inf@1500"], "poison")
    poisoned = re.search(r"poisoned ingested row 1500 \(reward=\+inf\) from actor (\d)", err)
    quarantined = re.findall(r"QUARANTINED worker (\d) \(numeric\)", err)
    if not (code == 0 and poisoned and quarantined == [poisoned.group(1)]
            and final.get("guardrail_source_quarantines", 0) >= 1
            and final.get("actor_quarantined") == 1):
        raise AssertionError(f"poison drill: exit {code}, final {final}; stderr: {err[-3000:]}")
    record["poison"] = dict(actor=int(poisoned.group(1)), bad_rows=final["guardrail_bad_rows"])
    log(f"[drills] {card}: " + json.dumps(record))
    return record


# --- the host replay path, lockstep mode and the agent ----------------------------

HOST_ENV_STEPS = 3000      # each host-replay main path (2 chunks)
PREFETCH_CHUNKS = 4        # chunks through the prefetcher a check
STRICT_ENV_STEPS = 5000    # each strict-sync run on K1 (a)
STRICT_SCAN_ENV_STEPS = 2000   # each strict-sync run on the scan route (~4 s a chunk)
AGENT_ENV_STEPS = 2000
# The wall-clock fields of a record (tests/test_strict_sync.py's list, the
# port's env_steps_per_sec and every t_* field); the rest must match.
STRICT_TIME_KEYS = ("wall_time", "learner_steps_per_sec", "actor_steps_per_sec",
                    "ingest_rows_per_sec", "ingest_stall_ms", "ingest_ship_ms",
                    "replay_exchange_ms_p50", "replay_exchange_ms_p95",
                    "env_steps_per_sec")


def host_rows(n: int, obs: int, act: int, seed: int):
    """Replay rows as the actors write them, with Pendulum's rewards
    (discount 0.99 ** 5, as README's D4PG command's 5-step returns)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, obs)).astype(np.float32),
            rng.uniform(-2, 2, (n, act)).astype(np.float32),
            rng.uniform(-81.5, 0.0, n).astype(np.float32),
            np.full(n, 0.99 ** 5, np.float32),
            rng.standard_normal((n, obs)).astype(np.float32))


def check_prefetched_chunk(cfg, obs: int, act: int, k: int, depth: int, card: str) -> dict:
    """The host replay's chunks on the card: PREFETCH_CHUNKS chunks drawn by
    a ChunkPrefetcher (depth `depth`, its puts on the transfer scheduler's
    prefetch class, as on the main path) from a PrioritizedReplay whose
    priorities vary (the IS weights in the rows), each put through
    ShardedLearner.put_chunk (pinned buffer, side-stream copy) and
    dispatched with run_chunk_async without waiting, so the next chunk's
    copy runs while a chunk runs; against the same draws from an identical
    replay through run_chunk, one chunk at a time, on a second learner
    from the same state. The indices, every chunk's td and the end state
    must be bit-identical: a chunk that read a half-copied chunk, or a
    pinned buffer reused before its copy, would differ."""
    from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.parallel.prefetch import ChunkPrefetcher
    from distributed_ddpg_tpu_torch.replay import PrioritizedReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    state = random_state_np(cfg, obs, act, seed=41)

    def learner():
        out = ShardedLearner(cfg, obs, act, 2.0, 0.0, chunk_size=k,
                             state=train_state_from_numpy(state, "cuda"))
        assert out.fused_chunk_active
        return out

    def replay():
        rep = PrioritizedReplay(50_000, obs, act, seed=7)
        rep.add_batch(*host_rows(40_000, obs, act, seed=8))
        rng = np.random.default_rng(9)
        rep.update_priorities(np.arange(0, 40_000, 3), rng.uniform(0.0, 40.0, 13_334))
        return rep

    a, b = learner(), learner()
    fc.KERNEL_LAUNCHES.clear()
    sched = TransferScheduler().start()
    prefetch = ChunkPrefetcher(replay(), a.put_chunk, cfg.batch_size, k, depth=depth,
                               scheduler=sched).start()
    got = []
    t0 = time.monotonic()
    try:
        for _ in range(PREFETCH_CHUNKS):
            device_chunk, idx = prefetch.next()
            got.append((a.run_chunk_async(device_chunk).td_errors, idx))
    finally:
        prefetch.stop()
        sched.close()
    torch.cuda.synchronize()
    prefetched_s = time.monotonic() - t0
    rb = replay()
    want = []
    for _ in range(PREFETCH_CHUNKS):
        draws = [rb.sample(cfg.batch_size) for _ in range(k)]
        chunk = {f: np.stack([d[f] for d in draws]) for f in draws[0]}
        idx = chunk.pop("indices")
        want.append((b.run_chunk(chunk).td_errors, idx))
    torch.cuda.synchronize()
    name = "fused_chunk_d4pg" if cfg.distributional else "fused_chunk"
    launches = dict(fc.KERNEL_LAUNCHES)
    if launches != {name: 2 * PREFETCH_CHUNKS}:
        raise AssertionError(f"prefetched chunk check: launches {launches}")
    for i, ((td_a, ia), (td_b, ib)) in enumerate(zip(got, want)):
        if not (np.array_equal(ia, ib) and torch.equal(td_a, td_b)):
            raise AssertionError(f"prefetched chunk {i} (depth {depth}, {name}) differs from "
                                 f"run_chunk's: max |td| gap {(td_a - td_b).abs().max()}")
    gap = (fc.flatten_state(a.state) - fc.flatten_state(b.state)).abs().max().item()
    if gap != 0.0:
        raise AssertionError(f"prefetched chunks (depth {depth}, {name}): end state {gap} "
                             "from run_chunk's")
    log(f"[host replay] {card}: {PREFETCH_CHUNKS} prefetched {name} chunks at K = {k}, "
        f"depth {depth}: bit-identical to run_chunk (td and end state), "
        f"{1000.0 * prefetched_s / PREFETCH_CHUNKS:.2f} ms a chunk with the prefetcher")
    return dict(name=name, depth=depth, ms_a_chunk=1000.0 * prefetched_s / PREFETCH_CHUNKS)


def strict_pair(flags, name: str, tmp: str, tag: str) -> dict:
    """Two strict-sync runs of one command (drive_main_path, so each is
    checked as a main path) whose records, the wall-clock fields stripped,
    must be bit-identical. Returns the first run's launch counts."""
    records, launches, summaries = [], None, []
    for i in range(2):
        path = os.path.join(tmp, f"{tag}{i}.jsonl")
        summary = {}
        got = drive_main_path(flags + [f"--log_path={path}"], name, summary)
        launches = launches or got
        summaries.append(summary)
        with open(path) as f:
            records.append([{k: v for k, v in json.loads(line).items()
                             if k not in STRICT_TIME_KEYS and not k.startswith("t_")}
                            for line in f])
    a, b = records
    if len(a) != len(b) or a != b:
        diff = next(((ra, rb) for ra, rb in zip(a, b) if ra != rb), (len(a), len(b)))
        raise AssertionError(f"strict-sync pair {tag}: the records differ: {diff}")
    if not any(r["kind"] == "train" for r in a):
        raise AssertionError(f"strict-sync pair {tag}: no train record")
    log(f"[strict sync] {tag}: two runs, {len(a)} records bit-identical once the wall-clock "
        f"fields are stripped; final learner_steps {a[-1]['learner_steps']}, chunks "
        f"{a[-1]['chunks']}, critic_loss {a[-1]['critic_loss']!r}, final_return "
        f"{a[-1]['final_return']!r}; learner steps/s {summaries[0]['learner_steps_per_sec']}, "
        f"{summaries[1]['learner_steps_per_sec']}")
    return launches


def agent_path(card: str) -> dict:
    """DDPGAgent with fused_update=True on the card (Pendulum-v1, 2x256,
    batch 64, the default 1000-row warmup) for AGENT_ENV_STEPS env steps of
    act, observe and train_step, with the launch counts zeroed before and
    read after: K2 twice a learner step and no chunk kernel; finite
    metrics and eval return. Prints the env and learner steps a second
    (the loop's host clock, one step a call)."""
    from distributed_ddpg_tpu_torch import DDPGAgent
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.envs import make, spec_of
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    cfg = DDPGConfig(fused_update=True, total_env_steps=AGENT_ENV_STEPS)
    env = make(cfg.env_id, seed=0)
    agent = DDPGAgent(cfg, spec_of(env))
    fc.KERNEL_LAUNCHES.clear()
    obs, _ = env.reset(seed=0)
    metrics, learn_steps = None, 0
    t0 = time.monotonic()
    for _ in range(AGENT_ENV_STEPS):
        action = agent.act(obs)
        next_obs, reward, terminated, truncated, _ = env.step(action)
        agent.observe(obs, action, reward, terminated, next_obs)
        m = agent.train_step()
        if m is not None:
            metrics, learn_steps = m, learn_steps + 1
        obs = next_obs
        if terminated or truncated:
            obs, _ = env.reset()
            agent.reset_episode()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = dict(fc.KERNEL_LAUNCHES)
    ret = agent.evaluate(make(cfg.env_id, seed=1), episodes=1)
    if launches != {"fused_update": 2 * learn_steps} or learn_steps < 1:
        raise AssertionError(f"agent path: launches {launches}, learner steps {learn_steps}")
    if not all(math.isfinite(metrics[k]) for k in METRIC_KEYS) or not math.isfinite(ret):
        raise AssertionError(f"agent path: metrics {metrics}, eval return {ret}")
    log(f"[agent] {card}: DDPGAgent(fused_update=True) {AGENT_ENV_STEPS} env steps, "
        f"{learn_steps} learner steps in {dt:.2f}s ({AGENT_ENV_STEPS / dt:.2f} env steps/s, "
        f"{learn_steps / dt:.2f} learner steps/s, one step a call); fused_update launches "
        f"{launches['fused_update']} = 2 x learner steps; critic_loss "
        f"{metrics['critic_loss']}, eval return {ret}")
    return launches


def host_replay_phase(card: str, common) -> dict:
    """The slice's paths (see the module docstring, 4d). Returns the launch
    counts of each path by kernel name."""
    from distributed_ddpg_tpu_torch import native
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk

    if not native.sum_tree_available():
        raise AssertionError("the native sum tree (native/replay_core.cpp) did not build: "
                             "the host PER would run on the numpy tree")
    cfg = DDPGConfig()
    d4pg = cfg.replace(distributional=True, v_min=-1500.0, v_max=150.0)
    prefetched = [check_prefetched_chunk(c, 3, 1, resolve_learner_chunk(c), depth, card)
                  for c in (cfg, d4pg) for depth in (1, 2)]
    host = ["--host_replay=true", f"--total_env_steps={HOST_ENV_STEPS}"]
    d4pg_flags = ["--distributional=true", "--n_step=5", "--v_min=auto", "--v_max=auto",
                  "--prioritized=true"]
    out = {}
    summaries = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        summaries["K1 (a)"] = {}
        out["fused_chunk"] = drive_main_path(common + host, "fused_chunk",
                                             summaries["K1 (a)"])["fused_chunk"]
        summaries["K1 (c), PER"] = {}
        out["fused_chunk_d4pg"] = drive_main_path(
            common + host + d4pg_flags + [f"--log_path={os.path.join(tmp, 'd4pg.jsonl')}"],
            "fused_chunk_d4pg", summaries["K1 (c), PER"])["fused_chunk_d4pg"]
        summaries["K2 (scan)"] = {}
        out["fused_update_host"] = drive_main_path(
            common + host + ["--fused_update=true"], "scan",
            summaries["K2 (scan)"])["fused_update"]
        strict = ["--strict_sync=true", "--max_learn_ratio=1.0", "--max_ingest_ratio=1.0"]
        out["fused_chunk_strict"] = strict_pair(
            common + strict + [f"--total_env_steps={STRICT_ENV_STEPS}"], "fused_chunk", tmp,
            "K1 (a)")["fused_chunk"]
        out["fused_update_strict"] = strict_pair(
            common + strict + [f"--total_env_steps={STRICT_SCAN_ENV_STEPS}",
                               "--fused_update=true"], "scan", tmp, "scan route with K2")[
            "fused_update"]
    out["fused_update_agent"] = agent_path(card)["fused_update"]
    for path, s in summaries.items():
        log(f"[host replay] {card}: {path} main path on the host replay: learner steps/s "
            f"{s['learner_steps_per_sec']}, env steps/s {s['env_steps_per_sec']}, "
            f"{s['chunks']} chunks, the driver's wait for a chunk {s['t_sample_wait_run_ms']:.3f} "
            f"ms a chunk, the card idle between chunks {s['gap_median_ms']} ms median"
            + (f", sum tree {s['sum_tree']}" if "sum_tree" in s else ""))
    log(f"[host replay] {card}: " + json.dumps(dict(prefetched=prefetched, launches=out)))
    return out


# --- 4e. device actors, the fused beat, the superstep, the monolith ---

DEVACTOR_ENVS = 1024      # device_actor_envs (the JAX default); K = 64 on the card
DEVACTOR_ROLLOUTS = 5     # the K1 (a) path: the warmup's rollout, then 4 chunks and rollouts
BEAT_PARITY_K = 16        # the bit-identity checks' learner chunk (the main path's is 800)
# Two free-running f32 rollouts (card, CPU; 1024 envs x 64 steps) parted by
# 3.405e-4 in both chip runs that printed it (H100 80GB HBM3, 700 W); about
# three times that fails.
FREE_RUNNING_BOUND = 1e-3
BEAT_PARITY_N = 3         # beats against the separate sequence
FUSED_BEATS = 3           # the fused beat's main path: beats after the warmup's rollout
ONDEVICE_ENV_STEPS = 2000
ONDEVICE_MC_ENV_STEPS = 1500
DEVACTOR_TIME_REPS = 5


def _pool_system(cfg, replay_cls=None):
    """A learner, a device-actor pool bound to it and a device replay on the
    card (the trainer's wiring), the replay warmed by one rollout."""
    from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, resolve_learner_chunk
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay

    pool = DeviceActorPool(cfg)
    learner = ShardedLearner(cfg, pool.obs_dim, pool.act_dim, pool.action_scale,
                             pool.action_offset, chunk_size=resolve_learner_chunk(cfg))
    pool.bind(lambda: learner.state.actor_params)
    if cfg.prioritized:
        rep = DevicePrioritizedReplay(cfg.replay_capacity, pool.obs_dim, pool.act_dim, "cuda",
                                      alpha=cfg.per_alpha, eps=cfg.per_eps)
    else:
        rep = DeviceReplay(cfg.replay_capacity, pool.obs_dim, pool.act_dim, "cuda")
    pool.run_chunk(rep)
    return cfg, learner, pool, rep


def _system_tensors(learner, pool, rep):
    from distributed_ddpg_tpu_torch.parallel.learner import state_tensors

    c = pool.carry
    out = [*state_tensors(learner.state), rep.storage, *c.env_state, c.obs, c.ou, c.ep_ret,
           c.steps, c.episodes, c.ret_sum, learner._gen.get_state(), pool._gen.get_state()]
    if hasattr(rep, "priorities"):
        out += [rep.priorities, rep.max_priority]
    return out, (rep.ptr, len(rep), c.host_steps)


def _same_system(a, b, what: str) -> None:
    (ta, ha), (tb, hb) = _system_tensors(*a[1:]), _system_tensors(*b[1:])
    bad = [i for i, (x, y) in enumerate(zip(ta, tb)) if not torch.equal(x, y)]
    if ha != hb or bad or len(ta) != len(tb):
        raise AssertionError(f"{what}: not bit-identical (host {ha} vs {hb}, tensors {bad})")


def check_rollout_against_cpu(card: str) -> float:
    """A rollout at the main path's width (1024 envs, 2x256 actor, 64
    steps) on the card against the CPU from the same params, start state
    and injected draws, one step at a time: each step's CPU reference
    starts from the card's carry after the step before, so the check holds
    the step's code at rtol 1e-5, atol 1e-5 (the JAX rollout test's
    tolerance) over all 64 steps and not the pendulum's sensitivity to
    initial conditions, which parts two free-running f32 rollouts. Each
    step's rows and its carry (every leaf: env state, observations, OU,
    episode returns and counters) are held at that tolerance. The
    free-running gap is held to FREE_RUNNING_BOUND. Returns the largest
    stepwise gap of the rows."""
    from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import init_train_state
    from distributed_ddpg_tpu_torch.ops.exploration import StepDraws, draw_step
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    steps = 64
    cfg = DDPGConfig(actor_backend="device", num_actors=0, device_actor_envs=DEVACTOR_ENVS,
                     device_actor_chunk=1)
    params = init_train_state(cfg, 3, 1, 5, "cpu").actor_params
    pools = {dev: DeviceActorPool(cfg.replace(device=dev)) for dev in ("cpu", "cuda")}
    free = DeviceActorPool(cfg.replace(device="cpu"))
    gen = torch.Generator().manual_seed(17)
    draws = [draw_step(pools["cpu"].env, 1, gen, pools["cpu"]._low, pools["cpu"]._high, False)
             for _ in range(steps)]

    def moved(carry, dev):
        env = type(carry.env_state)(*(t.to(dev) for t in carry.env_state))
        return carry._replace(env_state=env, **{f: getattr(carry, f).to(dev) for f in (
            "obs", "ou", "ep_ret", "steps", "episodes", "ret_sum")})

    pools["cuda"]._carry = moved(pools["cpu"].carry, "cuda")
    free._carry = pools["cpu"].carry
    reps = {dev: DeviceReplay(cfg.replay_capacity, 3, 1, dev) for dev in ("cpu", "cuda")}
    free_rep = DeviceReplay(cfg.replay_capacity, 3, 1, "cpu")
    for dev, pool in pools.items():
        pool.set_params(tuple({k: v.to(dev) for k, v in layer.items()} for layer in params))
    free.set_params(params)
    def leaves(carry):
        return [*carry.env_state, carry.obs, carry.ou, carry.ep_ret, carry.steps,
                carry.episodes, carry.ret_sum]

    carry_err = 0.0
    for i, d in enumerate(draws):
        if i:
            # The step's carry update on the card (OU reset where done, the
            # episode returns and counters, the env state) against the
            # CPU's, before the CPU takes the card's carry for the next step.
            for j, (a, b) in enumerate(zip(leaves(pools["cpu"].carry),
                                           leaves(pools["cuda"].carry))):
                a, b = a.numpy(), b.cpu().numpy()
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                           err_msg=f"carry leaf {j} after step {i}")
                if a.size:
                    carry_err = max(carry_err, float(np.abs(
                        a.astype(np.float64) - b.astype(np.float64)).max()))
            if pools["cpu"].carry.host_steps != pools["cuda"].carry.host_steps:
                raise AssertionError(f"host step counts part after step {i}")
        pools["cpu"]._carry = moved(pools["cuda"].carry, "cpu")
        for dev, pool in pools.items():
            pool.run_chunk(reps[dev], draws=[StepDraws(d.noise.to(dev), d.reset.to(dev))])
        free.run_chunk(free_rep, draws=[d])
    for j, (a, b) in enumerate(zip(leaves(pools["cpu"].carry), leaves(pools["cuda"].carry))):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"carry leaf {j} after the last step")
    n = DEVACTOR_ENVS * steps
    on_card = reps["cuda"].storage[:n].cpu().numpy()
    on_cpu = reps["cpu"].storage[:n].numpy()
    err = float(np.abs(on_card - on_cpu).max())
    free_err = float(np.abs(on_card - free_rep.storage[:n].numpy()).max())
    log(f"[devactor] {card}: a rollout ({DEVACTOR_ENVS} envs x {steps} steps) on the card "
        f"against the CPU from the same draws, step by step: rows max abs gap {err:.3e}, "
        f"carry (every leaf, each step) {carry_err:.3e}; free-running over all {steps} "
        f"steps: {free_err:.3e} (bound {FREE_RUNNING_BOUND:.0e})")
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-5, atol=1e-5)
    if not free_err <= FREE_RUNNING_BOUND:
        raise AssertionError(f"the free-running rollout parts from the CPU's by {free_err:.3e}, "
                             f"above its bound {FREE_RUNNING_BOUND:.0e}")
    return err


def check_stale_params(card: str) -> None:
    """A rollout after a K1 (a) chunk (K = 800) equals, bit for bit, one from
    a copy of the learner's NEW actor params, and differs from the old's."""
    from distributed_ddpg_tpu_torch.actors.device_pool import DeviceActorPool
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    cfg = DDPGConfig(actor_backend="device", num_actors=0, device_actor_envs=DEVACTOR_ENVS)
    _, learner, pool, rep = _pool_system(cfg)
    old = tuple({k: v.clone() for k, v in layer.items()} for layer in learner.state.actor_params)
    fc.KERNEL_LAUNCHES.clear()
    learner.run_sample_chunk(rep)
    if fc.KERNEL_LAUNCHES.get("fused_chunk") != 1:
        raise AssertionError(f"stale params: the chunk launched {dict(fc.KERNEL_LAUNCHES)}")
    carry, gen_state = pool.carry, pool._gen.get_state()
    rows = {}
    for name in ("bound", "new", "old"):
        pool._carry = carry
        pool._gen.set_state(gen_state)
        if name == "new":
            pool.set_params(tuple({k: v.clone() for k, v in layer.items()}
                                  for layer in learner.state.actor_params))
        elif name == "old":
            pool.set_params(old)
        else:
            pool.bind(lambda: learner.state.actor_params)
        r = DeviceReplay(cfg.replay_capacity, 3, 1, "cuda")
        pool.run_chunk(r)
        rows[name] = r.storage[:pool.rows_per_chunk].clone()
    if not torch.equal(rows["bound"], rows["new"]) or torch.equal(rows["bound"], rows["old"]):
        raise AssertionError("stale params: the rollout after a chunk did not read the new "
                             "actor params")
    log(f"[devactor] {card}: the rollout after a K1 (a) chunk equals a rollout from a copy of "
        "the new actor params bit for bit, and differs from the old params'")


def time_rollout(card: str) -> dict:
    """The rollout at the main path's width: its device time and its host
    time a dispatch (CUDA events and the host clock, warm), its launches a
    rollout step (torch.profiler), and env steps a second of device time."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    cfg = DDPGConfig(actor_backend="device", num_actors=0, device_actor_envs=DEVACTOR_ENVS)
    _, learner, pool, rep = _pool_system(cfg)
    dev_ms = time_ms(lambda: pool.run_chunk(rep), reps=DEVACTOR_TIME_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DEVACTOR_TIME_REPS):
        pool.run_chunk(rep)
    host_ms = 1000.0 * (time.perf_counter() - t0) / DEVACTOR_TIME_REPS
    torch.cuda.synchronize()
    prof_ms, launches = profiled(lambda: pool.run_chunk(rep), reps=2)
    out = dict(ms=dev_ms, host_ms=host_ms, busy_ms=prof_ms,
               launches_per_step=launches / pool.chunk_size,
               env_steps_per_s=1000.0 * pool.rows_per_chunk / dev_ms, rows=pool.rows_per_chunk)
    log(f"[devactor] {card}: a rollout of {pool.rows_per_chunk} rows ({DEVACTOR_ENVS} envs x "
        f"{pool.chunk_size} steps): {dev_ms:.3f} ms a dispatch (CUDA events), {host_ms:.3f} ms "
        f"of host enqueue, {prof_ms:.3f} ms of device busy time (profiler), "
        f"{out['launches_per_step']:.1f} launches a rollout step, "
        f"{out['env_steps_per_s']:.1f} env steps/s")
    return out


def check_beats(card: str, per: bool) -> None:
    """BEAT_PARITY_N fused beats against the separate sequence (the scan
    route's chunk with K2, then the rollout into the ring) on the card, at
    the main path's widths (1024 envs x 64 steps, 2x256, 1M ring) with the
    learner chunk cut to BEAT_PARITY_K: bit-identical."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.megastep import FusedMegastep

    cfg = DDPGConfig(actor_backend="device", num_actors=0, device_actor_envs=DEVACTOR_ENVS,
                     fused_chunk="off", fused_update=True, learner_chunk=BEAT_PARITY_K,
                     prioritized=per)
    fused, sep = _pool_system(cfg), _pool_system(cfg)
    ms = FusedMegastep(*fused)
    for n in range(BEAT_PARITY_N):
        beta = 0.4 + 0.1 * n
        ms.run_beat(beta if per else None)
        if per:
            sep[1].run_sample_chunk_per(sep[3], beta)
        else:
            sep[1].run_sample_chunk(sep[3])
        sep[2].run_chunk(sep[3])
    _same_system(fused, sep, f"the fused beat{' with PER' if per else ''}")
    log(f"[fused beat] {card}: {BEAT_PARITY_N} beats bit-identical to the separate sequence"
        + (" with PER" if per else "") + f" (K = {BEAT_PARITY_K}, 1024 envs x 64 steps)")


def check_superstep(card: str) -> int:
    """One superstep of 4 beats against 4 beats (K = BEAT_PARITY_K, uniform):
    bit-identical; then the host syncs of one superstep, counted in
    torch's sync debug mode, must be 1 (its stats' read). Returns it."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.megastep import FusedMegastep
    from distributed_ddpg_tpu_torch.parallel.superstep import FusedSuperstep

    cfg = DDPGConfig(actor_backend="device", num_actors=0, device_actor_envs=DEVACTOR_ENVS,
                     fused_chunk="off", fused_update=True, learner_chunk=BEAT_PARITY_K,
                     superstep_beats=4)
    sup, seq = _pool_system(cfg), _pool_system(cfg)
    ss, ms = FusedSuperstep(*sup), FusedMegastep(*seq)
    ss.run_superstep()
    for _ in range(4):
        ms.run_beat()
    _same_system(sup, seq, "the superstep")
    syncs = sync_calls(lambda: ss.run_superstep())
    log(f"[superstep] {card}: one superstep of 4 beats bit-identical to 4 beats; host syncs "
        f"a superstep: {syncs}")
    if syncs != 1:
        raise AssertionError(f"the superstep made {syncs} host syncs, not 1")
    return syncs


def ondevice_path(flags, name: str) -> dict:
    """`--backend=jax_ondevice` through train() with these flags, the launch
    counts zeroed before and read after: K2 twice a learner step with
    --fused_update=true, no K1; finite metrics and return."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.train import train

    cfg = DDPGConfig.from_flags(flags)
    fc.KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    summary = train(cfg, echo=False)
    launches = dict(fc.KERNEL_LAUNCHES)
    log(f"[ondevice {name}] {time.monotonic() - t0:.1f}s: " + json.dumps(summary))
    want = {"fused_update": 2 * summary["learner_steps"]} if cfg.fused_update else {}
    if launches != want or summary["learner_steps"] < 1 or summary["env_steps"] < \
            cfg.total_env_steps:
        raise AssertionError(f"ondevice {name}: launches {launches} != {want}, {summary}")
    for key in (*METRIC_KEYS, "final_return"):
        if not math.isfinite(summary[key]):
            raise AssertionError(f"ondevice {name}: {key} = {summary[key]}")
    return dict(summary, launches=launches)


def check_terminal_rows_on_card(card: str) -> None:
    """MountainCar on the monolith at 2x256: 64 envs, half of them placed at
    the goal, one chunk on the card; the terminal rows (next position >=
    0.45 with velocity >= 0) stored at discount 0 with reward > 99, the
    others at gamma."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.ondevice import OnDeviceDDPG

    cfg = DDPGConfig(backend="jax_ondevice", env_id="MountainCarContinuous-v0", num_actors=64,
                     fused_update=True)
    od = OnDeviceDDPG(cfg, chunk_size=8)
    near = torch.arange(64, device="cuda") % 2 == 0
    od.env_state = od.env_state._replace(
        pos=torch.where(near, 0.449, od.env_state.pos),
        vel=torch.where(near, 0.02, od.env_state.vel))
    od.obs = od.env.observe(od.env_state)
    od.run_chunk()
    rows = od.replay.storage[:len(od.replay)].cpu().numpy()
    disc, rew, nxt = rows[:, 4], rows[:, 3], rows[:, 5:7]
    term = (nxt[:, 0] >= 0.45) & (nxt[:, 1] >= 0.0)
    ok = (term.sum() >= 32 and np.all(disc[term] == 0.0) and np.all(rew[term] > 99.0)
          and np.allclose(disc[~term], np.float32(cfg.gamma)))
    log(f"[ondevice] {card}: MountainCar on the monolith, {int(term.sum())} terminal rows of "
        f"{len(rows)} stored at discount 0 (reward > 99), the rest at gamma: {ok}")
    if not ok:
        raise AssertionError("MountainCar's terminal rows are not stored at discount 0")


def device_actor_phase(card: str, host_actors: dict) -> dict:
    """4e (see the module docstring). `host_actors` is the DDPG main path's
    summary with a host actor process, for the comparison printed. Returns
    the launch counts of each path by kernel and path."""
    t_phase = time.monotonic()
    rows = DEVACTOR_ENVS * 64
    device = ["--actor_backend=device", "--num_actors=0",
              f"--device_actor_envs={DEVACTOR_ENVS}", "--replay_min_size=1000",
              "--eval_every=0", "--eval_episodes=2"]
    out = {}
    # K1 (a) with the device actors (the dispatch-per-phase loop: 'auto'
    # keeps the kernel route and the rollout after each chunk).
    s = {}
    out["device_actors"] = drive_main_path(
        device + [f"--total_env_steps={DEVACTOR_ROLLOUTS * rows}"], "fused_chunk", s)
    if (s["transfer_ingest_items"] != 0 or s["chunks"] < 4 or s["fused_beat_active"]
            or s["devactor_env_steps"] < DEVACTOR_ROLLOUTS * rows):
        raise AssertionError(f"device actors on K1 (a): {s}")
    log(f"[devactor] {card}: K1 (a) with {DEVACTOR_ENVS} device envs: {s['chunks']} chunks, "
        f"{s['devactor_env_steps'] // rows} rollouts of {rows} rows, learner steps/s "
        f"{s['learner_steps_per_sec']}, env steps/s {s['env_steps_per_sec']}, the card idle "
        f"between chunks {s['gap_median_ms']} ms median (max {s['gap_max_ms']}; the rollout "
        f"runs there), transfer_ingest_items {s['transfer_ingest_items']}; with one host "
        f"actor process: learner steps/s {host_actors['learner_steps_per_sec']}, env steps/s "
        f"{host_actors['env_steps_per_sec']}")
    rollout = time_rollout(card)
    err = check_rollout_against_cpu(card)
    check_stale_params(card)
    log(f"[phase] device actors done at {time.monotonic() - t_phase:.1f}s of the phase")

    # The fused beat: on the card bit for bit the separate sequence, then
    # its main path (scan route, K2) through the trainer.
    check_beats(card, per=False)
    check_beats(card, per=True)
    fused = ["--fused_chunk=off", "--fused_update=true",
             f"--total_env_steps={(FUSED_BEATS + 1) * rows}"]
    f = {}
    out["fused_beat"] = drive_main_path(device + fused, "scan", f)
    if not f["fused_beat_active"] or f["fused_beats"] != f["chunks"]:
        raise AssertionError(f"the fused beat's main path: {f}")
    log(f"[fused beat] {card}: main path {f['fused_beats']} beats of K = "
        f"{f['learner_steps'] // f['chunks']} learner steps and {rows} rows, learner steps/s "
        f"{f['learner_steps_per_sec']}, env steps/s {f['env_steps_per_sec']}, K2 launches "
        f"{out['fused_beat'].get('fused_update')}")
    syncs = check_superstep(card)
    sup = {}
    out["superstep"] = drive_main_path(
        device + ["--fused_chunk=off", "--fused_update=true", "--superstep_beats=4",
                  f"--total_env_steps={5 * rows}"], "scan", sup)
    if sup["fused_supersteps"] != 1 or sup["fused_beats"] != 4:
        raise AssertionError(f"the superstep's main path: {sup}")
    log(f"[superstep] {card}: main path 1 superstep of 4 beats, learner steps/s "
        f"{sup['learner_steps_per_sec']}, env steps/s {sup['env_steps_per_sec']}, K2 launches "
        f"{out['superstep'].get('fused_update')}, host syncs a superstep {syncs}")
    log(f"[phase] fused beat and superstep done at {time.monotonic() - t_phase:.1f}s")

    # The monolith with K2, then MountainCar on it.
    od = ondevice_path(["--backend=jax_ondevice", "--fused_update=true",
                        "--replay_min_size=1000", "--eval_every=0", "--eval_episodes=2",
                        f"--total_env_steps={ONDEVICE_ENV_STEPS}"], "Pendulum")
    out["jax_ondevice"] = od["launches"]
    check_terminal_rows_on_card(card)
    mc = ondevice_path(["--backend=jax_ondevice", "--fused_update=true",
                        "--env_id=MountainCarContinuous-v0", "--replay_min_size=1000",
                        "--eval_every=0", "--eval_episodes=1",
                        f"--total_env_steps={ONDEVICE_MC_ENV_STEPS}"], "MountainCar")
    log(f"[ondevice] {card}: Pendulum {od['env_steps']} env steps, {od['learner_steps']} "
        f"learner steps: env steps/s {od['env_steps_per_sec']}, learner steps/s "
        f"{od['learner_steps_per_sec']}, K2 launches {od['launches'].get('fused_update')}; "
        f"MountainCar learner steps/s {mc['learner_steps_per_sec']}, final return "
        f"{mc['final_return']}")

    # The device actors resumed from a checkpoint: the episodes go on. Each
    # env ends an episode every 200 of its steps (64 a rollout): 1024 by
    # the first run's end, 3072 by the resumed one's if the carry came back.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_devactor_") as tmp:
        ck = ["--checkpoint_dir=" + tmp, "--checkpoint_every=800"]
        first, second = {}, {}
        out["devactor_resume"] = drive_main_path(
            device + ck + [f"--total_env_steps={DEVACTOR_ROLLOUTS * rows}"], "fused_chunk",
            first)
        drive_main_path(device + ck + [f"--total_env_steps={2 * DEVACTOR_ROLLOUTS * rows}"],
                        "fused_chunk", second)
    log(f"[devactor] {card}: resumed from learner step {second['resumed_from']}: episodes "
        f"{first['devactor_episodes']} after the first run, {second['devactor_episodes']} "
        "after the resumed one")
    if second["resumed_from"] is None or second["devactor_episodes"] != 3 * DEVACTOR_ENVS:
        raise AssertionError(f"the resumed device actors did not continue their episodes: "
                             f"{second}")
    secs = time.monotonic() - t_phase
    log(f"[phase] 4e took {secs:.1f}s")
    return dict(launches=out, rollout=rollout, rollout_err=err, seconds=secs,
                superstep_syncs=syncs)

# --- 4f. batched policy serving (serve/) -------------------------------------

SERVE_LIMIT_S = 60        # phase 4f's budget, enforced by an alarm of its own
SERVE_ACTORS = 4
# The gated served run: 4 served actors step 189-461 env steps/s on an
# H100 (80GB HBM3, 700 W), with the host's speed, so 3000 env steps (2-3
# chunks) keep the phase inside its limit on a slow host.
SERVE_ENV_STEPS = 3000
SERVE_MIN_SIZE = 1000
# The free-running served run: each served step after the warmup waits
# behind a running chunk (~50 env steps/s), so it is kept to a couple of
# hundred such steps.
SERVE_FREE_MIN_SIZE = 500
SERVE_FREE_ENV_STEPS = 700
SERVE_ATOL = 1e-5
SERVE_BENCH_S = 2.0
FRONT_TCP_REQUESTS, FRONT_HTTP_REQUESTS = 50, 10


class PhaseLimit:
    """For the `with` block: raises TimeoutError in the main thread once
    `seconds` have passed (SIGALRM), so a phase that overruns its budget
    fails instead of eating the script's limit."""

    def __init__(self, seconds: float, name: str):
        self.seconds, self.name = seconds, name

    def __enter__(self):
        def fire(signum, frame):
            raise TimeoutError(f"{self.name} went past its {self.seconds} s limit")

        self._old = signal.signal(signal.SIGALRM, fire)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def __exit__(self, *exc):
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, self._old)


def check_serve_apply(card: str) -> dict:
    """The device apply (serve/server.py, backend 'jax') on the card through
    tools/serve_checks.py (the on-card tests' checks): at Pendulum 2x256
    (obs 3, act 1) and at the bench's shape (obs 17, act 6), DDPG and SAC's
    head rows, max_batch 32, n in (1, 7, 32), within SERVE_ATOL of the
    numpy oracle, of the same apply on the CPU and of the same rows of a
    full batch, with stale values in the pad rows' buffer; a seqlock
    refresh served from the next batch on; no synchronizing call in an
    apply. Then its own measurements: a server's build (with its warm
    apply), and the apply's kernel launches and device time a batch of 32
    (torch.profiler) and its round trip on the host."""
    from distributed_ddpg_tpu_torch.tools import serve_checks as sc

    worst = 0.0
    for obs, act in ((3, 1), (17, 6)):
        for sac in (False, True):
            t0 = time.perf_counter()
            sc.make_server(sc.layout_of(obs, act, sac), act, "cuda", sac=sac)
            build_ms = 1e3 * (time.perf_counter() - t0)
            err, same, _ = sc.check_apply(obs, act, sac, "cuda", SERVE_ATOL, seed=10 * obs + sac)
            worst = max(worst, err)
            log(f"[serve] {card}: device apply obs {obs} act {act} "
                f"{'SAC head' if sac else 'DDPG'}: built and warmed in {build_ms:.1f} ms; "
                f"n = 1, 7, 32 within {err:.3e} of the numpy oracle, the CPU apply and a full "
                f"batch's rows ({'bit-identical' if same else 'not bit-identical'} to those)")
    srv = sc.check_seqlock_refresh("cuda", SERVE_ATOL)
    syncs = sc.count_syncs(srv)
    if syncs:
        raise AssertionError(f"the serve apply made {syncs} synchronizing calls")
    full = np.random.default_rng(4).standard_normal((sc.MAX_BATCH, 3)).astype(np.float32)
    device_ms, launches = profiled(lambda: srv._compute(full), reps=20)
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        srv._compute(full)
    roundtrip_ms = 1e3 * (time.perf_counter() - t0) / reps
    log(f"[serve] {card}: seqlock refresh served from the next batch on, an odd version "
        f"skipped; no synchronizing call; one batch of 32 at Pendulum 2x256: {launches:.1f} "
        f"kernel launches, {device_ms * 1e3:.2f} us of device time, {roundtrip_ms * 1e3:.1f} us "
        "round trip on the host (pad, copy in, apply, copy out, wait on its event), learner "
        "idle")
    return dict(max_abs_err=worst, launches=launches, device_ms=device_ms,
                roundtrip_ms=roundtrip_ms)


def served_main_path(card: str, gated: bool) -> dict:
    """`--serve_actors=true --serve_backend=jax` through the CLI's parser and
    train() on K1 (a), SERVE_ACTORS actors (each chunk one K1 launch:
    drive_main_path): gated, SERVE_ENV_STEPS env steps with the learner at
    one learner step an env step (--max_learn_ratio=1), or free running
    (the command README gives), SERVE_FREE_ENV_STEPS, the chunks back to
    back once the replay holds SERVE_FREE_MIN_SIZE rows. JAX's healthy-run
    checks (tests/test_serve.py:514-559) on both: serve_requests > 0,
    serve_errors 0, serve_overloads 0, transfer_serve_items > 0,
    serve_client_fallbacks <= 8 (printed); the serve tails, the env rate
    and the ingest's stalls printed beside each other."""
    s = {}
    flags = ([f"--replay_min_size={SERVE_MIN_SIZE}", "--max_learn_ratio=1.0",
              f"--total_env_steps={SERVE_ENV_STEPS}"] if gated else
             [f"--replay_min_size={SERVE_FREE_MIN_SIZE}",
              f"--total_env_steps={SERVE_FREE_ENV_STEPS}"])
    launches = drive_main_path(
        [f"--num_actors={SERVE_ACTORS}", "--eval_every=0", "--eval_episodes=2",
         "--serve_actors=true", "--serve_backend=jax", *flags], "fused_chunk", s)
    log(f"[serve] {card}: served main path, {'gated 1:1' if gated else 'free running'} "
        f"({SERVE_ACTORS} actors, K1 (a), {s['env_steps']} env steps, warmup "
        f"{SERVE_MIN_SIZE if gated else SERVE_FREE_MIN_SIZE} rows): serve_requests "
        f"{s['serve_requests']}, serve_batches {s['serve_batches']}, serve_errors "
        f"{s['serve_errors']}, serve_overloads {s['serve_overloads']}, serve_client_fallbacks "
        f"{s['serve_client_fallbacks']}, transfer_serve_items {s['transfer_serve_items']}; "
        f"serve_p50_ms {s['serve_p50_ms']}, serve_p95_ms {s['serve_p95_ms']}, serve_max_ms "
        f"{s['serve_max_ms']}, serve_fill_mean {s['serve_fill_mean']} (the serve fields "
        f"since the last train record); {s['chunks']} chunks, K1 launches "
        f"{launches.get('fused_chunk')}, the card busy {100.0 * s['busy_share']:.2f}% from the "
        f"first chunk's start to the last's end, idle between chunks {s['gap_median_ms']} ms "
        f"median; env steps/s {s['env_steps_per_sec']}, learner steps/s "
        f"{s['learner_steps_per_sec']}; ingest_stall_ms {s.get('ingest_stall_ms')}, the "
        f"driver's longest ingest call {s['t_ingest_run_max']:.3f} ms")
    if not (s["serve_requests"] > 0 and s["serve_errors"] == 0 and s["serve_overloads"] == 0
            and s["transfer_serve_items"] > 0 and s["serve_client_fallbacks"] <= 8):
        raise AssertionError(f"the served main path is not healthy: {s}")
    return dict(s, launches=launches)


def check_front(card: str) -> dict:
    """FrontServer with device engines (Pendulum 2x256 on the card) on
    ephemeral localhost ports: FRONT_TCP_REQUESTS framed-TCP requests and
    FRONT_HTTP_REQUESTS HTTP POST /act, each answer within SERVE_ATOL of
    the device apply of a server of its own; then a candidate published,
    canaried at half the traffic (both versions serve, each request the
    apply of the version it names) and promoted (every answer then v2's)."""
    import http.client

    from distributed_ddpg_tpu_torch.serve.front import FrontClient, FrontServer

    from distributed_ddpg_tpu_torch.tools import serve_checks as sc

    layout = sc.layout_of(3, 1)
    flats = {"v1": sc.flat_params(layout, 11), "v2": sc.flat_params(layout, 12)}
    refs = {}
    for name, flat in flats.items():
        refs[name] = sc.make_server(layout, 1, "cuda")
        refs[name].refresh(flat)
    front = FrontServer(lambda: sc.make_server(layout, 1, "cuda", max_latency_s=0.005),
                        port=0, http_port=0)
    front.publish("v1", flats["v1"])
    front.start()
    obs = np.random.default_rng(5).standard_normal((200, 3)).astype(np.float32)
    err, seen = 0.0, {}

    def answered(action, version, i):
        nonlocal err
        want = refs[version]._compute(obs[i:i + 1])[0]
        err = max(err, float(np.max(np.abs(np.asarray(action, np.float32) - want))))
        seen[version] = seen.get(version, 0) + 1

    try:
        t0 = time.perf_counter()
        with FrontClient(front.port, tenant="smoke") as cli:
            for i in range(FRONT_TCP_REQUESTS):
                answered(*cli.act(obs[i], request_id=i), i)
            tcp_ms = 1e3 * (time.perf_counter() - t0) / FRONT_TCP_REQUESTS
            conn = http.client.HTTPConnection("127.0.0.1", front.http_port, timeout=10.0)
            for i in range(FRONT_TCP_REQUESTS, FRONT_TCP_REQUESTS + FRONT_HTTP_REQUESTS):
                conn.request("POST", "/act", json.dumps(
                    {"tenant": "smoke", "request_id": i, "obs": obs[i].tolist()}))
                r = conn.getresponse()
                body = json.loads(r.read())
                if r.status != 200:
                    raise AssertionError(f"front HTTP: {r.status} {body}")
                answered(body["action"], body["version"], i)
            conn.close()
            if seen != {"v1": FRONT_TCP_REQUESTS + FRONT_HTTP_REQUESTS}:
                raise AssertionError(f"front before the canary: versions {seen}")
            front.publish("v2", flats["v2"])
            front.start_canary("v2", 0.5)
            seen.clear()
            for i in range(100, 140):
                answered(*cli.act(obs[i], request_id=i), i)
            split = dict(seen)
            front.promote("v2")
            seen.clear()
            for i in range(140, 160):
                answered(*cli.act(obs[i], request_id=i), i)
        if not (split.get("v1") and split.get("v2")) or seen != {"v2": 20}:
            raise AssertionError(f"front routing: canary {split}, after the promote {seen}")
        if not err <= SERVE_ATOL:
            raise AssertionError(f"front answers {err} from the device apply")
        snap = front.snapshot()
    finally:
        front.stop()
    log(f"[front] {card}: {FRONT_TCP_REQUESTS} TCP and {FRONT_HTTP_REQUESTS} HTTP requests "
        f"on device engines within {err:.3e} of the device apply ({tcp_ms:.3f} ms a TCP round "
        f"trip, one client); canary at 0.5: {split}; after the promote every answer v2's; "
        f"front_wire_p50_ms {snap['front_wire_p50_ms']}, front_wire_p95_ms "
        f"{snap['front_wire_p95_ms']}, front_promotes {snap['front_promotes']}")
    return dict(max_abs_err=err, tcp_ms=tcp_ms, **snap)


class BackToBackChunks:
    """For the `with` block: a thread launches K1 (a) chunks at the main
    path's shapes (Pendulum 2x256, batch 64, K = 800) one after another on
    the default stream, each waited for on its own event before the next
    is launched, as the trainer's free-running loop does; `summary()`
    gives the chunks, their mean device ms and the card's busy share."""

    def __enter__(self):
        import threading

        from distributed_ddpg_tpu_torch.config import DDPGConfig
        from distributed_ddpg_tpu_torch.learner import train_state_from_numpy
        from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
        from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk

        cfg = DDPGConfig()
        k = resolve_learner_chunk(cfg)
        state = train_state_from_numpy(random_state_np(cfg, 3, 1, seed=7, step=1000), "cuda")
        packed = random_batches(seed=8, k=k, b=cfg.batch_size, obs=3, act=1)
        run = fc.make_fused_chunk_fn(cfg, 3, 1, 2.0, 0.0, chunk_size=k, device="cuda")
        run(state, packed, None)
        torch.cuda.synchronize()
        self.events, self._stop = [], threading.Event()

        def loop():
            while not self._stop.is_set():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(state, packed, None)
                end.record()
                end.synchronize()
                self.events.append((start, end))

        self._thread = threading.Thread(target=loop, daemon=True, name="k1-chunks")
        self._t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._wall_ms = 1e3 * (time.perf_counter() - self._t0)

    def summary(self) -> dict:
        ms = [a.elapsed_time(b) for a, b in self.events]
        return dict(chunks=len(ms), chunk_ms=float(np.mean(ms)) if ms else None,
                    busy_share=sum(ms) / self._wall_ms)


def serve_bench_on_card(card: str) -> dict:
    """tools/serve_bench.py's closed loop at its default shape (obs 17, act
    6, 2x256, max_batch 32, 5 ms window) for SERVE_BENCH_S each: the numpy
    and the device backend at 1 and 8 clients with the card idle, then the
    device backend at 8 clients while BackToBackChunks runs K1 (a)."""
    from distributed_ddpg_tpu_torch.tools.serve_bench import run_serve_bench

    out = {}

    def bench(tag, **kw):
        r = run_serve_bench(duration_s=SERVE_BENCH_S, device="cuda", measure_local=False, **kw)
        out[tag] = {k: r[k] for k in ("served_rps", "serve_p50_ms", "serve_p95_ms",
                                       "serve_max_ms", "serve_fill_mean", "client_sheds",
                                       "serve_errors")}
        log(f"[serve_bench] {card}: {tag}: rps {r['served_rps']}, p50 {r['serve_p50_ms']} ms, "
            f"p95 {r['serve_p95_ms']} ms, max {r['serve_max_ms']} ms, fill "
            f"{r['serve_fill_mean']}, sheds {r['client_sheds']}")
        if r["serve_errors"] or not r["served_rps"] > 0:
            raise AssertionError(f"serve_bench {tag}: {r}")

    for backend in ("numpy", "jax"):
        for clients in (1, 8):
            bench(f"{backend} x{clients} idle", backend=backend, clients=clients)
    with BackToBackChunks() as chunks:
        bench("jax x8 during K1 chunks", backend="jax", clients=8)
    c = chunks.summary()
    out["chunks"] = c
    log(f"[serve_bench] {card}: meanwhile {c['chunks']} K1 (a) chunks of {c['chunk_ms']:.3f} "
        f"ms, the card busy with them {100.0 * c['busy_share']:.1f}% of the run")
    return out


def serving_phase(card: str) -> dict:
    """4f (see the module docstring), under PhaseLimit(SERVE_LIMIT_S)."""
    t0 = time.monotonic()
    with PhaseLimit(SERVE_LIMIT_S, "phase 4f"):
        apply = check_serve_apply(card)
        served = served_main_path(card, gated=True)
        free = served_main_path(card, gated=False)
        front = check_front(card)
        bench = serve_bench_on_card(card)
    secs = time.monotonic() - t0
    log(f"[phase] 4f took {secs:.1f}s")
    return dict(apply=apply, served=served, free=free, front=front, bench=bench, seconds=secs)


# --- 4g. the operations layer (trace.py, watchdog.py, obs/, faults.py) -------

OPS_LIMIT_S = 150         # phase 4g's alarm (its budget is ~40 s on a fast host)
OPS_ENV_STEPS = 3000      # the traced main path, and the same path without the flags
# The profiled run: the warmup (1000 rows), then env steps held to the
# learner's by --max_ingest_ratio=1, so two chunks or three.
OPS_PROFILE_ENV_STEPS = 2600
OPS_WATCHDOG_S = 5        # the stall drill child's --watchdog_s
# The drill child's torch.cuda._sleep: at least 60 s at any SM clock up to
# 2 GHz (an H100 boosts to 1.98 GHz), over 10x OPS_WATCHDOG_S.
OPS_SLEEP_CYCLES = 60 * 2_000_000_000
OPS_DRILL_S = 240         # each drill child's time limit
# The CLI drill on K1 (a): both workers fail at their 500th env step (one
# dead, one heartbeating without rows), the 2nd ship and the 2nd transfer
# dispatch crash, the 1st checkpoint write fails, the 2nd broadcast is slow.
OPS_FAULTS = ("worker:0:crash@500;worker:1:stall@500;shipper:ship:crash@2;"
              "transfer:dispatch:crash@2;ckpt:write:ioerror@1;pool:broadcast:slow@2")
OPS_DRILL_ENV_STEPS = 8000
OPS_DEVACTOR_ENV_STEPS = 3 * 65536   # the warmup's rollout and two more (1024 envs x 64)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Scraper:
    """A thread that scrapes a running trainer's exporter every 250 ms:
    /healthz (200 and `healthy` expected), /metrics (the train record's
    learner rate once one is logged) and, at most twice, /trace (each
    writes the whole ring to a file); after the first scrape
    that shows a train record it sends this process SIGUSR2 once and waits
    for the signal's export (`trace_path`) to appear."""

    def __init__(self, port: int, trace_path: str):
        import threading

        self.url = f"http://127.0.0.1:{port}"
        self.trace_path = trace_path
        self.seen = dict(healthz=0, unhealthy=[], metrics=0, train_gauge=0, trace=0,
                         sigusr2_export=False)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="scraper", daemon=True)

    def start(self) -> "Scraper":
        self._thread.start()
        return self

    def _get(self, path: str):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.url + path, timeout=2) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()
        except OSError:
            return None, ""     # not bound yet, or already gone

    def _run(self) -> None:
        signalled = False
        while not self._stop.wait(0.25):
            status, body = self._get("/healthz")
            if status is None:
                continue
            if status == 200 and json.loads(body)["state"] == "healthy":
                self.seen["healthz"] += 1
            else:
                self.seen["unhealthy"].append((status, body))
            status, body = self._get("/metrics")
            if status == 200:
                self.seen["metrics"] += 1
                if 'ddpg_learner_steps_per_sec{kind="train"}' in body:
                    self.seen["train_gauge"] += 1
            if self.seen["trace"] < 2:
                status, body = self._get("/trace")
                if status == 200 and json.loads(body).get("enabled"):
                    self.seen["trace"] += 1
            if self.seen["train_gauge"] and not signalled:
                signalled = True
                os.kill(os.getpid(), signal.SIGUSR2)
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline and not os.path.exists(self.trace_path):
                    time.sleep(0.01)
                self.seen["sigusr2_export"] = os.path.exists(self.trace_path)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        return self.seen


def _tracks(path: str) -> dict:
    """{thread name: the set of span and instant names} of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    out = {}
    for e in events:
        if e["ph"] != "M":
            out.setdefault(names.get(e["tid"], str(e["tid"])), set()).add(e["name"])
    return out


def traced_main_path(card: str, common) -> dict:
    """4g (1): the DDPG main path on K1 (a) for OPS_ENV_STEPS env steps,
    first without and then with --trace_dir --watchdog_s=20 --obs_port
    --tb_dir --log_path, a Scraper reading the exporter during the second
    and sending SIGUSR2 once. Checks the exporter answered (/healthz 200
    healthy on every scrape, the train record's gauge, /trace), the signal's
    export, the train records' t_dispatch_*, t_sync_*, t_ingest_* and
    staleness_* fields, trace.json's tracks (the learner's dispatch, the
    ship and the scheduler's transfer spans), each actor's own file with
    its flushes, and the TensorBoard events file; prints both runs'
    learner steps/s."""
    flags = common + [f"--total_env_steps={OPS_ENV_STEPS}"]
    plain, traced = {}, {}
    drive_main_path(flags, "fused_chunk", plain)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ops_") as tmp:
        tdir, log_path = os.path.join(tmp, "trace"), os.path.join(tmp, "ops.jsonl")
        port = free_port()
        scraper = Scraper(port, os.path.join(tdir, "trace.json")).start()
        try:
            launches = drive_main_path(
                flags + [f"--trace_dir={tdir}", "--watchdog_s=20", f"--obs_port={port}",
                         f"--tb_dir={os.path.join(tmp, 'tb')}", f"--log_path={log_path}"],
                "fused_chunk", traced)
        finally:
            seen = scraper.stop()
        with open(log_path) as f:
            records = [json.loads(line) for line in f]
        trains = [r for r in records if r["kind"] == "train"]
        want = {f"t_{p}_{s}" for p in ("dispatch", "sync", "ingest")
                for s in ("ms", "p50", "p95", "max")} | {
            "n_dispatch", "n_sync", "n_ingest", "staleness_mean", "staleness_max"}
        missing = want - set(trains[0]) if trains else want
        tracks = _tracks(os.path.join(tdir, "trace.json"))
        actor_files = sorted(f for f in os.listdir(tdir) if f.startswith("trace_actor"))
        actor_tracks = [_tracks(os.path.join(tdir, f)) for f in actor_files]
        tb = [f for f in os.listdir(os.path.join(tmp, "tb")) if f.startswith("events.out")]
    span_threads = {name: sorted(t for t, spans in tracks.items() if name in spans)
                    for name in ("dispatch", "ingest_ship", "transfer_ingest", "param_broadcast")}
    log(f"[ops] traced main path: scrapes {json.dumps(seen)}; trace tracks "
        f"{json.dumps(span_threads)}; actor files {actor_files}; the first train record's "
        + json.dumps({k: trains[0].get(k) for k in sorted(want)} if trains else {}))
    if not (seen["healthz"] and not seen["unhealthy"] and seen["train_gauge"]
            and seen["trace"] and seen["sigusr2_export"]):
        raise AssertionError(f"ops: the exporter or SIGUSR2 did not answer as expected: {seen}")
    if missing:
        raise AssertionError(f"ops: the train record lacks {sorted(missing)}")
    if not (span_threads["dispatch"] == ["MainThread"] and span_threads["ingest_ship"]
            and "transfer-sched" in span_threads["transfer_ingest"]):
        raise AssertionError(f"ops: trace.json's tracks are not as expected: {span_threads}")
    if len(actor_files) != 1 or not all("actor_flush" in spans for t in actor_tracks
                                        for spans in t.values()):
        raise AssertionError(f"ops: actor trace files {actor_files} {actor_tracks}")
    if not tb:
        raise AssertionError("ops: no TensorBoard events file")
    overhead = 1.0 - traced["learner_steps_per_sec"] / plain["learner_steps_per_sec"]
    log(f"[ops] {card}: DDPG main path, {OPS_ENV_STEPS} env steps, learner steps/s "
        f"{plain['learner_steps_per_sec']} without the operations flags, "
        f"{traced['learner_steps_per_sec']} with them ({100.0 * overhead:.2f}% fewer; "
        f"{plain['chunks']} and {traced['chunks']} chunks)")
    return dict(launches=launches, plain=plain["learner_steps_per_sec"],
                traced=traced["learner_steps_per_sec"], overhead=overhead, scrapes=seen)


def profiled_flags(common, prof_dir: str):
    """4g (2)'s run: --profile_dir over the warmup and then two chunks or
    three, through train.main in a child process of this script
    (`--resume-drill`, which prints the kernels' launches), as a user runs
    it. (In this long-lived process, after the earlier phases' profiler
    sessions, the first chunk's kernel records were missing from such a
    trace in 3 of 5 runs, their launch calls present; PERF.md §7.)"""
    return common + [f"--total_env_steps={OPS_PROFILE_ENV_STEPS}", "--max_ingest_ratio=1",
                     f"--profile_dir={prof_dir}"]


def profiled_main_path(card: str, child: Child, prof_dir: str) -> dict:
    """4g (2): in the profiled run's Chrome trace (profiled_flags) K1's
    kernel appears as a CUDA kernel event once a chunk."""
    code, stdout, stderr, _, secs = child.finish()
    finals = [json.loads(line) for line in stdout.splitlines()
              if line.startswith('{"kind": "final"')]
    if code != 0 or not finals or not os.path.exists(os.path.join(prof_dir, "profile.json")):
        raise AssertionError(f"ops: the profiled run exited {code}; stderr: {stderr[-3000:]}")
    chunks = finals[-1]["chunks"]
    launches = json.loads(stdout.split("[launches] ")[-1].splitlines()[0])
    with open(os.path.join(prof_dir, "profile.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "fused_chunk_kernel" in e.get("name", "")]
    # The runtime calls that launched K1 (cudaLaunchCooperativeKernel), by
    # correlation id, beside the kernels they launched.
    launch_calls = [e for e in events if e.get("cat") == "cuda_runtime"
                    and "Cooperative" in e.get("name", "")]
    k1_corr = {e.get("args", {}).get("correlation") for e in k1}
    log(f"[ops] profiled main path ({secs:.1f}s, a child process): {chunks} chunks, {len(k1)} "
        f"K1 kernel events ({k1[0]['name'].split('(')[0] if k1 else None}, "
        f"{sum(e['dur'] for e in k1) / max(len(k1), 1):.1f} us each), {len(launch_calls)} "
        f"cooperative launch calls (without a kernel event: "
        f"{[e['ts'] for e in launch_calls if e.get('args', {}).get('correlation') not in k1_corr]}"
        f"), {len(kernels)} kernel events in all, {len(events)} events")
    if chunks < 2 or len(k1) != chunks or launches != {"fused_chunk": chunks}:
        raise AssertionError(f"ops: {len(k1)} K1 kernel events in the profile for "
                             f"{chunks} chunks (launches {launches})")
    return dict(chunks=chunks, k1_events=len(k1), kernel_events=len(kernels), seconds=secs)


def watchdog_drill_child(argv) -> int:
    """The stall drill's child (`--watchdog-drill OUT_DIR`): the DDPG main
    path through train.main with --watchdog_s=OPS_WATCHDOG_S and
    --trace_dir=OUT_DIR, and this harness, not a program flag, enqueueing
    torch.cuda._sleep(OPS_SLEEP_CYCLES) on the learner's stream right after
    the first chunk's dispatch, so the driver's next read waits on the card
    past the watchdog's timeout. Prints the stall's start time; the
    watchdog is to end the process with 70."""
    from distributed_ddpg_tpu_torch import train
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner

    out_dir = argv[0]
    run = ShardedLearner.run_sample_chunk
    calls = [0]

    def first_chunk_then_stall(learner, *args, **kwargs):
        out = run(learner, *args, **kwargs)
        calls[0] += 1
        if calls[0] == 1:
            torch.cuda._sleep(OPS_SLEEP_CYCLES)
            print(f"[stall] {time.time():.6f}", flush=True)
        return out

    ShardedLearner.run_sample_chunk = first_chunk_then_stall
    torch.backends.cuda.matmul.allow_tf32 = False
    train.main(["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
                "--eval_episodes=1", "--total_env_steps=100000000",
                f"--watchdog_s={OPS_WATCHDOG_S}", f"--trace_dir={out_dir}"])
    return 0


class Child:
    """A child process of this script (`mode` and its arguments), its
    output in files under `tmp`; finish() waits for it (OPS_DRILL_S at
    most, then kills it) and returns (exit code, stdout, stderr, the
    time.time() it was seen to end, its seconds)."""

    def __init__(self, tmp: str, tag: str, mode: str, args):
        self.files = [open(os.path.join(tmp, f"{tag}.{x}"), "w+") for x in ("out", "err")]
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, *args],
                                     stdout=self.files[0], stderr=self.files[1])

    def finish(self):
        try:
            self.proc.wait(timeout=OPS_DRILL_S)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        ended, secs = time.time(), time.monotonic() - self.t0
        out = []
        for f in self.files:
            f.seek(0)
            out.append(f.read())
            f.close()
        return self.proc.returncode, out[0], out[1], ended, secs


def watchdog_drill(card: str, child: Child, tmp: str) -> dict:
    """4g (3): the stall drill child (started by operations_phase, output
    dir `tmp`) must exit 70 and leave stall_report.json (the main thread
    in its device wait: a `_to_host` read) and stall_trace.json (its last
    spans, the first chunk's dispatch among them). Prints the seconds from
    the stall to the watchdog's report and from the report to the
    process's end."""
    code, stdout, stderr, ended, _ = child.finish()
    stalls = [float(line.split()[1]) for line in stdout.splitlines()
              if line.startswith("[stall] ")]
    files = sorted(os.listdir(tmp))
    report = trace_names = None
    if "stall_report.json" in files:
        with open(os.path.join(tmp, "stall_report.json")) as f:
            report = json.load(f)
    if "stall_trace.json" in files:
        trace_names = _tracks(os.path.join(tmp, "stall_trace.json"))
    main = next((t for t in (report or {}).get("threads", []) if t["name"] == "MainThread"),
                {"stack": []})
    waits = [line for line in main["stack"] if "_to_host" in line]
    if not (code == 70 and stalls and report is not None and waits
            and trace_names and "dispatch" in trace_names.get("MainThread", ())):
        raise AssertionError(f"watchdog drill: exit {code}, files {files}, main "
                             f"stack {main['stack'][-6:]}; stderr: {stderr[-3000:]}")
    record = dict(exit=code, stall_to_report_s=report["wall_time"] - stalls[0],
                  report_to_end_s=ended - report["wall_time"],
                  stall_to_end_s=ended - stalls[0], stalled_s=report["stalled_s"],
                  device_wait=waits[-1].split(": ")[0])
    log(f"[ops] {card}: watchdog drill (watchdog_s {OPS_WATCHDOG_S}, a "
        f"{OPS_SLEEP_CYCLES:.1e}-cycle sleep on the learner's stream after the first "
        "chunk): " + json.dumps(record))
    return record


def fault_drill_flags(tmp: str) -> dict:
    """4g (4)'s three CLI drills (run by operations_phase as children of
    this script, `--resume-drill`: train.main, printing the kernels'
    launches): OPS_FAULTS on K1 (a) with 2 actors, --actor_no_progress_s=3
    and --checkpoint_every=800; the host replay on the scan route with K2
    (--fused_update=true, K = 100) with prefetch:sample:slow@2~0.5; the
    device actors on K1 (a) with devactor:rollout:crash@2."""
    base = ["--replay_min_size=1000", "--eval_every=0", "--eval_episodes=1"]
    return {
        "sites": base + ["--num_actors=2", "--actor_no_progress_s=3",
                         "--actor_throttle_s=0.001", "--checkpoint_every=800",
                         f"--checkpoint_dir={os.path.join(tmp, 'ck')}",
                         f"--total_env_steps={OPS_DRILL_ENV_STEPS}", f"--faults={OPS_FAULTS}"],
        "prefetch": base + ["--num_actors=1", "--host_replay=true", "--fused_update=true",
                            "--learner_chunk=100", "--total_env_steps=3000",
                            "--faults=prefetch:sample:slow@2~0.5"],
        "devactor": base + ["--num_actors=0", "--actor_backend=device",
                            f"--total_env_steps={OPS_DEVACTOR_ENV_STEPS}",
                            "--faults=devactor:rollout:crash@2"],
    }


def fault_drills(children: dict) -> dict:
    """4g (4): each drill (fault_drill_flags) must exit 0 with the JAX
    trainer's counters: two respawns (one `dead`, one `no_rows`), one
    shipper restart, one scheduler restart and one checkpoint write retry,
    every chunk one K1 launch; the prefetched chunks' K2 launches twice a
    learner step; one device-actor restart."""
    out = {}
    for tag, child in children.items():
        code, stdout, stderr, _, secs = child.finish()
        finals = [json.loads(line) for line in stdout.splitlines()
                  if line.startswith('{"kind": "final"')]
        launches = json.loads(stdout.split("[launches] ")[-1].splitlines()[0]) \
            if "[launches] " in stdout else {}
        out[tag] = dict(exit=code, final=finals[-1] if finals else {}, launches=launches,
                        stderr=stderr, seconds=secs)
    for tag, r in out.items():
        f = r["final"]
        log(f"[ops] drill {tag}: exit {r['exit']} in {r['seconds']:.1f}s, launches "
            f"{r['launches']}; final " + json.dumps({k: f.get(k) for k in (
                "step", "learner_steps", "chunks", "actor_respawns", "actor_quarantined",
                "ingest_shipper_restarts", "transfer_restarts", "ckpt_write_retries",
                "devactor_restarts", "learner_steps_per_sec")}))
        for line in r["stderr"].splitlines():
            if line.startswith(("[pool]", "[checkpoint]", "[ingest]", "[transfer]",
                                "[devactor]")):
                log(f"  {line}")
        if r["exit"] != 0 or not f:
            raise AssertionError(f"drill {tag}: exit {r['exit']}; stderr: {r['stderr'][-3000:]}")
    sites, pre, dev = (out[t]["final"] for t in ("sites", "prefetch", "devactor"))
    err = out["sites"]["stderr"]
    if not (sites["actor_respawns"] == 2 and "failed (dead)" in err
            and "failed (no_rows)" in err and sites["ingest_shipper_restarts"] == 1
            and sites["transfer_restarts"] == 1 and sites["ckpt_write_retries"] == 1
            and out["sites"]["launches"] == {"fused_chunk": sites["chunks"]}):
        raise AssertionError(f"drill sites: counters {sites}, launches "
                             f"{out['sites']['launches']}")
    if out["prefetch"]["launches"] != {"fused_update": 2 * pre["learner_steps"]}:
        raise AssertionError(f"drill prefetch: launches {out['prefetch']['launches']} for "
                             f"{pre['learner_steps']} learner steps")
    if not (dev["devactor_restarts"] == 1
            and out["devactor"]["launches"] == {"fused_chunk": dev["chunks"]}):
        raise AssertionError(f"drill devactor: {dev}, launches {out['devactor']['launches']}")
    return {tag: dict(final=r["final"], launches=r["launches"], seconds=r["seconds"])
            for tag, r in out.items()}


def operations_phase(card: str) -> dict:
    """4g (see the module docstring), under PhaseLimit(OPS_LIMIT_S): the
    traced main path and its plain twin on an otherwise idle card (their
    rates are compared), then the profiled run's, the drills' and the
    stall drill's children started together, and their checks."""
    common = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
              "--eval_episodes=1"]
    t0 = time.monotonic()
    with PhaseLimit(OPS_LIMIT_S, "phase 4g"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_drills_") as tmp:
        traced = traced_main_path(card, common)
        stall_dir, prof_dir = os.path.join(tmp, "stall"), os.path.join(tmp, "profile")
        os.makedirs(stall_dir)
        children = {tag: Child(tmp, tag, "--resume-drill", flags)
                    for tag, flags in fault_drill_flags(tmp).items()}
        prof_child = Child(tmp, "profile", "--resume-drill", profiled_flags(common, prof_dir))
        stall_child = Child(tmp, "stall", "--watchdog-drill", [stall_dir])
        try:
            # The stall child first: it ends soonest, and the seconds to its
            # end are read when the wait for it returns.
            stall = watchdog_drill(card, stall_child, stall_dir)
            profiled_run = profiled_main_path(card, prof_child, prof_dir)
            drills = fault_drills(children)
        finally:
            for child in (*children.values(), prof_child, stall_child):
                if child.proc.poll() is None:
                    child.proc.kill()
                    child.proc.wait()
    secs = time.monotonic() - t0
    log(f"[phase] 4g took {secs:.1f}s")
    return dict(traced=traced, profiled=profiled_run, drills=drills, stall=stall, seconds=secs)


# --- 4h. the pod layer (parallel/multihost.py, supervisor/, tools/supervise.py) --

POD_LIMIT_S = 90          # phase 4h's alarm (its budget is 40-60 s on a fast host)
POD_DEADLINE_S = 8        # generation 1's --pod_collective_timeout_s
POD_HANG_BEAT = 5         # pod:1:hang@5: the 5th steady-state beat (after chunk 5)
# The global env-step budgets; generation 1 stops short of each. (a)'s
# relaunch then learns ~10 chunks to it, (b)'s generation 2 at least 10
# (its budget is gathered every 10th loop turn).
POD_SINGLE_ENV_STEPS = 12_000
POD_ENV_STEPS = 20_000
POD_LINGER_S = 2          # node 0's linger before its exit 76 (pod_child's linger_s)
# Detection past the deadline: the beat's lane dispatch and the two
# processes' skew at the beat (a poll of the ingest loop, 0.5 ms, and a
# chunk's end on two ranks time-slicing one card).
POD_SLACK_S = 2.0


def pod_child(argv) -> int:
    """One trainer process of phase 4h under the supervisor (`--pod-child`):
    train.main with a harness, not a program flag, that checks every beat's
    ship on the card: after DeviceReplay._ship_global lands a super-block,
    the node's own rows are read back from the ring at the JAX package's
    offsets j*(procs*bs) + p*bs + r from the pointer it wrote at, and
    counted when they differ. When the replay closes (after the last beat
    has landed) it prints the ring's sha256 over its filled rows and the
    tally; at the end, the kernels' launch counts, as --resume-drill does.

    The harness, not the trainer, reads the fault plan from POD_FAULTS
    (tools.supervise --env-first sets it in generation 1 only, as the JAX
    package's test child reads it) and gives node 0's exit 76 a linger of
    POD_LINGER_S."""
    import functools
    import hashlib

    from distributed_ddpg_tpu_torch import train
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.replay.device import DeviceReplay

    ship_global, close = DeviceReplay._ship_global, DeviceReplay.close
    tally = dict(ships=0, rows_landed=0, rows_checked=0, rows_misplaced=0)

    def checked_ship_global(rep, local_rows, k=1):
        start = ship_global(rep, local_rows, k)
        bs, procs, p = rep.block_size, rep._procs, rep._proc_idx
        offsets = (np.arange(k)[:, None] * (procs * bs) + p * bs
                   + np.arange(bs)[None, :]).reshape(-1)
        # A sharded ring holds the logical positions it owns (p % D) at
        # slots p // D: those of this node's rows are checked there.
        pos = (start + offsets) % rep.capacity
        mine = pos % rep.n_shards == rep.shard
        idx = torch.as_tensor(pos[mine] // rep.n_shards, device=rep.device)
        landed = rep.storage[idx].cpu().numpy()
        if rep._pod_lead:
            tally["rows_checked"] += int(mine.sum())
            tally["rows_misplaced"] += int((landed != local_rows[mine]).any(axis=1).sum())
        tally["ships"] += 1
        tally["rows_landed"] += procs * k * bs
        return start

    def closing(rep):
        filled = rep.storage[:rep.local_fill].cpu().numpy()
        print("[ring] " + json.dumps(dict(sha256=hashlib.sha256(filled.tobytes()).hexdigest(),
                                          size=rep.size, ptr=rep.ptr, **tally)), flush=True)
        return close(rep)

    DeviceReplay._ship_global = checked_ship_global
    DeviceReplay.close = closing
    train.pod_degraded_exit = functools.partial(train.pod_degraded_exit, POD_LINGER_S)
    if os.environ.get("POD_FAULTS"):
        argv = [*argv, f"--faults={os.environ['POD_FAULTS']}"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    code = 0
    try:
        train.main(argv)
    except SystemExit as e:
        code = e.code
    print("[launches] " + json.dumps(dict(fc.KERNEL_LAUNCHES)), flush=True)
    return code


def supervise_cmd(tmp: str, tag: str, procs: int, flags, extra=()):
    """tools.supervise over `procs` processes of pod_child with these trainer
    flags (per-generation and per-process JSONL logs), its event log and
    child logs under tmp/tag."""
    base = os.path.join(tmp, tag)
    os.makedirs(base, exist_ok=True)
    return [sys.executable, "-m", "distributed_ddpg_tpu_torch.tools.supervise",
            "--procs", str(procs), "--backoff-base", "0.1", "--drain-grace", "5",
            "--kill-grace", "5", "--event-log", os.path.join(base, "events.jsonl"),
            "--child-logs", os.path.join(base, "children"), *extra, "--",
            sys.executable, os.path.abspath(__file__), "--pod-child", *flags,
            f"--log_path={os.path.join(base, 'gen{gen}_proc{proc}.jsonl')}"]


def _events(tmp: str, tag: str) -> list:
    with open(os.path.join(tmp, tag, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _child_log(tmp: str, tag: str, gen: int, proc: int) -> str:
    with open(os.path.join(tmp, tag, "children", f"gen{gen}_proc{proc}.log"),
              errors="replace") as f:
        return f.read()


def _child_summary(text: str) -> dict:
    import ast

    lines = [line for line in text.splitlines() if line.startswith("{'")]
    if not lines:
        raise AssertionError("phase 4h: a child printed no summary:\n" + text[-3000:])
    return ast.literal_eval(lines[-1])


def _tagged(text: str, tag: str) -> dict:
    lines = [line for line in text.splitlines() if line.startswith(tag + " ")]
    if not lines:
        raise AssertionError(f"phase 4h: no {tag} line:\n" + text[-3000:])
    return json.loads(lines[-1][len(tag) + 1:])


def _in_order(kinds, want) -> bool:
    it = iter(kinds)
    return all(any(k == w for k in it) for w in want)


class SupervisedPreemption:
    """4h (a): one process under the supervisor on K1 (a), started before
    (b) and finished after it (the two overlap while (b)'s first
    generation waits out its deadline). Once generation 1's first cadence
    checkpoint has landed, a watcher thread sends SIGTERM to that child
    (not the supervisor): it exits 75 with its emergency checkpoint, the
    supervisor relaunches it in place, generation 2 resumes from
    --checkpoint_dir and finishes (exit 0), and so does the supervisor;
    its event log holds spawn, exit, relaunch, spawn and the final 0 in
    that order."""

    def __init__(self, tmp: str, common):
        import threading

        self.tmp, self.t0 = tmp, time.monotonic()
        self.ckdir = os.path.join(tmp, "single_ckpt")
        flags = common + [f"--total_env_steps={POD_SINGLE_ENV_STEPS}",
                          f"--checkpoint_dir={self.ckdir}", "--checkpoint_every=800"]
        cmd = supervise_cmd(tmp, "single", 1, flags)
        self.out = open(os.path.join(tmp, "single", "supervisor.out"), "w+")
        self.sup = subprocess.Popen(cmd, stdout=self.out, stderr=subprocess.STDOUT)
        self.sent = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="pod-4h-a", daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        manifest = os.path.join(self.ckdir, "manifest_800.json")
        while not self._stop.is_set() and self.sup.poll() is None:
            if os.path.exists(manifest):
                spawn = next(e for e in _events(self.tmp, "single") if e["event"] == "spawn")
                os.kill(spawn["pid"], signal.SIGTERM)
                self.sent.set()
                return
            time.sleep(0.05)

    def stop(self) -> None:
        self._stop.set()
        if self.sup.poll() is None:
            self.sup.kill()
            self.sup.wait()
        self._thread.join(timeout=5)
        self.out.close()

    def finish(self, card: str) -> dict:
        self.sup.wait()
        self._thread.join(timeout=5)
        secs = time.monotonic() - self.t0
        self.out.seek(0)
        out = self.out.read()
        events = _events(self.tmp, "single")
        kinds = [e["event"] for e in events]
        exits_ = [(e["gen"], e["code"]) for e in events if e["event"] == "exit"]
        gen2 = _child_log(self.tmp, "single", 2, 0)
        summary = _child_summary(gen2)
        launches = _tagged(gen2, "[launches]")
        if not (self.sup.returncode == 0 and self.sent.is_set() and exits_ == [(1, 75), (2, 0)]
                and _in_order(kinds, ["spawn", "exit", "relaunch", "spawn", "final"])
                and events[-1]["event"] == "final" and events[-1]["code"] == 0
                and summary["resumed_from"] and summary["resumed_from"] >= 800
                and summary["fused_chunk_active"]
                and launches == {"fused_chunk": summary["chunks"]}):
            raise AssertionError(
                f"phase 4h (a): supervisor exit {self.sup.returncode}, SIGTERM sent "
                f"{self.sent.is_set()}, events {kinds}, exits {exits_}, launches {launches}, "
                f"summary {summary}; supervisor output: {out[-2000:]}")
        record = dict(seconds=secs, events=kinds, resumed_from=summary["resumed_from"],
                      generation_s=[e["runtime_s"] for e in events if e["event"] == "exit"],
                      ended_unix=events[-1]["t_unix"], launches=launches["fused_chunk"],
                      chunks=summary["chunks"],
                      learner_steps_per_sec=summary["learner_steps_per_sec"])
        log(f"[pod] {card}: (a) one process under the supervisor, SIGTERM after the first "
            "cadence checkpoint: " + json.dumps(record))
        return record


def two_node_pod(card: str, tmp: str, common) -> dict:
    """4h (b): two nodes of one rank each (tools.supervise --procs 2 sets
    torchrun's environment), DDPG_DIST_BACKEND=gloo on the one card, 1
    actor each, K1 (a) on every chunk (the mesh launch). Generation 1 has
    pod:1:hang@POD_HANG_BEAT (--env-first): node 0 must exit 76 within
    POD_DEADLINE_S + POD_SLACK_S of the hang; node 1's own beat misses the
    same deadline (76). Generation 2: both elect the same resume step,
    every chunk one K1 launch a process, exit 0; the replicas' states
    bit-identical (mesh.replicas_equal), both rings the same bytes, and
    every beat's rows of each node at the JAX package's offsets."""
    ckdir = os.path.join(tmp, "pod_ckpt")
    flags = common + [f"--total_env_steps={POD_ENV_STEPS}", f"--checkpoint_dir={ckdir}",
                      "--checkpoint_every=1600", f"--pod_collective_timeout_s={POD_DEADLINE_S}"]
    extra = ["--env", "DDPG_DIST_BACKEND=gloo",
             "--env-first", f"POD_FAULTS=pod:1:hang@{POD_HANG_BEAT}"]
    t0 = time.monotonic()
    res = subprocess.run(supervise_cmd(tmp, "pod", 2, flags, extra), capture_output=True,
                         text=True, timeout=POD_LIMIT_S)
    secs = time.monotonic() - t0
    events = _events(tmp, "pod")
    kinds = [e["event"] for e in events]
    exits_ = sorted((e["gen"], e["proc"], e["code"]) for e in events if e["event"] == "exit")
    g1 = [_child_log(tmp, "pod", 1, p) for p in (0, 1)]
    g2 = [_child_log(tmp, "pod", 2, p) for p in (0, 1)]
    fired = re.search(rf"\[chaos\] pod:1:hang@{POD_HANG_BEAT} fired at ([0-9.]+)", g1[1])
    seen = re.search(r"\[train\] pod peer lost at ([0-9.]+)", g1[0])
    latency = float(seen.group(1)) - float(fired.group(1)) if fired and seen else None
    summaries = [_child_summary(t) for t in g2]
    rings = [_tagged(t, "[ring]") for t in g2]
    launches = [_tagged(t, "[launches]") for t in g2]
    elected = [s["pod_resume_step_elected"] for s in summaries]
    with open(os.path.join(tmp, "pod", "gen2_proc0.jsonl")) as f:
        final = [r for r in map(json.loads, f) if r["kind"] == "final"][-1]
    ok = (res.returncode == 0 and exits_[:1] == [(1, 0, 76)]
          and [c for g, _, c in exits_ if g == 2] == [0, 0]
          and _in_order(kinds, ["spawn", "spawn", "exit", "exit", "relaunch", "spawn", "spawn",
                                "exit", "exit", "final"])
          and events[-1]["code"] == 0 and latency is not None
          and POD_DEADLINE_S - 0.5 <= latency <= POD_DEADLINE_S + POD_SLACK_S
          and elected[0] == elected[1] > 0
          and all(s["replicas_identical"] and s["route"] == "mesh" and s["fused_chunk_active"]
                  and s["resumed_from"] == elected[0] for s in summaries)
          and launches == [{"fused_chunk": s["chunks"]} for s in summaries]
          and all(s["chunks"] > 0 for s in summaries)
          and rings[0]["sha256"] == rings[1]["sha256"] and rings[0]["size"] == rings[1]["size"]
          and all(r["ships"] > 0 and r["rows_checked"] > 0 and r["rows_misplaced"] == 0
                  for r in rings))
    if not ok:
        raise AssertionError(
            f"phase 4h (b): supervisor exit {res.returncode}, events {kinds}, exits {exits_}, "
            f"detection latency {latency}, elected {elected}, launches {launches}, rings "
            f"{rings}, summaries {summaries}; supervisor: {res.stdout[-1500:]} "
            f"{res.stderr[-1500:]}; gen 1 node 0: {g1[0][-2500:]}; gen 1 node 1: "
            f"{g1[1][-2500:]}")
    pod_fields = {k: v for k, v in final.items() if k.startswith("pod_")}
    record = dict(seconds=secs, generations=events[-1]["supervisor_generations"],
                  generation_s=[e["runtime_s"] for e in events if e["event"] == "exit"],
                  gen2_spawned_unix=[e["t_unix"] for e in events
                                     if e["event"] == "spawn" and e["gen"] == 2][0],
                  gen1_exits=[c for g, _, c in exits_ if g == 1],
                  detection_latency_s=latency, deadline_s=POD_DEADLINE_S,
                  elected_step=elected[0], launches=[x["fused_chunk"] for x in launches],
                  chunks=[s["chunks"] for s in summaries],
                  learner_steps_per_sec=[s["learner_steps_per_sec"] for s in summaries],
                  env_steps_per_sec=[s["env_steps_per_sec"] for s in summaries],
                  rings=rings, events=kinds)
    log(f"[pod] {card}: (b) two nodes over gloo on the one card: " + json.dumps(record))
    log(f"[pod] {card}: detection latency {latency:.3f} s (deadline {POD_DEADLINE_S} s), "
        f"elected step {elected[0]}, generations {record['generations']}, K1 launches a "
        f"process {record['launches']} (= chunks {record['chunks']}); generation 2, gloo "
        f"time-slicing one card: learner steps/s {record['learner_steps_per_sec']}, env "
        f"steps/s {record['env_steps_per_sec']} (nodes 0, 1)")
    log(f"[pod] {card}: process 0's final record's pod_* fields: " + json.dumps(pod_fields))
    return record


SHRINK_LIMIT_S = 100       # 4i's own deadline on its supervisor
SHRINK_KILL_BEAT = 3       # pod:1:kill@3: after two chunks' slice sets have landed
SHRINK_ENV_STEPS = 20_000  # generation 1 is killed short of it; generation 2 finishes it
SHRINK_INGEST_RATIO = 20   # paced: the kill comes ~4000 env steps in, on any host


class ShardedShrink:
    """4i (module docstring): the sharded pod's shrink under the supervisor,
    started before 4h (a) and (b) and finished after them."""

    def __init__(self, tmp: str, common):
        self.tmp, self.t0 = tmp, time.monotonic()
        self.ckdir = os.path.join(tmp, "shrink_ckpt")
        flags = common + [f"--total_env_steps={SHRINK_ENV_STEPS}",
                          f"--checkpoint_dir={self.ckdir}", f"--checkpoint_every={SHARD_K}",
                          f"--learner_chunk={SHARD_K}", "--replay_sharding=sharded",
                          "--fused_update=true", f"--max_ingest_ratio={SHRINK_INGEST_RATIO}",
                          f"--pod_collective_timeout_s={POD_DEADLINE_S}"]
        extra = ["--env", "DDPG_DIST_BACKEND=gloo",
                 "--env-first", f"POD_FAULTS=pod:1:kill@{SHRINK_KILL_BEAT}"]
        cmd = supervise_cmd(tmp, "shrink", 2, flags, extra)
        self.out = open(os.path.join(tmp, "shrink", "supervisor.out"), "w+")
        self.sup = subprocess.Popen(cmd, stdout=self.out, stderr=subprocess.STDOUT)

    def stop(self) -> None:
        if self.sup.poll() is None:
            self.sup.kill()
            self.sup.wait()
        self.out.close()

    def finish(self, card: str) -> dict:
        try:
            self.sup.wait(timeout=max(1.0, SHRINK_LIMIT_S - (time.monotonic() - self.t0)))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 4i went past its {SHRINK_LIMIT_S} s limit") from None
        secs = time.monotonic() - self.t0
        self.out.seek(0)
        out = self.out.read()
        events = _events(self.tmp, "shrink")
        kinds = [e["event"] for e in events]
        exits_ = sorted((e["gen"], e["proc"], e["code"]) for e in events if e["event"] == "exit")
        g1 = [_child_log(self.tmp, "shrink", 1, p) for p in (0, 1)]
        g2 = _child_log(self.tmp, "shrink", 2, 0)
        fired = re.search(rf"\[chaos\] pod:1:kill@{SHRINK_KILL_BEAT} fired at ([0-9.]+)", g1[1])
        seen = re.search(r"\[train\] pod peer lost at ([0-9.]+)", g1[0])
        latency = float(seen.group(1)) - float(fired.group(1)) if fired and seen else None
        summary = _child_summary(g2)
        launches = _tagged(g2, "[launches]")
        ok = (self.sup.returncode == 0
              and exits_ == [(1, 0, 78), (1, 1, -signal.SIGKILL), (2, 0, 0)]
              and "shrink-ready, exiting 78" in g1[0]
              and latency is not None and latency < POD_DEADLINE_S
              and summary["pod_slices_adopted"] == 1 and summary["pod_shrinks"] == 1
              and summary["pod_state_degraded"] == 1 and summary["replay_shard_count"] == 1
              and "written by 2 process(es), resharded to 1" in g2
              and summary["chunks"] > 0 and not summary["fused_chunk_active"]
              and launches == {"fused_update": 2 * (summary["learner_steps"]
                                                    - summary["resumed_from"])})
        if not ok:
            raise AssertionError(
                f"phase 4i: supervisor exit {self.sup.returncode}, events {kinds}, exits "
                f"{exits_}, detection latency {latency}, launches {launches}, summary "
                f"{summary}; supervisor: {out[-1500:]}; gen 1 node 0: {g1[0][-2500:]}; "
                f"gen 1 node 1: {g1[1][-1500:]}; gen 2: {g2[-2500:]}")
        record = dict(seconds=secs, events=kinds, detection_latency_s=latency,
                      generation_s=[(e["gen"], e["proc"], e["runtime_s"]) for e in events
                                    if e["event"] == "exit"],
                      adopted_step=summary["pod_slice_adopted_step"],
                      resumed_from=summary["resumed_from"],
                      launches=launches["fused_update"], chunks=summary["chunks"],
                      learner_steps_per_sec=summary["learner_steps_per_sec"],
                      env_steps_per_sec=summary["env_steps_per_sec"])
        log(f"[pod] {card}: 4i the sharded pod's shrink: " + json.dumps(record))
        log(f"[pod] {card}: 4i detection latency {latency:.3f} s; generation 1 node 0 exit 78 "
            f"with slices adopted from step {record['adopted_step']}; generation 2 (one node) "
            f"K2 launches {record['launches']}, learner steps/s "
            f"{record['learner_steps_per_sec']}, env steps/s {record['env_steps_per_sec']}; "
            f"generations' seconds {record['generation_s']}")
        return record


def pod_phase(card: str) -> dict:
    """4h (see the module docstring), under PhaseLimit(POD_LIMIT_S): (a) and
    (b) side by side, each a tools.supervise process and its children
    (most of each generation is its processes' start). Whether (a) still
    ran when (b)'s generation 2 started, the run whose rates are printed,
    is printed too."""
    common = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
              "--eval_episodes=1"]
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as tmp:
        # 4i beside 4h: started first, finished after, under its own limit.
        shrink_run = ShardedShrink(tmp, common)
        try:
            with PhaseLimit(POD_LIMIT_S, "phase 4h"):
                single_run = SupervisedPreemption(tmp, common)
                try:
                    pod = two_node_pod(card, tmp, common)
                    single = single_run.finish(card)
                finally:
                    single_run.stop()
            shrink = shrink_run.finish(card)
        finally:
            shrink_run.stop()
    secs = time.monotonic() - t0
    overlap = single["ended_unix"] - pod["gen2_spawned_unix"]
    log(f"[pod] {card}: (a) ended {overlap:+.3f} s after (b)'s generation 2 spawned"
        + (" (so (a)'s last seconds ran beside (b)'s relaunch)" if overlap > 0 else ""))
    log(f"[phase] 4h and 4i took {secs:.1f}s")
    return dict(single=single, pod=pod, shrink=shrink, seconds=secs, a_after_b_gen2_s=overlap)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 2. build every kernel ---
    from distributed_ddpg_tpu_torch.ops import _build

    t0 = time.monotonic()
    reports = _build.build_all(["fused_chunk", "fused_update"])
    log(f"[build] {time.monotonic() - t0:.1f}s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  {name}: {line.strip()}")

    # --- 3. kernels against their plain versions ---
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.tools import update_trees as ut

    cfg = DDPGConfig()                        # 2x256, batch 64, f32, cuda
    log("[parity] fused_update kernel vs fused_adam_polyak_reference on the card")
    update_err = {which: check_fused_update(which)
                  for which in (*ut.SHAPES, "ddpg_critic", "ddpg_actor", "d4pg_critic")}
    check_bias_corrections()
    update_launches_per_call()
    log("[parity] the scan route on the card")
    check_scan_route(cfg.replace(fused_update=True))
    check_scan_route(cfg.replace(fused_update=True, distributional=True, v_min=-10.0,
                                 v_max=10.0))
    check_scan_route(cfg.replace(critic_l2=0.01))
    check_scan_route(cfg.replace(fused_chunk="off"), against_kernel=True)
    td3 = cfg.replace(twin_critic=True, policy_delay=2, target_noise=0.2)
    td3_plain = cfg.replace(twin_critic=True)  # delay 1, no noise input
    d4pg = cfg.replace(distributional=True, v_min=-10.0, v_max=10.0)   # 51 atoms
    sac = cfg.replace(sac=True, actor_lr=3e-4, critic_lr=3e-4, tau=0.005)
    K = resolve_learner_chunk(cfg)            # the main path's chunk (800)
    td3_step = 1001                           # odd: the delay schedule is offset
    log("[parity] fused_chunk kernel vs fused_chunk_reference on the card")
    errs = {}
    for obs, act in ((3, 1), (17, 6)):
        for k in (16, K):
            errs[("fused_chunk", obs, k)] = check_fused_chunk(cfg, obs, act, k)
            errs[("fused_chunk_td3", obs, k)] = check_fused_chunk(
                td3, obs, act, k, td3_step, referee=(obs, k) == (17, K))
        check_fused_chunk(td3_plain, obs, act, 16, td3_step)
        for k in (16, K):
            errs[("fused_chunk_d4pg", obs, k)] = check_fused_chunk(d4pg, obs, act, k)
    check_fused_chunk(d4pg.replace(num_atoms=256), 3, 1, 16)
    check_fused_chunk(d4pg, 3, 1, 16, bounds=(-25.0, 5.0))
    # At the scale the main path trains with: a support like the one it
    # resolves from Pendulum's warmup (about [-1430, 130], dz ~31) and
    # Pendulum's 5-step returns (5 x [-16.3, 0], discount 0.99^5), so
    # tz clips at v_min and lands between atoms ~31 apart.
    for k in (16, K):
        check_fused_chunk(d4pg.replace(v_min=-1500.0, v_max=150.0), 3, 1, k,
                          rewards=(-81.5, 0.0, 0.99 ** 5))
    # SAC as README's command runs it: the temperature learned, and fixed.
    for obs, act in ((3, 1), (17, 6)):
        for k in (16, K):
            errs[("fused_chunk_sac", obs, k)] = check_fused_chunk(
                sac, obs, act, k, referee=(obs, k) == (17, K), spread_on_cpu=True)
        check_fused_chunk(sac.replace(sac_autotune=False), obs, act, 16)
    check_fused_chunk(sac, 3, 1, 16, tied=True)
    check_fused_chunk(sac, 17, 6, 16, hot=True)
    # bf16: the same branches with every product's operands rounded (TD3
    # with delay 2 and noise, D4PG at 51 atoms, SAC learning its
    # temperature); the K = 800 chunks with the f32 spread of the plain
    # version on the card and on the CPU as referee.
    for name, c, step in (("fused_chunk_bf16", cfg, 1000),
                          ("fused_chunk_td3_bf16", td3, td3_step),
                          ("fused_chunk_d4pg_bf16", d4pg, 1000),
                          ("fused_chunk_sac_bf16", sac, 1000)):
        c = c.replace(compute_dtype="bfloat16")
        for obs, act in ((3, 1), (17, 6)):
            check_fused_chunk(c, obs, act, 16, step)
        small = c.replace(actor_hidden=(32, 32), critic_hidden=(32, 32), batch_size=8)
        if c.distributional:
            small = small.replace(num_atoms=21, v_min=-5.0, v_max=5.0)
        check_fused_chunk(small, 3, 1, 4, 5, fresh=True)
        errs[(name, 3, K)] = check_fused_chunk(c, 3, 1, K, step, referee=True,
                                               spread_on_cpu=True)

    log("[parity] prioritized replay on the card")
    check_per_draw()
    check_per_chunk(cfg)
    check_per_chunk(d4pg)
    check_per_duplicates()
    check_per_syncs()

    log("[parity] the ingest pipeline on the card")
    check_ingest_parity()
    ingest_chunk = ingest_during_chunk(card)
    check_ingest_wrap()
    check_ingest_fence()

    log("[parity] K1 (a) on terminal rows at MountainCar's shapes; the guarded chunk")
    # MountainCar's rows: a step's reward in [-0.1, 0], 15% of them terminal
    # (discount 0, reward 100), under PR 1's f32 rule at K = 16 and 800.
    for k in (16, K):
        check_fused_chunk(cfg, 2, 1, k, terminal=0.15, scale=1.0, rewards=(-0.1, 0.0, 0.99))
    check_guarded_chunk(card)

    log(f"[phase] parity done at {time.monotonic() - t_start:.1f}s")

    # --- 3b. the mesh phase: two ranks over gloo on the one card ---
    mesh_record = mesh_phase(card)
    log("[mesh] rank 0's record: " + json.dumps(mesh_record))
    log(f"[phase] mesh done at {time.monotonic() - t_start:.1f}s")

    # --- 4. the main paths ---
    # DDPG, README's whole D4PG command (with --prioritized=true), SAC and
    # bf16 DDPG run STEADY_ENV_STEPS each: tens of chunks, so their rates
    # are the steady state's and not the first chunk's one-time costs. The
    # other paths run a few chunks each, enough to check their launches
    # and metrics.
    common = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
              "--eval_episodes=2"]
    plain = {}
    launches = drive_main_path(common + [f"--total_env_steps={STEADY_ENV_STEPS}"],
                               "fused_chunk", plain)
    # Each main path of the before/after record also runs once on the old
    # pipeline (OLD_PIPELINE: the queue, inline pageable inserts, no
    # scheduler), for a few chunks: DDPG here, README's D4PG command and
    # the scan route with K2 below.
    before_after(card, "DDPG", plain, common + [f"--total_env_steps={OLD_ENV_STEPS}"],
                 "fused_chunk")
    log(f"[ingest] {card}: in the parity phase {INGEST_BLOCKS} blocks staged during a "
        f"{ingest_chunk['chunk_ms']:.3f} ms chunk held the driver "
        f"{ingest_chunk['main']['total_ms']:.3f} ms on the default pipeline, "
        f"{ingest_chunk['old']['total_ms']:.3f} ms on the old one")
    launches.update(drive_main_path(
        common + ["--total_env_steps=5000", "--twin_critic=true", "--policy_delay=2",
                  "--target_noise=0.2"],
        "fused_chunk_td3"))
    d4pg_flags = ["--distributional=true", "--n_step=5", "--v_min=auto", "--v_max=auto"]
    with tempfile.TemporaryDirectory() as tmp:   # the run's JSONL: its support records
        drive_main_path(
            common + ["--total_env_steps=5000", *d4pg_flags,
                      f"--log_path={os.path.join(tmp, 'd4pg.jsonl')}"],
            "fused_chunk_d4pg")
        d4pg_per = {}
        launches.update(drive_main_path(
            common + [f"--total_env_steps={STEADY_ENV_STEPS}", *d4pg_flags,
                      "--prioritized=true",
                      f"--log_path={os.path.join(tmp, 'd4pg_per.jsonl')}"],
            "fused_chunk_d4pg", d4pg_per))
        before_after(card, "D4PG with PER", d4pg_per,
                     common + [f"--total_env_steps={OLD_ENV_STEPS}", *d4pg_flags,
                               "--prioritized=true",
                               f"--log_path={os.path.join(tmp, 'd4pg_per_old.jsonl')}"],
                     "fused_chunk_d4pg")
    launches.update(drive_main_path(
        common + [f"--total_env_steps={STEADY_ENV_STEPS}", "--sac=true", "--actor_lr=3e-4",
                  "--critic_lr=3e-4", "--tau=0.005"],
        "fused_chunk_sac"))
    # bf16: DDPG for STEADY_ENV_STEPS, the other families for a few chunks
    # each.
    bf16 = common + ["--compute_dtype=bfloat16"]
    launches.update(drive_main_path(bf16 + [f"--total_env_steps={STEADY_ENV_STEPS}"],
                                    "fused_chunk_bf16"))
    launches.update(drive_main_path(
        bf16 + ["--total_env_steps=5000", "--twin_critic=true", "--policy_delay=2",
                "--target_noise=0.2"],
        "fused_chunk_td3_bf16"))
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(drive_main_path(
            bf16 + ["--total_env_steps=5000", "--distributional=true", "--n_step=5",
                    "--v_min=auto", "--v_max=auto",
                    f"--log_path={os.path.join(tmp, 'd4pg_bf16.jsonl')}"],
            "fused_chunk_d4pg_bf16"))
    launches.update(drive_main_path(
        bf16 + ["--total_env_steps=5000", "--sac=true", "--actor_lr=3e-4",
                "--critic_lr=3e-4", "--tau=0.005"],
        "fused_chunk_sac_bf16"))
    # The scan route: DDPG with the fused update for 10,000 env steps, then
    # README's whole D4PG command (PER included) with it and the DDPG
    # paper's critic weight decay (no fused update) for 5000 each. A scan
    # chunk of 800 eager steps holds the host ~3-5 s; the actor fills its
    # shm ring (4096 rows) meanwhile, so a chunk brings in ~4000 env steps
    # (PERF.md §5): 10,000 env steps are 2-3 chunks.
    scan_k2 = {}
    update_launches = drive_main_path(common + ["--total_env_steps=10000",
                                                "--fused_update=true"], "scan", scan_k2)
    before_after(card, "the scan route with K2", scan_k2,
                 common + [f"--total_env_steps={OLD_SCAN_ENV_STEPS}", "--fused_update=true"],
                 "scan")
    with tempfile.TemporaryDirectory() as tmp:
        drive_main_path(
            common + ["--total_env_steps=5000", *d4pg_flags, "--prioritized=true",
                      "--fused_update=true",
                      f"--log_path={os.path.join(tmp, 'd4pg_scan.jsonl')}"],
            "scan")
    drive_main_path(common + ["--total_env_steps=5000", "--critic_l2=0.01"], "scan")
    # This slice's paths: MountainCar with 4 actors on K1 (a), and the
    # guarded scan route with K2, PER off and on.
    mountain_car_path(card)
    guarded = guarded_main_paths(card)
    log(f"[phase] main paths done at {time.monotonic() - t_start:.1f}s")

    # --- 4b. checkpoint and resume ---
    readme_d4pg = cfg.replace(distributional=True, n_step=5, v_min=math.nan, v_max=math.nan,
                              prioritized=True)
    check_resume_chunk(readme_d4pg, RESUME_K, card)
    check_resume_chunk(readme_d4pg.replace(fused_update=True), RESUME_SCAN_K, card)
    resume_drill(card)
    # The DDPG main path again with a save every chunk (its snapshot on
    # the loop's thread), beside the same path's rate without it above.
    cadence = {}
    with tempfile.TemporaryDirectory() as tmp:
        drive_main_path(common + [f"--total_env_steps={CADENCE_ENV_STEPS}",
                                  f"--checkpoint_dir={tmp}", "--checkpoint_every=800"],
                        "fused_chunk", cadence)
    log(f"[resume] {card}: DDPG main path learner steps/s "
        f"{plain['learner_steps_per_sec']} without checkpoints, "
        f"{cadence['learner_steps_per_sec']} with a save every chunk "
        f"({cadence['ckpt_skipped']} skipped, {cadence['chunks']} chunks)")
    log(f"[phase] resume done at {time.monotonic() - t_start:.1f}s")

    # --- 4c. the guardrail drills through the CLI ---
    guardrail_drills(card)
    log(f"[phase] drills done at {time.monotonic() - t_start:.1f}s")

    # --- 4d. the host replay, strict sync and the agent (this slice) ---
    host = host_replay_phase(card, common)
    log(f"[phase] host replay, strict sync and agent done at "
        f"{time.monotonic() - t_start:.1f}s")
    # The kernels' record counts each kernel's launches on this slice's
    # paths where it runs on one: K1 (a) and (c) on the host replay, K2 in
    # the agent's steps; the other branches on their device-replay paths.
    launches.update(fused_chunk=host["fused_chunk"], fused_chunk_d4pg=host["fused_chunk_d4pg"])
    update_launches = {"fused_update": host["fused_update_agent"]}

    # --- 4e. device actors, the fused beat, the superstep, the monolith ---
    devact = device_actor_phase(card, plain)
    log(f"[phase] device actors, fused beat, superstep and monolith done at "
        f"{time.monotonic() - t_start:.1f}s")
    dl = devact["launches"]
    # This slice's paths: K1 (a) on the device actors, K2 on the fused beat;
    # every path's count beside them.
    paths = {
        "fused_chunk": {"device_actors": dl["device_actors"]["fused_chunk"],
                        "devactor_resume": dl["devactor_resume"]["fused_chunk"],
                        "host_replay": host["fused_chunk"]},
        "fused_update": {"fused_beat": dl["fused_beat"]["fused_update"],
                         "superstep": dl["superstep"]["fused_update"],
                         "jax_ondevice": dl["jax_ondevice"]["fused_update"],
                         "agent": host["fused_update_agent"]},
    }
    update_launches = {"fused_update": paths["fused_update"]["fused_beat"]}

    # --- 4f. batched policy serving (this slice) ---
    serving = serving_phase(card)
    log(f"[phase] serving done at {time.monotonic() - t_start:.1f}s")
    # This slice's path: K1 (a) on the served actors' main path.
    paths["fused_chunk"]["served"] = serving["served"]["launches"]["fused_chunk"]
    paths["fused_chunk"]["served_free_running"] = serving["free"]["launches"]["fused_chunk"]
    launches["fused_chunk"] = paths["fused_chunk"]["served"]

    # --- 4g. the operations layer (this slice) ---
    ops = operations_phase(card)
    log(f"[phase] operations done at {time.monotonic() - t_start:.1f}s")
    # This slice's paths: K1 (a) on the traced main path and the drills, K2
    # on the host-replay drill's scan route.
    paths["fused_chunk"]["operations"] = ops["traced"]["launches"]["fused_chunk"]
    paths["fused_chunk"]["fault_drill"] = ops["drills"]["sites"]["launches"]["fused_chunk"]
    paths["fused_chunk"]["devactor_drill"] = ops["drills"]["devactor"]["launches"]["fused_chunk"]
    paths["fused_update"]["prefetch_drill"] = \
        ops["drills"]["prefetch"]["launches"]["fused_update"]
    launches["fused_chunk"] = paths["fused_chunk"]["operations"]
    update_launches = {"fused_update": paths["fused_update"]["prefetch_drill"]}

    # --- 4h. the pod layer (this slice) ---
    pod = pod_phase(card)
    log(f"[phase] pod done at {time.monotonic() - t_start:.1f}s")
    # This slice's paths: K1 (a) a process on generation 2 of the two-node
    # pod, and on the single supervised process's generation 2.
    paths["fused_chunk"]["pod_generation2"] = pod["pod"]["launches"]
    paths["fused_chunk"]["supervised_relaunch"] = pod["single"]["launches"]
    # This slice's paths: K2 on the sharded main path at D = 2 (the mesh
    # phase) and on the shrunk pod's generation 2 (4i); K1 runs on no
    # sharded path (the JAX learner's rule).
    paths["fused_update"]["sharded_mesh"] = mesh_record["sharded"]["path"]["launches"]
    paths["fused_update"]["sharded_shrink_generation2"] = pod["shrink"]["launches"]
    # This slice's paths (3c): K2 on each rank's shards on the TP main path
    # at D = 1 x M = 2 (train() on the mesh ranks) and at D = 2 x M = 2
    # through the CLI (a rank's count); K1 runs on no TP path (the JAX
    # learner's rule: model_axis > 1 keeps it off).
    paths["fused_update"]["tp_mesh"] = mesh_record["tp"]["path"]["launches"]
    paths["fused_update"]["tp_2x2_cli"] = mesh_record["tp"]["cli_2x2"]["launches"]
    update_launches = {"fused_update": paths["fused_update"]["tp_mesh"]}

    # --- 5. timing at the main path's shapes ---
    timing = {
        "fused_chunk": time_branch(cfg, "fused_chunk", K, 1000, card, eager=True),
        "fused_chunk_td3": time_branch(td3, "fused_chunk_td3", K, td3_step, card, eager=False),
        "fused_chunk_d4pg": time_branch(d4pg, "fused_chunk_d4pg", K, 1000, card, eager=False),
        "fused_chunk_sac": time_branch(sac, "fused_chunk_sac", K, 1000, card, eager=False),
    }
    for name, c, step in (("fused_chunk_bf16", cfg, 1000),
                          ("fused_chunk_td3_bf16", td3, td3_step),
                          ("fused_chunk_d4pg_bf16", d4pg, 1000),
                          ("fused_chunk_sac_bf16", sac, 1000)):
        timing[name] = time_branch(c.replace(compute_dtype="bfloat16"), name, K, step, card,
                                   eager=name == "fused_chunk_bf16",
                                   split=name == "fused_chunk_bf16")
    update_timing = time_fused_update(card)
    time_scan_chunk(card, cfg, K)
    guard_ops = guard_ops_per_step(card, cfg)
    log(f"[guardrails] {card}: guarded main paths' learner steps/s "
        + ", ".join(f"{n} {g['learner_steps_per_sec']}" for n, g in guarded.items())
        + f" against the unguarded K2 scan route's {scan_k2['learner_steps_per_sec']}; "
        f"device operations a step {guard_ops['guarded']['launches']:.1f} guarded, "
        f"{guard_ops['unguarded']['launches']:.1f} unguarded")
    time_per(card, timing["fused_chunk_d4pg"]["ms"])
    log(f"[done] {time.monotonic() - t_start:.1f}s")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "distributed_ddpg_tpu_torch/csrc/fused_chunk.cu",
        "replaces": "distributed_ddpg_tpu/ops/fused_chunk.py:992",
        "launches": launches[name],
        "max_abs_err": errs[(name, 3, K)],
        **timing[name],
        "library_ms": None,
        **({"launches_on_paths": paths[name]} if name in paths else {}),
    } for name in timing] + [{
        "name": "fused_update",
        "route": "cuda",
        "source": "distributed_ddpg_tpu_torch/csrc/fused_update.cu",
        "replaces": "distributed_ddpg_tpu/ops/fused_update.py:81",
        "launches": update_launches["fused_update"],
        "max_abs_err": update_err["ddpg_critic"],
        **update_timing,
        "launches_on_paths": paths["fused_update"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--resume-drill"]:
        sys.exit(resume_drill_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--watchdog-drill"]:
        sys.exit(watchdog_drill_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--pod-child"]:
        sys.exit(pod_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-child"]:
        sys.exit(tp_child(sys.argv[2:]))
    sys.exit(main())
