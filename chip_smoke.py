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
   with bit-identical replicas.
4. Drive the main paths, `distributed_ddpg_tpu_torch.train` (Pendulum-v1,
   2x256, batch 64, f32, one actor process, K = 800): DDPG with the
   default flags and TD3 with --twin_critic=true --policy_delay=2
   --target_noise=0.2 for 5000 env steps each, then D4PG with
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
   5000 each. DDPG and README's D4PG command run on the default pipeline
   (20,000 env steps) and once with the old one's flags (5000),
   --transport=queue --ingest_async=false --transfer_scheduler=false, and
   the scan route with K2 once with them (1200), each run printed with
   its wall time a chunk (before_after). For each, the
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
   MountainCarContinuous-v0 with 4 actors on K1 (a) for 20,000 env steps
   (mountain_car_path: the env's source, rows from every actor, the
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
   the DDPG main path again with a save every chunk, its learner steps/s
   beside the same path's without.
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
   twice a learner step, agent_path). The kernels' record counts K1 (a)'s
   and (c)'s launches on the host-replay paths and K2's in the agent.
5. Time each branch of the kernel at the main path's shapes (CUDA events,
   warmed up) beside its plain version (one run) and its bound; the eager autograd
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
    ref, rtd, rmet = fc.fused_chunk_reference(cfg, state, packed, scale, 0.0, eps)
    torch.cuda.synchronize()

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
        f"{summary['t_ingest_max']:.3f} ms, {summary['n_ingest']} calls); since the last "
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
            f"{summary['t_sample_wait_ms']:.3f} ms a chunk (depth {summary['prefetch_depth']})"
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
    if summary["learner_steps"] != summary["chunks"] * resolve_learner_chunk(cfg):
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


def ms_a_chunk(summary: dict) -> float:
    """A main path's wall time a chunk after its warmup (its learner steps
    over its learner steps/s, over its chunks)."""
    return 1000.0 * summary["learner_steps"] / summary["learner_steps_per_sec"] \
        / summary["chunks"]


def before_after(card: str, path: str, flags_of, name: str, first: dict = None,
                 turns=("default", "old", "old", "default")) -> None:
    """A main path on the default pipeline and on the old one (OLD_PIPELINE)
    in turns, each run printed with its rates, its wall time a chunk and
    the driver's ingest time a chunk. `flags_of(i)` gives run i's flags;
    `first`, a summary already taken on the default pipeline, stands for
    the first turn."""
    runs = []
    for i, kind in enumerate(turns):
        summary = first if (i == 0 and first is not None) else {}
        if not summary:
            drive_main_path(flags_of(i) + (OLD_PIPELINE if kind == "old" else []), name,
                            summary)
        runs.append((kind, summary))
    for kind, s in runs:
        log(f"[ingest] {card}: {path} main path, {kind} pipeline: learner steps/s "
            f"{s['learner_steps_per_sec']}, env steps/s {s['env_steps_per_sec']}, "
            f"{ms_a_chunk(s):.2f} ms a chunk over {s['chunks']} chunks ({s['env_steps']} env "
            f"steps), the card idle between chunks {s['gap_median_ms']} ms median, the "
            f"driver's ingest {s['t_ingest_chunk_ms']:.3f} ms a chunk, longest call "
            f"{s['t_ingest_max']:.3f} ms")


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
    # first call pays nothing a second would not, so no warm-up run.
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
MESH_TIMEOUT_S = 600      # the whole phase, both ranks
MESH_K = 16               # the mesh launch's checks (the existing K = 16 rule)
MESH_SUPPORT = (-4.0, 4.0)   # a C51 support far too narrow for Pendulum's returns
MESH_SUPPORT_K = 200      # learner steps a chunk of the forced expansion
MESH_SUPPORT_CHUNKS = 12  # chunks the expansion may take to fire
# README's whole D4PG command with PER at D = 2 takes the scan route: a scan
# chunk of 800 eager steps holds each rank's host ~9 s while the actor
# fills its 4096-row shm ring, so 10,000 env steps are ~3 chunks past the
# 1000-row warmup.
MESH_PER_ENV_STEPS = 10_000


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
                                                "t_ingest_chunk_ms", "t_ingest_max",
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
    say(f"[phase] mesh phase done at {time.monotonic() - t0:.1f}s")
    if group.lead:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(record, f)
    dist.destroy_process_group()
    return 0


RESUME_K = 800             # (a): the main path's chunk
RESUME_SCAN_K = 50        # (b): the scan route with K2, a check of the path
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
GUARD_ENV_STEPS = 10_000   # the guarded main path (2-3 chunks); with PER 5000 (1-2)
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

HOST_ENV_STEPS = 5000      # each host-replay main path
PREFETCH_CHUNKS = 4        # chunks through the prefetcher a check
STRICT_ENV_STEPS = 5000    # each strict-sync run on K1 (a)
STRICT_SCAN_ENV_STEPS = 3000   # each strict-sync run on the scan route (~4 s a chunk)
AGENT_ENV_STEPS = 2000
# The wall-clock fields of a record (tests/test_strict_sync.py's list, the
# port's env_steps_per_sec and every t_* field); the rest must match.
STRICT_TIME_KEYS = ("wall_time", "learner_steps_per_sec", "actor_steps_per_sec",
                    "ingest_rows_per_sec", "ingest_stall_ms", "ingest_ship_ms",
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
            f"{s['chunks']} chunks, the driver's wait for a chunk {s['t_sample_wait_ms']:.3f} "
            f"ms a chunk, the card idle between chunks {s['gap_median_ms']} ms median"
            + (f", sum tree {s['sum_tree']}" if "sum_tree" in s else ""))
    log(f"[host replay] {card}: " + json.dumps(dict(prefetched=prefetched, launches=out)))
    return out


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
    # README's whole D4PG command (with --prioritized=true), this slice's
    # path, and SAC run 20k env steps each: tens of chunks, so their rates
    # are the steady state's and not the first chunk's one-time costs. The
    # other paths run a few chunks each, enough to check their launches
    # and metrics.
    common = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
              "--eval_episodes=2"]
    plain = {}
    launches = drive_main_path(common + ["--total_env_steps=5000"], "fused_chunk", plain)
    # The same with the pipeline before PR 13's (the queue, inline pageable
    # inserts, no scheduler): DDPG at 20,000 env steps (20-40 chunks) on the
    # default pipeline, and once at 5000 on the old one (the before/after
    # record of PR 13 ran each twice at 20,000; cut to stay in time).
    before_after(card, "DDPG",
                 lambda i: common + [f"--total_env_steps={20000 if i == 0 else 5000}"],
                 "fused_chunk", turns=("default", "old"))
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

        def d4pg_per_flags(i):
            return common + [f"--total_env_steps={20000 if i == 0 else 5000}", *d4pg_flags,
                             "--prioritized=true",
                             f"--log_path={os.path.join(tmp, f'd4pg_per{i}.jsonl')}"]

        launches.update(drive_main_path(d4pg_per_flags(0), "fused_chunk_d4pg", d4pg_per))
        before_after(card, "D4PG with PER", d4pg_per_flags, "fused_chunk_d4pg", first=d4pg_per,
                     turns=("default", "old"))
    launches.update(drive_main_path(
        common + ["--total_env_steps=20000", "--sac=true", "--actor_lr=3e-4",
                  "--critic_lr=3e-4", "--tau=0.005"],
        "fused_chunk_sac"))
    # bf16, this slice's path: DDPG for 20,000 env steps, the other
    # families for a few chunks each.
    bf16 = common + ["--compute_dtype=bfloat16"]
    launches.update(drive_main_path(bf16 + ["--total_env_steps=20000"], "fused_chunk_bf16"))
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
    # (PERF.md §5): 10,000 env steps are 2-3 chunks. On the old pipeline
    # (its 4 x 32-row queue) a chunk brought in ~130-220, so its run is cut
    # to 1200 env steps (1-2 chunks).
    scan_k2 = {}
    update_launches = drive_main_path(common + ["--total_env_steps=10000",
                                                "--fused_update=true"], "scan", scan_k2)
    before_after(card, "the scan route with K2",
                 lambda i: common + [f"--total_env_steps={10000 if i == 0 else 1200}",
                                     "--fused_update=true"],
                 "scan", first=scan_k2, turns=("default", "old"))
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
        drive_main_path(common + ["--total_env_steps=5000", f"--checkpoint_dir={tmp}",
                                  "--checkpoint_every=800"], "fused_chunk", cadence)
    log(f"[resume] {card}: DDPG main path learner steps/s "
        f"{plain['learner_steps_per_sec']} without checkpoints, "
        f"{cadence['learner_steps_per_sec']} with a save every chunk "
        f"({cadence['ckpt_skipped']} skipped)")
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
    } for name in timing] + [{
        "name": "fused_update",
        "route": "cuda",
        "source": "distributed_ddpg_tpu_torch/csrc/fused_update.cu",
        "replaces": "distributed_ddpg_tpu/ops/fused_update.py:81",
        "launches": update_launches["fused_update"],
        "max_abs_err": update_err["ddpg_critic"],
        **update_timing,
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
    sys.exit(main())
