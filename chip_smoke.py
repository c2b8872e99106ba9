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
   critic, counted by torch.profiler; then the
   scan route (parallel/learner.make_scan_chunk_fn, K = 16 on one state
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
   card's cumsum's decreasing neighbours printed); one PER chunk at
   K = 16 on the chunk kernel's route against the scan route, DDPG and
   D4PG (51 atoms), on the same idx and weights (the state under the f32
   rule, td, the priority vector and max_priority within OUT_TOL); the
   duplicate rule of the priority write (the last draw of a slot wins)
   the same on the card as on the CPU and bit-identical over two runs;
   and no synchronizing call added by the PER chunk over a uniform one,
   or by the priority stamp over a uniform insert (torch.cuda sync
   debug mode).
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
   --fused_update=true for 5000 env steps, README's D4PG command (with
   --prioritized=true) with --fused_update=true and --critic_l2=0.01 for
   2500 each. For each, the
   launch counts are zeroed just before and read just after: on the
   kernel route every chunk must have been one launch of that branch's
   kernel and nothing else; on the scan route (fused_chunk_active false)
   no chunk kernel, and the fused update twice a learner step when
   fused_update is on, else never; learner_steps = chunks x K, metrics
   finite.
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
   kernel time a chunk and PER's byte bound.

It imports nothing of JAX or of the JAX package. The second-to-last line
is the kernels' JSON record; the last line is the device record.
"""

from __future__ import annotations

import json
import math
import os
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
                   rewards=None, weighted: bool = True) -> torch.Tensor:
    """Random packed rows. Rewards are N(0, 1) with discount 0.99, or with
    `rewards` = (low, high, discount) uniform in [low, high) at that
    discount. Importance weights are drawn from [0.5, 1], so a kernel that
    drops them fails, or are 1 unless `weighted`. The columns are drawn
    in the order obs, action, reward, next_obs, weight, so the default
    rows do not depend on `weighted`."""
    from distributed_ddpg_tpu_torch.types import pack_batch_np

    rng = np.random.default_rng(seed)
    o = rng.standard_normal((k, b, obs))
    a = rng.uniform(-2, 2, (k, b, act))
    if rewards is None:
        reward, disc = rng.standard_normal((k, b)), 0.99
    else:
        reward, disc = rng.uniform(rewards[0], rewards[1], (k, b)), rewards[2]
    packed = pack_batch_np({
        "obs": o.astype(np.float32),
        "action": a.astype(np.float32),
        "reward": reward.astype(np.float32),
        "discount": np.full((k, b), disc, np.float32),
        "next_obs": rng.standard_normal((k, b, obs)).astype(np.float32),
        "weight": (rng.uniform(0.5, 1.0, (k, b)) if weighted else np.ones((k, b))
                   ).astype(np.float32),
    })
    return torch.from_numpy(packed).cuda()


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
                      spread_on_cpu: bool = False, fresh: bool = False) -> float:
    """Kernel vs plain version on one random state and batch (and noise);
    returns the largest absolute difference over end state, td and
    metrics. Raises where an output is outside the tolerances; with
    `referee` (a drifting case, see SHARE_RATIO) such an output is held
    against the plain version in float64 instead, the f32 spread measured
    by the plain version on the card, and with `spread_on_cpu` by the
    larger miss of it and the plain version on the CPU. With `bounds` (D4PG)
    the kernel runs one chunk, then set_value_bounds(*bounds) and the
    chunk that is checked, against the plain version under those bounds.
    `rewards` is random_batches', `tied`, `hot` and `fresh` random_state_np's;
    from a `fresh` state (zero Adam moments, counts 0) the first moments
    are also held to FRESH_MU_RTOL and FRESH_MU_SCALE."""
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc

    label = (f"fused_chunk_td3 delay={cfg.policy_delay} noise={cfg.target_noise}"
             if cfg.twin_critic else
             f"fused_chunk_d4pg atoms={cfg.num_atoms}" if cfg.distributional else
             f"fused_chunk_sac autotune={cfg.sac_autotune}" if cfg.sac else "fused_chunk")
    label += (f" obs={obs} act={act} K={k}" + (" tied critics" if tied else "")
              + (" hot temperature" if hot else "") + (" fresh state" if fresh else "")
              + (" bf16" if cfg.compute_dtype == "bfloat16" else ""))
    if cfg.distributional:
        label += f" support=[{cfg.v_min:g}, {cfg.v_max:g}]"
    state = train_state_from_numpy(
        random_state_np(cfg, obs, act, seed=obs, step=step, tied=tied, hot=hot, fresh=fresh),
        "cuda")
    packed = random_batches(seed=100 + obs, k=k, b=cfg.batch_size, obs=obs, act=act,
                            rewards=rewards, weighted=k <= WEIGHTED_UP_TO)
    eps = noise_for(cfg, k, cfg.batch_size, act, step)
    run = fc.make_fused_chunk_fn(cfg, obs, act, 2.0, 0.0, chunk_size=k, device="cuda")
    if bounds is not None:
        run(state, packed, eps)
        run.set_value_bounds(*bounds)
        cfg = cfg.replace(v_min=bounds[0], v_max=bounds[1])
        label += f" after set_value_bounds{tuple(bounds)}"
    new, td, met = run(state, packed, eps)
    ref, rtd, rmet = fc.fused_chunk_reference(cfg, state, packed, 2.0, 0.0, eps)
    torch.cuda.synchronize()

    got_all, want_all = chunk_outputs(new, td, met), chunk_outputs(ref, rtd, rmet)
    worst, failed = compare_outputs(label, cfg, obs, act, got_all, want_all, fresh)
    if failed and not referee:
        raise AssertionError(f"{label}: {', '.join(failed)} outside the tolerances")
    if failed:
        exact, etd, emet = fc.fused_chunk_reference(
            cfg, to_double(state), packed.double(), 2.0, 0.0, to_double(eps))
        exact_all = chunk_outputs(exact, etd, emet)
        cuts, groups = state_cuts(cfg, obs, act)
        spread = [want_all]
        if spread_on_cpu:
            spread.append(chunk_outputs(*fc.fused_chunk_reference(
                cfg, tree_map_tensors(torch.Tensor.cpu, state), packed.cpu(), 2.0, 0.0,
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


def update_launches_per_call(calls: int = 5) -> float:
    """Device operations (kernels, copies, sets) a call of the fused update's
    wrapper on the Pendulum DDPG critic, counted by torch.profiler over
    `calls` calls: 1 expected."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_ddpg_tpu_torch.ops import fused_update as fu

    params, opt, targets, grads_at = update_trees("ddpg_critic")
    grads = grads_at(0, params)
    fu.fused_adam_polyak(params, grads, opt, targets, 1e-3, 5e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fu.fused_adam_polyak(params, grads, opt, targets, 1e-3, 5e-3)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    per_call = sum(e.count for e in events) / calls
    log(f"  fused_update wrapper: {per_call:g} device operations a call over {calls} calls "
        f"(torch.profiler: " + ", ".join(f"{e.key} x{e.count}" for e in events) + ")")
    if per_call != 1:
        raise AssertionError(f"fused_update wrapper: {per_call} device operations a call, "
                             "expected one launch")
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
    cumsums sum in different orders), with the count of decreasing
    neighbours in the card's cumsum."""
    from distributed_ddpg_tpu_torch.replay.device import draw_per_indices

    uniform = torch.from_numpy(
        np.random.default_rng(30).uniform(0, 1, (PER_K, PER_B)).astype(np.float32))
    for kind in ("dyadic", "random"):
        prios = torch.from_numpy(per_priorities(kind, PER_CAPACITY, 31))
        cidx, cw = draw_per_indices(prios.cuda(), PER_CAPACITY, (PER_K, PER_B), 0.4,
                                    uniform=uniform.cuda())
        hidx, hw = draw_per_indices(prios, PER_CAPACITY, (PER_K, PER_B), 0.4, uniform=uniform)
        cum = torch.cumsum(prios.cuda(), 0)
        falls = int((cum[1:] < cum[:-1]).sum())
        again = bool(torch.equal(cum, torch.cumsum(prios.cuda(), 0)))
        cidx, cw = cidx.cpu(), cw.cpu()
        same = cidx == hidx
        rows = same.all(dim=1)    # a row's weights share its max: compare whole rows
        w_err = float(((cw - hw).abs() / hw)[rows].max())
        log(f"  PER draw {kind} priorities, capacity {PER_CAPACITY}, K={PER_K} B={PER_B}: "
            f"{float((~same).double().mean()):.3e} of the indices differ from the CPU's "
            f"({int((~rows).sum())} of {PER_K} rows), weights' largest relative gap in the "
            f"rows that agree {w_err:.3e}; the card's cumsum (bit-identical when run "
            f"again: {again}) has {falls} decreasing neighbours, total {float(cum[-1]):.6f} on the card, "
            f"{float(torch.cumsum(prios, 0)[-1]):.6f} on the CPU")
        if kind == "dyadic" and (not bool(same.all()) or w_err > 1e-6):
            raise AssertionError("PER draw: the card and the CPU differ on exact sums")
        if cidx.max() >= PER_CAPACITY or not bool(torch.isfinite(cw).all()):
            raise AssertionError(f"PER draw {kind}: an index past the fill or a bad weight")


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


def sync_calls(fn) -> int:
    """Synchronizing CUDA calls made by fn() (torch.cuda sync debug mode,
    'warn', its warnings counted; the mode's own notice, once a process,
    is not one)."""
    import warnings

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


def time_per(card: str, chunk_ms: float) -> None:
    """PER's own work a chunk at the main path's shapes (K = 800, B = 64,
    capacity 1M, D4PG's rows): the draw, the gather into a fresh copy, the
    weight column, then from a td of the chunk's shape the new priorities,
    their write and the max, as run_sample_chunk_per does them around the
    chunk. Device time a chunk from torch.profiler (the card's busy time),
    time a chunk with the host's enqueue from CUDA events, beside the
    chunk kernel's time a chunk and PER's byte bound: the priority vector
    read once, the K x B rows read and written, td read, the K x B
    priorities and the max written."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_ddpg_tpu_torch.replay.device import draw_per_indices, scatter_last_wins

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

    reps = 20
    wall_ms = time_ms(per_work, reps=reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            per_work()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS) / reps
    width = rep.width
    nbytes = (4 * PER_CAPACITY + 2 * PER_K * PER_B * width * 4 + PER_K * PER_B * 4
              + PER_K * PER_B * 4 + 4)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"[timing] {card}: PER a chunk (K={PER_K}, B={PER_B}, capacity {PER_CAPACITY}): "
        f"device time {device_ms * 1e3:.2f} us ({launches:.1f} kernel launches), "
        f"{wall_ms * 1e3:.2f} us a chunk with the host's enqueue; the D4PG chunk kernel "
        f"{chunk_ms:.3f} ms a chunk, PER's device time {device_ms / chunk_ms:.3%} of it; "
        f"bound {bound_ms * 1e3:.3f} us, bytes ({nbytes / 1e6:.2f} MB)")


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


def drive_main_path(flags, name: str) -> dict:
    """One run of `distributed_ddpg_tpu_torch.train` with these flags (the
    CLI's own parser), with the launch counts zeroed just before and read
    just after. On the kernel route every chunk must be one launch of
    kernel `name`; on the scan route (`name` "scan") no chunk kernel may
    launch, and the fused update twice a learner step when fused_update is
    on, else never. Under --prioritized=true the final beta must lie in
    [per_beta, per_beta_final] and max_priority be at least its start, 1."""
    from distributed_ddpg_tpu_torch.config import DDPGConfig
    from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
    from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
    from distributed_ddpg_tpu_torch.parallel.learner import resolve_learner_chunk
    from distributed_ddpg_tpu_torch.train import train

    cfg = DDPGConfig.from_flags(flags)
    fc.KERNEL_LAUNCHES.clear()
    t0 = time.monotonic()
    summary = train(cfg, echo=False)
    launches = dict(fc.KERNEL_LAUNCHES)
    log(f"[main path {name}] {time.monotonic() - t0:.1f}s: " + json.dumps(summary))
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

    log(f"[phase] parity done at {time.monotonic() - t_start:.1f}s")

    # --- 4. the main paths ---
    # README's whole D4PG command (with --prioritized=true), this slice's
    # path, and SAC run 20k env steps each: tens of chunks, so their rates
    # are the steady state's and not the first chunk's one-time costs. The
    # other paths run a few chunks each, enough to check their launches
    # and metrics.
    common = ["--num_actors=1", "--replay_min_size=1000", "--eval_every=0",
              "--eval_episodes=2"]
    launches = drive_main_path(common + ["--total_env_steps=5000"], "fused_chunk")
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
        launches.update(drive_main_path(
            common + ["--total_env_steps=20000", *d4pg_flags, "--prioritized=true",
                      f"--log_path={os.path.join(tmp, 'd4pg_per.jsonl')}"],
            "fused_chunk_d4pg"))
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
    # The scan route: DDPG with the fused update for 5000 env steps, then
    # README's whole D4PG command (PER included) with it and the DDPG
    # paper's critic weight decay (no fused update) for 2500 each. A scan
    # chunk of 800 eager steps holds the host ~3-8 s while the actor's
    # queue (4 x 32 rows) fills, so a chunk brings in only ~130-170 env
    # steps (PERF.md §5): 5000 env steps are ~30 chunks, 130-250 s a path
    # on the hosts seen so far, 2500 about 10 chunks. Three paths at 5000
    # took 564 s of a 938 s run on a slow host, too close to the run's
    # limit for a slower one (PERF.md §4).
    update_launches = drive_main_path(common + ["--total_env_steps=5000",
                                                "--fused_update=true"], "scan")
    with tempfile.TemporaryDirectory() as tmp:
        drive_main_path(
            common + ["--total_env_steps=2500", *d4pg_flags, "--prioritized=true",
                      "--fused_update=true",
                      f"--log_path={os.path.join(tmp, 'd4pg_scan.jsonl')}"],
            "scan")
    drive_main_path(common + ["--total_env_steps=2500", "--critic_l2=0.01"], "scan")
    log(f"[phase] main paths done at {time.monotonic() - t_start:.1f}s")

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
    sys.exit(main())
