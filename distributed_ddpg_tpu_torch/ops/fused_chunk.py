"""K full DDPG, TD3, D4PG or SAC learner steps in ONE launch of a hand-written CUDA kernel.

Replaces the DDPG TD(0) f32 branch (a), the TD3 branch (b), the C51
branch (c) and the SAC branch (d) of the Pallas megakernel distributed_ddpg_tpu/ops/fused_chunk.py
(make_fused_chunk_fn -> run -> pl.pallas_call, kernel body
_make_kernel.kernel). Each step computes what that kernel computes, in the
same order of effects:

  target actor + target critic forward, TD target, critic forward and
  backward (layer 1's weight split at row F: features | action), actor
  forward, critic backward to the action only through the PRE-update
  critic, tanh chain and actor backward, Adam with bias correction
  1 - exp(t * log B) from each net's own carried count, Polyak, td[k],
  and the chunk mean of the 6 metrics (learner.METRIC_KEYS order).

TD3 (twin_critic; JAX kernel :572-607, :656-681, :697-724, :741-746): the
target action is smoothed by a streamed noise input eps[K, B, act]
(already clipped, `td3_noise_eps`) and clipped to the action box; both
critic members run forward on the target and online paths, the target is
the min over the two target heads, each member gets the cotangent
-w * td_m / B; the actor goes through member 0. The critic steps every
step; the actor's Adam and every Polyak update run only on steps with
(step0 + k) % policy_delay == 0, whose actor bias correction counts
the real updates, a_t = count_a + f(step0 + k) - f(step0) + 1 with
f(n) = ceil(n / policy_delay). The actor's backward tasks are skipped on
the other steps (their gradient would be discarded).

D4PG (distributional; JAX kernel :612-644, :661-670): the critic's head
has A = num_atoms logits. After the target and online heads, a row task
(no product; one warp per row) takes the stable softmax of the target
head, projects the Bellman-shifted distribution onto the support z[A]
with the triangular kernel relu(1 - |tz_i - z_j| / dz) accumulated over
i in ascending order, and writes the cross-entropy, td = E_proj[z] -
E_p[z] and the closed-form cotangent dq = (p - proj) * w / B. A second
row task turns the actor's head into dq_pi = -(1/B) p (z - E[Z]), so the
actor's backward starts after it. The support row and its spacing dz are
inputs of the launch; a change of bounds rewrites them in place.

SAC (JAX kernel :424-567): the actor's head is linear, [mean | log_std_raw]
(2*act wide), and both Gaussian forwards, on next_obs for the target and on
obs for the actor's loss, use the ONLINE actor. Two standard-normal streams
[K, B, act] are inputs (`sac_noise_eps`). Row tasks (one warp a row, lanes
over the action dims) sample a = tanh(mean + std*eps)*scale + offset with
its log-prob through the squash; form the target y = r + disc*(min(q'0,
q'1) - alpha*lp') with both members' cotangents; the min gate over the two
online critics at the sampled action (ties split 0.5/0.5, as jnp.min's
gradient); and the actor's cotangent at its head through the sample, the
log-prob and the log_std soft clamp. Both targets take Polyak every step;
with sac_autotune, block 0 takes the temperature's Adam step (critic_lr,
its own count) after every reader of step k's alpha has cached it at the
step's start.

bf16 (compute_dtype='bfloat16', any of the four; JAX kernel :218-242,
branch e): both operands of every product, forward and backward, are
rounded to bf16 and the f32 sum is kept, as the JAX kernel's `cast` does
before each dot. The bias gradients are sums of the f32 cotangent, not
products, and round nothing (JAX kernel :354, :366, :371, :381, :386); in
the program they are products with a row of ones (BASE_ONES), so the rule
the kernel applies is: a segment whose A operand is BASE_ONES rounds
neither operand. Activations, the TD, C51 and SAC row math, Adam, Polyak
and the state stay f32. This is NOT where the eager bf16 step rounds (JAX
autodiff rounds the gradients' products instead, models/mlp.py::
_Bf16Dense); the two agree only to bf16 level, as in the JAX package.

The data-parallel mesh launch of the JAX kernel is later work
(ROADMAP.md Queue 1).

Three pieces live here:

- `_plan`: turns the net shapes into a small program for the kernel — a
  table of matrix-product tasks (forward, weight gradient, input
  gradient, each with a fused epilogue) and row tasks (C51's softmaxes
  and projection; SAC's sampling, target, min gate and actor cotangent),
  grouped into stages by their data
  dependencies, with every buffer's offset in one flat scratch tensor.
  The kernel (csrc/fused_chunk.cu) loops over k and, per step, over the
  stages; a grid-wide barrier separates the stages. Within a stage the
  actor's backward tasks come last, so a step that skips them (TD3's
  delay) runs only a prefix of the stage's tiles.
- `fused_chunk_reference`: the plain PyTorch version, the same K-step
  hand-written math. The wrapper runs it for tensors on the CPU; the
  tests and chip_smoke.py hold the kernel and the JAX package against it.
- `make_fused_chunk_fn`: the wrapper. Inside the envelope (`supported`)
  and the JAX kernel's VMEM gate (`fits_vmem`), on a CUDA tensor it
  launches the kernel or raises; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
from distributed_ddpg_tpu_torch.models.mlp import round_bf16
from distributed_ddpg_tpu_torch.ops._build import KERNEL_LAUNCHES
from distributed_ddpg_tpu_torch.ops.losses import TANH_EPS, sac_target_entropy, support_row
from distributed_ddpg_tpu_torch.ops.optim import B1, B2, EPS
from distributed_ddpg_tpu_torch.types import OptState, TrainState

# --- the kernel's program format (mirrors csrc/fused_chunk.cu) ------------

TILE = 16                 # output tile is TILE x TILE, one element a thread
MAX_STAGES = 64
TASK_INTS = 40
OP_FWD, OP_DW, OP_DX, OP_ROWS = 0, 1, 2, 3   # OP_ROWS: a row task, no product
BASE_STATE, BASE_SCRATCH, BASE_BATCH, BASE_ONES = 0, 1, 2, 3
(EPI_NONE, EPI_RELU, EPI_TANH, EPI_TD, EPI_MASK, EPI_TANH_BWD, EPI_TANH_NOISE,
 EPI_TD3, EPI_C51, EPI_C51_PI,
 EPI_SAC_SAMPLE, EPI_SAC_TD, EPI_SAC_PI, EPI_SAC_ACT) = range(14)
ROWS_PER_TILE = 8         # a row task's tile: one warp a row, 8 warps a block
MAX_ATOMS = 256           # the row task keeps ceil(A / 32) <= 8 atoms a lane
# Task row fields. Segment s (s < 2) occupies F_SEG + 9*s .. + 8 as
# a_base, a_off, a_sm, a_sj, b_base, b_off, b_sj, b_sn, J:
#   C[m, n] = epi(sum_s sum_j A_s[m*a_sm + j*a_sj] * B_s[j*b_sj + n*b_sn] + bias[n])
F_OP, F_M, F_N, F_NSEG, F_SEG = 0, 1, 2, 3, 4
F_C, F_BIAS, F_EPI, F_AUX, F_AUX2 = 22, 26, 28, 29, 32   # C: base, off, sm, sn
F_TILE0, F_TILES_M, F_TILES_N = 34, 35, 36
F_ARG = 37     # EPI_SAC_SAMPLE: which normal stream, 0 = eps_next, 1 = eps_cur
# Integer parameters (ip) and float parameters (fp) of a launch.
(IP_K, IP_B, IP_D, IP_OBS, IP_ACT, IP_NSTAGES, IP_NA, IP_NC,
 IP_OFF_PA, IP_OFF_PC, IP_OFF_TA, IP_OFF_TC, IP_OFF_MUA, IP_OFF_NUA,
 IP_OFF_MUC, IP_OFF_NUC, IP_OFF_GA, IP_OFF_GC, IP_OFF_QPI, IP_OFF_PART,
 IP_OFF_STEPMET, IP_OFF_STEPNORM, IP_DELAY, IP_OFF_TD01,   # TD01: -1 unless TD3
 IP_OFF_WCE,                                               # WCE: -1 unless C51
 IP_OFF_ALPHA, IP_ALPHA_AUTOTUNE, IP_OFF_LPC,              # ALPHA, LPC: -1 unless SAC
 IP_STAGE_START) = range(29)
IP_STAGE_TILES = IP_STAGE_START + MAX_STAGES + 1
IP_STAGE_TILES_SKIP = IP_STAGE_TILES + MAX_STAGES   # tiles on a no-update step
IP_COUNT = IP_STAGE_TILES_SKIP + MAX_STAGES
(FP_LR_A, FP_LR_C, FP_B1, FP_OMB1, FP_B2, FP_OMB2, FP_EPS, FP_LOG_B1,
 FP_LOG_B2, FP_TAU, FP_OMTAU, FP_INV_B, FP_INV_K, FP_NEG2_INV_B,
 FP_VMIN, FP_VMAX, FP_DZ,                                  # the C51 support
 FP_SAC_M0, FP_SAC_HW, FP_SAC_TGT_H,                       # SAC's clamp, target entropy
 FP_COUNT) = range(21)
# Which instantiation of the kernel a launch runs.
MODE_PLAIN, MODE_C51, MODE_SAC = 0, 1, 2
# Element-wise operations per parameter and step in the optimizer pass
# (Adam: moments and the bias-corrected update; Polyak), for the
# operation count.
ADAM_OPS_PER_PARAM, POLYAK_OPS_PER_PARAM = 12, 3
# Operations of C51's row tasks, for the operation count, at the work the
# function needs: per source atom of the projection in its floor/ceil form
# (locate it between two neighbours: subtract, divide, floor, ceil; split
# its mass: two subtracts, two multiplies; add into both); per atom of the
# critic's row (both softmaxes, the shifted atoms and their clip,
# log-probabilities, cross-entropy, both expectations, the cotangent) and
# of the actor's (softmax, expectation, cotangent). The kernel's own
# triangular projection does more, C51_PAIR_OPS per (i, j) pair (subtract,
# abs, divide, 1 -, max, multiply, add); that is not counted in the bound.
C51_PROJ_ATOM_OPS, C51_CRITIC_ATOM_OPS, C51_ACTOR_ATOM_OPS = 10, 23, 10
C51_PAIR_OPS = 7
# Operations of SAC's row tasks, for the operation count: per action dim
# of a sample (the clamp, exp, u, tanh, the action, the squash's log and
# the log-prob's terms and sum: 21), of the actor's cotangent (du,
# dlog_std, the clamp's backward: 15, with the sample's cached values); per
# row of the target task (min, y, two td, two cotangents, td: 10) and of
# the min gate (compares, gates, two cotangents, min: 8).
SAC_SAMPLE_DIM_OPS, SAC_ACT_DIM_OPS, SAC_TD_ROW_OPS, SAC_PI_ROW_OPS = 21, 15, 10, 8


def supported(config: DDPGConfig) -> bool:
    """The JAX kernel's envelope (fused_chunk.py:167-180): DDPG TD(0), TD3,
    C51 and SAC, each in float32 or bfloat16. The route also needs
    fits_vmem."""
    return (
        config.action_insert_layer == 1
        and config.critic_l2 == 0.0
        and not config.fused_update
        and config.compute_dtype in ("float32", "bfloat16")
        and len(config.critic_hidden) >= 2
        and len(config.actor_hidden) >= 1
        and (not config.distributional or config.num_atoms <= MAX_ATOMS)
    )


def state_vmem_bytes(config: DDPGConfig, obs_dim: int, act_dim: int) -> int:
    """f32 bytes of the JAX kernel's VMEM-resident state (fused_chunk.py:
    132-157): params, targets and both Adam moments of the actor and the
    critic group, 16 (a + c) for a actor and c critic-group floats; the
    C51 head is num_atoms wide, TD3's and SAC's critic an ensemble of two,
    SAC's actor head [mean | log_std]. SAC's temperature is not counted."""

    def net(dims, extra_in=0):
        total = 0
        for i in range(len(dims) - 1):
            d_in = dims[i] + (extra_in if i == 1 else 0)
            total += d_in * dims[i + 1] + dims[i + 1]
        return total

    out = config.num_atoms if config.distributional else 1
    head = 2 * act_dim if config.sac else act_dim
    a = net([obs_dim, *config.actor_hidden, head])
    c = net([obs_dim, *config.critic_hidden, out], extra_in=act_dim)
    if config.twin_critic or config.sac:
        c *= 2
    return 4 * (4 * a + 4 * c)


# The JAX kernel's budget for that state (fused_chunk.py:160-162). This
# kernel keeps its state in device memory and has no such limit, but the
# route follows the JAX learner's gate, so both packages take their kernel
# on the same configs.
VMEM_STATE_BUDGET = 6 * 1024 * 1024


def fits_vmem(config: DDPGConfig, obs_dim: int, act_dim: int) -> bool:
    return state_vmem_bytes(config, obs_dim, act_dim) <= VMEM_STATE_BUDGET


def _atoms(config: DDPGConfig) -> int:
    """Width of the critic's head: num_atoms under D4PG, else 1."""
    return int(config.num_atoms) if config.distributional else 1


def support_params(config: DDPGConfig):
    """(z[A] as float32, [v_min, v_max, dz] as float32) for the C51 kernel
    and its plain version: the row computed in float64 and rounded once,
    dz = (v_max - v_min) / (A - 1) in float64, as the JAX kernel takes it
    (a Python float, fused_chunk.py:203)."""
    A = int(config.num_atoms)
    dz = (float(config.v_max) - float(config.v_min)) / (A - 1)
    return (support_row(config.v_min, config.v_max, A),
            np.asarray([config.v_min, config.v_max, dz], np.float32))


# --- layouts ----------------------------------------------------------------


def _net_dims(config: DDPGConfig, obs_dim: int, act_dim: int):
    """[(in, out)] per layer for the actor and the critic (action at
    critic layer 1; num_atoms outputs under D4PG; SAC's actor head is
    [mean | log_std], 2 * act_dim)."""
    ah, ch = list(config.actor_hidden), list(config.critic_hidden)
    head = 2 * act_dim if config.sac else act_dim
    actor = list(zip([obs_dim] + ah, ah + [head]))
    critic = list(zip([obs_dim, ch[0] + act_dim] + ch[1:], ch + [_atoms(config)]))
    return actor, critic


def _layer_offsets(dims) -> Tuple[List[Tuple[int, int]], int]:
    """(w_off, b_off) per layer of one net flattened w0, b0, w1, b1, ...;
    and the net's element count."""
    offs, n = [], 0
    for i, o in dims:
        offs.append((n, n + i * o))
        n += i * o + o
    return offs, n


class _Program(NamedTuple):
    tasks: np.ndarray          # int32 [n_tasks, TASK_INTS], ordered by stage
    stage_start: List[int]     # n_stages + 1 task indices
    stage_tiles: List[int]     # tiles per stage
    stage_tiles_skip: List[int]  # tiles per stage on a step without an actor update
    scratch: Dict[str, int]    # buffer name -> offset in the scratch tensor
    scratch_size: int          # floats before the per-launch metric area
    n_actor: int
    n_critic: int              # the critic group: both members under TD3
    matmul_flops: int          # per learner step, run every step
    actor_bwd_flops: int       # per actor update (every step but under TD3's delay)
    sum_flops: Tuple[int, int]  # the bias gradients' part of the two above
    row_ops: int               # per learner step: C51's row tasks (0 otherwise)


def _plan(config: DDPGConfig, obs_dim: int, act_dim: int) -> _Program:
    """The kernel's per-step program for these net shapes and this batch."""
    B, o, a = int(config.batch_size), int(obs_dim), int(act_dim)
    D = 2 * o + a + 3
    twin = bool(config.twin_critic)
    c51 = bool(config.distributional)
    sac = bool(config.sac)
    A = _atoms(config)                           # the critic head's width
    adims, cdims = _net_dims(config, o, a)
    aoffs, n_a = _layer_offsets(adims)
    coffs, n_c = _layer_offsets(cdims)           # one critic member
    ncg = 2 * n_c if twin or sac else n_c        # the critic group
    na, nc = len(adims), len(cdims)
    F = cdims[0][1]                              # critic features before the action
    # State groups: actor, critic, target actor, target critic, actor mu,
    # actor nu, critic mu, critic nu (the order the wrapper flattens); a
    # TD3 or SAC critic group is all of member 0's layers, then member 1's.
    PA, PC, TA, TC = 0, n_a, n_a + ncg, 2 * n_a + ncg
    scratch: Dict[str, int] = {}
    size = [0]

    def buf(name: str, n: int) -> int:
        if name not in scratch:
            scratch[name] = size[0]
            size[0] += n
        return scratch[name]

    buf("g_a", n_a)
    buf("g_c", ncg)
    # The actor's cotangent at the critic's head: the constant -1/B, filled
    # by the wrapper, or under C51 [B, A] from the actor's row task; under
    # SAC the min gate's [2, B], one row a member.
    buf("dqpi", 2 * B if sac else B * A)
    if twin or sac:
        # The TD3 (SAC) task reads the four heads q'0, q'1, q0, q1 (and,
        # under SAC, the target sample's log-prob lp') and writes dq0, dq1,
        # td0, td1: blocks of rows B apart.
        heads, outs = buf("q4", (5 if sac else 4) * B), buf("td3", 4 * B)
        for i, name in enumerate(("ct0_q", "ct1_q", "c0_q", "c1_q", "sN_lp")[:5 if sac else 4]):
            scratch[name] = heads + i * B
        for i, name in enumerate(("dq0", "dq1", "td0", "td1")):
            scratch[name] = outs + i * B
    if sac:
        # The min gate reads both members' heads at the sampled action, one
        # [2, B] block, and writes the cotangents into dqpi's two rows.
        pi_heads = buf("pi2", 2 * B)
        scratch["pi0_q"], scratch["pi1_q"] = pi_heads, pi_heads + B
        scratch["dqpi0"], scratch["dqpi1"] = scratch["dqpi"], scratch["dqpi"] + B
    if c51:
        # The C51 row task reads the target and the online heads: one
        # [2, B, A] block, the target first.
        heads = buf("c51_q", 2 * B * A)
        scratch["ct_q"], scratch["c_q"] = heads, heads + B * A
    ready: Dict[str, int] = {}  # scratch buffer -> stage that writes it
    skipped: set = set()        # buffers written only on actor-update steps
    rows: List[Tuple[int, bool, np.ndarray]] = []
    flops = [0, 0]              # every step, actor updates only
    sums = [0, 0]               # of which bias gradients (A = BASE_ONES)

    def add(row, reads, writes, actor_bwd=False):
        stage = 1 + max([ready[r] for r in reads if r in ready], default=-1)
        if not actor_bwd and skipped & set(reads):
            raise AssertionError(f"task reads {skipped & set(reads)} a skipped step never writes")
        for w in writes:
            ready[w] = stage
        if actor_bwd:
            skipped.update(writes)
        # Under TD3 the actor's backward sorts last in its stage, so a step
        # without an actor update runs a prefix of the stage's tiles.
        rows.append((stage, actor_bwd and twin, row))
        for s in range(row[F_NSEG]):
            f = 2 * int(row[F_M]) * int(row[F_N]) * int(row[F_SEG + 9 * s + 8])
            flops[1 if actor_bwd else 0] += f
            if row[F_SEG + 9 * s] == BASE_ONES:
                sums[1 if actor_bwd else 0] += f

    def task(op, M, N, segs, c=None, bias=None, epi=EPI_NONE, aux=None, aux2=None):
        r = np.zeros(TASK_INTS, np.int32)
        r[F_OP], r[F_M], r[F_N], r[F_NSEG] = op, M, N, len(segs)
        for s, (A, Bop, J) in enumerate(segs):
            r[F_SEG + 9 * s: F_SEG + 9 * s + 9] = (*A, *Bop, J)
        r[F_C:F_C + 4] = c if c is not None else (-1, 0, 0, 0)
        r[F_BIAS:F_BIAS + 2] = bias if bias is not None else (-1, 0)
        r[F_EPI] = epi
        r[F_AUX:F_AUX + 3] = aux if aux is not None else (-1, 0, 0)
        r[F_AUX2:F_AUX2 + 2] = aux2 if aux2 is not None else (-1, 0)
        r[F_TILES_M] = -(-M // TILE)
        r[F_TILES_N] = -(-N // TILE)
        return r

    def row_task(epi, aux, c, aux2, n=A, arg=0):
        """A task with no product over B rows, one warp a row. C51: reads
        the [B, A] heads aux, writes c [B, A] and one value a row to aux2.
        SAC: see csrc/fused_chunk.cu, run_sac_rows."""
        r = task(OP_ROWS, B, n, [], c=c, epi=epi, aux=aux, aux2=aux2)
        r[F_TILES_M], r[F_TILES_N] = -(-B // ROWS_PER_TILE), 1
        r[F_ARG] = arg
        return r

    def act_of(name, cols):     # a scratch activation [B, cols] as an A operand
        return (BASE_SCRATCH, buf(name, B * cols), cols, 1)

    def col_of(col):            # a column range of the batch rows
        return (BASE_BATCH, col, D, 1)

    obs, action, nobs = col_of(0), col_of(o), col_of(o + a + 2)

    # --- forwards ---------------------------------------------------------
    def actor_fwd(prefix, group, x, x_name, head_epi=EPI_TANH):
        for i, (din, dout) in enumerate(adims):
            w_off, b_off = aoffs[i]
            last = i == na - 1
            out = f"{prefix}_u" if last else f"{prefix}_h{i + 1}"
            reads = [x_name] if x_name else []
            tanh = last and head_epi != EPI_NONE     # SAC's head is linear
            add(task(
                OP_FWD, B, dout,
                [(x, (BASE_STATE, group + w_off, dout, 1), din)],
                c=(BASE_SCRATCH, buf(out, B * dout), dout, 1),
                bias=(BASE_STATE, group + b_off),
                epi=head_epi if last else EPI_RELU,
                aux=(BASE_SCRATCH, buf(f"{prefix}_t", B * dout), dout) if tanh else None,
            ), reads, [out] + ([f"{prefix}_t"] if tanh else []))
            x, x_name = act_of(out, dout), out

    def critic_fwd(prefix, group, x, act_op, act_name, shared_h1=None, head_epi=EPI_NONE):
        """Layer 0 on x (skipped when shared_h1 names an existing layer-0
        activation), layer 1 on [h1 | action], relu hiddens, linear head."""
        h1 = shared_h1 or f"{prefix}_h1"
        if shared_h1 is None:
            w_off, b_off = coffs[0]
            add(task(
                OP_FWD, B, F, [(x, (BASE_STATE, group + w_off, F, 1), o)],
                c=(BASE_SCRATCH, buf(h1, B * F), F, 1),
                bias=(BASE_STATE, group + b_off), epi=EPI_RELU,
            ), [], [h1])
        prev = h1
        for i in range(1, nc):
            din, dout = cdims[i]
            w_off, b_off = coffs[i]
            last = i == nc - 1
            out = f"{prefix}_q" if last else f"{prefix}_h{i + 1}"
            if i == 1:
                segs = [
                    (act_of(prev, F), (BASE_STATE, group + w_off, dout, 1), F),
                    (act_op, (BASE_STATE, group + w_off + F * dout, dout, 1), a),
                ]
                reads = [prev] + ([act_name] if act_name else [])
            else:
                segs = [(act_of(prev, din), (BASE_STATE, group + w_off, dout, 1), din)]
                reads = [prev]
            extra = {}
            writes = [out]
            if last and head_epi == EPI_TD:
                # y = r + disc*q_t, td = y - q, dq = -2/B * w * td
                extra = dict(aux=(BASE_SCRATCH, buf("c_q", B), 1),
                             aux2=(BASE_SCRATCH, buf("dq", B)))
                reads = reads + ["c_q"]
                writes = writes + ["dq"]
            add(task(
                OP_FWD, B, dout, segs,
                c=(BASE_SCRATCH, buf(out, B * dout), dout, 1),
                bias=(BASE_STATE, group + b_off),
                epi=(head_epi if last else EPI_RELU), **extra,
            ), reads, writes)
            prev = out

    if sac:
        # Both Gaussian heads through the ONLINE actor: on obs (the actor's
        # loss; its activations feed the actor's backward) and on next_obs
        # (the target); then the online critics on the batch's action.
        actor_fwd("a", PA, obs, None, EPI_NONE)
        actor_fwd("an", PA, nobs, None, EPI_NONE)
        for m in range(2):
            critic_fwd(f"c{m}", PC + m * n_c, obs, action, None)
        # The samples: the action and the log-prob a row (the target's
        # log-prob into the TD task's block), from eps_next and eps_cur.
        add(row_task(EPI_SAC_SAMPLE, aux=(BASE_SCRATCH, scratch["an_u"], 2 * a),
                     c=(BASE_SCRATCH, buf("sN_a", B * a), a, 1),
                     aux2=(BASE_SCRATCH, scratch["sN_lp"]), n=a, arg=0),
            ["an_u"], ["sN_a", "sN_lp"])
        add(row_task(EPI_SAC_SAMPLE, aux=(BASE_SCRATCH, scratch["a_u"], 2 * a),
                     c=(BASE_SCRATCH, buf("sC_a", B * a), a, 1),
                     aux2=(BASE_SCRATCH, buf("sC_lp", B)), n=a, arg=1),
            ["a_u"], ["sC_a", "sC_lp"])
        for m in range(2):
            critic_fwd(f"ct{m}", TC + m * n_c, nobs, act_of("sN_a", a), "sN_a")
        for m in range(2):
            critic_fwd(f"pi{m}", PC + m * n_c, obs, act_of("sC_a", a), "sC_a",
                       shared_h1=f"c{m}_h1")
        # y = r + disc * (min(q'0, q'1) - alpha * lp'), both members'
        # cotangents and td; the min gate at the sampled action.
        add(row_task(EPI_SAC_TD, aux=(BASE_SCRATCH, heads, B),
                     c=None, aux2=(BASE_SCRATCH, outs), n=1),
            ["ct0_q", "ct1_q", "c0_q", "c1_q", "sN_lp"], ["dq0", "dq1", "td0", "td1"])
        add(row_task(EPI_SAC_PI, aux=(BASE_SCRATCH, pi_heads, B),
                     c=(BASE_SCRATCH, scratch["dqpi"], B, 1),
                     aux2=(BASE_SCRATCH, buf("pi_qmin", B)), n=1),
            ["pi0_q", "pi1_q"], ["dqpi0", "dqpi1", "pi_qmin"])
    elif twin:
        actor_fwd("at", TA, nobs, None, EPI_TANH_NOISE if config.takes_noise else EPI_TANH)
        for m in range(2):
            critic_fwd(f"c{m}", PC + m * n_c, obs, action, None)
        for m in range(2):
            critic_fwd(f"ct{m}", TC + m * n_c, nobs, act_of("at_u", a), "at_u")
        # Min-over-ensemble target, both members' cotangents and td: an
        # element-wise task (no product) once all four heads exist.
        add(task(OP_FWD, B, 1, [], epi=EPI_TD3,
                 aux=(BASE_SCRATCH, heads, B), aux2=(BASE_SCRATCH, outs)),
            ["ct0_q", "ct1_q", "c0_q", "c1_q"], ["dq0", "dq1", "td0", "td1"])
        actor_fwd("a", PA, obs, None)
        critic_fwd("pi", PC, obs, act_of("a_u", a), "a_u", shared_h1="c0_h1")
    else:
        actor_fwd("at", TA, nobs, None)
        critic_fwd("c", PC, obs, action, None)
        critic_fwd("ct", TC, nobs, act_of("at_u", a), "at_u",
                   head_epi=EPI_NONE if c51 else EPI_TD)
        actor_fwd("a", PA, obs, None)
        critic_fwd("pi", PC, obs, act_of("a_u", a), "a_u", shared_h1="c_h1")
    if c51:
        # Once the heads exist: the critic's row task (target softmax,
        # projection, cross-entropy, td, dq) and the actor's (softmax,
        # E[Z], dq_pi), one warp a row.
        add(row_task(EPI_C51, aux=(BASE_SCRATCH, heads, A),
                     c=(BASE_SCRATCH, buf("dq", B * A), A, 1),
                     aux2=(BASE_SCRATCH, buf("c51_wce", B))),
            ["ct_q", "c_q"], ["dq", "c51_wce"])
        add(row_task(EPI_C51_PI, aux=(BASE_SCRATCH, scratch["pi_q"], A),
                     c=(BASE_SCRATCH, scratch["dqpi"], A, 1),
                     aux2=(BASE_SCRATCH, buf("pi_qexp", B))),
            ["pi_q"], ["dqpi", "pi_qexp"])

    # --- backwards --------------------------------------------------------
    def dw(x, x_name, rows, r0, dz_name, dout, g_off, b_goff=None, actor_bwd=False):
        """gW[r0:r0+rows, :] = x^T dz (and gb = 1^T dz when b_goff)."""
        dz = (BASE_SCRATCH, scratch[dz_name], dout, 1)
        reads = [dz_name] + ([x_name] if x_name else [])
        xt = (x[0], x[1], 1, x[2])   # A(m=row, j=b) = x[b*ld + row]
        add(task(OP_DW, rows, dout, [(xt, dz, B)],
                 c=(BASE_SCRATCH, g_off + r0 * dout, dout, 1)), reads, [], actor_bwd)
        if b_goff is not None:
            add(task(OP_DW, 1, dout, [((BASE_ONES, 0, 0, 0), dz, B)],
                     c=(BASE_SCRATCH, b_goff, dout, 1)), [dz_name], [], actor_bwd)

    def dx(dz_name, dout, group, w_off, r0, rows, out, epi, aux_name, actor_bwd=False):
        """out[b, r] = epi(sum_n dz[b, n] * W[r0 + r, n])."""
        add(task(
            OP_DX, B, rows,
            [((BASE_SCRATCH, scratch[dz_name], dout, 1),
              (BASE_STATE, group + w_off + r0 * dout, 1, dout), dout)],
            c=(BASE_SCRATCH, buf(out, B * rows), rows, 1), epi=epi,
            aux=(BASE_SCRATCH, scratch[aux_name], rows),
        ), [dz_name, aux_name], [out], actor_bwd)

    ga, gc = scratch["g_a"], scratch["g_c"]

    def critic_bwd(prefix, group, g, dq):
        """A member's TD cotangent dq back to layer 0, weight gradients all
        the way (into g, the member's part of the gradient buffer)."""
        dz = dq
        for i in range(nc - 1, -1, -1):
            din, dout = cdims[i]
            w_off, b_off = coffs[i]
            if i == 0:
                dw(obs, None, o, 0, dz, dout, g + w_off, g + b_off)
            elif i == 1:
                dw(act_of(f"{prefix}_h1", F), f"{prefix}_h1", F, 0, dz, dout,
                   g + w_off, g + b_off)
                dw(action, None, a, F, dz, dout, g + w_off)
            else:
                dw(act_of(f"{prefix}_h{i}", din), f"{prefix}_h{i}", din, 0, dz, dout,
                   g + w_off, g + b_off)
            if i >= 1:
                dx(dz, dout, group, w_off, 0, F if i == 1 else din, f"{prefix}_dz{i - 1}",
                   EPI_MASK, f"{prefix}_h{i}")
                dz = f"{prefix}_dz{i - 1}"

    if twin or sac:
        for m in range(2):
            critic_bwd(f"c{m}", PC + m * n_c, gc + m * n_c, f"dq{m}")
    else:
        critic_bwd("c", PC, gc, "dq")
    if sac:
        # Both members' gated cotangents back to the sampled action, through
        # the pre-update critics; one task of two segments sums them
        # through each member's W1 action rows: da = da0 + da1.
        dzs = []
        for m in range(2):
            dz = f"dqpi{m}"
            for i in range(nc - 1, 1, -1):
                din, dout = cdims[i]
                dx(dz, dout, PC + m * n_c, coffs[i][0], 0, din, f"pi{m}_dz{i - 1}",
                   EPI_MASK, f"pi{m}_h{i}", actor_bwd=True)
                dz = f"pi{m}_dz{i - 1}"
            dzs.append(dz)
        d1 = cdims[1][1]
        add(task(OP_DX, B, a, [
            ((BASE_SCRATCH, scratch[dzs[m]], d1, 1),
             (BASE_STATE, PC + m * n_c + coffs[1][0] + F * d1, 1, d1), d1) for m in range(2)],
            c=(BASE_SCRATCH, buf("sC_da", B * a), a, 1)), dzs, ["sC_da"], actor_bwd=True)
        # The cotangent at the actor's [mean | log_std_raw] head.
        add(row_task(EPI_SAC_ACT, aux=(BASE_SCRATCH, scratch["a_u"], 2 * a),
                     c=(BASE_SCRATCH, buf(f"a_dz{na - 1}", B * 2 * a), 2 * a, 1),
                     aux2=(BASE_SCRATCH, scratch["sC_da"]), n=a, arg=1),
            ["a_u", "sC_da"], [f"a_dz{na - 1}"], actor_bwd=True)
    else:
        # Actor pass through the pre-update critic (TD3: member 0, the first
        # in the group) to the action: dL/dq = -1/B (C51: the row task's dq_pi).
        dz = "dqpi"
        for i in range(nc - 1, 1, -1):
            din, dout = cdims[i]
            dx(dz, dout, PC, coffs[i][0], 0, din, f"pi_dz{i - 1}", EPI_MASK, f"pi_h{i}",
               actor_bwd=True)
            dz = f"pi_dz{i - 1}"
        # da through W1's action rows, chained through tanh*scale in the epilogue.
        dx(dz, cdims[1][1], PC, coffs[1][0], F, a, f"a_dz{na - 1}", EPI_TANH_BWD, "a_t",
           actor_bwd=True)
    dz = f"a_dz{na - 1}"
    for i in range(na - 1, -1, -1):
        din, dout = adims[i]
        w_off, b_off = aoffs[i]
        if i == 0:
            dw(obs, None, o, 0, dz, dout, ga + w_off, ga + b_off, actor_bwd=True)
        else:
            dw(act_of(f"a_h{i}", din), f"a_h{i}", din, 0, dz, dout,
               ga + w_off, ga + b_off, actor_bwd=True)
            dx(dz, dout, PA, w_off, 0, din, f"a_dz{i - 1}", EPI_MASK, f"a_h{i}",
               actor_bwd=True)
            dz = f"a_dz{i - 1}"

    rows.sort(key=lambda r: r[:2])   # stable: keeps the order within a stage
    n_stages = rows[-1][0] + 1
    if n_stages > MAX_STAGES:
        raise ValueError(f"nets too deep for the kernel: {n_stages} stages")
    stage_start, stage_tiles = [0] * (n_stages + 1), [0] * n_stages
    stage_tiles_skip = [0] * n_stages
    for t, (s, late, r) in enumerate(rows):
        r[F_TILE0] = stage_tiles[s]
        tiles = int(r[F_TILES_M] * r[F_TILES_N])
        stage_tiles[s] += tiles
        if not late:
            stage_tiles_skip[s] += tiles
        stage_start[s + 1] = t + 1
    table = np.stack([r for _, _, r in rows])
    if c51:
        row_ops = B * A * (C51_PROJ_ATOM_OPS + C51_CRITIC_ATOM_OPS + C51_ACTOR_ATOM_OPS)
    elif sac:
        row_ops = B * (a * (2 * SAC_SAMPLE_DIM_OPS + SAC_ACT_DIM_OPS)
                       + SAC_TD_ROW_OPS + SAC_PI_ROW_OPS)
    else:
        row_ops = 0
    return _Program(
        tasks=table, stage_start=stage_start, stage_tiles=stage_tiles,
        stage_tiles_skip=stage_tiles_skip, scratch=scratch, scratch_size=size[0],
        n_actor=n_a, n_critic=ncg, matmul_flops=flops[0], actor_bwd_flops=flops[1],
        sum_flops=(sums[0], sums[1]), row_ops=row_ops,
    )


def actor_updates(config: DDPGConfig, step0, k: int):
    """Actor (and Polyak) updates among the steps step0 .. step0 + k - 1:
    all k, or under TD3 those with step % policy_delay == 0, which number
    f(step0 + k) - f(step0) with f(n) = ceil(n / policy_delay). step0 may
    be an int or an integer tensor (then so is the result)."""
    d = int(config.policy_delay)   # 1 unless TD3 (config gate)
    return (step0 + k + d - 1) // d - (step0 + d - 1) // d


def _alpha_slots(config: DDPGConfig) -> int:
    """State floats after the 8 groups: SAC's log_alpha, and its Adam
    moments when autotuned."""
    return (3 if config.sac_autotune else 1) if config.sac else 0


def _alpha_adam(config: DDPGConfig) -> int:
    """Scalars the temperature's Adam updates each step (SAC autotune)."""
    return 1 if config.sac and config.sac_autotune else 0


def ops_per_chunk(config: DDPGConfig, obs_dim: int, act_dim: int, chunk: int,
                  step0: int = 0) -> int:
    """Floating-point operations the kernel does for one chunk that starts
    at global step step0: the program's matrix products, the row tasks
    (C51's, SAC's), the critic's Adam and SAC's temperature Adam every
    step; the actor's backward, its Adam and every Polyak update on the
    steps that update the actor."""
    prog = _plan(config, obs_dim, act_dim)
    updates = actor_updates(config, int(step0), chunk)
    every = (prog.matmul_flops + prog.row_ops
             + ADAM_OPS_PER_PARAM * (prog.n_critic + _alpha_adam(config)))
    per_update = (prog.actor_bwd_flops + ADAM_OPS_PER_PARAM * prog.n_actor
                  + POLYAK_OPS_PER_PARAM * (prog.n_actor + prog.n_critic))
    return chunk * every + updates * per_update


def rounded_product_ops(config: DDPGConfig, obs_dim: int, act_dim: int, chunk: int,
                        step0: int = 0) -> int:
    """The part of ops_per_chunk that is products whose operands a bf16
    chunk rounds: every product but the bias gradients' sums."""
    prog = _plan(config, obs_dim, act_dim)
    updates = actor_updates(config, int(step0), chunk)
    return (chunk * (prog.matmul_flops - prog.sum_flops[0])
            + updates * (prog.actor_bwd_flops - prog.sum_flops[1]))


def state_bytes(config: DDPGConfig, obs_dim: int, act_dim: int) -> int:
    """f32 bytes of params, targets and both Adam moments of both nets (and
    SAC's temperature)."""
    prog = _plan(config, obs_dim, act_dim)
    return 16 * (prog.n_actor + prog.n_critic) + 4 * _alpha_slots(config)


TD3_NOISE_SALT = 0x7D3AF   # the JAX package's td3 base key: PRNGKey(seed ^ salt)


def td3_noise_eps(config: DDPGConfig, generator: torch.Generator, step0: int,
                  chunk: int, batch: int, act_dim: int) -> torch.Tensor:
    """A chunk's TD3 target-smoothing noise [K, B, act]:
    clip(target_noise * N(0, 1), +-target_noise_clip), drawn on the
    generator's device. The generator is first reseeded from
    (config.seed ^ 0x7D3AF, step0), so a chunk's draw depends only on the
    seed and the global step it starts at, as the JAX package keys its
    stream by fold_in(PRNGKey(seed ^ 0x7D3AF), step). The numbers are not
    the JAX package's (the tests pass the JAX draw in)."""
    base = (int(config.seed) ^ TD3_NOISE_SALT) & 0xFFFFFFFF
    generator.manual_seed((base << 32) | (int(step0) & 0xFFFFFFFF))
    z = torch.randn((chunk, batch, act_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return torch.clamp(config.target_noise * z, -config.target_noise_clip,
                       config.target_noise_clip)


SAC_NOISE_SALT = 0x5AC0    # the JAX package's SAC base key: PRNGKey(seed ^ salt)


def sac_noise_eps(config: DDPGConfig, generator: torch.Generator, step0: int,
                  chunk: int, batch: int, act_dim: int):
    """A chunk's SAC standard normals (eps_next, eps_cur), each [K, B, act],
    drawn on the generator's device: eps_next for the critic target's
    sample a' ~ pi(.|s'), eps_cur for the actor's a ~ pi(.|s). The
    generator is first reseeded from (config.seed ^ 0x5AC0, step0), as
    td3_noise_eps is, so a chunk's draw depends only on the seed and the
    global step it starts at (the JAX package keys its stream by
    fold_in(PRNGKey(seed ^ 0x5AC0), step)). The numbers are not the JAX
    package's (the tests pass the JAX draw in). The two are views of one
    [2, K, B, act] tensor."""
    base = (int(config.seed) ^ SAC_NOISE_SALT) & 0xFFFFFFFF
    generator.manual_seed((base << 32) | (int(step0) & 0xFFFFFFFF))
    z = torch.randn((2, chunk, batch, act_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return z[0], z[1]


# --- the plain PyTorch version ----------------------------------------------


def c51_projection(p_t, rew, disc, z, v_min: float, v_max: float, dz: float):
    """The kernel's projection of the shifted target distribution p_t
    [B, A] onto the support z [A]: proj_j = sum_i p_t[i] * relu(1 -
    |tz_i - z_j| / dz) with tz = clip(rew + disc * z, v_min, v_max),
    accumulated over i in ascending order (the JAX kernel's triangular
    form, fused_chunk.py:626-632). rew and disc are [B, 1]."""
    tz = torch.clamp(rew + disc * z, v_min, v_max)
    tri = torch.relu(1.0 - torch.abs(tz[:, :, None] - z) / dz)   # [B, i, j]
    proj = torch.zeros_like(p_t)
    for i in range(z.shape[0]):
        proj = proj + p_t[:, i:i + 1] * tri[:, i]
    return proj


def fused_chunk_reference(config: DDPGConfig, state: TrainState, packed: torch.Tensor,
                          action_scale, action_offset=0.0, eps=None):
    """K learner steps written out by hand, step by step as the kernel
    does them. `packed` is [K, B, 2*obs+act+3]; `eps` is TD3's smoothing
    noise [K, B, act], given exactly when twin_critic and target_noise > 0,
    or under SAC the normals (eps_next, eps_cur), each [K, B, act].
    Under D4PG the support is config's (v_min, v_max, num_atoms), resolved.
    Under SAC the log-prob's Gaussian term is -eps^2 / 2, the JAX kernel's
    form (the eager step's ((u - mean) / std)^2 agrees to the ULP).
    Returns (new_state, td[K, B], metrics {METRIC_KEYS: 0-d tensors, chunk
    means})."""
    K, B, D = packed.shape
    dev = packed.device
    twin = bool(config.twin_critic)
    c51 = bool(config.distributional)
    sac = bool(config.sac)
    config.check_noise(eps)
    if c51:
        if config.v_support_auto:
            raise ValueError("the C51 support is still 'auto': resolve v_min/v_max first")
        z_row, _ = support_params(config)
        z = torch.as_tensor(z_row, device=dev, dtype=packed.dtype)
        dz = (config.v_max - config.v_min) / (config.num_atoms - 1)   # a Python float
    delay = int(config.policy_delay)
    step0 = int(state.step)
    o = state.actor_params[0]["w"].shape[0]
    a = D - 2 * o - 3
    f32 = torch.float32
    scale = torch.as_tensor(np.asarray(action_scale, np.float32), device=dev).expand(a)
    offset = torch.as_tensor(np.asarray(action_offset, np.float32), device=dev).expand(a)
    inv_b, inv_k = 1.0 / B, 1.0 / K
    log_b1 = torch.tensor(math.log(B1), dtype=f32, device=dev)
    log_b2 = torch.tensor(math.log(B2), dtype=f32, device=dev)

    def copy(t):
        return [[layer["w"].clone(), layer["b"].clone()] for layer in t]

    def members(t):     # a critic group as a list of member nets
        if not (twin or sac):
            return [copy(t)]
        return [[[layer["w"][m].clone(), layer["b"][m].clone()] for layer in t]
                for m in range(2)]

    A, TAp = copy(state.actor_params), copy(state.target_actor_params)
    AMU, ANU = copy(state.actor_opt.mu), copy(state.actor_opt.nu)
    C, TCp = members(state.critic_params), members(state.target_critic_params)
    CMU, CNU = members(state.critic_opt.mu), members(state.critic_opt.nu)
    if sac:
        autotune = state.alpha_opt is not None
        log_alpha = state.log_alpha.clone()
        al_mu = al_nu = None
        if autotune:
            al_mu, al_nu = state.alpha_opt.mu.clone(), state.alpha_opt.nu.clone()
        m0 = float(config.sac_log_std_min)
        hw = 0.5 * (float(config.sac_log_std_max) - m0)
        tgt_h = sac_target_entropy(config.target_entropy, a, action_scale)
        half_log_2pi = 0.5 * math.log(2.0 * math.pi)

    if config.compute_dtype == "bfloat16":
        # The JAX kernel's `cast` (fused_chunk.py:221-235): both operands of
        # every product rounded to bf16, the f32 sum kept. The bias
        # gradients (dz.sum(0)) are sums, not products, and round nothing.
        def mm(x, y):
            return round_bf16(x) @ round_bf16(y)
    else:
        def mm(x, y):
            return x @ y

    def actor_fwd(P, x):
        acts = [x]
        for w, b in P[:-1]:
            acts.append(torch.relu(mm(acts[-1], w) + b))
        t = torch.tanh(mm(acts[-1], P[-1][0]) + P[-1][1])
        return t * scale + offset, acts, t

    def gauss_fwd(P, x):
        """SAC's head: (mean, log_std, tanh(raw), activations)."""
        acts = [x]
        for w, b in P[:-1]:
            acts.append(torch.relu(mm(acts[-1], w) + b))
        z = mm(acts[-1], P[-1][0]) + P[-1][1]
        tr = torch.tanh(z[:, a:])
        return z[:, :a], m0 + hw * (tr + 1.0), tr, acts

    def sample(mean, log_std, e):
        """(std, tanh(u), action, the squash's g, log-prob [B, 1])."""
        std = torch.exp(log_std)
        t = torch.tanh(mean + std * e)
        g = scale * (1.0 - t * t) + TANH_EPS
        lp = torch.sum(-0.5 * (e * e) - log_std - half_log_2pi - torch.log(g), -1, keepdim=True)
        return std, t, t * scale + offset, g, lp

    def critic_fwd(P, x, act):
        f = P[0][0].shape[1]
        h = torch.relu(mm(x, P[0][0]) + P[0][1])
        acts = [x, h]
        h = torch.relu(mm(h, P[1][0][:f]) + mm(act, P[1][0][f:]) + P[1][1])
        acts.append(h)
        for w, b in P[2:-1]:
            acts.append(torch.relu(mm(acts[-1], w) + b))
        return mm(acts[-1], P[-1][0]) + P[-1][1], acts      # q: [B, 1]

    def critic_bwd(P, acts, act, dq, wgrads: bool):
        """(grads [[gw, gb]] or None, d_action)."""
        n = len(P)
        grads = [None] * n
        dz = dq
        for i in range(n - 1, 1, -1):
            if wgrads:
                grads[i] = [mm(acts[i].T, dz), dz.sum(0)]
            dz = (mm(dz, P[i][0].T)) * (acts[i] > 0.0)
        f = acts[1].shape[-1]
        w1 = P[1][0]
        da = mm(dz, w1[f:].T)
        if not wgrads:
            return None, da
        grads[1] = [torch.cat([mm(acts[1].T, dz), mm(act.T, dz)], 0), dz.sum(0)]
        dz0 = (mm(dz, w1[:f].T)) * (acts[1] > 0.0)
        grads[0] = [mm(acts[0].T, dz0), dz0.sum(0)]
        return grads, da

    def actor_bwd(P, acts, dz):
        n = len(P)
        grads = [None] * n
        for i in range(n - 1, -1, -1):
            grads[i] = [mm(acts[i].T, dz), dz.sum(0)]
            if i > 0:
                dz = (mm(dz, P[i][0].T)) * (acts[i] > 0.0)
        return grads

    def adam(P, MU, NU, grads, lr, t):
        """Adam with the kernel's bias correction 1 - exp(t log B)."""
        t = t.to(f32)
        bc1 = 1.0 - torch.exp(t * log_b1)
        bc2 = 1.0 - torch.exp(t * log_b2)
        for layer, m_l, v_l, g_l in zip(P, MU, NU, grads):
            for j in range(2):
                g = g_l[j]
                m = B1 * m_l[j] + (1.0 - B1) * g
                v = B2 * v_l[j] + (1.0 - B2) * (g * g)
                m_l[j], v_l[j] = m, v
                layer[j] = layer[j] - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS)

    def polyak(P, T):
        for layer, t_l in zip(P, T):
            for j in range(2):
                t_l[j] = config.tau * layer[j] + (1.0 - config.tau) * t_l[j]

    def sq(grads):
        return sum(torch.sum(g * g) for pair in grads for g in pair)

    def softmax(logits):
        e = torch.exp(logits - torch.max(logits, -1, keepdim=True).values)
        return e / torch.sum(e, -1, keepdim=True)

    def sac_step(k, obs, act, rew, disc, nobs, wgt):
        """One SAC step, in the JAX kernel's order; returns (the 6 metric
        values, td [B, 1], the grads)."""
        nonlocal log_alpha, al_mu, al_nu
        alpha = torch.exp(log_alpha)
        # The critic: y = r + disc * (min(q'0, q'1) - alpha * lp'), a' from
        # the online actor on next_obs; both members' TD updates.
        mean_n, log_std_n, _, _ = gauss_fwd(A, nobs)
        _, _, a_n, _, lp_n = sample(mean_n, log_std_n, eps[0][k])
        q_t = torch.minimum(critic_fwd(TCp[0], nobs, a_n)[0], critic_fwd(TCp[1], nobs, a_n)[0])
        y = rew + disc * (q_t - alpha * lp_n)
        c_grads, wtd2, td_m = [], [], []
        for P in C:
            q, c_acts = critic_fwd(P, obs, act)
            td = y - q
            td_m.append(td)
            wtd2.append(torch.sum(wgt * td * td))
            c_grads.append(critic_bwd(P, c_acts, act, (-inv_b) * wgt * td, True)[0])
        closs = sum(wtd2) * (0.5 * inv_b)
        td = 0.5 * (td_m[0] + td_m[1])
        # The actor: E[alpha * lp - min_m Q_m(s, a)] through the pre-update
        # critics; the min gate splits ties 0.5/0.5.
        e_c = eps[1][k]
        mean_c, log_std_c, tr_c, a_acts = gauss_fwd(A, obs)
        std_c, t_c, a_c, g_c, lp_c = sample(mean_c, log_std_c, e_c)
        q_pi0, pia0 = critic_fwd(C[0], obs, a_c)
        q_pi1, pia1 = critic_fwd(C[1], obs, a_c)
        mean_lp = torch.sum(lp_c) * inv_b
        aloss = alpha * mean_lp - torch.sum(torch.minimum(q_pi0, q_pi1)) * inv_b
        lt, gt = (q_pi0 < q_pi1).to(q_pi0.dtype), (q_pi0 > q_pi1).to(q_pi0.dtype)
        gate0 = lt + 0.5 * (1.0 - lt - gt)
        _, da0 = critic_bwd(C[0], pia0, a_c, (-inv_b) * gate0, False)
        _, da1 = critic_bwd(C[1], pia1, a_c, (-inv_b) * (1.0 - gate0), False)
        # Through the sample (du/dmean = 1, du/dlog_std = std * eps), the
        # log-prob (d lp/d log_std = -1; only -log g carries u) and the
        # clamp log_std = m0 + hw * (tanh(raw) + 1).
        dlp_row = alpha * inv_b
        one_m_t2 = 1.0 - t_c * t_c
        du = (da0 + da1) * scale * one_m_t2 + dlp_row * (2.0 * scale * t_c * one_m_t2 / g_c)
        dlog_std = du * std_c * e_c - dlp_row
        draw = dlog_std * (hw * (1.0 - tr_c * tr_c))
        a_grads = actor_bwd(A, a_acts, torch.cat([du, draw], -1))
        # Adam (critic, actor), Polyak (both targets, every step), then the
        # temperature's Adam at critic_lr on its own count.
        c_t = state.critic_opt.count + k + 1
        for P, MU, NU, g in zip(C, CMU, CNU, c_grads):
            adam(P, MU, NU, g, config.critic_lr, c_t)
        adam(A, AMU, ANU, a_grads, config.actor_lr, state.actor_opt.count + k + 1)
        for P, T in zip(C, TCp):
            polyak(P, T)
        polyak(A, TAp)
        if autotune:
            al_g = -(mean_lp + tgt_h)
            t = (state.alpha_opt.count + k + 1).to(log_alpha.dtype)
            bc1, bc2 = 1.0 - torch.exp(t * log_b1), 1.0 - torch.exp(t * log_b2)
            al_mu = B1 * al_mu + (1.0 - B1) * al_g
            al_nu = B2 * al_nu + (1.0 - B2) * (al_g * al_g)
            log_alpha = log_alpha - config.critic_lr * (al_mu / bc1) / (
                torch.sqrt(al_nu / bc2) + EPS)
        vals = torch.stack([
            closs, aloss, alpha * mean_lp - aloss, torch.sum(torch.abs(td)) * inv_b,
            torch.sqrt(sum(sq(g) for g in c_grads)), torch.sqrt(sq(a_grads)),
        ])
        return vals, td, a_grads, c_grads

    met = torch.zeros(len(METRIC_KEYS), dtype=f32, device=dev)
    tds = []
    with torch.no_grad():
        for k in range(K):
            x = packed[k]
            obs, act = x[:, :o], x[:, o:o + a]
            rew, disc = x[:, o + a:o + a + 1], x[:, o + a + 1:o + a + 2]
            nobs, wgt = x[:, o + a + 2:2 * o + a + 2], x[:, 2 * o + a + 2:]
            if sac:
                vals, td, a_grads, c_grads = sac_step(k, obs, act, rew, disc, nobs, wgt)
                met = met + vals * inv_k
                tds.append(td[:, 0])
                continue
            u_t, _, _ = actor_fwd(TAp, nobs)
            if eps is not None:
                u_t = torch.minimum(torch.maximum(u_t + eps[k], offset - scale),
                                    offset + scale)
            q_t = critic_fwd(TCp[0], nobs, u_t)[0]
            if c51:
                # The target distribution projected onto the support with
                # the triangular kernel, accumulated over i in ascending
                # order; cross-entropy, td = E_proj[z] - E_p[z] and the
                # cotangent (p - proj) * w / B at the online head.
                proj = c51_projection(softmax(q_t), rew, disc, z, config.v_min,
                                      config.v_max, dz)
                q, c_acts = critic_fwd(C[0], obs, act)
                m_q = torch.max(q, -1, keepdim=True).values
                e_q = torch.exp(q - m_q)
                sum_q = torch.sum(e_q, -1, keepdim=True)
                p_q = e_q / sum_q
                ce = -torch.sum(proj * (q - (m_q + torch.log(sum_q))), -1, keepdim=True)
                closs = torch.sum(wgt * ce) * inv_b
                td = torch.sum(proj * z, -1, keepdim=True) - torch.sum(p_q * z, -1, keepdim=True)
                c_grads = [critic_bwd(C[0], c_acts, act, (p_q - proj) * (wgt * inv_b), True)[0]]
            else:
                if twin:
                    q_t = torch.minimum(q_t, critic_fwd(TCp[1], nobs, u_t)[0])
                y = rew + disc * q_t
                # Each member's TD error and weight gradients. DDPG: dL/dq =
                # -2/B * w * td; TD3 (the mean over [2, B]): -1/B * w * td_m.
                cot = -inv_b if twin else -2.0 * inv_b
                c_grads, wtd2, td_m = [], [], []
                for P in C:
                    q, c_acts = critic_fwd(P, obs, act)
                    td = y - q
                    td_m.append(td)
                    wtd2.append(torch.sum(wgt * td * td))
                    c_grads.append(critic_bwd(P, c_acts, act, cot * wgt * td, True)[0])
                closs = sum(wtd2) * (inv_b / len(C))
                td = 0.5 * (td_m[0] + td_m[1]) if twin else td_m[0]
            u, a_acts, t_u = actor_fwd(A, obs)
            q_pi, pi_acts = critic_fwd(C[0], obs, u)
            if c51:
                # L_a = -mean E[Z]; the softmax's Jacobian in closed form:
                # dL/dlogit_j = -(1/B) p_j (z_j - E[Z]).
                p_pi = softmax(q_pi)
                q_exp = torch.sum(p_pi * z, -1, keepdim=True)
                dq_pi = ((-inv_b) * p_pi) * (z - q_exp)
                aloss = -torch.sum(q_exp) * inv_b
            else:
                dq_pi = torch.full_like(q_pi, -inv_b)
                aloss = -torch.sum(q_pi) * inv_b
            update = (step0 + k) % delay == 0
            if update:   # the actor's gradient, through the pre-update critic
                _, da = critic_bwd(C[0], pi_acts, u, dq_pi, False)
                a_grads = actor_bwd(A, a_acts, da * scale * (1.0 - t_u * t_u))
            c_t = state.critic_opt.count + k + 1
            for P, MU, NU, g in zip(C, CMU, CNU, c_grads):
                adam(P, MU, NU, g, config.critic_lr, c_t)
            if update:
                a_t = state.actor_opt.count + actor_updates(config, step0, k) + 1
                for P, T in zip(C, TCp):
                    polyak(P, T)
                adam(A, AMU, ANU, a_grads, config.actor_lr, a_t)
                polyak(A, TAp)
            a_norm = torch.sqrt(sq(a_grads)) if update else torch.zeros((), dtype=f32, device=dev)
            vals = torch.stack([
                closs, aloss, -aloss, torch.sum(torch.abs(td)) * inv_b,
                torch.sqrt(sum(sq(g) for g in c_grads)), a_norm,
            ])
            met = met + vals * inv_k
            tds.append(td[:, 0])

    def tree(P):
        return tuple({"w": w, "b": b} for w, b in P)

    def group(Ms):
        if not (twin or sac):
            return tree(Ms[0])
        return tuple({"w": torch.stack([w0, w1]), "b": torch.stack([b0, b1])}
                     for (w0, b0), (w1, b1) in zip(*Ms))

    new_state = TrainState(
        actor_params=tree(A), critic_params=group(C),
        target_actor_params=tree(TAp), target_critic_params=group(TCp),
        actor_opt=OptState(tree(AMU), tree(ANU),
                           state.actor_opt.count + actor_updates(config, step0, K)),
        critic_opt=OptState(group(CMU), group(CNU), state.critic_opt.count + K),
        step=state.step + K,
    )
    if sac:
        new_state = new_state._replace(
            log_alpha=log_alpha,
            alpha_opt=(OptState(al_mu, al_nu, state.alpha_opt.count + K)
                       if autotune else None))
    return new_state, torch.stack(tds), dict(zip(METRIC_KEYS, met.unbind()))


# --- the wrapper --------------------------------------------------------------


def _groups(state: TrainState):
    return (
        state.actor_params, state.critic_params,
        state.target_actor_params, state.target_critic_params,
        state.actor_opt.mu, state.actor_opt.nu,
        state.critic_opt.mu, state.critic_opt.nu,
    )


_CRITIC_GROUPS = (1, 3, 6, 7)   # the _groups entries that hold critic trees


def _is_twin(state: TrainState) -> bool:
    """A TD3 or SAC state: critic leaves carry a leading [2, ...] ensemble axis."""
    return state.critic_params[0]["w"].dim() == 3


def _group_leaves(tree, twin: bool):
    """A group in the kernel's order: w0, b0, w1, b1, ...; for a TD3
    critic all of member 0's layers, then all of member 1's (the JAX
    kernel's _flatten_twin)."""
    if twin:
        return [t[m] for m in range(2) for layer in tree for t in (layer["w"], layer["b"])]
    return [t for layer in tree for t in (layer["w"], layer["b"])]


def _alpha_leaves(state: TrainState):
    """SAC's state after the 8 groups: log_alpha, then alpha_opt's mu and nu
    when the temperature is learned; nothing otherwise."""
    if state.log_alpha is None:
        return []
    if state.alpha_opt is None:
        return [state.log_alpha]
    return [state.log_alpha, state.alpha_opt.mu, state.alpha_opt.nu]


def flatten_state(state: TrainState) -> torch.Tensor:
    """The kernel's state buffer: the 8 groups in _groups order, then SAC's
    temperature slots (a copy; the input state is not touched)."""
    twin = _is_twin(state)
    return torch.cat([
        t.reshape(-1) for i, g in enumerate(_groups(state))
        for t in _group_leaves(g, twin and i in _CRITIC_GROUPS)
    ] + [t.reshape(1) for t in _alpha_leaves(state)])


def unflatten_state(flat: torch.Tensor, like: TrainState, steps, actor_steps) -> TrainState:
    """Views into `flat` shaped like `like`: the critic count, the step and
    (SAC, autotuned) the temperature's count advanced by `steps`, the actor
    count by `actor_steps`. A TD3 or SAC critic leaf [2, ...] is one
    strided view over its two members' slices; log_alpha and alpha_opt's
    moments are 0-d views of their slots."""
    twin = _is_twin(like)
    pos = [0]

    def take_group(tree, ensemble: bool):
        member = sum(layer[k][0].numel() if ensemble else layer[k].numel()
                     for layer in tree for k in ("w", "b"))
        off, out = pos[0], []
        for layer in tree:
            views = {}
            for k in ("w", "b"):
                shape = tuple(layer[k].shape)
                inner = shape[1:] if ensemble else shape
                stride = [1] * len(inner)
                for d in range(len(inner) - 2, -1, -1):
                    stride[d] = stride[d + 1] * inner[d + 1]
                if ensemble:
                    stride = [member] + stride
                views[k] = torch.as_strided(flat, shape, stride, flat.storage_offset() + off)
                off += math.prod(inner)
            out.append(views)
        pos[0] += member * (2 if ensemble else 1)
        return tuple(out)

    g = [take_group(grp, twin and i in _CRITIC_GROUPS)
         for i, grp in enumerate(_groups(like))]
    alpha = [flat[pos[0] + i] for i in range(len(_alpha_leaves(like)))]
    return TrainState(
        actor_params=g[0], critic_params=g[1],
        target_actor_params=g[2], target_critic_params=g[3],
        actor_opt=OptState(g[4], g[5], like.actor_opt.count + actor_steps),
        critic_opt=OptState(g[6], g[7], like.critic_opt.count + steps),
        step=like.step + steps,
        log_alpha=alpha[0] if alpha else None,
        alpha_opt=(OptState(alpha[1], alpha[2], like.alpha_opt.count + steps)
                   if like.alpha_opt is not None else None),
    )


def _lib():
    from distributed_ddpg_tpu_torch.ops import _build

    lib = _build.load("fused_chunk")
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        lib.fused_chunk_launch.argtypes = [ptr] * 13 + [ctypes.c_int] * 3 + [ptr]
        lib.fused_chunk_launch.restype = ctypes.c_int
        lib.fused_chunk_max_grid.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.fused_chunk_max_grid.restype = ctypes.c_int
        lib.fused_chunk_error_string.argtypes = [ctypes.c_int]
        lib.fused_chunk_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"fused_chunk {what} failed: CUDA error {code} "
            f"({lib.fused_chunk_error_string(code).decode()})"
        )


def make_fused_chunk_fn(config: DDPGConfig, obs_dim: int, act_dim: int,
                        action_scale, action_offset=0.0, chunk_size: int = 8,
                        device="cuda"):
    """Returns run(state, packed[K, B, D], eps=None) -> (new_state, td[K, B],
    metrics). `eps` is TD3's smoothing noise [K, B, act] (td3_noise_eps),
    given exactly when twin_critic and target_noise > 0, or under SAC the
    normals (eps_next, eps_cur), each [K, B, act] (sac_noise_eps).

    Under D4PG, run.set_value_bounds(v_min, v_max) moves the C51 support:
    on the card it rewrites the launch's support row and spacing in place,
    so the next launch reads them and nothing is replanned. With v_min and
    v_max 'auto', run raises until the bounds are set.

    On the CPU, run is the plain version. On the card it launches the
    kernel once per call (counted in KERNEL_LAUNCHES["fused_chunk"],
    ["fused_chunk_td3"] for TD3, ["fused_chunk_d4pg"] for D4PG or
    ["fused_chunk_sac"] for SAC, each with "_bf16" appended under
    compute_dtype='bfloat16') or raises; the input state is never
    modified."""
    if not supported(config):
        raise ValueError(
            "fused chunk kernel envelope: DDPG, TD3, D4PG (num_atoms <= 256) or "
            "SAC, float32 or bfloat16, action_insert_layer=1, critic_l2=0, "
            "fused_update=False, >=2 critic hidden layers, >=1 actor hidden layer"
        )
    if not fits_vmem(config, obs_dim, act_dim):   # the JAX kernel's message (:849-855)
        raise ValueError(
            f"fused chunk kernel: VMEM-resident state would be "
            f"{state_vmem_bytes(config, obs_dim, act_dim)} bytes "
            f"(budget {VMEM_STATE_BUDGET}); use the XLA scan path "
            f"(fused_chunk='off') for nets this large"
        )
    K, B = int(chunk_size), int(config.batch_size)
    o, a = int(obs_dim), int(act_dim)
    D = 2 * o + a + 3
    twin, c51, sac = bool(config.twin_critic), bool(config.distributional), bool(config.sac)
    bf16 = config.compute_dtype == "bfloat16"
    name = ("fused_chunk_d4pg" if c51 else "fused_chunk_td3" if twin
            else "fused_chunk_sac" if sac else "fused_chunk") + ("_bf16" if bf16 else "")
    device = torch.device(device)
    current = [config]        # set_value_bounds replaces its support bounds
    write_support = None      # on the card: rewrites the launch's support

    def set_value_bounds(v_min: float, v_max: float) -> None:
        if not c51:
            raise ValueError("set_value_bounds needs a distributional (D4PG) chunk")
        current[0] = current[0].replace(v_min=float(v_min), v_max=float(v_max))
        if write_support is not None:
            write_support(current[0])

    def resolved() -> DDPGConfig:
        if c51 and current[0].v_support_auto:
            raise ValueError(
                "the C51 support is still 'auto': set_value_bounds must resolve "
                "v_min/v_max before the first chunk")
        return current[0]

    if device.type == "cpu":
        def run_cpu(state: TrainState, packed: torch.Tensor, eps=None):
            if packed.shape != (K, B, D):
                raise ValueError(f"packed batch must be {(K, B, D)}, got {tuple(packed.shape)}")
            return fused_chunk_reference(resolved(), state, packed, action_scale,
                                         action_offset, eps)

        run_cpu.set_value_bounds = set_value_bounds
        return run_cpu
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"fused_chunk kernel needs a CUDA device, got {device}")

    lib = _lib()
    prog = _plan(config, o, a)
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    max_grid = ctypes.c_int(0)
    _check(lib, lib.fused_chunk_max_grid(dev_index, ctypes.byref(max_grid)), "occupancy query")
    sms = torch.cuda.get_device_properties(dev_index).multi_processor_count
    grid = min(int(max_grid.value), sms)
    if grid < 1:
        raise RuntimeError("fused_chunk kernel: no block fits on the card")
    n_a, n_c = prog.n_actor, prog.n_critic
    off_part = prog.scratch_size
    off_stepmet = off_part + 2 * K * grid
    off_stepnorm = off_stepmet + 4 * K
    ip = np.zeros(IP_COUNT, np.int32)
    ip[[IP_K, IP_B, IP_D, IP_OBS, IP_ACT, IP_NSTAGES, IP_NA, IP_NC]] = (
        K, B, D, o, a, len(prog.stage_tiles), n_a, n_c)
    ip[[IP_OFF_PA, IP_OFF_PC, IP_OFF_TA, IP_OFF_TC, IP_OFF_MUA, IP_OFF_NUA,
        IP_OFF_MUC, IP_OFF_NUC]] = (
        0, n_a, n_a + n_c, 2 * n_a + n_c, 2 * (n_a + n_c), 3 * n_a + 2 * n_c,
        4 * n_a + 2 * n_c, 4 * n_a + 3 * n_c)
    ip[[IP_OFF_GA, IP_OFF_GC, IP_OFF_QPI, IP_OFF_PART, IP_OFF_STEPMET,
        IP_OFF_STEPNORM]] = (
        prog.scratch["g_a"], prog.scratch["g_c"],
        prog.scratch["pi_qexp" if c51 else "pi_qmin" if sac else "pi_q"],
        off_part, off_stepmet, off_stepnorm)
    ip[[IP_DELAY, IP_OFF_TD01, IP_OFF_WCE]] = (
        config.policy_delay, prog.scratch["td0"] if twin or sac else -1,
        prog.scratch["c51_wce"] if c51 else -1)
    ip[[IP_OFF_ALPHA, IP_ALPHA_AUTOTUNE, IP_OFF_LPC]] = (
        (4 * (n_a + n_c), _alpha_adam(config), prog.scratch["sC_lp"]) if sac
        else (-1, 0, -1))
    n_stages = len(prog.stage_tiles)
    ip[IP_STAGE_START:IP_STAGE_START + n_stages + 1] = prog.stage_start
    ip[IP_STAGE_TILES:IP_STAGE_TILES + n_stages] = prog.stage_tiles
    ip[IP_STAGE_TILES_SKIP:IP_STAGE_TILES_SKIP + n_stages] = prog.stage_tiles_skip
    fp = np.full(FP_COUNT, np.nan, np.float32)   # the support stays nan until resolved
    fp[[FP_LR_A, FP_LR_C, FP_B1, FP_OMB1, FP_B2, FP_OMB2, FP_EPS, FP_LOG_B1,
        FP_LOG_B2, FP_TAU, FP_OMTAU, FP_INV_B, FP_INV_K, FP_NEG2_INV_B]] = (
        config.actor_lr, config.critic_lr, B1, 1.0 - B1, B2, 1.0 - B2, EPS,
        math.log(B1), math.log(B2), config.tau, 1.0 - config.tau,
        1.0 / B, 1.0 / K, -2.0 / B)
    if sac:
        fp[[FP_SAC_M0, FP_SAC_HW, FP_SAC_TGT_H]] = (
            config.sac_log_std_min,
            0.5 * (float(config.sac_log_std_max) - float(config.sac_log_std_min)),
            sac_target_entropy(config.target_entropy, a, action_scale))
    mode = MODE_C51 if c51 else MODE_SAC if sac else MODE_PLAIN
    n_alpha = _alpha_slots(config)
    ip_d = torch.from_numpy(ip).to(device)
    fp_d = torch.from_numpy(fp).to(device)
    tasks_d = torch.from_numpy(np.ascontiguousarray(prog.tasks)).to(device)
    scratch = torch.zeros(off_stepnorm + 2 * K, dtype=torch.float32, device=device)
    if not (c51 or sac):
        dqpi = prog.scratch["dqpi"]
        scratch[dqpi:dqpi + B] = -1.0 / B
    scale = torch.as_tensor(np.broadcast_to(np.asarray(action_scale, np.float32), (a,)).copy(),
                            device=device)
    offset = torch.as_tensor(np.broadcast_to(np.asarray(action_offset, np.float32), (a,)).copy(),
                             device=device)
    support = torch.full((_atoms(config),), math.nan, dtype=torch.float32, device=device)

    def write_support(c: DDPGConfig) -> None:
        # Ordered on the current stream, after any chunk already queued.
        if not c.v_support_auto:
            z_row, bounds = support_params(c)
            support.copy_(torch.from_numpy(z_row))
            fp_d[FP_VMIN:FP_DZ + 1].copy_(torch.from_numpy(bounds))

    if c51:
        write_support(config)

    def check_input(what, x, shape):
        if x.device != scratch.device or x.dtype != torch.float32:
            raise ValueError(
                f"{what} must be float32 on {scratch.device}, got {x.dtype} on {x.device}"
            )
        if x.shape != shape or not x.is_contiguous():
            raise ValueError(
                f"{what} must be a contiguous {shape} tensor, got {tuple(x.shape)}"
            )

    def run(state: TrainState, packed: torch.Tensor, eps=None):
        check_input("packed batch", packed, (K, B, D))
        config.check_noise(eps)
        resolved()
        if sac:
            for e in eps:
                check_input("eps", e, (K, B, a))
            eps = torch.stack(eps)    # [2, K, B, act]: eps_next, then eps_cur
        elif eps is not None:
            check_input("eps", eps, (K, B, a))
        flat = flatten_state(state)
        if flat.numel() != 4 * (n_a + n_c) + n_alpha or flat.device != scratch.device:
            raise ValueError("state does not match the kernel's net shapes or device")
        counts = [state.actor_opt.count, state.critic_opt.count, state.step]
        if state.alpha_opt is not None:
            counts.append(state.alpha_opt.count)
        counts = torch.stack(counts).to(torch.int32)
        td = torch.empty((K, B), dtype=torch.float32, device=device)
        metrics = torch.empty(len(METRIC_KEYS), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.fused_chunk_launch(
            flat.data_ptr(), scratch.data_ptr(), packed.data_ptr(),
            eps.data_ptr() if eps is not None else None,
            support.data_ptr() if c51 else None, td.data_ptr(),
            metrics.data_ptr(), counts.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), ip_d.data_ptr(), fp_d.data_ptr(),
            tasks_d.data_ptr(), mode, int(bf16), grid, stream,
        )
        _check(lib, code, "launch")
        KERNEL_LAUNCHES[name] += 1
        new_state = unflatten_state(flat, state, K, actor_updates(config, state.step, K))
        return new_state, td, dict(zip(METRIC_KEYS, metrics.unbind()))

    # Launch parameters, for chip_smoke.py's breakdown of where the time
    # goes (it zeroes stage tile counts in `ip` and restores them).
    run.program, run.ip = prog, ip_d
    run.set_value_bounds = set_value_bounds
    return run
