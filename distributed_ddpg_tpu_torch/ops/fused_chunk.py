"""K full DDPG or TD3 learner steps in ONE launch of a hand-written CUDA kernel.

Replaces the DDPG TD(0) f32 branch (a) and the TD3 branch (b) of the
Pallas megakernel distributed_ddpg_tpu/ops/fused_chunk.py
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

The C51, SAC and bf16 branches and the data-parallel mesh launch of the
JAX kernel are later work (ROADMAP.md).

Three pieces live here:

- `_plan`: turns the net shapes into a small program for the kernel — a
  table of matrix-product tasks (forward, weight gradient, input
  gradient, each with a fused epilogue), grouped into stages by their data
  dependencies, with every buffer's offset in one flat scratch tensor.
  The kernel (csrc/fused_chunk.cu) loops over k and, per step, over the
  stages; a grid-wide barrier separates the stages. Within a stage the
  actor's backward tasks come last, so a step that skips them (TD3's
  delay) runs only a prefix of the stage's tiles.
- `fused_chunk_reference`: the plain PyTorch version, the same K-step
  hand-written math. The wrapper runs it for tensors on the CPU; the
  tests and chip_smoke.py hold the kernel and the JAX package against it.
- `make_fused_chunk_fn`: the wrapper. On a CUDA tensor it launches the
  kernel or raises; it never falls back to the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS
from distributed_ddpg_tpu_torch.ops.optim import B1, B2, EPS
from distributed_ddpg_tpu_torch.types import OptState, TrainState

# Launches of each hand-written kernel in this process, counted by the
# wrapper where it launches (chip_smoke.py zeroes and reads them).
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

# --- the kernel's program format (mirrors csrc/fused_chunk.cu) ------------

TILE = 16                 # output tile is TILE x TILE, one element a thread
MAX_STAGES = 64
TASK_INTS = 40
OP_FWD, OP_DW, OP_DX = 0, 1, 2
BASE_STATE, BASE_SCRATCH, BASE_BATCH, BASE_ONES = 0, 1, 2, 3
(EPI_NONE, EPI_RELU, EPI_TANH, EPI_TD, EPI_MASK, EPI_TANH_BWD, EPI_TANH_NOISE,
 EPI_TD3) = range(8)
# Task row fields. Segment s (s < 2) occupies F_SEG + 9*s .. + 8 as
# a_base, a_off, a_sm, a_sj, b_base, b_off, b_sj, b_sn, J:
#   C[m, n] = epi(sum_s sum_j A_s[m*a_sm + j*a_sj] * B_s[j*b_sj + n*b_sn] + bias[n])
F_OP, F_M, F_N, F_NSEG, F_SEG = 0, 1, 2, 3, 4
F_C, F_BIAS, F_EPI, F_AUX, F_AUX2 = 22, 26, 28, 29, 32   # C: base, off, sm, sn
F_TILE0, F_TILES_M, F_TILES_N = 34, 35, 36
# Integer parameters (ip) and float parameters (fp) of a launch.
(IP_K, IP_B, IP_D, IP_OBS, IP_ACT, IP_NSTAGES, IP_NA, IP_NC,
 IP_OFF_PA, IP_OFF_PC, IP_OFF_TA, IP_OFF_TC, IP_OFF_MUA, IP_OFF_NUA,
 IP_OFF_MUC, IP_OFF_NUC, IP_OFF_GA, IP_OFF_GC, IP_OFF_QPI, IP_OFF_PART,
 IP_OFF_STEPMET, IP_OFF_STEPNORM, IP_DELAY, IP_OFF_TD01,   # TD01: -1 unless TD3
 IP_STAGE_START) = range(25)
IP_STAGE_TILES = IP_STAGE_START + MAX_STAGES + 1
IP_STAGE_TILES_SKIP = IP_STAGE_TILES + MAX_STAGES   # tiles on a no-update step
IP_COUNT = IP_STAGE_TILES_SKIP + MAX_STAGES
(FP_LR_A, FP_LR_C, FP_B1, FP_OMB1, FP_B2, FP_OMB2, FP_EPS, FP_LOG_B1,
 FP_LOG_B2, FP_TAU, FP_OMTAU, FP_INV_B, FP_INV_K, FP_NEG2_INV_B,
 FP_COUNT) = range(15)
# Element-wise operations per parameter and step in the optimizer pass
# (Adam: moments and the bias-corrected update; Polyak), for the
# operation count.
ADAM_OPS_PER_PARAM, POLYAK_OPS_PER_PARAM = 12, 3


def supported(config: DDPGConfig) -> bool:
    """The DDPG TD(0) and TD3 f32 part of the JAX kernel's envelope
    (fused_chunk.py:167-180). C51, SAC and bf16 are later work."""
    return (
        config.action_insert_layer == 1
        and config.critic_l2 == 0.0
        and not config.fused_update
        and config.compute_dtype == "float32"
        and not (config.distributional or config.sac)
        and len(config.critic_hidden) >= 2
        and len(config.actor_hidden) >= 1
    )


# --- layouts ----------------------------------------------------------------


def _net_dims(config: DDPGConfig, obs_dim: int, act_dim: int):
    """[(in, out)] per layer for the actor and the critic (action at
    critic layer 1)."""
    ah, ch = list(config.actor_hidden), list(config.critic_hidden)
    actor = list(zip([obs_dim] + ah, ah + [act_dim]))
    critic = list(zip([obs_dim, ch[0] + act_dim] + ch[1:], ch + [1]))
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


def _plan(config: DDPGConfig, obs_dim: int, act_dim: int) -> _Program:
    """The kernel's per-step program for these net shapes and this batch."""
    B, o, a = int(config.batch_size), int(obs_dim), int(act_dim)
    D = 2 * o + a + 3
    twin = bool(config.twin_critic)
    adims, cdims = _net_dims(config, o, a)
    aoffs, n_a = _layer_offsets(adims)
    coffs, n_c = _layer_offsets(cdims)           # one critic member
    ncg = 2 * n_c if twin else n_c               # the critic group
    na, nc = len(adims), len(cdims)
    F = cdims[0][1]                              # critic features before the action
    # State groups: actor, critic, target actor, target critic, actor mu,
    # actor nu, critic mu, critic nu (the order the wrapper flattens); a
    # TD3 critic group is all of member 0's layers, then member 1's.
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
    buf("dqpi", B)              # constant -1/B, filled by the wrapper
    if twin:
        # The TD3 task reads the four heads q'0, q'1, q0, q1 and writes
        # dq0, dq1, td0, td1: two [4, B] blocks, rows B apart.
        heads, outs = buf("q4", 4 * B), buf("td3", 4 * B)
        for i, name in enumerate(("ct0_q", "ct1_q", "c0_q", "c1_q")):
            scratch[name] = heads + i * B
        for i, name in enumerate(("dq0", "dq1", "td0", "td1")):
            scratch[name] = outs + i * B
    ready: Dict[str, int] = {}  # scratch buffer -> stage that writes it
    skipped: set = set()        # buffers written only on actor-update steps
    rows: List[Tuple[int, bool, np.ndarray]] = []
    flops = [0, 0]              # every step, actor updates only

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
        flops[1 if actor_bwd else 0] += sum(
            2 * int(row[F_M]) * int(row[F_N]) * int(row[F_SEG + 9 * s + 8])
            for s in range(row[F_NSEG])
        )

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
            add(task(
                OP_FWD, B, dout,
                [(x, (BASE_STATE, group + w_off, dout, 1), din)],
                c=(BASE_SCRATCH, buf(out, B * dout), dout, 1),
                bias=(BASE_STATE, group + b_off),
                epi=head_epi if last else EPI_RELU,
                aux=(BASE_SCRATCH, buf(f"{prefix}_t", B * dout), dout) if last else None,
            ), reads, [out] + ([f"{prefix}_t"] if last else []))
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

    if twin:
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
        critic_fwd("ct", TC, nobs, act_of("at_u", a), "at_u", head_epi=EPI_TD)
        actor_fwd("a", PA, obs, None)
        critic_fwd("pi", PC, obs, act_of("a_u", a), "a_u", shared_h1="c_h1")

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

    if twin:
        for m in range(2):
            critic_bwd(f"c{m}", PC + m * n_c, gc + m * n_c, f"dq{m}")
    else:
        critic_bwd("c", PC, gc, "dq")
    # Actor pass through the pre-update critic (TD3: member 0, the first
    # in the group) to the action: dL/dq = -1/B.
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
    return _Program(
        tasks=table, stage_start=stage_start, stage_tiles=stage_tiles,
        stage_tiles_skip=stage_tiles_skip, scratch=scratch, scratch_size=size[0],
        n_actor=n_a, n_critic=ncg, matmul_flops=flops[0], actor_bwd_flops=flops[1],
    )


def actor_updates(config: DDPGConfig, step0, k: int):
    """Actor (and Polyak) updates among the steps step0 .. step0 + k - 1:
    all k, or under TD3 those with step % policy_delay == 0, which number
    f(step0 + k) - f(step0) with f(n) = ceil(n / policy_delay). step0 may
    be an int or an integer tensor (then so is the result)."""
    d = int(config.policy_delay)   # 1 unless TD3 (config gate)
    return (step0 + k + d - 1) // d - (step0 + d - 1) // d


def ops_per_chunk(config: DDPGConfig, obs_dim: int, act_dim: int, chunk: int,
                  step0: int = 0) -> int:
    """Floating-point operations the kernel does for one chunk that starts
    at global step step0: the program's matrix products and the critic's
    Adam every step; the actor's backward, its Adam and every Polyak
    update on the steps that update the actor."""
    prog = _plan(config, obs_dim, act_dim)
    updates = actor_updates(config, int(step0), chunk)
    every = prog.matmul_flops + ADAM_OPS_PER_PARAM * prog.n_critic
    per_update = (prog.actor_bwd_flops + ADAM_OPS_PER_PARAM * prog.n_actor
                  + POLYAK_OPS_PER_PARAM * (prog.n_actor + prog.n_critic))
    return chunk * every + updates * per_update


def state_bytes(config: DDPGConfig, obs_dim: int, act_dim: int) -> int:
    """f32 bytes of params, targets and both Adam moments of both nets."""
    prog = _plan(config, obs_dim, act_dim)
    return 16 * (prog.n_actor + prog.n_critic)


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


# --- the plain PyTorch version ----------------------------------------------


def fused_chunk_reference(config: DDPGConfig, state: TrainState, packed: torch.Tensor,
                          action_scale, action_offset=0.0, eps=None):
    """K learner steps written out by hand, step by step as the kernel
    does them. `packed` is [K, B, 2*obs+act+3]; `eps` is TD3's smoothing
    noise [K, B, act], given exactly when twin_critic and target_noise > 0.
    Returns (new_state, td[K, B], metrics {METRIC_KEYS: 0-d tensors, chunk
    means})."""
    K, B, _ = packed.shape
    dev = packed.device
    twin = bool(config.twin_critic)
    config.check_noise(eps)
    delay = int(config.policy_delay)
    step0 = int(state.step)
    o = state.actor_params[0]["w"].shape[0]
    a = state.actor_params[-1]["w"].shape[1]
    f32 = torch.float32
    scale = torch.as_tensor(np.asarray(action_scale, np.float32), device=dev).expand(a)
    offset = torch.as_tensor(np.asarray(action_offset, np.float32), device=dev).expand(a)
    inv_b, inv_k = 1.0 / B, 1.0 / K
    log_b1 = torch.tensor(math.log(B1), dtype=f32, device=dev)
    log_b2 = torch.tensor(math.log(B2), dtype=f32, device=dev)

    def copy(t):
        return [[layer["w"].clone(), layer["b"].clone()] for layer in t]

    def members(t):     # a critic group as a list of member nets
        if not twin:
            return [copy(t)]
        return [[[layer["w"][m].clone(), layer["b"][m].clone()] for layer in t]
                for m in range(2)]

    A, TAp = copy(state.actor_params), copy(state.target_actor_params)
    AMU, ANU = copy(state.actor_opt.mu), copy(state.actor_opt.nu)
    C, TCp = members(state.critic_params), members(state.target_critic_params)
    CMU, CNU = members(state.critic_opt.mu), members(state.critic_opt.nu)

    def actor_fwd(P, x):
        acts = [x]
        for w, b in P[:-1]:
            acts.append(torch.relu(acts[-1] @ w + b))
        t = torch.tanh(acts[-1] @ P[-1][0] + P[-1][1])
        return t * scale + offset, acts, t

    def critic_fwd(P, x, act):
        f = P[0][0].shape[1]
        h = torch.relu(x @ P[0][0] + P[0][1])
        acts = [x, h]
        h = torch.relu(h @ P[1][0][:f] + act @ P[1][0][f:] + P[1][1])
        acts.append(h)
        for w, b in P[2:-1]:
            acts.append(torch.relu(acts[-1] @ w + b))
        return acts[-1] @ P[-1][0] + P[-1][1], acts      # q: [B, 1]

    def critic_bwd(P, acts, act, dq, wgrads: bool):
        """(grads [[gw, gb]] or None, d_action)."""
        n = len(P)
        grads = [None] * n
        dz = dq
        for i in range(n - 1, 1, -1):
            if wgrads:
                grads[i] = [acts[i].T @ dz, dz.sum(0)]
            dz = (dz @ P[i][0].T) * (acts[i] > 0.0)
        f = acts[1].shape[-1]
        w1 = P[1][0]
        da = dz @ w1[f:].T
        if not wgrads:
            return None, da
        grads[1] = [torch.cat([acts[1].T @ dz, act.T @ dz], 0), dz.sum(0)]
        dz0 = (dz @ w1[:f].T) * (acts[1] > 0.0)
        grads[0] = [acts[0].T @ dz0, dz0.sum(0)]
        return grads, da

    def actor_bwd(P, acts, dz):
        n = len(P)
        grads = [None] * n
        for i in range(n - 1, -1, -1):
            grads[i] = [acts[i].T @ dz, dz.sum(0)]
            if i > 0:
                dz = (dz @ P[i][0].T) * (acts[i] > 0.0)
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

    met = torch.zeros(len(METRIC_KEYS), dtype=f32, device=dev)
    tds = []
    with torch.no_grad():
        for k in range(K):
            x = packed[k]
            obs, act = x[:, :o], x[:, o:o + a]
            rew, disc = x[:, o + a:o + a + 1], x[:, o + a + 1:o + a + 2]
            nobs, wgt = x[:, o + a + 2:2 * o + a + 2], x[:, 2 * o + a + 2:]
            u_t, _, _ = actor_fwd(TAp, nobs)
            if eps is not None:
                u_t = torch.minimum(torch.maximum(u_t + eps[k], offset - scale),
                                    offset + scale)
            q_t = critic_fwd(TCp[0], nobs, u_t)[0]
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
            aloss = -torch.sum(q_pi) * inv_b
            update = (step0 + k) % delay == 0
            if update:   # the actor's gradient, through the pre-update critic
                _, da = critic_bwd(C[0], pi_acts, u, torch.full_like(q_pi, -inv_b), False)
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
        if not twin:
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
    """A TD3 state: critic leaves carry a leading [2, ...] ensemble axis."""
    return state.critic_params[0]["w"].dim() == 3


def _group_leaves(tree, twin: bool):
    """A group in the kernel's order: w0, b0, w1, b1, ...; for a TD3
    critic all of member 0's layers, then all of member 1's (the JAX
    kernel's _flatten_twin)."""
    if twin:
        return [t[m] for m in range(2) for layer in tree for t in (layer["w"], layer["b"])]
    return [t for layer in tree for t in (layer["w"], layer["b"])]


def flatten_state(state: TrainState) -> torch.Tensor:
    """The kernel's state buffer: the 8 groups in _groups order (a copy;
    the input state is not touched)."""
    twin = _is_twin(state)
    return torch.cat([
        t.reshape(-1) for i, g in enumerate(_groups(state))
        for t in _group_leaves(g, twin and i in _CRITIC_GROUPS)
    ])


def unflatten_state(flat: torch.Tensor, like: TrainState, steps, actor_steps) -> TrainState:
    """Views into `flat` shaped like `like`: the critic count and the step
    advanced by `steps`, the actor count by `actor_steps`. A TD3 critic
    leaf [2, ...] is one strided view over its two members' slices."""
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
    return TrainState(
        actor_params=g[0], critic_params=g[1],
        target_actor_params=g[2], target_critic_params=g[3],
        actor_opt=OptState(g[4], g[5], like.actor_opt.count + actor_steps),
        critic_opt=OptState(g[6], g[7], like.critic_opt.count + steps),
        step=like.step + steps,
    )


def _lib():
    from distributed_ddpg_tpu_torch.ops import _build

    lib = _build.load("fused_chunk")
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        lib.fused_chunk_launch.argtypes = [ptr] * 12 + [ctypes.c_int, ptr]
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
    given exactly when twin_critic and target_noise > 0.

    On the CPU, run is the plain version. On the card it launches the
    kernel once per call (counted in KERNEL_LAUNCHES["fused_chunk"], or
    ["fused_chunk_td3"] for TD3) or raises; the input state is never
    modified."""
    if not supported(config):
        raise ValueError(
            "fused chunk kernel envelope: DDPG or TD3, float32, "
            "action_insert_layer=1, critic_l2=0, fused_update=False, "
            ">=2 critic hidden layers, >=1 actor hidden layer"
        )
    K, B = int(chunk_size), int(config.batch_size)
    o, a = int(obs_dim), int(act_dim)
    D = 2 * o + a + 3
    twin = bool(config.twin_critic)
    name = "fused_chunk_td3" if twin else "fused_chunk"
    device = torch.device(device)
    if device.type == "cpu":
        def run_cpu(state: TrainState, packed: torch.Tensor, eps=None):
            if packed.shape != (K, B, D):
                raise ValueError(f"packed batch must be {(K, B, D)}, got {tuple(packed.shape)}")
            return fused_chunk_reference(config, state, packed, action_scale, action_offset, eps)

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
        prog.scratch["g_a"], prog.scratch["g_c"], prog.scratch["pi_q"],
        off_part, off_stepmet, off_stepnorm)
    ip[[IP_DELAY, IP_OFF_TD01]] = (
        config.policy_delay, prog.scratch["td0"] if twin else -1)
    n_stages = len(prog.stage_tiles)
    ip[IP_STAGE_START:IP_STAGE_START + n_stages + 1] = prog.stage_start
    ip[IP_STAGE_TILES:IP_STAGE_TILES + n_stages] = prog.stage_tiles
    ip[IP_STAGE_TILES_SKIP:IP_STAGE_TILES_SKIP + n_stages] = prog.stage_tiles_skip
    fp = np.zeros(FP_COUNT, np.float32)
    fp[[FP_LR_A, FP_LR_C, FP_B1, FP_OMB1, FP_B2, FP_OMB2, FP_EPS, FP_LOG_B1,
        FP_LOG_B2, FP_TAU, FP_OMTAU, FP_INV_B, FP_INV_K, FP_NEG2_INV_B]] = (
        config.actor_lr, config.critic_lr, B1, 1.0 - B1, B2, 1.0 - B2, EPS,
        math.log(B1), math.log(B2), config.tau, 1.0 - config.tau,
        1.0 / B, 1.0 / K, -2.0 / B)
    ip_d = torch.from_numpy(ip).to(device)
    fp_d = torch.from_numpy(fp).to(device)
    tasks_d = torch.from_numpy(np.ascontiguousarray(prog.tasks)).to(device)
    scratch = torch.zeros(off_stepnorm + 2 * K, dtype=torch.float32, device=device)
    dqpi = prog.scratch["dqpi"]
    scratch[dqpi:dqpi + B] = -1.0 / B
    scale = torch.as_tensor(np.broadcast_to(np.asarray(action_scale, np.float32), (a,)).copy(),
                            device=device)
    offset = torch.as_tensor(np.broadcast_to(np.asarray(action_offset, np.float32), (a,)).copy(),
                             device=device)

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
        if eps is not None:
            check_input("eps", eps, (K, B, a))
        flat = flatten_state(state)
        if flat.numel() != 4 * (n_a + n_c) or flat.device != scratch.device:
            raise ValueError("state does not match the kernel's net shapes or device")
        counts = torch.stack(
            [state.actor_opt.count, state.critic_opt.count, state.step]).to(torch.int32)
        td = torch.empty((K, B), dtype=torch.float32, device=device)
        metrics = torch.empty(len(METRIC_KEYS), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.fused_chunk_launch(
            flat.data_ptr(), scratch.data_ptr(), packed.data_ptr(),
            eps.data_ptr() if eps is not None else None, td.data_ptr(),
            metrics.data_ptr(), counts.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), ip_d.data_ptr(), fp_d.data_ptr(),
            tasks_d.data_ptr(), grid, stream,
        )
        _check(lib, code, "launch")
        KERNEL_LAUNCHES[name] += 1
        new_state = unflatten_state(flat, state, K, actor_updates(config, state.step, K))
        return new_state, td, dict(zip(METRIC_KEYS, metrics.unbind()))

    # Launch parameters, for chip_smoke.py's breakdown of where the time
    # goes (it zeroes stage tile counts in `ip` and restores them).
    run.program, run.ip = prog, ip_d
    return run
