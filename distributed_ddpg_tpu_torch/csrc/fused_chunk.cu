// K full DDPG, TD3, D4PG or SAC learner steps in one launch, for Hopper (sm_90a).
//
// Replaces: distributed_ddpg_tpu/ops/fused_chunk.py, make_fused_chunk_fn ->
// run -> pl.pallas_call (the kernel body _make_kernel.kernel), its DDPG
// TD(0) f32 branch (a), its TD3 branch (b), its C51 branch (c), its SAC
// branch (d), and the bf16 operands of all four (e). The Python side
// (ops/fused_chunk.py) plans the per-step work as a table of matrix-product
// tasks grouped into dependency stages; this file executes that program K
// times and runs the optimizer pass.
//
// What bounds it on this card: operations. A step at Pendulum shapes
// (2x256 nets, batch 64) is ~77 MFLOP of f32 products in ~40 small
// dependent matrices plus an element-wise Adam/Polyak pass over 134k
// parameters; the whole state (params, targets, both Adam moments: 2.15 MB)
// is read and written once per chunk, which is negligible at K = 800. At
// the f32 CUDA-core peak that is ~1.2 us a step (TD3's second critic adds
// about 40%). The steps are a chain of
// dependent products far too small to fill the card one at a time, so in
// practice latency rules: each stage's round of tiles (a chain of
// dependent L2 reads around ~1 us of products) and each grid barrier
// (PERF.md has the measured split).
//
// Design:
// - The TPU kernel walks the chunk as a sequential grid (K,) on one core
//   with the state resident in VMEM. Here the state does not fit one SM's
//   shared memory (227 KB) or one cluster's, so it stays in device memory,
//   where it is resident in the 50 MB L2 for the whole launch, and the
//   chunk is a loop over k inside ONE persistent cooperative launch (at
//   most one block per SM).
// - Each step is ~9 stages; in a stage, every block takes output tiles
//   (16 x 16, one element a thread) of the stage's independent tasks, and
//   a grid-wide barrier (cooperative groups) separates the stages. The
//   optimizer pass is one more stage, element-wise over all parameters.
// - A tile loads its whole contraction (up to 256 deep) into shared memory
//   in one go, so each stage pays about one L2 round trip, then does the
//   products on the CUDA cores in true f32 (no TF32: the reference's
//   parity needs f32, learner.py:156-158 of the JAX package).
// - Elementwise work is fused into the tasks' epilogues: bias, relu,
//   tanh*scale+offset (storing tanh for the backward), the TD target with
//   the critic's output cotangent, the relu mask of the input gradient,
//   and the tanh chain of the actor's output cotangent.
// - Data written by other blocks is read with ld.global.cg (L2, not the
//   per-SM L1), after the barrier that orders it.
// - Metrics: block 0 computes the per-step losses; every block writes its
//   partial sums of squared gradients; after the loop block 0 reduces them
//   in a fixed order, so a launch's output does not depend on timing.
//
// TD3 (branch b) runs in the same 9 stages as DDPG, with no stage added:
// - The critic group holds both members (member 0's layers, then member
//   1's) in each of the 4 state copies; the members' forwards and
//   backwards are more tasks in the stages DDPG already has.
// - The target actor's head epilogue adds the streamed noise eps[k] and
//   clips to the action box (EPI_TANH_NOISE; eps arrives clipped).
// - The min target needs all four heads (q'0, q'1, q0, q1); the target
//   heads end stage 4. One element-wise task (EPI_TD3, no product) in
//   stage 5 -- which the actor's backward already occupies -- writes both
//   members' cotangents -w * td_m / B, td0, td1 and td = (td0 + td1) / 2.
//   The critic backward then fills stages 6-8, beside the actor's, so the
//   step keeps DDPG's 9 stages and 10 barriers.
// - The delay: on a step with (step0 + k) % delay != 0 each stage runs
//   only its first stage_tiles_skip tiles (the planner puts the actor's
//   backward tasks last), and the optimizer pass does the critic's Adam
//   alone. On update steps it also does the actor's Adam, with
//   t_a = count_a + f(step0 + k) - f(step0) + 1, f(n) = ceil(n / delay),
//   and every Polyak update (actor and both critic targets).
//
// D4PG (branch c): the critic's head is [B, A] logits, A = num_atoms <= 256,
// which spans ceil(A/16) column tiles, while a softmax and the projection
// need the whole row. So two row tasks (OP_ROWS, no product) follow the
// heads, one warp a row and ceil(A/32) atoms a lane, max and sums by warp
// shuffles, in the block's shared tile memory (the products are not
// running then):
// - EPI_C51 (critic): the stable softmax p_t of the target head; the
//   shifted atoms tz_i = clip(r + disc * z_i, v_min, v_max); the
//   projection proj_j = sum_i p_t[i] * max(0, 1 - |tz_i - z_j| / dz), each
//   lane summing its own atoms j over all i in ascending order from shared
//   memory (A^2 a row, deterministic, the JAX kernel's order; no atomics);
//   log-softmax of the online head, ce = -sum proj * logp, td = E_proj[z]
//   - E_p[z], and the cotangent dq = (p - proj) * w / B, from which the
//   critic's backward starts. w * ce goes to a per-row buffer that block 0
//   sums into the loss, as it sums td.
// - EPI_C51_PI (actor): p of the actor's head, E[Z] = sum p z, and
//   dq_pi = -(1/B) * p * (z - E[Z]). Unlike DDPG's constant -1/B this
//   cotangent needs the head, so the actor's backward starts after it: the
//   step has 11 stages (DDPG's 9), 12 barriers.
// The support row z[A] and dz, v_min, v_max (fp) are inputs of the launch;
// the wrapper rewrites them in place when the bounds change. expf/logf,
// not the fast intrinsics, while parity holds at f32.
//
// SAC (branch d; JAX kernel :424-567): a tanh-Gaussian actor whose head is
// linear, [mean | log_std_raw] (2 * act), twin critics as TD3's, and two
// streamed standard-normal inputs, eps_next and eps_cur ([2][K][B][act]).
// The step has 13 stages (14 barriers); SAC's element-wise work is four row
// tasks (OP_ROWS, one warp a row, lanes over the action dims), run by
// run_sac_rows in the kernel's SAC instantiation:
// - EPI_SAC_SAMPLE, after both Gaussian heads (both through the ONLINE
//   actor, on next_obs and on obs): log_std = m0 + hw * (tanh(raw) + 1),
//   u = mean + exp(log_std) * eps, a = tanh(u) * scale + offset, and
//   lp = sum(-eps^2 / 2 - log_std - log(2 pi) / 2 - log(scale (1 - t^2) +
//   1e-6)) by a warp sum.
// - EPI_SAC_TD, after the four heads: y = r + disc * (min(q'0, q'1) -
//   alpha * lp'), each member's cotangent -w * td_m / B, td0, td1 and td.
// - EPI_SAC_PI: the min gate over both online critics at the sampled
//   action; equal heads split the cotangent -1/B 0.5/0.5 (jnp.min's
//   gradient), and min Q a row for the loss.
// - EPI_SAC_ACT, after da = da0 + da1 (one product task of two segments,
//   each member's W1 action rows): the actor's head cotangent, du = da *
//   scale * (1 - t^2) + (alpha / B) * 2 scale t (1 - t^2) / g and
//   dlog_std = du * std * eps - alpha / B through the clamp. It recomputes
//   t, std and tanh(raw) from the head and eps, bit for bit as the sample.
// The temperature: every block caches alpha = exp(log_alpha) when step k
// starts (after the barrier that ends step k - 1), and every reader of
// step k -- the TD task, the actor's cotangent, block 0's losses -- uses
// that value. Block 0 then takes log_alpha's Adam step (critic_lr, its
// own count counts[3], only with sac_autotune) in the optimizer pass,
// after its losses; no block reads log_alpha again before the barrier
// that ends the step. Both targets take Polyak every step.
//
// bf16 (branch e; JAX kernel :218-242, `cast` before every dot): each
// family has a BF16 instantiation that rounds both operands of every
// product to bf16 (round to nearest even) as a tile's slots are staged
// into shared memory, and keeps the f32 fmaf chain: a product of two bf16
// values is exact in f32, so this is the tensor core's dot, summed in
// another order. The one exemption is a bias gradient, a product whose A
// operand is the row of ones (BASE_ONES): it is the JAX kernel's f32
// jnp.sum of the cotangent, so neither operand is rounded. Epilogues, row
// tasks, the optimizer pass and the temperature are the f32 code.
// What bounds it: the bf16 tensor cores would do the products ~15x faster
// than the f32 CUDA cores, so its bound is far below the f32 branches'
// while this design runs at their speed (PERF.md); mma.sync / wgmma on
// bf16 tiles is the later route.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define TILE 16
#define JC 256
#define NT 256
#define TASK_INTS 40
#define MAX_STAGES 64
#define LOADS (TILE * JC / NT)  // tile slots each thread loads, per operand
#define ROWS_PER_TILE (NT / 32)  // a row task's tile: one warp a row
#define MAX_ATOMS 256
#define APL (MAX_ATOMS / 32)     // atoms a lane holds in a row task

static_assert(ROWS_PER_TILE * 2 * MAX_ATOMS <= TILE * (JC + 1),
              "a row task's shared scratch must fit in the A-operand tile");

// Mirrors ops/fused_chunk.py.
enum { OP_FWD = 0, OP_DW = 1, OP_DX = 2, OP_ROWS = 3 };
enum { BASE_STATE = 0, BASE_SCRATCH = 1, BASE_BATCH = 2, BASE_ONES = 3 };
enum {
  EPI_NONE = 0, EPI_RELU, EPI_TANH, EPI_TD, EPI_MASK, EPI_TANH_BWD, EPI_TANH_NOISE,
  EPI_TD3, EPI_C51, EPI_C51_PI, EPI_SAC_SAMPLE, EPI_SAC_TD, EPI_SAC_PI, EPI_SAC_ACT
};
enum {
  F_OP = 0, F_M = 1, F_N = 2, F_NSEG = 3, F_SEG = 4,
  F_C = 22, F_BIAS = 26, F_EPI = 28, F_AUX = 29, F_AUX2 = 32,
  F_TILE0 = 34, F_TILES_M = 35, F_TILES_N = 36, F_ARG = 37
};
enum {
  IP_K = 0, IP_B, IP_D, IP_OBS, IP_ACT, IP_NSTAGES, IP_NA, IP_NC,
  IP_OFF_PA, IP_OFF_PC, IP_OFF_TA, IP_OFF_TC, IP_OFF_MUA, IP_OFF_NUA,
  IP_OFF_MUC, IP_OFF_NUC, IP_OFF_GA, IP_OFF_GC, IP_OFF_QPI, IP_OFF_PART,
  IP_OFF_STEPMET, IP_OFF_STEPNORM, IP_DELAY, IP_OFF_TD01, IP_OFF_WCE,
  IP_OFF_ALPHA, IP_ALPHA_AUTOTUNE, IP_OFF_LPC, IP_STAGE_START,
  IP_STAGE_TILES = IP_STAGE_START + MAX_STAGES + 1,
  IP_STAGE_TILES_SKIP = IP_STAGE_TILES + MAX_STAGES
};
enum {
  FP_LR_A = 0, FP_LR_C, FP_B1, FP_OMB1, FP_B2, FP_OMB2, FP_EPS, FP_LOG_B1,
  FP_LOG_B2, FP_TAU, FP_OMTAU, FP_INV_B, FP_INV_K, FP_NEG2_INV_B, FP_VMIN, FP_VMAX,
  FP_DZ, FP_SAC_M0, FP_SAC_HW, FP_SAC_TGT_H
};
// The kernel's instantiations: the program's row tasks, if any.
enum { MODE_PLAIN = 0, MODE_C51 = 1, MODE_SAC = 2 };
#define SAC_TANH_EPS 1e-6f
#define SAC_HALF_LOG_2PI 0.91893853320467274f  // log(2 pi) / 2

struct Ctx {
  float* state;
  float* scratch;
  const float* batch_k;  // this step's [B, D] packed rows
  const float* eps_k;    // this step's smoothing noise [B, act] (TD3), or null
  float* td_k;           // this step's td[B]
  const float* scale;
  const float* offset;
  const float* z;        // the C51 support [A], or null
  int D, obs, act;
  float neg2_inv_b, inv_b;
  float vmin, vmax, dz;  // the C51 support's bounds and spacing
};

__device__ __forceinline__ float* resolve(const Ctx& c, int base, int off) {
  if (base == BASE_STATE) return c.state + off;
  if (base == BASE_SCRATCH) return c.scratch + off;
  if (base == BASE_BATCH) return const_cast<float*>(c.batch_k) + off;
  return nullptr;
}

// Batch rows are read-only for the launch; state and scratch are written
// by other blocks between barriers, so they are read through L2.
__device__ __forceinline__ float load(const float* p, int base) {
  return base == BASE_BATCH ? __ldg(p) : __ldcg(p);
}

// x rounded to the nearest bf16 value (ties to even), back in f32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ void run_tile(const int* __restrict__ T, int tile, const Ctx& c,
                         float (*As)[JC + 1], float (*Bs)[TILE + 1]) {
  const int M = T[F_M], N = T[F_N], nseg = T[F_NSEG];
  const int tiles_n = T[F_TILES_N];
  const int m0 = (tile / tiles_n) * TILE, n0 = (tile % tiles_n) * TILE;
  const int tid = threadIdx.x, ty = tid / TILE, tx = tid % TILE;
  float acc = 0.f;
  for (int s = 0; s < nseg; ++s) {
    const int* S = T + F_SEG + 9 * s;
    const int a_base = S[0], a_sm = S[2], a_sj = S[3];
    const int b_base = S[4], b_sj = S[6], b_sn = S[7], J = S[8];
    const float* A = resolve(c, a_base, S[1]);
    const float* Bp = resolve(c, b_base, S[5]);
    // bf16: every product's operands round, but a bias gradient's (its A
    // is the row of ones; the B operand is the f32 cotangent it sums).
    const bool rnd = BF16 && a_base != BASE_ONES;
    for (int j0 = 0; j0 < J; j0 += JC) {
      const int jl = min(JC, J - j0);
      // Each thread owns LOADS slots of each tile. All of a thread's loads
      // are issued before any is stored, so a tile costs about one L2
      // round trip instead of one per slot. The slot -> (row, column) map
      // puts consecutive threads on consecutive addresses of whichever
      // dimension is contiguous in memory.
      float va[LOADS], vb[LOADS];
#pragma unroll
      for (int r = 0; r < LOADS; ++r) {
        const int idx = tid + r * NT;
        const int i = (a_sj == 1) ? idx / JC : idx % TILE;
        const int jj = (a_sj == 1) ? idx % JC : idx / TILE;
        const int m = m0 + i;
        va[r] = 0.f;
        if (m < M && jj < jl)
          va[r] = (a_base == BASE_ONES)
                      ? 1.f
                      : load(A + (size_t)m * a_sm + (size_t)(j0 + jj) * a_sj, a_base);
      }
#pragma unroll
      for (int r = 0; r < LOADS; ++r) {
        const int idx = tid + r * NT;
        const int jj = (b_sn == 1) ? idx / TILE : idx % JC;
        const int cc = (b_sn == 1) ? idx % TILE : idx / JC;
        const int n = n0 + cc;
        vb[r] = 0.f;
        if (n < N && jj < jl)
          vb[r] = load(Bp + (size_t)(j0 + jj) * b_sj + (size_t)n * b_sn, b_base);
      }
#pragma unroll
      for (int r = 0; r < LOADS; ++r) {
        const int idx = tid + r * NT;
        if (rnd) {
          va[r] = bf16_round(va[r]);
          vb[r] = bf16_round(vb[r]);
        }
        if (a_sj == 1) As[idx / JC][idx % JC] = va[r];
        else As[idx % TILE][idx / TILE] = va[r];
        if (b_sn == 1) Bs[idx / TILE][idx % TILE] = vb[r];
        else Bs[idx % JC][idx / JC] = vb[r];
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < jl; ++jj) acc = fmaf(As[ty][jj], Bs[jj][tx], acc);
      __syncthreads();
    }
  }
  const int m = m0 + ty, n = n0 + tx;
  if (m >= M || n >= N) return;
  float z = acc;
  if (T[F_BIAS] >= 0) z = z + __ldcg(resolve(c, T[F_BIAS], T[F_BIAS + 1]) + n);
  float* aux = T[F_AUX] >= 0 ? resolve(c, T[F_AUX], T[F_AUX + 1]) : nullptr;
  const int aux_sm = T[F_AUX + 2];
  float out = z;
  switch (T[F_EPI]) {
    case EPI_RELU:
      out = fmaxf(z, 0.f);
      break;
    case EPI_TANH: {
      const float t = tanhf(z);
      aux[m * aux_sm + n] = t;
      out = t * __ldg(c.scale + n) + __ldg(c.offset + n);
      break;
    }
    case EPI_TANH_NOISE: {
      // The TD3 target action: mu'(s') + eps, clipped to the action box.
      const float t = tanhf(z);
      aux[m * aux_sm + n] = t;
      const float sc = __ldg(c.scale + n), of = __ldg(c.offset + n);
      const float u = t * sc + of + __ldg(c.eps_k + (size_t)m * c.act + n);
      out = fminf(fmaxf(u, of - sc), of + sc);
      break;
    }
    case EPI_TD: {
      // z = Q'(s', mu'(s')); aux = Q(s, a); td = (r + disc * q_t) - q;
      // the critic's output cotangent dL/dq = -2/B * w * td goes to aux2.
      const float* row = c.batch_k + (size_t)m * c.D;
      const int col = c.obs + c.act;
      const float r = __ldg(row + col), disc = __ldg(row + col + 1);
      const float w = __ldg(row + 2 * c.obs + c.act + 2);
      const float td = (r + disc * z) - __ldcg(aux + m);
      c.td_k[m] = td;
      resolve(c, T[F_AUX2], T[F_AUX2 + 1])[m] = (c.neg2_inv_b * w) * td;
      break;
    }
    case EPI_TD3: {
      // No product. aux rows (aux_sm apart): q'0, q'1, q0, q1; aux2 rows:
      // dq0, dq1, td0, td1. y = r + disc * min(q'0, q'1), td_m = y - q_m,
      // dL/dq_m = -w * td_m / B; td = (td0 + td1) / 2.
      const float* row = c.batch_k + (size_t)m * c.D;
      const int col = c.obs + c.act;
      const float r = __ldg(row + col), disc = __ldg(row + col + 1);
      const float w = __ldg(row + 2 * c.obs + c.act + 2);
      const float y = r + disc * fminf(__ldcg(aux + m), __ldcg(aux + aux_sm + m));
      const float td0 = y - __ldcg(aux + 2 * aux_sm + m);
      const float td1 = y - __ldcg(aux + 3 * aux_sm + m);
      float* o = resolve(c, T[F_AUX2], T[F_AUX2 + 1]);
      const float g = -c.inv_b * w;
      o[m] = g * td0;
      o[aux_sm + m] = g * td1;
      o[2 * aux_sm + m] = td0;
      o[3 * aux_sm + m] = td1;
      c.td_k[m] = 0.5f * (td0 + td1);
      break;
    }
    case EPI_MASK:
      out = z * (__ldcg(aux + m * aux_sm + n) > 0.f ? 1.f : 0.f);
      break;
    case EPI_TANH_BWD: {
      const float t = __ldcg(aux + m * aux_sm + n);
      out = (z * __ldg(c.scale + n)) * (1.f - t * t);
      break;
    }
    default:
      break;
  }
  if (T[F_C] >= 0)
    resolve(c, T[F_C], T[F_C + 1])[(size_t)m * T[F_C + 2] + (size_t)n * T[F_C + 3]] = out;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A row task (no product) over [M, A] heads: warp w takes row
// m = tile * ROWS_PER_TILE + w, lane l the atoms j = l + 32 r. Reads aux
// (row stride aux_sm; EPI_C51: the target block, then the online block M
// rows later), writes C (row stride C_sm) and one value a row to aux2. `sh`
// is the block's shared tile memory, 2 * MAX_ATOMS floats a warp. Every
// thread of the block calls it; it ends with a block barrier, so the next
// tile may reuse the shared memory. Kept out of line: inlined, it took
// the kernel from 234 to 242 registers, and the steps were slower
// (PERF.md, the A/B runs of the C51 branch).
__device__ __noinline__ void run_rows(const int* __restrict__ T, int tile, const Ctx& c,
                                      float* sh) {
  const int M = T[F_M], A = T[F_N];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = tile * ROWS_PER_TILE + warp;
  if (m < M) {
    const int aux_sm = T[F_AUX + 2];
    const float* head = resolve(c, T[F_AUX], T[F_AUX + 1]);
    float* out = resolve(c, T[F_C], T[F_C + 1]) + (size_t)m * T[F_C + 2];
    float* per_row = resolve(c, T[F_AUX2], T[F_AUX2 + 1]);
    float zj[APL], v[APL], e[APL];
#pragma unroll
    for (int r = 0; r < APL; ++r) {
      const int j = lane + 32 * r;
      zj[r] = j < A ? __ldg(c.z + j) : 0.f;
    }
    if (T[F_EPI] == EPI_C51) {
      const float* row = c.batch_k + (size_t)m * c.D;
      const int col = c.obs + c.act;
      const float rw = __ldg(row + col), disc = __ldg(row + col + 1);
      const float w = __ldg(row + 2 * c.obs + c.act + 2);
      float* sp = sh + warp * 2 * MAX_ATOMS;  // p_t[A], then tz[A]
      float* st = sp + MAX_ATOMS;
      // Stable softmax of the target head; the shifted, clipped atoms.
      const float* qt = head + (size_t)m * aux_sm;
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        v[r] = j < A ? __ldcg(qt + j) : -INFINITY;
        mx = fmaxf(mx, v[r]);
      }
      mx = warp_max(mx);
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        e[r] = j < A ? expf(v[r] - mx) : 0.f;
        s += e[r];
      }
      s = warp_sum(s);
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        if (j < A) {
          sp[j] = e[r] / s;
          st[j] = fminf(fmaxf(rw + disc * zj[r], c.vmin), c.vmax);
        }
      }
      __syncwarp();
      // Projection: each lane its own atoms j, over every i in ascending
      // order; only the nr slots a lane holds at this A (warp-uniform).
      const int nr = (A + 31) / 32;
      float proj[APL];
#pragma unroll
      for (int r = 0; r < APL; ++r) proj[r] = 0.f;
      for (int i = 0; i < A; ++i) {
        const float ti = st[i], pi = sp[i];
#pragma unroll
        for (int r = 0; r < APL; ++r)
          if (r < nr) proj[r] = proj[r] + pi * fmaxf(0.f, 1.f - fabsf(ti - zj[r]) / c.dz);
      }
      // Log-softmax of the online head; cross-entropy, td, the cotangent.
      const float* q = head + (size_t)(M + m) * aux_sm;
      mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        v[r] = j < A ? __ldcg(q + j) : -INFINITY;
        mx = fmaxf(mx, v[r]);
      }
      mx = warp_max(mx);
      s = 0.f;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        e[r] = j < A ? expf(v[r] - mx) : 0.f;
        s += e[r];
      }
      s = warp_sum(s);
      const float lse = mx + logf(s), g = w * c.inv_b;
      float ce = 0.f, e_proj = 0.f, e_p = 0.f;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        if (j < A) {
          const float p = e[r] / s;
          ce += proj[r] * (v[r] - lse);
          e_proj += proj[r] * zj[r];
          e_p += p * zj[r];
          out[j] = (p - proj[r]) * g;
        }
      }
      ce = -warp_sum(ce);
      e_proj = warp_sum(e_proj);
      e_p = warp_sum(e_p);
      if (lane == 0) {
        c.td_k[m] = e_proj - e_p;
        per_row[m] = w * ce;
      }
    } else {  // EPI_C51_PI: the actor's cotangent at the critic's head.
      const float* q = head + (size_t)m * aux_sm;
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        v[r] = j < A ? __ldcg(q + j) : -INFINITY;
        mx = fmaxf(mx, v[r]);
      }
      mx = warp_max(mx);
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        e[r] = j < A ? expf(v[r] - mx) : 0.f;
        s += e[r];
      }
      s = warp_sum(s);
      float q_exp = 0.f;
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        e[r] = e[r] / s;  // p
        q_exp += e[r] * zj[r];
      }
      q_exp = warp_sum(q_exp);
#pragma unroll
      for (int r = 0; r < APL; ++r) {
        const int j = lane + 32 * r;
        if (j < A) out[j] = (-c.inv_b * e[r]) * (zj[r] - q_exp);
      }
      if (lane == 0) per_row[m] = q_exp;
    }
  }
  __syncthreads();
}

// SAC's row tasks (no product): warp w takes row m = tile * ROWS_PER_TILE
// + w; EPI_SAC_SAMPLE and EPI_SAC_ACT spread the action dims j over the
// lanes, EPI_SAC_TD and EPI_SAC_PI are one value a row (lane 0). Operands:
// - EPI_SAC_SAMPLE: aux = the Gaussian head [M, 2 act] (row stride aux_sm),
//   F_ARG = the normal stream (0: eps_next, 1: eps_cur); writes the action
//   to C (row stride C_sm) and lp to aux2.
// - EPI_SAC_TD: aux = rows q'0, q'1, q0, q1, lp' (aux_sm apart); writes the
//   rows dq0, dq1, td0, td1 at aux2 (aux_sm apart) and td.
// - EPI_SAC_PI: aux = rows q_pi0, q_pi1 (aux_sm apart); writes the gated
//   cotangents' rows at C (C_sm apart) and min(q_pi0, q_pi1) to aux2.
// - EPI_SAC_ACT: aux = the actor's head [M, 2 act], aux2 = da [M, act];
//   writes [du | dlog_std_raw] to C (row stride C_sm).
// `alpha` is the step's cached temperature. No shared memory, no block
// barrier: a warp whose row is past M returns at once.
__device__ __noinline__ void run_sac_rows(const int* __restrict__ T, int tile, const Ctx& c,
                                          const float* __restrict__ eps_cur, float alpha,
                                          float m0, float hw) {
  const int M = T[F_M];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = tile * ROWS_PER_TILE + warp;
  if (m >= M) return;
  const int A = c.act;
  const int aux_sm = T[F_AUX + 2];
  const float* aux = resolve(c, T[F_AUX], T[F_AUX + 1]);
  const int epi = T[F_EPI];
  if (epi == EPI_SAC_SAMPLE || epi == EPI_SAC_ACT) {
    const bool sample = epi == EPI_SAC_SAMPLE;
    const float* head = aux + (size_t)m * aux_sm;
    const float* eps = (sample && T[F_ARG] == 0 ? c.eps_k : eps_cur) + (size_t)m * A;
    float* out = resolve(c, T[F_C], T[F_C + 1]) + (size_t)m * T[F_C + 2];
    const float* da = sample ? nullptr : resolve(c, T[F_AUX2], T[F_AUX2 + 1]) + (size_t)m * A;
    const float dlp_row = alpha * c.inv_b;
    float lp = 0.f;
    for (int j = lane; j < A; j += 32) {
      const float mean = __ldcg(head + j), tr = tanhf(__ldcg(head + A + j));
      const float e = __ldg(eps + j), sc = __ldg(c.scale + j);
      const float log_std = m0 + hw * (tr + 1.f);
      const float sd = expf(log_std);
      const float t = tanhf(mean + sd * e);
      const float g = sc * (1.f - t * t) + SAC_TANH_EPS;
      if (sample) {
        out[j] = t * sc + __ldg(c.offset + j);
        lp += ((-0.5f * (e * e) - log_std) - SAC_HALF_LOG_2PI) - logf(g);
      } else {
        const float one_m_t2 = 1.f - t * t;
        const float du = __ldcg(da + j) * sc * one_m_t2
                         + dlp_row * (2.f * sc * t * one_m_t2 / g);
        const float dlog_std = du * sd * e - dlp_row;
        out[j] = du;
        out[A + j] = dlog_std * (hw * (1.f - tr * tr));
      }
    }
    if (sample) {
      lp = warp_sum(lp);
      if (lane == 0) resolve(c, T[F_AUX2], T[F_AUX2 + 1])[m] = lp;
    }
    return;
  }
  if (lane != 0) return;
  if (epi == EPI_SAC_TD) {
    const float* row = c.batch_k + (size_t)m * c.D;
    const int col = c.obs + c.act;
    const float r = __ldg(row + col), disc = __ldg(row + col + 1);
    const float w = __ldg(row + 2 * c.obs + c.act + 2);
    const float q_t = fminf(__ldcg(aux + m), __ldcg(aux + aux_sm + m));
    const float y = r + disc * (q_t - alpha * __ldcg(aux + 4 * aux_sm + m));
    const float td0 = y - __ldcg(aux + 2 * aux_sm + m);
    const float td1 = y - __ldcg(aux + 3 * aux_sm + m);
    float* o = resolve(c, T[F_AUX2], T[F_AUX2 + 1]);
    const float g = -c.inv_b * w;
    o[m] = g * td0;
    o[aux_sm + m] = g * td1;
    o[2 * aux_sm + m] = td0;
    o[3 * aux_sm + m] = td1;
    c.td_k[m] = 0.5f * (td0 + td1);
  } else {  // EPI_SAC_PI
    const float q0 = __ldcg(aux + m), q1 = __ldcg(aux + aux_sm + m);
    const float lt = q0 < q1 ? 1.f : 0.f, gt = q0 > q1 ? 1.f : 0.f;
    const float gate0 = lt + 0.5f * (1.f - lt - gt);  // gate0 + gate1 = 1 exactly
    const float gate1 = gt + 0.5f * (1.f - lt - gt);
    float* o = resolve(c, T[F_C], T[F_C + 1]);
    o[m] = -c.inv_b * gate0;
    o[(size_t)T[F_C + 2] + m] = -c.inv_b * gate1;
    resolve(c, T[F_AUX2], T[F_AUX2 + 1])[m] = fminf(q0, q1);
  }
}

// Sum of v over the block, returned to every thread. `red` holds NT/32.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// MODE: MODE_C51, the program has C51's row tasks (EPI_C51, EPI_C51_PI);
// MODE_SAC, SAC's (run_sac_rows) and the temperature. The DDPG and TD3
// programs run MODE_PLAIN, which tests no task's kind (with the test,
// those branches were ~1% slower; PERF.md). BF16: the products' operands
// round (branch e); the f32 instantiations compile without the test.
template <int MODE, bool BF16>
__global__ void __launch_bounds__(NT, 1)
fused_chunk_kernel(float* state, float* scratch, const float* __restrict__ batch,
                   const float* __restrict__ noise, const float* __restrict__ support,
                   float* td_out, float* metrics,
                   const int* __restrict__ counts,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   const int* __restrict__ ip, const float* __restrict__ fp,
                   const int* __restrict__ tasks) {
  __shared__ float As[TILE][JC + 1];
  __shared__ float Bs[JC][TILE + 1];
  __shared__ float red[NT / 32];
  constexpr bool C51 = MODE == MODE_C51, SAC = MODE == MODE_SAC;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int K = ip[IP_K], B = ip[IP_B], D = ip[IP_D], nst = ip[IP_NSTAGES];
  const int na = ip[IP_NA], nc = ip[IP_NC];
  const int obs = ip[IP_OBS], act = ip[IP_ACT];
  const int G = gridDim.x;
  float* part = scratch + ip[IP_OFF_PART];        // [K][G][2] squared-grad sums
  float* stepmet = scratch + ip[IP_OFF_STEPMET];  // [K][4]
  float* stepnorm = scratch + ip[IP_OFF_STEPNORM];  // [K][2]
  const float* qpi = scratch + ip[IP_OFF_QPI];
  const float inv_b = fp[FP_INV_B];
  const int cnt_a = counts[0], cnt_c = counts[1], step0 = counts[2];
  const int delay = ip[IP_DELAY];
  const bool twin = ip[IP_OFF_TD01] >= 0;                          // TD3
  const float* td01 = twin ? scratch + ip[IP_OFF_TD01] : nullptr;  // td0[B], td1[B]
  const float* wce = C51 ? scratch + ip[IP_OFF_WCE] : nullptr;  // C51: w*ce[B]
  // SAC: log_alpha's slot (then its Adam moments when autotuned), the
  // actor sample's log-prob a row, the clamp and the target entropy.
  float* la_slot = SAC ? state + ip[IP_OFF_ALPHA] : nullptr;
  const float* lp_c = SAC ? scratch + ip[IP_OFF_LPC] : nullptr;
  const float m0 = SAC ? fp[FP_SAC_M0] : 0.f, hw = SAC ? fp[FP_SAC_HW] : 0.f;

  for (int k = 0; k < K; ++k) {
    // The delay schedule (DDPG: delay 1, every step updates everything).
    const int step = step0 + k;
    const bool upd = step % delay == 0;
    const int done_a = (step + delay - 1) / delay - (step0 + delay - 1) / delay;
    const Ctx c{state, scratch, batch + (size_t)k * B * D,
                noise ? noise + (size_t)k * B * act : nullptr, td_out + (size_t)k * B,
                scale, offset, support, D, obs, act, fp[FP_NEG2_INV_B], inv_b,
                fp[FP_VMIN], fp[FP_VMAX], fp[FP_DZ]};
    // SAC: step k's temperature, read once here, after the barrier that
    // ended step k - 1 (block 0 writes log_alpha in step k's optimizer
    // pass); eps_cur[k] follows the K steps of eps_next.
    const float la = SAC ? __ldcg(la_slot) : 0.f;
    const float alpha = SAC ? expf(la) : 0.f;
    const float* eps_cur = SAC ? noise + (size_t)(K + k) * B * act : nullptr;
    for (int s = 0; s < nst; ++s) {
      const int t0 = ip[IP_STAGE_START + s], t1 = ip[IP_STAGE_START + s + 1];
      const int ntile = ip[(upd ? IP_STAGE_TILES : IP_STAGE_TILES_SKIP) + s];
      for (int tile = blockIdx.x; tile < ntile; tile += G) {
        int t = t0;
        while (t + 1 < t1 && tasks[(t + 1) * TASK_INTS + F_TILE0] <= tile) ++t;
        const int* T = tasks + t * TASK_INTS;
        if (C51 && T[F_OP] == OP_ROWS)
          run_rows(T, tile - T[F_TILE0], c, &As[0][0]);
        else if (SAC && T[F_OP] == OP_ROWS)
          run_sac_rows(T, tile - T[F_TILE0], c, eps_cur, alpha, m0, hw);
        else
          run_tile<BF16>(T, tile - T[F_TILE0], c, As, Bs);
      }
      grid.sync();
    }

    // --- optimizer: Adam (critic, then actor) and Polyak, element-wise.
    // A step without an actor update does the critic's Adam alone. ---
    const float t_c = (float)(cnt_c + k + 1), t_a = (float)(cnt_a + done_a + 1);
    const float bc1_c = 1.f - expf(t_c * fp[FP_LOG_B1]);
    const float bc2_c = 1.f - expf(t_c * fp[FP_LOG_B2]);
    const float bc1_a = 1.f - expf(t_a * fp[FP_LOG_B1]);
    const float bc2_a = 1.f - expf(t_a * fp[FP_LOG_B2]);
    const float b1 = fp[FP_B1], omb1 = fp[FP_OMB1], b2 = fp[FP_B2], omb2 = fp[FP_OMB2];
    const float eps = fp[FP_EPS], tau = fp[FP_TAU], omtau = fp[FP_OMTAU];
    float sq_c = 0.f, sq_a = 0.f;
    const int n_opt = upd ? nc + na : nc;
    for (int e = blockIdx.x * NT + tid; e < n_opt; e += G * NT) {
      const bool is_c = e < nc;
      const int i = is_c ? e : e - nc;
      float* P = state + ip[is_c ? IP_OFF_PC : IP_OFF_PA] + i;
      float* Tg = state + ip[is_c ? IP_OFF_TC : IP_OFF_TA] + i;
      float* MU = state + ip[is_c ? IP_OFF_MUC : IP_OFF_MUA] + i;
      float* NU = state + ip[is_c ? IP_OFF_NUC : IP_OFF_NUA] + i;
      const float g = __ldcg(scratch + ip[is_c ? IP_OFF_GC : IP_OFF_GA] + i);
      const float lr = fp[is_c ? FP_LR_C : FP_LR_A];
      const float bc1 = is_c ? bc1_c : bc1_a, bc2 = is_c ? bc2_c : bc2_a;
      const float m = b1 * __ldcg(MU) + omb1 * g;
      const float v = b2 * __ldcg(NU) + omb2 * (g * g);
      const float p = __ldcg(P) - lr * (m / bc1) / (sqrtf(v / bc2) + eps);
      *MU = m;
      *NU = v;
      *P = p;
      if (upd) *Tg = tau * p + omtau * __ldcg(Tg);
      if (is_c) sq_c += g * g; else sq_a += g * g;
    }
    const float bsq_c = block_sum(sq_c, red);
    const float bsq_a = block_sum(sq_a, red);
    if (tid == 0) {
      part[((size_t)k * G + blockIdx.x) * 2] = bsq_c;
      part[((size_t)k * G + blockIdx.x) * 2 + 1] = bsq_a;
    }
    if (blockIdx.x == 0) {
      // Per-step losses from td (all of step k's TD epilogues are done).
      // TD3 and SAC: the loss is the mean over both members, 0.5/B * sum
      // w td_m^2; C51: 1/B * sum w ce, from the critic row task's per-row
      // w * ce. SAC's actor loss is alpha * mean(lp) - mean(min Q).
      float wtd2 = 0.f, atd = 0.f, sq = 0.f, slp = 0.f;
      for (int m = tid; m < B; m += NT) {
        const float td = __ldcg(c.td_k + m);
        const float w = __ldg(c.batch_k + (size_t)m * D + 2 * obs + act + 2);
        if (C51) {
          wtd2 += __ldcg(wce + m);
        } else if (twin) {
          const float td0 = __ldcg(td01 + m), td1 = __ldcg(td01 + B + m);
          wtd2 += w * td0 * td0 + w * td1 * td1;
        } else {
          wtd2 += w * td * td;
        }
        atd += fabsf(td);
        sq += __ldcg(qpi + m);
        if (SAC) slp += __ldcg(lp_c + m);
      }
      wtd2 = block_sum(wtd2, red);
      atd = block_sum(atd, red);
      sq = block_sum(sq, red);
      if (SAC) slp = block_sum(slp, red);
      if (tid == 0) {
        if (SAC) {
          const float mean_lp = slp * inv_b;
          if (ip[IP_ALPHA_AUTOTUNE]) {
            // J(log_alpha) = -log_alpha * (mean_lp + H*): the exact scalar
            // gradient; Adam at critic_lr on the temperature's own count.
            const float g = -(mean_lp + fp[FP_SAC_TGT_H]);
            const float t = (float)(counts[3] + k + 1);
            const float bc1 = 1.f - expf(t * fp[FP_LOG_B1]);
            const float bc2 = 1.f - expf(t * fp[FP_LOG_B2]);
            const float m = fp[FP_B1] * __ldcg(la_slot + 1) + fp[FP_OMB1] * g;
            const float v = fp[FP_B2] * __ldcg(la_slot + 2) + fp[FP_OMB2] * (g * g);
            la_slot[1] = m;
            la_slot[2] = v;
            la_slot[0] = la - fp[FP_LR_C] * (m / bc1) / (sqrtf(v / bc2) + fp[FP_EPS]);
          }
          // The losses read step k's temperature, cached when the step began,
          // as every other reader does; mean_q = alpha * mean_lp - aloss is
          // the JAX kernel's form of E[min Q].
          const float aloss = alpha * mean_lp - sq * inv_b;
          stepmet[k * 4 + 0] = wtd2 * (0.5f * inv_b);
          stepmet[k * 4 + 1] = aloss;
          stepmet[k * 4 + 2] = alpha * mean_lp - aloss;
          stepmet[k * 4 + 3] = atd * inv_b;
        } else {
          const float aloss = -sq * inv_b;
          stepmet[k * 4 + 0] = wtd2 * (twin ? 0.5f * inv_b : inv_b);
          stepmet[k * 4 + 1] = aloss;
          stepmet[k * 4 + 2] = -aloss;
          stepmet[k * 4 + 3] = atd * inv_b;
        }
      }
    }
    grid.sync();
  }

  // --- chunk means of the 6 metrics, in a fixed order ---
  if (blockIdx.x != 0) return;
  for (int k = tid; k < K; k += NT) {
    float sc = 0.f, sa = 0.f;
    for (int b = 0; b < G; ++b) {
      sc += __ldcg(part + ((size_t)k * G + b) * 2);
      sa += __ldcg(part + ((size_t)k * G + b) * 2 + 1);
    }
    stepnorm[k * 2] = sqrtf(sc);
    stepnorm[k * 2 + 1] = sqrtf(sa);
  }
  __syncthreads();
  if (tid < 6) {
    const float inv_k = fp[FP_INV_K];
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float v = tid < 4 ? __ldcg(stepmet + k * 4 + tid)
                              : __ldcg(stepnorm + k * 2 + (tid - 4));
      acc += v * inv_k;
    }
    metrics[tid] = acc;
  }
}

template <int MODE>
static const void* with_bf16(int bf16) {
  return bf16 ? (const void*)fused_chunk_kernel<MODE, true>
              : (const void*)fused_chunk_kernel<MODE, false>;
}

// The instantiation for `mode` (MODE_PLAIN, MODE_C51, MODE_SAC) and `bf16`.
static const void* instantiation(int mode, int bf16) {
  return mode == MODE_C51   ? with_bf16<MODE_C51>(bf16)
         : mode == MODE_SAC ? with_bf16<MODE_SAC>(bf16)
                            : with_bf16<MODE_PLAIN>(bf16);
}

extern "C" {

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// `noise` is TD3's smoothing eps[K, B, act] when the target action is
// smoothed, SAC's normals [2, K, B, act] (eps_next, then eps_cur), else
// null; `support` (z[A]) is null unless the critic is distributional (C51);
// `mode` (MODE_PLAIN, MODE_C51, MODE_SAC) and `bf16` (0 or 1) select the
// instantiation.
int fused_chunk_launch(float* state, float* scratch, const float* batch, const float* noise,
                       const float* support, float* td_out, float* metrics, const int* counts,
                       const float* scale, const float* offset, const int* ip, const float* fp,
                       const int* tasks, int mode, int bf16, int grid, void* stream) {
  void* args[] = {&state, &scratch, &batch, &noise, &support, &td_out, &metrics, &counts,
                  &scale, &offset, &ip, &fp, &tasks};
  cudaError_t e = cudaLaunchCooperativeKernel(instantiation(mode, bf16), dim3(grid), dim3(NT),
                                              args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of the kernel that can be resident at once on `device` (the
// upper bound of a cooperative launch's grid), for every instantiation.
int fused_chunk_max_grid(int device, int* out) {
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  int lo = 1 << 30;
  for (int mode = MODE_PLAIN; mode <= MODE_SAC; ++mode) {
    for (int bf16 = 0; bf16 < 2; ++bf16) {
      int n = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, instantiation(mode, bf16), NT, 0);
      if (e != cudaSuccess) return (int)e;
      lo = n < lo ? n : lo;
    }
  }
  *out = sms * lo;
  return 0;
}

const char* fused_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
