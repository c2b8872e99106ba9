// K full DDPG or TD3 learner steps in one launch, for Hopper (sm_90a).
//
// Replaces: distributed_ddpg_tpu/ops/fused_chunk.py, make_fused_chunk_fn ->
// run -> pl.pallas_call (the kernel body _make_kernel.kernel), its DDPG
// TD(0) f32 branch (a) and its TD3 branch (b). The Python side
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define TILE 16
#define JC 256
#define NT 256
#define TASK_INTS 40
#define MAX_STAGES 64
#define LOADS (TILE * JC / NT)  // tile slots each thread loads, per operand

// Mirrors ops/fused_chunk.py.
enum { OP_FWD = 0, OP_DW = 1, OP_DX = 2 };
enum { BASE_STATE = 0, BASE_SCRATCH = 1, BASE_BATCH = 2, BASE_ONES = 3 };
enum {
  EPI_NONE = 0, EPI_RELU, EPI_TANH, EPI_TD, EPI_MASK, EPI_TANH_BWD, EPI_TANH_NOISE,
  EPI_TD3
};
enum {
  F_OP = 0, F_M = 1, F_N = 2, F_NSEG = 3, F_SEG = 4,
  F_C = 22, F_BIAS = 26, F_EPI = 28, F_AUX = 29, F_AUX2 = 32,
  F_TILE0 = 34, F_TILES_M = 35, F_TILES_N = 36
};
enum {
  IP_K = 0, IP_B, IP_D, IP_OBS, IP_ACT, IP_NSTAGES, IP_NA, IP_NC,
  IP_OFF_PA, IP_OFF_PC, IP_OFF_TA, IP_OFF_TC, IP_OFF_MUA, IP_OFF_NUA,
  IP_OFF_MUC, IP_OFF_NUC, IP_OFF_GA, IP_OFF_GC, IP_OFF_QPI, IP_OFF_PART,
  IP_OFF_STEPMET, IP_OFF_STEPNORM, IP_DELAY, IP_OFF_TD01, IP_STAGE_START,
  IP_STAGE_TILES = IP_STAGE_START + MAX_STAGES + 1,
  IP_STAGE_TILES_SKIP = IP_STAGE_TILES + MAX_STAGES
};
enum {
  FP_LR_A = 0, FP_LR_C, FP_B1, FP_OMB1, FP_B2, FP_OMB2, FP_EPS, FP_LOG_B1,
  FP_LOG_B2, FP_TAU, FP_OMTAU, FP_INV_B, FP_INV_K, FP_NEG2_INV_B
};

struct Ctx {
  float* state;
  float* scratch;
  const float* batch_k;  // this step's [B, D] packed rows
  const float* eps_k;    // this step's smoothing noise [B, act] (TD3), or null
  float* td_k;           // this step's td[B]
  const float* scale;
  const float* offset;
  int D, obs, act;
  float neg2_inv_b, inv_b;
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

__global__ void __launch_bounds__(NT, 1)
fused_chunk_kernel(float* state, float* scratch, const float* __restrict__ batch,
                   const float* __restrict__ noise, float* td_out, float* metrics,
                   const int* __restrict__ counts,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   const int* __restrict__ ip, const float* __restrict__ fp,
                   const int* __restrict__ tasks) {
  __shared__ float As[TILE][JC + 1];
  __shared__ float Bs[JC][TILE + 1];
  __shared__ float red[NT / 32];
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

  for (int k = 0; k < K; ++k) {
    // The delay schedule (DDPG: delay 1, every step updates everything).
    const int step = step0 + k;
    const bool upd = step % delay == 0;
    const int done_a = (step + delay - 1) / delay - (step0 + delay - 1) / delay;
    const Ctx c{state, scratch, batch + (size_t)k * B * D,
                noise ? noise + (size_t)k * B * act : nullptr, td_out + (size_t)k * B,
                scale, offset, D, obs, act, fp[FP_NEG2_INV_B], inv_b};
    for (int s = 0; s < nst; ++s) {
      const int t0 = ip[IP_STAGE_START + s], t1 = ip[IP_STAGE_START + s + 1];
      const int ntile = ip[(upd ? IP_STAGE_TILES : IP_STAGE_TILES_SKIP) + s];
      for (int tile = blockIdx.x; tile < ntile; tile += G) {
        int t = t0;
        while (t + 1 < t1 && tasks[(t + 1) * TASK_INTS + F_TILE0] <= tile) ++t;
        const int* T = tasks + t * TASK_INTS;
        run_tile(T, tile - T[F_TILE0], c, As, Bs);
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
      // TD3: the loss is the mean over both members, 0.5/B * sum w td_m^2.
      float wtd2 = 0.f, atd = 0.f, sq = 0.f;
      for (int m = tid; m < B; m += NT) {
        const float td = __ldcg(c.td_k + m);
        const float w = __ldg(c.batch_k + (size_t)m * D + 2 * obs + act + 2);
        if (twin) {
          const float td0 = __ldcg(td01 + m), td1 = __ldcg(td01 + B + m);
          wtd2 += w * td0 * td0 + w * td1 * td1;
        } else {
          wtd2 += w * td * td;
        }
        atd += fabsf(td);
        sq += __ldcg(qpi + m);
      }
      wtd2 = block_sum(wtd2, red);
      atd = block_sum(atd, red);
      sq = block_sum(sq, red);
      if (tid == 0) {
        const float aloss = -sq * inv_b;
        stepmet[k * 4 + 0] = wtd2 * (twin ? 0.5f * inv_b : inv_b);
        stepmet[k * 4 + 1] = aloss;
        stepmet[k * 4 + 2] = -aloss;
        stepmet[k * 4 + 3] = atd * inv_b;
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

extern "C" {

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
// `noise` (eps[K, B, act]) is null unless the TD3 target action is smoothed.
int fused_chunk_launch(float* state, float* scratch, const float* batch, const float* noise,
                       float* td_out, float* metrics, const int* counts, const float* scale,
                       const float* offset, const int* ip, const float* fp,
                       const int* tasks, int grid, void* stream) {
  void* args[] = {&state, &scratch, &batch, &noise, &td_out, &metrics, &counts,
                  &scale, &offset, &ip, &fp, &tasks};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)fused_chunk_kernel, dim3(grid),
                                              dim3(NT), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of the kernel that can be resident at once on `device` (the
// upper bound of a cooperative launch's grid).
int fused_chunk_max_grid(int device, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_chunk_kernel, NT, 0);
  if (e != cudaSuccess) return (int)e;
  *out = sms * per_sm;
  return 0;
}

const char* fused_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
