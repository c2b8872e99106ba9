// Fused Adam + Polyak update over one flat f32 buffer, for Hopper (sm_90a).
//
// Replaces: distributed_ddpg_tpu/ops/fused_update.py, fused_adam_polyak ->
// _fused_flat -> pl.pallas_call (the kernel body _kernel). For each element
// of a flattened parameter tree it takes the param p, Adam's moments m and
// v, the gradient g and the Polyak target t, and in one pass writes
//
//   m' = B1 * m + (1 - B1) * g
//   v' = B2 * v + (1 - B2) * (g * g)
//   p' = p - lr * (m' / bc1) / (sqrt(v' / bc2) + EPS)
//   t' = tau * p' + (1 - tau) * t
//
// with bc1 = 1 - B1^c, bc2 = 1 - B2^c from the new count c.
//
// What bounds it on this card: bytes. An element is 5 reads and 4 writes of
// f32 (36 bytes) against ~15 operations, far below the ~20 operations a
// byte the f32 peak needs, so at 3.35 TB/s a Pendulum critic (67,329
// elements, 2.42 MB) takes at least 0.72 us; at that size the launch itself
// is the larger cost (PERF.md has the measured times).
//
// Design:
// - The TPU kernel pads the flat vector to (256 x 128) tiles and walks them
//   as a grid. Here one thread takes one element in a grid-stride loop, so
//   no padding is needed and any length works.
// - The update is in place: the wrapper (ops/fused_update.py) gathers the
//   params, moments, targets and gradients into fresh flat buffers, and
//   the kernel overwrites the first four; the new state's leaves are views
//   into them. Each thread reads an element before it writes it, and no
//   two pointers alias.
// - Bit-identical to the plain version (ops/optim.adam_update, then
//   ops/polyak.polyak_update, in PyTorch): every operation is a separately
//   rounded IEEE op in the same order (__fmul_rn / __fadd_rn / __fsub_rn /
//   __fdiv_rn / __fsqrt_rn, so nvcc contracts nothing into an FMA), and the
//   constants are the f32 roundings of the same double expressions that
//   PyTorch rounds (1 - B1 is f32(0.09999999999999998), not 1.0f - 0.9f).
//   bc1 and bc2 arrive in device memory, computed on the card from the
//   count with the plain version's own expression, so no host read of the
//   count is needed; 1 - tau arrives rounded from the double, as the plain
//   version's scalar does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr double kB1 = 0.9, kB2 = 0.999, kEps = 1e-8;   // ops/optim.py
constexpr float B1 = static_cast<float>(kB1);
constexpr float OMB1 = static_cast<float>(1.0 - kB1);
constexpr float B2 = static_cast<float>(kB2);
constexpr float OMB2 = static_cast<float>(1.0 - kB2);
constexpr float EPS = static_cast<float>(kEps);
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
fused_update_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                    const float* __restrict__ g, float* __restrict__ t,
                    const float* __restrict__ bc1_ptr, const float* __restrict__ bc2_ptr,
                    float lr, float tau, float omtau, int64_t n) {
  const float bc1 = *bc1_ptr;
  const float bc2 = *bc2_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; i < n; i += stride) {
    const float gi = g[i];
    const float mi = __fadd_rn(__fmul_rn(B1, m[i]), __fmul_rn(OMB1, gi));
    const float vi = __fadd_rn(__fmul_rn(B2, v[i]), __fmul_rn(OMB2, __fmul_rn(gi, gi)));
    const float step = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mi, bc1)),
                                 __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), EPS));
    const float pi = __fsub_rn(p[i], step);
    m[i] = mi;
    v[i] = vi;
    p[i] = pi;
    t[i] = __fadd_rn(__fmul_rn(tau, pi), __fmul_rn(omtau, t[i]));
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over n elements, updating p, m, v and t in
// place; bc1 and bc2 point at one f32 each on the device. `blocks` of 256
// threads (the wrapper caps it; the loop strides over the rest). Returns the
// CUDA error code (0 = ok).
int fused_update_launch(float* p, float* m, float* v, const float* g, float* t,
                        const float* bc1, const float* bc2, float lr, float tau, float omtau,
                        long long n, int blocks, void* stream) {
  if (n <= 0) return 0;
  fused_update_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      p, m, v, g, t, bc1, bc2, lr, tau, omtau, static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
