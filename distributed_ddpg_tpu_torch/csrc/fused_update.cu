// Fused Adam + Polyak update over the leaves of a parameter tree, for
// Hopper (sm_90a): one launch reads each leaf where it lies and writes the
// new leaves into the wrapper's output buffer.
//
// Replaces: distributed_ddpg_tpu/ops/fused_update.py, fused_adam_polyak ->
// _fused_flat -> pl.pallas_call (the kernel body _kernel). For each element
// of a parameter tree it takes the param p, Adam's moments m and v, the
// gradient g and the Polyak target t, and in one pass writes
//
//   m' = B1 * m + (1 - B1) * g
//   v' = B2 * v + (1 - B2) * (g * g)
//   p' = p - lr * (m' / bc1) / (sqrt(v' / bc2) + EPS)
//   t' = tau * p' + (1 - tau) * t
//
// with bc1 = 1 - B1^c, bc2 = 1 - B2^c from the new count c = count + 1.
//
// What bounds it on this card: bytes, in principle. An element is 5 reads
// and 4 writes of f32 (36 bytes) against ~17 operations, far below the ~20
// operations a byte the f32 peak needs, so at 3.35 TB/s a Pendulum critic
// (67,329 elements, 2.42 MB) takes at least 0.72 us. At that size the
// working set sits in the 50 MB L2, and what a launch costs is latency:
// the launch itself (an empty kernel with the same table and grid takes
// ~1.1 us in a CUDA graph), then a chain of dependent reads (the table,
// the data, the count) and each thread's divides and square root.
// PERF.md has the measured times.
//
// Design:
// - The TPU kernel walks one flattened vector padded to (256 x 128)
//   tiles. Here the wrapper (ops/fused_update.py) gathers nothing: the
//   launch takes a table of leaves by value (__grid_constant__, 3392 bytes,
//   under the 4 KB parameter limit): for each leaf the pointers of its five
//   inputs and four outputs and its length; and each leaf's first block.
//   A tree with more leaves than one table holds takes further launches of
//   the same kernel.
// - Each block takes one tile of one leaf: it walks the first blocks from
//   the start and stops at the first leaf past it, so a small tree's
//   blocks read one or two entries before they read their leaf's row.
// - One element a thread, 256 threads a block (264 blocks for the
//   Pendulum critic), so any leaf, unaligned or of any length, takes the
//   same path. Wider accesses (2 or 4 f32 a thread as float2 / float4)
//   were measured on an H100 and not kept: with fewer threads each one's
//   serial chain of loads, divides and stores is longer, and at the
//   Pendulum critic 4 f32 a thread took ~1.5x as long (PERF.md).
// - The count and the bias corrections are computed here: every thread
//   reads the count and computes 1 - powf(B, c) itself, and one thread
//   writes count + 1 into the new count, so a call needs no other launch
//   and no host read. powf of an f32 base and exponent is the function
//   PyTorch's pow kernel evaluates for the plain version's
//   `1.0 - torch.pow(B1, c)`; checked on the card for every count in
//   1..2^20 (chip_smoke.py, tests/test_torch_on_card.py).
// - Bit-identical to the plain version (ops/optim.adam_update, then
//   ops/polyak.polyak_update, in PyTorch): every operation is a separately
//   rounded IEEE op in the same order (__fmul_rn / __fadd_rn / __fsub_rn /
//   __fdiv_rn / __fsqrt_rn, so nvcc contracts nothing into an FMA), and the
//   constants are the f32 roundings of the same double expressions that
//   PyTorch rounds (1 - B1 is f32(0.09999999999999998), not 1.0f - 0.9f);
//   lr, tau and 1 - tau arrive rounded from the doubles, as the plain
//   version's scalars are.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr double kB1 = 0.9, kB2 = 0.999, kEps = 1e-8;   // ops/optim.py
constexpr float OMB1 = static_cast<float>(1.0 - kB1);
constexpr float B1 = static_cast<float>(kB1);
constexpr float B2 = static_cast<float>(kB2);
constexpr float OMB2 = static_cast<float>(1.0 - kB2);
constexpr float EPS = static_cast<float>(kEps);

// Leaves in one launch's table (ops/fused_update.MAX_LEAVES) and threads a
// block, one element each (ops/fused_update.THREADS).
constexpr int kMaxLeaves = 40;
constexpr int kThreads = 256;

// One leaf; 10 x 8 bytes, a row of the wrapper's table (ops/fused_update.py).
struct Leaf {
  const float* in[5];     // p, m, v, g, t
  float* out[4];          // p', m', v', t'
  long long n;            // elements
};

struct Table {
  // Each leaf's first block in this launch, then the launch's block count:
  // a block's leaf is the last whose first block is at or before it.
  int first_block[kMaxLeaves + 1];
  float lr, tau, omtau;   // omtau = f32(1 - tau), rounded from the double
  const int* count;       // the carried count (int32, on the device)
  int* new_count;         // count + 1, written by one thread
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(Leaf) == 80, "the wrapper packs 10 int64 a leaf");
static_assert(sizeof(Table) == kMaxLeaves * 84 + 32, "ops/fused_update.table_format");
static_assert(sizeof(Table) <= 4096, "a kernel parameter block is at most 4 KB");

// 1 - B^c for the new count c, as PyTorch evaluates 1.0 - torch.pow(B, c)
// on the card: powf of an f32 base and exponent, then one rounded subtract.
// The base is a compile-time constant, so the compiler may fold the part
// of powf that depends on the base alone; the sweep in chip_smoke.py holds
// the result to torch.pow bit for bit either way.
template <int WHICH>
__device__ __forceinline__ float bias_correction(int c) {
  return __fsub_rn(1.0f, powf(WHICH == 1 ? B1 : B2, __int2float_rn(c)));
}

__global__ void __launch_bounds__(kThreads) fused_update_kernel(const __grid_constant__ Table tab) {
  const int c = __ldg(tab.count) + 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) *tab.new_count = c;

  // The block's leaf: the last whose first block is at or before this one
  // (a leaf of no elements has no block and shares its first with the
  // next). The walk stops at the first leaf past this block, at the latest
  // at the block count, so a block of an early leaf reads only the first
  // few entries before it reads its leaf's row.
  const int b = blockIdx.x;
  int l = 0;
#pragma unroll 1
  for (int i = 1; i < kMaxLeaves && tab.first_block[i] <= b; ++i) l = i;
  const Leaf& leaf = tab.leaf[l];
  const long long e = static_cast<long long>(b - tab.first_block[l]) * kThreads + threadIdx.x;
  if (e >= leaf.n) return;

  // The update of element e: loads, the arithmetic in the plain version's
  // order, stores.
  const float p = __ldg(leaf.in[0] + e), m = __ldg(leaf.in[1] + e), v = __ldg(leaf.in[2] + e);
  const float g = __ldg(leaf.in[3] + e), t = __ldg(leaf.in[4] + e);
  const float bc1 = bias_correction<1>(c);
  const float bc2 = bias_correction<2>(c);
  const float mi = __fadd_rn(__fmul_rn(B1, m), __fmul_rn(OMB1, g));
  const float vi = __fadd_rn(__fmul_rn(B2, v), __fmul_rn(OMB2, __fmul_rn(g, g)));
  const float step = __fdiv_rn(__fmul_rn(tab.lr, __fdiv_rn(mi, bc1)),
                               __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), EPS));
  const float pi = __fsub_rn(p, step);
  leaf.out[0][e] = pi;
  leaf.out[1][e] = mi;
  leaf.out[2][e] = vi;
  leaf.out[3][e] = __fadd_rn(__fmul_rn(tab.tau, pi), __fmul_rn(tab.omtau, t));
}

// The launch floor: a kernel with the same table and grid that does nothing.
__global__ void empty_kernel(const __grid_constant__ Table tab) {}

// bc1 and bc2 of every new count 1..counts, by the update kernel's own
// expression (the check against PyTorch's pow).
__global__ void bias_sweep_kernel(float* bc1, float* bc2, int counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < counts) {
    bc1[i] = bias_correction<1>(i + 1);
    bc2[i] = bias_correction<2>(i + 1);
  }
}

}  // namespace

extern "C" {

// The size of the table a launch takes (the wrapper checks its own).
int fused_update_table_bytes() { return static_cast<int>(sizeof(Table)); }

// Launches the update on `stream` over the table at `table` (the bytes of
// one Table, copied into the kernel's parameters), `blocks` blocks of 256
// threads; with `empty`, the empty kernel on the same table and grid (the
// launch floor). Returns the CUDA error code (0 = ok).
int fused_update_launch(const void* table, long long blocks, int empty, void* stream) {
  Table tab;
  std::memcpy(&tab, table, sizeof(Table));
  const auto s = static_cast<cudaStream_t>(stream);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const auto grid = static_cast<unsigned>(blocks);
  if (empty) empty_kernel<<<grid, kThreads, 0, s>>>(tab);
  else fused_update_kernel<<<grid, kThreads, 0, s>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

// bc1[i], bc2[i] for the new count i + 1, i < counts, as the update computes them.
int fused_update_bias_sweep(float* bc1, float* bc2, int counts, void* stream) {
  if (counts <= 0) return 0;
  bias_sweep_kernel<<<(counts + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      bc1, bc2, counts);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
