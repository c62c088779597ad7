// Fused V-trace: rho clipping, TD deltas and the reverse recursion in one pass.
//
// Replaces the TPU kernel `_vtrace_kernel` / `vtrace_pallas` in
// distributed_reinforcement_learning_tpu/ops/pallas/vtrace.py. The recursion:
//
//   delta_t = min(rho_bar, rho_t) * (r_t + gamma_t * V_{t+1} - V_t)
//   acc_t   = delta_t + gamma_t * min(c_bar, rho_t) * acc_{t+1}
//   vs_t    = acc_t + V_t                       (V_T = bootstrap value)
//
// What bounds it on an H100: at the IMPALA learn step's shape (T=18,
// B=32) a call moves ~14 KB, about 4 ns at 3.35 TB/s, and does ~10 flops
// per element, so the launch and the latency of one block's work are the
// cost. At large B it is bound by bytes: each input is read once and each
// output written once.
//
// Design: a staged slab. A block owns a slab of columns and walks it in
// chunks of rows from the end, carrying acc (and V_{t+1}) from chunk to
// chunk, so any T >= 1 runs; a block may own several slabs (the grid is
// capped at 4 blocks an SM), and its items, a slab's chunks in turn, are
// double-buffered in shared memory: the next item's copies fly while this
// one is computed. Per item:
//   1. every thread starts its copies of the chunk of the four inputs and
//      of V_{t+1} of the chunk's last row (the bootstrap value for the
//      last chunk): 16-byte cp.async where every row is 16-byte aligned,
//      4-byte otherwise, all in flight at once. A block's thread count is
//      a multiple of a row's copies, so each thread keeps one column group
//      and steps its addresses by whole rows (index arithmetic here, a
//      division a copy, cost ~0.5 us of the path's call on an H100);
//   2. the elementwise work: rho, the clipped rho (written out at once,
//      coalesced), gamma * min(c_bar, rho) and delta;
//   3. the T-step recursion, one thread a column, out of shared memory;
//      each step's vs goes out at once (a warp's row, one 128-byte store).
// Two shapes of block. Up to B = 96, 32-column slabs of up to 32 rows
// (one chunk at the path's T = 18), 256 threads: all 8 warps share the
// copies and the elementwise work (coef and delta go to shared memory),
// then warp 0 runs the recursion with only the chain's two rounded
// operations a step left in it. Wider, 128-column slabs of up to 10 rows
// (two chunks at T = 20: the second one's copies overlap the first one's
// work), 128 threads, a thread a column: each computes its column's
// elements 4 rows at a time (their loads and elementwise work first, then
// the chain) and runs its recursion, with no barrier between.
//
// Arithmetic: each product and sum is rounded on its own (__fmul_rn and
// __fadd_rn forbid nvcc's multiply-add contraction), in the order of the
// plain PyTorch version, which runs every operation as its own kernel.
// With expf at full precision (no --use_fast_math) the kernel then gives
// the plain version's bits on the card, which makes the on-card check a
// sharp one; a parallel scan over T would round in another order. The
// clips propagate a NaN rho as `torch.clamp` and `jnp.minimum` do
// (`fminf` would return the bound).
//
// Bound through ctypes: plain C interface, device pointers and the
// caller's stream, cudaError_t returned to the caller.
//
// Built with -DDRL_VTRACE_PHASES (which ops/kernels/_build.py never sets),
// the kernel also writes the globaltimer at each phase boundary of a
// block's first item: scripts/vtrace_phase_profile.py reads them.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Threads of a block: a 128-column slab has a thread a column; a
// 32-column slab's block is wider, to share the copies and the elementwise
// work that its one recursion warp would otherwise run alone.
__host__ __device__ constexpr int threads_for(int cols) { return cols == 128 ? 128 : 256; }
constexpr int kInputs = 4;  // log_rhos, discounts, rewards, values
// Rows of a chunk at most: all the paths' T in one chunk of a 32-column
// slab; two chunks of a 128-column slab at T = 20, so that the second
// one's copies overlap the first one's work.
constexpr int kNarrowRows = 32;
constexpr int kWideRows = 10;
constexpr int kBlocksPerSm = 4;  // the grid's cap, per SM
constexpr int kBatch = 4;        // rows a column thread takes at once (128-column slabs)

#ifdef DRL_VTRACE_PHASES
// [blocks, 8] of globaltimer readings (ns) per block, or null: 0 start,
// 6 the first item's copies issued, 1 it has landed, 2 (32-column slabs)
// its elementwise work done, 3 its columns done, 4 the block's last item
// done; 5 holds the number of items.
__device__ unsigned long long* g_marks;
#define MARK(i)                                                              \
  do {                                                                       \
    if (threadIdx.x == 0 && g_marks) {                                       \
      unsigned long long ns;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                 \
      g_marks[static_cast<size_t>(blockIdx.x) * 8 + (i)] = ns;               \
    }                                                                        \
  } while (0)
#define COUNT(n)                                                             \
  do {                                                                       \
    if (threadIdx.x == 0 && g_marks) g_marks[static_cast<size_t>(blockIdx.x) * 8 + 5] = (n); \
  } while (0)
#else
#define MARK(i) \
  do {          \
  } while (0)
#define COUNT(n) \
  do {           \
  } while (0)
#endif

// min(bound, x), NaN when x is NaN (fminf would return the bound); the
// bits of fminf on every other input.
__device__ __forceinline__ float clip(float bound, float x) { return bound < x ? bound : x; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A copy of kW floats (16 or 4 bytes) from global to shared memory (a
// shared-space address), zero-filled, and nothing read, when !valid.
template <int kW>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool valid) {
  if constexpr (kW == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

struct Inputs {
  const float* log_rhos;
  const float* discounts;
  const float* rewards;
  const float* values;
  const float* bootstrap;
};

// Start copying the n rows from `src` (the slab's first column of a
// [T, B] input's first row) into a [n][kCols] chunk at shared address
// `dst`, kW floats a copy, zero past column B. The block's threads are a
// multiple of a row's copies, so each thread keeps one column group: its
// address steps by whole rows, with no division in the loop.
template <int kCols, int kW>
__device__ __forceinline__ void stage_rows(uint32_t dst, const float* src, int n, int B,
                                           int col0) {
  constexpr int kPerRow = kCols / kW, kRowStep = threads_for(kCols) / kPerRow;
  const int r0 = threadIdx.x / kPerRow, c = threadIdx.x % kPerRow * kW;
  const bool valid = col0 + c < B;  // B % kW == 0: a group is wholly in or out
  const float* p = src + static_cast<size_t>(r0) * B + (valid ? c : 0);
  dst += 4u * (r0 * kCols + c);
  for (int r = r0; r < n; r += kRowStep) {
    cp_async<kW>(dst, p, valid);
    dst += 4u * kRowStep * kCols;
    p += static_cast<size_t>(kRowStep) * B;
  }
}

// Start the copies of one item, chunk k of a slab (rows [T - (k + 1)
// rows, T - k rows), cut at 0), into the stage at shared address `s`:
// the four inputs' [n][kCols] chunks, then V_{t+1} of the chunk's last
// row (the bootstrap value for the last chunk), kW floats a copy. Every
// thread of the block calls it, and commits one group.
template <int kCols, int kW>
__device__ __forceinline__ void start_item(uint32_t s, const Inputs& in, int T, int B, int rows,
                                           int slab, int k) {
  const int col0 = slab * kCols;
  const uint32_t slot = 4u * rows * kCols;
  const int t_end = T - k * rows, t0 = max(0, t_end - rows), n = t_end - t0;
  const size_t first = static_cast<size_t>(t0) * B + col0;
  stage_rows<kCols, kW>(s, in.log_rhos + first, n, B, col0);
  stage_rows<kCols, kW>(s + slot, in.discounts + first, n, B, col0);
  stage_rows<kCols, kW>(s + 2 * slot, in.rewards + first, n, B, col0);
  stage_rows<kCols, kW>(s + 3 * slot, in.values + first, n, B, col0);
  const float* top = t_end < T ? in.values + static_cast<size_t>(t_end) * B : in.bootstrap;
  stage_rows<kCols, kW>(s + kInputs * slot, top + col0, 1, B, col0);
  cp_async_commit();
}

// A block walks its items: slab blockIdx.x's chunks, latest rows first,
// then slab blockIdx.x + gridDim.x's, and so on, through two stages in
// dynamic shared memory.
template <int kCols, int kW>
__global__ void __launch_bounds__(threads_for(kCols))
vtrace_kernel(Inputs in, float* __restrict__ vs, float* __restrict__ clipped_rhos, int T,
              int B, int rows, float clip_rho, int has_clip_rho, float clip_c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t smem_base = smem_addr(smem);
  const int tid = threadIdx.x;
  const int n_slabs = (B + kCols - 1) / kCols;
  const int n_chunks = (T + rows - 1) / rows;
  const int slot = rows * kCols;
  const int stage_floats = kInputs * slot + kCols;

  MARK(0);
  int slab = blockIdx.x, k = 0, buf = 0, items = 0;
  start_item<kCols, kW>(smem_base, in, T, B, rows, slab, k);
  MARK(6);
  float acc = 0.0f;  // acc_{t+1} of this thread's column
  while (slab < n_slabs) {
    int next_slab = slab, next_k = k + 1;
    if (next_k == n_chunks) next_k = 0, next_slab += gridDim.x;
    cp_async_wait_all();
    // This item has landed for every thread, and every thread is done
    // with the other stage (the item before).
    __syncthreads();
    if (items == 0) MARK(1);
    if (next_slab < n_slabs)
      start_item<kCols, kW>(smem_base + 4u * (buf ^ 1) * stage_floats, in, T, B, rows,
                            next_slab, next_k);

    float* s = smem + buf * stage_floats;
    const int t_end = T - k * rows, t0 = max(0, t_end - rows), n = t_end - t0;
    const ptrdiff_t ld = B;  // a row's stride in the [T, B] arrays
    if constexpr (kCols == threads_for(kCols)) {
      // 128 columns: thread c computes every element of column c and runs
      // its recursion, kBatch rows at a time, latest first: first their
      // loads and elementwise work, which do not wait on acc, with no
      // branch (rows past 0 repeat row 0 and go unused), so the rows
      // overlap; then the two rounded operations a row that chain through
      // acc, and the stores (a warp's row of 32 one coalesced 128-byte
      // store), through pointers that step a row at a time.
      const int col = slab * kCols + tid;
      const bool own = col < B;
      float* vs_p = vs + (t0 + n - 1) * ld + col;  // row top
      float* rho_p = clipped_rhos + (t0 + n - 1) * ld + col;
      float v_next = s[kInputs * slot + tid];
      if (k == 0) acc = 0.0f;
      for (int top = n - 1; top >= 0; top -= kBatch) {
        float clipped[kBatch], coef[kBatch], delta[kBatch], v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = max(top - j, 0) * kCols + tid;
          const float rho = expf(s[i]);
          const float gamma = s[slot + i];
          v[j] = s[3 * slot + i];
          clipped[j] = has_clip_rho ? clip(clip_rho, rho) : rho;
          coef[j] = __fmul_rn(gamma, clip(clip_c, rho));
          delta[j] = __fmul_rn(
              clipped[j], __fsub_rn(__fadd_rn(s[2 * slot + i], __fmul_rn(gamma, v_next)), v[j]));
          v_next = v[j];
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (top - j >= 0) {
            acc = __fadd_rn(delta[j], __fmul_rn(coef[j], acc));
            if (own) {
              rho_p[-j * ld] = clipped[j];
              vs_p[-j * ld] = __fadd_rn(acc, v[j]);
            }
          }
        }
        vs_p -= kBatch * ld;
        rho_p -= kBatch * ld;
      }
    } else {
      // 32 columns: one warp alone would issue every element's work in
      // turn, so the block's warps share it. Thread tid takes column
      // tid % 32 at rows tid / 32, + kSteps, ..., writes gamma * min(c_bar,
      // rho) over the log-rho and delta over the reward, and the clipped
      // rho out; then warp 0 runs the recursion, only the chain's
      // operations left in it. Both loops are short and step their
      // addresses by rows: at the path's shape a call is one block whose
      // time is these loops' latency.
      constexpr int kSteps = threads_for(kCols) / kCols;
      const int c = tid % kCols, r0 = tid / kCols;
      const int col = slab * kCols + c;
      const bool own = col < B;
      float* rho_p = clipped_rhos + (t0 + r0) * ld + col;
#pragma unroll 2
      for (int r = r0; r < n; r += kSteps, rho_p += kSteps * ld) {
        const int i = r * kCols + c;
        const float rho = expf(s[i]);
        const float gamma = s[slot + i], v = s[3 * slot + i];
        const float v_next = r + 1 < n ? s[3 * slot + i + kCols] : s[kInputs * slot + c];
        const float clipped = has_clip_rho ? clip(clip_rho, rho) : rho;
        const float delta = __fmul_rn(
            clipped, __fsub_rn(__fadd_rn(s[2 * slot + i], __fmul_rn(gamma, v_next)), v));
        s[i] = __fmul_rn(gamma, clip(clip_c, rho));
        s[2 * slot + i] = delta;
        if (own) *rho_p = clipped;
      }
      __syncthreads();
      if (items == 0) MARK(2);
      if (tid < kCols) {
        float* vs_p = vs + (t0 + n - 1) * ld + col;
        const float* cf = s + (n - 1) * kCols + tid;
        if (k == 0) acc = 0.0f;
#pragma unroll 4
        for (int r = n - 1; r >= 0; --r, vs_p -= ld, cf -= kCols) {
          acc = __fadd_rn(cf[2 * slot], __fmul_rn(cf[0], acc));
          if (own) *vs_p = __fadd_rn(acc, cf[3 * slot]);
        }
      }
    }
    if (items++ == 0) MARK(3);
    slab = next_slab, k = next_k, buf ^= 1;
  }
  MARK(4);
  COUNT(items);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The SM count of each device, read once.
int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    counts[device] = 0;
  return counts[device];
}

template <int kCols, int kMaxRows, int kW>
int launch(const Inputs& in, float* vs, float* clipped_rhos, int T, int B, float clip_rho,
           int has_clip_rho, float clip_c, int sms, cudaStream_t stream) {
  const int n_chunks = (T + kMaxRows - 1) / kMaxRows;
  const int rows = (T + n_chunks - 1) / n_chunks;  // chunks of (nearly) equal size
  const int n_slabs = (B + kCols - 1) / kCols;
  const int blocks = n_slabs < kBlocksPerSm * sms ? n_slabs : kBlocksPerSm * sms;
  const int stages = n_chunks > 1 || n_slabs > blocks ? 2 : 1;
  static_assert(sizeof(float) * 2 * (kInputs * kMaxRows * kCols + kCols) <= 48 * 1024,
                "two stages fit the default dynamic shared memory of a block");
  const size_t smem = sizeof(float) * stages * (kInputs * rows * kCols + kCols);
  vtrace_kernel<kCols, kW><<<blocks, threads_for(kCols), smem, stream>>>(
      in, vs, clipped_rhos, T, B, rows, clip_rho, has_clip_rho, clip_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int drl_vtrace(const float* log_rhos, const float* discounts,
                          const float* rewards, const float* values,
                          const float* bootstrap, float* vs,
                          float* clipped_rhos, int T, int B, float clip_rho,
                          int has_clip_rho, float clip_c, int device,
                          void* stream) {
  // This library links its own CUDA runtime, whose current device is
  // not PyTorch's: select the tensors' device (only when it differs, so
  // a launch inside CUDA-graph capture makes no device switch).
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(device);
  if (T < 1 || B < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need every row of every input on a 16-byte boundary.
  const int vec = B % 4 == 0 && aligned16(log_rhos) && aligned16(discounts) &&
                  aligned16(rewards) && aligned16(values) && aligned16(bootstrap);
  const Inputs in{log_rhos, discounts, rewards, values, bootstrap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Up to 96 columns: 32-column slabs, warp 0 computing and the 4 warps
  // copying; wider: 128-column slabs, a thread a column.
  if (B <= 96)
    return vec ? launch<32, kNarrowRows, 4>(in, vs, clipped_rhos, T, B, clip_rho, has_clip_rho,
                                            clip_c, sms, s)
               : launch<32, kNarrowRows, 1>(in, vs, clipped_rhos, T, B, clip_rho, has_clip_rho,
                                            clip_c, sms, s);
  return vec ? launch<128, kWideRows, 4>(in, vs, clipped_rhos, T, B, clip_rho, has_clip_rho,
                                         clip_c, sms, s)
             : launch<128, kWideRows, 1>(in, vs, clipped_rhos, T, B, clip_rho, has_clip_rho,
                                         clip_c, sms, s);
}

#ifdef DRL_VTRACE_PHASES
extern "C" int drl_vtrace_set_marks(unsigned long long* marks) {
  return static_cast<int>(cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks)));
}
#endif

extern "C" const char* drl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
