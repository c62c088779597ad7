// Done-masked LSTM recursion: forward (K2a) and hand-derived BPTT (K2b).
//
// Replaces the TPU kernels `_fwd_kernel` / `_fwd_call` and `_bwd_kernel` /
// `_bwd_call` in distributed_reinforcement_learning_tpu/ops/pallas/lstm.py.
// Time-major float32: xg [T,B,4H] (input projection plus bias, computed
// outside), wh [H,4H], keep [T,B] (1 - done), h0/c0 [B,H]. Gate math is
// TF1 LSTMCell with forget bias 1:
//
//   gates_t = xg_t + h_{t-1} @ Wh          (i, f, g, o: columns k*H + j)
//   c_t = sigmoid(f + 1) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
//   carry (h, c) <- (h_t, c_t) * keep_t    (h_all, c_all keep the pre-mask values)
//
// What bounds it on an H100: the serial chain of T steps, then
// operations. At the R2D2 learn step's shape (T=10, B=32, H=512) the
// forward does 2*T*B*H*4H = 671 MFLOP, 10.0 us at the 67 TFLOP/s float32
// peak, against ~8 MB of bytes (2.4 us at 3.35 TB/s); the backward
// recomputes the gates and adds dgates @ Wh^T, twice the operations.
// One step is ~67 MFLOP, ~1 us on the whole card, so what it costs to end
// a step (a grid barrier) and to bring every SM what the step before it
// wrote sets the pace as much as the arithmetic.
//
// Design: persistent kernels. The Pallas kernels keep all of Wh in VMEM
// across a sequential time grid; here Wh (4 MiB at H = 512) is split
// across the SMs' shared memory and a grid barrier takes the place of
// the time axis.
//
// - One cooperative launch per call, at most one block per SM: the
//   caller's plan (`ops/kernels/lstm.py:lstm_plan`) sizes the grid from
//   the SM count, and `launch` refuses a grid that the occupancy query
//   says cannot be resident all at once, so the barrier cannot deadlock.
// - Block g owns `units` hidden units j and keeps the 4*units gate
//   columns k*H + j of Wh resident in shared memory for the whole call
//   (34 KB at H = 512 on 128 blocks). The cell update of its units stays
//   in the block.
// - Forward step t: every block stages the carried h_{t-1} (B x H, from
//   L2) in chunks of `rows` batch rows, multiplies it by its resident
//   columns (scaled by keep_{t-1} afterwards), adds xg_t, writes h_all[t]
//   and c_all[t] for its units; then one grid barrier. A step's xg, keep
//   and carried c are loaded before the barrier that precedes it.
// - Backward: phase 1 recomputes the gates xg_t + h_{t-1} @ Wh for all
//   T * B rows at once with the resident columns (no serial dependency,
//   no barrier) and parks them in dxg. Phase 2, step t (from T-1 down):
//   dh_carry for the block's units is the sum, over all blocks in order,
//   of their partial products from step t+1; the cell gradients turn the
//   parked gates into dgates_t in place and carry dc; the block's partial
//   product dgates_t[:, its columns] @ Wh[:, its columns]^T for every unit
//   goes to global scratch (two halves, alternating by step); then one
//   grid barrier. dh0 is one more sum after the last barrier. A block so
//   writes B x H partials and reads B x units x blocks of them a step
//   (16 MB in all at B = 32, no two blocks on the same lines), where
//   reading all of dgates_{t+1} into every block (the layout that keeps
//   Wh's rows resident too) moves 32 MB a step, every block on the same
//   lines (PERF.md has both measured). No transpose of Wh.
// - The products are one routine, `product`: the left operand (rows x
//   K) is staged row-major in shared memory with cp.async (L2 only; each
//   block starts at another offset, so the blocks, which all read the
//   same rows, do not queue on the same L2 slice), in four copy groups
//   so that FMAs on the first parts run while the rest are in flight. A
//   thread owns 8 rows x 4 columns over every S-th k-quad; the lanes
//   that split an item's K meet by a shuffle reduce-scatter, and warp
//   groups that split it further in shared memory, in a fixed order.
// - Memory order: what one block writes and another reads inside the
//   launch (h_all forward, the partial sums backward) is read through L2
//   (cp.async.cg) after the barrier, never through the read-only path.
//   One writer per output and no atomics, so two calls on the same
//   inputs give the same bits.
// - Arithmetic in float32 on the CUDA cores, no TF32 and no fast math,
//   so the kernels match the plain PyTorch versions (float32 cuBLAS with
//   TF32 off) to the rounding of H-term sums taken in another order.
//
// The range: the resident columns take 4 * (4 * units + 1) * H bytes
// beside the gate sums and the staged rows, within 227 KB a block. The
// limit is `ops/kernels/lstm.py:max_hidden` (H = 1056 on 132 SMs); the
// wrapper raises above it, and the launch refuses a plan whose regions
// are smaller than what the kernels index (`plan_fits`).
//
// Bound through ctypes: plain C interface, device pointers and the
// caller's stream, cudaError_t returned to the caller.
//
// Built with -DDRL_LSTM_PHASES (which ops/kernels/_build.py never sets),
// the kernels also write the globaltimer at each phase boundary of a
// step: scripts/lstm_phase_profile.py reads them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

#ifdef DRL_LSTM_PHASES
// [blocks, 64 slots, 8 marks] of globaltimer readings (ns), or null.
__device__ unsigned long long* g_marks;
// Every block of the grid meets at a barrier, and its thread 0 writes
// the time to mark i of slot `slot` (none where slot < 0).
#define MARK(slot, i)                                                                 \
  do {                                                                                \
    if ((slot) >= 0) {                                                                \
      __syncthreads();                                                                \
      if (threadIdx.x == 0 && g_marks) {                                              \
        unsigned long long ns;                                                        \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                        \
        g_marks[(static_cast<size_t>(blockIdx.x) * 64 + (slot)) * 8 + (i)] = ns;       \
      }                                                                               \
    }                                                                                 \
  } while (0)
#else
#define MARK(slot, i) \
  do {                \
    (void)(slot);     \
  } while (0)
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 8;  // batch rows per thread
constexpr int kColTile = 4;  // columns per thread
constexpr int kMaxOut = 4;   // cell outputs per thread and chunk (rows * units <= 1024)
constexpr int kParts = 2;    // cp.async groups a staged chunk is split into

// The caller's launch plan (`ops/kernels/lstm.py:lstm_plan`): units per
// block, batch rows per chunk (and, backward, rows of the flattened
// [T * B] gate recompute per chunk), and the floats of the three
// shared-memory regions: resident weights, gate sums, staged rows.
struct Plan {
  int units;
  int rows;
  int rows_all;
  int w_floats;
  int red_floats;
  int stage_floats;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  // L2 only (.cg): the source may have been written by another block of
  // this launch. src-size 0 fills the 16 bytes with zeros.
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` (0 or 1) of this thread's cp.async groups are
// pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}

// How a product over rows x cols outputs spreads over the block: an
// item is one 8 x 4 output tile; s_lane lanes of a warp (a power of two,
// at most 32) split its K, and s_warp groups of wi warps split it
// further. `ops/kernels/lstm.py:_split_layout` mirrors this; the launch
// refuses a plan that does not (`plan_fits`).
struct Split {
  int s_lane, s_warp, wi;
};

__host__ __device__ __forceinline__ Split split_of(int rows, int cols) {
  const int ni = (rows / kRowTile) * (cols / kColTile);
  int s_lane = 32;
  while (s_lane * ni > kThreads) s_lane >>= 1;
  const int wi = (ni + 32 / s_lane - 1) / (32 / s_lane);
  return Split{s_lane, kWarps / wi, wi};
}

// Weights resident in shared memory, [K, cols] with cols a multiple of
// 4, laid out by k-quads: the 4 x 4 block (k-quad q, column group g) at
// q * (4 * cols + 4) + 16 * g. The 4 floats of padding per quad put the
// quads that neighbouring lanes read in different banks.
__device__ __forceinline__ int w_index(int k, int col, int cols) {
  return (k >> 2) * (4 * cols + 4) + (col >> 2) * 16 + (k & 3) * 4 + (col & 3);
}

// Issue the cp.async copies of quads [q0, q1) of rows n0 .. n0+rows of
// the left operand (chunk k0) into stage (row-major, ld floats a row).
// Each block starts at another offset, so that the blocks, which all
// read the same rows, spread over the L2 slices instead of meeting on
// one.
template <class Row>
__device__ __forceinline__ void stage_quads(Row row, int n0, int N, int k0, int q0, int q1,
                                            int rows, int ld, float* stage) {
  const int width = q1 - q0;
  const int total = rows * width;
  if (total <= 0) return;
  const int shift = static_cast<int>((static_cast<long long>(blockIdx.x) * total) / gridDim.x);
  int idx = threadIdx.x + shift;
  if (idx >= total) idx -= total;
  // (r, q) of element idx, stepped by kThreads elements without a division.
  int r = idx / width, q = idx - r * width;
  const int dr = kThreads / width, dq = kThreads - dr * width;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const bool valid = n0 + r < N;
    cp_async16(stage + r * ld + 4 * (q0 + q), row(valid ? n0 + r : n0) + k0 + 4 * (q0 + q),
               valid);
    q += dq;
    r += dr;
    if (q >= width) {
      q -= width;
      ++r;
    }
    if (r >= rows) r -= rows;
  }
}

// One halving step of the reduce-scatter across the lanes of an item:
// lanes that differ in bit `mask` swap halves of their kHalf * 2 live
// sums, and each keeps the total of one half.
template <int kHalf>
__device__ __forceinline__ void reduce_scatter_step(float* acc, int lane, int mask, int& base) {
  const bool upper = lane & mask;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? acc[i] : acc[i + kHalf];
    const float keep = upper ? acc[i + kHalf] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
  base += upper ? kHalf : 0;
}

// The FMAs of quads q = first, first + S, ... below q1 of one staged chunk.
__device__ __forceinline__ int tile_quads(float* acc, const float* wk, const float* sk, int ld,
                                          int wq_stride, int first, int q1, int S) {
  int q = first;
#pragma unroll 2
  for (; q < q1; q += S) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wv[i] = *reinterpret_cast<const float4*>(wk + q * wq_stride + 4 * i);
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(sk + r * ld + 4 * q);
      float* o = acc + r * kColTile;
#pragma unroll
      for (int c = 0; c < kColTile; ++c) {
        const float wc0 = c == 0 ? wv[0].x : c == 1 ? wv[0].y : c == 2 ? wv[0].z : wv[0].w;
        const float wc1 = c == 0 ? wv[1].x : c == 1 ? wv[1].y : c == 2 ? wv[1].z : wv[1].w;
        const float wc2 = c == 0 ? wv[2].x : c == 1 ? wv[2].y : c == 2 ? wv[2].z : wv[2].w;
        const float wc3 = c == 0 ? wv[3].x : c == 1 ? wv[3].y : c == 2 ? wv[3].z : wv[3].w;
        o[c] = fmaf(a.x, wc0, o[c]);
        o[c] = fmaf(a.y, wc1, o[c]);
        o[c] = fmaf(a.z, wc2, o[c]);
        o[c] = fmaf(a.w, wc3, o[c]);
      }
    }
  }
  return q;
}

// A thread's place in a product over rows x cols outputs (`split_of`).
struct Tiling {
  int S;       // K splits in all
  int ks;      // this thread's split
  int wsplit;  // its warp group
  int item, rg, cgrp;
  bool in_grid, active;
  int s_lane;
};

__device__ __forceinline__ Tiling tiling(int rows, int cols) {
  const Split sp = split_of(rows, cols);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = cols / kColTile;
  const int ni = (rows / kRowTile) * groups;
  Tiling tl;
  tl.item = (warp % sp.wi) * (32 / sp.s_lane) + lane / sp.s_lane;
  tl.wsplit = warp / sp.wi;
  tl.S = sp.s_warp * sp.s_lane;
  tl.ks = tl.wsplit * sp.s_lane + lane % sp.s_lane;
  tl.in_grid = tl.wsplit < sp.s_warp;
  tl.active = tl.in_grid && tl.item < ni;
  tl.rg = tl.item / groups;
  tl.cgrp = tl.item % groups;
  tl.s_lane = sp.s_lane;
  return tl;
}

// The lanes that split an item's K meet by shuffles (a reduce-scatter:
// each ends with 32 / s_lane of the sums) and write them to `gates`, one
// slice per warp group; then a barrier.
__device__ __forceinline__ void store_sums(float* acc, const Tiling& tl, int rows, int cols,
                                           float* gates) {
  if (tl.in_grid) {  // whole warps: every lane takes part in the shuffles
    const int lane = threadIdx.x % 32;
    int base = 0;
    if (tl.s_lane > 1) reduce_scatter_step<16>(acc, lane, 1, base);
    if (tl.s_lane > 2) reduce_scatter_step<8>(acc, lane, 2, base);
    if (tl.s_lane > 4) reduce_scatter_step<4>(acc, lane, 4, base);
    if (tl.s_lane > 8) reduce_scatter_step<2>(acc, lane, 8, base);
    if (tl.s_lane > 16) reduce_scatter_step<1>(acc, lane, 16, base);
    const int live = kRowTile * kColTile / tl.s_lane;
    if (tl.active) {
      float* out = gates + (tl.wsplit * rows + tl.rg * kRowTile) * cols + tl.cgrp * kColTile;
#pragma unroll
      for (int i = 0; i < kRowTile * kColTile; ++i) {
        if (i < live) {
          const int f = base + i;
          out[(f / kColTile) * cols + f % kColTile] = acc[i];
        }
      }
    }
  }
  __syncthreads();
}

// gates[(w * rows + r) * cols + col] <- warp group w's share of
// sum_k lhs(n0 + r)[k] * w[k, col] for r < rows; rows n >= N are zeros.
// `row(n)` points at row n of the left operand (K floats, 16-byte
// aligned). The rows are staged row-major in shared memory with
// cp.async, in chunks of K that fit; a chunk's k-quads are kParts copy
// groups, and the FMAs on the first parts run while the rest are in
// flight. A thread accumulates its 8 x 4 tile over every S-th k-quad
// (`tile_quads`), then `store_sums`. Every sum is taken in a fixed order.
// `slot`: where the first chunk's phase marks go (-1: none).
template <class Row>
__device__ void product(Row row, int n0, int N, int K, const float* w, int cols, int rows,
                        float* stage, int stage_floats, float* gates, int slot) {
  const Tiling tl = tiling(rows, cols);
  const int wq_stride = 4 * cols + 4;
  const int kc = rows * (K + 4) <= stage_floats ? K : (stage_floats / rows - 4) / 8 * 8;

  float acc[kRowTile * kColTile];
#pragma unroll
  for (int i = 0; i < kRowTile * kColTile; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);
    const int quads = kn / 4;
    const int ld = kn + 4;
    // kParts copy groups; the FMAs on part p wait only for groups 0..p.
    int bound[kParts + 1];
#pragma unroll
    for (int i = 0; i <= kParts; ++i) bound[i] = quads * i / kParts;
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      stage_quads(row, n0, N, k0, bound[i], bound[i + 1], rows, ld, stage);
      cp_async_commit();
    }
    const float* wk = w + (k0 / 4) * wq_stride + tl.cgrp * 16;
    const float* sk = stage + tl.rg * kRowTile * ld;
    int q = tl.ks;
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      cp_async_wait_pending(kParts - 1 - i);
      __syncthreads();
      if (i == 0 && k0 == 0) MARK(slot, 4);  // the first copy group landed
      if (tl.active) q = tile_quads(acc, wk, sk, ld, wq_stride, q, bound[i + 1], tl.S);
    }
    __syncthreads();  // stage is refilled by the next chunk
    if (k0 == 0) MARK(slot, 5);  // the FMAs on the first chunk
  }
  store_sums(acc, tl, rows, cols, gates);
}

// Output (r, col) of the last product: the warp groups' shares, in order.
__device__ __forceinline__ float gate_sum(const float* gates, int rows, int cols, int r, int col) {
  const Split sp = split_of(rows, cols);
  float sum = gates[r * cols + col];
  for (int w = 1; w < sp.s_warp; ++w) sum += gates[(w * rows + r) * cols + col];
  return sum;
}

// The block's gate columns of Wh: w[k, g * U + u] = wh[k, g * H + j0 + u]
// (zeros past H).
__device__ void load_columns(const float* wh, int H, int j0, int U, float* w) {
  const int C = 4 * U;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int k = idx / C;
    const int col = idx - k * C;
    const int g = col / U;
    const int j = j0 + col - g * U;
    w[w_index(k, col, C)] = j < H ? wh[static_cast<size_t>(k) * 4 * H + g * H + j] : 0.0f;
  }
}

// What a thread's cell updates in chunk r0 of step t read besides the
// product, loaded ahead of it (for the next step's first chunk, before
// the grid barrier, since none of it comes from another block).
struct FwdIn {
  float x[kMaxOut][4];   // xg
  float c[kMaxOut];      // carried c_{t-1} (masked)
  float kp[kMaxOut];     // keep_{t-1}, which scales h_{t-1} @ Wh
  float k[kMaxOut];      // keep_t
};

__device__ __forceinline__ void fwd_fetch(FwdIn& in, const float* xg, const float* keep,
                                          const float* c0, const float* c_all, int t, int r0,
                                          int B, int H, int U, int rows, int j0) {
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / U;
    const int b = r0 + r;
    const int j = j0 + idx - r * U;
    if (idx >= rows * U || b >= B || j >= H) continue;
    const size_t row = static_cast<size_t>(t) * B + b;
    const float* x = xg + row * 4 * H + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) in.x[i][g] = x[g * H];
    in.kp[i] = t == 0 ? 1.0f : keep[row - B];
    // The thread wrote c_all[t - 1] for this (b, j) itself.
    in.c[i] = t == 0 ? c0[static_cast<size_t>(b) * H + j]
                     : __ldcg(c_all + (row - B) * H + j) * in.kp[i];
    in.k[i] = keep[row];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const float* xg, const float* wh, const float* keep, const float* h0,
                const float* c0, float* h_all, float* c_all, float* hT, float* cT, int T,
                int B, int H, Plan p) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  float* gates = w + p.w_floats;
  float* stage = gates + p.red_floats;
  const int U = p.units, C = 4 * U, rows = p.rows;
  const int j0 = blockIdx.x * U;
  load_columns(wh, H, j0, U, w);  // product() syncs before it reads w
  cg::grid_group grid = cg::this_grid();
  FwdIn in;
  fwd_fetch(in, xg, keep, c0, c_all, 0, 0, B, H, U, rows, j0);
  for (int t = 0; t < T; ++t) {
    MARK(t, 0);
    const float* h_prev = t == 0 ? h0 : h_all + static_cast<size_t>(t - 1) * B * H;
    for (int r0 = 0; r0 < B; r0 += rows) {
      if (r0 > 0) fwd_fetch(in, xg, keep, c0, c_all, t, r0, B, H, U, rows, j0);
      const int slot = r0 == 0 ? t : -1;
      product([=](int b) { return h_prev + static_cast<size_t>(b) * H; }, r0, B, H, w, C, rows,
              stage, p.stage_floats, gates, slot);
      MARK(slot, 1);  // the sums shared
#pragma unroll
      for (int i = 0; i < kMaxOut; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / U;
        const int u = idx - r * U;
        const int b = r0 + r;
        const int j = j0 + u;
        if (idx >= rows * U || b >= B || j >= H) continue;
        const float gi = in.x[i][0] + in.kp[i] * gate_sum(gates, rows, C, r, u);
        const float gf = in.x[i][1] + in.kp[i] * gate_sum(gates, rows, C, r, U + u);
        const float gg = in.x[i][2] + in.kp[i] * gate_sum(gates, rows, C, r, 2 * U + u);
        const float go = in.x[i][3] + in.kp[i] * gate_sum(gates, rows, C, r, 3 * U + u);
        const float c_new = sigmoid(gf + 1.0f) * in.c[i] + sigmoid(gi) * tanhf(gg);
        const float h_new = sigmoid(go) * tanhf(c_new);
        const size_t at = (static_cast<size_t>(t) * B + b) * H + j;
        h_all[at] = h_new;
        c_all[at] = c_new;
        if (t == T - 1) {
          hT[static_cast<size_t>(b) * H + j] = h_new * in.k[i];
          cT[static_cast<size_t>(b) * H + j] = c_new * in.k[i];
        }
      }
    }
    if (t + 1 < T) {
      fwd_fetch(in, xg, keep, c0, c_all, t + 1, 0, B, H, U, rows, j0);
      MARK(t, 2);
      grid.sync();  // h_all[t] complete on every block
      MARK(t, 3);
    }
  }
}

// What a thread's cell gradients in chunk r0 of step t read besides
// dh_carry, loaded ahead (as FwdIn).
struct BwdIn {
  float z[kMaxOut][4];  // the parked gates (pre-activation)
  float c_in[kMaxOut];  // carried c_{t-1} (masked)
  float c[kMaxOut];     // c_t
  float dh[kMaxOut];    // dh_all[t]
  float dc[kMaxOut];    // carried dc (from step t + 1, or dcT)
  float dhT[kMaxOut];   // dhT, at t = T - 1
  float k[kMaxOut];     // keep_t
};

__device__ __forceinline__ void bwd_fetch(BwdIn& in, const float* keep, const float* c0,
                                          const float* c_all, const float* dh_all,
                                          const float* dxg, const float* dh_carry,
                                          const float* dc_carry, int t, int T, int r0, int B,
                                          int H, int U, int rows, int j0) {
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / U;
    const int b = r0 + r;
    const int j = j0 + idx - r * U;
    if (idx >= rows * U || b >= B || j >= H) continue;
    const size_t row = static_cast<size_t>(t) * B + b;
    const size_t bj = static_cast<size_t>(b) * H + j;
    const float* d = dxg + row * 4 * H + j;  // written by this block's phase 1
#pragma unroll
    for (int g = 0; g < 4; ++g) in.z[i][g] = __ldcg(d + g * H);
    in.c_in[i] = t == 0 ? c0[bj] : c_all[(row - B) * H + j] * keep[row - B];
    in.c[i] = c_all[row * H + j];
    in.dh[i] = dh_all[row * H + j];
    in.dc[i] = __ldcg(dc_carry + bj);  // written by this thread at step t + 1
    in.dhT[i] = t == T - 1 ? dh_carry[bj] : 0.0f;
    in.k[i] = keep[row];
  }
}

// The partial sums of dh = dgates @ Wh^T over the block's own gate
// columns, for every unit and the chunk's rows: part[o, g, b, u] (unit
// j = o * U + u, block g = this block, batch row b < Bp) for all owners
// o. dg[r * (C + 4) + col] holds the chunk's dgates of the block's
// columns; w holds Wh's columns [H, C] (`w_index`). A thread owns 8 rows
// x one quad of units and sums over the C columns in order; neighbouring
// lanes take neighbouring quads (of w: other banks). The sums go to
// `buf` in part's layout, one padded segment of rows x U per owner, and
// from there to `part` in whole lines; as many owners a pass as fit.
__device__ void partial_dh(const float* dg, const float* w, int r0, int Bp, int H, int U,
                           int C, int rows, int blocks, float* part, float* buf,
                           int buf_floats) {
  const int ldd = C + 4;
  const int wq_stride = 4 * C + 4;
  const int seg = rows * U + 4;  // +4: neighbouring owners' segments in other banks
  const int per_pass = min(blocks, buf_floats / seg) / 4 * 4;  // whole quads of units
  for (int o0 = 0; o0 < blocks; o0 += per_pass) {
    const int o1 = min(blocks, o0 + per_pass);
    const int q0 = o0 * U / 4, q1 = min(H, o1 * U) / 4;
    for (int tile = threadIdx.x; tile < (rows / kRowTile) * (q1 - q0); tile += kThreads) {
      const int jq = q0 + tile % (q1 - q0);
      const int rg = tile / (q1 - q0);
      float acc[kRowTile][4];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
      for (int cq = 0; cq < C / 4; ++cq) {
        float4 wv[4];  // wv[i]: unit 4 jq + i, columns 4 cq .. 4 cq + 3
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = *reinterpret_cast<const float4*>(w + jq * wq_stride + cq * 16 + 4 * i);
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const float4 a =
              *reinterpret_cast<const float4*>(dg + (rg * kRowTile + r) * ldd + 4 * cq);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[r][i] = fmaf(a.x, wv[i].x, acc[r][i]);
            acc[r][i] = fmaf(a.y, wv[i].y, acc[r][i]);
            acc[r][i] = fmaf(a.z, wv[i].z, acc[r][i]);
            acc[r][i] = fmaf(a.w, wv[i].w, acc[r][i]);
          }
        }
      }
      if (U % 4 == 0) {  // the quad is one owner's: 16-byte stores (other banks by seg)
        const int o = 4 * jq / U;
        float* dst = buf + (o - o0) * seg + 4 * jq - o * U;
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          *reinterpret_cast<float4*>(dst + (rg * kRowTile + r) * U) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * jq + i;
          const int o = j / U;
          float* dst = buf + (o - o0) * seg + j - o * U;
#pragma unroll
          for (int r = 0; r < kRowTile; ++r) dst[(rg * kRowTile + r) * U] = acc[r][i];
        }
      }
    }
    __syncthreads();
    const int vecs = rows * U / 4;
    for (int idx = threadIdx.x; idx < (o1 - o0) * vecs; idx += kThreads) {
      const int o = idx / vecs;
      const int v = idx - o * vecs;
      const float4 x = *reinterpret_cast<const float4*>(buf + o * seg + 4 * v);
      *reinterpret_cast<float4*>(
          part + ((static_cast<size_t>(o0 + o) * blocks + blockIdx.x) * Bp + r0) * U + 4 * v) = x;
    }
    __syncthreads();  // buf is refilled by the next pass
  }
}

// dhc[i] <- sum over the blocks g of part[o, g, b, u] for the thread's
// outputs (r, u) of chunk r0 (o = this block), in a fixed order: the
// partial sums are staged through shared memory with cp.async, as many
// blocks' at a time as fit; where rows * U <= 128 two threads share an
// output, each summing every other staged block, and `red` (>= rows *
// U floats) joins the two halves.
__device__ void sum_partials(const float* part, int r0, int Bp, int U, int rows, int blocks,
                             float* stage, int stage_floats, float* red, float* dhc) {
  const int seg = rows * U;  // floats of one block's partials for the chunk
  const int per_round = min(blocks, stage_floats / seg);
  const bool halves = seg <= kThreads / 2;
  const int out = halves ? threadIdx.x % (kThreads / 2) : threadIdx.x;
  const int half = halves ? threadIdx.x / (kThreads / 2) : 0;
  const int step = halves ? 2 : 1;
  const float* mine = part + static_cast<size_t>(blockIdx.x) * blocks * Bp * U;
  float sum[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) sum[i] = 0.0f;
  for (int g0 = 0; g0 < blocks; g0 += per_round) {
    const int gn = min(per_round, blocks - g0);
    const int vecs = seg / 4;
    for (int idx = threadIdx.x; idx < gn * vecs; idx += kThreads) {
      const int g = idx / vecs;
      const int v = idx - g * vecs;
      cp_async16(stage + g * seg + 4 * v,
                 mine + (static_cast<size_t>(g0 + g) * Bp + r0) * U + 4 * v, true);
    }
    cp_async_commit();
    cp_async_wait_pending(0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int idx = out + i * kThreads;
      if (idx >= seg) continue;
      float acc = sum[i];
#pragma unroll 8
      for (int g = half; g < gn; g += step) acc += stage[g * seg + idx];
      sum[i] = acc;
    }
    __syncthreads();  // stage is refilled by the next round
  }
  if (halves) {
    if (half == 1 && out < seg) red[out] = sum[0];
    __syncthreads();
    if (half == 0 && out < seg) sum[0] += red[out];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) dhc[i] = sum[i];
}

// dxg holds no input: phase 1 parks the pre-activation gates there.
// dh_carry and dc_carry hold dhT and dcT on entry and dh0 and dc0 on
// return. part is scratch for two steps' partial sums of dh, [2, blocks,
// blocks, Bp, U] with Bp = B rounded up to a multiple of rows.
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const float* xg, const float* wh, const float* keep, const float* h0,
                const float* c0, const float* h_all, const float* c_all, const float* dh_all,
                float* dxg, float* dh_carry, float* dc_carry, float* part, int T, int B, int H,
                Plan p) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  float* gates = w + p.w_floats;  // phase 1's gate sums; then the chunk's dgates
  float* stage = gates + p.red_floats;
  const int U = p.units, C = 4 * U, rows = p.rows;
  const int j0 = blockIdx.x * U;
  const int G = 4 * H;
  const int blocks = gridDim.x;
  const int Bp = (B + rows - 1) / rows * rows;
  const size_t part_floats = static_cast<size_t>(blocks) * blocks * Bp * U;

  // Phase 1: gates = xg + (h_{t-1} * keep_{t-1}) @ Wh for the block's
  // columns, over the T * B rows n = t * B + b in chunks of rows_all:
  // row n of the left operand is h0[n] for n < B, else h_all[n - B]. Two
  // staging buffers: the next chunk's rows stream in while this chunk's
  // are multiplied.
  MARK(63, 0);
  load_columns(wh, H, j0, U, w);
  const int N = T * B;
  const int ld = H + 4;
  const int quads = H / 4;
  const Tiling tl = tiling(p.rows_all, C);
  auto h_row = [=](int n) { return n < B ? h0 + static_cast<size_t>(n) * H
                                         : h_all + static_cast<size_t>(n - B) * H; };
  stage_quads(h_row, 0, N, 0, 0, quads, p.rows_all, ld, stage);
  cp_async_commit();
  for (int n0 = 0, c = 0; n0 < N; n0 += p.rows_all, ++c) {
    const int slot = 40 + min(c, 19);  // recompute chunk c's marks
    MARK(slot, 0);
    // The epilogue's first kMaxOut outputs a thread: xg and keep loaded ahead.
    float xv[kMaxOut], kv[kMaxOut];
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / C;
      const int col = idx - r * C;
      const int g = col / U;
      const int n = n0 + r;
      const int j = j0 + col - g * U;
      const bool valid = idx < p.rows_all * C && n < N && j < H;
      xv[i] = valid ? xg[static_cast<size_t>(n) * G + g * H + j] : 0.0f;
      kv[i] = valid && n >= B ? keep[n - B] : 1.0f;
    }
    const float* cur = stage + (c & 1) * p.rows_all * ld;
    if (n0 + p.rows_all < N) {
      stage_quads(h_row, n0 + p.rows_all, N, 0, 0, quads, p.rows_all, ld,
                  stage + ((c + 1) & 1) * p.rows_all * ld);
      cp_async_commit();
      cp_async_wait_pending(1);
    } else {
      cp_async_wait_pending(0);
    }
    __syncthreads();
    MARK(slot, 4);  // the chunk's rows landed
    float acc[kRowTile * kColTile];
#pragma unroll
    for (int i = 0; i < kRowTile * kColTile; ++i) acc[i] = 0.0f;
    if (tl.active) {
      tile_quads(acc, w + tl.cgrp * 16, cur + tl.rg * kRowTile * ld, ld, 4 * C + 4, tl.ks, quads,
                 tl.S);
    }
    MARK(slot, 5);  // the FMAs
    store_sums(acc, tl, p.rows_all, C, gates);  // its barrier frees `cur`
    MARK(slot, 1);  // the sums shared
    for (int idx = threadIdx.x, i = 0; idx < p.rows_all * C; idx += kThreads, ++i) {
      const int r = idx / C;
      const int col = idx - r * C;
      const int g = col / U;
      const int n = n0 + r;
      const int j = j0 + col - g * U;
      if (n >= N || j >= H) continue;
      const size_t at = static_cast<size_t>(n) * G + g * H + j;
      float x = 0.0f, kp = 1.0f;
#pragma unroll
      for (int k = 0; k < kMaxOut; ++k) {
        x = i == k ? xv[k] : x;
        kp = i == k ? kv[k] : kp;
      }
      if (i >= kMaxOut) {
        x = xg[at];
        kp = n < B ? 1.0f : keep[n - B];
      }
      dxg[at] = x + kp * gate_sum(gates, p.rows_all, C, r, col);
    }
    MARK(slot, 2);  // the gates parked
  }
  __syncthreads();  // the parked gates, for the other threads' bwd_fetch
  MARK(63, 2);

  // Phase 2, step t: dh_carry for the block's units is the sum of every
  // block's partials from step t + 1; the cell gradients give dgates_t
  // for the block's columns (into dxg, in place of the parked gates);
  // their partial products with the block's columns of Wh go to the
  // other half of `part`; one grid barrier.
  cg::grid_group grid = cg::this_grid();
  float* dg = gates;
  BwdIn in;
  float dhc[kMaxOut];
  bwd_fetch(in, keep, c0, c_all, dh_all, dxg, dh_carry, dc_carry, T - 1, T, 0, B, H, U, rows, j0);
  for (int t = T - 1; t >= 0; --t) {
    MARK(t, 0);
    for (int r0 = 0; r0 < B; r0 += rows) {
      const int slot = r0 == 0 ? t : -1;
      if (r0 > 0) bwd_fetch(in, keep, c0, c_all, dh_all, dxg, dh_carry, dc_carry, t, T, r0, B, H,
                            U, rows, j0);
      if (t + 1 < T) {
        sum_partials(part + ((t + 1) & 1) * part_floats, r0, Bp, U, rows, blocks, stage,
                     p.stage_floats, dg, dhc);
      }
      MARK(slot, 4);  // the partials summed
#pragma unroll
      for (int i = 0; i < kMaxOut; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / U;
        const int u = idx - r * U;
        const int b = r0 + r;
        const int j = j0 + u;
        if (idx >= rows * U) continue;
        if (b >= B || j >= H) {
          // partial_dh sums every row and column of dg (units past H
          // against zero columns of w): no stale value may stand there.
#pragma unroll
          for (int g = 0; g < 4; ++g) dg[r * (C + 4) + g * U + u] = 0.0f;
          continue;
        }
        const float si = sigmoid(in.z[i][0]);
        const float sf = sigmoid(in.z[i][1] + 1.0f);
        const float sg = tanhf(in.z[i][2]);
        const float so = sigmoid(in.z[i][3]);
        const float tc = tanhf(in.c[i]);
        const float dh = in.dh[i] + in.k[i] * (t + 1 < T ? dhc[i] : in.dhT[i]);
        const float dc = in.k[i] * in.dc[i] + dh * so * (1.0f - tc * tc);
        const float d4[4] = {dc * sg * si * (1.0f - si), dc * in.c_in[i] * sf * (1.0f - sf),
                             dc * si * (1.0f - sg * sg), dh * tc * so * (1.0f - so)};
        float* d = dxg + (static_cast<size_t>(t) * B + b) * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          d[g * H] = d4[g];
          dg[r * (C + 4) + g * U + u] = d4[g];
        }
        dc_carry[static_cast<size_t>(b) * H + j] = dc * sf;
      }
      __syncthreads();
      MARK(slot, 5);  // the cell gradients
      partial_dh(dg, w, r0, Bp, H, U, C, rows, blocks, part + (t & 1) * part_floats, stage,
                 p.stage_floats);
      __syncthreads();  // dg is rewritten by the next chunk
      MARK(slot, 1);  // the block's own partials out
    }
    if (t > 0) bwd_fetch(in, keep, c0, c_all, dh_all, dxg, dh_carry, dc_carry, t - 1, T, 0, B, H,
                         U, rows, j0);
    MARK(t, 2);
    grid.sync();  // step t's partial sums complete on every block
    MARK(t, 3);
  }
  // dh0: the sum of the partials of dgates_0.
  for (int r0 = 0; r0 < B; r0 += rows) {
    sum_partials(part, r0, Bp, U, rows, blocks, stage, p.stage_floats, dg, dhc);
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / U;
      const int b = r0 + r;
      const int j = j0 + idx - r * U;
      if (idx < rows * U && b < B && j < H) dh_carry[static_cast<size_t>(b) * H + j] = dhc[i];
    }
  }
}

int select_device(int device) {
  // This library links its own CUDA runtime, whose current device is
  // not PyTorch's: select the tensors' device (only when it differs, so
  // a launch inside CUDA-graph capture makes no device switch).
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

// One cooperative launch of `kernel` on `blocks` blocks with `smem`
// bytes of shared memory each. Refuses (cudaErrorCooperativeLaunchTooLarge)
// a grid that cannot be resident all at once, so the grid barrier never
// waits on a block that cannot start.
// `allowed` is the kernel's dynamic shared-memory limit as last set: it
// is raised only when a launch needs more (a host-side attribute, set
// outside any graph capture by the first, eager, call at that size).
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), size_t* allowed, int blocks, size_t smem, int device,
           void* stream, Args... args) {
  int err = 0;
  if (smem > *allowed) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err == 0) *allowed = smem;
  }
  int sms = 0, per_sm = 0;
  if (err == 0) err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err == 0) err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem));
  if (err != 0) return err;
  if (blocks > sms * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, args...));
}

size_t fwd_allowed = 48 * 1024, bwd_allowed = 48 * 1024;

// Whether the caller's plan gives every shared-memory region at least
// what the kernels index at hidden size H, with the regions 16-byte
// aligned and every loop of the kernels making progress.
bool plan_fits(const Plan& p, int H, bool backward) {
  const int U = p.units, C = 4 * U;
  if (U < 1 || H % 4 != 0 || p.rows < kRowTile || p.rows % kRowTile != 0 ||
      p.rows * U > kMaxOut * kThreads || p.w_floats < H * C + H || p.w_floats % 4 != 0 ||
      p.red_floats % 4 != 0) {
    return false;
  }
  if (!backward) {  // product() over rows x C, K in chunks of at least 8
    const Split sp = split_of(p.rows, C);
    return sp.s_warp >= 1 && p.red_floats >= sp.s_warp * p.rows * C &&
           (p.stage_floats >= p.rows * (H + 4) || (p.stage_floats / p.rows - 4) / 8 * 8 >= 8);
  }
  // Phase 1 over rows_all x C in two staging buffers; phase 2's dgates
  // chunk in the gate region, and partial_dh's passes of whole quads of
  // owners through the stage.
  const Split sp = split_of(p.rows_all, C);
  const int blocks = (H + U - 1) / U;
  return p.rows_all >= kRowTile && p.rows_all % kRowTile == 0 && sp.s_warp >= 1 &&
         p.red_floats >= sp.s_warp * p.rows_all * C && p.red_floats >= p.rows * (C + 4) &&
         p.stage_floats >= 2 * p.rows_all * (H + 4) &&
         std::min(blocks, p.stage_floats / (p.rows * U + 4)) >= 4;
}

size_t plan_bytes(const Plan& p) {
  return sizeof(float) * (static_cast<size_t>(p.w_floats) + p.red_floats + p.stage_floats);
}

}  // namespace

// The launch plan (units per block, rows per chunk, and the floats of
// the three shared-memory regions) comes from the caller,
// `ops/kernels/lstm.py:lstm_plan`; a grid of ceil(H / units) blocks.

extern "C" int drl_lstm_sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return -1;
  }
  return sms;
}

extern "C" int drl_lstm_fwd(const float* xg, const float* wh, const float* keep,
                            const float* h0, const float* c0, float* h_all,
                            float* c_all, float* hT, float* cT, int T, int B,
                            int H, int units, int rows, int rows_all, int w_floats,
                            int red_floats, int stage_floats, int device, void* stream) {
  int err = select_device(device);
  if (err != 0) return err;
  const Plan p{units, rows, rows_all, w_floats, red_floats, stage_floats};
  if (!plan_fits(p, H, false)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(lstm_fwd_kernel, &fwd_allowed, (H + units - 1) / units, plan_bytes(p), device,
                stream, xg, wh, keep, h0, c0, h_all, c_all, hT, cT, T, B, H, p);
}

// dh_carry and dc_carry hold dhT and dcT on entry and dh0 and dc0 on
// return; part is the plan's scratch for the blocks' partial sums of dh.
extern "C" int drl_lstm_bwd(const float* xg, const float* wh, const float* keep,
                            const float* h0, const float* c0, const float* h_all,
                            const float* c_all, const float* dh_all, float* dxg,
                            float* dh_carry, float* dc_carry, float* part, int T, int B,
                            int H, int units, int rows, int rows_all, int w_floats,
                            int red_floats, int stage_floats, int device, void* stream) {
  int err = select_device(device);
  if (err != 0) return err;
  const Plan p{units, rows, rows_all, w_floats, red_floats, stage_floats};
  if (!plan_fits(p, H, true)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(lstm_bwd_kernel, &bwd_allowed, (H + units - 1) / units, plan_bytes(p), device,
                stream, xg, wh, keep, h0, c0, h_all, c_all, dh_all, dxg, dh_carry, dc_carry,
                part, T, B, H, p);
}

#ifdef DRL_LSTM_PHASES
// Where the kernels write their phase marks (null: nowhere).
extern "C" int drl_lstm_set_marks(unsigned long long* marks) {
  return static_cast<int>(cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks)));
}
#endif

extern "C" const char* drl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
