// Causal, segment-masked flash attention in float32: the forward (K3a),
// dq (K3b) and dk/dv (K3c).
//
// Replaces the TPU kernels in
// distributed_reinforcement_learning_tpu/ops/pallas/attention.py:
// `_fwd_kernel` (called by `_fwd_call`), `_dq_kernel` and `_dkv_kernel`
// (both called by `_bwd_call`). Layout [BH, T, D] row-major (batch x
// heads leading), segment ids [BH, T] int32; D in {32, 64, 128}. Query
// row i attends key j iff j <= i and qs[i] == ks[j]; a masked logit is
// the finite -0.5 * FLT_MAX, as in the JAX package, so no inf - inf
// appears in the rescale.
//
//   forward:  s = q k^T * D^-0.5, online softmax over the kv tiles,
//             o = acc / max(l, FLT_MIN),  lse = m + log(max(l, FLT_MIN))
//   dq:       p = exp(s - lse), ds = p * (dO v^T - delta) * D^-0.5,
//             dq = ds k                    (delta = rowsum(dO * o), outside)
//   dk, dv:   dv = p^T dO,  dk = ds^T q
//
// What bounds it on an H100: at the transformer sections' shapes
// (BH = 32, T = 16, D = 32) a call does ~0.5 MFLOP and moves ~0.2 MB:
// under 0.1 us either way, so the launch is the cost. At long T the
// work is the causal product, 4*D flops per attended (query, key) pair
// forward and 14*D backward, on the CUDA cores in float32 (67 TFLOP/s),
// against 3.35 TB/s for reading each input once.
//
// Design. The TPU kernels walk a sequential grid and carry the online
// softmax (or the gradient sums) in VMEM scratch from one grid step to
// the next. Here blocks run in parallel and in no order, so each block
// owns one output tile and loops over the other axis itself:
//
// - K3a and K3b: one block per (bh, 32-row q tile). It loops over the
//   32-key kv tiles up to the diagonal, staging K and V in shared
//   memory; its q (and dO) tile stays in shared memory throughout. The
//   running m, l and accumulator (or dq) of each row live in registers.
// - K3c: one block per (bh, 32-key kv tile). K and V stay in shared
//   memory; it loops over the q tiles from the diagonal to T, staging Q
//   and dO, and keeps dk and dv of its keys in registers.
//
// Each output has exactly one writer, so there are no atomics and the
// results do not change from run to run. 128 threads (4 warps) a block.
// Inside a warp the lanes take two roles in turn: lane = key (or query
// row, in K3c) for the dot products, which read their own row of a
// padded tile (row stride D + 4 floats keeps 16-byte loads free of bank
// conflicts) against a row every lane reads alike (a broadcast); and lane
// = head dimension for the accumulations, which pass each key's p or ds
// by warp shuffle. Rows (keys in K3c) are dealt to the warps round robin,
// so the diagonal tile's uneven work spreads over all four.
//
// Two kinds of tile are skipped, both exactly (a fully masked tile adds
// p = 0 and leaves m unchanged, alpha = exp(0) = 1): tiles past the
// diagonal, as the TPU kernels' clamped index maps skip them, and tiles
// whose segment-id ranges [min, max] do not overlap the block's own (no
// equal pair can exist). Episode ids from cumsum(done) increase along T,
// so at long T only the tiles near the diagonal that share an episode
// are computed. The test runs 32 tiles at a time, one tile per lane
// (`live_tiles`: independent 16-byte loads, then one ballot), so a block
// far down a long sequence pays one round trip to L2 per 32 tiles, not
// one per tile. Grids run the heaviest (last) q tiles first.
//
// Precision: float32 on the CUDA cores, no TF32, no fast math (expf,
// logf at full precision). Sums run in another order than the plain
// PyTorch version's matrix products, so the two agree to rounding.
//
// Bound through ctypes: plain C interface, device pointers and the
// caller's stream, cudaError_t returned to the caller.

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                      // q rows and kv keys per tile
constexpr int kPerWarp = kTile / kWarps;       // rows (or keys) each warp owns
constexpr float kMask = -0.5f * FLT_MAX;       // ops/attention.py:_MASK_VALUE
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// [lo, hi] of the segment ids of rows [r0, r0 + 32) below T. Every warp
// computes it alike, so a branch on it is uniform across the block.
__device__ __forceinline__ void seg_range(const int* seg, int r0, int T, int& lo, int& hi) {
  const int r = r0 + static_cast<int>(threadIdx.x % 32);
  int a = r < T ? seg[r] : INT_MAX;
  int b = r < T ? seg[r] : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = min(a, __shfl_xor_sync(kAll, a, o));
    b = max(b, __shfl_xor_sync(kAll, b, o));
  }
  lo = a;
  hi = b;
}

// Bit i set: the segment-id range [min, max] of tile c0 + i (of 32 rows;
// only tiles first..last count) meets [lo, hi]. Lane i reads its tile's ids, 4 at a time (T
// is a multiple of 8, so a group of 4 is wholly in or out of range).
// Every warp computes the same mask, so a loop over it is uniform across
// the block.
__device__ __forceinline__ unsigned live_tiles(const int* seg, int c0, int first, int last,
                                               int T, int lo, int hi) {
  const int j = c0 + static_cast<int>(threadIdx.x % 32);
  bool live = false;
  if (j >= first && j <= last) {
    int a = INT_MAX, b = INT_MIN;
#pragma unroll
    for (int i = 0; i < kTile; i += 4) {
      const int r = j * kTile + i;
      if (r < T) {
        const int4 x = *reinterpret_cast<const int4*>(seg + r);
        a = min(a, min(min(x.x, x.y), min(x.z, x.w)));
        b = max(b, max(max(x.x, x.y), max(x.z, x.w)));
      }
    }
    live = b >= lo && a <= hi;
  }
  return __ballot_sync(kAll, live);
}

// Copy rows [r0, r0 + 32) of a [T, D] matrix into shared memory with row
// stride LD, zero-filling rows at or past T.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int T) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// K3a. Shared memory: q [32][D], k and v [32][D + 4].
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qs,
                 const int* __restrict__ ks, float* __restrict__ o,
                 float* __restrict__ lse, int T, int n_tiles, float scale) {
  constexpr int LD = D + 4;
  constexpr int kDims = D / 32;  // head dimensions each lane owns
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTile * D;
  float* sv = sk + kTile * LD;

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles)) * kTile;
  const size_t base = static_cast<size_t>(bh) * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D, D>(sq, q + base * D, q0, T);
  int q_lo, q_hi;
  seg_range(qs + base, q0, T, q_lo, q_hi);

  float m[kPerWarp], l[kPerWarp], acc[kPerWarp][kDims];
  int qseg[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int row = q0 + r * kWarps + warp;
    m[r] = kMask;
    l[r] = 0.f;
    qseg[r] = row < T ? qs[base + row] : 0;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;
  }

  const int n_kv = (min(q0 + kTile, T) - 1) / kTile + 1;
  unsigned live = 0;  // bit j % 32: kv tile j can hold a same-segment pair
  for (int j = 0; j < n_kv; ++j) {
    if (j % 32 == 0) live = live_tiles(ks + base, j, 0, n_kv - 1, T, q_lo, q_hi);
    if (!((live >> (j % 32)) & 1u)) continue;
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, LD>(sk, k + base * D, k0, T);
    load_tile<D, LD>(sv, v + base * D, k0, T);
    __syncthreads();
    const int key = k0 + lane;
    const int kseg = key < T ? ks[base + key] : 0;
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int row = q0 + r * kWarps + warp;
      if (row >= T || k0 > row) continue;  // warp-uniform: every key of the tile is in the future
      float s = dot<D>(sq + (r * kWarps + warp) * D, sk + lane * LD) * scale;
      const bool valid = key <= row && kseg == qseg[r];
      s = valid ? s : kMask;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * alpha + warp_sum(p);
      float pv[kDims];
#pragma unroll
      for (int c = 0; c < kDims; ++c) pv[c] = 0.f;
      const int n_keys = min(kTile, row - k0 + 1);
      for (int jj = 0; jj < n_keys; ++jj) {
        const float pj = __shfl_sync(kAll, p, jj);
#pragma unroll
        for (int c = 0; c < kDims; ++c) pv[c] = fmaf(pj, sv[jj * LD + lane + 32 * c], pv[c]);
      }
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[r][c] = acc[r][c] * alpha + pv[c];
    }
  }

#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int row = q0 + r * kWarps + warp;
    if (row >= T) continue;
    const float l_safe = fmaxf(l[r], FLT_MIN);
#pragma unroll
    for (int c = 0; c < kDims; ++c) o[(base + row) * D + lane + 32 * c] = acc[r][c] / l_safe;
    if (lane == 0) lse[base + row] = m[r] + logf(l_safe);
  }
}

// K3b. Shared memory: q and dO [32][D], k and v [32][D + 4].
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ qs,
                const int* __restrict__ ks, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int T, int n_tiles, float scale) {
  constexpr int LD = D + 4;
  constexpr int kDims = D / 32;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + kTile * D;
  float* sk = sdo + kTile * D;
  float* sv = sk + kTile * LD;

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles)) * kTile;
  const size_t base = static_cast<size_t>(bh) * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D, D>(sq, q + base * D, q0, T);
  load_tile<D, D>(sdo, dout + base * D, q0, T);
  int q_lo, q_hi;
  seg_range(qs + base, q0, T, q_lo, q_hi);

  float row_lse[kPerWarp], row_delta[kPerWarp], acc[kPerWarp][kDims];
  int qseg[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int row = q0 + r * kWarps + warp;
    row_lse[r] = row < T ? lse[base + row] : 0.f;
    row_delta[r] = row < T ? delta[base + row] : 0.f;
    qseg[r] = row < T ? qs[base + row] : 0;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;
  }

  const int n_kv = (min(q0 + kTile, T) - 1) / kTile + 1;
  unsigned live = 0;
  for (int j = 0; j < n_kv; ++j) {
    if (j % 32 == 0) live = live_tiles(ks + base, j, 0, n_kv - 1, T, q_lo, q_hi);
    if (!((live >> (j % 32)) & 1u)) continue;
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<D, LD>(sk, k + base * D, k0, T);
    load_tile<D, LD>(sv, v + base * D, k0, T);
    __syncthreads();
    const int key = k0 + lane;
    const int kseg = key < T ? ks[base + key] : 0;
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int row = q0 + r * kWarps + warp;
      if (row >= T || k0 > row) continue;
      const int local = r * kWarps + warp;
      const float s = dot<D>(sq + local * D, sk + lane * LD) * scale;
      const bool valid = key <= row && kseg == qseg[r];
      const float p = valid ? expf(s - row_lse[r]) : 0.f;
      const float dp = dot<D>(sdo + local * D, sv + lane * LD);
      const float ds = p * (dp - row_delta[r]) * scale;
      const int n_keys = min(kTile, row - k0 + 1);
      for (int jj = 0; jj < n_keys; ++jj) {
        const float dsj = __shfl_sync(kAll, ds, jj);
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[r][c] = fmaf(dsj, sk[jj * LD + lane + 32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int row = q0 + r * kWarps + warp;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) dq[(base + row) * D + lane + 32 * c] = acc[r][c];
  }
}

// K3c. Shared memory: q and dO [32][D + 4], k and v [32][D].
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qs,
                 const int* __restrict__ ks, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int T, int n_tiles,
                 float scale) {
  constexpr int LD = D + 4;
  constexpr int kDims = D / 32;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + kTile * LD;
  float* sk = sdo + kTile * LD;
  float* sv = sk + kTile * D;

  const int bh = blockIdx.x / n_tiles;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const int k0 = tile * kTile;
  const size_t base = static_cast<size_t>(bh) * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D, D>(sk, k + base * D, k0, T);
  load_tile<D, D>(sv, v + base * D, k0, T);
  int k_lo, k_hi;
  seg_range(ks + base, k0, T, k_lo, k_hi);

  float acc_k[kPerWarp][kDims], acc_v[kPerWarp][kDims];
  int kseg[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int key = k0 + r * kWarps + warp;
    kseg[r] = key < T ? ks[base + key] : 0;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }

  // Causal: q tiles before this kv tile attend none of its keys.
  unsigned live = 0;  // bit i % 32: q tile i can hold a same-segment pair
  for (int i = tile; i < n_tiles; ++i) {
    if (i == tile || i % 32 == 0)
      live = live_tiles(qs + base, i - i % 32, tile, n_tiles - 1, T, k_lo, k_hi);
    if (!((live >> (i % 32)) & 1u)) continue;
    const int q0 = i * kTile;
    __syncthreads();
    load_tile<D, LD>(sq, q + base * D, q0, T);
    load_tile<D, LD>(sdo, dout + base * D, q0, T);
    __syncthreads();
    const int row = q0 + lane;
    const float row_lse = row < T ? lse[base + row] : 0.f;
    const float row_delta = row < T ? delta[base + row] : 0.f;
    const int qseg = row < T ? qs[base + row] : 0;
    const int n_rows = min(kTile, T - q0);
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int local = r * kWarps + warp;
      const int key = k0 + local;
      if (key >= T) continue;  // warp-uniform
      const float s = dot<D>(sq + lane * LD, sk + local * D) * scale;
      const bool valid = row < T && row >= key && qseg == kseg[r];
      const float p = valid ? expf(s - row_lse) : 0.f;
      const float dp = dot<D>(sdo + lane * LD, sv + local * D);
      const float ds = p * (dp - row_delta) * scale;
      for (int ii = max(0, key - q0); ii < n_rows; ++ii) {
        const float pi = __shfl_sync(kAll, p, ii);
        const float dsi = __shfl_sync(kAll, ds, ii);
#pragma unroll
        for (int c = 0; c < kDims; ++c) {
          acc_v[r][c] = fmaf(pi, sdo[ii * LD + lane + 32 * c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dsi, sq[ii * LD + lane + 32 * c], acc_k[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int key = k0 + r * kWarps + warp;
    if (key >= T) continue;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      dk[(base + key) * D + lane + 32 * c] = acc_k[r][c];
      dv[(base + key) * D + lane + 32 * c] = acc_v[r][c];
    }
  }
}

constexpr size_t fwd_smem(int D) { return sizeof(float) * kTile * (D + 2 * (D + 4)); }
constexpr size_t bwd_smem(int D) { return sizeof(float) * kTile * (2 * D + 2 * (D + 4)); }

// Raise a kernel's dynamic shared-memory limit above the 48 KB default
// once (a host-side attribute, set outside any graph capture by the
// first, eager, call at that D).
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (bytes <= 48 * 1024 || *done) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  if (err == 0) *done = true;
  return err;
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

int n_tiles(int T) { return (T + kTile - 1) / kTile; }

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const int* qs, const int* ks,
               float* o, float* lse, int BH, int T, float scale, cudaStream_t s) {
  static bool done = false;
  const int err = allow_smem(flash_fwd_kernel<D>, fwd_smem(D), &done);
  if (err != 0) return err;
  flash_fwd_kernel<D><<<BH * n_tiles(T), kThreads, fwd_smem(D), s>>>(
      q, k, v, qs, ks, o, lse, T, n_tiles(T), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const int* qs, const int* ks,
              const float* dout, const float* lse, const float* delta, float* dq, int BH,
              int T, float scale, cudaStream_t s) {
  static bool done = false;
  const int err = allow_smem(flash_dq_kernel<D>, bwd_smem(D), &done);
  if (err != 0) return err;
  flash_dq_kernel<D><<<BH * n_tiles(T), kThreads, bwd_smem(D), s>>>(
      q, k, v, qs, ks, dout, lse, delta, dq, T, n_tiles(T), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const int* qs, const int* ks,
               const float* dout, const float* lse, const float* delta, float* dk, float* dv,
               int BH, int T, float scale, cudaStream_t s) {
  static bool done = false;
  const int err = allow_smem(flash_dkv_kernel<D>, bwd_smem(D), &done);
  if (err != 0) return err;
  flash_dkv_kernel<D><<<BH * n_tiles(T), kThreads, bwd_smem(D), s>>>(
      q, k, v, qs, ks, dout, lse, delta, dk, dv, T, n_tiles(T), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns cudaErrorInvalidValue for a D outside
// {32, 64, 128} (the wrapper checks first).

extern "C" int drl_flash_fwd(const float* q, const float* k, const float* v, const int* qs,
                             const int* ks, float* o, float* lse, int BH, int T, int D,
                             float scale, int device, void* stream) {
  const int err = select_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_fwd<32>(q, k, v, qs, ks, o, lse, BH, T, scale, s);
    case 64: return launch_fwd<64>(q, k, v, qs, ks, o, lse, BH, T, scale, s);
    case 128: return launch_fwd<128>(q, k, v, qs, ks, o, lse, BH, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int drl_flash_dq(const float* q, const float* k, const float* v, const int* qs,
                            const int* ks, const float* dout, const float* lse,
                            const float* delta, float* dq, int BH, int T, int D, float scale,
                            int device, void* stream) {
  const int err = select_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dq<32>(q, k, v, qs, ks, dout, lse, delta, dq, BH, T, scale, s);
    case 64: return launch_dq<64>(q, k, v, qs, ks, dout, lse, delta, dq, BH, T, scale, s);
    case 128: return launch_dq<128>(q, k, v, qs, ks, dout, lse, delta, dq, BH, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int drl_flash_dkv(const float* q, const float* k, const float* v, const int* qs,
                             const int* ks, const float* dout, const float* lse,
                             const float* delta, float* dk, float* dv, int BH, int T, int D,
                             float scale, int device, void* stream) {
  const int err = select_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dkv<32>(q, k, v, qs, ks, dout, lse, delta, dk, dv, BH, T, scale, s);
    case 64: return launch_dkv<64>(q, k, v, qs, ks, dout, lse, delta, dk, dv, BH, T, scale, s);
    case 128: return launch_dkv<128>(q, k, v, qs, ks, dout, lse, delta, dk, dv, BH, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* drl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
