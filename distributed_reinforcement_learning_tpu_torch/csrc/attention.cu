// Causal, segment-masked flash attention in float32: the forward (K3a),
// dq (K3b) and dk/dv (K3c).
//
// Replaces the TPU kernels in
// distributed_reinforcement_learning_tpu/ops/pallas/attention.py:
// `_fwd_kernel` (called by `_fwd_call`), `_dq_kernel` and `_dkv_kernel`
// (both called by `_bwd_call`). Layout [BH, T, D] row-major (batch x
// heads leading), segment ids [BH, T] int32; D in {32, 64, 128}, T a
// multiple of 8. Query row i attends key j iff j <= i and qs[i] == ks[j];
// a masked logit is the finite -0.5 * FLT_MAX, as in the JAX package, so
// no inf - inf appears in the rescale.
//
//   forward:  s = q k^T * D^-0.5, online softmax over the kv tiles,
//             o = acc / max(l, FLT_MIN),  lse = m + log(max(l, FLT_MIN))
//   dq:       p = exp(s - lse), ds = p * (dO v^T - delta) * D^-0.5,
//             dq = ds k                    (delta = rowsum(dO * o), outside)
//   dk, dv:   dv = p^T dO,  dk = ds^T q
//
// What bounds it on an H100: at the transformer sections' shapes
// (BH = 32, T = 16, D = 32) a call does ~0.5 MFLOP and moves ~0.2 MB:
// under 0.1 us either way, so the launch and one chain of dependent
// memory round trips are the cost. At long T with episodes of ~12 steps
// the segment test skips all but one or two kv tiles per q tile, so
// reading each input once (3.35 TB/s) bounds it; causal attention
// without segments would be bound by the products (4*D flops per
// attended pair forward, 6*D for dq, 8*D for dk/dv).
//
// All three run on the tensor cores. Every product is `mma.sync` m16n8k8 in
// 3xTF32: each float32 operand x splits into hi = tf32(x) and
// lo = tf32(x - hi) (round to nearest, ties away), and the accumulator
// takes a_lo b_hi + a_hi b_lo, then a_hi b_hi, so the sum keeps about
// float32's precision where one TF32 product keeps ~3 digits (products
// over D keep the three terms in three accumulators and add them small
// terms first, which splits one chain of 3D/8 dependent products into
// three of D/8). `mma.sync`, not `wgmma`: wgmma takes 64 rows a warpgroup
// where the path's T is 16, and wants TF32 operands K-major, which V and
// dO are not.
//
// One block of 4 warps owns one (bh, 16-row tile): the q rows in K3a
// and K3b, the keys in K3c; blocks run the heaviest tiles first (the last
// q tiles in K3a and K3b, the first key tiles in K3c). It walks the other
// side's live 16-row tiles (K, V and their segment ids in K3a and K3b; Q,
// dO, their ids, lse and delta in K3c), staged by 16-byte cp.async into
// a double-buffered ring in shared memory that the 4 warps share: tile
// j + 1 lands while tile j is computed. The 4 warps split each tile's work, and meet at two
// barriers a tile (the tile has landed; the parts of S are out):
//
// - K3a: warp w computes S = Q K^T for keys 8 (w % 2).. over half of D
//   (Q's fragments for its half stay in registers), the four parts meet
//   in shared memory, and every warp sums them in the same order: the
//   same S, m, l and P in all four. The online softmax runs on the
//   accumulator fragments (a row lives in the 4 lanes of a quad: its max
//   is 2 shuffles; l stays per lane and is summed once at the end), then
//   warp w computes O += P V for its quarter of D, with P passed from the
//   accumulator layout to the A-fragment layout in registers.
// - K3b: warps 0, 1 compute S = Q K^T and warps 2, 3 dP = dO V^T, each
//   for 8 of the tile's keys over all of D (Q's or dO's fragments, split
//   into hi and lo once, stay in registers with each row's lse and
//   delta); after the exchange every warp forms P and dS in the same
//   order, and computes dQ += dS K for its quarter of D, with dS passed
//   from the accumulator layout to the A-fragment layout in registers.
// - K3c: warps 0, 1 compute S^T = K Q^T and warps 2, 3 dP^T = V dO^T, each
//   for 8 of the tile's q rows; after the exchange every warp forms P^T
//   and dS^T, and computes dV += P^T dO and dK += dS^T Q for its quarter
//   of D.
//
// (A first version gave each tile to one warp, 4 unrelated tiles a block
// with no barrier: each warp then ran all of a tile's products alone, one
// warp a scheduler, and was 10-27% slower at the path's shape and 9-12%
// at (64, 4, 32, 64); at (1, 4, 8192, 64) it was faster for K3a.
// PERF.md has the readings.)
//
// Fragment layouts (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4):
// A (16 x 8, row) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B (8 x 8, col) b0 (k t, n g), b1 (k t + 4, n g); C (16 x 8) c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1). A product whose k
// is the 8 columns of a C tile (P V, dS K, P^T dO, dS^T Q) takes the k order
// 2t, 2t + 1 for logical t, t + 4 in A and B alike, so c0..c3 become
// a0, a2, a1, a3 with no shuffle. Shared rows are D + 4 floats apart,
// which puts the 32 lanes of every fragment load on 32 banks.
//
// Tiles skipped, all exactly (a fully masked tile adds p = 0 and leaves
// m unchanged, alpha = exp(0) = 1): tiles past the diagonal, and tiles
// whose segment-id ranges [min, max] cannot meet the owner's (no equal
// pair can exist). Episode ids from cumsum(done) increase along T, so
// at long T only the tiles near the diagonal that share an episode are
// computed. The test runs 128 tiles at a time, one chunk of 32 a warp
// (`Walk`), one tile a lane (`live_tiles`: independent 16-byte loads,
// then one ballot), the first 128 while the diagonal tile's copy is in
// flight (the diagonal tile holds every row's own key, so it is always
// live). Each output has exactly one writer: no atomics, the same bits
// from call to call.
//
// Precision: float32 sums, 3xTF32 products, no fast math (expf, logf at
// full precision). Sums run in another order than the plain PyTorch
// version's matrix products, so the two agree to rounding.
//
// Bound through ctypes: plain C interface, device pointers and the
// caller's stream, cudaError_t returned to the caller.
//
// Built with -DDRL_FLASH_PHASES (which ops/kernels/_build.py never sets),
// each kernel also writes the globaltimer at each phase boundary of a
// block's walk: scripts/attention_phase_profile.py reads them.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMma = 16;                       // rows (keys) of a tile
constexpr float kMask = -0.5f * FLT_MAX;       // ops/attention.py:_MASK_VALUE
constexpr unsigned kAll = 0xffffffffu;

#ifdef DRL_FLASH_PHASES
// [blocks, 8] of globaltimer readings (ns) per block of a K3a, K3b or
// K3c call (warp 0's view), or null: 0 start, 1 first tile landed, 2
// first tile computed, 3 last tile computed, 4 outputs stored; 5 holds
// the number of tiles computed; 6 and 7 fall inside the first tile,
// before and after the barrier that exchanges the warps' parts of S (and
// dP; S^T and dP^T in K3c).
__device__ unsigned long long* g_marks;
#define MARK(block, i)                                                       \
  do {                                                                       \
    __syncwarp();                                                            \
    if (threadIdx.x == 0 && g_marks) {                                       \
      unsigned long long ns;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                 \
      g_marks[static_cast<size_t>(block) * 8 + (i)] = ns;                    \
    }                                                                        \
  } while (0)
#define COUNT(block, n)                                                      \
  do {                                                                       \
    if (threadIdx.x == 0 && g_marks)                                         \
      g_marks[static_cast<size_t>(block) * 8 + 5] = (n);                     \
  } while (0)
#else
#define MARK(block, i) \
  do {                 \
  } while (0)
#define COUNT(block, n) \
  do {                  \
  } while (0)
#endif

// [lo, hi] of the segment ids of rows [r0, r0 + 16) below T, in every
// lane of the warp.
__device__ __forceinline__ void seg_range(const int* seg, int r0, int T, int& lo, int& hi) {
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int r = r0 + lane;
  const bool in = lane < kMma && r < T;
  int a = in ? seg[r] : INT_MAX;
  int b = in ? seg[r] : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = min(a, __shfl_xor_sync(kAll, a, o));
    b = max(b, __shfl_xor_sync(kAll, b, o));
  }
  lo = a;
  hi = b;
}

// Bit i set: the segment-id range [min, max] of 16-row tile c0 + i (only
// tiles first..last count) meets [lo, hi]. Lane i reads its tile's ids,
// 4 at a time (T is a multiple of 8, so a group of 4 is wholly in or out
// of range). Every lane gets the same mask, so a loop over it is uniform
// across the warp.
__device__ __forceinline__ unsigned live_tiles(const int* seg, int c0, int first, int last,
                                               int T, int lo, int hi) {
  const int j = c0 + static_cast<int>(threadIdx.x % 32);
  bool live = false;
  if (j >= first && j <= last) {
    int a = INT_MAX, b = INT_MIN;
#pragma unroll
    for (int i = 0; i < kMma; i += 4) {
      const int r = j * kMma + i;
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

// The live tiles of a block's walk, found 128 at a time: each of the 4
// warps tests one 32-tile chunk (`live_tiles`, one ballot), and the masks
// meet in shared memory. The walk goes from tile `from` towards `to`
// (dir = +1 or -1), testing the tiles between them.
struct Walk {
  int from, to, dir, T, lo, hi;
  const int* seg;
  unsigned* masks;  // [2][kWarps] in shared memory: double-buffered passes
  int c0 = 0, pass = 0;
  bool tested = false;

  // Test the 4 chunks from chunk c (one a warp); every thread of the
  // block calls it.
  __device__ __forceinline__ void test(int c) {
    const int warp = static_cast<int>(threadIdx.x / 32);
    const int first = min(from, to), last = max(from, to);
    const unsigned m = live_tiles(seg, c + dir * 32 * warp, first, last, T, lo, hi);
    pass ^= 1;
    if (threadIdx.x % 32 == 0) masks[pass * kWarps + warp] = m;
    c0 = c;
    tested = true;
    __syncthreads();
  }

  // The first live tile from j on (j itself included), or past `to`.
  __device__ __forceinline__ int next(int j) {
    while (dir > 0 ? j <= to : j >= to) {
      const int c = j - j % 32;
      if (!tested || (dir > 0 ? c > c0 + 96 : c < c0 - 96)) test(c);
      for (int w = 0; w < kWarps; ++w) {
        const int cw = c0 + dir * 32 * w;
        unsigned m = masks[pass * kWarps + w];
        if (dir > 0) {
          if (j >= cw + 32) continue;
          if (j > cw) m &= kAll << (j - cw);
          if (m != 0u) return cw + __ffs(m) - 1;
        } else {
          if (j < cw) continue;
          if (j < cw + 31) m &= kAll >> (31 - (j - cw));
          if (m != 0u) return cw + 31 - __clz(m);
        }
      }
      j = c0 + dir * 32 * kWarps + (dir > 0 ? 0 : 31);  // past this window
    }
    return to + dir;
  }
};

// ---- 3xTF32 tensor-core products and cp.async staging ----

// Round to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: the result of cvt.rna.tf32.f32 for every finite x, in two
// integer operations (with cvt.rna.tf32.f32 the product phases took
// 1.3-1.8x as long on an H100).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each rounded to TF32.
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the two small terms first; a is split by the
// caller (it serves several n tiles), b here.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float b0, float b1) {
  const float b[2] = {b0, b1};
  uint32_t b_hi[2], b_lo[2];
  split_tf32(b, b_hi, b_lo);
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// The same terms for a product over D, each into its own accumulator
// (a_lo b_hi, a_hi b_lo, a_hi b_hi): three chains of D / 8 dependent
// products in place of one of 3D / 8. `sum3` adds them, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[3][4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float b0, float b1) {
  const float b[2] = {b0, b1};
  uint32_t b_hi[2], b_lo[2];
  split_tf32(b, b_hi, b_lo);
  mma_tf32(c[0], a_lo, b_hi);
  mma_tf32(c[1], a_hi, b_lo);
  mma_tf32(c[2], a_hi, b_hi);
}

__device__ __forceinline__ float sum3(const float (&c)[3][4], int e) {
  return (c[0][e] + c[1][e]) + c[2][e];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, around L1 (16) or
// through it (4); zero-filled, and nothing read, when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Start copying rows [r0, r0 + 16) of a [T, D] matrix into a shared tile
// with row stride D + 4, zero-filling rows at or past T; thread `tid` of
// the block takes every kThreads-th 16-byte chunk.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int T,
                                           int tid) {
  constexpr int kVec = D / 4;
#pragma unroll
  for (int n = 0; n < kMma * kVec / kThreads; ++n) {
    const int i = tid + kThreads * n;
    const int r = i / kVec, c = (i % kVec) * 4;
    const bool in = r0 + r < T;
    cp_async16(dst + r * (D + 4) + c, src + static_cast<size_t>(in ? r0 + r : 0) * D + c, in);
  }
}

// Start copying the 16 segment ids of rows [r0, r0 + 16) (zero past T).
__device__ __forceinline__ void stage_ids(int* dst, const int* src, int r0, int T, int tid) {
  if (tid < kMma / 4) {
    const int r = r0 + 4 * tid;
    cp_async16(dst + 4 * tid, src + (r < T ? r : 0), r < T);
  }
}

// A warp's 16 x 8 fragment of a partial product, out to its slot of the
// block's exchange area (lane-major float4s) or back from another's.
__device__ __forceinline__ void put_part(float* part, int warp, int lane, const float (&c)[3][4]) {
  *reinterpret_cast<float4*>(part + (warp * 32 + lane) * 4) =
      make_float4(sum3(c, 0), sum3(c, 1), sum3(c, 2), sum3(c, 3));
}

__device__ __forceinline__ float4 get_part(const float* part, int warp, int lane) {
  return *reinterpret_cast<const float4*>(part + (warp * 32 + lane) * 4);
}

// K3a. One block per (bh, 16-row q tile). Shared memory: two stages of K
// and V [16][D + 4] with their 16 segment ids, then the warps' partial S.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qs,
                 const int* __restrict__ ks, float* __restrict__ o,
                 float* __restrict__ lse, int BH, int T, int n_tiles, float scale) {
  constexpr int LD = D + 4;
  constexpr int kHalf = D / 16;                      // k steps of S a warp takes
  constexpr int kQuarter = D / 32;                   // n tiles of O a warp owns
  constexpr int kStage = 2 * kMma * LD + kMma;       // floats: K, V, key ids
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* part = ring + 2 * kStage;
  unsigned* masks = reinterpret_cast<unsigned*>(part + kWarps * 32 * 4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  MARK(blockIdx.x, 0);
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / BH;  // heaviest (last) first
  const size_t base = static_cast<size_t>(blockIdx.x % BH) * T;
  const int q0 = tile * kMma;
  const int g = lane / 4, t = lane % 4;
  const int rows[2] = {q0 + g, q0 + g + 8};
  // This warp's unit of S: keys 8 * half_n.., k steps kHalf * half_d...
  const int half_n = warp & 1, half_d = warp >> 1;
  const float* kb = k + base * D;
  const float* vb = v + base * D;
  const int* ksb = ks + base;

  // The diagonal tile first: it holds every row's own key, so it is live.
  auto stage = [&](int j, float* dst) {
    stage_rows<D>(dst, kb, j * kMma, T, tid);
    stage_rows<D>(dst + kMma * LD, vb, j * kMma, T, tid);
    stage_ids(reinterpret_cast<int*>(dst + 2 * kMma * LD), ksb, j * kMma, T, tid);
  };
  stage(tile, ring);
  cp_async_commit();

  // Q as A fragments for this warp's k steps, rows g and g + 8 (zero past T).
  float qa[kHalf][4];
  int qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < T;
    const float* row = q + (base + (in ? rows[r] : 0)) * D + half_d * kHalf * 8 + t;
#pragma unroll
    for (int kk = 0; kk < kHalf; ++kk) {
      qa[kk][r] = in ? __ldg(row + kk * 8) : 0.f;
      qa[kk][r + 2] = in ? __ldg(row + kk * 8 + 4) : 0.f;
    }
    qseg[r] = in ? qs[base + rows[r]] : 0;
  }
  Walk walk;  // down from the diagonal, while its copy is in flight
  walk.from = tile - 1, walk.to = 0, walk.dir = -1, walk.T = T, walk.lo = 0, walk.hi = -1;
  walk.seg = ksb, walk.masks = masks;
  if (tile > 0) seg_range(qs + base, q0, T, walk.lo, walk.hi);
  int next = walk.next(tile - 1);

  float acc[kQuarter][4] = {};
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sums
  int buf = 0, done = 0;
  for (int j = tile; j >= 0;) {
    cp_async_wait<0>();
    // Tile j has landed for every thread, and every warp is done with the
    // other stage and with the partials of the tile before.
    __syncthreads();
    if (done == 0) MARK(blockIdx.x, 1);
    if (next >= 0) stage(next, ring + (buf ^ 1) * kStage);
    cp_async_commit();
    const float* sk = ring + buf * kStage;
    const float* sv = sk + kMma * LD;
    const int* sid = reinterpret_cast<const int*>(sv + kMma * LD);
    const int k0 = j * kMma;

    float s3[3][4] = {};
#pragma unroll
    for (int kk = 0; kk < kHalf; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(qa[kk], a_hi, a_lo);
      const float* kr = sk + (half_n * 8 + g) * LD + (half_d * kHalf + kk) * 8 + t;
      mma_3xtf32(s3, a_hi, a_lo, kr[0], kr[4]);
    }
    put_part(part, warp, lane, s3);
    if (done == 0) MARK(blockIdx.x, 6);
    __syncthreads();
    if (done == 0) MARK(blockIdx.x, 7);
    // Every warp sums the same partials in the same order: the same S,
    // m, l and P in all four.
    float s[2][4], mx[2] = {m[0], m[1]};
    bool valid[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 lo = get_part(part, n, lane), hi = get_part(part, n + 2, lane);
      const float sum[4] = {lo.x + hi.x, lo.y + hi.y, lo.z + hi.z, lo.w + hi.w};
      const int2 ids = *reinterpret_cast<const int2*>(sid + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        valid[n][e] = key <= rows[e >> 1] && ((e & 1) ? ids.y : ids.x) == qseg[e >> 1];
        s[n][e] = valid[n][e] ? sum[e] * scale : kMask;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = valid[n][e] ? expf(s[n][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int nd = 0; nd < kQuarter; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    }
    // O += P V on this warp's columns: k step kk is keys 8kk.. in the
    // order 2t, 2t + 1.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float p[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      uint32_t a_hi[4], a_lo[4];
      split_tf32(p, a_hi, a_lo);
#pragma unroll
      for (int nd = 0; nd < kQuarter; ++nd) {
        const float* vr = sv + (kk * 8 + 2 * t) * LD + (warp * kQuarter + nd) * 8 + g;
        mma_3xtf32(acc[nd], a_hi, a_lo, vr[0], vr[LD]);
      }
    }
    if (done++ == 0) MARK(blockIdx.x, 2);
    buf ^= 1;
    j = next;
    if (j >= 0) next = walk.next(j - 1);
  }
  MARK(blockIdx.x, 3);
  COUNT(blockIdx.x, done);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kAll, l[r], 1);
    l[r] += __shfl_xor_sync(kAll, l[r], 2);
    if (rows[r] >= T) continue;
    const float l_safe = fmaxf(l[r], FLT_MIN);
    const float inv = 1.f / l_safe;  // one division a row, not one an element
    float* out = o + (base + rows[r]) * D + warp * kQuarter * 8 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kQuarter; ++nd)
      *reinterpret_cast<float2*>(out + nd * 8) =
          make_float2(acc[nd][2 * r] * inv, acc[nd][2 * r + 1] * inv);
    if (warp == 0 && t == 0) lse[base + rows[r]] = m[r] + logf(l_safe);
  }
  MARK(blockIdx.x, 4);
}

// K3b. One block per (bh, 16-row q tile), walking the live key tiles as
// K3a does. Shared memory: two stages of K and V [16][D + 4] with their 16
// segment ids, then the warps' parts of S and dP. At D = 64, 4 blocks an
// SM (128 registers, not the 135 ptxas would take): the 512 blocks of
// (64, 4, 32, 64) then run in one wave, not 3 blocks an SM in two.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ qs,
                const int* __restrict__ ks, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int BH, int T, int n_tiles, float scale) {
  constexpr int LD = D + 4;
  constexpr int kSteps = D / 8;                      // k steps of S and dP
  constexpr int kQuarter = D / 32;                   // n tiles of dQ a warp owns
  constexpr int kStage = 2 * kMma * LD + kMma;       // floats: K, V, key ids
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* part = ring + 2 * kStage;
  unsigned* masks = reinterpret_cast<unsigned*>(part + kWarps * 32 * 4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  MARK(blockIdx.x, 0);
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / BH;  // heaviest (last) first
  const size_t base = static_cast<size_t>(blockIdx.x % BH) * T;
  const int q0 = tile * kMma;
  const int g = lane / 4, t = lane % 4;
  const int rows[2] = {q0 + g, q0 + g + 8};
  // This warp's unit: S = Q K^T (warps 0, 1) or dP = dO V^T (2, 3), for
  // keys 8 * half_n.. of the tile.
  const int half_n = warp & 1;
  const float* kb = k + base * D;
  const float* vb = v + base * D;
  const int* ksb = ks + base;

  // The diagonal tile first: it holds every row's own key, so it is live.
  auto stage = [&](int j, float* dst) {
    stage_rows<D>(dst, kb, j * kMma, T, tid);
    stage_rows<D>(dst + kMma * LD, vb, j * kMma, T, tid);
    stage_ids(reinterpret_cast<int*>(dst + 2 * kMma * LD), ksb, j * kMma, T, tid);
  };
  stage(tile, ring);
  cp_async_commit();

  // Q (warps 0, 1) or dO (2, 3) as A fragments over all of D, rows g and
  // g + 8 (zero past T), split into hi and lo once; each row's segment
  // id, lse and delta.
  uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
  int qseg[2];
  float row_lse[2], row_delta[2];
  {
    float x[kSteps][4];
    const float* src = warp < 2 ? q : dout;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < T;
      const size_t at = base + (in ? rows[r] : 0);
      const float* row = src + at * D + t;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        x[kk][r] = in ? __ldg(row + kk * 8) : 0.f;
        x[kk][r + 2] = in ? __ldg(row + kk * 8 + 4) : 0.f;
      }
      qseg[r] = in ? qs[at] : 0;
      row_lse[r] = in ? lse[at] : 0.f;
      row_delta[r] = in ? delta[at] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) split_tf32(x[kk], a_hi[kk], a_lo[kk]);
  }
  Walk walk;  // down from the diagonal, while its copy is in flight
  walk.from = tile - 1, walk.to = 0, walk.dir = -1, walk.T = T, walk.lo = 0, walk.hi = -1;
  walk.seg = ksb, walk.masks = masks;
  if (tile > 0) seg_range(qs + base, q0, T, walk.lo, walk.hi);
  int next = walk.next(tile - 1);

  float acc[kQuarter][4] = {};
  int buf = 0, done = 0;
  for (int j = tile; j >= 0;) {
    cp_async_wait<0>();
    // Tile j has landed for every thread, and every warp is done with the
    // other stage and with the parts of the tile before.
    __syncthreads();
    if (done == 0) MARK(blockIdx.x, 1);
    if (next >= 0) stage(next, ring + (buf ^ 1) * kStage);
    cp_async_commit();
    const float* sk = ring + buf * kStage;
    const float* sv = sk + kMma * LD;
    const int* sid = reinterpret_cast<const int*>(sv + kMma * LD);
    const int k0 = j * kMma;

    // This warp's unit: q rows are rows, keys 8 * half_n.. columns.
    {
      const float* b_src = warp < 2 ? sk : sv;
      float u3[3][4] = {};
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const float* br = b_src + (half_n * 8 + g) * LD + kk * 8 + t;
        mma_3xtf32(u3, a_hi[kk], a_lo[kk], br[0], br[4]);
      }
      put_part(part, warp, lane, u3);
    }
    if (done == 0) MARK(blockIdx.x, 6);
    __syncthreads();
    if (done == 0) MARK(blockIdx.x, 7);
    // P and dS, the same in all four warps.
    float ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 s4 = get_part(part, n, lane), d4 = get_part(part, n + 2, lane);
      const float sn[4] = {s4.x, s4.y, s4.z, s4.w}, dn[4] = {d4.x, d4.y, d4.z, d4.w};
      const int2 ids = *reinterpret_cast<const int2*>(sid + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, odd = e & 1;
        const int key = k0 + n * 8 + 2 * t + odd;
        const bool valid = key <= rows[r] && (odd ? ids.y : ids.x) == qseg[r];
        const float p = valid ? expf(sn[e] * scale - row_lse[r]) : 0.f;
        ds[n][e] = p * (dn[e] - row_delta[r]) * scale;
      }
    }
    // dQ += dS K on this warp's columns: k step kk is keys 8kk.. in the
    // order 2t, 2t + 1.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float a[4] = {ds[kk][0], ds[kk][2], ds[kk][1], ds[kk][3]};
      uint32_t d_hi[4], d_lo[4];
      split_tf32(a, d_hi, d_lo);
#pragma unroll
      for (int nd = 0; nd < kQuarter; ++nd) {
        const float* kr = sk + (kk * 8 + 2 * t) * LD + (warp * kQuarter + nd) * 8 + g;
        mma_3xtf32(acc[nd], d_hi, d_lo, kr[0], kr[LD]);
      }
    }
    if (done++ == 0) MARK(blockIdx.x, 2);
    buf ^= 1;
    j = next;
    if (j >= 0) next = walk.next(j - 1);
  }
  MARK(blockIdx.x, 3);
  COUNT(blockIdx.x, done);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    float* out = dq + (base + rows[r]) * D + warp * kQuarter * 8 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kQuarter; ++nd)
      *reinterpret_cast<float2*>(out + nd * 8) = make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
  MARK(blockIdx.x, 4);
}

// K3c. One block per (bh, 16-key tile). Shared memory: K and V
// [16][D + 4], two stages of Q and dO [16][D + 4] with the 16 rows'
// segment ids, lse and delta, then the warps' parts of S^T and dP^T.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qs,
                 const int* __restrict__ ks, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int BH, int T, int n_tiles,
                 float scale) {
  constexpr int LD = D + 4;
  constexpr int kSteps = D / 8;                      // k steps of S^T and dP^T
  constexpr int kQuarter = D / 32;                   // n tiles of dK, dV a warp owns
  constexpr int kStage = 2 * kMma * LD + 3 * kMma;   // floats: Q, dO, ids, lse, delta
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kMma * LD;
  float* ring = sv + kMma * LD;
  float* part = ring + 2 * kStage;
  unsigned* masks = reinterpret_cast<unsigned*>(part + kWarps * 32 * 4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  MARK(blockIdx.x, 0);
  const int tile = static_cast<int>(blockIdx.x) / BH;  // heaviest (first) key tiles first
  const size_t base = static_cast<size_t>(blockIdx.x % BH) * T;
  const int k0 = tile * kMma;
  const int g = lane / 4, t = lane % 4;
  const int keys[2] = {k0 + g, k0 + g + 8};
  // This warp's unit: S^T = K Q^T (warps 0, 1) or dP^T = V dO^T (2, 3),
  // on q rows 8 * half_n...
  const int half_n = warp & 1;
  const float* qb = q + base * D;
  const float* dob = dout + base * D;
  const int* qsb = qs + base;

  stage_rows<D>(sk, k + base * D, k0, T, tid);
  stage_rows<D>(sv, v + base * D, k0, T, tid);
  // The diagonal q tile first: it holds every key's own row, so it is live.
  auto stage = [&](int i, float* dst) {
    const int r0 = i * kMma;
    stage_rows<D>(dst, qb, r0, T, tid);
    stage_rows<D>(dst + kMma * LD, dob, r0, T, tid);
    stage_ids(reinterpret_cast<int*>(dst + 2 * kMma * LD), qsb, r0, T, tid);
    // lse (threads 0-15) and delta (16-31), 4 bytes each: the wrapper
    // does not ask them to be 16-byte aligned.
    if (tid < 2 * kMma) {
      const int r = r0 + tid % kMma;
      const float* src = (tid < kMma ? lse : delta) + base;
      cp_async4(dst + 2 * kMma * LD + kMma + tid, src + (r < T ? r : 0), r < T);
    }
  };
  stage(tile, ring);
  cp_async_commit();

  int kseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kseg[r] = keys[r] < T ? ks[base + keys[r]] : 0;
  Walk walk;  // up from the diagonal, while its copy is in flight
  walk.from = tile + 1, walk.to = n_tiles - 1, walk.dir = 1, walk.T = T, walk.lo = 0;
  walk.hi = -1, walk.seg = qsb, walk.masks = masks;
  if (tile < n_tiles - 1) seg_range(ks + base, k0, T, walk.lo, walk.hi);
  int next = walk.next(tile + 1);

  float acc_k[kQuarter][4] = {}, acc_v[kQuarter][4] = {};
  int buf = 0, done = 0;
  for (int i = tile; i < n_tiles;) {
    cp_async_wait<0>();
    // K, V and q tile i have landed for every thread, and every warp is
    // done with the other stage and with the parts of the tile before.
    __syncthreads();
    if (done == 0) MARK(blockIdx.x, 1);
    if (next < n_tiles) stage(next, ring + (buf ^ 1) * kStage);
    cp_async_commit();
    const float* sq = ring + buf * kStage;
    const float* sdo = sq + kMma * LD;
    const int* sid = reinterpret_cast<const int*>(sdo + kMma * LD);
    const float* slse = reinterpret_cast<const float*>(sid) + kMma;
    const float* sdelta = slse + kMma;
    const int q0 = i * kMma;

    // This warp's unit: keys are rows, q rows 8 * half_n.. columns.
    {
      const float* a_src = warp < 2 ? sk : sv;
      const float* b_src = warp < 2 ? sq : sdo;
      float u3[3][4] = {};
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const float* ar = a_src + g * LD + kk * 8 + t;
        const float a[4] = {ar[0], ar[8 * LD], ar[4], ar[8 * LD + 4]};
        uint32_t a_hi[4], a_lo[4];
        split_tf32(a, a_hi, a_lo);
        const float* br = b_src + (half_n * 8 + g) * LD + kk * 8 + t;
        mma_3xtf32(u3, a_hi, a_lo, br[0], br[4]);
      }
      put_part(part, warp, lane, u3);
    }
    if (done == 0) MARK(blockIdx.x, 6);
    __syncthreads();
    if (done == 0) MARK(blockIdx.x, 7);
    // P^T and dS^T, the same in all four warps.
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 s4 = get_part(part, n, lane), d4 = get_part(part, n + 2, lane);
      const float sn[4] = {s4.x, s4.y, s4.z, s4.w}, dn[4] = {d4.x, d4.y, d4.z, d4.w};
      const int c = n * 8 + 2 * t;
      const int2 ids = *reinterpret_cast<const int2*>(sid + c);
      const float2 row_lse = *reinterpret_cast<const float2*>(slse + c);
      const float2 row_delta = *reinterpret_cast<const float2*>(sdelta + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int odd = e & 1;
        const int row = q0 + c + odd;
        const bool valid = row < T && row >= keys[e >> 1] &&
                           (odd ? ids.y : ids.x) == kseg[e >> 1];
        const float p = valid ? expf(sn[e] * scale - (odd ? row_lse.y : row_lse.x)) : 0.f;
        dp[n][e] = p * (dn[e] - (odd ? row_delta.y : row_delta.x)) * scale;
        s[n][e] = p;
      }
    }
    // dV += P^T dO and dK += dS^T Q on this warp's columns: k step kk is
    // q rows 8kk.. in the order 2t, 2t + 1.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      const float da[4] = {dp[kk][0], dp[kk][2], dp[kk][1], dp[kk][3]};
      uint32_t p_hi[4], p_lo[4], d_hi[4], d_lo[4];
      split_tf32(pa, p_hi, p_lo);
      split_tf32(da, d_hi, d_lo);
#pragma unroll
      for (int nd = 0; nd < kQuarter; ++nd) {
        const int col = (warp * kQuarter + nd) * 8 + g;
        const float* dr = sdo + (kk * 8 + 2 * t) * LD + col;
        const float* qr = sq + (kk * 8 + 2 * t) * LD + col;
        mma_3xtf32(acc_v[nd], p_hi, p_lo, dr[0], dr[LD]);
        mma_3xtf32(acc_k[nd], d_hi, d_lo, qr[0], qr[LD]);
      }
    }
    if (done++ == 0) MARK(blockIdx.x, 2);
    buf ^= 1;
    i = next;
    if (i < n_tiles) next = walk.next(i + 1);
  }
  MARK(blockIdx.x, 3);
  COUNT(blockIdx.x, done);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= T) continue;
    const size_t at = (base + keys[r]) * D + warp * kQuarter * 8 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kQuarter; ++nd) {
      *reinterpret_cast<float2*>(dk + at + nd * 8) =
          make_float2(acc_k[nd][2 * r], acc_k[nd][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + at + nd * 8) =
          make_float2(acc_v[nd][2 * r], acc_v[nd][2 * r + 1]);
    }
  }
  MARK(blockIdx.x, 4);
}

// Dynamic shared memory of a block (as laid out above, with 4 warps'
// partial 16 x 8 tiles and two passes of tile masks): K3a and K3b stage
// K and V, K3c Q and dO beside its own K and V.
constexpr size_t kv_smem(int D) {
  return sizeof(float) * (2 * (2 * kMma * (D + 4) + kMma) + kWarps * 32 * 4 + 2 * kWarps);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (2 * kMma * (D + 4) + 2 * (2 * kMma * (D + 4) + 3 * kMma) +
                          kWarps * 32 * 4 + 2 * kWarps);
}

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

int mma_tiles(int T) { return (T + kMma - 1) / kMma; }

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const int* qs, const int* ks,
               float* o, float* lse, int BH, int T, float scale, cudaStream_t s) {
  static bool done = false;
  const int err = allow_smem(flash_fwd_kernel<D>, kv_smem(D), &done);
  if (err != 0) return err;
  flash_fwd_kernel<D><<<BH * mma_tiles(T), kThreads, kv_smem(D), s>>>(
      q, k, v, qs, ks, o, lse, BH, T, mma_tiles(T), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const int* qs, const int* ks,
              const float* dout, const float* lse, const float* delta, float* dq, int BH,
              int T, float scale, cudaStream_t s) {
  static bool done = false;
  const int err = allow_smem(flash_dq_kernel<D>, kv_smem(D), &done);
  if (err != 0) return err;
  flash_dq_kernel<D><<<BH * mma_tiles(T), kThreads, kv_smem(D), s>>>(
      q, k, v, qs, ks, dout, lse, delta, dq, BH, T, mma_tiles(T), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const int* qs, const int* ks,
               const float* dout, const float* lse, const float* delta, float* dk, float* dv,
               int BH, int T, float scale, cudaStream_t s) {
  static bool done = false;
  const int err = allow_smem(flash_dkv_kernel<D>, dkv_smem(D), &done);
  if (err != 0) return err;
  flash_dkv_kernel<D><<<BH * mma_tiles(T), kThreads, dkv_smem(D), s>>>(
      q, k, v, qs, ks, dout, lse, delta, dk, dv, BH, T, mma_tiles(T), scale);
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

#ifdef DRL_FLASH_PHASES
extern "C" int drl_flash_set_marks(unsigned long long* marks) {
  return static_cast<int>(cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks)));
}
#endif

extern "C" const char* drl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
