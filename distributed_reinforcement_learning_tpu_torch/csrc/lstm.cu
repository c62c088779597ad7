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
// What bounds it on an H100: operations. At the R2D2 learn step's shape
// (T=10, B=32, H=512) the forward does 2*T*B*H*4H = 671 MFLOP, 10.0 us at
// the 67 TFLOP/s float32 peak, against ~8 MB of bytes (2.4 us at 3.35
// TB/s). The backward recomputes the gates and adds dgates @ Wh^T: twice
// the operations, ~20 us. The T steps are dependent, and Wh (4 MiB at H =
// 512) is 18x one SM's shared memory, so the Pallas design of keeping all
// of Wh resident across the time grid does not carry over.
//
// Design (simple first; a persistent kernel with Wh split across the SMs
// and a grid barrier per step is later work):
//
// - One launch per time step on the caller's stream: stream order is the
//   step-to-step barrier, and the whole sequence can be captured in a
//   CUDA graph. The step reads the previous step's h_all/c_all (times
//   keep) or h0/c0, so the forward needs no carry buffer.
// - Both products are one tile routine, `tile_products`: a block owns
//   kRows batch rows and kWidth output columns. It stages its rows of
//   the left operand (h_{t-1}, or the step's dgates) in shared memory,
//   transposed so a thread reads its kRows values with two float4 loads,
//   and streams the right operand (Wh, or Wh^T) through a kStages-deep
//   ring of kChunk-row tiles with cp.async. Both loads keep many requests
//   in flight: the first version read Wh straight from L2 a few loads per
//   thread at a time and was latency-bound at ~34 us a step, and a
//   staging loop that waited on one load per iteration cost ~10 us more.
//   The 50 MB L2 holds all of Wh. Thread (s, col) sums every split-th row
//   into kRows accumulators; the partial sums meet in shared memory.
// - Gate kernel (forward, and the backward's recompute): the block's
//   columns are 8 hidden units j with ALL FOUR gate columns k*H + j of
//   each, so the cell update (or, in the backward, the gate gradients)
//   stays inside the block: one thread per (row, unit) adds the partial
//   sums to xg and applies it.
// - Backward product dh = dgates @ Wh^T over the 4H columns: the same
//   tile over a transposed copy of Wh, made once per call by a small
//   transpose kernel. The backward is two launches per step: dgates needs
//   the carried dh, and the carried dh needs every column of dgates.
// - Arithmetic in float32 on the CUDA cores, no TF32 and no fast math,
//   so the kernels match the plain PyTorch versions (float32 cuBLAS with
//   TF32 off) to the rounding of 512-term sums taken in another order.
//
// Bound through ctypes: plain C interface, device pointers and the
// caller's stream, cudaError_t returned to the caller.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;      // batch rows per block
constexpr int kThreads = 256;
constexpr int kChunk = 64;    // right-operand rows per pipeline stage
constexpr int kStages = 4;    // pipeline depth
constexpr int kUnits = 8;     // hidden units per gate block (4 gates: 32 columns)
constexpr int kGateWidth = 4 * kUnits;
constexpr int kDhWidth = 16;  // hidden units per dh block

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Issue the cp.async copies of right-operand rows [c*kChunk, (c+1)*kChunk)
// into `slot`: kSegs segments of kWidth/kSegs columns, segment g starting
// at column g*seg_stride + n0 of each row. Out-of-range rows and columns
// are zero-filled.
template <int kSegs, int kWidth>
__device__ void load_chunk(const float* __restrict__ rhs, size_t ldb, size_t seg_stride,
                           int n0, int N, int K, int c, float* slot) {
  constexpr int kSegW = kWidth / kSegs;
  constexpr int kVecs = kSegW / 4;
  constexpr int kPerRow = kSegs * kVecs;
  for (int idx = threadIdx.x; idx < kChunk * kPerRow; idx += kThreads) {
    const int kk = idx / kPerRow;
    const int q = idx - kk * kPerRow;
    const int seg = q / kVecs;
    const int v = q - seg * kVecs;
    const int k = c * kChunk + kk;
    const int n = n0 + 4 * v;
    float* dst = slot + kk * kWidth + seg * kSegW + 4 * v;
    if (k < K && n < N) {
      __pipeline_memcpy_async(dst, rhs + k * ldb + seg * seg_stride + n, 16);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The left operand (K rows, staged by `stage(lhs_s)` as lhs_s[k * kRows
// + r]) times the block's kWidth columns of rhs. The first chunks of rhs
// are requested before the left operand is staged, so the two loads
// overlap. On return part[(s * kRows + r) * kWidth + col] holds split
// s's share of output (r, col); `part` aliases the stage ring.
template <int kSegs, int kWidth, class Stage>
__device__ float* tile_products(const float* __restrict__ rhs, size_t ldb, size_t seg_stride,
                                int n0, int N, int K, Stage stage) {
  constexpr int kSplit = kThreads / kWidth;
  constexpr int kSlot = kChunk * kWidth;
  extern __shared__ float4 smem4[];
  float* lhs_s = reinterpret_cast<float*>(smem4);
  float* stages = lhs_s + kRows * K;
  const int nchunks = (K + kChunk - 1) / kChunk;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load_chunk<kSegs, kWidth>(rhs, ldb, seg_stride, n0, N, K, c, stages + c * kSlot);
    __pipeline_commit();
  }
  stage(lhs_s);
  const int col = threadIdx.x % kWidth;
  const int s = threadIdx.x / kWidth;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  const float4* lhs4 = reinterpret_cast<const float4*>(lhs_s);
  for (int c = 0; c < nchunks; ++c) {
    const int next = c + kStages - 1;
    if (next < nchunks) {
      load_chunk<kSegs, kWidth>(rhs, ldb, seg_stride, n0, N, K, next,
                                stages + (next % kStages) * kSlot);
    }
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);  // this thread's copies of chunk c landed
    __syncthreads();                     // everyone's did
    const float* slot = stages + (c % kStages) * kSlot;
    const int kmax = min(kChunk, K - c * kChunk);
#pragma unroll 4
    for (int kk = s; kk < kmax; kk += kSplit) {
      const float w = slot[kk * kWidth + col];
      const int k = c * kChunk + kk;
      const float4 a = lhs4[2 * k];
      const float4 b = lhs4[2 * k + 1];
      acc[0] = fmaf(a.x, w, acc[0]);
      acc[1] = fmaf(a.y, w, acc[1]);
      acc[2] = fmaf(a.z, w, acc[2]);
      acc[3] = fmaf(a.w, w, acc[3]);
      acc[4] = fmaf(b.x, w, acc[4]);
      acc[5] = fmaf(b.y, w, acc[5]);
      acc[6] = fmaf(b.z, w, acc[6]);
      acc[7] = fmaf(b.w, w, acc[7]);
    }
    __syncthreads();  // the slot is refilled next iteration
  }
  float* part = stages;
#pragma unroll
  for (int r = 0; r < kRows; ++r) part[(s * kRows + r) * kWidth + col] = acc[r];
  __syncthreads();
  return part;
}

// Sum of the splits for output (r, col).
template <int kWidth>
__device__ __forceinline__ float split_sum(const float* part, int r, int col) {
  constexpr int kSplit = kThreads / kWidth;
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < kSplit; ++s) sum += part[(s * kRows + r) * kWidth + col];
  return sum;
}

// Stage the block's kRows rows of a left operand with K columns (K a
// multiple of 4) as lhs_s[k * kRows + r]: row b comes from row_ptr(b),
// times row_scale(b); rows past B are zeros. Each thread issues up to
// kBatch 16-byte loads (and their scales) before it stores any, so the
// loads are in flight together rather than one L2 round trip apiece.
template <class RowPtr, class RowScale>
__device__ void stage_lhs(int K, int B, RowPtr row_ptr, RowScale row_scale, float* lhs_s) {
  constexpr int kBatch = 8;
  const int r0 = blockIdx.y * kRows;
  const int n = kRows * (K / 4);
  // Element idx is row idx % kRows, columns 4q .. 4q+3 with q = idx / kRows:
  // a warp's stores then spread over the banks (4-way at worst).
  for (int base = threadIdx.x; base < n; base += kThreads * kBatch) {
    float4 v[kBatch];
    float m[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * kThreads;
      const int b = r0 + idx % kRows;
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      m[i] = 0.0f;
      if (idx < n && b < B) {
        v[i] = reinterpret_cast<const float4*>(row_ptr(b))[idx / kRows];
        m[i] = row_scale(b);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * kThreads;
      if (idx < n) {
        float* d = lhs_s + 4 * (idx / kRows) * kRows + idx % kRows;
        d[0] = v[i].x * m[i];
        d[kRows] = v[i].y * m[i];
        d[2 * kRows] = v[i].z * m[i];
        d[3 * kRows] = v[i].w * m[i];
      }
    }
  }
  __syncthreads();
}

// (h_{t-1} @ Wh) for the block's rows and its 8 units' 4 gate columns,
// with h_{t-1} the carried h entering step t: h0, or h_all[t-1] * keep[t-1].
__device__ const float* gate_products(const float* __restrict__ wh,
                                      const float* __restrict__ keep,
                                      const float* __restrict__ h0,
                                      const float* __restrict__ h_all, int t, int B, int H) {
  auto stage = [=](float* lhs_s) {
    if (t == 0) {
      stage_lhs(H, B, [=](int b) { return h0 + static_cast<size_t>(b) * H; },
                [](int) { return 1.0f; }, lhs_s);
    } else {
      const float* h_prev = h_all + static_cast<size_t>(t - 1) * B * H;
      const float* keep_prev = keep + static_cast<size_t>(t - 1) * B;
      stage_lhs(H, B, [=](int b) { return h_prev + static_cast<size_t>(b) * H; },
                [=](int b) { return keep_prev[b]; }, lhs_s);
    }
  };
  return tile_products<4, kGateWidth>(wh, 4 * static_cast<size_t>(H), H, blockIdx.x * kUnits,
                                      H, H, stage);
}

__global__ void __launch_bounds__(kThreads)
lstm_fwd_step(const float* __restrict__ xg, const float* __restrict__ wh,
              const float* __restrict__ keep, const float* __restrict__ h0,
              const float* __restrict__ c0, float* __restrict__ h_all,
              float* __restrict__ c_all, float* __restrict__ hT,
              float* __restrict__ cT, int t, int T, int B, int H) {
  const float* part = gate_products(wh, keep, h0, h_all, t, B, H);
  if (threadIdx.x >= kRows * kUnits) return;
  const int r = threadIdx.x / kUnits;
  const int u = threadIdx.x % kUnits;
  const int b = blockIdx.y * kRows + r;
  const int j = blockIdx.x * kUnits + u;
  if (b >= B || j >= H) return;
  const size_t row = static_cast<size_t>(t) * B + b;
  const float* x = xg + row * 4 * H + j;
  const float gi = x[0] + split_sum<kGateWidth>(part, r, u);
  const float gf = x[H] + split_sum<kGateWidth>(part, r, kUnits + u);
  const float gg = x[2 * H] + split_sum<kGateWidth>(part, r, 2 * kUnits + u);
  const float go = x[3 * H] + split_sum<kGateWidth>(part, r, 3 * kUnits + u);
  const float c_in = t == 0 ? c0[static_cast<size_t>(b) * H + j]
                            : c_all[(row - B) * H + j] * keep[row - B];
  const float c_new = sigmoid(gf + 1.0f) * c_in + sigmoid(gi) * tanhf(gg);
  const float h_new = sigmoid(go) * tanhf(c_new);
  h_all[row * H + j] = h_new;
  c_all[row * H + j] = c_new;
  if (t == T - 1) {
    hT[static_cast<size_t>(b) * H + j] = h_new * keep[row];
    cT[static_cast<size_t>(b) * H + j] = c_new * keep[row];
  }
}

// Backward step t, part 1: recompute the gates, take the carried dh/dc
// (the gradients with respect to the carried, post-mask h_t and c_t), and
// write dgates (= dxg[t]) and the next carried dc (in place).
__global__ void __launch_bounds__(kThreads)
lstm_bwd_gates_step(const float* __restrict__ xg, const float* __restrict__ wh,
                    const float* __restrict__ keep, const float* __restrict__ h0,
                    const float* __restrict__ c0, const float* __restrict__ h_all,
                    const float* __restrict__ c_all, const float* __restrict__ dh_all,
                    const float* __restrict__ dh_carry, float* __restrict__ dc_carry,
                    float* __restrict__ dxg, int t, int B, int H) {
  const float* part = gate_products(wh, keep, h0, h_all, t, B, H);
  if (threadIdx.x >= kRows * kUnits) return;
  const int r = threadIdx.x / kUnits;
  const int u = threadIdx.x % kUnits;
  const int b = blockIdx.y * kRows + r;
  const int j = blockIdx.x * kUnits + u;
  if (b >= B || j >= H) return;
  const size_t row = static_cast<size_t>(t) * B + b;
  const float* x = xg + row * 4 * H + j;
  const float si = sigmoid(x[0] + split_sum<kGateWidth>(part, r, u));
  const float sf = sigmoid(x[H] + split_sum<kGateWidth>(part, r, kUnits + u) + 1.0f);
  const float sg = tanhf(x[2 * H] + split_sum<kGateWidth>(part, r, 2 * kUnits + u));
  const float so = sigmoid(x[3 * H] + split_sum<kGateWidth>(part, r, 3 * kUnits + u));
  const float c_in = t == 0 ? c0[static_cast<size_t>(b) * H + j]
                            : c_all[(row - B) * H + j] * keep[row - B];
  const float tc = tanhf(c_all[row * H + j]);
  const float k = keep[row];
  const size_t bj = static_cast<size_t>(b) * H + j;
  const float dh = dh_all[row * H + j] + k * dh_carry[bj];
  const float dc = k * dc_carry[bj] + dh * so * (1.0f - tc * tc);
  float* d = dxg + row * 4 * H + j;
  d[0] = dc * sg * si * (1.0f - si);
  d[H] = dc * c_in * sf * (1.0f - sf);
  d[2 * H] = dc * si * (1.0f - sg * sg);
  d[3 * H] = dh * tc * so * (1.0f - so);
  dc_carry[bj] = dc * sf;
}

// Backward step t, part 2: dh_carry[b, h] = sum_g dxg[t, b, g] * Wh[h, g],
// over wh_t = Wh^T [4H, H].
__global__ void __launch_bounds__(kThreads)
lstm_bwd_dh_step(const float* __restrict__ dxg_t, const float* __restrict__ wh_t,
                 float* __restrict__ dh_carry, int B, int H) {
  const int G = 4 * H;
  const int r0 = blockIdx.y * kRows;
  const int h0 = blockIdx.x * kDhWidth;
  const float* part = tile_products<1, kDhWidth>(wh_t, H, 0, h0, H, G, [=](float* lhs_s) {
    stage_lhs(G, B, [=](int b) { return dxg_t + static_cast<size_t>(b) * G; },
              [](int) { return 1.0f; }, lhs_s);
  });
  if (threadIdx.x >= kRows * kDhWidth) return;
  const int r = threadIdx.x / kDhWidth;
  const int col = threadIdx.x % kDhWidth;
  if (r0 + r < B && h0 + col < H) {
    dh_carry[static_cast<size_t>(r0 + r) * H + h0 + col] = split_sum<kDhWidth>(part, r, col);
  }
}

// wh_t[g, h] = wh[h, g] through 32x32 shared-memory tiles.
__global__ void transpose(const float* __restrict__ wh, float* __restrict__ wh_t, int H) {
  __shared__ float tile[32][33];
  const int G = 4 * H;
  const int g0 = blockIdx.x * 32;
  const int h0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int h = h0 + i;
    const int g = g0 + threadIdx.x;
    if (h < H && g < G) tile[i][threadIdx.x] = wh[static_cast<size_t>(h) * G + g];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int g = g0 + i;
    const int h = h0 + threadIdx.x;
    if (g < G && h < H) wh_t[static_cast<size_t>(g) * H + h] = tile[threadIdx.x][i];
  }
}

size_t gate_smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(kRows) * H + kStages * kChunk * kGateWidth);
}

size_t dh_smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(kRows) * 4 * H + kStages * kChunk * kDhWidth);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt in to

// Raise a kernel's dynamic shared-memory limit when a launch needs more
// than it allows (a host-side attribute, set outside any graph capture
// by the first, eager, call at that size).
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  if (err == 0) *allowed = bytes;
  return err;
}

size_t fwd_allowed = 48 * 1024, bwd_gates_allowed = 48 * 1024, dh_allowed = 48 * 1024;

int select_device(int device) {
  // This library links its own CUDA runtime, whose current device is
  // not PyTorch's: select the tensors' device (only when it differs, so
  // a launch inside CUDA-graph capture makes no device switch).
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int drl_lstm_max_hidden() {
  // Largest H (a multiple of 4, for the 16-byte copies) whose blocks fit
  // a block's shared memory.
  const size_t floats = kMaxSmem / sizeof(float);
  const size_t dh = (floats - kStages * kChunk * kDhWidth) / (4 * kRows);
  const size_t gate = (floats - kStages * kChunk * kGateWidth) / kRows;
  return static_cast<int>(dh < gate ? dh : gate) / 4 * 4;
}

extern "C" int drl_lstm_fwd(const float* xg, const float* wh, const float* keep,
                            const float* h0, const float* c0, float* h_all,
                            float* c_all, float* hT, float* cT, int T, int B,
                            int H, int device, void* stream) {
  int err = select_device(device);
  if (err == 0) err = allow_smem(lstm_fwd_step, gate_smem_bytes(H), &fwd_allowed);
  if (err != 0) return err;
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    lstm_fwd_step<<<grid, kThreads, gate_smem_bytes(H), s>>>(xg, wh, keep, h0, c0, h_all,
                                                             c_all, hT, cT, t, T, B, H);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

// wh_t is scratch for Wh^T [4H, H]. dh_carry and dc_carry hold dhT and
// dcT on entry and dh0 and dc0 on return.
extern "C" int drl_lstm_bwd(const float* xg, const float* wh, const float* keep,
                            const float* h0, const float* c0, const float* h_all,
                            const float* c_all, const float* dh_all, float* dxg,
                            float* dh_carry, float* dc_carry, float* wh_t, int T, int B,
                            int H, int device, void* stream) {
  int err = select_device(device);
  if (err == 0) err = allow_smem(lstm_bwd_gates_step, gate_smem_bytes(H), &bwd_gates_allowed);
  if (err == 0) err = allow_smem(lstm_bwd_dh_step, dh_smem_bytes(H), &dh_allowed);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  transpose<<<dim3((4 * H + 31) / 32, (H + 31) / 32), dim3(32, 8), 0, s>>>(wh, wh_t, H);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 gate_grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  const dim3 dh_grid((H + kDhWidth - 1) / kDhWidth, (B + kRows - 1) / kRows);
  const size_t G = 4 * static_cast<size_t>(H);
  for (int t = T - 1; t >= 0; --t) {
    lstm_bwd_gates_step<<<gate_grid, kThreads, gate_smem_bytes(H), s>>>(
        xg, wh, keep, h0, c0, h_all, c_all, dh_all, dh_carry, dc_carry, dxg, t, B, H);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    lstm_bwd_dh_step<<<dh_grid, kThreads, dh_smem_bytes(H), s>>>(
        dxg + static_cast<size_t>(t) * B * G, wh_t, dh_carry, B, H);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

extern "C" const char* drl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
