// Fused softmax cross-entropy head for Hopper (sm_90a), bound from Python
// through ctypes (eigen_lstm_tpu_torch/ops/head.py). No PyTorch headers.
//
// Replaces the two kernels of eigen_lstm_tpu/ops/pallas_head.py:
//   head_fwd_launch <- _fwd_head_kernel: per token row r,
//       logits = h_c[r] @ Why_c + by (fp32 sums), lse = max + log sum exp,
//       and the total sum_r (lse_r - logits_r[tgt_r]) / ln 2; lse is kept
//       as the backward's residual.
//   head_bwd_launch <- _bwd_head_kernel: logits recomputed,
//       dlog = (exp(logits - lse) - onehot) * cot / ln 2,
//       dh = round(dlog) @ Why_c^T (stored in the compute type),
//       dWhy = h_c^T round(dlog) and dby = sum_r dlog (fp32).
// h_c and Why_c are already in the compute type (bf16 or fp32); by, lse
// and every sum are fp32.
//
// What bounds it on the H100: at the bench shapes (T = 12800 rows, N = 512,
// M = 256) the forward is 2*T*N*M = 3.4 GFLOP against 13 MB (h, Why, the
// targets and lse) and the backward three times the flops against 26 MB.
// In bf16 the forward is bound by its bytes (3.9 us) and the backward by
// its operations (10.2 us at the tensor-core peak); in fp32 both by their
// operations, 50 and 150 us (bound() in chip_smoke.py). This first design
// runs on CUDA cores in fp32 FMAs.
//
// Design. A block owns 32 token rows and one thread per vocabulary column
// (M <= 256): it stages the rows' h in shared memory, k-tile by k-tile,
// transposed so each k reads four rows as one float4, and each thread
// accumulates its column's 32 logits in registers, reading Why (256 KB in
// bf16, resident in L2) coalesced. The forward's row reductions (max, sum
// of exp, the target logit) run one warp per 4 rows over shared memory;
// the block's bits go to a per-block partial that a second launch adds in
// block order, so the total has a fixed order. The backward keeps the
// block's round(dlog) tile in shared memory for dh (threads own columns of
// N, reading Why^T coalesced). The TPU kernel accumulates dWhy and dby in
// VMEM across its sequential grid; Hopper blocks run in no order, so dlog
// goes to an fp32 (T, M) scratch and dWhy and dby come from the fixed-order
// reductions of common.cuh (atb_gemm, colsum). Deterministic throughout.

#include "common.cuh"

namespace {

constexpr int kRows = 32;   // token rows per block
constexpr int kCols = 256;  // threads per block = the largest vocabulary
constexpr int kKt = 32;     // k tile of h staged in shared memory
constexpr int kPad = 36;    // row pitch of the transposed tile (16-byte aligned)
constexpr float kInvLn2 = 1.4426950408889634f;

// acc[r] = sum_k h[row0 + r, k] * Why[k, m] for the thread's column m
// (0 for m >= M and for rows past T).
template <typename CT>
__device__ __forceinline__ void row_logits(const CT* __restrict__ h,
                                           const CT* __restrict__ Why,
                                           int row0, int T, int N, int M,
                                           float (&hsT)[kKt][kPad],
                                           float (&acc)[kRows]) {
  const int m = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kKt) {
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * kKt; e += kCols) {
      const int r = e / kKt, kk = e % kKt;
      const int row = row0 + r, k = k0 + kk;
      hsT[kk][r] = row < T && k < N ? to_f32(h[(size_t)row * N + k]) : 0.0f;
    }
    __syncthreads();
    if (m < M) {
      const int klen = min(kKt, N - k0);
      for (int kk = 0; kk < klen; ++kk) {
        const float wv = to_f32(Why[(size_t)(k0 + kk) * M + m]);
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4) {
          const float4 hv = *reinterpret_cast<const float4*>(&hsT[kk][r4 * 4]);
          acc[r4 * 4 + 0] = fmaf(hv.x, wv, acc[r4 * 4 + 0]);
          acc[r4 * 4 + 1] = fmaf(hv.y, wv, acc[r4 * 4 + 1]);
          acc[r4 * 4 + 2] = fmaf(hv.z, wv, acc[r4 * 4 + 2]);
          acc[r4 * 4 + 3] = fmaf(hv.w, wv, acc[r4 * 4 + 3]);
        }
      }
    }
  }
}

// grid = ceil(T / 32), block = 256. lse (T,), partial (grid,) bits.
template <typename CT>
__global__ void __launch_bounds__(kCols)
head_fwd(const CT* __restrict__ h, const CT* __restrict__ Why,
         const float* __restrict__ by, const int* __restrict__ tgt,
         float* __restrict__ lse, float* __restrict__ partial, int T, int N,
         int M) {
  __shared__ __align__(16) float hsT[kKt][kPad];
  __shared__ float logits[kRows][kCols + 1];
  __shared__ float row_bits[kRows];
  const int row0 = blockIdx.x * kRows;
  const int m = threadIdx.x;
  float acc[kRows];
  row_logits<CT>(h, Why, row0, T, N, M, hsT, acc);
  if (m < M) {
    const float bm = by[m];
#pragma unroll
    for (int r = 0; r < kRows; ++r) logits[r][m] = acc[r] + bm;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp * (kRows / 8); r < (warp + 1) * (kRows / 8); ++r) {
    const int row = row0 + r;
    float mx = -INFINITY;
    for (int c = lane; c < M; c += 32) mx = fmaxf(mx, logits[r][c]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float se = 0.0f;
    for (int c = lane; c < M; c += 32) se += expf(logits[r][c] - mx);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) se += __shfl_xor_sync(0xffffffffu, se, o);
    if (lane == 0) {
      float bits = 0.0f;
      if (row < T) {
        const float l = mx + logf(se);
        lse[row] = l;
        bits = l - logits[r][tgt[row]];
      }
      row_bits[r] = bits;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) s += row_bits[r];
    partial[blockIdx.x] = s * kInvLn2;
  }
}

// out[0] = sum of partial[0 .. n) in order.
__global__ void sum_in_order(const float* __restrict__ partial,
                             float* __restrict__ out, int n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += partial[i];
  out[0] = s;
}

// grid = ceil(T / 32), block = 256. dlog (T, M) fp32, dh (T, N) in CT.
template <typename CT>
__global__ void __launch_bounds__(kCols)
head_bwd(const CT* __restrict__ h, const CT* __restrict__ Why,
         const CT* __restrict__ WhyT, const float* __restrict__ by,
         const int* __restrict__ tgt, const float* __restrict__ lse,
         const float* __restrict__ cot, float* __restrict__ dlog,
         CT* __restrict__ dh, int T, int N, int M) {
  __shared__ __align__(16) float hsT[kKt][kPad];
  __shared__ __align__(16) float dlT[kCols][kPad];
  const int row0 = blockIdx.x * kRows;
  const int m = threadIdx.x;
  float acc[kRows];
  row_logits<CT>(h, Why, row0, T, N, M, hsT, acc);
  const float scale = cot[0] * kInvLn2;
  if (m < M) {
    const float bm = by[m];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float d = 0.0f;
      if (row < T) {
        const float p = expf(acc[r] + bm - lse[row]);
        d = (p - (tgt[row] == m ? 1.0f : 0.0f)) * scale;
        dlog[(size_t)row * M + m] = d;
      }
      dlT[m][r] = round_to<CT>(d);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += kCols) {
    float a2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a2[r] = 0.0f;
    for (int c = 0; c < M; ++c) {
      const float wv = to_f32(WhyT[(size_t)c * N + k]);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 dv = *reinterpret_cast<const float4*>(&dlT[c][r4 * 4]);
        a2[r4 * 4 + 0] = fmaf(dv.x, wv, a2[r4 * 4 + 0]);
        a2[r4 * 4 + 1] = fmaf(dv.y, wv, a2[r4 * 4 + 1]);
        a2[r4 * 4 + 2] = fmaf(dv.z, wv, a2[r4 * 4 + 2]);
        a2[r4 * 4 + 3] = fmaf(dv.w, wv, a2[r4 * 4 + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < T) dh[(size_t)(row0 + r) * N + k] = from_f32<CT>(a2[r]);
  }
}

template <typename CT>
int run_fwd(const void* h, const void* Why, const float* by, const int* tgt,
            float* lse, float* partial, float* bits, int T, int N, int M,
            cudaStream_t stream, int* launches) {
  const int blocks = (T + kRows - 1) / kRows;
  head_fwd<CT><<<blocks, kCols, 0, stream>>>(static_cast<const CT*>(h),
                                             static_cast<const CT*>(Why), by,
                                             tgt, lse, partial, T, N, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  sum_in_order<<<1, 1, 0, stream>>>(partial, bits, blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

template <typename CT>
int run_bwd(const void* h, const void* Why, const void* WhyT, const float* by,
            const int* tgt, const float* lse, const float* cot, float* dlog,
            void* dh, float* dWhy, float* dby, float* work, int T, int N,
            int M, cudaStream_t stream, int* launches) {
  const CT* hc = static_cast<const CT*>(h);
  head_bwd<CT><<<(T + kRows - 1) / kRows, kCols, 0, stream>>>(
      hc, static_cast<const CT*>(Why), static_cast<const CT*>(WhyT), by, tgt,
      lse, cot, dlog, static_cast<CT*>(dh), T, N, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  const int e = run_atb<CT, CT>(nullptr, hc, 0, dlog, dWhy, work, T, N, M,
                                stream, launches);
  if (e != 0) return e;
  return run_colsum(dlog, dby, work, T, M, stream, launches);
}

}  // namespace

// Scratch floats: the forward's per-block partials, the backward's work.
extern "C" size_t head_fwd_work_floats(int T) { return (T + kRows - 1) / kRows; }

extern "C" size_t head_bwd_work_floats(int T, int N, int M) {
  const size_t gemm = atb_work_floats(T, N, M);
  const size_t col = (size_t)colsum_chunks_of(T) * M;
  return gemm > col ? gemm : col;
}

// Type code 0 = fp32, 1 = bf16: the type of h and Why. by, lse, bits are
// fp32; tgt int32. Requires M <= 256. Adds its launches to *launches.
extern "C" int head_fwd_launch(int ctype, const void* h, const void* Why,
                               const void* by, const void* tgt, void* lse,
                               void* partial, void* bits, int T, int N, int M,
                               void* stream, int* launches) {
  if (M > kCols) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(h, Why, static_cast<const float*>(by),
               static_cast<const int*>(tgt), static_cast<float*>(lse),
               static_cast<float*>(partial), static_cast<float*>(bits), T, N,
               M, static_cast<cudaStream_t>(stream), launches);
  };
  if (ctype == 0) return f(run_fwd<float>);
  if (ctype == 1) return f(run_fwd<__nv_bfloat16>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// cot: the scalar cotangent of the bits sum, on the device. dh has the
// type of h; dlog (T, M), dWhy (N, M), dby (M,) are fp32.
extern "C" int head_bwd_launch(int ctype, const void* h, const void* Why,
                               const void* WhyT, const void* by,
                               const void* tgt, const void* lse,
                               const void* cot, void* dlog, void* dh,
                               void* dWhy, void* dby, void* work, int T,
                               int N, int M, void* stream, int* launches) {
  if (M > kCols) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(h, Why, WhyT, static_cast<const float*>(by),
               static_cast<const int*>(tgt), static_cast<const float*>(lse),
               static_cast<const float*>(cot), static_cast<float*>(dlog), dh,
               static_cast<float*>(dWhy), static_cast<float*>(dby),
               static_cast<float*>(work), T, N, M,
               static_cast<cudaStream_t>(stream), launches);
  };
  if (ctype == 0) return f(run_bwd<float>);
  if (ctype == 1) return f(run_bwd<__nv_bfloat16>);
  return static_cast<int>(cudaErrorInvalidValue);
}
