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
// operations, 50 and 150 us (bound() in chip_smoke.py). The first design
// ran both on CUDA cores in fp32 FMAs, the forward at 0.26 ms in bf16
// (PERF.md): each 32-row block read all of Why (256 KB) from L2, ~100 MB
// over 400 blocks for a 13 MB function.
//
// The forward under bf16 compute (head_fwd_mma, below) runs the logits on
// tensor cores: 64-row blocks (half the Why reads), Why and h through a
// cp.async ring in shared memory, mma.sync with fp32 sums, the logits kept
// in the C fragments for the row reductions (ops/head.py:fwd_tensor_cores
// chooses it): 0.057 ms at the bench shapes (PERF.md), still 14x its byte
// bound, each of the 200 blocks reading all of Why from L2 (51 MB). fp32
// (TF32 stays off) and the backward keep the first design:
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
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// The forward under bf16 compute on tensor cores (head_fwd_mma). A block
// owns kTRows = 64 token rows; its 8 warps form a 4 x 2 grid, warp (wm, wn)
// the 16-row m tile wm and the vocabulary columns 128 wn .. 128 wn + 127
// (16 n tiles of 8). N is walked in chunks of kTKC: the rows' h chunk
// (64 x kTKC) and Why's (kTKC x M, columns past M zero-filled) arrive by
// cp.async in a ring of kTStages slots; each k step of 16 is one ldmatrix of
// h and eight transposed ldmatrix of Why for 16 mma.sync m16n8k16 (bf16 in,
// fp32 sums; csrc/mma.cuh). The logits stay in the C fragments: lane (g, q)
// holds rows g and g + 8 of its m tile at columns 8 nt + 2q, 2q + 1. The
// epilogue adds by, takes each row's max over its lanes (shuffles over q)
// and the two column halves (shared memory), then the sum of exp, the
// target's logit (written by the lane that holds it), lse and the row's
// bits; the block's bits are added in row order into its partial, which
// sum_in_order adds in block order.
constexpr int kTRows = 64;
constexpr int kTKC = 64;
constexpr int kTStages = 2;
constexpr int kTAPitch = kTKC + 8;    // bf16: odd multiples of 16 bytes, so
constexpr int kTBPitch = kCols + 8;   // ldmatrix's row addresses miss each other's banks

inline size_t fwd_mma_smem_bytes() {
  return 2 * (size_t)kTStages * (kTRows * kTAPitch + kTKC * kTBPitch);
}

__global__ void __launch_bounds__(kCols)
head_fwd_mma(const __nv_bfloat16* __restrict__ h,    // (T, N)
             const __nv_bfloat16* __restrict__ Why,  // (N, M)
             const float* __restrict__ by, const int* __restrict__ tgt,
             float* __restrict__ lse, float* __restrict__ partial, int T,
             int N, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int aslot = kTRows * kTAPitch;
  constexpr int slot = aslot + kTKC * kTBPitch;
  __shared__ float rmax[2][kTRows], rsum[2][kTRows], tlog[kTRows], row_bits[kTRows];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int row0 = blockIdx.x * kTRows;

  const auto load_chunk = [&](int ch) {
    __nv_bfloat16* st = ring + (size_t)(ch % kTStages) * slot;
    const int k0 = ch * kTKC;
    for (int e = tid; e < kTRows * (kTKC / 8); e += kCols) {
      const int r = e / (kTKC / 8), p = e % (kTKC / 8);
      const bool in = row0 + r < T;
      cp_async_16(st + r * kTAPitch + p * 8,
                  in ? h + (size_t)(row0 + r) * N + k0 + p * 8 : h, in ? 16 : 0);
    }
    for (int e = tid; e < kTKC * (kCols / 8); e += kCols) {
      const int k = e / (kCols / 8), p = e % (kCols / 8);
      const bool in = p * 8 < M;
      cp_async_16(st + aslot + k * kTBPitch + p * 8,
                  in ? Why + (size_t)(k0 + k) * M + p * 8 : Why, in ? 16 : 0);
    }
  };
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0.0f;
  const int nchunks = N / kTKC;
#pragma unroll
  for (int ch = 0; ch < kTStages - 1; ++ch) {
    if (ch < nchunks) load_chunk(ch);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kTStages - 2>();
    __syncthreads();  // chunk ch is in, and chunk ch - 1's slot is free
    if (ch + kTStages - 1 < nchunks) load_chunk(ch + kTStages - 1);
    cp_async_commit();
    const __nv_bfloat16* st = ring + (size_t)(ch % kTStages) * slot;
#pragma unroll
    for (int ks = 0; ks < kTKC / 16; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, st + (wm * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * kTAPitch +
                         ks * 16 + 8 * (lane / 16));
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        // (k 0-7 | 8-15) x (columns 0-7 | 8-15) of this pair, transposed:
        // b0, b1 of n tile 2 np, then of n tile 2 np + 1
        unsigned bq[4];
        ldmatrix_x4_trans(bq, st + aslot +
                                  (ks * 16 + 8 * ((lane / 8) % 2) + lane % 8) * kTBPitch +
                                  128 * wn + 16 * np + 8 * (lane / 16));
        mma_bf16_16816(acc[2 * np], a, bq);
        mma_bf16_16816(acc[2 * np + 1], a, bq + 2);
      }
    }
  }
  cp_async_wait<0>();

  // logits: + by, columns past M out of the reductions
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 128 * wn + 8 * nt + 2 * q + e;
      const float bm = col < M ? by[col] : 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& v = acc[nt][2 * hh + e];
        v = col < M ? v + bm : -INFINITY;
        mx[hh] = fmaxf(mx[hh], v);
      }
    }
  const int rl[2] = {wm * 16 + g, wm * 16 + g + 8};  // the block's rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int o = 1; o < 4; o *= 2) mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], o));
    if (q == 0) rmax[wn][rl[hh]] = mx[hh];
  }
  __syncthreads();
  float se[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rl[hh];
    mx[hh] = fmaxf(rmax[0][r], rmax[1][r]);
    const int tc = row0 + r < T ? tgt[row0 + r] : -1;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 128 * wn + 8 * nt + 2 * q + e;
        const float v = acc[nt][2 * hh + e];
        if (col < M) se[hh] += expf(v - mx[hh]);
        if (col == tc) tlog[r] = v;
      }
#pragma unroll
    for (int o = 1; o < 4; o *= 2) se[hh] += __shfl_xor_sync(0xffffffffu, se[hh], o);
    if (q == 0) rsum[wn][r] = se[hh];
  }
  __syncthreads();
  if (tid < kTRows) {
    const int row = row0 + tid;
    float bits = 0.0f;
    if (row < T) {
      const float mrow = fmaxf(rmax[0][tid], rmax[1][tid]);
      const float l = mrow + logf(rsum[0][tid] + rsum[1][tid]);
      lse[row] = l;
      bits = l - tlog[tid];
    }
    row_bits[tid] = bits;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int r = 0; r < kTRows; ++r) s += row_bits[r];
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

// The forward: head_fwd_mma when tensor_cores (bf16 only; N a multiple of
// kTKC, M of 8), else head_fwd; then the partials added in block order.
template <typename CT>
int run_fwd(const void* h, const void* Why, const float* by, const int* tgt,
            float* lse, float* partial, float* bits, int T, int N, int M,
            int tensor_cores, cudaStream_t stream, int* launches) {
  int blocks = (T + kRows - 1) / kRows;
  cudaError_t err = cudaSuccess;
  if (tensor_cores) {
    if (sizeof(CT) != 2 || N % kTKC != 0 || M % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = fwd_mma_smem_bytes();
    err = cudaFuncSetAttribute(head_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = (T + kTRows - 1) / kTRows;
    head_fwd_mma<<<blocks, kCols, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(Why),
        by, tgt, lse, partial, T, N, M);
  } else {
    head_fwd<CT><<<blocks, kCols, 0, stream>>>(static_cast<const CT*>(h),
                                               static_cast<const CT*>(Why), by,
                                               tgt, lse, partial, T, N, M);
  }
  err = cudaGetLastError();
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
// fp32; tgt int32. Requires M <= 256. tensor_cores: the tensor-core design
// (bf16, N a multiple of 64, M of 8; ops/head.py:fwd_tensor_cores), else
// the CUDA-core one. Adds its launches to *launches.
extern "C" int head_fwd_launch(int ctype, const void* h, const void* Why,
                               const void* by, const void* tgt, void* lse,
                               void* partial, void* bits, int T, int N, int M,
                               int tensor_cores, void* stream, int* launches) {
  if (M > kCols) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(h, Why, static_cast<const float*>(by),
               static_cast<const int*>(tgt), static_cast<float*>(lse),
               static_cast<float*>(partial), static_cast<float*>(bits), T, N,
               M, tensor_cores, static_cast<cudaStream_t>(stream), launches);
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
