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
// (TF32 stays off) takes the CUDA-core design (head_fwd_core): the same
// 64-row blocks and ring, 8 x 8 register tiles of FFMAs. Either way the
// block's bits go to a per-block partial that a second launch adds in
// block order, so the total has a fixed order. The first design, for
// both types, was one thread a vocabulary column in 32-row blocks.
//
// The backward's first design was like it (0.74 ms at the bench
// shapes in either type, PERF.md): 32-row blocks that recomputed the
// logits against all of Why and read all of a Why^T copy again for dh
// (~200 MB of L2 reads for a 26 MB function), dlog through an fp32 (T, M)
// scratch, and dWhy, dby from CUDA-core reductions, 5 launches. Now both
// of its designs take 64-row blocks and keep dlog in registers: under bf16
// compute head_bwd_mma (tensor cores for the logits, dh and, through
// mma.cuh's atb_mma, dWhy; no fp32 scratch, no Why^T copy), elsewhere
// head_bwd_core (CUDA cores, 8 x 8 register tiles). The TPU kernel
// accumulates dWhy and dby in VMEM across its sequential grid; Hopper
// blocks run in no order, so each block writes its column sums of dlog to
// a row of parts that a second launch adds in block order (dby), and dWhy
// is a product over the rows, split and summed in a fixed order.
// Deterministic throughout.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTRows = 64;  // token rows per block
constexpr int kCols = 256;  // threads per block = the largest vocabulary
constexpr float kInvLn2 = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The forward on CUDA cores (head_fwd_core): fp32 compute (TF32 stays off),
// and bf16 where head_fwd_mma does not apply (ops/head.py:fwd_tensor_cores).
// What held the first design back on this card (one thread a column in
// 32-row blocks): each of its 400 blocks at the bench's shapes read all of
// Why from L2 (~205 MB in fp32 for a 13 MB function), h was staged in turns
// with no copy in flight while it multiplied, and each FMA took a shared
// load (~20 % of the fp32 peak; 0.2548 ms against this design's 0.1320 in
// one call, PERF.md). Here a block owns kTRows = 64 token rows (half the
// Why reads) and all M <= 256 columns. N is walked kHK values at a time:
// the rows' h chunk (64 x kHK, [row][k] with a pitch of kHK + one 16-byte
// copy) and Why's (kHK x 256, columns past M zero-filled) arrive by
// cp.async in a ring of kHStages slots, the next chunk in flight while one
// is multiplied. The 8 warps form a 2 x 4 grid of 32-row by 64-column warp
// tiles, and lane (lr, lc) = (lane / 8, lane % 8) a register tile of 8 rows
// (lr + 4 i of the warp's) by 8 columns (4 lc .. and 32 + 4 lc .. of the
// warp's): each pair of k is 8 loads of h (the 4 lr of a warp on
// neighbouring rows, banks apart through the pitch) and 4 16-byte loads of
// Why (8 lc, the rest broadcast) for 128 FMAs. On the H100 a shared load
// costs the bytes it hands each lane, broadcast or not, so 8 x 8 tiles (4
// FMAs a word) keep the shared path as busy as the FMA pipe (16 x 8 tiles,
// at 255 registers, were tried and were no faster). Two blocks fit an SM (128 registers, no spills): the bench's
// 200 blocks (T = 12800) run as one wave of 264 slots, the flagship's 512
// (T = 32768) as two. The logits stay in the register tiles: each row's
// max and sum of exp over its 8 lanes by shuffles, then over the 4 warp
// columns through shared memory; the target logit from the one thread that
// holds it; lse and the row bits from 64 threads, the bits added in row
// order into the block's partial, which sum_in_order adds in block order.
// Sums over k run in order. The wrapper pads N and Why's rows to a multiple
// of 8 with zeros where they are not (16-byte copies); ldm is Why's pitch.
constexpr int kHK = 32;       // k values a ring slot
constexpr int kHStages = 2;   // ring slots

// Values of a ring slot's h row: kHK and one 16-byte copy of padding.
template <typename CT>
__host__ __device__ constexpr int fwd_core_pitch() { return kHK + 16 / (int)sizeof(CT); }

template <typename CT>
inline size_t fwd_core_smem_bytes() {
  return sizeof(CT) * (size_t)kHStages * (kTRows * fwd_core_pitch<CT>() + kHK * kCols);
}

// Two consecutive values of CT at p, and four, widened to fp32.
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* v) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(x);
  v[1] = __high2float(x);
}
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}

// grid = ceil(T / kTRows), block = kCols; lse (T,), partial (grid,) bits.
// N and ldm multiples of 8; M <= ldm.
template <typename CT>
__global__ void __launch_bounds__(kCols, 2)
head_fwd_core(const CT* __restrict__ h,    // (T, N)
              const CT* __restrict__ Why,  // (N, ldm)
              const float* __restrict__ by, const int* __restrict__ tgt,
              float* __restrict__ lse, float* __restrict__ partial, int T,
              int N, int M, int ldm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rmax[4][kTRows], rsum[4][kTRows], tlog[kTRows], row_bits[kTRows];
  CT* ring = reinterpret_cast<CT*>(smem);
  constexpr int RPT = 8;                        // rows of a thread's tile
  constexpr int V = 16 / (int)sizeof(CT);       // values of a 16-byte copy
  constexpr int HP = fwd_core_pitch<CT>();
  constexpr int hslot = kTRows * HP;            // values of a slot's h chunk
  constexpr int slot = hslot + kHK * kCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lr = lane / 8, lc = lane % 8, wr = warp / 4, wc = warp % 4;
  const int rbase = 4 * RPT * wr + lr;          // the block's row of i = 0
  const int cbase = 64 * wc + 4 * lc;           // the column of b = 0
  const int row0 = blockIdx.x * kTRows;

  // chunk ch: h's columns ch * kHK.. of the block's rows (rows past T and
  // k past N zero-filled) and the same rows of Why
  const auto load_chunk = [&](int ch) {
    CT* st = ring + (size_t)(ch % kHStages) * slot;
    const int k0 = ch * kHK;
    for (int e = tid; e < kTRows * (kHK / V); e += kCols) {
      const int r = e / (kHK / V), k = k0 + (e % (kHK / V)) * V;
      const bool in = row0 + r < T && k < N;
      cp_async_16(st + r * HP + k - k0, in ? h + (size_t)(row0 + r) * N + k : h,
                  in ? 16 : 0);
    }
    for (int e = tid; e < kHK * (kCols / V); e += kCols) {
      const int kk = e / (kCols / V), col = (e % (kCols / V)) * V;
      const bool in = k0 + kk < N && col < M;
      cp_async_16(st + hslot + kk * kCols + col,
                  in ? Why + (size_t)(k0 + kk) * ldm + col : Why, in ? 16 : 0);
    }
  };

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[i][b] = 0.0f;
  const int nchunks = (N + kHK - 1) / kHK;
#pragma unroll
  for (int ch = 0; ch < kHStages - 1; ++ch) {
    if (ch < nchunks) load_chunk(ch);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();  // chunk ch is in, and chunk ch - 1's slot is free
    if (ch + kHStages - 1 < nchunks) load_chunk(ch + kHStages - 1);
    cp_async_commit();
    const CT* hs = ring + (size_t)(ch % kHStages) * slot + rbase * HP;
    const CT* ws = ring + (size_t)(ch % kHStages) * slot + hslot + cbase;
#pragma unroll
    for (int kk = 0; kk < kHK; kk += 2) {
      float hv[RPT][2], wv[2][8];
#pragma unroll
      for (int i = 0; i < RPT; ++i) load2(hs + 4 * i * HP + kk, hv[i]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        load4(ws + (kk + j) * kCols, wv[j]);
        load4(ws + (kk + j) * kCols + 32, wv[j] + 4);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[i][b] = fmaf(hv[i][j], wv[j][b], acc[i][b]);
    }
  }
  cp_async_wait<0>();

  // the logits: + by, columns past M out of the reductions
  const auto colof = [&](int b) { return cbase + (b / 4) * 32 + b % 4; };
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const float bm = colof(b) < M ? by[colof(b)] : 0.0f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i][b] = colof(b) < M ? acc[i][b] + bm : -INFINITY;
  }
  // each row's max over the thread's columns, its 8 lanes, then the 4
  // warp columns; the target's logit from the thread that holds it
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rbase + 4 * i;
    float mx = acc[i][0];
#pragma unroll
    for (int b = 1; b < 8; ++b) mx = fmaxf(mx, acc[i][b]);
#pragma unroll
    for (int o = 1; o < 8; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lc == 0) rmax[wc][r] = mx;
    const int tc = row0 + r < T ? tgt[row0 + r] : -1;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (colof(b) == tc) tlog[r] = acc[i][b];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rbase + 4 * i;
    const float mx = fmaxf(fmaxf(rmax[0][r], rmax[1][r]), fmaxf(rmax[2][r], rmax[3][r]));
    float se = 0.0f;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (colof(b) < M) se += expf(acc[i][b] - mx);
#pragma unroll
    for (int o = 1; o < 8; o *= 2) se += __shfl_xor_sync(0xffffffffu, se, o);
    if (lc == 0) rsum[wc][r] = se;
  }
  __syncthreads();
  if (tid < kTRows) {
    const int row = row0 + tid;
    float bits = 0.0f;
    if (row < T) {
      const float mx = fmaxf(fmaxf(rmax[0][tid], rmax[1][tid]), fmaxf(rmax[2][tid], rmax[3][tid]));
      const float l = mx + logf(((rsum[0][tid] + rsum[1][tid]) + rsum[2][tid]) + rsum[3][tid]);
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
constexpr int kTKC = 64;
constexpr int kTStages = 2;
constexpr int kTAPitch = kTKC + 8;    // bf16: odd multiples of 16 bytes, so
constexpr int kTBPitch = kCols + 8;   // ldmatrix's row addresses miss each other's banks

inline size_t fwd_mma_smem_bytes() {
  return 2 * (size_t)kTStages * (kTRows * kTAPitch + kTKC * kTBPitch);
}

// The logits of the block's kTRows token rows on tensor cores, without by,
// into the C fragments acc of warp (wm, wn) as above: the main loop of
// head_fwd_mma and of the backward's head_bwd_mma. Returns when every copy
// has landed; the caller syncs before it reuses the ring.
__device__ __forceinline__ void logits_mma(const __nv_bfloat16* __restrict__ h,
                                           const __nv_bfloat16* __restrict__ Why,
                                           int row0, int T, int N, int M,
                                           __nv_bfloat16* ring, float (&acc)[16][4]) {
  constexpr int aslot = kTRows * kTAPitch;
  constexpr int slot = aslot + kTKC * kTBPitch;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;

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
}

__global__ void __launch_bounds__(kCols)
head_fwd_mma(const __nv_bfloat16* __restrict__ h,    // (T, N)
             const __nv_bfloat16* __restrict__ Why,  // (N, M)
             const float* __restrict__ by, const int* __restrict__ tgt,
             float* __restrict__ lse, float* __restrict__ partial, int T,
             int N, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rmax[2][kTRows], rsum[2][kTRows], tlog[kTRows], row_bits[kTRows];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int row0 = blockIdx.x * kTRows;
  float acc[16][4];
  logits_mma(h, Why, row0, T, N, M, reinterpret_cast<__nv_bfloat16*>(smem), acc);

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

// ---------------------------------------------------------------------------
// The backward under bf16 compute on tensor cores (head_bwd_mma). A block
// owns kTRows = 64 token rows and first runs head_fwd_mma's main loop
// (logits_mma), so the logits lie in its warps' C fragments. In registers:
// dlog = (exp(logit + by - lse) - onehot) * cot / ln 2 in fp32. The block's
// column sums of that fp32 dlog (rows g and g + 8 of a lane, over the eight
// g of a warp by shuffles, then over the four m tiles in order) go to its
// row of `parts`, which sum_slabs adds in block order into dby. dlog rounded
// to bf16 goes to shared memory (64 x M) and to the (T, M) bf16 buffer that
// the dWhy product reads. Then dh = round(dlog) @ Why^T on mma.sync over N
// in chunks of kDN: Why's rows (N, M), the [n][k] layout of B, stream
// through a second ring of kDStages slots by cp.async (the first chunk's
// copies issued before the epilogue), each warp a 16-row m tile by 32
// columns of the chunk; dh is stored in bf16. dWhy = h^T round(dlog) is
// mma.cuh's atb_mma over the bf16 buffer (run_bwd). No fp32 (T, M) scratch
// and no Why^T copy.
constexpr int kDN = 64;              // Why rows (dh columns) a chunk
constexpr int kDStages = 2;
constexpr int kDPitch = kCols + 8;   // bf16 rows of the dlog tile and of Why

inline size_t bwd_mma_smem_bytes() {
  const size_t dh = 2 * (size_t)(kTRows + kDStages * kDN) * kDPitch;
  const size_t fwd = fwd_mma_smem_bytes();
  return dh > fwd ? dh : fwd;
}

// grid = ceil(T / kTRows), block = kCols; dlog (T, M), dh (T, N) bf16,
// parts (grid, M) fp32. N a multiple of kDN, M of 16 and at most kCols.
__global__ void __launch_bounds__(kCols)
head_bwd_mma(const __nv_bfloat16* __restrict__ h,    // (T, N)
             const __nv_bfloat16* __restrict__ Why,  // (N, M)
             const float* __restrict__ by, const int* __restrict__ tgt,
             const float* __restrict__ lse, const float* __restrict__ cot,
             __nv_bfloat16* __restrict__ dlog, __nv_bfloat16* __restrict__ dh,
             float* __restrict__ parts, int T, int N, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float csum[4][kCols];  // each m tile's column sums
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int row0 = blockIdx.x * kTRows;
  float acc[16][4];
  logits_mma(h, Why, row0, T, N, M, ring, acc);
  __syncthreads();  // every warp is done with the ring

  __nv_bfloat16* dls = ring;                                // [kTRows][kDPitch]
  __nv_bfloat16* wring = ring + (size_t)kTRows * kDPitch;   // kDStages x [kDN][kDPitch]
  const auto load_rows = [&](int c) {
    __nv_bfloat16* st = wring + (size_t)(c % kDStages) * kDN * kDPitch;
    for (int e = tid; e < kDN * (M / 8); e += kCols) {
      const int r = e / (M / 8), p = e % (M / 8);
      cp_async_16(st + r * kDPitch + p * 8, Why + (size_t)(c * kDN + r) * M + p * 8, 16);
    }
  };
  load_rows(0);
  cp_async_commit();

  const float scale = cot[0] * kInvLn2;
  const int rl[2] = {wm * 16 + g, wm * 16 + g + 8};  // the block's rows
  float lr[2];
  int tr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + rl[hh];
    lr[hh] = row < T ? lse[row] : 0.0f;
    tr[hh] = row < T ? tgt[row] : -1;
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col0 = 128 * wn + 8 * nt + 2 * q;
    float d[2][2];  // [row g | g + 8][column col0 | col0 + 1]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + e;
      const float bm = col < M ? by[col] : 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = 0.0f;
        if (col < M && row0 + rl[hh] < T) {
          const float p = expf(acc[nt][2 * hh + e] + bm - lr[hh]);
          v = (p - (col == tr[hh] ? 1.0f : 0.0f)) * scale;
        }
        d[hh][e] = v;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const unsigned pk = pack_bf16x2(d[hh][0], d[hh][1]);
      *reinterpret_cast<unsigned*>(dls + rl[hh] * kDPitch + col0) = pk;
      if (col0 < M && row0 + rl[hh] < T)
        *reinterpret_cast<unsigned*>(dlog + (size_t)(row0 + rl[hh]) * M + col0) = pk;
    }
    // the m tile's column sums of the fp32 dlog: rows g, g + 8, then over g
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float cs = d[0][e] + d[1][e];
#pragma unroll
      for (int o = 4; o < 32; o *= 2) cs += __shfl_xor_sync(0xffffffffu, cs, o);
      if (g == 0) csum[wm][col0 + e] = cs;
    }
  }
  __syncthreads();
  if (tid < M)
    parts[(size_t)blockIdx.x * M + tid] =
        ((csum[0][tid] + csum[1][tid]) + csum[2][tid]) + csum[3][tid];

  // dh = round(dlog) @ Why^T, kDN columns a chunk
  const int nch = N / kDN;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();  // chunk c is in, dls is written, and chunk c - 1's slot is free
    if (c + kDStages - 1 < nch) load_rows(c + kDStages - 1);
    cp_async_commit();
    const __nv_bfloat16* st = wring + (size_t)(c % kDStages) * kDN * kDPitch;
    float acc2[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc2[nt][x] = 0.0f;
    for (int ks = 0; ks < M / 16; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, dls + (wm * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * kDPitch +
                         ks * 16 + 8 * (lane / 16));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // Why rows (n 0-7 | 8-15) x (k 0-7 | 8-15): b0, b1 of n tile 2 np,
        // then of n tile 2 np + 1
        unsigned bq[4];
        ldmatrix_x4(bq, st + (32 * wn + 16 * np + lane % 8 + 8 * (lane / 16)) * kDPitch +
                            ks * 16 + 8 * ((lane / 8) % 2));
        mma_bf16_16816(acc2[2 * np], a, bq);
        mma_bf16_16816(acc2[2 * np + 1], a, bq + 2);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + rl[hh];
      if (row >= T) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<unsigned*>(dh + (size_t)row * N + c * kDN + 32 * wn + 8 * nt +
                                     2 * q) = pack_bf16x2(acc2[nt][2 * hh], acc2[nt][2 * hh + 1]);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// The backward on CUDA cores (head_bwd_core): fp32 compute (TF32 stays off),
// and bf16 where head_bwd_mma does not apply (ops/head.py:bwd_tensor_cores).
// A block owns kTRows = 64 token rows and all M <= 256 columns; its thread
// (ty, tx) = (warp, lane) a register tile of 8 rows (8 ty ..) by 8 columns
// (4 tx .. and 128 + 4 tx ..). The logits: h (transposed) and Why staged in
// shared memory kCK values of k at a time, each k two broadcast float4 of h
// and two float4 of Why for 64 FMAs. dlog in registers as in head_bwd_mma;
// the block's column sums (each thread's 8 rows in order, then the 8 warps
// in order) go to its row of `parts`; the fp32 dlog goes to the (T, M)
// scratch that atb_gemm reads for dWhy (its staging rounds to the compute
// type) and round(dlog) into shared memory, transposed. Then dh =
// round(dlog) @ Why^T over N in chunks of kCols columns, Why's rows staged
// transposed kCK columns at a time, with the same register tile. Sums run
// over k in order, as in the first design (32-row blocks, one column a
// thread: 0.74 ms at the bench's shapes in either type, PERF.md).
constexpr int kCK = 16;                 // k values staged at a time
constexpr int kCHPitch = kTRows + 4;    // floats: transposed 64-row tiles
constexpr int kCWPitch = kCols + 4;     // floats: staged Why tiles

inline size_t bwd_core_smem_bytes() {
  return sizeof(float) * ((size_t)kCols * kCHPitch + kCK * kCHPitch +
                          kCK * kCWPitch + 8 * kCols);
}

// grid = ceil(T / kTRows), block = kCols; dlog (T, M) fp32, dh (T, N) in
// CT, parts (grid, M) fp32.
template <typename CT>
__global__ void __launch_bounds__(kCols)
head_bwd_core(const CT* __restrict__ h, const CT* __restrict__ Why,
              const float* __restrict__ by, const int* __restrict__ tgt,
              const float* __restrict__ lse, const float* __restrict__ cot,
              float* __restrict__ dlog, CT* __restrict__ dh,
              float* __restrict__ parts, int T, int N, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dlT = reinterpret_cast<float*>(smem);   // [kCols][kCHPitch]
  float* hsT = dlT + kCols * kCHPitch;           // [kCK][kCHPitch]
  float* ws = hsT + kCK * kCHPitch;              // [kCK][kCWPitch]
  float* csum = ws + kCK * kCWPitch;             // [8][kCols]
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int row0 = blockIdx.x * kTRows;
  // the thread's columns: 4 tx .. 4 tx + 3, then 128 + 4 tx ..
  const auto colof = [&](int b) { return (b / 4) * 128 + 4 * tx + b % 4; };
  const auto micro = [&](const float* a, const float* w, float (&acc)[8][8]) {
    const float4 a0 = *reinterpret_cast<const float4*>(a);
    const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
    const float4 w0 = *reinterpret_cast<const float4*>(w + 4 * tx);
    const float4 w1 = *reinterpret_cast<const float4*>(w + 128 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[r][b] = fmaf(av[r], wv[b], acc[r][b]);
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[r][b] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kCK) {
    __syncthreads();
    for (int e = tid; e < kTRows * kCK; e += kCols) {
      const int r = e / kCK, kk = e % kCK;
      const int row = row0 + r, k = k0 + kk;
      hsT[kk * kCHPitch + r] = row < T && k < N ? to_f32(h[(size_t)row * N + k]) : 0.0f;
    }
    for (int e = tid; e < kCK * kCols; e += kCols) {
      const int kk = e / kCols, m = e % kCols, k = k0 + kk;
      ws[kk * kCWPitch + m] = k < N && m < M ? to_f32(Why[(size_t)k * M + m]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kCK; ++kk) micro(hsT + kk * kCHPitch + 8 * ty, ws + kk * kCWPitch, acc);
  }

  const float scale = cot[0] * kInvLn2;
  float bm[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) bm[b] = colof(b) < M ? by[colof(b)] : 0.0f;
  float cs[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) cs[b] = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + 8 * ty + r;
    const float l = row < T ? lse[row] : 0.0f;
    const int tg = row < T ? tgt[row] : -1;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = colof(b);
      float d = 0.0f;
      if (row < T && col < M) {
        const float p = expf(acc[r][b] + bm[b] - l);
        d = (p - (col == tg ? 1.0f : 0.0f)) * scale;
        dlog[(size_t)row * M + col] = d;
      }
      acc[r][b] = d;
      cs[b] += d;
    }
  }
  // round(dlog) into dlT[col][row]; the column sums into csum[ty]
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    float* dst = dlT + colof(b) * kCHPitch + 8 * ty;
    *reinterpret_cast<float4*>(dst) =
        make_float4(round_to<CT>(acc[0][b]), round_to<CT>(acc[1][b]),
                    round_to<CT>(acc[2][b]), round_to<CT>(acc[3][b]));
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(round_to<CT>(acc[4][b]), round_to<CT>(acc[5][b]),
                    round_to<CT>(acc[6][b]), round_to<CT>(acc[7][b]));
    csum[ty * kCols + colof(b)] = cs[b];
  }
  __syncthreads();
  if (tid < M) {
    float v = 0.0f;
    for (int w = 0; w < 8; ++w) v += csum[w * kCols + tid];
    parts[(size_t)blockIdx.x * M + tid] = v;
  }

  // dh = round(dlog) @ Why^T, kCols columns of N a chunk
  for (int n0 = 0; n0 < N; n0 += kCols) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[r][b] = 0.0f;
    for (int k0 = 0; k0 < M; k0 += kCK) {
      __syncthreads();
      for (int e = tid; e < kCols * kCK; e += kCols) {
        const int n = e / kCK, kk = e % kCK, k = k0 + kk;
        ws[kk * kCWPitch + n] =
            n0 + n < N && k < M ? to_f32(Why[(size_t)(n0 + n) * M + k]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kCK; ++kk)
        micro(dlT + (k0 + kk) * kCHPitch + 8 * ty, ws + kk * kCWPitch, acc);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = row0 + 8 * ty + r;
      if (row >= T) continue;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (n0 + colof(b) < N) dh[(size_t)row * N + n0 + colof(b)] = from_f32<CT>(acc[r][b]);
    }
  }
}

// The forward: head_fwd_mma when design is 1 (bf16 only; N a multiple of
// kTKC, M of 8, Why's pitch M), head_fwd_core when 0 (N and ldm multiples
// of 8); then the partials added in block order.
template <typename CT>
int run_fwd(const void* h, const void* Why, const float* by, const int* tgt,
            float* lse, float* partial, float* bits, int T, int N, int M,
            int ldm, int design, cudaStream_t stream, int* launches) {
  int blocks = (T + kTRows - 1) / kTRows;
  cudaError_t err = cudaSuccess;
  if (design == 1) {
    if (sizeof(CT) != 2 || N % kTKC != 0 || M % 8 != 0 || ldm != M)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = fwd_mma_smem_bytes();
    err = cudaFuncSetAttribute(head_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    head_fwd_mma<<<blocks, kCols, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(Why),
        by, tgt, lse, partial, T, N, M);
  } else if (design == 0) {
    if (N % 8 != 0 || ldm % 8 != 0 || ldm < M)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = head_fwd_core<CT>;
    const size_t smem = fwd_core_smem_bytes<CT>();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kCols, smem, stream>>>(
        static_cast<const CT*>(h), static_cast<const CT*>(Why), by, tgt, lse,
        partial, T, N, M, ldm);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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

// The backward: the main pass (head_bwd_mma when tensor_cores: bf16, N a
// multiple of kDN, M of kGT; else head_bwd_core), dby as the block parts'
// sum in block order, then dWhy = h^T round(dlog) (atb_mma over the bf16
// dlog, or atb_gemm over the fp32 dlog), split over r and summed in a fixed
// order where the tiles alone do not fill the card: 3 or 4 launches. dlog
// is (T, M) bf16 with tensor_cores, else fp32; work holds the parts, then
// the product's split.
template <typename CT>
int run_bwd(const void* h, const void* Why, const float* by, const int* tgt,
            const float* lse, const float* cot, void* dlog, void* dh,
            float* dWhy, float* dby, float* work, int T, int N, int M,
            int tensor_cores, cudaStream_t stream, int* launches) {
  const int blocks = (T + kTRows - 1) / kTRows;
  float* parts = work;
  float* split = work + (size_t)blocks * M;
  cudaError_t err = cudaSuccess;
  if (tensor_cores) {
    if (sizeof(CT) != 2 || N % kDN != 0 || M % kGT != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = bwd_mma_smem_bytes();
    err = cudaFuncSetAttribute(head_bwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    head_bwd_mma<<<blocks, kCols, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(Why),
        by, tgt, lse, cot, static_cast<__nv_bfloat16*>(dlog),
        static_cast<__nv_bfloat16*>(dh), parts, T, N, M);
  } else {
    const size_t smem = bwd_core_smem_bytes();
    err = cudaFuncSetAttribute(head_bwd_core<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    head_bwd_core<CT><<<blocks, kCols, smem, stream>>>(
        static_cast<const CT*>(h), static_cast<const CT*>(Why), by, tgt, lse,
        cot, static_cast<float*>(dlog), static_cast<CT*>(dh), parts, T, N, M);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  sum_slabs<<<(M + 255) / 256, 256, 0, stream>>>(parts, dby, blocks, (size_t)M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  if (tensor_cores)
    return run_atb_mma<__nv_bfloat16>(nullptr, 0, nullptr,
                                      static_cast<const __nv_bfloat16*>(h), 0,
                                      static_cast<const __nv_bfloat16*>(dlog), dWhy,
                                      split, T, N, M, stream, launches);
  return run_atb<CT, CT>(nullptr, static_cast<const CT*>(h), 0,
                         static_cast<const float*>(dlog), dWhy, split, T, N, M,
                         stream, launches);
}

}  // namespace

// Scratch floats: the forward's per-block partials, the backward's work.
extern "C" size_t head_fwd_work_floats(int T) { return (T + kTRows - 1) / kTRows; }

extern "C" size_t head_bwd_work_floats(int T, int N, int M) {
  return (size_t)((T + kTRows - 1) / kTRows) * M + atb_work_floats(T, N, M);
}

// Type code 0 = fp32, 1 = bf16: the type of h and Why. by, lse, bits are
// fp32; tgt int32. Requires M <= 256; Why (N, M) with row pitch ldm. design:
// 1 the tensor-core design (bf16, N a multiple of 64, M of 8, ldm = M;
// ops/head.py:fwd_tensor_cores), 0 the CUDA-core one (N and ldm multiples
// of 8). Adds its launches to *launches.
extern "C" int head_fwd_launch(int ctype, const void* h, const void* Why,
                               const void* by, const void* tgt, void* lse,
                               void* partial, void* bits, int T, int N, int M,
                               int ldm, int design, void* stream, int* launches) {
  if (M > kCols) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(h, Why, static_cast<const float*>(by),
               static_cast<const int*>(tgt), static_cast<float*>(lse),
               static_cast<float*>(partial), static_cast<float*>(bits), T, N,
               M, ldm, design, static_cast<cudaStream_t>(stream), launches);
  };
  if (ctype == 0) return f(run_fwd<float>);
  if (ctype == 1) return f(run_fwd<__nv_bfloat16>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// cot: the scalar cotangent of the bits sum, on the device. dh has the
// type of h; dWhy (N, M), dby (M,) are fp32; dlog is a (T, M) scratch, bf16
// with tensor_cores, else fp32. tensor_cores: the tensor-core design (bf16,
// N a multiple of 64, M of 128; ops/head.py:bwd_tensor_cores), else the
// CUDA-core one. Why is (N, M), as the forward takes it.
extern "C" int head_bwd_launch(int ctype, const void* h, const void* Why,
                               const void* by, const void* tgt,
                               const void* lse, const void* cot, void* dlog,
                               void* dh, void* dWhy, void* dby, void* work,
                               int T, int N, int M, int tensor_cores,
                               void* stream, int* launches) {
  if (M > kCols) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(h, Why, static_cast<const float*>(by),
               static_cast<const int*>(tgt), static_cast<const float*>(lse),
               static_cast<const float*>(cot), dlog, dh,
               static_cast<float*>(dWhy), static_cast<float*>(dby),
               static_cast<float*>(work), T, N, M, tensor_cores,
               static_cast<cudaStream_t>(stream), launches);
  };
  if (ctype == 0) return f(run_bwd<float>);
  if (ctype == 1) return f(run_bwd<__nv_bfloat16>);
  return static_cast<int>(cudaErrorInvalidValue);
}
