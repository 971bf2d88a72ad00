// The persistent CUDA-core forward under fp32 compute for Hopper (sm_90a):
// the design of K8 and K9 (lstm_tiled_f32.cu), of K1 and K2 (K8's EMBED
// mode and K9's, each with its own residual type and its batch split over
// block rows, through K8's and K9's launchers) and of K15 at D = 1 and at
// D ranks (lstm_tp_f32.cu), one window function with a Step policy, as
// fwd_mma.cuh's bf16 window has; K13's fp32 step (lstm_tp_step_f32.cu)
// runs one step of it in K15's mode, with U streamed, in the same sum
// order. No PyTorch headers. TF32 stays off for fp32 products, so fp32
// keeps the CUDA cores.
//
// K15's mode (TP): the input term is K15's xw stream (fp32, the bias
// folded in), h_seq is stored in fp32 (the param type) whatever the
// residual type, cseq receives c_prev[t] = c_{t-1} (the carry before the
// step's update) in the residual type, the gates' stride is the shard's
// width gs (nd at D ranks) while h and U's rows are N wide, and there is no
// dropout. The Step says where h lives and what ends a step:
// fwd_mma.cuh's GridStep<float> (hc's two halves, the grid barrier: K8,
// K9, K15 at D = 1) or exchange.cuh's RankStep<float> (the exchange
// buffers' slots, the exchange: K15 at D ranks). A block owns kPUnits
// units j0.. and `rows` batch rows b0.. (every row for K8 and K9; K1, K2
// and K15 split the batch over block rows where N / 8 blocks leave SMs
// idle: ops/cuda_cell_tiled.py:f32_split_rows). A row's sums do not depend
// on the rows a block holds, its ring or the width nd (split s sums the k
// with (k mod 32) / 8 = s in ascending k, whatever the layout), so K1's and
// K2's splits give their unsplit bits (a 32-row SP chunk the bits of those
// rows in a 128-row window), K15's D-rank windows give its D = 1 window's
// bits on the unpermuted weights, and a window of K13's fp32 steps gives
// K15's fp32 window bits.
#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"
#include "fwd_mma.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// K8 and K9 under fp32 compute: one persistent cooperative launch a window
// on CUDA cores (tiled_fwd_f32_persist, EMBED for K8;
// ops/cuda_cell_tiled.py:tiled_fwd_f32_plan chooses it): the persistent
// forward's idea (fwd_mma.cuh:fwd_persist) done with FFMAs. What held the
// per-step design back at the flagship's fp32 shapes (S = 256, B = 128,
// N = 1024): 256 launches a window, each with its ramp and tail, a grid of
// 64 blocks on 132 SMs, and every block reading its 512 KB slice of U from
// L2 every step (32 MB of U a step): ~86 us a step on an H100 against ~16
// us of FFMA at the fp32 peak. U in fp32 (16.8 MB) does not fit one block,
// but it fits the SMs' shared memory together.
//
// A block owns kPUnits = 8 hidden units with their four gate columns (N / 8
// blocks: 128 at N = 1024, one an SM) and every batch row, and holds its N x
// 32 slice of U in shared memory for the window ([k][unit][gate], 128 KB at
// N = 1024), read from device memory once. Each step the rows of
// round(h_{t-1}) (fp32, B x N: 512 KB at B = 128) arrive through a
// cp.async.cg ring of KC-column slots, L2 only (other blocks wrote them
// before the grid barrier). The product splits each chunk's k kPSplit ways:
// split s = tid / 64 takes a quarter of the chunk, and its thread (pu, pq) =
// (tid % 4, tid % 64 / 4) a register tile of 2 R rows (pq + 16 i) by 8
// columns (units 2 pu, 2 pu + 1, four gates each): each 4 values of k are 2
// R 16-byte loads of h and 8 of U for 64 R FMAs. Split s takes the k with (k
// mod 32) / 8 = s in every ring layout, so a sum's order does not depend on
// the batch (32 rows or 128 give a row the same bits). On the H100 a shared
// load costs the bytes it hands each lane, broadcast or not: the first
// design of this kernel (4 rows x 4 gates a thread, no split) spent two
// shared cycles per FFMA cycle; 8 x 8 tiles spend one. After the loop the
// splits' partial sums meet in the ring's memory and each owner adds them in
// split order. Thread (u, q) = (tid % 8, tid / 8) owns unit j0 + u of rows q
// + 32 i, i < R (R = 1, 2, 4 for B <= 32, 64, 128) with all four gates, and
// runs the epilogue in its registers: K8's (acc + W_row) + b (the W row
// issued a step ahead, its id two) or K9's acc + xw_t (the xw row issued a
// step ahead), the gates, the cell, the fp32 carry (in registers
// for the window), h_t into the other half of hc, the sequences in RT and
// under dropout the masked stream, as tiled_fwd_step writes them. A grid
// barrier closes each step. What bounds it then: the loop's shared loads, as
// busy as its FMAs, and every block reading all of h from L2 each step (64
// MB over the grid at B = 128). The slice of U always fits where the grid
// does: N / 8 blocks resident at one an SM need N <= 8 x the SMs (1056 on an
// H100), whose slice (132 KB) leaves room for a ring; past that (N = 2048,
// say) the plan refuses and K8 and K9 take the per-step design.
constexpr int kPUnits = 8;
constexpr int kPCols = 4 * kPUnits;   // [unit][gate]
constexpr int kPThreads = 256;
constexpr int kPRowGroups = kPThreads / kPUnits;   // rows q of a thread, q < 32
constexpr int kPSplit = 4;            // ways the product splits a chunk's k
// k of each 32 that a split takes: split s the k with (k mod 32) / 8 = s,
// whatever the ring's slots, so every layout sums in one order
constexpr int kPSplitK = 8;

// Floats of a ring row of KC columns: 4 rows' 16 bytes in distinct banks.
__host__ __device__ constexpr int f32_pitch(int KC) { return KC + 4; }

// Rows a thread owns at batch B: 1, 2 or 4 (B <= 32, 64, 128).
inline int f32_rows_per_thread(int B) { return B <= 32 ? 1 : B <= 64 ? 2 : 4; }

// Dynamic shared memory of a block at batch B and hidden N with a ring of
// `stages` slots of KC columns (mirrored by ops/cuda_cell_tiled.py:
// f32_persist_smem_bytes, which holds itself to tiled_fwd_f32_smem_bytes
// once a card): the slice of U, then the ring, each slot 32 R rows; the
// product splits' partial sums (kPSplit x 32 R rows x kPCols) reuse it.
inline size_t f32_persist_smem_bytes(int B, int N, int KC, int stages) {
  const size_t rows = (size_t)kPRowGroups * f32_rows_per_thread(B);
  const size_t ring = stages * rows * f32_pitch(KC), red = kPSplit * rows * kPCols;
  return sizeof(float) * ((size_t)N * kPCols + (ring > red ? ring : red));
}

template <typename RT, bool EMBED, bool TP, int R, int KC, int STAGES,
          typename Step, typename HT = typename std::conditional<TP, float, RT>::type>
__device__ __forceinline__ void
f32_fwd_window(const Step& step,
               const float* __restrict__ U,     // (N, 4 gs)
               // EMBED: W (M, 4 gs); else the xw stream (S, B, 4 gs)
               const float* __restrict__ W,
               const float* __restrict__ bias,  // (4 gs,), EMBED
               const int* __restrict__ ids,     // (S, B), EMBED
               float* __restrict__ c,      // (B, gs): c0 in, cT out
               float* __restrict__ hT,     // (B, gs)
               HT* __restrict__ hseq,      // (S, B, gs)
               RT* __restrict__ cseq,      // (S, B, gs) or null
               RT* __restrict__ gseq,      // (S, B, 4 gs) or null
               RT* __restrict__ hdrop,     // (S, B, gs) under dropout
               Dropout drop, int S, int B, int N, int gs, int j0, int b0,
               int rows, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = f32_pitch(KC);
  constexpr int RR = 2 * R;                 // product rows of a thread
  static_assert(KC % (kPSplit * kPSplitK) == 0, "a slot holds whole 32-k blocks");
  float* Us = reinterpret_cast<float*>(smem);        // [k][unit][gate]
  float* ring = Us + (size_t)N * kPCols;             // STAGES x [32 R][P]
  float* red = ring;                                 // [split][32 R][kPCols]
  constexpr int slot = kPRowGroups * R * P;
  const int tid = threadIdx.x;
  // the product: split s = tid / 64 takes k s * KQ.. of each chunk;
  // its thread (pu, pq) = (tid % 4, tid % 64 / 4) units 2 pu, 2 pu + 1 of
  // rows pq + 16 i, i < 2R
  const int split = tid / 64, pu = tid % 4, pq = tid % 64 / 4;
  // the epilogue: thread (u, q) = (tid % 8, tid / 8) owns unit j0 + u of
  // rows b0 + q + 32 i, i < R
  const int u = tid % kPUnits, q = tid / kPUnits;
  const int j = j0 + u;
  const int nrows = min(rows, B - b0);      // the block's rows in the batch
  const size_t n4 = 4 * (size_t)gs, bn = (size_t)B * gs;

  // the block's slice of U, once a window: consecutive threads read
  // consecutive units of one gate row
  for (int e = tid; e < N * kPCols; e += kPThreads) {
    const int k = e / kPCols, g = (e / kPUnits) % 4, uu = e % kPUnits;
    Us[k * kPCols + uu * 4 + g] = U[(size_t)k * n4 + (size_t)g * gs + j0 + uu];
  }

  // of the thread's epilogue rows: pin[i][g] the step's input term (K8 its
  // W row, K9 and K15 their xw_t row) and nxt[i][g] the next step's (loaded
  // at the start of the step before, so that the loop hides it), idn[i]
  // K8's id a step further on, cr[i] the carry; bs[g]: K8's bias
  float cr[R], pin[R][4], nxt[R][4], bs[4];
  int idn[R];
  const auto valid = [&](int i) { return q + kPRowGroups * i < nrows; };
  const auto brow = [&](int i) { return b0 + q + kPRowGroups * i; };
  const auto id_of = [&](int t, int i) { return ids[(size_t)t * B + brow(i)]; };
  const auto w_row = [&](int id, float (&dst)[4]) {
    const float* w = W + (size_t)id * n4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) dst[g] = w[(size_t)g * gs];
  };
  const auto xw_row = [&](int t, int i, float (&dst)[4]) {
    const float* x = W + (size_t)t * B * n4 + (size_t)brow(i) * n4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) dst[g] = x[(size_t)g * gs];
  };
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!valid(i)) continue;
    cr[i] = c[(size_t)brow(i) * gs + j];
    if constexpr (EMBED) {
      w_row(id_of(0, i), pin[i]);
      if (S > 1) idn[i] = id_of(1, i);
    } else {
      xw_row(0, i, pin[i]);
    }
  }
  if constexpr (EMBED)
#pragma unroll
    for (int g = 0; g < 4; ++g) bs[g] = bias[(size_t)g * gs + j];
  __syncthreads();  // the slice of U is in

  const int nchunks = N / KC;
  for (int t = 0; t < S; ++t) {
    const float* hin = step.hin(t);
    if (t + 1 < S)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!valid(i)) continue;
        if constexpr (EMBED) {
          w_row(idn[i], nxt[i]);
          if (t + 2 < S) idn[i] = id_of(t + 2, i);
        } else {
          xw_row(t + 1, i, nxt[i]);
        }
      }
    // chunk ch: columns ch * KC.. of the block's rows of h (other blocks
    // wrote them before the step's barrier or exchange: L2 only)
    const auto load_chunk = [&](int ch) {
      float* st = ring + (size_t)(ch % STAGES) * slot;
      for (int e = tid; e < nrows * (KC / 4); e += kPThreads) {
        const int r = e / (KC / 4), p = e % (KC / 4);
        cp_async_16(st + r * P + 4 * p, hin + (size_t)(b0 + r) * N + ch * KC + 4 * p, 16);
      }
    };
    // acc[i][x]: row pq + 16 i, unit 2 pu + x / 4, gate x % 4
    float acc[RR][8];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[i][x] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < STAGES - 1; ++ch) {
      if (ch < nchunks) load_chunk(ch);
      cp_async_commit();
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk ch is in, and chunk ch - 1's slot is free
      if (ch + STAGES - 1 < nchunks) load_chunk(ch + STAGES - 1);
      cp_async_commit();
      const float* hs = ring + (size_t)(ch % STAGES) * slot + pq * P + split * kPSplitK;
      const float* ub = Us + ((size_t)ch * KC + split * kPSplitK) * kPCols + 8 * pu;
#pragma unroll
      for (int kb = 0; kb < KC; kb += kPSplit * kPSplitK)
#pragma unroll
      for (int kk = kb; kk < kb + kPSplitK; kk += 4) {
        float4 hv[RR];
#pragma unroll
        for (int i = 0; i < RR; ++i)
          hv[i] = *reinterpret_cast<const float4*>(hs + i * (kPRowGroups / 2) * P + kk);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 w0 = *reinterpret_cast<const float4*>(ub + (kk + v) * kPCols);
          const float4 w1 = *reinterpret_cast<const float4*>(ub + (kk + v) * kPCols + 4);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < RR; ++i) {
            const float x = v == 0 ? hv[i].x : v == 1 ? hv[i].y : v == 2 ? hv[i].z : hv[i].w;
#pragma unroll
            for (int y = 0; y < 8; ++y) acc[i][y] = fmaf(x, wv[y], acc[i][y]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: reuse it as red
    // the splits' partial sums meet in shared memory, added in split order
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      float* dst = red + ((size_t)split * kPRowGroups * R + pq + 16 * i) * kPCols + 8 * pu;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!valid(i)) continue;
      const int r = q + kPRowGroups * i, b = b0 + r;
      constexpr size_t sp = (size_t)kPRowGroups * R * kPCols;   // a split's partials
      float4 v[kPSplit];
#pragma unroll
      for (int x = 0; x < kPSplit; ++x)
        v[x] = *reinterpret_cast<const float4*>(red + x * sp + (size_t)r * kPCols + 4 * u);
      const float sums[4] = {((v[0].x + v[1].x) + v[2].x) + v[3].x,
                             ((v[0].y + v[1].y) + v[2].y) + v[3].y,
                             ((v[0].z + v[1].z) + v[2].z) + v[3].z,
                             ((v[0].w + v[1].w) + v[2].w) + v[3].w};
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        // K8: (acc + W_row) + b; K9 and K15: acc + xw_t, as tiled_fwd_step
        // and K15's other designs sum
        float s = sums[g] + pin[i][g];
        if constexpr (EMBED) s += bs[g];
        gate[g] = g < 3 ? sigmoid(s) : tanhf(s);
      }
      const size_t idx = (size_t)b * gs + j, ts = (size_t)t * bn;
      if (TP && cseq != nullptr) cseq[ts + idx] = from_f32<RT>(cr[i]);
      float h, cc;
      cell(gate, cr[i], standard, &h, &cc);
      cr[i] = cc;
      step.put(t, b, j, h);
      hseq[ts + idx] = from_f32<HT>(h);
      if (!TP && drop.on)
        hdrop[ts + idx] = from_f32<RT>(keep_bit(drop, t, idx) ? h * drop.inv : 0.0f);
      if (!TP && cseq != nullptr) cseq[ts + idx] = from_f32<RT>(cc);
      if (gseq != nullptr)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gseq[4 * ts + (size_t)b * n4 + (size_t)g * gs + j] = from_f32<RT>(gate[g]);
      if (t == S - 1) {
        hT[idx] = h;
        c[idx] = cc;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) pin[i][g] = nxt[i][g];
    // every block reaches it every step but the last
    if (t + 1 < S) step.sync(t);
  }
}

// K8, K9 and K15 at D = 1: the window over the grid (N / kPUnits, ceil(B /
// rows)), each block kPUnits units of every gate and `rows` batch rows.
template <typename RT, bool EMBED, bool TP, int R, int KC, int STAGES,
          typename HT = typename std::conditional<TP, float, RT>::type>
__global__ void __launch_bounds__(kPThreads, 1)
tiled_fwd_f32_persist(const float* __restrict__ U,     // (N, 4N)
                      // EMBED: W (M, 4N); else the xw stream (S, B, 4N)
                      const float* __restrict__ W,
                      const float* __restrict__ bias,  // (4N,), EMBED
                      const int* __restrict__ ids,     // (S, B), EMBED
                      // (2, B, N) h: written and read within the launch,
                      // so neither const nor __restrict__ (no non-coherent loads)
                      float* hc,
                      float* __restrict__ c,      // (B, N): c0 in, cT out
                      float* __restrict__ hT,     // (B, N)
                      HT* __restrict__ hseq,      // (S, B, N)
                      RT* __restrict__ cseq,      // (S, B, N) or null
                      RT* __restrict__ gseq,      // (S, B, 4N) or null
                      RT* __restrict__ hdrop,     // (S, B, N) under dropout
                      Dropout drop, int S, int B, int N, int rows, int standard) {
  f32_fwd_window<RT, EMBED, TP, R, KC, STAGES>(
      GridStep<float>{hc, (size_t)B * N, N}, U, W, bias, ids, c, hT, hseq, cseq, gseq,
      hdrop, drop, S, B, N, N, blockIdx.x * kPUnits, blockIdx.y * rows, rows,
      standard);
}

// One cooperative launch of tiled_fwd_f32_persist<RT, EMBED, TP, R, KC,
// STAGES> on `stream`, `rows` batch rows a block (B: one block row), R the
// rows a thread owns at `rows`, W K9's or K15's xw stream where !EMBED.
// Returns 0 and adds the launch to *launches, or the error (the grid must
// be resident at once, or its barrier never opens).
template <typename RT, bool EMBED, bool TP, int R, int KC, int STAGES>
int run_fwd_f32(const void* U, const void* W, const float* bias, const int* ids,
                void* hc, float* c, float* hT, void* hseq, void* cseq, void* gseq,
                void* hdrop, Dropout drop, int S, int B, int N, int rows,
                int standard, cudaStream_t stream, int* launches) {
  if (N % KC != 0 || rows < 1 || rows > kPRowGroups * R)
    return static_cast<int>(cudaErrorInvalidValue);
  using HT = typename std::conditional<TP, float, RT>::type;
  const auto kernel = tiled_fwd_f32_persist<RT, EMBED, TP, R, KC, STAGES>;
  const size_t smem = f32_persist_smem_bytes(rows, N, KC, STAGES);
  const dim3 grid(N / kPUnits, (B + rows - 1) / rows);
  const int fits = cooperative_fits(reinterpret_cast<const void*>(kernel),
                                    kPThreads, smem, grid.x * grid.y);
  if (fits != 0) return fits;
  const float* u = static_cast<const float*>(U);
  const float* w = static_cast<const float*>(W);
  float* h = static_cast<float*>(hc);
  HT* hs = static_cast<HT*>(hseq);
  RT* cs = static_cast<RT*>(cseq);
  RT* gs = static_cast<RT*>(gseq);
  RT* hd = static_cast<RT*>(hdrop);
  void* args[] = {&u, &w, &bias, &ids, &h, &c, &hT, &hs, &cs, &gs, &hd,
                  &drop, &S, &B, &N, &rows, &standard};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(kPThreads), args,
      smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

// The ring layouts the library is built for: (rows a thread, KC, stages),
// as ops/cuda_cell_tiled.py:F32_RINGS lists them.
#define F32_LAYOUTS(X) X(1, 128, 4) X(1, 32, 3) X(2, 64, 4) X(2, 32, 3) \
  X(4, 64, 2) X(4, 32, 3)

}  // namespace
