// The tensor-core forward of the port: the step, shared by the persistent
// forward below (fwd_persist: K8, K9, and under bf16 compute K1, K2 and, at
// D = 1, K15; its window at D ranks is lstm_tp_persist.cu's
// tp_seq_fwd_persist_x) and the tensor-core K13 of lstm_tp.cu
// (tp_step_fwd_mma): one block's product of a step,
//
//   acc = round(h)[b0 .. b0 + rows) @ U[:, the block's 4 x kFUnits columns]
//
// with h (B, K) and U (K, 4 gs) in bf16, and the loads of its input term.
// A block owns kFUnits = 16 hidden units j0.. with their four gate columns
// gate * gs + j0 + u (gs: the gate stride, N for the persistent forward,
// the shard width nd for K13) and `rows` batch rows b0.. (rows past B
// zero-filled, their results dropped). Its slice of U is stored
// [k][gate][unit]: the first kres rows may sit in shared memory (the
// persistent design holds them for a window), the rest stream through the
// ring beside the round(h) chunks.
// Each chunk of kFKC k rows arrives by cp.async (L2 only: in the persistent
// design other blocks wrote h before the grid barrier) into a ring of
// kFStages slots. The 8 warps form a WM x WK grid: warp (wm, wk) takes the
// 16-row m tile wm and the k steps s (of 16) with s % WK == wk; WM = 8 at
// 128 rows (no k split), 1 at 16 (the k axis split 8 ways, the partial sums
// added in warp order through shared memory). Products are mma.sync
// m16n8k16, bf16 in, fp32 sums; with the [gate][unit] columns the C
// fragment's n tile 2 * gate + unit / 8 gives lane (g, q) all four gates of
// rows g, g + 8 and units 2q, 2q + 1, 8 + 2q, 9 + 2q, so the caller's
// epilogue runs in the registers of the wk = 0 warps (the owners):
// acc[2 gate + uh][2 hh + e] is the sum of row fwd_row(hh), unit
// fwd_unit(uh, e).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kFUnits = 16;
constexpr int kFCols = 4 * kFUnits;       // [gate][unit]
constexpr int kFThreads = 256;
constexpr int kFWarps = kFThreads / 32;
constexpr int kFMaxRows = 16 * kFWarps;   // one m tile a warp
constexpr int kFKC = 64;                  // k rows of a chunk
constexpr int kFStages = 3;
// bf16 of padding per shared row: rows of an odd number of 16-byte units,
// so the eight row addresses of an ldmatrix fall in distinct banks
constexpr int kFPad = 8;
constexpr int kFUPitch = kFCols + kFPad;
constexpr int kFAPitch = kFKC + kFPad;

// Warp rows of the WM x WK grid: the fewest powers of two that cover the
// m tiles of `rows` batch rows.
inline __host__ __device__ int fwd_warp_rows(int rows) {
  const int mt = (rows + 15) / 16;
  return mt <= 1 ? 1 : mt <= 2 ? 2 : mt <= 4 ? 4 : 8;
}

// Dynamic shared memory of a block of `rows` batch rows holding kres rows
// of its U slice (mirrored by ops/cuda_cell_tiled.py:persist_smem_bytes,
// which holds itself to tiled_fwd_persist_smem_bytes once a card): the
// kres rows, then the ring, each slot an h chunk of the m tiles' rows and a
// U chunk; the cross-warp partial sums (one 32 x 32 float tile a warp)
// reuse the ring.
inline size_t fwd_smem_bytes(int rows, int kres) {
  const size_t slot = 2 * ((size_t)(rows + 15) / 16 * 16 * kFAPitch +
                           (size_t)kFKC * kFUPitch);
  const size_t red = fwd_warp_rows(rows) < kFWarps ? (size_t)kFWarps * 32 * 32 * 4 : 0;
  const size_t ring = kFStages * slot > red ? kFStages * slot : red;
  return 2 * (size_t)kres * kFUPitch + ring;
}

// One block's place in the step.
struct FwdTile {
  int K;       // the contraction: h's width, U's rows
  int gs;      // the gate stride of U's columns and of the input term
  int j0;      // the block's first unit
  int b0, B;   // its first batch row; rows at or past B are not real
  int mtiles, WM, WK;
  int aslot, slot;   // bf16 of a ring slot's h chunk, of a slot
  int lane, warp, wm, wk, g, q;
  bool owner;  // runs the epilogue: wk == 0 with an m tile of its own
};

__device__ __forceinline__ FwdTile fwd_mma_tile(int K, int gs, int j0, int b0,
                                                int B, int rows) {
  FwdTile f;
  f.K = K;
  f.gs = gs;
  f.j0 = j0;
  f.b0 = b0;
  f.B = B;
  f.mtiles = (rows + 15) / 16;
  f.WM = fwd_warp_rows(rows);
  f.WK = kFWarps / f.WM;
  f.aslot = 16 * f.mtiles * kFAPitch;
  f.slot = f.aslot + kFKC * kFUPitch;
  f.lane = threadIdx.x % 32;
  f.warp = threadIdx.x / 32;
  f.wm = f.warp % f.WM;
  f.wk = f.warp / f.WM;
  f.g = f.lane / 4;
  f.q = f.lane % 4;
  f.owner = f.wk == 0 && f.wm < f.mtiles;
  return f;
}

// The batch row of the owner lane's fragment half hh, and the unit of its
// pair uh, element e.
__device__ __forceinline__ int fwd_row(const FwdTile& f, int hh) {
  return f.b0 + 16 * f.wm + f.g + 8 * hh;
}
__device__ __forceinline__ int fwd_unit(const FwdTile& f, int uh, int e) {
  return f.j0 + 8 * uh + 2 * f.q + e;
}

// The block's 64 columns of U's row k into dst, 16 bytes a copy p < 8.
__device__ __forceinline__ void fwd_u_copy(const FwdTile& f,
                                           const __nv_bfloat16* U,
                                           __nv_bfloat16* dst, int k, int p) {
  const int gate = p / 2, half = p % 2;
  cp_async_16(dst + gate * kFUnits + half * 8,
              U + (size_t)k * 4 * f.gs + (size_t)gate * f.gs + f.j0 + half * 8, 16);
}

template <typename XT>
__device__ __forceinline__ void load_pair(const XT* p, float* lo, float* hi);
template <>
__device__ __forceinline__ void load_pair<__nv_bfloat16>(const __nv_bfloat16* p,
                                                         float* lo, float* hi) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  *lo = __low2float(v);
  *hi = __high2float(v);
}
template <>
__device__ __forceinline__ void load_pair<float>(const float* p, float* lo,
                                                 float* hi) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  *lo = v.x;
  *hi = v.y;
}

// The owner lane's input term, widened to fp32: pin[4 hh + 2 uh + e][gate]
// of row fwd_row(hh), unit fwd_unit(uh, e), read from row src(b) of an
// input of type XT with the gate stride gs.
template <typename XT, typename Src>
__device__ __forceinline__ void fwd_inputs(const FwdTile& f, Src src,
                                           float (&pin)[8][4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int b = fwd_row(f, hh);
    if (b >= f.B) continue;
    const XT* row = src(b);
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int uh = 0; uh < 2; ++uh)
        load_pair<XT>(row + (size_t)gate * f.gs + f.j0 + 8 * uh + 2 * f.q,
                      &pin[4 * hh + 2 * uh][gate], &pin[4 * hh + 2 * uh + 1][gate]);
  }
}

// The step's product for the block (module comment), summed in the owner
// lanes' acc: h (B, K), its rows read from L2; the first cres chunks of U
// from Us (kres = cres * kFKC rows, [k][gate][unit] with pitch kFUPitch),
// the rest through the ring. Every thread of the block calls it; on return
// the ring may be reused.
__device__ __forceinline__ void fwd_products(const FwdTile& f,
                                             const __nv_bfloat16* U,
                                             const __nv_bfloat16* h,
                                             const __nv_bfloat16* Us, int cres,
                                             __nv_bfloat16* ring,
                                             float (&acc)[8][4]) {
  const int tid = threadIdx.x, lane = f.lane;
  const int rows = 16 * f.mtiles, nchunks = f.K / kFKC;
  // chunk ch: h's columns ch * kFKC.. for the m tiles' rows (rows past B
  // zero-filled), and the U rows when they are not resident
  const auto load_chunk = [&](int ch) {
    __nv_bfloat16* st = ring + (size_t)(ch % kFStages) * f.slot;
    for (int e = tid; e < rows * 8; e += kFThreads) {
      const int r = e / 8, p = e % 8;
      const bool in = f.b0 + r < f.B;
      cp_async_16(st + r * kFAPitch + p * 8,
                  in ? h + (size_t)(f.b0 + r) * f.K + ch * kFKC + p * 8 : h,
                  in ? 16 : 0);
    }
    if (ch >= cres)
      for (int e = tid; e < kFKC * 8; e += kFThreads)
        fwd_u_copy(f, U, st + f.aslot + (e / 8) * kFUPitch, ch * kFKC + e / 8, e % 8);
  };
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0.0f;
#pragma unroll
  for (int ch = 0; ch < kFStages - 1; ++ch) {
    if (ch < nchunks) load_chunk(ch);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // chunk ch is in, and chunk ch - 1's slot is free
    if (ch + kFStages - 1 < nchunks) load_chunk(ch + kFStages - 1);
    cp_async_commit();
    if (f.wm >= f.mtiles) continue;
    const __nv_bfloat16* st = ring + (size_t)(ch % kFStages) * f.slot;
    const __nv_bfloat16* ub =
        ch < cres ? Us + (size_t)ch * kFKC * kFUPitch : st + f.aslot;
#pragma unroll
    for (int ks = 0; ks < kFKC / 16; ++ks) {
      if ((ch * (kFKC / 16) + ks) % f.WK != f.wk) continue;
      unsigned a[4];
      ldmatrix_x4(a, st + (f.wm * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * kFAPitch +
                         ks * 16 + 8 * (lane / 16));
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        // (k 0-7 | 8-15) x (units 0-7 | 8-15) of this gate, transposed:
        // b0, b1 of n tile 2 gate, then of n tile 2 gate + 1
        unsigned bq[4];
        ldmatrix_x4_trans(bq, ub + (ks * 16 + 8 * ((lane / 8) % 2) + lane % 8) * kFUPitch +
                                  gate * kFUnits + 8 * (lane / 16));
        mma_bf16_16816(acc[2 * gate], a, bq);
        mma_bf16_16816(acc[2 * gate + 1], a, bq + 2);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it as red
  if (f.WK > 1) {
    float* red = reinterpret_cast<float*>(ring);
    if (f.wk > 0 && f.wm < f.mtiles)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          red[((size_t)f.warp * 32 + 4 * nt + x) * 32 + lane] = acc[nt][x];
    __syncthreads();
    if (f.owner)
      for (int k = 1; k < f.WK; ++k)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc[nt][x] += red[((size_t)(f.wm + k * f.WM) * 32 + 4 * nt + x) * 32 + lane];
  }
}

// ---------------------------------------------------------------------------
// The persistent forward: one cooperative launch for the S steps of a window
// (bf16 compute; ops/cuda_cell_tiled.py:fwd_layout chooses it and its
// layout). Each step is the tensor-core step above with the gate stride N.
// The grid is (N / kFUnits) x ceil(B / rows) blocks, at most what is
// resident: a block owns 16 hidden units and `rows` batch rows (all B for
// K8, K9 and K2; fewer for K1 and K15 where N / 16 blocks would leave most
// SMs idle: ops/cuda_cell_tiled.py:split_rows); as many rows of its N x 64
// slice of U as fit beside the ring stay in shared memory for the window,
// the rest stream every step with the block's rows of round(h_{t-1})
// through the ring. The epilogue runs in the owners' registers: the W-row
// gather and the bias (EMBED) or the input stream (loaded for step t + 1
// before the barrier that precedes it), the gates, the cell, the carry c
// (in registers for the whole window), round(h_t) into the other half of
// hc. A grid barrier closes each step.
//
// Two sets of streams. K8, K9, K1 and K2 (TP false): the input stream xw
// in bf16, the sum (acc + W_row) + b or acc + xw_t, h_seq, c_seq = c_t, the
// activated gates and the masked stream in the residual type RT. K15 at
// D = 1 (TP true, lstm_tp.cu:tp_seq_fwd_launch): xw in fp32 with the bias
// folded in, the sum acc + xw_t, h_seq in fp32 (K15's param type), and in
// cseq c_prev[t] = c_{t-1}, the carry before the step's update, in RT; no
// dropout. hc holds round(h0) in its first half on entry in both.
//
// The window itself is fwd_persist_window, whose Step policy says where
// round(h) lives and what ends a step: GridStep here (hc's two halves, the
// grid barrier), exchange.cuh's RankStep for K15 at D ranks (the
// exchange buffers' slots, the exchange). It takes the block's place (its
// first unit j0 and first row b0) and two widths: N, that of h and of U's
// rows, and the gate stride gs, that of the outputs and of U's and the
// input stream's gate blocks (N here; a rank's shard width nd at D ranks).
constexpr int kMaxDevices = 64;

// (lstm_tiled_f32.cuh's fp32 window takes it too, with HT = float.)
template <typename HT>
struct GridStep {
  HT* hc;     // (2, B, N)
  size_t bn;  // B * N
  int N;
  __device__ __forceinline__ const HT* hin(int t) const {
    return hc + (size_t)(t % 2) * bn;
  }
  // round(h_t) of row b, unit j
  __device__ __forceinline__ void put(int t, int b, int j, float h) const {
    hc[(size_t)((t + 1) % 2) * bn + (size_t)b * N + j] = from_f32<HT>(h);
  }
  // h_t is complete before any block reads it, and the products' shared
  // memory is free again
  __device__ __forceinline__ void sync(int) const {
    cooperative_groups::this_grid().sync();
  }
};

template <typename RT, bool EMBED, bool TP, typename Step,
          typename XT = typename std::conditional<TP, float, __nv_bfloat16>::type,
          typename HT = typename std::conditional<TP, float, RT>::type>
__device__ __forceinline__ void
fwd_persist_window(const Step& step,
                   const __nv_bfloat16* __restrict__ U,   // (N, 4 gs)
                   const XT* __restrict__ xw,             // (S, B, 4 gs), !EMBED
                   const __nv_bfloat16* __restrict__ W,   // (M, 4 gs), EMBED
                   const float* __restrict__ bias,        // (4 gs,), EMBED
                   const int* __restrict__ ids,           // (S, B), EMBED
                   float* __restrict__ c,      // (B, gs): c0 in, cT out
                   float* __restrict__ hT,     // (B, gs)
                   HT* __restrict__ hseq,      // (S, B, gs)
                   RT* __restrict__ cseq,      // (S, B, gs) or null
                   RT* __restrict__ gseq,      // (S, B, 4 gs) or null
                   RT* __restrict__ hdrop,     // (S, B, gs) under dropout
                   Dropout drop, int S, int B, int N, int gs, int j0, int b0,
                   int rows, int kres, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = Us + (size_t)kres * kFUPitch;
  const FwdTile f = fwd_mma_tile(N, gs, j0, b0, B, rows);
  const size_t n4 = 4 * (size_t)gs, bn = (size_t)B * gs;

  for (int e = threadIdx.x; e < kres * 8; e += kFThreads)
    fwd_u_copy(f, U, Us + (size_t)(e / 8) * kFUPitch, e / 8, e % 8);
  cp_async_commit();

  // this thread's (b, j), when it is an owner: p = 4 hh + 2 uh + e for
  // row fwd_row(hh) and unit fwd_unit(uh, e); acc[2 gate + uh][2 hh + e]
  // holds its gate sum, bs[gate][2 uh + e] its bias
  float cr[8], pin[8][4], bs[4][4];
  const auto load_inputs = [&](int t) {
    if (EMBED)
      fwd_inputs<__nv_bfloat16>(
          f, [&](int b) { return W + (size_t)ids[(size_t)t * B + b] * n4; }, pin);
    else
      fwd_inputs<XT>(f, [&](int b) { return xw + ((size_t)t * B + b) * n4; }, pin);
  };
  if (f.owner) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int b = fwd_row(f, p / 4);
      cr[p] = b < B ? c[(size_t)b * gs + fwd_unit(f, (p / 2) % 2, p % 2)] : 0.0f;
    }
    if (EMBED)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          bs[gate][u] = bias[(size_t)gate * gs + fwd_unit(f, u / 2, u % 2)];
    load_inputs(0);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int cres = kres / kFKC;
  for (int t = 0; t < S; ++t) {
    const __nv_bfloat16* hin = step.hin(t);
    float acc[8][4];
    fwd_products(f, U, hin, Us, cres, ring, acc);
    if (f.owner) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int hh = p / 4, uh = (p / 2) % 2, e = p % 2;
        const int b = fwd_row(f, hh);
        if (b >= B) continue;
        const int j = fwd_unit(f, uh, e);
        float gate[4];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          float s = acc[2 * gt + uh][2 * hh + e];
          s = EMBED ? (s + pin[p][gt]) + bs[gt][2 * uh + e] : s + pin[p][gt];
          gate[gt] = gt < 3 ? sigmoid(s) : tanhf(s);
        }
        const size_t idx = (size_t)b * gs + j, ts = (size_t)t * bn;
        if (TP && cseq != nullptr) cseq[ts + idx] = from_f32<RT>(cr[p]);
        float h, cc;
        cell(gate, cr[p], standard, &h, &cc);
        cr[p] = cc;
        step.put(t, b, j, h);
        hseq[ts + idx] = from_f32<HT>(h);
        if (!TP && drop.on)
          hdrop[ts + idx] = from_f32<RT>(keep_bit(drop, t, idx) ? h * drop.inv : 0.0f);
        if (!TP && cseq != nullptr) cseq[ts + idx] = from_f32<RT>(cc);
        if (gseq != nullptr)
#pragma unroll
          for (int gt = 0; gt < 4; ++gt)
            gseq[4 * ts + (size_t)b * n4 + (size_t)gt * gs + j] = from_f32<RT>(gate[gt]);
        if (t == S - 1) {
          hT[idx] = h;
          c[idx] = cc;
        }
      }
      if (t + 1 < S) load_inputs(t + 1);
    }
    if (t + 1 < S) step.sync(t);
  }
}

template <typename RT, bool EMBED, bool TP,
          typename XT = typename std::conditional<TP, float, __nv_bfloat16>::type,
          typename HT = typename std::conditional<TP, float, RT>::type>
__global__ void __launch_bounds__(kFThreads, 1)
fwd_persist(const __nv_bfloat16* __restrict__ U,   // (N, 4N)
            const XT* __restrict__ xw,             // (S, B, 4N), !EMBED
            const __nv_bfloat16* __restrict__ W,   // (M, 4N), EMBED
            const float* __restrict__ bias,        // (4N,), EMBED
            const int* __restrict__ ids,           // (S, B), EMBED
            // (2, B, N) round(h): written and read within the launch, so
            // neither const nor __restrict__ (no non-coherent loads)
            __nv_bfloat16* hc,
            float* __restrict__ c,      // (B, N): c0 in, cT out
            float* __restrict__ hT,     // (B, N)
            HT* __restrict__ hseq,      // (S, B, N)
            RT* __restrict__ cseq,      // (S, B, N) or null
            RT* __restrict__ gseq,      // (S, B, 4N) or null
            RT* __restrict__ hdrop,     // (S, B, N) under dropout
            Dropout drop, int S, int B, int N, int rows, int kres, int standard) {
  fwd_persist_window<RT, EMBED, TP>(GridStep<__nv_bfloat16>{hc, (size_t)B * N, N},
                                    U, xw, W, bias,
                                    ids, c, hT, hseq, cseq, gseq, hdrop, drop, S, B,
                                    N, N, blockIdx.x * kFUnits, blockIdx.y * rows,
                                    rows, kres, standard);
}

// One cooperative launch of fwd_persist<RT, EMBED, TP> on `stream`, rows
// batch rows a block (rows >= B: one block row; else a multiple of 16) and
// kres rows of U held. Returns 0 and adds the launch to *launches, or the
// error (the grid must be resident at once, or its barrier never opens).
template <typename RT, bool EMBED, bool TP>
int run_fwd_persist(const void* U, const void* xw, const void* W,
                    const float* bias, const int* ids, void* hc, float* c,
                    float* hT, void* hseq, void* cseq, void* gseq, void* hdrop,
                    Dropout drop, int S, int B, int N, int rows, int kres,
                    int standard, cudaStream_t stream, int* launches) {
  if (N % kFKC != 0 || B < 1 || S < 1 || rows < 1 || rows > kFMaxRows ||
      (rows < B && rows % 16 != 0) || kres < 0 || kres > N || kres % kFKC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = fwd_persist<RT, EMBED, TP>;
  const size_t smem = fwd_smem_bytes(rows, kres);
  // per card, read once: cooperative launch support and the SMs
  static int ready[kMaxDevices], coop[kMaxDevices], sms[kMaxDevices];
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !ready[dev]) {
    err = cudaDeviceGetAttribute(&coop[dev], cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) ready[dev] = 1;
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kFThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop[dev]) return static_cast<int>(cudaErrorNotSupported);
  const dim3 grid(N / kFUnits, (B + rows - 1) / rows);
  if ((int)(grid.x * grid.y) > sms[dev] * per_sm)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  using bf = __nv_bfloat16;
  using XT = typename std::conditional<TP, float, bf>::type;
  using HT = typename std::conditional<TP, float, RT>::type;
  const bf* u = static_cast<const bf*>(U);
  const XT* x = static_cast<const XT*>(xw);
  const bf* w = static_cast<const bf*>(W);
  bf* h = static_cast<bf*>(hc);
  HT* hs = static_cast<HT*>(hseq);
  RT* cs = static_cast<RT*>(cseq);
  RT* gs = static_cast<RT*>(gseq);
  RT* hd = static_cast<RT*>(hdrop);
  void* args[] = {&u, &x, &w, &bias, &ids, &h, &c, &hT, &hs, &cs, &gs, &hd,
                  &drop, &S, &B, &N, &rows, &kres, &standard};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                    dim3(kFThreads), args, smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

}  // namespace
