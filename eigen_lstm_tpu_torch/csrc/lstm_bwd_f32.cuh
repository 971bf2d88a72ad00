// The LSTM backward under fp32 compute for Hopper (sm_90a): the persistent
// CUDA-core reverse design that K6, K3, K12, K10 and K16 at D = 1 share
// (K16 with its cT as c_last), and whose product (f32_load_u_rows,
// f32_rec_splits, f32_split_sum) K16's D-rank design runs
// (lstm_tp_f32_bwd.cu). No PyTorch headers. TF32 stays off for fp32 products, so fp32 keeps the CUDA cores.
// G, the blocks of a group, is a template parameter, so each G is its own
// set of kernels: lstm_bwd_f32.cu instantiates G = 4 and holds the C
// launchers, lstm_bwd_f32_pairs.cu G = 2; the two build in parallel. The
// kernels' other designs (the tensor-core persistent ones under bf16
// compute, the per-step ones) and the weight-gradient tail are in
// lstm_bwd.cu and lstm_tiled.cu. One C launcher, bound from Python through
// ctypes (eigen_lstm_tpu_torch/ops/cuda_cell_bwd.py):
//
//   lstm_bwd_f32_launch <- pallas_cell.py:_bwd_kernel (K6, :227),
//       _bwd_embed_fused_kernel (K3, :556) and _bwd_embed_unroll2_kernel
//       (K12, :689), pallas_cell_tiled.py:_bwd_tiled_kernel (K10, :106):
//       the S reverse steps, dg_t fp32, dc0, and dh0 = dg_0 @ U^T as the
//       launch's last product, in one cooperative launch; then, for K6, K3
//       and K12, lstm_bwd_tail_launch (lstm_bwd.cu) gives dU, and for K3
//       and K12 dW and db, from the fp32 dg
//
// ops/cuda_cell_bwd.py:k6_f32_plan chooses it for B <= 128, N a multiple
// of 32 and a grid the card holds at once (K10's plan,
// ops/cuda_cell_tiled.py:tiled_bwd_f32_plan, is the same at groups of 2
// blocks); elsewhere (N = 2048, B > 128) the per-step designs of
// lstm_bwd.cu and lstm_tiled.cu run. The gate backward is common.cuh's
// (gate_bwd, keep_bit), as in every design, so all compute one function.
//
// What held the per-step design back, at the bench's fp32 shapes (S = 100,
// B = 128, N = 512): S + 1 launches a call, each a grid of (N / 32) x
// (B / 4) = 512 blocks, each block re-reading its 32 columns of U^T over
// all 4N rows from L2 (~128 MB a step), dg_t through an fp32 scratch that
// the next launch reads whole, and a fresh U^T copy a call. The operations
// bound the function: 2 S B 4N N flops for dh_rec and as many for dU, 0.80
// ms at the bench and 8.2 ms at the flagship's shapes (S = 256, B = 128,
// N = 1024) at the H100's 67 TFLOP/s in fp32.
//
// What bounds a persistent reverse step is L2: dh_rec = dg_{t+1} @ U^T
// needs, for any unit, a whole row of dg_{t+1} (4N gate columns). The
// first form of K10's design let each of N / 8 blocks read all of dg_{t+1}
// each step (2 MB at B = 128, 256 MB over the grid): 18.1 ms a flagship
// window on an H100, ~3.6 TB/s from L2. So a group of G blocks owns
// kFUnits = 16 hidden units (N / 16 groups, G N / 16 blocks): its block p
// takes the gate columns p 4N / G .. (p + 1) 4N / G - 1 for all 16 units,
// and the epilogue of the 16 / G units 16 g + p 16 / G... G = 2 (pairs,
// each block half of the gate axis) gives 128 blocks at N = 1024; at N =
// 512 it would fill 64 of the H100's 132 SMs, so G = 4 there (128 blocks):
// a block then holds 16 x N floats of U (32 KB) and reads a quarter of
// dg_{t+1} a step (256 KB at B = 128, 32 MB over the grid). The plan takes
// the largest G of 4 and 2 whose grid is resident; it depends on N and the
// card alone, not on the batch.
//
// A block holds U's 16 rows of its group over its columns in shared memory
// for the window ([k][unit]), read in place: no U^T. Each step the rows of
// its columns of dg_{t+1} (fp32) arrive through a cp.async.cg ring of
// kFKC-column slots, L2 only (other blocks wrote them before the grid
// barrier); vector p of row r sits at p ^ (r mod 8). The product splits the
// block's k kFSplit = 8 ways: warp s takes the k (counted from the block's
// first column) with (k mod 32) / 4 = s in every ring layout and at every
// batch, and its lane (uh, pq) = (lane / 16, lane % 16) a register tile of
// RR rows (pq + 16 i; RR = 1, 2, 4, 8 for B <= 16, 32, 64, 128) by the 8
// units 8 uh..: each 4 values of k are RR 16-byte loads of dg and 8 of U
// for 32 RR FMAs. The splits' partial sums meet in the ring's memory (rows
// of kFRedPitch floats, so a quarter warp's 16-byte stores meet eight bank
// groups) and are added in split order: P_p(b, j), the block's part of
// dh_rec. Each block keeps its own units' parts and stores the others' into
// xbuf (G x B x N, L2 only) for their owners; after a grid barrier the
// owner of (b, j) adds ((P_0 + P_1) + P_2) + P_3, in part order, the same
// order at every batch (at G = 2, P_0 + P_1). Thread (u, q) =
// (tid % (16 / G), tid / (16 / G)) owns unit j of rows q + (256 G / 16) i
// and runs the gate backward in its registers: the dropout's keep bit at
// the global index and __fmul_rn, dh_cot + dh_rec, c_{t-1} (c0 at t = 0),
// the fp32 dc carried there for the window; it writes dg_t once, in fp32,
// and loads the next steps' g, c, c_{t-1} and dh_seq before the barrier
// (K12: both steps of a pair at once, K3's arithmetic, so K3's bits). Two
// grid barriers a step (the parts exchanged; dg_t complete); after step 0
// one more product gives dh0 = dg_0 @ U^T. What bounds it then: the columns
// of dg_{t+1} each block reads from L2 each step, beside the products'
// shared loads and the two barriers.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFUnits = 16;                      // hidden units of a group
constexpr int kFThreads = 256;
constexpr int kFSplit = 8;                       // ways the product splits k: a warp each
constexpr int kFKC = 64;                         // gate columns of a ring slot
constexpr int kFRowGroups = 16;                  // product rows pq + 16 i
constexpr int kFRedPitch = 20;                   // floats of a partial-sum row
constexpr int kFMaxRows = 128;                   // batch rows: 8 product rows a thread

// Product rows of a thread at batch B: 1, 2, 4, 8 (B <= 16, 32, 64, 128).
inline int f32_rows_per_thread(int B) {
  return B <= 16 ? 1 : B <= 32 ? 2 : B <= 64 ? 4 : 8;
}

// Dynamic shared memory of a block at batch B and hidden N, G blocks a
// group, with a ring of `stages` slots (mirrored by
// ops/cuda_cell_bwd.py:f32_smem_bytes, which holds itself to
// lstm_bwd_f32_smem_bytes once a card): U's 16 rows over 4N / G columns,
// then the ring, each slot 16 RR rows of kFKC floats; the splits' partial
// sums (kFSplit x 16 RR rows x kFRedPitch) reuse it.
inline size_t f32_smem_bytes(int B, int N, int G, int stages) {
  const size_t rows = (size_t)kFRowGroups * f32_rows_per_thread(B);
  const size_t ring = stages * rows * kFKC, red = kFSplit * rows * kFRedPitch;
  return sizeof(float) * ((size_t)4 * N / G * kFUnits + (ring > red ? ring : red));
}

// The group's 16 rows of U over a block's KG columns (part * KG..), once a
// window, into Us ([k][unit of the group]): consecutive threads read
// consecutive gate columns of one row. U (rows of K floats) read in place.
__device__ __forceinline__ void f32_load_u_rows(const float* __restrict__ U,
                                                float* Us, int K, int KG,
                                                int p0, int part) {
  for (int e = threadIdx.x; e < kFUnits * KG; e += kFThreads) {
    const int uu = e / KG, k = e % KG;
    Us[(size_t)k * kFUnits + uu] = U[(size_t)(p0 + uu) * K + (size_t)part * KG + k];
  }
}

// The block's part of dgn @ U^T for its group's 16 units over its KG
// columns, split kFSplit ways: dgn is the block's first column of row 0
// of a (B, K) fp32 dg, written by other blocks before a barrier, so it is
// read through L2 only (the ring's cp.async.cg); Us as f32_load_u_rows
// leaves it. On return (after a block barrier) red, the ring's memory,
// holds split s's partial sum of row b, unit uu at
// red[(s * 16 RR + b) * kFRedPitch + uu], rows b < 16 RR; the caller adds
// the splits in split order. The ring's slots are free again once every
// thread has read red (the caller's next block barrier).
template <int RR, int STAGES>
__device__ __forceinline__ void f32_rec_splits(const float* dgn, const float* Us,
                                               float* ring, int B, int K, int KG) {
  constexpr int rows = kFRowGroups * RR;        // rows of a ring slot
  constexpr int slot = rows * kFKC;
  float* red = ring;                            // [split][rows][kFRedPitch]
  const int tid = threadIdx.x;
  const int split = tid / 32, uh = tid % 32 / 16, pq = tid % 16;
  const int nchunks = KG / kFKC;
  // chunk ch: columns ch * kFKC.. of the block's rows, vector p of row r
  // at p ^ (r mod 8); rows past B zero-filled
  const auto load_chunk = [&](int ch) {
    float* st = ring + (size_t)(ch % STAGES) * slot;
    for (int e = tid; e < rows * (kFKC / 4); e += kFThreads) {
      const int r = e / (kFKC / 4), p = e % (kFKC / 4);
      const bool in = r < B;
      cp_async_16(st + r * kFKC + 4 * (p ^ (r % 8)),
                  in ? dgn + (size_t)r * K + ch * kFKC + 4 * p : dgn,
                  in ? 16 : 0);
    }
  };
  float acc[RR][8];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[i][y] = 0.0f;
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
    // split s's vectors s and s + 8 (k 4s.. and 32 + 4s.. of the chunk)
    // of rows pq + 16 i (whose row mod 8 is pq mod 8), and U's units
    // 8 uh.. at the same k
    const float* sl = ring + (size_t)(ch % STAGES) * slot + pq * kFKC;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int vec = split + kFSplit * w;
      const float* ds = sl + 4 * (vec ^ (pq % 8));
      const float* ub = Us + ((size_t)ch * kFKC + 4 * vec) * kFUnits + 8 * uh;
      float4 dv[RR];
#pragma unroll
      for (int i = 0; i < RR; ++i)
        dv[i] = *reinterpret_cast<const float4*>(ds + i * kFRowGroups * kFKC);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 w0 = *reinterpret_cast<const float4*>(ub + v * kFUnits);
        const float4 w1 = *reinterpret_cast<const float4*>(ub + v * kFUnits + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          const float x = v == 0 ? dv[i].x : v == 1 ? dv[i].y : v == 2 ? dv[i].z : dv[i].w;
#pragma unroll
          for (int y = 0; y < 8; ++y) acc[i][y] = fmaf(x, wv[y], acc[i][y]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it as red
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    float* dst = red + ((size_t)split * rows + pq + kFRowGroups * i) * kFRedPitch + 8 * uh;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
}

// Split s's partial of row b, unit uu (f32_rec_splits' red) added in split
// order: the block's part of that dh_rec entry.
template <int RR>
__device__ __forceinline__ float f32_split_sum(const float* red, int b, int uu) {
  constexpr int rows = kFRowGroups * RR;
  const float* rb = red + (size_t)b * kFRedPitch;
  float v = rb[uu];
#pragma unroll
  for (int s = 1; s < kFSplit; ++s) v += rb[(size_t)s * rows * kFRedPitch + uu];
  return v;
}

template <typename RT, int RR, int STAGES, int kSteps, int G>
__global__ void __launch_bounds__(kFThreads, 1)
lstm_bwd_f32_persist(const float* __restrict__ U,       // (N, 4N)
                     const RT* __restrict__ g_seq,      // (S, B, 4N)
                     const RT* __restrict__ c_seq,      // (S, B, N)
                     const float* __restrict__ c0,      // (B, N)
                     // (B, N) the fp32 c of step S - 1, read in place
                     // of c_seq[S - 1] (K16's cT), or null
                     const float* __restrict__ c_last,
                     const float* __restrict__ dh_seq,  // (S, B, N)
                     const float* __restrict__ dhT,     // (B, N)
                     float* __restrict__ dc,            // (B, N): dcT in, dc0 out
                     // (S, B, 4N) dg_seq and (G, B, N) the groups' parts of
                     // dh_rec: written and read within the launch, so
                     // neither const nor __restrict__ (no non-coherent loads)
                     float* dg, float* xbuf,
                     float* __restrict__ dh0,           // (B, N)
                     Dropout drop, int S, int B, int N, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  // epilogue rows of a thread: at most RR / 2 (G = 2: 32 rows a pass)
  constexpr int RE = RR > 1 ? RR / 2 : 1;
  static_assert(kFKC == 2 * 4 * kFSplit && kFThreads == 32 * kFSplit,
                "a warp a split, two 16-byte vectors of a slot row each");
  const int K = 4 * N, KG = K / G;              // gate columns, a block's
  constexpr int EU = kFUnits / G;               // units of a block's epilogue
  constexpr int RG = kFThreads / EU;            // its rows q + RG i
  float* Us = reinterpret_cast<float*>(smem);   // [k][unit of the group]
  float* ring = Us + (size_t)KG * kFUnits;      // STAGES x [rows][kFKC]
  const int tid = threadIdx.x;
  const int u = tid % EU, q = tid / EU;
  const int part = blockIdx.x % G, p0 = (blockIdx.x / G) * kFUnits;
  const int j = p0 + part * EU + u;             // this thread's unit
  const size_t bn = (size_t)B * N, bk = (size_t)B * K;
  cg::grid_group grid = cg::this_grid();

  f32_load_u_rows(U, Us, K, KG, p0, part);

  // this thread's (b, j): rows q + RG i that lie in the batch; slot p of
  // the inputs holds step t - p's
  float dcr[RE], gin[kSteps][RE][4], cin[kSteps][RE], cpin[kSteps][RE],
      dhin[kSteps][RE];
  const auto valid = [&](int i) { return q + RG * i < B; };
  const auto row = [&](int i) { return (size_t)(q + RG * i) * N; };
#pragma unroll
  for (int i = 0; i < RE; ++i) dcr[i] = valid(i) ? dc[row(i) + j] : 0.0f;
  const auto load_inputs = [&](int p, int t) {
#pragma unroll
    for (int i = 0; i < RE; ++i) {
      if (!valid(i)) continue;
      const size_t idx = row(i) + j;
      const size_t gb = t * bk + (size_t)(q + RG * i) * K + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) gin[p][i][g] = to_f32(g_seq[gb + (size_t)g * N]);
      cin[p][i] = t == S - 1 && c_last != nullptr ? c_last[idx]
                                                  : to_f32(c_seq[t * bn + idx]);
      cpin[p][i] = t > 0 ? to_f32(c_seq[(t - 1) * bn + idx]) : c0[idx];
      dhin[p][i] = dh_seq[t * bn + idx];
    }
  };

  // The block's part of dh_rec = dg_tn @ U^T for the group's 16 units: its
  // own units' parts into mine, the others' stored into xbuf for their
  // owners (L2 only)
  const auto rec = [&](int tn, float (&mine)[RE]) {
    f32_rec_splits<RR, STAGES>(dg + (size_t)tn * bk + (size_t)part * KG, Us, ring,
                               B, K, KG);
    // each unit's part, the splits added in split order: the thread's own
    // unit kept, the same column of the other blocks' units stored
#pragma unroll
    for (int i = 0; i < RE; ++i) {
      mine[i] = 0.0f;
      if (!valid(i)) continue;
      const int b = q + RG * i;
#pragma unroll
      for (int o = 0; o < G; ++o) {
        const int uu = o * EU + u;
        const float v = f32_split_sum<RR>(ring, b, uu);
        if (o == part)
          mine[i] = v;
        else
          __stcg(xbuf + ((size_t)part * B + b) * N + p0 + uu, v);
      }
    }
  };

  // dh_rec of this thread's (b, j) from the G parts, added in part order
  // (the thread's own from mine, the others' through L2)
  const auto gather = [&](const float (&mine)[RE], float (&dh_rec)[RE]) {
#pragma unroll
    for (int i = 0; i < RE; ++i) {
      dh_rec[i] = 0.0f;
      if (!valid(i)) continue;
      const int b = q + RG * i;
      float v = 0.0f;
#pragma unroll
      for (int o = 0; o < G; ++o) {
        const float x = o == part ? mine[i] : __ldcg(xbuf + ((size_t)o * B + b) * N + j);
        v = o == 0 ? x : v + x;
      }
      dh_rec[i] = v;
    }
  };

#pragma unroll
  for (int p = 0; p < kSteps; ++p) load_inputs(p, S - 1 - p);
  __syncthreads();  // U's rows are in

  for (int t1 = S - 1; t1 >= 0; t1 -= kSteps) {
#pragma unroll
    for (int p = 0; p < kSteps; ++p) {
      const int t = t1 - p;
      float mine[RE], dh_rec[RE];
#pragma unroll
      for (int i = 0; i < RE; ++i) mine[i] = 0.0f;
      if (t < S - 1) rec(t + 1, mine);
      // the parts are exchanged; every block reaches it every step,
      // t = S - 1's (nothing exchanged) too
      grid.sync();
      if (t == S - 1) {
#pragma unroll
        for (int i = 0; i < RE; ++i) dh_rec[i] = valid(i) ? dhT[row(i) + j] : 0.0f;
      } else {
        gather(mine, dh_rec);
      }
#pragma unroll
      for (int i = 0; i < RE; ++i) {
        if (!valid(i)) continue;
        const size_t idx = row(i) + j;
        float dh_cot = dhin[p][i];
        // __fmul_rn: the product rounds before the add, as in the TPU kernel
        if (drop.on) dh_cot = keep_bit(drop, t, idx) ? __fmul_rn(dh_cot, drop.inv) : 0.0f;
        float d[4];
        gate_bwd(gin[p][i][0], gin[p][i][1], gin[p][i][2], gin[p][i][3], cin[p][i],
                 cpin[p][i], dh_cot + dh_rec[i], dcr[i], standard, d, &dcr[i]);
        const size_t gb = t * bk + (size_t)(q + RG * i) * K + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) dg[gb + (size_t)g * N] = d[g];
      }
      if (p == kSteps - 1 && t > 0)
#pragma unroll
        for (int p2 = 0; p2 < kSteps; ++p2) load_inputs(p2, t - 1 - p2);
      // dg_t is complete before any block reads it, the ring's partial
      // sums are read before the next chunks land, and the exchanged parts
      // are read before the next are stored; every block reaches it every
      // step
      grid.sync();
    }
  }
  // dh0 = dg_0 @ U^T, the launch's last product, and dc0
  float mine[RE], dh_rec[RE];
  rec(0, mine);
  grid.sync();
  gather(mine, dh_rec);
#pragma unroll
  for (int i = 0; i < RE; ++i)
    if (valid(i)) {
      dh0[row(i) + j] = dh_rec[i];
      dc[row(i) + j] = dcr[i];
    }
}

// One cooperative launch of lstm_bwd_f32_persist<RT, RR, STAGES, kSteps, G>
// on `stream`, RR the product rows a thread owns at B. Returns 0 and adds
// the launch to *launches, or the error.
template <typename RT, int RR, int STAGES, int kSteps, int G>
int run_f32(const void* U, const void* g_seq, const void* c_seq, const float* c0,
            const float* c_last, const float* dh_seq, const float* dhT, float* dc,
            float* dg, float* xbuf, float* dh0, Dropout drop, int S, int B, int N,
            int standard, cudaStream_t stream, int* launches) {
  const auto kernel = lstm_bwd_f32_persist<RT, RR, STAGES, kSteps, G>;
  const size_t smem = f32_smem_bytes(B, N, G, STAGES);
  const int grid = N / kFUnits * G;
  const int err = cooperative_fits(reinterpret_cast<const void*>(kernel),
                                   kFThreads, smem, grid);
  if (err != 0) return err;
  const float* u = static_cast<const float*>(U);
  const RT* gs = static_cast<const RT*>(g_seq);
  const RT* cs = static_cast<const RT*>(c_seq);
  void* args[] = {&u, &gs, &cs, &c0, &c_last, &dh_seq, &dhT, &dc, &dg, &xbuf,
                  &dh0, &drop, &S, &B, &N, &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kFThreads), args,
      smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launches;
  return 0;
}

// The ring layouts the library is built for: (product rows a thread,
// stages), as ops/cuda_cell_bwd.py:F32_RINGS lists them.
#define BWD_F32_LAYOUTS(X) X(1, 6) X(2, 6) X(4, 5) X(8, 3) X(8, 2)

template <typename RT, int kSteps, int G>
int bwd_f32(const void* U, const void* g_seq, const void* c_seq, const float* c0,
            const float* c_last, const float* dh_seq, const float* dhT, float* dc,
            float* dg, float* xbuf, float* dh0, Dropout drop, int S, int B, int N,
            int stages, int standard, cudaStream_t stream, int* launches) {
  const auto f = [&](auto run) {
    return run(U, g_seq, c_seq, c0, c_last, dh_seq, dhT, dc, dg, xbuf, dh0, drop,
               S, B, N, standard, stream, launches);
  };
  const int RR = f32_rows_per_thread(B);
#define BWD_F32_CASE(r, st) \
  if (RR == r && stages == st) return f(run_f32<RT, r, st, kSteps, G>);
  BWD_F32_LAYOUTS(BWD_F32_CASE)
#undef BWD_F32_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch at G blocks a group, the residual type and `steps` chosen at
// run time; arguments as lstm_bwd_f32_launch's, which checks them.
template <int G>
int launch_groups(int rtype, const void* U, const void* g_seq,
                  const void* c_seq, const void* c0, const void* c_last,
                  const void* dh_seq, const void* dhT, void* dc, void* dg,
                  void* xbuf, void* dh0,
                  int S, int B, int N, int stages, int steps, int standard,
                  int drop_on, unsigned seed, unsigned keep, float inv,
                  void* stream, int* launches) {
  const Dropout drop{drop_on, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, g_seq, c_seq, static_cast<const float*>(c0),
               static_cast<const float*>(c_last), static_cast<const float*>(dh_seq),
               static_cast<const float*>(dhT),
               static_cast<float*>(dc), static_cast<float*>(dg),
               static_cast<float*>(xbuf), static_cast<float*>(dh0), drop, S, B,
               N, stages, standard, static_cast<cudaStream_t>(stream), launches);
  };
  using bf = __nv_bfloat16;
  if (rtype == 0) return steps == 1 ? f(bwd_f32<float, 1, G>) : f(bwd_f32<float, 2, G>);
  if (rtype == 1) return steps == 1 ? f(bwd_f32<bf, 1, G>) : f(bwd_f32<bf, 2, G>);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
