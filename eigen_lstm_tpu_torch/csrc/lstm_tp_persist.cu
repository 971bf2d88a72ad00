// K15 and K16 at D > 1 in their persistent tensor-core designs for Hopper
// (sm_90a), bound from Python through ctypes (ops/cuda_tp_seq.py). No
// PyTorch headers. They replace the D > 1 exchange of the TPU kernels
// pallas_tp_seq.py:_fwd_kernel (:59; the exchange :96-120) and _bwd_kernel
// (:125; :150-177) under bf16 compute, wherever ops/cuda_tp_seq.py's
// planners give a layout; fp32 takes the CUDA-core counterparts of
// lstm_tp_f32.cu and lstm_tp_f32_bwd.cu, and the shapes no plan takes
// keep lstm_tp.cu's cooperative tiles (tp_seq_fwd_x, tp_seq_bwd_x). Both compute what the
// TPU kernels compute: the full h all-gathered each step in the forward,
// the reduce-scatter of round(dg_{t+1}) @ U_r^T in the backward, each
// rank's D chunks summed in rank order. The exchange (peer table, flags,
// rank barriers, exchange.cuh) and the buffers' layout are the cooperative
// design's; a launch holds one rank group on each of D cards or D groups
// on one card. A source of its own, so that nvcc builds it beside
// lstm_tp.cu.
//
// What bounds them on the H100: the work and the function's bytes are
// those of K15 and K16 at D = 1 (lstm_tp.cu's header), so the bound is the
// same; the exchange is neither input nor output. What holds them back is
// the recurrence, as at D = 1: each step every block reads its rows of the
// rank's h (or dg) from L2 and meets the exchange (or, in the backward, a
// rank barrier and the exchange), while its products take microseconds.

#include "common.cuh"
#include "exchange.cuh"
#include "fwd_mma.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// K15 at D ranks on the persistent tensor-core forward (bf16 compute;
// ops/cuda_tp_seq.py:ranks_fwd_plan gives each group's (kres, rows)):
// fwd_mma.cuh's window with K15's streams, the gate stride the shard's nd,
// and RankStep in place of the grid barrier. A block of rank r owns 16 of
// the shard's nd units with their four gate columns and `rows` batch rows,
// so a group holds (nd / 16) * ceil(B / rows) blocks; its N x 64 slice of
// U_r stays in shared memory as far as it fits (kres rows). Step t reads
// round(h_{t-1}) (B, N) from the rank's own slot (base + t) % 3 through L2
// (cp.async.cg), stores its tile of round(h_t) into slot (base + t + 1) % 3,
// columns [r * nd, +nd), of every rank's buffer, its own too, and ends with
// the exchange. The last step stores and exchanges nothing (a peer's next
// call may already hold its h0 in that slot); the host copies h0 into slot
// base % 3 first (copy_h0): exchange.cuh's RankStep. With the D = 1
// layout's rows a unit's sums are the D = 1 persistent K15's: the same
// chunks of h and of U's column, the same warps' k steps.
template <typename RT>
struct PersistFwdGroup {
  const __nv_bfloat16* U;  // (N, 4nd), the rank's shard
  const float* xw;         // (S, B, 4nd)
  float* c;                // (B, nd): c0 in, cT out
  float* hT;               // (B, nd)
  float* hseq;             // (S, B, nd)
  RT* cprev;               // (S, B, nd)
  RT* gseq;                // (S, B, 4nd)
  int rank, first, rows, kres;
};

template <typename RT>
struct PersistFwdRanks {
  PersistFwdGroup<RT> g[kMaxRanks];
};

template <typename RT>
__global__ void __launch_bounds__(kFThreads, 1)
tp_seq_fwd_persist_x(const __grid_constant__ PersistFwdRanks<RT> a, int groups,
                     const __grid_constant__ PeerTable peers, int D,
                     unsigned long long base, long long h_off, int S, int B,
                     int N, int nd, int standard) {
  int nb;
  const PersistFwdGroup<RT>& G = a.g[my_group(a.g, groups, &nb)];
  const int bi = static_cast<int>(blockIdx.x) - G.first;
  const int cols = nd / kFUnits;
  const RankStep<__nv_bfloat16> step{peers, G.rank, D, N, nd, S, base, h_off,
                                     (size_t)B * N, words(peers.buf[G.rank], kFwdBar),
                                     nb};
  fwd_persist_window<RT, false, true>(
      step, G.U, G.xw, nullptr, nullptr, nullptr, G.c, G.hT, G.hseq, G.cprev,
      G.gseq, nullptr, Dropout{0, 0, 0, 0.0f}, S, B, N, nd,
      (bi % cols) * kFUnits, (bi / cols) * G.rows, G.rows, G.kres, standard);
}

// ---------------------------------------------------------------------------
// K16 at D ranks as a persistent reverse kernel (bf16 compute;
// ops/cuda_tp_seq.py:ranks_bwd_plan gives (units, rows)), from K6's
// persistent step (lstm_bwd.cu:lstm_bwd_persist) with the reduce-scatter
// between its product and its gate backward. A rank's blocks own groups of
// kUnits output units over all N and tiles of kRows batch rows: a group
// holds (N / kUnits) * row_blocks blocks, block bi the unit group bi %
// (N / kUnits) and the row tiles bi / (N / kUnits), + row_blocks, ...; its
// rows of U_r (kUnits x 4nd bf16, narrower by D than at D = 1, so a block
// owns more units) are loaded into shared memory once. Reverse step t < S - 1
// (and t = -1, dh0):
//   1. the partial round(dg_{t+1}) @ U_r^T of each of the block's tiles: the
//      rank's dg_{t+1} rows (bf16) stream through a ring of kStages chunks
//      of kXKC gate columns by cp.async (L2 only), warp w taking the 16
//      columns 16w.. of each chunk as one k step of mma.sync m16n8k16 for
//      every (16-row, 8-unit) tile, the 8 warps' sums added in warp order
//      through shared memory; unit j's partial goes to chunk [w][me] of its
//      owner rank j / nd, w = (base + e) % 3 for the window's e-th exchange,
//      e = S - 2 - t;
//   2. the exchange: every rank's partials for this rank are in;
//   3. the gate backward of the rank's own B x nd elements, a fixed share a
//      thread (element (bi * 256 + tid) + i * nb * 256, i < kGMax): dh_rec
//      the sum of its D chunks in rank order 0..D-1 (pallas_tp_seq.py:140's
//      jnp.sum(rbuf[w], axis=0)), dc carried in registers for the window,
//      dg written in fp32 (the output) and rounded to bf16 into slot t % 2
//      of a two-slot scratch, which the next step's product reads;
//   4. a rank barrier: dg_t is whole before any block of the rank reads it.
// At t = S - 1 dh_rec is dhT and 1-2 are skipped; after step 0 the product
// of dg_0, the exchange and the sum give dh0, and the carry dc0. So a
// reverse step takes one rank barrier and one exchange (which holds no
// barrier), where the cooperative design takes two barriers. The steps' g,
// c and dh_seq do not depend on the recurrence: each thread loads those of
// step t - 1 before the barrier that precedes it. Three chunk slots for the
// reason of the forward's three h slots. What bounds it is then the
// recurrence's dependence, as K6's: each step every unit group reads the
// rank's whole dg_{t+1} rows from L2 and every block waits at the barrier
// and the exchange, while its products take a few microseconds.
constexpr int kXThreads = 256;          // 8 warps
constexpr int kXWarps = kXThreads / 32;
constexpr int kXKC = 16 * kXWarps;      // gate columns of a chunk: a k step a warp
constexpr int kXPad = 8;                // as lstm_bwd.cu's kPPad
constexpr int kXRingPitch = kXKC + kXPad;
constexpr int kXRingRows = 192;         // the ring's rows: kStages * kRows
constexpr int kGMax = 8;                // gate-backward elements a thread at most

// Dynamic shared memory of a block of `units` units and `rows` batch rows
// at shard width nd (mirrored by ops/cuda_tp_seq.py:ranks_bwd_smem_bytes):
// the units' rows of U_r, each 4nd + kXPad bf16, then the ring, whose
// space the cross-warp sums (8 warps x rows x units fp32) reuse.
inline size_t bwd_x_smem_bytes(int nd, int units, int rows) {
  const size_t ring = 2 * (size_t)kXRingRows * kXRingPitch;
  const size_t red = (size_t)kXWarps * rows * units * 4;
  return 2 * (size_t)units * (4 * nd + kXPad) + (ring > red ? ring : red);
}

template <typename RT>
struct PersistBwdGroup {
  const __nv_bfloat16* U;  // (N, 4nd), the rank's shard
  const RT* gseq;          // (S, B, 4nd)
  const RT* cprev;         // (S, B, nd)
  const float* cT;         // (B, nd)
  const float* dhseq;      // (S, B, nd)
  const float* dhT;        // (B, nd)
  float* dc;               // (B, nd): dcT in, dc0 out
  float* dg;               // (S, B, 4nd)
  __nv_bfloat16* dgx;      // (2, B, 4nd): round(dg) of the last two steps
  float* dh0;              // (B, nd)
  int rank, first, row_blocks;
};

template <typename RT>
struct PersistBwdRanks {
  PersistBwdGroup<RT> g[kMaxRanks];
};

template <typename RT, int MT, int NT>
__global__ void __launch_bounds__(kXThreads, 1)
tp_seq_bwd_persist_x(const __grid_constant__ PersistBwdRanks<RT> a, int groups,
                     const __grid_constant__ PeerTable peers, int D,
                     unsigned long long base, long long r_off, int S, int B,
                     int N, int nd, int standard) {
  constexpr int kRows = 16 * MT, kUnits = 8 * NT;
  constexpr int kStages = kXRingRows / kRows;
  constexpr int kElems = kRows * kUnits / kXThreads;  // a tile's (b, j) a thread
  extern __shared__ __align__(16) unsigned char smem[];
  int nb;
  const PersistBwdGroup<RT>& G = a.g[my_group(a.g, groups, &nb)];
  const int bi = static_cast<int>(blockIdx.x) - G.first;
  const int me = G.rank;
  const int K = 4 * nd, upitch = K + kXPad;
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = Us + (size_t)kUnits * upitch;
  float* red = reinterpret_cast<float*>(ring);  // [kXWarps][kRows][kUnits]
  const int ugroups = N / kUnits;
  const int j0 = (bi % ugroups) * kUnits;
  const int tiles = (B + kRows - 1) / kRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const size_t bn = (size_t)B * nd, bk = (size_t)B * K;
  unsigned char* mine = peers.buf[me];
  unsigned* bar = words(mine, kBwdBar);

  // U_r's rows j0.. into shared memory, once
  for (int p = tid; p < kUnits * (K / 8); p += kXThreads) {
    const int u = p / (K / 8), k = (p % (K / 8)) * 8;
    cp_async_16(Us + (size_t)u * upitch + k, G.U + (size_t)(j0 + u) * K + k, 16);
  }
  cp_async_commit();

  // 1: the partials of the block's tiles from the rank's round(dg) rows at
  // dgn (B, K), into their owners' chunks of slot ws
  const int nchunks = K / kXKC;
  const auto product = [&](const __nv_bfloat16* dgn, int ws) {
    for (int tile = bi / ugroups; tile < tiles; tile += G.row_blocks) {
      const int b0 = tile * kRows;
      const int nrows = min(kRows, B - b0);
      const int mtiles = (nrows + 15) / 16;
      const auto load_chunk = [&](int c) {
        __nv_bfloat16* slot = ring + (size_t)(c % kStages) * kRows * kXRingPitch;
        for (int p = tid; p < mtiles * 16 * (kXKC / 8); p += kXThreads) {
          const int r = p / (kXKC / 8), k = (p % (kXKC / 8)) * 8;
          const bool in = r < nrows;
          cp_async_16(slot + r * kXRingPitch + k,
                      in ? dgn + (size_t)(b0 + r) * K + c * kXKC + k : dgn, in ? 16 : 0);
        }
      };
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[mt][nt][x] = 0.0f;
      __syncthreads();  // the last tile's reads of red are done
#pragma unroll
      for (int c = 0; c < kStages - 1; ++c) {
        if (c < nchunks) load_chunk(c);
        cp_async_commit();
      }
      for (int c = 0; c < nchunks; ++c) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk c is in, and chunk c - 1's slot is free
        if (c + kStages - 1 < nchunks) load_chunk(c + kStages - 1);
        cp_async_commit();
        const __nv_bfloat16* slot = ring + (size_t)(c % kStages) * kRows * kXRingPitch;
        const int kk = warp * 16;
        // b0, b1 of n tiles 2p, 2p + 1: units 16p.. (k 0-7 | 8-15), 16p + 8..
        unsigned bq[2 * NT];
        const __nv_bfloat16* urow = Us + (size_t)(lane % 8 + 8 * (lane / 16)) * upitch +
                                    c * kXKC + kk + 8 * ((lane / 8) % 2);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) ldmatrix_x4(bq + 4 * p, urow + (size_t)16 * p * upitch);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt >= mtiles) break;
          unsigned af[4];
          ldmatrix_x4(af, slot + (mt * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * kXRingPitch +
                              kk + 8 * (lane / 16));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], af, bq + 2 * nt);
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring: reuse it as red
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= mtiles) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* dst = red + ((size_t)warp * kRows + mt * 16 + g + 8 * h) * kUnits +
                         nt * 8 + 2 * q;
            dst[0] = acc[mt][nt][2 * h];
            dst[1] = acc[mt][nt][2 * h + 1];
          }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = tid + kXThreads * i, r = e / kUnits;
        if (r >= nrows) continue;
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kXWarps; ++w) v += red[(size_t)w * kRows * kUnits + e];
        const int j = j0 + e % kUnits, owner = j / nd;
        reinterpret_cast<float*>(peers.buf[owner] + r_off)[((size_t)ws * D + me) * bn +
                                                           (size_t)(b0 + r) * nd + (j - owner * nd)] = v;
      }
    }
  };

  // 3: this thread's gate-backward elements of the rank's B x nd
  const size_t g0 = (size_t)bi * kXThreads + tid, gstep = (size_t)nb * kXThreads;
  float dcr[kGMax], gin[kGMax][4], cin[kGMax], cpin[kGMax], dhin[kGMax];
#pragma unroll
  for (int i = 0; i < kGMax; ++i) {
    const size_t idx = g0 + i * gstep;
    dcr[i] = idx < bn ? G.dc[idx] : 0.0f;
  }
  const auto load_inputs = [&](int t) {
#pragma unroll
    for (int i = 0; i < kGMax; ++i) {
      const size_t idx = g0 + i * gstep;
      if (idx >= bn) continue;
      const size_t gb = t * bk + (idx / nd) * K + idx % nd;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) gin[i][gt] = to_f32(G.gseq[gb + (size_t)gt * nd]);
      cin[i] = t == S - 1 ? G.cT[idx] : to_f32(G.cprev[(t + 1) * bn + idx]);
      cpin[i] = to_f32(G.cprev[t * bn + idx]);
      dhin[i] = G.dhseq[t * bn + idx];
    }
  };
  // dh_rec of this thread's elements: the D chunks of slot ws in rank order
  const auto chunk_sum = [&](int ws, float (&rec)[kGMax]) {
    const float* chunks = reinterpret_cast<const float*>(mine + r_off) + (size_t)ws * D * bn;
#pragma unroll
    for (int i = 0; i < kGMax; ++i) {
      const size_t idx = g0 + i * gstep;
      float v = 0.0f;
      if (idx < bn) {
        v = __ldcg(chunks + idx);
        for (int r = 1; r < D; ++r) v += __ldcg(chunks + (size_t)r * bn + idx);
      }
      rec[i] = v;
    }
  };

  load_inputs(S - 1);
  cp_async_wait<0>();
  __syncthreads();
  for (int t = S - 1; t >= 0; --t) {
    float rec[kGMax];
    if (t == S - 1) {
#pragma unroll
      for (int i = 0; i < kGMax; ++i) {
        const size_t idx = g0 + i * gstep;
        rec[i] = idx < bn ? G.dhT[idx] : 0.0f;
      }
    } else {
      const unsigned long long e = base + (S - 2 - t);
      const int ws = static_cast<int>(e % 3);
      product(G.dgx + (size_t)((t + 1) % 2) * bk, ws);
      exchange(peers, me, D, kBwdFlag, bar, nb, static_cast<unsigned>(e + 1));
      chunk_sum(ws, rec);
    }
#pragma unroll
    for (int i = 0; i < kGMax; ++i) {
      const size_t idx = g0 + i * gstep;
      if (idx >= bn) continue;
      float d[4];
      gate_bwd(gin[i][0], gin[i][1], gin[i][2], gin[i][3], cin[i], cpin[i],
               dhin[i] + rec[i], dcr[i], standard, d, &dcr[i]);
      const size_t gb = (idx / nd) * K + idx % nd;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        G.dg[t * bk + gb + (size_t)gt * nd] = d[gt];
        G.dgx[(size_t)(t % 2) * bk + gb + (size_t)gt * nd] = __float2bfloat16(d[gt]);
      }
    }
    if (t > 0) load_inputs(t - 1);
    rank_barrier(bar, nb);  // dg_t is whole before any block of the rank reads it
  }
  // dh0 = round(dg_0) @ U^T, the rank's columns summed over the ranks; dc0
  const unsigned long long e = base + (S - 1);
  const int ws = static_cast<int>(e % 3);
  product(G.dgx, ws);
  exchange(peers, me, D, kBwdFlag, bar, nb, static_cast<unsigned>(e + 1));
  float rec[kGMax];
  chunk_sum(ws, rec);
#pragma unroll
  for (int i = 0; i < kGMax; ++i) {
    const size_t idx = g0 + i * gstep;
    if (idx >= bn) continue;
    G.dh0[idx] = rec[i];
    G.dc[idx] = dcr[i];
  }
}

// K15 at D ranks on the persistent forward: group g's layout (kres[g],
// rows[g]) as fwd_persist's (rows >= B: one block row; else a multiple of
// 16), its blocks (nd / 16) * ceil(B / rows[g]), the shared memory the
// largest group's.
template <typename RT>
int run_fwd_persist_ranks(int groups, const int* ranks, const int* kres,
                          const int* rows, const void* const* U,
                          const void* const* xw, const void* const* h0,
                          void* const* c, void* const* hseq, void* const* gseq,
                          void* const* cprev, void* const* hT, int D,
                          void* const* bufs, long long h_off,
                          unsigned long long base, int S, int B, int N, int nd,
                          int standard, cudaStream_t stream) {
  if (groups < 1 || groups > kMaxRanks || S < 1 || B < 1 || N % kFKC != 0 ||
      nd < kFUnits || nd % kFUnits != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks[kMaxRanks];
  size_t smem = 0;
  for (int g = 0; g < groups; ++g) {
    if (rows[g] < 1 || rows[g] > kFMaxRows || (rows[g] < B && rows[g] % 16 != 0) ||
        kres[g] < 0 || kres[g] > N || kres[g] % kFKC != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    blocks[g] = (nd / kFUnits) * ((B + rows[g] - 1) / rows[g]);
    const size_t bytes = fwd_smem_bytes(rows[g], kres[g]);
    smem = bytes > smem ? bytes : smem;
  }
  const auto kernel = tp_seq_fwd_persist_x<RT>;
  int resident = 0;
  int err = resident_with(kernel, kFThreads, smem, &resident);
  if (err != 0) return err;
  PersistFwdRanks<RT> a{};
  PeerTable peers{};
  int first[kMaxRanks];
  const int grid = ranks_grid(groups, ranks, blocks, D, bufs, N, nd, resident,
                              first, &peers);
  if (grid < 0) return -grid;
  using bf = __nv_bfloat16;
  for (int g = 0; g < groups; ++g)
    a.g[g] = PersistFwdGroup<RT>{
        static_cast<const bf*>(U[g]), static_cast<const float*>(xw[g]),
        static_cast<float*>(c[g]), static_cast<float*>(hT[g]),
        static_cast<float*>(hseq[g]), static_cast<RT*>(cprev[g]),
        static_cast<RT*>(gseq[g]), ranks[g], first[g], rows[g], kres[g]};
  err = copy_h0(groups, ranks, h0, peers, h_off, base, (size_t)B * N * sizeof(bf), stream);
  if (err != 0) return err;
  void* args[] = {&a, &groups, &peers, &D, &base, &h_off, &S, &B, &N, &nd,
                  &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kFThreads), args,
      smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

// The persistent backward's kernel for (units, rows), or null.
template <typename RT>
auto bwd_persist_kernel(int units, int rows) -> decltype(&tp_seq_bwd_persist_x<RT, 1, 4>) {
  if (units == 32 && rows == 16) return tp_seq_bwd_persist_x<RT, 1, 4>;
  if (units == 32 && rows == 32) return tp_seq_bwd_persist_x<RT, 2, 4>;
  if (units == 32 && rows == 64) return tp_seq_bwd_persist_x<RT, 4, 4>;
  if (units == 64 && rows == 16) return tp_seq_bwd_persist_x<RT, 1, 8>;
  if (units == 64 && rows == 32) return tp_seq_bwd_persist_x<RT, 2, 8>;
  return nullptr;
}

// K16 at D ranks as the persistent reverse kernel: every group's blocks
// (N / units) * row_blocks[g], 1 <= row_blocks[g] <= ceil(B / rows), and
// each thread at most kGMax of the rank's B x nd gate-backward elements.
template <typename RT>
int run_bwd_persist_ranks(int groups, const int* ranks, const int* row_blocks,
                          const void* const* U, const void* const* gseq,
                          const void* const* cprev, const void* const* cT,
                          const void* const* dhseq, const void* const* dhT,
                          void* const* dc, void* const* dg, void* const* dgx,
                          void* const* dh0, int D, void* const* bufs,
                          long long r_off, unsigned long long base, int S,
                          int B, int N, int nd, int units, int rows,
                          int standard, cudaStream_t stream) {
  const auto kernel = bwd_persist_kernel<RT>(units, rows);
  if (kernel == nullptr || groups < 1 || groups > kMaxRanks || S < 1 || B < 1 ||
      nd < 32 || nd % 32 != 0 || N % units != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks[kMaxRanks];
  const int tiles = (B + rows - 1) / rows;
  for (int g = 0; g < groups; ++g) {
    if (row_blocks[g] < 1 || row_blocks[g] > tiles)
      return static_cast<int>(cudaErrorInvalidValue);
    blocks[g] = (N / units) * row_blocks[g];
    if ((size_t)B * nd > (size_t)blocks[g] * kXThreads * kGMax)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_x_smem_bytes(nd, units, rows);
  int resident = 0;
  int err = resident_with(kernel, kXThreads, smem, &resident);
  if (err != 0) return err;
  PersistBwdRanks<RT> a{};
  PeerTable peers{};
  int first[kMaxRanks];
  const int grid = ranks_grid(groups, ranks, blocks, D, bufs, N, nd, resident,
                              first, &peers);
  if (grid < 0) return -grid;
  using bf = __nv_bfloat16;
  for (int g = 0; g < groups; ++g)
    a.g[g] = PersistBwdGroup<RT>{
        static_cast<const bf*>(U[g]), static_cast<const RT*>(gseq[g]),
        static_cast<const RT*>(cprev[g]), static_cast<const float*>(cT[g]),
        static_cast<const float*>(dhseq[g]), static_cast<const float*>(dhT[g]),
        static_cast<float*>(dc[g]), static_cast<float*>(dg[g]),
        static_cast<bf*>(dgx[g]), static_cast<float*>(dh0[g]), ranks[g],
        first[g], row_blocks[g]};
  void* args[] = {&a, &groups, &peers, &D, &base, &r_off, &S, &B, &N, &nd,
                  &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kXThreads), args,
      smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// K15 at D ranks on the persistent tensor-core forward (bf16 compute; rtype
// 0 = fp32, 1 = bf16 residuals). As tp_seq_fwd_ranks_launch, with group g's
// layout (kres[g], rows[g]) from ops/cuda_tp_seq.py:ranks_fwd_plan in place
// of a block count, U (N, 4nd) and h0 (B, N) in bf16, U 16-byte aligned,
// and no cT: c (B, nd) holds c0 on entry and cT on return. Every block
// must be resident at once (refused before anything runs otherwise).
extern "C" int tp_seq_fwd_persist_ranks_launch(
    int rtype, int groups, const int* ranks, const int* kres, const int* rows,
    const void* const* U, const void* const* xw, const void* const* h0,
    void* const* c, void* const* hseq, void* const* gseq, void* const* cprev,
    void* const* hT, int D, void* const* bufs, long long h_off,
    unsigned long long base, int S, int B, int N, int nd, int standard,
    void* stream, int* launches) {
  const auto f = [&](auto run) {
    return run(groups, ranks, kres, rows, U, xw, h0, c, hseq, gseq, cprev, hT,
               D, bufs, h_off, base, S, B, N, nd, standard,
               static_cast<cudaStream_t>(stream));
  };
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (rtype == 0) err = f(run_fwd_persist_ranks<float>);
  if (rtype == 1) err = f(run_fwd_persist_ranks<__nv_bfloat16>);
  if (err == 0) ++*launches;
  return err;
}

// K16 at D ranks as the persistent reverse kernel (bf16 compute): as
// tp_seq_bwd_ranks_launch, with U (N, 4nd) in bf16 untransposed (16-byte
// aligned), dgx a (2, B, 4nd) bf16 scratch, (units, rows) from
// ops/cuda_tp_seq.py:ranks_bwd_plan (32 or 64 units; 16, 32 or 64 rows,
// rows * units <= 2048) and group g's row_blocks[g] in place of a block
// count. Every block must be resident at once.
extern "C" int tp_seq_bwd_persist_ranks_launch(
    int rtype, int groups, const int* ranks, const int* row_blocks,
    const void* const* U, const void* const* gseq, const void* const* cprev,
    const void* const* cT, const void* const* dhseq, const void* const* dhT,
    void* const* dc, void* const* dg, void* const* dgx, void* const* dh0,
    int D, void* const* bufs, long long r_off, unsigned long long base, int S,
    int B, int N, int nd, int units, int rows, int standard, void* stream,
    int* launches) {
  const auto f = [&](auto run) {
    return run(groups, ranks, row_blocks, U, gseq, cprev, cT, dhseq, dhT, dc,
               dg, dgx, dh0, D, bufs, r_off, base, S, B, N, nd, units, rows,
               standard, static_cast<cudaStream_t>(stream));
  };
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (rtype == 0) err = f(run_bwd_persist_ranks<float>);
  if (rtype == 1) err = f(run_bwd_persist_ranks<__nv_bfloat16>);
  if (err == 0) ++*launches;
  return err;
}

// Bytes of dynamic shared memory a block of the persistent D-rank backward
// takes (ops/cuda_tp_seq.py:ranks_bwd_smem_bytes mirrors it).
extern "C" size_t tp_seq_bwd_persist_smem_bytes(int nd, int units, int rows) {
  return bwd_x_smem_bytes(nd, units, rows);
}
