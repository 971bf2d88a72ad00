// Tensor-parallel LSTM kernels for Hopper (sm_90a), bound from Python
// through ctypes (eigen_lstm_tpu_torch/ops/cuda_tp_cell.py and
// cuda_tp_seq.py). No PyTorch headers. Under gate-sharded tensor
// parallelism over D devices, device d holds U_d (N, 4nd), nd = N / D: the
// columns of the gates [i|o|f|u] of its own nd hidden units
// (parallel/tp.py), and every step needs the full h_{t-1} (B, N).
//
// Replaces four TPU kernels:
//   tp_step_fwd_launch (K13) <- pallas_tp_cell.py:_step_fwd_kernel (:72):
//       one step, g = xw + round(h_full) @ U_d (xw fp32 with the bias,
//       h_full and U_d in the compute type, fp32 sums), sigma on [i|o|f],
//       tanh on u, the cell update of _cell_fwd; out h2, c2 (B, nd) and the
//       activated g (B, 4nd), all fp32. Under bf16 compute with B <= 128
//       it is the tensor-core step of fwd_mma.cuh (tp_step_fwd_mma, below;
//       ops/cuda_tp_cell.py:tp_step_plan chooses it), under fp32 compute
//       with B <= 128 one step of the fp32 persistent forward
//       (lstm_tp_step_f32.cu: tp_step_fwd_f32_launch), elsewhere (the
//       shapes neither plan takes) the CUDA-core step tile (tp_step_fwd).
//   tp_step_bwd_launch (K14) <- pallas_tp_cell.py:_step_bwd_kernel (:82):
//       the gate backward _gate_bwd of one step, elementwise: from g, c2,
//       c_prev, dh, dc (fp32) to dg (B, 4nd) and dc_prev (B, nd), fp32.
//   tp_seq_fwd_launch (K15) <- pallas_tp_seq.py:_fwd_kernel (:59): the
//       whole S-step window in one launch, at D = 1 (at D > 1 see
//       tp_seq_fwd_ranks_launch below). Each step rounds the
//       carried h and c to the param type (fp32 here), stores h_seq in the
//       param type, g and c_prev in the residual type, and hands h on to
//       the next step through the exchange buffer in the compute type.
//       Under bf16 compute, where ops/cuda_cell_tiled.py:split_fwd_plan
//       gives a layout, it is the persistent tensor-core forward of
//       fwd_mma.cuh (fwd_persist with K15's streams: xw fp32, h_seq fp32,
//       c_prev = c_{t-1}; U's rows in shared memory, mma.sync, a share of
//       the batch rows a block); under fp32 compute, where
//       split_fwd_f32_plan gives one, K9's fp32 persistent kernel in K15's
//       mode (lstm_tp_f32.cu: tp_seq_fwd_f32_launch); elsewhere the
//       cooperative design below.
//   tp_seq_bwd_launch (K16) <- pallas_tp_seq.py:_bwd_kernel (:125): the
//       reverse window in one launch, at D = 1 (at D > 1 see
//       tp_seq_bwd_ranks_launch): dh_t = dh_seq[t] + (dhT at
//       t = S-1, else round(dg_{t+1}) @ U^T), the gate backward, dg in fp32;
//       then dh0 = round(dg_0) @ U^T and dc0. This is K16's design for the
//       shapes K6's persistent layouts do not take; elsewhere K16 is K6's
//       persistent kernel of its type, the same recurrence with U in
//       shared memory (ops/cuda_cell_bwd.py: k6_plan, lstm_bwd.cu, dh_rec
//       on tensor cores; k6_f32_plan, lstm_bwd_f32.cu, on CUDA cores): at
//       the bench's shapes 0.93 ms in bf16 and 1.76 in fp32 against this
//       design's 4.2 and 4.0 (PERF.md).
//   K15 and K16 at D > 1 <- the same two kernels with their in-kernel
//       exchange (pallas_tp_seq.py:96-120, :150-177): the remote copies
//       written as stores into the peers' exchange buffers and a flag a step
//       raised at system scope (exchange.cuh), in place of the grid barrier.
//       Where ops/cuda_tp_seq.py's planners give a layout, the persistent
//       designs of the compute type: in bf16 those of lstm_tp_persist.cu
//       (tp_seq_fwd_persist_ranks_launch: fwd_mma.cuh's persistent forward
//       with the exchange as its step's end; tp_seq_bwd_persist_ranks_launch:
//       K6's persistent reverse step with the reduce-scatter inside), in
//       fp32 their CUDA-core counterparts of lstm_tp_f32.cu and
//       lstm_tp_f32_bwd.cu; elsewhere (shapes no layout takes) the
//       cooperative CUDA-core tiles (tp_seq_fwd_ranks_launch,
//       tp_seq_bwd_ranks_launch). One launch
//       holds one rank group on each of D cards (the peers' buffers mapped
//       through CUDA IPC, csrc/exchange.cu), or D rank groups on one card,
//       the same device code over the card's D buffers. Only the one-card
//       launch has run: multi-card runs and NVLink's system-scope ordering
//       are unverified.
// K13 and K14 run at any D (the all-gather of h sits between launches, in
// torch.distributed).
//
// What bounds them on the H100. K13 at the flagship's shapes (B = 128,
// N = 1024, D = 1) is 2*B*N*4nd = 1.07 GFLOP against ~14 MB that it must
// move (U_d once, h_full, xw, c, the outputs): bytes bound it at 4.3 us in
// bf16, operations at 16 us in fp32. K14 moves ~4 MB and computes little: bytes
// bound it, ~1.2 us. K15 and K16 at the bench's (S = 100, B = 128,
// N = nd = 512) are 2*S*B*N*4nd = 26.8 GFLOP each (K16: dh_rec only, dU is
// a product outside) against 60-80 MB: operations, 27 us in bf16 and
// 400 us in fp32 (the formulas are in chip_smoke.py, phase 11a). At D
// ranks the D shards' inputs, outputs and work sum to the same, so the
// bound is the same. The exchange is neither input nor output: a rank
// stores (S - 1) * (D - 1) * B * nd elements of h in the compute type
// (K15) and S * (D - 1) * B * nd fp32 partials (K16) into its peers'
// buffers, in L2 on one card, over NVLink on D cards
// (chip_smoke.py:exchange_bytes).
//
// Design (simple and right first): the step tiles of K2 and K3
// (common.cuh's gate_sums_tile and rec_tile, with cell and gate_bwd) with
// the shard's widths: a block owns 32 hidden units of the shard (one
// warp's lanes, so U rows are read coalesced) with all four gate columns,
// and kBT batch rows; its kKS warps split the N-long reduction over h and
// meet in shared memory, and the epilogue runs in registers. K13 is one
// launch a step, a block a tile; that design reads U_d from L2 once per 4
// batch rows (32 times a step at B = 128, ~256 MB at the flagship's D = 1
// in bf16, ~512 MB in fp32), so K13 takes the tensor-core step under bf16
// compute and the fp32 step (lstm_tp_step_f32.cu) under fp32 instead,
// whose blocks own all the batch rows or a large share of them. K15 and
// K16 are one cooperative launch a
// window, a grid of at most what is resident at once, each block walking
// the tiles, with a grid barrier between steps; K15 alternates two h
// buffers (a step reads one, writes the other; after the barrier no block
// reads what the next step writes), where the TPU kernel needs three for
// its one-step lead between devices. U_d stays in L2 across the window
// (0.5 MB in bf16 at the bench's shapes, of 50 MB) rather than in shared
// memory; K16 reads U^T (4nd, N) so that the lanes read coalesced, as K3
// does. Wherever their plans give a layout both take the persistent
// designs named above, with U's rows in shared memory; the shapes no plan
// takes keep these. At D > 1 those shapes keep these tiles with the
// exchange: K15's tile sums in K15's order
// at D = 1 (a unit's order depends on N and kKS, not nd), so its fp32
// forward is the D = 1 design's bit for bit; K16 runs two phases a reverse
// step (the partial over all N columns into the owners' chunks, then each
// rank's sum of its D chunks in rank order and the gate backward), a rank
// barrier and an exchange a step. Under bf16 compute at D > 1 the
// persistent designs (lstm_tp_persist.cu) keep U_r's rows in shared memory and run the
// products on tensor cores, with the exchange in place of the grid barrier;
// the D = 1 instantiations of fwd_mma.cuh and lstm_bwd.cu are the same
// device code. The groups of a launch wait on each other, so every block
// must be resident: the launchers refuse more.
// Every sum has a fixed order, so the kernels are deterministic.

#include <cooperative_groups.h>

#include "common.cuh"
#include "exchange.cuh"
#include "fwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// The activated gates of tile (bx, by) of a shard: common.cuh's
// gate_sums_tile over the full h (K = N) against the shard's 4nd columns,
// plus xw, then sigma on [i|o|f] and tanh on u. Warp r < kBT returns true
// for row b0 + r < B with gate[g] at column g*nd + j.
template <typename CT>
__device__ __forceinline__ bool
fwd_tile(const CT* __restrict__ U,      // (N, 4nd)
         const float* __restrict__ xw,  // (B, 4nd) fp32, bias folded in
         const CT* __restrict__ h,      // (B, N), the full h_{t-1}
         int B, int N, int nd, int bx, int by, float gate[4], int* b,
         int* j) {
  if (!gate_sums_tile<CT, CT>(U, h, B, N, nd, bx, by, gate, b, j)) return false;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float s = gate[g] + xw[(size_t)*b * 4 * nd + (size_t)g * nd + *j];
    gate[g] = g < 3 ? sigmoid(s) : tanhf(s);
  }
  return true;
}

// K13: one step, a block a tile. grid = (nd / 32, ceil(B / kBT)),
// block = (32, kKS).
template <typename CT>
__global__ void __launch_bounds__(kLanes * kKS)
tp_step_fwd(const CT* __restrict__ U, const float* __restrict__ xw,
            const CT* __restrict__ h, const float* __restrict__ c_in,
            float* __restrict__ h_out, float* __restrict__ c_out,
            float* __restrict__ g_out, int B, int N, int nd, int standard) {
  float gate[4];
  int b, j;
  if (!fwd_tile<CT>(U, xw, h, B, N, nd, blockIdx.x, blockIdx.y, gate, &b, &j))
    return;
  const size_t idx = (size_t)b * nd + j;
  float hv, cv;
  cell(gate, c_in[idx], standard, &hv, &cv);
  h_out[idx] = hv;
  c_out[idx] = cv;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    g_out[(size_t)b * 4 * nd + (size_t)g * nd + j] = gate[g];
}

// K13 under bf16 compute (ops/cuda_tp_cell.py:tp_step_plan chooses it):
// fwd_mma.cuh's tensor-core step with the shard's widths. A block owns
// kFUnits = 16 units j0.. of the shard with their four gate columns (gate
// stride nd) and `rows` batch rows b0.. (a multiple of 16, rows past B
// zero-filled), so the grid is (nd / 16, ceil(B / rows)) and each step
// reads U_d ceil(B / rows) times over the grid, against 32 times in the
// CUDA-core design (whose blocks own 4 rows); the contraction runs over the
// full h (K = N), U streamed through the ring beside the h chunks (one step
// has nothing to hold it for). The epilogue runs in the owners' registers
// and writes h2, c2 and the activated g in fp32, two units a store.
__global__ void __launch_bounds__(kFThreads, 1)
tp_step_fwd_mma(const __nv_bfloat16* __restrict__ U,  // (N, 4nd)
                const float* __restrict__ xw,         // (B, 4nd)
                const __nv_bfloat16* __restrict__ h,  // (B, N)
                const float* __restrict__ c_in, float* __restrict__ h_out,
                float* __restrict__ c_out, float* __restrict__ g_out, int B,
                int N, int nd, int rows, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const FwdTile f = fwd_mma_tile(N, nd, blockIdx.x * kFUnits, blockIdx.y * rows, B, rows);
  const size_t n4 = 4 * (size_t)nd;
  float pin[8][4];
  if (f.owner)
    fwd_inputs<float>(f, [&](int b) { return xw + (size_t)b * n4; }, pin);
  float acc[8][4];
  fwd_products(f, U, h, nullptr, 0, ring, acc);
  if (!f.owner) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int b = fwd_row(f, hh);
    if (b >= B) continue;
#pragma unroll
    for (int uh = 0; uh < 2; ++uh) {
      const int j = fwd_unit(f, uh, 0);
      const size_t idx = (size_t)b * nd + j;
      const float2 cp = *reinterpret_cast<const float2*>(c_in + idx);
      float gate[2][4], hv[2], cv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          const float s = acc[2 * gt + uh][2 * hh + e] + pin[4 * hh + 2 * uh + e][gt];
          gate[e][gt] = gt < 3 ? sigmoid(s) : tanhf(s);
        }
        cell(gate[e], e ? cp.y : cp.x, standard, &hv[e], &cv[e]);
      }
      *reinterpret_cast<float2*>(h_out + idx) = make_float2(hv[0], hv[1]);
      *reinterpret_cast<float2*>(c_out + idx) = make_float2(cv[0], cv[1]);
#pragma unroll
      for (int gt = 0; gt < 4; ++gt)
        *reinterpret_cast<float2*>(g_out + (size_t)b * n4 + (size_t)gt * nd + j) =
            make_float2(gate[0][gt], gate[1][gt]);
    }
  }
}

// K14: the gate backward of one step, a thread an element (b, j).
__global__ void __launch_bounds__(256)
tp_step_bwd(const float* __restrict__ g, const float* __restrict__ c2,
            const float* __restrict__ c_prev, const float* __restrict__ dh,
            const float* __restrict__ dc, float* __restrict__ dg,
            float* __restrict__ dc_prev, int B, int nd, int standard) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)B * nd) return;
  const size_t b = e / nd, j = e % nd;
  const size_t gb = b * 4 * nd + j;
  float d[4];
  gate_bwd(g[gb], g[gb + nd], g[gb + 2 * (size_t)nd], g[gb + 3 * (size_t)nd],
           c2[e], c_prev[e], dh[e], dc[e], standard, d, &dc_prev[e]);
#pragma unroll
  for (int q = 0; q < 4; ++q) dg[gb + (size_t)q * nd] = d[q];
}

// K15: the window at D = 1 (N == nd). hbuf (2, B, N) in the compute type
// holds h0 in slot 0 on entry; c (B, nd) fp32 holds c0 and is carried in
// place (each element belongs to one thread). Step t reads slot t % 2 and
// writes slot (t + 1) % 2; a grid barrier separates the steps.
template <typename CT, typename RT>
__global__ void __launch_bounds__(kLanes * kKS)
tp_seq_fwd(const CT* __restrict__ U, const float* __restrict__ xw,
           CT* __restrict__ hbuf, float* __restrict__ c,
           float* __restrict__ hseq, RT* __restrict__ gseq,
           RT* __restrict__ cprev, float* __restrict__ hT,
           float* __restrict__ cT, int S, int B, int N, int nd, int standard) {
  const int tiles_x = nd / kLanes;
  const int tiles = tiles_x * ((B + kBT - 1) / kBT);
  const size_t bn = (size_t)B * nd, bn4 = 4 * bn, bN = (size_t)B * N;
  for (int t = 0; t < S; ++t) {
    if (t > 0) cg::this_grid().sync();
    const CT* h_in = hbuf + (size_t)(t % 2) * bN;
    CT* h_next = hbuf + (size_t)((t + 1) % 2) * bN;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float gate[4];
      int b, j;
      if (!fwd_tile<CT>(U, xw + t * bn4, h_in, B, N, nd, tile % tiles_x,
                        tile / tiles_x, gate, &b, &j))
        continue;
      const size_t idx = (size_t)b * nd + j;
      const float cp = c[idx];
      cprev[t * bn + idx] = from_f32<RT>(cp);
      float hv, cv;
      cell(gate, cp, standard, &hv, &cv);
      hseq[t * bn + idx] = hv;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gseq[t * bn4 + (size_t)b * 4 * nd + (size_t)g * nd + j] =
            from_f32<RT>(gate[g]);
      c[idx] = cv;
      h_next[(size_t)b * N + j] = from_f32<CT>(hv);
      if (t == S - 1) {
        hT[idx] = hv;
        cT[idx] = cv;
      }
    }
  }
}

// K16: the reverse window at D = 1 (N == nd), then dh0. dc (B, nd) fp32
// holds dcT on entry and dc0 on exit; dg (S, B, 4nd) fp32 is the output.
// Reverse step t reads the whole dg_{t+1} (a barrier after step t + 1).
template <typename CT, typename RT>
__global__ void __launch_bounds__(kLanes * kKS)
tp_seq_bwd(const CT* __restrict__ UT, const RT* __restrict__ gseq,
           const RT* __restrict__ cprev, const float* __restrict__ cT,
           const float* __restrict__ dhseq, const float* __restrict__ dhT,
           float* __restrict__ dc, float* __restrict__ dg,
           float* __restrict__ dh0, int S, int B, int N, int nd,
           int standard) {
  const int tiles_x = N / kLanes;
  const int tiles = tiles_x * ((B + kBT - 1) / kBT);
  const size_t bn = (size_t)B * nd, bn4 = 4 * bn;
  for (int t = S - 1; t >= -1; --t) {
    if (t < S - 1) cg::this_grid().sync();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float rec;
      int b, j;
      if (t == S - 1) {
        // no product: dh_rec is dhT
        b = (tile / tiles_x) * kBT + threadIdx.y;
        j = (tile % tiles_x) * kLanes + threadIdx.x;
        if (threadIdx.y >= kBT || b >= B) continue;
        rec = dhT[(size_t)b * nd + j];
      } else if (!rec_tile<CT>(UT, dg + (t + 1) * bn4, B, N, 4 * nd,
                               tile % tiles_x, tile / tiles_x, &rec, &b, &j)) {
        continue;
      }
      const size_t idx = (size_t)b * nd + j;
      if (t == -1) {
        dh0[idx] = rec;
        continue;
      }
      const size_t gb = t * bn4 + (size_t)b * 4 * nd + j;
      const float ct = t == S - 1 ? cT[idx] : to_f32(cprev[(t + 1) * bn + idx]);
      float d[4];
      gate_bwd(to_f32(gseq[gb]), to_f32(gseq[gb + nd]),
               to_f32(gseq[gb + 2 * (size_t)nd]),
               to_f32(gseq[gb + 3 * (size_t)nd]), ct,
               to_f32(cprev[t * bn + idx]), dhseq[t * bn + idx] + rec, dc[idx],
               standard, d, &dc[idx]);
#pragma unroll
      for (int q = 0; q < 4; ++q) dg[gb + (size_t)q * nd] = d[q];
    }
  }
}

// ---------------------------------------------------------------------------
// K15 and K16 at D > 1, the cooperative design (fp32 compute, and shapes the
// persistent designs below do not take): K13's and K3's CUDA-core tiles with
// the exchange of exchange.cuh in place of the grid barrier.
template <typename CT, typename RT>
struct SeqFwdGroup {
  const CT* U;      // (N, 4nd), the rank's shard
  const float* xw;  // (S, B, 4nd)
  float* c;         // (B, nd) c0 on entry, the carry
  float* hseq;      // (S, B, nd)
  RT* gseq;         // (S, B, 4nd)
  RT* cprev;        // (S, B, nd)
  float* hT;
  float* cT;
  int rank, first;
};

template <typename CT, typename RT>
struct SeqFwdRanks {
  SeqFwdGroup<CT, RT> g[kMaxRanks];
};

// K15 at D ranks: the window of every group's rank, K15's tile (the same
// sums as the D = 1 cooperative design: a unit's order depends on N and
// kKS, not on nd). Step t reads the full h_{t-1} from its own slot
// (base + t) % 3 through L2, and stores its tile of h_t, rounded to the
// compute type, into slot (base + t + 1) % 3, columns [me * nd, +nd), of
// every rank's buffer, its own too; then the exchange. The last step
// exchanges nothing. The host copies h0 into slot base % 3 first. Three
// slots: a rank waits for every peer's flag of step t before step t + 1,
// so no rank writes a slot a peer still reads.
template <typename CT, typename RT>
__global__ void __launch_bounds__(kLanes * kKS)
tp_seq_fwd_x(const SeqFwdRanks<CT, RT> a, int groups, const PeerTable peers,
             int D, unsigned long long base, long long h_off, int S, int B,
             int N, int nd, int standard) {
  int nb;
  const SeqFwdGroup<CT, RT> G = a.g[my_group(a.g, groups, &nb)];
  const int bi = static_cast<int>(blockIdx.x) - G.first;
  const int me = G.rank;
  unsigned char* mine = peers.buf[me];
  const int tiles_x = nd / kLanes;
  const int tiles = tiles_x * ((B + kBT - 1) / kBT);
  const size_t bn = (size_t)B * nd, bn4 = 4 * bn, bN = (size_t)B * N;
  for (int t = 0; t < S; ++t) {
    const CT* h_in = reinterpret_cast<const CT*>(mine + h_off) + ((base + t) % 3) * bN;
    const size_t next = ((base + t + 1) % 3) * bN + (size_t)me * nd;
    for (int tile = bi; tile < tiles; tile += nb) {
      float gate[4];
      int b, j;
      if (!gate_sums_tile<CT, CT, true>(G.U, h_in, B, N, nd, tile % tiles_x,
                                        tile / tiles_x, gate, &b, &j))
        continue;
      const size_t idx = (size_t)b * nd + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float v = gate[g] + G.xw[t * bn4 + (size_t)b * 4 * nd + (size_t)g * nd + j];
        gate[g] = g < 3 ? sigmoid(v) : tanhf(v);
      }
      const float cp = G.c[idx];
      G.cprev[t * bn + idx] = from_f32<RT>(cp);
      float hv, cv;
      cell(gate, cp, standard, &hv, &cv);
      G.hseq[t * bn + idx] = hv;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        G.gseq[t * bn4 + (size_t)b * 4 * nd + (size_t)g * nd + j] = from_f32<RT>(gate[g]);
      G.c[idx] = cv;
      if (t < S - 1) {
        const CT hc = from_f32<CT>(hv);
        for (int q = 0; q < D; ++q)
          reinterpret_cast<CT*>(peers.buf[q] + h_off)[next + (size_t)b * N + j] = hc;
      } else {
        G.hT[idx] = hv;
        G.cT[idx] = cv;
      }
    }
    if (t < S - 1)
      exchange(peers, me, D, kFwdFlag, words(mine, kFwdBar), nb,
               static_cast<unsigned>(base + t + 1));
  }
}

template <typename CT, typename RT>
struct SeqBwdGroup {
  const CT* UT;         // (4nd, N), the rank's shard transposed
  const RT* gseq;       // (S, B, 4nd)
  const RT* cprev;      // (S, B, nd)
  const float* cT;      // (B, nd)
  const float* dhseq;   // (S, B, nd)
  const float* dhT;     // (B, nd)
  float* dc;            // (B, nd) dcT on entry, dc0 on exit
  float* dg;            // (S, B, 4nd)
  float* dh0;           // (B, nd)
  int rank, first;
};

template <typename CT, typename RT>
struct SeqBwdRanks {
  SeqBwdGroup<CT, RT> g[kMaxRanks];
};

// K16 at D ranks. Reverse step t < S - 1 (and t = -1, dh0) first has every
// block of the rank compute rec_tile's partial round(dg_{t+1}) @ U_r^T over
// all N columns (after a rank barrier: dg_{t+1} is the rank's whole last
// step), column j going to rank q = j / nd, chunk [w][me] of q's buffer,
// w = (base + e) % 3 for the window's e-th exchange, e = S - 2 - t; then
// the exchange; then each rank sums its D chunks in rank order 0..D-1
// (pallas_tp_seq.py:140's jnp.sum(rbuf[w], axis=0)) into dh_rec, an
// element a thread, and runs the gate backward (at t = S - 1 dh_rec is
// dhT, at t = -1 the sum is dh0). Three slots for the same reason as the
// forward's.
template <typename CT, typename RT>
__global__ void __launch_bounds__(kLanes * kKS)
tp_seq_bwd_x(const SeqBwdRanks<CT, RT> a, int groups, const PeerTable peers,
             int D, unsigned long long base, long long r_off, int S, int B,
             int N, int nd, int standard) {
  int nb;
  const SeqBwdGroup<CT, RT> G = a.g[my_group(a.g, groups, &nb)];
  const int bi = static_cast<int>(blockIdx.x) - G.first;
  const int me = G.rank;
  unsigned char* mine = peers.buf[me];
  const int tiles_x = N / kLanes;
  const int tiles = tiles_x * ((B + kBT - 1) / kBT);
  const size_t bn = (size_t)B * nd, bn4 = 4 * bn;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int t = S - 1; t >= -1; --t) {
    int w = 0;
    if (t < S - 1) {
      const unsigned long long e = base + (S - 2 - t);
      w = static_cast<int>(e % 3);
      rank_barrier(words(mine, kBwdBar), nb);
      for (int tile = bi; tile < tiles; tile += nb) {
        float rec;
        int b, j;
        if (!rec_tile<CT, true>(G.UT, G.dg + (t + 1) * bn4, B, N, 4 * nd,
                                tile % tiles_x, tile / tiles_x, &rec, &b, &j))
          continue;
        const int q = j / nd;
        float* chunk = reinterpret_cast<float*>(peers.buf[q] + r_off) +
                       ((size_t)w * D + me) * bn;
        chunk[(size_t)b * nd + (j - q * nd)] = rec;
      }
      exchange(peers, me, D, kBwdFlag, words(mine, kBwdBar), nb,
               static_cast<unsigned>(e + 1));
    }
    const float* chunks = reinterpret_cast<const float*>(mine + r_off) + (size_t)w * D * bn;
    for (size_t idx = (size_t)bi * kLanes * kKS + tid; idx < bn;
         idx += (size_t)nb * kLanes * kKS) {
      float rec;
      if (t == S - 1) {
        rec = G.dhT[idx];
      } else {
        rec = __ldcg(chunks + idx);
        for (int q = 1; q < D; ++q) rec += __ldcg(chunks + (size_t)q * bn + idx);
      }
      if (t == -1) {
        G.dh0[idx] = rec;
        continue;
      }
      const size_t b = idx / nd, j = idx % nd;
      const size_t gb = t * bn4 + b * 4 * nd + j;
      const float ct = t == S - 1 ? G.cT[idx] : to_f32(G.cprev[(t + 1) * bn + idx]);
      float d[4];
      gate_bwd(to_f32(G.gseq[gb]), to_f32(G.gseq[gb + nd]),
               to_f32(G.gseq[gb + 2 * (size_t)nd]),
               to_f32(G.gseq[gb + 3 * (size_t)nd]), ct,
               to_f32(G.cprev[t * bn + idx]), G.dhseq[t * bn + idx] + rec,
               G.dc[idx], standard, d, &G.dc[idx]);
#pragma unroll
      for (int q = 0; q < 4; ++q) G.dg[gb + (size_t)q * nd] = d[q];
    }
  }
}

// The grid of a cooperative launch of `kernel`: the tiles, at most what is
// resident at once (a grid barrier waits for every block). 0 and an error
// code when the card cannot take it.
template <typename K>
int coop_grid(K kernel, int tiles, int* grid) {
  int resident = 0;
  const int err = resident_with(kernel, kLanes * kKS, 0, &resident);
  if (err == 0) *grid = tiles < resident ? tiles : resident;
  return err;
}

template <typename CT>
int run_step_fwd(const void* U, const void* xw, const void* h,
                 const void* c_in, void* h_out, void* c_out, void* g_out,
                 int B, int N, int nd, int standard, cudaStream_t stream) {
  const dim3 grid(nd / kLanes, (B + kBT - 1) / kBT);
  tp_step_fwd<CT><<<grid, dim3(kLanes, kKS), 0, stream>>>(
      static_cast<const CT*>(U), static_cast<const float*>(xw),
      static_cast<const CT*>(h), static_cast<const float*>(c_in),
      static_cast<float*>(h_out), static_cast<float*>(c_out),
      static_cast<float*>(g_out), B, N, nd, standard);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core K13: U, h in bf16, `rows` batch rows a block.
int run_step_fwd_mma(const void* U, const void* xw, const void* h,
                     const void* c_in, void* h_out, void* c_out, void* g_out,
                     int B, int N, int nd, int rows, int standard,
                     cudaStream_t stream) {
  if (N % kFKC != 0 || nd % kFUnits != 0 || B < 1 || rows < 16 ||
      rows > kFMaxRows || rows % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem_bytes(rows, 0);
  cudaError_t err = cudaFuncSetAttribute(
      tp_step_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nd / kFUnits, (B + rows - 1) / rows);
  tp_step_fwd_mma<<<grid, kFThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(U), static_cast<const float*>(xw),
      static_cast<const __nv_bfloat16*>(h), static_cast<const float*>(c_in),
      static_cast<float*>(h_out), static_cast<float*>(c_out),
      static_cast<float*>(g_out), B, N, nd, rows, standard);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, typename RT>
int run_seq_fwd(const void* U, const void* xw, void* hbuf, void* c,
                void* hseq, void* gseq, void* cprev, void* hT, void* cT,
                int S, int B, int N, int nd, int standard,
                cudaStream_t stream) {
  const auto kernel = tp_seq_fwd<CT, RT>;
  int grid = 0;
  const int err = coop_grid(kernel, (nd / kLanes) * ((B + kBT - 1) / kBT), &grid);
  if (err != 0) return err;
  const CT* u = static_cast<const CT*>(U);
  const float* x = static_cast<const float*>(xw);
  CT* hb = static_cast<CT*>(hbuf);
  float* cc = static_cast<float*>(c);
  float* hs = static_cast<float*>(hseq);
  RT* gs = static_cast<RT*>(gseq);
  RT* cs = static_cast<RT*>(cprev);
  float* ht = static_cast<float*>(hT);
  float* ct = static_cast<float*>(cT);
  void* args[] = {&u, &x, &hb, &cc, &hs, &gs, &cs, &ht, &ct,
                  &S, &B, &N, &nd, &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kLanes, kKS),
      args, 0, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

template <typename CT, typename RT>
int run_seq_bwd(const void* UT, const void* gseq, const void* cprev,
                const void* cT, const void* dhseq, const void* dhT, void* dc,
                void* dg, void* dh0, int S, int B, int N, int nd,
                int standard, cudaStream_t stream) {
  const auto kernel = tp_seq_bwd<CT, RT>;
  int grid = 0;
  const int err = coop_grid(kernel, (N / kLanes) * ((B + kBT - 1) / kBT), &grid);
  if (err != 0) return err;
  const CT* ut = static_cast<const CT*>(UT);
  const RT* gs = static_cast<const RT*>(gseq);
  const RT* cs = static_cast<const RT*>(cprev);
  const float* ct = static_cast<const float*>(cT);
  const float* dhs = static_cast<const float*>(dhseq);
  const float* dht = static_cast<const float*>(dhT);
  float* dcc = static_cast<float*>(dc);
  float* dgs = static_cast<float*>(dg);
  float* d0 = static_cast<float*>(dh0);
  void* args[] = {&ut, &gs, &cs, &ct, &dhs, &dht, &dcc, &dgs, &d0,
                  &S, &B, &N, &nd, &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kLanes, kKS),
      args, 0, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

template <typename CT, typename RT>
int run_seq_fwd_ranks(int groups, const int* ranks, const int* blocks,
                      const void* const* U, const void* const* xw,
                      const void* const* h0, void* const* c, void* const* hseq,
                      void* const* gseq, void* const* cprev, void* const* hT,
                      void* const* cT, int D, void* const* bufs, long long h_off,
                      unsigned long long base, int S, int B, int N, int nd,
                      int standard, cudaStream_t stream) {
  if (nd % kLanes != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = tp_seq_fwd_x<CT, RT>;
  int resident = 0;
  int err = resident_with(kernel, kLanes * kKS, 0, &resident);
  if (err != 0) return err;
  SeqFwdRanks<CT, RT> a{};
  PeerTable peers{};
  int first[kMaxRanks];
  const int grid = ranks_grid(groups, ranks, blocks, D, bufs, N, nd, resident,
                              first, &peers);
  if (grid < 0) return -grid;
  for (int g = 0; g < groups; ++g)
    a.g[g] = SeqFwdGroup<CT, RT>{
        static_cast<const CT*>(U[g]), static_cast<const float*>(xw[g]),
        static_cast<float*>(c[g]), static_cast<float*>(hseq[g]),
        static_cast<RT*>(gseq[g]), static_cast<RT*>(cprev[g]),
        static_cast<float*>(hT[g]), static_cast<float*>(cT[g]), ranks[g],
        first[g]};
  err = copy_h0(groups, ranks, h0, peers, h_off, base, (size_t)B * N * sizeof(CT), stream);
  if (err != 0) return err;
  void* args[] = {&a, &groups, &peers, &D, &base, &h_off, &S, &B, &N, &nd,
                  &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kLanes, kKS),
      args, 0, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

template <typename CT, typename RT>
int run_seq_bwd_ranks(int groups, const int* ranks, const int* blocks,
                      const void* const* UT, const void* const* gseq,
                      const void* const* cprev, const void* const* cT,
                      const void* const* dhseq, const void* const* dhT,
                      void* const* dc, void* const* dg, void* const* dh0, int D,
                      void* const* bufs, long long r_off, unsigned long long base,
                      int S, int B, int N, int nd, int standard,
                      cudaStream_t stream) {
  if (nd % kLanes != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = tp_seq_bwd_x<CT, RT>;
  int resident = 0;
  const int err = resident_with(kernel, kLanes * kKS, 0, &resident);
  if (err != 0) return err;
  SeqBwdRanks<CT, RT> a{};
  PeerTable peers{};
  int first[kMaxRanks];
  const int grid = ranks_grid(groups, ranks, blocks, D, bufs, N, nd, resident,
                              first, &peers);
  if (grid < 0) return -grid;
  for (int g = 0; g < groups; ++g)
    a.g[g] = SeqBwdGroup<CT, RT>{
        static_cast<const CT*>(UT[g]), static_cast<const RT*>(gseq[g]),
        static_cast<const RT*>(cprev[g]), static_cast<const float*>(cT[g]),
        static_cast<const float*>(dhseq[g]), static_cast<const float*>(dhT[g]),
        static_cast<float*>(dc[g]), static_cast<float*>(dg[g]),
        static_cast<float*>(dh0[g]), ranks[g], first[g]};
  void* args[] = {&a, &groups, &peers, &D, &base, &r_off, &S, &B, &N, &nd,
                  &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kLanes, kKS),
      args, 0, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// Type codes: 0 = fp32, 1 = bf16. Each launcher makes one launch and
// returns its error code (0: launched).
//
// K13. rows >= 0: the tensor-core design with `rows` batch rows a block
// (bf16 compute; ops/cuda_tp_cell.py:tp_step_plan gives rows; U and h
// 16-byte aligned, N a multiple of 64, nd of 16); -1: the CUDA-core
// design (the shapes no plan takes; fp32's step, where its plan gives a
// layout, is lstm_tp_step_f32.cu's launcher). Adds its launch to
// *launches.
extern "C" int tp_step_fwd_launch(int ctype, const void* U, const void* xw,
                                  const void* h, const void* c_in,
                                  void* h_out, void* c_out, void* g_out,
                                  int B, int N, int nd, int standard, int rows,
                                  void* stream, int* launches) {
  const auto s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (rows >= 0) {
    if (ctype == 1)
      err = run_step_fwd_mma(U, xw, h, c_in, h_out, c_out, g_out, B, N, nd,
                             rows, standard, s);
  } else if (ctype == 0) {
    err = run_step_fwd<float>(U, xw, h, c_in, h_out, c_out, g_out, B, N, nd,
                              standard, s);
  } else if (ctype == 1) {
    err = run_step_fwd<__nv_bfloat16>(U, xw, h, c_in, h_out, c_out, g_out, B,
                                      N, nd, standard, s);
  }
  if (err == 0) ++*launches;
  return err;
}

extern "C" int tp_step_bwd_launch(const void* g, const void* c2,
                                  const void* c_prev, const void* dh,
                                  const void* dc, void* dg, void* dc_prev,
                                  int B, int nd, int standard, void* stream) {
  const size_t n = (size_t)B * nd;
  tp_step_bwd<<<(unsigned)((n + 255) / 256), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(c2),
      static_cast<const float*>(c_prev), static_cast<const float*>(dh),
      static_cast<const float*>(dc), static_cast<float*>(dg),
      static_cast<float*>(dc_prev), B, nd, standard);
  return static_cast<int>(cudaGetLastError());
}

// K15. hbuf (2, B, N) in the compute type holds h0 in its first half; c
// (B, nd) fp32 holds c0 (the launch's scratch after); xw (S, B, 4nd) fp32.
// kres >= 0: the persistent design of fwd_mma.cuh (bf16 compute, D = 1 so
// nd == N; ops/cuda_cell_tiled.py:split_fwd_plan gives kres and rows, U and
// hbuf 16-byte aligned), then cT copied from its carry; -1: the cooperative
// CUDA-core design. Adds its launch to *launches.
extern "C" int tp_seq_fwd_launch(int ctype, int rtype, const void* U,
                                 const void* xw, void* hbuf, void* c,
                                 void* hseq, void* gseq, void* cprev,
                                 void* hT, void* cT, int S, int B, int N,
                                 int nd, int standard, int kres, int rows,
                                 void* stream, int* launches) {
  const auto s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (kres >= 0) {
    if (ctype != 1 || nd != N) return err;
    const auto f = [&](auto run) {
      return run(U, xw, nullptr, nullptr, nullptr, hbuf, static_cast<float*>(c),
                 static_cast<float*>(hT), hseq, cprev, gseq, nullptr,
                 Dropout{0, 0, 0, 0.0f}, S, B, N, rows, kres, standard, s,
                 launches);
    };
    if (rtype == 0) err = f(run_fwd_persist<float, false, true>);
    if (rtype == 1) err = f(run_fwd_persist<bf, false, true>);
    if (err == 0)
      err = static_cast<int>(cudaMemcpyAsync(cT, c, (size_t)B * N * sizeof(float),
                                             cudaMemcpyDeviceToDevice, s));
    return err;
  }
  const auto f = [&](auto run) {
    return run(U, xw, hbuf, c, hseq, gseq, cprev, hT, cT, S, B, N, nd,
               standard, s);
  };
  if (ctype == 0 && rtype == 0) err = f(run_seq_fwd<float, float>);
  if (ctype == 0 && rtype == 1) err = f(run_seq_fwd<float, bf>);
  if (ctype == 1 && rtype == 0) err = f(run_seq_fwd<bf, float>);
  if (ctype == 1 && rtype == 1) err = f(run_seq_fwd<bf, bf>);
  if (err == 0) ++*launches;
  return err;
}

extern "C" int tp_seq_bwd_launch(int ctype, int rtype, const void* UT,
                                 const void* gseq, const void* cprev,
                                 const void* cT, const void* dhseq,
                                 const void* dhT, void* dc, void* dg,
                                 void* dh0, int S, int B, int N, int nd,
                                 int standard, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [&](auto run) {
    return run(UT, gseq, cprev, cT, dhseq, dhT, dc, dg, dh0, S, B, N, nd,
               standard, s);
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_seq_bwd<float, float>);
  if (ctype == 0 && rtype == 1) return f(run_seq_bwd<float, bf>);
  if (ctype == 1 && rtype == 0) return f(run_seq_bwd<bf, float>);
  if (ctype == 1 && rtype == 1) return f(run_seq_bwd<bf, bf>);
  return static_cast<int>(cudaErrorInvalidValue);
}


// K15 and K16 at D ranks (the exchange designs). `groups` rank groups in
// one cooperative launch, group g playing rank ranks[g] with blocks[g]
// blocks; each per-group pointer array holds that group's tensors (the
// shapes of tp_seq_fwd_launch and tp_seq_bwd_launch, N = D * nd, U^T for
// the backward). bufs holds every rank's exchange buffer by rank, as this
// process maps it; h_off and r_off are its offsets (exchange_layout in
// ops/cuda_tp_seq.py); base is the host's count of exchange steps of the
// buffers before this call (it rises by S a call). Every block must be
// resident at once: a sum of blocks past tp_seq_ranks_resident's count is
// refused (cudaErrorCooperativeLaunchTooLarge) before anything runs. The
// forward copies each group's h0 (B, N) into its rank's slot first. Each
// adds its launch to *launches.
extern "C" int tp_seq_fwd_ranks_launch(
    int ctype, int rtype, int groups, const int* ranks, const int* blocks,
    const void* const* U, const void* const* xw, const void* const* h0,
    void* const* c, void* const* hseq, void* const* gseq, void* const* cprev,
    void* const* hT, void* const* cT, int D, void* const* bufs,
    long long h_off, unsigned long long base, int S, int B, int N, int nd,
    int standard, void* stream, int* launches) {
  const auto f = [&](auto run) {
    return run(groups, ranks, blocks, U, xw, h0, c, hseq, gseq, cprev, hT, cT,
               D, bufs, h_off, base, S, B, N, nd, standard,
               static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (ctype == 0 && rtype == 0) err = f(run_seq_fwd_ranks<float, float>);
  if (ctype == 0 && rtype == 1) err = f(run_seq_fwd_ranks<float, bf>);
  if (ctype == 1 && rtype == 0) err = f(run_seq_fwd_ranks<bf, float>);
  if (ctype == 1 && rtype == 1) err = f(run_seq_fwd_ranks<bf, bf>);
  if (err == 0) ++*launches;
  return err;
}

extern "C" int tp_seq_bwd_ranks_launch(
    int ctype, int rtype, int groups, const int* ranks, const int* blocks,
    const void* const* UT, const void* const* gseq, const void* const* cprev,
    const void* const* cT, const void* const* dhseq, const void* const* dhT,
    void* const* dc, void* const* dg, void* const* dh0, int D,
    void* const* bufs, long long r_off, unsigned long long base, int S, int B,
    int N, int nd, int standard, void* stream, int* launches) {
  const auto f = [&](auto run) {
    return run(groups, ranks, blocks, UT, gseq, cprev, cT, dhseq, dhT, dc, dg,
               dh0, D, bufs, r_off, base, S, B, N, nd, standard,
               static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (ctype == 0 && rtype == 0) err = f(run_seq_bwd_ranks<float, float>);
  if (ctype == 0 && rtype == 1) err = f(run_seq_bwd_ranks<float, bf>);
  if (ctype == 1 && rtype == 0) err = f(run_seq_bwd_ranks<bf, float>);
  if (ctype == 1 && rtype == 1) err = f(run_seq_bwd_ranks<bf, bf>);
  if (err == 0) ++*launches;
  return err;
}

// The blocks of 256 threads one cooperative launch of the D-rank forward
// (bwd = 0) or backward (bwd = 1) may hold on the current card, into
// *resident; returns an error code.
extern "C" int tp_seq_ranks_resident(int bwd, int ctype, int rtype, int* resident) {
  const auto f = [&](auto fwd_kernel, auto bwd_kernel) {
    return bwd ? resident_with(bwd_kernel, kLanes * kKS, 0, resident)
               : resident_with(fwd_kernel, kLanes * kKS, 0, resident);
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(tp_seq_fwd_x<float, float>, tp_seq_bwd_x<float, float>);
  if (ctype == 0 && rtype == 1) return f(tp_seq_fwd_x<float, bf>, tp_seq_bwd_x<float, bf>);
  if (ctype == 1 && rtype == 0) return f(tp_seq_fwd_x<bf, float>, tp_seq_bwd_x<bf, float>);
  if (ctype == 1 && rtype == 1) return f(tp_seq_fwd_x<bf, bf>, tp_seq_bwd_x<bf, bf>);
  return static_cast<int>(cudaErrorInvalidValue);
}
