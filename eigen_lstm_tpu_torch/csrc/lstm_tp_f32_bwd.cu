// K16 at D ranks under fp32 compute for Hopper (sm_90a): K6's fp32
// persistent reverse step (lstm_bwd_f32.cuh) with the reduce-scatter
// inside, bound from Python through ctypes (ops/cuda_tp_seq.py). No
// PyTorch headers. Replaces pallas_tp_seq.py:_bwd_kernel (:125; the D > 1
// exchange :150-177) under fp32 compute, wherever ops/cuda_tp_seq.py:
// ranks_bwd_f32_plan gives a layout; elsewhere K16 keeps lstm_tp.cu's
// cooperative tiles (tp_seq_bwd_x). At D = 1 K16 under fp32 compute is
// lstm_bwd_f32_launch itself (K6's launch, its c_last = cT).
//
// Rank r holds U_r (N, 4nd), the columns of its nd units' four gates over
// all N rows. Its blocks form N / 16 groups of G blocks: group p0 = 16 g
// owns output units p0.. of all N (the rows p0.. of U_r), its block `part`
// the rank's gate columns part 4nd / G.., holding U_r's 16 rows over them
// in shared memory for the window (f32_load_u_rows). Reverse step t < S - 1
// (and t = -1, dh0):
//   1. the block's part of dg_{t+1} @ U_r^T for its 16 units
//      (f32_rec_splits: the rank's dg_{t+1} columns through the cp.async.cg
//      ring, the product split 8 ways over k in one order at every batch,
//      the splits added in split order); unit j's part goes to chunk
//      [w][me][part] of its owner rank j / nd, w = (base + e) % 3 for the
//      window's e-th exchange, e = S - 2 - t;
//   2. the exchange: every rank's parts for this rank are in;
//   3. the gate backward of the rank's own B x nd elements, a fixed share a
//      thread (element (bi * 256 + tid) + i * nb * 256, i < kGMax): dh_rec
//      the sum over the senders in rank order 0..D-1 (pallas_tp_seq.py:140's
//      jnp.sum(rbuf[w], axis=0)) of each sender's G parts added in part
//      order, dc carried in registers for the window, dg_t written in fp32
//      (the output, which the next step's product reads);
//   4. a rank barrier: dg_t is whole before any block of the rank reads it.
// At t = S - 1 dh_rec is dhT and 1-2 are skipped; after step 0 the product
// of dg_0, the exchange and the sum give dh0, and the carry dc0. So a step
// takes one rank barrier and one exchange, as the bf16 persistent design's
// (lstm_tp_persist.cu). At D = 1 the sums would be K6's fp32 persistent
// design's at the same G. The flags and slots are exchange.cuh's.
//
// G comes from (N, nd, D) and the SMs a rank group has on one card (the
// card's / D): the most of 4, 2, 1 whose N / 16 G blocks fit them
// (ops/cuda_tp_seq.py:ranks_bwd_f32_plan). G sets the sum order, so a rank
// on a card of its own takes the same G, and its bits are the one-card
// launch's. What bounds it on the H100: operations, 2 S B N 4N flops at 67
// TFLOP/s (0.40 ms at the bench's shapes); what holds it back is the
// recurrence, each block reading its columns of the rank's dg_{t+1} from
// L2 each step and meeting the exchange and the rank barrier.

#include "exchange.cuh"
#include "lstm_bwd_f32.cuh"

namespace {

constexpr int kGMax = 4;   // gate-backward elements a thread at most (B <= 16 D G)

template <typename RT>
struct F32BwdGroup {
  const float* U;       // (N, 4nd), the rank's shard
  const RT* gseq;       // (S, B, 4nd)
  const RT* cprev;      // (S, B, nd)
  const float* cT;      // (B, nd)
  const float* dhseq;   // (S, B, nd)
  const float* dhT;     // (B, nd)
  float* dc;            // (B, nd): dcT in, dc0 out
  float* dg;            // (S, B, 4nd)
  float* dh0;           // (B, nd)
  int rank, first;
};

template <typename RT>
struct F32BwdRanks {
  F32BwdGroup<RT> g[kMaxRanks];
};

template <typename RT, int RR, int STAGES>
__global__ void __launch_bounds__(kFThreads, 1)
tp_seq_bwd_f32_x(const __grid_constant__ F32BwdRanks<RT> a, int groups,
                 const __grid_constant__ PeerTable peers, int D,
                 unsigned long long base, long long r_off, int S, int B, int N,
                 int nd, int G, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  int nb;
  const F32BwdGroup<RT>& A = a.g[my_group(a.g, groups, &nb)];
  const int bi = static_cast<int>(blockIdx.x) - A.first;
  const int me = A.rank;
  const int K = 4 * nd, KG = K / G;            // the rank's gate columns, a block's
  const int part = bi % G, p0 = (bi / G) * kFUnits;
  float* Us = reinterpret_cast<float*>(smem);  // [k][unit of the group]
  float* ring = Us + (size_t)KG * kFUnits;
  const int tid = threadIdx.x;
  const size_t bn = (size_t)B * nd, bk = (size_t)B * K;
  unsigned char* mine = peers.buf[me];
  unsigned* bar = words(mine, kBwdBar);
  // the rank's dg (S, B, 4nd): written and read within the launch, so read
  // through L2 only (the product's ring)
  float* dg = A.dg;

  f32_load_u_rows(A.U, Us, K, KG, p0, part);

  // 1: the block's parts of dg[tn] @ U_r^T for its group's 16 units and
  // every row, into their owners' chunks [ws][me][part]
  const auto product = [&](int tn, int ws) {
    f32_rec_splits<RR, STAGES>(dg + (size_t)tn * bk + (size_t)part * KG, Us, ring, B,
                               K, KG);
    for (int e = tid; e < B * kFUnits; e += kFThreads) {
      const int b = e / kFUnits, uu = e % kFUnits;
      const int j = p0 + uu, owner = j / nd;
      float* chunk = reinterpret_cast<float*>(peers.buf[owner] + r_off) +
                     (((size_t)ws * D + me) * G + part) * bn;
      chunk[(size_t)b * nd + (j - owner * nd)] = f32_split_sum<RR>(ring, b, uu);
    }
  };

  // 3: this thread's gate-backward elements of the rank's B x nd
  const size_t g0 = (size_t)bi * kFThreads + tid, gstep = (size_t)nb * kFThreads;
  float dcr[kGMax], gin[kGMax][4], cin[kGMax], cpin[kGMax], dhin[kGMax];
#pragma unroll
  for (int i = 0; i < kGMax; ++i) {
    const size_t idx = g0 + i * gstep;
    dcr[i] = idx < bn ? A.dc[idx] : 0.0f;
  }
  const auto load_inputs = [&](int t) {
#pragma unroll
    for (int i = 0; i < kGMax; ++i) {
      const size_t idx = g0 + i * gstep;
      if (idx >= bn) continue;
      const size_t gb = t * bk + (idx / nd) * K + idx % nd;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) gin[i][gt] = to_f32(A.gseq[gb + (size_t)gt * nd]);
      cin[i] = t == S - 1 ? A.cT[idx] : to_f32(A.cprev[(t + 1) * bn + idx]);
      cpin[i] = to_f32(A.cprev[t * bn + idx]);
      dhin[i] = A.dhseq[t * bn + idx];
    }
  };
  // dh_rec of this thread's elements from slot ws: each sender's G parts in
  // part order, the senders in rank order (L2 only: peers wrote them)
  const auto chunk_sum = [&](int ws, float (&rec)[kGMax]) {
    const float* chunks = reinterpret_cast<const float*>(mine + r_off) +
                          (size_t)ws * D * G * bn;
#pragma unroll
    for (int i = 0; i < kGMax; ++i) {
      const size_t idx = g0 + i * gstep;
      float v = 0.0f;
      if (idx < bn) {
        for (int r = 0; r < D; ++r) {
          const float* sent = chunks + (size_t)r * G * bn + idx;
          float x = __ldcg(sent);
          for (int p = 1; p < G; ++p) x += __ldcg(sent + (size_t)p * bn);
          v = r == 0 ? x : v + x;
        }
      }
      rec[i] = v;
    }
  };

  load_inputs(S - 1);
  __syncthreads();  // U's rows are in
  for (int t = S - 1; t >= 0; --t) {
    float rec[kGMax];
    if (t == S - 1) {
#pragma unroll
      for (int i = 0; i < kGMax; ++i) {
        const size_t idx = g0 + i * gstep;
        rec[i] = idx < bn ? A.dhT[idx] : 0.0f;
      }
    } else {
      const unsigned long long e = base + (S - 2 - t);
      const int ws = static_cast<int>(e % 3);
      product(t + 1, ws);
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
      const size_t gb = t * bk + (idx / nd) * K + idx % nd;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) dg[gb + (size_t)gt * nd] = d[gt];
    }
    if (t > 0) load_inputs(t - 1);
    // dg_t is whole before any block of the rank reads it, and the ring's
    // partial sums are read before the next chunks land
    rank_barrier(bar, nb);
  }
  // dh0 = dg_0 @ U^T, the rank's columns summed over the ranks; dc0
  const unsigned long long e = base + (S - 1);
  const int ws = static_cast<int>(e % 3);
  product(0, ws);
  exchange(peers, me, D, kBwdFlag, bar, nb, static_cast<unsigned>(e + 1));
  float rec[kGMax];
  chunk_sum(ws, rec);
#pragma unroll
  for (int i = 0; i < kGMax; ++i) {
    const size_t idx = g0 + i * gstep;
    if (idx >= bn) continue;
    A.dh0[idx] = rec[i];
    A.dc[idx] = dcr[i];
  }
}

template <typename RT, int RR, int STAGES>
int run_bwd_f32_ranks(int groups, const int* ranks, const void* const* U,
                      const void* const* gseq, const void* const* cprev,
                      const void* const* cT, const void* const* dhseq,
                      const void* const* dhT, void* const* dc, void* const* dg,
                      void* const* dh0, int D, void* const* bufs, long long r_off,
                      unsigned long long base, int S, int B, int N, int nd,
                      int G, int standard, cudaStream_t stream) {
  int blocks[kMaxRanks];
  const int nb = N / kFUnits * G;
  if (groups < 1 || groups > kMaxRanks)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int g = 0; g < groups; ++g) blocks[g] = nb;
  const auto kernel = tp_seq_bwd_f32_x<RT, RR, STAGES>;
  const size_t smem = f32_smem_bytes(B, nd, G, STAGES);
  int resident = 0;
  int err = resident_with(kernel, kFThreads, smem, &resident);
  if (err != 0) return err;
  F32BwdRanks<RT> a{};
  PeerTable peers{};
  int first[kMaxRanks];
  const int grid = ranks_grid(groups, ranks, blocks, D, bufs, N, nd, resident,
                              first, &peers);
  if (grid < 0) return -grid;
  for (int g = 0; g < groups; ++g)
    a.g[g] = F32BwdGroup<RT>{
        static_cast<const float*>(U[g]), static_cast<const RT*>(gseq[g]),
        static_cast<const RT*>(cprev[g]), static_cast<const float*>(cT[g]),
        static_cast<const float*>(dhseq[g]), static_cast<const float*>(dhT[g]),
        static_cast<float*>(dc[g]), static_cast<float*>(dg[g]),
        static_cast<float*>(dh0[g]), ranks[g], first[g]};
  void* args[] = {&a, &groups, &peers, &D, &base, &r_off, &S, &B, &N, &nd, &G,
                  &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kFThreads), args,
      smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// K16 at D ranks under fp32 compute (ops/cuda_tp_seq.py:ranks_bwd_f32_plan
// gives G, the product rows a thread RR = 1, 2, 4, 8 for B <= 16, 32, 64,
// 128, and the ring's stages): as tp_seq_bwd_ranks_launch (lstm_tp.cu),
// with U (N, 4nd) fp32 untransposed, read in place, and no block counts:
// each group takes N / 16 x G blocks. G is 1, 2 or 4 with 4nd / G a
// multiple of 64; the exchange buffers' chunks hold G parts a sender
// (exchange.cuh). Every block must be resident at once, and each thread
// takes at most 8 of the rank's B x nd gate-backward elements.
extern "C" int tp_seq_bwd_f32_ranks_launch(
    int rtype, int groups, const int* ranks, int G, int RR, int stages,
    const void* const* U, const void* const* gseq, const void* const* cprev,
    const void* const* cT, const void* const* dhseq, const void* const* dhT,
    void* const* dc, void* const* dg, void* const* dh0, int D,
    void* const* bufs, long long r_off, unsigned long long base, int S, int B,
    int N, int nd, int standard, void* stream, int* launches) {
  if (B < 1 || B > kFMaxRows || S < 1 || nd < 16 || N % kFUnits != 0 ||
      (G != 1 && G != 2 && G != kMaxParts) || (4 * nd / G) % kFKC != 0 ||
      RR != f32_rows_per_thread(B) ||
      (size_t)B * nd > (size_t)N / kFUnits * G * kFThreads * kGMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(groups, ranks, U, gseq, cprev, cT, dhseq, dhT, dc, dg, dh0, D, bufs,
               r_off, base, S, B, N, nd, G, standard,
               static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  int err = static_cast<int>(cudaErrorInvalidValue);
#define BWD_F32_CASE(r, st)                                                  \
  if (RR == r && stages == st)                                               \
    err = rtype == 0 ? f(run_bwd_f32_ranks<float, r, st>)                    \
        : rtype == 1 ? f(run_bwd_f32_ranks<bf, r, st>)                       \
                     : err;
  BWD_F32_LAYOUTS(BWD_F32_CASE)
#undef BWD_F32_CASE
  if (err == 0) ++*launches;
  return err;
}
