// K15 under fp32 compute for Hopper (sm_90a), at D = 1 and at D ranks, on
// K8/K9's persistent CUDA-core forward (lstm_tiled_f32.cuh) in K15's mode,
// bound from Python through ctypes (ops/cuda_tp_seq.py). No PyTorch
// headers. Replaces pallas_tp_seq.py:_fwd_kernel (:59; the D > 1 exchange
// :96-120) under fp32 compute, wherever ops/cuda_cell_tiled.py:
// split_fwd_f32_plan (D = 1) or ops/cuda_tp_seq.py:ranks_fwd_f32_plan (D
// ranks) gives a layout; elsewhere K15 keeps lstm_tp.cu's cooperative
// tiles. Two C launchers, each one cooperative launch a window:
//
//   tp_seq_fwd_f32_launch: D = 1, the grid barrier between steps;
//   tp_seq_fwd_f32_ranks_launch: D rank groups, group g playing rank
//       ranks[g], exchange.cuh's RankStep in place of the grid barrier.
//
// K15's mode of the window: g = xw_t + round(h_{t-1}) @ U_r (xw fp32 with
// the bias; the compute type is fp32, so round is the identity), h_seq in
// fp32, c_prev[t] = c_{t-1} and g in the residual type at the shard's gate
// stride nd, hT and cT in fp32 (c holds c0 on entry and cT on return). A
// block owns 8 of the rank's nd units with their four gates over all N of
// h, and `rows` batch rows: at the bench's N = 512 the N / 8 = 64 blocks of
// one row each would leave half of the H100's SMs idle, so the batch splits
// over 2 block rows (128 blocks). A unit's sums do not depend on the rows,
// the ring or nd, so the D-rank windows give the D = 1 window's bits on
// the unpermuted weights.
//
// What bounds it on the H100: operations, 2 S B N 4N flops at 67 TFLOP/s
// in fp32 (0.40 ms at the bench's S = 100, B = 128, N = 512; the formulas
// in chip_smoke.py:tp_seq_work); the D shards' work and bytes sum to the
// same, the exchange (S - 1 stores of a rank's h tile to each peer) being
// neither input nor output. What holds it back is the recurrence: each
// step every block reads its rows of h from L2 and meets the barrier or
// the exchange, the product's shared loads as busy as its FMAs.

#include "exchange.cuh"
#include "lstm_tiled_f32.cuh"

namespace {

// K15 at D ranks: the window of each group's rank, its blocks (nd / 8) x
// ceil(B / rows) with the group's own rows.
template <typename RT>
struct F32FwdGroup {
  const float* U;   // (N, 4nd), the rank's shard
  const float* xw;  // (S, B, 4nd)
  float* c;         // (B, nd): c0 in, cT out
  float* hT;        // (B, nd)
  float* hseq;      // (S, B, nd)
  RT* cprev;        // (S, B, nd)
  RT* gseq;         // (S, B, 4nd)
  int rank, first, rows;
};

template <typename RT>
struct F32FwdRanks {
  F32FwdGroup<RT> g[kMaxRanks];
};

template <typename RT, int R, int KC, int STAGES>
__global__ void __launch_bounds__(kPThreads, 1)
tp_seq_fwd_f32_x(const __grid_constant__ F32FwdRanks<RT> a, int groups,
                 const __grid_constant__ PeerTable peers, int D,
                 unsigned long long base, long long h_off, int S, int B, int N,
                 int nd, int standard) {
  int nb;
  const F32FwdGroup<RT>& G = a.g[my_group(a.g, groups, &nb)];
  const int bi = static_cast<int>(blockIdx.x) - G.first;
  const int cols = nd / kPUnits;
  const RankStep<float> step{peers, G.rank, D, N, nd, S, base, h_off,
                             (size_t)B * N, words(peers.buf[G.rank], kFwdBar), nb};
  f32_fwd_window<RT, false, true, R, KC, STAGES>(
      step, G.U, G.xw, nullptr, nullptr, G.c, G.hT, G.hseq, G.cprev, G.gseq,
      nullptr, Dropout{0, 0, 0, 0.0f}, S, B, N, nd, (bi % cols) * kPUnits,
      (bi / cols) * G.rows, G.rows, standard);
}

// One cooperative launch of the D-rank window, R, KC and STAGES one layout
// for every group, each group's rows at most 32 R.
template <typename RT, int R, int KC, int STAGES>
int run_fwd_f32_ranks(int groups, const int* ranks, const int* rows,
                      const void* const* U, const void* const* xw,
                      const void* const* h0, void* const* c, void* const* hseq,
                      void* const* gseq, void* const* cprev, void* const* hT,
                      int D, void* const* bufs, long long h_off,
                      unsigned long long base, int S, int B, int N, int nd,
                      int standard, cudaStream_t stream) {
  if (groups < 1 || groups > kMaxRanks || N % KC != 0 || nd % kPUnits != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks[kMaxRanks];
  for (int g = 0; g < groups; ++g) {
    if (rows[g] < 1 || rows[g] > kPRowGroups * R)
      return static_cast<int>(cudaErrorInvalidValue);
    blocks[g] = nd / kPUnits * ((B + rows[g] - 1) / rows[g]);
  }
  const auto kernel = tp_seq_fwd_f32_x<RT, R, KC, STAGES>;
  const size_t smem = f32_persist_smem_bytes(kPRowGroups * R, N, KC, STAGES);
  int resident = 0;
  int err = resident_with(kernel, kPThreads, smem, &resident);
  if (err != 0) return err;
  F32FwdRanks<RT> a{};
  PeerTable peers{};
  int first[kMaxRanks];
  const int grid = ranks_grid(groups, ranks, blocks, D, bufs, N, nd, resident,
                              first, &peers);
  if (grid < 0) return -grid;
  for (int g = 0; g < groups; ++g)
    a.g[g] = F32FwdGroup<RT>{
        static_cast<const float*>(U[g]), static_cast<const float*>(xw[g]),
        static_cast<float*>(c[g]), static_cast<float*>(hT[g]),
        static_cast<float*>(hseq[g]), static_cast<RT*>(cprev[g]),
        static_cast<RT*>(gseq[g]), ranks[g], first[g], rows[g]};
  err = copy_h0(groups, ranks, h0, peers, h_off, base, (size_t)B * N * sizeof(float),
                stream);
  if (err != 0) return err;
  void* args[] = {&a, &groups, &peers, &D, &base, &h_off, &S, &B, &N, &nd,
                  &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kPThreads), args,
      smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// K15 at D = 1 under fp32 compute (ops/cuda_cell_tiled.py:
// split_fwd_f32_plan gives rows a block and the ring (R, kc, stages); R =
// 1, 2 or 4 for rows <= 32, 64, 128): U (N, 4N) and xw (S, B, 4N) fp32;
// hc (2, B, N) fp32 with h0 in its first half; c (B, N) fp32, c0 on entry
// and cT on return; hT and hseq (S, B, N) fp32; cprev (S, B, N) and gseq
// (S, B, 4N) in the residual type (rtype 0 fp32, 1 bf16). N a multiple of
// kc, 1 <= B <= 128. One cooperative launch, added to *launches.
extern "C" int tp_seq_fwd_f32_launch(int rtype, const void* U, const void* xw,
                                     void* hc, void* c, void* hT, void* hseq,
                                     void* cprev, void* gseq, int S, int B,
                                     int N, int standard, int rows, int R,
                                     int kc, int stages, void* stream,
                                     int* launches) {
  if (B < 1 || B > kPRowGroups * 4 || S < 1 || R != f32_rows_per_thread(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(U, xw, nullptr, nullptr, hc, static_cast<float*>(c),
               static_cast<float*>(hT), hseq, cprev, gseq, nullptr,
               Dropout{0, 0, 0, 0.0f}, S, B, N, rows, standard,
               static_cast<cudaStream_t>(stream), launches);
  };
  using bf = __nv_bfloat16;
#define F32_CASE(r, k, st)                                                   \
  if (R == r && kc == k && stages == st)                                     \
    return rtype == 0 ? f(run_fwd_f32<float, false, true, r, k, st>)         \
         : rtype == 1 ? f(run_fwd_f32<bf, false, true, r, k, st>)            \
                      : static_cast<int>(cudaErrorInvalidValue);
  F32_LAYOUTS(F32_CASE)
#undef F32_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K15 at D ranks under fp32 compute (ops/cuda_tp_seq.py:ranks_fwd_f32_plan):
// as tp_seq_fwd_ranks_launch (lstm_tp.cu), with group g's rows a block
// rows[g] in place of a block count, the ring (R, kc, stages) one for every
// group (rows[g] <= 32 R), U (N, 4nd), xw and h0 (B, N) fp32, and no cT: c
// (B, nd) holds c0 on entry and cT on return. Every block must be
// resident at once (refused before anything runs otherwise).
extern "C" int tp_seq_fwd_f32_ranks_launch(
    int rtype, int groups, const int* ranks, const int* rows, int R, int kc,
    int stages, const void* const* U, const void* const* xw,
    const void* const* h0, void* const* c, void* const* hseq,
    void* const* gseq, void* const* cprev, void* const* hT, int D,
    void* const* bufs, long long h_off, unsigned long long base, int S, int B,
    int N, int nd, int standard, void* stream, int* launches) {
  if (B < 1 || B > kPRowGroups * 4 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(groups, ranks, rows, U, xw, h0, c, hseq, gseq, cprev, hT, D, bufs,
               h_off, base, S, B, N, nd, standard, static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  int err = static_cast<int>(cudaErrorInvalidValue);
#define F32_CASE(r, k, st)                                                   \
  if (R == r && kc == k && stages == st)                                     \
    err = rtype == 0 ? f(run_fwd_f32_ranks<float, r, k, st>)                 \
        : rtype == 1 ? f(run_fwd_f32_ranks<bf, r, k, st>)                    \
                     : err;
  F32_LAYOUTS(F32_CASE)
#undef F32_CASE
  if (err == 0) ++*launches;
  return err;
}
