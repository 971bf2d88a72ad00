// The tiled-U LSTM forward under fp32 compute for Hopper (sm_90a): the
// persistent CUDA-core design of K8 and K9, bound from Python through
// ctypes (eigen_lstm_tpu_torch/ops/cuda_cell_tiled.py). No PyTorch headers.
// TF32 stays off for fp32 products, so fp32 keeps the CUDA cores. The
// kernels' other designs (the tensor-core persistent ones under bf16
// compute, the per-step ones) are in lstm_tiled.cu; the two sources build
// in parallel. K10's fp32 persistent design is K6's (lstm_bwd_f32.cu at
// groups of 2 blocks). Two C launchers, each one cooperative launch a
// window:
//
//   tiled_fwd_embed_f32_launch (K8, and K1 under fp32 compute) <-
//       pallas_cell_tiled.py:_fwd_tiled_embed_kernel (layer 0, :429) and
//       pallas_cell.py:_fwd_embed_kernel (:495): g = (W[ids_t] +
//       h_{t-1} @ U) + b
//   tiled_fwd_scan_f32_launch (K9, and K2 under fp32 compute) <-
//       _fwd_tiled_kernel (layers >= 1, :52) and pallas_cell.py:_fwd_kernel
//       (:184): g = xw_t + h_{t-1} @ U
//
// ops/cuda_cell_tiled.py:tiled_fwd_f32_plan chooses them for K8 and K9 for
// B <= 128, N a multiple of 32 and a grid of N / 8 blocks the card holds at
// once, every batch row in a block; split_fwd_f32_plan for K1 and K2 (ops/
// cuda_cell.py:embed_layer0, scan_layer), which splits the batch over block
// rows where N / 8 blocks would leave SMs idle (2 rows of 64 at the bench's
// N = 512, B = 128; 8 rows a block at a 1x512 eval's B = 16), as K15 does.
// Elsewhere the per-step designs of lstm_tiled.cu (K8, K9) and lstm_fwd.cu
// (K1, K2) run. The epilogue is that
// of lstm_tiled.cu's per-step kernels (common.cuh: cell, keep_bit), so
// every design computes one function. The kernel and its notes are in
// lstm_tiled_f32.cuh, which K15's fp32 designs (lstm_tp_f32.cu) share.

#include "lstm_tiled_f32.cuh"

namespace {

// `rows` batch rows a block (B: every row in one block row), R the rows a
// thread owns at that many.
template <typename RT, bool EMBED>
int fwd_f32(const void* U, const void* W, const float* bias, const int* ids,
            void* hc, float* c, float* hT, void* hseq, void* cseq, void* gseq,
            void* hdrop, Dropout drop, int S, int B, int N, int standard,
            int rows, int kc, int stages, cudaStream_t stream, int* launches) {
  if (B < 1 || B > kPRowGroups * 4 || S < 1 || rows < 1 || rows > B)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(U, W, bias, ids, hc, c, hT, hseq, cseq, gseq, hdrop, drop, S, B,
               N, rows, standard, stream, launches);
  };
  const int R = f32_rows_per_thread(rows);
#define F32_CASE(r, k, st) \
  if (R == r && kc == k && stages == st) \
    return f(run_fwd_f32<RT, EMBED, false, r, k, st>);
  F32_LAYOUTS(F32_CASE)
#undef F32_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K8 and K1 under fp32 compute, the persistent CUDA-core design
// (ops/cuda_cell_tiled.py: tiled_fwd_f32_plan for K8, rows = B;
// split_fwd_f32_plan for K1): W (M, 4N), U (N, 4N), bias and c, hT fp32;
// ids int32 (S, B); hc (2, B, N) fp32 with h0 in its first half; the
// sequences in the residual type (rtype 0 fp32, 1 bf16); hdrop null for no
// dropout, else the masked stream of (seed, keep, inv); `rows` batch rows a
// block (1..B), the ring (kc, stages) one of F32_LAYOUTS at the rows a
// thread owns at `rows`. N a multiple of 32, 1 <= B <= 128. One cooperative
// launch, added to *launches.
extern "C" int tiled_fwd_embed_f32_launch(
    int rtype, const void* W, const void* U, const void* bias, const void* ids,
    void* hc, void* c, void* hT, void* hseq, void* cseq, void* gseq,
    void* hdrop, int S, int B, int N, int standard, int rows, int kc,
    int stages, unsigned seed, unsigned keep, float inv, void* stream,
    int* launches) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, W, static_cast<const float*>(bias), static_cast<const int*>(ids),
               hc, static_cast<float*>(c), static_cast<float*>(hT), hseq, cseq,
               gseq, hdrop, drop, S, B, N, standard, rows, kc, stages,
               static_cast<cudaStream_t>(stream), launches);
  };
  if (rtype == 0) return f(fwd_f32<float, true>);
  if (rtype == 1) return f(fwd_f32<__nv_bfloat16, true>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9 under fp32 compute (tiled_fwd_f32_plan, rows = B), and K2 (ops/
// cuda_cell.py:scan_layer, split_fwd_f32_plan's rows): the same persistent
// CUDA-core design with the xw stream (S, B, 4N) fp32 in place of W's rows
// and the bias: g = xw_t + h_{t-1} @ U. Arguments as
// tiled_fwd_embed_f32_launch's.
extern "C" int tiled_fwd_scan_f32_launch(
    int rtype, const void* U, const void* xw, void* hc, void* c, void* hT,
    void* hseq, void* cseq, void* gseq, void* hdrop, int S, int B, int N,
    int standard, int rows, int kc, int stages, unsigned seed, unsigned keep,
    float inv, void* stream, int* launches) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, xw, nullptr, nullptr, hc, static_cast<float*>(c),
               static_cast<float*>(hT), hseq, cseq, gseq, hdrop, drop, S, B, N,
               standard, rows, kc, stages, static_cast<cudaStream_t>(stream),
               launches);
  };
  if (rtype == 0) return f(fwd_f32<float, false>);
  if (rtype == 1) return f(fwd_f32<__nv_bfloat16, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a block of K8's (and K9's and K1's) fp32
// persistent design takes at B batch rows a block and hidden N.
extern "C" size_t tiled_fwd_f32_smem_bytes(int B, int N, int kc, int stages) {
  return f32_persist_smem_bytes(B, N, kc, stages);
}
