// Forward LSTM recurrence for Hopper (sm_90a): one timestep per launch, two
// input modes behind two C launchers, bound from Python through ctypes
// (eigen_lstm_tpu_torch/ops/cuda_cell.py). No PyTorch headers: the file
// builds with a plain nvcc call, linked into one shared library.
//
// Replaces two TPU kernels of eigen_lstm_tpu/ops/pallas_cell.py:
//   lstm_fwd_embed_launch <- _fwd_embed_kernel (K1: layer 0, embedding
//       fused): g = (round(h_{t-1}) @ U + W[ids_t]) + b, the JAX kernel's
//       dot([onehot | h], [W; U]) then + b (:522-528)
//   lstm_fwd_scan_launch  <- _fwd_kernel (K2: layers >= 1, xw = x @ W + b
//       precomputed outside as one large product):
//       g = xw_t + round(h_{t-1}) @ U
// This file is their design for the shapes the persistent designs do not
// take (B > 128, N not a multiple of 64 in bf16 or of 32 in fp32, N = 2048
// in fp32, a grid the card cannot hold). Elsewhere both run on a
// persistent forward (ops/cuda_cell.py chooses), the same function with
// the same sum order around the product: under bf16 compute the
// tensor-core one of fwd_mma.cuh (fwd_persist, through lstm_tiled.cu's
// launchers), under fp32 compute the CUDA-core one of lstm_tiled_f32.cuh
// (K1 through lstm_tiled_f32.cu's tiled_fwd_embed_f32_launch, K2 through
// its tiled_fwd_scan_f32_launch, both with their batch split over block
// rows where N / 8 blocks would leave SMs idle).
// then sigma on i, o, f and tanh on u, and the cell update of _cell_fwd:
// "reference" carries c2 = tanh(i*u + f*c_prev) with h = o*c2; "standard"
// carries c_raw with h = o*tanh(c_raw). round() is the compute type (bf16
// or fp32); products accumulate in fp32 and the carry stays fp32.
// With dropout (a non-null hdrop) each step also writes the masked stream
// where(keep(seed, t), h * inv, 0) in the residual type, the epilogue of
// both TPU kernels (pallas_cell.py:221-224, :546-553): the product in fp32
// before the one rounding. h_seq and the carry stay unmasked.
//
// What bounds it on the H100: a window is 2*S*B*N*4N flops of recurrent
// products (17.2 GFLOP at S = 128, B = 16, N = 1024) against 13-34 MB that
// the function must move (U once, W rows or the xw stream, the outputs), so
// its bound is operations: about 17 us at the bf16 tensor-core peak and
// 256 us at the fp32 peak (the formula is bound() in chip_smoke.py). This
// design runs far above that bound, for costs of its own, not of the
// function: it re-reads all of U (8 MB in bf16) at every step, from L2
// after the first, although a step of B = 16 rows does only 2*B = 32 flops
// per U element read; its FMAs run on CUDA cores; and the S steps are S
// dependent launches, each paying launch latency.
//
// What the design does about it (simple and right first): each block owns
// 32 hidden units j (one warp's lanes, so U rows are read coalesced) and
// BT batch rows, and computes all four gate columns j, N+j, 2N+j, 3N+j so
// the epilogue fuses in registers. Its KS warps split the reduction over k
// and meet in shared memory. h_{t-1} comes from h0 at t = 0 and otherwise
// from an fp32 state buffer that the previous launch wrote; the launcher
// alternates two buffers so that no block reads what another block of the
// same launch writes. The persistent designs answer the three costs (one
// launch a window, U's rows in shared memory, and under bf16 compute
// mma.sync; under fp32 FFMAs in 8 x 8 register tiles, TF32 off).

#include "common.cuh"

namespace {

// One timestep. EMBED selects the input: W[ids_t] + b (layer 0) or xw_t;
// DROP adds the masked stream (a template flag, so that the kernel without
// dropout carries no code for it). The products are common.cuh's
// gate_sums_tile over the whole width (nd = N), the epilogue runs in
// registers. grid = (N / 32, ceil(B / kBT)), block = (32, kKS).
template <typename CT, typename RT, typename XT, bool EMBED, bool DROP>
__global__ void __launch_bounds__(kLanes * kKS)
lstm_fwd_step(const CT* __restrict__ U,        // (N, 4N)
              const XT* __restrict__ xw_t,     // (B, 4N), !EMBED
              const CT* __restrict__ W,        // (M, 4N), EMBED
              const float* __restrict__ bias,  // (4N,), EMBED
              const int* __restrict__ ids_t,   // (B,), EMBED
              const float* __restrict__ h_in,  // (B, N) fp32
              const float* __restrict__ c_in,  // (B, N) fp32
              float* __restrict__ h_out,       // (B, N) fp32
              float* __restrict__ c_out,       // (B, N) fp32
              RT* __restrict__ hseq_t,         // (B, N)
              RT* __restrict__ cseq_t,         // (B, N) or null
              RT* __restrict__ gseq_t,         // (B, 4N) or null
              RT* __restrict__ hdrop_t,        // (B, N), DROP
              Dropout drop, int tau, int B, int N, int standard) {
  float gate[4];
  int b, j;
  if (!gate_sums_tile<CT, float>(U, h_in, B, N, N, blockIdx.x, blockIdx.y,
                                 gate, &b, &j))
    return;
  const int n4 = 4 * N;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = gate[g];
    const size_t col = (size_t)g * N + j;
    if (EMBED) {
      s = (s + to_f32(W[(size_t)ids_t[b] * n4 + col])) + bias[col];
    } else {
      s += to_f32(xw_t[(size_t)b * n4 + col]);
    }
    gate[g] = g < 3 ? sigmoid(s) : tanhf(s);
  }
  const size_t idx = (size_t)b * N + j;
  float h, c;
  cell(gate, c_in[idx], standard, &h, &c);
  h_out[idx] = h;
  c_out[idx] = c;
  hseq_t[idx] = from_f32<RT>(h);
  if (DROP)
    hdrop_t[idx] = from_f32<RT>(keep_bit(drop, tau, idx) ? h * drop.inv : 0.0f);
  if (cseq_t != nullptr) cseq_t[idx] = from_f32<RT>(c);
  if (gseq_t != nullptr) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      gseq_t[(size_t)b * n4 + (size_t)g * N + j] = from_f32<RT>(gate[g]);
  }
}

// S launches on `stream`. Step t reads the state step t-1 wrote (h0/c0 at
// t = 0) and writes the other of {hT/cT, h_tmp/c_tmp}, chosen so that the
// last step lands in hT/cT. Returns the first launch error, else 0.
template <typename CT, typename RT, typename XT, bool EMBED>
int run_scan(const void* U, const void* xw, const void* W, const float* bias,
             const int* ids, const float* h0, const float* c0, float* hT,
             float* cT, float* h_tmp, float* c_tmp, void* hseq, void* cseq,
             void* gseq, void* hdrop, Dropout drop, int S, int B, int N,
             int standard, cudaStream_t stream) {
  const dim3 grid(N / kLanes, (B + kBT - 1) / kBT);
  const dim3 block(kLanes, kKS);
  const size_t bn = (size_t)B * N, bn4 = 4 * bn;
  const float* h_in = h0;
  const float* c_in = c0;
  for (int t = 0; t < S; ++t) {
    const bool to_final = ((S - 1 - t) % 2) == 0;
    float* h_out = to_final ? hT : h_tmp;
    float* c_out = to_final ? cT : c_tmp;
    const auto step = hdrop ? lstm_fwd_step<CT, RT, XT, EMBED, true>
                            : lstm_fwd_step<CT, RT, XT, EMBED, false>;
    step<<<grid, block, 0, stream>>>(
        static_cast<const CT*>(U),
        EMBED ? nullptr : static_cast<const XT*>(xw) + t * bn4,
        static_cast<const CT*>(W), bias, EMBED ? ids + (size_t)t * B : nullptr,
        h_in, c_in, h_out, c_out, static_cast<RT*>(hseq) + t * bn,
        cseq ? static_cast<RT*>(cseq) + t * bn : nullptr,
        gseq ? static_cast<RT*>(gseq) + t * bn4 : nullptr,
        hdrop ? static_cast<RT*>(hdrop) + t * bn : nullptr, drop, t, B, N,
        standard);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    h_in = h_out;
    c_in = c_out;
  }
  return 0;
}

}  // namespace

// Type codes: 0 = fp32, 1 = bf16. The xw stream of the scan launcher has
// the compute type (bf16 under bf16 compute, pallas_cell.py:475). hdrop,
// null for no dropout, receives the masked stream of (seed, keep, inv).
extern "C" int lstm_fwd_embed_launch(
    int ctype, int rtype, const void* W, const void* U, const void* bias,
    const void* ids, const void* h0, const void* c0, void* hT, void* cT,
    void* h_tmp, void* c_tmp, void* hseq, void* cseq, void* gseq,
    void* hdrop, int S, int B, int N, int standard, unsigned seed,
    unsigned keep, float inv, void* stream) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, nullptr, W, static_cast<const float*>(bias),
               static_cast<const int*>(ids), static_cast<const float*>(h0),
               static_cast<const float*>(c0), static_cast<float*>(hT),
               static_cast<float*>(cT), static_cast<float*>(h_tmp),
               static_cast<float*>(c_tmp), hseq, cseq, gseq, hdrop, drop, S,
               B, N, standard, static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_scan<float, float, float, true>);
  if (ctype == 0 && rtype == 1) return f(run_scan<float, bf, float, true>);
  if (ctype == 1 && rtype == 0) return f(run_scan<bf, float, bf, true>);
  if (ctype == 1 && rtype == 1) return f(run_scan<bf, bf, bf, true>);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int lstm_fwd_scan_launch(
    int ctype, int rtype, const void* U, const void* xw, const void* h0,
    const void* c0, void* hT, void* cT, void* h_tmp, void* c_tmp, void* hseq,
    void* cseq, void* gseq, void* hdrop, int S, int B, int N, int standard,
    unsigned seed, unsigned keep, float inv, void* stream) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, xw, nullptr, nullptr, nullptr,
               static_cast<const float*>(h0), static_cast<const float*>(c0),
               static_cast<float*>(hT), static_cast<float*>(cT),
               static_cast<float*>(h_tmp), static_cast<float*>(c_tmp), hseq,
               cseq, gseq, hdrop, drop, S, B, N, standard,
               static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_scan<float, float, float, false>);
  if (ctype == 0 && rtype == 1) return f(run_scan<float, bf, float, false>);
  if (ctype == 1 && rtype == 0) return f(run_scan<bf, float, bf, false>);
  if (ctype == 1 && rtype == 1) return f(run_scan<bf, bf, bf, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}
