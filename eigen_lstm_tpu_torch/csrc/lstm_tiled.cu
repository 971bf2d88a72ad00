// The tiled-U LSTM recurrence for Hopper (sm_90a): the kernels of the
// regime where U no longer fits a core's fast memory, bound from Python
// through ctypes (eigen_lstm_tpu_torch/ops/cuda_cell_tiled.py). No PyTorch
// headers. Three C launchers, one launch per timestep each:
//
//   tiled_fwd_embed_launch (K8) <- pallas_cell_tiled.py:_fwd_tiled_embed_kernel
//       (layer 0, :429): g = W[ids_t] + round(h_{t-1}) @ U, then + b
//       (the one-hot rows of [onehot | h] @ [W; U] are a gather, :454-457)
//   tiled_fwd_scan_launch (K9)  <- _fwd_tiled_kernel (layers >= 1, :52):
//       g = xw_t + round(h_{t-1}) @ U (:73-76)
//   tiled_bwd_launch (K10)      <- _bwd_tiled_kernel (:106), the reverse
//       steps shared by both tiled VJPs (bwd_call, :414):
//       dh_t = round(dg_{t+1}) @ U^T + dh_cot_t (dhT at t = S-1), then the
//       gate backward; dg_t in the xw type, dc in fp32 (dc0 at the end).
//       dh_cot_t is the cotangent of h_seq in the xw type (the VJPs round
//       it, :355, :596), masked and scaled by inv under dropout (:162-170).
//       dh0 = round(dg_0) @ U^T and the weight gradients are products
//       outside the kernel, as in the JAX VJPs (:359-375, :599-623).
// The forward epilogue: sigma on i, o, f, tanh on u, the cell update of
// _cell_fwd ("reference" carries tanh(i*u + f*c_prev), "standard" the raw
// cell), h_seq and c_seq and the activated gates in the residual type, the
// carry in fp32, and with dropout the masked stream where(keep(seed, t),
// h * inv, 0) (:97-103, :475-482), with the keep bits of common.cuh.
// round() is the compute type CT (bf16 or fp32), the xw type is CT, every
// product and sum is fp32.
//
// What bounds them on the H100. At run_configs.py 5b's shapes (S = 100,
// B = 128, N = 2048, bf16) a forward window is 2*S*B*N*4N = 429.5 GFLOP of
// recurrent products against ~350 MB the function must move (U once, 32 MB
// in bf16; the xw stream or the W rows; the residuals), so operations
// bound it: 0.434 ms at the bf16 tensor-core peak; K10 the same products
// (bound() in chip_smoke.py). U is 32 MB in bf16: more than the 227 KB a
// block can hold and the ~30 MB of all 132 SMs' shared memory together,
// less than the 50 MB L2.
//
// Design (simple and right first). The TPU kernel streams (N, wt) U tiles
// through VMEM in a sequential grid and gathers a step's gate chunks in
// scratch before the cell epilogue; Hopper blocks run in parallel and in
// no order, so the blocking is turned around:
//   * a block owns 32 hidden units (one per lane) with all four gate
//     columns j, N+j, 2N+j, 3N+j, and a batch tile of 8*R rows (R per
//     warp), so the cell epilogue (the gate backward for K10) runs in
//     registers and needs nothing of another block;
//   * it walks the contraction axis in 64-byte chunks, staging the U chunk
//     (for K10 a chunk of U^T, (4N, N), so lanes read neighbouring
//     addresses) and the matching chunk of the row operand in shared
//     memory through a two-stage cp.async pipeline: the copy of chunk c+1
//     is in flight while chunk c is multiplied, the counterpart of the TPU
//     kernel's double-buffered U-tile DMA;
//   * the row operand arrives rounded already: round(h_{t-1}) in CT, which
//     the previous step's epilogue writes beside the fp32 carry (the TPU
//     kernel's h_c cache, :70-71), and dg_{t+1} in the xw type, which is
//     K10's own output; so each U element is read once per batch tile per
//     step, and each thread does 4R (forward) or R (K10) fp32 FMAs on CUDA
//     cores per element of the row operand it reads;
//   * one launch per timestep: the launch boundary orders the steps, as
//     the TPU kernel's one-step-deep pipeline did. Nothing a block reads is
//     written by its own launch (h_c alternates between two buffers; c and
//     K10's dc are updated in place, each element by the thread that owns
//     it).
// Tensor cores (wgmma), TMA and a persistent kernel that keeps U's slices
// on chip across steps are later work.

#include "common.cuh"

namespace {

constexpr int kJT = 32;    // hidden units per block, one per lane
constexpr int kWarps = 8;  // warps per block, each owning R batch rows

// Elements of T in one 16-byte copy (V), and in one 64-byte chunk of the
// contraction axis (KC).
template <typename T> struct Vec {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int KC = 64 / (int)sizeof(T);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element v of a 16-byte vector of T, widened to fp32.
template <typename T> __device__ __forceinline__ float lane_of(const uint4& p, int v);
template <> __device__ __forceinline__ float lane_of<float>(const uint4& p, int v) {
  const unsigned w = v == 0 ? p.x : v == 1 ? p.y : v == 2 ? p.z : p.w;
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ float lane_of<__nv_bfloat16>(const uint4& p, int v) {
  const int q = v / 2;
  const unsigned w = q == 0 ? p.x : q == 1 ? p.y : q == 2 ? p.z : p.w;
  return __uint_as_float(v % 2 ? (w & 0xFFFF0000u) : (w << 16));
}

// The row operand's chunk: rows b0 .. b0 + BT - 1 of X (B, ld), columns
// k0 .. k0 + chunk - 1, into xs[BT][chunk]. Rows past B copy row B - 1
// (valid memory; the epilogue drops them).
template <typename T, int BT>
__device__ __forceinline__ void stage_rows(T (*xs)[Vec<T>::KC], const T* X,
                                           int b0, int B, size_t ld, int k0,
                                           int tid) {
  constexpr int per_row = 4;  // 16-byte copies in a 64-byte row chunk
  for (int e = tid; e < BT * per_row; e += kJT * kWarps) {
    const int r = e / per_row, q = e % per_row;
    const int b = min(b0 + r, B - 1);
    cp_async16(&xs[r][q * Vec<T>::V], X + (size_t)b * ld + k0 + q * Vec<T>::V);
  }
}

// ---------------------------------------------------------------------------
// K8 / K9: one forward step. grid = (N / 32, ceil(B / (8R))), block = (32, 8).
template <typename CT, typename RT, bool EMBED, bool DROP, int R>
__global__ void __launch_bounds__(kJT * kWarps)
tiled_fwd_step(const CT* __restrict__ U,        // (N, 4N)
               const CT* __restrict__ xw_t,     // (B, 4N), !EMBED
               const CT* __restrict__ W,        // (M, 4N), EMBED
               const float* __restrict__ bias,  // (4N,), EMBED
               const int* __restrict__ ids_t,   // (B,), EMBED
               const CT* __restrict__ hc_in,    // (B, N) round(h_{t-1})
               CT* __restrict__ hc_out,         // (B, N) round(h_t)
               float* __restrict__ c,           // (B, N) fp32 carry, in place
               float* __restrict__ hT,          // (B, N) fp32 h_t
               RT* __restrict__ hseq_t,         // (B, N)
               RT* __restrict__ cseq_t,         // (B, N) or null
               RT* __restrict__ gseq_t,         // (B, 4N) or null
               RT* __restrict__ hdrop_t,        // (B, N), DROP
               Dropout drop, int tau, int B, int N, int standard) {
  constexpr int BT = kWarps * R;
  constexpr int KC = Vec<CT>::KC;
  constexpr int V = Vec<CT>::V;
  constexpr int CH = kJT * (int)sizeof(CT) / 16;  // copies per 32-unit gate row
  __shared__ __align__(16) CT Us[2][KC][4][kJT];
  __shared__ __align__(16) CT Hs[2][BT][KC];

  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kJT + lane;
  const int j0 = blockIdx.x * kJT, j = j0 + lane;
  const int b0 = blockIdx.y * BT;
  const size_t n4 = 4 * (size_t)N;

  const auto stage = [&](int st, int k0) {
    for (int e = tid; e < KC * 4 * CH; e += kJT * kWarps) {
      const int kk = e / (4 * CH), g = (e / CH) % 4, q = e % CH;
      cp_async16(&Us[st][kk][g][q * V],
                 U + (size_t)(k0 + kk) * n4 + (size_t)g * N + j0 + q * V);
    }
    stage_rows<CT, BT>(Hs[st], hc_in, b0, B, N, k0, tid);
    cp_async_commit();
  };

  float acc[4][R];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;

  const int chunks = N / KC;
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int st = ch & 1;
    if (ch + 1 < chunks) {
      stage(st ^ 1, (ch + 1) * KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += V) {
      uint4 hp[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        hp[r] = *reinterpret_cast<const uint4*>(&Hs[st][w * R + r][kk]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float u[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) u[g] = to_f32(Us[st][kk + v][g][lane]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = lane_of<CT>(hp[r], v);
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hv, u[g], acc[g][r]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + w * R + r;
    if (b >= B) continue;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const size_t col = (size_t)g * N + j;
      float s = acc[g][r];
      if (EMBED) {
        s = (s + to_f32(W[(size_t)ids_t[b] * n4 + col])) + bias[col];
      } else {
        s += to_f32(xw_t[(size_t)b * n4 + col]);
      }
      gate[g] = g < 3 ? sigmoid(s) : tanhf(s);
    }
    const size_t idx = (size_t)b * N + j;
    float h, cc;
    cell(gate, c[idx], standard, &h, &cc);
    c[idx] = cc;
    hT[idx] = h;
    hc_out[idx] = from_f32<CT>(h);
    hseq_t[idx] = from_f32<RT>(h);
    if (DROP)
      hdrop_t[idx] = from_f32<RT>(keep_bit(drop, tau, idx) ? h * drop.inv : 0.0f);
    if (cseq_t != nullptr) cseq_t[idx] = from_f32<RT>(cc);
    if (gseq_t != nullptr) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gseq_t[(size_t)b * n4 + (size_t)g * N + j] = from_f32<RT>(gate[g]);
    }
  }
}

// ---------------------------------------------------------------------------
// K10: one reverse step. dg_next null: the last timestep (dh from dhT).
// grid = (N / 32, ceil(B / (8R))), block = (32, 8).
template <typename CT, typename RT, int R>
__global__ void __launch_bounds__(kJT * kWarps)
tiled_bwd_step(const CT* __restrict__ UT,        // (4N, N) = U^T
               const CT* __restrict__ dg_next,   // (B, 4N) dg_{t+1}, or null
               const float* __restrict__ dhT,    // (B, N)
               const CT* __restrict__ dhseq_t,   // (B, N) cotangent, xw type
               const RT* __restrict__ g_t,       // (B, 4N) activated gates
               const RT* __restrict__ c_t,       // (B, N)
               const RT* __restrict__ c_prev_t,  // (B, N) c_{t-1}, null at t = 0
               const float* __restrict__ c0,     // (B, N)
               float* __restrict__ dc,           // (B, N) in place
               CT* __restrict__ dg_t,            // (B, 4N) out, xw type
               Dropout drop, int tau, int B, int N, int standard) {
  constexpr int BT = kWarps * R;
  constexpr int KC = Vec<CT>::KC;
  constexpr int V = Vec<CT>::V;
  constexpr int CH = kJT * (int)sizeof(CT) / 16;
  __shared__ __align__(16) CT Us[2][KC][kJT];
  __shared__ __align__(16) CT Ds[2][BT][KC];

  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kJT + lane;
  const int j0 = blockIdx.x * kJT, j = j0 + lane;
  const int b0 = blockIdx.y * BT;
  const size_t n4 = 4 * (size_t)N;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  if (dg_next != nullptr) {
    const auto stage = [&](int st, int k0) {
      for (int e = tid; e < KC * CH; e += kJT * kWarps) {
        const int kk = e / CH, q = e % CH;
        cp_async16(&Us[st][kk][q * V], UT + (size_t)(k0 + kk) * N + j0 + q * V);
      }
      stage_rows<CT, BT>(Ds[st], dg_next, b0, B, n4, k0, tid);
      cp_async_commit();
    };
    const int chunks = 4 * N / KC;
    stage(0, 0);
    for (int ch = 0; ch < chunks; ++ch) {
      const int st = ch & 1;
      if (ch + 1 < chunks) {
        stage(st ^ 1, (ch + 1) * KC);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += V) {
        uint4 dp[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          dp[r] = *reinterpret_cast<const uint4*>(&Ds[st][w * R + r][kk]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float u = to_f32(Us[st][kk + v][lane]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(lane_of<CT>(dp[r], v), u, acc[r]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + w * R + r;
    if (b >= B) continue;
    const size_t idx = (size_t)b * N + j;
    const float dh_rec = dg_next != nullptr ? acc[r] : dhT[idx];
    float dh_cot = to_f32(dhseq_t[idx]);
    // __fmul_rn: the product rounds before the add, as in the TPU kernel
    if (drop.on) dh_cot = keep_bit(drop, tau, idx) ? __fmul_rn(dh_cot, drop.inv) : 0.0f;
    const size_t gb = (size_t)b * n4 + j;
    const float cp = c_prev_t != nullptr ? to_f32(c_prev_t[idx]) : c0[idx];
    float d[4];
    gate_bwd(to_f32(g_t[gb]), to_f32(g_t[gb + N]), to_f32(g_t[gb + 2 * (size_t)N]),
             to_f32(g_t[gb + 3 * (size_t)N]), to_f32(c_t[idx]), cp,
             dh_cot + dh_rec, dc[idx], standard, d, &dc[idx]);
#pragma unroll
    for (int q = 0; q < 4; ++q) dg_t[gb + (size_t)q * N] = from_f32<CT>(d[q]);
  }
}

// Rows per warp: 8 at training batches (each U element then feeds 8 rows
// of a tile of 64), 2 at small ones (a tile of 16, no rows wasted at the
// eval batch of 16).
inline bool wide_tile(int B) { return B >= 64; }

template <typename CT, typename RT, bool EMBED, bool DROP, int R>
int run_fwd_r(const void* U, const void* xw, const void* W, const float* bias,
              const int* ids, void* hc, float* c, float* hT, void* hseq,
              void* cseq, void* gseq, void* hdrop, Dropout drop, int S, int B,
              int N, int standard, cudaStream_t stream) {
  const dim3 grid(N / kJT, (B + kWarps * R - 1) / (kWarps * R));
  const dim3 block(kJT, kWarps);
  const size_t bn = (size_t)B * N, bn4 = 4 * bn;
  CT* hcb = static_cast<CT*>(hc);
  for (int t = 0; t < S; ++t) {
    tiled_fwd_step<CT, RT, EMBED, DROP, R><<<grid, block, 0, stream>>>(
        static_cast<const CT*>(U),
        EMBED ? nullptr : static_cast<const CT*>(xw) + t * bn4,
        static_cast<const CT*>(W), bias, EMBED ? ids + (size_t)t * B : nullptr,
        hcb + (t % 2) * bn, hcb + ((t + 1) % 2) * bn, c, hT,
        static_cast<RT*>(hseq) + t * bn,
        cseq ? static_cast<RT*>(cseq) + t * bn : nullptr,
        gseq ? static_cast<RT*>(gseq) + t * bn4 : nullptr,
        DROP ? static_cast<RT*>(hdrop) + t * bn : nullptr, drop, t, B, N,
        standard);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// S launches. hc: (2, B, N) in CT, round(h0) in its first half on entry
// (the halves alternate between steps); c: c0 on entry, cT after; hT out.
template <typename CT, typename RT, bool EMBED>
int run_fwd(const void* U, const void* xw, const void* W, const float* bias,
            const int* ids, void* hc, float* c, float* hT, void* hseq,
            void* cseq, void* gseq, void* hdrop, Dropout drop, int S, int B,
            int N, int standard, cudaStream_t stream) {
  const auto f = [&](auto run) {
    return run(U, xw, W, bias, ids, hc, c, hT, hseq, cseq, gseq, hdrop, drop,
               S, B, N, standard, stream);
  };
  if (hdrop != nullptr)
    return wide_tile(B) ? f(run_fwd_r<CT, RT, EMBED, true, 8>)
                        : f(run_fwd_r<CT, RT, EMBED, true, 2>);
  return wide_tile(B) ? f(run_fwd_r<CT, RT, EMBED, false, 8>)
                      : f(run_fwd_r<CT, RT, EMBED, false, 2>);
}

// S launches, t = S-1 .. 0. dg: the (S, B, 4N) dg sequence out, in CT;
// dc: dcT on entry, dc0 after.
template <typename CT, typename RT, int R>
int run_bwd_r(const void* UT, const void* g_seq, const void* c_seq,
              const float* c0, const void* dh_seq, const float* dhT, float* dc,
              void* dg, Dropout drop, int S, int B, int N, int standard,
              cudaStream_t stream) {
  const dim3 grid(N / kJT, (B + kWarps * R - 1) / (kWarps * R));
  const dim3 block(kJT, kWarps);
  const size_t bn = (size_t)B * N, bn4 = 4 * bn;
  const RT* gs = static_cast<const RT*>(g_seq);
  const RT* cs = static_cast<const RT*>(c_seq);
  CT* dgs = static_cast<CT*>(dg);
  for (int t = S - 1; t >= 0; --t) {
    tiled_bwd_step<CT, RT, R><<<grid, block, 0, stream>>>(
        static_cast<const CT*>(UT), t < S - 1 ? dgs + (t + 1) * bn4 : nullptr,
        dhT, static_cast<const CT*>(dh_seq) + t * bn, gs + t * bn4, cs + t * bn,
        t > 0 ? cs + (t - 1) * bn : nullptr, c0, dc, dgs + t * bn4, drop, t, B,
        N, standard);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename CT, typename RT>
int run_bwd(const void* UT, const void* g_seq, const void* c_seq,
            const float* c0, const void* dh_seq, const float* dhT, float* dc,
            void* dg, Dropout drop, int S, int B, int N, int standard,
            cudaStream_t stream) {
  return wide_tile(B)
             ? run_bwd_r<CT, RT, 8>(UT, g_seq, c_seq, c0, dh_seq, dhT, dc, dg,
                                    drop, S, B, N, standard, stream)
             : run_bwd_r<CT, RT, 2>(UT, g_seq, c_seq, c0, dh_seq, dhT, dc, dg,
                                    drop, S, B, N, standard, stream);
}

}  // namespace

// Type codes: 0 = fp32, 1 = bf16. Every pointer is 16-byte aligned and N a
// multiple of 32 (the wrappers check both). U (N, 4N), W (M, 4N) and the xw
// stream are in the compute type; bias, c and hT fp32; ids int32 (S, B);
// hc (2, B, N) in the compute type with round(h0) in its first half; the
// sequences in the residual type; hdrop null for no dropout, else the
// masked stream of (seed, keep, inv).
extern "C" int tiled_fwd_embed_launch(
    int ctype, int rtype, const void* W, const void* U, const void* bias,
    const void* ids, void* hc, void* c, void* hT, void* hseq, void* cseq,
    void* gseq, void* hdrop, int S, int B, int N, int standard, unsigned seed,
    unsigned keep, float inv, void* stream) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, nullptr, W, static_cast<const float*>(bias),
               static_cast<const int*>(ids), hc, static_cast<float*>(c),
               static_cast<float*>(hT), hseq, cseq, gseq, hdrop, drop, S, B, N,
               standard, static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_fwd<float, float, true>);
  if (ctype == 0 && rtype == 1) return f(run_fwd<float, bf, true>);
  if (ctype == 1 && rtype == 0) return f(run_fwd<bf, float, true>);
  if (ctype == 1 && rtype == 1) return f(run_fwd<bf, bf, true>);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tiled_fwd_scan_launch(
    int ctype, int rtype, const void* U, const void* xw, void* hc, void* c,
    void* hT, void* hseq, void* cseq, void* gseq, void* hdrop, int S, int B,
    int N, int standard, unsigned seed, unsigned keep, float inv,
    void* stream) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, xw, nullptr, nullptr, nullptr, hc, static_cast<float*>(c),
               static_cast<float*>(hT), hseq, cseq, gseq, hdrop, drop, S, B, N,
               standard, static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_fwd<float, float, false>);
  if (ctype == 0 && rtype == 1) return f(run_fwd<float, bf, false>);
  if (ctype == 1 && rtype == 0) return f(run_fwd<bf, float, false>);
  if (ctype == 1 && rtype == 1) return f(run_fwd<bf, bf, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10. UT is U^T (4N, N) and dh_seq (S, B, N) in the compute type (the xw
// type); the residual sequences in the residual type; c0 and dhT fp32; dc
// holds dcT on entry and dc0 on return; dg receives the (S, B, 4N) dg
// sequence in the compute type. drop_on, seed, keep, inv: the dropout of
// the forward's masked stream.
extern "C" int tiled_bwd_launch(
    int ctype, int rtype, const void* UT, const void* g_seq, const void* c_seq,
    const void* c0, const void* dh_seq, const void* dhT, void* dc, void* dg,
    int S, int B, int N, int standard, int drop_on, unsigned seed,
    unsigned keep, float inv, void* stream) {
  const Dropout drop{drop_on, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(UT, g_seq, c_seq, static_cast<const float*>(c0), dh_seq,
               static_cast<const float*>(dhT), static_cast<float*>(dc), dg,
               drop, S, B, N, standard, static_cast<cudaStream_t>(stream));
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_bwd<float, float>);
  if (ctype == 0 && rtype == 1) return f(run_bwd<float, bf>);
  if (ctype == 1 && rtype == 0) return f(run_bwd<bf, float>);
  if (ctype == 1 && rtype == 1) return f(run_bwd<bf, bf>);
  return static_cast<int>(cudaErrorInvalidValue);
}
