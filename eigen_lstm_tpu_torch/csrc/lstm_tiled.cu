// The tiled-U LSTM recurrence for Hopper (sm_90a): the kernels of the
// regime where U no longer fits a core's fast memory, bound from Python
// through ctypes (eigen_lstm_tpu_torch/ops/cuda_cell_tiled.py). No PyTorch
// headers. Three C launchers:
//
//   tiled_fwd_embed_launch (K8) <- pallas_cell_tiled.py:_fwd_tiled_embed_kernel
//       (layer 0, :429): g = W[ids_t] + round(h_{t-1}) @ U, then + b
//       (the one-hot rows of [onehot | h] @ [W; U] are a gather, :454-457);
//       under fp32 compute tiled_fwd_embed_f32_launch, its persistent
//       CUDA-core design (lstm_tiled_f32.cu)
//   tiled_fwd_scan_launch (K9)  <- _fwd_tiled_kernel (layers >= 1, :52):
//       g = xw_t + round(h_{t-1}) @ U (:73-76); under fp32 compute
//       tiled_fwd_scan_f32_launch, K8's fp32 design with the xw stream
//   tiled_bwd_launch (K10)      <- _bwd_tiled_kernel (:106), the reverse
//       steps shared by both tiled VJPs (bwd_call, :414):
//       dh_t = round(dg_{t+1}) @ U^T + dh_cot_t (dhT at t = S-1), then the
//       gate backward; dg_t in the xw type, dc in fp32 (dc0 at the end).
//       dh_cot_t is the cotangent of h_seq in the xw type (the VJPs round
//       it, :355, :596), masked and scaled by inv under dropout (:162-170).
//       dh0 = round(dg_0) @ U^T and the weight gradients are products
//       outside the kernel in the JAX VJPs (:359-375, :599-623); here dh0
//       is the persistent K10's last product, and dU is K6's tensor-core
//       product (lstm_bwd.cu:lstm_bwd_dWU_launch) under bf16 compute;
//       under fp32 compute lstm_bwd_f32_launch, K6's persistent CUDA-core
//       design at groups of 2 blocks (lstm_bwd_f32.cu), dh0 its last
//       product too.
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
// K8 and K9 have two designs of one function (ops/cuda_cell_tiled.py:
// tiled_fwd_plan chooses from the type, the shape and the card), and a
// third under fp32 compute (tiled_fwd_f32_plan; lstm_tiled_f32.cu:
// tiled_fwd_f32_persist). K2 and K1,
// the resident family's forwards (lstm_fwd.cu), compute K9's and K8's
// functions, so under bf16 compute ops/cuda_cell.py:scan_layer and
// embed_layer0 run them on the persistent design too, through
// tiled_fwd_scan_launch and tiled_fwd_embed_launch with their own residual
// type (at the flagship's N = 1024 all of U's rows stay in shared memory);
// K1's blocks take a share of the batch rows (ops/cuda_cell_tiled.py:
// split_fwd_plan), K2's, K8's and K9's all of them.
//
// The persistent design (bf16 compute, B <= 128, a resident grid;
// fwd_mma.cuh:fwd_persist, which K15 of lstm_tp.cu takes too, on the step
// that the tensor-core K13 shares). One cooperative launch a window, a grid
// barrier between steps. A block owns 16 hidden units with their four gate
// columns and its batch rows (all of them here), so each step's epilogue
// needs nothing of another block; as many rows of its N x 64 slice of U
// as fit beside the ring stay in shared memory for the window (1024 of 2048
// at 5b's B = 128, 1344 at the eval batch of 16), the rest stream every
// step with the round(h_{t-1}) chunks through a three-slot cp.async ring; the products are mma.sync
// m16n8k16 (bf16 in, fp32 sums; csrc/mma.cuh), and the fp32 carry stays in
// registers. What bounds it then is the recurrence's dependence, not the
// products: every step each of the 128 blocks reads all of round(h_{t-1})
// from L2 (512 KB a block, 64 MB in all at B = 128), feeds it through
// ldmatrix and mma.sync, and waits at the grid barrier; on the H100 a step
// takes ~44 us at B = 128 and ~20 us at B = 16 (PERF.md), against ~4 us of
// the products at the tensor cores' peak. Holding more of U on chip moves
// little (U's rows are ~1/5 of the step's reads at B = 128). Left for later:
// TMA multicast of each h chunk over a cluster of blocks (cutting the L2
// reads by the cluster size), and wgmma in place of mma.sync (B read from
// shared memory by the tensor cores, no ldmatrix).
//
// K10 has two designs of one function as well (tiled_bwd_plan), and a
// third under fp32 compute (tiled_bwd_f32_plan; K6's lstm_bwd_f32.cu:
// lstm_bwd_f32_persist at groups of 2 blocks):
//
// The persistent design (bf16 compute, N a multiple of 32, a resident grid;
// tiled_bwd_persist), K6's persistent design (lstm_bwd.cu) with U streamed
// where it does not fit. The per-step K10 (below) spent ~296 us a step at
// 5b's shapes: 100 launches, fp32 FMAs, all of U^T (32 MB) through a
// two-stage ring every step, and a fresh U^T copy a call. Here a block owns
// 32 hidden units (U's rows, read in place) and 64 batch rows at B = 128
// (128 blocks, one an SM), the gate backward and the dc carry in the
// registers of the thread that owns (b, j); 14 of its 64 chunks of U's
// rows (128 gate columns each) sit in shared memory for the window, the
// other 50 stream each step beside round(dg_{t+1}) through a four-slot
// cp.async ring; dh_rec is mma.sync m16n8k16; dg is written once, in bf16.
// What bounds it is again each step's L2 reads and the barrier: a block
// reads 1 MB of dg_{t+1} and ~0.4 MB of U a step, ~183 MB over the grid,
// against ~4.3 us of products at the bf16 peak (PERF.md). Wider unit
// groups would read dg fewer times but hold less of U; a cluster sharing
// each dg chunk (TMA multicast) would cut those reads, not built.
//
// The per-step design (the shapes that no persistent design takes: B >
// 128, a grid that is not resident, N not a multiple of 32). The TPU
// kernel streams (N, wt) U tiles through VMEM in a sequential grid and
// gathers a step's gate chunks in scratch before the cell epilogue; Hopper
// blocks run in parallel and in no order, so the blocking is turned around:
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
// TF32 stays off for fp32 products, so fp32 keeps the CUDA cores.

#include <cooperative_groups.h>

#include "common.cuh"
#include "fwd_mma.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kJT = 32;    // hidden units per block, one per lane
constexpr int kWarps = 8;  // warps per block, each owning R batch rows

// Elements of T in one 16-byte copy (V), and in one 64-byte chunk of the
// contraction axis (KC).
template <typename T> struct Vec {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int KC = 64 / (int)sizeof(T);
};

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
    cp_async_16(&xs[r][q * Vec<T>::V], X + (size_t)b * ld + k0 + q * Vec<T>::V, 16);
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
      cp_async_16(&Us[st][kk][g][q * V],
                  U + (size_t)(k0 + kk) * n4 + (size_t)g * N + j0 + q * V, 16);
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
        cp_async_16(&Us[st][kk][q * V], UT + (size_t)(k0 + kk) * N + j0 + q * V, 16);
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

// ---------------------------------------------------------------------------
// K10 under bf16 compute: one persistent cooperative launch for the S
// reverse steps and dh0 (tiled_bwd_persist; ops/cuda_cell_tiled.py:
// tiled_bwd_plan chooses it). K6's persistent design (csrc/lstm_bwd.cu:
// lstm_bwd_persist) where U does not fit the resident grid's shared memory.
//
// A block owns kBUnits = 32 hidden units j0.. (U's rows j0.., read in place:
// no U^T) and `rows` batch rows b0.., so the grid is (N / 32) *
// ceil(B / rows) blocks, at most what is resident (64 x 2 = 128 at 5b's
// B = 128). The 4N-long gate axis is walked in chunks of kBKC columns: the
// first cres chunks of the block's U rows sit in shared memory for the
// whole window ([chunk][unit][column]), the rest stream every step through
// a ring of kBStages slots beside the chunks of round(dg_{t+1}) (cp.async,
// L2 only: other blocks wrote dg_{t+1} before the barrier). In each chunk
// warp w takes the 16 columns 16w.. as one k step of mma.sync m16n8k16
// (bf16 in, fp32 sums) for every (16-row, 8-unit) tile; the 8 partial sums
// of each (b, j) meet in shared memory and are added in warp order. Thread
// (warp, lane) owns unit j0 + lane of rows b0 + warp + 8i: it runs the gate
// backward in registers, the fp32 dc carried there for the window, and
// writes dg_t once, in bf16. A grid barrier closes each step; each step's
// g, c, c_{t-1} and dh_seq[t] are loaded before the barrier that precedes
// it. After step 0 one more product gives dh0 = round(dg_0) @ U^T.
constexpr int kBUnits = 32;
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;
constexpr int kBMaxRows = 64;             // batch rows of a block: 4 m tiles
constexpr int kBKC = 16 * kBWarps;        // gate columns of a chunk
constexpr int kBStages = 4;  // three and five slots were slower at 5b's shapes
constexpr int kBPitch = kBKC + kFPad;     // bf16 of a shared row
constexpr int kBRedPitch = kBUnits + 8;   // floats: float2 stores without conflicts
constexpr int kBElems = kBMaxRows / kBWarps;

// Dynamic shared memory of the persistent K10 (mirrored by
// ops/cuda_cell_tiled.py:bwd_persist_smem_bytes, which holds itself to
// tiled_bwd_persist_smem_bytes once a card): cres resident U chunks, then
// the ring, each slot a dg chunk of the block's m tiles and a U chunk; the
// cross-warp partial sums reuse the ring.
inline size_t bwd_persist_smem_bytes(int rows, int cres) {
  const size_t r16 = (size_t)(rows + 15) / 16 * 16;
  const size_t ring = 2 * (size_t)kBStages * (r16 + kBUnits) * kBPitch;
  const size_t red = (size_t)kBWarps * r16 * kBRedPitch * 4;
  return 2 * (size_t)cres * kBUnits * kBPitch + (ring > red ? ring : red);
}

template <typename RT>
__global__ void __launch_bounds__(kBThreads, 1)
tiled_bwd_persist(const __nv_bfloat16* __restrict__ U,  // (N, 4N)
                  const RT* __restrict__ g_seq,         // (S, B, 4N)
                  const RT* __restrict__ c_seq,         // (S, B, N)
                  const float* __restrict__ c0,         // (B, N)
                  const __nv_bfloat16* __restrict__ dh_seq,  // (S, B, N)
                  const float* __restrict__ dhT,        // (B, N)
                  float* __restrict__ dc,               // (B, N): dcT in, dc0 out
                  // (S, B, 4N) dg_seq: written and read within the launch,
                  // so neither const nor __restrict__ (no non-coherent loads)
                  __nv_bfloat16* dg,
                  float* __restrict__ dg32,  // (S, B, 4N) fp32 dg, or null
                  float* __restrict__ dh0,   // (B, N)
                  Dropout drop, int S, int B, int N, int rows, int cres,
                  int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * N;
  const int r16 = (rows + 15) / 16 * 16;
  const int aslot = r16 * kBPitch;              // bf16 of a slot's dg chunk
  const int slot = aslot + kBUnits * kBPitch;   // bf16 of a slot
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = Us + (size_t)cres * kBUnits * kBPitch;
  float* red = reinterpret_cast<float*>(ring);  // [warp][row][unit]
  const int groups = N / kBUnits;
  const int j0 = (blockIdx.x % groups) * kBUnits;
  const int b0 = (blockIdx.x / groups) * rows;
  const int nrows = min(rows, B - b0);
  const int mtiles = (nrows + 15) / 16;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int j = j0 + lane;
  const size_t bn = (size_t)B * N, bk = (size_t)B * K;
  cg::grid_group grid = cg::this_grid();

  // 16 bytes e < kBUnits * 16 of the block's U rows in chunk c into dst
  const auto u_copy = [&](__nv_bfloat16* dst, int c, int e) {
    const int u = e / 16, p = e % 16;
    cp_async_16(dst + u * kBPitch + p * 8,
                U + (size_t)(j0 + u) * K + (size_t)c * kBKC + p * 8, 16);
  };
  for (int e = tid; e < cres * kBUnits * 16; e += kBThreads) {
    const int c = e / (kBUnits * 16);
    u_copy(Us + (size_t)c * kBUnits * kBPitch, c, e % (kBUnits * 16));
  }
  cp_async_commit();

  // this thread's (b, j): rows b0 + warp + 8i that lie in the block's part
  float dcr[kBElems], gin[kBElems][4], cin[kBElems], cpin[kBElems], dhin[kBElems];
  const auto valid = [&](int i) { return warp + 8 * i < nrows; };
  const auto index = [&](int i) { return (size_t)(b0 + warp + 8 * i) * N + j; };
#pragma unroll
  for (int i = 0; i < kBElems; ++i) dcr[i] = valid(i) ? dc[index(i)] : 0.0f;
  const auto load_inputs = [&](int t) {
#pragma unroll
    for (int i = 0; i < kBElems; ++i) {
      if (!valid(i)) continue;
      const size_t idx = index(i);
      const size_t gb = t * bk + (size_t)(b0 + warp + 8 * i) * K + j;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) gin[i][qq] = to_f32(g_seq[gb + (size_t)qq * N]);
      cin[i] = to_f32(c_seq[t * bn + idx]);
      cpin[i] = t > 0 ? to_f32(c_seq[(t - 1) * bn + idx]) : c0[idx];
      dhin[i] = __bfloat162float(dh_seq[t * bn + idx]);
    }
  };
  load_inputs(S - 1);
  cp_async_wait<0>();
  __syncthreads();

  const int nchunks = K / kBKC;
  for (int t = S - 1; t >= -1; --t) {
    float dh_rec[kBElems];
    if (t == S - 1) {
#pragma unroll
      for (int i = 0; i < kBElems; ++i) dh_rec[i] = valid(i) ? dhT[index(i)] : 0.0f;
    } else {
      // dh_rec = round(dg_{t+1}) @ U^T over the block's rows and units
      const __nv_bfloat16* dgn = dg + (t + 1) * bk;
      const auto load_chunk = [&](int c) {
        __nv_bfloat16* st = ring + (size_t)(c % kBStages) * slot;
        for (int p = tid; p < mtiles * 16 * (kBKC / 8); p += kBThreads) {
          const int r = p / (kBKC / 8), k = (p % (kBKC / 8)) * 8;
          const bool in = r < nrows;
          cp_async_16(st + r * kBPitch + k,
                      in ? dgn + (size_t)(b0 + r) * K + (size_t)c * kBKC + k : dgn,
                      in ? 16 : 0);
        }
        if (c >= cres)
          for (int e = tid; e < kBUnits * 16; e += kBThreads) u_copy(st + aslot, c, e);
      };
      float acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[mt][nt][x] = 0.0f;
#pragma unroll
      for (int c = 0; c < kBStages - 1; ++c) {
        if (c < nchunks) load_chunk(c);
        cp_async_commit();
      }
      for (int c = 0; c < nchunks; ++c) {
        cp_async_wait<kBStages - 2>();
        __syncthreads();  // chunk c is in, and chunk c - 1's slot is free
        if (c + kBStages - 1 < nchunks) load_chunk(c + kBStages - 1);
        cp_async_commit();
        const __nv_bfloat16* st = ring + (size_t)(c % kBStages) * slot;
        const __nv_bfloat16* ub = c < cres ? Us + (size_t)c * kBUnits * kBPitch : st + aslot;
        const int kk = warp * 16;
        // units 16h.. (k 0-7 | 8-15) x (units 0-7 | 8-15): b0, b1 of n
        // tile 2h, then of n tile 2h + 1
        unsigned bq[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ldmatrix_x4(bq[h], ub + (16 * h + lane % 8 + 8 * (lane / 16)) * kBPitch + kk +
                                 8 * ((lane / 8) % 2));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= mtiles) break;
          unsigned a[4];
          ldmatrix_x4(a, st + (mt * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * kBPitch + kk +
                             8 * (lane / 16));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a, bq[nt / 2] + 2 * (nt % 2));
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring: reuse it as red
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mtiles) break;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                red + ((size_t)warp * r16 + mt * 16 + g + 8 * h) * kBRedPitch + nt * 8 + 2 * q) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kBElems; ++i) {
        float v = 0.0f;
        if (valid(i))
#pragma unroll
          for (int w = 0; w < kBWarps; ++w)
            v += red[((size_t)w * r16 + warp + 8 * i) * kBRedPitch + lane];
        dh_rec[i] = v;
      }
    }
    if (t == -1) {
#pragma unroll
      for (int i = 0; i < kBElems; ++i)
        if (valid(i)) {
          dh0[index(i)] = dh_rec[i];
          dc[index(i)] = dcr[i];
        }
      break;
    }
#pragma unroll
    for (int i = 0; i < kBElems; ++i) {
      if (!valid(i)) continue;
      const size_t idx = index(i);
      float dh_cot = dhin[i];
      // __fmul_rn: the product rounds before the add, as in the TPU kernel
      if (drop.on) dh_cot = keep_bit(drop, t, idx) ? __fmul_rn(dh_cot, drop.inv) : 0.0f;
      float d[4];
      gate_bwd(gin[i][0], gin[i][1], gin[i][2], gin[i][3], cin[i], cpin[i],
               dh_cot + dh_rec[i], dcr[i], standard, d, &dcr[i]);
      const size_t gb = t * bk + (size_t)(b0 + warp + 8 * i) * K + j;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        dg[gb + (size_t)qq * N] = __float2bfloat16(d[qq]);
        if (dg32 != nullptr) dg32[gb + (size_t)qq * N] = d[qq];
      }
    }
    if (t > 0) load_inputs(t - 1);
    grid.sync();  // dg_t is complete before any block reads it
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
              int N, int standard, cudaStream_t stream, int* launches) {
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
    ++*launches;
  }
  return 0;
}

// The per-step design, S launches. hc: (2, B, N) in CT, round(h0) in its
// first half on entry (the halves alternate between steps); c: c0 on entry,
// cT after; hT out.
template <typename CT, typename RT, bool EMBED>
int run_fwd(const void* U, const void* xw, const void* W, const float* bias,
            const int* ids, void* hc, float* c, float* hT, void* hseq,
            void* cseq, void* gseq, void* hdrop, Dropout drop, int S, int B,
            int N, int standard, cudaStream_t stream, int* launches) {
  const auto f = [&](auto run) {
    return run(U, xw, W, bias, ids, hc, c, hT, hseq, cseq, gseq, hdrop, drop,
               S, B, N, standard, stream, launches);
  };
  if (hdrop != nullptr)
    return wide_tile(B) ? f(run_fwd_r<CT, RT, EMBED, true, 8>)
                        : f(run_fwd_r<CT, RT, EMBED, true, 2>);
  return wide_tile(B) ? f(run_fwd_r<CT, RT, EMBED, false, 8>)
                      : f(run_fwd_r<CT, RT, EMBED, false, 2>);
}

// K8 or K9 (and K1, K2): the persistent design of fwd_mma.cuh when
// kres >= 0 (bf16 compute only), rows batch rows a block, else the per-step
// one.
template <bool EMBED>
int fwd(int ctype, int rtype, const void* U, const void* xw, const void* W,
        const float* bias, const int* ids, void* hc, float* c, float* hT,
        void* hseq, void* cseq, void* gseq, void* hdrop, Dropout drop, int S,
        int B, int N, int standard, int kres, int rows, cudaStream_t stream,
        int* launches) {
  using bf = __nv_bfloat16;
  if (kres >= 0) {
    const auto f = [&](auto run) {
      return run(U, xw, W, bias, ids, hc, c, hT, hseq, cseq, gseq, hdrop, drop,
                 S, B, N, rows, kres, standard, stream, launches);
    };
    if (ctype == 1 && rtype == 0) return f(run_fwd_persist<float, EMBED, false>);
    if (ctype == 1 && rtype == 1) return f(run_fwd_persist<bf, EMBED, false>);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [&](auto run) {
    return run(U, xw, W, bias, ids, hc, c, hT, hseq, cseq, gseq, hdrop, drop,
               S, B, N, standard, stream, launches);
  };
  if (ctype == 0 && rtype == 0) return f(run_fwd<float, float, EMBED>);
  if (ctype == 0 && rtype == 1) return f(run_fwd<float, bf, EMBED>);
  if (ctype == 1 && rtype == 0) return f(run_fwd<bf, float, EMBED>);
  if (ctype == 1 && rtype == 1) return f(run_fwd<bf, bf, EMBED>);
  return static_cast<int>(cudaErrorInvalidValue);
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
            cudaStream_t stream, int* launches) {
  const int err =
      wide_tile(B)
          ? run_bwd_r<CT, RT, 8>(UT, g_seq, c_seq, c0, dh_seq, dhT, dc, dg,
                                 drop, S, B, N, standard, stream)
          : run_bwd_r<CT, RT, 2>(UT, g_seq, c_seq, c0, dh_seq, dhT, dc, dg,
                                 drop, S, B, N, standard, stream);
  if (err == 0) *launches += S;
  return err;
}

// The persistent K10 under bf16 compute, one cooperative launch: U (N, 4N)
// in bf16, rows batch rows a block, cres chunks of U resident; dh0 out.
template <typename RT>
int run_bwd_persist(const void* U, const void* g_seq, const void* c_seq,
                    const float* c0, const void* dh_seq, const float* dhT,
                    float* dc, void* dg, float* dg32, float* dh0, Dropout drop, int S,
                    int B, int N, int rows, int cres, int standard,
                    cudaStream_t stream, int* launches) {
  if (N % kBUnits != 0 || rows < 16 || rows > kBMaxRows || rows % 16 != 0 ||
      S < 1 || cres < 0 || cres > 4 * N / kBKC || dh0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = tiled_bwd_persist<RT>;
  const size_t smem = bwd_persist_smem_bytes(rows, cres);
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
                                                        kBThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop[dev]) return static_cast<int>(cudaErrorNotSupported);
  const int grid = (N / kBUnits) * ((B + rows - 1) / rows);
  // every block must be resident at once, or the grid barrier never opens
  if (grid > sms[dev] * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  using bf = __nv_bfloat16;
  const bf* u = static_cast<const bf*>(U);
  const RT* gs = static_cast<const RT*>(g_seq);
  const RT* cs = static_cast<const RT*>(c_seq);
  const bf* dh = static_cast<const bf*>(dh_seq);
  bf* d = static_cast<bf*>(dg);
  void* args[] = {&u, &gs, &cs, &c0, &dh, &dhT, &dc, &d, &dg32, &dh0, &drop,
                  &S, &B, &N, &rows, &cres, &standard};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kBThreads), args, smem,
                                    stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

}  // namespace

// Type codes: 0 = fp32, 1 = bf16. Every pointer is 16-byte aligned and N a
// multiple of 32 (the wrappers check both). U (N, 4N), W (M, 4N) and the xw
// stream are in the compute type; bias, c and hT fp32; ids int32 (S, B);
// hc (2, B, N) in the compute type with round(h0) in its first half; the
// sequences in the residual type; hdrop null for no dropout, else the
// masked stream of (seed, keep, inv). kres >= 0: the persistent design
// with kres rows of U in shared memory and `rows` batch rows a block
// (ops/cuda_cell_tiled.py:fwd_layout; bf16 compute, N a multiple of 64,
// B <= 128; rows = B for K8, K9 and K2, fewer for K1); -1: the per-step
// design, rows unread. Adds its kernel launches to *launches.
extern "C" int tiled_fwd_embed_launch(
    int ctype, int rtype, const void* W, const void* U, const void* bias,
    const void* ids, void* hc, void* c, void* hT, void* hseq, void* cseq,
    void* gseq, void* hdrop, int S, int B, int N, int standard, int kres,
    int rows, unsigned seed, unsigned keep, float inv, void* stream,
    int* launches) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  return fwd<true>(ctype, rtype, U, nullptr, W, static_cast<const float*>(bias),
                   static_cast<const int*>(ids), hc, static_cast<float*>(c),
                   static_cast<float*>(hT), hseq, cseq, gseq, hdrop, drop, S, B,
                   N, standard, kres, rows, static_cast<cudaStream_t>(stream),
                   launches);
}

extern "C" int tiled_fwd_scan_launch(
    int ctype, int rtype, const void* U, const void* xw, void* hc, void* c,
    void* hT, void* hseq, void* cseq, void* gseq, void* hdrop, int S, int B,
    int N, int standard, int kres, int rows, unsigned seed, unsigned keep,
    float inv, void* stream, int* launches) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  return fwd<false>(ctype, rtype, U, xw, nullptr, nullptr, nullptr, hc,
                    static_cast<float*>(c), static_cast<float*>(hT), hseq, cseq,
                    gseq, hdrop, drop, S, B, N, standard, kres, rows,
                    static_cast<cudaStream_t>(stream), launches);
}

// Bytes of dynamic shared memory a persistent forward block takes with
// `rows` batch rows, at hidden N, with kres resident rows of U.
extern "C" size_t tiled_fwd_persist_smem_bytes(int rows, int N, int kres) {
  return fwd_smem_bytes(rows, kres);
}

// Bytes of dynamic shared memory a persistent K10 block takes with `rows`
// batch rows and cres resident chunks of U.
extern "C" size_t tiled_bwd_persist_smem_bytes(int rows, int cres) {
  return bwd_persist_smem_bytes(rows, cres);
}

// K10. dh_seq (S, B, N) in the compute type (the xw type); the residual
// sequences in the residual type; c0 and dhT fp32; dc holds dcT on entry
// and dc0 on return; dg receives the (S, B, 4N) dg sequence in the compute
// type. drop_on, seed, keep, inv: the dropout of the forward's masked
// stream. rows >= 0: the persistent design (bf16 compute;
// ops/cuda_cell_tiled.py:tiled_bwd_plan gives rows and cres), U is U
// (N, 4N), dh0 (B, N) fp32 receives round(dg_0) @ U^T and dg32, unless
// null, the (S, B, 4N) fp32 dg; rows -1: the per-step design, U is U^T
// (4N, N) and dg32, dh0 are not written. Adds its kernel launches to
// *launches.
extern "C" int tiled_bwd_launch(
    int ctype, int rtype, const void* U, const void* g_seq, const void* c_seq,
    const void* c0, const void* dh_seq, const void* dhT, void* dc, void* dg,
    void* dg32, void* dh0, int S, int B, int N, int standard, int rows, int cres,
    int drop_on, unsigned seed, unsigned keep, float inv, void* stream,
    int* launches) {
  const Dropout drop{drop_on, seed, keep, inv};
  using bf = __nv_bfloat16;
  if (rows >= 0) {
    const auto f = [&](auto run) {
      return run(U, g_seq, c_seq, static_cast<const float*>(c0), dh_seq,
                 static_cast<const float*>(dhT), static_cast<float*>(dc), dg,
                 static_cast<float*>(dg32), static_cast<float*>(dh0), drop, S, B,
                 N, rows, cres, standard,
                 static_cast<cudaStream_t>(stream), launches);
    };
    if (ctype == 1 && rtype == 0) return f(run_bwd_persist<float>);
    if (ctype == 1 && rtype == 1) return f(run_bwd_persist<bf>);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [&](auto run) {
    return run(U, g_seq, c_seq, static_cast<const float*>(c0), dh_seq,
               static_cast<const float*>(dhT), static_cast<float*>(dc), dg,
               drop, S, B, N, standard, static_cast<cudaStream_t>(stream),
               launches);
  };
  if (ctype == 0 && rtype == 0) return f(run_bwd<float, float>);
  if (ctype == 0 && rtype == 1) return f(run_bwd<float, bf>);
  if (ctype == 1 && rtype == 0) return f(run_bwd<bf, float>);
  if (ctype == 1 && rtype == 1) return f(run_bwd<bf, bf>);
  return static_cast<int>(cudaErrorInvalidValue);
}
