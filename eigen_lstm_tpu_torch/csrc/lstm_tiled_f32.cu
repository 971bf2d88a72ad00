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
//   tiled_fwd_embed_f32_launch (K8) <- pallas_cell_tiled.py:
//       _fwd_tiled_embed_kernel (layer 0, :429): g = (W[ids_t] +
//       h_{t-1} @ U) + b
//   tiled_fwd_scan_f32_launch (K9)  <- _fwd_tiled_kernel (layers >= 1,
//       :52): g = xw_t + h_{t-1} @ U
//
// ops/cuda_cell_tiled.py:tiled_fwd_f32_plan chooses them for B <= 128, N a
// multiple of 32 and a grid of N / 8 blocks the card holds at once;
// elsewhere the per-step designs of lstm_tiled.cu run. The epilogue is that
// of lstm_tiled.cu's per-step kernels (common.cuh: cell, keep_bit), so
// every design computes one function.

#include <cooperative_groups.h>

#include "common.cuh"
#include "fwd_mma.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// K8 and K9 under fp32 compute: one persistent cooperative launch a window
// on CUDA cores (tiled_fwd_f32_persist, EMBED for K8;
// ops/cuda_cell_tiled.py:tiled_fwd_f32_plan chooses it): the persistent
// forward's idea (fwd_mma.cuh:fwd_persist) done with FFMAs. What held the
// per-step design back at the flagship's fp32 shapes (S = 256, B = 128,
// N = 1024): 256 launches a window, each with its ramp and tail, a grid of
// 64 blocks on 132 SMs, and every block reading its 512 KB slice of U from
// L2 every step (32 MB of U a step): ~86 us a step on an H100 against ~16
// us of FFMA at the fp32 peak. U in fp32 (16.8 MB) does not fit one block,
// but it fits the SMs' shared memory together.
//
// A block owns kPUnits = 8 hidden units with their four gate columns (N / 8
// blocks: 128 at N = 1024, one an SM) and every batch row, and holds its N x
// 32 slice of U in shared memory for the window ([k][unit][gate], 128 KB at
// N = 1024), read from device memory once. Each step the rows of
// round(h_{t-1}) (fp32, B x N: 512 KB at B = 128) arrive through a
// cp.async.cg ring of KC-column slots, L2 only (other blocks wrote them
// before the grid barrier). The product splits each chunk's k kPSplit ways:
// split s = tid / 64 takes a quarter of the chunk, and its thread (pu, pq) =
// (tid % 4, tid % 64 / 4) a register tile of 2 R rows (pq + 16 i) by 8
// columns (units 2 pu, 2 pu + 1, four gates each): each 4 values of k are 2
// R 16-byte loads of h and 8 of U for 64 R FMAs. Split s takes the k with (k
// mod 32) / 8 = s in every ring layout, so a sum's order does not depend on
// the batch (32 rows or 128 give a row the same bits). On the H100 a shared
// load costs the bytes it hands each lane, broadcast or not: the first
// design of this kernel (4 rows x 4 gates a thread, no split) spent two
// shared cycles per FFMA cycle; 8 x 8 tiles spend one. After the loop the
// splits' partial sums meet in the ring's memory and each owner adds them in
// split order. Thread (u, q) = (tid % 8, tid / 8) owns unit j0 + u of rows q
// + 32 i, i < R (R = 1, 2, 4 for B <= 32, 64, 128) with all four gates, and
// runs the epilogue in its registers: K8's (acc + W_row) + b (the W row
// issued a step ahead, its id two) or K9's acc + xw_t (the xw row issued a
// step ahead), the gates, the cell, the fp32 carry (in registers
// for the window), h_t into the other half of hc, the sequences in RT and
// under dropout the masked stream, as tiled_fwd_step writes them. A grid
// barrier closes each step. What bounds it then: the loop's shared loads, as
// busy as its FMAs, and every block reading all of h from L2 each step (64
// MB over the grid at B = 128). The slice of U always fits where the grid
// does: N / 8 blocks resident at one an SM need N <= 8 x the SMs (1056 on an
// H100), whose slice (132 KB) leaves room for a ring; past that (N = 2048,
// say) the plan refuses and K8 and K9 take the per-step design.
constexpr int kPUnits = 8;
constexpr int kPCols = 4 * kPUnits;   // [unit][gate]
constexpr int kPThreads = 256;
constexpr int kPRowGroups = kPThreads / kPUnits;   // rows q of a thread, q < 32
constexpr int kPSplit = 4;            // ways the product splits a chunk's k
// k of each 32 that a split takes: split s the k with (k mod 32) / 8 = s,
// whatever the ring's slots, so every layout sums in one order
constexpr int kPSplitK = 8;

// Floats of a ring row of KC columns: 4 rows' 16 bytes in distinct banks.
__host__ __device__ constexpr int f32_pitch(int KC) { return KC + 4; }

// Rows a thread owns at batch B: 1, 2 or 4 (B <= 32, 64, 128).
inline int f32_rows_per_thread(int B) { return B <= 32 ? 1 : B <= 64 ? 2 : 4; }

// Dynamic shared memory of a block at batch B and hidden N with a ring of
// `stages` slots of KC columns (mirrored by ops/cuda_cell_tiled.py:
// f32_persist_smem_bytes, which holds itself to tiled_fwd_f32_smem_bytes
// once a card): the slice of U, then the ring, each slot 32 R rows; the
// product splits' partial sums (kPSplit x 32 R rows x kPCols) reuse it.
inline size_t f32_persist_smem_bytes(int B, int N, int KC, int stages) {
  const size_t rows = (size_t)kPRowGroups * f32_rows_per_thread(B);
  const size_t ring = stages * rows * f32_pitch(KC), red = kPSplit * rows * kPCols;
  return sizeof(float) * ((size_t)N * kPCols + (ring > red ? ring : red));
}

template <typename RT, bool EMBED, int R, int KC, int STAGES>
__global__ void __launch_bounds__(kPThreads, 1)
tiled_fwd_f32_persist(const float* __restrict__ U,     // (N, 4N)
                      // EMBED: W (M, 4N); else K9's xw stream (S, B, 4N)
                      const float* __restrict__ W,
                      const float* __restrict__ bias,  // (4N,), EMBED
                      const int* __restrict__ ids,     // (S, B), EMBED
                      // (2, B, N) h: written and read within the launch,
                      // so neither const nor __restrict__ (no non-coherent loads)
                      float* hc,
                      float* __restrict__ c,      // (B, N): c0 in, cT out
                      float* __restrict__ hT,     // (B, N)
                      RT* __restrict__ hseq,      // (S, B, N)
                      RT* __restrict__ cseq,      // (S, B, N) or null
                      RT* __restrict__ gseq,      // (S, B, 4N) or null
                      RT* __restrict__ hdrop,     // (S, B, N) under dropout
                      Dropout drop, int S, int B, int N, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = f32_pitch(KC);
  constexpr int RR = 2 * R;                 // product rows of a thread
  static_assert(KC % (kPSplit * kPSplitK) == 0, "a slot holds whole 32-k blocks");
  float* Us = reinterpret_cast<float*>(smem);        // [k][unit][gate]
  float* ring = Us + (size_t)N * kPCols;             // STAGES x [32 R][P]
  float* red = ring;                                 // [split][32 R][kPCols]
  constexpr int slot = kPRowGroups * R * P;
  const int tid = threadIdx.x;
  // the product: split s = tid / 64 takes k s * KQ.. of each chunk;
  // its thread (pu, pq) = (tid % 4, tid % 64 / 4) units 2 pu, 2 pu + 1 of
  // rows pq + 16 i, i < 2R
  const int split = tid / 64, pu = tid % 4, pq = tid % 64 / 4;
  // the epilogue: thread (u, q) = (tid % 8, tid / 8) owns unit j0 + u of
  // rows q + 32 i, i < R
  const int u = tid % kPUnits, q = tid / kPUnits;
  const int j0 = blockIdx.x * kPUnits, j = j0 + u;
  const size_t n4 = 4 * (size_t)N, bn = (size_t)B * N;
  cg::grid_group grid = cg::this_grid();

  // the block's slice of U, once a window: consecutive threads read
  // consecutive units of one gate row
  for (int e = tid; e < N * kPCols; e += kPThreads) {
    const int k = e / kPCols, g = (e / kPUnits) % 4, uu = e % kPUnits;
    Us[k * kPCols + uu * 4 + g] = U[(size_t)k * n4 + (size_t)g * N + j0 + uu];
  }

  // of the thread's epilogue rows: pin[i][g] the step's input term (K8 its
  // W row, K9 its xw_t row) and nxt[i][g] the next step's (loaded at the
  // start of the step before, so that the loop hides it), idn[i] K8's id a
  // step further on, cr[i] the carry; bs[g]: K8's bias
  float cr[R], pin[R][4], nxt[R][4], bs[4];
  int idn[R];
  const auto valid = [&](int i) { return q + kPRowGroups * i < B; };
  const auto id_of = [&](int t, int i) { return ids[(size_t)t * B + q + kPRowGroups * i]; };
  const auto w_row = [&](int id, float (&dst)[4]) {
    const float* w = W + (size_t)id * n4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) dst[g] = w[(size_t)g * N];
  };
  const auto xw_row = [&](int t, int i, float (&dst)[4]) {
    const float* x = W + (size_t)t * B * n4 + (size_t)(q + kPRowGroups * i) * n4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) dst[g] = x[(size_t)g * N];
  };
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!valid(i)) continue;
    cr[i] = c[(size_t)(q + kPRowGroups * i) * N + j];
    if constexpr (EMBED) {
      w_row(id_of(0, i), pin[i]);
      if (S > 1) idn[i] = id_of(1, i);
    } else {
      xw_row(0, i, pin[i]);
    }
  }
  if constexpr (EMBED)
#pragma unroll
    for (int g = 0; g < 4; ++g) bs[g] = bias[(size_t)g * N + j];
  __syncthreads();  // the slice of U is in

  const int nchunks = N / KC;
  for (int t = 0; t < S; ++t) {
    const float* hin = hc + (size_t)(t % 2) * bn;
    if (t + 1 < S)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!valid(i)) continue;
        if constexpr (EMBED) {
          w_row(idn[i], nxt[i]);
          if (t + 2 < S) idn[i] = id_of(t + 2, i);
        } else {
          xw_row(t + 1, i, nxt[i]);
        }
      }
    // chunk ch: columns ch * KC.. of h's B rows
    const auto load_chunk = [&](int ch) {
      float* st = ring + (size_t)(ch % STAGES) * slot;
      for (int e = tid; e < B * (KC / 4); e += kPThreads) {
        const int r = e / (KC / 4), p = e % (KC / 4);
        cp_async_16(st + r * P + 4 * p, hin + (size_t)r * N + ch * KC + 4 * p, 16);
      }
    };
    // acc[i][x]: row pq + 16 i, unit 2 pu + x / 4, gate x % 4
    float acc[RR][8];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[i][x] = 0.0f;
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
      const float* hs = ring + (size_t)(ch % STAGES) * slot + pq * P + split * kPSplitK;
      const float* ub = Us + ((size_t)ch * KC + split * kPSplitK) * kPCols + 8 * pu;
#pragma unroll
      for (int kb = 0; kb < KC; kb += kPSplit * kPSplitK)
#pragma unroll
      for (int kk = kb; kk < kb + kPSplitK; kk += 4) {
        float4 hv[RR];
#pragma unroll
        for (int i = 0; i < RR; ++i)
          hv[i] = *reinterpret_cast<const float4*>(hs + i * (kPRowGroups / 2) * P + kk);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 w0 = *reinterpret_cast<const float4*>(ub + (kk + v) * kPCols);
          const float4 w1 = *reinterpret_cast<const float4*>(ub + (kk + v) * kPCols + 4);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < RR; ++i) {
            const float x = v == 0 ? hv[i].x : v == 1 ? hv[i].y : v == 2 ? hv[i].z : hv[i].w;
#pragma unroll
            for (int y = 0; y < 8; ++y) acc[i][y] = fmaf(x, wv[y], acc[i][y]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: reuse it as red
    // the splits' partial sums meet in shared memory, added in split order
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      float* dst = red + ((size_t)split * kPRowGroups * R + pq + 16 * i) * kPCols + 8 * pu;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!valid(i)) continue;
      const int b = q + kPRowGroups * i;
      constexpr size_t sp = (size_t)kPRowGroups * R * kPCols;   // a split's partials
      float4 v[kPSplit];
#pragma unroll
      for (int x = 0; x < kPSplit; ++x)
        v[x] = *reinterpret_cast<const float4*>(red + x * sp + (size_t)b * kPCols + 4 * u);
      const float sums[4] = {((v[0].x + v[1].x) + v[2].x) + v[3].x,
                             ((v[0].y + v[1].y) + v[2].y) + v[3].y,
                             ((v[0].z + v[1].z) + v[2].z) + v[3].z,
                             ((v[0].w + v[1].w) + v[2].w) + v[3].w};
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        // K8: (acc + W_row) + b; K9: acc + xw_t, as tiled_fwd_step sums
        float s = sums[g] + pin[i][g];
        if constexpr (EMBED) s += bs[g];
        gate[g] = g < 3 ? sigmoid(s) : tanhf(s);
      }
      const size_t idx = (size_t)b * N + j, ts = (size_t)t * bn;
      float h, cc;
      cell(gate, cr[i], standard, &h, &cc);
      cr[i] = cc;
      hc[(size_t)((t + 1) % 2) * bn + idx] = h;
      hseq[ts + idx] = from_f32<RT>(h);
      if (drop.on)
        hdrop[ts + idx] = from_f32<RT>(keep_bit(drop, t, idx) ? h * drop.inv : 0.0f);
      if (cseq != nullptr) cseq[ts + idx] = from_f32<RT>(cc);
      if (gseq != nullptr)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gseq[4 * ts + (size_t)b * n4 + (size_t)g * N + j] = from_f32<RT>(gate[g]);
      if (t == S - 1) {
        hT[idx] = h;
        c[idx] = cc;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) pin[i][g] = nxt[i][g];
    // h_t is complete before any block reads it, and the ring's partial
    // sums are read before the next chunks land; every block reaches it
    // every step, the last one too
    grid.sync();
  }
}

// One cooperative launch of tiled_fwd_f32_persist<RT, EMBED, R, KC, STAGES>
// on `stream`, R the rows a thread owns at B, W K9's xw stream where
// !EMBED. Returns 0 and adds the launch to *launches, or the error (the
// grid must be resident at once, or its barrier never opens).
template <typename RT, bool EMBED, int R, int KC, int STAGES>
int run_fwd_f32(const void* U, const void* W, const float* bias, const int* ids,
                void* hc, float* c, float* hT, void* hseq, void* cseq, void* gseq,
                void* hdrop, Dropout drop, int S, int B, int N, int standard,
                cudaStream_t stream, int* launches) {
  if (N % KC != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = tiled_fwd_f32_persist<RT, EMBED, R, KC, STAGES>;
  const size_t smem = f32_persist_smem_bytes(B, N, KC, STAGES);
  const int grid = N / kPUnits;
  const int fits = cooperative_fits(reinterpret_cast<const void*>(kernel),
                                    kPThreads, smem, grid);
  if (fits != 0) return fits;
  const float* u = static_cast<const float*>(U);
  const float* w = static_cast<const float*>(W);
  float* h = static_cast<float*>(hc);
  RT* hs = static_cast<RT*>(hseq);
  RT* cs = static_cast<RT*>(cseq);
  RT* gs = static_cast<RT*>(gseq);
  RT* hd = static_cast<RT*>(hdrop);
  void* args[] = {&u, &w, &bias, &ids, &h, &c, &hT, &hs, &cs, &gs, &hd,
                  &drop, &S, &B, &N, &standard};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kPThreads), args,
      smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

// The ring layouts the library is built for: (rows a thread, KC, stages),
// as ops/cuda_cell_tiled.py:F32_RINGS lists them.
#define F32_LAYOUTS(X) X(1, 128, 4) X(1, 32, 3) X(2, 64, 4) X(2, 32, 3) \
  X(4, 64, 2) X(4, 32, 3)

template <typename RT, bool EMBED>
int fwd_f32(const void* U, const void* W, const float* bias, const int* ids,
            void* hc, float* c, float* hT, void* hseq, void* cseq, void* gseq,
            void* hdrop, Dropout drop, int S, int B, int N, int standard,
            int kc, int stages, cudaStream_t stream, int* launches) {
  if (B < 1 || B > kPRowGroups * 4 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(U, W, bias, ids, hc, c, hT, hseq, cseq, gseq, hdrop, drop, S, B,
               N, standard, stream, launches);
  };
  const int R = f32_rows_per_thread(B);
#define F32_CASE(r, k, st) \
  if (R == r && kc == k && stages == st) return f(run_fwd_f32<RT, EMBED, r, k, st>);
  F32_LAYOUTS(F32_CASE)
#undef F32_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K8 under fp32 compute, the persistent CUDA-core design
// (ops/cuda_cell_tiled.py:tiled_fwd_f32_plan): W (M, 4N), U (N, 4N), bias
// and c, hT fp32; ids int32 (S, B); hc (2, B, N) fp32 with h0 in its first
// half; the sequences in the residual type (rtype 0 fp32, 1 bf16); hdrop
// null for no dropout, else the masked stream of (seed, keep, inv). N a
// multiple of 32, 1 <= B <= 128. One cooperative launch, added to
// *launches.
extern "C" int tiled_fwd_embed_f32_launch(
    int rtype, const void* W, const void* U, const void* bias, const void* ids,
    void* hc, void* c, void* hT, void* hseq, void* cseq, void* gseq,
    void* hdrop, int S, int B, int N, int standard, int kc, int stages,
    unsigned seed, unsigned keep, float inv, void* stream, int* launches) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, W, static_cast<const float*>(bias), static_cast<const int*>(ids),
               hc, static_cast<float*>(c), static_cast<float*>(hT), hseq, cseq,
               gseq, hdrop, drop, S, B, N, standard, kc, stages,
               static_cast<cudaStream_t>(stream), launches);
  };
  if (rtype == 0) return f(fwd_f32<float, true>);
  if (rtype == 1) return f(fwd_f32<__nv_bfloat16, true>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9 under fp32 compute, the same persistent CUDA-core design with the xw
// stream (S, B, 4N) fp32 in place of W's rows and the bias: g = xw_t +
// h_{t-1} @ U. Arguments as tiled_fwd_embed_f32_launch's.
extern "C" int tiled_fwd_scan_f32_launch(
    int rtype, const void* U, const void* xw, void* hc, void* c, void* hT,
    void* hseq, void* cseq, void* gseq, void* hdrop, int S, int B, int N,
    int standard, int kc, int stages, unsigned seed, unsigned keep, float inv,
    void* stream, int* launches) {
  const Dropout drop{hdrop != nullptr, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, xw, nullptr, nullptr, hc, static_cast<float*>(c),
               static_cast<float*>(hT), hseq, cseq, gseq, hdrop, drop, S, B, N,
               standard, kc, stages, static_cast<cudaStream_t>(stream), launches);
  };
  if (rtype == 0) return f(fwd_f32<float, false>);
  if (rtype == 1) return f(fwd_f32<__nv_bfloat16, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a block of K8's (and K9's) fp32
// persistent design takes at batch B and hidden N.
extern "C" size_t tiled_fwd_f32_smem_bytes(int B, int N, int kc, int stages) {
  return f32_persist_smem_bytes(B, N, kc, stages);
}
