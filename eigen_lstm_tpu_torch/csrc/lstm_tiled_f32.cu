// The tiled-U LSTM recurrence under fp32 compute for Hopper (sm_90a): the
// persistent CUDA-core designs of K8, K9 and K10, bound from Python through
// ctypes (eigen_lstm_tpu_torch/ops/cuda_cell_tiled.py). No PyTorch headers.
// TF32 stays off for fp32 products, so fp32 keeps the CUDA cores. The
// kernels' other designs (the tensor-core persistent ones under bf16
// compute, the per-step ones) are in lstm_tiled.cu; the two sources build
// in parallel. Three C launchers, each one cooperative launch a window:
//
//   tiled_fwd_embed_f32_launch (K8) <- pallas_cell_tiled.py:
//       _fwd_tiled_embed_kernel (layer 0, :429): g = (W[ids_t] +
//       h_{t-1} @ U) + b
//   tiled_fwd_scan_f32_launch (K9)  <- _fwd_tiled_kernel (layers >= 1,
//       :52): g = xw_t + h_{t-1} @ U
//   tiled_bwd_f32_launch (K10)      <- _bwd_tiled_kernel (:106): dh_t =
//       dg_{t+1} @ U^T + dh_cot_t, the gate backward, dg_t fp32, dc0, and
//       dh0 = dg_0 @ U^T as the launch's last product
//
// ops/cuda_cell_tiled.py:tiled_fwd_f32_plan (K8, K9) and tiled_bwd_f32_plan
// (K10) choose them for B <= 128, N a multiple of 32 and a grid of N / 8
// blocks the card holds at once; elsewhere the per-step designs of
// lstm_tiled.cu run. The forward's epilogue and K10's gate backward are
// those of lstm_tiled.cu's per-step kernels (common.cuh: cell, gate_bwd,
// keep_bit), so every design computes one function.

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

// Opts `kernel` in to `smem` bytes of dynamic shared memory and checks that
// `grid` blocks of `threads` can be resident at once on the current card
// (a cooperative launch's grid barrier never opens otherwise): 0 or the
// error. The fp32 persistent designs' launchers share it.
inline int cooperative_fits(const void* kernel, int threads, size_t smem, int grid) {
  // per card, read once: cooperative launch support and the SMs
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop[dev]) return static_cast<int>(cudaErrorNotSupported);
  if (grid > sms[dev] * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
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

// ---------------------------------------------------------------------------
// K10 under fp32 compute: one persistent cooperative launch for the S
// reverse steps and dh0 on CUDA cores (tiled_bwd_f32_persist;
// ops/cuda_cell_tiled.py:tiled_bwd_f32_plan chooses it), K8's fp32 design
// turned around. What held the per-step design back at the flagship's fp32
// shapes (S = 256, B = 128, N = 1024): 256 launches, each block reading its
// 32 columns of U^T over all 4N rows and its batch rows of dg_{t+1} from L2
// every step, one shared load per FMA, and a fresh U^T copy (16.8 MB) a
// call: ~184 us a reverse step on an H100.
//
// What bounds a persistent reverse step is L2: dh_rec = dg_{t+1} @ U^T
// needs, for any unit, a whole row of dg_{t+1} (4N gate columns). The
// first form of this kernel let each of N / 8 blocks read all of dg_{t+1}
// each step (2 MB at B = 128, 256 MB over the grid): 18.1 ms a flagship
// window on an H100, ~3.6 TB/s from L2 (PERF.md). So the blocks work in
// pairs: the pair p (blocks 2p, 2p + 1) owns the 16 hidden units 16p..,
// and its block h takes the half h of the gate axis (columns 2N h ..
// 2N h + 2N - 1, gates i, o or f, u) for all 16 units, and the epilogue of
// the units 16p + 8h..: each block reads half of dg_{t+1} a step (128 MB
// over the grid), and the pair swaps its partial sums through dh0's buffer
// (each block writes the 8 units its partner owns; read through L2 only)
// across a grid barrier.
//
// A block holds U's 16 rows of its pair over its half of the gate axis in
// shared memory for the window ([k][unit], 128 KB at N = 1024), read in
// place: no U^T. Each step the rows of its half of dg_{t+1} (fp32, B x 2N)
// arrive through a cp.async.cg ring of kQKC-column slots, L2 only (other
// blocks wrote them before the grid barrier); a slot's 16-byte vector p of
// row r sits at p ^ (r mod 8), so a quarter warp's reads of eight rows meet
// eight bank groups. The product splits the half's k kQSplit = 8 ways: warp
// s takes the k (counted from the half's start) with (k mod 32) / 4 = s in
// every ring layout and at every batch, and its lane (uh, pq) = (lane / 16,
// lane % 16) a register tile of RR rows (pq + 16 i; RR = 1, 2, 4, 8 for
// B <= 16, 32, 64, 128) by the 8 units 8 uh..: each 4 values of k are RR
// 16-byte loads of dg and 8 of U for 32 RR FMAs, one shared cycle per FFMA
// cycle at RR = 8, as K8's 8 x 8 tiles. The splits' partial sums meet in
// the ring's memory and are added in split order, so a (b, j)'s sum, (its
// i, o half) + (its f, u half), does not depend on the batch. Thread (u, q)
// = (tid % 8, tid / 8) owns unit 16p + 8h + u of rows q + 32 i and runs the
// gate backward of tiled_bwd_step in its registers: the dropout's keep bit
// at the global index and __fmul_rn, dh_cot + dh_rec, c_{t-1} (c0 at
// t = 0), the fp32 dc carried there for the window; it writes dg_t once, in
// fp32, and loads step t - 1's g, c, c_{t-1} and dh_seq before the barrier.
// Two grid barriers a step (the partial sums swapped; dg_t complete); after
// step 0 one more product gives dh0 = dg_0 @ U^T. What bounds it then: the
// half of dg_{t+1} each block reads from L2 each step, beside the
// products' shared loads and the two barriers.
constexpr int kQUnits = 8;                        // units a block's epilogue owns
constexpr int kQPair = 2 * kQUnits;               // units of a pair's products
constexpr int kQThreads = 256;
constexpr int kQSplit = 8;                        // ways the product splits k: a warp each
constexpr int kQKC = 64;                          // gate columns of a ring slot
constexpr int kQRowGroups = 16;                   // product rows pq + 16 i
constexpr int kQEpiRows = kQThreads / kQUnits;    // epilogue rows q + 32 i

// Product rows of a thread at batch B: 1, 2, 4, 8 (B <= 16, 32, 64, 128).
inline int bwd_f32_rows_per_thread(int B) {
  return B <= 16 ? 1 : B <= 32 ? 2 : B <= 64 ? 4 : 8;
}

// Dynamic shared memory of a block at batch B and hidden N with a ring of
// `stages` slots (mirrored by ops/cuda_cell_tiled.py:bwd_f32_smem_bytes,
// which holds itself to tiled_bwd_f32_smem_bytes once a card): U's 16 rows
// over 2N columns, then the ring, each slot 16 RR rows of kQKC floats; the
// splits' partial sums (kQSplit x 16 RR rows x kQPair) reuse it.
inline size_t bwd_f32_smem_bytes(int B, int N, int stages) {
  const size_t rows = (size_t)kQRowGroups * bwd_f32_rows_per_thread(B);
  const size_t ring = stages * rows * kQKC, red = kQSplit * rows * kQPair;
  return sizeof(float) * ((size_t)2 * N * kQPair + (ring > red ? ring : red));
}

template <typename RT, int RR, int STAGES>
__global__ void __launch_bounds__(kQThreads, 1)
tiled_bwd_f32_persist(const float* __restrict__ U,       // (N, 4N)
                      const RT* __restrict__ g_seq,      // (S, B, 4N)
                      const RT* __restrict__ c_seq,      // (S, B, N)
                      const float* __restrict__ c0,      // (B, N)
                      const float* __restrict__ dh_seq,  // (S, B, N)
                      const float* __restrict__ dhT,     // (B, N)
                      float* __restrict__ dc,            // (B, N): dcT in, dc0 out
                      // (S, B, 4N) dg_seq and (B, N) dh0, the pairs'
                      // partial sums until the end: written and read
                      // within the launch, so neither const nor
                      // __restrict__ (no non-coherent loads)
                      float* dg, float* dh0,
                      Dropout drop, int S, int B, int N, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RE = RR > 1 ? RR / 2 : 1;       // epilogue rows of a thread
  constexpr int rows = kQRowGroups * RR;        // rows of a ring slot
  constexpr int slot = rows * kQKC;
  static_assert(kQKC == 2 * 4 * kQSplit && kQThreads == 32 * kQSplit,
                "a warp a split, two 16-byte vectors of a slot row each");
  const int K = 4 * N, KH = 2 * N;              // gate columns, a half's
  float* Us = reinterpret_cast<float*>(smem);   // [k][unit of the pair]
  float* ring = Us + (size_t)KH * kQPair;       // STAGES x [rows][kQKC]
  float* red = ring;                            // [split][rows][unit of the pair]
  const int tid = threadIdx.x;
  const int split = tid / 32, uh = tid % 32 / 16, pq = tid % 16;
  const int u = tid % kQUnits, q = tid / kQUnits;
  const int half = blockIdx.x % 2, p0 = (blockIdx.x / 2) * kQPair;
  const int j = p0 + half * kQUnits + u;                   // this thread's unit
  const int jx = p0 + (1 - half) * kQUnits + u;            // its partner's
  const size_t bn = (size_t)B * N, bk = (size_t)B * K;
  cg::grid_group grid = cg::this_grid();

  // U's rows of the pair over the block's half, once a window:
  // consecutive threads read consecutive gate columns of one row
  for (int e = tid; e < kQPair * KH; e += kQThreads) {
    const int uu = e / KH, k = e % KH;
    Us[(size_t)k * kQPair + uu] = U[(size_t)(p0 + uu) * K + (size_t)half * KH + k];
  }

  // this thread's (b, j): rows q + 32 i that lie in the batch
  float dcr[RE], gin[RE][4], cin[RE], cpin[RE], dhin[RE];
  const auto valid = [&](int i) { return q + kQEpiRows * i < B; };
  const auto row = [&](int i) { return (size_t)(q + kQEpiRows * i) * N; };
#pragma unroll
  for (int i = 0; i < RE; ++i) dcr[i] = valid(i) ? dc[row(i) + j] : 0.0f;
  const auto load_inputs = [&](int t) {
#pragma unroll
    for (int i = 0; i < RE; ++i) {
      if (!valid(i)) continue;
      const size_t idx = row(i) + j;
      const size_t gb = t * bk + (size_t)(q + kQEpiRows * i) * K + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) gin[i][g] = to_f32(g_seq[gb + (size_t)g * N]);
      cin[i] = to_f32(c_seq[t * bn + idx]);
      cpin[i] = t > 0 ? to_f32(c_seq[(t - 1) * bn + idx]) : c0[idx];
      dhin[i] = dh_seq[t * bn + idx];
    }
  };
  load_inputs(S - 1);
  __syncthreads();  // U's rows are in

  const int nchunks = KH / kQKC;
  for (int t = S - 1; t >= -1; --t) {
    // the block's half of dh_rec = dg_{t+1} @ U^T for the pair's 16 units:
    // its own 8 units' kept, its partner's swapped through dh0's buffer
    float mine[RE] = {};
    if (t < S - 1) {
      const float* dgn = dg + (size_t)(t + 1) * bk + (size_t)half * KH;
      // chunk ch: columns ch * kQKC.. of the half's rows, vector p of row r
      // at p ^ (r mod 8); rows past B zero-filled
      const auto load_chunk = [&](int ch) {
        float* st = ring + (size_t)(ch % STAGES) * slot;
        for (int e = tid; e < rows * (kQKC / 4); e += kQThreads) {
          const int r = e / (kQKC / 4), p = e % (kQKC / 4);
          const bool in = r < B;
          cp_async_16(st + r * kQKC + 4 * (p ^ (r % 8)),
                      in ? dgn + (size_t)r * K + ch * kQKC + 4 * p : dgn,
                      in ? 16 : 0);
        }
      };
      float acc[RR][kQUnits];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int y = 0; y < kQUnits; ++y) acc[i][y] = 0.0f;
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
        // split s's vectors s and s + 8 (k 4s.. and 32 + 4s.. of the
        // chunk) of rows pq + 16 i (whose row mod 8 is pq mod 8), and U's
        // units 8 uh.. at the same k
        const float* sl = ring + (size_t)(ch % STAGES) * slot + pq * kQKC;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int vec = split + kQSplit * w;
          const float* ds = sl + 4 * (vec ^ (pq % 8));
          const float* ub = Us + ((size_t)ch * kQKC + 4 * vec) * kQPair + kQUnits * uh;
          float4 dv[RR];
#pragma unroll
          for (int i = 0; i < RR; ++i)
            dv[i] = *reinterpret_cast<const float4*>(ds + i * kQRowGroups * kQKC);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 w0 = *reinterpret_cast<const float4*>(ub + v * kQPair);
            const float4 w1 = *reinterpret_cast<const float4*>(ub + v * kQPair + 4);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < RR; ++i) {
              const float x = v == 0 ? dv[i].x : v == 1 ? dv[i].y : v == 2 ? dv[i].z : dv[i].w;
#pragma unroll
              for (int y = 0; y < kQUnits; ++y) acc[i][y] = fmaf(x, wv[y], acc[i][y]);
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring: reuse it as red
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        float* dst = red + ((size_t)split * rows + pq + kQRowGroups * i) * kQPair + kQUnits * uh;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      __syncthreads();
      // the splits' partial sums, added in split order: the thread's own
      // unit kept, its partner's unit stored for the partner (L2 only)
#pragma unroll
      for (int i = 0; i < RE; ++i) {
        const int b = q + kQEpiRows * i;
        float v = 0.0f, x = 0.0f;
        if (valid(i)) {
          const float* rb = red + (size_t)b * kQPair;
          v = rb[half * kQUnits + u];
          x = rb[(1 - half) * kQUnits + u];
#pragma unroll
          for (int s = 1; s < kQSplit; ++s) {
            v += rb[(size_t)s * rows * kQPair + half * kQUnits + u];
            x += rb[(size_t)s * rows * kQPair + (1 - half) * kQUnits + u];
          }
          __stcg(dh0 + row(i) + jx, x);
        }
        mine[i] = v;
      }
    }
    // the pair's partial sums are swapped; every block reaches it every
    // step, the last one and t = S - 1's (nothing swapped) too
    grid.sync();
    float dh_rec[RE];
#pragma unroll
    for (int i = 0; i < RE; ++i) {
      if (!valid(i)) {
        dh_rec[i] = 0.0f;
      } else if (t == S - 1) {
        dh_rec[i] = dhT[row(i) + j];
      } else {
        // (the i, o half) + (the f, u half): fp32 adds commute, so each
        // block of the pair adds the same two sums to the same bits
        dh_rec[i] = mine[i] + __ldcg(dh0 + row(i) + j);
      }
    }
    if (t == -1) {
#pragma unroll
      for (int i = 0; i < RE; ++i)
        if (valid(i)) {
          dh0[row(i) + j] = dh_rec[i];
          dc[row(i) + j] = dcr[i];
        }
      break;
    }
#pragma unroll
    for (int i = 0; i < RE; ++i) {
      if (!valid(i)) continue;
      const size_t idx = row(i) + j;
      float dh_cot = dhin[i];
      // __fmul_rn: the product rounds before the add, as in the TPU kernel
      if (drop.on) dh_cot = keep_bit(drop, t, idx) ? __fmul_rn(dh_cot, drop.inv) : 0.0f;
      float d[4];
      gate_bwd(gin[i][0], gin[i][1], gin[i][2], gin[i][3], cin[i], cpin[i],
               dh_cot + dh_rec[i], dcr[i], standard, d, &dcr[i]);
      const size_t gb = t * bk + (size_t)(q + kQEpiRows * i) * K + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) dg[gb + (size_t)g * N] = d[g];
    }
    if (t > 0) load_inputs(t - 1);
    // dg_t is complete before any block reads it, the ring's partial sums
    // are read before the next chunks land, and the swapped sums are read
    // before the next are stored; every block reaches it every step
    grid.sync();
  }
}

// One cooperative launch of tiled_bwd_f32_persist<RT, RR, STAGES> on
// `stream`, RR the product rows a thread owns at B. Returns 0 and adds the
// launch to *launches, or the error.
template <typename RT, int RR, int STAGES>
int run_bwd_f32(const void* U, const void* g_seq, const void* c_seq,
                const float* c0, const void* dh_seq, const float* dhT,
                float* dc, void* dg, float* dh0, Dropout drop, int S, int B,
                int N, int standard, cudaStream_t stream, int* launches) {
  const auto kernel = tiled_bwd_f32_persist<RT, RR, STAGES>;
  const size_t smem = bwd_f32_smem_bytes(B, N, STAGES);
  const int grid = N / kQUnits;
  const int err = cooperative_fits(reinterpret_cast<const void*>(kernel),
                                   kQThreads, smem, grid);
  if (err != 0) return err;
  const float* u = static_cast<const float*>(U);
  const RT* gs = static_cast<const RT*>(g_seq);
  const RT* cs = static_cast<const RT*>(c_seq);
  const float* dh = static_cast<const float*>(dh_seq);
  float* d = static_cast<float*>(dg);
  void* args[] = {&u, &gs, &cs, &c0, &dh, &dhT, &dc, &d, &dh0, &drop, &S, &B,
                  &N, &standard};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kQThreads), args,
      smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launches;
  return 0;
}

// The ring layouts K10's fp32 design is built for: (product rows a thread,
// stages), as ops/cuda_cell_tiled.py:BWD_F32_RINGS lists them.
#define BWD_F32_LAYOUTS(X) X(1, 6) X(2, 6) X(4, 5) X(8, 3) X(8, 2)

template <typename RT>
int bwd_f32(const void* U, const void* g_seq, const void* c_seq, const float* c0,
            const void* dh_seq, const float* dhT, float* dc, void* dg, float* dh0,
            Dropout drop, int S, int B, int N, int standard, int stages,
            cudaStream_t stream, int* launches) {
  if (B < 1 || B > kQRowGroups * 8 || S < 1 || N % 32 != 0 || dh0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(U, g_seq, c_seq, c0, dh_seq, dhT, dc, dg, dh0, drop, S, B, N,
               standard, stream, launches);
  };
  const int RR = bwd_f32_rows_per_thread(B);
#define BWD_F32_CASE(r, st) \
  if (RR == r && stages == st) return f(run_bwd_f32<RT, r, st>);
  BWD_F32_LAYOUTS(BWD_F32_CASE)
#undef BWD_F32_CASE
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

// K10 under fp32 compute, the persistent CUDA-core design
// (ops/cuda_cell_tiled.py:tiled_bwd_f32_plan): U (N, 4N) fp32, read in place;
// the residual sequences in the residual type (rtype 0 fp32, 1 bf16); dh_seq
// (S, B, N), c0 and dhT fp32; dc holds dcT on entry and dc0 on return; dg
// receives the (S, B, 4N) fp32 dg sequence and dh0 (B, N), the block
// pairs' swap buffer during the launch, dg_0 @ U^T. N a multiple of 32,
// 1 <= B <= 128, `stages` ring slots. One cooperative launch, added to
// *launches.
extern "C" int tiled_bwd_f32_launch(
    int rtype, const void* U, const void* g_seq, const void* c_seq,
    const void* c0, const void* dh_seq, const void* dhT, void* dc, void* dg,
    void* dh0, int S, int B, int N, int standard, int stages, int drop_on,
    unsigned seed, unsigned keep, float inv, void* stream, int* launches) {
  const Dropout drop{drop_on, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, g_seq, c_seq, static_cast<const float*>(c0), dh_seq,
               static_cast<const float*>(dhT), static_cast<float*>(dc), dg,
               static_cast<float*>(dh0), drop, S, B, N, standard, stages,
               static_cast<cudaStream_t>(stream), launches);
  };
  if (rtype == 0) return f(bwd_f32<float>);
  if (rtype == 1) return f(bwd_f32<__nv_bfloat16>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a block of K10's fp32 persistent design
// takes at batch B and hidden N with `stages` ring slots.
extern "C" size_t tiled_bwd_f32_smem_bytes(int B, int N, int stages) {
  return bwd_f32_smem_bytes(B, N, stages);
}
