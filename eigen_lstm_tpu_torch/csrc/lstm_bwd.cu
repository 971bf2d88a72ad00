// LSTM backward for Hopper (sm_90a), bound from Python through ctypes
// (eigen_lstm_tpu_torch/ops/cuda_cell_bwd.py). No PyTorch headers. Three C
// launchers share one reverse-time step body (bwd_tile):
//   lstm_bwd_embed_launch (K3) <- pallas_cell.py:_bwd_embed_fused_kernel,
//       layer 0 with its weight gradients dW, dU, db;
//   lstm_bwd_embed_unroll2_launch (K12) <- pallas_cell.py:
//       _bwd_embed_unroll2_kernel, K3's function, two reverse steps a launch;
//   lstm_bwd_scan_launch (K6)  <- pallas_cell.py:_bwd_kernel with the dU
//       product of _bwd_core (:393-414), layers >= 1: dg_seq, dU, dh0, dc0.
//
// The reverse step (the gate backward _gate_bwd). For t = S-1 .. 0, with
// dh_{S-1} carried from dhT and dc from dcT:
//   dh_cot   = dh_seq[t], or with dropout where(keep(seed, t), dh_seq[t] *
//              inv, 0): the cotangent is the masked stream's, and the mask
//              is rebuilt from (seed, t) as the forward drew it
//              (pallas_cell.py:629-634; t is the timestep, not the
//              iteration)
//   dh_total = dh_cot + dh_rec,      dh_rec = round(dg_{t+1}) @ U^T (fp32)
//   dg_t     = gate backward of (g_t, c_t, c_{t-1}, dh_total, dc) in fp32
//   dc       = dc_raw * f
// then dh0 = round(dg_0) @ U^T, dc0 = dc, and
//   dU = sum_t round(h_{t-1})^T round(dg_t)    (h_{-1} = h0)
// K3 adds
//   dW[v] = sum_{(t,b): ids = v} round(dg_t[b])  (the one-hot product)
//   db = sum_{t,b} dg_t[b]
// where db sums the unrounded fp32 dg when the JAX package takes the fused
// VJP (pallas_cell.py:1031-1042, where fused_accum_ok holds) and dg rounded
// to the xw type when it takes the GEMM fall-back (:1044-1066, which sums
// the xw-type dg that _bwd_kernel emits): the launcher's round_db.
// and K6 hands dg_seq out in the xw type (bf16 under bf16 compute,
// pallas_cell.py:299, :365): dW, db and dx of layers >= 1 follow from it
// outside, in torch (x @ W stays a plain large product, as in XLA). K6's
// h_{-1} arrives rounded to the residual type, as _bwd_core rounds h0.
// round() is the compute type (bf16 or fp32); every sum is fp32.
//
// What bounds K6 on the H100: the flagship's training window (S = 256,
// B = 128, N = 1024) is 2*S*B*4N*N flops for dh_rec plus as many for dU
// (550 GFLOP) against ~1.2 GB that the function must move (the fp32 g, c
// and h residuals are 0.8 GB of it), so operations bound it, at 0.56 ms in
// bf16 and 8.2 ms in fp32 (k6_bound() in chip_smoke.py). It runs on CUDA
// cores like K3, one launch per reverse step, far above that.
//
// What bounds K3 on the H100: a window at the bench shapes (S = 100,
// B = 128, N = 512, M = 256) is 2*S*B*4N*N flops for dh_rec plus as many
// for dU (53.7 GFLOP; the one-hot product is a gather-add and counted as
// no flops), against ~190 MB the function must move (the fp32 g, c and h
// residuals are 157 MB of it, then the dh_seq cotangent, U and dWU). In
// bf16 the two bounds are close, 58 us for the bytes and 54 us for the
// operations at the tensor-core peak; in fp32 the operations bound, at
// ~800 us (bound() in chip_smoke.py). This first design runs on CUDA
// cores, in fp32 FMAs, far above both.
//
// Design. The TPU kernel keeps dWU (3 MB fp32) resident in VMEM and
// accumulates it step by step; a Hopper block has 227 KB, so the weight
// gradients move out of the recurrence instead:
//   * lstm_bwd_step, one launch per reverse timestep, mirrors the forward
//     kernel's ownership: a block owns 32 hidden units (one warp's lanes)
//     and 4 batch rows, its 8 warps split the 4N-long reduction of
//     dg_{t+1} @ U^T (read as U^T, (4N, N), so the lanes read coalesced),
//     and the gate backward of all four gate columns of its units runs in
//     registers. dg_t goes to an (S, B, 4N) fp32 scratch that the next
//     launch reads whole: nothing a block reads is written by its own
//     launch. dc is updated in place: each (b, j) belongs to one thread.
//   * after the loop, one more reduction launch gives dh0, then three
//     hand-written reductions over the S*B rows of the dg scratch:
//     atb_gemm for dU, embed_grad for dW (for each byte v, the rows whose
//     id is v, found by a ballot compaction, summed in row order: a
//     deterministic segmented sum, no atomics) and colsum for db.
//   * K6 is the same reverse loop (run_reverse) and the same atb_gemm for
//     dU; the TPU's _bwd_kernel already left dU to one product outside the
//     recurrence. Under bf16 compute one store_as launch writes dg_seq in
//     bf16: S + 1 step launches, one or two for dU, and that one.
//   * The dropout mask costs no bytes: each thread hashes its own (t, b, j)
//     in the step's epilogue, where it reads dh_seq[t].
//   * K12 computes K3's function through the same step body, so its dg, dc,
//     dh0 and weight gradients are K3's bit for bit. The TPU kernel unrolls
//     two reverse steps to overlap step tau1's weight-gradient products with
//     tau0's gate backward; here the weight gradients already sit outside
//     the recurrence, so what carries over is two steps a launch: a
//     cooperative launch of at most the resident blocks, each looping over
//     the (32-unit, 4-row) tiles, with a grid barrier between tau1 and tau0
//     (tau0's dh_rec reads the whole dg_{tau1}). That halves the step
//     launches (S / 2 + 1 against S + 1); its bound is K3's.
// Every sum has a fixed order, so the kernels are deterministic.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// One reverse timestep of one tile (32 hidden units, kBT batch rows: tile
// bx, by), or (dh_seq_t == null) the final dh0 reduction of the tile. The
// step body of both K3 (a block a tile, one launch a step) and K12 (two
// steps a cooperative launch, blocks looping over the tiles): the same
// arithmetic in the same order, so the two give the same bits. Every
// thread of the block calls it, with the same tile. dh_rec is common.cuh's
// rec_tile over the 4N-long gate axis, the gate backward its gate_bwd.
template <typename CT, typename RT>
__device__ __forceinline__ void
bwd_tile(const CT* __restrict__ UT,          // (4N, N) = U^T
         const float* __restrict__ dg_next,  // (B, 4N) dg_{t+1}, or null
         const float* __restrict__ dh_in,    // (B, N) dhT, when no dg_next
         const float* __restrict__ dh_seq_t, // (B, N), null: final mode
         const RT* __restrict__ g_t,         // (B, 4N) activated gates
         const RT* __restrict__ c_t,         // (B, N) carried cell
         const RT* __restrict__ c_prev_t,    // (B, N) c_{t-1}, null at t=0
         const float* __restrict__ c0,       // (B, N)
         float* __restrict__ dc,             // (B, N) in place
         float* __restrict__ dg_t,           // (B, 4N) out
         float* __restrict__ dh_out,         // (B, N) final mode out
         Dropout drop, int tau, int B, int N, int standard, int bx, int by) {
  float dh_rec;
  int b = by * kBT + threadIdx.y, j = bx * kLanes + threadIdx.x;
  if (dg_next != nullptr) {
    if (!rec_tile<CT>(UT, dg_next, B, N, 4 * N, bx, by, &dh_rec, &b, &j)) return;
  } else {
    if (threadIdx.y >= kBT || b >= B) return;
    dh_rec = dh_in[(size_t)b * N + j];
  }
  const size_t idx = (size_t)b * N + j;
  if (dh_seq_t == nullptr) {
    dh_out[idx] = dh_rec;
    return;
  }
  const size_t gb = (size_t)b * 4 * N + j;
  const float cp = c_prev_t != nullptr ? to_f32(c_prev_t[idx]) : c0[idx];
  float dh_cot = dh_seq_t[idx];
  // __fmul_rn: the product rounds before the add, as in the TPU kernel
  if (drop.on) dh_cot = keep_bit(drop, tau, idx) ? __fmul_rn(dh_cot, drop.inv) : 0.0f;
  float d[4];
  gate_bwd(to_f32(g_t[gb]), to_f32(g_t[gb + N]), to_f32(g_t[gb + 2 * (size_t)N]),
           to_f32(g_t[gb + 3 * (size_t)N]), to_f32(c_t[idx]), cp,
           dh_cot + dh_rec, dc[idx], standard, d, &dc[idx]);
#pragma unroll
  for (int q = 0; q < 4; ++q) dg_t[gb + (size_t)q * N] = d[q];
}

// K3's step: one reverse timestep, or the final dh0 reduction, a block a
// tile. grid = (N / 32, ceil(B / kBT)), block = (32, kKS).
template <typename CT, typename RT>
__global__ void __launch_bounds__(kLanes * kKS)
lstm_bwd_step(const CT* __restrict__ UT, const float* __restrict__ dg_next,
              const float* __restrict__ dh_in,
              const float* __restrict__ dh_seq_t, const RT* __restrict__ g_t,
              const RT* __restrict__ c_t, const RT* __restrict__ c_prev_t,
              const float* __restrict__ c0, float* __restrict__ dc,
              float* __restrict__ dg_t, float* __restrict__ dh_out,
              Dropout drop, int tau, int B, int N, int standard) {
  bwd_tile<CT, RT>(UT, dg_next, dh_in, dh_seq_t, g_t, c_t, c_prev_t, c0, dc,
                   dg_t, dh_out, drop, tau, B, N, standard, blockIdx.x,
                   blockIdx.y);
}

// K12's launch: the reverse steps tau1 and tau1 - 1, a grid barrier between
// them (tau1 - 1 reads the whole dg_{tau1}). A grid of at most what is
// resident at once (a barrier waits for every block), each block walking
// the (N / 32) x ceil(B / kBT) tiles from its index in steps of the grid.
// dg is the (S, B, 4N) dg sequence; dc holds the carried dc in place.
template <typename CT, typename RT>
__global__ void __launch_bounds__(kLanes * kKS)
lstm_bwd_pair(const CT* __restrict__ UT, const RT* __restrict__ g_seq,
              const RT* __restrict__ c_seq, const float* __restrict__ c0,
              const float* __restrict__ dh_seq, const float* __restrict__ dhT,
              float* __restrict__ dc, float* __restrict__ dg, Dropout drop,
              int tau1, int S, int B, int N, int standard) {
  const int tiles_x = N / kLanes;
  const int tiles = tiles_x * ((B + kBT - 1) / kBT);
  const size_t bn = (size_t)B * N, bn4 = 4 * bn;
  for (int q = 0; q < 2; ++q) {
    const int t = tau1 - q;
    if (q == 1) cg::this_grid().sync();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      bwd_tile<CT, RT>(UT, t < S - 1 ? dg + (t + 1) * bn4 : nullptr, dhT,
                       dh_seq + t * bn, g_seq + t * bn4, c_seq + t * bn,
                       t > 0 ? c_seq + (t - 1) * bn : nullptr, c0, dc,
                       dg + t * bn4, nullptr, drop, t, B, N, standard,
                       tile % tiles_x, tile / tiles_x);
  }
}

// dW[v, col] = sum over rows r (in order) with ids[r] == v of round(dg[r, col]).
// grid = (M, ceil(4N / 256)), block = 256: the block scans the ids in
// chunks of 256, compacts the matching rows (ballot, in row order) into
// shared memory, and each thread adds its column of those rows.
template <typename CT>
__global__ void __launch_bounds__(256)
embed_grad(const int* __restrict__ ids, const float* __restrict__ dg,
           float* __restrict__ dW, int R, int C) {
  __shared__ int rows[256];
  __shared__ int warp_count[8];
  const int v = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col = blockIdx.y * 256 + tid;
  float acc = 0.0f;
  for (int base = 0; base < R; base += 256) {
    const int r = base + tid;
    const bool hit = r < R && ids[r] == v;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, total = 0;
    for (int q = 0; q < 8; ++q) {
      offset += q < warp ? warp_count[q] : 0;
      total += warp_count[q];
    }
    if (hit) rows[offset + __popc(mask & ((1u << lane) - 1u))] = r;
    __syncthreads();
    if (col < C)
      for (int q = 0; q < total; ++q)
        acc += round_to<CT>(dg[(size_t)rows[q] * C + col]);
    __syncthreads();
  }
  if (col < C) dW[(size_t)v * C + col] = acc;
}

// out[e] = x[e] in the type XT.
template <typename XT>
__global__ void store_as(const float* __restrict__ x, XT* __restrict__ out,
                         size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = from_f32<XT>(x[e]);
}

// The S reverse steps and the final dh0 reduction: S + 1 launches. dg is
// the (S, B, 4N) fp32 dg sequence, dc holds dcT on entry and dc0 after.
template <typename CT, typename RT>
int run_reverse(const void* UT, const void* g_seq, const void* c_seq,
                const float* c0, const float* dh_seq, const float* dhT,
                float* dc, float* dg, float* dh0, int S, int B, int N,
                int standard, Dropout drop, cudaStream_t stream,
                int* launches) {
  const dim3 grid(N / kLanes, (B + kBT - 1) / kBT);
  const dim3 block(kLanes, kKS);
  const size_t bn = (size_t)B * N, bn4 = 4 * bn;
  const CT* ut = static_cast<const CT*>(UT);
  const RT* gs = static_cast<const RT*>(g_seq);
  const RT* cs = static_cast<const RT*>(c_seq);
  for (int t = S - 1; t >= -1; --t) {
    // t = -1: the final reduction, dh0 = round(dg_0) @ U^T
    const bool last = t == -1;
    lstm_bwd_step<CT, RT><<<grid, block, 0, stream>>>(
        ut, t < S - 1 ? dg + (t + 1) * bn4 : nullptr, dhT,
        last ? nullptr : dh_seq + t * bn, last ? nullptr : gs + t * bn4,
        last ? nullptr : cs + t * bn, t > 0 ? cs + (t - 1) * bn : nullptr, c0,
        dc, last ? nullptr : dg + t * bn4, dh0, drop, t, B, N, standard);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

// K12's reverse loop: S / 2 cooperative launches of two steps each (S
// even), then K3's final dh0 reduction: S / 2 + 1 launches, with run_reverse's
// arguments and results.
template <typename CT, typename RT>
int run_reverse2(const void* UT, const void* g_seq, const void* c_seq,
                 const float* c0, const float* dh_seq, const float* dhT,
                 float* dc, float* dg, float* dh0, int S, int B, int N,
                 int standard, Dropout drop, cudaStream_t stream,
                 int* launches) {
  if (S < 2 || S % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = lstm_bwd_pair<CT, RT>;
  const dim3 block(kLanes, kKS);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kLanes * kKS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  // every block must be resident at once, or the grid barrier never opens
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = (N / kLanes) * ((B + kBT - 1) / kBT);
  const dim3 grid(tiles < sms * per_sm ? tiles : sms * per_sm);
  const CT* ut = static_cast<const CT*>(UT);
  const RT* gs = static_cast<const RT*>(g_seq);
  const RT* cs = static_cast<const RT*>(c_seq);
  for (int tau1 = S - 1; tau1 >= 1; tau1 -= 2) {
    void* args[] = {&ut, &gs, &cs, &c0, &dh_seq, &dhT, &dc, &dg, &drop,
                    &tau1, &S, &B, &N, &standard};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      grid, block, args, 0, stream);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  // dh0 = round(dg_0) @ U^T, as run_reverse's last launch
  lstm_bwd_step<CT, RT><<<dim3(N / kLanes, (B + kBT - 1) / kBT), block, 0,
                          stream>>>(ut, dg, dhT, nullptr, nullptr, nullptr,
                                    nullptr, c0, dc, nullptr, dh0, drop, -1, B,
                                    N, standard);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

template <typename CT, typename RT>
int run_bwd(const void* UT, const void* g_seq, const void* c_seq,
            const void* h_seq, const int* ids, const float* h0,
            const float* c0, const float* dh_seq, const float* dhT, float* dc,
            float* dg, float* dWU, float* db, float* dh0, float* work, int S,
            int B, int N, int M, int standard, int round_db, int unroll2,
            Dropout drop, cudaStream_t stream, int* launches) {
  const auto reverse = unroll2 ? run_reverse2<CT, RT> : run_reverse<CT, RT>;
  int e = reverse(UT, g_seq, c_seq, c0, dh_seq, dhT, dc, dg, dh0, S, B, N,
                  standard, drop, stream, launches);
  if (e != 0) return e;
  const int R = S * B, C = 4 * N;
  // dU = h_prev^T dg: rows r < B of h_prev are h0, then h_seq[r - B]
  e = run_atb<CT, RT>(h0, static_cast<const RT*>(h_seq), B, dg,
                      dWU + (size_t)M * C, work, R, N, C, stream, launches);
  if (e != 0) return e;
  embed_grad<CT><<<dim3(M, (C + 255) / 256), 256, 0, stream>>>(ids, dg, dWU, R, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  // the xw type is the compute type on the card (bf16 or fp32)
  return round_db ? run_colsum<CT>(dg, db, work, R, C, stream, launches)
                  : run_colsum(dg, db, work, R, C, stream, launches);
}

// K6: the reverse steps, dU over the fp32 dg (round_c(dg) is the xw-type
// dg's own rounding: the xw type is the compute type), then dg_seq in the
// xw type CT, unless dgx is dg itself (fp32).
template <typename CT, typename RT>
int run_bwd_scan(const void* UT, const void* g_seq, const void* c_seq,
                 const void* h_seq, const float* h0, const float* c0,
                 const float* dh_seq, const float* dhT, float* dc, float* dg,
                 void* dgx, float* dU, float* dh0, float* work, int S, int B,
                 int N, int standard, Dropout drop, cudaStream_t stream,
                 int* launches) {
  int e = run_reverse<CT, RT>(UT, g_seq, c_seq, c0, dh_seq, dhT, dc, dg, dh0,
                              S, B, N, standard, drop, stream, launches);
  if (e != 0) return e;
  const int R = S * B;
  e = run_atb<CT, RT>(h0, static_cast<const RT*>(h_seq), B, dg, dU, work, R,
                      N, 4 * N, stream, launches);
  if (e != 0 || dgx == static_cast<void*>(dg)) return e;
  const size_t n = (size_t)R * 4 * N;
  store_as<CT><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dg, static_cast<CT*>(dgx), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

}  // namespace

// Scratch floats lstm_bwd_embed_launch needs in `work`.
extern "C" size_t lstm_bwd_embed_work_floats(int S, int B, int N) {
  const size_t gemm = atb_work_floats(S * B, N, 4 * N);
  const size_t col = (size_t)colsum_chunks_of(S * B) * 4 * N;
  return gemm > col ? gemm : col;
}

namespace {

int bwd_embed(int unroll2, int ctype, int rtype, const void* UT,
              const void* g_seq, const void* c_seq, const void* h_seq,
              const void* ids, const void* h0, const void* c0,
              const void* dh_seq, const void* dhT, void* dc, void* dg,
              void* dWU, void* db, void* dh0, void* work, int S, int B, int N,
              int M, int standard, int round_db, int drop_on, unsigned seed,
              unsigned keep, float inv, void* stream, int* launches) {
  const Dropout drop{drop_on, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(UT, g_seq, c_seq, h_seq, static_cast<const int*>(ids),
               static_cast<const float*>(h0), static_cast<const float*>(c0),
               static_cast<const float*>(dh_seq),
               static_cast<const float*>(dhT), static_cast<float*>(dc),
               static_cast<float*>(dg), static_cast<float*>(dWU),
               static_cast<float*>(db), static_cast<float*>(dh0),
               static_cast<float*>(work), S, B, N, M, standard, round_db,
               unroll2, drop, static_cast<cudaStream_t>(stream), launches);
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_bwd<float, float>);
  if (ctype == 0 && rtype == 1) return f(run_bwd<float, bf>);
  if (ctype == 1 && rtype == 0) return f(run_bwd<bf, float>);
  if (ctype == 1 && rtype == 1) return f(run_bwd<bf, bf>);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Type codes: 0 = fp32, 1 = bf16. UT is U^T (4N, N) in the compute type;
// the residual sequences have the residual type; h0, c0, dh_seq, dhT and the
// outputs are fp32. dc holds dcT on entry and dc0 on return. dg is an
// (S, B, 4N) fp32 scratch. round_db: db sums dg rounded to the compute
// type (the GEMM fall-back VJP) instead of the fp32 dg (the fused VJP).
// drop_on, seed, keep, inv: the dropout of the forward's masked stream
// (pallas_cell.py:_keep_mask). Adds its kernel launches to *launches.
extern "C" int lstm_bwd_embed_launch(
    int ctype, int rtype, const void* UT, const void* g_seq,
    const void* c_seq, const void* h_seq, const void* ids, const void* h0,
    const void* c0, const void* dh_seq, const void* dhT, void* dc, void* dg,
    void* dWU, void* db, void* dh0, void* work, int S, int B, int N, int M,
    int standard, int round_db, int drop_on, unsigned seed, unsigned keep,
    float inv, void* stream, int* launches) {
  return bwd_embed(0, ctype, rtype, UT, g_seq, c_seq, h_seq, ids, h0, c0,
                   dh_seq, dhT, dc, dg, dWU, db, dh0, work, S, B, N, M,
                   standard, round_db, drop_on, seed, keep, inv, stream,
                   launches);
}

// K12 <- pallas_cell.py:_bwd_embed_unroll2_kernel: K3's function, bit for
// bit, two reverse steps a cooperative launch (S even): S / 2 + 1 step
// launches against K3's S + 1. Arguments as lstm_bwd_embed_launch's.
extern "C" int lstm_bwd_embed_unroll2_launch(
    int ctype, int rtype, const void* UT, const void* g_seq,
    const void* c_seq, const void* h_seq, const void* ids, const void* h0,
    const void* c0, const void* dh_seq, const void* dhT, void* dc, void* dg,
    void* dWU, void* db, void* dh0, void* work, int S, int B, int N, int M,
    int standard, int round_db, int drop_on, unsigned seed, unsigned keep,
    float inv, void* stream, int* launches) {
  return bwd_embed(1, ctype, rtype, UT, g_seq, c_seq, h_seq, ids, h0, c0,
                   dh_seq, dhT, dc, dg, dWU, db, dh0, work, S, B, N, M,
                   standard, round_db, drop_on, seed, keep, inv, stream,
                   launches);
}

// Scratch floats lstm_bwd_scan_launch needs in `work`.
extern "C" size_t lstm_bwd_scan_work_floats(int S, int B, int N) {
  return atb_work_floats(S * B, N, 4 * N);
}

// K6. As lstm_bwd_embed_launch, without ids, dW and db; h0 is h_{-1}
// rounded to the residual type; dg is the (S, B, 4N) fp32 scratch and dgx
// receives dg_seq in the compute type (dgx == dg under fp32 compute); dU
// (N, 4N) fp32.
extern "C" int lstm_bwd_scan_launch(
    int ctype, int rtype, const void* UT, const void* g_seq,
    const void* c_seq, const void* h_seq, const void* h0, const void* c0,
    const void* dh_seq, const void* dhT, void* dc, void* dg, void* dgx,
    void* dU, void* dh0, void* work, int S, int B, int N, int standard,
    int drop_on, unsigned seed, unsigned keep, float inv, void* stream,
    int* launches) {
  const Dropout drop{drop_on, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(UT, g_seq, c_seq, h_seq, static_cast<const float*>(h0),
               static_cast<const float*>(c0),
               static_cast<const float*>(dh_seq),
               static_cast<const float*>(dhT), static_cast<float*>(dc),
               static_cast<float*>(dg), dgx, static_cast<float*>(dU),
               static_cast<float*>(dh0), static_cast<float*>(work), S, B, N,
               standard, drop, static_cast<cudaStream_t>(stream), launches);
  };
  using bf = __nv_bfloat16;
  if (ctype == 0 && rtype == 0) return f(run_bwd_scan<float, float>);
  if (ctype == 0 && rtype == 1) return f(run_bwd_scan<float, bf>);
  if (ctype == 1 && rtype == 0) return f(run_bwd_scan<bf, float>);
  if (ctype == 1 && rtype == 1) return f(run_bwd_scan<bf, bf>);
  return static_cast<int>(cudaErrorInvalidValue);
}
