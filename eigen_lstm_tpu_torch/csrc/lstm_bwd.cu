// LSTM backward for Hopper (sm_90a), bound from Python through ctypes
// (eigen_lstm_tpu_torch/ops/cuda_cell_bwd.py). No PyTorch headers. Three
// kernels of the JAX package, each with three designs of one function:
//   K3  <- pallas_cell.py:_bwd_embed_fused_kernel, layer 0 with its weight
//          gradients dW, dU, db;
//   K12 <- pallas_cell.py:_bwd_embed_unroll2_kernel, K3's function bit for
//          bit, two reverse steps at a time;
//   K6  <- pallas_cell.py:_bwd_kernel with the dU product of _bwd_core
//          (:393-414), layers >= 1: dg_seq, dU, dh0, dc0.
// Under bf16 compute, where a resident grid can hold U's rows in shared
// memory (ops/cuda_cell_bwd.py:k6_plan chooses), all three take the
// persistent design: one cooperative launch a window, lstm_bwd_persist
// through lstm_bwd_persist_launch (K12 with its steps in pairs, K3 and K12
// with db), then their weight gradients on tensor cores through
// lstm_bwd_dWU_launch (K6 dU; K3 and K12 dW and dU in one product). Under
// fp32 compute, where a resident grid can hold U's rows in shared memory
// (B <= 128, N a multiple of 32, N / 16 groups of 2 or 4 blocks the card
// holds at once: ops/cuda_cell_bwd.py:k6_f32_plan), all three take
// lstm_bwd_f32.cu's persistent CUDA-core reverse launch, then this file's
// CUDA-core reductions through lstm_bwd_tail_launch. The shapes neither
// persistent design takes (N = 2048, B > 128) keep the per-step design:
// one launch a reverse step (lstm_bwd_embed_launch,
// lstm_bwd_embed_unroll2_launch with two steps a cooperative launch,
// lstm_bwd_scan_launch), then the same CUDA-core reductions (run_tail).
// The persistent reverse launch also serves K16, the tensor-parallel
// window's backward at D = 1 (ops/cuda_tp_seq.py), which is K6's reverse
// recurrence with its dg kept in fp32 and its dU taken outside.
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
// K3 and K12 add
//   dW[v] = sum_{(t,b): ids = v} round(dg_t[b])  (the one-hot product)
//   db = sum_{t,b} dg_t[b]
// where db sums the unrounded fp32 dg when the JAX package takes the fused
// VJP (pallas_cell.py:1031-1042, where fused_accum_ok holds) and dg rounded
// to the xw type when it takes the GEMM fall-back (:1044-1066, which sums
// the xw-type dg that _bwd_kernel emits): the launchers' round_db. There
// h_{-1} is h0 rounded to the residual type, as _bwd_core concatenates it
// (the wrapper rounds it), and so is K6's. K6 hands dg_seq out in the xw
// type (bf16 under bf16 compute, pallas_cell.py:299, :365): dW, db and dx of
// layers >= 1 follow from it outside, in torch (x @ W stays a plain large
// product, as in XLA). round() is the compute type (bf16 or fp32); every
// sum is fp32.
//
// What bounds them on the H100. K6 at the flagship's training window
// (S = 256, B = 128, N = 1024) is 2*S*B*4N*N flops for dh_rec plus as many
// for dU (550 GFLOP) against ~1.2 GB that the function must move (the fp32
// g, c and h residuals are 0.8 GB of it): operations bound it, at 0.56 ms in
// bf16 and 8.2 ms in fp32 (k6_bound() in chip_smoke.py). K3 at the bench
// shapes (S = 100, B = 128, N = 512, M = 256) is 53.7 GFLOP (the one-hot
// product counted as no flops) against ~190 MB (the fp32 residuals are 157
// MB of it): in bf16 the two bounds are close, 58 us for the bytes and 54 us
// for the operations; in fp32 the operations bound, at ~800 us (k3_bound()).
//
// The per-step design: lstm_bwd_step, one launch a reverse timestep, a
// block a tile of 32 hidden units (one warp's lanes) and kBT = 4 batch rows,
// its 8 warps splitting the 4N-long reduction of dg_{t+1} @ U^T (read as
// U^T, (4N, N), so the lanes read coalesced) on CUDA cores in fp32 FMAs, the
// gate backward of the four gate columns of its units in registers. dg_t
// goes to an (S, B, 4N) fp32 scratch that the next launch reads whole; dc
// is updated in place (each (b, j) belongs to one thread). After the loop
// one more launch gives dh0, then hand-written reductions over the S*B rows
// of the scratch: atb_gemm for dU, embed_grad for dW (for each byte v, the
// rows whose id is v, found by a ballot compaction, summed in row order)
// and colsum for db (K3, K12); K6 writes dg_seq in bf16 with store_as under
// bf16 compute. K12's per-step design takes two reverse steps a cooperative
// launch of at most the resident blocks, each looping over the tiles, with
// a grid barrier between tau1 and tau0 (tau0's dh_rec reads the whole
// dg_{tau1}). At the flagship's window the per-step K6 ran 42.55 ms in bf16
// (PERF.md): 257 launches of 1024 blocks, each block re-reading its 256 KB
// slab of U^T from L2 for 4 batch rows, fp32 FMAs, dg written in fp32.
//
// The persistent design answers each of those: one cooperative launch a
// window with a grid barrier between steps; a block's U rows (16 units x 4N,
// 128 KB at N = 1024) held in shared memory for the whole window; dh_rec on
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums; csrc/mma.cuh); dg
// stored once, in bf16, which the next step's product and the weight
// gradients read; db summed in registers from the fp32 dg as the steps go,
// so no fp32 dg stream (it is written only when a check asks for it); dW and
// dU one tensor-core product over [one-hot(ids) | round(h_{t-1})] (mma.cuh's
// atb_mma),
// no per-byte scan. What bounds it then is the recurrence's dependence:
// every step each of the N / 16 unit groups reads the whole dg_{t+1} of its
// batch rows from L2 (64 MB a step at the flagship, 1 MB per group) and
// waits at the grid barrier, while its products take a few microseconds.
// Wider groups would read less but their U rows would not fit: 16 units x 4N
// bf16 plus the dg ring fills 179 KB of the 227 KB; so the flagship's grid is
// 64 groups x 2 batch halves = 128 blocks, one an SM. On the H100 a step then
// takes ~23 us: ~5 us for the grid barrier and the epilogue, the rest the
// product, whose 64 MB of dg reads run at ~4 TB/s across the SMs (PERF.md).
// K12 takes the same steps with the same arithmetic, only each pair's
// recurrence-free loads issued together (the TPU kernel pairs steps to
// overlap off-path work with the serial chain; here the weight gradients
// already sit outside the recurrence), so its outputs are K3's bit for bit.
// Left for later: wgmma in place of mma.sync, and TMA multicast of dg_{t+1}
// over a cluster of blocks that share batch rows (cutting the L2 reads by
// the cluster size). fp32 compute cannot use this kernel (TF32 is off for
// fp32 products, so the tensor cores cannot serve it): lstm_bwd_f32.cu
// holds its CUDA-core counterpart.
//
// The dropout mask costs no bytes: each thread hashes its own (t, b, j) in
// the step's epilogue, where it reads dh_seq[t]. Every sum has a fixed
// order, so the kernels are deterministic.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

// One reverse timestep of one tile (32 hidden units, kBT batch rows: tile
// bx, by), or (dh_seq_t == null) the final dh0 reduction of the tile: the
// per-step design's step body, of K3 and K6 (a block a tile, one launch a
// step) and K12 (two steps a cooperative launch, blocks looping over the
// tiles): the same arithmetic in the same order, so K3 and K12 give the
// same bits. Every thread of the block calls it, with the same tile.
// dh_rec is common.cuh's
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

// The per-step design's step: one reverse timestep, or the final dh0 reduction, a block a
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

// K12's per-step design: the reverse steps tau1 and tau1 - 1, a grid barrier between
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

// The weight gradients from the (S, B, 4N) fp32 dg sequence: dU =
// h_prev^T dg into out + M * 4N (rows r < B of h_prev are h0, then
// h_seq[r - B]); with ids (K3, K12; M > 0) also dW, the one-hot product,
// into out and db, the column sums (of dg rounded to CT with round_db). The
// per-step design's tail, and the fp32 persistent design's
// (lstm_bwd_f32.cu) through lstm_bwd_tail_launch.
template <typename CT, typename RT>
int run_tail(const void* h_seq, const int* ids, const float* h0,
             const float* dg, float* out, float* db, float* work, int S,
             int B, int N, int M, int round_db, cudaStream_t stream,
             int* launches) {
  const int R = S * B, C = 4 * N;
  int e = run_atb<CT, RT>(h0, static_cast<const RT*>(h_seq), B, dg,
                          out + (size_t)M * C, work, R, N, C, stream, launches);
  if (e != 0 || ids == nullptr) return e;
  embed_grad<CT><<<dim3(M, (C + 255) / 256), 256, 0, stream>>>(ids, dg, out, R, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  // the xw type is the compute type on the card (bf16 or fp32)
  return round_db ? run_colsum<CT>(dg, db, work, R, C, stream, launches)
                  : run_colsum(dg, db, work, R, C, stream, launches);
}

// K3 and K12 in the per-step design: the reverse steps, then dU, dW and db.
template <typename CT, typename RT>
int run_bwd(const void* UT, const void* g_seq, const void* c_seq,
            const void* h_seq, const int* ids, const float* h0,
            const float* c0, const float* dh_seq, const float* dhT, float* dc,
            float* dg, float* dWU, float* db, float* dh0, float* work, int S,
            int B, int N, int M, int standard, int round_db, int unroll2,
            Dropout drop, cudaStream_t stream, int* launches) {
  const auto reverse = unroll2 ? run_reverse2<CT, RT> : run_reverse<CT, RT>;
  const int e = reverse(UT, g_seq, c_seq, c0, dh_seq, dhT, dc, dg, dh0, S, B,
                        N, standard, drop, stream, launches);
  if (e != 0) return e;
  return run_tail<CT, RT>(h_seq, ids, h0, dg, dWU, db, work, S, B, N, M,
                          round_db, stream, launches);
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
  e = run_tail<CT, RT>(h_seq, nullptr, h0, dg, dU, nullptr, work, S, B, N, 0,
                       0, stream, launches);
  if (e != 0 || dgx == static_cast<void*>(dg)) return e;
  const size_t n = (size_t)S * B * 4 * N;
  store_as<CT><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dg, static_cast<CT*>(dgx), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

// ---------------------------------------------------------------------------
// The persistent reverse launch under bf16 compute, shared by K6, K3 and K12:
// the S reverse steps and dh0 in one cooperative launch, U in shared memory,
// dh_rec on tensor cores. K3 and K12 add db (kDb); K12 takes the steps in
// pairs (kSteps = 2). All three run the same step arithmetic.
//
// A block owns kUnits = 8 * NT hidden units j0..j0+kUnits-1 (the rows of U
// whose products give their dh_rec; the gate backward then writes their
// four gate columns j + qN) and `rows` batch rows b0.. (a part of the
// batch), so the grid is (N / kUnits) * ceil(B / rows) blocks, at most what
// is resident. Its U rows (kUnits x 4N bf16) are loaded into shared memory
// once. Each step, the block's 8 warps split the 4N-long gate axis: dg_{t+1}
// (its rows, bf16) streams through a ring of kPStages chunks of kPKC gate
// columns by cp.async (L2 only: other blocks wrote it before the barrier),
// and in each chunk warp w takes the 16 columns 16w.. as one k step of
// mma.sync m16n8k16 for every (16-row, 8-unit) tile; the 8 partial sums of
// each (b, j) meet in shared memory and are added in warp order. The owner
// thread of (b, j) then runs the gate backward in registers, with dc carried
// in its registers across the window, and writes dg_t once in bf16 (and in
// fp32 into dg32 when asked for). A grid barrier closes each step. The
// steps' g, c, c_{t-1} and dh_seq[t] do not depend on the recurrence: each
// thread loads its own for the next kSteps steps before the barrier that
// precedes them (K12: both steps of a pair at once, the loads the TPU
// kernel's unrolling overlaps with the serial chain).
//
// db (kDb): each thread sums its elements' dg over the steps (the fp32 dg,
// or with round_db the bf16 one), the block adds its threads' sums in
// thread order into one row of db_part per part of the batch, and after a
// last grid barrier the blocks of part 0 add the parts in order. Every sum
// has a fixed order, so K12 gives K3's bits.
constexpr int kPThreads = 256;  // 8 warps
constexpr int kPWarps = kPThreads / 32;
constexpr int kPRows = 64;      // batch rows of a block at most: 4 m tiles
constexpr int kPKC = 16 * kPWarps;  // gate columns of a staged chunk
constexpr int kPStages = 3;
// bf16 of padding per shared row: rows of an odd number of 16-byte units,
// so the eight row addresses of an ldmatrix fall in distinct banks
constexpr int kPPad = 8;
constexpr int kPRingPitch = kPKC + kPPad;
constexpr int kMaxDevices = 64;

// Dynamic shared memory of the persistent launch (mirrored by
// ops/cuda_cell_bwd.py:persist_smem_bytes, which holds itself to
// lstm_bwd_persist_smem_bytes once a card): the group's U rows, then the
// ring of dg chunks, whose space the cross-warp sums and db's reuse.
inline size_t persist_smem_bytes(int N, int units) {
  return 2 * ((size_t)units * (4 * N + kPPad) +
              (size_t)kPStages * kPRows * kPRingPitch);
}

template <typename RT, int NT, int kSteps, bool kDb>
__global__ void __launch_bounds__(kPThreads, 1)
lstm_bwd_persist(const __nv_bfloat16* __restrict__ U,  // (N, 4N)
                 const RT* __restrict__ g_seq,         // (S, B, 4N)
                 const RT* __restrict__ c_seq,         // (S, B, N)
                 const float* __restrict__ c0,
                 // (B, N) c_{S-1} in fp32, read in place of c_seq[S-1], or
                 // null (K16: c_seq then stops at S-2)
                 const float* __restrict__ c_last,
                 const float* __restrict__ dh_seq,
                 const float* __restrict__ dhT,
                 float* __restrict__ dc,  // (B, N): dcT in, dc0 out
                 // (S, B, 4N) dg_seq: written and read within the launch,
                 // so neither const nor __restrict__ (no non-coherent loads)
                 __nv_bfloat16* dgx,
                 float* __restrict__ dg32,  // (S, B, 4N) fp32 dg, or null
                 float* __restrict__ dh0,
                 float* __restrict__ db,  // (4N,), kDb
                 float* db_part,          // (parts, 4N) scratch, kDb; as dgx
                 Dropout drop, int S, int B, int N, int rows, int standard,
                 int round_db) {
  constexpr int kUnits = 8 * NT;
  constexpr int kElems = kPRows * kUnits / kPThreads;  // (b, j) a thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * N;
  const int upitch = K + kPPad;
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = Us + (size_t)kUnits * upitch;
  float* red = reinterpret_cast<float*>(ring);  // [kPWarps][kPRows][kUnits]

  const int groups = N / kUnits;
  const int part = blockIdx.x / groups;
  const int j0 = (blockIdx.x % groups) * kUnits;
  const int b0 = part * rows;
  const int nrows = min(rows, B - b0);
  const int mtiles = (nrows + 15) / 16;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const size_t bn = (size_t)B * N, bk = (size_t)B * K;
  cg::grid_group grid = cg::this_grid();

  // U's rows j0.. into shared memory, once
  for (int p = tid; p < kUnits * (K / 8); p += kPThreads) {
    const int u = p / (K / 8), k = (p % (K / 8)) * 8;
    cp_async_16(Us + (size_t)u * upitch + k, U + (size_t)(j0 + u) * K + k, 16);
  }
  cp_async_commit();

  // this thread's (b, j): element e = tid + kPThreads * i of the block's
  // kPRows x kUnits, row-major; valid when its row lies in the block's part
  int eb[kElems], ej[kElems];
  bool ev[kElems];
  float dcr[kElems];
  // the recurrence-free inputs of the next kSteps steps, slot p for step t - p
  float gin[kSteps][kElems][4], cin[kSteps][kElems], cpin[kSteps][kElems],
      dhin[kSteps][kElems];
  float dbs[kDb ? kElems : 1][4];  // this thread's db sums
#pragma unroll
  for (int i = 0; i < kElems; ++i) {
    const int e = tid + kPThreads * i;
    eb[i] = b0 + e / kUnits;
    ej[i] = j0 + e % kUnits;
    ev[i] = e / kUnits < nrows;
    dcr[i] = ev[i] ? dc[(size_t)eb[i] * N + ej[i]] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < (kDb ? kElems : 1); ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) dbs[i][x] = 0.0f;
  const auto load_inputs = [&](int p, int t) {
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      if (!ev[i]) continue;
      const size_t idx = (size_t)eb[i] * N + ej[i];
      const size_t gb = t * bk + (size_t)eb[i] * K + ej[i];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) gin[p][i][qq] = to_f32(g_seq[gb + (size_t)qq * N]);
      // with c_last, no load touches c_seq[S-1] (cpin reads t - 1 < S - 1)
      cin[p][i] = t == S - 1 && c_last != nullptr ? c_last[idx]
                                                  : to_f32(c_seq[t * bn + idx]);
      cpin[p][i] = t > 0 ? to_f32(c_seq[(t - 1) * bn + idx]) : c0[idx];
      dhin[p][i] = dh_seq[t * bn + idx];
    }
  };

  // dh_rec = round(dg_next) @ U^T over the block's rows and units
  const int nchunks = K / kPKC;
  const auto rec = [&](const __nv_bfloat16* dgn, float (&dh_rec)[kElems]) {
    const auto load_chunk = [&](int c) {
      __nv_bfloat16* slot = ring + (size_t)(c % kPStages) * kPRows * kPRingPitch;
      for (int p = tid; p < mtiles * 16 * (kPKC / 8); p += kPThreads) {
        const int r = p / (kPKC / 8), k = (p % (kPKC / 8)) * 8;
        const bool in = r < nrows;
        cp_async_16(slot + r * kPRingPitch + k,
                    in ? dgn + (size_t)(b0 + r) * K + c * kPKC + k : dgn,
                    in ? 16 : 0);
      }
    };
    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mt][nt][x] = 0.0f;
#pragma unroll
    for (int c = 0; c < kPStages - 1; ++c) {
      if (c < nchunks) load_chunk(c);
      cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<kPStages - 2>();
      __syncthreads();  // chunk c is in, and chunk c - 1's slot is free
      if (c + kPStages - 1 < nchunks) load_chunk(c + kPStages - 1);
      cp_async_commit();
      const __nv_bfloat16* slot = ring + (size_t)(c % kPStages) * kPRows * kPRingPitch;
      const int kk = warp * 16;
      unsigned bq[4];
      const __nv_bfloat16* urow =
          Us + (size_t)(lane % 8 + 8 * (lane / 16)) * upitch + c * kPKC + kk +
          8 * ((lane / 8) % 2);
      if (NT == 2)
        ldmatrix_x4(bq, urow);
      else
        ldmatrix_x2(bq, urow);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mtiles) break;
        unsigned a[4];
        ldmatrix_x4(a, slot + (mt * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * kPRingPitch +
                           kk + 8 * (lane / 16));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a, bq + 2 * nt);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: reuse it as red
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mtiles) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = red + ((size_t)warp * kPRows + mt * 16 + g + 8 * h) * kUnits +
                       nt * 8 + 2 * q;
          dst[0] = acc[mt][nt][2 * h];
          dst[1] = acc[mt][nt][2 * h + 1];
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      const int e = tid + kPThreads * i;
      float v = 0.0f;
      if (ev[i])
#pragma unroll
        for (int w = 0; w < kPWarps; ++w) v += red[(size_t)w * kPRows * kUnits + e];
      dh_rec[i] = v;
    }
  };

  // the gate backward of step t from the inputs in slot p
  const auto gate_step = [&](int p, int t, const float (&dh_rec)[kElems]) {
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      if (!ev[i]) continue;
      const size_t idx = (size_t)eb[i] * N + ej[i];
      float dh_cot = dhin[p][i];
      // __fmul_rn: the product rounds before the add, as in the TPU kernel
      if (drop.on) dh_cot = keep_bit(drop, t, idx) ? __fmul_rn(dh_cot, drop.inv) : 0.0f;
      float d[4];
      gate_bwd(gin[p][i][0], gin[p][i][1], gin[p][i][2], gin[p][i][3], cin[p][i],
               cpin[p][i], dh_cot + dh_rec[i], dcr[i], standard, d, &dcr[i]);
      const size_t gb = t * bk + (size_t)eb[i] * K + ej[i];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const __nv_bfloat16 r = __float2bfloat16(d[qq]);
        dgx[gb + (size_t)qq * N] = r;
        if (dg32 != nullptr) dg32[gb + (size_t)qq * N] = d[qq];
        if (kDb) dbs[kDb ? i : 0][qq] += round_db ? __bfloat162float(r) : d[qq];
      }
    }
  };

#pragma unroll
  for (int p = 0; p < kSteps; ++p) load_inputs(p, S - 1 - p);
  cp_async_wait<0>();
  __syncthreads();

  for (int t1 = S - 1; t1 >= 0; t1 -= kSteps) {
#pragma unroll
    for (int p = 0; p < kSteps; ++p) {
      const int t = t1 - p;
      float dh_rec[kElems];
      if (t == S - 1) {
#pragma unroll
        for (int i = 0; i < kElems; ++i)
          dh_rec[i] = ev[i] ? dhT[(size_t)eb[i] * N + ej[i]] : 0.0f;
      } else {
        rec(dgx + (t + 1) * bk, dh_rec);
      }
      gate_step(p, t, dh_rec);
      if (p == kSteps - 1 && t > 0)
#pragma unroll
        for (int p2 = 0; p2 < kSteps; ++p2) load_inputs(p2, t - 1 - p2);
      grid.sync();  // dg_t is complete before any block reads it
    }
  }
  {
    // dh0 = round(dg_0) @ U^T, and dc0
    float dh_rec[kElems];
    rec(dgx, dh_rec);
#pragma unroll
    for (int i = 0; i < kElems; ++i)
      if (ev[i]) {
        dh0[(size_t)eb[i] * N + ej[i]] = dh_rec[i];
        dc[(size_t)eb[i] * N + ej[i]] = dcr[i];
      }
  }
  if (kDb) {
    // thread tid holds unit tid % kUnits of rows tid / kUnits + (kPThreads /
    // kUnits) * i: its sums over i, then over the threads of a unit in order
    constexpr int kPer = kPThreads / kUnits;
    float* sums = red;  // [kPer][4][kUnits]
    __syncthreads();    // rec's reads of red are done
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < kElems; ++i) v += dbs[kDb ? i : 0][x];
      sums[(tid / kUnits) * 4 * kUnits + x * kUnits + tid % kUnits] = v;
    }
    __syncthreads();
    const int col = (tid / kUnits) * N + j0 + tid % kUnits;  // gate q = tid / kUnits
    if (tid < 4 * kUnits) {
      float v = 0.0f;
      for (int w = 0; w < kPer; ++w) v += sums[w * 4 * kUnits + tid];
      db_part[(size_t)part * K + col] = v;
    }
    grid.sync();  // every part's sums are in db_part
    if (part == 0 && tid < 4 * kUnits) {
      float v = 0.0f;
      for (int p = 0; p < (int)gridDim.x / groups; ++p)
        v += __ldcg(db_part + (size_t)p * K + col);
      db[col] = v;
    }
  }
}

// The persistent reverse launch under bf16 compute: dg_seq (bf16, and fp32
// into dg32 unless null), dh0 and dc0; with db (K3, K12) also db, through
// db_part ((B / 16 + 1) x 4N floats at most), summing the bf16 dg with
// round_db. units: 8 or 16 hidden units a block; rows: 16, 32, 48 or 64
// batch rows a block; steps: 1, or 2 (K12, S even, with db).
template <typename RT>
int run_persist(const void* U, const void* g_seq, const void* c_seq,
                const float* c0, const float* c_last, const float* dh_seq,
                const float* dhT,
                float* dc, __nv_bfloat16* dgx, float* dg32, float* dh0,
                float* db, float* db_part, int S, int B, int N, int units,
                int rows, int steps, int standard, int round_db, Dropout drop,
                cudaStream_t stream, int* launches) {
  if ((4 * N) % kPKC != 0 || (units != 8 && units != 16) || N % units != 0 ||
      rows < 16 || rows > kPRows || rows % 16 != 0 || S < 1 ||
      (steps != 1 && steps != 2) || S % steps != 0 ||
      (steps == 2 && db == nullptr) || (db != nullptr && db_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // [units / 16][0: K6, 1: K3, 2: K12]
  using Kernel = decltype(&lstm_bwd_persist<RT, 1, 1, false>);
  static const Kernel kernels[2][3] = {
      {lstm_bwd_persist<RT, 1, 1, false>, lstm_bwd_persist<RT, 1, 1, true>,
       lstm_bwd_persist<RT, 1, 2, true>},
      {lstm_bwd_persist<RT, 2, 1, false>, lstm_bwd_persist<RT, 2, 1, true>,
       lstm_bwd_persist<RT, 2, 2, true>}};
  const int mode = db == nullptr ? 0 : steps;
  const Kernel kernel = kernels[units / 16][mode];
  const size_t smem = persist_smem_bytes(N, units);
  // per card, read once: cooperative launch support and the SMs; each
  // kernel's shared-memory limit raised when a launch needs more
  static int ready[kMaxDevices], coop[kMaxDevices], sms[kMaxDevices];
  static size_t cap[kMaxDevices][2][3];
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !ready[dev]) {
    err = cudaDeviceGetAttribute(&coop[dev], cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) ready[dev] = 1;
  }
  size_t* limit = err == cudaSuccess ? &cap[dev][units / 16][mode] : nullptr;
  if (err == cudaSuccess && *limit < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) *limit = smem;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kPThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop[dev]) return static_cast<int>(cudaErrorNotSupported);
  const int grid = (N / units) * ((B + rows - 1) / rows);
  // every block must be resident at once, or the grid barrier never opens
  if (grid > sms[dev] * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const __nv_bfloat16* u = static_cast<const __nv_bfloat16*>(U);
  const RT* gs = static_cast<const RT*>(g_seq);
  const RT* cs = static_cast<const RT*>(c_seq);
  void* args[] = {&u, &gs, &cs, &c0, &c_last, &dh_seq, &dhT, &dc, &dgx,
                  &dg32, &dh0, &db, &db_part, &drop, &S, &B, &N, &rows,
                  &standard, &round_db};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kPThreads), args, smem,
                                    stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

}  // namespace

// Scratch floats `work` holds for K3 and K12 in either design: the per-step
// design's dU split and colsum chunks; the persistent design's db parts,
// then (after the reverse launch) its dWU split.
extern "C" size_t lstm_bwd_embed_work_floats(int S, int B, int N, int M) {
  const size_t sizes[] = {atb_work_floats(S * B, N, 4 * N),
                          (size_t)colsum_chunks_of(S * B) * 4 * N,
                          (size_t)((B + 15) / 16) * 4 * N,
                          atb_work_floats(S * B, M + N, 4 * N)};
  size_t most = 0;
  for (const size_t n : sizes) most = n > most ? n : most;
  return most;
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

// K3's per-step design. Type codes: 0 = fp32, 1 = bf16. UT is U^T (4N, N)
// in the compute type; the residual sequences have the residual type; h0,
// c0, dh_seq, dhT and the outputs are fp32. dc holds dcT on entry and dc0 on return. dg is an
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

// K12's per-step design: K3's function, bit for bit, two reverse steps a
// cooperative launch (S even): S / 2 + 1 step launches against K3's S + 1.
// Arguments as lstm_bwd_embed_launch's.
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

// Scratch floats K6 needs in `work`, in either design.
extern "C" size_t lstm_bwd_scan_work_floats(int S, int B, int N) {
  return atb_work_floats(S * B, N, 4 * N);
}

// K6's per-step design. As lstm_bwd_embed_launch, without ids, dW and db; h0 is h_{-1}
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

// The weight gradients from the (S, B, 4N) fp32 dg sequence under fp32
// compute, as the per-step design takes them after its reverse steps
// (run_tail): the fp32 persistent design's tail (lstm_bwd_f32.cu). ids null
// and M 0: K6, dU (N, 4N) into out; else K3 and K12, dWU (M + N, 4N) into
// out and db (4N,), the sum of dg. h0 is h_{-1} in fp32, h_seq has the
// residual type (rtype 0 fp32, 1 bf16); work as lstm_bwd_scan_work_floats
// (K6) or lstm_bwd_embed_work_floats; round_db as lstm_bwd_embed_launch's.
extern "C" int lstm_bwd_tail_launch(int rtype, const void* h_seq,
                                    const void* ids, const void* h0,
                                    const void* dg, void* out, void* db,
                                    void* work, int S, int B, int N, int M,
                                    int round_db, void* stream, int* launches) {
  if (M < 0 || (M > 0) != (ids != nullptr) || (ids != nullptr && db == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(h_seq, static_cast<const int*>(ids), static_cast<const float*>(h0),
               static_cast<const float*>(dg), static_cast<float*>(out),
               static_cast<float*>(db), static_cast<float*>(work), S, B, N, M,
               round_db, static_cast<cudaStream_t>(stream), launches);
  };
  if (rtype == 0) return f(run_tail<float, float>);
  if (rtype == 1) return f(run_tail<float, __nv_bfloat16>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The device's SMs and the shared memory a block may opt in to, for the
// choice between the two designs (ops/cuda_cell_bwd.py:k6_plan).
extern "C" int lstm_bwd_device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// Bytes of dynamic shared memory a persistent block of `units` units takes
// at hidden size N.
extern "C" size_t lstm_bwd_persist_smem_bytes(int N, int units) {
  return persist_smem_bytes(N, units);
}

// The persistent design's reverse launch under bf16 compute (K6, K3, K12,
// and K16 of lstm_tp.cu's family at D = 1): the S reverse steps and dh0 in
// one cooperative launch. U is (N, 4N) in bf16 (not transposed); the
// residual sequences have the residual type (rtype 0 = fp32, 1 = bf16).
// c_last, (B, N) fp32 or null, is read in place of c_seq[S-1]: K16 hands
// c_{S-1} (its cT) apart, in fp32, and its c_prev stream advanced by a step
// as c_seq, which then ends at S-2. dgx receives dg_seq (S, B, 4N) in bf16,
// dg32 the fp32 dg or is null. db null: K6 (and K16); else K3 (steps 1) or
// K12 (steps 2)
// with db (4N,) the sum of the fp32 dg, or of the bf16 dg with round_db,
// through `work` (lstm_bwd_embed_work_floats). units, rows:
// ops/cuda_cell_bwd.py:k6_plan. Other arguments and results as
// lstm_bwd_scan_launch's.
extern "C" int lstm_bwd_persist_launch(
    int rtype, const void* U, const void* g_seq, const void* c_seq,
    const void* c0, const void* c_last, const void* dh_seq, const void* dhT,
    void* dc, void* dgx, void* dg32, void* dh0, void* db, void* work, int S,
    int B, int N,
    int units, int rows, int steps, int standard, int round_db, int drop_on,
    unsigned seed, unsigned keep, float inv, void* stream, int* launches) {
  const Dropout drop{drop_on, seed, keep, inv};
  const auto f = [&](auto run) {
    return run(U, g_seq, c_seq, static_cast<const float*>(c0),
               static_cast<const float*>(c_last),
               static_cast<const float*>(dh_seq),
               static_cast<const float*>(dhT), static_cast<float*>(dc),
               static_cast<__nv_bfloat16*>(dgx), static_cast<float*>(dg32),
               static_cast<float*>(dh0), static_cast<float*>(db),
               static_cast<float*>(work), S, B, N, units, rows, steps,
               standard, round_db, drop, static_cast<cudaStream_t>(stream),
               launches);
  };
  if (rtype == 0) return f(run_persist<float>);
  if (rtype == 1) return f(run_persist<__nv_bfloat16>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The persistent design's weight gradients on tensor cores, one launch or a
// split and a fixed-order sum: dU = round(h_{t-1})^T dg_seq into out (N, 4N)
// (K6), or with ids (S * B int32) and M > 0 dWU = [dW; dU] into out
// (M + N, 4N) (K3, K12), dW the one-hot product. h0 is h_{-1} in fp32, h_seq
// has the residual type, dgx is dg_seq in bf16; work as
// lstm_bwd_scan_work_floats (K6) or lstm_bwd_embed_work_floats. N a multiple
// of 32.
extern "C" int lstm_bwd_dWU_launch(int rtype, const void* h_seq,
                                   const void* h0, const void* ids,
                                   const void* dgx, void* out, void* work,
                                   int S, int B, int N, int M, void* stream,
                                   int* launches) {
  if (N % 32 != 0 || M < 0 || (M > 0) != (ids != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto* a1) {
    return run_atb_mma(static_cast<const int*>(ids), M,
                       static_cast<const float*>(h0), a1, B,
                       static_cast<const __nv_bfloat16*>(dgx),
                       static_cast<float*>(out), static_cast<float*>(work),
                       S * B, N, 4 * N, static_cast<cudaStream_t>(stream),
                       launches);
  };
  if (rtype == 0) return f(static_cast<const float*>(h_seq));
  if (rtype == 1) return f(static_cast<const __nv_bfloat16*>(h_seq));
  return static_cast<int>(cudaErrorInvalidValue);
}
