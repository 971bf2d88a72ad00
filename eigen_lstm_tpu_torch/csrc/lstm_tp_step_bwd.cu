// K14 for Hopper (sm_90a) under bf16 compute: the gate backward of one TP
// step and the rank's partial dh_full = round(dg) @ U_c^T in one
// cooperative launch, bound from Python through ctypes
// (ops/cuda_tp_cell.py:tp_step_bwd_dh). No PyTorch headers. Replaces
// pallas_tp_cell.py:_step_bwd_kernel (:82) together with the dot_general of
// its VJP that forms dh_full (:142-146), wherever
// ops/cuda_tp_cell.py:tp_step_bwd_plan gives a layout; elsewhere (fp32
// compute, refused shapes) K14 keeps its first design, lstm_tp.cu's
// tp_step_bwd_launch with the product outside (ops/cell.py:matmul).
//
//   tp_step_bwd_dh_launch: from g (B, 4nd), c2, c_prev, dh, dc (B, nd),
//       fp32, and U_c (N, 4nd) in bf16: dg (B, 4nd) and dc_prev (B, nd) in
//       fp32, dh_full (B, N) in bf16, its fp32 sums rounded once.
//
// What held the first design back at the flagship's shard (B = 128, N =
// 1024, D = 1): the elementwise pass moves ~6 MB with 4-byte loads, a
// thread an element, and the product after it ran in fp32 on cuBLAS with
// casts around it (dg rounded and widened, U_c widened from bf16: 8.4 MB
// read and 16.8 MB written a step), 1.07 GFLOP at the fp32 rate where the
// JAX VJP asks for bf16 inputs with fp32 sums. Here a grid of (N / 64) x G
// blocks, every block resident, does three things:
//   0. it starts the copy of its slice of U_c (its group's 64 rows over its
//      part of the 4nd gate columns) into shared memory with cp.async,
//      which lands while
//   1. every thread runs the gate backward (common.cuh's gate_bwd, as every
//      design) over a fixed share of the B x nd elements, four a vector
//      with 16-byte loads and stores: dg in fp32 and round(dg) into dgx
//      for the product; then a grid barrier: dg whole;
//   2. the block's part of round(dg) @ U_c^T for its 64 units and every
//      batch row: round(dg)'s columns of its part through a cp.async.cg
//      ring (L2 only); warp w takes the batch rows 16 w.. against all 64
//      units, mma.sync m16n8k16 with fp32 sums (the ldmatrix layouts of
//      K16's bf16 D-rank step, lstm_tp_persist.cu), U_c's rows streamed
//      for the step since nothing holds them across launches; with G = 1
//      its sums are dh_full, else it stores them to xbuf (G, B, N) and,
//      after a second grid barrier,
//   3. every thread adds the G parts of its share of dh_full in part order
//      and rounds the sum once to bf16.
// G is the first of 16, 8, 4, 2, 1 whose grid the card holds (8 at N =
// 1024, 128 blocks). It comes from (N, nd) and the card, never from B, so
// every batch (SP's 32-row chunks too) takes one sum order.
//
// What bounds it on the H100: at the flagship's shard the bytes (U_c, g,
// c2, c_prev, dh, dc in, dg, dc_prev, dh_full out: 15.5 MB, 4.6 us) over
// the 1.07 GFLOP at 989 TFLOP/s (1.1 us).

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSThreads = 256;             // 8 warps
constexpr int kSUnits = 64;                // units of a group, 8 n tiles
constexpr int kSKC = 64;                   // gate columns of a ring chunk
constexpr int kSPad = 8;                   // elements of padding a row
constexpr int kSRingPitch = kSKC + kSPad;  // elements of a ring row
constexpr int kSMaxRows = 128;             // batch rows: 8 m tiles, a warp each

struct StepBwd {
  const float *g, *c2, *c_prev, *dh, *dc;  // (B, 4nd); (B, nd) each
  const __nv_bfloat16* U;                  // (N, 4nd)
  // written in phase 1 and read in 2 by other blocks (through L2 only)
  float* dg;                               // (B, 4nd)
  __nv_bfloat16* dgx;                      // (B, 4nd) round(dg)
  float* dc_prev;                          // (B, nd)
  float* xbuf;                             // (G, B, N) the parts: G > 1 only
  __nv_bfloat16* dh_full;                  // (B, N)
  int B, N, nd, G, standard;
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// 1: the gate backward of the step's B x nd elements, vector (blockIdx.x *
// 256 + tid) + i * gridDim.x * 256 of four elements a thread (nd a
// multiple of 4, so a vector lies in one row)
__device__ __forceinline__ void step_gates(const StepBwd& a) {
  const int nd = a.nd;
  const size_t K = 4 * (size_t)nd, nvec = (size_t)a.B * nd / 4;
  for (size_t v = (size_t)blockIdx.x * kSThreads + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * kSThreads) {
    const size_t e = 4 * v, gb = e / nd * K + e % nd;
    float gt[4][4], ct[4], cp[4], dh[4], dc[4], d[4][4], dcp[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(a.g + gb + (size_t)q * nd, gt[q]);
    load4(a.c2 + e, ct);
    load4(a.c_prev + e, cp);
    load4(a.dh + e, dh);
    load4(a.dc + e, dc);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float dl[4];
      gate_bwd(gt[0][l], gt[1][l], gt[2][l], gt[3][l], ct[l], cp[l], dh[l], dc[l],
               a.standard, dl, &dcp[l]);
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q][l] = dl[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      *reinterpret_cast<float4*>(a.dg + gb + (size_t)q * nd) =
          make_float4(d[q][0], d[q][1], d[q][2], d[q][3]);
      *reinterpret_cast<uint2*>(a.dgx + gb + (size_t)q * nd) =
          make_uint2(pack_bf16x2(d[q][0], d[q][1]), pack_bf16x2(d[q][2], d[q][3]));
    }
    *reinterpret_cast<float4*>(a.dc_prev + e) = make_float4(dcp[0], dcp[1], dcp[2], dcp[3]);
  }
}

// 3: dh_full from the G parts in xbuf, added in part order (L2 only:
// other blocks stored them), four units a vector, rounded once to bf16
__device__ __forceinline__ void step_part_sums(const StepBwd& a) {
  const size_t nvec = (size_t)a.B * a.N / 4;
  const float4* parts = reinterpret_cast<const float4*>(a.xbuf);
  for (size_t v = (size_t)blockIdx.x * kSThreads + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * kSThreads) {
    float4 s = __ldcg(parts + v);
    for (int p = 1; p < a.G; ++p) {
      const float4 x = __ldcg(parts + (size_t)p * nvec + v);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    *reinterpret_cast<uint2*>(a.dh_full + 4 * v) =
        make_uint2(pack_bf16x2(s.x, s.y), pack_bf16x2(s.z, s.w));
  }
}

// Block (group, part) = (blockIdx.x / G, blockIdx.x % G) owns units u0 =
// 64 group.. and the gate columns part 4nd / G..; round(dg)'s rows of
// those columns through a ring of STAGES chunks of kSKC columns; warp w
// the rows 16 w.. of all 64 units.
template <int STAGES>
__global__ void __launch_bounds__(kSThreads, 1) tp_step_bwd_dh_bf16(const StepBwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * a.nd, KG = K / a.G, upitch = KG + kSPad;
  const int part = blockIdx.x % a.G, u0 = (blockIdx.x / a.G) * kSUnits;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = (a.B + 15) / 16 * 16;       // whole m tiles
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem);  // [unit][k]
  __nv_bfloat16* ring = Us + (size_t)kSUnits * upitch;
  const __nv_bfloat16* U = a.U;
  for (int e = tid; e < kSUnits * (KG / 8); e += kSThreads) {
    const int u = e / (KG / 8), k = 8 * (e % (KG / 8));
    cp_async_16(Us + (size_t)u * upitch + k,
                U + (size_t)(u0 + u) * K + (size_t)part * KG + k, 16);
  }
  cp_async_commit();
  step_gates(a);
  cg::this_grid().sync();  // round(dg) is whole

  const __nv_bfloat16* dgn = a.dgx + (size_t)part * KG;
  const int nchunks = KG / kSKC;
  // chunk c: columns c * kSKC.. of the block's part, rows past B zero-filled
  const auto load_chunk = [&](int c) {
    __nv_bfloat16* slot = ring + (size_t)(c % STAGES) * rows * kSRingPitch;
    for (int p = tid; p < rows * (kSKC / 8); p += kSThreads) {
      const int r = p / (kSKC / 8), k = 8 * (p % (kSKC / 8));
      const bool in = r < a.B;
      cp_async_16(slot + r * kSRingPitch + k,
                  in ? dgn + (size_t)r * K + c * kSKC + k : dgn, in ? 16 : 0);
    }
  };
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] = 0.0f;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_async_commit();
  }
  const bool active = 16 * warp < a.B;
  for (int c = 0; c < nchunks; ++c) {
    // chunk c is in (and U's rows, the oldest group), chunk c - 1's slot free
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < nchunks) load_chunk(c + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const __nv_bfloat16* slot = ring + (size_t)(c % STAGES) * rows * kSRingPitch;
#pragma unroll
    for (int ks = 0; ks < kSKC / 16; ++ks) {
      const int kk = c * kSKC + 16 * ks;
      unsigned af[4], bq[16];
      ldmatrix_x4(af, slot + (16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * kSRingPitch +
                          16 * ks + 8 * (lane / 16));
      // b0, b1 of n tiles 2p, 2p + 1: units 16p.. (k 0-7 | 8-15), 16p + 8..
      const __nv_bfloat16* urow =
          Us + (size_t)(lane % 8 + 8 * (lane / 16)) * upitch + kk + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int p = 0; p < 4; ++p) ldmatrix_x4(bq + 4 * p, urow + (size_t)16 * p * upitch);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_bf16_16816(acc[nt], af, bq + 2 * nt);
    }
  }
  cp_async_wait<0>();
  if (active) {
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 16 * warp + g + 8 * h, j = u0 + 8 * nt + 2 * q;
        if (b >= a.B) continue;
        const float x0 = acc[nt][2 * h], x1 = acc[nt][2 * h + 1];
        if (a.G == 1)
          *reinterpret_cast<unsigned*>(a.dh_full + (size_t)b * a.N + j) =
              pack_bf16x2(x0, x1);
        else
          __stcg(reinterpret_cast<float2*>(a.xbuf + ((size_t)part * a.B + b) * a.N + j),
                 make_float2(x0, x1));
      }
  }
  if (a.G == 1) return;
  cg::this_grid().sync();  // every part is in
  step_part_sums(a);
}

// Dynamic shared memory of a block (mirrored by ops/cuda_tp_cell.py:
// step_bwd_smem_bytes): the slice of U (64 units x (4nd / G + kSPad)),
// then the ring (STAGES chunks of the batch's whole m tiles by
// kSRingPitch).
inline size_t step_bwd_smem_bytes(int B, int nd, int G, int stages) {
  const size_t kg = (size_t)4 * nd / G;
  const size_t rows = (size_t)(B + 15) / 16 * 16;
  return sizeof(__nv_bfloat16) * (kSUnits * (kg + kSPad) + stages * rows * kSRingPitch);
}

template <typename Kernel>
int launch_step(Kernel kernel, const StepBwd& a, int grid, size_t smem,
                cudaStream_t stream) {
  const int err = cooperative_fits(reinterpret_cast<const void*>(kernel), kSThreads,
                                   smem, grid);
  if (err != 0) return err;
  StepBwd args = a;
  void* params[] = {&args};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                              dim3(grid), dim3(kSThreads), params,
                                              smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The rings the library is built for, as
// ops/cuda_tp_cell.py:STEP_BWD_STAGES lists them.
#define STEP_BWD_STAGES(X) X(4) X(2)

}  // namespace

// K14 (ops/cuda_tp_cell.py:tp_step_bwd_plan gives G and the ring's
// stages): g, c2, c_prev, dh, dc, dg, dc_prev fp32, all 16-byte aligned, as
// are U (bf16) and xbuf; dgx (B, 4nd) and dh_full (B, N) bf16, 8-byte
// aligned; xbuf (G, B, N) fp32 for G > 1, else unused. 1 <= B <= 128, nd a
// multiple of 16, 4nd / G of kSKC, N of 64, G 1, 2, 4, 8 or 16; the grid
// of N / 64 x G blocks resident at once. One cooperative launch, added to
// *launches.
extern "C" int tp_step_bwd_dh_launch(const void* g, const void* c2, const void* c_prev,
                                     const void* dh, const void* dc, const void* U,
                                     void* dg, void* dc_prev, void* dh_full, void* dgx,
                                     void* xbuf, int B, int N, int nd, int standard,
                                     int G, int stages, void* stream, int* launches) {
  if ((G != 1 && G != 2 && G != 4 && G != 8 && G != 16) || B < 1 || B > kSMaxRows ||
      nd < 16 || nd % 16 != 0 || (4 * nd) % G != 0 || (4 * nd / G) % kSKC != 0 ||
      N % kSUnits != 0 || (G > 1 && xbuf == nullptr) || dgx == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const vec16[] = {g, c2, c_prev, dh, dc, U, dg, dc_prev};
  for (const void* p : vec16)
    if (!aligned(p, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  if ((G > 1 && !aligned(xbuf, 16)) || !aligned(dh_full, 8) || !aligned(dgx, 8))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const StepBwd a{static_cast<const float*>(g), static_cast<const float*>(c2),
                  static_cast<const float*>(c_prev), static_cast<const float*>(dh),
                  static_cast<const float*>(dc), static_cast<const __nv_bfloat16*>(U),
                  static_cast<float*>(dg), static_cast<__nv_bfloat16*>(dgx),
                  static_cast<float*>(dc_prev), static_cast<float*>(xbuf),
                  static_cast<__nv_bfloat16*>(dh_full), B, N, nd, G, standard};
  const int grid = N / kSUnits * G;
  const size_t smem = step_bwd_smem_bytes(B, nd, G, stages);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
#define STEP_CASE(st) \
  if (stages == st) err = launch_step(tp_step_bwd_dh_bf16<st>, a, grid, smem, s);
  STEP_BWD_STAGES(STEP_CASE)
#undef STEP_CASE
  if (err == 0) ++*launches;
  return err;
}

// Bytes of dynamic shared memory a block of K14 takes at batch B and shard
// width nd, G blocks a group, `stages` slots.
extern "C" size_t tp_step_bwd_dh_smem_bytes(int B, int nd, int G, int stages) {
  return step_bwd_smem_bytes(B, nd, G, stages);
}
