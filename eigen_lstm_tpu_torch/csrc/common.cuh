// Helpers shared by the port's kernels: type conversion and rounding to the
// compute type, the gate nonlinearity, the cell update and the gate
// backward, the two product tiles of a recurrent step (gate_sums_tile,
// rec_tile), and the two fixed-order reductions that the backward kernels
// use for their weight gradients:
//
//   atb_gemm: C (I, J) = sum_r round(A[r, :])^T round(B[r, :]), a hand-written
//     tiled product on CUDA cores, the reduction over r split across blocks
//     into partial slabs that a second launch adds in a fixed order;
//   colsum:   out (J,) = sum_r X[r, :], each term optionally rounded to a
//     type XT first, in 128-row chunks and then over the chunks, both in a
//     fixed order.
//
// Both are deterministic: the same inputs give the same bits on every run.
// Last, cooperative_fits: the residency check of the fp32 persistent
// designs' cooperative launches.
// Everything here has internal linkage (an unnamed namespace), so each
// translation unit that includes it gets its own copy of every kernel.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and JAX
}

// x rounded to the compute type CT and widened back to fp32.
template <typename CT> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<CT>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// _cell_fwd of the TPU kernels: "reference" carries c = tanh(i*u + f*c_prev)
// with h = o*c; "standard" carries c_raw with h = o*tanh(c_raw). gate holds
// the activated [i|o|f|u].
__device__ __forceinline__ void cell(const float gate[4], float c_prev,
                                     int standard, float* h, float* c) {
  const float c_raw = gate[0] * gate[3] + gate[2] * c_prev;
  if (standard) {
    *h = gate[1] * tanhf(c_raw);
    *c = c_raw;
  } else {
    *c = tanhf(c_raw);
    *h = gate[1] * *c;
  }
}

// _gate_bwd of the TPU kernels: from the activated gates, the carried cell
// ct, c_{t-1} cp, dh_total and the carried dc, the pre-activation dg
// ([i|o|f|u], fp32) and the dc carried to t-1.
__device__ __forceinline__ void gate_bwd(float gi, float go, float gf,
                                         float gu, float ct, float cp,
                                         float dh_total, float dc,
                                         int standard, float dg[4],
                                         float* dc_prev) {
  float dc_raw, d_o;
  if (standard) {
    const float tc = tanhf(ct);
    dc_raw = dh_total * go * (1.0f - tc * tc) + dc;
    d_o = dh_total * tc;
  } else {
    const float dct = dh_total * go + dc;
    dc_raw = dct * (1.0f - ct * ct);
    d_o = dh_total * ct;
  }
  const float di = dc_raw * gu, du = dc_raw * gi, df = dc_raw * cp;
  dg[0] = di * gi * (1.0f - gi);
  dg[1] = d_o * go * (1.0f - go);
  dg[2] = df * gf * (1.0f - gf);
  dg[3] = du * (1.0f - gu * gu);
  *dc_prev = dc_raw * gf;
}

// ---------------------------------------------------------------------------
// The product tiles of one recurrent step, on CUDA cores, shared by the
// one-step kernels (K1/K2 forward, K3/K6/K12 reverse) and the
// tensor-parallel ones (K13, K15, K16). A block of (kLanes, kKS) threads
// owns 32 units j (one warp's lanes, so weight rows are read coalesced) and
// kBT batch rows b0..b0+kBT-1 (tile bx, by); its kKS warps split the
// reduction over k, staged kKT at a time in shared memory, and meet in
// shared memory in a fixed order. Every thread of the block calls a tile
// with the same (bx, by); warp r < kBT then returns true for row b0 + r < B
// with its sums for its lane's unit.
constexpr int kLanes = 32;  // hidden units per block
constexpr int kKS = 8;      // warps splitting the k reduction
constexpr int kBT = 4;      // batch rows per block
constexpr int kKT = 256;    // k tile staged in shared memory

// *p, through L2 only (__ldcg) where kL2: for a buffer that other blocks
// write inside the launch.
template <bool kL2, typename T>
__device__ __forceinline__ T tile_load(const T* p) {
  if constexpr (kL2) return __ldcg(p);
  else return *p;
}

// The four gate sums s[g] = sum_k round(h[b, k]) * U[k, g*nd + j] over the
// K-long k axis, with h (B, K) in HT, U (K, 4nd) in CT and round() to CT
// (nd = K for one device; under tensor parallelism the shard's width).
// kL2: h is written inside the launch (K15's exchange slots), so it is read
// through L2 only (__ldcg), never through the non-coherent path.
template <typename CT, typename HT, bool kL2 = false>
__device__ __forceinline__ bool
gate_sums_tile(const CT* __restrict__ U, const HT* __restrict__ h, int B,
               int K, int nd, int bx, int by, float s[4], int* b_out,
               int* j_out) {
  __shared__ float hs[kBT][kKT];
  __shared__ float red[kKS][4][kBT][kLanes];

  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int j = bx * kLanes + lane;
  const int b0 = by * kBT;
  const int n4 = 4 * nd;

  float acc[4][kBT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kBT; ++r) acc[g][r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKT) {
    const int klen = min(kKT, K - k0);
    __syncthreads();
    for (int e = w * kLanes + lane; e < kBT * klen; e += kKS * kLanes) {
      const int r = e / klen, kk = e % klen;
      const int b = b0 + r;
      hs[r][kk] = b < B
          ? round_to<CT>(to_f32(tile_load<kL2>(h + (size_t)b * K + k0 + kk)))
          : 0.0f;
    }
    __syncthreads();
    for (int kk = w; kk < klen; kk += kKS) {
      const CT* urow = U + (size_t)(k0 + kk) * n4 + j;
      float u4[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) u4[g] = to_f32(urow[(size_t)g * nd]);
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        const float hv = hs[r][kk];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hv, u4[g], acc[g][r]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kBT; ++r) red[w][g][r][lane] = acc[g][r];
  __syncthreads();

  const int r = w;
  const int b = b0 + r;
  if (r >= kBT || b >= B) return false;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < kKS; ++q) v += red[q][g][r][lane];
    s[g] = v;
  }
  *b_out = b;
  *j_out = j;
  return true;
}

// The recurrent dh of the reverse step: *dh = sum_k round(dg[b, k]) *
// UT[k, j] over the K-long gate axis (K = 4nd), with dg (B, K) fp32, UT
// (K, N) = U^T in CT (read as U^T so that the lanes read coalesced) and
// round() to CT; j runs over the N-wide h. kL2: dg is written inside the
// launch and read through L2 only, as gate_sums_tile's h.
template <typename CT, bool kL2 = false>
__device__ __forceinline__ bool
rec_tile(const CT* __restrict__ UT, const float* __restrict__ dg, int B,
         int N, int K, int bx, int by, float* dh, int* b_out, int* j_out) {
  __shared__ float ds[kBT][kKT];
  __shared__ float red[kKS][kBT][kLanes];

  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int j = bx * kLanes + lane;
  const int b0 = by * kBT;

  float acc[kBT];
#pragma unroll
  for (int r = 0; r < kBT; ++r) acc[r] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    const int klen = min(kKT, K - k0);
    __syncthreads();
    for (int e = w * kLanes + lane; e < kBT * klen; e += kKS * kLanes) {
      const int r = e / klen, kk = e % klen;
      const int b = b0 + r;
      ds[r][kk] = b < B
          ? round_to<CT>(tile_load<kL2>(dg + (size_t)b * K + k0 + kk))
          : 0.0f;
    }
    __syncthreads();
    for (int kk = w; kk < klen; kk += kKS) {
      const float u = to_f32(UT[(size_t)(k0 + kk) * N + j]);
#pragma unroll
      for (int r = 0; r < kBT; ++r) acc[r] = fmaf(ds[r][kk], u, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kBT; ++r) red[w][r][lane] = acc[r];
  __syncthreads();

  const int r = w;
  const int b = b0 + r;
  if (r >= kBT || b >= B) return false;
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < kKS; ++q) v += red[q][r][lane];
  *dh = v;
  *b_out = b;
  *j_out = j;
  return true;
}

// ---------------------------------------------------------------------------
// The dropout keep-mask, _keep_mask of eigen_lstm_tpu/ops/pallas_cell.py:84:
// a murmur3-finalizer hash of (seed, timestep tau, global element index
// b * N + j), all in wrapping uint32 arithmetic, kept where the hash is
// <= keep. keep = int((1 - rate) * 0xFFFFFFFF) and inv = fp32(1 / (1 - rate))
// come from the host; seed is the layer's int32 seed with the same bits. A
// kernel that masks rebuilds the bits from (seed, tau) instead of reading
// them, and indexes elements globally, so no blocking changes them.
struct Dropout {
  int on;          // 0: no dropout (the other fields are not read)
  unsigned seed;
  unsigned keep;
  float inv;
};

__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool keep_bit(const Dropout& d, int tau, size_t idx) {
  const unsigned base = fmix32(d.seed ^ (static_cast<unsigned>(tau) * 0x9E3779B9u));
  return fmix32((static_cast<unsigned>(idx) * 0x85EBCA6Bu) ^ base) <= d.keep;
}

// ---------------------------------------------------------------------------
// atb_gemm. Row r of A is A0[r] for r < R0 and A1[r - R0] after (the layer-0
// backward's h_{t-1}: h0 for t = 0, then h_seq); both have I columns. B is
// (R, J) fp32. Operands are rounded to CT as they are staged, products and
// sums are fp32. Block tile 128 x 128, r tile 8, 256 threads each owning an
// 8 x 8 patch (two 4-wide strips in each direction, read as float4).
// grid = (ceil(J/128), ceil(I/128), splits); split z sums its r range into
// out + z*I*J (the final C when splits == 1).
constexpr int kGT = 128;  // output tile edge
constexpr int kGR = 8;    // r tile

template <typename CT, typename AT>
__global__ void __launch_bounds__(256)
atb_gemm(const float* __restrict__ A0, const AT* __restrict__ A1, int R0,
         const float* __restrict__ Bm, float* __restrict__ out, int R, int I,
         int J, int r_chunk) {
  __shared__ __align__(16) float As[kGR][kGT];
  __shared__ __align__(16) float Bs[kGR][kGT];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kGT, j0 = blockIdx.x * kGT;
  const int r_begin = blockIdx.z * r_chunk;
  const int r_end = min(R, r_begin + r_chunk);
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

  // staging: thread loads 4 consecutive columns of one r row of each tile
  const int lr = tid / 32, lc = (tid % 32) * 4;
  for (int r0 = r_begin; r0 < r_end; r0 += kGR) {
    const int r = r0 + lr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + lc + q, j = j0 + lc + q;
      float av = 0.0f, bv = 0.0f;
      if (r < r_end && i < I)
        av = r < R0 ? A0[(size_t)r * I + i] : to_f32(A1[(size_t)(r - R0) * I + i]);
      if (r < r_end && j < J) bv = Bm[(size_t)r * J + j];
      As[lr][lc + q] = round_to<CT>(av);
      Bs[lr][lc + q] = round_to<CT>(bv);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kGR; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[rr][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[rr][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[rr][tx * 4 + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* C = out + (size_t)blockIdx.z * I * J;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + ty * 4 + (a % 4) + (a / 4) * 64;
    if (i >= I) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + tx * 4 + (b % 4) + (b / 4) * 64;
      if (j < J) C[(size_t)i * J + j] = acc[a][b];
    }
  }
}

// out[e] = sum_z part[z*n + e] for z = 0..splits-1 in order.
__global__ void sum_slabs(const float* __restrict__ part, float* __restrict__ out,
                          int splits, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + e];
  out[e] = s;
}

// C = A^T B as above on `stream`: one launch when the tiles alone fill the
// card, else a split over r into `work` (splits * I * J floats) and one
// fixed-order sum. Adds its launches to *launches; returns the first error.
constexpr int kMaxSplits = 32;

inline int atb_splits(int R, int I, int J) {
  const int tiles = ((I + kGT - 1) / kGT) * ((J + kGT - 1) / kGT);
  int splits = (264 + tiles - 1) / tiles;  // about two blocks per SM
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  const int max_by_r = (R + 63) / 64;      // at least 64 rows a split
  return splits > max_by_r ? (max_by_r < 1 ? 1 : max_by_r) : splits;
}

template <typename CT, typename AT>
int run_atb(const float* A0, const AT* A1, int R0, const float* Bm, float* C,
            float* work, int R, int I, int J, cudaStream_t stream,
            int* launches) {
  const int splits = atb_splits(R, I, J);
  int r_chunk = (R + splits - 1) / splits;
  r_chunk = (r_chunk + kGR - 1) / kGR * kGR;
  const dim3 grid((J + kGT - 1) / kGT, (I + kGT - 1) / kGT, splits);
  atb_gemm<CT, AT><<<grid, 256, 0, stream>>>(A0, A1, R0, Bm,
                                             splits == 1 ? C : work, R, I, J,
                                             r_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  if (splits > 1) {
    const size_t n = (size_t)I * J;
    sum_slabs<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(work, C, splits, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

// Scratch floats run_atb needs at (R, I, J).
inline size_t atb_work_floats(int R, int I, int J) {
  const int splits = atb_splits(R, I, J);
  return splits > 1 ? (size_t)splits * I * J : 0;
}

// ---------------------------------------------------------------------------
// colsum: part[c, j] = sum of round_to<XT>(X) rows 128c .. 128c+127 in
// order (XT = float: X as it is); then out[j] = sum_c part[c, j] in order.
// grid = (ceil(J/256), chunks).
constexpr int kColChunk = 128;

template <typename XT>
__global__ void colsum_chunks(const float* __restrict__ X, float* __restrict__ part,
                              int R, int J) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  const int r0 = blockIdx.y * kColChunk, r1 = min(R, r0 + kColChunk);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += round_to<XT>(X[(size_t)r * J + j]);
  part[(size_t)blockIdx.y * J + j] = s;
}

inline int colsum_chunks_of(int R) { return (R + kColChunk - 1) / kColChunk; }

// out = column sums of X (R, J), each term rounded to XT, through `work`
// (chunks * J floats).
template <typename XT = float>
int run_colsum(const float* X, float* out, float* work, int R, int J,
               cudaStream_t stream, int* launches) {
  const int chunks = colsum_chunks_of(R);
  colsum_chunks<XT><<<dim3((J + 255) / 256, chunks), 256, 0, stream>>>(X, work, R, J);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  sum_slabs<<<(J + 255) / 256, 256, 0, stream>>>(work, out, chunks, (size_t)J);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

// ---------------------------------------------------------------------------
// Opts `kernel` in to `smem` bytes of dynamic shared memory and checks that
// `grid` blocks of `threads` can be resident at once on the current card
// (a cooperative launch's grid barrier never opens otherwise): 0 or the
// error. The fp32 persistent designs' launchers share it.
inline int cooperative_fits(const void* kernel, int threads, size_t smem, int grid) {
  constexpr int kDevices = 64;
  // per card, read once: cooperative launch support and the SMs
  static int ready[kDevices], coop[kDevices], sms[kDevices];
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kDevices) err = cudaErrorInvalidDevice;
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

}  // namespace
