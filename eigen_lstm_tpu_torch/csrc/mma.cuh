// Tensor-core and asynchronous-copy helpers for Hopper (sm_90a), through
// inline PTX: the warp-level bf16 product mma.sync m16n8k16 with fp32
// accumulation, ldmatrix (plain and transposed) to build its operand
// fragments from shared memory, and cp.async for global-to-shared copies
// that bypass L1 (so a copy sees what other blocks of the same launch wrote
// before a grid barrier); and atb_mma, a weight-gradient product A^T B on
// tensor cores built from them (K3, K6, K12 in lstm_bwd.cu, K5 in head.cu).
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (lane = 4 * g + q, g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major), 4 regs of 2 bf16: a0 (row g, k 2q..2q+1),
//     a1 (row g + 8, k 2q..), a2 (row g, k 2q + 8..), a3 (row g + 8, k 2q + 8..)
//   B (16 x 8, k by n), 2 regs: b0 (k 2q..2q+1, col g), b1 (k 2q + 8.., col g)
//   C (16 x 8, fp32), 4 floats: c0, c1 (row g, cols 2q, 2q + 1),
//     c2, c3 (row g + 8, cols 2q, 2q + 1)
// ldmatrix .x4 reads four 8 x 8 b16 matrices, lanes 8i..8i+7 giving the
// shared-memory addresses of matrix i's eight 16-byte rows; lane then holds,
// of each matrix, row g, elements 2q and 2q + 1 (with .trans: of the
// transposed matrix). So for A stored row-major ([m][k]) the four matrices
// (rows 0-7 | 8-15) x (k 0-7 | 8-15) in the order above give a0..a3, and
// for B stored as [n][k] two matrices (k 0-7, k 8-15) give b0, b1; operands
// stored the other way round ([k][m], [k][n]) take .trans.
//
// The product of two bf16 values is exact in fp32; the sums inside a
// tensor-core instruction take the hardware's order and rounding, not
// fp32's round to nearest, so a sum carried through thousands of
// instructions drifts further from the fp32 one than a sum order alone
// would move it (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// c += a * b on one 16 x 8 x 16 tile (fragments as above).
__device__ __forceinline__ void mma_bf16_16816(float c[4], const unsigned a[4],
                                               const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory; `row` is this lane's row
// address (lanes 8i..8i+7: matrix i).
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// Two matrices (lanes 0-15 give the addresses; the others' are not read).
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// As ldmatrix_x4, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// 16 bytes global -> shared, cached in L2 only; src_bytes < 16 fills the
// rest with zeros (0: all zeros, the source is not read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two fp32 values as one register of two bf16 (lo in the low half), each
// rounded to nearest even.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// atb_mma, the tensor-core counterpart of common.cuh's atb_gemm, for the
// weight gradients of the persistent backward (lstm_bwd.cu: K6's dU, K3's
// and K12's dW and dU) and of the head (head.cu: K5's dWhy):
// C (I, J) = sum_r round(A[r, :])^T B[r, :]
// with A's rows as atb_gemm's (A0 for r < R0, then A1), rounded to bf16 as
// they are staged, and B (R, J) already bf16; with ids (K3's dW), the M rows
// before them are the one-hot product, dW[v, :] = sum_{r: ids[r] = v} B[r, :]
// (0 and 1 are exact in bf16, so its sums are the rows' own in fp32). Block
// tile kGT x kGT (as atb_gemm, so atb_splits and atb_work_floats apply),
// the one-hot rows' tiles first, r chunks of kMR through two shared-memory
// buffers (the next chunk is loaded into registers while the current one is
// multiplied). 8 warps, each a 64 x 32 tile (4 x 4 mma tiles); both
// operands are stored [r][.] and enter the products through ldmatrix
// .trans. Split z sums its r range into out + z*(M+I)*J. I is a multiple
// of 16, J of kGT.
constexpr int kMR = 32;
constexpr int kMPitch = kGT + 8;

__device__ __forceinline__ void load16(const float* p, float v[16]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float4 f = *reinterpret_cast<const float4*>(p + 4 * x);
    v[4 * x] = f.x; v[4 * x + 1] = f.y; v[4 * x + 2] = f.z; v[4 * x + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[16]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + 8 * x);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int y = 0; y < 8; ++y) v[8 * x + y] = __bfloat162float(h[y]);
  }
}

template <typename AT>
__global__ void __launch_bounds__(256)
atb_mma(const int* __restrict__ ids, int M, const float* __restrict__ A0,
        const AT* __restrict__ A1, int R0, const __nv_bfloat16* __restrict__ Bm,
        float* __restrict__ out, int R, int I, int J, int r_chunk) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kMR][kMPitch];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kMR][kMPitch];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wi = (warp / 4) * 64, wj = (warp % 4) * 32;
  const int onehot_tiles = (M + kGT - 1) / kGT;
  const bool onehot = (int)blockIdx.y < onehot_tiles;
  const int rows_out = onehot ? M : I;
  const int i0 = (onehot ? blockIdx.y : blockIdx.y - onehot_tiles) * kGT;
  const int j0 = blockIdx.x * kGT;
  const int r_begin = blockIdx.z * r_chunk;
  const int r_end = min(R, r_begin + r_chunk);
  // staging: this thread's row of a chunk and its 16 columns
  const int sr = tid / 8, sc = (tid % 8) * 16;
  float av[16];
  uint4 bv[2];
  const auto load = [&](int r0) {
    const int r = r0 + sr;
    const bool in_a = r < r_end && i0 + sc < I, in_b = r < r_end;
#pragma unroll
    for (int x = 0; x < 16; ++x) av[x] = 0.0f;
    if (onehot) {
      const int v = r < r_end ? ids[r] : -1;
#pragma unroll
      for (int x = 0; x < 16; ++x) av[x] = i0 + sc + x == v ? 1.0f : 0.0f;
    } else if (in_a) {
      if (r < R0)
        load16(A0 + (size_t)r * I + i0 + sc, av);
      else
        load16(A1 + (size_t)(r - R0) * I + i0 + sc, av);
    }
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const uint4* src = reinterpret_cast<const uint4*>(Bm + (size_t)r * J + j0 + sc);
    bv[0] = in_b ? src[0] : zero;
    bv[1] = in_b ? src[1] : zero;
  };
  const auto store = [&](int buf) {
    uint4* da = reinterpret_cast<uint4*>(&As[buf][sr][sc]);
#pragma unroll
    for (int x = 0; x < 2; ++x)
      da[x] = make_uint4(pack_bf16x2(av[8 * x], av[8 * x + 1]),
                         pack_bf16x2(av[8 * x + 2], av[8 * x + 3]),
                         pack_bf16x2(av[8 * x + 4], av[8 * x + 5]),
                         pack_bf16x2(av[8 * x + 6], av[8 * x + 7]));
    uint4* db = reinterpret_cast<uint4*>(&Bs[buf][sr][sc]);
    db[0] = bv[0];
    db[1] = bv[1];
  };
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[a][b][x] = 0.0f;

  load(r_begin);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kMR) {
    const bool more = r0 + kMR < r_end;
    if (more) load(r0 + kMR);
#pragma unroll
    for (int ks = 0; ks < kMR; ks += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], &As[buf][ks + lane % 8 + 8 * (lane / 16)]
                                     [wi + mt * 16 + 8 * ((lane / 8) % 2)]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned x[4];
        ldmatrix_x4_trans(x, &Bs[buf][ks + lane % 8 + 8 * ((lane / 8) % 2)]
                                [wj + np * 16 + 8 * (lane / 16)]);
        b[2 * np][0] = x[0];
        b[2 * np][1] = x[1];
        b[2 * np + 1][0] = x[2];
        b[2 * np + 1][1] = x[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  float* C = out + (size_t)blockIdx.z * (M + I) * J + (onehot ? 0 : (size_t)M * J);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wi + mt * 16 + g + 8 * h;
      if (i >= rows_out) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(C + (size_t)i * J + j0 + wj + nt * 8 + 2 * q) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
}

// C = A^T B through atb_mma on `stream` (with ids, the M one-hot rows
// before it), split over r as run_atb splits it (through `work`, then
// sum_slabs in a fixed order).
template <typename AT>
int run_atb_mma(const int* ids, int M, const float* A0, const AT* A1, int R0,
                const __nv_bfloat16* Bm, float* C, float* work, int R, int I,
                int J, cudaStream_t stream, int* launches) {
  const int splits = atb_splits(R, M + I, J);
  int r_chunk = (R + splits - 1) / splits;
  r_chunk = (r_chunk + kMR - 1) / kMR * kMR;
  const dim3 grid(J / kGT, (M + kGT - 1) / kGT + (I + kGT - 1) / kGT, splits);
  atb_mma<AT><<<grid, 256, 0, stream>>>(ids, M, A0, A1, R0, Bm,
                                        splits == 1 ? C : work, R, I, J, r_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  if (splits > 1) {
    const size_t n = (size_t)(M + I) * J;
    sum_slabs<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(work, C, splits, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace
