// Tensor-core and asynchronous-copy helpers for Hopper (sm_90a), through
// inline PTX: the warp-level bf16 product mma.sync m16n8k16 with fp32
// accumulation, ldmatrix (plain and transposed) to build its operand
// fragments from shared memory, and cp.async for global-to-shared copies
// that bypass L1 (so a copy sees what other blocks of the same launch wrote
// before a grid barrier).
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

}  // namespace
