// K13 under fp32 compute for Hopper (sm_90a): one step of the fp32
// persistent forward (lstm_tiled_f32.cuh: f32_fwd_window in K15's mode),
// bound from Python through ctypes (ops/cuda_tp_cell.py). No PyTorch
// headers. Replaces pallas_tp_cell.py:_step_fwd_kernel (:72) under fp32
// compute wherever ops/cuda_tp_cell.py:tp_step_plan gives an fp32 layout
// (N a multiple of 32, nd of 8, B <= 128, a grid of (nd / 8) x ceil(B /
// rows) blocks resident at one an SM, the ring in a block's shared memory);
// elsewhere K13 keeps lstm_tp.cu's CUDA-core step tile (tp_step_fwd).
//
//   tp_step_fwd_f32_launch: g = xw + h_full @ U_d (xw fp32 with the bias
//       folded in, h_full and U_d fp32, TF32 off, so CUDA cores), sigma on
//       [i|o|f], tanh on u, the cell of the config's variant; out h2, c2
//       (B, nd) and the activated g (B, 4nd), all fp32.
//
// What held the CUDA-core step tile back at the flagship's shard (B = 128,
// N = 1024, D = 1): its blocks own 32 units x 4 batch rows, so each step
// reads U_d (16.8 MB in fp32) from L2 once per 4 rows, 32 times over the
// grid, ~512 MB a step: ~70 us at L2's rate. Here a block owns kPUnits = 8
// units of the shard with their four gate columns (gate stride nd, h and
// U's rows N wide) and `rows` batch rows (ops/cuda_cell_tiled.py:
// f32_split_rows over nd / 8 column blocks: all 128 rows at D = 1, 2 block
// rows of 64 at D = 2, 4 of 32 at D = 4, 128 blocks each time), so U_d is
// read ceil(B / rows) times a step over the grid. Nothing holds U_d past
// one launch, so its N x 32 slice streams through the cp.async.cg ring
// beside the block's rows of h_full, a slot a KC-row chunk of both (as the
// bf16 K13 streams U through fwd_products). The product is the window's:
// split s = tid / 64 sums the k with (k mod 32) / 8 = s in ascending k with
// 8 x 8 register tiles of FFMAs, and the splits' partial sums are added in
// split order, so a row's sums do not depend on the rows a block holds,
// the ring or nd: a window of these steps gives K15's fp32 window bits at
// D = 1, and a shard's steps at D ranks the D = 1 bits on the unpermuted
// weights. The slot keeps a chunk of U gate-major ([k][gate][unit]), so a
// thread's tile is 8 units of one gate, each a 16-byte copy from U_d's
// rows; the columns' sums are the window's whatever thread computes them.
// The epilogue is K13's: acc + xw, the gates, the cell, h2, c2 and g.
//
// What bounds it on the H100: operations, 2 B N 4nd flops at 67 TFLOP/s
// (16 us at D = 1); its L2 reads are ceil(B / rows) x U_d plus (nd / 8) x
// the block's rows of h_full (80 MB at D = 1, less than the 512 MB above),
// and the loop's shared loads are as busy as its FMAs, as in the window.

#include "lstm_tiled_f32.cuh"

namespace {

// Floats of a row of the splits' partial sums: [gate][unit] and a pad, so
// that the epilogue's four rows of a warp read distinct banks.
constexpr int kStepRedPitch = kPCols + 8;

// Floats of a ring slot at R rows a thread and KC columns: the block's rows
// of h (32 R rows of KC + 4), then KC rows of U's slice ([k][gate][unit]).
__host__ __device__ constexpr int step_slot_floats(int R, int KC) {
  return kPRowGroups * R * f32_pitch(KC) + KC * kPCols;
}

// Dynamic shared memory of a block at `rows` batch rows with a ring of
// `stages` slots of KC columns (mirrored by ops/cuda_cell_tiled.py:
// step_f32_smem_bytes): the ring, whose memory the splits' partial sums
// reuse after the products.
inline size_t step_f32_smem_bytes(int rows, int KC, int stages) {
  const int R = f32_rows_per_thread(rows);
  const size_t ring = (size_t)stages * step_slot_floats(R, KC);
  const size_t red = (size_t)kPSplit * kPRowGroups * R * kStepRedPitch;
  return sizeof(float) * (ring > red ? ring : red);
}

// One step, the grid (nd / kPUnits, ceil(B / rows)): the block's kPUnits
// units j0.. of the shard and `rows` batch rows b0...
template <int R, int KC, int STAGES>
__global__ void __launch_bounds__(kPThreads, 1)
tp_step_fwd_f32(const float* __restrict__ U,     // (N, 4nd)
                const float* __restrict__ xw,    // (B, 4nd), the bias folded in
                const float* __restrict__ h,     // (B, N), the full h_{t-1}
                const float* __restrict__ c_in,  // (B, nd)
                float* __restrict__ h_out, float* __restrict__ c_out,
                float* __restrict__ g_out,       // (B, 4nd)
                int B, int N, int nd, int rows, int standard) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = f32_pitch(KC);
  constexpr int RR = 2 * R;                 // product rows of a thread
  constexpr int hslot = kPRowGroups * R * P;
  constexpr int slot = step_slot_floats(R, KC);
  static_assert(KC % (kPSplit * kPSplitK) == 0, "a slot holds whole 32-k blocks");
  float* ring = reinterpret_cast<float*>(smem);   // STAGES x [h rows | U rows]
  float* red = ring;                              // [split][32 R][kStepRedPitch]
  const int tid = threadIdx.x;
  // the product: split s = tid / 64 takes k s * 8.. of each 32; its thread
  // (pg, pq) = (tid % 4, tid % 64 / 4) gate pg of the 8 units, rows pq +
  // 16 i, i < 2R
  const int split = tid / 64, pg = tid % 4, pq = tid % 64 / 4;
  // the epilogue: thread (u, q) = (tid % 8, tid / 8) owns unit j0 + u of
  // rows b0 + q + 32 i, i < R
  const int u = tid % kPUnits, q = tid / kPUnits;
  const int j0 = blockIdx.x * kPUnits, b0 = blockIdx.y * rows;
  const int j = j0 + u;
  const int nrows = min(rows, B - b0);      // the block's rows in the batch
  const size_t n4 = 4 * (size_t)nd;

  // the epilogue's inputs, issued before the products so that they hide
  float pin[R][4], cp[R];
  const auto valid = [&](int i) { return q + kPRowGroups * i < nrows; };
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!valid(i)) continue;
    const size_t b = b0 + q + kPRowGroups * i;
#pragma unroll
    for (int g = 0; g < 4; ++g) pin[i][g] = xw[b * n4 + (size_t)g * nd + j];
    cp[i] = c_in[b * nd + j];
  }

  // chunk ch: columns ch * KC.. of the block's rows of h, and rows ch *
  // KC.. of U's slice, 16 bytes a copy (U's gate segment of 8 units is 32
  // bytes of a row)
  const auto load_chunk = [&](int ch) {
    float* st = ring + (size_t)(ch % STAGES) * slot;
    for (int e = tid; e < nrows * (KC / 4); e += kPThreads) {
      const int r = e / (KC / 4), p = e % (KC / 4);
      cp_async_16(st + r * P + 4 * p, h + (size_t)(b0 + r) * N + ch * KC + 4 * p, 16);
    }
    float* us = st + hslot;
    for (int e = tid; e < KC * 8; e += kPThreads) {
      const int k = e / 8, g = e / 2 % 4, hh = e % 2;
      cp_async_16(us + k * kPCols + g * kPUnits + 4 * hh,
                  U + (size_t)(ch * KC + k) * n4 + (size_t)g * nd + j0 + 4 * hh, 16);
    }
  };
  // acc[i][y]: row pq + 16 i, gate pg of unit y
  float acc[RR][8];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[i][y] = 0.0f;
  const int nchunks = N / KC;
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
    const float* st = ring + (size_t)(ch % STAGES) * slot;
    const float* hs = st + pq * P + split * kPSplitK;
    const float* ub = st + hslot + split * kPSplitK * kPCols + kPUnits * pg;
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
    float* dst = red + ((size_t)split * kPRowGroups * R + pq + 16 * i) * kStepRedPitch +
                 kPUnits * pg;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!valid(i)) continue;
    const int r = q + kPRowGroups * i, b = b0 + r;
    constexpr size_t sp = (size_t)kPRowGroups * R * kStepRedPitch;   // a split's partials
    const float* row = red + (size_t)r * kStepRedPitch + u;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* p = row + g * kPUnits;
      const float sum = ((p[0] + p[sp]) + p[2 * sp]) + p[3 * sp];
      // acc + xw, as K15's window and K13's other designs sum
      const float s = sum + pin[i][g];
      gate[g] = g < 3 ? sigmoid(s) : tanhf(s);
    }
    const size_t idx = (size_t)b * nd + j;
    float hv, cv;
    cell(gate, cp[i], standard, &hv, &cv);
    h_out[idx] = hv;
    c_out[idx] = cv;
#pragma unroll
    for (int g = 0; g < 4; ++g) g_out[(size_t)b * n4 + (size_t)g * nd + j] = gate[g];
  }
}

template <int R, int KC, int STAGES>
int run_step_fwd_f32(const float* U, const float* xw, const float* h,
                     const float* c_in, float* h_out, float* c_out, float* g_out,
                     int B, int N, int nd, int rows, int standard,
                     cudaStream_t stream) {
  if (N % KC != 0 || nd % kPUnits != 0 || rows < 1 || rows > kPRowGroups * R)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = step_f32_smem_bytes(rows, KC, STAGES);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(tp_step_fwd_f32<R, KC, STAGES>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nd / kPUnits, (B + rows - 1) / rows);
  tp_step_fwd_f32<R, KC, STAGES><<<grid, kPThreads, smem, stream>>>(
      U, xw, h, c_in, h_out, c_out, g_out, B, N, nd, rows, standard);
  return static_cast<int>(cudaGetLastError());
}

// The ring layouts the library is built for: (rows a thread, KC, stages),
// as ops/cuda_cell_tiled.py:STEP_F32_RINGS lists them.
#define STEP_F32_LAYOUTS(X) X(1, 128, 4) X(1, 32, 4) X(2, 64, 4) X(2, 32, 4) \
  X(4, 64, 4) X(4, 32, 4)

}  // namespace

// K13 under fp32 compute (ops/cuda_tp_cell.py:tp_step_plan gives rows a
// block and the ring (R, kc, stages); R = 1, 2 or 4 for rows <= 32, 64,
// 128): U (N, 4nd), xw (B, 4nd), h (B, N), c_in (B, nd), all fp32 and
// 16-byte aligned; out h2, c2 (B, nd) and g (B, 4nd) in fp32. N a multiple
// of kc, nd of 8, 1 <= B <= 128. One launch, added to *launches.
extern "C" int tp_step_fwd_f32_launch(const void* U, const void* xw, const void* h,
                                      const void* c_in, void* h_out, void* c_out,
                                      void* g_out, int B, int N, int nd,
                                      int standard, int rows, int R, int kc,
                                      int stages, void* stream, int* launches) {
  if (B < 1 || B > kPRowGroups * 4 || R != f32_rows_per_thread(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [&](auto run) {
    return run(static_cast<const float*>(U), static_cast<const float*>(xw),
               static_cast<const float*>(h), static_cast<const float*>(c_in),
               static_cast<float*>(h_out), static_cast<float*>(c_out),
               static_cast<float*>(g_out), B, N, nd, rows, standard,
               static_cast<cudaStream_t>(stream));
  };
  int err = static_cast<int>(cudaErrorInvalidValue);
#define STEP_F32_CASE(r, k, st) \
  if (R == r && kc == k && stages == st) err = f(run_step_fwd_f32<r, k, st>);
  STEP_F32_LAYOUTS(STEP_F32_CASE)
#undef STEP_F32_CASE
  if (err == 0) ++*launches;
  return err;
}

// Bytes of dynamic shared memory a block of the fp32 K13 takes at `rows`
// batch rows with a ring of `stages` slots of kc columns.
extern "C" size_t tp_step_fwd_f32_smem_bytes(int rows, int kc, int stages) {
  return step_f32_smem_bytes(rows, kc, stages);
}
