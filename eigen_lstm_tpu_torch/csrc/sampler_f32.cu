// K7's persistent design under fp32 compute for Hopper (sm_90a): the fp32
// products of sampler.cuh's gen_persist and their C launchers, bound from
// Python through ctypes (eigen_lstm_tpu_torch/ops/cuda_sampler.py). No
// PyTorch headers. Replaces pallas_sampler.py:_gen_kernel (:37) under fp32
// compute wherever ops/cuda_sampler.py:gen_plan gives a layout (B <= 128, N
// a multiple of 64, M of 32, at most 8 layers, every phase's tiles within
// the SMs); elsewhere the first design (sampler.cu:gen_kernel) runs. TF32
// stays off: fp32 products never go to the tensor cores, so both products
// here are FFMAs on CUDA cores. The phases, tiles, slots, draw and
// barriers are sampler.cuh's, as in bf16; the inputs' slots hold h in fp32.
//
//   gemv  (B = 1, the CLI's sample): sampler.cuh's GemvProduct<float>, 8
//         units a tile, a row of the tile 128 bytes (two 16-byte loads a
//         thread and row).
//   ffma  (B = 2..128): the product of K8's fp32 forward
//         (lstm_tiled_f32.cuh) on the tile of 8 units x 4 gates and the
//         item's rows: a cp.async ring of 32-row chunks (the item's rows of
//         h and, past the resident rows, the weights' rows), the chunk's k
//         split 4 ways over the warps (split s the k with (k mod 32) / 8 =
//         s, ascending), a thread a register tile of 2R rows by 8 columns
//         (one gate's 8 units), the splits' partial sums added in split
//         order by the owner of each (row, unit).
//
// Where the weights live (the flagship, 3 x 1024, M = 256): a token's
// weights are 22.28 M fp32 elements, 89.1 MB, of which layer 0's W rows are
// a gather (a token reads 84.9 MB). A block holds 1728 rows of 128 bytes
// at B = 1 (1280 at B = 128, beside the ring): 221 KB a block, 29.2 MB over
// 132 blocks, in phase order (layer 0's tiles whole, then the first 704 of
// each layer-1 tile's 2048 rows). The other ~55.7 MB (the rest of layer 1,
// layer 2 and the head) stream at every token, more than the 50 MB L2, so
// most of it comes from device memory. The products read them from Wt,
// every phase's rows packed tile by tile per call (ops/cuda_sampler.py:
// tile_weights, a copy of 85 MB): a block streams one contiguous span of
// 128-byte rows, where W's own rows would give it 32 bytes of each gate
// row, 16 KB apart (1.7x slower at B = 1 on the H100; PERF.md §6 row 11,
// scripts/k7_fp32_layout_ab.py). WU's W_0 rows stay for the gather. The
// gemv loads the rows of a phase its block holds none of (at B = 1 layer
// 2's and the head's) first-to-evict from L2 (sampler.cuh), so that layer
// 1's streamed 22 MB stay in L2 from token to token and ~34 MB come from
// device memory a token (1.2x faster at B = 1 on the H100, PERF.md).
//
// What bounds it on the H100: at B = 1 the streamed bytes, ~16.6 us a token
// at 3.35 TB/s, against 0.63 us of operations; at B = 128 the product's
// 5.44 GFLOP a token at 67 TFLOP/s (81 us), the ring's shared loads as
// busy as its FFMAs, as in K8's fp32 forward, and every block reading its
// rows of h from L2 at every phase.

#include "sampler.cuh"

namespace {

constexpr int kGFKC = 32;       // k rows of a ring chunk
constexpr int kGFStages = 3;
constexpr int kGFSplit = 4;     // ways a chunk's k splits
constexpr int kGFSplitK = 8;    // k of each 32 that a split takes
constexpr int kGFPitch = kGFKC + 4;   // floats of a ring row of h

// The FFMA product (module comment) for items of at most 32 R rows. A ring
// slot: 32 R rows of h by kGFKC columns (pitch kGFPitch), then kGFKC rows
// of the tile's weights [k][gate][unit] (used past the resident rows). The
// splits' partial sums [split][32 R rows][gate][unit] reuse the ring.
template <int R>
struct FfmaProduct {
  static constexpr int kUnits = kGVUnits;
  static constexpr int kPitch = kGVPitch;
  static constexpr int kRows = 32 * R;
  static constexpr int kSlot = kRows * kGFPitch + kGFKC * kGVPitch;   // floats

  static size_t scratch_bytes(int, int, int) {
    const size_t ring = (size_t)kGFStages * kSlot * 4;
    const size_t red = (size_t)kGFSplit * kRows * kGVPitch * 4;
    return ring > red ? ring : red;
  }

  static __device__ __forceinline__ void hold(const GenPersist<float>&,
                                              const GenItem<float>& it, float* dst,
                                              int n) {
    gen_hold_gate_rows(it, dst, n);
  }

  template <typename Emit>
  static __device__ __forceinline__ void run(const GenPersist<float>& p,
                                             const GenItem<float>& it,
                                             const float* x, const float* Us,
                                             int cres, unsigned char* scratch,
                                             Emit emit) {
    float* ring = reinterpret_cast<float*>(scratch);
    float* red = ring;
    const int tid = threadIdx.x;
    // the product: split s = tid / 64; thread (pu, pq) = (tid % 4, tid % 64
    // / 4) gate pu's 8 units of rows pq + 16 i, i < ni (the 16-row groups
    // the item's rows reach; ni <= 2R)
    const int split = tid / 64, pu = tid % 4, pq = tid % 64 / 4;
    const int nrows = min(it.rows, p.B - it.b0);
    const int ni = (nrows + 15) / 16;
    const int kres = cres * kFKC, nchunks = it.K / kGFKC;
    // chunk ch: h's columns ch * kGFKC.. of the item's rows (written in the
    // launch: L2 only), and the weights' rows where they are not resident
    const auto load_chunk = [&](int ch) {
      float* st = ring + (size_t)(ch % kGFStages) * kSlot;
      for (int e = tid; e < nrows * (kGFKC / 4); e += kFThreads) {
        const int r = e / (kGFKC / 4), q = e % (kGFKC / 4);
        cp_async_16(st + r * kGFPitch + 4 * q,
                    x + (size_t)(it.b0 + r) * it.K + ch * kGFKC + 4 * q, 16);
      }
      if (ch * kGFKC >= kres) {
        float* wst = st + kRows * kGFPitch;
        for (int e = tid; e < kGFKC * 8; e += kFThreads) {
          const int k = e / 8, g = e % 8 / 2, q = e % 2;
          cp_async_16(wst + k * kGVPitch + g * kGVUnits + 4 * q,
                      it.wt + (size_t)(ch * kGFKC + k) * it.rs + (size_t)g * it.gst + 4 * q,
                      16);
        }
      }
    };
    // acc[i][u]: row pq + 16 i, gate pu, unit u
    float acc[2 * R][kGVUnits];
#pragma unroll
    for (int i = 0; i < 2 * R; ++i)
#pragma unroll
      for (int u = 0; u < kGVUnits; ++u) acc[i][u] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < kGFStages - 1; ++ch) {
      if (ch < nchunks) load_chunk(ch);
      cp_async_commit();
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      cp_async_wait<kGFStages - 2>();
      __syncthreads();  // chunk ch is in, and chunk ch - 1's slot is free
      if (ch + kGFStages - 1 < nchunks) load_chunk(ch + kGFStages - 1);
      cp_async_commit();
      const float* st = ring + (size_t)(ch % kGFStages) * kSlot;
      const float* hs = st + pq * kGFPitch + split * kGFSplitK;
      const float* wb = (ch * kGFKC < kres ? Us + (size_t)ch * kGFKC * kGVPitch
                                           : st + kRows * kGFPitch) +
                        split * kGFSplitK * kGVPitch + pu * kGVUnits;
#pragma unroll
      for (int kk = 0; kk < kGFSplitK; kk += 4) {
        float4 hv[2 * R];
#pragma unroll
        for (int i = 0; i < 2 * R; ++i)
          if (i < ni) hv[i] = *reinterpret_cast<const float4*>(hs + i * 16 * kGFPitch + kk);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float w[8];
          w8_shared(wb + (kk + v) * kGVPitch, w);
#pragma unroll
          for (int i = 0; i < 2 * R; ++i) {
            if (i >= ni) continue;
            const float xv = v == 0 ? hv[i].x : v == 1 ? hv[i].y : v == 2 ? hv[i].z : hv[i].w;
#pragma unroll
            for (int u = 0; u < kGVUnits; ++u) acc[i][u] = fmaf(xv, w[u], acc[i][u]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: reuse it as red
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
      if (i >= ni) continue;
      float* dst = red + ((size_t)split * kRows + pq + 16 * i) * kGVPitch + pu * kGVUnits;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    // thread (u, q) = (tid % 8, tid / 8) owns unit j0 + u of rows q + 32 i,
    // the splits' sums added in split order
    const int u = tid % kGVUnits, q = tid / kGVUnits;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q + 32 * i;
      if (r >= nrows) continue;
      float s[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* v = red + (size_t)r * kGVPitch + g * kGVUnits + u;
        const size_t sp = (size_t)kRows * kGVPitch;
        s[g] = ((v[0] + v[sp]) + v[2 * sp]) + v[3 * sp];
      }
      emit(it.b0 + r, it.j0 + u, s);
    }
  }
};

// R for items of at most `rows` batch rows: 1, 2 or 4 (32, 64, 128 rows).
inline int gen_f32_rows_per_thread(int rows) { return rows <= 32 ? 1 : rows <= 64 ? 2 : 4; }

template <typename F>
auto with_f32_product(int ffma, int rows, int hrows, F f) {
  const int r = gen_f32_rows_per_thread(rows > hrows ? rows : hrows);
  if (!ffma) return f(GemvProduct<float>{});
  if (r == 1) return f(FfmaProduct<1>{});
  if (r == 2) return f(FfmaProduct<2>{});
  return f(FfmaProduct<4>{});
}

}  // namespace

// Bytes of the persistent design's dynamic shared memory in fp32
// (sampler.cuh:gen_smem_bytes; ffma 1: the FFMA product at the rows a
// thread of max(rows, hrows) takes, 0: gemv).
extern "C" size_t gen_persist_f32_smem_bytes(int ffma, int rows, int hrows, int N,
                                             int budget) {
  return with_f32_product(ffma, rows, hrows, [&](auto prod) {
    return gen_smem_bytes<float, decltype(prod)>(rows, hrows, N, budget);
  });
}

// Bytes of the persistent design's work buffer in fp32: the scores (B, M),
// then the products' inputs, two fp32 slots of (B, gen_K) a phase.
extern "C" size_t gen_persist_f32_work_bytes(int B, int N, int M, int L) {
  return gen_work_bytes<float>(B, N, M, L);
}

// The persistent design in fp32: WU and Why fp32, the rest as
// gen_persist_launch (sampler.cu), and Wt: every phase's product rows (layer
// 0's U, the [W; U] of layers >= 1, Why) packed tile by tile, [phase][tile]
// [k][gate][unit] with 8 units a tile (ops/cuda_sampler.py:tile_weights),
// from which the products read; WU's first M rows stay the W_0 rows the
// cell gathers. A null Wt reads WU's and Why's rows in place, as the bf16
// design does (a block then streams 32 bytes of each of its gate rows, 16
// KB apart; scripts/k7_fp32_layout_ab.py times the two layouts). The
// layout (ops/cuda_sampler.py:gen_plan): ffma (1: the FFMA product, 0:
// gemv, B = 1), both 8 units a tile; rows and hrows (batch rows of a layer
// and a head item, 1 to 128; 1 for gemv), budget (weight rows a block
// holds, a multiple of 64), grid (blocks, all resident, each phase at most
// one item a block). Refuses any other layout with cudaErrorInvalidValue.
// One launch, added to *launched.
extern "C" int gen_persist_f32_launch(const void* WU, const void* Wt, const void* bias,
                                      const void* Why, const void* by,
                                      const void* first, void* h,
                                      void* c, void* ids, void* work,
                                      void* trace_h, void* trace_c, int L, int B,
                                      int N, int M, int length, int standard,
                                      int greedy, unsigned seed, float inv_t,
                                      int ffma, int rows, int hrows, int budget,
                                      int grid, void* stream,
                                      int* launched) {
  const auto rows_ok = [&](int r) { return ffma ? r >= 1 && r <= kGMaxRows : r == 1; };
  if ((ffma != 0 && ffma != 1) || (!ffma && B != 1) ||
      !gen_layout_ok(L, B, N, M, length, (trace_h == nullptr) == (trace_c == nullptr),
                     kGVUnits, rows_ok, rows, hrows, budget, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const GenPersist<float> p = gen_args<float>(WU, Wt, bias, Why, by, first, h, c,
                                              ids, work, trace_h, trace_c, L, B, N,
                                              M, length, standard, greedy, seed,
                                              inv_t, rows, hrows, budget);
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = with_f32_product(ffma, rows, hrows, [&](auto prod) {
    return run_gen_persist<float, decltype(prod)>(p, grid, s);
  });
  if (err == 0) ++*launched;
  return err;
}
