// Fused text generation for Hopper (sm_90a): the whole `length`-token loop
// of every layer, the head and the draw in one cooperative launch, bound from
// Python through ctypes (eigen_lstm_tpu_torch/ops/cuda_sampler.py). No
// PyTorch headers.
//
// Replaces _gen_kernel of eigen_lstm_tpu/ops/pallas_sampler.py. For each
// token t of the call, with ch the previous token (the caller's `first` at
// t = 0) and the state (h, c) held in fp32:
//   layer l: g = round([x_l, h_l]) @ [W_l; U_l] + b_l, x_0 = one-hot(ch),
//            x_l = h_{l-1} of this token; sums in fp32, b in fp32; sigma on
//            i, o, f and tanh on u; the cell update of _cell_fwd
//            ("reference" carries tanh(c_raw), "standard" c_raw);
//   head:    logits = round(h_{L-1}) @ Why + by, by in fp32;
//   draw:    the first argmax of logits (T = 0) or of logits * inv_t +
//            gumbel, gumbel = -log(-log(max(u, 1e-7))), u = (bits >> 8) *
//            2^-24, bits = fmix32((b * M + v) * 0x85EBCA6B ^ base),
//            base = fmix32(seed ^ t * 0x9E3779B9) in wrapping uint32, b the
//            stream's row, v the byte, t counted from 0 within the call.
// round() is the compute type (bf16 or fp32). Layer 0's one-hot product is
// the row W_0[ch], added to its sums as (acc + W_0[ch]) + b.
//
// What bounds it on the H100: a token reads every layer's [W; U] and Why,
// 22.3 M elements for the 3 x 1024 flagship (44.6 MB in bf16; 89.1 MB in
// fp32, more than the SMs' shared memory and L2 hold: sampler_f32.cu's
// notes), and does
// 42.5 MFLOP per stream (layer 0's one-hot rows are a gather, no product).
// A call of n tokens needs the weights once and n * B * 42.5 MFLOP: bound
// by its operations (about 43 us for 1000 tokens at B = 1 at the bf16
// tensor-core peak). A design that reads the weights from memory at every
// token pays at least 44.6 MB / 3.35 TB/s = 13.3 us a token. The tokens
// form one chain (layer 0 of token t + 1 needs token t's draw), so a token
// is L + 1 dependent products at least, each ended by a grid barrier.
//
// Two designs (ops/cuda_sampler.py:gen_plan chooses, before the launch):
//
// The persistent design (gen_persist, sampler.cuh: B <= 128, N a multiple
// of 64, at most 8 layers, every phase's tiles within the SMs), in both
// compute types: each block owns fixed tiles of every layer and of the
// head for the call and holds as many of their weight rows in shared
// memory as fit, L + 1 grid barriers a token, the draw folded into layer
// 0's blocks (sampler.cuh's notes). This file builds its bf16 products,
// sampler_f32.cu its fp32 ones:
//   mma   (bf16, B >= 2, and B = 1 where gen_plan takes it): the
//         tensor-core step of fwd_mma.cuh (fwd_products: 16 units, a
//         cp.async ring of 64-row chunks, mma.sync m16n8k16, fp32 sums;
//         below 16 rows the m tile is masked), the epilogue in the owner
//         lanes' registers;
//   gemv  (B = 1): 8 units a tile (sampler.cuh:GemvProduct); the block
//         loads round(x) whole into shared memory, each thread takes one
//         gate's 8 units (16 bytes of a bf16 row) of every 64th k row,
//         resident rows from shared memory, the rest with 16-byte loads,
//         fp32 FMAs; the sums meet by warp shuffles and then across the
//         warps in a fixed order.
//
// The first design (gen_kernel: the shapes the plan refuses, in either
// type). One cooperative launch, a grid of at most two blocks a SM, all
// resident; the phases of a token are separated by grid barriers:
//   A_l  product items: (32 hidden units j, 256-row k chunk, BT batch rows).
//        A block's 8 warps split the chunk's rows; each lane owns unit j in
//        all four gates (columns j, N+j, 2N+j, 3N+j), reading [W; U] rows
//        coalesced; the warps meet in shared memory and the item stores
//        its fp32 partial sums. Layer 0 multiplies only its U rows: the
//        one-hot row of W is added in B_0, as the one-hot product adds it.
//   B_l  epilogue, one thread per (b, j): the chunks' partials summed in a
//        fixed order, W_0[ch] for layer 0, then b, the gates and the cell.
//   A_h  the head's product items, as A_l with one gate of M columns.
//   D    one warp per stream: the partials summed, by, the Gumbel noise,
//        the first argmax by a warp reduction; writes ids[t] and ch. D of
//        token t shares its phase with A_0 of token t+1, which reads only h.
// That makes 2L + 1 barriers a token, the weights streamed from L2 and
// memory at every token, on CUDA cores. The state, the partials and ch
// live in device memory between phases.

#include <cooperative_groups.h>

#include "common.cuh"
#include "fwd_mma.cuh"
#include "sampler.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGLanes = 32;   // units (columns of a gate) per item
constexpr int kGWarps = 8;    // warps splitting an item's k chunk
constexpr int kGThreads = kGLanes * kGWarps;
constexpr int kChunk = 256;   // k rows per item
constexpr int kBlocksPerSM = 2;

__host__ __device__ inline int chunks_of(int K) { return (K + kChunk - 1) / kChunk; }

struct Gen {
  const void* WU;     // layers' [W; U] in the compute type, one after another:
                      // layer 0 (M + N, 4N), layers >= 1 (2N, 4N)
  const float* bias;  // (L, 4N)
  const void* Why;    // (N, M) in the compute type
  const float* by;    // (M,)
  float* h;           // (L, B, N) state, updated in place
  float* c;           // (L, B, N)
  int* ch;            // (B,) the previous token
  int* ids;           // (length, B)
  float* part;        // (chunks(2N), B, 4N) partial sums of a layer
  float* hpart;       // (chunks(N), B, M) partial sums of the head
  float* trace_h;     // (length, L, B, N) state after each token, or null
  float* trace_c;
  int L, B, N, M, length, standard, greedy;
  unsigned seed;
  float inv_t;
};

// Partial sums of one product: for every item (column group of 32 units,
// k chunk kc, BT batch rows),
//   out[kc][b][g * width + j] = sum_{k in chunk kc} round(x[b][k]) * Wt[k][g * width + j]
// for g < G, where row k of x is x0[b][k] for k < split, else
// x1[b][k - split] (both with row stride N). Columns j >= width are masked.
template <typename CT, int BT, int G>
__device__ void product(const CT* __restrict__ Wt, int K, int width,
                        const float* x0, int split, const float* x1, int N,
                        int B, float* out, float (&hs)[BT][kChunk],
                        float (&red)[kGWarps][BT][kGLanes]) {
  const int lane = threadIdx.x, w = threadIdx.y;
  const int groups = (width + kGLanes - 1) / kGLanes;
  const int chunks = chunks_of(K);
  const int tiles = (B + BT - 1) / BT;
  const int items = groups * chunks * tiles;
  const size_t ld = (size_t)G * width;
  // batch tiles vary fastest: the blocks that read a slice of the weights
  // run side by side, so the slice is read from memory once and from L2
  // by the others
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b0 = item % tiles * BT;
    const int jg = item / tiles % groups, kc = item / (tiles * groups);
    const int k0 = kc * kChunk, klen = min(kChunk, K - k0);
    __syncthreads();  // the previous item's readers of hs and red are done
    for (int e = w * kGLanes + lane; e < BT * klen; e += kGThreads) {
      const int r = e / klen, k = k0 + e % klen, b = b0 + r;
      float v = 0.0f;
      if (b < B) v = k < split ? x0[(size_t)b * N + k] : x1[(size_t)b * N + k - split];
      hs[r][e % klen] = round_to<CT>(v);
    }
    __syncthreads();
    const int j = jg * kGLanes + lane;
    const bool jok = j < width;
    float acc[G][BT];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[g][r] = 0.0f;
#pragma unroll 4
    for (int kk = w; kk < klen; kk += kGWarps) {
      const CT* wrow = Wt + (size_t)(k0 + kk) * ld + j;
      float wv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) wv[g] = jok ? to_f32(wrow[(size_t)g * width]) : 0.0f;
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float hv = hs[r][kk];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][r] = fmaf(hv, wv[g], acc[g][r]);
      }
    }
    // the warps' sums, one gate at a time, added in warp order
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < BT; ++r) red[w][r][lane] = acc[g][r];
      __syncthreads();
      for (int r = w; r < BT; r += kGWarps) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < kGWarps; ++q) s += red[q][r][lane];
        const int b = b0 + r;
        if (b < B && jok) out[((size_t)kc * B + b) * ld + (size_t)g * width + j] = s;
      }
      __syncthreads();
    }
  }
}

// B_l: the gates and the cell update of layer l from the partial sums.
template <typename CT>
__device__ void epilogue(const Gen& p, int l, int t) {
  const int N = p.N, B = p.B;
  const size_t n4 = 4 * (size_t)N;
  const int chunks = chunks_of(l == 0 ? N : 2 * N);
  const CT* W0 = static_cast<const CT*>(p.WU);  // rows [0, M) of layer 0
  const float* bias = p.bias + l * n4;
  const int tid = threadIdx.y * kGLanes + threadIdx.x;
  for (size_t e = (size_t)blockIdx.x * kGThreads + tid; e < (size_t)B * N;
       e += (size_t)gridDim.x * kGThreads) {
    const int b = static_cast<int>(e / N), j = static_cast<int>(e % N);
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const size_t col = (size_t)g * N + j;
      float s = 0.0f;
      for (int kc = 0; kc < chunks; ++kc) s += p.part[((size_t)kc * B + b) * n4 + col];
      if (l == 0) s += to_f32(W0[(size_t)p.ch[b] * n4 + col]);
      s += bias[col];
      gate[g] = g < 3 ? sigmoid(s) : tanhf(s);
    }
    const size_t idx = ((size_t)l * B + b) * N + j;
    float h, c;
    cell(gate, p.c[idx], p.standard, &h, &c);
    p.h[idx] = h;
    p.c[idx] = c;
    if (p.trace_h != nullptr) {
      const size_t at = (size_t)t * p.L * B * N + idx;
      p.trace_h[at] = h;
      p.trace_c[at] = c;
    }
  }
}

// D: token t of every stream, one warp a stream.
__device__ void draw(const Gen& p, int t) {
  const int lane = threadIdx.x, M = p.M, B = p.B;
  const int chunks = chunks_of(p.N);
  const unsigned base = gen_base(p.seed, t);
  for (int b = blockIdx.x * kGWarps + threadIdx.y; b < B; b += gridDim.x * kGWarps) {
    float best = 0.0f;
    int arg = -1;  // none yet
    for (int v = lane; v < M; v += kGLanes) {
      float s = 0.0f;
      for (int kc = 0; kc < chunks; ++kc) s += p.hpart[((size_t)kc * B + b) * M + v];
      s = gen_score(__fadd_rn(s, p.by[v]), b, v, M, base, p.inv_t, p.greedy);
      if (arg < 0 || s > best) {  // ascending v: the first maximum stays
        best = s;
        arg = v;
      }
    }
    arg = warp_first_argmax(best, arg);
    if (lane == 0) {
      p.ids[(size_t)t * B + b] = arg;
      p.ch[b] = arg;
    }
  }
}

// Launch bounds, measured on the H100 (PERF.md): at BT = 1 two blocks a SM
// lets the compiler use up to 128 registers (64 with no minimum), 6 %
// faster in bf16. At BT = 16 no minimum (0) keeps the compiler's own 128:
// a minimum of two spilled more and ran 6-10 % slower, a minimum of one
// took 147 registers, so one block a SM, and ran 45 % slower.
template <typename CT, int BT>
__global__ void __launch_bounds__(kGThreads, BT == 1 ? kBlocksPerSM : 0)
    gen_kernel(Gen p) {
  __shared__ float hs[BT][kChunk];
  __shared__ float red[kGWarps][BT][kGLanes];
  cg::grid_group grid = cg::this_grid();
  const int N = p.N, M = p.M, B = p.B;
  const size_t n4 = 4 * (size_t)N, bn = (size_t)B * N;
  const CT* WU = static_cast<const CT*>(p.WU);
  const CT* Why = static_cast<const CT*>(p.Why);
  for (int t = 0; t < p.length; ++t) {
    if (t > 0) draw(p, t - 1);
    for (int l = 0; l < p.L; ++l) {
      if (l == 0) {  // the U rows of layer 0, after its M rows of W
        product<CT, BT, 4>(WU + (size_t)M * n4, N, N, p.h, N, nullptr, N, B,
                           p.part, hs, red);
      } else {
        const CT* Wl = WU + (size_t)(M + N) * n4 + (size_t)(l - 1) * 2 * N * n4;
        product<CT, BT, 4>(Wl, 2 * N, N, p.h + (l - 1) * bn, N, p.h + l * bn,
                           N, B, p.part, hs, red);
      }
      grid.sync();
      epilogue<CT>(p, l, t);
      grid.sync();
    }
    product<CT, BT, 1>(Why, N, M, p.h + (p.L - 1) * bn, N, nullptr, N, B,
                       p.hpart, hs, red);
    grid.sync();
  }
  draw(p, p.length - 1);
}

template <typename CT, int BT>
int run_gen(const Gen& p, cudaStream_t stream) {
  const auto kernel = gen_kernel<CT, BT>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  // every block must be resident at once, or a grid barrier never opens
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM));
  const dim3 block(kGLanes, kGWarps);
  Gen arg = p;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                    block, args, 0, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

template <typename CT>
int run_gen_bt(const Gen& p, cudaStream_t stream) {
  // batch rows per item: enough to reuse each weight read over the batch,
  // and B = 1 (the CLI's sample) multiplies no zero rows
  if (p.B == 1) return run_gen<CT, 1>(p, stream);
  return run_gen<CT, 16>(p, stream);
}

// ---------------------------------------------------------------------------
// The persistent design's tensor-core product (bf16, module comment):
// fwd_mma.cuh's step on the item's 16 units x 4 gates and rows, the
// resident rows [k][gate][unit] with fwd_products' padded pitch.
struct MmaProduct {
  static constexpr int kUnits = kFUnits;
  static constexpr int kPitch = kFUPitch;

  // the ring of the larger of rows and hrows
  static size_t scratch_bytes(int rows, int hrows, int) {
    const size_t a = fwd_smem_bytes(rows, 0), b = fwd_smem_bytes(hrows, 0);
    return a > b ? a : b;
  }

  static __device__ __forceinline__ void hold(const GenPersist<__nv_bfloat16>& p,
                                              const GenItem<__nv_bfloat16>& it,
                                              __nv_bfloat16* dst, int n) {
    const FwdTile f = fwd_mma_tile(it.K, it.gs, it.j0, it.b0, p.B, it.rows);
    for (int e = threadIdx.x; e < n * 8; e += kFThreads)
      fwd_u_copy(f, it.W, dst + (size_t)(e / 8) * kFUPitch, e / 8, e % 8);
  }

  template <typename Emit>
  static __device__ __forceinline__ void run(const GenPersist<__nv_bfloat16>& p,
                                             const GenItem<__nv_bfloat16>& it,
                                             const __nv_bfloat16* x,
                                             const __nv_bfloat16* Ur, int cres,
                                             unsigned char* scratch, Emit emit) {
    const FwdTile f = fwd_mma_tile(it.K, it.gs, it.j0, it.b0, p.B, it.rows);
    float acc[8][4];
    fwd_products(f, it.W, x, Ur, cres, reinterpret_cast<__nv_bfloat16*>(scratch), acc);
    if (!f.owner) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = fwd_row(f, hh);
      if (b >= p.B) continue;
#pragma unroll
      for (int uh = 0; uh < 2; ++uh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s[4] = {acc[uh][2 * hh + e], acc[2 + uh][2 * hh + e],
                              acc[4 + uh][2 * hh + e], acc[6 + uh][2 * hh + e]};
          emit(b, fwd_unit(f, uh, e), s);
        }
    }
  }
};

}  // namespace

// fp32 scratch floats gen_launch needs: the layer and the head partials.
extern "C" size_t gen_work_floats(int B, int N, int M) {
  return (size_t)chunks_of(2 * N) * B * 4 * N + (size_t)chunks_of(N) * B * M;
}

// Type code 0 = fp32, 1 = bf16: the type of WU and Why. bias, by, h, c and
// the traces are fp32; ch, ids int32. h, c and ch hold the initial state and
// first token and are updated in place. trace_h/trace_c, both null or both
// set, receive the state after every token. seed: the int32 seed's bits.
// Requires N % 32 == 0, M <= 256, B >= 1, length >= 1. One launch.
extern "C" int gen_launch(int ctype, const void* WU, const void* bias,
                          const void* Why, const void* by, void* h, void* c,
                          void* ch, void* ids, void* work, void* trace_h,
                          void* trace_c, int L, int B, int N, int M,
                          int length, int standard, int greedy, unsigned seed,
                          float inv_t, void* stream) {
  if (N % kGLanes != 0 || M > 256 || M < 1 || B < 1 || L < 1 || length < 1 ||
      (trace_h == nullptr) != (trace_c == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(work);
  const Gen p{WU, static_cast<const float*>(bias), Why,
              static_cast<const float*>(by), static_cast<float*>(h),
              static_cast<float*>(c), static_cast<int*>(ch),
              static_cast<int*>(ids), part,
              part + (size_t)chunks_of(2 * N) * B * 4 * N,
              static_cast<float*>(trace_h), static_cast<float*>(trace_c), L, B,
              N, M, length, standard, greedy, seed, inv_t};
  const auto s = static_cast<cudaStream_t>(stream);
  if (ctype == 0) return run_gen_bt<float>(p, s);
  if (ctype == 1) return run_gen_bt<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of the persistent design's dynamic shared memory in bf16
// (sampler.cuh:gen_smem_bytes; mma 1: the tensor-core product, 0: gemv).
extern "C" size_t gen_persist_smem_bytes(int mma, int rows, int hrows, int N,
                                         int budget) {
  using bf = __nv_bfloat16;
  return mma ? gen_smem_bytes<bf, MmaProduct>(rows, hrows, N, budget)
             : gen_smem_bytes<bf, GemvProduct<bf>>(rows, hrows, N, budget);
}

// Bytes of the persistent design's work buffer in bf16: the scores (B, M)
// fp32, then the products' inputs, two bf16 slots of (B, gen_K) a phase.
extern "C" size_t gen_persist_work_bytes(int B, int N, int M, int L) {
  return gen_work_bytes<__nv_bfloat16>(B, N, M, L);
}

// The persistent design in bf16: WU and Why bf16, the rest as gen_launch;
// `first` (B,) int32 is read only; h and c hold h0 and c0 and receive hT
// and cT. The layout (ops/cuda_sampler.py:gen_plan): mma (1: the
// tensor-core product, 16 units a tile; 0: gemv, 8 units, B = 1), rows and
// hrows (batch rows of a layer and a head item: B, or a multiple of 16),
// budget (weight rows a block holds, a multiple of 64), grid (blocks, all
// resident, each phase at most one item a block). Refuses any other layout
// with cudaErrorInvalidValue. One launch, added to *launched.
extern "C" int gen_persist_launch(const void* WU, const void* bias, const void* Why,
                                  const void* by, const void* first, void* h,
                                  void* c, void* ids, void* work,
                                  void* trace_h, void* trace_c, int L, int B,
                                  int N, int M, int length, int standard,
                                  int greedy, unsigned seed, float inv_t,
                                  int mma, int rows, int hrows, int budget,
                                  int grid, void* stream,
                                  int* launched) {
  const auto rows_ok = [&](int r) {
    return mma ? r >= 1 && r <= kFMaxRows && (r >= B || r % 16 == 0) : r == 1;
  };
  if ((mma != 0 && mma != 1) || (!mma && B != 1) ||
      !gen_layout_ok(L, B, N, M, length, (trace_h == nullptr) == (trace_c == nullptr),
                     mma ? kFUnits : kGVUnits, rows_ok, rows, hrows, budget, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const GenPersist<bf> p = gen_args<bf>(WU, nullptr, bias, Why, by, first, h, c,
                                        ids, work, trace_h, trace_c, L, B, N, M,
                                        length, standard, greedy, seed, inv_t,
                                        rows, hrows, budget);
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = mma ? run_gen_persist<bf, MmaProduct>(p, grid, s)
                      : run_gen_persist<bf, GemvProduct<bf>>(p, grid, s);
  if (err == 0) ++*launched;
  return err;
}
