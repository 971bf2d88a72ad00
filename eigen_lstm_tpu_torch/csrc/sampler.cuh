// K7's persistent generation design for Hopper (sm_90a), shared by its two
// compute types: the bf16 products (sampler.cu) and the fp32 ones
// (sampler_f32.cu) plug into one kernel, gen_persist<CT, Product>. Also
// the draw, which the first design (sampler.cu:gen_kernel) shares. No
// PyTorch headers.
//
// Each block owns fixed output tiles for the whole call: in each layer a
// tile of Product::kUnits hidden units x 4 gates and `rows` batch rows, in
// the head 4 x kUnits of the M logits (gate stride M / 4) and `hrows` rows;
// the items of phase p go to blocks (offset_p + i) % grid, offset_p the
// items of the phases before, so every phase spreads over the SMs and a
// block has at most one item a phase (ops/cuda_sampler.py:block_phases
// mirrors it). At the start a block copies as many of its items' weight
// rows into shared memory as its budget holds, in phase order, whole
// chunks of kFKC rows, and keeps them for the call; the rest stream at
// every token. A block sums the whole k range of its columns, so the gates
// and the cell update run right after the product in the owners'
// registers, and a token takes L + 1 grid barriers (one a layer, one after
// the head), with no partial sums through device memory. The head writes
// each row's scores (logits, and with T > 0 the scaled logits plus the
// noise); a block with a layer-0 item draws its rows' tokens from them
// itself (the first argmax of M scores, a warp a row) at the next token,
// so the draw takes no barrier of its own, and the block of tile 0 writes
// ids. The products' inputs round([x_l, h_l]) live in the compute type CT
// in two slots a phase (token parity): layer l writes h_l(t) into its own
// next slot and into layer l + 1's (or the head's) current one. c stays in
// the fp32 c buffer, read and written only by the thread that owns the
// element. Buffers written in the launch (the inputs, the scores, c) are
// read through L2 only (cp.async.cg, __ldcg); the weights, which nothing
// writes, through the read-only path, from W itself or (fp32) from a copy
// of every phase's rows packed tile by tile (Wt; sampler_f32.cu's notes).
// The grid barrier is
// cg::grid_group::sync (it measured faster than a counter barrier on the
// H100, PERF.md §6 row 11). Every sum has a fixed order, so a call is
// deterministic.
//
// A Product gives kUnits, kPitch (elements of a resident weight row),
// scratch_bytes(rows, hrows, N) (the shared memory its run takes beside the
// resident rows), hold(p, it, dst, n) (starts the cp.async copies of the
// item's first n weight rows into dst, uncommitted) and run(p, it, x, Ur,
// cres, scratch, emit): the item's gate sums from the input x (B, K) and
// its weights (the first cres chunks from Ur, the rest streamed), handed
// to emit(b, j, s) for each of its (row, unit) with s the four gates'
// sums, by the thread that owns them. Every thread of the block calls run.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "fwd_mma.cuh"

namespace {

constexpr int kGWarpLanes = 32;
constexpr int kGMaxLayers = 8;
constexpr int kGMaxPhases = kGMaxLayers + 1;   // the layers and the head
constexpr int kGMaxRows = kFMaxRows;           // batch rows at most
constexpr int kGVUnits = 8;                    // units of a gemv (and fp32) tile
constexpr int kGVPitch = 4 * kGVUnits;         // elements a resident row, [gate][unit]
constexpr int kGVLanes = kFThreads / 4;        // k rows a gemv pass takes

// The draw's score of byte v of row b: the logit (T = 0), else logit *
// inv_t + gumbel, each step rounded: no contraction into an fma, as the TPU
// kernel rounds the product. base: gen_base of the step.
__device__ __forceinline__ unsigned gen_base(unsigned seed, int t) {
  return fmix32(seed ^ (static_cast<unsigned>(t) * 0x9E3779B9u));
}
__device__ __forceinline__ float gen_score(float logit, int b, int v, int M,
                                           unsigned base, float inv_t,
                                           int greedy) {
  if (greedy) return logit;
  const unsigned bits = fmix32(
      (static_cast<unsigned>(b) * static_cast<unsigned>(M) + v) * 0x85EBCA6Bu ^ base);
  const float u = fmaxf(static_cast<float>(bits >> 8) * (1.0f / 16777216.0f), 1e-7f);
  return __fadd_rn(__fmul_rn(logit, inv_t), -logf(-logf(u)));
}

// The first argmax across a warp from each lane's (best, arg) over its
// ascending bytes (arg -1: none): the largest score, the smallest index
// among equals, in every lane.
__device__ __forceinline__ int warp_first_argmax(float best, int arg) {
#pragma unroll
  for (int off = kGWarpLanes / 2; off > 0; off /= 2) {
    const float ob = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int oa = __shfl_xor_sync(0xFFFFFFFFu, arg, off);
    if (oa >= 0 && (arg < 0 || ob > best || (ob == best && oa < arg))) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
}

template <typename CT>
struct GenPersist {
  const CT* WU;              // layers' [W; U] in CT, one after another:
                             // layer 0 (M + N, 4N), layers >= 1 (2N, 4N)
  const float* bias;         // (L, 4N)
  const CT* Why;             // (N, M)
  // null, or every phase's product rows packed tile by tile (fp32):
  // [phase][tile][k][gate][unit], the rows of a tile contiguous
  const CT* Wt;
  const float* by;           // (M,)
  const int* first;          // (B,) the token before the call
  float* h;                  // (L, B, N): h0 in, hT out
  float* c;                  // (L, B, N): c0 in, cT out, updated every token
  int* ids;                  // (length, B)
  float* scores;             // (B, M) the last head's scores
  CT* xin;                   // the products' inputs: two slots a phase
  float* trace_h;            // (length, L, B, N) or null
  float* trace_c;
  int L, B, N, M, length, standard, greedy;
  unsigned seed;
  float inv_t;
  int rows, hrows;           // batch rows of a layer item, of a head item
  int budget;                // weight rows a block may hold (a multiple of kFKC)
  int scratch;               // bytes of the product's scratch after them
};

// Phase ph's contraction: N for layer 0 (its U rows) and the head (ph ==
// L), 2N for the layers in between ([x_l, h_l]).
__host__ __device__ inline int gen_K(int ph, int L, int N) {
  return ph == 0 || ph == L ? N : 2 * N;
}

// Items of phase ph: tiles of `units` units (head: of the M / 4 columns of
// a gate stride) times the groups of rows (hrows) batch rows.
__host__ __device__ inline int gen_items(int ph, int L, int B, int N, int M,
                                         int units, int rows, int hrows) {
  const int r = ph < L ? rows : hrows;
  const int tiles = (ph < L ? N : M / 4) / units;
  return tiles * ((B + r - 1) / r);
}

// Slot `slot` of phase ph's input, (B, gen_K(ph)) in CT.
template <typename CT>
__device__ __forceinline__ CT* gen_xin(const GenPersist<CT>& p, int ph, int slot) {
  const size_t before = ph == 0 ? 0 : (size_t)p.N + (size_t)(ph - 1) * 2 * p.N;
  return p.xin + 2 * (size_t)p.B * before + (size_t)slot * p.B * gen_K(ph, p.L, p.N);
}

// A block's item of a phase: its weights (row stride 4 gs), its columns
// gate * gs + j0 + u (u < units), its batch rows b0 .. b0 + rows - 1; and
// where the tile's weight w[k][gate][unit] lies: wt[k * rs + gate * gst +
// unit], in W itself (rs = 4 gs, gst = gs) or, where the launch has them,
// in the packed rows Wt (rs = 4 units, gst = units: the tile contiguous).
template <typename CT>
struct GenItem {
  const CT* W;
  int K, gs, tile, j0, b0, rows;
  const CT* wt;
  size_t rs;
  int gst;
};

template <typename CT>
__device__ __forceinline__ GenItem<CT> gen_item(const GenPersist<CT>& p, int ph,
                                                int it, int units) {
  GenItem<CT> g;
  const bool head = ph == p.L;
  const size_t n4 = 4 * (size_t)p.N;
  g.K = gen_K(ph, p.L, p.N);
  g.gs = head ? p.M / 4 : p.N;
  const int tiles = g.gs / units;
  g.tile = it % tiles;
  g.j0 = g.tile * units;
  g.rows = head ? p.hrows : p.rows;
  g.b0 = it / tiles * g.rows;
  g.W = head ? p.Why
        : ph == 0 ? p.WU + (size_t)p.M * n4
                  : p.WU + (size_t)(p.M + p.N) * n4 + (size_t)(ph - 1) * 2 * p.N * n4;
  if (p.Wt == nullptr) {
    g.wt = g.W + g.j0;
    g.rs = 4 * (size_t)g.gs;
    g.gst = g.gs;
  } else {
    // the phases before hold 4N columns over their K rows each, as the
    // input slots' widths add up
    const size_t before = ph == 0 ? 0 : (size_t)p.N + (size_t)(ph - 1) * 2 * p.N;
    g.wt = p.Wt + n4 * before + (size_t)g.tile * g.K * 4 * units;
    g.rs = 4 * (size_t)units;
    g.gst = units;
  }
  return g;
}

// Layer ph's gates and cell update of row b, unit j from the gate sums s:
// (s + W_0[ch]) + b for layer 0, s + b after; round(h) to this layer's next
// input slot and to the next phase's current one; c in place; the traces;
// hT at the last token.
template <typename CT>
__device__ __forceinline__ void gen_cell(const GenPersist<CT>& p, int ph, int t,
                                         int b, int j, const float (&s)[4], int ch) {
  const int N = p.N, B = p.B;
  const size_t n4 = 4 * (size_t)N;
  const float* bias = p.bias + ph * n4;
  float gate[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v = s[g];
    if (ph == 0) v += to_f32(p.WU[(size_t)ch * n4 + (size_t)g * N + j]);
    v += bias[(size_t)g * N + j];
    gate[g] = g < 3 ? sigmoid(v) : tanhf(v);
  }
  const size_t idx = ((size_t)ph * B + b) * N + j;
  float h, c;
  cell(gate, __ldcg(p.c + idx), p.standard, &h, &c);
  p.c[idx] = c;
  const CT hr = from_f32<CT>(h);
  const int K = gen_K(ph, p.L, N), Kn = gen_K(ph + 1, p.L, N);
  gen_xin(p, ph, (t + 1) % 2)[(size_t)b * K + (K - N) + j] = hr;
  gen_xin(p, ph + 1, t % 2)[(size_t)b * Kn + j] = hr;
  if (p.trace_h != nullptr) {
    const size_t at = (size_t)t * p.L * B * N + idx;
    p.trace_h[at] = h;
    p.trace_c[at] = c;
  }
  if (t == p.length - 1) p.h[idx] = h;
}

// The head's score of row b, byte v from its logit sum s.
template <typename CT>
__device__ __forceinline__ void gen_head(const GenPersist<CT>& p, unsigned base,
                                         int b, int v, float s) {
  p.scores[(size_t)b * p.M + v] =
      gen_score(__fadd_rn(s, p.by[v]), b, v, p.M, base, p.inv_t, p.greedy);
}

// Row b's token from the scores of the last head (a warp; every lane
// returns it).
template <typename CT>
__device__ __forceinline__ int gen_draw(const GenPersist<CT>& p, int b) {
  float best = 0.0f;
  int arg = -1;
  for (int v = threadIdx.x % 32; v < p.M; v += 32) {
    const float s = __ldcg(p.scores + (size_t)b * p.M + v);
    if (arg < 0 || s > best) {  // ascending v: the first maximum stays
      best = s;
      arg = v;
    }
  }
  return warp_first_argmax(best, arg);
}

// 8 consecutive weights widened to fp32: from shared memory (a resident
// row) or through the read-only path (a streamed one; nothing in the launch
// writes the weights). p is 16-byte aligned.
__device__ __forceinline__ void w8_shared(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int u = 0; u < 8; ++u) w[u] = __bfloat162float(wb[u]);
}
__device__ __forceinline__ void w8_global(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int u = 0; u < 8; ++u) w[u] = __bfloat162float(wb[u]);
}
__device__ __forceinline__ void w8_shared(const float* p, float (&w)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void w8_global(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
// As w8_global, the lines first in L2's eviction order (policy: a
// createpolicy evict_first handle).
__device__ __forceinline__ void w8_global(const float* p, float (&w)[8],
                                          unsigned long long policy) {
  float4 a, b;
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(a.x), "=f"(a.y), "=f"(a.z), "=f"(a.w) : "l"(p), "l"(policy));
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(b.x), "=f"(b.y), "=f"(b.z), "=f"(b.w) : "l"(p + 4), "l"(policy));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// The first n rows of the item's 4 x kGVUnits columns into dst, [k][gate]
// [unit] with pitch kGVPitch, in 16-byte copies (one a gate row in bf16,
// two in fp32): the layout of the gemv and of the fp32 FFMA product.
template <typename CT>
__device__ __forceinline__ void gen_hold_gate_rows(const GenItem<CT>& it, CT* dst,
                                                   int n) {
  constexpr int per = 16 / sizeof(CT);        // elements of a copy
  constexpr int copies = kGVUnits / per;      // copies of a gate's units
  for (int e = threadIdx.x; e < n * 4 * copies; e += kFThreads) {
    const int k = e / (4 * copies), g = e / copies % 4, q = e % copies;
    cp_async_16(dst + (size_t)k * kGVPitch + g * kGVUnits + q * per,
                it.wt + (size_t)k * it.rs + (size_t)g * it.gst + q * per, 16);
  }
}

// gemv (B = 1, either type): the gate sums of the block's one row. round(x)
// whole into xs; thread (g = tid % 4, r = tid / 4) takes gate g's kGVUnits
// units of rows r, r + 64, ... (resident rows from Ur, the rest through the
// read-only path in 16-byte loads); the lanes of a gate add up by
// shuffles, then the warps in order through red. A row of the tile is 64
// bytes in bf16, 128 in fp32.
template <typename CT>
struct GemvProduct {
  static constexpr int kUnits = kGVUnits;
  static constexpr int kPitch = kGVPitch;

  // round(x) of 2N, the warps' sums and the block's 32 gate sums
  static size_t scratch_bytes(int, int, int N) {
    return 2 * (size_t)N * sizeof(CT) + (size_t)(kFWarps + 1) * 4 * kGVUnits * 4;
  }

  static __device__ __forceinline__ void hold(const GenPersist<CT>&,
                                              const GenItem<CT>& it, CT* dst, int n) {
    gen_hold_gate_rows(it, dst, n);
  }

  template <typename Emit>
  static __device__ __forceinline__ void run(const GenPersist<CT>& p,
                                             const GenItem<CT>& it, const CT* x,
                                             const CT* Us, int cres,
                                             unsigned char* scratch, Emit emit) {
    constexpr int per = 16 / sizeof(CT);
    CT* xs = reinterpret_cast<CT*>(scratch);
    float* red = reinterpret_cast<float*>(scratch + 2 * (size_t)p.N * sizeof(CT));
    float* sums = red + kFWarps * 4 * kGVUnits;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    for (int e = tid; e < it.K / per; e += kFThreads)
      cp_async_16(xs + per * e, x + per * e, 16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int g = tid % 4, r = tid / 4, kres = cres * kFKC;
    float acc[kGVUnits];
#pragma unroll
    for (int u = 0; u < kGVUnits; ++u) acc[u] = 0.0f;
    const auto fma8 = [&](float xv, const float (&w)[8]) {
#pragma unroll
      for (int u = 0; u < kGVUnits; ++u) acc[u] = fmaf(xv, w[u], acc[u]);
    };
#pragma unroll 4
    for (int k = r; k < kres; k += kGVLanes) {
      float w[8];
      w8_shared(Us + (size_t)k * kGVPitch + g * kGVUnits, w);
      fma8(to_f32(xs[k]), w);
    }
    const CT* wg = it.wt + (size_t)g * it.gst;
    const auto stream = [&](auto load) {
#pragma unroll 8
      for (int k = kres + r; k < it.K; k += kGVLanes) {
        float w[8];
        load(wg + (size_t)k * it.rs, w);
        fma8(to_f32(xs[k]), w);
      }
    };
    const auto plain = [](const CT* q, float (&w)[8]) { w8_global(q, w); };
    if constexpr (sizeof(CT) == 4) {
      // fp32 streams more than L2 holds at every token (the flagship's
      // ~55.7 MB against 50 MB): the rows of a phase the block holds none
      // of go first out of L2, so that the streamed rest of a phase it
      // holds in part stays there from token to token
      if (cres == 0) {
        unsigned long long first;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                     : "=l"(first));
        stream([&](const CT* q, float (&w)[8]) { w8_global(q, w, first); });
      } else {
        stream(plain);
      }
    } else {
      stream(plain);
    }
    // lanes g, g + 4, ..., g + 28 of a warp hold gate g
#pragma unroll
    for (int off = 4; off < 32; off *= 2)
#pragma unroll
      for (int u = 0; u < kGVUnits; ++u) acc[u] += __shfl_xor_sync(0xFFFFFFFFu, acc[u], off);
    if (lane < 4)
#pragma unroll
      for (int u = 0; u < kGVUnits; ++u) red[(warp * 4 + g) * kGVUnits + u] = acc[u];
    __syncthreads();
    if (tid < 4 * kGVUnits) {
      float s = 0.0f;
      for (int w = 0; w < kFWarps; ++w) s += red[w * 4 * kGVUnits + tid];
      sums[tid] = s;
    }
    __syncthreads();
    if (tid < kGVUnits) {
      const float s[4] = {sums[tid], sums[kGVUnits + tid], sums[2 * kGVUnits + tid],
                          sums[3 * kGVUnits + tid]};
      emit(0, it.j0 + tid, s);
    }
  }
};

// Bytes of dynamic shared memory a block takes (mirrored by
// ops/cuda_sampler.py:gen_smem_bytes): the resident weight rows, the
// product's scratch, then the block's tokens and its phases' (item,
// resident chunks, first resident row).
template <typename CT, typename P>
inline size_t gen_smem_bytes(int rows, int hrows, int N, int budget) {
  return (size_t)budget * sizeof(CT) * P::kPitch + P::scratch_bytes(rows, hrows, N) +
         (kGMaxRows + 4 * kGMaxPhases) * 4;
}

template <typename CT, typename P>
__global__ void __launch_bounds__(kFThreads, 1) gen_persist(GenPersist<CT> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  CT* Us = reinterpret_cast<CT*>(smem);
  unsigned char* scratch = smem + (size_t)p.budget * sizeof(CT) * P::kPitch;
  int* chs = reinterpret_cast<int*>(scratch + p.scratch);
  int* info = chs + kGMaxRows;   // item, resident chunks, first row, a phase
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int L = p.L, B = p.B, N = p.N, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if (tid == 0) {
    int left = p.budget / kFKC, row = 0, before = 0;
    for (int ph = 0; ph <= L; ++ph) {
      const int n = gen_items(ph, L, B, N, p.M, P::kUnits, p.rows, p.hrows);
      const int i = ((int)blockIdx.x - before % G + G) % G;
      const int it = i < n ? i : -1;
      const int cres = it < 0 ? 0 : min(gen_K(ph, L, N) / kFKC, left);
      info[4 * ph] = it;
      info[4 * ph + 1] = cres;
      info[4 * ph + 2] = row;
      left -= cres;
      row += cres * kFKC;
      before += n;
    }
  }
  __syncthreads();
  // the resident rows, once for the call
  for (int ph = 0; ph <= L; ++ph) {
    if (info[4 * ph] < 0) continue;
    const GenItem<CT> it = gen_item(p, ph, info[4 * ph], P::kUnits);
    P::hold(p, it, Us + (size_t)info[4 * ph + 2] * P::kPitch, info[4 * ph + 1] * kFKC);
  }
  cp_async_commit();
  // round(h0) into each layer's first slot
  for (size_t e = (size_t)blockIdx.x * kFThreads + tid; e < (size_t)L * B * N;
       e += (size_t)G * kFThreads) {
    const int l = static_cast<int>(e / ((size_t)B * N));
    const int b = static_cast<int>(e / N % B), j = static_cast<int>(e % N);
    const int K = gen_K(l, L, N);
    gen_xin(p, l, 0)[(size_t)b * K + (K - N) + j] = from_f32<CT>(p.h[e]);
  }
  cp_async_wait<0>();
  grid.sync();

  for (int t = 0; t < p.length; ++t) {
    const unsigned base = gen_base(p.seed, t);
    for (int ph = 0; ph <= L; ++ph) {
      const int item = info[4 * ph];
      if (item >= 0) {
        const GenItem<CT> it = gen_item(p, ph, item, P::kUnits);
        const CT* Ur = Us + (size_t)info[4 * ph + 2] * P::kPitch;
        const CT* x = gen_xin(p, ph, t % 2);
        if (ph == 0) {
          // the tokens of the item's rows: the caller's, or drawn from the
          // last head's scores (tile 0's block writes them out)
          for (int r = warp; r < it.rows && it.b0 + r < B; r += kFWarps) {
            const int b = it.b0 + r;
            const int ch = t == 0 ? p.first[b] : gen_draw(p, b);
            if (lane == 0) {
              chs[r] = ch;
              if (t > 0 && it.tile == 0) p.ids[(size_t)(t - 1) * B + b] = ch;
            }
          }
          __syncthreads();
        }
        P::run(p, it, x, Ur, info[4 * ph + 1], scratch,
               [&](int b, int j, const float (&s)[4]) {
                 if (ph < L) {
                   gen_cell(p, ph, t, b, j, s, ph == 0 ? chs[b - it.b0] : 0);
                 } else {
#pragma unroll
                   for (int g = 0; g < 4; ++g) gen_head(p, base, b, g * it.gs + j, s[g]);
                 }
               });
      }
      grid.sync();
    }
  }
  // the last token: a warp a row
  for (int b = blockIdx.x * kFWarps + warp; b < B; b += G * kFWarps) {
    const int ch = gen_draw(p, b);
    if (lane == 0) p.ids[(size_t)(p.length - 1) * B + b] = ch;
  }
}

// One cooperative launch of gen_persist<CT, P> on `grid` blocks, every one
// resident at once (or its grid barrier never opens: refused before the
// launch). Returns 0 or the error.
template <typename CT, typename P>
int run_gen_persist(GenPersist<CT> p, int grid, cudaStream_t stream) {
  const auto kernel = reinterpret_cast<const void*>(gen_persist<CT, P>);
  p.scratch = static_cast<int>(P::scratch_bytes(p.rows, p.hrows, p.N));
  const size_t smem = gen_smem_bytes<CT, P>(p.rows, p.hrows, p.N, p.budget);
  const int fits = cooperative_fits(kernel, kFThreads, smem, grid);
  if (fits != 0) return fits;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kFThreads),
                                                args, smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The checks both launchers make of a layout before anything runs: the
// model's shape, `units` columns a tile, rows and hrows that rows_ok takes,
// a budget of whole chunks, and every phase's items within the grid.
template <typename RowsOk>
bool gen_layout_ok(int L, int B, int N, int M, int length, bool traced_ok,
                   int units, RowsOk rows_ok, int rows, int hrows, int budget,
                   int grid) {
  bool ok = L >= 1 && L <= kGMaxLayers && B >= 1 && B <= kGMaxRows && N > 0 &&
            N % kFKC == 0 && M > 0 && M <= 256 && M % (4 * units) == 0 &&
            length >= 1 && traced_ok && rows_ok(rows) && rows_ok(hrows) &&
            budget >= 0 && budget % kFKC == 0 && grid >= 1;
  for (int ph = 0; ok && ph <= L; ++ph)
    ok = gen_items(ph, L, B, N, M, units, rows, hrows) <= grid;
  return ok;
}

// The kernel's arguments from the launchers' (scratch is set at the
// launch, from the product).
template <typename CT>
GenPersist<CT> gen_args(const void* WU, const void* Wt, const void* bias,
                        const void* Why, const void* by, const void* first,
                        void* h, void* c, void* ids, void* work, void* trace_h,
                        void* trace_c, int L, int B, int N, int M, int length,
                        int standard, int greedy, unsigned seed, float inv_t,
                        int rows, int hrows, int budget) {
  float* scores = static_cast<float*>(work);
  return GenPersist<CT>{static_cast<const CT*>(WU),
                        static_cast<const float*>(bias),
                        static_cast<const CT*>(Why),
                        static_cast<const CT*>(Wt),
                        static_cast<const float*>(by),
                        static_cast<const int*>(first),
                        static_cast<float*>(h),
                        static_cast<float*>(c),
                        static_cast<int*>(ids),
                        scores,
                        reinterpret_cast<CT*>(scores + (size_t)B * M),
                        static_cast<float*>(trace_h),
                        static_cast<float*>(trace_c),
                        L, B, N, M, length, standard, greedy, seed, inv_t,
                        rows, hrows, budget, 0};
}

// Bytes of the work buffer: the scores (B, M) fp32, then the products'
// inputs, two slots of (B, gen_K) in CT a phase.
template <typename CT>
inline size_t gen_work_bytes(int B, int N, int M, int L) {
  return (size_t)B * M * 4 + 2 * sizeof(CT) * (size_t)B * N * L * 2;
}

}  // namespace
