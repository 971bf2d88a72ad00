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
// 22.3 M elements for the 3 x 1024 flagship (44.6 MB in bf16), and does
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
// The persistent design (gen_persist, bf16 compute, B <= 128). Each block
// owns fixed output tiles for the whole call: in each layer a tile of
// `units` hidden units x 4 gates and `rows` batch rows, in the head 4 x
// `units` of the M logits (gate stride M / 4) and `hrows` rows; the items
// of phase p go to blocks (offset_p + i) % grid, offset_p the items of the
// phases before, so every phase spreads over the SMs and a block has at
// most one item a phase. At the start a block copies as many of its items'
// weight rows ([k][gate][unit]) into shared memory as its budget holds, in
// phase order, and keeps them for the call; the rest stream from L2 at
// every token. A block sums the whole k range of its columns, so the gates
// and the cell update run right after the product, in its registers, and a
// token takes L + 1 grid barriers (one a layer, one after the head), not
// 2L + 1, with no partial sums through device memory. The head writes each
// row's scores (logits, and with T > 0 the scaled logits plus the noise);
// a block with a layer-0 item draws its rows' tokens from them itself
// (the first argmax of 256 scores, a warp a row) at the next token, so the
// draw takes no barrier of its own, and the block of tile 0 writes ids.
// The products' inputs round([x_l, h_l]) live in bf16 in two slots a
// phase (token parity): layer l writes h_l(t) into its own next slot and
// into layer l + 1's (or the head's) current one. c stays in the fp32 c
// buffer, read and written only by the thread that owns the element.
// Buffers written in the launch (the inputs, the scores, c) are read
// through L2 only (cp.async.cg, __ldcg). Two products:
//   mma   (B >= 2, and B = 1 where gen_plan takes it): the tensor-core
//         step of fwd_mma.cuh (fwd_products: 16 units, a cp.async ring of
//         64-row chunks, mma.sync m16n8k16, fp32 sums; below 16 rows the m
//         tile is masked), the epilogue in the owner lanes' registers;
//   gemv  (B = 1): 8 units a tile; the block loads round(x) whole into
//         shared memory, each thread takes one gate's 8 units (16 bytes of
//         a row) of every 64th k row, resident rows from shared memory,
//         the rest with 16-byte loads from L2, fp32 FMAs; the sums meet by
//         warp shuffles and then across the warps in a fixed order.
// The grid barrier is cg::grid_group::sync (it measured faster than a
// counter barrier on the H100, PERF.md §6 row 11). Every sum has a fixed
// order, so a call is deterministic.
//
// The first design (gen_kernel: fp32 compute, and shapes the plan
// refuses). One cooperative launch, a grid of at most two blocks a SM, all
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
  for (int off = kGLanes / 2; off > 0; off /= 2) {
    const float ob = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int oa = __shfl_xor_sync(0xFFFFFFFFu, arg, off);
    if (oa >= 0 && (arg < 0 || ob > best || (ob == best && oa < arg))) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
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
// The persistent design (module comment): gen_persist<MMA>, bf16 compute.
constexpr int kGMaxLayers = 8;
constexpr int kGMaxPhases = kGMaxLayers + 1;   // the layers and the head
constexpr int kGMaxRows = kFMaxRows;           // batch rows at most
constexpr int kGVUnits = 8;                    // units of a gemv tile
constexpr int kGVPitch = 4 * kGVUnits;         // bf16 a resident gemv row
constexpr int kGVLanes = kFThreads / 4;        // k rows a gemv pass takes

struct GenPersist {
  const __nv_bfloat16* WU;   // layers' [W; U], as Gen
  const float* bias;         // (L, 4N)
  const __nv_bfloat16* Why;  // (N, M)
  const float* by;           // (M,)
  const int* first;          // (B,) the token before the call
  float* h;                  // (L, B, N): h0 in, hT out
  float* c;                  // (L, B, N): c0 in, cT out, updated every token
  int* ids;                  // (length, B)
  float* scores;             // (B, M) the last head's scores
  __nv_bfloat16* xin;        // the products' inputs: two slots a phase
  float* trace_h;            // (length, L, B, N) or null
  float* trace_c;
  int L, B, N, M, length, standard, greedy;
  unsigned seed;
  float inv_t;
  int rows, hrows;           // batch rows of a layer item, of a head item
  int budget;                // weight rows a block may hold (a multiple of kFKC)
  int scratch;               // bytes of the scratch after them (gen_scratch_bytes)
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

// Slot `slot` of phase ph's input, (B, gen_K(ph)) in bf16.
__device__ __forceinline__ __nv_bfloat16* gen_xin(const GenPersist& p, int ph,
                                                  int slot) {
  const size_t before = ph == 0 ? 0 : (size_t)p.N + (size_t)(ph - 1) * 2 * p.N;
  return p.xin + 2 * (size_t)p.B * before +
         (size_t)slot * p.B * gen_K(ph, p.L, p.N);
}

// A block's item of a phase: its weights (row stride 4 gs), its columns
// gate * gs + j0 + u (u < units), its batch rows b0 .. b0 + rows - 1.
struct GenItem {
  const __nv_bfloat16* W;
  int K, gs, tile, j0, b0, rows;
};

__device__ __forceinline__ GenItem gen_item(const GenPersist& p, int ph, int it,
                                            int units) {
  GenItem g;
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
  return g;
}

// Layer ph's gates and cell update of row b, unit j from the gate sums s:
// (s + W_0[ch]) + b for layer 0, s + b after; round(h) to this layer's next
// input slot and to the next phase's current one; c in place; the traces;
// hT at the last token.
__device__ __forceinline__ void gen_cell(const GenPersist& p, int ph, int t,
                                         int b, int j, const float s[4], int ch) {
  const int N = p.N, B = p.B;
  const size_t n4 = 4 * (size_t)N;
  const float* bias = p.bias + ph * n4;
  float gate[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v = s[g];
    if (ph == 0) v += __bfloat162float(p.WU[(size_t)ch * n4 + (size_t)g * N + j]);
    v += bias[(size_t)g * N + j];
    gate[g] = g < 3 ? sigmoid(v) : tanhf(v);
  }
  const size_t idx = ((size_t)ph * B + b) * N + j;
  float h, c;
  cell(gate, __ldcg(p.c + idx), p.standard, &h, &c);
  p.c[idx] = c;
  const __nv_bfloat16 hb = __float2bfloat16(h);
  const int K = gen_K(ph, p.L, N), Kn = gen_K(ph + 1, p.L, N);
  gen_xin(p, ph, (t + 1) % 2)[(size_t)b * K + (K - N) + j] = hb;
  gen_xin(p, ph + 1, t % 2)[(size_t)b * Kn + j] = hb;
  if (p.trace_h != nullptr) {
    const size_t at = (size_t)t * p.L * B * N + idx;
    p.trace_h[at] = h;
    p.trace_c[at] = c;
  }
  if (t == p.length - 1) p.h[idx] = h;
}

// The head's score of row b, byte v from its logit sum s.
__device__ __forceinline__ void gen_head(const GenPersist& p, unsigned base,
                                         int b, int v, float s) {
  p.scores[(size_t)b * p.M + v] =
      gen_score(__fadd_rn(s, p.by[v]), b, v, p.M, base, p.inv_t, p.greedy);
}

// Row b's token from the scores of the last head (a warp; every lane
// returns it).
__device__ __forceinline__ int gen_draw(const GenPersist& p, int b) {
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

// gemv: the gate sums of the block's one row (B = 1): round(x) whole into
// xs; thread (g = tid % 4, r = tid / 4) takes gate g's kGVUnits units of
// rows r, r + 64, ... (resident rows from Us, the rest from L2 in 16-byte
// loads); the lanes of a gate add up by shuffles, then the warps in order
// through red. sums[g * kGVUnits + u] on return.
__device__ __forceinline__ void gemv_products(const GenItem& it,
                                              const __nv_bfloat16* x,
                                              const __nv_bfloat16* Us, int cres,
                                              __nv_bfloat16* xs, float* red,
                                              float* sums) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int e = tid; e < it.K / 8; e += kFThreads) cp_async_16(xs + 8 * e, x + 8 * e, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int g = tid % 4, r = tid / 4, kres = cres * kFKC;
  float acc[kGVUnits];
#pragma unroll
  for (int u = 0; u < kGVUnits; ++u) acc[u] = 0.0f;
  const auto fma8 = [&](float xv, uint4 w) {
    const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int u = 0; u < kGVUnits; ++u) acc[u] = fmaf(xv, __bfloat162float(wb[u]), acc[u]);
  };
#pragma unroll 4
  for (int k = r; k < kres; k += kGVLanes)
    fma8(__bfloat162float(xs[k]),
         *reinterpret_cast<const uint4*>(Us + (size_t)k * kGVPitch + g * kGVUnits));
  const __nv_bfloat16* wg = it.W + (size_t)g * it.gs + it.j0;
#pragma unroll 8
  for (int k = kres + r; k < it.K; k += kGVLanes)
    fma8(__bfloat162float(xs[k]),
         __ldg(reinterpret_cast<const uint4*>(wg + (size_t)k * 4 * it.gs)));
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
}

// Bytes of dynamic shared memory a block takes (mirrored by
// ops/cuda_sampler.py:gen_smem_bytes): the resident weight rows, the
// scratch (mma: the ring of the larger of rows and hrows; gemv: round(x)
// of 2N and the warps' sums), then the block's tokens and its phases'
// (item, resident chunks, first resident row).
inline size_t gen_scratch_bytes(bool mma, int rows, int hrows, int N) {
  if (mma) {
    const size_t a = fwd_smem_bytes(rows, 0), b = fwd_smem_bytes(hrows, 0);
    return a > b ? a : b;
  }
  return 4 * (size_t)N + (size_t)(kFWarps + 1) * 4 * kGVUnits * 4;
}
inline size_t gen_smem_bytes(bool mma, int rows, int hrows, int N, int budget) {
  return (size_t)budget * 2 * (mma ? kFUPitch : kGVPitch) +
         gen_scratch_bytes(mma, rows, hrows, N) + (kGMaxRows + 4 * kGMaxPhases) * 4;
}

template <bool MMA>
__global__ void __launch_bounds__(kFThreads, 1) gen_persist(GenPersist p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int pitch = MMA ? kFUPitch : kGVPitch;
  constexpr int units = MMA ? kFUnits : kGVUnits;
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* scratch = smem + (size_t)p.budget * 2 * pitch;
  int* chs = reinterpret_cast<int*>(scratch + p.scratch);
  int* info = chs + kGMaxRows;   // item, resident chunks, first row, a phase
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int L = p.L, B = p.B, N = p.N, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if (tid == 0) {
    int left = p.budget / kFKC, row = 0, before = 0;
    for (int ph = 0; ph <= L; ++ph) {
      const int n = gen_items(ph, L, B, N, p.M, units, p.rows, p.hrows);
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
  // the resident rows, [k][gate][unit], once for the call
  for (int ph = 0; ph <= L; ++ph) {
    if (info[4 * ph] < 0) continue;
    const GenItem it = gen_item(p, ph, info[4 * ph], units);
    __nv_bfloat16* dst = Us + (size_t)info[4 * ph + 2] * pitch;
    const int n = info[4 * ph + 1] * kFKC;
    if constexpr (MMA) {
      const FwdTile f = fwd_mma_tile(it.K, it.gs, it.j0, it.b0, B, it.rows);
      for (int e = tid; e < n * 8; e += kFThreads)
        fwd_u_copy(f, it.W, dst + (size_t)(e / 8) * pitch, e / 8, e % 8);
    } else {
      for (int e = tid; e < n * 4; e += kFThreads) {
        const int k = e / 4, g = e % 4;
        cp_async_16(dst + (size_t)k * pitch + g * kGVUnits,
                    it.W + (size_t)k * 4 * it.gs + (size_t)g * it.gs + it.j0, 16);
      }
    }
  }
  cp_async_commit();
  // round(h0) into each layer's first slot
  for (size_t e = (size_t)blockIdx.x * kFThreads + tid; e < (size_t)L * B * N;
       e += (size_t)G * kFThreads) {
    const int l = static_cast<int>(e / ((size_t)B * N));
    const int b = static_cast<int>(e / N % B), j = static_cast<int>(e % N);
    const int K = gen_K(l, L, N);
    gen_xin(p, l, 0)[(size_t)b * K + (K - N) + j] = __float2bfloat16(p.h[e]);
  }
  cp_async_wait<0>();
  grid.sync();

  for (int t = 0; t < p.length; ++t) {
    const unsigned base = gen_base(p.seed, t);
    for (int ph = 0; ph <= L; ++ph) {
      const int item = info[4 * ph];
      if (item >= 0) {
        const GenItem it = gen_item(p, ph, item, units);
        const __nv_bfloat16* Ur = Us + (size_t)info[4 * ph + 2] * pitch;
        const int cres = info[4 * ph + 1];
        const __nv_bfloat16* x = gen_xin(p, ph, t % 2);
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
        if constexpr (MMA) {
          const FwdTile f = fwd_mma_tile(it.K, it.gs, it.j0, it.b0, B, it.rows);
          float acc[8][4];
          fwd_products(f, it.W, x, Ur, cres,
                       reinterpret_cast<__nv_bfloat16*>(scratch), acc);
          if (f.owner) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int b = fwd_row(f, hh);
              if (b >= B) continue;
#pragma unroll
              for (int uh = 0; uh < 2; ++uh)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int j = fwd_unit(f, uh, e);
                  if (ph < L) {
                    const float s[4] = {acc[uh][2 * hh + e], acc[2 + uh][2 * hh + e],
                                        acc[4 + uh][2 * hh + e], acc[6 + uh][2 * hh + e]};
                    gen_cell(p, ph, t, b, j, s, ph == 0 ? chs[b - it.b0] : 0);
                  } else {
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                      gen_head(p, base, b, g * it.gs + j, acc[2 * g + uh][2 * hh + e]);
                  }
                }
            }
          }
        } else {
          __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(scratch);
          float* red = reinterpret_cast<float*>(scratch + 4 * (size_t)N);
          float* sums = red + kFWarps * 4 * kGVUnits;
          gemv_products(it, x, Ur, cres, xs, red, sums);
          if (ph < L && tid < kGVUnits) {
            const float s[4] = {sums[tid], sums[kGVUnits + tid],
                                sums[2 * kGVUnits + tid], sums[3 * kGVUnits + tid]};
            gen_cell(p, ph, t, 0, it.j0 + tid, s, ph == 0 ? chs[0] : 0);
          } else if (ph == L && tid < 4 * kGVUnits) {
            gen_head(p, base, 0, tid / kGVUnits * it.gs + it.j0 + tid % kGVUnits,
                     sums[tid]);
          }
        }
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

// Per card, read once: cooperative launch support and the SMs.
constexpr int kGMaxDevices = 64;

template <bool MMA>
int run_gen_persist(const GenPersist& p, int grid, cudaStream_t stream) {
  const auto kernel = gen_persist<MMA>;
  const size_t smem = gen_smem_bytes(MMA, p.rows, p.hrows, p.N, p.budget);
  static int ready[kGMaxDevices], coop[kGMaxDevices], sms[kGMaxDevices];
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kGMaxDevices) err = cudaErrorInvalidDevice;
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop[dev]) return static_cast<int>(cudaErrorNotSupported);
  // every block must be resident at once, or a grid barrier never opens
  if (grid > sms[dev] * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  GenPersist arg = p;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kFThreads), args, smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

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

// Bytes of the persistent design's dynamic shared memory (gen_smem_bytes;
// mma 1: the tensor-core product, 0: gemv).
extern "C" size_t gen_persist_smem_bytes(int mma, int rows, int hrows, int N,
                                         int budget) {
  return gen_smem_bytes(mma != 0, rows, hrows, N, budget);
}

// Bytes of the persistent design's work buffer: the scores (B, M) fp32,
// then the products' inputs, two bf16 slots of (B, gen_K) a phase.
extern "C" size_t gen_persist_work_bytes(int B, int N, int M, int L) {
  return (size_t)B * M * 4 + 4 * (size_t)B * N * L * 2;
}

// The persistent design: WU and Why bf16, the rest as gen_launch; `first`
// (B,) int32 is read only; h and c hold h0 and c0 and receive hT and cT.
// The layout (ops/cuda_sampler.py:gen_plan):
// mma (1: the tensor-core product, 16 units a tile; 0: gemv, 8 units, B = 1),
// rows and hrows (batch rows of a layer and a head item: B, or a multiple of
// 16), budget (weight rows a block holds, a multiple of 64), grid (blocks,
// all resident, each phase at most one item a block). Refuses any other
// layout with cudaErrorInvalidValue. One launch, added to *launched.
extern "C" int gen_persist_launch(const void* WU, const void* bias, const void* Why,
                                  const void* by, const void* first, void* h,
                                  void* c, void* ids, void* work,
                                  void* trace_h, void* trace_c, int L, int B,
                                  int N, int M, int length, int standard,
                                  int greedy, unsigned seed, float inv_t,
                                  int mma, int rows, int hrows, int budget,
                                  int grid, void* stream,
                                  int* launched) {
  const int units = mma ? kFUnits : kGVUnits;
  const auto rows_ok = [&](int r) {
    return mma ? r >= 1 && r <= kFMaxRows && (r >= B || r % 16 == 0) : r == 1;
  };
  bool ok = L >= 1 && L <= kGMaxLayers && B >= 1 && B <= kGMaxRows && N > 0 &&
            N % kFKC == 0 && M > 0 && M <= 256 && M % (4 * units) == 0 &&
            length >= 1 && (trace_h == nullptr) == (trace_c == nullptr) &&
            (mma == 0 || mma == 1) && (mma || B == 1) && rows_ok(rows) &&
            rows_ok(hrows) && budget >= 0 && budget % kFKC == 0 && grid >= 1;
  for (int ph = 0; ok && ph <= L; ++ph)
    ok = gen_items(ph, L, B, N, M, units, rows, hrows) <= grid;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  float* scores = static_cast<float*>(work);
  const GenPersist p{static_cast<const __nv_bfloat16*>(WU),
                     static_cast<const float*>(bias),
                     static_cast<const __nv_bfloat16*>(Why),
                     static_cast<const float*>(by),
                     static_cast<const int*>(first),
                     static_cast<float*>(h),
                     static_cast<float*>(c),
                     static_cast<int*>(ids),
                     scores,
                     reinterpret_cast<__nv_bfloat16*>(scores + (size_t)B * M),
                     static_cast<float*>(trace_h),
                     static_cast<float*>(trace_c),
                     L, B, N, M, length, standard, greedy, seed, inv_t,
                     rows, hrows, budget,
                     static_cast<int>(gen_scratch_bytes(mma, rows, hrows, N))};
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = mma ? run_gen_persist<true>(p, grid, s) : run_gen_persist<false>(p, grid, s);
  if (err == 0) ++*launched;
  return err;
}
