// Fused Adagrad for Hopper (sm_90a), bound from Python through ctypes
// (eigen_lstm_tpu_torch/ops/cuda_adagrad.py). No PyTorch headers.
//   adagrad_plan_launch (K11) <- pallas_adagrad.py:_adagrad_kernel
//   adagrad_launch      (K11's first call path: the same kernel from a
//                        table of every pointer; the forced control)
//
// The update, per element, in the JAX order (train/optimizer.py:96-118 of
// the JAX package, which _adagrad_kernel repeats):
//   m' = m + g*g                          stored in m's type
//   p' = p - (lr*g) * rsqrt(m' + eps)     stored in p's type
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn):
// nvcc would contract a*b + c into one fma by default, and the plain torch
// version runs one rounded operation a kernel. rsqrtf is the same
// approximate reciprocal square root (2 ulp at most) that torch.rsqrt runs
// on the card, so m' is bit for bit the plain version's and p' within an
// ulp of it. The update is out of place, as the port's optimizer is
// functional: the caller keeps the state from before the step (the
// non-finite skip and the trainer's checks read it).
//
// One launch a step covers every tensor of the parameter set: a table of
// (p, g, m, p_out, m_out, numel) rides in the kernel's parameters, each
// tensor is cut into chunks of kChunk elements, and block c finds its
// tensor by the chunks' prefix counts. A thread moves 16 bytes at a time
// (float4) where all five of a tensor's pointers are 16-byte aligned and
// the chunk is whole, else one element at a time.
//
// The call path (adagrad_plan_launch) takes only what changes from call to
// call: the 3n input addresses, the bases of two output arenas (every p'
// in one allocation, every m' in another) and the caller's plan of the
// parameter set's layout, (numel, offset) a tensor, with every offset a
// multiple of 4 elements, so each output keeps the float4 path. The chunk
// prefixes and float4 flags are formed here at each launch (a loop over at
// most kMaxTensors entries on the host). The wrapper caches the plan and
// the address table per layout. adagrad_launch, the first call path, takes
// a table of 6n entries with 2n outputs of their own: its wrapper's host
// time, not the kernel, lost to torch._foreach_* at the bench's set.
//
// What bounds it on the H100: 20 bytes an element (read p, g, m; write p'
// and m'), ~3 flops: bytes, at 3.35 TB/s (the flagship's 22.3 M
// parameters: 446 MB, 0.133 ms). The chunks are independent and every
// byte is touched once, so the design's only cost above the bound is the
// tail of each tensor.

#include "common.cuh"

namespace {

constexpr int kMaxTensors = 48;  // a call with more is cut into launches
constexpr int kThreads = 256;
constexpr int kVec = 4;          // float4 a thread an iteration
constexpr int kChunk = kThreads * kVec * 4;  // elements a block

struct Table {
  const float* p[kMaxTensors];
  const float* g[kMaxTensors];
  const float* m[kMaxTensors];
  float* p_out[kMaxTensors];
  float* m_out[kMaxTensors];
  long long n[kMaxTensors];
  int first[kMaxTensors + 1];  // first chunk of each tensor, then the total
  int vec[kMaxTensors];        // all five pointers 16-byte aligned
  int count;
};

__device__ __forceinline__ void update(float p, float g, float m, float lr,
                                       float eps, float& p2, float& m2) {
  m2 = __fadd_rn(m, __fmul_rn(g, g));
  p2 = __fsub_rn(p, __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(m2, eps))));
}

__global__ void __launch_bounds__(kThreads)
adagrad_kernel(const __grid_constant__ Table t, float lr, float eps) {
  const int c = blockIdx.x;
  int k = 0;
  while (k + 1 < t.count && t.first[k + 1] <= c) ++k;
  const long long base = (long long)(c - t.first[k]) * kChunk;
  const long long n = t.n[k];
  const float* p = t.p[k];
  const float* g = t.g[k];
  const float* m = t.m[k];
  float* po = t.p_out[k];
  float* mo = t.m_out[k];
  if (t.vec[k] && base + kChunk <= n) {
#pragma unroll
    for (int i = 0; i < kChunk / (kThreads * kVec); ++i) {
      const long long e = base + ((long long)i * kThreads + threadIdx.x) * kVec;
      const float4 pv = __ldg(reinterpret_cast<const float4*>(p + e));
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g + e));
      const float4 mv = __ldg(reinterpret_cast<const float4*>(m + e));
      float4 p2, m2;
      update(pv.x, gv.x, mv.x, lr, eps, p2.x, m2.x);
      update(pv.y, gv.y, mv.y, lr, eps, p2.y, m2.y);
      update(pv.z, gv.z, mv.z, lr, eps, p2.z, m2.z);
      update(pv.w, gv.w, mv.w, lr, eps, p2.w, m2.w);
      *reinterpret_cast<float4*>(po + e) = p2;
      *reinterpret_cast<float4*>(mo + e) = m2;
    }
    return;
  }
  const long long end = base + kChunk < n ? base + kChunk : n;
  for (long long e = base + threadIdx.x; e < end; e += kThreads) {
    float p2, m2;
    update(p[e], g[e], m[e], lr, eps, p2, m2);
    po[e] = p2;
    mo[e] = m2;
  }
}

bool aligned16(const void* x) {
  return (reinterpret_cast<unsigned long long>(x) & 15ull) == 0;
}

// Launches the kernel over t, whose count, pointers and sizes are set:
// forms the chunk prefixes and the float4 flags first. Returns a CUDA
// error code; adds the launch to *launches.
int launch_table(Table& t, float lr, float eps, cudaStream_t stream,
                 int* launches) {
  long long chunks = 0;
  for (int k = 0; k < t.count; ++k) {
    if (t.n[k] < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.vec[k] = aligned16(t.p[k]) && aligned16(t.g[k]) && aligned16(t.m[k]) &&
               aligned16(t.p_out[k]) && aligned16(t.m_out[k]);
    t.first[k] = static_cast<int>(chunks);
    chunks += (t.n[k] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.first[t.count] = static_cast<int>(chunks);
  adagrad_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, stream>>>(
      t, lr, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return 0;
}

}  // namespace

// K11. count tensors of fp32. ins: 3 * count device addresses, every p,
// then every g, then every m (read). layout: 2 entries a tensor, (numel,
// offset): its output is p_out + offset and m_out + offset (written; they
// alias no input). numel >= 1; offsets multiples of 4 for the float4 path.
// lr and eps fp32. One launch for every kMaxTensors tensors (one for any
// parameter set of up to 15 layers); adds them to *launches.
extern "C" int adagrad_plan_launch(int count, const unsigned long long* ins,
                                   const long long* layout, void* p_out,
                                   void* m_out, float lr, float eps,
                                   void* stream, int* launches) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* const po = static_cast<float*>(p_out);
  float* const mo = static_cast<float*>(m_out);
  for (int k0 = 0; k0 < count; k0 += kMaxTensors) {
    Table t{};
    t.count = count - k0 < kMaxTensors ? count - k0 : kMaxTensors;
    for (int k = 0; k < t.count; ++k) {
      const int j = k0 + k;
      t.p[k] = reinterpret_cast<const float*>(ins[j]);
      t.g[k] = reinterpret_cast<const float*>(ins[count + j]);
      t.m[k] = reinterpret_cast<const float*>(ins[2 * count + j]);
      t.n[k] = layout[2 * j];
      t.p_out[k] = po + layout[2 * j + 1];
      t.m_out[k] = mo + layout[2 * j + 1];
    }
    const int err = launch_table(t, lr, eps, static_cast<cudaStream_t>(stream),
                                 launches);
    if (err != 0) return err;
  }
  return 0;
}

// K11's first call path. table: 6 entries a tensor, (p, g, m, p_out,
// m_out, numel), the first five device addresses of fp32 tensors; numel >=
// 1. p, g and m are read, p_out and m_out written (each may alias its
// input, but not another tensor). Otherwise as adagrad_plan_launch.
extern "C" int adagrad_launch(int count, const unsigned long long* table,
                              float lr, float eps, void* stream,
                              int* launches) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int k0 = 0; k0 < count; k0 += kMaxTensors) {
    Table t{};
    t.count = count - k0 < kMaxTensors ? count - k0 : kMaxTensors;
    for (int k = 0; k < t.count; ++k) {
      const unsigned long long* e = table + 6 * (size_t)(k0 + k);
      t.p[k] = reinterpret_cast<const float*>(e[0]);
      t.g[k] = reinterpret_cast<const float*>(e[1]);
      t.m[k] = reinterpret_cast<const float*>(e[2]);
      t.p_out[k] = reinterpret_cast<float*>(e[3]);
      t.m_out[k] = reinterpret_cast<float*>(e[4]);
      t.n[k] = static_cast<long long>(e[5]);
    }
    const int err = launch_table(t, lr, eps, static_cast<cudaStream_t>(stream),
                                 launches);
    if (err != 0) return err;
  }
  return 0;
}
