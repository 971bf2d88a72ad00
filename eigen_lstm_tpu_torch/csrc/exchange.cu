// The exchange buffers of K15 and K16 at D > 1 (csrc/lstm_tp.cu), bound
// from Python through ctypes (ops/cuda_tp_seq.py). No PyTorch headers.
//
// A rank's buffer is one cudaMalloc of its own, not a block of torch's
// caching allocator (whose blocks are pieces of larger allocations), so
// that cudaIpcGetMemHandle can export it: on D cards each rank exports its
// buffer, the handles are all-gathered over the model axis, and every rank
// maps its peers' with cudaIpcOpenMemHandle; the kernels then store into
// the peers' buffers over NVLink. On one card one process allocates the D
// buffers itself. Replaces no TPU kernel: it is the memory that the TPU
// kernel's remote copies and semaphores (pallas_tp_seq.py:96-120, :157-177)
// had from the runtime. Each function returns a CUDA error code (0: done).

#include <cuda_runtime.h>

#include <string.h>

namespace {

// Word i of the IPC round trip's pattern, from its seed.
__host__ __device__ inline unsigned pattern_word(size_t i, unsigned seed) {
  unsigned x = static_cast<unsigned>(i) * 0x9E3779B9u ^ seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  return x;
}

__global__ void write_pattern(unsigned* p, size_t n, unsigned seed) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = pattern_word(i, seed);
}

}  // namespace

// A buffer of `bytes` on the current card, zeroed (the flags and the rank
// barriers start at 0), into *ptr.
extern "C" int exchange_alloc(size_t bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

extern "C" int exchange_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// The 64-byte IPC handle of a buffer from exchange_alloc, into handle.
extern "C" int exchange_ipc_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

// A peer's buffer, mapped into this process from its handle (peer access
// enabled as the mapping needs it), into *ptr.
extern "C" int exchange_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int exchange_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Whether card `dev` may read and write card `peer`'s memory, into *can.
extern "C" int exchange_can_access_peer(int dev, int peer, int* can) {
  return static_cast<int>(cudaDeviceCanAccessPeer(can, dev, peer));
}

// Writes the pattern of `seed` into the first `words` 32-bit words at ptr
// and waits for it (the IPC round trip's writer).
extern "C" int exchange_write_pattern(void* ptr, size_t words, unsigned seed) {
  write_pattern<<<(unsigned)((words + 255) / 256), 256>>>(
      static_cast<unsigned*>(ptr), words, seed);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

// Copies `bytes` from device memory at src to host memory at dst.
extern "C" int exchange_read(void* dst, const void* src, size_t bytes) {
  return static_cast<int>(cudaMemcpy(dst, src, bytes, cudaMemcpyDeviceToHost));
}
