// The in-kernel exchange of K15 and K16 at D > 1: the peer table, a
// barrier over one rank's blocks, the exchange of a step, the forward's
// RankStep and the launchers' residency check, grid and h0 copy, shared by
// the cooperative tiles (lstm_tp.cu: tp_seq_fwd_x, tp_seq_bwd_x), the
// persistent tensor-core designs (lstm_tp_persist.cu: tp_seq_fwd_persist_x,
// tp_seq_bwd_persist_x) and the fp32 persistent CUDA-core designs
// (lstm_tp_f32.cu: tp_seq_fwd_f32_x; lstm_tp_f32_bwd.cu: tp_seq_bwd_f32_x).
//
// Rank r of D holds U_r, its shard's streams and an exchange buffer in its
// own device memory; the peer table holds every rank's buffer as this
// process maps it (its own, and on D cards the peers' through CUDA IPC,
// csrc/exchange.cu; on one card D buffers of the card). A launch holds
// `groups` rank groups of blocks, group g playing rank ranks[g] with its
// blocks [first, next first): on D cards one group (the process's rank), on
// one card D groups side by side.
//
// A rank's buffer (ops/cuda_tp_seq.py:exchange_layout gives the offsets):
//   [0, 512)  the header: fwd_flag[kMaxRanks] at 0 and bwd_flag at 64, each
//             flag the count of exchanges received from that sender, ever
//             rising (across calls: the host's base); the rank barriers
//             (count, generation) of the forward at 128, the backward at 256
//   h_off     the forward's h slots (3, B, N) in the compute type
//   r_off     the backward's chunks (3, D, P, B, nd) fp32: [slot][sender]
//             [part], P = the parts a sender sends (the fp32 persistent
//             backward's G blocks a unit group; 1 in the other designs),
//             room for kMaxParts under fp32 compute, for one under bf16
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxRanks = 8;
constexpr int kMaxParts = 4;   // the fp32 persistent backward's G at most
constexpr int kFwdFlag = 0, kBwdFlag = 16, kFwdBar = 32, kBwdBar = 64;  // words
constexpr unsigned long long kTimeoutNs = 60ull * 1000000000ull;

struct PeerTable {
  unsigned char* buf[kMaxRanks];  // by rank
};

__device__ __forceinline__ unsigned* words(unsigned char* buf, int off) {
  return reinterpret_cast<unsigned*>(buf) + off;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_relaxed_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_sys(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.sys.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel_gpu(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins until `reached()`; a wait past kTimeoutNs traps (the launch fails
// with an error instead of hanging the card on a peer that never comes).
template <typename F>
__device__ __forceinline__ void spin(F reached) {
  const unsigned long long t0 = now_ns();
  for (unsigned k = 1; !reached(); ++k)
    if ((k & 1023u) == 0 && now_ns() - t0 > kTimeoutNs) __trap();
}

// The barrier of one rank group's nb blocks over the rank's own memory: a
// count and a generation in the rank's buffer, the count back at 0 after
// each barrier. Each block's stores are fenced at device scope before it
// arrives (what goes to the peers is the exchange's to order); a waiting
// block polls the generation with relaxed loads and, once it has moved,
// reads it again with an acquire (cheaper than a fence, which also waits
// for the block's own stores).
__device__ __forceinline__ void rank_barrier(unsigned* bar, int nb) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    unsigned* count = bar;
    unsigned* gen = bar + 1;
    const unsigned g = ld_acquire_gpu(gen);
    __threadfence();
    if (atom_add_acq_rel_gpu(count, 1u) == static_cast<unsigned>(nb) - 1u) {
      *reinterpret_cast<volatile unsigned*>(count) = 0u;
      st_release_gpu(gen, g + 1u);
    } else {
      spin([&] { return ld_relaxed_gpu(gen) != g; });
      ld_acquire_gpu(gen);
    }
  }
  __syncthreads();
}

// One exchange of rank `me`, in place of a grid barrier. Each block fences
// its stores (to its own memory and its peers') at device scope and counts
// its arrival in the rank's `count` word (a barrier's count, which it
// leaves at 0); the last of the nb blocks to arrive has seen every arrival
// before it, and so every block's stores: one fence at system scope, then
// it raises this rank's flag to `target` at every rank, its own too (the
// fence and the flag stores a release at system scope, so the stores its
// arrivals carried are the peers' to see). Then every block polls the D
// ranks' flags with relaxed loads until they reach `target` and reads each
// once more with an acquire at system scope before it reads what they
// sent. No block waits for its rank's others at a barrier (its own rank's
// flag says they are done), only the last fences at system scope, and the
// waiters acquire by a load, not a fence (a fence.acq_rel would also wait
// for the block's own stores to reach system scope). Flags only rise:
// `target` is the host's base plus the exchange's index, so an earlier
// call's flags never satisfy a wait.
__device__ __forceinline__ void exchange(const PeerTable& peers, int me, int D,
                                         int flag, unsigned* count, int nb,
                                         unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    __threadfence();
    if (atom_add_acq_rel_gpu(count, 1u) == static_cast<unsigned>(nb) - 1u) {
      *reinterpret_cast<volatile unsigned*>(count) = 0u;
      fence_acq_rel_sys();
      for (int q = 0; q < D; ++q) st_relaxed_sys(words(peers.buf[q], flag) + me, target);
    }
    const unsigned* mine = words(peers.buf[me], flag);
    for (int q = 0; q < D; ++q) {
      spin([&] { return static_cast<int>(ld_relaxed_sys(mine + q) - target) >= 0; });
      ld_acquire_sys(mine + q);
    }
  }
  __syncthreads();
}

// The Step of K15's persistent windows at D ranks (fwd_mma.cuh's bf16
// window, lstm_tiled_f32.cuh's fp32 one) in place of their grid barrier:
// step t reads round(h_{t-1}) (B, N) in h's type HT from the rank's own
// slot (base + t) % 3 and stores its tile of round(h_t) into slot (base +
// t + 1) % 3, columns [me * nd, +nd), of every rank's buffer, its own too;
// then the exchange. The last step stores and exchanges nothing (a peer's
// next call may already hold its h0 in that slot). Three slots: a rank
// waits for every peer's flag of step t before step t + 1, so no rank
// writes a slot a peer still reads.
template <typename HT>
struct RankStep {
  const PeerTable& peers;
  int me, D, N, nd, S;
  unsigned long long base;
  long long h_off;
  size_t bN;        // B * N
  unsigned* count;  // the rank's forward barrier count
  int nb;
  __device__ __forceinline__ const HT* hin(int t) const {
    return reinterpret_cast<const HT*>(peers.buf[me] + h_off) + ((base + t) % 3) * bN;
  }
  __device__ __forceinline__ void put(int t, int b, int j, float h) const {
    if (t + 1 == S) return;  // the last step exchanges nothing
    const HT v = from_f32<HT>(h);
    const size_t at = ((base + t + 1) % 3) * bN + (size_t)b * N + (size_t)me * nd + j;
    for (int q = 0; q < D; ++q) reinterpret_cast<HT*>(peers.buf[q] + h_off)[at] = v;
  }
  __device__ __forceinline__ void sync(int t) const {
    exchange(peers, me, D, kFwdFlag, count, nb, static_cast<unsigned>(base + t + 1));
  }
};

// The group of this block: its index, its first block and its size.
template <typename G>
__device__ __forceinline__ int my_group(const G* g, int groups, int* nb) {
  int gi = 0;
  while (gi + 1 < groups && static_cast<int>(blockIdx.x) >= g[gi + 1].first) ++gi;
  *nb = (gi + 1 < groups ? g[gi + 1].first : static_cast<int>(gridDim.x)) - g[gi].first;
  return gi;
}

// The checks every D-rank launcher makes: groups and D within kMaxRanks,
// N = D * nd, each group a rank of its own below D with at least one block,
// and every block resident at once (the groups wait on each other, so a
// block that is not resident would never come); each launcher checks its
// own tiles. Fills first[] and the peer table; returns the blocks or a
// negative error.
inline int ranks_grid(int groups, const int* ranks, const int* blocks, int D,
                      void* const* bufs, int N, int nd, int resident,
                      int* first, PeerTable* peers) {
  if (groups < 1 || groups > kMaxRanks || D < 1 || D > kMaxRanks || N != D * nd)
    return -static_cast<int>(cudaErrorInvalidValue);
  int total = 0, seen = 0;
  for (int g = 0; g < groups; ++g) {
    if (ranks[g] < 0 || ranks[g] >= D || (seen >> ranks[g]) & 1 || blocks[g] < 1)
      return -static_cast<int>(cudaErrorInvalidValue);
    seen |= 1 << ranks[g];
    first[g] = total;
    total += blocks[g];
  }
  if (total > resident) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  for (int q = 0; q < kMaxRanks; ++q)
    peers->buf[q] = q < D ? static_cast<unsigned char*>(bufs[q]) : nullptr;
  return total;
}

// Each group's h0 (B, N) in the compute type into its rank's slot base %
// 3 (the forward launchers' first step; the stream orders it before the
// launch).
inline int copy_h0(int groups, const int* ranks, const void* const* h0,
                   const PeerTable& peers, long long h_off,
                   unsigned long long base, size_t hbytes, cudaStream_t stream) {
  for (int g = 0; g < groups; ++g) {
    // h0 into the rank's slot base % 3, which no peer writes before this
    // rank's flag of the call's second step
    const int err = static_cast<int>(cudaMemcpyAsync(
        peers.buf[ranks[g]] + h_off + (base % 3) * hbytes, h0[g], hbytes,
        cudaMemcpyDeviceToDevice, stream));
    if (err != 0) return err;
  }
  return 0;
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that a cooperative launch of `kernel` may hold at once on this card (its
// shared-memory limit raised to smem first), or an error code (none: too
// large).
template <typename K>
int resident_with(K kernel, int threads, size_t smem, int* resident) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *resident = sms * per_sm;
  return 0;
}

}  // namespace
