// The C launchers of the fp32 persistent reverse design that K6, K3, K12,
// K10 and K16 at D = 1 share (lstm_bwd_f32.cuh: the design, its kernels and its notes),
// bound from Python through ctypes (eigen_lstm_tpu_torch/ops/cuda_cell_bwd.py).
// Groups of G = 4 blocks are instantiated here, pairs (G = 2) in
// lstm_bwd_f32_pairs.cu, so that the two sets of kernels build in parallel.

#include "lstm_bwd_f32.cuh"

// lstm_bwd_f32_pairs.cu: launch_groups<2>, arguments as below less groups
extern "C" int lstm_bwd_f32_pairs_launch(
    int rtype, const void* U, const void* g_seq, const void* c_seq,
    const void* c0, const void* c_last, const void* dh_seq, const void* dhT,
    void* dc, void* dg, void* xbuf, void* dh0, int S, int B, int N, int stages,
    int steps, int standard, int drop_on, unsigned seed, unsigned keep,
    float inv, void* stream, int* launches);

// The persistent reverse launch under fp32 compute (K6, K3, K10, K16 at
// D = 1, and K12 with steps 2; ops/cuda_cell_bwd.py:k6_f32_plan): the S
// reverse steps and dh0 in one cooperative launch. U (N, 4N) fp32, read in
// place; the residual sequences in the residual type (rtype 0 fp32, 1
// bf16); c0, dh_seq, dhT fp32; c_last null, or (B, N) fp32 c_{S-1} read in
// place of c_seq[S-1] (K16: cT, with c_seq its c_prev advanced a step); dc
// holds dcT on entry and dc0 on return; dg receives the (S, B, 4N) fp32 dg
// sequence, dh0 (B, N) dg_0 @ U^T; xbuf, G x B x N floats, holds the
// groups' parts of dh_rec during the launch. groups: G, 2 or 4 blocks a
// group of 16 units, 4N / G a multiple of 64; stages: the ring's slots;
// steps: 1, or 2 (K12, S even: a pair's loads made together, K3's bits).
// 1 <= B <= 128. One cooperative launch, added to *launches.
extern "C" int lstm_bwd_f32_launch(
    int rtype, const void* U, const void* g_seq, const void* c_seq,
    const void* c0, const void* c_last, const void* dh_seq, const void* dhT,
    void* dc, void* dg, void* xbuf, void* dh0, int S, int B, int N, int groups,
    int stages, int steps, int standard, int drop_on, unsigned seed,
    unsigned keep, float inv, void* stream, int* launches) {
  if (B < 1 || B > kFMaxRows || S < 1 || N % 32 != 0 ||
      (groups != 2 && groups != 4) || (4 * N / groups) % kFKC != 0 ||
      (steps != 1 && steps != 2) || S % steps != 0 || xbuf == nullptr ||
      dh0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups == 4)
    return launch_groups<4>(rtype, U, g_seq, c_seq, c0, c_last, dh_seq, dhT,
                            dc, dg, xbuf, dh0, S, B, N, stages, steps,
                            standard, drop_on, seed, keep, inv, stream,
                            launches);
  return lstm_bwd_f32_pairs_launch(rtype, U, g_seq, c_seq, c0, c_last, dh_seq,
                                   dhT, dc, dg, xbuf, dh0, S, B, N, stages,
                                   steps, standard, drop_on, seed, keep, inv,
                                   stream, launches);
}

// Bytes of dynamic shared memory a block of the fp32 persistent design
// takes at batch B and hidden N, `groups` blocks a group, `stages` slots.
extern "C" size_t lstm_bwd_f32_smem_bytes(int B, int N, int groups, int stages) {
  return f32_smem_bytes(B, N, groups, stages);
}
