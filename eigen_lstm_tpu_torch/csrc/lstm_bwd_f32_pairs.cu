// The fp32 persistent reverse design (lstm_bwd_f32.cuh) in pairs of blocks
// (G = 2: hidden widths past 528 on an H100, the flagship's and K10's),
// apart from lstm_bwd_f32.cu so that the two sets of kernels build in
// parallel. lstm_bwd_f32_launch, which checks the arguments, calls it.

#include "lstm_bwd_f32.cuh"

extern "C" int lstm_bwd_f32_pairs_launch(
    int rtype, const void* U, const void* g_seq, const void* c_seq,
    const void* c0, const void* c_last, const void* dh_seq, const void* dhT,
    void* dc, void* dg, void* xbuf, void* dh0, int S, int B, int N, int stages,
    int steps, int standard, int drop_on, unsigned seed, unsigned keep,
    float inv, void* stream, int* launches) {
  return launch_groups<2>(rtype, U, g_seq, c_seq, c0, c_last, dh_seq, dhT, dc,
                          dg, xbuf, dh0, S, B, N, stages, steps, standard,
                          drop_on, seed, keep, inv, stream, launches);
}
