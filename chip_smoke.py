#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (``python3 chip_smoke.py``
from the root of the repository).

Phase 0  requires a CUDA device; prints the card's name and power limit.
Phase 1  builds the kernels (one nvcc per source, side by side, and one
         link) and prints the seconds.
Phase 2  runs each kernel against its plain PyTorch version on the card, at
         the eval path's shapes (N = 1024, M = 256, B = 16, S = 128) with the
         flagship's weights, in bf16 and fp32: every step of the window
         replayed by the plain version, the whole window, and the bf16
         residual type; prints errors, times, bounds and the cuDNN LSTM's
         time as a yardstick. K1 and K2 in bf16 take the persistent
         tensor-core forward (one launch a call, gated), in fp32 K8's and
         K9's fp32 persistent CUDA-core forward (one launch a call, gated);
         their per-step design, forced, is held to the same gates and timed
         in the same call.
Phase 3  the path: held-out bits/char of the 3x1024 flagship (bf16) through
         the kernels, with the launch counts reset before and read after
         (K1 one launch a chunk, K2 one a chunk and layer), and once more
         with K2's per-step design forced (one a step); then kernel against
         plain on a 4096-byte slice; the same for the 1x512 checkpoint;
         then ``cli eval`` of the 1x512 checkpoint at its defaults (fp32,
         100 000 bytes): K1 in its fp32 persistent design, one launch a
         chunk, against ``--backend plain`` (rel 2e-3), bits < 3.0.
Phase 4  the CLI's sample path: 1000-byte greedy and T = 0.7 samples of
         the flagship (bf16, B = 1) through ``sample_text``, so through the
         generation kernel K7 in its persistent design, its launches
         counted; the loop backend's bytes/s beside.
Phase 5  the training kernels (layer-0 backward, fused head forward and
         backward) against their plain versions at the bench's shapes
         (S = 100, B = 128, N = 512, M = 256) with the 1x512 checkpoint's
         weights, in fp32 and bf16: each reverse step of the backward
         replayed from the kernel's own state, the whole window, times,
         bounds and library yardsticks; K1 at the same shapes without and
         with dropout, gated as in phase 7a (in both types its persistent
         design with the batch split, one launch a call, beside the unsplit
         layout and the per-step design, both forced, in the same call, the
         persistent gated the faster than the per-step). K3
         (the fused VJP) without and with dropout 0.35: in bf16 its
         persistent design (one cooperative launch a window and a tensor-core
         dWU, its bf16 dg its fp32 dg rounded, bit for bit), in fp32 its
         persistent CUDA-core design (one cooperative launch a window, then
         dU, dW and db on CUDA cores), and, forced, its per-step design,
         which refused shapes keep, held to the same gates; the reverse
         launch and the tail (and dU alone) timed apart, the per-step
         design's call in the same run (the persistent must be the faster). K4 and K5 take their tensor-core designs in bf16
         (their CUDA-core designs, which fp32 takes, held to the same gates
         and timed in the same call; K5's launches a call gated). K4 in
         fp32 (its CUDA-core design: 64-row blocks, 8 x 8 register tiles, a
         cp.async ring) also at the flagship's T = 32768, N = 1024, each
         shape gated against its plain version and timed beside the
         library call, the plain version and the bound.
Phase 6  (a) one bible.txt window through loss_fn, loss and all five
         gradients through the kernels against the plain path, fp32 and
         bf16; (b) the port's bench (python -m eigen_lstm_tpu_torch.bench)
         at the root bench.py's schedule, its JSON line, train_bpc against
         the root bench's band (reported) and a sanity band (gated), the
         launch counts of the run against what its shapes give, and each
         kernel's share of the step; (c) 50 steps of the bench's Trainer
         in fp32 through the kernels, each step's loss and gradients held
         against the plain versions from the same state, K3's launches
         counted (its fp32 persistent design's) and K1's (one a call, its
         fp32 persistent design); (d) the bench's first six supersteps
         from the JAX bench's step-0 state
         (``artifacts/bench_jax_start/state0.npz``: the JAX PRNG's
         parameters, accumulators, cursors and stream state), and again
         with K4's CUDA-core design; then each of those supersteps' mean
         bits beside the JAX package's and the port's on the CPU from the
         same start (the committed trajectories), against the port's own
         order spread, and the first superstep past it (reported); (e)
         a 2x512 model in fp32 through the Trainer ``cli train`` builds at
         the bench's data configuration (``--dtype float32 --layers 2``),
         20 steps, each step's loss and gradients held against the plain
         versions from the same state, K2's, K3's and K6's launches counted
         (their fp32 persistent designs': K2 one a call), K2 on the model's
         layer 1 at these shapes against its plain replay, its per-step
         design forced, held to the same gates and timed in the same call
         beside cuDNN and the bound, then the median step time of the
         model, of the model with the per-step K2 and with the per-step
         K3/K6 forced and of the 1x512 bench in fp32, timed alike (K2 one
         launch a step).
Phase 7  the flagship's training (3x1024, S = 256, B = 128, dropout 0.35):
         (a) K1, K2, K3 and K6 (the layers >= 1 backward) against their
         plain versions with the flagship's weights, fp32 and bf16, without
         and with dropout: every step replayed, the masked streams against
         the numpy keep-mask bit for bit, the backward with explicit masks;
         times, bounds, cuDNN yardsticks; K1's and K2's design (the
         persistent one of each type, one launch a call; the per-step one
         and, for K1, the unsplit layout, forced, held to the same gates
         and timed in the same call; K1's bf16-residual run its fp32 run
         rounded); K3's (the GEMM fall-back) and K6's
         design (persistent in bf16, the CUDA-core persistent one in fp32)
         and launches a call, and the per-step design held to the same
         gates on the same inputs, the persistent design's reverse launch
         and tail timed apart beside its time (the persistent gated the
         faster); K5 against its plain version at T = 32768
         (printed) and the heads' times;
         (b) the flagship's loss and eleven gradients with dropout,
         kernels against plain, fp32 and bf16;
         (c) 100 steps of the flagship recipe through the CLI's Trainer
         from ckpt_best.npz's weights and accumulators: step time,
         chars/s, launches against what the shapes give, each kernel's
         share, the bits of every step; then 2 fp32 steps from the run's
         state, kernels against plain (fp32 at N = 1024 takes the tiled
         family, as in the JAX package: K8, K9, K10, their launches
         counted, K8 one a call in its fp32 persistent design), and both
         against the plain path in float64; then the fp32 flagship step
         time with K8 in each design (3 steps each, the mean of the last
         2). K3 runs the JAX VJP the flagship takes in bf16, the GEMM
         fall-back (db from the rounded dg).

Phase 8  generation: K7 against its plain version with the flagship's
         weights, fp32 and bf16, B = 1 and 128, T = 0 and 0.7, 256 tokens
         from primed states: every step replayed by the plain version from
         K7's own state and token (gated), a second call from the same
         state the same bits (gated), the free runs compared (printed); in
         both types its persistent design (gated; fp32's on CUDA cores,
         ``csrc/sampler_f32.cu``), and forced the first design and at B = 1
         the other product (bf16: mma or gemv; fp32: ffma), held to the
         same gates; 1000-token calls timed beside both terms of the bound
         (operations, and the weights read once at the memory rate), the
         plain version (one call), the first design in the same call (one
         window; the persistent design gated faster than it; the other
         product's and the loop backend's times, settled, not taken);
         ``sample_ids`` at B = 128 on the default backend, bf16 and fp32
         (one persistent launch each), and fp32 at B = 256 (one launch of
         the first design, which the plan keeps past 128 streams); ``cli
         sample`` of the flagship at its defaults (fp32, B = 1, T = 1, 1000
         bytes) and with ``--dtype bfloat16``: one persistent launch each,
         bytes/s of ``sample_text`` side by side.
Phase 9  the tiled-U regime (``scripts/run_configs.py`` 5b: 1x2048, B = 128,
         S = 100, bf16, bf16 residuals, enwik6): (a) K8, K9 and K10
         against their plain versions at those shapes, without and with
         dropout, and in fp32 at the flagship's fp32 shapes (S = 256,
         N = 1024): every step replayed, the masked streams against the
         numpy keep-mask bit for bit; K8, K9 and K10 in bf16 in their
         persistent design (one launch a call, gated; K10's bf16 dg its
         fp32 dg rounded, bit for bit) and, forced, their per-step one (S
         launches), both held to those gates; K10's dh0 and the
         tensor-core dU against the fp32 products; times of both designs
         beside the bound,
         the plain version, K1/K2/K6 at the same shapes (K6 on its
         per-step design in bf16, its fp32 persistent one in fp32, gated)
         and cuDNN, and at the eval batch of 16;
         K5 at the 5b shapes against its plain version (gated as in phase
         5) and beside its CUDA-core design;
         in fp32 K8 in its persistent CUDA-core design (one cooperative
         launch a window, gated) and, forced, its per-step one, both held
         to the same gates, the persistent design gated faster in the same
         call, also at the eval batch of 16; K9 and K10 per-step in fp32
         (gated); (b) one window's
         loss and all gradients of a 2x2048 model with dropout 0.35,
         kernels against plain (in fp32 K1, K3 and K6 take their per-step
         design, their launches counted, then K3 and K6 each held to its
         plain replay and timed on the model's layers at these shapes); (c) the
         5b recipe through the CLI's
         Trainer (its 200 warm-up steps at lr 0, then 100 at lr 0.005):
         step time, chars/s, the bits of each superstep, the launches
         against what the shapes give (K8 as many a step as one call of
         9a, K10 likewise), K8's and K10's shares of the step; then
         held-out bits/char of those
         weights on enwik6's last 1 % at eval batch 16 through K8 alone,
         one launch a window, kernels against plain.

Phase 10 the last two single-card kernels and the modules of this path:
         (a) the fused Adagrad K11 against its plain version on the
         flagship's weights and accumulators, 5b's and the bench's sets (m
         bit for bit, p within an ulp, one launch a call, the inputs
         unchanged, the outputs bit for bit those of its first call path,
         the forced control); its wrapper, the first call path's and
         ``torch._foreach_*`` timed in turns (A B C C B A, 10 rounds of 50
         calls; at the bench's set the wrapper must beat the first call
         path), its C launcher alone beside the bound and the plain
         version; then its share of 6b's bench step; (b) the two-step
         layer-0 backward K12 against K3 at the bench's shapes, B = 64 with
         fp32 residuals and B = 128 with bf16 residuals, bf16 (both in the
         persistent design) and fp32 (both in the CUDA-core persistent
         design, and forced both per-step, timed in the same call), dropout
         0 and 0.35: every output bit for bit; (c) the port's bench
         at the documented unroll-2 run's configuration (1x512, B = 64),
         with EIGEN_LSTM_BWD_UNROLL=2 (K12, never K3) and without (K3,
         never K12), K1 (16 rows a block) and K11 once a step, train_bpc
         equal; (d) ``cli train``
         at the bench's configuration with ``--crosscheck 50
         --gradcheck-every 100`` (0 failures), then ``Trainer.crosscheck``
         at phase 7c's flagship state; (e) the flagship's loss and eleven
         gradients in fp32 with scan_chunk = 64 against 0, with the peak
         device memory of both, K8's launches those its plan gives (one a
         call in fp32); (f) ``evaluate_ensemble_bpc`` of the
         flagship and the 1x512 checkpoint, kernels against plain, K1 one
         launch a chunk and member, K2 one a chunk and layer.
Phase 11 tensor parallelism on the one card (D = 1) through the four TP
         kernels: (a) K13 and K14 (the per-step pair) at the flagship's
         shapes as one shard of D = 1, 2 and 4 (K13 in bf16 on tensor
         cores, in fp32 the fp32 step of csrc/lstm_tp_step_f32.cu, its
         kernel and K14's alone timed beside the wrapper calls, and its
         CUDA-core design, forced, held to the same gate and timed in the
         same call; in fp32 at the bench's shapes a window of K13 steps
         K15's fp32 window bit for bit, and at D = 2 each shard the D = 1
         window's bits of its units; K14 in the design its plan gives at
         each shard, against its plain replay, dh_full against the plain
         product of its own round(dg): in bf16 its fused step, the gate
         backward with the rank's dh_full in one launch
         (csrc/lstm_tp_step_bwd.cu), beside its first design (the gate
         backward alone, then the product outside; forced) in the same
         call, its bound, the plain pair and the library pair, and faster
         alone than the first design's pair; in fp32 the first design,
         the plain pair and the library pair), K15 and K16 (the window
         pair) at the bench's, bf16 and fp32, against their plain versions
         with every step replayed (K15 within 1e-4, c_prev[0] = c0; its
         persistent design, in bf16 the tensor-core forward, in fp32 K9's
         CUDA-core kernel in K15's mode, beside its cooperative design and
         the unsplit layout, forced, held to the same gates and timed); K16
         on K6's persistent kernel of its type (one launch a call; in bf16
         its dg, dh0 and dc0 bit for bit K6's persistent reverse launch on
         the same inputs; in fp32 through lstm_bwd_f32_launch with c_last
         = cT), a call with bf16 residuals and its cooperative design
         (forced) held to the replay; in fp32 each persistent design faster
         than the cooperative one in the same call; times beside the bound,
         the plain version, ``torch.lstm_cell`` or cuDNN; then the D-rank
         cooperative kernels at D = 1 (one group) beside the D = 1
         cooperative kernels, bits, replay and times printed (whether the
         D = 1 kernels can go); (b) ``cli train --tp 1`` at the bench's configuration, 300
         steps, through K15/K16 and, with EIGEN_LSTM_TP_SEQ=0, K13/K14,
         launches counted, train_bpc against the single-device run's from
         the same seed (K13/K14 for 50 steps, against a single-device run
         of 50; K14 through its fused step), K15's, K16's and K13's shares
         of the step; (c) the flagship recipe
         at --tp 1 for 4 steps through K13/K14 (K14 fused; K13's share and
         the step beside its reading before K14's fused step), then
         one window's TP loss and eleven gradients, kernels against plain
         (the fp32 window's K13 and K14 launches counted, K14 all of its
         first design), then the fp32 window timed with K13 in its fp32
         step and, forced, its CUDA-core design (768 launches a window
         each; the window beside its earlier reading);
         (d) ``cli train --tp 1 --dtype float32`` at (b)'s configuration,
         300 steps, beside the single-device fp32 run: K15 and K16 once a
         step through their fp32 persistent launchers (counted at the
         library), K11 once a step, nothing else, train_bpc within 5e-2 of
         the single device's, the gap printed.
Phase 12 data parallelism at D = 1 on the paths of 11b, through
         ``cli train`` at the bench's configuration: (a) ``--dp 1
         --stream-data`` (the data group, NCCL's all-reduce and the mean;
         the single-device run's data path), its launches those of 11b's
         single-device run and its train_bpc within 1e-6 of it; (b) ``--dp
         1 --tp 1`` (the 2-D mesh and its two groups, the resident corpus
         read through the native IO library), the window family, K15, K16
         and K11 once a step and nothing else, train_bpc within 1e-6 of
         11b's ``--tp 1`` window-family run; step time and chars/s of both
         beside 11b's; (c) ``cli train --tp 1 --gradcheck-every 2``, the
         float64 shadow check on the canonical state, 0 failures.
Phase 13 sequence pipelining at D = 1 on the paths of 11b and 7c: (k)
         each kernel at a chunk's rows (B / C = 32) against its plain
         replay at the tolerances of 5, 7a and 9a: the bench's K1 and K3,
         the flagship's K1, K2, K3 and K6 in bf16 without dropout and at
         0.35 (K1's and K2's other designs too) and K8, K9 and K10 in
         fp32 (K8 in its persistent design, one launch a call), each
         design and its launches a call against the plans (K3 3 at the
         bench, 2 at the flagship, K6 3); (a) ``cli train --sp
         1`` at the bench's configuration with the batch in 4 and in 1
         microchunks (``--pp-chunks``): launches a step C times the plans'
         for a chunk (K1 1, K3 3) and K11 once, nothing else, one chunk
         rerun printed beside them; train_bpc in the sanity band, its gap
         to 11b's single device and both step times printed; K1's and K3's
         time a call at 32 and 128 rows; (b) ``--dp 1 --sp 1`` at C = 4:
         (a)'s launches and train_bpc within 1e-6; (c) ``--sp 1 --tp 1``
         (the torch-op TP scan, as the JAX tp_sp mesh takes its XLA scan),
         8 steps in supersteps of 4, a 4-step lr warm-up among them (the
         step time over the second superstep): K11 the only
         kernel, the bits finite and the last superstep's below the
         first's; (d) the flagship's bible.txt window (dropout 0) in 4
         chunks through ``sp_loss_and_grads`` against one device's
         ``loss_and_grads``, both through the kernels, launches against
         the plans: fp32 (the tiled family) against the whole batch, loss
         rel 1e-5 and each gradient 1e-4 of its largest magnitude; bf16
         against one device on each chunk's 32 rows, loss rel 1e-3 and
         each gradient within 2x its control (7b's rule; the bf16-value
         rule does not apply: a sum of chunks' bf16 gradients is not a
         bf16 value); bf16 against the fp32 whole batch: the top layer's
         h, the median stream's largest distance within 2x the plain
         path's, and the gradients over the plain path's drift printed
         for SP, the chunks, the whole batch and the chunks through K1's
         per-step design; K1's and K3's time a call at 32 and 128 rows;
         then 4 steps of the flagship recipe under ``--sp 1``: launches a
         step C times the plans' for a chunk (K1 1, K2 2, K3 2, K6 6), bits
         finite and below 3.0.
Phase 14 pipeline parallelism at S = 1, the stage's layers through the
         torch-op scan as the JAX stage mesh takes its XLA scan: (k) K11
         against its plain version on the stage-stacked ``PPParams`` sets
         the path updates, the bench's (W padded to 512 rows) and the
         flagship's (3 layers, W padded to 1024 rows, its accumulators),
         gated as in 10a; (a) ``cli train --pp 1`` at the bench's
         configuration with the window's sequence in 4 chunks, 16 steps in
         supersteps of 4, a 4-step lr warm-up among them: K11 once a step
         and no other kernel, the bits finite and the last superstep's
         below the first's, the step time over the last 12 steps beside
         11b's single device; (b) ``--dp 1 --pp 1``: (a)'s launches and
         bits within 1e-6; then (a) once more, its step time beside the
         two before (the host's drift between runs); (c) the flagship's bible.txt window (dropout 0)
         in 4 chunks through ``pp_loss_and_grads`` at S = 1 against one
         device's ``loss_and_grads`` with ``cell_fn=None``, fp32 and bf16,
         no kernel launched: the loss rel 1e-5, every gradient rtol 1e-4 /
         atol 1e-6 (tests/test_pp.py's), bf16's W of layers >= 1 and Why
         (each chunk's weight gradient rounded to bf16) within 5 half-ulps
         of bf16 of their largest entry; the largest differences printed.

Phase 15 K15 and K16 at D > 1 on the one card: the D-rank designs'
         device code, launched as D rank groups of one cooperative launch
         (``tp_seq_fwd_ranks``, ``tp_seq_bwd_ranks``; the peer table the
         card's D buffers), at the bench's shapes (1x512, S = 100, B =
         128, fp32 residuals) for D = 2 and 4 and at the flagship's layer
         shapes (N = 1024, S = 256) for D = 2, the weights through the TP
         gate permutation; the persistent designs the wrappers take (in
         bf16 the tensor-core ones, ``csrc/lstm_tp_persist.cu``; in fp32 the
         CUDA-core ones, ``csrc/lstm_tp_f32.cu``, ``lstm_tp_f32_bwd.cu``)
         and the cooperative ones forced. Each design: every
         rank's every step, forward and reverse, replayed from the
         kernel's own state (the 1e-4 of 11a); the forward bit for bit its
         D = 1 counterpart on the unpermuted weights (the persistent
         design with the D = 1 layout's rows, and every fp32 one, the D = 1
         persistent K15, the cooperative one the D = 1 cooperative design);
         10 calls on the same buffers and a lagging rank 0 (bf16
         persistent: a forward of one block row, replayed, and a backward of
         the fewest row blocks; fp32 persistent: a forward of one block row
         where the plan splits the batch; cooperative: one block, at the
         bench's shapes), each the first call's bits; times beside the
         bound (the inputs and outputs at the whole width; the exchange's
         bytes printed apart, with their time at NVLink's rate), the plain
         versions, cuDNN, the D = 1 cooperative design and the other
         design in the same call (the persistent must be faster). The fp32 windows at the
         bench's shapes against the D-rank plain versions (the rest
         printed beside the D = 1 design's own distance from its plain
         version); a buffer of the library's IPC allocator opened in a
         child process that loads the library with ctypes alone and
         writes a pattern the parent reads back; the launches and the
         launchers of one D-rank window in each persistent design and, at
         136 batch rows, which no persistent plan takes, the cooperative
         one (one each). Runs on several cards are not part of it.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Nothing
of JAX is imported. The build goes to ``eigen_lstm_tpu_torch/_build/``.

``python3 chip_smoke.py --gate-spread`` runs instead the gates that stand
near their noise (phase 3's flagship bits, 7b's bf16 gradients, 11b's
train_bpc gap) with K1 and K15 in three sum orders (their other design,
the persistent design unsplit, and split) and prints the spread.
``python3 chip_smoke.py --exchange`` runs phases 0, 1 and 15 alone,
``--tp-seq`` phases 0, 1, 11a, 11d and 15, ``--k2-k13`` phases 0, 1, 2,
6e, 11a and 11c (K2's and K13's designs), ``--k14`` phases 0, 1, 11a, 11b
and 11c (K14's designs),
``--k11`` phases 0, 1, 10a and 14k (K11 on its five sets) and the host's
pieces of K11's call,
``--tiled`` phases 0, 1 and 9a, ``--groups`` phases 0 and 1 and K3's fp32
persistent design at the bench's shapes with the other group width forced
(outputs against the plan's, reverse launches timed side by side).
``python3 chip_smoke.py --sp-spread`` reads 13d's bf16 gradients against
the fp32 whole batch on three flagship windows, as drawn and with the
streams that leave fp32 replaced, through the plain path, the kernels on
128 and 32 rows, SP and the kernels' other designs, and prints the spread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

LN2 = 0.6931471805599453
FLAGSHIP = "artifacts/flagship_drop/ckpt_best.npz"   # 3 x 1024, step 785000
H512 = "artifacts/bible_h512/ckpt.npz"               # 1 x 512, step 40000
CORPUS = "data/cantrbry/bible.txt"
EVAL_BATCH, CHUNK = 16, 128
PATH_CHARS, SLICE_CHARS = 100_000, 4096
DEVICE = "cuda"
BUDGET_S = 600.0        # half of the 1200 s a smoke run may take; aim: 300 s

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances of kernel against plain on the card, on h, c and g.
# Steps: every step of the kernel's own window launch is replayed by the
# plain version from the kernel's fp32 state at t-1. The arithmetic is the
# same, with its 1024-term fp32 sums taken in another order, and no rounding
# flip can build up from step to step; this is the gate in fp32 and bf16.
STEP_ATOL = 1e-4
# The whole 128-step window against the plain version's own run. fp32: those
# sums' rounding carried through 128 dependent steps, gated at 1e-4. bf16:
# one fp32 ulp in a sum can flip the bf16 rounding of h_{t-1} by one bf16
# ulp, and the trained layers carry the flip on chaotically, so the window's
# distance is printed beside how far bf16 moves the plain version from its
# own fp32 run ("bf16 drift") and gates nothing.
WINDOW_ATOL_F32 = 1e-4
# bits/char, kernel against plain on the card and against the JAX package
# on the CPU: a rounding flip moves the mean over 4096 bytes very little.
BPC_RTOL = 2e-3
# The JAX package's bits/char of these checkpoints on the same 4096-byte
# slice, bf16, Pallas kernels in interpret mode on the CPU
# (tests/test_torch_serve.py holds the port to them).
JAX_BPC = {FLAGSHIP: 2.276745, H512: 1.812555}

T0 = time.perf_counter()


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_budget(phase: str):
    elapsed = time.perf_counter() - T0
    print(f"[{phase} done at {elapsed:.1f} s]", flush=True)
    if elapsed > BUDGET_S:
        fail(f"over the {BUDGET_S:.0f} s budget after {phase}")


def cuda_ms(fn, reps: int, windows: int = 5) -> float:
    """Median over ``windows`` of the CUDA-event time of ``reps`` calls,
    per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def once_host_ms(fn) -> float:
    """The host-clock time of one call of ``fn`` between synchronisations:
    for paths whose host time is the point (the per-step TP family)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def once_ms(fn) -> float:
    """The CUDA-event time of one call of ``fn``, no warm-up: for plain
    versions, whose windows of PyTorch ops take tens of ms to seconds (a
    warm-up call and repeats bought the script's time, no gate)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase0() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)   # name, power limit: as nvidia-smi prints them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return smi


def phase1():
    from eigen_lstm_tpu_torch.ops import _build

    path = _build.build()
    secs = _build.build_seconds()
    print(f"build: {path} "
          + (f"nvcc {secs:.2f} s" if secs is not None else "already built"),
          flush=True)
    _build.load_library()


def flagship_cfg(dtype: str, residual: str = "float32"):
    from eigen_lstm_tpu_torch import ModelConfig

    return ModelConfig(hidden=1024, num_layers=3, compute_dtype=dtype,
                       residual_dtype=residual)


def max_err(a: torch.Tensor, b: torch.Tensor):
    d = (a.float() - b.float()).abs()
    rel = d / b.float().abs().clamp_min(1e-3)
    return float(d.max()), float(rel.max())


def bound(kind, cfg, s, b, n, m, train: bool = False, drop: bool = False):
    """Least time of one call's work on the card, ms: max(bytes / HBM rate,
    flops / peak rate for the compute type). bytes = U once + (W, b and
    the ids for layer 0 | the xw stream for layers >= 1) + h0, c0 + the
    outputs (h_seq in the residual type, hT and cT in fp32; for training
    also the c and g residuals, and with dropout the masked stream);
    flops = 2 S B N 4N for the recurrent products."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    rsz = torch.finfo(cfg.rdtype).bits // 8
    nbytes = n * 4 * n * csz + 4 * b * n * 4 + s * b * n * rsz
    if kind == "embed":
        nbytes += m * 4 * n * csz + 4 * n * 4 + s * b * 4
    else:
        nbytes += s * b * 4 * n * csz
    nbytes += s * b * n * rsz * ((5 if train else 0) + (1 if drop else 0))
    return _bound(nbytes, 2 * s * b * n * 4 * n, cfg)


def library_ms(in_dim, cfg, x, h0, c0):
    """One cuDNN ``torch.nn.LSTM`` call over the same window: the standard
    cell (not the reference's tanh-squashed carry) with the input product
    inside. A yardstick only; the port never calls it."""
    lstm = torch.nn.LSTM(in_dim, cfg.hidden).to(DEVICE, cfg.cdtype)
    lstm.flatten_parameters()
    xs, hs, cs = x.to(cfg.cdtype), h0[None].to(cfg.cdtype), c0[None].to(cfg.cdtype)
    try:
        with torch.no_grad():
            return cuda_ms(lambda: lstm(xs, (hs, cs)), reps=10)
    except RuntimeError as e:   # cuDNN may not take this type
        print(f"  library: nn.LSTM in {cfg.cdtype} refused: {e}", flush=True)
        return None


OUTPUTS = ("h_seq", "hT", "cT", "c_seq", "g_seq")


def _named(out):
    """(h_seq, (hT, cT), c_seq, g_seq) -> {name: tensor}."""
    return dict(zip(OUTPUTS, (out[0], out[1][0], out[1][1], out[2], out[3])))


def replay_steps(plain, layer, seq, h0, c0, cfg, out_k):
    """The plain version's single step from the kernel's own state at t-1
    (h0, c0 at t = 0), for every t of the window at once: the S steps run as
    one step of S*B rows. The kernel's sequences must be fp32, so that they
    hold its carry exactly."""
    s, b = seq.shape[:2]
    h_prev = torch.cat([h0[None], out_k["h_seq"][:-1]]).reshape(s * b, -1)
    c_prev = torch.cat([c0[None], out_k["c_seq"][:-1]]).reshape(s * b, -1)
    flat = seq.reshape(1, s * b, *seq.shape[2:])
    one = _named(plain(layer, flat, h_prev, c_prev, cfg, residuals=True))
    return {k: one[k][0].reshape(out_k[k].shape) for k in ("h_seq", "c_seq", "g_seq")}


def check_bf16_residuals(label, out_r, out_f):
    """A bf16-residual run of a forward kernel: its sequences in bf16, and
    every output the fp32-residual run's (the carry is fp32 whatever the
    residual type) rounded once to bf16, bit for bit."""
    flat = lambda out: [out[0], out[1][0], out[1][1]] + list(out[2:])
    for i, (got, ref) in enumerate(zip(flat(out_r), flat(out_f))):
        if i not in (1, 2) and got.dtype != torch.bfloat16:
            fail(f"{label}: bf16-residual output {i} in {got.dtype}")
        if not torch.equal(got.float(), ref.to(torch.bfloat16).float()):
            err = max_err(got, ref.to(torch.bfloat16))[0]
            fail(f"{label}: bf16-residual output {i} is not the fp32 run "
                 f"rounded to bf16 (max abs {err:.3e})")
    print(f"  {label}: bf16 residuals equal the fp32 run rounded to bf16 on "
          f"every output", flush=True)


def phase2(test, records):
    from eigen_lstm_tpu_torch.ops import cell as cell_ops
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.train.checkpoint import load_params
    from eigen_lstm_tpu_torch.train.evaluator import _build_streams

    x = _build_streams(test, EVAL_BATCH, CHUNK, PATH_CHARS)[0]
    ids = torch.from_numpy(x[:CHUNK].astype(np.int32)).to(DEVICE)
    s, b = ids.shape
    gen = torch.Generator().manual_seed(0)
    params = load_params(FLAGSHIP, flagship_cfg("float32"), DEVICE)
    l0, l1 = params.layers[0], params.layers[1]
    n, m = l0.U.shape[0], l0.W.shape[0]
    h0 = (torch.randn(b, n, generator=gen) * 0.1).to(DEVICE)
    c0 = (torch.randn(b, n, generator=gen) * 0.1).to(DEVICE)
    onehot = torch.nn.functional.one_hot(ids.long(), m).float()
    plain_f32 = {}
    for dtype in ("float32", "bfloat16"):
        cfg = flagship_cfg(dtype)
        h_l0 = cuda_cell.embed_layer0_plain(l0, ids, h0, c0, cfg)[0]
        xw = (cell_ops.matmul(h_l0.reshape(s * b, n), l1.W, cfg.cdtype)
              .reshape(s, b, 4 * n) + l1.b)
        cases = (
            ("lstm_fwd_embed", "embed", l0, ids, cuda_cell.embed_layer0,
             cuda_cell.embed_layer0_plain, "eigen_lstm_tpu/ops/pallas_cell.py:495",
             m, onehot),
            ("lstm_fwd_scan", "scan", l1, xw, cuda_cell.scan_layer,
             cuda_cell.scan_layer_plain, "eigen_lstm_tpu/ops/pallas_cell.py:184",
             n, h_l0.float()),
        )
        for name, kind, layer, seq, kern, plain, replaces, in_dim, lib_x in cases:
            before = kern.launches
            raw_k, out_k, step_err = eval_window_check(
                name, dtype, kern, plain, layer, seq, h0, c0, cfg)
            calls = kern.launches - before
            out_p = _named(plain(layer, seq, h0, c0, cfg, residuals=True))
            if dtype == "float32":
                plain_f32[name] = out_p
            window = []
            for label in OUTPUTS:
                abs_e, rel_e = max_err(out_k[label], out_p[label])
                window.append(f"{label} {abs_e:.3e} (rel {rel_e:.3e}")
                if cfg.cdtype == torch.float32:
                    window[-1] += ")"
                    if abs_e > WINDOW_ATOL_F32:
                        fail(f"{name} {dtype} window {label}: {abs_e:.3e} > "
                             f"{WINDOW_ATOL_F32:g}")
                else:
                    drift = max_err(out_p[label], plain_f32[name][label])[0]
                    window[-1] += f", drift {drift:.3e})"
            how = (f"atol {WINDOW_ATOL_F32:g}" if cfg.cdtype == torch.float32
                   else "not gated; drift: bf16 against fp32 of the plain "
                   "version")
            print(f"  {name} {dtype} window, max abs against plain ({how}): "
                  + ", ".join(window), flush=True)
            check_bf16_residuals(f"{name} {dtype}", kern(
                layer, seq, h0, c0, flagship_cfg(dtype, "bfloat16"),
                residuals=True), raw_k)
            # K1 and K2: the persistent design of each type, one launch a
            # call, and (forced) the per-step design, which refused shapes
            # keep, held to the same gates on the same inputs and timed in
            # this call
            design, persistent = (split_design if kind == "embed"
                                  else k2_design)(cfg, b, n)
            print(f"  {name} {dtype}: {design}", flush=True)
            if not persistent or calls != 1:
                fail(f"{name} {dtype}: {design}, {calls} launches a call; "
                     f"the eval shapes take the persistent design in both "
                     f"types, one launch a call")
            if persistent:
                with per_step_tiled(SPLIT_PLAN if kind == "embed" else K2_PLANS):
                    before = kern.launches
                    raw_s, _, err_s = eval_window_check(
                        name, dtype + " (the per-step design)", kern, plain,
                        layer, seq, h0, c0, cfg)
                    calls_s = kern.launches - before
                    check_bf16_residuals(f"{name} {dtype} (the per-step design)",
                                         kern(layer, seq, h0, c0,
                                              flagship_cfg(dtype, "bfloat16"),
                                              residuals=True), raw_s)
                    ms_s = cuda_ms(lambda: kern(layer, seq, h0, c0, cfg), reps=10)
                if calls_s != s:
                    fail(f"{name} {dtype}, the per-step design: {calls_s} "
                         f"launches a call, one a step gives {s}")
            ms = cuda_ms(lambda: kern(layer, seq, h0, c0, cfg), reps=10)
            plain_ms = once_ms(lambda: plain(layer, seq, h0, c0, cfg))
            bound_ms, bound_by = bound(kind, cfg, s, b, n, m)
            lib_ms = library_ms(in_dim, cfg, lib_x, h0, c0)
            print(f"  {name} {dtype}: {ms:.4f} ms per window per layer "
                  f"({calls} launch{'es' if calls > 1 else ''}), plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
                  f"cuDNN nn.LSTM "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  + (f"; the per-step design {ms_s:.4f} ms in this call "
                     f"({s} launches)" if persistent else ""), flush=True)
            rec = dict(
                name=name, route="cuda",
                source=(FWD_SOURCE if dtype == "bfloat16" else TILED_F32_SOURCE)
                if persistent else "eigen_lstm_tpu_torch/csrc/lstm_fwd.cu",
                replaces=replaces, launches=None, max_abs_err=step_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms,
            )
            records[(name, dtype)] = rec
            if persistent:
                records[(name + "_per_step", dtype)] = dict(
                    rec, name=name + "_per_step",
                    source="eigen_lstm_tpu_torch/csrc/lstm_fwd.cu",
                    max_abs_err=err_s, ms=ms_s)


def eval_window_check(name, tag, kern, plain, layer, seq, h0, c0, cfg):
    """A forward kernel's window with residuals: finite, and every step
    within STEP_ATOL of its plain replay from the kernel's own state.
    Returns (the raw output, the named output, the replay error)."""
    raw_k = kern(layer, seq, h0, c0, cfg, residuals=True)
    out_k = _named(raw_k)
    torch.cuda.synchronize()
    for label in OUTPUTS:
        if not torch.isfinite(out_k[label].float()).all():
            fail(f"{name} {tag} {label}: non-finite values")
    step_err = 0.0
    for label, ref in replay_steps(plain, layer, seq, h0, c0, cfg, out_k).items():
        err = max_err(out_k[label], ref)[0]
        step_err = max(step_err, err)
        if err > STEP_ATOL:
            fail(f"{name} {tag} {label}: a step of the window is {err:.3e} "
                 f"from its plain replay > {STEP_ATOL:g}")
    print(f"  {name} {tag}: all {seq.shape[0]} steps of the window within "
          f"{step_err:.3e} of their plain replay (atol {STEP_ATOL:g})",
          flush=True)
    return raw_k, out_k, step_err


def eval_check(path, cfg, test, label):
    """Path run at PATH_CHARS through the kernels, then kernel against
    plain on SLICE_CHARS. Returns the launch counts of the path run and
    its number of chunks, after gating K1's: one a chunk in its
    persistent design, one a step in the other."""
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.train.checkpoint import load_params
    from eigen_lstm_tpu_torch.train.evaluator import _build_streams, evaluate_bpc

    params = load_params(path, cfg, DEVICE)
    kern = select_cell_fn("auto", cfg, EVAL_BATCH, DEVICE)
    plain = select_cell_fn("plain", cfg, EVAL_BATCH, DEVICE)
    torch.cuda.synchronize()
    cuda_cell.reset_launches()
    t0 = time.perf_counter()
    bpc = evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, PATH_CHARS, kern)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = cuda_cell.launches()
    chars = min(PATH_CHARS, len(test) - 1)
    print(f"  {label} eval {chars} chars: bpc {bpc:.6f}, {chars / dt:.1f} "
          f"chars/s ({dt:.3f} s), launches embed {counts[0]} scan {counts[1]}",
          flush=True)
    if not np.isfinite(bpc) or bpc >= 3.0:
        fail(f"{label}: bpc {bpc} not below 3.0")
    want = (1, 1) if cfg.num_layers > 1 else (1, 0)
    for have, need, kname in zip(counts, want, ("embed", "scan")):
        if need and have <= 0:
            fail(f"{label}: the {kname} kernel was not launched on the path")
    chunks = _build_streams(test, EVAL_BATCH, CHUNK, PATH_CHARS)[-1]
    design, persistent = split_design(cfg, EVAL_BATCH, cfg.hidden)
    k1 = chunks * (1 if persistent else CHUNK)
    print(f"  {label}: K1 in {design}: {counts[0]} launches (the path's "
          f"{chunks} chunks give {k1})", flush=True)
    if counts[0] != k1:
        fail(f"{label}: K1 launched {counts[0]} times, the path gives {k1}")
    bpc_k = evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, SLICE_CHARS, kern)
    bpc_p = evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, SLICE_CHARS, plain)
    rel_p = abs(bpc_k - bpc_p) / bpc_p
    rel_j = abs(bpc_k - JAX_BPC[path]) / JAX_BPC[path]
    print(f"  {label} {SLICE_CHARS} chars: kernel {bpc_k:.6f} plain "
          f"{bpc_p:.6f} (rel {rel_p:.2e}), JAX on the CPU {JAX_BPC[path]} "
          f"(rel {rel_j:.2e}), rtol {BPC_RTOL:g}", flush=True)
    if rel_p > BPC_RTOL or rel_j > BPC_RTOL or bpc_k >= 3.0:
        fail(f"{label}: {SLICE_CHARS}-char bpc out of tolerance")
    return counts, chunks, bpc_k


def cli_eval_fp32(test):
    """``cli eval`` of the 1x512 checkpoint at its defaults (fp32 compute,
    eval batch 16, 100 000 held-out bytes), so K1 in its fp32 persistent
    design, one launch a chunk (K1's launches reset before and read
    after); the same command with ``--backend plain`` beside it: bits/char
    within BPC_RTOL, below 3.0. Returns K1's launches."""
    import io

    from eigen_lstm_tpu_torch import ModelConfig, cli
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.train.evaluator import _build_streams

    argv = ["eval", "--ckpt", H512, "--data", CORPUS]
    res = {}
    for backend in ("auto", "plain"):
        buf = io.StringIO()
        torch.cuda.synchronize()
        cuda_cell.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + ["--backend", backend])
        torch.cuda.synchronize()
        bpc = json.loads(buf.getvalue().strip().splitlines()[-1])["test_bpc"]
        res[backend] = (bpc, time.perf_counter() - t0, cuda_cell.launches()[0])
    cfg = ModelConfig(hidden=512, num_layers=1, compute_dtype="float32")
    chunks = _build_streams(test, EVAL_BATCH, CHUNK, PATH_CHARS)[-1]
    design, persistent = split_design(cfg, EVAL_BATCH, cfg.hidden)
    (bpc, dt, k1), (bpc_p, dt_p, k1_p) = res["auto"], res["plain"]
    rel = abs(bpc - bpc_p) / bpc_p
    print(f"  cli eval bible_h512 (its defaults: fp32, {PATH_CHARS} bytes): "
          f"bpc {bpc:.6f} in {dt:.3f} s ({PATH_CHARS / dt:,.0f} bytes/s, the "
          f"checkpoint's load included), --backend plain {bpc_p:.6f} in "
          f"{dt_p:.3f} s (rel {rel:.2e}, rtol {BPC_RTOL:g}); K1 in {design}: "
          f"{k1} launches (the path's {chunks} chunks give {chunks}), plain {k1_p}",
          flush=True)
    if not persistent or k1 != chunks or k1_p != 0:
        fail(f"cli eval fp32: K1 in {design}, launched {k1} and {k1_p} times; "
             f"its fp32 persistent design gives one a chunk ({chunks}), the "
             f"plain backend none")
    if rel > BPC_RTOL or not bpc < 3.0:
        fail(f"cli eval fp32: bpc {bpc} against plain {bpc_p} out of tolerance")
    return k1


def phase3(test):
    """The eval path of both checkpoints; K1 in its persistent design (one
    launch a chunk, both checkpoints), the flagship's K2 in its persistent
    design (one launch a chunk and layer), then once more with K2's
    per-step design forced (one a step); then ``cli eval`` of the 1x512
    checkpoint at its default fp32 (``cli_eval_fp32``). Returns the launch
    counts of the first flagship run, K2's launches in the forced one and
    K1's in the fp32 ``cli eval``."""
    from eigen_lstm_tpu_torch import ModelConfig

    cfg = flagship_cfg("bfloat16")
    label = "flagship 3x1024 bf16"
    counts, chunks, _ = eval_check(FLAGSHIP, cfg, test, label)
    with per_step_tiled(K2_PLANS):
        step_counts = eval_check(FLAGSHIP, cfg, test,
                                 label + " (K2's per-step design, forced)")[0]
    upper = cfg.num_layers - 1
    design, persistent = k2_design(cfg, EVAL_BATCH, cfg.hidden)
    want = (chunks * upper, chunks * upper * CHUNK)
    print(f"  {label}: K2 in {design}: {counts[1]} launches, forced per-step "
          f"{step_counts[1]} (the shapes give {want[0]} and {want[1]})",
          flush=True)
    if not persistent or (counts[1], step_counts[1]) != want \
            or step_counts[0] != counts[0]:
        fail(f"{label}: K2 launched {counts[1]} and {step_counts[1]} times "
             f"(persistent, per-step), the path gives {want}; K1 "
             f"{counts[0]} and {step_counts[0]}")
    eval_check(H512, ModelConfig(hidden=512, num_layers=1,
                                 compute_dtype="bfloat16"),
               test, "bible_h512 1x512 bf16")
    return counts, step_counts[1], cli_eval_fp32(test)


SAMPLE_CHARS, LOOP_CHARS = 1000, 200


def phase4():
    """The CLI's ``sample`` path: ``sample_text`` of the flagship (bf16,
    B = 1, the default backend, so K7 in its persistent design), greedy
    and at T = 0.7, with K7's launch counts reset before and read after;
    the ``"loop"`` backend's bytes/s from the same start beside it. Returns
    the persistent design's launches."""
    from eigen_lstm_tpu_torch.models import lstm as model
    from eigen_lstm_tpu_torch.models.sampler import sample_ids, sample_text
    from eigen_lstm_tpu_torch.ops import cuda_sampler
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    cfg = flagship_cfg("bfloat16")
    params = load_params(FLAGSHIP, cfg, DEVICE)
    h, c = model.init_state(cfg, 1, device=DEVICE)
    first = torch.tensor([10], device=DEVICE)
    torch.cuda.synchronize()
    cuda_sampler.generate.launches = 0
    cuda_sampler.generate.persistent_launches = 0
    for temp in (0.0, 0.7):
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        t0 = time.perf_counter()
        text = sample_text(params, cfg, gen, SAMPLE_CHARS, temperature=temp)
        dt = time.perf_counter() - t0
        if len(text) != SAMPLE_CHARS:
            fail(f"sample at T={temp}: {len(text)} chars, expected "
                 f"{SAMPLE_CHARS}")
        t0 = time.perf_counter()
        sample_ids(params, cfg, gen, first, h, c, LOOP_CHARS, temp,
                   backend="loop")
        torch.cuda.synchronize()
        dt_loop = time.perf_counter() - t0
        print(f"  sample T={temp}: {SAMPLE_CHARS / dt:,.1f} bytes/s through "
              f"K7 ({SAMPLE_CHARS} bytes in {dt:.3f} s); the loop backend "
              f"{LOOP_CHARS / dt_loop:,.1f} bytes/s; {text[:60]!r}",
              flush=True)
    launches = cuda_sampler.generate.launches
    persistent = cuda_sampler.generate.persistent_launches
    print(f"  sample_text launched K7 {launches} times, {persistent} in its "
          f"persistent design ({gen_design(cfg, 1)[0]})", flush=True)
    if launches != 2 or persistent != 2:
        fail(f"sample_text launched K7 {launches} times, {persistent} in its "
             f"persistent design; expected 2 and 2")
    return persistent


# --- the training path (bench shapes: S = 100, B = 128, N = 512, M = 256) ---
TRAIN_S, TRAIN_B = 100, 128
# Training kernels against their plain versions, as a share of the largest
# magnitude of the plain output ("normalised error"). Each check replays the
# kernel's own state, so only the order of fp32 sums differs: 1e-4, in fp32
# and bf16, on every fp32 output. The head's dh is stored in bf16 under bf16
# compute: one ulp there is 2^-8, so its bf16 gate is two ulps.
TRAIN_TOL = 1e-4
# K3, K6, K12 and, in bf16, K16: the persistent kernel and the per-step one;
# in fp32 their persistent reverse launch (its tail in lstm_bwd.cu)
BWD_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_bwd.cu"
BWD_F32_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_bwd_f32.cu"
DH_BF16_TOL = 2.0 ** -7
# Phase 6a, the loss and gradients of one window through the kernels
# against the plain path: fp32 rel 1e-5 on the loss, 1e-4 normalised on
# each gradient. bf16: a flip of a bf16 rounding in the forward or backward
# recurrence moves everything after it; sound kernels read 3e-3 to 5e-3
# normalised there, a path that lost the bf16 roundings reads as far as the
# plain path's own fp32 run (2.8e-2 to 9.3e-2, "bf16 drift", the control).
# So each bf16 gradient is gated at 1e-2, which the control must exceed,
# and the loss within rel 1e-3. The JAX custom VJPs hand dW, dU and dWhy
# back rounded to bf16 (pallas_cell.py:1039, pallas_head.py:195) and db,
# dby not: on both paths those three must be bf16 values and these two not,
# so a dropped or an extra rounding in the autograd functions, which both
# paths share, fails.
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL_BF16 = 1e-2
BF16_ROUNDED = ("params.layers[0].W", "params.layers[0].U", "params.Why")
# Phase 6b, the bench's train_bpc: gated inside the JAX bench's own sanity
# band (eigen_lstm_tpu/bench.py:86; a silent math fault shows as ~8 bits or
# non-finite); the root bench's band (2.40, 2.70), ``bench.BPC_BAND``, is
# printed with the verdict, which the port's H100 runs do not meet (PERF.md).
SANITY_BAND = (1.5, 4.5)
# Phase 6c, 50 steps of the bench's Trainer in fp32 (20 at lr 0, then 30
# Adagrad updates) through the kernels; at each step the loss and the five
# gradients through the plain versions from the kernel run's own state, at
# phase 6a's fp32 tolerances. A second run through the plain versions alone
# is printed, not gated: Adagrad's first updates, with an accumulator of
# ~1e-9, carry a 1e-7 difference in the gradients to 1e-1 in the
# parameters within 100 steps, while the bits stay within ~1e-5.
TRAJ_STEPS = 50   # 100 once; cut for the script's time


def norm_err(a, b) -> float:
    """max |a - b| over max |b|."""
    b = b.float()
    return float((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30))


def train_cfg(dtype: str):
    from eigen_lstm_tpu_torch import ModelConfig

    return ModelConfig(hidden=512, num_layers=1, compute_dtype=dtype,
                       loss_mode="all")


def bible_window(gen, s, b):
    """(x, t) of S+1 bytes of the training split of bible.txt at cursors
    drawn from ``gen``, on the card."""
    return corpus_window(CORPUS, 0.95, gen, s, b)


def corpus_window(path, train_percent, gen, s, b):
    """(x, t) of S+1 bytes of a corpus's training split at cursors drawn
    from ``gen``, on the card."""
    from eigen_lstm_tpu_torch.data.corpus import make_windows, rawread, split

    train = split(rawread(path), train_percent)[0]
    pos = torch.randint(0, len(train) - s - 1, (b,), generator=gen,
                        dtype=torch.int32).to(DEVICE)
    return make_windows(torch.from_numpy(train).to(DEVICE), pos, s)


def k3_bound(cfg, s, b, n, m):
    """K3's least time, ms: bytes = U + the g, c, h residuals + ids + h0,
    c0, dhT, dcT + the dh_seq cotangent + dWU, db, dh0, dc0; flops =
    2*S*B*4N*N for dg @ U^T plus as many for dU. The one-hot product
    (dW[ids] += dg) is a gather-add and counts no flops."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    rsz = torch.finfo(cfg.rdtype).bits // 8
    nbytes = (n * 4 * n * csz + s * b * 6 * n * rsz + s * b * 4
              + 4 * b * n * 4 + s * b * n * 4 + (m + n) * 4 * n * 4
              + 4 * n * 4 + 2 * b * n * 4)
    flops = 2 * (2 * s * b * 4 * n * n)
    return _bound(nbytes, flops, cfg)


def head_bound(cfg, t, n, m, backward: bool):
    """K4/K5's least time, ms: bytes = h, Why, by, targets, lse (+ the
    cotangent, dh, dWhy and dby backward); flops = 2*T*N*M for the logits
    (three such products backward: logits, dh, dWhy). The softmax's
    exponentials are not counted."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    nbytes = t * n * csz + n * m * csz + m * 4 + t * 4 + t * 4
    flops = 2 * t * n * m
    if backward:
        nbytes += 4 + t * n * csz + n * m * 4 + m * 4
        flops *= 3
    else:
        nbytes += 4
    return _bound(nbytes, flops, cfg)


def _bound(nbytes, flops, cfg):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[cfg.cdtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reverse_replay(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg, dg_k):
    """The plain arithmetic of every reverse step from the kernel's own
    dg_{t+1}: dh_rec = round(dg_{t+1}) @ U^T, then the gate backward with
    the fp32 dc chain (which no rounding touches). dh_seq is the cotangent
    as the step adds it (masked already, under dropout). Returns the plain
    dg sequence, dh0 and dc0."""
    from eigen_lstm_tpu_torch.ops import cell as cell_ops

    s = g_seq.shape[0]
    f32 = torch.float32
    rnd = lambda x: x.to(cfg.cdtype).to(f32)
    Uf = U_c.to(f32)
    dh_rec = torch.cat([rnd(dg_k[1:]) @ Uf.T, dhT[None]])
    dc = dcT
    dgs = [None] * s
    for t in reversed(range(s)):
        c_prev = c_seq[t - 1] if t > 0 else c0
        dgs[t], dc = cell_ops.gate_bwd(
            g_seq[t].to(f32), c_seq[t].to(f32), c_prev.to(f32),
            dh_seq[t] + dh_rec[t], dc, cfg.hidden, cfg.cell_variant)
    return torch.stack(dgs), rnd(dg_k[0]) @ Uf.T, dc


def k3_replay(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq, dhT, dcT, cfg,
              dg_k, fused_accum=True):
    """``reverse_replay``, then the weight gradients over the kernel's dg:
    (dg sequence, dh0, dc0, dWU, db). Without ``fused_accum`` (the JAX
    GEMM fall-back) h_{-1} is h0 in the residual type and db sums dg
    rounded to the xw type."""
    s, b = ids.shape
    n = cfg.hidden
    f32 = torch.float32
    rnd = lambda x: x.to(cfg.cdtype).to(f32)
    flat = rnd(dg_k).reshape(s * b, 4 * n)
    h_m1 = h0 if fused_accum else h0.to(cfg.rdtype).to(f32)
    h_prev = torch.cat([h_m1[None], h_seq[:-1].to(f32)]).reshape(s * b, n)
    dW = torch.zeros(cfg.vocab, 4 * n, dtype=f32, device=flat.device)
    dW.index_add_(0, ids.reshape(-1).long(), flat)
    dWU = torch.cat([dW, rnd(h_prev).T @ flat])
    dg_db = dg_k if fused_accum else rnd(dg_k)
    return reverse_replay(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg,
                          dg_k) + (dWU, dg_db.reshape(s * b, 4 * n).sum(0))


def k6_replay(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq, dhT, dcT, cfg, dg_k):
    """``reverse_replay``, then dU over the kernel's dg, with h_{-1}
    rounded to the residual type: (dg sequence, dh0, dc0, dU)."""
    s, b, n = h_seq.shape
    f32 = torch.float32
    rnd = lambda x: x.to(cfg.cdtype).to(f32)
    h_prev = torch.cat([h0.to(cfg.rdtype)[None], h_seq[:-1]]).to(f32)
    dU = rnd(h_prev.reshape(s * b, n)).T @ rnd(dg_k.reshape(s * b, 4 * n))
    return reverse_replay(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg,
                          dg_k) + (dU,)


def k6_bound(cfg, s, b, n):
    """K6's least time, ms: bytes = U + the g, c, h residuals + h0, c0,
    dhT, dcT + the dh_seq cotangent + dg_seq (xw type) + dU, dh0, dc0;
    flops = 2*S*B*4N*N for dg @ U^T plus as many for dU."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    rsz = torch.finfo(cfg.rdtype).bits // 8
    nbytes = (n * 4 * n * csz + s * b * 6 * n * rsz + 4 * b * n * 4
              + s * b * n * 4 + s * b * 4 * n * csz + n * 4 * n * 4
              + 2 * b * n * 4)
    return _bound(nbytes, 2 * (2 * s * b * 4 * n * n), cfg)


def k6_design(cfg, b, n):
    """The design K6, K3 and K12 take at these shapes on this card, as
    their wrappers choose it (``cuda_cell_bwd.k6_plan`` in bf16,
    ``k6_f32_plan`` in fp32): a label, and whether it is persistent."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_bwd import (device_k6_f32_plan,
                                                        device_k6_plan)

    plan = device_k6_plan(cfg, b, n)
    if plan is not None:
        units, rows = plan
        groups, parts = n // units, -(-b // rows)
        return (f"the persistent design ({groups} groups of {units} units x "
                f"{parts} parts of {rows} batch rows = {groups * parts} "
                f"blocks, one cooperative launch a window)"), True
    layout = device_k6_f32_plan(cfg, b, n)
    if layout is not None:
        groups = n // 16
        return (f"the fp32 persistent design ({groups} groups of 16 units x "
                f"{layout.blocks} blocks = {groups * layout.blocks} blocks, "
                f"{layout.rows} product rows a thread, {layout.stages} ring "
                f"slots, one cooperative launch a window, then the CUDA-core "
                f"tail)"), True
    return "the per-step design (one launch a reverse step)", False


def bwd_f32_launches(cfg, s, b, m):
    """K3's (``m`` the vocabulary) or K6's (``m`` 0) launches a call in
    the fp32 persistent design: the reverse launch, dU (and the sum of its
    splits where it splits), and for K3 dW and db's two."""
    n = cfg.hidden
    return 2 + (atb_splits(s * b, n, 4 * n) > 1) + (3 if m else 0)


def persist_split_ms(call, counter, cfg, reps: int = 5):
    """The persistent design's reverse launch and its weight-gradient
    launches (K6's dU, K3's dWU, and in fp32 K3's db: the tail), each
    timed by CUDA events around its C launcher within the wrapper's calls
    (``launchers_ms``); then the per-step design's whole call on the same
    inputs (the wrapper's choice overridden here only) and its launches,
    read from ``counter``, the wrapper. Returns (reverse ms, tail ms,
    per-step ms, per-step launches), medians."""
    names = (("lstm_bwd_persist_launch", "lstm_bwd_dWU_launch")
             if cfg.cdtype == torch.bfloat16
             else ("lstm_bwd_f32_launch", "lstm_bwd_tail_launch"))
    rev, tail = launchers_ms(call, names, reps)
    with per_step_k6():
        before = counter.launches
        call()
        launched = counter.launches - before
        per_step = cuda_ms(call, reps=1, windows=3)
    return rev, tail, per_step, launched


def launchers_ms(call, names, reps: int = 5):
    """The median time of each C launcher of ``names`` within ``reps``
    calls of ``call`` (after one call to warm up), CUDA events around
    it."""
    from eigen_lstm_tpu_torch.ops import _build

    lib = _build.load_library()
    real = {nm: getattr(lib, nm) for nm in names}
    events = {nm: [] for nm in names}

    def timed(nm):
        def launch(*a):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            err = real[nm](*a)
            e1.record()
            events[nm].append((e0, e1))
            return err
        return launch

    call()
    torch.cuda.synchronize()
    try:
        for nm in names:
            setattr(lib, nm, timed(nm))
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    finally:
        for nm in names:
            setattr(lib, nm, real[nm])
    return tuple(statistics.median(a.elapsed_time(b) for a, b in events[nm])
                 for nm in names)


@contextlib.contextmanager
def per_step_k6():
    """K6's, K3's and K12's wrappers take their per-step design inside the
    block, and K16's its cooperative one, whatever ``k6_plan`` and
    ``k6_f32_plan`` would choose: for the checks and times of that design
    where the main path takes a persistent one."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_bwd

    plans = cuda_cell_bwd.device_k6_plan, cuda_cell_bwd.device_k6_f32_plan
    cuda_cell_bwd.device_k6_plan = lambda *a: None
    cuda_cell_bwd.device_k6_f32_plan = lambda *a: None
    try:
        yield
    finally:
        cuda_cell_bwd.device_k6_plan, cuda_cell_bwd.device_k6_f32_plan = plans


@contextlib.contextmanager
def kept_dgx():
    """A list that receives, inside the block, every bf16 dg sequence the
    persistent design writes, so that a check can hold it to the fp32 dg of
    the same call."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_bwd

    new, kept = cuda_cell_bwd._new_dgx, []

    def keep(*a):
        kept.append(new(*a))
        return kept[-1]

    cuda_cell_bwd._new_dgx = keep
    try:
        yield kept
    finally:
        cuda_cell_bwd._new_dgx = new


def library_lstm_bwd(cfg, x, h0, c0, dh_seq):
    """One cuDNN ``torch.nn.LSTM`` backward over the same window (the
    standard cell, with the input product and its weight gradient); a
    yardstick only, the port never calls it."""
    lstm = torch.nn.LSTM(x.shape[-1], cfg.hidden).to(DEVICE, cfg.cdtype)
    lstm.flatten_parameters()
    xs = x.to(cfg.cdtype).requires_grad_()
    hs = h0[None].to(cfg.cdtype).requires_grad_()
    cs = c0[None].to(cfg.cdtype).requires_grad_()
    try:
        y, _ = lstm(xs, (hs, cs))
        gy = dh_seq.to(cfg.cdtype)
        ins = [xs, hs, cs] + list(lstm.parameters())
        return cuda_ms(lambda: torch.autograd.grad(y, ins, gy, retain_graph=True),
                       reps=5)
    except RuntimeError as e:   # cuDNN may not take this type
        print(f"  library: nn.LSTM backward in {cfg.cdtype} refused: {e}",
              flush=True)
        return None


def phase5(records):
    """K3, K4, K5 against their plain versions at the bench shapes, with
    the 1x512 checkpoint's weights, in fp32 and bf16; K3 without and with
    dropout, in bf16 in both its designs; K1's time at the same shapes for
    the step breakdown."""
    from eigen_lstm_tpu_torch.ops import cuda_cell, head
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    s, b = TRAIN_S, TRAIN_B
    per_call = {}
    mask = host_masks(FLAG_SEEDS[0], s, b, train_cfg("float32").hidden, FLAG_DROP)
    inv = torch.tensor(float(np.float32(1.0 / (1.0 - FLAG_DROP))), device=DEVICE)
    for dtype in ("float32", "bfloat16"):
        cfg = train_cfg(dtype)
        n, m = cfg.hidden, cfg.vocab
        gen = torch.Generator().manual_seed(5)
        params = load_params(H512, cfg, DEVICE)
        layer = params.layers[0]
        x, tgt = bible_window(gen, s, b)
        rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd).to(DEVICE)
        h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
        onehot = torch.nn.functional.one_hot(x.long(), m).float()
        # --- K1 at these shapes, without and with dropout: its persistent
        # design (the batch split, one launch a call) and, in this call,
        # the unsplit layout and the per-step design (forced)
        k1_lib = library_ms(m, cfg, onehot, h0, c0)
        for drop in (0.0, FLAG_DROP):
            tag = f"{dtype} drop {drop:g}"
            dr = (drop, FLAG_SEEDS[0]) if drop else None
            out, rec = fwd_check("lstm_fwd_embed", "embed", cuda_cell.embed_layer0,
                                 cuda_cell.embed_layer0_plain, layer, x, h0, c0,
                                 cfg, dr, mask, inv, tag, per_call)
            k1_designs(layer, x, h0, c0, cfg, dr, mask, inv, tag, out, rec,
                       per_call["lstm_fwd_embed"])
            rec.update(replaces=REPLACES["lstm_fwd_embed"], library_ms=k1_lib)
            print(f"  lstm_fwd_embed {tag}: {rec['ms']:.4f} ms per window "
                  f"({per_call['lstm_fwd_embed']} launches), plain "
                  f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
                  f"({rec['bound_by']}), cuDNN nn.LSTM "
                  f"{'n/a' if k1_lib is None else f'{k1_lib:.4f} ms'}"
                  + design_times(rec, s), flush=True)
            records[("5", "lstm_fwd_embed", dtype, drop)] = rec
            if not drop:
                fwd = out
        h_seq = fwd[0]
        k1_ms = records[("5", "lstm_fwd_embed", dtype, 0.0)]["ms"]
        # --- K3, in the fused VJP the bench takes, without and with
        # dropout; in bf16 both designs
        dh_seq = rand(s, b, n, sd=1e-3)
        dhT, dcT = rand(b, n, sd=1e-3), rand(b, n, sd=1e-3)
        lib_ms = library_lstm_bwd(cfg, onehot, h0, c0, dh_seq)
        design, persistent = k6_design(cfg, b, n)
        if not persistent:
            fail(f"lstm_bwd_embed {dtype}: {design}; the bench's shapes take "
                 f"a persistent design in both types")
        for drop in (0.0, FLAG_DROP):
            tag = f"{dtype} drop {drop:g}"
            dr = (drop, FLAG_SEEDS[0]) if drop else None
            rec = bwd_check("lstm_bwd_embed", layer.U, fwd, x, h0, c0, dh_seq,
                            dhT, dcT, cfg, dr, mask, inv, tag, per_call)
            rec.update(replaces="eigen_lstm_tpu/ops/pallas_cell.py:556",
                       library_ms=lib_ms)
            rec.update(other_designs("lstm_bwd_embed", layer.U, fwd, x, h0,
                                     c0, dh_seq, dhT, dcT, cfg, dr, mask, inv,
                                     tag))
            faster_than_per_step(rec, tag)
            print(f"  lstm_bwd_embed {tag}: {rec['ms']:.4f} ms per window "
                  f"({per_call['lstm_bwd_embed']} launches), plain "
                  f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
                  f"({rec['bound_by']}), cuDNN nn.LSTM backward "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; K1 at "
                  f"these shapes {k1_ms:.4f} ms", flush=True)
            records[("lstm_bwd_embed", dtype, drop)] = rec
        records[("k1_train", dtype)] = k1_ms
        # --- K4 and K5 on this window's hidden states
        t = s * b
        h_c = h_seq.reshape(t, n).to(cfg.cdtype)
        Why_c = params.Why.to(cfg.cdtype)
        by = params.by.float()
        tg = tgt.reshape(t)
        cot = torch.tensor(LN2 / t, device=DEVICE)
        before = head.head_fwd.launches
        bits_k, lse_k = head.head_fwd(Why_c, by, h_c, tg, cfg)
        per_call["head_fwd"] = head.head_fwd.launches - before
        bits_p, lse_p = head.head_fwd_plain(Why_c, by, h_c, tg, cfg)
        before = head.head_bwd.launches
        bwd_k = head.head_bwd(Why_c, by, h_c, tg, lse_k, cot, cfg)
        per_call["head_bwd"] = head.head_bwd.launches - before
        # the backward's plain version from the kernel's own lse
        bwd_p = head.head_bwd_plain(Why_c, by, h_c, tg, lse_k, cot, cfg)
        torch.cuda.synchronize()
        fwd_err = max(norm_err(bits_k, bits_p), norm_err(lse_k, lse_p))
        tc = head.fwd_tensor_cores(cfg, n, m)
        print(f"  head_fwd {dtype}: the {'tensor-core' if tc else 'CUDA-core'} "
              f"design; bits {float(bits_k):.4f} plain "
              f"{float(bits_p):.4f}, bits and lse within {fwd_err:.3e} "
              f"(tol {TRAIN_TOL:g})", flush=True)
        if not np.isfinite(fwd_err) or fwd_err > TRAIN_TOL:
            fail(f"head_fwd {dtype}: {fwd_err:.3e} > {TRAIN_TOL:g}")
        if tc != (dtype == "bfloat16"):
            fail(f"head_fwd {dtype}: tensor cores {tc}; these shapes take "
                 f"them in bf16 alone")
        if tc:
            # the CUDA-core design, which fp32 keeps, held to the same gate
            # on the same inputs and timed in this run
            with cuda_core_head():
                bits_o, lse_o = head.head_fwd(Why_c, by, h_c, tg, cfg)
                core_ms = cuda_ms(lambda: head.head_fwd(Why_c, by, h_c, tg, cfg),
                                  reps=10)
            core_err = max(norm_err(bits_o, bits_p), norm_err(lse_o, lse_p))
            print(f"  head_fwd {dtype}, the CUDA-core design: within "
                  f"{core_err:.3e} of plain (tol {TRAIN_TOL:g}), {core_ms:.4f} "
                  f"ms a call in this run", flush=True)
            if not np.isfinite(core_err) or core_err > TRAIN_TOL:
                fail(f"head_fwd {dtype}, the CUDA-core design: {core_err:.3e}")
            records[("head_fwd_core", dtype)] = core_ms
        else:
            k4_fp32(cfg, (Why_c, by, h_c, tg))
        btc = head.bwd_tensor_cores(cfg, n, m)
        if btc != (dtype == "bfloat16"):
            fail(f"head_bwd {dtype}: tensor cores {btc}; these shapes take "
                 f"them in bf16 alone")
        bwd_err = head_bwd_check(f"head_bwd {dtype}, the "
                                 f"{'tensor-core' if btc else 'CUDA-core'} design",
                                 bwd_k, bwd_p, per_call["head_bwd"], dtype)
        if btc:
            # the CUDA-core design, which fp32 keeps, held to the same gates
            # on the same inputs and timed in this run
            with cuda_core_head(("bwd_tensor_cores",)):
                before = head.head_bwd.launches
                bwd_o = head.head_bwd(Why_c, by, h_c, tg, lse_k, cot, cfg)
                core_calls = head.head_bwd.launches - before
                head_bwd_check(f"head_bwd {dtype}, the CUDA-core design", bwd_o,
                               bwd_p, core_calls, dtype)
                records[("head_bwd_core", dtype)] = cuda_ms(
                    lambda: head.head_bwd(Why_c, by, h_c, tg, lse_k, cot, cfg),
                    reps=10)
        logits_in = (h_c, Why_c, by, tg)
        lib = head_library(*logits_in)
        for name, kern, plain, bwd, err, lib_t in (
            ("head_fwd", lambda: head.head_fwd(Why_c, by, h_c, tg, cfg),
             lambda: head.head_fwd_plain(Why_c, by, h_c, tg, cfg), False,
             fwd_err, lib[0]),
            ("head_bwd", lambda: head.head_bwd(Why_c, by, h_c, tg, lse_k, cot, cfg),
             lambda: head.head_bwd_plain(Why_c, by, h_c, tg, lse_k, cot, cfg),
             True, bwd_err, lib[1]),
        ):
            ms = cuda_ms(kern, reps=10)
            plain_ms = cuda_ms(plain, reps=5)
            bound_ms, bound_by = head_bound(cfg, t, n, m, bwd)
            core = records.get((f"{name}_core", dtype))
            print(f"  {name} {dtype}: {ms:.4f} ms per call "
                  f"({per_call[name]} launches), plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.5f} ms ({bound_by}), library "
                  f"{'n/a' if lib_t is None else f'{lib_t:.4f} ms'}"
                  + ("" if core is None else
                     f"; the CUDA-core design {core:.4f} ms"), flush=True)
            records[(name, dtype)] = dict(
                name=name, route="cuda", source="eigen_lstm_tpu_torch/csrc/head.cu",
                replaces=("eigen_lstm_tpu/ops/pallas_head.py:81" if bwd
                          else "eigen_lstm_tpu/ops/pallas_head.py:54"),
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_t)
    return per_call


def k4_fp32(cfg, bench):
    """K4 in fp32, its CUDA-core design, at the bench's shapes (``bench``:
    Why_c, by, h_c, targets of phase 5's window) and at the flagship's
    T = 32768, N = 1024 (random h in (-1, 1), Why and by from a seed):
    bits and lse within TRAIN_TOL (normalised) of the plain version, two
    launches a call, the time beside the library call (``torch.addmm`` and
    ``F.cross_entropy``), the plain version and the bound."""
    from eigen_lstm_tpu_torch.ops import head

    gen = torch.Generator().manual_seed(24)
    t, n, m = FLAG_S * FLAG_B, 1024, cfg.vocab
    flag = (((torch.randn(n, m, generator=gen) * 0.05).to(DEVICE)),
            (torch.randn(m, generator=gen) * 0.3).to(DEVICE),
            torch.tanh(torch.randn(t, n, generator=gen)).to(DEVICE),
            torch.randint(0, m, (t,), generator=gen).to(DEVICE))
    for label, cfg_, (Why_c, by, h_c, tg) in (
            ("the bench's shapes", cfg, bench),
            ("the flagship's T", dataclasses.replace(cfg, hidden=n), flag)):
        t_, n_ = h_c.shape
        bits_p, lse_p = head.head_fwd_plain(Why_c, by, h_c, tg, cfg_)
        before = head.head_fwd.launches
        bits_k, lse_k = head.head_fwd(Why_c, by, h_c, tg, cfg_)
        calls = head.head_fwd.launches - before
        err = max(norm_err(bits_k, bits_p), norm_err(lse_k, lse_p))
        if not np.isfinite(err) or err > TRAIN_TOL or calls != 2:
            fail(f"head_fwd float32 at {label}: {err:.3e} of plain (tol "
                 f"{TRAIN_TOL:g}), {calls} launches a call")
        ms = cuda_ms(lambda: head.head_fwd(Why_c, by, h_c, tg, cfg_), reps=10)
        plain_ms = cuda_ms(lambda: head.head_fwd_plain(Why_c, by, h_c, tg, cfg_),
                           reps=2, windows=3)
        lib_ms = head_library(h_c, Why_c, by, tg)[0]
        bound_ms, bound_by = head_bound(cfg_, t_, n_, m, False)
        print(f"  head_fwd float32 at {label} (T={t_}, N={n_}): the CUDA-core "
              f"design {ms:.4f} ms a call, bits and lse within {err:.3e} of "
              f"plain (tol {TRAIN_TOL:g}); library {lib_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})",
              flush=True)


# K5's launches a call: the main pass, dby's sum over the blocks, the dWhy
# product and, where it splits over the rows, its fixed-order sum
HEAD_BWD_LAUNCHES = (3, 4)


def head_bwd_check(label, got, want, launches, dtype):
    """K5's outputs against its plain version's from the same lse (dh
    within DH_BF16_TOL in bf16, else TRAIN_TOL, normalised) and its
    launches a call; returns the largest error."""
    worst, line = 0.0, []
    for name, g, w in zip(("dh", "dWhy", "dby"), got, want):
        tol = DH_BF16_TOL if name == "dh" and dtype == "bfloat16" else TRAIN_TOL
        err = norm_err(g, w)
        worst = max(worst, err)
        line.append(f"{name} {err:.3e} (tol {tol:g})")
        if not np.isfinite(err) or err > tol:
            fail(f"{label} {name}: {err:.3e} > {tol:g}")
    print(f"  {label}: " + ", ".join(line) + f"; {launches} launches a call",
          flush=True)
    if launches not in HEAD_BWD_LAUNCHES:
        fail(f"{label}: {launches} launches a call, not {HEAD_BWD_LAUNCHES}")
    return worst


@contextlib.contextmanager
def cuda_core_head(names=("fwd_tensor_cores",)):
    """K4 (``head.fwd_tensor_cores``) or K5 (``head.bwd_tensor_cores``),
    as ``names`` says, takes its CUDA-core design inside the block,
    whatever its plan would choose: for the check and time of that design
    where the main path takes the tensor cores."""
    from eigen_lstm_tpu_torch.ops import head

    chosen = {nm: getattr(head, nm) for nm in names}
    for nm in names:
        setattr(head, nm, lambda *a: False)
    try:
        yield
    finally:
        for nm, fn in chosen.items():
            setattr(head, nm, fn)


def head_library(h_c, Why_c, by, tg):
    """The yardstick of the head: two PyTorch calls, ``torch.addmm`` (the
    logits) and ``F.cross_entropy(..., reduction="sum")``, forward; and the
    one ``torch.autograd.grad`` call of their backward. The port never
    calls them."""
    hs = h_c.detach().requires_grad_()
    W = Why_c.detach().requires_grad_()
    b_ = by.to(Why_c.dtype).detach().requires_grad_()
    f = lambda: torch.nn.functional.cross_entropy(
        torch.addmm(b_, hs, W).float(), tg.long(), reduction="sum")
    with torch.no_grad():
        fwd = cuda_ms(f, reps=10)
    loss = f()
    bwd = cuda_ms(lambda: torch.autograd.grad(loss, [hs, W, b_], retain_graph=True),
                  reps=10)
    return fwd, bwd


def phase6a():
    """One bible.txt window through ``loss_fn``: the kernels against the
    plain versions on the card, loss and all five gradients."""
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

    gen = torch.Generator().manual_seed(6)
    x, t = bible_window(gen, TRAIN_S, TRAIN_B)
    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = train_cfg(dtype)
        params, _, _, extras = load_checkpoint(H512, cfg, DEVICE)
        # the checkpoint's own stream state (B = 128 streams)
        h, c = extras["stream_h"][:, :TRAIN_B], extras["stream_c"][:, :TRAIN_B]
        for backend in ("cuda", "plain"):
            cell_fn = select_cell_fn(backend, cfg, TRAIN_B, DEVICE)
            loss, _, _, grads = loss_and_grads(params, x, t, h, c, cfg, cell_fn)
            res[(dtype, backend)] = (loss, dict(grads.named_tensors()))
    torch.cuda.synchronize()
    compare_paths("loss_fn", res, lambda key: key in BF16_ROUNDED)


def compare_paths(label, res, rounded, vs_drift=None):
    """Gate the loss and gradients of ``res[(dtype, backend)]`` = (loss,
    {key: gradient}), kernels ("cuda") against plain, at phase 6a's
    tolerances; under bf16 the plain path's drift from its fp32 run is the
    control that must exceed the gate (with ``vs_drift``, the gate is
    ``vs_drift`` times the control instead), and exactly the gradients for
    which ``rounded(key)`` holds must be bf16 values, on both paths.
    Returns each bf16 gradient's distance over its control."""
    ratios = {}
    for dtype in ("float32", "bfloat16"):
        (lk, gk), (lp, gp) = res[(dtype, "cuda")], res[(dtype, "plain")]
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        print(f"  {label} {dtype}: loss kernels {float(lk):.6f} plain "
              f"{float(lp):.6f} (rel {rel:.2e}, tol {LOSS_RTOL[dtype]:g})",
              flush=True)
        if not np.isfinite(float(lk)) or rel > LOSS_RTOL[dtype]:
            fail(f"{label} {dtype}: loss rel {rel:.2e}")
        tol = TRAIN_TOL if dtype == "float32" else GRAD_TOL_BF16
        line = []
        for key in gp:
            err = norm_err(gk[key], gp[key])
            line.append(f"d{key[len('params.'):]} {err:.3e}")
            if dtype == "float32" or vs_drift is None:
                if not np.isfinite(err) or err > tol:
                    fail(f"{label} {dtype} gradient {key}: {err:.3e} > {tol:g}")
            if dtype == "float32":
                continue
            control = norm_err(gp[key], res[("float32", "plain")][1][key])
            exact = [bool((g == g.bfloat16().float()).all())
                     for g in (gk[key], gp[key])]
            line[-1] += f" (control {control:.3e}, {exact[0]}/{exact[1]})"
            ratios[key] = err / control
            if vs_drift is not None:
                if not np.isfinite(err) or err > vs_drift * control:
                    fail(f"{label} bf16 gradient {key}: {err:.3e} > "
                         f"{vs_drift:g} x the control {control:.3e}")
            elif control <= tol:
                fail(f"{label} bf16 gradient {key}: the control "
                     f"{control:.3e} does not exceed the gate {tol:g}")
            want = rounded(key)
            if exact != [want, want]:
                fail(f"{label} bf16 gradient {key}: bf16 values {exact}, "
                     f"the JAX VJP's {want}")
        how = (f"tol {tol:g}" if dtype == "float32" or vs_drift is None
               else f"tol {vs_drift:g} x the control")
        if dtype != "float32":
            how += ("; control: the plain path's bf16 drift; bf16 values, "
                    "kernels/plain")
        print(f"  {label} {dtype} gradients against plain, normalised ("
              f"{how}): " + ", ".join(line), flush=True)
    return ratios


def phase6b(per_call):
    """The port's bench on the card at the root bench.py's schedule;
    returns the kernels' launch counts of this run."""
    from eigen_lstm_tpu_torch import bench
    from eigen_lstm_tpu_torch.cli import build_parser
    from eigen_lstm_tpu_torch.ops import cuda_adagrad, cuda_cell, cuda_cell_bwd, head

    args = build_parser().parse_args(bench.DEFAULT_ARGV)
    counters = (cuda_cell.embed_layer0, cuda_cell_bwd.embed_layer0_bwd,
                head.head_fwd, head.head_bwd, cuda_adagrad.adagrad_update_fused)
    for fn in counters:
        fn.launches = 0
    cuda_cell.reset_launches()
    t0 = time.perf_counter()
    result = bench.run_benchmark(args)
    dt = time.perf_counter() - t0
    counts = dict(zip(("lstm_fwd_embed", "lstm_bwd_embed", "head_fwd",
                       "head_bwd", "adagrad"), (fn.launches for fn in counters)))
    print(json.dumps(result), flush=True)
    warmup, windows, per_window = bench.schedule(args)
    steps = (warmup + windows * per_window) * args.superstep
    step_ms = TRAIN_S * TRAIN_B / result["value"] * 1e3
    print(f"  bench: {dt:.1f} s for {steps} steps, {step_ms:.3f} ms a step "
          f"(median window), launches {counts}", flush=True)
    bpc = result["train_bpc"]
    print(f"  bench: train_bpc {bpc}: the root bench's band {bench.BPC_BAND} "
          f"{'met' if result['train_bpc_ok'] else 'NOT met'} (train_bpc_ok "
          f"{result['train_bpc_ok']}); gated inside the sanity band "
          f"{SANITY_BAND}", flush=True)
    if result["platform"] != "cuda":
        fail("bench: not on the card")
    if not (np.isfinite(bpc) and SANITY_BAND[0] <= bpc <= SANITY_BAND[1]):
        fail(f"bench: train_bpc {bpc} outside {SANITY_BAND}")
    # K1 as phase 5's bf16 call (its persistent design: one launch a step)
    want = dict(per_call, adagrad=1)
    for name, n_call in want.items():
        if counts[name] != steps * n_call:
            fail(f"bench: {name} launched {counts[name]} times, the path's "
                 f"shapes give {steps} x {n_call}")
    return counts, step_ms, bpc


# The JAX bench's step-0 state (tests/jax_bench_start.py writes it with the
# JAX Trainer.save; tests/test_torch_bench_start.py holds it to the JAX
# package and to the port's restore)
JAX_BENCH_START = "artifacts/bench_jax_start/state0.npz"


# The JAX package's first supersteps of the bench on the CPU from that
# start (tests/jax_bench_trajectory.py), and the port's on the CPU through
# the plain versions (tests/torch_bench_trajectory.py)
JAX_TRAJECTORY = "artifacts/bench_jax_start/trajectory.json"
PORT_CPU_TRAJECTORY = "artifacts/bench_jax_start/port_cpu_trajectory.json"
def bench_from_jax_start(args, supersteps):
    """The bench's first ``supersteps`` from the JAX bench's step-0 state
    through the port's bench Trainer on the card: (step on restore, steps
    run, seconds, each superstep's mean bits)."""
    from eigen_lstm_tpu_torch import bench

    trainer = bench.make_trainer(args)
    trainer.restore(JAX_BENCH_START)
    start = trainer.step
    means = []
    t0 = time.perf_counter()
    for _ in range(supersteps):
        trainer.state, metrics = trainer.dispatch_superstep()
        means.append(float(metrics["bits_mean"]))
    torch.cuda.synchronize()
    return start, trainer.step - start, time.perf_counter() - t0, means


def phase6d():
    """The bench's warm-up supersteps once more, from the JAX bench's
    step-0 state restored into the port's bench Trainer: the parameters,
    accumulators, cursors and stream state the JAX PRNG drew, then the same
    steps on the card; and again with K4 on its CUDA-core design, whose
    bits and lse differ only in the order of fp32 sums (phase 5). Each
    superstep's mean bits beside the JAX package's and the port's on the
    CPU from the same start (the committed trajectories), each difference
    against the order spread, max - min over the port's three runs from the
    JAX start (the kernels, the kernels with K4's other design, the plain
    versions on the CPU), which differ only in the order of fp32 sums; the
    first superstep past it is named. Reported, not gated. (The spread over
    three own-start seeds, once a second threshold, and the whole
    schedule from this start, whose train_bpc against the JAX package's
    is settled (ROADMAP, "Settled"), were cut for the script's time.)"""
    from eigen_lstm_tpu_torch import bench
    from eigen_lstm_tpu_torch.cli import build_parser

    args = build_parser().parse_args(bench.DEFAULT_ARGV)
    warmup = bench.schedule(args)[0]
    start, steps, dt, means = bench_from_jax_start(args, warmup)
    with cuda_core_head():
        means_o = bench_from_jax_start(args, warmup)[3]
    print(f"  bench from the JAX start ({JAX_BENCH_START}, step {start} on "
          f"restore): its first {steps} steps ({warmup} supersteps) in {dt:.1f} "
          f"s, and again with K4's CUDA-core design", flush=True)
    with open(JAX_TRAJECTORY) as f:
        jax_means = [x["bits_mean"] for x in json.load(f)["supersteps"]]
    with open(PORT_CPU_TRAJECTORY) as f:
        cpu_means = [x["bits_mean"] for x in json.load(f)["supersteps"]]
    k = min(len(jax_means), len(cpu_means), len(means))
    parted = {"order spread": None}
    for i in range(k):
        own = (means[i], means_o[i], cpu_means[i])
        order = max(own) - min(own)
        diff = means[i] - jax_means[i]
        for name, thr in (("order spread", order),):
            if parted[name] is None and abs(diff) > thr:
                parted[name] = i
        print(f"  6d superstep {i} (steps {i * args.superstep}-"
              f"{(i + 1) * args.superstep - 1}): mean bits on the card "
              f"{means[i]:.4f}, the JAX package on the CPU {jax_means[i]:.4f} "
              f"(card - JAX {diff:+.4f}), the port on the CPU {cpu_means[i]:.4f} "
              f"(CPU port - JAX {cpu_means[i] - jax_means[i]:+.4f}), the card "
              f"with K4's CUDA-core design {means_o[i]:.4f}; threshold: the "
              f"order spread (the port's three runs from this start, which "
              f"differ only in the order of fp32 sums) {order:.4f}", flush=True)
    print("  6d: the card's supersteps part from the JAX package's on the CPU "
          + "; ".join(f"beyond the {name} "
                      + (f"first at superstep {i}" if i is not None
                         else f"at none of the first {k}")
                      for name, i in parted.items())
          + " (reported, not gated)", flush=True)


def phase6c():
    """TRAJ_STEPS steps of the bench's Trainer in fp32 through the kernels.
    At every step the loss and five gradients through the plain versions,
    from the kernel run's own state, are gated; a second run through the
    plain versions alone is printed beside it. Returns the launches of K3
    (its fp32 persistent design), K1 (its fp32 persistent design, one
    launch a call) and K4 (its CUDA-core design, which fp32 takes)."""
    from eigen_lstm_tpu_torch import bench
    from eigen_lstm_tpu_torch.cli import build_parser
    from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd, head
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads, train_step

    runs = [bench.make_trainer(build_parser().parse_args(
        bench.DEFAULT_ARGV + ["--dtype", "float32", "--backend", backend]))
        for backend in ("cuda", "plain")]
    k3, k1, k4 = cuda_cell_bwd.embed_layer0_bwd, cuda_cell.embed_layer0, head.head_fwd
    k3.launches = k1.launches = k4.launches = 0
    states = [tr.state for tr in runs]
    k_steps = runs[0].tcfg.superstep
    worst, bits = {}, [[], []]
    t0 = time.perf_counter()
    for step in range(TRAJ_STEPS):
        if step % k_steps == 0:
            wins = [tr.feeder.next_device_batch().to(torch.int32) for tr in runs]
        st = states[0]
        x, t = wins[0][step % k_steps, :-1], wins[0][step % k_steps, 1:]
        (_, _, bk, gk), (_, _, bp, gp) = (
            loss_and_grads(st.params, x, t, st.h, st.c, runs[0].mcfg, tr.cell_fn)
            for tr in runs)
        errs = {"bits": abs(float(bk) - float(bp)) / abs(float(bp))}
        errs.update((f"d{key[len('params.'):]}", norm_err(a, b))
                    for (key, a), (_, b) in
                    zip(gk.named_tensors(), gp.named_tensors()))
        for key, err in errs.items():
            worst[key] = max(worst.get(key, 0.0), err)
        for i, tr in enumerate(runs):
            w = wins[i][step % k_steps]
            states[i], (b_i, _) = train_step(
                states[i], w[:-1], w[1:], tr.mcfg, tr.dcfg, tr.tcfg,
                tr.length, tr.cell_fn, tr.generator)
            bits[i].append(float(b_i))
    print(f"  steps fp32: {TRAJ_STEPS} steps through the kernels and through "
          f"the plain versions in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  steps fp32: plain from the kernel run's state at every step, "
          f"bits rel (tol {LOSS_RTOL['float32']:g}) and gradients normalised "
          f"(tol {TRAIN_TOL:g}) within: "
          + ", ".join(f"{key} {err:.3e}" for key, err in worst.items()),
          flush=True)
    for key, err in worst.items():
        tol = LOSS_RTOL["float32"] if key == "bits" else TRAIN_TOL
        if not np.isfinite(err) or err > tol:
            fail(f"steps fp32 {key}: kernels against plain {err:.3e}")
    last = [statistics.fmean(b[-k_steps:]) for b in bits]
    pk, pp = (dict(st.params.named_tensors()) for st in states)
    print(f"  steps fp32, the two runs apart (not gated: Adagrad's first "
          f"steps amplify fp32 rounding): last superstep's bits {last[0]:.7f} "
          f"and {last[1]:.7f}, parameters "
          + ", ".join(f"{key[len('params.'):]} {norm_err(pk[key], pp[key]):.2e}"
                      for key in pp), flush=True)
    # two K3 calls a step (the gated loss_and_grads, then train_step), each
    # in the fp32 persistent design: one reverse launch and its tail's
    mcfg = runs[0].mcfg
    want = bwd_f32_launches(mcfg, TRAIN_S, TRAIN_B, mcfg.vocab)
    per_call = k3.launches / (2 * TRAJ_STEPS)
    print(f"  steps fp32: K3 {k3.launches} launches, {per_call:g} a call "
          f"({k6_design(mcfg, TRAIN_B, mcfg.hidden)[0]}: {want} a call)",
          flush=True)
    if per_call != want:
        fail(f"steps fp32: K3 launched {k3.launches} times in {TRAJ_STEPS} "
             f"steps, not the fp32 persistent design's {want} a call")
    # and two K1 calls a step in its fp32 persistent design, one launch a
    # call
    design, persistent = split_design(mcfg, TRAIN_B, mcfg.hidden)
    print(f"  steps fp32: K1 {k1.launches} launches ({design})", flush=True)
    if not persistent or k1.launches != 2 * TRAJ_STEPS:
        fail(f"steps fp32: K1 launched {k1.launches} times in {design}; its "
             f"fp32 persistent design gives {2 * TRAJ_STEPS}")
    # and two K4 calls a step, each its CUDA-core pass and the partials' sum
    print(f"  steps fp32: K4 {k4.launches} launches (the CUDA-core design)",
          flush=True)
    if k4.launches != 2 * 2 * TRAJ_STEPS:
        fail(f"steps fp32: K4 launched {k4.launches} times, two calls a step "
             f"give {2 * 2 * TRAJ_STEPS}")
    return k3.launches, k1.launches, k4.launches


# Phase 6e, a 2x512 model in fp32 at the bench's data configuration (the
# bench's argv with --dtype float32 --layers 2): LAYERS2_STEPS steps through
# the kernels, each step's loss and gradients against the plain versions
# from the kernel run's own state at phase 6a's fp32 tolerances; then
# STEP_TIMES steps each, timed alike and back to back: the model's, the
# model's with the per-step K3/K6 forced, and the 1x512 bench's in fp32, for
# the median step time of each
LAYERS2_STEPS = 20
STEP_TIMES = 8


def _timed_steps(tr, steps):
    """``steps`` train_steps of Trainer ``tr`` from its state, each timed
    on the host clock between synchronisations: ms a step."""
    from eigen_lstm_tpu_torch.train.trainer import train_step

    times = []
    for step in range(steps):
        if step % tr.tcfg.superstep == 0:
            win = tr.feeder.next_device_batch().to(torch.int32)
        w = win[step % tr.tcfg.superstep]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, _ = train_step(tr.state, w[:-1], w[1:], tr.mcfg, tr.dcfg,
                                 tr.tcfg, tr.length, tr.cell_fn, tr.generator)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase6e(records):
    """A 2x512 model in fp32 through the Trainer ``cli train`` builds at
    the bench's data configuration (enwik6, B = 128, S = 100), so K6's and
    K2's fp32 persistent designs run where users meet them: LAYERS2_STEPS
    steps, each step's loss and gradients through the kernels against the
    plain versions from the kernel run's own state (6a's fp32 tolerances);
    K2's, K3's and K6's launches counted (two calls a step each, K2 one
    launch a call, K3 and K6 the fp32 persistent design's count a call);
    the median step time beside the same run's steps with the per-step K2
    and the per-step K3/K6 forced and beside the 1x512 bench's in fp32
    (K2's launches counted in the first: one a step); K2 and K6 on the
    model's layer 1 at these shapes, as phase 7a holds and times them (K2's
    per-step design forced and timed in the same call). Returns (K3's
    launches, K6's launches, K2's launches, the step times)."""
    from eigen_lstm_tpu_torch import bench
    from eigen_lstm_tpu_torch.cli import build_parser
    from eigen_lstm_tpu_torch.ops import cell as cell_ops
    from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd
    from eigen_lstm_tpu_torch.ops.dispatch import families, select_cell_fn
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads, train_step

    def trainer(layers):
        return bench.make_trainer(build_parser().parse_args(
            bench.DEFAULT_ARGV + ["--dtype", "float32", "--layers", str(layers),
                                  "--backend", "cuda"]))

    tr = trainer(2)
    cfg = tr.mcfg
    plain_fn = select_cell_fn("plain", cfg, TRAIN_B, DEVICE)
    k3, k6 = cuda_cell_bwd.embed_layer0_bwd, cuda_cell_bwd.scan_layer_bwd
    k2 = cuda_cell.scan_layer
    design, persistent = k6_design(cfg, TRAIN_B, cfg.hidden)
    design2, persistent2 = k2_design(cfg, TRAIN_B, cfg.hidden)
    print(f"  2x512 fp32: families (layers >= 1, layer 0) "
          f"{families(cfg, TRAIN_B)}; K3 and K6 in {design}; K2 in {design2}",
          flush=True)
    if not persistent or not persistent2:
        fail(f"2x512 fp32: K3 and K6 in {design}, K2 in {design2}; these "
             f"shapes take the fp32 persistent designs")
    k3.launches = k6.launches = k2.launches = 0
    worst = {}
    t0 = time.perf_counter()
    for step in range(LAYERS2_STEPS):
        if step % tr.tcfg.superstep == 0:
            win = tr.feeder.next_device_batch().to(torch.int32)
        w = win[step % tr.tcfg.superstep]
        st = tr.state
        (_, _, bk, gk), (_, _, bp, gp) = (
            loss_and_grads(st.params, w[:-1], w[1:], st.h, st.c, cfg, fn)
            for fn in (tr.cell_fn, plain_fn))
        errs = {"bits": abs(float(bk) - float(bp)) / abs(float(bp))}
        errs.update((f"d{key[len('params.'):]}", norm_err(a, b))
                    for (key, a), (_, b) in
                    zip(gk.named_tensors(), gp.named_tensors()))
        for key, err in errs.items():
            worst[key] = max(worst.get(key, 0.0), err)
        tr.state, _ = train_step(st, w[:-1], w[1:], cfg, tr.dcfg, tr.tcfg,
                                 tr.length, tr.cell_fn, tr.generator)
    launched = (k3.launches, k6.launches, k2.launches)
    print(f"  2x512 fp32: {LAYERS2_STEPS} steps through the kernels, each "
          f"against plain from its state, in {time.perf_counter() - t0:.1f} s; "
          f"bits rel (tol {LOSS_RTOL['float32']:g}) and gradients normalised "
          f"(tol {TRAIN_TOL:g}) within: "
          + ", ".join(f"{key} {err:.3e}" for key, err in worst.items()),
          flush=True)
    for key, err in worst.items():
        tol = LOSS_RTOL["float32"] if key == "bits" else TRAIN_TOL
        if not np.isfinite(err) or err > tol:
            fail(f"2x512 fp32 {key}: kernels against plain {err:.3e}")
    # two calls of each a step (the gated loss_and_grads, then train_step)
    want = (2 * LAYERS2_STEPS * bwd_f32_launches(cfg, TRAIN_S, TRAIN_B, cfg.vocab),
            2 * LAYERS2_STEPS * bwd_f32_launches(cfg, TRAIN_S, TRAIN_B, 0),
            2 * LAYERS2_STEPS)
    print(f"  2x512 fp32: K3, K6, K2 launches {launched} (the fp32 persistent "
          f"designs give {want})", flush=True)
    if launched != want:
        fail(f"2x512 fp32: K3, K6, K2 launched {launched} times, not {want}")
    # K2 and K6 on this model's layer 1 at these shapes (S = 100, B = 128, N
    # = 512), from the last window: 7a's gates and times
    n, s, b = cfg.hidden, TRAIN_S, TRAIN_B
    l0, l1 = tr.state.params.layers[0], tr.state.params.layers[1]
    gen = torch.Generator().manual_seed(16)
    rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd).to(DEVICE)
    h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
    h_in = cuda_cell.embed_layer0(l0, w[:-1], h0, c0, cfg)[0].float()
    xw = (cell_ops.matmul(h_in.reshape(s * b, n), l1.W, cfg.cdtype)
          .reshape(s, b, 4 * n) + l1.b)
    tag = "2x512 layer 1 fp32"
    per_call = {}
    out2, rec2 = fwd_check("lstm_fwd_scan", "scan", k2, cuda_cell.scan_layer_plain,
                           l1, xw, h0, c0, cfg, None, None, None, tag, per_call,
                           source=TILED_F32_SOURCE)
    if per_call["lstm_fwd_scan"] != 1:
        fail(f"lstm_fwd_scan {tag}: {per_call['lstm_fwd_scan']} launches a "
             f"call, its fp32 persistent design gives 1")
    with per_step_tiled(K2_PLANS):
        step_call = {}
        fwd_check("lstm_fwd_scan", "scan", k2, cuda_cell.scan_layer_plain, l1,
                  xw, h0, c0, cfg, None, None, None, tag + " (the per-step design)",
                  step_call, timed=False)
        rec2["per_step_ms"] = cuda_ms(lambda: k2(l1, xw, h0, c0, cfg,
                                                 residuals=True), reps=2, windows=3)
    if step_call["lstm_fwd_scan"] != s:
        fail(f"lstm_fwd_scan {tag}, the per-step design: "
             f"{step_call['lstm_fwd_scan']} launches, one a step gives {s}")
    rec2.update(replaces=REPLACES["lstm_fwd_scan"],
                library_ms=library_ms(n, cfg, h_in, h0, c0))
    records[("6e", "lstm_fwd_scan")] = rec2
    lib2 = rec2["library_ms"]
    print(f"  lstm_fwd_scan {tag}: {rec2['ms']:.4f} ms per window (1 launch), "
          f"plain {rec2['plain_ms']:.4f} ms, bound {rec2['bound_ms']:.5f} ms "
          f"({rec2['bound_by']}), cuDNN nn.LSTM "
          f"{'n/a' if lib2 is None else f'{lib2:.4f} ms'}"
          + design_times(rec2, s), flush=True)
    dh_seq = rand(s, b, n, sd=1e-3)
    dhT, dcT = rand(b, n, sd=1e-3), rand(b, n, sd=1e-3)
    rec = bwd_check("lstm_bwd_scan", l1.U, out2, None, h0, c0, dh_seq, dhT,
                    dcT, cfg, None, None, None, tag, {})
    rec.update(other_designs("lstm_bwd_scan", l1.U, out2, None, h0, c0, dh_seq,
                             dhT, dcT, cfg, None, None, None, tag))
    faster_than_per_step(rec, tag)
    lib = library_lstm_bwd(cfg, h_in, h0, c0, dh_seq)
    rec.update(replaces=REPLACES["lstm_bwd_scan"], library_ms=lib)
    records[("6e", "lstm_bwd_scan")] = rec
    print(f"  lstm_bwd_scan {tag}: {rec['ms']:.4f} ms per window, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
          f"({rec['bound_by']}), cuDNN nn.LSTM backward "
          f"{'n/a' if lib is None else f'{lib:.4f} ms'}", flush=True)
    # the four step times alike: STEP_TIMES steps each, back to back; K2's
    # launches in the first, one a step
    k2.launches = 0
    times = _timed_steps(tr, STEP_TIMES)
    k2_steps = k2.launches
    with per_step_tiled(K2_PLANS):
        forced2 = _timed_steps(tr, STEP_TIMES)
    with per_step_k6():
        forced = _timed_steps(tr, STEP_TIMES)
    one = _timed_steps(trainer(1), STEP_TIMES)
    med = {"2x512": statistics.median(times[2:]),
           "2x512 per-step K2": statistics.median(forced2[2:]),
           "2x512 per-step K3/K6": statistics.median(forced[2:]),
           "1x512": statistics.median(one[2:])}
    print("  fp32 steps (median, host clock around synchronised steps): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
          + f"; K2 launched {k2_steps} times in the first {STEP_TIMES} steps",
          flush=True)
    if k2_steps != STEP_TIMES:
        fail(f"2x512 fp32 steps: K2 launched {k2_steps} times in {STEP_TIMES} "
             f"steps, one a step")
    return launched[0], launched[1], launched[2] + k2_steps, med


# --- the flagship's training (S = 256, B = 128, N = 1024, M = 256) ---------
FLAG_S, FLAG_B = 256, 128
FLAG_DROP = 0.35
# layer seeds of phase 7a: a negative int32 and one near the top, as
# models.lstm._drop_seed makes them
FLAG_SEEDS = (-1234567, 2**31 - 5)
FLAG_STEPS = 100
# The flagship recipe (scripts/flagship_resume.sh, flagship_full.sh) as the
# CLI takes it, from the flagship's own weights and Adagrad accumulators.
FLAG_ARGV = [
    "train", "--data", CORPUS, "--hidden", "1024", "--layers", "3",
    "--batch", str(FLAG_B), "--seq", str(FLAG_S), "--dtype", "bfloat16",
    "--stream-data", "--dropout", str(FLAG_DROP), "--lr", "0.005",
    "--warmup", "0", "--clip-norm", "2.0", "--superstep", "50",
    "--steps", str(FLAG_STEPS), "--sample-chars", "0", "--resume", FLAGSHIP,
]
# 7c's fp32 step time: FP32_STEPS steps with K8-K10 in each design, the
# mean over the last FP32_TIMED
FP32_STEPS, FP32_TIMED = 3, 2
# the gradients the JAX custom VJPs and the matmul VJP hand back as bf16
# values under bf16 compute: every layer's W and U, and Why
FLAG_ROUNDED = (".W", ".U", ".Why")
# Phase 7b in bf16. Three layers over 256 steps carry a flipped bf16
# rounding as far as bf16 itself moves the plain path from its fp32 run:
# sound kernels read 0.09 to 1.39 times that drift on the window (my chip
# run, PR 6), so the window cannot tell a sound kernel from a lost rounding
# at any fixed gate, and 6a's gate (1e-2, below the drift) does not hold.
# Each bf16 gradient is gated at twice the drift, which a fault in the
# math (a lost or misplaced mask, a wrong seed or transpose) exceeds; the
# roundings themselves are gated step by step in 7a (1e-4), and by the
# bf16-value rule here.
FLAG_BF16_VS_DRIFT = 2.0


def flag_train_cfg(dtype: str):
    from eigen_lstm_tpu_torch import ModelConfig

    return ModelConfig(hidden=1024, num_layers=3, compute_dtype=dtype,
                       residual_dtype="float32", loss_mode="all",
                       dropout=FLAG_DROP)


def host_masks(seed, s, b, n, rate):
    """The (S, B, N) keep-mask of a layer seed, from the numpy oracle, on
    the card."""
    from eigen_lstm_tpu_torch.ops.cuda_cell import host_keep_mask

    return torch.from_numpy(np.stack(
        [host_keep_mask(seed, t, b, n, rate) for t in range(s)])).to(DEVICE)


def masked(x, mask, inv):
    """where(mask, x * inv, 0), the product in fp32."""
    return torch.where(mask, x.float() * inv, torch.zeros((), device=DEVICE))


def fwd_check(name, kind, kern, plain, layer, seq, h0, c0, cfg, dropout, mask,
              inv, tag, per_call, source="eigen_lstm_tpu_torch/csrc/lstm_fwd.cu",
              time_cfg=None, timed=True):
    """A forward kernel at the training shapes, with residuals: every step
    against its plain replay, and under dropout the masked stream, the
    kernel's and the plain version's, against the numpy mask of their own
    h_seq, bit for bit. The times are taken at ``time_cfg`` (default
    ``cfg``). Returns (output, record), the record None when not
    ``timed``."""
    s, b = seq.shape[:2]
    before = kern.launches
    out = kern(layer, seq, h0, c0, cfg, residuals=True, dropout=dropout)
    per_call[name] = kern.launches - before
    out_k = _named(out)
    torch.cuda.synchronize()
    for label, x in out_k.items():
        if not torch.isfinite(x.float()).all():
            fail(f"{name} {tag} {label}: non-finite values")
    step_err = 0.0
    for label, ref in replay_steps(plain, layer, seq, h0, c0, cfg, out_k).items():
        step_err = max(step_err, max_err(out_k[label], ref)[0])
    if step_err > STEP_ATOL:
        fail(f"{name} {tag}: a step is {step_err:.3e} from its plain replay")
    line = f"all {s} steps within {step_err:.3e} of their plain replay"
    if dropout is not None:
        out_p = plain(layer, seq, h0, c0, cfg, residuals=True, dropout=dropout)
        for who, o in (("kernel", out), ("plain", out_p)):
            if not torch.equal(o[4], masked(o[0], mask, inv).to(o[4].dtype)):
                fail(f"{name} {tag}: the {who}'s masked stream is not "
                     f"where(host mask, h * inv, 0) of its own h_seq")
        line += ("; masked stream = where(host mask, h*inv, 0) of h_seq, bit "
                 f"for bit, kernel and plain ({float((~mask).float().mean()):.4f} "
                 "dropped)")
    print(f"  {name} {tag}: {line}", flush=True)
    if not timed:
        return out, None
    tc = time_cfg or cfg
    call = lambda fn: fn(layer, seq, h0, c0, tc, residuals=True, dropout=dropout)
    ms = cuda_ms(lambda: call(kern), reps=2, windows=3)
    plain_ms = once_ms(lambda: call(plain))
    bound_ms, bound_by = bound(kind, tc, s, b, cfg.hidden, cfg.vocab,
                               train=True, drop=dropout is not None)
    return out, dict(name=name, route="cuda", source=source,
                     launches=None, max_abs_err=step_err, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def k1_designs(layer, x, h0, c0, cfg, dropout, mask, inv, tag, out, rec,
               calls):
    """K1 at training shapes beyond ``fwd_check`` (its output ``out``, its
    record ``rec`` and launches ``calls`` of that call): the design and
    launches a call (the persistent one in both types, one launch); the
    bf16-residual run the fp32 run rounded, bit for bit; the per-step
    design and the unsplit layout (both forced) held to ``fwd_check``'s
    gates on the same inputs and timed in this call (``rec["per_step_ms"]``,
    ``rec["unsplit_ms"]``), the persistent design gated the faster than the
    per-step one."""
    from eigen_lstm_tpu_torch.ops import cuda_cell

    s, b = x.shape
    design, persistent = split_design(cfg, b, cfg.hidden)
    print(f"  lstm_fwd_embed {tag}: {design}", flush=True)
    if not persistent or calls != 1:
        fail(f"lstm_fwd_embed {tag}: {design}, {calls} launches a call; these "
             f"shapes take the persistent design in both types, one launch a "
             f"call")
    kern, plain = cuda_cell.embed_layer0, cuda_cell.embed_layer0_plain
    check_bf16_residuals(f"lstm_fwd_embed {tag}", kern(
        layer, x, h0, c0, dataclasses.replace(cfg, residual_dtype="bfloat16"),
        residuals=True, dropout=dropout), out)
    rec["source"] = FWD_SOURCE if cfg.cdtype == torch.bfloat16 else TILED_F32_SOURCE
    for key, label, force, want in (
            ("per_step_ms", "the per-step design", per_step_tiled(SPLIT_PLAN), s),
            ("unsplit_ms", "the unsplit layout", unsplit_fwd(), 1)):
        other = {}
        with force:
            fwd_check("lstm_fwd_embed", "embed", kern, plain, layer, x, h0, c0,
                      cfg, dropout, mask, inv, f"{tag} ({label})", other,
                      timed=False)
            rec[key] = cuda_ms(lambda: kern(layer, x, h0, c0, cfg, residuals=True,
                                            dropout=dropout), reps=2, windows=3)
        if other["lstm_fwd_embed"] != want:
            fail(f"lstm_fwd_embed {tag}, {label}: {other['lstm_fwd_embed']} "
                 f"launches a call, not {want}")
    if not rec["ms"] < rec["per_step_ms"]:
        fail(f"lstm_fwd_embed {tag}: the persistent design ({rec['ms']:.4f} ms) "
             f"is not faster than the per-step one ({rec['per_step_ms']:.4f})")


def design_times(rec, s):
    """The other designs' times of a record, as a line's suffix."""
    out = ""
    if "unsplit_ms" in rec:
        out += f"; the unsplit layout {rec['unsplit_ms']:.4f} ms"
    if "per_step_ms" in rec:
        out += f"; the per-step design {rec['per_step_ms']:.4f} ms ({s} launches)"
    return out + (" in this call" if out else "")


def bwd_check(name, U, fwd_out, ids, h0, c0, dh_seq, dhT, dcT, cfg, dropout,
              mask, inv, tag, per_call, timed=True):
    """K3 (``ids``) or K6 at the training shapes, in the design its wrapper
    takes (``k6_design``): every reverse step replayed from the kernel's
    own dg with the explicitly masked cotangent, and the whole window
    against the plain version given the explicitly masked cotangent (fp32
    gated, bf16 printed); the bf16 persistent design's bf16 dg its fp32 dg
    rounded, bit for bit, and 2 or 3 launches a call (the reverse launch
    and the weight-gradient product, split or not), the fp32 persistent
    design's one reverse launch and its tail's (``bwd_f32_launches``), the
    per-step design's more than S. K3 runs the layer-0 VJP the JAX package
    takes at these shapes (``dispatch.fused_accum_ok``). Returns the
    record, or with ``timed`` False the largest normalised error of the
    replay (the checks alone)."""
    from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd
    from eigen_lstm_tpu_torch.ops.dispatch import fused_accum_ok

    h_seq, c_seq, g_seq = fwd_out[0], fwd_out[2], fwd_out[3]
    s, b, n = h_seq.shape
    U_c = U.to(cfg.cdtype)
    dh_eff = dh_seq if dropout is None else masked(dh_seq, mask, inv)
    if ids is not None:
        kern, plain = cuda_cell_bwd.embed_layer0_bwd, cuda_cell_bwd.embed_layer0_bwd_plain
        args = (U_c, g_seq, c_seq, h_seq, ids, h0, c0)
        names = ("dWU", "db", "dh0", "dc0")
    else:
        kern, plain = cuda_cell_bwd.scan_layer_bwd, cuda_cell_bwd.scan_layer_bwd_plain
        args = (U_c, g_seq, c_seq, h_seq, h0, c0)
        names = ("dg_seq", "dU", "dh0", "dc0")
    kw = {} if ids is None else {"fused_accum": fused_accum_ok(cfg, b)}
    design, persistent = k6_design(cfg, b, n)
    bf16 = persistent and cfg.cdtype == torch.bfloat16
    dg_k = torch.empty(s, b, 4 * n, device=DEVICE)
    before = kern.launches
    with kept_dgx() as kept:
        out_k = kern(*args, dh_seq, dhT, dcT, cfg, dg_out=dg_k,
                     dropout=dropout, **kw)
    launched = kern.launches - before
    per_call[name] = launched
    out_p = plain(*args, dh_eff, dhT, dcT, cfg, **kw)
    torch.cuda.synchronize()
    for label, got in zip(names, out_k):
        if not torch.isfinite(got.float()).all():
            fail(f"{name} {tag} {label}: non-finite values")
    if bf16 != (len(kept) == 1) or (
            bf16 and not torch.equal(kept[0], dg_k.to(torch.bfloat16))):
        fail(f"{name} {tag}: {design}, {len(kept)} bf16 dg sequences written; "
             f"the persistent design's bf16 dg must be its fp32 dg rounded")
    m = 0 if ids is None else cfg.vocab
    if not (2 <= launched <= 3 if bf16 else
            launched == bwd_f32_launches(cfg, s, b, m) if persistent
            else launched > s):
        fail(f"{name} {tag}: {design}, {launched} launches a call")
    if ids is not None:
        rep = k3_replay(*args, dh_eff, dhT, dcT, cfg, dg_k, **kw)
        pairs = (("dg", dg_k, rep[0]), ("dh0", out_k[2], rep[1]),
                 ("dc0", out_k[3], rep[2]), ("dWU", out_k[0], rep[3]),
                 ("db", out_k[1], rep[4]))
    else:
        rep = k6_replay(*args, dh_eff, dhT, dcT, cfg, dg_k)
        pairs = (("dg", dg_k, rep[0]), ("dh0", out_k[2], rep[1]),
                 ("dc0", out_k[3], rep[2]), ("dU", out_k[1], rep[3]))
        if not torch.equal(out_k[0], dg_k.to(cuda_cell.xw_type(cfg))):
            fail(f"{name} {tag}: dg_seq is not its fp32 dg in the xw type")
    step_err, each = 0.0, []
    for label, got, want in pairs:
        err = norm_err(got, want)
        step_err = max(step_err, err)
        each.append(f"{label} {err:.1e}")
        if not np.isfinite(err) or err > TRAIN_TOL:
            fail(f"{name} {tag} {label}: {err:.3e} of its plain replay > "
                 f"{TRAIN_TOL:g}")
    window = []
    for label, got, want in zip(names, out_k, out_p):
        err = norm_err(got, want)
        window.append(f"{label} {err:.3e}")
        if cfg.cdtype == torch.float32 and err > TRAIN_TOL:
            fail(f"{name} {tag} window {label}: {err:.3e}")
    vjp = ("" if ids is None else " (the fused VJP's db)"
           if kw["fused_accum"] else " (the GEMM fall-back's db)")
    print(f"  {name} {tag}{vjp}, {design}, {launched} launches: every "
          f"reverse step and the outputs within {step_err:.3e} (normalised: "
          f"{', '.join(each)}) of the plain replay from the kernel's own dg"
          f"{' with the host mask' if dropout else ''} (tol {TRAIN_TOL:g})"
          + ("; its bf16 dg its fp32 dg rounded, bit for bit" if bf16
             else "") + "; window against plain with explicit masks ("
          + (f"tol {TRAIN_TOL:g}" if cfg.cdtype == torch.float32 else
             "bf16, not gated") + "): " + ", ".join(window), flush=True)
    if not timed:
        return step_err
    call = lambda: kern(*args, dh_seq, dhT, dcT, cfg, dropout=dropout, **kw)
    ms = cuda_ms(call, reps=1, windows=3)
    plain_ms = once_ms(lambda: plain(*args, dh_seq, dhT, dcT, cfg,
                                     dropout=dropout, **kw))
    if ids is not None:
        bound_ms, bound_by = k3_bound(cfg, s, b, n, cfg.vocab)
    else:
        bound_ms, bound_by = k6_bound(cfg, s, b, n)
    return dict(name=name, route="cuda",
                source=BWD_F32_SOURCE if persistent and not bf16 else BWD_SOURCE,
                launches=None, max_abs_err=step_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def other_designs(name, U, fwd_out, ids, h0, c0, dh_seq, dhT, dcT, cfg,
                  dropout, mask, inv, tag):
    """Where K3 (``ids``) or K6 takes a persistent design: the per-step
    design, which the plans keep for other shapes and cards, held to
    ``bwd_check``'s gates on the same inputs; the persistent design's
    reverse launch and tail timed apart (and K3's dU alone), and the
    per-step design's call in the same run. Returns those times and the
    per-step design's largest replay error for the record."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_bwd
    from eigen_lstm_tpu_torch.ops.dispatch import fused_accum_ok

    with per_step_k6():
        old_err = bwd_check(name, U, fwd_out, ids, h0, c0, dh_seq, dhT, dcT,
                            cfg, dropout, mask, inv,
                            tag + " (the per-step design)", {}, timed=False)
    h_seq, c_seq, g_seq = fwd_out[0], fwd_out[2], fwd_out[3]
    s, b, n = h_seq.shape
    U_c = U.to(cfg.cdtype)
    fused = fused_accum_ok(cfg, b)
    if ids is None:
        kern = cuda_cell_bwd.scan_layer_bwd
        call = lambda **kw: kern(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq, dhT,
                                 dcT, cfg, dropout=dropout, **kw)
    else:
        kern = cuda_cell_bwd.embed_layer0_bwd
        call = lambda **kw: kern(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq,
                                 dhT, dcT, cfg, dropout=dropout,
                                 fused_accum=fused, **kw)
    rev, tail, old, old_n = persist_split_ms(call, kern, cfg)
    what = "dU"
    if ids is not None and cfg.cdtype == torch.bfloat16:
        # K3's tail is one product over [one-hot(ids) | h_{t-1}]: the same
        # product without the one-hot rows (K6's) says what dW takes
        from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import tensor_core_dU

        with kept_dgx() as kept:
            call()
        du = cuda_ms(lambda: tensor_core_dU(kept[0], h_seq, h0, cfg), reps=5)
        what = f"dW and dU; dU alone {du:.4f} ms"
    elif ids is not None:
        # K3's fp32 tail is dU, dW and db: K6's tail (dU alone) on the
        # same dg says what dW and db take
        dg = torch.empty(s, b, 4 * n, device=DEVICE)
        call(dg_out=dg)
        h_m1 = cuda_cell_bwd._h_minus_1(h0, cfg, fused)
        du = f32_dU_ms(dg, h_seq, h_m1, cfg)
        what = f"dU, dW and db; dU alone {du:.4f} ms"
    print(f"  {name} {tag}: reverse launch {rev:.4f} ms ({1e3 * rev / (s + 1):.2f} "
          f"us a step), tail ({what}) {tail:.4f} ms; the per-step design "
          f"{old:.4f} ms in this run ({old_n} launches)", flush=True)
    return dict(reverse_ms=rev, tail_ms=tail, per_step_ms=old,
                per_step_launches=old_n, per_step_err=old_err)


def f32_dU_ms(dg, h_seq, h_m1, cfg):
    """dU = h_prev^T dg alone under fp32 compute, K6's tail in the fp32
    persistent design (``lstm_bwd_tail_launch`` without ids), on the fp32
    dg (S, B, 4N) and h_{-1}: ms a call, CUDA events."""
    import ctypes

    from eigen_lstm_tpu_torch.ops import _build, cuda_cell

    lib = _build.load_library()
    s, b, n = h_seq.shape
    h_k = h_seq.to(cfg.rdtype).contiguous()
    h0_k = h_m1.float().contiguous()
    out = torch.empty(n, 4 * n, device=DEVICE)
    work = torch.empty(max(1, lib.lstm_bwd_scan_work_floats(s, b, n)),
                       device=DEVICE)
    launched = ctypes.c_int(0)

    def run():
        err = lib.lstm_bwd_tail_launch(
            cuda_cell._TYPE_CODES[cfg.rdtype], h_k.data_ptr(), None,
            h0_k.data_ptr(), dg.data_ptr(), out.data_ptr(), None,
            work.data_ptr(), s, b, n, 0, 0,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
        if err != 0:
            fail(f"lstm_bwd_tail_launch (dU alone): error {err}")

    return cuda_ms(run, reps=5)


def group_control(U, fwd_out, ids, h0, c0, dh_seq, dhT, dcT, cfg):
    """K3's fp32 persistent design at the bench's shapes with the other
    group width forced (G = 2 where the plan takes 4: 64 blocks, each
    reading half of dg_{t+1}), held to the plan's outputs (the same
    function, another sum order) and its reverse launch timed beside the
    plan's: what the width buys. Printed, not recorded."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_bwd
    from eigen_lstm_tpu_torch.ops.dispatch import fused_accum_ok

    h_seq, c_seq, g_seq = fwd_out[0], fwd_out[2], fwd_out[3]
    s, b, n = h_seq.shape
    kern = cuda_cell_bwd.embed_layer0_bwd
    call = lambda: kern(U.to(cfg.cdtype), g_seq, c_seq, h_seq, ids, h0, c0,
                        dh_seq, dhT, dcT, cfg, fused_accum=fused_accum_ok(cfg, b))
    plan = cuda_cell_bwd.device_k6_f32_plan(cfg, b, n)
    other = plan._replace(blocks=2 if plan.blocks == 4 else 4)
    want = call()
    real = cuda_cell_bwd.device_k6_f32_plan
    cuda_cell_bwd.device_k6_f32_plan = lambda *a: other
    try:
        got = call()
        torch.cuda.synchronize()
        err = max(norm_err(a, w) for a, w in zip(got, want))
        times, = launchers_ms(call, ("lstm_bwd_f32_launch",))
    finally:
        cuda_cell_bwd.device_k6_f32_plan = real
    mine, = launchers_ms(call, ("lstm_bwd_f32_launch",))
    print(f"  lstm_bwd_embed float32, G = {other.blocks} forced "
          f"({n // 16 * other.blocks} blocks): outputs within {err:.3e} of "
          f"G = {plan.blocks}'s (tol {TRAIN_TOL:g}), reverse launch "
          f"{times:.4f} ms against G = {plan.blocks}'s {mine:.4f} ms in this "
          f"call", flush=True)
    if not np.isfinite(err) or err > TRAIN_TOL:
        fail(f"lstm_bwd_embed float32, G = {other.blocks} forced: {err:.3e}")


def faster_than_per_step(rec, tag):
    """The persistent design's call must beat the per-step design's, timed
    in the same run (``other_designs``)."""
    if not rec["ms"] < rec["per_step_ms"]:
        fail(f"{rec['name']} {tag}: the persistent design {rec['ms']:.4f} ms "
             f"is not faster than the per-step design "
             f"{rec['per_step_ms']:.4f} ms in this call")


# The keys of an entry of the kernels line; a record may hold more
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
REPLACES = {
    "lstm_fwd_embed": "eigen_lstm_tpu/ops/pallas_cell.py:495",
    "lstm_fwd_scan": "eigen_lstm_tpu/ops/pallas_cell.py:184",
    "lstm_bwd_embed": "eigen_lstm_tpu/ops/pallas_cell.py:556",
    "lstm_bwd_scan": "eigen_lstm_tpu/ops/pallas_cell.py:227",
}


def phase7a(records):
    """K1, K2, K3 and K6 against their plain versions at the flagship's
    training shapes, with the flagship's weights (layers 0 and 1), in fp32
    and bf16, without dropout and at 0.35; times beside the bound, the
    plain version and cuDNN ``nn.LSTM``; the heads' launches and times at
    these shapes. Returns the launches of one call of each kernel."""
    from eigen_lstm_tpu_torch.ops import cell as cell_ops
    from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd, head
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    s, b = FLAG_S, FLAG_B
    gen = torch.Generator().manual_seed(7)
    x, tgt = bible_window(gen, s, b)
    rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd).to(DEVICE)
    n, m = 1024, 256
    h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
    dh_seq = rand(s, b, n, sd=1e-3)
    dhT, dcT = rand(b, n, sd=1e-3), rand(b, n, sd=1e-3)
    masks = [host_masks(sd, s, b, n, FLAG_DROP) for sd in FLAG_SEEDS]
    inv = torch.tensor(float(np.float32(1.0 / (1.0 - FLAG_DROP))), device=DEVICE)
    onehot = torch.nn.functional.one_hot(x.long(), m).float()
    per_call = {}
    for dtype in ("float32", "bfloat16"):
        cfg = flag_train_cfg(dtype)
        params = load_params(FLAGSHIP, cfg, DEVICE)
        l0, l1 = params.layers[0], params.layers[1]
        for drop in (0.0, FLAG_DROP):
            tag = f"{dtype} drop {drop:g}"
            dr = [(drop, sd) if drop else None for sd in FLAG_SEEDS]
            out1, rec1 = fwd_check("lstm_fwd_embed", "embed", cuda_cell.embed_layer0,
                                   cuda_cell.embed_layer0_plain, l0, x, h0, c0,
                                   cfg, dr[0], masks[0], inv, tag, per_call)
            k1_designs(l0, x, h0, c0, cfg, dr[0], masks[0], inv, tag, out1, rec1,
                       per_call["lstm_fwd_embed"])
            h_in = (out1[4] if drop else out1[0]).float()
            xw = (cell_ops.matmul(h_in.reshape(s * b, n), l1.W, cfg.cdtype)
                  .reshape(s, b, 4 * n) + l1.b)
            out2, rec2 = fwd_check("lstm_fwd_scan", "scan", cuda_cell.scan_layer,
                                   cuda_cell.scan_layer_plain, l1, xw, h0, c0,
                                   cfg, dr[1], masks[1], inv, tag, per_call)
            design2, persistent2 = k2_design(cfg, b, n)
            print(f"  lstm_fwd_scan {tag}: {design2}", flush=True)
            if not persistent2 or per_call["lstm_fwd_scan"] != 1:
                fail(f"lstm_fwd_scan {tag}: {design2}, "
                     f"{per_call['lstm_fwd_scan']} launches a call; the "
                     f"flagship's shapes take the persistent design in both "
                     f"types, one launch a call")
            if persistent2:
                # K2's per-step design, which refused shapes keep, held to
                # the same gates on the same inputs and timed in this call
                rec2["source"] = FWD_SOURCE if dtype == "bfloat16" else TILED_F32_SOURCE
                step_call = {}
                with per_step_tiled(K2_PLANS):
                    fwd_check("lstm_fwd_scan", "scan", cuda_cell.scan_layer,
                              cuda_cell.scan_layer_plain, l1, xw, h0, c0, cfg,
                              dr[1], masks[1], inv,
                              tag + " (the per-step design)", step_call,
                              timed=False)
                    rec2["per_step_ms"] = cuda_ms(
                        lambda: cuda_cell.scan_layer(l1, xw, h0, c0, cfg,
                                                     residuals=True,
                                                     dropout=dr[1]),
                        reps=2, windows=3)
                if step_call["lstm_fwd_scan"] != s:
                    fail(f"lstm_fwd_scan {tag}, the per-step design: "
                         f"{step_call['lstm_fwd_scan']} launches, one a step "
                         f"gives {s}")
            rec3 = bwd_check("lstm_bwd_embed", l0.U, out1, x, h0, c0, dh_seq,
                             dhT, dcT, cfg, dr[0], masks[0], inv, tag, per_call)
            rec6 = bwd_check("lstm_bwd_scan", l1.U, out2, None, h0, c0, dh_seq,
                             dhT, dcT, cfg, dr[1], masks[1], inv, tag, per_call)
            design, persistent = k6_design(cfg, b, n)
            if not persistent:
                fail(f"lstm_bwd_embed, lstm_bwd_scan {tag}: {design}; the "
                     f"flagship's shapes take a persistent design in both "
                     f"types")
            for rec, U, out, ids, i in ((rec3, l0.U, out1, x, 0),
                                        (rec6, l1.U, out2, None, 1)):
                rec.update(other_designs(rec["name"], U, out, ids, h0, c0,
                                         dh_seq, dhT, dcT, cfg, dr[i],
                                         masks[i], inv, tag))
                faster_than_per_step(rec, tag)
            libs = (library_ms(m, cfg, onehot, h0, c0), library_ms(n, cfg, h_in, h0, c0),
                    library_lstm_bwd(cfg, onehot, h0, c0, dh_seq),
                    library_lstm_bwd(cfg, h_in, h0, c0, dh_seq))
            for rec, lib in zip((rec1, rec2, rec3, rec6), libs):
                rec.update(replaces=REPLACES[rec["name"]], library_ms=lib)
                records[("7a", rec["name"], dtype, drop)] = rec
                print(f"  {rec['name']} {tag}: {rec['ms']:.4f} ms per window "
                      f"({per_call[rec['name']]} launches), plain "
                      f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
                      f"({rec['bound_by']}), cuDNN nn.LSTM "
                      f"{'backward ' if 'bwd' in rec['name'] else ''}"
                      f"{'n/a' if lib is None else f'{lib:.4f} ms'}"
                      + (design_times(rec, s) if rec is rec1 or rec is rec2 else ""),
                      flush=True)
        # the heads at these shapes (T = S*B, N = 1024): launches and times
        t = s * b
        h_c = out2[0].reshape(t, n).to(cfg.cdtype)
        Why_c, by, tg = params.Why.to(cfg.cdtype), params.by.float(), tgt.reshape(t)
        cot = torch.tensor(LN2 / t, device=DEVICE)
        before = head.head_fwd.launches
        _, lse = head.head_fwd(Why_c, by, h_c, tg, cfg)
        per_call["head_fwd"] = head.head_fwd.launches - before
        before = head.head_bwd.launches
        bwd_k = head.head_bwd(Why_c, by, h_c, tg, lse, cot, cfg)
        per_call["head_bwd"] = head.head_bwd.launches - before
        # K5's sums over T = 32768 rows (tensor cores in bf16), printed
        # beside phase 5's gates, which hold at the bench's 12800
        bwd_p = head.head_bwd_plain(Why_c, by, h_c, tg, lse, cot, cfg)
        print(f"  head_bwd {dtype} at T={t}, N={n} against plain (not gated; "
              f"phase 5's tolerances {DH_BF16_TOL:g} on bf16 dh, else "
              f"{TRAIN_TOL:g}): " + ", ".join(
                  f"{k} {norm_err(a, b_):.3e}"
                  for k, a, b_ in zip(("dh", "dWhy", "dby"), bwd_k, bwd_p)),
              flush=True)
        del bwd_k, bwd_p
        for name, fn in (("head_fwd", lambda: head.head_fwd(Why_c, by, h_c, tg, cfg)),
                         ("head_bwd", lambda: head.head_bwd(Why_c, by, h_c, tg,
                                                            lse, cot, cfg))):
            records[("7a", name, dtype)] = cuda_ms(fn, reps=5, windows=3)
        print(f"  head_fwd, head_bwd {dtype} at T={t}, N={n}: "
              f"{records[('7a', 'head_fwd', dtype)]:.4f} ms, "
              f"{records[('7a', 'head_bwd', dtype)]:.4f} ms ({per_call['head_fwd']}"
              f", {per_call['head_bwd']} launches)", flush=True)
    return per_call


def phase7b():
    """The flagship's ``loss_fn`` with dropout on one bible.txt window, from
    ckpt_best.npz's weights and stream state, fixed layer seeds: the loss
    and all eleven gradients through the kernels against the plain path.
    Returns each bf16 gradient's distance over its control."""
    from eigen_lstm_tpu_torch.models.lstm import step_key
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

    gen = torch.Generator().manual_seed(8)
    x, t = bible_window(gen, FLAG_S, FLAG_B)
    key = step_key(1235, 785000)
    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = flag_train_cfg(dtype)
        params, _, _, extras = load_checkpoint(FLAGSHIP, cfg, DEVICE)
        for backend in ("cuda", "plain"):
            cell_fn = select_cell_fn(backend, cfg, FLAG_B, DEVICE)
            h, c = (extras[k][:, :FLAG_B] for k in ("stream_h", "stream_c"))
            loss, _, _, grads = loss_and_grads(params, x, t, h, c, cfg,
                                               cell_fn, key)
            res[(dtype, backend)] = (loss, dict(grads.named_tensors()))
    torch.cuda.synchronize()
    return compare_paths("flagship loss_fn", res,
                         lambda k: k.endswith(FLAG_ROUNDED),
                         vs_drift=FLAG_BF16_VS_DRIFT)


def plain64_cell_fn():
    """The resident family's plain versions as a ``cell_fn``, fused dropout
    and head included: in the float64 oracle configuration they keep
    float64 throughout, so they give the exact gradient that both fp32
    paths are read against. (``select_cell_fn`` would pick the tiled family
    at N = 1024 in float64, which sums in fp32 and stores its residuals in
    bf16 there, as the JAX tiled path does.)"""
    import functools

    from eigen_lstm_tpu_torch.ops import cuda_cell_bwd, head

    cell_fn = functools.partial(cuda_cell_bwd.differentiable_scan_layer,
                                plain=True)
    cell_fn.fused_dropout = cell_fn.plain = True
    cell_fn.embed_layer0 = functools.partial(
        cuda_cell_bwd.differentiable_embed_layer0, plain=True, fused_accum=True)
    cell_fn.fused_head = functools.partial(head.fused_head_bits, plain=True)
    cell_fn.fused_head.supported = head.head_supported
    return cell_fn


def phase7c(per_call, records):
    """FLAG_STEPS steps of the flagship recipe through the CLI's Trainer
    from ckpt_best.npz, with the launch counts reset before and read after;
    the step time, chars/s, each kernel's share and the trajectory; then 2
    steps from the run's state in fp32, kernels against plain, with the
    tiled kernels' launches reset before and read after (returned with the
    bf16 run's counts and step time, and the trainer at the bf16 run's
    state)."""
    import dataclasses

    from eigen_lstm_tpu_torch.cli import _make_trainer, build_parser
    from eigen_lstm_tpu_torch.models.lstm import like, step_key, tensors
    from eigen_lstm_tpu_torch.ops import (cuda_adagrad, cuda_cell, cuda_cell_bwd,
                                          cuda_cell_tiled, head)
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads, train_step

    trainer = _make_trainer(build_parser().parse_args(FLAG_ARGV))
    counters = {"lstm_fwd_embed": cuda_cell.embed_layer0,
                "lstm_fwd_scan": cuda_cell.scan_layer,
                "lstm_bwd_embed": cuda_cell_bwd.embed_layer0_bwd,
                "lstm_bwd_scan": cuda_cell_bwd.scan_layer_bwd,
                "head_fwd": head.head_fwd, "head_bwd": head.head_bwd}
    per_step = {"lstm_fwd_scan": 2, "lstm_bwd_scan": 2}   # layers 1 and 2
    k11 = cuda_adagrad.adagrad_update_fused   # one launch a step
    torch.cuda.synchronize()
    for fn in list(counters.values()) + [k11]:
        fn.launches = 0
    t0 = time.perf_counter()
    bits = []
    for _ in range(FLAG_STEPS // trainer.tcfg.superstep):
        trainer.state, met = trainer.dispatch_superstep()
        bits.append(met["bits"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    counts["adagrad"] = k11.launches
    bits = torch.cat(bits).tolist()
    step_ms = dt * 1e3 / FLAG_STEPS
    cps = FLAG_S * FLAG_B * FLAG_STEPS / dt
    print(f"  flagship steps: {FLAG_STEPS} steps (3x1024, B={FLAG_B}, "
          f"S={FLAG_S}, bf16, dropout {FLAG_DROP}) in {dt:.2f} s: "
          f"{step_ms:.2f} ms a step, {cps:,.0f} chars/s; launches {counts}",
          flush=True)
    print("  flagship steps, bits a step: "
          + " ".join(f"{v:.4f}" for v in bits), flush=True)
    last = statistics.fmean(bits[-trainer.tcfg.superstep:])
    if not all(np.isfinite(bits)) or last >= 3.0:
        fail(f"flagship steps: bits not finite or the last superstep's "
             f"mean {last:.4f} not below 3.0")
    for name, n_call in dict(per_call, adagrad=1).items():
        want = FLAG_STEPS * n_call * per_step.get(name, 1)
        if counts[name] != want:
            fail(f"flagship steps: {name} launched {counts[name]} times, "
                 f"the path's shapes give {want}")
    for name in counters:
        ms = (records[("7a", name, "bfloat16")] if name.startswith("head")
              else records[("7a", name, "bfloat16", FLAG_DROP)]["ms"])
        ms *= per_step.get(name, 1)
        print(f"  {name}: {ms:.3f} ms a step, {100 * ms / step_ms:.1f} % of "
              f"the {step_ms:.2f} ms flagship step", flush=True)
    # two more steps from the run's state in fp32, kernels against plain:
    # fp32 at N = 1024 takes the tiled family, as in the JAX package (U is
    # 16 MB in fp32), so K8, K9 and K10 and none of K1, K2, K3, K6
    cfg32 = dataclasses.replace(trainer.mcfg, compute_dtype="float32")
    paths = [select_cell_fn(b_, cfg32, FLAG_B, DEVICE) for b_ in ("cuda", "plain")]
    # the witness: both fp32 paths against the plain path in float64 at the
    # same seeds, so that a gap of the kernels near the gate can be read
    # against how far fp32 itself lies from the exact gradient at this state
    cfg64 = dataclasses.replace(cfg32, param_dtype="float64",
                                compute_dtype="float64", residual_dtype="float64")
    plain64 = plain64_cell_fn()
    st, worst, worst64 = trainer.state, {}, {}
    torch.cuda.synchronize()
    for fn in list(counters.values()) + [k11]:
        fn.launches = 0
    cuda_cell_tiled.reset_launches()
    for _ in range(2):
        win = trainer.feeder.next_device_batch()[0].to(torch.int32)
        x, t = win[:-1], win[1:]
        key = step_key(trainer.tcfg.seed, st.step)
        (_, _, bk, gk), (_, _, bp, gp) = (
            loss_and_grads(st.params, x, t, st.h, st.c, cfg32, cf, key)
            for cf in paths)
        errs = {"bits": abs(float(bk) - float(bp)) / abs(float(bp))}
        errs.update((f"d{key_[len('params.'):]}", norm_err(a, b_))
                    for (key_, a), (_, b_) in
                    zip(gk.named_tensors(), gp.named_tensors()))
        for name, err in errs.items():
            worst[name] = max(worst.get(name, 0.0), err)
        p64 = like(st.params, [p.double() for p in tensors(st.params)])
        g64 = loss_and_grads(p64, x, t, st.h.double(), st.c.double(), cfg64,
                             plain64, key)[3]
        for (key_, a), (_, b_), (_, r) in zip(gk.named_tensors(),
                                              gp.named_tensors(),
                                              g64.named_tensors()):
            name = f"d{key_[len('params.'):]}"
            ek, ep = worst64.get(name, (0.0, 0.0))
            worst64[name] = (max(ek, norm_err(a.double(), r)),
                             max(ep, norm_err(b_.double(), r)))
        del p64, g64
        st, _ = train_step(st, x, t, cfg32, trainer.dcfg, trainer.tcfg,
                           trainer.length, paths[0], trainer.generator)
    torch.cuda.synchronize()
    tiled = dict(zip(TILED, cuda_cell_tiled.launches()))
    # two kernel runs a step (the gated loss_and_grads, then train_step),
    # each K8 once, K9 for layers 1 and 2, K10 for all three, each call
    # its plan's launches (one in the fp32 persistent designs)
    fwd_n = tiled_fwd_calls(cfg32, FLAG_B, 1024, FLAG_S)
    want = {"tiled_fwd_embed": 4 * fwd_n, "tiled_fwd_scan": 8 * fwd_n,
            "tiled_bwd": 12 * tiled_bwd_calls(cfg32, FLAG_B, 1024, FLAG_S)}
    print(f"  flagship fp32, 2 steps from the run's state, plain at the same "
          f"seeds: bits rel (tol {LOSS_RTOL['float32']:g}) and gradients "
          f"normalised (tol {TRAIN_TOL:g}) within: "
          + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
          + f"; launches {tiled}, adagrad {k11.launches}", flush=True)
    print("  flagship fp32 against the plain path in float64 (not gated), "
          "normalised, kernels/plain: "
          + ", ".join(f"{k} {ek:.3e}/{ep:.3e}" for k, (ek, ep) in worst64.items()),
          flush=True)
    for name, err in worst.items():
        tol = LOSS_RTOL["float32"] if name == "bits" else TRAIN_TOL
        if not np.isfinite(err) or err > tol:
            fail(f"flagship fp32 {name}: kernels against plain {err:.3e}")
    resident = {name: fn.launches for name, fn in counters.items()
                if not name.startswith("head")}
    if tiled != want or any(resident.values()) or k11.launches != 2:
        fail(f"flagship fp32 steps: tiled launches {tiled} (the shapes give "
             f"{want}), resident launches {resident} (expected none), "
             f"adagrad {k11.launches} (expected 2)")
    # the fp32 flagship step (the default dtype at full width) with K8, K9
    # and K10 in their fp32 persistent designs and all three forced
    # per-step, FP32_STEPS steps each from the state above, timed over the
    # last FP32_TIMED
    times = {}
    for label, force in (("their fp32 persistent designs", contextlib.nullcontext()),
                         ("their per-step designs",
                          per_step_tiled(FWD_PLANS + BWD_PLANS))):
        s_, took = st, []
        with force:
            for _ in range(FP32_STEPS):
                win = trainer.feeder.next_device_batch()[0].to(torch.int32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s_, _ = train_step(s_, win[:-1], win[1:], cfg32, trainer.dcfg,
                                   trainer.tcfg, trainer.length, paths[0],
                                   trainer.generator)
                torch.cuda.synchronize()
                took.append(time.perf_counter() - t0)
        times[label] = 1e3 * statistics.fmean(took[-FP32_TIMED:])
        del s_
    print("  flagship fp32 step (3x1024, B=128, S=256, dropout "
          f"{FLAG_DROP}), the mean of the last {FP32_TIMED} of {FP32_STEPS}: "
          + ", ".join(f"K8-K10 in {k} {v:.2f} ms" for k, v in times.items()),
          flush=True)
    return counts, step_ms, tiled, trainer


# --- generation (3x1024 flagship, B = 1 and 128, 256 and 1000 tokens) -----
GEN_TOKENS, GEN_TIME_TOKENS, GEN_PRIME = 256, 1000, 64
GEN_SEED = -123456789        # a negative int32: its bits seed the draws
# Phase 8's gate, a teacher-forced replay: from K7's own state after step
# t-1 and its token, with each layer fed K7's own h of the layer below
# (and the head K7's top h), the plain version's step gives h and c within
# GEN_ATOL of K7's (the fp32 sums in another order only, as phase 7a), and
# K7's token scores within GEN_SCORE_RTOL * (1 + |max|) of the plain step's
# largest score: the hash is exact and the two logs agree to an ulp. Fed
# its own h instead, a layer of a bf16 step can see a flipped bf16
# rounding of its input, which moves its h by more than GEN_ATOL.
GEN_ATOL = 1e-4
GEN_SCORE_RTOL = 1e-4


def gen_bound(cfg, b, length):
    """K7's least time, ms: bytes = every layer's [W; U] and Why once in the
    compute type, b and by in fp32, the first tokens, h0 and c0 in and hT
    and cT out in fp32, the ids; flops = 2 * length * B * the elements of
    the products, layer 0's one-hot rows left out (a gather: K7 adds the
    row W_0[ch], as K1's and K3's bounds count it). Also the time to read
    the weights once at the memory rate, which a design that streams them
    at every token pays each token."""
    n, m, L = cfg.hidden, cfg.vocab, cfg.num_layers
    elems = (m + n) * 4 * n + (L - 1) * 2 * n * 4 * n + n * m
    elems_ops = elems - m * 4 * n
    csz = torch.finfo(cfg.cdtype).bits // 8
    weights = elems * csz + (L * 4 * n + m) * 4
    nbytes = weights + b * 4 + 4 * L * b * n * 4 + length * b * 4
    ms, by = _bound(nbytes, 2 * length * b * elems_ops, cfg)
    return ms, by, weights / HBM_BYTES_PER_S * 1e3


def primed(params, cfg, test, b):
    """(first, h, c) of B streams after GEN_PRIME bytes of the held-out
    split, each stream at its own offset, through the eval path's kernels."""
    from eigen_lstm_tpu_torch.models import lstm as model
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn

    starts = np.arange(b) * ((len(test) - GEN_PRIME - 1) // b)
    win = np.stack([test[s:s + GEN_PRIME + 1] for s in starts]).T
    ids = torch.from_numpy(win.astype(np.int32)).to(DEVICE)
    h0, c0 = model.init_state(cfg, b, device=DEVICE)
    with torch.no_grad():
        _, (h, c) = model.forward(params, ids[:-1], h0, c0, cfg,
                                  select_cell_fn("auto", cfg, b, DEVICE))
    return ids[-1], h, c


def gen_replay(params, cfg, first, h0, c0, temp, label):
    """K7 for GEN_TOKENS tokens with its state after every token, each step
    replayed by the plain version (gated), then the plain version's own
    free run (printed); a second call from the same state must give the
    same ids and (hT, cT) bit for bit (gated). Returns the largest h/c
    error of the replay."""
    from eigen_lstm_tpu_torch.ops import cuda_sampler as cs

    ids, (hT, cT), (th, tc) = cs.generate(params, cfg, GEN_SEED, first, h0,
                                          c0, GEN_TOKENS, temp, trace=True)
    ids2, (hT2, cT2) = cs.generate(params, cfg, GEN_SEED, first, h0, c0,
                                   GEN_TOKENS, temp)
    torch.cuda.synchronize()
    s, L, b, n = th.shape
    if (not torch.isfinite(th).all() or not torch.isfinite(tc).all()
            or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab):
        fail(f"K7 {label}: non-finite state or ids outside the vocabulary")
    if not (torch.equal(hT, th[-1].to(cfg.pdtype))
            and torch.equal(cT, tc[-1].to(cfg.pdtype))):
        fail(f"K7 {label}: (hT, cT) is not the state after the last token")
    if not (torch.equal(ids, ids2) and torch.equal(hT, hT2)
            and torch.equal(cT, cT2)):
        fail(f"K7 {label}: two calls from the same state differ")
    rows_of = lambda x: x.permute(1, 0, 2, 3).reshape(L, s * b, n)
    h_prev = rows_of(torch.cat([h0.float()[None], th[:-1]]))
    c_prev = rows_of(torch.cat([c0.float()[None], tc[:-1]]))
    ch_prev = torch.cat([first.to(torch.int32)[None], ids[:-1]]).reshape(-1)
    packed = cs.pack_weights(params, cfg)
    wus = [w.float() for w in cs.layer_weights(packed.WU, cfg)]
    steps = torch.arange(s, device=DEVICE).repeat_interleave(b)
    rows = torch.arange(b, device=DEVICE).repeat(s)
    h_k, c_k = rows_of(th), rows_of(tc)
    h_r, c_r, scores = cs.plain_step(wus, packed, h_prev, c_prev, ch_prev,
                                     cfg, GEN_SEED, steps, rows, temp,
                                     inputs=h_k)
    err = max(max_err(h_r, h_k)[0], max_err(c_r, c_k)[0])
    mx = scores.max(dim=-1).values
    chosen = scores.gather(-1, ids.reshape(-1, 1).long())[:, 0]
    short = float(((mx - chosen) / (1 + mx.abs())).max())
    ids_p = cs.generate_plain(params, cfg, GEN_SEED, first, h0, c0,
                              GEN_TOKENS, temp)[0]
    same = (ids_p == ids)
    diverged = (~same).any(dim=1).nonzero()
    print(f"  K7 {label}: {s} steps replayed, h/c within {err:.3e} (atol "
          f"{GEN_ATOL:g}), its tokens within {short:.3e} of the plain "
          f"step's best score (rtol {GEN_SCORE_RTOL:g}); a second call the "
          f"same bits; free runs: "
          f"{int(same.sum())} of {same.numel()} tokens equal, first "
          f"difference at step "
          f"{int(diverged[0]) if len(diverged) else 'none'} (not gated)",
          flush=True)
    if not err <= GEN_ATOL or not short <= GEN_SCORE_RTOL:
        fail(f"K7 {label}: the replay is out of tolerance")
    return err


def gen_design(cfg, b):
    """A label of K7's design as ``gen_plan`` chose it, and its layout."""
    from eigen_lstm_tpu_torch.ops import cuda_sampler as cs

    lay = cs.device_gen_plan(cfg, b)
    if lay is None:
        return "the first design (2L + 1 barriers a token, partial sums)", None
    return (f"the persistent design ({lay.design} product, {lay.grid} blocks, "
            f"tiles of {lay.units} units x 4 gates and {lay.rows} rows, head "
            f"items of {lay.head_rows} rows, {lay.resident_rows} weight rows "
            f"held a block, {lay.smem} bytes of shared memory)", lay)


@contextlib.contextmanager
def gen_forced(layout):
    """K7's wrapper takes ``layout`` (None: the first design), whatever
    ``gen_plan`` would choose: for the checks and times of the designs the
    main path does not take."""
    from eigen_lstm_tpu_torch.ops import cuda_sampler

    plan = cuda_sampler.device_gen_plan
    cuda_sampler.device_gen_plan = lambda *a, **k: layout
    try:
        yield
    finally:
        cuda_sampler.device_gen_plan = plan


def cli_sample(dtype):
    """``cli sample`` of the flagship at the CLI's defaults (B = 1, T = 1,
    1000 bytes, seed 0), ``--dtype`` ``dtype``, with K7's counts reset
    before and read after and ``sample_text`` timed (host clock between
    synchronisations; the checkpoint's load not included). Returns (the
    text, its seconds, K7's launches, the persistent design's)."""
    import io

    from eigen_lstm_tpu_torch import cli
    from eigen_lstm_tpu_torch.models import sampler
    from eigen_lstm_tpu_torch.ops import cuda_sampler as cs

    argv = ["sample", "--ckpt", FLAGSHIP, "--data", CORPUS, "--hidden", "1024",
            "--layers", "3"] + (["--dtype", dtype] if dtype != "float32" else [])
    real, took = sampler.sample_text, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = real(*a, **k)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
        return text

    buf = io.StringIO()
    cs.generate.launches = cs.generate.persistent_launches = 0
    sampler.sample_text = timed
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        sampler.sample_text = real
    return (buf.getvalue()[:-1], took[0], cs.generate.launches,
            cs.generate.persistent_launches)


def phase8(test, records):
    """K7 against its plain version with the flagship's weights, fp32 and
    bf16, B = 1 and 128, T = 0 and 0.7, from primed states, every design
    the card runs (the persistent design of each type, and forced the
    first design and, at B = 1, the other product: bf16's tensor-core one,
    fp32's FFMA one); then the times of 1000-token calls beside the bound,
    the plain version (one call), and the first design's in the same call
    (one window; the other product's, settled, and the loop backend's,
    the path before K7, no longer timed);
    then ``sample_ids`` on the default backend at B = 128 in bf16 and fp32
    (the persistent design) and in fp32 at B = 256 (the first design, by
    plan), and ``cli sample`` at its defaults (fp32) and in bf16, with
    K7's counts reset before and read after each. Returns the launches of
    those runs: {"bfloat16": the bf16 persistent design's, "float32": the
    fp32 persistent design's, "first": the first design's}."""
    from eigen_lstm_tpu_torch.models.sampler import sample_ids
    from eigen_lstm_tpu_torch.ops import cuda_sampler as cs
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    params = load_params(FLAGSHIP, flagship_cfg("float32"), DEVICE)
    for dtype in ("float32", "bfloat16"):
        cfg = flagship_cfg(dtype)
        for b in (1, 128):
            first, h0, c0 = primed(params, cfg, test, b)
            label, lay = gen_design(cfg, b)
            print(f"  K7 {dtype} B={b}: {label}", flush=True)
            if lay is None:
                fail(f"K7 {dtype} B={b}: {label}; the persistent design in "
                     f"both types")
            # the designs this call checks and times: the main path's, then
            # forced the first design and B = 1's other product
            others = {"first design": None}
            if b == 1:
                alt, = (d for d in cs.GEN_DESIGNS[cfg.cdtype] if d != lay.design)
                others[f"{alt} product"] = cs.device_gen_plan(cfg, b, design=alt)
            before = (cs.generate.launches, cs.generate.persistent_launches)
            err = max(gen_replay(params, cfg, first, h0, c0, temp,
                                 f"{dtype} B={b} T={temp}")
                      for temp in (0.0, 0.7))
            made = (cs.generate.launches - before[0],
                    cs.generate.persistent_launches - before[1])
            if made != (4, 4):
                fail(f"K7 {dtype} B={b}: {made} (all, persistent) launches "
                     f"in four calls")
            other_err = {}
            for key, other in others.items():
                with gen_forced(other):
                    other_err[key] = max(gen_replay(params, cfg, first, h0, c0,
                                                    temp, f"{dtype} B={b} T={temp} ({key})")
                                         for temp in (0.0, 0.7))
            n_tok = GEN_TIME_TOKENS
            run = lambda fn, **kw: fn(params, cfg, GEN_SEED, first, h0, c0,
                                      n_tok, 0.7, **kw)
            ms = cuda_ms(lambda: run(cs.generate), reps=1, windows=3)
            # the first design, whose time the gate below reads, in one
            # window; the plain version in one call (seconds of PyTorch ops:
            # the warm-up call bought nothing); the loop backend, the path
            # before K7, no longer timed
            with gen_forced(others["first design"]):
                times = {"first design": cuda_ms(lambda: run(cs.generate), reps=1,
                                                 windows=1)}
            plain_ms = once_ms(lambda: run(cs.generate_plain))
            bound_ms, bound_by, read_ms = gen_bound(cfg, b, n_tok)
            print(f"  K7 {dtype} B={b}, {n_tok} tokens: {ms:.3f} ms "
                  f"({1e3 * ms / n_tok:.2f} us a token, "
                  f"{b * n_tok / ms * 1e3:,.0f} bytes/s), bound "
                  f"{bound_ms:.4f} ms ({bound_by}; the weights read once "
                  f"{1e3 * read_ms:.2f} us), plain {plain_ms:.1f} ms"
                  + "".join(f"; {k} {v:.3f} ms" for k, v in times.items())
                  + (" in this call" if times else ""), flush=True)
            if not ms < times["first design"]:
                fail(f"K7 {dtype} B={b}: the persistent design ({ms:.3f} ms) "
                     f"is not faster than the first ({times['first design']:.3f})")
            rec = dict(
                name="gen" if dtype == "bfloat16" else "gen_fp32", route="cuda",
                source=("eigen_lstm_tpu_torch/csrc/sampler.cu" if dtype == "bfloat16"
                        else "eigen_lstm_tpu_torch/csrc/sampler_f32.cu"),
                replaces="eigen_lstm_tpu/ops/pallas_sampler.py:37",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            records[("gen", dtype, b)] = dict(
                rec, **{k.replace(" ", "_") + "_ms": v for k, v in times.items()})
            # the first design, forced on these inputs (fp32 B = 128 is its
            # record: refused shapes take it by plan)
            records[("gen_first", dtype, b)] = dict(
                rec, name="gen_first_design", source="eigen_lstm_tpu_torch/csrc/sampler.cu",
                max_abs_err=other_err["first design"], ms=times["first design"])
    print("  library: no single PyTorch call generates tokens through an "
          "LSTM stack with a draw", flush=True)
    made = {"bfloat16": 0, "float32": 0, "first": 0}
    for dtype, b in (("bfloat16", 128), ("float32", 128), ("float32", 256)):
        cfg = flagship_cfg(dtype)
        first, h0, c0 = primed(params, cfg, test, b)
        torch.cuda.synchronize()
        cs.generate.launches = cs.generate.persistent_launches = 0
        t0 = time.perf_counter()
        ids, _ = sample_ids(params, cfg,
                            torch.Generator(device=DEVICE).manual_seed(1),
                            first, h0, c0, GEN_TIME_TOKENS, 0.7)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, persistent = cs.generate.launches, cs.generate.persistent_launches
        label, lay = gen_design(cfg, b)
        print(f"  sample_ids {dtype} B={b}, {GEN_TIME_TOKENS} tokens on the "
              f"default backend: {ids.numel() / dt:,.0f} bytes/s ({dt:.3f} s), "
              f"K7 launched {launches} times, {persistent} in its persistent "
              f"design ({label})", flush=True)
        want = int(b <= 128)   # past 128 streams the plan keeps the first design
        if (launches != 1 or persistent != want or (lay is not None) != bool(want)
                or tuple(ids.shape) != (GEN_TIME_TOKENS, b)):
            fail(f"sample_ids {dtype} at B = {b} did not run K7 once in its "
                 f"{'persistent' if want else 'first'} design")
        made[dtype if want else "first"] += launches
    # the CLI's sample at its defaults (fp32), beside bf16
    rate = {}
    for dtype in ("float32", "bfloat16"):
        text, secs, launches, persistent = cli_sample(dtype)
        label = gen_design(flagship_cfg(dtype), 1)[0]
        rate[dtype] = SAMPLE_CHARS / secs
        print(f"  cli sample --dtype {dtype} (B = 1, T = 1, {SAMPLE_CHARS} "
              f"bytes): {rate[dtype]:,.1f} bytes/s through sample_text "
              f"({secs:.3f} s), K7 launched {launches} times, {persistent} in "
              f"{label}; {text[:60]!r}", flush=True)
        if len(text) != SAMPLE_CHARS or (launches, persistent) != (1, 1):
            fail(f"cli sample --dtype {dtype}: {len(text)} bytes, K7 launched "
                 f"{launches} times, {persistent} persistent; expected "
                 f"{SAMPLE_CHARS} bytes and one persistent launch")
        made[dtype] += persistent
    print(f"  cli sample: fp32 {rate['float32']:,.1f} bytes/s against bf16's "
          f"{rate['bfloat16']:,.1f} ({rate['float32'] / rate['bfloat16']:.2f}x)",
          flush=True)
    return made


# --- the tiled-U regime (scripts/run_configs.py 5b: 1x2048, B = 128, S = 100)
TILED = ("tiled_fwd_embed", "tiled_fwd_scan", "tiled_bwd")
TILED_REPLACES = {
    "tiled_fwd_embed": "eigen_lstm_tpu/ops/pallas_cell_tiled.py:429",
    "tiled_fwd_scan": "eigen_lstm_tpu/ops/pallas_cell_tiled.py:52",
    "tiled_bwd": "eigen_lstm_tpu/ops/pallas_cell_tiled.py:106",
}
TILED_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tiled.cu"
# the tiled kernels' fp32 persistent designs
TILED_F32_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tiled_f32.cu"
# the resident design's kernel for the same work, timed beside each
RESIDENT = {"tiled_fwd_embed": "K1", "tiled_fwd_scan": "K2",
            "tiled_bwd": "K6, with its dU and dh0"}
B5_S, B5_B, B5_N = 100, 128, 2048
ENWIK6 = "data/enwik6.txt"
# The 5b recipe as the CLI takes it (run_configs.py:114-120: 1x2048, loss on
# every step, bf16, enwik6 with 99 % for training, B = 128, S = 100, lr
# 0.005 after 200 warm-up steps at lr 0, supersteps of 10, seed 0;
# ``--residual-dtype auto`` resolves to bf16 at hidden 2048, as 5b sets it).
# The run there is 400 steps; here the warm-up and 100 steps at lr 0.005.
B5_WARMUP, B5_STEPS = 200, 300
B5_ARGV = [
    "train", "--data", ENWIK6, "--train-percent", "0.99", "--hidden", "2048",
    "--layers", "1", "--batch", str(B5_B), "--seq", str(B5_S), "--dtype",
    "bfloat16", "--loss-mode", "all", "--lr", "0.005", "--warmup",
    str(B5_WARMUP), "--superstep", "10", "--steps", str(B5_STEPS),
    "--sample-chars", "0", "--seed", "0",
]
# K10 stores dg in the xw type: under bf16 the kernel's dg_t must be the
# bf16 rounding (within 2^-8 of the value) of a value within TRAIN_TOL
# (normalised) of the plain replay's fp32 dg_t.
BF16_ROUNDING = 2.0 ** -8


def b5_cfg(residual="bfloat16", **kw):
    from eigen_lstm_tpu_torch import ModelConfig

    return ModelConfig(hidden=B5_N, num_layers=1, loss_mode="all",
                       compute_dtype="bfloat16", residual_dtype=residual, **kw)


def tiled_bound(cfg, s, b, n):
    """K10's least time, ms: bytes = U + the g and c residuals + c0, dhT,
    dcT, dc0 + the dh_seq cotangent and dg_seq, both in the xw type;
    flops = 2*S*B*4N*N for dg @ U^T (dh0 and the weight gradients are
    products outside the kernel, as in the JAX VJP)."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    rsz = 2 if cfg.residual_dtype == "bfloat16" else 4
    nbytes = (n * 4 * n * csz + s * b * 5 * n * rsz + 4 * b * n * 4
              + s * b * n * csz + s * b * 4 * n * csz)
    return _bound(nbytes, 2 * s * b * 4 * n * n, cfg)


def tiled_bwd_check(U, fwd_out, h0, c0, dh_seq, dhT, dcT, cfg, dropout, mask,
                    inv, tag, per_call, persistent, timed=True):
    """K10 at the training shapes: every reverse step replayed from the
    kernel's own dg_{t+1} with the cotangent rounded to the xw type and
    masked explicitly, dh0 against round(dg_0) @ U^T in fp32, and the
    window against the plain version given the explicitly masked cotangent
    (fp32 gated, bf16 printed). The bf16 persistent design hands out its
    fp32 dg too: that is held to the replay, and its bf16 dg must be it
    rounded, bit for bit; the per-step design's bf16 dg is held beyond its
    own rounding; an fp32 dg (either design) is held as it is. Returns the
    record (its time when ``timed``)."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    g_seq, c_seq = fwd_out[3], fwd_out[2]
    s, b, n = c_seq.shape
    _, _, xd = ct.types(cfg)
    dg32 = (torch.empty(s, b, 4 * n, device=DEVICE)
            if persistent and xd == torch.bfloat16 else None)
    dh0_k = torch.empty(b, n, device=DEVICE)
    before = ct.tiled_bwd.launches
    dg_k, dc_k = ct.tiled_bwd(U, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg,
                              dropout=dropout, dh0_out=dh0_k, dg_out=dg32)
    per_call["tiled_bwd"] = ct.tiled_bwd.launches - before
    dh_x = dh_seq.to(xd).float()
    dh_eff = dh_x if dropout is None else masked(dh_x, mask, inv)
    dg_p, dc_p = ct.tiled_bwd_plain(U, g_seq, c_seq, c0, dh_eff, dhT, dcT, cfg)
    torch.cuda.synchronize()
    if dg_k.dtype != xd or not torch.isfinite(dg_k.float()).all() \
            or not torch.isfinite(dc_k).all() or not torch.isfinite(dh0_k).all():
        fail(f"tiled_bwd {tag}: dg_seq, dc0 or dh0 not finite, or dg_seq not "
             f"in the xw type {xd}")
    rep_dg, rep_dh0, rep_dc = reverse_replay(U.to(cfg.cdtype), g_seq, c_seq, c0,
                                             dh_eff, dhT, dcT, cfg, dg_k.float())
    if dg32 is not None:
        dg_err = norm_err(dg32, rep_dg)
        if not torch.equal(dg_k, dg32.to(xd)):
            fail(f"tiled_bwd {tag}: the persistent design's dg_seq is not its "
                 f"fp32 dg rounded to {xd}")
        how = "fp32 dg; its bf16 dg that rounded, bit for bit"
    else:
        slack = BF16_ROUNDING if xd == torch.bfloat16 else 0.0
        dg_err = float(((dg_k.float() - rep_dg).abs() - slack * rep_dg.abs())
                       .clamp_min(0).max() / rep_dg.abs().max())
        how = "beyond dg's bf16 rounding" if slack else "fp32 dg"
    step_err = max(dg_err, norm_err(dc_k, rep_dc), norm_err(dh0_k, rep_dh0))
    if not np.isfinite(step_err) or step_err > TRAIN_TOL:
        fail(f"tiled_bwd {tag}: {step_err:.3e} of its plain replay > "
             f"{TRAIN_TOL:g}")
    window = [f"dg_seq {norm_err(dg_k, dg_p):.3e}", f"dc0 {norm_err(dc_k, dc_p):.3e}"]
    if cfg.cdtype == torch.float32 and max(norm_err(dg_k, dg_p),
                                           norm_err(dc_k, dc_p)) > TRAIN_TOL:
        fail(f"tiled_bwd {tag} window: {window}")
    print(f"  tiled_bwd {tag}: {per_call['tiled_bwd']} launches; every reverse "
          f"step, dh0 and dc0 within {step_err:.3e} (normalised; {how}) of the "
          f"plain replay from the kernel's own dg"
          f"{' with the host mask' if dropout else ''} (tol {TRAIN_TOL:g}); "
          f"window against plain with explicit masks ("
          + (f"tol {TRAIN_TOL:g}" if cfg.cdtype == torch.float32 else
             "bf16, not gated") + "): " + ", ".join(window), flush=True)
    source = TILED_SOURCE if cfg.cdtype == torch.bfloat16 else BWD_F32_SOURCE
    rec = dict(name="tiled_bwd", route="cuda", source=source,
               replaces=TILED_REPLACES["tiled_bwd"], launches=None,
               max_abs_err=step_err, dg=dg_k)
    if not timed:
        return rec
    rec["ms"] = cuda_ms(lambda: ct.tiled_bwd(U, g_seq, c_seq, c0, dh_seq, dhT,
                                             dcT, cfg, dropout=dropout),
                        reps=1, windows=3)
    rec["plain_ms"] = once_ms(lambda: ct.tiled_bwd_plain(
        U, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg, dropout))
    rec["bound_ms"], rec["bound_by"] = tiled_bound(cfg, s, b, n)
    return rec


def tiled_products_check(dg, h_seq, h0, cfg, tag, per_call):
    """The tiled VJPs' dU under bf16 compute: on tensor cores
    (``tensor_core_dU``, K6's dU kernel; dh0, the persistent K10's own last
    product, is held in ``tiled_bwd_check``) against the fp32 product of
    ``_mm`` on the same bf16 inputs.
    bf16 products are exact in fp32, so only the order of the fp32 sums
    differs: gated at TRAIN_TOL, normalised. Returns (dU's time on tensor
    cores, through ``_mm``), ms."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    before = ct.tensor_core_dU.launches
    dU = ct.tensor_core_dU(dg, h_seq, h0, cfg)
    per_call["tiled_dU"] = ct.tensor_core_dU.launches - before
    ref = ct._dU(dg, h_seq, h0, cfg, plain=True)
    torch.cuda.synchronize()
    err = norm_err(dU, ref)
    tc_ms = cuda_ms(lambda: ct.tensor_core_dU(dg, h_seq, h0, cfg), reps=2, windows=3)
    mm_ms = cuda_ms(lambda: ct._dU(dg, h_seq, h0, cfg, plain=True), reps=2, windows=3)
    print(f"  tiled dU {tag}: tensor cores ({per_call['tiled_dU']} launches) "
          f"within {err:.3e} of _mm's fp32 product (normalised, tol "
          f"{TRAIN_TOL:g}); {tc_ms:.4f} ms against _mm's {mm_ms:.4f} ms",
          flush=True)
    if not np.isfinite(err) or err > TRAIN_TOL:
        fail(f"tiled dU {tag}: {err:.3e} of _mm's > {TRAIN_TOL:g}")
    return tc_ms, mm_ms


# K8 and K9's per-step design (one launch a step) as PERF.md §6 rows 6 and
# 8 record it (NVIDIA H100 80GB HBM3, 700 W): bf16 at the 5b shapes and
# fp32 at the flagship's, without and with dropout 0.35
TILED_PER_STEP_RECORDED_MS = {
    ("tiled_fwd_embed", "bfloat16"): {0.0: 16.70, FLAG_DROP: 16.68},
    ("tiled_fwd_scan", "bfloat16"): {0.0: 17.02, FLAG_DROP: 16.84},
    ("tiled_fwd_embed", "float32"): {0.0: 22.11, FLAG_DROP: 22.54},
    ("tiled_fwd_scan", "float32"): {0.0: 23.97, FLAG_DROP: 24.14},
    ("tiled_bwd", "bfloat16"): {0.0: 29.62, FLAG_DROP: 30.03},
    ("tiled_bwd", "float32"): {0.0: 46.33, FLAG_DROP: 46.42},
}


def tiled_design(cfg, b, n):
    """K8/K9's design at these shapes on this card, as their wrappers
    choose it (``cuda_cell_tiled.tiled_fwd_plan``): a label, and whether
    it is persistent."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import (PERSIST_UNITS,
                                                          device_tiled_fwd_plan)

    kres = device_tiled_fwd_plan(cfg, b, n)
    if kres is None:
        return "the per-step design (one launch a step)", False
    return (f"the persistent design ({n // PERSIST_UNITS} blocks of "
            f"{PERSIST_UNITS} units and all {b} batch rows, {kres} of U's {n} "
            f"rows in shared memory, one cooperative launch a window)"), True


def tiled_bwd_design(cfg, b, n):
    """K10's design at these shapes on this card, as its wrapper chooses
    it (``cuda_cell_tiled.tiled_bwd_plan``, under fp32 compute
    ``tiled_bwd_f32_plan``, K6's fp32 design in pairs): a label, and
    whether it is persistent (one launch a call)."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import (
        BWD_KC, BWD_UNITS, device_tiled_bwd_f32_plan, device_tiled_bwd_plan)

    layout = device_tiled_bwd_f32_plan(cfg, b, n)
    if layout is not None:
        return (f"K6's fp32 persistent design ({n // 16} pairs of blocks, "
                f"each block half the gate axis of 16 units and all {b} batch "
                f"rows, U's rows in shared memory, a ring of {layout.stages} "
                f"slots of dg, one cooperative launch a window, CUDA "
                f"cores)"), True
    plan = device_tiled_bwd_plan(cfg, b, n)
    if plan is None:
        return "the per-step design (one launch a step)", False
    rows, cres = plan
    return (f"the persistent design ({n // BWD_UNITS * -(-b // rows)} blocks "
            f"of {BWD_UNITS} units and {rows} batch rows, {cres} of U's "
            f"{4 * n // BWD_KC} chunks in shared memory, one cooperative "
            f"launch a window)"), True


def tiled_bwd_calls(cfg, b, n, s):
    """K10's launches a call of ``s`` steps as its plans give them."""
    return 1 if tiled_bwd_design(cfg, b, n)[1] else s


# The plans of the tiled kernels (``cuda_cell_tiled``), the names that
# ``per_step_tiled`` replaces to force their per-step designs: K8's and
# K9's under either compute type, K10's
FWD_PLANS = ("device_tiled_fwd_plan", "device_tiled_fwd_f32_plan")
BWD_PLANS = ("device_tiled_bwd_plan", "device_tiled_bwd_f32_plan")


def tiled_fwd_design(cfg, b, n):
    """K8's and K9's design at these shapes on this card, as
    ``tiled_embed_layer0`` and ``tiled_scan_layer`` choose it (under fp32
    compute ``tiled_fwd_f32_plan``, else ``tiled_fwd_plan``): a label, and
    whether it is persistent (one launch a call)."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import (F32_UNITS,
                                                          device_tiled_fwd_f32_plan)

    layout = device_tiled_fwd_f32_plan(cfg, b, n)
    if layout is None:
        return tiled_design(cfg, b, n)
    return (f"the fp32 persistent design ({n // F32_UNITS} blocks of "
            f"{F32_UNITS} units and all {b} batch rows, U's slice in shared "
            f"memory, a ring of {layout.stages} slots of {layout.kc} columns "
            f"of h, one cooperative launch a window, CUDA cores)"), True


def tiled_fwd_calls(cfg, b, n, s):
    """K8's (or K9's) launches a call of ``s`` steps as their plans give
    them."""
    return 1 if tiled_fwd_design(cfg, b, n)[1] else s


@contextlib.contextmanager
def per_step_tiled(names=("device_tiled_fwd_plan",)):
    """The tiled kernels whose plans are ``names`` (K8 and K9's under bf16
    compute, and K2's, by default; FWD_PLANS and BWD_PLANS name the tiled
    kernels' in both types) take their per-step design inside the block,
    whatever the plan would choose: for the checks and times of that design
    where the main path takes the persistent one."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    plans = {name: getattr(ct, name) for name in names}
    for name in names:
        setattr(ct, name, lambda *a: None)
    try:
        yield
    finally:
        for name, plan in plans.items():
            setattr(ct, name, plan)


# K1's and K15's plans (``cuda_cell_tiled.split_fwd_plan``; under fp32
# compute ``split_fwd_f32_plan``), the names that ``per_step_tiled``
# replaces to force their other design
SPLIT_PLAN = ("device_split_fwd_plan", "device_split_fwd_f32_plan")
# the persistent tensor-core forward: K2, K8, K9 and, in bf16, K1 and K15
FWD_SOURCE = "eigen_lstm_tpu_torch/csrc/fwd_mma.cuh"


def split_design(cfg, b, n, k15=False):
    """K1's (or with ``k15`` K15's) design at these shapes on this card, as
    their wrappers choose it (``cuda_cell_tiled.split_fwd_plan``; under
    fp32 compute ``split_fwd_f32_plan``): a label, and whether it is
    persistent."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import (
        PERSIST_UNITS, F32_UNITS, device_split_fwd_f32_plan, device_split_fwd_plan)

    split = device_split_fwd_f32_plan(cfg, b, n)
    if split is not None:
        mode = "K9's kernel in K15's mode" if k15 else "K8's kernel in its EMBED mode"
        return (f"the fp32 persistent design ({mode}: "
                f"{n // F32_UNITS} x {-(-b // split.rows)} blocks of {F32_UNITS} "
                f"units and {split.rows} batch rows, {split.per} a thread, a ring of "
                f"{split.stages} slots of {split.kc} columns, one cooperative launch "
                f"a window)"), True
    layout = device_split_fwd_plan(cfg, b, n)
    if layout is None:
        return "its other design (K1: one launch a step; K15: cooperative)", False
    kres, rows = layout
    return (f"the persistent design ({n // PERSIST_UNITS} x {-(-b // rows)} "
            f"blocks of {PERSIST_UNITS} units and {rows} batch rows, {kres} of "
            f"U's {n} rows in shared memory, one cooperative launch a "
            f"window)"), True


# K2's plans (``cuda_cell.scan_layer``: ``tiled_fwd_plan`` under bf16
# compute, ``split_fwd_f32_plan`` under fp32), the names that
# ``per_step_tiled`` replaces to force its per-step design
K2_PLANS = ("device_tiled_fwd_plan", "device_split_fwd_f32_plan")


def k2_design(cfg, b, n):
    """K2's design at these shapes on this card, as ``scan_layer`` chooses
    it (under fp32 compute ``split_fwd_f32_plan``: K9's fp32 kernel with the
    batch split over block rows; under bf16 ``tiled_fwd_plan``): a label,
    and whether it is persistent (one launch a call)."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import (F32_UNITS,
                                                          device_split_fwd_f32_plan)

    if cfg.cdtype != torch.float32:
        return tiled_design(cfg, b, n)
    split = device_split_fwd_f32_plan(cfg, b, n)
    if split is None:
        return "the per-step design (one launch a step)", False
    return (f"the fp32 persistent design (K9's kernel: {n // F32_UNITS} x "
            f"{-(-b // split.rows)} blocks of {F32_UNITS} units and {split.rows} "
            f"batch rows, {split.per} a thread, a ring of {split.stages} slots of "
            f"{split.kc} columns, one cooperative launch a window)"), True


@contextlib.contextmanager
def unsplit_fwd():
    """K1's and K15's wrappers take the persistent design with every batch
    row in a block (K2's layout, ``tiled_fwd_plan``; K15's fp32 design
    unsplit) inside the block: the control of their split layout."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    plans = ct.device_split_fwd_plan, ct.device_split_fwd_f32_plan

    def unsplit(cfg, b, n):
        kres = ct.device_tiled_fwd_plan(cfg, b, n)
        return None if kres is None else (kres, b)

    def unsplit32(cfg, b, n):
        return ct.split_fwd_f32_plan(cfg, b, n, *ct._device_limits(
            torch.cuda.current_device()), split=False)

    ct.device_split_fwd_plan, ct.device_split_fwd_f32_plan = unsplit, unsplit32
    try:
        yield
    finally:
        ct.device_split_fwd_plan, ct.device_split_fwd_f32_plan = plans


def tiled_fwd_checks(l0, l1, x, h0, c0, cfg, run_cfg, dr, masks, inv, tag,
                     per_call, timed=True):
    """K8, then K9 on layer 1's xw from K8's stream, through the
    ``fwd_check`` gates, and where ``run_cfg`` keeps bf16 residuals the
    bf16-residual rule on both; returns (K8's output, K9's output in the
    residual type of ``run_cfg``, xw, K8's record, K9's record)."""
    from eigen_lstm_tpu_torch.ops import cell as cell_ops
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    s, b = x.shape
    n = cfg.hidden
    # the persistent designs' kernels: bf16 in fwd_mma.cuh, fp32 in
    # lstm_tiled_f32.cu
    source = FWD_SOURCE if cfg.cdtype == torch.bfloat16 else TILED_F32_SOURCE
    out1, rec8 = fwd_check("tiled_fwd_embed", "embed", ct.tiled_embed_layer0,
                           ct.tiled_embed_layer0_plain, l0, x, h0, c0, cfg,
                           dr[0], masks[0], inv, tag, per_call, source,
                           run_cfg, timed)
    h_in = (out1[4] if dr[0] else out1[0]).float()
    xw = (cell_ops.matmul(h_in.reshape(s * b, n), l1.W, cfg.cdtype)
          .reshape(s, b, 4 * n) + l1.b)
    out2, rec9 = fwd_check("tiled_fwd_scan", "scan", ct.tiled_scan_layer,
                           ct.tiled_scan_layer_plain, l1, xw, h0, c0, cfg,
                           dr[1], masks[1], inv, tag, per_call, source,
                           run_cfg, timed)
    if run_cfg is not cfg:
        for name, fn, lay_, seq, d, ref in (
                ("tiled_fwd_embed", ct.tiled_embed_layer0, l0, x, dr[0], out1),
                ("tiled_fwd_scan", ct.tiled_scan_layer, l1, xw, dr[1], out2)):
            check_bf16_residuals(f"{name} {tag}", fn(
                lay_, seq, h0, c0, run_cfg, residuals=True, dropout=d), ref)
        out2 = ct.tiled_scan_layer(l1, xw, h0, c0, run_cfg, residuals=True,
                                   dropout=dr[1])
    return out1, out2, xw, rec8, rec9


def phase9a(records):
    """K8, K9 and K10 against their plain versions at the 5b shapes (bf16;
    random weights that make the gates move, as the 5b recipe trains from
    random weights) and at the flagship's fp32 training shapes (its layers
    0 and 1), without and with dropout 0.35; in both types the three
    kernels' persistent designs (in fp32 their CUDA-core designs) and,
    forced, their per-step ones, each held to the same gates and timed in
    this run (the persistent must be the faster), and K8 and K9 at the
    eval batch of 16; times beside the bound, the plain version, K1/K2/K6
    at the same shapes and cuDNN; the heads' launches at the 5b shapes.
    Returns the launches of one call of each at the 5b shapes."""
    from eigen_lstm_tpu_torch.models.lstm import LayerParams
    from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd, head
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    calls = {}
    inv = torch.tensor(float(np.float32(1.0 / (1.0 - FLAG_DROP))), device=DEVICE)
    m = 256
    fwd = {"tiled_fwd_embed": ct.tiled_embed_layer0,
           "tiled_fwd_scan": ct.tiled_scan_layer}
    for dtype, s, n in (("bfloat16", B5_S, B5_N), ("float32", FLAG_S, 1024)):
        b = B5_B
        per_call = {}
        gen = torch.Generator().manual_seed(9)
        rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd).to(DEVICE)
        if dtype == "bfloat16":
            # the step replay reads the fp32 carry from fp32 residuals; the
            # path's bf16 residuals are checked against that run rounded
            cfg, run_cfg = b5_cfg("float32"), b5_cfg()
            lay = lambda in_dim: LayerParams(
                rand(in_dim, 4 * n, sd=0.3), rand(n, 4 * n, sd=0.3 / (n / 16) ** 0.5),
                rand(4 * n, sd=0.3))
            l0, l1 = lay(m), lay(n)
            x = corpus_window(ENWIK6, 0.99, gen, s, b)[0]
        else:
            cfg = run_cfg = flag_train_cfg("float32")
            params = load_params(FLAGSHIP, cfg, DEVICE)
            l0, l1 = params.layers[0], params.layers[1]
            x = corpus_window(CORPUS, 0.95, gen, s, b)[0]
        h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
        dh_seq = rand(s, b, n, sd=1e-3)
        dhT, dcT = rand(b, n, sd=1e-3), rand(b, n, sd=1e-3)
        masks = [host_masks(sd, s, b, n, FLAG_DROP) for sd in FLAG_SEEDS]
        onehot = torch.nn.functional.one_hot(x.long(), m).float()
        for drop in (0.0, FLAG_DROP):
            tag = f"{dtype} N={n} S={s} drop {drop:g}"
            dr = [(drop, sd) if drop else None for sd in FLAG_SEEDS]
            design, persistent = tiled_fwd_design(run_cfg, b, n)
            print(f"  tiled_fwd_embed, tiled_fwd_scan {tag}: {design}", flush=True)
            if not persistent:
                fail(f"tiled forward {tag}: K8 and K9 in {design}; these "
                     f"shapes take their persistent designs")
            out1, out2, xw, rec8, rec9 = tiled_fwd_checks(
                l0, l1, x, h0, c0, cfg, run_cfg, dr, masks, inv, tag, per_call)
            seqs = {"tiled_fwd_embed": (l0, x, dr[0]),
                    "tiled_fwd_scan": (l1, xw, dr[1])}
            # the per-step design, which the plans keep for other shapes
            # and cards, held to the same gates on the same inputs and
            # timed in this run
            step_call = {}
            with per_step_tiled(FWD_PLANS):
                tiled_fwd_checks(l0, l1, x, h0, c0, cfg, run_cfg, dr, masks,
                                 inv, tag + " (the per-step design)",
                                 step_call, timed=False)
                for rec in (rec8, rec9):
                    lay_, seq, d = seqs[rec["name"]]
                    rec["per_step_ms"] = cuda_ms(
                        lambda: fwd[rec["name"]](lay_, seq, h0, c0, run_cfg,
                                                 residuals=True, dropout=d),
                        reps=2, windows=3)
            if any(step_call[k] != s for k in fwd):
                fail(f"tiled forward {tag}, the per-step design: launches "
                     f"{step_call}, one a step gives {s}")
            if {k: per_call[k] for k in fwd} != {k: 1 for k in fwd}:
                fail(f"tiled forward {tag}: launches a call {per_call}, the "
                     f"plans give one each")
            design10, persistent10 = tiled_bwd_design(run_cfg, b, n)
            print(f"  tiled_bwd {tag}: {design10}", flush=True)
            if not persistent10:
                fail(f"tiled_bwd {tag}: {design10}; these shapes take the "
                     f"persistent design")
            bwd_args = (l1.U, out2, h0, c0, dh_seq, dhT, dcT, run_cfg, dr[1],
                        masks[1], inv)
            rec10 = tiled_bwd_check(*bwd_args, tag, per_call, persistent10)
            dg10 = rec10.pop("dg")
            if per_call["tiled_bwd"] != 1:
                fail(f"tiled_bwd {tag}: {per_call['tiled_bwd']} launches a "
                     f"call, {design10} gives 1")
            # the per-step design, which the plans keep for other shapes
            # and cards, held to its gates on the same inputs and timed in
            # this run
            step_call = {}
            with per_step_tiled(BWD_PLANS):
                tiled_bwd_check(*bwd_args, tag + " (the per-step design)",
                                step_call, False, timed=False)
                rec10["per_step_ms"] = cuda_ms(lambda: ct.tiled_bwd(
                    l1.U, out2[3], out2[2], c0, dh_seq, dhT, dcT, run_cfg,
                    dropout=dr[1]), reps=1, windows=3)
            if step_call["tiled_bwd"] != s:
                fail(f"tiled_bwd {tag}, the per-step design: "
                     f"{step_call['tiled_bwd']} launches, one a step gives {s}")
            for rec in (rec8, rec9, rec10):
                if not rec["ms"] < rec["per_step_ms"]:
                    fail(f"{rec['name']} {tag}: the persistent design "
                         f"{rec['ms']:.4f} ms is not faster than the per-step "
                         f"design {rec['per_step_ms']:.4f} ms in this call")
            if dtype == "bfloat16":
                # dU (and dh0) on tensor cores against _mm
                rec10["dU_ms"], rec10["dU_mm_ms"] = tiled_products_check(
                    dg10, out2[0], h0, run_cfg, tag, per_call)
            # the resident kernels at the same shapes (the path's types)
            k1 = cuda_ms(lambda: cuda_cell.embed_layer0(
                l0, x, h0, c0, run_cfg, residuals=True, dropout=dr[0]),
                reps=1, windows=3)
            k2 = cuda_ms(lambda: cuda_cell.scan_layer(
                l1, xw, h0, c0, run_cfg, residuals=True, dropout=dr[1]),
                reps=1, windows=3)
            h_in = (out1[4] if drop else out1[0]).float()
            res = cuda_cell.scan_layer(l1, xw, h0, c0, run_cfg, residuals=True)
            design6, persistent6 = k6_design(run_cfg, b, n)
            print(f"  lstm_bwd_scan {tag}: {design6}", flush=True)
            # fp32 at N = 1024: the fp32 persistent design; bf16 at N = 2048:
            # the per-step one
            if persistent6 != (dtype == "float32"):
                fail(f"lstm_bwd_scan {tag}: {design6}; these shapes take the "
                     f"{'fp32 persistent' if dtype == 'float32' else 'per-step'} "
                     f"design")
            k6 = cuda_ms(lambda: cuda_cell_bwd.scan_layer_bwd(
                l1.U.to(run_cfg.cdtype), res[3], res[2], res[0], h0, c0, dh_seq,
                dhT, dcT, run_cfg, dropout=dr[1]), reps=1, windows=3)
            libs = (library_ms(m, run_cfg, onehot, h0, c0),
                    library_ms(n, run_cfg, h_in, h0, c0),
                    library_lstm_bwd(run_cfg, h_in, h0, c0, dh_seq))
            for rec, lib, resident in zip((rec8, rec9, rec10), libs, (k1, k2, k6)):
                rec.update(replaces=TILED_REPLACES[rec["name"]], library_ms=lib,
                           resident_ms=resident)
                records[("9a", rec["name"], dtype, drop)] = rec
                old = TILED_PER_STEP_RECORDED_MS[(rec["name"], dtype)][drop]
                line = (f"; the per-step design {rec['per_step_ms']:.4f} ms "
                        f"in this run ({s} launches)" if "per_step_ms" in rec
                        else "")
                line += f"; PERF.md's per-step row {old} ms"
                if "dU_ms" in rec:
                    line += (f"; dU on tensor cores {rec['dU_ms']:.4f} ms, "
                             f"through _mm {rec['dU_mm_ms']:.4f} ms")
                print(f"  {rec['name']} {tag}: {rec['ms']:.4f} ms per window "
                      f"({per_call[rec['name']]} launches), plain "
                      f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
                      f"({rec['bound_by']}), the resident kernel "
                      f"({RESIDENT[rec['name']]}) {resident:.4f} ms, cuDNN nn.LSTM "
                      f"{'backward ' if 'bwd' in rec['name'] else ''}"
                      f"{'n/a' if lib is None else f'{lib:.4f} ms'}{line}",
                      flush=True)
        if dtype == "float32":
            tiled_f32_eval(l0, l1, gen, n, cfg, inv)
        if dtype == "bfloat16":
            calls = per_call
            tiled_eval_times(l0, l1, gen, n, run_cfg)
            # the heads at the 5b shapes (T = S*B, N = 2048): launches a
            # call and times
            t = s * b
            h_c = out1[0].reshape(t, n).to(cfg.cdtype)
            Why_c, by = rand(n, m, sd=0.01).to(cfg.cdtype), torch.zeros(m, device=DEVICE)
            tg, cot = x.reshape(t), torch.tensor(LN2 / t, device=DEVICE)
            before = head.head_fwd.launches
            _, lse = head.head_fwd(Why_c, by, h_c, tg, cfg)
            calls["head_fwd"] = head.head_fwd.launches - before
            before = head.head_bwd.launches
            bwd_k = head.head_bwd(Why_c, by, h_c, tg, lse, cot, cfg)
            calls["head_bwd"] = head.head_bwd.launches - before
            head_bwd_check(f"head_bwd {dtype} at T={t}, N={n}", bwd_k,
                           head.head_bwd_plain(Why_c, by, h_c, tg, lse, cot, cfg),
                           calls["head_bwd"], dtype)
            del bwd_k
            for name, fn in (("head_fwd", lambda: head.head_fwd(Why_c, by, h_c, tg, cfg)),
                             ("head_bwd", lambda: head.head_bwd(Why_c, by, h_c, tg,
                                                                lse, cot, cfg))):
                records[("9a", name)] = cuda_ms(fn, reps=5, windows=3)
            with cuda_core_head(("bwd_tensor_cores",)):
                core = cuda_ms(lambda: head.head_bwd(Why_c, by, h_c, tg, lse,
                                                     cot, cfg), reps=5, windows=3)
            print(f"  head_bwd {dtype} at T={t}, N={n}: "
                  f"{records[('9a', 'head_bwd')]:.4f} ms a call "
                  f"({'tensor-core' if head.bwd_tensor_cores(cfg, n, m) else 'CUDA-core'}"
                  f" design), the CUDA-core design {core:.4f} ms, bound "
                  f"{head_bound(cfg, t, n, m, True)[0]:.5f} ms", flush=True)
    return calls


def tiled_f32_eval(l0, l1, gen, n, cfg, inv):
    """K8 and K9 under fp32 compute at the eval batch of 16 (one
    CHUNK-step window), where their plan takes the persistent design:
    ``fwd_check``'s gates (every step replayed, with residuals) and one
    launch a call, then the eval call (no residuals) timed beside the
    per-step design (forced, held to the same gates, S launches a call) in
    this run; the persistent design must be the faster."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    s, b = CHUNK, EVAL_BATCH
    x = corpus_window(CORPUS, 0.95, gen, s, b)[0]
    xw = (torch.randn(s, b, 4 * n, generator=gen) * 0.3).to(DEVICE)
    h0 = (torch.randn(b, n, generator=gen) * 0.1).to(DEVICE)
    c0 = (torch.randn(b, n, generator=gen) * 0.1).to(DEVICE)
    design, persistent = tiled_fwd_design(cfg, b, n)
    tag = f"float32 at the eval batch (B={b}, S={s}, N={n})"
    if not persistent:
        fail(f"tiled forward {tag}: {design}")
    for name, kind, fn, plain, layer, seq in (
            ("tiled_fwd_embed", "embed", ct.tiled_embed_layer0,
             ct.tiled_embed_layer0_plain, l0, x),
            ("tiled_fwd_scan", "scan", ct.tiled_scan_layer,
             ct.tiled_scan_layer_plain, l1, xw)):
        calls = {}
        fwd_check(name, kind, fn, plain, layer, seq, h0, c0, cfg, None, None,
                  inv, tag, calls, timed=False)
        if calls[name] != 1:
            fail(f"{name} {tag}: {calls[name]} launches a call, {design} "
                 f"gives 1")
        call = lambda: fn(layer, seq, h0, c0, cfg)
        ms = cuda_ms(call, reps=2, windows=3)
        with per_step_tiled(FWD_PLANS):
            fwd_check(name, kind, fn, plain, layer, seq, h0, c0, cfg, None,
                      None, inv, tag + " (the per-step design)", calls,
                      timed=False)
            step_ms = cuda_ms(call, reps=2, windows=3)
        if calls[name] != s:
            fail(f"{name} {tag}, the per-step design: {calls[name]} launches "
                 f"a call, one a step gives {s}")
        bound_ms, bound_by = bound(kind, cfg, s, b, n, cfg.vocab)
        print(f"  {name} {tag}, no residuals: {design}; {ms:.4f} ms a window "
              f"(1 launch), the per-step design {step_ms:.4f} ms in this run, "
              f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
        if not ms < step_ms:
            fail(f"{name} {tag}: the persistent design {ms:.4f} ms is not "
                 f"faster than the per-step design {step_ms:.4f} ms")


def tiled_eval_times(l0, l1, gen, n, cfg):
    """K8 and K9 at the eval batch of 16 (one CHUNK-step window, no
    residuals, as ``evaluate_bpc`` calls them), both designs: launches a
    call, the times in this run beside the bound; the persistent design is
    gated as the one these shapes take."""
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

    s, b = CHUNK, EVAL_BATCH
    x = corpus_window(ENWIK6, 0.99, gen, s, b)[0]
    xw = (torch.randn(s, b, 4 * n, generator=gen) * 0.3).to(DEVICE)
    h0 = (torch.randn(b, n, generator=gen) * 0.1).to(DEVICE)
    c0 = (torch.randn(b, n, generator=gen) * 0.1).to(DEVICE)
    design, persistent = tiled_design(cfg, b, n)
    if not persistent:
        fail(f"tiled forward at the eval batch {b}: {design}")
    for name, fn, layer, seq, kind in (
            ("tiled_fwd_embed", ct.tiled_embed_layer0, l0, x, "embed"),
            ("tiled_fwd_scan", ct.tiled_scan_layer, l1, xw, "scan")):
        call = lambda: fn(layer, seq, h0, c0, cfg)
        before = fn.launches
        call()
        launched = fn.launches - before
        ms = cuda_ms(call, reps=2, windows=3)
        with per_step_tiled():
            step_ms = cuda_ms(call, reps=2, windows=3)
        bound_ms, bound_by = bound(kind, cfg, s, b, n, cfg.vocab)
        print(f"  {name} at the eval batch (B={b}, S={s}, N={n}, bf16, no "
              f"residuals): {design}; {ms:.4f} ms a window ({launched} "
              f"launches), the per-step design {step_ms:.4f} ms in this run, "
              f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
        if launched != 1:
            fail(f"{name} at the eval batch: {launched} launches a call, the "
                 f"persistent design gives 1")


def phase9b(records):
    """One enwik6 window through ``loss_fn`` of a 2x2048 model (the 5b
    widths at depth 2, so that K9 is on a model path; bf16 with bf16
    residuals, dropout 0.35, the recipe's random initialisation, a random
    carried state): the loss and all eight gradients through the kernels
    against the plain path, gated as phase 7b. The fp32 run, the control,
    keeps fp32 residuals: fp32 compute with bf16 residuals would round h to
    bf16 where an fp32 sum's order can flip it. Its K1, K2, K3 and K6 take
    their per-step design (N = 2048: no persistent plan takes it; their
    launches counted), K3 and K6 held to ``bwd_check``'s gates and timed at
    these shapes (the model's layers, their forward from the window's
    state). Returns (K3's and K6's launches, K1's, K2's) in the fp32
    window."""
    import dataclasses

    from eigen_lstm_tpu_torch.models.lstm import init_params, step_key
    from eigen_lstm_tpu_torch.ops import cell as cell_ops
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.ops import cuda_cell_bwd as cb
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
    from eigen_lstm_tpu_torch.ops.dispatch import families, select_cell_fn
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

    base = dataclasses.replace(b5_cfg(dropout=FLAG_DROP), num_layers=2)
    gen = torch.Generator().manual_seed(10)
    x, t = corpus_window(ENWIK6, 0.99, gen, B5_S, B5_B)
    h = (torch.randn(2, B5_B, B5_N, generator=gen) * 0.1).to(DEVICE)
    c = (torch.randn(2, B5_B, B5_N, generator=gen) * 0.1).to(DEVICE)
    params = init_params(base, device=DEVICE)
    key = step_key(1, 250)
    res = {}
    ct.reset_launches()
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype, residual_dtype=(
            "float32" if dtype == "float32" else base.residual_dtype))
        design, persistent = k6_design(cfg, B5_B, B5_N)
        print(f"  2x2048 {dtype}: families (layers >= 1, layer 0) "
              f"{families(cfg, B5_B)}; K6 at these shapes: {design}",
              flush=True)
        if persistent:
            fail(f"2x2048 {dtype}: K6's persistent design where the per-step "
                 f"one applies")
        for backend in ("cuda", "plain"):
            cell_fn = select_cell_fn(backend, cfg, B5_B, DEVICE)
            before = (cb.embed_layer0_bwd.launches, cb.scan_layer_bwd.launches,
                      cuda_cell.embed_layer0.launches, cuda_cell.scan_layer.launches)
            loss, _, _, grads = loss_and_grads(params, x, t, h, c, cfg,
                                               cell_fn, key)
            if (dtype, backend) == ("float32", "cuda"):
                per_step = (cb.embed_layer0_bwd.launches - before[0],
                            cb.scan_layer_bwd.launches - before[1])
                k1 = cuda_cell.embed_layer0.launches - before[2]
                k2 = cuda_cell.scan_layer.launches - before[3]
            res[(dtype, backend)] = (loss, dict(grads.named_tensors()))
    torch.cuda.synchronize()
    design1 = split_design(dataclasses.replace(base, compute_dtype="float32"),
                           B5_B, B5_N)[0]
    design2 = k2_design(dataclasses.replace(base, compute_dtype="float32"),
                        B5_B, B5_N)[0]
    print(f"  2x2048 fp32: K3, K6 launches {per_step} (their per-step design); "
          f"K1 {k1} ({design1}); K2 {k2} ({design2})", flush=True)
    if min(per_step) <= B5_S:
        fail(f"2x2048 fp32: K3, K6 launched {per_step} times; the per-step "
             f"design launches more than S a call")
    if k1 <= 0 or k1 % B5_S or k2 <= 0 or k2 % B5_S:
        fail(f"2x2048 fp32: K1, K2 launched {k1}, {k2} times; their per-step "
             f"design launches S = {B5_S} a call")
    launched = dict(zip(TILED, ct.launches()))
    print(f"  2x2048: tiled launches {launched}", flush=True)
    if min(launched.values()) <= 0:
        fail(f"2x2048 loss_fn: a tiled kernel was not launched: {launched}")
    compare_paths("2x2048 loss_fn", res, lambda k: k.endswith(FLAG_ROUNDED),
                  vs_drift=FLAG_BF16_VS_DRIFT)
    # K3 and K6 in fp32, the per-step design this window took, on the
    # model's layers 0 and 1 at these shapes
    cfg = dataclasses.replace(base, compute_dtype="float32",
                              residual_dtype="float32", dropout=0.0)
    s, b, n, m = B5_S, B5_B, B5_N, cfg.vocab
    l0, l1 = params.layers[0], params.layers[1]
    out1 = cuda_cell.embed_layer0(l0, x, h[0], c[0], cfg, residuals=True)
    h_in = out1[0].float()
    xw = (cell_ops.matmul(h_in.reshape(s * b, n), l1.W, cfg.cdtype)
          .reshape(s, b, 4 * n) + l1.b)
    out2 = cuda_cell.scan_layer(l1, xw, h[1], c[1], cfg, residuals=True)
    dh_seq = (torch.randn(s, b, n, generator=gen) * 1e-3).to(DEVICE)
    dhT, dcT = ((torch.randn(b, n, generator=gen) * 1e-3).to(DEVICE)
                for _ in range(2))
    onehot = torch.nn.functional.one_hot(x.long(), m).float()
    for name, lay, out, ids, x_in, i in (
            ("lstm_bwd_embed", l0, out1, x, onehot, 0),
            ("lstm_bwd_scan", l1, out2, None, h_in, 1)):
        tag = "2x2048 fp32"
        rec = bwd_check(name, lay.U, out, ids, h[i], c[i], dh_seq, dhT, dcT,
                        cfg, None, None, None, tag, {})
        lib = library_lstm_bwd(cfg, x_in, h[i], c[i], dh_seq)
        rec.update(replaces=REPLACES[name], library_ms=lib)
        records[("9b", name)] = rec
        print(f"  {name} {tag}: {rec['ms']:.4f} ms per window, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}), cuDNN nn.LSTM backward "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}", flush=True)
    return per_step, k1, k2


def phase9c(per_call, records):
    """The 5b recipe through the CLI's Trainer, with every kernel's launch
    count reset before and read after: the step time, chars/s and the mean
    bits of each superstep, gated finite, the last below 8.0 and below the
    first; the launches against what the shapes give (K8, K10, the
    tensor-core dU, K4, K5) and none of K1, K2, K3, K6. Then held-out bits/char of the trained weights
    on enwik6's last 1 % at eval batch 16 through K8, kernels against
    plain. Returns the launch counts of the training run."""
    from eigen_lstm_tpu_torch.cli import _make_trainer, build_parser
    from eigen_lstm_tpu_torch.ops import cuda_adagrad, cuda_cell, cuda_cell_bwd, head
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
    from eigen_lstm_tpu_torch.ops.dispatch import families, select_cell_fn
    from eigen_lstm_tpu_torch.train.evaluator import _build_streams, evaluate_bpc

    trainer = _make_trainer(build_parser().parse_args(B5_ARGV))
    cfg = trainer.mcfg
    print(f"  5b: {cfg.hidden} hidden, residual {cfg.residual_dtype}, families "
          f"(layers >= 1, layer 0) at B={B5_B} {families(cfg, B5_B)}, at the "
          f"eval batch {EVAL_BATCH} {families(cfg, EVAL_BATCH)}", flush=True)
    counters = {"tiled_fwd_embed": ct.tiled_embed_layer0,
                "tiled_fwd_scan": ct.tiled_scan_layer,
                "tiled_bwd": ct.tiled_bwd, "tiled_dU": ct.tensor_core_dU,
                "lstm_fwd_embed": cuda_cell.embed_layer0,
                "lstm_fwd_scan": cuda_cell.scan_layer,
                "lstm_bwd_embed": cuda_cell_bwd.embed_layer0_bwd,
                "lstm_bwd_scan": cuda_cell_bwd.scan_layer_bwd,
                "head_fwd": head.head_fwd, "head_bwd": head.head_bwd,
                "adagrad": cuda_adagrad.adagrad_update_fused}
    k = trainer.tcfg.superstep
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    bits = []
    for _ in range(B5_STEPS // k):
        trainer.state, met = trainer.dispatch_superstep()
        bits.append(met["bits"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    bits = torch.cat(bits).tolist()
    means = [statistics.fmean(bits[i:i + k]) for i in range(0, len(bits), k)]
    step_ms = dt * 1e3 / B5_STEPS
    print(f"  5b steps: {B5_STEPS} steps ({B5_WARMUP} at lr 0) in {dt:.2f} s: "
          f"{step_ms:.2f} ms a step, {B5_S * B5_B * B5_STEPS / dt:,.0f} chars/s; "
          f"launches {counts}", flush=True)
    print("  5b steps, mean bits of each superstep: "
          + " ".join(f"{v:.4f}" for v in means), flush=True)
    k10 = records[("9a", "tiled_bwd", "bfloat16", 0.0)]
    for name in ("tiled_fwd_embed", "tiled_bwd", "tiled_dU", "head_fwd",
                 "head_bwd"):
        ms = (records[("9a", name)] if name.startswith("head")
              else k10["dU_ms"] if name == "tiled_dU"
              else records[("9a", name, "bfloat16", 0.0)]["ms"])
        print(f"  {name}: {ms:.3f} ms a step, {100 * ms / step_ms:.1f} % of "
              f"the {step_ms:.2f} ms 5b step", flush=True)
    if not all(np.isfinite(bits)) or not means[-1] < min(8.0, means[0]):
        fail(f"5b steps: bits not finite, or the last superstep's mean "
             f"{means[-1]:.4f} not below 8.0 and the first's {means[0]:.4f}")
    # K8 and K10 as many launches a step as one call at these shapes gives
    # (their designs': 1 persistent, S per-step; 9a), dU on tensor cores
    # as one call of 9a
    want = {name: 0 for name in counters}
    want.update(tiled_fwd_embed=B5_STEPS * per_call["tiled_fwd_embed"],
                tiled_bwd=B5_STEPS * per_call["tiled_bwd"],
                tiled_dU=B5_STEPS * per_call["tiled_dU"],
                head_fwd=B5_STEPS * per_call["head_fwd"],
                head_bwd=B5_STEPS * per_call["head_bwd"], adagrad=B5_STEPS)
    if counts != want:
        fail(f"5b steps: launches {counts}, the path's shapes give {want}")
    test = trainer.test_np
    design, _ = tiled_design(cfg, EVAL_BATCH, cfg.hidden)
    kern = select_cell_fn("auto", cfg, EVAL_BATCH, DEVICE)
    plain = select_cell_fn("plain", cfg, EVAL_BATCH, DEVICE)
    params = trainer.state.params
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    bpc_k = evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, None, kern)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eval_counts = {name: fn.launches for name, fn in counters.items() if fn.launches}
    t0 = time.perf_counter()
    evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, None, kern)
    torch.cuda.synchronize()
    warm = len(test) / (time.perf_counter() - t0)
    bpc_p = evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, None, plain)
    rel = abs(bpc_k - bpc_p) / bpc_p
    # one K8 call a CHUNK-step window of the eval streams, one launch a call
    windows = _build_streams(test, EVAL_BATCH, CHUNK, None)[-1]
    print(f"  5b eval, enwik6's last {len(test)} bytes at B={EVAL_BATCH}: "
          f"kernels {bpc_k:.6f} plain {bpc_p:.6f} (rel {rel:.2e}, rtol "
          f"{BPC_RTOL:g}), {len(test) / dt:,.0f} bytes/s (a second call "
          f"{warm:,.0f}), launches "
          f"{eval_counts} over {windows} windows; K8's design: {design}",
          flush=True)
    if not np.isfinite(bpc_k) or rel > BPC_RTOL or eval_counts != {"tiled_fwd_embed": windows}:
        fail(f"5b eval: bits/char out of tolerance, or not through K8 alone, "
             f"one launch a window ({windows})")
    return counts, step_ms


# --- phase 10: fused Adagrad (K11), the two-step layer-0 backward (K12),
# the live checks, scan_chunk and the ensemble -------------------------------
ADAGRAD_SOURCE = "eigen_lstm_tpu_torch/csrc/adagrad.cu"
ADAGRAD_REPLACES = "eigen_lstm_tpu/ops/pallas_adagrad.py:35"
K12_REPLACES = "eigen_lstm_tpu/ops/pallas_cell.py:689"
# The documented unroll-2 run (docs/PERFORMANCE.md:478-515): 1x512, B = 64,
# S = 100, bf16 with fp32 residuals (the CLI's auto rule there), enwik6,
# lr 0.02 after 20 warm-up steps; a short schedule: 100 warm-up steps and
# 500 timed steps of the port's bench.
U2_ARGV = ["--batch", "64", "--warmup-steps", "100", "--bench-steps", "500"]
# Phase 10d: the bench's configuration through ``cli train`` with both live
# checks; supersteps of one step, so that their cadence (in supersteps)
# reads in steps.
CHECK_STEPS = 200
CHECK_ARGV = [
    "train", "--data", ENWIK6, "--train-percent", "1.0", "--hidden", "512",
    "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--dtype", "bfloat16",
    "--lr", "0.02", "--warmup", "20", "--superstep", "1", "--steps",
    str(CHECK_STEPS), "--crosscheck", "50", "--gradcheck-every", "100",
    "--sample-chars", "0", "--log-every", "50",
]
# Phase 10e: the chunked run sums each chunk's dU and dW in another order,
# so each gradient is held within 1e-5 of its largest magnitude; the loss
# must be equal or within rel 1e-6 (PERF.md names the cause).
CHUNK_GRAD_TOL, CHUNK_LOSS_RTOL, FLAG_CHUNK = 1e-5, 1e-6, 64


def adagrad_bound(numel: int):
    """K11's least time, ms: 20 bytes an element (p, g, m read; p', m'
    written) at the memory rate; its ~5 flops an element are far below the
    fp32 peak."""
    t_bytes = 20 * numel / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * numel / PEAK_OPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def foreach_adagrad(ps, gs, ms, lr, eps):
    """The same update in ``torch._foreach_*`` ops, out of place: the
    library yardstick, never called by the port."""
    m2 = torch._foreach_addcmul(ms, gs, gs)
    d = torch._foreach_add(m2, eps)
    torch._foreach_rsqrt_(d)
    torch._foreach_mul_(d, gs)
    return torch._foreach_add(ps, d, alpha=-float(lr)), m2


def k11_alone_ms(ps, gs, ms, lr, eps):
    """K11's C launcher alone between CUDA events on the tensors ``ps``,
    ``gs``, ``ms``, its table and outputs made once: the wrapper's checks,
    allocations and table left out."""
    import ctypes

    from eigen_lstm_tpu_torch.ops import _build

    outs = [(torch.empty_like(p), torch.empty_like(mm)) for p, mm in zip(ps, ms)]
    table = (ctypes.c_uint64 * (6 * len(ps)))(*(
        v for p, g, mm, (p2, m2) in zip(ps, gs, ms, outs)
        for v in (p.data_ptr(), g.data_ptr(), mm.data_ptr(), p2.data_ptr(),
                  m2.data_ptr(), p.numel())))
    lib = _build.load_library()
    launched = ctypes.c_int(0)
    args = (len(ps), table, float(lr), float(eps),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    if lib.adagrad_launch(*args) != 0:
        fail("adagrad_launch refused the call")
    return cuda_ms(lambda: lib.adagrad_launch(*args), reps=20)


# K11's timing: the plan's wrapper, its first call path (the forced
# control) and torch._foreach_* in turns, A B C C B A a round, K11_ROUNDS
# rounds of windows of K11_REPS calls each, after the same warm-up
K11_ROUNDS, K11_REPS, K11_WARMUP = 10, 50, 5
# the first call path's launches made by k11_check (the forced control),
# held at the end of main to the counter's total: nothing else reaches it
K11_CONTROL = [0]


def interleaved_ms(fns, rounds=K11_ROUNDS, reps=K11_REPS, warmup=K11_WARMUP):
    """Per-call CUDA-event times of the functions ``fns`` (name -> fn)
    timed in turns: each round runs a window of ``reps`` calls of each in
    order, then in reverse order (A B C C B A), after ``warmup`` calls of
    each. Returns name -> (median, min, max) over the 2 x ``rounds``
    windows, ms a call."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    names = list(fns)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: (statistics.median(t), min(t), max(t))
            for name, t in times.items()}


def k11_check(name, params, m, gen, lr, eps, gate_first: bool = False):
    """K11 against its plain version on ``params`` and accumulators ``m``
    with gradients seeded from ``gen``: m bit for bit, p within one ulp
    (the ulp differences counted), one launch a call, the inputs unchanged,
    and every output bit for bit the first call path's (the forced
    control, ``adagrad_update_first``). Then the plan's wrapper, the first
    call path and the ``_foreach`` yardstick timed in turns
    (``interleaved_ms``; with ``gate_first`` the plan's wrapper must be the
    faster of the two), its C launcher alone, the bound and the plain
    version. Returns the kernels-line record (launches None) with the
    first call path's and the launcher's times beside it."""
    from eigen_lstm_tpu_torch.models.lstm import like, tensors
    from eigen_lstm_tpu_torch.ops import cuda_adagrad as ca

    grads = like(params, ((torch.randn(t.shape, generator=gen) * 1e-2)
                          .to(DEVICE) for t in tensors(params)))
    numel = sum(t.numel() for t in tensors(params))
    ins = tensors(params) + tensors(grads) + tensors(m)
    before_ins = [t.clone() for t in ins]
    first0 = ca.adagrad_update_first.launches
    before = ca.adagrad_update_fused.launches
    pk, mk = ca.adagrad_update_fused(params, grads, m, lr, eps)
    launches = ca.adagrad_update_fused.launches - before
    pf, mf = ca.adagrad_update_first(params, grads, m, lr, eps)
    pp, mp = ca.adagrad_update_plain(params, grads, m, lr, eps)
    torch.cuda.synchronize()
    m_equal = all(torch.equal(a, b) for a, b in zip(tensors(mk), tensors(mp)))
    ulps = torch.cat([(a.view(torch.int32).long() - b.view(torch.int32).long())
                      .abs().flatten() for a, b in zip(tensors(pk), tensors(pp))])
    max_ulp, n_ulp = int(ulps.max()), int((ulps > 0).sum())
    err = max(float((a - b).abs().max()) for a, b in zip(tensors(pk), tensors(pp)))
    as_first = all(torch.equal(a, b) for a, b in zip(tensors(pk) + tensors(mk),
                                                    tensors(pf) + tensors(mf)))
    unchanged = all(torch.equal(a, b) for a, b in zip(ins, before_ins))
    del before_ins
    shapes = ", ".join("x".join(map(str, t.shape)) for t in tensors(params))
    print(f"  K11 {name}: {numel:,} parameters in {len(tensors(params))} "
          f"tensors ({shapes}), {launches} launch; m bit for bit {m_equal}; p "
          f"within {max_ulp} ulp of plain ({n_ulp} elements differ by an ulp), "
          f"max |dp| {err:.3e}; the first call path's bits {as_first}; inputs "
          f"unchanged {unchanged}", flush=True)
    if launches != 1 or not m_equal or max_ulp > 1 or not as_first or not unchanged:
        fail(f"K11 {name}: {launches} launches, m equal {m_equal}, p "
             f"{max_ulp} ulp from the plain version, the first call path's "
             f"bits {as_first}, inputs unchanged {unchanged}")
    ps, gs, ms = tensors(params), tensors(grads), tensors(m)
    t = interleaved_ms({
        "plan": lambda: ca.adagrad_update_fused(params, grads, m, lr, eps),
        "first": lambda: ca.adagrad_update_first(params, grads, m, lr, eps),
        "foreach": lambda: foreach_adagrad(ps, gs, ms, lr, eps)})
    plain_ms = cuda_ms(lambda: ca.adagrad_update_plain(params, grads, m, lr, eps),
                       reps=5)
    alone_ms = k11_alone_ms(ps, gs, ms, lr, eps)
    bound_ms, bound_by = adagrad_bound(numel)
    K11_CONTROL[0] += ca.adagrad_update_first.launches - first0
    spread = lambda key: f"{t[key][0]:.4f} ({t[key][1]:.4f}-{t[key][2]:.4f})"
    print(f"  K11 {name}: wrapper calls, median (min-max) of "
          f"{2 * K11_ROUNDS} windows of {K11_REPS} in turns: the plan's "
          f"{spread('plan')} ms, the first call path {spread('first')}, "
          f"torch._foreach_* {spread('foreach')} (host time, not gated); "
          f"the C launcher alone {alone_ms:.4f}, bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms", flush=True)
    if gate_first and t["plan"][0] >= t["first"][0]:
        fail(f"K11 {name}: the plan's wrapper ({t['plan'][0]:.4f} ms) is not "
             f"faster than the first call path ({t['first'][0]:.4f} ms)")
    return dict(name="adagrad", route="cuda", source=ADAGRAD_SOURCE,
                replaces=ADAGRAD_REPLACES, launches=None, max_abs_err=err,
                ms=t["plan"][0], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=t["foreach"][0],
                first_ms=t["first"][0], alone_ms=alone_ms)


def phase10a(records):
    """K11 (``k11_check``) on the flagship's weights and Adagrad
    accumulators, 5b's initial weights and the bench's (1x512)."""
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.models.lstm import init_params
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint
    from eigen_lstm_tpu_torch.train.optimizer import adagrad_init

    lr, eps = np.float32(0.005), 1e-10
    flag_p, flag_m, _, _ = load_checkpoint(FLAGSHIP, flag_train_cfg("bfloat16"),
                                           DEVICE)
    b5 = init_params(b5_cfg(), device=DEVICE)
    bench = init_params(ModelConfig(hidden=512), device=DEVICE)
    gen = torch.Generator().manual_seed(11)
    for name, params, m in (("flagship", flag_p, flag_m),
                            ("5b", b5, adagrad_init(b5)),
                            ("bench", bench, adagrad_init(bench))):
        records[("10a", name)] = k11_check(name, params, m, gen, lr, eps,
                                           gate_first=name == "bench")


def phase10b(records):
    """K12 at the bench's shapes (1x512, S = 100) with the 1x512
    checkpoint's weights: B = 64 with fp32 residuals and B = 128 with bf16
    residuals, bf16 and fp32 compute, dropout 0 and 0.35. Every reverse
    step, dh0, dc0, dWU and db within TRAIN_TOL of the plain replay from
    K12's own dg (as phase 5 holds K3); the window against its plain
    version given the explicitly masked cotangent (fp32 gated, bf16
    printed); dg, dWU, db, dh0 and dc0 equal to K3's bit for bit, both in
    the persistent design of each type (in fp32 the CUDA-core one) and, in
    fp32, in the per-step design too, forced, timed in the same call (the
    persistent must be the faster). Times beside K3's and the bound; the
    launches of one call of each. Returns
    K12's launches a call at the documented run's shapes (B = 64, bf16,
    fp32 residuals) and K3's."""
    import dataclasses

    from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd as cb
    from eigen_lstm_tpu_torch.ops.dispatch import fused_accum_ok
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    s, per_call = TRAIN_S, None
    inv = torch.tensor(float(np.float32(1.0 / (1.0 - FLAG_DROP))), device=DEVICE)
    names = ("dWU", "db", "dh0", "dc0")
    n = train_cfg("float32").hidden
    for b, residual in ((64, "float32"), (128, "bfloat16")):
        mask = host_masks(FLAG_SEEDS[0], s, b, n, FLAG_DROP)
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(train_cfg(dtype), residual_dtype=residual)
            layer = load_params(H512, cfg, DEVICE).layers[0]
            gen = torch.Generator().manual_seed(12)
            x, _ = bible_window(gen, s, b)
            rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen)
                                           * sd).to(DEVICE)
            h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
            dh_seq, dhT, dcT = (rand(s, b, n, sd=1e-3), rand(b, n, sd=1e-3),
                                rand(b, n, sd=1e-3))
            fused = fused_accum_ok(cfg, b)
            onehot = torch.nn.functional.one_hot(x.long(), cfg.vocab).float()
            lib_ms = library_lstm_bwd(cfg, onehot, h0, c0, dh_seq)
            for drop in (0.0, FLAG_DROP):
                dr = (drop, FLAG_SEEDS[0]) if drop else None
                dh_eff = masked(dh_seq, mask, inv) if drop else dh_seq
                out = cuda_cell.embed_layer0(layer, x, h0, c0, cfg,
                                             residuals=True, dropout=dr)
                fwd = (layer.U.to(cfg.cdtype), out[3], out[2], out[0], x, h0, c0)
                args = fwd + (dh_seq, dhT, dcT, cfg)
                tag = (f"B={b} {dtype} residual {residual} drop {drop:g} "
                       f"({'fused' if fused else 'fall-back'} VJP)")

                def k12_gates(label):
                    """K3's and K12's calls in the design the wrappers take
                    here; K12 held to its plain replay, its plain version
                    and K3's bits. Returns (K12's launches, K3's, the
                    largest replay error)."""
                    res, launched = {}, {}
                    for name, fn in (("K3", cb.embed_layer0_bwd),
                                     ("K12", cb.embed_layer0_bwd_unroll2)):
                        dg = torch.empty(s, b, 4 * n, device=DEVICE)
                        before = fn.launches
                        res[name] = (dg,) + fn(*args, dg_out=dg, dropout=dr,
                                               fused_accum=fused)
                        launched[name] = fn.launches - before
                    dg_k, out_k = res["K12"][0], res["K12"][1:]
                    rep = k3_replay(*fwd, dh_eff, dhT, dcT, cfg, dg_k,
                                    fused_accum=fused)
                    out_p = cb.embed_layer0_bwd_unroll2_plain(
                        *fwd, dh_eff, dhT, dcT, cfg, fused_accum=fused)
                    torch.cuda.synchronize()
                    for lab, got in zip(names, out_k):
                        if not torch.isfinite(got).all():
                            fail(f"K12 {label} {lab}: non-finite values")
                    step_err = 0.0
                    for lab, got, want in (("dg", dg_k, rep[0]),
                                           ("dh0", out_k[2], rep[1]),
                                           ("dc0", out_k[3], rep[2]),
                                           ("dWU", out_k[0], rep[3]),
                                           ("db", out_k[1], rep[4])):
                        err = norm_err(got, want)
                        step_err = max(step_err, err)
                        if not np.isfinite(err) or err > TRAIN_TOL:
                            fail(f"K12 {label} {lab}: {err:.3e} of its plain "
                                 f"replay > {TRAIN_TOL:g}")
                    window = []
                    for lab, got, want in zip(names, out_k, out_p):
                        err = norm_err(got, want)
                        window.append(f"{lab} {err:.3e}")
                        if cfg.cdtype == torch.float32 and err > TRAIN_TOL:
                            fail(f"K12 {label} window {lab}: {err:.3e} of its "
                                 f"plain version > {TRAIN_TOL:g}")
                    same = [torch.equal(a, b_) for a, b_ in zip(res["K3"], res["K12"])]
                    if not all(same):
                        fail(f"K12 {label}: dg, dWU, db, dh0, dc0 equal to "
                             f"K3's: {same}")
                    print(f"  K12 {label}: every reverse step, dh0, dc0, dWU "
                          f"and db within {step_err:.3e} (normalised) of the "
                          f"plain replay from K12's own dg (tol {TRAIN_TOL:g}); "
                          f"window against its plain version with explicit "
                          f"masks (" + (f"tol {TRAIN_TOL:g}"
                                        if cfg.cdtype == torch.float32
                                        else "bf16, not gated") + "): "
                          + ", ".join(window) + f"; dg, dWU, db, dh0, dc0 bit "
                          f"for bit K3's, both in {k6_design(cfg, b, n)[0]}",
                          flush=True)
                    return launched, step_err

                launched, step_err = k12_gates(tag)
                design, persistent = k6_design(cfg, b, n)
                if not persistent or launched["K12"] != launched["K3"]:
                    fail(f"K12 {tag}: {design}, launches {launched}; both "
                         f"types take a persistent design, both kernels "
                         f"alike")
                ms, host = {}, {}
                for name, fn in (("K3", cb.embed_layer0_bwd),
                                 ("K12", cb.embed_layer0_bwd_unroll2)):
                    call = lambda fn=fn: fn(*args, dropout=dr, fused_accum=fused)
                    ms[name] = cuda_ms(call, reps=3, windows=3)
                    # the host's time to issue one call, the card idle
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    host[name] = (time.perf_counter() - t0) * 1e3
                    torch.cuda.synchronize()
                step = ""
                if dtype == "float32":
                    # the per-step designs, forced: the same gates, K12 two
                    # steps a cooperative launch, timed in this call
                    with per_step_k6():
                        old, _ = k12_gates(tag + " (the per-step design)")
                        old_ms = cuda_ms(lambda: cb.embed_layer0_bwd_unroll2(
                            *args, dropout=dr, fused_accum=fused), reps=1,
                            windows=3)
                    if old["K12"] != s // 2 + 1 + bwd_f32_launches(cfg, s, b, cfg.vocab) - 1:
                        fail(f"K12 {tag}, the per-step design: {old['K12']} "
                             f"launches a call")
                    if not ms["K12"] < old_ms:
                        fail(f"K12 {tag}: the persistent design {ms['K12']:.4f} "
                             f"ms is not faster than the per-step design "
                             f"{old_ms:.4f} ms in this call")
                    step = (f"; the per-step design {old_ms:.4f} ms in this "
                            f"call ({old['K12']} launches)")
                plain_ms = once_ms(lambda: cb.embed_layer0_bwd_unroll2_plain(
                    *args, dropout=dr, fused_accum=fused))
                bound_ms, bound_by = k3_bound(cfg, s, b, n, cfg.vocab)
                print(f"  K12 {tag}: {ms['K12']:.4f} ms ({launched['K12']} "
                      f"launches) against K3's {ms['K3']:.4f} ms "
                      f"({launched['K3']} launches; K12/K3 "
                      f"{ms['K12'] / ms['K3']:.4f}), bound {bound_ms:.5f} ms "
                      f"({bound_by}), plain {plain_ms:.4f} ms, cuDNN nn.LSTM "
                      f"backward {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
                      f"the host issues a call in {host['K12']:.3f} ms (K3 "
                      f"{host['K3']:.3f} ms){step}", flush=True)
                records[("10b", b, dtype, drop)] = dict(
                    name="lstm_bwd_embed_unroll2", route="cuda",
                    source=BWD_SOURCE if dtype == "bfloat16" else BWD_F32_SOURCE,
                    replaces=K12_REPLACES, launches=None,
                    max_abs_err=step_err, ms=ms["K12"], plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
                if (b, dtype, drop) == (64, "bfloat16", 0.0):
                    per_call = launched
    return per_call


def phase10c(per_call, records):
    """The port's bench at the documented unroll-2 run's configuration,
    with ``EIGEN_LSTM_BWD_UNROLL=2`` and then without: the first launches
    K12 as the shapes give and K3 never, the second the reverse; K11 once
    a step in both; train_bpc equal. Returns the launch counts of the
    unroll-2 run and its step time."""
    import os

    from eigen_lstm_tpu_torch import bench
    from eigen_lstm_tpu_torch.cli import build_parser
    from eigen_lstm_tpu_torch.ops import cuda_adagrad, cuda_cell, cuda_cell_bwd as cb

    args = build_parser().parse_args(bench.DEFAULT_ARGV + U2_ARGV)
    warmup, windows, per_window = bench.schedule(args)
    steps = (warmup + windows * per_window) * args.superstep
    counters = {"lstm_fwd_embed": cuda_cell.embed_layer0,
                "lstm_bwd_embed": cb.embed_layer0_bwd,
                "lstm_bwd_embed_unroll2": cb.embed_layer0_bwd_unroll2,
                "adagrad": cuda_adagrad.adagrad_update_fused}
    # K1 at B = 64: the persistent design (16 rows a block), one launch a step
    design, persistent = split_design(train_cfg("bfloat16"), args.batch, 512)
    k1 = steps * (1 if persistent else TRAIN_S)
    print(f"  bench B=64: K1 in {design}", flush=True)
    runs = {}
    for unroll in ("2", "1"):
        os.environ["EIGEN_LSTM_BWD_UNROLL"] = unroll
        try:
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            result = bench.run_benchmark(args)
        finally:
            del os.environ["EIGEN_LSTM_BWD_UNROLL"]
        counts = {name: fn.launches for name, fn in counters.items()}
        step_ms = TRAIN_S * 64 / result["value"] * 1e3
        runs[unroll] = (result, counts, step_ms)
        print(f"  bench B=64 EIGEN_LSTM_BWD_UNROLL={unroll}: {json.dumps(result)}",
              flush=True)
        print(f"  bench B=64 unroll {unroll}: {steps} steps, {step_ms:.3f} ms a "
              f"step (median window), launches {counts}", flush=True)
    want = {"2": dict(lstm_fwd_embed=k1, lstm_bwd_embed=0,
                      lstm_bwd_embed_unroll2=steps * per_call["K12"],
                      adagrad=steps),
            "1": dict(lstm_fwd_embed=k1, lstm_bwd_embed=steps * per_call["K3"],
                      lstm_bwd_embed_unroll2=0, adagrad=steps)}
    for unroll, (result, counts, _) in runs.items():
        if counts != want[unroll]:
            fail(f"bench unroll {unroll}: launches {counts}, the shapes give "
                 f"{want[unroll]}")
        if result["platform"] != "cuda":
            fail("bench: not on the card")
    bpc = [runs[u][0]["train_bpc"] for u in ("2", "1")]
    k11_ms = records[("10a", "bench")]["ms"]
    print(f"  bench B=64: train_bpc {bpc[0]} (unroll 2) and {bpc[1]} (unroll 1); "
          f"{runs['2'][2]:.3f} and {runs['1'][2]:.3f} ms a step; K11 "
          f"{k11_ms:.4f} ms, {100 * k11_ms / runs['2'][2]:.2f} % of the step",
          flush=True)
    if bpc[0] != bpc[1] or not np.isfinite(bpc[0]):
        fail(f"bench B=64: train_bpc {bpc[0]} with K12, {bpc[1]} with K3")
    return runs["2"][1]


def phase10d(flag_trainer):
    """``cli train`` at the bench's configuration for CHECK_STEPS steps with
    ``--crosscheck 50 --gradcheck-every 100``: every check passes. Then one
    ``Trainer.crosscheck`` (tol 2e-2) at the flagship's state of phase 7c."""
    import contextlib
    import io

    from eigen_lstm_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(CHECK_ARGV)
    dt = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}", flush=True)
    cross = [l for l in lines if l.startswith("[crosscheck]")]
    grad = [l for l in lines if l.startswith("[gradcheck]")]
    bad = [l for l in cross + grad if not l.endswith(" ok")]
    print(f"  cli train with the checks: {CHECK_STEPS} steps in {dt:.1f} s, "
          f"{len(cross)} crosschecks, {len(grad)} gradcheck lines, "
          f"{len(bad)} failures", flush=True)
    if len(cross) != CHECK_STEPS // 50 or len(grad) != 5 * CHECK_STEPS // 100 or bad:
        fail(f"cli train checks: {len(cross)} crosschecks, {len(grad)} "
             f"gradcheck lines, failures {bad}")
    t0 = time.perf_counter()
    res = flag_trainer.crosscheck(tol=2e-2)
    print(f"  flagship crosscheck at step {flag_trainer.step} in "
          f"{time.perf_counter() - t0:.1f} s: {res}", flush=True)
    if not res["ok"] or flag_trainer.crosscheck_failures:
        fail("flagship crosscheck: the kernels and the plain loop disagree")


def phase10e():
    """The flagship's loss and eleven gradients on one bible.txt window in
    fp32 without dropout, through the kernels, with scan_chunk = 64 and
    without: the loss equal (or within rel 1e-6), each gradient within 1e-5
    of its largest magnitude; the forward kernels' launches and the peak
    device memory of both runs."""
    import dataclasses

    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.train.checkpoint import load_params
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

    base = dataclasses.replace(flag_train_cfg("float32"), dropout=0.0)
    params = load_params(FLAGSHIP, base, DEVICE)
    gen = torch.Generator().manual_seed(13)
    x, t = bible_window(gen, FLAG_S, FLAG_B)
    h = (torch.randn(3, FLAG_B, 1024, generator=gen) * 0.1).to(DEVICE)
    c = (torch.randn(3, FLAG_B, 1024, generator=gen) * 0.1).to(DEVICE)
    res = {}
    for chunk in (0, FLAG_CHUNK):
        cfg = dataclasses.replace(base, scan_chunk=chunk)
        cell_fn = select_cell_fn("auto", cfg, FLAG_B, DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ct.reset_launches()
        loss, _, _, grads = loss_and_grads(params, x, t, h, c, cfg, cell_fn)
        torch.cuda.synchronize()
        res[chunk] = (float(loss), dict(grads.named_tensors()),
                      dict(zip(TILED, ct.launches())),
                      torch.cuda.max_memory_allocated())
    (l0, g0, n0, mem0), (l1, g1, n1, mem1) = res[0], res[FLAG_CHUNK]
    errs = {k[len("params."):]: norm_err(g1[k], g0[k]) for k in g0}
    rel = abs(l1 - l0) / abs(l0)
    print(f"  flagship fp32 scan_chunk {FLAG_CHUNK} against 0: loss {l1!r} and "
          f"{l0!r} (rel {rel:.2e}, tol {CHUNK_LOSS_RTOL:g}); gradients "
          f"normalised (tol {CHUNK_GRAD_TOL:g}): "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()), flush=True)
    print(f"  flagship fp32 launches: unchunked {n0}, chunked {n1} (the "
          f"forward again in the backward); peak device memory "
          f"{mem0 / 2**30:.3f} GiB unchunked, {mem1 / 2**30:.3f} GiB chunked",
          flush=True)
    if rel > CHUNK_LOSS_RTOL or max(errs.values()) > CHUNK_GRAD_TOL \
            or not np.isfinite(l1):
        fail("scan_chunk: the chunked loss or gradients out of tolerance")
    # K8 (layer 0), K9 (layers 1 and 2) and K10 (all three) as their plans
    # give them: a call a layer unchunked; chunked a call a chunk and
    # layer, the forwards then again in the backward (the checkpointed
    # chunks recomputed)
    chunks = FLAG_S // FLAG_CHUNK
    fwd0, fwd1 = (tiled_fwd_calls(base, FLAG_B, 1024, s_) for s_ in (FLAG_S, FLAG_CHUNK))
    bwd0, bwd1 = (tiled_bwd_calls(base, FLAG_B, 1024, s_) for s_ in (FLAG_S, FLAG_CHUNK))
    want0 = {"tiled_fwd_embed": fwd0, "tiled_fwd_scan": 2 * fwd0,
             "tiled_bwd": 3 * bwd0}
    want1 = {"tiled_fwd_embed": 2 * chunks * fwd1,
             "tiled_fwd_scan": 4 * chunks * fwd1, "tiled_bwd": 3 * chunks * bwd1}
    if (n0, n1) != (want0, want1):
        fail(f"scan_chunk: the tiled kernels launched {n0} times unchunked "
             f"and {n1} chunked, their plans give {want0} and {want1}")


def phase10f(test):
    """``evaluate_ensemble_bpc`` of the flagship and the 1x512 checkpoint
    (bf16) on SLICE_CHARS held-out bytes, kernels against plain at
    BPC_RTOL; each member's bits/char beside the ensemble's."""
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.train.checkpoint import load_params
    from eigen_lstm_tpu_torch.train.evaluator import (_build_streams, evaluate_bpc,
                                                      evaluate_ensemble_bpc)

    cfgs = ((FLAGSHIP, flagship_cfg("bfloat16")),
            (H512, ModelConfig(hidden=512, num_layers=1, compute_dtype="bfloat16")))
    params = [load_params(path, cfg, DEVICE) for path, cfg in cfgs]
    # each chunk runs K1 once per member (one launch in its persistent
    # design, CHUNK in the other) and K2 once per layer >= 1 of the flagship
    chunks = _build_streams(test, EVAL_BATCH, CHUNK, SLICE_CHARS)[-1]
    k1 = sum(chunks * (1 if split_design(cfg, EVAL_BATCH, cfg.hidden)[1] else CHUNK)
             for _, cfg in cfgs)
    k2 = chunks * (cfgs[0][1].num_layers - 1)
    bpc = {}
    for backend in ("auto", "plain"):
        members = [(p, cfg, select_cell_fn(backend, cfg, EVAL_BATCH, DEVICE))
                   for p, (_, cfg) in zip(params, cfgs)]
        torch.cuda.synchronize()
        cuda_cell.reset_launches()
        t0 = time.perf_counter()
        ens = evaluate_ensemble_bpc(members, test, EVAL_BATCH, CHUNK, SLICE_CHARS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        emb, scan = cuda_cell.launches()
        singles = [evaluate_bpc(p, test, cfg, EVAL_BATCH, CHUNK, SLICE_CHARS, cf)
                   for p, cfg, cf in members]
        bpc[backend] = ens
        print(f"  ensemble ({backend}): {ens:.6f} bits/char over {SLICE_CHARS} "
              f"bytes in {dt:.2f} s (launches {(emb, scan)} before the "
              f"single runs); flagship alone {singles[0]:.6f}, 1x512 alone "
              f"{singles[1]:.6f}", flush=True)
        want = (k1, k2) if backend == "auto" else (0, 0)
        if (emb, scan) != want:
            fail(f"ensemble ({backend}): launches {(emb, scan)}; the path "
                 f"gives {want}")
    rel = abs(bpc["auto"] - bpc["plain"]) / bpc["plain"]
    print(f"  ensemble kernels against plain: rel {rel:.2e} (rtol {BPC_RTOL:g})",
          flush=True)
    if rel > BPC_RTOL or not bpc["auto"] < 3.0:
        fail("ensemble bits/char out of tolerance")


# --- phase 11: tensor parallelism at D = 1 (K13-K16) -----------------------
TP_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tp.cu"
# K15's fp32 designs (D = 1 and D ranks) and K16's at D ranks; at D = 1
# K16 under fp32 compute is K6's fp32 kernel
TP_F32_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tp_f32.cu"
# K13's fp32 step: one step of the fp32 persistent forward in K15's mode
TP_STEP_F32_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tp_step_f32.cu"
TP_F32_BWD_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tp_f32_bwd.cu"
# K14's fused step (bf16): the gate backward and the rank's dh_full in one
# launch
TP_STEP_BWD_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tp_step_bwd.cu"
TP_REPLACES = {
    "tp_step_fwd": "eigen_lstm_tpu/ops/pallas_tp_cell.py:72",
    "tp_step_bwd": "eigen_lstm_tpu/ops/pallas_tp_cell.py:82",
    "tp_step_bwd_dh": "eigen_lstm_tpu/ops/pallas_tp_cell.py:82",
    "tp_seq_fwd": "eigen_lstm_tpu/ops/pallas_tp_seq.py:59",
    "tp_seq_bwd": "eigen_lstm_tpu/ops/pallas_tp_seq.py:125",
}
TP_STEPS, TP_SUPERSTEP = 300, 50
# 11b's per-step TP family (K13/K14, 160-240 ms a step, host-bound) runs
# TP_STEP_STEPS steps in supersteps of TP_STEP_SUPERSTEP and is held to a
# single-device run of as many (once 100 steps in supersteps of 50, whose
# gap read 0.005 against the 0.05 gate; cut for the script's time)
TP_STEP_STEPS, TP_STEP_SUPERSTEP = 50, 25
# 11b: the root bench's configuration through ``cli train`` (its lr warm-up
# of 20 steps), 300 steps from the same seed under --tp 1 and on one device
TP_ARGV = [
    "train", "--data", ENWIK6, "--train-percent", "1.0", "--hidden", "512",
    "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--dtype", "bfloat16",
    "--lr", "0.02", "--warmup", "20", "--superstep", str(TP_SUPERSTEP),
    "--steps", str(TP_STEPS), "--log-every", str(TP_SUPERSTEP),
    "--sample-chars", "0",
]
# 11b's gate on train_bpc against the single-device run: both paths start
# from the same weights, cursors and windows; the single-device path takes
# K1 (W rounded to bf16 in the forward) and the fused head, whose bf16
# roundings differ, so the two trajectories are not bitwise. A broken path
# reads ~8 bits.
TP_BPC_TOL = 5e-2
# 11c: the flagship recipe under --tp 1, a few steps
TP_FLAG_STEPS = 4
# 11c's bf16 step and fp32 window before K14's fused step (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md section 5), printed beside this run's, not
# gated: both are host-bound
EARLIER_FLAG_TP_STEP_MS, EARLIER_FLAG_TP_F32_WINDOW_MS = 880.73, 1067.91


def tp_step_bound(cfg, b, n, nd, backward: bool, fused: bool = False):
    """K13's least time, ms: bytes = U_d + h_full (compute type) + xw, c
    in + h2, c2, g out (fp32); flops = 2*B*N*4nd. K14's gate backward: g,
    c2, c_prev, dh, dc in + dg, dc_prev out (fp32), ~30 flops an element;
    its fused step (``fused``, bf16) those bytes + U_d in and dh_full out
    in the compute type, flops = 2*B*N*4nd for dh_full."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    if backward:
        nbytes = b * nd * 4 * (4 + 4 + 4 + 1)
        if fused:
            return _bound(nbytes + n * 4 * nd * csz + b * n * csz, 2 * b * n * 4 * nd, cfg)
        return _bound(nbytes, 30 * b * nd,
                      dataclasses.replace(cfg, compute_dtype="float32"))
    nbytes = n * 4 * nd * csz + b * n * csz + b * 4 * nd * 4 * 2 + b * nd * 4 * 3
    return _bound(nbytes, 2 * b * n * 4 * nd, cfg)


def tp_seq_work(cfg, s, b, n, backward: bool):
    """(bytes, flops) of K15's window at width n: U + xw + h0, c0 in, h_seq
    (fp32), g, c_prev (residual type), hT, cT out; K16's: U + g, c_prev +
    cT, dh_seq, dhT, dcT in, dg (fp32), dh0, dc0 out; flops = 2*S*B*N*4N
    for each (K16's dU is a product outside). D shards of width N/D sum to
    the same."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    rsz = torch.finfo(cfg.rdtype).bits // 8
    u = n * 4 * n * csz
    if backward:
        nbytes = (u + s * b * 5 * n * rsz + s * b * n * 4 + 3 * b * n * 4
                  + s * b * 4 * n * 4 + 2 * b * n * 4)
    else:
        nbytes = (u + s * b * 4 * n * 4 + 2 * b * n * 4 + s * b * n * 4
                  + s * b * 5 * n * rsz + 2 * b * n * 4)
    return nbytes, 2 * s * b * n * 4 * n


def tp_seq_bound(cfg, s, b, n, backward: bool):
    """K15's or K16's least time, ms (``tp_seq_work``)."""
    return _bound(*tp_seq_work(cfg, s, b, n, backward), cfg)


def _tp_record(name, err, ms, plain_ms, bound, lib_ms):
    return dict(name=name, route="cuda", source=TP_SOURCE,
                replaces=TP_REPLACES[name], launches=None, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=lib_ms)


def lstm_cell_ms(cfg, h_full, h_d, c_d, U_d, bias):
    """One ``torch.lstm_cell`` call over the same step (the standard cell,
    h_full as its input, U_d^T its input weight, the xw term folded into
    a bias, and a hidden product of its own): a yardstick only."""
    w_hh = torch.zeros(U_d.shape[1], h_d.shape[1], device=DEVICE, dtype=cfg.cdtype)
    args = (h_full.to(cfg.cdtype), (h_d.to(cfg.cdtype), c_d.to(cfg.cdtype)),
            U_d.T.contiguous().to(cfg.cdtype), w_hh, bias.to(cfg.cdtype),
            torch.zeros_like(bias, dtype=cfg.cdtype))
    try:
        with torch.no_grad():
            return cuda_ms(lambda: torch.lstm_cell(*args), reps=50)
    except RuntimeError as e:   # the fused cell may not take this type
        print(f"  library: torch.lstm_cell in {cfg.cdtype} refused: {e}",
              flush=True)
        return None


def k13_design(rows, b, nd):
    """A label of K13's design as ``tp_step_plan`` chose it (``rows``: its
    plan)."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import (F32_UNITS, PERSIST_UNITS,
                                                          F32Split)

    if rows is None:
        return "the CUDA-core design (32 units x 4 batch rows a block)"
    if isinstance(rows, F32Split):
        grid = nd // F32_UNITS * -(-b // rows.rows)
        return (f"the fp32 step ({grid} blocks of {F32_UNITS} units and "
                f"{rows.rows} batch rows, {rows.per} a thread, a ring of "
                f"{rows.stages} slots of {rows.kc} columns of h and U, U_d read "
                f"{-(-b // rows.rows)} times a step, CUDA cores)")
    grid = nd // PERSIST_UNITS * -(-b // rows)
    return (f"the tensor-core design ({grid} blocks of {PERSIST_UNITS} units "
            f"and {rows} batch rows, U_d read {-(-b // rows)} times a step)")


def k13_check(tc, U_c, xw, h_full, c_d, cfg, tag):
    """One call of K13 against its plain version on the same inputs
    (TRAIN_TOL, normalised, on h2, c2 and g) and one launch a call.
    Returns (the output, the errors)."""
    before = tc.tp_step_fwd.launches
    out_k = tc.tp_step_fwd(U_c, xw, h_full, c_d, cfg)
    calls = tc.tp_step_fwd.launches - before
    out_p = tc.tp_step_plain(U_c, xw, h_full, c_d, cfg)
    torch.cuda.synchronize()
    errs = {k: norm_err(a, p) for k, a, p in zip(("h2", "c2", "g"), out_k, out_p)}
    print(f"  K13 {tag}: against plain, normalised (tol {TRAIN_TOL:g}): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; {calls} launch a call", flush=True)
    if calls != 1 or not all(np.isfinite(e) and e <= TRAIN_TOL for e in errs.values()):
        fail(f"K13 {tag}: {errs}, {calls} launches a call")
    return out_k, errs


def k13_alone_ms(U_c, xw, h_full, c_d, cfg, rows):
    """K13's C launcher alone between CUDA events, its buffers made once
    (``rows``: the plan, the tensor-core design's rows or the fp32 step's
    layout; None for the CUDA-core design)."""
    import ctypes

    from eigen_lstm_tpu_torch.ops import _build
    from eigen_lstm_tpu_torch.ops.cuda_cell_tiled import F32Split

    b, n = h_full.shape
    nd = c_d.shape[1]
    f32 = dict(dtype=torch.float32, device=DEVICE)
    outs = (torch.empty(b, nd, **f32), torch.empty(b, nd, **f32),
            torch.empty(b, 4 * nd, **f32))
    launched = ctypes.c_int(0)
    ptrs = (U_c.data_ptr(), xw.data_ptr(), h_full.data_ptr(), c_d.data_ptr(),
            *(o.data_ptr() for o in outs), b, n, nd,
            int(cfg.cell_variant == "standard"))
    tail = (torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    lib = _build.load_library()
    if isinstance(rows, F32Split):
        name, args = "tp_step_fwd_f32_launch", (*ptrs, *rows, *tail)
    else:
        name = "tp_step_fwd_launch"
        args = ((1 if cfg.cdtype == torch.bfloat16 else 0), *ptrs,
                -1 if rows is None else rows, *tail)
    launcher = getattr(lib, name)
    if launcher(*args) != 0:
        fail(f"{name} refused the call")
    return cuda_ms(lambda: launcher(*args), reps=50)


def k14_alone_ms(g, c2, c_prev, dh, dc, cfg, U_c=None):
    """K14's first design's C launcher alone between CUDA events, its fp32
    inputs and outputs made once: the wrapper's casts and allocations left
    out. With ``U_c``, the first design's pair: the launcher, then dh_full
    by the product outside as the wrapper forms it (``cell_ops.matmul``),
    captured in a CUDA graph and timed by its replays, so that the host's
    calls (two launches and the casts' dispatch) do not bound its time:
    the device time of the pair."""
    from eigen_lstm_tpu_torch.ops import _build
    from eigen_lstm_tpu_torch.ops import cell as cell_ops

    b, nd = c2.shape
    ins = [x.to(torch.float32).contiguous() for x in (g, c2, c_prev, dh, dc)]
    outs = (torch.empty(b, 4 * nd, dtype=torch.float32, device=DEVICE),
            torch.empty(b, nd, dtype=torch.float32, device=DEVICE))
    args = (*(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs), b,
            nd, int(cfg.cell_variant == "standard"),
            torch.cuda.current_stream().cuda_stream)
    lib = _build.load_library()
    if lib.tp_step_bwd_launch(*args) != 0:
        fail("tp_step_bwd_launch refused the call")
    if U_c is None:
        return cuda_ms(lambda: lib.tp_step_bwd_launch(*args), reps=50)

    def pair():
        lib.tp_step_bwd_launch(*args[:-1], torch.cuda.current_stream().cuda_stream)
        return cell_ops.matmul(outs[0], U_c.T, cfg.cdtype, torch.float32).to(cfg.cdtype)
    side = torch.cuda.Stream()   # the warm-up off the capture, as torch asks
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pair()
    return cuda_ms(graph.replay, reps=50)


def k14_fused_alone_ms(args, U_c, cfg, plan):
    """K14's fused C launcher alone between CUDA events (``plan``: its
    layout; bf16), its inputs, outputs and scratch made once."""
    import ctypes

    from eigen_lstm_tpu_torch.ops import _build

    ins = [x.to(torch.float32).contiguous() for x in args]
    b, nd = ins[1].shape
    n = U_c.shape[0]
    f32 = dict(dtype=torch.float32, device=DEVICE)
    bf16 = dict(dtype=torch.bfloat16, device=DEVICE)
    outs = (torch.empty(b, 4 * nd, **f32), torch.empty(b, nd, **f32),
            torch.empty(b, n, **bf16))
    dgx = torch.empty(b, 4 * nd, **bf16)
    xbuf = torch.empty(plan.blocks, b, n, **f32) if plan.blocks > 1 else None
    launched = ctypes.c_int(0)
    U_a = U_c.contiguous()
    call = (*(x.data_ptr() for x in ins), U_a.data_ptr(),
            *(o.data_ptr() for o in outs), dgx.data_ptr(),
            None if xbuf is None else xbuf.data_ptr(), b, n, nd,
            int(cfg.cell_variant == "standard"), *plan,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    lib = _build.load_library()
    if lib.tp_step_bwd_dh_launch(*call) != 0:
        fail("tp_step_bwd_dh_launch refused the call")
    return cuda_ms(lambda: lib.tp_step_bwd_dh_launch(*call), reps=50)


@contextlib.contextmanager
def k14_first_design():
    """K14's wrapper takes its first design (the gate backward, then the
    product outside) inside the block, whatever ``tp_step_bwd_plan`` would
    choose: the same-call control of the fused step in bf16."""
    from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc

    plan = tc.device_tp_step_bwd_plan
    tc.device_tp_step_bwd_plan = lambda *a: None
    try:
        yield
    finally:
        tc.device_tp_step_bwd_plan = plan


def k14_check(tc, args, U_c, cfg, tag, fused: bool):
    """One call of K14 (``tp_step_bwd_dh``) against its plain replay: dg
    and dc_prev within TRAIN_TOL (normalised) of ``tp_step_bwd_plain`` on
    the same inputs; dh_full within TRAIN_TOL (normalised) of the plain
    product of the kernel's own round(dg), in bf16 beyond the one rounding
    of each sum to bf16 (2^-8 of its magnitude, an ulp, element by
    element), in the compute type; one launch a call, of the fused step
    where ``fused``. Returns (the output, the worst gated error)."""
    from eigen_lstm_tpu_torch.ops import cell as cell_ops

    before = (tc.tp_step_bwd.launches, tc.tp_step_bwd_dh.launches)
    dg, dcp, dh_full = tc.tp_step_bwd_dh(*args, U_c, cfg)
    calls = (tc.tp_step_bwd.launches - before[0], tc.tp_step_bwd_dh.launches - before[1])
    pdg, pdcp = tc.tp_step_bwd_plain(*args, cfg)
    ref = cell_ops.matmul(dg, U_c.T, cfg.cdtype, torch.float32)
    torch.cuda.synchronize()
    errs = {"dg": norm_err(dg, pdg), "dc_prev": norm_err(dcp, pdcp),
            "dh_full": norm_err(dh_full, ref)}
    gated = ["dg", "dc_prev", "dh_full"]
    if cfg.cdtype == torch.bfloat16:
        past = (dh_full.float() - ref).abs() - 2.0 ** -8 * ref.abs()
        errs["dh_full past its bf16 rounding"] = float(past.max() / ref.abs().max())
        gated[2] = "dh_full past its bf16 rounding"
    print(f"  K14 {tag}: against plain, normalised (tol {TRAIN_TOL:g}): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; dh_full {dh_full.dtype}; {calls[0]} launch a call, "
          f"{calls[1]} of the fused step", flush=True)
    if calls != (1, int(fused)) or dh_full.dtype != cfg.cdtype or not all(
            np.isfinite(errs[k]) and errs[k] <= TRAIN_TOL for k in gated):
        fail(f"K14 {tag}: {errs}, launches {calls}, dh_full {dh_full.dtype}")
    return (dg, dcp, dh_full), max(errs[k] for k in gated)


def k14_library_ms(args, U_c, cfg):
    """The library pair on the same step, the standard cell: torch's fused
    LSTM cell backward (``_thnn_fused_lstm_cell_backward_impl``, the gates
    and U_c's columns permuted to its [i|f|g|o] outside the window), then
    dh_full by ``torch.matmul`` in the compute type; None where refused."""
    g, c2, c_prev, dh, dc = args
    nd = c2.shape[1]
    perm = torch.cat([torch.arange(q * nd, (q + 1) * nd) for q in (0, 2, 3, 1)]).to(DEVICE)
    ws, U_l = g[:, perm].contiguous(), U_c[:, perm].contiguous()

    def pair():
        dgates = torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
            dh, dc, c_prev, c2, ws, False)[0]
        return torch.matmul(dgates.to(U_l.dtype), U_l.T)
    try:
        with torch.no_grad():
            return cuda_ms(pair, reps=50)
    except RuntimeError as e:   # the fused cell may not take this type
        print(f"  library: the fused LSTM cell backward refused: {e}", flush=True)
        return None


def k14_designs(tc, args, U_c, cfg, dtype, ndev, records):
    """K14 at one flagship shard in the design its plan takes: bf16 the
    fused step, with the first design forced beside it; fp32 the first
    design, which it alone has. Each design held to ``k14_check`` and timed
    in this call beside the plain version and the library pair (a
    yardstick of the standard cell; none for the reference cell); the
    fused step beside its bound and its C launcher alone, which must beat
    the first design's pair alone (its device time, a CUDA graph)."""
    b, nd = args[1].shape
    n = U_c.shape[0]
    plan = tc.device_tp_step_bwd_plan(cfg, b, n, nd)
    tag = f"{dtype} D={ndev} (nd={nd})"
    print(f"  K14 {tag}: the plan takes "
          + ("the first design" if plan is None else
             f"the fused step {plan} ({n // tc.STEP_BWD_UNITS} groups of "
             f"{tc.STEP_BWD_UNITS} units x {plan.blocks} parts)"), flush=True)
    if (plan is None) != (dtype == "float32"):
        fail(f"K14 {tag}: plan {plan}; bf16 takes the fused step, fp32 the first design")
    if plan is not None:
        _, err = k14_check(tc, args, U_c, cfg, f"{tag}, the fused step", True)
        ms = cuda_ms(lambda: tc.tp_step_bwd_dh(*args, U_c, cfg), reps=50)
        alone = k14_fused_alone_ms(args, U_c, cfg, plan)
    with k14_first_design():
        _, err_first = k14_check(tc, args, U_c, cfg, f"{tag}, the first design", False)
        first = cuda_ms(lambda: tc.tp_step_bwd_dh(*args, U_c, cfg), reps=50)
    first_alone = k14_alone_ms(*args, cfg, U_c=U_c)
    plain = cuda_ms(lambda: tc.tp_step_bwd_dh_plain(*args, U_c, cfg), reps=20)
    lib = k14_library_ms(args, U_c, cfg)
    lib_ms = lib if cfg.cell_variant == "standard" else None
    lib_line = (f"the library pair {'refused' if lib is None else f'{lib:.4f} ms'} "
                f"(the standard cell; {'none' if lib_ms is None else 'this'} for "
                f"this {cfg.cell_variant} cell)")
    first_line = (f"the first design {first:.4f} ms a call (the wrapper; 1 launch "
                  f"and the product), its pair alone (K14's launcher and the "
                  f"product, a CUDA graph) {first_alone:.4f} ms")
    if plan is None:
        print(f"  K14 {tag}: {first_line}; plain {plain:.4f} ms; {lib_line}", flush=True)
        return
    bnd = tp_step_bound(cfg, b, n, nd, True, fused=True)
    print(f"  K14 {tag}: the fused step {ms:.4f} ms a call (the wrapper; 1 launch), "
          f"its kernel alone {alone:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); "
          f"{first_line}, in this call; plain {plain:.4f} ms; {lib_line}", flush=True)
    if not alone < first_alone:
        fail(f"K14 {tag}: the fused step {alone:.4f} ms alone against the first "
             f"design's pair {first_alone:.4f}: it must beat it")
    records[("11a", "tp_step_bwd_dh", dtype, ndev)] = dict(
        _tp_record("tp_step_bwd_dh", err, ms, plain, bnd, lib_ms),
        source=TP_STEP_BWD_SOURCE, alone_ms=alone, first_ms=first,
        first_alone_ms=first_alone, library_pair_ms=lib, first_err=err_first)


@contextlib.contextmanager
def cuda_core_k13():
    """K13's wrapper takes its CUDA-core design inside the block, whatever
    ``tp_step_plan`` would choose: for the check and time of that design
    where the main path takes the tensor cores (bf16) or the fp32 step."""
    from eigen_lstm_tpu_torch.ops import cuda_tp_cell

    plan = cuda_tp_cell.device_tp_step_plan
    cuda_tp_cell.device_tp_step_plan = lambda *a: None
    try:
        yield
    finally:
        cuda_tp_cell.device_tp_step_plan = plan


def phase11a(records):
    """K13 and K14 at the flagship's shapes (N = 1024, B = 128) as one
    shard of D = 1, 2 and 4 (nd = 1024, 512, 256, the full h), from the
    flagship's layer-1 weights permuted for D; K15 and K16 at the bench's
    (N = 512, B = 128, S = 100, fp32 residuals) from the 1x512
    checkpoint's weights on a bible.txt window; bf16 and fp32. Each call
    against its plain version, every step of the windows replayed from the
    kernel's own state (TRAIN_TOL, normalised); times beside the bound, the
    plain version and the library yardstick (``torch.lstm_cell`` for K13,
    cuDNN ``nn.LSTM`` forward and backward for K15 and K16, none for K14);
    K15 beside 100 launches of K13 at the same shapes. K15 and K16 in both
    types in their persistent designs, beside their cooperative designs
    (and K15's unsplit layout) forced, gated faster than the cooperative
    ones in fp32; then the D-rank cooperative kernels at D = 1
    (``x_at_d1``)."""
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc, cuda_tp_seq as ts
    from eigen_lstm_tpu_torch.parallel.tp import permute_params_for_tp
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    gen = torch.Generator().manual_seed(11)
    rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd).to(DEVICE)
    b, n = FLAG_B, 1024
    for dtype in ("float32", "bfloat16"):
        cfg = flag_train_cfg(dtype)
        flag = load_params(FLAGSHIP, cfg, DEVICE)
        for ndev in (1, 2, 4):
            nd = n // ndev
            layer = permute_params_for_tp(flag, ndev).layers[1]
            U_d = layer.U[:, :4 * nd].contiguous()
            # the path casts U once a window (parallel/tp.py) and hands each
            # step U_c: the wrapper's call as the path makes it
            U_c = U_d.to(cfg.cdtype)
            h_full = torch.tanh(rand(b, n, sd=0.5)).to(cfg.cdtype)
            xw = rand(b, 4 * nd, sd=0.5) + layer.b[:4 * nd]
            c_d = rand(b, nd, sd=0.3)
            rows = tc.device_tp_step_plan(cfg, b, n, nd)
            design = k13_design(rows, b, nd)
            print(f"  K13 {dtype} D={ndev} (nd={nd}): {design}", flush=True)
            if rows is None:
                fail(f"K13 {dtype} D={ndev}: {design}; the tensor cores in "
                     f"bf16, the fp32 step in fp32")
            out_k, errs13 = k13_check(tc, U_c, xw, h_full, c_d, cfg,
                                      f"{dtype} D={ndev}")
            dh, dc = rand(b, nd, sd=1e-2), rand(b, nd, sd=1e-2)
            bwd_k = tc.tp_step_bwd(out_k[2], out_k[1], c_d, dh, dc, cfg)
            bwd_p = tc.tp_step_bwd_plain(out_k[2], out_k[1], c_d, dh, dc, cfg)
            torch.cuda.synchronize()
            errs = {f"K14 {k}": norm_err(a, p) for k, a, p in zip(("dg", "dc_prev"), bwd_k, bwd_p)}
            bad = {k: e for k, e in errs.items() if not np.isfinite(e) or e > TRAIN_TOL}
            print(f"  K14 {dtype} D={ndev} (nd={nd}): against plain, normalised "
                  f"(tol {TRAIN_TOL:g}): " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()),
                  flush=True)
            if bad:
                fail(f"K14 {dtype} D={ndev}: {bad}")
            ms13 = cuda_ms(lambda: tc.tp_step_fwd(U_c, xw, h_full, c_d, cfg), reps=50)
            alone13 = k13_alone_ms(U_c, xw, h_full, c_d, cfg, rows)
            # the CUDA-core design, which refused shapes keep, held to the
            # same gates on the same inputs and timed in this call
            with cuda_core_k13():
                _, errs_core = k13_check(tc, U_c, xw, h_full, c_d, cfg,
                                         f"{dtype} D={ndev} (the CUDA-core design)")
                core13 = cuda_ms(lambda: tc.tp_step_fwd(U_c, xw, h_full, c_d, cfg),
                                 reps=50)
            core_alone = k13_alone_ms(U_c, xw, h_full, c_d, cfg, None)
            line = (f"; the CUDA-core design {core13:.4f} ms, its kernel "
                    f"alone {core_alone:.4f} ms, in this call")
            plain13 = cuda_ms(lambda: tc.tp_step_plain(U_c, xw, h_full, c_d, cfg), reps=20)
            lib13 = lstm_cell_ms(cfg, h_full, c_d, c_d, U_d, xw[0])
            ms14 = cuda_ms(lambda: tc.tp_step_bwd(out_k[2], out_k[1], c_d, dh, dc, cfg), reps=50)
            alone14 = k14_alone_ms(out_k[2], out_k[1], c_d, dh, dc, cfg)
            plain14 = cuda_ms(lambda: tc.tp_step_bwd_plain(out_k[2], out_k[1], c_d, dh, dc, cfg),
                              reps=20)
            b13 = tp_step_bound(cfg, b, n, nd, False)
            b14 = tp_step_bound(cfg, b, n, nd, True)
            print(f"  K13 {dtype} D={ndev}: {ms13:.4f} ms a step (the wrapper, U "
                  f"cast already; 1 launch), its kernel alone {alone13:.4f} ms, "
                  f"bound {b13[0]:.5f} ms ({b13[1]}), plain {plain13:.4f} ms, "
                  f"torch.lstm_cell {'n/a' if lib13 is None else f'{lib13:.4f} ms'}"
                  f"{line}; K14's first design (the gate backward alone): {ms14:.4f} "
                  f"ms (1 launch), its kernel alone {alone14:.4f} ms, bound {b14[0]:.5f} ms ({b14[1]}), plain "
                  f"{plain14:.4f} ms, library n/a", flush=True)
            records[("11a", "tp_step_fwd", dtype, ndev)] = dict(_tp_record(
                "tp_step_fwd", max(errs13.values()), ms13, plain13, b13, lib13),
                alone_ms=alone13)
            if dtype == "float32":
                records[("11a", "tp_step_fwd", dtype, ndev)]["source"] = TP_STEP_F32_SOURCE
            records[("11a", "tp_step_fwd_core", dtype, ndev)] = dict(_tp_record(
                "tp_step_fwd", max(errs_core.values()), core13, plain13, b13, lib13),
                alone_ms=core_alone)
            records[("11a", "tp_step_bwd", dtype, ndev)] = dict(_tp_record(
                "tp_step_bwd", max(errs["K14 dg"], errs["K14 dc_prev"]), ms14,
                plain14, b14, None), alone_ms=alone14)
            k14_designs(tc, (out_k[2], out_k[1], c_d, dh, dc), U_c, cfg, dtype, ndev,
                        records)
    s, b = TRAIN_S, TRAIN_B
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(hidden=512, compute_dtype=dtype, residual_dtype="float32")
        n = cfg.hidden
        layer = load_params(H512, cfg, DEVICE).layers[0]
        x, _ = bible_window(gen, s, b)
        xw = layer.W[x.long()] + layer.b
        h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
        U_c = layer.U.to(cfg.cdtype)
        design15, persistent15 = split_design(cfg, b, n, k15=True)
        print(f"  K15 {dtype}: {design15}", flush=True)
        if not persistent15:
            fail(f"K15 {dtype}: {design15}; the persistent design in both types")
        fwd_k, step_err = k15_check(ts, tc, U_c, xw, h0, c0, cfg, dtype)
        if dtype == "float32":
            k13_window_check(tc, U_c, xw, h0, c0, cfg, fwd_k)
        fwd_p = ts.tp_seq_fwd_plain(U_c, xw, h0, c0, cfg)
        h_seq, g_seq, c_prev, hT, cT = fwd_k
        win = [norm_err(a, p) for a, p in zip(fwd_k, fwd_p)]
        # the cooperative design and the unsplit layout, held to the same
        # gates and timed in this call; the fp32 design's bits do not
        # depend on its split
        others15 = {}
        for key, force in (("cooperative", per_step_tiled(SPLIT_PLAN)),
                           ("unsplit", unsplit_fwd())):
            with force:
                out = k15_check(ts, tc, U_c, xw, h0, c0, cfg, f"{dtype} ({key})")[0]
                others15[key] = cuda_ms(
                    lambda: ts.tp_seq_fwd(U_c, xw, h0, c0, cfg), reps=5)
            if dtype == "float32" and key == "unsplit" and not _same([out], [fwd_k]):
                fail("K15 float32: the unsplit layout moved the bits")
        dh_seq = rand(s, b, n, sd=1e-2)
        dhT, dcT = rand(b, n, sd=1e-2), rand(b, n, sd=1e-2)
        bargs = (U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT, cfg)
        bwd_k = ts.tp_seq_bwd(*bargs)
        bwd_p = ts.tp_seq_bwd_plain(*bargs)
        # the reverse steps from the kernel's own dg_{t+1}: c_t is c_prev[t+1]
        rep = reverse_replay(U_c, g_seq, torch.cat([c_prev[1:], cT[None]]),
                             c_prev[0], dh_seq, dhT, dcT, cfg, bwd_k[0])
        torch.cuda.synchronize()
        bstep = max(norm_err(a, p) for a, p in zip(bwd_k, rep))
        bwin = [norm_err(a, p) for a, p in zip(bwd_k, bwd_p)]
        print(f"  K15 {dtype}: the window against plain (h_seq, g, c_prev, hT, "
              f"cT): " + ", ".join(f"{e:.3e}" for e in win), flush=True)
        print(f"  K16 {dtype}: every reverse step, dh0, dc0 within {bstep:.3e} of the "
              f"plain replay from its own dg (tol {TRAIN_TOL:g}); the window against "
              f"plain (dg, dh0, dc0): " + ", ".join(f"{e:.3e}" for e in bwin), flush=True)
        gated = [step_err, bstep] + (win + bwin if dtype == "float32" else [])
        if not all(np.isfinite(e) and e <= TRAIN_TOL for e in gated):
            fail(f"K15/K16 {dtype}: replay {step_err:.3e}/{bstep:.3e}, windows "
                 f"{win} {bwin} (the windows gated in fp32 only)")
        before = ts.tp_seq_bwd.launches
        ts.tp_seq_bwd(*bargs)
        if ts.tp_seq_bwd.launches - before != 1:
            fail(f"K16: {ts.tp_seq_bwd.launches - before} launches a call")
        coop16 = k16_designs(bwd_k, bargs, cfg)
        ms15 = cuda_ms(lambda: ts.tp_seq_fwd(U_c, xw, h0, c0, cfg), reps=5)
        plain15 = once_ms(lambda: ts.tp_seq_fwd_plain(U_c, xw, h0, c0, cfg))
        ms16 = cuda_ms(lambda: ts.tp_seq_bwd(*bargs), reps=5)
        plain16 = once_ms(lambda: ts.tp_seq_bwd_plain(*bargs))
        h_in = torch.tanh(rand(s, b, n))
        lib15 = library_ms(n, cfg, h_in, h0, c0)
        lib16 = library_lstm_bwd(cfg, h_in, h0, c0, dh_seq)
        hc0 = h0.to(cfg.cdtype)
        per_step = cuda_ms(lambda: [tc.tp_step_fwd(U_c, xw[t], hc0, c0, cfg)
                                    for t in range(s)], reps=1)
        b15, b16 = tp_seq_bound(cfg, s, b, n, False), tp_seq_bound(cfg, s, b, n, True)
        print(f"  K15 {dtype}: {ms15:.4f} ms a window (1 launch), bound {b15[0]:.5f} ms "
              f"({b15[1]}), plain {plain15:.4f} ms, cuDNN nn.LSTM "
              f"{'n/a' if lib15 is None else f'{lib15:.4f} ms'}; {s} launches of K13 "
              f"at these shapes {per_step:.4f} ms"
              + "".join(f"; the {k} design {v:.4f} ms in this call"
                        for k, v in others15.items()), flush=True)
        print(f"  K16 {dtype}: {ms16:.4f} ms a window (1 launch), bound {b16[0]:.5f} ms "
              f"({b16[1]}), plain {plain16:.4f} ms, cuDNN nn.LSTM backward "
              f"{'n/a' if lib16 is None else f'{lib16:.4f} ms'}; the cooperative "
              f"CUDA-core design {coop16:.4f} ms", flush=True)
        if dtype == "float32":
            slower = [k for k, ms, coop in (("K15", ms15, others15["cooperative"]),
                                            ("K16", ms16, coop16)) if not ms < coop]
            if slower:
                fail(f"K15/K16 float32: the persistent design is not faster than the "
                     f"cooperative one in the same call: {slower}")
        x_at_d1(ts, U_c, xw, h0, c0, bargs, cfg, others15["cooperative"], coop16,
                records)
        records[("11a", "tp_seq_fwd", dtype)] = dict(_tp_record(
            "tp_seq_fwd", step_err, ms15, plain15, b15, lib15), **others15)
        records[("11a", "tp_seq_fwd", dtype)]["source"] = (
            FWD_SOURCE if dtype == "bfloat16" else TP_F32_SOURCE)
        records[("11a", "tp_seq_bwd", dtype)] = dict(_tp_record(
            "tp_seq_bwd", bstep, ms16, plain16, b16, lib16), cooperative_ms=coop16,
            source=BWD_SOURCE if dtype == "bfloat16" else BWD_F32_SOURCE)
        records[("11a", "k13x100", dtype)] = per_step


def k13_window(tc, Us, xws, h0, c0s, cfg):
    """S steps of K13 on D shards (D = len(Us)), the full h of a step the
    shards' h2 side by side, each shard's c carried: per shard (h_seq, g,
    c_prev, hT, cT) as K15's window returns them, and K13's launches."""
    before = tc.tp_step_fwd.launches
    h, cs = h0, list(c0s)
    seqs = [([], [], []) for _ in Us]
    for t in range(xws[0].shape[0]):
        hs = []
        for r, U in enumerate(Us):
            h2, c2, g = tc.tp_step_fwd(U, xws[r][t], h, cs[r], cfg)
            for seq, x in zip(seqs[r], (h2, g, cs[r])):
                seq.append(x)
            hs.append(h2)
            cs[r] = c2
        h = torch.cat(hs, 1)
    return ([(*(torch.stack(x) for x in seqs[r]), seqs[r][0][-1], cs[r])
             for r in range(len(Us))], tc.tp_step_fwd.launches - before)


def k13_window_check(tc, U_c, xw, h0, c0, cfg, fwd_k):
    """fp32 at the bench's shapes: a window of K13 steps (the fp32 step, one
    launch a step) gives K15's fp32 window ``fwd_k`` bit for bit (h_seq,
    g, c_prev, hT, cT: one k-split order, one epilogue), and at D = 2 each
    shard of the TP gate permutation's weights gives the D = 1 window's
    bits of its units."""
    from eigen_lstm_tpu_torch.parallel.tp import _gate_permutation

    s, b, n = xw.shape[0], xw.shape[1], U_c.shape[0]
    (one,), launched = k13_window(tc, [U_c], [xw], h0, [c0], cfg)
    same = [torch.equal(a, w) for a, w in zip(one, fwd_k)]
    d = 2
    nd = n // d
    perm = torch.as_tensor(_gate_permutation(n, d), device=DEVICE)
    cut = lambda x, r: x[..., perm][..., r * 4 * nd:(r + 1) * 4 * nd].contiguous()
    units = lambda x, r: x[..., r * nd:(r + 1) * nd]
    shards, launched2 = k13_window(
        tc, [cut(U_c, r) for r in range(d)], [cut(xw, r) for r in range(d)], h0,
        [units(c0, r).contiguous() for r in range(d)], cfg)
    same2 = [all(torch.equal(a, w) for a, w in zip(
        shards[r], (units(one[0], r), cut(one[1], r), units(one[2], r),
                    units(one[3], r), units(one[4], r)))) for r in range(d)]
    print(f"  K13 float32: a window of {s} steps (the fp32 step, {launched} "
          f"launches) against K15's fp32 window, bit for bit (h_seq, g, c_prev, "
          f"hT, cT): {same}; at D = {d} ({launched2} launches) each shard the D = 1 "
          f"window's bits of its units: {same2}", flush=True)
    if not all(same) or not all(same2) or launched != s or launched2 != d * s:
        fail(f"K13 float32 window: {same} against K15, shards {same2}, "
             f"launches {launched} and {launched2}")


def k15_check(ts, tc, U_c, xw, h0, c0, cfg, tag):
    """One call of K15 with every step replayed by K13's plain version from
    the kernel's own (h_{t-1}, c_{t-1}) as S*B rows: h_seq, g, c_{t+1} (the
    next step's c_prev, cT at the last) and hT within STEP_ATOL and, as
    before, TRAIN_TOL normalised; c_prev[0] is c0 in the residual type, bit
    for bit; one launch a call. Returns (the output, the normalised
    error)."""
    s, b, n4 = xw.shape
    n = n4 // 4
    before = ts.tp_seq_fwd.launches
    out = ts.tp_seq_fwd(U_c, xw, h0, c0, cfg)
    calls = ts.tp_seq_fwd.launches - before
    h_seq, g_seq, c_prev, hT, cT = out
    h_prev = torch.cat([h0[None], h_seq[:-1]]).reshape(s * b, n)
    h2, c2, g = tc.tp_step_plain(U_c, xw.reshape(s * b, n4), h_prev.to(cfg.cdtype),
                                 c_prev.reshape(s * b, n), cfg)
    c_next = torch.cat([c_prev[1:], cT[None]]).reshape(s * b, n)
    pairs = ((h_seq.reshape(s * b, n), h2), (c_next, c2),
             (g_seq.reshape(s * b, n4), g), (hT, h2[-b:]))
    torch.cuda.synchronize()
    rel = max(norm_err(a, p) for a, p in pairs)
    err = max(max_err(a, p)[0] for a, p in pairs)
    first = torch.equal(c_prev[0], c0.to(c_prev.dtype))
    print(f"  K15 {tag}: every step within {err:.3e} of its plain replay (atol "
          f"{STEP_ATOL:g}; normalised {rel:.3e}, tol {TRAIN_TOL:g}); c_prev[0] "
          f"{'is' if first else 'is NOT'} c0; {calls} launch a call", flush=True)
    if not (np.isfinite(err) and err <= STEP_ATOL and rel <= TRAIN_TOL) \
            or not first or calls != 1:
        fail(f"K15 {tag}: replay {err:.3e} ({rel:.3e}), c_prev[0] = c0 {first}, "
             f"{calls} launches a call")
    return out, rel


def k16_designs(out, bargs, cfg):
    """K16 at the bench's shapes, beyond 11a's replay gate: the design it
    took, K6's persistent reverse launch of its type once a call (bf16:
    ``lstm_bwd_persist_launch``, its dg, dh0 and dc0 bit for bit K6's
    (``scan_layer_bwd``) on the same inputs in K6's layout, c_seq =
    c_prev[1:] then cT, c0 = c_prev[0], exact with these fp32 residuals;
    fp32: ``lstm_bwd_f32_launch`` with c_last the fp32 cT); a call with
    bf16 residuals (c_{S-1} still the fp32 cT) held to the replay from its
    own dg; and the cooperative CUDA-core design, forced, held to the same
    replay gate. Returns the latter's time, ms a window."""
    from eigen_lstm_tpu_torch.ops import _build, cuda_cell_bwd, cuda_tp_seq as ts

    U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT = bargs[:7]
    s, b, nd = c_prev.shape
    f32 = cfg.cdtype == torch.float32
    name = "lstm_bwd_f32_launch" if f32 else "lstm_bwd_persist_launch"
    plan = (cuda_cell_bwd.device_k6_f32_plan if f32 else cuda_cell_bwd.device_k6_plan)(
        cfg, b, nd)
    lib = _build.load_library()
    real, calls = getattr(lib, name), []
    setattr(lib, name, lambda *a: calls.append(a) or real(*a))
    try:
        ts.tp_seq_bwd(*bargs)
    finally:
        setattr(lib, name, real)
    # the fp32 launcher's c_last, the bf16 one's cT: c_{S-1} read from cT
    c_last = len(calls) == 1 and calls[0][5] == cT.data_ptr()
    print(f"  K16 {cfg.compute_dtype}: {len(calls)} {name} a call (K6's persistent "
          f"reverse launch, {plan}), c_{{S-1}} {'from' if c_last else 'NOT from'} "
          f"cT", flush=True)
    if not c_last:
        fail(f"K16 {cfg.compute_dtype}: {len(calls)} launches of {name} a call, "
             f"c_(S-1) from cT {c_last}; the plan gives {plan}")
    c_seq = torch.cat([c_prev[1:], cT[None]])
    if not f32:
        zeros = torch.zeros(s, b, nd, device=DEVICE)
        dg6 = torch.empty(s, b, 4 * nd, device=DEVICE)
        _, _, dh0_6, dc0_6 = cuda_cell_bwd.scan_layer_bwd(
            U_c, g_seq, c_seq, zeros, zeros[0], c_prev[0], dh_seq, dhT, dcT, cfg,
            dg_out=dg6)
        torch.cuda.synchronize()
        same = [torch.equal(a, b_) for a, b_ in zip(out, (dg6, dh0_6, dc0_6))]
        print(f"  K16 bf16 against K6's persistent reverse launch on the same "
              f"inputs: dg, dh0, dc0 bit for bit {same}", flush=True)
        if not all(same):
            fail(f"K16 bf16: dg, dh0, dc0 not K6's bits: {same}")
    # bf16 residuals: c_{S-1} stays the fp32 cT
    g_r, c_r = g_seq.to(torch.bfloat16), c_prev.to(torch.bfloat16)
    out_r = ts.tp_seq_bwd(U_c, g_r, c_r, cT, dh_seq, dhT, dcT, cfg)
    rep_r = reverse_replay(U_c, g_r, torch.cat([c_r[1:].float(), cT[None]]),
                           c_r[0].float(), dh_seq, dhT, dcT, cfg, out_r[0])
    with per_step_k6():
        out_c = ts.tp_seq_bwd(*bargs)
        rep_c = reverse_replay(U_c, g_seq, c_seq, c_prev[0], dh_seq, dhT, dcT,
                               cfg, out_c[0])
        coop_ms = cuda_ms(lambda: ts.tp_seq_bwd(*bargs), reps=5)
    torch.cuda.synchronize()
    errs = {label: max(norm_err(a, p) for a, p in zip(o, r))
            for label, o, r in (("bf16 residuals", out_r, rep_r),
                                ("the cooperative design", out_c, rep_c))}
    print(f"  K16 {cfg.compute_dtype}, every reverse step, dh0, dc0 against the "
          f"replay from its own dg (tol {TRAIN_TOL:g}): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()), flush=True)
    if not all(np.isfinite(e) and e <= TRAIN_TOL for e in errs.values()):
        fail(f"K16 {cfg.compute_dtype}: {errs}")
    return coop_ms


def x_at_d1(ts, U_c, xw, h0, c0, bargs, cfg, coop15_ms, coop16_ms, records):
    """The D-rank cooperative kernels (``tp_seq_fwd_x``, ``tp_seq_bwd_x``)
    at D = 1, one rank group on the card's own buffers, beside the D = 1
    cooperative kernels (``tp_seq_fwd``, ``tp_seq_bwd``), which shapes no
    plan takes run: the forward's outputs their bits, the backward's every
    reverse step within TRAIN_TOL of the replay from its own dg (and its
    bits against the D = 1 kernel's, printed), the times side by side.
    Printed, not gated: whether the D = 1 kernels can go."""
    s, b, n4 = xw.shape
    n = n4 // 4
    ex = ts.one_card_exchange(b, n, 1, cfg.cdtype)
    try:
        with per_step_tiled(SPLIT_PLAN), per_step_k6():
            one = ts.tp_seq_fwd(U_c, xw, h0, c0, cfg)
            xf, = ts.tp_seq_fwd_ranks([U_c], [xw], h0, [c0], cfg, ex)
            ms_f = cuda_ms(lambda: ts.tp_seq_fwd_ranks([U_c], [xw], h0, [c0], cfg, ex),
                           reps=5)
            one_b = ts.tp_seq_bwd(U_c, *one[1:3], one[4], *bargs[4:])
            xb, = ts.tp_seq_bwd_ranks([U_c], [one[1]], [one[2]], [one[4]],
                                      *([a] for a in bargs[4:7]), cfg, ex)
            ms_b = cuda_ms(lambda: ts.tp_seq_bwd_ranks(
                [U_c], [one[1]], [one[2]], [one[4]], *([a] for a in bargs[4:7]), cfg,
                ex), reps=5)
        rep = reverse_replay(U_c, one[1], torch.cat([one[2][1:], one[4][None]]),
                             one[2][0], *bargs[4:7], cfg, xb[0])
        torch.cuda.synchronize()
    finally:
        ex.close()
    fbits = [torch.equal(a, p) for a, p in zip(xf, one)]
    bbits = [torch.equal(a, p) for a, p in zip(xb, one_b)]
    brel = max(norm_err(a, p) for a, p in zip(xb, rep))
    print(f"  K15/K16 {cfg.compute_dtype} at D = 1 through the D-rank cooperative "
          f"kernels (one group): the forward the D = 1 cooperative design's bits "
          f"{fbits}, the backward's {bbits}, its replay {brel:.3e} (tol "
          f"{TRAIN_TOL:g}); {ms_f:.4f} and {ms_b:.4f} ms against the D = 1 "
          f"kernels' {coop15_ms:.4f} and {coop16_ms:.4f} ms in this call (printed, "
          f"not gated)", flush=True)
    records[("11a", "x_at_d1", cfg.compute_dtype)] = dict(
        fwd_bits=all(fbits), bwd_bits=all(bbits), bwd_replay=brel, fwd_ms=ms_f,
        bwd_ms=ms_b, d1_fwd_ms=coop15_ms, d1_bwd_ms=coop16_ms)


def _tp_counters():
    from eigen_lstm_tpu_torch.ops import (cuda_adagrad, cuda_cell, cuda_cell_bwd,
                                          cuda_cell_tiled, cuda_tp_cell, cuda_tp_seq,
                                          head)

    return {"tp_step_fwd": cuda_tp_cell.tp_step_fwd,
            "tp_step_bwd": cuda_tp_cell.tp_step_bwd,
            "tp_seq_fwd": cuda_tp_seq.tp_seq_fwd,
            "tp_seq_bwd": cuda_tp_seq.tp_seq_bwd,
            "adagrad": cuda_adagrad.adagrad_update_fused,
            "lstm_fwd_embed": cuda_cell.embed_layer0,
            "lstm_fwd_scan": cuda_cell.scan_layer,
            "lstm_bwd_embed": cuda_cell_bwd.embed_layer0_bwd,
            "lstm_bwd_embed_unroll2": cuda_cell_bwd.embed_layer0_bwd_unroll2,
            "lstm_bwd_scan": cuda_cell_bwd.scan_layer_bwd,
            "head_fwd": head.head_fwd, "head_bwd": head.head_bwd,
            "tiled": cuda_cell_tiled}


def _launch_counts(counters):
    """Each counter of ``_tp_counters`` as it reads now (the tiled kernels
    summed)."""
    return {name: (sum(fn.launches()) if name == "tiled" else fn.launches)
            for name, fn in counters.items()}


def _tp_run(argv, steps):
    """The CLI's Trainer from ``argv``: one superstep, then ``steps`` -
    superstep more timed on the host clock around synchronised supersteps,
    the launch counts reset just before the run and read after. Returns
    (counts, ms a step over the timed part, chars/s, train_bpc, backend,
    the trainer)."""
    from eigen_lstm_tpu_torch.cli import _make_trainer, build_parser

    trainer = _make_trainer(build_parser().parse_args(argv))
    counters = _tp_counters()
    try:
        torch.cuda.synchronize()
        for name, fn in counters.items():
            if name == "tiled":
                fn.reset_launches()
            else:
                fn.launches = 0
        trainer.run(steps=trainer.tcfg.superstep, quiet=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = trainer.run(steps=steps - trainer.tcfg.superstep, quiet=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    except BaseException:
        if trainer.mesh is not None:
            trainer.mesh.close()
        raise
    counts = _launch_counts(counters)
    timed = steps - trainer.tcfg.superstep
    cps = trainer.dcfg.batch * trainer.dcfg.seq * timed / dt
    backend = None if trainer.tp is None else trainer.tp.backend
    return counts, dt * 1e3 / timed, cps, met["train_bpc"], backend, trainer


def phase11b(records):
    """``cli train --tp 1`` at the root bench's configuration, TP_STEPS
    steps with EIGEN_LSTM_TP_SEQ unset (K15, K16 once a step) and
    TP_STEP_STEPS with it 0 (K13, K14 S times a step), K11 once a step and
    none of K1-K10, K12 in both; then the same run on one device, for
    TP_STEPS and for TP_STEP_STEPS steps. train_bpc within TP_BPC_TOL of
    the single-device run's of as many steps, the TP_STEPS runs' in the
    JAX bench's sanity band. Returns the launch counts of both TP runs."""
    import os

    from eigen_lstm_tpu_torch.ops import cuda_tp_cell

    runs, fused14 = {}, {}
    for label, env, extra, steps in (
            ("tp seq", None, ["--tp", "1"], TP_STEPS),
            ("tp step", "0", ["--tp", "1"], TP_STEP_STEPS),
            ("single", None, [], TP_STEPS),
            ("single short", None, [], TP_STEP_STEPS)):
        trainer = None
        if env is not None:
            os.environ["EIGEN_LSTM_TP_SEQ"] = env
        superstep = TP_SUPERSTEP if steps == TP_STEPS else TP_STEP_SUPERSTEP
        before = cuda_tp_cell.tp_step_bwd_dh.launches
        try:
            counts, step_ms, cps, bpc, backend, trainer = _tp_run(
                _argv_with(TP_ARGV, superstep=superstep) + extra, steps)
        finally:
            os.environ.pop("EIGEN_LSTM_TP_SEQ", None)
            if trainer is not None and trainer.tp is not None:
                trainer.tp.group.close()
        fused14[label] = cuda_tp_cell.tp_step_bwd_dh.launches - before
        runs[label] = (counts, step_ms, bpc, backend)
        print(f"  cli train {' '.join(extra) or '(one device)'}"
              f"{' EIGEN_LSTM_TP_SEQ=' + env if env else ''}: family {backend}, "
              f"{steps} steps, {step_ms:.3f} ms a step over the last "
              f"{steps - superstep}, {cps:,.0f} chars/s, train_bpc {bpc:.4f}; "
              f"launches {counts}", flush=True)
    zero = ("lstm_fwd_embed", "lstm_fwd_scan", "lstm_bwd_embed",
            "lstm_bwd_embed_unroll2", "lstm_bwd_scan", "head_fwd", "head_bwd", "tiled")
    want = {"tp seq": dict(tp_seq_fwd=TP_STEPS, tp_seq_bwd=TP_STEPS, tp_step_fwd=0,
                           tp_step_bwd=0, adagrad=TP_STEPS),
            "tp step": dict(tp_seq_fwd=0, tp_seq_bwd=0,
                            tp_step_fwd=TP_STEP_STEPS * TRAIN_S,
                            tp_step_bwd=TP_STEP_STEPS * TRAIN_S,
                            adagrad=TP_STEP_STEPS)}
    for label, fam, ref in (("tp seq", "pallas_seq", "single"),
                            ("tp step", "pallas", "single short")):
        counts, _, bpc, backend = runs[label]
        w = dict(want[label], **{k: 0 for k in zero})
        if counts != w or backend != fam:
            fail(f"cli train --tp 1 ({label}): family {backend} (expected {fam}), "
                 f"launches {counts}, the path gives {w}")
        if fused14[label] != w["tp_step_bwd"]:
            fail(f"cli train --tp 1 ({label}): K14's fused step launched "
                 f"{fused14[label]} times of {w['tp_step_bwd']} (bf16 at N = 512 "
                 f"takes it)")
        ref_bpc = runs[ref][2]
        banded = ref == "single"
        if not (np.isfinite(bpc) and abs(bpc - ref_bpc) <= TP_BPC_TOL and (
                not banded or SANITY_BAND[0] <= bpc <= SANITY_BAND[1])):
            fail(f"cli train --tp 1 ({label}): train_bpc {bpc:.4f}, the single "
                 f"device's {ref_bpc:.4f} over as many steps (tol "
                 f"{TP_BPC_TOL:g}), band {SANITY_BAND if banded else None}")
    print(f"  --tp 1 train_bpc {runs['tp seq'][2]:.4f} (K15/K16), one device "
          f"{runs['single'][2]:.4f} ({TP_STEPS} steps, band {SANITY_BAND}); "
          f"{runs['tp step'][2]:.4f} (K13/K14), one device "
          f"{runs['single short'][2]:.4f} ({TP_STEP_STEPS} steps; K14's fused step "
          f"{fused14['tp step']} launches); tol "
          f"{TP_BPC_TOL:g}; step "
          f"{runs['tp seq'][1]:.3f}, {runs['tp step'][1]:.3f} and "
          f"{runs['single'][1]:.3f} ms", flush=True)
    records[("11b", "step_ms")] = {k: v[1] for k, v in runs.items()}
    for name in ("tp_seq_fwd", "tp_seq_bwd"):
        ms = records[("11a", name, "bfloat16")]["ms"]
        print(f"  {name}: {ms:.4f} ms a step, {100 * ms / runs['tp seq'][1]:.1f} % "
              f"of the {runs['tp seq'][1]:.3f} ms --tp 1 step", flush=True)
    ms = records[("11a", "k13x100", "bfloat16")]
    print(f"  tp_step_fwd: {TRAIN_S} calls {ms:.4f} ms a step (11a), "
          f"{100 * ms / runs['tp step'][1]:.1f} % of the {runs['tp step'][1]:.3f} "
          f"ms per-step --tp 1 step", flush=True)
    return runs


# 11d: the same configuration under fp32 compute (the CLI's default dtype),
# --tp 1 against one device, TP_STEPS steps each
TP_F32_ARGV = [("float32" if a == "bfloat16" else a) for a in TP_ARGV]


def phase11d(records):
    """``cli train --tp 1 --dtype float32`` at 11b's configuration for
    TP_STEPS steps beside the single-device fp32 run of as many steps: K15
    and K16 once a step through their fp32 persistent designs
    (``tp_seq_fwd_f32_launch``, ``lstm_bwd_f32_launch``, counted at the
    library), K11 once a step, nothing else; train_bpc within TP_BPC_TOL of
    the single device's, the gap printed. Returns the TP run's launch
    counts."""
    from eigen_lstm_tpu_torch.ops import _build

    runs = {}
    for label, extra in (("tp seq", ["--tp", "1"]), ("single", [])):
        trainer, load = None, _build.load_library
        counting = CountingLibrary(load())
        _build.load_library = lambda: counting
        try:
            counts, step_ms, cps, bpc, backend, trainer = _tp_run(TP_F32_ARGV + extra,
                                                                  TP_STEPS)
        finally:
            _build.load_library = load
            if trainer is not None and trainer.tp is not None:
                trainer.tp.group.close()
        runs[label] = (counts, step_ms, bpc, backend, counting.calls)
        print(f"  cli train {' '.join(extra) or '(one device)'} --dtype float32: family "
              f"{backend}, {TP_STEPS} steps, {step_ms:.3f} ms a step over the last "
              f"{TP_STEPS - TP_SUPERSTEP}, {cps:,.0f} chars/s, train_bpc {bpc:.4f}; "
              f"launches {counts}", flush=True)
    counts, step_ms, bpc, backend, calls = runs["tp seq"]
    zero = ("lstm_fwd_embed", "lstm_fwd_scan", "lstm_bwd_embed",
            "lstm_bwd_embed_unroll2", "lstm_bwd_scan", "head_fwd", "head_bwd", "tiled",
            "tp_step_fwd", "tp_step_bwd")
    want = dict({k: 0 for k in zero}, tp_seq_fwd=TP_STEPS, tp_seq_bwd=TP_STEPS,
                adagrad=TP_STEPS)
    launchers = {k: calls.get(k, 0) for k in ("tp_seq_fwd_f32_launch",
                                              "lstm_bwd_f32_launch",
                                              "tp_seq_fwd_launch", "tp_seq_bwd_launch")}
    print(f"  --tp 1 --dtype float32: K15 and K16 through {launchers}", flush=True)
    if counts != want or backend != "pallas_seq" or launchers != {
            "tp_seq_fwd_f32_launch": TP_STEPS, "lstm_bwd_f32_launch": TP_STEPS,
            "tp_seq_fwd_launch": 0, "tp_seq_bwd_launch": 0}:
        fail(f"cli train --tp 1 --dtype float32: family {backend}, launches {counts} "
             f"through {launchers}, the path gives {want}, the fp32 persistent "
             f"launchers once a step each")
    ref = runs["single"][2]
    gap = bpc - ref
    print(f"  --tp 1 --dtype float32 train_bpc {bpc:.4f}, one device {ref:.4f} "
          f"({TP_STEPS} steps): gap {gap:+.5f} (tol {TP_BPC_TOL:g}); step "
          f"{step_ms:.3f} ms against one device's {runs['single'][1]:.3f}", flush=True)
    if not (np.isfinite(bpc) and abs(gap) <= TP_BPC_TOL
            and SANITY_BAND[0] <= bpc <= SANITY_BAND[1]):
        fail(f"cli train --tp 1 --dtype float32: train_bpc {bpc:.4f}, the single "
             f"device's {ref:.4f} (tol {TP_BPC_TOL:g}), band {SANITY_BAND}")
    records[("11d", "step_ms")] = {k: v[1] for k, v in runs.items()}
    for name in ("tp_seq_fwd", "tp_seq_bwd"):
        ms = records[("11a", name, "float32")]["ms"]
        print(f"  {name} float32: {ms:.4f} ms a step, {100 * ms / step_ms:.1f} % of "
              f"the {step_ms:.3f} ms fp32 --tp 1 step", flush=True)
    return counts


def phase11c(records):
    """The flagship recipe at --tp 1 from ckpt_best.npz for TP_FLAG_STEPS
    steps with dropout 0.35 through K13/K14 (launches counted, bits
    finite and below 3.0); then one bible.txt window's TP loss and eleven
    gradients, the kernels against their plain versions, at phase 7b's
    rules; the fp32 window's time (host clock, one call after the gated
    one) with K13 in its fp32 step beside one with its CUDA-core design
    forced, and K13's launches a window in each; K14's there, all of its
    first design (the gate backward, then the product outside), which fp32
    takes. The bf16 step and the fp32 window are printed beside their
    earlier readings.
    Returns the run's launch counts (with K14's fused step's), K13's
    launches on the fp32 window in its fp32 step and in the CUDA-core
    design (forced), and K14's gate backward's on that window."""
    from eigen_lstm_tpu_torch.models.lstm import step_key
    from eigen_lstm_tpu_torch.ops import cuda_tp_cell
    from eigen_lstm_tpu_torch.parallel import tp as tp_mod
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint

    argv = FLAG_ARGV[:FLAG_ARGV.index("--superstep")] + [
        "--superstep", "2", "--steps", str(TP_FLAG_STEPS), "--sample-chars", "0",
        "--resume", FLAGSHIP, "--tp", "1"]
    trainer = None
    try:
        fused0 = cuda_tp_cell.tp_step_bwd_dh.launches
        counts, step_ms, cps, bpc, backend, trainer = _tp_run(argv, TP_FLAG_STEPS)
        fused = cuda_tp_cell.tp_step_bwd_dh.launches - fused0
        group = trainer.tp.group
        print(f"  flagship --tp 1: family {backend}, {TP_FLAG_STEPS} steps, "
              f"{step_ms:.2f} ms a step over the last {TP_FLAG_STEPS - 2} (before "
              f"K14's fused step: {EARLIER_FLAG_TP_STEP_MS} ms; host-bound, not gated), "
              f"{cps:,.0f} chars/s, bits {bpc:.4f}; launches {counts}, {fused} of "
              f"K14's fused step", flush=True)
        per = TP_FLAG_STEPS * 3 * FLAG_S
        w = dict({k: 0 for k in counts}, tp_step_fwd=per, tp_step_bwd=per,
                 adagrad=TP_FLAG_STEPS)
        if backend != "pallas" or counts != w or fused != per:
            fail(f"flagship --tp 1: family {backend}, launches {counts} ({fused} of "
                 f"K14's fused step), the path gives {w}, K14 fused in bf16")
        if not (np.isfinite(bpc) and bpc < 3.0):
            fail(f"flagship --tp 1: bits {bpc}")
        ms = records[("11a", "tp_step_fwd", "bfloat16", 1)]["ms"] * 3 * FLAG_S
        print(f"  tp_step_fwd: {3 * FLAG_S} calls {ms:.3f} ms a step (11a), "
              f"{100 * ms / step_ms:.1f} % of the {step_ms:.2f} ms flagship "
              f"--tp 1 step", flush=True)
        rows = cuda_tp_cell.device_tp_step_plan(trainer.mcfg, FLAG_B, 1024, 1024)
        print(f"  flagship --tp 1: K13 in {k13_design(rows, FLAG_B, 1024)}; K14 "
              f"{cuda_tp_cell.device_tp_step_bwd_plan(trainer.mcfg, FLAG_B, 1024, 1024)}",
              flush=True)
        if rows is None:
            fail("flagship --tp 1: K13 not on the tensor cores in bf16")
        gen = torch.Generator().manual_seed(12)
        x, t = bible_window(gen, FLAG_S, FLAG_B)
        key = step_key(1235, 785000)
        res = {}
        for dtype in ("float32", "bfloat16"):
            cfg = flag_train_cfg(dtype)
            params, _, _, extras = load_checkpoint(FLAGSHIP, cfg, DEVICE)
            shard = tp_mod.shard_params(params, cfg, group.rank, group.size)
            h, c = (extras[k][:, :FLAG_B] for k in ("stream_h", "stream_c"))
            for path, plain in (("cuda", False), ("plain", True)):
                window = lambda: tp_mod.tp_loss_and_grads(
                    shard, x, t, h, c, cfg, group, "pallas", key, plain)
                before = cuda_tp_cell.tp_step_fwd.launches
                before14 = (cuda_tp_cell.tp_step_bwd.launches,
                            cuda_tp_cell.tp_step_bwd_dh.launches)
                loss, _, _, grads = window()
                if dtype == "float32" and not plain:
                    # K13's fp32 step: its launches on this window, one a
                    # layer and step; then one more window's time in it and
                    # one with the CUDA-core design forced, which refused
                    # shapes keep, and that design's launches. K14: its
                    # first design's launches on this window
                    step32 = cuda_tp_cell.tp_step_fwd.launches - before
                    k14 = (cuda_tp_cell.tp_step_bwd.launches - before14[0],
                           cuda_tp_cell.tp_step_bwd_dh.launches - before14[1])
                    win_ms = {"fp32 step": once_host_ms(window)}
                    with cuda_core_k13():
                        before = cuda_tp_cell.tp_step_fwd.launches
                        win_ms["CUDA-core design"] = once_host_ms(window)
                        core = cuda_tp_cell.tp_step_fwd.launches - before
                grads = tp_mod.unshard_params(grads, cfg, group)
                res[(dtype, path)] = (loss, dict(grads.named_tensors()))
        torch.cuda.synchronize()
        print(f"  flagship TP fp32 window: K13 in its fp32 step launched "
              f"{step32} times, forced in its CUDA-core design {core} times; K14 "
              f"{k14[0]} times ({k14[1]} of its fused step); the window (loss and 11 "
              f"gradients, one call each, host clock) "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in win_ms.items())
              + f" (earlier: {EARLIER_FLAG_TP_F32_WINDOW_MS} ms in its fp32 "
              f"step; host-bound, not gated)", flush=True)
        records[("11c", "tp_window_fp32")] = win_ms
        win = 3 * FLAG_S
        if (step32, core) != (win, win) or k14 != (win, 0):
            fail(f"flagship TP fp32 window: K13 launched {step32} and {core} "
                 f"times, K14 {k14} (of them its fused step), the path gives "
                 f"{win} of K14's first design")
        # the per-step family's bf16 values: W of layers >= 1 (x @ W in the
        # compute type) and Why (the head's product); W0's gather, every U
        # (TPStep hands dU back in fp32) and the biases are not
        compare_paths("flagship TP loss", res,
                      lambda k: k.endswith(".Why") or (k.endswith(".W")
                                                       and "[0]" not in k),
                      vs_drift=FLAG_BF16_VS_DRIFT)
        return dict(counts, tp_step_bwd_dh=fused), step32, core, k14[0]
    finally:
        if trainer is not None:
            trainer.tp.group.close()


# --- phase 12: data parallelism at D = 1 (the DP and DP x TP paths) -------
# 12a/12b: the same bits as 11b's runs (the all-reduce of one rank is the
# identity and the mean divides by 1)
DP_BPC_TOL = 1e-6
# 12c: cli train --tp 1 with the shadow check after its second superstep
DP_GC_STEPS, DP_GC_EVERY = 100, 2


def _argv_with(argv, **flags):
    """``argv`` with each ``--flag value`` of ``flags`` replaced."""
    out = list(argv)
    for name, value in flags.items():
        out[out.index("--" + name.replace("_", "-")) + 1] = str(value)
    return out


def phase12(runs11b):
    """``cli train --dp 1 --stream-data`` and ``--dp 1 --tp 1`` at the
    bench's configuration, TP_STEPS steps each, held to 11b's
    single-device and ``--tp 1`` window-family runs (the same launches,
    train_bpc within DP_BPC_TOL); the corpus of the resident run read
    through the native IO library; then ``--tp 1 --gradcheck-every`` with
    0 failures."""
    import io

    from eigen_lstm_tpu_torch import cli
    from eigen_lstm_tpu_torch.utils import native

    native.calls.clear()
    runs = {}
    for label, extra in (("dp", ["--dp", "1", "--stream-data"]),
                         ("dp x tp", ["--dp", "1", "--tp", "1"])):
        counts, step_ms, cps, bpc, backend, trainer = _tp_run(TP_ARGV + extra,
                                                              TP_STEPS)
        trainer.mesh.close()
        runs[label] = (counts, step_ms, cps, bpc, backend)
        print(f"  cli train {' '.join(extra)}: family {backend}, {TP_STEPS} "
              f"steps, {step_ms:.3f} ms a step over the last "
              f"{TP_STEPS - TP_SUPERSTEP}, {cps:,.0f} chars/s, train_bpc "
              f"{bpc:.6f}; launches {counts}", flush=True)
    for label, ref_label, fam in (("dp", "single", None),
                                  ("dp x tp", "tp seq", "pallas_seq")):
        counts, step_ms, cps, bpc, backend = runs[label]
        ref_counts, ref_ms, ref_bpc, _ = runs11b[ref_label]
        gap = abs(bpc - ref_bpc)
        print(f"  {label}: train_bpc {bpc:.6f} against 11b's {ref_label} run's "
              f"{ref_bpc:.6f} (gap {gap:.3g}, tol {DP_BPC_TOL:g}); step "
              f"{step_ms:.3f} ms against {ref_ms:.3f}", flush=True)
        if counts != ref_counts or backend != fam or not gap <= DP_BPC_TOL:
            fail(f"phase 12 {label}: family {backend} (expected {fam}), "
                 f"launches {counts} (11b's {ref_label}: {ref_counts}), "
                 f"train_bpc gap {gap}")
    native.lib()   # raises with g++'s output if the build failed
    reads = native.calls["read_file"]
    print(f"  corpus read through the native IO library "
          f"({native.library_path()}): {reads} reads", flush=True)
    if reads < 1:
        fail("phase 12: the resident run did not read its corpus natively")
    argv = _argv_with(TP_ARGV, steps=DP_GC_STEPS) + [
        "--tp", "1", "--gradcheck-every", str(DP_GC_EVERY)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    dt = time.perf_counter() - t0
    lines = [l for l in out.getvalue().splitlines() if l.startswith("[gradcheck]")]
    for line in lines:
        print(f"  | {line}", flush=True)
    bad = [l for l in lines if not l.endswith(" ok")]
    print(f"  cli train --tp 1 --gradcheck-every {DP_GC_EVERY}: {DP_GC_STEPS} "
          f"steps in {dt:.1f} s, {len(lines)} gradcheck lines, {len(bad)} "
          f"failures", flush=True)
    if len(lines) != 5 * DP_GC_STEPS // (DP_GC_EVERY * TP_SUPERSTEP) or bad:
        fail(f"phase 12 gradcheck under --tp 1: lines {lines}")


# --- phase 13: sequence pipelining at D = 1 (the paths of 11b and 7c) -----
# 13a: 11b's configuration through cli train --sp 1, the batch in C
# microchunks (B = 128: 32 rows a kernel call at C = 4, 128 at C = 1)
SP_CHUNKS = (4, 1)
# 13c: --sp 1 --tp 1 runs the torch-op TP scan (the JAX tp_sp mesh's XLA
# scan), a launch for each op of each timestep and chunk: 831 ms a step at
# C = 4 on an H100 (700 W), so 8 steps in supersteps of 4, the lr
# warm-up cut to the first 4 so that the second superstep updates
SP_TP_STEPS, SP_TP_SUPERSTEP, SP_TP_WARMUP = 8, 4, 4
# 13d: the flagship's window in C = 4 chunks, then SP_FLAG_STEPS steps of
# its recipe under --sp 1
SP_FLAG_CHUNKS, SP_FLAG_STEPS = 4, 4
# 13d in bf16 against the fp32 whole batch (7b's rule, 2x the plain
# path's drift) is printed, not gated: three trained layers over 256 steps
# carry a bf16 rounding flip in a few streams apart, and the reading moves
# with any sum order (an H100 at 700 W, 6 flagship windows with and
# without those streams): the 128-row kernels of 7b read 1.48-5.15x,
# the 32-row chunks 0.95-5.11x, K1's per-step design on 32 rows 1.14-28x,
# K3 and K6 forced per-step leave it as it is. What holds at 32 rows: each
# kernel against its plain replay (13k), fp32 against the whole batch, SP
# against one device on the same rows, and the top layer's h: the median
# stream's largest distance to fp32 within 2x the plain path's (a fault in
# the math moves every stream; a flip, a few).
SP_STREAM_VS_PLAIN = 2.0


def atb_splits(r, i, j):
    """``atb_splits`` of csrc/common.cuh: the r splits of the persistent
    backward's weight-gradient product (r rows, i x j out), a launch of
    its own summing them where there are more than one."""
    tiles = -(-i // 128) * -(-j // 128)
    splits = min(max(-(-264 // tiles), 1), 32)
    return min(splits, max(-(-r // 64), 1))


def bwd_launches(cfg, s, b, m):
    """K3's (``m`` the vocabulary) or K6's (``m`` 0) launches a call in the
    persistent design: the reverse launch, the weight-gradient product and
    the sum of its splits where it splits; None where the plan takes the
    per-step design."""
    from eigen_lstm_tpu_torch.ops.cuda_cell_bwd import device_k6_plan

    n = cfg.hidden
    if device_k6_plan(cfg, b, n) is None:
        return None
    return 2 + (atb_splits(s * b, m + n, 4 * n) > 1)


# K3's and K6's launches a call on the SP paths, as their persistent design
# gives them at 32 and at 128 rows: the bench's K3 3 (its dWU product splits
# in 3), the flagship's K3 2 and K6 3
SP_BWD_LAUNCHES = {"bench": {"lstm_bwd_embed": 3},
                   "flagship": {"lstm_bwd_embed": 2, "lstm_bwd_scan": 3}}


def sp_plan_launches(cfg, s, rows, where):
    """One chunk's launches of each kernel of the bf16 SP path (``where``
    "bench" or "flagship", ``rows`` the chunk's): K1 one (its persistent
    design), K2 one a layer, K3 and K6 SP_BWD_LAUNCHES, each K6 call a
    layer >= 1; fails where the plans at ``rows`` give other designs."""
    n, layers = cfg.hidden, cfg.num_layers
    want = SP_BWD_LAUNCHES[where]
    got = {"lstm_bwd_embed": bwd_launches(cfg, s, rows, cfg.vocab),
           "lstm_bwd_scan": bwd_launches(cfg, s, rows, 0) if layers > 1 else None}
    if not split_design(cfg, rows, n)[1] or (
            layers > 1 and not tiled_design(cfg, rows, n)[1]) or any(
            got[k] != v for k, v in want.items()):
        fail(f"the {where}'s SP path at {rows} rows: K1 in "
             f"{split_design(cfg, rows, n)[0]}, K2 in "
             f"{tiled_design(cfg, rows, n)[0]}, K3/K6 launches a call {got}; "
             f"the persistent designs and {want}")
    out = {"lstm_fwd_embed": 1, "lstm_fwd_scan": layers - 1,
           "lstm_bwd_embed": want["lstm_bwd_embed"],
           "lstm_bwd_scan": (layers - 1) * want.get("lstm_bwd_scan", 0)}
    return out


def phase13k():
    """Each kernel of the SP paths at a chunk's rows (B / C = 32) against
    its plain replay, at the tolerances of phases 5, 7a and 9a: the
    bench's K1 and K3 (1x512 bf16, the 1x512 checkpoint's weights), the
    flagship's K1, K2, K3 and K6 in bf16 without dropout and at 0.35, and
    its fp32 window's K8, K9 and K10 (the flagship's weights, layers 0 and
    1); each kernel's design and launches a call, K3's and K6's against
    SP_BWD_LAUNCHES."""
    from eigen_lstm_tpu_torch.ops import cell as cell_ops
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    inv = torch.tensor(float(np.float32(1.0 / (1.0 - FLAG_DROP))), device=DEVICE)
    for where, path, s, chunks in (("bench", H512, TRAIN_S, SP_CHUNKS[0]),
                                   ("flagship", FLAGSHIP, FLAG_S, SP_FLAG_CHUNKS)):
        b = (TRAIN_B if where == "bench" else FLAG_B) // chunks
        gen = torch.Generator().manual_seed(131)
        x, _ = bible_window(gen, s, b)
        dtypes = ("bfloat16",) if where == "bench" else ("bfloat16", "float32")
        for dtype in dtypes:
            cfg = train_cfg(dtype) if where == "bench" else flag_train_cfg(dtype)
            n = cfg.hidden
            rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen)
                                           * sd).to(DEVICE)
            h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
            dh_seq = rand(s, b, n, sd=1e-3)
            dhT, dcT = rand(b, n, sd=1e-3), rand(b, n, sd=1e-3)
            params = load_params(path, cfg, DEVICE)
            l0 = params.layers[0]
            l1 = params.layers[1] if cfg.num_layers > 1 else None
            drops = (0.0,) if where == "bench" or dtype == "float32" else (0.0, FLAG_DROP)
            for drop in drops:
                tag = f"SP {where} {dtype} drop {drop:g}, {b} rows"
                dr = [(drop, sd) if drop else None for sd in FLAG_SEEDS]
                masks = [host_masks(sd, s, b, n, drop) if drop else None
                         for sd in FLAG_SEEDS]
                calls = {}
                if dtype == "float32":
                    out1, out2, _, _, _ = tiled_fwd_checks(
                        l0, l1, x, h0, c0, cfg, cfg, dr, masks, inv, tag, calls,
                        timed=False)
                    persistent = tiled_bwd_design(cfg, b, n)[1]
                    tiled_bwd_check(l1.U, out2, h0, c0, dh_seq, dhT, dcT, cfg,
                                    dr[1], masks[1], inv, tag, calls, persistent,
                                    timed=False)
                    print(f"  {tag}: K8 and K9 in {tiled_fwd_design(cfg, b, n)[0]}, "
                          f"K10 in {tiled_bwd_design(cfg, b, n)[0]}; launches a "
                          f"call {calls}", flush=True)
                    fwd_n = tiled_fwd_calls(cfg, b, n, s)
                    want = {"tiled_fwd_embed": fwd_n, "tiled_fwd_scan": fwd_n,
                            "tiled_bwd": tiled_bwd_calls(cfg, b, n, s)}
                    if calls != want:
                        fail(f"{tag}: launches a call {calls}, the plans give "
                             f"{want}")
                    continue
                want = sp_plan_launches(cfg, s, b, where)
                out1, _ = fwd_check("lstm_fwd_embed", "embed", cuda_cell.embed_layer0,
                                    cuda_cell.embed_layer0_plain, l0, x, h0, c0,
                                    cfg, dr[0], masks[0], inv, tag, calls,
                                    timed=False)
                bwd_check("lstm_bwd_embed", l0.U, out1, x, h0, c0, dh_seq, dhT,
                          dcT, cfg, dr[0], masks[0], inv, tag, calls, timed=False)
                if l1 is not None:
                    h_in = (out1[4] if drop else out1[0]).float()
                    xw = (cell_ops.matmul(h_in.reshape(s * b, n), l1.W, cfg.cdtype)
                          .reshape(s, b, 4 * n) + l1.b)
                    out2, _ = fwd_check("lstm_fwd_scan", "scan", cuda_cell.scan_layer,
                                        cuda_cell.scan_layer_plain, l1, xw, h0, c0,
                                        cfg, dr[1], masks[1], inv, tag, calls,
                                        timed=False)
                    bwd_check("lstm_bwd_scan", l1.U, out2, None, h0, c0, dh_seq,
                              dhT, dcT, cfg, dr[1], masks[1], inv, tag, calls,
                              timed=False)
                if where == "flagship" and not drop:
                    # K1's and K2's other designs on the same rows, which
                    # 13d reads beside the split layout
                    for label, force, kern, plain, lay, seq, want_n in (
                            ("K1 per-step", per_step_tiled(SPLIT_PLAN),
                             cuda_cell.embed_layer0, cuda_cell.embed_layer0_plain,
                             l0, x, s),
                            ("K1 unsplit", unsplit_fwd(), cuda_cell.embed_layer0,
                             cuda_cell.embed_layer0_plain, l0, x, 1),
                            ("K2 per-step", per_step_tiled(), cuda_cell.scan_layer,
                             cuda_cell.scan_layer_plain, l1, xw, s)):
                        other = {}
                        name = ("lstm_fwd_embed" if kern is cuda_cell.embed_layer0
                                else "lstm_fwd_scan")
                        with force:
                            fwd_check(name, "embed", kern, plain, lay, seq, h0, c0,
                                      cfg, None, None, inv, f"{tag} ({label})",
                                      other, timed=False)
                        if other[name] != want_n:
                            fail(f"{tag} ({label}): {other[name]} launches a "
                                 f"call, not {want_n}")
                per_layer = {k: v if k in ("lstm_fwd_embed", "lstm_bwd_embed")
                             else v // (cfg.num_layers - 1)
                             for k, v in want.items() if v}
                print(f"  {tag}: K1 in {split_design(cfg, b, n)[0]}; K2 in "
                      f"{tiled_design(cfg, b, n)[0]}; K3, K6 in "
                      f"{k6_design(cfg, b, n)[0]}; launches a call {calls} (the "
                      f"plans give {per_layer})", flush=True)
                if calls != per_layer:
                    fail(f"{tag}: launches a call {calls}, the plans give "
                         f"{per_layer}")
            del params


def sp_chunk_launches(trainer, rows, dropout_key=None):
    """What one chunk of a step launches: ``sp_loss_and_grads`` on the
    first ``rows`` streams of the trainer's current windows and state, one
    segment and one chunk, through the trainer's cell_fn; the launches of
    each kernel."""
    from eigen_lstm_tpu_torch.parallel.sp import sp_loss_and_grads

    counters = _tp_counters()
    x, t = trainer._current_windows()
    st = trainer.state
    torch.cuda.synchronize()
    before = _launch_counts(counters)
    sp_loss_and_grads(st.params, x[:, :rows], t[:, :rows], st.h[:, :rows],
                      st.c[:, :rows], trainer.mcfg, 1, None, trainer.cell_fn,
                      dropout_key=dropout_key)
    torch.cuda.synchronize()
    after = _launch_counts(counters)
    return {k: after[k] - before[k] for k in after}


def chunk_kernel_ms(cfg, layer, x, h, c, rows_list):
    """K1's and K3's time a call (CUDA events around their wrappers) on the
    first ``rows`` streams of a window, for each of ``rows_list``: what a
    microchunk costs the layer-0 kernels. {rows: (K1 ms, K3 ms)}."""
    from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd
    from eigen_lstm_tpu_torch.ops.dispatch import fused_accum_ok

    U_c = layer.U.to(cfg.cdtype)
    out = {}
    for rows in rows_list:
        ids = x[:, :rows].contiguous()
        h0, c0 = h[:rows].contiguous(), c[:rows].contiguous()
        fwd = lambda: cuda_cell.embed_layer0(layer, ids, h0, c0, cfg,
                                             residuals=True)
        res = fwd()
        h_seq, c_seq, g_seq = res[0], res[2], res[3]
        dh = torch.full_like(h_seq, 1e-3, dtype=torch.float32)
        zero = torch.zeros_like(h0, dtype=torch.float32)
        fused = fused_accum_ok(cfg, rows)
        bwd = lambda: cuda_cell_bwd.embed_layer0_bwd(
            U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh, zero, zero, cfg,
            fused_accum=fused)
        out[rows] = (cuda_ms(fwd, reps=5), cuda_ms(bwd, reps=5))
    return out


def _print_chunk_ms(label, chunks, times):
    """One line: K1's and K3's time a call at each row count, and C calls
    of the chunk's rows against one call of the whole batch's."""
    rows = sorted(times)
    small, whole = times[rows[0]], times[rows[-1]]
    print(f"  {label}: " + "; ".join(
        f"{r} rows K1 {times[r][0]:.4f} ms, K3 {times[r][1]:.4f} ms"
        for r in rows) + f"; {chunks} calls of {rows[0]} rows "
        f"{chunks * sum(small):.4f} ms against one of {rows[-1]} "
        f"{sum(whole):.4f} ({chunks * sum(small) / sum(whole):.2f}x)",
        flush=True)


def _sp_launch_gate(label, counts, plan, per_chunk, steps, chunks):
    """``counts`` of a run of ``steps`` steps in ``chunks`` chunks against
    ``chunks`` times the plan's launches of a chunk (``sp_plan_launches``)
    a step, K11 once a step and nothing else (no SP path launches the
    fused head, sp.py:143-153, the TP kernels, tp_sp taking the torch-op
    scan, or K12, EIGEN_LSTM_BWD_UNROLL unset); ``per_chunk``, one chunk
    rerun through the run's cell_fn, printed beside it as a cross-check."""
    want = {k: steps * chunks * plan.get(k, 0) for k in counts}
    want["adagrad"] = steps
    print(f"  {label}: launches a chunk by the plans {plan}; one chunk rerun "
          f"{ {k: v for k, v in per_chunk.items() if v} }", flush=True)
    if counts != want:
        fail(f"{label}: launches {counts}, the plans give {want} ({chunks} "
             f"chunks of {plan} a step, K11 once, nothing else)")


def phase13a(runs11b):
    """``cli train --sp 1`` at 11b's configuration in C = 4 and 1 chunks
    (13a), then ``--dp 1 --sp 1`` at C = 4 (13b). Returns the runs."""
    from eigen_lstm_tpu_torch.ops import dispatch

    runs = {}
    for label, extra in (("sp C=4", ["--sp", "1", "--pp-chunks", "4"]),
                         ("sp C=1", ["--sp", "1", "--pp-chunks", "1"]),
                         ("dp x sp C=4", ["--dp", "1", "--sp", "1",
                                          "--pp-chunks", "4"])):
        chunks = int(extra[-1])
        rows = TRAIN_B // chunks
        trainer = None
        try:
            counts, step_ms, cps, bpc, _, trainer = _tp_run(TP_ARGV + extra,
                                                            TP_STEPS)
            per_chunk = sp_chunk_launches(trainer, rows)
            cfg = trainer.mcfg
            if label == "sp C=4":
                x, _ = trainer._current_windows()
                st = trainer.state
                times = chunk_kernel_ms(cfg, st.params.layers[0], x, st.h[0],
                                        st.c[0], (rows, TRAIN_B))
        finally:
            if trainer is not None:
                trainer.mesh.close()
        runs[label] = (counts, step_ms, bpc)
        fused = dispatch.fused_accum_ok(cfg, rows)
        print(f"  cli train {' '.join(extra)}: {TP_STEPS} steps, {step_ms:.3f} "
              f"ms a step over the last {TP_STEPS - TP_SUPERSTEP}, {cps:,.0f} "
              f"chars/s, train_bpc {bpc:.6f}; launches {counts}; a chunk of "
              f"{rows} rows: {per_chunk}", flush=True)
        print(f"  {label}: K1 in {split_design(cfg, rows, cfg.hidden)[0]}; K3 in "
              f"{k6_design(cfg, rows, cfg.hidden)[0]}, "
              f"{per_chunk['lstm_bwd_embed']} launches a call, the "
              f"{'fused VJP' if fused else 'GEMM fall-back'} at {rows} rows; "
              f"K12 taken: {dispatch.bwd_unroll2(cfg, TRAIN_S, rows, fused)}",
              flush=True)
        _sp_launch_gate(f"cli train {' '.join(extra)}", counts,
                        sp_plan_launches(cfg, TRAIN_S, rows, "bench"), per_chunk,
                        TP_STEPS, chunks)
        if not (np.isfinite(bpc) and SANITY_BAND[0] <= bpc <= SANITY_BAND[1]):
            fail(f"cli train {' '.join(extra)}: train_bpc {bpc}, band {SANITY_BAND}")
    _print_chunk_ms("the bench's layer 0 a call", 4, times)
    single = runs11b["single"]
    for label in ("sp C=4", "sp C=1"):
        _, step_ms, bpc = runs[label]
        print(f"  {label}: train_bpc {bpc:.6f} against 11b's single device "
              f"{single[2]:.6f} (gap {abs(bpc - single[2]):.3g}, not gated); "
              f"step {step_ms:.3f} ms against {single[1]:.3f} "
              f"({step_ms / single[1]:.2f}x)", flush=True)
    (ca, _, ba), (cb, mb, bb) = runs["sp C=4"], runs["dp x sp C=4"]
    gap = abs(bb - ba)
    print(f"  dp x sp: train_bpc {bb:.6f} against --sp 1's {ba:.6f} (gap "
          f"{gap:.3g}, tol {DP_BPC_TOL:g}); step {mb:.3f} ms", flush=True)
    if cb != ca or not gap <= DP_BPC_TOL:
        fail(f"phase 13b: launches {cb} (--sp 1: {ca}), train_bpc gap {gap}")
    return runs


def _superstep_run(extra, steps, superstep, warmup):
    """``cli train`` at 11b's configuration with ``extra`` (the parallel
    flags) for ``steps`` steps in supersteps of ``superstep``, an lr
    warm-up of ``warmup`` steps among them, driven a superstep at a time:
    (launch counts of the run, ms a step over every superstep but the
    first, each superstep's bits, the TP family or None)."""
    from eigen_lstm_tpu_torch.cli import _make_trainer, build_parser

    argv = _argv_with(TP_ARGV, steps=steps, superstep=superstep,
                      log_every=superstep, warmup=warmup) + extra
    trainer = _make_trainer(build_parser().parse_args(argv))
    try:
        counters = _tp_counters()
        torch.cuda.synchronize()
        before = _launch_counts(counters)
        bits = []
        for i in range(steps // superstep):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            trainer.state, met = trainer.dispatch_superstep()
            bits.append(float(met["bits_mean"]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _launch_counts(counters)
        backend = None if trainer.tp is None else trainer.tp.backend
    finally:
        trainer.mesh.close()
    return ({k: after[k] - before[k] for k in after},
            dt * 1e3 / (steps - superstep), bits, backend)


def phase13c():
    """``cli train --sp 1 --tp 1`` at 11b's configuration for SP_TP_STEPS
    steps in supersteps of SP_TP_SUPERSTEP, an lr warm-up of SP_TP_WARMUP
    among them:
    the torch-op TP scan, K11 the only kernel; the bits finite, the last
    superstep's below the first's."""
    counts, step_ms, bits, backend = _superstep_run(
        ["--sp", "1", "--tp", "1"], SP_TP_STEPS, SP_TP_SUPERSTEP, SP_TP_WARMUP)
    print(f"  cli train --sp 1 --tp 1: family {backend}, {SP_TP_STEPS} steps, "
          f"{step_ms:.2f} ms a step over the last "
          f"{SP_TP_STEPS - SP_TP_SUPERSTEP}, "
          "superstep bits " + " ".join(f"{b:.4f}" for b in bits)
          + f"; launches {counts}", flush=True)
    want = dict({k: 0 for k in counts}, adagrad=SP_TP_STEPS)
    if backend != "xla" or counts != want:
        fail(f"--sp 1 --tp 1: family {backend} (expected xla), launches "
             f"{counts}, the path gives {want}")
    if not (all(np.isfinite(bits)) and bits[-1] < bits[0]):
        fail(f"--sp 1 --tp 1: superstep bits {bits}")
    return step_ms


def top_h(params, x, h, c, cfg, cell_fn):
    """The top layer's h over the window, fp32, without autograd."""
    from eigen_lstm_tpu_torch.models import lstm as model

    with torch.no_grad():
        return model.forward(params, x, h, c, cfg, cell_fn)[0].float()


def phase13d():
    """The flagship at full width: one bible.txt window from ckpt_best.npz
    with dropout 0, ``sp_loss_and_grads`` in SP_FLAG_CHUNKS chunks at
    D = 1 against the single device's ``loss_and_grads``, both through the
    kernels, the launches of the chunked window against the plans. fp32
    (the tiled family): against the single device on the whole batch.
    bf16 (K1, K2, K3, K6): against the single device on each chunk's rows
    (the mean of its C calls) at 7b's rule; the top layer's h against the
    fp32 whole batch, the median stream within SP_STREAM_VS_PLAIN of the
    plain path's; the gradients of SP, the chunks, the whole batch and the
    chunks through K1's per-step design against the fp32 whole batch over
    the plain path's drift printed (the note at SP_STREAM_VS_PLAIN).
    Then SP_FLAG_STEPS steps of the flagship recipe through ``cli train
    --sp 1``."""
    import dataclasses

    from eigen_lstm_tpu_torch.models.lstm import step_key
    from eigen_lstm_tpu_torch.ops import cuda_cell_tiled
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.parallel.sp import sp_loss_and_grads
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

    gen = torch.Generator().manual_seed(13)
    x, t = bible_window(gen, FLAG_S, FLAG_B)
    rows = FLAG_B // SP_FLAG_CHUNKS
    chunk = lambda a, j: (a[..., j * rows:(j + 1) * rows, :] if a.dim() == 3
                          else a[:, j * rows:(j + 1) * rows]).contiguous()

    def chunked(fn, *args):
        """fn on each chunk's rows of (x, t, h, c): loss_and_grads's loss
        and gradients, the means over the chunks."""
        parts = [fn(*(chunk(a, j) for a in args)) for j in range(SP_FLAG_CHUNKS)]
        keys = [k for k, _ in parts[0][3].named_tensors()]
        return (statistics.fmean(float(p[0]) for p in parts),
                {k: sum(dict(p[3].named_tensors())[k] for p in parts)
                 / SP_FLAG_CHUNKS for k in keys})

    counters = _tp_counters()
    res, windows, tops = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(flag_train_cfg(dtype), dropout=0.0)
        params, _, _, extras = load_checkpoint(FLAGSHIP, cfg, DEVICE)
        h, c = (extras[k][:, :FLAG_B] for k in ("stream_h", "stream_c"))
        cell_fn = select_cell_fn("cuda", cfg, FLAG_B, DEVICE)
        torch.cuda.synchronize()
        before = _launch_counts(counters)
        tiled0 = cuda_cell_tiled.launches()
        loss, _, _, grads = sp_loss_and_grads(params, x, t, h, c, cfg,
                                              SP_FLAG_CHUNKS, None, cell_fn)
        torch.cuda.synchronize()
        after = _launch_counts(counters)
        counts = {k: after[k] - before[k] for k in after if k != "tiled"}
        counts.update((k, b - a) for k, a, b in
                      zip(TILED, tiled0, cuda_cell_tiled.launches()))
        windows[dtype] = counts
        res[(dtype, "sp")] = (float(loss), dict(grads.named_tensors()))
        one = loss_and_grads(params, x, t, h, c, cfg, cell_fn)
        res[(dtype, "one")] = (float(one[0]), dict(one[3].named_tensors()))
        tops[(dtype, "one")] = top_h(params, x, h, c, cfg, cell_fn)
        if dtype == "bfloat16":
            times = chunk_kernel_ms(cfg, params.layers[0], x, h[0], c[0],
                                    (rows, FLAG_B))
            step = lambda *a: loss_and_grads(params, *a, cfg, cell_fn)
            res[(dtype, "rows")] = chunked(step, x, t, h, c)
            tops[(dtype, "rows")] = torch.cat(
                [top_h(params, chunk(x, j), chunk(h, j), chunk(c, j), cfg,
                       cell_fn) for j in range(SP_FLAG_CHUNKS)], dim=1)
            with per_step_tiled(SPLIT_PLAN):
                res[(dtype, "rows, K1 per-step")] = chunked(step, x, t, h, c)
            plain_fn = select_cell_fn("plain", cfg, FLAG_B, DEVICE)
            one = loss_and_grads(params, x, t, h, c, cfg, plain_fn)
            res[(dtype, "plain")] = (float(one[0]), dict(one[3].named_tensors()))
            tops[(dtype, "plain")] = top_h(params, x, h, c, cfg, plain_fn)
        del params, grads, one
    torch.cuda.synchronize()
    cfg16 = flag_train_cfg("bfloat16")
    cfg32 = flag_train_cfg("float32")
    print(f"  flagship SP window ({SP_FLAG_CHUNKS} chunks of {rows} rows): fp32 "
          f"K8 and K9 in {tiled_fwd_design(cfg32, rows, 1024)[0]}, K10 in "
          f"{tiled_bwd_design(cfg32, rows, 1024)[0]}; launches {windows['float32']}",
          flush=True)
    print(f"  flagship SP window bf16: K1 in {split_design(cfg16, rows, 1024)[0]}, "
          f"K2 in {tiled_design(cfg16, rows, 1024)[0]}, K3 and K6 in "
          f"{k6_design(cfg16, rows, 1024)[0]}; launches {windows['bfloat16']}",
          flush=True)
    c_, s_ = SP_FLAG_CHUNKS, FLAG_S
    fwd_n = tiled_fwd_calls(cfg32, rows, 1024, s_)
    want32 = {"tiled_fwd_embed": c_ * fwd_n, "tiled_fwd_scan": 2 * c_ * fwd_n,
              "tiled_bwd": 3 * c_ * tiled_bwd_calls(cfg32, rows, 1024, s_)}
    got32 = {k: windows["float32"][k] for k in TILED}
    if got32 != want32 or windows["float32"]["lstm_fwd_embed"]:
        fail(f"flagship SP fp32 window: tiled launches {got32} (the chunks "
             f"give {want32}), K1 {windows['float32']['lstm_fwd_embed']}")
    _print_chunk_ms("the flagship's layer 0 a call (bf16)", SP_FLAG_CHUNKS,
                    times)
    w16 = windows["bfloat16"]
    plan16 = sp_plan_launches(cfg16, FLAG_S, rows, "flagship")
    want16 = {k: c_ * plan16.get(k, 0) for k in w16}
    if w16 != want16:
        fail(f"flagship SP bf16 window: launches {w16}, the plans give {want16}")
    # the gates: fp32 against the whole batch, bf16 against one device on
    # the same rows (the schedule)
    for dtype, ref in (("float32", "one"), ("bfloat16", "rows")):
        (ls, gs), (l1, g1) = res[(dtype, "sp")], res[(dtype, ref)]
        rel = abs(ls - l1) / abs(l1)
        line, bad = [], []
        for key in g1:
            err = norm_err(gs[key], g1[key])
            if dtype == "float32":
                ok, tol = err <= TRAIN_TOL, f"{TRAIN_TOL:g}"
            else:
                control = norm_err(res[(dtype, "one")][1][key],
                                   res[("float32", "one")][1][key])
                ok = err <= FLAG_BF16_VS_DRIFT * control
                tol = f"{FLAG_BF16_VS_DRIFT:g} x {control:.3e}"
            line.append(f"d{key[len('params.'):]} {err:.3e} ({tol})")
            if not np.isfinite(err) or not ok:
                bad.append(key)
        what = ("one device" if ref == "one" else
                f"one device on each chunk's {rows} rows")
        print(f"  flagship SP {dtype}: loss {ls:.6f}, {what} {l1:.6f} (rel "
              f"{rel:.2e}, tol {LOSS_RTOL[dtype]:g}); gradients against "
              f"{what}, normalised: " + ", ".join(line), flush=True)
        if not rel <= LOSS_RTOL[dtype] or bad:
            fail(f"flagship SP {dtype}: loss rel {rel:.2e}, gradients past "
                 f"their gate: {bad}")
    # bf16 against the fp32 whole batch: the top layer's h gated, the
    # gradients at 7b's rule printed (the note at SP_STREAM_VS_PLAIN)
    f32 = tops[("float32", "one")]
    stream = {k: (tops[("bfloat16", k)] - f32).abs().amax(dim=(0, 2))
              for k in ("rows", "one", "plain")}
    med = {k: float(v.median()) for k, v in stream.items()}
    print(f"  flagship bf16 top layer h against fp32, the median stream's "
          f"largest distance: {rows}-row chunks {med['rows']:.3e}, one device "
          f"{med['one']:.3e}, the plain path {med['plain']:.3e} (tol "
          f"{SP_STREAM_VS_PLAIN:g} x the plain path's); streams past 0.1: "
          + ", ".join(f"{k} {int((v > 0.1).sum())}" for k, v in stream.items()),
          flush=True)
    if not med["rows"] <= SP_STREAM_VS_PLAIN * med["plain"]:
        fail(f"flagship SP bf16: the median stream's top h {med['rows']:.3e} "
             f"from fp32, past {SP_STREAM_VS_PLAIN:g} x the plain path's")
    g32 = res[("float32", "one")][1]
    drift = {k: norm_err(v, g32[k]) for k, v in res[("bfloat16", "plain")][1].items()}
    for label in ("sp", "rows", "one", "rows, K1 per-step"):
        ratio = {k: norm_err(v, g32[k]) / drift[k]
                 for k, v in res[("bfloat16", label)][1].items()}
        worst = max(ratio, key=ratio.get)
        print(f"  flagship bf16 {label} against fp32, over the plain path's "
              f"drift (7b's rule 2, not gated here): worst d"
              f"{worst[len('params.'):]} {ratio[worst]:.2f}x; " + ", ".join(
                  f"d{k[len('params.'):]} {v:.2f}" for k, v in ratio.items()),
              flush=True)
    del res
    argv = FLAG_ARGV[:FLAG_ARGV.index("--superstep")] + [
        "--superstep", "2", "--steps", str(SP_FLAG_STEPS), "--sample-chars", "0",
        "--resume", FLAGSHIP, "--sp", "1", "--pp-chunks", str(SP_FLAG_CHUNKS)]
    trainer = None
    try:
        counts, step_ms, cps, bpc, _, trainer = _tp_run(argv, SP_FLAG_STEPS)
        per_chunk = sp_chunk_launches(trainer, rows, step_key(1235, 785000))
    finally:
        if trainer is not None:
            trainer.mesh.close()
    print(f"  flagship --sp 1: {SP_FLAG_STEPS} steps, {step_ms:.2f} ms a step "
          f"over the last {SP_FLAG_STEPS - 2}, {cps:,.0f} chars/s, bits "
          f"{bpc:.4f}; launches {counts}; a chunk of {rows} rows: {per_chunk} "
          f"(K3 {per_chunk['lstm_bwd_embed']} launches a call, K6 "
          f"{per_chunk['lstm_bwd_scan'] // 2})", flush=True)
    _sp_launch_gate("flagship --sp 1", counts,
                    sp_plan_launches(flag_train_cfg("bfloat16"), FLAG_S, rows,
                                     "flagship"),
                    per_chunk, SP_FLAG_STEPS, SP_FLAG_CHUNKS)
    if not (np.isfinite(bpc) and bpc < 3.0):
        fail(f"flagship --sp 1: bits {bpc}")
    return step_ms


# --- phase 14: pipeline parallelism at S = 1 (the torch-op scan and K11) --
# 14a/14b: 11b's configuration through cli train --pp 1 with the window's
# sequence in PP_CHUNKS chunks; as in the JAX package the stage's layers run
# the torch-op scan (its XLA scan), a launch for each op of each step, so
# PP_STEPS steps in supersteps of PP_SUPERSTEP, an lr warm-up of PP_WARMUP
# steps among them
PP_CHUNKS = 4
PP_STEPS, PP_SUPERSTEP, PP_WARMUP = 16, 4, 4
# 14c: the flagship's bible.txt window (dropout 0) in PP_CHUNKS chunks at
# S = 1 against one device through the same torch-op scan: the loss at
# rtol 1e-5, the gradients at tests/test_pp.py:58-70's rtol 1e-4 / atol
# 1e-6; under bf16 the products cut into chunks (W of layers >= 1, Why)
# round each chunk's weight gradient to bf16 through the cast's VJP where
# one device rounds the window's once, so those are held within
# (C + 1) half-ulps of bf16 of their largest entry (parallel/pp.py)
PP_LOSS_RTOL, PP_GRAD_RTOL, PP_GRAD_ATOL = 1e-5, 1e-4, 1e-6
PP_CHUNK_ROUNDED = ("layers[1].W", "layers[2].W", "Why")


def phase14k(records):
    """K11 (``k11_check``) on the stage-stacked ``PPParams`` that ``--pp``
    updates: the bench's set (1x512: W padded to max(256, 512) rows, its
    zero accumulators laid out as the trainer lays them out) and the
    flagship's (3x1024: W padded to 1024 rows, its checkpoint's
    accumulators)."""
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.models.lstm import init_params
    from eigen_lstm_tpu_torch.parallel import pp as pp_mod
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint
    from eigen_lstm_tpu_torch.train.optimizer import adagrad_init

    lr, eps = np.float32(0.02), 1e-10
    bench_cfg = ModelConfig(hidden=512)
    bench = init_params(bench_cfg, device=DEVICE)
    flag_cfg = flag_train_cfg("bfloat16")
    flag_p, flag_m, _, _ = load_checkpoint(FLAGSHIP, flag_cfg, DEVICE)
    gen = torch.Generator().manual_seed(14)
    for name, params, m, cfg in (("bench", bench, adagrad_init(bench), bench_cfg),
                                 ("flagship", flag_p, flag_m, flag_cfg)):
        records[("14k", name)] = k11_check(
            f"{name} PPParams", pp_mod.pp_params_from(params, cfg),
            pp_mod.pp_params_from(m, cfg), gen, lr, eps)


def phase14ab(runs11b):
    """``cli train --pp 1 --pp-chunks PP_CHUNKS`` (14a), ``--dp 1 --pp 1``
    (14b) and 14a again at 11b's configuration: K11 once a step and no
    other kernel, the bits finite and the last superstep's below the
    first's; 14b's launches 14a's and its bits within DP_BPC_TOL. Returns
    K11's launches of the three runs."""
    runs = {}
    for label, extra in (("pp", ["--pp", "1"]),
                         ("dp x pp", ["--dp", "1", "--pp", "1"]),
                         ("pp again", ["--pp", "1"])):
        counts, step_ms, bits, _ = _superstep_run(
            extra + ["--pp-chunks", str(PP_CHUNKS)], PP_STEPS, PP_SUPERSTEP,
            PP_WARMUP)
        runs[label] = (counts, step_ms, bits)
        print(f"  cli train {' '.join(extra)} --pp-chunks {PP_CHUNKS}: "
              f"{PP_STEPS} steps, {step_ms:.2f} ms a step over the last "
              f"{PP_STEPS - PP_SUPERSTEP} against 11b's single device "
              f"{runs11b['single'][1]:.3f} ms "
              f"({step_ms / runs11b['single'][1]:.1f}x), superstep bits "
              + " ".join(f"{b:.6f}" for b in bits) + f"; launches {counts}",
              flush=True)
        want = dict({k: 0 for k in counts}, adagrad=PP_STEPS)
        if counts != want:
            fail(f"cli train {' '.join(extra)}: launches {counts}, the path "
                 f"gives {want} (K11 once a step, the torch-op scan)")
        if not (all(np.isfinite(bits)) and bits[-1] < bits[0]):
            fail(f"cli train {' '.join(extra)}: superstep bits {bits}")
    (ca, ma, ba), (cb, mb, bb), (_, mc, _) = (
        runs["pp"], runs["dp x pp"], runs["pp again"])
    gap = max(abs(a - b) for a, b in zip(ba, bb))
    print(f"  dp x pp: superstep bits against --pp 1's, largest gap {gap:.3g} "
          f"(tol {DP_BPC_TOL:g}); ms a step --pp 1 {ma:.2f}, --dp 1 --pp 1 "
          f"{mb:.2f}, --pp 1 again {mc:.2f}", flush=True)
    if cb != ca or not gap <= DP_BPC_TOL:
        fail(f"phase 14b: launches {cb} (--pp 1: {ca}), bits gap {gap}")
    return sum(c["adagrad"] for c, _, _ in runs.values())


def phase14c():
    """The flagship at full width: one bible.txt window from ckpt_best.npz
    with dropout 0, ``pp_loss_and_grads`` at S = 1 in PP_CHUNKS chunks
    against one device's ``loss_and_grads`` with ``cell_fn=None`` (the
    same torch-op scan), fp32 and bf16, no kernel launched: the loss at
    PP_LOSS_RTOL, each gradient at PP_GRAD_RTOL / PP_GRAD_ATOL, bf16's
    chunk-rounded ones within (C + 1) half-ulps of bf16 of their largest
    entry; the largest differences printed."""
    import dataclasses

    from eigen_lstm_tpu_torch.parallel import pp as pp_mod
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

    x, t = bible_window(torch.Generator().manual_seed(14), FLAG_S, FLAG_B)
    counters = _tp_counters()
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(flag_train_cfg(dtype), dropout=0.0)
        params, _, _, extras = load_checkpoint(FLAGSHIP, cfg, DEVICE)
        h, c = (extras[k][:, :FLAG_B].contiguous()
                for k in ("stream_h", "stream_c"))
        torch.cuda.synchronize()
        before = _launch_counts(counters)
        t0 = time.perf_counter()
        loss, (hT, cT), _, grads = pp_mod.pp_loss_and_grads(
            pp_mod.pp_params_from(params, cfg), x, t, h, c, cfg, PP_CHUNKS,
            None)
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in _launch_counts(counters).items()
                    if v != before[k]}
        t0 = time.perf_counter()
        l1, (h1, c1), _, g1 = loss_and_grads(params, x, t, h, c, cfg, None)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        rel = abs(float(loss) - float(l1)) / abs(float(l1))
        state = max(float((a - b).abs().max()) for a, b in ((hT, h1), (cT, c1)))
        line, bad = [], []
        got = dict(pp_mod.pp_params_to(grads, cfg).named_tensors())
        for key, w in g1.named_tensors():
            g, name = got[key], key[len("params."):]
            diff = (g - w).abs()
            gap = norm_err(g, w)
            if dtype == "bfloat16" and name in PP_CHUNK_ROUNDED:
                ok = gap <= (PP_CHUNKS + 1) * 2.0**-9
                rule = f"norm {gap:.2e} (tol {(PP_CHUNKS + 1) * 2.0**-9:.2e})"
            else:
                ok = bool((diff <= PP_GRAD_ATOL + PP_GRAD_RTOL * w.abs()).all())
                rule = f"norm {gap:.2e}"
            line.append(f"d{name} max {float(diff.max()):.2e} {rule}")
            if not ok:
                bad.append(name)
        print(f"  flagship PP window {dtype} ({PP_CHUNKS} chunks, S = 1): loss "
              f"{float(loss):.7f}, one device {float(l1):.7f} (rel {rel:.2e}, tol "
              f"{PP_LOSS_RTOL:g}), final state max {state:.2e}; {pp_s:.2f} s "
              f"against {one_s:.2f} s; kernels launched {launched or 'none'}; "
              + ", ".join(line), flush=True)
        if not rel <= PP_LOSS_RTOL or bad or launched:
            fail(f"flagship PP window {dtype}: loss rel {rel:.2e}, gradients "
                 f"past their gate {bad}, launches {launched}")
        del params, grads, g1, got


# --- phase 15: K15/K16's exchange at D > 1, on one card as D rank groups --
# the one-card launch repeated on the same buffers, each call's bits the first's
X_REPEATS = 10
# the IPC round trip: a child process that loads the kernels' library with
# ctypes alone opens the parent's buffer from its handle and writes a pattern
IPC_CHILD = """
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
handle, words, seed = bytes.fromhex(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
lib.exchange_ipc_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
lib.exchange_write_pattern.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint]
lib.exchange_ipc_close.argtypes = [ctypes.c_void_p]
ptr = ctypes.c_void_p()
for step, err in (("open", lambda: lib.exchange_ipc_open(handle, ctypes.byref(ptr))),
                  ("write", lambda: lib.exchange_write_pattern(ptr, words, seed)),
                  ("close", lambda: lib.exchange_ipc_close(ptr))):
    code = err()
    if code:
        print(f"exchange_ipc_{step}: CUDA error {code}")
        sys.exit(1)
"""


NVLINK_BYTES_PER_S = 450e9   # one direction of a card's NVLink links


def exchange_bytes(cfg, s, b, n, d, backward: bool):
    """The bytes one rank of the D-rank window stores into its D - 1 peers'
    buffers: the forward's S - 1 exchanges of its h tile (B x nd in the
    compute type), the backward's S of its partial's peers' chunks (B x nd
    in fp32 each). They are neither input nor output of the function, so
    they stay out of its bound (``tp_seq_bound`` at the whole width): on one
    card they stay in L2, on D cards they cross NVLink, a link of its own,
    and are printed with their time at NVLink's rate."""
    nd = n // d
    size = 4 if backward else torch.finfo(cfg.cdtype).bits // 8
    return (s if backward else s - 1) * (d - 1) * b * nd * size


def ranks_fwd_check(tc, U_cs, xws, h0_full, c0s, cfg, outs, tag):
    """Every rank's window of the D-rank forward, every step replayed by
    K13's plain version from the kernel's own state: the full h_{t-1} (the
    ranks' h_seq side by side, rounded to the compute type) and the rank's
    c_{t-1}; h_seq, g, c_{t+1} (cT at the last) and hT within STEP_ATOL and
    TRAIN_TOL normalised, c_prev[0] = c0 bit for bit. Returns the
    normalised error."""
    s, b, nd4 = xws[0].shape
    nd = nd4 // 4
    h_all = torch.cat([o[0] for o in outs], 2)
    h_prev = torch.cat([h0_full[None], h_all[:-1]]).reshape(s * b, -1).to(cfg.cdtype)
    rel = err = 0.0
    first = True
    for r, (h_seq, g_seq, c_prev, hT, cT) in enumerate(outs):
        h2, c2, g = tc.tp_step_plain(U_cs[r], xws[r].reshape(s * b, nd4), h_prev,
                                     c_prev.reshape(s * b, nd), cfg)
        c_next = torch.cat([c_prev[1:], cT[None]]).reshape(s * b, nd)
        pairs = ((h_seq.reshape(s * b, nd), h2), (c_next, c2),
                 (g_seq.reshape(s * b, nd4), g), (hT, h2[-b:]))
        rel = max([rel] + [norm_err(a, p) for a, p in pairs])
        err = max([err] + [max_err(a, p)[0] for a, p in pairs])
        first = first and torch.equal(c_prev[0], c0s[r].to(c_prev.dtype))
    torch.cuda.synchronize()
    print(f"  K15 {tag}: every rank's every step within {err:.3e} of its plain "
          f"replay (atol {STEP_ATOL:g}; normalised {rel:.3e}, tol {TRAIN_TOL:g}); "
          f"c_prev[0] {'is' if first else 'is NOT'} c0", flush=True)
    if not (np.isfinite(err) and err <= STEP_ATOL and rel <= TRAIN_TOL and first):
        fail(f"K15 {tag}: replay {err:.3e} ({rel:.3e}), c_prev[0] = c0 {first}")
    return rel


def ranks_bwd_replay(U_cs, g_seqs, c_prevs, cTs, dh_seqs, dhTs, dcTs, cfg, dgs_k):
    """The plain arithmetic of every rank's every reverse step from the
    kernel's own dg_{t+1} of every rank: the D partials round(dg_{t+1}) @
    U_r^T, each rank's chunk summed in rank order, then the gate backward
    with the fp32 dc chain. A list of D (dg, dh0, dc0)."""
    import functools
    import operator

    from eigen_lstm_tpu_torch.ops import cell as cell_ops

    s, _, nd = c_prevs[0].shape
    f32 = torch.float32
    rnd = lambda x: x.to(cfg.cdtype).to(f32)
    parts = [rnd(dg) @ U.to(f32).T for dg, U in zip(dgs_k, U_cs)]   # (S, B, N)
    out = []
    for r in range(len(U_cs)):
        rec = functools.reduce(operator.add, [p[..., r * nd:(r + 1) * nd] for p in parts])
        dh_rec = torch.cat([rec[1:], dhTs[r][None]])
        c_seq = torch.cat([c_prevs[r][1:], cTs[r][None]])
        dc, dgs = dcTs[r], [None] * s
        for t in reversed(range(s)):
            dgs[t], dc = cell_ops.gate_bwd(
                g_seqs[r][t].to(f32), c_seq[t].to(f32), c_prevs[r][t].to(f32),
                dh_seqs[r][t] + dh_rec[t], dc, nd, cfg.cell_variant)
        out.append((torch.stack(dgs), rec[0], dc))
    return out


def _same(a, b):
    return all(torch.equal(x, y) for xs, ys in zip(a, b) for x, y in zip(xs, ys))


def ipc_round_trip():
    """A buffer from the library's IPC allocator, opened from its handle in
    a child process that loads the library with ctypes alone (no torch),
    which writes a pattern; the parent reads the pattern back."""
    import ctypes

    from eigen_lstm_tpu_torch.ops import _build, cuda_tp_seq as ts

    lib = _build.load_library()
    words, seed = 1 << 18, 0x5EED
    ptr = ts._alloc(lib, 4 * words)
    try:
        handle = ctypes.create_string_buffer(64)
        ts._ok(lib.exchange_ipc_handle(ptr, handle), "exchange_ipc_handle")
        child = subprocess.run(
            [sys.executable, "-c", IPC_CHILD, _build.library_path(),
             handle.raw.hex(), str(words), str(seed)],
            capture_output=True, text=True, timeout=120)
        got = np.zeros(words, np.uint32)
        ts._ok(lib.exchange_read(got.ctypes.data, ptr, 4 * words), "exchange_read")
    finally:
        ts._ok(lib.exchange_free(ptr), "exchange_free")
    x = np.arange(words, dtype=np.uint32) * np.uint32(0x9E3779B9) ^ np.uint32(seed)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    same = bool(np.array_equal(got, x))
    print(f"  IPC on one card: a child process (ctypes alone) opened a "
          f"{4 * words}-byte buffer from its handle and wrote the pattern: exit "
          f"{child.returncode}, read back {'equal' if same else 'NOT equal'}"
          + (f"; {child.stdout.strip()} {child.stderr.strip()[-400:]}"
             if child.returncode else ""), flush=True)
    if child.returncode != 0 or not same:
        fail("phase 15: the IPC round trip between two processes failed")


@contextlib.contextmanager
def cooperative_ranks():
    """K15's and K16's D-rank wrappers take their cooperative design inside
    the block, whatever ``ranks_fwd_plan`` and ``ranks_bwd_plan`` would
    choose: for the checks and times of that design where bf16 takes the
    persistent one."""
    from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts

    plans = ts.device_ranks_fwd_plan, ts.device_ranks_bwd_plan
    ts.device_ranks_fwd_plan = ts.device_ranks_bwd_plan = lambda *a, **k: None
    try:
        yield
    finally:
        ts.device_ranks_fwd_plan, ts.device_ranks_bwd_plan = plans


class CountingLibrary:
    """The kernels' library, counting the calls of each C entry point made
    through it (an exchange's ``lib``): which launcher a wrapper took."""

    def __init__(self, lib):
        self.lib, self.calls = lib, {}

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args)
        return call


PERSIST_SOURCE = "eigen_lstm_tpu_torch/csrc/lstm_tp_persist.cu"


def ranks_design(design, tag, U_cs, xws, h0, c0s, bargs, cfg, ex, one_ref, lag):
    """One D-rank design of K15 and K16 on the one card (the wrappers'
    choice, or the cooperative design inside ``cooperative_ranks``): every
    rank's every step replayed; the forward against ``one_ref`` (the D = 1
    design of the same sums on the unpermuted weights, bit for bit: h_seq,
    g through ``perm``, c_prev, hT, cT; None: not compared); X_REPEATS
    calls on the same buffers, each the first call's bits; ``lag`` a
    lagging group's call: (forward kwargs, backward kwargs, bits) where
    bits says whether the forward's lag keeps the bits (the cooperative
    design's split does, the persistent forward's fewer rows move the
    sums, so its lagging call is replayed instead; the persistent
    backward's fewer row blocks keep them). Returns (forward outputs,
    backward outputs, the forward's and backward's replay errors)."""
    from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc, cuda_tp_seq as ts

    fwd = ts.tp_seq_fwd_ranks(U_cs, xws, h0, c0s, cfg, ex)
    rel = ranks_fwd_check(tc, U_cs, xws, h0, c0s, cfg, fwd, f"{tag} {design}")
    if one_ref is not None:
        one, perm = one_ref
        cat = lambda k: torch.cat([o[k] for o in fwd], -1)
        same1 = [torch.equal(cat(0), one[0]), torch.equal(cat(1), one[1][..., perm]),
                 torch.equal(cat(2), one[2]), torch.equal(cat(3), one[3]),
                 torch.equal(cat(4), one[4])]
        print(f"  K15 {tag} {design}: bit for bit the D = 1 {design} design on the "
              f"unpermuted weights (h_seq, g, c_prev, hT, cT): {same1}", flush=True)
        if not all(same1):
            fail(f"K15 {tag} {design}: the D = 1 design's bits {same1}")
    bargs = (U_cs, [o[1] for o in fwd], [o[2] for o in fwd], [o[4] for o in fwd]) + bargs
    bwd = ts.tp_seq_bwd_ranks(*bargs, ex)
    rep = ranks_bwd_replay(*bargs, [o[0] for o in bwd])
    torch.cuda.synchronize()
    brel = max(norm_err(a, p) for o, q in zip(bwd, rep) for a, p in zip(o, q))
    print(f"  K16 {tag} {design}: every rank's every reverse step, dh0, dc0 within "
          f"{brel:.3e} of the plain replay from its own dg (tol {TRAIN_TOL:g})",
          flush=True)
    if not (np.isfinite(brel) and brel <= TRAIN_TOL):
        fail(f"K16 {tag} {design}: replay {brel:.3e}")
    calls = [(ts.tp_seq_fwd_ranks(U_cs, xws, h0, c0s, cfg, ex),
              ts.tp_seq_bwd_ranks(*bargs, ex)) for _ in range(X_REPEATS)]
    lagged = ""
    if lag is not None:
        fkw, bkw, fbits = lag
        lf = ts.tp_seq_fwd_ranks(U_cs, xws, h0, c0s, cfg, ex, **fkw)
        lb = ts.tp_seq_bwd_ranks(*bargs, ex, **bkw)
        if fbits:
            calls.append((lf, lb))
        else:
            calls.append((fwd, lb))
            lrel = ranks_fwd_check(tc, U_cs, xws, h0, c0s, cfg, lf,
                                   f"{tag} {design}, lagging rank 0")
            lbargs = (U_cs, [o[1] for o in lf], [o[2] for o in lf],
                      [o[4] for o in lf]) + bargs[4:]
            lb2 = ts.tp_seq_bwd_ranks(*lbargs, ex, **bkw)
            lrep = ranks_bwd_replay(*lbargs, [o[0] for o in lb2])
            torch.cuda.synchronize()
            lbrel = max(norm_err(a, p) for o, q in zip(lb2, lrep) for a, p in zip(o, q))
            print(f"  K16 {tag} {design}, lagging rank 0 after the lagging forward: "
                  f"replay {lbrel:.3e} (tol {TRAIN_TOL:g}); the forward's {lrel:.3e}",
                  flush=True)
            if not (np.isfinite(lbrel) and lbrel <= TRAIN_TOL):
                fail(f"K16 {tag} {design} lagging: replay {lbrel:.3e}")
        lagged = (f"rank 0 lagging (forward {fkw}, backward {bkw}; "
                  f"{'each' if fbits else 'the backward'} the first call's bits) and ")
    torch.cuda.synchronize()
    same = [_same(f, fwd) and _same(g, bwd) for f, g in calls]
    print(f"  K15/K16 {tag} {design}: {lagged}{X_REPEATS} calls on the same buffers, "
          f"each the first call's bits: {sum(same)} of {len(same)}", flush=True)
    if not all(same):
        fail(f"K15/K16 {tag} {design}: a lagging or repeated call moved the bits: {same}")
    return fwd, bwd, rel, brel


def phase15(records, smi):
    """K15 and K16 at D > 1 on the one card: one cooperative launch of D rank
    groups (``tp_seq_fwd_ranks``, ``tp_seq_bwd_ranks``), the device code each
    rank runs on D cards, its peer table the card's D buffers. At the
    bench's shapes (1x512, S = 100, B = 128, fp32 residuals; the 1x512
    checkpoint's U and W on a bible.txt window) for D = 2 and 4 and at the
    flagship's layer shapes (N = 1024, S = 256, B = 128; its layer 1) for
    D = 2, the weights through the TP gate permutation; both types in both
    designs (the persistent one the wrappers take, the cooperative one
    forced). Each design: every rank's forward
    step and reverse step replayed from the kernel's own state (TRAIN_TOL);
    the forward bit for bit its D = 1 counterpart on the unpermuted weights
    (the bf16 persistent design with the D = 1 layout's rows and the fp32
    one the D = 1 persistent K15 of their type, the cooperative one the
    D = 1 cooperative design); X_REPEATS calls on the same buffers and a
    lagging rank 0 (the bf16 persistent design: a forward of one block
    row and a backward of the fewest row blocks, at every shape; the fp32
    one: a forward of one block row where the plan splits the batch; the
    cooperative: one block, at the bench's shapes), the first call's bits
    (the bf16 persistent forward's lag replayed); times beside the bound,
    the plain versions, cuDNN, the D = 1 designs and the other design
    timed in the same call (the persistent must be faster). The fp32
    windows at the bench's shapes against the D-rank plain versions (where
    11a gates K15's and K16's). Then the IPC round trip between two
    processes, and the launch counts and launchers of one D-rank window in
    each persistent design (the bench's layer at D = 2, bf16 and fp32) and
    in the cooperative one at 136 batch rows."""
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.ops import _build, cuda_cell_tiled as ct, cuda_tp_seq as ts
    from eigen_lstm_tpu_torch.parallel.tp import _gate_permutation
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    print(f"  card: {smi}", flush=True)
    gen = torch.Generator().manual_seed(15)
    rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd).to(DEVICE)
    lib = _build.load_library()
    drives, exchanges = {}, []
    for shape, s, b, n, dees in (("bench", TRAIN_S, TRAIN_B, 512, (2, 4)),
                                 ("flagship", FLAG_S, FLAG_B, 1024, (2,))):
        if shape == "bench":
            layer = load_params(H512, train_cfg("float32"), DEVICE).layers[0]
            x, _ = bible_window(gen, s, b)
            xw = layer.W[x.long()] + layer.b
        else:
            layer = load_params(FLAGSHIP, flag_train_cfg("float32"), DEVICE).layers[1]
            xw = rand(s, b, 4 * n, sd=0.5) + layer.b
        for dtype in ("float32", "bfloat16"):
            t_shape = time.perf_counter()
            cfg = ModelConfig(hidden=n, compute_dtype=dtype, residual_dtype="float32")
            U_c = layer.U.to(cfg.cdtype)
            h0, c0 = torch.tanh(rand(b, n, sd=0.5)), rand(b, n, sd=0.3)
            # the D = 1 designs on the unpermuted weights: the cooperative
            # forward, and the persistent one the wrapper takes
            with per_step_tiled(SPLIT_PLAN):
                one = ts.tp_seq_fwd(U_c, xw, h0, c0, cfg)
                one_ms = cuda_ms(lambda: ts.tp_seq_fwd(U_c, xw, h0, c0, cfg), reps=2,
                                 windows=3)
            one_p = ts.tp_seq_fwd(U_c, xw, h0, c0, cfg)
            dh_full = rand(s, b, n, sd=1e-2)
            dhT_full, dcT_full = rand(b, n, sd=1e-2), rand(b, n, sd=1e-2)
            with per_step_k6():
                one_b = ts.tp_seq_bwd(U_c, one[1], one[2], one[4], dh_full,
                                      dhT_full, dcT_full, cfg)
                one_bms = cuda_ms(lambda: ts.tp_seq_bwd(
                    U_c, one[1], one[2], one[4], dh_full, dhT_full, dcT_full, cfg),
                    reps=2, windows=3)
            # the D = 1 design's own windows against its plain versions
            one_win = max(norm_err(a, p) for a, p in
                          zip(one, ts.tp_seq_fwd_plain(U_c, xw, h0, c0, cfg)))
            one_bwin = max(norm_err(a, p) for a, p in zip(one_b, ts.tp_seq_bwd_plain(
                U_c, one[1], one[2], one[4], dh_full, dhT_full, dcT_full, cfg)))
            h_in = torch.tanh(rand(s, b, n))
            lib15 = library_ms(n, cfg, h_in, h0, c0)
            lib16 = library_lstm_bwd(cfg, h_in, h0, c0, dh_full)
            for d in dees:
                tag = f"{shape} {dtype} D={d}"
                nd = n // d
                perm = torch.as_tensor(_gate_permutation(n, d), device=DEVICE)
                U_p, xw_p = U_c[:, perm], xw[..., perm]
                cut = lambda x, r, w: x[..., r * w:(r + 1) * w].contiguous()
                U_cs = [cut(U_p, r, 4 * nd) for r in range(d)]
                xws = [cut(xw_p, r, 4 * nd) for r in range(d)]
                c0s = [cut(c0, r, nd) for r in range(d)]
                dhs = [cut(dh_full, r, nd) for r in range(d)]
                dhTs = [cut(dhT_full, r, nd) for r in range(d)]
                dcTs = [cut(dcT_full, r, nd) for r in range(d)]
                ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
                exchanges.append(ex)
                designs = [("persistent", contextlib.nullcontext),
                           ("cooperative", cooperative_ranks)]
                fplan = ts.device_ranks_fwd_plan(cfg, b, n, d, one_card=True)
                bplan = ts.device_ranks_bwd_plan(cfg, b, n, d, one_card=True)
                if fplan is None or bplan is None:
                    fail(f"K15/K16 {tag}: no persistent layout ({fplan}, {bplan})")
                if dtype == "bfloat16":
                    d1_rows = ct.device_split_fwd_plan(cfg, b, n)[1]
                    print(f"  K15/K16 {tag}: the persistent layouts, forward (kres, "
                          f"rows) {fplan} ({d} x {nd // 16} x {-(-b // fplan[1])} "
                          f"blocks; the D = 1 layout's rows {d1_rows}), backward "
                          f"(units, rows) {bplan} ({d} x {n // bplan[0]} x "
                          f"{-(-b // bplan[1])} blocks)", flush=True)
                else:
                    print(f"  K15/K16 {tag}: the fp32 persistent layouts, forward "
                          f"{fplan} ({d} x {nd // 8} x {-(-b // fplan.rows)} blocks), "
                          f"backward {bplan} ({d} x {n // 16} x {bplan.blocks} "
                          f"blocks, the G of a group on one card)", flush=True)
                times, outs = {}, {}
                for design, ctx in designs:
                    smem = ct._device_limits(torch.cuda.current_device())[1]
                    if design == "persistent" and dtype == "float32":
                        # rank 0 with every row in one block row: fewer blocks,
                        # the same bits (none where the plan holds every row)
                        lag_f = ct.f32_split_layout(b, n, nd // 8, nd // 8, smem, rows=b)
                        lag = None if lag_f == fplan else (
                            dict(layouts=[lag_f] + [fplan] * (d - 1)), {}, True)
                        ref = (one_p, perm)
                    elif design == "persistent":
                        lag_f = ts.ranks_fwd_plan(cfg, b, n, d, nd // 16, smem)
                        row_blocks = [ts.lag_row_blocks(b, n, d, bplan[0])] + \
                            [-(-b // bplan[1])] * (d - 1)
                        lag = (dict(layouts=[lag_f] + [fplan] * (d - 1)),
                               dict(layouts=[(*bplan, r) for r in row_blocks]), False)
                        ref = ((one_p, perm) if fplan[1] == d1_rows else None)
                    else:
                        ctype = 1 if dtype == "bfloat16" else 0
                        share = lambda tiles, bwd: [1] + [min(
                            tiles, ts._resident(lib, bwd, ctype, 0) // d)] * (d - 1)
                        lag = None if shape != "bench" else (
                            dict(blocks=share(ts.fwd_tiles(b, nd), 0)),
                            dict(blocks=share(ts.bwd_tiles(b, n), 1)), True)
                        ref = (one, perm)
                    with ctx():
                        fwd, bwd, rel, brel = ranks_design(
                            design, tag, U_cs, xws, h0, c0s, (dhs, dhTs, dcTs, cfg), cfg,
                            ex, ref, lag)
                        bargs = (U_cs, [o[1] for o in fwd], [o[2] for o in fwd],
                                 [o[4] for o in fwd], dhs, dhTs, dcTs, cfg)
                        times[design] = (
                            cuda_ms(lambda: ts.tp_seq_fwd_ranks(U_cs, xws, h0, c0s, cfg, ex),
                                    reps=2, windows=3),
                            cuda_ms(lambda: ts.tp_seq_bwd_ranks(*bargs, ex), reps=2,
                                    windows=3))
                    outs[design] = (fwd, bwd, rel, brel, bargs)
                    if (shape, d) == ("bench", 2):
                        drives[(dtype, design)] = (U_cs, xws, h0, c0s, cfg, bargs[4:], ex)
                # the windows against the D-rank plain versions: gated where
                # 11a gates them, in fp32 at the bench's 100 steps; over the
                # flagship's 256 the fp32 sums' order carries further
                fwd, bwd, _, _, bargs = outs[designs[0][0]]
                plain = ts.tp_seq_fwd_ranks_plain(U_cs, xws, h0, c0s, cfg)
                bplain = ts.tp_seq_bwd_ranks_plain(*bargs)
                win = max(norm_err(a, p) for o, q in zip(fwd, plain) for a, p in zip(o, q))
                bwin = max(norm_err(a, p) for o, q in zip(bwd, bplain) for a, p in zip(o, q))
                gate_win = dtype == "float32" and shape == "bench"
                print(f"  K15/K16 {tag} {designs[0][0]}: the windows against the D-rank "
                      f"plain versions {win:.3e}, {bwin:.3e} "
                      f"({'gated' if gate_win else 'printed'}, tol {TRAIN_TOL:g}; the "
                      f"D = 1 cooperative design's against its plain versions "
                      f"{one_win:.3e}, {one_bwin:.3e})", flush=True)
                if gate_win and not (win <= TRAIN_TOL and bwin <= TRAIN_TOL):
                    fail(f"K15/K16 {tag}: windows {win:.3e}, {bwin:.3e}")
                plain15 = once_ms(lambda: ts.tp_seq_fwd_ranks_plain(U_cs, xws, h0, c0s, cfg))
                plain16 = once_ms(lambda: ts.tp_seq_bwd_ranks_plain(*bargs))
                b15, b16 = (tp_seq_bound(cfg, s, b, n, False),
                            tp_seq_bound(cfg, s, b, n, True))
                x15, x16 = (exchange_bytes(cfg, s, b, n, d, False),
                            exchange_bytes(cfg, s, b, n, d, True))
                for design, _ in designs:
                    ms15, ms16 = times[design]
                    _, _, rel, brel, _ = outs[design]
                    other = [x for x, _ in designs if x != design]
                    for k, ms, bd, xb, pl, lb, one_t, i in (
                            ("K15", ms15, b15, x15, plain15, lib15, one_ms, 0),
                            ("K16", ms16, b16, x16, plain16, lib16, one_bms, 1)):
                        vs = "".join(f"; the {o} design in the same call "
                                     f"{times[o][i]:.4f} ms" for o in other)
                        print(f"  {k} {tag} {design}: {ms:.4f} ms a call (1 launch, {d} "
                              f"rank groups), bound {bd[0]:.5f} ms ({bd[1]}; the inputs "
                              f"and outputs at the whole width), plain {pl:.4f} ms, cuDNN "
                              f"{'n/a' if lb is None else f'{lb:.4f} ms'}; the D = 1 "
                              f"cooperative design at these total shapes {one_t:.4f} ms"
                              f"{vs}; the exchange {xb} bytes a rank to its peers, "
                              f"{xb / NVLINK_BYTES_PER_S * 1e3:.5f} ms at NVLink's "
                              f"450 GB/s a direction on D cards", flush=True)
                    suffix = "_x" if design == "cooperative" else ""
                    for name, err, ms, pl, bd, xb, lb, one_t in (
                            ("tp_seq_fwd_ranks", rel, ms15, plain15, b15, x15, lib15, one_ms),
                            ("tp_seq_bwd_ranks", brel, ms16, plain16, b16, x16, lib16, one_bms)):
                        rec = dict(_tp_record(name.replace("_ranks", ""), err, ms, pl, bd, lb),
                                   name=name + suffix, design=design,
                                   d1_cooperative_ms=one_t, exchange_bytes=xb,
                                   nvlink_ms=xb / NVLINK_BYTES_PER_S * 1e3)
                        if design == "persistent":
                            coop = times["cooperative"][name == "tp_seq_bwd_ranks"]
                            f32_src = (TP_F32_SOURCE if name == "tp_seq_fwd_ranks"
                                       else TP_F32_BWD_SOURCE)
                            rec.update(source=PERSIST_SOURCE if dtype == "bfloat16"
                                       else f32_src, cooperative_ms=coop)
                        records[("15", name + suffix, shape, dtype, d)] = rec
                if "persistent" in times:
                    slower = [k for k, i in (("K15", 0), ("K16", 1))
                              if not times["persistent"][i] < times["cooperative"][i]]
                    if slower:
                        fail(f"K15/K16 {tag}: the persistent design is not faster than "
                             f"the cooperative one in the same call: {slower} "
                             f"{times}")
            print(f"  ({shape} {dtype}: {time.perf_counter() - t_shape:.1f} s)", flush=True)
    ipc_round_trip()
    # the launches of one D-rank window: the bench's layer at D = 2 in bf16
    # and fp32 (the persistent designs), and at 136 rows in fp32, which no
    # persistent plan takes (the cooperative one)
    counts = {}
    U_cs, _, _, _, cfg32, _, _ = drives[("float32", "persistent")]
    bx, sx, d = 136, 16, len(U_cs)
    nd = U_cs[0].shape[1] // 4
    ex_x = ts.one_card_exchange(bx, d * nd, d, cfg32.cdtype)
    exchanges.append(ex_x)
    refused = (U_cs, [rand(sx, bx, 4 * nd, sd=0.5) for _ in range(d)],
               torch.tanh(rand(bx, d * nd, sd=0.5)), [rand(bx, nd, sd=0.3)] * d, cfg32,
               ([rand(sx, bx, nd, sd=1e-2)] * d, [rand(bx, nd, sd=1e-2)] * d,
                [rand(bx, nd, sd=1e-2)] * d, cfg32), ex_x)
    for dtype, drive, launcher, suffix in (
            ("bfloat16", drives[("bfloat16", "persistent")],
             "tp_seq_fwd_persist_ranks_launch", ""),
            ("float32", drives[("float32", "persistent")], "tp_seq_fwd_f32_ranks_launch",
             "_fp32"),
            ("float32, 136 rows", refused, "tp_seq_fwd_ranks_launch", "_x")):
        U_cs, xws, h0, c0s, cfg, brest, ex = drive
        counting = ex.lib = CountingLibrary(ex.lib)
        ts.tp_seq_fwd_ranks.launches = ts.tp_seq_bwd_ranks.launches = 0
        fwd = ts.tp_seq_fwd_ranks(U_cs, xws, h0, c0s, cfg, ex)
        ts.tp_seq_bwd_ranks(U_cs, [o[1] for o in fwd], [o[2] for o in fwd],
                            [o[4] for o in fwd], *brest, ex)
        torch.cuda.synchronize()
        ex.lib = counting.lib
        got = {"tp_seq_fwd_ranks": ts.tp_seq_fwd_ranks.launches,
               "tp_seq_bwd_ranks": ts.tp_seq_bwd_ranks.launches}
        bwd_launcher = launcher.replace("fwd", "bwd")
        counting.calls = {k: v for k, v in counting.calls.items() if k.endswith("_launch")}
        print(f"  one D-rank window (the bench's layer, D = 2, {dtype}): launches "
              f"{got} through {counting.calls}", flush=True)
        if got != {"tp_seq_fwd_ranks": 1, "tp_seq_bwd_ranks": 1} or \
                counting.calls != {launcher: 1, bwd_launcher: 1}:
            fail(f"phase 15: the D-rank window ({dtype}) launched {got} through "
                 f"{counting.calls}")
        counts.update({k + suffix: v for k, v in got.items()})
    for ex in exchanges:
        ex.close()
    return counts


def main():
    smi = phase0()
    check_budget("phase 0")
    phase1()
    check_budget("phase 1 (build)")
    from eigen_lstm_tpu_torch.data.corpus import rawread, split

    test = split(rawread(CORPUS), 0.95)[1]
    records = {}
    phase2(test, records)
    check_budget("phase 2 (kernels against plain)")
    (emb, scan), scan_step, k1_cli_eval = phase3(test)
    check_budget("phase 3 (eval path)")
    gen_launches = phase4()
    check_budget("phase 4 (sampling)")
    per_call = phase5(records)
    check_budget("phase 5 (training kernels against plain)")
    phase6a()
    check_budget("phase 6a (loss and gradients, kernels against plain)")
    counts, step_ms, _ = phase6b(per_call)
    for name in ("lstm_fwd_embed", "lstm_bwd_embed", "head_fwd", "head_bwd"):
        ms = (records[("k1_train", "bfloat16")] if name == "lstm_fwd_embed"
              else records[("lstm_bwd_embed", "bfloat16", 0.0)]["ms"]
              if name == "lstm_bwd_embed" else records[(name, "bfloat16")]["ms"])
        print(f"  {name}: {ms:.4f} ms a step, {100 * ms / step_ms:.1f} % of "
              f"the {step_ms:.3f} ms bench step", flush=True)
    check_budget("phase 6b (the bench)")
    phase6d()
    check_budget("phase 6d (the bench from the JAX start)")
    k3_fp32_launches, k1_fp32_launches, k4_fp32_launches = phase6c()
    check_budget("phase 6c (50 fp32 training steps)")
    _, k6_fp32_launches, k2_fp32_launches, _ = phase6e(records)
    check_budget("phase 6e (a 2x512 model's fp32 steps)")
    flag_call = phase7a(records)
    check_budget("phase 7a (flagship training kernels against plain)")
    phase7b()
    check_budget("phase 7b (flagship loss and gradients)")
    flag_counts, _, fp32_tiled, flag_trainer = phase7c(flag_call, records)
    check_budget("phase 7c (flagship training steps)")
    gen_made = phase8(test, records)
    gen_launches += gen_made["bfloat16"]
    check_budget("phase 8 (generation)")
    tiled_call = phase9a(records)
    check_budget("phase 9a (tiled kernels against plain)")
    per_step_bwd, k1_per_step, k2_per_step = phase9b(records)
    check_budget("phase 9b (2x2048 loss and gradients)")
    b5_counts, _ = phase9c(tiled_call, records)
    check_budget("phase 9c (the 5b recipe)")
    phase10a(records)
    k11 = records[("10a", "bench")]
    print(f"  K11 at the bench's set: {k11['ms']:.4f} ms a call (its first call "
          f"path {k11['first_ms']:.4f}), {100 * k11['ms'] / step_ms:.2f} % of 6b's "
          f"{step_ms:.3f} ms bench step (PR 18's run: 3.245 ms)", flush=True)
    check_budget("phase 10a (fused Adagrad against plain)")
    u2_call = phase10b(records)
    check_budget("phase 10b (the two-step backward against K3)")
    u2_counts = phase10c(u2_call, records)
    check_budget("phase 10c (the bench with and without unroll 2)")
    phase10d(flag_trainer)
    del flag_trainer
    check_budget("phase 10d (crosscheck and gradcheck)")
    phase10e()
    check_budget("phase 10e (scan_chunk)")
    phase10f(test)
    check_budget("phase 10f (the ensemble)")
    phase11a(records)
    check_budget("phase 11a (the TP kernels against plain)")
    runs11b = phase11b(records)
    seq_counts = runs11b["tp seq"][0]
    check_budget("phase 11b (cli train --tp 1 at the bench's configuration)")
    seq_f32_counts = phase11d(records)
    check_budget("phase 11d (cli train --tp 1 --dtype float32)")
    flag_tp_counts, k13_fp32, k13_core, k14_fp32 = phase11c(records)
    check_budget("phase 11c (the flagship at --tp 1)")
    phase12(runs11b)
    check_budget("phase 12 (cli train --dp 1, --dp 1 --tp 1, gradcheck under --tp 1)")
    phase13k()
    check_budget("phase 13k (the kernels at a chunk's rows)")
    phase13a(runs11b)
    check_budget("phase 13a, 13b (cli train --sp 1, --dp 1 --sp 1)")
    phase13c()
    check_budget("phase 13c (--sp 1 --tp 1)")
    phase13d()
    check_budget("phase 13 (sequence pipelining at D = 1)")
    phase14k(records)
    pp_adagrad = phase14ab(runs11b)
    check_budget("phase 14k, 14a, 14b (K11 on PP's sets, --pp 1, --dp 1 --pp 1)")
    phase14c()
    check_budget("phase 14 (pipeline parallelism at S = 1)")
    x_counts = phase15(records, smi)
    check_budget("phase 15 (K15/K16's exchange at D > 1 on one card)")
    from eigen_lstm_tpu_torch.ops import cuda_adagrad

    if cuda_adagrad.adagrad_update_first.launches != K11_CONTROL[0]:
        fail(f"K11's first call path launched "
             f"{cuda_adagrad.adagrad_update_first.launches} times, "
             f"{K11_CONTROL[0]} of them in the forced control")
    kernels = []

    def add(rec, launches, **kw):
        kernels.append(dict({key: rec[key] for key in KERNEL_KEYS},
                            launches=launches, **kw))

    # K1 and K2 on the flagship's eval path (phase 3): K2 in both designs,
    # the persistent one and the per-step one forced
    for name, count in (("lstm_fwd_embed", emb), ("lstm_fwd_scan", scan),
                        ("lstm_fwd_scan_per_step", scan_step),
                        ("head_fwd", counts["head_fwd"]),
                        ("head_bwd", counts["head_bwd"])):
        add(records[(name, "bfloat16")], count)
    # K1's fp32 persistent design on 6c's fp32 steps (timed at 5's bench
    # shapes) and on 3's fp32 cli eval; its per-step design, which N = 2048
    # keeps, on 9b's fp32 window (timed forced at 2's eval shapes)
    add(records[("5", "lstm_fwd_embed", "float32", 0.0)],
        k1_fp32_launches + k1_cli_eval, name="lstm_fwd_embed_fp32")
    add(records[("lstm_fwd_embed_per_step", "float32")], k1_per_step,
        name="lstm_fwd_embed_per_step")
    # K2's fp32 persistent design on 6e's 2x512 fp32 steps (timed at 6e's
    # layer shapes); its per-step design, which N = 2048 keeps, on 9b's fp32
    # window (timed forced at 2's eval shapes)
    add(records[("6e", "lstm_fwd_scan")], k2_fp32_launches, name="lstm_fwd_scan_fp32")
    add(records[("lstm_fwd_scan_per_step", "float32")], k2_per_step,
        name="lstm_fwd_scan_per_step_fp32")
    # K4's CUDA-core design, which fp32 takes, on 6c's fp32 steps
    add(records[("head_fwd", "float32")], k4_fp32_launches,
        name="head_fwd_cuda_core")
    # K3 in its three designs: the persistent one on the bench (6b, bf16),
    # the fp32 persistent one on its fp32 steps (6c), the per-step one on
    # 9b's fp32 window (N = 2048), held and timed at 9b's shapes
    add(records[("lstm_bwd_embed", "bfloat16", 0.0)], counts["lstm_bwd_embed"])
    add(records[("lstm_bwd_embed", "float32", 0.0)], k3_fp32_launches,
        name="lstm_bwd_embed_fp32")
    add(records[("9b", "lstm_bwd_embed")], per_step_bwd[0],
        name="lstm_bwd_embed_per_step")
    # K6 likewise: the persistent one on the flagship (7c, bf16), the fp32
    # persistent one on 6e's 2x512 steps (timed on 6e's layer 1), the
    # per-step one on 9b's fp32 window, held and timed at 9b's shapes
    add(records[("7a", "lstm_bwd_scan", "bfloat16", FLAG_DROP)],
        flag_counts["lstm_bwd_scan"])
    add(records[("6e", "lstm_bwd_scan")], k6_fp32_launches,
        name="lstm_bwd_scan_fp32")
    add(records[("9b", "lstm_bwd_scan")], per_step_bwd[1],
        name="lstm_bwd_scan_per_step")
    # K7: the bf16 persistent design on phase 4's sample_text and 8's bf16
    # sample_ids and cli sample; the fp32 one on 8's cli sample at its
    # defaults and fp32 sample_ids; the first design on 8's sample_ids at
    # B = 256, which the plan refuses (timed forced at fp32 B = 128)
    add(records[("gen", "bfloat16", 1)], gen_launches)
    add(records[("gen", "float32", 1)], gen_made["float32"])
    add(records[("gen_first", "float32", 128)], gen_made["first"])
    # K8 and K10 on the 5b path (9c), K9 on the flagship's fp32 steps (7c)
    for name, count in (("tiled_fwd_embed", b5_counts["tiled_fwd_embed"]),
                        ("tiled_fwd_scan", fp32_tiled["tiled_fwd_scan"]),
                        ("tiled_bwd", b5_counts["tiled_bwd"])):
        add(records[("9a", name, "bfloat16", 0.0)], count)
    # K8's, K9's and K10's fp32 persistent designs on the flagship's fp32
    # steps (7c)
    for name in TILED:
        add(records[("9a", name, "float32", 0.0)], fp32_tiled[name],
            name=f"{name}_fp32")
    # K11 and K12 on the documented unroll-2 run (10c): the bench's set and
    # its B = 64 shapes; K11 on the bench's stage-stacked set once a step of
    # phase 14's --pp 1 runs
    add(records[("10a", "bench")], u2_counts["adagrad"])
    add(records[("14k", "bench")], pp_adagrad, name="adagrad_pp")
    add(records[("10b", 64, "bfloat16", 0.0)],
        u2_counts["lstm_bwd_embed_unroll2"])
    # K13 and K14's fused step on the flagship's --tp 1 run (11c) at its
    # shapes (D = 1); K15 and K16 on the bench's --tp 1 run (11b) at its
    # shapes
    add(records[("11a", "tp_step_fwd", "bfloat16", 1)], flag_tp_counts["tp_step_fwd"])
    add(records[("11a", "tp_step_bwd_dh", "bfloat16", 1)], flag_tp_counts["tp_step_bwd_dh"])
    # K14's gate backward alone (its first design, the product outside):
    # in bf16 the launches that run gave it, none where the plan takes the
    # fused step (refused shapes and the forced control in 11a run it); in
    # fp32, the design the plan takes, on 11c's fp32 window
    add(records[("11a", "tp_step_bwd", "bfloat16", 1)],
        flag_tp_counts["tp_step_bwd"] - flag_tp_counts["tp_step_bwd_dh"])
    add(records[("11a", "tp_step_bwd", "float32", 1)], k14_fp32, name="tp_step_bwd_fp32")
    # K13's fp32 step on 11c's fp32 window, and its CUDA-core design, which
    # refused shapes keep, on the same window forced (both timed in 11a)
    add(records[("11a", "tp_step_fwd", "float32", 1)], k13_fp32,
        name="tp_step_fwd_fp32")
    add(records[("11a", "tp_step_fwd_core", "float32", 1)], k13_core,
        name="tp_step_fwd_cuda_core")
    for name in ("tp_seq_fwd", "tp_seq_bwd"):
        add(records[("11a", name, "bfloat16")], seq_counts[name])
    # K15's and K16's fp32 persistent designs on the fp32 --tp 1 run (11d),
    # timed in 11a
    for name in ("tp_seq_fwd", "tp_seq_bwd"):
        add(records[("11a", name, "float32")], seq_f32_counts[name], name=f"{name}_fp32")
    # K15 and K16 at D ranks: one D-rank window on the one card (phase 15)
    # at the bench's shapes, D = 2, in each persistent design; the
    # cooperative one's launches on a window of 136 rows, which no
    # persistent plan takes, its time at the bench's in fp32 (forced)
    for name in ("tp_seq_fwd_ranks", "tp_seq_bwd_ranks"):
        add(records[("15", name, "bench", "bfloat16", 2)], x_counts[name])
        add(records[("15", name, "bench", "float32", 2)], x_counts[name + "_fp32"],
            name=f"{name}_fp32")
        add(records[("15", name + "_x", "bench", "float32", 2)], x_counts[name + "_x"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _cli_bpc(argv, steps=TP_STEPS):
    """train_bpc of ``_tp_run(argv, steps)``, its TP group closed."""
    trainer = None
    try:
        *_, bpc, _, trainer = _tp_run(argv, steps)
    finally:
        if trainer is not None and trainer.tp is not None:
            trainer.tp.group.close()
    return bpc


def gate_spread():
    """``python3 chip_smoke.py --gate-spread``: the gates that stand near
    their noise read with K1 and K15 in three sum orders, their other
    design forced (K1 per-step, K15 cooperative), the persistent design
    with every batch row in a block, and split (the main path's): phase
    3's flagship bits against the JAX package's, 7b's bf16 gradients over
    their controls (gate 2), 11b's train_bpc of ``--tp 1`` (K15) and of the
    per-step TP family (K13/K14, once, TP_STEP_STEPS steps) against the
    single device's over as many steps (K1; gate 0.05). Each gate applies as in the main run; the spread over the
    orders is printed."""
    import os

    from eigen_lstm_tpu_torch.data.corpus import rawread, split

    phase0()
    phase1()
    test = split(rawread(CORPUS), 0.95)[1]
    os.environ["EIGEN_LSTM_TP_SEQ"] = "0"
    try:
        tp_step = _cli_bpc(_argv_with(TP_ARGV, superstep=TP_STEP_SUPERSTEP)
                           + ["--tp", "1"], TP_STEP_STEPS)
    finally:
        del os.environ["EIGEN_LSTM_TP_SEQ"]
    rows = {}
    for order, force in (("other design", lambda: per_step_tiled(SPLIT_PLAN)),
                         ("unsplit", unsplit_fwd),
                         ("split", contextlib.nullcontext)):
        with force():
            bpc = eval_check(FLAGSHIP, flagship_cfg("bfloat16"), test,
                             f"flagship 3x1024 bf16 ({order})")[2]
            ratios = phase7b()
            single = _cli_bpc(TP_ARGV)
            short = _cli_bpc(_argv_with(TP_ARGV, superstep=TP_STEP_SUPERSTEP),
                             TP_STEP_STEPS)
            tp_seq = _cli_bpc(TP_ARGV + ["--tp", "1"])
        rows[order] = dict(
            bits=bpc, rel_jax=abs(bpc - JAX_BPC[FLAGSHIP]) / JAX_BPC[FLAGSHIP],
            ratio_max=max(ratios.values()), single=single, tp_seq=tp_seq,
            gap_seq=abs(tp_seq - single), gap_step=abs(tp_step - short))
        print(f"  gate spread, K1/K15 {order}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in rows[order].items())
            + "; 7b: " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()),
            flush=True)
        if rows[order]["gap_seq"] > TP_BPC_TOL or rows[order]["gap_step"] > TP_BPC_TOL:
            fail(f"gate spread ({order}): 11b's gap past {TP_BPC_TOL:g}")
    print(f"  gate spread: the per-step TP family's train_bpc {tp_step:.6g}; "
          "over the three orders: " + ", ".join(
              f"{k} {min(r[k] for r in rows.values()):.6g} to "
              f"{max(r[k] for r in rows.values()):.6g}" for k in rows["split"]),
          flush=True)
    print(json.dumps({"gate_spread": rows}), flush=True)


# --sp-spread: the flagship windows of 13d's study, the seeds of 13d, 7b and
# one more; a stream is "wild" where the plain bf16 path carries the top
# layer's h more than SPREAD_WILD from fp32
SPREAD_SEEDS, SPREAD_WILD = (13, 8, 21), 0.1


def sp_spread():
    """``python3 chip_smoke.py --sp-spread``: 13d's bf16 reading against
    the fp32 whole batch on SPREAD_SEEDS' flagship windows (dropout 0),
    each as drawn and with its wild streams replaced by calm ones: every
    gradient over the plain path's drift (7b's rule) for the plain path
    (whole and in 4 chunks), the kernels (whole, in chunks, SP) and the
    chunks with K1 per-step or unsplit, K2 per-step, K3 and K6 per-step
    forced; each chunk's worst reading against fp32 on its own rows; the
    top layer's h per stream. First, layer 0's h on the first 32 rows
    from a 128-row and from a 32-row call of K1, and of its per-step
    design. Prints only; gates nothing."""
    import dataclasses

    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.parallel.sp import sp_loss_and_grads
    from eigen_lstm_tpu_torch.train.checkpoint import load_checkpoint
    from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

    phase0()
    phase1()
    b, c_ = FLAG_B, SP_FLAG_CHUNKS
    rows = b // c_
    cut = lambda a, lo, n: (a[..., lo:lo + n, :] if a.dim() == 3
                            else a[:, lo:lo + n]).contiguous()
    cfgs = {d: dataclasses.replace(flag_train_cfg(d), dropout=0.0)
            for d in ("float32", "bfloat16")}
    state = {}
    for d, cfg in cfgs.items():
        params, _, _, extras = load_checkpoint(FLAGSHIP, cfg, DEVICE)
        state[d] = (params, extras["stream_h"][:, :b].contiguous(),
                    extras["stream_c"][:, :b].contiguous())
    fns = {(d, k): select_cell_fn(k, cfgs[d], b, DEVICE)
           for d in cfgs for k in ("cuda", "plain")}
    params16, h_all, c_all = state["bfloat16"]
    x, _ = bible_window(torch.Generator().manual_seed(SPREAD_SEEDS[0]),
                        FLAG_S, b)
    for label, force in (("split", contextlib.nullcontext()),
                         ("per-step", per_step_tiled(SPLIT_PLAN))):
        with force:
            whole, part = (cuda_cell.embed_layer0(
                params16.layers[0], cut(x, 0, n), cut(h_all, 0, n)[0],
                cut(c_all, 0, n)[0], cfgs["bfloat16"])[0][:, :rows].float()
                for n in (b, rows))
        diff = (whole - part).abs()
        print(f"  sp spread: K1 ({label}) layer 0 h on rows 0-{rows - 1}, a "
              f"{b}-row call against a {rows}-row call: {int((diff > 0).sum())} "
              f"of {diff.numel()} differ, max {float(diff.max()):.3e}",
              flush=True)

    def run(d, k, x, t, h, c, chunks=1):
        """(mean gradients, each chunk's gradients, top h) of ``chunks``
        one-device calls through fns[(d, k)]."""
        params = state[d][0]
        n = b // chunks
        parts, tops = [], []
        for j in range(chunks):
            a = [cut(v, j * n, n) for v in (x, t, h, c)]
            g = loss_and_grads(params, *a, cfgs[d], fns[(d, k)])[3]
            parts.append({key: v.detach().clone() for key, v in g.named_tensors()})
            tops.append(top_h(params, a[0], a[2], a[3], cfgs[d], fns[(d, k)]))
        return ({key: sum(p[key] for p in parts) / chunks for key in parts[0]},
                parts, torch.cat(tops, dim=1))

    forced = (("K1 per-step", lambda: per_step_tiled(SPLIT_PLAN)),
              ("K1 unsplit", unsplit_fwd), ("K2 per-step", per_step_tiled),
              ("K3, K6 per-step", per_step_k6))
    for seed in SPREAD_SEEDS:
        x0, t0 = bible_window(torch.Generator().manual_seed(seed), FLAG_S, b)
        h0, c0 = state["float32"][1:]
        wild_top = top_h(state["float32"][0], x0, h0, c0, cfgs["float32"],
                         fns[("float32", "cuda")])
        wild_d = (top_h(params16, x0, h0, c0, cfgs["bfloat16"],
                        fns[("bfloat16", "plain")]) - wild_top).abs().amax(dim=(0, 2))
        wild = [int(i) for i in (wild_d > SPREAD_WILD).nonzero().flatten()]
        calm = [i for i in range(b) if i not in wild]
        for replaced in (False, True):
            x, t, h, c = x0, t0, h0, c0
            if replaced:
                idx = torch.arange(b)
                for k, i in enumerate(wild):
                    idx[i] = calm[(7 * k + 3) % len(calm)]
                idx = idx.to(x.device)
                x, t, h, c = (v[..., idx, :].contiguous() if v.dim() == 3
                              else v[:, idx].contiguous() for v in (x, t, h, c))
            g32, g32_parts, top32 = run("float32", "cuda", x, t, h, c, c_)
            top32 = top_h(state["float32"][0], x, h, c, cfgs["float32"],
                          fns[("float32", "cuda")])
            reads = {"plain whole": run("bfloat16", "plain", x, t, h, c),
                     "plain chunks": run("bfloat16", "plain", x, t, h, c, c_),
                     "kernels whole": run("bfloat16", "cuda", x, t, h, c),
                     "kernels chunks": run("bfloat16", "cuda", x, t, h, c, c_)}
            sp = sp_loss_and_grads(params16, x, t, h, c, cfgs["bfloat16"], c_,
                                   None, fns[("bfloat16", "cuda")])[3]
            reads["SP"] = ({k: v.detach().clone() for k, v in sp.named_tensors()},
                           None, reads["kernels chunks"][2])
            for label, force in forced:
                with force():
                    reads[f"chunks, {label}"] = run("bfloat16", "cuda", x, t, h,
                                                    c, c_)
            g_whole = run("float32", "cuda", x, t, h, c)[0]
            drift = {k: norm_err(v, g_whole[k])
                     for k, v in reads["plain whole"][0].items()}
            print(f"  sp spread, seed {seed}"
                  + (f", {len(wild)} wild streams replaced" if replaced else
                     f", wild streams {wild}") + ": over the drift, worst "
                  "(gradient); each chunk's worst against fp32 on its rows; "
                  "the top layer's h per stream, median and past 0.1",
                  flush=True)
            for label, (g, parts, top) in reads.items():
                ratio = {k: norm_err(v, g_whole[k]) / drift[k] for k, v in g.items()}
                worst = max(ratio, key=ratio.get)
                dd = (top - top32).abs().amax(dim=(0, 2))
                chunks = ("" if parts is None or len(parts) == 1 else "; chunks "
                          + " ".join(f"{max(norm_err(p[k], q[k]) for k in p):.3g}"
                                     for p, q in zip(parts, g32_parts)))
                print(f"    {label}: {ratio[worst]:.2f}x ({worst[len('params.'):]})"
                      f"{chunks}; h {float(dd.median()):.4f}, "
                      f"{int((dd > 0.1).sum())}", flush=True)


def exchange_only():
    """``python3 chip_smoke.py --exchange``: phases 0, 1 and 15 alone."""
    smi = phase0()
    phase1()
    phase15({}, smi)
    check_budget("phase 15 (K15/K16's exchange at D > 1 on one card)")


def groups_only():
    """``python3 chip_smoke.py --groups``: phases 0 and 1, then K3's fp32
    persistent design at the bench's shapes with the other group width
    forced (``group_control``): what the plan's G buys."""
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    phase0()
    phase1()
    cfg = train_cfg("float32")
    s, b, n = TRAIN_S, TRAIN_B, cfg.hidden
    gen = torch.Generator().manual_seed(5)
    layer = load_params(H512, cfg, DEVICE).layers[0]
    x = bible_window(gen, s, b)[0]
    rand = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd).to(DEVICE)
    h0, c0 = rand(b, n, sd=0.1), rand(b, n, sd=0.1)
    fwd = cuda_cell.embed_layer0(layer, x, h0, c0, cfg, residuals=True)
    dh_seq = rand(s, b, n, sd=1e-3)
    dhT, dcT = rand(b, n, sd=1e-3), rand(b, n, sd=1e-3)
    group_control(layer.U, fwd, x, h0, c0, dh_seq, dhT, dcT, cfg)
    check_budget("the group-width control")


def tp_seq_only():
    """``python3 chip_smoke.py --tp-seq``: phases 0, 1, 11a, 11d and 15
    alone (K13-K16 against plain, the fp32 --tp 1 run, the D-rank
    windows)."""
    smi = phase0()
    phase1()
    records = {}
    phase11a(records)
    check_budget("phase 11a (the TP kernels against plain)")
    phase11d(records)
    check_budget("phase 11d (cli train --tp 1 --dtype float32)")
    phase15(records, smi)
    check_budget("phase 15 (K15/K16's exchange at D > 1 on one card)")


def k2_k13_only():
    """``python3 chip_smoke.py --k2-k13``: phases 0, 1, 2, 6e, 11a and 11c
    alone: K2 and K13 in both types, their designs checked, timed and
    counted."""
    from eigen_lstm_tpu_torch.data.corpus import rawread, split

    phase0()
    phase1()
    records = {}
    phase2(split(rawread(CORPUS), 0.95)[1], records)
    check_budget("phase 2 (kernels against plain)")
    phase6e(records)
    check_budget("phase 6e (a 2x512 model's fp32 steps)")
    phase11a(records)
    check_budget("phase 11a (the TP kernels against plain)")
    phase11c(records)
    check_budget("phase 11c (the flagship at --tp 1)")


def k14_only():
    """``python3 chip_smoke.py --k14``: phases 0, 1, 11a, 11b and 11c
    alone: K14 in both types, its designs checked, timed and counted."""
    phase0()
    phase1()
    records = {}
    phase11a(records)
    check_budget("phase 11a (the TP kernels against plain)")
    phase11b(records)
    check_budget("phase 11b (cli train --tp 1 at the bench's configuration)")
    phase11c(records)
    check_budget("phase 11c (the flagship at --tp 1)")


def host_us(fn, calls: int = 2000, repeats: int = 5) -> float:
    """Median over ``repeats`` of the host-clock time of ``calls`` calls of
    ``fn``, µs a call, after a synchronisation (what ``fn`` enqueues on the
    card is waited for at the end of each repeat)."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


def k11_host_parts():
    """The host's pieces of K11's wrapper call on the bench's set (1x512),
    each timed alone on the host clock (``host_us``), beside the whole call
    and other ways to make the outputs' views and read the stream: where
    the host's time of the call goes."""
    from eigen_lstm_tpu_torch import ModelConfig
    from eigen_lstm_tpu_torch.models.lstm import init_params, like, tensors
    from eigen_lstm_tpu_torch.ops import _build
    from eigen_lstm_tpu_torch.ops import cuda_adagrad as ca
    from eigen_lstm_tpu_torch.train.optimizer import adagrad_init

    params = init_params(ModelConfig(hidden=512), device=DEVICE)
    m = adagrad_init(params)
    grads = like(params, (torch.randn_like(t) * 1e-2 for t in tensors(params)))
    lr, eps = np.float32(0.02), 1e-10
    ps, gs, ms = tensors(params), tensors(grads), tensors(m)
    xs = ps + gs + ms
    plan = ca.plan_for(ps, gs, ms)
    dev = ps[0].device
    arena, arena_m = ps[0].new_empty(plan.total), ps[0].new_empty(plan.total)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan.ins[:] = [x.data_ptr() for x in xs]
    metas = [torch.empty(p.shape, device="meta") for p in ps]   # no padding here
    views = plan.views(arena)
    calls = {
        "the whole call": lambda: ca.adagrad_update_fused(params, grads, m, lr, eps),
        "the first call path's whole call": lambda: ca.adagrad_update_first(
            params, grads, m, lr, eps)}
    whole = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        whole[name].append(host_us(calls[name]))
    parts = {
        "the three tensor lists": lambda: (tensors(params), tensors(grads), tensors(m)),
        "the plan's key and lookup": lambda: ca.plan_for(ps, gs, ms),
        "the contiguity check": lambda: all(map(ca._CONTIGUOUS, xs)),
        "two arenas (new_empty)": lambda: (ps[0].new_empty(plan.total),
                                           ps[0].new_empty(plan.total)),
        "the stream (raw)": lambda: ca._stream(dev),
        "the address table filled": lambda: plan.ins.__setitem__(
            slice(None), list(map(ca._DATA_PTR, xs))),
        "the launch (ctypes call, enqueue)": lambda: lib.adagrad_plan_launch(
            plan.count, plan.ins, plan.layout, arena.data_ptr(), arena_m.data_ptr(),
            float(lr), float(eps), stream, plan.launched_ref),
        "2n views (as_strided)": lambda: (plan.views(arena), plan.views(arena)),
        "two like() calls": lambda: (like(params, views), like(m, views)),
        # the other ways, not taken
        "the stream (current_stream)": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "2n views (unflatten_dense_tensors, one call)": lambda: [
            torch._C._nn.unflatten_dense_tensors(arena, metas) for _ in range(2)],
        "the three lists through named_tensors": lambda: [
            [t for _, t in s.named_tensors()] for s in (params, grads, m)],
    }
    times = {name: host_us(fn) for name, fn in parts.items()}
    print("  K11's host pieces at the bench's set, µs a call (host clock, "
          "median of 5 x 2000 calls; the whole calls in the order plan, "
          "first, first, plan): " + "; ".join(
              f"{name} {t[0]:.2f} and {t[1]:.2f}" for name, t in whole.items())
          + "; " + "; ".join(f"{name} {t:.2f}" for name, t in times.items()),
          flush=True)


def k11_only():
    """``python3 chip_smoke.py --k11``: phases 0, 1, 10a and 14k alone: K11
    on its five parameter sets, checked and timed; then the host's pieces
    of its call (``k11_host_parts``)."""
    phase0()
    phase1()
    records = {}
    phase10a(records)
    check_budget("phase 10a (fused Adagrad against plain)")
    phase14k(records)
    check_budget("phase 14k (K11 on PP's sets)")
    k11_host_parts()
    check_budget("K11's host pieces")


def tiled_only():
    """``python3 chip_smoke.py --tiled``: phases 0, 1 and 9a alone."""
    phase0()
    phase1()
    phase9a({})
    check_budget("phase 9a (the tiled kernels against plain)")


if __name__ == "__main__":
    if sys.argv[1:] == ["--gate-spread"]:
        gate_spread()
    elif sys.argv[1:] == ["--sp-spread"]:
        sp_spread()
    elif sys.argv[1:] == ["--exchange"]:
        exchange_only()
    elif sys.argv[1:] == ["--tiled"]:
        tiled_only()
    elif sys.argv[1:] == ["--groups"]:
        groups_only()
    elif sys.argv[1:] == ["--tp-seq"]:
        tp_seq_only()
    elif sys.argv[1:] == ["--k2-k13"]:
        k2_k13_only()
    elif sys.argv[1:] == ["--k14"]:
        k14_only()
    elif sys.argv[1:] == ["--k11"]:
        k11_only()
    elif sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}; the options are --gate-spread, "
             f"--sp-spread, --exchange, --tiled, --groups, --tp-seq, --k2-k13, "
             f"--k14 and --k11")
    else:
        main()
