#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (``python3 chip_smoke.py``
from the root of the repository).

Phase 0  requires a CUDA device; prints the card's name and power limit.
Phase 1  builds the kernels (one nvcc call) and prints its seconds.
Phase 2  runs each kernel against its plain PyTorch version on the card, at
         the eval path's shapes (N = 1024, M = 256, B = 16, S = 128) with the
         flagship's weights, in bf16 and fp32: every step of the window
         replayed by the plain version, the whole window, and the bf16
         residual type; prints errors, times, bounds and the cuDNN LSTM's
         time as a yardstick.
Phase 3  the path: held-out bits/char of the 3x1024 flagship (bf16) through
         the kernels, with the launch counts reset before and read after;
         then kernel against plain on a 4096-byte slice; the same for the
         1x512 checkpoint.
Phase 4  greedy and T = 0.7 samples from the flagship on the card.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Nothing
of JAX is imported. The build goes to ``eigen_lstm_tpu_torch/_build/``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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


def bound(kind, cfg, s, b, n, m):
    """Least time of one call's work on the card, ms: max(bytes / HBM rate,
    flops / peak rate for the compute type). bytes = U once + (W, b and
    the ids for layer 0 | the xw stream for layers >= 1) + h0, c0 + the
    outputs (h_seq in the residual type, hT and cT in fp32); flops =
    2 S B N 4N for the recurrent products."""
    csz = torch.finfo(cfg.cdtype).bits // 8
    rsz = torch.finfo(cfg.rdtype).bits // 8
    nbytes = n * 4 * n * csz + 4 * b * n * 4 + s * b * n * rsz
    if kind == "embed":
        nbytes += m * 4 * n * csz + 4 * n * 4 + s * b * 4
    else:
        nbytes += s * b * 4 * n * csz
    flops = 2 * s * b * n * 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[cfg.cdtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def check_bf16_residuals(name, dtype, kern, layer, seq, h0, c0, out_k):
    """The bf16-residual instantiations: the carry stays fp32 whatever the
    residual type, so every output must be the fp32-residual run's own,
    rounded once to bf16, bit for bit."""
    out_r = _named(kern(layer, seq, h0, c0, flagship_cfg(dtype, "bfloat16"),
                        residuals=True))
    for label in OUTPUTS:
        want = out_k[label].to(torch.bfloat16).float()
        if label.endswith("_seq") and out_r[label].dtype != torch.bfloat16:
            fail(f"{name} {dtype} bf16 residuals {label}: {out_r[label].dtype}")
        if not torch.equal(out_r[label].float(), want):
            err = max_err(out_r[label], want)[0]
            fail(f"{name} {dtype} bf16 residuals {label}: not the fp32 run "
                 f"rounded to bf16 (max abs {err:.3e})")
    print(f"  {name} {dtype}: bf16 residuals equal the fp32 run rounded to "
          f"bf16 on every output", flush=True)


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
            out_k = _named(kern(layer, seq, h0, c0, cfg, residuals=True))
            out_p = _named(plain(layer, seq, h0, c0, cfg, residuals=True))
            torch.cuda.synchronize()
            for label in OUTPUTS:
                if not torch.isfinite(out_k[label].float()).all():
                    fail(f"{name} {dtype} {label}: non-finite values")
            step_err = 0.0
            replay = replay_steps(plain, layer, seq, h0, c0, cfg, out_k)
            for label, ref in replay.items():
                err = max_err(out_k[label], ref)[0]
                step_err = max(step_err, err)
                if err > STEP_ATOL:
                    fail(f"{name} {dtype} {label}: a step of the window is "
                         f"{err:.3e} from its plain replay > {STEP_ATOL:g}")
            print(f"  {name} {dtype}: all {s} steps of the window within "
                  f"{step_err:.3e} of their plain replay (atol {STEP_ATOL:g})",
                  flush=True)
            if dtype == "float32":
                plain_f32[name] = out_p
            for label in OUTPUTS:
                abs_e, rel_e = max_err(out_k[label], out_p[label])
                if cfg.cdtype == torch.float32:
                    print(f"  {name} {dtype} window {label}: max abs {abs_e:.3e} "
                          f"max rel {rel_e:.3e} (atol {WINDOW_ATOL_F32:g})",
                          flush=True)
                    if abs_e > WINDOW_ATOL_F32:
                        fail(f"{name} {dtype} window {label}: {abs_e:.3e} > "
                             f"{WINDOW_ATOL_F32:g}")
                else:
                    drift = max_err(out_p[label], plain_f32[name][label])[0]
                    print(f"  {name} {dtype} window {label}: max abs {abs_e:.3e} "
                          f"max rel {rel_e:.3e} (not gated; bf16 drift of the "
                          f"plain version {drift:.3e})", flush=True)
            check_bf16_residuals(name, dtype, kern, layer, seq, h0, c0, out_k)
            ms = cuda_ms(lambda: kern(layer, seq, h0, c0, cfg), reps=10)
            plain_ms = cuda_ms(lambda: plain(layer, seq, h0, c0, cfg), reps=2,
                               windows=3)
            bound_ms, bound_by = bound(kind, cfg, s, b, n, m)
            lib_ms = library_ms(in_dim, cfg, lib_x, h0, c0)
            print(f"  {name} {dtype}: {ms:.4f} ms per window per layer "
                  f"(S={s} launches), plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.5f} ms ({bound_by}), cuDNN nn.LSTM "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}",
                  flush=True)
            records[(name, dtype)] = dict(
                name=name, route="cuda",
                source="eigen_lstm_tpu_torch/csrc/lstm_fwd.cu",
                replaces=replaces, launches=None, max_abs_err=step_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms,
            )


def eval_check(path, cfg, test, label):
    """Path run at PATH_CHARS through the kernels, then kernel against
    plain on SLICE_CHARS. Returns the launch counts of the path run."""
    from eigen_lstm_tpu_torch.ops import cuda_cell
    from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu_torch.train.checkpoint import load_params
    from eigen_lstm_tpu_torch.train.evaluator import evaluate_bpc

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
    bpc_k = evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, SLICE_CHARS, kern)
    bpc_p = evaluate_bpc(params, test, cfg, EVAL_BATCH, CHUNK, SLICE_CHARS, plain)
    rel_p = abs(bpc_k - bpc_p) / bpc_p
    rel_j = abs(bpc_k - JAX_BPC[path]) / JAX_BPC[path]
    print(f"  {label} {SLICE_CHARS} chars: kernel {bpc_k:.6f} plain "
          f"{bpc_p:.6f} (rel {rel_p:.2e}), JAX on the CPU {JAX_BPC[path]} "
          f"(rel {rel_j:.2e}), rtol {BPC_RTOL:g}", flush=True)
    if rel_p > BPC_RTOL or rel_j > BPC_RTOL or bpc_k >= 3.0:
        fail(f"{label}: {SLICE_CHARS}-char bpc out of tolerance")
    return counts


def phase3(test):
    from eigen_lstm_tpu_torch import ModelConfig

    counts = eval_check(FLAGSHIP, flagship_cfg("bfloat16"), test,
                        "flagship 3x1024 bf16")
    eval_check(H512, ModelConfig(hidden=512, num_layers=1,
                                 compute_dtype="bfloat16"),
               test, "bible_h512 1x512 bf16")
    return counts


def phase4():
    from eigen_lstm_tpu_torch.models.sampler import sample_text
    from eigen_lstm_tpu_torch.train.checkpoint import load_params

    cfg = flagship_cfg("bfloat16")
    params = load_params(FLAGSHIP, cfg, DEVICE)
    for temp in (0.0, 0.7):
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        t0 = time.perf_counter()
        text = sample_text(params, cfg, gen, 200, temperature=temp)
        dt = time.perf_counter() - t0
        if len(text) != 200:
            fail(f"sample at T={temp}: {len(text)} chars, expected 200")
        print(f"  sample T={temp} ({200 / dt:.1f} chars/s): {text[:60]!r}",
              flush=True)


def main():
    phase0()
    check_budget("phase 0")
    phase1()
    check_budget("phase 1 (build)")
    from eigen_lstm_tpu_torch.data.corpus import rawread, split

    test = split(rawread(CORPUS), 0.95)[1]
    records = {}
    phase2(test, records)
    check_budget("phase 2 (kernels against plain)")
    emb, scan = phase3(test)
    check_budget("phase 3 (eval path)")
    phase4()
    check_budget("phase 4 (sampling)")
    kernels = []
    for name, count in (("lstm_fwd_embed", emb), ("lstm_fwd_scan", scan)):
        rec = dict(records[(name, "bfloat16")], launches=count)
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
