"""Training throughput benchmark of the port: ``python -m
eigen_lstm_tpu_torch.bench`` prints one JSON line with the keys of
``eigen_lstm_tpu/bench.py``, measured on the card.

With no arguments it runs the configuration of the repository's root
``bench.py``: one layer, hidden 512, batch 128, window 100, bf16 compute,
Adagrad at lr 0.02 after 20 warm-up steps, supersteps of 50, windows
streamed from the host over ``data/enwik6.txt``; 300 warm-up steps, then
3000 timed steps in 5 windows whose median gives ``value``. Arguments are
those of ``cli.py bench`` and replace the defaults.

``vs_baseline`` divides by the reference's single-core Eigen+BLAS rate
(4.0 GFLOP/s over the one-hot FLOP count, as the JAX bench does); ``mfu``
is against the H100 peak of the compute type (``train/metrics.py``), and
null for a run that is not on the card.
``train_bpc`` is the mean bits/char of the last superstep and must fall in
``BPC_BAND``, the root bench's: a silent math fault that keeps the
throughput shows as ~8 bits/char or a non-finite value. The port's runs on
the H100 end below that band (PERF.md, Findings), so the bench reports
``train_bpc_ok`` false there and exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Any, Dict, Optional

import torch

EIGEN_BLAS_GFLOPS = 4.0   # the reference's single-core rate
# The root bench.py's band: +-0.15 around the JAX package's deterministic
# train_bpc of this configuration on its TPU (2.5572, BENCH_r04/r05.json).
BPC_BAND = (2.40, 2.70)
BENCH_WINDOWS = 5           # timed windows; ``value`` is their median
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ARGV = [
    "bench", "--data", os.path.join(_ROOT, "data", "enwik6.txt"),
    "--hidden", "512", "--batch", "128", "--seq", "100",
    "--dtype", "bfloat16", "--train-percent", "1.0", "--superstep", "50",
    "--bench-steps", "3000", "--warmup-steps", "300", "--lr", "0.02",
    "--warmup", "20", "--stream-data",
]


def schedule(args):
    """(warm-up supersteps, timed windows, supersteps per window) of a
    bench run, as the JAX bench rounds them."""
    superstep = args.superstep
    return (max(1, args.warmup_steps // superstep), BENCH_WINDOWS,
            max(1, args.bench_steps // superstep // BENCH_WINDOWS))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_trainer(args):
    """The bench's ``Trainer`` for the ``bench`` namespace of ``cli.py``."""
    from .cli import _configs
    from .data import corpus as corpus_mod
    from .data import streaming as streaming_mod
    from .ops.dispatch import select_cell_fn
    from .train.trainer import Trainer

    mcfg, dcfg, tcfg = _configs(args)
    device = torch.device(args.device)
    if args.stream_data:
        train, _ = corpus_mod.split(streaming_mod.load_corpus_mmap(dcfg.path),
                                    dcfg.train_percent)
    else:
        train, _ = corpus_mod.load_dataset(dcfg)
    cell_fn = select_cell_fn(args.backend, mcfg, dcfg.batch, device)
    return Trainer(mcfg, dcfg, tcfg, train, None, cell_fn=cell_fn,
                   streaming=bool(args.stream_data), device=device)


def run_benchmark(args) -> Dict[str, Any]:
    """Warm-up supersteps, then ``BENCH_WINDOWS`` timed windows of
    supersteps, each closed by a device synchronise; returns the result
    dict. ``args`` is the ``bench`` namespace of ``cli.py``."""
    from .train import metrics as metrics_mod

    trainer = make_trainer(args)
    mcfg, dcfg, device = trainer.mcfg, trainer.dcfg, trainer.device
    warmup, n_windows, steps = schedule(args)
    for _ in range(warmup):
        trainer.state, metrics = trainer.dispatch_superstep()
    _sync(device)
    window_cps = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.state, metrics = trainer.dispatch_superstep()
        _sync(device)
        dt = time.perf_counter() - t0
        window_cps.append(steps * trainer.chars_per_superstep() / dt)
    cps = statistics.median(window_cps)
    fpc = metrics_mod.lstm_flops_per_char(mcfg)
    fpc_ref = metrics_mod.lstm_flops_per_char(
        dataclasses.replace(mcfg, embedding_mode="onehot"))
    baseline_cps = EIGEN_BLAS_GFLOPS * 1e9 / fpc_ref
    train_bpc = float(metrics["bits_mean"])
    lo, hi = BPC_BAND
    bpc_ok = bool(train_bpc == train_bpc and lo <= train_bpc <= hi)
    return {
        "metric": f"train_chars_per_sec H={mcfg.hidden} B={dcfg.batch} "
                  f"S={dcfg.seq} {mcfg.compute_dtype}",
        "value": round(cps, 1),
        "unit": "chars/sec/chip",
        "vs_baseline": round(cps / baseline_cps, 2),
        "gflops": round(cps * fpc / 1e9, 1),
        # the H100's peak says nothing of a run elsewhere
        "mfu": (round(cps * fpc / metrics_mod.peak_flops(mcfg), 4)
                if device.type == "cuda" else None),
        "train_bpc": round(train_bpc, 4),
        "train_bpc_ok": bpc_ok,
        "windows_mchars_per_sec": [round(w / 1e6, 2) for w in window_cps],
        "platform": device.type,
    }


def main(argv: Optional[list] = None):
    """Runs the benchmark on the root bench's configuration, with ``argv``
    (``cli.py bench`` arguments) in place of the defaults where given;
    prints the JSON line and exits 1 when train_bpc is outside the band."""
    from .cli import build_parser

    extra = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(DEFAULT_ARGV + extra)
    result = run_benchmark(args)
    print(json.dumps(result), flush=True)
    if not result["train_bpc_ok"]:
        print(f"train_bpc {result['train_bpc']} outside {BPC_BAND}",
              file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
