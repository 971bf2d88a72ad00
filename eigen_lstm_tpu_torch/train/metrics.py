"""Throughput instrumentation, as ``eigen_lstm_tpu/train/metrics.py``: the
analytic FLOP model, a wall-clock timer, the results table, and a meter of
chars/s, GFLOP/s and model-FLOP utilization against the H100's peak.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..config import ModelConfig

# Dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA data
# sheet): the bf16 tensor-core rate and the fp32 rate outside the tensor
# cores. A card set below 700 W runs slower; the bench prints the limit.
H100_SXM_PEAK_BF16 = 989e12
H100_SXM_PEAK_FP32 = 67e12


def lstm_flops_per_char(cfg: ModelConfig, loss_mode: Optional[str] = None) -> float:
    """Analytic forward + backward FLOPs per trained character per stream,
    the JAX package's count: per layer 2*in*4N (x @ W) and 2*N*4N (h @ U)
    forward, twice that backward, except that layer 0's input product has
    no dgrad and its forward is a gather (no FLOPs) outside ``"onehot"``;
    ~40N elementwise; the head 3 * (2*N*M + 8*M) under ``loss_mode="all"``."""
    n, m = cfg.hidden, cfg.vocab
    mode = loss_mode or cfg.loss_mode
    total = 0.0
    for l in range(cfg.num_layers):
        in_dim = m if l == 0 else n
        gemm_x = 2.0 * in_dim * 4 * n
        gemm_h = 2.0 * n * 4 * n
        if l == 0:
            x_mult = 2.0 if cfg.embedding_mode == "onehot" else 1.0
        else:
            x_mult = 3.0
        total += x_mult * gemm_x + 3.0 * gemm_h + 40.0 * n
    if mode == "all":
        total += 3.0 * (2.0 * n * m + 8.0 * m)
    return total


def param_count(cfg: ModelConfig) -> int:
    n, m = cfg.hidden, cfg.vocab
    total = 0
    for l in range(cfg.num_layers):
        in_dim = m if l == 0 else n
        total += in_dim * 4 * n + n * 4 * n + 4 * n
    return total + n * m + m


def peak_flops(cfg: ModelConfig) -> float:
    """The H100 peak the compute type runs against."""
    return (H100_SXM_PEAK_BF16 if cfg.compute_dtype == "bfloat16"
            else H100_SXM_PEAK_FP32)


class Timer:
    """Wall-clock stopwatch."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


@dataclass
class ResultRow:
    """One eval-interval row."""

    idx: int
    step: int
    chars_trained: int
    wall_s: float
    train_bpc: float
    test_bpc: float
    gflops: float
    chars_per_sec: float
    mfu: float


@dataclass
class ResultsTable:
    """One row per eval, appended to a JSONL file when ``path`` is set."""

    path: Optional[str] = None
    rows: List[ResultRow] = field(default_factory=list)

    def append(self, row: ResultRow):
        self.rows.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row.__dict__) + "\n")

    def last(self) -> Optional[ResultRow]:
        return self.rows[-1] if self.rows else None


@dataclass
class ThroughputMeter:
    """chars/s, analytic GFLOP/s and MFU against the H100 peak of the
    compute type. On a device other than the card the MFU is NaN: the
    H100's peak says nothing of a CPU run."""

    cfg: ModelConfig
    device_type: str = "cuda"

    def rates(self, chars: int, seconds: float):
        cps = chars / max(seconds, 1e-9)
        flops = cps * lstm_flops_per_char(self.cfg)
        mfu = (flops / peak_flops(self.cfg) if self.device_type == "cuda"
               else float("nan"))
        return cps, flops / 1e9, mfu
