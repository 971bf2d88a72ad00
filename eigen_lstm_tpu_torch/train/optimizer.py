"""Adagrad with the JAX package's extensions (``eigen_lstm_tpu/train/
optimizer.py``): global-norm clipping, lr = 0 warm-up and the cyclic decay,
on ``LSTMParams``-shaped parameter sets.

m += g^2 on every step, warm-up included (the accumulators fill while
lr = 0), then p -= lr * g * rsqrt(m + eps) with eps = 1e-10 inside the
rsqrt: on the card one launch of the fused kernel K11 for the whole set
(``ops/cuda_adagrad.py``), on the CPU its plain version. Clipping and the
global norm stay torch ops, as the JAX package leaves them to XLA. The
functions return new tensors and leave their inputs as they were, as the
JAX functions do.

Under tensor parallelism (``group``) each rank updates its own shards, and
the global norm sums the ranks' squared sums over the group, with the
tensors that ``replicated`` marks (by, which every rank holds whole)
counted once: their squared sum is divided by the axis size first
(``eigen_lstm_tpu/train/optimizer.py:36-60``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..models.lstm import LSTMParams, like, tensors
from ..ops.cuda_adagrad import adagrad_update_fused
from ..parallel import mesh


def adagrad_init(params: LSTMParams) -> LSTMParams:
    """Zero accumulators, one per tensor."""
    return like(params, (torch.zeros_like(t) for t in tensors(params)))


def global_norm(grads: LSTMParams, group: Optional[mesh.TPGroup] = None,
                replicated: Optional[LSTMParams] = None) -> torch.Tensor:
    """L2 norm over every tensor, in fp32; with ``group`` over every rank's
    shards, the ``replicated`` tensors counted once."""
    leaves = tensors(grads)
    rep = (tensors(replicated) if group is not None and replicated is not None
           else [False] * len(leaves))
    sqs = (torch.sum(torch.square(g.to(torch.float32))) for g in leaves)
    sq = sum(s / group.size if r else s for s, r in zip(sqs, rep))
    return torch.sqrt(mesh.all_reduce(sq, group))


def clip_by_global_norm(grads: LSTMParams, max_norm: float,
                        group: Optional[mesh.TPGroup] = None,
                        replicated: Optional[LSTMParams] = None
                        ) -> Tuple[LSTMParams, torch.Tensor]:
    """Grads scaled so that their global norm is at most ``max_norm``."""
    gnorm = global_norm(grads, group, replicated)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-20), max=1.0)
    return like(grads, (g * scale.to(g.dtype) for g in tensors(grads))), gnorm


def warmup_lr(lr: float, step: int, warmup_steps: int) -> np.float32:
    """lr = 0 during warm-up, then ``lr``."""
    if warmup_steps > 0 and step < warmup_steps:
        return np.float32(0.0)
    return np.float32(lr)


def schedule_lr(cfg: TrainConfig, step: int) -> np.float32:
    """Warm-up, then (``lr_cycle_steps > 0``) a linear decay from lr to
    lr * lr_cycle_min_frac within each cycle, in fp32 as the JAX package
    computes it. ``step`` is a host integer: the port counts steps on the
    host."""
    lr = warmup_lr(cfg.lr, step, cfg.warmup_steps)
    if cfg.lr_cycle_steps > 0:
        t = (np.float32(max(step - cfg.warmup_steps, 0) % cfg.lr_cycle_steps)
             / np.float32(cfg.lr_cycle_steps))
        frac = np.float32(1.0) - np.float32(1.0 - cfg.lr_cycle_min_frac) * t
        lr = np.float32(lr * frac)
    return lr


def apply_updates(params: LSTMParams, grads: LSTMParams, m: LSTMParams,
                  step: int, cfg: TrainConfig,
                  group: Optional[mesh.TPGroup] = None,
                  replicated: Optional[LSTMParams] = None
                  ) -> Tuple[LSTMParams, LSTMParams, torch.Tensor]:
    """Clip, then the scheduled lr, then Adagrad (``adagrad_update_fused``):
    (params, m, grad norm). ``group``, ``replicated``: as ``global_norm``."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, group,
                                           replicated)
    else:
        gnorm = global_norm(grads, group, replicated)
    lr = schedule_lr(cfg, step)
    params, m = adagrad_update_fused(params, grads, m, lr, cfg.adagrad_eps)
    return params, m, gnorm
