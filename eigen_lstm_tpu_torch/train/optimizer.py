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
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..models.lstm import LSTMParams, like, tensors
from ..ops.cuda_adagrad import adagrad_update_fused


def adagrad_init(params: LSTMParams) -> LSTMParams:
    """Zero accumulators, one per tensor."""
    return like(params, (torch.zeros_like(t) for t in tensors(params)))


def global_norm(grads: LSTMParams) -> torch.Tensor:
    """L2 norm over every tensor, in fp32."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tensors(grads))
    return torch.sqrt(sq)


def clip_by_global_norm(grads: LSTMParams, max_norm: float
                        ) -> Tuple[LSTMParams, torch.Tensor]:
    """Grads scaled so that their global norm is at most ``max_norm``."""
    gnorm = global_norm(grads)
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
                  step: int, cfg: TrainConfig
                  ) -> Tuple[LSTMParams, LSTMParams, torch.Tensor]:
    """Clip, then the scheduled lr, then Adagrad (``adagrad_update_fused``):
    (params, m, grad norm)."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    lr = schedule_lr(cfg, step)
    params, m = adagrad_update_fused(params, grads, m, lr, cfg.adagrad_eps)
    return params, m, gnorm
