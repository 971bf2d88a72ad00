"""Adagrad with the JAX package's extensions (``eigen_lstm_tpu/train/
optimizer.py``): global-norm clipping, lr = 0 warm-up and the cyclic decay,
in plain torch ops on ``LSTMParams``-shaped parameter sets.

m += g^2 on every step, warm-up included (the accumulators fill while
lr = 0), then p -= lr * g * rsqrt(m + eps) with eps = 1e-10 inside the
rsqrt. The functions return new tensors and leave their inputs as they
were, as the JAX functions do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..models.lstm import LayerParams, LSTMParams


def tensors(p: LSTMParams):
    """The parameter set's tensors in checkpoint order (W, U, b of each
    layer, then Why, by)."""
    return [t for _, t in p.named_tensors()]


def like(p: LSTMParams, ts) -> LSTMParams:
    """An ``LSTMParams`` with ``p``'s structure holding ``ts`` in the order
    of ``tensors``."""
    ts = list(ts)
    layers = tuple(LayerParams(*ts[3 * i: 3 * i + 3])
                   for i in range(len(p.layers)))
    return LSTMParams(layers, ts[-2], ts[-1])


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


def adagrad_update(params: LSTMParams, grads: LSTMParams, m: LSTMParams,
                   lr, eps: float = 1e-10) -> Tuple[LSTMParams, LSTMParams]:
    """One Adagrad step: (new params, new accumulators)."""
    f32 = torch.float32
    new_m, new_p = [], []
    for p, g, mm in zip(tensors(params), tensors(grads), tensors(m)):
        g32 = g.to(f32)
        m2 = mm.to(f32) + torch.square(g32)
        new_m.append(m2.to(mm.dtype))
        step = float(lr) * g32 * torch.rsqrt(new_m[-1].to(f32) + eps)
        new_p.append((p.to(f32) - step).to(p.dtype))
    return like(params, new_p), like(m, new_m)


def apply_updates(params: LSTMParams, grads: LSTMParams, m: LSTMParams,
                  step: int, cfg: TrainConfig
                  ) -> Tuple[LSTMParams, LSTMParams, torch.Tensor]:
    """Clip, then the scheduled lr, then Adagrad: (params, m, grad norm)."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    lr = schedule_lr(cfg, step)
    params, m = adagrad_update(params, grads, m, lr, cfg.adagrad_eps)
    return params, m, gnorm
