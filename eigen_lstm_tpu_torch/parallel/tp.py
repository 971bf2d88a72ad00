"""Tensor-parallel (gate-sharded) LSTM over the model axis, the port's
``eigen_lstm_tpu/parallel/tp.py``.

The packed 4N gate axis is permuted to device-major groups [i_d o_d f_d
u_d] (each nd = N / D wide), so device d holds the gates of its own nd
hidden units and updates its c_d, h_d shard locally:

    h_full = all_gather(h_d)                  # (B, N), every step
    g_d    = xw_d + h_full @ U_d              # (B, 4nd)
    c_d, h_d = cell(g_d, c_d)
    logits = psum_d(h_d @ Why_d) + by         # row-sharded Why

W, U and b are sharded along the gate axis, Why along its rows (the hidden
units, in their canonical order), and by is replicated. Each rank is one
process. The model axis is a ``TPGroup`` of ``parallel/mesh.py`` (the
whole run under ``--tp`` alone, a row of the mesh under ``--dp --tp``),
and every collective runs on its group. The collectives are
``torch.autograd.Function`` s over ``parallel/mesh.py``, each with the JAX
transpose: the all-gather's backward reduce-scatters (sums) the
cotangent; the psum's backward is the
identity, since every rank already holds the same cotangent
(``torch.distributed.nn.functional.all_reduce`` would all-reduce it again
and multiply it by D, which no D = 1 run can show). At D = 1 they still go
through the group.

The recurrence of a layer runs one of three families (``_tp_scan_layer``,
picked by ``ops.dispatch.select_tp_backend`` as the JAX trainer picks
it): ``"xla"``, the JAX XLA scan in torch ops (the port's oracle, any
device); ``"pallas"``, the per-step kernels K13/K14
(``ops/cuda_tp_cell.py``); ``"pallas_seq"``, the whole-window kernels
K15/K16 (``ops/cuda_tp_seq.py``). With ``plain`` the kernel families run
their plain versions on any device. Dropout masks the all-gathered full
stream with the model's own ``_dropout`` and a rank-invariant seed, so
every shard draws the same mask, the mask of the single-device loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models import lstm as model
from ..ops import cell as cell_ops
from ..ops import cuda_tp_cell, cuda_tp_seq
from . import mesh


class _AllGather(torch.autograd.Function):
    """all_gather(x, dim, tiled) whose backward reduce-scatters (sums)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return mesh.all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return mesh.reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Psum(torch.autograd.Function):
    """psum(x) whose backward is the identity (the JAX transpose of a psum
    whose result is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return mesh.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x, dim: int, group: Optional[mesh.TPGroup]):
    return _AllGather.apply(x, dim, group)


def psum(x, group: Optional[mesh.TPGroup]):
    return _Psum.apply(x, group)


# --- layout ------------------------------------------------------------------


def _gate_permutation(n: int, ndev: int) -> np.ndarray:
    """Permutation of the packed 4N gate axis from gate-major [i|o|f|u]
    (each N) to device-major [[i_d o_d f_d u_d] for d] (each 4 * N/ndev)."""
    nd = n // ndev
    cols = []
    for d in range(ndev):
        for gate in range(4):
            start = gate * n + d * nd
            cols.append(np.arange(start, start + nd))
    return np.concatenate(cols)


def _permute_layers(params: model.LSTMParams, ndev: int, inverse: bool):
    layers = []
    for layer in params.layers:
        n = layer.U.shape[0]
        if n % ndev != 0:
            raise ValueError(f"hidden {n} not divisible by {ndev} TP devices")
        perm = _gate_permutation(n, ndev)
        idx = torch.as_tensor(np.argsort(perm) if inverse else perm,
                              device=layer.U.device)
        layers.append(model.LayerParams(W=layer.W[:, idx], U=layer.U[:, idx],
                                        b=layer.b[idx]))
    # Why rows follow the hidden units, whose order no permutation touches
    return model.LSTMParams(tuple(layers), params.Why, params.by)


def permute_params_for_tp(params: model.LSTMParams, ndev: int) -> model.LSTMParams:
    """W, U and b's gate axis into the device-major layout."""
    return _permute_layers(params, ndev, inverse=False)


def unpermute_params_from_tp(params: model.LSTMParams, ndev: int) -> model.LSTMParams:
    """The inverse of ``permute_params_for_tp``: canonical [i|o|f|u]."""
    return _permute_layers(params, ndev, inverse=True)


def tp_specs(cfg: ModelConfig) -> model.LSTMParams:
    """The axis along which each tensor of the permuted set is sharded over
    the model axis (the JAX PartitionSpecs): W, U along their columns, b
    along its length, Why along its rows; by (None) replicated."""
    layer = model.LayerParams(W=1, U=1, b=0)
    return model.LSTMParams(tuple(layer for _ in range(cfg.num_layers)), 0, None)


def tp_replicated_mask(cfg: ModelConfig) -> model.LSTMParams:
    """True for the tensors replicated across the model axis (by): their
    squared sum is counted once in the global norm (``train/optimizer.py``)."""
    return model.like(tp_specs(cfg), (d is None for d in model.tensors(tp_specs(cfg))))


def shard_params(params: model.LSTMParams, cfg: ModelConfig, rank: int,
                 ndev: int) -> model.LSTMParams:
    """Rank ``rank``'s shards of a canonical set (params, Adagrad
    accumulators, gradients): permuted, then cut along ``tp_specs``."""
    perm = permute_params_for_tp(params, ndev)

    def cut(x, dim):
        if dim is None:
            return x.clone()
        n = x.shape[dim] // ndev
        return x.narrow(dim, rank * n, n).clone()

    return model.like(perm, map(cut, model.tensors(perm),
                                model.tensors(tp_specs(cfg))))


def unshard_params(params_d: model.LSTMParams, cfg: ModelConfig,
                   group: Optional[mesh.TPGroup]) -> model.LSTMParams:
    """The canonical set from every rank's shards: all-gathered along
    ``tp_specs``, then unpermuted (checkpoints, eval and sampling)."""
    full = model.like(params_d, (
        x if dim is None else mesh.all_gather(x, dim, group)
        for x, dim in zip(model.tensors(params_d), model.tensors(tp_specs(cfg)))))
    return unpermute_params_from_tp(full, 1 if group is None else group.size)


# --- the model ---------------------------------------------------------------


def _tp_scan_layer(layer, xw, h0_d, c0_d, cfg: ModelConfig,
                   group: Optional[mesh.TPGroup], backend: str = "xla",
                   plain: bool = False):
    """The shard-local recurrence of one layer: xw (S, B, 4nd), h0_d, c0_d
    (B, nd) -> (h_seq_d (S, B, nd), (hT, cT)), the carry in the param type
    (h0 and c0 cast to it first, as the JAX scan carries them)."""
    nd = layer.U.shape[1] // 4
    h, c = h0_d.to(cfg.pdtype), c0_d.to(cfg.pdtype)
    if backend == "pallas_seq":
        return cuda_tp_seq.tp_seq_lstm(layer.U, xw, h, c, cfg, group, plain)
    # the per-step family's U in the compute type, cast once a window and
    # outside autograd (dU goes to layer.U unrounded, as in JAX)
    U_c = layer.U.detach().to(cfg.cdtype) if backend == "pallas" else None
    hs = []
    for t in range(xw.shape[0]):
        h_full = all_gather(h, 1, group)
        if backend == "pallas":
            h, c = cuda_tp_cell.fused_tp_step(layer.U, xw[t], h_full, c, cfg,
                                              plain, U_c)
        elif backend == "xla":
            g_pre = xw[t] + cell_ops.matmul(h_full, layer.U, cfg.cdtype)
            h, c = cell_ops.cell_step(g_pre, c.to(cfg.adtype), nd,
                                      cfg.cell_variant)
        else:
            raise ValueError(f"unknown TP backend {backend!r}")
        h, c = h.to(cfg.pdtype), c.to(cfg.pdtype)
        hs.append(h)
    return torch.stack(hs), (h, c)


def tp_stack_forward(params: model.LSTMParams, ids, h0, c0, cfg: ModelConfig,
                     group: Optional[mesh.TPGroup], backend: str = "xla",
                     dropout_key=None, plain: bool = False):
    """The sharded forward of the layer stack: (the all-gathered top hidden
    sequence (S, B, N), the stacked shard-local final state (L, B, nd)).
    Layer 0's xw gathers rows of its column-sharded W, plus b; tied
    embeddings all-gather Why and project it through the sharded W0, as
    ``tp.py:179-193``. ``dropout_key`` (``models.lstm.step_key``'s, the
    same on every rank) masks the full stream after each layer."""
    s, b_ = ids.shape
    drop = cfg.dropout if dropout_key is not None else 0.0
    ad = cfg.adtype
    x_full = None
    h_last, c_last = [], []
    for l, layer in enumerate(params.layers):
        if l == 0:
            W0 = layer.W
            if cfg.tie_embeddings:
                why_full = all_gather(params.Why, 0, group)
                W0 = cell_ops.matmul(why_full.T, W0, cfg.cdtype, ad).to(W0.dtype)
            xw = W0[ids.long()].to(ad) + layer.b.to(ad)
        else:
            flat = x_full.reshape(s * b_, -1)
            xw = cell_ops.matmul(flat, layer.W, cfg.cdtype).reshape(s, b_, -1)
            xw = xw + layer.b.to(ad)
        h_seq_d, (hT, cT) = _tp_scan_layer(layer, xw, h0[l], c0[l], cfg,
                                           group, backend, plain)
        x_full = all_gather(h_seq_d, 2, group)
        if drop > 0.0:
            x_full = model._dropout(x_full, drop,
                                    model._drop_seed(dropout_key, l))
        h_last.append(hT)
        c_last.append(cT)
    return x_full, (torch.stack(h_last), torch.stack(c_last))


def tp_head_logits(params: model.LSTMParams, flat, cfg: ModelConfig,
                   group: Optional[mesh.TPGroup]):
    """The row-sharded head: this rank's nd rows of Why against its slice
    of the hidden features, psum'd over the model axis, plus by."""
    nd = params.Why.shape[0]
    rank = 0 if group is None else group.rank
    y = cell_ops.matmul(flat[:, rank * nd:(rank + 1) * nd], params.Why,
                        cfg.cdtype)
    return psum(y, group) + params.by.to(cfg.adtype)


def tp_loss_fn(params: model.LSTMParams, ids, targets, h0, c0,
               cfg: ModelConfig, group: Optional[mesh.TPGroup],
               backend: str = "xla", dropout_key=None, plain: bool = False):
    """``models.lstm.loss_fn`` under TP, from shard-local params and state:
    (loss, ((hT, cT) shards, mean bits)), loss and bits the same on every
    rank."""
    s, b_ = ids.shape
    x_full, state = tp_stack_forward(params, ids, h0, c0, cfg, group,
                                     backend, dropout_key, plain)
    logits = tp_head_logits(params, x_full.reshape(s * b_, -1), cfg,
                            group).reshape(s, b_, cfg.vocab)
    if cfg.loss_mode == "last":
        bits = model.softmax_xent_bits(logits[-1], targets[-1])
    else:
        bits = model.softmax_xent_bits(logits, targets)
    mean_bits = torch.mean(bits)
    loss = mean_bits if cfg.loss_base == "2" else mean_bits * model.LN2
    return loss, (state, mean_bits)


def tp_loss_and_grads(params: model.LSTMParams, x, t, h, c, cfg: ModelConfig,
                      group: Optional[mesh.TPGroup], backend: str = "xla",
                      dropout_key=None, plain: bool = False):
    """``tp_loss_fn`` and its gradient in every shard-local parameter
    (``make_tp_loss_and_grad``'s counterpart): (loss, (hT, cT), mean bits,
    grads), all detached; the gradients in the permuted, sharded layout."""
    leaves = [p.detach().requires_grad_() for p in model.tensors(params)]
    with torch.enable_grad():
        loss, ((h2, c2), bits) = tp_loss_fn(
            model.like(params, leaves), x, t, h, c, cfg, group, backend,
            dropout_key, plain)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), (h2.detach(), c2.detach()), bits.detach(),
            model.like(params, grads))


@dataclasses.dataclass
class TPPlan:
    """How a trainer runs tensor parallelism: the model axis, the family of
    the recurrence and whether the kernel families run their plain
    versions."""

    group: Optional[mesh.TPGroup]
    backend: str
    plain: bool = False

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    @property
    def size(self) -> int:
        return 1 if self.group is None else self.group.size

    def norm_kw(self, cfg: ModelConfig):
        """``optimizer.apply_updates``'s global norm over the model axis,
        by counted once."""
        return dict(group=self.group, replicated=tp_replicated_mask(cfg))
