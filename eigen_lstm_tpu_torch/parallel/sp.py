"""Sequence pipelining over the seq axis of a ``ProcessMesh`` (``--sp N``,
alone or with ``--dp M`` or ``--tp M``), the port's
``eigen_lstm_tpu/parallel/sp.py``.

The S-step window is cut into D time segments, rank d of the seq axis
owning steps [d * S/D, (d + 1) * S/D), and the batch into C =
``TrainConfig.pp_chunks`` microchunks of B/C contiguous rows. Rank d runs
its whole layer stack over its segment for each chunk: segment 0 from the
chunk's rows of the window's (h0, c0), every other one from the (L, B/C,
N) carry that rank d - 1 hands up, cast to the parameter type before it is
sent. Each chunk's logits come from the open head
(``models.lstm.logits_from_h``; the fused head of K4 and K5 is not on this
path, as it is not in the JAX package) and its bits from
``softmax_xent_bits``; ``loss_mode="last"`` scores only the window's last
step, on the last segment. The loss divides the bits summed over every
rank by B ("last") or S * B ("all").

The schedule is GPipe's, in eager PyTorch (``parallel/gpipe.py``, which
``parallel/pp.py`` shares). The forward runs the chunks in order, each with
its own autograd graph: receive the carry from d - 1, run the segment,
send the carry to d + 1. The backward runs them in reverse: receive the
carry's cotangents from d + 1, back-propagate the chunk's loss and its
outgoing carry together, send the cotangents of its incoming carry to d -
1. At D = 1 nothing is sent. Then one all-reduce over the seq axis sums every rank's gradients
and bits, and the last segment's rank broadcasts the window's final (h,
c), which it assembled chunk by chunk.

Each kernel of ``ops/dispatch.py:select_cell_fn`` runs on the B/C rows of
a chunk (B/(M * C) under ``--dp M``), and its plan takes that batch. The
families are chosen at the global batch, as the JAX trainer chooses them;
layer 0's VJP at the rows of each call.

``sp_train_step`` is the step of the JAX package's three meshes, ending
in ``trainer.finish_step`` (the cursor advance, the wrap reset and Adagrad
of one device):

- ``--sp N`` (``make_sp_superstep``): the state is replicated on every
  rank, so the wrap reset's noise is the single device's stream.
- ``--dp M --sp N`` (``data``, ``make_dp_sp_superstep``): the streams are
  split over the data axis as in ``parallel/dp.py`` and each shard
  pipelines its windows over its seq axis; the gradients, the loss and the
  bits are averaged over data, so the non-finite skip reads the data-mean
  loss (``sp.py:415-432``). The dropout key and the reset noise fold in
  the data rank.
- ``--sp N --tp M`` (``tp``, ``make_tp_sp_superstep``): each segment runs
  the gate-sharded stack of ``parallel/tp.py`` over its model axis with
  the torch-op scan (the JAX mesh takes the XLA scan, ``backend="xla"``);
  the carries are model shards, the gradients stay shard-local over model
  and Adagrad's norm sums over it with by counted once. The reset noise
  folds in the model rank.

The canonical state is sharded and gathered by the trainer: nothing over
seq, the data axis's streams as ``parallel/dp.py`` cuts them, the model
axis's shards as ``parallel/tp.py`` cuts them.

With dropout, each (segment, chunk) folds ``d * C + j`` into the step's
key (``segment_key``), at D = 1 and C = 1 too, so a pipelined run draws
other masks than one device does, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DataConfig, ModelConfig, TrainConfig
from ..models import lstm as model
from ..ops import cell as cell_ops
from ..train import trainer as trainer_mod
from . import dp as dp_mod
from . import gpipe as gpipe_mod
from . import mesh as mesh_mod
from . import tp as tp_mod


def segment_key(key: int, index: int) -> int:
    """The dropout key of (segment, chunk) ``index`` = d * C + j at a step
    whose key is ``key``: the index folded in with the port's hash, as the
    JAX schedule folds it in (``sp.py:115-119``; other bits)."""
    h = cell_ops.hash32
    return h(h(key) ^ h(index ^ 0x27D4EB2F))


def check_shapes(mcfg: ModelConfig, dcfg: DataConfig, tcfg: TrainConfig,
                 n_seq: int, n_data: Optional[int] = None,
                 n_model: Optional[int] = None):
    """The JAX ``ValueError`` s of the three meshes (``sp.py:283-287,
    390-397, 507-516``), in their order."""
    seq, batch, n_chunks = dcfg.seq, dcfg.batch, tcfg.pp_chunks
    if n_data is not None and batch % n_data != 0:
        raise ValueError(f"batch {batch} not divisible by {n_data} data shards")
    if seq % n_seq != 0:
        raise ValueError(f"seq {seq} not divisible by {n_seq} seq devices")
    if n_data is not None:
        if (batch // n_data) % n_chunks != 0:
            raise ValueError(f"per-shard batch {batch // n_data} not "
                             f"divisible by pp_chunks {n_chunks}")
    elif batch % n_chunks != 0:
        raise ValueError(f"batch {batch} not divisible by pp_chunks {n_chunks}")
    if n_model is not None and mcfg.hidden % n_model != 0:
        raise ValueError(f"hidden {mcfg.hidden} not divisible by {n_model} "
                         f"model devices")


def _segment(params, ids, h0, c0, cfg: ModelConfig, cell_fn, tp, key):
    """One segment's layer stack on one chunk: (the top hidden sequence,
    the final (h, c), the head as a function of hidden rows)."""
    if tp is None:
        h_top, state = model.forward(params, ids, h0, c0, cfg,
                                     cell_fn=cell_fn, dropout_key=key)
        return h_top, state, lambda hr: model.logits_from_h(params, hr, cfg)
    h_top, state = tp_mod.tp_stack_forward(params, ids, h0, c0, cfg, tp.group,
                                           tp.backend, key, tp.plain)

    def head(hr):
        y = tp_mod.tp_head_logits(params, hr.reshape(-1, cfg.hidden), cfg,
                                  tp.group)
        return y.reshape(*hr.shape[:-1], cfg.vocab)

    return h_top, state, head


def sp_loss_and_grads(params: model.LSTMParams, x, t, h, c, cfg: ModelConfig,
                      n_chunks: int, seq_axis: Optional[mesh_mod.AxisGroup],
                      cell_fn=None, tp: Optional[tp_mod.TPPlan] = None,
                      dropout_key=None):
    """The pipelined ``loss_fn`` and its gradient in every parameter on
    this rank's segment of the windows (x, t), each (S, B), from the
    window's state (h, c) (L, B, N), or its model shards under ``tp``:
    (loss, (hT, cT), mean bits, grads), the same on every rank of the seq
    axis, all detached; hT and cT in the parameter type. ``seq_axis`` None
    is one segment without a collective. ``cell_fn`` is not read under
    ``tp``."""
    s, b = x.shape
    n_seq, d = (1, 0) if seq_axis is None else (seq_axis.size, seq_axis.rank)
    if s % n_seq != 0 or b % n_chunks != 0:
        raise ValueError(f"a window of {s} steps and {b} streams does not cut "
                         f"into {n_seq} segments and {n_chunks} chunks")
    seg, bs = s // n_seq, b // n_chunks
    last = d == n_seq - 1
    only_last = cfg.loss_mode == "last"
    denom = b if only_last else s * b
    scale = (1.0 if cfg.loss_base == "2" else model.LN2) / denom
    pd = cfg.pdtype
    leaves = [p.detach().requires_grad_() for p in model.tensors(params)]
    p = model.like(params, leaves)
    xs, ts = x[d * seg:(d + 1) * seg], t[d * seg:(d + 1) * seg]
    # the window's final (h, c), assembled by the last segment's rank
    final = torch.zeros((2,) + tuple(h.shape), dtype=pd, device=h.device)
    bits = []

    def run_chunk(j, carry_in, _):
        rows = slice(j * bs, (j + 1) * bs)
        if carry_in is None:
            carry_in = torch.stack([h[:, rows], c[:, rows]]).to(pd)
        key = (None if dropout_key is None
               else segment_key(dropout_key, d * n_chunks + j))
        h_top, (hT, cT), head = _segment(
            p, xs[:, rows].contiguous(), carry_in[0], carry_in[1], cfg,
            cell_fn, tp, key)
        objective = None
        if not only_last or last:
            hr, tr = ((h_top[-1], ts[-1, rows]) if only_last
                      else (h_top, ts[:, rows]))
            chunk_bits = model.softmax_xent_bits(head(hr), tr).sum()
            bits.append(chunk_bits.detach().to(cfg.adtype))
            objective = chunk_bits * scale
        carry_out = torch.stack([hT, cT]).to(pd)
        if last:
            final[:, :, rows] = carry_out.detach()
        return objective, carry_out, None

    gpipe_mod.gpipe(n_chunks, run_chunk, final[:, :, :bs], seq_axis)
    bits = sum(bits, torch.zeros((), dtype=cfg.adtype, device=x.device))
    grads = [gpipe_mod.grad_or_zeros(l) for l in leaves]
    *grads, bits = dp_mod.psum(grads + [bits], seq_axis)
    hT, cT = mesh_mod.broadcast(final, n_seq - 1, seq_axis)
    mean_bits = bits / denom
    loss = mean_bits if cfg.loss_base == "2" else mean_bits * model.LN2
    return loss, (hT, cT), mean_bits, model.like(params, grads)


def sp_train_step(state, x, t, mcfg: ModelConfig, dcfg: DataConfig,
                  tcfg: TrainConfig, length: int, cell_fn,
                  generator: Optional[torch.Generator],
                  seq: mesh_mod.AxisGroup,
                  data: Optional[mesh_mod.AxisGroup] = None,
                  tp: Optional[tp_mod.TPPlan] = None):
    """One step of this rank's segment on the windows (x, t), each (S, B)
    or, with ``data``, (S, B/M): the pipelined loss and gradients, with
    ``data`` their mean over the data axis, the non-finite skip, then the
    single device's step. ``tp``: the segment's stack runs the TP family
    on its model shards. Returns (state, (mean bits, grad norm))."""
    dkey = None
    if mcfg.dropout > 0.0:
        dkey = model.step_key(tcfg.seed, state.step)
        if data is not None:
            dkey = dp_mod.data_key(dkey, data.rank)
    loss, (h2, c2), bits, grads = sp_loss_and_grads(
        state.params, x, t, state.h, state.c, mcfg, tcfg.pp_chunks, seq,
        cell_fn, tp, dkey)
    if data is not None:
        *leaves, loss, bits = dp_mod.pmean(model.tensors(grads) + [loss, bits],
                                           data)
        grads = model.like(grads, leaves)
    if tcfg.skip_nonfinite:
        grads, h2, c2 = trainer_mod.skip_nonfinite(loss, grads, h2, c2, state)
    return trainer_mod.finish_step(state, h2, c2, grads, bits, dcfg, tcfg,
                                   length, generator,
                                   **(tp.norm_kw(mcfg) if tp else {}))

