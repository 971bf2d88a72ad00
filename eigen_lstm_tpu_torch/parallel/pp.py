"""Pipeline parallelism over the stage axis of a ``ProcessMesh`` (``--pp N``,
alone or with ``--dp M``), the port's ``eigen_lstm_tpu/parallel/pp.py``.

Stage s of S holds layers [s * L/S, (s + 1) * L/S) of the stack in the
stage-stacked layout ``PPParams``: the input weights padded to (max(M, N),
4N) (global layer 0 reads rows [0, M) as its embedding table, every other
layer rows [0, N); the pad rows stay zero), U and b stacked, Why and by
whole on every stage. The window's sequence is cut into C =
``TrainConfig.pp_chunks`` chunks of S/C steps. Each stage carries its own
(h, c) of its layers from one chunk to the next, so the recurrence is the
single device's stacked scan.

The schedule is GPipe's, in eager PyTorch (``parallel/gpipe.py``, which
``parallel/sp.py`` shares). The forward runs chunks 0..C-1, each with its
own autograd graph: receive the chunk's hidden sequence from stage s - 1
(stage 0 embeds the chunk's bytes), run the stage's layers, send the top
sequence, cast to the parameter type, to stage s + 1. The backward runs
chunks C-1..0: receive the cotangent of the sent sequence from s + 1,
back-propagate it together with the chunk's loss and the cotangent of the
carry that chunk k + 1 handed back, send the cotangent of the received
sequence to s - 1. At S = 1 nothing is sent. Then one all-reduce over the
stage axis sums the bits and the head's gradients: only the last stage
scores, so only it has a gradient of Why and by, and the sum gives every
stage the same one, as the JAX pvary transpose does; the stages' Adagrad
steps on Why and by then stay equal.

The arithmetic is the JAX schedule's (``pp.py:148-221``), in the model's
torch ops: layer 0's xw is ``W_pad[ids]`` in the accumulation type through
``ops/cell.py:embed`` (no rounding to the compute type in the forward; its
backward rounds the cotangent to the compute type, as the single device's
embedding does, where the JAX schedule differentiates a plain gather: the
two agree in fp32 and float64 and differ under bf16 in dW of layer 0 by
that rounding), later layers take ``matmul(x, W[:N])``, and each layer runs
``models.lstm._scan_layer``, the recurrence ``xw_t + h_{t-1} @ U`` with c
in the accumulation type and the carry in the parameter type. As in the
JAX package no kernel of the recurrence runs here (it takes the XLA
scan), and the head is the open one (``logits_from_h``,
``softmax_xent_bits``), not K4 and K5. The loss divides the summed bits by
B (``loss_mode="last"``: the window's last step, on the last stage's last
chunk) or by S * B. Under bf16 compute the cast's VJP rounds each chunk's
weight gradient of a product (dW of layers >= 1, dWhy) to bf16 where one
device rounds the window's once, so those differ from one device's by a
few half-ulps of bf16, in the JAX schedule too; the other gradients and
the loss differ only in sum order.

``pp_train_step`` is the step of ``make_pp_superstep`` and, with a data
axis, of ``make_dp_pp_superstep`` (the streams split over data as
``parallel/dp.py`` splits them, the gradients, the loss and the bits
averaged over data, so the non-finite skip reads the data-mean loss),
ending in ``trainer.finish_step``: Adagrad's global norm sums the stages'
squared sums over the stage axis with Why and by counted once
(``pp_replicated_mask``), and K11 updates the stage's whole set in one
launch. With dropout each (global layer l, chunk k) masks its output
sequence under the step's key (the data rank folded in first) with
``l * C + k`` folded in (``stage_key``), so a pipelined run draws other
masks than one device does, as in the JAX package; its reset noise folds
in the stage rank (the trainer seeds it), so it matches one device only
at ``reset_std`` 0. Tied embeddings are refused: the head and the
embedding live on different stages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import DataConfig, ModelConfig, TrainConfig
from ..models import lstm as model
from ..ops import cell as cell_ops
from ..train import trainer as trainer_mod
from . import dp as dp_mod
from . import gpipe as gpipe_mod
from . import mesh as mesh_mod


@dataclasses.dataclass
class PPParams:
    """Stage-stacked parameters: W_pad (L, max(M, N), 4N), U (L, N, 4N),
    b (L, 4N), and Why (N, M), by (M,) whole on every stage; L is the
    stage's layers, or the model's in the canonical stack."""

    W_pad: torch.Tensor
    U: torch.Tensor
    b: torch.Tensor
    Why: torch.Tensor
    by: torch.Tensor

    def named_tensors(self):
        for name in ("W_pad", "U", "b", "Why", "by"):
            yield name, getattr(self, name)

    def tensors(self):
        return [self.W_pad, self.U, self.b, self.Why, self.by]

    def like(self, ts) -> "PPParams":
        return PPParams(*ts)


def pp_params_from(params: model.LSTMParams, cfg: ModelConfig) -> PPParams:
    """The stage-stacked layout of ``params`` (``pp.py:62-78``)."""
    n, m = cfg.hidden, cfg.vocab
    w0 = params.layers[0].W
    w_pad = w0.new_zeros((len(params.layers), max(m, n), 4 * n))
    for l, layer in enumerate(params.layers):
        w_pad[l, :layer.W.shape[0]] = layer.W
    return PPParams(w_pad, torch.stack([l.U for l in params.layers]),
                    torch.stack([l.b for l in params.layers]), params.Why,
                    params.by)


def pp_params_to(pp: PPParams, cfg: ModelConfig) -> model.LSTMParams:
    """The inverse of ``pp_params_from`` (``pp.py:81-92``)."""
    n, m = cfg.hidden, cfg.vocab
    layers = tuple(model.LayerParams(pp.W_pad[l, :(m if l == 0 else n)],
                                     pp.U[l], pp.b[l])
                   for l in range(pp.U.shape[0]))
    return model.LSTMParams(layers, pp.Why, pp.by)


def pp_replicated_mask() -> PPParams:
    """The tensors every stage holds whole (``pp.py:105``): their squared
    sums are counted once in the global norm over the stage axis."""
    return PPParams(False, False, False, True, True)


def check_stages(num_layers: int, n_stages: int):
    """The JAX ``_check_stages`` (``pp.py:251-256``)."""
    if num_layers % n_stages != 0:
        raise ValueError(
            f"pipeline needs layers divisible by stages: {num_layers} layers "
            f"vs {n_stages} devices")


def check_shapes(mcfg: ModelConfig, dcfg: DataConfig, tcfg: TrainConfig,
                 n_stages: int, n_data: Optional[int] = None):
    """The JAX trainer's and superstep functions' ``ValueError`` s of the two
    meshes, in their order: tied embeddings (``trainer.py:263-273``), then
    the batch over the data shards, the layers over the stages and the
    sequence over the chunks (``pp.py:316-320, 448-456``)."""
    if mcfg.tie_embeddings:
        parallel = "pp" if n_data is None else "dp_pp"
        raise ValueError(
            "tie_embeddings is not supported under pipeline parallelism "
            f"(parallel={parallel!r}): the head and the embedding live on "
            "different stages")
    if n_data is not None and dcfg.batch % n_data != 0:
        raise ValueError(f"global batch {dcfg.batch} not divisible by {n_data}")
    check_stages(mcfg.num_layers, n_stages)
    if dcfg.seq % tcfg.pp_chunks != 0:
        raise ValueError(f"seq {dcfg.seq} not divisible by pp_chunks "
                         f"{tcfg.pp_chunks}")


def stage_key(key: int, index: int) -> int:
    """The dropout seed of (global layer l, chunk k), ``index`` = l * C + k,
    at a step whose key is ``key``: the index folded in with the port's
    hash, as the JAX schedule folds it in (``pp.py:184-192``; other
    bits)."""
    h = cell_ops.hash32
    return h(h(key) ^ h(index ^ 0x165667B1))


def _span(stage: Optional[mesh_mod.AxisGroup], num_layers: int):
    """(stage count, stage rank, layers a stage) of ``stage`` (None: one
    stage without a collective)."""
    n_st, s = (1, 0) if stage is None else (stage.size, stage.rank)
    check_stages(num_layers, n_st)
    return n_st, s, num_layers // n_st


def shard_params(pp: PPParams, stage: Optional[mesh_mod.AxisGroup]) -> PPParams:
    """Stage ``stage.rank``'s layers of a canonical ``PPParams``; Why, by
    whole."""
    _, s, lps = _span(stage, pp.U.shape[0])
    cut = lambda x: x[s * lps:(s + 1) * lps].contiguous()
    return PPParams(cut(pp.W_pad), cut(pp.U), cut(pp.b), pp.Why, pp.by)


def gather_params(pp: PPParams, stage: Optional[mesh_mod.AxisGroup]) -> PPParams:
    """The inverse of ``shard_params``: every stage's layers gathered in
    rank order (all ranks take part)."""
    g = lambda x: mesh_mod.all_gather(x, 0, stage)
    return PPParams(g(pp.W_pad), g(pp.U), g(pp.b), pp.Why, pp.by)


def shard_state(state, cfg: ModelConfig, stage: mesh_mod.AxisGroup):
    """Stage ``stage.rank`` of a canonical ``TrainState`` (``pp.py:583-606``):
    its layers of the stage-stacked parameters and accumulators and of h
    and c (dim 0); the cursors whole."""
    _, s, lps = _span(stage, cfg.num_layers)
    cut = lambda x: x[s * lps:(s + 1) * lps].contiguous()
    own = lambda p: shard_params(pp_params_from(p, cfg), stage)
    return trainer_mod.TrainState(own(state.params), own(state.m),
                                  cut(state.h), cut(state.c), state.positions,
                                  state.step)


def gather_state(state, cfg: ModelConfig, stage: mesh_mod.AxisGroup):
    """The inverse of ``shard_state``: the canonical ``LSTMParams`` and
    (L, B, N) h and c (all ranks take part)."""
    whole = lambda p: pp_params_to(gather_params(p, stage), cfg)
    g = lambda x: mesh_mod.all_gather(x, 0, stage)
    return trainer_mod.TrainState(whole(state.params), whole(state.m),
                                  g(state.h), g(state.c), state.positions,
                                  state.step)


def _stage_chunk(q: PPParams, ids, x, carry, cfg: ModelConfig, first: bool,
                 layer0: int, seed_of):
    """The stage's layers on one chunk: the top hidden sequence and the
    stacked final carry (2, lps, B, N). ``x``: the chunk's hidden sequence
    from the stage below (None on stage 0, which embeds ``ids``);
    ``seed_of(l)``: the mask seed of global layer l (None: no dropout)."""
    cl, b = ids.shape
    n = cfg.hidden
    hs, cs = [], []
    for j in range(q.U.shape[0]):
        W = q.W_pad[j]
        if first and j == 0:
            xw = cell_ops.embed(W, ids, cfg.cdtype, cfg.adtype)
        else:
            xw = cell_ops.matmul(x.reshape(cl * b, n), W[:n], cfg.cdtype,
                                 cfg.adtype).reshape(cl, b, 4 * n)
        xw = xw + q.b[j].to(cfg.adtype)
        h_seq, (hT, cT) = model._scan_layer(
            model.LayerParams(W, q.U[j], q.b[j]), xw, carry[0, j], carry[1, j],
            cfg)
        if seed_of is not None:
            h_seq = model._dropout(h_seq, cfg.dropout, seed_of(layer0 + j))
        x = h_seq
        hs.append(hT)
        cs.append(cT)
    return x, torch.stack([torch.stack(hs), torch.stack(cs)])


def pp_loss_and_grads(pp: PPParams, x, t, h, c, cfg: ModelConfig,
                      n_chunks: int, stage: Optional[mesh_mod.AxisGroup],
                      dropout_key=None):
    """The pipelined ``loss_fn`` and its gradient in every tensor of this
    stage's ``PPParams`` on the windows (x, t), each (S, B), from the
    stage's state (h, c) (lps, B, N): (loss, (hT, cT), mean bits, grads),
    all detached, the loss and the bits the same on every stage, hT and cT
    the stage's in the parameter type (``pp_loss_fn`` with
    ``make_pp_loss_and_grad``, ``pp.py:113-288``). ``stage`` None is one
    stage without a collective."""
    s_len, b = x.shape
    n_st, si = (1, 0) if stage is None else (stage.size, stage.rank)
    lps = pp.U.shape[0]
    if s_len % n_chunks != 0:
        raise ValueError(f"seq {s_len} not divisible by pp_chunks {n_chunks}")
    cl, n, pd = s_len // n_chunks, cfg.hidden, cfg.pdtype
    first, last = si == 0, si == n_st - 1
    only_last = cfg.loss_mode == "last"
    denom = b if only_last else s_len * b
    scale = (1.0 if cfg.loss_base == "2" else model.LN2) / denom
    dropout = dropout_key is not None and cfg.dropout > 0.0
    leaves = [p.detach().requires_grad_() for p in model.tensors(pp)]
    q = PPParams(*leaves)
    bits = []

    def run_chunk(k, x_in, carry_in):
        steps = slice(k * cl, (k + 1) * cl)
        seed_of = (None if not dropout else lambda l: stage_key(
            dropout_key, l * n_chunks + k))
        top, carry_out = _stage_chunk(q, x[steps], x_in, carry_in, cfg, first,
                                      si * lps, seed_of)
        objective = None
        if last and (not only_last or k == n_chunks - 1):
            hr, tr = (top[-1], t[s_len - 1]) if only_last else (top, t[steps])
            chunk_bits = model.softmax_xent_bits(
                model.logits_from_h(q, hr, cfg), tr).sum()
            bits.append(chunk_bits.detach().to(cfg.adtype))
            objective = chunk_bits * scale
        return objective, top.to(pd), carry_out

    carry = gpipe_mod.gpipe(
        n_chunks, run_chunk, torch.empty((cl, b, n), dtype=pd, device=x.device),
        stage, torch.stack([h, c]).to(pd))
    bits = sum(bits, torch.zeros((), dtype=cfg.adtype, device=x.device))
    grads = [gpipe_mod.grad_or_zeros(l) for l in leaves]
    grads[3], grads[4], bits = dp_mod.psum(grads[3:] + [bits], stage)
    mean_bits = bits / denom
    loss = mean_bits if cfg.loss_base == "2" else mean_bits * model.LN2
    hT, cT = carry
    return loss, (hT, cT), mean_bits, PPParams(*grads)


def pp_train_step(state, x, t, mcfg: ModelConfig, dcfg: DataConfig,
                  tcfg: TrainConfig, length: int,
                  generator: Optional[torch.Generator],
                  stage: mesh_mod.AxisGroup,
                  data: Optional[mesh_mod.AxisGroup] = None):
    """One step of this stage on the windows (x, t), each (S, B) or, with
    ``data``, (S, B/M): the pipelined loss and gradients, with ``data``
    their mean over the data axis, the non-finite skip, then the single
    device's step with the global norm over the stage axis. Returns
    (state, (mean bits, grad norm))."""
    dkey = None
    if mcfg.dropout > 0.0:
        dkey = model.step_key(tcfg.seed, state.step)
        if data is not None:
            dkey = dp_mod.data_key(dkey, data.rank)
    loss, (h2, c2), bits, grads = pp_loss_and_grads(
        state.params, x, t, state.h, state.c, mcfg, tcfg.pp_chunks, stage,
        dkey)
    if data is not None:
        *leaves, loss, bits = dp_mod.pmean(model.tensors(grads) + [loss, bits],
                                           data)
        grads = grads.like(leaves)
    if tcfg.skip_nonfinite:
        grads, h2, c2 = trainer_mod.skip_nonfinite(loss, grads, h2, c2, state)
    return trainer_mod.finish_step(state, h2, c2, grads, bits, dcfg, tcfg,
                                   length, generator, group=stage,
                                   replicated=pp_replicated_mask())
