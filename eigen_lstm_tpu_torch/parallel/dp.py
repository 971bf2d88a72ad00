"""Data-parallel training over the data axis of a ``ProcessMesh``, the
port's ``eigen_lstm_tpu/parallel/dp.py``.

The global batch of B streams is split over the D ranks of the data axis:
rank d holds streams [d * B/D, (d + 1) * B/D), its slices of h and c
(L, B/D, N) and of the cursors, and the whole parameter set. Each rank
runs the single-device step on its streams through ``cell_fn``, so the
kernels of ``ops/dispatch.py:select_cell_fn`` run unchanged; then one
all-reduce over the data group averages the gradients and the bits, and
every rank applies the same Adagrad update, which keeps the parameters
replicated. The non-finite skip is per shard and comes before the mean
(``dp.py:66-75``): a shard whose loss is not finite adds zeros and keeps
its own pre-step state.

A shard's dropout key and reset noise fold in its data rank (``data_key``;
the trainer seeds the noise generator), so the shards draw different masks
and noise, as the JAX superstep folds in ``axis_index``. Streamed, a rank
is fed only its own B/D slice of the windows
(``make_dp_streamed_superstep``): the trainer builds its feeder on the
rank's cursors.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DataConfig, ModelConfig, TrainConfig
from ..models import lstm as model
from ..ops import cell as cell_ops
from ..train import trainer as trainer_mod
from . import mesh as mesh_mod


def data_key(key: int, data_rank: int) -> int:
    """The dropout key of data shard ``data_rank`` at a step whose key is
    ``key`` (``models.lstm.step_key``'s): the rank folded in with the
    port's hash, as the JAX shard folds in ``axis_index("data")`` (other
    bits)."""
    h = cell_ops.hash32
    return h(h(key) ^ h(data_rank ^ 0x5BD1E995))


def local_batch(dcfg: DataConfig, data: mesh_mod.AxisGroup,
                what: str = "devices") -> int:
    """B / D, the streams of one data shard; the JAX ``ValueError`` unless
    D divides the global batch."""
    if dcfg.batch % data.size != 0:
        raise ValueError(f"global batch {dcfg.batch} not divisible by "
                         f"{data.size}" + (f" {what}" if what else ""))
    return dcfg.batch // data.size


def psum(tensors, axis: Optional[mesh_mod.AxisGroup], mean: bool = False):
    """The sum of each tensor over ``axis`` (``jax.lax.psum``; with
    ``mean``, ``jax.lax.pmean``), in one all-reduce of their
    concatenation; each comes back in its own type and shape."""
    dtype = torch.promote_types(tensors[0].dtype, torch.float32)
    flat = mesh_mod.all_reduce(torch.cat([t.reshape(-1).to(dtype)
                                          for t in tensors]), axis)
    if mean:
        flat = flat / axis.size
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def pmean(tensors, data: mesh_mod.AxisGroup):
    """The mean of each tensor over the data axis (``jax.lax.pmean``), as
    ``psum`` packs them."""
    return psum(tensors, data, mean=True)


def dp_train_step(state, x, t, mcfg: ModelConfig, dcfg: DataConfig,
                  tcfg: TrainConfig, length: int, cell_fn,
                  generator: Optional[torch.Generator],
                  data: mesh_mod.AxisGroup):
    """One step of data shard ``data.rank`` on its windows (x, t), each
    (S, B/D): the single-device loss and gradients, the per-shard skip,
    the mean over the data axis, then the same update on every rank.
    Returns (state, (mean bits, grad norm))."""
    dkey = (data_key(model.step_key(tcfg.seed, state.step), data.rank)
            if mcfg.dropout > 0.0 else None)
    loss, (h2, c2), bits, grads = trainer_mod.loss_and_grads(
        state.params, x, t, state.h, state.c, mcfg, cell_fn, dkey)
    if tcfg.skip_nonfinite:
        grads, h2, c2 = trainer_mod.skip_nonfinite(loss, grads, h2, c2, state)
    *leaves, bits = pmean(model.tensors(grads) + [bits], data)
    return trainer_mod.finish_step(state, h2, c2, model.like(grads, leaves),
                                   bits, dcfg, tcfg, length, generator)


def shard_state(state, data: mesh_mod.AxisGroup):
    """Data shard ``data.rank`` of a canonical ``TrainState``
    (``dp.py:204-219``): the parameters and accumulators whole, the streams
    [d * B/D, (d + 1) * B/D) of h, c (dim 1) and the cursors (dim 0)."""
    n = state.positions.shape[0] // data.size
    cut = lambda x, dim: x.narrow(dim, data.rank * n, n).contiguous()
    return trainer_mod.TrainState(state.params, state.m, cut(state.h, 1),
                                  cut(state.c, 1), cut(state.positions, 0),
                                  state.step)


def gather_state(state, data: mesh_mod.AxisGroup):
    """The inverse of ``shard_state``: every shard's streams gathered in
    rank order (all ranks take part)."""
    g = lambda x, dim: mesh_mod.all_gather(x, dim, data)
    return trainer_mod.TrainState(state.params, state.m, g(state.h, 1),
                                  g(state.c, 1), g(state.positions, 0),
                                  state.step)
