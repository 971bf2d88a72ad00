"""Plain PyTorch LSTM cell math: the oracle for every kernel of the port.

It mirrors ``eigen_lstm_tpu/ops/cell.py`` function for function. Gates are
packed along the last axis in the reference's [i; o; f; u] order, row-major
(B, 4N).

Float32 products must run in full float32: TF32 keeps about three decimal
digits, and the JAX package pins HIGHEST precision for the same reason
(``eigen_lstm_tpu/ops/cell.py:94-106``). ``matmul`` therefore switches TF32
off for both cuBLAS and cuDNN (``torch.backends.cuda.matmul.allow_tf32 =
False``, ``torch.backends.cudnn.allow_tf32 = False``).
"""

from __future__ import annotations

from typing import Tuple

import torch

# Full-precision float32 products on the card, as the JAX package pins
# Precision.HIGHEST: set once on import, and stated here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gate_slices(hidden: int):
    """Slices of the packed (..., 4N) gate axis in [i, o, f, u] order."""
    n = hidden
    return (
        slice(0 * n, 1 * n),  # i: input gate
        slice(1 * n, 2 * n),  # o: output gate
        slice(2 * n, 3 * n),  # f: forget gate
        slice(3 * n, 4 * n),  # u: candidate (tanh)
    )


def gate_activations(g_pre: torch.Tensor, hidden: int) -> torch.Tensor:
    """sigma on [i, o, f], tanh on [u]. (..., 4N) -> (..., 4N)."""
    n = hidden
    iof = torch.sigmoid(g_pre[..., : 3 * n])
    u = torch.tanh(g_pre[..., 3 * n:])
    return torch.cat([iof, u], dim=-1)


def cell_update(
    g: torch.Tensor, c_prev: torch.Tensor, hidden: int,
    variant: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """State update from activated gates. ``reference`` carries the
    tanh-squashed cell (c <- tanh(i*u + f*c_prev), h = o*c); ``standard``
    carries the raw cell (h = o*tanh(c)). Returns (h, c_carry)."""
    si, so, sf, su = gate_slices(hidden)
    i, o, f, u = g[..., si], g[..., so], g[..., sf], g[..., su]
    c_raw = i * u + f * c_prev
    if variant == "reference":
        c = torch.tanh(c_raw)
        return o * c, c
    if variant == "standard":
        return o * torch.tanh(c_raw), c_raw
    raise ValueError(f"unknown cell variant: {variant}")


def cell_step(
    g_pre: torch.Tensor, c_prev: torch.Tensor, hidden: int,
    variant: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full cell step from pre-activations. Returns (h, c_carry)."""
    return cell_update(gate_activations(g_pre, hidden), c_prev, hidden, variant)


def matmul(
    a: torch.Tensor, w: torch.Tensor, compute_dtype=torch.float32,
    accum_dtype=None,
) -> torch.Tensor:
    """``a @ w`` with the inputs rounded to ``compute_dtype`` and the product
    formed in ``accum_dtype`` (float32; float64 for the float64 oracle), as
    ``preferred_element_type`` does in the JAX package. The result is never
    bf16-typed: a bf16 product would round the logits."""
    if accum_dtype is None:
        accum_dtype = (
            torch.float64 if compute_dtype == torch.float64 else torch.float32
        )
    return torch.matmul(
        a.to(compute_dtype).to(accum_dtype), w.to(compute_dtype).to(accum_dtype)
    )


def hash32(x: int) -> int:
    """murmur3's 32-bit finalizer (the ``_fmix32`` of
    ``eigen_lstm_tpu/ops/pallas_cell.py``) on a host integer, mod 2**32."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def one_hot(ids: torch.Tensor, vocab: int, dtype=torch.float32) -> torch.Tensor:
    """Byte ids -> one-hot rows."""
    return torch.nn.functional.one_hot(ids.long(), vocab).to(dtype)


def gate_bwd(g, c_t, c_prev, dh_total, dc, hidden: int,
             variant: str = "reference"):
    """Gate backward of one step from the activated gates g (..., 4N), the
    carried cell c_t, the previous carry and the cotangents of h and of the
    carry: ``_gate_bwd`` of ``eigen_lstm_tpu/ops/pallas_cell.py``. Returns
    (dg (..., 4N) w.r.t. the pre-activations, dc carried to t-1)."""
    si, so, sf, su = gate_slices(hidden)
    i, o, f, u = g[..., si], g[..., so], g[..., sf], g[..., su]
    if variant == "reference":
        dct = dh_total * o + dc
        dc_raw = dct * (1.0 - c_t * c_t)
        do = dh_total * c_t
    elif variant == "standard":
        tc = torch.tanh(c_t)
        dc_raw = dh_total * o * (1.0 - tc * tc) + dc
        do = dh_total * tc
    else:
        raise ValueError(f"unknown cell variant: {variant}")
    di, du, df = dc_raw * u, dc_raw * i, dc_raw * c_prev
    dg = torch.cat([di * i * (1.0 - i), do * o * (1.0 - o),
                    df * f * (1.0 - f), du * (1.0 - u * u)], dim=-1)
    return dg, dc_raw * f


class _Embed(torch.autograd.Function):
    """``W[ids]`` in the accumulation type, whose backward is the JAX
    package's one-hot product (``eigen_lstm_tpu/ops/cell.py:_make_embed``):
    the cotangent rounded to the compute type, summed per byte id in the
    accumulation type, returned in W's type."""

    @staticmethod
    def forward(ctx, W, ids, compute_dtype, accum_dtype):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtypes = W.shape, (W.dtype, compute_dtype, accum_dtype)
        return W.to(accum_dtype)[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        wdtype, cdtype, adtype = ctx.dtypes
        g_c = g.reshape(-1, g.shape[-1]).to(cdtype).to(adtype)
        dW = torch.zeros(ctx.shape, dtype=adtype, device=g.device)
        dW.index_add_(0, ids.reshape(-1).long(), g_c)
        return dW.to(wdtype), None, None, None


def embed(
    W: torch.Tensor, ids: torch.Tensor, compute_dtype=torch.float32,
    accum_dtype=torch.float32,
) -> torch.Tensor:
    """Embedding lookup: the row gather ``W[ids]`` in ``accum_dtype`` (a
    one-hot product collapses to it). Its gradient is the one-hot product
    of the JAX package's custom VJP, with the cotangent rounded to
    ``compute_dtype``."""
    return _Embed.apply(W, ids, compute_dtype, accum_dtype)
