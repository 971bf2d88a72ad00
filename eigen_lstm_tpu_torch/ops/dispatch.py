"""Recurrence backend selection, the port's ``eigen_lstm_tpu/ops/dispatch.py``.

The JAX package picks its kernels by VMEM budgets: the resident kernels
while U and a step's blocks fit the TPU core's 16 MB of VMEM
(``dispatch.py:18-56``, ``pallas_cell.py:1100-1110``), the tiled ones that
stream U in gate-axis tiles past that (``pallas_cell_tiled.py:180-210,
484-510, 656-663``), the XLA scan when neither fits, and for layer 0 one of
two VJPs by whether the fp32 weight gradient also fits
(``fused_accum_ok``, ``pallas_cell.py:874-881``). The families round in
different places: the tiled VJPs round the cotangent of h_seq to the xw
type before the reverse steps and sum the rounded dg into db, and the
layer-0 GEMM fall-back sums the rounded dg too, where the fused VJP sums
the fp32 dg.

This module copies those gates in plain Python. **Every number in them
describes the TPU's VMEM.** The port keeps them only to choose which VJP's
roundings the JAX package applies at a config, so that both packages
compute the same function. They are not a capacity gate of the H100
kernels: those read U from device memory and L2 at every step, and their
only gate is alignment (``cuda_cell.shape_ok``: the hidden width a
multiple of 32), which the wrappers check, raising on a shape they do not
take. Where the JAX package takes the XLA scan (``_shape_ok`` fails, or
no Pallas kernel fits), the port runs its resident kernels, with the fused
VJP's db: the H100 kernels take those shapes. The fused head's gate is
what its kernels take (``head.head_supported``). ``select_tp_backend``
picks the tensor-parallel family as the JAX trainer does, with the TP
gates copied in ``cuda_tp_cell`` and ``cuda_tp_seq`` (their VMEM budget,
too, describes the TPU).
"""

from __future__ import annotations

import functools
import os

import torch

from ..config import ModelConfig
from . import cuda_cell_bwd, cuda_cell_tiled, cuda_tp_cell, cuda_tp_seq, head

_MB = 1024 * 1024
VMEM_BUDGET = 14 * _MB     # pallas_cell_tiled.py:49


def _rdtype_name(cfg: ModelConfig) -> str:
    # the JAX wrappers' residual type: fp32 only when asked for, else bf16
    return "float32" if cfg.residual_dtype == "float32" else "bfloat16"


def _shape_ok(cfg: ModelConfig, batch: int) -> bool:
    return cfg.hidden % 128 == 0 and batch % 8 == 0


def resident_supported(cfg: ModelConfig, batch: int) -> bool:
    """``dispatch.py:resident_supported``: U (N, 4N) in the compute type
    within 8 MB, and with the backward's (B, 4N) g and dg blocks within
    16 MB of VMEM."""
    if not _shape_ok(cfg, batch):
        return False
    csz = 2 if cfg.compute_dtype == "bfloat16" else 4
    rsz = 2 if cfg.residual_dtype == "bfloat16" else 4
    vmem_u = cfg.hidden * 4 * cfg.hidden * csz
    if vmem_u > 8 * _MB:
        return False
    return vmem_u + batch * cfg.hidden * 8 * (rsz + csz) <= 16 * _MB


def pick_tile_width(n: int, b: int, cdtype_name: str, rdtype_name: str,
                    drop: bool = False) -> int:
    """``pallas_cell_tiled.py:pick_tile_width``: the largest wt in (512,
    256, 128) dividing N whose forward and backward VMEM footprints fit
    the budget; 0 if none does."""
    cbytes = 2 if cdtype_name == "bfloat16" else 4
    rbytes = 2 if rdtype_name == "bfloat16" else 4
    for wt in (512, 256, 128):
        if n % wt != 0:
            continue
        bwd = (2 * n * wt * cbytes + b * 4 * n * rbytes + b * 4 * n * cbytes
               + 2 * b * n * 4 + 2 * 2 * b * n * rbytes + 2 * b * n * cbytes
               + 3 * b * n * 4 + 4 * b * wt * (rbytes + cbytes))
        fwd = (2 * n * wt * cbytes + b * 4 * n * 4 + 2 * b * n * 4
               + b * n * cbytes + 2 * 2 * b * n * rbytes
               + 4 * b * wt * (cbytes + rbytes) + 2 * b * n * 4
               + (2 * b * n * rbytes if drop else 0))
        if max(fwd, bwd) <= VMEM_BUDGET:
            return wt
    return 0


def pick_tile_width_embed(n: int, m: int, b: int, cdtype_name: str,
                          rdtype_name: str, drop: bool = False) -> int:
    """``pallas_cell_tiled.py:pick_tile_width_embed``: as
    ``pick_tile_width`` with the stacked (M+N, wt) weight tile; the shared
    backward's budget gates too."""
    cbytes = 2 if cdtype_name == "bfloat16" else 4
    rbytes = 2 if rdtype_name == "bfloat16" else 4
    for wt in (512, 256, 128):
        if n % wt != 0:
            continue
        if pick_tile_width(n, b, cdtype_name, rdtype_name, drop) < wt:
            continue
        fwd = (2 * (m + n) * wt * cbytes + b * (m + n) * cbytes
               + b * 4 * n * 4 + 2 * b * n * 4 + 2 * 2 * b * n * rbytes
               + 2 * b * wt * rbytes + 2 * b * n * 4
               + (2 * b * n * rbytes if drop else 0))
        if fwd <= VMEM_BUDGET:
            return wt
    return 0


def tiled_supported(cfg: ModelConfig, batch: int) -> bool:
    """``dispatch.py:tiled_supported``."""
    return _shape_ok(cfg, batch) and pick_tile_width(
        cfg.hidden, batch, cfg.compute_dtype, _rdtype_name(cfg),
        cfg.dropout > 0.0) > 0


def embed_supported(cfg: ModelConfig, batch: int) -> bool:
    """``pallas_cell.py:embed_supported``: the stacked (M+N, 4N) weight in
    the compute type within 12 MB."""
    n, m = cfg.hidden, cfg.vocab
    if n % 128 != 0 or m % 128 != 0 or batch % 8 != 0:
        return False
    bytes_per = 2 if cfg.compute_dtype == "bfloat16" else 4
    return (m + n) * 4 * n * bytes_per <= 12 * _MB


def tiled_embed_supported(cfg: ModelConfig, batch: int) -> bool:
    """``pallas_cell_tiled.py:tiled_embed_supported``."""
    n, m = cfg.hidden, cfg.vocab
    if n % 128 != 0 or m % 128 != 0 or batch % 8 != 0:
        return False
    return pick_tile_width_embed(n, m, batch, cfg.compute_dtype,
                                 _rdtype_name(cfg), cfg.dropout > 0.0) > 0


def fused_accum_ok(cfg: ModelConfig, batch: int) -> bool:
    """``fused_accum_ok`` of ``pallas_cell.py:874-881``: the fp32 dWU block,
    U and the backward's blocks within 16 MB. Where it holds the JAX
    package's layer 0 takes the fused VJP (db from the fp32 dg), else the
    GEMM fall-back (db from dg rounded to the xw type)."""
    n, m, b = cfg.hidden, cfg.vocab, batch
    rbytes = 2 if _rdtype_name(cfg) == "bfloat16" else 4
    cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    return ((m + n) * 4 * n * 4 + n * 4 * n * cbytes + 2 * b * 4 * n * rbytes
            + 6 * b * n * rbytes + 2 * b * n * 4 + 6 * b * n * 4) <= 16 * _MB


def unroll2_vmem_ok(cfg: ModelConfig, batch: int) -> bool:
    """``unroll2_vmem_ok`` of ``pallas_cell.py:951-958``: the unroll-2
    kernel's working set (the fp32 dWU block, U, and two-step time blocks
    for g, c, h and dh, double-buffered) within 16 MB of VMEM."""
    n, m, b = cfg.hidden, cfg.vocab, batch
    rbytes = 2 if _rdtype_name(cfg) == "bfloat16" else 4
    cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    return ((m + n) * 4 * n * 4 + n * 4 * n * cbytes
            + 2 * 2 * b * 4 * n * rbytes + 2 * 2 * b * n * rbytes * 4
            + 2 * 2 * b * n * 4 + 6 * b * n * 4) <= 16 * _MB


def bwd_unroll2(cfg: ModelConfig, s: int, batch: int, fused_accum: bool,
                drop: float = 0.0) -> bool:
    """Whether layer 0's backward runs K12 (``pallas_cell.py:
    _bwd_embed_unroll2_kernel``'s counterpart) instead of K3: where the JAX
    package runs its unroll-2 kernel, ``use_unroll2`` of
    ``pallas_cell.py:959-961`` taken inside its fused VJP (``:1031``):
    ``EIGEN_LSTM_BWD_UNROLL=2``, S even, ``EIGEN_LSTM_BWD_DEFER`` not 1,
    ``fused_accum`` and ``unroll2_vmem_ok``. The environment is read at
    each call, as ``pallas_embed_layer0`` reads it (``:1132-1135``). Where
    unroll 2 is asked for and not taken, the JAX package's line is printed
    once per shape and config (``:962-969``) and K3 runs. The knob applies
    only where the JAX package runs its resident layer-0 kernel at all
    (``families``: ``"embed_fused"`` or ``"embed_fallback"``).

    ``unroll2_vmem_ok`` describes the TPU's VMEM and picks which kernel the
    JAX package runs; it is not the H100's capacity: K12 takes any shape
    K3 takes with an even S. ``EIGEN_LSTM_BSPLIT`` and
    ``EIGEN_LSTM_BSPLIT_BWD`` get no counterpart: they only block the
    TPU's batch in halves, with bitwise identical results."""
    if int(os.environ.get("EIGEN_LSTM_BWD_UNROLL", "1")) != 2:
        return False
    if families(cfg, batch)[1] not in ("embed_fused", "embed_fallback"):
        return False
    defer = os.environ.get("EIGEN_LSTM_BWD_DEFER", "0") == "1"
    return _unroll2_choice(cfg, s, batch, defer, float(drop)) and fused_accum


@functools.lru_cache(maxsize=None)
def _unroll2_choice(cfg: ModelConfig, s: int, batch: int, defer: bool,
                    drop: float) -> bool:
    # cached on (shape, config), so the fall-back line prints once, as the
    # JAX package's lru_cache'd _make_fused_embed_seq prints it
    vmem_ok = unroll2_vmem_ok(cfg, batch)
    use = s % 2 == 0 and not defer and vmem_ok
    if not use:
        print(f"[pallas_cell] EIGEN_LSTM_BWD_UNROLL=2 requested but falling "
              f"back to unroll-1 (s={s} even={s % 2 == 0}, defer={defer}, "
              f"vmem_ok={vmem_ok})", flush=True)
    return use


def families(cfg: ModelConfig, batch: int):
    """(layers >= 1, layer 0) as the JAX ``select_cell_fn`` picks them
    (``dispatch.py:74-123``): ``"resident"`` or ``"tiled"``; and
    ``"embed_fused"``, ``"embed_fallback"`` (the resident layer-0 kernel
    with either VJP), ``"tiled_embed"`` or ``None`` (layer 0 through the
    layers >= 1 family, from xw = W[ids] + b). ``"xla"`` in both where the
    JAX package takes the XLA scan; the port then runs ``("resident",
    "embed_fused")``."""
    resident = resident_supported(cfg, batch)
    if not (resident or tiled_supported(cfg, batch)):
        return "xla", "xla"
    if embed_supported(cfg, batch):
        embed = ("embed_fused" if fused_accum_ok(cfg, batch)
                 else "embed_fallback")
    elif not resident and tiled_embed_supported(cfg, batch):
        embed = "tiled_embed"
    else:
        embed = None
    return ("resident" if resident else "tiled"), embed


def _cell_fn(cfg: ModelConfig, batch: int, plain: bool):
    scan, embed = families(cfg, batch)
    xla = scan == "xla"
    if xla:
        scan, embed = "resident", "embed_fused"
    if scan == "tiled":
        cell_fn = functools.partial(
            cuda_cell_tiled.differentiable_tiled_scan_layer, plain=plain)
    else:
        cell_fn = functools.partial(cuda_cell_bwd.differentiable_scan_layer,
                                    plain=plain)
    # both layer hooks of both families fuse the dropout of their output
    # stream, with the mask bits of pallas_cell.py:_keep_mask (the JAX
    # dispatch.py:103-106)
    cell_fn.fused_dropout = True
    if embed == "tiled_embed":
        cell_fn.embed_layer0 = functools.partial(
            cuda_cell_tiled.differentiable_tiled_embed_layer0, plain=plain)
    elif embed is not None:
        # the layer-0 VJP is chosen at each call, at the batch its kernel
        # sees, as pallas_embed_layer0 chooses it (pallas_cell.py:1122,
        # :874-881); where the JAX package takes the XLA scan, the fused
        # VJP's db
        kw = {"fused_accum": True} if xla else {}
        cell_fn.embed_layer0 = functools.partial(
            cuda_cell_bwd.differentiable_embed_layer0, plain=plain, **kw)
    fused_head = functools.partial(head.fused_head_bits, plain=plain)
    fused_head.supported = head.head_supported
    cell_fn.fused_head = fused_head
    cell_fn.plain = plain
    return cell_fn


def select_cell_fn(backend: str, cfg: ModelConfig, batch: int, device="cuda"):
    """A ``cell_fn`` for ``models.lstm.forward``: the layers >= 1
    recurrence, differentiable, with ``.embed_layer0`` (the layer-0
    recurrence, differentiable) where the JAX package has one, both taking
    ``dropout=(rate, seed)`` (``.fused_dropout``), and ``.fused_head`` (the
    fused softmax cross-entropy head, which reads the masked top stream,
    with its ``.supported`` gate, which ``models.lstm.loss_fn`` checks per
    shape). The families are the JAX ``select_cell_fn``'s at (cfg, batch)
    (``families``).

    ``"cuda"``: the kernels; raises unless ``device`` is a CUDA device.
    ``"plain"``: the kernels' plain versions, on any device. ``"auto"``: the
    kernels on a CUDA device, the plain versions on the CPU."""
    dev = torch.device(device)
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" else "plain"
    if backend == "plain":
        return _cell_fn(cfg, batch, plain=True)
    if backend == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"cuda backend on device {dev}")
        return _cell_fn(cfg, batch, plain=False)
    raise ValueError(f"unknown backend {backend!r}")


def select_tp_backend(cfg: ModelConfig, batch: int, ndev: int, cell_fn,
                      device="cuda", allow_per_step: bool = True) -> str:
    """The tensor-parallel family of ``_select_tp_backend``
    (``eigen_lstm_tpu/train/trainer.py:213-229``): ``"pallas_seq"`` (K15,
    K16) where ``cuda_tp_seq.tp_seq_supported`` holds and
    ``EIGEN_LSTM_TP_SEQ`` is not ``0``, else ``"pallas"`` (K13, K14) where
    ``cuda_tp_cell.tp_pallas_supported`` holds, else ``"xla"``; ``"xla"``
    without a ``cell_fn``. On a CUDA ``device`` a ``cell_fn`` never gets
    ``"xla"``: where the JAX package would take its XLA TP scan the card
    runs the per-step kernels, as ``select_cell_fn`` runs the resident
    kernels where the JAX package takes its XLA scan. ``batch`` is the
    batch each kernel sees. ``allow_per_step=False`` (the data x model
    mesh, JAX ``trainer.py:351-358``) leaves the per-step family out of the
    ladder: ``"pallas_seq"`` or ``"xla"``, on any device. The environment
    is read at each call."""
    if cell_fn is None:
        return "xla"
    if os.environ.get("EIGEN_LSTM_TP_SEQ", "1") != "0":
        if cuda_tp_seq.tp_seq_supported(cfg, batch, ndev):
            return "pallas_seq"
    if allow_per_step and (cuda_tp_cell.tp_pallas_supported(cfg, batch, ndev)
                           or torch.device(device).type == "cuda"):
        return "pallas"
    return "xla"
