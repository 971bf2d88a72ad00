"""Recurrence backend selection, the port's ``eigen_lstm_tpu/ops/dispatch.py``.

The TPU package gates its Pallas kernels on VMEM budgets
(``dispatch.py:24-55``, ``pallas_cell.py:1100-1110``): U had to sit in
16 MB of VMEM beside the step's blocks. Those budgets describe the TPU and
are not carried over. The H100 kernels read U from device memory and L2 at
every step and keep only a (4, 256) tile of h and the reduction in shared
memory, so their gate is alignment alone, and it lives in the wrappers
(``cuda_cell.shape_ok``: the hidden width a multiple of 32), which raise on
a shape they do not take. The fused head's gate is what its kernels take
(``head.head_supported``).
"""

from __future__ import annotations

import functools

import torch

from ..config import ModelConfig
from . import cuda_cell, cuda_cell_bwd, head


def _cell_fn(plain: bool):
    cell_fn = functools.partial(cuda_cell_bwd.differentiable_scan_layer,
                                plain=plain)
    # both layer hooks fuse the dropout of their output stream, with the
    # mask bits of pallas_cell.py:_keep_mask (the JAX dispatch.py:103-106)
    cell_fn.fused_dropout = True
    cell_fn.embed_layer0 = functools.partial(
        cuda_cell_bwd.differentiable_embed_layer0, plain=plain)
    fused_head = functools.partial(head.fused_head_bits, plain=plain)
    fused_head.supported = head.head_supported
    cell_fn.fused_head = fused_head
    return cell_fn


def select_cell_fn(backend: str, cfg: ModelConfig, batch: int, device="cuda"):
    """A ``cell_fn`` for ``models.lstm.forward``: the layers >= 1
    recurrence, differentiable, with ``.embed_layer0`` (the layer-0
    recurrence, differentiable), both taking ``dropout=(rate, seed)``
    (``.fused_dropout``), and ``.fused_head`` (the fused softmax
    cross-entropy head, which reads the masked top stream, with its
    ``.supported`` gate, which ``models.lstm.loss_fn`` checks per shape).

    ``"cuda"``: the kernels; raises unless ``device`` is a CUDA device.
    ``"plain"``: the kernels' plain versions, on any device. ``"auto"``: the
    kernels on a CUDA device, the plain versions on the CPU. The signature
    is the JAX package's; ``cfg`` and ``batch`` select nothing here, since
    the kernels take any batch and check the hidden width themselves."""
    del cfg, batch
    dev = torch.device(device)
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" else "plain"
    if backend == "plain":
        return _cell_fn(plain=True)
    if backend == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"cuda backend on device {dev}")
        return _cell_fn(plain=False)
    raise ValueError(f"unknown backend {backend!r}")
