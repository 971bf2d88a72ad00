"""The fused Adagrad kernel and its plain version, the port's
``eigen_lstm_tpu/ops/pallas_adagrad.py``.

``adagrad_update_fused`` (K11) replaces ``pallas_adagrad.py:_adagrad_kernel``
with the JAX function's signature: (new params, new accumulators) from
``LSTMParams``-shaped params, gradients and accumulators, m' = m + g^2 and
p' = p - lr * g * rsqrt(m' + eps). For CUDA tensors it launches
``adagrad_launch`` of ``csrc/adagrad.cu`` once for the whole parameter set,
out of place, or raises: the kernel takes fp32 tensors, which is what the
trainer holds (its leaves are ``param_dtype`` float32 and autograd returns
gradients of the leaf's type). For CPU tensors it runs
``adagrad_update_plain``, the JAX ``train/optimizer.py:adagrad_update`` in
torch ops, of any floating type.

Each call counts its kernel launches in ``adagrad_update_fused.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..models.lstm import LSTMParams, like, tensors
from . import _build
from . import cuda_cell


def adagrad_update_plain(params: LSTMParams, grads: LSTMParams,
                         m: LSTMParams, lr, eps: float = 1e-10
                         ) -> Tuple[LSTMParams, LSTMParams]:
    """One Adagrad step in torch ops, tensor by tensor: (new params, new
    accumulators). rsqrt reads the accumulator as stored in m's type."""
    f32 = torch.float32
    new_m, new_p = [], []
    for p, g, mm in zip(tensors(params), tensors(grads), tensors(m)):
        g32 = g.to(f32)
        m2 = mm.to(f32) + torch.square(g32)
        new_m.append(m2.to(mm.dtype))
        step = float(lr) * g32 * torch.rsqrt(new_m[-1].to(f32) + eps)
        new_p.append((p.to(f32) - step).to(p.dtype))
    return like(params, new_p), like(m, new_m)


def adagrad_update_fused(params: LSTMParams, grads: LSTMParams,
                         m: LSTMParams, lr, eps: float = 1e-10
                         ) -> Tuple[LSTMParams, LSTMParams]:
    """One Adagrad step: the kernel for CUDA tensors (one launch for the
    set), the plain version for CPU tensors. ``lr``: the host's fp32 lr
    (``optimizer.schedule_lr``)."""
    ps, gs, ms = tensors(params), tensors(grads), tensors(m)
    dev = ps[0].device
    for name, group in (("params", ps), ("grads", gs), ("m", ms)):
        for p, x in zip(ps, group):
            if x.shape != p.shape or x.device != dev:
                raise ValueError(f"{name} has a {tuple(x.shape)} tensor on "
                                 f"{x.device} where params has "
                                 f"{tuple(p.shape)} on {dev}")
    if dev.type == "cpu":
        return adagrad_update_plain(params, grads, m, lr, eps)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if any(x.dtype != torch.float32 for x in ps + gs + ms):
        raise TypeError("the Adagrad kernel takes float32 params, gradients "
                        "and accumulators, got "
                        f"{sorted({str(x.dtype) for x in ps + gs + ms})}")
    ins = [(p.contiguous(), g.contiguous(), mm.contiguous())
           for p, g, mm in zip(ps, gs, ms)]
    new_p = [torch.empty_like(p) for p, _, _ in ins]
    new_m = [torch.empty_like(mm) for _, _, mm in ins]
    table = (ctypes.c_uint64 * (6 * len(ins)))(*(
        v for (p, g, mm), p2, m2 in zip(ins, new_p, new_m)
        for v in (p.data_ptr(), g.data_ptr(), mm.data_ptr(), p2.data_ptr(),
                  m2.data_ptr(), p.numel())))
    lib = _build.load_library()
    launched = ctypes.c_int(0)
    err = lib.adagrad_launch(len(ins), table, float(lr), float(eps),
                             torch.cuda.current_stream(dev).cuda_stream,
                             ctypes.byref(launched))
    adagrad_update_fused.launches += launched.value
    cuda_cell._raise_on(err, "adagrad_launch")
    return like(params, new_p), like(m, new_m)


adagrad_update_fused.launches = 0
