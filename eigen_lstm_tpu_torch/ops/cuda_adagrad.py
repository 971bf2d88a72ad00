"""The fused Adagrad kernel and its plain version, the port's
``eigen_lstm_tpu/ops/pallas_adagrad.py``.

``adagrad_update_fused`` (K11) replaces ``pallas_adagrad.py:_adagrad_kernel``
with the JAX function's signature: (new params, new accumulators) from
``LSTMParams``-shaped params, gradients and accumulators, m' = m + g^2 and
p' = p - lr * g * rsqrt(m' + eps). For CUDA tensors it launches
``adagrad_plan_launch`` of ``csrc/adagrad.cu`` once for the whole parameter
set, out of place, or raises: the kernel takes fp32 tensors, which is what
the trainer holds (its leaves are ``param_dtype`` float32 and autograd
returns gradients of the leaf's type). For CPU tensors it runs
``adagrad_update_plain``, the JAX ``train/optimizer.py:adagrad_update`` in
torch ops, of any floating type.

The call path is planned once per layout of the set (``AdagradPlan``: the
device and each tensor's shape and dtype, for ``LSTMParams`` of any depth,
TP shards or PP's ``PPParams``): the checks run when a layout is first
seen, and a set that matches no plan is checked again, so a mismatch
raises before any launch. A call then fills the plan's address table in
place, allocates two arenas (every p' in one, every m' in the other, each
tensor at a 16-byte offset) and returns views of them. Nothing downstream
needs an output to own its storage: the trainer's leaves are
``p.detach().requires_grad_()``, checkpoints copy to numpy, and the
parallel paths clone or slice.

``adagrad_update_first`` is K11's first call path (the same kernel through
``adagrad_launch``: 3n ``contiguous`` calls, 2n allocations and a new table
of 6n entries a call), kept as the forced control that ``chip_smoke.py``
times beside the plan's; the trainer never calls it.

Each wrapper counts its kernel launches in its ``launches``.
"""

from __future__ import annotations

import ctypes
import operator
import threading
from typing import Optional, Tuple

import torch

from ..models.lstm import LSTMParams, like, tensors
from . import _build
from . import cuda_cell

ALIGN = 4   # elements: every output starts 16 bytes into its arena


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


def _check(ps, gs, ms) -> torch.device:
    """Raises unless grads and m match params tensor for tensor in shape
    and device; returns the device."""
    dev = ps[0].device
    if not len(ps) == len(gs) == len(ms):
        raise ValueError(f"params has {len(ps)} tensors, grads {len(gs)}, "
                         f"m {len(ms)}")
    for name, group in (("params", ps), ("grads", gs), ("m", ms)):
        for p, x in zip(ps, group):
            if x.shape != p.shape or x.device != dev:
                raise ValueError(f"{name} has a {tuple(x.shape)} tensor on "
                                 f"{x.device} where params has "
                                 f"{tuple(p.shape)} on {dev}")
    return dev


def _check_card(dev, xs):
    """Raises unless ``dev`` is a card and every tensor is float32."""
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError("the Adagrad kernel takes float32 params, gradients "
                        "and accumulators, got "
                        f"{sorted({str(x.dtype) for x in xs})}")


class AdagradPlan:
    """K11's call path for one layout of the parameter set, built once:
    each tensor's shape, contiguous strides, numel and offset in the
    output arenas (rounded up to ``ALIGN`` elements), the arenas' size,
    and the ctypes tables handed to ``adagrad_plan_launch``: the layout's
    (numel, offset) pairs, fixed, and the 3n input addresses, filled in
    place on each call (under a lock: the table is shared)."""

    def __init__(self, ps):
        self.count = len(ps)
        self.shapes = [p.shape for p in ps]
        self.strides = [torch.empty(s, device="meta").stride()
                        for s in self.shapes]
        self.offsets, total = [], 0
        for p in ps:
            total += -total % ALIGN
            self.offsets.append(total)
            total += p.numel()
        self.total = total
        self.layout = (ctypes.c_longlong * (2 * self.count))(*(
            v for p, off in zip(ps, self.offsets) for v in (p.numel(), off)))
        self.ins = (ctypes.c_uint64 * (3 * self.count))()
        self.launched = ctypes.c_int(0)
        self.launched_ref = ctypes.byref(self.launched)
        self.lock = threading.Lock()

    def views(self, arena):
        """The outputs: views of ``arena`` in the parameters' shapes, at
        the plan's offsets."""
        return list(map(arena.as_strided, self.shapes, self.strides,
                        self.offsets))


_PLANS = {}
_SIGNATURE = operator.attrgetter("shape", "dtype", "device")
_DATA_PTR = torch.Tensor.data_ptr
_CONTIGUOUS = torch.Tensor.is_contiguous


def _stream(dev: torch.device) -> int:
    """The handle of the current stream on ``dev``: torch's raw accessor,
    as its compiled kernels read it (``torch.cuda.current_stream`` builds
    a Stream object on every call, 3-5 µs of the call on an H100's
    host)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def plan_for(ps, gs, ms) -> Optional[AdagradPlan]:
    """The plan of the set (params ``ps``, grads ``gs``, accumulators
    ``ms``), built and cached when its layout is first seen; None for a
    CPU set. Raises, before any launch, for a set the kernel does not
    take: the key holds every tensor's shape, dtype and device, so a set
    that differs from a cached plan in any of them is checked again."""
    key = tuple(map(_SIGNATURE, ps + gs + ms))
    plan = _PLANS.get(key)
    if plan is None:
        dev = _check(ps, gs, ms)
        if dev.type == "cpu":
            return None
        _check_card(dev, ps + gs + ms)
        plan = _PLANS[key] = AdagradPlan(ps)
    return plan


def adagrad_update_fused(params: LSTMParams, grads: LSTMParams,
                         m: LSTMParams, lr, eps: float = 1e-10
                         ) -> Tuple[LSTMParams, LSTMParams]:
    """One Adagrad step: the kernel for CUDA tensors (one launch for the
    set, through the layout's plan), the plain version for CPU tensors.
    ``lr``: the host's fp32 lr (``optimizer.schedule_lr``)."""
    ps, gs, ms = tensors(params), tensors(grads), tensors(m)
    plan = plan_for(ps, gs, ms)
    if plan is None:
        return adagrad_update_plain(params, grads, m, lr, eps)
    xs = ps + gs + ms
    if not all(map(_CONTIGUOUS, xs)):
        xs = [x.contiguous() for x in xs]
    p0 = ps[0]
    new_p, new_m = p0.new_empty(plan.total), p0.new_empty(plan.total)
    lib = _build.load_library()
    stream = _stream(p0.device)
    with plan.lock:
        plan.ins[:] = list(map(_DATA_PTR, xs))
        plan.launched.value = 0
        err = lib.adagrad_plan_launch(plan.count, plan.ins, plan.layout,
                                      new_p.data_ptr(), new_m.data_ptr(),
                                      float(lr), float(eps), stream,
                                      plan.launched_ref)
        adagrad_update_fused.launches += plan.launched.value
    cuda_cell._raise_on(err, "adagrad_plan_launch")
    return like(params, plan.views(new_p)), like(m, plan.views(new_m))


adagrad_update_fused.launches = 0


def adagrad_update_first(params: LSTMParams, grads: LSTMParams,
                         m: LSTMParams, lr, eps: float = 1e-10
                         ) -> Tuple[LSTMParams, LSTMParams]:
    """K11's first call path on CUDA tensors, the forced control: the
    checks on every call, the inputs made contiguous, 2n outputs of their
    own and a new table of (p, g, m, p_out, m_out, numel) for
    ``adagrad_launch``. The same kernel and bits as
    ``adagrad_update_fused``."""
    ps, gs, ms = tensors(params), tensors(grads), tensors(m)
    dev = _check(ps, gs, ms)
    _check_card(dev, ps + gs + ms)
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
    adagrad_update_first.launches += launched.value
    cuda_cell._raise_on(err, "adagrad_launch")
    return like(params, new_p), like(m, new_m)


adagrad_update_first.launches = 0
