"""The sequence-level tensor-parallel kernels (K15, K16), their plain
versions and the whole-window TP recurrence as an autograd function: the
port's ``eigen_lstm_tpu/ops/pallas_tp_seq.py``.

``tp_seq_fwd`` (K15) replaces ``_fwd_kernel`` (:59): the S-step window of
one shard in one launch, from U_d in the compute type, xw (S, B, 4nd) in
fp32 with the bias, the full h0 (B, N) and c0 (B, nd) in fp32. Each step
rounds the carried h and c to the param type (:85-86), feeds the product
h rounded to the compute type (the exchange buffer's type), and stores
h_seq in the param type, g (activated) and c_prev in the residual type
(:243-244); hT and cT leave in the accumulation type. ``tp_seq_bwd`` (K16)
replaces ``_bwd_kernel`` (:125): the reverse window, dh_t = dh_seq[t] +
(dhT at t = S-1, else the reduce-scattered round(dg_{t+1}) @ U_d^T), the
gate backward, dg (S, B, 4nd) in fp32, dh0 and dc0. For a CUDA tensor each
launches its kernel at D = 1, and raises at D > 1:
the kernels' in-kernel exchange of h across D cards (the TPU kernel's
remote DMAs) is not written; there is no fall-back. For a CPU tensor each
runs its plain version, ``tp_seq_fwd_plain`` or ``tp_seq_bwd_plain``: the
per-step math of ``pallas_tp_cell.py`` over the window with the h exchange
as an all-gather over the group and the dh partials reduce-scattered, so
the plain versions are exact at any D. Each wrapper counts its launches in
``.launches``, one a call.

K15 has two designs of one function, both behind ``tp_seq_fwd_launch`` of
``csrc/lstm_tp.cu``. Under bf16 compute, wherever
``cuda_cell_tiled.split_fwd_plan`` gives a layout, it is the persistent
tensor-core forward of K8/K9 (``csrc/fwd_mma.cuh:fwd_persist``: U's rows
in shared memory, the products on tensor cores, a share of the batch rows
a block) with K15's own streams: xw in fp32 with the bias, the exchange
buffer's round(h) in the compute type, h_seq in fp32, g and c_prev =
c_{t-1} in the residual type; only the order of the product's fp32 sums
moves. Elsewhere (fp32) it is one cooperative launch of CUDA-core step
tiles. K16 has two designs of one function too. At D = 1 it is K6's reverse recurrence, so under bf16
compute, wherever ``cuda_cell_bwd.k6_plan`` gives a layout, it is K6's
persistent kernel (``lstm_bwd_persist_launch``: U in shared memory, dh_rec
on tensor cores, dg written in fp32 as well), given K16's c layout without
a copy of the stream: c_prev advanced by one step as c_seq, c_prev[0] as
c0 and cT, in fp32, as c_{S-1}. Elsewhere (fp32, or no layout) it is
``tp_seq_bwd_launch``, one cooperative launch of CUDA-core step tiles over
U^T.

``tp_seq_lstm`` is the JAX function of that name: U cast to the compute
type and xw, h0, c0 to the accumulation type before ``TPSeq``, whose
backward is ``tp_seq_bwd`` (:305-338): K16 gives dg, dh0, dc0, and dU is
one product outside, round(h_prev)^T round(dg) over the window with fp32
sums, h_prev rebuilt from h_seq (all-gathered) and the full h0. dU leaves
in U's type, the compute type (bf16 under bf16 compute: this family rounds
dU, the per-step family does not). ``tp_seq_supported`` is the JAX gate
with its 14 MB VMEM budget, copied to pick the family as the JAX package
does; the budget describes the TPU, not the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import ModelConfig, _DTYPES
from ..parallel import mesh
from . import _build
from . import cell as cell_ops
from . import cuda_cell
from . import cuda_cell_bwd
from . import cuda_cell_tiled as ct
from .cuda_tp_cell import _card, _check, _stream, tp_step_bwd_plain, tp_step_plain

VMEM_BUDGET = 14 * 1024 * 1024   # pallas_tp_seq.py:56


def _size(name: str) -> int:
    return torch.finfo(_DTYPES[name]).bits // 8


def tp_seq_supported(cfg: ModelConfig, batch: int, ndev: int) -> bool:
    """``pallas_tp_seq.py:tp_seq_supported``: shard slices 128-lane
    aligned, the batch a multiple of 8, and both kernels' VMEM reckoning
    within the budget."""
    if cfg.hidden % ndev != 0:
        return False
    nd = cfg.hidden // ndev
    if nd % 128 != 0 or batch % 8 != 0:
        return False
    n, b = cfg.hidden, batch
    csz, rsz = _size(cfg.compute_dtype), _size(cfg.residual_dtype)
    fwd = (n * 4 * nd * csz + 3 * b * n * csz + 2 * b * 4 * nd * 4
           + b * 4 * nd * rsz + 4 * b * nd * 4)
    bwd = (n * 4 * nd * csz + b * n * 4 + 3 * ndev * b * nd * 4
           + 2 * b * 4 * nd * (rsz + 4) + 6 * b * nd * 4)
    return max(fwd, bwd) <= VMEM_BUDGET


def tp_seq_fwd_plain(U_c, xw, h0_full, c0, cfg: ModelConfig,
                     group: Optional[mesh.TPGroup] = None):
    """The window of one shard: (h_seq (S, B, nd) in the param type, g
    (S, B, 4nd) and c_prev (S, B, nd) in the residual type, hT, cT)."""
    af, pd, rd = cuda_cell._acc_dtype(cfg), cfg.pdtype, cfg.rdtype
    h_full, c = h0_full.to(cfg.cdtype), c0.to(af)
    hs, gs, cps = [], [], []
    s = xw.shape[0]
    for t in range(s):
        cps.append(c.to(rd))
        h2, c2, g = tp_step_plain(U_c, xw[t], h_full, c, cfg)
        h2r, c2r = h2.to(pd), c2.to(pd)
        gs.append(g.to(rd))
        hs.append(h2r)
        c = c2r.to(af)
        if t < s - 1:
            h_full = mesh.all_gather(h2r.to(cfg.cdtype), 1, group)
    return (torch.stack(hs), torch.stack(gs), torch.stack(cps), h2r.to(af),
            c2r.to(af))


def tp_seq_bwd_plain(U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT,
                     cfg: ModelConfig, group: Optional[mesh.TPGroup] = None):
    """The reverse window of one shard: (dg (S, B, 4nd), dh0, dc0)."""
    af = cuda_cell._acc_dtype(cfg)
    s = g_seq.shape[0]
    dc, rec = dcT.to(af), dhT.to(af)
    dgs = [None] * s
    for t in reversed(range(s)):
        c2 = cT if t == s - 1 else c_prev[t + 1]
        dgs[t], dc = tp_step_bwd_plain(g_seq[t], c2, c_prev[t],
                                       dh_seq[t].to(af) + rec, dc, cfg)
        partial = cell_ops.matmul(dgs[t], U_c.T, cfg.cdtype, af)
        rec = mesh.reduce_scatter(partial, 1, group)
    return torch.stack(dgs), rec, dc


def _d1(group, dev, what: str):
    if group is not None and group.size > 1:
        raise NotImplementedError(
            f"{what} at D = {group.size} on {dev}: the kernel's exchange of h "
            f"across the D cards (the TPU kernel's in-kernel remote copies, "
            f"pallas_tp_seq.py:96-120, :157-177) is not written; it needs "
            f"D GPUs")


def tp_seq_fwd(U_c, xw, h0_full, c0, cfg: ModelConfig,
               group: Optional[mesh.TPGroup] = None):
    """The TP window: K15 on the card (D = 1), in the design
    ``cuda_cell_tiled.device_split_fwd_plan`` gives, the plain version on
    the CPU. Returns as ``tp_seq_fwd_plain``."""
    s, b, nd4 = xw.shape
    nd = nd4 // 4
    n = h0_full.shape[1]
    dev = xw.device
    for name, x, shape in (("U", U_c, (n, 4 * nd)), ("h0_full", h0_full, (b, n)),
                           ("c0", c0, (b, nd))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return tp_seq_fwd_plain(U_c, xw, h0_full, c0, cfg, group)
    _d1(group, dev, "K15")
    ctype = _card(cfg, dev, nd)
    if cfg.pdtype != torch.float32 or cfg.rdtype not in cuda_cell._TYPE_CODES:
        raise TypeError(f"K15 takes float32 params and float32/bfloat16 "
                        f"residuals, not {cfg.param_dtype}/{cfg.residual_dtype}")
    rtype = cuda_cell._TYPE_CODES[cfg.rdtype]
    lib = _build.load_library()
    layout = ct.device_split_fwd_plan(cfg, b, n)   # D = 1: nd == n
    f32 = torch.float32
    U_k = ct._aligned(U_c.to(cfg.cdtype))
    xw32 = ct._aligned(xw.to(f32))
    hbuf = torch.empty(2, b, n, dtype=cfg.cdtype, device=dev)
    hbuf[0] = h0_full
    c = c0.to(f32).clone().contiguous()
    h_seq = torch.empty(s, b, nd, dtype=f32, device=dev)
    g_seq = torch.empty(s, b, 4 * nd, dtype=cfg.rdtype, device=dev)
    c_prev = torch.empty(s, b, nd, dtype=cfg.rdtype, device=dev)
    hT, cT = (torch.empty(b, nd, dtype=f32, device=dev) for _ in range(2))
    launched = ctypes.c_int(0)
    err = lib.tp_seq_fwd_launch(
        ctype, rtype, U_k.data_ptr(), xw32.data_ptr(), hbuf.data_ptr(),
        c.data_ptr(), h_seq.data_ptr(), g_seq.data_ptr(), c_prev.data_ptr(),
        hT.data_ptr(), cT.data_ptr(), s, b, n, nd,
        int(cfg.cell_variant == "standard"), *(layout or (-1, 0)),
        _stream(dev), ctypes.byref(launched))
    tp_seq_fwd.launches += launched.value
    cuda_cell._raise_on(err, "tp_seq_fwd_launch")
    return h_seq, g_seq, c_prev, hT, cT


def tp_seq_bwd(U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT, cfg: ModelConfig,
               group: Optional[mesh.TPGroup] = None):
    """The TP reverse window: K16 on the card (D = 1), in the design
    ``cuda_cell_bwd.device_k6_plan`` gives, the plain version on the CPU.
    Returns as ``tp_seq_bwd_plain``."""
    s, b, nd4 = g_seq.shape
    nd = nd4 // 4
    n = U_c.shape[0]
    dev = g_seq.device
    for name, x, shape in (("U", U_c, (n, 4 * nd)), ("c_prev", c_prev, (s, b, nd)),
                           ("cT", cT, (b, nd)), ("dh_seq", dh_seq, (s, b, nd)),
                           ("dhT", dhT, (b, nd)), ("dcT", dcT, (b, nd))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return tp_seq_bwd_plain(U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT, cfg,
                                group)
    _d1(group, dev, "K16")
    ctype = _card(cfg, dev, nd)
    if g_seq.dtype not in cuda_cell._TYPE_CODES or c_prev.dtype != g_seq.dtype:
        raise TypeError(f"K16 takes float32/bfloat16 residuals, got "
                        f"{g_seq.dtype}/{c_prev.dtype}")
    rtype = cuda_cell._TYPE_CODES[g_seq.dtype]
    lib = _build.load_library()
    f32 = torch.float32
    gs, cs = g_seq.contiguous(), c_prev.contiguous()
    cT32, dh32, dhT32 = (x.to(f32).contiguous() for x in (cT, dh_seq, dhT))
    dc = dcT.to(f32).clone().contiguous()
    dg = torch.empty(s, b, 4 * nd, dtype=f32, device=dev)
    dh0 = torch.empty(b, nd, dtype=f32, device=dev)
    plan = cuda_cell_bwd.device_k6_plan(cfg, b, nd)
    if plan is not None:
        # K6's persistent reverse launch: U as it is, c_seq = c_prev advanced
        # a step (c_seq[t] = c_prev[t + 1] below S-1), c0 = c_prev[0], c_{S-1}
        # = cT; the fp32 dg into dg, its bf16 rounding (which the next step's
        # product reads) into a scratch; no db, no dropout, a step at a time
        name = "lstm_bwd_persist_launch"
        U_k, c0 = U_c.to(torch.bfloat16).contiguous(), cs[0].to(f32)
        dgx = torch.empty(s, b, 4 * nd, dtype=torch.bfloat16, device=dev)
        err = lib.lstm_bwd_persist_launch(
            rtype, U_k.data_ptr(), gs.data_ptr(), cs[1:].data_ptr(),
            c0.data_ptr(), cT32.data_ptr(), dh32.data_ptr(), dhT32.data_ptr(),
            dc.data_ptr(), dgx.data_ptr(), dg.data_ptr(), dh0.data_ptr(),
            None, None, s, b, nd, *plan, 1,
            int(cfg.cell_variant == "standard"), 0, 0, 0, 0, 0.0, _stream(dev),
            ctypes.byref(ctypes.c_int(0)))
    else:
        name = "tp_seq_bwd_launch"
        UT = U_c.to(cfg.cdtype).T.contiguous()
        err = lib.tp_seq_bwd_launch(
            ctype, rtype, UT.data_ptr(), gs.data_ptr(), cs.data_ptr(),
            cT32.data_ptr(), dh32.data_ptr(), dhT32.data_ptr(), dc.data_ptr(),
            dg.data_ptr(), dh0.data_ptr(), s, b, n, nd,
            int(cfg.cell_variant == "standard"), _stream(dev))
    cuda_cell._raise_on(err, name)
    tp_seq_bwd.launches += 1
    return dg, dh0, dc


tp_seq_fwd.launches = 0
tp_seq_bwd.launches = 0


class TPSeq(torch.autograd.Function):
    """The window of one shard, differentiable in U_c, xw, h0_d and c0_d:
    the JAX custom VJP of ``_make_tp_seq``. With ``plain`` both halves run
    their plain versions, on any device."""

    @staticmethod
    def forward(ctx, U_c, xw, h0_d, c0_d, cfg: ModelConfig, group, plain):
        h0_full = mesh.all_gather(h0_d, 1, group)
        fwd = tp_seq_fwd_plain if plain else tp_seq_fwd
        h_seq, g_seq, c_prev, hT, cT = fwd(U_c, xw, h0_full, c0_d, cfg, group)
        ctx.save_for_backward(U_c, g_seq, c_prev, cT, h0_full, h_seq)
        ctx.cfg, ctx.group, ctx.plain = cfg, group, plain
        ctx.dtypes = (xw.dtype, h0_d.dtype, c0_d.dtype)
        return h_seq, hT, cT

    @staticmethod
    def backward(ctx, dh_seq, dhT, dcT):
        U_c, g_seq, c_prev, cT, h0_full, h_seq = ctx.saved_tensors
        cfg, group = ctx.cfg, ctx.group
        af = cuda_cell._acc_dtype(cfg)
        zeros = lambda like: torch.zeros(like.shape, dtype=af, device=like.device)
        dh_seq = zeros(h_seq) if dh_seq is None else dh_seq.to(af)
        dhT = zeros(cT) if dhT is None else dhT.to(af)
        dcT = zeros(cT) if dcT is None else dcT.to(af)
        bwd = tp_seq_bwd_plain if ctx.plain else tp_seq_bwd
        dg, dh0, dc0 = bwd(U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT, cfg, group)
        s, b, nd4 = dg.shape
        h_all = mesh.all_gather(h_seq, 2, group)
        h_prev = torch.cat([h0_full[None].to(h_all.dtype), h_all[:-1]])
        dU = cell_ops.matmul(h_prev.reshape(s * b, -1).T, dg.reshape(s * b, nd4),
                             cfg.cdtype, af)
        xd, hd, cd = ctx.dtypes
        return dU.to(U_c.dtype), dg.to(xd), dh0.to(hd), dc0.to(cd), None, None, None


def tp_seq_lstm(U, xw, h0_d, c0_d, cfg: ModelConfig,
                group: Optional[mesh.TPGroup] = None, plain: bool = False):
    """``pallas_tp_seq.py:tp_seq_lstm``: (h_seq_d (S, B, nd), (hT, cT) in
    the param type) of one shard's window, through ``TPSeq`` when autograd
    needs a gradient, else the forward alone."""
    af = cuda_cell._acc_dtype(cfg)
    args = (U.to(cfg.cdtype), xw.to(af), h0_d.to(af), c0_d.to(af))
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        h_seq, hT, cT = TPSeq.apply(*args, cfg, group, plain)
    else:
        U_c, xw_a, h0_a, c0_a = args
        fwd = tp_seq_fwd_plain if plain else tp_seq_fwd
        h_seq, _, _, hT, cT = fwd(U_c, xw_a, mesh.all_gather(h0_a, 1, group),
                                  c0_a, cfg, group)
    return h_seq, (hT.to(cfg.pdtype), cT.to(cfg.pdtype))
