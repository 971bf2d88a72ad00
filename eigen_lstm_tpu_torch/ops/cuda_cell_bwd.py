"""The layer-0 backward kernel, its plain version, and layer 0 as an
autograd function.

``embed_layer0_bwd`` replaces ``pallas_cell.py:_bwd_embed_fused_kernel``
(the backward of ``pallas_embed_layer0``'s custom VJP, ``:1027-1068``): from
the forward's residuals and the cotangents of (h_seq, hT, cT) it returns
dWU (M+N, 4N), db (4N,), dh0 and dc0 (B, N), all fp32. For a CUDA tensor
it launches ``lstm_bwd_embed_launch`` of ``csrc/lstm_bwd.cu`` or raises;
for a CPU tensor it runs ``embed_layer0_bwd_plain``, which repeats the
kernel's arithmetic: dg in fp32, db from the unrounded dg, dg rounded to
the compute type before dh_{t-1} = dg_c @ U_c^T, dU += round(h_{t-1})^T dg_c
and dW[ids_t] += dg_c, with h_{-1} = h0 and c_{-1} = c0.

``differentiable_embed_layer0`` is layer 0 as ``models.lstm.forward`` calls
it: the forward kernel (with residuals) and this backward inside a
``torch.autograd.Function`` when a gradient is wanted, the forward kernel
alone otherwise. Like the JAX custom VJP, it hands dW and dU back rounded
to the compute type (``dWU.astype(WU.dtype)``, ``pallas_cell.py:1039``).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import ModelConfig
from ..models.lstm import LayerParams
from . import _build
from . import cell as cell_ops
from . import cuda_cell


def embed_layer0_bwd_plain(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq,
                           dhT, dcT, cfg: ModelConfig, dg_out=None):
    """Plain version of the layer-0 backward kernel; ``dg_out`` as the
    kernel's."""
    af = cuda_cell._acc_dtype(cfg)
    s, b = ids.shape
    n = cfg.hidden
    U_a = U_c.to(af)
    dh, dc = dhT.to(af), dcT.to(af)
    dgs = [None] * s
    for t in reversed(range(s)):
        c_prev = c_seq[t - 1] if t > 0 else c0
        dg, dc = cell_ops.gate_bwd(
            g_seq[t].to(af), c_seq[t].to(af), c_prev.to(af),
            dh_seq[t].to(af) + dh, dc, n, cfg.cell_variant,
        )
        dgs[t] = dg
        dh = dg.to(cfg.cdtype).to(af) @ U_a.T
    if dg_out is not None:
        dg_out.copy_(torch.stack(dgs))
    dg = torch.stack(dgs).reshape(s * b, 4 * n)
    dg_c = dg.to(cfg.cdtype).to(af)
    h_prev = torch.cat([h0.to(af)[None], h_seq[:-1].to(af)]).reshape(s * b, n)
    dU = h_prev.to(cfg.cdtype).to(af).T @ dg_c
    dW = torch.zeros(cfg.vocab, 4 * n, dtype=af, device=dg.device)
    dW.index_add_(0, ids.reshape(-1).long(), dg_c)
    return torch.cat([dW, dU]), dg.sum(0), dh, dc


def _validate(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq, dhT, dcT,
              cfg: ModelConfig):
    s, b = ids.shape
    n = cfg.hidden
    expected = (("U", U_c, (n, 4 * n)), ("g_seq", g_seq, (s, b, 4 * n)),
                ("c_seq", c_seq, (s, b, n)), ("h_seq", h_seq, (s, b, n)),
                ("h0", h0, (b, n)), ("c0", c0, (b, n)),
                ("dh_seq", dh_seq, (s, b, n)), ("dhT", dhT, (b, n)),
                ("dcT", dcT, (b, n)))
    for name, x, shape in expected:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != ids.device:
            raise ValueError(f"{name} on {x.device}, ids on {ids.device}")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f"ids must be integer byte ids, got {ids.dtype}")


def embed_layer0_bwd(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq, dhT, dcT,
                     cfg: ModelConfig, dg_out=None):
    """Layer-0 backward: the kernel on a CUDA tensor, the plain version on
    a CPU tensor. U_c: (N, 4N) in the compute type; g_seq (S, B, 4N), c_seq
    and h_seq (S, B, N) in the residual type; ids (S, B); h0, c0, dh_seq,
    dhT, dcT fp32. Returns (dWU (M+N, 4N), db (4N,), dh0, dc0) in fp32.
    ``dg_out``, an (S, B, 4N) fp32 tensor, receives the dg sequence (for
    a check that replays each step from it)."""
    _validate(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq, dhT, dcT, cfg)
    if ids.device.type == "cpu":
        return embed_layer0_bwd_plain(U_c, g_seq, c_seq, h_seq, ids, h0, c0,
                                      dh_seq, dhT, dcT, cfg, dg_out)
    ctype, rtype = cuda_cell._kernel_types(cfg, ids.device)
    s, b = ids.shape
    n, m = cfg.hidden, cfg.vocab
    dev = ids.device
    f32 = dict(dtype=torch.float32, device=dev)
    UT = U_c.to(cfg.cdtype).t().contiguous()
    seqs = [x.to(cfg.rdtype).contiguous() for x in (g_seq, c_seq, h_seq)]
    ins = [x.to(torch.float32).contiguous() for x in (h0, c0, dh_seq, dhT)]
    ids32 = ids.to(torch.int32).contiguous()
    dc = dcT.to(torch.float32).clone().contiguous()
    dg = torch.empty(s, b, 4 * n, **f32) if dg_out is None else dg_out
    if tuple(dg.shape) != (s, b, 4 * n) or dg.dtype != torch.float32 \
            or dg.device != dev or not dg.is_contiguous():
        raise ValueError("dg_out must be a contiguous (S, B, 4N) fp32 tensor "
                         "on the device of ids")
    dWU = torch.empty(m + n, 4 * n, **f32)
    db = torch.empty(4 * n, **f32)
    dh0 = torch.empty(b, n, **f32)
    lib = _build.load_library()
    work = torch.empty(max(1, lib.lstm_bwd_embed_work_floats(s, b, n)), **f32)
    launched = ctypes.c_int(0)
    err = lib.lstm_bwd_embed_launch(
        ctype, rtype, UT.data_ptr(), *(x.data_ptr() for x in seqs),
        ids32.data_ptr(), *(x.data_ptr() for x in ins), dc.data_ptr(),
        dg.data_ptr(), dWU.data_ptr(), db.data_ptr(), dh0.data_ptr(),
        work.data_ptr(), s, b, n, m, int(cfg.cell_variant == "standard"),
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched),
    )
    embed_layer0_bwd.launches += launched.value
    cuda_cell._raise_on(err, "lstm_bwd_embed_launch")
    return dWU, db, dh0, dc


embed_layer0_bwd.launches = 0


class EmbedLayer0(torch.autograd.Function):
    """Layer 0 with the embedding fused in, differentiable in W, U, b, h0
    and c0: the forward kernel with residuals, then ``embed_layer0_bwd``.
    With ``plain`` both halves run their plain versions, on any device."""

    @staticmethod
    def forward(ctx, W, U, b, ids, h0, c0, cfg: ModelConfig, plain: bool):
        layer = LayerParams(W, U, b)
        fwd = cuda_cell.embed_layer0_plain if plain else cuda_cell.embed_layer0
        h_seq, (hT, cT), c_seq, g_seq = fwd(layer, ids, h0, c0, cfg,
                                            residuals=True)
        ctx.save_for_backward(U, h_seq, c_seq, g_seq, ids, h0, c0)
        ctx.cfg, ctx.plain = cfg, plain
        ctx.dtypes = (W.dtype, U.dtype, b.dtype, h0.dtype, c0.dtype)
        return h_seq, hT, cT

    @staticmethod
    def backward(ctx, dh_seq, dhT, dcT):
        U, h_seq, c_seq, g_seq, ids, h0, c0 = ctx.saved_tensors
        cfg = ctx.cfg
        f32 = torch.float32

        def cot(x, like):
            # an output autograd did not reach has no cotangent; hT and cT
            # left the forward in the residual type, as in the JAX VJP
            if x is None:
                return torch.zeros(like.shape, dtype=f32, device=like.device)
            return x.to(cfg.rdtype).to(f32)

        bwd = embed_layer0_bwd_plain if ctx.plain else embed_layer0_bwd
        m = cfg.vocab
        dWU, db, dh0, dc0 = bwd(
            U.to(cfg.cdtype), g_seq, c_seq, h_seq, ids, h0.to(f32),
            c0.to(f32),
            (torch.zeros(h_seq.shape, dtype=f32, device=h_seq.device)
             if dh_seq is None else dh_seq.to(f32)),
            cot(dhT, h0), cot(dcT, c0), cfg,
        )
        dWU = dWU.to(cfg.cdtype)
        wd, ud, bd, hd, cd = ctx.dtypes
        return (dWU[:m].to(wd), dWU[m:].to(ud), db.to(bd), None,
                dh0.to(hd), dc0.to(cd), None, None)


def differentiable_embed_layer0(layer, ids, h0, c0, cfg: ModelConfig,
                                plain: bool = False):
    """``cell_fn.embed_layer0`` of ``ops.dispatch``: (h_seq, (hT, cT)) of
    layer 0, through ``EmbedLayer0`` when autograd needs a gradient of its
    inputs, else through the forward kernel alone (no residuals)."""
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (layer.W, layer.U, layer.b, h0, c0)
    ):
        h_seq, hT, cT = EmbedLayer0.apply(layer.W, layer.U, layer.b, ids, h0,
                                          c0, cfg, plain)
        return h_seq, (hT, cT)
    fwd = cuda_cell.embed_layer0_plain if plain else cuda_cell.embed_layer0
    return fwd(layer, ids, h0, c0, cfg)
