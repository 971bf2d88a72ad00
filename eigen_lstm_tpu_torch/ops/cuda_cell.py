"""The forward recurrence kernels of the port and their plain versions.

``embed_layer0`` and ``scan_layer`` replace ``pallas_embed_layer0`` and
``pallas_scan_layer`` of ``eigen_lstm_tpu/ops/pallas_cell.py``, with the same
return contract: ``(h_seq (S, B, N) in residual type, (hT, cT) in param
type)``. For a CUDA tensor they launch the kernel of ``csrc/lstm_fwd.cu``
or raise; for a CPU tensor they run the plain version beside them, which
repeats the kernel's arithmetic in PyTorch:

* layer 0: g = W_c[ids_t] + round_c(h_{t-1}) @ U_c + b, with W and U
  rounded to the compute type c and b in fp32 (``pallas_cell.py:1143``,
  ``:524-528``);
* layers >= 1: g = xw_t + round_c(h_{t-1}) @ U_c, with xw rounded to bf16
  under bf16 compute (``pallas_cell.py:475``);
* products in fp32 (float64 in the float64 oracle configuration), the
  carry in fp32 between steps, the sequences stored in the residual type.

Each wrapper counts in ``.launches`` the kernel launches it makes: S per
call, one per timestep.

None of these functions is differentiable by itself, and each raises when
asked for a gradient rather than return a result that autograd cannot
follow: the gradient of layer 0 goes through ``cuda_cell_bwd`` (its
backward kernel), and the backward of layers >= 1 is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import ModelConfig
from . import _build
from . import cell as cell_ops

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.float64 if cfg.cdtype == torch.float64 else torch.float32


def _plain_recurrence(g_in, steps, U_c, h0, c0, cfg: ModelConfig,
                      residuals: bool):
    """g_pre_t = g_in(t) + round(h_{t-1}) @ U_c for t < steps, fp32 carry.
    ``g_in(t)`` gives the (B, 4N) input term of step t."""
    af = _acc_dtype(cfg)
    rd = cfg.rdtype
    n = cfg.hidden
    h, c = h0.to(af), c0.to(af)
    hs, cs, gs = [], [], []
    for t in range(steps):
        g_pre = g_in(t) + cell_ops.matmul(h, U_c, cfg.cdtype, af)
        g = cell_ops.gate_activations(g_pre, n)
        h, c = cell_ops.cell_update(g, c, n, cfg.cell_variant)
        hs.append(h.to(rd))
        if residuals:
            cs.append(c.to(rd))
            gs.append(g.to(rd))
    out = _finish(torch.stack(hs), h, c, cfg)
    if residuals:
        return out + (torch.stack(cs), torch.stack(gs))
    return out


def _finish(h_seq, hT, cT, cfg: ModelConfig):
    # (hT, cT) leave in the residual type, then the param type, as the JAX
    # kernels return h_seq[-1] and c_seq[-1]
    return h_seq, (hT.to(cfg.rdtype).to(cfg.pdtype),
                   cT.to(cfg.rdtype).to(cfg.pdtype))


def _embed_weights(layer, cfg: ModelConfig):
    """The stacked [W; U] in the compute type and the fp32 bias, as
    ``pallas_embed_layer0`` prepares them."""
    m = layer.W.shape[0]
    WU = torch.cat([layer.W, layer.U], dim=0).to(cfg.cdtype).contiguous()
    return WU[:m], WU[m:], layer.b.to(_acc_dtype(cfg)).contiguous()


def _refuse_grad(layer, seq, h0, c0, embed: bool):
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (layer.W, layer.U, layer.b, seq, h0, c0)
    ):
        raise NotImplementedError(
            "layer 0 is differentiated through "
            "ops.cuda_cell_bwd.differentiable_embed_layer0" if embed else
            "the backward of the layers >= 1 kernel is not ported yet"
        )


def embed_layer0_plain(layer, ids, h0, c0, cfg: ModelConfig,
                       residuals: bool = False):
    """Plain version of the layer-0 kernel. With ``residuals`` it also
    returns the (S, B, N) cell and (S, B, 4N) activated gate sequences."""
    _refuse_grad(layer, ids, h0, c0, embed=True)
    W_c, U_c, bias = _embed_weights(layer, cfg)
    af = _acc_dtype(cfg)
    ids = ids.long()
    return _plain_recurrence(lambda t: W_c[ids[t]].to(af) + bias,
                             ids.shape[0], U_c, h0, c0, cfg, residuals)


def _xw_stream(xw, cfg: ModelConfig):
    """xw as the kernel reads it: bf16 under bf16 compute, else the
    accumulation type."""
    return xw.to(torch.bfloat16 if cfg.cdtype == torch.bfloat16
                 else _acc_dtype(cfg)).contiguous()


def scan_layer_plain(layer, xw, h0, c0, cfg: ModelConfig,
                     residuals: bool = False):
    """Plain version of the layers >= 1 kernel (bias folded into xw)."""
    _refuse_grad(layer, xw, h0, c0, embed=False)
    U_c = layer.U.to(cfg.cdtype)
    xs = _xw_stream(xw, cfg)
    af = _acc_dtype(cfg)
    return _plain_recurrence(lambda t: xs[t].to(af), xs.shape[0], U_c,
                             h0, c0, cfg, residuals)


def _validate(layer, seq, h0, c0, cfg: ModelConfig, embed: bool):
    """Raises on inputs that neither the kernel nor its plain version
    takes: wrong shapes, types or devices, or a request for a gradient."""
    _refuse_grad(layer, seq, h0, c0, embed)
    n = cfg.hidden
    if embed:
        if seq.dim() != 2:
            raise ValueError(f"ids must be (S, B), got {tuple(seq.shape)}")
        if seq.dtype.is_floating_point or seq.dtype == torch.bool:
            raise TypeError(f"ids must be integer byte ids, got {seq.dtype}")
        w_shape = (layer.W.shape[0], 4 * n)
    else:
        if seq.dim() != 3 or seq.shape[2] != 4 * n:
            raise ValueError(f"xw must be (S, B, {4 * n}), got {tuple(seq.shape)}")
        if not seq.dtype.is_floating_point:
            raise TypeError(f"xw must be floating point, got {seq.dtype}")
        w_shape = tuple(layer.W.shape)
    b = seq.shape[1]
    expected = (("W", layer.W, w_shape), ("U", layer.U, (n, 4 * n)),
                ("b", layer.b, (4 * n,)), ("h0", h0, (b, n)), ("c0", c0, (b, n)))
    for name, x, shape in expected:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.dtype.is_floating_point:
            raise TypeError(f"{name} must be floating point, got {x.dtype}")
        if x.device != seq.device:
            raise ValueError(f"{name} on {x.device}, the sequence on {seq.device}")


def _kernel_types(cfg: ModelConfig, device: torch.device):
    """Type codes of the kernel's compute and residual types; raises on
    what the kernel does not take."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not shape_ok(cfg):
        raise ValueError(f"hidden {cfg.hidden} is not a multiple of 32")
    if cfg.cdtype not in _TYPE_CODES or cfg.rdtype not in _TYPE_CODES:
        raise TypeError(
            f"the CUDA kernels take float32/bfloat16 compute and residual "
            f"types, not {cfg.compute_dtype}/{cfg.residual_dtype}"
        )
    return _TYPE_CODES[cfg.cdtype], _TYPE_CODES[cfg.rdtype]


def shape_ok(cfg: ModelConfig) -> bool:
    """The H100 kernels' only shape requirement: a block owns 32 hidden
    units, one per lane of a warp, so N must be a multiple of 32. Batch
    and sequence length are free (ragged batch tiles are masked), and
    there is no capacity limit to gate on: U streams from device memory
    and L2 each step instead of sitting in a 16 MB VMEM."""
    return cfg.hidden % 32 == 0


def _outputs(s, b, n, cfg: ModelConfig, device, residuals: bool):
    f32 = dict(dtype=torch.float32, device=device)
    outs = dict(
        hT=torch.empty(b, n, **f32), cT=torch.empty(b, n, **f32),
        h_tmp=torch.empty(b, n, **f32), c_tmp=torch.empty(b, n, **f32),
        hseq=torch.empty(s, b, n, dtype=cfg.rdtype, device=device),
        cseq=None, gseq=None,
    )
    if residuals:
        outs["cseq"] = torch.empty(s, b, n, dtype=cfg.rdtype, device=device)
        outs["gseq"] = torch.empty(s, b, 4 * n, dtype=cfg.rdtype, device=device)
    return outs


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _result(o, cfg: ModelConfig, residuals: bool):
    out = _finish(o["hseq"], o["hT"], o["cT"], cfg)
    return out + (o["cseq"], o["gseq"]) if residuals else out


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def embed_layer0(layer, ids, h0, c0, cfg: ModelConfig,
                 residuals: bool = False):
    """Layer-0 recurrence with the embedding fused in: the kernel on a CUDA
    tensor, the plain version on a CPU tensor. ids: (S, B) byte ids;
    h0, c0: (B, N). Returns (h_seq, (hT, cT)), and with ``residuals`` also
    the cell and activated gate sequences."""
    _validate(layer, ids, h0, c0, cfg, embed=True)
    if ids.device.type == "cpu":
        return embed_layer0_plain(layer, ids, h0, c0, cfg, residuals)
    ctype, rtype = _kernel_types(cfg, ids.device)
    s, b = ids.shape
    n = cfg.hidden
    dev = ids.device
    W_c, U_c, bias = _embed_weights(layer, cfg)
    ids32 = ids.to(torch.int32).contiguous()
    h0f = h0.to(torch.float32).contiguous()
    c0f = c0.to(torch.float32).contiguous()
    o = _outputs(s, b, n, cfg, dev, residuals)
    lib = _build.load_library()
    err = lib.lstm_fwd_embed_launch(
        ctype, rtype, W_c.data_ptr(), U_c.data_ptr(), bias.data_ptr(),
        ids32.data_ptr(), h0f.data_ptr(), c0f.data_ptr(),
        o["hT"].data_ptr(), o["cT"].data_ptr(),
        o["h_tmp"].data_ptr(), o["c_tmp"].data_ptr(),
        o["hseq"].data_ptr(), _ptr(o["cseq"]), _ptr(o["gseq"]),
        s, b, n, int(cfg.cell_variant == "standard"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "lstm_fwd_embed_launch")
    embed_layer0.launches += s
    return _result(o, cfg, residuals)


def scan_layer(layer, xw, h0, c0, cfg: ModelConfig, residuals: bool = False):
    """Recurrence of a layer >= 1 from the precomputed xw = x @ W + b:
    the kernel on a CUDA tensor, the plain version on a CPU tensor.
    xw: (S, B, 4N); h0, c0: (B, N). Returns as ``embed_layer0``."""
    _validate(layer, xw, h0, c0, cfg, embed=False)
    if xw.device.type == "cpu":
        return scan_layer_plain(layer, xw, h0, c0, cfg, residuals)
    ctype, rtype = _kernel_types(cfg, xw.device)
    s, b, _ = xw.shape
    n = cfg.hidden
    dev = xw.device
    U_c = layer.U.to(cfg.cdtype).contiguous()
    xs = _xw_stream(xw, cfg)
    h0f = h0.to(torch.float32).contiguous()
    c0f = c0.to(torch.float32).contiguous()
    o = _outputs(s, b, n, cfg, dev, residuals)
    lib = _build.load_library()
    err = lib.lstm_fwd_scan_launch(
        ctype, rtype, U_c.data_ptr(), xs.data_ptr(), h0f.data_ptr(),
        c0f.data_ptr(), o["hT"].data_ptr(), o["cT"].data_ptr(),
        o["h_tmp"].data_ptr(), o["c_tmp"].data_ptr(),
        o["hseq"].data_ptr(), _ptr(o["cseq"]), _ptr(o["gseq"]),
        s, b, n, int(cfg.cell_variant == "standard"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "lstm_fwd_scan_launch")
    scan_layer.launches += s
    return _result(o, cfg, residuals)


embed_layer0.launches = 0
scan_layer.launches = 0


def reset_launches():
    embed_layer0.launches = 0
    scan_layer.launches = 0


def launches() -> Tuple[int, int]:
    """(layer-0 kernel launches, layers >= 1 kernel launches) so far."""
    return embed_layer0.launches, scan_layer.launches
