"""The forward recurrence kernels of the port and their plain versions.

``embed_layer0`` and ``scan_layer`` replace ``pallas_embed_layer0`` and
``pallas_scan_layer`` of ``eigen_lstm_tpu/ops/pallas_cell.py``, with the same
return contract: ``(h_seq (S, B, N) in residual type, (hT, cT) in param
type)``. For a CUDA tensor they launch the kernel of ``csrc/lstm_fwd.cu``
or raise; for a CPU tensor they run the plain version beside them, which
repeats the kernel's arithmetic in PyTorch:

* layer 0: g = (round_c(h_{t-1}) @ U_c + W_c[ids_t]) + b, with W and U
  rounded to the compute type c and b in fp32 (``pallas_cell.py:1143``,
  ``:524-528``: the one-hot rows of dot([onehot | h], [W; U]) as a gather,
  then + b);
* layers >= 1: g = xw_t + round_c(h_{t-1}) @ U_c, with xw rounded to bf16
  under bf16 compute (``pallas_cell.py:475``);
* products in fp32 (float64 in the float64 oracle configuration), the
  carry in fp32 between steps, the sequences stored in the residual type.

With ``dropout=(rate, seed)`` both also return the masked stream
where(keep, h * inv, 0) in the residual type, the fused dropout of the TPU
kernels (``pallas_cell.py:221-224``, ``:546-553``): ``keep`` is
``_keep_mask``'s hash of (seed, timestep, global element index), of which
this module keeps the port's own copies (``_fmix32``, ``_keep_u32``,
``host_keep_mask`` in numpy, ``keep_mask`` in torch, bit for bit the same),
``inv`` = fp32(1 / (1 - rate)), the product in fp32 before the rounding.
h_seq and the carried (hT, cT) stay unmasked.

Each wrapper counts in ``.launches`` the kernel launches it makes: one a
call in the persistent design, S (one a timestep) in the per-step one.
The two recurrences compute the functions of K8 and K9
(``cuda_cell_tiled.tiled_embed_layer0`` and ``tiled_scan_layer``), so
wherever a plan gives a layout each is their persistent kernel with this
module's residual type and streams: only the order of the product's fp32
sums moves. Under bf16 compute that is ``csrc/fwd_mma.cuh:fwd_persist``
(one cooperative launch a window, U's rows in shared memory, the products
on tensor cores): ``scan_layer`` (K2) takes K9's layout
(``cuda_cell_tiled.tiled_fwd_plan``: N a multiple of 64, B <= 128, a grid
of N / 16 blocks resident, every batch row in a block); ``embed_layer0``
(K1) splits the batch over the blocks where N / 16 blocks would leave most
SMs idle (``cuda_cell_tiled.split_fwd_plan``: 32 of the bench's 128 rows
at N = 512, 128 blocks). Under fp32 compute K1 takes K8's fp32 persistent
kernel and K2 K9's (``csrc/lstm_tiled_f32.cuh``: one cooperative launch a
window on CUDA cores, N / 8 blocks each holding its N x 32 slice of U,
TF32 off), the batch of both split over block rows where N / 8 blocks
would leave SMs idle (``cuda_cell_tiled.split_fwd_f32_plan``: 2 rows of
64 at the bench's N = 512, B = 128; 8 rows a block at a 1x512 eval's
B = 16; one block row at N = 1024); a row's sums do not depend on the rows
its block holds. Elsewhere (B > 128, N not a multiple of 64 in bf16 or of
32 in fp32, N = 2048 in fp32, a grid the card cannot hold) each is
``csrc/lstm_fwd.cu``'s one launch a step. The plan decides before the
launch; a failed launch raises.

None of these functions is differentiable by itself, and each raises when
asked for a gradient rather than return a result that autograd cannot
follow: gradients go through ``cuda_cell_bwd`` (the backward kernels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from . import _build
from . import cell as cell_ops

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.float64 if cfg.cdtype == torch.float64 else torch.float32


# --- the dropout keep-mask (pallas_cell.py:70-144) ---------------------------
_M32 = 0xFFFFFFFF


def _fmix32(x):
    """murmur3's 32-bit finalizer on numpy uint32 values."""
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def _keep_u32(drop: float) -> int:
    """The keep threshold: an element stays where its hash is <= this."""
    return int((1.0 - drop) * 0xFFFFFFFF)


def _mask_base(seed: int, tau: int) -> int:
    """The hash of (seed, timestep); seed is an int32 read as its bits."""
    return cell_ops.hash32((seed & _M32) ^ ((tau * 0x9E3779B9) & _M32))


def host_keep_mask(seed: int, tau: int, b: int, n: int, drop: float):
    """(B, N) bool numpy keep-mask of timestep ``tau``: the hash of
    (seed, tau, row * N + col) <= ``_keep_u32(drop)``, as the kernels draw
    it."""
    base = np.uint32(_mask_base(seed, tau))
    with np.errstate(over="ignore"):
        rows = np.arange(b, dtype=np.uint32)[:, None]
        lanes = np.arange(n, dtype=np.uint32)[None, :]
        idx = (rows * np.uint32(n) + lanes).astype(np.uint32)
        bits = _fmix32((idx * np.uint32(0x85EBCA6B)).astype(np.uint32) ^ base)
    return bits <= np.uint32(_keep_u32(drop))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), in 16-bit halves of c
    so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32_torch(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed: int, tau: int, b: int, n: int, drop: float,
              device=None) -> torch.Tensor:
    """``host_keep_mask`` as a (B, N) bool tensor on ``device``, computed
    there in int64 (torch has no wrapping uint32 product)."""
    idx = torch.arange(b * n, dtype=torch.int64, device=device).reshape(b, n)
    bits = _fmix32_torch(_mul32(idx & _M32, 0x85EBCA6B)
                         ^ _mask_base(seed, tau))
    return bits <= _keep_u32(drop)


def drop_scalars(dropout):
    """(seed bits, keep threshold, fp32 inv) of ``dropout=(rate, seed)``
    for the C launchers, or None when there is no dropout."""
    if dropout is None or dropout[0] == 0.0:
        return None
    rate, seed = dropout
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside (0, 1)")
    return int(seed) & _M32, _keep_u32(rate), float(np.float32(1.0 / (1.0 - rate)))


def apply_keep(x: torch.Tensor, dropout, tau: int, af: torch.dtype):
    """where(keep(seed, tau), x * inv, 0) in ``af``: the masked stream of
    a forward step, or the cotangent of a backward step."""
    rate, seed = dropout
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=af)
    b, n = x.shape
    keep = keep_mask(seed, tau, b, n, rate, x.device)
    return torch.where(keep, x.to(af) * inv.to(x.device),
                       torch.zeros((), dtype=af, device=x.device))


# --- the recurrence ----------------------------------------------------------


def _plain_recurrence(g_of, steps, U_c, h0, c0, cfg: ModelConfig,
                      residuals: bool, dropout=None):
    """g_pre_t = g_of(t, round(h_{t-1}) @ U_c) for t < steps, fp32 carry:
    ``g_of`` adds step t's (B, 4N) input term to the product."""
    af = _acc_dtype(cfg)
    rd = cfg.rdtype
    n = cfg.hidden
    drop = drop_scalars(dropout) is not None
    h, c = h0.to(af), c0.to(af)
    hs, cs, gs, hds = [], [], [], []
    for t in range(steps):
        g_pre = g_of(t, cell_ops.matmul(h, U_c, cfg.cdtype, af))
        g = cell_ops.gate_activations(g_pre, n)
        h, c = cell_ops.cell_update(g, c, n, cfg.cell_variant)
        hs.append(h.to(rd))
        if drop:
            hds.append(apply_keep(h, dropout, t, af).to(rd))
        if residuals:
            cs.append(c.to(rd))
            gs.append(g.to(rd))
    stack = lambda xs: torch.stack(xs) if xs else None
    return _assemble(torch.stack(hs), h, c, cfg, residuals, stack(cs),
                     stack(gs), stack(hds))


def _assemble(h_seq, hT, cT, cfg: ModelConfig, residuals: bool, c_seq,
              g_seq, hd_seq):
    """The wrappers' return value: (h_out, (hT, cT)), h_out the masked
    stream under dropout; with ``residuals`` (h_seq, (hT, cT), c_seq,
    g_seq), and the masked stream last under dropout."""
    if not residuals:
        return _finish(h_seq if hd_seq is None else hd_seq, hT, cT, cfg)
    out = _finish(h_seq, hT, cT, cfg) + (c_seq, g_seq)
    return out if hd_seq is None else out + (hd_seq,)


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
            "layers >= 1 are differentiated through "
            "ops.cuda_cell_bwd.differentiable_scan_layer"
        )


def embed_layer0_plain(layer, ids, h0, c0, cfg: ModelConfig,
                       residuals: bool = False, dropout=None):
    """Plain version of the layer-0 kernel. With ``residuals`` it also
    returns the (S, B, N) cell and (S, B, 4N) activated gate sequences."""
    _refuse_grad(layer, ids, h0, c0, embed=True)
    W_c, U_c, bias = _embed_weights(layer, cfg)
    af = _acc_dtype(cfg)
    ids = ids.long()
    return _plain_recurrence(lambda t, hu: (hu + W_c[ids[t]].to(af)) + bias,
                             ids.shape[0], U_c, h0, c0, cfg, residuals,
                             dropout)


def xw_type(cfg: ModelConfig) -> torch.dtype:
    """The type of the xw stream and of its cotangent dg_seq: bf16 under
    bf16 compute, else the accumulation type (``pallas_cell.py:475``)."""
    return torch.bfloat16 if cfg.cdtype == torch.bfloat16 else _acc_dtype(cfg)


def _xw_stream(xw, cfg: ModelConfig):
    """xw as the kernel reads it, in ``xw_type``."""
    return xw.to(xw_type(cfg)).contiguous()


def scan_layer_plain(layer, xw, h0, c0, cfg: ModelConfig,
                     residuals: bool = False, dropout=None):
    """Plain version of the layers >= 1 kernel (bias folded into xw)."""
    _refuse_grad(layer, xw, h0, c0, embed=False)
    U_c = layer.U.to(cfg.cdtype)
    xs = _xw_stream(xw, cfg)
    af = _acc_dtype(cfg)
    return _plain_recurrence(lambda t, hu: xs[t].to(af) + hu, xs.shape[0],
                             U_c, h0, c0, cfg, residuals, dropout)


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


def _outputs(s, b, n, cfg: ModelConfig, device, residuals: bool,
             drop: bool):
    f32 = dict(dtype=torch.float32, device=device)
    seq = lambda *shape: torch.empty(s, b, *shape, dtype=cfg.rdtype, device=device)
    return dict(
        hT=torch.empty(b, n, **f32), cT=torch.empty(b, n, **f32),
        h_tmp=torch.empty(b, n, **f32), c_tmp=torch.empty(b, n, **f32),
        hseq=seq(n), cseq=seq(n) if residuals else None,
        gseq=seq(4 * n) if residuals else None,
        hdrop=seq(n) if drop else None,
    )


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _result(o, cfg: ModelConfig, residuals: bool):
    return _assemble(o["hseq"], o["hT"], o["cT"], cfg, residuals, o["cseq"],
                     o["gseq"], o["hdrop"])


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def embed_layer0(layer, ids, h0, c0, cfg: ModelConfig,
                 residuals: bool = False, dropout=None):
    """Layer-0 recurrence with the embedding fused in: the kernel on a CUDA
    tensor (the persistent design of the module docstring where the plan
    gives one, else one launch a step), the plain version on a CPU tensor.
    ids: (S, B) byte ids;
    h0, c0: (B, N). Returns (h_seq, (hT, cT)), and with ``residuals`` also
    the cell and activated gate sequences. ``dropout=(rate, seed)``: see
    ``_assemble`` for where the masked stream goes."""
    _validate(layer, ids, h0, c0, cfg, embed=True)
    drop = drop_scalars(dropout)
    if ids.device.type == "cpu":
        return embed_layer0_plain(layer, ids, h0, c0, cfg, residuals, dropout)
    ctype, rtype = _kernel_types(cfg, ids.device)
    s, b = ids.shape
    n = cfg.hidden
    dev = ids.device
    # cuda_cell_tiled imports this module, so it is imported here
    from . import cuda_cell_tiled as ct

    lib = _build.load_library()
    plan = (ct.device_split_fwd_f32_plan if cfg.cdtype == torch.float32
            else ct.device_split_fwd_plan)
    layout = plan(cfg, b, n)
    if layout is not None:   # K8's persistent kernel, K1's residual type
        o = ct.embed_launch(embed_layer0, layer, ids, h0, c0, cfg, cfg.rdtype,
                            layout, residuals, dropout)
        return _assemble(o["hseq"], o["hT"], o["c"], cfg, residuals,
                         o["cseq"], o["gseq"], o["hdrop"])
    W_c, U_c, bias = _embed_weights(layer, cfg)
    ids32 = ids.to(torch.int32).contiguous()
    h0f = h0.to(torch.float32).contiguous()
    c0f = c0.to(torch.float32).contiguous()
    o = _outputs(s, b, n, cfg, dev, residuals, drop is not None)
    err = lib.lstm_fwd_embed_launch(
        ctype, rtype, W_c.data_ptr(), U_c.data_ptr(), bias.data_ptr(),
        ids32.data_ptr(), h0f.data_ptr(), c0f.data_ptr(),
        o["hT"].data_ptr(), o["cT"].data_ptr(),
        o["h_tmp"].data_ptr(), o["c_tmp"].data_ptr(),
        o["hseq"].data_ptr(), _ptr(o["cseq"]), _ptr(o["gseq"]),
        _ptr(o["hdrop"]), s, b, n, int(cfg.cell_variant == "standard"),
        *(drop or (0, 0, 0.0)), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "lstm_fwd_embed_launch")
    embed_layer0.launches += s
    return _result(o, cfg, residuals)


def scan_layer(layer, xw, h0, c0, cfg: ModelConfig, residuals: bool = False,
               dropout=None):
    """Recurrence of a layer >= 1 from the precomputed xw = x @ W + b:
    the kernel on a CUDA tensor (the persistent design of the module
    docstring where the plan gives one, else one launch a step), the plain
    version on a CPU tensor. xw: (S, B, 4N); h0, c0: (B, N). Returns as
    ``embed_layer0``."""
    _validate(layer, xw, h0, c0, cfg, embed=False)
    drop = drop_scalars(dropout)
    if xw.device.type == "cpu":
        return scan_layer_plain(layer, xw, h0, c0, cfg, residuals, dropout)
    ctype, rtype = _kernel_types(cfg, xw.device)
    s, b, _ = xw.shape
    n = cfg.hidden
    dev = xw.device
    # cuda_cell_tiled imports this module, so it is imported here
    from . import cuda_cell_tiled as ct

    lib = _build.load_library()
    if cfg.cdtype == torch.float32:
        layout = ct.device_split_fwd_f32_plan(cfg, b, n)
    else:
        kres = ct.device_tiled_fwd_plan(cfg, b, n)
        layout = None if kres is None else (kres, b)
    if layout is not None:   # K9's persistent kernel, K2's residual type
        o = ct.scan_launch(scan_layer, layer, xw, h0, c0, cfg, cfg.rdtype,
                           layout, residuals, dropout)
        return _assemble(o["hseq"], o["hT"], o["c"], cfg, residuals,
                         o["cseq"], o["gseq"], o["hdrop"])
    U_c = layer.U.to(cfg.cdtype).contiguous()
    xs = _xw_stream(xw, cfg)
    h0f = h0.to(torch.float32).contiguous()
    c0f = c0.to(torch.float32).contiguous()
    o = _outputs(s, b, n, cfg, dev, residuals, drop is not None)
    err = lib.lstm_fwd_scan_launch(
        ctype, rtype, U_c.data_ptr(), xs.data_ptr(), h0f.data_ptr(),
        c0f.data_ptr(), o["hT"].data_ptr(), o["cT"].data_ptr(),
        o["h_tmp"].data_ptr(), o["c_tmp"].data_ptr(),
        o["hseq"].data_ptr(), _ptr(o["cseq"]), _ptr(o["gseq"]),
        _ptr(o["hdrop"]), s, b, n, int(cfg.cell_variant == "standard"),
        *(drop or (0, 0, 0.0)), torch.cuda.current_stream(dev).cuda_stream,
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
