"""The fused softmax cross-entropy head: its two kernels, their plain
versions, and the head as an autograd function.

``head_fwd`` and ``head_bwd`` replace ``pallas_head.py:_fwd_head_kernel``
and ``_bwd_head_kernel``. For a CUDA tensor they launch ``head_fwd_launch``
and ``head_bwd_launch`` of ``csrc/head.cu`` or raise; for a CPU tensor they
run the plain versions beside them, which repeat the kernels' arithmetic
(on tensor cores under bf16 compute where ``fwd_tensor_cores`` and
``bwd_tensor_cores`` hold, on CUDA cores otherwise):

* forward: logits = h_c @ Why_c + by in fp32, lse = max + log sum exp, and
  the sum over rows of (lse - logits[target]) / ln 2, with lse kept;
* backward: the logits recomputed, dlog = (exp(logits - lse) - onehot) *
  cot / ln 2 in fp32, dh = round(dlog) @ Why_c^T returned in the compute
  type, dWhy = h_c^T round(dlog) and dby = sum_r dlog in fp32.

``fused_head_bits`` is the function ``models.lstm.loss_fn`` calls through
``cell_fn.fused_head``: the sum over tokens of -log2 p(target), with the
gradient the JAX custom VJP gives (dWhy rounded to the compute type, dby
with the shape of ``by``, dh in the compute type). ``head_supported`` is
its gate: what the kernels take.

Each wrapper counts in ``.launches`` the kernel launches it makes.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import ModelConfig
from . import _build
from . import cuda_cell
from . import cuda_cell_tiled as ct

LN2 = 0.6931471805599453
MAX_VOCAB = 256   # the columns of a 256-thread block


def head_supported(cfg: ModelConfig) -> bool:
    """The kernels' gate: a vocabulary of at most 256 (a block's columns).
    They take any hidden width and any number of tokens (a ragged row tile
    is masked); the TPU's alignment and VMEM budget are not carried over."""
    return cfg.vocab <= MAX_VOCAB


# K4's tensor-core design: 64-row tiles, N in chunks of 64 (csrc/head.cu:
# head_fwd_mma), Why's columns copied 8 bf16 at a time
TC_KC, TC_COLS = 64, 8


def fwd_tensor_cores(cfg: ModelConfig, n: int, m: int) -> bool:
    """Whether K4 takes its tensor-core design at hidden ``n`` and
    vocabulary ``m``: bf16 compute (fp32 products keep TF32 off, so fp32
    takes the CUDA-core design), N a multiple of TC_KC and M of TC_COLS."""
    return (cfg.cdtype == torch.bfloat16 and n % TC_KC == 0
            and m % TC_COLS == 0 and m <= MAX_VOCAB)


# K4's CUDA-core design (csrc/head.cu: head_fwd_core) copies 16 bytes at a
# time: h's width and Why's row pitch are multiples of CORE_PAD values
CORE_PAD = 8


def core_operands(h_c, Why_c):
    """h (T, N) and Why (N, M) as K4's CUDA-core design reads them: N and
    Why's row pitch padded with zeros to multiples of CORE_PAD where they
    are not (the zeros add nothing to a logit; the kernel masks the columns
    past M)."""
    n, m = Why_c.shape
    pn, pm = -n % CORE_PAD, -m % CORE_PAD
    if pn:
        h_c = torch.nn.functional.pad(h_c, (0, pn))
    if pn or pm:
        Why_c = torch.nn.functional.pad(Why_c, (0, pm, 0, pn))
    return h_c, Why_c


# K5's tensor-core design: 64-row blocks, dh over N in chunks of 64
# (csrc/head.cu: head_bwd_mma), dWhy through mma.cuh's atb_mma, whose
# column tiles are 128 wide
TC_DWHY_COLS = 128


def bwd_tensor_cores(cfg: ModelConfig, n: int, m: int) -> bool:
    """Whether K5 takes its tensor-core design at hidden ``n`` and
    vocabulary ``m``: bf16 compute, N a multiple of TC_KC and M of
    TC_DWHY_COLS (at most MAX_VOCAB); else its CUDA-core design, which
    fp32 always takes."""
    return (cfg.cdtype == torch.bfloat16 and n % TC_KC == 0
            and m % TC_DWHY_COLS == 0 and m <= MAX_VOCAB)


def _logits(Why_c, by, h_c, af):
    return h_c.to(af) @ Why_c.to(af) + by.to(af)


def head_fwd_plain(Why_c, by, h_c, tgt, cfg: ModelConfig):
    """Plain version of the forward kernel: (bits sum (), lse (T,))."""
    af = cuda_cell._acc_dtype(cfg)
    logits = _logits(Why_c, by, h_c, af)
    mx = logits.max(dim=-1, keepdim=True).values
    lse = mx + torch.log(torch.exp(logits - mx).sum(dim=-1, keepdim=True))
    logit_t = logits.gather(-1, tgt.long()[:, None])
    bits = (lse - logit_t).sum() * (1.0 / LN2)
    return bits, lse[:, 0]


def head_bwd_plain(Why_c, by, h_c, tgt, lse, cot, cfg: ModelConfig):
    """Plain version of the backward kernel: (dh (T, N) in the compute
    type, dWhy (N, M), dby (M,))."""
    af = cuda_cell._acc_dtype(cfg)
    logits = _logits(Why_c, by, h_c, af)
    p = torch.exp(logits - lse.to(af)[:, None])
    onehot = torch.nn.functional.one_hot(tgt.long(), cfg.vocab).to(af)
    dlog = (p - onehot) * (cot.to(af) * (1.0 / LN2))
    dlog_c = dlog.to(cfg.cdtype).to(af)
    dh = (dlog_c @ Why_c.to(af).T).to(cfg.cdtype)
    dWhy = h_c.to(af).T @ dlog_c
    return dh, dWhy, dlog.sum(0)


def _validate(Why_c, by, h_c, tgt, cfg: ModelConfig):
    t = h_c.shape[0]
    n, m = cfg.hidden, cfg.vocab
    expected = (("Why", Why_c, (n, m)), ("by", by, (m,)), ("h", h_c, (t, n)),
                ("targets", tgt, (t,)))
    for name, x, shape in expected:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != h_c.device:
            raise ValueError(f"{name} on {x.device}, h on {h_c.device}")
    if tgt.dtype.is_floating_point or tgt.dtype == torch.bool:
        raise TypeError(f"targets must be integer byte ids, got {tgt.dtype}")


def _kernel_type(cfg: ModelConfig, device) -> int:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not head_supported(cfg):
        raise ValueError(f"the head kernels take a vocabulary of at most "
                         f"{MAX_VOCAB}, not {cfg.vocab}")
    if cfg.cdtype not in cuda_cell._TYPE_CODES:
        raise TypeError(f"the head kernels take float32/bfloat16, not "
                        f"{cfg.compute_dtype}")
    return cuda_cell._TYPE_CODES[cfg.cdtype]


def head_fwd(Why_c, by, h_c, tgt, cfg: ModelConfig):
    """Forward of the fused head: the kernel on a CUDA tensor, the plain
    version on a CPU tensor. Why_c (N, M) and h_c (T, N) in the compute
    type, by (M,) fp32, tgt (T,). Returns (bits sum, lse (T,)), fp32."""
    _validate(Why_c, by, h_c, tgt, cfg)
    if h_c.device.type == "cpu":
        return head_fwd_plain(Why_c, by, h_c, tgt, cfg)
    t, n = h_c.shape
    ctype = _kernel_type(cfg, h_c.device)
    f32 = dict(dtype=torch.float32, device=h_c.device)
    lib = _build.load_library()
    lse = torch.empty(t, **f32)
    partial = torch.empty(lib.head_fwd_work_floats(t), **f32)
    bits = torch.empty((), **f32)
    design = int(fwd_tensor_cores(cfg, n, cfg.vocab))
    h_k, Why_k = h_c.to(cfg.cdtype), Why_c.to(cfg.cdtype)
    if not design:
        h_k, Why_k = core_operands(h_k, Why_k)
    ins = [ct._aligned(x) for x in (h_k, Why_k, by.to(torch.float32),
                                    tgt.to(torch.int32))]
    launched = ctypes.c_int(0)
    err = lib.head_fwd_launch(
        ctype, *(x.data_ptr() for x in ins), lse.data_ptr(),
        partial.data_ptr(), bits.data_ptr(), t, h_k.shape[1], cfg.vocab,
        Why_k.shape[1], design,
        torch.cuda.current_stream(h_c.device).cuda_stream,
        ctypes.byref(launched),
    )
    head_fwd.launches += launched.value
    cuda_cell._raise_on(err, "head_fwd_launch")
    return bits, lse


def head_bwd(Why_c, by, h_c, tgt, lse, cot, cfg: ModelConfig):
    """Backward of the fused head: the kernel on a CUDA tensor, the plain
    version on a CPU tensor. ``cot`` is the cotangent of the bits sum, a
    one-element tensor on the same device (read by the kernel, never by the
    host). Returns (dh (T, N) in the compute type, dWhy (N, M), dby (M,))."""
    _validate(Why_c, by, h_c, tgt, cfg)
    if h_c.device.type == "cpu":
        return head_bwd_plain(Why_c, by, h_c, tgt, lse, cot, cfg)
    t, n = h_c.shape
    m = cfg.vocab
    ctype = _kernel_type(cfg, h_c.device)
    f32 = dict(dtype=torch.float32, device=h_c.device)
    lib = _build.load_library()
    ins = [x.contiguous() for x in (
        h_c.to(cfg.cdtype), Why_c.to(cfg.cdtype), by.to(torch.float32),
        tgt.to(torch.int32), lse.to(torch.float32),
        cot.to(torch.float32).reshape(1))]
    tc = bwd_tensor_cores(cfg, n, m)
    # the (T, M) dlog the dWhy product reads: round(dlog) in bf16 for the
    # tensor cores, the fp32 dlog for the CUDA-core design
    dlog = torch.empty(t, m, dtype=torch.bfloat16 if tc else torch.float32,
                       device=h_c.device)
    dh = torch.empty(t, n, dtype=cfg.cdtype, device=h_c.device)
    dWhy = torch.empty(n, m, **f32)
    dby = torch.empty(m, **f32)
    work = torch.empty(lib.head_bwd_work_floats(t, n, m), **f32)
    launched = ctypes.c_int(0)
    err = lib.head_bwd_launch(
        ctype, *(x.data_ptr() for x in ins), dlog.data_ptr(), dh.data_ptr(),
        dWhy.data_ptr(), dby.data_ptr(), work.data_ptr(), t, n, m, int(tc),
        torch.cuda.current_stream(h_c.device).cuda_stream,
        ctypes.byref(launched),
    )
    head_bwd.launches += launched.value
    cuda_cell._raise_on(err, "head_bwd_launch")
    return dh, dWhy, dby


head_fwd.launches = 0
head_bwd.launches = 0


class FusedHead(torch.autograd.Function):
    """Sum over tokens of -log2 p(target), differentiable in Why, by and h.
    With ``plain`` both halves run their plain versions, on any device."""

    @staticmethod
    def forward(ctx, Why, by, h, tgt, cfg: ModelConfig, plain: bool):
        Why_c = Why.to(cfg.cdtype)
        by_f = by.to(cuda_cell._acc_dtype(cfg))
        h_c = h.to(cfg.cdtype)
        fwd = head_fwd_plain if plain else head_fwd
        bits, lse = fwd(Why_c, by_f, h_c, tgt, cfg)
        ctx.save_for_backward(Why_c, by_f, h_c, tgt, lse)
        ctx.cfg, ctx.plain = cfg, plain
        ctx.dtypes = (Why.dtype, by.dtype, h.dtype)
        return bits

    @staticmethod
    def backward(ctx, cot):
        Why_c, by_f, h_c, tgt, lse = ctx.saved_tensors
        cfg = ctx.cfg
        bwd = head_bwd_plain if ctx.plain else head_bwd
        dh, dWhy, dby = bwd(Why_c, by_f, h_c, tgt, lse, cot, cfg)
        wd, bd, hd = ctx.dtypes
        return (dWhy.to(cfg.cdtype).to(wd), dby.to(bd), dh.to(hd), None, None,
                None)


def fused_head_bits(params, h_flat, targets_flat, cfg: ModelConfig,
                    plain: bool = False):
    """Sum over tokens of -log2 p(target). h_flat: (T, N); targets: (T,).
    The value of ``softmax_xent_bits(logits_from_h(...)).sum()``."""
    return FusedHead.apply(params.Why, params.by, h_flat, targets_flat, cfg,
                           plain)
