"""The per-step tensor-parallel kernels (K13, K14), their plain versions and
one TP step as an autograd function: the port's
``eigen_lstm_tpu/ops/pallas_tp_cell.py``.

Under gate-sharded tensor parallelism over D devices a shard holds U_d
(N, 4nd), nd = N / D, with its gates in the shard-local order [i|o|f|u],
each nd wide (``parallel/tp.py``), and every step needs the full h (B, N),
all-gathered between steps. ``tp_step_fwd`` (K13) replaces
``_step_fwd_kernel`` (:72): g = xw + round(h_full) @ U_d with xw in fp32
(the bias folded in), h_full and U_d in the compute type and fp32 sums,
then the activations and the cell update; it returns (h2, c2, g), with g
the activated gates, all fp32 (``pallas_tp_cell.py:116``: this family
keeps g in fp32). ``tp_step_bwd`` (K14) replaces ``_step_bwd_kernel``
(:82): the gate backward, (g, c2, c_prev, dh, dc) -> (dg, dc_prev) in fp32.
For a CUDA tensor each launches its kernel of ``csrc/lstm_tp.cu`` (K13's
fp32 step: ``csrc/lstm_tp_step_f32.cu``) or raises; for a CPU tensor each
runs its plain version, ``tp_step_plain`` or ``tp_step_bwd_plain``
(``_fwd_math``, ``_bwd_math``), which the card's comparisons also call by
name. The plain versions compute in the
accumulation type (float64 in the float64 oracle configuration, where the
JAX functions stay in float32). Each wrapper counts its launches in
``.launches``, one a call.

K13 has three designs of one function on the card (``tp_step_plan``
chooses from the type, the shape and the card's SMs and shared memory,
before the launch; a failed launch raises). Under bf16 compute with at most
128 batch rows it is the tensor-core step that K8/K9's persistent forward
runs each step (``csrc/fwd_mma.cuh``): a block owns 16 units of the shard
with their four gate columns and ``rows`` batch rows, U_d and h_full
stream through a ``cp.async`` ring, the products are ``mma.sync``, so U_d
is read ceil(B / rows) times a step over the grid. Under fp32 compute with
at most 128 batch rows it is one step of the fp32 persistent forward
(``csrc/lstm_tp_step_f32.cu``, the device code of
``lstm_tiled_f32.cuh:f32_fwd_window`` in K15's mode): a block owns 8 units
of the shard with their four gate columns and ``rows`` batch rows
(``cuda_cell_tiled.f32_split_rows`` over nd / 8 column blocks: 128, 64 and
32 rows at the flagship's D = 1, 2, 4, 128 blocks each time), U_d's
columns and h_full stream through a ``cp.async.cg`` ring, the products
are FFMAs in 8 x 8 register tiles (TF32 off) summed in the window's split
order, so a window of these steps gives K15's fp32 window bits at D = 1
and a shard's the D = 1 bits on the unpermuted weights. Elsewhere (B >
128, widths the tiles do not take, a grid the card cannot hold) it is the
CUDA-core step tile of K2 with the shard's widths, a block 32 units x 4
rows. One launch a call either way; the C launcher counts it.

K14 on the card is ``tp_step_bwd_dh``. Under bf16 compute, where
``tp_step_bwd_plan`` gives a layout, the gate backward and the VJP's
dh_full = round(dg) @ U_c^T (:142-146) are one cooperative launch
(``csrc/lstm_tp_step_bwd.cu``): a grid of N / 64 groups of G blocks, a
block its group's 64 rows of U_c over 4nd / G gate columns, copied while
every thread runs its share of the gate backward; after a grid barrier
each block forms its part of the product with ``mma.sync`` (fp32 sums),
and the G parts meet in part order, rounded once to bf16. G comes from (N,
nd) and the card, never from B, so every batch takes one sum order. fp32
compute and refused shapes (B > 128, widths the layout does not take, a
grid the card cannot hold) keep the first design: ``tp_step_bwd`` (the
gate backward alone, ``csrc/lstm_tp.cu``), then the product outside.
Either way one launch of K14 a call, counted in ``tp_step_bwd.launches``.

``fused_tp_step`` is the JAX function of that name: the autograd function
``TPStep``, whose backward is ``tp_step_bwd_dh`` (:136-154): dg, dc_prev
and dh_full = round(dg) @ round(U)^T; dU = round(h_full)^T round(dg) is a
product outside in the compute type with an fp32 result, as the JAX
``dot_general`` is. As there, dU comes back in U's type (fp32: not
rounded) and dh_full in h_full's, the compute type (bf16 under bf16
compute). The caller casts U to the compute type once a window
(``parallel/tp.py:_tp_scan_layer``) and hands that U_c to every step beside
U, as an input autograd does not differentiate: the kernel and dh_full read
U_c, while dU goes to U itself, so the cast's backward never rounds it.
``tp_pallas_supported`` is the JAX gate, copied to pick the family as the
JAX package does, not as a capacity limit of the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..config import ModelConfig
from . import _build
from . import cell as cell_ops
from . import cuda_cell
from . import cuda_cell_tiled as ct


def tp_pallas_supported(cfg: ModelConfig, batch: int, ndev: int) -> bool:
    """``pallas_tp_cell.py:tp_pallas_supported``: shard slices 128-lane
    aligned, the batch a multiple of 8 and the vocabulary of 128."""
    nd = cfg.hidden // ndev
    return (cfg.hidden % ndev == 0 and nd % 128 == 0 and batch % 8 == 0
            and cfg.vocab % 128 == 0)


def tp_step_plain(U, xw, h_full, c_d, cfg: ModelConfig):
    """``_fwd_math``: (h2, c2, g) of one step; nd is c_d's width."""
    af = cuda_cell._acc_dtype(cfg)
    nd = c_d.shape[-1]
    g_pre = xw.to(af) + cell_ops.matmul(h_full, U, cfg.cdtype, af)
    g = cell_ops.gate_activations(g_pre, nd)
    h2, c2 = cell_ops.cell_update(g, c_d.to(af), nd, cfg.cell_variant)
    return h2, c2, g


def tp_step_bwd_plain(g, c2, c_prev, dh, dc, cfg: ModelConfig):
    """``_bwd_math``: (dg, dc_prev) of one step."""
    af = cuda_cell._acc_dtype(cfg)
    return cell_ops.gate_bwd(g.to(af), c2.to(af), c_prev.to(af), dh.to(af),
                             dc.to(af), c2.shape[-1], cfg.cell_variant)


def _check(name, x, shape, device):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"{name} must be floating point, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, xw on {device}")


def _card(cfg: ModelConfig, device: torch.device, nd: int) -> int:
    """The compute type's code for the kernels; raises on what they do not
    take."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if nd % 32 != 0:
        raise ValueError(f"shard width {nd} is not a multiple of 32")
    if cfg.cdtype not in cuda_cell._TYPE_CODES:
        raise TypeError(f"the TP kernels take float32/bfloat16 compute, not "
                        f"{cfg.compute_dtype}")
    return cuda_cell._TYPE_CODES[cfg.cdtype]


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def tp_step_f32_plan(b: int, n: int, nd: int, sms: int,
                     smem_limit: int) -> Optional[ct.F32Split]:
    """The fp32 step's layout at (batch, full width n, shard width nd) on a
    device of ``sms`` SMs whose blocks may take ``smem_limit`` bytes of
    shared memory: ``rows`` batch rows a block (``ct.f32_split_rows`` over
    the nd / 8 column blocks: every row where the grid reaches half the
    SMs, else 2 or 4 block rows), the rows a thread and the first ring of
    ``ct.STEP_F32_RINGS`` whose KC divides n and that fits (beside no
    slice of U: ``ct.step_f32_smem_bytes``); None for B > 128, n
    not a multiple of 32, nd not of 8, a grid of (nd / 8) x ceil(B / rows)
    blocks that is not resident at one an SM, or no ring that fits."""
    if n % 32 or nd % ct.F32_UNITS or not 1 <= b <= ct.F32_ROWS:
        return None
    blocks = nd // ct.F32_UNITS
    rows = min(b, ct.f32_split_rows(b, blocks, sms))
    if blocks * -(-b // rows) > sms:
        return None
    per = ct.f32_rows_per_thread(rows)
    ring = next((r for r in ct.STEP_F32_RINGS[per] if n % r[0] == 0
                 and ct.step_f32_smem_bytes(rows, *r) <= smem_limit), None)
    return None if ring is None else ct.F32Split(rows, per, *ring)


def tp_step_plan(cfg: ModelConfig, b: int, n: int, nd: int, sms: int,
                 smem_limit: int) -> Optional[Union[int, ct.F32Split]]:
    """K13's design at (config, batch, full width n, shard width nd) on a
    device of ``sms`` SMs whose blocks may take ``smem_limit`` bytes of
    shared memory: under bf16 compute the batch rows a block takes in the
    tensor-core design, under fp32 compute the fp32 step's layout
    (``tp_step_f32_plan``), None for the CUDA-core design.

    The tensor-core design needs bf16 compute (fp32 products keep TF32
    off), n a multiple of the ring's k chunk, nd of the block's units and
    at most 128 batch rows (one 16-row m tile a warp). A block owns 16
    units of the shard and ``rows`` batch rows: all of them where the grid
    of nd / 16 blocks reaches half the card's SMs, else the fewest (the m
    tiles split 2, 4 or 8 ways) whose grid does, so that the step runs on
    enough SMs to draw on L2 at more than a few blocks' rate; U_d is then
    read ceil(B / rows) times a step over the grid."""
    if cfg.cdtype == torch.float32:
        return tp_step_f32_plan(b, n, nd, sms, smem_limit)
    if (cfg.cdtype != torch.bfloat16 or n % ct.PERSIST_KC != 0
            or nd % ct.PERSIST_UNITS != 0 or not 1 <= b <= ct.PERSIST_ROWS):
        return None
    rows = ct.split_rows(b, nd // ct.PERSIST_UNITS, sms)
    return rows if ct.persist_smem_bytes(rows, n, 0) <= smem_limit else None


def device_tp_step_plan(cfg: ModelConfig, b: int, n: int, nd: int):
    """``tp_step_plan`` with the current card's SMs and shared-memory
    limit."""
    return tp_step_plan(cfg, b, n, nd,
                        *ct._device_limits(torch.cuda.current_device()))


def tp_step_fwd(U, xw, h_full, c_d, cfg: ModelConfig):
    """One TP step: (U (N, 4nd), xw (B, 4nd), h_full (B, N), c_d (B, nd))
    -> (h2, c2, g), K13 on the card, the plain version on the CPU. U is
    cast to the compute type here unless it is in it already (the TP
    recurrence hands in U_c, cast once a window)."""
    b, n = h_full.shape
    nd = c_d.shape[-1]
    dev = xw.device
    for name, x, shape in (("U", U, (n, 4 * nd)), ("xw", xw, (b, 4 * nd)),
                           ("h_full", h_full, (b, n)), ("c_d", c_d, (b, nd))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return tp_step_plain(U, xw, h_full, c_d, cfg)
    ctype = _card(cfg, dev, nd)
    lib = _build.load_library()
    plan = device_tp_step_plan(cfg, b, n, nd)
    f32 = torch.float32
    U_c, h_c = (ct._aligned(x.to(cfg.cdtype)) for x in (U, h_full))
    xw32, c32 = (ct._aligned(x.to(f32)) for x in (xw, c_d))
    h2, c2 = (torch.empty(b, nd, dtype=f32, device=dev) for _ in range(2))
    g = torch.empty(b, 4 * nd, dtype=f32, device=dev)
    launched = ctypes.c_int(0)
    ptrs = (U_c.data_ptr(), xw32.data_ptr(), h_c.data_ptr(), c32.data_ptr(),
            h2.data_ptr(), c2.data_ptr(), g.data_ptr(), b, n, nd,
            int(cfg.cell_variant == "standard"))
    if isinstance(plan, ct.F32Split):
        name = "tp_step_fwd_f32_launch"
        err = lib.tp_step_fwd_f32_launch(*ptrs, *plan, _stream(dev),
                                         ctypes.byref(launched))
    else:
        name = "tp_step_fwd_launch"
        err = lib.tp_step_fwd_launch(ctype, *ptrs, -1 if plan is None else plan,
                                     _stream(dev), ctypes.byref(launched))
    tp_step_fwd.launches += launched.value
    cuda_cell._raise_on(err, name)
    return h2, c2, g


def tp_step_bwd(g, c2, c_prev, dh, dc, cfg: ModelConfig):
    """The gate backward of one TP step: (dg (B, 4nd), dc_prev (B, nd)),
    K14 on the card, the plain version on the CPU."""
    b, nd = c2.shape
    dev = g.device
    for name, x, shape in (("g", g, (b, 4 * nd)), ("c2", c2, (b, nd)),
                           ("c_prev", c_prev, (b, nd)), ("dh", dh, (b, nd)),
                           ("dc", dc, (b, nd))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return tp_step_bwd_plain(g, c2, c_prev, dh, dc, cfg)
    _card(cfg, dev, nd)
    lib = _build.load_library()
    f32 = torch.float32
    ins = [x.to(f32).contiguous() for x in (g, c2, c_prev, dh, dc)]
    dg = torch.empty(b, 4 * nd, dtype=f32, device=dev)
    dcp = torch.empty(b, nd, dtype=f32, device=dev)
    err = lib.tp_step_bwd_launch(
        *(x.data_ptr() for x in ins), dg.data_ptr(), dcp.data_ptr(), b, nd,
        int(cfg.cell_variant == "standard"), _stream(dev))
    cuda_cell._raise_on(err, "tp_step_bwd_launch")
    tp_step_bwd.launches += 1
    return dg, dcp


def _dh_full(dg, U_c, cfg: ModelConfig):
    """The VJP's dh_full = round(dg) @ U_c^T in the accumulation type, cast
    to the compute type (h_full's): the product outside the kernels."""
    return cell_ops.matmul(dg, U_c.T, cfg.cdtype, cuda_cell._acc_dtype(cfg)).to(cfg.cdtype)


def tp_step_bwd_dh_plain(g, c2, c_prev, dh, dc, U_c, cfg: ModelConfig):
    """``_bwd_math`` and the VJP's dh_full: (dg, dc_prev, dh_full)."""
    dg, dcp = tp_step_bwd_plain(g, c2, c_prev, dh, dc, cfg)
    return dg, dcp, _dh_full(dg, U_c, cfg)


# K14's fused step (csrc/lstm_tp_step_bwd.cu), bf16 compute: a block of
# 256 threads owns STEP_BWD_UNITS rows of U_c (output units) over 4nd / G
# gate columns, G the first of STEP_BWD_PARTS whose N / units x G blocks
# the card holds at one an SM and whose columns are whole chunks of
# STEP_BWD_KC; round(dg) through a ring of STEP_BWD_STAGES slots of the
# batch's whole 16-row tiles by STEP_BWD_KC + 8 columns, U_c's rows padded
# by 8 elements.
STEP_BWD_UNITS = 64
STEP_BWD_PARTS = (16, 8, 4, 2, 1)
STEP_BWD_KC = 64
STEP_BWD_ROWS = 128
STEP_BWD_STAGES = (4, 2)


class StepBwdPlan(NamedTuple):
    """K14's layout: ``blocks`` (G) blocks a group of units, a ring of
    ``stages`` slots."""
    blocks: int
    stages: int


def step_bwd_smem_bytes(b: int, nd: int, blocks: int, stages: int) -> int:
    """Bytes of dynamic shared memory a block of K14's fused step takes at
    batch ``b`` and shard width ``nd`` (``csrc/lstm_tp_step_bwd.cu``'s
    layout)."""
    rows = 16 * -(-b // 16)
    return 2 * (STEP_BWD_UNITS * (4 * nd // blocks + 8)
                + stages * rows * (STEP_BWD_KC + 8))


def tp_step_bwd_plan(cfg: ModelConfig, b: int, n: int, nd: int, sms: int,
                     smem_limit: int) -> Optional[StepBwdPlan]:
    """K14's fused layout at (batch, full width n, shard width nd) on a
    device of ``sms`` SMs whose blocks may take ``smem_limit`` bytes of
    shared memory: G from (n, nd) and the SMs alone, then the first ring
    that fits; None for the first design (the gate backward, then the
    product outside): fp32 compute, B > 128, n not a multiple of 64, nd not
    of 16, no G whose grid is resident at one block an SM, or no ring that
    fits. A fused fp32 step (K16's fp32 D-rank product on CUDA cores) was
    built and timed on an H100 at the flagship's shard: alone it trailed
    the first design at D = 1, 2 and 4, and on the fp32 ``--tp 1`` window
    the two read the same within the host's noise (PERF.md row 14), so
    fp32 keeps the first design alone."""
    if cfg.cdtype != torch.bfloat16 or not 1 <= b <= STEP_BWD_ROWS or nd % 16 \
            or n % STEP_BWD_UNITS:
        return None
    blocks = next((g for g in STEP_BWD_PARTS if (4 * nd) % (g * STEP_BWD_KC) == 0
                   and n // STEP_BWD_UNITS * g <= sms), None)
    if blocks is None:
        return None
    stages = next((st for st in STEP_BWD_STAGES
                   if step_bwd_smem_bytes(b, nd, blocks, st) <= smem_limit), None)
    return None if stages is None else StepBwdPlan(blocks, stages)


@functools.lru_cache(maxsize=None)
def _step_bwd_limits(index: int):
    """``ct._device_limits`` of card ``index``, once checking that the
    library lays out K14's shared memory as ``step_bwd_smem_bytes``
    does."""
    limits = ct._device_limits(index)
    lib = _build.load_library()
    for b, nd, blocks, st in ((128, 1024, 8, 4), (40, 512, 16, 2)):
        if lib.tp_step_bwd_dh_smem_bytes(b, nd, blocks, st) != \
                step_bwd_smem_bytes(b, nd, blocks, st):
            raise RuntimeError("step_bwd_smem_bytes disagrees with "
                               "csrc/lstm_tp_step_bwd.cu's layout")
    return limits


def device_tp_step_bwd_plan(cfg: ModelConfig, b: int, n: int, nd: int):
    """``tp_step_bwd_plan`` with the current card's SMs and shared-memory
    limit."""
    return tp_step_bwd_plan(cfg, b, n, nd,
                            *_step_bwd_limits(torch.cuda.current_device()))


def tp_step_bwd_dh(g, c2, c_prev, dh, dc, U_c, cfg: ModelConfig):
    """The reverse of one TP step: (dg (B, 4nd), dc_prev (B, nd), dh_full
    (B, N)), dh_full = round(dg) @ U_c^T in the compute type. On the card
    K14: its fused step where ``tp_step_bwd_plan`` gives a layout (bf16),
    else its first design; on the CPU the plain version."""
    b, nd = c2.shape
    n = U_c.shape[0]
    dev = g.device
    for name, x, shape in (("g", g, (b, 4 * nd)), ("c2", c2, (b, nd)),
                           ("c_prev", c_prev, (b, nd)), ("dh", dh, (b, nd)),
                           ("dc", dc, (b, nd)), ("U_c", U_c, (n, 4 * nd))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return tp_step_bwd_dh_plain(g, c2, c_prev, dh, dc, U_c, cfg)
    _card(cfg, dev, nd)
    plan = device_tp_step_bwd_plan(cfg, b, n, nd)
    if plan is None:
        dg, dcp = tp_step_bwd(g, c2, c_prev, dh, dc, cfg)
        return dg, dcp, _dh_full(dg, U_c, cfg)
    lib = _build.load_library()
    f32 = torch.float32
    ins = [ct._aligned(x.to(f32)) for x in (g, c2, c_prev, dh, dc)]
    U_a = ct._aligned(U_c.to(torch.bfloat16))
    dg = torch.empty(b, 4 * nd, dtype=f32, device=dev)
    dcp = torch.empty(b, nd, dtype=f32, device=dev)
    dh_full = torch.empty(b, n, dtype=torch.bfloat16, device=dev)
    dgx = torch.empty(b, 4 * nd, dtype=torch.bfloat16, device=dev)
    xbuf = (torch.empty(plan.blocks, b, n, dtype=f32, device=dev)
            if plan.blocks > 1 else None)
    launched = ctypes.c_int(0)
    err = lib.tp_step_bwd_dh_launch(
        *(x.data_ptr() for x in ins), U_a.data_ptr(), dg.data_ptr(),
        dcp.data_ptr(), dh_full.data_ptr(), dgx.data_ptr(),
        None if xbuf is None else xbuf.data_ptr(), b, n, nd,
        int(cfg.cell_variant == "standard"), *plan, _stream(dev),
        ctypes.byref(launched))
    tp_step_bwd.launches += launched.value
    tp_step_bwd_dh.launches += launched.value
    cuda_cell._raise_on(err, "tp_step_bwd_dh_launch")
    return dg, dcp, dh_full


tp_step_fwd.launches = 0
tp_step_bwd.launches = 0     # K14 in either design
tp_step_bwd_dh.launches = 0  # K14's fused step alone


class TPStep(torch.autograd.Function):
    """One TP step, differentiable in U, xw, h_full and c_d: the JAX custom
    VJP of ``_make_tp_step``. U_c is U in the compute type, an input that
    is not differentiated: the forward and dh_full read it, dU is U's.
    With ``plain`` both halves run their plain versions, on any device."""

    @staticmethod
    def forward(ctx, U, U_c, xw, h_full, c_d, cfg: ModelConfig, plain: bool):
        fwd = tp_step_plain if plain else tp_step_fwd
        h2, c2, g = fwd(U_c, xw, h_full, c_d, cfg)
        ctx.save_for_backward(U_c, g, c2, c_d, h_full)
        ctx.cfg, ctx.plain = cfg, plain
        ctx.u_dtype, ctx.xw_dtype = U.dtype, xw.dtype
        return h2, c2

    @staticmethod
    def backward(ctx, dh2, dc2):
        U_c, g, c2, c_prev, h_full = ctx.saved_tensors
        cfg = ctx.cfg
        af = cuda_cell._acc_dtype(cfg)
        dh2 = torch.zeros_like(c2) if dh2 is None else dh2
        dc2 = torch.zeros_like(c2) if dc2 is None else dc2
        bwd = tp_step_bwd_dh_plain if ctx.plain else tp_step_bwd_dh
        dg, dcp, dh_full = bwd(g, c2, c_prev.to(af), dh2.to(af), dc2.to(af), U_c, cfg)
        dU = cell_ops.matmul(h_full.T, dg, cfg.cdtype, af)
        return (dU.to(ctx.u_dtype), None, dg.to(ctx.xw_dtype),
                dh_full.to(h_full.dtype), dcp.to(c_prev.dtype), None, None)


def fused_tp_step(U, xw, h_full, c_d, cfg: ModelConfig, plain: bool = False,
                  U_c: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pallas_tp_cell.py:fused_tp_step``: (h_d, c_d) of one step in the
    accumulation type, with h_full cast to the compute type and c_d to the
    accumulation type first; through ``TPStep`` when autograd needs a
    gradient, else the forward alone. ``U_c``: U already cast to the
    compute type, outside autograd (the TP recurrence casts it once a
    window); cast here when None."""
    af = cuda_cell._acc_dtype(cfg)
    h_c, c_a = h_full.to(cfg.cdtype), c_d.to(af)
    if U_c is None:
        U_c = U.detach().to(cfg.cdtype)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (U, xw, h_c, c_a)):
        return TPStep.apply(U, U_c, xw, h_c, c_a, cfg, plain)
    fwd = tp_step_plain if plain else tp_step_fwd
    return fwd(U_c, xw, h_c, c_a, cfg)[:2]
