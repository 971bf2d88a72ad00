"""The tiled-U recurrence of the port: the counterpart of
``eigen_lstm_tpu/ops/pallas_cell_tiled.py``, the regime where U no longer
fits a TPU core's VMEM (N >= 2048 in bf16, N >= 1024 in fp32; the families
are chosen in ``ops/dispatch.py``).

Three kernels of ``csrc/lstm_tiled.cu`` (K8's and K9's fp32 persistent
design in ``csrc/lstm_tiled_f32.cu``, K10's K6's in
``csrc/lstm_bwd_f32.cu``), each with a wrapper that
validates, casts, launches and counts its launches in ``.launches``, and a
plain version beside it that repeats the kernel's arithmetic step by step;
a wrapper runs the plain version for a CPU tensor and for a CUDA tensor
launches the kernel or raises:

* ``tiled_embed_layer0`` (K8, ``_fwd_tiled_embed_kernel`` :429): layer 0,
  g = (W_c[ids_t] + round(h_{t-1}) @ U_c) + b (``:454-457``, the one-hot
  rows of [onehot | h] @ [W; U] as a gather);
* ``tiled_scan_layer`` (K9, ``_fwd_tiled_kernel`` :52): layers >= 1,
  g = xw_t + round(h_{t-1}) @ U_c, xw in the xw type (``:73-76``);
* ``tiled_bwd`` (K10, ``_bwd_tiled_kernel`` :106): the reverse steps of
  both tiled VJPs, dh_t = round(dg_{t+1}) @ U_c^T + dh_cot_t, then the gate
  backward; returns dg_seq in the xw type and dc0 in fp32.

K8 and K9 have three designs of one function on the card: under bf16
compute, where its grid of N / 16 blocks can be resident, one persistent
cooperative launch a window with as many of U's rows as fit in shared
memory and the product on tensor cores (``tiled_fwd_plan`` chooses from
the type, the shape and the card's SMs and shared memory); under fp32
compute one persistent cooperative launch a window on CUDA cores, N / 8
blocks each holding its N x 32 slice of U in shared memory
(``tiled_fwd_f32_plan``: B <= 128, a resident grid); elsewhere (B > 128,
a grid too large for the card) one launch a step. The resident family's
forwards compute the same functions and take the bf16 persistent design
through the same launchers (``embed_launch`` for K1, ``scan_launch`` for
K2), as does K15 (``cuda_tp_seq``); K1's and K15's blocks take a share of
the batch rows where N / 16 blocks would leave most SMs idle
(``split_fwd_plan``). Under fp32 compute K1 takes K8's fp32 persistent
kernel through ``embed_launch`` with K1's residual type, K2 K9's through
``scan_launch`` with K2's residual type and xw stream, and K15 K9's in
K15's mode (``csrc/lstm_tiled_f32.cuh``: h_seq in fp32, c_prev =
c_{t-1}), the blocks of all three a share of the batch rows where N / 8
blocks would leave SMs idle (``split_fwd_f32_plan``, ``f32_split_layout``,
which K15's D-rank design and K13's fp32 step share). K10 has three such designs too: under bf16 compute
(``tiled_bwd_plan``), where its grid of (N / 32) * ceil(B / rows) blocks
can be resident, one persistent cooperative launch a window that also
gives dh0, with as many chunks of U's rows as fit in shared memory and
dh_rec on tensor cores; under fp32 compute (``tiled_bwd_f32_plan``) K6's
fp32 persistent design (``cuda_cell_bwd.reverse_f32``): one cooperative
launch a window on CUDA cores, N / 8 blocks in pairs, each holding its
pair's 16 rows of U over half the 4N gate columns, which also gives dh0;
elsewhere one launch a reverse step. The C launchers
count the launches (1 or S a call).

The types are the tiled JAX functions' (``:222-225``, ``:673``): the
residual type is fp32 only where ``residual_dtype`` is ``"float32"``, else
bf16; the xw type is bf16 under bf16 compute, else fp32; every product,
carry and sum is fp32, also under float64 compute, which the tiled JAX path
runs in fp32. The forward wrappers return as those of ``cuda_cell``:
``(h_out, (hT, cT))``, with ``residuals`` ``(h_seq, (hT, cT), c_seq,
g_seq)`` and the masked stream last under ``dropout=(rate, seed)``.

``TiledEmbedLayer0`` and ``TiledScanLayer`` are the VJPs of
``_make_tiled_embed_seq`` and ``_make_tiled_seq`` (``:338-415``,
``:589-653``): the cotangent of h_seq rounded to the xw type before K10,
those of hT and cT through the residual type; then, outside the kernel as
in JAX, dh0 = round(dg_0) @ U_c^T, dU = round(h_prev)^T round(dg) with
h_{-1} = h0 in the residual type, dW = onehot(ids)^T round(dg) and db the
fp32 sum of the rounded dg, all fp32 products (``ops/cell.py:matmul``,
without TF32); dW and dU are handed back rounded to the compute type
(``:377``, ``:622``) and dxw is dg in the xw type. Under bf16 compute on
the card dU runs on tensor cores (``tensor_core_dU``: bf16 in, fp32 sums,
as the JAX product's ``preferred_element_type``, so only the order of the
sums moves) and dh0 is the persistent K10's own last product, as it is
of the fp32 persistent K10.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..config import ModelConfig
from ..models.lstm import LayerParams
from . import _build
from . import cell as cell_ops
from . import cuda_cell
from . import cuda_cell_bwd

AF = torch.float32   # every product, carry and sum of the tiled path


def types(cfg: ModelConfig) -> Tuple[torch.dtype, torch.dtype, torch.dtype]:
    """(compute, residual, xw) types of the tiled path."""
    rd = torch.float32 if cfg.residual_dtype == "float32" else torch.bfloat16
    xd = torch.bfloat16 if cfg.cdtype == torch.bfloat16 else torch.float32
    return cfg.cdtype, rd, xd


def _mm(a, w, cfg: ModelConfig):
    """a @ w with both rounded to the compute type, the product in fp32."""
    return cell_ops.matmul(a, w, cfg.cdtype, AF)


# --- the forward: plain versions ---------------------------------------------


def _recurrence_plain(g_of, steps, U_c, h0, c0, cfg: ModelConfig,
                      residuals: bool, dropout):
    """The forward steps: g_of(t, round(h_{t-1}) @ U_c) is step t's
    pre-activation, the carry fp32."""
    _, rd, _ = types(cfg)
    n = cfg.hidden
    drop = cuda_cell.drop_scalars(dropout) is not None
    h, c = h0.to(AF), c0.to(AF)
    hs, cs, gs, hds = [], [], [], []
    for t in range(steps):
        g = cell_ops.gate_activations(g_of(t, _mm(h, U_c, cfg)), n)
        h, c = cell_ops.cell_update(g, c, n, cfg.cell_variant)
        hs.append(h.to(rd))
        if drop:
            hds.append(cuda_cell.apply_keep(h, dropout, t, AF).to(rd))
        if residuals:
            cs.append(c.to(rd))
            gs.append(g.to(rd))
    stack = lambda xs: torch.stack(xs) if xs else None
    return _assemble(torch.stack(hs), h, c, cfg, residuals, stack(cs),
                     stack(gs), stack(hds))


def _assemble(h_seq, hT, cT, cfg: ModelConfig, residuals: bool, c_seq,
              g_seq, hd_seq):
    # (hT, cT) leave as h_seq[-1], c_seq[-1] in the residual type, then the
    # param type (pallas_cell_tiled.py:390, :696)
    _, rd, _ = types(cfg)
    last = (hT.to(rd).to(cfg.pdtype), cT.to(rd).to(cfg.pdtype))
    if not residuals:
        return (h_seq if hd_seq is None else hd_seq), last
    out = (h_seq, last, c_seq, g_seq)
    return out if hd_seq is None else out + (hd_seq,)


def _embed_weights(layer, cfg: ModelConfig):
    """W and U in the compute type, cut from the stacked [W; U] as
    ``pallas_tiled_embed_layer0`` builds it, and b in fp32."""
    m = layer.W.shape[0]
    WU = torch.cat([layer.W, layer.U], dim=0).to(cfg.cdtype).contiguous()
    return WU[:m], WU[m:], layer.b.to(AF).contiguous()


def _refuse_grad(layer, seq, h0, c0):
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (layer.W, layer.U, layer.b, seq, h0, c0)
    ):
        raise NotImplementedError(
            "the tiled layers are differentiated through "
            "ops.cuda_cell_tiled.differentiable_tiled_embed_layer0 and "
            "differentiable_tiled_scan_layer")


def tiled_embed_layer0_plain(layer, ids, h0, c0, cfg: ModelConfig,
                             residuals: bool = False, dropout=None):
    """Plain version of K8."""
    _refuse_grad(layer, ids, h0, c0)
    W_c, U_c, bias = _embed_weights(layer, cfg)
    ids = ids.long()
    return _recurrence_plain(lambda t, hu: (W_c[ids[t]].to(AF) + hu) + bias,
                             ids.shape[0], U_c, h0, c0, cfg, residuals,
                             dropout)


def tiled_scan_layer_plain(layer, xw, h0, c0, cfg: ModelConfig,
                           residuals: bool = False, dropout=None):
    """Plain version of K9 (bias folded into xw)."""
    _refuse_grad(layer, xw, h0, c0)
    xs = xw.to(types(cfg)[2])
    return _recurrence_plain(lambda t, hu: xs[t].to(AF) + hu, xs.shape[0],
                             layer.U.to(cfg.cdtype), h0, c0, cfg, residuals,
                             dropout)


# --- the forward: the kernels ------------------------------------------------


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address, as cp.async reads it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _kernel_codes(cfg: ModelConfig, device: torch.device):
    """Type codes of the compute and residual types; raises on what the
    kernels do not take (another device, a width not a multiple of 32,
    float64)."""
    cuda_cell._kernel_types(cfg, device)
    _, rd, _ = types(cfg)
    return cuda_cell._TYPE_CODES[cfg.cdtype], cuda_cell._TYPE_CODES[rd]


# The persistent K8/K9's shared-memory layout, as csrc/lstm_tiled.cu lays
# it out (fwd_persist_smem_bytes; ``_device_limits`` holds the two equal):
# kres rows of the block's U slice (UNITS units x 4 gates), each
# 4 * UNITS + PAD bf16, then a ring of STAGES slots, each the h chunk of
# the batch's 16-row m tiles (KC + PAD bf16 a row) and a KC-row U chunk;
# below 8 warp rows the cross-warp partial sums (8 warps x 32 x 32 fp32)
# reuse the ring.
PERSIST_UNITS, PERSIST_KC, PERSIST_STAGES, PERSIST_PAD = 16, 64, 3, 8
PERSIST_ROWS = 128   # batch rows at most: one 16-row m tile a warp
_WARPS = 8


def _warp_rows(b: int) -> int:
    """Warp rows of the kernel's 8 warps: the fewest of 1, 2, 4, 8 that
    cover the batch's 16-row m tiles (the rest split the k axis)."""
    tiles = -(-b // 16)
    return next(w for w in (1, 2, 4, 8) if w >= tiles)


def persist_smem_bytes(b: int, n: int, kres: int) -> int:
    """Bytes of dynamic shared memory a persistent K8/K9 block takes at
    batch ``b``, hidden ``n``, with ``kres`` rows of U held."""
    pitch_u = 4 * PERSIST_UNITS + PERSIST_PAD
    slot = 2 * (-(-b // 16) * 16 * (PERSIST_KC + PERSIST_PAD)
                + PERSIST_KC * pitch_u)
    red = _WARPS * 32 * 32 * 4 if _warp_rows(b) < _WARPS else 0
    return 2 * kres * pitch_u + max(PERSIST_STAGES * slot, red)


def split_rows(b: int, blocks: int, sms: int) -> int:
    """Batch rows a block of the tensor-core forward takes when ``blocks``
    column blocks would leave the card's ``sms`` SMs idle: all of them
    where the grid reaches half the SMs, else the fewest (the 16-row m
    tiles split 2, 4 or 8 ways) whose grid does, so that the step draws on
    L2 from enough SMs; 16 at most 8 ways."""
    tiles = -(-b // 16)
    for split in (1, 2, 4):
        rows = 16 * -(-tiles // split)
        if 2 * blocks * -(-b // rows) >= sms or rows == 16:
            return rows
    return 16 * -(-tiles // 8)


def fwd_layout(cfg: ModelConfig, b: int, n: int, sms: int, smem_limit: int,
               split: bool) -> Optional[Tuple[int, int]]:
    """The persistent forward's layout at (config, batch, hidden) on a
    device of ``sms`` SMs whose blocks may take ``smem_limit`` bytes of
    shared memory: (kres, rows), a block owning PERSIST_UNITS hidden units
    and ``rows`` batch rows and holding the first ``kres`` rows of its U
    slice in shared memory (whole KC-row chunks; the rest stream each
    step); None for the per-step design.

    The persistent design needs bf16 compute (the tensor cores; fp32
    products keep TF32 off), N a multiple of KC, at most 128 batch rows
    (one m tile a warp), and its grid of (N / 16) * ceil(B / rows) blocks
    resident at one a SM. ``rows`` is B, or with ``split`` the rows of
    ``split_rows`` (K1 and K15: at the bench's N = 512 a grid of N / 16 =
    32 blocks leaves most SMs idle). It holds as many of U's rows as fit
    beside its ring."""
    if cfg.cdtype != torch.bfloat16 or n % PERSIST_KC != 0:
        return None
    if not 1 <= b <= PERSIST_ROWS:
        return None
    blocks = n // PERSIST_UNITS
    rows = min(b, split_rows(b, blocks, sms)) if split else b
    if blocks * -(-b // rows) > sms:
        return None
    kres = held_rows(rows, n, smem_limit)
    return None if kres is None else (kres, rows)


def held_rows(rows: int, n: int, smem_limit: int) -> Optional[int]:
    """The rows of its N x 64 slice of U that a persistent forward block of
    ``rows`` batch rows holds in shared memory beside its ring (whole
    KC-row chunks, at most n), None where the ring alone does not fit."""
    free = smem_limit - persist_smem_bytes(rows, n, 0)
    if free < 0:
        return None
    row = 2 * (4 * PERSIST_UNITS + PERSIST_PAD)
    return min(n, free // row // PERSIST_KC * PERSIST_KC)


def tiled_fwd_plan(cfg: ModelConfig, b: int, n: int, sms: int,
                   smem_limit: int) -> Optional[int]:
    """K8/K9's design (and K2's) at (config, batch, hidden) on a device of
    ``sms`` SMs whose blocks may take ``smem_limit`` bytes of shared
    memory: the rows of U a block holds in shared memory for the
    persistent design, its blocks owning every batch row (``fwd_layout``
    unsplit), None for the per-step design."""
    layout = fwd_layout(cfg, b, n, sms, smem_limit, split=False)
    return None if layout is None else layout[0]


def split_fwd_plan(cfg: ModelConfig, b: int, n: int, sms: int,
                   smem_limit: int) -> Optional[Tuple[int, int]]:
    """K1's and K15's design: (kres, rows) of the persistent design with
    the batch split over the blocks (``fwd_layout`` with ``split``), None
    for their other design."""
    return fwd_layout(cfg, b, n, sms, smem_limit, split=True)


# K8's and K9's persistent design under fp32 compute
# (csrc/lstm_tiled_f32.cu: tiled_fwd_f32_persist, on CUDA cores: TF32 stays
# off), as the library lays out its shared memory (f32_persist_smem_bytes;
# ``_device_limits`` holds the two equal): a block of F32_THREADS threads
# owns F32_UNITS hidden units with their four gates and every batch row,
# holds its N x 4 * F32_UNITS slice of U (fp32) for the window, and streams
# h through a ring of slots of 32 R rows by KC columns, each row KC + 4
# floats, which the F32_SPLIT splits' partial sums (32 R rows x 4
# F32_UNITS) reuse; a thread's epilogue owns R = 1, 2 or 4 rows (B <= 32,
# 64, 128). F32_RINGS: the (KC, slots) the library is built for at each R,
# in the order the plan tries them (KC 32 for the widths the wider slots
# do not divide).
F32_UNITS = 8
F32_THREADS = 256
F32_SPLIT = 4    # ways the product splits a chunk's k
F32_ROWS = 128   # batch rows at most: 4 a thread
F32_RINGS = {1: ((128, 4), (32, 3)), 2: ((64, 4), (32, 3)), 4: ((64, 2), (32, 3))}


def f32_rows_per_thread(b: int) -> int:
    """Rows of the batch a thread of K8's and K9's fp32 persistent design
    owns."""
    return 1 if b <= 32 else 2 if b <= 64 else 4


def f32_persist_smem_bytes(b: int, n: int, kc: int, stages: int) -> int:
    """Bytes of dynamic shared memory a block of K8's and K9's fp32
    persistent design takes at batch ``b`` and hidden ``n`` with a ring of
    ``stages`` slots of ``kc`` columns."""
    rows = F32_THREADS // F32_UNITS * f32_rows_per_thread(b)
    ring, red = stages * rows * (kc + 4), F32_SPLIT * rows * 4 * F32_UNITS
    return 4 * (n * 4 * F32_UNITS + max(ring, red))


class F32Layout(NamedTuple):
    """K8's and K9's fp32 persistent design: a thread owns ``rows`` batch
    rows, the ring has ``stages`` slots of ``kc`` columns of h."""
    rows: int
    kc: int
    stages: int


def tiled_fwd_f32_plan(cfg: ModelConfig, b: int, n: int, sms: int,
                       smem_limit: int) -> Optional[F32Layout]:
    """K8's and K9's design under fp32 compute at (batch, hidden) on a
    device of ``sms`` SMs whose blocks may take ``smem_limit`` bytes of
    shared memory: the persistent CUDA-core design's layout (the first
    ring of F32_RINGS whose KC divides N and that fits beside the slice of
    U), or None for the per-step design (also under bf16 compute, whose
    plan is ``tiled_fwd_plan``).

    The design needs fp32 compute, N a multiple of a ring's KC (32 at
    least), at most F32_ROWS batch rows, its grid of N / F32_UNITS blocks
    resident at one an SM, and the whole slice of U with a ring in a
    block's shared memory (where the grid is resident on an H100 the slice
    always fits; a card with less shared memory refuses it rather than
    stream U)."""
    if cfg.cdtype != torch.float32:
        return None
    if not 1 <= b <= F32_ROWS or n // F32_UNITS > sms:
        return None
    rows = f32_rows_per_thread(b)
    ring = next((r for r in F32_RINGS[rows] if n % r[0] == 0
                 and f32_persist_smem_bytes(b, n, *r) <= smem_limit), None)
    return None if ring is None else F32Layout(rows, *ring)


class F32Split(NamedTuple):
    """K15's fp32 persistent design (K9's kernel in K15's mode): ``rows``
    batch rows a block, and the ring of a block of that many rows
    (``per`` rows a thread, ``stages`` slots of ``kc`` columns)."""
    rows: int
    per: int
    kc: int
    stages: int


def f32_split_rows(b: int, blocks: int, sms: int) -> int:
    """Batch rows a block of the fp32 persistent forward takes in K15's
    mode, where ``blocks`` column blocks (N / 8 at D = 1, nd / 8 at D
    ranks) would leave the ``sms`` SMs idle: every row where the grid
    reaches half the SMs, else the fewest of 2 and 4 block rows whose grid
    does (at the bench's N = 512, 64 blocks: 2 rows of 64 batch rows, 128
    blocks). A row's sums do not depend on the rows its block holds."""
    for split in (1, 2):
        rows = -(-b // split)
        if 2 * blocks * -(-b // rows) >= sms:
            return rows
    return -(-b // 4)


def f32_split_layout(b: int, n: int, blocks: int, sms: int, smem_limit: int,
                     rows: Optional[int] = None) -> Optional[F32Split]:
    """The fp32 persistent forward's layout in K15's mode for ``blocks``
    column blocks over h of width ``n``: ``rows`` (``f32_split_rows`` by
    default) batch rows a block, the first ring of F32_RINGS at that many
    rows whose KC divides N and that fits beside the N x 32 slice of U;
    None where the grid is not resident at one block an SM or nothing
    fits."""
    rows = min(b, rows or f32_split_rows(b, blocks, sms))
    if blocks * -(-b // rows) > sms:
        return None
    per = f32_rows_per_thread(rows)
    ring = next((r for r in F32_RINGS[per] if n % r[0] == 0
                 and f32_persist_smem_bytes(rows, n, *r) <= smem_limit), None)
    return None if ring is None else F32Split(rows, per, *ring)


def split_fwd_f32_plan(cfg: ModelConfig, b: int, n: int, sms: int,
                       smem_limit: int, split: bool = True) -> Optional[F32Split]:
    """K1's, K2's and K15's (at D = 1) design under fp32 compute at (batch,
    hidden) on a device of ``sms`` SMs whose blocks may take ``smem_limit``
    bytes of shared memory: the fp32 persistent kernel (K8's in its EMBED
    mode for K1, K9's for K2, K9's in K15's mode for K15) with the batch
    split over block rows (``f32_split_rows``: 2 rows of 64 at the bench's
    N = 512, B = 128; 8 rows a block at B = 16 there; one block row at N =
    1024; every row in a block without ``split``), or None for their other
    design (K1 and K2: one launch a step; K15: cooperative; also under bf16
    compute, whose plan is ``split_fwd_plan``, K2's ``tiled_fwd_plan``). It
    needs what ``tiled_fwd_f32_plan`` needs of K8 and K9: N a multiple of
    32, at most F32_ROWS batch rows, a resident grid, the slice of U and a
    ring in a block's shared memory (N = 2048's grid is not resident)."""
    if cfg.cdtype != torch.float32 or n % 32 or not 1 <= b <= F32_ROWS:
        return None
    return f32_split_layout(b, n, n // F32_UNITS, sms, smem_limit,
                            None if split else b)


# K13's fp32 step (csrc/lstm_tp_step_f32.cu: one step of the fp32
# persistent forward in K15's mode, planned by ``cuda_tp_cell.tp_step_plan``)
# as the library lays out its shared memory (step_f32_smem_bytes;
# ``_device_limits`` holds the two equal): no slice of U is held; a ring of
# slots, each the block's rows of h_full (32 R rows of KC + 4 floats) and KC
# rows of U_d's N x 32 slice, which the splits' partial sums (32 R rows of
# STEP_RED_PITCH floats a split) reuse. STEP_F32_RINGS: the (KC, slots) the
# library is built for at each R, in the order the plan tries them.
STEP_RED_PITCH = 4 * F32_UNITS + 8
STEP_F32_RINGS = {1: ((128, 4), (32, 4)), 2: ((64, 4), (32, 4)),
                  4: ((64, 4), (32, 4))}


def step_f32_smem_bytes(rows: int, kc: int, stages: int) -> int:
    """Bytes of dynamic shared memory a block of K13's fp32 step takes at
    ``rows`` batch rows with a ring of ``stages`` slots of ``kc``
    columns."""
    r = F32_THREADS // F32_UNITS * f32_rows_per_thread(rows)
    ring = stages * (r * (kc + 4) + kc * 4 * F32_UNITS)
    return 4 * max(ring, F32_SPLIT * r * STEP_RED_PITCH)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SMs, shared memory a block may opt in to) of card ``index``, read
    once; checks that the library lays out the shared memory of the
    persistent forward, the fp32 forwards, K10's persistent design and
    K13's fp32 step as ``persist_smem_bytes``, ``f32_persist_smem_bytes``,
    ``bwd_persist_smem_bytes`` and ``step_f32_smem_bytes`` do (the
    forward's also at K1's split layouts: 32 and 16 of 128 rows at N =
    512, 64 at N = 1024), and K10's fp32 design, K6's, through
    ``cuda_cell_bwd._device_limits``."""
    lib = _build.load_library()
    for b, n, kres in ((128, 2048, 1024), (16, 2048, 1344), (48, 1024, 0),
                       (32, 512, 512), (16, 512, 512), (64, 1024, 1024)):
        if lib.tiled_fwd_persist_smem_bytes(b, n, kres) != persist_smem_bytes(b, n, kres):
            raise RuntimeError("persist_smem_bytes disagrees with "
                               "csrc/lstm_tiled.cu's layout")
    for b, n, kc, st in ((128, 1024, 64, 2), (16, 1024, 128, 4), (32, 1024, 32, 3),
                         (64, 512, 64, 4), (100, 1056, 32, 3), (50, 512, 64, 4)):
        if lib.tiled_fwd_f32_smem_bytes(b, n, kc, st) != f32_persist_smem_bytes(b, n, kc, st):
            raise RuntimeError("f32_persist_smem_bytes disagrees with "
                               "csrc/lstm_tiled_f32.cu's layout")
    for rows, cres in ((64, 14), (32, 18), (16, 0), (48, 5)):
        if lib.tiled_bwd_persist_smem_bytes(rows, cres) != bwd_persist_smem_bytes(rows, cres):
            raise RuntimeError("bwd_persist_smem_bytes disagrees with "
                               "csrc/lstm_tiled.cu's layout")
    for rows, kc, st in ((128, 64, 4), (64, 64, 4), (32, 128, 4), (16, 32, 4),
                         (100, 32, 4)):
        if lib.tp_step_fwd_f32_smem_bytes(rows, kc, st) != step_f32_smem_bytes(rows, kc, st):
            raise RuntimeError("step_f32_smem_bytes disagrees with "
                               "csrc/lstm_tp_step_f32.cu's layout")
    return cuda_cell_bwd._device_limits(index)


def device_tiled_fwd_plan(cfg: ModelConfig, b: int, n: int) -> Optional[int]:
    """``tiled_fwd_plan`` with the current card's SMs and shared-memory
    limit."""
    return tiled_fwd_plan(cfg, b, n, *_device_limits(torch.cuda.current_device()))


def device_tiled_fwd_f32_plan(cfg: ModelConfig, b: int, n: int):
    """``tiled_fwd_f32_plan`` with the current card's SMs and shared-memory
    limit."""
    return tiled_fwd_f32_plan(cfg, b, n,
                              *_device_limits(torch.cuda.current_device()))


def device_split_fwd_plan(cfg: ModelConfig, b: int, n: int):
    """``split_fwd_plan`` with the current card's SMs and shared-memory
    limit."""
    return split_fwd_plan(cfg, b, n, *_device_limits(torch.cuda.current_device()))


def device_split_fwd_f32_plan(cfg: ModelConfig, b: int, n: int):
    """``split_fwd_f32_plan`` with the current card's SMs and shared-memory
    limit."""
    return split_fwd_f32_plan(cfg, b, n,
                              *_device_limits(torch.cuda.current_device()))


# The persistent K10's shared-memory layout, as csrc/lstm_tiled.cu lays it
# out (bwd_persist_smem_bytes; ``_device_limits`` holds the two equal): cres
# resident chunks of the block's U rows (BWD_UNITS rows of BWD_KC gate
# columns, each BWD_KC + PERSIST_PAD bf16), then a ring of BWD_STAGES
# slots, each the dg chunk of the block's 16-row m tiles and a U chunk; the
# cross-warp partial sums (8 warps x rows x BWD_RED_PITCH fp32) reuse it.
BWD_UNITS, BWD_KC, BWD_STAGES, BWD_RED_PITCH = 32, 128, 4, 40
BWD_ROWS = (16, 32, 48, 64)   # batch rows a block: the fewest that fit


def bwd_persist_smem_bytes(rows: int, cres: int) -> int:
    """Bytes of dynamic shared memory a persistent K10 block takes with
    ``rows`` batch rows and ``cres`` chunks of U held."""
    r16 = -(-rows // 16) * 16
    pitch = BWD_KC + PERSIST_PAD
    ring = 2 * BWD_STAGES * (r16 + BWD_UNITS) * pitch
    red = _WARPS * r16 * BWD_RED_PITCH * 4
    return 2 * cres * BWD_UNITS * pitch + max(ring, red)


def tiled_bwd_plan(cfg: ModelConfig, b: int, n: int, sms: int,
                   smem_limit: int) -> Optional[Tuple[int, int]]:
    """K10's design at (config, batch, hidden) on a device of ``sms`` SMs
    whose blocks may take ``smem_limit`` bytes of shared memory: (rows,
    cres) for the persistent design, a block owning BWD_UNITS hidden units
    and ``rows`` batch rows and holding the first ``cres`` of its 4N /
    BWD_KC chunks of U in shared memory (the rest stream each step); None
    for the per-step design.

    The persistent design needs bf16 compute (the tensor cores; fp32
    products keep TF32 off), N a multiple of BWD_UNITS, and its grid of
    (N / BWD_UNITS) * ceil(B / rows) blocks resident at one a SM: rows is
    the fewest of BWD_ROWS whose grid fits the SMs (more blocks share the
    dg reads). It holds as many chunks of U as fit beside its ring."""
    if cfg.cdtype != torch.bfloat16 or n % BWD_UNITS != 0:
        return None
    rows = next((r for r in BWD_ROWS if n // BWD_UNITS * -(-b // r) <= sms),
                None)
    if rows is None:
        return None
    free = smem_limit - bwd_persist_smem_bytes(rows, 0)
    if free < 0:
        return None
    chunk = 2 * BWD_UNITS * (BWD_KC + PERSIST_PAD)
    return rows, min(4 * n // BWD_KC, free // chunk)


def device_tiled_bwd_plan(cfg: ModelConfig, b: int, n: int):
    """``tiled_bwd_plan`` with the current card's SMs and shared-memory
    limit."""
    return tiled_bwd_plan(cfg, b, n, *_device_limits(torch.cuda.current_device()))


def tiled_bwd_f32_plan(cfg: ModelConfig, b: int, n: int, sms: int,
                       smem_limit: int) -> Optional[cuda_cell_bwd.F32Plan]:
    """K10's design under fp32 compute at (batch, hidden) on a device of
    ``sms`` SMs whose blocks may take ``smem_limit`` bytes of shared
    memory: K6's fp32 persistent design (``cuda_cell_bwd.k6_f32_plan``,
    csrc/lstm_bwd_f32.cu) in pairs of blocks, each block half of the gate
    axis (N / 8 blocks), or None for the per-step design (also under bf16
    compute, whose plan is ``tiled_bwd_plan``)."""
    return cuda_cell_bwd.k6_f32_plan(cfg, b, n, sms, smem_limit, blocks=(2,))


def device_tiled_bwd_f32_plan(cfg: ModelConfig, b: int, n: int):
    """``tiled_bwd_f32_plan`` with the current card's SMs and shared-memory
    limit."""
    return tiled_bwd_f32_plan(cfg, b, n,
                              *_device_limits(torch.cuda.current_device()))


def _kres_arg(cfg: ModelConfig, b: int, n: int) -> int:
    """The launchers' kres: the plan's, or -1 for the per-step design."""
    kres = device_tiled_fwd_plan(cfg, b, n)
    return -1 if kres is None else kres


def _fwd_layout_arg(cfg: ModelConfig, b: int):
    """K8's and K9's layout at batch ``b``: the fp32 persistent design's
    (``tiled_fwd_f32_plan``), else (kres, b) of ``tiled_fwd_plan``'s
    persistent design or, kres -1, the per-step design."""
    layout = device_tiled_fwd_f32_plan(cfg, b, cfg.hidden)
    return (_kres_arg(cfg, b, cfg.hidden), b) if layout is None else layout


def _fwd_buffers(h0, c0, s, b, n, cfg: ModelConfig, rd: torch.dtype,
                 residuals: bool, drop: bool):
    """The forward launchers' buffers, the sequences in ``rd``."""
    dev = h0.device
    seq = lambda *shape: torch.empty(s, b, *shape, dtype=rd, device=dev)
    hc = torch.empty(2, b, n, dtype=cfg.cdtype, device=dev)
    hc[0].copy_(h0)   # round(h0); the halves alternate between steps
    return dict(
        hc=hc, c=c0.to(AF).clone().contiguous(),
        hT=torch.empty(b, n, dtype=AF, device=dev), hseq=seq(n),
        cseq=seq(n) if residuals else None,
        gseq=seq(4 * n) if residuals else None,
        hdrop=seq(n) if drop else None,
    )


def _ptrs(o):
    p = lambda x: None if x is None else x.data_ptr()
    return (o["hc"].data_ptr(), o["c"].data_ptr(), o["hT"].data_ptr(),
            o["hseq"].data_ptr(), p(o["cseq"]), p(o["gseq"]), p(o["hdrop"]))


def _fwd_result(o, cfg: ModelConfig, residuals: bool):
    return _assemble(o["hseq"], o["hT"], o["c"], cfg, residuals, o["cseq"],
                     o["gseq"], o["hdrop"])


def _check_f32_layout(layout: F32Layout, cfg: ModelConfig, b: int):
    """Raises unless ``layout`` is the fp32 forward's at batch ``b``."""
    if cfg.cdtype != torch.float32 or layout.rows != f32_rows_per_thread(b):
        raise ValueError(f"{layout} is the fp32 layout at the batch {b}: fp32 "
                         f"compute and {f32_rows_per_thread(b)} rows a thread")


def _f32_block_rows(layout: Union[F32Layout, F32Split], cfg: ModelConfig,
                    b: int) -> F32Split:
    """The fp32 forward's layout as batch rows a block and its ring: an
    ``F32Layout`` (K8, K9) holds every row in one block; an ``F32Split``
    (K1, K2) is checked: fp32 compute, 1 to B rows a block, its rows a
    thread those of that many rows."""
    if isinstance(layout, F32Layout):
        _check_f32_layout(layout, cfg, b)
        return F32Split(b, *layout)
    if (cfg.cdtype != torch.float32 or not 1 <= layout.rows <= b
            or layout.per != f32_rows_per_thread(layout.rows)):
        raise ValueError(f"{layout} is no fp32 layout at the batch {b}: fp32 "
                         f"compute, 1 to {b} rows a block, the rows a thread "
                         f"of that many")
    return layout


def embed_launch(counter, layer, ids, h0, c0, cfg: ModelConfig,
                 rd: torch.dtype,
                 layout: Union[Tuple[int, int], F32Layout, F32Split],
                 residuals: bool, dropout):
    """One call of K8's launchers, which K1 (``cuda_cell.embed_layer0``)
    takes too: W and U in the compute type, b in fp32, the sequences in
    ``rd``; ``layout`` the persistent design's (kres, rows) (kres -1: the
    per-step design) through ``tiled_fwd_embed_launch``, or an
    ``F32Layout`` (K8: every batch row in a block) or ``F32Split`` (K1: the
    batch split over block rows): the fp32 persistent design through
    ``tiled_fwd_embed_f32_launch``. Adds the launches made to
    ``counter.launches``, then raises on a failed launch; returns the
    buffers."""
    s, b = ids.shape
    n = cfg.hidden
    f32 = isinstance(layout, (F32Layout, F32Split))
    if f32:
        layout = _f32_block_rows(layout, cfg, b)
    W_c, U_c, bias = (_aligned(x) for x in _embed_weights(layer, cfg))
    ids32 = ids.to(torch.int32).contiguous()
    drop = cuda_cell.drop_scalars(dropout)
    o = _fwd_buffers(h0, c0, s, b, n, cfg, rd, residuals, drop is not None)
    launched = ctypes.c_int(0)
    lib = _build.load_library()
    common = (W_c.data_ptr(), U_c.data_ptr(), bias.data_ptr(), ids32.data_ptr(),
              *_ptrs(o), s, b, n, int(cfg.cell_variant == "standard"))
    tail = (*(drop or (0, 0, 0.0)),
            torch.cuda.current_stream(ids.device).cuda_stream,
            ctypes.byref(launched))
    if f32:
        name = "tiled_fwd_embed_f32_launch"
        err = lib.tiled_fwd_embed_f32_launch(cuda_cell._TYPE_CODES[rd], *common,
                                             layout.rows, layout.kc,
                                             layout.stages, *tail)
    else:
        name = "tiled_fwd_embed_launch"
        err = lib.tiled_fwd_embed_launch(
            cuda_cell._TYPE_CODES[cfg.cdtype], cuda_cell._TYPE_CODES[rd],
            *common, *layout, *tail)
    counter.launches += launched.value
    cuda_cell._raise_on(err, name)
    return o


def tiled_embed_layer0(layer, ids, h0, c0, cfg: ModelConfig,
                       residuals: bool = False, dropout=None):
    """Layer 0, K8 on a CUDA tensor, the plain version on a CPU tensor.
    ids (S, B) byte ids; h0, c0 (B, N)."""
    _refuse_grad(layer, ids, h0, c0)
    cuda_cell._validate(layer, ids, h0, c0, cfg, embed=True)
    if ids.device.type == "cpu":
        return tiled_embed_layer0_plain(layer, ids, h0, c0, cfg, residuals,
                                        dropout)
    _kernel_codes(cfg, ids.device)
    o = embed_launch(tiled_embed_layer0, layer, ids, h0, c0, cfg,
                     types(cfg)[1], _fwd_layout_arg(cfg, ids.shape[1]),
                     residuals, dropout)
    return _fwd_result(o, cfg, residuals)


def scan_launch(counter, layer, xw, h0, c0, cfg: ModelConfig,
                rd: torch.dtype,
                layout: Union[Tuple[int, int], F32Layout, F32Split],
                residuals: bool, dropout):
    """One call of K9's launchers, which K2 (``cuda_cell.scan_layer``)
    takes too: U and the xw stream in the compute type, the sequences in
    ``rd``; ``layout`` the persistent design's (kres, rows) (kres -1: the
    per-step design) through ``tiled_fwd_scan_launch``, or an
    ``F32Layout`` (K9: every batch row in a block) or ``F32Split`` (K2: the
    batch split over block rows): the fp32 persistent design through
    ``tiled_fwd_scan_f32_launch``. Adds the launches made to
    ``counter.launches``, then raises on a failed launch; returns the
    buffers."""
    s, b, _ = xw.shape
    n = cfg.hidden
    f32 = isinstance(layout, (F32Layout, F32Split))
    if f32:
        layout = _f32_block_rows(layout, cfg, b)
    U_c = _aligned(layer.U.to(cfg.cdtype))
    xs = _aligned(xw.to(types(cfg)[2]))
    drop = cuda_cell.drop_scalars(dropout)
    o = _fwd_buffers(h0, c0, s, b, n, cfg, rd, residuals, drop is not None)
    launched = ctypes.c_int(0)
    lib = _build.load_library()
    common = (U_c.data_ptr(), xs.data_ptr(), *_ptrs(o), s, b, n,
              int(cfg.cell_variant == "standard"))
    tail = (*(drop or (0, 0, 0.0)),
            torch.cuda.current_stream(xw.device).cuda_stream,
            ctypes.byref(launched))
    if f32:
        name = "tiled_fwd_scan_f32_launch"
        err = lib.tiled_fwd_scan_f32_launch(cuda_cell._TYPE_CODES[rd], *common,
                                            layout.rows, layout.kc,
                                            layout.stages, *tail)
    else:
        name = "tiled_fwd_scan_launch"
        err = lib.tiled_fwd_scan_launch(
            cuda_cell._TYPE_CODES[cfg.cdtype], cuda_cell._TYPE_CODES[rd],
            *common, *layout, *tail)
    counter.launches += launched.value
    cuda_cell._raise_on(err, name)
    return o


def tiled_scan_layer(layer, xw, h0, c0, cfg: ModelConfig,
                     residuals: bool = False, dropout=None):
    """A layer >= 1 from xw = x @ W + b (S, B, 4N), K9 on a CUDA tensor,
    the plain version on a CPU tensor."""
    _refuse_grad(layer, xw, h0, c0)
    cuda_cell._validate(layer, xw, h0, c0, cfg, embed=False)
    if xw.device.type == "cpu":
        return tiled_scan_layer_plain(layer, xw, h0, c0, cfg, residuals,
                                      dropout)
    _kernel_codes(cfg, xw.device)
    o = scan_launch(tiled_scan_layer, layer, xw, h0, c0, cfg, types(cfg)[1],
                    _fwd_layout_arg(cfg, xw.shape[1]), residuals, dropout)
    return _fwd_result(o, cfg, residuals)


# --- the reverse steps -------------------------------------------------------


def tiled_bwd_plain(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT,
                    cfg: ModelConfig, dropout=None):
    """Plain version of K10: (dg_seq (S, B, 4N) in the xw type, dc0)."""
    _, _, xd = types(cfg)
    n = cfg.hidden
    s = g_seq.shape[0]
    drop = cuda_cell.drop_scalars(dropout) is not None
    U_a = U_c.to(cfg.cdtype).to(AF)
    dh_rec, dc = dhT.to(AF), dcT.to(AF)
    dgs = [None] * s
    for t in reversed(range(s)):
        c_prev = c_seq[t - 1] if t > 0 else c0
        cot = dh_seq[t].to(xd)
        dh_cot = (cuda_cell.apply_keep(cot, dropout, t, AF) if drop
                  else cot.to(AF))
        dg, dc = cell_ops.gate_bwd(
            g_seq[t].to(AF), c_seq[t].to(AF), c_prev.to(AF), dh_cot + dh_rec,
            dc, n, cfg.cell_variant)
        dgs[t] = dg.to(xd)
        dh_rec = dgs[t].to(cfg.cdtype).to(AF) @ U_a.T
    return torch.stack(dgs), dc


def tiled_bwd(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg: ModelConfig,
              dropout=None, dh0_out=None, dg_out=None):
    """The reverse steps, K10 on a CUDA tensor, the plain version on a CPU
    tensor. U_c (N, 4N); g_seq (S, B, 4N), c_seq (S, B, N) in the residual
    type; c0, dhT, dcT (B, N); dh_seq (S, B, N), the cotangent of h_seq (or
    of the masked stream under ``dropout``), rounded to the xw type here.
    Returns (dg_seq (S, B, 4N) in the xw type, dc0 fp32). ``dh0_out``, a
    (B, N) fp32 tensor, receives dh0 = round(dg_0) @ U_c^T: from the
    persistent designs' own last product, else through ``_mm``.
    ``dg_out``, an (S, B, 4N) fp32 tensor, receives the bf16 persistent
    design's fp32 dg (the check that its bf16 dg is that rounded); the
    other designs refuse it."""
    s, b = c_seq.shape[:2]
    n = cfg.hidden
    expected = (("U", U_c, (n, 4 * n)), ("g_seq", g_seq, (s, b, 4 * n)),
                ("c_seq", c_seq, (s, b, n)), ("c0", c0, (b, n)),
                ("dh_seq", dh_seq, (s, b, n)), ("dhT", dhT, (b, n)),
                ("dcT", dcT, (b, n)))
    for name, x, shape in expected:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != c_seq.device:
            raise ValueError(f"{name} on {x.device}, c_seq on {c_seq.device}")
    if dh0_out is not None and (
            tuple(dh0_out.shape) != (b, n) or dh0_out.dtype != AF
            or dh0_out.device != c_seq.device or not dh0_out.is_contiguous()):
        raise ValueError("dh0_out must be a contiguous (B, N) fp32 tensor on "
                         "the device of the sequences")
    if dg_out is not None and (
            tuple(dg_out.shape) != (s, b, 4 * n) or dg_out.dtype != AF
            or dg_out.device != c_seq.device or not dg_out.is_contiguous()):
        raise ValueError("dg_out must be a contiguous (S, B, 4N) fp32 tensor "
                         "on the device of the sequences")
    refused = "dg_out is written by K10's bf16 persistent design alone"
    if c_seq.device.type == "cpu":
        if dg_out is not None:
            raise ValueError(refused)
        dg, dc = tiled_bwd_plain(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg,
                                 dropout)
        if dh0_out is not None:
            dh0_out.copy_(_mm(dg[0], U_c.T, cfg))
        return dg, dc
    ctype, rtype = _kernel_codes(cfg, c_seq.device)
    _, rd, xd = types(cfg)
    dev = c_seq.device
    plan = device_tiled_bwd_plan(cfg, b, n)
    layout = device_tiled_bwd_f32_plan(cfg, b, n)
    persistent = plan is not None or layout is not None
    if dg_out is not None and plan is None:
        raise ValueError(refused)
    # the persistent designs read U's rows in place, the per-step one U^T
    U_k = U_c.to(cfg.cdtype)
    U_k = _aligned(U_k if persistent else U_k.t())
    seqs = [_aligned(x.to(rd)) for x in (g_seq, c_seq)]
    c0f, dhTf = (x.to(AF).contiguous() for x in (c0, dhT))
    dh = _aligned(dh_seq.to(xd))
    dc = dcT.to(AF).clone().contiguous()
    dg = torch.empty(s, b, 4 * n, dtype=xd, device=dev)
    dh0 = dh0_out
    if dh0 is None and persistent:   # the persistent launch writes it
        dh0 = torch.empty(b, n, dtype=AF, device=dev)
    drop = cuda_cell.drop_scalars(dropout)
    launched = ctypes.c_int(0)
    lib = _build.load_library()
    ptr = lambda x: None if x is None else x.data_ptr()
    common = (U_k.data_ptr(), seqs[0].data_ptr(), seqs[1].data_ptr(),
              c0f.data_ptr(), dh.data_ptr(), dhTf.data_ptr(), dc.data_ptr(),
              dg.data_ptr())
    standard = int(cfg.cell_variant == "standard")
    tail = (int(drop is not None), *(drop or (0, 0, 0.0)),
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    if layout is not None:
        name = "lstm_bwd_f32_launch"
        err = cuda_cell_bwd.reverse_f32(layout, cfg, U_k, seqs[0], seqs[1], c0f,
                                        dh, dhTf, dc, dg, dh0, dropout, launched)
    else:
        name = "tiled_bwd_launch"
        err = lib.tiled_bwd_launch(ctype, rtype, *common, ptr(dg_out), ptr(dh0),
                                   s, b, n, standard, *(plan or (-1, 0)), *tail)
    tiled_bwd.launches += launched.value
    cuda_cell._raise_on(err, name)
    if not persistent and dh0_out is not None:
        dh0_out.copy_(_mm(dg[0], U_c.T, cfg))
    return dg, dc


def tensor_core_dU(dg, h_seq, h0, cfg: ModelConfig):
    """dU = round(h_prev)^T round(dg) under bf16 compute on the card, on
    tensor cores (K6's ``lstm_bwd_dWU_launch``: bf16 in, fp32 sums),
    h_{-1} = h0 in the residual type; dg (S, B, 4N) in bf16. Counts its
    launches in ``.launches``."""
    _, rd, _ = types(cfg)
    s, b, n = h_seq.shape
    dev = h_seq.device
    if cfg.cdtype != torch.bfloat16 or dg.dtype != torch.bfloat16:
        raise TypeError("tensor_core_dU takes bf16 compute and a bf16 dg")
    lib = _build.load_library()
    f32 = dict(dtype=AF, device=dev)
    h_k = _aligned(h_seq.to(rd))
    h0_k = h0.to(rd).to(AF).contiguous()
    dg_k = _aligned(dg)
    dU = torch.empty(n, 4 * n, **f32)
    work = torch.empty(max(1, lib.lstm_bwd_scan_work_floats(s, b, n)), **f32)
    launched = ctypes.c_int(0)
    err = lib.lstm_bwd_dWU_launch(
        cuda_cell._TYPE_CODES[rd], h_k.data_ptr(), h0_k.data_ptr(), None,
        dg_k.data_ptr(), dU.data_ptr(), work.data_ptr(), s, b, n, 0,
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    tensor_core_dU.launches += launched.value
    cuda_cell._raise_on(err, "lstm_bwd_dWU_launch")
    return dU


tiled_embed_layer0.launches = 0
tiled_scan_layer.launches = 0
tiled_bwd.launches = 0
tensor_core_dU.launches = 0


def reset_launches():
    tiled_embed_layer0.launches = 0
    tiled_scan_layer.launches = 0
    tiled_bwd.launches = 0
    tensor_core_dU.launches = 0


def launches() -> Tuple[int, int, int]:
    """(K8, K9, K10) launches so far."""
    return (tiled_embed_layer0.launches, tiled_scan_layer.launches,
            tiled_bwd.launches)


# --- the VJPs ------------------------------------------------------------------


def _cotangents(cfg: ModelConfig, dh_out, dhT, dcT, h_seq, c0):
    """(dh_seq in the xw type, dhT, dcT in fp32): zeros, shaped as h_seq
    and c0, for an output that autograd did not reach; all three left the
    forward in the residual type (``:355-356``, ``:596-597``)."""
    _, rd, xd = types(cfg)

    def cot(x, like, to):
        if x is None:
            return torch.zeros(like.shape, dtype=to, device=like.device)
        return x.to(rd).to(to)

    return cot(dh_out, h_seq, xd), cot(dhT, c0, AF), cot(dcT, c0, AF)


def _reverse(ctx, U, h_seq, c_seq, g_seq, c0, dh_out, dhT, dcT):
    """K10 (or its plain version) from the autograd cotangents; returns
    (dg_seq in the xw type, dh0, dc0), dh0 = round(dg_0) @ U_c^T."""
    cfg = ctx.cfg
    U_c = U.to(cfg.cdtype)
    args = (U_c, g_seq, c_seq, c0.to(AF),
            *_cotangents(cfg, dh_out, dhT, dcT, h_seq, c0), cfg)
    if ctx.plain:
        dg, dc0 = tiled_bwd_plain(*args, dropout=ctx.dropout)
        return dg, _mm(dg[0], U_c.T, cfg), dc0
    dh0 = torch.empty(c0.shape, dtype=AF, device=c0.device)
    dg, dc0 = tiled_bwd(*args, dropout=ctx.dropout, dh0_out=dh0)
    return dg, dh0, dc0


def _dU(dg, h_seq, h0, cfg: ModelConfig, plain: bool):
    """round(h_prev)^T round(dg), h_{-1} = h0 in the residual type: on the
    card under bf16 compute through ``tensor_core_dU``, else through
    ``_mm`` (fp32 products, TF32 off)."""
    if (not plain and h_seq.device.type == "cuda"
            and cfg.cdtype == torch.bfloat16):
        return tensor_core_dU(dg, h_seq, h0, cfg)
    _, rd, _ = types(cfg)
    s, b, n = h_seq.shape
    h_prev = torch.cat([h0.to(rd)[None], h_seq[:-1]]).reshape(s * b, n)
    return _mm(h_prev.T, dg.reshape(s * b, 4 * n), cfg)


def _layer_out(out):
    h_seq, (hT, cT) = out[0], out[1]
    return (out[4] if len(out) == 5 else h_seq), hT, cT


class TiledEmbedLayer0(torch.autograd.Function):
    """Layer 0 of the tiled family, differentiable in W, U, b, h0 and c0:
    K8 with residuals, then K10 and the products of the module docstring.
    With ``plain`` both halves run their plain versions, on any device."""

    @staticmethod
    def forward(ctx, W, U, b, ids, h0, c0, cfg: ModelConfig, plain: bool,
                dropout):
        fwd = tiled_embed_layer0_plain if plain else tiled_embed_layer0
        out = fwd(LayerParams(W, U, b), ids, h0, c0, cfg, residuals=True,
                  dropout=dropout)
        ctx.save_for_backward(U, out[0], out[2], out[3], ids, h0, c0)
        ctx.cfg, ctx.plain, ctx.dropout = cfg, plain, dropout
        ctx.dtypes = (W.dtype, U.dtype, b.dtype, h0.dtype, c0.dtype)
        return _layer_out(out)

    @staticmethod
    def backward(ctx, dh_out, dhT, dcT):
        U, h_seq, c_seq, g_seq, ids, h0, c0 = ctx.saved_tensors
        cfg = ctx.cfg
        s, b = ids.shape
        dg, dh0, dc0 = _reverse(ctx, U, h_seq, c_seq, g_seq, c0, dh_out, dhT,
                                dcT)
        onehot = cell_ops.one_hot(ids.reshape(s * b), cfg.vocab, AF)
        dW = _mm(onehot.T, dg.reshape(s * b, -1), cfg)
        dU = _dU(dg, h_seq, h0, cfg, ctx.plain)
        db = dg.to(AF).sum((0, 1))
        wd, ud, bd, hd, cd = ctx.dtypes
        return (dW.to(cfg.cdtype).to(wd), dU.to(cfg.cdtype).to(ud), db.to(bd),
                None, dh0.to(hd), dc0.to(cd), None, None, None)


class TiledScanLayer(torch.autograd.Function):
    """A layer >= 1 of the tiled family, differentiable in U, xw, h0 and
    c0: K9 with residuals, then K10, dh0 and dU; W and b take their
    gradients through xw = x @ W + b outside. With ``plain`` both halves
    run their plain versions, on any device."""

    @staticmethod
    def forward(ctx, layer, U, xw, h0, c0, cfg: ModelConfig, plain: bool,
                dropout):
        fwd = tiled_scan_layer_plain if plain else tiled_scan_layer
        out = fwd(LayerParams(layer.W, U, layer.b), xw, h0, c0, cfg,
                  residuals=True, dropout=dropout)
        ctx.save_for_backward(U, out[0], out[2], out[3], h0, c0)
        ctx.cfg, ctx.plain, ctx.dropout = cfg, plain, dropout
        ctx.dtypes = (U.dtype, xw.dtype, h0.dtype, c0.dtype)
        return _layer_out(out)

    @staticmethod
    def backward(ctx, dh_out, dhT, dcT):
        U, h_seq, c_seq, g_seq, h0, c0 = ctx.saved_tensors
        cfg = ctx.cfg
        dg, dh0, dc0 = _reverse(ctx, U, h_seq, c_seq, g_seq, c0, dh_out, dhT,
                                dcT)
        dU = _dU(dg, h_seq, h0, cfg, ctx.plain)
        ud, xd, hd, cd = ctx.dtypes
        return (None, dU.to(cfg.cdtype).to(ud), dg.to(xd), dh0.to(hd),
                dc0.to(cd), None, None, None)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def differentiable_tiled_embed_layer0(layer, ids, h0, c0, cfg: ModelConfig,
                                      dropout=None, plain: bool = False):
    """``cell_fn.embed_layer0`` of the tiled family: (h_out, (hT, cT)) of
    layer 0, through ``TiledEmbedLayer0`` when autograd needs a gradient,
    else through K8 alone (no residuals)."""
    if _wants_grad(layer.W, layer.U, layer.b, h0, c0):
        h_out, hT, cT = TiledEmbedLayer0.apply(layer.W, layer.U, layer.b, ids,
                                               h0, c0, cfg, plain, dropout)
        return h_out, (hT, cT)
    fwd = tiled_embed_layer0_plain if plain else tiled_embed_layer0
    return fwd(layer, ids, h0, c0, cfg, dropout=dropout)


def differentiable_tiled_scan_layer(layer, xw, h0, c0, cfg: ModelConfig,
                                    dropout=None, plain: bool = False):
    """The ``cell_fn`` of the tiled family: (h_out, (hT, cT)) of a layer
    >= 1, through ``TiledScanLayer`` when autograd needs a gradient, else
    through K9 alone."""
    if _wants_grad(layer.W, layer.U, layer.b, xw, h0, c0):
        h_out, hT, cT = TiledScanLayer.apply(layer, layer.U, xw, h0, c0, cfg,
                                             plain, dropout)
        return h_out, (hT, cT)
    fwd = tiled_scan_layer_plain if plain else tiled_scan_layer
    return fwd(layer, xw, h0, c0, cfg, dropout=dropout)
