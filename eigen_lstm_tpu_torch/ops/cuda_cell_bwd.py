"""The backward kernels of the recurrence, their plain versions, and the
layers as autograd functions.

``embed_layer0_bwd`` (K3) replaces ``pallas_cell.py:_bwd_embed_fused_kernel``
(the backward of ``pallas_embed_layer0``'s custom VJP, ``:1027-1068``): from
the forward's residuals and the cotangents of (h_seq, hT, cT) it returns
dWU (M+N, 4N), db (4N,), dh0 and dc0 (B, N), all fp32.
``embed_layer0_bwd_unroll2`` (K12) replaces
``pallas_cell.py:_bwd_embed_unroll2_kernel``: the same function, bit for
bit, two reverse steps at a time, where the JAX package runs that kernel
(``EIGEN_LSTM_BWD_UNROLL=2``; ``ops.dispatch.bwd_unroll2``).
``scan_layer_bwd`` (K6) replaces ``pallas_cell.py:_bwd_kernel`` (:227) with
the dU product of ``_bwd_core`` (:393-414), the backward of
``pallas_scan_layer``: it returns dg_seq (S, B, 4N) in the xw type (bf16
under bf16 compute), dU (N, 4N), dh0 and dc0, fp32. dg_seq is the
cotangent of xw = x @ W + b, from which autograd takes db, dW and dx.

The three have three designs each (``csrc/lstm_bwd.cu``,
``csrc/lstm_bwd_f32.cu``), the same function. Under bf16 compute, where a
resident grid can hold U's rows in shared memory (``k6_plan``), they share
one persistent kernel: one cooperative launch for the reverse steps with
tensor-core products (``lstm_bwd_persist_launch``; K12 takes its steps in
pairs, K3 and K12 sum db in it), then the weight gradients in one
tensor-core product (``lstm_bwd_dWU_launch``: K6's dU, K3's and K12's dW
and dU). Under fp32 compute, where B <= 128 and a resident grid can hold U's
rows (``k6_f32_plan``: every width of the resident family, the flagship's
1024 too), they share one persistent CUDA-core kernel: one cooperative
launch for the reverse steps and dh0 (``lstm_bwd_f32_launch``, groups of 2
or 4 blocks splitting the gate axis; K12 with its steps in pairs, K3's
bits; K10, ``cuda_cell_tiled.tiled_bwd``, takes the same launch,
``reverse_f32``, in pairs of blocks, and K16 at D = 1,
``cuda_tp_seq.tp_seq_bwd``, with its c_prev advanced a step and cT as
c_last), then the CUDA-core reductions from
the fp32 dg (``lstm_bwd_tail_launch``: dU; K3's and K12's dW and db).
Elsewhere (N =
2048, B > 128) each takes one launch a reverse step (K12 two steps a
cooperative launch) and the same reductions (``lstm_bwd_embed_launch``,
``lstm_bwd_embed_unroll2_launch``, ``lstm_bwd_scan_launch``). The two plans
choose for all three from the shape, the type and the device's SMs and
shared memory. For a CUDA tensor each wrapper launches the design its plans
give or raises; for a CPU tensor it runs its plain version, which repeats
the kernels' arithmetic: dg in fp32 (``_reverse_plain``), rounded to the
compute type before dh_{t-1} = dg_c @ U_c^T and dU = round(h_{t-1})^T dg_c,
with h_{-1} = h0 (rounded to the residual type for K6, as ``_bwd_core``
rounds it); K3 adds dW[ids_t] += dg_c and db.

K3 copies whichever of the JAX package's two layer-0 VJPs the config takes
at the batch of the call (``ops.dispatch.fused_accum_ok``). With
``fused_accum`` (the fused VJP, ``pallas_cell.py:1031-1042``) db is the
sum of the unrounded fp32 dg and
h_{-1} = h0 as it is. Without it (the GEMM fall-back, ``:1044-1066``, which
the flagship takes in bf16) db is the fp32 sum of dg rounded to the xw
type, which ``_bwd_kernel`` emits, and h_{-1} = h0 rounded to the residual
type, as ``_bwd_core`` concatenates it. With ``dropout=(rate,
seed)`` the cotangent of h_seq is the masked stream's: step t masks it with
the forward's keep(seed, t) and scales it by inv before it meets the
recurrent dh (``pallas_cell.py:629-634``).

``differentiable_embed_layer0`` and ``differentiable_scan_layer`` are the
layers as ``models.lstm.forward`` calls them: the forward kernel (with
residuals) and the backward kernel inside a ``torch.autograd.Function``
when a gradient is wanted, the forward kernel alone otherwise. As the JAX
custom VJPs do, they hand dW and dU back rounded to the compute type
(``dWU.astype(WU.dtype)``, ``pallas_cell.py:1039``; ``dU.astype(U.dtype)``,
``:409``), and dh0, dc0 from fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..models.lstm import LayerParams
from . import _build
from . import cell as cell_ops
from . import cuda_cell


def _reverse_plain(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg: ModelConfig,
                   dropout):
    """The reverse steps both kernels take: the (S, B, 4N) dg sequence,
    dh0 = round(dg_0) @ U^T and dc0, in the accumulation type."""
    af = cuda_cell._acc_dtype(cfg)
    n = cfg.hidden
    s = g_seq.shape[0]
    drop = cuda_cell.drop_scalars(dropout) is not None
    U_a = U_c.to(af)
    dh, dc = dhT.to(af), dcT.to(af)
    dgs = [None] * s
    for t in reversed(range(s)):
        c_prev = c_seq[t - 1] if t > 0 else c0
        dh_cot = (cuda_cell.apply_keep(dh_seq[t], dropout, t, af) if drop
                  else dh_seq[t].to(af))
        dgs[t], dc = cell_ops.gate_bwd(
            g_seq[t].to(af), c_seq[t].to(af), c_prev.to(af), dh_cot + dh, dc,
            n, cfg.cell_variant,
        )
        dh = dgs[t].to(cfg.cdtype).to(af) @ U_a.T
    return torch.stack(dgs), dh, dc


def _round(x, cfg: ModelConfig):
    return x.to(cfg.cdtype).to(cuda_cell._acc_dtype(cfg))


def _h_minus_1(h0, cfg: ModelConfig, fused_accum: bool):
    """K3's h_{-1}: h0 as it is for the fused VJP, rounded to the residual
    type for the GEMM fall-back."""
    return h0 if fused_accum else h0.to(cfg.rdtype)


def embed_layer0_bwd_plain(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq,
                           dhT, dcT, cfg: ModelConfig, dg_out=None,
                           dropout=None, fused_accum: bool = True):
    """Plain version of the layer-0 backward kernel K3; ``dg_out`` and
    ``fused_accum`` as the kernel's."""
    af = cuda_cell._acc_dtype(cfg)
    s, b = ids.shape
    n = cfg.hidden
    dg, dh, dc = _reverse_plain(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg,
                                dropout)
    if dg_out is not None:
        dg_out.copy_(dg)
    dg = dg.reshape(s * b, 4 * n)
    dg_c = _round(dg, cfg)
    h0 = _h_minus_1(h0, cfg, fused_accum)
    h_prev = torch.cat([h0.to(af)[None], h_seq[:-1].to(af)]).reshape(s * b, n)
    dU = _round(h_prev, cfg).T @ dg_c
    dW = torch.zeros(cfg.vocab, 4 * n, dtype=af, device=dg.device)
    dW.index_add_(0, ids.reshape(-1).long(), dg_c)
    db = dg if fused_accum else dg.to(cuda_cell.xw_type(cfg)).to(af)
    return torch.cat([dW, dU]), db.sum(0), dh, dc


def embed_layer0_bwd_unroll2_plain(U_c, g_seq, c_seq, h_seq, ids, h0, c0,
                                   dh_seq, dhT, dcT, cfg: ModelConfig,
                                   dg_out=None, dropout=None,
                                   fused_accum: bool = True):
    """Plain version of K12 (S even): K3's plain version. K12's pairs
    (tau1 = S-1-2i, then tau1-1) visit the same reverse steps in the same
    order as K3, so the function is the same, bit for bit."""
    if ids.shape[0] % 2 != 0:
        raise ValueError(f"the two-step backward takes an even S, got "
                         f"{ids.shape[0]}")
    return embed_layer0_bwd_plain(U_c, g_seq, c_seq, h_seq, ids, h0, c0,
                                  dh_seq, dhT, dcT, cfg, dg_out, dropout,
                                  fused_accum)


def scan_layer_bwd_plain(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq, dhT, dcT,
                         cfg: ModelConfig, dg_out=None, dropout=None):
    """Plain version of the layers >= 1 backward kernel; ``dg_out`` as the
    kernel's."""
    af = cuda_cell._acc_dtype(cfg)
    s, b, n = h_seq.shape
    dg, dh, dc = _reverse_plain(U_c, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg,
                                dropout)
    if dg_out is not None:
        dg_out.copy_(dg)
    dg_x = dg.to(cuda_cell.xw_type(cfg))
    h_prev = torch.cat([h0.to(cfg.rdtype)[None], h_seq[:-1].to(cfg.rdtype)])
    dU = (_round(h_prev.reshape(s * b, n), cfg).T
          @ _round(dg_x.reshape(s * b, 4 * n), cfg))
    return dg_x, dU, dh, dc


# The persistent design's shared-memory layout, as csrc/lstm_bwd.cu lays it out
# (persist_smem_bytes; ``_device_limits`` holds the two equal): a group's U
# rows, each 4N + PAD bf16, then a ring of STAGES chunks of at most ROWS
# batch rows by KC gate columns, each row KC + PAD bf16.
PERSIST_ROWS, PERSIST_KC, PERSIST_STAGES, PERSIST_PAD = 64, 128, 3, 8


def persist_smem_bytes(n: int, units: int) -> int:
    """Bytes of dynamic shared memory a persistent block takes."""
    return 2 * (units * (4 * n + PERSIST_PAD)
                + PERSIST_STAGES * PERSIST_ROWS * (PERSIST_KC + PERSIST_PAD))


def k6_plan(cfg: ModelConfig, b: int, n: int, sms: int, smem_limit: int):
    """The design of K6, K3 and K12 at (config, batch, hidden) on a device
    of ``sms`` SMs whose blocks may take ``smem_limit`` bytes of shared
    memory: (units, rows) for the persistent design, a block holding
    ``units`` rows of U and ``rows`` batch rows, its grid (n / units) *
    ceil(b / rows) blocks at one a SM; None for the per-step design.

    The persistent design needs bf16 compute (the tensor cores; fp32
    products keep TF32 off) and a grid that is resident at once. Units: 16
    where their U rows fit, else 8 (fewer, wider groups read dg_{t+1} from
    L2 fewer times a step); rows: the fewest of 16, 32, 48, 64 whose grid
    fits the SMs (more blocks share the same reads)."""
    if cfg.cdtype != torch.bfloat16 or n % 32 != 0:
        return None
    fits = [u for u in (16, 8) if persist_smem_bytes(n, u) <= smem_limit]
    if not fits:
        return None
    units = fits[0]
    for rows in (16, 32, 48, PERSIST_ROWS):
        if n // units * -(-b // rows) <= sms:
            return units, rows
    return None


# The persistent design under fp32 compute (csrc/lstm_bwd_f32.cu:
# lstm_bwd_f32_persist, on CUDA cores: TF32 stays off), as the library lays
# out its shared memory (f32_smem_bytes; ``_device_limits`` holds the two
# equal): groups of G = F32_BLOCKS blocks of F32_THREADS threads, a group
# owning F32_UNITS hidden units and every batch row, its block p the
# columns p 4N / G .. of the gate axis and the epilogue of F32_UNITS / G of
# the units; a block holds the group's U rows over its columns (fp32) for
# the window and streams its columns of dg_{t+1} through a ring of slots of
# 16 RR rows by F32_KC columns, which the F32_SPLIT splits' partial sums (16
# RR rows of F32_RED_PITCH floats) reuse; a thread's product tile has RR =
# 1, 2, 4 or 8 rows (B <= 16, 32, 64, 128). Split s takes the k of its
# block with (k mod 32) / 4 = s at every batch, and the G blocks' parts of
# each sum meet in part order. F32_RINGS: the slots the library is built
# for at each RR, in the order the plan tries them.
F32_UNITS = 16
F32_THREADS = 256
F32_SPLIT = 8        # ways the product splits a block's k: a warp each
F32_KC = 64          # gate columns of a ring slot
F32_RED_PITCH = 20   # floats of a row of partial sums
F32_ROWS = 128       # batch rows at most: 8 product rows a thread
F32_BLOCKS = (4, 2)  # blocks a group, in the order the plan tries them
F32_RINGS = {1: (6,), 2: (6,), 4: (5,), 8: (3, 2)}


def f32_rows_per_thread(b: int) -> int:
    """Product rows a thread of the fp32 persistent design takes at batch
    ``b``."""
    return 1 if b <= 16 else 2 if b <= 32 else 4 if b <= 64 else 8


def f32_smem_bytes(b: int, n: int, blocks: int, stages: int) -> int:
    """Bytes of dynamic shared memory a block of the fp32 persistent
    design takes at batch ``b`` and hidden ``n``, ``blocks`` blocks a
    group, with ``stages`` ring slots."""
    rows = 16 * f32_rows_per_thread(b)
    ring = stages * rows * F32_KC
    red = F32_SPLIT * rows * F32_RED_PITCH
    return 4 * (4 * n // blocks * F32_UNITS + max(ring, red))


class F32Plan(NamedTuple):
    """The fp32 persistent design's layout: ``blocks`` blocks a group of
    F32_UNITS units, ``rows`` product rows a thread, ``stages`` ring
    slots."""
    blocks: int
    rows: int
    stages: int


def k6_f32_plan(cfg: ModelConfig, b: int, n: int, sms: int, smem_limit: int,
                blocks=F32_BLOCKS) -> Optional[F32Plan]:
    """The design of K6, K3 and K12 under fp32 compute at (batch, hidden)
    on a device of ``sms`` SMs whose blocks may take ``smem_limit`` bytes
    of shared memory: the persistent CUDA-core design's layout, or None
    for the per-step design (also under bf16 compute, whose plan is
    ``k6_plan``). K10's plan (``cuda_cell_tiled.tiled_bwd_f32_plan``) is
    this one with ``blocks`` (2,).

    The design needs fp32 compute, N a multiple of 32, at most F32_ROWS
    batch rows, a grid of N / F32_UNITS groups of G blocks resident at one
    an SM, and the group's U rows over a block's columns with a ring in a
    block's shared memory. G is the first of ``blocks`` (4, then 2) whose
    grid is resident and whose blocks' columns (4N / G) are whole ring
    slots: 4 at N = 512 (128 blocks), 2 at N = 1024 (128 blocks). The
    grid does not depend on the batch, so at a given width every batch
    takes one G, and the sums one order. N = 2048 is refused: its 256
    blocks at G = 2 are not resident on 132 SMs (and U, 64 MB in fp32,
    fits no card's shared memory), so it keeps the per-step design."""
    if cfg.cdtype != torch.float32 or n % 32 != 0:
        return None
    if not 1 <= b <= F32_ROWS:
        return None
    rows = f32_rows_per_thread(b)
    for g in blocks:
        if (4 * n // g) % F32_KC != 0 or n // F32_UNITS * g > sms:
            continue
        stages = next((st for st in F32_RINGS[rows]
                       if f32_smem_bytes(b, n, g, st) <= smem_limit), None)
        return None if stages is None else F32Plan(g, rows, stages)
    return None


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SMs, shared memory a block may opt in to) of card ``index``, read
    once; checks that the library lays out the persistent designs' shared
    memory as ``persist_smem_bytes`` and ``f32_smem_bytes`` do (the latter
    also at one block a group and a shard's width: K16's fp32 design at D
    ranks, ``cuda_tp_seq.ranks_bwd_f32_plan``)."""
    lib = _build.load_library()
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        cuda_cell._raise_on(lib.lstm_bwd_device_limits(ctypes.byref(sms),
                                                       ctypes.byref(smem)),
                            "lstm_bwd_device_limits")
    for n, units in ((1024, 8), (1024, 16), (2048, 16)):
        if lib.lstm_bwd_persist_smem_bytes(n, units) != persist_smem_bytes(n, units):
            raise RuntimeError("persist_smem_bytes disagrees with "
                               "csrc/lstm_bwd.cu's layout")
    for b, n, blocks, st in ((128, 1024, 2, 3), (128, 512, 4, 3), (16, 512, 4, 6),
                             (64, 640, 2, 5), (100, 1056, 2, 2), (128, 512, 1, 3),
                             (128, 256, 2, 3)):
        if lib.lstm_bwd_f32_smem_bytes(b, n, blocks, st) != f32_smem_bytes(b, n, blocks, st):
            raise RuntimeError("f32_smem_bytes disagrees with "
                               "csrc/lstm_bwd_f32.cu's layout")
    return sms.value, smem.value


def device_k6_plan(cfg: ModelConfig, b: int, n: int):
    """``k6_plan`` with the current card's SMs and shared-memory limit."""
    return k6_plan(cfg, b, n, *_device_limits(torch.cuda.current_device()))


def device_k6_f32_plan(cfg: ModelConfig, b: int, n: int) -> Optional[F32Plan]:
    """``k6_f32_plan`` with the current card's SMs and shared-memory
    limit."""
    return k6_f32_plan(cfg, b, n, *_device_limits(torch.cuda.current_device()))


def _validate(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq, dhT, dcT,
              cfg: ModelConfig, dg_out):
    s, b = h_seq.shape[:2]
    n = cfg.hidden
    expected = (("U", U_c, (n, 4 * n)), ("g_seq", g_seq, (s, b, 4 * n)),
                ("c_seq", c_seq, (s, b, n)), ("h_seq", h_seq, (s, b, n)),
                ("h0", h0, (b, n)), ("c0", c0, (b, n)),
                ("dh_seq", dh_seq, (s, b, n)), ("dhT", dhT, (b, n)),
                ("dcT", dcT, (b, n)))
    for name, x, shape in expected:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != h_seq.device:
            raise ValueError(f"{name} on {x.device}, h_seq on {h_seq.device}")
    if dg_out is not None and (
            tuple(dg_out.shape) != (s, b, 4 * n) or dg_out.dtype != torch.float32
            or dg_out.device != h_seq.device or not dg_out.is_contiguous()):
        raise ValueError("dg_out must be a contiguous (S, B, 4N) fp32 tensor "
                         "on the device of the sequences")


def _dg_scratch(dg_out, s, b, n, device):
    """The kernels' (S, B, 4N) fp32 dg sequence: ``dg_out`` when given (for
    a check that replays each step from it), else a new tensor."""
    if dg_out is None:
        return torch.empty(s, b, 4 * n, dtype=torch.float32, device=device)
    return dg_out


def _kernel_inputs(U_c, seqs, cfg: ModelConfig, *fp32, transpose=True):
    """U^T (U with ``transpose`` False) in the compute type, the residual
    sequences in the residual type and the rest in fp32, all contiguous."""
    U_k = U_c.to(cfg.cdtype)
    return ((U_k.t() if transpose else U_k).contiguous(),
            [x.to(cfg.rdtype).contiguous() for x in seqs],
            [x.to(torch.float32).contiguous() for x in fp32])


def _launch_args(cfg: ModelConfig, dropout, device, *flags):
    """The launchers' trailing arguments: the cell variant, ``flags``, the
    dropout's and the stream."""
    drop = cuda_cell.drop_scalars(dropout)
    return ((int(cfg.cell_variant == "standard"),) + flags
            + (int(drop is not None),) + (drop or (0, 0, 0.0))
            + (torch.cuda.current_stream(device).cuda_stream,))


def _new_dgx(s: int, b: int, n: int, device):
    """The persistent design's (S, B, 4N) bf16 dg sequence, which its two
    launches write and read (a function, so that a check on the card can
    keep the buffer it returns)."""
    return torch.empty(s, b, 4 * n, dtype=torch.bfloat16, device=device)


def _persist(plan, cfg: ModelConfig, seqs, ins, U_k, dc, dg_out, dh0, out,
             work, dropout, launched, ids=None, db=None, round_db=False,
             steps=1):
    """The persistent design on the card: the reverse launch (db when
    given, K3 and K12), then the weight-gradient product into ``out`` (dU,
    or with ``ids`` dWU). ``seqs`` and ``ins`` as ``_kernel_inputs`` gives
    them, with h_{-1} first in ``ins``. Returns (the bf16 dg sequence,
    error code, name of the launcher that returned it)."""
    g_k, c_k, h_k = seqs
    h_m1, c0_k, dh_k, dhT_k = ins
    s, b, n = h_k.shape
    dev = h_k.device
    rtype = cuda_cell._TYPE_CODES[cfg.rdtype]
    lib = _build.load_library()
    dgx = _new_dgx(s, b, n, dev)
    name = "lstm_bwd_persist_launch"
    err = lib.lstm_bwd_persist_launch(
        rtype, U_k.data_ptr(), g_k.data_ptr(), c_k.data_ptr(), c0_k.data_ptr(),
        None, dh_k.data_ptr(), dhT_k.data_ptr(), dc.data_ptr(), dgx.data_ptr(),
        None if dg_out is None else dg_out.data_ptr(), dh0.data_ptr(),
        None if db is None else db.data_ptr(), work.data_ptr(), s, b, n,
        *plan, steps, *_launch_args(cfg, dropout, dev, int(round_db)),
        ctypes.byref(launched),
    )
    if err == 0:
        name = "lstm_bwd_dWU_launch"
        err = lib.lstm_bwd_dWU_launch(
            rtype, h_k.data_ptr(), h_m1.data_ptr(),
            None if ids is None else ids.data_ptr(), dgx.data_ptr(),
            out.data_ptr(), work.data_ptr(), s, b, n,
            0 if ids is None else cfg.vocab,
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    return dgx, err, name


def reverse_f32(plan: F32Plan, cfg: ModelConfig, U_k, g_k, c_k, c0_k, dh_k,
                dhT_k, dc, dg, dh0, dropout, launched, steps: int = 1,
                c_last=None) -> int:
    """The fp32 persistent design's reverse launch on the card (K6, K3,
    K12 with ``steps`` 2, K10, and K16 at D = 1): the S reverse steps into
    the fp32 ``dg``, dc0 into ``dc`` (dcT on entry) and dh0 = dg_0 @ U^T
    into ``dh0``. U_k (N, 4N) fp32 read in place, g_k (S, B, 4N) and c_k in
    the residual type; ``c_last`` None, or the fp32 c_{S-1} that the kernel
    reads in place of c_k[S-1] (K16: cT, with c_k its c_prev advanced a
    step, S - 1 steps long). Adds its launch to ``launched``; returns the
    error code."""
    s, b, n4 = g_k.shape
    n = n4 // 4
    # the groups' parts of dh_rec, exchanged within the launch
    xbuf = torch.empty(plan.blocks * b * n, dtype=torch.float32, device=g_k.device)
    return _build.load_library().lstm_bwd_f32_launch(
        cuda_cell._TYPE_CODES[g_k.dtype], U_k.data_ptr(), g_k.data_ptr(),
        c_k.data_ptr(), c0_k.data_ptr(),
        None if c_last is None else c_last.data_ptr(), dh_k.data_ptr(),
        dhT_k.data_ptr(), dc.data_ptr(), dg.data_ptr(), xbuf.data_ptr(),
        dh0.data_ptr(), s, b, n, plan.blocks, plan.stages, steps,
        *_launch_args(cfg, dropout, g_k.device), ctypes.byref(launched))


def _persist_f32(plan: F32Plan, cfg: ModelConfig, seqs, ins, U_k, dc, dg, dh0,
                 out, work, dropout, launched, ids=None, db=None,
                 round_db=False, steps=1):
    """The fp32 persistent design on the card: the reverse launch into the
    fp32 ``dg``, then the weight gradients from it into ``out`` (dU, or
    with ``ids`` dWU and db). ``seqs`` and ``ins`` as ``_kernel_inputs``
    gives them, with h_{-1} first in ``ins``. Returns (error code, name of
    the launcher that returned it)."""
    g_k, c_k, h_k = seqs
    h_m1, c0_k, dh_k, dhT_k = ins
    s, b, n = h_k.shape
    dev = h_k.device
    err = reverse_f32(plan, cfg, U_k, g_k, c_k, c0_k, dh_k, dhT_k, dc, dg, dh0,
                      dropout, launched, steps)
    if err != 0:
        return err, "lstm_bwd_f32_launch"
    err = _build.load_library().lstm_bwd_tail_launch(
        cuda_cell._TYPE_CODES[cfg.rdtype], h_k.data_ptr(),
        None if ids is None else ids.data_ptr(), h_m1.data_ptr(),
        dg.data_ptr(), out.data_ptr(), None if db is None else db.data_ptr(),
        work.data_ptr(), s, b, n, 0 if ids is None else cfg.vocab,
        int(round_db), torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(launched))
    return err, "lstm_bwd_tail_launch"


def _embed_bwd(unroll2: bool, U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq,
               dhT, dcT, cfg: ModelConfig, dg_out, dropout, fused_accum: bool):
    """K3 (``unroll2`` False) or K12 on a CUDA tensor, in the design
    ``k6_plan`` (bf16) or ``k6_f32_plan`` (fp32) gives, else the per-step
    one; their plain versions on a CPU tensor; returns (outputs, kernel
    launches, error code, the launcher that returned it)."""
    _validate(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq, dhT, dcT, cfg, dg_out)
    if tuple(ids.shape) != tuple(h_seq.shape[:2]) or ids.device != h_seq.device:
        raise ValueError(f"ids {tuple(ids.shape)} on {ids.device} do not "
                         f"match h_seq {tuple(h_seq.shape)} on {h_seq.device}")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f"ids must be integer byte ids, got {ids.dtype}")
    s, b = ids.shape
    if unroll2 and (s < 2 or s % 2 != 0):
        raise ValueError(f"the two-step backward takes an even S, got {s}")
    if ids.device.type == "cpu":
        return embed_layer0_bwd_plain(U_c, g_seq, c_seq, h_seq, ids, h0, c0,
                                      dh_seq, dhT, dcT, cfg, dg_out, dropout,
                                      fused_accum), 0, 0, ""
    ctype, rtype = cuda_cell._kernel_types(cfg, ids.device)
    n, m = cfg.hidden, cfg.vocab
    dev = ids.device
    f32 = dict(dtype=torch.float32, device=dev)
    plan = device_k6_plan(cfg, b, n)
    layout = None if plan is not None else device_k6_f32_plan(cfg, b, n)
    U_k, seqs, ins = _kernel_inputs(U_c, (g_seq, c_seq, h_seq), cfg,
                                    _h_minus_1(h0, cfg, fused_accum), c0,
                                    dh_seq, dhT,
                                    transpose=plan is None and layout is None)
    ids32 = ids.to(torch.int32).contiguous()
    dc = dcT.to(torch.float32).clone().contiguous()
    dWU = torch.empty(m + n, 4 * n, **f32)
    db = torch.empty(4 * n, **f32)
    dh0 = torch.empty(b, n, **f32)
    lib = _build.load_library()
    work = torch.empty(max(1, lib.lstm_bwd_embed_work_floats(s, b, n, m)), **f32)
    launched = ctypes.c_int(0)
    if plan is not None:
        # dg stored once, in bf16; the fp32 dg only into dg_out
        _, err, name = _persist(plan, cfg, seqs, ins, U_k, dc, dg_out, dh0,
                                dWU, work, dropout, launched, ids=ids32, db=db,
                                round_db=not fused_accum,
                                steps=2 if unroll2 else 1)
    elif layout is not None:
        err, name = _persist_f32(layout, cfg, seqs, ins, U_k, dc,
                                 _dg_scratch(dg_out, s, b, n, dev), dh0, dWU,
                                 work, dropout, launched, ids=ids32, db=db,
                                 round_db=not fused_accum,
                                 steps=2 if unroll2 else 1)
    else:
        dg = _dg_scratch(dg_out, s, b, n, dev)
        name = ("lstm_bwd_embed_unroll2_launch" if unroll2
                else "lstm_bwd_embed_launch")
        err = getattr(lib, name)(
            ctype, rtype, U_k.data_ptr(), *(x.data_ptr() for x in seqs),
            ids32.data_ptr(), *(x.data_ptr() for x in ins), dc.data_ptr(),
            dg.data_ptr(), dWU.data_ptr(), db.data_ptr(), dh0.data_ptr(),
            work.data_ptr(), s, b, n, m,
            *_launch_args(cfg, dropout, dev, int(not fused_accum)),
            ctypes.byref(launched),
        )
    return (dWU, db, dh0, dc), launched.value, err, name


def embed_layer0_bwd(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq, dhT, dcT,
                     cfg: ModelConfig, dg_out=None, dropout=None,
                     fused_accum: bool = True):
    """Layer-0 backward (K3): the kernel on a CUDA tensor, the plain version
    on a CPU tensor. U_c: (N, 4N) in the compute type; g_seq (S, B, 4N),
    c_seq and h_seq (S, B, N) in the residual type; ids (S, B); h0, c0,
    dh_seq, dhT, dcT fp32. Returns (dWU (M+N, 4N), db (4N,), dh0, dc0) in
    fp32. ``dg_out``, an (S, B, 4N) fp32 tensor, receives the dg sequence.
    ``fused_accum``: the JAX VJP copied, fused (True) or the GEMM fall-back
    (the module docstring)."""
    out, launched, err, name = _embed_bwd(False, U_c, g_seq, c_seq, h_seq,
                                          ids, h0, c0, dh_seq, dhT, dcT, cfg,
                                          dg_out, dropout, fused_accum)
    embed_layer0_bwd.launches += launched
    cuda_cell._raise_on(err, name)
    return out


def embed_layer0_bwd_unroll2(U_c, g_seq, c_seq, h_seq, ids, h0, c0, dh_seq,
                             dhT, dcT, cfg: ModelConfig, dg_out=None,
                             dropout=None, fused_accum: bool = True):
    """Layer-0 backward through K12, which replaces
    ``pallas_cell.py:_bwd_embed_unroll2_kernel``: K3's function, bit for
    bit, the reverse steps in pairs (the persistent design issues a pair's
    loads together, the per-step one launches a pair at a time); S must be
    even. The kernel on a CUDA tensor, ``embed_layer0_bwd_unroll2_plain``
    on a CPU tensor; arguments and results as ``embed_layer0_bwd``'s."""
    out, launched, err, name = _embed_bwd(True, U_c, g_seq, c_seq, h_seq,
                                          ids, h0, c0, dh_seq, dhT, dcT, cfg,
                                          dg_out, dropout, fused_accum)
    embed_layer0_bwd_unroll2.launches += launched
    cuda_cell._raise_on(err, name)
    return out


def scan_layer_bwd(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq, dhT, dcT,
                   cfg: ModelConfig, dg_out=None, dropout=None):
    """Layers >= 1 backward: the kernel on a CUDA tensor, the plain version
    on a CPU tensor. Inputs as ``embed_layer0_bwd`` without ids. Returns
    (dg_seq (S, B, 4N) in ``cuda_cell.xw_type``, dU (N, 4N), dh0, dc0),
    fp32 but dg_seq. ``dg_out`` receives the fp32 dg sequence."""
    _validate(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq, dhT, dcT, cfg, dg_out)
    if h_seq.device.type == "cpu":
        return scan_layer_bwd_plain(U_c, g_seq, c_seq, h_seq, h0, c0, dh_seq,
                                    dhT, dcT, cfg, dg_out, dropout)
    ctype, rtype = cuda_cell._kernel_types(cfg, h_seq.device)
    s, b, n = h_seq.shape
    dev = h_seq.device
    f32 = dict(dtype=torch.float32, device=dev)
    plan = device_k6_plan(cfg, b, n)
    layout = None if plan is not None else device_k6_f32_plan(cfg, b, n)
    # h_{-1} rounded to the residual type, as _bwd_core concatenates it
    U_k, seqs, ins = _kernel_inputs(U_c, (g_seq, c_seq, h_seq), cfg,
                                    h0.to(cfg.rdtype), c0, dh_seq, dhT,
                                    transpose=plan is None and layout is None)
    dc = dcT.to(torch.float32).clone().contiguous()
    dU = torch.empty(n, 4 * n, **f32)
    dh0 = torch.empty(b, n, **f32)
    lib = _build.load_library()
    work = torch.empty(max(1, lib.lstm_bwd_scan_work_floats(s, b, n)), **f32)
    launched = ctypes.c_int(0)
    if plan is not None:
        # dg_seq written once, in bf16; the fp32 dg only into dg_out
        dgx, err, name = _persist(plan, cfg, seqs, ins, U_k, dc, dg_out, dh0,
                                  dU, work, dropout, launched)
    elif layout is not None:
        # dg_seq written once, in fp32, the xw type under fp32 compute
        dgx = _dg_scratch(dg_out, s, b, n, dev)
        err, name = _persist_f32(layout, cfg, seqs, ins, U_k, dc, dgx, dh0, dU,
                                 work, dropout, launched)
    else:
        dg = _dg_scratch(dg_out, s, b, n, dev)
        dgx = (dg if cuda_cell.xw_type(cfg) == torch.float32
               else torch.empty(s, b, 4 * n, dtype=torch.bfloat16, device=dev))
        name = "lstm_bwd_scan_launch"
        err = lib.lstm_bwd_scan_launch(
            ctype, rtype, U_k.data_ptr(),
            *(x.data_ptr() for x in seqs), *(x.data_ptr() for x in ins),
            dc.data_ptr(), dg.data_ptr(), dgx.data_ptr(), dU.data_ptr(),
            dh0.data_ptr(), work.data_ptr(), s, b, n,
            *_launch_args(cfg, dropout, dev), ctypes.byref(launched),
        )
    scan_layer_bwd.launches += launched.value
    cuda_cell._raise_on(err, name)
    return dgx, dU, dh0, dc


embed_layer0_bwd.launches = 0
embed_layer0_bwd_unroll2.launches = 0
scan_layer_bwd.launches = 0


def _cotangents(ctx, dh_out, dhT, dcT, h_seq, h0, c0):
    """(dh_seq, dhT, dcT) in the accumulation type: zeros for an output
    that autograd did not reach; hT and cT left the forward in the residual
    type, as in the JAX VJP."""
    cfg = ctx.cfg
    af = cuda_cell._acc_dtype(cfg)

    def cot(x, like, rounded):
        if x is None:
            return torch.zeros(like.shape, dtype=af, device=like.device)
        return (x.to(cfg.rdtype) if rounded else x).to(af)

    return cot(dh_out, h_seq, False), cot(dhT, h0, True), cot(dcT, c0, True)


def _layer_out(out):
    """(the stream the layer hands on, hT, cT) of a forward wrapper's
    residual result: the masked stream under dropout, else h_seq."""
    h_seq, (hT, cT) = out[0], out[1]
    return (out[4] if len(out) == 5 else h_seq), hT, cT


class EmbedLayer0(torch.autograd.Function):
    """Layer 0 with the embedding fused in, differentiable in W, U, b, h0
    and c0: the forward kernel with residuals, then ``embed_layer0_bwd``
    (K3), or with ``unroll2`` ``embed_layer0_bwd_unroll2`` (K12). With
    ``plain`` both halves run their plain versions, on any device."""

    @staticmethod
    def forward(ctx, W, U, b, ids, h0, c0, cfg: ModelConfig, plain: bool,
                dropout, fused_accum: bool, unroll2: bool):
        layer = LayerParams(W, U, b)
        fwd = cuda_cell.embed_layer0_plain if plain else cuda_cell.embed_layer0
        out = fwd(layer, ids, h0, c0, cfg, residuals=True, dropout=dropout)
        ctx.save_for_backward(U, out[0], out[2], out[3], ids, h0, c0)
        ctx.cfg, ctx.plain, ctx.dropout = cfg, plain, dropout
        ctx.fused_accum, ctx.unroll2 = fused_accum, unroll2
        ctx.dtypes = (W.dtype, U.dtype, b.dtype, h0.dtype, c0.dtype)
        return _layer_out(out)

    @staticmethod
    def backward(ctx, dh_out, dhT, dcT):
        U, h_seq, c_seq, g_seq, ids, h0, c0 = ctx.saved_tensors
        cfg = ctx.cfg
        af = cuda_cell._acc_dtype(cfg)
        if ctx.unroll2:
            bwd = (embed_layer0_bwd_unroll2_plain if ctx.plain
                   else embed_layer0_bwd_unroll2)
        else:
            bwd = embed_layer0_bwd_plain if ctx.plain else embed_layer0_bwd
        m = cfg.vocab
        dWU, db, dh0, dc0 = bwd(
            U.to(cfg.cdtype), g_seq, c_seq, h_seq, ids, h0.to(af), c0.to(af),
            *_cotangents(ctx, dh_out, dhT, dcT, h_seq, h0, c0), cfg,
            dropout=ctx.dropout, fused_accum=ctx.fused_accum,
        )
        dWU = dWU.to(cfg.cdtype)
        wd, ud, bd, hd, cd = ctx.dtypes
        return (dWU[:m].to(wd), dWU[m:].to(ud), db.to(bd), None,
                dh0.to(hd), dc0.to(cd), None, None, None, None, None)


class ScanLayer(torch.autograd.Function):
    """A layer >= 1, differentiable in U, xw, h0 and c0: the forward kernel
    with residuals, then ``scan_layer_bwd``; W and b take their gradients
    through xw = x @ W + b outside. ``layer`` travels as a plain object (its
    W and b are only checked for shape). With ``plain`` both halves run
    their plain versions, on any device."""

    @staticmethod
    def forward(ctx, layer, U, xw, h0, c0, cfg: ModelConfig, plain: bool,
                dropout):
        fwd = cuda_cell.scan_layer_plain if plain else cuda_cell.scan_layer
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
        af = cuda_cell._acc_dtype(cfg)
        bwd = scan_layer_bwd_plain if ctx.plain else scan_layer_bwd
        dg, dU, dh0, dc0 = bwd(
            U.to(cfg.cdtype), g_seq, c_seq, h_seq, h0.to(af), c0.to(af),
            *_cotangents(ctx, dh_out, dhT, dcT, h_seq, h0, c0), cfg,
            dropout=ctx.dropout,
        )
        ud, xd, hd, cd = ctx.dtypes
        return (None, dU.to(cfg.cdtype).to(ud), dg.to(xd), dh0.to(hd),
                dc0.to(cd), None, None, None)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def layer0_fused_accum(cfg: ModelConfig, batch: int,
                       fused_accum: Optional[bool] = None) -> bool:
    """The JAX VJP that K3 copies on a call of ``batch`` rows: ``fused_accum``
    where given, else the JAX rule at that batch, ``fused_accum_ok``
    (``pallas_cell.py:874-881``, with b the batch of the ids its kernel
    sees, ``:1122``): under ``--dp`` or sequence pipelining the kernel sees
    fewer rows than the global batch, and the gate may flip between the
    two counts."""
    if fused_accum is not None:
        return fused_accum
    from .dispatch import fused_accum_ok   # dispatch imports this module

    return fused_accum_ok(cfg, batch)


def differentiable_embed_layer0(layer, ids, h0, c0, cfg: ModelConfig,
                                dropout=None, plain: bool = False,
                                fused_accum: Optional[bool] = None):
    """``cell_fn.embed_layer0`` of ``ops.dispatch``: (h_out, (hT, cT)) of
    layer 0, h_out the masked stream under ``dropout=(rate, seed)``,
    through ``EmbedLayer0`` when autograd needs a gradient of its inputs,
    else through the forward kernel alone (no residuals). ``fused_accum``
    picks the JAX VJP that K3 copies (the module docstring); None chooses
    it at this call's batch (``layer0_fused_accum``). The backward is K12
    where the JAX package takes its unroll-2 kernel
    (``ops.dispatch.bwd_unroll2``: ``EIGEN_LSTM_BWD_UNROLL=2``, read at
    each call as the JAX package reads it), else K3."""
    from .dispatch import bwd_unroll2   # dispatch imports this module

    fused_accum = layer0_fused_accum(cfg, ids.shape[1], fused_accum)
    unroll2 = bwd_unroll2(cfg, ids.shape[0], ids.shape[1], fused_accum,
                          0.0 if dropout is None else dropout[0])
    if _wants_grad(layer.W, layer.U, layer.b, h0, c0):
        h_out, hT, cT = EmbedLayer0.apply(layer.W, layer.U, layer.b, ids, h0,
                                          c0, cfg, plain, dropout,
                                          fused_accum, unroll2)
        return h_out, (hT, cT)
    fwd = cuda_cell.embed_layer0_plain if plain else cuda_cell.embed_layer0
    return fwd(layer, ids, h0, c0, cfg, dropout=dropout)


def differentiable_scan_layer(layer, xw, h0, c0, cfg: ModelConfig,
                              dropout=None, plain: bool = False):
    """The ``cell_fn`` of ``ops.dispatch``: (h_out, (hT, cT)) of a layer
    >= 1 from xw = x @ W + b, as ``differentiable_embed_layer0``, through
    ``ScanLayer`` when autograd needs a gradient."""
    if _wants_grad(layer.W, layer.U, layer.b, xw, h0, c0):
        h_out, hT, cT = ScanLayer.apply(layer, layer.U, xw, h0, c0, cfg,
                                        plain, dropout)
        return h_out, (hT, cT)
    fwd = cuda_cell.scan_layer_plain if plain else cuda_cell.scan_layer
    return fwd(layer, xw, h0, c0, cfg, dropout=dropout)
