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
launches its kernel, at any D; for a CPU tensor each runs its plain
version, ``tp_seq_fwd_plain`` or ``tp_seq_bwd_plain``: the per-step math of
``pallas_tp_cell.py`` over the window with the h exchange as an all-gather
over the group and the dh partials reduce-scattered, so the plain versions
are exact at any D. Each wrapper counts its launches in ``.launches``, one
a call.

At D = 1 K15 has three designs of one function. Under bf16 compute,
wherever ``cuda_cell_tiled.split_fwd_plan`` gives a layout, it is the
persistent tensor-core forward of K8/K9 (``csrc/fwd_mma.cuh:fwd_persist``
through ``tp_seq_fwd_launch``: U's rows in shared memory, the products on
tensor cores, a share of the batch rows a block) with K15's own streams:
xw in fp32 with the bias, the exchange buffer's round(h) in the compute
type, h_seq in fp32, g and c_prev = c_{t-1} in the residual type; only the
order of the product's fp32 sums moves. Under fp32 compute, wherever
``cuda_cell_tiled.split_fwd_f32_plan`` gives one, it is K9's fp32
persistent CUDA-core kernel in K15's mode (``csrc/lstm_tiled_f32.cuh``
through ``tp_seq_fwd_f32_launch``: each block its N x 32 slice of U in
shared memory, the batch over block rows where N / 8 blocks would leave SMs
idle, the same streams). Elsewhere it is one cooperative launch of
CUDA-core step tiles (``tp_seq_fwd_launch`` without a layout). K16 at
D = 1 is K6's reverse recurrence, so wherever ``cuda_cell_bwd.k6_plan``
(bf16) or ``k6_f32_plan`` (fp32) gives a layout it is K6's persistent
kernel of that type (``lstm_bwd_persist_launch``: U in shared memory,
dh_rec on tensor cores, dg written in fp32 as well;
``lstm_bwd_f32_launch``: U's rows over a block's gate columns in shared
memory, dh_rec on CUDA cores), given K16's c layout without a copy of the
stream: c_prev advanced by one step as c_seq, c_prev[0] as c0 and cT, in
fp32, as c_{S-1}. Elsewhere it is ``tp_seq_bwd_launch``, one cooperative
launch of CUDA-core step tiles over U^T. The D-rank cooperative kernels
run at one group give the D = 1 cooperative kernels' bits, but 1-10 %
slower at the bench's shapes (PERF.md), so the D = 1 ones stay.

At D > 1 both run the TPU kernel's in-kernel exchange: K15 stores its
tile of h_t into slot (t+1) mod 3 of every rank's h buffer and waits for
the D ranks' flags before step t+1 reads; K16 stores column j of its
partial round(dg_{t+1}) @ U_d^T into rank j / nd's chunk, and each rank
sums its D chunks in rank order. Wherever the planners give a layout
(each for the SMs and shared memory one rank group may use) these are
the persistent designs of the compute type. Under bf16 compute
(``ranks_fwd_plan``: (kres, rows); ``ranks_bwd_plan``: (units, rows))
the tensor-core ones (``tp_seq_fwd_persist_ranks_launch``: K15's
persistent forward with the exchange in place of its grid barrier, the
D = 1 layout's rows on one card, so its bits are the D = 1 design's;
``tp_seq_bwd_persist_ranks_launch``: K6's persistent reverse step, U_r's
rows in shared memory, the partials on tensor cores, dc in registers, a
rank barrier and an exchange a step). Under fp32 compute
(``ranks_fwd_f32_plan``: a ``cuda_cell_tiled.F32Split``;
``ranks_bwd_f32_plan``: a ``cuda_cell_bwd.F32Plan``) the CUDA-core ones
(``tp_seq_fwd_f32_ranks_launch``: the fp32 K15 window with the exchange,
the D = 1 fp32 persistent K15's bits; ``tp_seq_bwd_f32_ranks_launch``:
K6's fp32 reverse step over the rank's 4nd gate columns, N / 16 unit
groups of G blocks whose G parts go to their owners' chunks and are
added in part order, then the senders in rank order; G from the SMs a
rank has on one card, on D cards too). Elsewhere (no layout) they are
the cooperative CUDA-core tiles (``tp_seq_fwd_ranks_launch``,
``tp_seq_bwd_ranks_launch``). The buffers
(``exchange_layout``) are one ``cudaMalloc`` a rank: on D cards the
group's (``group_exchange``: handles all-gathered over the model axis,
peers mapped with CUDA IPC, held by the group and released when it
closes), on one card D of the card's (``one_card_exchange``, which the
caller passes to each call and closes). Flags only rise: each call takes
a base from the buffers' count of exchange steps (``Exchange.take``), so
no call's wait is met by an earlier call's flag. ``tp_seq_fwd_ranks`` and
``tp_seq_bwd_ranks`` launch the same device code on one card as D rank
groups of one launch, group r playing rank r, each with the card's SMs /
D (the cooperative design: a share of the resident blocks,
``rank_blocks``, which refuses D groups that do not fit; a split, or a
layout a group, may be given, so one rank can lag); their plain versions
``tp_seq_*_ranks_plain`` run the D shards in one process, the all-gather
a concatenation and the reduce-scatter a sum in rank order. Nothing on
the main path calls them: ``chip_smoke.py`` and the tests do.

``tp_seq_lstm`` is the JAX function of that name: U cast to the compute
type and xw, h0, c0 to the accumulation type before ``TPSeq``, whose
backward is ``tp_seq_bwd`` (:305-338): K16 gives dg, dh0, dc0, and dU is
one product outside (``window_dU``), round(h_prev)^T round(dg) over the
window with fp32 sums, h_prev rebuilt from h_seq (all-gathered) and the
full h0. dU leaves in U's type, the compute type (bf16 under bf16 compute:
this family rounds dU, the per-step family does not).
``tp_seq_supported`` is the JAX gate with its 14 MB VMEM budget, copied to
pick the family as the JAX package does; the budget describes the TPU,
not the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator
from typing import List, Optional, Sequence

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


def tp_seq_fwd_ranks_plain(U_cs: Sequence, xws: Sequence, h0_full,
                           c0s: Sequence, cfg: ModelConfig):
    """The windows of D shards in one process (U_cs, xws and c0s by rank,
    the full h0): ``tp_seq_fwd_plain``'s steps on every shard, the
    all-gather a concatenation in rank order. A list of D outputs, each as
    ``tp_seq_fwd_plain``'s."""
    af, pd, rd = cuda_cell._acc_dtype(cfg), cfg.pdtype, cfg.rdtype
    d, s = len(U_cs), xws[0].shape[0]
    h_full, cs = h0_full.to(cfg.cdtype), [c0.to(af) for c0 in c0s]
    seqs = [([], [], []) for _ in range(d)]
    for t in range(s):
        h2rs = []
        for r, (hs, gs, cps) in enumerate(seqs):
            cps.append(cs[r].to(rd))
            h2, c2, g = tp_step_plain(U_cs[r], xws[r][t], h_full, cs[r], cfg)
            h2r, c2r = h2.to(pd), c2.to(pd)
            gs.append(g.to(rd))
            hs.append(h2r)
            cs[r] = c2r.to(af)
            h2rs.append(h2r)
        h_full = torch.cat([h.to(cfg.cdtype) for h in h2rs], 1)
    return [(torch.stack(hs), torch.stack(gs), torch.stack(cps), h2rs[r].to(af),
             cs[r]) for r, (hs, gs, cps) in enumerate(seqs)]


def tp_seq_bwd_ranks_plain(U_cs: Sequence, g_seqs: Sequence, c_prevs: Sequence,
                           cTs: Sequence, dh_seqs: Sequence, dhTs: Sequence,
                           dcTs: Sequence, cfg: ModelConfig):
    """The reverse windows of D shards in one process (every argument by
    rank): ``tp_seq_bwd_plain``'s steps on every shard, the reduce-scatter
    each rank's D chunks of the partials summed in rank order 0..D-1, as
    the kernel and ``pallas_tp_seq.py:140`` sum them. A list of D (dg, dh0,
    dc0)."""
    af = cuda_cell._acc_dtype(cfg)
    d, s = len(U_cs), g_seqs[0].shape[0]
    nd = c_prevs[0].shape[-1]
    dcs, recs = [x.to(af) for x in dcTs], [x.to(af) for x in dhTs]
    dgs = [[None] * s for _ in range(d)]
    for t in reversed(range(s)):
        partials = []
        for r in range(d):
            c2 = cTs[r] if t == s - 1 else c_prevs[r][t + 1]
            dgs[r][t], dcs[r] = tp_step_bwd_plain(
                g_seqs[r][t], c2, c_prevs[r][t], dh_seqs[r][t].to(af) + recs[r],
                dcs[r], cfg)
            partials.append(cell_ops.matmul(dgs[r][t], U_cs[r].T, cfg.cdtype, af))
        recs = [functools.reduce(operator.add,
                                 [p[:, r * nd:(r + 1) * nd] for p in partials])
                for r in range(d)]
    return [(torch.stack(dgs[r]), recs[r], dcs[r]) for r in range(d)]


# --- the exchange of the D > 1 designs --------------------------------------

MAX_RANKS = 8          # csrc/exchange.cuh:kMaxRanks
MAX_PARTS = 4          # csrc/exchange.cuh:kMaxParts, the fp32 backward's G at most
HEADER_BYTES = 512     # a buffer's flags and rank barriers (exchange.cuh)
SLOTS = 3              # h slots and chunk slots, as the TPU kernel's
LANES, BATCH_TILE = 32, 4   # a tile's units and batch rows (common.cuh)


@dataclasses.dataclass(frozen=True)
class ExchangeLayout:
    """Byte offsets in one rank's exchange buffer: the header at 0 (flags,
    rank barriers), the forward's h slots (SLOTS, B, N) in the compute type
    at ``h_off``, the backward's chunks (SLOTS, D, P, B, nd) fp32 at
    ``r_off`` (P the parts a sender sends: under fp32 compute room for
    MAX_PARTS, the fp32 persistent backward's G; else 1); ``nbytes`` in
    all."""

    h_off: int
    r_off: int
    nbytes: int


def _align(x: int, to: int = 256) -> int:
    return -(-x // to) * to


def exchange_layout(b: int, n: int, d: int, csize: int) -> ExchangeLayout:
    """The layout of a rank's buffer at batch b, width n = D * nd and a
    compute type of ``csize`` bytes (4: fp32, whose chunks hold MAX_PARTS
    parts a sender)."""
    if d < 1 or d > MAX_RANKS or n % d:
        raise ValueError(f"no exchange layout for D = {d}, N = {n}")
    parts = MAX_PARTS if csize == 4 else 1
    h_off = HEADER_BYTES
    r_off = _align(h_off + SLOTS * b * n * csize)
    return ExchangeLayout(h_off, r_off, _align(r_off + SLOTS * parts * b * n * 4))


def fwd_tiles(b: int, nd: int) -> int:
    return nd // LANES * -(-b // BATCH_TILE)


def bwd_tiles(b: int, n: int) -> int:
    """The backward's product tiles run over all N columns."""
    return n // LANES * -(-b // BATCH_TILE)


def rank_blocks(tiles: int, groups: int, resident: int,
                blocks: Optional[Sequence[int]] = None) -> List[int]:
    """The blocks of each of ``groups`` rank groups of one cooperative
    launch, of which ``resident`` blocks fit the card at once: ``blocks``
    as given, else an even share, at most ``tiles`` a group. Every block
    must be resident, since the groups wait on each other: raises
    ValueError when they do not fit."""
    if blocks is None:
        share = resident // groups
        if share < 1:
            raise ValueError(f"{groups} rank groups do not fit: the card holds "
                             f"{resident} blocks of this kernel at once")
        blocks = [min(tiles, share)] * groups
    blocks = [int(x) for x in blocks]
    if len(blocks) != groups or min(blocks) < 1:
        raise ValueError(f"blocks {blocks}: one count of at least 1 for each "
                         f"of the {groups} rank groups")
    if sum(blocks) > resident:
        raise ValueError(f"{groups} rank groups of {blocks} blocks do not fit: "
                         f"the card holds {resident} blocks of this kernel at "
                         f"once, and the groups wait on each other")
    return blocks


def refused_pairs(devices: Sequence[int], can_access):
    """The pairs (i, j) of ranks whose cards are not the same and where
    card devices[i] may not reach card devices[j]'s memory
    (``can_access(dev, peer)``)."""
    return [(i, j) for i, a in enumerate(devices) for j, c in enumerate(devices)
            if a != c and not can_access(a, c)]


def _ok(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class Exchange:
    """The exchange buffers of D ranks at one (B, N, compute type):
    ``ptrs`` every rank's buffer as this process maps it, ``own`` those it
    allocated, ``mapped`` the peers' it opened, and the count of exchange
    steps each direction has taken (a call's base). ``close`` releases
    them."""

    def __init__(self, lib, key, layout: ExchangeLayout, ptrs, own, mapped=(),
                 group: Optional[mesh.AxisGroup] = None):
        self.lib, self.key, self.layout = lib, key, layout
        self.ptrs, self.own, self.mapped = list(ptrs), list(own), list(mapped)
        self.group = group
        self.steps = {"fwd": 0, "bwd": 0}

    def take(self, kind: str, s: int) -> int:
        """The base of a call of S steps, and the count moved past it."""
        base = self.steps[kind]
        self.steps[kind] = base + s
        return base

    def close(self, failed: bool = False):
        """Waits for the card, unmaps the peers' buffers and, under a group,
        waits for every rank to have unmapped this rank's before it frees
        it. With ``failed`` (the run is ending on an error), or when the
        card has failed, it runs no collective and frees nothing: a peer
        may still be inside a kernel that reads the buffers, and the
        process's end returns them; it raises the card's error, if it
        found one."""
        if self.lib is None:
            return
        lib, self.lib = self.lib, None
        err = None
        if not failed:
            try:
                torch.cuda.synchronize()
            except RuntimeError as e:   # a sticky error: the card has failed
                failed, err = True, e
        codes = [("exchange_ipc_close", lib.exchange_ipc_close(p)) for p in self.mapped]
        if failed:
            if err is not None:
                raise err
            return
        g = self.group
        if g is not None and torch.distributed.is_initialized():
            # no peer may still hold this rank's buffer mapped when it goes
            mesh.all_reduce(torch.zeros(1, device=g.device), g).item()
        codes += [("exchange_free", lib.exchange_free(p)) for p in self.own]
        for what, code in codes:
            _ok(code, what)


def _alloc(lib, nbytes: int) -> int:
    ptr = ctypes.c_void_p()
    _ok(lib.exchange_alloc(nbytes, ctypes.byref(ptr)), "exchange_alloc")
    return ptr.value


def one_card_exchange(b: int, n: int, d: int, cdtype) -> Exchange:
    """The D buffers of the one-card launch at (B, N, D, compute type) on
    the current card; the caller passes them to every call that shares
    them and closes them."""
    lib = _build.load_library()
    layout = exchange_layout(b, n, d, torch.finfo(cdtype).bits // 8)
    ptrs = [_alloc(lib, layout.nbytes) for _ in range(d)]
    return Exchange(lib, (b, n, d, cdtype), layout, ptrs, ptrs)


def group_exchange(group: mesh.AxisGroup, b: int, n: int, cdtype) -> Exchange:
    """The group's buffers at (B, N, D, compute type), made at the first
    call and held by the group (``group.exchange``) until it closes: this
    rank allocates its own and exports it; the handles and card numbers
    are all-gathered over the group; every pair of cards must reach each
    other's memory (else RuntimeError with the pairs, on every rank); the
    peers' buffers are then mapped with CUDA IPC."""
    key = ("tp_seq", b, n, group.size, cdtype)
    ex = group.exchange.get(key)
    if ex is not None:
        return ex
    lib = _build.load_library()
    d, me = group.size, group.rank
    layout = exchange_layout(b, n, d, torch.finfo(cdtype).bits // 8)
    ptr = _alloc(lib, layout.nbytes)
    handle = ctypes.create_string_buffer(64)
    _ok(lib.exchange_ipc_handle(ptr, handle), "exchange_ipc_handle")
    card = torch.cuda.current_device()
    row = torch.tensor(list(handle.raw) + list(card.to_bytes(4, "little")),
                       dtype=torch.uint8, device=group.device)
    rows = mesh.all_gather(row[None], 0, group).cpu()
    cards = [int.from_bytes(bytes(r[64:].tolist()), "little") for r in rows]

    def can_access(a, c):
        out = ctypes.c_int(0)
        _ok(lib.exchange_can_access_peer(a, c, ctypes.byref(out)),
            "exchange_can_access_peer")
        return bool(out.value)

    refused = refused_pairs(cards, can_access)
    if refused:
        _ok(lib.exchange_free(ptr), "exchange_free")
        raise RuntimeError(
            f"K15/K16 at D = {d}: the cards of ranks {refused} (cards {cards}) "
            f"cannot reach each other's memory, which the kernels' exchange "
            f"stores into; run the per-step family (EIGEN_LSTM_TP_SEQ=0) or "
            f"on cards with peer access")
    ptrs = []
    for q in range(d):
        if q == me:
            ptrs.append(ptr)
            continue
        peer = ctypes.c_void_p()
        _ok(lib.exchange_ipc_open(bytes(rows[q, :64].tolist()), ctypes.byref(peer)),
            f"exchange_ipc_open (rank {q})")
        ptrs.append(peer.value)
    ex = group.exchange[key] = Exchange(lib, key, layout, ptrs, [ptr],
                                        [p for q, p in enumerate(ptrs) if q != me],
                                        group)
    return ex


def _resident(lib, bwd: int, ctype: int, rtype: int) -> int:
    out = ctypes.c_int(0)
    _ok(lib.tp_seq_ranks_resident(bwd, ctype, rtype, ctypes.byref(out)),
        "tp_seq_ranks_resident")
    return out.value


def _ptrs(xs):
    return (ctypes.c_void_p * len(xs))(*xs)


def _ints(xs):
    return (ctypes.c_int * len(xs))(*xs)


def _fwd_ranks(ex: Exchange, ranks, blocks, ins, cfg: ModelConfig, ctype: int,
               rtype: int, layouts=None):
    """One launch of the D-rank forward for the groups of ``ranks``, each
    with its (U_c, xw, h0_full, c0): the persistent design of the compute
    type with ``layouts`` (a layout a group), else the cooperative one with
    ``blocks``. (Their outputs, the launches.)"""
    if layouts is not None:
        persist = _fwd_f32_ranks if cfg.cdtype == torch.float32 else _fwd_persist_ranks
        return persist(ex, ranks, layouts, ins, cfg, rtype)
    s, b, nd4 = ins[0][1].shape
    nd, n, dev = nd4 // 4, ins[0][2].shape[1], ins[0][1].device
    d = len(ex.ptrs)
    blocks = rank_blocks(fwd_tiles(b, nd), len(ranks),
                         _resident(ex.lib, 0, ctype, rtype), blocks)
    f32, keep = torch.float32, []
    e = lambda *shape, dtype=f32: torch.empty(*shape, dtype=dtype, device=dev)
    for U_c, xw, h0_full, c0 in ins:
        keep.append(dict(
            U=U_c.to(cfg.cdtype).contiguous(), xw=xw.to(f32).contiguous(),
            h0=h0_full.to(cfg.cdtype).contiguous(), c=c0.to(f32).clone().contiguous(),
            hseq=e(s, b, nd), gseq=e(s, b, 4 * nd, dtype=cfg.rdtype),
            cprev=e(s, b, nd, dtype=cfg.rdtype), hT=e(b, nd), cT=e(b, nd)))
    cols = [_ptrs([t[k].data_ptr() for t in keep]) for k in
            ("U", "xw", "h0", "c", "hseq", "gseq", "cprev", "hT", "cT")]
    launched = ctypes.c_int(0)
    err = ex.lib.tp_seq_fwd_ranks_launch(
        ctype, rtype, len(ranks), _ints(ranks), _ints(blocks), *cols, d,
        _ptrs(ex.ptrs), ex.layout.h_off, ex.take("fwd", s), s, b, n, nd,
        int(cfg.cell_variant == "standard"), _stream(dev), ctypes.byref(launched))
    cuda_cell._raise_on(err, "tp_seq_fwd_ranks_launch")
    return [(t["hseq"], t["gseq"], t["cprev"], t["hT"], t["cT"]) for t in keep], \
        launched.value


def _bwd_ranks(ex: Exchange, ranks, blocks, ins, cfg: ModelConfig, ctype: int,
               rtype: int, layouts=None):
    """One launch of the D-rank backward for the groups of ``ranks``, each
    with its (U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT), as ``_fwd_ranks``:
    (their (dg, dh0, dc0), the launches)."""
    if layouts is not None:
        persist = _bwd_f32_ranks if cfg.cdtype == torch.float32 else _bwd_persist_ranks
        return persist(ex, ranks, layouts, ins, cfg, rtype)
    s, b, nd4 = ins[0][1].shape
    nd, dev = nd4 // 4, ins[0][1].device
    n = ins[0][0].shape[0]
    d = len(ex.ptrs)
    blocks = rank_blocks(bwd_tiles(b, n), len(ranks),
                         _resident(ex.lib, 1, ctype, rtype), blocks)
    f32, keep = torch.float32, []
    for U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT in ins:
        keep.append(dict(
            UT=U_c.to(cfg.cdtype).T.contiguous(), gseq=g_seq.contiguous(),
            cprev=c_prev.contiguous(), cT=cT.to(f32).contiguous(),
            dhseq=dh_seq.to(f32).contiguous(), dhT=dhT.to(f32).contiguous(),
            dc=dcT.to(f32).clone().contiguous(),
            dg=torch.empty(s, b, 4 * nd, dtype=f32, device=dev),
            dh0=torch.empty(b, nd, dtype=f32, device=dev)))
    cols = [_ptrs([t[k].data_ptr() for t in keep]) for k in
            ("UT", "gseq", "cprev", "cT", "dhseq", "dhT", "dc", "dg", "dh0")]
    launched = ctypes.c_int(0)
    err = ex.lib.tp_seq_bwd_ranks_launch(
        ctype, rtype, len(ranks), _ints(ranks), _ints(blocks), *cols, d,
        _ptrs(ex.ptrs), ex.layout.r_off, ex.take("bwd", s), s, b, n, nd,
        int(cfg.cell_variant == "standard"), _stream(dev), ctypes.byref(launched))
    cuda_cell._raise_on(err, "tp_seq_bwd_ranks_launch")
    return [(t["dg"], t["dh0"], t["dc"]) for t in keep], launched.value


# --- the persistent designs at D > 1 (bf16 compute) -------------------------
# The persistent D-rank backward's tiles (csrc/lstm_tp_persist.cu:tp_seq_bwd_persist_x,
# bwd_x_smem_bytes): a block of X_THREADS threads owns `units` of X_UNITS
# output units and tiles of `rows` of X_ROWS batch rows (rows * units at
# most X_TILE), holds its units' rows of U_r (4nd + X_PAD bf16 each) and a
# ring of X_RING_ROWS rows of X_KC + X_PAD bf16, whose space the 8 warps'
# partial sums (rows x units fp32 each) reuse; each thread runs the gate
# backward of at most GATE_ELEMS of the rank's B x nd elements.
X_THREADS, X_WARPS, X_KC, X_PAD, X_RING_ROWS, GATE_ELEMS = 256, 8, 128, 8, 192, 8
X_UNITS, X_ROWS, X_TILE = (64, 32), (16, 32, 64), 2048


def ranks_fwd_plan(cfg: ModelConfig, b: int, n: int, d: int, sms: int,
                   smem_limit: int, rows: Optional[int] = None):
    """K15's persistent design at D > 1: (kres, rows) of one rank group
    that may use ``sms`` SMs and ``smem_limit`` bytes of shared memory a
    block (the card's SMs / D for D groups on one card, the whole card for
    a group on its own), or None for the cooperative design.

    It needs bf16 compute, N a multiple of the ring's k chunk, nd of 32
    and at most 128 batch rows. A block owns 16 of the shard's nd units and
    ``rows`` batch rows: the rows given (the D = 1 layout's, so that its
    bits can be compared) where the group's (nd / 16) * ceil(B / rows)
    blocks fit its SMs, else ``cuda_cell_tiled.split_rows`` over the
    group's own grid. It holds as many rows of its N x 64 slice of U_r as
    fit beside its ring."""
    if d < 2 or cfg.cdtype != torch.bfloat16 or n % d:
        return None
    nd = n // d
    if n % ct.PERSIST_KC or nd % 32 or not 1 <= b <= ct.PERSIST_ROWS:
        return None
    blocks = nd // ct.PERSIST_UNITS
    if rows is None or blocks * -(-b // rows) > sms:
        rows = min(b, ct.split_rows(b, blocks, sms))
    if blocks * -(-b // rows) > sms:
        return None
    kres = ct.held_rows(rows, n, smem_limit)
    return None if kres is None else (kres, rows)


def ranks_bwd_smem_bytes(nd: int, units: int, rows: int) -> int:
    """Bytes of dynamic shared memory a persistent D-rank backward block
    takes (csrc/lstm_tp_persist.cu:bwd_x_smem_bytes, which ``_card_limits``
    holds this to once a card)."""
    ring = 2 * X_RING_ROWS * (X_KC + X_PAD)
    return 2 * units * (4 * nd + X_PAD) + max(ring, X_WARPS * rows * units * 4)


def ranks_bwd_plan(cfg: ModelConfig, b: int, n: int, d: int, sms: int,
                   smem_limit: int):
    """K16's persistent design at D > 1: (units, rows) of one rank group
    that may use ``sms`` SMs and ``smem_limit`` bytes of shared memory a
    block, its (N / units) * ceil(B / rows) blocks each holding its units'
    rows of U_r; None for the cooperative design.

    It needs bf16 compute and nd a multiple of 32. Units: the most of
    X_UNITS whose rows of U_r fit (a wider group reads the rank's dg_{t+1}
    from L2 fewer times a step); rows: the fewest of X_ROWS whose grid fits
    the SMs, each thread then holding at most GATE_ELEMS gate-backward
    elements (their dc in registers)."""
    if d < 2 or cfg.cdtype != torch.bfloat16 or n % d:
        return None
    nd = n // d
    if nd % 32:
        return None
    for units in X_UNITS:
        for rows in X_ROWS:
            if n % units or rows * units > X_TILE:
                continue
            blocks = n // units * -(-b // rows)
            if (blocks <= sms and ranks_bwd_smem_bytes(nd, units, rows) <= smem_limit
                    and b * nd <= blocks * X_THREADS * GATE_ELEMS):
                return units, rows
    return None


def lag_row_blocks(b: int, n: int, d: int, units: int) -> int:
    """The fewest row blocks a persistent backward group of ``units``
    units may take (each thread at most GATE_ELEMS gate-backward
    elements): a layout that lags its peers."""
    return max(1, -(-b * (n // d) // (n // units * X_THREADS * GATE_ELEMS)))


@functools.lru_cache(maxsize=None)
def _checked_limits(index: int):
    """(SMs, shared memory a block may opt in to) of card ``index``, read
    once; checks that the library lays out the persistent backward's shared
    memory as ``ranks_bwd_smem_bytes`` does."""
    lib = _build.load_library()
    for nd, units, rows in ((256, 64, 16), (128, 64, 32), (512, 32, 64), (512, 32, 32)):
        if lib.tp_seq_bwd_persist_smem_bytes(nd, units, rows) != \
                ranks_bwd_smem_bytes(nd, units, rows):
            raise RuntimeError("ranks_bwd_smem_bytes disagrees with "
                               "csrc/lstm_tp_persist.cu's layout")
    return ct._device_limits(index)


def _card_limits():
    """(SMs, shared memory a block may opt in to) of the current card."""
    return _checked_limits(torch.cuda.current_device())


def device_ranks_fwd_plan(cfg: ModelConfig, b: int, n: int, d: int, one_card: bool):
    """``ranks_fwd_plan`` (bf16) or ``ranks_fwd_f32_plan`` (fp32) on the
    current card: with ``one_card`` (D groups of one launch) a group takes
    the card's SMs / D (in bf16 the D = 1 layout's rows where they fit),
    else the whole card."""
    sms, smem = _card_limits()
    if cfg.cdtype == torch.float32:
        return ranks_fwd_f32_plan(cfg, b, n, d, sms // d if one_card else sms, smem)
    if not one_card:
        return ranks_fwd_plan(cfg, b, n, d, sms, smem)
    one = ct.split_fwd_plan(cfg, b, n, sms, smem)
    return ranks_fwd_plan(cfg, b, n, d, sms // d, smem, None if one is None else one[1])


def device_ranks_bwd_plan(cfg: ModelConfig, b: int, n: int, d: int, one_card: bool):
    """``ranks_bwd_plan`` on the current card, a group taking the card's
    SMs / D with ``one_card``, else the whole card; under fp32 compute
    ``ranks_bwd_f32_plan`` with the card's SMs / D in both cases (its G
    sets the sum order, so a rank on a card of its own keeps the one-card
    launch's)."""
    sms, smem = _card_limits()
    if cfg.cdtype == torch.float32:
        return ranks_bwd_f32_plan(cfg, b, n, d, sms // d, smem)
    return ranks_bwd_plan(cfg, b, n, d, sms // d if one_card else sms, smem)


def _bwd_layout(plan, b: int):
    """A group's layout from the backward's plan: the fp32 design's as it
    is, the bf16 persistent one's (units, rows) with its ceil(B / rows) row
    blocks; None for the cooperative design."""
    if plan is None or isinstance(plan, cuda_cell_bwd.F32Plan):
        return plan
    return (*plan, -(-b // plan[1]))


def _fwd_persist_ranks(ex: Exchange, ranks, layouts, ins, cfg: ModelConfig,
                       rtype: int):
    """One launch of the persistent D-rank forward for the groups of
    ``ranks``, group g with its (U_c, xw, h0_full, c0) and layout (kres,
    rows): (their outputs, the launches)."""
    s, b, nd4 = ins[0][1].shape
    nd, n, dev = nd4 // 4, ins[0][2].shape[1], ins[0][1].device
    f32, bf, keep = torch.float32, torch.bfloat16, []
    e = lambda *shape, dtype=f32: torch.empty(*shape, dtype=dtype, device=dev)
    for U_c, xw, h0_full, c0 in ins:
        keep.append(dict(
            U=ct._aligned(U_c.to(bf)), xw=xw.to(f32).contiguous(),
            h0=h0_full.to(bf).contiguous(), c=c0.to(f32).clone().contiguous(),
            hseq=e(s, b, nd), gseq=e(s, b, 4 * nd, dtype=cfg.rdtype),
            cprev=e(s, b, nd, dtype=cfg.rdtype), hT=e(b, nd)))
    cols = [_ptrs([t[k].data_ptr() for t in keep]) for k in
            ("U", "xw", "h0", "c", "hseq", "gseq", "cprev", "hT")]
    launched = ctypes.c_int(0)
    err = ex.lib.tp_seq_fwd_persist_ranks_launch(
        rtype, len(ranks), _ints(ranks), _ints([k for k, _ in layouts]),
        _ints([r for _, r in layouts]), *cols, len(ex.ptrs), _ptrs(ex.ptrs),
        ex.layout.h_off, ex.take("fwd", s), s, b, n, nd,
        int(cfg.cell_variant == "standard"), _stream(dev), ctypes.byref(launched))
    cuda_cell._raise_on(err, "tp_seq_fwd_persist_ranks_launch")
    # c holds cT on return
    return [(t["hseq"], t["gseq"], t["cprev"], t["hT"], t["c"]) for t in keep], \
        launched.value


def _bwd_persist_ranks(ex: Exchange, ranks, layouts, ins, cfg: ModelConfig,
                       rtype: int):
    """One launch of the persistent D-rank backward for the groups of
    ``ranks``, group g with its (U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT)
    and layout (units, rows, row_blocks), units and rows the same for all:
    (their (dg, dh0, dc0), the launches)."""
    s, b, nd4 = ins[0][1].shape
    nd, dev = nd4 // 4, ins[0][1].device
    n = ins[0][0].shape[0]
    units, rows = layouts[0][:2]
    if any(tuple(lay[:2]) != (units, rows) for lay in layouts):
        raise ValueError(f"the groups of one launch take one (units, rows), not {layouts}")
    f32, bf, keep = torch.float32, torch.bfloat16, []
    for U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT in ins:
        keep.append(dict(
            U=ct._aligned(U_c.to(bf)), gseq=g_seq.contiguous(),
            cprev=c_prev.contiguous(), cT=cT.to(f32).contiguous(),
            dhseq=dh_seq.to(f32).contiguous(), dhT=dhT.to(f32).contiguous(),
            dc=dcT.to(f32).clone().contiguous(),
            dg=torch.empty(s, b, 4 * nd, dtype=f32, device=dev),
            dgx=torch.empty(2, b, 4 * nd, dtype=bf, device=dev),
            dh0=torch.empty(b, nd, dtype=f32, device=dev)))
    cols = [_ptrs([t[k].data_ptr() for t in keep]) for k in
            ("U", "gseq", "cprev", "cT", "dhseq", "dhT", "dc", "dg", "dgx", "dh0")]
    launched = ctypes.c_int(0)
    err = ex.lib.tp_seq_bwd_persist_ranks_launch(
        rtype, len(ranks), _ints(ranks), _ints([lay[2] for lay in layouts]), *cols,
        len(ex.ptrs), _ptrs(ex.ptrs), ex.layout.r_off, ex.take("bwd", s), s, b, n,
        nd, units, rows, int(cfg.cell_variant == "standard"), _stream(dev),
        ctypes.byref(launched))
    cuda_cell._raise_on(err, "tp_seq_bwd_persist_ranks_launch")
    return [(t["dg"], t["dh0"], t["dc"]) for t in keep], launched.value


# --- the persistent designs at D > 1 under fp32 compute ----------------------
# K15: K9's fp32 persistent kernel in K15's mode (csrc/lstm_tiled_f32.cuh)
# with exchange.cuh's RankStep (csrc/lstm_tp_f32.cu), its layout
# ``cuda_cell_tiled.F32Split``; K16: K6's fp32 persistent reverse step with
# the reduce-scatter inside (csrc/lstm_tp_f32_bwd.cu), its layout
# ``cuda_cell_bwd.F32Plan`` (G blocks a group of 16 units, product rows a
# thread, ring slots), each thread running the gate backward of at most
# F32_GATE_ELEMS of the rank's B x nd elements.
F32_GROUPS = (4, 2, 1)   # G, in the order the plan tries them
F32_GATE_ELEMS = 4       # csrc/lstm_tp_f32_bwd.cu:kGMax


def ranks_fwd_f32_plan(cfg: ModelConfig, b: int, n: int, d: int, sms: int,
                       smem_limit: int) -> Optional[ct.F32Split]:
    """K15's fp32 persistent design at D > 1: the ``F32Split`` of one rank
    group that may use ``sms`` SMs and ``smem_limit`` bytes of shared
    memory a block, its nd / 8 column blocks over the batch's block rows
    (``cuda_cell_tiled.f32_split_layout``), each block holding its N x 32
    slice of U_r; None for the cooperative design. It needs fp32 compute,
    N a multiple of 32 and at most 128 batch rows. A unit's sums do not
    depend on the rows, the ring or nd, so every layout gives the D = 1
    fp32 persistent K15's bits on the unpermuted weights."""
    if d < 2 or cfg.cdtype != torch.float32 or n % d:
        return None
    nd = n // d
    if nd % ct.F32_UNITS or n % 32 or not 1 <= b <= ct.F32_ROWS:
        return None
    return ct.f32_split_layout(b, n, nd // ct.F32_UNITS, sms, smem_limit)


def ranks_bwd_f32_plan(cfg: ModelConfig, b: int, n: int, d: int, sms: int,
                       smem_limit: int) -> Optional[cuda_cell_bwd.F32Plan]:
    """K16's fp32 persistent design at D > 1: (G, product rows a thread,
    ring slots) of one rank group, N / 16 groups of G blocks over the
    rank's 4nd gate columns, ``sms`` the SMs one rank group has on one card
    (the card's SMs / D, on D cards too: G sets the sum order). G: the
    first of F32_GROUPS whose N / 16 x G blocks fit those SMs, whose blocks'
    4nd / G columns are whole ring slots and whose threads take at most
    F32_GATE_ELEMS gate-backward elements each; the first ring of
    ``cuda_cell_bwd.F32_RINGS`` that fits beside U_r's 16 rows over a
    block's columns (``f32_smem_bytes`` at the shard's width). None for the
    cooperative design: bf16, more than 128 batch rows, a grid or a block
    that does not fit (the flagship's layer at D = 2 takes G = 1: its 64 x
    2 blocks would not be resident beside the other rank's)."""
    if d < 2 or cfg.cdtype != torch.float32 or n % d:
        return None
    nd = n // d
    if n % cuda_cell_bwd.F32_UNITS or not 1 <= b <= cuda_cell_bwd.F32_ROWS:
        return None
    rows = cuda_cell_bwd.f32_rows_per_thread(b)
    for g in F32_GROUPS:
        blocks = n // cuda_cell_bwd.F32_UNITS * g
        if ((4 * nd) % g or (4 * nd // g) % cuda_cell_bwd.F32_KC or blocks > sms
                or b * nd > blocks * cuda_cell_bwd.F32_THREADS * F32_GATE_ELEMS):
            continue
        stages = next((st for st in cuda_cell_bwd.F32_RINGS[rows]
                       if cuda_cell_bwd.f32_smem_bytes(b, nd, g, st) <= smem_limit), None)
        return None if stages is None else cuda_cell_bwd.F32Plan(g, rows, stages)
    return None


def _fwd_f32_ranks(ex: Exchange, ranks, layouts, ins, cfg: ModelConfig, rtype: int):
    """One launch of the fp32 persistent D-rank forward for the groups of
    ``ranks``, group g with its (U_c, xw, h0_full, c0) and ``F32Split``:
    each group its own rows, every group the ring of the layout with the
    most rows a thread. (Their outputs, the launches.)"""
    s, b, nd4 = ins[0][1].shape
    nd, n, dev = nd4 // 4, ins[0][2].shape[1], ins[0][1].device
    ring = max(layouts, key=lambda lay: lay.per)
    f32, keep = torch.float32, []
    e = lambda *shape, dtype=f32: torch.empty(*shape, dtype=dtype, device=dev)
    for U_c, xw, h0_full, c0 in ins:
        keep.append(dict(
            U=U_c.to(f32).contiguous(), xw=ct._aligned(xw.to(f32)),
            h0=h0_full.to(f32).contiguous(), c=c0.to(f32).clone().contiguous(),
            hseq=e(s, b, nd), gseq=e(s, b, 4 * nd, dtype=cfg.rdtype),
            cprev=e(s, b, nd, dtype=cfg.rdtype), hT=e(b, nd)))
    cols = [_ptrs([t[k].data_ptr() for t in keep]) for k in
            ("U", "xw", "h0", "c", "hseq", "gseq", "cprev", "hT")]
    launched = ctypes.c_int(0)
    err = ex.lib.tp_seq_fwd_f32_ranks_launch(
        rtype, len(ranks), _ints(ranks), _ints([lay.rows for lay in layouts]),
        ring.per, ring.kc, ring.stages, *cols, len(ex.ptrs), _ptrs(ex.ptrs),
        ex.layout.h_off, ex.take("fwd", s), s, b, n, nd,
        int(cfg.cell_variant == "standard"), _stream(dev), ctypes.byref(launched))
    cuda_cell._raise_on(err, "tp_seq_fwd_f32_ranks_launch")
    # c holds cT on return
    return [(t["hseq"], t["gseq"], t["cprev"], t["hT"], t["c"]) for t in keep], \
        launched.value


def _bwd_f32_ranks(ex: Exchange, ranks, layouts, ins, cfg: ModelConfig, rtype: int):
    """One launch of the fp32 persistent D-rank backward for the groups of
    ``ranks``, group g with its (U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT),
    every group the one ``F32Plan`` of ``layouts``: (their (dg, dh0, dc0),
    the launches)."""
    s, b, nd4 = ins[0][1].shape
    nd, dev = nd4 // 4, ins[0][1].device
    n = ins[0][0].shape[0]
    plan = layouts[0]
    if any(tuple(lay) != tuple(plan) for lay in layouts):
        raise ValueError(f"the groups of one launch take one layout, not {layouts}")
    f32, keep = torch.float32, []
    for U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT in ins:
        keep.append(dict(
            U=U_c.to(f32).contiguous(), gseq=g_seq.contiguous(),
            cprev=c_prev.contiguous(), cT=cT.to(f32).contiguous(),
            dhseq=dh_seq.to(f32).contiguous(), dhT=dhT.to(f32).contiguous(),
            dc=dcT.to(f32).clone().contiguous(),
            dg=torch.empty(s, b, 4 * nd, dtype=f32, device=dev),
            dh0=torch.empty(b, nd, dtype=f32, device=dev)))
    cols = [_ptrs([t[k].data_ptr() for t in keep]) for k in
            ("U", "gseq", "cprev", "cT", "dhseq", "dhT", "dc", "dg", "dh0")]
    launched = ctypes.c_int(0)
    err = ex.lib.tp_seq_bwd_f32_ranks_launch(
        rtype, len(ranks), _ints(ranks), plan.blocks, plan.rows, plan.stages, *cols,
        len(ex.ptrs), _ptrs(ex.ptrs), ex.layout.r_off, ex.take("bwd", s), s, b, n,
        nd, int(cfg.cell_variant == "standard"), _stream(dev), ctypes.byref(launched))
    cuda_cell._raise_on(err, "tp_seq_bwd_f32_ranks_launch")
    return [(t["dg"], t["dh0"], t["dc"]) for t in keep], launched.value


def _fwd_types(cfg: ModelConfig, dev, nd: int):
    ctype = _card(cfg, dev, nd)
    if cfg.pdtype != torch.float32 or cfg.rdtype not in cuda_cell._TYPE_CODES:
        raise TypeError(f"K15 takes float32 params and float32/bfloat16 "
                        f"residuals, not {cfg.param_dtype}/{cfg.residual_dtype}")
    return ctype, cuda_cell._TYPE_CODES[cfg.rdtype]


def _bwd_types(cfg: ModelConfig, dev, nd: int, g_seq, c_prev):
    ctype = _card(cfg, dev, nd)
    if g_seq.dtype not in cuda_cell._TYPE_CODES or c_prev.dtype != g_seq.dtype:
        raise TypeError(f"K16 takes float32/bfloat16 residuals, got "
                        f"{g_seq.dtype}/{c_prev.dtype}")
    return ctype, cuda_cell._TYPE_CODES[g_seq.dtype]


def tp_seq_fwd(U_c, xw, h0_full, c0, cfg: ModelConfig,
               group: Optional[mesh.TPGroup] = None):
    """The TP window: K15 on the card, at D = 1 in the design
    ``cuda_cell_tiled.device_split_fwd_f32_plan`` (fp32) or
    ``device_split_fwd_plan`` (bf16) gives, at D > 1 the exchange design
    through the group's buffers; the plain version on the CPU. Returns as
    ``tp_seq_fwd_plain``."""
    s, b, nd4 = xw.shape
    nd = nd4 // 4
    n = h0_full.shape[1]
    dev = xw.device
    for name, x, shape in (("U", U_c, (n, 4 * nd)), ("h0_full", h0_full, (b, n)),
                           ("c0", c0, (b, nd))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return tp_seq_fwd_plain(U_c, xw, h0_full, c0, cfg, group)
    ctype, rtype = _fwd_types(cfg, dev, nd)
    if group is not None and group.size > 1:
        ex = group_exchange(group, b, n, cfg.cdtype)   # raises first without peer access
        plan = device_ranks_fwd_plan(cfg, b, n, group.size, one_card=False)
        (out,), launched = _fwd_ranks(ex, [group.rank], None, [(U_c, xw, h0_full, c0)],
                                      cfg, ctype, rtype, plan and [plan])
        tp_seq_fwd.launches += launched
        return out
    lib = _build.load_library()
    f32 = torch.float32
    U_k = ct._aligned(U_c.to(cfg.cdtype))
    xw32 = ct._aligned(xw.to(f32))
    hbuf = torch.empty(2, b, n, dtype=cfg.cdtype, device=dev)
    hbuf[0] = h0_full
    c = c0.to(f32).clone().contiguous()
    h_seq = torch.empty(s, b, nd, dtype=f32, device=dev)
    g_seq = torch.empty(s, b, 4 * nd, dtype=cfg.rdtype, device=dev)
    c_prev = torch.empty(s, b, nd, dtype=cfg.rdtype, device=dev)
    hT = torch.empty(b, nd, dtype=f32, device=dev)
    launched = ctypes.c_int(0)
    split32 = ct.device_split_fwd_f32_plan(cfg, b, n)   # D = 1: nd == n
    if split32 is not None:
        # K9's fp32 persistent kernel in K15's mode; c holds cT on return
        name, cT = "tp_seq_fwd_f32_launch", c
        err = lib.tp_seq_fwd_f32_launch(
            rtype, U_k.data_ptr(), xw32.data_ptr(), hbuf.data_ptr(), c.data_ptr(),
            hT.data_ptr(), h_seq.data_ptr(), c_prev.data_ptr(), g_seq.data_ptr(),
            s, b, n, int(cfg.cell_variant == "standard"), *split32, _stream(dev),
            ctypes.byref(launched))
    else:
        name, cT = "tp_seq_fwd_launch", torch.empty(b, nd, dtype=f32, device=dev)
        layout = ct.device_split_fwd_plan(cfg, b, n)
        err = lib.tp_seq_fwd_launch(
            ctype, rtype, U_k.data_ptr(), xw32.data_ptr(), hbuf.data_ptr(),
            c.data_ptr(), h_seq.data_ptr(), g_seq.data_ptr(), c_prev.data_ptr(),
            hT.data_ptr(), cT.data_ptr(), s, b, n, nd,
            int(cfg.cell_variant == "standard"), *(layout or (-1, 0)),
            _stream(dev), ctypes.byref(launched))
    tp_seq_fwd.launches += launched.value
    cuda_cell._raise_on(err, name)
    return h_seq, g_seq, c_prev, hT, cT


def tp_seq_bwd(U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT, cfg: ModelConfig,
               group: Optional[mesh.TPGroup] = None):
    """The TP reverse window: K16 on the card, at D = 1 in the design
    ``cuda_cell_bwd.device_k6_plan`` (bf16) or ``device_k6_f32_plan``
    (fp32) gives, at D > 1 the exchange design through the group's
    buffers; the plain version on the CPU. Returns as
    ``tp_seq_bwd_plain``."""
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
    ctype, rtype = _bwd_types(cfg, dev, nd, g_seq, c_prev)
    if group is not None and group.size > 1:
        ex = group_exchange(group, b, n, cfg.cdtype)
        plan = _bwd_layout(device_ranks_bwd_plan(cfg, b, n, group.size,
                                                 one_card=False), b)
        (out,), launched = _bwd_ranks(
            ex, [group.rank], None, [(U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT)],
            cfg, ctype, rtype, plan and [plan])
        tp_seq_bwd.launches += launched
        return out
    lib = _build.load_library()
    f32 = torch.float32
    gs, cs = g_seq.contiguous(), c_prev.contiguous()
    cT32, dh32, dhT32 = (x.to(f32).contiguous() for x in (cT, dh_seq, dhT))
    dc = dcT.to(f32).clone().contiguous()
    dg = torch.empty(s, b, 4 * nd, dtype=f32, device=dev)
    dh0 = torch.empty(b, nd, dtype=f32, device=dev)
    # K6's persistent reverse launch on K16's c layout, without a copy of
    # the stream: c_seq = c_prev advanced a step (c_seq[t] = c_prev[t + 1]
    # below S-1), c0 = c_prev[0] in fp32 and c_{S-1} = cT in fp32; no db,
    # no dropout, a step at a time; dU stays ``window_dU``'s product
    plan = cuda_cell_bwd.device_k6_plan(cfg, b, nd)
    plan32 = cuda_cell_bwd.device_k6_f32_plan(cfg, b, nd)
    if plan is not None:
        # bf16: the fp32 dg into dg, its bf16 rounding (which the next
        # step's product reads) into a scratch
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
    elif plan32 is not None:
        # fp32: U read in place, the G parts of dh_rec in the launch's scratch
        name = "lstm_bwd_f32_launch"
        err = cuda_cell_bwd.reverse_f32(
            plan32, cfg, U_c.to(f32).contiguous(), gs, cs[1:], cs[0].to(f32), dh32,
            dhT32, dc, dg, dh0, None, ctypes.c_int(0), c_last=cT32)
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


def _one_card(xs, what: str, exchange: Optional[Exchange], key):
    """The device of the D shards, one device; on a card, ``exchange`` must
    be buffers of ``key``."""
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{what}: the D shards lie on {[x.device for x in xs]}, "
                         f"not on one device")
    if dev.type != "cpu" and (exchange is None or exchange.key != key):
        raise ValueError(f"{what} on {dev} takes the one-card buffers of "
                         f"(B, N, D, compute type) = {key} "
                         f"(one_card_exchange), not {exchange and exchange.key}")
    return dev


def _one_card_layouts(what, plan, blocks, layouts, d):
    """The layouts of the D groups for the persistent design, or None for
    the cooperative one: ``layouts`` as given where the plan gives one (bf16
    with a layout), None where ``blocks`` (the cooperative design's split)
    is given, else the plan's layout for every group."""
    if blocks is not None and layouts is not None:
        raise ValueError(f"{what}: blocks (the cooperative design's) and layouts "
                         f"(the persistent design's) both given")
    if layouts is not None:
        if plan is None:
            raise ValueError(f"{what}: layouts {layouts} given where the "
                             f"persistent design does not run (no layout)")
        if len(layouts) != d:
            raise ValueError(f"{what}: {len(layouts)} layouts for {d} rank groups")
        return list(layouts)
    return None if blocks is not None or plan is None else [plan] * d


def tp_seq_fwd_ranks(U_cs: Sequence, xws: Sequence, h0_full, c0s: Sequence,
                     cfg: ModelConfig, exchange: Optional[Exchange] = None,
                     blocks: Optional[Sequence[int]] = None, layouts=None):
    """K15 at D = len(U_cs) ranks on one card: one launch of D rank
    groups, group r playing rank r on U_cs[r], xws[r], c0s[r] and the full
    h0, through ``exchange``, the card's D buffers (``one_card_exchange``).
    Where ``device_ranks_fwd_plan`` gives a layout, the persistent design
    of the compute type, each group with that layout or ``layouts[r]``
    (bf16: (kres, rows); fp32: an ``F32Split``; so that one group can
    lag); elsewhere, or with ``blocks`` (the blocks of each group,
    ``rank_blocks``), the cooperative design. The plain version on the
    CPU. A list of D outputs as ``tp_seq_fwd_plain``'s."""
    d, (s, b, nd4) = len(U_cs), xws[0].shape
    nd = nd4 // 4
    n = h0_full.shape[1]
    dev = _one_card(list(U_cs) + list(xws) + list(c0s) + [h0_full], "K15",
                    exchange, (b, n, d, cfg.cdtype))
    if n != d * nd:
        raise ValueError(f"K15: h0_full is {n} wide, not D * nd = {d * nd}")
    for r in range(d):
        for name, x, shape in (("U", U_cs[r], (n, 4 * nd)), ("xw", xws[r], (s, b, 4 * nd)),
                               ("c0", c0s[r], (b, nd))):
            _check(f"{name}[{r}]", x, shape, dev)
    _check("h0_full", h0_full, (b, n), dev)
    if dev.type == "cpu":
        return tp_seq_fwd_ranks_plain(U_cs, xws, h0_full, c0s, cfg)
    ctype, rtype = _fwd_types(cfg, dev, nd)
    h0_c = h0_full.to(cfg.cdtype).contiguous()   # one copy for the D groups
    ins = [(U_cs[r], xws[r], h0_c, c0s[r]) for r in range(d)]
    plan = device_ranks_fwd_plan(cfg, b, n, d, one_card=True)
    outs, launched = _fwd_ranks(exchange, list(range(d)), blocks, ins, cfg, ctype,
                                rtype, _one_card_layouts("K15", plan, blocks, layouts, d))
    tp_seq_fwd_ranks.launches += launched
    return outs


def tp_seq_bwd_ranks(U_cs: Sequence, g_seqs: Sequence, c_prevs: Sequence,
                     cTs: Sequence, dh_seqs: Sequence, dhTs: Sequence,
                     dcTs: Sequence, cfg: ModelConfig,
                     exchange: Optional[Exchange] = None,
                     blocks: Optional[Sequence[int]] = None, layouts=None):
    """K16 at D = len(U_cs) ranks on one card, as ``tp_seq_fwd_ranks``:
    every argument by rank; the bf16 persistent design's layouts are
    (units, rows, row_blocks) a group, units and rows those of
    ``device_ranks_bwd_plan`` (row_blocks of ceil(B / rows) by default,
    fewer so that a group lags, at least ``lag_row_blocks``), the fp32
    one's the plan's ``F32Plan``, one for every group. A list of D (dg,
    dh0, dc0)."""
    d, (s, b, nd4) = len(U_cs), g_seqs[0].shape
    nd = nd4 // 4
    n = U_cs[0].shape[0]
    ins = [(U_cs[r], g_seqs[r], c_prevs[r], cTs[r], dh_seqs[r], dhTs[r], dcTs[r])
           for r in range(d)]
    dev = _one_card([x for xs in ins for x in xs], "K16", exchange,
                    (b, n, d, cfg.cdtype))
    if n != d * nd:
        raise ValueError(f"K16: U is {n} wide, not D * nd = {d * nd}")
    for r, (U_c, g_seq, c_prev, cT, dh_seq, dhT, dcT) in enumerate(ins):
        for name, x, shape in (("U", U_c, (n, 4 * nd)), ("g_seq", g_seq, (s, b, 4 * nd)),
                               ("c_prev", c_prev, (s, b, nd)), ("cT", cT, (b, nd)),
                               ("dh_seq", dh_seq, (s, b, nd)), ("dhT", dhT, (b, nd)),
                               ("dcT", dcT, (b, nd))):
            _check(f"{name}[{r}]", x, shape, dev)
    if dev.type == "cpu":
        return tp_seq_bwd_ranks_plain(U_cs, g_seqs, c_prevs, cTs, dh_seqs, dhTs,
                                      dcTs, cfg)
    ctype, rtype = _bwd_types(cfg, dev, nd, g_seqs[0], c_prevs[0])
    plan = _bwd_layout(device_ranks_bwd_plan(cfg, b, n, d, one_card=True), b)
    outs, launched = _bwd_ranks(exchange, list(range(d)), blocks, ins, cfg, ctype,
                                rtype, _one_card_layouts("K16", plan, blocks, layouts, d))
    tp_seq_bwd_ranks.launches += launched
    return outs


tp_seq_fwd_ranks.launches = 0
tp_seq_bwd_ranks.launches = 0


def window_dU(h0_full, h_all, dg, cfg: ModelConfig):
    """dU of a window, the product outside K16 (``pallas_tp_seq.py:315-325``):
    round(h_prev)^T round(dg) with fp32 sums, h_prev the full h0, then the
    full h_seq (S, B, N) but its last step; dg (S, B, 4nd)."""
    s, b, nd4 = dg.shape
    h_prev = torch.cat([h0_full[None].to(h_all.dtype), h_all[:-1]])
    return cell_ops.matmul(h_prev.reshape(s * b, -1).T, dg.reshape(s * b, nd4),
                           cfg.cdtype, cuda_cell._acc_dtype(cfg))


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
        dU = window_dU(h0_full, mesh.all_gather(h_seq, 2, group), dg, cfg)
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
