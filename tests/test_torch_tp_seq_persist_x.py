"""K15 and K16 at D > 1 in their persistent tensor-core designs
(``ops/cuda_tp_seq.py``: ``ranks_fwd_plan``, ``ranks_bwd_plan`` and the
launches they route to), on the CPU, where no kernel runs.

The planners with H100 numbers (132 SMs, 232,448 bytes of shared memory a
block) at the bench's (B 128, N 512, D 2 and 4) and the flagship's (B 128,
N 1024, D 2) shapes, for D groups on one card (132 // D SMs a group) and
for a group on a card of its own: on one card the forward keeps the
D = 1 layout's rows, so that its D groups hold the D = 1 design's blocks;
every grid fits; None in fp32, where the grid or the shared memory does
not fit, at D = 1 and at widths the kernels do not take. The routing
through ``test_torch_tp_seq_exchange``'s stand-in library (tensors on
``meta``): under bf16 with a layout the one-card entries and the group
path on D cards reach the persistent launches, one a call, with the
planners' layouts (or a lagging group's); fp32 with a layout reaches the
fp32 persistent launches (tests/test_torch_tp_seq_f32.py holds them); fp32
past 128 rows, no layout or a cooperative split reach
``tp_seq_*_ranks_launch``. The kernel source: the persistent kernels' slot
and flag rules, read from ``exchange.cuh``'s RankStep and
``lstm_tp_persist.cu``, are the cooperative kernels' (which
``test_torch_tp_seq_exchange`` follows
across calls), on the forward's and backward's flag and barrier words;
the backward's tile constants and kernel table are the planner's.
"""

import math
import re

import pytest
import torch

from test_torch_tp_seq_exchange import (LP_CU, _arr, _c_expr, _kernel_exchanges,
                                        _meta, routed)  # noqa: F401
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts
from eigen_lstm_tpu_torch.parallel import mesh

PERSIST_CU = LP_CU.replace("lstm_tp.cu", "lstm_tp_persist.cu")
EX_CUH = LP_CU.replace("lstm_tp.cu", "exchange.cuh")
FWD_MMA = LP_CU.replace("lstm_tp.cu", "fwd_mma.cuh")
BWD_END = "// K15 at D ranks on the persistent forward: group g"   # the launcher after it
SMS, SMEM = 132, 232448        # H100 SXM: SMs, shared memory a block may opt in to
SHAPES = [(128, 512, 2), (128, 512, 4), (128, 1024, 2)]   # bench D = 2, 4; flagship
BF16 = torch.bfloat16


def _cfg(n, dtype="bfloat16"):
    return TConfig(hidden=n, compute_dtype=dtype)


# --- the planners -------------------------------------------------------------


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_forward_plan_on_one_card_keeps_the_d1_rows(b, n, d):
    """D groups of 132 // D SMs take the D = 1 layout's rows and all of
    U's rows: their blocks are the D = 1 design's (128), each group's
    within its SMs."""
    cfg = _cfg(n)
    kres1, rows1 = ct.split_fwd_plan(cfg, b, n, SMS, SMEM)
    kres, rows = ts.ranks_fwd_plan(cfg, b, n, d, SMS // d, SMEM, rows1)
    group = n // d // ct.PERSIST_UNITS * -(-b // rows)
    assert (kres, rows) == (kres1, rows1) == (n, rows1)
    assert group <= SMS // d
    assert d * group == n // ct.PERSIST_UNITS * -(-b // rows1) == 128
    assert ct.persist_smem_bytes(rows, n, kres) <= SMEM


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_forward_plan_on_a_card_of_its_own(b, n, d):
    cfg = _cfg(n)
    kres, rows = ts.ranks_fwd_plan(cfg, b, n, d, SMS, SMEM)
    assert n // d // ct.PERSIST_UNITS * -(-b // rows) <= SMS
    assert rows % 16 == 0 and kres % ct.PERSIST_KC == 0 and kres <= n
    assert ct.persist_smem_bytes(rows, n, kres) <= SMEM
    # where the D = 1 rows do not fit, the group's own split
    assert ts.ranks_fwd_plan(cfg, b, n, d, 8, SMEM, 32) == (
        None if n // d // 16 > 8 else ts.ranks_fwd_plan(cfg, b, n, d, 8, SMEM))


@pytest.mark.parametrize("one_card", [True, False])
@pytest.mark.parametrize("b,n,d,want", [(128, 512, 2, ((64, 16), (64, 16))),
                                        (128, 512, 4, ((64, 32), (64, 16))),
                                        (128, 1024, 2, ((32, 64), (32, 32)))])
def test_backward_plan(b, n, d, want, one_card):
    """The most units whose U_r rows fit, then the fewest rows whose grid
    fits the group's SMs; every thread at most GATE_ELEMS gate-backward
    elements; a kernel of the table for each layout."""
    sms = SMS // d if one_card else SMS
    units, rows = ts.ranks_bwd_plan(_cfg(n), b, n, d, sms, SMEM)
    assert (units, rows) == want[0 if one_card else 1]
    blocks = n // units * -(-b // rows)
    assert blocks <= sms
    assert ts.ranks_bwd_smem_bytes(n // d, units, rows) <= SMEM
    assert b * (n // d) <= blocks * ts.X_THREADS * ts.GATE_ELEMS
    assert (units, rows) in _kernel_table()


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_plans_refuse(b, n, d):
    """None in fp32, at D = 1, where the grid or the shared memory does not
    fit, at a shard width not a multiple of 32, and (the forward) past 128
    batch rows."""
    for plan in (ts.ranks_fwd_plan, ts.ranks_bwd_plan):
        assert plan(_cfg(n, "float32"), b, n, d, SMS, SMEM) is None
        assert plan(_cfg(n), b, n, 1, SMS, SMEM) is None
        assert plan(_cfg(n), b, n, d, 3, SMEM) is None
        assert plan(_cfg(n), b, n, d, SMS, 20000) is None
        assert plan(_cfg(160), b, 160, 2, SMS, SMEM) is None   # nd = 80
    assert ts.ranks_fwd_plan(_cfg(n), 256, n, d, SMS, SMEM) is None


def test_lag_row_blocks():
    """The fewest row blocks a backward group may take: each thread at most
    GATE_ELEMS of the rank's B x nd elements."""
    for b, n, d in SHAPES:
        units, rows = ts.ranks_bwd_plan(_cfg(n), b, n, d, SMS // d, SMEM)
        lag = ts.lag_row_blocks(b, n, d, units)
        assert 1 <= lag <= -(-b // rows)
        assert b * (n // d) <= n // units * lag * ts.X_THREADS * ts.GATE_ELEMS
        assert lag == 1 or b * (n // d) > n // units * (lag - 1) * 2048
    assert ts.lag_row_blocks(128, 512, 2, 64) == 2


def test_device_plans_take_the_cards_limits(monkeypatch):
    monkeypatch.setattr(ts, "_card_limits", lambda: (SMS, SMEM))
    for b, n, d in SHAPES:
        cfg = _cfg(n)
        rows1 = ct.split_fwd_plan(cfg, b, n, SMS, SMEM)[1]
        assert ts.device_ranks_fwd_plan(cfg, b, n, d, True) == \
            ts.ranks_fwd_plan(cfg, b, n, d, SMS // d, SMEM, rows1)
        assert ts.device_ranks_fwd_plan(cfg, b, n, d, False) == \
            ts.ranks_fwd_plan(cfg, b, n, d, SMS, SMEM)
        assert ts.device_ranks_bwd_plan(cfg, b, n, d, True) == \
            ts.ranks_bwd_plan(cfg, b, n, d, SMS // d, SMEM)
        assert ts.device_ranks_bwd_plan(cfg, b, n, d, False) == \
            ts.ranks_bwd_plan(cfg, b, n, d, SMS, SMEM)


# --- the routing ---------------------------------------------------------------


def _one_card_inputs(d, s, b, n):
    nd = n // d
    U = [_meta(n, 4 * nd, dtype=BF16) for _ in range(d)]
    xw = [_meta(s, b, 4 * nd) for _ in range(d)]
    return U, xw, _meta(b, n), [_meta(b, nd) for _ in range(d)]


@pytest.mark.parametrize("d", [2, 4])
def test_one_card_routes_bf16_to_the_persistent_launches(routed, d):
    """Under bf16 with a layout, ``tp_seq_fwd_ranks`` and
    ``tp_seq_bwd_ranks`` make one persistent launch each, D groups with
    the planners' layouts, every group's tensors in rank order, the D
    buffers at the layout's offsets; the forward's c comes back as cT."""
    lib, ptr = routed
    lib.limits = (SMS, SMEM)
    s, b, n = 4, 128, 512
    nd = n // d
    cfg = _cfg(n)
    U, xw, h0, c0 = _one_card_inputs(d, s, b, n)
    ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
    kres, rows = ts.ranks_fwd_plan(cfg, b, n, d, SMS // d, SMEM,
                                   ct.split_fwd_plan(cfg, b, n, SMS, SMEM)[1])
    before = (ts.tp_seq_fwd_ranks.launches, ts.tp_seq_bwd_ranks.launches)
    out = ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg, ex)
    (name, call), = lib.calls
    assert name == "tp_seq_fwd_persist_ranks_launch"
    assert call[:2] == (0, d) and _arr(call[2], d) == list(range(d))
    assert _arr(call[3], d) == [kres] * d and _arr(call[4], d) == [rows] * d
    assert _arr(call[5], d) == [ptr(u) for u in U]
    assert len(set(_arr(call[7], d))) == 1                      # the one h0
    for col, k in ((8, 4), (9, 0), (10, 1), (11, 2), (12, 3)):
        assert _arr(call[col], d) == [ptr(o[k]) for o in out]
    lay = ts.exchange_layout(b, n, d, 2)
    assert call[13] == d and _arr(call[14], d) == ex.ptrs
    assert call[15:22] == (lay.h_off, 0, s, b, n, nd, 0) and call[22] == 7
    lib.calls.clear()
    units, rows_b = ts.ranks_bwd_plan(cfg, b, n, d, SMS // d, SMEM)
    dh, z = [_meta(s, b, nd) for _ in range(d)], [_meta(b, nd) for _ in range(d)]
    res = ts.tp_seq_bwd_ranks(U, [o[1] for o in out], [o[2] for o in out],
                              [o[4] for o in out], dh, z, z, cfg, ex)
    (name, call), = lib.calls
    assert name == "tp_seq_bwd_persist_ranks_launch"
    assert call[:2] == (0, d) and _arr(call[2], d) == list(range(d))
    assert _arr(call[3], d) == [-(-b // rows_b)] * d
    assert _arr(call[4], d) == [ptr(u) for u in U]            # U untransposed
    assert _arr(call[5], d) == [ptr(o[1]) for o in out]
    for col, k in ((10, 2), (11, 0), (13, 1)):                 # dc, dg, dh0
        assert _arr(call[col], d) == [ptr(r[k]) for r in res]
    assert call[14] == d and _arr(call[15], d) == ex.ptrs
    assert call[16:25] == (lay.r_off, 0, s, b, n, nd, units, rows_b, 0)
    assert (ts.tp_seq_fwd_ranks.launches, ts.tp_seq_bwd_ranks.launches) == (
        before[0] + 1, before[1] + 1)
    assert ex.steps == {"fwd": s, "bwd": s}


def test_one_card_takes_a_lagging_group(routed):
    """A layout a group: rank 0 on a forward of one block row and a
    backward of the fewest row blocks."""
    lib, _ = routed
    lib.limits = (SMS, SMEM)
    s, b, n, d = 3, 128, 512, 2
    nd = n // d
    cfg = _cfg(n)
    U, xw, h0, c0 = _one_card_inputs(d, s, b, n)
    ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
    plan = ts.device_ranks_fwd_plan(cfg, b, n, d, True)
    lag = ts.ranks_fwd_plan(cfg, b, n, d, nd // 16, SMEM)
    assert lag[1] == b
    out = ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg, ex, layouts=[lag, plan])
    units, rows = ts.device_ranks_bwd_plan(cfg, b, n, d, True)
    blay = [(units, rows, ts.lag_row_blocks(b, n, d, units)), (units, rows, b // rows)]
    z = [_meta(b, nd) for _ in range(d)]
    ts.tp_seq_bwd_ranks(U, [o[1] for o in out], [o[2] for o in out], z,
                        [_meta(s, b, nd) for _ in range(d)], z, z, cfg, ex,
                        layouts=blay)
    (f_name, f), (b_name, bw) = lib.calls
    assert (f_name, b_name) == ("tp_seq_fwd_persist_ranks_launch",
                                "tp_seq_bwd_persist_ranks_launch")
    assert _arr(f[3], d) == [lag[0], plan[0]] and _arr(f[4], d) == [b, plan[1]]
    assert _arr(bw[3], d) == [2, b // rows] and bw[22:24] == (units, rows)
    with pytest.raises(ValueError, match="one .units, rows."):
        ts.tp_seq_bwd_ranks(U, [o[1] for o in out], [o[2] for o in out], z,
                            [_meta(s, b, nd) for _ in range(d)], z, z, cfg, ex,
                            layouts=[(64, 16, 8), (32, 16, 8)])


@pytest.mark.parametrize("case", ["fp32", "no_layout", "blocks"])
def test_one_card_routes_the_rest_to_the_cooperative_launches(routed, case):
    """fp32 past 128 batch rows (which no fp32 plan takes), a card where no
    layout fits, or a cooperative split given: ``tp_seq_*_ranks_launch``."""
    lib, _ = routed
    lib.limits = (SMS, 0 if case == "no_layout" else SMEM)
    s, b, n, d = 3, 136 if case == "fp32" else 128, 512, 2
    nd = n // d
    cfg = _cfg(n, "float32" if case == "fp32" else "bfloat16")
    U, xw, h0, c0 = _one_card_inputs(d, s, b, n)
    ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
    blocks = [5, 7] if case == "blocks" else None
    out = ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg, ex, blocks=blocks)
    z = [_meta(b, nd) for _ in range(d)]
    ts.tp_seq_bwd_ranks(U, [o[1] for o in out], [o[2] for o in out], z,
                        [_meta(s, b, nd) for _ in range(d)], z, z, cfg, ex,
                        blocks=blocks)
    assert [c[0] for c in lib.calls] == ["tp_seq_fwd_ranks_launch",
                                         "tp_seq_bwd_ranks_launch"]
    if blocks:
        assert _arr(lib.calls[0][1][4], d) == blocks == _arr(lib.calls[1][1][4], d)


def test_one_card_refuses_mixed_or_misplaced_layouts(routed):
    lib, _ = routed
    lib.limits = (SMS, SMEM)
    s, b, n, d = 3, 128, 512, 2
    U, xw, h0, c0 = _one_card_inputs(d, s, b, n)
    ex = ts.one_card_exchange(b, n, d, BF16)
    with pytest.raises(ValueError, match="both given"):
        ts.tp_seq_fwd_ranks(U, xw, h0, c0, _cfg(n), ex, blocks=[4, 4],
                            layouts=[(512, 32)] * 2)
    with pytest.raises(ValueError, match="2 rank groups"):
        ts.tp_seq_fwd_ranks(U, xw, h0, c0, _cfg(n), ex, layouts=[(512, 32)])
    ex32 = ts.one_card_exchange(b, n, d, torch.float32)
    lib.limits = (SMS, 0)   # no fp32 layout fits such a card
    with pytest.raises(ValueError, match="does not run"):
        ts.tp_seq_fwd_ranks(U, xw, h0, c0, _cfg(n, "float32"), ex32,
                            layouts=[(512, 32)] * 2)
    assert lib.calls == []


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_group_path_routes_by_the_plan(routed, dtype):
    """On D cards ``tp_seq_fwd`` and ``tp_seq_bwd`` launch one group, this
    process's rank, with the layouts of a group on a card of its own (the
    fp32 backward: the G of a group on one card, 132 // D SMs); one launch
    each."""
    lib, ptr = routed
    lib.limits = (SMS, SMEM)
    s, b, n, d = 3, 128, 512, 2
    nd = n // d
    cfg = _cfg(n, dtype)
    group = mesh.AxisGroup(1, d, torch.device("meta"))
    key = ("tp_seq", b, n, d, cfg.cdtype)
    csize = torch.finfo(cfg.cdtype).bits // 8
    ex = group.exchange[key] = ts.Exchange(None, key, ts.exchange_layout(b, n, d, csize),
                                           [11 << 32, 12 << 32], [])
    ex.lib = lib
    before = (ts.tp_seq_fwd.launches, ts.tp_seq_bwd.launches)
    h_seq, g, cp, hT, cT = ts.tp_seq_fwd(_meta(n, 4 * nd, dtype=cfg.cdtype),
                                         _meta(s, b, 4 * nd), _meta(b, n),
                                         _meta(b, nd), cfg, group)
    dg, dh0, dc0 = ts.tp_seq_bwd(_meta(n, 4 * nd, dtype=cfg.cdtype), g, cp, cT,
                                 _meta(s, b, nd), _meta(b, nd), _meta(b, nd), cfg, group)
    assert (ts.tp_seq_fwd.launches, ts.tp_seq_bwd.launches) == (before[0] + 1,
                                                                before[1] + 1)
    (fname, f), (bname, bw) = lib.calls
    if dtype == "float32":
        assert (fname, bname) == ("tp_seq_fwd_f32_ranks_launch",
                                  "tp_seq_bwd_f32_ranks_launch")
        split = ts.ranks_fwd_f32_plan(cfg, b, n, d, SMS, SMEM)
        plan = ts.ranks_bwd_f32_plan(cfg, b, n, d, SMS // d, SMEM)
        assert f[:2] == (0, 1) and f[2][0] == 1 and f[3][0] == split.rows
        assert f[4:7] == split[1:]
        assert f[15] == d and _arr(f[16], d) == ex.ptrs and f[17:19] == (ex.layout.h_off, 0)
        assert f[10][0] == ptr(cT) and f[11][0] == ptr(h_seq)
        assert bw[:2] == (0, 1) and bw[2][0] == 1 and bw[3:6] == tuple(plan)
        assert bw[15] == d and _arr(bw[16], d) == ex.ptrs
        assert bw[17:19] == (ex.layout.r_off, 0)
        assert bw[13][0] == ptr(dg) and bw[14][0] == ptr(dh0)
        assert ex.steps == {"fwd": s, "bwd": s}
        return
    assert (fname, bname) == ("tp_seq_fwd_persist_ranks_launch",
                              "tp_seq_bwd_persist_ranks_launch")
    kres, rows = ts.ranks_fwd_plan(cfg, b, n, d, SMS, SMEM)
    units, rows_b = ts.ranks_bwd_plan(cfg, b, n, d, SMS, SMEM)
    assert f[:2] == (0, 1) and f[2][0] == 1 and (f[3][0], f[4][0]) == (kres, rows)
    assert f[13] == d and _arr(f[14], d) == ex.ptrs and f[15:17] == (ex.layout.h_off, 0)
    assert f[8][0] == ptr(cT) and f[9][0] == ptr(h_seq)
    assert bw[:2] == (0, 1) and bw[2][0] == 1 and bw[3][0] == -(-b // rows_b)
    assert bw[22:24] == (units, rows_b) and bw[16:18] == (ex.layout.r_off, 0)
    assert bw[11][0] == ptr(dg) and bw[13][0] == ptr(dh0)
    assert ex.steps == {"fwd": s, "bwd": s}


# --- the kernel source ------------------------------------------------------------


def _section(src, start, end):
    a = src.index(start)
    return src[a:src.index(end, a)]


def _persist_exchanges(window=FWD_MMA, bsrc=None):
    """The slot and flag rules of ``RankStep`` (exchange.cuh: the
    persistent forwards' step end, whose window ``window`` says at which
    steps it syncs) and of a persistent backward kernel ``bsrc``
    (``tp_seq_bwd_persist_x`` of lstm_tp_persist.cu by default), as
    ``_kernel_exchanges`` gives the cooperative kernels': fwd(base, s) step
    t's (slot read, slot written, flag raised; None, None at the last
    step), bwd(base, s) the (chunk slot, flag) of exchange e = 0..S-1."""
    xsrc = open(EX_CUH).read()
    step = _section(xsrc, "struct RankStep {", "// The group of this block")
    read = _c_expr(step, r"h_off\) \+\s*\((\([^;]*?\) % 3)\) \* bN;")
    write = _c_expr(step, r"at = \((\([^;]*?\) % 3)\) \* bN")
    skip = _c_expr(step, r"if \(([^)]*)\) return;  // the last step")
    flag = _c_expr(step, r"kFwdFlag, count, nb, static_cast<unsigned>\(([^;]*?)\)\);")
    when = _c_expr(open(window).read(), r"if \(([^)]*)\) step\.sync\(t\);")
    if bsrc is None:
        bsrc = _section(open(PERSIST_CU).read(), "tp_seq_bwd_persist_x(const", BWD_END)
    e_of = _c_expr(bsrc, r"const unsigned long long e = (base \+ \(S - 2 - t\));")
    e_last = _c_expr(bsrc, r"const unsigned long long e = (base \+ \(S - 1\));")
    slots = re.findall(r"const int ws = static_cast<int>\(([^;]*?)\);", bsrc)
    bflags = re.findall(r"kBwdFlag, bar, nb, static_cast<unsigned>\(([^;]*?)\)\);", bsrc)
    assert len(slots) == len(bflags) == 2 and len(set(slots)) == len(set(bflags)) == 1
    slot = lambda e: eval(slots[0], {}, {"e": e})
    bflag = lambda e: eval(bflags[0], {}, {"e": e})
    assert "if (t == S - 1) {" in bsrc and "for (int t = S - 1; t >= 0; --t)" in bsrc
    word = lambda x: x % 2 ** 32

    def fwd(base, s):
        out = []
        for t in range(s):
            on = when(t=t, S=s)
            assert on == (not skip(t=t, S=s))   # no store where no exchange
            out.append((read(base=base, t=t),
                        write(base=base, t=t) if on else None,
                        word(flag(base=base, t=t)) if on else None))
        return out

    def bwd(base, s):
        es = [e_of(base=base, S=s, t=t) for t in range(s - 2, -1, -1)]
        es.append(e_last(base=base, S=s))
        return [(slot(e), word(bflag(e))) for e in es]

    return fwd, bwd


@pytest.mark.parametrize("s", [1, 2, 3, 5, 7])
def test_persistent_kernels_keep_the_slot_and_flag_rules(s):
    """Step for step the persistent kernels read, write and flag the slots
    the cooperative kernels do (whose rules hold across calls), and the
    forward stores no h at the step it exchanges nothing."""
    fwd_p, bwd_p = _persist_exchanges()
    fwd_x, bwd_x, h0 = _kernel_exchanges()
    for base in (0, 1, 2, 10, 2 ** 32 - 2):
        assert fwd_p(base, s) == fwd_x(base, s)
        assert fwd_p(base, s)[0][0] == h0(base)
        assert bwd_p(base, s) == bwd_x(base, s)


def test_persistent_kernels_use_the_layouts_words():
    """The persistent forward counts its arrivals on the forward barrier's
    word and flags the forward's words; the backward both the backward's,
    the offsets of ``exchange_layout``'s header; both launch through
    copy_h0's slot (forward) and the group table's first blocks."""
    src = open(PERSIST_CU).read()
    fsrc = _section(src, "tp_seq_fwd_persist_x(const", "// -------")
    bsrc = _section(src, "tp_seq_bwd_persist_x(const", BWD_END)
    assert "words(peers.buf[G.rank], kFwdBar)" in fsrc
    assert "unsigned* bar = words(mine, kBwdBar);" in bsrc
    assert bsrc.count("rank_barrier(bar, nb)") == 1          # one a reverse step
    assert "kFwd" not in bsrc and "kBwd" not in fsrc
    launcher = _section(src, "int run_fwd_persist_ranks(", "// The persistent backward's kernel")
    assert "copy_h0(groups, ranks, h0, peers, h_off, base," in launcher


def _kernel_table():
    """(units, rows) of each persistent backward kernel in lstm_tp_persist.cu's
    table, checked against its template arguments (MT = rows / 16 m tiles,
    NT = units / 8 n tiles)."""
    src = open(PERSIST_CU).read()
    rows = re.findall(r"if \(units == (\d+) && rows == (\d+)\) return "
                      r"tp_seq_bwd_persist_x<RT, (\d+), (\d+)>;", src)
    assert rows
    for u, r, mt, nt in rows:
        assert (int(r) // 16, int(u) // 8) == (int(mt), int(nt))
    return {(int(u), int(r)) for u, r, _, _ in rows}


def test_backward_constants_match_the_kernel_source():
    src = open(PERSIST_CU).read()
    get = lambda name: re.search(rf"constexpr int {name} = ([^;]*);", src).group(1)
    assert int(get("kXThreads")) == ts.X_THREADS
    assert get("kXWarps") == "kXThreads / 32" and ts.X_WARPS == ts.X_THREADS // 32
    assert get("kXKC") == "16 * kXWarps" and ts.X_KC == 16 * ts.X_WARPS
    assert int(get("kXPad")) == ts.X_PAD
    assert int(get("kXRingRows")) == ts.X_RING_ROWS
    assert int(get("kGMax")) == ts.GATE_ELEMS
    assert _kernel_table() == {(u, r) for u in ts.X_UNITS for r in ts.X_ROWS
                               if u * r <= ts.X_TILE}
    # each ring stage a whole number of the rows
    assert all(ts.X_RING_ROWS % r == 0 and ts.X_RING_ROWS // r >= 3 for r in ts.X_ROWS)
    assert math.gcd(ts.X_KC, 16) == 16
