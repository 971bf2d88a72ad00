"""K15 and K16 under fp32 compute in their persistent CUDA-core designs, at
D = 1 and at D ranks, on the CPU, where no kernel runs.

At D = 1 K15 is K9's fp32 persistent kernel in K15's mode
(``csrc/lstm_tiled_f32.cuh``, ``tp_seq_fwd_f32_launch``) with the batch
split over block rows where N / 8 blocks would leave SMs idle
(``cuda_cell_tiled.split_fwd_f32_plan``), and K16 is K6's fp32 persistent
reverse launch with c_last = cT (tests/test_torch_tp_seq_plan.py). At D
ranks K15 runs the same window with exchange.cuh's RankStep
(``csrc/lstm_tp_f32.cu``; ``cuda_tp_seq.ranks_fwd_f32_plan``) and K16 K6's
fp32 reverse step with the reduce-scatter inside
(``csrc/lstm_tp_f32_bwd.cu``; ``ranks_bwd_f32_plan``: N / 16 unit groups
of G blocks over the rank's 4nd gate columns, G from the SMs a rank has
on one card).

Here: the plans with an H100 SXM's numbers (132 SMs, 232,448 bytes of
shared memory a block) at the bench's (B 128, N 512; D 1, 2, 4) and the
flagship's layer (N 1024; D 1, 2) shapes and where they refuse; the
shared-memory mirrors and the exchange layout's room for the G parts; the
card paths through a stand-in library (tensors on ``meta``); the kernel
sources' rules (reads through L2, the exchange's slots and flags,
barriers under no branch) and their C signatures; and a float32 replay of
each new sum order (the forward's k split, the backward's k split, part
order and rank order): one set of bits at 8, 32 and 128 rows and at every
D for the forward, and within rtol 1e-5 (values) and rtol 2e-4 / atol
1e-6 (gradients, tests/test_pallas_cell.py's fp32 tolerances) of the JAX
``tp_seq_lstm`` at D = 1 and, on the virtual CPU mesh, at D = 2, its
kernels in interpret mode.
"""

import ctypes
import functools
import operator
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.ops import pallas_tp_seq as jseq

import test_torch_fp32_bwd_plan as bwd_plan
import test_torch_fp32_fwd_plan as fwd_plan
from test_torch_tp_seq_exchange import (F32, GRAD, _arr, _inputs, _jax_ranks,
                                        _kernel_exchanges, _meta, routed)  # noqa: F401
from test_torch_tp_seq_persist_x import _persist_exchanges, _section
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.ops import _build
from eigen_lstm_tpu_torch.ops import cell as cell_ops
from eigen_lstm_tpu_torch.ops import cuda_cell_bwd as cb
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts
from eigen_lstm_tpu_torch.parallel.tp import _gate_permutation

SMS, SMEM = 132, 232_448
CSRC = fwd_plan.CSRC
SHAPES = [(128, 512, 2), (128, 512, 4), (128, 1024, 2)]   # bench D = 2, 4; flagship


def _cfg(n, dtype="float32", residual="float32", **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual, **kw)


# --- the plans -----------------------------------------------------------------


@pytest.mark.parametrize("b,n,want", [
    (128, 512, (64, 2, 64, 4)),     # the bench: 64 x 2 blocks of 64 rows
    (64, 512, (32, 1, 128, 4)),
    (100, 512, (50, 2, 64, 4)),
    (128, 1024, (128, 4, 64, 2)),   # the flagship's width: K9's layout, unsplit
    (128, 256, (32, 1, 128, 4)),    # 32 x 4 blocks
    (128, 96, (32, 1, 32, 3)),      # N not a multiple of 64: 32-column slots
])
def test_k15_d1_plan_splits_the_batch_where_sms_idle(b, n, want):
    """fp32 at D = 1: K9's kernel in K15's mode, the batch over block rows
    where N / 8 blocks would not reach half the SMs, the grid resident at
    one block an SM, the slice of U and a ring in a block's shared
    memory."""
    split = ct.split_fwd_f32_plan(_cfg(n), b, n, SMS, SMEM)
    assert tuple(split) == want
    assert n // 8 * -(-b // split.rows) <= SMS
    assert split.per == ct.f32_rows_per_thread(split.rows)
    assert ct.f32_persist_smem_bytes(split.rows, n, split.kc, split.stages) <= SMEM
    unsplit = ct.split_fwd_f32_plan(_cfg(n), b, n, SMS, SMEM, split=False)
    assert unsplit.rows == b
    assert tuple(unsplit)[1:] == tuple(ct.tiled_fwd_f32_plan(_cfg(n), b, n, SMS, SMEM))


@pytest.mark.parametrize("dtype,b,n,sms,smem", [
    ("bfloat16", 128, 512, SMS, SMEM),   # bf16: split_fwd_plan's design
    ("float32", 129, 512, SMS, SMEM),    # past 4 rows a thread
    ("float32", 128, 2048, SMS, SMEM),   # 256 blocks on 132 SMs
    ("float32", 128, 1000, SMS, SMEM),   # N not a multiple of 32
    ("float32", 128, 1024, 127, SMEM),   # 128 blocks on 127 SMs
    ("float32", 128, 1024, SMS, 100_000),
])
def test_k15_d1_plan_refuses(dtype, b, n, sms, smem):
    assert ct.split_fwd_f32_plan(_cfg(n, dtype), b, n, sms, smem) is None


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_ranks_forward_plan(b, n, d):
    """D groups on one card (132 // D SMs each) and a group on a card of
    its own: nd / 8 column blocks over the batch's block rows, every grid
    resident; the bench's D = 2 and 4 take the D = 1 layout (2 block rows
    of 64), the flagship's layer at D = 2 every row in a block."""
    cfg = _cfg(n)
    nd = n // d
    for sms in (SMS // d, SMS):
        split = ts.ranks_fwd_f32_plan(cfg, b, n, d, sms, SMEM)
        assert nd // 8 * -(-b // split.rows) <= sms
        assert ct.f32_persist_smem_bytes(split.rows, n, split.kc, split.stages) <= SMEM
    one_card = ts.ranks_fwd_f32_plan(cfg, b, n, d, SMS // d, SMEM)
    assert tuple(one_card) == ((128, 4, 64, 2) if n == 1024 else (64, 2, 64, 4))


@pytest.mark.parametrize("b,n,d,want", [(128, 512, 2, (2, 8, 3)),
                                        (128, 512, 4, (1, 8, 3)),
                                        (128, 1024, 2, (1, 8, 3)),
                                        (32, 512, 2, (2, 2, 6)),
                                        (128, 256, 2, (4, 8, 3))])
def test_ranks_backward_plan(b, n, d, want):
    """G: the first of 4, 2, 1 whose N / 16 x G blocks fit the SMs one
    rank group has on one card, with whole ring slots and at most 4
    gate-backward elements a thread; the flagship's layer at D = 2 takes
    G = 1 (U_r's 16 rows over all 2048 gate columns, 128 KB, beside a
    ring of 3 slots)."""
    plan = ts.ranks_bwd_f32_plan(_cfg(n), b, n, d, SMS // d, SMEM)
    assert tuple(plan) == want
    g, nd = plan.blocks, n // d
    blocks = n // 16 * g
    assert d * blocks <= SMS
    assert (4 * nd // g) % cb.F32_KC == 0
    assert b * nd <= blocks * cb.F32_THREADS * ts.F32_GATE_ELEMS
    assert cb.f32_smem_bytes(b, nd, g, plan.stages) <= SMEM


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_ranks_backward_g_is_the_one_cards_on_d_cards(b, n, d, monkeypatch):
    """The device plan takes the SMs a rank group has on one card whether
    the rank shares the card or not, so a rank on a card of its own sums
    in the one-card launch's order; its other layouts (rows a thread, ring)
    depend on the batch and width alone."""
    monkeypatch.setattr(ts, "_card_limits", lambda: (SMS, SMEM))
    cfg = _cfg(n)
    one = ts.device_ranks_bwd_plan(cfg, b, n, d, one_card=True)
    own = ts.device_ranks_bwd_plan(cfg, b, n, d, one_card=False)
    assert one == own == ts.ranks_bwd_f32_plan(cfg, b, n, d, SMS // d, SMEM)
    assert ts.device_ranks_fwd_plan(cfg, b, n, d, one_card=True) == \
        ts.ranks_fwd_f32_plan(cfg, b, n, d, SMS // d, SMEM)
    assert ts.device_ranks_fwd_plan(cfg, b, n, d, one_card=False) == \
        ts.ranks_fwd_f32_plan(cfg, b, n, d, SMS, SMEM)


@pytest.mark.parametrize("plan", ["fwd", "bwd"])
@pytest.mark.parametrize("args", [
    ("bfloat16", 128, 512, 2, SMS, SMEM),    # bf16: ranks_*_plan's designs
    ("float32", 128, 512, 1, SMS, SMEM),     # D = 1 takes the D = 1 designs
    ("float32", 129, 512, 2, SMS, SMEM),     # past 128 batch rows
    ("float32", 128, 2048, 2, 66, SMEM),     # groups that are not resident
    ("float32", 128, 1024, 2, 63, SMEM),
    ("float32", 128, 1024, 2, 66, 120_000),  # U's rows and a ring do not fit
])
def test_ranks_plans_refuse(plan, args):
    dtype, b, n, d, sms, smem = args
    fn = ts.ranks_fwd_f32_plan if plan == "fwd" else ts.ranks_bwd_f32_plan
    assert fn(_cfg(n, dtype), b, n, d, sms, smem) is None


# --- the shared-memory mirrors and the exchange layout -------------------------


def test_shared_memory_mirrors():
    """The forward's block of `rows` batch rows: its N x 32 slice of U, then
    the larger of the ring (32 R rows of KC + 4 floats a slot) and the
    splits' partials; the D-rank backward's block: U_r's 16 rows over 4nd /
    G columns, then the larger of the ring (16 RR rows of 64 floats a
    slot) and the splits' partials; both the layouts the C side computes
    (``lstm_tiled_f32.cuh:f32_persist_smem_bytes`` at 32 R rows,
    ``lstm_bwd_f32.cuh:f32_smem_bytes`` at the shard's width)."""
    for rows, per in ((2, 1), (32, 1), (50, 2), (64, 2), (65, 4), (128, 4)):
        assert ct.f32_rows_per_thread(rows) == per
        for n, kc, st in ((512, 64, 4), (1024, 64, 2), (512, 128, 4), (96, 32, 3)):
            want = 4 * (n * 32 + max(st * 32 * per * (kc + 4), 4 * 32 * per * 32))
            assert ct.f32_persist_smem_bytes(rows, n, kc, st) == want
    assert cb.f32_smem_bytes(128, 512, 1, 3) == 4 * (2048 * 16 + 3 * 128 * 64)
    assert cb.f32_smem_bytes(128, 256, 2, 3) == 4 * (512 * 16 + 3 * 128 * 64)
    launcher = _section(_source("lstm_tp_f32.cu"), "int run_fwd_f32_ranks(", "}  // namespace")
    assert "f32_persist_smem_bytes(kPRowGroups * R, N, KC, STAGES)" in launcher
    bwd = _section(_source("lstm_tp_f32_bwd.cu"), "int run_bwd_f32_ranks(", "}  // namespace")
    assert "f32_smem_bytes(B, nd, G, STAGES)" in bwd


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_exchange_layout_holds_the_parts(b, n, d):
    """Under fp32 compute a rank's chunks hold MAX_PARTS parts of every
    sender (slot, sender, part, B, nd), the kernel's furthest chunk within
    the buffer; under bf16 one part."""
    nd, bn = n // d, b * n // d
    f32, bf = ts.exchange_layout(b, n, d, 4), ts.exchange_layout(b, n, d, 2)
    assert f32.nbytes >= f32.r_off + 4 * ts.SLOTS * d * ts.MAX_PARTS * bn
    assert bf.nbytes >= bf.r_off + 4 * ts.SLOTS * d * bn
    assert bf.nbytes < bf.r_off + 4 * ts.SLOTS * d * 2 * bn
    g = max(ts.F32_GROUPS)
    last = (((ts.SLOTS - 1) * d + d - 1) * g + g - 1) * bn + bn
    assert f32.r_off + 4 * last <= f32.nbytes
    assert nd * d == n


# --- the card paths ---------------------------------------------------------------


def _one_card_inputs(d, s, b, n):
    nd = n // d
    return ([_meta(n, 4 * nd) for _ in range(d)], [_meta(s, b, 4 * nd) for _ in range(d)],
            _meta(b, n), [_meta(b, nd) for _ in range(d)])


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2, 4])
def test_one_card_launches_the_fp32_designs(routed, d, residual):
    """fp32 at the bench's shapes: one ``tp_seq_fwd_f32_ranks_launch`` (D
    groups, each the plan's rows, the ring of the plan, U_r as given, h0
    in fp32, the D buffers at the layout's h offset) and one
    ``tp_seq_bwd_f32_ranks_launch`` (the plan's G, rows a thread and ring,
    U_r untransposed, the fp32 dg the output), one launch each."""
    lib, ptr = routed
    lib.limits = (SMS, SMEM)
    s, b, n = 4, 128, 512
    nd = n // d
    cfg = _cfg(n, residual=residual)
    U, xw, h0, c0 = _one_card_inputs(d, s, b, n)
    ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
    before = (ts.tp_seq_fwd_ranks.launches, ts.tp_seq_bwd_ranks.launches)
    out = ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg, ex)
    (name, f), = lib.calls
    split = ts.ranks_fwd_f32_plan(cfg, b, n, d, SMS // d, SMEM)
    assert name == "tp_seq_fwd_f32_ranks_launch"
    # (rtype, groups, ranks, rows, per, kc, stages, U, xw, h0, c, hseq, gseq,
    #  cprev, hT, D, bufs, h_off, base, S, B, N, nd, standard, stream, launched)
    assert f[:2] == (int(residual == "bfloat16"), d) and _arr(f[2], d) == list(range(d))
    assert _arr(f[3], d) == [split.rows] * d and f[4:7] == tuple(split)[1:]
    assert _arr(f[7], d) == [ptr(u) for u in U]
    assert len(set(_arr(f[9], d))) == 1
    for col, k in ((10, 4), (11, 0), (12, 1), (13, 2), (14, 3)):
        assert _arr(f[col], d) == [ptr(o[k]) for o in out]
    assert all(o[0].dtype == o[3].dtype == o[4].dtype == torch.float32 for o in out)
    assert all(o[1].dtype == o[2].dtype == cfg.rdtype for o in out)
    assert f[15] == d and _arr(f[16], d) == ex.ptrs
    assert f[17:24] == (ex.layout.h_off, 0, s, b, n, nd, 0)
    lib.calls.clear()
    plan = ts.ranks_bwd_f32_plan(cfg, b, n, d, SMS // d, SMEM)
    dh, z = [_meta(s, b, nd) for _ in range(d)], [_meta(b, nd) for _ in range(d)]
    res = ts.tp_seq_bwd_ranks(U, [o[1] for o in out], [o[2] for o in out],
                              [o[4] for o in out], dh, z, z, cfg, ex)
    (name, bw), = lib.calls
    assert name == "tp_seq_bwd_f32_ranks_launch"
    # (rtype, groups, ranks, G, rows a thread, stages, U, gseq, cprev, cT,
    #  dhseq, dhT, dc, dg, dh0, D, bufs, r_off, base, S, B, N, nd, standard,
    #  stream, launched)
    assert bw[:2] == (int(residual == "bfloat16"), d) and bw[3:6] == tuple(plan)
    assert _arr(bw[6], d) == [ptr(u) for u in U]                # U untransposed
    assert _arr(bw[7], d) == [ptr(o[1]) for o in out]
    for col, k in ((12, 2), (13, 0), (14, 1)):                  # dc, dg, dh0
        assert _arr(bw[col], d) == [ptr(r[k]) for r in res]
    assert all(r[0].dtype == torch.float32 and tuple(r[0].shape) == (s, b, 4 * nd)
               for r in res)
    assert bw[15] == d and _arr(bw[16], d) == ex.ptrs
    assert bw[17:24] == (ex.layout.r_off, 0, s, b, n, nd, 0)
    assert (ts.tp_seq_fwd_ranks.launches, ts.tp_seq_bwd_ranks.launches) == (
        before[0] + 1, before[1] + 1)
    assert ex.steps == {"fwd": s, "bwd": s}


def test_one_card_takes_a_lagging_fp32_group(routed):
    """A layout a group: rank 0's forward with every row in one block row
    (fewer blocks, so it lags), the others the plan's; the ring is the one
    with the most rows a thread, for every group; the backward's groups
    take one layout."""
    lib, _ = routed
    lib.limits = (SMS, SMEM)
    s, b, n, d = 3, 128, 512, 2
    cfg = _cfg(n)
    U, xw, h0, c0 = _one_card_inputs(d, s, b, n)
    ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
    plan = ts.device_ranks_fwd_plan(cfg, b, n, d, True)
    lag = ct.f32_split_layout(b, n, n // d // 8, SMS // d, SMEM, rows=b)
    assert lag.rows == b and lag.per > plan.per
    ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg, ex, layouts=[lag, plan])
    (_, f), = lib.calls
    assert _arr(f[3], d) == [b, plan.rows] and f[4:7] == tuple(lag)[1:]
    bplan = ts.device_ranks_bwd_plan(cfg, b, n, d, True)
    with pytest.raises(ValueError, match="one layout"):
        ts.tp_seq_bwd_ranks(U, [_meta(s, b, 4 * n // d)] * d, [_meta(s, b, n // d)] * d,
                            [_meta(b, n // d)] * d, [_meta(s, b, n // d)] * d,
                            [_meta(b, n // d)] * d, [_meta(b, n // d)] * d, cfg, ex,
                            layouts=[bplan, cb.F32Plan(1, bplan.rows, bplan.stages)])


# --- the kernel sources ---------------------------------------------------------


def _source(name):
    return fwd_plan._source(name)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 7])
def test_fp32_kernels_keep_the_slot_and_flag_rules(s):
    """Step for step the fp32 forward (the window's sync over RankStep) and
    backward read, write and flag the slots the cooperative kernels do."""
    bsrc = _section(_source("lstm_tp_f32_bwd.cu"), "tp_seq_bwd_f32_x(const",
                    "template <typename RT, int RR, int STAGES>\nint run_bwd_f32_ranks(")
    fwd_p, bwd_p = _persist_exchanges(os.path.join(CSRC, "lstm_tiled_f32.cuh"), bsrc)
    fwd_x, bwd_x, h0 = _kernel_exchanges()
    for base in (0, 1, 2, 10, 2 ** 32 - 2):
        assert fwd_p(base, s) == fwd_x(base, s)
        assert fwd_p(base, s)[0][0] == h0(base)
        assert bwd_p(base, s) == bwd_x(base, s)


def test_forward_runs_the_window_in_k15s_mode_over_rank_steps():
    """tp_seq_fwd_f32_x is f32_fwd_window in K15's mode (TP true, no EMBED)
    over RankStep<float> on the forward's barrier word, the gate stride the
    shard's nd, its rows the group's; the D = 1 launcher the grid kernel in
    the same mode; the window stores c_prev before the update and h_seq in
    fp32 under K15's mode, and hands h only to the Step."""
    src = _source("lstm_tp_f32.cu")
    _, body = fwd_plan._kernel(src, "tp_seq_fwd_f32_x(const __grid_constant__")
    code = fwd_plan._strip_comments(body)
    assert "const RankStep<float> step{" in code
    assert "words(peers.buf[G.rank], kFwdBar)" in code
    assert "f32_fwd_window<RT, false, true, R, KC, STAGES>(" in code
    assert "S, B, N, nd, (bi % cols) * kPUnits," in code and "G.rows, standard);" in code
    assert "sync" not in code and "__syncthreads" not in code
    assert "run_fwd_f32<float, false, true, r, k, st>" in src
    window = fwd_plan._kernel(_source("lstm_tiled_f32.cuh"), "f32_fwd_window(const Step& step,")[1]
    wcode = fwd_plan._strip_comments(window)
    store = wcode.index("if (TP && cseq != nullptr) cseq[ts + idx] = from_f32<RT>(cr[i]);")
    assert store < wcode.index("cell(gate, cr[i], standard, &h, &cc);")
    assert "step.put(t, b, j, h);" in wcode and "hseq[ts + idx] = from_f32<HT>(h);" in wcode
    assert "typename HT = typename std::conditional<TP, float, RT>::type" in \
        _source("lstm_tiled_f32.cuh")


def test_backward_reads_through_l2_and_keeps_barriers_unguarded():
    """tp_seq_bwd_f32_x: the rank's dg, written and read within the launch,
    is read only through the shared product (f32_rec_splits' cp.async.cg),
    the peers' chunks through ``__ldcg``, nothing through ``__ldg``; each
    part goes to chunk [ws][me][part] of its owner; each rank sums a
    sender's G parts in part order and the senders in rank order; one rank
    barrier a reverse step and under no branch, the exchange under none
    but the uniform one on t; block barriers only in the shared
    product."""
    src = _source("lstm_tp_f32_bwd.cu")
    params, body = fwd_plan._kernel(src, "tp_seq_bwd_f32_x(const __grid_constant__")
    code = fwd_plan._strip_comments(body)
    assert "__ldg" not in code and "__ldca" not in code
    assert "f32_rec_splits<RR, STAGES>(dg + (size_t)tn * bk + (size_t)part * KG, Us, ring, B," \
        in code
    assert "float* dg = A.dg;" in code and "float* dg;" in _section(
        src, "struct F32BwdGroup {", "};")
    assert "(((size_t)ws * D + me) * G + part) * bn;" in code
    assert "(size_t)ws * D * G * bn;" in code
    assert "const float* sent = chunks + (size_t)r * G * bn + idx;" in code
    assert "float x = __ldcg(sent);" in code
    assert "for (int p = 1; p < G; ++p) x += __ldcg(sent + (size_t)p * bn);" in code
    assert "v = r == 0 ? x : v + x;" in code
    assert code.count("rank_barrier(bar, nb);") == 1
    assert code.count("exchange(peers, me, D, kBwdFlag, bar, nb,") == 2
    assert fwd_plan._barriers_under_conditions(body) == []
    assert not re.search(r"if \([^)]*\)\s*rank_barrier", code)
    # the barrier closes the loop's body, unconditionally
    loop = code[code.index("for (int t = S - 1; t >= 0; --t) {"):]
    assert re.search(r"rank_barrier\(bar, nb\);\s*\}\s*const unsigned long long e = "
                     r"base \+ \(S - 1\);", loop)


def test_backward_constants_match_the_plan():
    src = _source("lstm_tp_f32_bwd.cu")
    assert int(re.search(r"constexpr int kGMax = (\d+);", src).group(1)) == \
        ts.F32_GATE_ELEMS
    assert int(re.search(r"constexpr int kMaxParts = (\d+);",
                         _source("exchange.cuh")).group(1)) == ts.MAX_PARTS
    assert "(G != 1 && G != 2 && G != kMaxParts)" in src
    assert sorted(ts.F32_GROUPS) == [1, 2, ts.MAX_PARTS]
    assert "BWD_F32_LAYOUTS(BWD_F32_CASE)" in src
    assert "F32_LAYOUTS(F32_CASE)" in _source("lstm_tp_f32.cu")
    assert "RR != f32_rows_per_thread(B)" in src
    assert "(size_t)B * nd > (size_t)N / kFUnits * G * kFThreads * kGMax" in src


_C_TYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
            "int": ctypes.c_int, "int*": ctypes.POINTER(ctypes.c_int),
            "const int*": ctypes.POINTER(ctypes.c_int),
            "void* const*": ctypes.POINTER(ctypes.c_void_p),
            "const void* const*": ctypes.POINTER(ctypes.c_void_p),
            "long long": ctypes.c_longlong, "unsigned long long": ctypes.c_ulonglong,
            "unsigned": ctypes.c_uint, "float": ctypes.c_float}


@pytest.mark.parametrize("name,source", [
    ("tp_seq_fwd_f32_launch", "lstm_tp_f32.cu"),
    ("tp_seq_fwd_f32_ranks_launch", "lstm_tp_f32.cu"),
    ("tp_seq_bwd_f32_ranks_launch", "lstm_tp_f32_bwd.cu"),
    ("lstm_bwd_f32_launch", "lstm_bwd_f32.cu"),
])
def test_signatures_match_the_source(name, source):
    """``_build.SIGNATURES`` gives the entry points this design adds or
    widens (``lstm_bwd_f32_launch``'s c_last) the argument types their
    sources declare, in order."""
    decl = re.search(r'extern "C" \w+ ' + name + r"\(([^)]*)\)", _source(source))
    params = [re.sub(r"\s+", " ", a).strip() for a in decl.group(1).split(",")]
    types_ = [_C_TYPES[re.sub(r"\s*\w+$", "", a).replace(" *", "*")] for a in params]
    assert _build.SIGNATURES[name][1] == types_


# --- the sum orders ----------------------------------------------------------------


def f32_order_gates(h, U):
    """h @ U in the fp32 persistent forward's order: split s of 4 summing
    the k with (k mod 32) / 8 = s in ascending k, each step one multiply-add
    rounded once to fp32 (the product exact in fp64), the 4 partials added
    in split order. h (B, N), U (N, C) fp32, N a multiple of 32."""
    b, n = h.shape
    hh = h.double().reshape(b, n // 32, 4, 8)
    uu = U.double().reshape(n // 32, 4, 8, U.shape[1])
    acc = torch.zeros(4, b, U.shape[1], dtype=torch.float32)
    for c in range(n // 32):
        for v in range(8):
            prod = hh[:, c, :, v].T[:, :, None] * uu[c, :, v, :][:, None, :]
            acc = (prod + acc.double()).float()
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]


def f32_fwd_replay(U_cs, xws, h0_full, c0s, cfg):
    """K15's fp32 persistent window at D = len(U_cs) ranks (D = 1 the
    window itself): each rank's step from the full h_{t-1} (the ranks' h_t
    side by side) with ``f32_order_gates``, the gates and the cell as the
    plain version computes them. A list of D (h_seq, g, c_prev, hT, cT)."""
    d, nd = len(U_cs), c0s[0].shape[-1]
    h, cs = h0_full.float(), [c.float() for c in c0s]
    seqs = [([], [], []) for _ in range(d)]
    for t in range(xws[0].shape[0]):
        hs = []
        for r in range(d):
            g = cell_ops.gate_activations(xws[r][t].float() + f32_order_gates(h, U_cs[r]), nd)
            h2, c2 = cell_ops.cell_update(g, cs[r], nd, cfg.cell_variant)
            for seq, x in zip(seqs[r], (h2, g.to(cfg.rdtype), cs[r].to(cfg.rdtype))):
                seq.append(x)
            hs.append(h2)
            cs[r] = c2
        h = torch.cat(hs, 1)
    return [(*(torch.stack(x) for x in seqs[r]), hs[r], cs[r]) for r in range(d)]


def f32_ranks_bwd_replay(U_cs, g_seqs, c_prevs, cTs, dh_seqs, dhTs, dcTs, cfg, blocks):
    """K16's fp32 persistent window at D = len(U_cs) ranks: each rank's
    gate backward from dh_seq[t] + dh_rec, then its parts of dg_t @ U_r^T
    over all N columns in the fp32 persistent order at G = ``blocks``
    (tests/test_torch_fp32_bwd_plan.py:f32_order_dh_rec: the split order,
    then the parts in part order), and each rank's columns summed over
    the senders in rank order. A list of D (dg, dh0, dc0)."""
    d, s, nd = len(U_cs), g_seqs[0].shape[0], c_prevs[0].shape[-1]
    dcs, recs = [x.float() for x in dcTs], [x.float() for x in dhTs]
    dgs = [[None] * s for _ in range(d)]
    for t in reversed(range(s)):
        sent = []
        for r in range(d):
            c2 = cTs[r] if t == s - 1 else c_prevs[r][t + 1]
            dgs[r][t], dcs[r] = cell_ops.gate_bwd(
                g_seqs[r][t].float(), c2.float(), c_prevs[r][t].float(),
                dh_seqs[r][t].float() + recs[r], dcs[r], nd, cfg.cell_variant)
            sent.append(bwd_plan.f32_order_dh_rec(dgs[r][t], U_cs[r], blocks))
        recs = [functools.reduce(operator.add, [p[:, r * nd:(r + 1) * nd] for p in sent])
                for r in range(d)]
    return [(torch.stack(dgs[r]), recs[r], dcs[r]) for r in range(d)]


def _mats(b, n, c, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((n, c)) / n ** 0.5).astype(np.float32)))


def test_forward_order_gives_one_set_of_bits_at_every_batch_and_width():
    """A unit's sum depends on k alone: 128 rows at once, in chunks of 32 and
    of 8 rows, and any subset of U's columns (a rank's shard) give the same
    bits; the plain product differs only by the order."""
    h, U = _mats(128, 64, 96, 31)
    whole = f32_order_gates(h, U)
    for rows in (32, 8):
        parts = torch.cat([f32_order_gates(h[r:r + rows], U) for r in range(0, 128, rows)])
        assert torch.equal(parts, whole), rows
    cols = torch.tensor([5, 17, 40, 41, 90])
    assert torch.equal(f32_order_gates(h, U[:, cols]), whole[:, cols])
    torch.testing.assert_close(whole, h @ U, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blocks", [1, 2])
def test_ranks_backward_order_gives_one_set_of_bits_at_every_batch(blocks):
    """The D-rank backward's dh_rec for each row depends on that row alone:
    128 rows at once and in chunks of 32 and of 8 give the same bits."""
    rng = np.random.default_rng(40 + blocks)
    d, n, b = 2, 64, 128
    nd = n // d
    dgs = [torch.from_numpy(rng.standard_normal((b, 4 * nd)).astype(np.float32))
           for _ in range(d)]
    Us = [torch.from_numpy((rng.standard_normal((n, 4 * nd)) * 0.2).astype(np.float32))
          for _ in range(d)]

    def rec(rows):
        sent = [bwd_plan.f32_order_dh_rec(g[rows], U, blocks) for g, U in zip(dgs, Us)]
        return [functools.reduce(operator.add, [p[:, r * nd:(r + 1) * nd] for p in sent])
                for r in range(d)]

    whole = rec(slice(0, b))
    for step in (32, 8):
        chunks = [rec(slice(r, r + step)) for r in range(0, b, step)]
        for r in range(d):
            assert torch.equal(torch.cat([c[r] for c in chunks]), whole[r])
    plain = sum(g @ U.T for g, U in zip(dgs, Us))
    torch.testing.assert_close(torch.cat(whole, 1), plain, rtol=1e-5, atol=1e-5)


def test_ranks_forward_order_is_the_d1_order():
    """On the TP gate permutation's shards, every step's gate sums of the
    D-rank forward (from the full h_{t-1} of the window) are the D = 1
    window's sums bit for bit, at D = 2 and 4: what phase 15 holds the
    kernels' D-rank windows to on the card (the gates and the cell are the
    kernel's per-element code at every D; torch's vectorised CPU
    elementwise functions may round the last bit by a tensor's width, so
    the replay compares the order's part)."""
    x = _inputs(1, 12)
    cfg = _cfg(32)
    t = {k: torch.from_numpy(v[0]) for k, v in x.items()}
    one, = f32_fwd_replay([t["U"]], [t["xw"]], t["h0"], [t["c0"]], cfg)
    h_prev = torch.cat([t["h0"][None], one[0][:-1]])
    for d in (2, 4):
        nd = 32 // d
        perm = torch.as_tensor(_gate_permutation(32, d))
        U_p = t["U"][:, perm]
        for h in h_prev:
            whole = f32_order_gates(h, t["U"])[:, perm]
            ranks = torch.cat([f32_order_gates(h, U_p[:, r * 4 * nd:(r + 1) * 4 * nd])
                               for r in range(d)], 1)
            assert torch.equal(ranks, whole), d


def _jax_d1(x, jcfg):
    t = [jnp.asarray(x[k][0]) for k in ("U", "xw", "h0", "c0")]
    out, vjp = jax.vjp(lambda *a: jseq.tp_seq_lstm(*a, jcfg, "model", 1), *t)
    grads = vjp((jnp.asarray(x["dh"][0]), (jnp.asarray(x["dhT"][0]),
                                          jnp.asarray(x["dcT"][0]))))
    return [[np.asarray(a) for a in (out[0], *out[1], *grads)]]


@pytest.mark.parametrize("d", [1, 2])
def test_replays_match_the_jax_kernels(d):
    """The fp32 persistent designs' orders (the forward's, and the backward
    at G = 2 and 1: the bench's D = 2 and the flagship's) from numpy
    inputs against the JAX ``tp_seq_lstm`` and its VJP (D = 1: one device;
    D = 2: the virtual CPU mesh's model axis), the kernels in interpret
    mode: h_seq, hT, cT at rtol 1e-5; dU (``window_dU`` over the replay's
    dg), dxw = dg, dh0, dc0 at rtol 2e-4 / atol 1e-6."""
    x = _inputs(d, 300 + d)
    cfg, jcfg = _cfg(32), JConfig(hidden=32)
    want = _jax_d1(x, jcfg) if d == 1 else _jax_ranks(x, jcfg, d)
    t = {k: [torch.from_numpy(a) for a in v] for k, v in x.items()}
    h0_full = torch.cat(t["h0"], 1)
    fwd = f32_fwd_replay(t["U"], t["xw"], h0_full, t["c0"], cfg)
    h_all = torch.cat([o[0] for o in fwd], 2)
    for blocks in (2, 1):
        bwd = f32_ranks_bwd_replay(t["U"], [o[1] for o in fwd], [o[2] for o in fwd],
                                   [o[4] for o in fwd], t["dh"], t["dhT"], t["dcT"], cfg,
                                   blocks)
        for r in range(d):
            dU = ts.window_dU(h0_full, h_all, bwd[r][0], cfg)
            got = (fwd[r][0], fwd[r][3], fwd[r][4], dU, *bwd[r])
            for i, name in enumerate(("h_seq", "hT", "cT", "dU", "dxw", "dh0", "dc0")):
                np.testing.assert_allclose(got[i].double().numpy(), want[r][i],
                                           **(F32 if i < 3 else GRAD),
                                           err_msg=f"rank {r} G={blocks} {name}")
