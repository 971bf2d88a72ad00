"""K6, K3 and K12 under fp32 compute: the persistent CUDA-core design's plan
(``ops/cuda_cell_bwd.py:k6_f32_plan``) and its shared-memory mirror, the
launches the card paths make, the kernel source's rules, and the design's
sum order.

Under fp32 compute (TF32 stays off, so CUDA cores) K6, K3 and K12 take one
cooperative launch a window through ``lstm_bwd_f32_launch``
(``csrc/lstm_bwd_f32.cu``), then the CUDA-core tail through
``lstm_bwd_tail_launch``: groups of G blocks own 16 hidden units each and
split the 4N gate columns G ways, each block holding the group's 16 rows of
U over its columns in shared memory, its columns of dg_{t+1} streamed
through a ring each step, the product split 8 ways over the block's k
(split s takes the k with (k mod 32) / 4 = s at every batch) and the
partials added in split order, the G parts of each sum exchanged and added
in part order, dh0 the launch's last product. G is 4 where that grid is
resident (N = 512: 128 blocks), else 2 (N = 1024: K10's pairs). The
per-step design keeps B > 128, grids that are not resident (N = 2048) and
N not a multiple of 32. The device numbers are an H100 SXM's (132 SMs,
232,448 bytes of shared memory a block may opt in to). The routing is
checked without a card: tensors on ``meta``, ``Tensor.data_ptr`` giving
each storage an address of its own, a stand-in library recording the
calls. The order is replayed in torch (each multiply-add rounded once to
fp32 from fp64, as a fused multiply-add rounds it) and held against the
JAX ``_bwd_kernel`` (through ``pallas_scan_layer``'s VJP) and
``_bwd_embed_fused_kernel`` (through ``pallas_embed_layer0``'s) in
interpret mode, at the fp32 gradient tolerances of
tests/test_pallas_cell.py:60-87 (rtol 2e-4, atol 1e-6).
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops import pallas_cell as jpc
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cell as cell_ops
from eigen_lstm_tpu_torch.ops import cuda_cell_bwd as cb

import test_torch_fp32_fwd_plan as fwd_plan
import test_torch_fp32_tiled_plan as tiled_plan

SMS, SMEM = 132, 232_448
M = 256


def _cfg(dtype="float32", n=512, residual="float32", **kw):
    return ModelConfig(vocab=M, hidden=n, compute_dtype=dtype,
                       residual_dtype=residual, loss_mode="all", **kw)


# --- the plan -------------------------------------------------------------


@pytest.mark.parametrize("b,n,want", [
    (128, 512, (4, 8, 3)),     # the bench, and layer 1 of a 2x512 model
    (64, 512, (4, 4, 5)),      # the documented unroll-2 run
    (32, 512, (4, 2, 6)),      # a chunk of 32 rows (SP, 4 chunks)
    (16, 512, (4, 1, 6)),
    (128, 1024, (2, 8, 3)),    # the flagship's shapes: K10's pairs
    (128, 640, (2, 8, 3)),     # the resident family's widest: 160 blocks at G = 4
    (128, 384, (4, 8, 3)),
    (8, 128, (4, 1, 6)),
    (128, 96, (2, 8, 3)),      # 4N / 4 = 96 columns: not whole ring slots
    (100, 1056, (2, 8, 2)),    # 132 blocks: three slots do not fit
])
def test_plan_takes_the_persistent_design(b, n, want):
    """fp32 with B <= 128: G, the first of (4, 2) whose grid of N / 16
    groups of G blocks is resident and whose blocks' 4N / G columns are
    whole 64-column slots; the product rows a thread takes (1, 2, 4, 8 for
    B <= 16, 32, 64, 128); the first ring of F32_RINGS that fits."""
    plan = cb.k6_f32_plan(_cfg(n=n), b, n, SMS, SMEM)
    assert tuple(plan) == want
    assert n // cb.F32_UNITS * plan.blocks <= SMS
    assert (4 * n // plan.blocks) % cb.F32_KC == 0
    assert cb.f32_smem_bytes(b, n, plan.blocks, plan.stages) <= SMEM
    assert plan.stages in cb.F32_RINGS[plan.rows]


@pytest.mark.parametrize("n", [128, 256, 384, 512, 640, 1024])
def test_one_group_width_at_every_batch(n):
    """G depends on N and the card alone: every batch of 1..128 takes the
    same G, so a row's sum has one order whether it is summed with 8, 32
    or 128 rows (SP's chunks and the whole batch agree)."""
    blocks = {cb.k6_f32_plan(_cfg(n=n), b, n, SMS, SMEM).blocks
              for b in range(1, 129)}
    assert len(blocks) == 1


@pytest.mark.parametrize("dtype,b,n,sms,smem", [
    ("bfloat16", 128, 512, SMS, SMEM),     # bf16: k6_plan's design
    ("bfloat16", 128, 1024, SMS, SMEM),
    ("float32", 128, 2048, SMS, SMEM),     # 256 blocks on 132 SMs
    ("float32", 129, 512, SMS, SMEM),      # past 8 product rows a thread
    ("float32", 256, 1024, SMS, SMEM),
    ("float32", 0, 512, SMS, SMEM),
    ("float32", 128, 1000, SMS, SMEM),     # N not a multiple of 32
    ("float32", 128, 1040, SMS, SMEM),
    ("float32", 128, 1024, 127, SMEM),     # 128 blocks on 127 SMs
    ("float32", 128, 1024, SMS, 150_000),  # U's rows and too small a ring
    ("float32", 128, 512, SMS, 40_000),
])
def test_plan_refuses(dtype, b, n, sms, smem):
    """None: the per-step design keeps these (and bf16 has its own
    plan)."""
    assert cb.k6_f32_plan(_cfg(dtype, n=n), b, n, sms, smem) is None


def test_bf16_plan_is_unchanged_and_refuses_fp32():
    """``k6_plan`` stays the bf16 plan: fp32 gets None from it, and the
    bf16 layouts of tests/test_torch_k3_plan.py hold."""
    assert cb.k6_plan(_cfg("float32"), 128, 512, SMS, SMEM) is None
    assert cb.k6_plan(_cfg("bfloat16", residual="bfloat16"), 128, 512, SMS,
                      SMEM) == (16, 32)


def test_n_2048_is_refused_not_streamed():
    """At N = 2048 the grid of 128 groups is not resident on 132 SMs at G =
    2 or 4, and a block's U rows at G = 2 (256 KB) would not fit either: the
    plan refuses rather than stream U (9b's 2x2048 fp32 window keeps the
    per-step design); a card with twice the SMs still refuses it for its
    shared memory, one with more shared memory takes it."""
    cfg = _cfg(n=2048)
    assert cb.k6_f32_plan(cfg, 128, 2048, SMS, SMEM) is None
    assert cb.k6_f32_plan(cfg, 128, 2048, 264, SMEM) is None
    assert cb.f32_smem_bytes(128, 2048, 2, 2) > SMEM
    assert cb.k6_f32_plan(cfg, 128, 2048, 264, 1 << 20) == (2, 8, 3)


def test_shared_memory_mirror_arithmetic():
    """The group's 16 rows of U over 4N / G columns (fp32), then the larger
    of the ring (stages x 16 RR rows x 64 floats) and the splits' partial
    sums (8 x 16 RR rows x 20 floats)."""
    for b, rr in ((1, 1), (16, 1), (17, 2), (32, 2), (33, 4), (64, 4),
                  (65, 8), (128, 8)):
        assert cb.f32_rows_per_thread(b) == rr
        for n in (256, 512, 1024, 1056):
            for blocks in (2, 4):
                for st in (2, 3, 5, 6):
                    rows = 16 * rr
                    want = 4 * (4 * n // blocks * 16
                                + max(st * rows * 64, 8 * rows * 20))
                    assert cb.f32_smem_bytes(b, n, blocks, st) == want
    assert cb.f32_smem_bytes(128, 1024, 2, 3) == 131072 + 98304
    assert cb.f32_smem_bytes(128, 512, 4, 3) == 32768 + 98304
    assert cb.f32_smem_bytes(128, 1056, 2, 3) > SMEM
    assert cb.f32_smem_bytes(128, 1056, 2, 2) == 135168 + 81920


def test_device_plan_takes_the_cards_limits(monkeypatch):
    monkeypatch.setattr(cb, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for b in (16, 64, 128):
        for n in (512, 1024):
            assert cb.device_k6_f32_plan(_cfg(n=n), b, n) == \
                cb.k6_f32_plan(_cfg(n=n), b, n, SMS, SMEM)


# --- the routing -----------------------------------------------------------


class _Library:
    """Stands in for the kernels' library: records each call, returns 0
    (one scratch float for the work-size queries)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 1 if name.endswith("_work_floats") else 0
        return call


@pytest.fixture
def routed(monkeypatch):
    """The wrappers' card path with no card: tensors on ``meta`` with an
    address for each storage, the H100's limits, the stand-in library."""
    lib = _Library()
    storages, seen = {}, {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        addr = (storages.setdefault(key, len(storages) + 1) << 32) + \
            t.storage_offset() * t.element_size()
        seen[addr] = t
        return addr

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(cb, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(cuda_cell, "_kernel_types", lambda cfg, dev: (
        cuda_cell._TYPE_CODES[cfg.cdtype], cuda_cell._TYPE_CODES[cfg.rdtype]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr, seen


_e = fwd_plan._e


def _args(cfg, s, b, ids=True):
    n, rd = cfg.hidden, cfg.rdtype
    head = (_e(n, 4 * n), _e(s, b, 4 * n, dtype=rd), _e(s, b, n, dtype=rd),
            _e(s, b, n, dtype=rd))
    ids = (_e(s, b, dtype=torch.int32),) if ids else ()
    return head + ids + (_e(b, n), _e(b, n), _e(s, b, n), _e(b, n), _e(b, n), cfg)


def _check_reverse(a, seen, ptr, cfg, s, b, plan, steps, dropout):
    """lstm_bwd_f32_launch's arguments: (rtype, U, g_seq, c_seq, c0,
    c_last, dh_seq, dhT, dc, dg, xbuf, dh0, S, B, N, groups, stages, steps,
    standard, drop_on, seed, keep, inv, stream, launched), c_last null
    (c_{S-1} from the stream). Returns the fp32 dg's address."""
    n = cfg.hidden
    assert a[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
    U = seen[a[1]]
    assert U.dtype == torch.float32 and tuple(U.shape) == (n, 4 * n)  # no U^T
    for i, shape in ((2, (s, b, 4 * n)), (3, (s, b, n))):
        assert seen[a[i]].dtype == cfg.rdtype and tuple(seen[a[i]].shape) == shape
    assert a[5] is None
    for i, shape in ((4, (b, n)), (6, (s, b, n)), (7, (b, n)), (8, (b, n)),
                     (9, (s, b, 4 * n)), (10, (plan.blocks * b * n,)), (11, (b, n))):
        assert seen[a[i]].dtype == torch.float32
        assert tuple(seen[a[i]].shape) == shape, i
    assert a[12:20] == (s, b, n, plan.blocks, plan.stages, steps, 0,
                        int(dropout is not None))
    assert a[20:23] == (cuda_cell.drop_scalars(dropout) or (0, 0, 0.0))
    return a[9]


@pytest.mark.parametrize("unroll2", [False, True], ids=["K3", "K12"])
@pytest.mark.parametrize("b,n", [(128, 512), (64, 512), (128, 1024)])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -4242)])
def test_k3_and_k12_launch_the_fp32_design(routed, unroll2, b, n, residual,
                                           dropout):
    """fp32: the work query, one ``lstm_bwd_f32_launch`` with the plan's
    layout (K12: steps 2), then one ``lstm_bwd_tail_launch`` over the same
    fp32 dg: h_seq, the ids, h_{-1}, dWU and db, the vocabulary's M rows;
    nothing else."""
    lib, ptr, seen = routed
    s = 4
    cfg = _cfg(n=n, residual=residual)
    wrapper = (cb.embed_layer0_bwd_unroll2 if unroll2 else cb.embed_layer0_bwd)
    dWU, db, dh0, dc0 = wrapper(*_args(cfg, s, b), dropout=dropout,
                                fused_accum=True)
    assert [c[0] for c in lib.calls] == ["lstm_bwd_embed_work_floats",
                                         "lstm_bwd_f32_launch",
                                         "lstm_bwd_tail_launch"]
    plan = cb.k6_f32_plan(cfg, b, n, SMS, SMEM)
    rev, tail = lib.calls[1][1], lib.calls[2][1]
    dg = _check_reverse(rev, seen, ptr, cfg, s, b, plan, 2 if unroll2 else 1,
                        dropout)
    assert rev[8] == ptr(dc0) and rev[11] == ptr(dh0)
    # (rtype, h_seq, ids, h0, dg, out, db, work, S, B, N, M, round_db,
    #  stream, launched)
    assert tail[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
    assert seen[tail[2]].dtype == torch.int32 and tuple(seen[tail[2]].shape) == (s, b)
    assert tail[4] == dg and tail[5] == ptr(dWU) and tail[6] == ptr(db)
    assert tail[8:13] == (s, b, n, M, 0)


@pytest.mark.parametrize("b,n", [(128, 512), (32, 512), (128, 1024)])
@pytest.mark.parametrize("dropout", [None, (0.35, 99)])
def test_k6_launches_the_fp32_design(routed, b, n, dropout):
    """fp32: one ``lstm_bwd_f32_launch`` with the plan's layout, then one
    ``lstm_bwd_tail_launch`` for dU alone (no ids, M 0) over the same fp32
    dg, which the wrapper hands back as dg_seq (the xw type is fp32);
    ``dg_out`` is that buffer."""
    lib, ptr, seen = routed
    s = 3
    cfg = _cfg(n=n)
    args = _args(cfg, s, b, ids=False)
    dg_out = _e(s, b, 4 * n)
    dg, dU, dh0, dc0 = cb.scan_layer_bwd(*args, dg_out=dg_out, dropout=dropout)
    assert [c[0] for c in lib.calls] == ["lstm_bwd_scan_work_floats",
                                         "lstm_bwd_f32_launch",
                                         "lstm_bwd_tail_launch"]
    plan = cb.k6_f32_plan(cfg, b, n, SMS, SMEM)
    rev, tail = lib.calls[1][1], lib.calls[2][1]
    assert _check_reverse(rev, seen, ptr, cfg, s, b, plan, 1, dropout) == ptr(dg)
    assert dg is dg_out and dg.dtype == torch.float32
    assert tail[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
    assert tail[2] is None and tail[6] is None
    assert tail[4] == ptr(dg) and tail[5] == ptr(dU)
    assert tail[8:13] == (s, b, n, 0, 0)


@pytest.mark.parametrize("b,n", [(129, 512), (128, 2048)])
def test_k6_refused_shapes_keep_the_per_step_launcher(routed, b, n):
    """B > 128 and N = 2048: ``lstm_bwd_scan_launch`` with U^T, chosen from
    the shape; no persistent launch."""
    lib, ptr, seen = routed
    cfg = _cfg(n=n)
    cb.scan_layer_bwd(*_args(cfg, 3, b, ids=False))
    assert [c[0] for c in lib.calls] == ["lstm_bwd_scan_work_floats",
                                         "lstm_bwd_scan_launch"]
    assert tuple(seen[lib.calls[1][1][2]].shape) == (4 * n, n)


def test_per_step_control_forces_both_plans_off(routed, monkeypatch):
    """With both device plans None (as chip_smoke.py's ``per_step_k6``
    forces them for its timed controls) the fp32 wrappers launch the
    per-step design at shapes the fp32 plan takes."""
    lib = routed[0]
    monkeypatch.setattr(cb, "device_k6_plan", lambda *a: None)
    monkeypatch.setattr(cb, "device_k6_f32_plan", lambda *a: None)
    cfg = _cfg()
    cb.embed_layer0_bwd(*_args(cfg, 4, 128), fused_accum=True)
    cb.scan_layer_bwd(*_args(cfg, 4, 128, ids=False))
    assert [c[0] for c in lib.calls] == [
        "lstm_bwd_embed_work_floats", "lstm_bwd_embed_launch",
        "lstm_bwd_scan_work_floats", "lstm_bwd_scan_launch"]


# --- the kernel source -------------------------------------------------------


def test_kernel_reads_dg_through_l2_only_and_barriers_unguarded():
    """lstm_bwd_f32_persist: dg and xbuf (the groups' parts), which the
    launch's blocks write and read, are neither const nor __restrict__; dg
    is read only through the product's ring (f32_rec_splits: ``cp.async.cg``,
    L2 only) and the parts through ``__ldcg`` after ``__stcg``, never
    through ``__ldg``; U is read in place (the group's row, the block's
    columns: f32_load_u_rows); the grid barriers sit under no branch (the
    product's block barriers sit in ``rec``, called under the branch on t
    alone, the same in every thread); c_{S-1} comes from c_last where it is
    given (K16's cT), else from the stream."""
    src = fwd_plan._source("lstm_bwd_f32.cuh")
    params, body = fwd_plan._kernel(src, "lstm_bwd_f32_persist(const float* __restrict__ U")
    assert re.search(r"\n\s*float\* dg, float\* xbuf,", params)
    assert "const float* __restrict__ c_last," in params
    code = fwd_plan._strip_comments(body)
    assert "__ldg" not in code and "__ldca" not in code
    assert "f32_rec_splits<RR, STAGES>(dg + (size_t)tn * bk + (size_t)part * KG, Us, ring," in code
    _, splits = fwd_plan._kernel(src, "f32_rec_splits(const float* dgn,")
    scode = fwd_plan._strip_comments(splits)
    assert "__ldg" not in scode and len(re.findall(r"\bdgn\b", scode)) == 2
    assert re.search(r"cp_async_16\(st \+ r \* kFKC \+ 4 \* \(p \^ \(r % 8\)\),\s*"
                     r"in \? dgn \+ ", scode)
    assert re.search(r"\bdg\[gb \+", code)              # the one store
    assert len(re.findall(r"\bdg\b", code)) == 2
    _, load = fwd_plan._kernel(src, "f32_load_u_rows(const float* __restrict__ U,")
    assert "U[(size_t)(p0 + uu) * K + (size_t)part * KG + k]" in load
    assert "f32_load_u_rows(U, Us, K, KG, p0, part);" in code
    assert len(re.findall(r"\bxbuf\b", code)) == 2
    assert "__stcg(xbuf + ((size_t)part * B + b) * N + p0 + uu, v);" in code
    assert "__ldcg(xbuf + ((size_t)o * B + b) * N + j)" in code
    assert code.count("grid.sync()") == 3
    assert fwd_plan._barriers_under_conditions(body) == []
    assert fwd_plan._barriers_under_conditions(splits) == []
    assert "if (t < S - 1) rec(t + 1, mine);" in code
    assert re.search(r"cin\[p\]\[i\] = t == S - 1 && c_last != nullptr \? c_last\[idx\]\s*"
                     r": to_f32\(c_seq\[t \* bn \+ idx\]\);", code)


def test_parts_meet_in_part_order():
    """Each (b, j) adds the G parts in part order, the block's own from its
    registers: ((P_0 + P_1) + P_2) + P_3, the splits of each part added in
    split order first (f32_split_sum, which K16's D-rank design shares)."""
    src = fwd_plan._source("lstm_bwd_f32.cuh")
    _, body = fwd_plan._kernel(src, "lstm_bwd_f32_persist(const float* __restrict__ U")
    code = fwd_plan._strip_comments(body)
    assert "for (int o = 0; o < G; ++o) {" in code
    assert "v = o == 0 ? x : v + x;" in code
    assert "const float v = f32_split_sum<RR>(ring, b, uu);" in code
    _, split_sum = fwd_plan._kernel(src, "f32_split_sum(const float* red, int b, int uu)")
    assert "for (int s = 1; s < kFSplit; ++s) v += rb[(size_t)s * rows * kFRedPitch + uu];" \
        in split_sum


def test_constants_and_layouts_match_the_plan():
    src = fwd_plan._source("lstm_bwd_f32.cuh")
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kFUnits"), const("kFThreads"), const("kFSplit"), const("kFKC"),
            const("kFRedPitch"), const("kFMaxRows")) == \
        (cb.F32_UNITS, cb.F32_THREADS, cb.F32_SPLIT, cb.F32_KC,
         cb.F32_RED_PITCH, cb.F32_ROWS)
    layouts = re.search(r"#define BWD_F32_LAYOUTS\(X\)(.*?)\n", src).group(1)
    built = {(int(r), int(st)) for r, st in re.findall(r"X\((\d+), (\d+)\)", layouts)}
    planned = {(r, st) for r, rings in cb.F32_RINGS.items() for st in rings}
    assert built == planned
    for name in ("lstm_bwd_f32_launch", "lstm_bwd_f32_smem_bytes",
                 "lstm_bwd_tail_launch"):
        assert name in _build.SIGNATURES
    # G a template parameter: the plan's G = 4 built in lstm_bwd_f32.cu, its
    # G = 2 in lstm_bwd_f32_pairs.cu
    assert sorted(cb.F32_BLOCKS) == [2, 4]
    assert "template <typename RT, int RR, int STAGES, int kSteps, int G>" in src
    assert "launch_groups<4>(" in fwd_plan._source("lstm_bwd_f32.cu")
    assert "launch_groups<2>(" in fwd_plan._source("lstm_bwd_f32_pairs.cu")


# --- the sum order ------------------------------------------------------------


def f32_order_dh_rec(dg, U, blocks):
    """dh_rec = dg @ U^T in the fp32 persistent design's order: each of
    the ``blocks`` parts of the gate axis (4N / G columns: a block of the
    group) summed apart, split s of 8 summing the part's k with (k mod 32)
    / 4 = s in ascending k, each step one multiply-add rounded once to fp32
    (the product exact in fp64), the 8 partials added in split order; then
    the parts added in part order. dg (B, 4N) and U (N, 4N) fp32."""
    split, period = cb.F32_SPLIT, 4 * cb.F32_SPLIT
    b, k = dg.shape
    n, kg = U.shape[0], k // blocks
    out = None
    for p in range(blocks):
        cols = slice(p * kg, (p + 1) * kg)
        d = dg[:, cols].double().reshape(b, kg // period, split, 4)
        u = U[:, cols].double().reshape(n, kg // period, split, 4)
        acc = torch.zeros(split, b, n, dtype=torch.float32)
        for c in range(kg // period):
            for v in range(4):
                prod = d[:, c, :, v].T[:, :, None] * u[:, c, :, v].T[:, None, :]
                acc = (prod + acc.double()).float()
        part = acc[0]
        for s in range(1, split):
            part = part + acc[s]
        out = part if out is None else out + part
    return out


def f32_replay(U, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg, blocks, dropout=None):
    """The fp32 persistent design's reverse steps with
    ``f32_order_dh_rec``: (dg_seq, dh0, dc0)."""
    n = cfg.hidden
    dh_rec, dc = dhT, dcT
    dgs = [None] * g_seq.shape[0]
    for t in reversed(range(g_seq.shape[0])):
        c_prev = c_seq[t - 1] if t > 0 else c0
        cot = dh_seq[t].float()
        dh_cot = cuda_cell.apply_keep(cot, dropout, t, torch.float32) if dropout else cot
        dgs[t], dc = cell_ops.gate_bwd(g_seq[t].float(), c_seq[t].float(),
                                       c_prev.float(), dh_cot + dh_rec, dc, n,
                                       cfg.cell_variant)
        dh_rec = f32_order_dh_rec(dgs[t], U, blocks)
    return torch.stack(dgs), dh_rec, dc


def _mats(b, n, seed):
    rng = np.random.default_rng(seed)
    dg = torch.from_numpy(rng.standard_normal((b, 4 * n)).astype(np.float32))
    U = torch.from_numpy((rng.standard_normal((n, 4 * n)) * 0.25).astype(np.float32))
    return dg, U


@pytest.mark.parametrize("blocks", [4, 2])
def test_order_gives_one_set_of_bits_at_every_batch(blocks):
    """The order of each (b, j)'s sum is a function of k and G alone: the
    replay on 128 rows at once, in chunks of 32 (SP's four) and of 8 rows
    gives the same bits; the plain product differs from it only by the
    order."""
    dg, U = _mats(128, 64, 26)
    whole = f32_order_dh_rec(dg, U, blocks)
    for rows in (32, 8):
        parts = torch.cat([f32_order_dh_rec(dg[r:r + rows], U, blocks)
                           for r in range(0, 128, rows)])
        assert torch.equal(parts, whole), rows
    torch.testing.assert_close(whole, dg @ U.T, rtol=1e-5, atol=1e-5)


def test_two_blocks_a_group_is_k10s_order():
    """At G = 2 (N = 1024 on an H100) the design sums K10's fp32 persistent
    order (tests/test_torch_fp32_tiled_plan.py): (i, o half) + (f, u half),
    each half in split order, so the two kernels give one set of bits."""
    dg, U = _mats(32, 64, 27)
    assert torch.equal(f32_order_dh_rec(dg, U, 2),
                       tiled_plan.split_order_dh_rec(dg, U))


def _inputs(s, b, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: (rng.standard_normal(shape) * sd).astype(np.float32)
    return dict(W=f(M, 4 * n, sd=0.3), Ws=f(n, 4 * n, sd=0.3 / n ** 0.5),
                U=f(n, 4 * n, sd=2.0 / n ** 0.5), b=f(4 * n, sd=0.3),
                ids=rng.integers(0, M, (s, b)).astype(np.int32),
                xw=f(s, b, 4 * n), h0=f(b, n, sd=0.5), c0=f(b, n, sd=0.5),
                dh=f(s, b, n, sd=0.1), dhT=f(b, n, sd=0.1), dcT=f(b, n, sd=0.1))


S, B, N, SEED = 5, 16, 128, -1234567


def _drops(drop):
    return ((drop, jnp.asarray([SEED], jnp.int32)) if drop else None,
            (drop, SEED) if drop else None)


@pytest.mark.parametrize("drop", [0.0, 0.35])
def test_k6_order_matches_the_jax_kernel(drop):
    """K6's fp32 reverse steps in the design's order (G = 4 at N = 128),
    from the port's forward residuals, and dU over their dg, against the
    JAX VJP of ``pallas_scan_layer`` (``_bwd_kernel`` in interpret mode) on
    the same numpy inputs: dU, dg (the gradient of xw), dh0, dc0."""
    x = _inputs(S, B, N, 8)
    jdrop, tdrop = _drops(drop)
    jcfg, cfg = JConfig(hidden=N), _cfg(n=N)
    blocks = cb.k6_f32_plan(cfg, B, N, SMS, SMEM).blocks
    assert blocks == 4

    def f(U, xw, h0, c0):
        return jpc.pallas_scan_layer(
            jmodel.LayerParams(jnp.asarray(x["Ws"]), U, jnp.asarray(x["b"])),
            xw, h0, c0, jcfg, dropout=jdrop)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x["U"], x["xw"], x["h0"], x["c0"])))
    want = vjp((jnp.asarray(x["dh"]), (jnp.asarray(x["dhT"]), jnp.asarray(x["dcT"]))))

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    layer = LayerParams(t["Ws"], t["U"], t["b"])
    h_seq, _, c_seq, g_seq = cuda_cell.scan_layer(layer, t["xw"], t["h0"], t["c0"],
                                                  cfg, residuals=True,
                                                  dropout=tdrop)[:4]
    dg, dh0, dc0 = f32_replay(t["U"], g_seq, c_seq, t["c0"], t["dh"], t["dhT"],
                              t["dcT"], cfg, blocks, tdrop)
    h_prev = torch.cat([t["h0"][None], h_seq[:-1]]).reshape(S * B, N)
    dU = h_prev.T @ dg.reshape(S * B, 4 * N)
    for got, w, what in zip((dU, dg, dh0, dc0), want, ("dU", "dg", "dh0", "dc0")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-6, err_msg=what)


@pytest.mark.parametrize("drop", [0.0, 0.35])
def test_k3_order_matches_the_jax_kernel(drop):
    """K3's fp32 reverse steps in the design's order, then dW (the one-hot
    sum), dU and db (the fused VJP's: the fp32 dg) over their dg, against
    the JAX VJP of ``pallas_embed_layer0`` (``_bwd_embed_fused_kernel`` in
    interpret mode) on the same numpy inputs: dW, dU, db, dh0, dc0."""
    x = _inputs(S, B, N, 9)
    jdrop, tdrop = _drops(drop)
    jcfg, cfg = JConfig(vocab=M, hidden=N), _cfg(n=N)
    blocks = cb.k6_f32_plan(cfg, B, N, SMS, SMEM).blocks

    def f(W, U, b_, h0, c0):
        return jpc.pallas_embed_layer0(jmodel.LayerParams(W, U, b_),
                                       jnp.asarray(x["ids"]), h0, c0, jcfg,
                                       dropout=jdrop)

    jpc._make_fused_embed_seq.cache_clear()
    try:
        _, vjp = jax.vjp(f, *map(jnp.asarray, (x["W"], x["U"], x["b"], x["h0"],
                                               x["c0"])))
        want = vjp((jnp.asarray(x["dh"]), (jnp.asarray(x["dhT"]),
                                           jnp.asarray(x["dcT"]))))
    finally:
        jpc._make_fused_embed_seq.cache_clear()

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    layer = LayerParams(t["W"], t["U"], t["b"])
    h_seq, _, c_seq, g_seq = cuda_cell.embed_layer0(layer, t["ids"], t["h0"],
                                                    t["c0"], cfg, residuals=True,
                                                    dropout=tdrop)[:4]
    dg, dh0, dc0 = f32_replay(t["U"], g_seq, c_seq, t["c0"], t["dh"], t["dhT"],
                              t["dcT"], cfg, blocks, tdrop)
    flat = dg.reshape(S * B, 4 * N)
    h_prev = torch.cat([t["h0"][None], h_seq[:-1]]).reshape(S * B, N)
    dW = torch.zeros(M, 4 * N).index_add_(0, t["ids"].reshape(-1).long(), flat)
    got = (dW, h_prev.T @ flat, flat.sum(0), dh0, dc0)
    for g, w, what in zip(got, want, ("dW", "dU", "db", "dh0", "dc0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-6, err_msg=what)
