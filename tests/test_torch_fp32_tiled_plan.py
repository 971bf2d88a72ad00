"""K9 and K10 under fp32 compute: K9's route through the fp32 persistent
forward (``ops/cuda_cell_tiled.py:tiled_fwd_f32_plan``, K8's design with
the xw stream), K10's persistent CUDA-core design's plan
(``tiled_bwd_f32_plan``, K6's ``cuda_cell_bwd.k6_f32_plan`` in pairs of
blocks) and its shared-memory mirror, the launches the card paths make,
the kernel source's rules, and K10's sum order.

Under fp32 compute (TF32 stays off, so CUDA cores) K9 takes one
cooperative launch a window through ``tiled_fwd_scan_f32_launch``, and K10
one through K6's ``lstm_bwd_f32_launch`` (csrc/lstm_bwd_f32.cu) at groups
of 2 blocks: N / 8 blocks in pairs, a pair owning
16 hidden units and each of its blocks half the 4N gate columns, holding
the pair's 16 rows of U over its half in shared memory, its half of
dg_{t+1} streamed through a ring each step, the product split 8 ways over
the half's k (split s takes the k with (k mod 32) / 4 = s at every batch)
and the partials added in split order, the pair's two halves swapped and
added, dh0 its last product. The per-step designs keep B > 128, grids that
are not resident (N = 2048) and N not a multiple of 32. The device numbers
are an H100 SXM's (132 SMs, 232,448 bytes of shared memory a block may opt
in to). The routing is checked without a card: tensors on ``meta``,
``Tensor.data_ptr`` giving each storage an address of its own, a stand-in
library recording the calls. K10's order is replayed in torch (each
multiply-add rounded once to fp32 from fp64, as a fused multiply-add
rounds it) and held against the JAX ``_bwd_tiled_kernel`` in interpret
mode through the VJP of ``pallas_tiled_scan_layer``, at the float32
tolerances of tests/test_pallas_cell.py:60-87 (rtol 1e-5 / atol 1e-6).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_cell_tiled import pallas_tiled_scan_layer
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cell as cell_ops
from eigen_lstm_tpu_torch.ops import cuda_cell_bwd as cb
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

import test_torch_fp32_fwd_plan as fwd_plan
from test_torch_fp32_fwd_plan import routed  # noqa: F401  (the fixture)

SMS, SMEM = 132, 232_448


def _cfg(dtype="float32", n=1024, residual="float32", **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual,
                       **kw)


# --- the plans ------------------------------------------------------------


@pytest.mark.parametrize("b,n,fwd,bwd", [
    (128, 1024, (4, 64, 2), (2, 8, 3)),    # the flagship's fp32 training window
    (16, 1024, (1, 128, 4), (2, 1, 6)),    # the flagship's eval batch
    (32, 1024, (1, 128, 4), (2, 2, 6)),    # a chunk of 32 rows (SP, 4 chunks)
    (64, 1024, (2, 64, 4), (2, 4, 5)),
    (100, 1056, (4, 32, 3), (2, 8, 2)),    # 132 blocks: three slots do not fit
])
def test_plans_take_the_persistent_designs(b, n, fwd, bwd):
    """fp32 with B <= 128 and N / 8 blocks resident: K9's layout is K8's
    (``tiled_fwd_f32_plan``), K10's the product rows a thread takes (1, 2,
    4, 8 for B <= 16, 32, 64, 128) and the first ring of K6's F32_RINGS
    that fits beside U's rows, in pairs of blocks."""
    cfg = _cfg(n=n)
    assert tuple(ct.tiled_fwd_f32_plan(cfg, b, n, SMS, SMEM)) == fwd
    layout = ct.tiled_bwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert tuple(layout) == bwd
    assert cb.f32_smem_bytes(b, n, 2, layout.stages) <= SMEM
    assert n // cb.F32_UNITS * 2 <= SMS
    assert layout.stages in cb.F32_RINGS[layout.rows]


@pytest.mark.parametrize("dtype,b,n,sms,smem", [
    ("bfloat16", 128, 1024, SMS, SMEM),    # bf16: tiled_bwd_plan's designs
    ("bfloat16", 128, 2048, SMS, SMEM),
    ("float32", 129, 1024, SMS, SMEM),     # past 8 product rows a thread
    ("float32", 256, 1024, SMS, SMEM),
    ("float32", 128, 2048, SMS, SMEM),     # 256 blocks on 132 SMs
    ("float32", 128, 1000, SMS, SMEM),     # N not a multiple of 32
    ("float32", 128, 1040, SMS, SMEM),     # 130 blocks, N a multiple of 16
    ("float32", 128, 1024, 127, SMEM),     # 128 blocks on 127 SMs
    ("float32", 128, 1024, SMS, 190_000),  # U's rows and too small a ring
])
def test_k10_plan_refuses(dtype, b, n, sms, smem):
    """None: the per-step design keeps these (and bf16 has its own
    plan)."""
    assert ct.tiled_bwd_f32_plan(_cfg(dtype, n=n), b, n, sms, smem) is None


def test_n_2048_is_refused_not_streamed():
    """At N = 2048 neither grid of 256 blocks is resident on 132 SMs, and
    U's rows (256 KB a block) would not fit either: both plans refuse
    rather than stream U; a card with twice the SMs still refuses them for
    their shared memory."""
    cfg = _cfg(n=2048)
    for plan in (ct.tiled_fwd_f32_plan, ct.tiled_bwd_f32_plan):
        assert plan(cfg, 128, 2048, SMS, SMEM) is None
        assert plan(cfg, 128, 2048, 264, SMEM) is None
    assert cb.f32_smem_bytes(128, 2048, 2, 2) > SMEM
    assert ct.tiled_bwd_f32_plan(cfg, 128, 2048, 264, 1 << 20) == (2, 8, 3)


def test_k10_shared_memory_mirror_arithmetic():
    """K6's fp32 design in pairs: the pair's 16 rows of U over 2N columns
    (fp32), then the larger of the ring (stages x 16 RR rows x 64 floats)
    and the splits' partial sums (8 x 16 RR rows of 20 floats)."""
    for b, rr in ((1, 1), (16, 1), (17, 2), (32, 2), (33, 4), (64, 4),
                  (65, 8), (128, 8)):
        assert cb.f32_rows_per_thread(b) == rr
        for n in (256, 512, 1024, 1056):
            for st in (2, 3, 5, 6):
                rows = 16 * rr
                want = 4 * (2 * n * 16 + max(st * rows * 64, 8 * rows * 20))
                assert cb.f32_smem_bytes(b, n, 2, st) == want
    assert cb.f32_smem_bytes(128, 1024, 2, 3) == 131072 + 98304
    assert cb.f32_smem_bytes(128, 1056, 2, 3) > SMEM
    assert cb.f32_smem_bytes(128, 1056, 2, 2) == 135168 + 81920


def test_device_plans_take_the_cards_limits(monkeypatch):
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for b in (16, 32, 128):
        assert ct.device_tiled_bwd_f32_plan(_cfg(), b, 1024) == \
            ct.tiled_bwd_f32_plan(_cfg(), b, 1024, SMS, SMEM)


# --- the routing -----------------------------------------------------------


_e = fwd_plan._e
_layer = fwd_plan._layer


@pytest.mark.parametrize("b", [128, 16, 32])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -1234567)])
def test_k9_fp32_launches_the_persistent_design(routed, b, residual, dropout):
    """fp32 at the flagship's, the eval and the SP chunk's batches: one
    call of ``tiled_fwd_scan_f32_launch`` and nothing else, one launch
    counted, U and the xw stream in fp32, hc (2, B, N) fp32, the outputs'
    buffers in the residual type, every batch row in a block, the plan's
    ring, the dropout's scalars."""
    lib, ptr, seen = routed
    s, n = 4, 1024
    cfg = _cfg(residual=residual)
    layer, xw = _layer(n), _e(s, b, 4 * n)
    before = ct.launches()
    out = ct.tiled_scan_layer(layer, xw, _e(b, n), _e(b, n), cfg,
                              residuals=True, dropout=dropout)
    assert ct.launches() == (before[0], before[1] + 1, before[2])
    assert [c[0] for c in lib.calls] == ["tiled_fwd_scan_f32_launch"]
    a = lib.calls[0][1]
    # (rtype, U, xw, hc, c, hT, hseq, cseq, gseq, hdrop, S, B, N, standard,
    #  rows, kc, stages, seed, keep, inv, stream, launched)
    rd = ct.types(cfg)[1]
    assert a[0] == cuda_cell._TYPE_CODES[rd]
    for i, shape in ((1, (n, 4 * n)), (2, (s, b, 4 * n))):
        assert seen[a[i]].dtype == torch.float32 and tuple(seen[a[i]].shape) == shape
    hc = seen[a[3]]
    assert hc.dtype == torch.float32 and tuple(hc.shape) == (2, b, n)
    h_seq, (hT, cT), c_seq, g_seq = out[:4]
    assert a[6:9] == (ptr(h_seq), ptr(c_seq), ptr(g_seq))
    assert h_seq.dtype == c_seq.dtype == g_seq.dtype == rd
    plan = ct.tiled_fwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert a[10:17] == (s, b, n, 0, b, plan.kc, plan.stages)   # every row a block
    assert (a[9] is None) == (dropout is None)
    assert a[17:20] == (cuda_cell.drop_scalars(dropout) or (0, 0, 0.0))


@pytest.mark.parametrize("dtype,b,n,want", [
    ("bfloat16", 128, 1024, (1024, 128)),   # the bf16 plan: tensor cores
    ("float32", 256, 1024, (-1, 256)),      # refused: the per-step design
    ("float32", 128, 2048, (-1, 128)),
])
def test_k9_elsewhere_keeps_tiled_fwd_scan_launch(routed, dtype, b, n, want):
    lib = routed[0]
    cfg = _cfg(dtype, n=n, residual="bfloat16" if dtype == "bfloat16" else "float32")
    ct.tiled_scan_layer(_layer(n), _e(3, b, 4 * n), _e(b, n), _e(b, n), cfg)
    assert [c[0] for c in lib.calls] == ["tiled_fwd_scan_launch"]
    assert lib.calls[0][1][15:17] == want


def test_scan_launch_refuses_a_mismatched_layout(routed):
    """The fp32 layout is the fp32 forward's alone: bf16 compute, or rows a
    thread that are not the batch's, raise before any launch."""
    lib = routed[0]
    b, n = 128, 1024
    args = (_layer(n), _e(3, b, 4 * n), _e(b, n), _e(b, n))
    for cfg, layout in ((_cfg("bfloat16", residual="bfloat16"), ct.F32Layout(4, 64, 2)),
                        (_cfg(), ct.F32Layout(2, 64, 4))):
        with pytest.raises(ValueError, match="fp32 layout"):
            ct.scan_launch(ct.tiled_scan_layer, *args, cfg, torch.float32,
                           layout, False, None)
    assert lib.calls == []


def _reverse_args(s, b, n, cfg):
    rd = ct.types(cfg)[1]
    return (_e(n, 4 * n), _e(s, b, 4 * n, dtype=rd), _e(s, b, n, dtype=rd),
            _e(b, n), _e(s, b, n), _e(b, n), _e(b, n))


@pytest.mark.parametrize("b", [128, 32])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -7654321)])
def test_k10_fp32_launches_the_persistent_design(routed, b, residual, dropout):
    """fp32 at the flagship's and the SP chunk's batches: one call of K6's
    ``lstm_bwd_f32_launch`` at groups of 2 blocks, steps 1, and nothing
    else, one launch counted, U (N, 4N) read in place (no U^T), the
    residual sequences in the residual type, dh_seq fp32, dg (S, B, 4N)
    fp32, the pairs' exchange buffer (2 x B x N fp32), dh0 handed to the
    kernel (its last product: no ``_mm`` after it), the plan's ring, the
    dropout's scalars; ``dg_out`` is refused."""
    lib, ptr, seen = routed
    s, n = 4, 1024
    cfg = _cfg(residual=residual)
    U, g, c, c0, dh, dhT, dcT = _reverse_args(s, b, n, cfg)
    dh0 = _e(b, n)
    before = ct.launches()
    dg, dc = ct.tiled_bwd(U, g, c, c0, dh, dhT, dcT, cfg, dropout=dropout,
                          dh0_out=dh0)
    assert ct.launches() == before[:2] + (before[2] + 1,)
    assert [c_[0] for c_ in lib.calls] == ["lstm_bwd_f32_launch"]
    a = lib.calls[0][1]
    # (rtype, U, g_seq, c_seq, c0, c_last, dh_seq, dhT, dc, dg, xbuf, dh0,
    #  S, B, N, groups, stages, steps, standard, drop_on, seed, keep, inv,
    #  stream, launched): c_last null, c_{S-1} from the stream
    rd = ct.types(cfg)[1]
    assert a[0] == cuda_cell._TYPE_CODES[rd]
    assert a[1] == ptr(U) and tuple(seen[a[1]].shape) == (n, 4 * n)
    for i, shape in ((2, (s, b, 4 * n)), (3, (s, b, n))):
        assert seen[a[i]].dtype == rd and tuple(seen[a[i]].shape) == shape
    assert a[5] is None
    assert seen[a[6]].dtype == torch.float32
    assert a[8] == ptr(dc) and a[9] == ptr(dg) and a[11] == ptr(dh0)
    assert seen[a[10]].dtype == torch.float32 and tuple(seen[a[10]].shape) == (2 * b * n,)
    assert dg.dtype == torch.float32 and tuple(dg.shape) == (s, b, 4 * n)
    layout = ct.tiled_bwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert a[12:19] == (s, b, n, 2, layout.stages, 1, 0)
    assert a[19:23] == ((int(dropout is not None),)
                        + (cuda_cell.drop_scalars(dropout) or (0, 0, 0.0)))
    with pytest.raises(ValueError, match="persistent design alone"):
        ct.tiled_bwd(U, g, c, c0, dh, dhT, dcT, cfg, dg_out=_e(s, b, 4 * n))


@pytest.mark.parametrize("dtype,b,n,rows", [
    ("bfloat16", 128, 2048, 64),   # the bf16 plan: tensor cores
    ("float32", 256, 1024, -1),    # refused: the per-step design, U^T
    ("float32", 128, 2048, -1),
])
def test_k10_elsewhere_keeps_tiled_bwd_launch(routed, dtype, b, n, rows):
    lib, ptr, seen = routed
    s = 3
    cfg = _cfg(dtype, n=n, residual="bfloat16" if dtype == "bfloat16" else "float32")
    args = _reverse_args(s, b, n, cfg)
    ct.tiled_bwd(*args, cfg)
    assert [c[0] for c in lib.calls] == ["tiled_bwd_launch"]
    a = lib.calls[0][1]
    assert a[16] == rows
    u_shape = (n, 4 * n) if rows >= 0 else (4 * n, n)
    assert tuple(seen[a[2]].shape) == u_shape


# --- the kernel source -------------------------------------------------------


def test_k10_kernel_reads_dg_through_l2_only_and_barriers_unguarded():
    """K10's fp32 design is K6's lstm_bwd_f32_persist (csrc/lstm_bwd_f32.cuh),
    and lstm_tiled_f32.cu holds no reverse kernel of its own: dg and xbuf
    (the pairs' exchange buffer), which the launch's blocks write and
    read, are neither const nor __restrict__; dg is read only through the
    ring's cp.async (``cp.async.cg``, L2 only) and the exchanged parts
    through ``__ldcg`` after ``__stcg``, never through ``__ldg``; U is read
    in place (the group's row, the block's columns); the grid barriers sit
    under no branch."""
    assert "_bwd_" not in fwd_plan._strip_comments(
        fwd_plan._source("lstm_tiled_f32.cu"))
    src = fwd_plan._source("lstm_bwd_f32.cuh")
    params, body = fwd_plan._kernel(src, "lstm_bwd_f32_persist(const float* __restrict__ U")
    assert re.search(r"\n\s*float\* dg, float\* xbuf,", params)
    code = fwd_plan._strip_comments(body)
    assert "__ldg" not in code and "__ldca" not in code
    # dg read through the shared product (f32_rec_splits' ring) and stored once
    assert "f32_rec_splits<RR, STAGES>(dg + " in code
    _, splits = fwd_plan._kernel(src, "f32_rec_splits(const float* dgn,")
    scode = fwd_plan._strip_comments(splits)
    assert "__ldg" not in scode and len(re.findall(r"\bdgn\b", scode)) == 2
    assert re.search(r"cp_async_16\(st \+ r \* kFKC \+ 4 \* \(p \^ \(r % 8\)\),\s*"
                     r"in \? dgn \+ ", scode)
    assert len(re.findall(r"\bdg\b", code)) == 2
    assert "f32_load_u_rows(U, Us, K, KG, p0, part);" in code
    assert "U[(size_t)(p0 + uu) * K + (size_t)part * KG + k]" in src
    assert "__stcg(xbuf + " in code and "__ldcg(xbuf + " in code
    assert fwd_plan._barriers_under_conditions(body) == []
    assert fwd_plan._barriers_under_conditions(splits) == []


def test_k9_shares_the_fp32_forward_and_reads_xw_a_step_ahead():
    """K9 is tiled_fwd_f32_persist without EMBED: its input term is xw_t's
    row, issued a step ahead as K8's W row is, and added as acc + xw (the
    window f32_fwd_window of csrc/lstm_tiled_f32.cuh, which K15 shares)."""
    _, body = fwd_plan._kernel(fwd_plan._source("lstm_tiled_f32.cuh"),
                               "f32_fwd_window(const Step& step,")
    code = fwd_plan._strip_comments(body)
    assert "xw_row(t + 1, i, nxt[i]);" in code
    assert "float s = sums[g] + pin[i][g];" in code
    assert "if constexpr (EMBED) s += bs[g];" in code


def test_k10_constants_and_layouts_match_the_plan():
    """K10's fp32 launch is K6's: its layouts are K6's plan's, and the
    library exports no launcher of K10's own under fp32 compute."""
    src = fwd_plan._source("lstm_bwd_f32.cuh")
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kFUnits"), const("kFThreads"), const("kFSplit"), const("kFKC")) == \
        (cb.F32_UNITS, cb.F32_THREADS, cb.F32_SPLIT, cb.F32_KC)
    layouts = re.search(r"#define BWD_F32_LAYOUTS\(X\)(.*?)\n", src).group(1)
    built = {(int(r), int(st)) for r, st in re.findall(r"X\((\d+), (\d+)\)", layouts)}
    planned = {(r, st) for r, rings in cb.F32_RINGS.items() for st in rings}
    assert built == planned
    assert "BWD_F32_LAYOUTS" not in fwd_plan._source("lstm_tiled_f32.cu")
    for name in ("tiled_fwd_scan_f32_launch", "lstm_bwd_f32_launch",
                 "lstm_bwd_f32_smem_bytes"):
        assert name in _build.SIGNATURES
    assert not any(name.startswith("tiled_bwd_f32") for name in _build.SIGNATURES)


# --- K10's sum order ----------------------------------------------------------


def split_order_dh_rec(dg, U):
    """dh_rec = dg @ U^T in the fp32 persistent K10's order: each half of
    the gate axis (its 2N columns: a block of the pair) summed apart, split
    s of 8 summing the half's k with (k mod 32) / 4 = s in ascending k,
    each step one multiply-add rounded once to fp32 (the product exact in
    fp64), the 8 partials added in split order; then the two halves added.
    dg (B, 4N) and U (N, 4N) fp32."""
    split, period = cb.F32_SPLIT, 4 * cb.F32_SPLIT
    b, k = dg.shape
    n, kh = U.shape[0], k // 2
    halves = []
    for h in range(2):
        cols = slice(h * kh, (h + 1) * kh)
        d = dg[:, cols].double().reshape(b, kh // period, split, 4)
        u = U[:, cols].double().reshape(n, kh // period, split, 4)
        acc = torch.zeros(split, b, n, dtype=torch.float32)
        for c in range(kh // period):
            for v in range(4):
                prod = d[:, c, :, v].T[:, :, None] * u[:, c, :, v].T[:, None, :]
                acc = (prod + acc.double()).float()
        out = acc[0]
        for s in range(1, split):
            out = out + acc[s]
        halves.append(out)
    return halves[0] + halves[1]


def k10_replay(U, g_seq, c_seq, c0, dh_seq, dhT, dcT, cfg, dropout=None):
    """The fp32 persistent K10's reverse steps with ``split_order_dh_rec``:
    (dg_seq, dc0, dh0)."""
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
        dh_rec = split_order_dh_rec(dgs[t], U)
    return torch.stack(dgs), dc, dh_rec


def test_split_order_gives_one_set_of_bits_at_every_layout():
    """The order of each (b, j)'s sum is a function of k alone: the replay
    on 128 rows at once, in chunks of 32 (SP's four) and of 8 rows gives
    the same bits; the plain product differs from it only by the order."""
    rng = np.random.default_rng(25)
    b, n = 128, 64
    dg = torch.from_numpy(rng.standard_normal((b, 4 * n)).astype(np.float32))
    U = torch.from_numpy((rng.standard_normal((n, 4 * n)) * 0.25).astype(np.float32))
    whole = split_order_dh_rec(dg, U)
    for rows in (32, 8):
        parts = torch.cat([split_order_dh_rec(dg[r:r + rows], U)
                           for r in range(0, b, rows)])
        assert torch.equal(parts, whole), rows
    torch.testing.assert_close(whole, dg @ U.T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("drop", [0.0, 0.35])
def test_k10_order_matches_the_jax_kernel(drop):
    """K10's fp32 reverse steps in the persistent design's order, from the
    port's forward residuals, against the JAX VJP of
    ``pallas_tiled_scan_layer`` (``_bwd_tiled_kernel`` in interpret mode)
    on the same numpy inputs: dg (the gradient of xw), dh0 and dc0 within
    rtol 1e-5 / atol 1e-6."""
    s, b, n, wt, seed = 4, 32, 256, 128, -1234567
    rng = np.random.default_rng(7)
    U = (rng.standard_normal((n, 4 * n)) * 0.3 / np.sqrt(n / 16)).astype(np.float32)
    W = (rng.standard_normal((n, 4 * n)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(4 * n) * 0.3).astype(np.float32)
    h0, c0 = ((rng.standard_normal((b, n)) * 0.5).astype(np.float32) for _ in range(2))
    xw = rng.standard_normal((s, b, 4 * n)).astype(np.float32)
    dh = rng.standard_normal((s, b, n)).astype(np.float32)
    dhT, dcT = (rng.standard_normal((b, n)).astype(np.float32) for _ in range(2))
    kw = dict(hidden=n, compute_dtype="float32", residual_dtype="float32")
    jdrop = (drop, jnp.asarray([seed], jnp.int32)) if drop else None
    tdrop = (drop, seed) if drop else None

    def f(xw, h0, c0):
        return pallas_tiled_scan_layer(
            jmodel.LayerParams(jnp.asarray(W), jnp.asarray(U), jnp.asarray(bias)),
            xw, h0, c0, JConfig(**kw), wt=wt, dropout=jdrop)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (xw, h0, c0)))
    jdg, jdh0, jdc0 = vjp((jnp.asarray(dh), (jnp.asarray(dhT), jnp.asarray(dcT))))

    cfg = ModelConfig(**kw)
    t = torch.from_numpy
    out = ct.tiled_scan_layer_plain(LayerParams(t(W), t(U), t(bias)), t(xw),
                                    t(h0), t(c0), cfg, residuals=True,
                                    dropout=tdrop)
    g_seq, c_seq = out[3], out[2]
    got = k10_replay(t(U), g_seq, c_seq, t(c0), t(dh), t(dhT), t(dcT), cfg, tdrop)
    for mine, theirs, what in zip(got, (jdg, jdc0, jdh0), ("dg", "dc0", "dh0")):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5,
                                   atol=1e-6, err_msg=what)
