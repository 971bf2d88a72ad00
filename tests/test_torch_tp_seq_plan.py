"""K16, the tensor-parallel window's backward (``cuda_tp_seq.tp_seq_bwd``):
its choice of design, the launch its card path makes, and the layout that
lets it run on K6's persistent kernel.

At D = 1 K16 is K6's reverse recurrence: dh_t = dh_seq[t] + (dhT at
t = S-1, else round(dg_{t+1}) @ U^T), the gate backward, the fp32 dg, then
dh0 = round(dg_0) @ U^T and dc0. Under bf16 compute it takes K6's
persistent kernel wherever ``cuda_cell_bwd.k6_plan`` gives a layout, under
fp32 compute K6's fp32 persistent kernel wherever ``k6_f32_plan`` gives
one, and the cooperative CUDA-core design elsewhere. The layouts differ in one
place: K16 gets c_prev (S, B, nd) with c_prev[t] = c_{t-1} and c_{S-1}
apart, as the fp32 cT; K6 reads c_t = c_seq[t] and
c_{t-1} = c_seq[t-1] or the fp32 c0. So the wrapper hands the kernel
c_prev advanced by one step as c_seq, c_prev[0] as c0 and cT as c_{S-1}
(read in place of c_seq[S-1]: the bf16 launcher's cT, the fp32 launcher's
c_last), with no copy of the stream. Rounding cT
into a copied stream would change dg under bf16 residuals; the last test
keeps that trap guarded.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. The plain
version against the JAX ``tp_seq_lstm`` VJP is
tests/test_torch_tp_kernels.py::test_tp_seq_matches_jax_tp_seq_lstm.
"""

import types

import numpy as np
import pytest
import torch

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.ops import _build, cuda_cell, cuda_cell_bwd
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts

SMS, SMEM = 132, 232_448


def _cfg(dtype="bfloat16", residual="float32", n=512, **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual,
                       **kw)


def test_bench_tp1_takes_the_persistent_design():
    """bf16 at the bench's --tp 1 shapes (N = nd = 512, B = 128): K6's
    layout, 32 groups of 16 units x 4 parts of 32 rows = 128 blocks."""
    for residual in ("float32", "bfloat16"):
        plan = cuda_cell_bwd.k6_plan(_cfg(residual=residual), 128, 512, SMS, SMEM)
        assert plan == (16, 32)
        assert 512 // plan[0] * -(-128 // plan[1]) == 128


@pytest.mark.parametrize("dtype,nd,b", [
    ("float32", 512, 128),    # fp32: TF32 stays off, no tensor cores
    ("float32", 1024, 128),
    ("bfloat16", 48, 128),    # widths that are not a multiple of 32
    ("bfloat16", 80, 64),
    ("bfloat16", 4096, 128),  # 16 units x 16K gates overflow shared memory
])
def test_cooperative_design_elsewhere(dtype, nd, b):
    assert cuda_cell_bwd.k6_plan(_cfg(dtype, n=nd), b, nd, SMS, SMEM) is None


class _Library:
    """Stands in for the kernels' library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    """The card path with no card: tensors on ``meta``, each storage at an
    address of its own (its index << 32, plus the view's byte offset), the
    H100's limits and the stand-in library."""
    lib = _Library()
    storages = {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        base = storages.setdefault(key, len(storages) + 1) << 32
        return base + t.storage_offset() * t.element_size()

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_cell_bwd, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(ts, "_card", lambda cfg, dev, nd: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr


def _meta_args(cfg, s, b, nd):
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype,
                                                        device="meta")
    return dict(U=e(nd, 4 * nd, dtype=cfg.cdtype), g=e(s, b, 4 * nd, dtype=cfg.rdtype),
                c_prev=e(s, b, nd, dtype=cfg.rdtype), cT=e(b, nd), dh=e(s, b, nd),
                dhT=e(b, nd), dcT=e(b, nd))


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
def test_card_path_launches_k6_s_persistent_kernel(routed, residual):
    """bf16 compute, --tp 1 bench shapes: one call of
    ``lstm_bwd_persist_launch`` and nothing else (no dWU launch: dU is a
    product outside), with U as it is (N, 4N), c_seq = c_prev advanced one
    step, c0 = c_prev[0] in fp32 (the same storage with fp32 residuals),
    cT as c_{S-1}, the fp32 dg into the returned dg, no db, no work,
    k6_plan's layout, one step at a time, dropout off."""
    lib, ptr = routed
    s, b, nd = 5, 128, 512
    cfg = _cfg(residual=residual)
    x = _meta_args(cfg, s, b, nd)
    dg, dh0, dc0 = ts.tp_seq_bwd(x["U"], x["g"], x["c_prev"], x["cT"], x["dh"],
                                 x["dhT"], x["dcT"], cfg)
    assert tuple(dg.shape) == (s, b, 4 * nd) and dg.dtype == torch.float32
    assert [c[0] for c in lib.calls] == ["lstm_bwd_persist_launch"]
    a = lib.calls[0][1]
    # (rtype, U, g, c_seq, c0, c_last, dh_seq, dhT, dc, dgx, dg32, dh0, db,
    #  work, S, B, N, units, rows, steps, standard, round_db, drop_on, ...)
    assert a[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
    assert a[1] == ptr(x["U"]) and a[2] == ptr(x["g"])
    assert a[3] == ptr(x["c_prev"]) + b * nd * x["c_prev"].element_size()
    if residual == "float32":
        assert a[4] == ptr(x["c_prev"])
    else:   # c_prev[0] widened to fp32: a tensor of its own
        assert a[4] >> 32 not in {ptr(v) >> 32 for v in x.values()}
    assert a[5] == ptr(x["cT"]) and a[6] == ptr(x["dh"]) and a[7] == ptr(x["dhT"])
    assert a[10] == ptr(dg) and a[11] == ptr(dh0) and a[8] == ptr(dc0)
    assert a[9] not in (None, ptr(dg))   # the bf16 dg the products read
    assert a[12] is None and a[13] is None
    assert a[14:22] == (s, b, nd, 16, 32, 1, 0, 0) and a[22] == 0


def test_fp32_keeps_the_cooperative_design(routed):
    """fp32 compute at shapes ``k6_f32_plan`` refuses (more than 128 batch
    rows; N = 2048, whose grid is not resident): ``tp_seq_bwd_launch``
    with U^T, one call each."""
    lib, ptr = routed
    for b, nd in ((136, 512), (128, 2048)):
        lib.calls.clear()
        cfg = _cfg("float32", n=nd)
        assert cuda_cell_bwd.k6_f32_plan(cfg, b, nd, SMS, SMEM) is None
        x = _meta_args(cfg, 5, b, nd)
        ts.tp_seq_bwd(x["U"], x["g"], x["c_prev"], x["cT"], x["dh"], x["dhT"],
                      x["dcT"], cfg)
        assert [c[0] for c in lib.calls] == ["tp_seq_bwd_launch"]
        assert lib.calls[0][1][2] != ptr(x["U"])   # the transposed copy


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nd", [(128, 512), (32, 512), (128, 1024)])
def test_fp32_launches_k6_s_fp32_persistent_kernel(routed, residual, b, nd):
    """fp32 compute where ``k6_f32_plan`` gives a layout (the --tp 1
    bench's B = 128, N = 512: G = 4): one call of ``lstm_bwd_f32_launch``
    and nothing else, with U as it is (N, 4N) fp32, c_seq = c_prev
    advanced one step, c0 = c_prev[0] in fp32 (the same storage with fp32
    residuals), c_last = cT (in place of c_seq[S-1]), the dh sequence,
    dhT, dc (dcT's copy, dc0 on return), the returned fp32 dg, the G parts'
    scratch, dh0; the plan's G and ring, one step at a time, dropout off."""
    lib, ptr = routed
    s = 5
    cfg = _cfg("float32", residual, n=nd)
    x = _meta_args(cfg, s, b, nd)
    dg, dh0, dc0 = ts.tp_seq_bwd(x["U"], x["g"], x["c_prev"], x["cT"], x["dh"],
                                 x["dhT"], x["dcT"], cfg)
    assert [c[0] for c in lib.calls] == ["lstm_bwd_f32_launch"]
    a = lib.calls[0][1]
    # (rtype, U, g, c_seq, c0, c_last, dh_seq, dhT, dc, dg, xbuf, dh0, S, B,
    #  N, groups, stages, steps, standard, drop_on, seed, keep, inv, stream,
    #  launched)
    plan = cuda_cell_bwd.k6_f32_plan(cfg, b, nd, SMS, SMEM)
    assert a[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
    assert a[1] == ptr(x["U"]) and a[2] == ptr(x["g"])
    assert a[3] == ptr(x["c_prev"]) + b * nd * x["c_prev"].element_size()
    if residual == "float32":
        assert a[4] == ptr(x["c_prev"])
    else:   # c_prev[0] widened to fp32: a tensor of its own
        assert a[4] >> 32 not in {ptr(v) >> 32 for v in x.values()}
    assert a[5] == ptr(x["cT"]) and a[6] == ptr(x["dh"]) and a[7] == ptr(x["dhT"])
    assert a[8] == ptr(dc0) and a[9] == ptr(dg) and a[11] == ptr(dh0)
    assert a[10] not in (None, ptr(dg))
    assert dg.dtype == torch.float32 and tuple(dg.shape) == (s, b, 4 * nd)
    assert a[12:23] == (s, b, nd, plan.blocks, plan.stages, 1, 0, 0, 0, 0, 0.0)
    assert plan.blocks == (4 if nd == 512 else 2)


def _window(cfg, s, b, n, seed):
    """A window's residuals from K15's plain version at D = 1 and the
    backward's cotangents, from numpy at ``seed``."""
    rng = np.random.default_rng(seed)
    ad = cuda_cell._acc_dtype(cfg)
    f = lambda *shape, sd: torch.from_numpy(rng.normal(size=shape) * sd).to(ad)
    U = f(n, 4 * n, sd=0.08).to(cfg.cdtype)
    h_seq, g_seq, c_prev, hT, cT = ts.tp_seq_fwd_plain(
        U, f(s, b, 4 * n, sd=0.7), f(b, n, sd=0.3), f(b, n, sd=0.3), cfg)
    return U, g_seq, c_prev, cT, f(s, b, n, sd=0.1), f(b, n, sd=0.1), f(b, n, sd=0.1)


def _k6_layout(c_prev, cT, ad):
    """K6's c layout from K16's, in the accumulation type (as the kernel
    reads c_{S-1} from cT in fp32): c_seq = c_prev[1:] then cT, c0 =
    c_prev[0]."""
    return torch.cat([c_prev[1:].to(ad), cT.to(ad)[None]]), c_prev[0].to(ad)


@pytest.mark.parametrize("dtype,residual,tol", [
    ("float32", "float32", 1e-6), ("float32", "bfloat16", 1e-6),
    ("bfloat16", "float32", 1e-6), ("bfloat16", "bfloat16", 1e-6),
    ("float64", "float64", 1e-12)])
def test_k6_reverse_on_the_remapped_inputs_is_k16(dtype, residual, tol):
    """``cuda_cell_bwd._reverse_plain`` (K6's reverse steps) on K16's
    inputs in K6's layout equals ``tp_seq_bwd_plain`` at D = 1: dg, dh0 and
    dc0. The two loops take the same steps; only the order of their
    products may differ."""
    s, b, n = 6, 12, 64
    cfg = _cfg(dtype, residual, n=n,
               param_dtype="float64" if dtype == "float64" else "float32")
    ad = cuda_cell._acc_dtype(cfg)
    U, g_seq, c_prev, cT, dh_seq, dhT, dcT = _window(cfg, s, b, n, 3)
    want = ts.tp_seq_bwd_plain(U, g_seq, c_prev, cT, dh_seq, dhT, dcT, cfg)
    c_seq, c0 = _k6_layout(c_prev, cT, ad)
    got = cuda_cell_bwd._reverse_plain(U, g_seq, c_seq, c0, dh_seq, dhT, dcT,
                                       cfg, None)
    for name, g, w in zip(("dg", "dh0", "dc0"), got, want):
        assert g.dtype == w.dtype == ad
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= tol * scale, name


def test_rounding_ct_into_the_stream_changes_dg():
    """bf16 residuals: c_{S-1} is the fp32 cT; a stream copy that rounds
    it to bf16 (as c_seq[S-1] in the residual type would) gives another
    dg at the last step, and so another dg_t for every t before it."""
    s, b, n = 6, 12, 64
    cfg = _cfg("bfloat16", "bfloat16", n=n)
    U, g_seq, c_prev, cT, dh_seq, dhT, dcT = _window(cfg, s, b, n, 5)
    assert not torch.equal(cT, cT.to(cfg.rdtype).float())
    want = ts.tp_seq_bwd_plain(U, g_seq, c_prev, cT, dh_seq, dhT, dcT, cfg)[0]
    c_seq, c0 = _k6_layout(c_prev, cT, torch.float32)
    rounded = torch.cat([c_prev[1:], cT.to(cfg.rdtype)[None]])
    kept = cuda_cell_bwd._reverse_plain(U, g_seq, c_seq, c0, dh_seq, dhT, dcT,
                                        cfg, None)[0]
    lost = cuda_cell_bwd._reverse_plain(U, g_seq, rounded, c0, dh_seq, dhT,
                                        dcT, cfg, None)[0]
    torch.testing.assert_close(kept, want, rtol=0, atol=1e-6)
    assert not torch.equal(lost[-1], want[-1])
    assert not torch.equal(lost[0], want[0])
