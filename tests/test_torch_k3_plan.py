"""Layer 0's backward, K3 (``cuda_cell_bwd.embed_layer0_bwd``) and its
two-step form K12 (``embed_layer0_bwd_unroll2``): the choice of design,
the wrappers on the CPU, and their plain version against the JAX VJP.

Under bf16 compute K3 and K12 take K6's persistent kernel with the layout
``k6_plan`` gives (one cooperative launch a window, then one tensor-core
product for dW and dU); under fp32 compute the fp32 persistent kernel with
the layout ``k6_f32_plan`` gives (one cooperative launch a window, then the
CUDA-core tail); B > 128, N = 2048 in fp32 and bf16 widths that are not a
multiple of 32 keep the per-step design. The device numbers are an H100 SXM's: 132
SMs, 232,448 bytes of shared memory a block may opt in to. The routing is
checked without a card: the tensors lie on the ``meta`` device and a
stand-in library records which launchers the wrapper calls, with what
layout. On CPU tensors the wrappers return their plain version bit for bit
without loading the library.

Against the JAX package: the plain version at B = 12 (a batch that fills
no 16-row part), fp32, N = 128, M = 256, against ``pallas_embed_layer0``'s
VJP in interpret mode at tests/test_pallas_cell.py:60-87's tolerances
(rtol 2e-4, atol 1e-6 on gradients), K3 without dropout and K12 (the JAX
package's unroll-2 kernel, ``EIGEN_LSTM_BWD_UNROLL=2``) without and with
dropout. Left out as covered elsewhere: K3 with dropout at B = 12
(tests/test_torch_dropout.py::test_embed_layer0_dropout_matches_pallas),
K3 and K12 at B = 8 (tests/test_torch_train_kernels.py,
tests/test_torch_unroll2.py) and the GEMM fall-back's db, which the JAX
package takes only at N = 1024 (tests/test_torch_layer0_db.py, B = 8).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops import pallas_cell as jpc
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import _build, cuda_cell, cuda_cell_bwd

SMS, SMEM = 132, 232_448
M = 256

# (name, config keywords, batch, fused VJP, unroll 2, the layout k6_plan
# gives, its shared memory): the bench (bench.py: 1x512, B = 128), layer 0
# of the 3x1024 flagship (its GEMM fall-back), the documented unroll-2 run
# (docs/PERFORMANCE.md: 1x512, B = 64, fp32 residuals)
SHAPES = [
    ("bench", dict(hidden=512), 128, True, False, (16, 32), 118_016),
    ("flagship", dict(hidden=1024, num_layers=3, dropout=0.35), 128, False,
     False, (16, 64), 183_552),
    ("unroll2", dict(hidden=512, residual_dtype="float32"), 64, True, True,
     (16, 16), 118_016),
]


def _cfg(dtype, **kw):
    return TConfig(vocab=M, compute_dtype=dtype, loss_mode="all", **kw)


@pytest.mark.parametrize("name,kw,b,fused,unroll2,plan,smem", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_layouts_of_the_three_runs(name, kw, b, fused, unroll2, plan, smem):
    """bf16: the bench 32 groups of 16 units x 4 parts of 32 rows, the
    flagship 64 x 2 parts of 64, the unroll-2 run 32 x 4 parts of 16: 128
    blocks each, one an SM."""
    n = kw["hidden"]
    assert cuda_cell_bwd.k6_plan(_cfg("bfloat16", **kw), b, n, SMS, SMEM) == plan
    units, rows = plan
    assert (n // units) * -(-b // rows) == 128
    assert cuda_cell_bwd.persist_smem_bytes(n, units) == smem <= SMEM


@pytest.mark.parametrize("dtype,n", [("float32", 512), ("float32", 1024),
                                     ("bfloat16", 48), ("bfloat16", 80)])
def test_per_step_design_in_fp32_and_at_odd_widths(dtype, n):
    assert cuda_cell_bwd.k6_plan(_cfg(dtype, hidden=n), 128, n, SMS, SMEM) is None


class _Library:
    """Stands in for the kernels' library: records each call, returns 0
    (one scratch float for the work-size query)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 1 if name.endswith("_work_floats") else 0
        return call


@pytest.fixture
def routed(monkeypatch):
    """The wrappers' card path with no card: tensors on ``meta``, the H100's
    limits, and the stand-in library."""
    lib = _Library()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_cell_bwd, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(cuda_cell, "_kernel_types",
                        lambda cfg, device: (cuda_cell._TYPE_CODES[cfg.cdtype],
                                             cuda_cell._TYPE_CODES[cfg.rdtype]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib


def _meta_args(cfg, s, b):
    n = cfg.hidden
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype,
                                                        device="meta")
    return (e(n, 4 * n, dtype=cfg.cdtype), e(s, b, 4 * n, dtype=cfg.rdtype),
            e(s, b, n, dtype=cfg.rdtype), e(s, b, n, dtype=cfg.rdtype),
            e(s, b, dtype=torch.int32), e(b, n), e(b, n), e(s, b, n), e(b, n),
            e(b, n), cfg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,kw,b,fused,unroll2,plan,smem", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_wrapper_launches_the_plan_s_design(routed, dtype, name, kw, b, fused,
                                            unroll2, plan, smem):
    """bf16: the persistent reverse launch with k6_plan's layout (steps in
    pairs for K12, db summed from the bf16 dg in the GEMM fall-back), then
    the one product of dW and dU (M one-hot rows); fp32: the fp32
    persistent reverse launch with k6_f32_plan's layout (steps in pairs for
    K12), then the tail of dU, dW and db from the fp32 dg (db from the dg
    rounded to the xw type in the GEMM fall-back), no per-step launch."""
    cfg = _cfg(dtype, **kw)
    wrapper = (cuda_cell_bwd.embed_layer0_bwd_unroll2 if unroll2
               else cuda_cell_bwd.embed_layer0_bwd)
    dWU, db, dh0, dc0 = wrapper(*_meta_args(cfg, 4, b), fused_accum=fused)
    n = cfg.hidden
    assert tuple(dWU.shape) == (M + n, 4 * n) and tuple(db.shape) == (4 * n,)
    names = [call[0] for call in routed.calls]
    if dtype == "float32":
        assert names == ["lstm_bwd_embed_work_floats", "lstm_bwd_f32_launch",
                         "lstm_bwd_tail_launch"]
        work, rev, tail = (call[1] for call in routed.calls)
        assert work == (4, b, n, M)
        layout = cuda_cell_bwd.k6_f32_plan(cfg, b, n, SMS, SMEM)
        # (rtype, 11 pointers, S, B, N, blocks, stages, steps, standard,
        #  drop_on, ...): 4 blocks a group at N = 512, 2 at 1024; c_last
        #  null (c_{S-1} from the stream)
        assert layout.blocks == (4 if n == 512 else 2)
        assert rev[5] is None
        assert rev[12:19] == (4, b, n, layout.blocks, layout.stages,
                              2 if unroll2 else 1, 0)
        assert rev[19] == 0
        # (rtype, h_seq, ids, h0, dg, out, db, work, S, B, N, M, round_db,
        #  ...): the fp32 dg the reverse launch wrote
        assert tail[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
        assert tail[4] == rev[9]
        assert tail[8:13] == (4, b, n, M, int(not fused))
        return
    assert names == ["lstm_bwd_embed_work_floats", "lstm_bwd_persist_launch",
                     "lstm_bwd_dWU_launch"]
    work, persist, dWU_call = (call[1] for call in routed.calls)
    assert work == (4, b, n, M)
    # (..., c_last, ..., S, B, N, units, rows, steps, standard, round_db,
    #  drop_on, ...): no c_last, which only K16 hands over
    assert persist[5] is None
    assert persist[14:20] == (4, b, n) + plan + (2 if unroll2 else 1,)
    assert persist[21] == int(not fused) and persist[22] == 0
    assert dWU_call[7:11] == (4, b, n, M)


@pytest.mark.parametrize("unroll2", [False, True], ids=["K3", "K12"])
@pytest.mark.parametrize("b,n", [(129, 512), (256, 512), (128, 2048)],
                         ids=["B129", "B256", "N2048"])
def test_refused_fp32_shapes_keep_the_per_step_launcher(routed, unroll2, b, n):
    """fp32 where k6_f32_plan refuses (B > 128; N = 2048, whose 256 blocks
    are not resident on 132 SMs): the per-step launcher alone, chosen from
    the shape, no persistent launch."""
    cfg = _cfg("float32", hidden=n)
    assert cuda_cell_bwd.k6_f32_plan(cfg, b, n, SMS, SMEM) is None
    wrapper = (cuda_cell_bwd.embed_layer0_bwd_unroll2 if unroll2
               else cuda_cell_bwd.embed_layer0_bwd)
    wrapper(*_meta_args(cfg, 4, b), fused_accum=True)
    assert [call[0] for call in routed.calls] == [
        "lstm_bwd_embed_work_floats",
        "lstm_bwd_embed_unroll2_launch" if unroll2 else "lstm_bwd_embed_launch"]


def _inputs(s, b, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: (rng.standard_normal(shape) * sd).astype(np.float32)
    return dict(W=f(M, 4 * n, sd=0.3), U=f(n, 4 * n, sd=2.0 / n ** 0.5),
                b=f(4 * n, sd=0.3), ids=rng.integers(0, M, (s, b)).astype(np.int32),
                h0=f(b, n, sd=0.5), c0=f(b, n, sd=0.5), dh=f(s, b, n, sd=0.1),
                dhT=f(b, n, sd=0.1), dcT=f(b, n, sd=0.1))


@pytest.mark.parametrize("unroll2", [False, True], ids=["K3", "K12"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "fall-back"])
@pytest.mark.parametrize("drop", [None, (0.35, -7)], ids=["no-drop", "drop"])
def test_cpu_wrappers_are_the_plain_version(monkeypatch, unroll2, fused, drop):
    """bf16 on CPU tensors: neither wrapper builds nor loads the library
    (stubbed to raise); each returns the plain version's outputs bit for
    bit, dg_out included."""
    def no_library():
        raise AssertionError("the kernels' library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    s, b, n = 6, 12, 32
    x = {k: torch.from_numpy(v) for k, v in _inputs(s, b, n, 3).items()}
    cfg = _cfg("bfloat16", hidden=n)
    layer = tmodel.LayerParams(x["W"], x["U"], x["b"])
    h_seq, _, c_seq, g_seq = cuda_cell.embed_layer0(layer, x["ids"], x["h0"],
                                                    x["c0"], cfg, residuals=True)
    args = (x["U"].to(cfg.cdtype), g_seq, c_seq, h_seq, x["ids"], x["h0"],
            x["c0"], x["dh"], x["dhT"], x["dcT"], cfg)
    wrapper = (cuda_cell_bwd.embed_layer0_bwd_unroll2 if unroll2
               else cuda_cell_bwd.embed_layer0_bwd)
    before = wrapper.launches
    dg_w, dg_p = torch.empty(s, b, 4 * n), torch.empty(s, b, 4 * n)
    got = wrapper(*args, dg_out=dg_w, dropout=drop, fused_accum=fused)
    want = cuda_cell_bwd.embed_layer0_bwd_plain(*args, dg_out=dg_p, dropout=drop,
                                                fused_accum=fused)
    assert wrapper.launches == before
    for g, w in zip(got + (dg_w,), want + (dg_p,)):
        assert g.dtype == w.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("unroll2,drop", [(False, None), (True, None),
                                          (True, (0.35, -77))],
                         ids=["K3", "K12", "K12-drop"])
def test_plain_version_matches_the_jax_vjp_at_b12(monkeypatch, capsys, unroll2,
                                                  drop):
    """fp32, B = 12, S = 6: dW, dU, db, dh0, dc0 of K3's or K12's wrapper on
    CPU tensors (the plain version), from K1's residuals, against
    ``pallas_embed_layer0``'s VJP in interpret mode, which runs its unroll-2
    kernel (no fall-back line) where K12 is held to it."""
    s, b, n = 6, 12, 128
    monkeypatch.setenv("EIGEN_LSTM_BWD_UNROLL", "2" if unroll2 else "1")
    x = _inputs(s, b, n, 11)
    jcfg, cfg = JConfig(vocab=M, hidden=n), _cfg("float32", hidden=n)
    jdrop = drop and (drop[0], jnp.asarray([drop[1]], jnp.int32))

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
    assert "falling back" not in capsys.readouterr().out

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    layer = tmodel.LayerParams(t["W"], t["U"], t["b"])
    h_seq, _, c_seq, g_seq = cuda_cell.embed_layer0(
        layer, t["ids"], t["h0"], t["c0"], cfg, residuals=True, dropout=drop)[:4]
    wrapper = (cuda_cell_bwd.embed_layer0_bwd_unroll2 if unroll2
               else cuda_cell_bwd.embed_layer0_bwd)
    dWU, db, dh0, dc0 = wrapper(t["U"], g_seq, c_seq, h_seq, t["ids"], t["h0"],
                                t["c0"], t["dh"], t["dhT"], t["dcT"], cfg,
                                dropout=drop)
    got = (dWU[:M], dWU[M:], db, dh0, dc0)
    for g, w, what in zip(got, want, ("dW", "dU", "db", "dh0", "dc0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-6, err_msg=what)
