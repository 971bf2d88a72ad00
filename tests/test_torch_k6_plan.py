"""K6's choice of design (``ops/cuda_cell_bwd.py:k6_plan``) with explicit
device numbers, and its wrapper on the CPU.

K6, the layers >= 1 backward, has two designs of one function on the card:
one persistent cooperative launch a window with U in shared memory and
tensor-core products (bf16 compute, where the grid can be resident), and
one launch a reverse step (fp32 compute, or shapes whose grid would not be
resident). The numbers are an H100 SXM's: 132 SMs, 232,448 bytes of shared
memory a block may opt in to. On a CPU tensor the wrapper returns its
plain version, bit for bit, without touching the kernels' library; that
plain version is held against the JAX VJP of ``pallas_scan_layer``
(interpret mode) at tests/test_pallas_cell.py:60-87's fp32 tolerances.
"""

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
FLAGSHIP = dict(hidden=1024, num_layers=3, dropout=0.35, loss_mode="all")


def _cfg(dtype, **kw):
    return TConfig(**{**FLAGSHIP, **kw}, compute_dtype=dtype)


def test_flagship_takes_the_persistent_design():
    """3x1024 in bf16 at B = 128: 64 groups of 16 units, the batch in two
    halves of 64 rows, 128 blocks on 132 SMs, 179 KB of shared memory."""
    assert cuda_cell_bwd.k6_plan(_cfg("bfloat16"), 128, 1024, SMS, SMEM) == (16, 64)
    assert cuda_cell_bwd.persist_smem_bytes(1024, 16) == 183_552 <= SMEM


@pytest.mark.parametrize("dtype,n,residual", [
    ("float32", 1024, "float32"),     # the flagship's fp32 steps
    ("float32", 512, "float32"),
    ("bfloat16", 2048, "bfloat16"),   # 5b's width: 256 groups of 8 units
    ("bfloat16", 2048, "float32"),
])
def test_per_step_design_where_the_persistent_one_does_not_apply(dtype, n, residual):
    cfg = _cfg(dtype, hidden=n, residual_dtype=residual)
    assert cuda_cell_bwd.k6_plan(cfg, 128, n, SMS, SMEM) is None


def test_shared_memory_and_sms_bound_the_choice():
    """16 units where their U rows fit, else 8; none where neither fits or
    the grid cannot be resident."""
    cfg = _cfg("bfloat16")
    need16 = cuda_cell_bwd.persist_smem_bytes(1024, 16)
    need8 = cuda_cell_bwd.persist_smem_bytes(1024, 8)
    assert cuda_cell_bwd.k6_plan(cfg, 128, 1024, SMS, need16 - 1) is None  # 128 groups > 132 / 2
    assert cuda_cell_bwd.k6_plan(cfg, 64, 1024, SMS, need16 - 1) == (8, 64)
    assert cuda_cell_bwd.k6_plan(cfg, 128, 1024, SMS, need8 - 1) is None
    assert cuda_cell_bwd.k6_plan(cfg, 128, 1024, 127, SMEM) is None
    assert cuda_cell_bwd.k6_plan(cfg, 128, 1024, 256, SMEM) == (16, 32)


@pytest.mark.parametrize("n,b", [(1024, 128), (1024, 100), (1024, 16),
                                 (512, 128), (512, 64), (256, 128), (96, 33),
                                 (32, 1), (1024, 1)])
def test_groups_and_parts_cover_the_layer(n, b):
    """Units a group times groups is N exactly; the parts of rows cover the
    batch, each part at least one row; the grid fits the SMs, one block an
    SM, and a block's shared memory fits."""
    plan = cuda_cell_bwd.k6_plan(_cfg("bfloat16", hidden=n), b, n, SMS, SMEM)
    assert plan is not None
    units, rows = plan
    groups, parts = n // units, -(-b // rows)
    assert units in (8, 16) and units * groups == n
    assert rows in (16, 32, 48, 64)
    assert parts * rows >= b > (parts - 1) * rows
    assert groups * parts <= SMS
    assert cuda_cell_bwd.persist_smem_bytes(n, units) <= SMEM


def _inputs(s, b, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: (rng.standard_normal(shape) * sd).astype(np.float32)
    return dict(W=f(n, 4 * n, sd=0.3 / n ** 0.5), U=f(n, 4 * n, sd=2.0 / n ** 0.5),
                b=f(4 * n, sd=0.3), xw=f(s, b, 4 * n), h0=f(b, n, sd=0.2),
                c0=f(b, n, sd=0.2), dh=f(s, b, n, sd=0.1), dhT=f(b, n, sd=0.1),
                dcT=f(b, n, sd=0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop", [None, (0.35, -7)])
def test_cpu_wrapper_is_the_plain_version(dtype, drop, monkeypatch):
    """On CPU tensors ``scan_layer_bwd`` neither builds nor loads the
    kernels' library (stubbed to raise) and returns
    ``scan_layer_bwd_plain``'s outputs bit for bit, dg_out included."""
    def no_library():
        raise AssertionError("the kernels' library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    s, b, n = 6, 5, 32
    x = {k: torch.from_numpy(v) for k, v in _inputs(s, b, n, 3).items()}
    cfg = TConfig(hidden=n, compute_dtype=dtype)
    layer = tmodel.LayerParams(x["W"], x["U"], x["b"])
    h_seq, _, c_seq, g_seq = cuda_cell.scan_layer(layer, x["xw"], x["h0"],
                                                  x["c0"], cfg, residuals=True)
    args = (x["U"].to(cfg.cdtype), g_seq, c_seq, h_seq, x["h0"], x["c0"],
            x["dh"], x["dhT"], x["dcT"], cfg)
    dg_w, dg_p = torch.empty(s, b, 4 * n), torch.empty(s, b, 4 * n)
    got = cuda_cell_bwd.scan_layer_bwd(*args, dg_out=dg_w, dropout=drop)
    want = cuda_cell_bwd.scan_layer_bwd_plain(*args, dg_out=dg_p, dropout=drop)
    for g, w in zip(got + (dg_w,), want + (dg_p,)):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_plain_version_matches_the_jax_vjp():
    """fp32, B = 12 (not a multiple of 16, the persistent design's row
    tile): dg_seq, dU, dh0, dc0 against the JAX VJP of
    ``pallas_scan_layer`` in interpret mode."""
    s, b, n = 8, 12, 32
    x = _inputs(s, b, n, 5)
    jcfg, cfg = JConfig(hidden=n), TConfig(hidden=n)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    layer = tmodel.LayerParams(t["W"], t["U"], t["b"])
    h_seq, _, c_seq, g_seq = cuda_cell.scan_layer(layer, t["xw"], t["h0"],
                                                  t["c0"], cfg, residuals=True)
    dg, dU, dh0, dc0 = cuda_cell_bwd.scan_layer_bwd(
        t["U"], g_seq, c_seq, h_seq, t["h0"], t["c0"], t["dh"], t["dhT"],
        t["dcT"], cfg)

    def f(U, xw, h0, c0):
        return jpc.pallas_scan_layer(
            jmodel.LayerParams(jnp.asarray(x["W"]), U, jnp.asarray(x["b"])),
            xw, h0, c0, jcfg)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x["U"], x["xw"], x["h0"], x["c0"])))
    want = vjp((jnp.asarray(x["dh"]), (jnp.asarray(x["dhT"]), jnp.asarray(x["dcT"]))))
    for got, w in zip((dU, dg, dh0, dc0), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4, atol=1e-6)
