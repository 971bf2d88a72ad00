"""K8 and K9's choice of design (``ops/cuda_cell_tiled.py:tiled_fwd_plan``)
with explicit device numbers, the persistent design's shared-memory
mirror, and the forward wrappers on the CPU.

K8 and K9, the tiled-U forward, have two designs of one function on the
card: one persistent cooperative launch a window with N / 16 blocks, as
many of U's rows as fit held in shared memory and tensor-core products
(bf16 compute, B <= 128, a resident grid), and one launch a step (fp32
compute, or shapes the persistent design does not take). The numbers are
an H100 SXM's: 132 SMs, 232,448 bytes of shared memory a block may opt in
to. On a CPU tensor the wrappers return their plain versions, bit for bit,
without touching the kernels' library; those plain versions are held
against the JAX VJPs of ``pallas_tiled_embed_layer0`` and
``pallas_tiled_scan_layer`` (interpret mode) at
tests/test_pallas_cell.py:60-87's fp32 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_cell_tiled import (
    pallas_tiled_embed_layer0,
    pallas_tiled_scan_layer,
)
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import _build
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

SMS, SMEM = 132, 232_448
B5 = dict(hidden=2048, num_layers=1, loss_mode="all")   # run_configs.py 5b


def _cfg(dtype="bfloat16", residual="bfloat16", **kw):
    return TConfig(**{**B5, **kw}, compute_dtype=dtype, residual_dtype=residual)


@pytest.mark.parametrize("residual", ["bfloat16", "float32"])
def test_5b_takes_the_persistent_design(residual):
    """1x2048 in bf16: 128 blocks of 16 units on 132 SMs; at the training
    batch of 128 half of each block's 2048 U rows sit in shared memory, at
    the eval batch of 16 (one m tile, the k axis split 8 ways, a smaller
    ring) 1344 of them."""
    cfg = _cfg(residual=residual)
    assert ct.tiled_fwd_plan(cfg, 128, 2048, SMS, SMEM) == 1024
    assert ct.tiled_fwd_plan(cfg, 16, 2048, SMS, SMEM) == 1344
    assert ct.persist_smem_bytes(128, 2048, 1024) == 230_400 <= SMEM
    assert ct.persist_smem_bytes(16, 2048, 1344) == 228_096 <= SMEM


@pytest.mark.parametrize("dtype,n,b", [
    ("float32", 1024, 128),    # the flagship's fp32 steps
    ("float32", 2048, 128),
    ("float32", 1024, 16),
    ("bfloat16", 2048, 129),   # past one m tile a warp
    ("bfloat16", 2048, 256),
    ("bfloat16", 2080, 128),   # not a multiple of the 64-row chunk
])
def test_per_step_design_where_the_persistent_one_does_not_apply(dtype, n, b):
    cfg = _cfg(dtype, "float32" if dtype == "float32" else "bfloat16", hidden=n)
    assert ct.tiled_fwd_plan(cfg, b, n, SMS, SMEM) is None


def test_sms_and_shared_memory_bound_the_choice():
    """A grid of N / 16 blocks must be resident at one a SM: N = 4096
    needs 256 SMs, and a card of 114 SMs (an H100 PCIe) cannot hold 5b's
    128 blocks; a block needs at least its ring, and holds fewer U rows
    when it may take less shared memory."""
    cfg = _cfg()
    kres = ct.tiled_fwd_plan
    assert ct.tiled_fwd_plan(_cfg(hidden=4096), 128, 4096, SMS, SMEM) is None
    assert kres(_cfg(hidden=4096), 128, 4096, 256, SMEM) == 1024
    assert ct.tiled_fwd_plan(cfg, 128, 2048, 114, SMEM) is None
    assert kres(cfg, 128, 2048, 128, SMEM) == 1024
    ring = ct.persist_smem_bytes(128, 2048, 0)
    assert ct.tiled_fwd_plan(cfg, 128, 2048, SMS, ring - 1) is None
    assert kres(cfg, 128, 2048, SMS, ring) == 0
    chunk = 2 * 64 * (4 * 16 + 8)   # 64 U rows of 16 units x 4 gates
    assert kres(cfg, 128, 2048, SMS, ring + chunk - 1) == 0
    assert kres(cfg, 128, 2048, SMS, ring + chunk) == 64
    assert kres(cfg, 128, 2048, SMS, ring + 8 * chunk - 1) == 448
    assert kres(cfg, 128, 2048, SMS, 1 << 20) == 2048


def test_shared_memory_mirror_arithmetic():
    """kres rows of 64 + 8 bf16, then 3 ring slots of the m tiles' rows by
    64 + 8 bf16 and 64 U rows by 64 + 8 bf16; below 8 warp rows (the k
    axis split) at least the 32 KB of cross-warp partial sums."""
    slot = lambda b: 2 * (-(-b // 16) * 16 * 72 + 64 * 72)
    for b in (1, 16, 17, 32, 48, 64, 100, 128):
        for kres in (0, 64, 1024):
            ring = 3 * slot(b)
            if b <= 64:
                ring = max(ring, 8 * 32 * 32 * 4)
            assert ct.persist_smem_bytes(b, 2048, kres) == 144 * kres + ring
    assert [ct._warp_rows(b) for b in (1, 16, 17, 32, 33, 64, 65, 128)] == \
        [1, 1, 2, 2, 4, 4, 8, 8]


@pytest.mark.parametrize("n,b", [(2048, 128), (2048, 16), (2048, 1), (1024, 100),
                                 (512, 48), (128, 33), (64, 128)])
def test_plan_fills_shared_memory_with_whole_chunks(n, b):
    """The held rows are whole 64-row chunks of the slice, fit with the
    ring, and one more chunk would not fit (or the slice is whole)."""
    kres = ct.tiled_fwd_plan(_cfg(hidden=n), b, n, SMS, SMEM)
    assert kres is not None and kres % 64 == 0 and 0 <= kres <= n
    assert ct.persist_smem_bytes(b, n, kres) <= SMEM
    assert kres == n or ct.persist_smem_bytes(b, n, kres + 64) > SMEM
    assert n // ct.PERSIST_UNITS <= SMS


def _inputs(s, b, n, m, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: (rng.standard_normal(shape) * sd).astype(np.float32)
    return dict(W=f(m, 4 * n, sd=0.3), U=f(n, 4 * n, sd=0.3 / (n / 16) ** 0.5),
                b=f(4 * n, sd=0.3), xw=f(s, b, 4 * n), h0=f(b, n, sd=0.5),
                c0=f(b, n, sd=0.5), ids=rng.integers(0, m, (s, b)).astype(np.int32),
                dh=f(s, b, n), dhT=f(b, n), dcT=f(b, n))


@pytest.mark.parametrize("embed", [True, False])
@pytest.mark.parametrize("dtype,residual", [("float32", "float32"),
                                            ("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32")])
@pytest.mark.parametrize("drop", [None, (0.35, -7)])
def test_cpu_wrappers_are_the_plain_versions(embed, dtype, residual, drop,
                                             monkeypatch):
    """On CPU tensors ``tiled_embed_layer0`` and ``tiled_scan_layer``
    neither build nor load the kernels' library (stubbed to raise) and
    return their plain versions' outputs bit for bit, with residuals and
    without."""
    def no_library():
        raise AssertionError("the kernels' library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    s, b, n, m = 5, 12, 64, 32
    x = {k: torch.from_numpy(v) for k, v in _inputs(s, b, n, m, 3).items()}
    cfg = TConfig(hidden=n, vocab=m, compute_dtype=dtype, residual_dtype=residual)
    layer = tmodel.LayerParams(x["W"], x["U"], x["b"])
    kern, plain, seq = ((ct.tiled_embed_layer0, ct.tiled_embed_layer0_plain, x["ids"])
                        if embed else
                        (ct.tiled_scan_layer, ct.tiled_scan_layer_plain, x["xw"]))
    for residuals in (False, True):
        got = kern(layer, seq, x["h0"], x["c0"], cfg, residuals, drop)
        want = plain(layer, seq, x["h0"], x["c0"], cfg, residuals, drop)
        flat = lambda o: [o[0], *o[1], *o[2:]]
        assert len(flat(got)) == len(flat(want))
        for g, w in zip(flat(got), flat(want)):
            assert g.dtype == w.dtype
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("embed", [True, False])
def test_plain_versions_match_the_jax_vjp(embed):
    """fp32, B = 12 (not a multiple of 16, the persistent design's m tile):
    the output stream, hT, cT and every gradient through the wrappers'
    autograd functions on CPU tensors against the JAX VJP of the tiled
    Pallas function in interpret mode."""
    s, b, n, m = 6, 12, 256, 64
    x = _inputs(s, b, n, m, 5)
    jcfg, cfg = (C(hidden=n, vocab=m) for C in (JConfig, TConfig))
    if embed:
        def f(W, U, bias, h0, c0):
            return pallas_tiled_embed_layer0(jmodel.LayerParams(W, U, bias),
                                             jnp.asarray(x["ids"]), h0, c0, jcfg,
                                             wt=128)
        names = ("W", "U", "b", "h0", "c0")
    else:
        def f(U, xw, h0, c0):
            return pallas_tiled_scan_layer(
                jmodel.LayerParams(jnp.asarray(x["W"]), U, jnp.asarray(x["b"])),
                xw, h0, c0, jcfg, wt=128)
        names = ("U", "xw", "h0", "c0")
    (jh, (jhT, jcT)), vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in names))
    jg = vjp((jnp.asarray(x["dh"]), (jnp.asarray(x["dhT"]), jnp.asarray(x["dcT"]))))

    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in names}
    if embed:
        layer = tmodel.LayerParams(leaves["W"], leaves["U"], leaves["b"])
        th, (thT, tcT) = ct.differentiable_tiled_embed_layer0(
            layer, torch.from_numpy(x["ids"]), leaves["h0"], leaves["c0"], cfg)
    else:
        layer = tmodel.LayerParams(torch.from_numpy(x["W"]), leaves["U"],
                                   torch.from_numpy(x["b"]))
        th, (thT, tcT) = ct.differentiable_tiled_scan_layer(
            layer, leaves["xw"], leaves["h0"], leaves["c0"], cfg)
    obj = ((th * torch.from_numpy(x["dh"])).sum()
           + (thT * torch.from_numpy(x["dhT"])).sum()
           + (tcT * torch.from_numpy(x["dcT"])).sum())
    tg = torch.autograd.grad(obj, [leaves[k] for k in names])
    for got, want in ((th, jh), (thT, jhT), (tcT, jcT)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    for name, got, want in zip(names, tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=1e-6, err_msg=name)
