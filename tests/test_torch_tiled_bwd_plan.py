"""K10's choice of design (``ops/cuda_cell_tiled.py:tiled_bwd_plan``) with
explicit device numbers, the persistent design's shared-memory mirror, the
reverse wrapper and the tiled VJPs' products on the CPU, and K4's choice
of design (``ops/head.py:fwd_tensor_cores``).

K10, the tiled-U backward, has two designs of one function on the card:
one persistent cooperative launch a window, each block 32 hidden units and
16-64 batch rows, as many of its U chunks as fit held in shared memory and
tensor-core products (bf16 compute, N a multiple of 32, a resident grid),
and one launch a reverse step (fp32 compute, or shapes the persistent
design does not take). The numbers are an H100 SXM's: 132 SMs, 232,448
bytes of shared memory a block may opt in to. On a CPU tensor the wrapper
returns its plain version bit for bit without touching the kernels'
library, and the VJPs that call it (``plain=False``) still equal the JAX
VJPs of ``pallas_tiled_scan_layer`` and ``pallas_tiled_embed_layer0`` in
interpret mode, at tests/test_pallas_cell.py:60-87's tolerances (those of
``tests/test_torch_tiled.py``).
"""

import numpy as np
import pytest
import torch

from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.ops import _build, head
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

import test_torch_tiled

SMS, SMEM = 132, 232_448
B5 = dict(hidden=2048, num_layers=1, loss_mode="all")   # run_configs.py 5b
CHUNK = 2 * 32 * (128 + 8)   # bytes of one resident U chunk


def _cfg(dtype="bfloat16", residual="bfloat16", **kw):
    return TConfig(**{**B5, **kw}, compute_dtype=dtype, residual_dtype=residual)


@pytest.mark.parametrize("residual", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,rows,cres", [(128, 64, 14), (64, 32, 18)])
def test_5b_takes_the_persistent_design(residual, b, rows, cres):
    """1x2048 in bf16: 64 unit groups of 32; at B = 128 two halves of 64
    rows (128 blocks), 14 of each block's 64 U chunks held; at B = 64 two
    halves of 32 rows (128 blocks), 18 held."""
    plan = ct.tiled_bwd_plan(_cfg(residual=residual), b, 2048, SMS, SMEM)
    assert plan == (rows, cres)
    assert 2048 // ct.BWD_UNITS * -(-b // rows) == 128 <= SMS


@pytest.mark.parametrize("dtype,n,b", [
    ("float32", 1024, 128),    # the flagship's fp32 steps
    ("float32", 2048, 128),
    ("bfloat16", 2048, 129),   # past the design's 128 rows at N = 2048
    ("bfloat16", 2048, 256),
    ("bfloat16", 2040, 128),   # not a multiple of the 32-unit group
    ("bfloat16", 4096, 128),   # 128 groups need 256 SMs at 64 rows
])
def test_per_step_design_where_the_persistent_one_does_not_apply(dtype, n, b):
    cfg = _cfg(dtype, "float32" if dtype == "float32" else "bfloat16", hidden=n)
    assert ct.tiled_bwd_plan(cfg, b, n, SMS, SMEM) is None


def test_sms_and_shared_memory_bound_the_choice():
    """The grid must be resident at one block a SM: an H100 PCIe's 114 SMs
    hold 5b's B = 128 only at more rows than a block takes; a block needs
    at least its ring, and holds fewer chunks with less shared memory."""
    cfg = _cfg()
    plan = ct.tiled_bwd_plan
    assert plan(cfg, 128, 2048, 114, SMEM) is None
    assert plan(cfg, 64, 2048, 114, SMEM) == (64, 14)
    assert plan(_cfg(hidden=4096), 64, 4096, SMS, SMEM) == (64, 14)
    ring = ct.bwd_persist_smem_bytes(64, 0)
    assert plan(cfg, 128, 2048, SMS, ring - 1) is None
    assert plan(cfg, 128, 2048, SMS, ring) == (64, 0)
    assert plan(cfg, 128, 2048, SMS, ring + CHUNK - 1) == (64, 0)
    assert plan(cfg, 128, 2048, SMS, ring + 5 * CHUNK) == (64, 5)
    assert plan(cfg, 128, 2048, SMS, 1 << 22) == (64, 64)   # all of U's 4N


def test_shared_memory_mirror_arithmetic():
    """cres chunks of 32 units by 128 + 8 bf16, then 4 ring slots of the
    16-row tiles and 32 units by 128 + 8 bf16, or the cross-warp partial
    sums (8 warps x rows x 40 fp32) where those are larger."""
    for rows in (16, 32, 48, 64):
        ring = 2 * 4 * (rows + 32) * 136
        red = 8 * rows * 40 * 4
        for cres in (0, 1, 17, 64):
            assert ct.bwd_persist_smem_bytes(rows, cres) == \
                CHUNK * cres + max(ring, red)
    assert ct.bwd_persist_smem_bytes(64, 14) == 226_304 <= SMEM
    assert ct.bwd_persist_smem_bytes(32, 18) == 226_304 <= SMEM
    assert ct.bwd_persist_smem_bytes(64, 15) > SMEM
    assert ct.bwd_persist_smem_bytes(20, 3) == ct.bwd_persist_smem_bytes(32, 3)


@pytest.mark.parametrize("n,b", [(2048, 128), (2048, 64), (2048, 1),
                                 (1024, 128), (512, 48), (64, 128)])
def test_plan_fills_shared_memory_with_whole_chunks(n, b):
    """The held chunks fit with the ring, and one more would not fit (or
    all of the block's 4N / 128 chunks are held)."""
    rows, cres = ct.tiled_bwd_plan(_cfg(hidden=n), b, n, SMS, SMEM)
    assert rows in ct.BWD_ROWS and 0 <= cres <= 4 * n // ct.BWD_KC
    assert ct.bwd_persist_smem_bytes(rows, cres) <= SMEM
    assert (cres == 4 * n // ct.BWD_KC
            or ct.bwd_persist_smem_bytes(rows, cres + 1) > SMEM)
    assert n // ct.BWD_UNITS * -(-b // rows) <= SMS


def _reverse_inputs(s, b, n, seed, cfg):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * sd).astype(np.float32))
    _, rd, _ = ct.types(cfg)
    g = torch.sigmoid(f(s, b, 4 * n)).to(rd)
    c = f(s, b, n, sd=0.5).to(rd)
    return (f(n, 4 * n, sd=0.3 / (n / 16) ** 0.5), g, c, f(b, n, sd=0.5),
            f(s, b, n), f(b, n), f(b, n))


@pytest.mark.parametrize("dtype,residual", [("float32", "float32"),
                                            ("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32")])
@pytest.mark.parametrize("drop", [None, (0.35, -7)])
def test_cpu_reverse_wrapper_is_the_plain_version(dtype, residual, drop,
                                                 monkeypatch):
    """On CPU tensors ``tiled_bwd`` neither builds nor loads the kernels'
    library (stubbed to raise) and returns ``tiled_bwd_plain``'s dg and
    dc0 bit for bit; ``dh0_out`` receives round(dg_0) @ U_c^T through
    ``_mm``, and ``dg_out``, which the persistent design alone writes, is
    refused."""
    def no_library():
        raise AssertionError("the kernels' library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    s, b, n = 5, 12, 64
    cfg = TConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual)
    U, g, c, c0, dh, dhT, dcT = _reverse_inputs(s, b, n, 4, cfg)
    U_c = U.to(cfg.cdtype)
    dh0 = torch.empty(b, n)
    dg, dc = ct.tiled_bwd(U_c, g, c, c0, dh, dhT, dcT, cfg, drop, dh0_out=dh0)
    dg_p, dc_p = ct.tiled_bwd_plain(U_c, g, c, c0, dh, dhT, dcT, cfg, drop)
    assert dg.dtype == dg_p.dtype == ct.types(cfg)[2]
    torch.testing.assert_close(dg, dg_p, rtol=0, atol=0)
    torch.testing.assert_close(dc, dc_p, rtol=0, atol=0)
    torch.testing.assert_close(dh0, ct._mm(dg_p[0], U_c.T, cfg), rtol=0, atol=0)
    with pytest.raises(ValueError, match="persistent design alone"):
        ct.tiled_bwd(U_c, g, c, c0, dh, dhT, dcT, cfg, drop,
                     dg_out=torch.empty(s, b, 4 * n))


@pytest.mark.parametrize("dtype,residual", [("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32"),
                                            ("float32", "float32")])
def test_cpu_dU_is_the_fp32_product(dtype, residual):
    """On the CPU the VJPs' dU is ``_mm``'s fp32 product of round(h_prev)
    and round(dg) whether or not ``plain`` is asked for (the tensor cores
    take it on the card under bf16 compute), and ``tensor_core_dU``
    refuses fp32 compute."""
    s, b, n = 4, 6, 32
    cfg = TConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual)
    _, rd, xd = ct.types(cfg)
    rng = np.random.default_rng(8)
    dg = torch.from_numpy(rng.standard_normal((s, b, 4 * n)).astype(np.float32)).to(xd)
    h = torch.from_numpy(rng.standard_normal((s, b, n)).astype(np.float32)).to(rd)
    h0 = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    got = ct._dU(dg, h, h0, cfg, plain=False)
    h_prev = torch.cat([h0.to(rd)[None], h[:-1]]).reshape(s * b, n)
    want = ct._mm(h_prev.T, dg.reshape(s * b, 4 * n), cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ct._dU(dg, h, h0, cfg, plain=True), want,
                               rtol=0, atol=0)
    if dtype == "float32":
        with pytest.raises(TypeError):
            ct.tensor_core_dU(dg, h, h0, cfg)


@pytest.mark.parametrize("drop", [0.0, test_torch_tiled.RATE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("embed", [True, False])
def test_tiled_vjps_through_the_wrappers_match_pallas(embed, dtype, drop):
    """The autograd functions as the path calls them (``plain=False``: the
    wrappers, which on the CPU run the plain versions, with dh0 handed out
    through ``dh0_out`` and dU through ``_dU``) against the JAX VJPs in
    interpret mode: the stream, hT, cT and every gradient."""
    test_torch_tiled._compare(dtype, "reference", embed, drop, plain=False)


@pytest.mark.parametrize("dtype,n,m,want", [
    ("bfloat16", 512, 256, True),     # the bench
    ("bfloat16", 2048, 256, True),    # 5b
    ("bfloat16", 1024, 256, True),    # the flagship
    ("float32", 512, 256, False),     # fp32 keeps the CUDA cores
    ("bfloat16", 520, 256, False),    # N not a multiple of 64
    ("bfloat16", 512, 100, False),    # M not a multiple of 8
    ("bfloat16", 512, 8, True),
])
def test_k4_design(dtype, n, m, want):
    """K4 takes its tensor-core design under bf16 compute where N is a
    multiple of its 64-row chunk and M of its 8-column copies."""
    cfg = TConfig(hidden=n, vocab=m, compute_dtype=dtype)
    assert head.fwd_tensor_cores(cfg, n, m) is want
