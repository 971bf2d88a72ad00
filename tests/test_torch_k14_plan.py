"""K14, the per-step tensor-parallel reverse step
(``cuda_tp_cell.tp_step_bwd_dh``): its choice of design, its sum order and
the launch ``TPStep.backward`` makes on the card.

Where ``tp_step_bwd_plan`` gives a layout (bf16 compute), K14 is one
cooperative launch (``csrc/lstm_tp_step_bwd.cu``): the gate backward of
the step and the rank's partial dh_full = round(dg) @ U_c^T, N / 64 groups
of G blocks, a block its group's rows of U_c over 4nd / G gate columns,
the G parts added in part order and rounded once to bf16; G comes from (N,
nd) and the card, never from B. Elsewhere (fp32 compute, refused shapes)
K14 keeps its first design: the gate backward alone (``tp_step_bwd``) and
the product outside.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. The fused
step's sum order is replayed (each part's products in float64, as the
tensor cores' fp32 sums approach them) against the plain version.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cell as cell_ops
from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc

SMS, SMEM = 132, 232_448
CSRC = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")
BF16, FP32 = torch.bfloat16, torch.float32


def _cfg(dtype="bfloat16", n=1024, **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, **kw)


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_flagship_shards_take_the_fused_step(ndev):
    """The flagship's --tp shard (N = 1024, B = 128) at D = 1, 2, 4 under
    bf16 compute: 128 blocks (16 groups of 64 units x 8 parts), a block's
    slice of U_c and its ring within the block's shared memory."""
    nd = 1024 // ndev
    plan = tc.tp_step_bwd_plan(_cfg(), 128, 1024, nd, SMS, SMEM)
    assert plan == tc.StepBwdPlan(8, 4)
    assert 1024 // tc.STEP_BWD_UNITS * plan.blocks == 128
    assert tc.step_bwd_smem_bytes(128, nd, *plan) <= SMEM


@pytest.mark.parametrize("n,nd", [(1024, 1024), (1024, 512), (1024, 256),
                                  (512, 512), (2048, 1024), (256, 256)])
def test_g_does_not_depend_on_the_batch(n, nd):
    """G at 8, 32 and 128 rows is one (SP's 32-row chunks sum in the whole
    batch's order)."""
    cfg = _cfg(n=n)
    gs = {tc.tp_step_bwd_plan(cfg, b, n, nd, SMS, SMEM).blocks for b in (8, 32, 128)}
    assert len(gs) == 1


@pytest.mark.parametrize("b,n,nd,sms,smem", [
    (160, 1024, 1024, SMS, SMEM),     # more rows than 8 m tiles
    (129, 512, 512, SMS, SMEM),       # likewise, one row past
    (128, 96, 96, SMS, SMEM),         # N not a multiple of 64 units
    (128, 1024, 1000, SMS, SMEM),     # nd not a multiple of 16
    (128, 1024, 1024, 15, SMEM),      # 16 groups on 15 SMs
    (128, 8192, 1024, SMS, SMEM),     # U's slice does not fit
    (128, 1024, 1024, SMS, 40_000),   # no ring fits
    (128, 1024, 24, SMS, SMEM),       # 4nd not a whole chunk at any G
])
def test_layout_refuses(b, n, nd, sms, smem):
    assert tc.tp_step_bwd_plan(_cfg(n=n), b, n, nd, sms, smem) is None


def test_float64_has_no_layout():
    cfg = types.SimpleNamespace(cdtype=torch.float64)
    assert tc.tp_step_bwd_plan(cfg, 128, 1024, 1024, SMS, SMEM) is None


@pytest.mark.parametrize("n,nd", [(1024, 256), (1024, 512), (1024, 1024), (512, 512)])
def test_fp32_keeps_the_first_design_bf16_takes_the_layout(n, nd):
    """Under fp32 compute the first design at every shard (a fused fp32
    step measured no faster on the card); under bf16 compute the fused
    step's layout, the same at 32 and 128 rows."""
    for b in (32, 128):
        assert tc.tp_step_bwd_plan(_cfg("float32", n=n), b, n, nd, SMS, SMEM) is None
        assert tc.tp_step_bwd_plan(_cfg("bfloat16", n=n), b, n, nd, SMS, SMEM) is not None


def test_shared_memory_mirror():
    """U_c's slice (64 units x (4nd / G + 8)) beside stages x whole 16-row
    tiles x (64 + 8), as the source lays them out; the source's constants
    and rings are the mirror's."""
    for b, nd, g, st in ((128, 1024, 8, 4), (40, 512, 16, 2), (1, 256, 4, 2)):
        want = 2 * (64 * (4 * nd // g + 8) + st * 16 * -(-b // 16) * 72)
        assert tc.step_bwd_smem_bytes(b, nd, g, st) == want
    src = open(os.path.join(CSRC, "lstm_tp_step_bwd.cu")).read()
    for decl in ("kSUnits = 64;", "kSKC = 64;", "kSPad = 8;", "kSMaxRows = 128;"):
        assert "constexpr int " + decl in src
    stages = re.search(r"#define STEP_BWD_STAGES\(X\)(.*)", src).group(1)
    assert tuple(int(x) for x in re.findall(r"X\((\d+)\)", stages)) == tc.STEP_BWD_STAGES


def test_kernel_source_keeps_the_orders_and_its_signature():
    """The gate backward is ``gate_bwd``; the parts are added in part
    order; two grid barriers at most; products on ``mma.sync`` alone; the
    C signature is ``_build.SIGNATURES``'."""
    src = open(os.path.join(CSRC, "lstm_tp_step_bwd.cu")).read()
    code = re.sub(r"//[^\n]*", "", src)
    assert "for (int p = 1; p < a.G; ++p)" in code
    assert code.count("cg::this_grid().sync()") == 2
    assert "gate_bwd(" in code and "mma_bf16_16816(" in code
    assert "lstm_bwd_f32.cuh" not in code
    decl = re.search(r'extern "C" int tp_step_bwd_dh_launch\(([^)]*)\)', code).group(1)
    kinds = ["int*" if "int*" in a else "int" if re.match(r"\s*int ", a) else "void*"
             for a in decl.split(",")]
    import ctypes
    want = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "int*": ctypes.POINTER(ctypes.c_int)}
    assert _build.SIGNATURES["tp_step_bwd_dh_launch"][1] == [want[k] for k in kinds]
    assert _build.SIGNATURES["tp_step_bwd_dh_smem_bytes"][1] == [ctypes.c_int] * 4


# --- the sum order ------------------------------------------------------------


def _step_inputs(b, n, nd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd: torch.from_numpy((rng.standard_normal(shape) * sd)
                                            .astype(np.float32))
    g = torch.sigmoid(f(b, 4 * nd, sd=1.0))
    return g, f(b, nd, sd=0.5), f(b, nd, sd=0.5), f(b, nd, sd=1.0), f(b, nd, sd=0.3), \
        f(n, 4 * nd, sd=0.2)


def fused_step_replay(g, c2, c_prev, dh, dc, U_c, cfg, blocks):
    """One fused K14 step in the kernel's order: the gate backward, then
    dh_full's G parts (each part's products of round(dg) and U_c summed in
    float64, as the tensor cores' fp32 sums approach them) added in part
    order in fp32 and rounded once to bf16."""
    nd = c2.shape[-1]
    dg, dcp = cell_ops.gate_bwd(g, c2, c_prev, dh, dc, nd, cfg.cell_variant)
    kg = 4 * nd // blocks
    dgx = dg.to(BF16).double()
    parts = [(dgx[:, p * kg:(p + 1) * kg] @ U_c[:, p * kg:(p + 1) * kg].double().T).float()
             for p in range(blocks)]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return dg, dcp, out.to(BF16)


@pytest.mark.parametrize("variant", ["reference", "standard"])
@pytest.mark.parametrize("ndev,nd", [(1, 32), (1, 64), (2, 32), (2, 64), (4, 32), (4, 64)])
def test_fused_order_meets_the_plain_version(variant, ndev, nd):
    """The fused step's order at nd 32-64 and D = 1, 2, 4 (N = D nd), G as
    the plan takes it, against ``tp_step_bwd_plain`` + ``cell_ops.matmul``:
    dg and dc_prev equal, dh_full bf16 and within one bf16 rounding of the
    fp32 product."""
    n = ndev * nd
    cfg = _cfg("bfloat16", n=n, cell_variant=variant)
    g, c2, cp, dh, dc, U = _step_inputs(16, n, nd, seed=3 * nd + ndev)
    U_c = U.to(BF16)
    plan = tc.tp_step_bwd_plan(cfg, 16, n, nd, SMS, SMEM)
    blocks = plan.blocks if plan is not None else 2   # N = 32: any G
    got = fused_step_replay(g, c2, cp, dh, dc, U_c, cfg, blocks)
    want = tc.tp_step_bwd_dh(g, c2, cp, dh, dc, U_c, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].dtype == want[2].dtype == BF16
    exact = cell_ops.matmul(want[0], U_c.T, BF16, FP32)
    for x in (got[2], want[2]):
        np.testing.assert_allclose(x.float().numpy(), exact.numpy(),
                                   rtol=2.0 ** -8, atol=1e-6)


# --- the card path ---------------------------------------------------------------


class _Library:
    """Stands in for the kernels' library: records each call, returns 0,
    counts one launch where the call takes a counter."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name.endswith("_dh_launch"):
                args[-1]._obj.value += 1
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    lib = _Library()
    storages = {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        base = storages.setdefault(key, len(storages) + 1) << 32
        return base + t.storage_offset() * t.element_size()

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tc, "_step_bwd_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(tc, "_card", lambda cfg, dev, nd: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    products = []
    matmul = cell_ops.matmul

    def spy(a, w, *args):
        products.append(tuple(w.shape))
        return matmul(a, w, *args)

    monkeypatch.setattr(cell_ops, "matmul", spy)
    return lib, data_ptr, products


def _backward(dtype, b, n, nd, variant="reference"):
    """``TPStep.backward`` of one step on meta tensors, h_full and U_c in
    the compute type, as ``fused_tp_step`` saves them."""
    cfg = _cfg(dtype, n=n, cell_variant=variant)
    e = lambda *shape, dt=FP32: torch.empty(*shape, dtype=dt, device="meta")
    ctx = types.SimpleNamespace(
        saved_tensors=(e(n, 4 * nd, dt=cfg.cdtype), e(b, 4 * nd), e(b, nd), e(b, nd),
                       e(b, n, dt=cfg.cdtype)),
        cfg=cfg, plain=False, u_dtype=FP32, xw_dtype=FP32)
    return cfg, tc.TPStep.backward(ctx, e(b, nd), e(b, nd))


@pytest.mark.parametrize("variant", ["reference", "standard"])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_backward_takes_the_fused_launch(routed, ndev, variant):
    """Under bf16 compute, where the plan gives a layout: one
    ``tp_step_bwd_dh_launch`` with the plan's G and stages, one launch
    counted; the only product outside is dU's; the returns keep TPStep's
    types (dU in U's, dg in xw's, dh_full in h_full's, dc_prev in
    c_prev's)."""
    lib, ptr, products = routed
    b, n = 128, 1024
    nd = n // ndev
    before = (tc.tp_step_bwd.launches, tc.tp_step_bwd_dh.launches)
    cfg, grads = _backward("bfloat16", b, n, nd, variant)
    plan = tc.tp_step_bwd_plan(cfg, b, n, nd, SMS, SMEM)
    (name, args), = lib.calls
    assert (tc.tp_step_bwd.launches - before[0], tc.tp_step_bwd_dh.launches - before[1]) \
        == (1, 1)
    assert name == "tp_step_bwd_dh_launch"
    # (g, c2, c_prev, dh, dc, U, dg, dc_prev, dh_full, dgx, xbuf, B, N, nd,
    #  standard, G, stages, stream, launched)
    assert args[11:17] == (b, n, nd, int(variant == "standard"), *plan)
    assert args[9] is not None and args[10] is not None
    assert len({args[i] for i in range(11)}) == 11   # eleven distinct buffers
    assert products == [(b, 4 * nd)]   # h_full^T @ dg alone
    dU, _, dg, dh_full, dcp, _, _ = grads
    assert (dU.dtype, dg.dtype, dh_full.dtype, dcp.dtype) == (FP32, FP32, BF16, FP32)
    assert tuple(dh_full.shape) == (b, n)


@pytest.mark.parametrize("dtype,b,ndev", [("bfloat16", 160, 1), ("float32", 128, 1),
                                          ("float32", 128, 2), ("float32", 128, 4),
                                          ("float32", 32, 1)])
def test_refused_shapes_keep_the_first_design(routed, dtype, b, ndev):
    """fp32 compute at the flagship's shards and at SP's 32 rows, and bf16
    past 128 rows: the gate backward's launcher and the products outside
    (dh_full's, then dU's), one launch of K14 counted and none of its
    fused step; dh_full in the compute type."""
    lib, _, products = routed
    n = 1024
    nd = n // ndev
    before = (tc.tp_step_bwd.launches, tc.tp_step_bwd_dh.launches)
    cfg, grads = _backward(dtype, b, n, nd)
    assert [name for name, _ in lib.calls] == ["tp_step_bwd_launch"]
    assert (tc.tp_step_bwd.launches - before[0], tc.tp_step_bwd_dh.launches - before[1]) \
        == (1, 0)
    assert products == [(4 * nd, n), (b, 4 * nd)]
    assert grads[3].dtype == cfg.cdtype and tuple(grads[3].shape) == (b, n)


@pytest.mark.parametrize("variant", ["reference", "standard"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cpu_path_is_the_plain_pair(monkeypatch, dtype, variant):
    """On CPU tensors: ``tp_step_bwd_plain`` then dh_full = round(dg) @
    U_c^T cast to the compute type, no launch, no build."""
    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "load_library", no_build)
    cfg = _cfg(dtype, n=64, cell_variant=variant)
    g, c2, cp, dh, dc, U = _step_inputs(8, 64, 32, seed=5)
    U_c = U.to(cfg.cdtype)
    before = tc.tp_step_bwd.launches
    dg, dcp, dh_full = tc.tp_step_bwd_dh(g, c2, cp, dh, dc, U_c, cfg)
    wdg, wdcp = tc.tp_step_bwd_plain(g, c2, cp, dh, dc, cfg)
    want = cell_ops.matmul(wdg, U_c.T, cfg.cdtype, FP32)
    assert torch.equal(dg, wdg) and torch.equal(dcp, wdcp)
    assert dh_full.dtype == cfg.cdtype and torch.equal(dh_full, want.to(cfg.cdtype))
    assert tc.tp_step_bwd.launches == before
