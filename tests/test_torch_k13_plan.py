"""K13, the per-step tensor-parallel forward (``cuda_tp_cell.tp_step_fwd``):
its choice of design, the launch its card path makes, and how the TP
recurrence hands it U.

Under bf16 compute with at most 128 batch rows K13 is the tensor-core step
of K8/K9's persistent forward (``csrc/fwd_mma.cuh``), a block 16 units of
the shard and ``rows`` batch rows, ``rows`` chosen so that the grid reaches
half the card's SMs; fp32, B > 128 and widths the tiles do not take keep
the CUDA-core design. ``parallel/tp.py:_tp_scan_layer`` casts U to the
compute type once a window and hands that U_c to every step beside U, as
an input autograd does not differentiate: dU still goes to U unrounded,
as the JAX VJP returns it (``pallas_tp_cell.py:152``), where passing only
a differentiable cast would round dU to bf16 through the cast's backward.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. The
gradients are held to the JAX package's ``fused_tp_step`` VJP on the CPU
at the fp32 tolerances of tests/test_torch_tp_kernels.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.ops import pallas_tp_cell as jcell

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc
from eigen_lstm_tpu_torch.parallel import tp as ttp

SMS, SMEM = 132, 232_448
GRAD = dict(rtol=1e-4, atol=1e-6)


def _cfg(dtype="bfloat16", n=1024, **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, **kw)


@pytest.mark.parametrize("ndev,rows", [(1, 64), (2, 32), (4, 16)])
def test_flagship_shards_take_the_tensor_cores(ndev, rows):
    """bf16 at the flagship's --tp shapes (N = 1024, B = 128) as a shard of
    D = 1, 2, 4: the batch split until the grid reaches 66 blocks, so 128
    blocks of 16 units at every D, U_d read 2, 4 and 8 times a step."""
    nd = 1024 // ndev
    assert tc.tp_step_plan(_cfg(), 128, 1024, nd, SMS, SMEM) == rows
    assert nd // ct.PERSIST_UNITS * -(-128 // rows) == 128


def test_a_wide_grid_keeps_every_row_in_a_block():
    """Where nd / 16 blocks reach half the SMs already, a block takes all
    the batch rows and U_d is read once a step."""
    assert tc.tp_step_plan(_cfg(), 128, 1024, 1024, 128, SMEM) == 128
    assert tc.tp_step_plan(_cfg(), 16, 1024, 1024, SMS, SMEM) == 16


@pytest.mark.parametrize("dtype,n,nd,b,smem", [
    ("float32", 1024, 1024, 128, SMEM),    # fp32: TF32 stays off
    ("float32", 1024, 256, 128, SMEM),
    ("bfloat16", 1024, 1024, 160, SMEM),   # more rows than 8 m tiles
    ("bfloat16", 96, 96, 128, SMEM),       # N not a multiple of the k chunk
    ("bfloat16", 1024, 1024, 128, 40_000),  # a ring the block cannot hold
])
def test_cuda_core_design_elsewhere(dtype, n, nd, b, smem):
    assert tc.tp_step_plan(_cfg(dtype, n=n), b, n, nd, SMS, smem) is None


class _Library:
    """Stands in for the kernels' library: records each call, returns 0,
    counts one launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
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
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(tc, "_card", lambda cfg, dev, nd: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr


@pytest.mark.parametrize("dtype,ndev", [("bfloat16", 1), ("bfloat16", 2),
                                        ("bfloat16", 4), ("float32", 1)])
def test_card_path_launches_the_planned_design(routed, dtype, ndev):
    """One call of ``tp_step_fwd_launch`` a step, with the plan's rows in
    bf16 (-1 in fp32), U_c and h_full read in place when they are in the
    compute type already (no cast a step), one launch counted."""
    lib, ptr = routed
    cfg = _cfg(dtype)
    n, b = 1024, 128
    nd = n // ndev
    e = lambda *shape, dt=torch.float32: torch.empty(*shape, dtype=dt, device="meta")
    U_c, h = e(n, 4 * nd, dt=cfg.cdtype), e(b, n, dt=cfg.cdtype)
    xw, c = e(b, 4 * nd), e(b, nd)
    before = tc.tp_step_fwd.launches
    h2, c2, g = tc.tp_step_fwd(U_c, xw, h, c, cfg)
    assert tc.tp_step_fwd.launches - before == 1
    assert [x[0] for x in lib.calls] == ["tp_step_fwd_launch"]
    a = lib.calls[0][1]
    # (ctype, U, xw, h, c_in, h_out, c_out, g_out, B, N, nd, standard,
    #  rows, stream, launched)
    assert a[0] == cuda_cell._TYPE_CODES[cfg.cdtype]
    assert a[1:5] == (ptr(U_c), ptr(xw), ptr(h), ptr(c))
    assert a[5:8] == (ptr(h2), ptr(c2), ptr(g))
    want = tc.tp_step_plan(cfg, b, n, nd, SMS, SMEM)
    assert a[8:13] == (b, n, nd, 0, -1 if want is None else want)
    assert (want is None) == (dtype == "float32")


def _window(s=3, b=8, n=64, seed=6):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd: rng.normal(size=shape).astype(np.float32) * sd
    return (f(n, 4 * n, sd=0.1), f(s, b, 4 * n, sd=0.7), f(b, n, sd=0.3),
            f(b, n, sd=0.3), f(s, b, n, sd=1.0))


def test_tp_scan_layer_casts_U_once_a_window(monkeypatch):
    """The per-step family hands every step of a window one U_c: U in the
    compute type, outside autograd."""
    seen = []
    step = tc.fused_tp_step

    def spy(U, xw, h_full, c_d, cfg, plain=False, U_c=None):
        seen.append(U_c)
        return step(U, xw, h_full, c_d, cfg, plain, U_c)

    monkeypatch.setattr(tc, "fused_tp_step", spy)
    U, xw, h0, c0, _ = (torch.from_numpy(x) for x in _window())
    U.requires_grad_()
    cfg = _cfg(n=U.shape[0])
    layer = LayerParams(torch.zeros(1), U, torch.zeros(1))
    with torch.enable_grad():
        ttp._tp_scan_layer(layer, xw, h0, c0, cfg, None, "pallas", plain=True)
    assert len(seen) == xw.shape[0]
    assert all(x is seen[0] for x in seen)
    assert seen[0].dtype == torch.bfloat16 and not seen[0].requires_grad
    assert torch.equal(seen[0], U.detach().bfloat16())


def _jax_window_dU(U, xw, h0, c0, cot):
    """The JAX ``fused_tp_step`` over the window at D = 1 (h_full = h),
    h and c carried in fp32, and its VJP in U for sum(h_seq * cot)."""
    jcfg = JConfig(hidden=U.shape[0], compute_dtype="bfloat16")

    def loss(U_):
        h, c, total = jnp.asarray(h0), jnp.asarray(c0), 0.0
        for t in range(xw.shape[0]):
            h, c = jcell.fused_tp_step(U_, jnp.asarray(xw[t]), h, c, jcfg)
            total = total + jnp.sum(h * cot[t])
        return total

    return np.asarray(jax.grad(loss)(jnp.asarray(U)))


def test_tp_window_dU_is_the_jax_vjp_s_unrounded():
    """bf16 compute at D = 1: dU of a window through ``_tp_scan_layer``
    (the cast once a window, ``TPStep`` a step) is fp32, not a bf16 value,
    and the JAX VJP's. Were U_c handed to each step as the differentiable
    cast in U's place, dU would come back rounded to bf16 (the last test
    shows it) and fail here."""
    U, xw, h0, c0, cot = _window()
    cfg = _cfg(n=U.shape[0])
    Ut = torch.from_numpy(U).requires_grad_()
    layer = LayerParams(torch.zeros(1), Ut, torch.zeros(1))
    with torch.enable_grad():
        h_seq, _ = ttp._tp_scan_layer(layer, torch.from_numpy(xw),
                                      torch.from_numpy(h0), torch.from_numpy(c0),
                                      cfg, None, "pallas", plain=True)
        (dU,) = torch.autograd.grad((h_seq * torch.from_numpy(cot)).sum(), [Ut])
    assert dU.dtype == torch.float32
    assert not torch.equal(dU, dU.bfloat16().float())
    np.testing.assert_allclose(dU.numpy(), _jax_window_dU(U, xw, h0, c0, cot), **GRAD)


@pytest.mark.parametrize("ndev", [1, 2])
def test_tp_step_dU_with_U_c_matches_jax(ndev):
    """One step of a shard of D = 1, 2 (nd = N, N / 2, the full h) through
    ``fused_tp_step`` with U_c given, as the window hands it: every
    cotangent the JAX VJP's, dU in fp32 and not rounded, dh_full bf16."""
    rng = np.random.default_rng(8 + ndev)
    n, b = 64, 8
    nd = n // ndev
    f = lambda *shape, sd: rng.normal(size=shape).astype(np.float32) * sd
    U, xw, h, c = f(n, 4 * nd, sd=0.1), f(b, 4 * nd, sd=0.7), np.tanh(f(b, n, sd=1.0)), f(b, nd, sd=0.5)
    cots = [f(b, nd, sd=1.0) for _ in range(2)]
    cfg = _cfg(n=n)
    ts = [torch.from_numpy(a).requires_grad_() for a in (U, xw, h, c)]
    U_c = ts[0].detach().bfloat16()
    out = tc.fused_tp_step(*ts, cfg, plain=True, U_c=U_c)
    got = torch.autograd.grad(out, ts, [torch.from_numpy(x) for x in cots])
    jcfg = JConfig(hidden=n, compute_dtype="bfloat16")
    jout, vjp = jax.vjp(lambda *a: jcell.fused_tp_step(*a, jcfg),
                        *map(jnp.asarray, (U, xw, h, c)))
    want = vjp(tuple(jnp.asarray(x) for x in cots))
    for name, a, w in zip("U xw h_full c_d".split(), got, want):
        np.testing.assert_allclose(a.double().numpy(), np.asarray(w, np.float64),
                                   **GRAD, err_msg=name)
    assert got[0].dtype == torch.float32
    assert not torch.equal(got[0], got[0].bfloat16().float())
    assert torch.equal(got[2].float(), got[2].float().bfloat16().float())


def test_passing_U_c_alone_rounds_dU():
    """The trap the extra input avoids: a differentiable cast handed to
    ``TPStep`` in U's place sends dU back through the cast's backward,
    rounded to bf16, away from the JAX VJP's fp32 dU."""
    rng = np.random.default_rng(12)
    n, b = 64, 8
    f = lambda *shape, sd: rng.normal(size=shape).astype(np.float32) * sd
    U, xw, h, c = f(n, 4 * n, sd=0.1), f(b, 4 * n, sd=0.7), np.tanh(f(b, n, sd=1.0)), f(b, n, sd=0.5)
    cfg = _cfg(n=n)
    Ut = torch.from_numpy(U).requires_grad_()
    args = [torch.from_numpy(x) for x in (xw, h, c)]
    with torch.enable_grad():
        right = tc.TPStep.apply(Ut, Ut.detach().bfloat16(), *args, cfg, True)
        (dU_right,) = torch.autograd.grad(right[0].sum(), [Ut])
        cast = Ut.bfloat16()
        wrong = tc.TPStep.apply(cast, cast.detach(), *args, cfg, True)
        (dU_wrong,) = torch.autograd.grad(wrong[0].sum(), [Ut])
    assert torch.equal(dU_wrong, dU_right.bfloat16().float())
    assert not torch.equal(dU_wrong, dU_right)
