"""The port's tensor-parallel kernel modules against the JAX package, on the
CPU: ``ops/cuda_tp_cell.py`` (K13, K14 and ``TPStep``) against
``pallas_tp_cell.py``'s ``_fwd_math``, ``_bwd_math`` and ``fused_tp_step``,
and ``ops/cuda_tp_seq.py`` (K15, K16 and ``TPSeq``) at D = 1 against
``pallas_tp_seq.py:tp_seq_lstm``, whose Pallas kernels run here in
interpret mode as ``tests/test_tp_seq.py`` runs them; then the wrappers'
rules on the card (a CUDA tensor launches or raises, at any D), with a
stand-in CUDA tensor.

Tolerances: fp32 rtol 1e-5 / atol 1e-6 on the forward, 1e-4 / 1e-6 on the
gradients (``tests/test_tp.py``). float64: the JAX functions compute in
float32 (``_fwd_math`` casts xw and accumulates in float32), the port's
plain versions in float64, so float64 is held to JAX at the fp32
tolerances and to a numpy float64 formula at 1e-12; the JAX window kernel
does not run under x64 (its grid index meets an int64 in interpret mode),
so the float64 window is held to the JAX fp32 run at the fp32 tolerances
and to the port's own float64 ``"xla"`` TP scan at 1e-10. bf16: both round h
and U to bf16 and sum in fp32 in another order, so a bf16 rounding of h
can flip between steps of the window: rtol 2e-2 / atol 2^-9 there (the
sampler tests' rule), exact on a single step. Each family's bf16 values
are checked exactly: ``TPStep`` hands dh_full back in bf16 and dU in
fp32, ``TPSeq`` dU in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.ops import pallas_tp_cell as jcell
from eigen_lstm_tpu.ops import pallas_tp_seq as jseq

from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tcell
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as tseq
from eigen_lstm_tpu_torch.parallel import tp as ttp
from eigen_lstm_tpu_torch.parallel.mesh import TPGroup

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
BF16_WINDOW = dict(rtol=2e-2, atol=2.0 ** -9)
B, N = 8, 128
VARIANTS = ("reference", "standard")


def _cfgs(dtype, variant, **kw):
    pd = "float64" if dtype == "float64" else "float32"
    both = dict(hidden=N, compute_dtype=dtype, param_dtype=pd,
                cell_variant=variant, **kw)
    return TConfig(**both), JConfig(**both)


def _np(x):
    return np.asarray(x, dtype=np.float64) if not isinstance(x, torch.Tensor) \
        else x.detach().double().numpy()


def _step_inputs(nd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    ft = np.float64 if dtype == "float64" else np.float32
    return (rng.normal(size=(N, 4 * nd)).astype(ft) * 0.1,
            rng.normal(size=(B, 4 * nd)).astype(ft) * 0.7,
            np.tanh(rng.normal(size=(B, N))).astype(ft),
            rng.normal(size=(B, nd)).astype(ft) * 0.5)


@pytest.fixture()
def maybe_x64(request):
    """float64 needs JAX's x64 mode (not the window test's: see above)."""
    on = "float64" in request.node.name and "tp_seq" not in request.node.name
    if on:
        jax.config.update("jax_enable_x64", True)
    yield
    if on:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("nd", [N, N // 4])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_tp_step_plain_matches_jax_fwd_math(maybe_x64, dtype, variant, nd):
    """K13's plain version against ``_fwd_math`` at D = 1 (nd = N) and at a
    D = 4 shard (nd = N / 4, the full h): h2, c2 and the activated g."""
    tcfg, jcfg = _cfgs(dtype, variant)
    U, xw, h, c = _step_inputs(nd, dtype)
    hc = torch.from_numpy(h).to(tcfg.cdtype)
    got = tcell.tp_step_plain(*map(torch.from_numpy, (U, xw)), hc,
                              torch.from_numpy(c), tcfg)
    want = jcell._fwd_math(jnp.asarray(U), jnp.asarray(xw),
                           jnp.asarray(h).astype(jcfg.cdtype), jnp.asarray(c),
                           nd, variant, jcfg.cdtype)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    if dtype == "float64":
        # the numpy float64 formula
        g = xw + h @ U
        s = 1.0 / (1.0 + np.exp(-g[:, :3 * nd]))
        i, o, f, u = s[:, :nd], s[:, nd:2 * nd], s[:, 2 * nd:], np.tanh(g[:, 3 * nd:])
        c_raw = i * u + f * c
        h2 = o * np.tanh(c_raw)
        c2 = np.tanh(c_raw) if variant == "reference" else c_raw
        for a, b in zip(got, (h2, c2, np.concatenate([s, u], 1))):
            np.testing.assert_allclose(_np(a), b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tp_step_bwd_plain_matches_jax_bwd_math(maybe_x64, dtype, variant):
    """K14's plain version against ``_bwd_math``: dg and dc_prev."""
    tcfg, _ = _cfgs(dtype, variant)
    nd = N // 2
    rng = np.random.default_rng(1)
    ft = np.float64 if dtype == "float64" else np.float32
    g = np.concatenate([1 / (1 + np.exp(-rng.normal(size=(B, 3 * nd)))),
                        np.tanh(rng.normal(size=(B, nd)))], 1).astype(ft)
    c2, cp, dh, dc = (rng.normal(size=(B, nd)).astype(ft) * 0.5 for _ in range(4))
    c2 = np.tanh(c2) if variant == "reference" else c2
    got = tcell.tp_step_bwd_plain(*map(torch.from_numpy, (g, c2, cp, dh, dc)), tcfg)
    want = jcell._bwd_math(*map(jnp.asarray, (g, c2, cp, dh, dc)), nd, variant)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_tp_step_vjp_matches_jax(maybe_x64, dtype, variant):
    """``fused_tp_step`` through ``TPStep`` (K13, K14's plain versions and
    the two products outside) against ``jax.vjp`` of the JAX
    ``fused_tp_step``: (h2, c2) and the cotangents of U, xw, h_full and
    c_d; in bf16 dh_full is a bf16 value and dU is not, in both."""
    tcfg, jcfg = _cfgs(dtype, variant)
    nd = N // 2
    U, xw, h, c = _step_inputs(nd, dtype, seed=2)
    rng = np.random.default_rng(3)
    cots = [rng.normal(size=(B, nd)).astype(U.dtype) for _ in range(2)]
    ts = [torch.from_numpy(a).requires_grad_() for a in (U, xw, h, c)]
    out = tcell.fused_tp_step(*ts, tcfg, plain=True)
    got = torch.autograd.grad(out, ts, [torch.from_numpy(x) for x in cots])
    jout, vjp = jax.vjp(lambda *a: jcell.fused_tp_step(*a, jcfg),
                        *map(jnp.asarray, (U, xw, h, c)))
    want = vjp(tuple(jnp.asarray(x, o.dtype) for x, o in zip(cots, jout)))
    for a, b in zip(out, jout):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    for name, a, b in zip("U xw h_full c_d".split(), got, want):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD, err_msg=name)
    if dtype == "bfloat16":
        for x in (got[2], want[2]):   # dh_full: bf16 values
            x = torch.tensor(np.asarray(x, np.float32))
            assert torch.equal(x, x.bfloat16().float())
        for x in (got[0], want[0]):   # dU: fp32, not rounded
            x = torch.tensor(np.asarray(x, np.float32))
            assert not torch.equal(x, x.bfloat16().float())


def _seq_inputs(s, dtype, seed=4):
    rng = np.random.default_rng(seed)
    ft = np.float64 if dtype == "float64" else np.float32
    return (rng.normal(size=(N, 4 * N)).astype(ft) * 0.08,
            rng.normal(size=(s, B, 4 * N)).astype(ft) * 0.7,
            (rng.normal(size=(B, N)) * 0.3).astype(ft),
            (rng.normal(size=(B, N)) * 0.3).astype(ft))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype,residual", [
    ("float32", "float32"), ("float32", "bfloat16"), ("float64", "float64"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_tp_seq_matches_jax_tp_seq_lstm(maybe_x64, dtype, residual, variant):
    """``tp_seq_lstm`` at D = 1 through ``TPSeq`` (K15, K16's plain
    versions) against the JAX ``tp_seq_lstm`` (its Pallas kernels in
    interpret mode) over a 5-step window: h_seq, hT, cT and the cotangents
    of U, xw, h0, c0; in bf16 dU is a bf16 value in both."""
    s = 5
    tcfg, jcfg = _cfgs(dtype, variant, residual_dtype=residual)
    U, xw, h0, c0 = _seq_inputs(s, dtype)
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=x).astype(U.dtype) for x in ((s, B, N), (B, N), (B, N))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (U, xw, h0, c0)]
    h_seq, (hT, cT) = tseq.tp_seq_lstm(*ts, tcfg, plain=True)
    got = torch.autograd.grad((h_seq, hT, cT), ts, [torch.from_numpy(x) for x in cots])
    if dtype == "float64":
        # the port's own float64 TP scan, then JAX in fp32
        layer = tmodel.LayerParams(None, ts[0], None)
        xs, (xT, xcT) = ttp._tp_scan_layer(layer, ts[1], ts[2], ts[3], tcfg, None)
        ref = torch.autograd.grad((xs, xT, xcT), ts, [torch.from_numpy(x) for x in cots])
        for a, b in zip((h_seq, hT, cT) + got, (xs, xT, xcT) + ref):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-10, atol=1e-12)
        jcfg = _cfgs("float32", variant)[1]
        U, xw, h0, c0, *cots = (a.astype(np.float32) for a in (U, xw, h0, c0, *cots))
    jout, vjp = jax.vjp(
        lambda *a: jseq.tp_seq_lstm(*a, jcfg, "model", 1), *map(jnp.asarray, (U, xw, h0, c0)))
    want = vjp((jnp.asarray(cots[0]), (jnp.asarray(cots[1]), jnp.asarray(cots[2]))))
    fwd_tol = BF16_WINDOW if dtype == "bfloat16" else F32
    grad_tol = BF16_WINDOW if dtype == "bfloat16" else GRAD
    for a, b in zip((h_seq, hT, cT), (jout[0], *jout[1])):
        np.testing.assert_allclose(_np(a), _np(b), **fwd_tol)
    for name, a, b in zip("U xw h0 c0".split(), got, want):
        np.testing.assert_allclose(_np(a), _np(b), **grad_tol, err_msg=name)
    if dtype == "bfloat16":
        for x in (got[0], want[0]):
            x = torch.tensor(np.asarray(x, np.float32))
            assert torch.equal(x, x.bfloat16().float())


def test_tp_seq_single_step_is_tp_step():
    """At S = 1 the window is one step: K15's plain version equals K13's
    bit for bit, and K16's gives K14's dg and dc with dh0 = round(dg) @
    U^T."""
    tcfg, _ = _cfgs("bfloat16", "reference")
    U, xw, h0, c0 = (torch.from_numpy(a) for a in _seq_inputs(1, "float32"))
    Uc = U.bfloat16()
    h_seq, g, cp, hT, cT = tseq.tp_seq_fwd_plain(Uc, xw, h0, c0, tcfg)
    h2, c2, g2 = tcell.tp_step_plain(Uc, xw[0], h0.bfloat16(), c0, tcfg)
    for a, b in ((h_seq[0], h2), (g[0], g2), (hT, h2), (cT, c2), (cp[0], c0)):
        assert torch.equal(a, b)
    dh, dhT, dcT = torch.randn(1, B, N), torch.randn(B, N), torch.randn(B, N)
    dg, dh0, dc0 = tseq.tp_seq_bwd_plain(Uc, g, cp, cT, dh, dhT, dcT, tcfg)
    dg2, dc2 = tcell.tp_step_bwd_plain(g2, c2, c0, dh[0] + dhT, dcT, tcfg)
    assert torch.equal(dg[0], dg2) and torch.equal(dc0, dc2)
    assert torch.equal(dh0, dg2.bfloat16().float() @ Uc.float().T)


class FakeCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


def _fake(*xs):
    return [x.as_subclass(FakeCuda) for x in xs]


def test_wrappers_run_plain_on_the_cpu_without_a_launch(monkeypatch):
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch; it never builds the kernels."""
    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(tcell._build, "load_library", no_build)
    tcfg, _ = _cfgs("float32", "reference")
    before = (tcell.tp_step_fwd.launches, tcell.tp_step_bwd.launches,
              tseq.tp_seq_fwd.launches, tseq.tp_seq_bwd.launches)
    U, xw, h, c = map(torch.from_numpy, _step_inputs(N, "float32"))
    for a, b in zip(tcell.tp_step_fwd(U, xw, h, c, tcfg),
                    tcell.tp_step_plain(U, xw, h, c, tcfg)):
        assert torch.equal(a, b)
    h2, c2, g = tcell.tp_step_plain(U, xw, h, c, tcfg)
    for a, b in zip(tcell.tp_step_bwd(g, c2, c, h2, c2, tcfg),
                    tcell.tp_step_bwd_plain(g, c2, c, h2, c2, tcfg)):
        assert torch.equal(a, b)
    Us, xs, h0, c0 = map(torch.from_numpy, _seq_inputs(3, "float32"))
    fwd = tseq.tp_seq_fwd(Us, xs, h0, c0, tcfg)
    for a, b in zip(fwd, tseq.tp_seq_fwd_plain(Us, xs, h0, c0, tcfg)):
        assert torch.equal(a, b)
    dh = torch.ones(3, B, N)
    for a, b in zip(tseq.tp_seq_bwd(Us, fwd[1], fwd[2], fwd[4], dh, h0, c0, tcfg),
                    tseq.tp_seq_bwd_plain(Us, fwd[1], fwd[2], fwd[4], dh, h0, c0, tcfg)):
        assert torch.equal(a, b)
    assert before == (tcell.tp_step_fwd.launches, tcell.tp_step_bwd.launches,
                      tseq.tp_seq_fwd.launches, tseq.tp_seq_bwd.launches)


def test_the_card_launches_or_raises(monkeypatch):
    """On a CUDA tensor each wrapper reaches its kernel's launcher (stubbed
    to raise) and never its plain version, K15 / K16 at D > 1 too (their
    exchange design, through the group's buffers); a float64 model and a
    shard width off the 32-unit tile raise before any build."""
    def launcher():
        raise RuntimeError("launcher reached")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(tcell._build, "load_library", launcher)
    for mod, name in ((tcell, "tp_step_plain"), (tcell, "tp_step_bwd_plain"),
                      (tseq, "tp_seq_fwd_plain"), (tseq, "tp_seq_bwd_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    tcfg, _ = _cfgs("bfloat16", "reference")
    U, xw, h, c = _fake(*map(torch.from_numpy, _step_inputs(N, "float32")))
    g = _fake(torch.zeros(B, 4 * N))[0]
    Us, xs, h0, c0 = _fake(*map(torch.from_numpy, _seq_inputs(3, "float32")))
    dh = _fake(torch.zeros(3, B, N))[0]
    calls = [lambda cfg, grp: tcell.tp_step_fwd(U, xw, h, c, cfg),
             lambda cfg, grp: tcell.tp_step_bwd(g, c, c, c, c, cfg),
             lambda cfg, grp: tseq.tp_seq_fwd(Us, xs, h0, c0, cfg, grp),
             lambda cfg, grp: tseq.tp_seq_bwd(Us, xs, dh, c0, dh, h0, c0, cfg, grp)]
    for call in calls:
        with pytest.raises(RuntimeError, match="launcher reached"):
            call(tcfg, None)
        with pytest.raises(TypeError, match="float32/bfloat16"):
            call(_cfgs("float64", "reference")[0], None)
    two = TPGroup(rank=0, size=2, device=torch.device("cuda"))
    for call in calls[2:]:
        with pytest.raises(RuntimeError, match="launcher reached"):
            call(tcfg, two)
        with pytest.raises(TypeError, match="float32/bfloat16"):
            call(_cfgs("float64", "reference")[0], two)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        tcell.tp_step_fwd(*_fake(*map(torch.from_numpy, _step_inputs(48, "float32"))),
                          tcfg)
