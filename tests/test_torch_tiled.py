"""The tiled-U path of the port (``eigen_lstm_tpu_torch/ops/cuda_cell_tiled.py``
and the family choice of ``ops/dispatch.py``) on CPU tensors, where K8, K9
and K10 run their plain versions, against the JAX package's tiled Pallas
kernels (``pallas_cell_tiled.py``) in interpret mode, on the same numpy
inputs.

* The functions: ``pallas_tiled_embed_layer0`` and
  ``pallas_tiled_scan_layer`` with wt = 128 at S = 6, B = 8, N = 256 (the
  shapes of tests/test_pallas_cell_tiled.py:20-21), both cell variants,
  dropout 0 and 0.35 with a negative int32 seed: the output stream, hT, cT
  and every gradient of their VJPs against the port's autograd functions;
  layer 0's db at S = 1.
* The slice as a whole: ``loss_fn`` and every gradient of a 2x2048 bf16
  model with bf16 residuals and of a 2x1024 fp32 model, S = 3, B = 8,
  through the port's ``select_cell_fn("auto", device="cpu")`` against the
  JAX ``loss_fn`` through ``select_cell_fn("pallas", cfg, 8,
  interpret=True)``, which takes the tiled kernels at both.
* The family choice: the port's equals the JAX dispatch's on a grid.
* The build compiles ``lstm_tiled.cu``.

Tolerances (tests/test_pallas_cell.py:60-87, as the port's other tests):
float32 rtol 1e-5 / atol 1e-6 on the streams and the loss, rtol 2e-4 /
atol 1e-6 on the gradients. float64, which the JAX tiled path runs in
fp32 (fp32 products and residuals), at the float32 tolerances. bfloat16:
streams within atol 2e-2, the loss within rtol 1e-4, each gradient within
2e-2 of its largest magnitude (both sides round h and dg to bf16, and a
float32 sum taken in another order can flip one rounding, which the
recurrence carries), and each gradient a bf16 value exactly where the JAX
VJP's is. db at S = 1: within 1e-5 of its largest magnitude in at least
99 % of its columns (tests/test_torch_layer0_db.py says why).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops import dispatch as jdispatch
from eigen_lstm_tpu.ops import pallas_cell as jpc
from eigen_lstm_tpu.ops.pallas_cell_tiled import (
    pallas_tiled_embed_layer0,
    pallas_tiled_scan_layer,
)
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import _build, cuda_cell, cuda_cell_bwd, dispatch
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

S, B, N, M, WT = 6, 8, 256, 256, 128
RATE, SEED = 0.35, -987654321
FP32_VAL = dict(rtol=1e-5, atol=1e-6)
FP32_GRAD = dict(rtol=2e-4, atol=1e-6)
BF16_ATOL, BF16_FRAC = 2e-2, 2e-2
DB_FRAC, DB_COLUMNS = 1e-5, 0.99


def db_columns_within(got, want) -> float:
    """The share of db's columns within DB_FRAC of its largest magnitude
    of the reference's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= DB_FRAC * np.abs(want).max()).mean())


def _layer(in_dim, seed, s=S, n=N):
    """Weights that make the gates move (std 0.3, U scaled by 4/sqrt(N)),
    (h0, c0), the inputs and the cotangents of the outputs."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(in_dim, 4 * n)) * 0.3
    U = rng.normal(size=(n, 4 * n)) * 0.3 / np.sqrt(n / 16)
    b = rng.normal(size=(4 * n,)) * 0.3
    h0, c0 = (rng.normal(size=(B, n)) * 0.5 for _ in range(2))
    xw = rng.normal(size=(s, B, 4 * n))
    ids = rng.integers(0, M, (s, B)).astype(np.int32)
    dh = rng.normal(size=(s, B, n))
    dhT, dcT = (rng.normal(size=(B, n)) for _ in range(2))
    return W, U, b, h0, c0, xw, ids, dh, dhT, dcT


def _bf16_valued(x) -> bool:
    t = torch.from_numpy(np.array(x, np.float32))
    return bool((t.bfloat16().float() == t).all())


def _close_grad(got, want, dtype, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "bfloat16":
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_FRAC, (what, err)
        assert _bf16_valued(got) == _bf16_valued(want), what
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **FP32_GRAD)


def _run_both(dtype, variant, embed, drop, s=S, residual="float32", n=N,
              plain=True):
    """The JAX tiled function's outputs and VJP, and the port's autograd
    function's (its plain versions, or with ``plain`` False its wrappers,
    which run them on the CPU), on the same inputs. Returns (JAX, port)
    pairs of (output stream, hT, cT, gradients)."""
    W, U, b, h0, c0, xw, ids, dh, dhT, dcT = _layer(M if embed else n, 1, s, n)
    kw = dict(vocab=M, hidden=n, cell_variant=variant, compute_dtype=dtype,
              residual_dtype=residual,
              param_dtype="float64" if dtype == "float64" else "float32")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    ft = np.float64 if dtype == "float64" else np.float32
    W, U, b, h0, c0, xw, dh, dhT, dcT = (a.astype(ft) for a in
                                         (W, U, b, h0, c0, xw, dh, dhT, dcT))
    jdrop = (drop, jnp.asarray([SEED], jnp.int32)) if drop else None
    tdrop = (drop, SEED) if drop else None
    if embed:
        def f(W, U, b, h0, c0):
            return pallas_tiled_embed_layer0(
                jmodel.LayerParams(W, U, b), jnp.asarray(ids), h0, c0, jcfg,
                wt=WT, dropout=jdrop)
        jargs = (W, U, b, h0, c0)
    else:
        def f(U, xw, h0, c0):
            return pallas_tiled_scan_layer(
                jmodel.LayerParams(jnp.asarray(W), U, jnp.asarray(b)), xw,
                h0, c0, jcfg, wt=WT, dropout=jdrop)
        jargs = (U, xw, h0, c0)
    (jh, (jhT, jcT)), vjp = jax.vjp(f, *map(jnp.asarray, jargs))
    jg = vjp((jnp.asarray(dh).astype(jh.dtype),
              (jnp.asarray(dhT), jnp.asarray(dcT))))

    leaves = [torch.from_numpy(a).requires_grad_() for a in jargs]
    if embed:
        th, (thT, tcT) = ct.differentiable_tiled_embed_layer0(
            tmodel.LayerParams(*leaves[:3]), torch.from_numpy(ids), leaves[3],
            leaves[4], tcfg, dropout=tdrop, plain=plain)
    else:
        layer = tmodel.LayerParams(torch.from_numpy(W), leaves[0],
                                   torch.from_numpy(b))
        th, (thT, tcT) = ct.differentiable_tiled_scan_layer(
            layer, leaves[1], leaves[2], leaves[3], tcfg, dropout=tdrop,
            plain=plain)
    obj = ((th.to(leaves[0].dtype) * torch.from_numpy(dh)).sum()
           + (thT * torch.from_numpy(dhT)).sum()
           + (tcT * torch.from_numpy(dcT)).sum())
    tg = torch.autograd.grad(obj, leaves)
    return (jh, jhT, jcT, jg), (th.detach(), thT.detach(), tcT.detach(), tg)


def _compare(dtype, variant, embed, drop, plain=True):
    """bf16 with bf16 residuals, as 5b runs; the rest with fp32 ones."""
    residual = "bfloat16" if dtype == "bfloat16" else "float32"
    (jh, jhT, jcT, jg), (th, thT, tcT, tg) = _run_both(
        dtype, variant, embed, drop, residual=residual, plain=plain)
    assert th.dtype == getattr(torch, residual)      # the residual type
    assert np.dtype(jh.dtype).name == residual
    val = FP32_VAL if dtype != "bfloat16" else dict(rtol=0, atol=BF16_ATOL)
    for got, want in ((th, jh), (thT, jhT), (tcT, jcT)):
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(want, np.float64), **val)
    names = ("dW", "dU", "db", "dh0", "dc0") if embed else ("dU", "dxw", "dh0", "dc0")
    for g, w, what in zip(tg, jg, names):
        assert g.shape == tuple(w.shape), what
        _close_grad(g.numpy(), w, dtype, what)


@pytest.mark.parametrize("drop", [0.0, RATE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_tiled_embed_layer0_matches_pallas(variant, dtype, drop):
    """K8's plain version and K10's through ``TiledEmbedLayer0`` against
    ``pallas_tiled_embed_layer0`` and its VJP: the stream (masked under
    dropout), hT, cT, dW, dU, db, dh0, dc0."""
    _compare(dtype, variant, embed=True, drop=drop)


@pytest.mark.parametrize("drop", [0.0, RATE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_tiled_scan_layer_matches_pallas(variant, dtype, drop):
    """K9's plain version and K10's through ``TiledScanLayer`` against
    ``pallas_tiled_scan_layer`` and its VJP: the stream, hT, cT, dU, dxw
    (the dg sequence in the xw type), dh0, dc0."""
    _compare(dtype, variant, embed=False, drop=drop)


@pytest.mark.parametrize("embed", [True, False])
def test_tiled_layers_match_pallas_float64(x64, embed):
    """float64 compute: the JAX tiled path takes it with fp32 products
    and residuals, and so does the port's."""
    _compare("float64", "reference", embed, RATE)


def test_tiled_layer0_db_sums_the_rounded_dg():
    """Layer 0's db at S = 1, bf16, bf16 residuals: the fp32 sum of dg
    rounded to bf16, within 1e-5 of its largest magnitude of the JAX tiled
    VJP's in 99 % of its columns. The resident K3's fused-VJP rule (the
    fp32 dg, the fp32 cotangent) misses in most of them."""
    (_, _, _, jg), (_, _, _, tg) = _run_both("bfloat16", "reference", True,
                                             0.0, s=1, residual="bfloat16")
    db_j = np.asarray(jg[2], np.float64)
    share = db_columns_within(tg[2].numpy(), db_j)
    assert share >= DB_COLUMNS, share
    W, U, b, h0, c0, _, ids, dh, dhT, dcT = _layer(M, 1, 1)
    cfg = TConfig(vocab=M, hidden=N, compute_dtype="bfloat16",
                  residual_dtype="bfloat16")
    leaves = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
              for a in (W, U, b)]
    h, (hT, cT) = cuda_cell_bwd.differentiable_embed_layer0(
        tmodel.LayerParams(*leaves), torch.from_numpy(ids),
        torch.from_numpy(h0.astype(np.float32)),
        torch.from_numpy(c0.astype(np.float32)), cfg, plain=True,
        fused_accum=True)
    obj = ((h.float() * torch.from_numpy(dh.astype(np.float32))).sum()
           + (hT * torch.from_numpy(dhT.astype(np.float32))).sum()
           + (cT * torch.from_numpy(dcT.astype(np.float32))).sum())
    db_fused = torch.autograd.grad(obj, leaves[2])[0].double().numpy()
    assert db_columns_within(db_fused, db_j) < 0.5


def _model_arrays(L, n, seed):
    """npz-keyed parameters that make the gates move, a window and a
    stream state."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for l in range(L):
        arrays[f"params.layers[{l}].W"] = rng.normal(size=(M if l == 0 else n, 4 * n)) * 0.2
        arrays[f"params.layers[{l}].U"] = rng.normal(size=(n, 4 * n)) * 0.2 / np.sqrt(n / 16)
        arrays[f"params.layers[{l}].b"] = rng.normal(size=(4 * n,)) * 0.2
    arrays["params.Why"] = rng.normal(size=(n, M)) * 0.2
    arrays["params.by"] = rng.normal(size=(M,)) * 0.2
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    win = rng.integers(0, M, (4, B)).astype(np.int32)
    h, c = ((rng.normal(size=(L, B, n)) * 0.3).astype(np.float32) for _ in range(2))
    return arrays, win, h, c


def _loss_both(n, dtype, residual, drop):
    """loss_fn and every gradient of a 2-layer model at S = 3, B = 8: JAX
    through its own dispatch (interpret mode), the port through its own
    (plain versions); both must pick the tiled family."""
    L = 2
    arrays, win, h, c = _model_arrays(L, n, 5)
    kw = dict(vocab=M, hidden=n, num_layers=L, loss_mode="all",
              compute_dtype=dtype, residual_dtype=residual, dropout=drop)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jcell = jdispatch.select_cell_fn("pallas", jcfg, B, interpret=True)
    assert jcell.func is pallas_tiled_scan_layer
    assert jcell.embed_layer0 is pallas_tiled_embed_layer0
    tcell = dispatch.select_cell_fn("auto", tcfg, B, "cpu")
    assert tcell.func is ct.differentiable_tiled_scan_layer
    assert tcell.embed_layer0.func is ct.differentiable_tiled_embed_layer0
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    dkey = jax.random.PRNGKey(23) if drop else None
    seeds = (tuple(int(np.asarray(jmodel._drop_seed(dkey, l))[0])
                   for l in range(L)) if drop else None)

    def f(p):
        return jmodel.loss_fn(p, jnp.asarray(win[:-1]), jnp.asarray(win[1:]),
                              jnp.asarray(h), jnp.asarray(c), jcfg, jcell,
                              dkey)

    (jl, _), jg = jax.value_and_grad(f, has_aux=True)(jp)
    tl, _, _, tg = loss_and_grads(
        tckpt.params_from_numpy(arrays, tcfg, "cpu"),
        torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
        torch.from_numpy(h), torch.from_numpy(c), tcfg, tcell, seeds)
    jflat = jckpt._flatten(jg, "params")
    tflat = {k: v.numpy() for k, v in tg.named_tensors()}
    assert sorted(tflat) == sorted(jflat) and len(tflat) == 3 * L + 2
    return float(jl), jflat, float(tl), tflat


@pytest.mark.parametrize("drop", [0.0, RATE])
def test_two_layers_of_2048_bf16_match_jax(drop):
    """The 5b widths at depth 2, bf16 with bf16 residuals: K8, K9, K10
    (plain) and the head through ``loss_fn``, the loss and all eight
    gradients, each a bf16 value exactly where the JAX VJP's is (dW, dU
    and dWhy rounded; db, dby not)."""
    jl, jg, tl, tg = _loss_both(2048, "bfloat16", "bfloat16", drop)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for key in jg:
        _close_grad(tg[key], jg[key], "bfloat16", key)
        want = key.rsplit(".", 1)[-1] in ("W", "U", "Why")
        assert _bf16_valued(jg[key]) == want, key


@pytest.mark.parametrize("drop", [0.0, RATE])
def test_two_layers_of_1024_fp32_match_jax(drop):
    """fp32 at N = 1024, where U (16 MB) takes the tiled kernels in the
    JAX package (the flagship's fp32 steps): the loss and all eight
    gradients."""
    jl, jg, tl, tg = _loss_both(1024, "float32", "float32", drop)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], err_msg=key, **FP32_GRAD)


def _jax_families(jcfg, batch):
    """What the JAX ``select_cell_fn`` returns, read as the port's
    ``dispatch.families`` names it; the fused-accumulation choice of
    ``pallas_embed_layer0``'s VJP read from the closure it builds."""
    cell = jdispatch.select_cell_fn("auto", jcfg, batch, interpret=True)
    if cell is None:
        return "xla", "xla"
    scan = {jpc.pallas_scan_layer: "resident",
            pallas_tiled_scan_layer: "tiled"}[cell.func]
    embed = getattr(cell, "embed_layer0", None)
    if embed is pallas_tiled_embed_layer0:
        return scan, "tiled_embed"
    if embed is None:
        return scan, None
    assert embed is jpc.pallas_embed_layer0
    rd = "float32" if jcfg.residual_dtype == "float32" else "bfloat16"
    fn = jpc._make_fused_embed_seq(2, batch, jcfg.hidden, jcfg.vocab,
                                   jcfg.cell_variant, jcfg.compute_dtype, rd,
                                   True)
    core = inspect.getclosurevars(fn.bwd).nonlocals["_bwd_core"]
    fused = inspect.getclosurevars(core).nonlocals["fused_accum_ok"]
    return scan, "embed_fused" if fused else "embed_fallback"


GRID = [
    # (hidden, batch, compute, residual, dropout, vocab)
    (2048, 128, "bfloat16", "bfloat16", 0.0, 256),    # 5b
    (2048, 16, "bfloat16", "bfloat16", 0.0, 256),     # 5b at the eval batch
    (2048, 128, "bfloat16", "bfloat16", RATE, 256),
    (1024, 128, "bfloat16", "float32", 0.0, 256),     # the flagship, bf16
    (1024, 128, "float32", "float32", RATE, 256),     # the flagship, fp32
    (512, 128, "bfloat16", "float32", 0.0, 256),      # the bench
    (2048, 128, "bfloat16", "float32", 0.0, 256),     # XLA in JAX
    (1024, 256, "bfloat16", "float32", 0.0, 256),
    (1024, 8, "bfloat16", "float32", 0.0, 256),
    (512, 128, "float32", "float32", 0.0, 256),
    (256, 8, "float32", "float32", 0.0, 64),
    (256, 12, "float32", "float32", 0.0, 256),
    (100, 16, "float32", "float32", 0.0, 256),
]


@pytest.mark.parametrize("n,batch,dtype,residual,drop,vocab", GRID)
def test_family_choice_equals_the_jax_dispatch(n, batch, dtype, residual,
                                               drop, vocab):
    kw = dict(vocab=vocab, hidden=n, compute_dtype=dtype,
              residual_dtype=residual, dropout=drop)
    want = _jax_families(JConfig(**kw), batch)
    tcfg = TConfig(**kw)
    assert dispatch.families(tcfg, batch) == want
    cell = dispatch.select_cell_fn("plain", tcfg, batch, "cpu")
    scan, embed = want if want[0] != "xla" else ("resident", "embed_fused")
    assert cell.func is {"resident": cuda_cell_bwd.differentiable_scan_layer,
                         "tiled": ct.differentiable_tiled_scan_layer}[scan]
    if embed is None:
        assert not hasattr(cell, "embed_layer0")
    elif embed == "tiled_embed":
        assert cell.embed_layer0.func is ct.differentiable_tiled_embed_layer0
    else:
        assert cell.embed_layer0.func is cuda_cell_bwd.differentiable_embed_layer0
        # the VJP is chosen at each call, from the rows it sees (this
        # batch here); bound only where the JAX package takes the XLA scan
        kw = cell.embed_layer0.keywords
        assert ("fused_accum" in kw) == (want[0] == "xla")
        assert cuda_cell_bwd.layer0_fused_accum(
            tcfg, batch, kw.get("fused_accum")) == (embed == "embed_fused")
    assert cell.fused_dropout and cell.keywords == {"plain": True}


def test_build_lists_the_tiled_source():
    import os

    assert "lstm_tiled.cu" in [os.path.basename(p) for p in _build.sources()]
    for name in ("tiled_fwd_embed_launch", "tiled_fwd_scan_launch",
                 "tiled_bwd_launch"):
        assert name in _build.SIGNATURES


def test_tiled_wrappers_run_plain_on_cpu_and_refuse_bad_inputs():
    """A CPU tensor runs the plain version and launches nothing; the
    kernels' own checks raise for a device that is not the card and for
    float64; shapes are checked before either."""
    W, U, b, h0, c0, xw, ids, dh, dhT, dcT = (
        torch.from_numpy(a.astype(np.float32)) if a.dtype != np.int32 else
        torch.from_numpy(a) for a in _layer(N, 2))
    cfg = TConfig(vocab=M, hidden=N)
    layer = tmodel.LayerParams(W, U, b)
    before = ct.launches()
    h_seq, _, c_seq, g_seq = ct.tiled_scan_layer(layer, xw, h0, c0, cfg,
                                                 residuals=True)
    dg, dc0 = ct.tiled_bwd(U, g_seq, c_seq, c0, dh, dhT, dcT, cfg,
                           dropout=(RATE, 3))
    assert dg.dtype == torch.float32 and dc0.shape == (B, N)
    ct.tiled_embed_layer0(layer, ids, h0, c0, cfg)   # W is (M, 4N): M = N
    assert ct.launches() == before
    with pytest.raises(ValueError, match="dh_seq"):
        ct.tiled_bwd(U, g_seq, c_seq, c0, dh[:, :-1], dhT, dcT, cfg)
    with pytest.raises(ValueError, match="xw"):
        ct.tiled_scan_layer(layer, xw[..., :-1], h0, c0, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ct._kernel_codes(cfg, torch.device("cpu"))
    with pytest.raises(TypeError):
        ct._kernel_codes(TConfig(hidden=N, compute_dtype="float64",
                                 param_dtype="float64"), torch.device("cuda"))
    with pytest.raises(NotImplementedError):
        ct.tiled_scan_layer(tmodel.LayerParams(W, U.requires_grad_(), b), xw,
                            h0, c0, cfg)
