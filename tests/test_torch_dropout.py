"""The port's dropout against the JAX package's: the keep-mask bits, the
masked streams of the forward wrappers, the layers >= 1 backward (K6,
``scan_layer_bwd``) and layer 0 with dropout through their autograd
functions, against ``pallas_scan_layer`` / ``pallas_embed_layer0`` with
``dropout=(rate, seed)`` in interpret mode and their VJPs, and the model's
own loop (``_dropout``) against the JAX XLA path with the same explicit
masks. The port's wrappers run their plain versions here (CPU tensors).

Shapes: N = 128, B = 12 (not a multiple of 8), S = 10.

Tolerances (tests/test_pallas_cell.py:60-87; on the streams, those of
tests/test_torch_cuda_cell.py): float32 rtol 1e-5 / atol 1e-6 on the
output streams, rtol 2e-4 / atol 1e-6 on the gradients; float64 rtol 1e-10 /
atol 1e-12. bfloat16: each gradient within 2e-2 of its largest magnitude
(both round dg to bf16 before the products, and a float32 sum taken in
another order can flip one rounding, which the recurrence carries), and
each gradient a bf16 value exactly where the JAX VJP's is. The masks
themselves are compared bit for bit.
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
from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd
from eigen_lstm_tpu_torch.train import optimizer as topt

S, B, N, M = 10, 12, 128, 256
RATE = 0.35
SEEDS = (0, 7, -1, -2**31, 2**31 - 1, -123456789)
FP32_VAL = dict(rtol=1e-5, atol=1e-6)
FP32_GRAD = dict(rtol=2e-4, atol=1e-6)
FP64 = dict(rtol=1e-10, atol=1e-12)
BF16_FRAC = 2e-2


@pytest.mark.parametrize("drop", [0.2, 0.35])
def test_keep_mask_bits_equal_jax(drop):
    """The port's numpy and torch masks equal the JAX ``host_keep_mask``
    bit for bit: negative int32 seeds, timesteps up to 255, batches that
    are not multiples of 4."""
    for seed in SEEDS:
        for tau in (0, 1, 17, 255):
            for b, n in ((3, 32), (7, 128), (12, 64)):
                want = jpc.host_keep_mask(seed, tau, b, n, drop)
                np.testing.assert_array_equal(
                    cuda_cell.host_keep_mask(seed, tau, b, n, drop), want)
                np.testing.assert_array_equal(
                    cuda_cell.keep_mask(seed, tau, b, n, drop).numpy(), want)
    assert cuda_cell._keep_u32(drop) == jpc._keep_u32(drop)


def test_keep_mask_keeps_the_threshold_itself():
    """An element whose hash equals the threshold is kept (``<=``, as
    ``_keep_mask``): the drop rate is chosen so that the threshold is one
    element's hash exactly."""
    b, n, seed, tau, k = 4, 32, -11, 3, 5
    idx = np.arange(b * n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        bits = cuda_cell._fmix32((idx * np.uint32(0x85EBCA6B)).astype(np.uint32)
                                 ^ np.uint32(cuda_cell._mask_base(seed, tau)))
    v = int(bits[k])
    drop = 1.0 - v / 0xFFFFFFFF
    for _ in range(64):
        if cuda_cell._keep_u32(drop) > v:
            drop = np.nextafter(drop, 1.0)
        elif cuda_cell._keep_u32(drop) < v:
            drop = np.nextafter(drop, 0.0)
    assert cuda_cell._keep_u32(drop) == v
    for mask in (jpc.host_keep_mask(seed, tau, b, n, drop),
                 cuda_cell.host_keep_mask(seed, tau, b, n, drop),
                 cuda_cell.keep_mask(seed, tau, b, n, drop).numpy()):
        assert mask.reshape(-1)[k]
        np.testing.assert_array_equal(mask.reshape(-1), bits <= v)


def _layer(in_dim, seed):
    """Weights that make the gates move (std 0.3, U scaled by 4/sqrt(N)),
    (h0, c0), and cotangents for the outputs."""
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(in_dim, 4 * N)) * 0.3).astype(np.float32)
    U = (rng.normal(size=(N, 4 * N)) * 0.3 / np.sqrt(N / 16)).astype(np.float32)
    b = (rng.normal(size=(4 * N,)) * 0.3).astype(np.float32)
    h0, c0 = ((rng.normal(size=(B, N)) * 0.5).astype(np.float32) for _ in range(2))
    xw = rng.normal(size=(S, B, 4 * N)).astype(np.float32)
    ids = rng.integers(0, M, (S, B)).astype(np.int32)
    dh = rng.normal(size=(S, B, N)).astype(np.float32)
    dhT, dcT = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(2))
    return W, U, b, h0, c0, xw, ids, dh, dhT, dcT


@pytest.mark.parametrize("embed", [True, False])
def test_masked_stream_is_the_hash_of_the_unmasked_one(embed):
    """Both forward wrappers: the masked stream is where(host mask, h *
    inv, 0) of their own fp32 h_seq, bit for bit, and h_seq, hT, cT are
    the run without dropout's."""
    W, U, b, h0, c0, xw, ids, *_ = _layer(M if embed else N, 3)
    cfg = TConfig(vocab=M, hidden=N)
    layer = tmodel.LayerParams(*map(torch.from_numpy, (W, U, b)))
    fn = cuda_cell.embed_layer0 if embed else cuda_cell.scan_layer
    seq = torch.from_numpy(ids if embed else xw)
    args = (layer, seq, torch.from_numpy(h0), torch.from_numpy(c0), cfg)
    seed = -987654321
    h_seq, (hT, cT), _, _, hd = fn(*args, residuals=True, dropout=(RATE, seed))
    eval_out = fn(*args)
    inv = np.float32(1.0 / (1.0 - RATE))
    masks = np.stack([cuda_cell.host_keep_mask(seed, t, B, N, RATE)
                      for t in range(S)])
    want = np.where(masks, h_seq.numpy() * inv, np.float32(0))
    np.testing.assert_array_equal(hd.numpy(), want)
    for got, ref in ((h_seq, eval_out[0]), (hT, eval_out[1][0]),
                     (cT, eval_out[1][1])):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # without residuals the wrapper hands on the masked stream
    torch.testing.assert_close(fn(*args, dropout=(RATE, seed))[0], hd,
                               rtol=0, atol=0)


def _bf16_valued(x) -> bool:
    t = torch.from_numpy(np.asarray(x, np.float32))
    return bool((t.bfloat16().float() == t).all())


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float32 if dtype != "float64" else np.float64)
    want = np.asarray(want, got.dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **FP32_GRAD)
    elif dtype == "float64":
        np.testing.assert_allclose(got, want, err_msg=what, **FP64)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_FRAC, (what, err)
        assert _bf16_valued(got) == _bf16_valued(want), what


def _run_both(dtype, variant, embed, seed):
    """The JAX kernel's output and VJP, and the port's autograd function's,
    on the same inputs with ``dropout=(RATE, seed)``. Returns (JAX, port)
    pairs of (output stream, hT, cT, gradients)."""
    W, U, b, h0, c0, xw, ids, dh, dhT, dcT = _layer(M if embed else N, 1)
    kw = dict(vocab=M, hidden=N, cell_variant=variant, compute_dtype=dtype,
              param_dtype="float64" if dtype == "float64" else "float32")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    ft = np.float64 if dtype == "float64" else np.float32
    W, U, b, h0, c0, xw, dh, dhT, dcT = (a.astype(ft) for a in
                                         (W, U, b, h0, c0, xw, dh, dhT, dcT))
    jseed = jnp.asarray([seed], jnp.int32)

    if embed:
        def f(W, U, b, h0, c0):
            return jpc.pallas_embed_layer0(
                jmodel.LayerParams(W, U, b), jnp.asarray(ids), h0, c0, jcfg,
                dropout=(RATE, jseed))
        jargs, tleaves = (W, U, b, h0, c0), (W, U, b, h0, c0)
    else:
        def f(U, xw, h0, c0):
            return jpc.pallas_scan_layer(
                jmodel.LayerParams(jnp.asarray(W), U, jnp.asarray(b)), xw,
                h0, c0, jcfg, dropout=(RATE, jseed))
        jargs, tleaves = (U, xw, h0, c0), (U, xw, h0, c0)
    (jh, (jhT, jcT)), vjp = jax.vjp(f, *map(jnp.asarray, jargs))
    jg = vjp((jnp.asarray(dh).astype(jh.dtype),
              (jnp.asarray(dhT), jnp.asarray(dcT))))

    leaves = [torch.from_numpy(a).requires_grad_() for a in tleaves]
    if embed:
        layer = tmodel.LayerParams(*leaves[:3])
        th, (thT, tcT) = cuda_cell_bwd.differentiable_embed_layer0(
            layer, torch.from_numpy(ids), leaves[3], leaves[4], tcfg,
            dropout=(RATE, seed))
    else:
        layer = tmodel.LayerParams(torch.from_numpy(W), leaves[0],
                                   torch.from_numpy(b))
        th, (thT, tcT) = cuda_cell_bwd.differentiable_scan_layer(
            layer, leaves[1], leaves[2], leaves[3], tcfg, dropout=(RATE, seed))
    obj = ((th.to(leaves[0].dtype) * torch.from_numpy(dh)).sum()
           + (thT * torch.from_numpy(dhT)).sum()
           + (tcT * torch.from_numpy(dcT)).sum())
    tg = torch.autograd.grad(obj, leaves)
    return (jh, jhT, jcT, jg), (th.detach(), thT.detach(), tcT.detach(), tg)


def _compare(dtype, variant, embed, seed=-77):
    (jh, jhT, jcT, jg), (th, thT, tcT, tg) = _run_both(dtype, variant, embed,
                                                       seed)
    val = {"float32": FP32_VAL, "float64": FP64}.get(dtype, dict(rtol=0, atol=2e-2))
    for got, want in ((th, jh), (thT, jhT), (tcT, jcT)):
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(want, np.float64), **val)
    names = ("dW", "dU", "db", "dh0", "dc0") if embed else ("dU", "dxw", "dh0", "dc0")
    for g, w, what in zip(tg, jg, names):
        assert g.shape == tuple(w.shape), what
        _close(g.detach().numpy(), w, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_scan_layer_dropout_matches_pallas(dtype, variant):
    """Layers >= 1 with dropout: K2's plain version with its masked stream
    and K6's through ``differentiable_scan_layer``, against
    ``pallas_scan_layer`` and its VJP: the stream, hT, cT, dU, dxw (the
    dg sequence), dh0, dc0."""
    _compare(dtype, variant, embed=False)


def test_scan_layer_dropout_matches_pallas_float64(x64):
    _compare("float64", "reference", embed=False, seed=2**31 - 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_layer0_dropout_matches_pallas(dtype):
    """Layer 0 with dropout: K1's masked stream and K3 with the mask,
    against ``pallas_embed_layer0`` and its VJP, all five gradients."""
    _compare(dtype, "reference", embed=True)


def test_scan_layer_bwd_wrapper_returns_the_vjp_pieces():
    """K6's wrapper alone: dg_seq in the xw type (bf16 under bf16 compute,
    fp32 else), dU, dh0, dc0 in fp32; ``dg_out`` receives the fp32 dg whose
    rounding dg_seq is; and without dropout it equals the JAX VJP."""
    W, U, b, h0, c0, xw, _, dh, dhT, dcT = _layer(N, 4)
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = JConfig(hidden=N, compute_dtype=dtype), TConfig(hidden=N, compute_dtype=dtype)
        layer = tmodel.LayerParams(*map(torch.from_numpy, (W, U, b)))
        t_h0, t_c0 = torch.from_numpy(h0), torch.from_numpy(c0)
        h_seq, _, c_seq, g_seq = cuda_cell.scan_layer(
            layer, torch.from_numpy(xw), t_h0, t_c0, tcfg, residuals=True)
        dg_out = torch.empty(S, B, 4 * N)
        dg, dU, dh0, dc0 = cuda_cell_bwd.scan_layer_bwd(
            layer.U.to(tcfg.cdtype), g_seq, c_seq, h_seq, t_h0, t_c0,
            *map(torch.from_numpy, (dh, dhT, dcT)), tcfg, dg_out=dg_out)
        assert dg.dtype == cuda_cell.xw_type(tcfg) == (
            torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        assert dU.dtype == dh0.dtype == dc0.dtype == torch.float32
        torch.testing.assert_close(dg, dg_out.to(dg.dtype), rtol=0, atol=0)

        def f(U, xw, h0, c0):
            return jpc.pallas_scan_layer(
                jmodel.LayerParams(jnp.asarray(W), U, jnp.asarray(b)), xw,
                h0, c0, jcfg)
        _, vjp = jax.vjp(f, *map(jnp.asarray, (U, xw, h0, c0)))
        jdU, jdxw, jdh0, jdc0 = vjp((jnp.asarray(dh),
                                     (jnp.asarray(dhT), jnp.asarray(dcT))))
        for got, want, what in ((dU.to(tcfg.cdtype).float(), jdU, "dU"),
                                (dg.float(), jdxw, "dxw"), (dh0, jdh0, "dh0"),
                                (dc0, jdc0, "dc0")):
            _close(got.numpy(), want, dtype, what)


def _explicit_masks(seeds, s, b, n, rate):
    return [np.stack([cuda_cell.host_keep_mask(sd, t, b, n, rate)
                      for t in range(s)]) for sd in seeds]


def test_plain_loop_dropout_matches_jax_with_explicit_masks():
    """``cell_fn=None``: the model's own loop with ``_dropout`` replaced in
    both packages by the same explicit masks (x / keep where kept), loss
    and all eight gradients of two layers, float32."""
    rate = 0.25
    kw = dict(vocab=M, hidden=N, num_layers=2, loss_mode="all", dropout=rate,
              init_std=0.1)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(11)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    jp = jmodel.LSTMParams(
        tuple(jmodel.LayerParams(*(jnp.asarray(t.numpy()) for t in (l.W, l.U, l.b)))
              for l in tp.layers), jnp.asarray(tp.Why.numpy()), jnp.asarray(tp.by.numpy()))
    ids = rng.integers(0, M, (S + 1, B)).astype(np.int32)
    masks = _explicit_masks((5, -6), S, B, N, rate)

    def fake(calls, where):
        def drop(x, r, key):
            m = next(calls)
            return where(m, x, r)
        return drop

    def jwhere(m, x, r):
        return jnp.where(jnp.asarray(m), x / jnp.asarray(1.0 - r, x.dtype), 0.0)

    def twhere(m, x, r):
        keep = torch.tensor(1.0 - r, dtype=x.dtype)
        return torch.where(torch.from_numpy(m), x / keep, torch.zeros_like(x))

    h = np.zeros((2, B, N), np.float32)
    orig_j, orig_t = jmodel._dropout, tmodel._dropout
    try:
        jmodel._dropout = fake(iter(masks), jwhere)
        (jl, _), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
            jp, jnp.asarray(ids[:-1]), jnp.asarray(ids[1:]), jnp.asarray(h),
            jnp.asarray(h), jcfg, None, jax.random.PRNGKey(0))
        tmodel._dropout = fake(iter(masks), twhere)
        leaves = [t.detach().requires_grad_() for _, t in tp.named_tensors()]
        tl, _ = tmodel.loss_fn(topt.like(tp, leaves), torch.from_numpy(ids[:-1]),
                               torch.from_numpy(ids[1:]), torch.from_numpy(h),
                               torch.from_numpy(h), tcfg, None, dropout_key=9)
        tg = torch.autograd.grad(tl, leaves)
    finally:
        jmodel._dropout, tmodel._dropout = orig_j, orig_t
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jflat = jax.tree_util.tree_leaves(jg)
    jnames = ["layers[0].W", "layers[0].U", "layers[0].b", "layers[1].W",
              "layers[1].U", "layers[1].b", "Why", "by"]
    # JAX flattens a dataclass's fields in order: layers, Why, by
    for g, w, what in zip(tg, jflat, jnames):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what,
                                   **FP32_GRAD)


def test_plain_dropout_draws_its_rate_from_the_seed():
    """The real ``_dropout``: about the rate's share dropped, the kept ones
    scaled by 1 / keep, the same bits for the same seed and other bits for
    another."""
    x = torch.ones(64, 256)
    a = tmodel._dropout(x, 0.35, -5)
    assert abs(float((a == 0).float().mean()) - 0.35) < 0.02
    kept = a[a != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.65))
    torch.testing.assert_close(tmodel._dropout(x, 0.35, -5), a, rtol=0, atol=0)
    assert not torch.equal(tmodel._dropout(x, 0.35, -4), a)


def test_step_key_and_layer_seeds_are_pure_int32_functions():
    keys = {tmodel.step_key(1235, step) for step in range(100)}
    assert len(keys) == 100 and all(0 <= k < 2**32 for k in keys)
    assert tmodel.step_key(1235, 7) == tmodel.step_key(1235, 7)
    assert tmodel.step_key(1235, 7) != tmodel.step_key(1236, 7)
    seeds = [tmodel._drop_seed(tmodel.step_key(0, 3), l) for l in range(3)]
    assert len(set(seeds)) == 3
    assert all(-2**31 <= sd < 2**31 for sd in seeds)
    assert tmodel._drop_seed((4, -5, 6), 1) == -5
    with pytest.raises(ValueError):
        cuda_cell.drop_scalars((1.0, 3))
    assert cuda_cell.drop_scalars(None) is None
    assert cuda_cell.drop_scalars((0.0, 3)) is None
    assert cuda_cell.drop_scalars((0.35, -1)) == (
        0xFFFFFFFF, jpc._keep_u32(0.35), float(np.float32(1 / 0.65)))


def test_backward_wrappers_refuse_bad_inputs():
    """K3's and K6's wrappers raise on a shape, a type or a dg_out they do
    not take, and their kernels on a device that is not the card; a CPU
    tensor runs the plain version and launches nothing."""
    W, U, b, h0, c0, xw, ids, dh, dhT, dcT = _layer(N, 5)
    cfg = TConfig(vocab=M, hidden=N)
    layer = tmodel.LayerParams(*map(torch.from_numpy, (W, U, b)))
    t_h0, t_c0 = torch.from_numpy(h0), torch.from_numpy(c0)
    h_seq, _, c_seq, g_seq = cuda_cell.scan_layer(
        layer, torch.from_numpy(xw), t_h0, t_c0, cfg, residuals=True)
    cots = [torch.from_numpy(a) for a in (dh, dhT, dcT)]
    args = (layer.U, g_seq, c_seq, h_seq, t_h0, t_c0)
    with pytest.raises(ValueError, match="dh_seq"):
        cuda_cell_bwd.scan_layer_bwd(*args, cots[0][:, :-1], *cots[1:], cfg)
    with pytest.raises(ValueError, match="g_seq"):
        cuda_cell_bwd.scan_layer_bwd(layer.U, g_seq[..., :-1], *args[2:],
                                     *cots, cfg)
    with pytest.raises(ValueError, match="dg_out"):
        cuda_cell_bwd.scan_layer_bwd(*args, *cots, cfg,
                                     dg_out=torch.empty(S, B, 4 * N,
                                                        dtype=torch.float64))
    with pytest.raises(TypeError):
        cuda_cell_bwd.embed_layer0_bwd(layer.U, g_seq, c_seq, h_seq,
                                       torch.from_numpy(ids).float(), t_h0,
                                       t_c0, *cots, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_cell._kernel_types(cfg, torch.device("cpu"))
    before = cuda_cell_bwd.scan_layer_bwd.launches
    cuda_cell_bwd.scan_layer_bwd(*args, *cots, cfg, dropout=(RATE, 3))
    assert cuda_cell_bwd.scan_layer_bwd.launches == before
