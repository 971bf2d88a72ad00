"""The training kernels' wrappers on CPU tensors, where they run their plain
versions, against the JAX package's Pallas kernels in interpret mode, on
the same numpy inputs: the layer-0 backward (``pallas_cell.py:
_bwd_embed_fused_kernel`` through ``pallas_embed_layer0``'s VJP) and the
fused head forward and backward (``pallas_head.py``).

Shapes: N = 128, M = 256, B = 8, S = 16 (T = 128 head rows).

Tolerances. float32: rtol 1e-5 on values, rtol 2e-4 / atol 1e-6 on
gradients, the JAX package's own kernel parity tolerances
(tests/test_pallas_cell.py:60-87). bfloat16: each gradient within 2e-2 of
its largest magnitude. Both sides round dg (and the head's dlog) to bf16
before the products, a bf16 ulp is 2^-8 = 3.9e-3, and a float32 sum taken
in another order can flip one rounding, which the reverse recurrence then
carries into every earlier step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops import pallas_head as jhead
from eigen_lstm_tpu.ops.pallas_cell import pallas_embed_layer0
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import cuda_cell, cuda_cell_bwd, head

S, B, N, M = 16, 8, 128, 256
FP32_VAL = dict(rtol=1e-5, atol=0)
FP32_GRAD = dict(rtol=2e-4, atol=1e-6)
BF16_FRAC = 2e-2


def _cfgs(dtype, variant="reference"):
    kw = dict(vocab=M, hidden=N, cell_variant=variant, compute_dtype=dtype,
              loss_mode="all")
    return JConfig(**kw), TConfig(**kw)


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **FP32_GRAD)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_FRAC, (what, err)


def _layer_inputs(seed):
    """Weights that make the gates move (std 0.3, U scaled by 4/sqrt(N)),
    a window of byte ids, (h0, c0) and the cotangents of (h_seq, hT, cT)."""
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(M, 4 * N)) * 0.3).astype(np.float32)
    U = (rng.normal(size=(N, 4 * N)) * 0.3 / np.sqrt(N / 16)).astype(np.float32)
    b = (rng.normal(size=(4 * N,)) * 0.3).astype(np.float32)
    ids = rng.integers(0, M, (S, B)).astype(np.int32)
    h0, c0 = ((rng.normal(size=(B, N)) * 0.5).astype(np.float32)
              for _ in range(2))
    dh_seq = rng.normal(size=(S, B, N)).astype(np.float32)
    dhT, dcT = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(2))
    return W, U, b, ids, h0, c0, dh_seq, dhT, dcT


def _jax_vjp(W, U, b, ids, h0, c0, dh_seq, dhT, dcT, jcfg):
    def f(W, U, b, h0, c0):
        layer = jmodel.LayerParams(W, U, b)
        return pallas_embed_layer0(layer, jnp.asarray(ids), h0, c0, jcfg)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (W, U, b, h0, c0)))
    return vjp((jnp.asarray(dh_seq), (jnp.asarray(dhT), jnp.asarray(dcT))))


@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_layer0_backward_wrapper_matches_pallas_fp32(variant):
    """The K3 wrapper alone: dWU, db, dh0, dc0 from the forward's residuals
    against the JAX custom VJP, float32."""
    W, U, b, ids, h0, c0, dh_seq, dhT, dcT = _layer_inputs(0)
    jcfg, tcfg = _cfgs("float32", variant)
    dW_j, dU_j, db_j, dh0_j, dc0_j = _jax_vjp(W, U, b, ids, h0, c0, dh_seq,
                                              dhT, dcT, jcfg)
    layer = tmodel.LayerParams(*map(torch.from_numpy, (W, U, b)))
    t_ids, t_h0, t_c0 = map(torch.from_numpy, (ids, h0, c0))
    h_seq, _, c_seq, g_seq = cuda_cell.embed_layer0(layer, t_ids, t_h0, t_c0,
                                                    tcfg, residuals=True)
    dWU, db, dh0, dc0 = cuda_cell_bwd.embed_layer0_bwd(
        layer.U, g_seq, c_seq, h_seq, t_ids, t_h0, t_c0,
        *map(torch.from_numpy, (dh_seq, dhT, dcT)), tcfg)
    assert dWU.shape == (M + N, 4 * N) and db.shape == (4 * N,)
    for got, want, what in ((dWU[:M], dW_j, "dW"), (dWU[M:], dU_j, "dU"),
                            (db, db_j, "db"), (dh0, dh0_j, "dh0"),
                            (dc0, dc0_j, "dc0")):
        _close(got, want, "float32", what)


def test_layer0_backward_fills_dg_out_with_the_dg_sequence():
    """``dg_out`` receives the dg sequence whose sums are db."""
    W, U, b, ids, h0, c0, dh_seq, dhT, dcT = _layer_inputs(3)
    _, tcfg = _cfgs("float32")
    layer = tmodel.LayerParams(*map(torch.from_numpy, (W, U, b)))
    t_ids, t_h0, t_c0 = map(torch.from_numpy, (ids, h0, c0))
    h_seq, _, c_seq, g_seq = cuda_cell.embed_layer0(layer, t_ids, t_h0, t_c0,
                                                    tcfg, residuals=True)
    dg = torch.empty(S, B, 4 * N)
    _, db, _, _ = cuda_cell_bwd.embed_layer0_bwd(
        layer.U, g_seq, c_seq, h_seq, t_ids, t_h0, t_c0,
        *map(torch.from_numpy, (dh_seq, dhT, dcT)), tcfg, dg_out=dg)
    np.testing.assert_allclose(dg.sum((0, 1)).numpy(), db.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_layer0_autograd_matches_pallas_vjp(dtype, variant):
    """Layer 0 as ``models.lstm.forward`` differentiates it (the forward
    kernel, then K3, with dW and dU rounded to the compute type) against
    the JAX custom VJP, all five cotangents."""
    W, U, b, ids, h0, c0, dh_seq, dhT, dcT = _layer_inputs(1)
    jcfg, tcfg = _cfgs(dtype, variant)
    want = _jax_vjp(W, U, b, ids, h0, c0, dh_seq, dhT, dcT, jcfg)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (W, U, b, h0, c0)]
    layer = tmodel.LayerParams(*leaves[:3])
    h_seq, (hT, cT) = cuda_cell_bwd.differentiable_embed_layer0(
        layer, torch.from_numpy(ids), leaves[3], leaves[4], tcfg)
    obj = ((h_seq * torch.from_numpy(dh_seq)).sum()
           + (hT * torch.from_numpy(dhT)).sum()
           + (cT * torch.from_numpy(dcT)).sum())
    got = torch.autograd.grad(obj, leaves)
    for g, w, what in zip(got, want, ("dW", "dU", "db", "dh0", "dc0")):
        assert g.shape == tuple(w.shape), what
        _close(g, w, dtype, what)


def test_forward_wrappers_refuse_a_gradient():
    """A forward wrapper never returns a result that autograd cannot
    follow: both point at their differentiable forms, and those give the
    gradient the wrappers refuse."""
    _, tcfg = _cfgs("float32")
    W, U, b, ids, h0, c0, *_ = _layer_inputs(2)
    layer = tmodel.LayerParams(torch.from_numpy(W).requires_grad_(),
                               torch.from_numpy(U), torch.from_numpy(b))
    with pytest.raises(NotImplementedError, match="differentiable_embed"):
        cuda_cell.embed_layer0(layer, torch.from_numpy(ids),
                               torch.from_numpy(h0), torch.from_numpy(c0), tcfg)
    upper = tmodel.LayerParams(torch.zeros(N, 4 * N, requires_grad=True),
                               torch.from_numpy(U).requires_grad_(),
                               torch.from_numpy(b))
    xw = torch.zeros(S, B, 4 * N)
    for fn in (cuda_cell.scan_layer, cuda_cell.scan_layer_plain):
        with pytest.raises(NotImplementedError, match="differentiable_scan"):
            fn(upper, xw, torch.from_numpy(h0), torch.from_numpy(c0), tcfg)
    with torch.no_grad():   # eval still runs
        want = cuda_cell.scan_layer(upper, xw, torch.from_numpy(h0),
                                    torch.from_numpy(c0), tcfg)
    h_seq, (hT, cT) = cuda_cell_bwd.differentiable_scan_layer(
        upper, xw, torch.from_numpy(h0), torch.from_numpy(c0), tcfg)
    torch.testing.assert_close(h_seq, want[0], rtol=0, atol=0)
    dU, = torch.autograd.grad(h_seq.sum() + hT.sum(), [upper.U])
    assert dU.shape == (N, 4 * N) and bool(torch.isfinite(dU).all())
    assert float(dU.abs().max()) > 0


def _head_inputs(seed, t=S * B):
    rng = np.random.default_rng(seed)
    Why = (rng.normal(size=(N, M)) * 0.1).astype(np.float32)
    by = (rng.normal(size=(M,)) * 0.1).astype(np.float32)
    h = (rng.normal(size=(t, N)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, M, (t,)).astype(np.int32)
    return Why, by, h, tgt


def _jparams(Why, by):
    return jmodel.LSTMParams((), jnp.asarray(Why), jnp.asarray(by))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_forward_matches_pallas(dtype):
    """K4 alone: the bits sum against ``fused_head_bits``, and lse against
    the log-sum-exp of the same logits."""
    Why, by, h, tgt = _head_inputs(0)
    jcfg, tcfg = _cfgs(dtype)
    want = float(jhead.fused_head_bits(_jparams(Why, by), jnp.asarray(h),
                                       jnp.asarray(tgt), jcfg))
    h_c = torch.from_numpy(h).to(tcfg.cdtype)
    bits, lse = head.head_fwd(torch.from_numpy(Why).to(tcfg.cdtype),
                              torch.from_numpy(by), h_c,
                              torch.from_numpy(tgt), tcfg)
    np.testing.assert_allclose(float(bits), want, **FP32_VAL)
    logits = jmodel.logits_from_h(_jparams(Why, by), jnp.asarray(h), jcfg)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(logits, axis=-1)), **FP32_VAL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_backward_matches_pallas(dtype):
    """K5 alone and through the autograd function: dh, dWhy and dby
    against ``jax.grad`` of ``fused_head_bits`` at a cotangent of 0.37;
    dby has the shape of by."""
    Why, by, h, tgt = _head_inputs(1)
    jcfg, tcfg = _cfgs(dtype)
    cot = 0.37

    def f(Why, by, h):
        return jhead.fused_head_bits(jmodel.LSTMParams((), Why, by), h,
                                     jnp.asarray(tgt), jcfg) * cot

    dWhy_j, dby_j, dh_j = jax.grad(f, argnums=(0, 1, 2))(
        *map(jnp.asarray, (Why, by, h)))
    # the wrapper alone, from the forward's lse
    Why_c = torch.from_numpy(Why).to(tcfg.cdtype)
    h_c = torch.from_numpy(h).to(tcfg.cdtype)
    t_by, t_tgt = torch.from_numpy(by), torch.from_numpy(tgt)
    _, lse = head.head_fwd(Why_c, t_by, h_c, t_tgt, tcfg)
    dh, dWhy, dby = head.head_bwd(Why_c, t_by, h_c, t_tgt, lse,
                                  torch.tensor(cot), tcfg)
    assert dh.dtype == tcfg.cdtype and dby.shape == (M,)
    _close(dh.float(), dh_j, dtype, "dh")
    _close(dby, dby_j, dtype, "dby")
    if dtype == "float32":
        _close(dWhy, dWhy_j, dtype, "dWhy")
    # the autograd function: dWhy rounded to the compute type, as the VJP
    leaves = [torch.from_numpy(a).requires_grad_() for a in (Why, by, h)]
    params = tmodel.LSTMParams((), leaves[0], leaves[1])
    bits = head.fused_head_bits(params, leaves[2], t_tgt, tcfg)
    got = torch.autograd.grad(bits * cot, leaves)
    for g, w, what in zip(got, (dWhy_j, dby_j, dh_j), ("dWhy", "dby", "dh")):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32, what
        _close(g, w, dtype, what)


def test_head_gate_is_what_the_kernels_take():
    # any hidden width and token count (ragged row tiles are masked), no
    # VMEM budget: the H100 kernels stream Why from L2; one thread a column
    for cfg in (TConfig(hidden=512), TConfig(hidden=500), TConfig(hidden=4096),
                TConfig(vocab=256)):
        assert head.head_supported(cfg)
    assert not head.head_supported(TConfig(vocab=512))
    with pytest.raises(ValueError, match="vocabulary"):
        head._kernel_type(TConfig(vocab=512), torch.device("cuda"))


def test_head_kernels_refuse_a_cpu_launch_and_a_bad_shape():
    _, tcfg = _cfgs("float32")
    Why, by, h, tgt = map(torch.from_numpy, _head_inputs(2))
    with pytest.raises(ValueError, match="no kernel"):
        head._kernel_type(tcfg, torch.device("cpu"))
    with pytest.raises(ValueError, match="shape"):
        head.head_fwd(Why, by, h[:, :-1], tgt, tcfg)
    with pytest.raises(TypeError):
        head.head_fwd(Why, by, h, tgt.float(), tcfg)
