"""The port's plain cell oracle (eigen_lstm_tpu_torch/ops/cell.py) against the
JAX package's (eigen_lstm_tpu/ops/cell.py), on the same numpy inputs.

Tolerances: float32 rtol 1e-5 / atol 1e-6, the JAX package's own parity
tolerance (tests/test_pallas_cell.py); float64 rtol 1e-12, where only the
order of a few roundings differs; the bf16-input matmul rtol 1e-5, since
both round the inputs to bf16 identically and then sum in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu.ops import cell as jcell
from eigen_lstm_tpu_torch.ops import cell as tcell

N, B = 32, 6
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "float64": dict(rtol=1e-12, atol=1e-14)}


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    g_pre = rng.normal(size=(B, 4 * N)).astype(dtype) * 2.0
    c_prev = rng.normal(size=(B, N)).astype(dtype)
    return g_pre, c_prev


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_cell_step_matches_jax(dtype, variant, x64):
    g_pre, c_prev = _inputs(dtype)
    hj, cj = jcell.cell_step(jnp.asarray(g_pre), jnp.asarray(c_prev), N, variant)
    ht, ct = tcell.cell_step(torch.from_numpy(g_pre), torch.from_numpy(c_prev),
                             N, variant)
    assert ht.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL[dtype])
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gate_activations_and_slices(dtype, x64):
    g_pre, _ = _inputs(dtype, seed=1)
    gj = jcell.gate_activations(jnp.asarray(g_pre), N)
    gt = tcell.gate_activations(torch.from_numpy(g_pre), N)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL[dtype])
    assert tcell.gate_slices(N) == jcell.gate_slices(N)


def test_cell_update_rejects_unknown_variant():
    g = torch.zeros(B, 4 * N)
    with pytest.raises(ValueError):
        tcell.cell_update(g, torch.zeros(B, N), N, "bogus")


@pytest.mark.parametrize("compute", ["float32", "bfloat16", "float64"])
def test_matmul_matches_jax(compute, x64):
    """fp32 output from compute-type-rounded inputs, never a bf16 product."""
    rng = np.random.default_rng(2)
    base = "float64" if compute == "float64" else "float32"
    a = rng.normal(size=(B, 64)).astype(base)
    w = rng.normal(size=(64, 48)).astype(base)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
    yj = jcell.matmul(jnp.asarray(a), jnp.asarray(w), jd[compute])
    yt = tcell.matmul(torch.from_numpy(a), torch.from_numpy(w), td[compute])
    assert yt.dtype == (torch.float64 if compute == "float64" else torch.float32)
    assert np.asarray(yj).dtype == yt.numpy().dtype
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL[base])


def test_matmul_keeps_float32_products_exact():
    """TF32 stays off: a float32 product keeps float32 precision (the JAX
    package pins HIGHEST for the same reason)."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    rng = np.random.default_rng(3)
    a = rng.normal(size=(8, 256)).astype(np.float32)
    w = rng.normal(size=(256, 16)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    got = tcell.matmul(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_one_hot_match_jax(dtype):
    rng = np.random.default_rng(4)
    W = rng.normal(size=(20, 4 * N)).astype(np.float32)
    ids = rng.integers(0, 20, (5, 3)).astype(np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ej = jcell.embed(jnp.asarray(W), jnp.asarray(ids), jd)
    et = tcell.embed(torch.from_numpy(W), torch.from_numpy(ids), td)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    oj = jcell.one_hot(jnp.asarray(ids), 20)
    ot = tcell.one_hot(torch.from_numpy(ids), 20)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert jax.devices()[0].platform == "cpu"
