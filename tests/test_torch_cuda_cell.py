"""The port's recurrence wrappers (eigen_lstm_tpu_torch/ops/cuda_cell.py) on
CPU tensors, where they run their kernels' plain versions, against the JAX
package's Pallas kernels in interpret mode (pallas_embed_layer0,
pallas_scan_layer), on the same numpy inputs.

Tolerances: float32 rtol 1e-5 / atol 1e-6 on h and c, the JAX package's own
kernel parity tolerance (tests/test_pallas_cell.py:60-87). bf16 atol 2e-2
on h and c: both round h_{t-1} to bf16 before the product, and a float32
sum taken in another order can flip that rounding by one bf16 ulp, which
every later step then carries.
"""

import os
import pkgutil
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_cell import pallas_embed_layer0, pallas_scan_layer
import eigen_lstm_tpu_torch
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import _build, cuda_cell, cuda_cell_bwd, dispatch, head

S, B, N, M = 12, 8, 128, 256
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=0, atol=2e-2)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _layer(in_dim, seed):
    """Random weights (std 0.3, U scaled by 4 / sqrt(N)) so that the gates
    move; a std-0.01 init would leave the cell near its fixed point."""
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(in_dim, 4 * N)) * 0.3).astype(np.float32)
    U = (rng.normal(size=(N, 4 * N)) * 0.3 / np.sqrt(N / 16)).astype(np.float32)
    b = (rng.normal(size=(4 * N,)) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(B, N)) * 0.5).astype(np.float32)
    c0 = (rng.normal(size=(B, N)) * 0.5).astype(np.float32)
    return W, U, b, h0, c0


def _both(W, U, b):
    return (jmodel.LayerParams(jnp.asarray(W), jnp.asarray(U), jnp.asarray(b)),
            tmodel.LayerParams(torch.from_numpy(W), torch.from_numpy(U),
                               torch.from_numpy(b)))


def _cfgs(dtype, variant):
    kw = dict(vocab=M, hidden=N, cell_variant=variant, compute_dtype=dtype)
    return JConfig(**kw), TConfig(**kw)


def _compare(out_t, out_j, dtype):
    (h_t, (hT_t, cT_t)), (h_j, (hT_j, cT_j)) = out_t, out_j
    for got, want in ((h_t, h_j), (hT_t, hT_j), (cT_t, cT_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_embed_layer0_matches_pallas(dtype, variant):
    W, U, b, h0, c0 = _layer(M, seed=0)
    ids = np.random.default_rng(1).integers(0, M, (S, B)).astype(np.int32)
    lj, lt = _both(W, U, b)
    cj, ct = _cfgs(dtype, variant)
    out_j = pallas_embed_layer0(lj, jnp.asarray(ids), jnp.asarray(h0),
                                jnp.asarray(c0), cj)
    out_t = cuda_cell.embed_layer0(lt, torch.from_numpy(ids),
                                   torch.from_numpy(h0), torch.from_numpy(c0), ct)
    _compare(out_t, out_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_scan_layer_matches_pallas(dtype, variant):
    W, U, b, h0, c0 = _layer(N, seed=2)
    xw = (np.random.default_rng(3).normal(size=(S, B, 4 * N)) * 1.5).astype(np.float32)
    lj, lt = _both(W, U, b)
    cj, ct = _cfgs(dtype, variant)
    out_j = pallas_scan_layer(lj, jnp.asarray(xw), jnp.asarray(h0),
                              jnp.asarray(c0), cj)
    out_t = cuda_cell.scan_layer(lt, torch.from_numpy(xw), torch.from_numpy(h0),
                                 torch.from_numpy(c0), ct)
    _compare(out_t, out_j, dtype)


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
def test_residuals_and_carry_types(residual):
    """The residual sequences come back in the residual type, agree with
    the carried state, and leave h_seq as it is without them."""
    W, U, b, h0, c0 = _layer(M, seed=4)
    ids = torch.from_numpy(
        np.random.default_rng(5).integers(0, M, (S, B)).astype(np.int32))
    _, lt = _both(W, U, b)
    cfg = TConfig(vocab=M, hidden=N, residual_dtype=residual)
    h0t, c0t = torch.from_numpy(h0), torch.from_numpy(c0)
    h_seq, (hT, cT), c_seq, g_seq = cuda_cell.embed_layer0(
        lt, ids, h0t, c0t, cfg, residuals=True)
    h_only, _ = cuda_cell.embed_layer0(lt, ids, h0t, c0t, cfg)
    rd = getattr(torch, residual)
    assert h_seq.dtype == c_seq.dtype == g_seq.dtype == rd
    assert hT.dtype == cT.dtype == torch.float32
    assert g_seq.shape == (S, B, 4 * N)
    torch.testing.assert_close(h_only, h_seq, rtol=0, atol=0)
    torch.testing.assert_close(hT, h_seq[-1].float(), rtol=0, atol=0)
    torch.testing.assert_close(cT, c_seq[-1].float(), rtol=0, atol=0)
    assert float(g_seq.float().abs().max()) <= 1.0


def test_wrappers_refuse_bad_inputs():
    W, U, b, h0, c0 = _layer(M, seed=6)
    _, lt = _both(W, U, b)
    cfg = TConfig(vocab=M, hidden=N)
    ids = torch.zeros(S, B, dtype=torch.int32)
    h0t, c0t = torch.from_numpy(h0), torch.from_numpy(c0)
    with pytest.raises(TypeError):
        cuda_cell.embed_layer0(lt, ids.float(), h0t, c0t, cfg)
    with pytest.raises(ValueError):
        cuda_cell.embed_layer0(lt, ids, h0t[:, :-1], c0t, cfg)
    with pytest.raises(ValueError):
        cuda_cell.embed_layer0(lt, ids[0], h0t, c0t, cfg)
    xw = torch.zeros(S, B, 4 * N)
    with pytest.raises(ValueError):
        cuda_cell.scan_layer(lt, xw[..., :-1], h0t, c0t, cfg)
    bad_u = tmodel.LayerParams(lt.W, lt.U[:-1], lt.b)
    with pytest.raises(ValueError):
        cuda_cell.scan_layer(bad_u, xw, h0t, c0t, cfg)
    # what only the kernel refuses: float64, an unaligned width, no card
    cuda = torch.device("cuda")
    with pytest.raises(TypeError):
        cuda_cell._kernel_types(TConfig(hidden=N, compute_dtype="float64",
                                        param_dtype="float64"), cuda)
    with pytest.raises(ValueError):
        cuda_cell._kernel_types(TConfig(hidden=100), cuda)
    with pytest.raises(ValueError):
        cuda_cell._kernel_types(cfg, torch.device("cpu"))
    assert cuda_cell._kernel_types(TConfig(compute_dtype="bfloat16"), cuda) == (1, 0)


def test_cpu_tensors_launch_nothing():
    W, U, b, h0, c0 = _layer(M, seed=7)
    _, lt = _both(W, U, b)
    before = cuda_cell.launches()
    cuda_cell.embed_layer0(lt, torch.zeros(S, B, dtype=torch.int64),
                           torch.from_numpy(h0), torch.from_numpy(c0),
                           TConfig(vocab=M, hidden=N))
    assert cuda_cell.launches() == before


def test_dispatch_backends():
    cfg = TConfig(hidden=N)
    plain = dispatch.select_cell_fn("plain", cfg, 16, "cpu")
    assert plain.func is cuda_cell_bwd.differentiable_scan_layer
    assert plain.keywords == {"plain": True} and plain.fused_dropout
    assert plain.embed_layer0.func is cuda_cell_bwd.differentiable_embed_layer0
    # the layer-0 VJP is chosen at each call (the kernel's batch)
    assert plain.embed_layer0.keywords == {"plain": True}
    assert plain.fused_head.keywords == {"plain": True}
    assert plain.fused_head.supported is head.head_supported
    auto = dispatch.select_cell_fn("auto", cfg, 16, "cpu")
    assert auto.func is cuda_cell_bwd.differentiable_scan_layer
    assert auto.keywords == {"plain": True}
    with pytest.raises(ValueError):
        dispatch.select_cell_fn("cuda", cfg, 16, "cpu")
    # the hidden-width gate is the wrappers' alone (_kernel_types raises)
    kern = dispatch.select_cell_fn("cuda", TConfig(hidden=100), 16, "cuda")
    assert kern.func is cuda_cell_bwd.differentiable_scan_layer
    assert kern.keywords == {"plain": False} and kern.fused_dropout
    assert kern.embed_layer0.func is cuda_cell_bwd.differentiable_embed_layer0
    # where the JAX package takes the XLA scan: the fused VJP at any batch
    assert kern.embed_layer0.keywords == {"plain": False, "fused_accum": True}
    assert kern.fused_head.func is head.fused_head_bits
    assert kern.fused_head.keywords == {"plain": False}
    with pytest.raises(ValueError):
        dispatch.select_cell_fn("bogus", cfg, 16, "cpu")


def test_build_reports_missing_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(FileNotFoundError, match="nonexistent-cuda/bin/nvcc"):
        _build.find_nvcc()
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert re.fullmatch(r"liblstm_kernels_[0-9a-f]{16}\.so", os.path.basename(path))
    assert [os.path.basename(p) for p in _build.sources()] == [
        "adagrad.cu", "exchange.cu", "head.cu", "lstm_bwd.cu", "lstm_bwd_f32.cu",
        "lstm_bwd_f32_pairs.cu", "lstm_fwd.cu", "lstm_tiled.cu",
        "lstm_tiled_f32.cu", "lstm_tp.cu", "lstm_tp_f32.cu", "lstm_tp_f32_bwd.cu",
        "lstm_tp_persist.cu", "lstm_tp_step_bwd.cu", "lstm_tp_step_f32.cu", "sampler.cu",
        "sampler_f32.cu"]
    assert [os.path.basename(p) for p in _build.headers()] == [
        "common.cuh", "exchange.cuh", "fwd_mma.cuh", "lstm_bwd_f32.cuh",
        "lstm_tiled_f32.cuh", "mma.cuh", "sampler.cuh"]


def test_port_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    names = [m.name for m in pkgutil.walk_packages(
        eigen_lstm_tpu_torch.__path__, "eigen_lstm_tpu_torch.")]
    assert "eigen_lstm_tpu_torch.ops.cuda_cell" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'eigen_lstm_tpu' or m.startswith('eigen_lstm_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|eigen_lstm_tpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, "eigen_lstm_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "_build"]   # build outputs
        files += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
