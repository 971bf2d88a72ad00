"""``scan_chunk`` (the recurrence rematerialised chunk by chunk in the
backward, ``models/lstm.py:_chunked_seq``) and ``evaluate_ensemble_bpc``
against the JAX package.

scan_chunk: 2 layers, N = 128, M = 256, B = 8, S = 8, chunks of 4. float32
through the kernels' plain versions against the JAX Pallas kernels in
interpret mode, both chunked; float64 through the model's own loop
against the JAX XLA scan, both chunked (the JAX layer-0 kernel takes b,
h0 and c0 in float32, so its float64 kernel path is not a float64
computation); and each chunked run against the port's unchunked one.

The ensemble: the 1x512 checkpoint and a 2x128 model with random weights,
both loaded from numpy arrays through ``params_from_numpy``, on 2048
held-out bytes of bible.txt, float32.

Tolerances. float32: rtol 1e-5 on the loss and the ensemble's bits/char,
rtol 2e-4 / atol 1e-6 on the gradients (tests/test_pallas_cell.py:60-87);
float64: rtol 1e-10 / atol 1e-12. A one-member ensemble equals
``evaluate_bpc`` exactly (the mixture of one is its own log-probability).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.data import corpus as jcorpus
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.dispatch import select_cell_fn as jselect
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import evaluator as jeval
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn as tselect
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import evaluator as teval
from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIBLE = os.path.join(ROOT, "data/cantrbry/bible.txt")
H512 = os.path.join(ROOT, "artifacts/bible_h512/ckpt.npz")
L, S, B, N, M, CHUNK = 2, 8, 8, 128, 256, 4
TOLS = {"float32": (dict(rtol=1e-5), dict(rtol=2e-4, atol=1e-6)),
        "float64": (dict(rtol=1e-10), dict(rtol=1e-10, atol=1e-12))}


def _arrays(layers, n, ft, seed):
    rng = np.random.default_rng(seed)
    arrays = {}
    for l in range(layers):
        arrays[f"params.layers[{l}].W"] = rng.normal(size=(M if l == 0 else n, 4 * n)) * 0.2
        arrays[f"params.layers[{l}].U"] = rng.normal(size=(n, 4 * n)) * 0.2 / np.sqrt(n / 16)
        arrays[f"params.layers[{l}].b"] = rng.normal(size=(4 * n,)) * 0.2
    arrays["params.Why"] = rng.normal(size=(n, M)) * 0.2
    arrays["params.by"] = rng.normal(size=(M,)) * 0.2
    return {k: v.astype(ft) for k, v in arrays.items()}


def _inputs(ft):
    rng = np.random.default_rng(9)
    win = rng.integers(0, M, (S + 1, B)).astype(np.int32)
    h, c = ((rng.normal(size=(L, B, N)) * 0.3).astype(ft) for _ in range(2))
    return win, h, c


def _kw(dtype, chunk):
    return dict(vocab=M, hidden=N, num_layers=L, loss_mode="all",
                compute_dtype=dtype, scan_chunk=chunk,
                param_dtype="float64" if dtype == "float64" else "float32")


def _jax(dtype, kernels):
    ft = np.float64 if dtype == "float64" else np.float32
    arrays, (win, h, c) = _arrays(L, N, ft, 1), _inputs(ft)
    jcfg = JConfig(**_kw(dtype, CHUNK))
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    cell = jselect("pallas", jcfg, B, interpret=True) if kernels else None
    loss, grads = jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, jnp.asarray(win[:-1]), jnp.asarray(win[1:]), jnp.asarray(h),
        jnp.asarray(c), jcfg, cell)[0])(jp)
    return float(loss), jckpt._flatten(grads, "params")


def _port(dtype, kernels, chunk):
    ft = np.float64 if dtype == "float64" else np.float32
    arrays, (win, h, c) = _arrays(L, N, ft, 1), _inputs(ft)
    tcfg = TConfig(**_kw(dtype, chunk))
    loss, _, _, grads = loss_and_grads(
        tckpt.params_from_numpy(arrays, tcfg, "cpu"),
        torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
        torch.from_numpy(h), torch.from_numpy(c), tcfg,
        tselect("auto", tcfg, B, "cpu") if kernels else None)
    return float(loss), {k: v.numpy() for k, v in grads.named_tensors()}


def _assert_close(got, want, dtype):
    (gl, gg), (wl, wg) = got, want
    loss_tol, grad_tol = TOLS[dtype]
    np.testing.assert_allclose(gl, wl, **loss_tol)
    assert sorted(gg) == sorted(wg) and len(gg) == 3 * L + 2
    for key in wg:
        np.testing.assert_allclose(gg[key], wg[key], **grad_tol, err_msg=key)


@pytest.mark.parametrize("dtype,kernels", [("float32", True),
                                           ("float64", False)])
def test_scan_chunk_matches_jax_and_the_unchunked_run(request, dtype, kernels):
    """The loss and all eight gradients with scan_chunk = 4 at S = 8
    against the JAX package's scan_chunk = 4, and against the port's own
    unchunked run."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    chunked = _port(dtype, kernels, CHUNK)
    _assert_close(chunked, _jax(dtype, kernels), dtype)
    _assert_close(chunked, _port(dtype, kernels, 0), dtype)


def test_scan_chunk_checkpoints_each_chunk_and_drops_the_fused_dropout(
        monkeypatch):
    """Under scan_chunk each layer's hook runs once a chunk, without the
    fused dropout (``fdrop`` excludes it, as in the JAX package): the
    model's ``_dropout`` masks the stream; a chunk that does not divide S
    leaves the window whole, and the fused dropout in place."""
    calls = []
    cfg = TConfig(**_kw("float32", CHUNK), dropout=0.3)
    cell = tselect("auto", cfg, B, "cpu")

    def spy(layer, xw, h0, c0, cfg, **kw):
        calls.append(("scan", xw.shape[0], "dropout" in kw))
        return cell(layer, xw, h0, c0, cfg, **kw)

    def spy_embed(layer, ids, h0, c0, cfg, **kw):
        calls.append(("embed", ids.shape[0], "dropout" in kw))
        return cell.embed_layer0(layer, ids, h0, c0, cfg, **kw)

    drops = []
    real = tmodel._dropout
    monkeypatch.setattr(tmodel, "_dropout",
                        lambda x, rate, seed: drops.append(x.shape) or real(x, rate, seed))
    spy.embed_layer0, spy.fused_dropout, spy.fused_head = (
        spy_embed, True, cell.fused_head)
    win, h, c = _inputs(np.float32)
    params = tckpt.params_from_numpy(_arrays(L, N, np.float32, 1), cfg, "cpu")
    args = (torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
            torch.from_numpy(h), torch.from_numpy(c))
    loss_and_grads(params, *args, cfg, spy, (5, -6))
    fwd = [("embed", CHUNK, False)] * 2 + [("scan", CHUNK, False)] * 2
    assert calls[:4] == fwd and drops == [(S, B, N)] * L
    calls.clear()
    drops.clear()
    whole = TConfig(**_kw("float32", 3), dropout=0.3)
    loss_and_grads(params, *args, whole, spy, (5, -6))
    assert calls == [("embed", S, True), ("scan", S, True)] and drops == []


def _members():
    with np.load(H512) as z:
        a512 = {k: z[k] for k in z.files if k.startswith("params")}
    kw512 = dict(vocab=M, hidden=512)
    kw128 = dict(vocab=M, hidden=N, num_layers=L)
    a128 = _arrays(L, N, np.float32, 3)
    return [(a512, kw512), (a128, kw128)]


@pytest.fixture(scope="module")
def held_out():
    return jcorpus.split(jcorpus.rawread(BIBLE), 0.95)[1]


def test_ensemble_matches_jax_and_one_member_is_evaluate_bpc(held_out):
    """Two members (each with its own ``cell_fn``: the kernels' plain
    versions for the 1x512, the model's own loop for the 2x128) against
    the JAX ensemble; one member alone gives ``evaluate_bpc`` exactly."""
    jm, tm = [], []
    for i, (arrays, kw) in enumerate(_members()):
        jcfg, tcfg = JConfig(**kw), TConfig(**kw)
        jm.append((jckpt._unflatten_like(jmodel.init_params(jcfg), "params",
                                         arrays), jcfg, None))
        cell = tselect("auto", tcfg, 16, "cpu") if i == 0 else None
        tm.append((tckpt.params_from_numpy(arrays, tcfg, "cpu"), tcfg, cell))
    want = jeval.evaluate_ensemble_bpc(jm, held_out, max_chars=2048)
    got = teval.evaluate_ensemble_bpc(tm, held_out, max_chars=2048)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    singles = [teval.evaluate_bpc(p, held_out, cfg, max_chars=2048, cell_fn=cf)
               for p, cfg, cf in tm]
    assert min(singles) < got < max(singles) + 1.0
    assert teval.evaluate_ensemble_bpc(tm[:1], held_out, max_chars=2048) == singles[0]


def test_ensemble_refuses_members_of_other_vocabularies(held_out):
    tcfg = TConfig(vocab=128, hidden=32)
    other = (tmodel.init_params(tcfg, device="cpu"), tcfg, None)
    cfg = TConfig(hidden=32)
    member = (tmodel.init_params(cfg, device="cpu"), cfg, None)
    with pytest.raises(ValueError, match=r"share one vocab, got \[128, 256\]"):
        teval.evaluate_ensemble_bpc([member, other], held_out)
    with pytest.raises(ValueError, match="at least one"):
        teval.evaluate_ensemble_bpc([], held_out)
