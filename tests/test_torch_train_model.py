"""The port's training objective against the JAX package's: ``loss_fn``'s
loss and all five gradients on the trained 1x512 checkpoint
(``artifacts/bible_h512/ckpt.npz``) and a ``data/cantrbry/bible.txt``
window, the JAX side through its Pallas kernels in interpret mode
(``select_cell_fn("pallas", ..., interpret=True)``), the port's through
``select_cell_fn("auto", ..., "cpu")`` (the kernels' plain versions).

Tolerances. float32: rtol 1e-5 on the loss and rtol 2e-4 / atol 1e-6 on
the gradients (tests/test_pallas_cell.py:60-87). bfloat16: rtol 1e-4 on
the loss and each gradient within 2e-2 of its largest magnitude; both
round dg, dlog and dh to bf16 and a float32 sum taken in another order can
flip one of those roundings (a bf16 ulp is 2^-8), which the recurrence then
carries.
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
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn as tselect
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts/bible_h512/ckpt.npz")
CORPUS = os.path.join(ROOT, "data/cantrbry/bible.txt")
S, B, N = 16, 8, 512


@pytest.fixture(scope="module")
def setup():
    """The checkpoint's arrays, a window of the training split at seeded
    cursors, and the checkpoint's own stream state for those streams."""
    with np.load(CKPT) as z:
        arrays = {k: z[k] for k in z.files}
    train = jcorpus.split(jcorpus.rawread(CORPUS), 0.95)[0]
    rng = np.random.default_rng(0)
    pos = rng.integers(0, len(train) - S - 1, B)
    win = np.stack([train[p: p + S + 1] for p in pos], axis=1).astype(np.int32)
    h = arrays["data/stream_h"][:, :B].copy()
    c = arrays["data/stream_c"][:, :B].copy()
    return arrays, win, h, c


def _run_both(setup, dtype, loss_mode, loss_base):
    arrays, win, h, c = setup
    kw = dict(hidden=N, loss_mode=loss_mode, loss_base=loss_base,
              compute_dtype=dtype)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    cell = jselect("pallas", jcfg, B, interpret=True)

    def f(p):
        return jmodel.loss_fn(p, jnp.asarray(win[:-1]), jnp.asarray(win[1:]),
                              jnp.asarray(h), jnp.asarray(c), jcfg, cell)

    (jloss, ((jh, jc), jbits)), jg = jax.value_and_grad(f, has_aux=True)(jp)
    tp = tckpt.params_from_numpy(arrays, tcfg, "cpu")
    tloss, (th, tc), tbits, tg = loss_and_grads(
        tp, torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
        torch.from_numpy(h), torch.from_numpy(c), tcfg,
        tselect("auto", tcfg, B, "cpu"))
    return ((float(jloss), float(jbits), np.asarray(jh), np.asarray(jc),
             jckpt._flatten(jg, "params")),
            (float(tloss), float(tbits), th.numpy(), tc.numpy(),
             {k: v.numpy() for k, v in tg.named_tensors()}))


@pytest.mark.parametrize("loss_mode", ["all", "last"])
@pytest.mark.parametrize("loss_base", ["e", "2"])
def test_loss_and_gradients_match_jax_fp32(setup, loss_mode, loss_base):
    (jl, jb, jh, jc, jg), (tl, tb, th, tc, tg) = _run_both(
        setup, "float32", loss_mode, loss_base)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tb, jb, rtol=1e-5)
    # the carried state, as the trainer reads it
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)
    assert sorted(tg) == sorted(jg)
    for key in jg:
        assert tg[key].shape == jg[key].shape, key
        np.testing.assert_allclose(tg[key], jg[key], rtol=2e-4, atol=1e-6,
                                   err_msg=key)


def test_loss_and_gradients_match_jax_bf16(setup):
    (jl, _, _, _, jg), (tl, _, _, _, tg) = _run_both(setup, "bfloat16", "all", "e")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for key in jg:
        err = np.abs(tg[key] - jg[key]).max() / np.abs(jg[key]).max()
        assert err <= 2e-2, (key, err)
        # the roundings of the custom VJPs: dW, dU and dWhy come back as
        # bf16 values, db and dby in full fp32, in both packages
        exact = [bool((torch.from_numpy(np.asarray(g)).bfloat16().float()
                       == torch.from_numpy(np.asarray(g))).all())
                 for g in (tg[key], jg[key])]
        assert exact[0] == exact[1], (key, exact)


def test_plain_loop_gradients_match_jax_xla(setup):
    """``cell_fn=None``: the model's own loop and open logits, against the
    JAX package's XLA path, float32, both embedding modes that differ in
    their backward."""
    arrays, win, h, c = setup
    for mode in ("auto", "gather"):
        kw = dict(hidden=N, loss_mode="all", embedding_mode=mode)
        jcfg, tcfg = JConfig(**kw), TConfig(**kw)
        jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
        (jl, _), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
            jp, jnp.asarray(win[:-1]), jnp.asarray(win[1:]), jnp.asarray(h),
            jnp.asarray(c), jcfg)
        tp = tckpt.params_from_numpy(arrays, tcfg, "cpu")
        tl, _, _, tg = loss_and_grads(
            tp, torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
            torch.from_numpy(h), torch.from_numpy(c), tcfg, None)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        jflat = jckpt._flatten(jg, "params")
        for key, g in tg.named_tensors():
            np.testing.assert_allclose(g.numpy(), jflat[key], rtol=2e-4,
                                       atol=1e-6, err_msg=f"{mode} {key}")


def test_loss_fn_takes_the_fused_head_only_where_its_gate_holds(setup):
    """Under ``"all"`` the head of ``cell_fn`` takes the loss where
    ``supported`` holds, and the open logits otherwise; the two agree."""
    arrays, win, h, c = setup
    tcfg = TConfig(hidden=N, loss_mode="all")
    tp = tckpt.params_from_numpy(arrays, tcfg, "cpu")
    calls = []
    cell = tselect("auto", tcfg, B, "cpu")
    fused = cell.fused_head

    def spy(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    args = (tp, torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
            torch.from_numpy(h), torch.from_numpy(c), tcfg)
    for gate in (True, False):
        spy.supported = lambda cfg, gate=gate: gate
        cell.fused_head = spy
        calls.clear()
        loss, _ = tmodel.loss_fn(*args, cell)
        assert bool(calls) == gate
        np.testing.assert_allclose(float(loss), float(tmodel.loss_fn(*args)[0]),
                                   rtol=1e-5)


def test_fused_head_takes_a_ragged_token_count(setup):
    """The fused head has no T % 8 gate: 15 steps of 3 streams (45 tokens)
    go through it, and the loss and five gradients match the JAX package's
    XLA path with open logits (its Pallas kernels take no batch of 3);
    float32 at the tolerances above."""
    arrays, win, h, c = setup
    win, h, c = win[:16, :3], h[:, :3], c[:, :3]
    kw = dict(hidden=N, loss_mode="all")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    (jl, _), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jp, jnp.asarray(win[:-1]), jnp.asarray(win[1:]), jnp.asarray(h),
        jnp.asarray(c), jcfg)
    cell = tselect("auto", tcfg, 3, "cpu")
    calls = []
    fused = cell.fused_head

    def spy(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    spy.supported = fused.supported
    cell.fused_head = spy
    tl, _, _, tg = loss_and_grads(
        tckpt.params_from_numpy(arrays, tcfg, "cpu"),
        torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
        torch.from_numpy(h), torch.from_numpy(c), tcfg, cell)
    assert calls
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jflat = jckpt._flatten(jg, "params")
    for key, g in tg.named_tensors():
        np.testing.assert_allclose(g.numpy(), jflat[key], rtol=2e-4,
                                   atol=1e-6, err_msg=key)
