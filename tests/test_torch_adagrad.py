"""The fused Adagrad update (K11, ``ops/cuda_adagrad.py``) against the JAX
package's ``adagrad_update_fused`` (``pallas_adagrad.py``, its Pallas kernel
in interpret mode, as tests/test_pallas_adagrad.py runs it) and
``adagrad_update``. On the CPU the wrapper runs its plain version; its
launch on the card is checked here with a stand-in library that records
the table it is handed.

Parameter sets: the 1x512 checkpoint's parameters and Adagrad accumulators
with seeded gradients, and a 2x128 model over a 97-byte vocabulary (W of
layer 0 and Why with 97 rows or columns, by of 97 and the biases 1-D, so
that the JAX function takes its jnp path for them).

Tolerances: m and p within rtol 1e-6 / atol 1e-7, as the JAX test holds
its kernel to its jnp path, through three chained steps. XLA on the CPU may
contract m + g*g into an FMA where torch rounds the product first, so
exact equality is asked only on the card (chip_smoke.py phase 10a, against
the plain version).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_adagrad import adagrad_update_fused as jfused
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import optimizer as jopt
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.config import TrainConfig as TTrain
from eigen_lstm_tpu_torch.ops import cuda_adagrad
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import optimizer as topt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H512 = os.path.join(ROOT, "artifacts/bible_h512/ckpt.npz")
TOL = dict(rtol=1e-6, atol=1e-7)
LR = np.float32(0.02)


def _h512():
    cfg = dict(vocab=256, hidden=512)
    with np.load(H512) as z:
        params = {k: z[k] for k in z.files if k.startswith("params")}
        m = {"params" + k[len("opt"):]: z[k] for k in z.files
             if k.startswith("opt")}
    return cfg, params, m


def _odd():
    cfg = dict(vocab=97, hidden=128, num_layers=2)
    rng = np.random.default_rng(3)
    shapes = {"params.layers[0].W": (97, 512), "params.layers[0].U": (128, 512),
              "params.layers[0].b": (512,), "params.layers[1].W": (128, 512),
              "params.layers[1].U": (128, 512), "params.layers[1].b": (512,),
              "params.Why": (128, 97), "params.by": (97,)}
    params = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
              for k, s in shapes.items()}
    m = {k: np.abs(rng.normal(size=s) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    return cfg, params, m


def _grads(params, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=v.shape) * 0.05).astype(dtype)
            for k, v in params.items()}


def _jax(tree_like, arrays):
    return jckpt._unflatten_like(tree_like, "params", arrays)


def _torch(arrays, cfg):
    return tckpt.params_from_numpy(arrays, cfg, "cpu")


def _assert_sets_close(got, want, what):
    for (key, g), w in zip(got.named_tensors(),
                           jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("make", [_h512, _odd], ids=["1x512", "2x128_odd"])
def test_fused_update_matches_jax_over_three_steps(make):
    """Three chained steps from the same state: the port's wrapper (its
    plain version on the CPU) against the JAX Pallas kernel (interpret
    mode) and the JAX jnp update, params and accumulators."""
    kw, params, m = make()
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    like = jmodel.init_params(jcfg)
    jp_f = jp_r = _jax(like, params)
    jm_f = jm_r = _jax(like, m)
    tp, tm = _torch(params, tcfg), _torch(m, tcfg)
    for step in range(3):
        g = _grads(params, step)
        jg, tg = _jax(like, g), _torch(g, tcfg)
        jp_f, jm_f = jfused(jp_f, jg, jm_f, jnp.float32(LR), 1e-10)
        jp_r, jm_r = jopt.adagrad_update(jp_r, jg, jm_r, jnp.float32(LR), 1e-10)
        tp, tm = cuda_adagrad.adagrad_update_fused(tp, tg, tm, LR, 1e-10)
        for got, want, what in ((tp, jp_f, "p vs pallas"), (tm, jm_f, "m vs pallas"),
                                (tp, jp_r, "p vs jnp"), (tm, jm_r, "m vs jnp")):
            _assert_sets_close(got, want, f"step {step} {what}")


def test_float64_set_matches_jax(x64):
    """A float64 set (the float64 oracle configuration) on the CPU: the
    plain version computes in fp32 and stores float64, as both JAX
    functions do."""
    kw, params, m = _odd()
    kw["param_dtype"] = "float64"
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: v.astype(np.float64) for k, v in m.items()}
    g = _grads(params, 5, np.float64)
    like = jmodel.init_params(jcfg)
    jg = _jax(like, g)
    tp, tm = cuda_adagrad.adagrad_update_fused(
        _torch(params, tcfg), _torch(g, tcfg), _torch(m, tcfg), LR)
    assert {t.dtype for t in topt.tensors(tp)} == {torch.float64}
    for fn in (jfused, jopt.adagrad_update):
        jp, jm = fn(_jax(like, params), jg, _jax(like, m), jnp.float32(LR), 1e-10)
        _assert_sets_close(tp, jp, f"p vs {fn.__name__}")
        _assert_sets_close(tm, jm, f"m vs {fn.__name__}")


def test_apply_updates_goes_through_the_fused_update(monkeypatch):
    """``apply_updates`` (the trainer's step) updates through
    ``adagrad_update_fused``, once a step, with the scheduled lr."""
    calls = []
    real = topt.adagrad_update_fused

    def spy(params, grads, m, lr, eps):
        calls.append(lr)
        return real(params, grads, m, lr, eps)

    monkeypatch.setattr(topt, "adagrad_update_fused", spy)
    kw, params, m = _odd()
    tcfg = TConfig(**kw)
    p, mm = _torch(params, tcfg), _torch(m, tcfg)
    for step in range(3):
        p, mm, _ = topt.apply_updates(p, _torch(_grads(params, step), tcfg), mm,
                                      step, TTrain(lr=0.1, warmup_steps=1))
    assert calls == [np.float32(0.0), np.float32(0.1), np.float32(0.1)]


class FakeCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


def _fake_set(arrays, cfg):
    params = _torch(arrays, cfg)
    return topt.like(params, (t.as_subclass(FakeCuda)
                              for t in topt.tensors(params)))


def test_the_card_launches_once_for_the_whole_set(monkeypatch):
    """On CUDA tensors the wrapper launches ``adagrad_launch`` once with a
    table of (p, g, m, p_out, m_out, numel) for every tensor of the set
    (eight here), the lr and eps, and counts the launch; it never runs
    the plain version."""
    seen = {}

    class Lib:
        @staticmethod
        def adagrad_launch(count, table, lr, eps, stream, launched):
            seen.update(count=count, table=list(table), lr=lr, eps=eps)
            launched._obj.value = 1
            return 0

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(cuda_adagrad._build, "load_library", lambda: Lib)
    monkeypatch.setattr(cuda_adagrad, "adagrad_update_plain", no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream)
    kw, params, m = _odd()
    cfg = TConfig(**kw)
    p, g, mm = (_fake_set(a, cfg) for a in (params, _grads(params, 0), m))
    before = cuda_adagrad.adagrad_update_fused.launches
    new_p, new_m = cuda_adagrad.adagrad_update_fused(p, g, mm, LR, 1e-10)
    assert cuda_adagrad.adagrad_update_fused.launches == before + 1
    assert seen["count"] == 8 and seen["lr"] == float(LR) and seen["eps"] == 1e-10
    rows = [seen["table"][6 * k: 6 * k + 6] for k in range(8)]
    for row, a, b, c, d, e in zip(rows, *map(topt.tensors, (p, g, mm, new_p, new_m))):
        assert row == [a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       d.data_ptr(), e.data_ptr(), a.numel()]


def test_the_card_refuses_float64_and_mixed_sets(monkeypatch):
    """A float64 set on the card raises before any build; so does a set
    whose tensors do not match the parameters' shapes or device."""
    def no_build():
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(cuda_adagrad._build, "load_library", no_build)
    kw, params, m = _odd()
    cfg = TConfig(**kw, param_dtype="float64")
    p, g, mm = (_fake_set(a, cfg) for a in (params, _grads(params, 0), m))
    with pytest.raises(TypeError, match="float32"):
        cuda_adagrad.adagrad_update_fused(p, g, mm, LR)
    cpu = _torch(params, cfg)
    with pytest.raises(ValueError, match="params has"):
        cuda_adagrad.adagrad_update_fused(p, cpu, mm, LR)
