"""Layer 0's two-step backward, K12 (``cuda_cell_bwd.embed_layer0_bwd_unroll2``,
its plain version on the CPU), against the JAX package with
``EIGEN_LSTM_BWD_UNROLL=2`` (``pallas_cell.py:_bwd_embed_unroll2_kernel``
in interpret mode), and the port's choice of it (``ops/dispatch.py:
bwd_unroll2``) against the JAX package's.

Shapes: one layer, N = 128, M = 256, B = 8, S = 6 (even), where the JAX
package runs its resident layer-0 kernel with the fused VJP.

Tolerances. Against JAX, those of tests/test_torch_flagship_train.py:
float32 rtol 1e-5 on the loss, rtol 2e-4 / atol 1e-6 on the gradients;
bfloat16 rtol 1e-4 on the loss and each gradient within 2e-2 of its
largest magnitude (a float32 sum taken in another order can flip a bf16
rounding, which the recurrence carries). float64: the JAX layer-0 wrapper
hands its kernel b, h0 and c0 in float32 (``pallas_cell.py:1144-1147``),
so its float64 run is 3e-8 from a float64 computation; the port's
float64 unroll-2 run is held to the JAX one at the float32 tolerances
and to the port's own float64 loop (``cell_fn=None``) at rtol 1e-10 /
atol 1e-12. The port's unroll-2 run against its own unroll-1 run: exact,
as K12 and K3 are on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops import pallas_cell as jpc
from eigen_lstm_tpu.ops.dispatch import select_cell_fn as jselect
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.ops import cuda_cell_bwd, dispatch
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn as tselect
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

S, B, N, M = 6, 8, 128, 256
RATE = 0.35
FP32 = (dict(rtol=1e-5), dict(rtol=2e-4, atol=1e-6))
FP64 = (dict(rtol=1e-10), dict(rtol=1e-10, atol=1e-12))


def _arrays(dtype):
    rng = np.random.default_rng(4)
    ft = np.float64 if dtype == "float64" else np.float32
    shapes = {"params.layers[0].W": ((M, 4 * N), 0.3),
              "params.layers[0].U": ((N, 4 * N), 0.3 / np.sqrt(N / 16)),
              "params.layers[0].b": ((4 * N,), 0.3),
              "params.Why": ((N, M), 0.2), "params.by": ((M,), 0.2)}
    arrays = {k: (rng.normal(size=s) * sd).astype(ft)
              for k, (s, sd) in shapes.items()}
    win = rng.integers(0, M, (S + 1, B)).astype(np.int32)
    h, c = ((rng.normal(size=(1, B, N)) * 0.3).astype(ft) for _ in range(2))
    return arrays, win, h, c


def _config(dtype, drop):
    return dict(vocab=M, hidden=N, loss_mode="all", dropout=drop,
                compute_dtype=dtype,
                param_dtype="float64" if dtype == "float64" else "float32")


def _jax_run(monkeypatch, dtype, drop):
    monkeypatch.setenv("EIGEN_LSTM_BWD_UNROLL", "2")
    jpc._make_fused_embed_seq.cache_clear()
    arrays, win, h, c = _arrays(dtype)
    jcfg = JConfig(**_config(dtype, drop))
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    cell = jselect("pallas", jcfg, B, interpret=True)
    assert cell.embed_layer0.__name__ == "pallas_embed_layer0"
    dkey = jax.random.PRNGKey(23) if drop else None
    seeds = (int(np.asarray(jmodel._drop_seed(dkey, 0))[0]),) if drop else None

    def f(p):
        return jmodel.loss_fn(p, jnp.asarray(win[:-1]), jnp.asarray(win[1:]),
                              jnp.asarray(h), jnp.asarray(c), jcfg, cell,
                              dkey)[0]

    try:
        loss, grads = jax.value_and_grad(f)(jp)
    finally:
        jpc._make_fused_embed_seq.cache_clear()
    return float(loss), jckpt._flatten(grads, "params"), seeds


def _port_run(monkeypatch, dtype, drop, unroll, seeds, backend="auto"):
    """The port's loss and gradients with ``EIGEN_LSTM_BWD_UNROLL=unroll``
    (``backend`` None: the model's own loop), and the number of calls of
    K3's and K12's plain versions."""
    monkeypatch.setenv("EIGEN_LSTM_BWD_UNROLL", str(unroll))
    calls = {"K3": 0, "K12": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    with monkeypatch.context() as mp:
        mp.setattr(cuda_cell_bwd, "embed_layer0_bwd_plain",
                   counted("K3", cuda_cell_bwd.embed_layer0_bwd_plain))
        mp.setattr(cuda_cell_bwd, "embed_layer0_bwd_unroll2_plain",
                   counted("K12", cuda_cell_bwd.embed_layer0_bwd_unroll2_plain))
        arrays, win, h, c = _arrays(dtype)
        tcfg = TConfig(**_config(dtype, drop))
        loss, _, _, grads = loss_and_grads(
            tckpt.params_from_numpy(arrays, tcfg, "cpu"),
            torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
            torch.from_numpy(h), torch.from_numpy(c), tcfg,
            backend and tselect(backend, tcfg, B, "cpu"), seeds)
    return float(loss), {k: v.numpy() for k, v in grads.named_tensors()}, calls


def _assert_close(tl, tg, wl, wg, tols):
    loss_tol, grad_tol = tols
    np.testing.assert_allclose(tl, wl, **loss_tol)
    for key in wg:
        np.testing.assert_allclose(tg[key], wg[key], **grad_tol, err_msg=key)


@pytest.mark.parametrize("drop", [0.0, RATE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_unroll2_matches_jax_and_equals_unroll1(monkeypatch, request, dtype,
                                                drop):
    """The loss and all five gradients of one layer through K12's plain
    version against the JAX package's unroll-2 path, with and without
    fused dropout (the JAX seeds); the same run through K3's plain version
    gives the same bits."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    jl, jg, seeds = _jax_run(monkeypatch, dtype, drop)
    tl, tg, calls = _port_run(monkeypatch, dtype, drop, 2, seeds)
    assert calls == {"K3": 1, "K12": 1}   # K12's plain version calls K3's
    if dtype == "bfloat16":
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        for key in jg:
            err = np.abs(tg[key] - jg[key]).max() / np.abs(jg[key]).max()
            assert err <= 2e-2, (key, err)
    else:
        _assert_close(tl, tg, jl, jg, FP32)
    if dtype == "float64" and not drop:
        _assert_close(tl, tg, *_port_run(monkeypatch, dtype, drop, 2, seeds,
                                         None)[:2], FP64)
    l1, g1, calls1 = _port_run(monkeypatch, dtype, drop, 1, seeds)
    assert calls1 == {"K3": 1, "K12": 0}
    assert l1 == tl
    for key in g1:
        np.testing.assert_array_equal(tg[key], g1[key], err_msg=key)


def _jax_line(capsys, s, b, n, cdtype, rdtype, defer):
    jpc._make_fused_embed_seq.cache_clear()
    jpc._make_fused_embed_seq(s, b, n, M, "reference", cdtype, rdtype, True,
                              1, (), 1, defer, 0.0, 2)
    jpc._make_fused_embed_seq.cache_clear()
    return capsys.readouterr().out


# (hidden, layers, batch, S, compute, residual, DEFER, JAX takes unroll-2):
# the documented 1x512 run (B = 64, fp32 residuals, the CLI's auto rule
# there), the root bench.py's batch in both residual types, the flagship's
# shape, an odd S and the deferred schedule
SELECTIONS = [
    (512, 1, 64, 100, "bfloat16", "float32", False, True),
    (512, 1, 128, 100, "bfloat16", "float32", False, False),
    (512, 1, 128, 100, "bfloat16", "bfloat16", False, True),
    (1024, 3, 128, 256, "bfloat16", "float32", False, False),
    (512, 1, 64, 99, "bfloat16", "float32", False, False),
    (512, 1, 64, 100, "bfloat16", "float32", True, False),
]


@pytest.mark.parametrize("n,layers,b,s,cdtype,rdtype,defer,takes", SELECTIONS)
def test_selection_and_fallback_line_match_jax(monkeypatch, capsys, n, layers,
                                               b, s, cdtype, rdtype, defer,
                                               takes):
    """``bwd_unroll2`` takes K12 exactly where the JAX package takes its
    unroll-2 kernel, and where unroll 2 is asked for and not taken prints
    the JAX package's line, once per shape and config; without the knob it
    takes K3 and prints nothing."""
    monkeypatch.setenv("EIGEN_LSTM_BWD_UNROLL", "2")
    monkeypatch.setenv("EIGEN_LSTM_BWD_DEFER", "1" if defer else "0")
    cfg = TConfig(hidden=n, num_layers=layers, compute_dtype=cdtype,
                  residual_dtype=rdtype)
    fused = dispatch.fused_accum_ok(cfg, b)
    assert dispatch.families(cfg, b)[1] == ("embed_fused" if fused
                                            else "embed_fallback")
    dispatch._unroll2_choice.cache_clear()
    assert dispatch.bwd_unroll2(cfg, s, b, fused) is takes
    assert dispatch.bwd_unroll2(cfg, s, b, fused) is takes
    got = capsys.readouterr().out
    want = _jax_line(capsys, s, b, n, cdtype, rdtype, defer)
    assert got == want
    assert (got == "") is takes
    monkeypatch.setenv("EIGEN_LSTM_BWD_UNROLL", "1")
    assert dispatch.bwd_unroll2(cfg, s, b, fused) is False
    assert capsys.readouterr().out == ""


def test_knob_needs_the_jax_resident_layer0(monkeypatch, capsys):
    """Where the JAX package runs no resident layer-0 kernel (its XLA scan
    at hidden 96, its tiled embed at hidden 2048) the knob changes nothing
    and prints nothing, as there."""
    monkeypatch.setenv("EIGEN_LSTM_BWD_UNROLL", "2")
    dispatch._unroll2_choice.cache_clear()
    for cfg in (TConfig(hidden=96), TConfig(hidden=2048, compute_dtype="bfloat16",
                                            residual_dtype="bfloat16")):
        assert dispatch.families(cfg, 128)[1] in ("xla", "tiled_embed")
        assert dispatch.bwd_unroll2(cfg, 100, 128, True) is False
    assert capsys.readouterr().out == ""


def test_wrapper_takes_even_s_only_and_counts_no_launch_on_the_cpu():
    """K12's wrapper refuses an odd S; on CPU tensors it runs the plain
    version (no launch) and equals K3's wrapper exactly."""
    cfg = TConfig(hidden=32, vocab=16)
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    s, b, n = 4, 3, 32
    g_seq = torch.sigmoid(t(s, b, 4 * n))
    args = (t(n, 4 * n), g_seq, t(s, b, n), t(s, b, n),
            torch.from_numpy(rng.integers(0, 16, (s, b))), t(b, n), t(b, n),
            t(s, b, n), t(b, n), t(b, n), cfg)
    before = cuda_cell_bwd.embed_layer0_bwd_unroll2.launches
    got = cuda_cell_bwd.embed_layer0_bwd_unroll2(*args)
    want = cuda_cell_bwd.embed_layer0_bwd(*args)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert cuda_cell_bwd.embed_layer0_bwd_unroll2.launches == before
    odd = [a[:3] if i in (1, 2, 3, 4, 7) else a for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="even S"):
        cuda_cell_bwd.embed_layer0_bwd_unroll2(*odd)
    with pytest.raises(ValueError, match="even S"):
        cuda_cell_bwd.embed_layer0_bwd_unroll2_plain(*odd)
