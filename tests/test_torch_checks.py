"""The trainer's live checks, ported: ``utils/gradcheck.check_gradients``
against the JAX package's, ``Trainer.crosscheck`` against the JAX
``loss_fn`` and ``global_norm`` at the same state, a planted bug that both
checks must catch, their cadence in ``Trainer.run`` and the CLI's flags.

The port's kernels run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode and its XLA scan.

Tolerances. ``check_gradients`` on one loss, a numpy function that both
call: the same sampled entries and counts, and each tensor's max and mean
relative errors within 1e-9 of the JAX function's. On the model's float64
loss, the port's loop against the JAX XLA scan: the same entries, and
every tensor's max and mean errors below 1e-4 in both (far inside the
pass thresholds 1e-1 and 1e-3). The errors there are finite-difference
noise: the two losses differ by float64 roundoff, ~5e-16, which a central
difference at 1e-5 turns into ~5e-11 of a derivative, and small
derivatives give relative errors of 1e-6 that differ between the two.
``crosscheck``: both losses and both gradient norms within rtol 1e-5 of
the JAX values (float32, tests/test_pallas_cell.py's loss tolerance).
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
from eigen_lstm_tpu.train import optimizer as jopt
from eigen_lstm_tpu.utils import gradcheck as jgc
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig as TData
from eigen_lstm_tpu_torch.config import TrainConfig as TTrain
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn as tselect
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train.trainer import Trainer as TTrainer
from eigen_lstm_tpu_torch.utils import gradcheck as tgc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALICE = os.path.join(ROOT, "data/alice29.txt")


def _arrays(vocab, hidden, layers, ft, seed, sd=0.3):
    rng = np.random.default_rng(seed)
    arrays = {}
    for l in range(layers):
        arrays[f"params.layers[{l}].W"] = rng.normal(size=(vocab if l == 0 else hidden, 4 * hidden)) * sd
        arrays[f"params.layers[{l}].U"] = rng.normal(size=(hidden, 4 * hidden)) * sd
        arrays[f"params.layers[{l}].b"] = rng.normal(size=(4 * hidden,)) * sd
    arrays["params.Why"] = rng.normal(size=(hidden, vocab)) * sd
    arrays["params.by"] = rng.normal(size=(vocab,)) * sd
    return {k: v.astype(ft) for k, v in arrays.items()}


def _perturbed(leaves, base):
    """(tensor index, flat index) of the one entry that differs from base."""
    for i, (a, b) in enumerate(zip(leaves, base)):
        diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
        if diff.size:
            return i, int(diff[0])
    return None


@pytest.mark.parametrize("mode", ["last", "all"])
def test_check_gradients_matches_jax(x64, mode):
    """Both functions on the model's float64 loss (2 layers, the port's
    own loop and the XLA scan), seed and sample count: the same entries, in
    the same order, and errors that are noise in both."""
    kw = dict(vocab=12, hidden=6, num_layers=2, loss_mode=mode,
              param_dtype="float64", compute_dtype="float64")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    arrays = _arrays(12, 6, 2, np.float64, 1)
    rng = np.random.default_rng(7)
    ids, tgt = (rng.integers(0, 12, (5, 3)).astype(np.int32) for _ in range(2))
    h, c = (rng.normal(size=(2, 3, 6)) * 0.1 for _ in range(2))

    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    jbase = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    jseen = []

    def jloss(p):
        jseen.append(_perturbed(jax.tree_util.tree_leaves(p), jbase))
        return jmodel.loss_fn(p, jnp.asarray(ids), jnp.asarray(tgt),
                              jnp.asarray(h), jnp.asarray(c), jcfg)[0]

    jgrad = jax.grad(lambda p: jmodel.loss_fn(
        p, jnp.asarray(ids), jnp.asarray(tgt), jnp.asarray(h), jnp.asarray(c),
        jcfg)[0])(jp)
    want = jgc.check_gradients(jloss, jp, jgrad, samples_per_tensor=10, seed=3)

    tp = tckpt.params_from_numpy(arrays, tcfg, "cpu")
    tbase = [x.numpy() for x in tmodel.tensors(tp)]
    tseen = []
    th, tc = torch.from_numpy(h), torch.from_numpy(c)

    def tloss(p):
        tseen.append(_perturbed([x.numpy() for x in tmodel.tensors(p)], tbase))
        return tmodel.loss_fn(p, torch.from_numpy(ids), torch.from_numpy(tgt),
                              th, tc, tcfg)[0]

    leaves = [x.clone().requires_grad_() for x in tmodel.tensors(tp)]
    loss = tmodel.loss_fn(tmodel.like(tp, leaves), torch.from_numpy(ids),
                          torch.from_numpy(tgt), th, tc, tcfg)[0]
    tgrad = tmodel.like(tp, torch.autograd.grad(loss, leaves))
    got = tgc.check_gradients(tloss, tp, tgrad, samples_per_tensor=10, seed=3)

    assert tseen == jseen and len(tseen) == 2 * 8 * 10
    assert list(got) == list(want)
    for name in want:
        assert got[name].n_checked == want[name].n_checked == 10
        for r in (got[name], want[name]):
            assert r.max_rel_err < 1e-4 and r.mean_rel_err < 1e-4, (name, r)


def _assert_results_close(got, want, tol):
    assert list(got) == list(want)
    for name in want:
        assert got[name].n_checked == want[name].n_checked
        assert abs(got[name].max_rel_err - want[name].max_rel_err) <= tol, name
        assert abs(got[name].mean_rel_err - want[name].mean_rel_err) <= tol, name


@pytest.mark.parametrize("rel_floor", [0.0, 1e-1])
def test_check_gradients_equals_jax_on_one_loss(x64, rel_floor):
    """Both functions on one numpy loss of every tensor, with analytic
    gradients that are off in two tensors: the same entries and the same
    errors, floors included."""
    kw = dict(vocab=12, hidden=6, num_layers=2, param_dtype="float64",
              compute_dtype="float64")
    arrays = _arrays(12, 6, 2, np.float64, 5)
    keys = list(arrays)
    coef = {k: np.random.default_rng(i).normal(size=v.shape)
            for i, (k, v) in enumerate(arrays.items())}

    def loss(leaves):
        return sum(float(np.sum(np.sin(a) * coef[k] + 0.5 * a ** 3))
                   for k, a in zip(keys, leaves))

    grads = {k: np.cos(a) * coef[k] + 1.5 * a ** 2 for k, a in arrays.items()}
    grads["params.layers[0].U"] *= 1.01
    grads["params.by"] += 1e-3
    jp = jckpt._unflatten_like(jmodel.init_params(JConfig(**kw)), "params", arrays)
    jg = jckpt._unflatten_like(jp, "params", grads)
    want = jgc.check_gradients(
        lambda p: loss([np.asarray(x) for x in jax.tree_util.tree_leaves(p)]),
        jp, jg, samples_per_tensor=20, seed=11, rel_floor=rel_floor)
    tcfg = TConfig(**kw)
    got = tgc.check_gradients(
        lambda p: loss([x.numpy() for x in tmodel.tensors(p)]),
        tckpt.params_from_numpy(arrays, tcfg, "cpu"),
        tckpt.params_from_numpy(grads, tcfg, "cpu"),
        samples_per_tensor=20, seed=11, rel_floor=rel_floor)
    _assert_results_close(got, want, 1e-9)
    assert not got[".layers[0].U"].passed or rel_floor


def _trainer(cfg, batch=8, seq=12, cell_fn="plain", streaming=False, **tkw):
    data = jcorpus.rawread(ALICE)[:20000]
    if cell_fn == "plain":
        cell_fn = tselect("plain", cfg, batch, "cpu")
    return TTrainer(cfg, TData(batch=batch, seq=seq),
                    TTrain(superstep=1, **tkw), data, None, cell_fn=cell_fn,
                    streaming=streaming, device="cpu")


def test_crosscheck_matches_jax_at_the_same_state():
    """``crosscheck`` at the trainer's current windows and state: its
    kernel-path loss and gradient norm against the JAX package's Pallas
    path (interpret mode), its plain-loop values against the JAX XLA scan;
    a streamed trainer checks the same windows."""
    kw = dict(vocab=256, hidden=128, loss_mode="all")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    arrays = _arrays(256, 128, 1, np.float32, 2, sd=0.1)
    tr = _trainer(tcfg)
    tr.state.params = tckpt.params_from_numpy(arrays, tcfg, "cpu")
    tr.state.h.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
    res = tr.crosscheck(quiet=True)
    assert res["ok"] and tr.crosscheck_failures == 0
    x, t = (a.numpy() for a in tr._current_windows())
    streamed = _trainer(tcfg, streaming=True)
    streamed.state = tr.state
    for a, b in zip(streamed._current_windows(), (x, t)):
        np.testing.assert_array_equal(a.numpy(), b)

    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    h, c = (jnp.asarray(a.numpy()) for a in (tr.state.h, tr.state.c))
    for cell, key in ((jselect("pallas", jcfg, 8, interpret=True), "kernels"),
                      (None, "plain")):
        loss, grads = jax.value_and_grad(lambda p: jmodel.loss_fn(
            p, jnp.asarray(x), jnp.asarray(t), h, c, jcfg, cell)[0])(jp)
        np.testing.assert_allclose(res[f"loss_{key}"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(res[f"gnorm_{key}"],
                                   float(jopt.global_norm(grads)), rtol=1e-5)


class _ScaleGrad(torch.autograd.Function):
    """The identity whose backward scales the gradient by 1.1."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * 1.1


def _buggy(cell_fn):
    """``cell_fn`` whose backward hands back 1.1 dU in every layer."""
    def bad(layer):
        return tmodel.LayerParams(layer.W, _ScaleGrad.apply(layer.U), layer.b)

    def scan(layer, xw, h0, c0, cfg, **kw):
        return cell_fn(bad(layer), xw, h0, c0, cfg, **kw)

    scan.embed_layer0 = (lambda layer, ids, h0, c0, cfg, **kw:
                         cell_fn.embed_layer0(bad(layer), ids, h0, c0, cfg, **kw))
    scan.fused_dropout = True
    scan.fused_head = cell_fn.fused_head
    return scan


def test_a_planted_backward_bug_fails_both_checks():
    """A ``cell_fn`` whose backward scales dU by 1.1: ``crosscheck`` counts
    a failure (float32), and the float64 ``gradcheck``, which checks the
    live backward, fails; the healthy ``cell_fn`` passes both. The float32
    config's gradcheck runs a float64 shadow through the model's own loop,
    so it passes with the bug: the live kernels are ``crosscheck``'s."""
    for dtype in ("float32", "float64"):
        cfg = TConfig(vocab=256, hidden=32, num_layers=2, loss_mode="all",
                      init_std=0.3, param_dtype=dtype, compute_dtype=dtype)
        healthy = tselect("plain", cfg, 4, "cpu")
        for cell_fn, bug in ((healthy, False), (_buggy(healthy), True)):
            tr = _trainer(cfg, batch=4, seq=8, cell_fn=cell_fn)
            if dtype == "float32":
                assert tr.crosscheck(quiet=True)["ok"] is not bug
                assert tr.crosscheck_failures == int(bug)
                assert tr.gradcheck(samples_per_tensor=4, quiet=True)
            else:
                assert tr.gradcheck(samples_per_tensor=8, quiet=True) is not bug
                assert tr.gradcheck_failures == int(bug)


def test_trainer_runs_the_checks_on_their_cadence(monkeypatch):
    """``run`` calls ``crosscheck`` every ``crosscheck_every`` supersteps
    (only with a ``cell_fn``) and ``gradcheck`` every ``gradcheck_every``
    with ``gradcheck_samples`` and rel_floor 1e-4, as the JAX trainer."""
    calls = []
    monkeypatch.setattr(TTrainer, "crosscheck",
                        lambda self, quiet: calls.append(("cross", self.step)))
    monkeypatch.setattr(TTrainer, "gradcheck",
                        lambda self, **kw: calls.append(("grad", self.step, kw)))
    cfg = TConfig(hidden=32, loss_mode="all")
    kw = dict(crosscheck_every=2, gradcheck_every=3, gradcheck_samples=5)
    _trainer(cfg, **kw).run(steps=6, quiet=True)
    gkw = dict(samples_per_tensor=5, quiet=True, rel_floor=1e-4)
    assert calls == [("cross", 2), ("grad", 3, gkw), ("cross", 4),
                     ("cross", 6), ("grad", 6, gkw)]
    calls.clear()
    _trainer(cfg, cell_fn=None, **kw).run(steps=6, quiet=True)
    assert calls == [("grad", 3, gkw), ("grad", 6, gkw)]


def test_cli_flags_reach_the_trainer_and_run(capsys):
    """``--crosscheck``, ``--gradcheck-every``, ``--gradcheck`` and
    ``--scan-chunk`` reach the configs, and a short CPU run prints both
    checks' lines."""
    args = tcli.build_parser().parse_args(
        ["train", "--data", ALICE, "--crosscheck", "5", "--gradcheck-every",
         "7", "--scan-chunk", "4"])
    mcfg, _, tcfg = tcli._configs(args)
    assert (tcfg.crosscheck_every, tcfg.gradcheck_every, mcfg.scan_chunk) == (5, 7, 4)
    tcli.main(["train", "--data", ALICE, "--hidden", "32", "--batch", "4",
               "--seq", "8", "--steps", "2", "--superstep", "1", "--crosscheck",
               "1", "--gradcheck", "--gradcheck-every", "2", "--scan-chunk", "4",
               "--sample-chars", "0", "--eval-chars", "200", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[crosscheck]") == 2 and "MISMATCH" not in out
    # the check before training runs at rel_floor 0, on the weights as
    # initialised; the mid-run one at rel_floor 1e-4 passes
    assert out.count("[gradcheck] step 0") == 5
    mid = [line for line in out.splitlines() if "[gradcheck] step 2" in line]
    assert len(mid) == 5 and all(line.endswith(" ok") for line in mid)
