"""The flagship's training path, ported, against the JAX package: ``loss_fn``
of three layers with fused dropout and all eleven gradients, a 2-layer
``Trainer`` trajectory, the dropout ``Trainer`` and its resume, and the
CLI's ``train --dropout`` and ``--resume`` of a 3-layer checkpoint with
its Adagrad state, including the flagship's own, whose cursors index a
corpus that is not in the repository.

The JAX side runs its Pallas kernels in interpret mode
(``select_cell_fn("pallas", ..., interpret=True)``), the port's the
kernels' plain versions (``select_cell_fn("auto", ..., "cpu")``). The port
takes the JAX package's per-layer dropout seeds (``_drop_seed(dkey, l)``)
as its ``dropout_key``, so both draw the same masks.

Shapes: 3 layers, N = 128, M = 256, B = 8, S = 12.

Tolerances. float32: rtol 1e-5 on the loss, rtol 2e-4 / atol 1e-6 on the
gradients (tests/test_pallas_cell.py:60-87). bfloat16: rtol 1e-4 on the
loss and each gradient within 2e-2 of its largest magnitude (a float32
sum taken in another order can flip one bf16 rounding of dg, dlog or dh,
which the recurrence carries), and each gradient a bf16 value exactly
where the JAX VJP's is: dW, dU of every layer and dWhy are rounded to
bf16, db and dby are not. The trajectory: as
tests/test_torch_train_loop.py, within 10 times the JAX package's own gap
between its Pallas and XLA runs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import DataConfig as JData
from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu import TrainConfig as JTrain
from eigen_lstm_tpu.data import corpus as jcorpus
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.dispatch import select_cell_fn as jselect
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train.trainer import Trainer as JTrainer
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig as TData
from eigen_lstm_tpu_torch.config import TrainConfig as TTrain
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn as tselect
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train.trainer import Trainer as TTrainer
from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALICE = os.path.join(ROOT, "data/alice29.txt")
BIBLE = os.path.join(ROOT, "data/cantrbry/bible.txt")
FLAGSHIP = os.path.join(ROOT, "artifacts/flagship_drop/ckpt_best.npz")
L, S, B, N, M = 3, 12, 8, 128, 256
RATE = 0.35
BF16_ROUNDED = {"W", "U", "Why"}


def _arrays(seed):
    """npz-keyed parameters of 3 x 128 that make the gates move, a window
    of alice29.txt, and a stream state."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for l in range(L):
        arrays[f"params.layers[{l}].W"] = rng.normal(size=(M if l == 0 else N, 4 * N)) * 0.2
        arrays[f"params.layers[{l}].U"] = rng.normal(size=(N, 4 * N)) * 0.2 / np.sqrt(N / 16)
        arrays[f"params.layers[{l}].b"] = rng.normal(size=(4 * N,)) * 0.2
    arrays["params.Why"] = rng.normal(size=(N, M)) * 0.2
    arrays["params.by"] = rng.normal(size=(M,)) * 0.2
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    data = jcorpus.rawread(ALICE)
    pos = rng.integers(0, len(data) - S - 1, B)
    win = np.stack([data[p: p + S + 1] for p in pos], axis=1).astype(np.int32)
    h, c = ((rng.normal(size=(L, B, N)) * 0.3).astype(np.float32) for _ in range(2))
    return arrays, win, h, c


def _run_both(dtype, drop, seed=0):
    arrays, win, h, c = _arrays(seed)
    kw = dict(vocab=M, hidden=N, num_layers=L, loss_mode="all",
              compute_dtype=dtype, dropout=drop)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    cell = jselect("pallas", jcfg, B, interpret=True)
    dkey = jax.random.PRNGKey(17) if drop else None
    seeds = (tuple(int(np.asarray(jmodel._drop_seed(dkey, l))[0])
                   for l in range(L)) if drop else None)

    def f(p):
        return jmodel.loss_fn(p, jnp.asarray(win[:-1]), jnp.asarray(win[1:]),
                              jnp.asarray(h), jnp.asarray(c), jcfg, cell, dkey)

    (jl, ((jh, jc), _)), jg = jax.value_and_grad(f, has_aux=True)(jp)
    tl, (th, tc), _, tg = loss_and_grads(
        tckpt.params_from_numpy(arrays, tcfg, "cpu"),
        torch.from_numpy(win[:-1]), torch.from_numpy(win[1:]),
        torch.from_numpy(h), torch.from_numpy(c), tcfg,
        tselect("auto", tcfg, B, "cpu"), seeds)
    jflat = jckpt._flatten(jg, "params")
    tflat = {k: v.numpy() for k, v in tg.named_tensors()}
    assert sorted(tflat) == sorted(jflat) and len(tflat) == 11
    return (float(jl), np.asarray(jh), np.asarray(jc), jflat), \
        (float(tl), th.numpy(), tc.numpy(), tflat)


@pytest.mark.parametrize("drop", [0.0, RATE])
def test_loss_and_eleven_gradients_match_jax_fp32(drop):
    """Three layers through K1, K2, K3, K6 and the head (plain versions)
    with the masks of the JAX package's seeds: loss, carried state and the
    eleven gradients."""
    (jl, jh, jc, jg), (tl, th, tc, tg) = _run_both("float32", drop)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)
    for key in jg:
        assert tg[key].shape == jg[key].shape, key
        np.testing.assert_allclose(tg[key], jg[key], rtol=2e-4, atol=1e-6,
                                   err_msg=key)


def _bf16_valued(x) -> bool:
    t = torch.from_numpy(np.array(x, np.float32))
    return bool((t.bfloat16().float() == t).all())


def test_loss_and_eleven_gradients_match_jax_bf16():
    """bf16 with dropout: the loss, each gradient within 2e-2, and each
    gradient's bf16-value property that of the JAX VJPs (layers >= 1: dW
    from the matmul VJP and dU from ``_bwd_core`` rounded, db the fp32 sum
    of the bf16 dg sequence, not)."""
    (jl, _, _, jg), (tl, _, _, tg) = _run_both("bfloat16", RATE)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for key in jg:
        err = np.abs(tg[key] - jg[key]).max() / np.abs(jg[key]).max()
        assert err <= 2e-2, (key, err)
        want = key.rsplit(".", 1)[-1] in BF16_ROUNDED
        assert _bf16_valued(jg[key]) == want, key      # the JAX rule itself
        assert _bf16_valued(tg[key]) == want, key


def test_two_layer_trainer_trajectory_matches_jax(tmp_path):
    """20 streamed steps of the port's ``Trainer`` on two layers (K1, K2,
    K3, K6 and the head, plain versions) and of the JAX ``Trainer`` (its
    Pallas kernels in interpret mode) from the JAX trainer's saved initial
    state; per-step bits and the final parameters within 10x the JAX
    package's own Pallas-against-XLA gap on the same steps."""
    kw = dict(hidden=128, num_layers=2, loss_mode="all")
    dkw = dict(batch=8, seq=16, train_percent=0.9)
    tkw = dict(lr=0.05, warmup_steps=3, superstep=1, steps=20, eval_every_s=1e9)
    data = jcorpus.rawread(ALICE)[:40000]
    train, test = jcorpus.split(data, dkw["train_percent"])
    jcfg = JConfig(**kw)
    runs = {}
    init = str(tmp_path / "init.npz")
    for name, cell in (("pallas", jselect("pallas", jcfg, 8, interpret=True)),
                       ("xla", None)):
        tr = JTrainer(jcfg, JData(**dkw), JTrain(**tkw), train, test,
                      cell_fn=cell, streaming=True)
        if name == "pallas":
            tr.save(init)
        bits = []
        for _ in range(20):
            tr.state, met = tr.dispatch_superstep()
            bits.append(float(met["bits_mean"]))
        runs[name] = (np.array(bits), jckpt._flatten(tr.state.params, "params"))
    tcfg = TConfig(**kw)
    tt = TTrainer(tcfg, TData(**dkw), TTrain(**tkw), train, test,
                  cell_fn=tselect("auto", tcfg, 8, "cpu"), streaming=True,
                  device="cpu")
    tt.restore(init)
    bits = []
    for _ in range(20):
        tt.state, met = tt.dispatch_superstep()
        bits.append(float(met["bits_mean"]))
    bits = np.array(bits)
    (jb, jparams), (xb, xparams) = runs["pallas"], runs["xla"]
    assert bits[0] > 7.0 and bits[-1] < bits[0] - 1.0      # it learns
    gap_bits = max(np.abs(jb - xb).max(), 1e-7)
    np.testing.assert_array_less(np.abs(bits - jb), 10 * gap_bits)
    for k, v in tt.state.params.named_tensors():
        gap = max(np.abs(jparams[k] - xparams[k]).max(), 1e-9)
        assert np.abs(v.numpy() - jparams[k]).max() <= 10 * gap, k


def _dropout_trainer(tmp_path=None, superstep=5):
    data = jcorpus.rawread(ALICE)[:30000]
    train, test = jcorpus.split(data, 0.9)
    cfg = TConfig(hidden=64, num_layers=2, loss_mode="all", dropout=RATE)
    tkw = dict(lr=0.05, warmup_steps=0, superstep=superstep, eval_every_s=1e9,
               seed=7)
    return TTrainer(cfg, TData(batch=8, seq=16), TTrain(**tkw), train, test,
                    cell_fn=tselect("auto", cfg, 8, "cpu"), streaming=True,
                    device="cpu")


def test_dropout_trainer_learns_and_resumes_exactly(tmp_path):
    """Dropout through the fused path: the bits fall, and 2 supersteps
    straight give the parameters, accumulators and stream state of 1
    superstep, a checkpoint, a resume into a fresh trainer and 1 more, bit
    for bit: each step's masks derive from (seed, step) alone."""
    tr = _dropout_trainer()
    bits = []
    for _ in range(8):
        tr.state, met = tr.dispatch_superstep()
        bits.append(float(met["bits_mean"]))
    assert bits[0] > 6.0 and bits[-1] < bits[0] - 1.5, bits

    straight = _dropout_trainer()
    for _ in range(2):
        straight.state, _ = straight.dispatch_superstep()
    first = _dropout_trainer()
    first.state, _ = first.dispatch_superstep()
    first.save(str(tmp_path / "ckpt.npz"))
    resumed = _dropout_trainer()
    resumed.restore(str(tmp_path / "ckpt.npz"))
    resumed.state, _ = resumed.dispatch_superstep()
    assert resumed.step == straight.step == 10
    for a, b in ((straight.state.params, resumed.state.params),
                 (straight.state.m, resumed.state.m)):
        for (k, x), (_, y) in zip(a.named_tensors(), b.named_tensors()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    for x, y in ((straight.state.h, resumed.state.h),
                 (straight.state.c, resumed.state.c),
                 (straight.state.positions, resumed.state.positions)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_restore_replaces_cursors_outside_the_corpus(tmp_path, capsys):
    """A checkpoint whose cursors lie past this corpus: those streams take
    the trainer's fresh cursors and a reset state, the others keep theirs,
    and the restore says so."""
    tr = _dropout_trainer()
    tr.state.h = torch.ones_like(tr.state.h)
    saved = tr.state.positions.flip(0)
    saved[[1, 5]] = torch.tensor([10**8, -3], dtype=saved.dtype)
    tr.state.positions = saved
    tr.save(str(tmp_path / "far.npz"))
    other = _dropout_trainer()
    fresh = other.state.positions.clone()
    other.restore(str(tmp_path / "far.npz"))
    assert "2 of 8 cursors" in capsys.readouterr().out
    want = saved.clone()
    want[[1, 5]] = fresh[[1, 5]]
    torch.testing.assert_close(other.state.positions, want, rtol=0, atol=0)
    assert bool((other.state.h[:, [1, 5]] == 0).all())
    assert bool((other.state.h[:, [0, 2, 3, 4, 6, 7]] == 1).all())
    np.testing.assert_array_equal(other.feeder.positions, want.numpy())


def test_cli_trains_three_layers_with_dropout_and_resumes(tmp_path, capsys):
    """``train --dropout`` on three layers writes a checkpoint with its
    Adagrad state, and ``--resume`` continues from its step; then one step
    of the 3x1024 flagship from its own weights and accumulators, whose
    cursors index a corpus that is not in the repository, on bible.txt."""
    base = ["train", "--data", ALICE, "--hidden", "32", "--layers", "3",
            "--batch", "8", "--seq", "16", "--dropout", "0.35",
            "--superstep", "2", "--sample-chars", "0", "--eval-chars", "500",
            "--device", "cpu"]
    tcli.main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path)])
    with np.load(tmp_path / "ckpt.npz") as z:
        assert "opt.layers[2].U" in z.files and "data/positions" in z.files
    capsys.readouterr()
    tcli.main(base + ["--steps", "2", "--resume", str(tmp_path / "ckpt.npz")])
    out = capsys.readouterr().out
    assert "at step 4" in out and "final test bpc" in out
    assert tcli._configs(tcli.build_parser().parse_args(base))[0].dropout == 0.35

    tcli.main(["train", "--data", BIBLE, "--hidden", "1024", "--layers", "3",
               "--batch", "128", "--seq", "4", "--dropout", "0.35",
               "--lr", "0.005", "--warmup", "0", "--clip-norm", "2.0",
               "--superstep", "1", "--steps", "1", "--log-every", "1",
               "--eval-chars", "64", "--sample-chars", "0",
               "--resume", FLAGSHIP, "--device", "cpu"])
    out = capsys.readouterr().out
    with np.load(FLAGSHIP) as z:
        pos = z["data/positions"]
    limit = int(os.path.getsize(BIBLE) * 0.95) - 4 - 1
    outside = int(((pos < 0) | (pos > limit)).sum())
    assert 0 < outside < 128        # the others index bible.txt by chance
    assert f"{outside} of 128 cursors" in out and "at step 785000" in out
    # a 64-byte eval from a reset state: finite, not yet the model's 2.28
    bpc = float(out.split("final test bpc:")[1].split()[0])
    assert np.isfinite(bpc) and bpc < 8.0
