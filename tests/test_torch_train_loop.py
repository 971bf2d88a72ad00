"""The port's training loop against the JAX package's: the cursors and the
streamed windows, Adagrad with its warm-up and clipping, checkpoints in both
directions, and a 20-step ``Trainer`` trajectory from the same initial
state; then the trainer's refusals, the CLI's ``train`` and the bench on the
CPU.

Tolerances. Cursors, wrap masks and windows: exact. Adagrad: rtol 1e-6 on
parameters and accumulators, atol 1e-7 on parameters (the same fp32
arithmetic with rsqrt from another library: an ulp of a step of size
lr = 0.1 is 7e-9, and a parameter that the step brings near zero keeps
that absolute error). Checkpoints: exact. The trajectory: per-step bits and final
parameters within 10 times the JAX package's own gap between its Pallas
(interpret mode) and XLA runs of the same 20 steps, measured by the test.
"""

import json
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
from eigen_lstm_tpu.data import streaming as jstreaming
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.dispatch import select_cell_fn as jselect
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import metrics as jmetrics
from eigen_lstm_tpu.train import optimizer as jopt
from eigen_lstm_tpu.train.trainer import Trainer as JTrainer
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch import bench as tbench
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig as TData
from eigen_lstm_tpu_torch.config import TrainConfig as TTrain
from eigen_lstm_tpu_torch.data import corpus as tcorpus
from eigen_lstm_tpu_torch.data import streaming as tstreaming
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn as tselect
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import metrics as tmetrics
from eigen_lstm_tpu_torch.train import optimizer as topt
from eigen_lstm_tpu_torch.train.trainer import Trainer as TTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALICE = os.path.join(ROOT, "data/alice29.txt")


@pytest.mark.parametrize("stride", [1, 7, 16])
def test_cursors_and_wrap_masks_equal_jax(stride):
    """``advance_positions`` over 250 steps of a 100-byte corpus, where
    every cursor wraps at least twice: positions and wrap masks exact."""
    length, seq = 100, 16
    start = np.random.default_rng(stride).integers(0, length - seq - 1, 12)
    jp, tp = jnp.asarray(start, jnp.int32), torch.from_numpy(start.astype(np.int32))
    wraps = 0
    for _ in range(250):
        jp, jw = jcorpus.advance_positions(jp, stride, length, seq)
        tp, tw = tcorpus.advance_positions(tp, stride, length, seq)
        assert tp.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        wraps += int(tw.sum())
    assert wraps >= 2 * 12


def test_feeder_batches_and_windows_equal_jax():
    """``WindowFeeder`` over 40 supersteps of 5 (200 steps) on a short
    corpus, against the JAX feeder; and the port's device-side window
    gather against the feeder's windows."""
    data = np.frombuffer(b"the quick brown fox jumps over the lazy dog. " * 9,
                         np.uint8)
    dcfg = dict(batch=6, seq=10, stride=None)
    start = np.random.default_rng(0).integers(0, len(data) - 11, 6).astype(np.int32)
    jf = jstreaming.WindowFeeder(data, JData(**dcfg), 5, positions=start)
    tf = tstreaming.WindowFeeder(data, TData(**dcfg), 5, positions=start,
                                 device="cpu")
    corpus = torch.from_numpy(data.copy())
    pos = torch.from_numpy(start)
    for _ in range(40):
        want = jf.next_batch()
        got = tf.next_device_batch()
        assert got.dtype == torch.uint8 and got.shape == (5, 11, 6)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tf.positions, jf.positions)
        for k in range(5):
            x, t = tcorpus.make_windows(corpus, pos, 10)
            np.testing.assert_array_equal(x.numpy(), want[k, :-1])
            np.testing.assert_array_equal(t.numpy(), want[k, 1:])
            pos, _ = tcorpus.advance_positions(pos, 10, len(data), 10)
    streams = tcorpus.CorpusStreams(data, TData(**dcfg), device="cpu")
    x, t = streams.windows(torch.from_numpy(start))
    np.testing.assert_array_equal(x.numpy(), tf.build(start)[:-1])
    nxt, _ = streams.advance(torch.from_numpy(start))
    np.testing.assert_array_equal(nxt.numpy(), jstreaming.advance_host(
        start, 10, len(data), 10)[0])
    h_pos, h_wrap = tstreaming.advance_host(start, 10, len(data), 10)
    j_pos, j_wrap = jstreaming.advance_host(start, 10, len(data), 10)
    np.testing.assert_array_equal(h_pos, j_pos)
    np.testing.assert_array_equal(h_wrap, j_wrap)


def test_init_positions_range_and_short_corpus():
    gen = torch.Generator().manual_seed(0)
    pos = tcorpus.init_positions(gen, 1000, 50, 10)
    assert pos.dtype == torch.int32 and int(pos.min()) >= 0 and int(pos.max()) < 39
    with pytest.raises(ValueError, match="too short"):
        tcorpus.init_positions(gen, 4, 11, 10)
    with pytest.raises(ValueError, match="too short"):
        tstreaming.WindowFeeder(np.zeros(5, np.uint8), TData(seq=10), 2,
                                device="cpu")


def _grads_pair(shapes, rng, scale):
    arrs = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
    return arrs


@pytest.mark.parametrize("clip", [None, 0.05])
def test_adagrad_matches_jax_through_warmup_and_after(clip):
    """``apply_updates`` over 8 steps, lr = 0 for the first 3 (the
    accumulators still fill), with and without clipping, and the cyclic
    schedule's values."""
    n, m = 16, 8
    jcfg = JConfig(hidden=n, vocab=m)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    flat = jckpt._flatten(jp, "params")
    tp = tckpt.params_from_numpy(flat, TConfig(hidden=n, vocab=m), "cpu")
    jm_, tm_ = jopt.adagrad_init(jp), topt.adagrad_init(tp)
    kw = dict(lr=0.1, warmup_steps=3, clip_norm=clip)
    jt, tt = JTrain(**kw), TTrain(**kw)
    rng = np.random.default_rng(0)
    keys = [k for k, _ in tp.named_tensors()]
    for step in range(8):
        garr = _grads_pair([flat[k].shape for k in keys], rng, 0.1)
        jg = jckpt._unflatten_like(jp, "params", dict(zip(keys, garr)))
        tg = topt.like(tp, map(torch.from_numpy, garr))
        jp, jm_, jn = jopt.apply_updates(jp, jg, jm_, jnp.asarray(step), jt)
        tp, tm_, tn = topt.apply_updates(tp, tg, tm_, step, tt)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for (k, t), (_, tmv) in zip(tp.named_tensors(), tm_.named_tensors()):
            np.testing.assert_allclose(t.numpy(), np.asarray(
                jckpt._flatten(jp, "params")[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tmv.numpy(), np.asarray(
                jckpt._flatten(jm_, "params")[k]), rtol=1e-6)
        if step < 3:   # warm-up: parameters frozen, accumulators filling
            np.testing.assert_array_equal(tp.Why.numpy(), flat["params.Why"])
            assert float(tm_.Why.abs().sum()) > 0
    cyc = dict(lr=0.1, warmup_steps=4, lr_cycle_steps=10, lr_cycle_min_frac=0.2)
    for step in range(0, 40, 3):
        assert topt.schedule_lr(TTrain(**cyc), step) == np.float32(
            jopt.schedule_lr(JTrain(**cyc), jnp.asarray(step)))


def test_checkpoints_load_across_packages(tmp_path):
    """A port save loads in the JAX package's ``load_checkpoint`` and a JAX
    save in the port's, full state, bit for bit."""
    n, m, b = 32, 16, 4
    jcfg, tcfg = JConfig(hidden=n, vocab=m), TConfig(hidden=n, vocab=m)
    rng = np.random.default_rng(0)
    jp = jmodel.init_params(JConfig(hidden=n, vocab=m, init_std=0.3),
                            jax.random.PRNGKey(1))
    jm_ = jax.tree_util.tree_map(lambda x: x * x, jp)
    pos = rng.integers(0, 100, b).astype(np.int32)
    h = rng.normal(size=(1, b, n)).astype(np.float32)
    c = rng.normal(size=(1, b, n)).astype(np.float32)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jp, jm_, 7, positions=pos, stream_h=h,
                          stream_c=c, rng_key=jax.random.PRNGKey(3),
                          meta={"hidden": n})
    tp, tm_, step, extras = tckpt.load_checkpoint(jpath, tcfg, "cpu")
    assert step == 7 and extras["meta"]["hidden"] == n
    for (k, t), (_, tmv) in zip(tp.named_tensors(), tm_.named_tensors()):
        np.testing.assert_array_equal(t.numpy(), jckpt._flatten(jp, "params")[k])
        np.testing.assert_array_equal(tmv.numpy(), jckpt._flatten(jm_, "params")[k])
    np.testing.assert_array_equal(extras["positions"].numpy(), pos)
    np.testing.assert_array_equal(extras["stream_h"].numpy(), h)
    tpath = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(tpath, tp, tm_, 9, positions=extras["positions"],
                          stream_h=extras["stream_h"], stream_c=extras["stream_c"],
                          rng_key=np.array([0, 5], np.uint32), meta={"x": 1})
    assert not os.path.exists(tpath + ".tmp")
    params, opt, step, ext = jckpt.load_checkpoint(
        tpath, jmodel.init_params(jcfg), jopt.adagrad_init(jmodel.init_params(jcfg)))
    assert step == 9 and ext["meta"]["x"] == 1
    for k, v in jckpt._flatten(params, "params").items():
        np.testing.assert_array_equal(v, jckpt._flatten(jp, "params")[k])
    for k, v in jckpt._flatten(opt, "params").items():
        np.testing.assert_array_equal(v, jckpt._flatten(jm_, "params")[k])
    np.testing.assert_array_equal(np.asarray(ext["stream_c"]), c)
    np.testing.assert_array_equal(np.asarray(ext["rng_key"]), [0, 5])
    with np.load(tpath) as z:
        assert sorted(z.files) == sorted(np.load(jpath).files)


def _trajectory_cfgs():
    kw = dict(hidden=128, loss_mode="all", compute_dtype="float32")
    dkw = dict(batch=8, seq=16, train_percent=0.9)
    tkw = dict(lr=0.05, warmup_steps=3, superstep=1, steps=20,
               eval_every_s=1e9)
    return kw, dkw, tkw


def test_trainer_trajectory_matches_jax(tmp_path):
    """20 streamed steps of the port's ``Trainer`` (the kernels' plain
    versions) and of the JAX ``Trainer`` (its Pallas kernels in interpret
    mode) from the JAX trainer's saved initial state, which the port
    restores. Per-step bits and the final parameters must agree within 10x
    the JAX package's own Pallas-against-XLA gap on the same steps."""
    kw, dkw, tkw = _trajectory_cfgs()
    data = jcorpus.rawread(ALICE)[:40000]
    train, test = jcorpus.split(data, dkw["train_percent"])
    jcfg, jd, jt = JConfig(**kw), JData(**dkw), JTrain(**tkw)
    runs = {}
    init = str(tmp_path / "init.npz")
    for name, cell in (("pallas", jselect("pallas", jcfg, 8, interpret=True)),
                       ("xla", None)):
        tr = JTrainer(jcfg, jd, jt, train, test, cell_fn=cell, streaming=True)
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
    assert tt.step == 20


def test_trainer_run_eval_checkpoint_and_resume(tmp_path):
    """``run`` with the eval cadence on: a results row, the rolling and
    best checkpoints and a sample; a restore resumes at the saved step, and
    the resident corpus gives the streamed run's metrics."""
    kw, dkw, tkw = _trajectory_cfgs()
    tkw = dict(tkw, superstep=5, eval_every_s=0.0, eval_chars=2000,
               sample_chars=40, checkpoint_dir=str(tmp_path), log_every=5)
    data = jcorpus.rawread(ALICE)[:20000]
    train, test = jcorpus.split(data, 0.9)
    cfg = TConfig(hidden=32, loss_mode="all")
    runs = {}
    for streaming in (True, False):
        tr = TTrainer(cfg, TData(**dkw), TTrain(**tkw), train, test,
                      results_path=str(tmp_path / "results.jsonl"),
                      streaming=streaming, device="cpu")
        runs[streaming] = tr.run(10, quiet=True)
    assert runs[True]["train_bpc"] == pytest.approx(runs[False]["train_bpc"],
                                                    rel=1e-6)
    assert np.isnan(runs[True]["mfu"])          # no H100 peak for a CPU run
    assert len(tr.table.rows) == 2 and tr.table.last().test_bpc < 8.5
    for name in ("ckpt.npz", "ckpt_best.npz", "sample_step10.txt"):
        assert os.path.exists(tmp_path / name), name
    rows = [json.loads(l) for l in open(tmp_path / "results.jsonl")]
    assert len(rows) == 4 and rows[-1]["step"] == 10
    fresh = TTrainer(cfg, TData(**dkw), TTrain(**tkw), train, test,
                     streaming=True, device="cpu")
    fresh.restore(str(tmp_path / "ckpt.npz"))
    assert fresh.step == 10
    np.testing.assert_array_equal(fresh.feeder.positions,
                                  tr.state.positions.numpy())
    assert len(fresh.sample(20, temperature=0.0)) == 20


def test_trainer_refuses_what_is_not_ported(capsys):
    """Meshes are refused when the trainer is built; dropout and several
    layers through the kernels' plain versions, ``scan_chunk`` and the live
    checks (``crosscheck``, ``gradcheck``) now run."""
    data = jcorpus.rawread(ALICE)[:5000]
    d, t = TData(batch=4, seq=8), TTrain(superstep=2)
    cfg = TConfig(hidden=32)
    with pytest.raises(NotImplementedError, match="mesh"):
        TTrainer(mcfg=cfg, dcfg=d, tcfg=t, train_data=data, mesh=object(),
                 device="cpu")
    deep = TConfig(hidden=32, num_layers=2, dropout=0.1, loss_mode="all")
    tr = TTrainer(deep, d, t, data, None, cell_fn=tselect("plain", deep, 4, "cpu"),
                  device="cpu")
    tr.state, met = tr.dispatch_superstep()
    assert tr.step == 2 and np.isfinite(float(met["bits_mean"]))
    chunked = TTrainer(TConfig(hidden=32, scan_chunk=4), d,
                       TTrain(superstep=2, crosscheck_every=1), data, None,
                       cell_fn=tselect("plain", cfg, 4, "cpu"), device="cpu")
    met = chunked.run(steps=2)   # one superstep, then its crosscheck
    assert chunked.step == 2 and np.isfinite(met["train_bpc"])
    cross = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[crosscheck]")]
    assert len(cross) == 1 and cross[0].endswith(" ok"), cross
    assert chunked.crosscheck_failures == 0
    # weights large enough that the float64 central differences of every
    # sampled entry stand above their roundoff
    tr = TTrainer(TConfig(hidden=32, init_std=0.3), d, t, data, None,
                  device="cpu")
    assert tr.crosscheck(quiet=True)["ok"]
    assert tr.gradcheck(samples_per_tensor=2, quiet=True)
    assert tr.crosscheck_failures == tr.gradcheck_failures == 0
    with pytest.raises(ValueError, match="no test split"):
        tr.evaluate()


def test_skip_nonfinite_keeps_state_and_params():
    """A non-finite loss zeroes the update and keeps the pre-step (h, c)."""
    data = jcorpus.rawread(ALICE)[:5000]
    cfg = TConfig(hidden=32, loss_mode="all")
    tr = TTrainer(cfg, TData(batch=4, seq=8), TTrain(superstep=1), data,
                  None, device="cpu")
    tr.state.params.Why[0, 0] = float("nan")
    tr.state.h = torch.randn(tr.state.h.shape, generator=torch.Generator().manual_seed(0))
    before = [t.clone() for _, t in tr.state.params.named_tensors()]
    h0 = tr.state.h.clone()
    _, wrapped = tcorpus.advance_positions(tr.state.positions, 8, len(data), 8)
    tr.state, met = tr.dispatch_superstep()
    assert not np.isfinite(float(met["bits_mean"]))
    for (_, t), b in zip(tr.state.params.named_tensors(), before):
        np.testing.assert_array_equal(t.numpy(), b.numpy())
    want = torch.where(wrapped[None, :, None], torch.zeros_like(h0), h0)
    torch.testing.assert_close(tr.state.h, want, rtol=0, atol=0)


def test_metrics_match_jax_flop_model():
    for kw in (dict(hidden=512), dict(hidden=1024, num_layers=3),
               dict(hidden=256, embedding_mode="onehot", loss_mode="last")):
        assert tmetrics.lstm_flops_per_char(TConfig(**kw)) == \
            jmetrics.lstm_flops_per_char(JConfig(**kw))
        assert tmetrics.param_count(TConfig(**kw)) == \
            jmetrics.param_count(JConfig(**kw))
    assert tmetrics.peak_flops(TConfig(compute_dtype="bfloat16")) == 989e12
    assert tmetrics.peak_flops(TConfig()) == 67e12


def test_cli_train_on_the_cpu(tmp_path, capsys):
    tcli.main(["train", "--data", ALICE, "--hidden", "32", "--batch", "8",
               "--seq", "16", "--steps", "20", "--superstep", "10",
               "--log-every", "10", "--eval-chars", "2000",
               "--sample-chars", "30", "--ckpt-dir", str(tmp_path),
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final test bpc" in out and "--- sample ---" in out
    assert os.path.exists(tmp_path / "ckpt.npz")
    tcli.main(["train", "--data", ALICE, "--hidden", "32", "--batch", "8",
               "--seq", "16", "--steps", "10", "--superstep", "10",
               "--sample-chars", "0", "--resume", str(tmp_path / "ckpt.npz"),
               "--resident-data", "--device", "cpu"])
    assert "resumed" in capsys.readouterr().out
    tcli.main(["train", "--data", ALICE, "--hidden", "32", "--batch", "8",
               "--seq", "16", "--steps", "10", "--superstep", "5",
               "--sample-chars", "0", "--train-percent", "1.0",
               "--profile", str(tmp_path / "prof"), "--device", "cpu"])
    assert "profile trace written" in capsys.readouterr().out
    for name in ("trace.json", "kernels.txt"):
        assert os.path.getsize(tmp_path / "prof" / name) > 0
    args = tcli.build_parser().parse_args(["train", "--data", "x"])
    mcfg, dcfg, tcfg = tcli._configs(args)
    assert (tcfg.lr, tcfg.warmup_steps, tcfg.seed) == (0.02, 1000, 1)
    assert mcfg.loss_mode == "all" and args.stream_data and args.device == "cuda"


def test_bench_on_the_cpu_prints_the_jax_keys(capsys):
    """The bench's JSON line has the JAX bench's keys; off the card it says
    so (platform "cpu", no MFU) and a band miss exits 1 after the line."""
    argv = ["--data", ALICE, "--hidden", "32", "--batch", "8", "--seq", "16",
            "--superstep", "5", "--bench-steps", "10", "--warmup-steps", "5",
            "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        tbench.main(argv)
    assert exc.value.code == 1
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "gflops",
                        "mfu", "train_bpc", "train_bpc_ok",
                        "windows_mchars_per_sec", "platform"}
    assert res["platform"] == "cpu" and res["mfu"] is None
    assert res["train_bpc_ok"] is False and len(res["windows_mchars_per_sec"]) == 5
    args = tcli.build_parser().parse_args(tbench.DEFAULT_ARGV)
    assert (args.hidden, args.batch, args.seq, args.dtype, args.lr,
            args.warmup, args.superstep, args.bench_steps,
            args.warmup_steps) == (512, 128, 100, "bfloat16", 0.02, 20, 50,
                                   3000, 300)
