"""Pipeline parallelism of the port (``parallel/pp.py``, the stage axis of
``parallel/mesh.py``, the PP ``Trainer`` and ``cli train --pp N``) against
the JAX package's ``parallel/pp.py`` on the 8-device virtual CPU mesh and
against the port's single device.

The port runs one process a stage: the cases of S = 2, 4 and 8 run once on
spawned gloo ranks (``tests/torch_dp_ranks.py``, beside the data-parallel
and sequence-pipelined cases), S = 1 runs here, one stage without a
collective. Tolerances are ``tests/test_pp.py``'s: loss and bits rtol
1e-5, gradients rtol 1e-4 / atol 1e-6 (``:58-70``), the float64 training
superstep rtol 1e-9 / atol 1e-12 (``:113-119``), the checkpoint round trip
exact and its next bits rtol 1e-6 (``:139-150``); the data x stage mesh
``tests/test_torch_dp_tp.py``'s (bits rtol 1e-5, parameters rtol 1e-4 /
atol 1e-6).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import DataConfig as JData
from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu import TrainConfig as JTrain
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.parallel import mesh as jmesh
from eigen_lstm_tpu.parallel import pp as jpp
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train.trainer import Trainer as JTrainer

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig, MeshConfig, TrainConfig
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.parallel import mesh as mesh_mod
from eigen_lstm_tpu_torch.parallel import pp as pp_mod
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import trainer as trainer_mod
from eigen_lstm_tpu_torch.train.trainer import Trainer

from torch_dp_ranks import (BITS_RTOL, CLI_ARGV, PARAM_ATOL, PARAM_RTOL,
                            PPG_KEY, assert_params, assert_state, case_state,
                            check_checkpoints, dp_ranks, gradcheck_lines,
                            jax_superstep, port_single, pp_inputs, steps_of)

__all__ = ["dp_ranks"]

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
GRAD_CASES = ["ppg_2_2_4_all", "ppg_4_4_2_all", "ppg_8_8_4_all",
              "ppg_4_2_4_all", "ppg_8_4_2_all", "ppg_4_4_4_last",
              "ppg_4_2_2_last"]
NAMES = ("W_pad", "U", "b", "Why", "by")
CPU = torch.device("cpu")


def _port_inputs(key):
    cfg_kw, n_chunks, n_stage, arrs = pp_inputs(key)
    cfg = ModelConfig(**cfg_kw)
    params = tckpt.params_from_numpy(arrs, cfg, "cpu")
    x, t, h, c = (torch.from_numpy(arrs[k]) for k in ("x", "t", "h", "c"))
    return cfg, n_chunks, n_stage, arrs, params, (x, t, h, c)


def _jax_params(cfg_kw, arrs):
    like = jmodel.init_params(JConfig(**cfg_kw))
    return jckpt._unflatten_like(like, "params", {
        k: jnp.asarray(arrs[k]) for k in jckpt._flatten(like, "params")})


def _jax_pp(key):
    """The JAX ``make_pp_loss_and_grad`` on S virtual devices: (loss, bits,
    {name: gradient in the stage-stacked layout})."""
    cfg_kw, n_chunks, n_stage, arrs = pp_inputs(key)
    jcfg = JConfig(**cfg_kw)
    mesh = jmesh.make_mesh(n_stage, axis="stage")
    pp = jpp.shard_pp(jpp.pp_params_from(_jax_params(cfg_kw, arrs), jcfg), mesh)
    fn = jpp.make_pp_loss_and_grad(jcfg, mesh, n_chunks)
    loss, bits, grads = fn(pp, *(jnp.asarray(arrs[k], jnp.int32)
                                 for k in ("x", "t")),
                           jnp.asarray(arrs["h"]), jnp.asarray(arrs["c"]))
    return float(loss), float(bits), {n: np.asarray(getattr(grads, n))
                                      for n in NAMES}


def test_pp_params_roundtrip():
    """``pp_params_to(pp_params_from(p))`` is ``p`` bit for bit
    (``tests/test_pp.py:31``), and the stage-stacked layout, its zero pad
    rows included, is the JAX package's on the same numpy arrays."""
    cfg_kw, _, _, arrs = pp_inputs("ppg_4_2_4_all")
    cfg = ModelConfig(**cfg_kw)
    params = tckpt.params_from_numpy(arrs, cfg, "cpu")
    pp = pp_mod.pp_params_from(params, cfg)
    back = pp_mod.pp_params_to(pp, cfg)
    for (name, a), b in zip(params.named_tensors(), model.tensors(back)):
        assert torch.equal(a, b), name
    jp = jpp.pp_params_from(_jax_params(cfg_kw, arrs), JConfig(**cfg_kw))
    for name, t in pp.named_tensors():
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert (pp.W_pad[1:, cfg.hidden:] == 0).all()


def _port_pp(key, dp_ranks):
    """The port's pipelined loss, bits, final state and gradients (the
    stage-stacked layout, gathered): from the spawned ranks."""
    got, _ = dp_ranks(key)
    return (float(got[f"{key}/loss"]), float(got[f"{key}/bits"]),
            got[f"{key}/hT"], got[f"{key}/cT"],
            {n: got[f"{key}/grad/{n}"] for n in NAMES})


@pytest.mark.parametrize("key", GRAD_CASES)
def test_pp_matches_jax_and_single_device(dp_ranks, key):
    """(layers, stages, chunks, loss mode) over tests/test_pp.py:38-49's
    seven cases: the port's pipelined loss, bits and every gradient
    against the JAX ``make_pp_loss_and_grad`` on S virtual devices and the
    port's single-device ``loss_and_grads`` (the model's own loop); the
    final state against the single device's."""
    cfg, _, _, _, params, (x, t, h, c) = _port_inputs(key)
    loss, bits, hT, cT, grads = _port_pp(key, dp_ranks)
    l1, (h1, c1), b1, g1 = trainer_mod.loss_and_grads(params, x, t, h, c, cfg)
    single = pp_mod.pp_params_from(g1, cfg)
    jloss, jbits, jgrads = _jax_pp(key)
    for want, what in (((jloss, jbits, jgrads), "JAX"),
                       ((float(l1), float(b1), {n: v.numpy() for n, v in
                                                single.named_tensors()}),
                        "one device")):
        np.testing.assert_allclose(loss, want[0], rtol=LOSS_RTOL, err_msg=what)
        np.testing.assert_allclose(bits, want[1], rtol=LOSS_RTOL, err_msg=what)
        for name in NAMES:
            np.testing.assert_allclose(grads[name], want[2][name],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{what} {name}")
    np.testing.assert_allclose(hT, h1.numpy(), rtol=LOSS_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(cT, c1.numpy(), rtol=LOSS_RTOL, atol=GRAD_ATOL)


def test_pp_at_one_stage_is_the_single_device():
    """S = 1 without a collective, in 1, 2 and 4 chunks, fp32 and bf16
    compute, against the single device through the model's own loop
    (``cell_fn=None``, the same torch-op scan): the loss rtol 1e-5 and the
    final state to 1e-6; every gradient rtol 1e-4 / atol 1e-6, except in
    bf16 those of the products cut into chunks (W and Why), whose cast
    rounds each chunk's weight gradient to bf16 where one device rounds
    the window's once: their largest distance within (C + 1) half-ulps of
    bf16 (2^-9 each) of their largest entry, and exact at C = 1."""
    for dtype in ("float32", "bfloat16"):
        cfg_kw, _, _, arrs = pp_inputs("ppg_4_2_4_all")
        cfg = ModelConfig(**dict(cfg_kw, compute_dtype=dtype))
        params = tckpt.params_from_numpy(arrs, cfg, "cpu")
        x, t, h, c = (torch.from_numpy(arrs[k]) for k in ("x", "t", "h", "c"))
        l1, (h1, c1), _, g1 = trainer_mod.loss_and_grads(params, x, t, h, c, cfg)
        want = pp_mod.pp_params_from(g1, cfg)
        for chunks in (1, 2, 4):
            loss, (hT, cT), _, grads = pp_mod.pp_loss_and_grads(
                pp_mod.pp_params_from(params, cfg), x, t, h, c, cfg, chunks,
                None)
            np.testing.assert_allclose(float(loss), float(l1), rtol=LOSS_RTOL)
            for a, b in ((hT, h1), (cT, c1)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
            for (name, g), w in zip(grads.named_tensors(), model.tensors(want)):
                what = f"{dtype} C={chunks} {name}"
                if dtype == "bfloat16" and name in ("W_pad", "Why"):
                    gap = float((g - w).abs().max() / w.abs().max())
                    assert gap <= (chunks + 1) * 2.0**-9, (what, gap)
                    assert chunks > 1 or gap == 0.0, (what, gap)
                else:
                    np.testing.assert_allclose(g.numpy(), w.numpy(),
                                               rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                               err_msg=what)


def test_pp_rejects_layer_stage_mismatch():
    """Two layers over four stages: the port's Trainer and
    ``check_stages`` raise the JAX ``make_pp_loss_and_grad``'s message
    (``tests/test_pp.py:75``)."""
    msg = "^pipeline needs layers divisible by stages: 2 layers vs 4 devices$"
    cfg = ModelConfig(hidden=16, num_layers=2)
    with pytest.raises(ValueError, match=msg):
        Trainer(cfg, DataConfig(batch=4, seq=8), TrainConfig(), _data(),
                mesh=_stage_mesh(4), device="cpu")
    with pytest.raises(ValueError, match=msg):
        pp_mod.check_stages(2, 4)
    with pytest.raises(ValueError, match=msg):
        jpp.make_pp_loss_and_grad(JConfig(hidden=16, num_layers=2),
                                  jmesh.make_mesh(4, axis="stage"), 2)


def _data():
    return np.tile(np.arange(31, dtype=np.uint8), 100)


def _stage_mesh(n, n_data=None):
    """A ProcessMesh of rank 0 on a stage axis of ``n`` (and a data axis of
    ``n_data``) for the checks that raise before any collective."""
    data = None if n_data is None else mesh_mod.AxisGroup(0, n_data, CPU)
    return mesh_mod.ProcessMesh(data, None, CPU,
                                stage=mesh_mod.AxisGroup(0, n, CPU))


def test_pp_rejections_carry_the_jax_messages():
    """Tied embeddings under ``pp`` and ``dp_pp`` (the JAX Trainer's
    ``ValueError``, ``trainer.py:263-273``), the sequence not divisible by
    ``pp_chunks`` and the batch not divisible by the data shards (the JAX
    superstep functions'): the port's Trainer raises each message, and so
    does the JAX package on the same configuration."""
    data, jdata = _data(), jnp.asarray(_data())
    cases = [
        ("pp", dict(tie_embeddings=True), {}, {}, 2, None,
         "tie_embeddings is not supported under pipeline parallelism "
         "(parallel='pp'): the head and the embedding live on different "
         "stages"),
        ("dp_pp", dict(tie_embeddings=True), {}, {}, 2, 2,
         "tie_embeddings is not supported under pipeline parallelism "
         "(parallel='dp_pp'): the head and the embedding live on different "
         "stages"),
        ("pp", {}, dict(seq=10), {}, 2, None,
         "seq 10 not divisible by pp_chunks 4"),
        ("dp_pp", {}, dict(batch=6), {}, 2, 4,
         "global batch 6 not divisible by 4"),
        ("dp_pp", {}, {}, dict(pp_chunks=3), 2, 2,
         "seq 8 not divisible by pp_chunks 3"),
    ]
    for mode, mkw, dkw, tkw, n_stage, n_data, msg in cases:
        mkw = dict(dict(vocab=32, hidden=16, num_layers=2), **mkw)
        dkw = dict(dict(batch=8, seq=8, train_percent=1.0), **dkw)
        with pytest.raises(ValueError, match=f"^{re.escape(msg)}$"):
            Trainer(ModelConfig(**mkw), DataConfig(**dkw), TrainConfig(**tkw),
                    data, mesh=_stage_mesh(n_stage, n_data), device="cpu")
        jcfg, jd, jt = JConfig(**mkw), JData(**dkw), JTrain(**tkw)
        if mkw.get("tie_embeddings"):
            mesh = (jmesh.make_mesh(n_stage, axis="stage") if mode == "pp"
                    else jpp.make_mesh_dp_pp(n_data, n_stage))
            build = lambda: JTrainer(jcfg, jd, jt, _data(), None, mesh=mesh,
                                     parallel=mode)
        elif mode == "pp":
            build = lambda: jpp.make_pp_superstep(
                jcfg, jd, jt, jdata, jmesh.make_mesh(n_stage, axis="stage"))
        else:
            build = lambda: jpp.make_dp_pp_superstep(
                jcfg, jd, jt, jdata, jpp.make_mesh_dp_pp(n_data, n_stage))
        with pytest.raises(ValueError, match=f"^{re.escape(msg)}$"):
            build()


def _jax_supersteps(work, key, mesh, parallel, n):
    """``n`` supersteps of the JAX ``Trainer`` from the case's checkpoint:
    (each superstep's bits_mean, the canonical params as numpy)."""
    base, data, _ = case_state(key)
    tr = JTrainer(JConfig(**base["cfg"]), JData(**base["dcfg"]),
                  JTrain(**base["tcfg"]), data, None, mesh=mesh,
                  parallel=parallel)
    tr.restore(str(work / f"{key}.npz"))
    bits = []
    for _ in range(n):
        tr.state, met = tr.superstep(tr.state)
        bits.append(float(met["bits_mean"]))
    return bits, [np.asarray(p) for p in
                  jax.tree_util.tree_leaves(tr.canonical_params())]


@pytest.mark.parametrize("key", ["pptrain_2_2_all", "pptrain_4_2_last",
                                 "pptrain_4_4_all"])
def test_pp_training_superstep_matches_jax_and_single_device(dp_ranks, key,
                                                             x64):
    """tests/test_pp.py:82-120's cases (layers, stages, loss mode) = (2, 2,
    all), (4, 2, last), (4, 4, all) in float64: two supersteps of 3 steps
    in 4 chunks on S gloo ranks from one checkpoint against the port's
    single-device Trainer (the model's own loop) and the JAX
    ``make_pp_superstep`` on S virtual devices: the bits of each
    superstep rtol 1e-5; every canonical parameter against one device
    rtol 1e-9 / atol 1e-12 (tests/test_pp.py:113-119's rule) and against
    the JAX package rtol 1e-6 / atol 1e-8: both packages' Adagrad steps in
    fp32 arithmetic in float64 configs too
    (``eigen_lstm_tpu/train/optimizer.py:104-117``), so float64 gradients
    that differ in their last bits can round an fp32 ulp apart (the two
    single devices differ so, 7.5e-9 at most here); against one device
    also the accumulators, the gathered stream state and the cursors."""
    got, work = dp_ranks(key)
    base, data, _ = case_state(key)
    n_stage = int(key.split("_")[2])
    cfg, dcfg = ModelConfig(**base["cfg"]), DataConfig(**base["dcfg"])
    tr = Trainer(cfg, dcfg, TrainConfig(**base["tcfg"]), data, None,
                 device="cpu")
    tr.restore(str(work / f"{key}.npz"))
    jbits, jparams = _jax_supersteps(work, key,
                                     jmesh.make_mesh(n_stage, axis="stage"),
                                     "pp", 2)
    for k in range(2):
        tr.state, met = tr.dispatch_superstep()
        for want in (float(met["bits_mean"]), jbits[k]):
            np.testing.assert_allclose(got[f"{key}/{k}/bits_mean"], want,
                                       rtol=1e-5)
    names = [n for n, _ in tr.state.params.named_tensors()]
    for name, p, jp in zip(names, model.tensors(tr.state.params), jparams):
        np.testing.assert_allclose(got[f"{key}/{name}"], p.numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=f"one device {name}")
        np.testing.assert_allclose(got[f"{key}/{name}"], jp, rtol=1e-6,
                                   atol=1e-8, err_msg=f"JAX {name}")
    for name, m in tr.state.m.named_tensors():
        np.testing.assert_allclose(got[f"{key}/m/{name}"], m.numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    for k in ("h", "c"):
        np.testing.assert_allclose(got[f"{key}/{k}"],
                                   getattr(tr.state, k).numpy(), rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_array_equal(got[f"{key}/positions"],
                                  tr.state.positions.numpy())


def test_pp_checkpoint_roundtrip(dp_ranks):
    """tests/test_pp.py:123-150 on two gloo stages: a PP Trainer's
    checkpoint restored into a fresh PP Trainer gives its canonical
    parameters, accumulators, stream state and cursors exactly, the step
    too, and the next superstep's bits (rtol 1e-6)."""
    key = "ppckpt_2"
    got, _ = dp_ranks(key)
    assert list(got[f"{key}/steps"]) == [2, 2]
    names = [k[len(f"{key}/a/"):] for k in got if k.startswith(f"{key}/a/")
             and not k.endswith("bits_mean")]
    assert len(names) == 2 * 8 + 3
    for name in names:
        np.testing.assert_array_equal(got[f"{key}/b/{name}"],
                                      got[f"{key}/a/{name}"], err_msg=name)
    np.testing.assert_allclose(got[f"{key}/b/bits_mean"],
                               got[f"{key}/a/bits_mean"], rtol=1e-6)


def test_dp_pp_matches_jax_and_single_device(dp_ranks):
    """One superstep (3 steps, clip 0.1, the sequence in 2 chunks) of a
    two-layer model on a 2 x 2 data x stage mesh of gloo ranks against
    the JAX ``make_dp_pp_superstep`` on 2 x 2 virtual devices and the
    port's single-device Trainer: bits, every canonical parameter, the
    accumulators, the gathered stream state, the cursors."""
    key = "dppp_22"
    got, work = dp_ranks(key)
    jmet, jparams, jpos = jax_superstep(work, key, jpp.make_mesh_dp_pp(2, 2),
                                        "dp_pp")
    smet, st = port_single(work, key)
    np.testing.assert_allclose(got[f"{key}/0/bits_mean"], jmet["bits_mean"],
                               rtol=BITS_RTOL)
    assert_params(got, key, jparams, "against JAX")
    np.testing.assert_array_equal(got[f"{key}/positions"], jpos)
    for k in ("bits_mean", "gnorm_mean", "gnorm_max"):
        np.testing.assert_allclose(got[f"{key}/0/{k}"], smet[k],
                                   rtol=BITS_RTOL, err_msg=k)
    assert_state(got, key, st, "against one device")
    assert smet["gnorm_max"] > case_state(key)[0]["tcfg"]["clip_norm"]


def _replay(params, x, t, h, c, cfg, n_chunks, seed_of):
    """The pipelined objective rebuilt from the model's pieces in one
    autograd graph, a chunk at a time through every layer, (layer l, chunk
    k)'s output masked by ``_dropout`` under ``seed_of(l, k)``: (loss,
    grads in checkpoint order)."""
    leaves = [p.detach().requires_grad_() for p in model.tensors(params)]
    p = model.like(params, leaves)
    s, b = x.shape
    cl = s // n_chunks
    state = [(h[l], c[l]) for l in range(cfg.num_layers)]
    total = 0.0
    for k in range(n_chunks):
        ids = x[k * cl:(k + 1) * cl]
        inp = None
        for l, layer in enumerate(p.layers):
            xw = (layer.W[ids.long()] if l == 0 else
                  (inp.reshape(cl * b, -1) @ layer.W).reshape(cl, b, -1))
            h_seq, state[l] = model._scan_layer(layer, xw + layer.b, *state[l],
                                                cfg)
            inp = model._dropout(h_seq, cfg.dropout, seed_of(l, k))
        total = total + model.softmax_xent_bits(
            model.logits_from_h(p, inp, cfg), t[k * cl:(k + 1) * cl]).sum()
    loss = total / (s * b) * model.LN2
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def test_pp_dropout_folds_layer_and_chunk(dp_ranks):
    """Two layers with dropout 0.3 on two stages in 2 chunks: the ranks'
    loss and gradients equal a one-process replay of the model's pieces,
    (layer l, chunk k) masked under the step key with ``l * C + k`` folded
    in (``stage_key``); the four seeds differ from each other and from the
    key, and one seed for every (layer, chunk) misses the replay."""
    key = "ppg_2_2_2_all_drop"
    cfg, n_chunks, _, _, params, (x, t, h, c) = _port_inputs(key)
    loss, _, _, _, grads = _port_pp(key, dp_ranks)
    seeds = [pp_mod.stage_key(PPG_KEY, i) for i in range(4)]
    assert len(set(seeds + [PPG_KEY])) == 5
    want, wgrads = _replay(params, x, t, h, c, cfg, n_chunks,
                           lambda l, k: pp_mod.stage_key(PPG_KEY, l * 2 + k))
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)
    wpp = pp_mod.pp_params_from(model.like(params, wgrads), cfg)
    for name, g in wpp.named_tensors():
        np.testing.assert_allclose(grads[name], g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    unfolded, _ = _replay(params, x, t, h, c, cfg, n_chunks,
                          lambda l, k: PPG_KEY)
    assert abs(unfolded - loss) > 10 * LOSS_RTOL * abs(loss)


def test_cli_pp2_trains_with_gradcheck_and_its_checkpoint_loads(
        dp_ranks, capsys, tmp_path):
    """``cli train --layers 2 --pp 2 --pp-chunks 2 --gradcheck-every 1`` on
    two gloo ranks: the pipeline-parallel line, the resident corpus, the
    float64 shadow check at every superstep with 0 failures, the single
    device's bits (rel 1e-5) and a checkpoint that loads on one device in
    the port and in the JAX package, equal to the single device's within
    1e-4."""
    key = "cli_pp2"
    got, work = dp_ranks(key)
    out = str(got[f"{key}/stdout"])
    assert "pipeline-parallel over 2 stages" in out
    assert "data: resident on the device" in out
    gradcheck_lines(out, 2 * 8)
    tcli.main(CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")]
              + ["--layers", "2", "--ckpt-dir", str(tmp_path)])
    np.testing.assert_allclose(steps_of(out), steps_of(capsys.readouterr().out),
                               rtol=BITS_RTOL)
    check_checkpoints(work / key / "ckpt.npz", tmp_path / "ckpt.npz", layers=2)


@pytest.mark.parametrize("flags,line", [
    (["--pp", "1"], "pipeline-parallel over 1 stages"),
    (["--dp", "1", "--pp", "1"], "2-D mesh: 1 data x 1 stage devices"),
    (["--pp", "1", "--stream-data"], "pipeline-parallel over 1 stages")])
def test_cli_pp1_needs_no_launcher(capsys, flags, line):
    """``--pp 1`` and ``--dp 1 --pp 1`` run in one process (a gloo group of
    one), on the resident corpus, and ``--pp 1 --stream-data`` on windows
    streamed from the host, with ``--pp-chunks 2`` over two layers, and
    give the single device's bits (rel 1e-5)."""
    argv = CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")] + ["--layers", "2"]
    tcli.main(argv + flags + ["--pp-chunks", "2"])
    out = capsys.readouterr().out
    data = ("streamed from the host" if "--stream-data" in flags
            else "resident on the device")
    assert line in out and f"data: {data}" in out
    tcli.main(argv + ["--resident-data"])
    np.testing.assert_allclose(steps_of(out), steps_of(capsys.readouterr().out),
                               rtol=BITS_RTOL)


def test_init_mesh_stage_layouts():
    """The stage axis alone and beside the data axis (rank = d * P + p, the
    JAX ``make_mesh_dp_pp``'s row-major order, its axes ("data", "stage"))
    as ``ProcessMesh.rank`` reads them back; ``init_mesh`` refuses a stage
    axis beside a seq or a model axis."""
    for n_rows, n_cols in ((2, 2), (1, 2), (2, 1), (2, 3)):
        for r in range(n_rows * n_cols):
            row, col = divmod(r, n_cols)
            mesh = mesh_mod.ProcessMesh(mesh_mod.AxisGroup(row, n_rows, CPU),
                                        None, CPU,
                                        stage=mesh_mod.AxisGroup(col, n_cols, CPU))
            assert mesh.rank == r
    jm = jpp.make_mesh_dp_pp(2, 2)
    assert jm.axis_names == ("data", "stage")
    assert [d.id for d in jm.devices.flat] == [d.id for d in jax.devices()[:4]]
    for cfg in (MeshConfig(num_devices=None, seq_devices=2, stage_devices=2),
                MeshConfig(num_devices=None, model_devices=2, stage_devices=2)):
        with pytest.raises(ValueError, match="init_mesh takes"):
            mesh_mod.init_mesh(cfg, "cpu")
