"""Sequence pipelining of the port (``parallel/sp.py``, the seq axis of
``parallel/mesh.py``, the SP ``Trainer`` and ``cli train --sp N``) against
the JAX package's ``parallel/sp.py`` on the 8-device virtual CPU mesh and
against the port's single device.

The port runs one process a rank: the cases of D = 2 and 4 run once on
spawned gloo ranks (``tests/torch_dp_ranks.py``, which holds them beside
the data-parallel cases), through the plain versions; D = 1 runs here,
one segment without a collective. Tolerances: the gradient cases are
``tests/test_sp.py:57-72``'s (loss, bits and state rtol 1e-5 / atol 1e-6,
gradients rtol 2e-4 / atol 1e-6); the trajectory
``tests/test_sp.py:77-111``'s; the 2-D meshes ``tests/test_sp.py:125-166``'s
(data x seq) and ``tests/test_compositions.py``'s (seq x model).
"""

import contextlib
import io

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
from eigen_lstm_tpu.parallel import sp as jsp
from eigen_lstm_tpu.train import checkpoint as jckpt

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig, TrainConfig
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
from eigen_lstm_tpu_torch.parallel import mesh as mesh_mod
from eigen_lstm_tpu_torch.parallel import sp as sp_mod
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import trainer as trainer_mod
from eigen_lstm_tpu_torch.train.trainer import Trainer

from torch_dp_ranks import (ALICE, BITS_RTOL, CLI_ARGV, NAN_STREAM, PARAM_ATOL,
                            PARAM_RTOL, SPG_KEY, SP_TRAJ_START, assert_params,
                            assert_state, case_state, check_checkpoints,
                            dp_ranks, gradcheck_lines, jax_superstep,
                            port_single, sp_inputs, steps_of)

__all__ = ["dp_ranks"]

STATE_RTOL, STATE_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
GRAD_CASES = ["spg_1_2_2_all", "spg_2_2_2_all", "spg_1_4_2_all",
              "spg_2_2_2_last", "spg_1_1_4_all"]


def _port_inputs(key):
    cfg_kw, n_chunks, n_seq, arrs = sp_inputs(key)
    cfg = ModelConfig(**cfg_kw)
    params = tckpt.params_from_numpy(arrs, cfg, "cpu")
    x, t, h, c = (torch.from_numpy(arrs[k]) for k in ("x", "t", "h", "c"))
    return cfg, n_chunks, n_seq, arrs, params, (x, t, h, c)


def _jax_sp(key):
    """The JAX ``make_sp_loss_and_grad`` on D virtual devices: (loss, bits,
    hT, cT, {checkpoint key: gradient})."""
    cfg_kw, n_chunks, n_seq, arrs = sp_inputs(key)
    jcfg = JConfig(**cfg_kw)
    like = jmodel.init_params(jcfg)
    params = jckpt._unflatten_like(like, "params", {
        k: jnp.asarray(arrs[k]) for k in jckpt._flatten(like, "params")})
    fn = jsp.make_sp_loss_and_grad(jcfg, jmesh.make_mesh(n_seq, axis="seq"),
                                   n_chunks)
    loss, bits, hT, cT, grads = fn(params, *(jnp.asarray(arrs[k], jnp.int32)
                                             for k in ("x", "t")),
                                   jnp.asarray(arrs["h"]), jnp.asarray(arrs["c"]))
    return (float(loss), float(bits), np.asarray(hT), np.asarray(cT),
            {k: np.asarray(v) for k, v in jckpt._flatten(grads, "params").items()})


def _port_sp(key, dp_ranks):
    """The port's pipelined loss and gradients: from the spawned ranks for
    D > 1, here without a collective for D = 1."""
    cfg, n_chunks, n_seq, _, params, (x, t, h, c) = _port_inputs(key)
    if n_seq > 1:
        got, _ = dp_ranks(key)
        assert int(got[f"{key}/n_params"]) == len(model.tensors(params))
        return (float(got[f"{key}/loss"]), float(got[f"{key}/bits"]),
                got[f"{key}/hT"], got[f"{key}/cT"],
                {k[len(f"{key}/grad/"):]: v for k, v in got.items()
                 if k.startswith(f"{key}/grad/")})
    loss, (hT, cT), bits, grads = sp_mod.sp_loss_and_grads(
        params, x, t, h, c, cfg, n_chunks, None,
        select_cell_fn("plain", cfg, x.shape[1], "cpu"))
    return (float(loss), float(bits), hT.numpy(), cT.numpy(),
            {k: g.numpy() for k, g in grads.named_tensors()})


@pytest.mark.parametrize("key", GRAD_CASES)
def test_sp_matches_jax_and_single_device(dp_ranks, key):
    """(layers, D, C, loss mode) over (1, 2, 2, all), (2, 2, 2, all), (1, 4,
    2, all), (2, 2, 2, last), (1, 1, 4, all): the port's pipelined loss,
    bits, final state and every gradient against the JAX SP on D virtual
    devices and the port's single-device ``loss_and_grads``."""
    cfg, _, _, _, params, (x, t, h, c) = _port_inputs(key)
    got = _port_sp(key, dp_ranks)
    loss, (h2, c2), bits, grads = trainer_mod.loss_and_grads(
        params, x, t, h, c, cfg, select_cell_fn("plain", cfg, x.shape[1], "cpu"))
    single = (float(loss), float(bits), h2.numpy(), c2.numpy(),
              {k: g.numpy() for k, g in grads.named_tensors()})
    for want, what in ((_jax_sp(key), "JAX"), (single, "one device")):
        np.testing.assert_allclose(got[0], want[0], rtol=STATE_RTOL, err_msg=what)
        np.testing.assert_allclose(got[1], want[1], rtol=STATE_RTOL, err_msg=what)
        for i in (2, 3):
            np.testing.assert_allclose(got[i], want[i], rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=what)
        assert sorted(got[4]) == sorted(want[4])
        for name, g in want[4].items():
            np.testing.assert_allclose(got[4][name], g, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{what} {name}")


def _replay(params, x, t, h, c, cfg, n_chunks, n_seq, key, cell_fn):
    """The pipelined objective rebuilt from the port's ``model.forward``,
    one (segment, chunk) at a time in one autograd graph, (segment d,
    chunk j) under the dropout key ``key(d * C + j)``: (loss, grads)."""
    leaves = [p.detach().requires_grad_() for p in model.tensors(params)]
    p = model.like(params, leaves)
    s, b = x.shape
    seg, bs = s // n_seq, b // n_chunks
    carries = [(h[:, j * bs:(j + 1) * bs], c[:, j * bs:(j + 1) * bs])
               for j in range(n_chunks)]
    total = 0.0
    for d in range(n_seq):
        for j in range(n_chunks):
            ids = x[d * seg:(d + 1) * seg, j * bs:(j + 1) * bs].contiguous()
            h_top, (hT, cT) = model.forward(p, ids, *carries[j], cfg, cell_fn,
                                            key(d * n_chunks + j))
            total = total + model.softmax_xent_bits(
                model.logits_from_h(p, h_top, cfg),
                t[d * seg:(d + 1) * seg, j * bs:(j + 1) * bs]).sum()
            carries[j] = (hT.float(), cT.float())
    loss = total / (s * b) * model.LN2
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def test_sp_dropout_folds_segment_and_chunk(dp_ranks):
    """Two layers with dropout 0.3 at D = 2, C = 2: the ranks' loss and
    gradients equal a replay of the port's ``model.forward`` a (segment,
    chunk) at a time, each under the step key with ``d * C + j`` folded in
    (``segment_key``); the four keys differ, and one key for every
    (segment, chunk) misses the replay."""
    key = "spg_2_2_2_all_drop"
    cfg, n_chunks, n_seq, _, params, (x, t, h, c) = _port_inputs(key)
    got = _port_sp(key, dp_ranks)
    cell_fn = select_cell_fn("plain", cfg, x.shape[1], "cpu")
    keys = [sp_mod.segment_key(SPG_KEY, i) for i in range(4)]
    assert len(set(keys + [SPG_KEY])) == 5
    loss, grads = _replay(params, x, t, h, c, cfg, n_chunks, n_seq,
                          lambda i: sp_mod.segment_key(SPG_KEY, i), cell_fn)
    np.testing.assert_allclose(got[0], loss, rtol=STATE_RTOL)
    for (name, _), g in zip(params.named_tensors(), grads):
        np.testing.assert_allclose(got[4][name], g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    unfolded, _ = _replay(params, x, t, h, c, cfg, n_chunks, n_seq,
                          lambda i: SPG_KEY, cell_fn)
    assert abs(unfolded - got[0]) > 10 * STATE_RTOL * abs(got[0])


def test_sp_trajectory_with_resets_matches_single_device(dp_ranks):
    """Four supersteps of 3 steps at D = 2, C = 2 with reset_std 0.1 on a
    150-byte corpus: the streams wrap from the second superstep on, and
    the noise is the single device's stream, so the cursors are equal and
    every superstep's bits, the parameters and the stream state follow the
    port's single-device Trainer (rtol 1e-3 / atol 5e-5, bits rtol 1e-4);
    the first superstep, before any wrap, follows the JAX
    ``make_sp_superstep`` on two virtual devices."""
    key = "sptraj_2"
    got, work = dp_ranks(key)
    base, data, arrs = case_state(key)
    cfg, dcfg = ModelConfig(**base["cfg"]), DataConfig(**base["dcfg"])
    tr = Trainer(cfg, dcfg, TrainConfig(**base["tcfg"]), data, None,
                 cell_fn=select_cell_fn("plain", cfg, dcfg.batch, "cpu"),
                 device="cpu")
    tr.restore(str(work / f"{key}.npz"))
    for k in range(4):
        tr.state, met = tr.dispatch_superstep()
        np.testing.assert_allclose(got[f"{key}/{k}/bits_mean"],
                                   float(met["bits_mean"]), rtol=1e-4)
    np.testing.assert_array_equal(got[f"{key}/positions"],
                                  tr.state.positions.numpy())
    for name, p in tr.state.params.named_tensors():
        np.testing.assert_allclose(got[f"{key}/{name}"], p.numpy(), rtol=1e-3,
                                   atol=5e-5, err_msg=name)
    for k in ("h", "c"):
        np.testing.assert_allclose(got[f"{key}/{k}"], getattr(tr.state, k).numpy(),
                                   rtol=1e-3, atol=5e-5)
    unwrapped = arrs["positions"] + 4 * base["tcfg"]["superstep"] * dcfg.seq
    assert (got[f"{key}/positions"] != unwrapped).sum() >= 4
    first = arrs["positions"] + base["tcfg"]["superstep"] * dcfg.seq
    np.testing.assert_array_equal(got[f"{key}/first/positions"], first)
    assert (arrs["positions"] < SP_TRAJ_START).all()
    jmet, jparams, jpos = jax_superstep(work, key,
                                        jmesh.make_mesh(2, axis="seq"), "sp")
    np.testing.assert_allclose(got[f"{key}/0/bits_mean"], jmet["bits_mean"],
                               rtol=1e-4)
    np.testing.assert_array_equal(got[f"{key}/first/positions"], jpos)
    assert_params(got, f"{key}/first", jparams, "against JAX")


@pytest.mark.parametrize("mode", ["dp_sp", "tp_sp"])
def test_sp_2d_meshes_match_jax_and_single_device(dp_ranks, mode):
    """One superstep (3 steps, clip 0.1, C = 2) on a 2 x 2 data x seq and
    seq x model mesh of gloo ranks against the JAX ``make_dp_sp_superstep``
    and ``make_tp_sp_superstep`` on 2 x 2 virtual devices and the port's
    single-device Trainer: bits (rtol 1e-5), every canonical parameter,
    the accumulators, the gathered stream state, the cursors; the seq x
    model mesh runs the torch-op TP scan, as the JAX mesh runs its XLA
    scan."""
    key = {"dp_sp": "dpsp_22", "tp_sp": "tpsp_22"}[mode]
    got, work = dp_ranks(key)
    mesh = (jsp.make_mesh_dp_sp(2, 2) if mode == "dp_sp"
            else jsp.make_mesh_tp_sp(2, 2))
    jmet, jparams, jpos = jax_superstep(work, key, mesh, mode)
    smet, st = port_single(work, key)
    np.testing.assert_allclose(got[f"{key}/0/bits_mean"], jmet["bits_mean"],
                               rtol=BITS_RTOL)
    assert_params(got, key, jparams, "against JAX")
    np.testing.assert_array_equal(got[f"{key}/positions"], jpos)
    for k in ("bits_mean", "gnorm_mean", "gnorm_max"):
        np.testing.assert_allclose(got[f"{key}/0/{k}"], smet[k],
                                   rtol=BITS_RTOL, err_msg=k)
    assert_state(got, key, st, "against one device")
    assert str(got[f"{key}/backend"]) == ("xla" if mode == "tp_sp" else "")
    assert smet["gnorm_max"] > case_state(key)[0]["tcfg"]["clip_norm"]


def test_dp_sp_nonfinite_skip_reads_the_data_mean_loss(dp_ranks):
    """A NaN planted in stream 5's state (data row 1) makes the data-mean
    loss non-finite on a 2 x 2 data x seq mesh: every rank skips the step
    (``sp.py:430-432``: the loss is averaged over data before the skip),
    parameters, accumulators and stream state stay, the cursors move."""
    key = "skip_dpsp22"
    got, _ = dp_ranks(key)
    base, _, arrs = case_state(key)
    for name in arrs:
        if name.startswith(("params.", "opt.")):
            out = f"{key}/{name}" if name.startswith("params.") else \
                f"{key}/m/params.{name[len('opt.'):]}"
            np.testing.assert_array_equal(got[out], arrs[name], err_msg=name)
    for k in ("h", "c"):
        np.testing.assert_array_equal(got[f"{key}/{k}"], arrs[k])
    assert np.isnan(got[f"{key}/h"][0, NAN_STREAM, 0])
    np.testing.assert_array_equal(got[f"{key}/positions"],
                                  arrs["positions"] + base["dcfg"]["seq"])


def test_sp_rejections_carry_the_jax_messages():
    """The seq length not divisible by the seq devices, the batch not
    divisible by ``pp_chunks``, the batch not divisible by the data shards
    and the per-shard batch not divisible by ``pp_chunks`` under data x
    seq, the hidden width not divisible by the model devices under seq x
    model: the port's Trainer raises the JAX superstep functions'
    ``ValueError``, message for message."""
    cpu = torch.device("cpu")
    ax = lambda n: mesh_mod.AxisGroup(0, n, cpu)
    data = np.tile(np.arange(17, dtype=np.uint8), 100)
    jdata = jnp.asarray(data)
    cases = [
        ("sp", dict(seq=10), {}, 16, None, None, 4,
         "seq 10 not divisible by 4 seq devices"),
        ("sp", dict(batch=6), {}, 16, None, None, 2,
         "batch 6 not divisible by pp_chunks 4"),
        ("dp_sp", dict(batch=6), {}, 16, 4, None, 2,
         "batch 6 not divisible by 4 data shards"),
        ("dp_sp", dict(batch=8), dict(pp_chunks=4), 16, 4, None, 2,
         "per-shard batch 2 not divisible by pp_chunks 4"),
        ("dp_sp", dict(seq=10), dict(pp_chunks=2), 16, 2, None, 4,
         "seq 10 not divisible by 4 seq devices"),
        ("tp_sp", {}, dict(pp_chunks=2), 18, None, 4, 2,
         "hidden 18 not divisible by 4 model devices"),
        ("tp_sp", dict(batch=6), {}, 16, None, 2, 2,
         "batch 6 not divisible by pp_chunks 4"),
    ]
    for mode, dkw, tkw, hidden, n_data, n_model, n_seq, msg in cases:
        dkw = dict(dict(batch=8, seq=8, train_percent=1.0), **dkw)
        mesh = mesh_mod.ProcessMesh(n_data and ax(n_data),
                                    n_model and ax(n_model), cpu,
                                    seq=ax(n_seq))
        with pytest.raises(ValueError, match=f"^{msg}$"):
            Trainer(ModelConfig(hidden=hidden), DataConfig(**dkw),
                    TrainConfig(**tkw), data, mesh=mesh, device="cpu")
        jcfg, jd, jt = (JConfig(hidden=hidden, vocab=32), JData(**dkw),
                        JTrain(**tkw))
        if mode == "sp":
            build = lambda: jsp.make_sp_superstep(
                jcfg, jd, jt, jdata, jmesh.make_mesh(n_seq, axis="seq"))
        elif mode == "dp_sp":
            build = lambda: jsp.make_dp_sp_superstep(
                jcfg, jd, jt, jdata, jsp.make_mesh_dp_sp(n_data, n_seq))
        else:
            build = lambda: jsp.make_tp_sp_superstep(
                jcfg, jd, jt, jdata, jsp.make_mesh_tp_sp(n_seq, n_model))
        with pytest.raises(ValueError, match=f"^{msg}$"):
            build()


def test_cli_sp2_trains_with_gradcheck_and_its_checkpoint_loads(
        dp_ranks, capsys, tmp_path):
    """``cli train --sp 2 --gradcheck-every 1`` on two gloo ranks: the
    sequence-pipelined line, the resident corpus, the float64 shadow check
    at every superstep with 0 failures, the single device's bits (rel
    1e-5) and a checkpoint that loads in the port and in the JAX package,
    equal to the single device's within 1e-4."""
    key = "cli_sp2"
    got, work = dp_ranks(key)
    out = str(got[f"{key}/stdout"])
    assert "sequence-pipelined over 2 time segments" in out
    assert "data: resident on the device" in out
    gradcheck_lines(out, 10)
    tcli.main(CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")]
              + ["--ckpt-dir", str(tmp_path)])
    np.testing.assert_allclose(steps_of(out), steps_of(capsys.readouterr().out),
                               rtol=BITS_RTOL)
    check_checkpoints(work / key / "ckpt.npz", tmp_path / "ckpt.npz")


@pytest.mark.parametrize("flags,line", [
    (["--sp", "1"], "sequence-pipelined over 1 time segments"),
    (["--dp", "1", "--sp", "1"], "2-D mesh: 1 data x 1 seq devices"),
    (["--sp", "1", "--tp", "1"], "2-D mesh: 1 seq x 1 model devices")])
def test_cli_sp1_needs_no_launcher(capsys, flags, line):
    """``--sp 1``, ``--dp 1 --sp 1`` and ``--sp 1 --tp 1`` run in one
    process (a gloo group of one), on the resident corpus, with
    ``--pp-chunks 2``, and give the single device's bits (rel 1e-5)."""
    argv = CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")]
    tcli.main(argv + flags + ["--pp-chunks", "2"])
    out = capsys.readouterr().out
    assert line in out and "data: resident on the device" in out
    tcli.main(argv + ["--resident-data"])
    np.testing.assert_allclose(steps_of(out), steps_of(capsys.readouterr().out),
                               rtol=BITS_RTOL)


def test_cli_sp_combination_rules_and_refusals():
    """The JAX CLI's rules with its messages; ``--pp N > 1`` and ``--sp N >
    1`` in one process name the launcher, alone and on a 2-D mesh;
    ``--crosscheck`` stays on one device, under ``--pp`` too;
    ``--pp-chunks`` reaches the TrainConfig."""
    argv = CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")]
    for flags, msg in (
            (["--sp", "2", "--pp", "2"], "--pp combines only with --dp"),
            (["--dp", "2", "--sp", "2", "--tp", "2"],
             "at most two parallel axes may be combined"),
            (["--pp", "2"], "--pp 2: the mesh is one process a device, and "
                            "this run has 1 \\(start 2 with torchrun "
                            "--nproc_per_node 2\\)"),
            (["--dp", "2", "--pp", "2"], "--dp 2 --pp 2: the mesh is one "
                                         "process a device, and this run has "
                                         "1 \\(start 4"),
            (["--sp", "2"], "--sp 2: the mesh is one process a device, "
                            "and this run has 1 \\(start 2 with torchrun "
                            "--nproc_per_node 2\\)"),
            (["--dp", "2", "--sp", "2"], "--dp 2 --sp 2: the mesh is one "
                                         "process a device, and this run has "
                                         "1 \\(start 4"),
            (["--sp", "2", "--tp", "2"], "--sp 2 --tp 2: the mesh is one "
                                         "process a device, and this run has "
                                         "1 \\(start 4"),
            (["--sp", "1", "--crosscheck", "1"],
             "--crosscheck with --dp, --tp, --sp or --pp: it runs on one "
             "device"),
            (["--pp", "1", "--crosscheck", "1"],
             "--crosscheck with --dp, --tp, --sp or --pp: it runs on one "
             "device")):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(argv + flags)
    parse = lambda *a: tcli._configs(tcli.build_parser().parse_args(
        ["train", "--data", ALICE] + list(a)))[2].pp_chunks
    assert parse() == 4 and parse("--pp-chunks", "8") == 8
    assert tcli.build_parser().parse_args(
        ["train", "--data", ALICE, "--sp", "2"]).stream_data is False


def test_init_mesh_layouts():
    """The rank of each axis in the three 2-D layouts (rank = row * M +
    column: data x seq, seq x model as the JAX ``make_mesh_dp_sp`` and
    ``make_mesh_tp_sp`` lay them out) as ``ProcessMesh.rank`` reads them
    back, and the axes ``init_mesh`` refuses."""
    cpu = torch.device("cpu")
    for n_rows, n_cols in ((2, 2), (1, 2), (2, 1), (2, 3)):
        for r in range(n_rows * n_cols):
            row, col = divmod(r, n_cols)
            rows, cols = (mesh_mod.AxisGroup(row, n_rows, cpu),
                          mesh_mod.AxisGroup(col, n_cols, cpu))
            assert mesh_mod.ProcessMesh(rows, None, cpu, seq=cols).rank == r
            assert mesh_mod.ProcessMesh(None, cols, cpu, seq=rows).rank == r
    jnames = (jsp.make_mesh_dp_sp(2, 2).axis_names,
              jsp.make_mesh_tp_sp(2, 2).axis_names)
    assert jnames == (("data", "seq"), ("seq", "model"))
    from eigen_lstm_tpu_torch.config import MeshConfig

    for cfg in (MeshConfig(num_devices=None),
                MeshConfig(num_devices=2, seq_devices=2, model_devices=2),
                MeshConfig(num_devices=None, model_devices=2)):
        with pytest.raises(ValueError, match="init_mesh takes"):
            mesh_mod.init_mesh(cfg, "cpu")
