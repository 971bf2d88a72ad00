"""Data parallelism of the port (``parallel/mesh.py:init_mesh``,
``parallel/dp.py``, the DP ``Trainer`` and ``cli train --dp N``) against
the JAX package's ``make_dp_superstep`` on the virtual CPU mesh and against
the port's single device.

The port runs one process a rank: the cases of each world size run once on
spawned gloo ranks (``tests/torch_dp_ranks.py``,
``tests/torch_dp_worker.py``), through the plain versions, from
checkpoints written from a numpy seed. Tolerances are
``tests/test_parallel.py:41-72``'s: bits rtol 1e-5, parameters rtol 1e-4 /
atol 1e-6, positions equal. The masks, the skip and the data paths are
held against the port's own single-device functions on each shard.
"""

import numpy as np
import pytest
import torch

from eigen_lstm_tpu.parallel import mesh as jmesh

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig, MeshConfig, TrainConfig
from eigen_lstm_tpu_torch.data import corpus as corpus_mod
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.parallel import dp as dp_mod
from eigen_lstm_tpu_torch.parallel import mesh as mesh_mod
from eigen_lstm_tpu_torch.train.trainer import Trainer

from torch_dp_ranks import (ALICE, BITS_RTOL, CLI_ARGV, NAN_STREAM, PARAM_ATOL,
                            PARAM_RTOL, assert_params, assert_state, case_state,
                            check_checkpoints, dp_ranks, gradcheck_lines,
                            jax_superstep, max_gap, port_single,
                            shard_reference, steps_of)

__all__ = ["dp_ranks"]


@pytest.mark.parametrize("ndev", [2, 4])
def test_dp_matches_jax_and_single_device(dp_ranks, ndev):
    """One superstep (4 steps, clip 0.1) of the DP Trainer over D gloo ranks
    against the JAX DP superstep on D virtual devices and the port's
    single-device Trainer, from one checkpoint: bits, every parameter,
    the accumulators, the gathered stream state and the cursors."""
    key = f"dp_{ndev}"
    got, work = dp_ranks(key)
    jmet, jparams, jpos = jax_superstep(work, key, jmesh.make_mesh(ndev), "dp")
    smet, st = port_single(work, key)
    np.testing.assert_allclose(got[f"{key}/0/bits_mean"], jmet["bits_mean"],
                               rtol=BITS_RTOL)
    assert_params(got, key, jparams, "against JAX")
    np.testing.assert_array_equal(got[f"{key}/positions"], jpos)
    for k in ("bits_mean", "gnorm_mean", "gnorm_max"):
        np.testing.assert_allclose(got[f"{key}/0/{k}"], smet[k],
                                   rtol=BITS_RTOL, err_msg=k)
    assert_params(got, key, [p.numpy() for p in model.tensors(st.params)],
                  "against one device")
    for name, m in st.m.named_tensors():
        np.testing.assert_allclose(got[f"{key}/m/{name}"], m.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)
    for k in ("h", "c"):
        np.testing.assert_allclose(got[f"{key}/{k}"], getattr(st, k).numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)
    np.testing.assert_array_equal(got[f"{key}/positions"], st.positions.numpy())
    # the clip moves the update
    assert smet["gnorm_max"] > case_state(key)[0]["tcfg"]["clip_norm"]


def test_dp_dropout_key_folds_the_data_rank(dp_ranks):
    """With dropout 0.3 (2 layers) the DP step at D = 2 equals the mean of
    the two shards' single-device half-batch gradients, each under its
    step key with its data rank folded in (``dp.data_key``); the shards'
    keys differ, and one key for both shards misses the step."""
    key = "drop_dp2"
    got, work = dp_ranks(key)
    tcfg = TrainConfig(**case_state(key)[0]["tcfg"])
    step_key = model.step_key(tcfg.seed, 0)
    keys = [dp_mod.data_key(step_key, d) for d in range(2)]
    assert keys[0] != keys[1] and step_key not in keys
    assert_state(got, key, shard_reference(work, key, 2, keys.__getitem__))
    unfolded = shard_reference(work, key, 2, lambda d: step_key)
    assert max_gap(got, key, unfolded) > 100 * PARAM_ATOL


def test_dp_nonfinite_skip_is_per_shard(dp_ranks):
    """A NaN planted in stream 5's state makes shard 1's loss non-finite at
    D = 2: shard 1 adds zeros and keeps its pre-step state (the NaN
    included), shard 0's gradient is averaged in and its streams step on.
    A skip after the mean, or of every shard, leaves the parameters
    where they were."""
    key = "skip_dp2"
    got, work = dp_ranks(key)
    want = shard_reference(work, key, 2, lambda d: None)
    assert_state(got, key, want)
    base, _, arrs = case_state(key)
    assert np.isnan(got[f"{key}/h"][0, NAN_STREAM, 0])
    np.testing.assert_array_equal(got[f"{key}/h"][:, 4:], arrs["h"][:, 4:])
    assert not np.array_equal(got[f"{key}/h"][:, :4], arrs["h"][:, :4])
    moved = max(float(np.abs(got[f"{key}/{k}"] - arrs[k]).max())
                for k in arrs if k.startswith("params."))
    assert moved > 1e-3


def test_dp_streamed_equals_resident(dp_ranks):
    """Three supersteps at D = 2 on a 150-byte corpus, each rank fed its own
    B/D slice of the streamed windows, against the resident corpus: every
    metric and the whole canonical state bit for bit, with cursors that
    wrapped."""
    got, _ = dp_ranks("wrap_streamed")
    a, b = "wrap_resident", "wrap_streamed"
    for name in got:
        if name.startswith(a + "/"):
            np.testing.assert_array_equal(got[name], got[b + name[len(a):]],
                                          err_msg=name)
    base, data, arrs = case_state(a)
    limit = corpus_mod.corpus_limit(len(data), base["dcfg"]["seq"])
    steps = 3 * base["tcfg"]["superstep"]
    assert (arrs["positions"] + steps * base["dcfg"]["seq"] > limit).sum() >= 4


def test_cli_dp2_trains_and_its_checkpoint_loads_in_both_packages(
        dp_ranks, capsys, tmp_path):
    """``cli train --dp 2 --gradcheck-every 1`` on two gloo ranks: the
    single device's bits, the float64 shadow check at every superstep with
    0 failures, and a checkpoint that loads in the port and in the JAX
    package, equal to the single device's within 1e-4."""
    key = "cli_dp2"
    got, work = dp_ranks(key)
    out = str(got[f"{key}/stdout"])
    assert "data-parallel over 2 devices" in out
    assert "data: resident on the device" in out
    gradcheck_lines(out, 10)
    tcli.main(CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")]
              + ["--ckpt-dir", str(tmp_path)])
    ref = capsys.readouterr().out
    assert "data: streamed from the host" in ref
    np.testing.assert_allclose(steps_of(out), steps_of(ref), rtol=BITS_RTOL)
    check_checkpoints(work / key / "ckpt.npz", tmp_path / "ckpt.npz")


def test_cli_resolves_the_data_path_as_the_jax_cli():
    """``--stream-data`` left unset resolves, once the flags are parsed, to
    streaming on one device and to the resident corpus under a mesh
    (``eigen_lstm_tpu/cli.py:240-246``); the flags override it both ways;
    ``--tp 1`` builds a trainer without a feeder and says so."""
    parse = lambda *a: tcli.build_parser().parse_args(
        ["train", "--data", ALICE] + list(a))
    assert parse().stream_data is True
    for flags in (["--tp", "2"], ["--dp", "2"], ["--dp", "2", "--tp", "2"]):
        assert parse(*flags).stream_data is False, flags
        assert parse(*flags, "--stream-data").stream_data is True, flags
    assert parse("--resident-data").stream_data is False
    assert tcli.build_parser().parse_args(
        ["bench", "--data", ALICE]).stream_data is True


def test_cli_refusals_carry_the_jax_messages(capsys):
    """The JAX CLI's combination rules and messages; ``--dp 2``, ``--sp
    2``, ``--dp 2 --pp 2`` and ``--sp 2 --tp 2`` in one process name the
    launcher; the trainer's batch check is the JAX ``ValueError``;
    ``crosscheck`` stays on one device."""
    argv = CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")]
    for flags, msg in ((["--tp", "2", "--pp", "2"], "--pp combines only with --dp"),
                       (["--sp", "2", "--pp", "2"], "--pp combines only with --dp"),
                       (["--dp", "2", "--tp", "2", "--sp", "2"],
                        "at most two parallel axes may be combined"),
                       (["--sp", "2"], "--sp 2: the mesh is one process a "
                                       "device, and this run has 1 \\(start 2 "
                                       "with torchrun --nproc_per_node 2\\)"),
                       (["--dp", "2", "--pp", "2"], "--dp 2 --pp 2: the mesh is one "
                                                    "process a device, and this run "
                                                    "has 1 \\(start 4"),
                       (["--tp", "2", "--sp", "2"], "--sp 2 --tp 2: the mesh is one "
                                                    "process a device, and this run "
                                                    "has 1 \\(start 4"),
                       (["--dp", "1", "--crosscheck", "1"],
                        "--crosscheck with --dp, --tp, --sp or --pp: it runs on "
                        "one device"),
                       (["--dp", "2"], "--dp 2: the mesh is one process a device, "
                                       "and this run has 1 \\(start 2 with torchrun "
                                       "--nproc_per_node 2\\)"),
                       (["--dp", "2", "--tp", "2"], "--dp 2 --tp 2: the mesh is one "
                                                    "process a device, and this run "
                                                    "has 1 \\(start 4")):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(argv + flags)
    cfg, dcfg = ModelConfig(hidden=16), DataConfig(batch=16, seq=8)
    cpu = torch.device("cpu")
    three = mesh_mod.AxisGroup(0, 3, cpu)
    data = np.tile(np.arange(17, dtype=np.uint8), 100)
    with pytest.raises(ValueError, match="global batch 16 not divisible by 3 devices"):
        Trainer(cfg, dcfg, TrainConfig(), data,
                mesh=mesh_mod.ProcessMesh(three, None, cpu), device="cpu")
    with pytest.raises(ValueError, match="global batch 16 not divisible by 3$"):
        Trainer(cfg, dcfg, TrainConfig(), data,
                mesh=mesh_mod.ProcessMesh(three, mesh_mod.AxisGroup(0, 1, cpu), cpu),
                device="cpu")
    with pytest.raises(SystemExit, match="--dp 0: the mesh needs at least one"):
        mesh_mod.init_mesh(MeshConfig(num_devices=0), "cpu")
    tr = Trainer(cfg, DataConfig(batch=2, seq=8), TrainConfig(), data,
                 mesh=mesh_mod.ProcessMesh(mesh_mod.AxisGroup(0, 1, cpu), None,
                                           cpu), device="cpu")
    with pytest.raises(NotImplementedError, match="crosscheck under a mesh"):
        tr.crosscheck()
