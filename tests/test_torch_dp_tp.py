"""The data x model mesh of the port (``parallel/mesh.py:init_mesh``,
``parallel/dp_tp.py``, ``cli train --dp N --tp M``) against the JAX
package's ``make_dp_tp_superstep`` on the virtual CPU mesh and against the
port's single device; the collectives on their axis; the trainer's
gradcheck under a mesh.

The cases run once on spawned gloo ranks (``tests/torch_dp_ranks.py``),
through the plain versions, from checkpoints written from a numpy seed.
Tolerances are ``tests/test_dp_tp.py:12-38``'s: bits rtol 1e-5,
parameters rtol 1e-4 / atol 1e-6, positions equal.
"""

import contextlib
import io

import numpy as np
import pytest

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.parallel import dp_tp as jdp_tp
from eigen_lstm_tpu.train.trainer import _select_tp_backend as jselect

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig, TrainConfig
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn, select_tp_backend
from eigen_lstm_tpu_torch.parallel import dp as dp_mod
from eigen_lstm_tpu_torch.train.trainer import Trainer

from torch_dp_ranks import (BITS_RTOL, CLI_ARGV, GRADCHECK_SAMPLES, NAN_STREAM,
                            PARAM_ATOL, PARAM_RTOL, assert_params, assert_state,
                            case_state, check_checkpoints, dp_ranks,
                            gradcheck_lines, jax_superstep, max_gap,
                            port_single, shard_reference, steps_of)

__all__ = ["dp_ranks"]


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_dp_tp_matches_jax_and_single_device(dp_ranks, shape):
    """One superstep (3 steps, clip 0.1) on an N x M mesh of gloo ranks
    against the JAX 2-D superstep on N x M virtual devices and the port's
    single-device Trainer, from one checkpoint: bits, every canonical
    parameter and accumulator, the gathered stream state, the cursors; the
    TP family is the JAX ladder's at the per-shard batch without the
    per-step family."""
    n_data, n_model = shape
    key = f"dptp_{n_data}{n_model}"
    got, work = dp_ranks(key)
    jmet, jparams, jpos = jax_superstep(
        work, key, jdp_tp.make_mesh_2d(n_data, n_model), "dp_tp")
    smet, st = port_single(work, key)
    np.testing.assert_allclose(got[f"{key}/0/bits_mean"], jmet["bits_mean"],
                               rtol=BITS_RTOL)
    assert_params(got, key, jparams, "against JAX")
    np.testing.assert_array_equal(got[f"{key}/positions"], jpos)
    for k in ("bits_mean", "gnorm_mean", "gnorm_max"):
        np.testing.assert_allclose(got[f"{key}/0/{k}"], smet[k],
                                   rtol=BITS_RTOL, err_msg=k)
    assert_state(got, key, st, "against one device")
    base = case_state(key)[0]
    assert smet["gnorm_max"] > base["tcfg"]["clip_norm"]
    cfg = JConfig(**base["cfg"])
    batch = base["dcfg"]["batch"] // n_data
    assert str(got[f"{key}/backend"]) == jselect(cfg, batch, n_model, object(),
                                                 allow_per_step=False)


def test_dp_tp_dropout_mask_per_data_row(dp_ranks):
    """With dropout 0.3 (2 layers) a 2 x 2 step equals the mean of the two
    data rows' single-device half-batch gradients, each row's mask drawn
    from its data key over the full hidden stream (the model's own
    ``_dropout``, as the TP families draw it): one mask across the model
    shards of a row (a key that folded in the model rank would give each
    shard of the stream its own mask and miss this), another across rows
    (one key for both rows misses it too)."""
    key = "drop_dptp22"
    got, work = dp_ranks(key)
    step_key = model.step_key(TrainConfig(**case_state(key)[0]["tcfg"]).seed, 0)
    assert_state(got, key, shard_reference(
        work, key, 2, lambda d: dp_mod.data_key(step_key, d), kernels=False))
    unfolded = shard_reference(work, key, 2, lambda d: step_key, kernels=False)
    assert max_gap(got, key, unfolded) > 100 * PARAM_ATOL


def test_dp_tp_nonfinite_skip_reads_the_global_loss(dp_ranks):
    """A NaN planted in stream 5's state (data row 1) makes the mean loss
    over the data axis non-finite: every rank skips the step (the JAX 2-D
    superstep's objective is that mean), parameters, accumulators and
    stream state stay, the cursors move."""
    key = "skip_dptp22"
    got, _ = dp_ranks(key)
    base, data, arrs = case_state(key)
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


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_collectives_run_on_their_axis(dp_ranks, shape):
    """On an N x M mesh (rank = d * M + m) each collective of the data axis
    reduces over column m, each of the model axis over row d: the values
    every rank got, from tensors that carry the rank. A collective on the
    default group would gather N * M parts or sum every rank."""
    n_data, n_model = shape
    key = f"coll_{n_data}{n_model}"
    got, _ = dp_ranks(key)
    for r in range(n_data * n_model):
        d, m = divmod(r, n_model)
        for axis, members in (("data", [e * n_model + m for e in range(n_data)]),
                              ("model", [d * n_model + f for f in range(n_model)])):
            me = members.index(r)
            gather = np.repeat(np.asarray(members, np.float32), 2)[:, None]
            np.testing.assert_array_equal(got[f"{key}/{axis}/gather"][r],
                                          np.broadcast_to(gather, (len(gather), 4)))
            total = float(sum(members))
            np.testing.assert_array_equal(got[f"{key}/{axis}/sum"][r],
                                          np.full((2, 4), total))
            width = 4 // len(members)
            np.testing.assert_array_equal(got[f"{key}/{axis}/scatter"][r],
                                          np.full((2, width), total),
                                          err_msg=f"{axis} rank {r} ({me})")


@pytest.mark.parametrize("key,line", [
    ("cli_dp2tp2", "2-D mesh: 2 data x 2 model devices"),
    ("cli_tp2", "tensor-parallel over 2 devices")])
def test_cli_mesh_trains_with_gradcheck_and_its_checkpoint_loads(
        dp_ranks, capsys, tmp_path, key, line):
    """``cli train --dp 2 --tp 2`` (4 gloo ranks) and ``--tp 2`` (2) with
    ``--gradcheck-every 1``: the mesh's line, the resident corpus, the
    float64 shadow check at every superstep with 0 failures, the single
    device's bits (rel 1e-5), a checkpoint that loads in both packages."""
    got, work = dp_ranks(key)
    out = str(got[f"{key}/stdout"])
    assert line in out and "data: resident on the device" in out
    gradcheck_lines(out, 10)
    tcli.main(CLI_ARGV[:CLI_ARGV.index("--gradcheck-every")]
              + ["--ckpt-dir", str(tmp_path)])
    np.testing.assert_allclose(steps_of(out), steps_of(capsys.readouterr().out),
                               rtol=BITS_RTOL)
    check_checkpoints(work / key / "ckpt.npz", tmp_path / "ckpt.npz")


def test_gradcheck_under_tp_is_the_single_device_one(dp_ranks):
    """``Trainer.gradcheck`` under ``--tp 2`` after a superstep, on every
    rank, at the canonical state: passes with 0 failures and prints the
    lines of a single-device trainer restored from the checkpoint the TP
    trainer saved there (the same float64 shadow on the same inputs)."""
    key = "dp_tp2gc"
    got, work = dp_ranks(key)
    assert bool(got[f"{key}/ok"]) and int(got[f"{key}/failures"]) == 0
    base, data, _ = case_state(key)
    cfg, dcfg = ModelConfig(**base["cfg"]), DataConfig(**base["dcfg"])
    tr = Trainer(cfg, dcfg, TrainConfig(**base["tcfg"]), data, None,
                 cell_fn=select_cell_fn("plain", cfg, dcfg.batch, "cpu"),
                 device="cpu")
    tr.restore(str(work / f"{key}_saved.npz"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tr.gradcheck(samples_per_tensor=GRADCHECK_SAMPLES)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 5 and lines == str(got[f"{key}/stdout"]).splitlines()
    assert tr.step == base["tcfg"]["superstep"]


def test_tp_family_without_the_per_step_kernels_matches_jax():
    """``select_tp_backend(..., allow_per_step=False)`` against the JAX
    ladder with ``allow_per_step=False`` on a grid, on the CPU and a CUDA
    device alike: the window family or the XLA scan, never the per-step
    kernels."""
    seen = set()
    for n in (256, 512, 1024):
        for dt in ("float32", "bfloat16"):
            for b in (8, 12, 64, 128):
                t = ModelConfig(hidden=n, compute_dtype=dt)
                j = JConfig(hidden=n, compute_dtype=dt)
                for ndev in (1, 2, 4):
                    want = jselect(j, b, ndev, object(), allow_per_step=False)
                    for device in ("cpu", "cuda"):
                        got = select_tp_backend(t, b, ndev, object(), device,
                                                allow_per_step=False)
                        assert got == want, (n, dt, b, ndev, device)
                    seen.add(want)
    assert seen == {"pallas_seq", "xla"}
