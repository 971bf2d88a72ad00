"""The JAX bench's step-0 state (``artifacts/bench_jax_start/state0.npz``,
written by ``tests/jax_bench_start.py``) on the CPU.

* Regenerated from the JAX package (its bench ``Trainer`` at the root
  ``bench.py``'s arguments, saved with ``Trainer.save``), it equals the
  committed file array for array, bit for bit: the file is the JAX start,
  and nothing in the JAX package has moved it.
* Restored into the port's bench ``Trainer`` (``eigen_lstm_tpu_torch.bench``
  at its default arguments, on the CPU), the port holds the same
  parameters, Adagrad accumulators, cursors and stream state, bit for bit,
  at step 0. ``chip_smoke.py`` runs the bench schedule on the card from
  this state.
"""

import numpy as np
import pytest
import torch

from eigen_lstm_tpu_torch import bench as tbench
from eigen_lstm_tpu_torch.cli import build_parser
from eigen_lstm_tpu_torch.models.lstm import tensors

import jax_bench_start


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_committed_state_is_the_jax_bench_start(tmp_path):
    want = _arrays(jax_bench_start.STATE)
    got = _arrays(jax_bench_start.write_state(str(tmp_path / "state0.npz")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # the root bench's model: 1 x 512 over 256 bytes, 128 streams, step 0
    assert want["params.layers[0].U"].shape == (512, 2048)
    assert want["data/positions"].shape == (128,)
    assert bytes(want["meta/json"]).decode().startswith('{"step": 0')


@pytest.fixture(scope="module")
def restored():
    args = build_parser().parse_args(tbench.DEFAULT_ARGV + ["--device", "cpu"])
    trainer = tbench.make_trainer(args)
    trainer.restore(jax_bench_start.STATE)
    return trainer, _arrays(jax_bench_start.STATE)


def _names(prefix):
    return [f"{prefix}.layers[0].W", f"{prefix}.layers[0].U",
            f"{prefix}.layers[0].b", f"{prefix}.Why", f"{prefix}.by"]


@pytest.mark.parametrize("part", ["params", "opt"])
def test_port_bench_restores_params_and_accumulators(restored, part):
    trainer, z = restored
    st = trainer.state
    held = tensors(st.params if part == "params" else st.m)
    assert len(held) == 5
    for name, t in zip(_names(part), held):
        assert t.dtype == torch.float32 and t.device.type == "cpu", name
        np.testing.assert_array_equal(t.numpy(), z[name], err_msg=name)


def test_port_bench_restores_cursors_and_streams(restored):
    trainer, z = restored
    st = trainer.state
    assert trainer.step == 0
    np.testing.assert_array_equal(st.positions.numpy(), z["data/positions"])
    np.testing.assert_array_equal(st.h.numpy(), z["data/stream_h"])
    np.testing.assert_array_equal(st.c.numpy(), z["data/stream_c"])
    # the streamed windows start at the restored cursors
    np.testing.assert_array_equal(trainer.feeder.positions, z["data/positions"])
