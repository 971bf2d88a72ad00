"""The bench's warm-up trajectory from the JAX bench's step-0 state
(``artifacts/bench_jax_start/state0.npz``), on the CPU.

* The JAX package's (``artifacts/bench_jax_start/trajectory.json``, written
  by ``tests/jax_bench_trajectory.py``): six finite supersteps of 50 steps,
  each mean below the first's; its first superstep, regenerated from the
  JAX package on the CPU, equals the file's.
* The JAX package's whole schedule (``trajectory_full.json``, the same
  script): 66 finite supersteps whose first six are ``trajectory.json``'s,
  bit for bit; its last superstep's mean is the JAX package's train_bpc
  off the TPU, which PERF.md sets beside the port's and the TPU's.
* The port's (``artifacts/bench_jax_start/port_cpu_trajectory.json``,
  written by ``tests/torch_bench_trajectory.py``, the plain versions): the
  same form. Its 50-step supersteps are too slow for this suite (about a
  minute each on an 8-core CPU); PERF.md sets them beside the JAX file's.
* The port's first FIRST_STEPS single steps on the CPU from the same start
  against the JAX package's, at the bench's full widths: the bits within
  BITS_ATOL and the gradient norm within GNORM_RTOL. These steps run at
  lr 0 (the bench's 20 warm-up steps), so the parameters stay the same
  while the windows, the cursors and the accumulators move: the two
  packages' bf16 forward and backward differ only in the order of fp32
  sums and in the bf16 roundings that order flips (measured over ten such
  steps: 2e-6 in the bits, 7e-5 relative in the norm).
* The data path of the whole bench schedule (6 + 60 supersteps of 50
  steps) from that start: the port's streamed windows equal the JAX
  package's, superstep by superstep, and its cursors and wrap masks equal
  the JAX package's at every step (42 streams wrap within the 3300 steps,
  the first before step 78).
"""

import json
import math

import numpy as np
import pytest
import torch

from eigen_lstm_tpu.data import corpus as jcorpus
from eigen_lstm_tpu_torch import bench as tbench
from eigen_lstm_tpu_torch.cli import build_parser
from eigen_lstm_tpu_torch.data import corpus as tcorpus

import jax_bench_start

import jax_bench_trajectory
import torch_bench_trajectory

FIRST_STEPS = 3
SCHEDULE = 66   # supersteps of the bench: 300 warm-up and 3000 timed steps
BITS_ATOL, GNORM_RTOL = 1e-4, 1e-3
KEYS = ("bits_mean", "bits_last", "gnorm_mean", "gnorm_max")


def _supersteps(path):
    with open(path) as f:
        return json.load(f)["supersteps"]


@pytest.mark.parametrize("path", [jax_bench_trajectory.TRAJECTORY,
                                  torch_bench_trajectory.TRAJECTORY])
def test_committed_trajectory_falls(path):
    steps = _supersteps(path)
    assert len(steps) == jax_bench_trajectory.SUPERSTEPS == 6
    for s in steps:
        assert sorted(s) == sorted(KEYS)
        assert all(math.isfinite(s[k]) for k in KEYS)
    first = steps[0]["bits_mean"]
    assert first < 8.0   # log2 256: the untrained model
    assert all(s["bits_mean"] < first for s in steps[1:])


def test_full_jax_schedule_extends_the_warm_up():
    steps = _supersteps(jax_bench_trajectory.FULL)
    assert len(steps) == SCHEDULE
    assert all(math.isfinite(s[k]) for s in steps for k in KEYS)
    assert steps[:6] == _supersteps(jax_bench_trajectory.TRAJECTORY)
    assert steps[-1]["bits_mean"] < steps[5]["bits_mean"]


def test_jax_first_superstep_regenerates_the_file():
    got = jax_bench_trajectory.jax_supersteps(1)[0]
    want = _supersteps(jax_bench_trajectory.TRAJECTORY)[0]
    assert got == want


def test_port_first_steps_follow_jax():
    got = torch_bench_trajectory.port_supersteps(FIRST_STEPS, superstep=1)
    want = jax_bench_trajectory.jax_supersteps(FIRST_STEPS, superstep=1)
    for step, (g, w) in enumerate(zip(got, want)):
        assert abs(g["bits_mean"] - w["bits_mean"]) <= BITS_ATOL, (step, g, w)
        assert abs(g["gnorm_mean"] - w["gnorm_mean"]) <= \
            GNORM_RTOL * w["gnorm_mean"], (step, g, w)


def test_port_bench_data_path_is_the_jax_one():
    jt = jax_bench_start.jax_bench_trainer()
    jt.restore(jax_bench_start.STATE)
    args = build_parser().parse_args(tbench.DEFAULT_ARGV + ["--device", "cpu"])
    pt = tbench.make_trainer(args)
    pt.restore(jax_bench_start.STATE)
    length = len(jt.feeder.data)
    assert pt.length == length
    for k in range(SCHEDULE):
        np.testing.assert_array_equal(
            np.asarray(jt.feeder.next_batch(), np.int64),
            pt.feeder.next_device_batch().numpy().astype(np.int64),
            err_msg=f"superstep {k}")
    jpos, tpos = np.asarray(jt.state.positions), pt.state.positions
    seq = args.seq
    stride = pt.dcfg.effective_stride   # the window: segments, state carried
    wraps = 0
    for step in range(SCHEDULE * args.superstep):
        jpos, jwrap = (np.asarray(a) for a in jcorpus.advance_positions(
            jpos, stride, length, seq))
        tpos, twrap = tcorpus.advance_positions(tpos, stride, length, seq)
        np.testing.assert_array_equal(tpos.numpy(), jpos, err_msg=f"step {step}")
        np.testing.assert_array_equal(twrap.numpy(), jwrap, err_msg=f"step {step}")
        wraps += int(jwrap.sum())
    assert wraps == 42 and tpos.dtype == torch.int32
