"""The port's bench warm-up trajectory on the CPU from the JAX bench's
step-0 state, beside the JAX package's:
``python tests/torch_bench_trajectory.py [PATH]`` writes it to PATH
(default ``TRAJECTORY``), about 8 minutes on a CPU.

It builds the port's bench ``Trainer`` (``eigen_lstm_tpu_torch.bench`` at
the root ``bench.py``'s arguments) on the CPU, where every wrapper runs its
kernel's plain version, restores the committed step-0 state
(``artifacts/bench_jax_start/state0.npz``) and runs the bench's warm-up
supersteps (``tests/jax_bench_trajectory.py``'s six of 50 steps), recording
for each what the JAX file records. Held beside
``artifacts/bench_jax_start/trajectory.json`` it separates the port's
arithmetic from its kernels: the card's run (``chip_smoke.py``, phase 6d)
is the same schedule through the kernels.
"""

from __future__ import annotations

import json
import os
import sys

from jax_bench_start import REPO, STATE

TRAJECTORY = os.path.join(REPO, "artifacts", "bench_jax_start",
                          "port_cpu_trajectory.json")
SUPERSTEPS = 6
KEYS = ("bits_mean", "bits_last", "gnorm_mean", "gnorm_max")


def port_supersteps(n: int = SUPERSTEPS, superstep: int = 50):
    """The port's bench ``Trainer``'s first ``n`` supersteps of
    ``superstep`` steps from the committed step-0 state, on the CPU: a
    list of dicts of ``KEYS``."""
    from eigen_lstm_tpu_torch import bench
    from eigen_lstm_tpu_torch.cli import build_parser

    args = build_parser().parse_args(bench.DEFAULT_ARGV + [
        "--device", "cpu", "--superstep", str(superstep)])
    trainer = bench.make_trainer(args)
    trainer.restore(STATE)
    out = []
    for _ in range(n):
        trainer.state, metrics = trainer.dispatch_superstep()
        out.append({k: float(metrics[k]) for k in KEYS})
    return out


def write_trajectory(path: str = TRAJECTORY, n: int = SUPERSTEPS) -> dict:
    """Runs ``port_supersteps(n)`` on the CPU and writes them, with the
    torch version, as JSON to ``path``; returns the record."""
    import torch

    record = {
        "source": "tests/torch_bench_trajectory.py",
        "start": "artifacts/bench_jax_start/state0.npz",
        "superstep": 50,
        "torch": torch.__version__,
        "device": "cpu",
        "supersteps": port_supersteps(n),
    }
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return record


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    rec = write_trajectory(sys.argv[1] if len(sys.argv) > 1 else TRAJECTORY)
    for i, s in enumerate(rec["supersteps"]):
        print(i, json.dumps(s), flush=True)
