"""The JAX bench's warm-up trajectory from its step-0 state, for the port's
bench to be held to superstep by superstep:
``JAX_PLATFORMS=cpu python tests/jax_bench_trajectory.py [PATH [N]]``
writes its first N supersteps (default ``SUPERSTEPS``) to PATH (default
``TRAJECTORY``), about 5 minutes on an 8-core CPU for the default six.

It builds the JAX package's bench ``Trainer`` on the CPU at the root
``bench.py``'s arguments (``tests/jax_bench_start.py``), restores the
committed step-0 state (``artifacts/bench_jax_start/state0.npz``) and runs
the bench's warm-up supersteps (300 steps in supersteps of 50, as
``eigen_lstm_tpu/bench.py`` does before it times anything). For each
superstep it records the mean and last bits/char and the mean and largest
gradient norm. Nothing in the JAX package is changed. In enwik6 each of
the 128 streams covers about 7,800 bytes, so the first cursors wrap before
step 100: the trajectory covers the wrap-reset path too.

``tests/test_torch_bench_trajectory.py`` regenerates the first superstep
and holds it to the file; ``chip_smoke.py`` (phase 6d) prints the port's
supersteps on the card beside the file's.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJECTORY = os.path.join(REPO, "artifacts", "bench_jax_start",
                          "trajectory.json")
# the whole bench schedule (6 warm-up and 60 timed supersteps), written by
# ``JAX_PLATFORMS=cpu python tests/jax_bench_trajectory.py FULL 66``
# (about 45 minutes on an 8-core CPU): the JAX package's train_bpc off
# the TPU, the mean of its last superstep
FULL = os.path.join(REPO, "artifacts", "bench_jax_start",
                    "trajectory_full.json")
SUPERSTEPS = 6      # the bench's 300 warm-up steps at supersteps of 50
KEYS = ("bits_mean", "bits_last", "gnorm_mean", "gnorm_max")


def jax_supersteps(n: int = SUPERSTEPS, superstep: int = 50):
    """The JAX bench ``Trainer``'s first ``n`` supersteps of ``superstep``
    steps from the committed step-0 state, on JAX's default device: a list
    of dicts of ``KEYS``."""
    import jax_bench_start

    trainer = jax_bench_start.jax_bench_trainer(superstep)
    trainer.restore(jax_bench_start.STATE)
    out = []
    for _ in range(n):
        trainer.state, metrics = trainer.dispatch_superstep()
        out.append({k: float(metrics[k]) for k in KEYS})
    return out


def write_trajectory(path: str = TRAJECTORY, n: int = SUPERSTEPS) -> dict:
    """Runs ``jax_supersteps(n)`` and writes them, with the versions and the
    backend, as JSON to ``path``; returns the record."""
    import jax
    import jaxlib

    record = {
        "source": "tests/jax_bench_trajectory.py",
        "start": "artifacts/bench_jax_start/state0.npz",
        "superstep": 50,
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "backend": jax.default_backend(),
        "supersteps": jax_supersteps(n),
    }
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return record


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    rec = write_trajectory(sys.argv[1] if len(sys.argv) > 1 else TRAJECTORY,
                           int(sys.argv[2]) if len(sys.argv) > 2 else SUPERSTEPS)
    for i, s in enumerate(rec["supersteps"]):
        print(i, json.dumps(s), flush=True)
