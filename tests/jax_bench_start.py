"""The JAX bench's step-0 training state, for the port's bench to start
from: ``JAX_PLATFORMS=cpu python tests/jax_bench_start.py [PATH]`` writes
it to PATH (default ``STATE``).

It builds the JAX package's bench ``Trainer`` on the CPU at the root
``bench.py``'s arguments (``ROOT_BENCH_ARGV``, its argument list) as
``eigen_lstm_tpu/bench.py:26-42`` builds it, and saves its state with
``Trainer.save`` (``eigen_lstm_tpu/train/trainer.py:885-897``): the
parameters and Adagrad accumulators the JAX PRNG drew, the 128 cursors,
the stream state and the key. Nothing is trained. The port draws its
start from torch's generators, so its bench cannot reach this state by
itself; ``chip_smoke.py`` restores it into the port's bench ``Trainer``
and runs the bench schedule from it, and
``tests/test_torch_bench_start.py`` regenerates it and holds it to the
committed file.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = os.path.join(REPO, "artifacts", "bench_jax_start", "state0.npz")
# bench.py's arguments, with the corpus path relative to the repository
ROOT_BENCH_ARGV = [
    "bench", "--data", os.path.join(REPO, "data", "enwik6.txt"),
    "--hidden", "512", "--batch", "128", "--seq", "100",
    "--dtype", "bfloat16", "--train-percent", "1.0", "--superstep", "50",
    "--bench-steps", "3000", "--warmup-steps", "300", "--lr", "0.02",
    "--warmup", "20", "--stream-data",
]


def jax_bench_trainer(superstep: int = 50):
    """The JAX bench's ``Trainer`` at step 0, on JAX's default device, with
    supersteps of ``superstep`` steps (the bench's 50 by default)."""
    from eigen_lstm_tpu.cli import _configs, build_parser
    from eigen_lstm_tpu.data import corpus as corpus_mod
    from eigen_lstm_tpu.ops.dispatch import select_cell_fn
    from eigen_lstm_tpu.train.trainer import Trainer

    args = build_parser().parse_args(ROOT_BENCH_ARGV
                                     + ["--superstep", str(superstep)])
    mcfg, dcfg, tcfg = _configs(args)
    train, _ = corpus_mod.load_dataset(dcfg)
    cell_fn = select_cell_fn(args.backend, mcfg, dcfg.batch)
    return Trainer(mcfg, dcfg, tcfg, train, None, cell_fn=cell_fn,
                   streaming=bool(args.stream_data))


def write_state(path: str = STATE) -> str:
    """Saves the JAX bench's step-0 state to ``path``; returns it."""
    jax_bench_trainer().save(path)
    return path


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    print(write_state(sys.argv[1] if len(sys.argv) > 1 else STATE))
