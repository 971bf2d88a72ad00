"""The port's command line against the JAX package's: every subcommand takes
the same flags, and the same argument list gives the same configs.

Each argument list is parsed by both parsers and run through both
``_configs``; the ModelConfig, DataConfig and TrainConfig the two packages
share (they have the same fields) must be equal, field for field. The
known differences are listed in ``PORT_ONLY``, ``JAX_ONLY`` and
``BACKENDS``. One case evaluates a small tied checkpoint written by the JAX
package through the port's ``eval`` on the CPU, with the JAX subcommand's
data and train flags, against the JAX ``evaluate_bpc`` (fp32, rtol 1e-5,
as tests/test_pallas_cell.py:60-87 holds losses).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu import cli as jcli
from eigen_lstm_tpu.data import corpus as jcorpus
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import evaluator as jeval
from eigen_lstm_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALICE = os.path.join(ROOT, "data/alice29.txt")

# The port's own differences: it runs on a card or the CPU (--device); its
# backends are its kernels or their plain versions, where the JAX package
# picks Pallas or the XLA scan.
PORT_ONLY = {"--device"}
JAX_ONLY = set()
BACKENDS = {"jax": {"auto", "xla", "pallas"}, "port": {"auto", "cuda", "plain"}}

CASES = {
    "train": [
        ["--tie-embeddings"],
        ["--tie-embeddings", "--hidden", "1024", "--layers", "3", "--batch",
         "128", "--seq", "256", "--dtype", "bfloat16", "--dropout", "0.35",
         "--lr", "0.005", "--warmup", "0", "--clip-norm", "2.0",
         "--superstep", "50", "--steps", "100", "--stream-data"],
        ["--tie-embeddings", "--hidden", "2048", "--dtype", "bfloat16",
         "--cell", "standard", "--epochs", "2", "--stride", "50",
         "--no-carry", "--reset-std", "0.1", "--resident-data",
         "--lr-cycle-steps", "100", "--keep-snapshots", "--crosscheck", "5",
         "--gradcheck-every", "7", "--scan-chunk", "4", "--pp-chunks", "2"],
    ],
    "eval": [
        ["--ckpt", "x.npz", "--tie-embeddings", "--batch", "128", "--seq", "256"],
        ["--ckpt", "x.npz", "--tie-embeddings", "--batch", "128", "--seq",
         "256", "--hidden", "1024", "--layers", "3", "--dtype", "bfloat16",
         "--eval-chars", "4096", "--lr", "0.02", "--steps", "5"],
    ],
    "sample": [
        ["--ckpt", "x.npz", "--tie-embeddings", "--batch", "128", "--seq", "256"],
        ["--ckpt", "x.npz", "--tie-embeddings", "--batch", "128", "--seq",
         "600", "--dtype", "bfloat16", "--length", "40", "--temperature",
         "0.7", "--superstep", "10"],
    ],
    "bench": [
        ["--tie-embeddings", "--bench-steps", "10", "--warmup-steps", "2"],
        ["--tie-embeddings", "--hidden", "512", "--batch", "64", "--seq",
         "100", "--dtype", "bfloat16", "--residual-dtype", "float32"],
    ],
}


def _subparsers(ap):
    (action,) = [a for a in ap._actions
                 if a.__class__.__name__ == "_SubParsersAction"]
    return action.choices


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_subcommand_takes_the_jax_flags(cmd):
    jsub = _subparsers(jcli.build_parser())[cmd]
    tsub = _subparsers(tcli.build_parser())[cmd]
    flags = lambda p: {o for a in p._actions for o in a.option_strings}
    assert flags(tsub) - flags(jsub) == PORT_ONLY
    assert flags(jsub) - flags(tsub) == JAX_ONLY
    choices = lambda p: {c for a in p._actions if "--backend" in a.option_strings
                         for c in a.choices}
    assert (choices(jsub), choices(tsub)) == (BACKENDS["jax"], BACKENDS["port"])


@pytest.mark.parametrize("cmd,idx", [(c, i) for c in sorted(CASES)
                                     for i in range(len(CASES[c]))])
def test_same_flags_give_the_same_configs(cmd, idx):
    argv = [cmd, "--data", ALICE] + CASES[cmd][idx]
    want = jcli._configs(jcli.build_parser().parse_args(argv))
    got = tcli._configs(tcli.build_parser().parse_args(argv))
    for j, t in zip(want, got):
        assert dataclasses.asdict(t) == dataclasses.asdict(j), type(t).__name__
    assert got[0].tie_embeddings


def test_cli_eval_of_a_tied_jax_checkpoint(tmp_path, capsys):
    """A 2x32 tied model written by the JAX package, evaluated by the port's
    ``eval --device cpu`` with the JAX subcommand's data flags, gives the
    JAX ``evaluate_bpc``."""
    hidden, layers, max_chars = 32, 2, 2048
    jcfg = JConfig(hidden=hidden, num_layers=layers, tie_embeddings=True)
    like = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    flat = {k: (rng.standard_normal(v.shape) * 0.4).astype(np.float32)
            for k, v in jckpt._flatten(like, "params").items()}
    params = jckpt._unflatten_like(like, "params", flat)
    assert params.layers[0].W.shape == (hidden, 4 * hidden)   # tied: (N, 4N)
    path = str(tmp_path / "tied.npz")
    jckpt.save_checkpoint(path, params, {}, step=0)
    test = jcorpus.split(jcorpus.rawread(ALICE), 0.95)[1]
    want = jeval.evaluate_bpc(params, test, jcfg, max_chars=max_chars)
    tcli.main(["eval", "--ckpt", path, "--data", ALICE, "--hidden", str(hidden),
               "--layers", str(layers), "--tie-embeddings", "--batch", "128",
               "--seq", "256", "--eval-chars", str(max_chars), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(got["test_bpc"], want, rtol=1e-5)
    assert 1.0 < want < 20.0
