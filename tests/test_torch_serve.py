"""The serving slice of the port as a whole against the JAX package: held-out
bits/char and greedy samples of both shipped checkpoints, and the CLI.

The JAX side runs its Pallas kernels in interpret mode
(``select_cell_fn("pallas", cfg, 16, interpret=True)``); the port runs the
plain versions of its CUDA kernels, which is what it does on the CPU. Both
score the held-out 5 % of data/cantrbry/bible.txt, capped at 4096 bytes.

Tolerances: float32 rtol 1e-5 on bits/char (tests/test_pallas_cell.py:60-87
holds losses to it); bf16 rtol 1e-3, since one bf16 rounding of h_{t-1}
can flip by an ulp between the frameworks and move later steps. Greedy
samples in float32 must be token-exact: argmax picks the first maximum in
both, and the logits agree far below the gaps between them on this prime.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.data import corpus as jcorpus
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.models import sampler as jsampler
from eigen_lstm_tpu.ops import dispatch as jdispatch
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import evaluator as jeval
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.models import sampler as tsampler
from eigen_lstm_tpu_torch.ops import _build as tbuild
from eigen_lstm_tpu_torch.ops import dispatch as tdispatch
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import evaluator as teval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data/cantrbry/bible.txt")
CKPTS = {
    "flagship": (os.path.join(ROOT, "artifacts/flagship_drop/ckpt_best.npz"), 1024, 3),
    "h512": (os.path.join(ROOT, "artifacts/bible_h512/ckpt.npz"), 512, 1),
}
MAX_CHARS = 4096
RTOL = {"float32": 1e-5, "bfloat16": 1e-3}


@pytest.fixture(scope="module")
def test_split():
    return jcorpus.split(jcorpus.rawread(CORPUS), 0.95)[1]


@pytest.fixture(scope="module")
def arrays():
    """Parameter arrays of each checkpoint, read once."""
    out = {}
    for name, (path, _, _) in CKPTS.items():
        with np.load(path) as z:
            out[name] = {k: z[k] for k in z.files if k.startswith("params")}
    return out


def _both(name, arrays, dtype):
    _, hidden, layers = CKPTS[name]
    kw = dict(hidden=hidden, num_layers=layers, compute_dtype=dtype)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays[name])
    tp = tckpt.params_from_numpy(arrays[name], tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["flagship", "h512"])
def test_evaluate_bpc_matches_jax_kernels(name, dtype, arrays, test_split):
    jcfg, jp, tcfg, tp = _both(name, arrays, dtype)
    jcell = jdispatch.select_cell_fn("pallas", jcfg, 16, interpret=True)
    want = jeval.evaluate_bpc(jp, test_split, jcfg, max_chars=MAX_CHARS,
                              cell_fn=jcell)
    tcell = tdispatch.select_cell_fn("auto", tcfg, 16, "cpu")
    got = teval.evaluate_bpc(tp, test_split, tcfg, max_chars=MAX_CHARS,
                             cell_fn=tcell)
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
    assert got < 3.0


@pytest.mark.parametrize("name", ["flagship", "h512"])
def test_greedy_sample_token_exact(name, arrays):
    jcfg, jp, tcfg, tp = _both(name, arrays, "float32")
    want = jsampler.sample_text(jp, jcfg, jax.random.PRNGKey(0), length=64,
                                temperature=0.0)
    got = tsampler.sample_text(tp, tcfg, None, length=64, temperature=0.0)
    assert got == want and len(got) == 64


def test_temperature_sample_is_seeded(arrays):
    _, _, tcfg, tp = _both("h512", arrays, "float32")
    draws = [tsampler.sample_text(tp, tcfg, torch.Generator().manual_seed(s),
                                  length=48, temperature=0.7)
             for s in (3, 3, 4)]
    assert draws[0] == draws[1] and draws[0] != draws[2]
    assert all(len(d) == 48 for d in draws)


def test_sample_ids_leaves_batched_cuda_sampling_to_the_next_slice(monkeypatch):
    """Batched sampling on the card, which this test once showed raising as
    left to a later slice, goes to the generation kernel: a CUDA tensor
    under "auto" or "cuda" reaches the kernel's launcher (stubbed here to
    raise) and never the forward_step loop."""
    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def launcher():
        raise RuntimeError("launcher reached")

    def no_loop(*args, **kwargs):
        raise AssertionError("the forward_step loop ran")

    monkeypatch.setattr(tbuild, "load_library", launcher)
    monkeypatch.setattr(tmodel, "forward_step", no_loop)
    cfg = TConfig(hidden=32, vocab=16)
    fake = lambda x: x.as_subclass(FakeCuda)
    params = tmodel.init_params(cfg, device="cpu")
    params = tmodel.LSTMParams(
        tuple(tmodel.LayerParams(fake(l.W), fake(l.U), fake(l.b))
              for l in params.layers), fake(params.Why), fake(params.by))
    h0, c0 = tmodel.init_state(cfg, 8, device="cpu")
    first = fake(torch.zeros(8, dtype=torch.int64))
    for backend in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="launcher reached"):
            tsampler.sample_ids(params, cfg, torch.Generator(), first,
                                fake(h0), fake(c0), 4, backend=backend)


def test_cli_eval_prints_the_jax_bpc(arrays, test_split, capsys):
    """``eval --device cpu`` prints the bits/char the JAX package's CLI
    computes on the CPU (its XLA scan) for the same checkpoint and flags."""
    path, hidden, layers = CKPTS["h512"]
    jcfg = JConfig(hidden=hidden, num_layers=layers)
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays["h512"])
    want = jeval.evaluate_bpc(jp, test_split, jcfg, max_chars=MAX_CHARS)
    tcli.main(["eval", "--ckpt", path, "--data", CORPUS, "--hidden", str(hidden),
               "--layers", str(layers), "--eval-chars", str(MAX_CHARS),
               "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == {"test_bpc"}
    np.testing.assert_allclose(got["test_bpc"], want, rtol=RTOL["float32"])


def test_cli_sample_and_unported_commands(capsys):
    path, hidden, layers = CKPTS["h512"]
    tcli.main(["sample", "--ckpt", path, "--data", CORPUS, "--hidden", str(hidden),
               "--layers", str(layers), "--length", "40", "--temperature", "0",
               "--device", "cpu"])
    assert len(capsys.readouterr().out.rstrip("\n")) >= 30
    with pytest.raises(SystemExit, match="not ported yet"):
        tcli.main(["bench", "--data", CORPUS, "--profile", "trace"])
    args = tcli.build_parser().parse_args(
        ["eval", "--ckpt", "x", "--data", "y", "--hidden", "2048",
         "--dtype", "bfloat16"])
    assert tcli._configs(args)[0].residual_dtype == "bfloat16"
