"""The cases that tests/test_torch_dp.py, tests/test_torch_dp_tp.py,
tests/test_torch_sp.py and tests/test_torch_pp.py run on spawned gloo
ranks, and the pool that runs them.

For each world size (2, 4 and 8) the cases of every mesh of that size go to
one spawn of ``tests/torch_dp_worker.py``, once a test run: the first test
that asks for a world size spawns it under a file lock and later ones, in
either file and any xdist worker, read its results. Each case starts from
a checkpoint written here from a numpy seed (``params_from_numpy`` and the
port's ``save_checkpoint``), so the port's ranks, the port's single device
and the JAX package start from one state.
"""

import json
import os
import subprocess
import sys

import filelock
import jax
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import optimizer as jopt
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.config import DataConfig, TrainConfig
from eigen_lstm_tpu_torch.data import corpus as corpus_mod
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import trainer as trainer_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
ALICE = os.path.join(ROOT, "data", "alice29.txt")
RANKS_TIMEOUT_S = 600

# tests/test_parallel.py:build's model, batch and corpus (clip added, so
# the global norm moves the update); tests/test_dp_tp.py's for the mesh
DP = dict(cfg=dict(hidden=16, num_layers=1, loss_mode="all", seed=0),
          dcfg=dict(batch=16, seq=8, train_percent=1.0),
          tcfg=dict(lr=0.1, superstep=4, eval_every_s=1e9, clip_norm=0.1))
DP_TP = dict(cfg=dict(vocab=128, hidden=16, num_layers=1, loss_mode="all",
                      seed=0),
             dcfg=dict(batch=8, seq=8, train_percent=1.0),
             tcfg=dict(lr=0.1, superstep=3, eval_every_s=1e9, clip_norm=0.1))
# two layers with dropout, one step: the masks of each data shard
DROP = dict(cfg=dict(hidden=16, num_layers=2, loss_mode="all", dropout=0.3,
                     seed=0),
            dcfg=dict(batch=8, seq=8, train_percent=1.0),
            tcfg=dict(lr=0.1, superstep=1, eval_every_s=1e9))
# a short corpus, so that most cursors wrap within three supersteps
WRAP = dict(cfg=dict(hidden=16, num_layers=1, loss_mode="all", seed=0),
            dcfg=dict(batch=8, seq=8, train_percent=1.0),
            tcfg=dict(lr=0.1, superstep=4, eval_every_s=1e9))
WRAP_LEN = 150
NAN_STREAM = 5     # of 8: shard 1's at D = 2, row 1's on a 2 x 2 mesh
# tests/test_sp.py:125-166's and tests/test_compositions.py's meshes: the
# batch in 2 microchunks (1 row a chunk under --dp 2), clip added
SP_MESH = dict(cfg=dict(hidden=16, num_layers=1, loss_mode="all", seed=0),
               dcfg=dict(batch=8, seq=8, train_percent=1.0),
               tcfg=dict(lr=0.1, superstep=3, eval_every_s=1e9, clip_norm=0.1,
                         pp_chunks=2))
# tests/test_sp.py:77-111's trajectory: the wrap reset's noise, cursors
# in [SP_TRAJ_START / 2, SP_TRAJ_START) that wrap after the first
# superstep and before the fourth (the first, before any wrap, is held to
# the JAX package, whose noise differs from the port's)
SP_TRAJ = dict(cfg=dict(hidden=16, num_layers=1, loss_mode="all", seed=3),
               dcfg=dict(batch=8, seq=8, train_percent=1.0, reset_std=0.1),
               tcfg=dict(lr=0.1, superstep=3, eval_every_s=1e9, seed=7,
                         pp_chunks=2))
SP_TRAJ_LEN, SP_TRAJ_START = 150, 100
# the gradient cases of tests/test_torch_sp.py: tests/test_sp.py:setup's
# model and window (vocab 32, hidden 16, S = 16, B = 8)
SPG_S, SPG_B, SPG_VOCAB = 16, 8, 32
SPG_KEY = 0x1234567
CLI_ARGV = ["train", "--data", ALICE, "--hidden", "32", "--batch", "8",
            "--seq", "8", "--steps", "4", "--superstep", "2", "--log-every",
            "2", "--sample-chars", "0", "--eval-chars", "500", "--device",
            "cpu", "--lr", "0.05", "--gradcheck-every", "1"]
GRADCHECK_SAMPLES = 8
# the gradient cases of tests/test_torch_pp.py: tests/test_pp.py:setup's
# model and window (vocab 32, hidden 16, S = 8, B = 4)
PPG_S, PPG_B, PPG_VOCAB = 8, 4, 32
PPG_KEY = 0x7654321
# tests/test_pp.py:82-120's training superstep in float64 (3 steps, C = 4,
# its 3100-byte corpus of bytes 0-30); layers and loss mode from the key
PP_TRAIN = dict(cfg=dict(vocab=32, hidden=16, seed=0, param_dtype="float64",
                         compute_dtype="float64"),
                dcfg=dict(batch=4, seq=8, train_percent=1.0),
                tcfg=dict(lr=0.1, superstep=3, eval_every_s=1e9,
                          warmup_steps=0, pp_chunks=4))
# the data x stage mesh: two layers, the sequence in 2 chunks, clip added
PP_MESH = dict(cfg=dict(hidden=16, num_layers=2, loss_mode="all", seed=0),
               dcfg=dict(batch=8, seq=8, train_percent=1.0),
               tcfg=dict(lr=0.1, superstep=3, eval_every_s=1e9, clip_norm=0.1,
                         pp_chunks=2))
# tests/test_pp.py:123-150's checkpoint round trip
PP_CKPT = dict(cfg=dict(vocab=32, hidden=16, num_layers=2, loss_mode="all",
                        seed=0),
               dcfg=dict(batch=4, seq=8, train_percent=1.0),
               tcfg=dict(lr=0.1, superstep=2, eval_every_s=1e9, pp_chunks=4))


def corpus(vocab: int, n: int = 20000) -> np.ndarray:
    if vocab == 32:
        # tests/test_pp.py's corpus
        return np.tile(np.arange(31, dtype=np.uint8), 100)[:n]
    period = 17 if vocab == 256 else 31
    base = np.arange(period, dtype=np.uint8) + (65 if vocab == 256 else 60)
    return np.tile(base, n // period + 1)[:n]


def state_arrays(cfg_kw, batch, length, seed, nan_stream=None):
    """A seeded canonical state as a run holds it midway: params (the
    checkpoint's keys), accumulators away from zero (at m = 0 the first
    Adagrad step is lr * sign(g), whose sign on the smallest gradients
    flips with the order of a sum), stream state and cursors inside the
    corpus."""
    cfg = ModelConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    arrs = {}
    for key, shape in tckpt._expected_shapes(cfg).items():
        arrs[key] = (rng.normal(size=shape) * 0.1).astype(np.float32)
        arrs["opt" + key[len("params"):]] = rng.uniform(
            0.01, 0.1, size=shape).astype(np.float32)
    shape = (cfg.num_layers, batch, cfg.hidden)
    arrs["h"] = (rng.normal(size=shape) * 0.1).astype(np.float32)
    arrs["c"] = (rng.normal(size=shape) * 0.1).astype(np.float32)
    if nan_stream is not None:
        arrs["h"][0, nan_stream, 0] = np.nan
    arrs["positions"] = rng.integers(0, length - cfg_kw.get("seq", 8) - 9,
                                     batch).astype(np.int32)
    return arrs


def write_ckpt(path, arrs, cfg_kw):
    cfg = ModelConfig(**cfg_kw)
    params = tckpt.params_from_numpy(arrs, cfg, "cpu")
    m = tckpt.params_from_numpy({"params" + k[len("opt"):]: v for k, v in
                                 arrs.items() if k.startswith("opt")}, cfg, "cpu")
    tckpt.save_checkpoint(path, params, m, 0,
                          positions=arrs["positions"],
                          stream_h=torch.from_numpy(arrs["h"]).to(cfg.pdtype),
                          stream_c=torch.from_numpy(arrs["c"]).to(cfg.pdtype),
                          rng_key=np.array([0, 7], np.uint32),
                          meta={"hidden": cfg.hidden,
                                "num_layers": cfg.num_layers})


def case_state(key):
    """(base config, corpus, state arrays) of a training case."""
    base, length, nan = {
        "dp": (DP, 20000, None), "dptp": (DP_TP, 15500, None),
        "drop": (DROP, 20000, None), "skip": (DROP, 20000, NAN_STREAM),
        "wrap": (WRAP, WRAP_LEN, None), "dpsp": (SP_MESH, 20000, None),
        "tpsp": (SP_MESH, 20000, None), "sptraj": (SP_TRAJ, SP_TRAJ_LEN, None),
        "pptrain": (PP_TRAIN, 3100, None), "dppp": (PP_MESH, 20000, None),
        "ppckpt": (PP_CKPT, 3100, None),
    }[key.split("_")[0]]
    if key.startswith("skip"):
        base = dict(base, cfg=dict(base["cfg"], dropout=0.0))
    if key.startswith("pptrain"):
        _, layers, _, mode = key.split("_")
        base = dict(base, cfg=dict(base["cfg"], num_layers=int(layers),
                                   loss_mode=mode))
    data = corpus(base["cfg"].get("vocab", 256), length)
    seed = sum(map(ord, key.split("_")[0]))
    arrs = state_arrays(base["cfg"], base["dcfg"]["batch"], len(data), seed,
                        nan)
    if key.startswith("sptraj"):
        half = SP_TRAJ_START // 2
        arrs["positions"] = half + arrs["positions"] % half
    return base, data, arrs


def sp_inputs(key):
    """(model config, chunks, seq devices, arrays: the parameters under
    their checkpoint keys, x, t, h, c and the dropout key) of a gradient
    case ``spg_{layers}_{D}_{C}_{loss mode}[_drop]``."""
    _, layers, n_seq, n_chunks, mode, *drop = key.split("_")
    cfg = dict(vocab=SPG_VOCAB, hidden=16, num_layers=int(layers),
               loss_mode=mode, dropout=0.3 if drop else 0.0, seed=0)
    arrs = state_arrays(cfg, SPG_B, 1000, sum(map(ord, key)))
    rng = np.random.default_rng(len(key))
    for name in ("x", "t"):
        arrs[name] = rng.integers(0, SPG_VOCAB, (SPG_S, SPG_B)).astype(np.int64)
    arrs["dropout_key"] = np.array(SPG_KEY if drop else -1)
    return cfg, int(n_chunks), int(n_seq), arrs


def pp_inputs(key):
    """(model config, chunks, stages, arrays: the parameters under their
    checkpoint keys, x, t, h, c and the dropout key) of a gradient case
    ``ppg_{layers}_{S}_{C}_{loss mode}[_drop]``."""
    _, layers, n_stage, n_chunks, mode, *drop = key.split("_")
    cfg = dict(vocab=PPG_VOCAB, hidden=16, num_layers=int(layers),
               loss_mode=mode, dropout=0.3 if drop else 0.0, seed=0)
    arrs = state_arrays(cfg, PPG_B, 1000, sum(map(ord, key)))
    rng = np.random.default_rng(len(key))
    for name in ("x", "t"):
        arrs[name] = rng.integers(0, PPG_VOCAB, (PPG_S, PPG_B)).astype(np.int64)
    arrs["dropout_key"] = np.array(PPG_KEY if drop else -1)
    return cfg, int(n_chunks), int(n_stage), arrs


# key -> (world size, mesh [n_data, n_model(, n_seq(, n_stage))], kind, extra)
CASES = {
    "dp_2": (2, [2, None], "train", {}),
    "dp_4": (4, [4, None], "train", {}),
    "dptp_22": (4, [2, 2], "train", {}),
    "dptp_12": (2, [1, 2], "train", {}),
    "drop_dp2": (2, [2, None], "train", {}),
    "drop_dptp22": (4, [2, 2], "train", {}),
    "skip_dp2": (2, [2, None], "train", {}),
    "skip_dptp22": (4, [2, 2], "train", {}),
    "wrap_resident": (2, [2, None], "train", dict(supersteps=3)),
    "wrap_streamed": (2, [2, None], "train", dict(supersteps=3, streaming=True)),
    "dp_tp2gc": (2, [None, 2], "gradcheck", {}),
    "coll_22": (4, [2, 2], "collectives", {}),
    "coll_12": (2, [1, 2], "collectives", {}),
    "cli_dp2": (2, None, "cli", dict(argv=["--dp", "2"])),
    "cli_tp2": (2, None, "cli", dict(argv=["--tp", "2"])),
    "cli_dp2tp2": (4, None, "cli", dict(argv=["--dp", "2", "--tp", "2"])),
    "spg_1_2_2_all": (2, [None, None, 2], "sp_grads", {}),
    "spg_2_2_2_all": (2, [None, None, 2], "sp_grads", {}),
    "spg_1_4_2_all": (4, [None, None, 4], "sp_grads", {}),
    "spg_2_2_2_last": (2, [None, None, 2], "sp_grads", {}),
    "spg_2_2_2_all_drop": (2, [None, None, 2], "sp_grads", {}),
    "sptraj_2": (2, [None, None, 2], "train", dict(supersteps=4)),
    "dpsp_22": (4, [2, None, 2], "train", {}),
    "tpsp_22": (4, [None, 2, 2], "train", {}),
    "skip_dpsp22": (4, [2, None, 2], "train", {}),
    "cli_sp2": (2, None, "cli", dict(argv=["--sp", "2"])),
    # tests/test_pp.py:38-49's (layers, stages, chunks, loss mode)
    "ppg_2_2_4_all": (2, [None, None, None, 2], "pp_grads", {}),
    "ppg_4_4_2_all": (4, [None, None, None, 4], "pp_grads", {}),
    "ppg_8_8_4_all": (8, [None, None, None, 8], "pp_grads", {}),
    "ppg_4_2_4_all": (2, [None, None, None, 2], "pp_grads", {}),
    "ppg_8_4_2_all": (4, [None, None, None, 4], "pp_grads", {}),
    "ppg_4_4_4_last": (4, [None, None, None, 4], "pp_grads", {}),
    "ppg_4_2_2_last": (2, [None, None, None, 2], "pp_grads", {}),
    "ppg_2_2_2_all_drop": (2, [None, None, None, 2], "pp_grads", {}),
    "pptrain_2_2_all": (2, [None, None, None, 2], "train", dict(supersteps=2)),
    "pptrain_4_2_last": (2, [None, None, None, 2], "train", dict(supersteps=2)),
    "pptrain_4_4_all": (4, [None, None, None, 4], "train", dict(supersteps=2)),
    "dppp_22": (4, [2, None, None, 2], "train", {}),
    "ppckpt_2": (2, [None, None, None, 2], "pp_ckpt", {}),
    "cli_pp2": (2, None, "cli", dict(argv=["--layers", "2", "--pp", "2",
                                          "--pp-chunks", "2"])),
}


def _spec(world, work):
    spec, inputs = {}, {}
    for key, (size, mesh, kind, extra) in CASES.items():
        if size != world:
            continue
        case = {"kind": kind, "mesh": mesh}
        if kind == "cli":
            case["argv"] = CLI_ARGV + ["--ckpt-dir", str(work / key)] + extra["argv"]
        elif kind in ("sp_grads", "pp_grads"):
            cfg, case["chunks"], _, arrs = (sp_inputs if kind == "sp_grads"
                                            else pp_inputs)(key)
            case["cfg"] = cfg
            inputs.update((f"{key}/{k}", v) for k, v in arrs.items())
        elif kind == "pp_ckpt":
            base, data, _ = case_state(key)
            case.update(base, save=str(work / f"{key}_saved.npz"))
            inputs[f"{key}/data"] = data
        elif kind in ("train", "gradcheck"):
            base, data, arrs = case_state(key)
            ckpt = str(work / f"{key}.npz")
            write_ckpt(ckpt, arrs, base["cfg"])
            case.update(dict(base, ckpt=ckpt, supersteps=1), **extra)
            inputs[f"{key}/data"] = data
            if kind == "gradcheck":
                case.update(save=str(work / f"{key}_saved.npz"),
                            samples=GRADCHECK_SAMPLES)
        spec[key] = case
    return spec, inputs


def _spawn(world, work):
    spec, inputs = _spec(world, work)
    src, dst = work / f"in_{world}.npz", work / f"out_{world}.npz"
    np.savez(src, spec=np.array(json.dumps(spec)), **inputs)
    store = work / f"store_{world}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(store), str(r),
                               str(world), str(src), str(dst)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{o[-4000:]}"
    with np.load(dst) as z:
        return dict(z)


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory, worker_id):
    """dp_ranks(key): (the results of the case's world, its work directory),
    each world spawned once for the whole run (shared across xdist workers
    through a file lock)."""
    root = tmp_path_factory.getbasetemp()
    if worker_id != "master":
        root = root.parent
    work = root / "torch_dp_ranks"
    work.mkdir(exist_ok=True)
    cache = {}

    def get(key):
        world = CASES[key][0]
        if world not in cache:
            with filelock.FileLock(str(work / f"W{world}.lock")):
                done = work / f"out_{world}.npz"
                if done.exists():
                    with np.load(done) as z:
                        cache[world] = dict(z)
                else:
                    cache[world] = _spawn(world, work)
        return cache[world], work

    return get


# --- the references: the JAX package on the virtual mesh, the port on one
# device, from the case's checkpoint -------------------------------------

BITS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6


def ckpt_of(work, key):
    return str(work / f"{key}.npz")


def jax_superstep(work, key, mesh, parallel):
    """One superstep of the JAX ``Trainer`` on ``mesh`` from the case's
    checkpoint: (metrics, canonical params as numpy, positions)."""
    from eigen_lstm_tpu import DataConfig as JData
    from eigen_lstm_tpu import TrainConfig as JTrain
    from eigen_lstm_tpu.train.trainer import Trainer

    base, data, _ = case_state(key)
    tr = Trainer(JConfig(**base["cfg"]), JData(**base["dcfg"]),
                 JTrain(**base["tcfg"]), data, None, mesh=mesh,
                 parallel=parallel)
    tr.restore(ckpt_of(work, key))
    tr.state, met = tr.dispatch_superstep()
    params = [np.asarray(p) for p in
              jax.tree_util.tree_leaves(tr.canonical_params())]
    return ({k: float(v) for k, v in met.items()}, params,
            np.asarray(tr.state.positions))


def port_single(work, key, supersteps=1):
    """The port's single-device ``Trainer`` (the plain versions) from the
    case's checkpoint after ``supersteps``: (metrics, state)."""
    base, data, _ = case_state(key)
    cfg, dcfg = ModelConfig(**base["cfg"]), DataConfig(**base["dcfg"])
    tr = trainer_mod.Trainer(cfg, dcfg, TrainConfig(**base["tcfg"]), data, None,
                 cell_fn=select_cell_fn("plain", cfg, dcfg.batch, "cpu"),
                 device="cpu")
    tr.restore(ckpt_of(work, key))
    for _ in range(supersteps):
        tr.state, met = tr.dispatch_superstep()
    return {k: float(v) for k, v in met.items() if v.ndim == 0}, tr.state


def assert_params(got, key, want, err=""):
    """The case's canonical params (checkpoint order) against ``want``."""
    names = [k for k in got if k.startswith(f"{key}/params.")]
    assert len(names) == len(want)
    for name, w in zip(sorted(names, key=lambda k: _order(k)), want):
        np.testing.assert_allclose(got[name], np.asarray(w), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{err} {name}")


def _order(name):
    """Checkpoint order of a ``params.`` key."""
    tail = name.split("/params.")[1]
    if tail.startswith("layers["):
        layer, t = tail[len("layers["):].split("].")
        return (0, int(layer), "WUb".index(t))
    return (1, 0, ("Why", "by").index(tail))


def shard_reference(work, key, ndata, dkey_of, kernels=True):
    """The DP step from the case's checkpoint rebuilt from single-device
    pieces: each data shard's loss and gradients on its B/D streams under
    ``dkey_of(d)``, the skip of each shard, the mean, the shared update;
    through the kernels' plain versions (their fused masks), or with
    ``kernels=False`` the model's own loop (``_dropout``'s masks, which the
    TP families draw over the full hidden stream). Returns the state after
    the step."""
    base, data, _ = case_state(key)
    cfg, dcfg = ModelConfig(**base["cfg"]), DataConfig(**base["dcfg"])
    tcfg = TrainConfig(**base["tcfg"])
    params, m, step, ex = tckpt.load_checkpoint(ckpt_of(work, key), cfg, "cpu")
    cell_fn = (select_cell_fn("plain", cfg, dcfg.batch, "cpu") if kernels
               else None)
    corpus = torch.from_numpy(data)
    n = dcfg.batch // ndata
    grads, hs, cs, bits = [], [], [], []
    for d in range(ndata):
        sl = slice(d * n, (d + 1) * n)
        st = trainer_mod.TrainState(params, m, ex["stream_h"][:, sl],
                                    ex["stream_c"][:, sl],
                                    ex["positions"][sl], step)
        x, t = corpus_mod.make_windows(corpus, st.positions, dcfg.seq)
        loss, (h2, c2), b, g = trainer_mod.loss_and_grads(
            params, x, t, st.h, st.c, cfg, cell_fn, dkey_of(d))
        g, h2, c2 = trainer_mod.skip_nonfinite(loss, g, h2, c2, st)
        grads.append(model.tensors(g))
        hs.append(h2)
        cs.append(c2)
        bits.append(b)
    mean = model.like(params, (sum(gs) / ndata for gs in zip(*grads)))
    whole = trainer_mod.TrainState(params, m, ex["stream_h"], ex["stream_c"],
                                   ex["positions"], step)
    state, _ = trainer_mod.finish_step(whole, torch.cat(hs, 1),
                                       torch.cat(cs, 1), mean,
                                       sum(bits) / ndata, dcfg, tcfg,
                                       len(data))
    return state


def assert_state(got, key, state, err=""):
    assert_params(got, key, [p.numpy() for p in model.tensors(state.params)],
                  err)
    for name, m in state.m.named_tensors():
        np.testing.assert_allclose(got[f"{key}/m/{name}"], m.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=err)
    for k in ("h", "c"):
        np.testing.assert_allclose(got[f"{key}/{k}"], getattr(state, k).numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=err)
    np.testing.assert_array_equal(got[f"{key}/positions"],
                                  state.positions.numpy())


def max_gap(got, key, state):
    return max(float(np.abs(got[f"{key}/{name}"] - p.numpy()).max())
               for name, p in state.params.named_tensors())


def steps_of(out):
    return [float(l.split()[3]) for l in out.splitlines() if l.startswith("step ")]


def gradcheck_lines(out, n):
    lines = [l for l in out.splitlines() if l.startswith("[gradcheck]")]
    assert len(lines) == n and all(l.endswith(" ok") for l in lines), lines


def check_checkpoints(path, single_path, hidden=32, layers=1):
    """The mesh's checkpoint in both packages: the port's arrays equal the
    JAX package's, the step 4, the full batch of cursors and stream state,
    the parameters within 1e-4 of the single device's."""
    cfg = ModelConfig(hidden=hidden, num_layers=layers)
    p, m, step, ex = tckpt.load_checkpoint(str(path), cfg, "cpu")
    sp, _, _, _ = tckpt.load_checkpoint(str(single_path), cfg, "cpu")
    assert step == 4 and ex["positions"].shape == (8,)
    assert tuple(ex["stream_h"].shape) == (layers, 8, hidden)
    for (name, a), b in zip(p.named_tensors(), model.tensors(sp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    like = jmodel.init_params(JConfig(hidden=hidden, num_layers=layers))
    jp, jm, jstep, jex = jckpt.load_checkpoint(str(path), like,
                                               jopt.adagrad_init(like))
    assert jstep == 4
    for a, b in zip(jax.tree_util.tree_leaves((jp, jm)),
                    model.tensors(p) + model.tensors(m)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jex["positions"]),
                                  ex["positions"].numpy())
