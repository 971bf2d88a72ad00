"""Tensor parallelism of the port (``parallel/mesh.py``, ``parallel/tp.py``,
the TP trainer and CLI) against the JAX package's TP on the 8-device
virtual CPU mesh and against the port's single-device model.

The port runs one process a rank: each D in (1, 2, 4) spawns D processes
of ``tests/torch_tp_worker.py`` once, meeting over gloo through a
FileStore, which run every case of that D on their shards through the
plain versions (CPU tensors) and hand back the loss, the gathered state
and the gradients in the canonical layout. The JAX side runs here, under
the checked harness (``check_vma=True``), where the gradients are the
single-device ones: the JAX ``"pallas_seq"`` family needs the unchecked
harness, which scales every gradient by D (``tests/test_tp_seq.py:43-65``),
so the port's ``"pallas_seq"`` is held to the JAX ``"xla"`` TP backend.
Tolerances are ``tests/test_tp.py``'s: loss rtol 1e-5, gradients rtol 1e-4
and atol 1e-6 (fp32).
"""

import json
import os
import subprocess
import sys

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops import pallas_tp_cell as jtp_cell
from eigen_lstm_tpu.ops import pallas_tp_seq as jtp_seq
from eigen_lstm_tpu.parallel import mesh as jmesh
from eigen_lstm_tpu.parallel import tp as jtp
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import optimizer as jopt
from eigen_lstm_tpu.train.trainer import _select_tp_backend as jselect

from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch import cli as tcli
from eigen_lstm_tpu_torch.config import DataConfig as TData
from eigen_lstm_tpu_torch.config import TrainConfig as TTrain
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import cuda_tp_cell, cuda_tp_seq
from eigen_lstm_tpu_torch.ops.dispatch import select_tp_backend
from eigen_lstm_tpu_torch.parallel import tp as ttp
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train.trainer import Trainer as TTrainer
from eigen_lstm_tpu_torch.train.trainer import loss_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_worker.py")
ALICE = os.path.join(ROOT, "data", "alice29.txt")
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
RANKS_TIMEOUT_S = 600
S, B, N, M = 6, 4, 16, 32
FAMILIES = ("xla", "pallas", "pallas_seq")
# (layers, loss mode, tied, cell variant, dropout): every family at every
# D runs each; dropout is held to the port's single-device loop only (the
# JAX package's RBG mask bits cannot be drawn in torch)
KINDS = {
    "l1_all": (1, "all", False, "reference", 0.0),
    "l2_last": (2, "last", False, "reference", 0.0),
    "l1_tied_std": (1, "all", True, "standard", 0.0),
    "l2_drop": (2, "all", False, "reference", 0.3),
}
DROP_KEY = 77


def _cfg_kw(kind):
    layers, mode, tied, variant, drop = KINDS[kind]
    return dict(vocab=M, hidden=N, num_layers=layers, loss_mode=mode,
                tie_embeddings=tied, cell_variant=variant, dropout=drop)


def _arrays(kind):
    """Seeded canonical params, windows and state of a case."""
    kw = _cfg_kw(kind)
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    arrs = {}
    for l in range(kw["num_layers"]):
        in_dim = N if (l == 0 and kw["tie_embeddings"]) or l > 0 else M
        arrs[f"params.layers[{l}].W"] = rng.normal(size=(in_dim, 4 * N)) * 0.3
        arrs[f"params.layers[{l}].U"] = rng.normal(size=(N, 4 * N)) * 0.3
        arrs[f"params.layers[{l}].b"] = rng.normal(size=(4 * N,)) * 0.1
    arrs["params.Why"] = rng.normal(size=(N, M)) * 0.3
    arrs["params.by"] = rng.normal(size=(M,)) * 0.1
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    arrs["ids"] = rng.integers(0, M, (S, B)).astype(np.int32)
    arrs["targets"] = rng.integers(0, M, (S, B)).astype(np.int32)
    for k in ("h0", "c0"):
        arrs[k] = (rng.normal(size=(kw["num_layers"], B, N)) * 0.3).astype(np.float32)
    return arrs


def _torch_params(arrs, cfg):
    return tmodel.like(tmodel.init_params(cfg, device="cpu"),
                       (torch.from_numpy(arrs[k]) for k, _ in
                        tmodel.init_params(cfg, device="cpu").named_tensors()))


def _jax_params(arrs, cfg):
    layers = tuple(jmodel.LayerParams(*(jnp.asarray(arrs[f"params.layers[{l}].{n}"])
                                        for n in "WUb"))
                   for l in range(cfg.num_layers))
    return jmodel.LSTMParams(layers, jnp.asarray(arrs["params.Why"]),
                             jnp.asarray(arrs["params.by"]))


SUPERSTEP = dict(cfg=dict(vocab=32, hidden=16, num_layers=1, loss_mode="all",
                          seed=0),
                 dcfg=dict(batch=4, seq=8, train_percent=1.0),
                 tcfg=dict(lr=0.1, superstep=3, eval_every_s=1e9,
                           clip_norm=0.1))


def _superstep_data():
    # tests/test_tp.py's periodic corpus, with bytes inside the vocabulary
    return np.tile(np.arange(31, dtype=np.uint8), 500)


def _spawn(ndev, work):
    """Runs the D ranks on the cases of ``KINDS`` x ``FAMILIES`` (and the
    superstep at D = 2); returns rank 0's results."""
    spec = {"loss": {}}
    inputs = {}
    for kind in KINDS:
        arrs = _arrays(kind)
        for fam in FAMILIES:
            key = f"{kind}-{fam}"
            spec["loss"][key] = {"cfg": _cfg_kw(kind), "family": fam,
                                 "dropout_key": DROP_KEY if KINDS[kind][4] else None}
            inputs.update({f"{key}/{k}": v for k, v in arrs.items()})
    if ndev == 2:
        spec["superstep"] = SUPERSTEP
        inputs["superstep/data"] = _superstep_data()
    src, dst = work / f"in_{ndev}.npz", work / f"out_{ndev}.npz"
    np.savez(src, spec=np.array(json.dumps(spec)), **inputs)
    store = work / f"store_{ndev}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(store), str(r),
                               str(ndev), str(src), str(dst)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(ndev)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {ndev} failed:\n{o[-4000:]}"
    with np.load(dst) as z:
        return dict(z)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, worker_id):
    """ranks(D): the results of D ranks, computed once for the whole run
    (shared across xdist workers through a file lock)."""
    root = tmp_path_factory.getbasetemp()
    if worker_id != "master":
        root = root.parent
    cache = {}

    def get(ndev):
        if ndev not in cache:
            work = root / "torch_tp_ranks"
            work.mkdir(exist_ok=True)
            with filelock.FileLock(str(work / f"D{ndev}.lock")):
                done = work / f"out_{ndev}.npz"
                if done.exists():
                    with np.load(done) as z:
                        cache[ndev] = dict(z)
                else:
                    cache[ndev] = _spawn(ndev, work)
        return cache[ndev]

    return get


def test_gate_permutation_and_round_trip_equal_jax():
    """``_gate_permutation``, and permute / unpermute on the same arrays,
    bit for bit the JAX functions'."""
    for n, d in ((16, 1), (16, 2), (16, 4), (1024, 4), (512, 8)):
        np.testing.assert_array_equal(ttp._gate_permutation(n, d),
                                      jtp._gate_permutation(n, d))
    arrs = _arrays("l2_last")
    tcfg, jcfg = TConfig(**_cfg_kw("l2_last")), JConfig(**_cfg_kw("l2_last"))
    tp_, jp = _torch_params(arrs, tcfg), _jax_params(arrs, jcfg)
    for d in (1, 2, 4):
        tperm, jperm = ttp.permute_params_for_tp(tp_, d), jtp.permute_params_for_tp(jp, d)
        for a, b in zip(tmodel.tensors(tperm), jax.tree_util.tree_leaves(jperm)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        back = ttp.unpermute_params_from_tp(tperm, d)
        jback = jtp.unpermute_params_from_tp(jperm, d)
        for a, b, c in zip(tmodel.tensors(back), jax.tree_util.tree_leaves(jback),
                           tmodel.tensors(tp_)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        ttp.permute_params_for_tp(tp_, 3)
    mask = tmodel.tensors(ttp.tp_replicated_mask(tcfg))
    jmask = jax.tree_util.tree_leaves(jtp.tp_replicated_mask(jcfg))
    assert mask == list(jmask) == [False] * 7 + [True]


def _jax_tp(kind, family, ndev):
    """The JAX TP loss and canonical gradients (checked harness)."""
    arrs = _arrays(kind)
    cfg = JConfig(**_cfg_kw(kind))
    params = _jax_params(arrs, cfg)
    mesh = jmesh.make_mesh(ndev, axis="model")
    fn = jtp.make_tp_loss_and_grad(
        cfg, mesh, backend="pallas" if family == "pallas" else "xla")
    loss, bits, grads = fn(
        jtp.shard_tp_params(jtp.permute_params_for_tp(params, ndev), mesh),
        *(jnp.asarray(arrs[k]) for k in ("ids", "targets", "h0", "c0")))
    grads = jtp.unpermute_params_from_tp(jax.device_get(grads), ndev)
    names = [k for k, _ in tmodel.init_params(TConfig(**_cfg_kw(kind)),
                                              device="cpu").named_tensors()]
    return float(loss), float(bits), dict(zip(
        names, (np.asarray(g) for g in jax.tree_util.tree_leaves(grads))))


def _port_single(kind):
    """The port's single-device loss_fn (its own loop): loss, bits, state,
    gradients."""
    arrs = _arrays(kind)
    cfg = TConfig(**_cfg_kw(kind))
    loss, (h, c), bits, grads = loss_and_grads(
        _torch_params(arrs, cfg), torch.from_numpy(arrs["ids"]),
        torch.from_numpy(arrs["targets"]), torch.from_numpy(arrs["h0"]),
        torch.from_numpy(arrs["c0"]), cfg, None,
        DROP_KEY if KINDS[kind][4] else None)
    return (float(loss), float(bits), h.numpy(), c.numpy(),
            {k: g.numpy() for k, g in grads.named_tensors()})


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_tp_loss_and_grads_match_jax_and_single_device(ranks, kind, family, ndev):
    """``tp_loss_and_grads`` over D gloo ranks, each family through its
    plain versions: the loss, the gathered state and every gradient
    against the port's single-device ``loss_fn``, and, without dropout,
    against the JAX TP path on D virtual devices."""
    got = ranks(ndev)
    key = f"{kind}-{family}"
    grads = {k.split("/grad/")[1]: v for k, v in got.items()
             if k.startswith(f"{key}/grad/")}
    loss, bits, h, c, ref = _port_single(kind)
    np.testing.assert_allclose(got[f"{key}/loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[f"{key}/bits"], bits, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[f"{key}/h"], h, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(got[f"{key}/c"], c, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert sorted(grads) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(grads[name], ref[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{key} D={ndev} {name}")
    if KINDS[kind][4]:
        return
    jloss, jbits, jgrads = _jax_tp(kind, family, ndev)
    np.testing.assert_allclose(got[f"{key}/loss"], jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[f"{key}/bits"], jbits, rtol=LOSS_RTOL)
    for name in ref:
        np.testing.assert_allclose(grads[name], jgrads[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{key} D={ndev} {name}")


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_psum_backward_is_the_identity(ranks, ndev):
    """d/dx sum(w * psum(x)) is w on every rank: a psum whose backward
    all-reduced again (``torch.distributed.nn.functional.all_reduce``)
    would give D * w, which only D > 1 shows."""
    got = ranks(ndev)
    w = np.arange(6, dtype=np.float32).reshape(2, 3) + 1.0
    np.testing.assert_array_equal(got["psum/y"],
                                  np.full((2, 3), ndev * (ndev + 1) / 2))
    np.testing.assert_array_equal(got["psum/grad"], np.tile(w, (ndev, 1)))


def test_tp_superstep_matches_single_device_training(ranks):
    """A 3-step superstep of the TP Trainer on 2 gloo ranks (clip-norm 0.1,
    so the global norm moves the update) against the single-device
    Trainer: bits and the global norm, with by's squared sum counted once,
    rtol 1e-5; every parameter after the three updates rtol 1e-4 / atol
    1e-6 (``tests/test_tp.py:114``'s)."""
    got = ranks(2)
    cfg = TConfig(**SUPERSTEP["cfg"])
    tr = TTrainer(cfg, TData(**SUPERSTEP["dcfg"]), TTrain(**SUPERSTEP["tcfg"]),
                  _superstep_data(), None, device="cpu")
    tr.state, met = tr.dispatch_superstep()
    for k in ("bits_mean", "gnorm_mean", "gnorm_max"):
        np.testing.assert_allclose(got[f"superstep/{k}"], float(met[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for name, p in tr.state.params.named_tensors():
        np.testing.assert_allclose(got[f"superstep/{name}"], p.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    np.testing.assert_array_equal(got["superstep/positions"],
                                  tr.state.positions.numpy())
    # the clip is active, so the norm moves the parameters too
    assert float(met["gnorm_max"]) > SUPERSTEP["tcfg"]["clip_norm"]


@pytest.mark.parametrize("tp_seq_env", [None, "0"])
def test_family_ladder_matches_jax(monkeypatch, tp_seq_env):
    """``select_tp_backend`` and both gates against the JAX
    ``_select_tp_backend`` at the bench's shapes (1x512, B = 128, bf16),
    the flagship's (3x1024, B = 128, bf16) and a grid, D = 1, 2, 4, with a
    cell_fn and without, with EIGEN_LSTM_TP_SEQ unset and 0; on a CUDA
    device the JAX "xla" family with a cell_fn is the per-step kernels."""
    if tp_seq_env is None:
        monkeypatch.delenv("EIGEN_LSTM_TP_SEQ", raising=False)
    else:
        monkeypatch.setenv("EIGEN_LSTM_TP_SEQ", tp_seq_env)
    configs = [(dict(hidden=512, compute_dtype="bfloat16"), 128),
               (dict(hidden=1024, num_layers=3, compute_dtype="bfloat16"), 128)]
    configs += [(dict(hidden=n, vocab=v, compute_dtype=dt, residual_dtype=rd), b)
                for n in (256, 1024, 2048) for v in (100, 256)
                for dt in ("float32", "bfloat16") for rd in ("float32", "bfloat16")
                for b in (12, 64, 256)]
    seen = set()
    for kw, batch in configs:
        t, j = TConfig(**kw), JConfig(**kw)
        for ndev in (1, 2, 4):
            assert (cuda_tp_seq.tp_seq_supported(t, batch, ndev)
                    == jtp_seq.tp_seq_supported(j, batch, ndev))
            assert (cuda_tp_cell.tp_pallas_supported(t, batch, ndev)
                    == jtp_cell.tp_pallas_supported(j, batch, ndev))
            for cell_fn in (object(), None):
                want = jselect(j, batch, ndev, cell_fn)
                got = select_tp_backend(t, batch, ndev, cell_fn, "cpu")
                assert got == want, (kw, batch, ndev)
                seen.add(got)
                # a stand-in CUDA device: the JAX XLA TP scan becomes the
                # per-step kernels wherever there is a cell_fn
                on_card = select_tp_backend(t, batch, ndev, cell_fn,
                                            torch.device("cuda"))
                if cell_fn is not None and want == "xla":
                    want = "pallas"
                assert on_card == want, (kw, batch, ndev)
    bench = TConfig(hidden=512, compute_dtype="bfloat16")
    flag = TConfig(hidden=1024, num_layers=3, compute_dtype="bfloat16")
    want_bench = "pallas" if tp_seq_env == "0" else "pallas_seq"
    for device in ("cpu", "cuda"):
        assert select_tp_backend(bench, 128, 1, object(), device) == want_bench
        assert select_tp_backend(flag, 128, 1, object(), device) == "pallas"
    assert seen == {"xla", "pallas", "pallas_seq"} - ({"pallas_seq"} if tp_seq_env else set())


TP_ARGV = ["train", "--data", ALICE, "--hidden", "128", "--batch", "8",
           "--seq", "8", "--steps", "4", "--superstep", "2", "--log-every", "2",
           "--sample-chars", "20", "--eval-chars", "500", "--device", "cpu",
           "--lr", "0.05"]


@pytest.mark.parametrize("tp_seq_env", [None, "0"])
def test_cli_train_tp1_checkpoint_loads_in_both_packages(tmp_path, capsys,
                                                         monkeypatch, tp_seq_env):
    """``cli train --tp 1 --device cpu`` (the pallas_seq family, then the
    per-step one with EIGEN_LSTM_TP_SEQ=0, through their plain versions)
    prints the TP line and trains as the single-device CLI does (bits
    within rel 1e-5); its checkpoint holds canonical params that load in
    the port and in the JAX package, equal to the single-device run's
    within 1e-4; ``--resume`` of it trains on under TP."""
    if tp_seq_env is None:
        monkeypatch.delenv("EIGEN_LSTM_TP_SEQ", raising=False)
    else:
        monkeypatch.setenv("EIGEN_LSTM_TP_SEQ", tp_seq_env)
    runs = {}
    for label, extra in (("tp", ["--tp", "1"]), ("single", [])):
        d = tmp_path / label
        tcli.main(TP_ARGV + ["--ckpt-dir", str(d)] + extra)
        out = capsys.readouterr().out
        bits = [float(l.split()[3]) for l in out.splitlines() if l.startswith("step ")]
        runs[label] = (out, bits, d / "ckpt.npz")
    assert "tensor-parallel over 1 devices" in runs["tp"][0]
    assert "tensor-parallel" not in runs["single"][0]
    np.testing.assert_allclose(runs["tp"][1], runs["single"][1], rtol=1e-5)
    cfg = TConfig(hidden=128)
    tp_p, tp_m, step, _ = tckpt.load_checkpoint(str(runs["tp"][2]), cfg, "cpu")
    sd_p, _, _, _ = tckpt.load_checkpoint(str(runs["single"][2]), cfg, "cpu")
    assert step == 4
    for (name, a), b in zip(tp_p.named_tensors(), tmodel.tensors(sd_p)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    like = jmodel.init_params(JConfig(hidden=128))
    jp, jm, jstep, _ = jckpt.load_checkpoint(str(runs["tp"][2]), like,
                                             jopt.adagrad_init(like))
    assert jstep == 4
    for a, b in zip(jax.tree_util.tree_leaves((jp, jm)),
                    tmodel.tensors(tp_p) + tmodel.tensors(tp_m)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    tcli.main(TP_ARGV + ["--tp", "1", "--resume", str(runs["tp"][2]),
                         "--steps", "2", "--sample-chars", "0"])
    assert "resumed from" in capsys.readouterr().out


def test_cli_refuses_what_tp_does_not_run(capsys):
    """``--tp 2`` in one process, ``--tp`` beside ``--pp`` (the JAX
    combination rule), ``--dp 2 --tp 1`` and ``--sp 2 --tp 1`` in one
    process, ``--crosscheck`` under ``--tp`` (one device only) and ``bench
    --tp`` raise SystemExit with the reason, and ``--dp 2``, ``--sp 2``
    and ``--pp 2`` in one process name the launcher alike; the trainer
    refuses a mesh of another type."""
    with pytest.raises(SystemExit, match="--tp 2: the model axis is one process"):
        tcli.main(TP_ARGV + ["--tp", "2"])
    for flag, msg in (("--dp", "--dp 2 --tp 1: the mesh is one process"),
                      ("--sp", "--sp 2 --tp 1: the mesh is one process"),
                      ("--pp", "--pp combines only with --dp")):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(TP_ARGV + ["--tp", "1", flag, "2"])
    with pytest.raises(SystemExit,
                       match="--crosscheck with --dp, --tp, --sp or --pp"):
        tcli.main(TP_ARGV + ["--tp", "1", "--crosscheck", "1"])
    with pytest.raises(SystemExit, match="bench over several devices"):
        tcli.main(["bench", "--data", ALICE, "--tp", "1", "--device", "cpu"])
    for flag, msg in (("--dp", "--dp 2: the mesh is one process"),
                      ("--sp", "--sp 2: the mesh is one process"),
                      ("--pp", "--pp 2: the mesh is one process")):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(TP_ARGV + [flag, "2"])
    with pytest.raises(NotImplementedError, match="mesh training over a object"):
        TTrainer(TConfig(hidden=32), TData(batch=4, seq=8), TTrain(),
                 _superstep_data(), mesh=object(), device="cpu")
