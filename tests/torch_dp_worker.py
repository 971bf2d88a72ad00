"""One rank of the port's data parallelism, sequence pipelining and
pipeline parallelism on the CPU, for tests/test_torch_dp.py,
tests/test_torch_dp_tp.py, tests/test_torch_sp.py and
tests/test_torch_pp.py: ``python
tests/torch_dp_worker.py STORE RANK SIZE IN.npz OUT.npz``. The SIZE ranks
meet over gloo through the FileStore at STORE and run every case of IN.npz
(a JSON ``spec`` and its numpy inputs), each on the mesh the case names;
rank 0 writes the results, in the canonical layout, to OUT.npz. Imports
torch and the port only."""

import contextlib
import io
import json
import sys

import numpy as np
import torch

from eigen_lstm_tpu_torch import ModelConfig, cli
from eigen_lstm_tpu_torch.config import DataConfig, MeshConfig, TrainConfig
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
from eigen_lstm_tpu_torch.parallel import mesh as mesh_mod
from eigen_lstm_tpu_torch.parallel import pp as pp_mod
from eigen_lstm_tpu_torch.parallel import sp as sp_mod
from eigen_lstm_tpu_torch.train import checkpoint as ckpt_mod
from eigen_lstm_tpu_torch.train.trainer import Trainer


def make_mesh(case, world):
    """The case's mesh: [n_data, n_model(, n_seq(, n_stage))] a ProcessMesh
    (n_model None: data parallelism alone), [None, n] the model axis alone
    over the run, [None, None, n] the seq axis alone, [None, None, None, n]
    the stage axis alone."""
    n_data, n_model, *rest = case["mesh"]
    n_seq, n_stage = (rest + [None, None])[:2]
    if n_data is None and n_seq is None and n_stage is None:
        return mesh_mod.AxisGroup(world.rank, world.size, world.device)
    return mesh_mod.init_mesh(MeshConfig(num_devices=n_data,
                                         model_devices=n_model,
                                         seq_devices=n_seq,
                                         stage_devices=n_stage), "cpu")


def trainer_of(z, key, case, mesh):
    cfg = ModelConfig(**case["cfg"])
    dcfg, tcfg = DataConfig(**case["dcfg"]), TrainConfig(**case["tcfg"])
    tr = Trainer(cfg, dcfg, tcfg, z[f"{key}/data"], None,
                 cell_fn=select_cell_fn("plain", cfg, dcfg.batch, "cpu"),
                 mesh=mesh, streaming=case.get("streaming", False),
                 device="cpu")
    tr.restore(case["ckpt"])
    return tr


def put_state(out, key, st):
    out[f"{key}/positions"] = st.positions.numpy()
    out[f"{key}/h"] = st.h.numpy()
    out[f"{key}/c"] = st.c.numpy()
    for name, p in st.params.named_tensors():
        out[f"{key}/{name}"] = p.numpy()
    for name, p in st.m.named_tensors():
        out[f"{key}/m/{name}"] = p.numpy()


def train_case(z, key, case, mesh, out):
    """``supersteps`` supersteps from the case's checkpoint: each one's
    metrics, then the canonical state (of more than one, also after the
    first under ``{key}/first``)."""
    tr = trainer_of(z, key, case, mesh)
    for k in range(case["supersteps"]):
        tr.state, met = tr.dispatch_superstep()
        for name in ("bits_mean", "gnorm_mean", "gnorm_max"):
            out[f"{key}/{k}/{name}"] = met[name].numpy()
        if k == 0 and case["supersteps"] > 1:
            put_state(out, f"{key}/first", tr.canonical_state())
    out[f"{key}/backend"] = np.array(tr.tp.backend if tr.tp else "")
    put_state(out, key, tr.canonical_state())


def gradcheck_case(z, key, case, mesh, out):
    """One superstep, the checkpoint of the canonical state (rank 0 writes
    it), then ``Trainer.gradcheck`` there on every rank: its result and
    rank 0's printed lines."""
    tr = trainer_of(z, key, case, mesh)
    tr.state, _ = tr.dispatch_superstep()
    tr.save(case["save"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = tr.gradcheck(samples_per_tensor=case["samples"])
    out[f"{key}/ok"] = np.array(ok)
    out[f"{key}/failures"] = np.array(tr.gradcheck_failures)
    out[f"{key}/stdout"] = np.array(buf.getvalue())


def sp_grads_case(z, key, case, mesh, out):
    """``sp_loss_and_grads`` on the case's window over the seq axis, through
    the plain versions: the loss, the bits, (hT, cT) and every gradient."""
    cfg = ModelConfig(**case["cfg"])
    arr = lambda name: z[f"{key}/{name}"]
    params = ckpt_mod.params_from_numpy(
        {k: arr(k) for k in ckpt_mod._expected_shapes(cfg)}, cfg, "cpu")
    x, t, h, c = (torch.from_numpy(arr(k)) for k in ("x", "t", "h", "c"))
    dkey = int(arr("dropout_key"))
    loss, (hT, cT), bits, grads = sp_mod.sp_loss_and_grads(
        params, x, t, h, c, cfg, case["chunks"], mesh.seq,
        select_cell_fn("plain", cfg, x.shape[1], "cpu"),
        dropout_key=None if dkey < 0 else dkey)
    for name, v in (("loss", loss), ("bits", bits), ("hT", hT), ("cT", cT)):
        out[f"{key}/{name}"] = v.numpy()
    for name, g in grads.named_tensors():
        out[f"{key}/grad/{name}"] = g.numpy()
    out[f"{key}/n_params"] = np.array(len(model.tensors(grads)))


def pp_grads_case(z, key, case, mesh, out):
    """``pp_loss_and_grads`` on the case's window over the stage axis: the
    loss, the bits, and the stages' (hT, cT) and gradients gathered in
    the stage-stacked layout."""
    cfg = ModelConfig(**case["cfg"])
    arr = lambda name: z[f"{key}/{name}"]
    params = ckpt_mod.params_from_numpy(
        {k: arr(k) for k in ckpt_mod._expected_shapes(cfg)}, cfg, "cpu")
    x, t, h, c = (torch.from_numpy(arr(k)) for k in ("x", "t", "h", "c"))
    stage = mesh.stage
    lps = cfg.num_layers // stage.size
    own = slice(stage.rank * lps, (stage.rank + 1) * lps)
    dkey = int(arr("dropout_key"))
    loss, (hT, cT), bits, grads = pp_mod.pp_loss_and_grads(
        pp_mod.shard_params(pp_mod.pp_params_from(params, cfg), stage), x, t,
        h[own], c[own], cfg, case["chunks"], stage,
        dropout_key=None if dkey < 0 else dkey)
    grads = pp_mod.gather_params(grads, stage)
    for name, v in (("loss", loss), ("bits", bits),
                    ("hT", mesh_mod.all_gather(hT, 0, stage)),
                    ("cT", mesh_mod.all_gather(cT, 0, stage))):
        out[f"{key}/{name}"] = v.numpy()
    for name, g in grads.named_tensors():
        out[f"{key}/grad/{name}"] = g.numpy()


def pp_ckpt_case(z, key, case, mesh, out):
    """A stage-mesh Trainer from its own init: one superstep, its
    checkpoint, a second Trainer on the mesh restored from it; both
    canonical states, then one more superstep of each and its bits."""
    trainers = []
    for _ in range(2):
        cfg = ModelConfig(**case["cfg"])
        trainers.append(Trainer(cfg, DataConfig(**case["dcfg"]),
                                TrainConfig(**case["tcfg"]), z[f"{key}/data"],
                                None, mesh=mesh, device="cpu"))
    a, b = trainers
    a.state, _ = a.dispatch_superstep()
    a.save(case["save"])
    torch.distributed.barrier()   # rank 0 has written the file
    b.restore(case["save"])
    out[f"{key}/steps"] = np.array([a.step, b.step])
    for name, tr in (("a", a), ("b", b)):
        put_state(out, f"{key}/{name}", tr.canonical_state())
        tr.state, met = tr.dispatch_superstep()
        out[f"{key}/{name}/bits_mean"] = met["bits_mean"].numpy()


def collectives_case(key, mesh, world, out):
    """Each collective of each axis on tensors that carry the global rank,
    every rank's results gathered: a collective that ran on the default
    group would sum or gather every rank of the run."""
    x = torch.full((2, 4), float(mesh.rank))
    for axis_name in ("data", "model"):
        axis = getattr(mesh, axis_name)
        for name, v in (("gather", mesh_mod.all_gather(x, 0, axis)),
                        ("sum", mesh_mod.all_reduce(x, axis)),
                        ("scatter", mesh_mod.reduce_scatter(x, 1, axis))):
            out[f"{key}/{axis_name}/{name}"] = mesh_mod.all_gather(
                v[None], 0, world).numpy()


def cli_case(key, case, out):
    """``cli.main(argv)`` on every rank; rank 0's standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(case["argv"])
    out[f"{key}/stdout"] = np.array(buf.getvalue())


def main():
    store, rank, size, src, dst = sys.argv[1:]
    world = mesh_mod.init_tp_group(int(size), "cpu", store_path=store,
                                   rank=int(rank))
    try:
        with np.load(src) as z:
            z = dict(z)
        spec = json.loads(str(z["spec"]))
        out = {}
        for key, case in spec.items():
            kind = case["kind"]
            if kind == "cli":
                cli_case(key, case, out)
                continue
            mesh = make_mesh(case, world)
            if kind == "train":
                train_case(z, key, case, mesh, out)
            elif kind == "gradcheck":
                gradcheck_case(z, key, case, mesh, out)
            elif kind == "collectives":
                collectives_case(key, mesh, world, out)
            elif kind == "sp_grads":
                sp_grads_case(z, key, case, mesh, out)
            elif kind == "pp_grads":
                pp_grads_case(z, key, case, mesh, out)
            elif kind == "pp_ckpt":
                pp_ckpt_case(z, key, case, mesh, out)
        if world.rank == 0:
            np.savez(dst, **out)
    finally:
        world.close()


if __name__ == "__main__":
    main()
