"""One rank of the port's tensor parallelism on the CPU, for
tests/test_torch_tp.py: ``python tests/torch_tp_worker.py STORE RANK SIZE
IN.npz OUT.npz``. The D ranks meet over gloo through the FileStore at
STORE. IN.npz holds a JSON ``spec`` (the cases) and their numpy inputs;
rank 0 writes every result, gathered into the canonical layout, to
OUT.npz. Imports torch and the port only."""

import json
import sys

import numpy as np
import torch

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.config import DataConfig, TrainConfig
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn
from eigen_lstm_tpu_torch.parallel import mesh
from eigen_lstm_tpu_torch.parallel import tp as tp_mod
from eigen_lstm_tpu_torch.train.trainer import Trainer


def params_from(z, prefix, cfg):
    return model.like(
        model.init_params(cfg, device="cpu"),
        (torch.from_numpy(z[f"{prefix}/{name}"]) for name, _ in
         model.init_params(cfg, device="cpu").named_tensors()))


def loss_case(z, key, case, group, out):
    """tp_loss_and_grads of one case on this rank's shards."""
    cfg = ModelConfig(**case["cfg"])
    params = params_from(z, key, cfg)
    shard = tp_mod.shard_params(params, cfg, group.rank, group.size)
    nd = cfg.hidden // group.size
    cut = lambda a: torch.from_numpy(a)[..., group.rank * nd:(group.rank + 1) * nd]
    ids, tg = (torch.from_numpy(z[f"{key}/{k}"]) for k in ("ids", "targets"))
    loss, (h, c), bits, grads = tp_mod.tp_loss_and_grads(
        shard, ids, tg, cut(z[f"{key}/h0"]), cut(z[f"{key}/c0"]), cfg, group,
        case["family"], case.get("dropout_key"))
    full = tp_mod.unshard_params(grads, cfg, group)
    out[f"{key}/loss"] = loss.numpy()
    out[f"{key}/bits"] = bits.numpy()
    out[f"{key}/h"] = mesh.all_gather(h, 2, group).numpy()
    out[f"{key}/c"] = mesh.all_gather(c, 2, group).numpy()
    for name, g in full.named_tensors():
        out[f"{key}/grad/{name}"] = g.numpy()


def psum_case(group, out):
    """d/dx of sum(w * psum(x)): w on every rank when the psum's backward is
    the identity, D * w when it all-reduces again."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 1.0
    x = (torch.ones(2, 3) * (group.rank + 1)).requires_grad_()
    y = tp_mod.psum(x, group)
    (gx,) = torch.autograd.grad((w * y).sum(), x)
    out["psum/y"] = y.detach().numpy()
    out["psum/grad"] = mesh.all_gather(gx, 0, group).numpy()


def superstep_case(z, case, group, out):
    """One superstep of the TP Trainer, canonical state and metrics out."""
    cfg = ModelConfig(**case["cfg"])
    dcfg, tcfg = DataConfig(**case["dcfg"]), TrainConfig(**case["tcfg"])
    tr = Trainer(cfg, dcfg, tcfg, z["superstep/data"], None,
                 cell_fn=select_cell_fn("plain", cfg, dcfg.batch, "cpu"),
                 mesh=group, device="cpu")
    tr.state, met = tr.dispatch_superstep()
    st = tr.canonical_state()
    out["superstep/backend"] = np.array(tr.tp.backend)
    for k in ("bits_mean", "gnorm_mean", "gnorm_max"):
        out[f"superstep/{k}"] = met[k].numpy()
    out["superstep/positions"] = st.positions.numpy()
    for name, p in st.params.named_tensors():
        out[f"superstep/{name}"] = p.numpy()


def main():
    store, rank, size, src, dst = sys.argv[1:]
    group = mesh.init_tp_group(int(size), "cpu", store_path=store, rank=int(rank))
    try:
        with np.load(src) as z:
            z = dict(z)
        spec = json.loads(str(z["spec"]))
        out = {}
        for key, case in spec["loss"].items():
            loss_case(z, key, case, group, out)
        psum_case(group, out)
        if "superstep" in spec:
            superstep_case(z, spec["superstep"], group, out)
        if group.rank == 0:
            np.savez(dst, **out)
    finally:
        group.close()


if __name__ == "__main__":
    main()
