"""One rank of K15/K16's plain versions over gloo, for
tests/test_torch_tp_seq_exchange.py: ``python
tests/torch_tp_seq_exchange_worker.py STORE RANK SIZE IN.npz OUT_DIR``. The
D ranks meet through the FileStore at STORE. IN.npz holds a JSON ``spec``
(case key -> config) and each case's inputs by rank; this rank runs
``tp_seq_fwd_plain`` and then ``tp_seq_bwd_plain`` on its own shard over the
group and writes its outputs to OUT_DIR/rank{RANK}.npz. Imports torch and
the port only."""

import json
import os
import sys

import numpy as np
import torch

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts
from eigen_lstm_tpu_torch.parallel import mesh


def main(store, rank, size, src, out_dir):
    group = mesh.init_tp_group(size, "cpu", store_path=store, rank=rank)
    out = {}
    try:
        with np.load(src) as z:
            for key, kw in json.loads(str(z["spec"])).items():
                cfg = ModelConfig(**kw)
                x = lambda name: torch.from_numpy(z[f"{key}/{name}{rank}"])
                U_c = x("U").to(cfg.cdtype)
                h0 = torch.from_numpy(z[f"{key}/h0_full"])
                fwd = ts.tp_seq_fwd_plain(U_c, x("xw"), h0, x("c0"), cfg, group)
                _, g_seq, c_prev, _, cT = fwd
                bwd = ts.tp_seq_bwd_plain(U_c, g_seq, c_prev, cT, x("dh"),
                                          x("dhT"), x("dcT"), cfg, group)
                for name, t in zip(("h_seq", "g_seq", "c_prev", "hT", "cT",
                                    "dg", "dh0", "dc0"), fwd + bwd):
                    out[f"{key}/{name}"] = t.float().numpy()
    finally:
        group.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    store, rank, size, src, out_dir = sys.argv[1:6]
    main(store, int(rank), int(size), src, out_dir)
