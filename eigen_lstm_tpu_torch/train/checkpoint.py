"""Loading the JAX package's npz checkpoints into the port.

A checkpoint holds the parameters under the keys ``params.layers[i].W``,
``.U``, ``.b``, ``params.Why`` and ``params.by``, beside optimizer, stream
and metadata entries that serving does not read
(``eigen_lstm_tpu/train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.lstm import LayerParams, LSTMParams


def _expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    n, m = cfg.hidden, cfg.vocab
    shapes = {}
    for i in range(cfg.num_layers):
        in_dim = n if (i == 0 and cfg.tie_embeddings) else (m if i == 0 else n)
        shapes[f"params.layers[{i}].W"] = (in_dim, 4 * n)
        shapes[f"params.layers[{i}].U"] = (n, 4 * n)
        shapes[f"params.layers[{i}].b"] = (4 * n,)
    shapes["params.Why"] = (n, m)
    shapes["params.by"] = (m,)
    return shapes


def params_from_numpy(
    arrays: Dict[str, np.ndarray], cfg: ModelConfig, device="cuda"
) -> LSTMParams:
    """Parameters from ``{npz key: array}``, checked against ``cfg``'s
    shapes and cast to its param type on ``device``. This is how the JAX
    package's weights cross into the port."""
    tensors = {}
    for key, shape in _expected_shapes(cfg).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing tensor {key}")
        arr = np.asarray(arrays[key])
        if arr.shape != shape:
            raise ValueError(
                f"checkpoint shape mismatch for {key}: {arr.shape} vs {shape}"
            )
        tensors[key] = torch.tensor(arr, dtype=cfg.pdtype, device=device)
    layers = tuple(
        LayerParams(*(tensors[f"params.layers[{i}].{name}"]
                      for name in ("W", "U", "b")))
        for i in range(cfg.num_layers)
    )
    return LSTMParams(layers, tensors["params.Why"], tensors["params.by"])


def load_params(path: str, cfg: ModelConfig, device="cuda") -> LSTMParams:
    """Parameters of the npz checkpoint at ``path``; the other entries are
    not read."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in _expected_shapes(cfg) if k in z.files}
    return params_from_numpy(arrays, cfg, device)
