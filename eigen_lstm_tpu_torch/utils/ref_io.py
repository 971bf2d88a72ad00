"""The reference's text checkpoint format, read and written on the port's
``LSTMParams``: the counterpart of ``eigen_lstm_tpu/utils/ref_io.py``.

The reference saves one whitespace text file per tensor under a prefix,
``<prefix>_W.txt``, ``_U.txt``, ``_b.txt``, ``_Why.txt``, ``_by.txt``, each
a matrix a row a line in its column-vector layout:

  ref W   (4N, M)  -> layers[0].W = ref.T   (M, 4N)
  ref U   (4N, N)  -> layers[0].U = ref.T   (N, 4N)
  ref b   (4N, 1)  -> layers[0].b = ref[:, 0]
  ref Why (M, N)   -> Why = ref.T           (N, M)
  ref by  (M, 1)   -> by = ref[:, 0]

The gates are packed [i; o; f; u] in blocks of N in both, so a transpose
keeps their order. Only one-layer models exist in the format. The files
are parsed and written through ``utils/native.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import ModelConfig
from ..models.lstm import LayerParams, LSTMParams
from . import native


def load_text_matrix(path: str, rows: int, cols: int) -> np.ndarray:
    """The file's floats as a (rows, cols) float64 matrix; ValueError when
    it holds another count."""
    vals = native.parse_floats(path, rows * cols)
    if vals.size != rows * cols:
        raise ValueError(
            f"{path}: expected {rows}x{cols}={rows * cols} values, got {vals.size}")
    return vals.reshape(rows, cols)


def save_text_matrix(path: str, mat: np.ndarray) -> None:
    native.write_matrix(path, np.atleast_2d(mat))


def load_reference_checkpoint(prefix: str, cfg: ModelConfig,
                              device="cuda") -> LSTMParams:
    """A reference-format checkpoint as ``LSTMParams`` in ``cfg``'s param
    type on ``device``."""
    if cfg.num_layers != 1:
        raise ValueError("reference checkpoints are always 1-layer")
    n, m = cfg.hidden, cfg.vocab
    W = load_text_matrix(f"{prefix}_W.txt", 4 * n, m)
    U = load_text_matrix(f"{prefix}_U.txt", 4 * n, n)
    b = load_text_matrix(f"{prefix}_b.txt", 4 * n, 1)
    Why = load_text_matrix(f"{prefix}_Why.txt", m, n)
    by = load_text_matrix(f"{prefix}_by.txt", m, 1)
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=cfg.pdtype,
                               device=device)
    return LSTMParams((LayerParams(t(W.T), t(U.T), t(b[:, 0])),),
                      t(Why.T), t(by[:, 0]))


def save_reference_checkpoint(params: LSTMParams, prefix: str) -> None:
    """The reference's text files of a one-layer ``LSTMParams`` (the inverse
    mapping)."""
    if len(params.layers) != 1:
        raise ValueError("reference format only holds 1-layer models")
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    f64 = lambda x: x.detach().to("cpu", torch.float64).numpy()
    layer = params.layers[0]
    save_text_matrix(f"{prefix}_W.txt", f64(layer.W).T)
    save_text_matrix(f"{prefix}_U.txt", f64(layer.U).T)
    save_text_matrix(f"{prefix}_b.txt", f64(layer.b)[:, None])
    save_text_matrix(f"{prefix}_Why.txt", f64(params.Why).T)
    save_text_matrix(f"{prefix}_by.txt", f64(params.by)[:, None])
