"""Byte corpora and the leading-percentage train/test split, byte for byte
as ``eigen_lstm_tpu/data/corpus.py`` reads and splits them."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rawread(path: str) -> np.ndarray:
    """Whole file -> uint8 array."""
    data = np.fromfile(path, dtype=np.uint8)
    if len(data) == 0:
        raise ValueError(f"empty corpus: {path}")
    return data


def split(data: np.ndarray, train_percent: float) -> Tuple[np.ndarray, np.ndarray]:
    """The leading ``train_percent`` of the bytes trains, the rest is held
    out."""
    n_train = int(len(data) * train_percent)
    return data[:n_train], data[n_train:]
