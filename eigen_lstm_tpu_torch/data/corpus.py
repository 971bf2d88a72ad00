"""Byte corpora, the leading-percentage train/test split and the stream
cursors, as ``eigen_lstm_tpu/data/corpus.py`` reads, splits and advances
them.

B cursors at random offsets read windows of S+1 bytes (S inputs, S
next-byte targets) and advance by ``stride``; at EOF a cursor wraps and the
caller resets that stream's (h, c). The cursor functions are plain torch
ops on whatever device the positions live on, so a training step advances
them on the card without a host round trip.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DataConfig


def rawread(path: str) -> np.ndarray:
    """Whole file -> uint8 array, through the native reader
    (``utils/native.py``), as the JAX ``rawread`` reads it."""
    from ..utils import native

    data = native.read_file(path)
    if len(data) == 0:
        raise ValueError(f"empty corpus: {path}")
    return data


def split(data: np.ndarray, train_percent: float) -> Tuple[np.ndarray, np.ndarray]:
    """The leading ``train_percent`` of the bytes trains, the rest is held
    out."""
    n_train = int(len(data) * train_percent)
    return data[:n_train], data[n_train:]


def corpus_limit(corpus_len: int, seq: int) -> int:
    """The largest cursor: the window of S+1 bytes there ends at the last
    byte. Fresh cursors are drawn below it; an advanced one may reach it."""
    return corpus_len - seq - 1


def init_positions(generator: torch.Generator, batch: int, corpus_len: int,
                   seq: int) -> torch.Tensor:
    """Random window starts in [0, corpus_len - seq - 1), (B,) int32 on the
    generator's device. The draws differ from the JAX package's."""
    limit = corpus_limit(corpus_len, seq)
    if limit <= 0:
        raise ValueError(f"corpus too short: len={corpus_len} seq={seq}")
    return torch.randint(0, limit, (batch,), generator=generator,
                         dtype=torch.int32, device=generator.device)


def make_windows(corpus: torch.Tensor, positions: torch.Tensor, seq: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, targets), each (S, B) int32: the S+1 bytes at every cursor, read
    from ``corpus`` (a uint8 tensor on the positions' device)."""
    offs = torch.arange(seq + 1, dtype=torch.int64, device=positions.device)
    window = corpus[positions.long()[None, :] + offs[:, None]].to(torch.int32)
    return window[:-1], window[1:]


def advance_positions(positions: torch.Tensor, stride: int, corpus_len: int,
                      seq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cursors advanced by ``stride``, wrapped modulo the last valid start
    past it: (new positions (B,) int32, wrapped (B,) bool)."""
    limit = corpus_limit(corpus_len, seq)
    nxt = positions.to(torch.int64) + stride
    wrapped = nxt > limit
    nxt = torch.where(wrapped, nxt % max(limit, 1), nxt)
    return nxt.to(torch.int32), wrapped


class CorpusStreams:
    """A corpus on a device with its data config: the cursor functions
    bound to its length."""

    def __init__(self, data: np.ndarray, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.corpus = torch.tensor(np.asarray(data), dtype=torch.uint8,
                                   device=device)
        self.length = int(len(data))

    def init_positions(self, generator: torch.Generator) -> torch.Tensor:
        return init_positions(generator, self.cfg.batch, self.length,
                              self.cfg.seq)

    def windows(self, positions: torch.Tensor):
        return make_windows(self.corpus, positions, self.cfg.seq)

    def advance(self, positions: torch.Tensor):
        return advance_positions(positions, self.cfg.effective_stride,
                                 self.length, self.cfg.seq)


def load_dataset(cfg: DataConfig) -> Tuple[np.ndarray, np.ndarray]:
    """rawread + split in one call."""
    return split(rawread(cfg.path), cfg.train_percent)
