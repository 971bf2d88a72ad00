"""Host-streamed windows, as ``eigen_lstm_tpu/data/streaming.py`` feeds
them: the corpus stays on the host (a read-only memmap) and each superstep
gets one (K, S+1, B) uint8 window batch.

``WindowFeeder.next_device_batch`` builds the batch in pinned host memory
and copies it to the card with ``non_blocking=True``; the trainer asks for
the next batch right after it enqueues a superstep, so the host builds and
copies while the card computes. Two pinned buffers alternate, and a buffer
is refilled only after the CUDA event of its previous copy has fired.

The host cursors advance with the JAX package's arithmetic (same stride,
same wrap modulo), so streamed windows equal resident ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DataConfig


def load_corpus_mmap(path: str) -> np.ndarray:
    """The corpus as a read-only byte memmap. Cursors are int32, so the
    corpus must be shorter than 2**31 - 1 bytes."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    if data.shape[0] >= np.iinfo(np.int32).max:
        raise ValueError(
            f"corpus {path} is {data.shape[0]} bytes; stream cursors are "
            f"int32, the largest corpus is {np.iinfo(np.int32).max - 1} bytes"
        )
    return data


def advance_host(positions: np.ndarray, stride: int, corpus_len: int,
                 seq: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host mirror of ``corpus.advance_positions`` (the same wrap modulo)."""
    limit = corpus_len - seq - 1
    nxt = positions.astype(np.int64) + stride
    wrapped = nxt > limit
    nxt = np.where(wrapped, nxt % max(limit, 1), nxt)
    return nxt.astype(np.int32), wrapped


class WindowFeeder:
    """Per-superstep window batches from a host corpus.

    ``next_batch()`` is the (K, S+1, B) uint8 array of the next K steps
    (``win[:-1]`` the inputs, ``win[1:]`` the targets) and advances the
    host cursors past them. After each dispatch the trainer prefetches one
    batch, so ``positions`` leads the trainer's cursors by one superstep;
    ``set_positions`` re-syncs them (after init or a restore)."""

    def __init__(self, data: np.ndarray, dcfg: DataConfig, superstep: int,
                 positions: Optional[np.ndarray] = None, device="cuda"):
        if len(data) < dcfg.seq + 2:
            raise ValueError(f"corpus too short: len={len(data)} seq={dcfg.seq}")
        self.data = data
        self.seq = dcfg.seq
        self.stride = dcfg.effective_stride
        self.batch = dcfg.batch
        self.superstep = superstep
        self.device = torch.device(device)
        self._offs = np.arange(self.seq + 1, dtype=np.int64)[:, None]
        self.positions = (np.zeros(self.batch, np.int32) if positions is None
                          else np.asarray(positions, np.int32).copy())
        pin = self.device.type == "cuda"
        shape = (superstep, self.seq + 1, self.batch)
        self._host = [torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(2)]
        self._copied = [None, None]     # CUDA event of each buffer's copy
        self._slot = 0

    def set_positions(self, positions: np.ndarray) -> None:
        self.positions = np.asarray(positions, np.int32).copy()

    def build(self, positions: np.ndarray) -> np.ndarray:
        """One (S+1, B) uint8 window stack at the given cursors."""
        idx = positions.astype(np.int64)[None, :] + self._offs
        return np.ascontiguousarray(self.data[idx])

    def next_batch(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """(K, S+1, B) uint8 windows of the next superstep (into ``out``
        when given); advances the host cursors past them."""
        if out is None:
            out = np.empty((self.superstep, self.seq + 1, self.batch), np.uint8)
        pos = self.positions
        for i in range(self.superstep):
            out[i] = self.build(pos)
            pos, _ = advance_host(pos, self.stride, len(self.data), self.seq)
        self.positions = pos
        return out

    def next_device_batch(self) -> torch.Tensor:
        """The next batch on the feeder's device: built in a pinned buffer
        and copied without blocking the host (a fresh copy on the CPU)."""
        slot = self._slot
        self._slot ^= 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        buf = self._host[slot]
        self.next_batch(buf.numpy())
        if self.device.type != "cuda":
            return buf.clone()
        out = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._copied[slot] = event
        return out
