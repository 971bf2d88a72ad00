"""Held-out evaluation: bits/char over the test split, as
``eigen_lstm_tpu/train/evaluator.py`` scores it.

The test bytes are folded into E contiguous streams, scored chunk by chunk
with the hidden state carried from one chunk to the next; padding past a
stream's own span is masked out, so every byte is scored exactly once.
``evaluate_ensemble_bpc`` scores a probability-space mixture of models the
same way.

The kernels are re-gated at the eval batch, as the JAX evaluator re-gates
its Pallas kernels (``eigen_lstm_tpu/train/evaluator.py:93-99``): a split
smaller than ``eval_batch * chunk`` bytes is scored as one stream, and at a
batch that is not a multiple of 8, or a hidden width that is not a
multiple of 128, the model's own loop scores it where the JAX package
takes its XLA scan.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models import lstm as model
from ..ops.dispatch import _shape_ok


def _score_streams(
    params: model.LSTMParams,
    x: torch.Tensor,        # (T, E) inputs, T = n_chunks * chunk
    t: torch.Tensor,        # (T, E) next-byte targets
    mask: torch.Tensor,     # (T, E) float, 1 where the position is real
    cfg: ModelConfig,
    chunk: int,
    n_chunks: int,
    cell_fn=None,
) -> torch.Tensor:
    """Sum of -log2 p(target) over the masked positions, as a float32
    tensor on the inputs' device (no host sync inside the loop)."""
    e = x.shape[1]
    h, c = model.init_state(cfg, e, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in range(n_chunks):
        sl = slice(k * chunk, (k + 1) * chunk)
        h_seq, (h, c) = model.forward(params, x[sl], h, c, cfg, cell_fn=cell_fn)
        logits = model.logits_from_h(params, h_seq, cfg)
        bits = model.softmax_xent_bits(logits, t[sl])
        total = total + torch.sum(bits * mask[sl]).to(torch.float32)
    return total


def _build_streams(test_data, eval_batch: int, chunk: int, max_chars):
    """(x, t, mask, usable, eval_batch, chunk, n_chunks): the held-out bytes
    as E contiguous streams of ceil-sized spans, the padded tail masked."""
    data = test_data
    if max_chars is not None and len(data) > max_chars + 1:
        data = data[: max_chars + 1]
    usable = len(data) - 1
    if usable < 1:
        raise ValueError("test split too small to evaluate")
    if usable < eval_batch * chunk:
        eval_batch = 1
    span = -(-usable // eval_batch)
    chunk = min(chunk, span)
    n_chunks = -(-span // chunk)
    span_pad = n_chunks * chunk
    need = (eval_batch - 1) * span + span_pad + 1
    if need > len(data):
        data = np.concatenate(
            [data, np.zeros(need - len(data), dtype=data.dtype)]
        )
    starts = np.arange(eval_batch) * span
    x = np.stack([data[s: s + span_pad] for s in starts], axis=1)
    t = np.stack([data[s + 1: s + span_pad + 1] for s in starts], axis=1)
    local = np.arange(span_pad)[:, None]
    idx = starts[None, :] + local
    mask = (idx < usable) & (local < span)
    return x, t, mask, usable, eval_batch, chunk, n_chunks


def _regate_cell_fn(cell_fn, cfg: ModelConfig, eval_batch: int):
    """``cell_fn`` at the eval batch, or None (the model's own loop) where
    the JAX evaluator drops its kernels: a batch that is not a multiple of
    8 or a hidden width that is not a multiple of 128
    (``ops/dispatch.py:_shape_ok``). A function of (eval batch, hidden)
    alone, chosen before any launch."""
    if cell_fn is not None and not _shape_ok(cfg, eval_batch):
        return None
    return cell_fn


def evaluate_bpc(
    params: model.LSTMParams,
    test_data: np.ndarray,
    cfg: ModelConfig,
    eval_batch: int = 16,
    chunk: int = 128,
    max_chars: Optional[int] = None,
    cell_fn=None,
) -> float:
    """bits/char on the held-out split; the parameters' device runs it.
    ``max_chars`` caps the scored bytes; ``cell_fn`` is the recurrence
    backend (``ops.dispatch.select_cell_fn``), re-gated at the batch the
    split is scored at (``_regate_cell_fn``)."""
    x, t, mask, usable, eval_batch, chunk, n_chunks = _build_streams(
        test_data, eval_batch, chunk, max_chars
    )
    dev = params.Why.device
    total = _score_streams(
        params,
        torch.from_numpy(x.astype(np.int32)).to(dev),
        torch.from_numpy(t.astype(np.int32)).to(dev),
        torch.from_numpy(mask.astype(np.float32)).to(dev),
        cfg,
        chunk,
        n_chunks,
        _regate_cell_fn(cell_fn, cfg, eval_batch),
    )
    return float(total) / usable


def _score_streams_ensemble(members, x, t, mask, chunk: int,
                            n_chunks: int) -> torch.Tensor:
    """Sum of -log2(mean_i p_i(target)) over the masked positions, each
    member carrying its own state across chunks; the mixture is
    logsumexp of the members' fp32 log-probabilities less log k."""
    e = x.shape[1]
    states = [model.init_state(cfg, e, device=x.device)
              for _, cfg, _ in members]
    log_k = torch.log(torch.tensor(float(len(members)), device=x.device))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in range(n_chunks):
        sl = slice(k * chunk, (k + 1) * chunk)
        logps = []
        for i, (params, cfg, cell_fn) in enumerate(members):
            h, c = states[i]
            h_seq, states[i] = model.forward(params, x[sl], h, c, cfg,
                                             cell_fn=cell_fn)
            logits = model.logits_from_h(params, h_seq, cfg)
            logps.append(torch.log_softmax(logits.to(torch.float32), dim=-1))
        mix = torch.logsumexp(torch.stack(logps), dim=0) - log_k
        nll = -torch.gather(mix, -1, t[sl].long()[..., None])[..., 0]
        total = total + torch.sum(nll / model.LN2 * mask[sl])
    return total


def evaluate_ensemble_bpc(
    members,
    test_data: np.ndarray,
    eval_batch: int = 16,
    chunk: int = 128,
    max_chars: Optional[int] = None,
) -> float:
    """bits/char of a probability-space ensemble on the held-out split
    (``eigen_lstm_tpu/train/evaluator.py:134-219``). ``members``: a
    sequence of ``(params, cfg, cell_fn)``, architectures free to differ
    but sharing one vocabulary; each member's ``cell_fn`` is re-gated at
    the eval batch (``_regate_cell_fn``).
    The first member's device runs it. One member gives ``evaluate_bpc``'s
    value."""
    if not members:
        raise ValueError("need at least one ensemble member")
    vocabs = {m[1].vocab for m in members}
    if len(vocabs) > 1:
        raise ValueError(
            f"ensemble members must share one vocab, got {sorted(vocabs)}")
    x, t, mask, usable, eval_batch, chunk, n_chunks = _build_streams(
        test_data, eval_batch, chunk, max_chars)
    dev = members[0][0].Why.device
    members = [(p, cfg, _regate_cell_fn(cell_fn, cfg, eval_batch))
               for p, cfg, cell_fn in members]
    total = _score_streams_ensemble(
        members,
        torch.from_numpy(x.astype(np.int32)).to(dev),
        torch.from_numpy(t.astype(np.int32)).to(dev),
        torch.from_numpy(mask.astype(np.float32)).to(dev),
        chunk, n_chunks)
    return float(total) / usable
