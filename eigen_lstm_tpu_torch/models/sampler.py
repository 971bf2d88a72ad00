"""Text sampling from a trained model, as ``eigen_lstm_tpu/models/sampler.py``
generates it: a loop of ``forward_step`` calls, greedy or at a temperature.

Greedy decoding takes the first maximal logit, as ``jnp.argmax`` does, so a
float32 model gives the JAX package's tokens. Temperature sampling draws
from softmax(logits / T) with ``torch.multinomial`` and an explicit
``torch.Generator``; its draws differ from JAX's PRNG.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import ModelConfig
from . import lstm as model


def sample_ids(
    params: model.LSTMParams,
    cfg: ModelConfig,
    generator: Optional[torch.Generator],
    first: torch.Tensor,        # (B,) priming byte per stream
    h0: torch.Tensor,           # (L, B, N)
    c0: torch.Tensor,           # (L, B, N)
    length: int,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``length`` ids per stream: ((length, B) ids, (h, c)).

    A batch that is a multiple of 8 on the card belongs to the fused
    generation kernel (``pallas_sampler.py:_gen_kernel``), which is not
    ported yet: it raises rather than quietly taking the loop."""
    if first.device.type == "cuda" and first.shape[0] % 8 == 0:
        raise NotImplementedError("generation kernel: next slice")
    if cfg.tie_embeddings:
        params = model._substitute_tied_embed(params, cfg)
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    if cfg.compute_dtype != cfg.param_dtype:
        # the weights in the compute type once, as the JAX sampler casts
        # them outside its scan
        params = params.to(cfg.cdtype)
    greedy = temperature == 0.0
    ch, h, c = first, h0, c0
    ids = []
    for _ in range(length):
        logits, (h, c) = model.forward_step(params, ch, h, c, cfg)
        if greedy:
            ch = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            ch = torch.multinomial(probs, 1, generator=generator)[:, 0]
        ids.append(ch)
    return torch.stack(ids), (h, c)


def sample_text(
    params: model.LSTMParams,
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    length: int = 1000,
    prime: bytes = b"\n",
    temperature: float = 1.0,
) -> str:
    """Prime with a byte string, generate ``length`` bytes on the
    parameters' device, decode latin-1."""
    if cfg.tie_embeddings:
        params = model._substitute_tied_embed(params, cfg)
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    dev = params.Why.device
    h, c = model.init_state(cfg, 1, device=dev)
    for byte in prime[:-1]:
        _, (h, c) = model.forward_step(
            params, torch.tensor([byte], device=dev), h, c, cfg
        )
    first = torch.tensor([prime[-1]], device=dev)
    ids, _ = sample_ids(params, cfg, generator, first, h, c, length,
                        temperature)
    return bytes(ids[:, 0].tolist()).decode("latin-1")
