"""Text sampling from a trained model, as ``eigen_lstm_tpu/models/sampler.py``
generates it.

``sample_ids``'s ``backend`` mirrors the JAX argument, which chooses
between the fused kernel and the XLA scan:

* ``"cuda"`` (JAX ``"pallas"``): the fused generation kernel
  (``ops/cuda_sampler.generate``); raises off the card, and on the card
  for a model the kernel does not take.
* ``"loop"`` (JAX ``"xla"``): a loop of ``forward_step`` calls with every
  parameter, biases included, in the compute type, as the JAX scan casts
  them. Greedy decoding takes the first maximal logit, as ``jnp.argmax``
  does, so a float32 model gives the JAX package's tokens; a temperature
  draws with ``torch.multinomial`` from the caller's ``torch.Generator``.
* ``"auto"``: ``"cuda"`` on a CUDA device, ``"loop"`` off it, as the JAX
  ``auto`` takes its scan off the TPU. On the card there is no fallback:
  a model the kernel does not take raises, as the eval and training
  paths do.

The kernel keeps b and by in fp32 (as the JAX kernel does), so in bf16 it
matches its plain version (``cuda_sampler.generate_plain``) and the JAX
kernel, not the loop. Its draws are the kernel's murmur3 Gumbel stream,
seeded by an int32 drawn from the caller's generator (the JAX kernel
derives it from its key, ``pallas_sampler.py:223``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import ModelConfig
from ..ops import cuda_sampler
from . import lstm as model

BACKENDS = ("auto", "cuda", "loop")


def draw_seed(generator: Optional[torch.Generator], device) -> int:
    """An int32 seed from ``generator`` (torch's default one if None); the
    draw advances it, so consecutive samples differ."""
    if generator is not None:
        device = generator.device
    return int(torch.randint(-2**31, 2**31, (), generator=generator,
                             device=device, dtype=torch.int64))


def sample_ids(
    params: model.LSTMParams,
    cfg: ModelConfig,
    generator: Optional[torch.Generator],
    first: torch.Tensor,        # (B,) priming byte per stream
    h0: torch.Tensor,           # (L, B, N)
    c0: torch.Tensor,           # (L, B, N)
    length: int,
    temperature: float = 1.0,
    backend: str = "auto",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``length`` ids per stream: ((length, B) int32 ids, (h, c))."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if cfg.tie_embeddings:
        # substituted once here: every backend sees untied params
        params = model._substitute_tied_embed(params, cfg)
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    if backend == "auto":
        backend = "cuda" if first.device.type == "cuda" else "loop"
    if backend == "cuda":
        if first.device.type != "cuda":
            raise ValueError(f"cuda backend on device {first.device}")
        return cuda_sampler.generate(params, cfg,
                                     draw_seed(generator, first.device),
                                     first, h0, c0, length, temperature)
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
    return torch.stack(ids).to(torch.int32), (h, c)


def sample_text(
    params: model.LSTMParams,
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    length: int = 1000,
    prime: bytes = b"\n",
    temperature: float = 1.0,
) -> str:
    """Prime with a byte string, generate ``length`` bytes on the
    parameters' device (through the kernel on the card), decode latin-1."""
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
