"""The fused generation kernel of the port and its plain version, the
counterpart of ``eigen_lstm_tpu/ops/pallas_sampler.py``.

``generate`` replaces ``pallas_sample_ids``: ``length`` tokens of every
layer, the head and the draw in one launch of ``csrc/sampler.cu``, with the
same contract: ``((length, B) int32 ids, (hT, cT) in the param type)``. For
a CUDA tensor it launches the kernel or raises; for a CPU tensor it runs
``generate_plain``, which repeats the kernel's arithmetic in PyTorch:

* the weights as ``pallas_sample_ids`` packs them: each layer's [W; U] in
  the compute type, b and by in fp32 (``pallas_sampler.py:210-222``);
* layer l: g = round([x, h_l]) @ [W_l; U_l] + b_l with fp32 sums, x the
  one-hot of the previous token (layer 0) or h_{l-1} of this token, the
  state in fp32; logits = round(h_{L-1}) @ Why + by;
* the token: the first argmax of the logits (T = 0) or of
  logits * inv_t + gumbel, inv_t = fp32(1 / T), the Gumbel noise from the
  murmur3 hash of (seed, step within the call, row * M + byte)
  (``pallas_sampler.py:89-103``, ``gumbel`` here).

The draws are not ``jax.random``'s: the JAX package's seed is
``jax.random.bits(key)`` read as int32, which torch cannot reproduce; the
callers pass a seed, and tests pass the JAX one.

``generate.launches`` counts kernel launches: one a call.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from . import _build
from . import cell as cell_ops
from .cuda_cell import _M32, _TYPE_CODES, _acc_dtype, _fmix32_torch, _mul32, _raise_on
from .head import MAX_VOCAB


def supported(cfg: ModelConfig, batch: int) -> bool:
    """What the kernel takes: a hidden width that is a multiple of 32 (a
    warp's lanes own 32 units of each gate), at most 256 bytes of
    vocabulary (as ``head.head_supported``), any batch >= 1, and an fp32 or
    bf16 compute type. There is no capacity gate: the weights stream from
    device memory and L2 at every token, and the TPU's 13 MB VMEM budget
    (``pallas_sampler.py:121-134``) describes the TPU."""
    return (cfg.hidden % 32 == 0 and 0 < cfg.vocab <= MAX_VOCAB
            and batch >= 1 and cfg.cdtype in _TYPE_CODES)


class Packed(NamedTuple):
    WU: torch.Tensor   # every layer's [W; U] in the compute type, flat
    b: torch.Tensor    # (L, 4N)
    Why: torch.Tensor  # (N, M) in the compute type
    by: torch.Tensor   # (M,)


def pack_weights(params, cfg: ModelConfig) -> Packed:
    """The weights as the kernel reads them: the layers' [W; U] one after
    the other in the compute type (no padding to a common input width,
    which was the TPU's layout), b and by in fp32 (the accumulation
    type)."""
    af = _acc_dtype(cfg)
    WU = torch.cat([torch.cat([l.W, l.U]).to(cfg.cdtype).reshape(-1)
                    for l in params.layers])
    b = torch.stack([l.b.to(af) for l in params.layers])
    return Packed(WU, b, params.Why.to(cfg.cdtype).contiguous(),
                  params.by.to(af).contiguous())


def layer_weights(WU: torch.Tensor, cfg: ModelConfig) -> List[torch.Tensor]:
    """Views of the flat [W; U] stack: (M + N, 4N) for layer 0, (2N, 4N)
    after."""
    n, m = cfg.hidden, cfg.vocab
    out, at = [], 0
    for l in range(cfg.num_layers):
        rows = (m if l == 0 else n) + n
        out.append(WU[at:at + rows * 4 * n].view(rows, 4 * n))
        at += rows * 4 * n
    return out


def hash_bits(seed: int, steps: torch.Tensor, rows: torch.Tensor,
              m: int) -> torch.Tensor:
    """(R, m) uint32 hash bits (as int64) of the kernel's draw for rows r of
    the call's batch at steps t (both (R,) int64): base = fmix32(seed ^ t *
    0x9E3779B9), bits = fmix32((r * m + v) * 0x85EBCA6B ^ base) in wrapping
    uint32, the int32 seed read as its bits. Computed in int64, since torch
    has no wrapping uint32 product."""
    base = _fmix32_torch((int(seed) & _M32) ^ _mul32(steps & _M32, 0x9E3779B9))
    idx = (rows[:, None] * m + torch.arange(m, device=rows.device)) & _M32
    return _fmix32_torch(_mul32(idx, 0x85EBCA6B) ^ base[:, None])


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """max((bits >> 8) * 2^-24, 1e-7) in fp32; the product is exact."""
    return torch.clamp_min((bits >> 8).to(torch.float32) * 2.0 ** -24, 1e-7)


def gumbel(seed: int, steps: torch.Tensor, rows: torch.Tensor,
           m: int) -> torch.Tensor:
    """(R, m) fp32 Gumbel noise of the kernel: -log(-log(u)) of the
    ``uniform`` of the ``hash_bits``."""
    return -torch.log(-torch.log(uniform(hash_bits(seed, steps, rows, m))))


def first_argmax(scores: torch.Tensor) -> torch.Tensor:
    """The smallest index among the maxima of the last axis, as the TPU
    kernel takes it (max, then the least column that reaches it;
    ``pallas_sampler.py:106-110``), whatever ``torch.argmax`` does on a
    tie. int32."""
    m = scores.shape[-1]
    mx = scores.max(dim=-1, keepdim=True).values
    cols = torch.arange(m, device=scores.device)
    return torch.where(scores >= mx, cols, m).min(dim=-1).values.to(torch.int32)


def inv_temperature(temperature: float) -> float:
    """fp32(1 / T) computed in double, as ``pallas_sample_ids`` makes it
    (0 for greedy)."""
    if temperature == 0.0:
        return 0.0
    return float(np.float32(1.0 / float(temperature)))


def plain_step(wus, packed: Packed, h, c, ch, cfg: ModelConfig, seed: int,
               steps, rows, temperature: float, inputs=None):
    """One token of every layer and the head, on R rows at once: the
    kernel's arithmetic. wus: ``layer_weights`` in the accumulation type;
    h, c: (L, R, N) in the accumulation type; ch: (R,) previous tokens;
    steps, rows: (R,) int64, each row's step within its call and row in
    its batch (the hash's counters). ``inputs`` (L, R, N), when given,
    replaces the h of this token that layer l + 1 (and the head, after
    layer L - 1) reads, so that a replay of another run's step holds each
    layer alone. Returns (h, c, scores (R, M))."""
    af = _acc_dtype(cfg)
    n, m = cfg.hidden, cfg.vocab
    x = None
    hs, cs = [], []
    for l, wu in enumerate(wus):
        if l == 0:
            inp = cell_ops.one_hot(ch, m, af)
        else:
            inp = x if inputs is None else inputs[l - 1]
        xh = torch.cat([inp, h[l]], dim=-1).to(cfg.cdtype).to(af)
        g = cell_ops.gate_activations(xh @ wu + packed.b[l], n)
        x, cl = cell_ops.cell_update(g, c[l], n, cfg.cell_variant)
        hs.append(x)
        cs.append(cl)
    if inputs is not None:
        x = inputs[-1]
    logits = x.to(cfg.cdtype).to(af) @ packed.Why.to(af) + packed.by
    if temperature == 0.0:
        scores = logits
    else:
        inv_t = torch.tensor(inv_temperature(temperature), dtype=af,
                             device=logits.device)
        scores = logits * inv_t + gumbel(seed, steps, rows, m).to(af)
    return torch.stack(hs), torch.stack(cs), scores


def _validate(params, cfg: ModelConfig, first, h0, c0, length: int,
              temperature: float):
    """Raises on inputs that neither the kernel nor its plain version
    takes."""
    if cfg.tie_embeddings:
        raise ValueError("substitute tied embeddings first "
                         "(models.lstm._substitute_tied_embed)")
    if first.dim() != 1 or first.dtype.is_floating_point or first.dtype == torch.bool:
        raise TypeError(f"first must be (B,) integer byte ids, got "
                        f"{tuple(first.shape)} {first.dtype}")
    b = first.shape[0]
    shape = (cfg.num_layers, b, cfg.hidden)
    for name, x in (("h0", h0), ("c0", c0)):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != first.device:
            raise ValueError(f"{name} on {x.device}, first on {first.device}")
    n, m = cfg.hidden, cfg.vocab
    want = {"params.Why": (n, m), "params.by": (m,)}
    for l in range(cfg.num_layers):
        want.update({f"params.layers[{l}].W": (m if l == 0 else n, 4 * n),
                     f"params.layers[{l}].U": (n, 4 * n),
                     f"params.layers[{l}].b": (4 * n,)})
    named = dict(params.named_tensors())
    if set(named) != set(want):
        raise ValueError(f"params hold {sorted(named)}, expected {sorted(want)}")
    for name, x in named.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {want[name]}")
        if x.device != first.device:
            raise ValueError(f"{name} on {x.device}, first on {first.device}")
    if length < 1:
        raise ValueError(f"length must be >= 1, got {length}")
    if not temperature >= 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if b and (int(first.min()) < 0 or int(first.max()) >= cfg.vocab):
        raise ValueError(f"first holds ids outside [0, {cfg.vocab})")


def _finish(ids, h, c, cfg: ModelConfig, trace):
    out = (ids, (h.to(cfg.pdtype), c.to(cfg.pdtype)))
    return out if trace is None else out + (trace,)


def generate_plain(params, cfg: ModelConfig, seed: int, first, h0, c0,
                   length: int, temperature: float = 1.0,
                   trace: bool = False):
    """Plain version of the kernel: a loop of ``plain_step``, one token at a
    time. With ``trace`` it also returns the fp32 state after every token,
    ((length, L, B, N), (length, L, B, N))."""
    _validate(params, cfg, first, h0, c0, length, temperature)
    af = _acc_dtype(cfg)
    packed = pack_weights(params, cfg)
    wus = [w.to(af) for w in layer_weights(packed.WU, cfg)]
    h, c = h0.to(af), c0.to(af)
    ch = first.to(torch.int32)
    rows = torch.arange(first.shape[0], device=first.device)
    ids, hs, cs = [], [], []
    for t in range(length):
        h, c, scores = plain_step(wus, packed, h, c, ch, cfg, seed,
                                  torch.full_like(rows, t), rows, temperature)
        ch = first_argmax(scores)
        ids.append(ch)
        if trace:
            hs.append(h)
            cs.append(c)
    states = (torch.stack(hs), torch.stack(cs)) if trace else None
    return _finish(torch.stack(ids), h, c, cfg, states)


def generate(params, cfg: ModelConfig, seed: int, first, h0, c0,
             length: int, temperature: float = 1.0, trace: bool = False):
    """``length`` tokens per stream from the previous token ``first`` (B,)
    and the state h0, c0 (L, B, N): the kernel on a CUDA tensor, the plain
    version on a CPU tensor. ``seed`` is an int32 whose bits seed the
    draws; ``temperature`` 0 is greedy. Returns ((length, B) int32 ids,
    (hT, cT)), and with ``trace`` the fp32 state after every token."""
    _validate(params, cfg, first, h0, c0, length, temperature)
    if first.device.type == "cpu":
        return generate_plain(params, cfg, seed, first, h0, c0, length,
                              temperature, trace)
    b = first.shape[0]
    if first.device.type != "cuda" or not supported(cfg, b):
        raise ValueError(f"no generation kernel for {cfg} at B = {b} on "
                         f"{first.device}")
    lib = _build.load_library()
    dev = first.device
    n, m, L = cfg.hidden, cfg.vocab, cfg.num_layers
    packed = pack_weights(params, cfg)
    h = h0.to(torch.float32).contiguous().clone()
    c = c0.to(torch.float32).contiguous().clone()
    ch = first.to(torch.int32).contiguous().clone()
    ids = torch.empty(length, b, dtype=torch.int32, device=dev)
    work = torch.empty(lib.gen_work_floats(b, n, m), dtype=torch.float32,
                       device=dev)
    states = None
    if trace:
        states = tuple(torch.empty(length, L, b, n, dtype=torch.float32,
                                   device=dev) for _ in range(2))
    err = lib.gen_launch(
        _TYPE_CODES[cfg.cdtype], packed.WU.data_ptr(), packed.b.data_ptr(),
        packed.Why.data_ptr(), packed.by.data_ptr(), h.data_ptr(),
        c.data_ptr(), ch.data_ptr(), ids.data_ptr(), work.data_ptr(),
        *((None, None) if states is None else (s.data_ptr() for s in states)),
        L, b, n, m, length, int(cfg.cell_variant == "standard"),
        int(temperature == 0.0), int(seed) & _M32,
        inv_temperature(temperature), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "gen_launch")
    generate.launches += 1
    return _finish(ids, h, c, cfg, states)


generate.launches = 0
