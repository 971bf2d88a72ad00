"""Stacked character-LSTM language model in PyTorch, mirroring
``eigen_lstm_tpu/models/lstm.py``.

Layer 0 gathers rows of W by byte id; layers >= 1 take the hidden sequence
of the layer below through one large product x @ W + b outside the
recurrence. Only h_{t-1} @ U stays inside the per-layer recurrence, which a
``cell_fn`` (``ops/dispatch.py``) may replace with a kernel.

Parameters are plain tensors in dataclasses, keyed like the JAX package's
npz checkpoints (``params.layers[i].W`` ...; ``train/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from ..config import ModelConfig
from ..ops import cell as cell_ops

LN2 = 0.6931471805599453
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class LayerParams:
    """One layer. W: (in_dim, 4N); U: (N, 4N); b: (4N,)."""

    W: torch.Tensor
    U: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass
class LSTMParams:
    """Stacked layers plus the softmax head Why: (N, M), by: (M,)."""

    layers: Tuple[LayerParams, ...]
    Why: torch.Tensor
    by: torch.Tensor

    def named_tensors(self):
        """(npz key, tensor) pairs under the JAX checkpoint's keys."""
        for i, layer in enumerate(self.layers):
            for name in ("W", "U", "b"):
                yield f"params.layers[{i}].{name}", getattr(layer, name)
        yield "params.Why", self.Why
        yield "params.by", self.by

    def tensors(self):
        """The tensors of ``named_tensors``, in its order, without the
        keys (the optimizer's per-step path)."""
        return [t for l in self.layers for t in (l.W, l.U, l.b)] + [self.Why,
                                                                    self.by]

    def like(self, ts) -> "LSTMParams":
        """This structure holding ``ts`` in the order of ``named_tensors``."""
        ts = list(ts)
        layers = tuple(LayerParams(*ts[3 * i: 3 * i + 3])
                       for i in range(len(self.layers)))
        return LSTMParams(layers, ts[-2], ts[-1])

    def to(self, dtype: torch.dtype) -> "LSTMParams":
        return LSTMParams(
            tuple(LayerParams(l.W.to(dtype), l.U.to(dtype), l.b.to(dtype))
                  for l in self.layers),
            self.Why.to(dtype), self.by.to(dtype),
        )


def tensors(p: LSTMParams):
    """The parameter set's tensors in checkpoint order (W, U, b of each
    layer, then Why, by), or those of another layout with ``tensors``
    (``parallel/pp.py:PPParams``)."""
    return p.tensors()


def like(p: LSTMParams, ts) -> LSTMParams:
    """A parameter set with ``p``'s structure holding ``ts`` in the order
    of ``tensors`` (``p.like``)."""
    return p.like(ts)


def init_params(
    cfg: ModelConfig, generator: Optional[torch.Generator] = None,
    device="cuda",
) -> LSTMParams:
    """W, U, Why ~ N(0, init_std), biases 0, forget-gate bias
    ``forget_bias``. Seeded by ``generator`` (default: one seeded with
    ``cfg.seed``); the numbers differ from the JAX package's."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    n, m, dt = cfg.hidden, cfg.vocab, cfg.pdtype

    def normal(*shape):
        x = torch.randn(*shape, generator=generator, dtype=torch.float32)
        return (x * cfg.init_std).to(dt).to(device)

    layers = []
    for l in range(cfg.num_layers):
        in_dim = n if (l == 0 and cfg.tie_embeddings) else (m if l == 0 else n)
        W = normal(in_dim, 4 * n)
        U = normal(n, 4 * n)
        b = torch.zeros(4 * n, dtype=dt, device=device)
        b[cell_ops.gate_slices(n)[2]] = cfg.forget_bias
        layers.append(LayerParams(W, U, b))
    Why = normal(n, m)
    by = torch.zeros(m, dtype=dt, device=device)
    return LSTMParams(tuple(layers), Why, by)


def init_state(
    cfg: ModelConfig, batch: int, device="cuda", reset_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, c), each (L, B, N): zeros, or N(0, reset_std) drawn from
    ``generator`` (on ``device``) when both are given. The draws differ
    from the JAX package's."""
    shape = (cfg.num_layers, batch, cfg.hidden)
    if reset_std == 0.0 or generator is None:
        return (torch.zeros(shape, dtype=cfg.pdtype, device=device),
                torch.zeros(shape, dtype=cfg.pdtype, device=device))
    h = torch.randn(shape, generator=generator, device=device) * reset_std
    c = torch.randn(shape, generator=generator, device=device) * reset_std
    return h.to(cfg.pdtype), c.to(cfg.pdtype)


def _scan_layer(
    layer: LayerParams, xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The recurrence h_t = cell(xw_t + h_{t-1} @ U, c_{t-1}) as a loop,
    with the carry in the param type (the JAX ``lax.scan``). xw: (S, B, 4N)
    with the bias folded in. Returns (h_seq, (hT, cT)).

    This is the counterpart of the JAX package's XLA path (``cell_fn=None``),
    not of its kernels: xw stays unrounded under bf16 compute, and layer 0
    may take the one-hot or tied embedding. The kernels' plain versions in
    ``ops/cuda_cell.py`` repeat the Pallas path's arithmetic instead; the
    two differ in bf16 (2.276534 against 2.276745 bits/char on the
    flagship's 4096-byte held-out slice, in the JAX package on the CPU)."""
    n = cfg.hidden
    h, c = h0.to(cfg.pdtype), c0.to(cfg.pdtype)
    hs = []
    for t in range(xw.shape[0]):
        g_pre = xw[t] + cell_ops.matmul(h, layer.U, cfg.cdtype)
        h, c = cell_ops.cell_step(g_pre, c.to(cfg.adtype), n, cfg.cell_variant)
        h, c = h.to(cfg.pdtype), c.to(cfg.pdtype)
        hs.append(h)
    return torch.stack(hs), (h, c)


def step_key(seed: int, step: int) -> int:
    """The dropout key of training step ``step`` of a run seeded ``seed``: a
    pure function of the two, so a resumed run draws the masks a straight
    run would (the JAX trainer's ``fold_in(key, step)``,
    ``trainer.py:89-92``; the bits differ from the JAX package's)."""
    return cell_ops.hash32(cell_ops.hash32(seed) ^ ((step * 0x9E3779B9) & _M32))


def _drop_seed(key, l: int) -> int:
    """The int32 seed of layer ``l``'s dropout mask: a pure function of the
    step's key and the layer, so masks differ across layers and steps (the
    JAX ``_drop_seed``, ``models/lstm.py:186-194``, with other bits). A
    ``key`` that is a sequence of per-layer seeds gives them as they are:
    the tests pass the JAX package's."""
    if isinstance(key, (tuple, list)):
        return int(key[l])
    h = cell_ops.hash32
    x = h(h(key) ^ h(l ^ 0x632BE5AB))
    return x - (1 << 32) if x >= (1 << 31) else x


def _dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of the model's own loop (``cell_fn=None``), the JAX
    ``_dropout`` (``models/lstm.py:166-183``): keep where 32 random bits
    are <= int(keep * (2**32 - 1)), then x / keep. The bits come from a
    torch generator seeded with the layer's seed on x's device; the JAX
    package's RBG bits cannot be reproduced."""
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(seed & _M32)
    bits = torch.randint(0, 1 << 32, x.shape, generator=gen,
                         dtype=torch.int64, device=x.device)
    thresh = int(keep * (2**32 - 1))
    return torch.where(bits <= thresh,
                       x / torch.tensor(keep, dtype=x.dtype, device=x.device),
                       torch.zeros_like(x))


def _substitute_tied_embed(params: LSTMParams, cfg: ModelConfig) -> LSTMParams:
    """Tied embeddings: layer 0's input weight becomes W_eff = Why^T @ W0.
    No-op when untied."""
    if not cfg.tie_embeddings:
        return params
    l0 = params.layers[0]
    w_eff = cell_ops.matmul(
        params.Why.T, l0.W, cfg.cdtype, cfg.adtype
    ).to(cfg.pdtype)
    return dataclasses.replace(
        params, layers=(dataclasses.replace(l0, W=w_eff),) + params.layers[1:]
    )


def _chunked_seq(fn, seq_arg: torch.Tensor, h0: torch.Tensor,
                 c0: torch.Tensor, chunk: int):
    """A whole-sequence layer op run chunk by chunk with rematerialisation
    (the JAX ``_chunked_seq``, ``models/lstm.py:138-156``): ``fn(x_chunk,
    h, c) -> (h_seq, (hT, cT))`` on each ``chunk`` steps under
    ``torch.utils.checkpoint``, the state carried from one chunk to the
    next, so the backward holds one chunk's residuals at a time and
    recomputes each chunk from its starting (h, c): the backward calls
    ``fn`` again, so it must bind its layer rather than read a loop
    variable."""
    hs = []
    h, c = h0, c0
    for k in range(seq_arg.shape[0] // chunk):
        h_seq, (h, c) = torch.utils.checkpoint.checkpoint(
            fn, seq_arg[k * chunk:(k + 1) * chunk], h, c, use_reentrant=False)
        hs.append(h_seq)
    return torch.cat(hs), (h, c)


def _maybe_chunk(cfg: ModelConfig, s: int) -> int:
    """The chunk of this window, or 0 (off, or not dividing S)."""
    ck = cfg.scan_chunk
    return ck if ck and 0 < ck < s and s % ck == 0 else 0


def forward(
    params: LSTMParams,
    ids: torch.Tensor,           # (S, B) int byte ids
    h0: torch.Tensor,            # (L, B, N)
    c0: torch.Tensor,            # (L, B, N)
    cfg: ModelConfig,
    cell_fn=None,
    dropout_key=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full forward: (h_seq of the top layer (S, B, N), (hL, cL) stacked).

    ``cell_fn(layer, xw, h0, c0, cfg) -> (h_seq, (hT, cT))`` replaces the
    per-layer recurrence, and its ``embed_layer0(layer, ids, h0, c0, cfg)``
    attribute, when present, replaces layer 0 with the embedding fused in.
    Gradients flow through both (``ops.cuda_cell_bwd``) and through the
    plain loop. With ``cfg.scan_chunk`` dividing S, each layer's recurrence
    runs in chunks under ``_chunked_seq``.

    ``dropout_key`` (an int, ``step_key``'s; or a sequence of per-layer
    int32 seeds) with ``cfg.dropout > 0`` drops out each layer's output
    stream, between the layers and before the head; None is eval. A
    ``cell_fn`` with ``fused_dropout`` takes ``dropout=(rate, seed)`` and
    masks in its kernels with ``_keep_mask``'s bits, one seed per layer
    from ``_drop_seed``; the carried (hT, cT) stay unmasked. Otherwise,
    and always under ``scan_chunk`` (a chunk's kernel would draw the mask
    of its own timesteps, as in the JAX package), ``_dropout`` masks the
    stream."""
    drop = cfg.dropout if dropout_key is not None else 0.0
    if drop > 0.0 and isinstance(dropout_key, (tuple, list)) \
            and len(dropout_key) != cfg.num_layers:
        raise ValueError(f"{len(dropout_key)} dropout seeds for "
                         f"{cfg.num_layers} layers")
    s, b_ = ids.shape
    ck = _maybe_chunk(cfg, s)
    fdrop = drop > 0.0 and not ck and getattr(cell_fn, "fused_dropout", False)
    scan_fn = cell_fn or _scan_layer
    embed_fn = getattr(cell_fn, "embed_layer0", None)
    x = None
    h_last, c_last = [], []
    params = _substitute_tied_embed(params, cfg)
    for l, layer in enumerate(params.layers):
        kw = {"dropout": (drop, _drop_seed(dropout_key, l))} if fdrop else {}
        if l == 0 and embed_fn is not None:
            if ck:
                h_seq, (hT, cT) = _chunked_seq(
                    lambda x_c, h, c, layer=layer: embed_fn(layer, x_c, h, c,
                                                            cfg),
                    ids, h0[0], c0[0], ck)
            else:
                h_seq, (hT, cT) = embed_fn(layer, ids, h0[0], c0[0], cfg, **kw)
        else:
            if l == 0:
                if cfg.embedding_mode == "onehot":
                    oh = cell_ops.one_hot(ids, cfg.vocab, cfg.cdtype)
                    xw = cell_ops.matmul(
                        oh.reshape(s * b_, cfg.vocab), layer.W, cfg.cdtype,
                        cfg.adtype,
                    ).reshape(s, b_, -1)
                else:
                    # "auto" and "gather" agree in the forward: a row gather
                    xw = cell_ops.embed(layer.W, ids, cfg.cdtype, cfg.adtype)
            else:
                xw = cell_ops.matmul(
                    x.reshape(s * b_, -1), layer.W, cfg.cdtype
                ).reshape(s, b_, -1)
            xw = xw + layer.b.to(cfg.adtype)
            if ck:
                h_seq, (hT, cT) = _chunked_seq(
                    lambda x_c, h, c, layer=layer: scan_fn(layer, x_c, h, c,
                                                           cfg),
                    xw, h0[l], c0[l], ck)
            else:
                h_seq, (hT, cT) = scan_fn(layer, xw, h0[l], c0[l], cfg, **kw)
        if drop > 0.0 and not fdrop:
            h_seq = _dropout(h_seq, drop, _drop_seed(dropout_key, l))
        x = h_seq
        h_last.append(hT)
        c_last.append(cT)
    return x, (torch.stack(h_last), torch.stack(c_last))


def logits_from_h(params: LSTMParams, h: torch.Tensor, cfg: ModelConfig):
    """y = h @ Why + by. (..., N) -> (..., M), in the accumulation type."""
    flat = h.reshape(-1, h.shape[-1])
    y = cell_ops.matmul(flat, params.Why, cfg.cdtype) + params.by.to(cfg.adtype)
    return y.reshape(*h.shape[:-1], cfg.vocab)


def softmax_xent_bits(logits: torch.Tensor, targets: torch.Tensor):
    """Per-example -log2 p(target). logits (..., M), targets (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll / LN2


def loss_fn(
    params: LSTMParams,
    ids: torch.Tensor,           # (S, B)
    targets: torch.Tensor,       # (S, B)
    h0: torch.Tensor,
    c0: torch.Tensor,
    cfg: ModelConfig,
    cell_fn=None,
    dropout_key=None,
):
    """Training objective: (loss, ((hL, cL), mean bits/char)).

    ``loss_mode="last"`` counts only t = S-1, ``"all"`` every step; the
    loss is in bits (``loss_base="2"``) or nats (``"e"``), the metric always
    in bits. Under ``"all"`` the fused head of ``cell_fn`` takes the loss
    where its gate holds (``cell_fn.fused_head.supported``: what its kernels
    take), and raises for a CUDA tensor outside it; logits and log-softmax
    go in the open without a fused head, on the CPU outside the gate, and
    under ``"last"``."""
    h_seq, state = forward(params, ids, h0, c0, cfg, cell_fn=cell_fn,
                           dropout_key=dropout_key)
    s, b_ = ids.shape
    head_fn = getattr(cell_fn, "fused_head", None)
    if cfg.loss_mode == "last":
        logits = logits_from_h(params, h_seq[-1], cfg)
        mean_bits = torch.mean(softmax_xent_bits(logits, targets[-1]))
    elif head_fn is not None and head_fn.supported(cfg):
        bits_sum = head_fn(params, h_seq.reshape(s * b_, -1),
                           targets.reshape(-1), cfg)
        mean_bits = bits_sum / (s * b_)
    elif head_fn is not None and h_seq.is_cuda:
        raise ValueError(f"the fused head's kernels do not take a "
                         f"vocabulary of {cfg.vocab}")
    else:
        logits = logits_from_h(params, h_seq, cfg)
        mean_bits = torch.mean(softmax_xent_bits(logits, targets))
    loss = mean_bits if cfg.loss_base == "2" else mean_bits * LN2
    return loss, (state, mean_bits)


def forward_step(
    params: LSTMParams,
    ids: torch.Tensor,           # (B,) one byte per stream
    h: torch.Tensor,             # (L, B, N)
    c: torch.Tensor,             # (L, B, N)
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One timestep of every layer: (logits (B, M), (h, c))."""
    params = _substitute_tied_embed(params, cfg)
    x = None
    hs, cs = [], []
    for l, layer in enumerate(params.layers):
        if l == 0:
            g_in = layer.W[ids.long()].to(cfg.adtype)
        else:
            g_in = cell_ops.matmul(x, layer.W, cfg.cdtype)
        g_pre = (g_in + cell_ops.matmul(h[l], layer.U, cfg.cdtype)
                 + layer.b.to(cfg.adtype))
        hl, cl = cell_ops.cell_step(
            g_pre, c[l].to(cfg.adtype), cfg.hidden, cfg.cell_variant
        )
        x = hl
        hs.append(hl.to(cfg.pdtype))
        cs.append(cl.to(cfg.pdtype))
    return logits_from_h(params, x, cfg), (torch.stack(hs), torch.stack(cs))
