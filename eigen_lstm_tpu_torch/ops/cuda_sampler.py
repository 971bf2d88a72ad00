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

K7 has two designs on the card (``gen_plan`` chooses from the type, the
batch, the shape and the card's SMs and shared memory, before the launch;
a failed launch raises): the persistent design of ``csrc/sampler.cuh``
(``gen_persist``: each block owns fixed columns of every layer and of the
head for the call and holds as many of their weight rows in shared memory
as fit, L + 1 grid barriers a token), in bf16 with its products on tensor
cores or at B = 1 a gemv (``csrc/sampler.cu``), in fp32 on CUDA cores,
TF32 off: at B = 1 the same gemv on fp32 rows, above it the 8 x 8
register tiles of K8's fp32 forward (``csrc/sampler_f32.cu``); elsewhere
(B > 128, N not a multiple of 64, M not a multiple of the head's tile,
more than 8 layers, more tiles a phase than SMs) the first design
(``gen_kernel``: partial sums and an epilogue phase a layer, 2L + 1
barriers a token, the weights streamed from L2 at every token).

``generate.launches`` counts kernel launches of either design, one a call;
``generate.persistent_launches`` those of the persistent design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig
from . import _build
from . import cell as cell_ops
from . import cuda_cell_tiled as ct
from .cuda_cell import _M32, _TYPE_CODES, _acc_dtype, _fmix32_torch, _mul32, _raise_on
from .head import MAX_VOCAB


def supported(cfg: ModelConfig, batch: int) -> bool:
    """What the first design takes, the whole domain of the kernel: a
    hidden width that is a multiple of 32 (a warp's lanes own 32 units of
    each gate), at most 256 bytes of vocabulary (as
    ``head.head_supported``), any batch >= 1, and an fp32 or bf16 compute
    type. It streams the weights from device memory and L2 at every token,
    so it has no capacity gate (the TPU's 13 MB VMEM budget,
    ``pallas_sampler.py:121-134``, describes the TPU). Within it
    ``gen_plan`` picks the persistent design where it gives a layout: N a
    multiple of 64, M of 64 (32 for the 8-unit tiles: the gemv and the
    fp32 product), at most 128 streams and 8 layers, each phase's tiles
    within the SMs; it holds about two thirds of the flagship's bf16
    weights (a third of its fp32 ones) on chip for the whole call."""
    return (cfg.hidden % 32 == 0 and 0 < cfg.vocab <= MAX_VOCAB
            and batch >= 1 and cfg.cdtype in _TYPE_CODES)


# The persistent design's layout, as csrc/sampler.cuh lays it out
# (gen_smem_bytes; ``_layout_checked`` holds the two equal): each block
# holds `resident_rows` weight rows ([k][gate][unit] in the compute type,
# 4 * units + pad elements a row for the tensor-core product, 4 * units for
# gemv and the fp32 product), then its scratch (the tensor-core ring of
# ``cuda_cell_tiled.persist_smem_bytes`` for the larger of rows and
# head_rows; gemv: round(x) of 2N in the compute type and the warps' sums,
# 9 x 32 fp32; the fp32 product: a ring of GEN_F32_STAGES slots, each 32 R
# rows of h by GEN_F32_KC columns, + 4 floats of pitch, and GEN_F32_KC
# weight rows, which the 4 splits' partial sums reuse), then 128 + 4 * 9
# ints (its rows' tokens, its phases' items). The designs of each compute
# type: (B = 1's, the batch's).
GEN_UNITS = {"mma": ct.PERSIST_UNITS, "gemv": 8, "ffma": ct.F32_UNITS}
GEN_PITCH = {"mma": 4 * ct.PERSIST_UNITS + ct.PERSIST_PAD, "gemv": 4 * 8,
             "ffma": 4 * ct.F32_UNITS}
GEN_DESIGNS = {torch.bfloat16: ("gemv", "mma"), torch.float32: ("gemv", "ffma")}
GEN_F32_KC, GEN_F32_STAGES = 32, 3
GEN_MAX_ROWS, GEN_MAX_LAYERS = ct.PERSIST_ROWS, 8


class GenLayout(NamedTuple):
    design: str          # "mma" (bf16 tensor cores), "gemv" (B = 1) or
                         # "ffma" (fp32 CUDA cores)
    units: int           # hidden units of a block's layer tile (x 4 gates)
    rows: int            # batch rows of a layer item
    head_rows: int       # batch rows of a head item (its tile: 4 x units logits)
    grid: int            # blocks, one a SM
    resident_rows: int   # weight rows a block holds in shared memory
    smem: int            # its bytes of dynamic shared memory


def gen_K(ph: int, L: int, n: int) -> int:
    """Phase ph's contraction: N for layer 0 (its U rows) and the head
    (ph == L), 2N for the layers between ([x_l, h_l])."""
    return n if ph in (0, L) else 2 * n


def gen_items(ph: int, L: int, b: int, n: int, m: int, units: int,
              rows: int, head_rows: int) -> int:
    """Phase ph's items: tiles of ``units`` units (the head: of the M / 4
    columns of a gate stride) times the groups of rows."""
    r = rows if ph < L else head_rows
    return (n if ph < L else m // 4) // units * -(-b // r)


def gen_scratch_bytes(design: str, rows: int, head_rows: int, n: int,
                      csize: int) -> int:
    """The product's shared memory beside the resident rows, elements of
    ``csize`` bytes (each Product's ``scratch_bytes`` in the source)."""
    if design == "mma":
        return max(ct.persist_smem_bytes(r, n, 0) for r in (rows, head_rows))
    if design == "gemv":
        return 2 * n * csize + 9 * 4 * GEN_UNITS["gemv"] * 4
    r = 32 * ct.f32_rows_per_thread(max(rows, head_rows))
    ring = GEN_F32_STAGES * (r * (GEN_F32_KC + 4) + GEN_F32_KC * GEN_PITCH["ffma"])
    return 4 * max(ring, ct.F32_SPLIT * r * GEN_PITCH["ffma"])


def gen_smem_bytes(design: str, rows: int, head_rows: int, n: int,
                   resident_rows: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """A block's dynamic shared memory in compute type ``dtype``
    (``gen_smem_bytes`` of the source)."""
    csize = torch.finfo(dtype).bits // 8
    return (csize * GEN_PITCH[design] * resident_rows
            + gen_scratch_bytes(design, rows, head_rows, n, csize)
            + (GEN_MAX_ROWS + 4 * (GEN_MAX_LAYERS + 1)) * 4)


def block_phases(cfg: ModelConfig, b: int, layout: GenLayout, block: int):
    """The kernel's assignment for one block: per phase (the layers, then
    the head) its (item or None, resident rows, first resident row). The
    items of phase p go to blocks (offset_p + i) % grid; resident rows fill
    in phase order, whole chunks of 64."""
    L, n, m = cfg.num_layers, cfg.hidden, cfg.vocab
    left, row, before, out = layout.resident_rows // ct.PERSIST_KC, 0, 0, []
    for ph in range(L + 1):
        count = gen_items(ph, L, b, n, m, layout.units, layout.rows,
                          layout.head_rows)
        i = (block - before) % layout.grid
        item = i if i < count else None
        cres = 0 if item is None else min(gen_K(ph, L, n) // ct.PERSIST_KC, left)
        out.append((item, cres * ct.PERSIST_KC, row))
        left -= cres
        row += cres * ct.PERSIST_KC
        before += count
    return out


@functools.lru_cache(maxsize=None)
def gen_plan(cfg: ModelConfig, b: int, sms: int, smem_limit: int,
             design: Optional[str] = None) -> Optional[GenLayout]:
    """K7's design at (config, batch) on a device of ``sms`` SMs whose
    blocks may take ``smem_limit`` bytes of shared memory: the persistent
    design's layout, or None for the first design.

    The persistent design needs bf16 or fp32 compute, N a multiple of the
    64-row chunk, 1 to 8 layers, at most 128 streams and 256 bytes, and
    every phase's items within one a block on a grid of one block a SM. Its
    product is ``design``, one of the type's ``GEN_DESIGNS``: by default at
    B = 1 "gemv" (8 units a tile, M a multiple of 32; it beat the
    tensor-core product at B = 1 on the H100, PERF.md §6 row 11), else in
    bf16 "mma" (the tensor-core step of ``csrc/fwd_mma.cuh``: 16 units a
    tile, M a multiple of 64) and in fp32 "ffma" (K8's fp32 product on
    CUDA cores: 8 units a tile, M a multiple of 32; TF32 stays off). A
    layer item takes ``cuda_cell_tiled.split_rows`` batch rows under mma
    (all of them where N / 16 tiles reach half the SMs, else fewer, as K1
    and K13 split) and ``f32_split_rows`` under ffma (as K1 and K15 split
    under fp32), a head item likewise over its M / 4 / units tiles. A
    block holds as many weight rows as fit beside its scratch, at most
    what its items have. Cached: ``generate`` asks for the plan at every
    call."""
    n, m, L = cfg.hidden, cfg.vocab, cfg.num_layers
    if (cfg.cdtype not in GEN_DESIGNS or n % ct.PERSIST_KC != 0
            or not 1 <= L <= GEN_MAX_LAYERS or not 1 <= b <= GEN_MAX_ROWS
            or not 0 < m <= MAX_VOCAB):
        return None
    single, batched = GEN_DESIGNS[cfg.cdtype]
    if design is None:
        # B = 1 falls back to the batch's product where gemv's tiles do
        # not fit
        first = gen_plan(cfg, b, sms, smem_limit, single) if b == 1 else None
        return first or gen_plan(cfg, b, sms, smem_limit, batched)
    if design not in GEN_DESIGNS[cfg.cdtype]:
        return None
    units = GEN_UNITS[design]
    if m % (4 * units) != 0 or (design == "gemv" and b != 1):
        return None
    if design == "gemv":
        rows = head_rows = 1
    else:
        split = ct.split_rows if design == "mma" else ct.f32_split_rows
        rows = min(b, split(b, n // units, sms))
        head_rows = min(b, split(b, m // 4 // units, sms))
    if any(gen_items(ph, L, b, n, m, units, rows, head_rows) > sms
           for ph in range(L + 1)):
        return None
    free = smem_limit - gen_smem_bytes(design, rows, head_rows, n, 0, cfg.cdtype)
    if free < 0:
        return None
    row = torch.finfo(cfg.cdtype).bits // 8 * GEN_PITCH[design]
    fit = free // row // ct.PERSIST_KC * ct.PERSIST_KC
    layout = GenLayout(design, units, rows, head_rows, sms, fit, 0)
    # no more than the most any block's items have
    need = max(sum(gen_K(ph, L, n) for ph, (item, _, _) in
                   enumerate(block_phases(cfg, b, layout._replace(
                       resident_rows=0), blk)) if item is not None)
               for blk in range(sms))
    resident = min(fit, need)
    return layout._replace(resident_rows=resident, smem=gen_smem_bytes(
        design, rows, head_rows, n, resident, cfg.cdtype))


def device_gen_plan(cfg: ModelConfig, b: int,
                    design: Optional[str] = None) -> Optional[GenLayout]:
    """``gen_plan`` with the current card's SMs and shared-memory limit."""
    return gen_plan(cfg, b, *ct._device_limits(torch.cuda.current_device()),
                    design=design)


@functools.lru_cache(maxsize=None)
def _layout_checked() -> bool:
    """Holds ``gen_smem_bytes`` to the library's layout once a process, in
    both compute types."""
    lib = _build.load_library()
    bf16, f32 = torch.bfloat16, torch.float32
    for design, rows, head_rows, n, res, dtype in (
            ("mma", 64, 16, 1024, 1216, bf16), ("mma", 128, 16, 1024, 1024, bf16),
            ("mma", 1, 1, 2048, 0, bf16), ("gemv", 1, 1, 1024, 3392, bf16),
            ("gemv", 1, 1, 1024, 1728, f32), ("ffma", 128, 32, 1024, 1280, f32),
            ("ffma", 16, 16, 512, 0, f32), ("ffma", 64, 32, 1024, 64, f32)):
        query = (lib.gen_persist_smem_bytes if dtype == bf16
                 else lib.gen_persist_f32_smem_bytes)
        if query(int(design != "gemv"), rows, head_rows, n, res) != \
                gen_smem_bytes(design, rows, head_rows, n, res, dtype):
            raise RuntimeError("gen_smem_bytes disagrees with csrc/sampler.cuh's "
                               "layout")
    return True


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


def tile_weights(packed: Packed, cfg: ModelConfig, units: int) -> torch.Tensor:
    """Every phase's product rows packed tile by tile, as the fp32
    persistent design reads them (``csrc/sampler.cuh:gen_item``): layer 0's
    U rows, each later layer's [W; U], then Why, each cut into tiles of
    ``units`` units x 4 gates (the head's gate stride M / 4), flat in
    [phase][tile][k][gate][unit] order, so that a block streams its tile's
    rows from one contiguous span."""
    n, m = cfg.hidden, cfg.vocab
    mats = [wu[m:] if l == 0 else wu
            for l, wu in enumerate(layer_weights(packed.WU, cfg))] + [packed.Why]
    return torch.cat([w.reshape(w.shape[0], 4, -1, units).permute(2, 0, 1, 3)
                      .reshape(-1) for w in mats])


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
    return _launch(params, cfg, seed, first, h0, c0, length, temperature,
                   trace)


def _launch(params, cfg: ModelConfig, seed: int, first, h0, c0, length: int,
            temperature: float, trace: bool):
    """``generate``'s card path on validated inputs: one launch of the
    design ``device_gen_plan`` chooses (None: the first design), counted
    in ``generate.launches`` (and ``generate.persistent_launches``)."""
    b = first.shape[0]
    lib = _build.load_library()
    dev = first.device
    n, m, L = cfg.hidden, cfg.vocab, cfg.num_layers
    packed = pack_weights(params, cfg)
    h = h0.to(torch.float32).contiguous().clone()
    c = c0.to(torch.float32).contiguous().clone()
    ch = first.to(torch.int32).contiguous().clone()
    ids = torch.empty(length, b, dtype=torch.int32, device=dev)
    states = None
    if trace:
        states = tuple(torch.empty(length, L, b, n, dtype=torch.float32,
                                   device=dev) for _ in range(2))
    traces = (None, None) if states is None else (s.data_ptr() for s in states)
    tail = (L, b, n, m, length, int(cfg.cell_variant == "standard"),
            int(temperature == 0.0), int(seed) & _M32,
            inv_temperature(temperature))
    stream = torch.cuda.current_stream(dev).cuda_stream
    layout = device_gen_plan(cfg, b)
    if layout is None:
        work = torch.empty(lib.gen_work_floats(b, n, m), dtype=torch.float32,
                           device=dev)
        err = lib.gen_launch(
            _TYPE_CODES[cfg.cdtype], packed.WU.data_ptr(), packed.b.data_ptr(),
            packed.Why.data_ptr(), packed.by.data_ptr(), h.data_ptr(),
            c.data_ptr(), ch.data_ptr(), ids.data_ptr(), work.data_ptr(),
            *traces, *tail, stream)
        _raise_on(err, "gen_launch")
        generate.launches += 1
        return _finish(ids, h, c, cfg, states)
    _layout_checked()
    # bf16: gen_persist_launch (sampler.cu); fp32: gen_persist_f32_launch
    # (sampler_f32.cu), its products reading the tile-packed rows; the flag
    # picks the batch's product over gemv
    if cfg.cdtype == torch.bfloat16:
        name, sizes, tiled = "gen_persist_launch", lib.gen_persist_work_bytes, ()
    else:
        name, sizes = "gen_persist_f32_launch", lib.gen_persist_f32_work_bytes
        tiled = (tile_weights(packed, cfg, layout.units),)
    work = torch.empty(sizes(b, n, m, L), dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    err = getattr(lib, name)(
        packed.WU.data_ptr(), *(t.data_ptr() for t in tiled), packed.b.data_ptr(),
        packed.Why.data_ptr(), packed.by.data_ptr(), ch.data_ptr(), h.data_ptr(),
        c.data_ptr(), ids.data_ptr(), work.data_ptr(), *traces, *tail,
        int(layout.design != "gemv"), layout.rows, layout.head_rows,
        layout.resident_rows, layout.grid, stream, ctypes.byref(launched))
    generate.launches += launched.value
    generate.persistent_launches += launched.value
    _raise_on(err, name)
    return _finish(ids, h, c, cfg, states)


generate.launches = 0
generate.persistent_launches = 0
