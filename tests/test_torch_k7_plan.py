"""K7, the fused generation kernel (``cuda_sampler.generate``): its choice of
design, the tiles its persistent design assigns, and the launch its card
path makes.

With N a multiple of 64, at most 128 streams and 8 layers, K7 is the
persistent design of ``csrc/sampler.cuh`` (``gen_persist``): every block
owns fixed tiles of every layer and of the head for the whole call and
holds as many of their weight rows in shared memory as fit, L + 1 grid
barriers a token. Under bf16 compute its product is the tensor-core step
of ``csrc/fwd_mma.cuh`` (16 units a tile) or, at B = 1, a gemv (8 units);
under fp32 compute (``csrc/sampler_f32.cu``, TF32 off) the same gemv on
fp32 rows at B = 1 and above it K8's fp32 product (8 units, 8 x 8 register
tiles on CUDA cores). Shapes the plan refuses keep the first design
(``gen_kernel``).

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage a
distinct address, and a stand-in library records the calls. The kernel reads
``pack_weights``'s matrices as they are (no host-side repacking): the tests
replay its tile arithmetic and hold the tiles to cover every column of
every layer and of the head once a group of rows. The plain version,
``generate_plain``, stays held to the JAX ``pallas_sample_ids`` in interpret
mode (here at a bf16 batch the persistent design takes, beside
tests/test_torch_sampler.py).
"""

import ctypes
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops import pallas_sampler as jps
from eigen_lstm_tpu.train import checkpoint as jckpt

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import _build
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.ops import cuda_sampler as cs
from eigen_lstm_tpu_torch.train import checkpoint as tckpt

SMS, SMEM = 132, 232_448
CSRC = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")


def _cfg(dtype="bfloat16", n=1024, layers=3, m=256):
    return ModelConfig(hidden=n, num_layers=layers, vocab=m,
                       compute_dtype=dtype)


@pytest.mark.parametrize("b,n,want", [
    # B = 1: gemv, 8 units a tile (128 tiles a layer at N = 1024)
    (1, 512, ("gemv", 8, 1, 1)),
    (1, 1024, ("gemv", 8, 1, 1)),
    # N = 2048: 256 gemv tiles would not fit 132 SMs, so the tensor cores
    (1, 2048, ("mma", 16, 1, 1)),
    # B = 16: one m tile; 64 tiles of 16 units a layer
    (16, 512, ("mma", 16, 16, 16)),
    (16, 1024, ("mma", 16, 16, 16)),
    (16, 2048, ("mma", 16, 16, 16)),
    # B = 128: the rows split until a layer's items reach half the SMs, as
    # K1 and K13 split them; the head's 4 tiles of 64 logits take 16 rows
    (128, 512, ("mma", 16, 32, 16)),
    (128, 1024, ("mma", 16, 64, 16)),
    (128, 2048, ("mma", 16, 128, 16)),
])
def test_bf16_takes_the_persistent_design(b, n, want):
    lay = cs.gen_plan(_cfg(n=n), b, SMS, SMEM)
    assert (lay.design, lay.units, lay.rows, lay.head_rows) == want
    assert lay.grid == SMS
    assert lay.resident_rows % 64 == 0 and lay.resident_rows > 0
    # the resident rows, the scratch and the block's tokens fit the block
    assert lay.smem == cs.gen_smem_bytes(lay.design, lay.rows, lay.head_rows,
                                         n, lay.resident_rows) <= SMEM
    L = 3
    for ph in range(L + 1):
        assert cs.gen_items(ph, L, b, n, 256, lay.units, lay.rows,
                            lay.head_rows) <= lay.grid


def test_flagship_layouts():
    """The flagship (3 x 1024, 256 bytes): B = 1 holds 3520 rows a block on
    the gemv's 64-byte rows (70 % of its 663 552 weight rows over 132
    blocks), B = 128 1216 on the tensor cores' padded 144-byte rows beside
    a ring of 3 slots of 64 rows."""
    one = cs.gen_plan(_cfg(), 1, SMS, SMEM)
    assert (one.resident_rows, one.smem) == (3520, 231_184)
    full = cs.gen_plan(_cfg(), 128, SMS, SMEM)
    assert (full.resident_rows, full.smem) == (1216, 231_056)


@pytest.mark.parametrize("dtype,b,n,m,layers,sms", [
    ("float32", 1, 1024, 256, 3, SMS),      # fp32: now its persistent design
    ("float32", 128, 1024, 256, 3, SMS),
    ("bfloat16", 129, 1024, 256, 3, SMS),   # more streams than 8 m tiles
    ("bfloat16", 256, 1024, 256, 3, SMS),
    ("bfloat16", 16, 96, 256, 3, SMS),      # N not a multiple of 64
    ("bfloat16", 1, 4096, 256, 3, SMS),     # 256 tiles a layer > 132 SMs
    ("bfloat16", 16, 1024, 256, 3, 60),     # too few SMs for 64 tiles
    ("bfloat16", 16, 1024, 96, 3, SMS),     # M not a multiple of 64
    ("bfloat16", 16, 1024, 256, 9, SMS),    # more than 8 layers
])
def test_first_design_elsewhere(dtype, b, n, m, layers, sms):
    """The bf16 shapes the plan refuses keep the first design. fp32 at the
    flagship's B = 1 and 128 took it too before fp32's persistent design:
    those two cases now take that design (gemv at B = 1, the FFMA product
    at 128); fp32's refusals are below."""
    lay = cs.gen_plan(_cfg(dtype, n, layers, m), b, sms, SMEM)
    if dtype == "float32":
        assert lay.design == ("gemv" if b == 1 else "ffma")
    else:
        assert lay is None


def test_fp32_flagship_layouts():
    """The flagship in fp32: B = 1 holds 1728 rows a block on the gemv's
    128-byte rows (a third of its 663 552 tile rows over 132 blocks, the
    rest streamed at every token); B = 128 the FFMA product, every batch
    row in a layer item (128 tiles of 8 units), the head's 8 tiles over 4
    groups of 32 rows, 1280 rows held beside a ring of 3 slots of 32 rows
    (32 R = 128 rows of h each)."""
    one = cs.gen_plan(_cfg("float32"), 1, SMS, SMEM)
    assert tuple(one) == ("gemv", 8, 1, 1, SMS, 1728, 231_184)
    full = cs.gen_plan(_cfg("float32"), 128, SMS, SMEM)
    assert tuple(full) == ("ffma", 8, 128, 32, SMS, 1280, 232_080)
    for lay, b in ((one, 1), (full, 128)):
        assert lay.smem == cs.gen_smem_bytes(lay.design, lay.rows, lay.head_rows,
                                             1024, lay.resident_rows,
                                             torch.float32) <= SMEM
        for ph in range(4):
            assert cs.gen_items(ph, 3, b, 1024, 256, 8, lay.rows,
                                lay.head_rows) <= SMS


@pytest.mark.parametrize("b,n,m,layers,sms", [
    (129, 1024, 256, 3, SMS),    # more than 128 streams
    (16, 96, 256, 3, SMS),       # N not a multiple of 64
    (1, 4096, 256, 3, SMS),      # 512 tiles a layer > 132 SMs, either product
    (16, 1024, 256, 3, 120),     # 128 tiles on 120 SMs
    (16, 1024, 100, 3, SMS),     # M not a multiple of 32
    (16, 1024, 256, 9, SMS),     # more than 8 layers
])
def test_fp32_first_design_elsewhere(b, n, m, layers, sms):
    assert cs.gen_plan(_cfg("float32", n, layers, m), b, sms, SMEM) is None


def test_fp32_designs_can_be_forced():
    """fp32's products are gemv and ffma (the tensor-core one is bf16's):
    B = 1 takes gemv, ffma where forced (chip_smoke.py's control); mma is
    refused, as ffma is in bf16; below gemv's scratch (round(x) and the
    sums, 10 000 bytes with the tokens at N = 1024) B = 1 has no layout,
    since the FFMA product's ring is larger still."""
    cfg = _cfg("float32")
    assert cs.gen_plan(cfg, 1, SMS, SMEM).design == "gemv"
    assert cs.gen_plan(cfg, 1, SMS, SMEM, design="ffma").design == "ffma"
    assert cs.gen_plan(cfg, 1, SMS, SMEM, design="mma") is None
    assert cs.gen_plan(cfg, 16, SMS, SMEM, design="gemv") is None
    assert cs.gen_plan(_cfg(), 1, SMS, SMEM, design="ffma") is None
    assert cs.gen_plan(cfg, 1, SMS, 10_000).resident_rows == 0
    assert cs.gen_plan(cfg, 1, SMS, 9_999) is None


def _sampler_f32_constant(name):
    src = open(os.path.join(CSRC, "sampler_f32.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_fp32_shared_memory_mirror_arithmetic():
    """The fp32 products' scratch as sampler_f32.cu lays it out: gemv
    round(x) of 2N floats and 9 x 32 floats of sums; ffma a ring of
    kGFStages slots, each 32 R rows of kGFKC + 4 floats and kGFKC weight
    rows of 32 floats, or the 4 splits' 32 R x 32 partial sums if larger;
    then the resident rows of 128 bytes and the 164 ints."""
    assert (_sampler_f32_constant("kGFKC"), _sampler_f32_constant("kGFStages"),
            _sampler_f32_constant("kGFSplit")) == (cs.GEN_F32_KC,
                                                    cs.GEN_F32_STAGES, ct.F32_SPLIT)
    f32 = torch.float32
    for n in (512, 1024):
        assert cs.gen_smem_bytes("gemv", 1, 1, n, 64, f32) == \
            64 * 128 + 8 * n + 9 * 32 * 4 + 164 * 4
    for rows, hrows, r in ((16, 4, 1), (64, 32, 2), (128, 32, 4), (100, 25, 4)):
        ring = 3 * (32 * r * 36 + 32 * 32) * 4
        assert ring >= 4 * 32 * r * 32 * 4
        assert cs.gen_smem_bytes("ffma", rows, hrows, 1024, 640, f32) == \
            640 * 128 + ring + 164 * 4
    # bf16's gemv is unchanged by the type argument's default
    assert cs.gen_smem_bytes("gemv", 1, 1, 1024, 3520) == 3520 * 64 + 4096 + 1152 + 656


def test_a_small_shared_memory_holds_fewer_rows():
    """Where the scratch alone does not fit, the first design; below the
    H100's limit fewer resident rows, never more bytes than the limit."""
    cfg = _cfg()
    assert cs.gen_plan(cfg, 128, SMS, 40_000) is None
    lay = cs.gen_plan(cfg, 128, SMS, 120_000)
    assert 0 < lay.resident_rows < 1216 and lay.smem <= 120_000


def test_b1_design_can_be_forced():
    """chip_smoke.py checks B = 1's other product through ``design``."""
    cfg = _cfg()
    assert cs.gen_plan(cfg, 1, SMS, SMEM, design="mma").design == "mma"
    assert cs.gen_plan(cfg, 1, SMS, SMEM, design="gemv").design == "gemv"
    assert cs.gen_plan(cfg, 16, SMS, SMEM, design="gemv") is None


def _item_columns(cfg, b, lay, ph, item):
    """The kernel's gen_item: (first column of each gate, units, rows)."""
    L, n, m = cfg.num_layers, cfg.hidden, cfg.vocab
    gs = n if ph < L else m // 4
    tiles = gs // lay.units
    rows = lay.rows if ph < L else lay.head_rows
    j0, b0 = item % tiles * lay.units, item // tiles * rows
    return [g * gs + j0 for g in range(4)], range(b0, min(b, b0 + rows))


@pytest.mark.parametrize("b,n,layers", [(1, 1024, 3), (128, 1024, 3),
                                        (16, 512, 2), (128, 2048, 1),
                                        (1, 2048, 3)])
def test_tiles_cover_every_column_once(b, n, layers):
    """Every (row, column) of every layer's 4N gate sums and of the head's
    M logits belongs to exactly one block; a block has at most one item a
    phase; its resident rows stay within its budget and within its items'
    rows; the gates of a tile are the same units (the cell update runs in
    the block)."""
    _cover_every_column_once(_cfg(n=n, layers=layers), b)


@pytest.mark.parametrize("b,n,layers", [(1, 1024, 3), (128, 1024, 3),
                                        (16, 512, 2), (100, 512, 3),
                                        (1, 512, 1)])
def test_fp32_tiles_cover_every_column_once(b, n, layers):
    """The same rules for fp32's layouts (gemv at B = 1; the FFMA product's
    8-unit tiles and f32_split_rows' row groups above it)."""
    cfg = _cfg("float32", n=n, layers=layers)
    assert cs.gen_plan(cfg, b, SMS, SMEM).design == ("gemv" if b == 1 else "ffma")
    _cover_every_column_once(cfg, b)


def _cover_every_column_once(cfg, b):
    lay = cs.gen_plan(cfg, b, SMS, SMEM)
    L, m, n = cfg.num_layers, 256, cfg.hidden
    for ph in range(L + 1):
        width = 4 * n if ph < L else m
        owner = np.full((b, width), -1)
        for blk in range(lay.grid):
            item, res, first = cs.block_phases(cfg, b, lay, blk)[ph]
            if item is None:
                assert res == 0
                continue
            assert 0 <= item < cs.gen_items(ph, L, b, n, m, lay.units,
                                             lay.rows, lay.head_rows)
            assert res <= cs.gen_K(ph, L, n) and res % 64 == 0
            starts, rows = _item_columns(cfg, b, lay, ph, item)
            for s in starts:
                cols = slice(s, s + lay.units)
                assert (owner[rows, cols] == -1).all()
                owner[rows, cols] = blk
            # the four gates of one unit in one block
            assert len({s % (n if ph < L else m // 4) for s in starts}) == 1
        assert (owner >= 0).all()
    for blk in range(lay.grid):
        phases = cs.block_phases(cfg, b, lay, blk)
        held = sum(res for _, res, _ in phases)
        assert held <= lay.resident_rows
        # contiguous, in phase order
        at = 0
        for _, res, first in phases:
            assert first == at
            at += res


def test_resident_rows_fill_in_phase_order():
    """The flagship at B = 1: a block holds its earlier phases' rows whole
    before a later phase's; the budget is the most any block's items
    need, capped by shared memory."""
    _fill_in_phase_order(_cfg(), 1)


@pytest.mark.parametrize("b", [1, 128])
def test_fp32_resident_rows_fill_in_phase_order(b):
    """The fp32 flagship: layer 0's tiles whole (1024 rows), then as much
    of layer 1's as the budget leaves; over the grid 29.2 MB of the 89.1
    MB of weights at B = 1."""
    cfg = _cfg("float32")
    lay = _fill_in_phase_order(cfg, b)
    held = sum(res for blk in range(SMS)
               for _, res, _ in cs.block_phases(cfg, b, lay, blk))
    if b == 1:
        assert held * 128 == 29_196_288
        phases = cs.block_phases(cfg, b, lay, 0)
        assert [res for _, res, _ in phases] == [1024, 704, 0, 0]


def _fill_in_phase_order(cfg, b):
    lay = cs.gen_plan(cfg, b, SMS, SMEM)
    for blk in (0, 57, 131):
        phases = cs.block_phases(cfg, b, lay, blk)
        left = lay.resident_rows
        for ph, (item, res, _) in enumerate(phases):
            if item is None:
                continue
            assert res == min(cs.gen_K(ph, 3, 1024), left // 64 * 64)
            left -= res
    return lay


class _Library:
    """Stands in for the kernels' library: records each call; the size
    queries answer as the source's mirrors do; a launch returns 0 and adds
    one to its counter when it has one."""

    def __init__(self):
        self.calls = []

    def gen_persist_smem_bytes(self, mma, rows, hrows, n, budget):
        return cs.gen_smem_bytes("mma" if mma else "gemv", rows, hrows, n, budget)

    def gen_persist_f32_smem_bytes(self, ffma, rows, hrows, n, budget):
        return cs.gen_smem_bytes("ffma" if ffma else "gemv", rows, hrows, n,
                                 budget, torch.float32)

    def gen_persist_work_bytes(self, b, n, m, layers):
        return b * m * 4 + 4 * b * n * layers * 2

    def gen_persist_f32_work_bytes(self, b, n, m, layers):
        return b * m * 4 + 8 * b * n * layers * 2

    def gen_work_floats(self, b, n, m):
        return 8 * b * 4 * n + 4 * b * m

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if hasattr(args[-1], "_obj"):
                args[-1]._obj.value += 1
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    lib = _Library()
    storages = {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        base = storages.setdefault(key, len(storages) + 1) << 32
        return base + t.storage_offset() * t.element_size()

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr


def _meta_inputs(cfg, b):
    params = tmodel.init_params(cfg, device="meta")
    h0, c0 = tmodel.init_state(cfg, b, device="meta")
    first = torch.empty(b, dtype=torch.int32, device="meta")
    return params, first, h0, c0


@pytest.mark.parametrize("dtype,b,trace", [("bfloat16", 1, False),
                                           ("bfloat16", 128, True),
                                           ("bfloat16", 16, False),
                                           ("float32", 1, False),
                                           ("float32", 128, True)])
def test_card_path_launches_the_planned_design(routed, dtype, b, trace):
    """One call of the type's persistent launcher with the plan's layout,
    both counters one up: bf16 ``gen_persist_launch`` (flag 1: mma), fp32
    ``gen_persist_f32_launch`` (flag 1: ffma; before fp32's persistent
    design, fp32 made one call of ``gen_launch`` here); the work buffer the
    library's size for the type."""
    lib, ptr = routed
    cfg = _cfg(dtype)
    params, first, h0, c0 = _meta_inputs(cfg, b)
    before = (cs.generate.launches, cs.generate.persistent_launches)
    out = cs._launch(params, cfg, -5, first, h0, c0, 7, 0.7, trace)
    ids, (hT, cT) = out[:2]
    assert tuple(ids.shape) == (7, b) and ids.dtype == torch.int32
    assert (len(out) == 3) == trace
    lay = cs.gen_plan(cfg, b, SMS, SMEM)
    assert lay is not None
    launcher = "gen_persist_launch" if dtype == "bfloat16" else "gen_persist_f32_launch"
    launches = [c for c in lib.calls if c[0].endswith("launch")]
    assert [c[0] for c in launches] == [launcher]
    assert (cs.generate.launches - before[0],
            cs.generate.persistent_launches - before[1]) == (1, 1)
    a = launches[0][1]
    n = cfg.hidden
    traced = out[2] if trace else None
    if dtype == "float32":
        # the tile-packed rows after WU: a new fp32 buffer of the products'
        # rows (U of layer 0, [W; U] of layers 1 and 2, Why)
        assert a[1] >> 32 not in {a[0] >> 32, a[2] >> 32, a[3] >> 32}
        a = a[:1] + a[2:]
    # (WU, b, Why, by, first, h, c, ids, work, trace_h, trace_c,
    #  L, B, N, M, length, standard, greedy, seed, inv_t, mma or ffma,
    #  rows, hrows, budget, grid, stream, launched)
    assert len(a) == 27
    assert a[7] == ptr(ids) and a[5] == ptr(hT) and a[6] == ptr(cT)
    assert a[9:11] == ((None, None) if traced is None
                       else (ptr(traced[0]), ptr(traced[1])))
    assert a[11:20] == (3, b, n, 256, 7, 0, 0, (-5) & 0xFFFFFFFF,
                        cs.inv_temperature(0.7))
    assert a[20:25] == (int(lay.design != "gemv"), lay.rows,
                        lay.head_rows, lay.resident_rows, lay.grid)
    sizes = (lib.gen_persist_work_bytes if dtype == "bfloat16"
             else lib.gen_persist_f32_work_bytes)
    owner = [c for c in lib.calls if c[0] == "gen_persist_work_bytes"]
    assert owner == []   # a size query answered by the stand-in, not recorded
    assert sizes(b, n, 256, 3) == b * 256 * 4 + (4 if dtype == "bfloat16" else 8) \
        * b * n * 3 * 2


def test_card_path_on_a_refused_bf16_shape_takes_the_first_design(routed):
    """bf16 at B = 129 (more than 8 m tiles): the first design, no
    persistent launch."""
    lib, _ = routed
    cfg = _cfg()
    params, first, h0, c0 = _meta_inputs(cfg, 129)
    cs._launch(params, cfg, 0, first, h0, c0, 3, 0.0, False)
    assert [c[0] for c in lib.calls if c[0].endswith("launch")] == ["gen_launch"]
    assert lib.calls[-1][1][0] == 1   # the bf16 type code


@pytest.mark.parametrize("b,n", [(129, 1024), (16, 96)])
def test_card_path_on_a_refused_fp32_shape_takes_the_first_design(routed, b, n):
    """fp32 past 128 streams or at N not a multiple of 64: one call of
    ``gen_launch`` with the fp32 type code, chosen by the plan before the
    launch; the persistent counter stays."""
    lib, _ = routed
    cfg = _cfg("float32", n=n)
    params, first, h0, c0 = _meta_inputs(cfg, b)
    before = cs.generate.persistent_launches
    cs._launch(params, cfg, 0, first, h0, c0, 3, 0.0, False)
    assert [c[0] for c in lib.calls if c[0].endswith("launch")] == ["gen_launch"]
    assert lib.calls[-1][1][0] == 0   # the fp32 type code
    assert cs.generate.persistent_launches == before


_C_TYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
            "int": ctypes.c_int, "unsigned": ctypes.c_uint,
            "float": ctypes.c_float, "int*": ctypes.POINTER(ctypes.c_int)}


@pytest.mark.parametrize("name", ["gen_launch", "gen_persist_launch",
                                  "gen_persist_smem_bytes",
                                  "gen_persist_work_bytes", "gen_work_floats"])
def test_signatures_match_the_source(name):
    """``_build.SIGNATURES`` gives K7's entry points the argument types
    that ``csrc/sampler.cu`` declares, in order, and the plan's answer is
    cached (one object for one question)."""
    src = open(os.path.join(os.path.dirname(_build.__file__), os.pardir,
                            "csrc", "sampler.cu")).read()
    decl = re.search(r'extern "C" \w+ ' + name + r"\(([^)]*)\)", src)
    params = [re.sub(r"\s+", " ", a).strip() for a in decl.group(1).split(",")]
    types_ = [_C_TYPES[re.sub(r"\s*\w+$", "", a).replace(" *", "*")]
              for a in params]
    assert _build.SIGNATURES[name][1] == types_
    assert cs.gen_plan(_cfg(), 128, SMS, SMEM) is cs.gen_plan(_cfg(), 128,
                                                               SMS, SMEM)


@pytest.mark.parametrize("name", ["gen_persist_f32_launch",
                                  "gen_persist_f32_smem_bytes",
                                  "gen_persist_f32_work_bytes"])
def test_fp32_signatures_match_the_source(name):
    """``_build.SIGNATURES`` gives K7's fp32 entry points the argument types
    that ``csrc/sampler_f32.cu`` declares, in order; the fp32 launcher's
    are the bf16 one's."""
    src = open(os.path.join(CSRC, "sampler_f32.cu")).read()
    decl = re.search(r'extern "C" \w+ ' + name + r"\(([^)]*)\)", src)
    params = [re.sub(r"\s+", " ", a).strip() for a in decl.group(1).split(",")]
    types_ = [_C_TYPES[re.sub(r"\s*\w+$", "", a).replace(" *", "*")]
              for a in params]
    assert _build.SIGNATURES[name][1] == types_
    restype, args = _build.SIGNATURES[name.replace("_f32", "")]
    if name == "gen_persist_f32_launch":   # the tile-packed rows after WU
        args = args[:1] + [ctypes.c_void_p] + args[1:]
    assert _build.SIGNATURES[name] == (restype, args)


@pytest.mark.parametrize("n,m,layers", [(64, 64, 3), (128, 256, 2), (64, 32, 1)])
def test_tile_weights_hold_each_tile_contiguous(n, m, layers):
    """``tile_weights`` puts weight w[k][gate * gs + tile * 8 + u] of phase
    ph (layer 0's U rows, a later layer's [W; U], Why with gs = M / 4) at
    the offset the kernel's gen_item gives it: 4N times the K of the
    phases before, then tile * K * 32 + k * 32 + gate * 8 + u."""
    cfg = _cfg("float32", n, layers, m)
    packed = cs.pack_weights(tmodel.init_params(cfg, device="cpu"), cfg)
    tiled = cs.tile_weights(packed, cfg, 8)
    mats = [wu[m:] if l == 0 else wu
            for l, wu in enumerate(cs.layer_weights(packed.WU, cfg))] + [packed.Why]
    before = 0
    for ph, w in enumerate(mats):
        k_rows, gs = w.shape[0], w.shape[1] // 4
        assert k_rows == cs.gen_K(ph, layers, n)
        base = 4 * n * before
        t = tiled[base:base + w.numel()].reshape(gs // 8, k_rows, 4, 8)
        for tile in (0, gs // 8 - 1):
            for g in range(4):
                cols = g * gs + tile * 8 + torch.arange(8)
                assert torch.equal(t[tile, :, g, :], w[:, cols])
        before += k_rows
    assert tiled.numel() == 4 * n * (before - n) + n * m   # the head's M columns last


def test_fp32_kernel_reads_its_inputs_through_l2_and_keeps_tf32_off():
    """The fp32 products read the inputs' slots, which the launch writes,
    through cp.async.cg alone (no __ldg of x), the weights through the
    read-only path or cp.async; no tensor-core instruction (no mma, no
    wmma, no TF32) appears in sampler_f32.cu, and its k split is K8's:
    split s the k with (k mod 32) / 8 = s, the partials added in split
    order."""
    src = open(os.path.join(CSRC, "sampler_f32.cu")).read()
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.search(r"\bmma|wmma|tf32|ldmatrix", code)
    assert "__ldg" not in code and "__ldcg" not in code
    assert "cp_async_16(st + r * kGFPitch + 4 * q,\n                    x + " in code
    assert "const int split = tid / 64, pu = tid % 4, pq = tid % 64 / 4;" in code
    assert "split * kGFSplitK" in code
    assert "s[g] = ((v[0] + v[sp]) + v[2 * sp]) + v[3 * sp];" in code
    header = re.sub(r"//[^\n]*", "", open(os.path.join(CSRC, "sampler.cuh")).read())
    # the slots and the scores are read through L2 only, the weights not
    # from L1 either
    assert "__ldcg(p.scores" in header and "__ldcg(p.c + idx)" in header
    assert "__ldg(reinterpret_cast<const float4*>(p))" in header


def test_layout_mirror_is_checked_against_the_library(monkeypatch):
    """``_layout_checked`` raises where the library lays out shared memory
    otherwise than ``gen_smem_bytes``."""
    lib = _Library()
    lib.gen_persist_smem_bytes = lambda *a: 1
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    cs._layout_checked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="gen_smem_bytes"):
            cs._layout_checked()
    finally:
        cs._layout_checked.cache_clear()


def test_plain_version_matches_the_jax_kernel_at_a_persistent_shape():
    """``generate_plain`` at B = 16 (the shape the persistent design's
    bf16 tensor-core tiles take at their smallest, and fp32's FFMA product
    at one 16-row group), 3 layers of 128, 24 greedy tokens, in bf16 and
    fp32, against the JAX kernel in interpret mode with the JAX seed:
    token-exact."""
    for dtype in ("bfloat16", "float32"):
        kw = dict(vocab=256, hidden=128, num_layers=3, compute_dtype=dtype)
        jcfg, tcfg = JConfig(init_std=0.1, **kw), ModelConfig(**kw)
        assert cs.gen_plan(tcfg, 16, SMS, SMEM) is not None
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(21))
        tp = tckpt.params_from_numpy(jckpt._flatten(jp, "params"), tcfg, "cpu")
        rng = np.random.default_rng(22)
        b = 16
        first = rng.integers(0, 256, b).astype(np.int32)
        h0 = (rng.standard_normal((3, b, 128)) * 0.5).astype(np.float32)
        c0 = (rng.standard_normal((3, b, 128)) * 0.5).astype(np.float32)
        key = jax.random.PRNGKey(23)
        ids_j, _ = jps.pallas_sample_ids(jp, jcfg, key, jnp.asarray(first),
                                         jnp.asarray(h0), jnp.asarray(c0), 24, 0.0)
        seed = int(jax.random.bits(key, (), jnp.uint32).astype(jnp.int32))
        ids_t, _ = cs.generate_plain(tp, tcfg, seed, torch.from_numpy(first),
                                     torch.from_numpy(h0), torch.from_numpy(c0),
                                     24, 0.0)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
