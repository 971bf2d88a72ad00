"""K7, the fused generation kernel (``cuda_sampler.generate``): its choice of
design, the tiles its persistent design assigns, and the launch its card
path makes.

Under bf16 compute, with N a multiple of 64, at most 128 streams and 8
layers, K7 is the persistent design of ``csrc/sampler.cu`` (``gen_persist``):
every block owns fixed tiles of every layer and of the head for the whole
call and holds as many of their weight rows in shared memory as fit, L + 1
grid barriers a token; its product is the tensor-core step of
``csrc/fwd_mma.cuh`` (16 units a tile) or, at B = 1, a gemv (8 units).
fp32 compute and shapes the plan refuses keep the first design
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
    ("float32", 1, 1024, 256, 3, SMS),      # fp32: the first design
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
    assert cs.gen_plan(_cfg(dtype, n, layers, m), b, sms, SMEM) is None


def test_a_small_shared_memory_holds_fewer_rows():
    """Where the scratch alone does not fit, the first design; below the
    H100's limit fewer resident rows, never more bytes than the limit."""
    cfg = _cfg()
    assert cs.gen_plan(cfg, 128, SMS, 40_000) is None
    lay = cs.gen_plan(cfg, 128, SMS, 120_000)
    assert 0 < lay.resident_rows < 1216 and lay.smem <= 120_000


def test_b1_design_can_be_forced():
    """chip_smoke.py times B = 1's other product through ``design``."""
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
    cfg = _cfg(n=n, layers=layers)
    lay = cs.gen_plan(cfg, b, SMS, SMEM)
    L, m = layers, 256
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
    cfg = _cfg()
    lay = cs.gen_plan(cfg, 1, SMS, SMEM)
    for blk in (0, 57, 131):
        phases = cs.block_phases(cfg, 1, lay, blk)
        left = lay.resident_rows
        for ph, (item, res, _) in enumerate(phases):
            if item is None:
                continue
            assert res == min(cs.gen_K(ph, 3, 1024), left // 64 * 64)
            left -= res


class _Library:
    """Stands in for the kernels' library: records each call; the size
    queries answer as the source's mirrors do; a launch returns 0 and adds
    one to its counter when it has one."""

    def __init__(self):
        self.calls = []

    def gen_persist_smem_bytes(self, mma, rows, hrows, n, budget):
        return cs.gen_smem_bytes("mma" if mma else "gemv", rows, hrows, n, budget)

    def gen_persist_work_bytes(self, b, n, m, layers):
        return b * m * 4 + 4 * b * n * layers * 2

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
    """bf16: one call of ``gen_persist_launch`` with the plan's layout,
    both counters one up; fp32: one call
    of ``gen_launch``, the first design, the persistent counter still."""
    lib, ptr = routed
    cfg = _cfg(dtype)
    params, first, h0, c0 = _meta_inputs(cfg, b)
    before = (cs.generate.launches, cs.generate.persistent_launches)
    out = cs._launch(params, cfg, -5, first, h0, c0, 7, 0.7, trace)
    ids, (hT, cT) = out[:2]
    assert tuple(ids.shape) == (7, b) and ids.dtype == torch.int32
    assert (len(out) == 3) == trace
    lay = cs.gen_plan(cfg, b, SMS, SMEM)
    persistent = dtype == "bfloat16"
    assert (lay is not None) == persistent
    launches = [c for c in lib.calls if c[0].endswith("launch")]
    assert [c[0] for c in launches] == (["gen_persist_launch"] if persistent
                                        else ["gen_launch"])
    assert (cs.generate.launches - before[0],
            cs.generate.persistent_launches - before[1]) == (1, int(persistent))
    a = launches[0][1]
    n = cfg.hidden
    traced = out[2] if trace else None
    if persistent:
        # (WU, b, Why, by, first, h, c, ids, work, trace_h, trace_c,
        #  L, B, N, M, length, standard, greedy, seed, inv_t, mma, rows,
        #  hrows, budget, grid, stream, launched)
        assert len(a) == 27
        assert a[7] == ptr(ids) and a[5] == ptr(hT) and a[6] == ptr(cT)
        assert a[9:11] == ((None, None) if traced is None
                           else (ptr(traced[0]), ptr(traced[1])))
        assert a[11:20] == (3, b, n, 256, 7, 0, 0, (-5) & 0xFFFFFFFF,
                            cs.inv_temperature(0.7))
        assert a[20:25] == (int(lay.design == "mma"), lay.rows,
                            lay.head_rows, lay.resident_rows, lay.grid)
    else:
        # (ctype, WU, b, Why, by, h, c, ch, ids, work, trace_h, trace_c,
        #  L, B, N, M, length, standard, greedy, seed, inv_t, stream)
        assert a[0] == 0 and a[8] == ptr(ids)
        assert a[12:21] == (3, b, n, 256, 7, 0, 0, (-5) & 0xFFFFFFFF,
                            cs.inv_temperature(0.7))


def test_card_path_on_a_refused_bf16_shape_takes_the_first_design(routed):
    """bf16 at B = 129 (more than 8 m tiles): the first design, no
    persistent launch."""
    lib, _ = routed
    cfg = _cfg()
    params, first, h0, c0 = _meta_inputs(cfg, 129)
    cs._launch(params, cfg, 0, first, h0, c0, 3, 0.0, False)
    assert [c[0] for c in lib.calls if c[0].endswith("launch")] == ["gen_launch"]
    assert lib.calls[-1][1][0] == 1   # the bf16 type code


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
    """``generate_plain`` at bf16, B = 16 (the shape the persistent design's
    tensor-core tiles take at their smallest), 3 layers of 128, 24 greedy
    tokens, against the JAX kernel in interpret mode with the JAX seed:
    token-exact."""
    kw = dict(vocab=256, hidden=128, num_layers=3, compute_dtype="bfloat16")
    jcfg, tcfg = JConfig(init_std=0.1, **kw), ModelConfig(**kw)
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
