"""K2, the layers >= 1 forward (``cuda_cell.scan_layer``): its choice of
design, the launch its card path makes, its fp32 sum order, and its fp32
plain version against the JAX kernel.

K2 computes K9's function, g = xw_t + round(h_{t-1}) @ U_c with xw rounded
to bf16 under bf16 compute, fp32 sums and carry, the sequences in the
residual type. So under bf16 compute, wherever
``cuda_cell_tiled.tiled_fwd_plan`` gives a layout, ``scan_layer`` runs
K9's persistent kernel (``tiled_fwd_scan_launch``: one cooperative launch
a window, U's rows in shared memory, tensor-core products) with K2's own
residual type and xw stream; under fp32 compute, wherever
``split_fwd_f32_plan`` gives a layout, K9's fp32 persistent kernel
(``tiled_fwd_scan_f32_launch``: N / 8 blocks of 8 units, CUDA cores) with
K2's residual type and xw stream, the batch split over block rows where
N / 8 blocks would leave SMs idle, as K1's is. B > 128, N not a multiple
of 64 (bf16), N = 2048 in fp32 and a grid the card cannot hold keep K2's
launch a step (``lstm_fwd_scan_launch``). Only the order of the product's
fp32 sums moves: K2's plain version equals K9's bit for bit on the same
inputs, and the fp32 kernel's k split does not depend on the rows a block
holds, so its split layouts give the unsplit bits.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. K2's plain
version against the JAX kernel is tests/test_torch_cuda_cell.py and
tests/test_torch_dropout.py; its fp32 sum order against
``pallas_scan_layer`` in interpret mode is here.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_cell import pallas_scan_layer

from test_torch_tp_seq_f32 import f32_order_gates
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cell as cell_ops
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

SMS, SMEM = 132, 232_448
F32 = dict(rtol=1e-5, atol=1e-6)


def _cfg(dtype="bfloat16", residual="float32", n=1024, **kw):
    return ModelConfig(hidden=n, num_layers=3, compute_dtype=dtype,
                       residual_dtype=residual, **kw)


@pytest.mark.parametrize("b", [128, 16])   # the flagship's training, eval
def test_flagship_shapes_take_the_persistent_design(b):
    """bf16 at N = 1024: all of U's rows in shared memory, 64 blocks."""
    for residual in ("float32", "bfloat16"):
        assert ct.tiled_fwd_plan(_cfg(residual=residual), b, 1024, SMS, SMEM) == 1024


def _k2_plan(cfg, b, n, sms=SMS, smem=SMEM):
    """K2's layout as ``scan_layer`` plans it: fp32 compute
    ``split_fwd_f32_plan``, bf16 ``tiled_fwd_plan``."""
    if cfg.cdtype == torch.float32:
        return ct.split_fwd_f32_plan(cfg, b, n, sms, smem)
    return ct.tiled_fwd_plan(cfg, b, n, sms, smem)


@pytest.mark.parametrize("dtype,n,b", [
    ("float32", 2048, 128),    # fp32: 256 blocks of 8 units on 132 SMs
    ("float32", 1024, 160),    # fp32: past 4 rows a thread
    ("bfloat16", 1024, 160),   # more rows than one m tile a warp
    ("bfloat16", 96, 16),      # N not a multiple of the 64-row chunk
])
def test_per_step_design_elsewhere(dtype, n, b):
    """The shapes K2's plan refuses in each type, which keep its launch a
    step; the bf16 plan never takes fp32 (TF32 stays off)."""
    cfg = _cfg(dtype, n=n)
    assert _k2_plan(cfg, b, n) is None
    assert ct.tiled_fwd_plan(_cfg("float32", n=n), b, n, SMS, SMEM) is None


@pytest.mark.parametrize("n,b,want", [
    (512, 128, (64, 2, 64, 4)),    # 6e's layer 1: 2 block rows of 64, 128 blocks
    (1024, 16, (16, 1, 128, 4)),   # the flagship's eval: one block row
    (512, 16, (8, 1, 128, 4)),     # a 2x512 eval: 8 rows a block, 128 blocks
    (1024, 128, (128, 4, 64, 2)),  # the flagship's training width: one block row
])
def test_fp32_plan_takes_k9s_kernel_with_the_batch_split(n, b, want):
    """fp32: K1's layout (``split_fwd_f32_plan``), in either residual type:
    the grid of N / 8 x ceil(B / rows) blocks resident and reaching half
    the SMs, the slice of U and the ring in a block."""
    for residual in ("float32", "bfloat16"):
        assert tuple(_k2_plan(_cfg("float32", residual, n=n), b, n)) == want
    rows, per, kc, stages = want
    assert SMS // 2 <= n // ct.F32_UNITS * -(-b // rows) <= SMS
    assert per == ct.f32_rows_per_thread(rows)
    assert ct.f32_persist_smem_bytes(rows, n, kc, stages) <= SMEM


@pytest.mark.parametrize("n,b,sms", [(1000, 16, SMS),   # N not a multiple of 32
                                     (1024, 16, 127)])  # 128 blocks on 127 SMs
def test_fp32_plan_refuses_what_the_card_cannot_hold(n, b, sms):
    assert _k2_plan(_cfg("float32", n=n), b, n, sms) is None


def test_too_few_sms_keep_the_per_step_design():
    """N / 16 blocks must be resident at one an SM."""
    assert ct.tiled_fwd_plan(_cfg(), 16, 1024, 63, SMEM) is None
    assert ct.tiled_fwd_plan(_cfg(), 16, 1024, 64, SMEM) == 1024


class _Library:
    """Stands in for the kernels' library: records each call, returns 0,
    and counts one launch where the launcher takes a count."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name in ("tiled_fwd_scan_launch", "tiled_fwd_scan_f32_launch"):
                args[-1]._obj.value += 1
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    """The card path with no card: tensors on ``meta``, each storage at an
    address of its own, the H100's limits and the stand-in library."""
    lib = _Library()
    storages = {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        base = storages.setdefault(key, len(storages) + 1) << 32
        return base + t.storage_offset() * t.element_size()

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(cuda_cell, "_kernel_types", lambda cfg, dev: (
        cuda_cell._TYPE_CODES[cfg.cdtype], cuda_cell._TYPE_CODES[cfg.rdtype]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr


def _meta_layer(n, xw_dtype=torch.float32, s=4, b=16):
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype,
                                                        device="meta")
    layer = LayerParams(e(n, 4 * n), e(n, 4 * n), e(4 * n))
    return layer, e(s, b, 4 * n, dtype=xw_dtype), e(b, n), e(b, n)


@pytest.mark.parametrize("b", [128, 16])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -1234567)])
def test_card_path_launches_k9_s_persistent_kernel(routed, b, residual, dropout):
    """bf16 compute at the flagship's shapes: one call of
    ``tiled_fwd_scan_launch`` and nothing else, with K2's residual type, U
    and xw in bf16 (new tensors: the parameters are fp32), the plan's kres,
    the dropout's scalars; one launch counted from the launcher's count;
    the sequences in the residual type, (hT, cT) in the param type."""
    lib, ptr = routed
    cfg = _cfg(residual=residual)
    s, n = 4, cfg.hidden
    layer, xw, h0, c0 = _meta_layer(n, s=s, b=b)
    before = cuda_cell.scan_layer.launches
    out = cuda_cell.scan_layer(layer, xw, h0, c0, cfg, residuals=True,
                               dropout=dropout)
    assert cuda_cell.scan_layer.launches - before == 1
    assert [c[0] for c in lib.calls] == ["tiled_fwd_scan_launch"]
    a = lib.calls[0][1]
    # (ctype, rtype, U, xw, hc, c, hT, hseq, cseq, gseq, hdrop, S, B, N,
    #  standard, kres, rows, seed, keep, inv, stream, launched)
    assert a[0] == 1 and a[1] == cuda_cell._TYPE_CODES[cfg.rdtype]
    owned = {ptr(x) >> 32 for x in (layer.W, layer.U, layer.b, xw, h0, c0)}
    assert a[2] >> 32 not in owned and a[3] >> 32 not in owned
    h_seq, (hT, cT), c_seq, g_seq = out[:4]
    assert a[7] == ptr(h_seq) and a[8] == ptr(c_seq) and a[9] == ptr(g_seq)
    assert a[11:17] == (s, b, n, 0, 1024, b)
    assert (a[10] is None) == (dropout is None)
    drop = cuda_cell.drop_scalars(dropout)
    assert a[17:20] == (drop or (0, 0, 0.0))
    assert h_seq.dtype == c_seq.dtype == g_seq.dtype == cfg.rdtype
    assert hT.dtype == cT.dtype == cfg.pdtype
    if dropout is not None:
        assert a[10] == ptr(out[4]) and out[4].dtype == cfg.rdtype


def test_card_path_takes_a_bf16_xw_as_it_is(routed):
    """An xw already in bf16 (the xw type) and 16-byte aligned is read in
    place: no copy a call."""
    lib, ptr = routed
    layer, xw, h0, c0 = _meta_layer(1024, xw_dtype=torch.bfloat16)
    cuda_cell.scan_layer(layer, xw, h0, c0, _cfg())
    assert lib.calls[0][1][3] == ptr(xw)


@pytest.mark.parametrize("dtype,n,b", [("float32", 2048, 16), ("bfloat16", 1024, 160),
                                       ("bfloat16", 96, 16)])
def test_card_path_keeps_the_per_step_kernel_elsewhere(routed, dtype, n, b):
    """fp32 at N = 2048, B > 128, N not a multiple of 64 in bf16:
    ``lstm_fwd_scan_launch``, S launches a call, chosen by the plan before
    any launch."""
    lib, _ = routed
    s = 4
    layer, xw, h0, c0 = _meta_layer(n, s=s, b=b)
    before = cuda_cell.scan_layer.launches
    cuda_cell.scan_layer(layer, xw, h0, c0, _cfg(dtype, n=n))
    assert [c[0] for c in lib.calls] == ["lstm_fwd_scan_launch"]
    assert cuda_cell.scan_layer.launches - before == s


@pytest.mark.parametrize("n,b", [(512, 128), (1024, 16), (512, 16)])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -1234567)])
def test_card_path_launches_k9s_fp32_kernel(routed, n, b, residual, dropout):
    """fp32 compute at 6e's layer, the flagship's eval and a 2x512 eval:
    one call of ``tiled_fwd_scan_f32_launch`` and nothing else, one launch
    counted, with K2's residual type, U and the xw stream in fp32 (U a new
    aligned copy, xw read in place), hc (2, B, N) fp32, the plan's rows a
    block and ring, the dropout's scalars; the sequences in the residual
    type, (hT, cT) in the param type."""
    lib, ptr = routed
    cfg = _cfg("float32", residual, n=n)
    s = 4
    layer, xw, h0, c0 = _meta_layer(n, s=s, b=b)
    before = cuda_cell.scan_layer.launches
    out = cuda_cell.scan_layer(layer, xw, h0, c0, cfg, residuals=True,
                               dropout=dropout)
    assert cuda_cell.scan_layer.launches - before == 1
    assert [c[0] for c in lib.calls] == ["tiled_fwd_scan_f32_launch"]
    a = lib.calls[0][1]
    # (rtype, U, xw, hc, c, hT, hseq, cseq, gseq, hdrop, S, B, N, standard,
    #  rows, kc, stages, seed, keep, inv, stream, launched)
    assert a[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
    assert a[2] == ptr(xw)
    h_seq, (hT, cT), c_seq, g_seq = out[:4]
    assert a[6:9] == (ptr(h_seq), ptr(c_seq), ptr(g_seq))
    layout = ct.split_fwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert a[10:17] == (s, b, n, 0, layout.rows, layout.kc, layout.stages)
    assert (a[9] is None) == (dropout is None)
    assert a[17:20] == (cuda_cell.drop_scalars(dropout) or (0, 0, 0.0))
    assert h_seq.dtype == c_seq.dtype == g_seq.dtype == cfg.rdtype
    assert hT.dtype == cT.dtype == cfg.pdtype
    if dropout is not None:
        assert a[9] == ptr(out[4]) and out[4].dtype == cfg.rdtype


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_k2_plain_version_is_k9_s(residual, variant):
    """Under bf16 compute K2's plain version and K9's compute the same
    function in the same types: equal bit for bit, with dropout too (the
    persistent kernel's sums take another order; chip_smoke.py holds it
    to this replay at 1e-4)."""
    _plain_versions_agree("bfloat16", residual, variant)


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_k2_fp32_plain_version_is_k9_s(residual, variant):
    """Under fp32 compute too, K2's plain version and K9's are one function
    in the same types (the xw stream fp32), bit for bit, with dropout."""
    _plain_versions_agree("float32", residual, variant)


def _plain_versions_agree(dtype, residual, variant):
    rng = np.random.default_rng(5)
    n, s, b = 64, 6, 8
    cfg = _cfg(dtype, residual=residual, n=n, cell_variant=variant)
    t = lambda *shape, sd: torch.from_numpy(rng.normal(size=shape).astype(np.float32) * sd)
    layer = LayerParams(t(n, 4 * n, sd=0.2), t(n, 4 * n, sd=0.2), t(4 * n, sd=0.1))
    xw, h0, c0 = t(s, b, 4 * n, sd=0.7), t(b, n, sd=0.3), t(b, n, sd=0.3)
    for dropout in (None, (0.35, 77)):
        got = cuda_cell.scan_layer_plain(layer, xw, h0, c0, cfg, True, dropout)
        want = ct.tiled_scan_layer_plain(layer, xw, h0, c0, cfg, True, dropout)
        flat = lambda o: [o[0], *o[1], *o[2:]]
        for a, w in zip(flat(got), flat(want)):
            assert a.dtype == w.dtype and torch.equal(a, w)


# --- the fp32 sum order ------------------------------------------------------


def _inputs(s, b, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: (rng.standard_normal(shape) * sd).astype(np.float32)
    return dict(U=f(n, 4 * n, sd=0.3 / (n / 16) ** 0.5), xw=f(s, b, 4 * n, sd=0.7),
                h0=f(b, n, sd=0.5), c0=f(b, n, sd=0.5))


def _f32_window_replay(U, xw, h0, c0, cfg, rows):
    """K2's fp32 persistent window (K9's kernel) replayed in blocks of
    ``rows`` batch rows: each step's gate sums in the kernel's k-split
    order (tests/test_torch_tp_seq_f32.py:f32_order_gates), then acc +
    xw_t, the gates and the cell. Returns (h_seq, g_seq, hT, cT)."""
    s, b = xw.shape[:2]
    n = cfg.hidden
    hs, gs, last = [], [], []
    for r0 in range(0, b, rows):
        blk = slice(r0, r0 + rows)
        h, c, h_rows, g_rows = h0[blk], c0[blk], [], []
        for t in range(s):
            g = cell_ops.gate_activations(f32_order_gates(h, U) + xw[t, blk], n)
            h, c = cell_ops.cell_update(g, c, n, cfg.cell_variant)
            h_rows.append(h)
            g_rows.append(g)
        hs.append(torch.stack(h_rows, 1))
        gs.append(torch.stack(g_rows, 1))
        last.append((h, c))
    cat = lambda xs: torch.cat(xs, 0).transpose(0, 1)
    return (cat(hs), cat(gs), torch.cat([x[0] for x in last]),
            torch.cat([x[1] for x in last]))


def test_fp32_sum_order_does_not_depend_on_the_rows_a_block_holds():
    """The fp32 persistent K2's window replayed in its k-split order in
    blocks of 8, 32 and 128 rows gives one set of bits (a 32-row SP chunk
    the bits of its rows in a 128-row window, a 2x512 eval's 8 rows a
    block those of the unsplit layout), within rtol 1e-5 of the plain
    version, whose order differs."""
    s, b, n = 4, 128, 32
    x = {k: torch.from_numpy(v) for k, v in _inputs(s, b, n, 23).items()}
    cfg = _cfg("float32", n=n)
    whole = _f32_window_replay(x["U"], x["xw"], x["h0"], x["c0"], cfg, 128)
    for rows in (32, 8):
        part = _f32_window_replay(x["U"], x["xw"], x["h0"], x["c0"], cfg, rows)
        for a, w in zip(part, whole):
            assert torch.equal(a, w), rows
    layer = LayerParams(torch.zeros(1), x["U"], torch.zeros(1))
    plain = cuda_cell.scan_layer_plain(layer, x["xw"], x["h0"], x["c0"], cfg,
                                       residuals=True)
    for a, w in zip(whole, (plain[0], plain[3], *plain[1])):
        torch.testing.assert_close(a, w, **F32)


@pytest.mark.parametrize("variant", ["reference", "standard"])
@pytest.mark.parametrize("rows", [8, 32])
def test_fp32_replay_matches_pallas_scan_layer(variant, rows):
    """fp32, B = 32: the kernel's window in its k-split order at ``rows``
    rows a block (a 2x512 eval's 8, an SP chunk's 32) against
    ``pallas_scan_layer`` in interpret mode: h_seq, hT and cT within rtol
    1e-5 / atol 1e-6."""
    s, b, n = 6, 32, 64
    x = _inputs(s, b, n, 29)
    kw = dict(hidden=n, num_layers=2, cell_variant=variant)
    jlayer = jmodel.LayerParams(jnp.zeros((n, 4 * n), jnp.float32),
                                jnp.asarray(x["U"]), jnp.zeros(4 * n, jnp.float32))
    jh, (jhT, jcT) = pallas_scan_layer(jlayer, jnp.asarray(x["xw"]),
                                       jnp.asarray(x["h0"]), jnp.asarray(x["c0"]),
                                       JConfig(**kw))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = _f32_window_replay(t["U"], t["xw"], t["h0"], t["c0"],
                             ModelConfig(**kw), rows)
    for a, w in ((got[0], jh), (got[2], jhT), (got[3], jcT)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32)
