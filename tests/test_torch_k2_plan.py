"""K2, the layers >= 1 forward (``cuda_cell.scan_layer``): its choice of
design and the launch its card path makes.

K2 computes K9's function, g = xw_t + round(h_{t-1}) @ U_c with xw rounded
to bf16 under bf16 compute, fp32 sums and carry, the sequences in the
residual type. So under bf16 compute, wherever
``cuda_cell_tiled.tiled_fwd_plan`` gives a layout, ``scan_layer`` runs
K9's persistent kernel (``tiled_fwd_scan_launch``: one cooperative launch
a window, U's rows in shared memory, tensor-core products) with K2's own
residual type and xw stream; fp32 compute, B > 128, N not a multiple of 64
and a grid the card cannot hold keep K2's launch a step
(``lstm_fwd_scan_launch``). Only the order of the product's fp32 sums
moves: K2's plain version equals K9's bit for bit on the same inputs.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. K2's plain
version against the JAX kernel is tests/test_torch_cuda_cell.py and
tests/test_torch_dropout.py.
"""

import types

import numpy as np
import pytest
import torch

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

SMS, SMEM = 132, 232_448


def _cfg(dtype="bfloat16", residual="float32", n=1024, **kw):
    return ModelConfig(hidden=n, num_layers=3, compute_dtype=dtype,
                       residual_dtype=residual, **kw)


@pytest.mark.parametrize("b", [128, 16])   # the flagship's training, eval
def test_flagship_shapes_take_the_persistent_design(b):
    """bf16 at N = 1024: all of U's rows in shared memory, 64 blocks."""
    for residual in ("float32", "bfloat16"):
        assert ct.tiled_fwd_plan(_cfg(residual=residual), b, 1024, SMS, SMEM) == 1024


@pytest.mark.parametrize("dtype,n,b", [
    ("float32", 1024, 128),    # fp32: TF32 stays off, no tensor cores
    ("float32", 1024, 16),
    ("bfloat16", 1024, 160),   # more rows than one m tile a warp
    ("bfloat16", 96, 16),      # N not a multiple of the 64-row chunk
])
def test_per_step_design_elsewhere(dtype, n, b):
    assert ct.tiled_fwd_plan(_cfg(dtype, n=n), b, n, SMS, SMEM) is None


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
            if name == "tiled_fwd_scan_launch":
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


@pytest.mark.parametrize("dtype,n,b", [("float32", 1024, 16), ("bfloat16", 1024, 160),
                                       ("bfloat16", 96, 16)])
def test_card_path_keeps_the_per_step_kernel_elsewhere(routed, dtype, n, b):
    """fp32, B > 128, N not a multiple of 64: ``lstm_fwd_scan_launch``,
    S launches a call."""
    lib, _ = routed
    s = 4
    layer, xw, h0, c0 = _meta_layer(n, s=s, b=b)
    before = cuda_cell.scan_layer.launches
    cuda_cell.scan_layer(layer, xw, h0, c0, _cfg(dtype, n=n))
    assert [c[0] for c in lib.calls] == ["lstm_fwd_scan_launch"]
    assert cuda_cell.scan_layer.launches - before == s


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_k2_plain_version_is_k9_s(residual, variant):
    """Under bf16 compute K2's plain version and K9's compute the same
    function in the same types: equal bit for bit, with dropout too (the
    persistent kernel's sums take another order; chip_smoke.py holds it
    to this replay at 1e-4)."""
    rng = np.random.default_rng(5)
    n, s, b = 64, 6, 8
    cfg = _cfg(residual=residual, n=n, cell_variant=variant)
    t = lambda *shape, sd: torch.from_numpy(rng.normal(size=shape).astype(np.float32) * sd)
    layer = LayerParams(t(n, 4 * n, sd=0.2), t(n, 4 * n, sd=0.2), t(4 * n, sd=0.1))
    xw, h0, c0 = t(s, b, 4 * n, sd=0.7), t(b, n, sd=0.3), t(b, n, sd=0.3)
    for dropout in (None, (0.35, 77)):
        got = cuda_cell.scan_layer_plain(layer, xw, h0, c0, cfg, True, dropout)
        want = ct.tiled_scan_layer_plain(layer, xw, h0, c0, cfg, True, dropout)
        flat = lambda o: [o[0], *o[1], *o[2:]]
        for a, w in zip(flat(got), flat(want)):
            assert a.dtype == w.dtype and torch.equal(a, w)
