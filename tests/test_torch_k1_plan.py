"""K1, the layer-0 forward (``cuda_cell.embed_layer0``): its choice of
design, the launch its card path makes, its sum order, and its plain
version against the JAX kernel.

K1 computes K8's function, g = (round(h_{t-1}) @ U_c + W_c[ids_t]) + b with
W and U rounded to the compute type, b in fp32, fp32 sums and carry, the
sequences in the residual type. So under bf16 compute, wherever
``cuda_cell_tiled.split_fwd_plan`` gives a layout, ``embed_layer0`` runs
the persistent forward (``tiled_fwd_embed_launch``: one cooperative launch
a window, U's rows in shared memory, tensor-core products) with K1's own
residual type, its blocks taking a share of the batch rows where N / 16
blocks would leave most SMs idle; under fp32 compute, wherever
``split_fwd_f32_plan`` gives a layout, K8's fp32 persistent forward
(``tiled_fwd_embed_f32_launch``: N / 8 blocks of 8 units, CUDA cores) with
K1's residual type, the batch split over block rows where N / 8 blocks
would leave SMs idle. B > 128, N not a multiple of 64 (bf16), N = 2048 in
fp32 and a grid the card cannot hold keep K1's launch a step
(``lstm_fwd_embed_launch``). Every design sums (acc + W_row) + b, the JAX
kernel's dot([onehot | h], [W; U]) then + b (``pallas_cell.py:522-528``);
the fp32 persistent design's k split does not depend on the rows a block
holds, so its split layouts give the unsplit bits.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. The plain
version is held to ``pallas_embed_layer0`` in interpret mode at the JAX
package's fp32 kernel tolerance (tests/test_pallas_cell.py:60-87).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_cell import pallas_embed_layer0

from test_torch_tp_seq_f32 import f32_order_gates
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cell as cell_ops
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct

SMS, SMEM = 132, 232_448
F32 = dict(rtol=1e-5, atol=1e-6)


def _cfg(dtype="bfloat16", residual="float32", n=1024, **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual,
                       **kw)


@pytest.mark.parametrize("n,b,want", [
    (512, 128, (512, 32)),     # the bench: 4 parts of 32 rows, 128 blocks
    (512, 64, (512, 16)),      # the unroll-2 run: 4 parts of 16, 128 blocks
    (512, 16, (512, 16)),      # the 1x512 eval: one 16-row tile, 32 blocks
    (1024, 16, (1024, 16)),    # the flagship's eval: 64 blocks
    (1024, 128, (1024, 64)),   # the flagship's training: 2 parts, 128 blocks
])
def test_plan_splits_the_batch_until_half_the_sms_work(n, b, want):
    """bf16: every row of U in shared memory at N = 512 and 1024, and the
    batch split over the fewest parts whose grid reaches 66 blocks."""
    for residual in ("float32", "bfloat16"):
        assert ct.split_fwd_plan(_cfg(residual=residual, n=n), b, n, SMS, SMEM) == want
    kres, rows = want
    assert ct.persist_smem_bytes(rows, n, kres) <= SMEM
    grid = n // ct.PERSIST_UNITS * -(-b // rows)
    assert grid <= SMS and (2 * grid >= SMS or rows == 16)


@pytest.mark.parametrize("n,b", [(512, 128), (1024, 128), (1024, 16)])
def test_k2_k8_k9_keep_every_row_in_a_block(n, b):
    """The unsplit layout, K2's, K8's and K9's, is the one they had: rows
    = B and ``tiled_fwd_plan``'s kres."""
    cfg = _cfg(n=n)
    kres, rows = ct.fwd_layout(cfg, b, n, SMS, SMEM, split=False)
    assert rows == b and kres == ct.tiled_fwd_plan(cfg, b, n, SMS, SMEM)


@pytest.mark.parametrize("dtype,n,b", [
    ("float32", 512, 128),     # fp32: TF32 stays off, no tensor cores
    ("float32", 1024, 16),
    ("bfloat16", 512, 160),    # more rows than one m tile a warp
    ("bfloat16", 96, 16),      # N not a multiple of the 64-row chunk
])
def test_per_step_design_elsewhere(dtype, n, b):
    """The tensor-core plan refuses these; fp32 has a plan of its own,
    ``split_fwd_f32_plan``, which takes the fp32 shapes here (K1 no longer
    runs a launch a step there)."""
    cfg = _cfg(dtype, n=n)
    assert ct.split_fwd_plan(cfg, b, n, SMS, SMEM) is None
    f32 = ct.split_fwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert (f32 is not None) == (dtype == "float32")


def test_too_few_sms_keep_the_per_step_design():
    """N / 16 blocks must be resident at one an SM, split or not."""
    assert ct.split_fwd_plan(_cfg(), 128, 1024, 63, SMEM) is None
    assert ct.split_fwd_plan(_cfg(), 128, 1024, 64, SMEM) == (1024, 128)
    assert ct.split_fwd_plan(_cfg(), 16, 1024, 63, SMEM) is None


class _Library:
    """Stands in for the kernels' library: records each call, returns 0,
    and counts one launch where the launcher takes a count."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name in ("tiled_fwd_embed_launch", "tiled_fwd_embed_f32_launch"):
                args[-1]._obj.value += 1
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    """The card path with no card: tensors on ``meta``, each storage at an
    address of its own, the tensor behind each address kept, the H100's
    limits and the stand-in library."""
    lib = _Library()
    storages, seen = {}, {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        base = storages.setdefault(key, len(storages) + 1) << 32
        addr = base + t.storage_offset() * t.element_size()
        seen[addr] = t
        return addr

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(cuda_cell, "_kernel_types", lambda cfg, dev: (
        cuda_cell._TYPE_CODES[cfg.cdtype], cuda_cell._TYPE_CODES[cfg.rdtype]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr, seen


def _meta_layer(n, m=256, s=4, b=128):
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype,
                                                        device="meta")
    layer = LayerParams(e(m, 4 * n), e(n, 4 * n), e(4 * n))
    return layer, e(s, b, dtype=torch.int64), e(b, n), e(b, n)


@pytest.mark.parametrize("n,b", [(512, 128), (1024, 16)])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -1234567)])
def test_card_path_launches_the_persistent_kernel(routed, n, b, residual,
                                                  dropout):
    """bf16 compute at the bench's and the flagship eval's shapes: one call
    of ``tiled_fwd_embed_launch`` and nothing else, with K1's residual type
    (not the tiled family's), W and U in bf16 (new tensors: the parameters
    are fp32) and b in fp32 (read in place), the ids in int32, the plan's
    kres and rows, the dropout's scalars; one launch counted from the
    launcher's count; the sequences in the residual type, (hT, cT) in the
    param type."""
    lib, ptr, seen = routed
    cfg = _cfg(residual=residual, n=n)
    s, m = 4, 256
    layer, ids, h0, c0 = _meta_layer(n, m, s, b)
    before = cuda_cell.embed_layer0.launches
    out = cuda_cell.embed_layer0(layer, ids, h0, c0, cfg, residuals=True,
                                 dropout=dropout)
    assert cuda_cell.embed_layer0.launches - before == 1
    assert [c[0] for c in lib.calls] == ["tiled_fwd_embed_launch"]
    a = lib.calls[0][1]
    # (ctype, rtype, W, U, b, ids, hc, c, hT, hseq, cseq, gseq, hdrop, S, B,
    #  N, standard, kres, rows, seed, keep, inv, stream, launched)
    assert a[0] == 1 and a[1] == cuda_cell._TYPE_CODES[cfg.rdtype]
    for i, dtype, shape in ((2, torch.bfloat16, (m, 4 * n)),
                            (3, torch.bfloat16, (n, 4 * n)),
                            (4, torch.float32, (4 * n,)),
                            (5, torch.int32, (s, b)),
                            (6, torch.bfloat16, (2, b, n))):
        assert seen[a[i]].dtype == dtype and tuple(seen[a[i]].shape) == shape
    owned = {ptr(x) >> 32 for x in (layer.W, layer.U, layer.b, ids, h0, c0)}
    assert not {a[i] >> 32 for i in (2, 3, 5)} & owned
    assert a[4] == ptr(layer.b)   # fp32 already: read in place
    h_seq, (hT, cT), c_seq, g_seq = out[:4]
    assert a[9] == ptr(h_seq) and a[10] == ptr(c_seq) and a[11] == ptr(g_seq)
    assert a[13:19] == (s, b, n, 0) + ct.split_fwd_plan(cfg, b, n, SMS, SMEM)
    assert (a[12] is None) == (dropout is None)
    assert a[19:22] == (cuda_cell.drop_scalars(dropout) or (0, 0, 0.0))
    assert h_seq.dtype == c_seq.dtype == g_seq.dtype == cfg.rdtype
    assert hT.dtype == cT.dtype == cfg.pdtype
    if dropout is not None:
        assert a[12] == ptr(out[4]) and out[4].dtype == cfg.rdtype


@pytest.mark.parametrize("dtype,n,b", [("float32", 512, 128),
                                       ("bfloat16", 512, 160),
                                       ("bfloat16", 96, 16)])
def test_card_path_keeps_the_per_step_kernel_elsewhere(routed, dtype, n, b):
    """bf16 at B > 128 and N not a multiple of 64: ``lstm_fwd_embed_launch``,
    S launches a call. fp32 at the bench's shapes, which took it too before
    K1's fp32 persistent design, now makes one call of
    ``tiled_fwd_embed_f32_launch`` (its arguments below); the fp32 shapes
    its plan refuses keep the launch a step (further below)."""
    lib = routed[0]
    s = 4
    layer, ids, h0, c0 = _meta_layer(n, s=s, b=b)
    before = cuda_cell.embed_layer0.launches
    cuda_cell.embed_layer0(layer, ids, h0, c0, _cfg(dtype, n=n))
    f32 = dtype == "float32"
    assert [c[0] for c in lib.calls] == (["tiled_fwd_embed_f32_launch"] if f32
                                         else ["lstm_fwd_embed_launch"])
    assert cuda_cell.embed_layer0.launches - before == (1 if f32 else s)


# --- K1 under fp32 compute: K8's fp32 persistent kernel ----------------------


@pytest.mark.parametrize("n,b,want", [
    (512, 128, (64, 2, 64, 4)),    # the bench: 2 block rows of 64, 128 blocks
    (1024, 16, (16, 1, 128, 4)),   # the flagship's eval: one block row, 128
    (512, 16, (8, 1, 128, 4)),     # the 1x512 eval: 8 rows a block, 128 blocks
    (1024, 128, (128, 4, 64, 2)),  # the flagship's training: one block row
])
def test_fp32_plan_splits_the_batch_where_sms_idle(n, b, want):
    """fp32: ``split_fwd_f32_plan``'s (rows a block, rows a thread, KC,
    stages), in either residual type; the grid of N / 8 x ceil(B / rows)
    blocks is resident and reaches half the SMs; the slice of U and the
    ring fit a block."""
    for residual in ("float32", "bfloat16"):
        layout = ct.split_fwd_f32_plan(_cfg("float32", residual, n=n), b, n,
                                       SMS, SMEM)
        assert tuple(layout) == want
    rows, per, kc, stages = want
    grid = n // ct.F32_UNITS * -(-b // rows)
    assert SMS // 2 <= grid <= SMS
    assert per == ct.f32_rows_per_thread(rows)
    assert ct.f32_persist_smem_bytes(rows, n, kc, stages) <= SMEM


@pytest.mark.parametrize("b,n,sms", [
    (129, 512, SMS),     # past 4 rows a thread
    (256, 1024, SMS),
    (16, 2048, SMS),     # 256 blocks on 132 SMs (and a 256 KB slice of U)
    (128, 1024, 127),    # 128 blocks on 127 SMs
])
def test_fp32_plan_refuses(b, n, sms):
    assert ct.split_fwd_f32_plan(_cfg("float32", n=n), b, n, sms, SMEM) is None


@pytest.mark.parametrize("n,b", [(512, 128), (1024, 16), (512, 16)])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -1234567)])
def test_card_path_launches_the_fp32_persistent_kernel(routed, n, b, residual,
                                                       dropout):
    """fp32 compute at the bench's and both evals' shapes: one call of
    ``tiled_fwd_embed_f32_launch`` and nothing else, one launch counted,
    with K1's residual type (bf16 where the config says so, which the
    tiled family would not keep), W and U in fp32 cut from one stacked
    [W; U], b read in place, the ids in int32, hc (2, B, N) fp32, the
    plan's rows a block and ring, the dropout's scalars."""
    lib, ptr, seen = routed
    cfg = _cfg("float32", residual, n=n)
    s, m = 4, 256
    layer, ids, h0, c0 = _meta_layer(n, m, s, b)
    before = cuda_cell.embed_layer0.launches
    out = cuda_cell.embed_layer0(layer, ids, h0, c0, cfg, residuals=True,
                                 dropout=dropout)
    assert cuda_cell.embed_layer0.launches - before == 1
    assert [c[0] for c in lib.calls] == ["tiled_fwd_embed_f32_launch"]
    a = lib.calls[0][1]
    # (rtype, W, U, b, ids, hc, c, hT, hseq, cseq, gseq, hdrop, S, B, N,
    #  standard, rows, kc, stages, seed, keep, inv, stream, launched)
    assert a[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
    for i, dtype, shape in ((1, torch.float32, (m, 4 * n)),
                            (2, torch.float32, (n, 4 * n)),
                            (4, torch.int32, (s, b)),
                            (5, torch.float32, (2, b, n))):
        assert seen[a[i]].dtype == dtype and tuple(seen[a[i]].shape) == shape
    assert a[1] >> 32 == a[2] >> 32 and a[3] == ptr(layer.b)
    h_seq, (hT, cT), c_seq, g_seq = out[:4]
    assert a[8:11] == (ptr(h_seq), ptr(c_seq), ptr(g_seq))
    layout = ct.split_fwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert a[12:19] == (s, b, n, 0, layout.rows, layout.kc, layout.stages)
    assert (a[11] is None) == (dropout is None)
    assert a[19:22] == (cuda_cell.drop_scalars(dropout) or (0, 0, 0.0))
    assert h_seq.dtype == c_seq.dtype == g_seq.dtype == cfg.rdtype
    assert hT.dtype == cT.dtype == cfg.pdtype
    if dropout is not None:
        assert a[11] == ptr(out[4]) and out[4].dtype == cfg.rdtype


@pytest.mark.parametrize("n,b", [(512, 160), (2048, 16)])
def test_fp32_card_path_keeps_the_per_step_kernel_where_refused(routed, n, b):
    """fp32 past 128 rows or at N = 2048: ``lstm_fwd_embed_launch``, S
    launches a call, chosen by the plan before any launch."""
    lib = routed[0]
    s = 3
    layer, ids, h0, c0 = _meta_layer(n, s=s, b=b)
    before = cuda_cell.embed_layer0.launches
    cuda_cell.embed_layer0(layer, ids, h0, c0, _cfg("float32", n=n))
    assert [c[0] for c in lib.calls] == ["lstm_fwd_embed_launch"]
    assert cuda_cell.embed_layer0.launches - before == s


def test_fp32_layout_is_checked_before_the_launch(routed):
    """A split layout under bf16 compute, with more rows than the batch, or
    with rows a thread not those of its rows raises before any launch."""
    lib = routed[0]
    b, n = 16, 512
    layer, ids, h0, c0 = _meta_layer(n, s=3, b=b)
    for cfg, layout in ((_cfg("bfloat16", n=n), ct.F32Split(8, 1, 128, 4)),
                        (_cfg("float32", n=n), ct.F32Split(32, 1, 128, 4)),
                        (_cfg("float32", n=n), ct.F32Split(8, 2, 64, 4))):
        with pytest.raises(ValueError, match="no fp32 layout"):
            ct.embed_launch(cuda_cell.embed_layer0, layer, ids, h0, c0, cfg,
                            cfg.rdtype, layout, False, None)
    assert lib.calls == []


def _f32_window_replay(layer, ids, h0, c0, cfg, rows):
    """K1's fp32 persistent window replayed in blocks of ``rows`` batch
    rows: each step's gate sums in the kernel's k-split order
    (tests/test_torch_tp_seq_f32.py:f32_order_gates), then (acc + W_row) +
    b, the gates and the cell. Returns (h_seq, g_seq, hT, cT)."""
    from test_torch_tp_seq_f32 import f32_order_gates

    s, b = ids.shape
    n = cfg.hidden
    hs, gs, last = [], [], []
    for r0 in range(0, b, rows):
        blk = slice(r0, r0 + rows)
        h, c, h_rows, g_rows = h0[blk], c0[blk], [], []
        for t in range(s):
            acc = f32_order_gates(h, layer.U)
            g = cell_ops.gate_activations((acc + layer.W[ids[t, blk].long()])
                                          + layer.b, n)
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
    """The fp32 persistent K1's window replayed in its k-split order in
    blocks of 8, 32 and 128 rows gives one set of bits (a 32-row SP chunk
    the bits of its rows in the 128-row window, the 1x512 eval's 8 rows a
    block those of the unsplit layout), within rtol 1e-5 of the plain
    version, whose order differs."""
    s, b, n, m = 4, 128, 64, 32
    layer, ids, h0, c0 = _torch_layer(_inputs(s, b, n, m, 17))
    cfg = _cfg("float32", n=n, vocab=m)
    whole = _f32_window_replay(layer, ids, h0, c0, cfg, 128)
    for rows in (32, 8):
        part = _f32_window_replay(layer, ids, h0, c0, cfg, rows)
        for a, w in zip(part, whole):
            assert torch.equal(a, w), rows
    plain = cuda_cell.embed_layer0_plain(layer, ids, h0, c0, cfg, residuals=True)
    for a, w in zip(whole, (plain[0], plain[3], *plain[1])):
        torch.testing.assert_close(a, w, **F32)


def _inputs(s, b, n, m, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd=1.0: (rng.standard_normal(shape) * sd).astype(np.float32)
    return dict(W=f(m, 4 * n, sd=0.3), U=f(n, 4 * n, sd=0.3 / (n / 16) ** 0.5),
                b=f(4 * n, sd=0.3), h0=f(b, n, sd=0.5), c0=f(b, n, sd=0.5),
                ids=rng.integers(0, m, (s, b)).astype(np.int32))


def _torch_layer(x):
    layer = LayerParams(*(torch.from_numpy(x[k]) for k in ("W", "U", "b")))
    return layer, torch.from_numpy(x["ids"]), torch.from_numpy(x["h0"]), \
        torch.from_numpy(x["c0"])


@pytest.mark.parametrize("dtype,residual", [("float32", "float32"),
                                            ("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32")])
@pytest.mark.parametrize("dropout", [None, (0.35, -7)])
def test_cpu_wrapper_is_the_plain_version(dtype, residual, dropout,
                                          monkeypatch):
    """On CPU tensors ``embed_layer0`` neither builds nor loads the
    kernels' library (stubbed to raise) and returns its plain version's
    outputs bit for bit, with residuals and without."""
    def no_library():
        raise AssertionError("the kernels' library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    s, b, n, m = 5, 12, 64, 32
    layer, ids, h0, c0 = _torch_layer(_inputs(s, b, n, m, 3))
    cfg = _cfg(dtype, residual, n=n, vocab=m)
    before = cuda_cell.embed_layer0.launches
    for residuals in (False, True):
        got = cuda_cell.embed_layer0(layer, ids, h0, c0, cfg, residuals, dropout)
        want = cuda_cell.embed_layer0_plain(layer, ids, h0, c0, cfg, residuals,
                                            dropout)
        flat = lambda o: [o[0], *o[1], *o[2:]]
        assert len(flat(got)) == len(flat(want))
        for g, w in zip(flat(got), flat(want)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert cuda_cell.embed_layer0.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_plain_version_sums_acc_plus_w_then_b(dtype, variant):
    """The plain version's pre-activation is (round(h) @ U_c + W_c[ids]) +
    b in fp32, the persistent kernel's order: a step-by-step replay in
    that order equals it bit for bit, and equals K8's plain version; the
    earlier order, acc + (W_c[ids] + b), gives other bits."""
    s, b, n, m = 6, 12, 64, 32
    layer, ids, h0, c0 = _torch_layer(_inputs(s, b, n, m, 9))
    cfg = _cfg(dtype, n=n, vocab=m, cell_variant=variant)
    got = cuda_cell.embed_layer0_plain(layer, ids, h0, c0, cfg, residuals=True)
    W_c = layer.W.to(cfg.cdtype).float()
    U_c = layer.U.to(cfg.cdtype)

    def replay(order):
        h, c, hs, gs = h0, c0, [], []
        for t in range(s):
            acc = cell_ops.matmul(h, U_c, cfg.cdtype, torch.float32)
            w = W_c[ids[t].long()]
            g_pre = (acc + w) + layer.b if order == "new" else acc + (w + layer.b)
            g = cell_ops.gate_activations(g_pre, n)
            h, c = cell_ops.cell_update(g, c, n, variant)
            hs.append(h)
            gs.append(g)
        return torch.stack(hs), torch.stack(gs)

    h_new, g_new = replay("new")
    assert torch.equal(got[0], h_new) and torch.equal(got[3], g_new)
    h_old, g_old = replay("old")
    assert not torch.equal(g_old, g_new)
    k8 = ct.tiled_embed_layer0_plain(layer, ids, h0, c0, cfg, residuals=True)
    for a, w in zip([got[0], *got[1], *got[2:]], [k8[0], *k8[1], *k8[2:]]):
        assert torch.equal(a, w)


@pytest.mark.parametrize("variant", ["reference", "standard"])
@pytest.mark.parametrize("dropout", [None, (0.35, 4321)])
def test_plain_version_matches_pallas_embed_layer0(variant, dropout):
    """fp32, B = 12 (not a multiple of the 16-row m tile): the output
    stream (masked under dropout), hT and cT of the plain version against
    ``pallas_embed_layer0`` in interpret mode, rtol 1e-5."""
    s, b, n, m = 8, 12, 128, 64
    x = _inputs(s, b, n, m, 11)
    kw = dict(vocab=m, hidden=n, cell_variant=variant)
    jlayer = jmodel.LayerParams(*(jnp.asarray(x[k]) for k in ("W", "U", "b")))
    jdrop = None if dropout is None else (dropout[0],
                                          jnp.asarray([dropout[1]], jnp.int32))
    jh, (jhT, jcT) = pallas_embed_layer0(jlayer, jnp.asarray(x["ids"]),
                                         jnp.asarray(x["h0"]), jnp.asarray(x["c0"]),
                                         JConfig(**kw), dropout=jdrop)
    th, (thT, tcT) = cuda_cell.embed_layer0_plain(*_torch_layer(x),
                                                  ModelConfig(**kw),
                                                  dropout=dropout)
    for got, want in ((th, jh), (thT, jhT), (tcT, jcT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
