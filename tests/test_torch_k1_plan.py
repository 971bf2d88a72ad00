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
blocks would leave most SMs idle; fp32 compute, B > 128, N not a multiple
of 64 and a grid the card cannot hold keep K1's launch a step
(``lstm_fwd_embed_launch``). Both designs sum (acc + W_row) + b, the JAX
kernel's dot([onehot | h], [W; U]) then + b (``pallas_cell.py:522-528``).

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
    assert ct.split_fwd_plan(_cfg(dtype, n=n), b, n, SMS, SMEM) is None


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
            if name == "tiled_fwd_embed_launch":
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
    """fp32, B > 128, N not a multiple of 64: ``lstm_fwd_embed_launch``,
    S launches a call."""
    lib = routed[0]
    s = 4
    layer, ids, h0, c0 = _meta_layer(n, s=s, b=b)
    before = cuda_cell.embed_layer0.launches
    cuda_cell.embed_layer0(layer, ids, h0, c0, _cfg(dtype, n=n))
    assert [c[0] for c in lib.calls] == ["lstm_fwd_embed_launch"]
    assert cuda_cell.embed_layer0.launches - before == s


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
