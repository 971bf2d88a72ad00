"""K15, the ``--tp`` window forward (``cuda_tp_seq.tp_seq_fwd``) at D = 1:
its choice of design, the launch its card path makes, and its plain
version against the JAX kernel.

At D = 1 K15 is K2's recurrence with its own types and streams
(``pallas_tp_seq.py:79-94``): xw in fp32 with the bias, round(h_{t-1})
through the exchange buffer in the compute type (seeded with h0_full),
c_prev[t] = c_{t-1} and the activated g in the residual type, h_seq in the
param type (fp32: the wrapper takes fp32 params only), hT and cT in fp32.
So under bf16 compute, wherever ``cuda_cell_tiled.split_fwd_plan`` gives a
layout, it runs the persistent tensor-core forward
(``csrc/fwd_mma.cuh:fwd_persist`` with K15's streams, through
``tp_seq_fwd_launch``); under fp32 compute, wherever
``split_fwd_f32_plan`` gives one, K9's fp32 persistent kernel in K15's
mode (``csrc/lstm_tiled_f32.cuh``, through ``tp_seq_fwd_f32_launch``);
elsewhere the cooperative CUDA-core design. At
D > 1 it takes the exchange design through the group's buffers
(tests/test_torch_tp_seq_exchange.py), and raises before any launch where
the group's cards cannot reach each other's memory.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. The plain
version is held to ``pallas_tp_seq.py``'s forward (its custom VJP's
forward, so also g and c_prev) in interpret mode at the fp32 tolerances of
tests/test_torch_tp_kernels.py.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu.ops import pallas_tp_seq as jseq

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts
from eigen_lstm_tpu_torch.parallel import mesh

SMS, SMEM = 132, 232_448
F32 = dict(rtol=1e-5, atol=1e-6)


def _cfg(dtype="bfloat16", residual="float32", n=512, **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual,
                       **kw)


def test_tp1_bench_takes_the_persistent_design():
    """bf16 at the ``--tp 1`` bench shapes (N = 512, B = 128): all of U's
    rows in shared memory, 4 parts of 32 rows, 128 blocks."""
    for residual in ("float32", "bfloat16"):
        assert ct.split_fwd_plan(_cfg(residual=residual), 128, 512, SMS, SMEM) == (512, 32)


@pytest.mark.parametrize("dtype,n,b,sms", [
    ("float32", 512, 128, SMS),    # fp32: the cooperative CUDA-core design
    ("bfloat16", 512, 160, SMS),   # more rows than one m tile a warp
    ("bfloat16", 96, 128, SMS),    # a shard of 32-unit tiles, not 64-row chunks
    ("bfloat16", 512, 128, 31),    # N / 16 = 32 blocks, not resident
])
def test_cooperative_design_elsewhere(dtype, n, b, sms):
    assert ct.split_fwd_plan(_cfg(dtype, n=n), b, n, sms, SMEM) is None


class _Library:
    """Stands in for the kernels' library: records each call, returns 0,
    counts one launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            args[-1]._obj.value += 1
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    """The card path with no card: tensors on ``meta``, each storage at an
    address of its own, the tensor behind each address kept, every
    ``t[i] = x`` recorded, the H100's limits and the stand-in library."""
    lib = _Library()
    storages, seen, stores = {}, {}, []

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        base = storages.setdefault(key, len(storages) + 1) << 32
        addr = base + t.storage_offset() * t.element_size()
        seen[addr] = t
        return addr

    setitem = torch.Tensor.__setitem__

    def record(t, key, value):
        stores.append((data_ptr(t), key, value))
        return setitem(t, key, value)

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(torch.Tensor, "__setitem__", record)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(ts, "_card", lambda cfg, dev, nd: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return lib, data_ptr, seen, stores


def _meta_window(cfg, s, b, n):
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype,
                                                        device="meta")
    return e(n, 4 * n, dtype=cfg.cdtype), e(s, b, 4 * n), e(b, n), e(b, n)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
def test_card_path_launches_the_planned_design(routed, dtype, residual):
    """The ``--tp 1`` bench shapes: one launcher call and one launch
    counted; U_c and the fp32 xw read in place; the exchange buffer (2, B,
    N) in the compute type with h0_full stored in its first half; c a copy
    of c0 in fp32; h_seq fp32, g and c_prev in the residual type, hT and cT
    fp32, each the wrapper's output. bf16: ``tp_seq_fwd_launch`` with the
    plan's kres and rows. fp32: ``tp_seq_fwd_f32_launch``, K9's fp32
    persistent kernel in K15's mode with ``split_fwd_f32_plan``'s layout
    (2 block rows of 64: 128 blocks), c coming back as cT."""
    lib, ptr, seen, stores = routed
    cfg = _cfg(dtype, residual)
    s, b, n = 5, 128, 512
    U_c, xw, h0_full, c0 = _meta_window(cfg, s, b, n)
    before = ts.tp_seq_fwd.launches
    h_seq, g_seq, c_prev, hT, cT = ts.tp_seq_fwd(U_c, xw, h0_full, c0, cfg)
    assert ts.tp_seq_fwd.launches - before == 1
    assert h_seq.dtype == hT.dtype == cT.dtype == torch.float32
    assert g_seq.dtype == c_prev.dtype == cfg.rdtype
    a = lib.calls[0][1]
    if dtype == "float32":
        assert [c[0] for c in lib.calls] == ["tp_seq_fwd_f32_launch"]
        # (rtype, U, xw, hbuf, c, hT, hseq, cprev, gseq, S, B, N, standard,
        #  rows, rows a thread, kc, stages, stream, launched)
        assert a[0] == cuda_cell._TYPE_CODES[cfg.rdtype]
        assert a[1] == ptr(U_c) and a[2] == ptr(xw)
        hbuf, c = seen[a[3]], seen[a[4]]
        assert hbuf.dtype == torch.float32 and tuple(hbuf.shape) == (2, b, n)
        assert [(k, v) for p, k, v in stores if p == a[3]] == [(0, h0_full)]
        assert c.dtype == torch.float32 and a[4] >> 32 != ptr(c0) >> 32
        assert a[4] == ptr(cT)                       # c holds cT on return
        assert a[5:9] == tuple(ptr(x) for x in (hT, h_seq, c_prev, g_seq))
        split = ct.split_fwd_f32_plan(cfg, b, n, SMS, SMEM)
        assert split == (64, 2, 64, 4)
        assert a[9:17] == (s, b, n, 0) + tuple(split)
        return
    assert [c[0] for c in lib.calls] == ["tp_seq_fwd_launch"]
    # (ctype, rtype, U, xw, hbuf, c, hseq, gseq, cprev, hT, cT, S, B, N, nd,
    #  standard, kres, rows, stream, launched)
    assert a[0] == cuda_cell._TYPE_CODES[cfg.cdtype]
    assert a[1] == cuda_cell._TYPE_CODES[cfg.rdtype]
    assert a[2] == ptr(U_c) and a[3] == ptr(xw)
    hbuf, c = seen[a[4]], seen[a[5]]
    assert hbuf.dtype == cfg.cdtype and tuple(hbuf.shape) == (2, b, n)
    assert [(k, v) for p, k, v in stores if p == a[4]] == [(0, h0_full)]
    assert c.dtype == torch.float32 and a[5] >> 32 != ptr(c0) >> 32
    assert a[6:11] == tuple(ptr(x) for x in (h_seq, g_seq, c_prev, hT, cT))
    assert a[11:18] == (s, b, n, n, 0, 512, 32)


def test_d2_still_raises(routed, monkeypatch):
    """A group of two whose cards cannot reach each other's memory (cards 0
    and 1, peer access refused): the exchange design stores into the
    peer's buffer, so the wrapper raises with the pair and names the
    per-step family, before any launch, and keeps no buffers."""
    lib = routed[0]
    lib.exchange_alloc = lambda nbytes, ptr: setattr(ptr._obj, "value", 1 << 40) or 0
    lib.exchange_ipc_handle = lambda ptr, handle: 0
    lib.exchange_can_access_peer = lambda dev, peer, can: 0   # *can stays 0
    lib.exchange_free = lambda ptr: 0

    def two_cards(row, dim, group):
        other = row.clone()
        other[0, 64] = 1
        return torch.cat([row, other], dim)

    monkeypatch.setattr(ts.mesh, "all_gather", two_cards)
    group = mesh.AxisGroup(0, 2, torch.device("cpu"))
    cfg = _cfg()
    U_c, xw, h0_full, c0 = _meta_window(cfg, 3, 16, 512)
    nd = 256
    with pytest.raises(RuntimeError, match=r"ranks \[\(0, 1\), \(1, 0\)\].*EIGEN_LSTM_TP_SEQ=0"):
        ts.tp_seq_fwd(U_c[:, :4 * nd], xw[..., :4 * nd], h0_full, c0[:, :nd],
                      cfg, group)
    assert lib.calls == [] and group.exchange == {}


@pytest.mark.parametrize("variant", ["reference", "standard"])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
def test_plain_version_matches_the_jax_forward(variant, residual):
    """fp32 compute at D = 1, B = 12: h_seq, g, c_prev (c_{t-1}: c0 at
    t = 0), hT and cT of the plain version against the forward of
    ``pallas_tp_seq.py``'s custom VJP in interpret mode, rtol 1e-5; with
    bf16 residuals g and c_prev within one bf16 ulp (rtol 2^-7, the
    largest ulp-to-value ratio: an fp32 sum taken in another order may
    flip their one rounding)."""
    s, b, n = 6, 12, 128
    rng = np.random.default_rng(17)
    f = lambda *shape, sd: (rng.standard_normal(shape) * sd).astype(np.float32)
    U, xw, h0, c0 = f(n, 4 * n, sd=0.08), f(s, b, 4 * n, sd=0.7), \
        f(b, n, sd=0.3), f(b, n, sd=0.3)
    cfg = _cfg("float32", residual, n=n, cell_variant=variant)
    fn = jseq._make_tp_seq(b, n, n, s, 1, variant, "float32", residual,
                           "float32", "model", "interpret")
    (jh, jhT, jcT), (_, jg, jcp, _, _, _) = fn.fwd(*map(jnp.asarray, (U, xw, h0, c0)))
    got = ts.tp_seq_fwd_plain(*map(torch.from_numpy, (U, xw, h0, c0)), cfg)
    assert torch.equal(got[2][0].float(), torch.from_numpy(c0).to(cfg.rdtype).float())
    for name, a, w in zip(("h_seq", "g", "c_prev", "hT", "cT"), got,
                          (jh, jg, jcp, jhT, jcT)):
        rounded = name in ("g", "c_prev")
        assert a.dtype == (cfg.rdtype if rounded else torch.float32)
        tol = dict(rtol=2.0 ** -7, atol=0) if rounded and residual == "bfloat16" else F32
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   **tol, err_msg=name)
