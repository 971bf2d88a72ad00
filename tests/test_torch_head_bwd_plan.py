"""K5, the fused head's backward (``ops/head.py:head_bwd``): its choice of
design, the launch its card path makes, and the order of its sums.

K5 has two designs of one function on the card (``csrc/head.cu``): under
bf16 compute with N a multiple of 64 and M of 128 (``bwd_tensor_cores``)
the logits, dh and dWhy run on tensor cores and dlog goes to a (T, M) bf16
buffer; elsewhere (fp32, whose products keep TF32 off, and the other
shapes) on CUDA cores, with an fp32 dlog scratch. Both take Why as it is,
(N, M), and both take dby as the sum, in block order, of each 64-row
block's column sums of the fp32 dlog. The routing is checked without a
card: tensors on ``meta``, ``Tensor.data_ptr`` giving each storage an
address of its own, a stand-in library recording the calls.

``replay`` below is the plain arithmetic in the kernels' order; it is
held to ``head_bwd_plain`` in fp32 (rtol 1e-5) and float64 (rtol 1e-12),
and to the JAX ``_bwd_head_kernel`` in interpret mode, as
tests/test_pallas_head.py runs it, in fp32 (rtol 1e-5; each output's
atol 1e-6 of its largest magnitude, for entries near zero).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu.ops import pallas_head as ph
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.ops import _build, cuda_cell, head

ROWS = 64   # token rows of a K5 block, both designs


def _cfg(dtype="bfloat16", n=512, m=256):
    return ModelConfig(vocab=m, hidden=n, compute_dtype=dtype, loss_mode="all",
                       param_dtype="float64" if dtype == "float64" else "float32")


@pytest.mark.parametrize("name,n,m,want", [
    ("bench", 512, 256, True),       # bench.py: 1x512
    ("5b", 2048, 256, True),         # scripts/run_configs.py 5b: 1x2048
    ("flagship", 1024, 256, True),   # 3x1024
    ("n-not-64", 520, 256, False),
    ("n-32", 96, 256, False),
    ("m-200", 512, 200, False),      # atb_mma's column tiles are 128 wide
    ("m-64", 512, 64, False),
    ("m-128", 512, 128, True),
])
def test_design_choice(name, n, m, want):
    """bf16 takes the tensor cores where N % 64 == 0 and M % 128 == 0;
    fp32 never does. K4's choice beside it for the same shapes."""
    assert head.bwd_tensor_cores(_cfg("bfloat16", n, m), n, m) is want
    assert head.bwd_tensor_cores(_cfg("float32", n, m), n, m) is False
    if want:
        assert head.fwd_tensor_cores(_cfg("bfloat16", n, m), n, m)


class _Library:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 1 if name.endswith("_work_floats") else 0
        return call


@pytest.fixture
def routed(monkeypatch):
    lib = _Library()
    storages, seen = {}, {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        ptr = (storages.setdefault(key, len(storages) + 1) << 32) + \
            t.storage_offset() * t.element_size()
        seen[ptr] = t
        return ptr

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(head, "_kernel_type",
                        lambda cfg, dev: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr, seen


@pytest.mark.parametrize("dtype,n,m", [("bfloat16", 512, 256), ("bfloat16", 2048, 256),
                                       ("bfloat16", 96, 256), ("bfloat16", 512, 200),
                                       ("float32", 512, 256)])
def test_wrapper_passes_why_and_the_plan_s_flag(routed, dtype, n, m):
    """One ``head_bwd_launch`` with Why untransposed (the caller's own
    tensor), the flag ``bwd_tensor_cores`` gives, and the dlog buffer of
    that design: bf16 for the tensor cores, fp32 for the CUDA cores."""
    lib, ptr, seen = routed
    cfg = _cfg(dtype, n, m)
    t = 300
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype,
                                                        device="meta")
    Why, h = e(n, m, dtype=cfg.cdtype), e(t, n, dtype=cfg.cdtype)
    dh, dWhy, dby = head.head_bwd(Why, e(m), h, e(t, dtype=torch.int32), e(t),
                                  e(()), cfg)
    assert [c[0] for c in lib.calls] == ["head_bwd_work_floats", "head_bwd_launch"]
    assert lib.calls[0][1] == (t, n, m)
    a = lib.calls[1][1]
    # (ctype, h, Why, by, tgt, lse, cot, dlog, dh, dWhy, dby, work, T, N, M,
    #  tensor_cores, stream, launches)
    tc = head.bwd_tensor_cores(cfg, n, m)
    assert a[1] == ptr(h) and a[2] == ptr(Why)
    assert a[8] == ptr(dh) and a[9] == ptr(dWhy) and a[10] == ptr(dby)
    assert a[12:16] == (t, n, m, int(tc))
    dlog = seen[a[7]]
    assert tuple(dlog.shape) == (t, m)
    assert dlog.dtype == (torch.bfloat16 if tc else torch.float32)
    assert dh.dtype == cfg.cdtype and tuple(dWhy.shape) == (n, m)


def _inputs(t, n, m, seed, dtype):
    rng = np.random.default_rng(seed)
    ft = np.float64 if dtype == "float64" else np.float32
    return (rng.normal(size=(n, m)).astype(ft) * 0.1,
            rng.normal(size=(m,)).astype(ft) * 0.3,
            (rng.normal(size=(t, n)) * 0.5).astype(ft),
            rng.integers(0, m, (t,)).astype(np.int32))


def replay(Why_c, by, h_c, tgt, lse, cot, cfg):
    """K5 in its kernels' order: dlog in the accumulation type; dby the
    sum, in block order, of each 64-row block's column sums; dh =
    round(dlog) @ Why^T in the compute type; dWhy = h^T round(dlog)."""
    af = cuda_cell._acc_dtype(cfg)
    logits = h_c.to(af) @ Why_c.to(af) + by.to(af)
    onehot = torch.nn.functional.one_hot(tgt.long(), cfg.vocab).to(af)
    dlog = (torch.exp(logits - lse.to(af)[:, None]) - onehot) * (
        cot.to(af) * (1.0 / head.LN2))
    dby = torch.zeros(cfg.vocab, dtype=af)
    for r0 in range(0, dlog.shape[0], ROWS):
        dby = dby + dlog[r0:r0 + ROWS].sum(0)
    dlog_c = dlog.to(cfg.cdtype).to(af)
    return ((dlog_c @ Why_c.to(af).T).to(cfg.cdtype), h_c.to(af).T @ dlog_c,
            dby)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-12)])
def test_replay_matches_the_plain_version(dtype, rtol):
    """T = 150: two full blocks and a ragged one."""
    t, n, m = 150, 96, 256
    cfg = _cfg(dtype, n, m)
    Why, by, h, tgt = (torch.from_numpy(x) for x in _inputs(t, n, m, 2, dtype))
    _, lse = head.head_fwd_plain(Why, by, h, tgt, cfg)
    cot = torch.tensor(0.37, dtype=Why.dtype)
    got = replay(Why, by, h, tgt, lse, cot, cfg)
    want = head.head_bwd_plain(Why, by, h, tgt, lse, cot, cfg)
    for name, g, w in zip(("dh", "dWhy", "dby"), got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                   atol=rtol * 0.1 * float(w.abs().max()),
                                   err_msg=name)


def test_replay_matches_the_jax_kernel():
    """fp32, T = 150 in chunks of 50, N = 96, M = 256: the replay from the
    port's lse against ``_bwd_head_kernel`` in interpret mode through the
    custom VJP of ``_make_head`` (its own lse), cotangent 0.37."""
    t, n, m = 150, 96, 256
    Why, by, h, tgt = _inputs(t, n, m, 4, "float32")
    f = ph._make_head(t, n, m, 50, "float32", True)
    _, vjp = jax.vjp(lambda W, b_, x: f(W, b_, x, jnp.asarray(tgt).reshape(t, 1)),
                     jnp.asarray(Why), jnp.asarray(by).reshape(1, m), jnp.asarray(h))
    dWhy_j, dby_j, dh_j = vjp(jnp.float32(0.37))
    cfg = _cfg("float32", n, m)
    tw, tb, th, tt = (torch.from_numpy(x) for x in (Why, by, h, tgt))
    _, lse = head.head_fwd_plain(tw, tb, th, tt, cfg)
    got = replay(tw, tb, th, tt, lse, torch.tensor(0.37), cfg)
    for name, g, w in zip(("dh", "dWhy", "dby"), got,
                          (dh_j, dWhy_j, np.asarray(dby_j).reshape(m))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrapper_is_the_plain_version(monkeypatch, dtype):
    """On CPU tensors ``head_bwd`` loads no library and returns
    ``head_bwd_plain``'s outputs bit for bit, launching nothing."""
    def no_library():
        raise AssertionError("the kernels' library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    t, n, m = 70, 64, 256
    cfg = _cfg(dtype, n, m)
    Why, by, h, tgt = (torch.from_numpy(x) for x in _inputs(t, n, m, 6, "float32"))
    Why_c, h_c = Why.to(cfg.cdtype), h.to(cfg.cdtype)
    _, lse = head.head_fwd(Why_c, by, h_c, tgt, cfg)
    cot = torch.tensor(0.5)
    before = head.head_bwd.launches
    got = head.head_bwd(Why_c, by, h_c, tgt, lse, cot, cfg)
    want = head.head_bwd_plain(Why_c, by, h_c, tgt, lse, cot, cfg)
    assert head.head_bwd.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
