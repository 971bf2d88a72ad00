"""K4, the fused head's forward (``ops/head.py:head_fwd``): the design each
call reaches, the operands its CUDA-core design reads, and the order of
its sums.

K4 has two designs of one function on the card (``csrc/head.cu``): under
bf16 compute with N a multiple of 64 and M of 8 (``fwd_tensor_cores``) the
logits run on tensor cores; every fp32 call, and bf16 where the tensor
cores do not apply or are forced off (the control of chip_smoke.py's
phases 5 and 6d), take the CUDA-core design (``head_fwd_core``: 64-row
blocks, 8 x 8 register tiles, a ``cp.async`` ring), which reads h with N
padded and Why with its row pitch padded to multiples of 8 (zeros) where
they are not. Both add each 64-row block's bits in row order into a
partial, and the partials in block order. The routing is checked without
a card: tensors on ``meta``, ``Tensor.data_ptr`` giving each storage an
address of its own, a stand-in library recording the calls.

``replay`` below is the plain arithmetic in the kernels' order of the
bits' sums; it is held to ``head_fwd_plain`` in fp32 (rtol 1e-5) and
float64 (rtol 1e-12), and its total to the JAX ``_fwd_head_kernel`` in
interpret mode, as tests/test_pallas_head.py runs it (fp32, rtol 1e-5).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu.ops import pallas_head as ph
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.ops import _build, cuda_cell, head

ROWS = 64   # token rows of a K4 block, both designs


def _cfg(dtype="float32", n=512, m=256):
    return ModelConfig(vocab=m, hidden=n, compute_dtype=dtype, loss_mode="all",
                       param_dtype="float64" if dtype == "float64" else "float32")


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


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _launch(lib, cfg, t, n, m):
    Why, h = _meta(n, m, dtype=cfg.cdtype), _meta(t, n, dtype=cfg.cdtype)
    head.head_fwd(Why, _meta(m), h, _meta(t, dtype=torch.int32), cfg)
    assert [c[0] for c in lib.calls] == ["head_fwd_work_floats", "head_fwd_launch"]
    # (ctype, h, Why, by, tgt, lse, partial, bits, T, N, M, ldm, design,
    #  stream, launches)
    return lib.calls[1][1], Why, h


@pytest.mark.parametrize("dtype,n,m,design", [
    ("float32", 512, 256, 0),     # the bench
    ("float32", 1024, 256, 0),    # the flagship
    ("float32", 2048, 256, 0),    # 5b
    ("bfloat16", 512, 256, 1),    # tensor cores
    ("bfloat16", 1024, 256, 1),
    ("bfloat16", 96, 256, 0),     # N not a multiple of 64
    ("bfloat16", 512, 100, 0),    # M not a multiple of 8
])
def test_each_call_reaches_its_design(routed, dtype, n, m, design):
    """fp32 always reaches the CUDA-core design (0), bf16 the tensor cores
    (1) where ``fwd_tensor_cores`` holds, else the CUDA-core design; the
    aligned operands are read in place."""
    lib, ptr, seen = routed
    t = 300
    a, Why, h = _launch(lib, _cfg(dtype, n, m), t, n, m)
    assert a[12] == design
    if n % 8 == 0 and m % 8 == 0:
        assert a[1] == ptr(h) and a[2] == ptr(Why)
        assert a[8:12] == (t, n, m, m)


def test_forced_bf16_control_reaches_the_cuda_core_design(routed, monkeypatch):
    """With ``fwd_tensor_cores`` forced off, as chip_smoke.py's control
    does, a bf16 call at the bench's shapes launches the CUDA-core design
    on its bf16 operands."""
    lib, ptr, seen = routed
    monkeypatch.setattr(head, "fwd_tensor_cores", lambda *a: False)
    a, Why, h = _launch(lib, _cfg("bfloat16"), 12800, 512, 256)
    assert a[0] == 1 and a[12] == 0 and a[1] == ptr(h) and a[2] == ptr(Why)


@pytest.mark.parametrize("n,m,np_,ldm", [(100, 200, 104, 200), (64, 250, 64, 256),
                                         (99, 7, 104, 8), (512, 256, 512, 256)])
def test_cuda_core_operands_are_padded_to_8(routed, n, m, np_, ldm):
    """h (T, N) and Why (N, M) with N and Why's row pitch rounded up to a
    multiple of 8: the kernel gets the padded N, the real M and the pitch."""
    lib, ptr, seen = routed
    a, _, _ = _launch(lib, _cfg("float32", n, m), 77, n, m)
    assert a[8:13] == (77, np_, m, ldm, 0)
    assert tuple(seen[a[1]].shape) == (77, np_)
    assert tuple(seen[a[2]].shape) == (np_, ldm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_adds_nothing(dtype):
    """The zeros ``core_operands`` adds leave every logit as it is: the
    plain version on the padded operands (columns past M dropped) equals
    it on the originals."""
    rng = np.random.default_rng(3)
    t, n, m = 50, 100, 203
    cfg = _cfg(dtype, n, m)
    h = torch.from_numpy(rng.normal(size=(t, n)).astype(np.float32)).to(cfg.cdtype)
    Why = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32) * 0.1).to(cfg.cdtype)
    hp, Wp = head.core_operands(h, Why)
    assert hp.shape == (t, 104) and Wp.shape == (104, 208)
    assert torch.equal(hp[:, :n], h) and not hp[:, n:].any()
    assert torch.equal(Wp[:n, :m], Why) and not Wp[n:].any() and not Wp[:, m:].any()
    got = hp.float() @ Wp[:, :m].float()
    np.testing.assert_allclose(got.numpy(), (h.float() @ Why.float()).numpy(),
                               rtol=1e-6, atol=1e-6)


def _inputs(t, n, m, seed, dtype):
    rng = np.random.default_rng(seed)
    ft = np.float64 if dtype == "float64" else np.float32
    return (rng.normal(size=(n, m)).astype(ft) * 0.1,
            rng.normal(size=(m,)).astype(ft) * 0.3,
            (rng.normal(size=(t, n)) * 0.5).astype(ft),
            rng.integers(0, m, (t,)).astype(np.int32))


def replay(Why_c, by, h_c, tgt, cfg):
    """K4 in its kernels' order of the bits: each 64-row block's rows in
    order, times 1/ln 2, then the blocks in order; lse per row."""
    af = cuda_cell._acc_dtype(cfg)
    logits = h_c.to(af) @ Why_c.to(af) + by.to(af)
    mx = logits.max(-1).values
    lse = mx + torch.log(torch.exp(logits - mx[:, None]).sum(-1))
    rows = lse - logits.gather(-1, tgt.long()[:, None])[:, 0]
    bits = torch.zeros((), dtype=af)
    for r0 in range(0, rows.shape[0], ROWS):
        part = torch.zeros((), dtype=af)
        for v in rows[r0:r0 + ROWS]:
            part = part + v
        bits = bits + part * (1.0 / head.LN2)
    return bits, lse


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-12)])
def test_replay_matches_the_plain_version(dtype, rtol):
    """T = 150: two full blocks and a ragged one."""
    t, n, m = 150, 96, 256
    cfg = _cfg(dtype, n, m)
    Why, by, h, tgt = (torch.from_numpy(x) for x in _inputs(t, n, m, 2, dtype))
    got = replay(Why, by, h, tgt, cfg)
    want = head.head_fwd_plain(Why, by, h, tgt, cfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol)


def test_replay_matches_the_jax_kernel():
    """fp32, T = 150 in chunks of 50, N = 96, M = 256: the replay's bits
    against ``_fwd_head_kernel`` in interpret mode through ``_make_head``."""
    t, n, m = 150, 96, 256
    Why, by, h, tgt = _inputs(t, n, m, 4, "float32")
    f = ph._make_head(t, n, m, 50, "float32", True)
    bits_j = f(jnp.asarray(Why), jnp.asarray(by).reshape(1, m), jnp.asarray(h),
               jnp.asarray(tgt).reshape(t, 1))
    bits, _ = replay(*(torch.from_numpy(x) for x in (Why, by, h, tgt)),
                     _cfg("float32", n, m))
    np.testing.assert_allclose(float(bits), float(bits_j), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrapper_is_the_plain_version(monkeypatch, dtype):
    """On CPU tensors ``head_fwd`` loads no library and returns
    ``head_fwd_plain``'s outputs bit for bit, launching nothing."""
    def no_library():
        raise AssertionError("the kernels' library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    t, n, m = 70, 100, 200
    cfg = _cfg(dtype, n, m)
    Why, by, h, tgt = (torch.from_numpy(x) for x in _inputs(t, n, m, 6, "float32"))
    Why_c, h_c = Why.to(cfg.cdtype), h.to(cfg.cdtype)
    before = head.head_fwd.launches
    got = head.head_fwd(Why_c, by, h_c, tgt, cfg)
    want = head.head_fwd_plain(Why_c, by, h_c, tgt, cfg)
    assert head.head_fwd.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
