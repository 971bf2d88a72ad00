"""K13, the per-step tensor-parallel forward (``cuda_tp_cell.tp_step_fwd``):
its choice of design, the launch its card path makes, and how the TP
recurrence hands it U.

Under bf16 compute with at most 128 batch rows K13 is the tensor-core step
of K8/K9's persistent forward (``csrc/fwd_mma.cuh``), a block 16 units of
the shard and ``rows`` batch rows, ``rows`` chosen so that the grid reaches
half the card's SMs; under fp32 compute with at most 128 batch rows it is
one step of the fp32 persistent forward (``csrc/lstm_tp_step_f32.cu``), a
block 8 units of the shard and ``rows`` batch rows (128, 64, 32 at the
flagship's D = 1, 2, 4), its sums in the window's k-split order, so that a
window of its steps gives K15's fp32 window bits; B > 128, widths the tiles
do not take and grids the card cannot hold keep the CUDA-core design. ``parallel/tp.py:_tp_scan_layer`` casts U to the
compute type once a window and hands that U_c to every step beside U, as
an input autograd does not differentiate: dU still goes to U unrounded,
as the JAX VJP returns it (``pallas_tp_cell.py:152``), where passing only
a differentiable cast would round dU to bf16 through the cast's backward.

The device numbers are an H100 SXM's (132 SMs, 232,448 bytes of shared
memory a block may opt in to). The routing is checked without a card: the
tensors lie on the ``meta`` device, ``Tensor.data_ptr`` gives each storage
a distinct address, and a stand-in library records the calls. The
gradients are held to the JAX package's ``fused_tp_step`` VJP on the CPU
at the fp32 tolerances of tests/test_torch_tp_kernels.py; the fp32 step's
sum order, replayed over a window at D = 1 and 2, to K15's fp32 window
replay bit for bit and to the JAX ``_fwd_math`` at rtol 1e-5 / atol 1e-6.
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.ops import pallas_tp_cell as jcell

from test_torch_tp_seq_f32 import f32_fwd_replay, f32_order_gates
from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cell as cell_ops
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.ops import cuda_tp_cell as tc
from eigen_lstm_tpu_torch.parallel import tp as ttp
from eigen_lstm_tpu_torch.parallel.tp import _gate_permutation

SMS, SMEM = 132, 232_448
GRAD = dict(rtol=1e-4, atol=1e-6)
F32 = dict(rtol=1e-5, atol=1e-6)
CSRC = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")


def _cfg(dtype="bfloat16", n=1024, **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, **kw)


@pytest.mark.parametrize("ndev,rows", [(1, 64), (2, 32), (4, 16)])
def test_flagship_shards_take_the_tensor_cores(ndev, rows):
    """bf16 at the flagship's --tp shapes (N = 1024, B = 128) as a shard of
    D = 1, 2, 4: the batch split until the grid reaches 66 blocks, so 128
    blocks of 16 units at every D, U_d read 2, 4 and 8 times a step."""
    nd = 1024 // ndev
    assert tc.tp_step_plan(_cfg(), 128, 1024, nd, SMS, SMEM) == rows
    assert nd // ct.PERSIST_UNITS * -(-128 // rows) == 128


def test_a_wide_grid_keeps_every_row_in_a_block():
    """Where nd / 16 blocks reach half the SMs already, a block takes all
    the batch rows and U_d is read once a step."""
    assert tc.tp_step_plan(_cfg(), 128, 1024, 1024, 128, SMEM) == 128
    assert tc.tp_step_plan(_cfg(), 16, 1024, 1024, SMS, SMEM) == 16


@pytest.mark.parametrize("ndev,rows,kc", [(1, 128, 64), (2, 64, 64), (4, 32, 128)])
def test_fp32_flagship_shards_take_the_fp32_step(ndev, rows, kc):
    """fp32 at the flagship's --tp shapes (N = 1024, B = 128) as a shard of
    D = 1, 2, 4: the fp32 step's rows (every row where nd / 8 blocks reach
    half the SMs, else 2 or 4 block rows), 128 blocks at every D, U_d read
    1, 2 and 4 times a step; the ring of 4 slots fits a block, which holds
    no slice of U."""
    nd = 1024 // ndev
    plan = tc.tp_step_plan(_cfg("float32"), 128, 1024, nd, SMS, SMEM)
    assert plan == ct.F32Split(rows, ct.f32_rows_per_thread(rows), kc, 4)
    assert nd // ct.F32_UNITS * -(-128 // rows) == 128
    assert ct.step_f32_smem_bytes(rows, kc, 4) <= SMEM
    assert plan == tc.tp_step_f32_plan(128, 1024, nd, SMS, SMEM)


@pytest.mark.parametrize("dtype,n,nd,b,smem", [
    ("float32", 1024, 1024, 160, SMEM),    # fp32 past 4 rows a thread
    ("float32", 2048, 2048, 128, SMEM),    # 256 blocks on 132 SMs
    ("bfloat16", 1024, 1024, 160, SMEM),   # more rows than 8 m tiles
    ("bfloat16", 96, 96, 128, SMEM),       # N not a multiple of the k chunk
    ("bfloat16", 1024, 1024, 128, 40_000),  # a ring the block cannot hold
])
def test_cuda_core_design_elsewhere(dtype, n, nd, b, smem):
    assert tc.tp_step_plan(_cfg(dtype, n=n), b, n, nd, SMS, smem) is None


@pytest.mark.parametrize("n,nd,b,sms,smem", [
    (1000, 1000, 128, SMS, SMEM),   # N not a multiple of 32
    (1024, 1020, 128, SMS, SMEM),   # nd not a multiple of 8
    (1024, 1024, 128, 127, SMEM),   # 128 blocks on 127 SMs
    (1024, 1024, 128, SMS, 60_000),  # no ring fits
])
def test_fp32_step_plan_refuses(n, nd, b, sms, smem):
    assert tc.tp_step_f32_plan(b, n, nd, sms, smem) is None


def test_fp32_step_shared_memory_mirror():
    """A block's ring: 32 R rows of h (KC + 4 floats) and KC rows of U's
    32 columns a slot; the splits' partials (4 x 32 R rows of 40 floats)
    reuse it; the C side's constants are the mirror's."""
    for rows, kc, st in ((128, 64, 4), (64, 64, 4), (32, 128, 4), (16, 32, 4)):
        r = 32 * ct.f32_rows_per_thread(rows)
        want = 4 * max(st * (r * (kc + 4) + kc * 32), 4 * r * 40)
        assert ct.step_f32_smem_bytes(rows, kc, st) == want
    src = open(os.path.join(CSRC, "lstm_tp_step_f32.cu")).read()
    assert "constexpr int kStepRedPitch = kPCols + 8;" in src
    assert ct.STEP_RED_PITCH == 4 * ct.F32_UNITS + 8
    layouts = re.search(r"#define STEP_F32_LAYOUTS\(X\)(.*?)\n\n", src, re.S).group(1)
    built = {tuple(map(int, x)) for x in re.findall(r"X\((\d+), (\d+), (\d+)\)", layouts)}
    assert built == {(r, k, st) for r, rings in ct.STEP_F32_RINGS.items()
                     for k, st in rings}


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
    lib = _Library()
    storages = {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        base = storages.setdefault(key, len(storages) + 1) << 32
        return base + t.storage_offset() * t.element_size()

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(tc, "_card", lambda cfg, dev, nd: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr


def _step_call(routed, dtype, b, n, nd):
    """One ``tp_step_fwd`` call on meta tensors, U_c and h_full in the
    compute type: (config, the call's name and arguments, pointers of the
    inputs and outputs), one launch counted."""
    lib, ptr = routed
    cfg = _cfg(dtype, n=n)
    e = lambda *shape, dt=torch.float32: torch.empty(*shape, dtype=dt, device="meta")
    U_c, h = e(n, 4 * nd, dt=cfg.cdtype), e(b, n, dt=cfg.cdtype)
    xw, c = e(b, 4 * nd), e(b, nd)
    before = tc.tp_step_fwd.launches
    out = tc.tp_step_fwd(U_c, xw, h, c, cfg)
    assert tc.tp_step_fwd.launches - before == 1
    (name, args), = lib.calls
    return cfg, name, args, [ptr(x) for x in (U_c, xw, h, c, *out)]


@pytest.mark.parametrize("dtype,ndev", [("bfloat16", 1), ("bfloat16", 2),
                                        ("bfloat16", 4), ("float32", 1),
                                        ("float32", 2), ("float32", 4)])
def test_card_path_launches_the_planned_design(routed, dtype, ndev):
    """One call a step of the plan's launcher: in bf16 ``tp_step_fwd_launch``
    with the plan's rows, in fp32 ``tp_step_fwd_f32_launch`` with the
    plan's rows a block, rows a thread and ring; U_c and h_full read in
    place when they are in the compute type already (no cast a step), one
    launch counted."""
    n, b = 1024, 128
    nd = n // ndev
    cfg, name, a, ptrs = _step_call(routed, dtype, b, n, nd)
    want = tc.tp_step_plan(cfg, b, n, nd, SMS, SMEM)
    if dtype == "float32":
        assert name == "tp_step_fwd_f32_launch"
        # (U, xw, h, c_in, h_out, c_out, g_out, B, N, nd, standard, rows,
        #  R, kc, stages, stream, launched)
        assert list(a[:7]) == ptrs
        assert a[7:15] == (b, n, nd, 0, *want)
        assert isinstance(want, ct.F32Split)
    else:
        assert name == "tp_step_fwd_launch"
        # (ctype, U, xw, h, c_in, h_out, c_out, g_out, B, N, nd, standard,
        #  rows, stream, launched)
        assert a[0] == cuda_cell._TYPE_CODES[cfg.cdtype]
        assert list(a[1:8]) == ptrs
        assert a[8:13] == (b, n, nd, 0, want)


@pytest.mark.parametrize("b,n", [(160, 1024), (128, 2048)])
def test_fp32_card_path_keeps_the_cuda_core_design_where_refused(routed, b, n):
    """fp32 past 128 rows or with a grid the card cannot hold:
    ``tp_step_fwd_launch`` with rows -1 (the CUDA-core design), chosen by
    the plan before the launch."""
    _, name, a, _ = _step_call(routed, "float32", b, n, n)
    assert name == "tp_step_fwd_launch" and a[0] == 0 and a[12] == -1


def _window(s=3, b=8, n=64, seed=6):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd: rng.normal(size=shape).astype(np.float32) * sd
    return (f(n, 4 * n, sd=0.1), f(s, b, 4 * n, sd=0.7), f(b, n, sd=0.3),
            f(b, n, sd=0.3), f(s, b, n, sd=1.0))


def test_tp_scan_layer_casts_U_once_a_window(monkeypatch):
    """The per-step family hands every step of a window one U_c: U in the
    compute type, outside autograd."""
    seen = []
    step = tc.fused_tp_step

    def spy(U, xw, h_full, c_d, cfg, plain=False, U_c=None):
        seen.append(U_c)
        return step(U, xw, h_full, c_d, cfg, plain, U_c)

    monkeypatch.setattr(tc, "fused_tp_step", spy)
    U, xw, h0, c0, _ = (torch.from_numpy(x) for x in _window())
    U.requires_grad_()
    cfg = _cfg(n=U.shape[0])
    layer = LayerParams(torch.zeros(1), U, torch.zeros(1))
    with torch.enable_grad():
        ttp._tp_scan_layer(layer, xw, h0, c0, cfg, None, "pallas", plain=True)
    assert len(seen) == xw.shape[0]
    assert all(x is seen[0] for x in seen)
    assert seen[0].dtype == torch.bfloat16 and not seen[0].requires_grad
    assert torch.equal(seen[0], U.detach().bfloat16())


def _jax_window_dU(U, xw, h0, c0, cot):
    """The JAX ``fused_tp_step`` over the window at D = 1 (h_full = h),
    h and c carried in fp32, and its VJP in U for sum(h_seq * cot)."""
    jcfg = JConfig(hidden=U.shape[0], compute_dtype="bfloat16")

    def loss(U_):
        h, c, total = jnp.asarray(h0), jnp.asarray(c0), 0.0
        for t in range(xw.shape[0]):
            h, c = jcell.fused_tp_step(U_, jnp.asarray(xw[t]), h, c, jcfg)
            total = total + jnp.sum(h * cot[t])
        return total

    return np.asarray(jax.grad(loss)(jnp.asarray(U)))


def test_tp_window_dU_is_the_jax_vjp_s_unrounded():
    """bf16 compute at D = 1: dU of a window through ``_tp_scan_layer``
    (the cast once a window, ``TPStep`` a step) is fp32, not a bf16 value,
    and the JAX VJP's. Were U_c handed to each step as the differentiable
    cast in U's place, dU would come back rounded to bf16 (the last test
    shows it) and fail here."""
    U, xw, h0, c0, cot = _window()
    cfg = _cfg(n=U.shape[0])
    Ut = torch.from_numpy(U).requires_grad_()
    layer = LayerParams(torch.zeros(1), Ut, torch.zeros(1))
    with torch.enable_grad():
        h_seq, _ = ttp._tp_scan_layer(layer, torch.from_numpy(xw),
                                      torch.from_numpy(h0), torch.from_numpy(c0),
                                      cfg, None, "pallas", plain=True)
        (dU,) = torch.autograd.grad((h_seq * torch.from_numpy(cot)).sum(), [Ut])
    assert dU.dtype == torch.float32
    assert not torch.equal(dU, dU.bfloat16().float())
    np.testing.assert_allclose(dU.numpy(), _jax_window_dU(U, xw, h0, c0, cot), **GRAD)


@pytest.mark.parametrize("ndev", [1, 2])
def test_tp_step_dU_with_U_c_matches_jax(ndev):
    """One step of a shard of D = 1, 2 (nd = N, N / 2, the full h) through
    ``fused_tp_step`` with U_c given, as the window hands it: every
    cotangent the JAX VJP's, dU in fp32 and not rounded, dh_full bf16."""
    rng = np.random.default_rng(8 + ndev)
    n, b = 64, 8
    nd = n // ndev
    f = lambda *shape, sd: rng.normal(size=shape).astype(np.float32) * sd
    U, xw, h, c = f(n, 4 * nd, sd=0.1), f(b, 4 * nd, sd=0.7), np.tanh(f(b, n, sd=1.0)), f(b, nd, sd=0.5)
    cots = [f(b, nd, sd=1.0) for _ in range(2)]
    cfg = _cfg(n=n)
    ts = [torch.from_numpy(a).requires_grad_() for a in (U, xw, h, c)]
    U_c = ts[0].detach().bfloat16()
    out = tc.fused_tp_step(*ts, cfg, plain=True, U_c=U_c)
    got = torch.autograd.grad(out, ts, [torch.from_numpy(x) for x in cots])
    jcfg = JConfig(hidden=n, compute_dtype="bfloat16")
    jout, vjp = jax.vjp(lambda *a: jcell.fused_tp_step(*a, jcfg),
                        *map(jnp.asarray, (U, xw, h, c)))
    want = vjp(tuple(jnp.asarray(x) for x in cots))
    for name, a, w in zip("U xw h_full c_d".split(), got, want):
        np.testing.assert_allclose(a.double().numpy(), np.asarray(w, np.float64),
                                   **GRAD, err_msg=name)
    assert got[0].dtype == torch.float32
    assert not torch.equal(got[0], got[0].bfloat16().float())
    assert torch.equal(got[2].float(), got[2].float().bfloat16().float())


def test_passing_U_c_alone_rounds_dU():
    """The trap the extra input avoids: a differentiable cast handed to
    ``TPStep`` in U's place sends dU back through the cast's backward,
    rounded to bf16, away from the JAX VJP's fp32 dU."""
    rng = np.random.default_rng(12)
    n, b = 64, 8
    f = lambda *shape, sd: rng.normal(size=shape).astype(np.float32) * sd
    U, xw, h, c = f(n, 4 * n, sd=0.1), f(b, 4 * n, sd=0.7), np.tanh(f(b, n, sd=1.0)), f(b, n, sd=0.5)
    cfg = _cfg(n=n)
    Ut = torch.from_numpy(U).requires_grad_()
    args = [torch.from_numpy(x) for x in (xw, h, c)]
    with torch.enable_grad():
        right = tc.TPStep.apply(Ut, Ut.detach().bfloat16(), *args, cfg, True)
        (dU_right,) = torch.autograd.grad(right[0].sum(), [Ut])
        cast = Ut.bfloat16()
        wrong = tc.TPStep.apply(cast, cast.detach(), *args, cfg, True)
        (dU_wrong,) = torch.autograd.grad(wrong[0].sum(), [Ut])
    assert torch.equal(dU_wrong, dU_right.bfloat16().float())
    assert not torch.equal(dU_wrong, dU_right)


# --- the fp32 step's sum order ------------------------------------------------


def k13_f32_step_replay(U_d, xw, h_full, c_d, cfg):
    """One fp32 K13 step in the kernel's order: the gate sums of
    ``f32_order_gates`` (split s of 4 the k with (k mod 32) / 8 = s,
    ascending, the partials in split order), then acc + xw, the gates and
    the cell. Returns (h2, c2, g)."""
    nd = c_d.shape[-1]
    g = cell_ops.gate_activations(xw + f32_order_gates(h_full, U_d), nd)
    h2, c2 = cell_ops.cell_update(g, c_d, nd, cfg.cell_variant)
    return h2, c2, g


def _k13_window(Us, xws, h0, c0s, cfg):
    """S steps of D shards (D = len(Us)), the full h of a step the shards'
    h2 side by side, each shard's c carried: per shard (h_seq, g_seq,
    c_prev, hT, cT), as K15's window returns them."""
    h, cs = h0, list(c0s)
    seqs = [([], [], []) for _ in Us]
    for t in range(xws[0].shape[0]):
        hs = []
        for r, U in enumerate(Us):
            h2, c2, g = k13_f32_step_replay(U, xws[r][t], h, cs[r], cfg)
            for seq, x in zip(seqs[r], (h2, g, cs[r])):
                seq.append(x)
            hs.append(h2)
            cs[r] = c2
        h = torch.cat(hs, 1)
    return [(*(torch.stack(x) for x in seqs[r]), seqs[r][0][-1], cs[r])
            for r in range(len(Us))]


def _step_window_inputs(s=5, b=16, n=64, seed=41):
    rng = np.random.default_rng(seed)
    f = lambda *shape, sd: torch.from_numpy((rng.standard_normal(shape) * sd)
                                            .astype(np.float32))
    return f(n, 4 * n, sd=0.15), f(s, b, 4 * n, sd=0.7), f(b, n, sd=0.3), f(b, n, sd=0.3)


@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_fp32_step_window_is_k15s_fp32_window(variant):
    """D = 1: a window of fp32 K13 steps in the kernel's order gives K15's
    fp32 persistent window (``f32_fwd_replay``) bit for bit: h_seq, g,
    c_prev, hT, cT."""
    U, xw, h0, c0 = _step_window_inputs()
    cfg = _cfg("float32", n=U.shape[0], cell_variant=variant)
    got, = _k13_window([U], [xw], h0, [c0], cfg)
    want, = f32_fwd_replay([U], [xw], h0, [c0], cfg)
    for name, a, w in zip(("h_seq", "g", "c_prev", "hT", "cT"), got, want):
        assert torch.equal(a, w), name


def test_fp32_step_shards_are_the_d1_window():
    """D = 2 on the TP gate permutation's shards of the same weights: every
    step's gate sums of each shard, from the D = 1 window's h_{t-1}, are
    the D = 1 sums of its columns bit for bit (a unit's sum depends on k
    alone), and the shards' window gives the D = 1 window's h, c and g bit
    for bit (the gates and the cell are per-element code on the card; here
    every width is a multiple of torch's vector length, so its vectorised
    elementwise functions take one path at D = 1 and 2)."""
    U, xw, h0, c0 = _step_window_inputs(seed=43)
    n, d = U.shape[0], 2
    nd = n // d
    cfg = _cfg("float32", n=n)
    one, = _k13_window([U], [xw], h0, [c0], cfg)
    perm = torch.as_tensor(_gate_permutation(n, d))
    Us = [U[:, perm][:, r * 4 * nd:(r + 1) * 4 * nd] for r in range(d)]
    xws = [xw[..., perm][..., r * 4 * nd:(r + 1) * 4 * nd] for r in range(d)]
    c0s = [c0[:, r * nd:(r + 1) * nd] for r in range(d)]
    for h in torch.cat([h0[None], one[0][:-1]]):
        whole = f32_order_gates(h, U)[:, perm]
        shards = torch.cat([f32_order_gates(h, Ur) for Ur in Us], 1)
        assert torch.equal(shards, whole)
    got = _k13_window(Us, xws, h0, c0s, cfg)
    cols = lambda r: slice(r * nd, (r + 1) * nd)
    for r in range(d):
        for a, w in ((got[r][0], one[0][..., cols(r)]), (got[r][3], one[3][:, cols(r)]),
                     (got[r][4], one[4][:, cols(r)]),
                     (got[r][1], one[1][..., perm][..., r * 4 * nd:(r + 1) * 4 * nd])):
            assert torch.equal(a, w), r


@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_fp32_step_window_matches_jax_fwd_math(variant):
    """The fp32 step's order over a window at D = 1 and at D = 2's shards
    against the JAX ``_fwd_math`` (the Pallas kernel's body) stepped in
    fp32: h, c and g within rtol 1e-5 / atol 1e-6."""
    U, xw, h0, c0 = _step_window_inputs(seed=47)
    n = U.shape[0]
    cfg = _cfg("float32", n=n, cell_variant=variant)
    h, c, want = jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy()), []
    for t in range(xw.shape[0]):
        h, c, g = jcell._fwd_math(jnp.asarray(U.numpy()), jnp.asarray(xw[t].numpy()),
                                  h, c, n, variant, jnp.float32)
        want.append((h, c, g))
    one, = _k13_window([U], [xw], h0, [c0], cfg)
    for t, (jh, jc, jg) in enumerate(want):
        np.testing.assert_allclose(one[0][t].numpy(), np.asarray(jh), **F32)
        np.testing.assert_allclose(one[1][t].numpy(), np.asarray(jg), **F32)
        c_t = one[2][t + 1] if t + 1 < len(want) else one[4]
        np.testing.assert_allclose(c_t.numpy(), np.asarray(jc), **F32)


def test_fp32_step_kernel_keeps_the_window_s_order():
    """The fp32 step's source: split s = tid / 64 of kPSplit over whole
    32-k blocks (the window's constants), the partials added in split
    order, then + xw; h and U reach shared memory only through
    ``cp_async_16`` (``cp.async.cg``), never ``__ldg``; its C signature is
    ``_build.SIGNATURES``'."""
    src = open(os.path.join(CSRC, "lstm_tp_step_f32.cu")).read()
    code = re.sub(r"//[^\n]*", "", src)
    assert '#include "lstm_tiled_f32.cuh"' in code
    assert "const int split = tid / 64, pg = tid % 4, pq = tid % 64 / 4;" in code
    assert "for (int kb = 0; kb < KC; kb += kPSplit * kPSplitK)" in code
    assert "acc[i][y] = fmaf(x, wv[y], acc[i][y]);" in code
    assert "const float sum = ((p[0] + p[sp]) + p[2 * sp]) + p[3 * sp];" in code
    assert "const float s = sum + pin[i][g];" in code
    assert "__ldg" not in code and code.count("cp_async_16(") == 2
    decl = re.search(r'extern "C" int tp_step_fwd_f32_launch\(([^)]*)\)', code).group(1)
    kinds = ["int*" if "int*" in a else "int" if re.match(r"\s*int ", a) else "void*"
             for a in decl.split(",")]
    import ctypes
    want = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "int*": ctypes.POINTER(ctypes.c_int)}
    assert _build.SIGNATURES["tp_step_fwd_f32_launch"][1] == [want[k] for k in kinds]
