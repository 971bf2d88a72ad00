"""K8 under fp32 compute: its persistent CUDA-core design's plan
(``ops/cuda_cell_tiled.py:tiled_fwd_f32_plan``), the shared-memory mirror,
the launch its card path makes, the forwards that keep their fp32 routes,
and the kernel source's rules.

K8 (``tiled_embed_layer0``) has a third design of its function under fp32
compute (TF32 stays off, so CUDA cores): one cooperative launch a window,
N / 8 blocks each holding its N x 32 slice of U in shared memory for the
window, round(h_{t-1}) streamed through a ring each step, a grid barrier
between steps. K1 takes it too, through the same launcher with its batch
split over block rows (tests/test_torch_k1_plan.py), K9 through a launcher
of its own, which K2 takes with its batch split the same way
(tests/test_torch_k2_plan.py), K15 in its mode. The device numbers are an
H100 SXM's (132 SMs, 232,448 bytes of shared memory a block may opt in
to). The routing is checked without a
card: tensors on ``meta``, ``Tensor.data_ptr`` giving each storage an
address of its own, a stand-in library recording the calls. The plain
version K8's kernels are held to is held against the JAX
``_fwd_tiled_embed_kernel`` in interpret mode by tests/test_torch_tiled.py.
"""

import os
import re
import types

import pytest
import torch

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.models.lstm import LayerParams
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cuda_cell_tiled as ct
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts

SMS, SMEM = 132, 232_448
CSRC = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")


def _cfg(dtype="float32", n=1024, residual="float32", **kw):
    return ModelConfig(hidden=n, compute_dtype=dtype, residual_dtype=residual,
                       **kw)


# --- the plan -------------------------------------------------------------


@pytest.mark.parametrize("b,n,want", [
    (128, 1024, (4, 64, 2)),    # the flagship's fp32 training window
    (16, 1024, (1, 128, 4)),    # the flagship's eval batch
    (32, 1024, (1, 128, 4)),    # a chunk of 32 rows (SP, 4 chunks)
    (64, 512, (2, 64, 4)),
    (100, 1056, (4, 32, 3)),    # 132 blocks; N not a multiple of 64
    (1, 256, (1, 128, 4)),
])
def test_plan_takes_the_persistent_design(b, n, want):
    """fp32 with B <= 128 and N / 8 blocks resident: the rows a thread
    owns (1, 2, 4 for B <= 32, 64, 128) and the first ring of F32_RINGS
    whose columns divide N and that fits beside the slice of U."""
    layout = ct.tiled_fwd_f32_plan(_cfg(n=n), b, n, SMS, SMEM)
    assert tuple(layout) == want
    assert ct.f32_persist_smem_bytes(b, n, layout.kc, layout.stages) <= SMEM
    assert n // ct.F32_UNITS <= SMS and n % layout.kc == 0


@pytest.mark.parametrize("dtype,b,n,sms,smem", [
    ("float32", 128, 2048, SMS, SMEM),     # 256 blocks on 132 SMs
    ("float32", 129, 1024, SMS, SMEM),     # past 4 rows a thread
    ("float32", 256, 1024, SMS, SMEM),
    ("float32", 128, 1024, 127, SMEM),     # 128 blocks on 127 SMs
    ("float32", 128, 1024, SMS, 150_000),  # the slice of U and no ring
    ("float32", 128, 1000, SMS, SMEM),     # N not a multiple of 32
    ("bfloat16", 128, 1024, SMS, SMEM),    # bf16: tiled_fwd_plan's designs
    ("bfloat16", 16, 2048, SMS, SMEM),
])
def test_plan_refuses(dtype, b, n, sms, smem):
    """None: the per-step design keeps these (and bf16 has its own plan)."""
    assert ct.tiled_fwd_f32_plan(_cfg(dtype, n=n), b, n, sms, smem) is None


def test_n_2048_is_refused_not_streamed():
    """At N = 2048 the grid of 256 blocks is not resident on 132 SMs, and
    the slice of U (256 KB) would not fit a block either: the plan refuses
    (K8 takes its per-step design) rather than stream U; a card with twice
    the SMs still refuses it for its shared memory."""
    cfg = _cfg(n=2048)
    assert ct.tiled_fwd_f32_plan(cfg, 128, 2048, SMS, SMEM) is None
    assert ct.tiled_fwd_f32_plan(cfg, 128, 2048, 264, SMEM) is None
    assert ct.f32_persist_smem_bytes(128, 2048, 32, 3) > SMEM
    assert ct.tiled_fwd_f32_plan(cfg, 128, 2048, 264, 1 << 20) == (4, 64, 2)


def test_shared_memory_mirror_arithmetic():
    """The slice of U (N x 32 fp32), then the larger of the ring (stages x
    32 R rows x (KC + 4) floats) and the splits' partial sums (4 x 32 R
    rows x 32 floats)."""
    for b, r in ((1, 1), (16, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4)):
        assert ct.f32_rows_per_thread(b) == r
        for n in (256, 512, 1024, 1056):
            for kc, st in ((32, 3), (64, 2), (64, 4), (128, 4)):
                rows = 32 * r
                want = 4 * (32 * n + max(st * rows * (kc + 4), 4 * rows * 32))
                assert ct.f32_persist_smem_bytes(b, n, kc, st) == want
    assert ct.f32_persist_smem_bytes(128, 1024, 64, 2) == 131072 + 69632
    assert ct.f32_persist_smem_bytes(128, 1024, 32, 3) == 131072 + 65536


def test_device_plan_takes_the_cards_limits(monkeypatch):
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for b in (16, 128):
        assert ct.device_tiled_fwd_f32_plan(_cfg(), b, 1024) == \
            ct.tiled_fwd_f32_plan(_cfg(), b, 1024, SMS, SMEM)


# --- the routing -----------------------------------------------------------


class _Library:
    """Stands in for the kernels' library: records each call, returns 0,
    and counts the fp32 persistent launchers' one launch (K8's, and K9's
    and K10's, K6's lstm_bwd_f32_launch, in
    tests/test_torch_fp32_tiled_plan.py)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name.endswith("_f32_launch"):
                args[-1]._obj.value += 1
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    lib = _Library()
    storages, seen = {}, {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        addr = (storages.setdefault(key, len(storages) + 1) << 32) + \
            t.storage_offset() * t.element_size()
        seen[addr] = t
        return addr

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ct, "_device_limits", lambda index: (SMS, SMEM))
    monkeypatch.setattr(cuda_cell, "_kernel_types", lambda cfg, dev: (
        cuda_cell._TYPE_CODES[cfg.cdtype], cuda_cell._TYPE_CODES[cfg.rdtype]))
    monkeypatch.setattr(ts, "_card", lambda cfg, dev, nd: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib, data_ptr, seen


def _e(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _layer(n, m=256):
    return LayerParams(_e(m, 4 * n), _e(n, 4 * n), _e(4 * n))


@pytest.mark.parametrize("b", [128, 16])
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [None, (0.35, -1234567)])
def test_k8_fp32_launches_the_persistent_design(routed, b, residual, dropout):
    """fp32 at the flagship's shapes and its eval batch: one call of
    ``tiled_fwd_embed_f32_launch`` and nothing else, one launch counted,
    with the tiled family's residual type, W and U in fp32 cut from one
    stacked [W; U] (as the JAX wrapper builds it), b read in place, the ids
    in int32, hc (2, B, N) fp32, the outputs' buffers, the plan's ring,
    the dropout's scalars."""
    lib, ptr, seen = routed
    s, n = 4, 1024
    cfg = _cfg(residual=residual)
    layer, ids = _layer(n), _e(s, b, dtype=torch.int64)
    h0, c0 = _e(b, n), _e(b, n)
    before = ct.launches()
    out = ct.tiled_embed_layer0(layer, ids, h0, c0, cfg, residuals=True,
                                dropout=dropout)
    assert ct.launches() == (before[0] + 1,) + before[1:]
    assert [c[0] for c in lib.calls] == ["tiled_fwd_embed_f32_launch"]
    a = lib.calls[0][1]
    # (rtype, W, U, b, ids, hc, c, hT, hseq, cseq, gseq, hdrop, S, B, N,
    #  standard, rows, kc, stages, seed, keep, inv, stream, launched)
    rd = ct.types(cfg)[1]
    assert a[0] == cuda_cell._TYPE_CODES[rd]
    for i, shape in ((1, (256, 4 * n)), (2, (n, 4 * n))):
        assert seen[a[i]].dtype == torch.float32 and tuple(seen[a[i]].shape) == shape
    assert a[1] >> 32 == a[2] >> 32 and a[3] == ptr(layer.b)
    assert seen[a[4]].dtype == torch.int32 and tuple(seen[a[4]].shape) == (s, b)
    hc = seen[a[5]]
    assert hc.dtype == torch.float32 and tuple(hc.shape) == (2, b, n)
    h_seq, (hT, cT), c_seq, g_seq = out[:4]
    assert a[8:11] == (ptr(h_seq), ptr(c_seq), ptr(g_seq))
    assert h_seq.dtype == c_seq.dtype == g_seq.dtype == rd
    plan = ct.tiled_fwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert a[12:19] == (s, b, n, 0, b, plan.kc, plan.stages)   # every row a block
    assert (a[11] is None) == (dropout is None)
    assert a[19:22] == (cuda_cell.drop_scalars(dropout) or (0, 0, 0.0))


@pytest.mark.parametrize("dtype,b,n,want", [
    ("bfloat16", 128, 1024, (1024, 128)),   # the bf16 plan: tensor cores
    ("float32", 256, 1024, (-1, 256)),      # refused: the per-step design
    ("float32", 128, 2048, (-1, 128)),
])
def test_k8_elsewhere_keeps_tiled_fwd_embed_launch(routed, dtype, b, n, want):
    lib = routed[0]
    cfg = _cfg(dtype, n=n, residual="bfloat16" if dtype == "bfloat16" else "float32")
    ct.tiled_embed_layer0(_layer(n), _e(3, b, dtype=torch.int64), _e(b, n),
                          _e(b, n), cfg)
    assert [c[0] for c in lib.calls] == ["tiled_fwd_embed_launch"]
    assert lib.calls[0][1][17:19] == want


def test_other_forwards_keep_their_fp32_routes(routed):
    """At the flagship's fp32 shapes K9 (``tiled_scan_layer``) takes the
    fp32 persistent design through its own launcher
    (``tiled_fwd_scan_f32_launch``, the plan's ring); K1 takes K8's
    launcher (``split_fwd_f32_plan``'s layout: one block row of 128 at N =
    1024); K2 (``cuda_cell``) takes K9's launcher with the same layout's
    rows and ring; K15 at D = 1 takes the same kernel in K15's mode
    through a launcher of its own (``tp_seq_fwd_f32_launch``,
    ``split_fwd_f32_plan``'s layout: N / 8 = 128 blocks of every batch
    row)."""
    lib = routed[0]
    s, b, n = 3, 128, 1024
    cfg = _cfg()
    h0, c0 = _e(b, n), _e(b, n)
    ct.tiled_scan_layer(_layer(n), _e(s, b, 4 * n), h0, c0, cfg)
    cuda_cell.embed_layer0(_layer(n), _e(s, b, dtype=torch.int64), h0, c0, cfg)
    cuda_cell.scan_layer(_layer(n), _e(s, b, 4 * n), h0, c0, cfg)
    ts.tp_seq_fwd(_e(n, 4 * n), _e(s, b, 4 * n), h0, c0, cfg)
    names = [c[0] for c in lib.calls]
    assert names == ["tiled_fwd_scan_f32_launch", "tiled_fwd_embed_f32_launch",
                     "tiled_fwd_scan_f32_launch", "tp_seq_fwd_f32_launch"]
    plan = ct.tiled_fwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert lib.calls[0][1][14:17] == (b, plan.kc, plan.stages)   # K9: fp32 ring
    split = ct.split_fwd_f32_plan(cfg, b, n, SMS, SMEM)
    assert split == (b, plan.rows, plan.kc, plan.stages)   # K1, K2, K15: K9's layout
    assert lib.calls[1][1][16:19] == (split.rows, split.kc, split.stages)
    assert lib.calls[2][1][14:17] == (split.rows, split.kc, split.stages)
    assert lib.calls[3][1][13:17] == tuple(split)


def test_embed_launch_refuses_a_mismatched_layout(routed):
    """The fp32 layout is K8's alone: bf16 compute, or rows a thread that
    are not the batch's, raise before any launch."""
    lib = routed[0]
    b, n = 128, 1024
    args = (_layer(n), _e(3, b, dtype=torch.int64), _e(b, n), _e(b, n))
    for cfg, layout in ((_cfg("bfloat16", residual="bfloat16"), ct.F32Layout(4, 64, 2)),
                        (_cfg(), ct.F32Layout(2, 64, 4))):
        with pytest.raises(ValueError, match="fp32 layout"):
            ct.embed_launch(ct.tiled_embed_layer0, *args, cfg, torch.float32,
                            layout, False, None)
    assert lib.calls == []


# --- the kernel source -------------------------------------------------------


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _kernel(src, signature):
    """The body of the function whose definition starts with
    ``signature``: from its first brace to the matching one."""
    start = src.index(signature)
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start:i], src[i:j + 1]
    raise AssertionError(f"no end of {signature}")


def _strip_comments(code):
    return re.sub(r"//[^\n]*", "", code)


def _barriers_under_conditions(body):
    """The barriers (``__syncthreads()``, ``grid.sync()``) that a branch
    guards: inside a block opened by ``if`` or ``else``, or the statement
    of an unbraced ``if``; loops with the same bounds in every thread do
    not count. Returns the offending statements."""
    code = _strip_comments(body)
    stack, bad, head_start = [], [], 0
    for m in re.finditer(r"[{};]", code):
        tok, head = m.group(), code[head_start:m.start()].strip()
        if tok == "{":
            stack.append(bool(re.match(r"(\}\s*)?(if\b|else\b)", head)))
        elif tok == ";":
            if re.search(r"__syncthreads\(\)|grid\.sync\(\)", head) and (
                    any(stack) or re.match(r"(if|else)\b", head)):
                bad.append(head)
        else:
            stack.pop()
        head_start = m.end()
    return bad


def test_k8_kernel_reads_h_through_l2_only_and_barriers_unguarded():
    """tiled_fwd_f32_persist (csrc/lstm_tiled_f32.cuh) runs the window
    f32_fwd_window over fwd_mma.cuh's GridStep<float>: hc, which the
    launch's blocks write and read, is neither const nor __restrict__, is
    read only through the ring's cp.async (``cp.async.cg``, L2 only) and
    never through ``__ldg``; the grid barrier (the Step's sync) closes
    every step but the last, on a condition every block evaluates alike,
    and no block barrier sits under a branch."""
    src = _source("lstm_tiled_f32.cuh")
    params, body = _kernel(src, "tiled_fwd_f32_persist(const float* __restrict__ U")
    assert re.search(r"\n\s*float\* hc,", params)
    assert "GridStep<float>{hc, (size_t)B * N, N}" in body
    mma = _source("fwd_mma.cuh")
    step = mma[mma.index("struct GridStep {"):mma.index("};", mma.index("struct GridStep {"))]
    assert re.search(r"\n\s*HT\* hc;", step)
    assert "return hc + (size_t)(t % 2) * bn;" in step
    assert _strip_comments(step).count("cooperative_groups::this_grid().sync();") == 1
    _, window = _kernel(src, "f32_fwd_window(const Step& step,")
    code = _strip_comments(window)
    assert "__ldg" not in code and "__ldca" not in code
    assert len(re.findall(r"\bhin\b", code)) == 3   # step.hin, its name, one read
    assert "const float* hin = step.hin(t);" in code
    assert "cp_async_16(st + r * P + 4 * p, hin + " in code
    assert code.count("step.sync(t)") == 1 and "if (t + 1 < S) step.sync(t);" in code
    assert _barriers_under_conditions(window) == []
    assert "cp.async.cg.shared.global" in _source("mma.cuh")


def test_k4_core_kernel_puts_no_barrier_under_a_branch():
    _, body = _kernel(_source("head.cu"), "head_fwd_core(const CT* __restrict__ h")
    assert _strip_comments(body).count("__syncthreads()") == 4
    assert _barriers_under_conditions(body) == []


def test_the_barrier_check_sees_a_guarded_barrier():
    assert _barriers_under_conditions(
        "{ if (t < S) { grid.sync(); } for (;;) { __syncthreads(); } }") == ["grid.sync()"]
    assert _barriers_under_conditions("{ if (x) __syncthreads(); }") == \
        ["if (x) __syncthreads()"]


def test_kernel_constants_and_layouts_match_the_plan():
    """The block's units, threads and split, the ring's pitch, and the
    layouts the library is built for are the plan's."""
    src = _source("lstm_tiled_f32.cuh")
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kPUnits"), const("kPThreads"), const("kPSplit")) == \
        (ct.F32_UNITS, ct.F32_THREADS, ct.F32_SPLIT)
    assert "constexpr int f32_pitch(int KC) { return KC + 4; }" in src
    layouts = re.search(r"#define F32_LAYOUTS\(X\)(.*?)\n\n", src, re.S).group(1)
    built = {(int(r), int(k), int(st)) for r, k, st in
             re.findall(r"X\((\d+), (\d+), (\d+)\)", layouts)}
    planned = {(r, k, st) for r, rings in ct.F32_RINGS.items() for k, st in rings}
    assert built == planned
    assert "tiled_fwd_embed_f32_launch" in _build.SIGNATURES
    assert "tiled_fwd_f32_smem_bytes" in _build.SIGNATURES
