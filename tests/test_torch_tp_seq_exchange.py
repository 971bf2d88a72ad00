"""K15 and K16 at D > 1 (``ops/cuda_tp_seq.py``'s exchange designs) on the
CPU, at small sizes.

The D-rank plain versions (``tp_seq_fwd_ranks_plain``,
``tp_seq_bwd_ranks_plain``: D shards in one process, the all-gather a
concatenation, the reduce-scatter a sum in rank order) are held
  - to the port's D-rank plain versions over gloo (D processes of
    ``tests/torch_tp_seq_exchange_worker.py``): the forward bit for bit
    (an all-gather moves values and sums nothing), the backward at rtol
    1e-6 in fp32 (gloo's all-reduce sums the partials in its own order;
    atol 1e-7 for entries near 0) and at the bf16 window tolerance of
    ``tests/test_torch_tp_kernels.py`` under bf16 compute, where one fp32
    ulp of a sum can flip a bf16 rounding of dg;
  - to the JAX ``pallas_tp_seq.tp_seq_lstm`` on the virtual CPU mesh at
    D = 2 and 4, its kernels in interpret mode with their remote copies
    (the unchecked harness of ``tests/test_tp_seq.py``): forward outputs
    rtol 1e-5 and the VJP's dU, dxw, dh0, dc0 rtol 2e-4 / atol 1e-6 in
    fp32, ``tests/test_tp_seq.py``'s bf16 tolerance (rtol 5e-2 / atol 1e-4)
    on gradients under bf16 compute and the bf16 window tolerance on its
    values.
Then the one-card plan in pure Python: the buffer layout against the
kernel source's constants, the slots and flags of each step as the
kernel source computes them and across the bases the launchers are
given, blocks per rank against a resident count and the
refusal of groups that do not fit, the peer-access check, the buffers'
release with their mesh axis (a normal close and one on an error, which
runs no collective), and the launch each card path makes (tensors on
``meta``, a stand-in library).
"""

import json
import os
import re
import subprocess
import sys
import types

import filelock
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.ops import pallas_tp_seq as jseq
from eigen_lstm_tpu.parallel import mesh as jmesh

from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.ops import _build, cuda_cell
from eigen_lstm_tpu_torch.ops import cuda_tp_seq as ts
from eigen_lstm_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_seq_exchange_worker.py")
LP_CU = os.path.join(ROOT, "eigen_lstm_tpu_torch", "csrc", "lstm_tp.cu")
EX_CUH = os.path.join(ROOT, "eigen_lstm_tpu_torch", "csrc", "exchange.cuh")
RANKS_TIMEOUT_S = 300
S, B, N = 5, 8, 32
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-6)
GLOO_BWD = dict(rtol=1e-6, atol=1e-7)
BF16_WINDOW = dict(rtol=2e-2, atol=2.0 ** -9)   # tests/test_torch_tp_kernels.py
BF16_GRAD = dict(rtol=5e-2, atol=1e-4)          # tests/test_tp_seq.py
# (compute, residual, cell variant)
CASES = {
    "f32": ("float32", "float32", "reference"),
    "f32_std": ("float32", "float32", "standard"),
    "f32_bf16res": ("float32", "bfloat16", "reference"),
    "bf16": ("bfloat16", "float32", "reference"),
}


def _cfg_kw(case):
    dtype, residual, variant = CASES[case]
    return dict(hidden=N, compute_dtype=dtype, residual_dtype=residual,
                cell_variant=variant)


def _inputs(d, seed):
    """Seeded shards of one window: U (N, 4nd), xw (S, B, 4nd), h0_d and c0
    (B, nd) by rank, and the cotangents dh (S, B, nd), dhT, dcT by rank."""
    rng = np.random.default_rng(seed)
    nd = N // d
    f = lambda *shape, sd: (rng.normal(size=shape) * sd).astype(np.float32)
    return dict(U=[f(N, 4 * nd, sd=0.15) for _ in range(d)],
                xw=[f(S, B, 4 * nd, sd=0.7) for _ in range(d)],
                h0=[f(B, nd, sd=0.3) for _ in range(d)],
                c0=[f(B, nd, sd=0.3) for _ in range(d)],
                dh=[f(S, B, nd, sd=0.5) for _ in range(d)],
                dhT=[f(B, nd, sd=0.5) for _ in range(d)],
                dcT=[f(B, nd, sd=0.5) for _ in range(d)])


def _seed(case, d):
    return 100 * d + sorted(CASES).index(case)


def _ranks_plain(x, cfg):
    """The D-rank plain versions and the window's dU on the inputs ``x``:
    (per rank (h_seq, g, c_prev, hT, cT), per rank (dg, dh0, dc0), per rank
    dU)."""
    t = lambda a: [torch.from_numpy(v) for v in a]
    U_cs = [u.to(cfg.cdtype) for u in t(x["U"])]
    h0_full = torch.cat(t(x["h0"]), 1)
    fwd = ts.tp_seq_fwd_ranks_plain(U_cs, t(x["xw"]), h0_full, t(x["c0"]), cfg)
    bwd = ts.tp_seq_bwd_ranks_plain(U_cs, [o[1] for o in fwd], [o[2] for o in fwd],
                                    [o[4] for o in fwd], t(x["dh"]), t(x["dhT"]),
                                    t(x["dcT"]), cfg)
    h_all = torch.cat([o[0] for o in fwd], 2)
    dU = [ts.window_dU(h0_full, h_all, dg, cfg).to(cfg.cdtype) for dg, _, _ in bwd]
    return fwd, bwd, dU


def _np(x):
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float64)


# --- the D-rank plain versions against the gloo ranks ----------------------


def _spawn(d, work):
    spec, inputs = {}, {}
    for case in CASES:
        spec[case] = _cfg_kw(case)
        x = _inputs(d, _seed(case, d))
        inputs[f"{case}/h0_full"] = np.concatenate(x["h0"], 1)
        for name in ("U", "xw", "c0", "dh", "dhT", "dcT"):
            for r in range(d):
                inputs[f"{case}/{name}{r}"] = x[name][r]
    src, out_dir = work / f"in_{d}.npz", work / f"out_{d}"
    out_dir.mkdir(exist_ok=True)
    np.savez(src, spec=np.array(json.dumps(spec)), **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(work / f"store_{d}"),
                               str(r), str(d), str(src), str(out_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(d)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {d} failed:\n{o[-4000:]}"
    res = []
    for r in range(d):
        with np.load(out_dir / f"rank{r}.npz") as z:
            res.append(dict(z))
    (work / f"done_{d}").write_text("ok")
    return res


@pytest.fixture(scope="module")
def gloo(tmp_path_factory, worker_id):
    """gloo(D): every case's outputs of D gloo ranks, computed once for the
    whole run (shared across xdist workers through a file lock)."""
    root = tmp_path_factory.getbasetemp()
    if worker_id != "master":
        root = root.parent
    cache = {}

    def get(d):
        if d not in cache:
            work = root / "torch_tp_seq_exchange"
            work.mkdir(exist_ok=True)
            with filelock.FileLock(str(work / f"D{d}.lock")):
                if (work / f"done_{d}").exists():
                    cache[d] = []
                    for r in range(d):
                        with np.load(work / f"out_{d}" / f"rank{r}.npz") as z:
                            cache[d].append(dict(z))
                else:
                    cache[d] = _spawn(d, work)
        return cache[d]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [2, 4])
def test_ranks_plain_equals_the_gloo_ranks(gloo, d, case):
    """One process's D shards against D processes over gloo."""
    cfg = TConfig(**_cfg_kw(case))
    fwd, bwd, _ = _ranks_plain(_inputs(d, _seed(case, d)), cfg)
    bwd_tol = BF16_WINDOW if cfg.cdtype == torch.bfloat16 else GLOO_BWD
    for r, want in enumerate(gloo(d)):
        for name, got in zip(("h_seq", "g_seq", "c_prev", "hT", "cT"), fwd[r]):
            np.testing.assert_array_equal(got.float().numpy(), want[f"{case}/{name}"],
                                          err_msg=f"rank {r} {name}")
        for name, got in zip(("dg", "dh0", "dc0"), bwd[r]):
            np.testing.assert_allclose(_np(got), want[f"{case}/{name}"], **bwd_tol,
                                       err_msg=f"rank {r} {name}")


# --- against the JAX kernels on the virtual CPU mesh -----------------------


def _jax_ranks(x, jcfg, d):
    """The JAX ``tp_seq_lstm`` and its VJP on D devices of the model axis:
    per rank (h_seq, hT, cT, dU, dxw, dh0, dc0)."""
    jm = jmesh.make_mesh(d, axis="model")
    names = ("U", "xw", "h0", "c0", "dh", "dhT", "dcT")

    def local(U, xw, h0, c0, dh, dhT, dcT):
        U, xw, h0, c0, dh, dhT, dcT = (a[0] for a in (U, xw, h0, c0, dh, dhT, dcT))
        out, vjp = jax.vjp(lambda *a: jseq.tp_seq_lstm(*a, jcfg, "model", d),
                           U, xw, h0, c0)
        grads = vjp((dh, (dhT, dcT)))
        return tuple(a[None] for a in (out[0], *out[1], *grads))

    f = jax.shard_map(local, mesh=jm, in_specs=(P("model"),) * 7,
                      out_specs=(P("model"),) * 7, check_vma=False)
    outs = jax.jit(f)(*(jnp.asarray(np.stack(x[k])) for k in names))
    return [[np.asarray(o[r]) for o in outs] for r in range(d)]


@pytest.mark.parametrize("case", ["f32", "f32_std", "bf16"])
@pytest.mark.parametrize("d", [2, 4])
def test_ranks_plain_matches_jax_tp_seq_lstm(d, case):
    """The port's D shards (values and the VJP: dU = window_dU, dxw = dg,
    dh0, dc0) against the JAX kernels' remote copies on D devices."""
    kw = _cfg_kw(case)
    tcfg, jcfg = TConfig(**kw), JConfig(**kw)
    x = _inputs(d, _seed(case, d))
    fwd, bwd, dU = _ranks_plain(x, tcfg)
    bf16 = tcfg.cdtype == torch.bfloat16
    val_tol = BF16_WINDOW if bf16 else F32
    grad_tol = BF16_GRAD if bf16 else GRAD
    for r, want in enumerate(_jax_ranks(x, jcfg, d)):
        got = (fwd[r][0], fwd[r][3], fwd[r][4], dU[r], *bwd[r])
        for i, name in enumerate(("h_seq", "hT", "cT", "dU", "dxw", "dh0", "dc0")):
            np.testing.assert_allclose(_np(got[i]), _np(want[i]),
                                       **(val_tol if i < 3 else grad_tol),
                                       err_msg=f"rank {r} {name}")
        if bf16:   # dU leaves as a bf16 value in both
            for a in (got[3], want[3]):
                a = torch.tensor(np.asarray(_np(a), np.float32))
                assert torch.equal(a, a.bfloat16().float())


def test_ranks_plain_at_one_rank_is_the_window():
    """At D = 1 the D-rank plain versions are the window's, bit for bit."""
    cfg = TConfig(**_cfg_kw("bf16"))
    x = _inputs(1, 7)
    fwd, bwd, _ = _ranks_plain(x, cfg)
    t = {k: torch.from_numpy(v[0]) for k, v in x.items()}
    U_c = t["U"].to(cfg.cdtype)
    want = ts.tp_seq_fwd_plain(U_c, t["xw"], t["h0"], t["c0"], cfg)
    for a, b in zip(fwd[0], want):
        assert torch.equal(a, b)
    want = ts.tp_seq_bwd_plain(U_c, want[1], want[2], want[4], t["dh"], t["dhT"],
                               t["dcT"], cfg)
    for a, b in zip(bwd[0], want):
        assert torch.equal(a, b)


def test_backward_sums_the_chunks_in_rank_order(monkeypatch):
    """dh_rec is ((c0 + c1) + c2) + c3 over the ranks' chunks, as the
    kernel adds them: chunks where fp32 addition is not associative tell
    the orders apart (rank order 0, pairwise 1, exact 2)."""
    d = 4
    vals = [2.0 ** 24, 1.0, 1.0, -2.0 ** 24]
    partials = iter([torch.full((1, d), v) for v in vals])
    monkeypatch.setattr(ts.cell_ops, "matmul", lambda *a: next(partials))
    cfg = TConfig(hidden=d, compute_dtype="float32")
    z = lambda *shape: [torch.zeros(*shape) for _ in range(d)]
    out = ts.tp_seq_bwd_ranks_plain(z(d, 4), z(1, 1, 4), z(1, 1, 1), z(1, 1),
                                    z(1, 1, 1), z(1, 1), z(1, 1), cfg)
    assert [o[1].item() for o in out] == [0.0] * d


# --- the one-card plan ------------------------------------------------------


def _cu_constants():
    src = open(EX_CUH).read()
    get = lambda name: int(re.search(rf"\b{name}\s*=\s*(\d+)", src).group(1))
    return {k: get(k) for k in ("kMaxRanks", "kFwdFlag", "kBwdFlag", "kFwdBar",
                                "kBwdBar")}


def test_layout_matches_the_kernel_source():
    """The header's flags (a word a sender) and barriers (count,
    generation) lie inside HEADER_BYTES without overlap, as exchange.cuh
    places them, and MAX_RANKS is the kernel's."""
    k = _cu_constants()
    assert k["kMaxRanks"] == ts.MAX_RANKS
    spans = sorted([(4 * k["kFwdFlag"], 4 * (k["kFwdFlag"] + ts.MAX_RANKS)),
                    (4 * k["kBwdFlag"], 4 * (k["kBwdFlag"] + ts.MAX_RANKS)),
                    (4 * k["kFwdBar"], 4 * k["kFwdBar"] + 8),
                    (4 * k["kBwdBar"], 4 * k["kBwdBar"] + 8)])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= ts.HEADER_BYTES


@pytest.mark.parametrize("b,n,d,csize", [(128, 512, 2, 2), (128, 512, 4, 4),
                                         (128, 1024, 2, 2), (8, 32, 4, 4),
                                         (8, 48, 3, 2)])
def test_exchange_layout(b, n, d, csize):
    lay = ts.exchange_layout(b, n, d, csize)
    assert lay.h_off == ts.HEADER_BYTES
    assert lay.r_off % 256 == 0 and lay.nbytes % 256 == 0
    # the h slots (3, B, N) in the compute type, then the chunks (3, D, B, nd)
    assert lay.r_off >= lay.h_off + 3 * b * n * csize
    assert lay.nbytes >= lay.r_off + 3 * d * b * (n // d) * 4
    assert lay.r_off - (lay.h_off + 3 * b * n * csize) < 256


def test_exchange_layout_refuses():
    with pytest.raises(ValueError):
        ts.exchange_layout(8, 32, ts.MAX_RANKS + 1, 4)
    with pytest.raises(ValueError):
        ts.exchange_layout(8, 30, 4, 4)


def _c_expr(src, pattern):
    """The C expression the pattern's group captures in the kernel source,
    as a Python function of its names (base, t, e, S): unsigned integer
    arithmetic that Python's agrees with on these ranges."""
    m = re.search(pattern, src, re.S)
    assert m, pattern
    expr = m.group(1)
    return lambda **names: eval(expr, {}, dict(names))


def _kernel_exchanges():
    """The slot and flag rules of ``tp_seq_fwd_x``, ``tp_seq_bwd_x`` and
    the forward launchers' h0 copy, read from lstm_tp.cu and exchange.cuh: fwd(base, s) gives step
    t's (slot read, slot written, flag raised; None, None at the last
    step), bwd(base, s) exchange e's (chunk slot, flag), e = 0..S-1 for
    reverse steps S-2..-1, and h0(base) the slot the launcher copies h0
    into. Flags are the kernel's 32-bit words."""
    src = open(LP_CU).read()
    fsrc = src[src.index("tp_seq_fwd_x(const"):src.index("struct SeqBwdGroup")]
    bsrc = src[src.index("tp_seq_bwd_x(const"):src.index("// The grid of a cooperative")]
    xsrc = open(EX_CUH).read()
    lsrc = xsrc[xsrc.index("h0 into the rank's slot"):]
    read = _c_expr(fsrc, r"h_in = [^;]*?\+ \((\([^;]*?\) % 3)\) \* bN;")
    write = _c_expr(fsrc, r"next = \((\([^;]*?\) % 3)\) \* bN")
    fflag = _c_expr(fsrc, r"kFwdBar\),[^;]*?static_cast<unsigned>\(([^;]*?)\)\);")
    fwhen = _c_expr(fsrc, r"if \(([^)]*)\)\s*exchange\(")
    h0 = _c_expr(lsrc, r"h_off \+ \(([^;]*?)\) \* hbytes")
    e_of = _c_expr(bsrc, r"const unsigned long long e = ([^;]*);")
    slot = _c_expr(bsrc, r"w = static_cast<int>\(([^;]*?)\);")
    bflag = _c_expr(bsrc, r"kBwdBar\),[^;]*?static_cast<unsigned>\(([^;]*?)\)\);")
    bwhen = _c_expr(bsrc, r"if \(([^)]*)\) \{\s*const unsigned long long e")
    word = lambda x: x % 2 ** 32

    def fwd(base, s):
        out = []
        for t in range(s):
            on = fwhen(t=t, S=s)
            out.append((read(base=base, t=t),
                        write(base=base, t=t) if on else None,
                        word(fflag(base=base, t=t)) if on else None))
        return out

    def bwd(base, s):
        out = []
        for t in range(s - 1, -2, -1):
            if bwhen(t=t, S=s):
                e = e_of(base=base, t=t, S=s)
                out.append((slot(e=e), word(bflag(e=e))))
        return out

    return fwd, bwd, lambda base: h0(base=base)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 7])
def test_forward_slots(s):
    """Within a call (lstm_tp.cu's rule) step t reads slot (base + t) % 3,
    the launcher's h0 slot at t = 0, and writes the next; a writer one
    step ahead never writes the slot a laggard reads."""
    fwd_x, _, h0 = _kernel_exchanges()
    for base in (0, 1, 2, 10):
        ex = fwd_x(base, s)
        assert len(ex) == s and ex[0][0] == h0(base) == base % 3
        assert ex[-1][1:] == (None, None)
        for t in range(s - 1):
            read, write, flag = ex[t]
            assert write == ex[t + 1][0] and write != read
            assert flag == base + t + 1
        for t in range(s - 2):
            # a rank at step t + 1 writes; its peer may still read step t's
            assert ex[t + 1][1] not in (ex[t][0], ex[t + 1][0])


@pytest.mark.parametrize("sizes", [(5, 5, 5), (1, 3, 1, 2), (2, 1, 7), (4,)])
def test_flags_across_calls(routed, sizes):
    """The bases the launchers are given across calls on one card's
    buffers, through lstm_tp.cu's rule: every flag a call waits for
    exceeds every flag of the calls before (so an old flag never meets a
    wait), a peer that starts the next call writes no slot this rank may
    still read, and h0's slot is none the last call's peers wrote into
    late."""
    fwd_x, bwd_x, h0 = _kernel_exchanges()
    lib, _ = routed
    d, b, n = 2, 8, 64
    nd = n // d
    cfg = TConfig(hidden=n, compute_dtype="float32")
    ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
    U = [_meta(n, 4 * nd) for _ in range(d)]
    seen_f = seen_b = 0
    last = None
    for s in sizes:
        x = [_meta(s, b, nd) for _ in range(d)]
        g = [_meta(s, b, 4 * nd) for _ in range(d)]
        z = [_meta(b, nd) for _ in range(d)]
        lib.calls.clear()
        ts.tp_seq_fwd_ranks(U, g, _meta(b, n), z, cfg, ex)
        ts.tp_seq_bwd_ranks(U, g, x, z, x, z, z, cfg, ex)
        (_, f), (_, bw) = lib.calls
        base_f, base_b = f[17], bw[17]
        fwd, bwd = fwd_x(base_f, s), bwd_x(base_b, s)
        assert len(bwd) == s
        flags_f = [fl for _, _, fl in fwd if fl is not None]
        flags_b = [fl for _, fl in bwd]
        assert all(fl > seen_f for fl in flags_f) and all(fl > seen_b for fl in flags_b)
        seen_f = max(flags_f + [seen_f])
        seen_b = max(flags_b + [seen_b])
        if last is not None:
            last_fwd, last_bwd = last
            # this rank may still read the last call's last slot while a
            # peer begins this call
            if s > 1:
                assert fwd[0][1] != last_fwd[-1][0]
            assert h0(base_f) != last_fwd[-1][0] or len(last_fwd) == 1
            assert bwd[0][0] != last_bwd[-1][0]
        last = (fwd, bwd)
    assert ex.steps == {"fwd": sum(sizes), "bwd": sum(sizes)}


def test_backward_slots():
    _, bwd_x, _ = _kernel_exchanges()
    for base in (0, 4):
        ex = bwd_x(base, 6)
        assert [f for _, f in ex] == list(range(base + 1, base + 7))
        assert all(a[0] != b[0] for a, b in zip(ex, ex[1:]))


def test_flags_wrap_at_32_bits():
    """The kernel compares flags as int32 differences: its targets wrap
    with the 32-bit word and stay ordered across the wrap."""
    fwd_x, _, _ = _kernel_exchanges()
    base = 2 ** 32 - 2
    flags = [f for _, _, f in fwd_x(base, 5) if f is not None]
    assert flags == [2 ** 32 - 1, 0, 1, 2]
    as_int32 = lambda x: (x + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert [as_int32(b - a) for a, b in zip(flags, flags[1:])] == [1, 1, 1]
    assert as_int32(flags[0] - flags[-1]) < 0


def test_rank_blocks():
    assert ts.rank_blocks(256, 2, 1056) == [256, 256]
    assert ts.rank_blocks(512, 2, 1000) == [500, 500]
    assert ts.rank_blocks(128, 4, 1056) == [128] * 4
    assert ts.rank_blocks(100, 2, 1056, blocks=[1, 100]) == [1, 100]


@pytest.mark.parametrize("tiles,groups,resident,blocks", [
    (64, 4, 3, None),            # fewer resident blocks than groups
    (64, 2, 100, [60, 60]),      # a split past the resident count
    (64, 2, 100, [0, 10]),       # a group without a block
    (64, 2, 100, [10]),          # a count for each group
])
def test_rank_blocks_refuses_groups_that_do_not_fit(tiles, groups, resident, blocks):
    with pytest.raises(ValueError):
        ts.rank_blocks(tiles, groups, resident, blocks)


def test_tiles():
    assert ts.fwd_tiles(128, 256) == 8 * 32
    assert ts.bwd_tiles(128, 512) == 16 * 32
    assert ts.fwd_tiles(6, 64) == 2 * 2


def test_refused_pairs():
    can = {(0, 1): True, (1, 0): True, (0, 2): False, (2, 0): True,
           (1, 2): True, (2, 1): True}
    assert ts.refused_pairs([0, 1, 2], lambda a, c: can[(a, c)]) == [(0, 2)]
    assert ts.refused_pairs([3, 3], lambda a, c: False) == []


class _Buffers:
    def __init__(self):
        self.closed = 0

    def close(self, failed=False):
        self.closed += 1


def test_axis_releases_its_exchange_buffers_on_close():
    cpu = torch.device("cpu")
    ax = mesh.AxisGroup(0, 2, cpu)
    buf = ax.exchange["k"] = _Buffers()
    ax.close()
    ax.close()
    assert buf.closed == 1 and ax.exchange == {}
    model = mesh.AxisGroup(1, 2, cpu)
    row = model.exchange["k"] = _Buffers()
    pm = mesh.ProcessMesh(mesh.AxisGroup(0, 2, cpu), model, cpu)
    pm.close()
    assert row.closed == 1 and model.exchange == {}


class _CloseLibrary:
    """Records the exchange library's calls, in order, into ``log``."""

    def __init__(self, log):
        self.log = log

    def exchange_ipc_close(self, p):
        self.log.append(("ipc_close", p))
        return 0

    def exchange_free(self, p):
        self.log.append(("free", p))
        return 0


@pytest.fixture
def close_log(monkeypatch):
    """A record of the card's synchronize and the model axis's all-reduce,
    with a process group up."""
    log = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: log.append(("sync",)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)

    def all_reduce(x, group):
        log.append(("all_reduce",))
        return x

    monkeypatch.setattr(mesh, "all_reduce", all_reduce)
    return log


def _group_exchange(log):
    group = mesh.AxisGroup(0, 2, torch.device("cpu"))
    return ts.Exchange(_CloseLibrary(log), "k", ts.exchange_layout(8, 32, 2, 4),
                       [1, 2], [1], [2], group)


@pytest.mark.parametrize("failed", [False, True])
def test_exchange_close(close_log, failed):
    """A normal close waits for the card, unmaps the peer's buffer, meets
    the peers (so none still maps this rank's) and frees its own; a close
    on an error runs no collective and no synchronize, unmaps, and leaves
    the free to the process's end. A second close does nothing."""
    ex = _group_exchange(close_log)
    ex.close(failed=failed)
    ex.close()
    if failed:
        assert close_log == [("ipc_close", 2)]
    else:
        assert close_log == [("sync",), ("ipc_close", 2), ("all_reduce",), ("free", 1)]


def test_exchange_close_after_the_card_failed(close_log, monkeypatch):
    """A sticky CUDA error at the synchronize: the peer's buffer unmapped,
    no collective, nothing freed, the card's error raised."""
    def sync():
        raise RuntimeError("CUDA error: an illegal instruction was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    ex = _group_exchange(close_log)
    with pytest.raises(RuntimeError, match="illegal instruction"):
        ex.close()
    assert close_log == [("ipc_close", 2)]


class _Failing:
    def __init__(self):
        self.failed = []

    def close(self, failed=False):
        self.failed.append(failed)
        raise RuntimeError("CUDA error: unspecified launch failure")


class _Recording(_Failing):
    def close(self, failed=False):
        self.failed.append(failed)


def test_process_group_ends_when_a_buffer_close_raises(monkeypatch, tmp_path):
    """A buffer's close raises: the axis's other buffers are closed as
    after a failure (no collective), the process group still ends, the
    temporary directory goes, and the error is raised after."""
    ended = []
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "destroy_process_group", lambda: ended.append(1))
    store = tmp_path / "store"
    store.mkdir()
    model = mesh.AxisGroup(0, 2, torch.device("cpu"))
    bad, other = model.exchange["a"], model.exchange["b"] = _Failing(), _Recording()
    pm = mesh.ProcessMesh(None, model, torch.device("cpu"), owns=True,
                          tmpdir=str(store))
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        pm.close()
    assert (bad.failed, other.failed, ended) == ([False], [True], [1])
    assert not pm.owns and pm.tmpdir is None and not store.exists()
    assert model.exchange == {}
    pm.close()
    assert ended == [1]


@pytest.mark.parametrize("fails", [False, True])
def test_cli_train_closes_the_mesh_as_failed_on_an_error(monkeypatch, fails):
    """``cli train`` closes its mesh as after a failure (no collective)
    when the run raises, and normally when it ends."""
    from eigen_lstm_tpu_torch import cli

    closes = []
    trainer = types.SimpleNamespace(mesh=types.SimpleNamespace(
        close=lambda failed=False: closes.append(failed)))

    def run(args, tr):
        if fails:
            raise RuntimeError("a step failed")

    monkeypatch.setattr(cli, "_make_trainer", lambda args: trainer)
    monkeypatch.setattr(cli, "_train", run)
    if fails:
        with pytest.raises(RuntimeError, match="a step failed"):
            cli.cmd_train(None)
    else:
        cli.cmd_train(None)
    assert closes == [fails]


# --- the card paths, routed to a stand-in library --------------------------


class _Library:
    """Stands in for the kernels' library: allocations at addresses of
    their own, a resident count, and a record of every launch."""

    def __init__(self, resident=1056):
        self.calls, self.resident, self.next = [], resident, 1 << 40
        # the card's (SMs, shared memory a block): none, so the persistent
        # designs take no layout and the cooperative design runs
        self.limits = (132, 0)

    def exchange_alloc(self, nbytes, ptr):
        ptr._obj.value = self.next
        self.next += 1 << 32
        return 0

    def tp_seq_ranks_resident(self, bwd, ctype, rtype, out):
        out._obj.value = self.resident
        return 0

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            args[-1]._obj.value += 1   # the launches
            return 0
        return call


@pytest.fixture
def routed(monkeypatch):
    """The card paths with no card: tensors on ``meta``, each storage at an
    address of its own and the stand-in library."""
    lib = _Library()
    storages = {}

    def data_ptr(t):
        key = t.untyped_storage()._cdata
        return (storages.setdefault(key, len(storages) + 1) << 32) \
            + t.storage_offset() * t.element_size()

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ts, "_card", lambda cfg, dev, nd: cuda_cell._TYPE_CODES[cfg.cdtype])
    monkeypatch.setattr(ts, "_card_limits", lambda: lib.limits)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=7))
    return lib, data_ptr


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _arr(a, n):
    return [a[i] for i in range(n)]


@pytest.mark.parametrize("d", [2, 4])
def test_one_card_launch(routed, d):
    """``tp_seq_fwd_ranks`` and ``tp_seq_bwd_ranks`` on the card: one launch
    each with D groups, ranks 0..D-1, an even share of the resident blocks
    (or the split given), every group's tensors in rank order, the D
    buffers at the layout's offsets, the base rising by S a call; buffers
    of another shape or type, or none, are refused."""
    lib, ptr = routed
    s, b, n = 4, 128, 512
    nd = n // d
    cfg = TConfig(hidden=n, compute_dtype="bfloat16")
    U = [_meta(n, 4 * nd, dtype=torch.bfloat16) for _ in range(d)]
    xw = [_meta(s, b, 4 * nd) for _ in range(d)]
    h0, c0 = _meta(b, n), [_meta(b, nd) for _ in range(d)]
    ex = ts.one_card_exchange(b, n, d, cfg.cdtype)
    before = ts.tp_seq_fwd_ranks.launches
    out = ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg, ex)
    out2 = ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg, ex, blocks=[1] + [7] * (d - 1))
    assert ts.tp_seq_fwd_ranks.launches - before == 2
    assert [c[0] for c in lib.calls] == ["tp_seq_fwd_ranks_launch"] * 2
    lay = ts.exchange_layout(b, n, d, 2)
    for call, o, base, blocks in ((lib.calls[0][1], out, 0, [min(ts.fwd_tiles(b, nd), 1056 // d)] * d),
                                  (lib.calls[1][1], out2, s, [1] + [7] * (d - 1))):
        assert call[:3] == (1, 0, d)
        assert _arr(call[3], d) == list(range(d)) and _arr(call[4], d) == blocks
        assert _arr(call[5], d) == [ptr(u) for u in U]          # U as it is
        assert len(set(_arr(call[7], d))) == 1                   # the one h0
        for col, k in ((8, None), (9, 0), (10, 1), (11, 2), (12, 3), (13, 4)):
            if k is not None:
                assert _arr(call[col], d) == [ptr(o[r][k]) for r in range(d)]
        assert call[14] == d and _arr(call[15], d) == ex.ptrs
        assert len(set(ex.ptrs)) == d
        assert call[16:23] == (lay.h_off, base, s, b, n, nd, 0)
        assert call[23] == 7
    lib.calls.clear()
    g = [o[1] for o in out]
    cp = [o[2] for o in out]
    cT = [o[4] for o in out]
    dh = [_meta(s, b, nd) for _ in range(d)]
    z = [_meta(b, nd) for _ in range(d)]
    res = ts.tp_seq_bwd_ranks(U, g, cp, cT, dh, z, z, cfg, ex)
    (name, call), = lib.calls
    assert name == "tp_seq_bwd_ranks_launch" and call[:3] == (1, 0, d)
    assert _arr(call[4], d) == [min(ts.bwd_tiles(b, n), 1056 // d)] * d
    assert _arr(call[6], d) == [ptr(x) for x in g]
    assert _arr(call[12], d) == [ptr(x[0]) for x in res]      # dg
    assert _arr(call[15], d) == ex.ptrs and call[16:18] == (lay.r_off, 0)
    with pytest.raises(ValueError, match="one-card buffers"):
        ts.tp_seq_fwd_ranks(U, xw, h0, c0, cfg)
    with pytest.raises(ValueError, match="one-card buffers"):
        ts.tp_seq_fwd_ranks(U, xw, h0, c0, TConfig(hidden=n, compute_dtype="float32"), ex)


def test_one_card_launch_refuses_groups_that_do_not_fit(routed):
    lib, _ = routed
    lib.resident = 3
    cfg = TConfig(hidden=128, compute_dtype="float32")
    ex = ts.one_card_exchange(8, 128, 4, cfg.cdtype)
    with pytest.raises(ValueError, match="do not fit"):
        ts.tp_seq_fwd_ranks([_meta(128, 128)] * 4, [_meta(2, 8, 128)] * 4,
                            _meta(8, 128), [_meta(8, 32)] * 4, cfg, ex)
    assert lib.calls == []


def test_group_path_launches_one_group(routed):
    """On D cards ``tp_seq_fwd`` and ``tp_seq_bwd`` launch one group, this
    process's rank, through the group's buffers."""
    lib, ptr = routed
    s, b, n, d = 3, 128, 512, 2
    nd = n // d
    cfg = TConfig(hidden=n, compute_dtype="float32")
    group = mesh.AxisGroup(1, d, torch.device("meta"))
    key = ("tp_seq", b, n, d, cfg.cdtype)
    ex = group.exchange[key] = ts.Exchange(None, key, ts.exchange_layout(b, n, d, 4),
                                           [11 << 32, 12 << 32], [])
    ex.lib = lib
    before = (ts.tp_seq_fwd.launches, ts.tp_seq_bwd.launches)
    h_seq, g, cp, hT, cT = ts.tp_seq_fwd(_meta(n, 4 * nd), _meta(s, b, 4 * nd),
                                         _meta(b, n), _meta(b, nd), cfg, group)
    dg, dh0, dc0 = ts.tp_seq_bwd(_meta(n, 4 * nd), g, cp, cT, _meta(s, b, nd),
                                 _meta(b, nd), _meta(b, nd), cfg, group)
    assert (ts.tp_seq_fwd.launches, ts.tp_seq_bwd.launches) == (before[0] + 1,
                                                                before[1] + 1)
    (fname, f), (bname, bw) = lib.calls
    assert fname == "tp_seq_fwd_ranks_launch" and bname == "tp_seq_bwd_ranks_launch"
    for call in (f, bw):
        assert call[:3] == (0, 0, 1) and call[3][0] == 1 and call[14] == d
        assert _arr(call[15], d) == ex.ptrs
    assert f[4][0] == ts.fwd_tiles(b, nd) and bw[4][0] == ts.bwd_tiles(b, n)
    assert f[16:18] == (ex.layout.h_off, 0) and bw[16:18] == (ex.layout.r_off, 0)
    assert ex.steps == {"fwd": s, "bwd": s}
    assert f[9][0] == ptr(h_seq) and bw[12][0] == ptr(dg)


def test_ranks_entries_run_plain_on_the_cpu(monkeypatch):
    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "load_library", no_build)
    cfg = TConfig(**_cfg_kw("f32"))
    x = _inputs(2, 3)
    t = lambda a: [torch.from_numpy(v) for v in a]
    before = (ts.tp_seq_fwd_ranks.launches, ts.tp_seq_bwd_ranks.launches)
    U, h0 = t(x["U"]), torch.cat(t(x["h0"]), 1)
    fwd = ts.tp_seq_fwd_ranks(U, t(x["xw"]), h0, t(x["c0"]), cfg)
    want = ts.tp_seq_fwd_ranks_plain(U, t(x["xw"]), h0, t(x["c0"]), cfg)
    for o, w in zip(fwd, want):
        for a, b in zip(o, w):
            assert torch.equal(a, b)
    args = (U, [o[1] for o in fwd], [o[2] for o in fwd], [o[4] for o in fwd],
            t(x["dh"]), t(x["dhT"]), t(x["dcT"]), cfg)
    for o, w in zip(ts.tp_seq_bwd_ranks(*args), ts.tp_seq_bwd_ranks_plain(*args)):
        for a, b in zip(o, w):
            assert torch.equal(a, b)
    assert before == (ts.tp_seq_fwd_ranks.launches, ts.tp_seq_bwd_ranks.launches)
