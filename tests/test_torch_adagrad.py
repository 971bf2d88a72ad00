"""The fused Adagrad update (K11, ``ops/cuda_adagrad.py``) against the JAX
package's ``adagrad_update_fused`` (``pallas_adagrad.py``, its Pallas kernel
in interpret mode, as tests/test_pallas_adagrad.py runs it) and
``adagrad_update``. On the CPU the wrapper runs its plain version; its
launch on the card is checked here with a stand-in library that records
the tables it is handed and runs the update on the addresses in them
(``EmulatedLib``): the plan cached per layout, the checks that still run
after a plan is cached, the output arenas, and the first call path kept as
the forced control.

Parameter sets: the 1x512 checkpoint's parameters and Adagrad accumulators
with seeded gradients, and a 2x128 model over a 97-byte vocabulary (W of
layer 0 and Why with 97 rows or columns, by of 97 and the biases 1-D, so
that the JAX function takes its jnp path for them).

Tolerances: m and p within rtol 1e-6 / atol 1e-7, as the JAX test holds
its kernel to its jnp path, through three chained steps. XLA on the CPU may
contract m + g*g into an FMA where torch rounds the product first, so
exact equality is asked only on the card (chip_smoke.py phase 10a, against
the plain version).
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_adagrad import adagrad_update_fused as jfused
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu.train import optimizer as jopt
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.config import TrainConfig as TTrain
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import _build, cuda_adagrad
from eigen_lstm_tpu_torch.parallel import mesh as tmesh
from eigen_lstm_tpu_torch.parallel import pp as tpp
from eigen_lstm_tpu_torch.parallel import tp as ttp
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train import optimizer as topt
from eigen_lstm_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H512 = os.path.join(ROOT, "artifacts/bible_h512/ckpt.npz")
TOL = dict(rtol=1e-6, atol=1e-7)
LR = np.float32(0.02)
PLAIN = cuda_adagrad.adagrad_update_plain   # before the fixtures replace it


def _h512():
    cfg = dict(vocab=256, hidden=512)
    with np.load(H512) as z:
        params = {k: z[k] for k in z.files if k.startswith("params")}
        m = {"params" + k[len("opt"):]: z[k] for k in z.files
             if k.startswith("opt")}
    return cfg, params, m


def _odd():
    cfg = dict(vocab=97, hidden=128, num_layers=2)
    rng = np.random.default_rng(3)
    shapes = {"params.layers[0].W": (97, 512), "params.layers[0].U": (128, 512),
              "params.layers[0].b": (512,), "params.layers[1].W": (128, 512),
              "params.layers[1].U": (128, 512), "params.layers[1].b": (512,),
              "params.Why": (128, 97), "params.by": (97,)}
    params = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
              for k, s in shapes.items()}
    m = {k: np.abs(rng.normal(size=s) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    return cfg, params, m


def _grads(params, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=v.shape) * 0.05).astype(dtype)
            for k, v in params.items()}


def _jax(tree_like, arrays):
    return jckpt._unflatten_like(tree_like, "params", arrays)


def _torch(arrays, cfg):
    return tckpt.params_from_numpy(arrays, cfg, "cpu")


def _assert_sets_close(got, want, what):
    for (key, g), w in zip(got.named_tensors(),
                           jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("make", [_h512, _odd], ids=["1x512", "2x128_odd"])
def test_fused_update_matches_jax_over_three_steps(make):
    """Three chained steps from the same state: the port's wrapper (its
    plain version on the CPU) against the JAX Pallas kernel (interpret
    mode) and the JAX jnp update, params and accumulators."""
    kw, params, m = make()
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    like = jmodel.init_params(jcfg)
    jp_f = jp_r = _jax(like, params)
    jm_f = jm_r = _jax(like, m)
    tp, tm = _torch(params, tcfg), _torch(m, tcfg)
    for step in range(3):
        g = _grads(params, step)
        jg, tg = _jax(like, g), _torch(g, tcfg)
        jp_f, jm_f = jfused(jp_f, jg, jm_f, jnp.float32(LR), 1e-10)
        jp_r, jm_r = jopt.adagrad_update(jp_r, jg, jm_r, jnp.float32(LR), 1e-10)
        tp, tm = cuda_adagrad.adagrad_update_fused(tp, tg, tm, LR, 1e-10)
        for got, want, what in ((tp, jp_f, "p vs pallas"), (tm, jm_f, "m vs pallas"),
                                (tp, jp_r, "p vs jnp"), (tm, jm_r, "m vs jnp")):
            _assert_sets_close(got, want, f"step {step} {what}")


def test_float64_set_matches_jax(x64):
    """A float64 set (the float64 oracle configuration) on the CPU: the
    plain version computes in fp32 and stores float64, as both JAX
    functions do."""
    kw, params, m = _odd()
    kw["param_dtype"] = "float64"
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: v.astype(np.float64) for k, v in m.items()}
    g = _grads(params, 5, np.float64)
    like = jmodel.init_params(jcfg)
    jg = _jax(like, g)
    tp, tm = cuda_adagrad.adagrad_update_fused(
        _torch(params, tcfg), _torch(g, tcfg), _torch(m, tcfg), LR)
    assert {t.dtype for t in topt.tensors(tp)} == {torch.float64}
    for fn in (jfused, jopt.adagrad_update):
        jp, jm = fn(_jax(like, params), jg, _jax(like, m), jnp.float32(LR), 1e-10)
        _assert_sets_close(tp, jp, f"p vs {fn.__name__}")
        _assert_sets_close(tm, jm, f"m vs {fn.__name__}")


def test_apply_updates_goes_through_the_fused_update(monkeypatch):
    """``apply_updates`` (the trainer's step) updates through
    ``adagrad_update_fused``, once a step, with the scheduled lr."""
    calls = []
    real = topt.adagrad_update_fused

    def spy(params, grads, m, lr, eps):
        calls.append(lr)
        return real(params, grads, m, lr, eps)

    monkeypatch.setattr(topt, "adagrad_update_fused", spy)
    kw, params, m = _odd()
    tcfg = TConfig(**kw)
    p, mm = _torch(params, tcfg), _torch(m, tcfg)
    for step in range(3):
        p, mm, _ = topt.apply_updates(p, _torch(_grads(params, step), tcfg), mm,
                                      step, TTrain(lr=0.1, warmup_steps=1))
    assert calls == [np.float32(0.0), np.float32(0.1), np.float32(0.1)]


class FakeCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


def _fake_set(arrays, cfg):
    params = _torch(arrays, cfg)
    return topt.like(params, (t.as_subclass(FakeCuda)
                              for t in topt.tensors(params)))


def _floats(address, n):
    """The n float32 values at ``address``, as a tensor over that memory."""
    return torch.frombuffer((ctypes.c_float * n).from_address(address),
                            dtype=torch.float32)


class EmulatedLib:
    """Stands in for the kernels' library: records every call of K11's two
    C entry points and runs the update on the addresses it is handed, in
    the plain version's torch ops, as the kernel would on the card."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _update(p, g, m, p_out, m_out, n, lr, eps):
        gv, m2 = _floats(g, n), _floats(m_out, n)
        m2.copy_(_floats(m, n) + torch.square(gv))
        _floats(p_out, n).copy_(_floats(p, n) - lr * gv * torch.rsqrt(m2 + eps))

    def adagrad_plan_launch(self, count, ins, layout, p_out, m_out, lr, eps,
                            stream, launched):
        ins, layout = list(ins), list(layout)
        rows = [(ins[k], ins[count + k], ins[2 * count + k],
                 p_out + 4 * layout[2 * k + 1], m_out + 4 * layout[2 * k + 1],
                 layout[2 * k]) for k in range(count)]
        self.calls.append(dict(entry="plan", count=count, rows=rows, lr=lr,
                               eps=eps, bases=(p_out, m_out),
                               offsets=layout[1::2]))
        for row in rows:
            self._update(*row, lr, eps)
        launched._obj.value += 1
        return 0

    def adagrad_launch(self, count, table, lr, eps, stream, launched):
        table = list(table)
        rows = [tuple(table[6 * k: 6 * k + 6]) for k in range(count)]
        self.calls.append(dict(entry="first", count=count, rows=rows, lr=lr,
                               eps=eps))
        for row in rows:
            self._update(*row, lr, eps)
        launched._obj.value += 1
        return 0


@pytest.fixture
def card(monkeypatch):
    """The wrappers' card path on CPU memory: an ``EmulatedLib``, a stand-in
    stream, an empty plan cache, and no plain version."""
    lib = EmulatedLib()

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(cuda_adagrad._build, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_adagrad, "adagrad_update_plain", no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream)
    monkeypatch.setattr(cuda_adagrad, "_stream", lambda dev: Stream.cuda_stream)
    monkeypatch.setattr(cuda_adagrad, "_PLANS", {})
    return lib


def _odd_card_sets():
    kw, params, m = _odd()
    cfg = TConfig(**kw)
    return cfg, tuple(_fake_set(a, cfg) for a in (params, _grads(params, 0), m))


def test_the_card_launches_once_for_the_whole_set(card):
    """On CUDA tensors the wrapper launches ``adagrad_plan_launch`` once
    with every tensor's input addresses, the two arenas' bases and the
    plan's (numel, offset) for every tensor of the set (eight here), the
    lr and eps, and counts the launch; it never runs the plain version or
    the first call path."""
    _, (p, g, mm) = _odd_card_sets()
    before = cuda_adagrad.adagrad_update_fused.launches
    first = cuda_adagrad.adagrad_update_first.launches
    new_p, new_m = cuda_adagrad.adagrad_update_fused(p, g, mm, LR, 1e-10)
    assert cuda_adagrad.adagrad_update_fused.launches == before + 1
    assert cuda_adagrad.adagrad_update_first.launches == first
    (call,) = card.calls
    assert call["entry"] == "plan" and call["count"] == 8
    assert call["lr"] == float(LR) and call["eps"] == 1e-10
    for row, a, b, c, d, e in zip(call["rows"], *map(topt.tensors, (p, g, mm, new_p, new_m))):
        assert row == (a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       d.data_ptr(), e.data_ptr(), a.numel())


def test_the_card_refuses_float64_and_mixed_sets(monkeypatch):
    """A float64 set on the card raises before any build; so does a set
    whose tensors do not match the parameters' shapes or device."""
    def no_build():
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(cuda_adagrad._build, "load_library", no_build)
    kw, params, m = _odd()
    cfg = TConfig(**kw, param_dtype="float64")
    p, g, mm = (_fake_set(a, cfg) for a in (params, _grads(params, 0), m))
    with pytest.raises(TypeError, match="float32"):
        cuda_adagrad.adagrad_update_fused(p, g, mm, LR)
    cpu = _torch(params, cfg)
    with pytest.raises(ValueError, match="params has"):
        cuda_adagrad.adagrad_update_fused(p, cpu, mm, LR)


def _deeper_set():
    kw, params, m = _odd()
    kw["num_layers"] = 3
    for name in ("W", "U", "b"):
        params[f"params.layers[2].{name}"] = params[f"params.layers[1].{name}"]
        m[f"params.layers[2].{name}"] = m[f"params.layers[1].{name}"]
    cfg = TConfig(**kw)
    return tuple(_fake_set(a, cfg) for a in (params, _grads(params, 1), m))


def _pp_set():
    kw, params, m = _odd()
    cfg = TConfig(**kw)
    return tuple(topt.like(pp, (t.as_subclass(FakeCuda) for t in topt.tensors(pp)))
                 for pp in (tpp.pp_params_from(_torch(a, cfg), cfg)
                            for a in (params, _grads(params, 2), m)))


def test_a_layout_is_planned_once(card, monkeypatch):
    """The plan of a layout is built at its first call and reused on the
    next two; a deeper set and the stage-stacked ``PPParams`` of the same
    model each get a plan of their own, and the first layout keeps its."""
    built = []
    real = cuda_adagrad.AdagradPlan.__init__

    def spy(self, ps):
        built.append([tuple(p.shape) for p in ps])
        real(self, ps)

    monkeypatch.setattr(cuda_adagrad.AdagradPlan, "__init__", spy)
    _, odd = _odd_card_sets()
    for _ in range(3):
        cuda_adagrad.adagrad_update_fused(*odd, LR)
    assert len(built) == 1 and len(built[0]) == 8
    deeper, pp = _deeper_set(), _pp_set()
    cuda_adagrad.adagrad_update_fused(*deeper, LR)
    cuda_adagrad.adagrad_update_fused(*pp, LR)
    cuda_adagrad.adagrad_update_fused(*odd, LR)
    cuda_adagrad.adagrad_update_fused(*pp, LR)
    assert [len(b) for b in built] == [8, 11, 5]
    assert built[2] == [(2, 128, 512), (2, 128, 512), (2, 512), (128, 97), (97,)]
    assert len(cuda_adagrad._PLANS) == 3 and len(card.calls) == 7


@pytest.mark.parametrize("fault", ["shape", "device", "dtype", "count"])
def test_a_mismatch_after_the_plan_raises_before_any_launch(card, fault):
    """Once the layout's plan is cached, a set whose gradients differ from
    the parameters in a shape, a device, a dtype or the number of tensors
    still raises, and nothing is launched."""
    _, (p, g, mm) = _odd_card_sets()
    cuda_adagrad.adagrad_update_fused(p, g, mm, LR)
    gs = topt.tensors(g)
    if fault == "shape":
        gs[4] = gs[4].reshape(512, 128)
        bad = g.like(gs)
    elif fault == "device":
        gs[2] = gs[2].as_subclass(torch.Tensor)
        bad = g.like(gs)
    elif fault == "dtype":
        gs[7] = gs[7].double().as_subclass(FakeCuda)
        bad = g.like(gs)
    else:
        bad = tmodel.LSTMParams(g.layers[:1], g.Why, g.by)
    error = TypeError if fault == "dtype" else ValueError
    with pytest.raises(error):
        cuda_adagrad.adagrad_update_fused(p, bad, mm, LR)
    assert len(card.calls) == 1


def _ragged_set():
    """A set whose Why (5 x 97) has a numel that is not a multiple of 4, so
    that by's output needs padding before it: W (97, 20), U (5, 20), b
    (20,), Why (5, 97), by (97,)."""
    rng = np.random.default_rng(4)
    shapes = [(97, 20), (5, 20), (20,), (5, 97), (97,)]

    def make(scale, positive=False):
        ts = [torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
              for s in shapes]
        ts = [t.abs() if positive else t for t in ts]
        return tmodel.LSTMParams((tmodel.LayerParams(*ts[:3]),), ts[3], ts[4])

    return make(0.1), make(0.05), make(0.01, positive=True)


def _span(t):
    return t.data_ptr(), t.data_ptr() + 4 * t.numel()


def test_outputs_are_aligned_views_of_two_arenas(card):
    """p' and m' are views of one arena each, every view 16 bytes aligned
    (by after Why's 485 elements starts at 2548, not 2545), none
    overlapping an input; the inputs are unchanged; the values are the
    plain version's bit for bit (the emulated kernel runs its ops)."""
    cpu = _ragged_set()
    p, g, mm = (topt.like(s, (t.as_subclass(FakeCuda) for t in topt.tensors(s)))
                for s in cpu)
    ins = topt.tensors(p) + topt.tensors(g) + topt.tensors(mm)
    before = [t.clone() for t in ins]
    new_p, new_m = cuda_adagrad.adagrad_update_fused(p, g, mm, LR, 1e-10)
    for a, b in zip(ins, before):
        assert torch.equal(a, b)
    (call,) = card.calls
    assert call["offsets"] == [0, 1940, 2040, 2060, 2548]
    assert call["bases"][0] != call["bases"][1]
    for outs in (topt.tensors(new_p), topt.tensors(new_m)):
        assert len({t.untyped_storage().data_ptr() for t in outs}) == 1
        assert all(t.data_ptr() % 16 == 0 and t.is_contiguous() for t in outs)
    for lo, hi in map(_span, topt.tensors(new_p) + topt.tensors(new_m)):
        for x_lo, x_hi in map(_span, ins):
            assert hi <= x_lo or x_hi <= lo
    want_p, want_m = PLAIN(*cpu, LR, 1e-10)
    for got, want in ((new_p, want_p), (new_m, want_m)):
        for a, b in zip(topt.tensors(got), topt.tensors(want)):
            assert a.shape == b.shape
            assert torch.equal(a.as_subclass(torch.Tensor), b)


def test_the_first_call_path_hands_the_same_tables(card):
    """The forced control (``adagrad_update_first``, ``adagrad_launch``)
    and the plan's path hand the library the same input addresses, numels,
    lr and eps, each its own outputs, and give the same bits."""
    _, (p, g, mm) = _odd_card_sets()
    plan_p, plan_m = cuda_adagrad.adagrad_update_fused(p, g, mm, LR, 1e-10)
    before = cuda_adagrad.adagrad_update_first.launches
    first_p, first_m = cuda_adagrad.adagrad_update_first(p, g, mm, LR, 1e-10)
    assert cuda_adagrad.adagrad_update_first.launches == before + 1
    plan, first = card.calls
    assert (plan["entry"], first["entry"]) == ("plan", "first")
    assert (plan["count"], plan["lr"], plan["eps"]) == (first["count"], first["lr"], first["eps"])
    for a, b, out_a, out_b in zip(plan["rows"], first["rows"],
                                  zip(topt.tensors(plan_p), topt.tensors(plan_m)),
                                  zip(topt.tensors(first_p), topt.tensors(first_m))):
        assert a[:3] + a[5:] == b[:3] + b[5:]
        assert a[3:5] == tuple(t.data_ptr() for t in out_a)
        assert b[3:5] == tuple(t.data_ptr() for t in out_b)
    for a, b in zip(topt.tensors(plan_p) + topt.tensors(plan_m),
                    topt.tensors(first_p) + topt.tensors(first_m)):
        assert torch.equal(a, b)


def test_the_first_call_path_refuses_what_the_plan_refuses(monkeypatch):
    """The control raises as the plan's path does: float64 and mismatched
    sets, and CPU tensors (it has no plain version)."""
    monkeypatch.setattr(cuda_adagrad._build, "load_library", lambda: None)
    kw, params, m = _odd()
    cfg = TConfig(**kw, param_dtype="float64")
    p, g, mm = (_fake_set(a, cfg) for a in (params, _grads(params, 0), m))
    with pytest.raises(TypeError, match="float32"):
        cuda_adagrad.adagrad_update_first(p, g, mm, LR)
    with pytest.raises(ValueError, match="params has"):
        cuda_adagrad.adagrad_update_first(p, _torch(params, cfg), mm, LR)
    cpu = [_torch(a, TConfig(**kw)) for a in (params, _grads(params, 0), m)]
    with pytest.raises(ValueError, match="no kernel"):
        cuda_adagrad.adagrad_update_first(*cpu, LR)


def test_non_contiguous_inputs_are_read_through_copies(card):
    """A gradient that is a transposed view reaches the kernel as a
    contiguous copy; the plan is the contiguous set's and the bits equal."""
    _, (p, g, mm) = _odd_card_sets()
    want_p, _ = cuda_adagrad.adagrad_update_fused(p, g, mm, LR)
    gs = topt.tensors(g)
    gs[1] = gs[1].t().contiguous().t()
    assert not gs[1].is_contiguous()
    got_p, _ = cuda_adagrad.adagrad_update_fused(p, g.like(gs), mm, LR)
    assert card.calls[1]["rows"][1][1] != gs[1].data_ptr()
    assert len(cuda_adagrad._PLANS) == 1
    for a, b in zip(topt.tensors(got_p), topt.tensors(want_p)):
        assert torch.equal(a, b)


def test_arena_views_serve_every_downstream_use(card, tmp_path):
    """Outputs that share an arena behave as tensors of their own where the
    port takes them next: the trainer's leaves (``p.detach()
    .requires_grad_()``) give the gradients of separate copies, a
    checkpoint saves and restores each tensor alone, and TP's and PP's
    sharding and the collectives' one-rank forms give the copies'
    values."""
    cfg, (p, g, mm) = _odd_card_sets()
    new_p, new_m = cuda_adagrad.adagrad_update_fused(p, g, mm, LR)
    views = topt.like(new_p, (t.as_subclass(torch.Tensor) for t in topt.tensors(new_p)))
    accs = topt.like(new_m, (t.as_subclass(torch.Tensor) for t in topt.tensors(new_m)))
    assert len({t.untyped_storage().data_ptr() for t in topt.tensors(views)}) == 1
    copies = topt.like(views, (t.clone() for t in topt.tensors(views)))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, 97, (6, 3)))
    t = torch.from_numpy(rng.integers(0, 97, (6, 3)))
    h = torch.zeros(2, 3, 128)
    got = ttrainer.loss_and_grads(views, x, t, h, h, cfg)
    want = ttrainer.loss_and_grads(copies, x, t, h, h, cfg)
    assert torch.equal(got[0], want[0])
    for a, b in zip(topt.tensors(got[3]), topt.tensors(want[3])):
        assert torch.equal(a, b)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(path, views, accs, 3)
    back_p, back_m, step, _ = tckpt.load_checkpoint(path, cfg, "cpu")
    assert step == 3
    for a, b in zip(topt.tensors(back_p) + topt.tensors(back_m),
                    topt.tensors(views) + topt.tensors(accs)):
        assert a.shape == b.shape and torch.equal(a, b)
    for rank in (0, 1):
        for a, b in zip(topt.tensors(ttp.shard_params(views, cfg, rank, 2)),
                        topt.tensors(ttp.shard_params(copies, cfg, rank, 2))):
            assert torch.equal(a, b)
    stacked = tpp.shard_params(tpp.pp_params_from(views, cfg), None)
    for a, b in zip(topt.tensors(stacked),
                    topt.tensors(tpp.shard_params(tpp.pp_params_from(copies, cfg), None))):
        assert torch.equal(a, b)
    for v, c in zip(topt.tensors(views), topt.tensors(copies)):
        assert torch.equal(tmesh.broadcast(v, 0, None), c)
        assert torch.equal(tmesh.all_reduce(v, None), c)


def test_the_sets_list_their_tensors_in_checkpoint_order():
    """``tensors`` (the optimizer's per-step list) is ``named_tensors``'s
    order, for ``LSTMParams`` and PP's ``PPParams``; a plan pads only
    before a tensor that would start off a 16-byte boundary, so the odd
    set's arenas end with by's 97 elements."""
    kw, params, _ = _odd()
    cfg = TConfig(**kw)
    for s in (_torch(params, cfg), tpp.pp_params_from(_torch(params, cfg), cfg),
              _ragged_set()[0]):
        assert [id(t) for t in topt.tensors(s)] == [id(t) for _, t in s.named_tensors()]
    odd = topt.tensors(_torch(params, cfg))
    assert cuda_adagrad.AdagradPlan(odd).total == sum(t.numel() for t in odd)


def test_k11_c_signatures_match_the_source():
    """``_build.SIGNATURES`` of K11's two entry points against their
    declarations in ``csrc/adagrad.cu``."""
    src = re.sub(r"//[^\n]*", "", open(os.path.join(
        os.path.dirname(_build.__file__), "..", "csrc", "adagrad.cu")).read())
    want = {"int": ctypes.c_int, "float": ctypes.c_float,
            "int*": ctypes.POINTER(ctypes.c_int), "void*": ctypes.c_void_p}
    for name in ("adagrad_plan_launch", "adagrad_launch"):
        decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1)
        args = [" ".join(a.split()) for a in decl.split(",")]
        kinds = ["int*" if a.startswith("int*") else "void*" if "*" in a
                 else a.split()[0] for a in args]
        assert _build.SIGNATURES[name][1] == [want[k] for k in kinds]
