"""The port's generation path against the JAX package: the fused generation
kernel's plain version (``ops/cuda_sampler.generate_plain``) against
``pallas_sampler.py:_gen_kernel`` in interpret mode, its hash and Gumbel
draw against the kernel's ``_fmix32`` arithmetic, and ``sample_ids``'s
backends.

The JAX kernel derives an int32 seed from its key (``pallas_sampler.py:223``)
with ``jax.random.bits``, which torch cannot reproduce: the tests compute
that seed and pass it to the port.

Tolerances. The hash bits and the uniforms: exact. The Gumbel noise: one fp32 ulp
of 1 plus one of the value (an ulp in each ``log`` of the two frameworks).
fp32 ids: token-exact at T = 0 and
T = 1, the state hT, cT within rtol 1e-5 / atol 1e-6
(tests/test_pallas_sampler.py:36-37; the frameworks sum the products in
another order). bf16 ids: token-exact at T = 0 over 32 tokens, the state
within rtol 2e-2 and atol 2^-9: a bf16 rounding of h may flip by an ulp
between the two, which moves an element near 0 by up to about half a bf16
ulp of 1, beyond any rtol.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.models import sampler as jsampler
from eigen_lstm_tpu.ops import pallas_sampler as jps
from eigen_lstm_tpu.ops.pallas_cell import _fmix32, _shr
from eigen_lstm_tpu.train import checkpoint as jckpt
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.config import DataConfig as TData
from eigen_lstm_tpu_torch.config import TrainConfig as TTrain
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.models import sampler as tsampler
from eigen_lstm_tpu_torch.ops import cuda_sampler
from eigen_lstm_tpu_torch.ops.dispatch import select_cell_fn as tselect
from eigen_lstm_tpu_torch.train import checkpoint as tckpt
from eigen_lstm_tpu_torch.train.trainer import Trainer as TTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts/flagship_drop/ckpt_best.npz")
SHIPPED = ("bible_h512/ckpt.npz", "flagship_3x1024/ckpt.npz",
           "flagship_drop/ckpt.npz", "flagship_drop/ckpt_best.npz",
           "flagship_swa/ckpt_best.npz", "refcfg_n256/ckpt.npz")
FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2.0 ** -9)
B = 8


def jax_seed(key) -> int:
    """The int32 seed pallas_sample_ids draws from ``key``."""
    return int(jax.random.bits(key, (), jnp.uint32).astype(jnp.int32))


def jax_draw(seed, t, b, m):
    """The kernel's bits, uniforms and Gumbel noise at step t for rows
    0..b-1, in the JAX kernel's own arithmetic (pallas_sampler.py:89-103)."""
    base = _fmix32(jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
                   ^ (jnp.uint32(t) * jnp.uint32(0x9E3779B9)))
    rows = jax.lax.broadcasted_iota(jnp.uint32, (b, m), 0)
    lanes = jax.lax.broadcasted_iota(jnp.uint32, (b, m), 1)
    bits = _fmix32((rows * jnp.uint32(m) + lanes) * jnp.uint32(0x85EBCA6B) ^ base)
    uni = jax.lax.bitcast_convert_type(_shr(bits, 8), jnp.int32).astype(
        jnp.float32) * (1.0 / (1 << 24))
    uni = jnp.maximum(uni, 1e-7)
    return np.asarray(bits), np.asarray(uni), np.asarray(-jnp.log(-jnp.log(uni)))


@pytest.mark.parametrize("seed", [0, 1, -1, -2**31, 2**31 - 1, -987654321])
@pytest.mark.parametrize("t", [0, 63, 2**20 + 3])
def test_hash_and_gumbel_match_the_jax_kernel(seed, t):
    """300 rows of 256 bytes: indices b*M + v up to 76 799, past 2^16."""
    b, m = 300, 256
    bits_j, uni_j, gum_j = jax_draw(seed, t, b, m)
    rows = torch.arange(b)
    steps = torch.full((b,), t)
    bits = cuda_sampler.hash_bits(seed, steps, rows, m)
    np.testing.assert_array_equal(bits.numpy(), bits_j.astype(np.int64))
    uni = cuda_sampler.uniform(bits)
    assert uni.dtype == torch.float32
    np.testing.assert_array_equal(uni.numpy(), uni_j)
    # 1 ulp of each log: the inner log's carries through the outer as at
    # most an ulp of 1 (d log x = dx / x), the outer log's is an ulp of the
    # value; near 0 (u near 1/e) the first is many ulps of the value
    gum = cuda_sampler.gumbel(seed, steps, rows, m).numpy()
    bound = np.spacing(np.float32(1)) + np.spacing(np.abs(gum_j))
    assert (np.abs(gum - gum_j) <= bound).all()


def _models(layers, variant, tie, dtype, seed=3):
    """Random weights at init_std 0.1: logits of order 0.3, so T = 1 draws
    depend on them, and a recurrence that contracts (at 0.3 it is chaotic
    and carries a 1e-7 difference in the sums to 1e-4 within 64 steps)."""
    kw = dict(vocab=256, hidden=128, num_layers=layers, cell_variant=variant,
              tie_embeddings=tie, compute_dtype=dtype)
    jcfg, tcfg = JConfig(init_std=0.1, **kw), TConfig(**kw)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp, "params"), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _inputs(cfg_layers, hidden, seed=5):
    """A primed-looking state and first bytes, from numpy."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 256, B).astype(np.int32)
    h0 = (rng.standard_normal((cfg_layers, B, hidden)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((cfg_layers, B, hidden)) * 0.5).astype(np.float32)
    return first, h0, c0


def _first_diff_gap(tp, tcfg, seed, first, h0, c0, got, want, temperature):
    """The plain version's top-two score gap at the first step where the
    two runs' tokens differ."""
    t = int(np.nonzero((got != want).any(axis=1))[0][0])
    params = tmodel._substitute_tied_embed(tp, tcfg)
    cfg = dataclasses.replace(tcfg, tie_embeddings=False)
    args = (params, cfg, seed, torch.from_numpy(first), torch.from_numpy(h0),
            torch.from_numpy(c0))
    if t:
        _, (h, c), _ = cuda_sampler.generate_plain(*args, t, temperature,
                                                  trace=True)
        h, c = h[-1], c[-1]
        ch = torch.from_numpy(got[t - 1])
    else:
        h, c, ch = args[4], args[5], args[3]
    packed = cuda_sampler.pack_weights(params, cfg)
    wus = [w.float() for w in cuda_sampler.layer_weights(packed.WU, cfg)]
    rows = torch.arange(B)
    _, _, scores = cuda_sampler.plain_step(
        wus, packed, h, c, ch, cfg, seed, torch.full_like(rows, t), rows,
        temperature)
    top2 = scores.topk(2, dim=-1).values
    return t, float((top2[:, 0] - top2[:, 1]).min())


def test_pack_weights_keeps_the_biases_fp32():
    """As pallas_sampler.py:218-222: [W; U] and Why in the compute type, b
    and by in fp32 and unrounded (the JAX scan rounds them; the kernel
    does not)."""
    _, _, tcfg, tp = _models(2, "reference", False, "bfloat16")
    tp.layers[1].b.add_(1e-3)   # values that bf16 would round
    packed = cuda_sampler.pack_weights(tp, tcfg)
    assert packed.WU.dtype == packed.Why.dtype == torch.bfloat16
    assert packed.b.dtype == packed.by.dtype == torch.float32
    assert torch.equal(packed.b, torch.stack([l.b for l in tp.layers]))
    assert torch.equal(packed.by, tp.by)
    wus = cuda_sampler.layer_weights(packed.WU, tcfg)
    for layer, wu in zip(tp.layers, wus):
        assert torch.equal(wu, torch.cat([layer.W, layer.U]).bfloat16())


def test_first_argmax_takes_the_first_maximum():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                           [-1.0, -2.0, -1.0, -3.0]])
    got = cuda_sampler.first_argmax(scores)
    assert got.dtype == torch.int32 and got.tolist() == [1, 0, 0]


@pytest.mark.parametrize("temperature", [0.7, 1.0, 3.0, 1e-8])
def test_inv_temperature_is_the_fp32_of_the_double(temperature):
    """pallas_sample_ids makes inv_t = 1.0 / float(T) in double; the kernel
    reads it as an fp32 constant. T = 0 is greedy."""
    assert cuda_sampler.inv_temperature(temperature) == np.float32(1.0 / temperature)
    assert cuda_sampler.inv_temperature(0.0) == 0.0


MODELS = [(layers, variant, tie) for layers in (1, 2)
          for variant in ("reference", "standard") for tie in (False, True)]
MODES = [("float32", 0.0, 64), ("float32", 1.0, 64), ("bfloat16", 0.0, 32)]


@pytest.mark.parametrize("dtype,temperature,length", MODES)
@pytest.mark.parametrize("layers,variant,tie", MODELS)
def test_generate_plain_matches_the_jax_kernel(layers, variant, tie, dtype,
                                               temperature, length):
    jcfg, jp, tcfg, tp = _models(layers, variant, tie, dtype)
    first, h0, c0 = _inputs(layers, 128)
    key = jax.random.PRNGKey(11)
    ids_j, (hj, cj) = jsampler.sample_ids(
        jp, jcfg, key, jnp.asarray(first), jnp.asarray(h0), jnp.asarray(c0),
        length, temperature=temperature, backend="pallas")
    seed = jax_seed(key)
    params, cfg = tp, tcfg
    if tie:
        params = tmodel._substitute_tied_embed(tp, tcfg)
        cfg = dataclasses.replace(tcfg, tie_embeddings=False)
    ids_t, (ht, ct) = cuda_sampler.generate_plain(
        params, cfg, seed, torch.from_numpy(first), torch.from_numpy(h0),
        torch.from_numpy(c0), length, temperature)
    got, want = ids_t.numpy(), np.asarray(ids_j)
    assert ids_t.dtype == torch.int32 and got.shape == (length, B)
    if not np.array_equal(got, want):
        t, gap = _first_diff_gap(tp, tcfg, seed, first, h0, c0, got, want,
                                 temperature)
        pytest.fail(f"tokens differ first at step {t}; the plain version's "
                    f"smallest top-two score gap there is {gap:.3e}")
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **tol)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **tol)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_flagship_weights_token_exact(temperature):
    """16 fp32 tokens of the 3x1024 flagship at B = 8 against the JAX kernel
    in interpret mode (called directly: its TPU VMEM gate refuses this
    width)."""
    with np.load(FLAGSHIP) as z:
        arrays = {k: z[k] for k in z.files if k.startswith("params")}
    kw = dict(hidden=1024, num_layers=3)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jp = jckpt._unflatten_like(jmodel.init_params(jcfg), "params", arrays)
    tp = tckpt.params_from_numpy(arrays, tcfg, "cpu")
    first = np.frombuffer(b"Thy God ", np.uint8).astype(np.int32)
    h0 = np.zeros((3, B, 1024), np.float32)
    key = jax.random.PRNGKey(2)
    ids_j, _ = jps.pallas_sample_ids(jp, jcfg, key, jnp.asarray(first),
                                     jnp.asarray(h0), jnp.asarray(h0), 16,
                                     temperature)
    ids_t, _ = cuda_sampler.generate_plain(
        tp, tcfg, jax_seed(key), torch.from_numpy(first),
        torch.from_numpy(h0), torch.from_numpy(h0), 16, temperature)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


@pytest.mark.parametrize("variant", ["reference", "standard"])
def test_fp32_greedy_plain_equals_the_loop(variant):
    """In fp32 the kernel's fp32 biases are the loop's own: the two decode
    the same tokens."""
    _, _, tcfg, tp = _models(2, variant, False, "float32", seed=8)
    first, h0, c0 = (torch.from_numpy(x) for x in _inputs(2, 128, seed=9))
    ids_p, (hp, cp) = cuda_sampler.generate_plain(tp, tcfg, 0, first, h0, c0,
                                                  48, 0.0)
    ids_l, (hl, cl) = tsampler.sample_ids(tp, tcfg, None, first, h0, c0, 48,
                                          0.0, backend="loop")
    assert ids_p.dtype == ids_l.dtype == torch.int32
    torch.testing.assert_close(ids_p, ids_l, rtol=0, atol=0)
    np.testing.assert_allclose(hp.numpy(), hl.numpy(), **FP32)
    np.testing.assert_allclose(cp.numpy(), cl.numpy(), **FP32)


def test_auto_on_the_cpu_is_the_loop():
    _, _, tcfg, tp = _models(1, "reference", False, "float32")
    first, h0, c0 = (torch.from_numpy(x) for x in _inputs(1, 128))
    for temperature in (0.0, 0.7):
        runs = [tsampler.sample_ids(tp, tcfg, torch.Generator().manual_seed(4),
                                    first, h0, c0, 24, temperature,
                                    backend=backend)
                for backend in ("auto", "loop")]
        torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)


class FakeCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("hidden,dtype", [(100, "float32"),
                                          (128, "float64")])
def test_auto_on_the_card_raises_for_a_model_the_kernel_does_not_take(
        monkeypatch, hidden, dtype):
    """On a CUDA tensor "auto" is the kernel: a width or compute type that
    it does not take raises in ``generate``, before any build, and never
    falls back to the forward_step loop."""
    def no_build():
        raise AssertionError("the kernel was built")

    def no_loop(*args, **kwargs):
        raise AssertionError("the forward_step loop ran")

    monkeypatch.setattr(cuda_sampler._build, "load_library", no_build)
    monkeypatch.setattr(tmodel, "forward_step", no_loop)
    cfg = TConfig(hidden=hidden, vocab=16, compute_dtype=dtype)
    params = tmodel.init_params(cfg, device="cpu")
    params = tmodel.LSTMParams(
        tuple(tmodel.LayerParams(*(x.as_subclass(FakeCuda)
                                   for x in (l.W, l.U, l.b)))
              for l in params.layers),
        params.Why.as_subclass(FakeCuda), params.by.as_subclass(FakeCuda))
    h0, c0 = (x.as_subclass(FakeCuda) for x in tmodel.init_state(cfg, 1, device="cpu"))
    first = torch.zeros(1, dtype=torch.int64).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="no generation kernel"):
        tsampler.sample_ids(params, cfg, torch.Generator(), first, h0, c0, 4)


def test_backend_argument_checks():
    _, _, tcfg, tp = _models(1, "reference", False, "float32")
    first, h0, c0 = (torch.from_numpy(x) for x in _inputs(1, 128))
    with pytest.raises(ValueError, match="cuda backend on device cpu"):
        tsampler.sample_ids(tp, tcfg, None, first, h0, c0, 4, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tsampler.sample_ids(tp, tcfg, None, first, h0, c0, 4, backend="xla")
    with pytest.raises(ValueError, match="length"):
        cuda_sampler.generate(tp, tcfg, 0, first, h0, c0, 0)
    with pytest.raises(ValueError, match="temperature"):
        cuda_sampler.generate(tp, tcfg, 0, first, h0, c0, 4, -1.0)
    with pytest.raises(ValueError, match="outside"):
        cuda_sampler.generate(tp, tcfg, 0, first + 300, h0, c0, 4)
    with pytest.raises(ValueError, match="shape"):
        cuda_sampler.generate(tp, tcfg, 0, first, h0[:, :2], c0, 4)


@pytest.mark.parametrize("path", SHIPPED)
def test_every_shipped_checkpoint_passes_the_gate(path):
    """The card's path is the kernel for every shipped checkpoint, at B = 1
    (``sample_text``) and B = 128; the gate refuses what the kernel does
    not take."""
    with np.load(os.path.join(ROOT, "artifacts", path)) as z:
        n, m = z["params.Why"].shape
        layers = sum(k.endswith(".U") for k in z.files if k.startswith("params"))
    for dtype in ("float32", "bfloat16"):
        cfg = TConfig(hidden=n, vocab=m, num_layers=layers, compute_dtype=dtype)
        assert cuda_sampler.supported(cfg, 1) and cuda_sampler.supported(cfg, 128)
    assert not cuda_sampler.supported(TConfig(hidden=100), 1)
    assert not cuda_sampler.supported(TConfig(vocab=300), 1)
    assert not cuda_sampler.supported(TConfig(), 0)
    assert not cuda_sampler.supported(TConfig(compute_dtype="float64"), 1)


def test_seeded_draws_repeat_and_advance():
    """A generator gives the kernel's seed (``draw_seed``, as
    ``sample_ids`` draws it): the same generator state gives the same
    tokens, and each draw advances it."""
    _, _, tcfg, tp = _models(1, "standard", False, "float32")
    first, h0, c0 = (torch.from_numpy(x) for x in _inputs(1, 128))
    gen = torch.Generator().manual_seed(21)
    run = lambda g: cuda_sampler.generate_plain(
        tp, tcfg, tsampler.draw_seed(g, "cpu"), first, h0, c0, 32, 1.0)[0]
    a, b = run(gen), run(gen)
    again = run(torch.Generator().manual_seed(21))
    assert torch.equal(a, again) and not torch.equal(a, b)


def test_trainer_sample_advances_its_generator():
    """Consecutive ``Trainer.sample`` calls differ, as the JAX trainer splits
    its key before each sample (eigen_lstm_tpu/train/trainer.py:758-768)."""
    data = np.frombuffer(b"the quick brown fox jumps over the lazy dog. " * 40,
                         np.uint8)
    cfg = TConfig(hidden=32, num_layers=1)
    tr = TTrainer(cfg, TData(batch=4, seq=8), TTrain(seed=1), data, None,
                  cell_fn=tselect("plain", cfg, 4, "cpu"), device="cpu")
    a, b = tr.sample(64), tr.sample(64)
    assert len(a) == len(b) == 64 and a != b
