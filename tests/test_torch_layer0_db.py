"""Layer 0's bias gradient against the JAX package's two layer-0 VJPs.

``pallas_embed_layer0`` takes the fused VJP where ``fused_accum_ok`` holds
(``pallas_cell.py:874-881``, a VMEM budget that the fp32 dWU block must
fit): db is the fp32 sum of the unrounded fp32 dg (``:1031-1042``).
Elsewhere, the 3x1024 flagship included at any batch, it takes the GEMM
fall-back (``:1044-1066``): ``_bwd_kernel`` emits dg in the xw type (bf16
under bf16 compute) and db is the fp32 sum of that rounded dg. The port's
dispatch hands K3 the same choice (``ops/dispatch.py:fused_accum_ok``);
here its plain version, through the ``cell_fn.embed_layer0`` that
``select_cell_fn("auto", cfg, 8, "cpu")`` returns, against the JAX VJP in
interpret mode, bf16 with fp32 residuals, B = 8.

Tolerances. db at S = 1: within 1e-5 of its largest magnitude in at least
99 % of its 4N columns. The two rules differ by one bf16 rounding of each
dg term, so the wrong rule misses 1e-5 in over 90 % of the columns (by up
to ~2e-3); the right one can miss it only where a float32 sum of the
forward, taken in another order, flips one bf16 rounding of a dg term,
which moves that column alone (0 to 3 of 4096 columns in these runs). The
other gradients, and all five at S = 4, within 2e-2 of their largest
magnitude, each a bf16 value exactly where the JAX VJP's is
(tests/test_torch_train_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.models import lstm as jmodel
from eigen_lstm_tpu.ops.pallas_cell import pallas_embed_layer0
from eigen_lstm_tpu_torch import ModelConfig as TConfig
from eigen_lstm_tpu_torch.models import lstm as tmodel
from eigen_lstm_tpu_torch.ops import cuda_cell_bwd, dispatch

B, M = 8, 256
DB_FRAC, DB_COLUMNS, BF16_FRAC = 1e-5, 0.99, 2e-2
NAMES = ("dW", "dU", "db", "dh0", "dc0")


def db_columns_within(got, want) -> float:
    """The share of db's columns within DB_FRAC of its largest magnitude
    of the reference's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= DB_FRAC * np.abs(want).max()).mean())


def _bf16_valued(x) -> bool:
    t = torch.from_numpy(np.array(x, np.float32))
    return bool((t.bfloat16().float() == t).all())


def _grads(n, s, seed=0, rows=B, built_at=B, fused_accum=None):
    """The five gradients of layer 0 at hidden ``n`` over ``s`` steps on
    ``rows`` rows: the JAX VJP's and the port's, on the same numpy inputs
    (weights that make the gates move, normal cotangents), the port's
    ``embed_layer0`` from ``select_cell_fn`` at batch ``built_at`` (with
    ``fused_accum`` forced where given); and the ``fused_accum`` the call
    had bound or forced (None: chosen at the call, ``_took``)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, sd=1.0: (rng.normal(size=shape) * sd).astype(np.float32)
    W, U, b = f32(M, 4 * n, sd=0.3), f32(n, 4 * n, sd=0.3 / np.sqrt(n / 16)), f32(4 * n, sd=0.3)
    h0, c0 = f32(rows, n, sd=0.5), f32(rows, n, sd=0.5)
    ids = rng.integers(0, M, (s, rows)).astype(np.int32)
    dh, dhT, dcT = f32(s, rows, n), f32(rows, n), f32(rows, n)
    kw = dict(vocab=M, hidden=n, compute_dtype="bfloat16")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)

    def f(W, U, b, h0, c0):
        return pallas_embed_layer0(jmodel.LayerParams(W, U, b),
                                   jnp.asarray(ids), h0, c0, jcfg)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (W, U, b, h0, c0)))
    jg = vjp((jnp.asarray(dh), (jnp.asarray(dhT), jnp.asarray(dcT))))

    embed = dispatch.select_cell_fn("auto", tcfg, built_at, "cpu").embed_layer0
    assert embed.func is cuda_cell_bwd.differentiable_embed_layer0
    kw = {} if fused_accum is None else {"fused_accum": fused_accum}
    leaves = [torch.from_numpy(a).requires_grad_() for a in (W, U, b, h0, c0)]
    h, (hT, cT) = embed(tmodel.LayerParams(*leaves[:3]), torch.from_numpy(ids),
                        leaves[3], leaves[4], tcfg, **kw)
    obj = ((h.float() * torch.from_numpy(dh)).sum()
           + (hT * torch.from_numpy(dhT)).sum() + (cT * torch.from_numpy(dcT)).sum())
    tg = torch.autograd.grad(obj, leaves)
    return ([np.asarray(g, np.float64) for g in jg],
            [g.double().numpy() for g in tg],
            kw.get("fused_accum", embed.keywords.get("fused_accum")))


def _took(n, rows, fused_accum):
    """The VJP the port's layer 0 takes on ``rows`` rows at hidden ``n``
    with ``fused_accum`` bound (None: chosen at the call)."""
    cfg = TConfig(vocab=M, hidden=n, compute_dtype="bfloat16")
    return cuda_cell_bwd.layer0_fused_accum(cfg, rows, fused_accum)


def _frac(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n,fused", [(1024, False), (512, True)])
def test_layer0_db_at_one_step_follows_the_jax_vjp(n, fused):
    """One step: db within 1e-5 of the JAX VJP's in 99 % of its columns,
    the fall-back's rounded sum at the flagship's width and the fused
    VJP's fp32 sum at the bench's; the other four gradients by the bf16
    rules."""
    jg, tg, fused_accum = _grads(n, 1)
    assert _took(n, B, fused_accum) == fused == dispatch.fused_accum_ok(
        TConfig(vocab=M, hidden=n, compute_dtype="bfloat16"), B)
    share = db_columns_within(tg[2], jg[2])
    assert share >= DB_COLUMNS, share
    for got, want, what in zip(tg, jg, NAMES):
        assert _frac(got, want) <= BF16_FRAC, what
        assert _bf16_valued(got) == _bf16_valued(want), what


def test_layer0_gradients_at_the_flagship_width_over_four_steps():
    """Four steps at the flagship's width (the GEMM fall-back): all five
    gradients by the bf16 rules."""
    jg, tg, fused_accum = _grads(1024, 4, seed=1)
    assert not _took(1024, B, fused_accum)
    for got, want, what in zip(tg, jg, NAMES):
        assert _frac(got, want) <= BF16_FRAC, (what, _frac(got, want))
        assert _bf16_valued(got) == _bf16_valued(want), what


def test_layer0_vjp_is_chosen_at_the_batch_its_kernel_sees():
    """1x512 in bf16 with fp32 residuals (the CLI's ``auto`` at S < 512):
    at B = 256 ``fused_accum_ok`` fails (the GEMM fall-back), at 64 rows
    it holds (the fused VJP). A ``cell_fn`` built at the global batch of
    256 and called on 64 rows, as a data shard of ``--dp 4`` or a
    microchunk of ``--sp`` sees them, takes the JAX package's VJP at 64
    rows: db within 1e-5 in 99 % of its columns, the other gradients by
    the bf16 rules. The fall-back's db at those rows misses that rule."""
    cfg = TConfig(vocab=M, hidden=512, compute_dtype="bfloat16")
    assert not dispatch.fused_accum_ok(cfg, 256) and dispatch.fused_accum_ok(cfg, 64)
    assert dispatch.families(cfg, 256)[1] == "embed_fallback"
    jg, tg, fused_accum = _grads(512, 1, seed=2, rows=64, built_at=256)
    share = db_columns_within(tg[2], jg[2])
    assert share >= DB_COLUMNS, share
    for got, want, what in zip(tg, jg, NAMES):
        assert _frac(got, want) <= BF16_FRAC, what
        assert _bf16_valued(got) == _bf16_valued(want), what
    assert fused_accum is None and _took(512, 64, fused_accum)
    _, frozen, _ = _grads(512, 1, seed=2, rows=64, built_at=256,
                          fused_accum=False)
    assert db_columns_within(frozen[2], jg[2]) < DB_COLUMNS
