"""The port's native IO binding (``utils/native.py``) and the reference's
text checkpoints (``utils/ref_io.py``) against their plain versions and
the JAX package's: ``tests/test_native.py`` and ``tests/test_ref_io.py``
held for the port, each function equal to its Python version and to the
JAX binding of the same C++, and the text checkpoints written by one
package read by the other. The JAX test that reads the reference tree's
own checkpoints needs files this box does not have; the JAX exporter
writes them instead."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigen_lstm_tpu import ModelConfig as JConfig
from eigen_lstm_tpu.data import corpus as jcorpus
from eigen_lstm_tpu.models import init_params as jinit
from eigen_lstm_tpu.utils import native as jnative
from eigen_lstm_tpu.utils import ref_io as jref_io

from eigen_lstm_tpu_torch import ModelConfig
from eigen_lstm_tpu_torch.data import corpus as corpus_mod
from eigen_lstm_tpu_torch.models import lstm as model
from eigen_lstm_tpu_torch.train.checkpoint import params_from_numpy
from eigen_lstm_tpu_torch.utils import native, ref_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=32, hidden=8, num_layers=1, seed=0)


def _params(cfg_kw=CFG, seed=0):
    """Seeded params in both packages, from the same numpy arrays."""
    cfg = ModelConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    arrs = {k: rng.normal(size=t.shape).astype(np.float32) for k, t in
            model.init_params(cfg, device="cpu").named_tensors()}
    jp = jinit(JConfig(**cfg_kw))
    leaves = [jnp.asarray(arrs[k]) for k, _ in
              model.init_params(cfg, device="cpu").named_tensors()]
    return (params_from_numpy(arrs, cfg, "cpu"),
            jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp), leaves))


def test_native_builds_into_the_port_build_dir():
    """One g++ call into ``eigen_lstm_tpu_torch/_build/`` under a name with
    the source's hash; ``native/`` (the JAX package's build) is not
    touched."""
    path = native.build()
    assert os.path.dirname(path) == os.path.join(ROOT, "eigen_lstm_tpu_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("libeigenlstm_io_")
    assert native.SOURCE == os.path.join(ROOT, "native", "eigenlstm_io.cpp")
    assert native.available() and native.lib() is native.lib()
    assert not any(n.endswith(".tmp") for n in os.listdir(os.path.dirname(path)))


def test_read_file_and_rawread(tmp_path):
    """``read_file``: native, plain and the JAX binding give the file's
    bytes; a missing file raises FileNotFoundError in both versions, an
    empty one ValueError; ``corpus.rawread`` reads through the library."""
    p = tmp_path / "c.bin"
    payload = bytes(range(256)) * 10
    p.write_bytes(payload)
    want = np.frombuffer(payload, np.uint8)
    for fn in (native.read_file, native.read_file_plain, jnative.read_file):
        np.testing.assert_array_equal(fn(str(p)), want)
    for fn in (native.read_file, native.read_file_plain):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "missing.bin"))
    (tmp_path / "empty").write_bytes(b"")
    with pytest.raises(ValueError, match="empty corpus"):
        native.read_file(str(tmp_path / "empty"))
    before = native.calls["read_file"]
    np.testing.assert_array_equal(corpus_mod.rawread(str(p)),
                                  jcorpus.rawread(str(p)))
    assert native.calls["read_file"] == before + 1


def test_build_windows_matches_plain_jax_and_the_device_batcher():
    """(x, t) at three cursors, the last at the corpus's end: native, plain,
    the JAX binding and the port's ``make_windows`` alike; a window past
    the end raises."""
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, 256, 500).astype(np.uint8)
    positions = np.asarray([0, 100, 500 - 17], np.int32)
    x, t = native.build_windows(corpus, positions, seq=16)
    for other in (native.build_windows_plain(corpus, positions, 16),
                  jnative.build_windows(corpus, positions, 16),
                  corpus_mod.make_windows(torch.from_numpy(corpus),
                                          torch.from_numpy(positions), 16)):
        np.testing.assert_array_equal(x, np.asarray(other[0]))
        np.testing.assert_array_equal(t, np.asarray(other[1]))
    with pytest.raises(ValueError, match="out of range"):
        native.build_windows(np.zeros(50, np.uint8), np.asarray([45], np.int32), 10)


@pytest.mark.parametrize("stride,length", [(10, 50), (7, 41), (100, 30)])
def test_advance_positions_matches_plain_jax_and_the_device(stride, length):
    """The cursor advance with the wrap: native, plain, the JAX binding and
    the port's ``advance_positions`` alike; the input is left as it was."""
    positions = np.asarray([0, 13, 25, 30], np.int32)
    keep = positions.copy()
    nxt, wrapped = native.advance_positions(positions, stride, length, 10)
    np.testing.assert_array_equal(positions, keep)
    assert wrapped.any()
    for other in (native.advance_positions_plain(positions, stride, length, 10),
                  jnative.advance_positions(positions, stride, length, 10)):
        np.testing.assert_array_equal(nxt, other[0])
        np.testing.assert_array_equal(wrapped, other[1])
    if length - 11 >= 1:
        dev = corpus_mod.advance_positions(torch.from_numpy(positions), stride,
                                           length, 10)
        np.testing.assert_array_equal(nxt, dev[0].numpy())
        np.testing.assert_array_equal(wrapped, dev[1].numpy())


def test_text_matrix_codec_matches_plain_and_jax(tmp_path):
    """``write_matrix`` writes the bytes of its plain version and of the JAX
    binding; ``parse_floats`` reads them back (rtol 1e-9) as the plain
    version and the JAX binding do; more values than expected raise."""
    mat = np.random.default_rng(1).normal(size=(7, 5))
    paths = [str(tmp_path / f"m{i}.txt") for i in range(3)]
    native.write_matrix(paths[0], mat)
    native.write_matrix_plain(paths[1], mat)
    jnative.write_matrix(paths[2], mat)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] == data[2]
    back = native.parse_floats(paths[0], 35)
    np.testing.assert_allclose(back.reshape(7, 5), mat, rtol=1e-9)
    np.testing.assert_array_equal(back, native.parse_floats_plain(paths[0], 35))
    np.testing.assert_array_equal(back, jnative.parse_floats(paths[0], 35))
    with pytest.raises(ValueError, match="more than"):
        native.parse_floats(paths[0], 4)
    with pytest.raises(FileNotFoundError):
        native.parse_floats(str(tmp_path / "missing.txt"), 4)


def test_roundtrip(tmp_path):
    """Save, then load: every tensor back (``tests/test_ref_io.py``'s
    tolerances, rtol 1e-6 / atol 1e-7)."""
    params, _ = _params()
    prefix = str(tmp_path / "ck")
    ref_io.save_reference_checkpoint(params, prefix)
    loaded = ref_io.load_reference_checkpoint(prefix, ModelConfig(**CFG), "cpu")
    for (name, a), b in zip(params.named_tensors(), model.tensors(loaded)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_wrong_size_rejected(tmp_path):
    params, _ = _params()
    prefix = str(tmp_path / "ck")
    ref_io.save_reference_checkpoint(params, prefix)
    with pytest.raises(ValueError, match="expected"):
        ref_io.load_reference_checkpoint(
            prefix, ModelConfig(vocab=32, hidden=16, num_layers=1), "cpu")
    with pytest.raises(ValueError, match="1-layer"):
        ref_io.load_reference_checkpoint(
            prefix, ModelConfig(vocab=32, hidden=8, num_layers=2), "cpu")
    two, _ = _params(dict(CFG, num_layers=2))
    with pytest.raises(ValueError, match="1-layer"):
        ref_io.save_reference_checkpoint(two, prefix)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_text_checkpoints_cross_between_packages(tmp_path, writer):
    """The same weights written by one package and read by the other: the
    five files byte for byte the other package's, and the weights read in
    both packages equal (rtol 1e-6 / atol 1e-7 to the originals)."""
    params, jparams = _params(dict(vocab=64, hidden=16, num_layers=1), seed=3)
    cfg = ModelConfig(vocab=64, hidden=16, num_layers=1)
    prefix, other = str(tmp_path / "a" / "ck"), str(tmp_path / "b" / "ck")
    if writer == "port":
        ref_io.save_reference_checkpoint(params, prefix)
        jref_io.save_reference_checkpoint(jparams, other)
    else:
        jref_io.save_reference_checkpoint(jparams, prefix)
        ref_io.save_reference_checkpoint(params, other)
    for name in ("W", "U", "b", "Why", "by"):
        with open(f"{prefix}_{name}.txt", "rb") as f, \
                open(f"{other}_{name}.txt", "rb") as g:
            assert f.read() == g.read(), name
    tp = ref_io.load_reference_checkpoint(prefix, cfg, "cpu")
    jp = jref_io.load_reference_checkpoint(prefix, JConfig(vocab=64, hidden=16))
    for (name, a), b, c in zip(params.named_tensors(), model.tensors(tp),
                               jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_array_equal(b.numpy(), np.asarray(c), err_msg=name)
