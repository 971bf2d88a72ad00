"""The port's binding of the repo's native IO library
(``native/eigenlstm_io.cpp``, the C++ that ``eigen_lstm_tpu/utils/native.py``
binds): corpus reading, host-side window building and cursor advance, and
the reference's text matrix codec, through ``ctypes``.

The C++ is the repo's; it is not copied. At the first call of a process the
library is built by one ``g++ -O3 -shared -fPIC`` call into
``eigen_lstm_tpu_torch/_build/``, under a name that carries a hash of the
source, written to a temporary name and then renamed, so processes that
build it side by side never load half a file (``make -C native`` writes
``native/libeigenlstm_io.so``, which the JAX package builds too).

Each function has the JAX module's Python version beside it as its plain
version (``*_plain``): this is host IO, not a device kernel. Where the
library cannot be built (no compiler, no source) the functions run their
plain versions and say why once, on standard error; ``available()`` and
``lib()`` tell a caller that needs the library (``lib()`` raises with the
compiler's output). ``calls`` counts the native calls of each function.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "eigenlstm_io.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

calls = collections.Counter()


class _State:
    lib: Optional[ctypes.CDLL] = None
    error: Optional[str] = None
    warned = False


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libeigenlstm_io_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first unless a build of the same source
    is there: one ``g++`` call to a temporary name, then a rename. Raises
    with the compiler's output when it fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++")] + CXX_FLAGS + ["-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process; raises
    with the reason when it cannot be built or loaded."""
    if _State.lib is None:
        lib_ = ctypes.CDLL(build())
        i64, i32, u8, f64, P = (ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8,
                                ctypes.c_double, ctypes.POINTER)
        for name, restype, argtypes in (
            ("elio_file_size", i64, [ctypes.c_char_p]),
            ("elio_read_file", i64, [ctypes.c_char_p, P(u8), i64]),
            ("elio_build_windows", ctypes.c_int,
             [P(u8), i64, P(i32), i32, i32, P(i32), P(i32)]),
            ("elio_advance_positions", None, [P(i32), i32, i32, i64, i32, P(u8)]),
            ("elio_parse_floats", i64, [ctypes.c_char_p, P(f64), i64]),
            ("elio_write_matrix", ctypes.c_int, [ctypes.c_char_p, P(f64), i64, i64]),
        ):
            fn = getattr(lib_, name)
            fn.restype, fn.argtypes = restype, argtypes
        _State.lib = lib_
    return _State.lib


def _lib() -> Optional[ctypes.CDLL]:
    """The library, or None (said once) where it cannot be built."""
    if _State.lib is None and _State.error is None:
        try:
            lib()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _State.error = f"{type(e).__name__}: {e}"
    if _State.error is not None and not _State.warned:
        _State.warned = True
        print(f"[native] the IO library is not available, its functions run "
              f"their plain versions: {_State.error}", file=sys.stderr,
              flush=True)
    return _State.lib


def available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_file_plain(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(bytearray(f.read()), np.uint8)


def read_file(path: str) -> np.ndarray:
    """The whole file as uint8 (the reference's ``rawread``)."""
    lib_ = _lib()
    if lib_ is None:
        return read_file_plain(path)
    calls["read_file"] += 1
    size = lib_.elio_file_size(path.encode())
    if size < 0:
        raise FileNotFoundError(path)
    if size == 0:
        raise ValueError(f"empty corpus: {path}")
    buf = np.empty(size, np.uint8)
    got = lib_.elio_read_file(path.encode(), _ptr(buf, ctypes.c_uint8), size)
    if got != size:
        raise IOError(f"short read on {path}: {got}/{size}")
    return buf


def build_windows_plain(corpus: np.ndarray, positions: np.ndarray, seq: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    offs = np.arange(seq + 1)
    win = corpus[positions[None, :] + offs[:, None]].astype(np.int32)
    return np.ascontiguousarray(win[:-1]), np.ascontiguousarray(win[1:])


def build_windows(corpus: np.ndarray, positions: np.ndarray, seq: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(x, t), each (S, B) int32: the windows at the cursors and their
    next-byte targets; ValueError for a window past the corpus."""
    lib_ = _lib()
    if lib_ is None:
        return build_windows_plain(corpus, positions, seq)
    calls["build_windows"] += 1
    corpus = np.ascontiguousarray(corpus, np.uint8)
    positions = np.ascontiguousarray(positions, np.int32)
    x = np.empty((seq, len(positions)), np.int32)
    t = np.empty((seq, len(positions)), np.int32)
    rc = lib_.elio_build_windows(_ptr(corpus, ctypes.c_uint8), len(corpus),
                                 _ptr(positions, ctypes.c_int32), len(positions),
                                 seq, _ptr(x, ctypes.c_int32),
                                 _ptr(t, ctypes.c_int32))
    if rc != 0:
        raise ValueError("position out of range for window build")
    return x, t


def advance_positions_plain(positions: np.ndarray, stride: int,
                            corpus_len: int, seq: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    pos = np.ascontiguousarray(positions, np.int32)
    limit = max(corpus_len - seq - 1, 1)
    nxt = pos.astype(np.int64) + stride
    wrapped = nxt > limit
    nxt = np.where(wrapped, nxt % limit, nxt)
    return nxt.astype(np.int32), wrapped


def advance_positions(positions: np.ndarray, stride: int, corpus_len: int,
                      seq: int) -> Tuple[np.ndarray, np.ndarray]:
    """The cursors advanced by ``stride`` with the wrap at EOF: (new
    positions, wrapped); ``positions`` is left as it was."""
    lib_ = _lib()
    if lib_ is None:
        return advance_positions_plain(positions, stride, corpus_len, seq)
    calls["advance_positions"] += 1
    pos = np.ascontiguousarray(positions, np.int32).copy()
    wrapped = np.empty(len(pos), np.uint8)
    lib_.elio_advance_positions(_ptr(pos, ctypes.c_int32), len(pos), stride,
                                corpus_len, seq, _ptr(wrapped, ctypes.c_uint8))
    return pos, wrapped.astype(bool)


def parse_floats_plain(path: str, expected: int) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def parse_floats(path: str, expected: int) -> np.ndarray:
    """The whitespace-separated floats of a text matrix file, at most
    ``expected`` of them (ValueError past that)."""
    lib_ = _lib()
    if lib_ is None:
        return parse_floats_plain(path, expected)
    calls["parse_floats"] += 1
    out = np.empty(expected, np.float64)
    n = lib_.elio_parse_floats(path.encode(), _ptr(out, ctypes.c_double),
                               expected)
    if n == -1:
        raise FileNotFoundError(path)
    if n < 0:
        raise ValueError(f"{path}: more than {expected} values")
    return out[:n]


def write_matrix_plain(path: str, mat: np.ndarray) -> None:
    np.savetxt(path, np.atleast_2d(mat), fmt="%.10g")


def write_matrix(path: str, mat: np.ndarray) -> None:
    """A row a line, ``%.10g`` values separated by spaces (the reference's
    ``file << m``)."""
    lib_ = _lib()
    if lib_ is None:
        return write_matrix_plain(path, mat)
    calls["write_matrix"] += 1
    mat2 = np.ascontiguousarray(np.atleast_2d(mat), np.float64)
    rc = lib_.elio_write_matrix(path.encode(), _ptr(mat2, ctypes.c_double),
                                mat2.shape[0], mat2.shape[1])
    if rc != 0:
        raise IOError(f"failed to write {path}")
