"""Builds the port's CUDA sources with plain ``nvcc`` calls and loads the
result with ``ctypes``.

The sources (``csrc/*.cu``, with the shared ``csrc/*.cuh``) include no
PyTorch header and export C functions, so the build is seconds of ``nvcc``
and needs neither ``torch.utils.cpp_extension`` nor ``ninja``: one ``nvcc
-c`` per source, all started together, then one link. The library
goes to ``eigen_lstm_tpu_torch/_build/`` under a name that carries a hash
of the sources, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is built on import: ``load_library`` runs at the
first kernel launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_Z = ctypes.c_size_t
_U = ctypes.c_uint
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)   # an array of pointers, or an out-pointer
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_CP = ctypes.c_char_p                   # an IPC handle's 64 bytes
_DROP = [_U, _U, _F]   # the dropout's seed (int32 bits), keep threshold, inv
# (restype, argtypes) of every exported function: c_void_p for pointers and
# the stream, c_int for ints (an unset argtype would pass a pointer as a
# 32-bit int and cut it). The backward, head and tiled launchers add the
# number of kernels they launched to their last argument.
SIGNATURES = {
    "lstm_fwd_embed_launch": (_I, [_I, _I] + [_P] * 14 + [_I] * 4 + _DROP + [_P]),
    "lstm_fwd_scan_launch": (_I, [_I, _I] + [_P] * 12 + [_I] * 4 + _DROP + [_P]),
    "lstm_bwd_embed_launch": (_I, [_I, _I] + [_P] * 15 + [_I] * 7 + _DROP
                              + [_P, _IP]),
    "lstm_bwd_embed_unroll2_launch": (_I, [_I, _I] + [_P] * 15 + [_I] * 7
                                      + _DROP + [_P, _IP]),
    "lstm_bwd_embed_work_floats": (_Z, [_I] * 4),
    "lstm_bwd_scan_launch": (_I, [_I, _I] + [_P] * 14 + [_I] * 5 + _DROP
                             + [_P, _IP]),
    "lstm_bwd_scan_work_floats": (_Z, [_I] * 3),
    "lstm_bwd_persist_launch": (_I, [_I] + [_P] * 13 + [_I] * 9 + _DROP
                                + [_P, _IP]),
    "lstm_bwd_dWU_launch": (_I, [_I] + [_P] * 6 + [_I] * 4 + [_P, _IP]),
    "lstm_bwd_tail_launch": (_I, [_I] + [_P] * 7 + [_I] * 5 + [_P, _IP]),
    "lstm_bwd_f32_launch": (_I, [_I] + [_P] * 11 + [_I] * 8 + _DROP
                            + [_P, _IP]),
    "lstm_bwd_f32_smem_bytes": (_Z, [_I] * 4),
    "lstm_bwd_device_limits": (_I, [_IP, _IP]),
    "lstm_bwd_persist_smem_bytes": (_Z, [_I, _I]),
    "head_fwd_launch": (_I, [_I] + [_P] * 7 + [_I] * 5 + [_P, _IP]),
    "head_bwd_launch": (_I, [_I] + [_P] * 11 + [_I] * 4 + [_P, _IP]),
    "head_fwd_work_floats": (_Z, [_I]),
    "head_bwd_work_floats": (_Z, [_I] * 3),
    "gen_launch": (_I, [_I] + [_P] * 11 + [_I] * 7 + [_U, _F, _P]),
    "tiled_fwd_embed_launch": (_I, [_I, _I] + [_P] * 11 + [_I] * 6 + _DROP
                               + [_P, _IP]),
    "tiled_fwd_scan_launch": (_I, [_I, _I] + [_P] * 9 + [_I] * 6 + _DROP
                              + [_P, _IP]),
    "tiled_fwd_persist_smem_bytes": (_Z, [_I] * 3),
    "tiled_fwd_embed_f32_launch": (_I, [_I] + [_P] * 11 + [_I] * 7 + _DROP
                                   + [_P, _IP]),
    "tiled_fwd_f32_smem_bytes": (_Z, [_I] * 4),
    "tiled_fwd_scan_f32_launch": (_I, [_I] + [_P] * 9 + [_I] * 7 + _DROP
                                  + [_P, _IP]),
    "tiled_bwd_launch": (_I, [_I, _I] + [_P] * 10 + [_I] * 7 + _DROP
                         + [_P, _IP]),
    "tiled_bwd_persist_smem_bytes": (_Z, [_I] * 2),
    "gen_work_floats": (_Z, [_I] * 3),
    "gen_persist_launch": (_I, [_P] * 11 + [_I] * 7 + [_U, _F] + [_I] * 5
                           + [_P, _IP]),
    "gen_persist_smem_bytes": (_Z, [_I] * 5),
    "gen_persist_work_bytes": (_Z, [_I] * 4),
    "gen_persist_f32_launch": (_I, [_P] * 12 + [_I] * 7 + [_U, _F] + [_I] * 5
                               + [_P, _IP]),
    "gen_persist_f32_smem_bytes": (_Z, [_I] * 5),
    "gen_persist_f32_work_bytes": (_Z, [_I] * 4),
    "adagrad_launch": (_I, [_I, _P, _F, _F, _P, _IP]),
    "adagrad_plan_launch": (_I, [_I, _P, _P, _P, _P, _F, _F, _P, _IP]),
    "tp_step_fwd_launch": (_I, [_I] + [_P] * 7 + [_I] * 5 + [_P, _IP]),
    "tp_step_fwd_f32_launch": (_I, [_P] * 7 + [_I] * 8 + [_P, _IP]),
    "tp_step_fwd_f32_smem_bytes": (_Z, [_I] * 3),
    "tp_step_bwd_launch": (_I, [_P] * 7 + [_I] * 3 + [_P]),
    "tp_step_bwd_dh_launch": (_I, [_P] * 11 + [_I] * 6 + [_P, _IP]),
    "tp_step_bwd_dh_smem_bytes": (_Z, [_I] * 4),
    "tp_seq_fwd_launch": (_I, [_I, _I] + [_P] * 9 + [_I] * 7 + [_P, _IP]),
    "tp_seq_bwd_launch": (_I, [_I, _I] + [_P] * 9 + [_I] * 5 + [_P]),
    "tp_seq_fwd_ranks_launch": (_I, [_I, _I, _I, _IP, _IP] + [_PP] * 9
                                + [_I, _PP, _LL, _ULL] + [_I] * 5 + [_P, _IP]),
    "tp_seq_bwd_ranks_launch": (_I, [_I, _I, _I, _IP, _IP] + [_PP] * 9
                                + [_I, _PP, _LL, _ULL] + [_I] * 5 + [_P, _IP]),
    "tp_seq_ranks_resident": (_I, [_I, _I, _I, _IP]),
    "tp_seq_fwd_persist_ranks_launch": (_I, [_I, _I, _IP, _IP, _IP] + [_PP] * 8
                                        + [_I, _PP, _LL, _ULL] + [_I] * 5
                                        + [_P, _IP]),
    "tp_seq_bwd_persist_ranks_launch": (_I, [_I, _I, _IP, _IP] + [_PP] * 10
                                        + [_I, _PP, _LL, _ULL] + [_I] * 7
                                        + [_P, _IP]),
    "tp_seq_bwd_persist_smem_bytes": (_Z, [_I] * 3),
    "tp_seq_fwd_f32_launch": (_I, [_I] + [_P] * 8 + [_I] * 8 + [_P, _IP]),
    "tp_seq_fwd_f32_ranks_launch": (_I, [_I, _I, _IP, _IP, _I, _I, _I] + [_PP] * 8
                                    + [_I, _PP, _LL, _ULL] + [_I] * 5 + [_P, _IP]),
    "tp_seq_bwd_f32_ranks_launch": (_I, [_I, _I, _IP, _I, _I, _I] + [_PP] * 9
                                    + [_I, _PP, _LL, _ULL] + [_I] * 5 + [_P, _IP]),
    "exchange_alloc": (_I, [_Z, _PP]),
    "exchange_free": (_I, [_P]),
    "exchange_ipc_handle": (_I, [_P, _CP]),
    "exchange_ipc_open": (_I, [_CP, _PP]),
    "exchange_ipc_close": (_I, [_P]),
    "exchange_can_access_peer": (_I, [_I, _I, _IP]),
    "exchange_write_pattern": (_I, [_P, _Z, _U]),
    "exchange_read": (_I, [_P, _P, _Z]),
}


class _State:
    lib: Optional[ctypes.CDLL] = None
    build_seconds: Optional[float] = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``; raises with the places searched."""
    searched = []
    cuda_home = os.environ.get("CUDA_HOME")
    for d in ([os.path.join(cuda_home, "bin")] if cuda_home else []) + [
        "/usr/local/cuda/bin"
    ]:
        path = os.path.join(d, "nvcc")
        searched.append(path)
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    searched.append("PATH=" + os.environ.get("PATH", ""))
    if found:
        return found
    raise FileNotFoundError("nvcc not found; searched: " + ", ".join(searched))


def library_path() -> str:
    digest = hashlib.sha256()
    for src in sources() + headers():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"liblstm_kernels_{digest.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Runs the commands side by side and waits for all of them; raises
    with the output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def build() -> str:
    """Compiles every source into one shared library unless a library of
    the same sources is there already: one ``nvcc -c`` per source, all at
    once, then one link. Returns its path; raises with nvcc's output when
    the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src]
                  for src, obj in zip(sources(), objs)])
        tmp = f"{out}.{tag}"
        _run_all([[nvcc] + NVCC_FLAGS + ["-shared", "-o", tmp] + objs])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    _State.build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def build_seconds() -> Optional[float]:
    """Seconds the nvcc calls of this process took; None if the library
    was already built."""
    return _State.build_seconds


def load_library() -> ctypes.CDLL:
    """The kernels' library, built at the first call of the process."""
    if _State.lib is None:
        lib = ctypes.CDLL(build())
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _State.lib = lib
    return _State.lib
