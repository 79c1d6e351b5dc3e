"""ctypes loader for the native design-time routines (csrc/lut_core.cpp,
and the PEG construction of csrc/peg.cpp).

Counterpart of lut_ldpc_tpu/_native.py.  The library is built with g++ at
first use into this package's own ``build/torch_kernels/`` (never the JAX
package's ``build/`` library, which is compiled ``-march=native`` for the
machine that built it) and without ``-march`` flags, so a build is valid on
any x86-64 host.  Its file name carries a sha256 over both sources' text
and the g++ flags (``liblutcore_<hash16>.so``, as ``decoder/nvcc``
names the CUDA libraries), so a library on disk is never stale: one built
from other sources (an older ``liblutcore.so`` without ``peg_construct``)
is never loaded.  ``-ffp-contract=off`` keeps results bit-identical to the
numpy implementations, which every caller falls back to when no compiler is
available or ``LUT_LDPC_NO_NATIVE`` is set: the native path is an
accelerator of the host-side design, never a correctness dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_REPO_ROOT, "csrc", "lut_core.cpp"),
         os.path.join(_REPO_ROOT, "csrc", "peg.cpp")]
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")
_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    """``liblutcore_<hash16>.so``: the hash over the sources' text and the
    g++ flags, each part preceded by its length."""
    h = hashlib.sha256()
    for part in [*(open(p, "rb").read() for p in _SRCS), " ".join(_FLAGS).encode()]:
        h.update(len(part).to_bytes(8, "little"))
        h.update(part)
    return os.path.join(_BUILD_DIR, f"liblutcore_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"  # concurrent builds never share a file
    try:
        subprocess.run(["g++", *_FLAGS, *_SRCS, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LUT_LDPC_NO_NATIVE") or not all(map(os.path.exists, _SRCS)):
            return None
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        dptr = ctypes.POINTER(ctypes.c_double)
        iptr = ctypes.POINTER(ctypes.c_int64)
        lib.quant_mi_sym.restype = ctypes.c_double
        lib.quant_mi_sym.argtypes = [dptr, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int32, dptr, iptr]
        lib.chk_update_minsum.restype = None
        lib.chk_update_minsum.argtypes = [dptr, ctypes.c_int64, ctypes.c_int64, dptr]
        i32ptr = ctypes.POINTER(ctypes.c_int32)
        lib.peg_construct.restype = ctypes.c_int32
        lib.peg_construct.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32ptr, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint64, i32ptr, i32ptr,
        ]
        _lib = lib
        return _lib


def _as_dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _as_iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def quant_mi_sym_native(p_in: np.ndarray, Nq: int, is_sorted: bool):
    """Native quant_mi_sym; returns (mi, p_out, Q_out) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p_in = np.ascontiguousarray(p_in, dtype=np.float64)
    p_out = np.empty(Nq, dtype=np.float64)
    Q_out = np.empty(len(p_in), dtype=np.int64)
    mi = lib.quant_mi_sym(
        _as_dptr(p_in), len(p_in), Nq, 1 if is_sorted else 0, _as_dptr(p_out), _as_iptr(Q_out)
    )
    if np.isnan(mi):
        raise ValueError("quant_mi_sym (native): invalid input")
    return float(mi), p_out, Q_out


def chk_update_minsum_native(p_in: np.ndarray, dc: int):
    lib = get_lib()
    if lib is None:
        return None
    p_in = np.ascontiguousarray(p_in, dtype=np.float64)
    out = np.empty(len(p_in), dtype=np.float64)
    lib.chk_update_minsum(_as_dptr(p_in), len(p_in), dc, _as_dptr(out))
    return out
