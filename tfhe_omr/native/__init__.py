"""C++ host runtime (ctypes): client-side decoder hot loops.

Builds ``omr_host.cpp`` with g++ on first import (cached as a .so next to the
source); every entry point has a NumPy fallback in tfhe_omr.core, so the
framework works even without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "omr_host.cpp")
_LIB_PATH = os.path.join(_HERE, "_omr_host.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-pthread",
        "-o",
        _LIB_PATH,
        _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(
            _LIB_PATH
        ) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.omr_solve_matrix.restype = ctypes.c_int
        lib.omr_solve_matrix.argtypes = [
            i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p,
        ]
        lib.omr_scan_buckets.restype = ctypes.c_int
        lib.omr_scan_buckets.argtypes = [
            i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def solve_matrix_native(matrix: np.ndarray, rhs: np.ndarray, p: int):
    """C++ Gaussian elimination mod p; returns None if lib unavailable or
    singular (caller falls back / raises)."""
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(np.mod(matrix, p), dtype=np.int64)
    r = np.ascontiguousarray(np.mod(rhs, p), dtype=np.int64)
    rows, cols = m.shape
    plen = r.shape[1]
    out = np.empty((cols, plen), dtype=np.int64)
    rc = lib.omr_solve_matrix(m, r, rows, cols, plen, p, out)
    if rc != 0:
        from tfhe_omr.core.errors import InvertibleMatrixError

        raise InvertibleMatrixError("singular weight matrix (native)")
    return out


def scan_buckets_native(
    decoded: np.ndarray,
    n_seg: int,
    sps: int,
    spb: int,
    n_buckets: int,
    p: int,
    max_index: int,
):
    """C++ flag-scan; returns an int64 array of indices or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(decoded, dtype=np.int64)
    cap = n_seg * n_buckets
    out = np.empty(cap, dtype=np.int64)
    n = lib.omr_scan_buckets(d, n_seg, sps, spb, n_buckets, p, max_index, out, cap)
    return out[:n]
