"""Native C++ geometry runtime (KD-tree, ICP, normals) via ctypes.

Builds geomlib.cpp on first use (g++, no external deps); callers fall back
to the scipy implementations in tools/ when the toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "geomlib.cpp")
_LIB = os.path.join(os.path.dirname(_DIR), "_build", "libgeomlib.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # built beside the port's CUDA kernels, under a temporary name that is
    # renamed into place, so processes that build at once never load a
    # half-written library
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception as e:  # missing compiler etc.
        print(f"geomlib build failed ({e}); falling back to scipy paths")
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or (os.path.getmtime(_LIB)
                                    < os.path.getmtime(_SRC)):
        if not _build():
            return None
    lib = ctypes.CDLL(_LIB)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [f32p, ctypes.c_int]
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_query.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int, f32p, i32p]
    lib.kdtree_knn.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                               ctypes.c_int, i32p]
    lib.icp_p2p.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                            ctypes.c_float, ctypes.c_int, f64p]
    lib.estimate_normals.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.chamfer_stats.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                                  f64p, f64p]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _as_f32(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.float32).reshape(-1, 3))


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeKDTree:
    """Drop-in for scipy.cKDTree's query() over 3-D points."""

    def __init__(self, points):
        lib = load()
        assert lib is not None, "native geomlib unavailable"
        self._lib = lib
        self._pts = _as_f32(points)
        self._handle = lib.kdtree_build(_fp(self._pts), len(self._pts))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None

    def query(self, queries, k: int = 1):
        q = _as_f32(queries)
        n = len(q)
        if k == 1:
            dist = np.empty(n, np.float32)
            idx = np.empty(n, np.int32)
            self._lib.kdtree_query(self._handle, _fp(q), n,
                                   _fp(dist),
                                   idx.ctypes.data_as(
                                       ctypes.POINTER(ctypes.c_int)))
            return dist.astype(np.float64), idx.astype(np.int64)
        idx = np.empty((n, k), np.int32)
        self._lib.kdtree_knn(self._handle, _fp(q), n, k,
                             idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return None, idx.astype(np.int64)


def icp_p2p(src, dst, threshold: float, init=None,
            max_iterations: int = 30) -> np.ndarray:
    lib = load()
    assert lib is not None
    s, d = _as_f32(src), _as_f32(dst)
    tr = np.ascontiguousarray(
        np.eye(4) if init is None else np.asarray(init, np.float64))
    lib.icp_p2p(_fp(s), len(s), _fp(d), len(d),
                ctypes.c_float(threshold), max_iterations,
                tr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return tr


def estimate_normals(points, k: int = 30) -> np.ndarray:
    lib = load()
    assert lib is not None
    p = _as_f32(points)
    out = np.empty_like(p)
    lib.estimate_normals(_fp(p), len(p), k, _fp(out))
    return out.astype(np.float64)


def chamfer_stats(ref, queries) -> Tuple[float, float]:
    """(mean, median) NN distance from queries into ref."""
    lib = load()
    assert lib is not None
    r, q = _as_f32(ref), _as_f32(queries)
    mean = ctypes.c_double()
    med = ctypes.c_double()
    lib.chamfer_stats(_fp(r), len(r), _fp(q), len(q),
                      ctypes.byref(mean), ctypes.byref(med))
    return mean.value, med.value
