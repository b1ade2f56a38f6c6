"""Native (C++) components, loaded via ctypes.

The compute path is JAX/XLA and Pallas; the host-side runtime pieces that
need native speed live here. Currently: the BVH builder
(bvh_builder.cpp), compiled on demand with g++ into the package dir
(pybind11 is not available in this environment; ctypes + a C ABI is).

`build_bvh_native` mirrors bvh/builder.py's build_bvh exactly (same
BVHArrays layout); builder parity is tested in tests/test_native.py.
Falls back to raising ImportError if no toolchain is present — callers
(bvh.builder.scene_bvh) degrade to the NumPy builder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_LIB = os.path.join(_HERE, "libcrtbvh.so")

_lock = threading.Lock()
_lib = None


def _compile() -> None:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
           "-o", _LIB + ".tmp"]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(_LIB + ".tmp", _LIB)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _compile()
        lib = ctypes.CDLL(_LIB)
        lib.crt_build_bvh.restype = ctypes.c_int32
        lib.crt_build_bvh.argtypes = [
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def build_bvh_native(category, data1, data2, data3, max_leaf: int = 4):
    """C++ twin of bvh.builder.build_bvh; returns BVHArrays."""
    from computeraytracer.bvh import builder

    lib = _load()
    lo, hi = builder.primitive_bounds(category, data1, data2, data3)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    cap = 2 * n + 2
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    miss = np.empty(cap, np.int32)
    leaf = np.empty((cap, max_leaf), np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.crt_build_bvh(
        n, lo.ctypes.data_as(fp), hi.ctypes.data_as(fp), max_leaf,
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        miss.ctypes.data_as(ip), leaf.ctypes.data_as(ip))
    if n_nodes <= 0:
        raise RuntimeError(f"crt_build_bvh failed ({n_nodes})")
    return builder.BVHArrays(
        bbox_min=bmin[:n_nodes].copy(),
        bbox_max=bmax[:n_nodes].copy(),
        miss=miss[:n_nodes].copy(),
        leaf_prims=leaf[:n_nodes].copy(),
    )
