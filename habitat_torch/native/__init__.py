"""ctypes bindings for the port's copy of the native host-side helpers
(habitat_native.cpp): exact 16-connected geodesic Dijkstra and conservative
triangle rasterization. Built with g++ at first use into
``habitat_torch/build/``; a failed build raises. One process-wide lock
covers the check, the build and the load, so threads that ask at once get one
library; the build writes a file named by pid and thread id and moves it into
place with ``os.replace``."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "habitat_native.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "build")
_SO = os.path.join(_BUILD, "libhabitat_native.so")
# the JAX package's Makefile flags: the same compiler and flags give
# bit-identical fields and masks
_CXXFLAGS = ["-O3", "-march=x86-64-v2", "-fPIC", "-shared", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _compile(out: str) -> None:
    subprocess.run(["g++", *_CXXFLAGS, "-o", out, _SRC], check=True, capture_output=True, timeout=300)


def ensure_built() -> None:
    """Build the library if it is missing or older than its source."""
    with _LOCK:
        _ensure_built()


def _ensure_built() -> None:
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
        _compile(tmp)
        os.replace(tmp, _SO)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            _ensure_built()
            _lib = _bind(ctypes.CDLL(_SO))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.geodesic_field.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.geodesic_field.restype = None
    lib.rasterize_triangles.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.rasterize_triangles.restype = None
    return lib


def geodesic_field_native(
    nav_occ: np.ndarray, sources: np.ndarray, res: float
) -> np.ndarray:
    """Exact 16-connected Dijkstra distance field (meters)."""
    lib = get_lib()
    occ = np.ascontiguousarray(nav_occ.astype(np.uint8))
    src = np.ascontiguousarray(np.asarray(sources, np.int64).reshape(-1, 2))
    nx, nz = occ.shape
    out = np.empty((nx, nz), np.float32)
    lib.geodesic_field(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nx,
        nz,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(src),
        ctypes.c_float(res),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def rasterize_triangles_native(
    tri_xz: np.ndarray,  # (T, 3, 2) f32
    lo: np.ndarray,  # (2,)
    res: float,
    shape,  # (nx, nz)
    tol: float,
) -> np.ndarray:
    lib = get_lib()
    tris = np.ascontiguousarray(tri_xz.astype(np.float32))
    nx, nz = shape
    mask = np.zeros((nx, nz), np.uint8)
    lib.rasterize_triangles(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(tris),
        ctypes.c_float(float(lo[0])),
        ctypes.c_float(float(lo[1])),
        ctypes.c_float(res),
        nx,
        nz,
        ctypes.c_float(tol),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return mask.astype(bool)
