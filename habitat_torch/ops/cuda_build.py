"""Build table of the port's CUDA kernels.

Each source ``habitat_torch/csrc/<name>.cu`` exports functions with a plain
C interface. ``build`` compiles sources with nvcc for sm_90a into
``habitat_torch/build/lib<name>.so`` (one nvcc per source, all started
together); ``load`` builds a source at first use when its library is missing
or older than the source or a header of ``csrc/``, and loads it through
ctypes with the argument types registered in ``SOURCES``. Every exported
function returns ``cudaGetLastError()`` after its launch; ``raise_on``
turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD = os.path.join(_PKG, "build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P, _I = ctypes.c_void_p, ctypes.c_int
# source name -> {exported function: argument types}
SOURCES = {
    "raycast_fused": {
        "raycast_fused_sel": [_P] * 8 + [_I] * 6 + [_P],
        "raycast_fused": [_P] * 6 + [_I] * 5 + [_P],
        "raycast_tilecull": [_P] * 9 + [_I] * 6 + [_P],
        "raycast_fused_design": [_I, _I, _P],
    },
    "raycast_stream": {
        "raycast_stream": [_P] * 8 + [_I] * 8 + [_P],
        "raycast_stream_design": [_P],
    },
    "raycast_general": {
        "raycast_index": [_P] * 5 + [_I] * 5 + [_P],
        "raycast_culled": [_P] * 7 + [_I] * 6 + [_P],
        "raycast_index_rm": [_P] * 5 + [_I] * 4 + [_P],
        "raycast_culled_rm": [_P] * 7 + [_I] * 6 + [_P],
        "raycast_index_design": [_I, _I, _P],
        "raycast_culled_design": [_I, _I, _I, _P],
    },
    "cullmask": {
        "cullmask": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P],
        "cullmask_design": [_P],
    },
    "maxpool_bwd": {
        "maxpool_bwd": [_P] * 4 + [_I] * 5 + [_P],
        "maxpool_bwd_design": [_I, _P],
    },
}
_libs: Dict[str, ctypes.CDLL] = {}
# check, build and load of a library, across the threads of the process
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


def _src(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def _newest_input(name: str) -> float:
    """The latest change to a source or to a header the sources include."""
    csrc = os.path.dirname(_src(name))
    headers = [os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [_src(name), *headers])


def _so(name: str) -> str:
    return os.path.join(_BUILD, f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Tuple[float, str]]:
    """Compile the named kernel libraries, one nvcc per source, all started
    together; returns {name: (seconds, ptxas report)}."""
    with _BUILD_LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, Tuple[float, str]]:
    os.makedirs(_BUILD, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        tmp = f"{_so(name)}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _src(name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    out, failed = {}, []
    for name, (tmp, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            err += "\nnvcc timed out"
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {_src(name)}:\n{err}")
            continue
        os.replace(tmp, _so(name))
        out[name] = (time.perf_counter() - t0, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _stale(name: str) -> bool:
    so = _so(name)
    return not os.path.exists(so) or os.path.getmtime(so) < _newest_input(name)


def ensure_built(names: Sequence[str] = tuple(SOURCES)) -> None:
    """Build the named libraries that are missing or stale, without loading
    them (a parent does this before it starts worker processes, so they do
    not each run nvcc)."""
    with _BUILD_LOCK:
        stale = [n for n in names if _stale(n)]
        if stale:
            build(stale)


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        if name in _libs:
            return _libs[name]
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(_so(name))
        for fn, argtypes in SOURCES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        _libs[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel, safe across threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
