"""Closest-hit ray casting kernels: CUDA for tensors on the card, their plain
PyTorch versions for tensors on the CPU.

Counterpart of ``habitat_tpu/ops/raycast_pallas.py`` for the two kernels the
pinhole render path runs:

- ``raycast_fused_sel_t`` <- ``raycast_pallas_fused_sel_t``: per (env, ray
  tile) only the tile's frustum-surviving chunks (``select_chunks_frustum``).
- ``raycast_fused_t`` <- ``raycast_pallas_fused_t``: every chunk in order.

Both take the JAX kernels' inputs unchanged: the chunk-grouped scene matrix
(S, 10, 4T) from ``group_tri_mat``, scene ids (N,), the camera-frame [d, 1]
tiles (nt, 8, Rt) and the ray-feature matrices B^T (N, 16, 4). They return
(t (N, R) f32, idx (N, R) i32) with t = 1e6, idx = -1 on a miss.

The CUDA source is ``habitat_torch/csrc/raycast_fused.cu``, compiled with
nvcc for sm_90a at first use into ``habitat_torch/build/`` and called through
ctypes on PyTorch's current stream. A CUDA tensor launches the kernel or
raises; only CPU tensors take the plain version. Each wrapper counts its
kernel launches in its ``launches`` attribute and names its plain version
(same signature) in ``plain``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

import torch

_TMAX = 1e6
_TMIN = 1e-3
_EPS = 1e-7

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "raycast_fused.cu")
_BUILD = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD, "libraycast_fused.so")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build() -> Tuple[float, str]:
    """Compile the kernel library; returns (seconds, ptxas report)."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, _SO)
    return time.perf_counter() - t0, proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        build()
    lib = ctypes.CDLL(_SO)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.raycast_fused_sel.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.raycast_fused_sel.restype = i
    lib.raycast_fused.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.raycast_fused.restype = i
    _lib = lib
    return _lib


def _check_inputs(tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk, extra=()):
    dev = d_t.device
    for name, x, dt in (
        ("tri_mat_c", tri_mat_c, torch.float32),
        ("sids", sids, torch.int32),
        ("d_t", d_t, torch.float32),
        ("Bt", Bt, torch.float32),
        *extra,
    ):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {dt} tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    n_tiles, k8, rt = d_t.shape
    if k8 != 8 or rt != ray_tile or Bt.shape[1:] != (16, 4) or Bt.shape[0] != sids.shape[0]:
        raise ValueError(f"bad shapes d_t {tuple(d_t.shape)} Bt {tuple(Bt.shape)}")
    if (tri_mat_c.shape[2] // 4) % tri_chunk or tri_mat_c.shape[1] != 10:
        raise ValueError(f"tri_mat_c {tuple(tri_mat_c.shape)} vs chunk {tri_chunk}")
    return n_tiles


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _features(Bt: torch.Tensor, d_t: torch.Tensor) -> torch.Tensor:
    """F (N, nt, 10, Rt) = B^T [d, 1], summed over k in order like the
    kernel (separately rounded products and sums)."""
    b = Bt[:, None, :10, :, None]  # (N,1,10,4,1)
    d = d_t[None, :, None, :4, :]  # (1,nt,1,4,Rt)
    F = b[..., 0, :] * d[..., 0, :]
    for k in range(1, 4):
        F = F + b[..., k, :] * d[..., k, :]
    return F


def _fold(G, C, base, valid, best_t, best_i):
    """Fold one chunk's determinants G (N, nt, 4C, Rt) into the running
    winner: sign-free margin, argmin-first within the chunk, strict < across."""
    detA, tnum, unum, vnum = G[:, :, :C], G[:, :, C:2 * C], G[:, :, 2 * C:3 * C], G[:, :, 3 * C:]
    aa = detA * detA
    p = unum * detA
    q = vnum * detA
    w = tnum * detA
    m = torch.minimum(
        torch.minimum(torch.minimum(p, q), aa - p - q),
        torch.minimum(w - _TMIN * aa, aa - _EPS * _EPS),
    )
    hit = m >= 0.0
    t = torch.where(hit, tnum / torch.where(hit, detA, torch.ones_like(detA)), _TMAX)
    tmin, win = t.min(dim=2)  # (N, nt, Rt), first minimum
    better = (tmin < best_t) & valid[..., None]
    best_t = torch.where(better, tmin, best_t)
    best_i = torch.where(better, base[..., None] * C + win.to(torch.int32), best_i)
    return best_t, best_i


def _finish(best_t, best_i):
    miss = best_t >= _TMAX * 0.5
    N = best_t.shape[0]
    t = torch.where(miss, _TMAX, best_t).reshape(N, -1)
    idx = torch.where(miss, -1, best_i).reshape(N, -1)
    return t, idx


def raycast_fused_sel_t_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile=2048, tri_chunk=32):
    """Plain version of the frustum-selected kernel."""
    N = sids.shape[0]
    n_tiles, _, rt = d_t.shape
    C = tri_chunk
    F = _features(Bt, d_t)
    Mg = tri_mat_c[sids.long()]  # (N, 10, 4T)
    best_t = torch.full((N, n_tiles, rt), _TMAX, device=d_t.device)
    best_i = torch.full((N, n_tiles, rt), -1, dtype=torch.int32, device=d_t.device)
    cols = torch.arange(4 * C, device=d_t.device)
    for k in range(chunk_ids.shape[2]):
        cid = chunk_ids[:, :, k]  # (N, nt)
        idx = (cid.long()[..., None] * 4 * C + cols)[:, :, None, :].expand(N, n_tiles, 10, 4 * C)
        M = torch.gather(Mg[:, None].expand(N, n_tiles, *Mg.shape[1:]), 3, idx)
        G = torch.einsum("ntfc,ntfr->ntcr", M, F)
        best_t, best_i = _fold(G, C, cid, k < cnt, best_t, best_i)
    return _finish(best_t, best_i)


def raycast_fused_t_plain(tri_mat_c, sids, d_t, Bt, ray_tile=2048, tri_chunk=128):
    """Plain version of the every-chunk kernel."""
    N = sids.shape[0]
    n_tiles, _, rt = d_t.shape
    C = tri_chunk
    F = _features(Bt, d_t)
    Mg = tri_mat_c[sids.long()]  # (N, 10, 4T)
    best_t = torch.full((N, n_tiles, rt), _TMAX, device=d_t.device)
    best_i = torch.full((N, n_tiles, rt), -1, dtype=torch.int32, device=d_t.device)
    valid = torch.ones((N, n_tiles), dtype=torch.bool, device=d_t.device)
    for c in range(Mg.shape[2] // (4 * C)):
        G = torch.einsum("nfc,ntfr->ntcr", Mg[:, :, c * 4 * C:(c + 1) * 4 * C], F)
        base = torch.full((N, n_tiles), c, dtype=torch.int32, device=d_t.device)
        best_t, best_i = _fold(G, C, base, valid, best_t, best_i)
    return _finish(best_t, best_i)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def raycast_fused_sel_t(
    tri_mat_c: torch.Tensor,  # (S, 10, 4T) group_tri_mat(tri_mat, C)
    sids: torch.Tensor,  # (N,) int32
    chunk_ids: torch.Tensor,  # (N, nt, K) int32 survivors first
    cnt: torch.Tensor,  # (N, nt) int32 survivor counts
    d_t: torch.Tensor,  # (nt, 8, Rt) camera [d, 1] transposed
    Bt: torch.Tensor,  # (N, 16, 4) ray-feature matrices B^T
    ray_tile: int = 2048,
    tri_chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frustum-selected closest hit: (t (N,R) f32, idx (N,R) i32)."""
    n_tiles = _check_inputs(
        tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk,
        extra=(("chunk_ids", chunk_ids, torch.int32), ("cnt", cnt, torch.int32)),
    )
    N = sids.shape[0]
    if chunk_ids.shape[:2] != (N, n_tiles) or cnt.shape != (N, n_tiles):
        raise ValueError(f"chunk_ids {tuple(chunk_ids.shape)} / cnt {tuple(cnt.shape)}")
    if d_t.device.type == "cpu":
        return raycast_fused_sel_t_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile, tri_chunk)
    lib = _load()
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=d_t.device)
    idx = torch.empty((N, n_tiles * ray_tile), dtype=torch.int32, device=d_t.device)
    err = lib.raycast_fused_sel(
        tri_mat_c.data_ptr(), sids.data_ptr(), chunk_ids.data_ptr(), cnt.data_ptr(),
        d_t.data_ptr(), Bt.data_ptr(), t.data_ptr(), idx.data_ptr(),
        N, tri_mat_c.shape[2], n_tiles, chunk_ids.shape[2], ray_tile, tri_chunk,
        torch.cuda.current_stream(d_t.device).cuda_stream,
    )
    _raise_on(err, "raycast_fused_sel")
    raycast_fused_sel_t.launches += 1
    return t, idx


raycast_fused_sel_t.launches = 0
raycast_fused_sel_t.plain = raycast_fused_sel_t_plain


def raycast_fused_t(
    tri_mat_c: torch.Tensor,  # (S, 10, 4T) group_tri_mat(tri_mat, C)
    sids: torch.Tensor,  # (N,) int32
    d_t: torch.Tensor,  # (nt, 8, Rt)
    Bt: torch.Tensor,  # (N, 16, 4)
    ray_tile: int = 2048,
    tri_chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every-chunk closest hit: (t (N,R) f32, idx (N,R) i32)."""
    n_tiles = _check_inputs(tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk)
    if d_t.device.type == "cpu":
        return raycast_fused_t_plain(tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk)
    lib = _load()
    N = sids.shape[0]
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=d_t.device)
    idx = torch.empty((N, n_tiles * ray_tile), dtype=torch.int32, device=d_t.device)
    err = lib.raycast_fused(
        tri_mat_c.data_ptr(), sids.data_ptr(), d_t.data_ptr(), Bt.data_ptr(),
        t.data_ptr(), idx.data_ptr(),
        N, tri_mat_c.shape[2], n_tiles, ray_tile, tri_chunk,
        torch.cuda.current_stream(d_t.device).cuda_stream,
    )
    _raise_on(err, "raycast_fused")
    raycast_fused_t.launches += 1
    return t, idx


raycast_fused_t.launches = 0
raycast_fused_t.plain = raycast_fused_t_plain
