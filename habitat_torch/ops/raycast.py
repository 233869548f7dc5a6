"""Batched triangle raycasting -> RGB / depth / semantic frames.

Port of ``habitat_tpu/ops/raycast.py::render_batch`` (and the helpers it
runs): the pinhole routes below, the general route for equirect and fisheye
cameras and for pinhole images that do not tile, and the merge of per-env
dynamic geometry (movable objects) by closest hit.

Scenes up to 96 chunks of 128 triangles: per-screen-tile frustum culling at
32-triangle chunk granularity (``select_chunks_frustum``) or every chunk,
the closest-hit kernel (``ops/raycast_kernels.py``), then the attribute
gather with plane-exact depth recovery and flat+Lambert shading.

Larger scenes, on images that split into 32x32-pixel tiles: per tile, cone
culling of the parent chunks' bounding spheres with the LOD distance bands
(``select_chunks``), expansion into 32-triangle chunklets culled by their
boxes and then by the exact three-vertex plane test
(``select_chunklets_exact``), and the nearest-first chunklet stream kernel;
or, with ``backend="stream"``, occlusion-bounded parent chunks
(``select_chunks_occluded``) through the chunk stream kernel. The epilogue
is one 64-byte row gather per ray from ``tri_attr16`` where the pack has it.

The general route generates world rays per projection and their transposed
features ``ray_features_t``: small scenes (and large ones whose image is not
a multiple of 1024 rays) take the every-chunk index kernel over the whole
scene; large scenes take, per raster-order 1024-ray tile, the K nearest
occlusion-bounded parent chunks of ``select_chunks_occluded`` through the
culled kernel, which returns the winner's attributes. Its epilogue keeps the
kernel's t: planar depth for pinhole, Euclidean range for the panoramic
projections.

Dynamic geometry (``render_batch(dynamic=...)``): each env's triangles,
padded to a multiple of 128, become that env's own scene for the index
kernel (``sids = arange(N)``), with matrices built on the device every call
(``build_tri_matrix_torch``); a ray takes the dynamic triangle where it hits
one nearer than the static winner. A render with dynamic geometry never
takes the pinhole fast path: small scenes go through the index route; the
block route merges in 32x32-pixel block order, channel-major; the others
merge in raster order.

The intersection is the matrix form of Möller–Trumbore: the four
determinants are bilinear in per-ray features F = [d, o, o×d, 1] and
per-triangle coefficients M (10, 4, T), segments (detA | t_num | u_num |
v_num):

    detA  = -d·n                       (n = e1×e2)
    t_num =  o·n - v0·n
    u_num =  (o×d)·e2 + d·(v0×e2)
    v_num = -(o×d)·e1 + d·(e1×v0)
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from habitat_torch.ops.raycast_kernels import (  # VERTS16_VALID: re-exported beside ATTR16_NV0
    _EPS,
    _TMAX,
    _TMIN,
    VERTS16_VALID,
    cullmask_t,
    raycast_culled_t,
    raycast_exactsel_t,
    raycast_fused_sel_t,
    raycast_fused_t,
    raycast_index_t,
    raycast_stream_t,
)
from habitat_torch.sims.scene import ScenePack
from habitat_torch.utils.geometry import (
    camera_rays,
    equirect_rays,
    fisheye_rays,
    view_rotation_matrix,
    yaw_to_forward,
)

# tri_attr16 row [attr(8) | v0(3) | n.v0 | pad(4)]: the slot of n.v0
ATTR16_NV0 = 11
_ID_BITS = 18  # packed list slot: (dmin_cm << 18) | chunk id
_SENTINEL = 0x7FFFFFFF
# the chunk-culled routes' ray tile: one 32x32-pixel screen block
_BLOCK = 32
_BLOCK_RAYS = _BLOCK * _BLOCK

# the fast path keeps the whole scene per kernel call up to 2 x 48 chunks of
# 128 triangles (2 x cull_k where the caller gives one); beyond it the
# chunk-culled routes take over
_FAST_CULL_K = 48
# parent chunks the chunk stream route keeps per tile when cull_k is not given
_STREAM_CULL_K = 160
# parent chunks the exact-cull route keeps per tile at least
_EXACT_MIN_K = 320
# frustum-selected route up to this many (padded) triangles
_SEL_MAX_TRIS = 4096
_SEL_CHUNK = 32
_RAY_TILE = 2048


def _mt_chunk(o, d, v0, e1, e2, valid):
    """Classic Möller–Trumbore: rays (R, 3) x one chunk of triangles (C, 3)
    -> t (R, C), _TMAX where a ray misses."""
    d_, o_ = d[:, None, :], o[:, None, :]
    h = torch.linalg.cross(d_.expand(-1, e2.shape[0], -1), e2[None].expand(d.shape[0], -1, -1))
    a = (e1[None] * h).sum(-1)
    ok = a.abs() > _EPS
    f = torch.where(ok, 1.0 / torch.where(ok, a, 1.0), 0.0)
    s = o_ - v0[None]
    u = f * (s * h).sum(-1)
    q = torch.linalg.cross(s, e1[None].expand_as(s))
    v = f * (d_ * q).sum(-1)
    t = f * (e2[None] * q).sum(-1)
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _TMIN) & valid[None, :]
    return torch.where(hit, t, _TMAX)


def raycast_rays(tri_v0, tri_e1, tri_e2, tri_valid, origins, dirs, chunk: int = 128):
    """The closest-hit oracle over every triangle (the XLA
    ``habitat_tpu/ops/raycast.py::raycast_rays``; no kernel): (T, 3)
    triangles, T a multiple of ``chunk``, and (R, 3) rays on one device ->
    (t (R,), triangle index (R,) int64, -1 and _TMAX on a miss). Chunks run
    in order and a later one wins only when strictly nearer, so ties keep
    the lowest index."""
    T, R = tri_v0.shape[0], origins.shape[0]
    if T % chunk:
        raise ValueError(f"{T} triangles is not a multiple of the chunk {chunk}")
    valid = tri_valid.bool()
    best_t = torch.full((R,), _TMAX, dtype=torch.float32, device=origins.device)
    best_i = torch.full((R,), -1, dtype=torch.int64, device=origins.device)
    for base in range(0, T, chunk):
        sl = slice(base, base + chunk)
        t = _mt_chunk(origins, dirs, tri_v0[sl], tri_e1[sl], tri_e2[sl], valid[sl])
        tmin, imin = t.min(dim=1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, imin + base, best_i)
    miss = best_t >= _TMAX
    return torch.where(miss, _TMAX, best_t), torch.where(miss, -1, best_i)


def build_tri_matrix(tri_v0, tri_e1, tri_e2, tri_valid) -> np.ndarray:
    """(T,3) host arrays -> (10, 4, T) f32 coefficient matrix (see module
    doc). Padding (invalid) triangles get all-zero columns."""
    n = np.cross(tri_e1, tri_e2)
    v0xe2 = np.cross(tri_v0, tri_e2)
    e1xv0 = np.cross(tri_e1, tri_v0)
    T = tri_v0.shape[0]
    M = np.zeros((10, 4, T), np.float32)
    M[0:3, 0] = -n.T
    M[3:6, 1] = n.T
    M[9, 1] = -np.sum(tri_v0 * n, axis=-1)
    M[0:3, 2] = v0xe2.T
    M[6:9, 2] = tri_e2.T
    M[0:3, 3] = e1xv0.T
    M[6:9, 3] = -tri_e1.T
    M *= np.asarray(tri_valid)[None, None, :]
    return M


def build_tri_matrix_torch(tri_v0, tri_e1, tri_e2, valid) -> torch.Tensor:
    """(..., T, 3) tensors -> (..., 10, 4, T) float32 coefficient matrices on
    their device: ``build_tri_matrix`` for dynamic triangles, whose
    transforms change every step. ``valid`` (..., T) zeroes padding
    columns."""
    n = torch.linalg.cross(tri_e1, tri_e2)
    v0xe2 = torch.linalg.cross(tri_v0, tri_e2)
    e1xv0 = torch.linalg.cross(tri_e1, tri_v0)
    *batch, T, _ = tri_v0.shape
    M = tri_v0.new_zeros(*batch, 10, 4, T)
    M[..., 0:3, 0, :] = -n.transpose(-1, -2)
    M[..., 3:6, 1, :] = n.transpose(-1, -2)
    M[..., 9, 1, :] = -(tri_v0 * n).sum(-1)
    M[..., 0:3, 2, :] = v0xe2.transpose(-1, -2)
    M[..., 6:9, 2, :] = tri_e2.transpose(-1, -2)
    M[..., 0:3, 3, :] = e1xv0.transpose(-1, -2)
    M[..., 6:9, 3, :] = -tri_e1.transpose(-1, -2)
    return M * valid[..., None, None, :].to(M.dtype)


def group_tri_mat(tri_mat: torch.Tensor, tri_chunk: int = 128) -> torch.Tensor:
    """(S,10,4,T) -> (S,10,4T) with chunk c in columns [c*4C, (c+1)*4C) as
    [detA(C)|tnum(C)|unum(C)|vnum(C)] — the kernels' input layout."""
    S, _, _, T = tri_mat.shape
    C = tri_chunk
    return (
        tri_mat.reshape(S, 10, 4, T // C, C)
        .permute(0, 1, 3, 2, 4)
        .reshape(S, 10, 4 * T)
    )


def ray_features(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3), (..., 3) -> (..., 10) row-major ray features [d, o, o x d, 1]
    (the ray-batch kernels' input)."""
    oxd = torch.linalg.cross(origins, dirs)
    return torch.cat([dirs, origins, oxd, torch.ones_like(dirs[..., :1])], dim=-1).float()


def ray_features_t(origins: torch.Tensor, dirs: torch.Tensor, ray_tile: int) -> torch.Tensor:
    """(N, R, 3), (N, R, 3) -> (N, R/ray_tile, 16, ray_tile) transposed ray
    features [d, o, o x d, 1], rays minor; rows 10:16 are zero."""
    N, R, _ = origins.shape
    F = torch.nn.functional.pad(ray_features(origins, dirs), (0, 6))  # (N, R, 16)
    return F.reshape(N, R // ray_tile, ray_tile, 16).transpose(2, 3).contiguous()


def ray_feature_matrix(cam_pos: torch.Tensor, yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """(N,3),(N,),(N,) -> (N,4,10) B with ray features = [d_cam, 1] @ B.

    F = [d_world, o, o x d_world, 1] is bilinear in the camera-frame dir:
    d_world = R d_cam, o x d_world = skew(o) R d_cam. Row-vector form:
    B[0:3] = [R^T | 0 | -R^T skew(o) | 0], B[3] = [0 | o | 0 | 1]."""
    N = cam_pos.shape[0]
    dev = cam_pos.device
    rot = view_rotation_matrix(yaw, pitch)  # (N,3,3), d_world = R @ d_cam
    o = cam_pos.float()
    z = torch.zeros(N, device=dev)
    sk = torch.stack(
        [
            torch.stack([z, -o[:, 2], o[:, 1]], -1),
            torch.stack([o[:, 2], z, -o[:, 0]], -1),
            torch.stack([-o[:, 1], o[:, 0], z], -1),
        ],
        dim=1,
    )
    rT = rot.transpose(1, 2)
    b_top = torch.cat(
        [rT, torch.zeros(N, 3, 3, device=dev), -torch.bmm(rT, sk), torch.zeros(N, 3, 1, device=dev)],
        dim=2,
    )
    b_bot = torch.cat(
        [torch.zeros(N, 3, device=dev), o, torch.zeros(N, 3, device=dev), torch.ones(N, 1, device=dev)],
        dim=1,
    )[:, None, :]
    return torch.cat([b_top, b_bot], dim=1)


def tile_plane_normals_cam(
    hfov_rad: float, height: int, width: int, th: int, tw: int
) -> np.ndarray:
    """Inward side-plane normals of each screen-tile frustum, camera frame.

    Tiles raster row-major over (height//th, width//tw). Planes pass through
    the camera apex and the tile's outermost pixel-center rays padded outward
    by half a pixel. Returns (n_tiles, 4, 3) float32. A triangle with ALL
    THREE vertices outside ONE plane cannot be hit by any ray of the tile.
    """
    fx = float(np.tan(hfov_rad / 2.0))
    aspect = height / width
    xs = np.linspace(-fx, fx, width)
    ys = np.linspace(fx * aspect, -fx * aspect, height)
    dx = xs[1] - xs[0] if width > 1 else fx
    dy = abs(ys[1] - ys[0]) if height > 1 else fx * aspect
    nty, ntx = height // th, width // tw
    planes = np.zeros((nty, ntx, 4, 3), np.float32)
    for ty in range(nty):
        for tx in range(ntx):
            x_lo = xs[tx * tw] - 0.5 * dx
            x_hi = xs[tx * tw + tw - 1] + 0.5 * dx
            y_hi = ys[ty * th] + 0.5 * dy  # ys descends
            y_lo = ys[ty * th + th - 1] - 0.5 * dy
            planes[ty, tx, 0] = (1.0, 0.0, x_lo)
            planes[ty, tx, 1] = (-1.0, 0.0, -x_hi)
            planes[ty, tx, 2] = (0.0, 1.0, y_lo)
            planes[ty, tx, 3] = (0.0, -1.0, -y_hi)
    return planes.reshape(nty * ntx, 4, 3)


def bin_tris_tiles(
    tri_v0, tri_e1, tri_e2, tri_valid, sids, cam_pos, yaw, pitch, planes_cam
) -> torch.Tensor:
    """Conservative per-screen-tile triangle culling flags (N, nt, T) bool:
    a culled triangle cannot be hit by any ray of its tile. The -1e-3
    margin absorbs f32 rounding here and in the kernel's products."""
    R = view_rotation_matrix(yaw, pitch)  # (N,3,3)
    nw = torch.einsum("nij,kpj->nkpi", R, planes_cam)
    v0 = tri_v0[sids]  # (N,T,3)
    rel0 = v0 - cam_pos[:, None, :]
    d0 = torch.einsum("nkpc,ntc->nkpt", nw, rel0)  # (N,nt,4,T)
    de1 = torch.einsum("nkpc,ntc->nkpt", nw, tri_e1[sids])
    de2 = torch.einsum("nkpc,ntc->nkpt", nw, tri_e2[sids])
    eps = -1e-3
    out_all = (d0 < eps) & (d0 + de1 < eps) & (d0 + de2 < eps)  # 3 verts out
    return out_all.any(dim=2) | ~tri_valid[sids][:, None, :]


def select_chunks_frustum(
    tri_v0, tri_e1, tri_e2, tri_valid, sids, cam_pos, yaw, pitch, planes_cam,
    tri_chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-granularity frustum culling: a chunk survives for an (env, tile)
    iff any of its triangles does under ``bin_tris_tiles``.

    Returns (chunk_ids (N, nt, K=T//C) int32, cnt (N, nt) int32): survivors
    first in ascending chunk order, the tail padded with the last survivor
    (the kernel stops at cnt). cnt == 0 pads with chunk 0."""
    culled = bin_tris_tiles(
        tri_v0, tri_e1, tri_e2, tri_valid, sids, cam_pos, yaw, pitch, planes_cam
    )
    N, nt, T = culled.shape
    K = T // tri_chunk
    surv = (~culled).reshape(N, nt, K, tri_chunk).any(dim=-1)  # (N,nt,K)
    cnt = surv.sum(dim=-1, dtype=torch.int32)
    ids = torch.argsort((~surv).to(torch.int8), dim=-1, stable=True).to(torch.int32)
    last = torch.gather(ids, 2, (cnt.long() - 1).clamp(min=0)[..., None])
    kk = torch.arange(K, dtype=torch.int32, device=ids.device)
    ids = torch.where(kk[None, None, :] < cnt[..., None], ids, last)
    return ids, cnt


def mt_epilogue(G: torch.Tensor, C: int) -> torch.Tensor:
    """Determinant segments (..., 4C) -> t (..., C), 1e6 where no hit."""
    detA, tnum, unum, vnum = G[..., :C], G[..., C:2 * C], G[..., 2 * C:3 * C], G[..., 3 * C:]
    sgn = torch.sign(detA)
    a = detA.abs()
    us, vs, ts = unum * sgn, vnum * sgn, tnum * sgn
    hit = (a > _EPS) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= a) & (ts > _TMIN * a)
    return torch.where(hit, tnum / torch.where(a > _EPS, detA, torch.ones_like(detA)), _TMAX)


def raycast_mxu_batch(
    tri_mats: torch.Tensor,  # (N, 10, 4, T) per-env triangle matrices
    origins: torch.Tensor,  # (N, R, 3)
    dirs: torch.Tensor,  # (N, R, 3)
    tri_chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit as batched matrix products in PyTorch, triangle chunks in
    order: (t (N, R) f32, idx (N, R) i32, -1 on a miss). It is the occlusion
    prepass of ``select_chunks_occluded`` and runs wherever its inputs lie."""
    N, R, _ = origins.shape
    T = tri_mats.shape[3]
    C = min(tri_chunk, T)
    if T % C:
        raise ValueError(f"{T} triangles do not split into chunks of {C}")
    ones = torch.ones(N, R, 1, device=origins.device)
    F = torch.cat([dirs, origins, torch.linalg.cross(origins, dirs), ones], dim=-1).float()
    Mc = tri_mats.reshape(N, 10, 4, T // C, C)
    best_t = torch.full((N, R), _TMAX, device=origins.device)
    best_i = torch.full((N, R), -1, dtype=torch.int32, device=origins.device)
    for c in range(T // C):
        t = mt_epilogue(torch.bmm(F, Mc[:, :, :, c].reshape(N, 10, 4 * C)), C)
        tmin, win = t.min(dim=-1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, win.to(torch.int32) + c * C, best_i)
    return best_t, torch.where(best_t >= _TMAX, -1, best_i)


def _lod_band_ok(chunk_bounds: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Discrete-LOD render band: a chunk competes only when the tile apex is
    within its [dmin, dmax] distance range (chunk_bounds columns 4:6;
    single-LOD packs carry [0, 1e9]), padded by the chunk radius so that band
    boundaries never open gaps."""
    if chunk_bounds.shape[-1] < 6:
        return torch.ones_like(dist, dtype=torch.bool)
    r = chunk_bounds[..., 3][:, None, :]
    dmin = chunk_bounds[..., 4][:, None, :]
    dmax = chunk_bounds[..., 5][:, None, :]
    return ((dist + r) >= dmin) & ((dist - r) <= dmax)


def _tile_cones(chunk_bounds, origins, dirs, ray_tile):
    """Per (env, tile) cone test of every chunk sphere: (dist to the apex
    (N, nt, NC), cone-visible (N, nt, NC), r (N, NC))."""
    N, R, _ = origins.shape
    n_tiles = R // ray_tile
    d = dirs.reshape(N, n_tiles, ray_tile, 3)
    axis = d.mean(dim=2)
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-9)
    cos_tile = (d * axis[:, :, None, :]).sum(-1).min(dim=2).values  # (N, nt)
    ang_tile = torch.arccos(cos_tile.clamp(-1.0, 1.0))
    o = origins.reshape(N, n_tiles, ray_tile, 3)[:, :, 0]  # (N, nt, 3) apex
    r = chunk_bounds[..., 3]  # (N, NC)
    v = chunk_bounds[:, None, :, :3] - o[:, :, None, :]  # (N, nt, NC, 3)
    dist = torch.linalg.vector_norm(v, dim=-1)
    safe = dist.clamp(min=1e-9)
    cos_v = (v * axis[:, :, None, :]).sum(-1) / safe
    ang_v = torch.arccos(cos_v.clamp(-1.0, 1.0))
    ang_r = torch.arcsin((r[:, None, :] / safe).clamp(0.0, 1.0))
    visible = (ang_v <= ang_tile[:, :, None] + ang_r) | (dist <= r[:, None, :])
    return dist, visible, r


def select_chunks(
    chunk_bounds: torch.Tensor,  # (N, NC, 4 or 6) per-env chunk spheres (+ LOD band)
    origins: torch.Tensor,  # (N, R, 3)
    dirs: torch.Tensor,  # (N, R, 3)
    ray_tile: int,
    k: int,
    with_cnt: bool = False,
):
    """Per-ray-tile K nearest candidate chunks by cone/sphere culling.

    The rays of a tile share an origin and form a cone (axis = mean
    direction, half-angle covering the tile's rays). A chunk is a candidate
    iff the cone meets its bounding sphere and the apex lies in its LOD band;
    the K nearest win. Returns ids (N, nt, K) int32 nearest first, and with
    ``with_cnt`` the number of real candidates per tile (the tail is
    arbitrary non-candidates)."""
    dist, visible, r = _tile_cones(chunk_bounds, origins, dirs, ray_tile)
    valid = (r > 0)[:, None, :] & _lod_band_ok(chunk_bounds, dist)
    score = torch.where(visible & valid, (dist - r[:, None, :]).clamp(min=0.0), 1e9)
    neg, idx = torch.topk(-score, min(k, score.shape[-1]), dim=-1)
    if with_cnt:
        return idx.to(torch.int32), (neg > -1e8).sum(-1, dtype=torch.int32)
    return idx.to(torch.int32)


def _pack_nearest_first(neg: torch.Tensor, idx: torch.Tensor):
    """topk output (negated scores, ids) -> the stream kernels' list:
    (packed (dmin_cm << 18) | id with the tail holding the last survivor,
    cnt). dmin is floored to centimetres (never above the true bound) and
    capped at 81.91 m."""
    valid_sel = neg > -1e8
    cnt = valid_sel.sum(-1, dtype=torch.int32)
    ids = idx.to(torch.int32)
    pos = torch.arange(ids.shape[-1], dtype=torch.int32, device=ids.device)
    in_list = pos < cnt[..., None]
    last = torch.gather(ids, -1, (cnt.long() - 1).clamp(min=0)[..., None])
    ids = torch.where(in_list, ids, last)
    ids = torch.where(cnt[..., None] > 0, ids, 0)
    dmin_cm = torch.floor(-neg * 1e2).clamp(0, 8191).to(torch.int32)
    dmin_cm = torch.where(valid_sel & in_list, dmin_cm, 0)
    return (dmin_cm << _ID_BITS) | ids, cnt


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last dim, ties to the lower index first (as
    ``jax.lax.top_k``; ``torch.topk`` orders ties arbitrarily, and a tie at
    a clamped score of 0 can decide which chunks a tile keeps)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def select_chunks_occluded(
    pack_tri_mat: torch.Tensor,  # (S, 10, 4, T)
    chunk_bounds: torch.Tensor,  # (N, NC, 4 or 6)
    sids: torch.Tensor,  # (N,)
    origins: torch.Tensor,  # (N, R, 3)
    dirs: torch.Tensor,  # (N, R, 3)
    ray_tile: int,
    k: int,
    lowres_stride: int = 64,
    depth_margin: float = 1.0,
    pre_chunks: int = 16,
    with_cnt: bool = False,
    with_dmax: bool = False,
):
    """Occlusion-aware chunk selection: a low-resolution raycast (one ray in
    ``lowres_stride``) against a proxy subset of the scene bounds each
    tile's depth; only cone-visible chunks nearer than that bound compete
    for the K slots. A subset can only overestimate the depth, so the bound
    stays conservative with respect to a full prepass. On LOD packs the
    proxy is the coarsest-LOD chunks (they cover the whole scene sparsely),
    else the chunks nearest the agent.

    Returns ids (N, nt, K) int32; with ``with_cnt`` the packed nearest-first
    list of the stream kernel and the counts; ``with_dmax`` appends the
    per-tile depth bound."""
    N, R, _ = origins.shape
    S, _, _, T = pack_tri_mat.shape
    NC = chunk_bounds.shape[1]
    C = T // NC
    n_tiles = R // ray_tile
    agent = origins[:, 0]
    cdist = torch.linalg.vector_norm(chunk_bounds[..., :3] - agent[:, None, :], dim=-1) - chunk_bounds[..., 3]
    cdist = torch.where(chunk_bounds[..., 3] > 0, cdist, 1e9)
    if chunk_bounds.shape[-1] >= 6:
        coarse = chunk_bounds[..., 5] > 1e8
        cdist = torch.where(coarse, cdist, cdist + 1e6)
        kp = min(max(pre_chunks, 192 * 128 // C), NC)  # constant proxy size in triangles
    else:
        kp = min(pre_chunks, NC)
    near_ids = _top_k(-cdist, kp)[1]  # (N, kp)
    # chunk-major gather, never materializing per-env scene matrices
    flat = pack_tri_mat.reshape(S, 10, 4, NC, C).permute(0, 3, 1, 2, 4).reshape(S * NC, 10, 4, C)
    Mg = flat[sids.long()[:, None] * NC + near_ids]  # (N, kp, 10, 4, C)
    Mg = Mg.permute(0, 2, 3, 1, 4).reshape(N, 10, 4, kp * C)
    t_lr, _ = raycast_mxu_batch(Mg, origins[:, ::lowres_stride], dirs[:, ::lowres_stride], tri_chunk=128)
    t_lr = torch.where(t_lr > 1e5, 40.0, t_lr)  # miss -> generous bound
    dmax = t_lr.reshape(N, n_tiles, ray_tile // lowres_stride).max(dim=-1).values * 1.2 + depth_margin

    dist, visible, r = _tile_cones(chunk_bounds, origins, dirs, ray_tile)
    near_enough = (dist - r[:, None, :]) <= dmax[:, :, None]
    valid = (r > 0)[:, None, :] & _lod_band_ok(chunk_bounds, dist)
    score = torch.where(visible & valid & near_enough, (dist - r[:, None, :]).clamp(min=0.0), 1e9)
    neg, idx = _top_k(-score, min(k, NC))
    if not with_cnt:
        ids = idx.to(torch.int32)
        return (ids, dmax) if with_dmax else ids
    packed, cnt = _pack_nearest_first(neg, idx)
    return (packed, cnt, dmax) if with_dmax else (packed, cnt)


def chunklet_aabbs(tri_v0, tri_e1, tri_e2, tri_valid, c: int = 32) -> torch.Tensor:
    """Per-chunklet AABBs (S, T//c, 6) = [center(3), half(3)]; empty
    chunklets get an inverted box that fails every positive-vertex test."""
    S, T, _ = tri_v0.shape
    n = T // c
    verts = torch.stack([tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2], dim=2).reshape(S, n, c * 3, 3)
    m = tri_valid.reshape(S, n, c).repeat_interleave(3, dim=2)[..., None]
    inf = torch.tensor(float("inf"), device=tri_v0.device)
    lo = torch.where(m, verts, inf).min(dim=2).values
    hi = torch.where(m, verts, -inf).max(dim=2).values
    any_v = tri_valid.reshape(S, n, c).any(dim=2)[..., None]
    lo = torch.where(any_v, lo, 1e9)
    hi = torch.where(any_v, hi, -1e9)
    return torch.cat([(lo + hi) * 0.5, (hi - lo) * 0.5], dim=-1)


def _finish_list(packed: torch.Tensor, cnt: torch.Tensor, kf: int):
    """Cut or zero-pad a sorted packed list to ``kf`` slots, fill the tail
    with the last survivor, zero the list of a tile without survivors."""
    K = packed.shape[-1]
    packed = packed[..., :kf] if kf <= K else torch.nn.functional.pad(packed, (0, kf - K))
    cnt = cnt.clamp(max=kf)
    last = torch.gather(packed, -1, (cnt.long() - 1).clamp(min=0)[..., None])
    pos = torch.arange(kf, dtype=torch.int32, device=packed.device)
    packed = torch.where(pos < cnt[..., None], packed, last)
    packed = torch.where(cnt[..., None] > 0, packed, 0)
    return packed.to(torch.int32), cnt.to(torch.int32)


def _box_dmin_cm(ctr: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """Least distance from the apex to a box (centre relative to the apex),
    in floored centimetres, capped at 8191."""
    dmin = (torch.linalg.vector_norm(ctr, dim=-1) - torch.linalg.vector_norm(half, dim=-1)).clamp(min=0.0)
    return torch.floor(dmin * 1e2).clamp(0, 8191).to(torch.int32)


def select_chunklets_exact(
    tri_v0: torch.Tensor,  # (S, T, 3)
    tri_e1: torch.Tensor,
    tri_e2: torch.Tensor,
    tri_valid: torch.Tensor,  # (S, T)
    aabbs: torch.Tensor,  # (S, T//c, 6) from chunklet_aabbs
    sids: torch.Tensor,  # (N,)
    cam_pos: torch.Tensor,  # (N, 3)
    yaw: torch.Tensor,
    pitch: torch.Tensor,
    planes_cam: torch.Tensor,  # (nt, 4, 3) tile_plane_normals_cam
    ids0: torch.Tensor,  # (N, nt, K0) surviving parent chunk ids
    cnt0: torch.Tensor,  # (N, nt)
    parent_c: int,  # parent chunk size (triangles)
    c: int = 32,  # chunklet size
    k_aabb: Optional[int] = None,
    k_final: Optional[int] = None,
    skip_exact: bool = True,
    verts16: Optional[torch.Tensor] = None,
    k_exact: int = 384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical exact chunklet selection.

    Level 1 expands each surviving parent chunk into its chunklets and culls
    them by the AABB positive-vertex rule (the box corner most inside each
    tile plane: if even it is outside, every triangle in the box is). Level 2
    is ``bin_tris_tiles``' exact three-vertex plane test on the survivors'
    triangles, with the same -1e-3 margin, so a culled chunklet holds no
    triangle that a ray of the tile can hit. There is no occlusion pre-cull:
    the kernel exploits occlusion exactly, streaming nearest first and
    stopping once no later chunklet can win.

    Three flows:
    - ``verts16`` given (packs that carry ``tri_verts16``): level 2 runs on
      the ``k_exact`` nearest level-1 survivors, one 2 KB row gather per
      chunklet; survivors beyond the cap pass through untested, so the cap
      costs work, never exactness.
    - ``skip_exact`` (default) without ``verts16``: level 1 only, uncapped.
    - otherwise the capped level-2 flow (``k_aabb``, ``k_final``), which can
      drop true survivors when counts exceed a cap.

    Returns (packed (N, nt, Kf) int32 = (dmin_cm << 18) | chunklet id,
    ascending, survivors first, the tail holding the last survivor, Kf =
    ``k_final`` or all candidates, rounded up to a multiple of 128 in the
    first two flows; cnt (N, nt) int32)."""
    N, nt, K0 = ids0.shape
    S, T, _ = tri_v0.shape
    NCH = T // c
    if NCH > (1 << _ID_BITS):
        raise ValueError("a packed chunklet id has 18 bits")
    expand = parent_c // c
    Kc = K0 * expand
    dev = ids0.device
    sid = sids.long()
    nw = torch.einsum("nij,kpj->nkpi", view_rotation_matrix(yaw, pitch), planes_cam)  # (N, nt, 4, 3)

    # ---- level 1: AABB positive vertex over the expanded candidates ------
    cand = (
        ids0[..., None] * expand + torch.arange(expand, dtype=torch.int32, device=dev)
    ).reshape(N, nt, Kc)
    pos0 = torch.arange(K0, dtype=torch.int32, device=dev)
    cand_valid = (
        (pos0[None, None, :, None] < cnt0[..., None, None]).expand(N, nt, K0, expand).reshape(N, nt, Kc)
    )
    NC0 = T // parent_c
    ab = aabbs.reshape(S * NC0, expand, 6)[sid[:, None, None] * NC0 + ids0.long()].reshape(N, nt, Kc, 6)
    ctr = ab[..., 0:3] - cam_pos[:, None, None, :]
    half = ab[..., 3:6]
    surv1 = cand_valid
    for p in range(4):
        nw_p = nw[:, :, None, p, :]  # (N, nt, 1, 3)
        surv1 = surv1 & (((ctr + torch.sign(nw_p) * half) * nw_p).sum(-1) > -1e-3)

    if verts16 is not None or skip_exact:
        packed = torch.where(surv1, (_box_dmin_cm(ctr, half) << _ID_BITS) | cand, _SENTINEL)
        packed = torch.sort(packed, dim=-1).values  # nearest-first survivors
        cnt = surv1.sum(-1, dtype=torch.int32)
        if verts16 is not None:
            ka = min(k_exact, Kc)
            head = packed[..., :ka].contiguous()
            cntk = cnt.clamp(max=ka)
            tri_pass = cullmask_t(verts16, sids.to(torch.int32), head, cntk, nw.contiguous(), cam_pos, c=c)
            pos_a = torch.arange(ka, dtype=torch.int32, device=dev)
            keep_head = (tri_pass > 0.5).any(-1) & (pos_a < cntk[..., None])
            head = torch.where(keep_head, head, _SENTINEL)
            # push the culled slots to the tail
            packed = torch.sort(torch.cat([head, packed[..., ka:]], dim=-1), dim=-1).values
            cnt = keep_head.sum(-1, dtype=torch.int32) + (cnt - ka).clamp(min=0)
        kf = Kc if k_final is None else min(k_final, Kc)
        return _finish_list(packed, cnt, -(-kf // 128) * 128)

    # ---- capped flow: compact by chunklet id, then level 2 ----------------
    ka = min(k_aabb or 512, Kc)
    key1 = torch.where(surv1, cand, 1 << 30)
    ord1 = torch.argsort(key1, dim=-1, stable=True)[..., :ka]
    ids1 = torch.gather(cand, -1, ord1)  # (N, nt, ka)
    cnt1 = surv1.sum(-1).clamp(max=ka)
    ord3 = ord1[..., None].expand(N, nt, ka, 3)
    ctr1, half1 = torch.gather(ctr, 2, ord3), torch.gather(half, 2, ord3)
    flat_key = sid[:, None, None] * NCH + ids1.long()
    p9 = torch.cat([tri_v0, tri_e1, tri_e2], dim=-1).reshape(S * NCH, c, 9)[flat_key]  # (N, nt, ka, c, 9)
    vgood = tri_valid.reshape(S * NCH, c)[flat_key]
    rel0 = p9[..., 0:3] - cam_pos[:, None, None, None, :]
    eps = -1e-3
    out_any = torch.zeros_like(vgood)
    for p in range(4):
        nw_p = nw[:, :, None, None, p, :]
        d0 = (rel0 * nw_p).sum(-1)
        de1 = (p9[..., 3:6] * nw_p).sum(-1)
        de2 = (p9[..., 6:9] * nw_p).sum(-1)
        out_any = out_any | ((d0 < eps) & (d0 + de1 < eps) & (d0 + de2 < eps))
    pos1 = torch.arange(ka, device=dev)
    surv2 = (~out_any & vgood).any(-1) & (pos1 < cnt1[..., None])
    packed = (_box_dmin_cm(ctr1, half1) << _ID_BITS) | ids1
    kf = min(k_final or ka, ka)
    packed = torch.sort(torch.where(surv2, packed, _SENTINEL), dim=-1).values
    return _finish_list(packed, surv2.sum(-1), kf)


@functools.lru_cache(maxsize=16)
def pinhole_constants(hfov_deg: float, height: int, width: int, device: torch.device):
    """Per-camera constants of the fast path, on the device: camera-frame
    [d, 1] rows (R, 4), their transposed kernel tiles (nt, 8, Rt), the
    tile frustum planes (nt, 4, 3) and the sky colour."""
    hfov_rad = math.radians(hfov_deg)
    zero = torch.zeros((), device=device)
    d_cam = camera_rays(zero, zero, hfov_rad, height, width, device=device).reshape(-1, 3)
    R = d_cam.shape[0]
    d_aug = torch.cat([d_cam, torch.ones(R, 1, device=device)], dim=-1)
    ray_tile = min(_RAY_TILE, R)
    n_tiles = R // ray_tile
    d_t = torch.nn.functional.pad(
        d_aug.reshape(n_tiles, ray_tile, 4).transpose(1, 2), (0, 0, 0, 4)
    ).contiguous()  # (n_tiles, 8, Rt)
    planes = torch.from_numpy(
        tile_plane_normals_cam(hfov_rad, height, width, ray_tile // width, width)
    ).to(device)
    sky = torch.tensor([0.65, 0.75, 0.9], device=device)
    return d_aug, d_t, planes, sky, ray_tile


@functools.lru_cache(maxsize=16)
def block_constants(hfov_deg: float, height: int, width: int, device: torch.device):
    """Per-camera constants of the chunk-culled routes, rays in 32x32-pixel
    block order (tile j = block j, row-major over blocks): camera-frame dirs
    (R, 3), [d, 1] rows (R, 4), their transposed kernel tiles (nt, 8, 1024),
    the block frustum planes (nt, 4, 3) and the sky colour."""
    hfov_rad = math.radians(hfov_deg)
    zero = torch.zeros((), device=device)
    d_cam = camera_rays(zero, zero, hfov_rad, height, width, device=device)  # (H, W, 3)
    dcb = to_blocks(d_cam.reshape(1, height * width, 3), height, width)[0]
    R = dcb.shape[0]
    d_aug = torch.cat([dcb, torch.ones(R, 1, device=device)], dim=-1)
    n_tiles = R // _BLOCK_RAYS
    d_t = torch.nn.functional.pad(
        d_aug.reshape(n_tiles, _BLOCK_RAYS, 4).transpose(1, 2), (0, 0, 0, 4)
    ).contiguous()  # (n_tiles, 8, 1024)
    planes = torch.from_numpy(
        tile_plane_normals_cam(hfov_rad, height, width, _BLOCK, _BLOCK)
    ).to(device)
    sky = torch.tensor([0.65, 0.75, 0.9], device=device)
    return dcb, d_aug, d_t, planes, sky


def to_blocks(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H*W, ...) raster order -> 32x32-pixel block order."""
    N, R = x.shape[:2]
    tail = x.shape[2:]
    x = x.reshape(N, height // _BLOCK, _BLOCK, width // _BLOCK, _BLOCK, *tail).transpose(2, 3)
    return x.reshape(N, R, *tail)


def from_blocks(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H*W, ...) 32x32-pixel block order -> raster order."""
    N, R = x.shape[:2]
    tail = x.shape[2:]
    x = x.reshape(N, height // _BLOCK, width // _BLOCK, _BLOCK, _BLOCK, *tail).transpose(2, 3)
    return x.reshape(N, R, *tail)


def world_rays(
    yaw: torch.Tensor, pitch: torch.Tensor, hfov_deg: float, height: int, width: int,
    projection: str = "pinhole",
) -> torch.Tensor:
    """(N,), (N,) -> (N, H*W, 3) world-space ray directions in raster order.
    A fisheye camera's field of view is twice ``hfov_deg``; an equirect one
    sees the whole sphere."""
    y, p = yaw[:, None, None], pitch[:, None, None]
    if projection == "equirect":
        d = equirect_rays(y, p, height, width)
    elif projection == "fisheye":
        d = fisheye_rays(y, p, math.radians(hfov_deg * 2), height, width)
    elif projection == "pinhole":
        d = camera_rays(y, p, math.radians(hfov_deg), height, width, device=yaw.device)
    else:
        raise ValueError(f"projection {projection!r}: expected 'pinhole', 'equirect' or 'fisheye'")
    return d.reshape(yaw.shape[0], height * width, 3)


def is_large_scene(pack: ScenePack, cull_k: Optional[int] = None) -> bool:
    """Whether a render of this pack takes the chunk-culled routes: more
    than 2 x 48 chunks of 128 triangles (2 x ``cull_k`` where given)."""
    boundary = cull_k if cull_k is not None else _FAST_CULL_K
    return pack.tri_attr.shape[1] // 128 > 2 * boundary


def render_route(
    pack: ScenePack, height: int, width: int, projection: str = "pinhole", cull_k: Optional[int] = None,
    dynamic: bool = False,
) -> str:
    """The route a render takes, as the JAX package dispatches it
    (``dynamic``: whether the render merges dynamic geometry):

    - "pinhole": a pinhole image of a multiple of 1024 rays (and of 2048
      above 2048) on a scene of up to 2 x 48 chunks of 128 triangles (2 x
      ``cull_k``), without dynamic geometry: frustum-selected or every-chunk
      kernel, raster order;
    - "block": a pinhole image that splits into 32x32-pixel tiles on a
      larger scene: the chunklet or chunk stream, block order;
    - "culled": any other image of a multiple of 1024 rays on a larger
      scene: the culled kernel over raster-order 1024-ray tiles;
    - "index": everything else: the every-chunk index kernel."""
    R = height * width
    large = is_large_scene(pack, cull_k)
    if projection == "pinhole":
        if not large and not dynamic and R % 1024 == 0 and R % min(_RAY_TILE, R) == 0:
            return "pinhole"
        if large and height % _BLOCK == 0 and width % _BLOCK == 0:
            return "block"
    elif projection not in ("equirect", "fisheye"):
        raise ValueError(f"projection {projection!r}: expected 'pinhole', 'equirect' or 'fisheye'")
    return "culled" if large and R % _BLOCK_RAYS == 0 else "index"


def closest_hit_call(
    pack: ScenePack,
    sids: torch.Tensor,
    cam_pos: torch.Tensor,
    yaw: torch.Tensor,
    pitch: torch.Tensor,
    *,
    height: int,
    width: int,
    hfov_deg: float = 90.0,
    cull_k: Optional[int] = None,
    backend: str = "auto",
    projection: str = "pinhole",
    dynamic: bool = False,
):
    """The closest-hit step of one render's static scene: selection done, returns
    (kernel wrapper, args, kwargs, rays) where ``kernel(*args, **kwargs)``
    gives (t, idx), or (t, attrs_t) on the "culled" route (``render_route``).
    ``rays`` is the ray-feature matrix B (N, 4, 10) on the pinhole and block
    routes and the world ray directions (N, R, 3), raster order, on the
    general ones.

    Scenes up to 4096 padded triangles take the frustum-selected kernel and
    up to 96 chunks of 128 the every-chunk kernel, rays in raster order
    (with ``dynamic``, the index route instead).
    Larger scenes take the exact-culled chunklet stream, or the parent-chunk
    stream with ``backend="stream"``, rays in 32x32-pixel block order."""
    if backend not in ("auto", "stream"):
        raise ValueError(f"backend {backend!r}: expected 'auto' or 'stream'")
    T = pack.tri_attr.shape[1]
    R = height * width
    sids = sids.to(torch.int32)
    route = render_route(pack, height, width, projection, cull_k, dynamic)
    if route in ("index", "culled"):
        dirs = world_rays(yaw, pitch, hfov_deg, height, width, projection)
        origins = cam_pos[:, None, :].expand(-1, R, -1)
        if route == "index":
            rt = _RAY_TILE if R % _RAY_TILE == 0 else R
            return raycast_index_t, (pack.tri_mat, sids, ray_features_t(origins, dirs, rt)), dict(ray_tile=rt), dirs
        ids = select_chunks_occluded(
            pack.tri_mat, pack.chunk_bounds[sids.long()], sids, origins, dirs, _BLOCK_RAYS,
            _STREAM_CULL_K if cull_k is None else cull_k,
        )
        # the ids count the pack's own chunks: T // NC triangles each
        C_big = T // pack.chunk_bounds.shape[1]
        args = (pack.tri_mat, pack.tri_attr.transpose(1, 2).contiguous(), ids.contiguous(), sids,
                ray_features_t(origins, dirs, _BLOCK_RAYS))
        return raycast_culled_t, args, dict(ray_tile=_BLOCK_RAYS, tri_chunk=C_big), dirs
    B = ray_feature_matrix(cam_pos, yaw, pitch)  # (N, 4, 10)
    Bt = torch.nn.functional.pad(B.transpose(1, 2), (0, 0, 0, 6)).contiguous()  # (N,16,4)
    if route == "block":
        if cull_k is None:
            cull_k = _STREAM_CULL_K
        _, _, d_t, planes, _ = block_constants(float(hfov_deg), height, width, cam_pos.device)
        dirs_c = to_blocks(world_rays(yaw, pitch, hfov_deg, height, width), height, width)
        origins_c = cam_pos[:, None, :].expand(-1, R, -1)
        bounds = pack.chunk_bounds[sids.long()]
        C_big = T // pack.chunk_bounds.shape[1]
        kwargs = dict(ray_tile=_BLOCK_RAYS)
        if backend == "stream":
            ids, cnt = select_chunks_occluded(
                pack.tri_mat, bounds, sids, origins_c, dirs_c, _BLOCK_RAYS, cull_k, with_cnt=True
            )
            gm = group_tri_mat(pack.tri_mat, C_big).contiguous()
            return raycast_stream_t, (gm, sids, ids.contiguous(), cnt, d_t, Bt), dict(kwargs, tri_chunk=C_big), B
        ids0, cnt0 = select_chunks(
            bounds, origins_c, dirs_c, _BLOCK_RAYS, max(cull_k, _EXACT_MIN_K), with_cnt=True
        )
        # pack-time tables where the pack has them (scene-constant work does
        # not belong in the per-step render)
        ab = pack.chunklet_ab32
        if ab is None:
            ab = chunklet_aabbs(pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid, c=32)
        gm32 = pack.tri_mat_g32
        if gm32 is None:
            gm32 = group_tri_mat(pack.tri_mat, 32).contiguous()
        ids, cnt = select_chunklets_exact(
            pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid, ab, sids, cam_pos, yaw, pitch,
            planes, ids0, cnt0, parent_c=C_big, c=32, skip_exact=True,
            verts16=pack.tri_verts16,
        )
        return raycast_exactsel_t, (gm32, sids, ids.contiguous(), cnt, d_t, Bt), dict(kwargs, tri_chunk=32), B
    _, d_t, planes, _, ray_tile = pinhole_constants(float(hfov_deg), height, width, cam_pos.device)
    if T <= _SEL_MAX_TRIS and ray_tile % width == 0 and T % _SEL_CHUNK == 0:
        ids, cnt = select_chunks_frustum(
            pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid,
            sids.long(), cam_pos, yaw, pitch, planes, tri_chunk=_SEL_CHUNK,
        )
        args = (group_tri_mat(pack.tri_mat, _SEL_CHUNK).contiguous(), sids, ids, cnt, d_t, Bt)
        return raycast_fused_sel_t, args, dict(ray_tile=ray_tile, tri_chunk=_SEL_CHUNK), B
    args = (group_tri_mat(pack.tri_mat).contiguous(), sids, d_t, Bt)
    return raycast_fused_t, args, dict(ray_tile=ray_tile, tri_chunk=128), B


def plane_exact_t(pack: ScenePack, sids: torch.Tensor, B: torch.Tensor, t: torch.Tensor, idx: torch.Tensor,
                  d_aug: torch.Tensor):
    """The pinhole route's epilogue head on the kernel's (t, idx) (N, R),
    raster order, with B the ray-feature matrix (N, 4, 10) and ``d_aug`` the
    camera-frame rays of ``pinhole_constants``: (the plane-exact t, the
    winner's 8 attributes (N, R, 8), zero on a miss, n.d). The plane-exact t
    is n.(v0 - o) / n.d from the winner's plane; the kernel's t on a miss or
    a grazing hit (|n.d| <= 1e-6)."""
    hit = idx >= 0
    # winner attributes [n(3), rgb(3), sem, valid | v0(3)] gathered exactly
    # (the JAX package's HIGHEST-precision one-hot product is this copy)
    table = torch.cat([pack.tri_attr, pack.tri_v0], dim=2)  # (S, T, 11)
    attrs = table[sids.long()[:, None], idx.clamp(min=0).long()] * hit[..., None].float()  # (N, R, 11)
    dirs = torch.einsum("rk,nkf->nrf", d_aug, B[..., 0:3])  # (N, R, 3) world dirs
    nrm = attrs[..., 0:3]
    nd = (nrm * dirs).sum(-1)  # signed n.d
    num = (nrm * (attrs[..., 8:11] - B[:, 3:4, 3:6])).sum(-1)  # n.(v0 - o); B[:, 3, 3:6] is o
    ok = hit & (nd.abs() > 1e-6)
    return torch.where(ok, num / torch.where(ok, nd, torch.ones_like(nd)), t), attrs[..., :8], nd


@functools.lru_cache(maxsize=None)
def _sky(device: torch.device) -> torch.Tensor:
    """The sky colour on ``device``, copied from the host once per device (a
    copy per render would wait on the card)."""
    return torch.tensor([0.65, 0.75, 0.9], device=device)


def _frames(N, height, width, hit, z, nd, base, sem_val, sky, max_depth, min_depth, normalize_depth):
    """Shared tail of the epilogues on (N, R) planes in raster order: depth
    clip/normalize, flat+Lambert shade, u8 rgb, semantic ids. ``base`` is
    the (N, R, 3) colour of each ray's winner."""
    z = torch.where(hit, z, torch.full_like(z, max_depth)).clamp(min_depth, max_depth)
    if normalize_depth:
        z = (z - min_depth) / (max_depth - min_depth)
    shade = 0.35 + 0.65 * nd.abs()
    rgb = torch.where(hit[..., None], base * shade[..., None], sky)
    rgb_u8 = (rgb * 255.0).clamp(0, 255).to(torch.uint8)
    sem = torch.where(hit, sem_val.round().to(torch.int32), 0)
    return {
        "rgb": rgb_u8.reshape(N, height, width, 3),
        "depth": z.reshape(N, height, width, 1),
        "semantic": sem.reshape(N, height, width, 1),
    }


def _dynamic_hits(dynamic: Dict[str, torch.Tensor], origins: torch.Tensor, dirs: torch.Tensor, ray_tile: int):
    """The dynamic pass: each env's triangles, padded to a multiple of 128,
    as that env's own scene through the index kernel (``sids = arange(N)``).
    Returns (t2 (N, R), idx2 (N, R), the winner's [n(3), rgb(3), sem] (N, R,
    7), zero on a miss); n is the unit normal e1 x e2 / (|e1 x e2| + 1e-9)."""
    N, td, _ = dynamic["v0"].shape
    pad = (-td) % 128

    def padded(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, pad))

    v0, e1, e2 = padded(dynamic["v0"]), padded(dynamic["e1"]), padded(dynamic["e2"])
    mat = build_tri_matrix_torch(v0, e1, e2, torch.nn.functional.pad(dynamic["valid"].float(), (0, pad)))
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / (torch.linalg.vector_norm(nrm, dim=-1, keepdim=True) + 1e-9)
    sem = torch.nn.functional.pad(dynamic["sem"].float(), (0, pad))
    table = torch.cat([nrm, padded(dynamic["color"]), sem[..., None]], dim=-1)  # (N, Tp, 7)
    env = torch.arange(N, dtype=torch.int32, device=v0.device)
    t2, idx2 = raycast_index_t(mat.contiguous(), env, ray_features_t(origins, dirs, ray_tile), ray_tile=ray_tile)
    # the winner's row, gathered exactly (the JAX package's one-hot product)
    attr2 = table[env.long()[:, None], idx2.clamp(min=0).long()] * (idx2 >= 0)[..., None]
    return t2, idx2, attr2


def _merge_dynamic(dynamic, cam_pos, dirs, t, hit, nrm, base, sem_val):
    """The general merge, rays in raster order: where a dynamic triangle is
    hit nearer than the static t, its t, normal, colour and semantic id."""
    R = dirs.shape[1]
    origins = cam_pos[:, None, :].expand(-1, R, -1)
    t2, idx2, attr2 = _dynamic_hits(dynamic, origins, dirs, _RAY_TILE if R % _RAY_TILE == 0 else R)
    closer = (idx2 >= 0) & (t2 < t)
    c = closer[..., None]
    return (torch.where(closer, t2, t), hit | closer, torch.where(c, attr2[..., 0:3], nrm),
            torch.where(c, attr2[..., 3:6], base), torch.where(closer, attr2[..., 6], sem_val))


def _planar(t, dirs, yaw, pitch):
    """Planar depth t * cos(angle to the camera's forward axis)."""
    cp = torch.cos(pitch)
    fwd_flat = yaw_to_forward(yaw)
    fwd = torch.stack([fwd_flat[..., 0] * cp, torch.sin(pitch), fwd_flat[..., 2] * cp], dim=-1)
    return t * (dirs * fwd[:, None, :]).sum(-1)


def _general_epilogue(pack, sid, route, t, res, dirs, yaw, pitch, projection, height, width, depth_cfg,
                      cam_pos, dynamic):
    """The general route's frames from the kernel's t and its winner index
    (``res`` = idx) or attributes (``res`` = attrs_t, "culled"), merged with
    ``dynamic`` where given: no plane-exact t; planar depth t (d . forward)
    for pinhole cameras, the range t otherwise; Lambert shade |n . d|."""
    N = t.shape[0]
    if route == "culled":
        attrs = res.transpose(1, 2)  # (N, R, 8)
        hit = attrs[..., 7] > 0.5
    else:
        hit = res >= 0
        # the winner's attributes, gathered exactly (the JAX package's
        # one-hot product is this copy)
        attrs = pack.tri_attr[sid, res.clamp(min=0).long()] * hit[..., None].float()
    nrm, base, sem_val = attrs[..., 0:3], attrs[..., 3:6], attrs[..., 6]
    if dynamic is not None:
        t, hit, nrm, base, sem_val = _merge_dynamic(dynamic, cam_pos, dirs, t, hit, nrm, base, sem_val)
    z = _planar(t, dirs, yaw, pitch) if projection == "pinhole" else t
    nd = (nrm * dirs).sum(-1)
    return _frames(N, height, width, hit, z, nd, base, sem_val, _sky(t.device), *depth_cfg)


def render_batch(
    pack: ScenePack,
    sids: torch.Tensor,  # (N,) int
    cam_pos: torch.Tensor,  # (N,3)
    yaw: torch.Tensor,  # (N,)
    pitch: torch.Tensor,  # (N,)
    *,
    height: int,
    width: int,
    hfov_deg: float = 90.0,
    max_depth: float = 10.0,
    min_depth: float = 0.0,
    normalize_depth: bool = True,
    backend: str = "auto",  # "stream": the parent-chunk stream on large scenes
    dynamic: Optional[Dict[str, torch.Tensor]] = None,
    cull_k: Optional[int] = None,
    projection: str = "pinhole",
) -> Dict[str, torch.Tensor]:
    """Render all envs: (N,H,W,C) frames of a scene through a pinhole,
    equirect or fisheye camera (``render_route`` says which kernel serves
    which camera, image size and scene size).

    Depth is clipped to [min_depth, max_depth] and normalized if requested:
    planar z-depth for pinhole cameras, the Euclidean range for equirect and
    fisheye ones. Frames come out on the device of ``pack``; on the card the
    closest-hit pass is a CUDA kernel, on the CPU its plain version.
    ``cull_k`` is the number of parent chunks the chunk-culled routes keep
    per tile, and sets the scene size from which they are taken.

    ``dynamic``: per-env movable geometry merged by closest hit, a dict of
    v0, e1, e2 (N, Td, 3), valid (N, Td), color (N, Td, 3) and sem (N, Td),
    on the pack's device."""
    cam_pos = cam_pos.float()
    kernel, args, kwargs, rays = closest_hit_call(
        pack, sids, cam_pos, yaw, pitch, height=height, width=width, hfov_deg=hfov_deg,
        cull_k=cull_k, backend=backend, projection=projection, dynamic=dynamic is not None,
    )
    return render_epilogue(
        pack, sids, cam_pos, yaw, pitch, kernel(*args, **kwargs), rays, height=height, width=width,
        hfov_deg=hfov_deg, max_depth=max_depth, min_depth=min_depth, normalize_depth=normalize_depth,
        dynamic=dynamic, cull_k=cull_k, projection=projection,
    )


def render_epilogue(
    pack: ScenePack,
    sids: torch.Tensor,
    cam_pos: torch.Tensor,
    yaw: torch.Tensor,
    pitch: torch.Tensor,
    hits: Tuple[torch.Tensor, torch.Tensor],
    rays: torch.Tensor,
    *,
    height: int,
    width: int,
    hfov_deg: float = 90.0,
    max_depth: float = 10.0,
    min_depth: float = 0.0,
    normalize_depth: bool = True,
    dynamic: Optional[Dict[str, torch.Tensor]] = None,
    cull_k: Optional[int] = None,
    projection: str = "pinhole",
) -> Dict[str, torch.Tensor]:
    """The frames of ``render_batch`` from its closest-hit step: ``hits`` =
    ``kernel(*args, **kwargs)`` and ``rays`` of ``closest_hit_call`` on the
    same arguments. The last stage of a render, callable on its own."""
    N = sids.shape[0]
    cam_pos = cam_pos.float()
    route = render_route(pack, height, width, projection, cull_k, dynamic is not None)
    t, res = hits
    sid = sids.long()[:, None]
    depth_cfg = (max_depth, min_depth, normalize_depth)
    if route in ("index", "culled"):
        return _general_epilogue(pack, sid, route, t, res, rays, yaw, pitch, projection, height, width, depth_cfg,
                                 cam_pos, dynamic)
    B, idx = rays, res
    if route == "pinhole":
        d_aug, _, _, sky, _ = pinhole_constants(float(hfov_deg), height, width, cam_pos.device)
        t_pl, attrs, nd = plane_exact_t(pack, sids, B, t, idx, d_aug)
        z = t_pl * (-d_aug[None, :, 2])
        return _frames(N, height, width, idx >= 0, z, nd, attrs[..., 3:6], attrs[..., 6], sky, *depth_cfg)

    dcb, d_aug, _, _, sky = block_constants(float(hfov_deg), height, width, cam_pos.device)
    if pack.tri_attr16 is not None:
        # channel-major epilogue in block order: ONE 64-byte row gather per
        # ray, then every quantity is an (N, R) plane
        hit = idx >= 0
        a16 = pack.tri_attr16[sid, idx.clamp(min=0).long()]  # (N, R, 16)
        at = a16.permute(2, 0, 1).contiguous()  # (16, N, R)
        dirs = torch.einsum("rk,nkf->fnr", d_aug, B[..., 0:3])  # (3, N, R) world dirs
        cam = cam_pos.t()[:, :, None]  # (3, N, 1)
        nd = at[0] * dirs[0] + at[1] * dirs[1] + at[2] * dirs[2]  # n.d
        n_o = at[0] * cam[0] + at[1] * cam[1] + at[2] * cam[2]  # n.o
        ok = hit & (nd.abs() > 1e-6)
        # plane-exact t from the precomputed n.v0: (n.v0 - n.o) / (n.d). The
        # two dots round independently (error ~|n.v0| * 1e-7): fine for
        # scene coordinates of modest extent
        t_pl = torch.where(ok, (at[ATTR16_NV0] - n_o) / torch.where(ok, nd, torch.ones_like(nd)), t)
        base, sem_val = a16[..., 3:6], at[6]
        if dynamic is not None:
            # the dynamic pass in block order, merged against the kernel's t
            R = height * width
            dirs_c = to_blocks(world_rays(yaw, pitch, hfov_deg, height, width), height, width)
            t2, idx2, attr2 = _dynamic_hits(dynamic, cam_pos[:, None, :].expand(-1, R, -1), dirs_c, _BLOCK_RAYS)
            closer = (idx2 >= 0) & (t2 < t)
            nd2 = attr2[..., 0] * dirs[0] + attr2[..., 1] * dirs[1] + attr2[..., 2] * dirs[2]
            hit = hit | closer
            t_pl = torch.where(closer, t2, t_pl)
            nd = torch.where(closer, nd2, nd)
            base = torch.where(closer[..., None], attr2[..., 3:6], base)
            sem_val = torch.where(closer, attr2[..., 6], sem_val)
        z = torch.where(hit, t_pl, torch.zeros_like(t_pl)) * (-dcb[:, 2])[None, :]

        def fb(x):
            return from_blocks(x, height, width)

        return _frames(N, height, width, fb(hit), fb(z), fb(nd), fb(base), fb(sem_val), sky, *depth_cfg)
    # row-gather epilogue for packs without tri_attr16, in raster order
    t, idx = from_blocks(t, height, width), from_blocks(idx, height, width)
    hit = idx >= 0
    safe = idx.clamp(min=0).long()
    attrs = pack.tri_attr[sid, safe] * hit[..., None].float()  # (N, R, 8)
    v0g = pack.tri_v0[sid, safe]
    dirs = world_rays(yaw, pitch, hfov_deg, height, width)
    nrm, base, sem_val = attrs[..., 0:3], attrs[..., 3:6], attrs[..., 6]
    nd = (nrm * dirs).sum(-1)
    num = (nrm * (v0g - cam_pos[:, None, :])).sum(-1)
    ok = hit & (nd.abs() > 1e-6)
    t = torch.where(ok, num / torch.where(ok, nd, torch.ones_like(nd)), t)
    if dynamic is not None:
        t, hit, nrm, base, sem_val = _merge_dynamic(dynamic, cam_pos, dirs, t, hit, nrm, base, sem_val)
        nd = (nrm * dirs).sum(-1)
    return _frames(N, height, width, hit, _planar(t, dirs, yaw, pitch), nd, base, sem_val, sky, *depth_cfg)


def render_env(
    pack: ScenePack,
    sid,
    cam_pos,
    yaw,
    pitch,
    **kw,
) -> Dict[str, torch.Tensor]:
    """One camera: ``render_batch`` at N=1, squeezed to (H, W, C) frames.
    ``sid``, ``cam_pos`` (3,), ``yaw`` and ``pitch`` are tensors on the
    pack's device or host numbers (copied there)."""
    dev = pack.nav_lo.device

    def one(x, dtype, shape):
        return torch.as_tensor(x, dtype=dtype, device=dev).reshape(shape)

    out = render_batch(
        pack, one(sid, torch.int64, (1,)), one(cam_pos, torch.float32, (1, 3)), one(yaw, torch.float32, (1,)),
        one(pitch, torch.float32, (1,)), **kw,
    )
    return {k: v[0] for k, v in out.items()}
