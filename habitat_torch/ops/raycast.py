"""Batched triangle raycasting -> RGB / depth / semantic frames.

Port of the pinhole fast path of ``habitat_tpu/ops/raycast.py::render_batch``
(and the helpers it runs): per-screen-tile frustum culling at 32-triangle
chunk granularity (``select_chunks_frustum``), the closest-hit kernel
(``ops/raycast_kernels.py``), then the attribute gather with plane-exact
depth recovery and flat+Lambert shading.

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

from habitat_torch.ops.raycast_kernels import raycast_fused_sel_t, raycast_fused_t
from habitat_torch.sims.scene import ScenePack
from habitat_torch.utils.geometry import camera_rays, view_rotation_matrix

# the fast path keeps the whole scene per kernel call up to 2 x 48 chunks
# of 128 triangles; beyond it the JAX package switches to occlusion culling
_MAX_FAST_CHUNKS = 96
# frustum-selected route up to this many (padded) triangles
_SEL_MAX_TRIS = 4096
_SEL_CHUNK = 32
_RAY_TILE = 2048


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
):
    """The pinhole fast path's closest-hit step for one render: returns
    (kernel wrapper, args, kwargs, B) where ``kernel(*args, **kwargs)`` gives
    (t, idx) and B (N, 4, 10) is the ray-feature matrix. Scenes up to 4096
    padded triangles take the frustum-selected kernel, larger ones (up to
    96 chunks of 128) the every-chunk kernel. Raises NotImplementedError for
    the branches the port does not have yet."""
    T = pack.tri_attr.shape[1]
    if T // 128 > _MAX_FAST_CHUNKS:
        raise NotImplementedError(
            f"{T} padded triangles exceed the fast path's {_MAX_FAST_CHUNKS} "
            "chunks; the occlusion-culled large-scene route is ROADMAP Queue 1 "
            "item 7 / Queue 2 items 4-7"
        )
    R = height * width
    if R % 1024 or R % min(_RAY_TILE, R):
        raise NotImplementedError(
            f"{height}x{width} images do not tile into 1024/2048-ray kernel "
            "tiles; the general path is ROADMAP Queue 2 item 3 "
            "(raycast_pallas_index_t)"
        )
    _, d_t, planes, _, ray_tile = pinhole_constants(float(hfov_deg), height, width, cam_pos.device)
    B = ray_feature_matrix(cam_pos, yaw, pitch)  # (N, 4, 10)
    Bt = torch.nn.functional.pad(B.transpose(1, 2), (0, 0, 0, 6)).contiguous()  # (N,16,4)
    sids = sids.to(torch.int32)
    if T <= _SEL_MAX_TRIS and ray_tile % width == 0 and T % _SEL_CHUNK == 0:
        ids, cnt = select_chunks_frustum(
            pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid,
            sids.long(), cam_pos, yaw, pitch, planes, tri_chunk=_SEL_CHUNK,
        )
        args = (group_tri_mat(pack.tri_mat, _SEL_CHUNK).contiguous(), sids, ids, cnt, d_t, Bt)
        return raycast_fused_sel_t, args, dict(ray_tile=ray_tile, tri_chunk=_SEL_CHUNK), B
    args = (group_tri_mat(pack.tri_mat).contiguous(), sids, d_t, Bt)
    return raycast_fused_t, args, dict(ray_tile=ray_tile, tri_chunk=128), B


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
    dynamic: Optional[Dict[str, torch.Tensor]] = None,
    projection: str = "pinhole",
) -> Dict[str, torch.Tensor]:
    """Render all envs: (N,H,W,C) frames through the pinhole fast path.

    Depth is planar z-depth clipped to [min_depth, max_depth], normalized if
    requested. Frames come out on the device of ``pack``; on the card the
    closest-hit pass is the CUDA kernel, on the CPU its plain version."""
    if projection != "pinhole":
        raise NotImplementedError(
            f"{projection} cameras are ROADMAP Queue 1 item 9 (equirect and "
            "fisheye cameras)"
        )
    if dynamic is not None:
        raise NotImplementedError(
            "dynamic geometry is ROADMAP Queue 1 item 8 (rearrangement render merge)"
        )
    N = sids.shape[0]
    cam_pos = cam_pos.float()
    kernel, args, kwargs, B = closest_hit_call(
        pack, sids, cam_pos, yaw, pitch, height=height, width=width, hfov_deg=hfov_deg
    )
    t, idx = kernel(*args, **kwargs)
    d_aug, _, _, sky, _ = pinhole_constants(float(hfov_deg), height, width, cam_pos.device)
    hit = idx >= 0
    # winner attributes [n(3), rgb(3), sem, valid | v0(3)] gathered exactly
    # (the JAX package's HIGHEST-precision one-hot product is this copy)
    table = torch.cat([pack.tri_attr, pack.tri_v0], dim=2)  # (S, T, 11)
    attrs = table[sids.long()[:, None], idx.clamp(min=0).long()]  # (N, R, 11)
    attrs = attrs * hit[..., None].float()
    dirs = torch.einsum("rk,nkf->nrf", d_aug, B[..., 0:3])  # (N, R, 3) world dirs
    nrm = attrs[..., 0:3]
    nd = (nrm * dirs).sum(-1)  # signed n.d
    num = (nrm * (attrs[..., 8:11] - cam_pos[:, None, :])).sum(-1)  # n.(v0 - o)
    ok = hit & (nd.abs() > 1e-6)
    # plane-exact t from the winner's plane
    t_pl = torch.where(ok, num / torch.where(ok, nd, torch.ones_like(nd)), t)
    z = t_pl * (-d_aug[None, :, 2])
    z = torch.where(hit, z, torch.full_like(z, max_depth))
    z = z.clamp(min_depth, max_depth)
    if normalize_depth:
        z = (z - min_depth) / (max_depth - min_depth)
    shade = 0.35 + 0.65 * nd.abs()
    rgb = torch.where(hit[..., None], attrs[..., 3:6] * shade[..., None], sky)
    rgb_u8 = (rgb * 255.0).clamp(0, 255).to(torch.uint8)
    sem = torch.where(hit, attrs[..., 6].round().to(torch.int32), 0)
    return {
        "rgb": rgb_u8.reshape(N, height, width, 3),
        "depth": z.reshape(N, height, width, 1),
        "semantic": sem.reshape(N, height, width, 1),
    }
