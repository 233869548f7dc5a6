"""Scene representation: host-side build, device-side packed tensors.

Port of ``habitat_tpu/sims/scene.py``. The host half (``SceneData``,
``rasterize_occupancy``, ``geodesic_field``, ``largest_island_mask`` and the
packing arithmetic) is the same numpy code; ``ScenePack`` is a dataclass of
torch tensors with ``.to(device)``.

Coordinates: y-up, units meters (habitat convention). Navgrid cells are in the
xz plane at the scene's floor height.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from habitat_torch import native as _native

INF_DIST = np.float32(1e6)


@dataclasses.dataclass
class SceneData:
    """One scene on the host. Triangle soup + navgrid."""

    scene_id: str
    # triangles
    vertices: np.ndarray  # (T, 3, 3) f32 — per-triangle vertex positions
    colors: np.ndarray  # (T, 3) f32 in [0,1]
    semantic_ids: np.ndarray  # (T,) int32
    # navgrid
    nav_occ: Optional[np.ndarray] = None  # (NX, NZ) bool, True = navigable
    obst_dist: Optional[np.ndarray] = None  # (NX, NZ) f32 — meters to nearest obstacle
    nav_lo: Optional[np.ndarray] = None  # (2,) world xz of cell (0,0) CENTER
    nav_res: float = 0.1
    floor_y: float = 0.0
    # semantic object / region annotations (SemanticScene equivalent)
    objects: Optional[list] = None
    regions: Optional[list] = None
    # discrete level-of-detail: per-triangle lod id + per-lod (dmin, dmax)
    # render distance band (meters). None = single-LOD scene.
    tri_lod: Optional[np.ndarray] = None  # (T,) int32
    lod_ranges: Optional[list] = None  # [(dmin, dmax), ...] per lod id

    @property
    def num_triangles(self) -> int:
        return int(self.vertices.shape[0])

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        v = self.vertices.reshape(-1, 3)
        return v.min(axis=0), v.max(axis=0)

    # -- navgrid helpers (host) -------------------------------------------
    def world_to_cell(self, xz: np.ndarray) -> np.ndarray:
        return np.round((np.asarray(xz) - self.nav_lo) / self.nav_res).astype(np.int64)

    def cell_to_world(self, ij: np.ndarray) -> np.ndarray:
        return np.asarray(ij, dtype=np.float64) * self.nav_res + self.nav_lo

    def is_navigable(self, pos: np.ndarray) -> bool:
        """Whether a world position's navgrid cell is navigable (False off the grid)."""
        i, k = self.world_to_cell(np.asarray(pos)[[0, 2]])
        nx, nz = self.nav_occ.shape
        return bool(0 <= i < nx and 0 <= k < nz and self.nav_occ[i, k])

    def sample_navigable_point(
        self, rng: np.random.Generator, largest_island_only: bool = False
    ) -> np.ndarray:
        occ = (
            largest_island_mask(self.nav_occ) if largest_island_only else self.nav_occ
        )
        ii, kk = np.nonzero(occ)
        j = rng.integers(len(ii))
        xz = self.cell_to_world(np.array([ii[j], kk[j]]))
        return np.array([xz[0], self.floor_y, xz[1]], dtype=np.float32)


def largest_island_mask(occ: np.ndarray) -> np.ndarray:
    """Largest 4-connected navigable component (episode generation samples
    only from it so agents and goals are mutually reachable)."""
    occ = np.asarray(occ, bool)
    labels = np.zeros(occ.shape, np.int32)
    cur = 0
    best_label, best_size = 0, 0
    for i, k in zip(*np.nonzero(occ)):
        if labels[i, k]:
            continue
        cur += 1
        stack = [(i, k)]
        labels[i, k] = cur
        size = 0
        while stack:
            a, b = stack.pop()
            size += 1
            for da, db in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                x, y = a + da, b + db
                if (
                    0 <= x < occ.shape[0]
                    and 0 <= y < occ.shape[1]
                    and occ[x, y]
                    and not labels[x, y]
                ):
                    labels[x, y] = cur
                    stack.append((x, y))
        if size > best_size:
            best_size, best_label = size, cur
    return labels == best_label


def rasterize_occupancy(
    scene: SceneData,
    res: float = 0.1,
    agent_radius: float = 0.1,
    agent_height: float = 1.5,
    floor_y: Optional[float] = None,
    step_clearance: float = 0.2,
    pad_cells: int = 2,
) -> None:
    """Bake the navgrid from the triangle soup (in place).

    A cell is navigable iff (a) some triangle provides floor support near
    ``floor_y`` and (b) no obstacle triangle intersects the agent's body slab
    ``[floor+step_clearance, floor+height]`` within ``agent_radius`` of the
    cell center.
    """
    from scipy import ndimage

    lo, hi = scene.bounds()
    if floor_y is None:
        floor_y = float(lo[1])
    nav_lo = lo[[0, 2]] - pad_cells * res
    nx = int(np.ceil((hi[0] - lo[0]) / res)) + 2 * pad_cells + 1
    nz = int(np.ceil((hi[2] - lo[2]) / res)) + 2 * pad_cells + 1

    v = scene.vertices  # (T, 3, 3)
    ymin = v[:, :, 1].min(axis=1)
    ymax = v[:, :, 1].max(axis=1)
    is_floor = (ymin <= floor_y + 0.05) & (ymax <= floor_y + step_clearance)
    is_obst = ymax > floor_y + step_clearance
    # obstacle must overlap the body slab
    is_obst &= ymin < floor_y + agent_height

    tol = 0.75 * res
    floor = _native.rasterize_triangles_native(
        v[is_floor][:, :, [0, 2]], nav_lo, res, (nx, nz), tol
    )
    obst = _native.rasterize_triangles_native(
        v[is_obst][:, :, [0, 2]], nav_lo, res, (nx, nz), tol
    )

    # erode navigable area by agent radius: dilate obstacles with a disk
    r_cells = int(np.ceil(agent_radius / res))
    if r_cells > 0:
        yy, xx = np.mgrid[-r_cells : r_cells + 1, -r_cells : r_cells + 1]
        disk = (xx**2 + yy**2) <= r_cells**2
        obst = ndimage.binary_dilation(obst, structure=disk)
        # also keep agents away from the floor boundary (falling off the map)
        floor = ndimage.binary_erosion(floor, structure=disk)

    scene.nav_occ = floor & ~obst
    # euclidean distance (meters) to nearest non-navigable cell
    scene.obst_dist = (
        ndimage.distance_transform_edt(scene.nav_occ).astype(np.float32) * res
    )
    scene.nav_lo = nav_lo.astype(np.float32)
    scene.nav_res = float(res)
    scene.floor_y = float(floor_y)


def geodesic_field(nav_occ: np.ndarray, sources: np.ndarray, res: float) -> np.ndarray:
    """Multi-source geodesic distance field (meters) over the navgrid: exact
    16-connected Dijkstra (native). sources: (M, 2) int cell indices.
    Returns (NX, NZ) f32, INF_DIST where unreachable or non-navigable."""
    out = _native.geodesic_field_native(nav_occ, np.asarray(sources), res)
    # pin sources to zero (snapped goals may sit on blocked cells)
    src = np.asarray(sources).reshape(-1, 2)
    ok = (
        (src[:, 0] >= 0)
        & (src[:, 0] < out.shape[0])
        & (src[:, 1] >= 0)
        & (src[:, 1] < out.shape[1])
    )
    src = src[ok]
    out[src[:, 0], src[:, 1]] = 0.0
    return out


@dataclasses.dataclass
class ScenePack:
    """S scenes packed into tensors, padded to max sizes."""

    tri_v0: torch.Tensor  # (S, T, 3) f32
    tri_e1: torch.Tensor  # (S, T, 3) f32 — v1 - v0
    tri_e2: torch.Tensor  # (S, T, 3) f32 — v2 - v0
    tri_color: torch.Tensor  # (S, T, 3) f32
    tri_sem: torch.Tensor  # (S, T) i32
    tri_valid: torch.Tensor  # (S, T) bool
    tri_mat: torch.Tensor  # (S, 10, 4, T) f32 — raycast coefficient matrix
    tri_attr: torch.Tensor  # (S, T, 8) f32 — [unit normal(3), color(3), sem, valid]
    chunk_bounds: torch.Tensor  # (S, T//chunk, 6) f32 — spheres + LOD band
    nav_occ: torch.Tensor  # (S, NX, NZ) bool
    obst_dist: torch.Tensor  # (S, NX, NZ) f32 meters to nearest obstacle
    nav_lo: torch.Tensor  # (S, 2) f32
    floor_y: torch.Tensor  # (S,) f32
    # scan-scale render tables, built at pack time for packs of chunk 256
    # (None otherwise; the renderer then derives what it needs per call):
    # the 32-triangle-grouped matrix (group_tri_mat(tri_mat, 32)), the
    # per-chunklet AABBs [center(3), half(3)], the epilogue's 64-byte rows
    # [attr(8) | v0(3) | n.v0 | pad(4)] and the exact cull's vertex rows
    # [v0 | e1 | e2 | pad(6) | valid]
    tri_mat_g32: Optional[torch.Tensor] = None  # (S, 10, 4T)
    chunklet_ab32: Optional[torch.Tensor] = None  # (S, T//32, 6)
    tri_attr16: Optional[torch.Tensor] = None  # (S, T, 16)
    tri_verts16: Optional[torch.Tensor] = None  # (S, T, 16)
    nav_res: float = 0.1
    scene_ids: Tuple[str, ...] = ()

    @property
    def num_scenes(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def max_triangles(self) -> int:
        return int(self.tri_v0.shape[1])

    def to(self, device) -> "ScenePack":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


TRI_CHUNK = 128  # culling chunk; the renderer's kernels regroup it
# padded triangle count from which a pack is scan-scale: culling chunks of
# 256 triangles (half the chunk-stream kernel's per-tile iterations) and the
# render tables above built at pack time
_SCAN_SCALE_TRIS = 262144
_SCAN_CHUNK = 256


def _morton_sort_keys(centroids: np.ndarray) -> np.ndarray:
    """Morton codes of the quantized centroids."""
    lo = centroids.min(axis=0)
    span = centroids.max(axis=0) - lo + 1e-6
    q = np.clip(((centroids - lo) / span * 1023).astype(np.uint32), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def pack_scenes(
    scenes: List[SceneData],
    tri_pad: int = TRI_CHUNK,
    force_scan_tables: bool = False,
) -> ScenePack:
    """Pack host scenes into one padded CPU ScenePack (triangles
    morton-sorted; per-chunk bounding spheres). Move it with ``.to``.

    ``force_scan_tables`` builds the scan-scale layout (chunk 256 and the
    render tables) whatever the scene size, so that tests reach the
    scan-only render path on small scenes."""
    from habitat_torch.ops.raycast import (
        ATTR16_NV0,
        VERTS16_VALID,
        build_tri_matrix,
        chunklet_aabbs,
        group_tri_mat,
    )

    if not scenes:
        raise ValueError("pack_scenes needs at least one scene")
    tri_pad = max(tri_pad, TRI_CHUNK)
    t_max = _round_up(max(s.num_triangles for s in scenes), tri_pad)
    scan = force_scan_tables or t_max >= _SCAN_SCALE_TRIS
    chunk = _SCAN_CHUNK if scan else TRI_CHUNK
    t_max = _round_up(t_max, chunk)
    grids = [s.nav_occ.shape for s in scenes]
    nx = max(g[0] for g in grids)
    nz = max(g[1] for g in grids)

    S = len(scenes)
    v0 = np.zeros((S, t_max, 3), np.float32)
    e1 = np.zeros((S, t_max, 3), np.float32)
    e2 = np.zeros((S, t_max, 3), np.float32)
    col = np.zeros((S, t_max, 3), np.float32)
    sem = np.zeros((S, t_max), np.int32)
    valid = np.zeros((S, t_max), bool)
    tmat = np.zeros((S, 10, 4, t_max), np.float32)
    tattr = np.zeros((S, t_max, 8), np.float32)
    occ = np.zeros((S, nx, nz), bool)
    odist = np.zeros((S, nx, nz), np.float32)
    lo = np.zeros((S, 2), np.float32)
    fy = np.zeros((S,), np.float32)

    n_chunks = t_max // chunk
    # bounding spheres + LOD render band: [cx, cy, cz, r, dmin, dmax]
    cb = np.zeros((S, n_chunks, 6), np.float32)

    for i, s in enumerate(scenes):
        n = s.num_triangles
        v = s.vertices
        keys = _morton_sort_keys(v.mean(axis=1))
        if s.tri_lod is not None:
            # keep chunks LOD-pure: morton-sort WITHIN each lod group
            order = np.lexsort((keys, s.tri_lod))
            tri_lod_sorted = s.tri_lod[order]
        else:
            order = np.argsort(keys, kind="stable")
            tri_lod_sorted = None
        v = v[order]
        v0[i, :n] = v[:, 0]
        e1[i, :n] = v[:, 1] - v[:, 0]
        e2[i, :n] = v[:, 2] - v[:, 0]
        col[i, :n] = s.colors[order]
        sem[i, :n] = s.semantic_ids[order]
        valid[i, :n] = True
        # per-chunk bounding spheres (padding chunks: zero radius far away)
        cb[i, :, 3] = -1.0
        cb[i, :, 1] = -1e6
        cb[i, :, 5] = 1e9  # default band: always rendered
        for c in range(n_chunks):
            a, b = c * chunk, min((c + 1) * chunk, n)
            if a >= n:
                break
            pts = v[a:b].reshape(-1, 3)
            ctr = (pts.min(axis=0) + pts.max(axis=0)) / 2
            cb[i, c, :3] = ctr
            cb[i, c, 3] = float(np.linalg.norm(pts - ctr, axis=-1).max())
            if tri_lod_sorted is not None and s.lod_ranges is not None:
                lod = int(tri_lod_sorted[a])  # chunk is lod-pure
                dmin, dmax = s.lod_ranges[lod]
                cb[i, c, 4] = dmin
                cb[i, c, 5] = dmax
        tmat[i] = build_tri_matrix(v0[i], e1[i], e2[i], valid[i])
        nrm = np.cross(e1[i], e2[i])
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-9
        tattr[i, :, 0:3] = nrm
        tattr[i, :, 3:6] = col[i]
        tattr[i, :, 6] = sem[i]
        tattr[i, :, 7] = valid[i]
        g = s.nav_occ
        occ[i, : g.shape[0], : g.shape[1]] = g
        odist[i, : g.shape[0], : g.shape[1]] = s.obst_dist
        lo[i] = s.nav_lo
        fy[i] = s.floor_y

    t = torch.from_numpy
    tables = {}
    if scan:
        nv0 = (tattr[..., 0] * v0[..., 0] + tattr[..., 1] * v0[..., 1]) + tattr[..., 2] * v0[..., 2]
        attr16 = np.zeros((S, t_max, 16), np.float32)
        attr16[..., 0:8] = tattr
        attr16[..., 8:11] = v0
        attr16[..., ATTR16_NV0] = nv0
        verts16 = np.zeros((S, t_max, 16), np.float32)
        verts16[..., 0:3] = v0
        verts16[..., 3:6] = e1
        verts16[..., 6:9] = e2
        verts16[..., VERTS16_VALID] = valid
        tables = dict(
            tri_mat_g32=group_tri_mat(t(tmat), 32).contiguous(),
            chunklet_ab32=chunklet_aabbs(t(v0), t(e1), t(e2), t(valid), c=32),
            tri_attr16=t(attr16),
            tri_verts16=t(verts16),
        )
    return ScenePack(
        tri_v0=t(v0),
        tri_e1=t(e1),
        tri_e2=t(e2),
        tri_color=t(col),
        tri_sem=t(sem),
        tri_valid=t(valid),
        tri_mat=t(tmat),
        tri_attr=t(tattr),
        chunk_bounds=t(cb),
        nav_occ=t(occ),
        obst_dist=t(odist),
        nav_lo=t(lo),
        floor_y=t(fy),
        **tables,
        nav_res=scenes[0].nav_res,
        scene_ids=tuple(s.scene_id for s in scenes),
    )
