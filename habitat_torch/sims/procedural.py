"""Procedural scene generation (host, numpy).

The reference ships tiny real scan scenes ("habitat-test-scenes") for tests and
downloads HM3D/MP3D/ReplicaCAD for training (reference DATASETS.md). This image
has no scene data, so the framework ships a procedural apartment generator that
produces watertight triangle-soup scenes with rooms, doorways, and clutter —
used by unit tests, benchmarks, and the built-in episode generator
(counterpart of reference datasets/pointnav/pointnav_generator.py).

Semantic ids: 0=void/sky, 1=floor, 2=wall, 3=ceiling, 4+=object categories.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from habitat_torch.sims.scene import SceneData, rasterize_occupancy

SEM_VOID = 0
SEM_FLOOR = 1
SEM_WALL = 2
SEM_CEILING = 3
SEM_OBJECT_BASE = 4

# procedural object category vocabulary (objectnav goals); category id =
# index into this list (reference maps category strings to task ids via
# dataset.category_to_task_category_id)
OBJECT_CATEGORIES = (
    "chair", "table", "bed", "sofa", "plant", "tv_monitor",
    "cabinet", "counter", "shelf", "fridge",
)

# region category vocabulary (habitat-sim SemanticRegion categories)
REGION_CATEGORIES = (
    "living room", "kitchen", "bedroom", "bathroom",
    "hallway", "office", "dining room", "closet",
)


def _quad(p0, p1, p2, p3) -> np.ndarray:
    """Two triangles for quad p0-p1-p2-p3 (ccw)."""
    return np.array([[p0, p1, p2], [p0, p2, p3]], dtype=np.float32)


def _box(center, size, y0: float, y1: float) -> np.ndarray:
    """Axis-aligned box walls+top between heights y0..y1. center/size are xz."""
    cx, cz = center
    hx, hz = size[0] / 2, size[1] / 2
    x0, x1, z0, z1 = cx - hx, cx + hx, cz - hz, cz + hz
    quads = []
    # four side walls
    quads.append(_quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]))
    quads.append(_quad([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]))
    quads.append(_quad([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]))
    quads.append(_quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]))
    # top
    quads.append(_quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]))
    return np.concatenate(quads, axis=0)


def _wall_with_door(
    x0, z0, x1, z1, height, door_center_t: Optional[float], door_width: float
) -> List[np.ndarray]:
    """Vertical wall from (x0,z0) to (x1,z1); optional door gap at param t."""
    p0 = np.array([x0, z0])
    p1 = np.array([x1, z1])
    length = np.linalg.norm(p1 - p0)
    segs = []
    if door_center_t is None or length < door_width * 1.5:
        segs.append((0.0, 1.0))
    else:
        t0 = max(0.0, door_center_t - door_width / 2 / length)
        t1 = min(1.0, door_center_t + door_width / 2 / length)
        if t0 > 1e-3:
            segs.append((0.0, t0))
        if t1 < 1 - 1e-3:
            segs.append((t1, 1.0))
    out = []
    for a, b in segs:
        pa = p0 + (p1 - p0) * a
        pb = p0 + (p1 - p0) * b
        out.append(
            _quad(
                [pa[0], 0.0, pa[1]],
                [pb[0], 0.0, pb[1]],
                [pb[0], height, pb[1]],
                [pa[0], height, pa[1]],
            )
        )
    return out


def generate_apartment(
    seed: int,
    extent: float = 10.0,
    n_rooms_per_axis: int = 2,
    n_clutter: int = 6,
    wall_height: float = 2.5,
    nav_res: float = 0.1,
    agent_radius: float = 0.1,
    with_ceiling: bool = False,
    scene_id: Optional[str] = None,
) -> SceneData:
    """A square apartment split into a grid of rooms joined by doorways."""
    rng = np.random.default_rng(seed)
    tris: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    sems: List[np.ndarray] = []

    def add(t: np.ndarray, color, sem: int):
        tris.append(t)
        c = np.asarray(color, np.float32)
        cols.append(np.tile(c, (len(t), 1)))
        sems.append(np.full((len(t),), sem, np.int32))

    e = extent
    # floor
    add(
        _quad([0, 0, 0], [e, 0, 0], [e, 0, e], [0, 0, e]),
        rng.uniform(0.35, 0.55, 3),
        SEM_FLOOR,
    )
    if with_ceiling:
        add(
            _quad([0, wall_height, 0], [0, wall_height, e], [e, wall_height, e], [e, wall_height, 0]),
            [0.9, 0.9, 0.9],
            SEM_CEILING,
        )
    wall_col = rng.uniform(0.55, 0.8, 3)
    # outer walls
    for w in (
        _wall_with_door(0, 0, e, 0, wall_height, None, 0)
        + _wall_with_door(e, 0, e, e, wall_height, None, 0)
        + _wall_with_door(e, e, 0, e, wall_height, None, 0)
        + _wall_with_door(0, e, 0, 0, wall_height, None, 0)
    ):
        add(w, wall_col, SEM_WALL)

    # interior room divider walls with doors
    k = n_rooms_per_axis
    door_w = 1.0
    for i in range(1, k):
        x = e * i / k + rng.uniform(-0.5, 0.5)
        # one wall per row segment, each with a door
        for j in range(k):
            z0, z1 = e * j / k, e * (j + 1) / k
            t = rng.uniform(0.25, 0.75)
            for w in _wall_with_door(x, z0, x, z1, wall_height, t, door_w):
                add(w, wall_col, SEM_WALL)
    for j in range(1, k):
        z = e * j / k + rng.uniform(-0.5, 0.5)
        for i in range(k):
            x0, x1 = e * i / k, e * (i + 1) / k
            t = rng.uniform(0.25, 0.75)
            for w in _wall_with_door(x0, z, x1, z, wall_height, t, door_w):
                add(w, wall_col, SEM_WALL)

    # clutter boxes (furniture): random sizes, snapped to floor; each box is
    # an annotated object instance with a category (SemanticScene equivalent,
    # SURVEY §2.9 semantic id tables)
    objects = []
    for n in range(n_clutter):
        size = rng.uniform(0.4, 1.2, 2)
        c = rng.uniform(1.0, e - 1.0, 2)
        h = rng.uniform(0.4, 1.4)
        cat = int(rng.integers(0, len(OBJECT_CATEGORIES)))
        add(
            _box(c, size, 0.0, h),
            rng.uniform(0.2, 0.9, 3),
            SEM_OBJECT_BASE + n,
        )
        objects.append(
            dict(
                semantic_id=SEM_OBJECT_BASE + n,
                category_id=cat,
                category=OBJECT_CATEGORIES[cat],
                center=[float(c[0]), h / 2, float(c[1])],
                size=[float(size[0]), h, float(size[1])],
            )
        )

    # room-grid regions: the region layer of the SemanticScene hierarchy
    # (habitat-sim SemanticScene levels>regions>objects; semantic_scene.py)
    regions = []
    for i in range(k):
        for j in range(k):
            regions.append(
                dict(
                    id=f"room_{i}_{j}",
                    category=REGION_CATEGORIES[(i * k + j) % len(REGION_CATEGORIES)],
                    lo=[e * i / k, 0.0, e * j / k],
                    hi=[e * (i + 1) / k, wall_height, e * (j + 1) / k],
                )
            )

    scene = SceneData(
        scene_id=scene_id or f"procgen/apartment_{seed}",
        vertices=np.concatenate(tris, axis=0),
        colors=np.concatenate(cols, axis=0),
        semantic_ids=np.concatenate(sems, axis=0),
    )
    scene.objects = objects
    scene.regions = regions
    rasterize_occupancy(scene, res=nav_res, agent_radius=agent_radius)
    return scene


def generate_empty_room(
    extent: float = 6.0, nav_res: float = 0.1, scene_id: str = "procgen/empty_room"
) -> SceneData:
    """Single empty square room (floor and four walls 2.5 m high): analytic
    ground truth for renderer and placement tests."""
    tris, cols, sems = [], [], []

    def add(t, color, sem):
        tris.append(t)
        cols.append(np.tile(np.asarray(color, np.float32), (len(t), 1)))
        sems.append(np.full((len(t),), sem, np.int32))

    e, h = extent, 2.5
    add(_quad([0, 0, 0], [e, 0, 0], [e, 0, e], [0, 0, e]), [0.5, 0.5, 0.5], SEM_FLOOR)
    for w in (
        _wall_with_door(0, 0, e, 0, h, None, 0)
        + _wall_with_door(e, 0, e, e, h, None, 0)
        + _wall_with_door(e, e, 0, e, h, None, 0)
        + _wall_with_door(0, e, 0, 0, h, None, 0)
    ):
        add(w, [0.7, 0.7, 0.7], SEM_WALL)
    scene = SceneData(
        scene_id=scene_id,
        vertices=np.concatenate(tris, axis=0),
        colors=np.concatenate(cols, axis=0),
        semantic_ids=np.concatenate(sems, axis=0),
    )
    rasterize_occupancy(scene, res=nav_res)
    return scene


def scanify(
    scene: SceneData,
    tess: float = 0.08,
    noise: float = 0.004,
    color_noise: float = 0.06,
    seed: int = 0,
    max_tris: int = 1_500_000,
) -> SceneData:
    """Turn a clean CAD-style mesh into a scan-like mesh: every triangle is
    subdivided until edges are ~``tess`` meters and vertices get hash-based
    jitter (consistent across shared edges, so the surface stays watertight)
    plus per-face color noise — the triangle-density and surface-roughness
    profile of an HM3D/MP3D reconstruction (millions of small noisy faces)
    rather than a procedural box world."""
    rng = np.random.default_rng(seed)
    v = scene.vertices.astype(np.float64)  # (T,3,3)
    edges = np.stack(
        [
            np.linalg.norm(v[:, 1] - v[:, 0], axis=-1),
            np.linalg.norm(v[:, 2] - v[:, 1], axis=-1),
            np.linalg.norm(v[:, 2] - v[:, 0], axis=-1),
        ],
        axis=1,
    ).max(axis=1)
    lvl = np.clip(np.ceil(edges / tess).astype(np.int64), 1, 64)
    # respect the budget by scaling levels down uniformly if needed
    total = int((lvl**2).sum())
    if total > max_tris:
        lvl = np.maximum((lvl * np.sqrt(max_tris / total)).astype(np.int64), 1)

    out_v, out_c, out_s = [], [], []
    for n in np.unique(lvl):
        sel = lvl == n
        A = v[sel, 0][:, None, :]
        AB = (v[sel, 1] - v[sel, 0])[:, None, :]
        AC = (v[sel, 2] - v[sel, 0])[:, None, :]
        # barycentric grid triangles for level n (upright + inverted)
        ij_up, ij_v1, ij_v2 = [], [], []
        for i in range(n):
            for j in range(n - i):
                ij_up.append((i, j))
                ij_v1.append((i + 1, j))
                ij_v2.append((i, j + 1))
                if i + j < n - 1:
                    ij_up.append((i + 1, j))
                    ij_v1.append((i + 1, j + 1))
                    ij_v2.append((i, j + 1))
        bar = (
            np.asarray([ij_up, ij_v1, ij_v2], np.float64).transpose(1, 0, 2) / n
        )  # (n_sub, 3 verts, 2)
        sub = (
            A[:, None]
            + bar[None, :, :, 0:1] * AB[:, None]
            + bar[None, :, :, 1:2] * AC[:, None]
        )  # (t, n_sub, 3, 3)
        t_cnt = sub.shape[0] * sub.shape[1]
        out_v.append(sub.reshape(t_cnt, 3, 3))
        c = scene.colors[sel]
        out_c.append(np.repeat(c, sub.shape[1], axis=0))
        out_s.append(np.repeat(scene.semantic_ids[sel], sub.shape[1], axis=0))

    V = np.concatenate(out_v)
    C = np.concatenate(out_c).astype(np.float32)
    S = np.concatenate(out_s)

    # watertight jitter: displacement is a hash of the QUANTIZED position, so
    # coincident vertices of adjacent triangles move identically
    q = np.round(V / 1e-3).astype(np.int64)
    h = (
        q[..., 0] * 73856093 ^ q[..., 1] * 19349663 ^ q[..., 2] * 83492791
    ).astype(np.uint64)
    disp = np.stack(
        [
            ((h * np.uint64(2654435761)) % np.uint64(8192)).astype(np.float64),
            ((h * np.uint64(40503)) % np.uint64(8192)).astype(np.float64),
            ((h * np.uint64(1597334677)) % np.uint64(8192)).astype(np.float64),
        ],
        axis=-1,
    )
    V = V + (disp / 4096.0 - 1.0) * noise
    C = np.clip(
        C + rng.normal(0, color_noise, C.shape).astype(np.float32), 0.0, 1.0
    )
    out = SceneData(
        scene_id=scene.scene_id + "_scan",
        vertices=V.astype(np.float32),
        colors=C,
        semantic_ids=S.astype(np.int32),
        objects=scene.objects,
    )
    rasterize_occupancy(out, res=scene.nav_res)
    return out


def generate_scan_apartment(
    seed: int = 0,
    extent: float = 16.0,
    n_rooms_per_axis: int = 3,
    n_clutter: int = 24,
    tess: float = 0.08,
    max_tris: int = 1_500_000,
    scene_id: Optional[str] = None,
) -> SceneData:
    """A multi-room apartment at real-scan triangle density (>=500k tris with
    multi-room occlusion): generate_apartment geometry scanified to ~tess-
    meter faces: the large-scene configuration."""
    base = generate_apartment(
        seed,
        extent=extent,
        n_rooms_per_axis=n_rooms_per_axis,
        n_clutter=n_clutter,
        with_ceiling=True,
        scene_id=scene_id or f"scan_apartment_{seed}",
    )
    return scanify(base, tess=tess, seed=seed, max_tris=max_tris)


def decimate(scene: SceneData, cell: float) -> SceneData:
    """Vertex-clustering mesh decimation (LOD generation for real scans —
    works on any triangle soup): snap vertices to a ``cell`` grid, drop
    degenerate triangles, dedupe coincident ones. Depth error <= cell/2."""
    v = scene.vertices.astype(np.float64)
    q = np.round(v / cell).astype(np.int64)  # (T,3,3) cell coords
    snapped = (q * cell).astype(np.float32)
    # degenerate: any two corners share a cell
    deg = (
        (q[:, 0] == q[:, 1]).all(-1)
        | (q[:, 1] == q[:, 2]).all(-1)
        | (q[:, 0] == q[:, 2]).all(-1)
    )
    keep = ~deg
    qk = q[keep]
    # dedupe by unordered corner set
    corner_keys = (
        qk[..., 0] * 73856093 ^ qk[..., 1] * 19349663 ^ qk[..., 2] * 83492791
    )  # (t,3)
    corner_keys = np.sort(corner_keys, axis=1)
    _, first = np.unique(corner_keys, axis=0, return_index=True)
    sel = np.zeros(keep.sum(), bool)
    sel[first] = True
    idx = np.flatnonzero(keep)[sel]
    return SceneData(
        scene_id=f"{scene.scene_id}_lod{cell}",
        vertices=snapped[idx],
        colors=scene.colors[idx],
        semantic_ids=scene.semantic_ids[idx],
        nav_occ=scene.nav_occ,
        obst_dist=scene.obst_dist,
        nav_lo=scene.nav_lo,
        nav_res=scene.nav_res,
        floor_y=scene.floor_y,
        objects=scene.objects,
    )


def build_lod_scene(
    scene: SceneData,
    cells: Tuple[float, ...] = (0.12, 0.3),
    bands: Tuple[float, ...] = (3.5, 9.0),
    overlap: float = 1.3,
) -> SceneData:
    """Combine a full-resolution scan mesh with decimated LODs into one
    SceneData with per-triangle render-distance bands, the discrete-LOD
    scheme of production renderers: LOD0 (full) renders within bands[0],
    LOD_i within (bands[i-1]/overlap, bands[i]), the last LOD beyond. Bands
    overlap by ``overlap`` so closest-hit never sees a gap at a boundary —
    within the overlap both LODs render and the nearer surface wins (they
    coincide to within cell/2)."""
    lods = [scene] + [decimate(scene, c) for c in cells]
    ranges = []
    for i in range(len(lods)):
        dmin = 0.0 if i == 0 else float(bands[i - 1]) / overlap
        dmax = float(bands[i]) if i < len(bands) else 1e9
        ranges.append((dmin, dmax))
    verts = np.concatenate([s.vertices for s in lods])
    cols = np.concatenate([s.colors for s in lods])
    sems = np.concatenate([s.semantic_ids for s in lods])
    lod_ids = np.concatenate(
        [np.full((s.num_triangles,), i, np.int32) for i, s in enumerate(lods)]
    )
    return SceneData(
        scene_id=f"{scene.scene_id}_lod",
        vertices=verts,
        colors=cols,
        semantic_ids=sems,
        nav_occ=scene.nav_occ,
        obst_dist=scene.obst_dist,
        nav_lo=scene.nav_lo,
        nav_res=scene.nav_res,
        floor_y=scene.floor_y,
        objects=scene.objects,
        tri_lod=lod_ids,
        lod_ranges=ranges,
    )
