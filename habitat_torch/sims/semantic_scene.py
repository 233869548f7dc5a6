"""SemanticScene hierarchy: levels > regions > objects with categories (port
of ``habitat_tpu/sims/semantic_scene.py``, host numpy).

Counterpart of habitat-sim's ``SemanticScene`` (exposed to habitat-lab via
``sim.semantic_annotations()``/``semantic_scene``; used by ObjectNav episode
generation and the semantic sensor id maps — reference
habitat-lab/habitat/sims/habitat_simulator/habitat_simulator.py:249-257
``semantic_annotations``, and ``object_nav_task.py`` goal categories).

The reference reads this from scene .semantic.json / .house files; here the
hierarchy is built from ``SceneData`` annotations (objects + room regions)
— procedural scenes record both, and loaders can attach them from scene
dataset configs. API mirrors habitat-sim: ``scene.levels[i].regions``,
``region.objects``, ``object.category.index()/.name()``, ``.aabb.center``/
``.aabb.sizes``, ids in the "<level>_<region>_<object>" style.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SemanticCategory:
    """habitat-sim SemanticCategory: stable index + name."""

    _index: int
    _name: str

    def index(self) -> int:
        return self._index

    def name(self) -> str:
        return self._name


@dataclasses.dataclass(frozen=True)
class AABB:
    """habitat-sim BBox surface: center + sizes (+ min/max corners)."""

    center: np.ndarray
    sizes: np.ndarray

    @property
    def min(self) -> np.ndarray:
        return self.center - self.sizes / 2

    @property
    def max(self) -> np.ndarray:
        return self.center + self.sizes / 2

    def contains(self, point) -> bool:
        p = np.asarray(point)
        return bool(np.all(p >= self.min - 1e-9) and np.all(p <= self.max + 1e-9))


class SemanticObject:
    def __init__(self, oid: str, semantic_id: int, category: SemanticCategory,
                 aabb: AABB, region: Optional["SemanticRegion"] = None):
        self.id = oid
        self.semantic_id = semantic_id
        self.category = category
        self.aabb = aabb
        self.region = region

    obb = property(lambda self: self.aabb)  # no rotated boxes in the tables


class SemanticRegion:
    def __init__(self, rid: str, category: SemanticCategory, aabb: AABB,
                 level: Optional["SemanticLevel"] = None):
        self.id = rid
        self.category = category
        self.aabb = aabb
        self.level = level
        self.objects: List[SemanticObject] = []


class SemanticLevel:
    def __init__(self, lid: str, aabb: AABB):
        self.id = lid
        self.aabb = aabb
        self.regions: List[SemanticRegion] = []

    @property
    def objects(self) -> List[SemanticObject]:
        return [o for r in self.regions for o in r.objects]


class SemanticScene:
    """Top container (habitat-sim SemanticScene): levels/regions/objects
    plus the semantic-id -> object index map used by the semantic sensor."""

    def __init__(self):
        self.levels: List[SemanticLevel] = []
        self.regions: List[SemanticRegion] = []
        self.objects: List[SemanticObject] = []
        self.categories: List[SemanticCategory] = []
        self.semantic_index_map: Dict[int, int] = {}  # semantic_id -> obj idx

    def get_object(self, semantic_id: int) -> Optional[SemanticObject]:
        i = self.semantic_index_map.get(int(semantic_id))
        return self.objects[i] if i is not None else None

    def get_regions_for_point(self, point) -> List[SemanticRegion]:
        """Regions containing a world point (reference
        get_regions_for_point on the sim; used by object_in_region)."""
        return [r for r in self.regions if r.aabb.contains(point)]


def build_semantic_scene(scene) -> SemanticScene:
    """SceneData (objects/regions annotations) -> SemanticScene hierarchy.

    Regions default to one whole-scene region when the scene has no region
    annotations; objects attach to the region containing their center (first
    match), mirroring how .house files nest the hierarchy."""
    out = SemanticScene()
    cat_index: Dict[str, SemanticCategory] = {}

    def category(name: str) -> SemanticCategory:
        if name not in cat_index:
            cat_index[name] = SemanticCategory(len(cat_index), name)
            out.categories.append(cat_index[name])
        return cat_index[name]

    # single level spanning the scene (procedural scenes are one-story; a
    # multi-level loader can emit several by y-banding its regions)
    objs = scene.objects or []
    regions = scene.regions or []
    all_pts = [np.asarray(o["center"], np.float64) for o in objs] or [np.zeros(3)]
    lo = np.min(np.stack(all_pts), axis=0) - 1.0
    hi = np.max(np.stack(all_pts), axis=0) + 1.0
    for r in regions:
        lo = np.minimum(lo, np.asarray(r["lo"], np.float64))
        hi = np.maximum(hi, np.asarray(r["hi"], np.float64))
    level = SemanticLevel("0", AABB((lo + hi) / 2, hi - lo))
    out.levels.append(level)

    if regions:
        for ri, r in enumerate(regions):
            rlo = np.asarray(r["lo"], np.float64)
            rhi = np.asarray(r["hi"], np.float64)
            reg = SemanticRegion(
                f"0_{ri}",
                category(r.get("category", "unknown")),
                AABB((rlo + rhi) / 2, rhi - rlo),
                level=level,
            )
            out.regions.append(reg)
            level.regions.append(reg)
    else:
        reg = SemanticRegion("0_0", category("scene"), level.aabb, level=level)
        out.regions.append(reg)
        level.regions.append(reg)

    for o in objs:
        center = np.asarray(o["center"], np.float64)
        region = next(
            (r for r in out.regions if r.aabb.contains(center)), out.regions[0]
        )
        obj = SemanticObject(
            f"{region.id}_{len(region.objects)}",
            int(o["semantic_id"]),
            category(o.get("category", "unknown")),
            AABB(center, np.asarray(o["size"], np.float64)),
            region=region,
        )
        region.objects.append(obj)
        out.semantic_index_map[obj.semantic_id] = len(out.objects)
        out.objects.append(obj)
    return out
