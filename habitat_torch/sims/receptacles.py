"""Receptacles: surfaces that objects are placed on or in, with samplers
(port of ``habitat_tpu/sims/receptacles.py``; reference habitat-lab/habitat/
datasets/rearrange/samplers/receptacle.py: Receptacle :30, AABBReceptacle
:219, TriangleMeshReceptacle :334 with area-weighted triangle sampling,
find_receptacles, ReceptacleSet and ReceptacleTracker).

The reference parses receptacle metadata out of habitat-sim scene and object
configs; here receptacles come from a SceneData's object annotations
(procedural scenes annotate every clutter box) or are built from AABBs or
triangle sets. Sampling is host numpy with the JAX package's RNG calls in
its order, so one seed gives the same placements in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# categories whose top surface accepts placed objects (the procedural vocabulary)
RECEPTACLE_CATEGORIES = ("table", "counter", "shelf", "cabinet", "bed", "sofa")


class Receptacle:
    """A named placement surface attached to a parent object (reference
    receptacle.py:30)."""

    def __init__(self, name: str, parent_object_handle: Optional[str] = None, up=(0, 1, 0)):
        self.name = name
        self.parent_object_handle = parent_object_handle
        self.up = np.asarray(up, np.float32)

    @property
    def bounds(self):  # (lo, hi) world AABB
        raise NotImplementedError

    def sample_uniform_local(self, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def sample_uniform_global(self, rng: np.random.Generator) -> np.ndarray:
        """A world-space sample (receptacles are stored in world space)."""
        return self.sample_uniform_local(rng)


class AABBReceptacle(Receptacle):
    """Axis-aligned box receptacle; samples on its top face (reference
    receptacle.py:219)."""

    def __init__(self, name: str, lo, hi, parent_object_handle=None):
        super().__init__(name, parent_object_handle)
        self.lo = np.asarray(lo, np.float32)
        self.hi = np.asarray(hi, np.float32)

    @property
    def bounds(self):
        return self.lo, self.hi

    @property
    def total_area(self) -> float:
        d = self.hi - self.lo
        return float(d[0] * d[2])

    def sample_uniform_local(self, rng: np.random.Generator) -> np.ndarray:
        x = rng.uniform(self.lo[0], self.hi[0])
        z = rng.uniform(self.lo[2], self.hi[2])
        return np.array([x, self.hi[1], z], np.float32)


class TriangleMeshReceptacle(Receptacle):
    """Triangle-soup receptacle with area-weighted uniform sampling
    (reference receptacle.py:334-470: cumulative-area CDF + barycentric)."""

    def __init__(self, name: str, triangles: np.ndarray, parent_object_handle=None):
        super().__init__(name, parent_object_handle)
        self.triangles = np.asarray(triangles, np.float32)  # (T, 3, 3)
        e1 = self.triangles[:, 1] - self.triangles[:, 0]
        e2 = self.triangles[:, 2] - self.triangles[:, 0]
        self.areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        total = self.areas.sum()
        if not total > 0:
            raise ValueError(f"receptacle {name!r}: degenerate mesh")
        self._cdf = np.cumsum(self.areas) / total

    @property
    def total_area(self) -> float:
        return float(self.areas.sum())

    @property
    def bounds(self):
        flat = self.triangles.reshape(-1, 3)
        return flat.min(0), flat.max(0)

    def sample_uniform_local(self, rng: np.random.Generator) -> np.ndarray:
        t = min(int(np.searchsorted(self._cdf, rng.uniform())), len(self.triangles) - 1)
        # uniform barycentric (the square-root trick)
        r1, r2 = rng.uniform(), rng.uniform()
        s = np.sqrt(r1)
        a, b, c = self.triangles[t]
        return (1 - s) * a + s * (1 - r2) * b + s * r2 * c


def find_receptacles(scene) -> List[Receptacle]:
    """The receptacles of a SceneData's annotated objects: one top-face
    AABBReceptacle per object of a receptacle category, its footprint shrunk
    by 5 cm a side (none where that leaves nothing)."""
    out: List[Receptacle] = []
    for obj in getattr(scene, "objects", None) or ():
        if obj.get("category") not in RECEPTACLE_CATEGORIES:
            continue
        c = np.asarray(obj["center"], np.float32)
        s = np.asarray(obj["size"], np.float32)
        lo, hi = c - s / 2, c + s / 2
        m = 0.05
        lo[[0, 2]] += m
        hi[[0, 2]] -= m
        if (hi[[0, 2]] <= lo[[0, 2]]).any():
            continue
        out.append(AABBReceptacle(name=f"receptacle_aabb_{obj['category']}_{obj['semantic_id']}", lo=lo, hi=hi,
                                  parent_object_handle=str(obj["semantic_id"])))
    return out


@dataclasses.dataclass
class ReceptacleSet:
    """Named inclusion/exclusion filter over receptacle names (reference
    ReceptacleSet)."""

    name: str = "all"
    included_object_substrings: Sequence[str] = ("",)
    excluded_object_substrings: Sequence[str] = ()

    def filter(self, receptacles: Sequence[Receptacle]) -> List[Receptacle]:
        return [r for r in receptacles
                if not any(s in r.name for s in self.excluded_object_substrings)
                and any(s in r.name for s in self.included_object_substrings)]


class ReceptacleTracker:
    """Per-episode receptacle capacity (reference ReceptacleTracker): a
    receptacle with a limit is consumed as it is filled; one without is
    unlimited."""

    def __init__(self, max_objects_per_receptacle: Dict[str, int], recep_sets: Dict[str, ReceptacleSet]):
        self._remaining = dict(max_objects_per_receptacle)
        self.recep_sets = dict(recep_sets)

    def allocate(self, recep_name: str) -> bool:
        left = self._remaining.get(recep_name)
        if left is None:
            return True
        if left <= 0:
            return False
        self._remaining[recep_name] = left - 1
        return True


def sample_on_receptacle(scene, rng: np.random.Generator, recep_set: Optional[ReceptacleSet] = None,
                         clearance: float = 0.05) -> Optional[np.ndarray]:
    """An area-weighted receptacle, then a uniform point on its surface,
    raised by ``clearance`` (reference object_sampler.py's sample() inner
    loop); None when the scene has no receptacle."""
    receps = find_receptacles(scene)
    if recep_set is not None:
        receps = recep_set.filter(receps)
    if not receps:
        return None
    areas = np.array([r.total_area for r in receps])
    idx = int(rng.choice(len(receps), p=areas / areas.sum()))
    p = receps[idx].sample_uniform_global(rng)
    return p + np.array([0, clearance, 0], np.float32)
