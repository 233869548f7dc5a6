"""ObjectNav dataset: the reference-format loader and the procedural
generator (port of ``habitat_tpu/datasets/object_nav.py``).

- ``ObjectNavDatasetV1`` (registered "ObjectNav-v1") reads the reference's
  schema (habitat-lab/habitat/datasets/object_nav/object_nav_dataset.py:
  goals_by_category, category_to_task_category_id, ObjectGoal view_points).
- ``make_procedural_objectnav`` samples goal categories from the procedural
  scenes' annotated objects; an episode's goal set is every navigable cell
  within ``view_radius`` of any instance of the category (the VIEW_POINTS
  distance semantics), baked into its geodesic field. The draws from
  ``rng`` follow the JAX generator's order, those of tries that return
  nothing included, so both packages list the same episodes.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from habitat_torch.core.dataset import Dataset, Episode, NavigationGoal
from habitat_torch.core.registry import registry
from habitat_torch.datasets.pointnav import _yaw_to_quat_coeffs
from habitat_torch.sims.scene import INF_DIST, SceneData, geodesic_field


@dataclasses.dataclass
class ObjectGoal(NavigationGoal):
    object_id: str = ""
    object_name: Optional[str] = None
    object_category: Optional[str] = None
    view_points: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ObjectGoalNavEpisode(Episode):
    object_category: Optional[str] = None
    goals: list = dataclasses.field(default_factory=list)

    @property
    def goals_key(self) -> str:
        return f"{os.path.basename(self.scene_id)}_{self.object_category}"


@registry.register_dataset(name="ObjectNav-v1")
class ObjectNavDatasetV1(Dataset):
    """Episodes of a reference ObjectNav JSON(.gz) file (``config.data_path``
    with ``{split}`` filled from ``config.split``), or of ``from_json``."""

    def __init__(self, config=None) -> None:
        super().__init__()
        self.category_to_task_category_id: Dict[str, int] = {}
        self.goals_by_category: Dict[str, list] = {}
        if config is None:
            return
        data_path = config.data_path.format(split=config.split)
        opener = gzip.open if data_path.endswith(".gz") else open
        with opener(data_path, "rt") as f:
            self.from_json(f.read())

    def from_json(self, json_str: str, scenes_dir: Optional[str] = None) -> None:
        data = json.loads(json_str)
        self.category_to_task_category_id = data.get("category_to_task_category_id", {})
        self.goals_by_category = {
            key: [
                ObjectGoal(
                    position=list(g.get("position", [])),
                    radius=g.get("radius"),
                    object_id=str(g.get("object_id", "")),
                    object_category=g.get("object_category"),
                    view_points=g.get("view_points", []),
                )
                for g in goals
            ]
            for key, goals in data.get("goals_by_category", {}).items()
        }
        for ep in data.get("episodes", []):
            episode = ObjectGoalNavEpisode(
                episode_id=str(ep["episode_id"]),
                scene_id=ep["scene_id"],
                start_position=list(ep["start_position"]),
                start_rotation=list(ep["start_rotation"]),
                info=ep.get("info", {}),
                object_category=ep.get("object_category"),
            )
            episode.info.setdefault(
                "object_category_id", self.category_to_task_category_id.get(episode.object_category, -1)
            )
            episode.goals = self.goals_by_category.get(episode.goals_key, [])
            self.episodes.append(episode)


def generate_objectnav_episode(
    scene: SceneData,
    episode_id: str,
    rng: np.random.Generator,
    *,
    view_radius: float = 1.0,
    closest_dist_limit: float = 1.0,
    furthest_dist_limit: float = 30.0,
    max_tries: int = 10,
) -> Optional[Tuple[ObjectGoalNavEpisode, np.ndarray]]:
    """One episode toward a category of ``scene``'s annotated objects (+ its
    goal distance field), or None after ``max_tries`` tries."""
    assert scene.objects, "scene has no annotated objects"
    occ = scene.nav_occ
    ii, kk = np.nonzero(occ)
    cells_xz = np.stack([ii, kk], -1) * scene.nav_res + scene.nav_lo
    for _ in range(max_tries):
        obj = scene.objects[rng.integers(len(scene.objects))]
        cat_id = obj["category_id"]
        instances = [o for o in scene.objects if o["category_id"] == cat_id]
        # goal cells: navigable cells within view_radius of any instance
        good = np.zeros(len(ii), bool)
        for inst in instances:
            c = np.asarray(inst["center"])[[0, 2]]
            r = max(np.asarray(inst["size"])[[0, 2]]) / 2 + view_radius
            good |= np.linalg.norm(cells_xz - c, axis=-1) <= r
        if not good.any():
            continue
        field = geodesic_field(occ, np.stack([ii[good], kk[good]], -1), scene.nav_res)
        dist = np.where(occ, field, INF_DIST)
        si, sk = np.nonzero((dist > closest_dist_limit) & (dist < furthest_dist_limit) & occ)
        if len(si) == 0:
            continue
        j = rng.integers(len(si))
        start_xz = scene.cell_to_world(np.array([si[j], sk[j]]))
        yaw = float(rng.uniform(-np.pi, np.pi))
        ep = ObjectGoalNavEpisode(
            episode_id=episode_id,
            scene_id=scene.scene_id,
            start_position=[float(start_xz[0]), scene.floor_y, float(start_xz[1])],
            start_rotation=_yaw_to_quat_coeffs(yaw),
            info={"geodesic_distance": float(dist[si[j], sk[j]]), "object_category_id": int(cat_id)},
            object_category=obj["category"],
            goals=[
                ObjectGoal(
                    position=[float(i["center"][0]), scene.floor_y, float(i["center"][2])],
                    radius=view_radius,
                    object_category=obj["category"],
                )
                for i in instances
            ],
        )
        return ep, field
    return None


def make_procedural_objectnav(
    num_scenes: int = 2,
    episodes_per_scene: int = 8,
    seed: int = 0,
    extent: float = 10.0,
    nav_res: float = 0.1,
    **episode_kw,
):
    """(scenes, episodes, {episode_id: goal field}): apartments with 8
    annotated clutter objects each, episodes "on_{scene}_{i}"."""
    from habitat_torch.sims.procedural import generate_apartment

    rng = np.random.default_rng(seed)
    scenes, episodes, fields = [], [], {}
    for s in range(num_scenes):
        scene = generate_apartment(seed=seed * 1000 + s, extent=extent, nav_res=nav_res, n_clutter=8)
        scenes.append(scene)
        for e in range(episodes_per_scene):
            out = generate_objectnav_episode(scene, episode_id=f"on_{s}_{e}", rng=rng, **episode_kw)
            if out is None:
                continue
            ep, field = out
            episodes.append(ep)
            fields[ep.episode_id] = field
    return scenes, episodes, fields
