"""PointNav dataset: the reference-format loader and the procedural episode
generator (host, numpy; port of ``habitat_tpu/datasets/pointnav.py``).

- ``PointNavDatasetV1`` (registered "PointNav-v1") reads the reference's
  episode JSON(.gz) schema (habitat-lab/habitat/datasets/pointnav/
  pointnav_dataset.py: ``{data_path}`` and its ``content/{scene}.json.gz``
  shards; episodes with start_position, start_rotation quaternion [x, y, z,
  w], goals, info.geodesic_distance) and writes it back with ``to_json``.
- ``generate_pointnav_episode`` / ``make_procedural_pointnav`` sample
  episodes on the navgrid with the precomputed geodesic field, under the
  reference generator's admissibility constraints (distance band,
  geodesic/euclidean ratio).
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from habitat_torch.core.dataset import ALL_SCENES_MASK, Dataset, NavigationEpisode, NavigationGoal
from habitat_torch.core.registry import registry
from habitat_torch.sims.scene import INF_DIST, SceneData, geodesic_field


@registry.register_dataset(name="PointNav-v1")
class PointNavDatasetV1(Dataset):
    """Episodes of ``config.data_path`` (``{split}`` filled from
    ``config.split``) and of the ``content/`` shards beside it that
    ``config.content_scenes`` names (all by default), or of ``from_json``."""

    def __init__(self, config=None) -> None:
        super().__init__()
        if config is None:
            return
        data_path = config.data_path.format(split=config.split)
        self._load_file(data_path)
        content_dir = os.path.join(os.path.dirname(data_path), "content")
        if os.path.isdir(content_dir):
            wanted = getattr(config, "content_scenes", [ALL_SCENES_MASK])
            for fn in sorted(os.listdir(content_dir)):
                if not fn.endswith(".json.gz"):
                    continue
                scene = fn[: -len(".json.gz")]
                if ALL_SCENES_MASK in wanted or scene in wanted:
                    self._load_file(os.path.join(content_dir, fn))

    def _load_file(self, fname: str) -> None:
        opener = gzip.open if fname.endswith(".gz") else open
        with opener(fname, "rt") as f:
            self.from_json(f.read())

    def from_json(self, json_str: str, scenes_dir: Optional[str] = None) -> None:
        for ep in json.loads(json_str).get("episodes", []):
            self.episodes.append(
                NavigationEpisode(
                    episode_id=str(ep["episode_id"]),
                    scene_id=ep["scene_id"],
                    start_position=list(ep["start_position"]),
                    start_rotation=list(ep["start_rotation"]),
                    info=ep.get("info", {}),
                    goals=[NavigationGoal(position=list(g["position"]), radius=g.get("radius"))
                           for g in ep.get("goals", [])],
                )
            )

    def to_json(self) -> str:
        return json.dumps({"episodes": [
            {
                "episode_id": e.episode_id,
                "scene_id": e.scene_id,
                "start_position": list(map(float, e.start_position)),
                "start_rotation": list(map(float, e.start_rotation)),
                "info": e.info,
                "goals": [{"position": list(map(float, g.position)), "radius": g.radius} for g in e.goals],
            }
            for e in self.episodes
        ]})


def _yaw_to_quat_coeffs(yaw: float) -> List[float]:
    """[x,y,z,w] for a rotation of yaw about +y."""
    return [0.0, float(np.sin(yaw / 2)), 0.0, float(np.cos(yaw / 2))]


def generate_pointnav_episode(
    scene: SceneData,
    episode_id: str,
    rng: np.random.Generator,
    *,
    closest_dist_limit: float = 1.0,
    furthest_dist_limit: float = 30.0,
    geodesic_to_euclid_ratio: float = 1.1,
    max_tries: int = 20,
) -> Optional[Tuple[NavigationEpisode, np.ndarray]]:
    """Sample one episode (+ its goal distance field, reused by the table)."""
    occ = scene.nav_occ
    nav_cells = np.argwhere(occ)
    for _ in range(max_tries):
        goal_cell = nav_cells[rng.integers(len(nav_cells))]
        field = geodesic_field(occ, goal_cell[None], scene.nav_res)
        dist = field.copy()
        dist[~occ] = INF_DIST
        # candidate starts meeting the distance band
        ii, kk = np.nonzero(
            (dist > closest_dist_limit) & (dist < furthest_dist_limit) & occ
        )
        if len(ii) == 0:
            continue
        goal_xz = scene.cell_to_world(goal_cell)
        euclid = (
            np.sqrt(
                (ii - goal_cell[0]).astype(np.float64) ** 2
                + (kk - goal_cell[1]).astype(np.float64) ** 2
            )
            * scene.nav_res
        )
        ratio = dist[ii, kk] / np.maximum(euclid, 1e-6)
        ok = ratio > geodesic_to_euclid_ratio
        if not np.any(ok):
            # straight-line fallback: accept any start in the band
            ok = np.ones_like(ratio, bool)
        cand = rng.integers(ok.sum())
        si, sk = ii[ok][cand], kk[ok][cand]
        start_xz = scene.cell_to_world(np.array([si, sk]))
        yaw = float(rng.uniform(-np.pi, np.pi))
        ep = NavigationEpisode(
            episode_id=episode_id,
            scene_id=scene.scene_id,
            start_position=[float(start_xz[0]), scene.floor_y, float(start_xz[1])],
            start_rotation=_yaw_to_quat_coeffs(yaw),
            info={"geodesic_distance": float(dist[si, sk])},
            goals=[
                NavigationGoal(
                    position=[float(goal_xz[0]), scene.floor_y, float(goal_xz[1])],
                    radius=0.2,
                )
            ],
        )
        return ep, field
    return None


def make_procedural_pointnav(
    num_scenes: int = 2,
    episodes_per_scene: int = 8,
    seed: int = 0,
    extent: float = 10.0,
    nav_res: float = 0.1,
    episode_seed: Optional[int] = None,
    scene_kw: Optional[dict] = None,
    **episode_kw,
) -> Tuple[List[SceneData], List[NavigationEpisode], Dict[str, np.ndarray]]:
    """Procedural scenes + episodes (+ per-episode fields keyed by
    episode_id). episode_seed decouples the episode stream from the scene
    set (same scenes, held-out start/goal pairs)."""
    from habitat_torch.sims.procedural import generate_apartment

    rng = np.random.default_rng(seed if episode_seed is None else episode_seed)
    scenes: List[SceneData] = []
    episodes: List[NavigationEpisode] = []
    fields: Dict[str, np.ndarray] = {}
    for s in range(num_scenes):
        scene = generate_apartment(
            seed=seed * 1000 + s, extent=extent, nav_res=nav_res,
            **(scene_kw or {}),
        )
        scenes.append(scene)
        for e in range(episodes_per_scene):
            out = generate_pointnav_episode(
                scene, episode_id=f"{s}_{e}", rng=rng, **episode_kw
            )
            if out is None:
                continue
            ep, field = out
            episodes.append(ep)
            fields[ep.episode_id] = field
    return scenes, episodes, fields
