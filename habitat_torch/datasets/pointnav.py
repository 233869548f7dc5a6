"""PointNav procedural episode generator (host, numpy).

Port of ``generate_pointnav_episode`` / ``make_procedural_pointnav`` from
``habitat_tpu/datasets/pointnav.py``: episodes are sampled on the navgrid
with the precomputed geodesic field, under the reference generator's
admissibility constraints (distance band, geodesic/euclidean ratio).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from habitat_torch.core.dataset import NavigationEpisode, NavigationGoal
from habitat_torch.sims.scene import INF_DIST, SceneData, geodesic_field


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
