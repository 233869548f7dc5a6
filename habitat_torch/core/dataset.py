"""Episodes and the device episode table.

Port of the parts of ``habitat_tpu/core/dataset.py`` the PointNav rollout
uses: the episode dataclasses, ``EpisodeTable`` (all episodes packed as
tensors, indexed by episode id on the device) built by
``build_episode_table`` (with ImageNav's goal views rendered once, at table
build, when ``goal_image_size`` is given), and the per-env episode schedule
``build_env_episode_order``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class BaseEpisode:
    episode_id: str
    scene_id: str


@dataclasses.dataclass
class Episode(BaseEpisode):
    """An episode spec: scene + initial agent state (+ task extras).
    start_rotation is quaternion coeffs [x, y, z, w]."""

    start_position: List[float] = dataclasses.field(default_factory=list)
    start_rotation: List[float] = dataclasses.field(default_factory=lambda: [0, 0, 0, 1])
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def start_yaw(self) -> float:
        """Heading angle about +y recovered from the (pure-y) quaternion."""
        x, y, z, w = self.start_rotation
        return float(2.0 * np.arctan2(y, w))


@dataclasses.dataclass
class NavigationGoal:
    position: List[float] = dataclasses.field(default_factory=list)
    radius: Optional[float] = None


@dataclasses.dataclass
class NavigationEpisode(Episode):
    goals: List[NavigationGoal] = dataclasses.field(default_factory=list)
    start_room: Optional[str] = None
    shortest_paths: Optional[List[Any]] = None


MAX_GOALS_DEFAULT = 1


@dataclasses.dataclass
class EpisodeTable:
    """All episodes packed as tensors; indexed by episode id.

    ``dist_field`` holds the per-episode geodesic distance-to-goal field
    (min over goals, precomputed on the navgrid) in float16."""

    scene_idx: torch.Tensor  # (E,) int32 index into ScenePack
    start_pos: torch.Tensor  # (E,3) f32
    start_yaw: torch.Tensor  # (E,) f32
    goal_pos: torch.Tensor  # (E,G,3) f32
    goal_valid: torch.Tensor  # (E,G) bool
    geodesic_start: torch.Tensor  # (E,) f32 — start-to-goal geodesic (SPL denom)
    dist_field: torch.Tensor  # (E,NX,NZ) f16 — geodesic distance-to-goal
    object_category: torch.Tensor  # (E,) int32 — objectnav goal category (-1: n/a)
    goal_image: torch.Tensor  # (E,Hg,Wg,3) u8 — imagegoal renders ((E,1,1,3) if unused)
    # task-specific per-episode tensors (e.g. "instance_hfov"); sensors
    # index extras[key][ep_idx]
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_episodes(self) -> int:
        return int(self.scene_idx.shape[0])

    def to(self, device) -> "EpisodeTable":
        moved = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self) if f.name != "extras"}
        return dataclasses.replace(self, extras={k: v.to(device) for k, v in self.extras.items()}, **moved)


def build_episode_table(
    episodes: Sequence[NavigationEpisode],
    scenes: Dict[str, Any],  # scene_id -> SceneData
    scene_index: Dict[str, int],
    grid_shape: Optional[tuple] = None,
    max_goals: int = MAX_GOALS_DEFAULT,
    precomputed_fields: Optional[Dict[str, np.ndarray]] = None,
    goal_image_size: Optional[int] = None,
    device=None,
) -> EpisodeTable:
    """Pack episodes + per-episode geodesic fields (host, CPU tensors).

    precomputed_fields: optional episode_id -> field map (e.g. from the
    procedural generator, which already ran the geodesic solve).
    goal_image_size: render each episode's goal view at that square size
    on ``device`` (``None`` = cuda; only read when rendering) into
    ``goal_image``; without it ``goal_image`` is (E, 1, 1, 3) zeros.
    """
    from habitat_torch.sims.scene import geodesic_field

    E = len(episodes)
    if grid_shape is None:
        nx = max(scenes[sid].nav_occ.shape[0] for sid in scene_index)
        nz = max(scenes[sid].nav_occ.shape[1] for sid in scene_index)
        grid_shape = (nx, nz)
    nx, nz = grid_shape

    scene_idx = np.zeros((E,), np.int32)
    start_pos = np.zeros((E, 3), np.float32)
    start_yaw = np.zeros((E,), np.float32)
    goal_pos = np.zeros((E, max_goals, 3), np.float32)
    goal_valid = np.zeros((E, max_goals), bool)
    geo_start = np.zeros((E,), np.float32)
    fields = np.zeros((E, nx, nz), np.float32)
    obj_cat = np.full((E,), -1, np.int32)

    for i, ep in enumerate(episodes):
        scene = scenes[ep.scene_id]
        scene_idx[i] = scene_index[ep.scene_id]
        start_pos[i] = np.asarray(ep.start_position, np.float32)
        start_yaw[i] = ep.start_yaw
        cells = []
        for g, goal in enumerate(ep.goals[:max_goals]):
            goal_pos[i, g] = np.asarray(goal.position, np.float32)
            goal_valid[i, g] = True
            cells.append(scene.world_to_cell(np.asarray(goal.position)[[0, 2]]))
        if precomputed_fields is not None and ep.episode_id in precomputed_fields:
            f = precomputed_fields[ep.episode_id]
        else:
            f = geodesic_field(scene.nav_occ, np.asarray(cells), scene.nav_res)
        gx, gz = f.shape
        fields[i, :gx, :gz] = f
        fields[i, gx:, :] = 1e6
        fields[i, :, gz:] = 1e6
        # keep within float16 range (6e4 ~ "unreachable" at scene scale)
        np.minimum(fields[i], 6.0e4, out=fields[i])
        sc = scene.world_to_cell(start_pos[i][[0, 2]])
        geo = ep.info.get("geodesic_distance")
        geo_start[i] = geo if geo is not None else f[sc[0], sc[1]]
        cat = ep.info.get("object_category_id")
        if cat is not None:
            obj_cat[i] = cat

    if goal_image_size:
        goal_imgs = _render_goal_images(episodes, scenes, scene_index, goal_image_size, device).cpu()
    else:
        goal_imgs = torch.zeros((E, 1, 1, 3), dtype=torch.uint8)

    t = torch.from_numpy
    return EpisodeTable(
        scene_idx=t(scene_idx),
        start_pos=t(start_pos),
        start_yaw=t(start_yaw),
        goal_pos=t(goal_pos),
        goal_valid=t(goal_valid),
        geodesic_start=t(geo_start),
        dist_field=t(fields).to(torch.float16),
        object_category=t(obj_cat),
        goal_image=goal_imgs,
    )


def goal_view(episode) -> tuple:
    """(camera position (3,) float32, yaw) of an episode's goal view: an
    InstanceImageNav episode's stored camera (position and the yaw of its
    rotation quaternion); otherwise the goal point + 1.25 m at a heading
    drawn from ``RandomState(abs(hash(episode_id)) % 2**31)``, the
    reference ImageGoalSensor's rule. Python salts ``hash`` of a ``str``
    per process, so these headings repeat within a process and only across
    processes that share ``PYTHONHASHSEED``."""
    g = episode.goals[0] if episode.goals else None
    img_goals = getattr(g, "image_goals", None)
    if img_goals:
        p = img_goals[int(getattr(episode, "goal_image_id", 0)) % len(img_goals)]
        x, y, z, w = p.rotation
        yaw = float(np.arctan2(2 * (w * y + x * z), 1 - 2 * (y * y + x * x)))
        return np.asarray(p.position, np.float32), yaw
    gp = np.asarray(g.position, np.float32)
    yaw = np.random.RandomState(abs(hash(episode.episode_id)) % (2**31)).uniform(0, 2 * np.pi)
    return gp + np.array([0.0, 1.25, 0.0], np.float32), float(yaw)


def _render_goal_images(episodes, scenes, scene_index, size: int, device=None) -> torch.Tensor:
    """(E, size, size, 3) uint8 goal views, rendered once through
    ``render_batch`` at pitch 0 on ``device`` (``None`` = cuda; on the card
    the pinhole route's kernel)."""
    from habitat_torch.device import resolve_device
    from habitat_torch.ops.raycast import render_batch
    from habitat_torch.sims.scene import pack_scenes

    dev = resolve_device(device)
    scene_list = sorted(scene_index, key=lambda k: scene_index[k])
    pack = pack_scenes([scenes[sid] for sid in scene_list]).to(dev)
    views = [goal_view(e) for e in episodes]
    sids = torch.tensor([scene_index[e.scene_id] for e in episodes], dtype=torch.int32, device=dev)
    cam = torch.from_numpy(np.stack([v[0] for v in views])).to(dev)
    yaws = torch.tensor([v[1] for v in views], dtype=torch.float32, device=dev)
    pitch = torch.zeros(len(episodes), device=dev)
    return render_batch(pack, sids, cam, yaws, pitch, height=size, width=size)["rgb"]


def build_env_episode_order(
    episodes: Sequence[Episode],
    num_envs: int,
    *,
    group_by_scene: bool = True,
    shuffle: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """(num_envs, L) int32 episode-index schedule: scenes round-robin over
    envs when there are at least as many scenes as envs, else every env
    cycles all episodes; each env's list shuffled once.

    Env i plays order[i, k % L] as its k-th episode.
    """
    rng = np.random.default_rng(seed)
    by_scene: Dict[str, List[int]] = {}
    for idx, e in enumerate(episodes):
        by_scene.setdefault(e.scene_id, []).append(idx)
    scene_list = sorted(by_scene)

    env_eps: List[List[int]] = [[] for _ in range(num_envs)]
    if group_by_scene and len(scene_list) >= num_envs:
        for j, sid in enumerate(scene_list):
            env_eps[j % num_envs].extend(by_scene[sid])
    else:
        for i in range(num_envs):
            env_eps[i] = list(range(len(episodes)))

    L = max(len(x) for x in env_eps)
    order = np.zeros((num_envs, L), np.int32)
    for i, eps in enumerate(env_eps):
        eps = np.asarray(eps, np.int32)
        if shuffle:
            eps = rng.permutation(eps)
        reps = int(np.ceil(L / len(eps)))
        order[i] = np.tile(eps, reps)[:L]
    return order
