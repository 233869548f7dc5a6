"""Rearrangement episode generation and packing (port of
``habitat_tpu/tasks/rearrange/generator.py``).

Counterpart of the reference RearrangeEpisodeGenerator (datasets/rearrange/
rearrange_generator.py:53: scene, object and target samplers, stability
settling :938) and of the RearrangeDataset episode schema (rigid_objs and
targets). Host numpy throughout, with the same RNG calls in the same order
as the JAX package, so the same seed gives the same episodes and tables;
``build_rearrange_table`` returns CPU tensors and ``make_rearrange_env``
moves them to the env's device.

Goals may lie on receptacles (``use_receptacles``, sims/receptacles.py),
episodes may carry sampled articulated-object states (``ao_state_sampler``,
tasks/rearrange/samplers.py), and the articulated object may come from a
URDF (``art_urdf`` / ``art_asset``, sims/loaders.py). ``RearrangeDatasetV0``
reads RearrangeDataset-v0 episode files.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from habitat_torch.core.dataset import (
    Dataset,
    Episode,
    NavigationEpisode,
    NavigationGoal,
    build_env_episode_order,
    build_episode_table,
)
from habitat_torch.core.registry import registry
from habitat_torch.datasets.pointnav import _yaw_to_quat_coeffs
from habitat_torch.device import resolve_device
from habitat_torch.sims.loaders import load_articulated_object
from habitat_torch.sims.procedural import generate_apartment
from habitat_torch.sims.receptacles import sample_on_receptacle
from habitat_torch.sims.scene import SceneData, pack_scenes
from habitat_torch.tasks.rearrange.rearrange_env import RearrangeBatchedEnv, RearrangeTable, contact_step
from habitat_torch.tasks.rearrange.samplers import ArtObjSpec


@dataclasses.dataclass
class RearrangeEpisode(Episode):
    """Rigid object inits and target positions (reference RearrangeEpisode,
    datasets/rearrange/rearrange_dataset.py; positions stand in for its 4x4
    transforms)."""

    rigid_objs: list = dataclasses.field(default_factory=list)  # [(name, pos)]
    targets: dict = dataclasses.field(default_factory=dict)  # name -> goal pos
    markers: list = dataclasses.field(default_factory=list)
    ao_states: dict = dataclasses.field(default_factory=dict)
    target_receptacles: list = dataclasses.field(default_factory=list)
    goal_receptacles: list = dataclasses.field(default_factory=list)


def _position(T) -> List[float]:
    """A 4x4 transform's translation, or a 3-vector as it is."""
    T = np.asarray(T)
    return [float(x) for x in (T[:3, 3] if T.ndim == 2 else T[:3])]


@registry.register_dataset(name="RearrangeDataset-v0")
class RearrangeDatasetV0(Dataset):
    """RearrangeDataset-v0 episode files (reference
    datasets/rearrange/rearrange_dataset.py): rigid objects and targets as
    4x4 transforms or positions, markers and articulated-object states.
    ``config`` names the file as ``data_path`` with ``{split}`` (``.json``
    or ``.json.gz``)."""

    def __init__(self, config=None) -> None:
        super().__init__()
        if config is None:
            return
        data_path = config.data_path.format(split=config.split)
        opener = gzip.open if data_path.endswith(".gz") else open
        with opener(data_path, "rt") as f:
            self.from_json(f.read())

    def from_json(self, json_str: str, scenes_dir=None) -> None:
        for ep in json.loads(json_str).get("episodes", []):
            self.episodes.append(RearrangeEpisode(
                episode_id=str(ep["episode_id"]),
                scene_id=ep["scene_id"],
                start_position=list(ep.get("start_position", [0, 0, 0])),
                start_rotation=list(ep.get("start_rotation", [0, 0, 0, 1])),
                info=ep.get("info", {}),
                rigid_objs=[(name, _position(T)) for name, T in ep.get("rigid_objs", [])],
                targets={name: _position(T) for name, T in ep.get("targets", {}).items()},
                markers=ep.get("markers", []),
                ao_states=ep.get("ao_states", {}),
            ))


def generate_rearrange_episode(
    scene: SceneData,
    episode_id: str,
    rng: np.random.Generator,
    *,
    num_objects: int = 3,
    num_targets: int = 1,
    min_start_dist: float = 1.0,
    use_receptacles: bool = False,
) -> Optional[RearrangeEpisode]:
    """Objects, their goals and the start on navigable cells; the start is
    redrawn (up to 10 times) while it lies within ``min_start_dist`` of an
    object. With ``use_receptacles`` a goal lies on a receptacle where the
    scene has one (reference object_sampler.py), else on the floor."""
    occ = scene.nav_occ
    nav_cells = np.argwhere(occ)
    if len(nav_cells) < num_objects + 2:
        return None

    def sample_point():
        c = nav_cells[rng.integers(len(nav_cells))]
        xz = scene.cell_to_world(c)
        return [float(xz[0]), scene.floor_y, float(xz[1])]

    def sample_goal():
        if use_receptacles:
            p = sample_on_receptacle(scene, rng)
            if p is not None:
                return [float(p[0]), float(p[1]), float(p[2])]
        return sample_point()

    objs = [(f"obj_{i}", sample_point()) for i in range(num_objects)]
    target_ids = rng.choice(num_objects, size=num_targets, replace=False)
    targets = {f"obj_{i}": sample_goal() for i in target_ids}
    start = sample_point()
    tries = 0
    while min(np.linalg.norm(np.asarray(start) - np.asarray(p)) for _, p in objs) < min_start_dist and tries < 10:
        start = sample_point()
        tries += 1
    yaw = float(rng.uniform(-np.pi, np.pi))
    return RearrangeEpisode(
        episode_id=episode_id,
        scene_id=scene.scene_id,
        start_position=start,
        start_rotation=_yaw_to_quat_coeffs(yaw),
        rigid_objs=objs,
        targets=targets,
    )


def make_procedural_rearrange(
    num_scenes: int = 2,
    episodes_per_scene: int = 8,
    seed: int = 0,
    extent: float = 8.0,
    num_objects: int = 3,
    n_rooms_per_axis: int = 2,
    n_clutter: int = 3,
    **kw,
) -> Tuple[List[SceneData], List[RearrangeEpisode]]:
    """Procedural apartments (seeds ``seed * 500 + s``) and their episodes,
    all drawn from one ``default_rng(seed)``. An ``ao_state_sampler``
    (samplers.py) draws each episode's ``ao_states`` right after it, over
    ``art_objs`` (default: one ``ArtObjSpec("drawer_<s>")``)."""
    ao_state_sampler = kw.pop("ao_state_sampler", None)
    art_objs = kw.pop("art_objs", None)
    rng = np.random.default_rng(seed)
    scenes, episodes = [], []
    for s in range(num_scenes):
        scene = generate_apartment(
            seed=seed * 500 + s, extent=extent, n_clutter=n_clutter, n_rooms_per_axis=n_rooms_per_axis
        )
        scenes.append(scene)
        for e in range(episodes_per_scene):
            ep = generate_rearrange_episode(scene, f"re_{s}_{e}", rng, num_objects=num_objects, **kw)
            if ep is not None:
                if ao_state_sampler is not None:
                    ep.ao_states = ao_state_sampler.sample(art_objs or [ArtObjSpec(handle=f"drawer_{s}")], rng)
                episodes.append(ep)
    return scenes, episodes


def settle_objects(
    obj_init: np.ndarray,  # (E, O, 3) box bottoms
    obj_valid: np.ndarray,  # (E, O)
    floor_y: np.ndarray,  # (E,)
    steps: int = 30,
    device=None,
) -> np.ndarray:
    """Stability settling at episode-generation time (reference settle_sim,
    datasets/rearrange/rearrange_generator.py:938): ``steps`` contacts-v3
    steps with the robot far away, so overlapping spawns separate and
    floating spawns drop. Numpy in, numpy out; the steps run on ``device``
    (``None`` is the card)."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(obj_init, np.float32), device=dev)
    v = torch.zeros_like(p)
    free = torch.as_tensor(np.asarray(obj_valid, bool), device=dev)
    fy = torch.as_tensor(np.asarray(floor_y, np.float32), device=dev)
    agent_far = torch.full((p.shape[0], 3), 1e6, dtype=torch.float32, device=dev)
    for _ in range(steps):
        p, v, _ = contact_step(p, v, free, fy, agent_far)
    return p.cpu().numpy()


def _asset_dims(name: str) -> Tuple[np.ndarray, np.float32]:
    """An object's box half-extents and spawn yaw, deterministic in its name
    (the asset's own dims; the renderer and the contact step use them)."""
    h = int(hashlib.md5(str(name).encode()).hexdigest()[:8], 16)
    r = np.random.default_rng(h)
    return r.uniform(0.07, 0.16, 3).astype(np.float32), np.float32(r.uniform(0.0, np.pi))


def _place_asset_joint(j, ang: float):
    """A URDF joint ``j`` placed at yaw ``ang``: (the world axis row, the
    joint origin's world offset, revolute, the open joint value). A hinge's
    axis row holds the door's direction at q=0, which the env swings about
    +Y: the child box's center direction, or x where that box sits on the
    hinge."""
    revolute = j.joint_type == "revolute"
    ca, sa = np.cos(ang), np.sin(ang)
    if not revolute:
        axo = j.axis
    elif np.linalg.norm(j.box_center[[0, 2]]) > 1e-5:
        axo = j.box_center
    else:
        axo = np.array([1.0, 0.0, 0.0], np.float32)
    axw = np.array([ca * axo[0] + sa * axo[2], axo[1], -sa * axo[0] + ca * axo[2]], np.float32)
    axw = axw / max(np.linalg.norm(axw[[0, 2]]), 1e-6)
    axw[1] = 0.0  # furniture joints actuate in the horizontal plane
    oo = j.origin
    offset = np.array([ca * oo[0] + sa * oo[2], oo[1], -sa * oo[0] + ca * oo[2]], np.float32)
    open_q = float(j.upper) if j.upper > j.lower else (1.5 if revolute else 0.35)
    return axw, offset, revolute, open_q


def build_rearrange_table(
    episodes: List[RearrangeEpisode],
    scenes: Dict[str, SceneData],
    scene_index: Dict[str, int],
    max_objects: Optional[int] = None,
    settle: bool = False,
    art_joint: str = "prismatic",
    art_asset=None,
    device=None,
) -> RearrangeTable:
    """Pack rearrange episodes into a table of CPU tensors, with the nav
    table whose goal is the pick target's initial position. One articulated
    object per episode (a drawer, or with ``art_joint="revolute"`` a fridge
    door) at a sampled navigable spot. ``art_asset`` (a
    ``loaders.ArticulatedObjectAsset``) gives it its URDF's primary movable
    joint instead: the joint kind, the axis turned by the placement yaw,
    the joint origin's offset and the open value (the upper limit). An
    episode's ``ao_states`` set its initial joint value. ``settle`` runs
    ``settle_objects`` on ``device`` (``None`` is the card)."""
    E = len(episodes)
    if max_objects is None:
        max_objects = max(len(e.rigid_objs) for e in episodes)
    O = max_objects

    obj_init = np.zeros((E, O, 3), np.float32)
    obj_valid = np.zeros((E, O), bool)
    obj_half = np.full((E, O, 3), 0.12, np.float32)
    obj_yaw = np.zeros((E, O), np.float32)
    target_pos = np.zeros((E, O, 3), np.float32)
    target_mask = np.zeros((E, O), bool)
    pick_target = np.zeros((E,), np.int64)
    A = 1
    art_pos = np.zeros((E, A, 3), np.float32)
    art_axis = np.zeros((E, A, 3), np.float32)
    art_valid = np.zeros((E, A), bool)
    art_target = np.zeros((E,), np.int64)
    art_init_q = np.zeros((E,), np.float32)
    art_goal_q = np.zeros((E,), np.float32)
    art_is_revolute = np.zeros((E, A), bool)
    rng_art = np.random.default_rng(1234)
    nav_episodes = []

    for i, ep in enumerate(episodes):
        names = []
        for j, (name, pos) in enumerate(ep.rigid_objs[:O]):
            obj_init[i, j] = pos
            obj_valid[i, j] = True
            obj_half[i, j], obj_yaw[i, j] = _asset_dims(name)
            names.append(name)
        first_target = None
        for name, goal in ep.targets.items():
            if name in names:
                j = names.index(name)
                target_pos[i, j] = goal
                target_mask[i, j] = True
                if first_target is None:
                    first_target = j
        # objects without targets keep their init as "goal" (distance 0)
        for j in range(O):
            if not target_mask[i, j]:
                target_pos[i, j] = obj_init[i, j]
        pick_target[i] = first_target if first_target is not None else 0
        scene = scenes[ep.scene_id]
        if ep.markers:
            art_pos[i, 0] = ep.markers[0].get("position", [0, 0, 0])
        else:
            art_pos[i, 0] = scene.sample_navigable_point(rng_art)
        ang = rng_art.uniform(-np.pi, np.pi)
        art_valid[i, 0] = True
        if art_asset is not None:
            art_axis[i, 0], offset, revolute, open_q = _place_asset_joint(art_asset.primary, ang)
            art_pos[i, 0] = art_pos[i, 0] + offset
        else:
            art_axis[i, 0] = [np.cos(ang), 0.0, np.sin(ang)]
            # fridge doors are revolute (q radians about the vertical hinge),
            # drawers prismatic (q metres)
            revolute = ep.info.get("art_joint", art_joint) == "revolute"
            open_q = 1.5 if revolute else 0.35
        art_is_revolute[i, 0] = revolute
        if ep.info.get("art_task", "open") == "close":
            art_init_q[i], art_goal_q[i] = open_q, 0.0
        else:
            art_init_q[i], art_goal_q[i] = 0.0, open_q
        # episode-declared AO states override the task default
        if ep.ao_states:
            art_init_q[i] = float(next(iter(next(iter(ep.ao_states.values())).values())))
        # nav goal = the pick target's start (NavToObj semantics)
        nav_episodes.append(
            NavigationEpisode(
                episode_id=ep.episode_id,
                scene_id=ep.scene_id,
                start_position=list(ep.start_position),
                start_rotation=list(ep.start_rotation),
                info=dict(ep.info),
                goals=[NavigationGoal(position=[float(x) for x in obj_init[i, pick_target[i]]], radius=0.3)],
            )
        )

    if settle:
        floor_ys = np.array([scenes[ep.scene_id].floor_y for ep in episodes], np.float32)
        obj_init = settle_objects(obj_init, obj_valid, floor_ys, device=device)

    t = torch.from_numpy
    return RearrangeTable(
        nav=build_episode_table(nav_episodes, scenes, scene_index),
        obj_init=t(obj_init),
        obj_valid=t(obj_valid),
        obj_half=t(obj_half),
        obj_yaw=t(obj_yaw),
        target_pos=t(target_pos),
        target_mask=t(target_mask),
        pick_target=t(pick_target),
        art_pos=t(art_pos),
        art_axis=t(art_axis),
        art_valid=t(art_valid),
        art_target=t(art_target),
        art_init_q=t(art_init_q),
        art_goal_q=t(art_goal_q),
        art_is_revolute=t(art_is_revolute),
    )


def make_rearrange_env(
    num_envs: int = 4,
    task: str = "pick",
    art_joint: str = "prismatic",
    art_urdf: Optional[str] = None,
    num_scenes: int = 2,
    episodes_per_scene: int = 8,
    seed: int = 0,
    with_visual: bool = True,
    render_size=(128, 128),
    n_rooms_per_axis: int = 2,
    n_clutter: int = 3,
    num_objects: int = 3,
    device=None,
    **env_kw,
) -> RearrangeBatchedEnv:
    """Procedural scenes and episodes -> ``RearrangeBatchedEnv`` on
    ``device`` (``None`` = cuda). Under ``dynamics="contacts"`` the spawns
    are settled first, on the same device. ``art_urdf`` names a URDF whose
    primary movable joint becomes every episode's articulated object."""
    dev = resolve_device(device)
    scenes, episodes = make_procedural_rearrange(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed,
        n_rooms_per_axis=n_rooms_per_axis, n_clutter=n_clutter, num_objects=num_objects,
    )
    scene_index = {s.scene_id: i for i, s in enumerate(scenes)}
    table = build_rearrange_table(
        episodes, {s.scene_id: s for s in scenes}, scene_index,
        settle=env_kw.get("dynamics") == "contacts", art_joint=art_joint,
        art_asset=None if art_urdf is None else load_articulated_object(art_urdf), device=dev,
    )
    order = build_env_episode_order(episodes, num_envs, seed=seed)
    return RearrangeBatchedEnv(
        pack_scenes(scenes), table, order, task=task, with_visual=with_visual, render_size=render_size,
        device=dev, **env_kw,
    )
