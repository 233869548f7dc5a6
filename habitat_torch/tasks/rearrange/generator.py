"""Rearrangement episode generation and packing (port of
``habitat_tpu/tasks/rearrange/generator.py``).

Counterpart of the reference RearrangeEpisodeGenerator (datasets/rearrange/
rearrange_generator.py:53: scene, object and target samplers, stability
settling :938) and of the RearrangeDataset episode schema (rigid_objs and
targets). Host numpy throughout, with the same RNG calls in the same order
as the JAX package, so the same seed gives the same episodes and tables;
``build_rearrange_table`` returns CPU tensors and ``make_rearrange_env``
moves them to the env's device.

Not ported yet, and raising ``NotImplementedError``: receptacle goals
(``use_receptacles``, sims/receptacles.py), sampled articulated-object
states (``ao_state_sampler``, tasks/rearrange/samplers.py) and URDF-defined
articulated objects (``art_urdf`` / ``art_asset``, sims/loaders.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from habitat_torch.core.dataset import (
    Episode,
    NavigationEpisode,
    NavigationGoal,
    build_env_episode_order,
    build_episode_table,
)
from habitat_torch.datasets.pointnav import _yaw_to_quat_coeffs
from habitat_torch.device import resolve_device
from habitat_torch.sims.procedural import generate_apartment
from habitat_torch.sims.scene import SceneData, pack_scenes
from habitat_torch.tasks.rearrange.rearrange_env import RearrangeBatchedEnv, RearrangeTable, contact_step


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
    object."""
    if use_receptacles:
        raise NotImplementedError("receptacle goals wait for the port of sims/receptacles.py")
    occ = scene.nav_occ
    nav_cells = np.argwhere(occ)
    if len(nav_cells) < num_objects + 2:
        return None

    def sample_point():
        c = nav_cells[rng.integers(len(nav_cells))]
        xz = scene.cell_to_world(c)
        return [float(xz[0]), scene.floor_y, float(xz[1])]

    objs = [(f"obj_{i}", sample_point()) for i in range(num_objects)]
    target_ids = rng.choice(num_objects, size=num_targets, replace=False)
    targets = {f"obj_{i}": sample_point() for i in target_ids}
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
    all drawn from one ``default_rng(seed)``."""
    if kw.pop("ao_state_sampler", None) is not None:
        raise NotImplementedError("sampled articulated-object states wait for the port of tasks/rearrange/samplers.py")
    kw.pop("art_objs", None)
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
    door) at a sampled navigable spot. ``settle`` runs ``settle_objects`` on
    ``device`` (``None`` is the card)."""
    if art_asset is not None:
        raise NotImplementedError("URDF-defined articulated objects wait for the port of sims/loaders.py")
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
    are settled first, on the same device."""
    if art_urdf is not None:
        raise NotImplementedError("URDF-defined articulated objects wait for the port of sims/loaders.py")
    dev = resolve_device(device)
    scenes, episodes = make_procedural_rearrange(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed,
        n_rooms_per_axis=n_rooms_per_axis, n_clutter=n_clutter, num_objects=num_objects,
    )
    scene_index = {s.scene_id: i for i, s in enumerate(scenes)}
    table = build_rearrange_table(
        episodes, {s.scene_id: s for s in scenes}, scene_index,
        settle=env_kw.get("dynamics") == "contacts", art_joint=art_joint, device=dev,
    )
    order = build_env_episode_order(episodes, num_envs, seed=seed)
    return RearrangeBatchedEnv(
        pack_scenes(scenes), table, order, task=task, with_visual=with_visual, render_size=render_size,
        device=dev, **env_kw,
    )
