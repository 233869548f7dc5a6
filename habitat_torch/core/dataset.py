"""Episodes, datasets, iterators and the device episode table.

Port of ``habitat_tpu/core/dataset.py``: the episode dataclasses, the host
``Dataset`` (splits, filtering) and ``EpisodeIterator`` (the single-env
``Env``'s episode scheduler: cycle / shuffle / group-by-scene /
max-scene-repeat, every draw from one ``numpy.random.Generator`` in the JAX
package's order, so a seed gives the same episode sequence in both),
``EpisodeTable`` (all episodes packed as tensors, indexed by episode id on
the device) built by ``build_episode_table`` (with ImageNav's goal views
rendered once, at table build, when ``goal_image_size`` is given), and the
per-env episode schedule ``build_env_episode_order``.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import Any, Callable, Dict, Generic, Iterator, List, Optional, Sequence, TypeVar

import numpy as np
import torch

ALL_SCENES_MASK = "*"


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


T = TypeVar("T", bound=Episode)


class Dataset(Generic[T]):
    """Collection of episodes + splits/filtering (reference dataset.py:111)."""

    episodes: List[T]

    def __init__(self, episodes: Optional[List[T]] = None) -> None:
        self.episodes = episodes or []

    @property
    def scene_ids(self) -> List[str]:
        return sorted({episode.scene_id for episode in self.episodes})

    def scene_from_scene_path(self, scene_path: str) -> str:
        return scene_path.split("/")[-1].split(".")[0]

    def get_scene_episodes(self, scene_id: str) -> List[T]:
        return [e for e in self.episodes if e.scene_id == scene_id]

    def get_episodes(self, indexes: Sequence[int]) -> List[T]:
        return [self.episodes[i] for i in indexes]

    def filter_episodes(self, filter_fn: Callable[[T], bool]) -> "Dataset":
        """A copy holding the episodes that pass ``filter_fn``."""
        new = copy.copy(self)
        new.episodes = [e for e in self.episodes if filter_fn(e)]
        return new

    def get_splits(
        self,
        num_splits: int,
        episodes_allowed: Optional[Sequence[str]] = None,
        collate_scene_ids: bool = True,
        sort_by_episode_id: bool = False,
        allow_uneven_splits: bool = False,
    ) -> List["Dataset"]:
        """``num_splits`` datasets dealt round-robin from the (allowed,
        scene-sorted) episodes; without ``allow_uneven_splits`` each holds
        the same count and the remainder is dropped."""
        if episodes_allowed is not None:
            allowed = set(episodes_allowed)
            eps = [e for e in self.episodes if e.episode_id in allowed]
        else:
            eps = list(self.episodes)
        if collate_scene_ids:
            eps.sort(key=lambda e: e.scene_id)
        if sort_by_episode_id:
            eps.sort(key=lambda e: e.episode_id)
        n = len(eps)
        if not allow_uneven_splits:
            n = (n // num_splits) * num_splits
        splits: List[Dataset] = []
        for i in range(num_splits):
            new = copy.copy(self)
            new.episodes = eps[i:n:num_splits]
            splits.append(new)
        return splits

    def get_scenes_to_load(self) -> List[str]:
        return self.scene_ids

    def get_episode_iterator(self, *args, **kwargs) -> "EpisodeIterator":
        return EpisodeIterator(self.episodes, *args, **kwargs)


class EpisodeIterator(Iterator[T]):
    """Cycling episode scheduler with scene-grouped ordering and forced
    scene rotation (reference core/dataset.py:329-584 semantics). The
    pending order of the current cycle is an explicit ``deque``, and every
    draw comes from one private ``numpy.random.Generator``:

    * episodes are (optionally) shuffled each cycle, then stably reordered
      so that each scene's episodes form one contiguous block, blocks in
      order of first appearance;
    * after ``max_scene_repeat_episodes`` consecutive episodes, or once
      ``max_scene_repeat_steps`` env steps (jittered by
      ``±step_repetition_range`` and drawn again after every forced switch)
      have been taken in one scene, the leading run of same-scene episodes
      still pending moves to the back of the deque, so the next episode
      comes from another scene;
    * pulling an episode of another scene than the previous pull resets
      both counters: the budgets are per contiguous scene run.
    """

    def __init__(
        self,
        episodes: Sequence[T],
        cycle: bool = True,
        shuffle: bool = False,
        group_by_scene: bool = True,
        max_scene_repeat_episodes: int = -1,
        max_scene_repeat_steps: int = -1,
        num_episode_sample: int = -1,
        step_repetition_range: float = 0.2,
        seed: Optional[int] = None,
    ) -> None:
        self._rng = np.random.default_rng(seed)
        pool = list(episodes)
        if num_episode_sample >= 0:
            if num_episode_sample > len(pool):
                raise ValueError(f"num_episode_sample {num_episode_sample} > episode count {len(pool)}")
            picks = self._rng.choice(len(pool), num_episode_sample, replace=False)
            pool = [pool[i] for i in picks]
        self.cycle = cycle
        self.shuffle = shuffle
        self.group_by_scene = group_by_scene
        self.max_scene_repetition_episodes = max_scene_repeat_episodes
        self.max_scene_repetition_steps = max_scene_repeat_steps
        self.step_repetition_range = step_repetition_range
        # the current cycle's base order (reordered at construction and at
        # each cycle boundary); forced switches reorder only the deque
        self.episodes: List[T] = self._ordered(pool, shuffle=shuffle)
        self._pending: deque = deque(self.episodes)
        self._scene_now: Optional[str] = None
        self._episodes_in_scene = 0
        self._steps_in_scene = 0
        self._draw_step_quota()

    def _ordered(self, pool: Sequence[T], shuffle: bool) -> List[T]:
        out = list(pool)
        if shuffle:
            out = [out[i] for i in self._rng.permutation(len(out))]
        if self.group_by_scene:
            first_seen: Dict[str, int] = {}
            for e in out:
                first_seen.setdefault(e.scene_id, len(first_seen))
            out.sort(key=lambda e: first_seen[e.scene_id])  # stable
        return out

    def _rotate_leading_run(self) -> None:
        """Move the pending deque's leading same-scene run to its back."""
        if not self._pending:
            return
        lead = self._pending[0].scene_id
        run: List[T] = []
        while self._pending and self._pending[0].scene_id == lead:
            run.append(self._pending.popleft())
        if self._pending:
            self._pending.extend(run)
        else:
            self._pending.extendleft(reversed(run))  # single scene: no-op

    def __iter__(self) -> "EpisodeIterator":
        return self

    def __next__(self) -> T:
        if self._quota_hit():
            self._rotate_leading_run()
            self._draw_step_quota()
        if not self._pending:
            if not self.cycle:
                raise StopIteration
            if self.shuffle:
                self.episodes = self._ordered(self.episodes, shuffle=True)
            self._pending = deque(self.episodes)
            if not self._pending:
                raise StopIteration
        ep = self._pending.popleft()
        if self._scene_now is not None and ep.scene_id != self._scene_now:
            self._episodes_in_scene = 0
            self._steps_in_scene = 0
        self._scene_now = ep.scene_id
        self._episodes_in_scene += 1
        return ep

    def _quota_hit(self) -> bool:
        if self.max_scene_repetition_episodes > 0 and self._episodes_in_scene >= self.max_scene_repetition_episodes:
            return True
        return self._step_quota is not None and self._steps_in_scene >= self._step_quota

    def _draw_step_quota(self) -> None:
        """(Re)draw the jittered step budget for the upcoming scene run."""
        if self.max_scene_repetition_steps > 0:
            v, r = self.max_scene_repetition_steps, self.step_repetition_range
            self._step_quota: Optional[int] = int(self._rng.integers(int(v * (1 - r)), int(v * (1 + r)) + 1))
        else:
            self._step_quota = None

    def step_taken(self) -> None:
        self._steps_in_scene += 1


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
