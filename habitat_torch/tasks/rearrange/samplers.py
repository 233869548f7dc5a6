"""Rearrange episode-generation samplers (port of
``habitat_tpu/tasks/rearrange/samplers.py``; reference habitat-lab/habitat/
datasets/rearrange/samplers/: scene_sampler.py, object_sampler.py,
object_target_sampler.py, art_sampler.py).

The reference samplers act on a live habitat-sim instance; here they act on
a host ``SceneData`` and its receptacle annotations and return plain
placement dicts that ``generator.generate_rearrange_episode`` and
``build_rearrange_table`` consume. Host numpy, with the JAX package's RNG
calls in its order.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from habitat_torch.sims.receptacles import sample_on_receptacle
from habitat_torch.sims.scene import SceneData

# -- scene samplers (reference scene_sampler.py) ------------------------------


class SceneSampler(ABC):
    """reference scene_sampler.py:10."""

    @abstractmethod
    def num_scenes(self) -> int:
        ...

    @abstractmethod
    def sample(self) -> str:
        ...

    def set_cur_episode(self, cur_episode: int) -> None:
        """Episode-count hook (BalancedSceneSampler uses it)."""


class SingleSceneSampler(SceneSampler):
    """reference :34: always the one scene."""

    def __init__(self, scene: str):
        self.scene = scene

    def sample(self) -> str:
        return self.scene

    def num_scenes(self) -> int:
        return 1


class MultiSceneSampler(SceneSampler):
    """reference :53: uniform over a unique scene set."""

    def __init__(self, scenes: Sequence[str], seed: int = 0):
        self.scenes = sorted(set(scenes))
        if not self.scenes:
            raise ValueError("No scenes provided to MultiSceneSampler.")
        self._rng = np.random.default_rng(seed)

    def sample(self) -> str:
        return self.scenes[self._rng.integers(len(self.scenes))]

    def num_scenes(self) -> int:
        return len(self.scenes)


class BalancedSceneSampler(SceneSampler):
    """reference :77: num_episodes / num_scenes episodes per scene, in order."""

    def __init__(self, scenes: Sequence[str], num_episodes: int):
        self.scenes = list(scenes)
        self.num_episodes = num_episodes
        if num_episodes % len(self.scenes):
            raise ValueError(f"{num_episodes} episodes not evenly divisible by {len(self.scenes)} scenes")
        self.eps_per_scene = num_episodes // len(self.scenes)
        self.cur_episode = 0

    def sample(self) -> str:
        return self.scenes[min(self.cur_episode // self.eps_per_scene, len(self.scenes) - 1)]

    def num_scenes(self) -> int:
        return len(self.scenes)

    def set_cur_episode(self, cur_episode: int) -> None:
        self.cur_episode = cur_episode


# -- object and target samplers (reference object_sampler.py,
#    object_target_sampler.py) ------------------------------------------------


class ObjectSampler:
    """Initial object placements (reference object_sampler.py:38): a point
    on a receptacle, else on a navigable floor cell, with pairwise
    ``min_separation`` by rejection."""

    def __init__(
        self,
        object_set: Sequence[str],
        num_objects: Tuple[int, int] = (1, 1),
        orientation_sample: Optional[str] = "up",  # None | "up" | "all"
        use_receptacles: bool = True,
        min_separation: float = 0.3,
    ):
        self.object_set = list(object_set)
        self.num_objects = num_objects
        self.orientation_sample = orientation_sample
        self.use_receptacles = use_receptacles
        self.min_separation = min_separation

    def _sample_point(self, scene: SceneData, rng: np.random.Generator):
        if self.use_receptacles:
            p = sample_on_receptacle(scene, rng)
            if p is not None:
                return np.asarray(p, np.float64)
        cells = np.argwhere(scene.nav_occ)
        xz = scene.cell_to_world(cells[rng.integers(len(cells))])
        return np.array([xz[0], scene.floor_y, xz[1]], np.float64)

    def sample(self, scene: SceneData, rng: np.random.Generator,
               max_tries: int = 50) -> List[Tuple[str, List[float], float]]:
        """-> [(object_name, position, yaw)] with pairwise separation."""
        n = int(rng.integers(self.num_objects[0], self.num_objects[1] + 1))
        out: List[Tuple[str, List[float], float]] = []
        pts: List[np.ndarray] = []
        tries = 0
        while len(out) < n and tries < max_tries * n:
            tries += 1
            p = self._sample_point(scene, rng)
            if pts and min(np.linalg.norm(p - q) for q in pts) < self.min_separation:
                continue
            name = self.object_set[rng.integers(len(self.object_set))]
            yaw = float(rng.uniform(-np.pi, np.pi)) if self.orientation_sample in ("up", "all") else 0.0
            out.append((f"{name}_:{len(out):04d}", [float(v) for v in p], yaw))
            pts.append(p)
        return out


class ObjectTargetSampler(ObjectSampler):
    """Goal placements for placed objects (reference
    object_target_sampler.py): one target per chosen object, at least
    ``min_displacement`` from its start."""

    def sample_targets(
        self,
        scene: SceneData,
        placements: Sequence[Tuple[str, List[float], float]],
        num_targets: int,
        rng: np.random.Generator,
        min_displacement: float = 0.5,
        max_tries: int = 50,
    ) -> Dict[str, List[float]]:
        idxs = rng.choice(len(placements), size=min(num_targets, len(placements)), replace=False)
        out: Dict[str, List[float]] = {}
        for i in idxs:
            name, pos, _ = placements[int(i)]
            for _ in range(max_tries):
                p = self._sample_point(scene, rng)
                if np.linalg.norm(p - np.asarray(pos)) >= min_displacement:
                    out[name] = [float(v) for v in p]
                    break
        return out


# -- articulated-object state samplers (reference art_sampler.py) -------------


@dataclasses.dataclass
class ArtObjSpec:
    """A host-side articulated object: handle and named links with ranges."""

    handle: str
    link_names: Tuple[str, ...] = ("drawer_0",)
    joint_limits: Tuple[Tuple[float, float], ...] = ((0.0, 0.45),)


class ArticulatedObjectStateSampler:
    """reference art_sampler.py:16: for every AO whose handle contains
    ``ao_handle``, the named link's joint state drawn uniformly from
    ``state_range`` and clipped to the link's limits."""

    def __init__(self, ao_handle: str, link_name: str, state_range: Tuple[float, float]):
        if state_range[1] < state_range[0]:
            raise ValueError(f"state_range {state_range} is empty")
        self.ao_handle = ao_handle
        self.link_name = link_name
        self.state_range = state_range

    def _sample_joint_state(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.state_range[0], self.state_range[1]))

    def sample(self, art_objs: Sequence[ArtObjSpec], rng: np.random.Generator) -> Dict[str, Dict[str, float]]:
        """-> {ao_handle: {link_name: q}} for matching AOs (an episode's
        ao_states, which build_rearrange_table reads)."""
        out: Dict[str, Dict[str, float]] = {}
        for ao in art_objs:
            if self.ao_handle not in ao.handle:
                continue
            for li, link in enumerate(ao.link_names):
                if link == self.link_name:
                    lo, hi = ao.joint_limits[li]
                    out.setdefault(ao.handle, {})[link] = float(np.clip(self._sample_joint_state(rng), lo, hi))
                    break
        return out


class ArtObjCatStateSampler(ArticulatedObjectStateSampler):
    """reference art_sampler.py:65: the same sampling, matched by category
    (categories are handle prefixes in the procedural tables)."""


class CompositeArticulatedObjectStateSampler(ArticulatedObjectStateSampler):
    """reference art_sampler.py:75: one of several pre-defined joint-state
    configurations (e.g. 'fridge open' or 'all drawers shut')."""

    def __init__(self, configurations: Sequence[Dict[str, Dict[str, float]]]):
        self.configurations = list(configurations)
        if not self.configurations:
            raise ValueError("CompositeArticulatedObjectStateSampler needs a configuration")

    def sample(self, art_objs: Sequence[ArtObjSpec], rng: np.random.Generator) -> Dict[str, Dict[str, float]]:
        cfg = self.configurations[rng.integers(len(self.configurations))]
        handles = {ao.handle for ao in art_objs}
        return {h: dict(links) for h, links in cfg.items() if h in handles}
