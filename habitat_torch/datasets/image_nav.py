"""Instance-image navigation dataset (port of
``habitat_tpu/datasets/image_nav.py``; reference habitat-lab/habitat/
datasets/image_nav/instance_image_nav_dataset.py): goals keyed by object
instance, each with the stored camera parameters of its goal views
(position, rotation, hfov)."""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Dict, List, Optional

from habitat_torch.core.dataset import Episode, NavigationGoal
from habitat_torch.core.registry import registry


@dataclasses.dataclass
class InstanceImageParameters:
    position: List[float] = dataclasses.field(default_factory=list)
    rotation: List[float] = dataclasses.field(default_factory=lambda: [0, 0, 0, 1])
    hfov: float = 90.0
    image_dimensions: tuple = (512, 512)


@dataclasses.dataclass
class InstanceImageGoal(NavigationGoal):
    object_id: str = ""
    object_category: Optional[str] = None
    image_goals: List[InstanceImageParameters] = dataclasses.field(default_factory=list)
    view_points: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class InstanceImageGoalNavEpisode(Episode):
    object_category: Optional[str] = None
    goal_object_id: str = ""
    goal_image_id: int = 0
    goals: list = dataclasses.field(default_factory=list)

    @property
    def goal_key(self) -> str:
        """'<scene basename without .glb/.basis>_<goal_object_id>'
        (reference instance_image_nav_task.py:53)."""
        sid = os.path.basename(self.scene_id)
        for x in (".glb", ".basis"):
            sid = sid[: -len(x)] if sid.endswith(x) else sid
        oid = self.goal_object_id or (self.goals[0].object_id if self.goals else "")
        return f"{sid}_{oid}"


def _goal(g: dict) -> InstanceImageGoal:
    return InstanceImageGoal(
        position=list(g.get("position", [])),
        radius=g.get("radius"),
        object_id=str(g.get("object_id", "")),
        object_category=g.get("object_category"),
        image_goals=[
            InstanceImageParameters(
                position=list(ig.get("position", [])),
                rotation=list(ig.get("rotation", [0, 0, 0, 1])),
                hfov=float(ig.get("hfov", 90.0)),
                image_dimensions=tuple(ig.get("image_dimensions", (512, 512))),
            )
            for ig in g.get("image_goals", [])
        ],
        view_points=g.get("view_points", []),
    )


@registry.register_dataset(name="InstanceImageNav-v1")
class InstanceImageNavDatasetV1:
    """Episodes of a reference InstanceImageNav JSON(.gz) file, or of
    ``from_json``."""

    def __init__(self, config=None) -> None:
        self.episodes: List[InstanceImageGoalNavEpisode] = []
        self.goals_by_category: Dict[str, list] = {}
        if config is None:
            return
        data_path = config.data_path.format(split=config.split)
        opener = gzip.open if data_path.endswith(".gz") else open
        with opener(data_path, "rt") as f:
            self.from_json(f.read())

    def from_json(self, json_str: str, scenes_dir=None) -> None:
        data = json.loads(json_str)
        # the reference maps goal_key -> ONE goal dict
        # (instance_image_nav_dataset.py:76-78); a list is accepted too
        goals_by_key = {
            key: [_goal(g) for g in ([goals] if isinstance(goals, dict) else goals)]
            for key, goals in data.get("goals", data.get("goals_by_category", {})).items()
        }
        for ep in data.get("episodes", []):
            episode = InstanceImageGoalNavEpisode(
                episode_id=str(ep["episode_id"]),
                scene_id=ep["scene_id"],
                start_position=list(ep["start_position"]),
                start_rotation=list(ep["start_rotation"]),
                info=ep.get("info", {}),
                object_category=ep.get("object_category"),
                goal_object_id=str(ep.get("goal_object_id", "")),
                goal_image_id=int(ep.get("goal_image_id", 0)),
            )
            episode.goals = goals_by_key.get(ep.get("goal_key") or episode.goal_key, [])
            if not episode.goals and goals_by_key:
                # no key matches: the first goal set whose key starts with
                # the scene's basename
                for k, v in goals_by_key.items():
                    if k.startswith(str(ep["scene_id"]).split("/")[-1]):
                        episode.goals = v
                        break
            self.episodes.append(episode)
