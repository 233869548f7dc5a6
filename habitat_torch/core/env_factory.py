"""Constructor wiring scenes + episodes + task into a BatchedEnv (port of
``habitat_tpu/core/env_factory.py::make_nav_env``). The scene split over
envs is the per-env episode-order table."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

import habitat_torch.tasks.nav  # noqa: F401  (registers the nav components)
from habitat_torch.core.batched_env import BatchedEnv, RewardSpec
from habitat_torch.core.dataset import (
    NavigationEpisode,
    build_env_episode_order,
    build_episode_table,
)
from habitat_torch.core.registry import registry
from habitat_torch.device import resolve_device
from habitat_torch.sims.scene import SceneData, pack_scenes

DEFAULT_NAV_ACTIONS = (
    "StopAction",
    "MoveForwardAction",
    "TurnLeftAction",
    "TurnRightAction",
)


def make_nav_env(
    scenes: Sequence[SceneData],
    episodes: Sequence[NavigationEpisode],
    num_envs: int,
    *,
    sensor_specs: Sequence = (("PointGoalWithGPSCompassSensor", None),),
    measure_specs: Sequence = (
        ("DistanceToGoal", None),
        ("Success", None),
        ("SPL", None),
        ("SoftSPL", None),
        ("Collisions", None),
        ("DistanceToGoalReward", None),
        ("NumSteps", None),
    ),
    action_names: Sequence[str] = DEFAULT_NAV_ACTIONS,
    action_config=None,
    max_episode_steps: int = 500,
    reward_spec: RewardSpec = RewardSpec(),
    precomputed_fields: Optional[Dict[str, np.ndarray]] = None,
    seed: int = 0,
    goal_image_size: Optional[int] = None,
    device=None,
    rows: slice = slice(None),
) -> BatchedEnv:
    """Build a batched PointNav-style env (PointNav, ObjectNav, ImageNav by
    its sensors) from host scenes + episodes on ``device`` (``None`` =
    cuda). ``goal_image_size`` renders each episode's goal view at that
    size on ``device``, for ImageGoalSensor. ``rows`` of the ``num_envs``
    envs' episode order are built (a DD-PPO rank's; all by default)."""
    dev = resolve_device(device)
    scene_index = {s.scene_id: i for i, s in enumerate(scenes)}
    scene_map = {s.scene_id: s for s in scenes}
    pack = pack_scenes(list(scenes))
    table = build_episode_table(
        list(episodes), scene_map, scene_index, precomputed_fields=precomputed_fields,
        goal_image_size=goal_image_size, device=dev,
    )
    order = build_env_episode_order(list(episodes), num_envs, seed=seed)

    sensors = [registry.get_sensor(name)(cfg) for name, cfg in sensor_specs]
    measures = [registry.get_measure(name)(cfg) for name, cfg in measure_specs]
    actions = [registry.get_task_action(name)(action_config) for name in action_names]

    return BatchedEnv(
        pack,
        table,
        order,
        sensors,
        measures,
        actions,
        device=dev,
        rows=rows,
        max_episode_steps=max_episode_steps,
        reward_spec=reward_spec,
    )
