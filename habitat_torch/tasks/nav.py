"""Navigation task: sensors, measures, actions, batched over envs (port of
the PointNav parts of ``habitat_tpu/tasks/nav.py``, under the same
registered names).

- sensors: PointGoalWithGPSCompassSensor, HabitatSimRGBSensor,
  HabitatSimDepthSensor, HabitatSimSemanticSensor and their equirect and
  fisheye versions (HabitatSimEquirectangular*Sensor,
  HabitatSimFisheye*Sensor); the visual ones are rendered once per step and
  camera model by the env;
- measures: DistanceToGoal, Success, SPL, SoftSPL, Collisions,
  DistanceToGoalReward, NumSteps;
- actions: stop / move_forward / turn_left / turn_right.
"""

from __future__ import annotations

import numpy as np
import torch

from habitat_torch.core.embodied_task import (
    FunctionalAction,
    FunctionalMeasure,
    FunctionalSensor,
    StepContext,
)
from habitat_torch.core.registry import registry
from habitat_torch.ops.navgrid import distance_at
from habitat_torch.utils.geometry import rotate_world_to_agent


def _cfg(config, name, default):
    if config is None:
        return default
    if isinstance(config, dict):
        return config.get(name, default)
    return getattr(config, name, default)


def table_distance_at(ctx: StepContext, pos: torch.Tensor) -> torch.Tensor:
    """Geodesic distance-to-goal at world pos (N,3) -> (N,), read from each
    env's episode field in the table."""
    return distance_at(
        ctx.table.dist_field, ctx.ep_idx, ctx.pack.nav_lo[ctx.sid], ctx.pack.nav_res, pos
    )


# ---------------------------------------------------------------------------
# Sensors
# ---------------------------------------------------------------------------


def _pointgoal_obs(source_pos, source_yaw, goal_pos, goal_format: str, dimensionality: int):
    """Batched pointgoal in the source frame (reference _compute_pointgoal)."""
    dva = rotate_world_to_agent(goal_pos - source_pos, source_yaw)
    if goal_format == "POLAR":
        phi = torch.atan2(dva[:, 0], -dva[:, 2])
        if dimensionality == 2:
            rho = torch.sqrt(dva[:, 0] ** 2 + dva[:, 2] ** 2)
            return torch.stack([rho, -phi], dim=-1)
        norm = torch.linalg.vector_norm(dva, dim=-1)
        theta = torch.arccos(torch.clamp(dva[:, 1] / norm.clamp(min=1e-9), -1, 1))
        return torch.stack([norm, -phi, theta], dim=-1)
    if dimensionality == 2:
        return torch.stack([-dva[:, 2], dva[:, 0]], dim=-1)
    return dva


@registry.register_sensor("PointGoalWithGPSCompassSensor")
class IntegratedPointGoalGPSAndCompassSensor(FunctionalSensor):
    """Pointgoal in the CURRENT agent frame."""

    uuid = "pointgoal_with_gps_compass"

    def __init__(self, config=None):
        super().__init__(config)
        self.goal_format = _cfg(config, "goal_format", "POLAR")
        self.dimensionality = _cfg(config, "dimensionality", 2)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return _pointgoal_obs(
            ctx.pos, ctx.yaw, ctx.goal_pos[:, 0], self.goal_format, self.dimensionality
        ).float()


class VisualSensorSpec(FunctionalSensor):
    """Marker base for raster sensors; the env renders once per step per
    camera model (size, hfov, projection, mount height) and hands each
    sensor its frame."""

    projection = "pinhole"

    def __init__(self, config=None):
        super().__init__(config)
        self.height = _cfg(config, "height", 128)
        self.width = _cfg(config, "width", 128)
        self.hfov = _cfg(config, "hfov", 90.0)
        # camera mount height above the agent base (reference default [0, 1.25, 0])
        self.position_y = _cfg(config, "position", [0.0, 1.25, 0.0])[1]


@registry.register_sensor("HabitatSimRGBSensor")
class RGBSensor(VisualSensorSpec):
    uuid = "rgb"


@registry.register_sensor("HabitatSimDepthSensor")
class DepthSensor(VisualSensorSpec):
    uuid = "depth"

    def __init__(self, config=None):
        super().__init__(config)
        self.min_depth = _cfg(config, "min_depth", 0.0)
        self.max_depth = _cfg(config, "max_depth", 10.0)
        self.normalize_depth = _cfg(config, "normalize_depth", True)


@registry.register_sensor("HabitatSimSemanticSensor")
class SemanticSensor(VisualSensorSpec):
    uuid = "semantic"


# panoramic projections: the same uuids through other ray generators


@registry.register_sensor("HabitatSimEquirectangularRGBSensor")
class EquirectRGBSensor(RGBSensor):
    projection = "equirect"


@registry.register_sensor("HabitatSimEquirectangularDepthSensor")
class EquirectDepthSensor(DepthSensor):
    projection = "equirect"


@registry.register_sensor("HabitatSimEquirectangularSemanticSensor")
class EquirectSemanticSensor(SemanticSensor):
    projection = "equirect"


@registry.register_sensor("HabitatSimFisheyeRGBSensor")
class FisheyeRGBSensor(RGBSensor):
    projection = "fisheye"


@registry.register_sensor("HabitatSimFisheyeDepthSensor")
class FisheyeDepthSensor(DepthSensor):
    projection = "fisheye"


@registry.register_sensor("HabitatSimFisheyeSemanticSensor")
class FisheyeSemanticSensor(SemanticSensor):
    projection = "fisheye"


# ---------------------------------------------------------------------------
# Measures
# ---------------------------------------------------------------------------


@registry.register_measure("NumSteps")
class NumStepsMeasure(FunctionalMeasure):
    uuid = "num_steps"

    def reset(self, ctx):
        return {}, torch.zeros_like(ctx.step, dtype=torch.float32)

    def update(self, state, ctx, measures):
        return {}, ctx.step.float()


@registry.register_measure("DistanceToGoal")
class DistanceToGoal(FunctionalMeasure):
    """Geodesic distance to the goal set, read from the episode field."""

    uuid = "distance_to_goal"

    def reset(self, ctx):
        return {}, table_distance_at(ctx, ctx.pos)

    def update(self, state, ctx, measures):
        return {}, table_distance_at(ctx, ctx.pos)


@registry.register_measure("Success")
class Success(FunctionalMeasure):
    """stop called && distance_to_goal < success_distance."""

    uuid = "success"
    deps = ("distance_to_goal",)

    def __init__(self, config=None):
        super().__init__(config)
        self.success_distance = _cfg(config, "success_distance", 0.2)

    def reset(self, ctx):
        return {}, torch.zeros(ctx.pos.shape[0], device=ctx.pos.device)

    def update(self, state, ctx, measures):
        ok = ctx.stop_called & (measures["distance_to_goal"] < self.success_distance)
        return {}, ok.float()


@registry.register_measure("SPL")
class SPL(FunctionalMeasure):
    """Success-weighted path length; state carries (path, start)."""

    uuid = "spl"
    deps = ("distance_to_goal", "success")

    def reset(self, ctx):
        start = table_distance_at(ctx, ctx.pos)
        return {"path": torch.zeros_like(start), "start": start}, torch.zeros_like(start)

    def update(self, state, ctx, measures):
        path = state["path"] + torch.linalg.vector_norm(ctx.pos - ctx.prev_pos, dim=-1)
        start = state["start"]
        val = measures["success"] * start / torch.maximum(start, path.clamp(min=1e-6))
        return {"path": path, "start": start}, val


@registry.register_measure("SoftSPL")
class SoftSPL(FunctionalMeasure):
    """SPL with soft success = max(0, 1 - d/d_start)."""

    uuid = "soft_spl"
    deps = ("distance_to_goal",)

    def reset(self, ctx):
        start = table_distance_at(ctx, ctx.pos)
        return {"path": torch.zeros_like(start), "start": start}, torch.zeros_like(start)

    def update(self, state, ctx, measures):
        path = state["path"] + torch.linalg.vector_norm(ctx.pos - ctx.prev_pos, dim=-1)
        start = state["start"]
        soft = (1.0 - measures["distance_to_goal"] / start.clamp(min=1e-6)).clamp(min=0.0)
        val = soft * start / torch.maximum(start, path.clamp(min=1e-6))
        return {"path": path, "start": start}, val


@registry.register_measure("Collisions")
class Collisions(FunctionalMeasure):
    """Cumulative collision count."""

    uuid = "collisions"

    def reset(self, ctx):
        return {}, torch.zeros(ctx.pos.shape[0], device=ctx.pos.device)

    def update(self, state, ctx, measures):
        return {}, ctx.collision_count.float()


@registry.register_measure("DistanceToGoalReward")
class DistanceToGoalReward(FunctionalMeasure):
    """-(d_t - d_{t-1}) shaping."""

    uuid = "distance_to_goal_reward"
    deps = ("distance_to_goal",)

    def reset(self, ctx):
        d = table_distance_at(ctx, ctx.pos)
        return {"prev": d}, torch.zeros_like(d)

    def update(self, state, ctx, measures):
        d = measures["distance_to_goal"]
        return {"prev": d}, -(d - state["prev"])


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------


@registry.register_task_action("StopAction")
class StopAction(FunctionalAction):
    name = "stop"

    def is_stop(self):
        return True


@registry.register_task_action("MoveForwardAction")
class MoveForwardAction(FunctionalAction):
    name = "move_forward"

    def move_amount(self):
        return _cfg(self.config, "forward_step_size", 0.25)


@registry.register_task_action("TurnLeftAction")
class TurnLeftAction(FunctionalAction):
    name = "turn_left"

    def turn_amount(self):
        return float(np.deg2rad(_cfg(self.config, "turn_angle", 10.0)))


@registry.register_task_action("TurnRightAction")
class TurnRightAction(FunctionalAction):
    name = "turn_right"

    def turn_amount(self):
        return -float(np.deg2rad(_cfg(self.config, "turn_angle", 10.0)))
