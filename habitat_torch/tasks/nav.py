"""Navigation task: sensors, measures, actions, batched over envs (port of
``habitat_tpu/tasks/nav.py``, under the same registered names).

- sensors: PointGoalSensor, PointGoalWithGPSCompassSensor, HeadingSensor,
  CompassSensor, GPSSensor, ProximitySensor, ObjectGoalSensor,
  ImageGoalSensor, InstanceImageGoalSensor, InstanceImageGoalHFOVSensor,
  HabitatSimRGBSensor, HabitatSimDepthSensor, HabitatSimSemanticSensor and
  their equirect and fisheye versions (HabitatSimEquirectangular*Sensor,
  HabitatSimFisheye*Sensor); the visual ones are rendered once per step and
  camera model by the env, the goal images once per episode at table build;
- measures: DistanceToGoal, Success, SPL, SoftSPL, Collisions,
  DistanceToGoalReward, NumSteps, and the host-side TopDownMap,
  RuntimePerfStats and GfxReplayMeasure (``host_side``: the batched step
  reports zeros for them, and the single-env ``core/env.py::Env`` updates
  them on the host after each step, from the agent's pose);
- actions: stop / move_forward / turn_left / turn_right / look_up /
  look_down, velocity_control (continuous commands, integrated by the
  batched env) and teleport (no pose change in the batched env, as in the
  JAX package; the parameterised teleport runs on the host simulator,
  ``sims/tpu_sim.py``'s ``TpuSim.step``).
"""

from __future__ import annotations

import json
import time

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


def scene_field_at(fields: torch.Tensor, sid, lo, res, pos: torch.Tensor) -> torch.Tensor:
    """A per-scene field (S,NX,NZ) at world pos (N,3), nearest cell
    (rounded half to even, as ``jnp.round``)."""
    nx, nz = fields.shape[-2], fields.shape[-1]
    c = torch.round((pos[:, [0, 2]] - lo) / res).long()
    return fields[sid, c[:, 0].clamp(0, nx - 1), c[:, 1].clamp(0, nz - 1)]


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


@registry.register_sensor("PointGoalSensor")
class PointGoalSensor(FunctionalSensor):
    """Pointgoal in the episode-start frame."""

    uuid = "pointgoal"

    def __init__(self, config=None):
        super().__init__(config)
        self.goal_format = _cfg(config, "goal_format", "POLAR")
        self.dimensionality = _cfg(config, "dimensionality", 2)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return _pointgoal_obs(
            ctx.start_pos, ctx.start_yaw, ctx.goal_pos[:, 0], self.goal_format, self.dimensionality
        ).float()


@registry.register_sensor("PointGoalWithGPSCompassSensor")
class IntegratedPointGoalGPSAndCompassSensor(PointGoalSensor):
    """Pointgoal in the CURRENT agent frame."""

    uuid = "pointgoal_with_gps_compass"

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return _pointgoal_obs(
            ctx.pos, ctx.yaw, ctx.goal_pos[:, 0], self.goal_format, self.dimensionality
        ).float()


def _wrap(a: torch.Tensor) -> torch.Tensor:
    """An angle wrapped to [-pi, pi] as (N, 1) float32."""
    return torch.atan2(torch.sin(a), torch.cos(a))[:, None].float()


@registry.register_sensor("HeadingSensor")
class HeadingSensor(FunctionalSensor):
    """World-frame heading: the yaw (about +y, forward -z) wrapped."""

    uuid = "heading"

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return _wrap(ctx.yaw)


@registry.register_sensor("CompassSensor")
class EpisodicCompassSensor(FunctionalSensor):
    """Heading relative to the episode start, wrapped."""

    uuid = "compass"

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return _wrap(ctx.yaw - ctx.start_yaw)


@registry.register_sensor("GPSSensor")
class EpisodicGPSSensor(FunctionalSensor):
    """Position in the episode-start frame; 2-D gives [-z, x] of it."""

    uuid = "gps"

    def __init__(self, config=None):
        super().__init__(config)
        self.dimensionality = _cfg(config, "dimensionality", 2)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        rel = rotate_world_to_agent(ctx.pos - ctx.start_pos, ctx.start_yaw)
        if self.dimensionality == 2:
            return torch.stack([-rel[:, 2], rel[:, 0]], dim=-1).float()
        return rel.float()


@registry.register_sensor("ProximitySensor")
class ProximitySensor(FunctionalSensor):
    """Distance to the closest obstacle, from the scene's obstacle-distance
    field, clipped to ``max_detection_radius``."""

    uuid = "proximity"

    def __init__(self, config=None):
        super().__init__(config)
        self.max_detection_radius = _cfg(config, "max_detection_radius", 2.0)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        d = scene_field_at(ctx.pack.obst_dist, ctx.sid, ctx.pack.nav_lo[ctx.sid], ctx.pack.nav_res, ctx.pos)
        return d.clamp(0.0, self.max_detection_radius)[:, None].float()


@registry.register_sensor("ObjectGoalSensor")
class ObjectGoalSensor(FunctionalSensor):
    """The episode's goal category id, (N, 1) int32 (-1 read as 0)."""

    uuid = "objectgoal"

    def __init__(self, config=None):
        super().__init__(config)
        self.goal_spec_max_val = _cfg(config, "goal_spec_max_val", 50)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return ctx.table.object_category[ctx.ep_idx].clamp(min=0)[:, None].to(torch.int32)


@registry.register_sensor("ImageGoalSensor")
class ImageGoalSensor(FunctionalSensor):
    """The episode's goal view, (N, H, W, 3) uint8, gathered from the
    table's ``goal_image`` (rendered once at table build, see
    ``core.dataset.goal_view``)."""

    uuid = "imagegoal"

    def __init__(self, config=None):
        super().__init__(config)
        self.height = _cfg(config, "height", 128)
        self.width = _cfg(config, "width", 128)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        img = ctx.table.goal_image
        if img.shape[1] != self.height or img.shape[2] != self.width:
            raise ValueError(
                "EpisodeTable was built without goal images of the right size; pass goal_image_size to "
                f"build_episode_table (table {tuple(img.shape)} vs sensor {(self.height, self.width)})")
        return img[ctx.ep_idx]


@registry.register_sensor("InstanceImageGoalSensor")
class InstanceImageGoalSensor(ImageGoalSensor):
    """The goal instance's stored view, from the same table."""

    uuid = "instance_imagegoal"


@registry.register_sensor("InstanceImageGoalHFOVSensor")
class InstanceImageGoalHFOVSensor(FunctionalSensor):
    """The goal view's HFOV: the table's ``extras["instance_hfov"]``, else
    90 degrees."""

    uuid = "instance_imagegoal_hfov"

    def compute(self, ctx: StepContext) -> torch.Tensor:
        extras = ctx.table.extras
        if "instance_hfov" in extras:
            return extras["instance_hfov"][ctx.ep_idx][:, None].float()
        return torch.full((ctx.pos.shape[0], 1), 90.0, device=ctx.pos.device)


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


@registry.register_task_action("LookUpAction")
class LookUpAction(FunctionalAction):
    name = "look_up"

    def tilt_amount(self):
        return float(np.deg2rad(_cfg(self.config, "tilt_angle", 15.0)))


@registry.register_task_action("LookDownAction")
class LookDownAction(FunctionalAction):
    name = "look_down"

    def tilt_amount(self):
        return -float(np.deg2rad(_cfg(self.config, "tilt_angle", 15.0)))


@registry.register_task_action("TeleportAction")
class TeleportAction(FunctionalAction):
    """Teleport to a given pose (reference nav.py:1121). The parameterised
    action runs on the host simulator (``TpuSim.step({"action": "teleport",
    "action_args": {"position", "rotation"}})``); in the batched env it
    contributes no pose change."""

    name = "teleport"


@registry.register_task_action("VelocityAction")
class VelocityAction(FunctionalAction):
    """Velocity control (reference nav.py:1170): a (linear, angular) command
    in [-1, 1]^2 mapped onto ``lin_vel_range`` (m/s) and ``ang_vel_range``
    (degrees/s) and integrated over ``time_step`` seconds by the batched
    env; both speeds under ``min_abs_lin_speed`` / ``min_abs_ang_speed``
    stop the episode."""

    name = "velocity_control"

    def __init__(self, config=None):
        super().__init__(config)
        self.lin_vel_range = _cfg(config, "lin_vel_range", [0.0, 0.25])
        self.ang_vel_range = _cfg(config, "ang_vel_range", [-10.0, 10.0])
        self.min_abs_lin_speed = _cfg(config, "min_abs_lin_speed", 0.025)
        self.min_abs_ang_speed = _cfg(config, "min_abs_ang_speed", 1.0)
        self.time_step = _cfg(config, "time_step", 1.0)


class HostMeasure(FunctionalMeasure):
    """A measure the single-env ``Env`` computes on the host: ``host_reset``
    at an episode's start and ``host_update`` after each step, from the
    agent's (3,) position and yaw. In a batched env it reports zeros."""

    host_side = True

    def reset(self, ctx):
        return {}, torch.zeros(ctx.pos.shape[0], device=ctx.pos.device)

    def update(self, state, ctx, measures):
        return {}, torch.zeros(ctx.pos.shape[0], device=ctx.pos.device)


@registry.register_measure("TopDownMap")
class TopDownMap(HostMeasure):
    """Top-down map (reference nav.py:678): the scene's occupancy map with
    the goals stamped, the fog of war the agent has lifted and its pose, as
    {map, fog_of_war_mask, agent_map_coord, agent_angle}
    (``utils/visualizations/maps.py::TopDownMapTracker``)."""

    uuid = "top_down_map"

    def __init__(self, config=None):
        super().__init__(config)
        self._tracker = None

    def host_reset(self, scene, episode, pos, yaw):
        from habitat_torch.utils.visualizations.maps import TopDownMapTracker

        fog, draw_path = True, True
        if self.config is not None and hasattr(self.config, "get"):
            fow = self.config.get("fog_of_war", None)
            if hasattr(fow, "get"):
                fog = bool(fow.get("draw", True))
            draw_path = bool(self.config.get("draw_shortest_path", True))
        goals = None
        if episode is not None and getattr(episode, "goals", None):
            goals = np.array([g.position for g in episode.goals], np.float32)
        self._tracker = TopDownMapTracker(scene, draw_shortest_path=draw_path, fog_of_war=fog)
        self._tracker.reset(goal_positions=goals)
        self._tracker.update(np.asarray(pos), float(yaw))
        return self.host_value()

    def host_update(self, pos, yaw, episode_over=False):
        self._tracker.update(np.asarray(pos), float(yaw))
        return self.host_value()

    def host_value(self):
        t = self._tracker
        c, yaw = t._last_pose
        return {"map": t.map, "fog_of_war_mask": t.fog_mask, "agent_map_coord": (int(c[0]), int(c[1])),
                "agent_angle": float(yaw)}


@registry.register_measure("RuntimePerfStats")
class RuntimePerfStats(HostMeasure):
    """Step timing (reference rearrange_sensors.py:1166, uuid
    "habitat_perf"): ``step_ms``, the wall-clock ms since the previous
    update (or the reset), and ``utils/timing.py::g_timer``'s means in ms."""

    uuid = "habitat_perf"

    def __init__(self, config=None):
        super().__init__(config)
        self._t_prev = None

    def host_reset(self, scene, episode, pos, yaw):
        self._t_prev = time.time()
        return {}

    def host_update(self, pos, yaw, episode_over=False):
        from habitat_torch.utils.timing import g_timer

        now = time.time()
        out = {"step_ms": (now - self._t_prev) * 1e3}
        self._t_prev = now
        for k, v in g_timer.todict().items():
            out[k] = v * 1e3
        return out


@registry.register_measure("GfxReplayMeasure")
class GfxReplayMeasure(HostMeasure):
    """gfx-replay keyframes (reference rearrange_sensors.py:500, uuid
    "gfx_replay_keyframes_string"): one keyframe of the agent's pose at the
    reset and one per step; "" while the episode runs, the JSON replay
    {"keyframes": [...]} at its end."""

    uuid = "gfx_replay_keyframes_string"

    def host_reset(self, scene, episode, pos, yaw):
        self._kfs = []
        self._scene_id = getattr(scene, "scene_id", "scene")
        self._append(pos, yaw)
        return ""

    def _append(self, pos, yaw):
        self._kfs.append({"agent": {"position": [float(x) for x in np.asarray(pos)], "yaw": float(yaw)},
                          "index": len(self._kfs), "scene": self._scene_id})

    def host_update(self, pos, yaw, episode_over=False):
        self._append(pos, yaw)
        return json.dumps({"keyframes": self._kfs}) if episode_over else ""
