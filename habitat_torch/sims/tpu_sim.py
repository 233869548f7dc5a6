"""TpuSim, the registered "Sim-v0": the single-agent host simulator (port of
``habitat_tpu/sims/tpu_sim.py``; reference sims/habitat_simulator/
habitat_simulator.py:270).

It holds one scene as a ``ScenePack`` on its device and serves the
reference's single-agent API (examples, ``ShortestPathFollower``, user
agents) over the port's kernels; the batched envs do not go through it.

- The agent's pose lives on the host, as in the JAX sim: position (3,)
  float32, yaw and pitch in radians. Moves and turns are computed there in
  the JAX sim's float32 arithmetic; a move's collision-resolved position
  comes from ``ops/navgrid.try_step`` on the device.
- Every step renders the agent's camera with ``render_batch`` (N=1) and
  copies the frames to the host once: the frames, the new position and the
  collision flag travel in one buffer. The pose goes to the device in one
  copy that does not wait on the card.
- The pathfinder queries (geodesic distance, island radius, shortest-path
  points, navigable points) are the host numpy code of the JAX sim, on the
  scene's navgrid.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from habitat_torch.core.registry import registry
from habitat_torch.core.simulator import AgentState, Simulator
from habitat_torch.device import resolve_device
from habitat_torch.ops import navgrid as ng
from habitat_torch.ops.raycast import render_batch
from habitat_torch.sims.scene import INF_DIST, SceneData, geodesic_field, pack_scenes

CAMERA_HEIGHT = 1.25


class HabitatSimActions:
    """Extensible action-name -> index singleton (reference
    sims/habitat_simulator/actions.py:17-91)."""

    _map: Dict[str, int] = {}

    @classmethod
    def extend_action_space(cls, name: str) -> int:
        assert name not in cls._map, f"action {name} already registered"
        cls._map[name] = len(cls._map)
        return cls._map[name]

    @classmethod
    def has_action(cls, name: str) -> bool:
        return name in cls._map

    @classmethod
    def __class_getitem__(cls, name: str) -> int:
        return cls._map[name]

    @classmethod
    def get(cls, name: str) -> int:
        return cls._map[name]


for _a in ("stop", "move_forward", "turn_left", "turn_right", "look_up", "look_down"):
    HabitatSimActions.extend_action_space(_a)


def _yaw_of(rotation) -> float:
    x, y, z, w = rotation
    return float(2.0 * np.arctan2(y, w))


@registry.register_simulator(name="Sim-v0")
class TpuSim(Simulator):
    """``config``: the lab's simulator node (``scene`` "procedural[:seed]"
    or a scene file, ``forward_step_size``, ``turn_angle``, ``tilt_angle``,
    the agents' ``sim_sensors``) or None; ``scene``: a ``SceneData`` that
    overrides the config's; ``device``: ``None`` = cuda."""

    def __init__(self, config: Any = None, scene: Optional[SceneData] = None, device=None):
        self.habitat_config = config
        self.device = resolve_device(device)
        if scene is None:
            scene_name = "procedural"
            if config is not None:
                scene_name = getattr(config, "scene", "procedural") or "procedural"
            if scene_name.startswith("procedural"):
                from habitat_torch.sims.procedural import generate_apartment

                seed = int(scene_name.split(":")[1]) if ":" in scene_name else 0
                scene = generate_apartment(seed=seed)
            else:
                from habitat_torch.sims.loaders import load_scene

                scene = load_scene(scene_name)
        self._scene = scene
        self.pack = pack_scenes([scene]).to(self.device)
        self._fwd_step = float(getattr(config, "forward_step_size", 0.25) if config else 0.25)
        self._turn = np.deg2rad(float(getattr(config, "turn_angle", 10) if config else 10))
        self._tilt = np.deg2rad(float(getattr(config, "tilt_angle", 15) if config else 15))
        self._pos = np.array([0.0, 0.0, 0.0], np.float32)
        self._yaw = 0.0
        self._pitch = 0.0
        self._collided = False
        self._rng = np.random.default_rng(0)
        self._sensor_cfgs = self._collect_sensor_cfgs(config)
        self._sid = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._cam_offset = torch.tensor([0.0, CAMERA_HEIGHT, 0.0], dtype=torch.float32, device=self.device)
        self._field_cache: Dict[Any, np.ndarray] = {}
        self._semantic_scene = None
        self.reset()

    def semantic_annotations(self):
        """The SemanticScene hierarchy (levels > regions > objects) of the
        scene's annotations (reference habitat_simulator.py:249-257)."""
        if self._semantic_scene is None:
            from habitat_torch.sims.semantic_scene import build_semantic_scene

            self._semantic_scene = build_semantic_scene(self._scene)
        return self._semantic_scene

    @property
    def semantic_scene(self):
        return self.semantic_annotations()

    # -- config ----------------------------------------------------------
    def _collect_sensor_cfgs(self, config):
        out = {}
        try:
            agents = config.agents
            for name in config.agents_order or sorted(agents):
                for uuid, c in agents[name].sim_sensors.items():
                    out[c["type"]] = c
        except Exception:
            out = {
                "HabitatSimRGBSensor": {"height": 128, "width": 128},
                "HabitatSimDepthSensor": {"height": 128, "width": 128},
            }
        return out

    def _render_cfg(self):
        """(height, width, min_depth, max_depth, normalize_depth): the size
        of the last configured sensor and the depth sensor's settings, as the
        JAX sim reads them."""
        h = w = 128
        min_d, max_d, norm = 0.0, 10.0, True
        for t, c in self._sensor_cfgs.items():
            h = int(c.get("height", 128))
            w = int(c.get("width", 128))
            if t == "HabitatSimDepthSensor":
                min_d = float(c.get("min_depth", 0.0))
                max_d = float(c.get("max_depth", 10.0))
                norm = bool(c.get("normalize_depth", True))
        return h, w, min_d, max_d, norm

    # -- core API ----------------------------------------------------------
    def reset(self):
        self._pos = np.asarray(self._scene.sample_navigable_point(self._rng))
        self._yaw = float(self._rng.uniform(-np.pi, np.pi))
        self._pitch = 0.0
        self._collided = False
        return self._observations()

    def _forward(self) -> np.ndarray:
        return np.array([-np.sin(self._yaw), 0.0, -np.cos(self._yaw)], np.float32)

    def step(self, action, *args, **kwargs):
        if isinstance(action, dict):
            name = action.get("action")
            args_ = action.get("action_args", {}) or {}
            if name in ("teleport", "TELEPORT"):
                self._pos = np.asarray(args_["position"], np.float32)
                if "rotation" in args_:
                    self._yaw = _yaw_of(args_["rotation"])
                return self._observations()
            if name in ("velocity_control", "VELOCITY_CONTROL"):
                lin = float(args_.get("lin_vel", args_.get("linear_velocity", 0.0)))
                ang = float(np.deg2rad(args_.get("ang_vel", args_.get("angular_velocity", 0.0))))
                dt = float(args_.get("time_step", 1.0))
                # rotate, then translate (reference VelocityControl)
                self._yaw += ang * dt
                return self._observations(target=self._pos + self._forward() * lin * dt)
            action = name
        if isinstance(action, str):
            action = HabitatSimActions.get(action)
        if action == HabitatSimActions.get("move_forward"):
            return self._observations(target=self._pos + self._forward() * self._fwd_step)
        if action == HabitatSimActions.get("turn_left"):
            self._yaw += self._turn
        elif action == HabitatSimActions.get("turn_right"):
            self._yaw -= self._turn
        elif action == HabitatSimActions.get("look_up"):
            self._pitch = min(self._pitch + self._tilt, np.pi / 2)
        elif action == HabitatSimActions.get("look_down"):
            self._pitch = max(self._pitch - self._tilt, -np.pi / 2)
        return self._observations()

    def _observations(self, target: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Render the agent's camera; with ``target``, first move toward it
        (``try_step``, sliding along walls) and keep the new position and the
        collision flag. One copy to the device, one back."""
        h, w, min_d, max_d, norm = self._render_cfg()
        host = [self._pos, np.array([self._yaw, self._pitch], np.float32)]
        if target is not None:
            host.append(np.asarray(target, np.float32))
        x = torch.from_numpy(np.concatenate(host)).to(self.device, non_blocking=True)
        pos = x[None, 0:3]
        if target is not None:
            pos, collided = ng.try_step(self.pack, self._sid, pos, x[None, 5:8])
        frames = render_batch(self.pack, self._sid, pos + self._cam_offset, x[3:4], x[4:5], height=h, width=w,
                              min_depth=min_d, max_depth=max_d, normalize_depth=norm)
        parts = {k: v[0] for k, v in frames.items()}
        if target is not None:
            parts["_pos"], parts["_collided"] = pos[0], collided.to(torch.uint8)
        host_parts = to_host(parts)
        if target is not None:
            self._pos = host_parts.pop("_pos")
            self._collided = bool(host_parts.pop("_collided")[0])
        return host_parts

    def get_observations_at(self, position=None, rotation=None, keep_agent_at_new_pose=False):
        old = (self._pos.copy(), self._yaw, self._pitch)
        if position is not None:
            self._pos = np.asarray(position, np.float32)
        if rotation is not None:
            self._yaw = _yaw_of(rotation)
        obs = self._observations()
        if not keep_agent_at_new_pose:
            self._pos, self._yaw, self._pitch = old
        return obs

    # -- agent state -------------------------------------------------------
    def get_agent_state(self, agent_id: int = 0) -> AgentState:
        yaw = self._yaw
        rot = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)], np.float32)
        return AgentState(position=self._pos.copy(), rotation=rot)

    def set_agent_state(self, position, rotation, agent_id: int = 0, reset_sensors: bool = True) -> bool:
        self._pos = np.asarray(position, np.float32)
        self._yaw = _yaw_of(rotation)
        return True

    # -- pathfinder queries (reference habitat_simulator.py:528-709) --------
    def _goal_field(self, goals) -> np.ndarray:
        key = tuple(tuple(np.round(np.asarray(g), 3)) for g in goals)
        if key not in self._field_cache:
            cells = np.asarray([self._scene.world_to_cell(np.asarray(g)[[0, 2]]) for g in goals])
            self._field_cache[key] = geodesic_field(self._scene.nav_occ, cells, self._scene.nav_res)
        return self._field_cache[key]

    def geodesic_distance(self, position_a, position_b, episode=None) -> float:
        pb = np.asarray(position_b, dtype=np.float64)
        goals = pb[None] if pb.ndim == 1 else pb
        field = self._goal_field(list(goals))
        c = self._scene.world_to_cell(np.asarray(position_a)[[0, 2]])
        nx, nz = field.shape
        if not (0 <= c[0] < nx and 0 <= c[1] < nz):
            return float("inf")
        d = float(field[c[0], c[1]])
        return float("inf") if d >= INF_DIST else d

    def sample_navigable_point(self) -> List[float]:
        return list(map(float, self._scene.sample_navigable_point(self._rng)))

    def is_navigable(self, point) -> bool:
        return self._scene.is_navigable(np.asarray(point))

    def island_radius(self, position) -> float:
        """Approximate island radius: the obstacle distance at the point's
        cell (reference habitat_simulator.py:708)."""
        c = self._scene.world_to_cell(np.asarray(position)[[0, 2]])
        nx, nz = self._scene.obst_dist.shape
        if not (0 <= c[0] < nx and 0 <= c[1] < nz):
            return 0.0
        return float(self._scene.obst_dist[c[0], c[1]])

    def distance_to_closest_obstacle(self, position, max_search_radius: float = 2.0):
        return min(self.island_radius(position), max_search_radius)

    def get_straight_shortest_path_points(self, position_a, position_b):
        """Cell centres down the goal's geodesic field from ``position_a``,
        ending with ``position_b``."""
        field = self._goal_field([np.asarray(position_b)])
        pts = [list(map(float, position_a))]
        pos = np.asarray(position_a, np.float64)
        res = self._scene.nav_res
        for _ in range(10000):
            c = self._scene.world_to_cell(pos[[0, 2]])
            if field[c[0], c[1]] <= res:
                break
            best, bestd = None, field[c[0], c[1]]
            for dx in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    i, k = c[0] + dx, c[1] + dz
                    if 0 <= i < field.shape[0] and 0 <= k < field.shape[1] and field[i, k] < bestd:
                        bestd, best = field[i, k], (i, k)
            if best is None:
                break
            xz = self._scene.cell_to_world(np.asarray(best))
            pos = np.array([xz[0], pos[1], xz[1]])
            pts.append([float(pos[0]), float(pos[1]), float(pos[2])])
        pts.append(list(map(float, position_b)))
        return pts

    def previous_step_collided(self) -> bool:
        return self._collided

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def reconfigure(self, config: Any) -> None:
        self.habitat_config = config


def to_host(parts: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy device tensors to the host in one transfer (their bytes
    concatenated on the device) and give them back as numpy arrays of their
    own dtypes and shapes."""
    # widest elements first, so that every part starts aligned
    order = sorted(parts, key=lambda k: -parts[k].element_size())
    flat = [parts[k].contiguous().reshape(-1).view(torch.uint8) for k in order]
    buf = torch.cat(flat).cpu().numpy()
    out, at = {}, 0
    for k, f in zip(order, flat):
        v, n = parts[k], f.numel()
        out[k] = buf[at:at + n].view(_NUMPY[v.dtype]).reshape(tuple(v.shape))
        at += n
    return {k: out[k] for k in parts}


_NUMPY = {torch.float32: np.float32, torch.uint8: np.uint8, torch.int32: np.int32, torch.int64: np.int64}
