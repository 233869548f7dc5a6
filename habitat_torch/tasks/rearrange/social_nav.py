"""Social navigation: a robot finds and follows a moving humanoid (port of
``habitat_tpu/tasks/rearrange/social_nav.py``; reference
PddlSocialNavTask-v0, tasks/rearrange/social_nav/social_nav_task.py:21, and
its sensors: SocialNavReward social_nav_sensors.py:37, SocialNavStats :185,
SocialNavSeekSuccess :468, HumanoidDetectorSensor :552, DidAgentsCollide
multi_agent_sensors.py:18, OtherAgentGps :87).

``SocialNavBatchedEnv`` is N envs as one set of tensors on one device. The
humanoid walks a patrol loop of waypoints inside the step, through the same
sliding collision as the robot (``ops/navgrid.try_step``); with
``two_agent=True`` it is a second learned agent instead, the actions are
(N, 2) (robot, humanoid) and the observations carry ``agent_0_`` /
``agent_1_`` prefixes. With ``with_visual`` the robot's head camera renders
the scene and the humanoid's body (a torso and a head box, 24 triangles of
semantic id 9000) merged by closest hit (``render_batch(...,
dynamic=...)``). The step makes no random draw and no host sync; finished
envs reset in place to their next episode.

Seek success is the reference's: the humanoid detected (within range and the
field of view) inside the follow band for ``need_to_face_steps`` steps in a
row. The measures are the reference's, SocialNavStats' under flattened
``social_nav_stats.<field>`` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from habitat_torch.device import resolve_device
from habitat_torch.ops import navgrid as ng
from habitat_torch.ops.raycast import render_batch
from habitat_torch.sims.scene import ScenePack
from habitat_torch.utils.geometry import rotate_world_to_agent, yaw_to_forward

A_STOP, A_FWD, A_LEFT, A_RIGHT = 0, 1, 2, 3
SOCIAL_ACTIONS = ("stop", "move_forward", "turn_left", "turn_right")
HUMANOID_SEM = 9000
HUMANOID_COLOR = (0.85, 0.35, 0.25)
_BOX_CORNERS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
_BOX_FACES = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                       [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]])


def _xz_dist(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(a[:, 0] * a[:, 0] + a[:, 2] * a[:, 2])


def humanoid_body() -> np.ndarray:
    """The humanoid's body relative to its root, (24, 3, 3) float32
    triangles: a 0.36 x 1.4 x 0.36 m torso standing on the floor and a
    0.24 m head box at 1.55 m."""
    cube = _BOX_CORNERS[_BOX_FACES]  # (12, 3, 3), half extent 1
    torso = cube * np.float32([0.18, 0.70, 0.18]) + np.float32([0.0, 0.70, 0.0])
    head = cube * np.float32(0.12) + np.float32([0.0, 1.55, 0.0])
    return np.concatenate([torso, head], axis=0).astype(np.float32)


@dataclasses.dataclass
class SocialNavTable:
    """Per-episode data, E episodes of W waypoints."""

    scene_idx: torch.Tensor  # (E,)
    start_pos: torch.Tensor  # (E, 3)
    start_yaw: torch.Tensor  # (E,)
    human_start: torch.Tensor  # (E, 3)
    waypoints: torch.Tensor  # (E, W, 3) the humanoid's patrol loop

    def to(self, device) -> "SocialNavTable":
        return SocialNavTable(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


@dataclasses.dataclass
class SocialNavState:
    """The batched env's state, (N, ...) tensors."""

    ep_ptr: torch.Tensor  # (N,) i64 position in the env's episode order
    ep_idx: torch.Tensor  # (N,) i64
    step: torch.Tensor  # (N,) i32
    pos: torch.Tensor  # (N, 3)
    yaw: torch.Tensor  # (N,)
    human_pos: torch.Tensor  # (N, 3)
    human_yaw: torch.Tensor  # (N,)
    human_wp: torch.Tensor  # (N,) i64 the waypoint the humanoid walks to
    follow_steps: torch.Tensor  # (N,) i32 consecutive steps facing in the follow band
    found_steps: torch.Tensor  # (N,) i32 steps with the humanoid detected
    min_human_dist: torch.Tensor  # (N,)
    # SocialNavStats' accumulators (reference social_nav_sensors.py:185-462)
    found_ever: torch.Tensor  # (N,) bool
    found_step: torch.Tensor  # (N,) i32 the step of the first encounter
    dis_sum: torch.Tensor  # (N,) robot-humanoid distance summed over steps
    dis_after_sum: torch.Tensor  # (N,) the same after the first encounter
    after_found_times: torch.Tensor  # (N,) i32 detections after the first encounter
    step_after_found: torch.Tensor  # (N,) i32 steps after the first encounter
    backup_count: torch.Tensor  # (N,) i32 backing up near the humanoid
    yield_count: torch.Tensor  # (N,) i32 standing still near the humanoid
    stop_called: torch.Tensor  # (N,) bool
    collided: torch.Tensor  # (N,) bool
    agents_collide: torch.Tensor  # (N,) bool: the two came within collide_dist this episode
    episode_over: torch.Tensor  # (N,) bool
    episode_count: torch.Tensor  # (N,) i32

    def to(self, device) -> "SocialNavState":
        return SocialNavState(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


class SocialNavBatchedEnv:
    """N social-navigation envs on ``device`` (``None`` = cuda).

    ``reset_fn()`` -> (state, obs); ``step_fn(state, actions)`` -> (state,
    obs, reward, done, info): actions (N,) in ``SOCIAL_ACTIONS``, or (N, 2)
    for the robot and the humanoid with ``two_agent``. ``observation_shapes``
    maps each observation key to its (shape, dtype) per env."""

    def __init__(
        self,
        pack: ScenePack,
        table: SocialNavTable,
        episode_order: np.ndarray,
        *,
        max_episode_steps: int = 300,
        human_speed: float = 0.1,  # m per step
        robot_step: float = 0.25,
        turn_angle_deg: float = 10.0,
        follow_band: Tuple[float, float] = (1.0, 2.0),
        detect_dist: float = 4.0,
        detect_fov_deg: float = 90.0,
        need_to_face_steps: int = 5,
        collide_dist: float = 0.5,
        two_agent: bool = False,
        with_visual: bool = False,
        render_size: Optional[Tuple[int, int]] = (128, 128),
        device=None,
    ):
        dev = resolve_device(device)
        self.device = dev
        self.pack = pack.to(dev)
        self.table = table.to(dev)
        self.order = torch.as_tensor(np.asarray(episode_order), dtype=torch.int64, device=dev)
        self.num_envs = int(self.order.shape[0])
        self._order_len = int(self.order.shape[1])
        self._env_ids = torch.arange(self.num_envs, device=dev)
        self.with_visual = with_visual and render_size is not None
        self.render_size = render_size
        self.max_episode_steps = max_episode_steps
        self.human_speed = human_speed
        self.fwd = robot_step
        self.turn = float(np.deg2rad(turn_angle_deg))
        self.follow_band = follow_band
        self.detect_dist = detect_dist
        self.detect_cos = float(np.cos(np.deg2rad(detect_fov_deg) / 2))
        self.need_to_face = need_to_face_steps
        self.collide_dist = collide_dist
        self.num_waypoints = int(self.table.waypoints.shape[1])
        self.two_agent = two_agent
        self.action_names = SOCIAL_ACTIONS
        self.num_actions = len(SOCIAL_ACTIONS)
        # the humanoid's triangles and their attributes, built once
        n = self.num_envs
        self._body = torch.as_tensor(humanoid_body(), device=dev)
        self._body_valid = torch.ones((n, 24), dtype=torch.bool, device=dev)
        self._body_color = torch.tensor(HUMANOID_COLOR, dtype=torch.float32, device=dev).expand(n, 24, 3).contiguous()
        self._body_sem = torch.full((n, 24), HUMANOID_SEM, dtype=torch.int32, device=dev)

        f32 = torch.float32
        agent = {"humanoid_detector_sensor": ((4,), f32), "other_agent_gps": ((2,), f32), "gps": ((2,), f32),
                 "compass": ((1,), f32)}
        if self.with_visual:
            h, w = render_size
            agent["robot_head_rgb"] = ((h, w, 3), torch.uint8)
            agent["robot_head_depth"] = ((h, w, 1), f32)
        if two_agent:
            # reference RearrangeSim's prefixing (rearrange_sim.py:68-82); the
            # camera is the robot's only: the humanoid's would sit inside its
            # own rendered body
            agent = {f"agent_{i}_{k}": v for i in range(2) for k, v in agent.items()
                     if i == 0 or not k.startswith("robot_head")}
        self.observation_shapes = agent

    def agent_observation_shapes(self, i: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Agent i's observation shapes without its prefix (both agents'
        without ``two_agent``)."""
        if not self.two_agent:
            return dict(self.observation_shapes)
        pre = f"agent_{i}_"
        return {k[len(pre):]: v for k, v in self.observation_shapes.items() if k.startswith(pre)}

    # ------------------------------------------------------------------
    def _sid(self, state: SocialNavState) -> torch.Tensor:
        return self.table.scene_idx[state.ep_idx].long()

    def _sees(self, pos, yaw, other_pos) -> Tuple[torch.Tensor, torch.Tensor]:
        """(visible (N,), other's position in the agent frame (N, 3)): the
        HumanoidDetectorSensor's cone of ``detect_fov_deg`` and range
        ``detect_dist``."""
        rel = rotate_world_to_agent(other_pos - pos, yaw)
        dist = _xz_dist(rel)
        fwd_cos = -rel[:, 2] / torch.clamp_min(dist, 1e-6)
        return (dist < self.detect_dist) & (fwd_cos > self.detect_cos), rel

    def _agent_obs(self, state, pos, yaw, other_pos) -> Dict[str, torch.Tensor]:
        """One agent's sensors: its detector of the other agent, the other's
        and its own GPS and its compass in the episode's start frame."""
        visible, rel = self._sees(pos, yaw, other_pos)
        start = self.table.start_pos[state.ep_idx]
        syaw = self.table.start_yaw[state.ep_idx]
        me = rotate_world_to_agent(pos - start, syaw)
        other = rotate_world_to_agent(other_pos - start, syaw)
        comp = yaw - syaw
        return {
            "humanoid_detector_sensor": torch.cat([visible[:, None].float(), rel], dim=-1),
            "other_agent_gps": torch.stack([-other[:, 2], other[:, 0]], dim=-1),
            "gps": torch.stack([-me[:, 2], me[:, 0]], dim=-1),
            "compass": torch.atan2(torch.sin(comp), torch.cos(comp))[:, None],
        }

    def humanoid_geometry(self, state: SocialNavState) -> Dict[str, torch.Tensor]:
        """The humanoid's body at its position as the render's dynamic
        geometry (the reference draws the SMPL-X avatar; flat boxes carry the
        same occlusion and depth)."""
        v = state.human_pos[:, None, None, :] + self._body[None]  # (N, 24, 3, 3)
        return dict(v0=v[:, :, 0], e1=v[:, :, 1] - v[:, :, 0], e2=v[:, :, 2] - v[:, :, 0], valid=self._body_valid,
                    color=self._body_color, sem=self._body_sem)

    def render(self, state: SocialNavState) -> Dict[str, torch.Tensor]:
        """The robot's head camera: 1.25 m up, pitched down 0.25 rad."""
        h, w = self.render_size
        cam = torch.stack([state.pos[:, 0], state.pos[:, 1] + 1.25, state.pos[:, 2]], dim=-1)
        return render_batch(self.pack, self._sid(state), cam, state.yaw, torch.full_like(state.yaw, -0.25),
                            height=h, width=w, dynamic=self.humanoid_geometry(state))

    def _observations(self, state: SocialNavState) -> Dict[str, torch.Tensor]:
        robot = self._agent_obs(state, state.pos, state.yaw, state.human_pos)
        if self.with_visual:
            frames = self.render(state)
            robot["robot_head_depth"] = frames["depth"]
            robot["robot_head_rgb"] = frames["rgb"]
        if not self.two_agent:
            return robot
        human = self._agent_obs(state, state.human_pos, state.human_yaw, state.pos)
        out = {f"agent_0_{k}": v for k, v in robot.items()}
        out.update({f"agent_1_{k}": v for k, v in human.items()})
        return out

    def _measures(self, state: SocialNavState) -> Dict[str, torch.Tensor]:
        dist = _xz_dist(state.human_pos - state.pos)
        seek = (state.follow_steps >= self.need_to_face).float()
        stepf = torch.clamp_min(state.step.float(), 1.0)
        saf = torch.clamp_min(state.step_after_found.float(), 1.0)
        # the fewest steps from the robot's start to the humanoid's: straight
        # line at the step size, a lower bound of the reference's navmesh
        # path, so first_encounter_spl stays at most the true SPL
        start_d = _xz_dist(self.table.human_start[state.ep_idx] - self.table.start_pos[state.ep_idx])
        min_steps = torch.clamp_min(start_d / self.fwd, 1.0)
        found_stepf = torch.clamp_min(state.found_step.float(), 1.0)
        after = state.after_found_times.float()
        return {
            "nav_seek_success": seek,
            "success": seek,
            "did_agents_collide": state.agents_collide.float(),
            "human_dist": dist,
            "min_human_dist": state.min_human_dist,
            "found_human_rate": state.found_steps.float() / stepf,
            "num_steps": state.step.float(),
            # SocialNavStats (reference social_nav_sensors.py:427-462)
            "social_nav_stats.has_found_human": state.found_ever.float(),
            "social_nav_stats.found_human_rate_over_epi": state.found_steps.float() / stepf,
            "social_nav_stats.found_human_rate_after_encounter_over_epi": after / saf,
            "social_nav_stats.avg_robot_to_human_dis_over_epi": state.dis_sum / stepf,
            "social_nav_stats.avg_robot_to_human_after_encounter_dis_over_epi": state.dis_after_sum / saf,
            "social_nav_stats.first_encounter_spl": state.found_ever.float() * (
                min_steps / torch.maximum(min_steps, found_stepf)),
            "social_nav_stats.frist_ecnounter_steps": state.found_step.float(),
            "social_nav_stats.frist_ecnounter_steps_ratio": found_stepf / min_steps,
            "social_nav_stats.follow_human_steps_after_frist_encounter": after,
            "social_nav_stats.follow_human_steps_ratio_after_frist_encounter": after / torch.clamp_min(
                float(self.max_episode_steps) - min_steps, 1.0),
            "social_nav_stats.backup_ratio": state.backup_count.float() / stepf,
            "social_nav_stats.yield_ratio": state.yield_count.float() / stepf,
        }

    def _advance_human(self, state: SocialNavState):
        """The scripted humanoid: ``human_speed`` toward its waypoint (the
        next one once within 0.3 m), sliding along walls."""
        wp = self.table.waypoints[state.ep_idx, state.human_wp % self.num_waypoints]
        d = wp - state.human_pos
        dist = _xz_dist(d)
        new_wp = torch.where(dist < 0.3, state.human_wp + 1, state.human_wp)
        dirn = d / torch.clamp_min(dist, 1e-6)[:, None]
        new_pos, _ = ng.try_step(self.pack, self._sid(state), state.human_pos, state.human_pos + dirn * self.human_speed)
        return new_pos, torch.atan2(-dirn[:, 0], -dirn[:, 2]), new_wp

    def _move(self, sid, pos, yaw, a):
        """A discrete action's heading and slide: (new pos, yaw, collided)."""
        yaw = yaw + torch.where(a == A_LEFT, self.turn, 0.0) - torch.where(a == A_RIGHT, self.turn, 0.0)
        move = torch.where(a == A_FWD, self.fwd, 0.0)
        new_pos, collided = ng.try_step(self.pack, sid, pos, pos + yaw_to_forward(yaw) * move[:, None])
        return new_pos, yaw, collided

    # -- lifecycle ------------------------------------------------------------
    def _fresh(self, ep_idx: torch.Tensor) -> SocialNavState:
        n, dev = self.num_envs, self.device

        def zeros(dtype=torch.int32):
            return torch.zeros(n, dtype=dtype, device=dev)

        return SocialNavState(
            ep_ptr=zeros(torch.int64), ep_idx=ep_idx, step=zeros(),
            pos=self.table.start_pos[ep_idx], yaw=self.table.start_yaw[ep_idx],
            human_pos=self.table.human_start[ep_idx], human_yaw=zeros(torch.float32), human_wp=zeros(torch.int64),
            follow_steps=zeros(), found_steps=zeros(),
            min_human_dist=torch.full((n,), 1e6, device=dev),
            found_ever=zeros(torch.bool), found_step=torch.full((n,), self.max_episode_steps, dtype=torch.int32,
                                                               device=dev),
            dis_sum=zeros(torch.float32), dis_after_sum=zeros(torch.float32), after_found_times=zeros(),
            step_after_found=zeros(), backup_count=zeros(), yield_count=zeros(),
            stop_called=zeros(torch.bool), collided=zeros(torch.bool), agents_collide=zeros(torch.bool),
            episode_over=zeros(torch.bool), episode_count=zeros(),
        )

    def reset_fn(self) -> Tuple[SocialNavState, Dict[str, torch.Tensor]]:
        state = self._fresh(self.order[:, 0])
        return state, self._observations(state)

    def step_fn(self, state: SocialNavState, actions: torch.Tensor):
        """One batched step with masked auto-reset of finished envs; the
        input state is not modified."""
        n = self.num_envs
        sid = self._sid(state)
        prev_dist = _xz_dist(state.human_pos - state.pos)
        acts = actions.long()
        a = acts[:, 0] if self.two_agent else acts
        stop = state.stop_called | (a == A_STOP)
        new_pos, yaw, collided = self._move(sid, state.pos, state.yaw, a)
        if self.two_agent:
            # both agents policy-driven (reference MultiPolicy's action split)
            h_pos, h_yaw, _ = self._move(sid, state.human_pos, state.human_yaw, acts[:, 1])
            h_wp = state.human_wp
        else:
            h_pos, h_yaw, h_wp = self._advance_human(state)

        dist = _xz_dist(h_pos - new_pos)
        step = state.step + 1
        visible, _ = self._sees(new_pos, yaw, h_pos)
        in_band = (dist >= self.follow_band[0]) & (dist <= self.follow_band[1])
        facing = visible & in_band
        # SocialNavStats (reference social_nav_sensors.py:313-462): the first
        # encounter, distance sums, and near the humanoid backing up (moving
        # against the robot's own forward axis) or yielding (nearly still)
        found_now = state.found_ever | visible
        move_vel = ((new_pos - state.pos) * yaw_to_forward(yaw)).sum(-1)  # m per step along forward
        near = dist <= 1.5
        backup = near & (move_vel < -1e-3)
        yield_ = near & (move_vel.abs() < 0.02) & ~backup
        follow = torch.where(facing, state.follow_steps + 1, 0)
        state = dataclasses.replace(
            state, pos=new_pos, yaw=yaw, human_pos=h_pos, human_yaw=h_yaw, human_wp=h_wp, stop_called=stop,
            collided=collided, agents_collide=state.agents_collide | (dist < self.collide_dist), step=step,
            min_human_dist=torch.minimum(state.min_human_dist, dist),
            follow_steps=follow,
            found_steps=state.found_steps + visible.to(torch.int32),
            found_ever=found_now,
            found_step=torch.where(visible & ~state.found_ever, step, state.found_step),
            dis_sum=state.dis_sum + dist,
            dis_after_sum=state.dis_after_sum + torch.where(found_now, dist, 0.0),
            after_found_times=state.after_found_times + (found_now & visible).to(torch.int32),
            step_after_found=state.step_after_found + found_now.to(torch.int32),
            backup_count=state.backup_count + backup.to(torch.int32),
            yield_count=state.yield_count + yield_.to(torch.int32),
        )

        m = self._measures(state)
        episode_over = stop | (step >= self.max_episode_steps)
        done = episode_over | (m["success"] > 0)
        # SocialNavReward (reference social_nav_sensors.py:37): approach into
        # the band, a bonus for each facing step growing with the run of
        # them, a penalty within collide_dist, the success bonus once
        facing_f = facing.float()
        reward = (
            -0.01
            + 0.5 * (prev_dist - dist) * (~in_band).float()
            + 0.1 * facing_f
            + 0.05 * torch.clamp_max(follow, self.need_to_face) * facing_f
            - 1.0 * (dist < self.collide_dist).float()
            + 5.0 * m["success"] * (follow == self.need_to_face)
        )

        # masked auto-reset
        ep_ptr = torch.where(done, state.ep_ptr + 1, state.ep_ptr)
        ep_next = self.order[self._env_ids, ep_ptr % self._order_len]
        fresh = self._fresh(ep_next)

        def sel(new, old):
            return torch.where(done.reshape((n,) + (1,) * (old.dim() - 1)), new, old)

        keep = ("ep_ptr", "ep_idx", "episode_over", "episode_count")
        state = SocialNavState(
            **{f.name: sel(getattr(fresh, f.name), getattr(state, f.name))
               for f in dataclasses.fields(state) if f.name not in keep},
            ep_ptr=ep_ptr, ep_idx=torch.where(done, ep_next, state.ep_idx), episode_over=episode_over,
            episode_count=state.episode_count + done.to(torch.int32))
        return state, self._observations(state), reward, done, dict(m)


def make_social_nav_env(
    num_envs: int = 8,
    num_scenes: int = 2,
    episodes_per_scene: int = 8,
    seed: int = 0,
    n_rooms_per_axis: int = 1,
    num_waypoints: int = 4,
    device=None,
    **env_kw,
) -> SocialNavBatchedEnv:
    """Procedural social-nav episodes on ``device`` (``None`` = cuda): 8 m
    apartments, each episode a robot start, a humanoid start, a patrol loop
    of ``num_waypoints`` and a start yaw, drawn from ``default_rng(seed)`` in
    the JAX package's order, so a seed gives the same table."""
    from habitat_torch.core.dataset import Episode, build_env_episode_order
    from habitat_torch.sims.procedural import generate_apartment
    from habitat_torch.sims.scene import pack_scenes

    rng = np.random.default_rng(seed)
    scenes = [generate_apartment(seed=seed * 77 + s, extent=8.0, n_rooms_per_axis=n_rooms_per_axis, n_clutter=2)
              for s in range(num_scenes)]
    episodes, rows = [], []
    for si, scene in enumerate(scenes):
        for e in range(episodes_per_scene):
            start = scene.sample_navigable_point(rng)
            hstart = scene.sample_navigable_point(rng)
            wps = np.stack([scene.sample_navigable_point(rng) for _ in range(num_waypoints)])
            yaw = float(rng.uniform(-np.pi, np.pi))
            episodes.append(Episode(episode_id=f"sn_{si}_{e}", scene_id=scene.scene_id,
                                    start_position=[float(x) for x in start]))
            rows.append((si, start, yaw, hstart, wps))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    table = SocialNavTable(
        scene_idx=torch.as_tensor([r[0] for r in rows], dtype=torch.int64),
        start_pos=f32(np.stack([r[1] for r in rows])),
        start_yaw=f32([r[2] for r in rows]),
        human_start=f32(np.stack([r[3] for r in rows])),
        waypoints=f32(np.stack([r[4] for r in rows])),
    )
    order = build_env_episode_order(episodes, num_envs, seed=seed)
    return SocialNavBatchedEnv(pack_scenes(scenes), table, order, device=device, **env_kw)
