"""Batched functional environment (port of ``habitat_tpu/core/batched_env.py``).

All N envs are one set of tensors: ``EnvState`` holds (N, ...) tensors on the
env's device, ``reset_fn``/``step_fn`` compute every env at once, auto-reset
of finished envs is masking (``auto_reset_done=True``, the default), and
scene switching is indexing into the packed scene table. Without auto-reset
a finished env keeps its final state until ``reset_to_fn`` starts the
episodes given to it (the single-env ``core/env.py::Env`` path).

Actions are discrete (an index into the action list) unless the task
declares ``velocity_control`` (``tasks/nav.py::VelocityAction``): then each
env takes a (linear, angular) command in [-1, 1]^2, mapped onto the
action's speed ranges and integrated over its ``time_step`` as
``slide_substeps`` rotate-then-translate sub-moves, each one collision
step; both speeds under their minimums stop the episode.

Reward/done composition matches RLTaskEnv:
``reward = slack + reward_measure (+ success_reward if success)``,
``done = episode_over or (end_on_success and success)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.core.dataset import EpisodeTable
from habitat_torch.core.embodied_task import (
    FunctionalAction,
    FunctionalMeasure,
    FunctionalSensor,
    StepContext,
    order_measures,
)
from habitat_torch.ops import navgrid as ng
from habitat_torch.ops.raycast import render_batch
from habitat_torch.sims.scene import ScenePack
from habitat_torch.tasks.nav import DepthSensor, VisualSensorSpec
from habitat_torch.utils.geometry import yaw_to_forward


# channels and dtype of each frame render_batch returns
FRAME_LAYOUT = {"rgb": (3, torch.uint8), "depth": (1, torch.float32), "semantic": (1, torch.int32)}


@dataclasses.dataclass
class EnvState:
    """Batched env state (all N envs)."""

    ep_ptr: torch.Tensor  # (N,) i32 — position in the per-env episode order
    ep_idx: torch.Tensor  # (N,) i64 — current episode id
    step: torch.Tensor  # (N,) i32
    pos: torch.Tensor  # (N,3) f32
    yaw: torch.Tensor  # (N,) f32
    pitch: torch.Tensor  # (N,) f32
    prev_pos: torch.Tensor  # (N,3) f32
    stop_called: torch.Tensor  # (N,) bool
    collided: torch.Tensor  # (N,) bool — last step
    collision_count: torch.Tensor  # (N,) i32
    last_action: torch.Tensor  # (N,) i32
    episode_over: torch.Tensor  # (N,) bool
    episode_count: torch.Tensor  # (N,) i32 — completed episodes
    measure_state: Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RewardSpec:
    """RLTaskEnv reward composition."""

    reward_measure: str = "distance_to_goal_reward"
    success_measure: str = "success"
    slack_reward: float = -0.01
    success_reward: float = 2.5
    end_on_success: bool = True


class BatchedEnv:
    """N batched envs over a ScenePack + EpisodeTable on one device."""

    def __init__(
        self,
        pack: ScenePack,
        table: EpisodeTable,
        episode_order: np.ndarray,  # (N, L) int32 per-env episode schedule (global N)
        sensors: Sequence[FunctionalSensor],
        measures: Sequence[FunctionalMeasure],
        actions: Sequence[FunctionalAction],
        *,
        device: torch.device,
        rows: slice = slice(None),
        max_episode_steps: int = 500,
        reward_spec: RewardSpec = RewardSpec(),
        slide_substeps: int = 4,
        auto_reset_done: bool = True,
    ):
        self.device = device
        self.pack = pack.to(device)
        self.table = table.to(device)
        # the envs are ``rows`` of the global order (a DD-PPO rank's,
        # parallel/distributed.py::env_rows; all by default)
        episode_order = np.asarray(episode_order)[rows]
        self.order = torch.as_tensor(episode_order, dtype=torch.int64, device=device)
        self.num_envs = int(episode_order.shape[0])
        self._order_len = int(episode_order.shape[1])
        self._env_ids = torch.arange(self.num_envs, device=device)
        self.sensors = tuple(sensors)
        self.measures = order_measures(measures)
        self.actions = tuple(actions)
        self.action_names = tuple(a.name for a in self.actions)
        self.max_episode_steps = int(max_episode_steps)
        self.reward_spec = reward_spec
        self.slide_substeps = slide_substeps
        self.auto_reset_done = auto_reset_done

        def table_of(fn, dtype):
            return torch.tensor([fn(a) for a in self.actions], dtype=dtype, device=device)

        self._move_amt = table_of(lambda a: a.move_amount(), torch.float32)
        self._turn_amt = table_of(lambda a: a.turn_amount(), torch.float32)
        self._tilt_amt = table_of(lambda a: a.tilt_amount(), torch.float32)
        self._stop_flag = table_of(lambda a: a.is_stop(), torch.bool)

        self.state_sensors = tuple(
            s for s in self.sensors if not isinstance(s, VisualSensorSpec)
        )
        # render groups: one raycast per distinct camera model
        by_cam: Dict[Tuple, List[VisualSensorSpec]] = {}
        for s in self.sensors:
            if isinstance(s, VisualSensorSpec):
                key = (s.height, s.width, s.hfov, s.projection, s.position_y)
                by_cam.setdefault(key, []).append(s)
        self._render_groups = []
        for (h, w, hfov, proj, cam_y), group in by_cam.items():
            depth = next((s for s in group if isinstance(s, DepthSensor)), DepthSensor(None))
            self._render_groups.append(
                dict(
                    h=h, w=w, hfov=hfov, proj=proj,
                    cam_offset=torch.tensor([0.0, cam_y, 0.0], device=device),
                    uuids=tuple(s.uuid for s in group),
                    depth_cfg=(depth.min_depth, depth.max_depth, depth.normalize_depth),
                )
            )

        # velocity control: continuous (lin, ang) commands; the policy side
        # reads ``action_dim`` (no ``num_actions``), as for the rearrange
        # envs' continuous control
        self._vel_ctrl = next((a for a in self.actions if a.name == "velocity_control"), None)
        if self._vel_ctrl is not None:
            self.action_dim = 2
            self.action_shape: Tuple[int, ...] = (2,)
        else:
            self.num_actions = len(self.actions)
            self.action_shape = ()

        # what the policy reads (the JAX package's observation_space): the
        # state sensors' shapes from one fresh state, the frames' from their
        # render groups, so building the env renders nothing
        ctx = self._make_ctx(self._fresh_state())
        shapes = {}
        for s in self.state_sensors:
            v = s.compute(ctx)
            shapes[s.uuid] = (tuple(v.shape[1:]), v.dtype)
        for g in self._render_groups:
            for uuid in g["uuids"]:
                channels, dtype = FRAME_LAYOUT[uuid]
                shapes[uuid] = ((g["h"], g["w"], channels), dtype)
        self.observation_shapes = shapes

    # ------------------------------------------------------------------

    def _make_ctx(self, state: EnvState) -> StepContext:
        return StepContext(
            pack=self.pack,
            table=self.table,
            ep_idx=state.ep_idx,
            sid=self.table.scene_idx[state.ep_idx].long(),
            pos=state.pos,
            yaw=state.yaw,
            pitch=state.pitch,
            prev_pos=state.prev_pos,
            start_pos=self.table.start_pos[state.ep_idx],
            start_yaw=self.table.start_yaw[state.ep_idx],
            step=state.step,
            action=state.last_action,
            stop_called=state.stop_called,
            collided=state.collided,
            collision_count=state.collision_count,
        )

    def _observations(self, state: EnvState) -> Dict[str, torch.Tensor]:
        ctx = self._make_ctx(state)
        obs = {s.uuid: s.compute(ctx) for s in self.state_sensors}
        for g in self._render_groups:
            mn, mx, norm = g["depth_cfg"]
            frames = render_batch(
                self.pack,
                ctx.sid,
                state.pos + g["cam_offset"],
                state.yaw,
                state.pitch,
                height=g["h"],
                width=g["w"],
                hfov_deg=g["hfov"],
                min_depth=mn,
                max_depth=mx,
                normalize_depth=norm,
                projection=g["proj"],
            )
            for uuid in g["uuids"]:
                obs[uuid] = frames[uuid]
        return obs

    def _reset_measures(self, state: EnvState) -> Dict[str, Dict[str, torch.Tensor]]:
        ctx = self._make_ctx(state)
        return {m.uuid: m.reset(ctx)[0] for m in self.measures}

    def _fresh_state(self, ep_idx: Optional[torch.Tensor] = None) -> EnvState:
        """Every env at the start of episode ``ep_idx`` (default: its first
        in the order), measures not reset."""
        n, dev = self.num_envs, self.device
        if ep_idx is None:
            ep_idx = self.order[self._env_ids, 0]
        pos = self.table.start_pos[ep_idx]
        return EnvState(
            ep_ptr=torch.zeros(n, dtype=torch.int32, device=dev),
            ep_idx=ep_idx,
            step=torch.zeros(n, dtype=torch.int32, device=dev),
            pos=pos,
            yaw=self.table.start_yaw[ep_idx],
            pitch=torch.zeros(n, device=dev),
            prev_pos=pos,
            stop_called=torch.zeros(n, dtype=torch.bool, device=dev),
            collided=torch.zeros(n, dtype=torch.bool, device=dev),
            collision_count=torch.zeros(n, dtype=torch.int32, device=dev),
            last_action=torch.full((n,), -1, dtype=torch.int32, device=dev),
            episode_over=torch.zeros(n, dtype=torch.bool, device=dev),
            episode_count=torch.zeros(n, dtype=torch.int32, device=dev),
            measure_state={},
        )

    def reset_fn(self) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        state = self._fresh_state()
        state.measure_state = self._reset_measures(state)
        return state, self._observations(state)

    def reset_to_fn(self, ep_idx) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        """Every env at the start of the episode ``ep_idx`` (N,) names, with
        fresh measures and its observations (one render); nothing of an
        earlier state carries over."""
        state = self._fresh_state(torch.as_tensor(ep_idx, device=self.device).long())
        state.measure_state = self._reset_measures(state)
        return state, self._observations(state)

    def measure_values(self, state: EnvState) -> Dict[str, torch.Tensor]:
        """The measures' current values, without stepping (what
        ``Env.get_metrics`` reports after a reset)."""
        ctx = self._make_ctx(state)
        values: Dict[str, torch.Tensor] = {}
        for m in self.measures:
            values[m.uuid] = m.update(state.measure_state[m.uuid], ctx, values)[1]
        return values

    def _velocity_move(self, state: EnvState, sid: torch.Tensor, actions: torch.Tensor):
        """(stop, yaw, new_pos, collided) of a velocity command per env:
        the JAX package's arithmetic, in float32."""
        vc = self._vel_ctrl
        acts = actions.float().clamp(-1.0, 1.0)
        lo_l, hi_l = float(vc.lin_vel_range[0]), float(vc.lin_vel_range[1])
        lo_a, hi_a = float(vc.ang_vel_range[0]), float(vc.ang_vel_range[1])
        lin_v = lo_l + (acts[:, 0] + 1.0) * 0.5 * (hi_l - lo_l)
        ang_v_rad = torch.deg2rad(lo_a + (acts[:, 1] + 1.0) * 0.5 * (hi_a - lo_a))
        dt = float(vc.time_step)
        auto_stop = (lin_v.abs() < float(vc.min_abs_lin_speed)) & (
            ang_v_rad.abs() < float(np.deg2rad(float(vc.min_abs_ang_speed))))
        nsub = max(self.slide_substeps, 1)
        yaw, new_pos = state.yaw, state.pos
        collided = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        for _ in range(nsub):
            yaw = yaw + ang_v_rad * (dt / nsub)
            target = new_pos + yaw_to_forward(yaw) * (lin_v * dt / nsub)[:, None]
            new_pos, c = ng.try_step(self.pack, sid, new_pos, target, 1)
            collided = collided | c
        collided = collided & (lin_v.abs() * dt > 1e-6)
        return state.stop_called | auto_stop, yaw, new_pos, collided

    def step_fn(
        self, state: EnvState, actions: torch.Tensor
    ) -> Tuple[EnvState, Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """One batched step, with auto-reset of done envs when
        ``auto_reset_done``. Returns (state, obs, reward, done, info); the
        input state is not modified."""
        sid = self.table.scene_idx[state.ep_idx].long()
        if self._vel_ctrl is not None:
            stop, yaw, new_pos, collided = self._velocity_move(state, sid, actions)
            pitch = state.pitch
            a32 = torch.zeros(self.num_envs, dtype=torch.int32, device=self.device)
        else:
            a = actions.long()
            stop = state.stop_called | self._stop_flag[a]
            yaw = state.yaw + self._turn_amt[a]
            pitch = (state.pitch + self._tilt_amt[a]).clamp(-np.pi / 2, np.pi / 2)
            move = self._move_amt[a]
            target = state.pos + yaw_to_forward(yaw) * move[:, None]
            new_pos, collided = ng.try_step(self.pack, sid, state.pos, target, self.slide_substeps)
            moved = move > 0
            collided = collided & moved
            new_pos = torch.where(moved[:, None], new_pos, state.pos)
            a32 = a.to(torch.int32)

        step = state.step + 1
        state = dataclasses.replace(
            state,
            pos=new_pos,
            yaw=yaw,
            pitch=pitch,
            prev_pos=state.pos,
            stop_called=stop,
            collided=collided,
            collision_count=state.collision_count + collided.to(torch.int32),
            last_action=a32,
            step=step,
        )

        # measures in dependency order
        ctx = self._make_ctx(state)
        values: Dict[str, torch.Tensor] = {}
        new_mstate: Dict[str, Dict[str, torch.Tensor]] = {}
        for m in self.measures:
            ms, v = m.update(state.measure_state[m.uuid], ctx, values)
            new_mstate[m.uuid] = ms
            values[m.uuid] = v

        episode_over = stop | (step >= self.max_episode_steps)
        rs = self.reward_spec
        success_val = values.get(rs.success_measure, torch.zeros_like(step, dtype=torch.float32))
        is_success = success_val > 0
        done = episode_over | is_success if rs.end_on_success else episode_over
        reward = (
            rs.slack_reward
            + values.get(rs.reward_measure, torch.zeros_like(success_val))
            + rs.success_reward * is_success.float()
        )
        info = dict(values)
        info["is_collision"] = collided.float()

        if not self.auto_reset_done:
            state = dataclasses.replace(state, episode_over=episode_over, measure_state=new_mstate)
            return state, self._observations(state), reward, done, info

        # ---- auto-reset done envs ----
        ep_ptr = torch.where(done, state.ep_ptr + 1, state.ep_ptr)
        ep_idx = self.order[self._env_ids, (ep_ptr % self._order_len).long()]
        rpos = self.table.start_pos[ep_idx]
        ryaw = self.table.start_yaw[ep_idx]
        d1 = done[:, None]
        state = dataclasses.replace(
            state,
            ep_ptr=ep_ptr,
            ep_idx=ep_idx,
            step=torch.where(done, 0, step),
            pos=torch.where(d1, rpos, state.pos),
            yaw=torch.where(done, ryaw, yaw),
            pitch=torch.where(done, 0.0, pitch),
            prev_pos=torch.where(d1, rpos, state.prev_pos),
            stop_called=stop & ~done,
            collided=collided & ~done,
            collision_count=torch.where(done, 0, state.collision_count),
            last_action=torch.where(done, -1, a32),
            episode_over=episode_over,
            episode_count=state.episode_count + done.to(torch.int32),
            measure_state=new_mstate,
        )
        # merge measure reset state for done envs
        reset_ms = self._reset_measures(state)
        state.measure_state = {
            uuid: {
                k: torch.where(done.reshape(-1, *([1] * (r.dim() - 1))), r, new_mstate[uuid][k])
                for k, r in rms.items()
            }
            for uuid, rms in reset_ms.items()
        }
        return state, self._observations(state), reward, done, info

    # ------------------------------------------------------------------
    # host conveniences

    def reset(self, seed: int = 0):
        """``reset_fn()``; ``seed`` is accepted for the JAX package's
        signature (no nav component draws from a key)."""
        return self.reset_fn()

    def step(self, state: EnvState, actions):
        return self.step_fn(state, torch.as_tensor(actions, device=self.device))

    def get_metrics(self, info) -> Dict[str, np.ndarray]:
        """Host view of the last info dict."""
        return {k: v.cpu().numpy() for k, v in info.items()}
