"""HITL GUI/policy controllers (port of ``habitat_tpu/hitl/controllers.py``;
reference habitat-hitl/habitat_hitl/
environment/controllers/: controller_abc.py, gui_controller.py 471 LoC,
controller_helper.py 224 LoC).

The reference maps each agent of a multi-agent env to a Controller: GUI
controllers translate keyboard/VR input into that agent's action vector,
BaselinesController runs a trained policy, and ControllerHelper composes the
per-agent action dict for env.step. Here the env is the batched rearrange
env (`habitat_torch/tasks/rearrange/rearrange_env.py`), whose continuous
action layouts are those of `habitat_tpu/tasks/rearrange/rearrange_env.py:274-299`:

  control='continuous': [fwd, turn, grip]           (3,)
  control='arm':        [dq_0..dq_6, fwd, turn, grip] (n_joints+3,)
  discrete:             REARRANGE_ACTION_NAMES index

Act hints mirror the reference `set_act_hints(walk_dir,
distance_multiplier, grasp_obj_idx, do_drop, ...)` surface so app states
written against the reference API port over unchanged.

The controllers read the env's state as the port keeps it: ``state.yaw``
and ``state.human_yaw`` are tensors on the env's device, and an act that
needs one copies that one element to the host.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np


class Controller(ABC):
    """reference controller_abc.py::Controller."""

    def __init__(self, is_multi_agent: bool = False):
        self._is_multi_agent = is_multi_agent

    @abstractmethod
    def act(self, obs, env):
        ...

    def on_environment_reset(self) -> None:
        pass


class GuiController(Controller):
    """reference controller_abc.py::GuiController."""

    def __init__(self, agent_idx: int, is_multi_agent: bool, gui_input):
        super().__init__(is_multi_agent)
        self._agent_idx = agent_idx
        self._gui_input = gui_input


def angle_from_dir_a_to_b(a: np.ndarray, b: np.ndarray) -> float:
    """Signed yaw-plane angle from direction a to b (reference
    gui_controller.py:87-103; +z-handed like the navgrid frame)."""
    a = a / (np.linalg.norm(a) + 1e-9)
    b = b / (np.linalg.norm(b) + 1e-9)
    dot = float(np.clip(np.dot(a, b), -1.0, 1.0))
    ang = float(np.arccos(dot))
    det = a[0] * b[2] - a[2] * b[0]
    return ang if det >= 0 else -ang


class GuiRobotController(GuiController):
    """Keyboard/VR -> robot action vector (reference gui_controller.py:21).

    W/S walk, the turn channel servos the base toward `cam_yaw` (the
    camera-follow convention, gui_controller.py:105-137); arm joints hold
    unless `reach_pos` hints drive them (not in the reference robot
    controller either — kept NotImplemented-parity: grasp/drop hints assert
    None exactly like the reference)."""

    def __init__(
        self,
        agent_idx: int,
        is_multi_agent: bool,
        gui_input,
        num_actions: int,
        base_vel_action_idx: int = 0,
        num_base_vel_actions: int = 2,
        turn_scale: float = 0.3,
    ):
        super().__init__(agent_idx, is_multi_agent, gui_input)
        self._num_actions = num_actions
        self._base_vel_action_idx = base_vel_action_idx
        self._num_base_vel_actions = num_base_vel_actions
        self._turn_scale = turn_scale
        self._cam_yaw: Optional[float] = None
        self._hint_walk_dir = None
        self._hint_distance_multiplier = None
        self._hint_target_dir = None

    def set_act_hints(
        self,
        walk_dir,
        distance_multiplier,
        grasp_obj_idx,
        do_drop,
        cam_yaw=None,
        throw_vel=None,
        reach_pos=None,
        hand_idx=None,
        target_dir=None,
    ):
        assert throw_vel is None or do_drop is None
        # grasp/drop/throw/reach unsupported in the robot GUI controller —
        # same contract as reference gui_controller.py:65-73
        assert grasp_obj_idx is None and do_drop is None
        assert throw_vel is None and reach_pos is None and hand_idx is None
        self._hint_walk_dir = walk_dir
        self._hint_distance_multiplier = distance_multiplier
        self._cam_yaw = cam_yaw
        self._hint_target_dir = target_dir

    def act(self, obs, env) -> np.ndarray:
        action = np.zeros((self._num_actions,), np.float32)
        base = np.zeros((self._num_base_vel_actions,), np.float32)
        gui = self._gui_input
        if gui.get_key("w"):
            base[0] += 1.0
        if gui.get_key("s"):
            base[0] -= 1.0
        if self._cam_yaw is not None:
            yaw = None
            state = getattr(env, "_state", None)
            if state is not None and hasattr(state, "yaw"):
                yaw = float(state.yaw[self._agent_idx])  # one host copy
            if yaw is not None:
                fwd = np.array([np.cos(yaw), 0.0, np.sin(yaw)])
                tgt = np.array(
                    [np.cos(self._cam_yaw + np.pi), 0.0, np.sin(self._cam_yaw + np.pi)]
                )
                base[1] = -angle_from_dir_a_to_b(fwd, tgt) * self._turn_scale
        else:
            if gui.get_key("a"):
                base[1] += 1.0
            if gui.get_key("d"):
                base[1] -= 1.0
        i = self._base_vel_action_idx
        action[i : i + self._num_base_vel_actions] = np.clip(base, -1.0, 1.0)
        return action


class GuiHumanoidController(GuiController):
    """Keyboard/VR -> humanoid walk + grasp (reference gui_controller.py:146).

    The reference drives a mocap HumanoidRearrangeController; here the
    humanoid is the scripted walker of the social-nav/rearrange envs, so the
    controller emits [fwd, turn, grip] plus tracks the grasp hint state
    machine (grasp_obj_idx -> hold, do_drop -> release) that
    AppStateRearrange-style apps use."""

    def __init__(self, agent_idx: int, is_multi_agent: bool, gui_input,
                 num_actions: int = 3):
        super().__init__(agent_idx, is_multi_agent, gui_input)
        self._num_actions = num_actions
        self._hint_walk_dir = None
        self._hint_distance_multiplier = 1.0
        self._grasp_obj_idx: Optional[int] = None
        self._do_drop = None
        self._grasped = False

    def set_act_hints(
        self,
        walk_dir,
        distance_multiplier,
        grasp_obj_idx,
        do_drop,
        cam_yaw=None,
        throw_vel=None,
        reach_pos=None,
        hand_idx=None,
        target_dir=None,
    ):
        assert throw_vel is None or do_drop is None
        self._hint_walk_dir = walk_dir
        self._hint_distance_multiplier = (
            1.0 if distance_multiplier is None else distance_multiplier
        )
        self._grasp_obj_idx = grasp_obj_idx
        self._do_drop = do_drop

    @property
    def is_grasped(self) -> bool:
        return self._grasped

    def on_environment_reset(self) -> None:
        self._grasped = False
        self._grasp_obj_idx = None
        self._do_drop = None

    def act(self, obs, env) -> np.ndarray:
        action = np.zeros((self._num_actions,), np.float32)
        gui = self._gui_input
        fwd = 1.0 if gui.get_key("w") else 0.0
        turn = (1.0 if gui.get_key("a") else 0.0) - (1.0 if gui.get_key("d") else 0.0)
        if self._hint_walk_dir is not None:
            wd = np.asarray(self._hint_walk_dir, np.float32)
            yaw = 0.0
            state = getattr(env, "_state", None)
            if state is not None and hasattr(state, "human_yaw"):
                yaw = float(state.human_yaw[0])  # one host copy
            heading = np.array([np.cos(yaw), 0.0, np.sin(yaw)])
            turn = -angle_from_dir_a_to_b(heading, wd)
            fwd = float(self._hint_distance_multiplier)
        grip = 0.0
        if self._grasp_obj_idx is not None and not self._grasped:
            grip = 1.0
            self._grasped = True
            self._grasp_obj_idx = None
        elif self._do_drop is not None and self._grasped:
            grip = -1.0
            self._grasped = False
            self._do_drop = None
        elif self._grasped:
            grip = 1.0
        action[0] = np.clip(fwd, -1.0, 1.0)
        action[1] = np.clip(turn, -1.0, 1.0)
        if self._num_actions >= 3:
            action[2] = grip
        return action


class ControllerHelper:
    """Builds and steps the per-agent controller set (reference
    controller_helper.py: gui-controlled agent index from config, policy
    controllers for the rest, update() -> the env action).

    For single-agent envs the composed action is the controller's vector;
    for multi-agent it is a dict {f"agent_{i}": vec} matching the
    TwoAgentPPOLearner/multi-agent env conventions."""

    def __init__(
        self,
        env,
        gui_input,
        n_agents: int = 1,
        gui_controlled_agent_index: Optional[int] = 0,
        agent_action_dims: Optional[List[int]] = None,
        policy_controllers: Optional[Dict[int, Controller]] = None,
        humanoid_agent_indices: Optional[List[int]] = None,
    ):
        self._env = env
        self.n_agents = n_agents
        self.gui_agent_idx = gui_controlled_agent_index
        dims = agent_action_dims or [3] * n_agents
        humanoids = set(humanoid_agent_indices or [])
        self.controllers: List[Controller] = []
        policy_controllers = policy_controllers or {}
        for i in range(n_agents):
            if i == gui_controlled_agent_index:
                cls = GuiHumanoidController if i in humanoids else GuiRobotController
                self.controllers.append(
                    cls(i, n_agents > 1, gui_input, num_actions=dims[i])
                )
            elif i in policy_controllers:
                self.controllers.append(policy_controllers[i])
            else:
                self.controllers.append(_IdleController(dims[i]))

    def get_gui_agent_controller(self) -> Optional[Controller]:
        if self.gui_agent_idx is None:
            return None
        return self.controllers[self.gui_agent_idx]

    def get_gui_controlled_agent_index(self) -> Optional[int]:
        return self.gui_agent_idx

    def update(self, obs) -> Any:
        acts = [c.act(obs, self._env) for c in self.controllers]
        if self.n_agents == 1:
            return acts[0]
        return {f"agent_{i}": a for i, a in enumerate(acts)}

    def on_environment_reset(self) -> None:
        for c in self.controllers:
            c.on_environment_reset()


class _IdleController(Controller):
    """Zero-action filler for agents with no GUI or policy attached."""

    def __init__(self, num_actions: int):
        super().__init__(True)
        self._num_actions = num_actions

    def act(self, obs, env):
        return np.zeros((self._num_actions,), np.float32)
