"""Manipulator and MobileManipulator host classes (port of
``habitat_tpu/articulated_agents/manipulator.py``).

Counterparts of reference articulated_agents/manipulator.py:19 (URDF load,
joint motors, EE state, gripper logic), articulated_agent_base.py and
mobile_manipulator.py. The host API is numpy in, numpy out; the kinematics
run on ``device`` (``None`` is the card) through kinematics.py.
"""

from __future__ import annotations

import numpy as np
import torch

from habitat_torch.articulated_agents.kinematics import (
    ee_chain,
    ee_position,
    ee_position_world,
    ik_solve,
    ik_solve_chain,
)
from habitat_torch.articulated_agents.params import ROBOTS, MobileManipulatorParams
from habitat_torch.articulated_agents.urdf import load_chain
from habitat_torch.device import resolve_device


class Manipulator:
    """reference manipulator.py: arm joint get/set, EE transform, gripper."""

    def __init__(self, params: MobileManipulatorParams, device=None):
        self.params = params
        self.device = resolve_device(device)
        self._joints = np.asarray(params.resting_pose, np.float32)
        self._gripper = params.gripper_open_state

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # -- joints ----------------------------------------------------------
    @property
    def arm_joint_pos(self) -> np.ndarray:
        return self._joints.copy()

    @arm_joint_pos.setter
    def arm_joint_pos(self, q) -> None:
        lo = np.asarray(self.params.joint_limits_lower)
        hi = np.asarray(self.params.joint_limits_upper)
        self._joints = np.clip(np.asarray(q, np.float32), lo, hi)

    @property
    def arm_motor_pos(self) -> np.ndarray:
        return self.arm_joint_pos

    @arm_motor_pos.setter
    def arm_motor_pos(self, q) -> None:
        self.arm_joint_pos = q

    def reset(self) -> None:
        self._joints = np.asarray(self.params.resting_pose, np.float32)
        self.open_gripper()

    # -- EE ----------------------------------------------------------------
    @property
    def ee_local_pos(self) -> np.ndarray:
        return ee_position(self.params, self._tensor(self._joints)).cpu().numpy()

    def ee_world_pos(self, base_pos, base_yaw) -> np.ndarray:
        return ee_position_world(
            self.params, self._tensor(self._joints), self._tensor(base_pos), self._tensor(base_yaw)
        ).cpu().numpy()

    def calculate_ee_inverse_kinematics(self, target_local) -> np.ndarray:
        return ik_solve(self.params, self._tensor(target_local), self._tensor(self._joints)).cpu().numpy()

    # -- gripper -------------------------------------------------------------
    def open_gripper(self) -> None:
        self._gripper = self.params.gripper_open_state

    def close_gripper(self) -> None:
        self._gripper = self.params.gripper_closed_state

    @property
    def is_gripper_open(self) -> bool:
        return abs(self._gripper - self.params.gripper_open_state) < 1e-3


class UrdfManipulator(Manipulator):
    """Manipulator whose kinematics come from a parsed URDF chain instead of
    a hand-written param table (reference manipulator.py:79-120 loads the
    URDF into Bullet; here `urdf.load_chain` + `kinematics.fk_chain`)."""

    def __init__(self, urdf_path: str, base_link=None, ee_link=None, device=None):
        self.chain = load_chain(urdf_path, base_link=base_link, ee_link=ee_link)
        J = self.chain.num_joints
        rest = np.clip(np.zeros(J), self.chain.lower, self.chain.upper)
        params = MobileManipulatorParams(
            name=self.chain.name,
            arm_joints=J,
            joint_axes=tuple("x" * J),  # unused by the chain path
            link_offsets=tuple((0.0, 0.0, 0.0) for _ in range(J)),
            arm_root_offset=(0.0, 0.0, 0.0),
            joint_limits_lower=tuple(float(v) for v in self.chain.lower),
            joint_limits_upper=tuple(float(v) for v in self.chain.upper),
            resting_pose=tuple(float(v) for v in rest),
        )
        super().__init__(params, device=device)

    @property
    def ee_local_pos(self) -> np.ndarray:
        return ee_chain(self.chain, self._tensor(self._joints)).cpu().numpy()

    def calculate_ee_inverse_kinematics(self, target_local) -> np.ndarray:
        return ik_solve_chain(self.chain, self._tensor(target_local), self._tensor(self._joints)).cpu().numpy()


class MobileManipulator(Manipulator):
    """Base pose + arm (reference mobile_manipulator.py)."""

    def __init__(self, params: MobileManipulatorParams, device=None):
        super().__init__(params, device=device)
        self.base_pos = np.zeros(3, np.float32)
        self.base_rot = 0.0  # yaw

    @property
    def ee_pos(self) -> np.ndarray:
        return self.ee_world_pos(self.base_pos, self.base_rot)


class StaticManipulator(Manipulator):
    """reference static_manipulator.py (fixed base)."""


def make_robot(name: str, device=None) -> MobileManipulator:
    """Robot factory by reference class name (FetchRobot, SpotRobot, ...)."""
    return MobileManipulator(ROBOTS[name], device=device)


class FetchRobot(MobileManipulator):
    def __init__(self, device=None):
        super().__init__(ROBOTS["FetchRobot"], device=device)


class SpotRobot(MobileManipulator):
    def __init__(self, device=None):
        super().__init__(ROBOTS["SpotRobot"], device=device)


class StretchRobot(MobileManipulator):
    def __init__(self, device=None):
        super().__init__(ROBOTS["StretchRobot"], device=device)


class FrankaRobot(StaticManipulator):
    def __init__(self, device=None):
        super().__init__(ROBOTS["FrankaRobot"], device=device)
