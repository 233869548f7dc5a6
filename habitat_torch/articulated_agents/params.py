"""Robot parameter tables (port of ``habitat_tpu/articulated_agents/params.py``;
reference habitat-lab/habitat/articulated_agents/robots/: fetch_robot.py,
spot_robot.py, stretch_robot.py, franka_robot.py, each robot a
MobileManipulatorParams table; mobile_manipulator.py:19-33
ArticulatedAgentCameraParams).

Each robot is a fixed-topology serial arm spec for the batched FK in
kinematics.py: plain Python tables, no tensors. Link offsets are compact
approximations of the URDF chains."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArticulatedAgentCameraParams:
    """reference mobile_manipulator.py:19-33."""

    attached_link_id: int = -1  # -1 = base
    cam_offset_pos: Tuple[float, float, float] = (0.0, 1.25, 0.0)
    cam_look_at_pos: Tuple[float, float, float] = (0.0, 0.75, -1.0)
    relative_transform: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class MobileManipulatorParams:
    """Per-robot kinematic spec (reference manipulator/base param tables)."""

    name: str
    arm_joints: int
    # serial chain: per-joint (axis 'x'|'y'|'z', link offset xyz applied AFTER
    # the rotation) in the arm root frame
    joint_axes: Tuple[str, ...]
    link_offsets: Tuple[Tuple[float, float, float], ...]
    arm_root_offset: Tuple[float, float, float]  # base -> arm root
    joint_limits_lower: Tuple[float, ...]
    joint_limits_upper: Tuple[float, ...]
    resting_pose: Tuple[float, ...]
    gripper_joints: int = 2
    gripper_open_state: float = 0.04
    gripper_closed_state: float = 0.0
    base_height: float = 0.0
    base_radius: float = 0.3
    cameras: Dict[str, ArticulatedAgentCameraParams] = dataclasses.field(
        default_factory=dict
    )
    wheel_joints: int = 0
    leg_joints: int = 0


def _cams(head_h: float) -> Dict[str, ArticulatedAgentCameraParams]:
    return {
        "head": ArticulatedAgentCameraParams(
            cam_offset_pos=(0.0, head_h, 0.0),
            cam_look_at_pos=(0.0, head_h - 0.5, -1.0),
        ),
        "third": ArticulatedAgentCameraParams(
            cam_offset_pos=(-0.5, 1.7, 0.8), cam_look_at_pos=(0.0, 0.7, 0.0)
        ),
    }


FETCH = MobileManipulatorParams(
    name="fetch",
    arm_joints=7,
    joint_axes=("y", "x", "y", "x", "y", "x", "y"),
    link_offsets=(
        (0.12, 0.0, 0.0),
        (0.22, 0.0, 0.0),
        (0.13, 0.0, 0.0),
        (0.20, 0.0, 0.0),
        (0.12, 0.0, 0.0),
        (0.14, 0.0, 0.0),
        (0.16, 0.0, 0.0),
    ),
    arm_root_offset=(0.1, 0.9, 0.0),
    joint_limits_lower=(-1.6, -1.2, -3.1, -2.2, -3.1, -2.1, -3.1),
    joint_limits_upper=(1.6, 1.5, 3.1, 2.2, 3.1, 2.1, 3.1),
    resting_pose=(-0.45, -1.08, 0.1, 0.935, -0.001, 1.573, 0.005),
    base_radius=0.3,
    cameras=_cams(1.2),
)

SPOT = MobileManipulatorParams(
    name="spot",
    arm_joints=6,
    joint_axes=("y", "x", "x", "y", "x", "y"),
    link_offsets=(
        (0.25, 0.0, 0.0),
        (0.35, 0.0, 0.0),
        (0.1, 0.0, 0.0),
        (0.2, 0.0, 0.0),
        (0.1, 0.0, 0.0),
        (0.12, 0.0, 0.0),
    ),
    arm_root_offset=(0.3, 0.6, 0.0),
    joint_limits_lower=(-2.6, -3.1, 0.0, -2.8, -1.8, -2.9),
    joint_limits_upper=(3.1, 0.3, 3.1, 2.8, 1.8, 2.9),
    resting_pose=(0.0, -3.0, 3.0, 0.0, 0.0, 0.0),
    leg_joints=12,
    base_radius=0.4,
    cameras=_cams(0.6),
)

STRETCH = MobileManipulatorParams(
    name="stretch",
    arm_joints=5,  # lift + 4 telescoping (modeled as prismatic-ish small links)
    joint_axes=("z", "z", "z", "z", "y"),
    link_offsets=(
        (0.0, 0.25, 0.0),
        (0.0, 0.0, -0.13),
        (0.0, 0.0, -0.13),
        (0.0, 0.0, -0.13),
        (0.0, 0.0, -0.17),
    ),
    arm_root_offset=(-0.15, 0.5, 0.0),
    joint_limits_lower=(0.0, 0.0, 0.0, 0.0, -1.75),
    joint_limits_upper=(1.1, 0.13, 0.13, 0.13, 4.0),
    resting_pose=(0.6, 0.0, 0.0, 0.0, 0.0),
    base_radius=0.25,
    cameras=_cams(1.3),
)

FRANKA = MobileManipulatorParams(
    name="franka",
    arm_joints=7,
    joint_axes=("y", "x", "y", "x", "y", "x", "y"),
    link_offsets=(
        (0.0, 0.333, 0.0),
        (0.0, 0.0, 0.0),
        (0.0, 0.316, 0.0),
        (0.0825, 0.0, 0.0),
        (-0.0825, 0.384, 0.0),
        (0.0, 0.0, 0.0),
        (0.088, 0.107, 0.0),
    ),
    arm_root_offset=(0.0, 0.0, 0.0),
    joint_limits_lower=(-2.9, -1.76, -2.9, -3.07, -2.9, -0.02, -2.9),
    joint_limits_upper=(2.9, 1.76, 2.9, -0.07, 2.9, 3.75, 2.9),
    resting_pose=(0.0, -0.8, 0.0, -2.0, 0.0, 1.5, 0.8),
    base_radius=0.2,
    cameras=_cams(0.8),
)

ROBOTS: Dict[str, MobileManipulatorParams] = {
    "FetchRobot": FETCH,
    "SpotRobot": SPOT,
    "StretchRobot": STRETCH,
    "FrankaRobot": FRANKA,
}
