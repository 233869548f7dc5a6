"""The kinematic humanoid and its controllers (port of
``habitat_tpu/articulated_agents/humanoid.py``; reference
articulated_agents/humanoids/kinematic_humanoid.py and
articulated_agent_controllers/).

Host code in numpy, as in the JAX package: a controller holds one
humanoid's pose (17 joint quaternions in (x, y, z, w) order and a 4x4 root
transform) and advances it a frame at a time; the batched envs read only the
root. A mocap clip (the reference's walk-pose pickle layout, or an ``.npz``
of the same fields) drives the walk through ``load_motion``; without one the
walk is a procedural gait, a sinusoid of the phase over the legs and arms.
Reaching blends the poses of a grid of hand targets trilinearly
(``ReachPoseGrid``); without reach data the grid comes from a two-link
analytic arm.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

NUM_JOINTS = 17  # the reduced SMPL-X body
_DIST_TO_STOP = 1e-9


def _yaw_matrix(yaw: float) -> np.ndarray:
    """Rotation about +Y by ``yaw`` (forward is -z)."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _heading(d: np.ndarray) -> float:
    """The yaw that faces direction ``d``."""
    return float(np.arctan2(-d[0], -d[2]))


class Motion:
    """A mocap clip: per-frame joint quaternions (T, J, 4), root transforms
    (T, 4, 4), its frame rate and the cumulative root displacement (T,),
    which defaults to the arc length of the root's translation."""

    def __init__(self, joints_quat: np.ndarray, transforms: np.ndarray, fps: float,
                 displacement: Optional[np.ndarray] = None):
        self.poses = np.asarray(joints_quat, np.float32)
        self.transforms = np.asarray(transforms, np.float32)
        self.fps = float(fps)
        self.num_poses = len(self.poses)
        if displacement is None:
            steps = np.linalg.norm(np.diff(self.transforms[:, :3, 3], axis=0), axis=-1)
            displacement = np.concatenate([[0.0], np.cumsum(steps)])
        self.displacement = np.asarray(displacement, np.float32)

    @property
    def dist_per_step_size(self) -> float:
        return float(self.displacement[-1]) / max(1, self.num_poses)


def load_motion(path: str, key: str = "walk_motion") -> Motion:
    """A clip from a pickle in the reference's walk-pose layout (a dict whose
    ``key`` entry holds joints_quat_array, transform_array, fps and
    displacement; humanoid_rearrange_controller.py:82-98) or from an ``.npz``
    with those fields. Flat (T, J*4) joint arrays are reshaped."""
    if path.endswith(".npz"):
        data = dict(np.load(path))
    else:
        import pickle

        with open(path, "rb") as f:
            raw = pickle.load(f)
        data = raw.get(key, raw) if isinstance(raw, dict) else raw
    if key in data and isinstance(data[key], dict):
        data = data[key]
    joints = np.asarray(data["joints_quat_array"], np.float32)
    if joints.ndim == 2:
        joints = joints.reshape(len(joints), -1, 4)
    fps = float(np.asarray(data.get("fps", 30.0)).reshape(-1)[0])
    return Motion(joints, np.asarray(data["transform_array"], np.float32), fps, data.get("displacement"))


class HumanoidBaseController:
    """One humanoid's pose: identity joint quaternions and the root
    transform given at ``reset`` (reference humanoid_base_controller.py)."""

    def __init__(self, motion_fps: float = 30.0, base_offset=(0, 0.9, 0)):
        self.motion_fps = motion_fps
        self.base_offset = np.asarray(base_offset)
        self.obj_transform_base = np.eye(4)
        self.joint_pose = np.zeros((NUM_JOINTS, 4), np.float32)
        self.joint_pose[:, 3] = 1.0

    def reset(self, base_transformation: np.ndarray) -> None:
        self.obj_transform_base = np.asarray(base_transformation)

    def get_pose(self) -> np.ndarray:
        """The flat pose, joint quaternions then the root transform: what
        ``HumanoidJointAction`` reads (reference get_pose)."""
        return np.concatenate([self.joint_pose.reshape(-1), self.obj_transform_base.reshape(-1)])


def _nlerp(quats: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Weighted quaternion blend: each quaternion flipped to the first one's
    hemisphere, summed with ``weights`` and renormalised. quats (K, J, 4),
    weights (K,) -> (J, 4) float32."""
    sign = np.where(np.sum(quats * quats[0][None], axis=-1, keepdims=True) < 0, -1.0, 1.0)
    q = np.sum(quats * sign * weights[:, None, None], axis=0)
    return (q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)).astype(np.float32)


class ReachPoseGrid:
    """Full-body poses over a 3D grid of hand targets in the root frame
    (reference hand_processed_data); ``blend`` interpolates the 8 corners of
    the target's cell."""

    def __init__(self, xs, ys, zs, poses):
        self.xs = np.asarray(xs, np.float32)
        self.ys = np.asarray(ys, np.float32)
        self.zs = np.asarray(zs, np.float32)
        self.poses = np.asarray(poses, np.float32)  # (Gx, Gy, Gz, J, 4)

    @classmethod
    def synthetic(cls, index_hand: int = 0, n: int = 5) -> "ReachPoseGrid":
        """An n^3 grid from a two-link arm: shoulder pitch from the target's
        height, yaw from its bearing, the elbow bent by its distance."""
        xs, ys, zs = np.linspace(-0.6, 0.6, n), np.linspace(0.2, 1.6, n), np.linspace(-0.8, 0.0, n)
        poses = np.zeros((n, n, n, NUM_JOINTS, 4), np.float32)
        poses[..., 3] = 1.0
        arm_j = 11 + 3 * index_hand
        for i, x in enumerate(xs):
            for j, y in enumerate(ys):
                for k, z in enumerate(zs):
                    pitch = np.clip(y - 0.9, -1.2, 1.2)
                    yaw = np.clip(np.arctan2(x, max(-z, 1e-3)), -1.2, 1.2)
                    elbow = np.clip(1.6 * (1.0 - np.sqrt(x * x + (y - 0.9) ** 2 + z * z) / 0.8), 0.0, 1.5)
                    for a, ang in enumerate((pitch, yaw, elbow)):
                        poses[i, j, k, arm_j + a, 0] = np.sin(ang / 2)
                        poses[i, j, k, arm_j + a, 3] = np.cos(ang / 2)
        return cls(xs, ys, zs, poses)

    def blend(self, target_rel: np.ndarray) -> np.ndarray:
        """The trilinear blend at a hand target (root frame), clamped to the
        grid: (J, 4)."""
        idx, frac = [], []
        for axis, v in zip((self.xs, self.ys, self.zs), np.asarray(target_rel, np.float64)):
            v = np.clip(v, axis[0], axis[-1])
            i = int(np.clip(np.searchsorted(axis, v) - 1, 0, len(axis) - 2))
            idx.append(i)
            frac.append((v - axis[i]) / max(axis[i + 1] - axis[i], 1e-9))
        (i, j, k), (fx, fy, fz) = idx, frac
        corners, weights = [], []
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corners.append(self.poses[i + dx, j + dy, k + dz])
                    weights.append((fx if dx else 1 - fx) * (fy if dy else 1 - fy) * (fz if dz else 1 - fz))
        return _nlerp(np.stack(corners), np.asarray(weights))


class HumanoidRearrangeController(HumanoidBaseController):
    """Walk, turn, stop and reach (reference
    humanoid_rearrange_controller.py:52; thresholds :23-30). With
    ``walk_pose_path`` the walk plays the clip's frames at the distance
    walked; without it the gait is procedural at 1.6 cycles per second."""

    def __init__(self, walk_pose_path: Optional[str] = None, motion_fps: float = 30.0):
        super().__init__(motion_fps)
        self._phase = 0.0
        self.turning_step_amount = 20  # degrees per turn step
        self.stop_distance = 0.2
        self.walk_speed = 1.0  # m/s
        self.walk_motion: Optional[Motion] = None
        self._motion_frame = 0
        if walk_pose_path is not None:
            self.walk_motion = load_motion(walk_pose_path)
            self.walk_speed = self.walk_motion.dist_per_step_size * self.motion_fps
        self._reach_grids = {0: ReachPoseGrid.synthetic(0), 1: ReachPoseGrid.synthetic(1)}

    def calculate_stop_pose(self) -> None:
        self.joint_pose[:] = 0.0
        self.joint_pose[:, 3] = 1.0

    def calculate_turn_pose(self, target_direction: np.ndarray) -> None:
        self.obj_transform_base = self.obj_transform_base.copy()
        self.obj_transform_base[:3, :3] = _yaw_matrix(_heading(target_direction))
        self._swing(0.3)

    def calculate_walk_pose(self, target_direction: np.ndarray, distance_multiplier: float = 1.0) -> None:
        """One frame toward ``target_direction``: the root moves by
        min(walk speed / fps, distance) times ``distance_multiplier`` and
        turns to face it; a zero direction stops."""
        d = np.asarray(target_direction, np.float64)
        dist = np.linalg.norm(d[[0, 2]])
        if dist < _DIST_TO_STOP:
            self.calculate_stop_pose()
            return
        step = min(self.walk_speed / self.motion_fps, dist) * distance_multiplier
        dirn = d / (np.linalg.norm(d) + 1e-9)
        self.obj_transform_base = self.obj_transform_base.copy()
        self.obj_transform_base[:3, 3] += dirn * step
        self.obj_transform_base[:3, :3] = _yaw_matrix(_heading(dirn))
        if self.walk_motion is not None:
            # as many frames as the clip needs to cover the step
            m = self.walk_motion
            adv = max(1, int(round(step / max(m.dist_per_step_size, 1e-6))))
            self._motion_frame = (self._motion_frame + adv) % m.num_poses
            self.joint_pose = m.poses[self._motion_frame].copy()
            return
        self._phase = (self._phase + 2 * np.pi * 1.6 / self.motion_fps) % (2 * np.pi)
        self._swing(1.0)

    def calculate_reach_pose(self, target: np.ndarray, index_hand: int = 0) -> None:
        """Reach a world point: the grid's blend at the target in the root
        frame, spliced into the reaching arm's three joints."""
        rel = self.obj_transform_base[:3, :3].T @ (np.asarray(target, np.float64) - self.obj_transform_base[:3, 3])
        blended = self._reach_grids[index_hand].blend(rel)
        arm_j = 11 + 3 * index_hand
        self.joint_pose = self.joint_pose.copy()
        self.joint_pose[arm_j:arm_j + 3] = blended[arm_j:arm_j + 3]

    def calculate_walk_and_reach_pose(self, target_direction: np.ndarray, reach_target: np.ndarray,
                                      index_hand: int = 0, distance_multiplier: float = 1.0) -> None:
        self.calculate_walk_pose(target_direction, distance_multiplier)
        self.calculate_reach_pose(reach_target, index_hand)

    def _swing(self, amp: float) -> None:
        # legs (joints 1, 2) and arms (11, 14) swing in counter-phase
        s = np.sin(self._phase) * 0.4 * amp
        self.joint_pose[1, 0] = s
        self.joint_pose[2, 0] = -s
        self.joint_pose[11, 0] = -s * 0.6
        self.joint_pose[14, 0] = s * 0.6


class HumanoidSeqPoseController(HumanoidBaseController):
    """Plays a fixed pose sequence (T, J, 4) frame by frame (reference
    humanoid_seq_pose_controller.py)."""

    def __init__(self, poses: Optional[np.ndarray] = None, motion_fps: float = 30.0):
        super().__init__(motion_fps)
        self.poses = poses if poses is not None else np.zeros((1, NUM_JOINTS, 4))
        self._t = 0

    @classmethod
    def from_file(cls, path: str, key: str = "walk_motion") -> "HumanoidSeqPoseController":
        m = load_motion(path, key)
        ctrl = cls(m.poses, motion_fps=m.fps)
        ctrl.motion = m
        return ctrl

    def reset(self, base_transformation) -> None:
        super().reset(base_transformation)
        self._t = 0

    def next_pose(self, cycle: bool = True) -> None:
        """The next frame, wrapping to the first (``cycle``) or holding the
        last."""
        n = len(self.poses)
        self._t = (self._t + 1) % n if cycle else min(self._t + 1, n - 1)
        self.joint_pose = self.poses[self._t]


class KinematicHumanoid:
    """The humanoid agent: a controller and the base position it reads from
    the controller's root (reference humanoids/kinematic_humanoid.py)."""

    def __init__(self, controller: Optional[HumanoidRearrangeController] = None):
        self.controller = controller or HumanoidRearrangeController()
        self.base_pos = np.zeros(3)
        self.base_rot = 0.0

    def reconfigure(self) -> None:
        pass

    def update(self) -> None:
        self.base_pos = self.controller.obj_transform_base[:3, 3].copy()
