"""Batched forward and inverse kinematics (port of
``habitat_tpu/articulated_agents/kinematics.py``).

Counterpart of the reference's Bullet-backed Manipulator
(articulated_agents/manipulator.py:19: joint motors, EE state) and IkHelper
(tasks/rearrange/utils.py, pybullet IK). Joints are (..., J) tensors: every
leading axis is a batch axis (the JAX package ``vmap``s over envs). FK walks
the serial chain; its Jacobians are written analytically (a revolute joint
moves a point p by axis x (p - pivot), a prismatic one by its axis), so
damped-least-squares IK needs no autodiff. Linear solves use
``torch.linalg.solve_ex``, which leaves its status on the device; the
tables of a params arm are made on the device by fills, and a URDF chain's
are copied to a device once and kept, so FK and IK never wait on the card
(a URDF chain's first call on a device does).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.articulated_agents.params import MobileManipulatorParams
from habitat_torch.utils.geometry import rotate_agent_to_world

_AXIS = {"x": 0, "y": 1, "z": 2}


def device_values(values: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """A float32 (len(values),) tensor on ``like``'s device, each element a
    fill on the device: no copy from the host, so no wait on the card (an
    element assignment or ``torch.tensor`` copies from the host and waits)."""
    return torch.stack([torch.full((), float(x), dtype=torch.float32, device=like.device) for x in values])


def _unit_columns(batch: Tuple[int, ...], like: torch.Tensor) -> List[torch.Tensor]:
    """The identity's three columns, each (*batch, 3)."""
    eye = torch.eye(3, dtype=torch.float32, device=like.device)
    return [eye[:, k].expand(batch + (3,)) for k in range(3)]


def _rotate_columns(cols: List[torch.Tensor], axis: int, c: torch.Tensor, s: torch.Tensor) -> List[torch.Tensor]:
    """Columns of R @ rot(axis, theta), with c = cos(theta), s = sin(theta)
    of shape (...,) and R given by its columns (..., 3)."""
    c, s = c.unsqueeze(-1), s.unsqueeze(-1)
    r0, r1, r2 = cols
    if axis == 0:
        return [r0, c * r1 + s * r2, c * r2 - s * r1]
    if axis == 1:
        return [c * r0 - s * r2, r1, s * r0 + c * r2]
    return [c * r0 + s * r1, c * r1 - s * r0, r2]


def _apply_columns(cols: List[torch.Tensor], offset: Sequence[float]) -> torch.Tensor:
    """R @ offset for a constant offset; zero components add nothing."""
    terms = [col * float(o) for col, o in zip(cols, offset) if o != 0.0]
    if not terms:
        return torch.zeros_like(cols[0])
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def fk_frames(params: MobileManipulatorParams, joints: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., J) joint angles -> (link positions (..., J+1, 3) in the arm-root
    frame, world joint axes (..., J, 3)). Joint j turns about axis j at
    position j and moves positions j+1..J."""
    batch = joints.shape[:-1]
    cols = _unit_columns(batch, joints)
    p = torch.zeros(batch + (3,), dtype=torch.float32, device=joints.device)
    pts, axes = [p], []
    c, s = torch.cos(joints), torch.sin(joints)
    for j in range(params.arm_joints):
        a = _AXIS[params.joint_axes[j]]
        cols = _rotate_columns(cols, a, c[..., j], s[..., j])
        axes.append(cols[a])
        p = p + _apply_columns(cols, params.link_offsets[j])
        pts.append(p)
    return torch.stack(pts, dim=-2), torch.stack(axes, dim=-2)


def fk_positions(params: MobileManipulatorParams, joints: torch.Tensor) -> torch.Tensor:
    """(..., J) joint angles -> (..., J+1, 3) link positions in the arm-root
    frame."""
    return fk_frames(params, joints)[0]


def ee_position(params: MobileManipulatorParams, joints: torch.Tensor) -> torch.Tensor:
    """End-effector position in the arm-root frame, (..., J) -> (..., 3)."""
    return fk_positions(params, joints)[..., -1, :]


def ee_position_world(
    params: MobileManipulatorParams,
    joints: torch.Tensor,
    base_pos: torch.Tensor,
    base_yaw: torch.Tensor,
) -> torch.Tensor:
    """EE world position (..., 3) given the mobile base pose (..., 3), (...,)."""
    ee = ee_position(params, joints)
    root = params.arm_root_offset
    local = torch.stack([ee[..., i] + float(root[i]) for i in range(3)], dim=-1)
    return base_pos + rotate_agent_to_world(local, base_yaw)


def _ee_jacobian(pts: torch.Tensor, axes: torch.Tensor) -> torch.Tensor:
    """d ee / d q for revolute joints: (..., 3, J)."""
    ee = pts[..., -1:, :]
    return torch.linalg.cross(axes, ee - pts[..., :-1, :], dim=-1).transpose(-1, -2)


def _dls_step(J: torch.Tensor, err: torch.Tensor, damping: float) -> torch.Tensor:
    """dq = J^T (J J^T + damping^2 I)^-1 err, batched: J (..., 3, J)."""
    eye = torch.eye(3, dtype=torch.float32, device=J.device)
    JJt = J @ J.transpose(-1, -2) + damping**2 * eye
    x = torch.linalg.solve_ex(JJt, err.unsqueeze(-1))[0]
    return (J.transpose(-1, -2) @ x).squeeze(-1)


def ik_solve(
    params: MobileManipulatorParams,
    target: torch.Tensor,  # (..., 3) in the arm-root frame
    joints0: torch.Tensor,  # (..., J)
    iters: int = 20,
    damping: float = 0.1,
) -> torch.Tensor:
    """Damped-least-squares IK (reference IkHelper.calc_ik via pybullet),
    ``iters`` steps clamped to the joint limits."""
    lo = device_values(params.joint_limits_lower, joints0)
    hi = device_values(params.joint_limits_upper, joints0)
    q = joints0
    for _ in range(iters):
        pts, axes = fk_frames(params, q)
        dq = _dls_step(_ee_jacobian(pts, axes), target - pts[..., -1, :], damping)
        q = torch.clamp(q + dq, min=lo, max=hi)
    return q


def ik_error(params: MobileManipulatorParams, target: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    d = target - ee_position(params, joints)
    return torch.sqrt((d * d).sum(-1))


# -- URDF chains (arbitrary axes, rpy origins, prismatic joints) -------------
#
# The reference gets this generality from Bullet's URDF importer
# (articulated_agents/manipulator.py:79-120); here `urdf.load_chain` parses
# the file and these functions run the chain as batched tensor math. The
# chain's numpy tables are copied to a device once, on the first call there,
# and kept on the chain, so later calls never wait on the card.


def _chain_tables(chain, device: torch.device):
    """(origin_xyz, origin_rot, axis, ee_offset, lower, upper) float32 and
    is_prismatic bool, on ``device``."""
    cache = chain.__dict__.setdefault("_device_tables", {})
    if device not in cache:
        names = ("origin_xyz", "origin_rot", "axis", "ee_offset", "lower", "upper")
        floats = [np.asarray(getattr(chain, k), np.float32) for k in names]
        prism = np.asarray(chain.is_prismatic, bool)
        cache[device] = tuple(torch.as_tensor(x, device=device) for x in floats + [prism])
    return cache[device]


def _chain_frames(chain, joints: torch.Tensor, tables):
    """URDF chain FK: (frame origins (..., J+1, 3), the last row the
    end-effector, and each joint's world motion axis (..., J, 3)).

    Frame update per joint j (urdf.ArticulatedChain):
      T_j = Trans(origin_xyz[j]) @ origin_rot[j] @ Motion_j(q_j)
    with Motion = Rodrigues(axis, q) for revolute, Trans(axis * q) prismatic.
    """
    o_xyz, o_rot, axes, ee_off = tables[:4]
    batch = joints.shape[:-1]
    eye = torch.eye(3, dtype=torch.float32, device=joints.device)
    R = eye.expand(batch + (3, 3))
    p = torch.zeros(batch + (3,), dtype=torch.float32, device=joints.device)
    pts, motion = [], []
    for j in range(chain.num_joints):
        p = p + R @ o_xyz[j]
        R = R @ o_rot[j]
        pts.append(p)
        a = R @ axes[j]  # the joint's axis in the base frame
        motion.append(a)
        qj = joints[..., j, None]
        if chain.is_prismatic[j]:
            p = p + a * qj
        else:
            x, y, z = axes[j, 0], axes[j, 1], axes[j, 2]
            zero = torch.zeros_like(x)
            K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero]).reshape(3, 3)
            c, s = torch.cos(qj)[..., None], torch.sin(qj)[..., None]
            R = R @ (eye + s * K + (1.0 - c) * (K @ K))
    pts.append(p + R @ ee_off)
    return torch.stack(pts, dim=-2), torch.stack(motion, dim=-2)


def fk_chain(chain, joints: torch.Tensor) -> torch.Tensor:
    """URDF chain FK: (..., J) joint values -> (..., J+1, 3) frame origins in
    the chain's base frame; the last row is the end-effector (fixed tail
    folded)."""
    return _chain_frames(chain, joints, _chain_tables(chain, joints.device))[0]


def ee_chain(chain, joints: torch.Tensor) -> torch.Tensor:
    """URDF-chain end-effector position (..., J) -> (..., 3)."""
    return fk_chain(chain, joints)[..., -1, :]


def ik_solve_chain(
    chain,
    target: torch.Tensor,
    joints0: torch.Tensor,
    iters: int = 20,
    damping: float = 0.1,
) -> torch.Tensor:
    """Damped-least-squares IK on the URDF chain (the scheme of ik_solve)."""
    tables = _chain_tables(chain, joints0.device)
    lo, hi, prism = tables[4:]
    q = joints0
    for _ in range(iters):
        pts, motion = _chain_frames(chain, q, tables)
        ee = pts[..., -1:, :]
        rev = torch.linalg.cross(motion, ee - pts[..., :-1, :], dim=-1)
        J = torch.where(prism[:, None], motion, rev).transpose(-1, -2)
        dq = _dls_step(J, target - ee[..., 0, :], damping)
        q = torch.clamp(q + dq, min=lo, max=hi)
    return q
