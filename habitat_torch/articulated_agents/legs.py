"""Articulated legged base (port of ``habitat_tpu/articulated_agents/legs.py``):
Spot's 12 leg joints as a batched FK chain.

Reference semantics (articulated_agents/articulated_agent_base.py:111-141,
234-292 and robots/spot_robot.py:20-37): a "leg"-type base owns 12 leg
joints (4 legs x [hip-roll, hip-pitch, knee-pitch]) initialised to
leg_init_params = [0.0, 0.7, -1.5] * 4 and held fixed during kinematic base
motion. The legs render through the dynamic raycast pass as FK-posed link
boxes, so the joint values change pixels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from habitat_torch.utils.geometry import rotate_agent_to_world

# Spot-like leg geometry (base frame: x forward, y up, z right)
HIP_OFFSETS = np.array(
    [
        [0.29, 0.0, -0.17],  # front-left
        [0.29, 0.0, 0.17],  # front-right
        [-0.29, 0.0, -0.17],  # hind-left
        [-0.29, 0.0, 0.17],  # hind-right
    ],
    np.float32,
)
UPPER_LEN = 0.35
LOWER_LEN = 0.33
LEG_INIT = np.array([0.0, 0.7, -1.5] * 4, np.float32)

_CORNER_SIGNS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
    np.float32,
)
_BOX_FACES = np.array(
    [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
     [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]],
    np.int64,
)


@functools.lru_cache(maxsize=None)
def _leg_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """HIP_OFFSETS, the box corner signs and faces on ``device``: copied from
    the host once per device, so later calls never wait on the card."""
    return tuple(torch.as_tensor(x, device=device) for x in (HIP_OFFSETS, _CORNER_SIGNS, _BOX_FACES))


def leg_fk(leg_q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """FK for 4 legs: (..., 12) joints -> (knee (..., 4, 3), foot (..., 4, 3))
    in the base frame (base origin at hip height).

    Per leg [roll, pitch, knee]: the hip roll tilts the leg plane about the
    body x axis; hip pitch and knee pitch articulate within that plane
    (0 pitch = straight down; positive pitch swings the leg forward)."""
    q = leg_q.reshape(leg_q.shape[:-1] + (4, 3))
    roll, pitch, knee = q[..., 0], q[..., 1], q[..., 2]
    hips = _leg_tables(leg_q.device)[0]

    def seg(theta, length):
        # in-plane direction for joint angle theta: (x forward, y down)
        return torch.stack([torch.sin(theta) * length, -torch.cos(theta) * length], dim=-1)

    def to3(d2):
        # roll tilts the leg plane: y stays in-plane scaled by cos, z gets sin
        return torch.stack([d2[..., 0], d2[..., 1] * torch.cos(roll), d2[..., 1] * torch.sin(roll)], dim=-1)

    knee_p = hips + to3(seg(pitch, UPPER_LEN))
    foot_p = knee_p + to3(seg(pitch + knee, LOWER_LEN))
    return knee_p, foot_p


def leg_segment_boxes(
    base_pos: torch.Tensor,  # (N, 3) base origin (hip height), world
    yaw: torch.Tensor,  # (N,)
    leg_q: torch.Tensor,  # (N, 12)
    radius: float = 0.035,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space triangle boxes for the 8 leg segments (4 legs x thigh and
    shank): (N, 96, 3, 3) triangles and (N, 96) valid, one box per segment
    as the arm's dynamic-pass geometry."""
    N = base_pos.shape[0]
    dev = base_pos.device
    knee_p, foot_p = leg_fk(leg_q)  # (N, 4, 3) base frame
    hips, signs, faces = _leg_tables(dev)
    hips = hips.expand(N, 4, 3)
    pts = torch.stack([hips, knee_p, foot_p], dim=2)  # (N, 4, 3 points, 3)
    pts_w = base_pos[:, None, None, :] + rotate_agent_to_world(pts.reshape(N, 12, 3), yaw[:, None]).reshape(
        N, 4, 3, 3
    )
    p0 = pts_w[:, :, :-1].reshape(N, 8, 3)
    p1 = pts_w[:, :, 1:].reshape(N, 8, 3)
    seg = p1 - p0
    ln = torch.sqrt((seg * seg).sum(-1, keepdim=True))
    u = seg / torch.clamp_min(ln, 1e-6)
    vertical = u[..., 1].abs() > 0.9
    ref = torch.stack([vertical, ~vertical, torch.zeros_like(vertical)], dim=-1).to(u.dtype)  # x or y axis
    v = torch.linalg.cross(u, ref, dim=-1)
    v = v / torch.clamp_min(torch.sqrt((v * v).sum(-1, keepdim=True)), 1e-6)
    w = torch.linalg.cross(u, v, dim=-1)
    mid = 0.5 * (p0 + p1)
    h = 0.5 * ln
    corners = (
        mid[:, :, None, :]
        + signs[None, None, :, 0:1] * u[:, :, None, :] * h[:, :, None, :]
        + signs[None, None, :, 1:2] * v[:, :, None, :] * radius
        + signs[None, None, :, 2:3] * w[:, :, None, :] * radius
    )  # (N, 8, 8, 3)
    tris = corners[:, :, faces, :].reshape(N, 96, 3, 3)
    return tris, torch.ones((N, 96), dtype=torch.bool, device=dev)
