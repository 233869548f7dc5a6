"""Geometry helpers on tensors (port of ``habitat_tpu/utils/geometry.py``).

Habitat coordinate convention: y-up, agent forward is -z, right is +x. A yaw
of 0 faces -z; positive yaw turns left (counter-clockwise around +y).
"""

from __future__ import annotations

import math

import torch


def yaw_to_forward(yaw: torch.Tensor) -> torch.Tensor:
    """Unit forward vector in the xz plane for a given yaw (0 -> -z)."""
    return torch.stack([-torch.sin(yaw), torch.zeros_like(yaw), -torch.cos(yaw)], dim=-1)


def rotate_world_to_agent(vec: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Express a world-frame vector (..., 3) in the agent frame (rotation by
    -yaw about +y)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    return torch.stack([c * x - s * z, y, s * x + c * z], dim=-1)


def rotate_agent_to_world(vec: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Express an agent-frame vector (..., 3) in the world frame (rotation by
    yaw about +y); the inverse of ``rotate_world_to_agent``."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def cartesian_to_polar(x: torch.Tensor, y: torch.Tensor):
    """(rho, phi)."""
    return torch.sqrt(x**2 + y**2), torch.atan2(y, x)


def rotate_dirs(d: torch.Tensor, yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Camera-frame -> world: pitch about camera +x, then yaw about +y."""
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    y2 = cp * y - sp * z
    z2 = sp * y + cp * z
    cyw, syw = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([cyw * x + syw * z2, y2, -syw * x + cyw * z2], dim=-1)


def camera_rays(
    yaw: torch.Tensor, pitch: torch.Tensor, hfov_rad: float, height: int, width: int,
    device=None,
) -> torch.Tensor:
    """(height, width, 3) unit world-space ray directions of a pinhole camera
    (square pixels, vfov from the aspect ratio) for scalar yaw/pitch."""
    fx = math.tan(hfov_rad / 2.0)
    xs = torch.linspace(-fx, fx, width, dtype=torch.float32, device=device)
    aspect = height / width
    ys = torch.linspace(fx * aspect, -fx * aspect, height, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    dirs = torch.stack([xx, yy, -torch.ones_like(xx)], dim=-1)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return rotate_dirs(dirs, yaw, pitch)


def view_rotation_matrix(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """(...,) yaw/pitch -> (..., 3, 3) R with d_world = R @ d_camera."""
    eye = torch.eye(3, dtype=torch.float32, device=yaw.device)
    cols = [rotate_dirs(eye[k], yaw, pitch) for k in range(3)]
    return torch.stack(cols, dim=-1)


def equirect_rays(yaw: torch.Tensor, pitch: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(height, width, 3) unit world-space rays of an equirectangular camera:
    the full 360x180 panorama turned by the yaw, the pitch applied as a
    latitude shift. yaw/pitch broadcast against (height, width), e.g.
    (N, 1, 1) for a batch."""
    dev = yaw.device
    # longitudes without the endpoint: width steps of 2 pi / width from -pi
    lon = torch.linspace(-math.pi, math.pi, width + 1, dtype=torch.float32, device=dev)[:width]
    lat = torch.linspace(math.pi / 2, -math.pi / 2, height, dtype=torch.float32, device=dev)
    la, lo = torch.meshgrid(lat, lon, indexing="ij")  # (H, W)
    la = la + pitch
    return torch.stack(
        [-torch.sin(lo + yaw) * torch.cos(la), torch.sin(la), -torch.cos(lo + yaw) * torch.cos(la)], dim=-1
    )


def fisheye_rays(yaw: torch.Tensor, pitch: torch.Tensor, fov_rad: float, height: int, width: int) -> torch.Tensor:
    """(height, width, 3) unit world-space rays of an equidistant fisheye
    camera: the angle from the axis grows with the radius in the image.
    Pixels outside the image circle take the edge angle (the radius is
    clipped to 1); nothing masks them."""
    dev = yaw.device
    ys = torch.linspace(1.0, -1.0, height, dtype=torch.float32, device=dev)
    xs = torch.linspace(-1.0, 1.0, width, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    r = torch.sqrt(xx**2 + yy**2)
    theta = r.clamp(0.0, 1.0) * (fov_rad / 2.0)
    phi = torch.atan2(yy, xx)
    d_cam = torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), -torch.cos(theta)], dim=-1
    )
    return rotate_dirs(d_cam, yaw, pitch)
