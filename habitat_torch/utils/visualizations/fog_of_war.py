"""Fog-of-war reveal (port of ``habitat_tpu/utils/visualizations/fog_of_war.py``;
reference habitat/utils/visualizations/fog_of_war.py): rays marched on the
top-down map in numpy."""

from __future__ import annotations

import numpy as np


def reveal_fog_of_war(
    top_down_map: np.ndarray,  # bool navigable
    current_fog_of_war_mask: np.ndarray,
    current_point: np.ndarray,  # (2,) cell
    current_angle: float,
    fov: float = 90.0,
    max_line_len: float = 100.0,
) -> np.ndarray:
    """A copy of the mask with the cells seen from ``current_point`` set:
    64 rays over ``fov`` degrees about ``current_angle`` (0 faces -z; map
    axes are (x, z)), each revealing its cells up to and including the
    first one that is not navigable, within ``max_line_len`` cells."""
    n_rays = 64
    half = np.deg2rad(fov) / 2
    angles = current_angle + np.linspace(-half, half, n_rays)
    dirs = np.stack([-np.sin(angles), -np.cos(angles)], axis=-1)  # (n,2)

    mask = current_fog_of_war_mask.copy()
    nx, nz = top_down_map.shape
    steps = np.arange(1, int(max_line_len))
    pts = current_point[None, None, :] + dirs[:, None, :] * steps[None, :, None]  # (n_rays, n_steps, 2)
    pts = np.round(pts).astype(np.int64)
    inb = (pts[..., 0] >= 0) & (pts[..., 0] < nx) & (pts[..., 1] >= 0) & (pts[..., 1] < nz)
    pts_c = np.clip(pts, 0, [nx - 1, nz - 1])
    navigable = top_down_map[pts_c[..., 0], pts_c[..., 1]] & inb
    # visible until the first blocked step per ray
    blocked = ~navigable
    first_block = np.where(blocked.any(axis=1), blocked.argmax(axis=1), blocked.shape[1])
    visible = steps[None, :] <= (first_block[:, None] + 1)
    visible &= inb
    mask[pts_c[..., 0][visible], pts_c[..., 1][visible]] = 1
    ci, ck = int(current_point[0]), int(current_point[1])
    if 0 <= ci < nx and 0 <= ck < nz:
        mask[ci, ck] = 1
    return mask
