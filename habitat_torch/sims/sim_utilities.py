"""Geometry and semantics toolbox (port of
``habitat_tpu/sims/sim_utilities.py``; reference habitat-lab/habitat/sims/
habitat_simulator/sim_utilities.py: bbox math, snap_down raycast placement
:310, spatial predicates above:724 / within:755 / ontop:841 / on_floor:910 /
object_in_region:958, receptacle matching :1439).

Works on axis-aligned bounds and the scene's navgrid and triangles instead of
Magnum scene nodes. The host helpers take numpy arrays (episode generation
is host work); ``batched_within`` and ``batched_ontop`` are torch functions
on the device of their inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# -- bounding boxes ----------------------------------------------------------


def aabb(center, size) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi) corners from center + full size."""
    c = np.asarray(center, np.float64)
    h = np.asarray(size, np.float64) / 2
    return c - h, c + h


def aabb_contains(point, lo, hi, eps: float = 1e-6) -> bool:
    p = np.asarray(point)
    return bool(np.all(p >= np.asarray(lo) - eps) and np.all(p <= np.asarray(hi) + eps))


def aabb_overlap(lo_a, hi_a, lo_b, hi_b) -> bool:
    return bool(np.all(np.asarray(hi_a) >= np.asarray(lo_b)) and np.all(np.asarray(hi_b) >= np.asarray(lo_a)))


def get_global_keypoints(center, size) -> np.ndarray:
    """Center + 8 corners (reference get_global_keypoints_from_bb)."""
    lo, hi = aabb(center, size)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    return np.concatenate([np.asarray(center)[None], corners])


# -- placement / snapping ----------------------------------------------------


def snap_down(scene, center, size, max_drop: float = 2.0) -> Optional[np.ndarray]:
    """Drop an object's bbox onto the floor (reference snap_down:310): None
    when it would fall more than ``max_drop``, starts below the floor or
    lands off the navgrid."""
    c = np.asarray(center, np.float64)
    ground = scene.floor_y + size[1] / 2
    if c[1] - ground > max_drop or c[1] < ground - 1e-3:
        return None
    out = c.copy()
    out[1] = ground
    if not scene.is_navigable(np.array([out[0], scene.floor_y, out[2]])):
        return None
    return out


def snap_down_raycast(tri_v0, tri_e1, tri_e2, tri_valid, center, size, max_drop: float = 2.0):
    """Drop an object onto whatever surface is below it (reference snap_down
    + bb_ray_prescreen, sim_utilities.py:234-380): five rays straight down
    from the bbox's center and bottom corners through ``raycast_rays`` on
    CPU tensors. Returns the snapped center, or None without support within
    ``max_drop``."""
    from habitat_torch.ops.raycast import raycast_rays

    c = np.asarray(center, np.float64)
    h = np.asarray(size, np.float64) / 2
    pts = np.array(
        [
            [c[0], c[1], c[2]],
            [c[0] - h[0], c[1], c[2] - h[2]],
            [c[0] + h[0], c[1], c[2] - h[2]],
            [c[0] - h[0], c[1], c[2] + h[2]],
            [c[0] + h[0], c[1], c[2] + h[2]],
        ],
        np.float32,
    )
    dirs = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (5, 1))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    t, idx = raycast_rays(f32(tri_v0), f32(tri_e1), f32(tri_e2), torch.as_tensor(np.asarray(tri_valid)).bool(),
                          f32(pts), f32(dirs))
    t, hit = t.numpy(), idx.numpy() >= 0
    if not hit.any():
        return None
    # the nearest hit below a keypoint is the support the object rests on
    drop = np.min(np.where(hit, t, np.inf))
    if drop > max_drop + h[1]:
        return None
    out = c.copy()
    out[1] = c[1] - drop + h[1]
    return out


# -- spatial predicates (reference :724-958) ---------------------------------


def above(obj_center, obj_size, other_center, other_size, eps: float = 0.01) -> bool:
    """obj is above other: xz footprints overlap and obj bottom >= other top."""
    lo_a, hi_a = aabb(obj_center, obj_size)
    lo_b, hi_b = aabb(other_center, other_size)
    xz_overlap = hi_a[0] >= lo_b[0] and hi_b[0] >= lo_a[0] and hi_a[2] >= lo_b[2] and hi_b[2] >= lo_a[2]
    return bool(xz_overlap and lo_a[1] >= hi_b[1] - eps)


def within(obj_center, other_center, other_size) -> bool:
    """obj center inside other's bounds (reference within:755)."""
    lo, hi = aabb(other_center, other_size)
    return aabb_contains(obj_center, lo, hi)


def ontop(obj_center, obj_size, other_center, other_size, tol: float = 0.05) -> bool:
    """Resting contact: above and touching (reference ontop:841)."""
    lo_a, _ = aabb(obj_center, obj_size)
    _, hi_b = aabb(other_center, other_size)
    return above(obj_center, obj_size, other_center, other_size, eps=tol) and bool(abs(lo_a[1] - hi_b[1]) <= tol)


def on_floor(scene, obj_center, obj_size, tol: float = 0.05) -> bool:
    """Resting on the navigable floor (reference on_floor:910)."""
    lo, _ = aabb(obj_center, obj_size)
    near_floor = abs(lo[1] - scene.floor_y) <= tol
    return bool(near_floor and scene.is_navigable(np.array([obj_center[0], scene.floor_y, obj_center[2]])))


def object_in_region(obj_center, region_lo, region_hi) -> bool:
    """reference object_in_region:958 (regions are AABBs here)."""
    return aabb_contains(obj_center, region_lo, region_hi)


# -- articulated-link state helpers (reference :1168-1233) --------------------
#
# Links are joint values with (lo, hi) limits; the helpers are pure
# functions of them.


def get_link_normalized_joint_position(q, lo, hi):
    """Joint state -> [0, 1] within limits (reference :1190)."""
    rng = np.maximum(np.asarray(hi) - np.asarray(lo), 1e-9)
    return np.clip((np.asarray(q) - np.asarray(lo)) / rng, 0.0, 1.0)


def set_link_normalized_joint_position(nq, lo, hi):
    """[0, 1] -> joint state (reference :1205)."""
    return np.asarray(lo) + np.clip(np.asarray(nq), 0.0, 1.0) * (np.asarray(hi) - np.asarray(lo))


def link_is_open(q, lo, hi, threshold: float = 0.4) -> bool:
    """reference link_is_open:1168."""
    return bool(get_link_normalized_joint_position(q, lo, hi) >= threshold)


def link_is_closed(q, lo, hi, threshold: float = 0.1) -> bool:
    """reference link_is_closed:1179."""
    return bool(get_link_normalized_joint_position(q, lo, hi) <= threshold)


def open_link(lo, hi):
    """Fully open joint state (reference open_link:1223)."""
    return set_link_normalized_joint_position(1.0, lo, hi)


def close_link(lo, hi):
    """Fully closed joint state (reference close_link:1233)."""
    return set_link_normalized_joint_position(0.0, lo, hi)


# -- receptacle matching (reference :1439-1528) -------------------------------


def get_obj_receptacle_matches(obj_center, obj_size, receptacles, ontop_tol: float = 0.08):
    """Which receptacles support or contain the object (reference
    get_obj_receptacle_and_confidence:1439): a receptacle matches when the
    object's center is inside its bounds padded by ``ontop_tol`` (by the
    object's height upward). Confidence is one less the larger xz distance
    from the receptacle's center in units of its half extent. Returns
    [(name, confidence)] best first."""
    c = np.asarray(obj_center, np.float64)
    matches = []
    for rec in receptacles:
        lo, hi = (np.asarray(b, np.float64) for b in rec.bounds)
        pad = np.array([ontop_tol, max(obj_size[1], ontop_tol), ontop_tol])
        if not (np.all(c >= lo - pad) and np.all(c <= hi + pad)):
            continue
        d = np.abs(c - (lo + hi) / 2) / np.maximum((hi - lo) / 2, 1e-6)
        matches.append((rec.name, float(np.clip(1.0 - np.max(d[[0, 2]]), 0.0, 1.0))))
    matches.sort(key=lambda x: -x[1])
    return matches


def find_receptacle_for_object(obj_center, obj_size, receptacles):
    """Best-match receptacle name or None."""
    m = get_obj_receptacle_matches(obj_center, obj_size, receptacles)
    return m[0][0] if m else None


# -- batched forms (torch, on the inputs' device) ------------------------------


def batched_within(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(N, 3) points against (3,) or (N, 3) bounds -> (N,) bool."""
    return ((points >= lo) & (points <= hi)).all(dim=-1)


def batched_ontop(obj_c: torch.Tensor, obj_s: torch.Tensor, other_c: torch.Tensor, other_s: torch.Tensor,
                  tol: float = 0.05) -> torch.Tensor:
    """``ontop``'s resting contact for (..., 3) centers and sizes -> (...,) bool."""
    lo_a, hi_a = obj_c - obj_s / 2, obj_c + obj_s / 2
    lo_b, hi_b = other_c - other_s / 2, other_c + other_s / 2
    xz = ((hi_a[..., 0] >= lo_b[..., 0]) & (hi_b[..., 0] >= lo_a[..., 0])
          & (hi_a[..., 2] >= lo_b[..., 2]) & (hi_b[..., 2] >= lo_a[..., 2]))
    return xz & ((lo_a[..., 1] - hi_b[..., 1]).abs() <= tol)
