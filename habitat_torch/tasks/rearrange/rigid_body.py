"""Batched rigid-body boxes (port of
``habitat_tpu/tasks/rearrange/rigid_body.py``).

Quaternions are (w, x, y, z). Every function is batched over leading axes
(envs N, objects O), runs in its inputs' dtype (float32, as the JAX package)
on their device, and writes into none of them. ``box_floor_substep`` is one substep of gravity, integration
and an 8-corner sequential-impulse floor contact (two Gauss-Seidel passes),
then a translational lift out of the support and Bullet's sleep rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from habitat_torch.device import resolve_device


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, summed as the JAX package's
    ``jnp.linalg.norm`` is (sqrt of the sum of squares)."""
    return torch.sqrt((x * x).sum(-1))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the others."""
    return torch.linalg.cross(a, b, dim=-1)


def matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3), broadcasting the batch axes."""
    return (m @ x.unsqueeze(-1)).squeeze(-1)


def add_y(x: torch.Tensor, dy) -> torch.Tensor:
    """x with dy added to its y component (a new tensor)."""
    return torch.stack([x[..., 0], x[..., 1] + dy, x[..., 2]], dim=-1)


def corner_signs(like: torch.Tensor) -> torch.Tensor:
    """The 8 box corners' (±1, ±1, ±1), (8, 3) in ``like``'s dtype and on its
    device, made by arithmetic on the device (no host copy)."""
    k = torch.arange(8, device=like.device)
    bits = torch.stack([((k + 1) >> 1) & 1, (k >> 1) & 1, (k >> 2) & 1], dim=-1)
    return (2 * bits - 1).to(like.dtype)


# ---------------------------------------------------------------------------
# quaternion utilities (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(shape, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    shape = tuple(shape)
    return torch.cat([torch.ones(shape + (1,), device=dev), torch.zeros(shape + (3,), device=dev)], dim=-1)


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about +Y by yaw: quat (cos h, 0, sin h, 0), h = yaw / 2."""
    h = 0.5 * yaw
    z = torch.zeros_like(yaw)
    return torch.stack([torch.cos(h), z, torch.sin(h), z], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(norm(q), 1e-8).unsqueeze(-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrix (columns = body axes)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """q' = normalize(q + dt/2 * [0, omega] * q) for a world-frame omega."""
    wq = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    return quat_normalize(q + 0.5 * dt * quat_mul(wq, q))


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Twist about +Y matching quat_from_yaw (upright boxes round-trip)."""
    return torch.atan2(
        2.0 * (q[..., 0] * q[..., 2] + q[..., 1] * q[..., 3]),
        1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2),
    )


# ---------------------------------------------------------------------------
# inertia and the floor substep
# ---------------------------------------------------------------------------


def box_inertia_inv(half: torch.Tensor, mass: float = 1.0) -> torch.Tensor:
    """Inverse inertia of a solid box in the BODY frame, diagonal (..., 3):
    I = m/3 * (h_j^2 + h_k^2) per axis (half-extents h)."""
    hx2, hy2, hz2 = half[..., 0] ** 2, half[..., 1] ** 2, half[..., 2] ** 2
    i = (mass / 3.0) * torch.stack([hy2 + hz2, hx2 + hz2, hx2 + hy2], dim=-1)
    return 1.0 / torch.clamp_min(i, 1e-8)


def _rotate_inertia(R: torch.Tensor, ii: torch.Tensor) -> torch.Tensor:
    """R diag(ii) R^T."""
    return (R * ii.unsqueeze(-2)) @ R.transpose(-1, -2)


def world_inertia_inv(q: torch.Tensor, half: torch.Tensor, mass: float = 1.0) -> torch.Tensor:
    """World-frame inverse inertia R diag(I_body^-1) R^T, (..., 3, 3)."""
    return _rotate_inertia(quat_to_matrix(q), box_inertia_inv(half, mass))


def box_floor_substep(
    p: torch.Tensor,  # (N, O, 3) box CENTERS
    v: torch.Tensor,  # (N, O, 3)
    q: torch.Tensor,  # (N, O, 4)
    w: torch.Tensor,  # (N, O, 3) world angular velocity
    half: torch.Tensor,  # (N, O, 3)
    free: torch.Tensor,  # (N, O) bool
    floor_y: torch.Tensor,  # (N,)
    dt: float,
    g: float = 9.8,
    mu: float = 0.5,
    ang_damp: float = 0.985,
    mass: float = 1.0,
    ledges: Optional[torch.Tensor] = None,  # (N, L, 6) static AABBs [center3, half3]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rigid-body substep: gravity, integration, and 8-corner floor
    contact with sequential normal and Coulomb friction impulses at each
    corner (the lever arm gives torque: overhanging boxes tip, tipped boxes
    settle on a face). Zero restitution, friction clamped at mu * jn, then a
    translational lift out of the support. ``ledges`` adds static support
    boxes as a height function under each corner (top faces only).
    Returns (p, v, q, w)."""
    freem = free.unsqueeze(-1)

    def height_under(c):
        """Support height below world points (N, M, 3) -> (N, M)."""
        h = floor_y[:, None].expand(c.shape[:-1])
        if ledges is None:
            return h
        lc, lh = ledges[..., 0:3], ledges[..., 3:6]
        inx = (c[..., None, 0] - lc[..., None, :, 0]).abs() <= lh[..., None, :, 0]
        inz = (c[..., None, 2] - lc[..., None, :, 2]).abs() <= lh[..., None, :, 2]
        top = lc[..., None, :, 1] + lh[..., None, :, 1]
        below = c[..., None, 1] <= top + 0.25  # only when near or below the top
        cand = torch.where(inx & inz & below, top, -torch.inf)
        return torch.maximum(h, cand.amax(-1))

    # free-fall integrate
    v = torch.where(freem, add_y(v, -g * dt), 0.0)
    w = torch.where(freem, w * ang_damp, 0.0)
    p = torch.where(freem, p + v * dt, p)
    q = torch.where(freem, quat_integrate(q, w, dt), q)

    R = quat_to_matrix(q)  # (N, O, 3, 3)
    inv_m = 1.0 / mass
    iw = _rotate_inertia(R, box_inertia_inv(half, mass))
    signs = corner_signs(p)
    zero = torch.zeros_like(p[..., 0])
    e_y = torch.stack([zero, zero + 1.0, zero], dim=-1)
    e_xz = 1.0 - e_y

    # sequential impulses over the 8 corners, two Gauss-Seidel passes (one
    # pass leaves an order-bias torque: a slow parasitic spin at rest)
    for k in range(16):
        r = matvec(R, signs[k % 8] * half)  # lever arm
        c = p + r
        touching = free & (height_under(c) - c[..., 1] > 0.0)
        vn = (v + cross(w, r))[..., 1]  # normal = +Y
        ang = cross(matvec(iw, cross(r, e_y)), r)[..., 1]
        jn = torch.where(touching & (vn < 0.0), -vn / torch.clamp_min(inv_m + ang, 1e-6), 0.0)
        imp = jn.unsqueeze(-1) * e_y
        v = v + inv_m * imp
        w = w + matvec(iw, cross(r, imp))
        # Coulomb friction at the same corner (tangential, clamped mu * jn)
        vc = v + cross(w, r)
        vt = vc * e_xz
        vt_len = norm(vt)
        t_dir = vt / torch.clamp_min(vt_len, 1e-8).unsqueeze(-1)
        ang_t = (cross(matvec(iw, cross(r, -t_dir)), r) * -t_dir).sum(-1)
        k_t = inv_m + ang_t
        jt = torch.where(touching, torch.minimum(vt_len / torch.clamp_min(k_t, 1e-6), mu * jn), 0.0)
        imp_t = -t_dir * jt.unsqueeze(-1)
        v = v + inv_m * imp_t
        w = w + matvec(iw, cross(r, imp_t))

    # positional projection: lift out of the support surface. The unit
    # corner is scaled by half in the BODY frame before it is rotated.
    corners = p.unsqueeze(-2) + matvec(R.unsqueeze(-3), signs * half.unsqueeze(-2))  # (N, O, 8, 3)
    N, O = corners.shape[0], corners.shape[1]
    hts = height_under(corners.reshape(N, O * 8, 3)).reshape(N, O, 8)
    lift = torch.clamp_min(hts - corners[..., 1], 0.0).amax(-1)
    p = torch.where(freem, add_y(p, lift), p)
    # sleeping (Bullet's rest rule): supported on >= 3 corners with
    # near-zero velocities; an edge-balanced box (<= 2 corners) never sleeps
    n_touch = (hts - corners[..., 1] > -2e-3).sum(-1)
    asleep = ((n_touch >= 3) & (norm(v) < 0.08) & (norm(w) < 0.6)).unsqueeze(-1)
    v = torch.where(asleep, 0.0, v)
    w = torch.where(asleep, 0.0, w)
    return p, torch.where(freem, v, 0.0), q, torch.where(freem, w, 0.0)
