"""Rearrangement physics (port of the contact step of
``habitat_tpu/tasks/rearrange/rearrange_env.py``).

``contact_step`` is the impulse/projection contact dynamics of movable boxes
(reference: Bullet's step_world, tasks/rearrange/rearrange_sim.py:1017-1028),
batched over N envs and O boxes, on the device of its inputs:

- contacts v3 (``quat=None``): upright boxes yawed about +Y; box-box pairs by
  a 5-axis separating-axis test with a minimum-translation projection and
  zero-restitution velocity impulses; floor support with ground friction;
  robot-cylinder pushout against the nearest footprint point.
- contacts v6 (``quat`` given): full rotational state. Gravity, integration
  and the floor run through ``rigid_body.box_floor_substep``; box-box pairs
  by the 15-axis OBB-OBB separating-axis test on the true orientations, with
  the impulse at the pair contact point and both lever arms; the robot
  cylinder against the true rotated box (closest point by ternary search).

The robot's pushout depth integrates into a pseudo contact force per env
(reference RobotForce, rearrange_sensors.py:814). The env itself
(``RearrangeBatchedEnv``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from habitat_torch.tasks.rearrange import rigid_body as rigid
from habitat_torch.tasks.rearrange.rigid_body import add_y, cross, matvec, norm

OBJ_HALF = 0.12  # rearrange objects are ~24 cm boxes (YCB-ish scale)
AGENT_RADIUS = 0.3
FORCE_K = 100.0  # pseudo-force per meter of robot-object penetration


def _scale_xz(v: torch.Tensor, s: float) -> torch.Tensor:
    """v * (s, 0, s): friction and no bounce."""
    return torch.stack([v[..., 0] * s, v[..., 1] * 0.0, v[..., 2] * s], dim=-1)


def _xz(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0], x[..., 2]], dim=-1)


def _sat_boxbox(p, v, free, fy_c, half_c, hy_c, u_c, w_c, eye):
    """Contacts v3: one upright-OBB separating-axis pass over {Y, u_i, w_i,
    u_j, w_j}: minimum-translation projection, then restitution-0 impulses
    between centers. Returns (p, v, supported)."""
    d = p[:, :, None, :] - p[:, None, :, :]  # (N, O, O, 3), i <- j
    dxz = _xz(d)
    pen_y = hy_c[:, :, None] + hy_c[:, None, :] - d[..., 1].abs()
    shp = dxz.shape
    axes = torch.stack(
        [u_c[:, :, None].expand(shp), w_c[:, :, None].expand(shp),
         u_c[:, None, :].expand(shp), w_c[:, None, :].expand(shp)],
        dim=0,
    )  # (4, N, O, O, 2)
    sep = (axes * dxz).sum(-1)  # signed center gap on each axis

    def proj_radius(axis):
        ri = half_c[..., 0][:, :, None] * (u_c[:, :, None] * axis).sum(-1).abs() + half_c[..., 2][
            :, :, None
        ] * (w_c[:, :, None] * axis).sum(-1).abs()
        rj = half_c[..., 0][:, None, :] * (u_c[:, None, :] * axis).sum(-1).abs() + half_c[..., 2][
            :, None, :
        ] * (w_c[:, None, :] * axis).sum(-1).abs()
        return ri + rj

    pen_xz = torch.stack([proj_radius(axes[k]) for k in range(4)], dim=0) - sep.abs()  # (4, N, O, O)
    pair = free[:, :, None] & free[:, None, :] & ~eye
    active = pair & (pen_y > 0.0) & (pen_xz > 0.0).all(0)
    pens = torch.cat([pen_y[None], pen_xz], dim=0)  # (5, N, O, O)
    pen, which = pens.min(0)  # the first minimum, as jnp.argmin
    zero = torch.zeros_like(pen_y)
    y_nrm = torch.stack([zero, torch.where(d[..., 1] >= 0, 1.0, -1.0), zero], dim=-1)
    xz_nrm = axes * torch.where(sep >= 0, 1.0, -1.0)[..., None]  # unit, pushing i away from j
    nrm3 = torch.stack([xz_nrm[..., 0], zero.expand(xz_nrm.shape[:-1]), xz_nrm[..., 1]], dim=-1)
    cand = torch.cat([y_nrm[None], nrm3], dim=0)  # (5, N, O, O, 3)
    nrm = torch.gather(cand, 0, which[None, ..., None].expand((1,) + which.shape + (3,)))[0]
    # separation split: grounded (or held) bodies act kinematic, the free
    # body takes the full correction; one propagation pass anchors boxes
    # resting on an anchored box (stable short stacks)
    base = ~free | (p[..., 1] <= fy_c + hy_c + 1e-3)
    support = active & (which == 0) & (d[..., 1] > 0)  # j supports i
    sup_anchored = base | (support & base[:, None, :]).any(2)
    ai = base[:, :, None]
    aj = sup_anchored[:, None, :]
    wgt = torch.where(aj & ~ai, 1.0, torch.where(ai & ~aj, 0.0, 0.5))
    p = p + torch.where(active[..., None], (wgt * pen)[..., None] * nrm, 0.0).sum(2)
    vn = ((v[:, :, None, :] - v[:, None, :, :]) * nrm).sum(-1)
    imp = torch.where(active & (vn < 0), -0.5 * vn, 0.0)
    v = v + (imp[..., None] * nrm).sum(2)
    return p, v, support.any(2)


def _robot_pushout(p, free, agent_pos, half_c, u_c, w_c, force):
    """Contacts v3: robot cylinder against the nearest footprint point of
    each upright box -> positional pushout and pseudo force."""
    da = p - agent_pos[:, None, :]
    in_h = da[..., 1].abs() < 1.2
    da_xz = _xz(da)
    lx = -(da_xz * u_c).sum(-1)
    lz = -(da_xz * w_c).sum(-1)
    nearx = torch.clamp(lx, min=-half_c[..., 0], max=half_c[..., 0])
    nearz = torch.clamp(lz, min=-half_c[..., 2], max=half_c[..., 2])
    gap = torch.sqrt((lx - nearx) ** 2 + (lz - nearz) ** 2)
    pen_a = torch.where(free & in_h, AGENT_RADIUS - gap, 0.0)
    hit_a = pen_a > 0.0
    dlen = torch.clamp_min(torch.sqrt((da_xz**2).sum(-1)), 1e-6)
    push = torch.where(hit_a, pen_a, 0.0)
    p = torch.stack([p[..., 0] + push * (da_xz[..., 0] / dlen), p[..., 1],
                     p[..., 2] + push * (da_xz[..., 1] / dlen)], dim=-1)
    return p, force + FORCE_K * push.sum(1)


def _sat_boxbox_obb(p, v, q, wv, half, iw, free, fy_c, eye):
    """Contacts v6: the full 15-axis OBB-OBB separating-axis test on the true
    orientations (3 face normals per box + 9 edge-edge cross products,
    degenerate cross axes masked; Bullet btBoxBoxDetector's axis set), a
    positional split along the least-penetrated axis, and the pair impulse
    at the midpoint of the two closest-surface points with both lever arms.
    Returns (p, v, wv, supported)."""
    R = rigid.quat_to_matrix(q)  # (N, O, 3, 3), columns = box axes
    d = p[:, :, None, :] - p[:, None, :, :]  # (N, O, O, 3), i <- j
    shp = d.shape
    ax = R.transpose(-1, -2)  # rows = axes
    ax_i = ax[:, :, None]  # (N, O, 1, 3 axes, 3)
    ax_j = ax[:, None, :]  # (N, 1, O, 3 axes, 3)
    axes = [ax_i[..., k, :].expand(shp) for k in range(3)]
    axes += [ax_j[..., k, :].expand(shp) for k in range(3)]
    axes += [cross(ax_i[..., k, :], ax_j[..., l, :]).expand(shp) for k in range(3) for l in range(3)]
    axes = torch.stack(axes, dim=0)  # (15, N, O, O, 3)
    nb = norm(axes)
    valid = nb > 1e-6
    axes = axes / torch.clamp_min(nb, 1e-6)[..., None]

    # projection radii with the true half extents in both frames
    Ri = R[:, :, None]  # (N, O, 1, 3, 3)
    Rj = R[:, None, :]
    half_i = half[:, :, None]  # (N, O, 1, 3)
    half_j = half[:, None, :]
    ri = (half_i * (axes.unsqueeze(-2) @ Ri).squeeze(-2).abs()).sum(-1)
    rj = (half_j * (axes.unsqueeze(-2) @ Rj).squeeze(-2).abs()).sum(-1)
    sep = (axes * d).sum(-1)  # (15, N, O, O)
    pen = torch.where(valid, ri + rj - sep.abs(), torch.inf)
    pair = free[:, :, None] & free[:, None, :] & ~eye
    pmin, which = pen.min(0)  # the first minimum, as jnp.argmin
    active = pair & (pen > 0.0).all(0) & (pmin < 1e9)
    signed = axes * torch.where(sep >= 0, 1.0, -1.0)[..., None]
    nrm = torch.gather(signed, 0, which[None, ..., None].expand((1,) + shp))[0]  # pushes i away from j

    # positional split: anchored bodies act kinematic; support is a mostly
    # vertical contact normal
    hw_y = (R[..., 1, :].abs() * half).sum(-1)  # world AABB half height
    base = ~free | (p[..., 1] <= fy_c + hw_y + 1e-3)
    support = active & (nrm[..., 1] > 0.7)
    sup_anchored = base | (support & base[:, None, :]).any(2)
    ai = base[:, :, None]
    aj = sup_anchored[:, None, :]
    wgt = torch.where(aj & ~ai, 1.0, torch.where(ai & ~aj, 0.0, 0.5))
    p = p + torch.where(active[..., None], (wgt * pmin)[..., None] * nrm, 0.0).sum(2)

    def closest_on(x_rel, Rb, halfb, pb):
        """Closest point on the box (Rb, halfb) centred at pb to pb + x_rel."""
        local = (x_rel.unsqueeze(-2) @ Rb).squeeze(-2)  # R^T x
        return pb + matvec(Rb, torch.clamp(local, min=-halfb, max=halfb))

    pi = p[:, :, None, :]
    pj = p[:, None, :, :]
    c = 0.5 * (closest_on(-d, Ri, half_i, pi) + closest_on(d, Rj, half_j, pj))
    r_i = c - pi
    r_j = c - pj
    vr = (v[:, :, None, :] + cross(wv[:, :, None, :], r_i)) - (v[:, None, :, :] + cross(wv[:, None, :, :], r_j))
    vn = (vr * nrm).sum(-1)
    mi = torch.where(free, 1.0, 0.0)
    ang_i = (cross(matvec(iw[:, :, None], cross(r_i, nrm)), r_i) * nrm).sum(-1)
    ang_j = (cross(matvec(iw[:, None, :], cross(r_j, nrm)), r_j) * nrm).sum(-1)
    k_n = mi[:, :, None] + mi[:, None, :] + ang_i * mi[:, :, None] + ang_j * mi[:, None, :]
    jn = torch.where(active & (vn < 0.0), -vn / torch.clamp_min(k_n, 1e-6), 0.0)
    Ji = jn[..., None] * nrm  # impulse on body i from each j
    v = v + mi[..., None] * Ji.sum(2)
    wv = wv + mi[..., None] * matvec(iw, cross(r_i, Ji).sum(2))
    return p, v, wv, support.any(2)


def _robot_pushout_obb(p, v, q, wv, half, iw, free, agent_pos, force, sdt):
    """Contacts v6: the robot's vertical cylinder against the true rotated
    box. The closest point between the robot's axis segment and the box comes
    from a ternary search of the (convex) squared point-to-box distance along
    the axis (16 halvings); the pushout, the pseudo force and the lever-arm
    impulse act at that point."""
    R = rigid.quat_to_matrix(q)  # (N, O, 3, 3)
    rel = agent_pos[:, None, :] - p  # box centre -> agent base
    a0 = (rel.unsqueeze(-2) @ R).squeeze(-2)  # R^T rel (local)
    dL = R[..., 1, :]  # world +y in the box frame

    def fdist(t):
        l = a0 + t[..., None] * dL
        return ((l - torch.clamp(l, min=-half, max=half)) ** 2).sum(-1)

    lo = torch.full(p.shape[:-1], -1.2, dtype=p.dtype, device=p.device)
    hi = torch.full(p.shape[:-1], 1.2, dtype=p.dtype, device=p.device)
    for _ in range(16):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        pick1 = fdist(m1) < fdist(m2)
        hi = torch.where(pick1, m2, hi)
        lo = torch.where(pick1, lo, m1)
    t_s = 0.5 * (lo + hi)
    c_local = torch.clamp(a0 + t_s[..., None] * dL, min=-half, max=half)
    cb = p + matvec(R, c_local)  # world point on the box
    aw = add_y(agent_pos[:, None, :].expand(p.shape), t_s)
    dxz = _xz(cb - aw)
    dlen = torch.sqrt((dxz**2).sum(-1))
    # degenerate (axis inside the box): push along centre-to-centre
    ctr_xz = _xz(p - agent_pos[:, None, :])
    clen = torch.sqrt((ctr_xz**2).sum(-1))
    nxz = torch.where(
        (dlen < 1e-5)[..., None],
        ctr_xz / torch.clamp_min(clen, 1e-6)[..., None],
        dxz / torch.clamp_min(dlen, 1e-6)[..., None],
    )
    pen_a = torch.where(free, AGENT_RADIUS - dlen, 0.0)
    # vertical gate: when the box overlaps the cylinder's height span the
    # optimum has cb_y == aw_y; a residual gap means the box is above or
    # below the robot
    hit_a = (pen_a > 0.0) & ((cb[..., 1] - aw[..., 1]).abs() < 1e-2)
    n3 = torch.stack([nxz[..., 0], torch.zeros_like(dlen), nxz[..., 1]], dim=-1)
    p = p + torch.where(hit_a[..., None], pen_a[..., None] * n3, 0.0)
    force = force + FORCE_K * torch.where(hit_a, pen_a, 0.0).sum(1)
    r = cb - p
    vn = ((v + cross(wv, r)) * n3).sum(-1)
    vn_t = torch.where(hit_a, 0.5 * pen_a / sdt, 0.0)  # separating speed
    ang = (cross(matvec(iw, cross(r, n3)), r) * n3).sum(-1)
    k_n = 1.0 + torch.clamp_min(ang, 0.0)
    jn = torch.where(hit_a & (vn < vn_t), (vn_t - vn) / torch.clamp_min(k_n, 1e-6), 0.0)
    Jv = jn[..., None] * n3
    return p, v + Jv, wv + matvec(iw, cross(r, Jv)), force


def contact_step(
    obj_pos: torch.Tensor,  # (N, O, 3) object BOTTOM positions
    obj_vel: torch.Tensor,  # (N, O, 3)
    free: torch.Tensor,  # (N, O) bool: simulated (valid and not held)
    floor_y: torch.Tensor,  # (N,)
    agent_pos: torch.Tensor,  # (N, 3)
    dt: float = 0.1,
    g: float = 9.8,
    n_substeps: int = 4,
    half=OBJ_HALF,  # float | (N, O, 3) per-object half-extents
    yaw_o: Optional[torch.Tensor] = None,  # None | (N, O) upright-box yaw about +Y
    quat: Optional[torch.Tensor] = None,  # None | (N, O, 4) contacts v6 orientation
    omega: Optional[torch.Tensor] = None,  # None | (N, O, 3) world angular velocity
):
    """One env step of contact dynamics, ``n_substeps`` substeps of dt /
    n_substeps. The contact shapes are the rendered boxes.

    v3 (``quat=None``) returns (obj_pos, obj_vel, robot_force); v6 returns
    (obj_pos, obj_vel, robot_force, quat, omega). Positions are box bottoms
    in and out; a box that is not free keeps its position and gets zero
    velocities. Inputs are not written."""
    N, O, _ = obj_pos.shape
    dev = obj_pos.device
    sdt = dt / n_substeps
    eye = torch.eye(O, dtype=torch.bool, device=dev)[None]
    freem = free[..., None]
    force = torch.zeros((N,), dtype=obj_pos.dtype, device=dev)
    if not torch.is_tensor(half):
        half = torch.full((N, O, 3), float(half), dtype=obj_pos.dtype, device=dev)
    fy_c = floor_y[:, None]
    hy = half[..., 1]
    center_off = torch.stack([torch.zeros_like(hy), hy, torch.zeros_like(hy)], dim=-1)
    p = obj_pos + center_off
    v = obj_vel

    if quat is not None:
        # ---- contacts v6: rotational floor + 15-axis box-box + true robot
        q, wv = quat, omega
        for _ in range(n_substeps):
            p, v, q, wv = rigid.box_floor_substep(p, v, q, wv, half, free, floor_y, sdt, g=g)
            iw = rigid.world_inertia_inv(q, half)
            p, v, wv, supported = _sat_boxbox_obb(p, v, q, wv, half, iw, free, fy_c, eye)
            v = torch.where(supported[..., None], _scale_xz(v, 0.2), v)
            p, v, wv, force = _robot_pushout_obb(p, v, q, wv, half, iw, free, agent_pos, force, sdt)
        return p - center_off, torch.where(freem, v, 0.0), force, q, torch.where(freem, wv, 0.0)

    # ---- contacts v3: upright OBBs -----------------------------------------
    if yaw_o is None:
        yaw_o = torch.zeros((N, O), dtype=obj_pos.dtype, device=dev)
    cy, sy = torch.cos(yaw_o), torch.sin(yaw_o)
    u = torch.stack([cy, -sy], dim=-1)  # (N, O, 2)
    w = torch.stack([sy, cy], dim=-1)
    for _ in range(n_substeps):
        v = torch.where(freem, add_y(v, -g * sdt), 0.0)
        p = torch.where(freem, p + v * sdt, p)
        p, v, supported = _sat_boxbox(p, v, free, fy_c, half, hy, u, w, eye)
        # floor and support: ground clamp; friction stops horizontal motion
        # on the floor and on top of a supporting box
        fy = fy_c + hy
        on_ground = p[..., 1] <= fy + 1e-4
        p = torch.stack([p[..., 0], torch.maximum(p[..., 1], fy), p[..., 2]], dim=-1)
        v = torch.where((on_ground | supported)[..., None], _scale_xz(v, 0.2), v)
        p, force = _robot_pushout(p, free, agent_pos, half, u, w, force)
    return p - center_off, torch.where(freem, v, 0.0), force
