"""Batched rearrangement (port of
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
(reference RobotForce, rearrange_sensors.py:814).

``RearrangeBatchedEnv`` is N rearrangement envs as one set of tensors
(reference RearrangeSim and its Pick/Place/articulated sub-tasks): objects
are (N, O, 3) box bottoms, grasping parents the object to the end effector
(the reference's kinematic_mode recipe, rearrange_grasp_manager.py:27-60),
the physics is ``kinematic`` (objects still unless held), ``gravity`` or
``contacts`` (v6 above), and the head camera renders the scene with the
boxes, articulated objects, Spot's legs and the arm links merged by closest
hit (``render_batch(..., dynamic=...)``). ``step_fn`` makes no host sync:
constants live on the env's device, built once.

``action_specs`` (registry-resolved task actions, task_actions.py) compose
the flat action vector in declaration order; ``step_fn`` merges their
commands (joint or EE deltas, grip, base velocity, stop, the base-or-arm
selection, PDDL nav/pick/place postconditions, a root teleport, a pick
target).

Habitat 3.0's second agent: a spec named ``agent_1_*`` turns on the
humanoid lane (``with_humanoid``). The humanoid is a kinematic agent that
spawns 2 m behind the robot's start, snapped to the navgrid, moves by its
own specs' base velocity, oracle navigation and PDDL nav, and grasps by its
PDDL pick and place or a pick target (an object it holds rides at its hand).
The observations then carry the reference's per-agent prefixes
(``agent_0_<robot sensor>``, ``agent_1_localization_sensor``, ...,
``other_agent_gps`` and ``agents_within_threshold`` for both), and the
measures ``did_agents_collide`` / ``num_agents_collide``.

The PDDL predicate sensors (``all_predicates``, and per agent
``multi_agent_all_predicates``) ground every type-compatible predicate of
the ``pddl_domain`` YAML (``multi_task/pddl_yaml.py``) over the env's
entities once, at construction, when a predicate sensor is declared or the
humanoid lane is on; the step evaluates them all on the device.

The reach task's per-episode goal is the JAX package's draw
``fold_in(PRNGKey(4321), episode)``, computed for every episode of the
table once, on the host (``utils/threefry.py``), and indexed by the episode
in the step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.articulated_agents import dynamics as arm_dyn
from habitat_torch.articulated_agents import kinematics as kin
from habitat_torch.articulated_agents import legs as legs_mod
from habitat_torch.articulated_agents.params import ROBOTS
from habitat_torch.core.dataset import EpisodeTable
from habitat_torch.device import resolve_device
from habitat_torch.ops import navgrid as ng
from habitat_torch.ops.raycast import render_batch
from habitat_torch.sims.scene import ScenePack
from habitat_torch.tasks.rearrange import rigid_body as rigid
from habitat_torch.tasks.rearrange.rigid_body import add_y, cross, matvec, norm
from habitat_torch.tasks.rearrange.task_actions import entity_positions
from habitat_torch.utils.geometry import rotate_agent_to_world, rotate_world_to_agent, yaw_to_forward
from habitat_torch.utils.threefry import reach_goal_offsets

# fixed kinematic EE offset in the agent frame (forward, lifted; stands in
# for the articulated arm's resting EE outside the arm controls)
EE_OFFSET = (0.0, 0.9, -0.45)
HELD_OFFSET = (0.0, 0.9, -0.45)
DOOR_LEN = 0.6  # revolute (fridge) door length, hinge to handle
OBJ_SEM_BASE = 100
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


# discrete kinematic action set (abstract-grasp mode)
A_STOP, A_FWD, A_LEFT, A_RIGHT, A_GRAB = 0, 1, 2, 3, 4
REARRANGE_ACTION_NAMES = ("stop", "move_forward", "turn_left", "turn_right", "grab_release")

TASKS = ("pick", "place", "reach", "rearrange", "nav_to_obj", "open", "close", "empty")
CONTROLS = ("discrete", "continuous", "arm", "arm_ee")
DYNAMICS = ("kinematic", "gravity", "contacts")
EXTRA_SENSORS = ("obj_goal_pos_sensor", "initial_gps_compass_sensor", "nav_to_skill_sensor")
PREDICATE_SENSORS = ("all_predicates", "multi_agent_all_predicates")
# the task's reward under its reference reward-measure uuid
REWARD_KEYS = {
    "pick": "pick_reward",
    "place": "place_reward",
    "reach": "rearrange_reach_reward",
    "open": "art_obj_reward",
    "close": "art_obj_reward",
    "nav_to_obj": "nav_to_obj_reward",
    "rearrange": "move_objects_reward",
}
_BOX_CORNERS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32
)
_BOX_FACES = np.array(
    [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
     [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]],
    np.int64,
)


@functools.lru_cache(maxsize=None)
def _box_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unit box's corners (8, 3), faces (12, 3) and triangles (12, 3, 3)
    on ``device``: copied from the host once per device."""
    corners = torch.as_tensor(_BOX_CORNERS, device=device)
    faces = torch.as_tensor(_BOX_FACES, device=device)
    return corners, faces, corners[faces]


def _xz_norm(x: torch.Tensor) -> torch.Tensor:
    """Norm of the xz components of (..., 3)."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 2] * x[..., 2])


def _tensor_fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@dataclasses.dataclass
class RearrangeTable:
    """Per-episode rearrangement data (extends the nav EpisodeTable): E
    episodes, O objects, A articulated objects."""

    nav: EpisodeTable
    obj_init: torch.Tensor  # (E, O, 3) box bottoms
    obj_valid: torch.Tensor  # (E, O) bool
    obj_half: torch.Tensor  # (E, O, 3) box half-extents from the asset
    obj_yaw: torch.Tensor  # (E, O) spawn yaw
    target_pos: torch.Tensor  # (E, O, 3) goal per object
    target_mask: torch.Tensor  # (E, O) bool: objects that must move
    pick_target: torch.Tensor  # (E,) i64: focus object of pick/place
    # articulated objects: prismatic (drawer, q metres along art_axis) or
    # revolute (fridge door, q radians about the vertical hinge at art_pos;
    # art_axis is the door's direction at q=0)
    art_pos: torch.Tensor  # (E, A, 3)
    art_axis: torch.Tensor  # (E, A, 3)
    art_valid: torch.Tensor  # (E, A) bool
    art_target: torch.Tensor  # (E,) i64
    art_init_q: torch.Tensor  # (E,)
    art_goal_q: torch.Tensor  # (E,)
    art_is_revolute: torch.Tensor  # (E, A) bool

    def to(self, device) -> "RearrangeTable":
        return RearrangeTable(**{k: v.to(device) for k, v in _tensor_fields(self).items()})


@dataclasses.dataclass
class RearrangeState:
    """Batched rearrangement env state, (N, ...) tensors."""

    ep_ptr: torch.Tensor  # (N,) i64 position in the per-env episode order
    ep_idx: torch.Tensor  # (N,) i64
    step: torch.Tensor  # (N,) i32
    pos: torch.Tensor  # (N, 3)
    yaw: torch.Tensor  # (N,)
    prev_pos: torch.Tensor  # (N, 3)
    obj_pos: torch.Tensor  # (N, O, 3) box bottoms
    obj_vel: torch.Tensor  # (N, O, 3)
    obj_quat: torch.Tensor  # (N, O, 4) (w, x, y, z)
    obj_omega: torch.Tensor  # (N, O, 3) world angular velocity
    art_q: torch.Tensor  # (N, A) joint states
    art_vel: torch.Tensor  # (N, A) joint velocities
    joints: torch.Tensor  # (N, J) arm joint positions
    leg_q: torch.Tensor  # (N, L) leg joints; L = 0 without legs
    joint_vel: torch.Tensor  # (N, J) (arm_dynamics)
    motor_target: torch.Tensor  # (N, J) accumulated PD motor targets
    held: torch.Tensor  # (N,) i64, -1 = none
    ever_held: torch.Tensor  # (N,) bool: picked the target at least once
    # the second agent, the humanoid (with_humanoid; carried along otherwise)
    human_pos: torch.Tensor  # (N, 3)
    human_yaw: torch.Tensor  # (N,)
    human_held: torch.Tensor  # (N,) i64, -1 = none
    accum_force: torch.Tensor  # (N,) running contact force on the robot
    stop_called: torch.Tensor  # (N,) bool
    collided: torch.Tensor  # (N,) bool
    collision_count: torch.Tensor  # (N,) i32
    last_action: torch.Tensor  # (N,) i32
    episode_over: torch.Tensor  # (N,) bool
    episode_count: torch.Tensor  # (N,) i32

    def to(self, device) -> "RearrangeState":
        return RearrangeState(**{k: v.to(device) for k, v in _tensor_fields(self).items()})


class _ObjectsOnce:
    """The env as the grounded predicates read it, with one state's object
    positions computed once for all of them."""

    def __init__(self, env, state):
        self._env = env
        self._objs = env._obj_world(state)

    def __getattr__(self, name):
        return getattr(self._env, name)

    def _obj_world(self, state):
        return self._objs


class RearrangeBatchedEnv:
    """N batched rearrangement envs on one device.

    task: "pick" (success = holding the target object), "place" (the target
    at its goal and released), "rearrange" (all targets at their goals),
    "nav_to_obj" (near and facing the target, then stop), "open" / "close"
    (the articulated target at its goal state), "empty" (no objective).
    control: "discrete" (``REARRANGE_ACTION_NAMES``), "continuous" (base
    velocity and grip), "arm" (joint deltas, grip, base velocity; kinematic
    or, with ``arm_dynamics``, PD motors under gravity), "arm_ee" (an EE
    displacement through 8 IK iterations, grip, base velocity).

    ``sensor_keys`` / ``measure_keys`` select what the env emits; unknown
    keys raise ``ValueError`` at construction. ``observation_shapes`` maps
    each key to its (shape, dtype) per env."""

    def __init__(
        self,
        pack: ScenePack,
        table: RearrangeTable,
        episode_order: np.ndarray,  # (N, L) per-env episode schedule (global N)
        *,
        task: str = "pick",
        max_episode_steps: int = 300,
        grasp_distance: float = 1.0,
        at_goal_thresh: float = 0.15,
        success_reward: float = 10.0,
        slack_reward: float = -0.01,
        dist_reward_scale: float = 1.0,
        forward_step: float = 0.25,
        turn_angle_deg: float = 10.0,
        render_size: Optional[Tuple[int, int]] = (128, 128),
        with_visual: bool = True,
        continuous: bool = False,
        dynamics: str = "kinematic",
        control: Optional[str] = None,
        robot: str = "FetchRobot",
        max_joint_delta: float = 0.1,
        arm_dynamics: bool = False,
        ee_delta: float = 0.06,
        arm_grasp_distance: float = 0.25,
        max_accum_force: float = -1.0,
        constraint_violation_ends_episode: bool = False,
        constraint_violation_drops_object: bool = False,
        sensor_keys: Optional[Sequence[str]] = None,
        measure_keys: Optional[Sequence[str]] = None,
        action_specs: Optional[list] = None,
        pddl_domain: str = "fp",
        device=None,
        rows: slice = slice(None),
    ):
        if control is None:
            control = "continuous" if continuous else "discrete"
        for name, value, allowed in (("task", task, TASKS), ("control", control, CONTROLS),
                                     ("dynamics", dynamics, DYNAMICS)):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}: the port has {allowed}")
        dev = resolve_device(device)
        self.device = dev
        self.pack = pack.to(dev)
        self.table = table.to(dev)
        # the envs are ``rows`` of the global order (a DD-PPO rank's; all by default)
        episode_order = np.asarray(episode_order)[rows]
        self.order = torch.as_tensor(episode_order, dtype=torch.int64, device=dev)
        self.num_envs = int(episode_order.shape[0])
        self._order_len = int(episode_order.shape[1])
        self._env_ids = torch.arange(self.num_envs, device=dev)
        self.task = task
        self.dynamics = dynamics
        self.max_accum_force = max_accum_force
        self.cv_ends_episode = constraint_violation_ends_episode
        self.cv_drops_object = constraint_violation_drops_object
        self.max_episode_steps = max_episode_steps
        self.grasp_distance = grasp_distance
        self.at_goal_thresh = at_goal_thresh
        self.success_reward = success_reward
        self.slack_reward = slack_reward
        self.dist_reward_scale = dist_reward_scale
        self.fwd = forward_step
        self.turn = float(np.deg2rad(turn_angle_deg))
        self.with_visual = with_visual and render_size is not None
        self.render_size = render_size
        self.num_objects = int(self.table.obj_init.shape[1])
        self.num_art = int(self.table.art_pos.shape[1])
        self._o_lane = torch.arange(self.num_objects, device=dev)[None]
        self._a_lane = torch.arange(self.num_art, device=dev)[None]
        self.control = control
        self.continuous = control != "discrete"
        self.rparams = ROBOTS[robot]
        self.n_joints = self.rparams.arm_joints
        self.max_joint_delta = max_joint_delta
        self.arm_dynamics = arm_dynamics
        self._arm_dyn = arm_dyn.default_arm_dynamics(self.rparams, kp=300.0, kd=30.0, device=dev)
        self.ee_delta = ee_delta
        f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
        self._resting = f32(self.rparams.resting_pose)
        self._arm_root = f32(self.rparams.arm_root_offset)
        self._joint_lo = f32(self.rparams.joint_limits_lower)
        self._joint_hi = f32(self.rparams.joint_limits_upper)
        self._leg_init = f32(legs_mod.LEG_INIT[: self.rparams.leg_joints])
        self._ee_offset = f32(EE_OFFSET)
        # resting EE in the agent frame (RelativeRestingPositionSensor origin)
        self._resting_ee_local = kin.ee_position(self.rparams, self._resting) + self._arm_root
        # the reach task's goal less the resting EE, per episode of the table
        # (reference RearrangeReachTask.reset, sub_tasks/reach_task.py:29-55)
        self._reach_offsets = None
        if task == "reach":
            E = int(self.table.obj_init.shape[0])
            self._reach_offsets = torch.from_numpy(reach_goal_offsets(E)).to(dev)
        if control in ("arm", "arm_ee"):
            self.grasp_distance = arm_grasp_distance
        self._extra_sensors = tuple(k for k in EXTRA_SENSORS if k in (sensor_keys or ()))
        self._build_dynamic_constants()

        self.action_specs = list(action_specs) if action_specs else None
        # Habitat 3.0's second agent: agent_1_* specs drive the humanoid lane
        # (reference hssd_spot_human.yaml's per-agent prefixed actions)
        self.with_humanoid = bool(self.action_specs) and any(s.agent_idx >= 1 for s in self.action_specs)
        # the predicate sensors' universe, grounded once; always on the
        # two-agent env (reference plan_pop.yaml declares all_predicates)
        self._grounded_preds = None
        if self.with_humanoid or any(k in PREDICATE_SENSORS for k in (sensor_keys or ())):
            self._grounded_preds = self._ground_all_predicates(pddl_domain)
        if self.action_specs is not None:
            # composed registry-resolved actions: one flat float vector, each
            # spec's slice in declaration order
            self._spec_dims = tuple(s.dims(self) for s in self.action_specs)
            self.action_dim = max(sum(self._spec_dims), 1)
            self.action_names = tuple(s.name or type(s).__name__ for s in self.action_specs)
        elif control == "arm":
            # [J joint deltas | grip | base lin | base ang] (reference
            # ArmRelPosAction + MagicGraspAction + BaseVelAction)
            self.action_names, self.action_dim = ("arm_action", "base_velocity"), self.n_joints + 3
        elif control == "arm_ee":
            # [EE delta xyz | grip | base lin | base ang] (ArmEEAction)
            self.action_names, self.action_dim = ("arm_ee_action", "base_velocity"), 6
        elif control == "continuous":
            # (lin_vel, ang_vel, grip) in [-1, 1]
            self.action_names, self.action_dim = ("base_velocity", "grip"), 3
        else:
            self.action_names = REARRANGE_ACTION_NAMES
            self.num_actions = len(REARRANGE_ACTION_NAMES)

        # the key sets come from one fresh state (the role of the JAX
        # package's eval_shape): declared keys are validated against what the
        # env really emits, so the two cannot drift
        self.sensor_keys = tuple(sensor_keys) if sensor_keys is not None else None
        self.measure_keys = tuple(measure_keys) if measure_keys is not None else None
        fresh = self._fresh(self.order[:, 0])

        def shapes_of(obs):
            return {k: (tuple(v.shape[1:]), v.dtype) for k, v in obs.items()}

        shapes = shapes_of(self._state_observations(fresh))
        if self.with_visual:
            h, w = render_size
            shapes["robot_head_depth"] = ((h, w, 1), torch.float32)
            shapes["robot_head_rgb"] = ((h, w, 3), torch.uint8)
        if self.with_humanoid:
            shapes = self._prefixed(shapes, shapes_of(self._agent_1_observations(fresh)))
        if self.sensor_keys is not None:
            bad = [k for k in self.sensor_keys if k not in shapes]
            if bad:
                raise ValueError(f"declared sensors {bad} are not available on this env (task={task}); "
                                 f"available: {sorted(shapes)}")
            if not self.with_humanoid:  # the two-agent env keeps its own layout
                shapes = {k: v for k, v in shapes.items() if k in self.sensor_keys}
        self.observation_shapes = shapes
        if self.measure_keys is not None:
            avail = set(self._measures(fresh)) | set(self._posthoc_measure_keys())
            bad = [k for k in self.measure_keys if k not in avail]
            if bad:
                raise ValueError(f"declared measures {bad} are not available on this env (task={task}); "
                                 f"available: {sorted(avail)}")

    # ------------------------------------------------------------------
    def _build_dynamic_constants(self):
        """The render's per-triangle semantics and colours (objects, then
        articulated objects, Spot's legs, the arm links), fixed per env:
        built once here, the palette from ``default_rng(7)``."""
        dev, n = self.device, self.num_envs
        n_dyn = self.num_objects + self.num_art
        palette = torch.as_tensor(np.random.default_rng(7).uniform(0.3, 1.0, (n_dyn, 3)), dtype=torch.float32,
                                  device=dev)
        sem = [(torch.arange(n_dyn, device=dev) + OBJ_SEM_BASE).to(torch.int32).repeat_interleave(12)]
        color = [palette.repeat_interleave(12, 0)]
        extra = []
        if self.rparams.leg_joints > 0:
            extra.append((96, 0.85))  # 8 leg segments of 12 triangles
        if self._arm_mode():
            extra.append((12 * self.n_joints, 0.55))
        for count, grey in extra:
            sem.append(torch.full((count,), OBJ_SEM_BASE - 1, dtype=torch.int32, device=dev))
            color.append(torch.full((count, 3), grey, dtype=torch.float32, device=dev))
        self._dyn_sem = torch.cat(sem)[None].expand(n, -1).contiguous()
        self._dyn_color = torch.cat(color)[None].expand(n, -1, -1).contiguous()

    def _ground_all_predicates(self, pddl_domain: str):
        """Every type-compatible grounding of the domain's predicates over
        the env's entities, sorted by compact_str (the reference's
        GlobalPredicatesSensor universe, pddl_domain.py:420-439): the O
        movable targets, their goals, the articulated receptacles (fridges
        when revolute and the domain has the type, else cabinets), the
        robot and, with the humanoid, ``robot_1``. Objects come before
        robots, so (object, robot) signatures ground."""
        from habitat_torch.tasks.rearrange.multi_task import pddl_yaml as py

        dom = py.YamlPddlDomain.from_yaml(py.domain_path(pddl_domain))
        O = self.num_objects
        ents = {f"any_targets|{i}": py.PddlEntity(f"any_targets|{i}", py.MOVABLE_TYPE) for i in range(O)}
        ents.update({f"TARGET_any_targets|{i}": py.PddlEntity(f"TARGET_any_targets|{i}", py.GOAL_TYPE)
                     for i in range(O)})
        revolute = self.table.art_is_revolute.cpu().numpy()  # read once, at construction
        for j in range(self.num_art):
            t = "fridge_type" if revolute[:, j].any() else "cab_type"
            if t == "fridge_type" and not dom.types.is_subtype(t, "art_receptacle_entity_type"):
                t = "cab_type"
            ents[f"art_{j}"] = py.PddlEntity(f"art_{j}", t)
            dom.art_slots.setdefault(f"art_{j}", j)
        ents["robot_0"] = py.PddlEntity("robot_0", py.ROBOT_TYPE)
        if self.with_humanoid:
            ents["robot_1"] = py.PddlEntity("robot_1", py.ROBOT_TYPE)
        self.target_order = py.target_order(self.table.target_mask)  # read by every movable-entity predicate
        return tuple(dom.get_possible_predicates(ents))

    def _predicate_vector(self, state: RearrangeState) -> torch.Tensor:
        """(N, P) float32 truth of each grounded predicate; the object
        positions are computed once for all of them."""
        view = _ObjectsOnce(self, state)
        return torch.stack([p.is_true(view, state).float() for p in self._grounded_preds], dim=-1)

    def _sid(self, state: RearrangeState) -> torch.Tensor:
        return self.table.nav.scene_idx[state.ep_idx].long()

    @property
    def capabilities(self) -> Tuple[str, ...]:
        """Capability tags the registry specs (sensors.py) check."""
        return (self.task, self.control, self.dynamics)

    def _arm_mode(self) -> bool:
        return self.control in ("arm", "arm_ee")

    def _posthoc_measure_keys(self) -> Tuple[str, ...]:
        """Measure keys ``step_fn`` adds after ``_measures``."""
        keys = ["constraint_violation", "did_violate_hold_constraint", "bad_called_terminate"]
        if self.task in REWARD_KEYS:
            keys.append(REWARD_KEYS[self.task])
        if self.task == "rearrange":
            keys.append("pddl_subgoal_reward")
        return tuple(keys)

    def _ee_local(self, joints: torch.Tensor) -> torch.Tensor:
        """(N, J) joints -> (N, 3) EE in the agent frame."""
        return kin.ee_position(self.rparams, joints) + self._arm_root

    def _ee_pos(self, state: RearrangeState) -> torch.Tensor:
        if self._arm_mode():
            return state.pos + rotate_agent_to_world(self._ee_local(state.joints), state.yaw)
        return state.pos + rotate_agent_to_world(self._ee_offset.expand(state.pos.shape), state.yaw)

    def _desired_rest(self, state: RearrangeState) -> torch.Tensor:
        """The EE's desired rest in the agent frame: the resting pose, or
        the reach task's per-episode workspace goal."""
        if self._reach_offsets is None:
            return self._resting_ee_local
        return self._resting_ee_local + self._reach_offsets[state.ep_idx]

    def _target_obj(self, state: RearrangeState) -> torch.Tensor:
        return self.table.pick_target[state.ep_idx]

    def _door_dir(self, axis: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """A door's direction after swinging by q about +Y from ``axis``."""
        cq, sq = torch.cos(q), torch.sin(q)
        return torch.stack([cq * axis[..., 0] + sq * axis[..., 2], axis[..., 1], -sq * axis[..., 0] + cq * axis[..., 2]],
                           dim=-1)

    def _handle_pos(self, state: RearrangeState) -> torch.Tensor:
        """(N, 3) world position of the target's handle: the drawer's front
        at its extension, or the door's free edge swung by q."""
        a = self.table.art_target[state.ep_idx]
        base = self.table.art_pos[state.ep_idx, a]
        axis = self.table.art_axis[state.ep_idx, a]
        q = state.art_q[self._env_ids, a]
        prism = base + axis * (q[:, None] + 0.3)
        rev = base + self._door_dir(axis, q) * DOOR_LEN
        is_rev = self.table.art_is_revolute[state.ep_idx, a]
        return add_y(torch.where(is_rev[:, None], rev, prism), 0.5)

    def _obj_world(self, state: RearrangeState) -> torch.Tensor:
        """(N, O, 3) object positions with the held one at the EE and the
        humanoid's at its hand (0.8 m up, 0.3 m ahead)."""
        is_held = self._o_lane == state.held[:, None]
        out = torch.where(is_held[..., None], self._ee_pos(state)[:, None, :], state.obj_pos)
        if self.with_humanoid:
            hand = add_y(state.human_pos, 0.8) + yaw_to_forward(state.human_yaw) * 0.3
            out = torch.where((self._o_lane == state.human_held[:, None])[..., None], hand[:, None, :], out)
        return out

    # -- observations ---------------------------------------------------
    def _state_observations(self, state: RearrangeState) -> Dict[str, torch.Tensor]:
        """Every state sensor (reference rearrange_sensors.py:51-468), in the
        agent frame where the reference transforms."""
        tgt = self._target_obj(state)
        objs = self._obj_world(state)
        tgt_pos = objs[self._env_ids, tgt]
        goal_pos = self.table.target_pos[state.ep_idx, tgt]
        ee = self._ee_pos(state)

        def rel(p):
            return rotate_world_to_agent(p - state.pos, state.yaw)

        def gps_compass(rel_p):
            # polar (rho, -phi) of an agent-frame position; forward is -z
            return torch.stack([_xz_norm(rel_p), -torch.atan2(rel_p[:, 0], -rel_p[:, 2])], dim=-1)

        rel_start, rel_goal, rel_ee = rel(tgt_pos), rel(goal_pos), rel(ee)
        obs = {
            "obj_start_sensor": rel_start,
            "obj_goal_sensor": rel_goal,
            "abs_obj_start_sensor": tgt_pos,
            "abs_obj_goal_sensor": goal_pos,
            "joint": state.joints,
            "joint_vel": state.joint_vel,
            "is_holding": (state.held >= 0).float()[:, None],
            "ee_pos": rel_ee,
            "relative_resting_position": rel_ee - self._desired_rest(state),
            "localization_sensor": torch.cat([state.pos, state.yaw[:, None]], dim=-1),
            "obj_start_gps_compass": gps_compass(rel_start),
            "obj_goal_gps_compass": gps_compass(rel_goal),
        }
        if self._grounded_preds is not None:
            # GlobalPredicatesSensor (pddl_sensors.py:25-57); the per-agent
            # MultiAgentGlobalPredicatesSensor (multi_agent_sensors.py
            # :121-156) reads the same universe
            obs["all_predicates"] = obs["multi_agent_all_predicates"] = self._predicate_vector(state)
        if "obj_goal_pos_sensor" in self._extra_sensors:
            # the target in the EE frame, oriented as the base
            obs["obj_goal_pos_sensor"] = rotate_world_to_agent(tgt_pos - ee, state.yaw)
        if "initial_gps_compass_sensor" in self._extra_sensors:
            st_pos = self.table.nav.start_pos[state.ep_idx]
            st_yaw = self.table.nav.start_yaw[state.ep_idx]
            obs["initial_gps_compass_sensor"] = gps_compass(rotate_world_to_agent(state.pos - st_pos, st_yaw))
        if "nav_to_skill_sensor" in self._extra_sensors:
            # pick (1) while nothing is held, place (2) after
            skill = torch.where(state.held >= 0, 2, 1)
            obs["nav_to_skill_sensor"] = torch.nn.functional.one_hot(skill, 8).float()
        return obs

    def _observations(self, state: RearrangeState) -> Dict[str, torch.Tensor]:
        obs = self._state_observations(state)
        if self.with_visual:
            h, w = self.render_size
            frames = render_batch(
                self.pack, self._sid(state), add_y(state.pos, 1.25), state.yaw,
                torch.full_like(state.yaw, -0.45),  # the head camera tilts down
                height=h, width=w, dynamic=self._dynamic_geometry(state),
            )
            obs["robot_head_depth"] = frames["depth"]
            obs["robot_head_rgb"] = frames["rgb"]
        if self.with_humanoid:
            return self._prefixed(obs, self._agent_1_observations(state))
        if self.sensor_keys is not None:
            obs = {k: obs[k] for k in self.sensor_keys if k in obs}
        return obs

    def _agent_1_observations(self, state: RearrangeState) -> Dict[str, torch.Tensor]:
        """The humanoid's sensors and the two agents' mutual ones: its
        localization, the target and its goal in its frame, whether it
        holds, each agent's GPS of the other (forward, right) in its own
        frame, and whether they are within 2 m."""
        tgt = self._target_obj(state)
        tgt_pos = self._obj_world(state)[self._env_ids, tgt]
        goal_pos = self.table.target_pos[state.ep_idx, tgt]

        def gps(p_self, yaw_self, p_other):
            rel = rotate_world_to_agent(p_other - p_self, yaw_self)
            return torch.stack([-rel[:, 2], rel[:, 0]], dim=-1)

        within = (_xz_norm(state.human_pos - state.pos) < 2.0).float()[:, None]
        return {
            "agent_1_localization_sensor": torch.cat([state.human_pos, state.human_yaw[:, None]], dim=-1),
            "agent_1_obj_start_sensor": rotate_world_to_agent(tgt_pos - state.human_pos, state.human_yaw),
            "agent_1_obj_goal_sensor": rotate_world_to_agent(goal_pos - state.human_pos, state.human_yaw),
            "agent_1_is_holding": (state.human_held >= 0).float()[:, None],
            "agent_0_other_agent_gps": gps(state.pos, state.yaw, state.human_pos),
            "agent_1_other_agent_gps": gps(state.human_pos, state.human_yaw, state.pos),
            "agent_0_agents_within_threshold": within,
            "agent_1_agents_within_threshold": within,
        }

    @staticmethod
    def _prefixed(obs: Dict, agent_1: Dict) -> Dict:
        """The reference's multi-agent layout (rearrange_sim.py:68-82): the
        robot's sensors under ``agent_0_``, ``all_predicates`` task-level
        and ``multi_agent_all_predicates`` under both prefixes, then
        ``agent_1``'s entries."""
        obs = dict(obs)
        preds = obs.pop("all_predicates", None)
        obs.pop("multi_agent_all_predicates", None)
        out = {f"agent_0_{k}": v for k, v in obs.items()}
        if preds is not None:
            out["all_predicates"] = out["agent_0_multi_agent_all_predicates"] = preds
            out["agent_1_multi_agent_all_predicates"] = preds
        out.update(agent_1)
        return out

    def _arm_geometry(self, state: RearrangeState) -> Tuple[torch.Tensor, torch.Tensor]:
        """The arm's links as boxes of radius 4 cm: (N, J*12, 3, 3) world
        triangles and (N, J*12) valid."""
        N, J = self.num_envs, self.n_joints
        corners, faces, _ = _box_tables(self.device)
        pts_agent = kin.fk_positions(self.rparams, state.joints) + self._arm_root  # (N, J+1, 3)
        pts_world = state.pos[:, None, :] + rotate_agent_to_world(pts_agent, state.yaw[:, None])
        p0, p1 = pts_world[:, :-1], pts_world[:, 1:]
        seg = p1 - p0
        ln = norm(seg)[..., None]
        u = seg / torch.clamp_min(ln, 1e-6)
        vertical = u[..., 1].abs() > 0.9
        ref = torch.stack([vertical, ~vertical, torch.zeros_like(vertical)], dim=-1).float()  # x or up
        v = cross(u, ref)
        v = v / torch.clamp_min(norm(v)[..., None], 1e-6)
        w = cross(u, v)
        r = 0.04
        mid = 0.5 * (p0 + p1)
        h = 0.5 * ln
        box = (
            mid[:, :, None, :]
            + corners[None, None, :, 0:1] * u[:, :, None, :] * h[:, :, None, :]
            + corners[None, None, :, 1:2] * v[:, :, None, :] * r
            + corners[None, None, :, 2:3] * w[:, :, None, :] * r
        )  # (N, J, 8, 3)
        tris = box[:, :, faces, :].reshape(N, J * 12, 3, 3)
        return tris, torch.ones((N, J * 12), dtype=torch.bool, device=self.device)

    def _dynamic_geometry(self, state: RearrangeState) -> Dict[str, torch.Tensor]:
        """Movable geometry for the render's dynamic pass: the objects as the
        boxes the contact step uses, posed by their quaternions; the
        articulated objects as 0.72 m boxes (drawers slide, doors swing);
        Spot's leg segments; the arm links in the arm controls."""
        N, A = self.num_envs, self.num_art
        _, _, unit_tri = _box_tables(self.device)
        ep = state.ep_idx
        halves = self.table.obj_half[ep]  # (N, O, 3)
        scaled = unit_tri[None, None] * halves[:, :, None, None, :]
        obj_tri = torch.einsum("noij,noktj->nokti", rigid.quat_to_matrix(state.obj_quat), scaled)
        center = add_y(self._obj_world(state), halves[..., 1])  # boxes sit on their bottoms
        art_tri = unit_tri * OBJ_HALF * 3.0
        axis = self.table.art_axis[ep]
        q = state.art_q
        is_rev = self.table.art_is_revolute[ep][..., None]
        art_center = add_y(self.table.art_pos[ep] + torch.where(
            is_rev, self._door_dir(axis, q) * (DOOR_LEN * 0.5), axis * q[..., None]), 0.4)
        centers = torch.cat([center, art_center], dim=1)
        tris_all = torch.cat([obj_tri, art_tri.expand(N, A, 12, 3, 3)], dim=1)
        v = (centers[:, :, None, None, :] + tris_all).reshape(N, -1, 3, 3)
        valid = torch.cat([self.table.obj_valid[ep], self.table.art_valid[ep]], dim=1).repeat_interleave(12, 1)
        if self.rparams.leg_joints > 0:
            leg_v, leg_valid = legs_mod.leg_segment_boxes(add_y(state.pos, 0.5), state.yaw, state.leg_q)
            v = torch.cat([v, leg_v], dim=1)
            valid = torch.cat([valid, leg_valid], dim=1)
        if self._arm_mode():
            arm_v, arm_valid = self._arm_geometry(state)
            v = torch.cat([v, arm_v], dim=1)
            valid = torch.cat([valid, arm_valid], dim=1)
        return dict(v0=v[:, :, 0], e1=v[:, :, 1] - v[:, :, 0], e2=v[:, :, 2] - v[:, :, 0], valid=valid,
                    color=self._dyn_color, sem=self._dyn_sem)

    # -- measures ----------------------------------------------------------
    def _measures(self, state: RearrangeState) -> Dict[str, torch.Tensor]:
        n_idx, ep = self._env_ids, state.ep_idx
        tgt = self._target_obj(state)
        objs = self._obj_world(state)
        tgt_pos = objs[n_idx, tgt]
        goal = self.table.target_pos[ep, tgt]
        ee = self._ee_pos(state)
        all_d = norm(objs - self.table.target_pos[ep])
        tmask = self.table.target_mask[ep]
        at_goal = (all_d < self.at_goal_thresh) & tmask
        frac_at_goal = at_goal.sum(1) / torch.clamp_min(tmask.sum(1), 1)
        rel_ee = rotate_world_to_agent(ee - state.pos, state.yaw)
        zeros = torch.zeros_like(state.yaw)
        m = {
            "object_to_goal_distance": norm(tgt_pos - goal),
            "ee_to_object_distance": norm(tgt_pos - ee),
            "ee_to_rest_distance": norm(rel_ee - self._desired_rest(state)),
            "ee_to_goal_distance": norm(goal - ee),
            "base_to_object_distance": _xz_norm(tgt_pos - state.pos),
            "did_pick_object": state.ever_held.float(),
            "is_holding": (state.held >= 0).float(),
            "obj_at_goal": at_goal[n_idx, tgt].float(),
            "objects_at_goal_fraction": frac_at_goal,
            "does_want_terminate": state.stop_called.float(),
            "zero": zeros,
            # the accumulated robot-object penetration force (reference
            # RobotForce / ForceTerminate); zero in kinematic mode
            "robot_force": state.accum_force,
            "force_terminate": ((state.accum_force > self.max_accum_force) if self.max_accum_force > 0
                                else torch.zeros_like(state.stop_called)).float(),
            "robot_collisions": state.collision_count.float(),
            "num_steps": state.step.float(),
        }
        m["articulated_agent_force"] = m["robot_force"]
        if self.with_humanoid:
            # reference DidAgentsCollide / NumAgentsCollide (multi_agent_sensors.py:18)
            m["did_agents_collide"] = (_xz_norm(state.human_pos - state.pos) < 0.5).float()
            m["num_agents_collide"] = m["did_agents_collide"]
        if self.task in ("open", "close"):
            q = state.art_q[n_idx, self.table.art_target[ep]]
            m["art_obj_state"] = q
            m["art_obj_at_desired_state"] = ((q - self.table.art_goal_q[ep]).abs() < 0.05).float()
            m["ee_to_marker_dist"] = _xz_norm(self._handle_pos(state) - ee)
            m["ee_dist_to_marker"] = m["ee_to_marker_dist"]
            m["success"] = m["art_obj_at_desired_state"]
            m["art_obj_success"] = m["success"]
        elif self.task == "reach":
            # EE to the workspace goal (reference EndEffectorToRestDistance and
            # RearrangeReachSuccess, sub_tasks/reach_sensors.py; succ_thresh 0.2)
            m["ee_to_resting_distance"] = m["ee_to_rest_distance"]
            m["rearrange_reach_success"] = (m["ee_to_resting_distance"] < 0.2).float()
            m["success"] = m["rearrange_reach_success"]
        elif self.task == "pick":
            m["pick_success"] = (state.held == tgt).float()
            m["success"] = m["pick_success"]
        elif self.task == "place":
            m["place_success"] = (at_goal[n_idx, tgt] & (state.held < 0) & state.ever_held).float()
            m["success"] = m["place_success"]
        elif self.task == "rearrange":
            m["success"] = ((frac_at_goal >= 1.0) & (state.held < 0)).float()
            m["pddl_success"] = m["success"]
            m["pddl_stage_goals"] = frac_at_goal
        elif self.task == "nav_to_obj":
            d_xz = _xz_norm(tgt_pos - state.pos)
            rel = rotate_world_to_agent(tgt_pos - state.pos, state.yaw)
            ang = torch.atan2(rel[:, 0], -rel[:, 2]).abs()
            m["rot_dist_to_goal"] = ang
            m["dist_to_goal"] = d_xz
            m["nav_to_obj_success"] = ((d_xz < 1.5) & (ang < 0.5) & state.stop_called).float()
            m["nav_to_pos_success"] = (d_xz < 1.5).float()
            m["success"] = m["nav_to_obj_success"]
        else:  # empty
            m["success"] = zeros
        return m

    def _reward(self, prev_m, m) -> torch.Tensor:
        """Distance-delta shaping and the success bonus (reference
        RearrangePickReward / PlaceReward structure)."""
        r = torch.full((self.num_envs,), self.slack_reward, device=self.device)
        s = self.dist_reward_scale
        if self.task in ("open", "close"):
            r = r + s * (prev_m["ee_to_marker_dist"] - m["ee_to_marker_dist"])
            r = r + 2.0 * (m["art_obj_state"] - prev_m["art_obj_state"]).abs()
        elif self.task == "reach":
            # dense EE-to-goal delta (reference RearrangeReachReward, diff mode)
            r = r + s * (prev_m["ee_to_resting_distance"] - m["ee_to_resting_distance"])
        elif self.task == "pick":
            r = r + s * (prev_m["ee_to_object_distance"] - m["ee_to_object_distance"])
            r = r + 1.0 * (m["did_pick_object"] - prev_m["did_pick_object"])
        elif self.task in ("place", "rearrange"):
            if self.task == "rearrange":
                # staged (reference MoveObjectsReward): EE to object until the
                # first pick, a one-time pick bonus
                not_picked = 1.0 - prev_m["did_pick_object"]
                r = r + s * not_picked * (prev_m["ee_to_object_distance"] - m["ee_to_object_distance"])
                r = r + 1.0 * torch.clamp_min(m["did_pick_object"] - prev_m["did_pick_object"], 0.0)
            r = r + s * (prev_m["object_to_goal_distance"] - m["object_to_goal_distance"])
        elif self.task == "nav_to_obj":
            r = r + s * (prev_m["dist_to_goal"] - m["dist_to_goal"])
            near = (m["dist_to_goal"] < 1.5).float()
            r = r + 0.5 * near * (prev_m["rot_dist_to_goal"] - m["rot_dist_to_goal"])
        return r + self.success_reward * torch.clamp_min(m["success"] - prev_m["success"], 0.0)

    # -- lifecycle -----------------------------------------------------------
    def _fresh(self, ep_idx: torch.Tensor) -> RearrangeState:
        n, dev, t = self.num_envs, self.device, self.table
        pos = t.nav.start_pos[ep_idx]

        def flags():
            return torch.zeros(n, dtype=torch.bool, device=dev)

        def counts():
            return torch.zeros(n, dtype=torch.int32, device=dev)

        return RearrangeState(
            ep_ptr=torch.zeros(n, dtype=torch.int64, device=dev),
            ep_idx=ep_idx,
            step=counts(),
            pos=pos,
            yaw=t.nav.start_yaw[ep_idx],
            prev_pos=pos,
            obj_pos=t.obj_init[ep_idx],
            obj_vel=torch.zeros((n, self.num_objects, 3), device=dev),
            obj_quat=rigid.quat_from_yaw(t.obj_yaw[ep_idx]),
            obj_omega=torch.zeros((n, self.num_objects, 3), device=dev),
            art_q=t.art_init_q[ep_idx][:, None].expand(n, self.num_art) * t.art_valid[ep_idx],
            art_vel=torch.zeros((n, self.num_art), device=dev),
            joints=self._resting.repeat(n, 1),
            leg_q=self._leg_init.repeat(n, 1),
            joint_vel=torch.zeros((n, self.n_joints), device=dev),
            motor_target=self._resting.repeat(n, 1),
            held=torch.full((n,), -1, dtype=torch.int64, device=dev),
            ever_held=flags(),
            # the humanoid spawns 2 m behind the robot, snapped to the navgrid
            # (the generator has no humanoid start; hab3 episodes carry one)
            human_pos=ng.snap_to_navigable(self.pack, t.nav.scene_idx[ep_idx].long(),
                                           pos + yaw_to_forward(t.nav.start_yaw[ep_idx] + np.pi) * 2.0),
            human_yaw=t.nav.start_yaw[ep_idx],
            human_held=torch.full((n,), -1, dtype=torch.int64, device=dev),
            accum_force=torch.zeros(n, device=dev),
            stop_called=flags(),
            collided=flags(),
            collision_count=counts(),
            last_action=torch.full((n,), -1, dtype=torch.int32, device=dev),
            episode_over=flags(),
            episode_count=counts(),
        )

    def reset_fn(self) -> Tuple[RearrangeState, Dict[str, torch.Tensor]]:
        state = self._fresh(self.order[:, 0])
        return state, self._observations(state)

    def _commands(self, state: RearrangeState, actions: torch.Tensor):
        """The action specs' merged commands, the robot's and the humanoid's
        (agent_1_* specs, steering the humanoid's pose): each spec reads its
        slice of the flat action vector in declaration order."""
        acts = actions.float()
        cmd: Dict[str, torch.Tensor] = {}
        cmd1: Dict[str, torch.Tensor] = {}
        off = 0
        for spec, w in zip(self.action_specs, self._spec_dims):
            x = acts[:, off:off + w]
            if self.with_humanoid and spec.agent_idx >= 1:
                spec.contribute(self, state, x, cmd1, pose=(state.human_pos, state.human_yaw))
            else:
                spec.contribute(self, state, x, cmd)
            off += w
        if "sel_arm" in cmd:
            # SelectBaseOrArmAction (reference actions.py:74-99): base and arm
            # may not move in the same step; the deselected group is gated
            sel = cmd["sel_arm"]  # (N,) bool, True = arm
            for k in ("dq", "ee_delta"):
                if k in cmd:
                    cmd[k] = torch.where(sel[:, None], cmd[k], 0.0)
            for k in ("lin", "ang"):
                if k in cmd:
                    cmd[k] = torch.where(sel, 0.0, cmd[k])
        return cmd, cmd1

    def _arm_step(self, state: RearrangeState, dq=None, ee_delta=None):
        """(joints, joint_vel, motor_target) after joint deltas ``dq`` or an
        EE displacement ``ee_delta`` (agent frame)."""
        joints, joint_vel, motor = state.joints, state.joint_vel, state.motor_target
        if dq is not None:
            if self.arm_dynamics:
                # the delta accumulates on the motor target; PD motors and
                # gravity integrate (reference ArmRelPosAction)
                motor = torch.clamp(state.motor_target + dq, min=self._joint_lo, max=self._joint_hi)
                joints, joint_vel = arm_dyn.step_arm(self.rparams, self._arm_dyn, state.joints, state.joint_vel,
                                                     motor, dt=1.0 / 30.0, substeps=4)
            else:
                # ArmRelPosKinematicAction: joints set directly
                joints = torch.clamp(state.joints + dq, min=self._joint_lo, max=self._joint_hi)
        elif ee_delta is not None:
            # DLS-IK toward the displaced EE target (ArmEEAction)
            target = self._ee_local(state.joints) - self._arm_root + ee_delta
            joints = kin.ik_solve(self.rparams, target, state.joints, iters=8)
        return joints, joint_vel, motor

    def _controls(self, state: RearrangeState, actions: torch.Tensor, cmd: Dict[str, torch.Tensor]):
        """Actions (with action specs, their commands ``cmd``) -> (joints,
        joint_vel, motor_target, grip, logged action, stop, yaw, move)."""
        grip = None
        if self.action_specs is not None:
            joints, joint_vel, motor = self._arm_step(state, cmd.get("dq"), cmd.get("ee_delta"))
            no = torch.zeros_like(state.stop_called)
            grip = cmd.get("grip", no)
            zeros = torch.zeros_like(state.yaw)
            lin = cmd.get("lin", zeros).clamp(-1.0, 1.0)
            ang = cmd.get("ang", zeros).clamp(-1.0, 1.0)
            a = torch.where(grip, A_GRAB, A_FWD).to(torch.int32)  # for the logs
            stop = state.stop_called | cmd.get("stop", no)
            return joints, joint_vel, motor, grip, a, stop, state.yaw + ang * self.turn, lin * self.fwd
        joints, joint_vel, motor = state.joints, state.joint_vel, state.motor_target
        if self._arm_mode():
            acts = actions.float().clamp(-1.0, 1.0)
            if self.control == "arm":
                J = self.n_joints
                joints, joint_vel, motor = self._arm_step(state, dq=acts[:, :J] * self.max_joint_delta)
                rest = acts[:, J:]
            else:
                joints, joint_vel, motor = self._arm_step(state, ee_delta=acts[:, 0:3] * self.ee_delta)
                rest = acts[:, 3:]
            grip, lin, ang = rest[:, 0] > 0.0, rest[:, 1], rest[:, 2]
        elif self.continuous:
            acts = actions.float()
            lin, ang, grip = acts[:, 0].clamp(-1.0, 1.0), acts[:, 1].clamp(-1.0, 1.0), acts[:, 2] > 0.0
        if grip is not None:
            a = torch.where(grip, A_GRAB, A_FWD).to(torch.int32)  # for the logs
            return joints, joint_vel, motor, grip, a, state.stop_called, state.yaw + ang * self.turn, lin * self.fwd
        a = actions.to(torch.int32)
        stop = state.stop_called | (a == A_STOP)
        yaw = state.yaw + torch.where(a == A_LEFT, self.turn, 0.0) - torch.where(a == A_RIGHT, self.turn, 0.0)
        return joints, joint_vel, motor, None, a, stop, yaw, torch.where(a == A_FWD, self.fwd, 0.0)

    def _articulate(self, state: RearrangeState, a: torch.Tensor) -> RearrangeState:
        """Grabbing near the target's handle drives its joint toward the goal
        state: a PD force against damping and friction under gravity or
        contacts, a fixed rate (8 cm, 0.15 rad) when kinematic."""
        n_idx, ep = self._env_ids, state.ep_idx
        interact = a == A_GRAB
        near = _xz_norm(self._handle_pos(state) - self._ee_pos(state)) <= self.grasp_distance
        art_t = self.table.art_target[ep]
        goal_q = self.table.art_goal_q[ep]
        cur_q = state.art_q[n_idx, art_t]
        is_rev = self.table.art_is_revolute[ep, art_t]
        on_t = self._a_lane == art_t[:, None]
        if self.dynamics in ("gravity", "contacts"):
            dt = 0.1
            inertia = torch.where(is_rev, 0.5, 1.0)
            qd = state.art_vel[n_idx, art_t]
            tau_max = inertia * 6.0
            tau = torch.clamp(25.0 * (goal_q - cur_q) - 8.0 * qd, min=-tau_max, max=tau_max)
            tau = torch.where(interact & near, tau, 0.0)
            qd = qd + (tau - 1.0 * qd) / inertia * dt
            # Coulomb friction: decelerate toward rest, never reverse
            qd = torch.sign(qd) * torch.clamp_min(qd.abs() - 0.8 / inertia * dt, 0.0)
            init_q = self.table.art_init_q[ep]
            lo = torch.clamp_max(torch.minimum(init_q, goal_q), 0.0)
            hi = torch.clamp_min(torch.maximum(init_q, goal_q), 0.0)
            raw_q = cur_q + qd * dt
            new_q = torch.minimum(torch.maximum(raw_q, lo), hi)
            qd = torch.where((raw_q < lo) | (raw_q > hi), 0.0, qd)
            return dataclasses.replace(state, art_q=torch.where(on_t, new_q[:, None], state.art_q),
                                       art_vel=torch.where(on_t, qd[:, None], state.art_vel))
        rate = torch.where(is_rev, 0.15, 0.08)
        dq = torch.minimum(torch.maximum(goal_q - cur_q, -rate), rate)
        new_q = torch.where(interact & near, cur_q + dq, cur_q)
        return dataclasses.replace(state, art_q=torch.where(on_t, new_q[:, None], state.art_q))

    def _pddl_nav(self, state, sid, nav_arg, pos, yaw):
        """PddlApplyAction nav(e): the postcondition puts the agent on the
        navigable cell nearest entity e (1-based; objects, then goals),
        facing it (reference pddl_actions.py:57-99). Returns (pos, yaw)."""
        n_idx = self._env_ids
        ents, valid = entity_positions(self, state)
        ne = ents.shape[1]
        e_i = (nav_arg - 1).clamp(0, ne - 1)
        do_nav = (nav_arg >= 1) & (nav_arg <= ne) & valid[n_idx, e_i]
        tgt_e = ents[n_idx, e_i]
        snap_e = ng.snap_to_navigable(self.pack, sid, tgt_e)
        face = tgt_e - snap_e
        return (torch.where(do_nav[:, None], snap_e, pos),
                torch.where(do_nav, torch.atan2(-face[:, 0], -face[:, 2]), yaw))

    def _pddl_grasp(self, state, objs, args, agent_pos, agent_held):
        """PddlApplyAction pick(o) and place(g) for an agent: (pick it does,
        the object, place it does, the place argument)."""
        n_idx, O = self._env_ids, self.num_objects
        p_arg = args[:, 1]
        p_obj = (p_arg - 1).clamp(0, O - 1)
        p_ok = (p_arg >= 1) & (p_arg <= O) & self.table.obj_valid[state.ep_idx][n_idx, p_obj]
        p_do = p_ok & (_xz_norm(objs[n_idx, p_obj] - agent_pos) <= 2.0) & (agent_held < 0)
        pl_arg = args[:, 2]
        return p_do, p_obj, (pl_arg >= O + 1) & (pl_arg <= 2 * O) & (agent_held >= 0), pl_arg

    def _goal_arg(self, state, pl_arg):
        """(N, 3) the goal a place argument names."""
        O = self.num_objects
        return self.table.target_pos[state.ep_idx][self._env_ids, (pl_arg - 1 - O).clamp(0, O - 1)]

    def _pick_target(self, state, objs, pick, agent_pos, agent_held):
        """HumanoidPickAction for an agent: the valid object nearest the
        target, grasped when within 0.4 m of it, the target within 1.5 m of
        the agent and nothing held. Returns (grasp, the object)."""
        active, target = pick
        d = torch.where(self.table.obj_valid[state.ep_idx], norm(objs - target[:, None, :]), 1e6)
        obj = d.argmin(1)
        near = (d[self._env_ids, obj] <= 0.4) & (_xz_norm(target - agent_pos) <= 1.5)
        return active & near & (agent_held < 0), obj

    def _humanoid_grasp(self, state, sid, objs, cmd1, held, obj_pos):
        """The humanoid's grasp lane: its pick target and PDDL pick grasp
        (never the object the robot holds); its PDDL place drops the held
        object at the goal, otherwise at its feet. Returns (obj_pos,
        human_held)."""
        grab = torch.zeros_like(state.stop_called)
        obj = torch.zeros_like(held)
        release = torch.zeros_like(grab)
        floor = self.pack.floor_y[sid]
        drop = torch.stack([state.human_pos[:, 0], floor, state.human_pos[:, 2]], dim=-1)
        if "humanoid_pick" in cmd1:
            g, cand = self._pick_target(state, objs, cmd1["humanoid_pick"], state.human_pos, state.human_held)
            grab = grab | g
            obj = torch.where(g, cand, obj)
        if "pddl_apply" in cmd1:
            g, p_obj, place, pl_arg = self._pddl_grasp(state, objs, cmd1["pddl_apply"], state.human_pos,
                                                       state.human_held)
            grab = grab | g
            obj = torch.where(g, p_obj, obj)
            release = release | place
            drop = torch.where(place[:, None], self._goal_arg(state, pl_arg), drop)
        grab = grab & (obj != held)
        dropped = release[:, None] & (self._o_lane == torch.clamp_min(state.human_held, 0)[:, None])
        obj_pos = torch.where(dropped[..., None], drop[:, None, :], obj_pos)
        human_held = torch.where(release, -1, state.human_held)
        return obj_pos, torch.where(grab, obj, human_held)

    def step_fn(self, state: RearrangeState, actions: torch.Tensor):
        """One batched step with masked auto-reset of finished envs. Returns
        (state, obs, reward, done, info); the input state is not modified."""
        n_idx, ep = self._env_ids, state.ep_idx
        prev_m = self._measures(state)
        sid = self._sid(state)
        cmd, cmd1 = self._commands(state, actions) if self.action_specs is not None else ({}, {})
        joints, joint_vel, motor, grip, a, stop, yaw, move = self._controls(state, actions, cmd)

        # base motion with wall sliding; movable objects block the base by a
        # per-step disc test against their current positions (the reference
        # recomputes its navmesh, rearrange_sim.py:465-492)
        target = state.pos + yaw_to_forward(yaw) * move[:, None]
        new_pos, collided = ng.try_step(self.pack, sid, state.pos, target)
        not_held = self._o_lane != torch.where(state.held < 0, -1, state.held)[:, None]
        blockers = self.table.obj_valid[ep] & not_held
        half = self.table.obj_half[ep]
        obj_rad = torch.maximum(half[..., 0], half[..., 2])
        d_obj = _xz_norm(self._obj_world(state) - new_pos[:, None, :])
        obj_hit = (blockers & (d_obj < (AGENT_RADIUS + obj_rad) * 0.9)).any(1)
        new_pos = torch.where(obj_hit[:, None], state.pos, new_pos)
        moved = move.abs() > 1e-6
        collided = (collided | obj_hit) & moved
        new_pos = torch.where(moved[:, None], new_pos, state.pos)
        if "base_pos_override" in cmd:
            # HumanoidJointAction's base transform: the root is set, snapped
            # to the navgrid (the reference's step_filter)
            ov_set, ov_pos, ov_yaw = cmd["base_pos_override"]
            new_pos = torch.where(ov_set[:, None], ng.snap_to_navigable(self.pack, sid, ov_pos), new_pos)
            yaw = torch.where(ov_set, ov_yaw, yaw)
        if "pddl_apply" in cmd:
            new_pos, yaw = self._pddl_nav(state, sid, cmd["pddl_apply"][:, 0], new_pos, yaw)
        h_pos, h_yaw = state.human_pos, state.human_yaw
        if self.with_humanoid:
            # the humanoid's lane: the same base motion on its own pose
            zeros = torch.zeros_like(state.yaw)
            h_lin = cmd1.get("lin", zeros).clamp(-1.0, 1.0)
            h_yaw = state.human_yaw + cmd1.get("ang", zeros).clamp(-1.0, 1.0) * self.turn
            stop = stop | cmd1.get("stop", torch.zeros_like(stop))
            h_pos, _ = ng.try_step(self.pack, sid, state.human_pos,
                                   state.human_pos + yaw_to_forward(h_yaw) * (h_lin * self.fwd)[:, None])
            if "pddl_apply" in cmd1:
                h_pos, h_yaw = self._pddl_nav(state, sid, cmd1["pddl_apply"][:, 0], h_pos, h_yaw)
        state = dataclasses.replace(
            state, pos=new_pos, yaw=yaw, prev_pos=state.pos, joints=joints, joint_vel=joint_vel, motor_target=motor,
            human_pos=h_pos, human_yaw=h_yaw, stop_called=stop, collided=collided,
            collision_count=state.collision_count + collided.to(torch.int32), last_action=a, step=state.step + 1,
        )
        if self.task in ("open", "close"):
            state = self._articulate(state, a)

        # magic grasp and release (reference grip_actions.py:38-177)
        ee = self._ee_pos(state)
        objs = self._obj_world(state)
        d = torch.where(self.table.obj_valid[ep], norm(objs - ee[:, None, :]), 1e6)
        nearest = d.argmin(1)
        near = d[n_idx, nearest] <= self.grasp_distance
        if self.action_specs is not None and "grip" not in cmd:
            # no grip slice declared: the grasp changes only through
            # PddlApplyAction below
            can_grab = do_release = torch.zeros_like(state.stop_called)
        elif grip is not None:
            # suction semantics: hold while grip > 0, release at <= 0
            can_grab = grip & (state.held < 0) & near
            do_release = ~grip & (state.held >= 0)
        else:
            grab = a == A_GRAB
            can_grab = grab & (state.held < 0) & near
            do_release = grab & (state.held >= 0)
        if "humanoid_pick" in cmd:
            # HumanoidPickAction: grasp the object nearest the target
            hp_grab, hp_obj = self._pick_target(state, objs, cmd["humanoid_pick"], state.pos, state.held)
            can_grab = can_grab | hp_grab
            nearest = torch.where(hp_grab, hp_obj, nearest)
        if "pddl_apply" in cmd:
            # pick(o) snaps object o to the hand when nothing is held and the
            # base is within 2 m of it; place(g) releases the held object at
            # goal g (reference pddl_actions.py)
            p_do, p_obj, pddl_place, pl_arg = self._pddl_grasp(state, objs, cmd["pddl_apply"], state.pos, state.held)
            can_grab = can_grab | p_do
            nearest = torch.where(p_do, p_obj, nearest)
            do_release = do_release | pddl_place
        # a released object drops under the EE (snapped to the nearest
        # navigable cell off the grid); with physics it falls from the EE
        floor = self.pack.floor_y[sid]
        ee_floor = torch.stack([ee[:, 0], floor, ee[:, 2]], dim=-1)
        drop = torch.where(ng.is_navigable(self.pack, sid, ee_floor)[:, None], ee_floor,
                           ng.snap_to_navigable(self.pack, sid, ee))
        if self.dynamics in ("gravity", "contacts"):
            drop = torch.stack([drop[:, 0], ee[:, 1], drop[:, 2]], dim=-1)
        if "pddl_apply" in cmd:  # place(g): the object lands at the goal
            drop = torch.where(pddl_place[:, None], self._goal_arg(state, pl_arg), drop)
        released = do_release[:, None] & (self._o_lane == torch.clamp_min(state.held, 0)[:, None])
        obj_pos = torch.where(released[..., None], drop[:, None, :], state.obj_pos)
        held = torch.where(do_release, -1, state.held)
        held = torch.where(can_grab, nearest, held)
        ever_held = state.ever_held | (held == self._target_obj(state))
        human_held = state.human_held
        free = self.table.obj_valid[ep] & (self._o_lane != torch.where(held < 0, -1, held)[:, None])
        if self.with_humanoid:
            obj_pos, human_held = self._humanoid_grasp(state, sid, objs, cmd1, held, obj_pos)
            free = free & (self._o_lane != torch.where(human_held < 0, -1, human_held)[:, None])

        obj_vel, obj_quat, obj_omega = state.obj_vel, state.obj_quat, state.obj_omega
        step_force = torch.zeros_like(state.accum_force)
        if self.dynamics == "gravity":
            # semi-implicit Euler for free objects; the floor stops them
            dt, g = 0.1, 9.8
            rest_y = floor[:, None]
            v = add_y(obj_vel, -g * dt)
            p = obj_pos + v * dt
            on_ground = p[..., 1] <= rest_y
            p = torch.stack([p[..., 0], torch.where(on_ground, rest_y, p[..., 1]), p[..., 2]], dim=-1)
            v = torch.where(on_ground[..., None], 0.0, v)
            obj_pos = torch.where(free[..., None], p, obj_pos)
            obj_vel = torch.where(free[..., None], v, 0.0)
        elif self.dynamics == "contacts":
            obj_pos, obj_vel, step_force, obj_quat, obj_omega = contact_step(
                obj_pos, obj_vel, free, floor, state.pos, half=half, yaw_o=self.table.obj_yaw[ep],
                quat=obj_quat, omega=obj_omega,
            )

        # grasp constraint: the held box (hanging bottom-anchored at the EE)
        # penetrating the floor or another box violates the reference's rigid
        # constraint: force, and per the task flags a drop or the episode's end
        pen_floor = torch.clamp_min(floor - ee[:, 1], 0.0)
        h_held = half[n_idx, torch.clamp_min(held, 0)]  # (N, 3)
        c_held = add_y(ee, h_held[:, 1])
        centers = add_y(obj_pos, half[..., 1])
        o_other = self.table.obj_valid[ep] & (self._o_lane != torch.where(held < 0, -1, held)[:, None])
        pen3 = (h_held[:, None] + half) - (c_held[:, None, :] - centers).abs()
        pen_obj = torch.where(o_other & (pen3 > 0).all(-1), pen3.amin(-1), 0.0).amax(1)
        violation = torch.where(held >= 0, pen_floor + pen_obj, 0.0)
        step_force = step_force + FORCE_K * violation
        if self.cv_drops_object:
            broke = violation > 0.0
            obj_pos = torch.where((broke[:, None] & (self._o_lane == held[:, None]))[..., None], ee[:, None, :],
                                  obj_pos)
            held = torch.where(broke, -1, held)
        state = dataclasses.replace(
            state, obj_pos=obj_pos, obj_vel=obj_vel, obj_quat=obj_quat, obj_omega=obj_omega, held=held,
            ever_held=ever_held, human_held=human_held, accum_force=state.accum_force + step_force,
        )

        m = self._measures(state)
        m["constraint_violation"] = (violation > 0.0).float()
        episode_over = stop | (state.step >= self.max_episode_steps)
        if self.max_accum_force > 0:
            episode_over = episode_over | (m["force_terminate"] > 0)  # ForceTerminate
        if self.cv_ends_episode:
            episode_over = episode_over | (violation > 0.0)
        done = episode_over | (m["success"] > 0)  # sub-tasks end on success
        reward = self._reward(prev_m, m)
        info = dict(m)
        info["did_violate_hold_constraint"] = info["constraint_violation"]
        # called stop without having succeeded (reference BadCalledTerminate)
        info["bad_called_terminate"] = (state.stop_called & ~(m["success"] > 0)).float()
        if self.task in REWARD_KEYS:
            info[REWARD_KEYS[self.task]] = reward
        if self.task == "rearrange":
            info["pddl_subgoal_reward"] = reward
        if self.measure_keys is not None:
            info = {k: info[k] for k in self.measure_keys if k in info}

        # masked auto-reset
        ep_ptr = torch.where(done, state.ep_ptr + 1, state.ep_ptr)
        ep_next = self.order[n_idx, ep_ptr % self._order_len]
        fresh = self._fresh(ep_next)

        def sel(new, old):
            return torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)

        state = RearrangeState(**{
            k: sel(getattr(fresh, k), v) for k, v in _tensor_fields(state).items()
            if k not in ("ep_ptr", "ep_idx", "episode_over", "episode_count")
        }, ep_ptr=ep_ptr, ep_idx=torch.where(done, ep_next, state.ep_idx), episode_over=episode_over,
            episode_count=state.episode_count + done.to(torch.int32))
        return state, self._observations(state), reward, done, info
