"""Batched articulated dynamics for serial chains (port of
``habitat_tpu/articulated_agents/dynamics.py``).

Counterpart of the reference's Bullet articulated dynamics: URDF joint
motors with position gains driving the arm under gravity
(articulated_agents/manipulator.py:79-120; habitat-sim steps the multibody
in step_world, rearrange_sim.py:1017-1028), in the Lagrangian point-mass
formulation. Each link's mass is lumped at its distal frame origin (the
next joint, or the EE), for which the generalized dynamics are exact:

  M(q)      = sum_k m_k J_k(q)^T J_k(q) + armature I
  c(q, qd)  = sum_k J_k^T m_k (a_bias_k - g),  a_bias_k = d/dt(J_k) qd
  tau       = M qdd + c                      (inverse dynamics)
  qdd       = M^-1 (tau - c)                 (forward dynamics)

J_k and the bias acceleration are written analytically from the same FK as
``kinematics.fk_frames`` (the JAX package takes them by ``jax.jacfwd`` and a
nested ``jax.jvp``): point k moves by a_j x (p_k - o_j) per unit of joint
j <= k, and its bias acceleration is
  sum_{j<=k} qd_j [(w_j x a_j) x (p_k - o_j) + a_j x (v_k - v(o_j))]
with w_j the angular velocity of the frame that carries axis a_j.

Everything is batched over leading axes: q, qd, q_target (..., J). Solves
use ``torch.linalg.solve_ex`` and every constant is made on the device, so
``step_arm`` never waits on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from habitat_torch.articulated_agents.kinematics import fk_frames
from habitat_torch.articulated_agents.params import MobileManipulatorParams
from habitat_torch.device import resolve_device

GRAVITY = (0.0, -9.81, 0.0)


class ArmDynParams(NamedTuple):
    """Dynamics-side parameters for a serial arm (tensors on one device)."""

    masses: torch.Tensor  # (J,) lumped link masses (kg)
    kp: torch.Tensor  # (J,) motor position gains
    kd: torch.Tensor  # (J,) motor velocity gains
    lower: torch.Tensor  # (J,) joint limits
    upper: torch.Tensor  # (J,)
    armature: float = 1e-2  # rotor inertia added to M's diagonal


def default_arm_dynamics(
    params: MobileManipulatorParams,
    mass_per_link: float = 1.0,
    kp: float = 60.0,
    kd: float = 8.0,
    device=None,
) -> ArmDynParams:
    """Uniform lumped masses and motor gains for a params-table arm (the
    reference's JointMotorSettings defaults are likewise uniform), on
    ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    J = params.arm_joints

    def full(x):
        return torch.full((J,), float(x), dtype=torch.float32, device=dev)

    return ArmDynParams(
        masses=full(mass_per_link),
        kp=full(kp),
        kd=full(kd),
        lower=torch.tensor(params.joint_limits_lower, dtype=torch.float32, device=dev),
        upper=torch.tensor(params.joint_limits_upper, dtype=torch.float32, device=dev),
    )


def _point_jacobian(params: MobileManipulatorParams, q: torch.Tensor):
    """Mass points P (..., J, 3), their Jacobian (..., J, 3, J), the pivots O
    (..., J, 3) and the world joint axes A (..., J, 3)."""
    pts, A = fk_frames(params, q)
    P, O = pts[..., 1:, :], pts[..., :-1, :]
    J = q.shape[-1]
    lower = torch.ones(J, J, dtype=torch.bool, device=q.device).tril()  # joint j <= point k
    cols = torch.linalg.cross(A.unsqueeze(-3), P.unsqueeze(-2) - O.unsqueeze(-3), dim=-1)  # (..., k, j, 3)
    Jac = torch.where(lower[..., None], cols, 0.0).transpose(-1, -2)
    return P, Jac, O, A


def _mass_matrix(Jac: torch.Tensor, dyn: ArmDynParams) -> torch.Tensor:
    J = Jac.shape[-1]
    flat = Jac.reshape(Jac.shape[:-3] + (3 * J, J))
    m3 = dyn.masses[:, None].expand(J, 3).reshape(3 * J)  # per row (k, axis)
    M = (flat.transpose(-1, -2) * m3) @ flat
    return M + dyn.armature * torch.eye(J, dtype=M.dtype, device=M.device)


def _bias(P, Jac, O, A, dyn: ArmDynParams, qd: torch.Tensor, gravity) -> torch.Tensor:
    J = qd.shape[-1]
    vP = (Jac @ qd[..., None, :, None]).squeeze(-1)  # (..., J, 3) point velocities
    vO = torch.cat([torch.zeros_like(vP[..., :1, :]), vP[..., :-1, :]], dim=-2)  # pivot velocities
    spin = qd[..., :, None] * A  # each joint's angular velocity contribution
    w_before = torch.cumsum(spin, dim=-2) - spin  # frame carrying axis j: joints i < j
    a_dot = torch.linalg.cross(w_before, A, dim=-1)
    lever = P.unsqueeze(-2) - O.unsqueeze(-3)  # (..., k, j, 3)
    rel_v = vP.unsqueeze(-2) - vO.unsqueeze(-3)
    terms = torch.linalg.cross(a_dot.unsqueeze(-3), lever, dim=-1) + torch.linalg.cross(
        A.unsqueeze(-3), rel_v, dim=-1
    )
    lower = torch.ones(J, J, dtype=torch.bool, device=qd.device).tril()
    a_bias = torch.where(lower[..., None], qd[..., None, :, None] * terms, 0.0).sum(-2)  # (..., k, 3)
    acc = torch.stack([a_bias[..., i] - gravity[i] for i in range(3)], dim=-1)
    f = dyn.masses[:, None] * acc
    return (Jac.transpose(-1, -2) @ f.unsqueeze(-1)).squeeze(-1).sum(-2)


def mass_matrix(params: MobileManipulatorParams, dyn: ArmDynParams, q: torch.Tensor) -> torch.Tensor:
    """M(q) = sum_k m_k J_k^T J_k + armature I, (..., J, J), symmetric PD."""
    return _mass_matrix(_point_jacobian(params, q)[1], dyn)


def bias_forces(
    params: MobileManipulatorParams,
    dyn: ArmDynParams,
    q: torch.Tensor,
    qd: torch.Tensor,
    gravity: Sequence[float] = GRAVITY,
) -> torch.Tensor:
    """c(q, qd): Coriolis, centrifugal and gravity generalized forces (..., J)."""
    return _bias(*_point_jacobian(params, q), dyn, qd, gravity)


def _mass_and_bias(params, dyn, q, qd, gravity) -> Tuple[torch.Tensor, torch.Tensor]:
    terms = _point_jacobian(params, q)
    return _mass_matrix(terms[1], dyn), _bias(*terms, dyn, qd, gravity)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b.unsqueeze(-1))[0].squeeze(-1)


def inverse_dynamics(
    params: MobileManipulatorParams,
    dyn: ArmDynParams,
    q: torch.Tensor,
    qd: torch.Tensor,
    qdd: torch.Tensor,
    gravity: Sequence[float] = GRAVITY,
) -> torch.Tensor:
    """tau = M(q) qdd + c(q, qd) (RNEA equivalent for the lumped model)."""
    M, c = _mass_and_bias(params, dyn, q, qd, gravity)
    return (M @ qdd.unsqueeze(-1)).squeeze(-1) + c


def forward_dynamics(
    params: MobileManipulatorParams,
    dyn: ArmDynParams,
    q: torch.Tensor,
    qd: torch.Tensor,
    tau: torch.Tensor,
    gravity: Sequence[float] = GRAVITY,
) -> torch.Tensor:
    """qdd = M^-1 (tau - c): joint accelerations under applied torques."""
    M, c = _mass_and_bias(params, dyn, q, qd, gravity)
    return _solve(M, tau - c)


def motor_torques(dyn: ArmDynParams, q: torch.Tensor, qd: torch.Tensor, q_target: torch.Tensor) -> torch.Tensor:
    """PD joint motors (reference JointMotorSettings position and velocity
    gains, manipulator.py:79-120)."""
    return dyn.kp * (q_target - q) - dyn.kd * qd


def step_arm(
    params: MobileManipulatorParams,
    dyn: ArmDynParams,
    q: torch.Tensor,
    qd: torch.Tensor,
    q_target: torch.Tensor,
    dt: float = 1.0 / 120.0,
    substeps: int = 4,
    gravity: Sequence[float] = GRAVITY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semi-implicit Euler under PD motors and gravity; joint limits clamp
    with velocity zeroing (Bullet's limit behaviour). Batched over envs.

    Motor damping is integrated implicitly, qdd solving
    (M + h diag(kd)) qdd = kp (q* - q) - kd qd - c, because distal joints
    can have near-zero effective inertia at straightened poses (only the
    armature), where explicit h kd / M > 2 diverges. A joint pinned at a
    limit with its torque pushing outward is locked for the substep
    (identity row and column, zero right-hand side), so its phantom
    acceleration cannot couple reaction forces into the free joints."""
    h = dt / substeps
    eps = 1e-6
    damp = h * torch.diag_embed(dyn.kd)
    for _ in range(substeps):
        tau = motor_torques(dyn, q, qd, q_target)
        M, c = _mass_and_bias(params, dyn, q, qd, gravity)
        r = tau - c
        free = ~((q <= dyn.lower + eps) & (r < 0)) & ~((q >= dyn.upper - eps) & (r > 0))
        ff = free.unsqueeze(-1) & free.unsqueeze(-2)
        A = torch.where(ff, M + damp, 0.0) + torch.diag_embed(torch.where(free, 0.0, 1.0))
        qdd = _solve(A, torch.where(free, r, 0.0))
        qd = qd + h * qdd
        qn = q + h * qd
        q = torch.clamp(qn, min=dyn.lower, max=dyn.upper)
        qd = torch.where(qn == q, qd, 0.0)
    return q, qd


def kinetic_energy(params: MobileManipulatorParams, dyn: ArmDynParams, q: torch.Tensor, qd: torch.Tensor):
    M = mass_matrix(params, dyn, q)
    return 0.5 * (qd.unsqueeze(-2) @ M @ qd.unsqueeze(-1))[..., 0, 0]


def potential_energy(
    params: MobileManipulatorParams, dyn: ArmDynParams, q: torch.Tensor, gravity: Sequence[float] = GRAVITY
):
    P = fk_frames(params, q)[0][..., 1:, :]
    height = P[..., 0] * gravity[0] + P[..., 1] * gravity[1] + P[..., 2] * gravity[2]
    return -(dyn.masses * height).sum(-1)
