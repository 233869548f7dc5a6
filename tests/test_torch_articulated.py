"""habitat_torch's articulated agents against habitat_tpu's on the CPU.

Same seeded numpy inputs through ``habitat_tpu.articulated_agents`` (one
``jax.jit`` of the ``vmap``-ed reference per function, as the env batches
it) and ``habitat_torch.articulated_agents``, batched over N=4 envs: FK of
the four robots, the EE in the world, IK on a params arm and on a URDF
chain, the arm dynamics, 30 teacher-forced ``step_arm`` calls (the JAX state
at call k into both) with a joint pinned at its limit, the legged base and
the URDF tables, which are numpy in both and must be equal.

Tolerances: atol 1e-5 on positions and joints; rtol 1e-4 on mass matrices,
bias forces, torques and accelerations (float32 sums in another order; the
port writes the Jacobians analytically where the JAX package takes them by
autodiff).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.articulated_agents import dynamics as jdyn
from habitat_tpu.articulated_agents import kinematics as jkin
from habitat_tpu.articulated_agents import legs as jlegs
from habitat_tpu.articulated_agents import manipulator as jman
from habitat_tpu.articulated_agents import params as jparams
from habitat_tpu.articulated_agents import urdf as jurdf

from habitat_torch.articulated_agents import dynamics as tdyn
from habitat_torch.articulated_agents import kinematics as tkin
from habitat_torch.articulated_agents import legs as tlegs
from habitat_torch.articulated_agents import manipulator as tman
from habitat_torch.articulated_agents import params as tparams
from habitat_torch.articulated_agents import urdf as turdf
from tests.test_urdf import FRANKA_URDF

ATOL = 1e-5
RTOL = 1e-4
N = 4
ROBOTS = ["FetchRobot", "SpotRobot", "StretchRobot", "FrankaRobot"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _joints(params, rng, n=N):
    lo, hi = np.array(params.joint_limits_lower), np.array(params.joint_limits_upper)
    return rng.uniform(lo, hi, (n, params.arm_joints)).astype(np.float32)


def _dyn_pair(name, kp=300.0, kd=30.0):
    """The env's arm dynamics (rearrange_env.py:765) in both packages."""
    return (jdyn.default_arm_dynamics(jparams.ROBOTS[name], kp=kp, kd=kd),
            tdyn.default_arm_dynamics(tparams.ROBOTS[name], kp=kp, kd=kd, device="cpu"))


def _fields(params):
    return dataclasses.asdict(params)


def test_params_tables_equal():
    assert list(tparams.ROBOTS) == list(jparams.ROBOTS)
    for name in ROBOTS:
        assert _fields(tparams.ROBOTS[name]) == _fields(jparams.ROBOTS[name])


@pytest.mark.parametrize("name", ROBOTS)
def test_fk_matches_jax(name):
    P = jparams.ROBOTS[name]
    q = _joints(P, np.random.default_rng(0))
    ref = np.asarray(jax.jit(jax.vmap(lambda x: jkin.fk_positions(P, x)))(q))
    got = tkin.fk_positions(tparams.ROBOTS[name], _t(q))
    assert got.shape == (N, P.arm_joints + 1, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(tkin.ee_position(tparams.ROBOTS[name], _t(q)).numpy(), ref[:, -1], atol=ATOL)


def test_ee_position_world_matches_jax():
    rng = np.random.default_rng(1)
    P = jparams.FETCH
    q = _joints(P, rng)
    base = rng.normal(size=(N, 3)).astype(np.float32)
    yaw = rng.uniform(-3, 3, N).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b, c: jkin.ee_position_world(P, a, b, c)))(q, base, yaw))
    got = tkin.ee_position_world(tparams.FETCH, _t(q), _t(base), _t(yaw))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_ik_params_arm_matches_jax():
    """The env's IK (iters=8, rearrange_env.py:1756) on reachable targets
    near the resting pose."""
    rng = np.random.default_rng(2)
    P = jparams.FETCH
    lo, hi = np.array(P.joint_limits_lower), np.array(P.joint_limits_upper)
    q_goal = np.clip(np.array(P.resting_pose) + rng.normal(0, 0.3, (N, 7)), lo, hi).astype(np.float32)
    target = np.asarray(jax.vmap(lambda x: jkin.ee_position(P, x))(q_goal))
    q0 = np.tile(np.array(P.resting_pose, np.float32), (N, 1))
    ref = np.asarray(jax.jit(jax.vmap(lambda t, x: jkin.ik_solve(P, t, x, iters=8)))(target, q0))
    got = tkin.ik_solve(tparams.FETCH, _t(target), _t(q0), iters=8)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    err_ref = np.asarray(jax.vmap(lambda t, x: jkin.ik_error(P, t, x))(target, ref))
    np.testing.assert_allclose(tkin.ik_error(tparams.FETCH, _t(target), got).numpy(), err_ref, atol=ATOL)
    assert err_ref.max() < 0.05


def test_urdf_chain_fk_and_ik_match_jax():
    """The Franka URDF chain of tests/test_urdf.py: FK over its 8 joints
    (the finger is prismatic) and IK to a reachable flange target."""
    rng = np.random.default_rng(3)
    jchain = jurdf.parse_urdf(FRANKA_URDF).extract_chain(ee_link="finger")
    tchain = turdf.parse_urdf(FRANKA_URDF).extract_chain(ee_link="finger")
    q = rng.uniform(jchain.lower, jchain.upper, (N, jchain.num_joints)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda x: jkin.fk_chain(jchain, x)))(q))
    np.testing.assert_allclose(tkin.fk_chain(tchain, _t(q)).numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(tkin.ee_chain(tchain, _t(q)).numpy(), ref[:, -1], atol=ATOL)

    jchain = jurdf.parse_urdf(FRANKA_URDF).extract_chain(ee_link="flange")
    tchain = turdf.parse_urdf(FRANKA_URDF).extract_chain(ee_link="flange")
    q_goal = np.clip(0.4 * rng.normal(size=(N, 7)), jchain.lower, jchain.upper).astype(np.float32)
    q_goal[:, 3] = -1.5
    target = np.asarray(jax.vmap(lambda x: jkin.ee_chain(jchain, x))(q_goal))
    q0 = np.clip(np.zeros((N, 7), np.float32), jchain.lower, jchain.upper)
    ref = np.asarray(jax.jit(jax.vmap(lambda t, x: jkin.ik_solve_chain(jchain, t, x)))(target, q0))
    got = tkin.ik_solve_chain(tchain, _t(target), _t(q0))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("quantity", ["mass_matrix", "bias_forces", "forward_dynamics", "inverse_dynamics"])
def test_dynamics_matches_jax(quantity):
    rng = np.random.default_rng(4)
    jd, td = _dyn_pair("FetchRobot", kp=60.0, kd=8.0)
    P, TP = jparams.FETCH, tparams.FETCH
    q = _joints(P, rng)
    qd = rng.normal(0, 1, (N, 7)).astype(np.float32)
    x = rng.normal(0, 5, (N, 7)).astype(np.float32)  # torques or accelerations
    jfn = {
        "mass_matrix": lambda a, b, c: jdyn.mass_matrix(P, jd, a),
        "bias_forces": lambda a, b, c: jdyn.bias_forces(P, jd, a, b),
        "forward_dynamics": lambda a, b, c: jdyn.forward_dynamics(P, jd, a, b, c),
        "inverse_dynamics": lambda a, b, c: jdyn.inverse_dynamics(P, jd, a, b, c),
    }[quantity]
    tfn = {
        "mass_matrix": lambda a, b, c: tdyn.mass_matrix(TP, td, a),
        "bias_forces": lambda a, b, c: tdyn.bias_forces(TP, td, a, b),
        "forward_dynamics": lambda a, b, c: tdyn.forward_dynamics(TP, td, a, b, c),
        "inverse_dynamics": lambda a, b, c: tdyn.inverse_dynamics(TP, td, a, b, c),
    }[quantity]
    ref = np.asarray(jax.jit(jax.vmap(jfn))(q, qd, x))
    got = tfn(_t(q), _t(qd), _t(x)).numpy()
    # relative to each env's largest entry: a zero-crossing entry has no
    # relative precision of its own
    scale = np.abs(ref).reshape(N, -1).max(-1).reshape((N,) + (1,) * (ref.ndim - 1))
    assert (np.abs(got - ref) <= RTOL * scale).all(), np.abs(got - ref).max()


def test_bias_forces_without_gravity_match_jax():
    """Coriolis and centrifugal terms alone (what the analytic bias
    acceleration must get right)."""
    rng = np.random.default_rng(5)
    jd, td = _dyn_pair("SpotRobot")
    P = jparams.SPOT
    q, qd = _joints(P, rng), rng.normal(0, 2, (N, 6)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda a, b: jdyn.bias_forces(P, jd, a, b, gravity=jnp.zeros(3)))(q, qd))
    got = tdyn.bias_forces(tparams.SPOT, td, _t(q), _t(qd), gravity=(0.0, 0.0, 0.0)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_energies_match_jax():
    rng = np.random.default_rng(6)
    jd, td = _dyn_pair("FetchRobot")
    P = jparams.FETCH
    q, qd = _joints(P, rng), rng.normal(0, 1, (N, 7)).astype(np.float32)
    ke = np.asarray(jax.vmap(lambda a, b: jdyn.kinetic_energy(P, jd, a, b))(q, qd))
    pe = np.asarray(jax.vmap(lambda a: jdyn.potential_energy(P, jd, a))(q))
    np.testing.assert_allclose(tdyn.kinetic_energy(tparams.FETCH, td, _t(q), _t(qd)).numpy(), ke, rtol=RTOL)
    np.testing.assert_allclose(tdyn.potential_energy(tparams.FETCH, td, _t(q)).numpy(), pe, rtol=RTOL)


def test_step_arm_teacher_forced_with_a_joint_at_its_limit():
    """30 env-rate calls (dt=1/30, 4 substeps, rearrange_env.py:1742) of PD
    tracking; joint 1 starts at its lower limit with its motor target 0.3
    rad beyond it, so the active-set lock holds it there."""
    rng = np.random.default_rng(7)
    jd, td = _dyn_pair("FetchRobot")
    P = jparams.FETCH
    lo, hi = np.array(P.joint_limits_lower, np.float32), np.array(P.joint_limits_upper, np.float32)
    q = np.clip(np.array(P.resting_pose) + rng.normal(0, 0.3, (N, 7)), lo, hi).astype(np.float32)
    q[:, 1] = lo[1]
    qd = np.zeros((N, 7), np.float32)
    target = np.clip(q + rng.normal(0, 0.4, (N, 7)), lo, hi).astype(np.float32)
    target[:, 1] = lo[1] - 0.3
    jstep = jax.jit(jax.vmap(lambda a, b, c: jdyn.step_arm(P, jd, a, b, c, dt=1.0 / 30.0, substeps=4)))
    worst_q = worst_qd = 0.0
    for _ in range(30):
        rq, rqd = (np.asarray(x) for x in jstep(q, qd, target))
        gq, gqd = tdyn.step_arm(tparams.FETCH, td, _t(q), _t(qd), _t(target), dt=1.0 / 30.0, substeps=4)
        worst_q = max(worst_q, float(np.abs(gq.numpy() - rq).max()))
        worst_qd = max(worst_qd, float(np.abs(gqd.numpy() - rqd).max()))
        q, qd = rq, rqd
    assert worst_q <= ATOL and worst_qd <= ATOL, (worst_q, worst_qd)
    assert (q[:, 1] == lo[1]).all()  # pinned at its limit all along


def test_step_arm_leaves_inputs_unchanged():
    _, td = _dyn_pair("FetchRobot")
    rng = np.random.default_rng(8)
    xs = [_t(_joints(jparams.FETCH, rng)), _t(rng.normal(size=(N, 7))), _t(_joints(jparams.FETCH, rng))]
    before = [x.clone() for x in xs]
    tdyn.step_arm(tparams.FETCH, td, *xs, dt=1.0 / 30.0)
    for x, b in zip(xs, before):
        assert torch.equal(x, b)


def test_leg_fk_and_boxes_match_jax():
    rng = np.random.default_rng(9)
    leg_q = (np.tile(jlegs.LEG_INIT, (N, 1)) + rng.normal(0, 0.4, (N, 12))).astype(np.float32)
    base = rng.normal(size=(N, 3)).astype(np.float32)
    yaw = rng.uniform(-3, 3, N).astype(np.float32)
    for r, g in zip(jax.jit(jlegs.leg_fk)(leg_q), tlegs.leg_fk(_t(leg_q))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    (rt, rv), (gt, gv) = jax.jit(jlegs.leg_segment_boxes)(base, yaw, leg_q), tlegs.leg_segment_boxes(
        _t(base), _t(yaw), _t(leg_q))
    np.testing.assert_allclose(gt.numpy(), np.asarray(rt), atol=ATOL)
    assert np.array_equal(gv.numpy(), np.asarray(rv))
    assert np.array_equal(tlegs.HIP_OFFSETS, jlegs.HIP_OFFSETS) and np.array_equal(tlegs.LEG_INIT, jlegs.LEG_INIT)


@pytest.mark.parametrize("ee_link", ["flange", "finger"])
def test_urdf_tables_equal(ee_link, tmp_path):
    """parse_urdf and load_chain give the JAX package's tables exactly."""
    path = tmp_path / "mini_panda.urdf"
    path.write_text(FRANKA_URDF)
    jm, tm = jurdf.parse_urdf(FRANKA_URDF), turdf.parse_urdf(FRANKA_URDF)
    assert tm.root_link == jm.root_link and tm.movable_joint_names() == jm.movable_joint_names()
    for a, b in zip(jm.joints, tm.joints):
        for f in ("name", "joint_type", "parent", "child", "lower", "upper", "velocity", "effort"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("origin_xyz", "origin_rot", "axis"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    jc, tc = jurdf.load_chain(str(path), ee_link=ee_link), turdf.load_chain(str(path), ee_link=ee_link)
    assert tc.joint_names == jc.joint_names
    for f in ("origin_xyz", "origin_rot", "axis", "is_prismatic", "lower", "upper", "ee_offset", "ee_rot"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("cls", ["FetchRobot", "SpotRobot", "StretchRobot", "FrankaRobot", "make_robot"])
def test_manipulators_match_jax(cls):
    """The numpy-in, numpy-out host API: joints, limits, EE, IK, gripper."""
    if cls == "make_robot":
        jr, tr = jman.make_robot("SpotRobot"), tman.make_robot("SpotRobot", device="cpu")
    else:
        jr, tr = getattr(jman, cls)(), getattr(tman, cls)(device="cpu")
    assert type(tr).__mro__[1].__name__ == type(jr).__mro__[1].__name__
    q = np.array(jr.params.resting_pose, np.float32) + 0.2
    jr.arm_joint_pos = q
    tr.arm_joint_pos = q
    assert np.array_equal(tr.arm_joint_pos, jr.arm_joint_pos)
    np.testing.assert_allclose(tr.ee_local_pos, jr.ee_local_pos, atol=ATOL)
    if hasattr(jr, "base_pos"):
        jr.base_pos = tr.base_pos = np.array([1.0, 0.0, -2.0], np.float32)
        jr.base_rot = tr.base_rot = 0.7
        np.testing.assert_allclose(tr.ee_pos, jr.ee_pos, atol=ATOL)
    target = jr.ee_local_pos + np.array([0.02, -0.03, 0.01], np.float32)
    np.testing.assert_allclose(tr.calculate_ee_inverse_kinematics(target),
                               jr.calculate_ee_inverse_kinematics(target), atol=ATOL)
    tr.close_gripper()
    assert not tr.is_gripper_open
    tr.reset()
    assert tr.is_gripper_open and np.array_equal(tr.arm_joint_pos, np.array(jr.params.resting_pose, np.float32))


def test_urdf_manipulator_matches_jax(tmp_path):
    path = tmp_path / "mini_panda.urdf"
    path.write_text(FRANKA_URDF)
    jr = jman.UrdfManipulator(str(path), ee_link="flange")
    tr = tman.UrdfManipulator(str(path), ee_link="flange", device="cpu")
    assert _fields(tr.params) == _fields(jr.params)
    q = np.clip(np.full(7, 0.3, np.float32), jr.chain.lower, jr.chain.upper)
    q[3] = -1.2
    jr.arm_joint_pos = tr.arm_joint_pos = q
    np.testing.assert_allclose(tr.ee_local_pos, jr.ee_local_pos, atol=ATOL)
    target = jr.ee_local_pos + np.array([0.03, 0.0, -0.02], np.float32)
    np.testing.assert_allclose(tr.calculate_ee_inverse_kinematics(target),
                               jr.calculate_ee_inverse_kinematics(target), atol=ATOL)


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (lambda: tdyn.default_arm_dynamics(tparams.FETCH), lambda: tman.FetchRobot(),
                 lambda: tman.make_robot("SpotRobot")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
