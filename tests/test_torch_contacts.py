"""habitat_torch's contact step against habitat_tpu's on the CPU.

Same seeded numpy inputs, N=4 envs of O=4 boxes, through
``habitat_tpu.tasks.rearrange.rearrange_env.contact_step`` (one ``jax.jit``
per branch) and ``habitat_torch.tasks.rearrange.rearrange_env.contact_step``,
in both branches: contacts v3 (upright boxes, ``quat=None``) and v6 (full
rotational state, the env's branch), at the env's dt=0.1 and 4 substeps.

Scenarios: an overlapping spawn, a stack, an axis-aligned separating-axis
tie (exact in every pair: both packages must take the first axis), a box
tipped 45 degrees beside an upright one (tests/test_contacts_v6.py), a robot
ramming a tall box (tests/test_contacts_v5.py), a held box, which is not
simulated, and a robot that appears with its axis inside an upright box,
then inside two tipped ones (the v6 pushout's centre-to-centre branch). Env 0
holds the scenario exactly, envs 1-3 jittered copies.

The step makes threshold decisions (touching corners, the sleep rule, the
separating-axis argmin, the ternary search), so free runs can part after
a last-bit difference: every multi-step comparison is teacher-forced (the
JAX state at step k into both, step k+1 compared), 30 steps.

Tolerances: atol 1e-5 on positions, velocities and quaternions; angular
velocities atol 1e-5 plus rtol 1e-5 (small boxes tumble at 10-25 rad/s,
and 16 sequential corner impulses per substep, each through an inverse
inertia of up to ~600, carry float32 rounding of a few 1e-6 relative); the
robot force (100 N per metre of penetration) within rtol 1e-4 and atol
1e-3, the force of a 1e-5 m penetration gap.

On the random batch with the robot among tipped, spinning boxes, the v6
robot contact is ill-conditioned in both packages for some boxes: the
ternary search's contact point, the lever arm and the impulse's torque are
set by rounding, and the next substeps carry that into the box's
orientation and position (the largest gaps sit on a box the axis crosses
and on one it passes 1.2 cm from; the robot_inside scenario, whose axis
crosses boxes at rest, holds to 1e-6). Measured on that batch, the largest
gaps between the JAX package in float32, the port in float32 and the port in
float64 are 2.9e-5 m (p), 2.7e-4 m/s (v), 5.3e-5 (q) and 1.5e-3 rad/s (w).
There v3, the force, and every box the robot does not reach are held to
the JAX package at the tolerances above; the boxes it reaches are held to
fixed bounds about twice those gaps, which a fault in the port exceeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.tasks.rearrange import generator as jgen
from habitat_tpu.tasks.rearrange import rearrange_env as jre

from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.tasks.rearrange import rearrange_env as tre
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL = 1e-5
W_RTOL = 1e-5
FORCE_RTOL, FORCE_ATOL = 1e-4, 1e-3
N, O = 4, 4
STEPS = 30


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jstep():
    """One jit per branch of the JAX contact step."""
    return dict(
        v3=jax.jit(lambda p, v, free, fy, agent, half, yaw: jre.contact_step(
            p, v, free, fy, agent, half=half, yaw_o=yaw)),
        v6=jax.jit(lambda p, v, free, fy, agent, half, yaw, q, w: jre.contact_step(
            p, v, free, fy, agent, half=half, yaw_o=yaw, quat=q, omega=w)),
    )


def _quat_axis(axis, angle):
    h = 0.5 * angle
    q = np.zeros(4)
    q[0] = np.cos(h)
    q[1 + axis] = np.sin(h)
    return q


def _yaw_quat(yaw):
    return _quat_axis(1, yaw)


def _scenario(name):
    """One env of the scenario: bottoms (O, 3), halves (O, 3), yaws (O,),
    quats (O, 4), free (O,), velocities (O, 3), agent path (steps -> (3,))."""
    far = lambda s: np.array([50.0, 0.0, 50.0])  # noqa: E731
    pad = np.array([[3.0, 0.0, 3.0], [-3.0, 0.0, 3.0], [3.0, 0.0, -3.0]])  # resting boxes far off
    vel = np.zeros((O, 3))
    free = np.ones(O, bool)
    if name == "overlapping_spawn":
        pos = np.array([[0.0, 0.0, 0.0], [0.12, 0.05, 0.04], [-0.05, 0.3, 0.1], [0.2, 0.6, -0.1]])
        half = np.array([[0.12, 0.1, 0.08], [0.1, 0.12, 0.1], [0.08, 0.06, 0.15], [0.1, 0.1, 0.1]])
        yaw = np.array([0.0, 0.4, -0.8, 1.2])
        quat = np.stack([_yaw_quat(y) for y in yaw])
        quat[3] = _quat_axis(0, 0.6)  # the floating box starts tipped
        return pos, half, yaw, quat, free, vel, far
    if name == "stack":
        half = np.array([[0.15, 0.1, 0.15], [0.1, 0.08, 0.1], [0.06, 0.05, 0.06], [0.1, 0.1, 0.1]])
        pos = np.array([[0.0, 0.0, 0.0], [0.02, 0.2, -0.01], [0.0, 0.36, 0.01], pad[0]])
        yaw = np.array([0.0, 0.3, -0.2, 0.0])
        return pos, half, yaw, np.stack([_yaw_quat(y) for y in yaw]), free, vel, far
    if name == "sat_tie":
        # axis-aligned cubes overlapping 0.05 m in x and in z: the x and z
        # axes of both boxes tie, and the first axis must win
        half = np.full((O, 3), 0.1)
        pos = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.15], pad[1], pad[2]])
        return pos, half, np.zeros(O), np.tile([1.0, 0, 0, 0], (O, 1)), free, vel, far
    if name == "tipped_beside_upright":
        h, s2 = 0.15, np.sqrt(2.0)
        half = np.array([[h, h, h], [h, h, h], [0.05, 0.05, 0.05], [0.1, 0.1, 0.1]])
        pos = np.array([[0.0, h * s2 - h, 0.0], [h * s2 + h - 0.12, h * s2 - h, 0.0], [0.19, 0.0, 0.6], pad[0]])
        quat = np.stack([_quat_axis(2, np.pi / 4), _yaw_quat(0.0), _yaw_quat(0.0), _yaw_quat(0.0)])
        return pos, half, np.zeros(O), quat, free, vel, far
    if name == "robot_ram":
        half = np.array([[0.05, 0.32, 0.05], [0.1, 0.1, 0.1], [0.08, 0.15, 0.08], [0.1, 0.1, 0.1]])
        pos = np.array([[0.0, 0.0, 0.0], [0.6, 0.0, 0.1], [0.3, 0.0, -0.35], pad[0]])
        yaw = np.array([0.0, 0.7, -0.3, 0.0])

        def path(s):  # drive from x = -0.6 through the boxes at 1 m/s
            return np.array([-0.6 + 0.1 * min(s, 12), 0.0, 0.0])

        return pos, half, yaw, np.stack([_yaw_quat(y) for y in yaw]), free, vel, path
    if name == "robot_inside":
        # the robot appears with its axis inside box 0 (upright), then box 1
        # and box 2 (tipped about x and about z): pushed centre to centre
        half = np.array([[0.15, 0.1, 0.12], [0.12, 0.12, 0.12], [0.1, 0.2, 0.1], [0.1, 0.1, 0.1]])
        pos = np.array([[0.0, 0.0, 0.0], [0.8, 0.05, 0.0], [0.0, 0.1, 0.8], pad[0]])
        quat = np.stack([_yaw_quat(0.3), _quat_axis(0, 0.25), _quat_axis(2, 0.4), _yaw_quat(0.0)])

        def path(s):
            k = min(s // 10, 2)
            return np.array([pos[k, 0] + 0.03, 0.0, pos[k, 2] - 0.02])

        return pos, half, np.array([0.3, 0.0, -0.5, 0.0]), quat, free, vel, path
    assert name == "held_box"
    # box 1 is held (not free) inside box 0, which must take the whole
    # correction; the robot stands against box 2
    half = np.array([[0.1, 0.1, 0.1], [0.08, 0.08, 0.08], [0.1, 0.2, 0.1], [0.1, 0.1, 0.1]])
    pos = np.array([[0.0, 0.0, 0.0], [0.12, 0.1, 0.0], [0.5, 0.0, 0.0], pad[0]])
    free = np.array([True, False, True, True])
    vel = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    quat = np.stack([_yaw_quat(0.0), _quat_axis(0, 0.3), _yaw_quat(0.2), _yaw_quat(0.0)])
    return pos, half, np.array([0.0, 0.0, 0.2, 0.0]), quat, free, vel, lambda s: np.array([0.85, 0.0, 0.05])


SCENARIOS = ["overlapping_spawn", "stack", "sat_tie", "tipped_beside_upright", "robot_ram", "held_box",
             "robot_inside"]


def _batch(name, seed=0):
    """The scenario in env 0 and jittered copies in envs 1-3, float32."""
    pos, half, yaw, quat, free, vel, path = _scenario(name)
    rng = np.random.default_rng(seed)
    jit = rng.normal(0, 0.01, (N, O, 3)) * (np.arange(N) > 0)[:, None, None]
    jit[..., 1] = np.abs(jit[..., 1])  # lift, never sink
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    floor = f32(rng.uniform(-0.05, 0.05, N) * (np.arange(N) > 0))
    state = dict(
        p=f32(pos[None] + jit + floor[:, None, None] * np.array([0, 1, 0])),
        v=f32(np.broadcast_to(vel, (N, O, 3))),
        q=f32(np.broadcast_to(quat, (N, O, 4))),
        w=np.zeros((N, O, 3), np.float32),
    )
    const = dict(free=np.broadcast_to(free, (N, O)).copy(), floor=floor, half=f32(np.broadcast_to(half, (N, O, 3))),
                 yaw=f32(np.broadcast_to(yaw, (N, O))))

    def agent(s):
        return f32(np.broadcast_to(path(s), (N, 3)) + np.array([0.0, 1.0, 0.0]) * floor[:, None])

    return state, const, agent


def _jax_step(jstep, version, st, c, agent):
    args = [jnp.asarray(x) for x in (st["p"], st["v"], c["free"], c["floor"], agent, c["half"], c["yaw"])]
    if version == "v3":
        p, v, f = jstep["v3"](*args)
        return dict(p=np.asarray(p), v=np.asarray(v), q=st["q"], w=st["w"]), np.asarray(f)
    p, v, f, q, w = jstep["v6"](*args, jnp.asarray(st["q"]), jnp.asarray(st["w"]))
    return dict(p=np.asarray(p), v=np.asarray(v), q=np.asarray(q), w=np.asarray(w)), np.asarray(f)


def _torch_step(version, st, c, agent, dtype=torch.float32):
    def t(x):
        x = torch.as_tensor(np.array(x))
        return x.to(dtype) if x.is_floating_point() else x

    args = (t(st["p"]), t(st["v"]), t(c["free"]), t(c["floor"]), t(agent))
    if version == "v3":
        p, v, f = tre.contact_step(*args, half=t(c["half"]), yaw_o=t(c["yaw"]))
        return dict(p=p.numpy(), v=v.numpy(), q=st["q"], w=st["w"]), f.numpy()
    p, v, f, q, w = tre.contact_step(*args, half=t(c["half"]), yaw_o=t(c["yaw"]), quat=t(st["q"]), omega=t(st["w"]))
    return dict(p=p.numpy(), v=v.numpy(), q=q.numpy(), w=w.numpy()), f.numpy()


def _gaps(ref, got, f_ref, f_got):
    """Each gap less its relative allowance: within tolerance when <= ATOL
    (FORCE_ATOL for the force)."""
    gaps = {k: float(np.abs(ref[k] - got[k]).max()) for k in ("p", "v", "q")}
    gaps["w"] = float((np.abs(ref["w"] - got["w"]) - W_RTOL * np.abs(ref["w"])).max())
    gaps["force"] = float((np.abs(f_ref - f_got) - FORCE_RTOL * np.abs(f_ref)).max())
    return gaps


@pytest.mark.parametrize("version", ["v3", "v6"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_contact_step_teacher_forced(jstep, name, version):
    state, const, agent = _batch(name)
    worst = dict(p=0.0, v=0.0, q=0.0, w=0.0, force=-np.inf)
    p0 = state["p"].copy()
    for s in range(STEPS):
        ref, f_ref = _jax_step(jstep, version, state, const, agent(s))
        got, f_got = _torch_step(version, state, const, agent(s))
        for k, g in _gaps(ref, got, f_ref, f_got).items():
            worst[k] = max(worst[k], g)
        state = ref
    assert max(worst[k] for k in "pvqw") <= ATOL and worst["force"] <= FORCE_ATOL, worst
    held = ~const["free"]  # a held box is not simulated (bottom -> centre -> bottom rounds)
    np.testing.assert_allclose(state["p"][held], p0[held], atol=1e-6)
    if name == "robot_ram":
        assert f_ref.sum() >= 0.0 and np.abs(state["p"][:, 0] - p0[:, 0]).max() > 0.05  # the ram moved a box


def _random_state(seed, robot_among_boxes):
    """Tipped, spinning, floating and held boxes, floors at several heights;
    the robot among the boxes or 5 m away."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    q = rng.normal(size=(N, O, 4))
    st = dict(
        p=f32(np.c_[rng.uniform(-0.3, 0.3, (N * O, 1)), rng.uniform(0.0, 0.4, (N * O, 1)),
                    rng.uniform(-0.3, 0.3, (N * O, 1))].reshape(N, O, 3)),
        v=f32(rng.normal(0, 0.5, (N, O, 3))), q=f32(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        w=f32(rng.normal(0, 1, (N, O, 3))),
    )
    c = dict(free=rng.uniform(size=(N, O)) > 0.15, floor=f32(rng.uniform(-0.1, 0.1, N)),
             half=f32(rng.uniform(0.05, 0.2, (N, O, 3))), yaw=f32(rng.uniform(-3, 3, (N, O))))
    agent = f32(np.c_[rng.uniform(-0.3, 0.3, N), np.zeros(N), rng.uniform(-0.3, 0.3, N)])
    if not robot_among_boxes:
        agent[:, 0] += 5.0
    return st, c, agent


@pytest.mark.parametrize("version", ["v3", "v6"])
def test_contact_step_random_batch(jstep, version):
    """One step from a random state, the robot away from the boxes."""
    st, c, agent = _random_state(11, robot_among_boxes=False)
    ref, f_ref = _jax_step(jstep, version, st, c, agent)
    got, f_got = _torch_step(version, st, c, agent)
    gaps = _gaps(ref, got, f_ref, f_got)
    assert max(gaps[k] for k in "pvqw") <= ATOL and gaps["force"] <= FORCE_ATOL, gaps


# fixed bounds for the boxes the robot reaches in the v6 random batch, about
# twice the largest gap measured there (see the module docstring)
REACHED_BOUND = dict(p=6e-5, v=6e-4, q=1.2e-4, w=3e-3)


@pytest.mark.parametrize("version", ["v3", "v6"])
def test_contact_step_random_batch_robot_among_boxes(jstep, version):
    """One step from a random state with the robot's axis inside boxes.

    v3, the force, and in v6 every box whose JAX result is the same with the
    robot 5 m away are held to the JAX package at the module's tolerances.
    In v6 the boxes the robot reaches are held to REACHED_BOUND against the
    JAX package, and both packages' float32 results to half of it against the
    port run in float64."""
    st, c, agent = _random_state(11, robot_among_boxes=True)
    ref, f_ref = _jax_step(jstep, version, st, c, agent)
    got, f_got = _torch_step(version, st, c, agent)
    np.testing.assert_allclose(f_got, f_ref, rtol=FORCE_RTOL, atol=FORCE_ATOL)
    if version == "v3":
        gaps = _gaps(ref, got, f_ref, f_got)
        assert max(gaps[k] for k in "pvqw") <= ATOL, gaps
        return
    away = agent.copy()
    away[:, 0] += 5.0
    ref_away, _ = _jax_step(jstep, version, st, c, away)
    reached = np.zeros((N, O), bool)
    for k in "pvqw":
        reached |= (ref[k] != ref_away[k]).any(-1)
    assert 0 < reached.sum() < N * O
    exact, _ = _torch_step(version, st, c, agent, dtype=torch.float64)
    for k in "pvqw":
        gap = np.abs(got[k] - ref[k])
        allow = ATOL + (W_RTOL * np.abs(ref[k]) if k == "w" else 0.0)
        assert (gap <= allow)[~reached].all(), (k, float(gap[~reached].max()))
        assert gap[reached].max() <= REACHED_BOUND[k], (k, float(gap[reached].max()))
        for name, x in (("jax", ref[k]), ("port", got[k])):
            err = float(np.abs(x - exact[k])[reached].max())
            assert err <= REACHED_BOUND[k] / 2, (k, name, err)


def test_contact_step_default_half_and_yaw(jstep):
    """v3 with the defaults: every box OBJ_HALF, upright, unrotated."""
    state, const, agent = _batch("overlapping_spawn", seed=2)
    p, v, f = jax.jit(jre.contact_step)(*[jnp.asarray(x) for x in (state["p"], state["v"], const["free"],
                                                                     const["floor"], agent(0))])
    got = tre.contact_step(*[torch.as_tensor(np.array(x)) for x in (state["p"], state["v"], const["free"],
                                                                       const["floor"], agent(0))])
    for r, g in zip((p, v), got[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(f), rtol=FORCE_RTOL, atol=FORCE_ATOL)


@pytest.mark.parametrize("version", ["v3", "v6"])
def test_contact_step_leaves_inputs_unchanged(version):
    state, const, agent = _batch("held_box")
    xs = dict(obj_pos=state["p"], obj_vel=state["v"], free=const["free"], floor_y=const["floor"],
              agent_pos=agent(0))
    kw = dict(half=const["half"], yaw_o=const["yaw"])
    if version == "v6":
        kw.update(quat=state["q"], omega=state["w"])
    xs = {k: torch.as_tensor(np.array(x)) for k, x in xs.items()}
    kw = {k: torch.as_tensor(np.array(x)) for k, x in kw.items()}
    before = {k: x.clone() for k, x in {**xs, **kw}.items()}
    tre.contact_step(**xs, **kw)
    for k, x in {**xs, **kw}.items():
        assert torch.equal(x, before[k]), k


def test_contact_step_refuses_mixed_devices():
    """A tensor on another device raises (PyTorch's own check); nothing is
    copied across."""
    state, const, agent = _batch("stack")
    args = [torch.as_tensor(np.array(x)) for x in (state["p"], state["v"], const["free"], const["floor"], agent(0))]
    with pytest.raises(RuntimeError, match="device"):
        tre.contact_step(*args[:3], args[3].to("meta"), args[4])


def test_settle_objects_matches_jax():
    """Overlapping and floating spawns settled by 30 v3 steps in both
    packages (a free run, as the generator runs it)."""
    rng = np.random.default_rng(4)
    E = N
    init = np.c_[rng.uniform(-0.25, 0.25, (E * O, 1)), rng.uniform(0.0, 0.6, (E * O, 1)),
                 rng.uniform(-0.25, 0.25, (E * O, 1))].reshape(E, O, 3).astype(np.float32)
    valid = rng.uniform(size=(E, O)) > 0.2
    floor = rng.uniform(-0.1, 0.1, E).astype(np.float32)
    ref = jgen.settle_objects(init, valid, floor)
    got = tgen.settle_objects(init, valid, floor, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == init.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert (got[..., 1] >= floor[:, None] - 1e-6)[valid].all()


def test_settle_objects_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.settle_objects(np.zeros((1, 1, 3)), np.ones((1, 1), bool), np.zeros(1))
