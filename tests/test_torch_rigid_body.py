"""habitat_torch's rigid-body boxes against habitat_tpu's on the CPU.

Same seeded numpy inputs through ``habitat_tpu.tasks.rearrange.rigid_body``
(one ``jax.jit`` per function) and ``habitat_torch.tasks.rearrange.rigid_body``.

``box_floor_substep`` makes threshold decisions (a corner touching, the sleep
rule), so a last-bit difference can part two free runs. Its trajectories
are therefore teacher-forced: the JAX state at step k goes into both
packages and their step k+1 is compared, over the JAX package's own
scenarios (tests/test_rigid_body.py: flat drop, tilted drop, ledge tip).

Tolerances: atol 1e-5 on positions, velocities, quaternions, angular
velocities and matrices (float32 arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.tasks.rearrange import rigid_body as jrb

from habitat_torch.tasks.rearrange import rigid_body as trb

ATOL = 1e-5
N, O = 4, 4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jsub():
    """One jit of the JAX substep per (dt, ledges or not)."""
    return jax.jit(jrb.box_floor_substep, static_argnames=("dt", "g", "mu", "ang_damp", "mass"))


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))  # a writable copy of a JAX result


def _random_quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _conv(m, x):
    return jnp.asarray(x) if m is jrb else torch.as_tensor(x)


def _quats(m, rng):
    return _conv(m, _random_quats(rng, (N, O)))


def _halves(m, rng):
    return _conv(m, rng.uniform(0.05, 0.2, (N, O, 3)).astype(np.float32))


def _yaws(m, rng):
    return _conv(m, rng.uniform(-4, 4, (N, O)).astype(np.float32))


HELPERS = {
    "quat_identity": lambda m, rng: m.quat_identity((N, O), **({} if m is jrb else {"device": "cpu"})),
    "quat_from_yaw": lambda m, rng: m.quat_from_yaw(_yaws(m, rng)),
    "quat_mul": lambda m, rng: m.quat_mul(_quats(m, rng), _quats(m, rng)),
    "quat_normalize": lambda m, rng: m.quat_normalize(_conv(m, rng.normal(size=(N, O, 4)).astype(np.float32))),
    "quat_to_matrix": lambda m, rng: m.quat_to_matrix(_quats(m, rng)),
    "quat_integrate": lambda m, rng: m.quat_integrate(
        _quats(m, rng), _conv(m, rng.normal(size=(N, O, 3)).astype(np.float32)), 0.025),
    "yaw_from_quat": lambda m, rng: m.yaw_from_quat(_quats(m, rng)),
    "yaw_round_trip": lambda m, rng: m.yaw_from_quat(m.quat_from_yaw(_yaws(m, rng))),
    "box_inertia_inv": lambda m, rng: m.box_inertia_inv(_halves(m, rng), 1.7),
    "world_inertia_inv": lambda m, rng: m.world_inertia_inv(_quats(m, rng), _halves(m, rng)),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_match_jax(name):
    fn = HELPERS[name]
    ref = _np(fn(jrb, np.random.default_rng(7)))
    got = fn(trb, np.random.default_rng(7))
    assert got.dtype == torch.float32
    # inverse inertias are 1e2-1e3: compare them relatively
    rtol = 1e-6 if name.endswith("inertia_inv") else 0.0
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=rtol)


def _scenario(name):
    """The JAX package's scenarios (tests/test_rigid_body.py), N=1:
    (p, v, q, w, half, ledges, steps)."""
    if name == "flat_drop":
        return ([[[0.0, 0.5, 0.0]]], np.zeros((1, 1, 3)), np.array([[[1.0, 0, 0, 0]]]), np.zeros((1, 1, 3)),
                np.full((1, 1, 3), 0.1), None, 200)
    if name == "tilted_drop":
        a = np.deg2rad(35.0) / 2
        return ([[[0.0, 0.4, 0.0]]], np.zeros((1, 1, 3)), np.array([[[np.cos(a), np.sin(a), 0.0, 0.0]]]),
                np.zeros((1, 1, 3)), np.full((1, 1, 3), 0.1), None, 400)
    ledges = np.array([[[-0.2, 0.15, 0.0, 0.3, 0.15, 0.5]]])
    return ([[[0.08, 0.36, 0.0], [-0.3, 0.36, 0.0]]], [[[0.25, 0.0, 0.0], [0.0, 0.0, 0.0]]],
            np.tile([1.0, 0, 0, 0], (1, 2, 1)), np.zeros((1, 2, 3)), np.full((1, 2, 3), 0.06), ledges, 500)


@pytest.mark.parametrize("name", ["flat_drop", "tilted_drop", "ledge_tip"])
def test_box_floor_substep_teacher_forced(jsub, name):
    p, v, q, w, half, ledges, steps = _scenario(name)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    state = [f32(p), f32(v), f32(q), f32(w)]
    half = f32(half)
    free = np.ones(half.shape[:2], bool)
    floor = np.zeros((half.shape[0],), np.float32)
    led = None if ledges is None else f32(ledges)
    worst = np.zeros(4)
    for _ in range(steps):
        ref = jsub(*[jnp.asarray(x) for x in state], jnp.asarray(half), jnp.asarray(free), jnp.asarray(floor),
                   dt=0.02, ledges=None if led is None else jnp.asarray(led))
        got = trb.box_floor_substep(*[_t(x) for x in state], _t(half), _t(free), _t(floor), 0.02,
                                    ledges=None if led is None else _t(led))
        for i, (r, g) in enumerate(zip(ref, got)):
            worst[i] = max(worst[i], float(np.abs(_np(r) - g.numpy()).max()))
        state = [_np(r) for r in ref]
    assert (worst <= ATOL).all(), f"max |dp|, |dv|, |dq|, |dw| over {steps} steps: {worst}"
    if name == "ledge_tip":  # the overhanging box tipped off the ledge, in both packages' last step
        assert float(state[0][0, 0, 1]) < 0.1


def test_box_floor_substep_random_batch(jsub):
    """A random (4, 4) batch: some boxes held, floors at several heights,
    ledges under some boxes, tipped and spinning boxes."""
    rng = np.random.default_rng(3)
    half = rng.uniform(0.05, 0.2, (N, O, 3)).astype(np.float32)
    p = np.c_[rng.uniform(-0.4, 0.4, (N * O, 1)), rng.uniform(0.0, 0.5, (N * O, 1)),
              rng.uniform(-0.4, 0.4, (N * O, 1))].reshape(N, O, 3).astype(np.float32)
    v = rng.normal(0, 0.5, (N, O, 3)).astype(np.float32)
    q = _random_quats(rng, (N, O))
    w = rng.normal(0, 2, (N, O, 3)).astype(np.float32)
    free = rng.uniform(size=(N, O)) > 0.2
    floor = rng.uniform(-0.1, 0.1, N).astype(np.float32)
    ledges = np.c_[rng.uniform(-0.3, 0.3, (N * 2, 1)), rng.uniform(0.05, 0.15, (N * 2, 1)),
                   rng.uniform(-0.3, 0.3, (N * 2, 1)), rng.uniform(0.1, 0.3, (N * 2, 3))].reshape(N, 2, 6)
    ledges = ledges.astype(np.float32)
    for led in (None, ledges):
        ref = jsub(*[jnp.asarray(x) for x in (p, v, q, w, half, free, floor)], dt=0.025,
                   ledges=None if led is None else jnp.asarray(led))
        got = trb.box_floor_substep(*[_t(x) for x in (p, v, q, w, half, free, floor)], 0.025,
                                    ledges=None if led is None else _t(led))
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), _np(r), atol=ATOL)


def test_box_floor_substep_leaves_inputs_unchanged():
    rng = np.random.default_rng(5)
    xs = [torch.as_tensor(x) for x in (
        rng.uniform(0.0, 0.3, (N, O, 3)).astype(np.float32), rng.normal(0, 1, (N, O, 3)).astype(np.float32),
        _random_quats(rng, (N, O)), rng.normal(0, 1, (N, O, 3)).astype(np.float32),
        rng.uniform(0.05, 0.2, (N, O, 3)).astype(np.float32), rng.uniform(size=(N, O)) > 0.3,
        np.zeros(N, np.float32))]
    before = [x.clone() for x in xs]
    out = trb.box_floor_substep(*xs, 0.025)
    for x, b in zip(xs, before):
        assert torch.equal(x, b)
    assert not any(o.data_ptr() == x.data_ptr() for o in out for x in xs)
