"""habitat_torch's velocity control (``tasks/nav.py::VelocityAction`` and
the batched env's velocity path) against habitat_tpu's on the CPU.

- tests/test_env_api.py::test_velocity_control_substeps's schedule on both
  packages (an arc, opposite turns, then both speeds under their minimums):
  positions, yaws and rewards within 1e-5, dones equal (the auto-stop);
  ``action_shape == (2,)`` and ``action_dim == 2`` where the discrete env
  has ``num_actions``.
- 40 steps of seeded commands in [-1.2, 1.2]^2 (clipped to [-1, 1]) at N=4
  with 4 substeps and a 12-step limit, auto-reset on: positions, yaws,
  collisions, measures and rewards within 1e-5, dones, episode ids and
  collision counts equal, some steps colliding and some envs reset; the
  discrete path's substep count is untouched (tests/test_torch_env.py).
- The single-env ``Env`` takes a (linear, angular) command.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.config.default import read_write as jax_read_write
from habitat_tpu.config.omega import Config as JaxConfig
from habitat_tpu.core.construct import env_from_config as jax_env_from_config

from habitat_torch.config.default import get_config
from habitat_torch.config.omega import Config, read_write
from habitat_torch.core.construct import env_from_config
from habitat_torch.core.env import Env

from tests.test_torch_env_api import CFG, SMALL
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL = 1e-5
VELOCITY = {"type": "VelocityAction", "lin_vel_range": [0.0, 0.25], "ang_vel_range": [-10.0, 10.0],
            "min_abs_lin_speed": 0.025, "min_abs_ang_speed": 1.0, "time_step": 1.0}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _velocity(cfg, rw, config_cls, extra=()):
    with rw(cfg) as c:
        c.habitat.task.actions = config_cls({"velocity_control": config_cls(VELOCITY)})
        for k, v in extra:
            c.set_path(k, v)
    return cfg


def _pair(n, extra=()):
    je = jax_env_from_config(_velocity(jax_get_config(CFG, SMALL), jax_read_write, JaxConfig, extra), num_envs=n)
    te = env_from_config(_velocity(get_config(CFG, SMALL), read_write, Config, extra), num_envs=n, device="cpu")
    return je, te


def _same(js, ts, jr, tr, jd, td, what):
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done@{what}")
    for name in ("pos", "yaw", "prev_pos"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=0, atol=ATOL,
                                   err_msg=f"{name}@{what}")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ATOL, err_msg=f"reward@{what}")


def test_substep_schedule_matches_jax():
    je, te = _pair(2)
    assert te.action_shape == (2,) == je.action_space.shape and te.action_dim == 2
    assert not hasattr(te, "num_actions") and te.action_names == ("velocity_control",)
    js, _ = je.reset(seed=0)
    ts, _ = te.reset()
    p0, y0 = ts.pos.clone(), ts.yaw.clone()
    schedule = [[[1.0, 0.5], [1.0, 0.5]], [[1.0, -1.0], [1.0, 1.0]], [[-1.0, 0.0], [-1.0, 0.0]]]
    dones = []
    for k, a in enumerate(schedule):
        y_before = ts.yaw.clone()
        js, _, jr, jd, _ = je.step(js, jnp.asarray(a, jnp.float32))
        ts, _, tr, td, _ = te.step(ts, a)
        _same(js, ts, jr, tr, jd, td, k)
        dones.append(td.tolist())
        if k == 0:
            # full forward, half-positive turn: an arc, both pos and yaw change
            assert (ts.pos - p0).norm(dim=-1).min() > 0.1 and (ts.yaw - y0).abs().max() > 0.01
        if k == 1:
            d_yaw = ts.yaw - y_before  # opposite turns bend opposite ways
            assert d_yaw[0] < 0 < d_yaw[1]
    assert dones == [[False, False], [False, False], [True, True]]  # under both minimums: auto-stop


def test_seeded_commands_match_jax():
    je, te = _pair(4, extra=(("habitat.environment.max_episode_steps", 12),))
    js, _ = je.reset(seed=0)
    ts, _ = te.reset()
    rng = np.random.default_rng(5)
    collided = resets = 0
    for k in range(40):
        a = rng.uniform(-1.2, 1.2, (4, 2)).astype(np.float32)
        a[:, 0] = np.abs(a[:, 0])  # mostly forward, so the agents reach walls
        js, _, jr, jd, jinfo = je.step(js, jnp.asarray(a))
        ts, _, tr, td, tinfo = te.step(ts, a)
        _same(js, ts, jr, tr, jd, td, k)
        for name in ("ep_idx", "collision_count", "step", "last_action"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)
        for m in tinfo:
            np.testing.assert_allclose(tinfo[m].numpy(), np.asarray(jinfo[m]), rtol=0, atol=ATOL, err_msg=f"{m}@{k}")
        got, want = te.get_metrics(tinfo), je.get_metrics(jinfo)
        assert set(got) == set(want) and all(np.abs(got[m] - want[m]).max() <= ATOL for m in want)
        collided += int(tinfo["is_collision"].sum())
        resets += int(td.sum())
    assert collided > 0 and resets >= 4


def test_env_takes_velocity_commands():
    te = Env(_velocity(get_config(CFG, SMALL), read_write, Config), device="cpu")
    te.reset()
    te.step([1.0, 0.0])
    assert not te.episode_over and te.elapsed_steps == 1
    assert not torch.equal(te._state.pos, te._state.prev_pos) or te.get_metrics()["is_collision"] == 1.0
    te.step({"action": np.array([-1.0, 0.0])})  # both speeds under their minimums
    assert te.episode_over
    with pytest.raises(AssertionError):
        te.step([1.0, 0.0])
