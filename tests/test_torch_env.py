"""habitat_torch BatchedEnv against habitat_tpu's on a fixed action schedule.

64 steps over N=8 envs with a short episode limit, so episodes end by stop,
by success and by the time limit and the masked auto-reset runs many times.
Dones, episode ids and episode pointers must be equal; poses, rewards,
measures and the pointgoal observation within 1e-5 (float32 arithmetic in
both, evaluated in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav

from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from tests.torch_jax_native import _jax_native  # noqa: F401

N_ENVS, N_STEPS, MAX_STEPS = 8, 64, 12
MEASURES = ("distance_to_goal", "success", "spl", "soft_spl", "collisions",
            "distance_to_goal_reward", "num_steps")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    kw = dict(num_scenes=2, episodes_per_scene=4, seed=0)
    sj, ej, fj = jax_pointnav(**kw)
    st, et, ft = make_procedural_pointnav(**kw)
    env_kw = dict(num_envs=N_ENVS, max_episode_steps=MAX_STEPS, seed=3)
    return (
        jax_make_nav_env(sj, ej, precomputed_fields=fj, **env_kw),
        make_nav_env(st, et, precomputed_fields=ft, device="cpu", **env_kw),
    )


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), b.double().numpy(), rtol=0, atol=1e-5, err_msg=what)


def test_fixed_action_rollout_matches(envs):
    je, te = envs
    rng = np.random.default_rng(0)
    # mostly forward/turns; stop is rare so episodes also run to the limit
    actions = rng.choice(4, size=(N_STEPS, N_ENVS), p=[0.04, 0.56, 0.2, 0.2]).astype(np.int32)
    js, jobs = je.reset(seed=0)
    ts, tobs = te.reset_fn()
    _close(jobs["pointgoal_with_gps_compass"], tobs["pointgoal_with_gps_compass"], "obs@reset")
    n_done = 0
    for k in range(N_STEPS):
        js, jobs, jr, jd, jinfo = je.step(js, jnp.asarray(actions[k]))
        ts, tobs, tr, td, tinfo = te.step_fn(ts, torch.from_numpy(actions[k]))
        np.testing.assert_array_equal(np.asarray(jd), td.numpy(), err_msg=f"done@{k}")
        for name in ("ep_idx", "ep_ptr", "step", "collision_count", "last_action", "episode_count"):
            np.testing.assert_array_equal(
                np.asarray(getattr(js, name)), getattr(ts, name).numpy(), err_msg=f"{name}@{k}"
            )
        for name in ("pos", "yaw", "prev_pos"):
            _close(getattr(js, name), getattr(ts, name), f"{name}@{k}")
        _close(jr, tr, f"reward@{k}")
        for m in MEASURES:
            _close(jinfo[m], tinfo[m], f"{m}@{k}")
        _close(jinfo["is_collision"], tinfo["is_collision"], f"is_collision@{k}")
        _close(jobs["pointgoal_with_gps_compass"], tobs["pointgoal_with_gps_compass"], f"obs@{k}")
        for m, state in ts.measure_state.items():
            for leaf, v in state.items():
                _close(js.measure_state[m][leaf], v, f"{m}.{leaf}@{k}")
        n_done += int(td.sum())
    assert n_done >= N_ENVS  # auto-reset exercised


def test_device_none_needs_cuda(envs, monkeypatch):
    """Entry points default to CUDA and never continue on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st, et, ft = make_procedural_pointnav(num_scenes=1, episodes_per_scene=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_nav_env(st, et, num_envs=1, precomputed_fields=ft)
