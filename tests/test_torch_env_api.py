"""habitat_torch's single-env API (``core/env.py``, ``core/environments.py``)
and the batched env's non-auto-reset path against habitat_tpu's on the CPU,
at tests/test_env_api.py's small overrides (2 procedural scenes x 3
episodes, 32x32 depth, 20 steps per episode).

- ``Env`` and ``RLTaskEnv`` through a fixed action schedule whose episodes
  end by stop and by the step limit: at every step the episode id,
  ``episode_over``, ``elapsed_steps``, reward and done equal; depth,
  pointgoal and every metric within 1e-5 (float32 in both, evaluated in
  different orders). After a reset the JAX metrics are its measure values
  jitted: its ``Env.reset`` evaluates them eagerly, and an eager cell index
  parts from XLA's compiled one (the port's) at cell boundaries, where
  episodes start.
- ``Env`` on the mini on-disk dataset (PointNav-v1 episodes and their glb
  stage) through the same schedule. The JAX package keys a loaded scene by
  its file name and so cannot build this env; here its ``load_scene`` is
  wrapped to give the scene the id its episodes name, as the port does.
- ``BatchedEnv(auto_reset_done=False)``: ``reset_to_fn`` to given episodes,
  steps past an env's end (its state held, its step count still counting),
  ``measure_values`` after each step, and a second ``reset_to_fn`` whose
  measure state equals a fresh env's (nothing of the earlier episodes
  carried over); the JAX side jitted, as its ``Env`` runs it.
- ``render()``: the depth observation as gray, and the 256x256 frame of a
  config with no visual sensor against JAX's on >= 99.9% of pixels (the
  frame rule of tests/test_torch_raycast.py).
- The lifecycle's assertions, ``get_env_class``, and ``device=None``
  raising without a card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.config.default import read_write as jax_read_write
from habitat_tpu.core import env as jenv
from habitat_tpu.core.batched_env import BatchedEnv as JaxBatchedEnv
from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.core.environments import RLTaskEnv as JaxRLTaskEnv
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.sims import loaders as jloaders

from habitat_torch.config.default import get_config
from habitat_torch.config.omega import read_write
from habitat_torch.core.batched_env import BatchedEnv
from habitat_torch.core.env import Env
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.core.environments import RLTaskEnv, get_env_class
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from tests.torch_jax_native import _jax_native  # noqa: F401

CFG = "benchmark/nav/pointnav/pointnav_procgen.yaml"
SMALL = [
    "habitat.dataset.procedural.num_scenes=2",
    "habitat.dataset.procedural.episodes_per_scene=3",
    "habitat.simulator.agents.main_agent.sim_sensors.depth_sensor.width=32",
    "habitat.simulator.agents.main_agent.sim_sensors.depth_sensor.height=32",
    "habitat.environment.max_episode_steps=20",
]
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
MINI = SMALL[2:] + [
    "habitat.dataset.type=PointNav-v1", "habitat.dataset.split=val",
    f"habitat.dataset.data_path={ASSETS}/mini_dataset/pointnav/v1/{{split}}/{{split}}.json.gz",
    f"habitat.dataset.scenes_dir={ASSETS}",
]
# episodes end by stop (after 8 steps), by the limit (20), by stop (6), by
# the limit, then a last one runs 4 steps
SCHEDULE = [1, 1, 2, 1, 3, 1, 1, 0] + [1, 2, 1, 1, 3] * 5 + [0] + [1, 3, 1, 2] * 6
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_keyed_by_episode_ids(monkeypatch):
    """The JAX loader, giving each scene the id its episodes name."""
    load = jloaders.load_scene

    def load_scene(scene_id, *args, **kwargs):
        scene = load(scene_id, *args, **kwargs)
        scene.scene_id = scene_id
        return scene

    monkeypatch.setattr(jloaders, "load_scene", load_scene)


@pytest.fixture(scope="module")
def procedural():
    return jenv.Env(jax_get_config(CFG, SMALL)), Env(get_config(CFG, SMALL), device="cpu")


@pytest.fixture(scope="module")
def on_disk():
    with pytest.MonkeyPatch.context() as mp:
        _jax_keyed_by_episode_ids(mp)
        je = jenv.Env(jax_get_config(CFG, MINI))
    return je, Env(get_config(CFG, MINI), device="cpu")


def _same_obs(jo, to, what):
    assert set(jo) == set(to), what
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0, atol=ATOL, err_msg=f"{k}@{what}")


def _same_metrics(jm, tm, what):
    assert set(jm) == set(tm), (what, sorted(jm), sorted(tm))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=ATOL, err_msg=f"{k}@{what}")


def _jax_reset_metrics(env):
    """The JAX ``Env``'s metrics after a reset, its measure values jitted
    (its ``reset`` computes them eagerly, whose cell index parts from the
    compiled one at cell boundaries, where episodes start)."""
    jitted = jax.jit(env._inner.measure_values)(env._state)
    return {**env.get_metrics(), **{k: np.asarray(v)[0] for k, v in jitted.items()}}


def _drive(je, te, rl=False):
    """Both envs through SCHEDULE, resetting when an episode is over;
    returns how each episode ended (its step count and whether it stopped
    early)."""
    ends, jo, to = [], None, None
    env_j, env_t = (je.habitat_env, te.habitat_env) if rl else (je, te)
    for k, a in enumerate(SCHEDULE):
        if jo is None or env_j.episode_over:
            jo, to = je.reset(), te.reset()
            assert env_t.current_episode.episode_id == env_j.current_episode.episode_id, k
            _same_obs(jo, to, f"reset@{k}")
            _same_metrics(_jax_reset_metrics(env_j), env_t.get_metrics(), f"reset@{k}")
        if rl:
            jo, jr, jd, jinfo = je.step(a)
            to, tr, td, tinfo = te.step(a)
            assert td == jd and isinstance(tr, float), k
            np.testing.assert_allclose(tr, jr, rtol=0, atol=ATOL, err_msg=f"reward@{k}")
            _same_metrics(jinfo, tinfo, f"step {k}")
        else:
            jo, to = je.step(a), te.step(a)
            _same_metrics(je.get_metrics(), te.get_metrics(), f"step {k}")
        _same_obs(jo, to, f"step {k}")
        assert (env_t.episode_over, env_t.elapsed_steps) == (env_j.episode_over, env_j.elapsed_steps), k
        if env_t.episode_over:
            ends.append((env_t.elapsed_steps, a == 0))
    return ends


def test_env_schedule_matches_jax(procedural):
    je, te = procedural
    ends = _drive(je, te)
    assert ends == [(8, True), (20, False), (6, True), (20, False)]


def test_rl_task_env_schedule_matches_jax():
    je, te = JaxRLTaskEnv(jax_get_config(CFG, SMALL)), RLTaskEnv(get_config(CFG, SMALL), device="cpu")
    assert get_env_class("RLTaskEnv") is RLTaskEnv
    assert te.number_of_episodes == 6
    assert _drive(je, te, rl=True) == [(8, True), (20, False), (6, True), (20, False)]


def test_env_on_disk_dataset_matches_jax(on_disk):
    je, te = on_disk
    assert te.number_of_episodes == 8
    assert _drive(je, te) == [(8, True), (20, False), (6, True), (20, False)]


def _batched_pair(n=3, max_steps=6):
    kw = dict(num_scenes=2, episodes_per_scene=3, seed=0)
    sensors = (("HabitatSimDepthSensor", {"height": 32, "width": 32}), ("PointGoalWithGPSCompassSensor", None))
    ej = jax_make_nav_env(*jax_pointnav(**kw)[:2], n, precomputed_fields=jax_pointnav(**kw)[2],
                          sensor_specs=sensors)
    st, et, ft = make_procedural_pointnav(**kw)
    et_ = make_nav_env(st, et, n, precomputed_fields=ft, sensor_specs=sensors, device="cpu")
    jb = JaxBatchedEnv(ej.pack, ej.table, np.asarray(ej.order), ej.sensors, ej.measures, ej.actions,
                       max_episode_steps=max_steps, auto_reset_done=False)
    tb = BatchedEnv(et_.pack, et_.table, et_.order.numpy(), et_.sensors, et_.measures, et_.actions,
                    device=torch.device("cpu"), max_episode_steps=max_steps, auto_reset_done=False)
    return jb, tb


def _same_state(js, ts, what):
    for name in ("ep_idx", "step", "stop_called", "collision_count", "last_action", "episode_over"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=f"{name}@{what}")
    for name in ("pos", "yaw", "prev_pos"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=0, atol=ATOL,
                                   err_msg=f"{name}@{what}")
    for m, leaves in ts.measure_state.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js.measure_state[m][leaf]), rtol=0, atol=ATOL,
                                       err_msg=f"{m}.{leaf}@{what}")


def test_batched_no_auto_reset_matches_jax():
    jb, tb = _batched_pair()
    reset_to = jax.jit(lambda data, key, idx: jb.reset_to_fn(key, idx, env_data=data))
    values = jax.jit(jb.measure_values)
    step = jax.jit(lambda data, s, a: jb.step_fn(s, a, env_data=data))

    def reset_both(idx):
        js, jo = reset_to(jb.env_data, jax.random.PRNGKey(0), jnp.asarray(idx, jnp.int32))
        ts, to = tb.reset_to_fn(torch.tensor(idx))
        _same_state(js, ts, f"reset {idx}")
        _same_obs(jo, to, f"reset {idx}")
        _same_metrics_rows(values(js), tb.measure_values(ts), f"reset {idx}")
        return js, ts

    js, ts = reset_both([4, 0, 2])
    schedule = [[1, 1, 3], [2, 0, 1], [1, 1, 1], [3, 2, 1], [1, 1, 0], [1, 3, 2], [1, 1, 1], [2, 2, 2]]
    for k, a in enumerate(schedule):
        js, jo, jr, jd, jinfo = step(jb.env_data, js, jnp.asarray(a, jnp.int32))
        ts, to, tr, td, tinfo = tb.step_fn(ts, torch.tensor(a))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done@{k}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=ATOL, err_msg=f"reward@{k}")
        _same_state(js, ts, f"step {k}")
        _same_obs(jo, to, f"step {k}")
        _same_metrics_rows(jinfo, tinfo, f"step {k}")
        _same_metrics_rows(values(js), tb.measure_values(ts), f"values@{k}")
    # env 1 stopped at step 2 and is held; the step limit ended the others
    assert ts.step.tolist() == [8, 8, 8] and ts.episode_over.all()
    assert ts.ep_idx.tolist() == [4, 0, 2] and ts.episode_count.tolist() == [0, 0, 0]
    # a second reset_to_fn leaves nothing of these episodes
    _, fresh_t = reset_both([1, 5, 3])
    ts2, _ = tb.reset_to_fn(torch.tensor([1, 5, 3]))
    _same_state_exact(ts2, fresh_t)
    _same_state_exact(BatchedEnv(tb.pack, tb.table, tb.order.numpy(), tb.sensors, tb.measures, tb.actions,
                                 device=torch.device("cpu"), auto_reset_done=False).reset_to_fn(
                                     torch.tensor([1, 5, 3]))[0], fresh_t)


def _same_metrics_rows(jm, tm, what):
    assert set(jm) == set(tm), what
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=0, atol=ATOL, err_msg=f"{k}@{what}")


def _same_state_exact(a, b):
    for name in ("ep_idx", "step", "pos", "yaw", "pitch", "prev_pos", "stop_called", "collision_count",
                 "episode_over", "episode_count"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert {m: {k: v.tolist() for k, v in s.items()} for m, s in a.measure_state.items()} == {
        m: {k: v.tolist() for k, v in s.items()} for m, s in b.measure_state.items()}


def test_render_matches_jax(procedural):
    je, te = procedural
    je.reset(), te.reset()
    frame = te.render()
    assert frame.shape == (32, 32, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame[..., 0], (te.sim._observations(te._state)["depth"][0, ..., 0] * 255)
                                  .to(torch.uint8).numpy())
    jc, tc = jax_get_config(CFG, SMALL), get_config(CFG, SMALL)
    for cfg, rw in ((jc, jax_read_write), (tc, read_write)):
        with rw(cfg) as c:
            del c.habitat.simulator.agents.main_agent.sim_sensors["depth_sensor"]
    jb, tb = jenv.Env(jc), Env(tc, device="cpu")
    assert "depth" not in tb.reset()
    jb.reset()
    for a in (1, 2, 1):
        jb.step(a), tb.step(a)
    got, want = tb.render(), jb.render()
    assert got.shape == want.shape == (256, 256, 3) and got.dtype == np.uint8
    assert (got == want).all(-1).mean() >= 0.999


def test_env_lifecycle_and_device(monkeypatch):
    te = Env(get_config(CFG, SMALL), device="cpu")
    with pytest.raises(AssertionError, match="reset"):
        te.step(1)
    te.reset()
    te.step("stop")
    assert te.episode_over and te.get_metrics()["success"] == 0.0
    with pytest.raises(AssertionError, match="Episode over"):
        te.step({"action": 1})
    te.seed(3)
    assert te.generator.initial_seed() == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Env(get_config(CFG, SMALL))
