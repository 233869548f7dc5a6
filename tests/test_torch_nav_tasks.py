"""habitat_torch's ObjectNav and ImageNav pieces against habitat_tpu's on the
same seeds and inputs (CPU; the JAX side renders through its XLA route).

- ``make_procedural_objectnav`` (2 scenes x 4 episodes): the episodes'
  fields equal and their geodesic fields bit-equal.
- Both ``from_json`` loaders on JSON strings written here: ObjectNav's
  goals_by_category schema, InstanceImageNav's dict and list goal schemas,
  an explicit ``goal_key`` and the scene-prefix fallback.
- ``_render_goal_images`` at 32x32 against the JAX XLA render of the same
  episodes: RGB equal on >= 99.9% of pixels (the frame rule of
  tests/test_torch_raycast.py:183-190).
- Every new sensor on a teacher-forced trajectory with look_up/look_down
  (the JAX state after each step is carried into the port's env): the envs
  of objectnav_procgen.yaml and imagenav_procgen.yaml at
  tests/test_tasks.py's 32x32 sizes, and a hand-built env with the other
  sensors; observations within 1e-5 (as tests/test_torch_env.py), goal
  images and the frames at nonzero pitch by the frame rule.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.core import construct as jcons
from habitat_tpu.core import dataset as jds
from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets import image_nav as jin
from habitat_tpu.datasets import object_nav as jon
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.tasks import nav as jnav

from habitat_torch.config.default import get_config
from habitat_torch.core import construct as tcons
from habitat_torch.core import dataset as tds
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets import image_nav as tin
from habitat_torch.datasets import object_nav as ton
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.tasks import nav as tnav
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL = 1e-5
FRAME_AGREE = 0.999
OBJECTNAV_32 = [
    "habitat.dataset.procedural.num_scenes=2",
    "habitat.dataset.procedural.episodes_per_scene=4",
] + [f"habitat.simulator.agents.main_agent.sim_sensors.{s}_sensor.{d}=32"
     for s in ("rgb", "depth", "semantic") for d in ("width", "height")]
IMAGENAV_32 = [
    "habitat.dataset.procedural.num_scenes=2",
    "habitat.dataset.procedural.episodes_per_scene=3",
    "habitat.task.lab_sensors.imagegoal.width=32",
    "habitat.task.lab_sensors.imagegoal.height=32",
    "habitat.simulator.agents.main_agent.sim_sensors.rgb_sensor.width=32",
    "habitat.simulator.agents.main_agent.sim_sensors.rgb_sensor.height=32",
]
# stop, forward, left, right, look_up, look_down: the camera tilts up and
# down by 15 degrees, twice up in a row, while the agent moves and turns
SCHEDULE = [[4, 1], [1, 4], [4, 5], [2, 5], [1, 1], [5, 3], [3, 4], [1, 2], [5, 5], [1, 1]]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fields(obj, skip=("_shortest_path_cache",)):
    """A dataclass as a dict, its nested dataclasses too, without ``skip``."""
    return {k: v for k, v in dataclasses.asdict(obj).items() if k not in skip}


def _frames_agree(ref, got, what):
    eq = (np.asarray(ref) == got.numpy())
    if eq.ndim == 4 and eq.shape[-1] == 3:
        eq = eq.all(-1)
    assert eq.mean() >= FRAME_AGREE, (what, eq.mean())


# -- datasets ----------------------------------------------------------------


def test_procedural_objectnav_bit_equal():
    kw = dict(num_scenes=2, episodes_per_scene=4, seed=0)
    (sj, ej, fj), (st, et, ft) = jon.make_procedural_objectnav(**kw), ton.make_procedural_objectnav(**kw)
    assert [s.scene_id for s in sj] == [s.scene_id for s in st]
    assert len(et) == len(ej) >= 6
    assert [_fields(e) for e in et] == [_fields(e) for e in ej]
    assert {e.info["object_category_id"] for e in et} <= {o["category_id"] for s in st for o in s.objects}
    assert sorted(ft) == sorted(fj)
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


OBJECTNAV_JSON = {
    "category_to_task_category_id": {"chair": 0, "table": 3},
    "goals_by_category": {
        "room_a.glb_chair": [
            {"position": [1.0, 0.0, 2.0], "radius": 0.5, "object_id": 7, "object_category": "chair",
             "view_points": [{"agent_state": {"position": [1.5, 0.0, 2.0]}}]},
            {"position": [3.0, 0.0, -1.0], "object_id": "8", "object_category": "chair"},
        ],
        "room_b.glb_table": [{"position": [0.0, 0.0, 0.0], "object_category": "table"}],
    },
    "episodes": [
        {"episode_id": 0, "scene_id": "data/scenes/room_a.glb", "start_position": [0.0, 0.0, 0.0],
         "start_rotation": [0.0, 0.38, 0.0, 0.92], "object_category": "chair", "info": {"geodesic_distance": 2.5}},
        {"episode_id": "1", "scene_id": "room_b.glb", "start_position": [1.0, 0.0, 1.0],
         "start_rotation": [0, 0, 0, 1], "object_category": "table"},
        {"episode_id": 2, "scene_id": "room_b.glb", "start_position": [1.0, 0.0, 1.0],
         "start_rotation": [0, 0, 0, 1], "object_category": "sofa", "info": {"object_category_id": 9}},
    ],
}

IMAGENAV_JSON = {
    "goals": {
        # the reference schema: one goal dict per key
        "room_a_7": {"position": [1.0, 0.0, 2.0], "radius": 0.2, "object_id": 7, "object_category": "chair",
                     "image_goals": [{"position": [1.0, 1.2, 3.0], "rotation": [0.0, 0.7071, 0.0, 0.7071],
                                      "hfov": 79.0, "image_dimensions": [480, 640]}, {"position": [0.0, 1.0, 0.0]}]},
        # a list of goals, and a key only the scene-prefix fallback finds
        "room_b.glb_extra": [{"position": [2.0, 0.0, 2.0], "object_id": "3"},
                             {"position": [2.5, 0.0, 2.0], "object_id": "4", "view_points": [[2.5, 0.0, 2.5]]}],
        "custom_key": {"position": [5.0, 0.0, 5.0], "object_id": 11},
    },
    "episodes": [
        {"episode_id": 0, "scene_id": "data/room_a.glb", "start_position": [0.0, 0.0, 0.0],
         "start_rotation": [0, 0, 0, 1], "goal_object_id": 7, "goal_image_id": 1, "object_category": "chair"},
        {"episode_id": 1, "scene_id": "data/room_b.glb", "start_position": [0.5, 0.0, 0.5],
         "start_rotation": [0, 1, 0, 0], "goal_object_id": "99"},
        {"episode_id": 2, "scene_id": "room_c.basis", "start_position": [0.0, 0.0, 1.0],
         "start_rotation": [0, 0, 0, 1], "goal_key": "custom_key", "info": {"geodesic_distance": 4.0}},
    ],
}


def test_objectnav_from_json_matches():
    text = json.dumps(OBJECTNAV_JSON)
    dj, dt = jon.ObjectNavDatasetV1(), ton.ObjectNavDatasetV1()
    dj.from_json(text)
    dt.from_json(text)
    assert [_fields(e) for e in dt.episodes] == [_fields(e) for e in dj.episodes]
    assert dt.category_to_task_category_id == dj.category_to_task_category_id
    assert {k: [_fields(g) for g in v] for k, v in dt.goals_by_category.items()} == \
        {k: [_fields(g) for g in v] for k, v in dj.goals_by_category.items()}
    a, b, c = dt.episodes
    assert (len(a.goals), len(b.goals), len(c.goals)) == (2, 1, 0)
    assert [e.info["object_category_id"] for e in dt.episodes] == [0, 3, 9]
    assert a.goals_key == "room_a.glb_chair" and dt.scene_ids == ["data/scenes/room_a.glb", "room_b.glb"]


def test_instance_imagenav_from_json_matches():
    text = json.dumps(IMAGENAV_JSON)
    dj, dt = jin.InstanceImageNavDatasetV1(), tin.InstanceImageNavDatasetV1()
    dj.from_json(text)
    dt.from_json(text)
    assert [_fields(e) for e in dt.episodes] == [_fields(e) for e in dj.episodes]
    a, b, c = dt.episodes
    assert [g.object_id for g in a.goals] == ["7"] and a.goals[0].image_goals[0].hfov == 79.0
    assert a.goals[0].image_goals[1].rotation == [0, 0, 0, 1] and a.goal_key == "room_a_7"
    assert [g.object_id for g in b.goals] == ["3", "4"]  # by the scene prefix "room_b.glb"
    assert [g.object_id for g in c.goals] == ["11"] and c.goal_key == "room_c_11"
    # the goal view of a stored camera: its position and the quaternion's yaw
    pos, yaw = tds.goal_view(a)
    np.testing.assert_array_equal(pos, np.float32([0.0, 1.0, 0.0]))
    assert yaw == 0.0
    dt.episodes[0].goal_image_id = 0
    assert tds.goal_view(dt.episodes[0])[1] == pytest.approx(np.pi / 2, abs=1e-4)


# -- goal images -------------------------------------------------------------


@pytest.fixture(scope="module")
def pointnav_both():
    kw = dict(num_scenes=2, episodes_per_scene=4, seed=0)
    return jax_pointnav(**kw), make_procedural_pointnav(**kw)


def test_goal_images_match_jax_xla(pointnav_both):
    (sj, ej, _), (st, et, _) = pointnav_both
    ref = jds._render_goal_images(ej, {s.scene_id: s for s in sj}, {s.scene_id: i for i, s in enumerate(sj)}, 32)
    got = tds._render_goal_images(et, {s.scene_id: s for s in st}, {s.scene_id: i for i, s in enumerate(st)}, 32,
                                  device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape == (len(et), 32, 32, 3)
    _frames_agree(ref, got, "goal rgb")
    assert len({bytes(g.numpy()) for g in got}) == len(et)  # every episode its own view
    table = tds.build_episode_table(
        et, {s.scene_id: s for s in st}, {s.scene_id: i for i, s in enumerate(st)}, goal_image_size=32,
        device="cpu")
    assert torch.equal(table.goal_image, got)
    no_goal = tds.build_episode_table(et, {s.scene_id: s for s in st}, {s.scene_id: i for i, s in enumerate(st)})
    assert tuple(no_goal.goal_image.shape) == (len(et), 1, 1, 3) and not no_goal.goal_image.any()


# -- sensors on teacher-forced trajectories ------------------------------------


def _teacher_forced(je, te, check, steps=SCHEDULE):
    """Reset both envs, then each step: both take the action, ``check``
    compares (jax obs, port obs, k), and the JAX state's pose is carried
    into the port's state for the next step."""
    js, jobs = je.reset(seed=0)
    ts, tobs = te.reset_fn()
    check(jobs, tobs, -1)
    tilted = 0
    for k, acts in enumerate(steps):
        a = np.asarray(acts, np.int32)
        js, jobs, _, jd, _ = je.step(js, jnp.asarray(a))
        ts, tobs, _, td, _ = te.step_fn(ts, torch.from_numpy(a))
        assert np.array_equal(np.asarray(jd), td.numpy()), k
        np.testing.assert_allclose(ts.pitch.numpy(), np.asarray(js.pitch), atol=ATOL, err_msg=f"pitch@{k}")
        check(jobs, tobs, k)
        tilted += int((np.abs(np.asarray(js.pitch)) > 0.1).sum())
        ts = dataclasses.replace(ts, **{f: torch.from_numpy(np.array(getattr(js, f)))
                                        for f in ("pos", "yaw", "pitch", "prev_pos")})
    return tilted


def _close(jobs, tobs, keys, k):
    for key in keys:
        got, ref = tobs[key], np.asarray(jobs[key])
        assert tuple(got.shape) == ref.shape and str(got.dtype).split(".")[-1] == str(ref.dtype), (key, k)
        np.testing.assert_allclose(got.double().numpy(), ref.astype(np.float64), rtol=0, atol=ATOL,
                                   err_msg=f"{key}@{k}")


def test_objectnav_env_sensors_match():
    jcfg = jax_get_config("benchmark/nav/objectnav/objectnav_procgen.yaml", OBJECTNAV_32)
    tcfg = get_config("benchmark/nav/objectnav/objectnav_procgen.yaml", OBJECTNAV_32)
    je, te = jcons.env_from_config(jcfg, num_envs=2), tcons.env_from_config(tcfg, num_envs=2, device="cpu")
    assert te.action_names == je.action_names and te.num_actions == je.action_space.n == 6
    assert set(te.observation_shapes) == set(je.observation_space.spaces) == {
        "rgb", "depth", "semantic", "objectgoal", "compass", "gps"}

    def check(jobs, tobs, k):
        _close(jobs, tobs, ("objectgoal", "compass", "gps"), k)
        assert (tobs["objectgoal"] >= 0).all()
        np.testing.assert_allclose(tobs["depth"].numpy(), np.asarray(jobs["depth"]), atol=1e-4,
                                   err_msg=f"depth@{k}")
        _frames_agree(jobs["rgb"], tobs["rgb"], f"rgb@{k}")
        _frames_agree(jobs["semantic"], tobs["semantic"], f"semantic@{k}")

    assert _teacher_forced(je, te, check) >= 6


def test_imagenav_env_sensors_match():
    jcfg = jax_get_config("benchmark/nav/imagenav/imagenav_procgen.yaml", IMAGENAV_32)
    tcfg = get_config("benchmark/nav/imagenav/imagenav_procgen.yaml", IMAGENAV_32)
    je, te = jcons.env_from_config(jcfg, num_envs=2), tcons.env_from_config(tcfg, num_envs=2, device="cpu")
    assert te.observation_shapes["imagegoal"] == ((32, 32, 3), torch.uint8)
    starts = []

    def check(jobs, tobs, k):
        _frames_agree(jobs["imagegoal"], tobs["imagegoal"], f"imagegoal@{k}")
        _frames_agree(jobs["rgb"], tobs["rgb"], f"rgb@{k}")
        starts.append(tobs["imagegoal"].clone())
        # the goal view is not the start view (tests/test_tasks.py:43-64)
        assert k >= 0 or not torch.equal(tobs["imagegoal"], tobs["rgb"])

    _teacher_forced(je, te, check, steps=[[1, 1], [2, 3], [1, 2]])
    # constant within an episode (no env's episode ended)
    assert all(torch.equal(g, starts[0]) for g in starts)


def test_more_nav_sensors_match(pointnav_both):
    """PointGoal, Heading, Proximity, the instance-image goal and its HFOV,
    with look_up/look_down, on hand-built envs."""
    (sj, ej, fj), (st, et, ft) = pointnav_both
    specs = (
        ("PointGoalSensor", None),
        ("HeadingSensor", None),
        ("ProximitySensor", {"max_detection_radius": 1.0}),
        ("InstanceImageGoalSensor", {"height": 32, "width": 32}),
        ("InstanceImageGoalHFOVSensor", None),
        ("CompassSensor", None),
        ("GPSSensor", {"dimensionality": 3}),
    )
    actions = ("StopAction", "MoveForwardAction", "TurnLeftAction", "TurnRightAction", "LookUpAction",
               "LookDownAction")
    kw = dict(num_envs=2, sensor_specs=specs, action_names=actions, goal_image_size=32, max_episode_steps=50)
    je = jax_make_nav_env(sj, ej, precomputed_fields=fj, **kw)
    te = make_nav_env(st, et, precomputed_fields=ft, device="cpu", **kw)
    keys = ("pointgoal", "heading", "proximity", "instance_imagegoal_hfov", "compass", "gps")
    assert set(te.observation_shapes) == set(keys) | {"instance_imagegoal"}

    def check(jobs, tobs, k):
        _close(jobs, tobs, keys, k)
        _frames_agree(jobs["instance_imagegoal"], tobs["instance_imagegoal"], f"instance_imagegoal@{k}")
        assert (tobs["proximity"] <= 1.0).all() and (tobs["instance_imagegoal_hfov"] == 90.0).all()

    _teacher_forced(je, te, check)


@pytest.mark.parametrize("goal_format,dims", [("POLAR", 2), ("POLAR", 3), ("CARTESIAN", 2), ("CARTESIAN", 3)])
def test_pointgoal_forms_match(goal_format, dims):
    rng = np.random.default_rng(dims)
    src, goal = rng.normal(0, 3, (2, 16, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    ref = np.asarray(jnav._pointgoal_obs(jnp.asarray(src), jnp.asarray(yaw), jnp.asarray(goal), goal_format, dims))
    got = tnav._pointgoal_obs(torch.from_numpy(src), torch.from_numpy(yaw), torch.from_numpy(goal), goal_format, dims)
    assert tuple(got.shape) == ref.shape == (16, dims)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=ATOL)


def test_image_goal_size_mismatch_raises(pointnav_both):
    """As the JAX package asserts: a goal sensor whose size the table was
    not rendered at."""
    (sj, ej, fj), (st, et, ft) = pointnav_both
    kw = dict(num_envs=2, sensor_specs=(("ImageGoalSensor", {"height": 16, "width": 16}),), goal_image_size=32)
    with pytest.raises(AssertionError, match="goal_image_size"):
        jax_make_nav_env(sj, ej, precomputed_fields=fj, **kw).reset(seed=0)
    with pytest.raises(ValueError, match="goal_image_size"):
        make_nav_env(st, et, precomputed_fields=ft, device="cpu", **kw)


@pytest.mark.parametrize("name,kind", [
    ("TopDownMap", "measure"), ("RuntimePerfStats", "measure"), ("GfxReplayMeasure", "measure"),
    ("TeleportAction", "task_action"), ("VelocityAction", "task_action"),
])
def test_host_measures_and_actions_registered(name, kind):
    """Registered under the JAX names, built with the same uuid (measures,
    both host-side) or action name and settings as the JAX package's."""
    from habitat_torch.core.registry import registry

    cfg = {"lin_vel_range": [0.0, 0.5], "min_abs_ang_speed": 2.0}
    j = getattr(jcons.registry, f"get_{kind}")(name)(cfg)
    t = getattr(registry, f"get_{kind}")(name)(cfg)
    if kind == "measure":
        assert (t.uuid, t.host_side) == (j.uuid, j.host_side) and t.host_side
    else:
        assert t.name == j.name
        assert {k: v for k, v in vars(t).items() if k != "config"} == {
            k: v for k, v in vars(j).items() if k != "config"}
