"""habitat_torch's single-env simulator and the modules around it against
habitat_tpu's on the CPU.

- ``TpuSim(device="cpu")`` beside the JAX ``TpuSim`` on the procedural
  apartment (128x128 depth + RGB): reset poses equal; a fixed action
  sequence (forward into a wall and along it, turns, look up and down,
  ``teleport`` with a rotation, ``velocity_control``) gives equal poses and
  collision flags at every step, and frames held to the frame rule of
  tests/test_torch_raycast.py (depth within 1e-4, RGB and semantic ids
  equal on >= 99.9% of pixels); ``get_observations_at`` leaves the pose.
- The JAX tests' rules on the port (tests/test_env_api.py:120-150): the
  ``ShortestPathFollower`` stops at a sampled goal within 300 steps and
  0.6 m, and geodesic >= Euclidean - 0.15. ``geodesic_distance``,
  ``island_radius``, ``distance_to_closest_obstacle`` and
  ``get_straight_shortest_path_points`` equal JAX's.
- ``render_env`` equals the N=1 ``render_batch`` and JAX's ``render_env``
  (the frame rule) at tests/test_scene.py's 32x32.
- ``navgrid.sample_navigable_point`` is bit-equal to JAX's jitted one for
  256 keys, at 32 tries and at 2 (21 of the keys then take the snap).
- ``to_grid``, ``from_grid`` and ``get_topdown_map_from_sim`` equal JAX's.
- ``DebugVisualizer`` at tests/test_sim_utilities.py:119's 48x48: ``peek``
  of an AABB subject with debug lines and circles, of a centre/size
  subject on all axes and of the scene, held to JAX's by the frame rule
  (the overlays drawn where the frames agree); ``project_point``,
  ``draw_object_highlight`` and ``stitch_image_matrix`` equal; the image
  of ``get_observation`` held to JAX's by the frame rule, ``show_point``
  and ``save`` on it, and ``make_debug_video`` writing the single-view
  frames as a GIF (tests/test_torch_video.py holds the encoders).
- ``build_semantic_scene`` field by field against JAX's on
  tests/test_scene.py:186's apartment, with that test's rules.
- ``core/simulator.py``'s suite and the lazy exports of ``habitat_torch``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.ops import navgrid as jng
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.sims import debug_visualizer as jdbv
from habitat_tpu.sims import procedural as jproc
from habitat_tpu.sims import semantic_scene as jsem
from habitat_tpu.sims import tpu_sim as jsim
from habitat_tpu.sims.scene import pack_scenes as jpack
from habitat_tpu.utils.visualizations import maps as jmaps

from habitat_torch.ops import navgrid as tng
from habitat_torch.ops import raycast as trc
from habitat_torch.sims import debug_visualizer as tdbv
from habitat_torch.sims import procedural as tproc
from habitat_torch.sims import semantic_scene as tsem
from habitat_torch.sims import tpu_sim as tsim
from habitat_torch.sims.scene import pack_scenes as tpack
from habitat_torch.utils import threefry
from habitat_torch.utils.visualizations import maps as tmaps


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames_agree(want, got, what=""):
    """The frame rule: equal shapes and dtypes, depth within 1e-4, RGB and
    semantic ids equal on >= 99.9% of pixels."""
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
    assert np.abs(np.asarray(want["depth"]) - _np(got["depth"])).max() <= 1e-4, what
    assert (np.asarray(want["rgb"]) == _np(got["rgb"])).all(-1).mean() >= 0.999, what
    assert (np.asarray(want["semantic"]) == _np(got["semantic"])).mean() >= 0.999, what


def _np(x):
    return x.numpy() if torch.is_tensor(x) else x


def _small_cfg(size=32):
    sensors = {"depth_sensor": {"type": "HabitatSimDepthSensor", "height": size, "width": size},
               "rgb_sensor": {"type": "HabitatSimRGBSensor", "height": size, "width": size}}
    return types.SimpleNamespace(scene="procedural", forward_step_size=0.25, turn_angle=10, tilt_angle=15,
                                 agents_order=["main_agent"],
                                 agents={"main_agent": types.SimpleNamespace(sim_sensors=sensors)})


@pytest.fixture(scope="module")
def sims():
    return jsim.TpuSim(None), tsim.TpuSim(None, device="cpu")


TELEPORT = dict(action="teleport", action_args=dict(position=[3.0, 0.0, 3.0],
                                                    rotation=[0.0, float(np.sin(0.3)), 0.0, float(np.cos(0.3))]))
VELOCITY = dict(action="velocity_control", action_args=dict(lin_vel=0.5, ang_vel=20.0, time_step=0.5))
ACTIONS = [1] * 10 + [2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 4, 5, 5, 3, "move_forward", TELEPORT] + [VELOCITY] * 4


def test_sim_matches_jax(sims):
    js, ts = sims
    js.seed(0), ts.seed(0)
    _frames_agree(js.reset(), ts.reset(), "reset")
    np.testing.assert_array_equal(ts._pos, js._pos)
    assert ts._yaw == js._yaw and ts._pitch == js._pitch == 0.0
    collided = []
    for i, a in enumerate(ACTIONS):
        want, got = js.step(a), ts.step(a)
        _frames_agree(want, got, f"step {i}")
        np.testing.assert_array_equal(ts._pos, js._pos, err_msg=f"step {i}")
        assert (ts._yaw, ts._pitch, ts.previous_step_collided()) == (js._yaw, js._pitch, js.previous_step_collided())
        collided.append(ts.previous_step_collided())
        st_j, st_t = js.get_agent_state(), ts.get_agent_state()
        np.testing.assert_array_equal(st_t.rotation, st_j.rotation)
    assert True in collided and False in collided[:10] + collided[-4:]
    rot = [0.0, float(np.sin(0.7)), 0.0, float(np.cos(0.7))]
    pose = (ts._pos.copy(), ts._yaw)
    _frames_agree(js.get_observations_at([4.0, 0.0, 5.0], rot), ts.get_observations_at([4.0, 0.0, 5.0], rot))
    np.testing.assert_array_equal(ts._pos, pose[0])
    assert ts._yaw == pose[1]
    assert ts.set_agent_state([4.0, 0.0, 5.0], rot) and js.set_agent_state([4.0, 0.0, 5.0], rot)
    assert ts._yaw == js._yaw


def test_pathfinder_queries_match_jax(sims):
    js, ts = sims
    js.seed(5), ts.seed(5)
    for _ in range(4):
        a, b = ts.sample_navigable_point(), ts.sample_navigable_point()
        assert a == js.sample_navigable_point() and b == js.sample_navigable_point()
        geo = ts.geodesic_distance(a, b)
        assert geo == js.geodesic_distance(a, b)
        euc = float(np.linalg.norm((np.asarray(a) - np.asarray(b))[[0, 2]]))
        assert euc - 0.15 <= geo < 100  # tests/test_env_api.py:141-150
        assert ts.geodesic_distance(a, [b, a]) == js.geodesic_distance(a, [b, a]) == 0.0
        assert ts.island_radius(a) == js.island_radius(a)
        assert ts.distance_to_closest_obstacle(b, 0.3) == js.distance_to_closest_obstacle(b, 0.3)
        assert ts.get_straight_shortest_path_points(a, b) == js.get_straight_shortest_path_points(a, b)
        assert ts.is_navigable(a) and js.is_navigable(a)
    assert ts.geodesic_distance([-50.0, 0.0, 0.0], b) == float("inf")


def test_follower_reaches_goal():
    """tests/test_env_api.py:120-138 on the port's sim and follower."""
    from habitat_torch.tasks.shortest_path_follower import ShortestPathFollower

    sim = tsim.TpuSim(_small_cfg(), device="cpu")
    sim.seed(3)
    sim.reset()
    goal = np.asarray(sim.sample_navigable_point())
    follower = ShortestPathFollower(sim, goal_radius=0.3, return_one_hot=False)
    reached = False
    for _ in range(300):
        a = follower.get_next_action(goal)
        if a == 0:
            reached = True
            break
        sim.step(a)
    assert reached
    assert np.linalg.norm((sim.get_agent_state().position - goal)[[0, 2]]) < 0.6


def test_registered_and_exported():
    import habitat_torch
    from habitat_torch.core.registry import registry
    from habitat_torch.core.simulator import SensorSuite, SensorTypes

    assert registry.get_simulator("Sim-v0") is tsim.TpuSim
    assert habitat_torch.Simulator is habitat_torch.core.simulator.Simulator
    assert habitat_torch.AgentState is habitat_torch.core.simulator.AgentState

    class Depth(habitat_torch.Sensor):
        def _get_uuid(self, *a, **k):
            return "depth"

        def _get_sensor_type(self, *a, **k):
            return SensorTypes.DEPTH

        def _get_observation_space(self, *a, **k):
            return ((4, 4, 1), torch.float32)

        def get_observation(self, *a, **k):
            return np.zeros((4, 4, 1), np.float32)

    suite = SensorSuite([Depth()])
    assert suite.observation_spaces == {"depth": ((4, 4, 1), torch.float32)}
    assert suite.get_observations()["depth"].shape == (4, 4, 1)
    with pytest.raises(AssertionError):
        SensorSuite([Depth(), Depth()])
    assert HabitatSimActions_ok()


def HabitatSimActions_ok():
    a = tsim.HabitatSimActions
    return [a.get(n) for n in ("stop", "move_forward", "turn_left", "turn_right", "look_up", "look_down")] == list(
        range(6)) and a.has_action("look_down") and not a.has_action("teleport")


def test_render_env_matches_render_batch():
    tp = tpack([tproc.generate_apartment(seed=1)])
    jp = jpack([jproc.generate_apartment(seed=1)])
    got = trc.render_env(tp, 0, [4.0, 1.25, 4.0], 0.4, -0.1, height=32, width=32)
    batch = trc.render_batch(tp, torch.zeros(1, dtype=torch.int64), torch.tensor([[4.0, 1.25, 4.0]]),
                             torch.tensor([0.4]), torch.tensor([-0.1]), height=32, width=32)
    for k, v in batch.items():
        assert torch.equal(got[k], v[0]), k
    want = jax.jit(lambda p: jrc.render_env(p, jnp.int32(0), jnp.array([4.0, 1.25, 4.0]), jnp.float32(0.4),
                                            jnp.float32(-0.1), height=32, width=32))(jp)
    _frames_agree(want, got)
    assert got["depth"].std() > 0.001


@pytest.mark.parametrize("n_tries", [32, 2])
def test_sample_navigable_point_matches_jax(n_tries):
    jp = jpack([jproc.generate_apartment(seed=0)])
    tp = tpack([tproc.generate_apartment(seed=0)])
    keys = threefry.fold_in(threefry.prng_key(7), np.arange(256))
    f = jax.jit(jax.vmap(lambda k: jng.sample_navigable_point(jp, jnp.int32(0), k, n_tries=n_tries)))
    want = np.asarray(f(jnp.asarray(keys)))
    got = tng.sample_navigable_point(tp, 0, keys, n_tries=n_tries)
    assert got.shape == (256, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    one = tng.sample_navigable_point(tp, 0, keys[3], n_tries=n_tries)
    np.testing.assert_array_equal(one.numpy(), want[3])
    # how many keys took the snap: none of their tries was navigable
    occ = tp.nav_occ[0].numpy()
    k = threefry.split(keys)
    tries = occ[threefry.randint(k[:, 0], (n_tries,), 0, occ.shape[0]), threefry.randint(k[:, 1], (n_tries,), 0,
                                                                                          occ.shape[1])]
    assert (~tries.any(1)).sum() == (0 if n_tries == 32 else 21)


def test_map_helpers_match_jax(sims):
    js, ts = sims
    rng = np.random.default_rng(2)
    lo, hi = (-3.5, 1.25), (7.0, 9.5)
    for x, y in rng.uniform(-4, 10, (50, 2)):
        args = ((64, 80), lo, hi)
        assert tmaps.to_grid(x, y, *args) == jmaps.to_grid(x, y, *args)
        gx, gy = tmaps.to_grid(x, y, *args)
        assert tmaps.from_grid(gx, gy, *args) == jmaps.from_grid(gx, gy, *args)
    for border in (True, False):
        np.testing.assert_array_equal(tmaps.get_topdown_map_from_sim(ts, draw_border=border),
                                      jmaps.get_topdown_map_from_sim(js, draw_border=border))


def _peeks(mod, dbv):
    lines = [([[2, 0.5, 2], [4, 0.5, 4]], (0, 255, 0))]
    circles = [([3, 0.5, 3], 0.5, [0, 1, 0], (255, 0, 0))]
    out = [dbv.peek(([2.0, 0.0, 2.0], [4.0, 1.0, 4.0]), debug_lines=lines, debug_circles=circles).obs_data,
           dbv.peek({"center": [3, 0.5, 3], "size": [1, 1, 1]}, peek_all_axis=True).obs_data,
           dbv.peek_scene()]
    dbv.look_at([3, 0, 3], look_from=[3, 2, 6])
    dbv.translate([0, 0, -0.5], local=True)
    dbv.rotate(d_yaw=0.1, d_pitch=-2.0)
    obs = dbv.render()
    hi = mod.draw_object_highlight(out[0], dbv.eye, dbv.yaw, dbv.pitch, [3, 0.5, 3])
    return out, obs, hi, (dbv.eye.copy(), dbv.yaw, dbv.pitch, len(dbv._frames))


def test_debug_visualizer_matches_jax(tmp_path):
    jd = jdbv.DebugVisualizer(jpack([jproc.generate_empty_room(extent=6.0)]), resolution=(48, 48))
    td = tdbv.DebugVisualizer(tpack([tproc.generate_empty_room(extent=6.0)]), resolution=(48, 48), device="cpu")
    (jp, jobs, jhi, jstate), (tp, tobs, thi, tstate) = _peeks(jdbv, jd), _peeks(tdbv, td)
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, i
        assert (a == b).all(-1).mean() >= 0.999, i
    assert tp[0].shape == (48, 48, 3) and tp[0].std() > 1.0 and tp[1].shape == (96, 144, 3)
    _frames_agree(jobs, tobs)
    assert (jhi == thi).all(-1).mean() >= 0.999
    np.testing.assert_array_equal(tstate[0], jstate[0])
    assert tstate[1:] == jstate[1:]
    for p in ([0, 1, -2], [1, 2, -3], [0, 1, 3]):
        for mod_args in ((0.0, 0.0), (0.3, -0.2)):
            a = tdbv.project_point([0, 1, 0], *mod_args, p)
            b = jdbv.project_point([0, 1, 0], *mod_args, p)
            assert (a is None and b is None) or np.array_equal(a, b)
    np.testing.assert_allclose(tdbv.project_point([0, 1, 0], 0.0, 0.0, [0, 1, -2]), [0.5, 0.5], atol=1e-6)
    frames = [tp[0], tp[2], tp[0]]
    np.testing.assert_array_equal(tdbv.stitch_image_matrix(frames, num_col=2),
                                  jdbv.stitch_image_matrix(frames, num_col=2))
    obs, jobs_ = td.get_observation(look_at=[3, 0.5, 3]), jd.get_observation(look_at=[3, 0.5, 3])
    img = obs.get_image()
    assert img.shape == (48, 48, 3) and img.dtype == np.uint8
    assert (img == np.asarray(jobs_.get_image())).all(-1).mean() >= 0.999
    obs.show_point(np.array([0.5, 0.5]))
    assert (obs.get_image() != img).any(-1).sum() > 0
    path = obs.save(str(tmp_path), "dbg")
    assert path.endswith(".png") and open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    td.make_debug_video(str(tmp_path))
    assert open(tmp_path / "dbv.gif", "rb").read(6) == b"GIF89a"


def _sem_fields(ss):
    box = lambda b: (tuple(b.center), tuple(b.sizes))  # noqa: E731
    return dict(
        levels=[(lv.id, box(lv.aabb), [r.id for r in lv.regions]) for lv in ss.levels],
        regions=[(r.id, r.category.index(), r.category.name(), box(r.aabb), r.level.id, [o.id for o in r.objects])
                 for r in ss.regions],
        objects=[(o.id, o.semantic_id, o.category.index(), o.category.name(), box(o.aabb), o.region.id)
                 for o in ss.objects],
        categories=[(c.index(), c.name()) for c in ss.categories],
        index=ss.semantic_index_map,
    )


def test_semantic_scene_matches_jax():
    ts = tproc.generate_apartment(seed=3, n_rooms_per_axis=2, n_clutter=5)
    ss = tsem.build_semantic_scene(ts)
    assert _sem_fields(ss) == _sem_fields(jsem.build_semantic_scene(
        jproc.generate_apartment(seed=3, n_rooms_per_axis=2, n_clutter=5)))
    # tests/test_scene.py:186's rules
    assert len(ss.levels) == 1 and len(ss.regions) == 4 and len(ss.objects) == 5
    for o in ss.objects:
        assert o.region is not None and o.region.aabb.contains(o.aabb.center)
        assert o.category.name() and o.id.startswith(o.region.id)
    o0 = ss.objects[0]
    assert ss.get_object(o0.semantic_id) is o0
    assert o0.region in ss.get_regions_for_point(o0.aabb.center)
    assert len(ss.levels[0].objects) == 5
    assert ss.regions[0].category.name() in ("living room", "kitchen", "bedroom", "bathroom", "hallway", "office",
                                             "dining room", "closet")
    sim = tsim.TpuSim(_small_cfg(), scene=ts, device="cpu")
    assert sim.semantic_annotations() is sim.semantic_scene
    assert len(sim.semantic_scene.objects) == 5
    # a scene without annotations: one whole-scene region
    empty = tsem.build_semantic_scene(tproc.generate_empty_room())
    assert _sem_fields(empty) == _sem_fields(jsem.build_semantic_scene(jproc.generate_empty_room()))
