"""habitat_torch's receptacles and episode samplers against habitat_tpu's on
the CPU: the receptacle cases of tests/test_receptacles_mocap.py and every
case of tests/test_samplers.py, each run through both packages from the
same seeds. The samplers are host numpy with the same RNG calls in the same
order, so every sample is held equal (exact), and the generator's tables
bit for bit.
"""

import numpy as np
import pytest

from habitat_tpu.sims import receptacles as jrec
from habitat_tpu.sims.procedural import generate_apartment as j_apartment
from habitat_tpu.tasks.rearrange import generator as jgen
from habitat_tpu.tasks.rearrange import samplers as jsam

from habitat_torch.sims import receptacles as trec
from habitat_torch.sims.procedural import generate_apartment as t_apartment
from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.tasks.rearrange import samplers as tsam
from tests.torch_jax_native import _jax_native  # noqa: F401


def test_aabb_receptacle_samples_on_top():
    r, jr = trec.AABBReceptacle("r", lo=(0, 0, 0), hi=(2, 1, 3)), jrec.AABBReceptacle("r", lo=(0, 0, 0), hi=(2, 1, 3))
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        p = r.sample_uniform_global(rng)
        assert 0 <= p[0] <= 2 and 0 <= p[2] <= 3 and p[1] == pytest.approx(1.0)
        np.testing.assert_array_equal(p, jr.sample_uniform_global(jrng))
    assert r.total_area == pytest.approx(6.0) == jr.total_area
    assert [b.tolist() for b in r.bounds] == [b.tolist() for b in jr.bounds]


def test_triangle_mesh_receptacle_area_weighted():
    """A tiny and a big triangle in the y=0 plane: 200 samples, equal in
    both packages, >95% on the big one, inside the triangles."""
    tris = np.array([[[0, 0, 0], [0.1, 0, 0], [0, 0, 0.1]], [[5, 0, 5], [15, 0, 5], [5, 0, 15]]], np.float32)
    r, jr = trec.TriangleMeshReceptacle("tm", tris), jrec.TriangleMeshReceptacle("tm", tris)
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    pts = np.stack([r.sample_uniform_local(rng) for _ in range(200)])
    np.testing.assert_array_equal(pts, np.stack([jr.sample_uniform_local(jrng) for _ in range(200)]))
    assert (pts[:, 0] > 1).mean() > 0.95 and np.allclose(pts[:, 1], 0)
    assert (pts[:, 0] + pts[:, 2] <= 20 + 1e-4).all()
    assert r.total_area == jr.total_area
    assert [b.tolist() for b in r.bounds] == [b.tolist() for b in jr.bounds]
    with pytest.raises(ValueError):
        trec.TriangleMeshReceptacle("flat", np.zeros((1, 3, 3), np.float32))


@pytest.mark.parametrize("seed,n_clutter,rooms", [(7, 12, 2), (0, 3, 1), (2, 3, 1), (5, 0, 1)])
def test_find_receptacles_procedural_scene(seed, n_clutter, rooms):
    """The port's apartment annotates its objects as the JAX one does; the
    same receptacles come out; 20 samples equal, each on an object's top
    face 5 cm up (None in both where the scene has no receptacle)."""
    js = j_apartment(seed=seed, n_clutter=n_clutter, n_rooms_per_axis=rooms)
    ts = t_apartment(seed=seed, n_clutter=n_clutter, n_rooms_per_axis=rooms)
    assert ts.objects == js.objects and ts.regions == js.regions
    got, ref = trec.find_receptacles(ts), jrec.find_receptacles(js)
    assert [(r.name, r.parent_object_handle, r.lo.tolist(), r.hi.tolist()) for r in got] == [
        (r.name, r.parent_object_handle, r.lo.tolist(), r.hi.tolist()) for r in ref]
    assert (len(got) > 0) == (n_clutter > 0)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(20):
        p, q = trec.sample_on_receptacle(ts, rng), jrec.sample_on_receptacle(js, jrng)
        if not got:
            assert p is None and q is None
            continue
        np.testing.assert_array_equal(p, q)
        assert p.shape == (3,) and any(
            abs(p[1] - (c[1] + s[1] / 2) - 0.05) < 1e-4 and abs(p[0] - c[0]) <= s[0] / 2 and abs(p[2] - c[2]) <= s[2] / 2
            for c, s in ((np.asarray(o["center"]), np.asarray(o["size"])) for o in ts.objects))
    tables = trec.ReceptacleSet("tables", included_object_substrings=("table",))
    p = trec.sample_on_receptacle(ts, rng, recep_set=tables)
    q = jrec.sample_on_receptacle(js, jrng, recep_set=jrec.ReceptacleSet("tables", ("table",)))
    assert (p is None) == (q is None) and (p is None or np.array_equal(p, q))


def test_receptacle_set_and_tracker():
    rs = trec.ReceptacleSet("tables", included_object_substrings=("table",))
    receps = [trec.AABBReceptacle("receptacle_aabb_table_4", (0, 0, 0), (1, 1, 1)),
              trec.AABBReceptacle("receptacle_aabb_shelf_5", (0, 0, 0), (1, 1, 1))]
    assert [r.name for r in rs.filter(receps)] == ["receptacle_aabb_table_4"]
    no_tables = trec.ReceptacleSet("rest", excluded_object_substrings=("table",))
    assert [r.name for r in no_tables.filter(receps)] == ["receptacle_aabb_shelf_5"]
    tracker = trec.ReceptacleTracker({"receptacle_aabb_table_4": 1}, {"tables": rs})
    assert tracker.allocate("receptacle_aabb_table_4")
    assert not tracker.allocate("receptacle_aabb_table_4")  # consumed
    assert tracker.allocate("receptacle_aabb_shelf_5")  # untracked: unlimited


def test_scene_samplers():
    assert tsam.SingleSceneSampler("a").sample() == "a"
    ms, jms = tsam.MultiSceneSampler(["a", "b", "b", "c"], seed=0), jsam.MultiSceneSampler(["a", "b", "b", "c"], seed=0)
    assert ms.num_scenes() == 3
    assert [ms.sample() for _ in range(10)] == [jms.sample() for _ in range(10)]
    bs = tsam.BalancedSceneSampler(["a", "b"], num_episodes=4)
    seq = []
    for i in range(4):
        bs.set_cur_episode(i)
        seq.append(bs.sample())
    assert seq == ["a", "a", "b", "b"]
    with pytest.raises(ValueError):
        tsam.BalancedSceneSampler(["a", "b"], num_episodes=3)


@pytest.mark.parametrize("use_receptacles", [True, False])
def test_object_and_target_samplers(use_receptacles):
    """The JAX test's apartment and samplers in both packages from one seed:
    the same placements and targets, with its separation rules."""
    js = j_apartment(seed=1, n_rooms_per_axis=1, n_clutter=2)
    ts = t_apartment(seed=1, n_rooms_per_axis=1, n_clutter=2)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    kw = dict(num_objects=(2, 3), min_separation=0.3, use_receptacles=use_receptacles)
    placements = tsam.ObjectSampler(["cup", "bowl"], **kw).sample(ts, rng)
    assert placements == jsam.ObjectSampler(["cup", "bowl"], **kw).sample(js, jrng)
    assert 2 <= len(placements) <= 3
    pts = [np.asarray(p) for _, p, _ in placements]
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            assert np.linalg.norm(pts[i] - pts[j]) >= 0.3
    targets = tsam.ObjectTargetSampler(["cup"], use_receptacles=False).sample_targets(ts, placements, 2, rng)
    assert targets == jsam.ObjectTargetSampler(["cup"], use_receptacles=False).sample_targets(js, placements, 2, jrng)
    assert len(targets) == 2
    for name, goal in targets.items():
        src = next(p for n, p, _ in placements if n == name)
        assert np.linalg.norm(np.asarray(goal) - np.asarray(src)) >= 0.5


def test_art_state_samplers_and_generator_integration():
    """The JAX test's samplers, then the generator with an AO state sampler:
    the same ao_states, and the same tables, whose art_init_q are the
    sampled states."""
    aos = [tsam.ArtObjSpec("kitchen_drawer_left", ("drawer_0",), ((0.0, 0.45),)),
           tsam.ArtObjSpec("fridge_a", ("door",), ((0.0, 2.0),))]
    jaos = [jsam.ArtObjSpec("kitchen_drawer_left", ("drawer_0",), ((0.0, 0.45),)),
            jsam.ArtObjSpec("fridge_a", ("door",), ((0.0, 2.0),))]
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for cls in ("ArticulatedObjectStateSampler", "ArtObjCatStateSampler"):
        out = getattr(tsam, cls)("drawer", "drawer_0", (0.1, 0.3)).sample(aos, rng)
        assert out == getattr(jsam, cls)("drawer", "drawer_0", (0.1, 0.3)).sample(jaos, jrng)
        assert list(out) == ["kitchen_drawer_left"] and 0.1 <= out["kitchen_drawer_left"]["drawer_0"] <= 0.3
    clipped = tsam.ArticulatedObjectStateSampler("fridge", "door", (1.5, 3.0)).sample(aos, rng)
    assert clipped == jsam.ArticulatedObjectStateSampler("fridge", "door", (1.5, 3.0)).sample(jaos, jrng)
    assert clipped["fridge_a"]["door"] <= 2.0
    configs = [{"fridge_a": {"door": 1.5}}, {"fridge_a": {"door": 0.0}, "missing": {"x": 1.0}}]
    for _ in range(6):
        out2 = tsam.CompositeArticulatedObjectStateSampler(configs).sample(aos, rng)
        assert out2 == jsam.CompositeArticulatedObjectStateSampler(configs).sample(jaos, jrng)
        assert set(out2) <= {"fridge_a"}
    with pytest.raises(ValueError):
        tsam.ArticulatedObjectStateSampler("d", "l", (0.3, 0.1))

    gen = dict(num_scenes=1, episodes_per_scene=8, seed=2, n_rooms_per_axis=1, n_clutter=0)
    scenes, eps = tgen.make_procedural_rearrange(
        **gen, ao_state_sampler=tsam.ArticulatedObjectStateSampler("drawer", "drawer_0", (0.05, 0.25)),
        art_objs=[tsam.ArtObjSpec("drawer_main", ("drawer_0",), ((0.0, 0.45),))])
    jscenes, jeps = jgen.make_procedural_rearrange(
        **gen, ao_state_sampler=jsam.ArticulatedObjectStateSampler("drawer", "drawer_0", (0.05, 0.25)),
        art_objs=[jsam.ArtObjSpec("drawer_main", ("drawer_0",), ((0.0, 0.45),))])
    assert all(ep.ao_states for ep in eps)
    assert [(e.rigid_objs, e.targets, e.ao_states) for e in eps] == [(e.rigid_objs, e.targets, e.ao_states) for e in jeps]
    index = {s.scene_id: i for i, s in enumerate(scenes)}
    table = tgen.build_rearrange_table(eps, {s.scene_id: s for s in scenes}, index)
    jtable = jgen.build_rearrange_table(jeps, {s.scene_id: s for s in jscenes}, index)
    q = table.art_init_q.numpy()
    assert np.array_equal(q, np.asarray(jtable.art_init_q))
    assert (q >= 0.05 - 1e-6).all() and (q <= 0.25 + 1e-6).all() and np.unique(q.round(4)).size > 1
    # without art_objs each scene's default drawer_<s> matches the handle
    _, eps = tgen.make_procedural_rearrange(
        **gen, ao_state_sampler=tsam.ArticulatedObjectStateSampler("drawer", "drawer_0", (0.05, 0.25)))
    assert all(list(ep.ao_states) == ["drawer_0"] for ep in eps)
