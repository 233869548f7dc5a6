"""habitat_torch's sim utilities, kinematic relationships and object states
against habitat_tpu's on the CPU: every case of tests/test_sim_utilities.py
but the debug visualizer, each run through both packages on the same numpy
inputs.

- Host predicates, link helpers, receptacle matching, the relationship graph
  and the state machine: the same answers (exact; floats from the same
  numpy arithmetic, equal).
- ``generate_empty_room``: vertices, colours, semantics and navgrid equal.
- ``raycast_rays`` (the port's closest-hit oracle) and ``snap_down_raycast``:
  the same triangle on every ray, t within 1e-5 (float32 Möller–Trumbore in
  another operation order).
- The batched forms (``batched_within`` / ``batched_ontop``,
  ``apply_relations`` / ``apply_relations_rotating``, ``set_state``): torch
  against jax.numpy on random inputs, booleans equal, positions within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.ops import raycast as jrc
from habitat_tpu.sims import kinematic_relationship_manager as jkrm
from habitat_tpu.sims import object_state_machine as josm
from habitat_tpu.sims import sim_utilities as jsu
from habitat_tpu.sims.procedural import generate_empty_room as j_empty_room
from habitat_tpu.sims.receptacles import AABBReceptacle as JAABB

from habitat_torch.ops import raycast as trc
from habitat_torch.sims import kinematic_relationship_manager as tkrm
from habitat_torch.sims import object_state_machine as tosm
from habitat_torch.sims import sim_utilities as tsu
from habitat_torch.sims.procedural import generate_empty_room as t_empty_room
from habitat_torch.sims.receptacles import AABBReceptacle as TAABB
from tests.torch_jax_native import _jax_native  # noqa: F401

POS_ATOL = 1e-6
T_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rooms():
    return j_empty_room(extent=6.0), t_empty_room(extent=6.0)


def _boxes(rng, n):
    """n (center, size) pairs, half of them stacked on the one before."""
    out = []
    for i in range(n):
        s = rng.uniform(0.1, 1.0, 3)
        c = rng.uniform(-1.0, 1.0, 3)
        if i % 2 and out:
            pc, ps = out[-1]
            c = np.array([pc[0] + rng.uniform(-0.2, 0.2), pc[1] + ps[1] / 2 + s[1] / 2 + rng.uniform(-0.03, 0.03),
                          pc[2] + rng.uniform(-0.2, 0.2)])
        out.append((c, s))
    return out


def test_spatial_predicates():
    """The JAX test's boxes, then every ordered pair of 24 random boxes
    (half stacked) and 200 points, through both packages."""
    b_c, b_s = [0, 0.25, 0], [1.0, 0.5, 1.0]
    a_c, a_s = [0.1, 0.6, 0.1], [0.2, 0.2, 0.2]
    assert tsu.above(a_c, a_s, b_c, b_s) and tsu.ontop(a_c, a_s, b_c, b_s)
    assert not tsu.ontop(b_c, b_s, a_c, a_s)
    assert tsu.within([0, 0.3, 0], b_c, b_s) and not tsu.within([2, 0.3, 0], b_c, b_s)
    assert tsu.object_in_region([0.5, 0, 0.5], [0, -1, 0], [1, 1, 1])
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 24)
    counts = {"above": 0, "ontop": 0}
    for i, (ca, sa) in enumerate(boxes):
        for j, (cb, sb) in enumerate(boxes):
            if i == j:
                continue
            for name in ("above", "ontop"):
                got = getattr(tsu, name)(ca, sa, cb, sb)
                assert got == getattr(jsu, name)(ca, sa, cb, sb), (name, i, j)
                counts[name] += got
            assert tsu.within(ca, cb, sb) == jsu.within(ca, cb, sb)
            lo_a, hi_a = tsu.aabb(ca, sa)
            lo_b, hi_b = tsu.aabb(cb, sb)
            assert tsu.aabb_overlap(lo_a, hi_a, lo_b, hi_b) == jsu.aabb_overlap(lo_a, hi_a, lo_b, hi_b)
        np.testing.assert_array_equal(tsu.get_global_keypoints(ca, sa), jsu.get_global_keypoints(ca, sa))
    assert counts["ontop"] > 0 and counts["above"] > counts["ontop"] - 1
    for p in rng.uniform(-1.5, 1.5, (200, 3)):
        assert tsu.object_in_region(p, [-1, -1, -1], [1, 0.5, 1]) == jsu.object_in_region(p, [-1, -1, -1], [1, 0.5, 1])


def test_batched_predicates():
    """batched_within / batched_ontop on 256 random rows: torch against jax.numpy."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    lo, hi = np.float32([-0.5, 0.0, -0.5]), rng.uniform(0.0, 0.8, (256, 3)).astype(np.float32)
    got = tsu.batched_within(torch.as_tensor(pts), torch.as_tensor(lo), torch.as_tensor(hi)).numpy()
    ref = np.asarray(jsu.batched_within(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    assert np.array_equal(got, ref) and 0 < got.sum() < 256
    assert tsu.batched_within(torch.tensor([[0.0, 0.3, 0.0], [5.0, 0.0, 0.0]]), torch.tensor([-0.5, 0.0, -0.5]),
                              torch.tensor([0.5, 0.5, 0.5])).tolist() == [True, False]
    boxes = _boxes(rng, 257)
    c = np.stack([b[0] for b in boxes]).astype(np.float32)
    s = np.stack([b[1] for b in boxes]).astype(np.float32)
    args = (c[1:], s[1:], c[:-1], s[:-1])
    got = tsu.batched_ontop(*map(torch.as_tensor, args)).numpy()
    ref = np.asarray(jsu.batched_ontop(*map(jnp.asarray, args)))
    assert np.array_equal(got, ref) and got.any()


def test_empty_room_matches(rooms):
    j, t = rooms
    for f in ("vertices", "colors", "semantic_ids", "nav_occ", "obst_dist", "nav_lo"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    assert (j.scene_id, j.nav_res, j.floor_y) == (t.scene_id, t.nav_res, t.floor_y)


def test_snap_down_and_on_floor(rooms):
    """The JAX test's cases, then 64 random drops, in both packages."""
    j, t = rooms
    c = tsu.snap_down(t, [3.0, 1.0, 3.0], [0.2, 0.3, 0.2])
    assert c is not None and abs(c[1] - (t.floor_y + 0.15)) < 1e-6
    assert tsu.on_floor(t, c, [0.2, 0.3, 0.2])
    assert tsu.snap_down(t, [-2.0, 1.0, 3.0], [0.2, 0.3, 0.2]) is None
    rng = np.random.default_rng(2)
    landed = 0
    for _ in range(64):
        c = rng.uniform([-1.0, -0.5, -1.0], [7.0, 3.0, 7.0])
        s = rng.uniform(0.1, 0.6, 3)
        got, ref = tsu.snap_down(t, c, s), jsu.snap_down(j, c, s)
        assert (got is None) == (ref is None)
        if got is not None:
            landed += 1
            np.testing.assert_array_equal(got, ref)
            assert tsu.on_floor(t, got, s) == jsu.on_floor(j, ref, s)
        assert tsu.on_floor(t, c, s) == jsu.on_floor(j, c, s)
        assert t.is_navigable(c) == j.is_navigable(c)
    assert landed > 5


def test_link_state_helpers():
    lo, hi = 0.0, 0.5
    assert tsu.link_is_closed(0.02, lo, hi) and not tsu.link_is_open(0.02, lo, hi) and tsu.link_is_open(0.3, lo, hi)
    assert tsu.open_link(lo, hi) == 0.5 and tsu.close_link(lo, hi) == 0.0
    assert abs(tsu.get_link_normalized_joint_position(0.25, lo, hi) - 0.5) < 1e-9
    assert abs(tsu.set_link_normalized_joint_position(0.5, lo, hi) - 0.25) < 1e-9
    for q in np.linspace(-0.2, 0.8, 41):
        for name in ("link_is_open", "link_is_closed"):
            assert getattr(tsu, name)(q, lo, hi) == getattr(jsu, name)(q, lo, hi)
        assert tsu.get_link_normalized_joint_position(q, lo, hi) == jsu.get_link_normalized_joint_position(q, lo, hi)
        assert tsu.set_link_normalized_joint_position(q, lo, hi) == jsu.set_link_normalized_joint_position(q, lo, hi)


def _floor_and_boxes(rng, n_boxes=6):
    """A 10 m floor quad at y=0 and ``n_boxes`` axis-aligned boxes on it,
    padded to 128 triangles: (v0, e1, e2, valid) float32."""
    tris = [[[-5, 0, -5], [5, 0, -5], [5, 0, 5]], [[-5, 0, -5], [5, 0, 5], [-5, 0, 5]]]
    for _ in range(n_boxes):
        c = rng.uniform(-3, 3, 2)
        h, w = rng.uniform(0.2, 1.0), rng.uniform(0.3, 0.8)
        x0, x1, z0, z1 = c[0] - w, c[0] + w, c[1] - w, c[1] + w
        tris += [[[x0, h, z0], [x1, h, z0], [x1, h, z1]], [[x0, h, z0], [x1, h, z1], [x0, h, z1]]]
    tri = np.zeros((128, 3, 3), np.float32)
    tri[: len(tris)] = tris
    valid = np.zeros(128, np.float32)
    valid[: len(tris)] = 1.0
    return tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], valid


def test_raycast_rays_matches():
    """The closest-hit oracle on 512 random rays against a floor and boxes."""
    rng = np.random.default_rng(3)
    v0, e1, e2, valid = _floor_and_boxes(rng)
    o = rng.uniform([-4, 0.1, -4], [4, 3.0, 4], (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_ref, i_ref = (np.asarray(x) for x in jrc.raycast_rays(*map(jnp.asarray, (v0, e1, e2)),
                                                            jnp.asarray(valid).astype(bool), jnp.asarray(o),
                                                            jnp.asarray(d)))
    t, i = trc.raycast_rays(*map(torch.as_tensor, (v0, e1, e2)), torch.as_tensor(valid).bool(),
                            torch.as_tensor(o), torch.as_tensor(d))
    assert np.array_equal(i.numpy(), i_ref) and (i_ref >= 0).mean() > 0.5
    np.testing.assert_allclose(t.numpy(), t_ref, atol=T_ATOL, rtol=0)


def test_snap_down_raycast():
    """The JAX test's floor (rest at 0.1, None from 5 m), then 12 drops onto
    a floor with boxes, in both packages (the JAX function traces its scan
    at every call, ~0.35 s)."""
    v = np.array([[[-5, 0, -5], [5, 0, -5], [5, 0, 5]], [[-5, 0, -5], [5, 0, 5], [-5, 0, 5]]], np.float32)
    tri = np.concatenate([v, np.zeros((126, 3, 3), np.float32)])
    valid = np.zeros((128,), np.float32)
    valid[:2] = 1.0
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    out = tsu.snap_down_raycast(v0, e1, e2, valid, [0.0, 1.0, 0.0], [0.2, 0.2, 0.2])
    assert out is not None and abs(out[1] - 0.1) < 1e-3
    assert tsu.snap_down_raycast(v0, e1, e2, valid, [0.0, 5.0, 0.0], [0.2, 0.2, 0.2], max_drop=2.0) is None
    rng = np.random.default_rng(4)
    geo = _floor_and_boxes(rng)
    rested = 0
    for _ in range(12):
        c, s = rng.uniform([-4, 0.5, -4], [4, 4.0, 4]), rng.uniform(0.1, 0.5, 3)
        got, ref = tsu.snap_down_raycast(*geo, c, s), jsu.snap_down_raycast(*geo, c, s)
        assert (got is None) == (ref is None)
        if got is not None:
            rested += 1
            np.testing.assert_allclose(got, ref, atol=T_ATOL, rtol=0)
    assert rested > 3


def test_receptacle_matching():
    """The JAX test's table and shelf, then 200 random objects against 6
    receptacles: the same matches, confidences equal."""
    def both(name, lo, hi):
        return TAABB(name, lo=lo, hi=hi), JAABB(name, lo=lo, hi=hi)

    (tt, jt), (ts, js) = both("table", [0, 0.7, 0], [1, 0.75, 1]), both("shelf", [3, 1.0, 3], [4, 1.05, 4])
    assert tsu.get_obj_receptacle_matches([0.5, 0.8, 0.5], [0.1] * 3, [tt, ts])[0][0] == "table"
    assert tsu.find_receptacle_for_object([0.5, 0.8, 0.5], [0.1] * 3, [tt, ts]) == "table"
    assert tsu.find_receptacle_for_object([9, 9, 9], [0.1] * 3, [tt, ts]) is None
    rng = np.random.default_rng(5)
    lows = rng.uniform(-2, 2, (6, 3))
    pairs = [both(f"r{k}", lo, lo + rng.uniform(0.3, 1.5, 3)) for k, lo in enumerate(lows)]
    t_recs, j_recs = [p[0] for p in pairs], [p[1] for p in pairs]
    matched = 0
    for k in range(200):
        lo, hi = t_recs[k % 6].bounds
        c, s = (lo + hi) / 2 + rng.uniform(-1.0, 1.0, 3) * (hi - lo), rng.uniform(0.05, 0.4, 3)
        got = tsu.get_obj_receptacle_matches(c, s, t_recs)
        assert got == jsu.get_obj_receptacle_matches(c, s, j_recs)
        assert tsu.find_receptacle_for_object(c, s, t_recs) == jsu.find_receptacle_for_object(c, s, j_recs)
        matched += bool(got)
    assert 20 < matched < 190


def test_object_state_machine():
    """The JAX test's specs, machine, update loop and channels in both packages."""
    for m in (tosm, josm):
        specs = [m.BooleanObjectState("is_clean", default_value=False)]
        osm = m.ObjectStateMachine(specs)
        osm.register_object("cup", semantic_class=0)
        assert osm.get_state("cup", "is_clean") is False
        osm.set_state("cup", "is_clean", True)
        assert osm.get_snapshot_dict()["is_clean"]["cup"] is True
        assert specs[0].toggle(osm, "cup") is False
        m.set_state_of_obj(osm, "cup", "is_clean", True)
        assert m.get_state_of_obj(osm, "cup", "is_clean") is True
        assert m.get_state_of_obj(osm, "missing", "is_clean") is None

        class Discharges(m.BooleanObjectState):
            def __init__(self):
                super().__init__(name="is_powered_on", default_value=True)

            def update_state(self, sim, handle, value, dt):
                return value and dt < 1.0

        osm2 = m.ObjectStateMachine([Discharges(), m.ObjectIsClean()])
        osm2.initialize_object_state_map([("tv", 0), ("lamp", 3)])
        osm2.update_states(dt=0.1)
        assert osm2.get_state("tv", "is_powered_on") is True
        osm2.update_states(dt=2.0)
        assert osm2.get_state("tv", "is_powered_on") is False
        assert m.ObjectIsPoweredOn().default_value is False
        assert specs[0].draw_state(True) == (0, 255, 0)
    spec = tosm.ObjectStateSpec("is_open", accepted_semantic_classes=(2,))
    assert spec.is_affordance_of(2) and not spec.is_affordance_of(1)


def test_state_channels_match():
    """init_state_channels + set_state at N=64, O=5: torch against jax.numpy."""
    rng = np.random.default_rng(6)
    specs_t = [tosm.BooleanObjectState("is_clean"), tosm.ObjectIsPoweredOn(), tosm.BooleanObjectState("on", True)]
    specs_j = [josm.BooleanObjectState("is_clean"), josm.ObjectIsPoweredOn(), josm.BooleanObjectState("on", True)]
    ch_t, ch_j = tosm.init_state_channels(specs_t, 64, 5, device="cpu"), josm.init_state_channels(specs_j, 64, 5)
    for name, value in (("is_clean", True), ("on", False), ("is_clean", False), ("is_powered_on", True)):
        mask, idx = rng.random(64) < 0.5, rng.integers(0, 5, 64)
        ch_t = tosm.set_state(ch_t, name, torch.as_tensor(mask), torch.as_tensor(idx), value)
        ch_j = josm.set_state(ch_j, name, jnp.asarray(mask), jnp.asarray(idx), value)
    assert set(ch_t) == set(ch_j)
    for k in ch_t:
        assert ch_t[k].dtype == torch.bool and np.array_equal(ch_t[k].numpy(), np.asarray(ch_j[k])), k
    ch = tosm.init_state_channels(specs_t[:1], 3, 2, device="cpu")
    ch = tosm.set_state(ch, "is_clean", torch.tensor([True, False, True]), torch.tensor([0, 0, 1]), True)["is_clean"]
    assert ch[0, 0] and not ch[1, 0] and ch[2, 1]


def test_kinematic_relationships():
    """The JAX test's stack (inferred ontop, parent moves, child follows) in both packages."""
    centers = np.array([[0, 0.25, 0], [0, 0.6, 0], [3, 0.25, 3]])
    sizes = np.array([[1, 0.5, 1], [0.2, 0.2, 0.2], [1, 0.5, 1]])
    krm = tkrm.KinematicRelationshipManager(3)
    krm.initialize_from_obj_state(centers, sizes)
    jk = jkrm.KinematicRelationshipManager(3)
    jk.initialize_from_obj_state(centers, sizes)
    assert krm.relationship_graph.get_parent(1) == 0 and krm.relationship_graph.get_children(0) == [1]
    assert krm.get_relations_snapshot() == jk.get_relations_snapshot()
    delta = np.zeros((1, 3, 3), np.float32)
    delta[0, 0] = [1.0, 0.0, 0.0]
    new = krm.apply_relations(torch.as_tensor(centers, dtype=torch.float32)[None], torch.as_tensor(delta))[0].numpy()
    np.testing.assert_allclose(new[1], centers[1] + [1, 0, 0], atol=POS_ATOL)
    np.testing.assert_allclose(new[2], centers[2], atol=POS_ATOL)
    ref = np.asarray(jk.apply_relations(jnp.asarray(centers, jnp.float32)[None], jnp.asarray(delta)))[0]
    np.testing.assert_allclose(new, ref, atol=POS_ATOL)


def test_krm_snapshots_and_rotation():
    """The JAX test's chain (a turning, moving parent swings its child and
    grandchild), the forest dump, detaching, and the rotating batched form."""
    centers = np.array([[0.0, 0, 0], [1.0, 0, 0], [1.5, 0, 0]])
    new = np.array(centers, copy=True)
    new[0] = [0.0, 0.0, 2.0]
    yaws = [np.pi / 2, 0.0, 0.0]
    outs = []
    for m in (tkrm, jkrm):
        krm = m.KinematicRelationshipManager(3)
        krm.relationship_graph.add_relation(0, 1, "ontop")
        krm.relationship_graph.add_relation(1, 2, "within")
        krm.update_snapshots(centers, [0.0, 0.0, 0.0])
        out = krm.apply_relationships_snapshot(new, yaws)
        np.testing.assert_allclose(out[1], [0.0, 0.0, 1.0], atol=POS_ATOL)
        np.testing.assert_allclose(out[2], [0.0, 0.0, 0.5], atol=POS_ATOL)
        assert krm.get_relations_snapshot() == {0: {1: "ontop"}, 1: {2: "within"}}
        forest = krm.relationship_graph.get_human_readable_relationship_forest({0: "table", 1: "tray", 2: "cup"})
        assert forest[0] == "- table" and "[within]" in forest[2]
        outs.append((out, forest))
        krm.relationship_graph.remove_obj_relations(1)
        assert krm.relationship_graph.get_parent(1) is None and krm.relationship_graph.get_children(1) == []
        krm.relationship_graph.add_relation(2, 0)
        krm.relationship_graph.add_relation(1, 0, "within")  # re-parents 0
        assert krm.relationship_graph.get_parent(0) == 1 and krm.relationship_graph.get_root_parents() == [1]
        assert list(krm.relationship_graph.to_parent_array(3)) == [1, -1, -1]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    out_b = tkrm.apply_relations_rotating(*(torch.as_tensor(x, dtype=torch.float32)[None] for x in (centers, [-1, 0, -1])),
                                          torch.as_tensor(centers, dtype=torch.float32)[None],
                                          torch.as_tensor(new, dtype=torch.float32)[None],
                                          torch.tensor([[np.pi / 2, 0.0, 0.0]]))[0].numpy()
    np.testing.assert_allclose(out_b[1], [0.0, 0.0, 1.0], atol=POS_ATOL)
    with pytest.raises(ValueError):
        tkrm.RelationshipGraph().add_relation(1, 1)


def test_batched_relations_match():
    """apply_relations (chains of 3) and apply_relations_rotating at N=32,
    O=6 on random parents: torch against jax.numpy."""
    rng = np.random.default_rng(7)
    N, O = 32, 6
    parent = np.where(rng.random((N, O)) < 0.5, rng.integers(0, O, (N, O)), -1)
    parent[np.arange(O)[None].repeat(N, 0) == parent] = -1
    pos, delta = rng.normal(size=(N, O, 3)).astype(np.float32), rng.normal(size=(N, O, 3)).astype(np.float32)
    got = tkrm.apply_relations(torch.as_tensor(pos), torch.as_tensor(parent), torch.as_tensor(delta), iterations=3)
    ref = jkrm.apply_relations(jnp.asarray(pos), jnp.asarray(parent), jnp.asarray(delta), iterations=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POS_ATOL)
    prev, nxt = rng.normal(size=(N, O, 3)).astype(np.float32), rng.normal(size=(N, O, 3)).astype(np.float32)
    dyaw = rng.uniform(-np.pi, np.pi, (N, O)).astype(np.float32)
    got = tkrm.apply_relations_rotating(*map(torch.as_tensor, (pos, parent, prev, nxt, dyaw)))
    ref = jkrm.apply_relations_rotating(*map(jnp.asarray, (pos, parent, prev, nxt, dyaw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POS_ATOL)
