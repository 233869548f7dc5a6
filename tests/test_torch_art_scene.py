"""habitat_torch's articulated scenes against habitat_tpu's on the CPU:
receptacle goals, sampled articulated-object states, URDF-defined
articulated objects and RearrangeDataset-v0 files.

- Episodes of ``make_procedural_rearrange(use_receptacles=True,
  ao_state_sampler=...)``: every field equal (the same numpy draws in the
  same order), and their tables bit for bit, with the URDF cabinet
  (``build_rearrange_table(art_asset=...)``) and with revolute URDFs whose
  door box sits off the hinge and on it (the x fallback).
- ``load_articulated_object`` / ``resolve_articulated_objects``: every field
  equal on tests/assets/mini_dataset.
- The URDF open env (tests/test_urdf_artobj.py's configuration at N=4):
  the reset, and 32 steps of the scripted opener from beside the handles
  teacher-forced against
  JAX's jitted reset and step, at tests/test_torch_rearrange_env.py's
  tolerances (floats within 1e-5, discrete fields equal); then the JAX
  test's rule on the port alone: some env opens the drawer past 0.36 m
  within 200 steps.
- ``RearrangeDatasetV0.from_json``: the same JSON text (4x4 and 3-vector
  transforms) gives the same episodes; a ``.json.gz`` through the
  registry's config path.
"""

import dataclasses
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.sims import loaders as jl
from habitat_tpu.tasks.rearrange import generator as jgen
from habitat_tpu.tasks.rearrange import rearrange_env as jre
from habitat_tpu.tasks.rearrange import samplers as jsam

from habitat_torch.core.registry import registry
from habitat_torch.sims import loaders as tl
from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.tasks.rearrange import samplers as tsam
from habitat_torch.tasks.rearrange.art_scene import opener_action
from tests.test_torch_rearrange_env import _assert_tables_equal, _compare, to_port_state
from tests.torch_jax_native import _jax_native  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "assets", "mini_dataset")
CFG = os.path.join(ROOT, "mini.scene_dataset_config.json")
URDF = os.path.join(ROOT, "urdf", "kitchen_cabinet.urdf")
N = 4
OPEN_ENV = dict(num_envs=N, task="open", with_visual=False, max_episode_steps=200, n_rooms_per_axis=1, n_clutter=0,
                seed=4)
OPEN_STEPS = 32
EPISODE_FIELDS = ("episode_id", "scene_id", "start_position", "start_rotation", "info", "rigid_objs", "targets",
                  "markers", "ao_states")

# a fridge: the door's box 0.3 m off its hinge, or centred on it
REVOLUTE_URDF = """<?xml version="1.0"?>
<robot name="fridge">
  <link name="body"><collision><origin xyz="0 0.8 0"/><geometry><box size="0.7 1.6 0.6"/></geometry></collision></link>
  <link name="door"><visual><origin xyz="{door}"/><geometry><box size="0.6 1.5 0.04"/></geometry></visual></link>
  <link name="shelf"><collision><geometry><box size="0.5 0.02 0.5"/></geometry></collision></link>
  <joint name="fix_shelf" type="fixed"><parent link="body"/><child link="shelf"/><origin xyz="0 0.5 0"/></joint>
  <joint name="door_hinge" type="revolute"><parent link="shelf"/><child link="door"/>
    <origin xyz="0.35 0.3 0.3"/><axis xyz="0 1 0"/><limit lower="0" upper="{upper}"/></joint>
</robot>
"""


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _episodes(gen, sam, **kw):
    return gen.make_procedural_rearrange(
        num_scenes=3, episodes_per_scene=6, seed=1, n_rooms_per_axis=1, n_clutter=3, use_receptacles=True,
        ao_state_sampler=sam.ArticulatedObjectStateSampler("drawer", "drawer_0", (0.05, 0.3)),
        art_objs=[sam.ArtObjSpec("drawer_main", ("drawer_0",), ((0.0, 0.45),))], **kw)


@pytest.fixture(scope="module")
def episodes():
    return _episodes(jgen, jsam), _episodes(tgen, tsam)


def _asset_fields(a):
    return (a.name, a.urdf_path, a.base_box_half.tolist(), a.base_box_center.tolist(),
            [(j.name, j.joint_type, j.axis.tolist(), j.origin.tolist(), j.lower, j.upper, j.child_link,
              j.box_half.tolist(), j.box_center.tolist()) for j in a.joints])


def test_receptacle_and_ao_episodes_match(episodes):
    (sj, ej), (st, et) = episodes
    assert [s.scene_id for s in sj] == [s.scene_id for s in st] and len(ej) == len(et) == 18
    for a, b in zip(ej, et):
        for f in EPISODE_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.episode_id, f)
    # receptacle goals sit 5 cm above an annotated object's top
    tops = {s.scene_id: [o["center"][1] + o["size"][1] / 2 + 0.05 for o in s.objects] for s in st}
    on_recep = sum(any(abs(g[1] - h) < 1e-4 for h in tops[e.scene_id]) for e in et for g in e.targets.values())
    assert on_recep > 6 and all(0.05 <= e.ao_states["drawer_main"]["drawer_0"] <= 0.3 for e in et)


def test_load_articulated_object_matches():
    assert tl.resolve_articulated_objects(CFG) == jl.resolve_articulated_objects(CFG)
    urdf = tl.resolve_articulated_objects(CFG)["kitchen_cabinet"]
    asset = tl.load_articulated_object(urdf)
    assert _asset_fields(asset) == _asset_fields(jl.load_articulated_object(urdf))
    j = asset.primary
    assert (j.joint_type, j.name, j.lower, j.upper) == ("prismatic", "drawer_top_slide", 0.0, 0.42)
    np.testing.assert_allclose(j.origin, [0.05, 0.62, 0.0])
    np.testing.assert_allclose(j.box_half, [0.25, 0.09, 0.22])
    np.testing.assert_allclose(asset.base_box_half, [0.3, 0.4, 0.25])


@pytest.mark.parametrize("asset", ["cabinet", "door_off_hinge", "door_on_hinge", "procedural_revolute"])
def test_art_tables_match(episodes, asset, tmp_path):
    """The episodes' tables: every field bit for bit; art_init_q is each
    episode's sampled state, art_goal_q the URDF's upper limit (1.5 / 0.35
    without a limit or an asset)."""
    (sj, ej), (st, et) = episodes
    kw, goal = {}, 0.42
    if asset == "cabinet":
        kw = dict(art_asset=(jl.load_articulated_object(URDF), tl.load_articulated_object(URDF)))
    elif asset.startswith("door"):
        path = tmp_path / "fridge.urdf"
        on_hinge = asset == "door_on_hinge"
        path.write_text(REVOLUTE_URDF.format(door="0 0 0" if on_hinge else "-0.3 0 0.02",
                                             upper="0" if on_hinge else "1.2"))
        kw = dict(art_asset=(jl.load_articulated_object(str(path)), tl.load_articulated_object(str(path))))
        goal = 1.5 if on_hinge else 1.2
        assert kw["art_asset"][1].primary.origin.tolist() == pytest.approx([0.35, 0.8, 0.3])
    else:
        kw = dict(art_joint=("revolute", "revolute"))
        goal = 1.5
    index = {s.scene_id: i for i, s in enumerate(sj)}
    jt = jgen.build_rearrange_table(ej, {s.scene_id: s for s in sj}, index, **{k: v[0] for k, v in kw.items()})
    tt = tgen.build_rearrange_table(et, {s.scene_id: s for s in st}, index, device="cpu",
                                    **{k: v[1] for k, v in kw.items()})
    _assert_tables_equal(jt, tt)
    q = np.array([e.ao_states["drawer_main"]["drawer_0"] for e in et], np.float32)
    assert np.array_equal(tt.art_init_q.numpy(), q)
    assert np.allclose(tt.art_goal_q.numpy(), goal)
    assert tt.art_is_revolute.all() == (asset != "cabinet")
    axis = tt.art_axis.numpy()[:, 0]
    np.testing.assert_allclose(np.linalg.norm(axis, axis=-1), 1.0, atol=1e-6)
    assert (axis[:, 1] == 0).all()


def test_urdf_without_movable_joint_raises(tmp_path):
    path = tmp_path / "block.urdf"
    path.write_text('<robot name="block"><link name="a"/><link name="b"/>'
                    '<joint name="j" type="fixed"><parent link="a"/><child link="b"/></joint></robot>')
    with pytest.raises(ValueError, match="no movable"):
        tl.load_articulated_object(str(path))


def _opener(handle, pos, yaw):
    """tests/test_urdf_artobj.py's scripted opener in numpy, for the JAX
    env: turn to the handle, drive to it, pull when within 0.8 m."""
    d = handle - pos
    dist = np.linalg.norm(d[:, [0, 2]], axis=-1)
    ang_world = np.arctan2(-d[:, 0], -d[:, 2])
    ang = np.arctan2(np.sin(ang_world - yaw), np.cos(ang_world - yaw))
    act = np.where(np.abs(ang) < np.deg2rad(12), jre.A_FWD, np.where(ang > 0, jre.A_LEFT, jre.A_RIGHT))
    return np.where(dist < 0.8, jre.A_GRAB, act).astype(np.int32)


@pytest.fixture(scope="module")
def open_envs():
    je = jgen.make_rearrange_env(art_urdf=URDF, **OPEN_ENV)
    te = tgen.make_rearrange_env(art_urdf=URDF, device="cpu", **OPEN_ENV)
    return je, te


def test_urdf_open_env_matches_jax(open_envs):
    """The reset, then 32 teacher-forced steps of the scripted opener from
    0.4 m beside each handle."""
    je, te = open_envs
    _assert_tables_equal(je.table, te.table)
    assert np.allclose(te.table.art_goal_q.numpy()[te.table.art_init_q.numpy() == 0.0], 0.42)
    assert not te.table.art_is_revolute.any()
    js, jo = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    ts, to = te.reset_fn()
    assert set(jo) == set(to)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=1e-5, err_msg=k)
    for f in dataclasses.fields(ts):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)), atol=1e-5,
                                   err_msg=f.name)
    jstep, jhandle = jax.jit(je.step_fn), jax.jit(je._handle_pos)
    # start beside the handle (as tests/test_torch_rearrange_env.py's handle
    # runs do), so that the 32 steps pull the drawers
    h = np.asarray(jhandle(js))
    js = dataclasses.replace(js, pos=jnp.asarray(np.c_[h[:, 0] + 0.4, np.asarray(js.pos)[:, 1], h[:, 2]]))
    q0 = np.asarray(js.art_q).copy()
    for _ in range(OPEN_STEPS):
        a = _opener(np.asarray(jhandle(js)), np.asarray(js.pos), np.asarray(js.yaw))
        jout = jstep(js, jnp.asarray(a))
        _compare(jout, te.step_fn(to_port_state(js), torch.as_tensor(a)))
        js = jout[0]
    assert np.abs(np.asarray(js.art_q) - q0).max() > 0.05, "the opener never moved a drawer in 32 steps"


def test_urdf_drawer_opens_on_the_port(open_envs):
    """tests/test_urdf_artobj.py's rule, on the port alone with its own
    opener (art_scene.opener_action): some env reaches
    art_obj_at_desired_state within 200 steps, past the procedural 0.35."""
    _, te = open_envs
    st, _ = te.reset_fn()
    info = {}
    for _ in range(200):
        st, _, _, _, info = te.step_fn(st, opener_action(te, st))
        if (info["art_obj_at_desired_state"] > 0).any():
            break
    assert (info["art_obj_at_desired_state"] > 0).any(), "no env opened the URDF drawer"
    assert info["art_obj_state"].max() > 0.36


DATASET = {"episodes": [
    {"episode_id": 7, "scene_id": "procgen/apartment_3", "start_position": [1.0, 0.0, 2.0],
     "start_rotation": [0, 0.38268343, 0, 0.92387953], "info": {"art_task": "close"},
     "rigid_objs": [["obj_0", [[1, 0, 0, 0.5], [0, 1, 0, 0.0], [0, 0, 1, -1.25], [0, 0, 0, 1]]],
                    ["obj_1", [2.0, 0.1, 3.0]]],
     "targets": {"obj_0": [[0, 0, 1, 3.5], [0, 1, 0, 0.8], [-1, 0, 0, 1.5], [0, 0, 0, 1]]},
     "markers": [{"name": "handle", "position": [1.5, 0.6, 0.5]}],
     "ao_states": {"drawer_main": {"drawer_0": 0.2}}},
    {"episode_id": "x", "scene_id": "procgen/apartment_4", "targets": {"obj_0": [0.1, 0.0, 0.2]}},
]}


def test_rearrange_dataset_from_json(tmp_path):
    text = json.dumps(DATASET)
    ours, ref = tgen.RearrangeDatasetV0(), jgen.RearrangeDatasetV0()
    ours.from_json(text)
    ref.from_json(text)
    assert len(ours.episodes) == len(ref.episodes) == 2
    for a, b in zip(ours.episodes, ref.episodes):
        for f in EPISODE_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    assert ours.episodes[0].rigid_objs == [("obj_0", [0.5, 0.0, -1.25]), ("obj_1", [2.0, 0.1, 3.0])]
    assert ours.episodes[0].targets == {"obj_0": [3.5, 0.8, 1.5]}
    # a .json.gz named by a config through the registry
    path = tmp_path / "val.json.gz"
    with gzip.open(path, "wt") as f:
        f.write(text)
    cfg = type("Cfg", (), dict(data_path=str(tmp_path / "{split}.json.gz"), split="val"))()
    loaded = registry.get_dataset("RearrangeDataset-v0")(cfg)
    assert isinstance(loaded, tgen.RearrangeDatasetV0)
    assert [e.episode_id for e in loaded.episodes] == ["7", "x"] and loaded.scene_ids == sorted(
        ["procgen/apartment_3", "procgen/apartment_4"])
    # the file's episodes build a table (markers place the articulated object)
    from habitat_torch.sims.procedural import generate_apartment

    scenes = {f"procgen/apartment_{s}": generate_apartment(seed=s) for s in (3, 4)}
    table = tgen.build_rearrange_table(loaded.episodes, scenes, {k: i for i, k in enumerate(scenes)}, device="cpu")
    assert table.art_pos[0, 0].tolist() == pytest.approx([1.5, 0.6, 0.5])
    assert table.art_init_q[0].item() == pytest.approx(0.2) and table.art_goal_q[0].item() == 0.0
