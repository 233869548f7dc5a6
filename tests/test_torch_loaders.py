"""habitat_torch's scene loaders and episode datasets on disk against
habitat_tpu's, on tests/assets/mini_dataset/ (the reference's on-disk
layout: a scene dataset config, a 66-triangle glb stage and 8 PointNav-v1
episodes).

- ``load_scene`` of the glb: triangles, colors, semantic ids, bounds and
  the navgrid (occupancy, obstacle distance, origin) equal to JAX's; the
  same after a save -> load round trip through npz, glb and gltf (+ .bin),
  each package reading its own file, and through a hand-written .obj.
- A textured gltf (tests/test_scene.py:117's two triangles over a PNG
  atlas, written by PIL): the port decodes the PNG without PIL
  (``loaders.decode_png``) and bakes JAX's colors; the decoder undoes each
  of the five PNG row filters (hand-filtered rows) and reads grey, grey +
  alpha, palette and RGBA images as PIL does; a JPEG gives None.
- ``resolve_scene_dataset`` on the mini config: the same stage path, the
  same error for an unknown id.
- ``PointNavDatasetV1``: the 8 episodes equal field by field, and
  ``to_json`` reads back to the same episodes and equals JAX's string.
- ``load_dataset`` with ``type: PointNav-v1`` and the mini ``data_path``
  (and an ObjectNav-v1 file naming the same stage): the same scenes and
  episodes as JAX's; the port keys each scene by the id its episodes name
  (the JAX package keys it by its file name).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.core import construct as jcons
from habitat_tpu.datasets import object_nav as jon
from habitat_tpu.datasets.pointnav import PointNavDatasetV1 as JaxPointNav
from habitat_tpu.sims import loaders as jload

from habitat_torch.config.default import get_config
from habitat_torch.core import construct as tcons
from habitat_torch.datasets.pointnav import PointNavDatasetV1
from habitat_torch.datasets.registration import make_dataset
from habitat_torch.sims import loaders as tload
from tests.torch_jax_native import _jax_native  # noqa: F401


ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
MINI = os.path.join(ROOT, "mini_dataset")
GLB = os.path.join(MINI, "stages", "mini_room_0.glb")
SCENE_CONFIG = os.path.join(MINI, "mini.scene_dataset_config.json")
DATA_PATH = os.path.join(MINI, "pointnav", "v1", "{split}", "{split}.json.gz")
ON_DISK = ["habitat.dataset.type=PointNav-v1", "habitat.dataset.split=val",
           f"habitat.dataset.data_path={DATA_PATH}", f"habitat.dataset.scenes_dir={ROOT}"]
CFG = "benchmark/nav/pointnav/pointnav_procgen.yaml"


class _DatasetConfig:
    data_path = DATA_PATH
    split = "val"
    content_scenes = ["*"]


def _same_scene(t, j):
    for name in ("vertices", "colors", "semantic_ids", "nav_occ", "obst_dist", "nav_lo"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert (t.nav_res, t.floor_y) == (j.nav_res, j.floor_y)
    for a, b in zip(t.bounds(), j.bounds()):
        np.testing.assert_array_equal(a, b)


def test_load_glb_matches_jax():
    t, j = tload.load_scene(GLB), jload.load_scene(GLB)
    assert t.scene_id == j.scene_id == "mini_room_0.glb"
    assert t.num_triangles == 66 and t.nav_occ.shape == (85, 85)
    _same_scene(t, j)


@pytest.mark.parametrize("fmt", ["npz", "glb", "gltf"])
def test_save_load_round_trip_matches_jax(fmt, tmp_path):
    """Each package writes the mini room in ``fmt`` and reads its own file."""
    scenes = []
    for pkg, load in (("t", tload), ("j", jload)):
        path = str(tmp_path / f"{pkg}_room.{fmt}")
        getattr(load, f"save_scene_{fmt}")(load.load_scene(GLB), path)
        scenes.append(load.load_scene(path))
    _same_scene(*scenes)
    np.testing.assert_array_equal(scenes[0].vertices, tload.load_scene(GLB).vertices)


def test_obj_scene_matches_jax(tmp_path):
    """A quad floor and one wall box face, fan-triangulated."""
    path = tmp_path / "room.obj"
    path.write_text("v 0 0 0\nv 4 0 0\nv 4 0 4\nv 0 0 4\nv 2 0 0\nv 2 2 0\nv 2 2 4\nv 2 0 4\n"
                    "f 1 2 3 4\nf 5/1 6/1 7/1 8/1\n")
    t, j = tload.load_scene(str(path)), jload.load_scene(str(path))
    assert t.num_triangles == 4
    _same_scene(t, j)


def test_resolve_scene_dataset_matches_jax():
    sid = "mini_dataset/stages/mini_room_0.glb"
    got = tload.resolve_scene_dataset(SCENE_CONFIG, sid)
    assert got == jload.resolve_scene_dataset(SCENE_CONFIG, sid) and os.path.samefile(got, GLB)
    assert tload.resolve_scene_dataset(SCENE_CONFIG, GLB) == GLB  # an existing path passes through
    for load in (tload, jload):
        with pytest.raises(FileNotFoundError, match="not found in dataset"):
            load.resolve_scene_dataset(SCENE_CONFIG, "stages/other_room.glb")


def test_pointnav_v1_matches_jax():
    t, j = PointNavDatasetV1(_DatasetConfig()), JaxPointNav(_DatasetConfig())
    assert len(t.episodes) == len(j.episodes) == 8
    for et, ej in zip(t.episodes, j.episodes):
        assert (et.episode_id, et.scene_id, et.start_position, et.start_rotation, et.info) == (
            ej.episode_id, ej.scene_id, ej.start_position, ej.start_rotation, ej.info)
        assert [dataclasses.astuple(g) for g in et.goals] == [dataclasses.astuple(g) for g in ej.goals]
        assert et.start_yaw == ej.start_yaw
    text = t.to_json()
    assert text == j.to_json()
    again = PointNavDatasetV1()
    again.from_json(text)
    assert again.episodes == t.episodes
    assert t.scene_ids == j.scene_ids == ["mini_dataset/stages/mini_room_0.glb"]
    assert type(make_dataset("PointNav-v1")) is PointNavDatasetV1


def test_load_dataset_on_disk_matches_jax():
    (st, et, ft) = tcons.load_dataset(get_config(CFG, ON_DISK).habitat.dataset)
    (sj, ej, fj) = jcons.load_dataset(jax_get_config(CFG, ON_DISK).habitat.dataset)
    assert ft is None and fj is None
    assert [e.episode_id for e in et] == [e.episode_id for e in ej] == [str(i) for i in range(8)]
    assert [e.start_position for e in et] == [e.start_position for e in ej]
    assert len(st) == len(sj) == 1
    _same_scene(st[0], sj[0])
    # the port keys the scene by the id its episodes name
    assert st[0].scene_id == et[0].scene_id == "mini_dataset/stages/mini_room_0.glb"
    assert sj[0].scene_id == "mini_room_0.glb"


def test_objectnav_file_on_disk_matches_jax(tmp_path):
    """An ObjectNav-v1 file whose episodes stand in the mini room."""
    path = tmp_path / "val.json"
    path.write_text(json.dumps({
        "category_to_task_category_id": {"chair": 3},
        "goals_by_category": {"mini_room_0.glb_chair": [
            {"position": [4.7, 0.0, 1.3], "radius": 1.0, "object_id": 7, "object_category": "chair"}]},
        "episodes": [{"episode_id": str(i), "scene_id": "mini_dataset/stages/mini_room_0.glb",
                      "start_position": [5.7 - 0.5 * i, 0.0, 5.7], "start_rotation": [0, 0, 0, 1],
                      "object_category": "chair"} for i in range(3)],
    }))
    over = ["habitat.dataset.type=ObjectNav-v1", f"habitat.dataset.data_path={path}",
            f"habitat.dataset.scenes_dir={ROOT}"]
    ocfg = "benchmark/nav/objectnav/objectnav_procgen.yaml"
    (st, et, _), (sj, ej, _) = (tcons.load_dataset(get_config(ocfg, over).habitat.dataset),
                                jcons.load_dataset(jax_get_config(ocfg, over).habitat.dataset))
    assert [(e.episode_id, e.info, e.object_category, len(e.goals)) for e in et] == [
        (e.episode_id, e.info, e.object_category, len(e.goals)) for e in ej]
    assert et[0].info["object_category_id"] == 3 and isinstance(ej[0], jon.ObjectGoalNavEpisode)
    _same_scene(st[0], sj[0])
    env = tcons.env_from_config(get_config(ocfg, over + [
        f"habitat.simulator.agents.main_agent.sim_sensors.{s}_sensor.{d}=16"
        for s in ("rgb", "depth", "semantic") for d in ("width", "height")]), num_envs=2, device="cpu")
    _, obs = env.reset_fn()
    assert obs["objectgoal"].tolist() == [[3], [3]] and obs["depth"].shape == (2, 16, 16, 1)


def _texture_gltf(path):
    """tests/test_scene.py:117's asset: left half red, right half green."""
    from PIL import Image

    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4, 0] = 255
    tex[:, 4:, 1] = 255
    Image.fromarray(tex).save(os.path.join(path, "atlas.png"))
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [2, 0, 0], [3, 0, 0], [2, 0, 1]], np.float32)
    uv = np.array([[0.0, 0.5], [0.2, 0.5], [0.1, 0.4], [0.8, 0.5], [0.9, 0.5], [0.85, 0.4]], np.float32)
    blob = pos.tobytes() + uv.tobytes()
    with open(os.path.join(path, "mesh.bin"), "wb") as f:
        f.write(blob)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "material": 0, "mode": 4}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}], "images": [{"uri": "atlas.png"}],
        "buffers": [{"uri": "mesh.bin", "byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
                        {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": uv.nbytes}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3", "min": [0, 0, 0],
                       "max": [3, 0, 1]},
                      {"bufferView": 1, "componentType": 5126, "count": 6, "type": "VEC2"}],
    }
    with open(os.path.join(path, "mesh.gltf"), "w") as f:
        json.dump(gltf, f)
    return os.path.join(path, "mesh.gltf")


def _png(pixels, ctype, filters, palette=None):
    """A PNG of (H, W*C) uint8 rows, row y filtered with filters[y]."""
    import struct
    import zlib

    h, wc = pixels.shape
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    x = pixels.astype(np.int64)
    rows = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(wc, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        f = filters[y % len(filters)]
        if f == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        else:
            pred = [np.zeros(wc, np.int64), left, up, (left + up) // 2][f]
        rows.append(bytes([f]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", wc // c, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


def test_textured_gltf_and_png_decoder(tmp_path):
    import io

    from PIL import Image

    path = _texture_gltf(str(tmp_path))
    got, want = tload.load_scene(path), jload.load_scene(path)
    np.testing.assert_array_equal(got.colors, want.colors)
    np.testing.assert_allclose(got.colors[0], [1.0, 0.0, 0.0], atol=1e-2)
    np.testing.assert_allclose(got.colors[1], [0.0, 1.0, 0.0], atol=1e-2)
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (7, 9 * 3), dtype=np.uint8)
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        np.testing.assert_array_equal(tload.decode_png(_png(rgb, 2, filters)), rgb.reshape(7, 9, 3) / np.float32(255))
    for mode in ("L", "LA", "P", "RGBA"):
        im = Image.fromarray(rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)).convert(mode)
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        np.testing.assert_array_equal(tload.decode_png(buf.getvalue()),
                                      np.asarray(im.convert("RGB"), np.float32) / 255.0, err_msg=mode)
    buf = io.BytesIO()
    Image.fromarray(rgb.reshape(7, 9, 3)).save(buf, format="JPEG")
    assert tload.decode_png(buf.getvalue()) is None
