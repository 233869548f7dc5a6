"""Scene asset loading (host, one-time): mesh files -> SceneData, and
articulated objects from URDF (port of ``habitat_tpu/sims/loaders.py``).

Reads:
- .obj (wavefront, triangulated on load)
- .glb / .gltf (embedded BIN, external buffers and data URIs: positions,
  indices, node transforms, COLOR_0, baseColorFactor, and baseColorTexture
  baked to per-triangle colors at centroid UVs; the JAX package decodes
  textures with PIL, the port decodes 8-bit PNG itself (``decode_png``,
  zlib) and bakes no other image format)
- .npz (the packed scene format: vertices (T,3,3), colors (T,3),
  semantic_ids (T,))

and writes .npz, .glb and .gltf (+ .bin); ``resolve_scene_dataset`` finds a
scene id through a habitat ``*.scene_dataset_config.json`` and
``resolve_articulated_objects`` lists its URDFs, which
``load_articulated_object`` reads. The navgrid is baked by
``sims/scene.py::rasterize_occupancy``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import List, Optional

import numpy as np

from habitat_torch.sims.scene import SceneData, rasterize_occupancy


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


def decode_png(raw: bytes) -> Optional[np.ndarray]:
    """(H, W, 3) float32 RGB in [0, 1] of an 8-bit, non-interlaced PNG
    (grey, RGB, palette, grey + alpha or RGBA; alpha dropped), or None for
    another format. The rows' filters are undone in numpy, per row."""
    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    at, idat, palette, head = 8, [], None, None
    while at + 8 <= len(raw):
        n, kind = struct.unpack(">I4s", raw[at:at + 8])
        body = raw[at + 8:at + 8 + n]
        at += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if head is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS or (ctype == 3 and palette is None):
        return None
    c = _PNG_CHANNELS[ctype]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, row = data[y, 0], data[y, 1:].astype(np.int32)
        if f == 1:  # Sub: running sum per channel
            row = np.cumsum(row.reshape(w, c), axis=0).reshape(-1)
        elif f == 2:  # Up
            row = row + prev
        elif f in (3, 4):  # Average, Paeth: each pixel after its left neighbour
            row = row.copy()
            for x in range(w * c):
                a = row[x - c] & 255 if x >= c else 0
                b = prev[x]
                if f == 3:
                    row[x] += (a + b) >> 1
                else:
                    cc = prev[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    row[x] += a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
        elif f != 0:
            raise ValueError(f"PNG filter {f}")
        out[y] = row & 255
        prev = out[y].astype(np.int32)
    px = out.reshape(h, w, c)
    if ctype == 3:
        rgb = palette[px[..., 0]]
    elif c <= 2:
        rgb = np.repeat(px[..., :1], 3, axis=-1)
    else:
        rgb = px[..., :3]
    return rgb.astype(np.float32) / 255.0


def save_scene_npz(scene: SceneData, path: str) -> None:
    np.savez_compressed(
        path,
        vertices=scene.vertices,
        colors=scene.colors,
        semantic_ids=scene.semantic_ids,
        scene_id=np.array(scene.scene_id),
    )


def _load_npz(path: str) -> SceneData:
    data = np.load(path, allow_pickle=False)
    return SceneData(
        scene_id=str(data["scene_id"]) if "scene_id" in data else os.path.basename(path),
        vertices=np.asarray(data["vertices"], np.float32),
        colors=np.asarray(data["colors"], np.float32),
        semantic_ids=np.asarray(data["semantic_ids"], np.int32),
    )


def _load_obj(path: str) -> SceneData:
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[i], idx[i + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    tris = v[f]  # (T,3,3)
    colors = np.full((len(tris), 3), 0.6, np.float32)
    sems = np.zeros((len(tris),), np.int32)
    return SceneData(
        scene_id=os.path.basename(path), vertices=tris, colors=colors, semantic_ids=sems
    )


_GLTF_COMPONENT = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def _resolve_buffers(gltf: dict, bin_chunk: bytes, base_dir: str) -> list:
    """Resolve every gltf buffer: GLB-embedded BIN chunk, external .bin file
    (relative uri — the HM3D/MP3D distribution format), or base64 data URI."""
    import base64

    bufs = []
    for i, buf in enumerate(gltf.get("buffers", [{}])):
        uri = buf.get("uri")
        if uri is None:
            bufs.append(bin_chunk)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote

            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                bufs.append(f.read())
    return bufs


def _load_glb(path: str) -> SceneData:
    """glTF parser: positions + indices + per-vertex colors of all mesh
    primitives, .glb (embedded BIN) and .gltf (external buffers / data URIs).
    Node transforms are applied for the default scene graph. Counterpart of
    habitat-sim's asset import used at
    sims/habitat_simulator/habitat_simulator.py:299-311.
    """
    if path.lower().endswith(".gltf"):
        with open(path, "r") as f:
            gltf = json.load(f)
        bin_chunk = b""
    else:
        with open(path, "rb") as f:
            magic, version, _length = struct.unpack("<III", f.read(12))
            assert magic == 0x46546C67, "not a GLB file"
            chunks = {}
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                clen, ctype = struct.unpack("<II", header)
                chunks[ctype] = f.read(clen)
        gltf = json.loads(chunks[0x4E4F534A].decode("utf-8"))
        bin_chunk = chunks.get(0x004E4942, b"")
    buffers = _resolve_buffers(gltf, bin_chunk, os.path.dirname(path))

    def read_accessor(acc_idx: int) -> np.ndarray:
        acc = gltf["accessors"][acc_idx]
        bv = gltf["bufferViews"][acc["bufferView"]]
        bin_buf = buffers[bv.get("buffer", 0)]
        dtype = _GLTF_COMPONENT[acc["componentType"]]
        n = _GLTF_NCOMP[acc["type"]]
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        count = acc["count"]
        stride = bv.get("byteStride")
        itemsize = np.dtype(dtype).itemsize * n
        if stride and stride != itemsize:
            raw = np.frombuffer(
                bin_buf, np.uint8, count * stride, offset
            ).reshape(count, stride)[:, : itemsize]
            out = np.ascontiguousarray(raw).view(dtype).reshape(count, n)
        else:
            out = np.frombuffer(bin_buf, dtype, count * n, offset).reshape(count, n)
        if acc.get("normalized") and np.issubdtype(out.dtype, np.unsignedinteger):
            out = out.astype(np.float32) / np.iinfo(out.dtype).max
        return out

    _image_cache: dict = {}

    def read_image(img_idx: int) -> Optional[np.ndarray]:
        """Decode gltf image img_idx to a float (H,W,3) array in [0,1].
        Source may be a bufferView (GLB-embedded PNG/JPEG) or an external /
        data URI. Returns None when no decoder is available."""
        if img_idx in _image_cache:
            return _image_cache[img_idx]
        img = gltf["images"][img_idx]
        raw = None
        if "bufferView" in img:
            bv = gltf["bufferViews"][img["bufferView"]]
            buf = buffers[bv.get("buffer", 0)]
            off = bv.get("byteOffset", 0)
            raw = bytes(buf[off : off + bv["byteLength"]])
        elif "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                import base64

                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                p = os.path.join(os.path.dirname(path), unquote(uri))
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        raw = f.read()
        arr = None
        if raw is not None:
            try:
                arr = decode_png(raw)
            except (ValueError, zlib.error):
                arr = None
        _image_cache[img_idx] = arr
        return arr

    def sample_texture(tex_idx: int, uv: np.ndarray) -> Optional[np.ndarray]:
        """Nearest-texel sample of texture tex_idx at (M,2) UVs (REPEAT wrap,
        the glTF default; scan assets tile their atlases)."""
        tex = gltf.get("textures", [])[tex_idx]
        if "source" not in tex:
            return None
        img = read_image(tex["source"])
        if img is None:
            return None
        h, w = img.shape[:2]
        u = np.mod(uv[:, 0], 1.0)
        v = np.mod(uv[:, 1], 1.0)
        xi = np.clip((u * w).astype(np.int64), 0, w - 1)
        yi = np.clip((v * h).astype(np.int64), 0, h - 1)
        return img[yi, xi]

    def node_transform(node) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m[:3, :3] *= np.asarray(node["scale"])
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            R = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                ]
            )
            m[:3, :3] = R @ m[:3, :3]
        if "translation" in node:
            m[:3, 3] = node["translation"]
        return m

    all_tris = []
    all_colors = []
    all_sems = []

    def emit_mesh(mesh_idx: int, xform: np.ndarray, sem: int):
        mesh = gltf["meshes"][mesh_idx]
        for prim in mesh["primitives"]:
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            pos = read_accessor(prim["attributes"]["POSITION"]).astype(np.float64)
            pos = pos @ xform[:3, :3].T + xform[:3, 3]
            if "indices" in prim:
                idx = read_accessor(prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos))
            tris = pos[idx].reshape(-1, 3, 3).astype(np.float32)
            color = np.full((len(tris), 3), 0.6, np.float32)
            if "COLOR_0" in prim["attributes"]:
                # per-vertex colors (scan meshes bake textures into these);
                # per-triangle color = mean of the 3 vertices
                vc = read_accessor(prim["attributes"]["COLOR_0"]).astype(np.float32)
                color = vc[idx, :3].reshape(-1, 3, 3).mean(axis=1)
            else:
                mat_idx = prim.get("material")
                if mat_idx is not None:
                    mat = gltf["materials"][mat_idx]
                    pbr = mat.get("pbrMetallicRoughness", {})
                    base = pbr.get("baseColorFactor")
                    if base:
                        color[:] = base[:3]
                    tex = pbr.get("baseColorTexture")
                    if tex is not None and "TEXCOORD_0" in prim["attributes"]:
                        # bake the texture to per-tri flat color: sample at
                        # the triangle-centroid UV (the renderer shades one
                        # color per triangle — habitat-sim's textured draw
                        # collapses to this under our flat-shaded kernel)
                        uv_set = tex.get("texCoord", 0)
                        attr = f"TEXCOORD_{uv_set}"
                        if attr in prim["attributes"]:
                            uvs = read_accessor(prim["attributes"][attr]).astype(
                                np.float32
                            )
                            tri_uv = uvs[idx, :2].reshape(-1, 3, 2).mean(axis=1)
                            sampled = sample_texture(tex["index"], tri_uv)
                            if sampled is not None:
                                color = sampled.astype(np.float32)
                                if base:
                                    color = color * np.asarray(
                                        base[:3], np.float32
                                    )
            all_tris.append(tris)
            all_colors.append(color)
            all_sems.append(np.full((len(tris),), sem, np.int32))

    def walk(node_idx: int, parent: np.ndarray, sem: int):
        node = gltf["nodes"][node_idx]
        xf = parent @ node_transform(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], xf, sem)
        for child in node.get("children", []):
            walk(child, xf, sem)

    scene_def = gltf["scenes"][gltf.get("scene", 0)]
    for i, root in enumerate(scene_def.get("nodes", [])):
        walk(root, np.eye(4), i + 1)

    if not all_tris:
        raise ValueError(f"no triangles found in {path}")
    return SceneData(
        scene_id=os.path.basename(path),
        vertices=np.concatenate(all_tris),
        colors=np.concatenate(all_colors),
        semantic_ids=np.concatenate(all_sems),
    )


def load_scene(
    scene_path: str,
    scenes_dir: str = "",
    nav_res: float = 0.1,
    agent_radius: float = 0.1,
    agent_height: float = 1.5,
) -> SceneData:
    path = scene_path
    if not os.path.exists(path) and scenes_dir:
        path = os.path.join(scenes_dir, scene_path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"scene not found: {scene_path}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        scene = _load_npz(path)
    elif ext == ".obj":
        scene = _load_obj(path)
    elif ext in (".glb", ".gltf"):
        scene = _load_glb(path)
    else:
        raise ValueError(f"unsupported scene format: {ext}")
    rasterize_occupancy(
        scene, res=nav_res, agent_radius=agent_radius, agent_height=agent_height
    )
    return scene


def save_scene_glb(scene: SceneData, path: str) -> None:
    """Minimal GLB writer (positions + per-primitive baseColor): used for
    loader round-trip tests and for exporting procedural scenes to standard
    tooling. One mesh primitive per semantic id so colors survive."""
    import numpy as _np

    sems = _np.unique(scene.semantic_ids)
    buffers = []
    accessors = []
    buffer_views = []
    primitives = []
    materials = []
    offset = 0

    for gi, sem in enumerate(sems):
        mask = scene.semantic_ids == sem
        tris = scene.vertices[mask].astype(_np.float32)  # (t,3,3)
        pos = tris.reshape(-1, 3)
        blob = pos.tobytes()
        buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": len(blob)}
        )
        offset += len(blob)
        buffers.append(blob)
        accessors.append(
            {
                "bufferView": gi,
                "componentType": 5126,
                "count": int(len(pos)),
                "type": "VEC3",
                "min": [float(x) for x in pos.min(axis=0)],
                "max": [float(x) for x in pos.max(axis=0)],
            }
        )
        color = scene.colors[mask][0] if mask.any() else [0.6, 0.6, 0.6]
        materials.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorFactor": [float(c) for c in color] + [1.0]
                }
            }
        )
        primitives.append({"attributes": {"POSITION": gi}, "material": gi, "mode": 4})

    bin_chunk = b"".join(buffers)
    pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\x00" * pad

    gltf = {
        "asset": {"version": "2.0", "generator": "habitat_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": primitives}],
        "materials": materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(gltf).encode("utf-8")
    js += b" " * ((-len(js)) % 4)

    with open(path, "wb") as f:
        total = 12 + 8 + len(js) + 8 + len(bin_chunk)
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)


def save_scene_gltf(scene: SceneData, path: str) -> None:
    """Standard-format .gltf with an EXTERNAL .bin buffer and per-vertex
    COLOR_0 — the layout real scan distributions use (HM3D/MP3D ship
    glTF-family assets with separate binary buffers), exercising the
    external-uri + COLOR_0 loader paths. One primitive per semantic id."""
    base = os.path.splitext(path)[0]
    bin_name = os.path.basename(base) + ".bin"

    sems = np.unique(scene.semantic_ids)
    blob = b""
    buffer_views = []
    accessors = []
    primitives = []

    for sem in sems:
        mask = scene.semantic_ids == sem
        tris = scene.vertices[mask].astype(np.float32)
        pos = tris.reshape(-1, 3)
        col = np.repeat(scene.colors[mask].astype(np.float32), 3, axis=0)
        attrs = {}
        for name, arr in (("POSITION", pos), ("COLOR_0", col)):
            data = arr.tobytes()
            buffer_views.append(
                {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
            )
            blob += data
            accessors.append(
                {
                    "bufferView": len(buffer_views) - 1,
                    "componentType": 5126,
                    "count": int(len(arr)),
                    "type": "VEC3",
                    "min": [float(x) for x in arr.min(axis=0)],
                    "max": [float(x) for x in arr.max(axis=0)],
                }
            )
            attrs[name] = len(accessors) - 1
        primitives.append({"attributes": attrs, "mode": 4})

    gltf = {
        "asset": {"version": "2.0", "generator": "habitat_torch"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(primitives)))}],
        "nodes": [{"mesh": i} for i in range(len(primitives))],
        "meshes": [{"primitives": [p]} for p in primitives],
        "buffers": [{"uri": bin_name, "byteLength": len(blob)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    with open(base + ".bin", "wb") as f:
        f.write(blob)
    with open(base + ".gltf", "w") as f:
        json.dump(gltf, f)


def resolve_scene_dataset(
    config_path: str, scene_id: str
) -> str:
    """Resolve a scene id through a habitat `*.scene_dataset_config.json`
    (the reference's on-disk dataset layout: habitat.simulator.scene_dataset
    names the config, habitat.simulator.scene / episode scene_ids name a
    stage — habitat_simulator.py:299-331). Supports the habitat-sim schema's
    ``stages: {paths: {".glb": [globs...]}}`` section: globs are expanded
    relative to the config's directory and the stage whose filename stem
    matches the scene id's stem wins. Absolute/existing scene ids pass
    through unchanged."""
    import glob as _glob
    import json as _json

    if os.path.exists(scene_id):
        return scene_id
    base = os.path.dirname(os.path.abspath(config_path))
    with open(config_path) as f:
        cfg = _json.load(f)
    stem = os.path.splitext(os.path.basename(scene_id))[0]
    # hm3d-style ids carry double extensions (.basis.glb)
    stem = stem.split(".")[0]
    paths = (cfg.get("stages", {}) or {}).get("paths", {}) or {}
    for _ext, globs in paths.items():
        for g in globs:
            for hit in sorted(_glob.glob(os.path.join(base, g))):
                if os.path.splitext(os.path.basename(hit))[0].split(".")[0] == stem:
                    return hit
    raise FileNotFoundError(
        f"scene {scene_id!r} not found in dataset {config_path!r}"
    )


# ---------------------------------------------------------------------------
# Articulated objects from URDF
# ---------------------------------------------------------------------------
#
# The reference loads articulated objects (cabinets, fridges) from URDF through
# habitat-sim's ArticulatedObjectManager, listed by the scene dataset config
# (habitat_simulator.py:299-311; rearrange_sim.py:209-233). Here the URDF's
# kinematics parse through the agents' parser (articulated_agents/urdf.py) and
# the links' collision boxes are read off the XML; the result feeds the
# rearrange table's articulated lanes (tasks/rearrange/generator.py
# build_rearrange_table).


@dataclasses.dataclass
class ArtJointSpec:
    """One movable joint of an articulated object asset."""

    name: str
    joint_type: str  # "prismatic" | "revolute"
    axis: np.ndarray  # (3,) unit, in the object frame
    origin: np.ndarray  # (3,) joint origin in the object frame
    lower: float
    upper: float
    child_link: str
    # the moving link's collision box: half extents and center offset (joint frame)
    box_half: np.ndarray  # (3,)
    box_center: np.ndarray  # (3,)


@dataclasses.dataclass
class ArticulatedObjectAsset:
    """Host-side articulated object: URDF kinematics and link boxes."""

    name: str
    urdf_path: str
    joints: List[ArtJointSpec]
    base_box_half: np.ndarray  # (3,) the base link's collision box half extents
    base_box_center: np.ndarray  # (3,)

    @property
    def primary(self) -> ArtJointSpec:
        return self.joints[0]


def _link_box(link_el):
    """A link's collision (else visual) <box size>: (half extents, center)."""
    for kind in ("collision", "visual"):
        sec = link_el.find(kind)
        if sec is None:
            continue
        geo = sec.find("geometry")
        box = geo.find("box") if geo is not None else None
        if box is None:
            continue
        size = np.array([float(x) for x in box.get("size", "0 0 0").split()])
        origin = sec.find("origin")
        xyz = np.array([float(x) for x in origin.get("xyz", "0 0 0").split()]) if origin is not None else np.zeros(3)
        return size.astype(np.float32) / 2.0, xyz.astype(np.float32)
    return np.zeros(3, np.float32), np.zeros(3, np.float32)


def load_articulated_object(urdf_path: str) -> ArticulatedObjectAsset:
    """URDF file -> ArticulatedObjectAsset (its prismatic and revolute
    joints and the links' boxes). A joint's origin is accumulated through
    the joints from the root link, so ``origin`` is in the object frame."""
    import xml.etree.ElementTree as ET

    from habitat_torch.articulated_agents.urdf import parse_urdf

    model = parse_urdf(urdf_path)
    root = ET.parse(urdf_path).getroot()
    link_els = {l.get("name", ""): l for l in root.findall("link")}

    # each link's origin in the object frame, propagated from the root
    # (furniture trees are shallow)
    base = model.root_link
    link_origin = {base: np.zeros(3, np.float32)}
    for _ in range(len(model.joints) + 1):
        for j in model.joints:
            if j.parent in link_origin and j.child not in link_origin:
                link_origin[j.child] = link_origin[j.parent] + j.origin_xyz.astype(np.float32)

    joints: List[ArtJointSpec] = []
    for j in model.joints:
        if j.joint_type not in ("prismatic", "revolute"):
            continue
        half, center = _link_box(link_els.get(j.child, ET.Element("link")))
        joints.append(ArtJointSpec(
            name=j.name, joint_type=j.joint_type, axis=j.axis.astype(np.float32),
            origin=link_origin.get(j.parent, np.zeros(3, np.float32)) + j.origin_xyz.astype(np.float32),
            lower=float(j.lower), upper=float(j.upper), child_link=j.child, box_half=half, box_center=center,
        ))
    if not joints:
        raise ValueError(f"{urdf_path}: no movable (prismatic/revolute) joints")
    bhalf, bcenter = _link_box(link_els.get(base, ET.Element("link")))
    return ArticulatedObjectAsset(name=model.name, urdf_path=urdf_path, joints=joints, base_box_half=bhalf,
                                  base_box_center=bcenter)


def resolve_articulated_objects(config_path: str) -> dict:
    """The articulated-object URDFs a scene_dataset_config lists
    (habitat-sim schema: ``articulated_objects: {paths: {".urdf": [globs]}}``,
    relative to the config's directory): {file stem: absolute path}."""
    import glob as _glob

    base = os.path.dirname(os.path.abspath(config_path))
    with open(config_path) as f:
        cfg = json.load(f)
    paths = (cfg.get("articulated_objects", {}) or {}).get("paths", {}) or {}
    out = {}
    for _ext, globs in paths.items():
        for g in globs:
            for hit in sorted(_glob.glob(os.path.join(base, g))):
                out[os.path.splitext(os.path.basename(hit))[0]] = hit
    return out
