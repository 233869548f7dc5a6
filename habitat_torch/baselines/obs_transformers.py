"""Observation transforms (port of ``habitat_tpu/baselines/obs_transformers.py``;
reference habitat-baselines/habitat_baselines/common/obs_transformers.py:
ResizeShortestEdge:70, CenterCropper:156, projection converters :234-1244,
AddVirtualKeys:1246), registered under the same names.

Each transform maps observation descriptors (``transform_observation_space``
on a dict of ``(shape, dtype)`` pairs, the port's ``observation_shapes``) and
batched observations (``__call__`` on a dict of tensors, (N, H, W, C) frames
or one unbatched (H, W, C) frame).

- ``ResizeShortestEdge`` resamples with the weights of ``jax.image.resize``'s
  bilinear method (half-pixel centres, a triangle kernel widened by the
  scale when shrinking, renormalised at the edges), as two per-axis weight
  matrices; uint8 frames are rounded half to even and clipped, as the JAX
  package rounds them.
- The projection converters (cube map <-> equirect, cube map -> fisheye)
  resample through a bilinear plan, 4 source indices and weights per output
  pixel, computed in float64 numpy as in the JAX package and placed on the
  device once per input size; applying it is 4 gathers and a weighted sum
  (plain PyTorch, as the JAX code's ``jnp.take`` is plain XLA).

The transforms' weights and plans live on ``device`` (``None`` = cuda); the
observations must be there too.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from habitat_torch.core.registry import registry
from habitat_torch.device import resolve_device
from habitat_torch.utils.geometry import camera_rays


class ObservationTransformer:
    """``device``: where the transform's tables live (``None`` = cuda)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def transform_observation_space(self, observation_space: Dict) -> Dict:
        return observation_space

    def __call__(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @classmethod
    def from_config(cls, config, device=None):
        return cls(device=device)


def _image_keys(observation_space: Dict) -> List[str]:
    return [k for k, (shape, _) in observation_space.items() if len(shape) == 3]


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s bilinear
    method along one axis (antialiased, translation 0), in its float32
    arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps), w / np.where(total != 0, total, f32(1.0)),
                 f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _to_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float resampling results back to the input's dtype: uint8 rounded half
    to even and clipped, other integers rounded."""
    if dtype == torch.uint8:
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
    if not dtype.is_floating_point:
        return torch.round(x).to(dtype)
    return x


@registry.register_obs_transformer(name="ResizeShortestEdge")
class ResizeShortestEdge(ObservationTransformer):
    def __init__(self, size: int = 256, channels_last: bool = True,
                 trans_keys: Tuple[str, ...] = ("rgb", "depth", "semantic"), device=None):
        super().__init__(device)
        self._size = int(size)
        self.trans_keys = trans_keys
        self._shapes: Dict[str, Tuple[int, int]] = {}
        self._weights: Dict[Tuple[int, int], torch.Tensor] = {}

    def _target_shape(self, h: int, w: int) -> Tuple[int, int]:
        scale = self._size / min(h, w)
        return int(round(h * scale)), int(round(w * scale))

    def transform_observation_space(self, observation_space: Dict) -> Dict:
        out = dict(observation_space)
        for k in _image_keys(observation_space):
            if k not in self.trans_keys:
                continue
            (h, w, c), dtype = observation_space[k]
            nh, nw = self._target_shape(h, w)
            self._shapes[k] = (nh, nw)
            out[k] = ((nh, nw, c), dtype)
        return out

    def _weight(self, n_in: int, n_out: int) -> torch.Tensor:
        if (n_in, n_out) not in self._weights:
            self._weights[(n_in, n_out)] = torch.from_numpy(resize_weights(n_in, n_out)).to(self.device)
        return self._weights[(n_in, n_out)]

    def _resize(self, img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
        """(..., H, W, C) -> (..., nh, nw, C); an axis of unchanged size is
        left alone, as ``jax.image.resize`` leaves it."""
        x = img.float()
        h, w = x.shape[-3], x.shape[-2]
        if nh != h:
            x = torch.einsum("...hwc,hH->...Hwc", x, self._weight(h, nh))
        if nw != w:
            x = torch.einsum("...hwc,wW->...hWc", x, self._weight(w, nw))
        return _to_dtype(x, img.dtype)

    def __call__(self, obs):
        out = dict(obs)
        for k in self.trans_keys:
            if k not in out or out[k].ndim < 3:
                continue
            nh, nw = self._shapes.get(k, self._target_shape(out[k].shape[-3], out[k].shape[-2]))
            if (nh, nw) != tuple(out[k].shape[-3:-1]):
                out[k] = self._resize(out[k], nh, nw)
        return out

    @classmethod
    def from_config(cls, config, device=None):
        return cls(size=int(getattr(config, "size", 256)), device=device)


@registry.register_obs_transformer(name="CenterCropper")
class CenterCropper(ObservationTransformer):
    def __init__(self, height: int = 256, width: int = 256,
                 trans_keys: Tuple[str, ...] = ("rgb", "depth", "semantic"), device=None):
        super().__init__(device)
        self._h = int(height)
        self._w = int(width)
        self.trans_keys = trans_keys
        self._crops: Dict[str, Tuple[int, int]] = {}

    def transform_observation_space(self, observation_space: Dict) -> Dict:
        out = dict(observation_space)
        for k in _image_keys(observation_space):
            if k not in self.trans_keys:
                continue
            (h, w, c), dtype = observation_space[k]
            assert h >= self._h and w >= self._w, (k, h, w, self._h, self._w)
            self._crops[k] = ((h - self._h) // 2, (w - self._w) // 2)
            out[k] = ((self._h, self._w, c), dtype)
        return out

    def __call__(self, obs):
        out = dict(obs)
        for k in self.trans_keys:
            if k not in out or out[k].ndim < 3:
                continue
            h, w = out[k].shape[-3], out[k].shape[-2]
            if h == self._h and w == self._w:
                continue
            oy, ox = self._crops.get(k, ((h - self._h) // 2, (w - self._w) // 2))
            out[k] = out[k][..., oy:oy + self._h, ox:ox + self._w, :]
        return out

    @classmethod
    def from_config(cls, config, device=None):
        return cls(height=int(getattr(config, "height", 256)), width=int(getattr(config, "width", 256)),
                   device=device)


# ---------------------------------------------------------------------------
# projection converters (reference common/obs_transformers.py:234-1244)
# ---------------------------------------------------------------------------
#
# Cube face order is the reference's: BACK, DOWN, FRONT, LEFT, RIGHT, UP
# (obs_transformers.py:344-352), each face a 90-degree pinhole at (yaw, pitch)
# in the port's camera convention (utils/geometry.camera_rays: forward -z,
# yaw about +y).

CUBE_FACES = ("BACK", "DOWN", "FRONT", "LEFT", "RIGHT", "UP")
_FACE_POSES = {
    "BACK": (np.pi, 0.0),
    "DOWN": (0.0, -np.pi / 2),
    "FRONT": (0.0, 0.0),
    "LEFT": (np.pi / 2, 0.0),
    "RIGHT": (-np.pi / 2, 0.0),
    "UP": (0.0, np.pi / 2),
}


def _rot_yaw_pitch(yaw: float, pitch: float) -> np.ndarray:
    """World-from-camera rotation (as utils/geometry.rotate_dirs)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    r_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    r_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return r_yaw @ r_pitch


def _dirs_to_cube_plan(dirs: np.ndarray, face_hw: int):
    """(H, W, 3) world directions -> a bilinear plan into the stacked cube
    (6 * face_hw * face_hw sources): (idx (4, H*W) int32, weights (4, H*W)
    float32). Each direction samples the face that sees it most head-on, at
    its 90-degree pinhole projection."""
    d = dirs.reshape(-1, 3)
    best_z = np.full(d.shape[0], -np.inf)
    face = np.zeros(d.shape[0], np.int32)
    uu = np.zeros(d.shape[0])
    vv = np.zeros(d.shape[0])
    for fi, name in enumerate(CUBE_FACES):
        dc = d @ _rot_yaw_pitch(*_FACE_POSES[name])  # world -> camera
        z = -dc[:, 2]  # forwardness
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.where(z > 1e-9, dc[:, 0] / z, 0.0)
            v = np.where(z > 1e-9, dc[:, 1] / z, 0.0)
        take = z > best_z
        best_z = np.where(take, z, best_z)
        face = np.where(take, fi, face)
        uu = np.where(take, u, uu)
        vv = np.where(take, v, vv)
    # uv in [-1, 1] -> pixel coordinates (x right, y up, row 0 = +v)
    px = (uu + 1.0) * 0.5 * (face_hw - 1)
    py = (1.0 - vv) * 0.5 * (face_hw - 1)
    x0 = np.clip(np.floor(px).astype(np.int64), 0, face_hw - 1)
    y0 = np.clip(np.floor(py).astype(np.int64), 0, face_hw - 1)
    x1 = np.minimum(x0 + 1, face_hw - 1)
    y1 = np.minimum(y0 + 1, face_hw - 1)
    fx = np.clip(px - x0, 0.0, 1.0)
    fy = np.clip(py - y0, 0.0, 1.0)
    base = face.astype(np.int64) * face_hw * face_hw
    idx = np.stack([base + y0 * face_hw + x0, base + y0 * face_hw + x1, base + y1 * face_hw + x0,
                    base + y1 * face_hw + x1])
    wts = np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy])
    return idx.astype(np.int32), wts.astype(np.float32)


def _apply_plan(stacked: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, out_hw, nearest: bool) -> torch.Tensor:
    """stacked (N, S, C) flat sources -> (N, H, W, C): the weighted sum of
    the plan's 4 samples (in float32, in the JAX package's order), or the
    sample of the largest weight (first on ties) with ``nearest``."""
    N, _, C = stacked.shape
    H, W = out_hw
    if nearest:
        best = torch.argmax(wts, dim=0)
        flat = stacked.index_select(1, idx.gather(0, best[None])[0])
        return flat.reshape(N, H, W, C)
    acc = wts[0][None, :, None] * stacked.index_select(1, idx[0])
    for k in range(1, 4):
        acc = acc + wts[k][None, :, None] * stacked.index_select(1, idx[k])
    return acc.reshape(N, H, W, C)


def _resample_obs(img6: torch.Tensor, idx, wts, out_hw) -> torch.Tensor:
    """(N, 6, Hf, Wf, C) cube faces -> (N, H, W, C); integer frames other
    than uint8 (semantic ids) take the nearest sample."""
    N, C, dtype = img6.shape[0], img6.shape[-1], img6.dtype
    nearest = not dtype.is_floating_point and dtype != torch.uint8
    x = img6.reshape(N, -1, C)
    if not nearest:
        x = x.float()
    out = _apply_plan(x, idx, wts, out_hw, nearest)
    return out.to(dtype) if nearest else _to_dtype(out, dtype)


class _CubeMapConverter(ObservationTransformer):
    """Consumes groups of 6 cube-face uuids (BACK, DOWN, FRONT, LEFT, RIGHT,
    UP) and emits one key per group: ``target_uuids``, or the group's first
    uuid without its face suffix (reference ProjectionConverter)."""

    def __init__(self, sensor_uuids: List[str], out_hw: Tuple[int, int],
                 target_uuids: Optional[List[str]] = None, device=None):
        super().__init__(device)
        assert len(sensor_uuids) % 6 == 0, sensor_uuids
        self.groups = [sensor_uuids[i:i + 6] for i in range(0, len(sensor_uuids), 6)]
        self.out_hw = tuple(out_hw)
        if target_uuids is None:
            target_uuids = []
            for g in self.groups:
                name = g[0]
                for f in CUBE_FACES:
                    name = name.replace(f"_{f.lower()}", "").replace(f"_{f}", "")
                target_uuids.append(name)
        self.target_uuids = target_uuids
        self._plan = {}  # face_hw -> (idx, wts) on the device

    def _out_dirs(self) -> np.ndarray:
        raise NotImplementedError

    def _get_plan(self, face_hw: int):
        if face_hw not in self._plan:
            idx, wts = _dirs_to_cube_plan(self._out_dirs(), face_hw)
            self._plan[face_hw] = (torch.from_numpy(idx.astype(np.int64)).to(self.device),
                                   torch.from_numpy(wts).to(self.device))
        return self._plan[face_hw]

    def transform_observation_space(self, observation_space: Dict) -> Dict:
        out = dict(observation_space)
        H, W = self.out_hw
        for g, tgt in zip(self.groups, self.target_uuids):
            if g[0] not in out:
                continue
            shape, dtype = out[g[0]]
            for u in g:
                out.pop(u, None)
            out[tgt] = ((H, W, shape[-1]), dtype)
        return out

    def __call__(self, obs):
        out = dict(obs)
        for g, tgt in zip(self.groups, self.target_uuids):
            if g[0] not in out:
                continue
            faces = torch.stack([out.pop(u) for u in g], dim=-4)  # (..., 6, H, W, C)
            squeeze = faces.ndim == 4
            if squeeze:
                faces = faces[None]
            idx, wts = self._get_plan(faces.shape[-2])
            res = _resample_obs(faces, idx, wts, self.out_hw)
            out[tgt] = res[0] if squeeze else res
        return out


@registry.register_obs_transformer(name="CubeMap2Equirect")
class CubeMap2Equirect(_CubeMapConverter):
    """6 cube faces -> one equirectangular panorama (reference
    obs_transformers.py:340-420)."""

    def _out_dirs(self) -> np.ndarray:
        H, W = self.out_hw
        lon = np.linspace(-np.pi, np.pi, W, endpoint=False)
        lat = np.linspace(np.pi / 2, -np.pi / 2, H)
        LO, LA = np.meshgrid(lon, lat)
        # utils/geometry.equirect_rays at yaw = pitch = 0
        return np.stack([-np.sin(LO) * np.cos(LA), np.sin(LA), -np.cos(LO) * np.cos(LA)], axis=-1)

    @classmethod
    def from_config(cls, config, device=None):
        return cls(sensor_uuids=list(config.get("sensor_uuids", [])), out_hw=tuple(config.get("eq_shape", (256, 512))),
                   target_uuids=list(config.get("target_uuids", [])) or None, device=device)


@registry.register_obs_transformer(name="CubeMap2Fisheye")
class CubeMap2Fisheye(_CubeMapConverter):
    """6 cube faces -> a double-sphere fisheye image (reference
    obs_transformers.py:730-900; Usenko et al. 2018). ``fish_params`` =
    (xi, alpha, focal over the image's smaller side); pixels outside the
    model's image are zero."""

    def __init__(self, sensor_uuids, out_hw, fish_params=(0.2, 0.59, 0.18), target_uuids=None, device=None):
        self.fish_params = fish_params
        super().__init__(sensor_uuids, out_hw, target_uuids, device)
        self._mask = None

    def _out_dirs(self) -> np.ndarray:
        H, W = self.out_hw
        xi, alpha, fr = self.fish_params
        fx = fy = fr * min(H, W)
        cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        mx = (u - cx) / fx
        my = -(v - cy) / fy  # y up
        r2 = mx * mx + my * my
        # double-sphere unprojection (closed form)
        inner = 1.0 - (2 * alpha - 1.0) * r2
        valid = inner >= 0.0
        inner = np.maximum(inner, 0.0)
        mz = (1.0 - alpha * alpha * r2) / (alpha * np.sqrt(inner) + 1.0 - alpha)
        s = (mz * xi + np.sqrt(np.maximum(mz * mz + (1 - xi * xi) * r2, 0.0))) / (mz * mz + r2 + 1e-12)
        d = np.stack([s * mx, s * my, -(s * mz - xi)], axis=-1)
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
        d[~valid] = np.array([0.0, 0.0, 1.0])  # sampled, then masked
        self._valid_mask = valid
        return d

    def __call__(self, obs):
        out = super().__call__(obs)
        mask = getattr(self, "_valid_mask", None)
        if mask is not None:
            if self._mask is None:
                self._mask = torch.from_numpy(mask).to(self.device)
            for tgt in self.target_uuids:
                if tgt in out and hasattr(out[tgt], "ndim") and tuple(out[tgt].shape[-3:-1]) == mask.shape:
                    img = out[tgt]
                    out[tgt] = img * self._mask[..., None].to(img.dtype)
        return out

    @classmethod
    def from_config(cls, config, device=None):
        fp = config.get("fish_params", None)
        kw = {} if fp is None else {"fish_params": tuple(fp)}
        return cls(sensor_uuids=list(config.get("sensor_uuids", [])),
                   out_hw=tuple(config.get("fish_shape", (256, 256))),
                   target_uuids=list(config.get("target_uuids", [])) or None, device=device, **kw)


@registry.register_obs_transformer(name="Equirect2CubeMap")
class Equirect2CubeMap(ObservationTransformer):
    """One equirect panorama -> 6 cube faces (reference
    obs_transformers.py:950-1080): the keys ``target_uuids``, 6 per input,
    ``<uuid>_<face>`` by default."""

    def __init__(self, sensor_uuids: List[str], img_shape: Tuple[int, int],
                 target_uuids: Optional[List[str]] = None, device=None):
        super().__init__(device)
        self.sensor_uuids = list(sensor_uuids)
        self.out_hw = tuple(img_shape)
        if target_uuids is None:
            target_uuids = [f"{u}_{f.lower()}" for u in sensor_uuids for f in CUBE_FACES]
        self.target_uuids = target_uuids
        self._plan = {}

    def _get_plan(self, eq_hw: Tuple[int, int]):
        """The faces' plan into an (He, We) panorama: the faces' float32 rays
        (``camera_rays``, as the JAX package takes its own), then float64
        numpy; longitude wraps."""
        if eq_hw not in self._plan:
            H, W = self.out_hw
            He, We = eq_hw
            idxs, wtss = [], []
            for f in CUBE_FACES:
                yaw, pitch = _FACE_POSES[f]
                d = camera_rays(torch.tensor(yaw, dtype=torch.float32), torch.tensor(pitch, dtype=torch.float32),
                                float(np.float32(np.pi / 2)), H, W).numpy().astype(np.float64).reshape(-1, 3)
                lon = np.arctan2(-d[:, 0], -d[:, 2])
                lat = np.arcsin(np.clip(d[:, 1], -1, 1))
                px = (lon + np.pi) / (2 * np.pi) * We  # lon = -pi -> column 0
                py = (np.pi / 2 - lat) / np.pi * (He - 1)
                x0 = np.floor(px).astype(np.int64)
                fx = px - x0
                x0 = x0 % We
                x1 = (x0 + 1) % We
                y0 = np.clip(np.floor(py).astype(np.int64), 0, He - 1)
                y1 = np.minimum(y0 + 1, He - 1)
                fy = np.clip(py - y0, 0.0, 1.0)
                idxs.append(np.stack([y0 * We + x0, y0 * We + x1, y1 * We + x0, y1 * We + x1]))
                wtss.append(np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]))
            self._plan[eq_hw] = (torch.from_numpy(np.stack(idxs).astype(np.int64)).to(self.device),
                                 torch.from_numpy(np.stack(wtss).astype(np.float32)).to(self.device))
        return self._plan[eq_hw]

    def transform_observation_space(self, observation_space: Dict) -> Dict:
        out = dict(observation_space)
        H, W = self.out_hw
        ti = 0
        for u in self.sensor_uuids:
            if u not in out:
                ti += 6
                continue
            shape, dtype = out.pop(u)
            for _ in range(6):
                out[self.target_uuids[ti]] = ((H, W, shape[-1]), dtype)
                ti += 1
        return out

    def __call__(self, obs):
        out = dict(obs)
        ti = 0
        for u in self.sensor_uuids:
            if u not in out:
                ti += 6
                continue
            eq = out.pop(u)
            squeeze = eq.ndim == 3
            if squeeze:
                eq = eq[None]
            N, He, We, C = eq.shape
            idxs, wtss = self._get_plan((He, We))
            x = eq.reshape(N, He * We, C).float()
            for fi in range(6):
                res = _to_dtype(_apply_plan(x, idxs[fi], wtss[fi], self.out_hw, False), eq.dtype)
                out[self.target_uuids[ti]] = res[0] if squeeze else res
                ti += 1
        return out

    @classmethod
    def from_config(cls, config, device=None):
        return cls(sensor_uuids=list(config.get("sensor_uuids", [])), img_shape=tuple(config.get("img_shape", (256, 256))),
                   target_uuids=list(config.get("target_uuids", [])) or None, device=device)


@registry.register_obs_transformer(name="AddVirtualKeys")
class AddVirtualKeys(ObservationTransformer):
    """Adds zero-filled float32 keys (reference obs_transformers.py:1246;
    policy-side keys that HITL and planning configs declare)."""

    def __init__(self, virtual_keys: Dict[str, int], device=None):
        super().__init__(device)
        self.virtual_keys = dict(virtual_keys)

    def transform_observation_space(self, observation_space: Dict) -> Dict:
        out = dict(observation_space)
        for k, dim in self.virtual_keys.items():
            out[k] = ((int(dim),), torch.float32)
        return out

    def __call__(self, obs):
        out = dict(obs)
        any_leaf = next(iter(obs.values()))
        batch = any_leaf.shape[0] if any_leaf.ndim > 3 or any_leaf.ndim == 2 else None
        for k, dim in self.virtual_keys.items():
            if k in out:
                continue
            shape = (batch, int(dim)) if batch is not None else (int(dim),)
            out[k] = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return out

    @classmethod
    def from_config(cls, config, device=None):
        vk = config.get("virtual_keys", {}) or {}
        items = vk.items() if hasattr(vk, "items") else []
        return cls({str(k): int(v) for k, v in items}, device=device)


def get_active_obs_transforms(config, device=None) -> List[ObservationTransformer]:
    """The transforms named under
    ``habitat_baselines.rl.policy.main_agent.obs_transforms``, in order."""
    out = []
    transforms_cfg = config.get_path("habitat_baselines.rl.policy.main_agent.obs_transforms", {})
    for name, cfg in (transforms_cfg or {}).items():
        cls = registry.get_obs_transformer(cfg.get("type", name))
        out.append(cls.from_config(cfg, device=device))
    return out


def apply_obs_transforms_batch(obs, transforms: Iterable[ObservationTransformer]):
    for t in transforms:
        obs = t(obs)
    return obs


def apply_obs_transforms_obs_space(obs_space, transforms: Iterable[ObservationTransformer]):
    for t in transforms:
        obs_space = t.transform_observation_space(obs_space)
    return obs_space
