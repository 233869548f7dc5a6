"""Offscreen debug camera and image tools (port of
``habitat_tpu/sims/debug_visualizer.py``; reference habitat-lab/habitat/sims/
habitat_simulator/debug_visualizer.py).

- ``project_point``: world point -> 2D image fraction (reference :23);
- ``stitch_image_matrix``: image grid compositor (reference :48);
- ``draw_object_highlight``: circle around a subject (reference :173);
- ``DebugVisualizer``: look_at / translate / rotate camera state,
  ``peek(subject)`` framed by the subject's bounds, the 3x2 ``peek_all_axis``
  matrix, debug line and circle overlays, and the list of single-view frames.

Frames come from ``render_batch`` (N=1, kernel #1 on the card) at arbitrary
look-at poses and are copied to the host once per render; the overlays are
drawn there in numpy. ``DebugObservation`` keeps its frame as
``obs_data``; its image is the (H, W, 3) uint8 array the JAX package's PIL
image holds, ``save`` writes it as a PNG and ``make_debug_video`` writes the
single-view frames as a GIF, both through the port's own encoders
(``utils/visualizations/image_io.py``).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.device import resolve_device
from habitat_torch.ops.raycast import render_batch
from habitat_torch.sims.scene import ScenePack
from habitat_torch.sims.tpu_sim import to_host

def _lookat_yaw_pitch(eye: np.ndarray, target: np.ndarray) -> Tuple[float, float]:
    d = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    yaw = float(np.arctan2(-d[0], -d[2]))
    pitch = float(np.arctan2(d[1], np.linalg.norm(d[[0, 2]])))
    return yaw, pitch


def _camera_basis(yaw: float, pitch: float):
    """Forward/right/up of our yaw-pitch camera (forward = -z at yaw=0)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    fwd = np.array([-sy * cp, sp, -cy * cp])
    right = np.array([cy, 0.0, -sy])
    up = np.cross(right, fwd)
    return fwd, right, up


def project_point(
    eye, yaw: float, pitch: float, point, hfov_deg: float = 90.0
) -> Optional[np.ndarray]:
    """World point -> (x, y) image-fraction coordinates, or None if behind
    the camera (reference project_point:23 via camera_matrix+projection)."""
    fwd, right, up = _camera_basis(yaw, pitch)
    d = np.asarray(point, np.float64) - np.asarray(eye, np.float64)
    z = d @ fwd
    if z <= 1e-6:
        return None
    tan_h = np.tan(np.deg2rad(hfov_deg) / 2)
    x = (d @ right) / (z * tan_h)
    y = (d @ up) / (z * tan_h)
    return np.array([0.5 + 0.5 * x, 0.5 - 0.5 * y])


def stitch_image_matrix(images: Sequence[np.ndarray], num_col: int = 3) -> np.ndarray:
    """Compose equal-size RGB frames into a grid (reference :48)."""
    assert images, "no images to stitch"
    h, w = images[0].shape[:2]
    rows = (len(images) + num_col - 1) // num_col
    out = np.zeros((rows * h, num_col * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, num_col)
        out[r * h : (r + 1) * h, c * w : (c + 1) * w] = im[..., :3]
    return out


def _draw_circle_px(frame: np.ndarray, cx: float, cy: float, radius_px: float,
                    color=(255, 255, 0), thickness: float = 1.5) -> None:
    h, w = frame.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    ring = np.abs(r - radius_px) <= thickness
    frame[ring] = color


def _draw_segment_px(frame: np.ndarray, p0, p1, color=(0, 255, 0),
                     thickness: float = 1.0) -> None:
    h, w = frame.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip(p0[0] + (p1[0] - p0[0]) * ts, 0, w - 1).astype(int)
    ys = np.clip(p0[1] + (p1[1] - p0[1]) * ts, 0, h - 1).astype(int)
    for dx in range(-int(thickness), int(thickness) + 1):
        frame[np.clip(ys + dx, 0, h - 1), xs] = color
        frame[ys, np.clip(xs + dx, 0, w - 1)] = color


class DebugObservation:
    """A debug frame (reference DebugObservation:82): ``obs_data`` is the
    (H, W, C) array; ``image`` its (H, W, 3) uint8 picture once made."""

    def __init__(self, obs_data: np.ndarray):
        self.obs_data = np.asarray(obs_data)
        self.image: Optional[np.ndarray] = None

    def create_image(self) -> np.ndarray:
        """uint8 as it is, floats scaled by 255 and clipped, one channel
        repeated to three, a fourth dropped."""
        data = self.obs_data
        if data.dtype != np.uint8:
            data = np.clip(data * 255, 0, 255).astype(np.uint8)
        if data.ndim == 3 and data.shape[-1] == 1:
            data = np.repeat(data, 3, axis=-1)
        self.image = np.ascontiguousarray(data[..., :3])
        return self.image

    def get_image(self) -> np.ndarray:
        if self.image is None:
            self.create_image()
        return self.image

    def show_point(self, p_2d: np.ndarray, color=(255, 0, 0)) -> None:
        """Mark an image-fraction point with a ring (reference show_point:128)."""
        img = np.array(self.get_image())
        h, w = img.shape[:2]
        _draw_circle_px(img, p_2d[0] * w, p_2d[1] * h, max(3.0, 0.01 * w), color)
        self.image = img

    def save(self, output_path: str, prefix: str = "") -> str:
        """Write the image as ``<output_path>/<prefix><ms since epoch>.png``;
        returns the path."""
        from habitat_torch.utils.visualizations.image_io import write_png

        os.makedirs(output_path, exist_ok=True)
        path = os.path.join(output_path, f"{prefix}{int(time.time() * 1000)}.png")
        write_png(path, self.get_image())
        return path


def draw_object_highlight(
    frame: np.ndarray, eye, yaw: float, pitch: float, center, radius: float = 0.3,
    color=(255, 255, 0), hfov_deg: float = 90.0,
) -> np.ndarray:
    """Circle highlight around a world-space subject (reference
    draw_object_highlight:173 via DebugLineRender)."""
    out = np.array(frame[..., :3], np.uint8, copy=True)
    h, w = out.shape[:2]
    p = project_point(eye, yaw, pitch, center, hfov_deg)
    if p is None:
        return out
    d = np.linalg.norm(np.asarray(center, np.float64) - np.asarray(eye, np.float64))
    tan_h = np.tan(np.deg2rad(hfov_deg) / 2)
    radius_px = max(2.0, radius / max(d * tan_h, 1e-6) * (w / 2))
    _draw_circle_px(out, p[0] * w, p[1] * h, radius_px, color)
    return out


class DebugVisualizer:
    """dbv: point a camera anywhere, frame subjects by bounds, collect frames,
    write them as a video (reference DebugVisualizer:227). ``pack`` is moved to ``device``
    (``None`` = cuda)."""

    def __init__(
        self,
        pack: ScenePack,
        sid: int = 0,
        resolution: Tuple[int, int] = (256, 256),
        output_path: str = "visual_debug_output",
        hfov_deg: float = 90.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.pack = pack.to(self.device)
        self._nav_lo = pack.nav_lo[sid].cpu().numpy()
        self.sid = sid
        self.resolution = resolution
        self.output_path = output_path
        self.hfov_deg = hfov_deg
        self._frames: List[np.ndarray] = []
        # persistent camera state (reference look_at/translate/rotate)
        self.eye = np.array([0.0, 1.5, 0.0])
        self.yaw = 0.0
        self.pitch = 0.0

    # -- camera state (reference :373-466) --------------------------------
    def look_at(self, look_at, look_from=None) -> None:
        if look_from is not None:
            self.eye = np.asarray(look_from, np.float64)
        self.yaw, self.pitch = _lookat_yaw_pitch(self.eye, look_at)

    def translate(self, vec, local: bool = False) -> None:
        v = np.asarray(vec, np.float64)
        if local:
            fwd, right, up = _camera_basis(self.yaw, self.pitch)
            v = v[0] * right + v[1] * up + v[2] * -fwd
        self.eye = self.eye + v

    def rotate(self, d_yaw: float = 0.0, d_pitch: float = 0.0) -> None:
        self.yaw += d_yaw
        self.pitch = float(np.clip(self.pitch + d_pitch, -1.4, 1.4))

    # -- rendering --------------------------------------------------------
    def render(self, eye=None, target=None, yaw=None, pitch=None):
        eye = self.eye if eye is None else np.asarray(eye, np.float64)
        if target is not None:
            yaw, pitch = _lookat_yaw_pitch(eye, target)
        yaw = self.yaw if yaw is None else yaw
        pitch = self.pitch if pitch is None else pitch
        h, w = self.resolution
        cam = np.concatenate([np.asarray(eye, np.float32), np.array([yaw, pitch], np.float32)])
        x = torch.from_numpy(cam).to(self.device, non_blocking=True)
        sid = torch.full((1,), self.sid, dtype=torch.int64, device=self.device)
        out = render_batch(self.pack, sid, x[None, 0:3], x[3:4], x[4:5], height=h, width=w, hfov_deg=self.hfov_deg)
        self.eye, self.yaw, self.pitch = np.asarray(eye, np.float64), yaw, pitch
        return to_host({k: v[0] for k, v in out.items()})

    def get_observation(self, look_at=None, look_from=None) -> DebugObservation:
        if look_at is not None:
            self.look_at(look_at, look_from)
        return DebugObservation(self.render()["rgb"])

    # -- peek (reference :562-735) ----------------------------------------
    def peek(
        self,
        subject="scene",
        cam_local_pos=None,
        peek_all_axis: bool = False,
        debug_lines=None,
        debug_circles=None,
    ) -> DebugObservation:
        """Frame a subject automatically from its bounds.

        subject: "scene"/"stage", an (lo, hi) AABB tuple, or a (center, size)
        pair given as {"center": ..., "size": ...}. The camera distance is
        set from the bound radius and the fov (reference _peek_bb:647)."""
        if subject in ("scene", "stage"):
            lo = np.array([self._nav_lo[0], 0.0, self._nav_lo[1]])
            size = np.array([10.0, 3.0, 10.0])
            center = lo + size / 2
        elif isinstance(subject, dict):
            center = np.asarray(subject["center"], np.float64)
            size = np.asarray(subject["size"], np.float64)
        else:
            lo, hi = subject
            lo = np.asarray(lo, np.float64)
            hi = np.asarray(hi, np.float64)
            center, size = (lo + hi) / 2, hi - lo
        radius = float(np.linalg.norm(size) / 2) + 1e-3
        dist = radius / np.tan(np.deg2rad(self.hfov_deg) / 2)

        def frame_from(offset_dir):
            off = np.asarray(offset_dir, np.float64)
            off = off / (np.linalg.norm(off) + 1e-9)
            eye = center + off * (dist + radius)
            obs = self.render(eye=eye, target=center)
            img = np.array(obs["rgb"][..., :3], np.uint8, copy=True)
            self._overlay(img, debug_lines, debug_circles)
            return img

        if peek_all_axis:
            views = [
                frame_from(d)
                for d in ((1, 0.001, 0), (-1, 0.001, 0), (0.001, 1, 0),
                          (0.001, -1, 0), (0, 0.001, 1), (0, 0.001, -1))
            ]
            img = stitch_image_matrix(views, num_col=3)
        else:
            img = frame_from(cam_local_pos if cam_local_pos is not None else (0, 1, 1))
            # only single-view frames join the video reel (uniform size)
            self._frames.append(img)
        return DebugObservation(img)

    def _overlay(self, img, debug_lines, debug_circles) -> None:
        h, w = img.shape[:2]
        for pts, color in debug_lines or []:
            px = [
                project_point(self.eye, self.yaw, self.pitch, p, self.hfov_deg)
                for p in pts
            ]
            for a, b in zip(px[:-1], px[1:]):
                if a is not None and b is not None:
                    _draw_segment_px(
                        img, (a[0] * w, a[1] * h), (b[0] * w, b[1] * h), color
                    )
        for center, radius, _normal, color in debug_circles or []:
            p = project_point(self.eye, self.yaw, self.pitch, center, self.hfov_deg)
            if p is None:
                continue
            d = np.linalg.norm(np.asarray(center) - self.eye)
            tan_h = np.tan(np.deg2rad(self.hfov_deg) / 2)
            rp = max(2.0, radius / max(d * tan_h, 1e-6) * (w / 2))
            _draw_circle_px(img, p[0] * w, p[1] * h, rp, color)

    def peek_scene(self, height: float = 9.0) -> np.ndarray:
        """Bird's-eye rgb of the whole scene (compat with the round-1 API)."""
        return np.asarray(self.peek("scene").obs_data)

    # -- video ------------------------------------------------------------
    def make_debug_video(self, output_path: Optional[str] = None, prefix: str = "dbv") -> None:
        """The single-view frames as ``<output_path>/<prefix>.gif``."""
        from habitat_torch.utils.visualizations.utils import images_to_video

        if not self._frames:
            return
        images_to_video(self._frames, output_path or self.output_path, prefix)

    def clear(self) -> None:
        self._frames = []
