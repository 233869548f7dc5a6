"""Image and video helpers (port of
``habitat_tpu/utils/visualizations/utils.py``; reference
habitat/utils/visualizations/utils.py).

- ``tile_images``, ``observations_to_image`` and ``draw_collision`` give the
  JAX package's arrays bit for bit. The top-down map is scaled to the
  frame's height by nearest neighbour with OpenCV's ``INTER_NEAREST`` source
  index, ``min(floor(x * (1 / (dst / src))), src - 1)`` in float64, written
  out in numpy (``_resize_nearest``).
- ``images_to_video`` writes ``<name>.gif`` through the port's own encoder
  (``image_io.encode_gif``), with the frame delay ``fps`` asks. The JAX
  package, on a machine without imageio's ffmpeg plugin, falls back to a GIF
  through PIL whose frames carry no delay.
- ``append_text_to_image`` draws with OpenCV's Hershey font
  (``cv2.putText``); it raises ``NotImplementedError`` until that font is
  ported. Nothing in either package calls it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from habitat_torch.utils.visualizations.image_io import write_gif


def tile_images(images: List[np.ndarray]) -> np.ndarray:
    """Tile N (H, W, C) images into one, row-major on a ceil(sqrt(N))-wide
    grid, the empty cells black (reference utils.py tile_images)."""
    assert len(images) > 0
    np_images = np.asarray(images)
    n, h, w, c = np_images.shape
    new_w = int(np.ceil(np.sqrt(n)))
    new_h = int(np.ceil(n / new_w))
    pad = np.zeros((new_w * new_h - n, h, w, c), np_images.dtype)
    np_images = np.concatenate([np_images, pad], axis=0)
    np_images = np_images.reshape(new_h, new_w, h, w, c)
    np_images = np_images.transpose(0, 2, 1, 3, 4)
    return np_images.reshape(new_h * h, new_w * w, c)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    inv_scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv_scale).astype(np.int64), src - 1)


def _resize_nearest(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=INTER_NEAREST)``."""
    rows = _nearest_index(image.shape[0], height)
    cols = _nearest_index(image.shape[1], width)
    return image[rows[:, None], cols[None, :]]


def observations_to_image(observation: Dict, info: Dict) -> np.ndarray:
    """The rgb, depth (clipped to [0, 1], gray) and semantic (a fixed random
    palette) observations side by side, or tiled when their sizes differ,
    then the top-down map of ``info`` scaled to the frame's height
    (reference utils.py observations_to_image)."""
    render_obs_images: List[np.ndarray] = []
    for sensor_name, ob in observation.items():
        if sensor_name == "rgb":
            render_obs_images.append(np.asarray(ob))
        elif sensor_name == "depth":
            d = np.clip(np.asarray(ob), 0, 1)
            render_obs_images.append((np.repeat(d, 3, axis=-1) * 255).astype(np.uint8))
        elif sensor_name == "semantic":
            s = np.asarray(ob)[..., 0]
            rng = np.random.default_rng(42)
            palette = rng.integers(0, 255, (int(s.max()) + 2, 3), dtype=np.uint8)
            render_obs_images.append(palette[s])
    assert render_obs_images, "no visual sensors to render"
    if len({x.shape for x in render_obs_images}) == 1:
        render_frame = np.concatenate(render_obs_images, axis=1)
    else:
        render_frame = tile_images(render_obs_images)

    if "top_down_map" in info and info["top_down_map"] is not None:
        td = np.asarray(info["top_down_map"])
        h = render_frame.shape[0]
        scale = h / td.shape[0]
        td = _resize_nearest(td, int(td.shape[1] * scale), h)
        render_frame = np.concatenate([render_frame, td], axis=1)
    return render_frame


def images_to_video(
    images: List[np.ndarray],
    output_dir: str,
    video_name: str,
    fps: int = 10,
    quality: Optional[float] = 5,
    verbose: bool = True,
) -> None:
    """Write the frames as ``<output_dir>/<video_name>.gif`` (spaces and
    newlines of the name become underscores), one frame every
    ``round(100 / fps)`` centiseconds. ``quality`` is
    accepted for the reference's signature (a GIF has no such setting)."""
    os.makedirs(output_dir, exist_ok=True)
    video_name = video_name.replace(" ", "_").replace("\n", "_")
    path = os.path.join(output_dir, video_name + ".gif")
    write_gif(path, images, fps=fps)
    if verbose:
        from habitat_torch.core.logging import logger

        logger.info(f"Video created: {path}")


def draw_collision(view: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Red border flash on collision, in place (reference utils.py
    draw_collision)."""
    strip_width = view.shape[0] // 20
    mask = np.ones(view.shape[:2], dtype=bool)
    mask[strip_width:-strip_width, strip_width:-strip_width] = 0
    view[mask] = (alpha * np.array([255, 0, 0]) + (1.0 - alpha) * view)[mask]
    return view


def append_text_to_image(image: np.ndarray, text: str) -> np.ndarray:
    """Not ported: the JAX package draws the text with OpenCV's Hershey font
    and anti-aliasing (``cv2.putText``), and the port has no OpenCV."""
    raise NotImplementedError(
        "append_text_to_image draws with cv2.putText's Hershey font (habitat_tpu/utils/visualizations/utils.py); "
        "it waits for a port of that font, since the card's machine has no cv2")
