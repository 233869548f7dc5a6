"""habitat_torch's eval videos, debug images and TensorBoard frames
(``utils/visualizations/{utils,image_io}.py``, ``utils/common.py``,
``utils/tb.py``, ``sims/debug_visualizer.py``, ``baselines/evaluator.py``)
against habitat_tpu on the CPU. PIL, OpenCV and TensorBoard's event reader
are used here, on the test side only.

- ``tile_images``, ``draw_collision`` and ``observations_to_image`` (rgb,
  depth, semantic; with and without the top-down map of the port's
  ``TopDownMapTracker``) equal JAX's bit for bit, the map resized at the
  map sizes of the flagship's scenes (105x105) and of the mini dataset's
  (85x85) to frame heights 32 and 128 (JAX resizes with
  ``cv2.resize(..., INTER_NEAREST)``).
- ``images_to_video``: both packages write ``<name>.gif`` here (JAX through
  imageio's PIL fallback). Decoded with PIL, the port's file has JAX's frame
  count and size and a delay of ``round(100 / fps)`` centiseconds (JAX's
  frames carry none). Per channel, its mean absolute error against the
  source frames is at most JAX's own file's plus 1.0. Measured on the
  frames below (4 frames of 48x80, gradients with noise, > 256 colours
  each): per frame and channel the port's 3.84-4.52 against JAX's
  3.45-5.27, the largest single error 24 against JAX's 63. A frame of at
  most 256 colours comes back exact.
- ``DebugObservation``: ``get_image`` equals ``np.asarray`` of JAX's PIL
  image (uint8 rgb, float depth), and ``save`` writes a PNG whose pixels
  (decoded with PIL) equal JAX's saved file, with and without
  ``show_point``.
- ``generate_video`` names its file as JAX's does.
- ``evaluate_agent(video_option=("disk",), map_tracker=...)`` on
  tests/test_torch_evaluator.py's configuration (2 bench scenes, N=4, 32x32
  depth, the greedy pointgoal controller on both sides, which takes the
  same actions): the frames given to ``generate_video`` equal JAX's, and
  the one GIF written decodes to as many frames.
- The TensorBoard video, read back with TensorBoard's event reader, is a GIF
  of the frames at the step given; ``WeightsAndBiasesWriter`` raises
  ImportError naming wandb (not installed here).
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import habitat_tpu.utils.common as jcommon
from habitat_tpu.baselines.evaluator import evaluate_agent as jax_evaluate_agent
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.sims import debug_visualizer as jdbv
from habitat_tpu.utils.visualizations import maps as jmaps
from habitat_tpu.utils.visualizations import utils as jvis

import habitat_torch.utils.common as tcommon
from habitat_torch.baselines import evaluator as tev
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.sims import debug_visualizer as tdbv
from habitat_torch.sims.loaders import load_scene
from habitat_torch.utils.visualizations import maps as tmaps
from habitat_torch.utils.visualizations import utils as tvis

from tests.test_torch_evaluator import MAX_EP_STEPS, QUOTA, _jax_stub, _TorchStub
from tests.test_torch_evaluator import envs  # noqa: F401 - the module fixture
from tests.torch_jax_native import _jax_native  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS = 7  # delay 14 cs


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def map_frames():
    """Top-down map frames of the port's tracker on a flagship scene (the
    protocol's generator and seed) and on the mini dataset's scene, after a
    few poses."""
    flagship = make_procedural_pointnav(num_scenes=1, episodes_per_scene=1, seed=91_000)[0][0]
    mini = load_scene(os.path.join(ROOT, "tests/assets/mini_dataset/stages/mini_room_0.glb"))
    out = []
    for scene in (flagship, mini):
        tracker = tmaps.TopDownMapTracker(scene)
        lo = np.asarray(scene.nav_lo, np.float64)
        for k in range(4):
            tracker.update(np.array([lo[0] + 1.0 + 0.3 * k, 0.0, lo[1] + 1.5]), 0.4 * k)
        out.append(tracker.frame())
    assert [f.shape[:2] for f in out] == [(105, 105), (85, 85)]
    return out


def _obs(h, seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 256, (h, h, 3), dtype=np.uint8),
            "depth": rng.uniform(-0.2, 1.2, (h, h, 1)).astype(np.float32),
            "semantic": rng.integers(0, 9, (h, h, 1)).astype(np.int32)}


@pytest.mark.parametrize("h", [32, 128])
def test_frames_match_jax(h, map_frames):
    obs = _obs(h)
    for keys in (("rgb",), ("depth",), ("semantic",), ("rgb", "depth", "semantic"), ("depth", "rgb")):
        sub = {k: obs[k] for k in keys}
        np.testing.assert_array_equal(tvis.observations_to_image(sub, {}), jvis.observations_to_image(sub, {}))
        for td in map_frames:
            info = {"top_down_map": td}
            got = tvis.observations_to_image(sub, info)
            np.testing.assert_array_equal(got, jvis.observations_to_image(sub, info))
            assert got.shape[0] == h
    frames = [obs["rgb"], obs["rgb"][::-1].copy(), obs["rgb"][:, ::-1].copy()]
    for n in (1, 2, 3):
        np.testing.assert_array_equal(tvis.tile_images(frames[:n]), jvis.tile_images(frames[:n]))
    np.testing.assert_array_equal(tvis.draw_collision(obs["rgb"].copy()), jvis.draw_collision(obs["rgb"].copy()))
    with pytest.raises(NotImplementedError, match="cv2"):
        tvis.append_text_to_image(obs["rgb"], "text")


def _many_colour_frames(n=4, h=48, w=80):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for k in range(n):
        base = np.stack([(xx * 3 + 20 * k) % 256, yy * 5, (xx + yy + 40 * k) % 256], -1).astype(np.float64)
        out.append(np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8))
    return out


def _decode(path):
    im = Image.open(path)
    frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
    return frames, [f.info.get("duration") for f in ImageSequence.Iterator(Image.open(path))]


def test_gif_matches_jax_within_its_error(tmp_path):
    frames = _many_colour_frames()
    assert all(len(np.unique(f.reshape(-1, 3), axis=0)) > 256 for f in frames)
    tvis.images_to_video(frames, str(tmp_path / "t"), "a video", fps=FPS, verbose=False)
    jvis.images_to_video(frames, str(tmp_path / "j"), "a video", fps=FPS, verbose=False)
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == ["a_video.gif"]
    got, delays = _decode(tmp_path / "t" / "a_video.gif")
    ref, _ = _decode(tmp_path / "j" / "a_video.gif")
    assert len(got) == len(ref) == len(frames) and got[0].shape == ref[0].shape == frames[0].shape
    assert delays == [10 * round(100 / FPS)] * len(frames)
    err = lambda dec: np.stack([np.abs(d.astype(int) - f.astype(int)).mean((0, 1)) for d, f in zip(dec, frames)])  # noqa: E731
    assert (err(got) <= err(ref) + 1.0).all(), (err(got), err(ref))
    lossless = [frames[0] // 64 * 64]  # <= 256 colours keep their exact values
    tvis.images_to_video(lossless, str(tmp_path / "t"), "few", fps=FPS, verbose=False)
    np.testing.assert_array_equal(_decode(tmp_path / "t" / "few.gif")[0][0], lossless[0])


def test_debug_observation_png_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for data in (rng.integers(0, 256, (24, 40, 3), dtype=np.uint8), rng.random((24, 40, 1), dtype=np.float32)):
        for point in (None, np.array([0.3, 0.6])):
            t, j = tdbv.DebugObservation(data), jdbv.DebugObservation(data)
            if point is not None:
                t.show_point(point)
                j.show_point(point)
            np.testing.assert_array_equal(t.get_image(), np.asarray(j.get_image()))
            tp, jp = t.save(str(tmp_path / "t"), "dbg"), j.save(str(tmp_path / "j"), "dbg")
            assert tp.endswith(".png") and os.path.basename(tp).startswith("dbg")
            np.testing.assert_array_equal(np.asarray(Image.open(tp)), np.asarray(Image.open(jp)))


def test_generate_video_name_matches_jax(tmp_path):
    frames = _many_colour_frames(n=2)
    kw = dict(episode_id="env0", checkpoint_idx=3, metrics={"success": 1.0, "spl": 0.51234}, fps=FPS, verbose=False)
    tcommon.generate_video(["disk"], str(tmp_path / "t"), frames, **kw)
    jcommon.generate_video(["disk"], str(tmp_path / "j"), frames, **kw)
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == ["episode=env0-ckpt=3-success=1.00-spl=0.51.gif"]
    tcommon.generate_video(["disk"], str(tmp_path / "none"), [], **kw)
    assert not os.path.exists(tmp_path / "none")


def _recording(monkeypatch, module, log):
    generate = module.generate_video

    def record(video_option, video_dir, images, **kw):
        log.append([np.array(im) for im in images])
        return generate(video_option, video_dir, images, **kw)

    monkeypatch.setattr(module, "generate_video", record)


def test_evaluate_agent_video_matches_jax(envs, tmp_path, monkeypatch):  # noqa: F811
    jenv, tenv = envs[0](), envs[1]()
    jframes, tframes = [], []
    _recording(monkeypatch, jcommon, jframes)
    _recording(monkeypatch, tcommon, tframes)
    # the map of the first scene of the fixture's (env 0 starts there)
    jtracker = jmaps.TopDownMapTracker(jax_pointnav(num_scenes=2, episodes_per_scene=4, seed=4)[0][0])
    ttracker = tmaps.TopDownMapTracker(make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=4)[0][0])
    kw = dict(episodes_per_env=QUOTA, deterministic=True, seed=7, video_option=("disk",), checkpoint_idx=2)
    ref = jax_evaluate_agent(jenv, _jax_stub(), None, video_dir=str(tmp_path / "j"), map_tracker=jtracker, **kw)
    got = tev.evaluate_agent(tenv, _TorchStub(), video_dir=str(tmp_path / "t"), map_tracker=ttracker, **kw)
    assert {k: round(v, 5) for k, v in got.items()} == {k: round(v, 5) for k, v in ref.items()}
    assert len(tframes) == len(jframes) == 1 and len(tframes[0]) == len(jframes[0]) > QUOTA
    for k, (a, b) in enumerate(zip(tframes[0], jframes[0])):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    names = os.listdir(tmp_path / "t")
    assert names == os.listdir(tmp_path / "j") and len(names) == 1 and names[0].startswith("episode=env0-ckpt=2-")
    decoded, delays = _decode(tmp_path / "t" / names[0])
    assert len(decoded) == len(tframes[0]) and decoded[0].shape == tframes[0][0].shape and delays[0] == 100


class _PoseLog:
    """A map tracker that keeps the poses it is given and draws a fixed map."""

    def __init__(self):
        self.poses = []

    def update(self, pos, yaw):
        self.poses.append((np.array(pos), float(yaw)))

    def frame(self):
        return np.full((16, 16, 3), 7, np.uint8)

    def reset(self):
        pass


def test_evaluate_agent_video_at_an_odd_rgb_size(tmp_path, monkeypatch):
    """An 85x85 rgb frame (85*85*3 bytes, not a multiple of 4) ahead of the
    float depth and pose in the step's one host copy: every frame equals
    ``observations_to_image`` of the step's observation, and the tracker gets
    the step's pose."""
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=4)
    hw = {"height": 85, "width": 85}
    env = make_nav_env(scenes, episodes, precomputed_fields=fields, device="cpu", num_envs=2,
                       sensor_specs=(("HabitatSimRGBSensor", hw), ("HabitatSimDepthSensor", hw),
                                     ("PointGoalWithGPSCompassSensor", None)),
                       max_episode_steps=MAX_EP_STEPS)
    seen, step = [], env.step_fn

    def run(state, action):
        out = step(state, action)
        seen.append(({k: out[1][k][0].numpy().copy() for k in ("rgb", "depth")},
                     out[0].pos[0].numpy().copy(), float(out[0].yaw[0])))
        return out

    env.step_fn = run
    frames, tracker = [], _PoseLog()
    _recording(monkeypatch, tcommon, frames)
    tev.evaluate_agent(env, _TorchStub(), episodes_per_env=1, deterministic=True, seed=7,
                       video_option=("disk",), video_dir=str(tmp_path), map_tracker=tracker)
    (frames,) = frames
    assert len(frames) == len(tracker.poses) > 1
    for k, (frame, (obs, pos, yaw), (tpos, tyaw)) in enumerate(zip(frames, seen, tracker.poses)):
        want = tvis.observations_to_image(obs, {"top_down_map": np.full((16, 16, 3), 7, np.uint8)})
        np.testing.assert_array_equal(frame, want, err_msg=f"frame {k}")
        np.testing.assert_array_equal(tpos, pos)
        assert tyaw == np.float32(yaw)


def test_tensorboard_video_and_wandb(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from habitat_torch.utils.tb import TensorboardWriter, WeightsAndBiasesWriter

    frames = _many_colour_frames(n=3)
    with TensorboardWriter(str(tmp_path)) as w:
        w.add_video_from_np_images("episode0", 5, frames, fps=FPS)
    acc = EventAccumulator(str(tmp_path), size_guidance={"images": 0})
    acc.Reload()
    (event,) = acc.Images("episode0")
    assert (event.step, event.width, event.height) == (5, frames[0].shape[1], frames[0].shape[0])
    im = Image.open(io.BytesIO(event.encoded_image_string))
    assert im.format == "GIF" and getattr(im, "n_frames", 1) == 3 and im.info["duration"] == 10 * round(100 / FPS)
    with pytest.raises(ImportError, match="wandb"):
        WeightsAndBiasesWriter()
