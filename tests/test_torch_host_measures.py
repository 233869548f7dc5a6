"""habitat_torch's host-side measures and their utilities against
habitat_tpu's on the CPU.

- ``Env`` with TopDownMap, RuntimePerfStats and GfxReplayMeasure declared
  (tests/test_env_api.py's small procedural config) through the schedule of
  tests/test_torch_env_api.py: at every reset and step TopDownMap's
  {map, fog_of_war_mask, agent_map_coord} equal JAX's element for element
  and agent_angle within 1e-5, the fog never shrinks within an episode;
  RuntimePerfStats reports the same keys; GfxReplayMeasure is "" until the
  episode ends and then JSON of steps + 1 keyframes equal to JAX's (poses
  within 1e-5).
- ``reveal_fog_of_war`` from random poses and ``SceneData.world_to_cell``
  at and beside cell boundaries: equal to JAX's.
- ``TopDownMapTracker.frame()`` over the schedule: equal to JAX's frame,
  which draws with OpenCV. The port draws in numpy: its lines equal
  ``cv2.line``'s on random segments, and its filled triangles equal
  ``cv2.fillPoly``'s on random triangles inside the image. On triangles
  that leave the image OpenCV 5.0 differs in a way not reproduced: on
  random triangles with vertices up to 12 px outside a 5-40 px image about
  3% of the fills differ, by at most 31 px. The agent's marker (9 px from
  its centre at most) leaves the map only beside its edge, which the
  schedule's 63 frames never do: they are held equal, every pixel.
- ``write_gfx_replay`` / ``load_gfx_replay`` (plain and .gz), each reading
  the other's file; ``render_keyframe`` against JAX's on >= 99.9% of
  pixels (the frame rule of tests/test_torch_raycast.py).
"""

import json

import cv2
import numpy as np
import pytest

from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.config.default import read_write as jax_read_write
from habitat_tpu.config.omega import Config as JaxConfig
from habitat_tpu.core import env as jenv
from habitat_tpu.sims.procedural import generate_apartment as jax_apartment
from habitat_tpu.utils import gfx_replay as jgfx
from habitat_tpu.utils.visualizations import fog_of_war as jfog
from habitat_tpu.utils.visualizations import maps as jmaps

from habitat_torch.config.default import get_config
from habitat_torch.config.omega import Config, read_write
from habitat_torch.core.env import Env
from habitat_torch.sims.procedural import generate_apartment
from habitat_torch.utils import gfx_replay as tgfx
from habitat_torch.utils.timing import Timing, g_timer
from habitat_torch.utils.visualizations import fog_of_war as tfog
from habitat_torch.utils.visualizations import maps as tmaps

from tests.test_torch_env_api import CFG, SCHEDULE, SMALL
from tests.torch_jax_native import _jax_native  # noqa: F401


ATOL = 1e-5
HOST = {"top_down_map": "TopDownMap", "runtime_perf_stats": "RuntimePerfStats", "gfx_replay": "GfxReplayMeasure"}


def _with_host_measures(cfg, rw, config_cls):
    with rw(cfg) as c:
        for name, kind in HOST.items():
            c.habitat.task.measurements[name] = config_cls({"type": kind})
    return cfg


@pytest.fixture(scope="module")
def trajectory():
    """Per reset and step of the schedule: (JAX metrics, port metrics,
    JAX frame, port frame, steps in the episode)."""
    je = jenv.Env(_with_host_measures(jax_get_config(CFG, SMALL), jax_read_write, JaxConfig))
    te = Env(_with_host_measures(get_config(CFG, SMALL), read_write, Config), device="cpu")
    out = []

    def record():
        out.append((je.get_metrics(), te.get_metrics(), _tracker(je).frame(), _tracker(te).frame(),
                    te.elapsed_steps))

    for a in SCHEDULE:
        if te._current_episode is None or te.episode_over:
            je.reset(), te.reset()
            record()
        je.step(a), te.step(a)
        record()
    return out


def _tracker(env):
    return next(m for m in env._host_measures if m.uuid == "top_down_map")._tracker


def test_top_down_map_matches_jax(trajectory):
    prev_fog = None
    for k, (jm, tm, _, _, steps) in enumerate(trajectory):
        jt, tt = jm["top_down_map"], tm["top_down_map"]
        assert set(tt) == set(jt) == {"map", "fog_of_war_mask", "agent_map_coord", "agent_angle"}
        np.testing.assert_array_equal(tt["map"], jt["map"], err_msg=f"map@{k}")
        np.testing.assert_array_equal(tt["fog_of_war_mask"], jt["fog_of_war_mask"], err_msg=f"fog@{k}")
        assert tt["agent_map_coord"] == jt["agent_map_coord"], k
        assert abs(tt["agent_angle"] - jt["agent_angle"]) <= ATOL, k
        if steps and prev_fog is not None:
            assert (tt["fog_of_war_mask"] >= prev_fog).all(), k  # the fog never comes back
        prev_fog = tt["fog_of_war_mask"]
    assert prev_fog.sum() > 0 and (tt["map"] == tmaps.MAP_TARGET_POINT_INDICATOR).any()


def test_runtime_perf_stats_keys_match_jax(trajectory):
    for jm, tm, _, _, steps in trajectory:
        assert set(tm["habitat_perf"]) == set(jm["habitat_perf"]) == ({"step_ms"} if steps else set())
        assert all(v >= 0 for v in tm["habitat_perf"].values())
    timing = Timing()
    with timing.avg_time("render"):
        pass
    timing.add_time("render", 0.5)
    assert set(timing.todict()) == {"render"} and 0.25 <= timing["render"].mean <= 0.26
    assert isinstance(g_timer, Timing)


def test_gfx_replay_measure_matches_jax(trajectory):
    ends = 0
    for k, (jm, tm, _, _, steps) in enumerate(trajectory):
        jr, tr = jm["gfx_replay_keyframes_string"], tm["gfx_replay_keyframes_string"]
        if not jr:
            assert tr == "", k
            continue
        ends += 1
        jk, tk = json.loads(jr)["keyframes"], json.loads(tr)["keyframes"]
        assert len(tk) == len(jk) == steps + 1
        for a, b in zip(tk, jk):
            assert (a["index"], a["scene"]) == (b["index"], b["scene"])
            np.testing.assert_allclose(a["agent"]["position"], b["agent"]["position"], rtol=0, atol=ATOL)
            assert abs(a["agent"]["yaw"] - b["agent"]["yaw"]) <= ATOL
    assert ends == 4


def test_tracker_frames_match_jax(trajectory):
    assert len(trajectory) == 63
    for k, (_, _, jf, tf, _) in enumerate(trajectory):
        assert tf.dtype == np.uint8
        np.testing.assert_array_equal(tf, jf, err_msg=f"frame {k}")


def test_lines_and_triangles_match_opencv():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        h, w = (int(v) for v in rng.integers(5, 40, 2))
        p, q = rng.integers(-15, 55, 2), rng.integers(-15, 55, 2)
        want, got = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.line(want, (int(p[0]), int(p[1])), (int(q[0]), int(q[1])), 7, thickness=1)
        tmaps.draw_line(got, p, q, 7)
        np.testing.assert_array_equal(got, want)
        tri = rng.integers(0, 40, (3, 2))
        want, got = np.zeros((40, 40, 3), np.uint8), np.zeros((40, 40, 3), np.uint8)
        cv2.fillPoly(want, [tri.astype(np.int32)], (0, 0, 255))
        tmaps.fill_poly(got, tri, (0, 0, 255))
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def scenes():
    return generate_apartment(seed=3, extent=6.0), jax_apartment(seed=3, extent=6.0)


def test_fog_of_war_and_cells_match_jax(scenes):
    ts, js = scenes
    free = ts.nav_occ
    np.testing.assert_array_equal(tmaps.get_topdown_map(ts), jmaps.get_topdown_map(js))
    rng = np.random.default_rng(1)
    cells = np.argwhere(free)[rng.choice(free.sum(), 40)]
    tmask = jmask = np.zeros(free.shape, np.uint8)
    for c in cells:
        angle = float(rng.uniform(-np.pi, np.pi))
        tmask = tfog.reveal_fog_of_war(free, tmask, c, angle, fov=90.0, max_line_len=50.0)
        jmask = jfog.reveal_fog_of_war(free, jmask, c, angle, fov=90.0, max_line_len=50.0)
        np.testing.assert_array_equal(tmask, jmask)
    # world -> cell at cell boundaries (half a cell from a centre) and a float32 ulp either side
    lo, res = ts.nav_lo, ts.nav_res
    edge = lo + (cells[:, None, :] + 0.5) * res
    pts = np.concatenate([edge, np.nextafter(edge.astype(np.float32), np.inf), np.nextafter(
        edge.astype(np.float32), -np.inf)], axis=1).reshape(-1, 2)
    np.testing.assert_array_equal(ts.world_to_cell(pts), js.world_to_cell(pts))
    np.testing.assert_array_equal(tmaps.colorize_topdown_map(tmaps.get_topdown_map(ts), tmask),
                                  jmaps.colorize_topdown_map(jmaps.get_topdown_map(js), jmask))


def test_gfx_replay_files_and_render_match_jax(tmp_path, trajectory):
    text = next(tm["gfx_replay_keyframes_string"] for _, tm, _, _, _ in trajectory if tm["gfx_replay_keyframes_string"])
    for name in ("replay.json", "replay.json.gz"):
        tgfx.write_gfx_replay(text, str(tmp_path / "t" / name))
        jgfx.write_gfx_replay(text, str(tmp_path / "j" / name))
        assert tgfx.load_gfx_replay(str(tmp_path / "j" / name)) == jgfx.load_gfx_replay(
            str(tmp_path / "t" / name)) == json.loads(text)["keyframes"]
    te = Env(get_config(CFG, SMALL), device="cpu")
    je = jenv.Env(jax_get_config(CFG, SMALL))
    kf = json.loads(text)["keyframes"][-1]
    got = tgfx.render_keyframe(te.sim, kf, height=64, width=64)
    want = jgfx.render_keyframe(je.sim, kf, height=64, width=64)
    assert set(got) == set(want)
    assert (got["rgb"].numpy() == want["rgb"]).all(-1).mean() >= 0.999
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"], rtol=0, atol=1e-4)
    recorder = tgfx.GfxReplayRecorder(te.sim)
    te.reset()
    recorder.record(te._state)
    te.step(1)
    recorder.record(te._state)
    recorder.write(str(tmp_path / "rec.json.gz"))
    frames = tgfx.load_gfx_replay(str(tmp_path / "rec.json.gz"))
    assert [f["step"] for f in frames] == [0, 1]
    np.testing.assert_allclose(frames[1]["agent"]["position"], te._state.pos[0].tolist(), rtol=0, atol=1e-6)
