"""The port's HITL apps (``habitat_torch/examples/``) against the JAX
repository's ``examples/`` on the CPU.

- ``hitl_minimal_app.main(max_steps=8)``: the keyframes equal JAX's (agent
  poses within 1e-6: the port's ``Env`` against JAX's on
  ``pointnav_procgen.yaml``).
- ``hitl_rearrange_v2_app.main``: the gzipped session record equals JAX's
  but for its wall-clock stamps, and the two-agent social-nav state at the
  end equals JAX's within 1e-5.
- ``hitl_pick_throw_app.main``: the grasp and throw events equal JAX's (the
  hand velocity rounded to 0.01 m/s, as the app records it) and every
  object's final position within 1e-3 m after the 80 contact steps (the
  thrown box's flight, tumble and settle run free, not teacher-forced).
- ``shortest_path_follower_example``: the follower's actions equal JAX's
  (``TpuSim`` on both, ``sim.seed(7)``), and its GIF is written.
- ``hitl_rearrange_app.main``: the keyframes (agent and humanoid poses,
  objects, joints, held object, message) equal those of JAX's app with its
  head camera within 1e-5, blind and with the port's 128x128 head camera;
  the head frame differs from JAX's on at most 1e-3 of its pixels. JAX's
  keyframes do not depend on the camera, so one JAX run serves both.
- ``hitl_basic_viewer_app.main``: the episodes seen and the 42 keyframes
  equal JAX's (poses within 1e-6). ``hitl_sim_viewer_app.main``: the scenes
  viewed and the camera's path equal JAX's, and its 64 frames differ from
  those of JAX's ``render_batch`` on at most 1e-3 of their pixels.
- ``interactive_play.main``: the status line equals JAX's, and the last
  observation within 1e-5.
- The rearrange_v2 session over the port's ``NetworkingServer`` with two
  real clients (tests/test_hitl.py's routing test): the lobby waits for both
  users, user 0's 'w' moves the robot, user 1's 'd' turns the humanoid in
  place, the session record lands with both users' steps.
"""

import gzip
import json
import threading
import time

import numpy as np
import pytest
import torch

from tests.torch_jax_native import _jax_native  # noqa: F401

PIXEL_GAP = 1e-3  # the share of pixels a port frame may differ from JAX's by (silhouette edges)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_tree_close(got, want, atol, where="keyframes"):
    """``got`` has ``want``'s structure and leaves: floats within ``atol``,
    everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_tree_close(got[k], want[k], atol, f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, atol, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= atol, f"{where}: {got} against {want}"
    else:
        assert type(got) is type(want) and got == want, f"{where}: {got!r} against {want!r}"


def _pixel_gap(got, want):
    """The share of pixels where two (..., H, W, 3) frames differ."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return float((got != want).any(-1).mean())


def _poses(keyframes):
    return np.array([kf["agent"]["position"] + kf["agent"]["rotation"] for kf in keyframes])


def test_minimal_app_keyframes_match_jax():
    from examples import hitl_minimal_app as japp

    from habitat_torch.examples import hitl_minimal_app as tapp

    want = japp.main(max_steps=8).keyframes
    got = tapp.main(max_steps=8, device="cpu").keyframes
    assert len(got) == len(want) == 8
    assert [{k: v for k, v in kf.items() if k != "agent"} for kf in got] == \
        [{k: v for k, v in kf.items() if k != "agent"} for kf in want]
    np.testing.assert_allclose(_poses(got), _poses(want), atol=1e-6)
    assert np.abs(np.diff(_poses(got)[:, [0, 2]], axis=0)).max() > 0.1  # the agent walked


def _record(path):
    with gzip.open(path, "rt") as f:
        rec = json.load(f)
    stamps = (rec.pop("session_start"), rec.pop("session_end"))
    assert stamps[0] <= stamps[1]
    return rec


def test_rearrange_v2_session_matches_jax(tmp_path):
    from examples import hitl_rearrange_v2_app as japp

    from habitat_torch.examples import hitl_rearrange_v2_app as tapp

    apps = []
    for mod, name, kw in ((japp, "jax", {}), (tapp, "port", {"device": "cpu"})):
        created = []
        init = mod.RearrangeV2App.__init__

        def keep(self, *a, _init=init, **k):
            _init(self, *a, **k)
            created.append(self)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod.RearrangeV2App, "__init__", keep)
            rec = mod.main(output_path=str(tmp_path / f"{name}.json.gz"), **kw)
        apps.append((rec, created[0]))
    (jrec, japp_), (trec, tapp_) = apps
    assert _record(tmp_path / "port.json.gz") == _record(tmp_path / "jax.json.gz")
    assert trec["finished"] and len(trec["episodes"]) == 2 and min(trec["episodes"][0]["user_steps"]) > 0
    for field in ("pos", "yaw", "human_pos", "human_yaw"):
        np.testing.assert_allclose(getattr(tapp_._state, field).numpy(), np.asarray(getattr(japp_._state, field)),
                                   atol=1e-5, err_msg=field)


def test_pick_throw_result_matches_jax():
    from examples import hitl_pick_throw_app as japp

    from habitat_torch.examples import hitl_pick_throw_app as tapp

    want = japp.main()
    got = tapp.main(device="cpu")
    assert [e[:3] for e in got.events] == [e[:3] for e in want.events]
    assert [tuple(map(float, e[3])) for e in got.events[1:]] == [tuple(map(float, e[3])) for e in want.events[1:]]
    np.testing.assert_allclose(got._obj_world(), np.asarray(want._obj_world()), atol=1e-3)


def test_follower_example_actions_match_jax(tmp_path):
    import examples.shortest_path_follower_example as jex
    from habitat_tpu.tasks.shortest_path_follower import ShortestPathFollower as JFollower

    from habitat_torch.examples import shortest_path_follower_example as tex

    want = []
    step = JFollower.get_next_action
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFollower, "get_next_action", lambda self, goal: want.append(step(self, goal)) or want[-1])
        jex.shortest_path_example(make_video=False)
    got = tex.shortest_path_example(device="cpu", output_dir=str(tmp_path))
    assert got == want and got[-1] == 0 and len(got) > 10
    assert (tmp_path / "shortest_path_example.gif").stat().st_size > 0


def test_viewer_apps_on_the_port():
    from examples import hitl_basic_viewer_app as jbasic
    from examples import hitl_sim_viewer_app as jsim

    from habitat_torch.examples import hitl_basic_viewer_app, hitl_sim_viewer_app

    japp, jdriver = jbasic.main()
    app, driver = hitl_basic_viewer_app.main(device="cpu")
    assert app.seen_episodes == japp.seen_episodes == [0, 1, 2] and len(driver.keyframes) == 42
    _assert_tree_close(driver.keyframes, jdriver.keyframes, 1e-6)
    japp, jframes = jsim.main()
    app, frames = hitl_sim_viewer_app.main(device="cpu")  # asserts its scenes and its moving camera
    assert app.scenes_viewed == japp.scenes_viewed == [0, 1, 0] and app.yaw == japp.yaw
    np.testing.assert_array_equal(app.cam_pos, japp.cam_pos)
    assert len(frames) == len(jframes) == 64 and frames[0].shape == (64, 64, 3)
    assert _pixel_gap(np.stack([np.asarray(f) for f in frames]), np.stack(jframes)) <= PIXEL_GAP


@pytest.fixture(scope="module")
def jax_rearrange():
    """JAX's rearrange app with its head camera, run once."""
    from examples import hitl_rearrange_app as japp

    return japp.main(record=True)


@pytest.mark.parametrize("record", [False, True], ids=["blind", "head-camera"])
def test_rearrange_app_on_the_port(jax_rearrange, record):
    from habitat_torch.examples import hitl_rearrange_app

    driver = hitl_rearrange_app.main(record=record, device="cpu")
    kf = driver.keyframes[-1]
    assert len(driver.keyframes) == 24 and len(kf["objects"]) == 3
    assert any(k["held_object"] >= 0 for k in driver.keyframes)
    assert set(kf) >= {"agent", "articulations", "held_object", "humanoid", "joints", "message", "objects"}
    _assert_tree_close(driver.keyframes, jax_rearrange.keyframes, 1e-5)
    if record:
        head = driver.service.get_observations()["robot_head_rgb"]
        assert head.shape == (128, 128, 3) and head.device.type == "cpu"
        want = np.asarray(jax_rearrange.service.get_observations()["robot_head_rgb"])
        assert _pixel_gap(head.numpy(), want) <= PIXEL_GAP


def test_interactive_play_on_the_port():
    from examples import interactive_play as jplay

    from habitat_torch.examples import interactive_play

    want = jplay.main(interactive=False)
    sess = interactive_play.main(interactive=False, device="cpu")
    assert sess.frames == want.frames == len(interactive_play.SCRIPTED)
    assert sess.status() == want.status() and sess.status().startswith(f"frame {sess.frames} joint[2] q=+0.50")
    assert sorted(sess.obs) == sorted(want.obs)
    for k in want.obs:
        np.testing.assert_allclose(sess.obs[k].numpy(), np.asarray(want.obs[k]), atol=1e-5, err_msg=k)


def test_rearrange_v2_routes_each_client_to_its_agent(tmp_path):
    from habitat_torch.examples.hitl_rearrange_v2_app import AppStateLobby, RearrangeV2App, _NullEnv
    from habitat_torch.hitl import websocket as ws
    from habitat_torch.hitl.hitl_main import HitlDriver, NetworkingServer

    out = str(tmp_path / "session.json.gz")
    app = RearrangeV2App(n_users=2, n_episodes=1, max_episode_steps=12, output_path=out, device="cpu")
    driver = HitlDriver(app, env=_NullEnv(), record_video=False, target_sps=1000.0)
    server = NetworkingServer(driver, port=0)
    app.server = server
    server.start()
    stop = threading.Event()

    def client(key):
        with ws.connect(f"ws://127.0.0.1:{server.port}") as c:
            while not stop.is_set():
                try:
                    c.recv(timeout=0.05)
                except TimeoutError:
                    pass
                c.send(json.dumps({"keys_down": [key], "keys_up": []}))
                time.sleep(0.01)

    try:
        driver.reset()
        driver.step(1 / 30)
        assert isinstance(app.state, AppStateLobby)
        t0 = threading.Thread(target=client, args=("w",), daemon=True)
        t0.start()
        deadline = time.time() + 10
        while len(server.user_inputs) < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert len(server.user_inputs) == 1
        t1 = threading.Thread(target=client, args=("d",), daemon=True)
        t1.start()
        deadline = time.time() + 30
        robot0 = human0 = None
        post = {}
        while time.time() < deadline:
            post = driver.step(1 / 30)
            if app._state is not None and robot0 is None:
                robot0 = app._state.pos[0].clone()
                human0 = (app._state.human_pos[0].clone(), float(app._state.human_yaw[0]))
            if post.get("application_exit"):
                break
            time.sleep(0.005)
    finally:
        stop.set()
        t0.join(5)
        t1.join(5)
        server.stop()
    assert post.get("application_exit")
    assert float((app._state.pos[0] - robot0).norm()) > 0.2
    assert abs(float(app._state.human_yaw[0]) - human0[1]) > 0.2
    assert float((app._state.human_pos[0] - human0[0]).norm()) < 1e-6
    with gzip.open(out, "rt") as f:
        rec = json.load(f)
    assert len(rec["users"]) == 2 and rec["finished"]
    assert rec["episodes"][0]["user_steps"][0] > 0 and rec["episodes"][0]["user_steps"][1] > 0
    assert all("1000" in r.get("ended", "1000") for r in server.connection_records.values())
