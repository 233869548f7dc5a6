"""habitat_torch's HITL layer (``habitat_torch/hitl/``) against habitat_tpu's
on the CPU, and its websocket against the ``websockets`` package.

- ``unity_protocol``: the cases of tests/test_unity_protocol.py, one
  parametrised test, run through both packages on the same keyframes (poses
  drawn from numpy seeds): the outputs are equal as JSON.
- ``make_keyframe``, ``project_to_pixels`` and ``composite_lines`` over the
  port's and JAX's ``TpuSim`` (64x64 RGB + depth): keyframes equal; pixel
  coordinates within 1e-9 (both float64 numpy) on 512 seeded points; a
  composited frame equal to JAX's wherever the two renders agree, which is
  tests/test_torch_raycast.py's frame rule (RGB equal on >= 99.9% of pixels).
- ``HitlDriver`` running tests/test_hitl.py's drawing app on both sims: equal
  keyframes (the HUD text included) and recorded frames under the frame rule,
  the magenta circle in both.
- The controllers over the port's and JAX's continuous rearrangement env
  (``GuiRobotController`` servoing to a camera yaw from ``_state.yaw``,
  ``GuiHumanoidController`` walking to a hint from ``_state.human_yaw``,
  ``ControllerHelper`` composing both): the actions equal to 1e-6 and the
  poses to 1e-5 at each of 8 steps.
- ``RemoteClientState`` after the same 40 seeded messages: equal.
- ``BaselinesController`` with JAX weights carried across by
  ``models/convert.py`` (resnet9 over 32x32 depth + pointgoal, LSTM-32, both
  in float32, the JAX pool crediting every tie): JAX's action at each of 20
  acts, deterministic and sampled (JAX's key split per act and its
  ``categorical`` draw), a reset of the episode mask after act 10.
- The websocket (``hitl/websocket.py``) both ways: ``websockets.sync.client``
  against the port's server and the port's client against
  ``websockets.serve``: text messages of 125, 126, 65,535 and 65,536 bytes,
  a fragmented message each way, ping/pong and the close handshake; a
  binary message closes with 1003 and an unmasked client frame with 1002.
- ``NetworkingServer`` in Unity mode: the live session with a late joiner
  (client A on ``websockets``, client B on the port's client): B's first
  payload is a consolidated keyframe with A's whole creation set, the folded
  replicas agree, A's input steers the agent. No wall-clock rate is
  asserted here (``chip_smoke.py`` [hitl] gates it on the card). A
  malformed message ends only its own connection, which is recorded;
  ``stop()`` frees the port.
"""

import asyncio
import json
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.config.omega import Config as JConfig
from habitat_tpu.hitl import controllers as jctl
from habitat_tpu.hitl import hitl_main as jhm
from habitat_tpu.hitl import unity_protocol as jup
from habitat_tpu.sims.tpu_sim import TpuSim as JTpuSim

from habitat_torch.config.omega import Config as TConfig
from habitat_torch.hitl import controllers as tctl
from habitat_torch.hitl import hitl_main as thm
from habitat_torch.hitl import unity_protocol as tup
from habitat_torch.hitl import websocket as ws
from habitat_torch.hitl.app_states import AppState
from habitat_torch.models.convert import params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy
from habitat_torch.sims.tpu_sim import TpuSim as TTpuSim

from tests.torch_jax_native import _jax_native  # noqa: F401
from tests.test_torch_eqa_il import _random_params
from tests.test_torch_ppo import _flat, _jax_as

HW, HIDDEN = 32, 32
FRAME_AGREE = 0.999  # the frame rule of tests/test_torch_raycast.py


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sim_cfg(Config, hw=64):
    return Config({"agents_order": ["main_agent"], "agents": {"main_agent": {"sim_sensors": {
        "rgb": {"type": "HabitatSimRGBSensor", "height": hw, "width": hw},
        "depth": {"type": "HabitatSimDepthSensor", "height": hw, "width": hw}}}}})


def _json(x):
    return json.loads(json.dumps(x, default=float))


# -- unity_protocol ------------------------------------------------------------


def _internal_kf(rng, step=0, n_objs=2, yaw=None):
    return {"step": step, "id": step,
            "agent": {"position": [float(v) for v in rng.uniform(-5, 5, 3)],
                      "rotation": [float(rng.uniform(-np.pi, np.pi)) if yaw is None else yaw]},
            "objects": [{"id": i, "position": [float(v) for v in rng.uniform(-5, 5, 3)]} for i in range(n_objs)]}


def _case_schema(up, rng):
    return [up.to_gfx_keyframe(_internal_kf(rng), first=True), up.to_gfx_keyframe(_internal_kf(rng, 1))]


def _case_consolidate(up, rng):
    con = up.get_empty_keyframe()
    up.update_consolidated_keyframe(con, up.to_gfx_keyframe(_internal_kf(rng, n_objs=1), first=True))
    up.update_consolidated_keyframe(con, up.to_gfx_keyframe(_internal_kf(rng, 1, n_objs=1)))
    return con


def _case_deletion(up, rng):
    con = up.get_empty_keyframe()
    up.update_consolidated_keyframe(con, up.to_gfx_keyframe(_internal_kf(rng, n_objs=1), first=True))
    up.update_consolidated_keyframe(con, {"deletions": [up.OBJECT_KEY_BASE]})
    up.update_consolidated_keyframe(con, {"deletions": [999]})
    return con


def _case_late_joiner(up, rng):
    s = up.UnitySession()
    kfs = [s.ingest(_internal_kf(rng, i, n_objs=1)) for i in range(2)]
    first = s.payload_for_send(kfs, message={"serverTime": 1.0})
    kf3 = s.ingest(_internal_kf(rng, 2))
    return [first, s.payload_for_send([kf3], message={"serverTime": 2.0}), s.consolidated]


def _case_message(up, rng):
    internal = _internal_kf(rng)
    internal["message"] = {"texts": [["hello", [1, 1, 1, 1]]]}
    kf = up.to_gfx_keyframe(internal)
    return [kf, up.get_user_keyframe(kf, None)]


def _case_object_rotation(up, rng):
    yaw = float(rng.uniform(-np.pi, np.pi))
    xyzw = [0.0, float(np.sin(yaw / 2)), 0.0, float(np.cos(yaw / 2))]
    return up.to_gfx_keyframe({"objects": [{"id": 0, "position": [1, 0, 1], "rotation": xyzw},
                                           {"id": 1, "position": [2, 0, 2], "rotation": [yaw]},
                                           {"id": 2, "position": [3, 0, 3]}]})


def _case_id(up, rng):
    internal = _internal_kf(rng)
    internal["id"] = 41
    s = up.UnitySession()
    return [s.ingest(internal), s.consolidated]


def _case_parse(up, rng):
    msg = {"recentServerKeyframeId": int(rng.integers(100)),
           "avatar": {"root": {"position": rng.uniform(-1, 1, 3).tolist(), "rotation": [1, 0, 0, 0]},
                      "hands": [{"position": rng.uniform(-1, 1, 3).tolist(), "rotation": [1, 0, 0, 0]}] * 2},
           "input": {"buttonDown": ["0"], "buttonUp": [], "buttonHeld": ["2"]}}
    return [up.parse_client_state(msg), up.parse_client_state({})]


def _case_wrap(up, rng):
    kf = up.to_gfx_keyframe(_internal_kf(rng))
    return [up.wrap_keyframes([up.get_user_keyframe(kf, {"sceneChanged": True})]), up.get_user_keyframe(kf, None)]


def _case_xyzw_agent(up, rng):
    yaw = float(rng.uniform(-np.pi, np.pi))
    return up.to_gfx_keyframe({"agent": {"position": [0, 0, 0],
                                         "rotation": [0.0, float(np.sin(yaw / 2)), 0.0, float(np.cos(yaw / 2))]}})


def _case_humanoid(up, rng):
    internal = _internal_kf(rng)
    internal["humanoid"] = {"position": rng.uniform(-1, 1, 3).tolist(), "rotation": [0.3]}
    internal["joints"] = rng.uniform(-1, 1, 7).tolist()
    internal["articulations"] = [0.1, 0.2]
    return up.to_gfx_keyframe(internal, first=True)


UNITY_CASES = {f.__name__[6:]: f for f in (
    _case_schema, _case_consolidate, _case_deletion, _case_late_joiner, _case_message, _case_object_rotation,
    _case_id, _case_parse, _case_wrap, _case_xyzw_agent, _case_humanoid)}


@pytest.mark.parametrize("case", sorted(UNITY_CASES))
def test_unity_protocol_matches_jax(case):
    """Exact: both are the same host code on the same python floats."""
    seed = sorted(UNITY_CASES).index(case)
    want = UNITY_CASES[case](jup, np.random.default_rng(seed))
    got = UNITY_CASES[case](tup, np.random.default_rng(seed))
    assert _json(got) == _json(want)


# -- keyframes, projection and line compositing over TpuSim ---------------------


@pytest.fixture(scope="module")
def sims():
    """(JAX TpuSim, port TpuSim) on generate_apartment(seed=0), 64x64."""
    return JTpuSim(_sim_cfg(JConfig)), TTpuSim(_sim_cfg(TConfig), device="cpu")


def _frames_agree(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    return (got == want).all(-1).mean()


def test_keyframe_projection_and_lines_match_jax(sims):
    jsim, tsim = sims
    rng = np.random.default_rng(7)
    for s in (jsim, tsim):
        s.seed(3)
    jo, to = jsim.reset(), tsim.reset()
    for a in (1, 2, 1, 3, 1):
        jo, to = jsim.step(a), tsim.step(a)
    assert thm.make_keyframe(tsim, to, 5) == jhm.make_keyframe(jsim, jo, 5)
    cam = jsim._pos + np.float32([0.0, 1.25, 0.0])
    pts = cam + rng.uniform(-4, 4, (512, 3))
    for pitch in (0.0, 0.3):
        want = jhm.project_to_pixels(pts, cam, jsim._yaw, pitch, 64, 64)
        got = thm.project_to_pixels(pts, cam, tsim._yaw, pitch, 64, 64)
        np.testing.assert_allclose(got[0], want[0], atol=1e-9)
        np.testing.assert_allclose(got[1], want[1], atol=1e-9)
        np.testing.assert_array_equal(got[2], want[2])
    fwd = np.array([-np.sin(jsim._yaw), 0.0, -np.cos(jsim._yaw)])
    lines = [(cam + fwd * 1.5 + rng.uniform(-1, 1, 3), cam + fwd * 3 + rng.uniform(-1, 1, 3), (255, 0, 255))
             for _ in range(6)]
    want = jhm.composite_lines(np.asarray(jo["rgb"]), lines, cam, jsim._yaw, 0.0)
    got = thm.composite_lines(to["rgb"], lines, cam, tsim._yaw, 0.0)
    assert _frames_agree(got, want) >= FRAME_AGREE
    drawn = (want != np.asarray(jo["rgb"])).any(-1)
    assert drawn.sum() > 20 and (got[drawn] == want[drawn]).all()


class DrawApp(AppState):
    """tests/test_hitl.py's drawing app: a magenta circle 1.5 m ahead,
    a HUD line, turning left; exits after 3 updates."""

    def __init__(self):
        self.updates, self.service = 0, None

    def on_environment_reset(self, _):
        pass

    def sim_update(self, dt, post):
        self.updates += 1
        svc = self.service
        pos = np.asarray(svc.sim.get_agent_state().position)
        yaw = float(svc.sim._yaw)
        fwd = np.array([-np.sin(yaw), 0.0, -np.cos(yaw)])
        svc.line_render.draw_circle(pos + fwd * 1.5 + np.array([0.0, 1.25, 0.0]), 0.4, color=(255, 0, 255))
        svc.text_drawer.add_text("hello hitl")
        post["action"] = "turn_left" if self.updates % 2 else "move_forward"
        if self.updates >= 3:
            post["application_exit"] = True


def test_driver_keyframes_and_frames_match_jax(sims, tmp_path):
    drivers = []
    for hm, sim in zip((jhm, thm), sims):
        sim.seed(5)
        app = DrawApp()
        driver = hm.HitlDriver(app, env=sim, target_sps=1000.0)
        app.service = driver.service
        driver.run(max_steps=5)
        drivers.append(driver)
    jd, td = drivers
    assert _json(td.keyframes) == _json(jd.keyframes) and len(td.keyframes) == 3
    assert td.keyframes[0]["message"]["texts"] == [("hello hitl", "top_left")]
    assert len(td.service.video_frames) == len(jd.service.video_frames) == 3
    for got, want in zip(td.service.video_frames, jd.service.video_frames):
        assert _frames_agree(got, np.asarray(want)) >= FRAME_AGREE
        magenta = (got[..., 0] > 200) & (got[..., 2] > 200) & (got[..., 1] < 60)
        assert magenta.sum() >= 10
    td.export_keyframes(str(tmp_path / "kf.json"))
    td.save_video(str(tmp_path), "session")
    with open(tmp_path / "kf.json") as f:
        assert json.load(f)["keyframes"] == _json(td.keyframes)
    assert (tmp_path / "session.gif").exists()


def test_driver_builds_tpu_sim_on_the_device():
    driver = thm.HitlDriver(DrawApp(), device="cpu", record_video=False)
    assert isinstance(driver._env, TTpuSim) and driver._env.device == torch.device("cpu")


# -- controllers over the rearrangement env ------------------------------------


def test_controllers_match_jax():
    from habitat_tpu.hitl.app_states import GuiInput as JGui
    from habitat_tpu.tasks.rearrange.generator import make_rearrange_env as jmake

    from habitat_torch.hitl.app_states import GuiInput as TGui
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env as tmake

    kw = dict(num_envs=1, task="empty", with_visual=False, control="continuous", n_rooms_per_axis=1, n_clutter=0,
              seed=0)
    jenv, tenv = jmake(**kw), tmake(**kw, device="cpu")
    jstep = jax.jit(jenv.step_fn)

    class Holder:  # the app-side env object the controllers read ``_state`` from
        _state = None

    runs = []
    for ctl, Gui, env, reset, step in ((jctl, JGui, jenv, lambda: jenv.reset_fn(jax.random.PRNGKey(0)),
                                        lambda s, a: jstep(s, jnp.asarray(a))),
                                       (tctl, TGui, tenv, tenv.reset_fn, lambda s, a: tenv.step_fn(s, torch.tensor(a)))):
        gui, holder = Gui(), Holder()
        helper = ctl.ControllerHelper(holder, gui, n_agents=2, gui_controlled_agent_index=0,
                                      agent_action_dims=[3, 3])
        human = ctl.GuiHumanoidController(1, True, gui, num_actions=3)
        helper.controllers[1] = human
        holder._state, obs = reset()
        acts, poses = [], []
        gui.press("w")
        for t in range(8):
            helper.get_gui_agent_controller().set_act_hints(None, None, None, None, cam_yaw=0.4 * t)
            human.set_act_hints(np.array([np.cos(t), 0.0, np.sin(t)]), 0.5, 2 if t == 3 else None,
                                np.zeros(3) if t == 6 else None)
            a = helper.update(obs)
            acts.append(np.stack([a["agent_0"], a["agent_1"]]))
            holder._state, obs, *_ = step(holder._state, a["agent_0"][None])
            gui.on_frame_end()
            st = holder._state
            poses.append(np.concatenate([np.asarray(st.pos[0]), np.asarray(st.yaw)[:1]]))
        runs.append((np.stack(acts), np.stack(poses)))
    (ja, jp), (ta, tp) = runs
    assert np.abs(ja[:, 0, 1]).max() > 0.05 and set(ja[:, 1, 2]) == {-1.0, 0.0, 1.0}
    np.testing.assert_allclose(ta, ja, atol=1e-6)
    np.testing.assert_allclose(tp, jp, atol=1e-5)


def test_remote_client_state_matches_jax():
    rng = np.random.default_rng(2)
    msgs = []
    for i in range(40):
        m = {"recentServerKeyframeId": i}
        if rng.uniform() < 0.7:
            m["avatar"] = {"root": {"position": rng.uniform(-1, 1, 3).tolist()},
                           "hands": [{"position": rng.uniform(-1, 1, 3).tolist()}]}
        if rng.uniform() < 0.3:
            m["pointer"] = {"origin": rng.uniform(-1, 1, 3).tolist()}
        msgs.append(m)
    states = []
    for hm in (jhm, thm):
        cs = hm.RemoteClientState()
        for m in msgs:
            cs.update(m)
        states.append(_json(vars(cs)) | {"heads": [cs.get_head_pose(i) for i in range(40)]})
    assert states[1] == states[0]
    assert states[1]["recent_server_keyframe_id"] == 39 and len(states[1]["recent_events"]) == 32


# -- BaselinesController --------------------------------------------------------


@pytest.fixture(scope="module")
def policies():
    """(JAX policy, its params, the port's state dict) for a resnet9 over
    32x32 depth + pointgoal with an LSTM-32, both in float32."""
    from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
    from habitat_tpu.models.rnn_state_encoder import initial_hidden_state

    with _jax_as("float32", all_ties=True):
        jpol = jax_policy(4, backbone="resnet9", hidden_size=HIDDEN)
        obs0 = {k: jnp.asarray(v)[None] for k, v in _obs(np.random.default_rng(0)).items()}
        h0 = initial_hidden_state(1, HIDDEN, jpol.net.num_recurrent_layers, jpol.net.rnn_type)
        params = _random_params(jpol, obs0, h0, jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), seed=4)
    return jpol, params, params_from_jax(_flat(params["params"]))


def _obs(rng):
    return {"depth": rng.uniform(0, 1, (HW, HW, 1)).astype(np.float32),
            "pointgoal_with_gps_compass": np.array([rng.uniform(0.5, 5), rng.uniform(-3, 3)], np.float32)}


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "sampled"])
def test_baselines_controller_matches_jax(policies, deterministic):
    jpol, params, state_dict = policies
    rng = np.random.default_rng(11)
    seq = [_obs(rng) for _ in range(20)]
    with _jax_as("float32", all_ties=True):
        jc = jhm.BaselinesController(jpol, params, deterministic=deterministic)
        want = []
        for i, o in enumerate(seq):
            if i == 10:
                jc.on_environment_reset()
            want.append(jc.act(o))
    port = make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                                       hidden_size=HIDDEN, dtype=torch.float32, device="cpu")
    tc = thm.BaselinesController(port, state_dict, deterministic=deterministic)
    got = []
    for i, o in enumerate(seq):
        if i == 10:
            tc.on_environment_reset()
        got.append(tc.act(o))
    assert got == want and len(set(want)) > 1, (got, want)
    np.testing.assert_allclose(tc._hidden.numpy(), np.asarray(jc._hidden), atol=1e-5)


# -- the websocket ---------------------------------------------------------------

LENGTHS = (125, 126, 65535, 65536)


class PortServer:
    """The port's ``serve`` in a thread with an echo handler; the close
    codes its connections end with."""

    def __init__(self):
        self.closes, self._stop, ready = [], threading.Event(), threading.Event()

        async def handler(conn):
            while True:
                try:
                    msg = await conn.recv(timeout=0.05)
                except TimeoutError:
                    if self._stop.is_set():
                        return
                    continue
                except ws.ConnectionClosed as e:
                    self.closes.append(e.code)
                    return
                await conn.send(msg)

        async def main():
            async with ws.serve(handler, "127.0.0.1", 0) as server:
                self.port = server.port
                ready.set()
                while not self._stop.is_set():
                    await asyncio.sleep(0.02)

        self._thread = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
        self._thread.start()
        assert ready.wait(10)

    def stop(self):
        self._stop.set()
        self._thread.join(10)
        assert not self._thread.is_alive()


def test_websockets_client_against_port_server():
    from websockets.sync.client import connect

    from websockets.exceptions import ConnectionClosedError

    server = PortServer()
    try:
        with connect(f"ws://127.0.0.1:{server.port}", open_timeout=10) as c:
            for n in LENGTHS:
                c.send("x" * n)
                assert c.recv(timeout=10) == "x" * n
            c.send(["frag", "mented ", "message"])  # a fragmented client message
            assert c.recv(timeout=10) == "fragmented message"
            assert c.ping(b"hitl").wait(10)
        assert server.closes == [1000]  # the client's close handshake reached the server
        with connect(f"ws://127.0.0.1:{server.port}", open_timeout=10) as c:
            c.send(bytes(range(256)))  # binary messages are not part of the session
            with pytest.raises(ConnectionClosedError) as e:
                c.recv(timeout=10)
        assert e.value.rcvd.code == ws.CLOSE_UNSUPPORTED and server.closes == [1000, ws.CLOSE_UNSUPPORTED]
    finally:
        server.stop()


def test_port_client_against_websockets_server():
    import websockets

    seen, ready, stop = [], threading.Event(), threading.Event()

    async def echo(conn):
        async for msg in conn:
            seen.append(len(msg))
            await conn.send(["ab", "cd", "ef"] if msg == "fragments" else msg)

    async def main():
        async with websockets.serve(echo, "127.0.0.1", 0) as server:
            seen.append(server.sockets[0].getsockname()[1])
            ready.set()
            while not stop.is_set():
                await asyncio.sleep(0.02)

    t = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
    t.start()
    assert ready.wait(10)
    try:
        c = ws.connect(f"ws://127.0.0.1:{seen[0]}")
        for n in LENGTHS:
            c.send("y" * n)
            assert c.recv(10) == "y" * n
        c.send("fragments")  # the server answers with a fragmented message
        assert c.recv(10) == "abcdef"
        c.ping(b"hitl")
        with pytest.raises(TimeoutError):
            c.recv(0.05)
        c.close()
        with pytest.raises(ws.ConnectionClosed):
            c.recv(1)
        assert seen[1:] == [*LENGTHS, 9]
    finally:
        stop.set()
        t.join(10)


def test_unmasked_client_frame_fails_the_connection():
    server = PortServer()
    try:
        c = ws.connect(f"ws://127.0.0.1:{server.port}")
        c._sock.sendall(ws.encode_frame(ws.OP_TEXT, b"not masked", mask=False))
        with pytest.raises(ws.ConnectionClosed) as e:
            c.recv(10)
        assert e.value.code == ws.CLOSE_PROTOCOL_ERROR
    finally:
        server.stop()
    assert server.closes == [ws.CLOSE_PROTOCOL_ERROR]


# -- the networking server ---------------------------------------------------------


class SteerApp(AppState):
    """Client 'w' input drives the agent forward (tests/test_hitl.py)."""

    def __init__(self):
        self.service = None

    def on_environment_reset(self, _):
        pass

    def sim_update(self, dt, post):
        if self.service.gui_input.get_key("w"):
            post["action"] = "move_forward"


def test_unity_live_session_with_late_joiner():
    """tests/test_hitl.py's live session on the port's server, 32x32 CPU
    renders, client A on ``websockets`` and the late joiner B on the port's
    client; the folded replicas, the late joiner's consolidated keyframe and
    the steering are held, the wall-clock rate is not."""
    from websockets.sync.client import connect

    app = SteerApp()
    driver = thm.HitlDriver(app, env=TTpuSim(_sim_cfg(TConfig, 32), device="cpu"), target_sps=60.0,
                            record_video=False)
    app.service = driver.service
    server = thm.NetworkingServer(driver, port=0, unity=True)
    server.start()
    folds = {"A": tup.get_empty_keyframe(), "B": tup.get_empty_keyframe()}
    first_payload, counts, stop = {}, {"A": 0, "B": 0}, threading.Event()

    def client(tag, conn, send_input):
        sent = False
        with conn:
            while not stop.is_set():
                try:
                    payload = json.loads(conn.recv(timeout=0.25))
                except TimeoutError:
                    continue
                kfs = payload.get("keyframes", [])
                if kfs and tag not in first_payload:
                    first_payload[tag] = kfs
                for kf in kfs:
                    tup.update_consolidated_keyframe(folds[tag], kf)
                    counts[tag] += 1
                # ack the newest keyframe that carries an id (the consolidated
                # keyframe sent before the driver's first has none; a null
                # ack is a malformed message, which ends the connection)
                ids = [kf["id"] for kf in kfs if "id" in kf]
                out = {"recentServerKeyframeId": ids[-1]} if ids else {}
                if send_input and not sent and counts[tag] > 5:
                    out["input"] = {"buttonDown": ["w"], "buttonUp": []}
                    sent = True
                conn.send(json.dumps(out))

    url = f"ws://127.0.0.1:{server.port}"
    ta = threading.Thread(target=client, args=("A", connect(url, open_timeout=10), True), daemon=True)
    ta.start()
    tb = threading.Thread(target=lambda: (time.sleep(0.6), client("B", ws.connect(url), False)), daemon=True)
    tb.start()
    driver.run(max_steps=120)
    time.sleep(0.5)  # drain the last sends
    stop.set()
    ta.join(5)
    tb.join(5)
    server.stop()
    assert counts["A"] > 60 and counts["B"] > 10, counts
    b0 = first_payload["B"][0]
    assert len(b0.get("creations", [])) > 0
    assert {c["instanceKey"] for c in b0["creations"]} == {c["instanceKey"] for c in folds["A"]["creations"]}
    assert json.dumps(folds["A"]["stateUpdates"], sort_keys=True) == json.dumps(folds["B"]["stateUpdates"],
                                                                                  sort_keys=True)
    assert server.user_inputs[0].get_key("w") and not server.user_inputs[1].get_key("w")
    p_first = np.asarray(driver.keyframes[5]["agent"]["position"])
    p_last = np.asarray(driver.keyframes[-1]["agent"]["position"])
    assert np.linalg.norm(p_last - p_first) > 0.2, (p_first, p_last)
    assert all("ended" not in r or "1000" in r["ended"] for r in server.connection_records.values())


MALFORMED = {"not json": ("{not json", "JSONDecodeError"),
             "null ack": ('{"recentServerKeyframeId": null}', "TypeError"),
             "not an object": ("[1, 2]", "AttributeError")}


@pytest.mark.parametrize("kind", sorted(MALFORMED))
def test_malformed_message_ends_only_its_connection(kind):
    message, error = MALFORMED[kind]
    driver = thm.HitlDriver(SteerApp(), env=object(), record_video=False)
    server = thm.NetworkingServer(driver, port=0)
    server.start()
    port = server.port
    try:
        bad, good = ws.connect(f"ws://127.0.0.1:{port}"), ws.connect(f"ws://127.0.0.1:{port}")
        deadline = time.time() + 10
        while len(server.user_inputs) < 2 and time.time() < deadline:
            time.sleep(0.01)
        bad.send(message)
        with pytest.raises(ws.ConnectionClosed):
            bad.recv(10)
        good.send(json.dumps({"keys_down": ["k"]}))
        deadline = time.time() + 10
        while not server.user_inputs[1].get_key("k") and time.time() < deadline:
            time.sleep(0.01)
        assert server.user_inputs[1].get_key("k")
        assert error in server.connection_records[0]["ended"]
        assert "ended" not in server.connection_records[1]
        good.close()
    finally:
        server.stop()
    with socket.socket() as s:  # stop() closed the listening socket (closed connections may sit in TIME_WAIT)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        taken = thm.NetworkingServer(driver, port=s.getsockname()[1])
        with pytest.raises(RuntimeError, match="could not listen"):
            taken.start()
