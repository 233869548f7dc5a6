"""HITL driver loop (port of ``habitat_tpu/hitl/hitl_main.py``; reference
habitat-hitl/habitat_hitl/core/hitl_main.py + _internal/lab_driver.py): glue
config → env → AppState at a target SPS.

This engine is headless (no GL window): frames render through the port's
raycast kernels; the loop records video and/or serves keyframes to a remote
client over a websocket (reference _internal/networking/networking_process.py
— same JSON keyframe wire, Unity/VR client compatible at the transport
level). The 30 SPS interactive target (habitat-hitl/README.md:28) is paced by
the driver.

What differs from the JAX module:

- ``make_keyframe`` reads lane 0 of a batched env's device state in one host
  copy; observations given as tensors are copied to the host where a frame
  is recorded.
- ``HitlDriver(env=None, device=None)`` builds ``TpuSim(None)`` on
  ``device`` (``None`` = cuda).
- ``BaselinesController`` runs the port's policy, on the card as a CUDA
  graph; its sampled actions are JAX's draws (a Threefry key ``PRNGKey(0)``
  split at every act, ``utils/threefry.py``'s Gumbel noise).
- ``NetworkingServer`` serves on ``hitl/websocket.py`` (standard library
  only). Its receive loop catches only the receive timeout: a malformed
  message or a closed socket ends that connection, which is logged and
  recorded in ``connection_records[user]["ended"]``. ``start()`` raises
  when the server cannot listen, and ``stop()`` closes the server and joins
  its thread, so that the port is free again.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from habitat_torch.core.logging import logger
from habitat_torch.hitl.app_states import (
    AppService,
    AppState,
    DebugLineRender,
    GuiInput,
    TextDrawer,
)
from habitat_torch.utils import threefry

# lane-0 fields of a batched env state a keyframe carries, in copy order
_KEYFRAME_FIELDS = ("pos", "yaw", "obj_pos", "art_q", "held", "joints", "human_pos", "human_yaw")


def _lane0(dev_state) -> Dict[str, np.ndarray]:
    """Lane 0 of the state's keyframe fields on the host, in one copy
    (concatenated in float64, which holds float32 and the held index
    exactly)."""
    parts = {k: getattr(dev_state, k)[0] for k in _KEYFRAME_FIELDS if hasattr(dev_state, k)}
    flat = torch.cat([v.reshape(-1).to(torch.float64) for v in parts.values()]).cpu().numpy()
    out, at = {}, 0
    for k, v in parts.items():
        n = v.numel()
        out[k] = flat[at:at + n].astype(np.float32 if v.is_floating_point() else np.int64).reshape(tuple(v.shape))
        at += n
    return out


def make_keyframe(sim, obs: Dict[str, Any], step: int) -> Dict[str, Any]:
    """gfx-replay-style keyframe (reference keyframe wire format,
    _internal/networking/keyframe_utils.py): agent pose + OBJECT states +
    articulation joint states + grasp state, no mesh payload — enough for a
    remote client to replay a full rearrange episode."""
    dev_state = getattr(sim, "_state", None)
    if dev_state is None:
        dev_state = getattr(sim, "state", None)
    lane = _lane0(dev_state) if dev_state is not None else {}
    if hasattr(sim, "get_agent_state"):
        state = sim.get_agent_state()
        position, rotation = state.position, np.atleast_1d(state.rotation)
    elif dev_state is not None:
        # host Env wraps a 1-env BatchedEnv: read lane 0 of the device state
        position = lane["pos"]
        rotation = np.atleast_1d(lane["yaw"])
    else:
        position, rotation = np.zeros(3), np.zeros(1)
    kf: Dict[str, Any] = {
        "step": step,
        # wire id the client echoes back as recentServerKeyframeId
        # (reference keyframe_utils.get_empty_keyframe / networking ack)
        "id": step,
        "agent": {
            "position": [float(x) for x in position],
            "rotation": [float(x) for x in rotation],
        },
    }
    if dev_state is not None:
        if "obj_pos" in lane:
            kf["objects"] = [
                {"id": i, "position": [float(x) for x in p]}
                for i, p in enumerate(lane["obj_pos"])
            ]
        if "art_q" in lane:
            kf["articulations"] = [float(q) for q in lane["art_q"]]
        if "held" in lane:
            kf["held_object"] = int(lane["held"])
        if "joints" in lane:
            kf["joints"] = [float(q) for q in lane["joints"]]
        if "human_pos" in lane:
            kf["humanoid"] = {
                "position": [float(x) for x in lane["human_pos"]],
                "rotation": [float(lane["human_yaw"])],
            }
    return kf


def project_to_pixels(
    pts: np.ndarray,
    cam_pos: np.ndarray,
    yaw: float,
    pitch: float,
    h: int,
    w: int,
    hfov_rad: float = np.pi / 2,
):
    """World points -> (row, col) pixel coords + visibility mask under the
    renderer's pinhole model (utils/geometry.camera_rays conventions: camera
    at cam_pos, looks along -z at yaw=0, pitch about camera +x)."""
    d = np.asarray(pts, np.float64) - np.asarray(cam_pos, np.float64)
    cyw, syw = np.cos(yaw), np.sin(yaw)
    # inverse yaw (about +y), then inverse pitch (about +x)
    x = cyw * d[..., 0] - syw * d[..., 2]
    z1 = syw * d[..., 0] + cyw * d[..., 2]
    cp, sp = np.cos(pitch), np.sin(pitch)
    y = cp * d[..., 1] + sp * z1
    z = -sp * d[..., 1] + cp * z1
    vis = z < -1e-6
    zs = np.where(vis, z, -1.0)
    fx = np.tan(hfov_rad / 2.0)
    aspect = h / w
    xn = x / (-zs)
    yn = y / (-zs)
    col = (xn / fx + 1.0) * (w - 1) / 2.0
    row = (1.0 - yn / (fx * aspect)) * (h - 1) / 2.0
    return row, col, vis


def composite_lines(
    frame: np.ndarray,
    lines,
    cam_pos: np.ndarray,
    yaw: float,
    pitch: float,
    samples: int = 64,
) -> np.ndarray:
    """Rasterize accumulated DebugLineRender segments into an (H,W,3) RGB
    frame (the reference draws them via GL into the viewport; headless here,
    so they land in the recorded video/eval frames)."""
    if not lines:
        return frame
    out = np.array(frame)
    h, w = out.shape[:2]
    t = np.linspace(0.0, 1.0, samples)[:, None]
    for a, b, color in lines:
        pts = np.asarray(a)[None] * (1 - t) + np.asarray(b)[None] * t
        row, col, vis = project_to_pixels(pts, cam_pos, yaw, pitch, h, w)
        ri = np.round(row).astype(int)
        ci = np.round(col).astype(int)
        ok = vis & (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
        out[ri[ok], ci[ok]] = np.asarray(color, out.dtype)
    return out


class HitlDriver:
    """reference _internal/lab_driver.py / sim_driver.py. ``env=None``
    builds ``TpuSim(None)`` on ``device`` (``None`` = cuda)."""

    def __init__(
        self,
        app_state: AppState,
        env=None,
        target_sps: float = 30.0,
        record_video: bool = True,
        device=None,
    ):
        if env is None:
            from habitat_torch.sims.tpu_sim import TpuSim

            env = TpuSim(None, device=device)
        self._env = env
        self._sim = getattr(env, "sim", env)
        self.app_state = app_state
        self.target_sps = target_sps
        self.record_video = record_video
        self.gui_input = GuiInput()
        self._obs = None
        self.service = AppService(
            config=None,
            env=env,
            sim=self._sim,
            gui_input=self.gui_input,
            line_render=DebugLineRender(),
            text_drawer=TextDrawer(),
            get_observations=lambda: self._obs,
        )
        self.keyframes: List[Dict[str, Any]] = []
        self._step = 0

    def reset(self):
        self._obs = self._env.reset()
        self.app_state.on_environment_reset(None)

    def step(self, dt: float) -> Dict[str, Any]:
        post: Dict[str, Any] = {}
        self.app_state.sim_update(dt, post)
        if "action" in post:
            self._obs = self._env.step(post["action"])
        kf = make_keyframe(self._env, self._obs, self._step)
        # text HUD rides the keyframe message channel (reference keyframes
        # carry a message dict for the client UI)
        if self.service.text_drawer.texts:
            kf["message"] = {"texts": list(self.service.text_drawer.texts)}
        self.keyframes.append(kf)
        if self.record_video and self._obs is not None and "rgb" in self._obs:
            frame = self._obs["rgb"]
            frame = frame.cpu().numpy() if torch.is_tensor(frame) else np.asarray(frame)
            lines = self.service.line_render.lines
            if lines:
                # composite debug lines through the sim camera (pos + 1.25m
                # head height, current yaw/pitch — TpuSim render model)
                sim = self._sim
                pos = np.asarray(getattr(sim, "_pos", np.zeros(3)))
                frame = composite_lines(
                    frame,
                    lines,
                    pos + np.array([0.0, 1.25, 0.0]),
                    float(getattr(sim, "_yaw", 0.0)),
                    float(getattr(sim, "_pitch", 0.0)),
                )
            self.service.video_frames.append(frame)
        self.service.line_render.clear()
        self.service.text_drawer.clear()
        self.gui_input.on_frame_end()
        self._step += 1
        return post

    def run(self, max_steps: int = 300) -> None:
        self.reset()
        frame_time = 1.0 / self.target_sps
        for _ in range(max_steps):
            t0 = time.time()
            post = self.step(frame_time)
            if post.get("application_exit", False):
                break
            elapsed = time.time() - t0
            if elapsed < frame_time:
                time.sleep(frame_time - elapsed)

    def save_video(self, output_dir: str, name: str = "hitl_session") -> None:
        if self.service.video_frames:
            from habitat_torch.utils.visualizations.utils import images_to_video

            images_to_video(self.service.video_frames, output_dir, name, fps=int(self.target_sps))

    def export_keyframes(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"keyframes": self.keyframes}, f)


def hitl_main(config, create_app_state_lambda: Callable, max_steps: int = 300, device=None):
    """Entry point (reference hitl_main.py): builds the env from config and
    runs the driver on ``device`` (``None`` = cuda)."""
    from habitat_torch.sims.tpu_sim import TpuSim

    app_state = create_app_state_lambda(None)
    driver = HitlDriver(app_state, env=TpuSim(None, device=device))
    driver.run(max_steps=max_steps)
    return driver


class RemoteClientState:
    """Latest state received from a remote client (reference
    _internal/networking/remote_client_state.py): head/hand poses for VR
    avatars, pointer ray, and the per-frame input event history."""

    HISTORY_LEN = 32

    def __init__(self):
        self.head_pose: Optional[Dict[str, Any]] = None
        self.hand_poses: List[Dict[str, Any]] = []
        self.pointer: Optional[Dict[str, Any]] = None
        self.connected: bool = False
        self.recent_events: List[Dict[str, Any]] = []
        # newest-server-keyframe id the client has acknowledged receiving
        # (reference get_recent_server_keyframe_id; the wire key is
        # recentServerKeyframeId) — lets the server measure client lag and
        # garbage-collect its keyframe backlog
        self.recent_server_keyframe_id: Optional[int] = None

    def update(self, msg: Dict[str, Any]) -> None:
        self.connected = True
        if "avatar" in msg:
            av = msg["avatar"]
            self.head_pose = av.get("root")
            self.hand_poses = av.get("hands", [])
        if "pointer" in msg:
            self.pointer = msg["pointer"]
        if "recentServerKeyframeId" in msg:
            self.recent_server_keyframe_id = int(msg["recentServerKeyframeId"])
        self.recent_events.append(msg)
        del self.recent_events[: -self.HISTORY_LEN]

    # history accessors (reference remote_client_state.py:128-175;
    # single-user here — the reference indexes per user)
    def get_history_length(self) -> int:
        return len(self.recent_events)

    def get_recent_client_state_by_history_index(
        self, history_index: int = 0
    ) -> Optional[Dict[str, Any]]:
        if history_index >= len(self.recent_events):
            return None
        return self.recent_events[-(1 + history_index)]

    def get_head_pose(self, history_index: int = 0) -> Optional[Dict[str, Any]]:
        cs = self.get_recent_client_state_by_history_index(history_index)
        if not cs or "avatar" not in cs:
            return None
        return cs["avatar"].get("root")


class BaselinesController:
    """Policy-driven GUI agent (reference environment/controllers/
    baselines_controller.py): runs a trained policy for one agent inside the
    HITL loop while the human drives another (or observes).

    ``policy`` is a port ``ActorCritic`` on its device; ``params``, if given,
    is a state dict loaded into it. Actions are the argmax with
    ``deterministic``, else JAX's ``categorical`` draws: the key
    ``PRNGKey(0)`` is split at every act (as the JAX controller does, also
    when deterministic) and its Gumbel noise added to the logits. ``logits``
    holds the last act's (float32).

    On the card the forward runs as a CUDA graph, captured at the first act
    (and again if the observations' keys or shapes change) and replayed on
    copies of each act's inputs: at batch 1 the policy's few hundred
    kernels take less time on the device than their launches take on the
    host, and an interactive loop pays that host time every frame."""

    def __init__(self, policy, params=None, num_envs: int = 1, deterministic: bool = True):
        if params is not None:
            policy.load_state_dict(params)
        self.policy = policy.eval()
        self.params = params
        self.deterministic = deterministic
        self.device = policy.critic.weight.device
        self._hidden = policy.initial_hidden(num_envs)
        self._prev_a = torch.zeros((num_envs,), dtype=torch.int32, device=self.device)
        self._not_done = torch.zeros((num_envs,), dtype=torch.float32, device=self.device)
        self._key = threefry.prng_key(0)
        self.logits = None
        self._graph = None  # (signature, CUDA graph, static inputs, static outputs)

    def _forward(self, obs_b: Dict[str, torch.Tensor]):
        """(logits, new hidden) of one step of the policy."""
        state = (self._hidden, self._prev_a, self._not_done)
        if self.device.type != "cuda":
            logits, _, hidden = self.policy(obs_b, *state)
            return logits, hidden
        keys = sorted(obs_b)
        inputs = [obs_b[k] for k in keys] + list(state)
        sig = (tuple(keys), tuple((t.shape, t.dtype) for t in inputs))
        if self._graph is None or self._graph[0] != sig:
            static = [t.clone() for t in inputs]

            def run():
                return self.policy(dict(zip(keys, static)), *static[len(keys):])

            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):  # warm-up before capture, as CUDA graphs require
                run()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run()
            self._graph = (sig, graph, static, out)
        _, graph, static, out = self._graph
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        return out[0], out[2]

    @torch.no_grad()
    def act(self, obs: Dict[str, Any]):
        obs_b = {
            k: torch.as_tensor(v, device=self.device)[None]
            if np.ndim(v) < 2 or k not in ("rgb", "depth")
            else torch.as_tensor(v, device=self.device)[None]
            for k, v in obs.items()
        }
        self._key, k = threefry.split(self._key)
        if not self.deterministic:
            noise = torch.from_numpy(threefry.gumbel(k, (1, self.policy.net.num_actions)))
            noise = noise.to(self.device, non_blocking=True)
        logits, self._hidden = self._forward(obs_b)
        self.logits = logits.float().clone()  # on the card, the graph's output buffer is rewritten by the next act
        a = (self.logits if self.deterministic else self.logits + noise).argmax(-1).to(torch.int32)
        self._prev_a = a
        self._not_done = torch.ones_like(self._not_done)
        return int(a[0])

    def on_environment_reset(self):
        self._not_done = torch.zeros_like(self._not_done)


# -- networking (reference _internal/networking/networking_process.py) -----


class NetworkingServer:
    """Websocket keyframe server for remote (e.g. Unity VR) clients.

    Serves JSON keyframes and receives client input events; the transport
    mirrors the reference's wire model, on ``hitl/websocket.py``. The server
    runs an asyncio loop in a background thread. ``port=0`` binds a free
    port, which ``start()`` writes back to ``port``.
    """

    def __init__(
        self,
        driver: HitlDriver,
        host: str = "127.0.0.1",
        port: int = 8888,
        unity: bool = False,
    ):
        self.driver = driver
        self.host = host
        self.port = port
        self.unity = unity  # speak the Unity/VR gfx-replay wire schema
        self._thread = None
        self._stop = False
        self._error: Optional[BaseException] = None
        self.client_state = RemoteClientState()
        self.client_lag = 0  # keyframes sent but not yet acked
        # multi-user input routing (reference habitat_hitl.core.user_mask
        # Users/Mask: each connection owns a user index and its own input
        # lane; rearrange_v2-style apps read per-user GuiInput here while
        # single-user apps keep the merged driver.gui_input)
        self.user_inputs: Dict[int, GuiInput] = {}
        self.connection_records: Dict[int, Dict[str, Any]] = {}
        self._next_user = 0

    async def _handler(self, ws) -> None:
        user_idx = self._next_user
        self._next_user += 1
        self.user_inputs[user_idx] = GuiInput()
        self.connection_records[user_idx] = {"connection_id": user_idx}
        try:
            await self._serve_user(ws, user_idx)
        except Exception as e:  # ends this connection only; recorded and logged
            self.connection_records[user_idx]["ended"] = repr(e)
            logger.warning(f"HITL connection {user_idx} ended: {e!r}")

    async def _serve_user(self, ws, user_idx: int) -> None:
        from habitat_torch.hitl.unity_protocol import (
            UnitySession,
            get_empty_keyframe,
            parse_client_state,
            update_consolidated_keyframe,
        )

        idx = 0
        # Unity clients get the gfx-replay schema with the late-joiner
        # consolidated-first-keyframe rule; a session ingests EVERY
        # driver keyframe (including those before this connection).
        session = UnitySession() if self.unity else None
        # Per-connection flow control (reference
        # is_okay_to_send_keyframes): once the client falls more than
        # MAX_LAG keyframes behind its last recentServerKeyframeId ack,
        # incrementals are coalesced into a catch-up keyframe instead of
        # growing an unbounded send backlog.
        MAX_LAG = 20
        conn_ack = None  # latest ack from THIS client
        sent_hwm = -1  # highest keyframe id sent on this connection
        catchup = None  # coalesced keyframe accumulated while blocked
        while not self._stop:
            kfs = self.driver.keyframes[idx:]
            idx += len(kfs)
            if session is not None:
                inc = [session.ingest(kf) for kf in kfs]
                blocked = conn_ack is not None and sent_hwm - conn_ack > MAX_LAG
                if blocked and not session.needs_consolidated_keyframe:
                    if inc:
                        if catchup is None:
                            catchup = get_empty_keyframe()
                        for kf in inc:
                            update_consolidated_keyframe(catchup, kf)
                else:
                    if catchup is not None or len(inc) > MAX_LAG:
                        # coalesce the backlog (post-block catch-up OR an
                        # oversized per-poll burst) into one keyframe:
                        # the client needs creations + latest state, not
                        # every intermediate pose
                        ck = catchup or get_empty_keyframe()
                        for kf in inc:
                            update_consolidated_keyframe(ck, kf)
                        inc, catchup = [ck], None
                    if inc or session.needs_consolidated_keyframe:
                        payload = session.payload_for_send(inc)
                        for kf in payload["keyframes"]:
                            sent_hwm = max(sent_hwm, kf.get("id", -1))
                        await ws.send(json.dumps(payload))
            elif kfs:
                for kf in kfs:
                    sent_hwm = max(sent_hwm, kf.get("id", -1))
                await ws.send(json.dumps({"keyframes": kfs}))
            try:
                msg = await ws.recv(timeout=0.03)
            except TimeoutError:
                continue
            data = json.loads(msg)
            for key in data.get("keys_down", []):
                self.driver.gui_input.press(key)
                self.user_inputs[user_idx].press(key)
            for key in data.get("keys_up", []):
                self.driver.gui_input.release(key)
                self.user_inputs[user_idx].release(key)
            # Unity client-state schema: input buttons ride
            # data["input"] (reference remote_client_state.py:274)
            _, _, inp = parse_client_state(data)
            if inp:
                for key in inp.get("buttonDown", []):
                    self.driver.gui_input.press(key)
                    self.user_inputs[user_idx].press(key)
                for key in inp.get("buttonUp", []):
                    self.driver.gui_input.release(key)
                    self.user_inputs[user_idx].release(key)
            # client->server state channel (avatar poses, pointer,
            # keyframe ack — reference remote_client_state.py)
            self.client_state.update(data)
            ack = self.client_state.recent_server_keyframe_id
            if ack is not None:
                conn_ack = ack
                self.client_lag = len(self.driver.keyframes) - 1 - ack

    async def _main(self, ready: threading.Event) -> None:
        from habitat_torch.hitl import websocket

        async with websocket.serve(self._handler, self.host, self.port) as server:
            self.port = server.port
            ready.set()
            while not self._stop:
                await asyncio.sleep(0.05)

    def start(self):
        ready = threading.Event()

        def run():
            try:
                asyncio.run(self._main(ready))
            except BaseException as e:  # handed to start() or stop()
                self._error = e
            finally:
                ready.set()

        self._stop = False
        self._thread = threading.Thread(target=run, name="hitl-networking", daemon=True)
        self._thread.start()
        ready.wait()
        if self._error is not None:
            raise RuntimeError(f"HITL networking server could not listen on {self.host}:{self.port}: "
                               f"{self._error!r}") from self._error
        logger.info(f"HITL networking server on ws://{self.host}:{self.port}")

    def stop(self, timeout: float = 10.0):
        """Close the server and its connections and join its thread."""
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"HITL networking server thread still running {timeout} s after stop()")
            self._thread = None
        if self._error is not None:
            raise RuntimeError(f"HITL networking server failed: {self._error!r}") from self._error

