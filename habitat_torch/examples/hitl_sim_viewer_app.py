"""HITL sim_viewer analog (port of the JAX repository's
``examples/hitl_sim_viewer_app.py``): free-camera scene inspection with
WASD/QE fly, J/L look-at yaw, and scene cycling — no agent, no episodes
(reference examples/hitl/sim_viewer/sim_viewer.py: AppStateSimViewer's
lookat-pos movement keys W/S/E/Q/J/L and reconfigure_sim(dataset, scene)).

Keys: w/s = forward/back along the view direction, e/q = up/down,
j/l = yaw the look-at offset, tab = next scene, x = quit. Headless:
``main`` flies a scripted path through two scenes and renders 64x64 frames
with the port's ``render_batch`` on ``device`` (``None`` = cuda).

Run: python -m habitat_torch.examples.hitl_sim_viewer_app
"""

import numpy as np
import torch

from habitat_torch.hitl.app_states import AppState
from habitat_torch.hitl.hitl_main import HitlDriver
from habitat_torch.sims.tpu_sim import to_host


class AppStateSimViewer(AppState):
    """Scene viewer (reference AppStateSimViewer): a free look-at camera
    flown with move keys; no task/agent — the 'sim' is render-only."""

    def __init__(self, num_scenes: int = 2):
        self.service = None
        self.num_scenes = num_scenes
        self.scene_idx = 0
        self.cam_pos = np.array([0.0, 1.4, 0.0], np.float32)
        self.yaw = 0.0
        self.frames = 0
        self.scenes_viewed = [0]

    def bind(self, service):
        self.service = service

    def _move(self, gui):
        step = 0.1
        fwd = np.array([-np.sin(self.yaw), 0.0, -np.cos(self.yaw)], np.float32)
        if gui.get_key("w"):
            self.cam_pos += step * fwd
        if gui.get_key("s"):
            self.cam_pos -= step * fwd
        if gui.get_key("e"):
            self.cam_pos[1] += step
        if gui.get_key("q"):
            self.cam_pos[1] -= step
        if gui.get_key("j"):
            self.yaw += 0.1
        if gui.get_key("l"):
            self.yaw -= 0.1

    def sim_update(self, dt, post):
        gui = self.service.gui_input
        if gui.get_key_down("x"):
            post["application_exit"] = True
            return
        if gui.get_key_down("\t"):
            self.scene_idx = (self.scene_idx + 1) % self.num_scenes
            self.scenes_viewed.append(self.scene_idx)
            post["reconfigure_scene"] = self.scene_idx
        self._move(gui)
        post["camera_pos"] = self.cam_pos.copy()
        post["camera_yaw"] = self.yaw
        self.frames += 1
        td = self.service.text_drawer
        td.clear()
        td.add_text(
            f"scene {self.scene_idx}  cam {np.round(self.cam_pos, 2)}"
            f"  yaw {self.yaw:.2f}"
        )


class SceneOnlyAdapter:
    """Render-only 'env': reset/step produce frames at the app camera, one
    ``render_batch`` at N=1 and one host copy each."""

    def __init__(self, pack):
        self.pack = pack
        self.scene_idx = 0
        self.cam = np.array([4.0, 1.4, 4.0], np.float32)
        self.yaw = 0.0

    def reset(self):
        return self._frame()

    def step(self, action):
        return self._frame()

    def _frame(self):
        from habitat_torch.ops.raycast import render_batch

        dev = self.pack.tri_mat.device
        pose = torch.from_numpy(np.concatenate([self.cam, np.float32([self.yaw])]).astype(np.float32)).to(dev)
        out = render_batch(
            self.pack,
            torch.full((1,), self.scene_idx, dtype=torch.int64, device=dev),
            pose[None, :3],
            pose[3:4],
            torch.zeros((1,), dtype=torch.float32, device=dev),
            height=64,
            width=64,
        )
        return to_host({k: v[0] for k, v in out.items()})


def main(max_steps: int = 120, device=None):
    from habitat_torch.device import resolve_device
    from habitat_torch.sims.procedural import generate_apartment
    from habitat_torch.sims.scene import pack_scenes

    scenes = [generate_apartment(seed=s, extent=8.0) for s in range(2)]
    pack = pack_scenes(scenes).to(resolve_device(device))

    app = AppStateSimViewer(num_scenes=len(scenes))
    adapter = SceneOnlyAdapter(pack)
    driver = HitlDriver(app, env=adapter, record_video=False, target_sps=1e9)
    app.bind(driver.service)
    app.cam_pos = adapter.cam.copy()
    driver.reset()
    script = ["w"] * 20 + ["j"] * 8 + ["w"] * 10 + ["\t"] + ["w"] * 15 + ["l"] * 5 + ["\t"] + ["e"] * 3 + ["x"]
    rendered = []
    for i in range(min(max_steps, len(script))):
        k = script[i]
        if k:
            driver.gui_input.press(k)
        post = driver.step(1 / 30)
        if k:
            driver.gui_input.release(k)
        if "reconfigure_scene" in post:
            adapter.scene_idx = post["reconfigure_scene"]
        if "camera_pos" in post:
            adapter.cam = post["camera_pos"]
            adapter.yaw = post["camera_yaw"]
        obs = adapter.step(None)
        rendered.append(obs["rgb"])
        if post.get("application_exit"):
            break
    print("scenes viewed:", app.scenes_viewed, "frames:", len(rendered))
    assert len(set(app.scenes_viewed)) == 2
    # camera moved: first and last frames differ
    assert not np.array_equal(rendered[0], rendered[-1])
    return app, rendered


if __name__ == "__main__":
    main()
