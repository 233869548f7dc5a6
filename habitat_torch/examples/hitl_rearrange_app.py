"""HITL rearrange app (port of the JAX repository's
``examples/hitl_rearrange_app.py``): a human drives the robot through a
pick-and-place episode with the keyboard while keyframes carry full
object/grasp state (reference examples/hitl/rearrange/ rearrange.py — the
canonical habitat-hitl sample app).

Keys: w = forward, a/d = turn, space = grab/release, q = quit.
Headless demo mode (no stdin): a scripted key feed drives one pick on the
port's batched rearrangement env on ``device`` (``None`` = cuda); with
``record=True`` each step renders the 128x128 head camera.

Run: python -m habitat_torch.examples.hitl_rearrange_app
"""

import numpy as np
import torch

from habitat_torch.hitl.app_states import AppState
from habitat_torch.hitl.hitl_main import HitlDriver


class AppStateRearrange(AppState):
    """Keyboard -> rearrange env actions + HUD text (reference
    AppStateRearrange in examples/hitl/rearrange/rearrange.py)."""

    def __init__(self, service=None):
        self.service = service
        self._status = ""

    def bind(self, service):
        self.service = service

    def on_environment_reset(self, episode_recorder_dict):
        self._status = "episode start"

    def sim_update(self, dt, post):
        gui = self.service.gui_input
        action = 0  # A_STOP semantics are ignored by 'empty' task
        if gui.get_key("w"):
            action = 1
        elif gui.get_key("a"):
            action = 2
        elif gui.get_key("d"):
            action = 3
        if gui.get_key_down("space"):
            action = 4  # grab/release
        if gui.get_key_down("q"):
            post["application_exit"] = True
        post["action"] = np.array([action], np.int32)
        td = self.service.text_drawer
        td.clear()
        td.add_text(f"status: {self._status}")


class EnvAdapter:
    """Thin host adapter: HitlDriver drives a 1-env batched rearrange env;
    observations are lane 0, as tensors on the env's device."""

    def __init__(self, env):
        self.env = env
        self._state = None

    def reset(self):
        self._state, obs = self.env.reset_fn()
        return {k: v[0] for k, v in obs.items()}

    def step(self, action):
        self._state, obs, r, d, info = self.env.step_fn(
            self._state, torch.as_tensor(action, device=self.env.device)
        )
        return {k: v[0] for k, v in obs.items()}


def make_env(record: bool = False, device=None):
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    return make_rearrange_env(
        num_envs=1,
        task="empty",
        with_visual=record,
        render_size=(128, 128) if record else None,
        n_rooms_per_axis=1,
        n_clutter=0,
        seed=0,
        grasp_distance=100.0,  # demo-friendly grab radius
        device=device,
    )


SCRIPT = ["w"] * 10 + ["space"] + ["a"] * 6 + ["w"] * 6 + ["space"]


def main(max_steps: int = 60, record: bool = False, device=None, env=None):
    """``env``: a ``make_env(record, device)`` env to drive instead of a
    new one."""
    app = AppStateRearrange()
    adapter = EnvAdapter(make_env(record, device) if env is None else env)
    driver = HitlDriver(app, env=adapter, record_video=record, target_sps=1000.0)
    app.bind(driver.service)

    # headless scripted session: walk forward, grab, turn, release
    driver.reset()
    for i in range(min(max_steps, len(SCRIPT))):
        driver.gui_input.press(SCRIPT[i])
        driver.step(1.0 / 30)
        driver.gui_input.release(SCRIPT[i])

    kf = driver.keyframes[-1]
    held_at_some_point = any(k.get("held_object", -1) >= 0 for k in driver.keyframes)
    print("steps:", len(driver.keyframes))
    print("final keyframe keys:", sorted(kf.keys()))
    print("objects in keyframe:", len(kf.get("objects", [])))
    print("held during session:", held_at_some_point)
    return driver


if __name__ == "__main__":
    main()
