"""Minimal HITL application: keyboard-driven PointNav with on-screen help
(port of the JAX repository's ``examples/hitl_minimal_app.py``).

Counterpart of the reference's HITL example apps (habitat-hitl/examples/
minimal/minimal_main.py and pick_throw_vr): an AppState maps GuiInput keys
to discrete nav actions, draws a line to the goal, and ends the episode on
success. Headless-friendly — a scripted GuiInput feed replaces a real
keyboard (the reference's GUI apps run the same callbacks under magnum; here
frames land in service.video_frames). The env is the port's ``Env`` on
``device`` (``None`` = cuda).

Run: python -m habitat_torch.examples.hitl_minimal_app
"""

import numpy as np

from habitat_torch.hitl.app_states import AppState
from habitat_torch.hitl.hitl_main import HitlDriver

KEY_TO_ACTION = {"w": 1, "a": 2, "d": 3, "space": 0}  # fwd / left / right / stop


class MinimalNavAppState(AppState):
    """reference minimal_main.py::AppStateMinimal — one action per frame."""

    def __init__(self, service=None):
        self.service = service
        self.steps = 0

    def bind(self, service):
        self.service = service
        return self

    def on_environment_reset(self, episode_recorder_dict) -> None:
        self.steps = 0
        if self.service is not None:
            self.service.text_drawer.add_text(
                "W: forward  A/D: turn  SPACE: stop", position="top_left"
            )

    def sim_update(self, dt: float, post_sim_update_dict) -> None:
        svc = self.service
        self.steps += 1
        action = None
        for key, act in KEY_TO_ACTION.items():
            if svc.gui_input.get_key_down(key):
                action = act
                break
        if action is None and svc.gui_input.get_key("w"):
            action = 1
        if action is not None:
            post_sim_update_dict["action"] = action
        # draw a guide line toward the goal when the env exposes it
        env = svc.env
        try:
            ep = env.current_episode
            agent = env.sim._state.pos[0] if hasattr(env.sim, "_state") else None
            if agent is not None and ep.goals:
                svc.line_render.draw_transformed_line(
                    agent.cpu().numpy(), np.asarray(ep.goals[0].position), (0, 255, 0)
                )
        except (AssertionError, AttributeError):
            pass
        metrics = env.get_metrics() if hasattr(env, "get_metrics") else {}
        if metrics.get("success", 0) > 0 or self.steps >= 60:
            post_sim_update_dict["application_exit"] = True


def main(max_steps: int = 60, device=None):
    from habitat_torch.config.default import get_config
    from habitat_torch.core.env import Env

    cfg = get_config(
        "benchmark/nav/pointnav/pointnav_procgen.yaml",
        overrides=["habitat.environment.max_episode_steps=50"],
    )
    env = Env(cfg, device=device)
    state = MinimalNavAppState()
    driver = HitlDriver(state, env=env, record_video=True)
    state.bind(driver.service)
    # scripted "user": hold W with occasional turns (a real GUI feeds the
    # same GuiInput from key events)
    driver.reset()
    for t in range(max_steps):
        driver.gui_input.press("w" if t % 7 else "a")
        post = driver.step(1.0 / 30.0)
        driver.gui_input.release("w"), driver.gui_input.release("a")
        if post.get("application_exit"):
            break
    print(
        f"hitl app ran {driver._step} frames, "
        f"{len(driver.service.video_frames)} video frames, "
        f"{len(driver.keyframes)} keyframes"
    )
    return driver


if __name__ == "__main__":
    main()
