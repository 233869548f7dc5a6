"""HITL basic_viewer analog (port of the JAX repository's
``examples/hitl_basic_viewer_app.py``): step through a dataset's episodes
with a free look-at camera, pause/single-step, and policy-driven playback
(reference examples/hitl/basic_viewer/basic_viewer.py: episode cycling via
episode_helper, pause '/SPACE semantics, camera_helper look-at orbit).

Keys: p = pause/resume, . = single step while paused, ] = next episode,
arrow keys (here j/l/i/k) orbit the look-at camera, q = quit. Headless:
``main`` runs a scripted viewing session over 3 episodes of the port's
``make_nav_env`` on ``device`` (``None`` = cuda).

Run: python -m habitat_torch.examples.hitl_basic_viewer_app
"""

import numpy as np
import torch

from habitat_torch.hitl.app_states import AppState
from habitat_torch.hitl.hitl_main import HitlDriver


class AppStateBasicViewer(AppState):
    """Episode viewer (reference AppStateBasicViewer): the agent replays a
    scripted/policy action stream; the user pauses, single-steps, orbits
    the camera, and jumps between episodes."""

    def __init__(self, episodes: int = 3, steps_per_episode: int = 40):
        self.service = None
        self.n_episodes = episodes
        self.steps_per_episode = steps_per_episode
        self.episode_idx = 0
        self._paused = False
        self._step_in_ep = 0
        self._orbit_yaw = 0.0
        self.seen_episodes = []

    def bind(self, service):
        self.service = service

    def on_environment_reset(self, _):
        self._step_in_ep = 0
        self.seen_episodes.append(self.episode_idx)

    def sim_update(self, dt, post):
        gui = self.service.gui_input
        if gui.get_key_down("q"):
            post["application_exit"] = True
            return
        if gui.get_key_down("p"):
            self._paused = not self._paused
        do_step = not self._paused or gui.get_key_down(".")
        if gui.get_key("j"):
            self._orbit_yaw -= 0.1
        if gui.get_key("l"):
            self._orbit_yaw += 0.1
        if gui.get_key_down("]") or self._step_in_ep >= self.steps_per_episode:
            self.episode_idx += 1
            if self.episode_idx >= self.n_episodes:
                post["application_exit"] = True
                return
            post["reset"] = True
            self.on_environment_reset(None)
            return
        if do_step:
            # simple forward-biased walk (stands in for the policy replay)
            a = 1 if (self._step_in_ep % 5) else 2
            post["action"] = np.array([a], np.int32)
            self._step_in_ep += 1
        td = self.service.text_drawer
        td.clear()
        td.add_text(
            f"episode {self.episode_idx} step {self._step_in_ep}"
            + (" [paused]" if self._paused else "")
        )
        post["camera_orbit_yaw"] = self._orbit_yaw


class EnvAdapter:
    """The HitlDriver's host env over a 1-env batched env: lane 0 of the
    observations, as tensors on the env's device."""

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


def main(max_steps: int = 200, device=None):
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    scenes, episodes, fields = make_procedural_pointnav(
        num_scenes=1, episodes_per_scene=4, seed=0
    )
    env = make_nav_env(
        scenes, episodes, num_envs=1, precomputed_fields=fields,
        max_episode_steps=100, device=device,
    )
    app = AppStateBasicViewer(episodes=3, steps_per_episode=20)
    adapter = EnvAdapter(env)
    driver = HitlDriver(app, env=adapter, record_video=False, target_sps=1000.0)
    app.bind(driver.service)
    driver.reset()
    script = (
        ["w"] * 5 + ["p"] + [None] * 3 + ["."] * 2 + ["p"]  # pause/step
        + ["j"] * 3 + ["]"]  # orbit + next episode
        + [None] * 25 + ["]"] + [None] * 25
    )
    for i in range(min(max_steps, len(script))):
        k = script[i]
        if k:
            driver.gui_input.press(k)
        post = driver.step(1 / 30)
        if k:
            driver.gui_input.release(k)
        if post.get("reset"):
            adapter.reset()
        if post.get("application_exit"):
            break
    print("episodes viewed:", app.seen_episodes)
    print("keyframes:", len(driver.keyframes))
    return app, driver


if __name__ == "__main__":
    main()
