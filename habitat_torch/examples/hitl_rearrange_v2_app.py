"""HITL rearrange_v2-style session app (port of the JAX repository's
``examples/hitl_rearrange_v2_app.py``): multi-USER collaborative rearrange
driven through a session state machine (reference examples/hitl/rearrange_v2:
lobby -> start_session -> load_episode -> rearrange -> end_session, with a
SessionRecorder written at the end and per-user input routing — session.py,
session_recorder.py, app_state_*.py).

Two users each drive their own agent of a two-agent env (user 0 = robot,
user 1 = humanoid) through their OWN GuiInput lane (NetworkingServer
user_inputs — reference habitat_hitl.core.user_mask routing). Headless:
the tests drive two real websocket clients; ``main`` runs a scripted
two-user session on ``device`` (``None`` = cuda).

The JAX app resets an episode with ``reset_fn(jax.random.PRNGKey(idx))``;
its social-nav env draws nothing from that key (the reset takes each env's
first scheduled episode and only carries the key in the state), so the
port's ``reset_fn()`` starts the same episode.

Run: python -m habitat_torch.examples.hitl_rearrange_v2_app
"""

import gzip
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from habitat_torch.hitl.app_states import AppState, GuiInput
from habitat_torch.hitl.hitl_main import HitlDriver


class Session:
    """A fixed set of users working through a fixed set of episodes
    (reference rearrange_v2/session.py:14-40)."""

    def __init__(self, episode_indices: List[int], connection_records: Dict[int, dict]):
        self.episode_indices = list(episode_indices)
        self.current_episode_index = 0
        self.connection_records = dict(connection_records)
        self.finished = False
        self.error = ""
        self.session_recorder: Dict[str, Any] = {
            "users": [
                {"connection_record": cr} for cr in connection_records.values()
            ],
            "episodes": [],
            "session_start": time.time(),
        }

    def record_episode(self, metrics: Dict[str, Any]) -> None:
        self.session_recorder["episodes"].append(metrics)

    def write(self, path: str) -> None:
        self.session_recorder["session_end"] = time.time()
        self.session_recorder["finished"] = self.finished
        self.session_recorder["error"] = self.error
        with gzip.open(path, "wt") as f:
            json.dump(self.session_recorder, f)


class AppStateBase(AppState):
    """State-machine node (reference rearrange_v2/app_state_base.py): each
    state runs until it names a successor via get_next_state()."""

    def __init__(self, app):
        self.app = app

    def get_next_state(self) -> Optional["AppStateBase"]:
        return None

    def on_enter(self) -> None:
        pass

    def sim_update(self, dt, post) -> None:
        pass


class AppStateLobby(AppStateBase):
    """Wait until the session's user count is connected
    (reference app_state_lobby.py)."""

    def sim_update(self, dt, post):
        self.app.hud(f"lobby: {self.app.num_users()} / {self.app.n_users} users")

    def get_next_state(self):
        if self.app.num_users() >= self.app.n_users:
            return AppStateStartSession(self.app)
        return None


class AppStateStartSession(AppStateBase):
    """Snapshot connection records into a Session
    (reference app_state_start_session.py)."""

    def on_enter(self):
        self.app.session = Session(
            list(range(self.app.n_episodes)), self.app.connection_records()
        )

    def get_next_state(self):
        return AppStateLoadEpisode(self.app)


class AppStateLoadEpisode(AppStateBase):
    """Advance to the session's next episode, or end the session
    (reference app_state_load_episode.py)."""

    def on_enter(self):
        s = self.app.session
        if s.current_episode_index >= len(s.episode_indices):
            s.finished = True
        else:
            self.app.reset_episode(s.episode_indices[s.current_episode_index])

    def get_next_state(self):
        if self.app.session.finished:
            return AppStateEndSession(self.app)
        return AppStateRearrangeV2(self.app)


class AppStateRearrangeV2(AppStateBase):
    """The collaborative episode: each user's OWN input lane drives their
    agent (reference rearrange_v2.py — GuiRobotController for the robot
    user, GuiHumanoidController for the human user). Keys per user:
    w = forward, a/d = turn; 'n' (any user) ends the episode."""

    def on_enter(self):
        self._steps = 0
        self._moved = [0, 0]

    def sim_update(self, dt, post):
        acts = []
        done = False
        for u in range(self.app.n_users):
            gui = self.app.user_input(u)
            a = 0
            if gui.get_key("w"):
                a = 1
            elif gui.get_key("a"):
                a = 2
            elif gui.get_key("d"):
                a = 3
            if gui.get_key_down("n"):
                done = True
            if a:
                self._moved[u] += 1
            acts.append(a)
            gui.on_frame_end()
        post["action"] = torch.tensor([acts], dtype=torch.int32, device=self.app.env.device)  # (1 env, n_agents)
        self._steps += 1
        self.app.hud(
            f"episode {self.app.session.current_episode_index} "
            f"step {self._steps} moved {self._moved}"
        )
        if done or self._steps >= self.app.max_episode_steps:
            self.app.session.record_episode(
                {
                    "episode_index": self.app.session.current_episode_index,
                    "steps": self._steps,
                    "user_steps": list(self._moved),
                }
            )
            self.app.session.current_episode_index += 1
            self._finished = True

    def get_next_state(self):
        if getattr(self, "_finished", False):
            return AppStateLoadEpisode(self.app)
        return None


class AppStateEndSession(AppStateBase):
    """Write the session record and exit (reference
    app_state_end_session.py + session_recorder.py)."""

    def sim_update(self, dt, post):
        out = self.app.output_path
        if out:
            self.app.session.write(out)
        post["application_exit"] = True


class RearrangeV2App:
    """Host-side app shell: owns the state machine, the two-agent env, and
    the per-user input lanes (server-backed when networked, local GuiInput
    lanes otherwise)."""

    def __init__(
        self,
        n_users: int = 2,
        n_episodes: int = 2,
        max_episode_steps: int = 30,
        output_path: Optional[str] = None,
        server=None,
        device=None,
    ):
        from habitat_torch.tasks.rearrange.social_nav import make_social_nav_env

        self.n_users = n_users
        self.n_episodes = n_episodes
        self.max_episode_steps = max_episode_steps
        self.output_path = output_path
        self.server = server  # NetworkingServer (user_inputs) or None
        self._local_inputs = [GuiInput() for _ in range(n_users)]
        self.session: Optional[Session] = None
        self.env = make_social_nav_env(
            num_envs=1, num_scenes=1, episodes_per_scene=max(2, n_episodes),
            seed=3, two_agent=True, device=device,
        )
        self._state = None
        self.state: AppStateBase = AppStateLobby(self)
        self.state.on_enter()
        self._hud = ""

    # -- wiring --------------------------------------------------------
    def num_users(self) -> int:
        if self.server is not None:
            return len(self.server.user_inputs)
        return self.n_users  # local mode: everyone is "connected"

    def user_input(self, u: int) -> GuiInput:
        if self.server is not None and u in self.server.user_inputs:
            return self.server.user_inputs[u]
        return self._local_inputs[u]

    def connection_records(self) -> Dict[int, dict]:
        if self.server is not None:
            return dict(self.server.connection_records)
        return {u: {"connection_id": u, "local": True} for u in range(self.n_users)}

    def hud(self, text: str) -> None:
        self._hud = text

    def reset_episode(self, idx: int) -> None:
        self._state, _ = self.env.reset_fn()

    # -- AppState facade for HitlDriver ---------------------------------
    def on_environment_reset(self, _):
        pass

    def sim_update(self, dt, post):
        self.state.sim_update(dt, post)
        if "action" in post and self._state is not None:
            self._state, *_ = self.env.step_fn(self._state, post.pop("action"))
        nxt = self.state.get_next_state()
        if nxt is not None:
            self.state = nxt
            self.state.on_enter()


def main(output_path: Optional[str] = None, device=None):
    if output_path is None:
        output_path = os.path.join(tempfile.gettempdir(), "rearrange_v2_session.json.gz")
    app = RearrangeV2App(n_users=2, n_episodes=2, output_path=output_path, device=device)
    driver = HitlDriver(app, env=_NullEnv(), record_video=False, target_sps=1000.0)
    # scripted two-user session: user 0 walks, user 1 turns, then 'n' twice
    script = [("w", "d")] * 8 + [("n", None)] + [("w", "w")] * 5 + [("n", None)]
    driver.reset()
    for keys in script + [(None, None)] * 5:
        for u, k in enumerate(keys):
            if k:
                app.user_input(u).press(k)
        post = driver.step(1 / 30)
        for u, k in enumerate(keys):
            if k:
                app.user_input(u).release(k)
        if post.get("application_exit"):
            break
    print("session written:", os.path.exists(output_path))
    with gzip.open(output_path, "rt") as f:
        rec = json.load(f)
    print("episodes recorded:", len(rec["episodes"]), "finished:", rec["finished"])
    return rec


class _NullEnv:
    """The app owns its env; the driver just ticks the state machine."""

    def reset(self):
        return {}

    def step(self, action):
        return {}


if __name__ == "__main__":
    main()
