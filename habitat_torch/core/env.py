"""Single-env ``Env`` / ``RLEnv``: the reference's basic API (port of
``habitat_tpu/core/env.py``; reference habitat-lab/habitat/core/env.py).

``Env(config)`` drives a 1-env ``BatchedEnv(auto_reset_done=False)`` on
``device`` (``None`` = cuda), with the episodes scheduled on the host by
the dataset's ``EpisodeIterator`` (the config's ``iterator_options`` and
``habitat.seed``): ``reset()`` starts the iterator's next episode through
``reset_to_fn`` and ``step(action)`` takes one action (an index, a name, a
dict with "action", or a (linear, angular) command for velocity control).
Observations come back without the batch axis, as tensors on the env's
device. After each reset and step one copy brings the measures, reward,
done and pose to the host, where the host-side measures (TopDownMap,
RuntimePerfStats, GfxReplayMeasure) are updated; ``get_metrics()`` reports
both kinds. ``render()`` returns a host image: the rgb or depth observation
rendered again, or a 256x256 frame when the config has no visual sensor.

``RLEnv`` adds reward, done and info (the batched env's RLTaskEnv
composition).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from habitat_torch.config.omega import Config
from habitat_torch.core.dataset import Dataset, Episode
from habitat_torch.core.embodied_task import Metrics
from habitat_torch.device import resolve_device

DEBUG_FRAME = 256  # size of render()'s frame when the config has no visual sensor


class Env:
    def __init__(self, config: Config, dataset: Optional[Dataset] = None, device=None) -> None:
        from habitat_torch.core.batched_env import BatchedEnv
        from habitat_torch.core.construct import (
            _action_instances,
            _measure_instances,
            _sensor_instances,
            _with_scenes,
            goal_image_size,
            load_dataset,
            reward_spec_of,
        )
        from habitat_torch.core.dataset import build_episode_table
        from habitat_torch.sims.scene import pack_scenes

        self._config = config
        self.device = resolve_device(device)
        if dataset is not None:
            scenes, episodes, fields = _with_scenes(dataset, config.habitat.dataset)
        else:
            scenes, episodes, fields = load_dataset(config.habitat.dataset)
            dataset = Dataset(episodes)
        if not episodes:
            raise ValueError("Env requires a non-empty dataset")
        self._dataset = dataset
        self._episodes: List[Episode] = list(episodes)
        self._ep_index = {e.episode_id: i for i, e in enumerate(self._episodes)}

        seed = int(config.habitat.get("seed", 100))
        it = config.habitat.environment.get("iterator_options", Config())
        self._episode_iterator = dataset.get_episode_iterator(
            cycle=bool(it.get("cycle", True)),
            shuffle=bool(it.get("shuffle", True)),
            group_by_scene=bool(it.get("group_by_scene", True)),
            max_scene_repeat_episodes=int(it.get("max_scene_repeat_episodes", -1)),
            # reference IteratorOptionsConfig default
            max_scene_repeat_steps=int(it.get("max_scene_repeat_steps", int(1e4))),
            num_episode_sample=int(it.get("num_episode_sample", -1)),
            step_repetition_range=float(it.get("step_repetition_range", 0.2)),
            seed=seed,
        )

        self._scene_map = {s.scene_id: s for s in scenes}
        scene_index = {s.scene_id: i for i, s in enumerate(scenes)}
        task = config.habitat.task
        table = build_episode_table(self._episodes, self._scene_map, scene_index, precomputed_fields=fields,
                                    goal_image_size=goal_image_size(task), device=self.device)
        measures = _measure_instances(config)
        self._host_measures = [m for m in measures if getattr(m, "host_side", False)]
        self._inner = BatchedEnv(
            pack_scenes(list(scenes)),
            table,
            np.zeros((1, 1), np.int32),
            _sensor_instances(config),
            [m for m in measures if not getattr(m, "host_side", False)],
            _action_instances(config),
            device=self.device,
            max_episode_steps=int(config.habitat.environment.get("max_episode_steps", 500)),
            reward_spec=reward_spec_of(task),
            slide_substeps=int(config.habitat.simulator.get_path("tpu.slide_substeps", 4)),
            auto_reset_done=False,
        )
        self.observation_shapes = self._inner.observation_shapes
        self.action_names = self._inner.action_names
        self.number_of_episodes = len(self._episodes)
        self._current_episode: Optional[Episode] = None
        self._state = None
        self._last_info: Dict[str, Any] = {}
        self._last_reward_done = (0.0, False)
        self._episode_over = False
        self._elapsed_steps = 0
        self._episode_start_time: Optional[float] = None
        # the env's random stream (the JAX package's PRNG key); no nav
        # component draws from it
        self.generator = torch.Generator().manual_seed(seed)

    # -- properties (reference env.py surface) -----------------------------
    @property
    def current_episode(self) -> Episode:
        assert self._current_episode is not None
        return self._current_episode

    @property
    def episodes(self) -> List[Episode]:
        return self._episodes

    @property
    def episode_iterator(self) -> Iterator:
        return self._episode_iterator

    @property
    def sim(self):
        return self._inner

    @property
    def task(self):
        return self._inner

    @property
    def episode_over(self) -> bool:
        return self._episode_over

    @property
    def episode_start_time(self) -> Optional[float]:
        return self._episode_start_time

    @property
    def elapsed_steps(self) -> int:
        return self._elapsed_steps

    def get_metrics(self) -> Metrics:
        return Metrics(self._last_info)

    # -- lifecycle ----------------------------------------------------------
    def _to_host(self, values: Dict[str, torch.Tensor], *extra: torch.Tensor):
        """The measure values of the one env as numpy float32 scalars, and
        ``extra`` (1-d tensors), in one copy."""
        keys = list(values)
        flat = torch.cat([*(values[k].float() for k in keys), *(x.float() for x in extra)])
        host = flat.cpu().numpy()
        return dict(zip(keys, host[: len(keys)])), host[len(keys):]

    def _update_host_measures(self, host_pose: np.ndarray, reset: bool) -> None:
        pos, yaw = host_pose[:3], float(host_pose[3])
        for m in self._host_measures:
            if reset:
                scene = self._scene_map[self._current_episode.scene_id]
                self._last_info[m.uuid] = m.host_reset(scene, self._current_episode, pos, yaw)
            else:
                self._last_info[m.uuid] = m.host_update(pos, yaw, episode_over=self._episode_over)

    def reset(self) -> Dict[str, torch.Tensor]:
        self._episode_start_time = time.time()
        self._episode_over = False
        self._elapsed_steps = 0
        self._current_episode = next(self._episode_iterator)
        idx = self._ep_index[self._current_episode.episode_id]
        self._state, obs = self._inner.reset_to_fn(torch.tensor([idx]))
        st = self._state
        self._last_info, pose = self._to_host(self._inner.measure_values(st), st.pos[0], st.yaw)
        self._update_host_measures(pose, reset=True)
        return {k: v[0] for k, v in obs.items()}

    def step(self, action: Union[int, str, Dict[str, Any], Any], **kwargs) -> Dict[str, torch.Tensor]:
        assert self._current_episode is not None, "Call reset before step"
        assert not self._episode_over, "Episode over; call reset"
        if isinstance(action, dict):
            action = action["action"]
        if isinstance(action, str):
            action = self._inner.action_names.index(action)
        if self._inner.action_shape:
            actions = torch.as_tensor(action, dtype=torch.float32, device=self.device).reshape(1, -1)
        else:
            actions = torch.tensor([int(action)], device=self.device)
        self._state, obs, reward, done, info = self._inner.step_fn(self._state, actions)
        st = self._state
        self._elapsed_steps += 1
        self._last_info, host = self._to_host(info, reward, done, st.episode_over, st.pos[0], st.yaw)
        self._last_reward_done = (float(host[0]), bool(host[1]))
        self._episode_over = bool(host[2])
        self._update_host_measures(host[3:], reset=False)
        self._episode_iterator.step_taken()
        return {k: v[0] for k, v in obs.items()}

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    def reconfigure(self, config: Config) -> None:
        self._config = config

    def render(self, mode: str = "rgb") -> np.ndarray:
        """(H, W, 3) uint8 host image of the current state: the rgb
        observation, the depth one as gray, or, without a visual sensor, a
        DEBUG_FRAME square RGB frame from 1.25 m above the agent. Each call
        renders once."""
        st = self._state
        obs = self._inner._observations(st)
        if "rgb" in obs:
            return obs["rgb"][0].cpu().numpy()
        if "depth" in obs:
            return (obs["depth"][0].repeat(1, 1, 3) * 255).to(torch.uint8).cpu().numpy()
        from habitat_torch.ops.raycast import render_batch

        out = render_batch(
            self._inner.pack,
            self._inner.table.scene_idx[st.ep_idx].long(),
            st.pos + torch.tensor([0.0, 1.25, 0.0], device=self.device),
            st.yaw,
            st.pitch,
            height=DEBUG_FRAME,
            width=DEBUG_FRAME,
        )
        return out["rgb"][0].cpu().numpy()

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


class RLEnv:
    """gym-style wrapper with reward, done and info (reference
    core/env.py:358-494). The reward composition is the batched env's
    (``RewardSpec``, RLTaskEnv's); subclasses may override ``get_reward`` /
    ``get_done`` / ``get_info``."""

    def __init__(self, config: Config, dataset: Optional[Dataset] = None, device=None):
        self._env = Env(config, dataset, device=device)
        self.observation_shapes = self._env.observation_shapes
        self.action_names = self._env.action_names
        self.number_of_episodes = self._env.number_of_episodes
        self.reward_range = (-float("inf"), float("inf"))

    @property
    def env(self) -> Env:
        return self._env

    @property
    def habitat_env(self) -> Env:
        return self._env

    @property
    def episodes(self) -> List[Episode]:
        return self._env.episodes

    @property
    def current_episode(self) -> Episode:
        return self._env.current_episode

    def reset(self, *, return_info: bool = False, **kwargs):
        obs = self._env.reset()
        if return_info:
            return obs, self.get_info(obs)
        return obs

    def get_reward_range(self):
        return self.reward_range

    def get_reward(self, observations) -> float:
        return self._env._last_reward_done[0]

    def get_done(self, observations) -> bool:
        return self._env._last_reward_done[1]

    def get_info(self, observations) -> dict:
        return dict(self._env.get_metrics())

    def step(self, *args, **kwargs):
        obs = self._env.step(*args, **kwargs)
        return obs, self.get_reward(obs), self.get_done(obs), self.get_info(obs)

    def seed(self, seed=None):
        self._env.seed(seed)

    def render(self, mode: str = "rgb"):
        return self._env.render(mode)

    def close(self):
        self._env.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
