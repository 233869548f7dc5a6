"""The articulated-scene open task and its scripted opener.

``art_scene_envs`` builds the open task on receptacle goals, the
articulated-object state sampler's initial drawer states and a URDF
cabinet: one env with the head camera on ``device`` and one on the CPU
without it, over the same pack, table and episode order, so that a step
taken on the card can be taken again on the CPU from the card's state.
``opener_action`` is tests/test_urdf_artobj.py's scripted opener on the
state's device: turn to the handle, drive to it, pull within 0.8 m.
"""

from __future__ import annotations

import numpy as np
import torch

from habitat_torch.core.dataset import build_env_episode_order
from habitat_torch.sims.loaders import load_articulated_object
from habitat_torch.sims.scene import pack_scenes
from habitat_torch.tasks.rearrange import rearrange_env as renv
from habitat_torch.tasks.rearrange.generator import build_rearrange_table, make_procedural_rearrange
from habitat_torch.tasks.rearrange.samplers import ArticulatedObjectStateSampler, ArtObjSpec

# (ao_handle, link, state range) of the sampler, and ArtObjSpec(handle,
# links, limits): tests/test_samplers.py's drawer
ART_SAMPLER = ("drawer", "drawer_0", (0.05, 0.25))
ART_OBJ = ("drawer_main", ("drawer_0",), ((0.0, 0.45),))


def art_scene_envs(urdf: str, device, *, num_envs: int, num_scenes: int, episodes_per_scene: int, seed: int = 0,
                   n_rooms_per_axis: int = 1, n_clutter: int = 3, render_size=(128, 128), **env_kw):
    """(card env, CPU env, scenes, episodes) of the open task on the URDF
    ``urdf``; ``env_kw`` goes to both envs."""
    scenes, episodes = make_procedural_rearrange(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed, n_rooms_per_axis=n_rooms_per_axis,
        n_clutter=n_clutter, use_receptacles=True, ao_state_sampler=ArticulatedObjectStateSampler(*ART_SAMPLER),
        art_objs=[ArtObjSpec(*ART_OBJ)])
    table = build_rearrange_table(episodes, {s.scene_id: s for s in scenes},
                                  {s.scene_id: i for i, s in enumerate(scenes)},
                                  art_asset=load_articulated_object(urdf))
    order, pack = build_env_episode_order(episodes, num_envs, seed=seed), pack_scenes(scenes)
    env = renv.RearrangeBatchedEnv(pack, table, order, task="open", with_visual=True, render_size=render_size,
                                   device=device, **env_kw)
    env_c = renv.RearrangeBatchedEnv(pack, table, order, task="open", with_visual=False,
                                     device=torch.device("cpu"), **env_kw)
    return env, env_c, scenes, episodes


def opener_action(env: renv.RearrangeBatchedEnv, st: renv.RearrangeState) -> torch.Tensor:
    """(N,) int32 discrete actions: turn to the handle until within 12
    degrees, then forward; grab_release (pull) within 0.8 m."""
    d = env._handle_pos(st) - st.pos
    dist = torch.sqrt(d[:, 0] ** 2 + d[:, 2] ** 2)
    ang = torch.atan2(-d[:, 0], -d[:, 2]) - st.yaw
    ang = torch.atan2(torch.sin(ang), torch.cos(ang))
    act = torch.where(ang.abs() < np.deg2rad(12), renv.A_FWD, torch.where(ang > 0, renv.A_LEFT, renv.A_RIGHT))
    return torch.where(dist < 0.8, renv.A_GRAB, act).to(torch.int32)
