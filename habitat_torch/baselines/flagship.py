"""The flagship PointNav checkpoint's evaluation protocol (that of
``scripts/eval_flagship_ckpt.py``), without JAX.

Held-out procedural scenes (``make_procedural_pointnav(num_scenes=64,
episodes_per_scene=16, seed=91000)``, seeds disjoint from every training
seed), 64 envs with 128x128 depth and the pointgoal, episodes of at most 200
steps, greedy actions, the first 4 episodes of each env counted (256
episodes) within 850 env steps. The JAX script plays that rollout from four
reset keys and counts 1024 episodes, but its env never reads the key: the
four passes replay the same 256 episodes, so one pass here plays the
episodes behind its 0.9414 success and 0.8919 SPL. The protocol is fixed:
the committed weights take 128x128 depth, and another scene count is
another eval set than the one those numbers describe.
"""

from __future__ import annotations

import os
import time

import torch

from habitat_torch.baselines.evaluator import evaluate_agent
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.device import resolve_device
from habitat_torch.models.convert import load_policy_file

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights",
                       "flagship_pointnav.pt")
PROTOCOL = dict(num_scenes=64, episodes_per_scene=16, scene_seed=91_000, num_envs=64, res=128,
                max_episode_steps=200, episodes_per_env=4, max_steps=850)


def flagship_eval(weights: str = WEIGHTS, device=None) -> dict:
    """The protocol on ``device`` (``None`` = cuda) with the exported
    weights at ``weights``. Returns episodes, success, SPL, soft SPL, the
    batched env steps run (one render each, after the reset's),
    env-steps/s, wall and set-up seconds, and the device's name."""
    dev = resolve_device(device)
    p = PROTOCOL
    t_setup = time.perf_counter()
    scenes, episodes, fields = make_procedural_pointnav(
        num_scenes=p["num_scenes"], episodes_per_scene=p["episodes_per_scene"], seed=p["scene_seed"])
    env = make_nav_env(
        scenes, episodes, num_envs=p["num_envs"], precomputed_fields=fields,
        max_episode_steps=p["max_episode_steps"], device=dev,
        sensor_specs=(("HabitatSimDepthSensor", {"height": p["res"], "width": p["res"]}),
                      ("PointGoalWithGPSCompassSensor", None)),
    )
    policy = load_policy_file(weights, device=dev)
    setup_s = time.perf_counter() - t_setup

    steps = 0
    step_fn = env.step_fn

    def counted_step(*args):
        nonlocal steps
        steps += 1
        return step_fn(*args)

    env.step_fn = counted_step
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    m = evaluate_agent(env, policy, episodes_per_env=p["episodes_per_env"], deterministic=True,
                       max_steps=p["max_steps"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return dict(
        episodes=int(m.get("num_episodes", 0)), success=m.get("success"), spl=m.get("spl"),
        soft_spl=m.get("soft_spl"), env_steps=steps, env_steps_per_s=steps * env.num_envs / wall, wall_s=wall,
        setup_s=setup_s, device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
