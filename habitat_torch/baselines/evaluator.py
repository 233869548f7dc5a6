"""Checkpoint evaluation with exactly-once episode accounting (port of
``habitat_tpu/baselines/evaluator.py``).

Counterpart of HabitatEvaluator.evaluate_agent (reference
rl/ppo/habitat_evaluator.py:39) and pause_envs (rl/ppo/evaluator.py:57):
all envs run batched, and "pausing" a finished env is an accounting mask.
Each env has an episode quota, its share of the eval set, and episodes it
finishes beyond the quota are not counted.

``evaluate_from_config`` is the config entry (``run.py --run-type eval``):
the trainer's ``latest`` checkpoint, ``test_episode_count`` episodes.

A Gaussian (continuous-action) policy starts from a zero previous action
(N, ``num_outputs``) and acts with mu when ``deterministic``.

Eval videos: with ``video_option`` ("disk" and/or "tensorboard") the frames
of env ``video_env`` (``observations_to_image`` of its rgb, depth and
semantic observations, with the ``map_tracker``'s top-down map when one is
given) are kept while that env's quota is open and written at the end by
``generate_video`` with the mean success and SPL (a GIF in ``video_dir``,
frames to ``tb_writer``). The frame comes to the host in the step's one
copy. The trainer's config path passes no ``video_option``, as in the JAX
package. ``eval_checkpoint_loop`` takes its two settings as keywords.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from habitat_torch.core.batched_env import BatchedEnv
from habitat_torch.models.policy import ActorCritic, sample_action, sample_gaussian_action

logger = logging.getLogger(__name__)
# the observations a video frame shows
_FRAME_KEYS = ("rgb", "depth", "semantic")


def evaluate_agent(
    env: BatchedEnv,
    policy: ActorCritic,
    *,
    episodes_per_env: Optional[int] = None,
    evals_per_ep: int = 1,
    deterministic: bool = False,
    seed: int = 0,
    max_steps: Optional[int] = None,
    measure_keys: Tuple[str, ...] = ("success", "spl", "soft_spl", "distance_to_goal", "num_steps"),
    video_option: Tuple[str, ...] = (),
    video_dir: Optional[str] = None,
    video_env: int = 0,
    tb_writer=None,
    checkpoint_idx: int = 0,
    map_tracker=None,
) -> Dict[str, float]:
    """Run ``policy`` on ``env`` (both on the env's device) until every env
    has finished its quota of ``episodes_per_env * evals_per_ep`` episodes
    (each env cycles its episode list, so ``evals_per_ep`` passes evaluate
    every episode that many times) or ``max_steps`` env steps have run.
    Actions are greedy (``deterministic``) or sampled from a generator
    seeded with ``seed``. Returns the mean over counted episodes of each
    measure in ``measure_keys`` that the env reports and of the episode
    ``reward``, and ``num_episodes``; {} if no episode finished. With
    ``video_option`` the frames of env ``video_env`` become a video (the
    module's docstring); ``map_tracker`` (a ``TopDownMapTracker`` of that
    env's scene) follows its pose and is reset when its episode ends."""
    from habitat_torch.utils.visualizations.utils import observations_to_image

    dev = env.device
    n = env.num_envs
    if episodes_per_env is None:
        episodes_per_env = max(1, env.table.num_episodes // n)
    quota = np.full((n,), episodes_per_env * max(1, evals_per_ep), np.int64)
    if max_steps is None:
        max_steps = env.max_episode_steps * (episodes_per_env + 1) * 2

    generator = torch.Generator(device=dev).manual_seed(seed)
    hidden = policy.initial_hidden(n)
    continuous = not getattr(policy.net, "discrete_actions", True)
    if continuous:
        prev_action = torch.zeros((n, int(policy.num_outputs)), device=dev)
    else:
        prev_action = torch.zeros((n,), dtype=torch.int32, device=dev)
    not_done = torch.zeros((n,), device=dev)
    state, obs = env.reset_fn()
    counted = np.zeros((n,), np.int64)
    sums: Dict[str, float] = defaultdict(float)
    reward_acc = np.zeros((n,), np.float64)
    total_eps = 0
    record = bool(video_option)
    frames: List[np.ndarray] = []
    with torch.no_grad():
        for _ in range(max_steps):
            dist, _, hidden = policy(obs, hidden, prev_action, not_done)
            if continuous:
                action, _ = sample_gaussian_action(*dist, generator, deterministic=deterministic)
            else:
                action, _ = sample_action(dist, generator, deterministic=deterministic)
            state, obs, reward, done, info = env.step_fn(state, action)
            keys = [k for k in measure_keys if k in info]
            # one transfer per step: dones, rewards and the measures (and
            # the video env's frame and pose while it is recorded)
            scalars = torch.stack([done.float(), reward.float(), *(info[k].float() for k in keys)])
            if record and counted[video_env] < quota[video_env]:
                seen = [k for k in obs if k in _FRAME_KEYS]
                host, *rest = _one_copy([scalars, *(obs[k][video_env] for k in seen),
                                         state.pos[video_env], state.yaw[video_env]])
                if map_tracker is not None:
                    map_tracker.update(rest[-2], float(rest[-1]))
                if seen:
                    frame_info = {"top_down_map": map_tracker.frame()} if map_tracker is not None else {}
                    frames.append(observations_to_image(dict(zip(seen, rest)), frame_info))
                if map_tracker is not None and host[0][video_env] > 0.5:
                    map_tracker.reset()
            else:
                host = scalars.cpu().numpy()
            prev_action = action
            not_done = 1.0 - done.float()
            d = host[0] > 0.5
            reward_acc += host[1]
            if d.any():
                take = d & (counted < quota)
                for i, k in enumerate(keys):
                    sums[k] += float(host[2 + i][take].sum())
                sums["reward"] += float(reward_acc[take].sum())
                total_eps += int(take.sum())
                counted += take.astype(np.int64)
                reward_acc[d] = 0.0
            if np.all(counted >= quota):
                break

    if total_eps == 0:
        logger.warning("evaluation finished no episodes")
        return {}
    out = {k: v / total_eps for k, v in sums.items()}
    out["num_episodes"] = float(total_eps)
    if record and frames:
        from habitat_torch.utils.common import generate_video

        generate_video(list(video_option), video_dir, frames, episode_id=f"env{video_env}",
                       checkpoint_idx=checkpoint_idx, metrics={k: out.get(k, 0.0) for k in ("success", "spl")},
                       tb_writer=tb_writer)
    return out


def _one_copy(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays, brought to the host in one copy (their
    bytes side by side, each piece padded to 8 bytes so that every slice
    starts aligned for its dtype)."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    pieces = []
    for f in flat:
        pieces.append(f)
        if f.numel() % 8:
            pieces.append(f.new_zeros(8 - f.numel() % 8))
    host = torch.cat(pieces).cpu()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        out.append(host[at:at + f.numel()].view(t.dtype).reshape(t.shape).numpy())
        at += -(-f.numel() // 8) * 8
    return out


def poll_checkpoint_folder(folder: str, prev_ckpt_ind: int) -> Optional[str]:
    """The first numbered checkpoint ``ckpt.{i}`` in ``folder`` with i >
    ``prev_ckpt_ind``, or None (reference poll_checkpoint_folder used by
    BaseTrainer.eval, common/base_trainer.py:136-150)."""
    if not os.path.isdir(folder):
        return None
    found = sorted((int(m.group(1)), f) for f in os.listdir(folder) if (m := re.match(r"ckpt\.(\d+)$", f)))
    for idx, f in found:
        if idx > prev_ckpt_ind:
            return os.path.join(folder, f)
    return None


def eval_checkpoint_loop(
    trainer,
    *,
    evals_per_ep: int = 1,
    seed: int = 100,
    poll_interval_s: float = 2.0,
    timeout_s: float = 600.0,
) -> Dict[int, Dict[str, float]]:
    """Evaluate every numbered checkpoint of ``trainer``'s checkpoint folder
    as it appears (reference BaseTrainer.eval loop,
    common/base_trainer.py:108-167), each with ``evaluate_agent(trainer.env,
    trainer.policy, evals_per_ep=, seed=)`` after
    ``trainer.load_checkpoint``; stops once no checkpoint is left and the
    trainer is done, or after ``timeout_s``. Progress persists to
    ``.eval_resume_state`` in the folder, so a preempted eval resumes at the
    next checkpoint not yet evaluated (reference :77-88, 152-163). Returns
    {checkpoint index: metrics}."""
    folder = os.path.abspath(trainer.run_cfg.checkpoint_folder)
    resume_path = os.path.join(folder, ".eval_resume_state")
    prev = -1
    if os.path.exists(resume_path):
        with open(resume_path) as f:
            prev = int(json.load(f).get("prev_ckpt_ind", -1))
        logger.info(f"eval resumed after checkpoint {prev}")

    results: Dict[int, Dict[str, float]] = {}
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        nxt = poll_checkpoint_folder(folder, prev)
        if nxt is None:
            if trainer.is_done():
                break
            time.sleep(poll_interval_s)
            continue
        idx = int(nxt.rsplit(".", 1)[1])
        trainer.load_checkpoint(os.path.basename(nxt))
        metrics = evaluate_agent(trainer.env, trainer.policy, evals_per_ep=evals_per_ep, seed=seed)
        results[idx] = metrics
        logger.info(f"eval ckpt.{idx}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
        prev = idx
        with open(resume_path, "w") as f:
            json.dump({"prev_ckpt_ind": prev}, f)
    return results


def evaluate_from_config(config, trainer) -> Dict[str, float]:
    """Eval entry (reference BaseTrainer.eval, common/base_trainer.py:66):
    loads the ``latest`` checkpoint of ``trainer`` when there is one and
    ``habitat_baselines.eval.should_load_ckpt`` is set, then evaluates
    ``test_episode_count // num_envs`` episodes per env (at least one; all of
    each env's episodes when the count is not positive), sampling actions
    from a generator seeded with ``habitat.seed``."""
    env = trainer.env
    latest = os.path.join(os.path.abspath(trainer.run_cfg.checkpoint_folder), "latest")
    if os.path.exists(latest) and config.get_path("habitat_baselines.eval.should_load_ckpt", True):
        trainer.load_checkpoint("latest")
    count = int(config.get_path("habitat_baselines.test_episode_count", -1))
    metrics = evaluate_agent(
        env,
        trainer.policy,
        episodes_per_env=None if count <= 0 else max(1, count // env.num_envs),
        evals_per_ep=int(config.get_path("habitat_baselines.eval.evals_per_ep", 1)),
        deterministic=False,
        seed=int(config.habitat.get("seed", 100)),
    )
    logger.info("eval: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
    return metrics
