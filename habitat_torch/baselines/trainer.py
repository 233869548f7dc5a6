"""Single-card PPO trainer (port of ``habitat_tpu/baselines/trainer.py``).

The host loop over ``PPOLearner.train_step`` with the reference trainer's
bookkeeping (common/base_trainer.py, rl/ppo/ppo_trainer.py):

- windowed episode metrics: each update's episode sums divided by its
  finished episodes, kept over the last ``reward_window_size`` updates
  (``reward``, ``episode_length`` and one key per measure);
- progress: ``percent_done``, ``is_done``, ``should_checkpoint``;
- checkpoints: ``ckpt.{i}`` and ``latest`` in ``checkpoint_folder``, each a
  ``torch.save`` of the policy's and the optimizer's state dicts, the
  rollout state (env state, observations, hidden state, the generator's
  state) and the counters, with ``{name}.meta.json`` beside it;
- preemption: SIGTERM / SIGUSR2 save ``.resume_state`` and stop, SIGUSR1
  also requeues the SLURM job; ``train(resume=True)`` continues from
  ``.resume_state``.

- TensorBoard: with ``tensorboard_dir`` set, each update's metrics go to
  ``utils/tb.TensorboardWriter`` at the step count (``metrics/<name>``
  unless the name has a ``/``).

A continuous-action env (``action_dim``, no ``num_actions``) trains the
Gaussian policy (``PPOLearner(action_type="gaussian")``).

Registered as the ``ppo`` trainer. DD-PPO over several cards
(``use_mesh``, the ``ddppo`` trainer) and the ``ver`` trainer are not ported
yet (ROADMAP Queue 1 item 5) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import time
from collections import defaultdict, deque
from typing import Dict, Tuple

import torch

from habitat_torch.baselines.ppo import PPOConfig, PPOLearner, RolloutState
from habitat_torch.core.batched_env import BatchedEnv, EnvState
from habitat_torch.core.registry import registry
from habitat_torch.models.policy import ActorCritic
from habitat_torch.utils.tb import TensorboardWriter

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    """Run-level settings (reference HabitatBaselinesConfig fields)."""

    total_num_steps: float = 1e6
    checkpoint_folder: str = "data/checkpoints"
    tensorboard_dir: str = ""
    num_checkpoints: int = 10
    checkpoint_interval: int = -1
    log_interval: int = 10
    reward_window_size: int = 50
    use_mesh: bool = False
    verbose: bool = True

    def __post_init__(self):
        if self.use_mesh:
            raise NotImplementedError("DD-PPO (use_mesh) is not ported to habitat_torch yet (ROADMAP Queue 1 item 5)")


class EarlyStopper:
    """Preemption signals -> clean exit with resume state (reference
    ddp_utils.py:36-41,163-179): SIGTERM/SIGUSR2 ask to save
    ``.resume_state`` and stop; SIGUSR1, SLURM's preemption notice, also
    asks to requeue the job."""

    def __init__(self):
        self.should_exit = False
        self.should_requeue = False
        for sig in (signal.SIGTERM, signal.SIGUSR2):
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread
        try:
            signal.signal(signal.SIGUSR1, self._requeue_handler)
        except ValueError:
            pass

    def _handler(self, signum, frame):
        self.should_exit = True

    def _requeue_handler(self, signum, frame):
        self.should_exit = True
        self.should_requeue = True


def requeue_job() -> bool:
    """``scontrol requeue $SLURM_JOB_ID`` (reference ddp_utils.py:227);
    returns whether a requeue was issued (none outside SLURM)."""
    job_id = os.environ.get("SLURM_JOB_ID")
    if not job_id:
        return False
    logger.info("requeueing SLURM job %s", job_id)
    subprocess.check_call(["scontrol", "requeue", job_id])
    return True


def _to(obj, dev: torch.device):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    return obj


def _rollout_state_dict(rs: RolloutState) -> Dict:
    """A ``RolloutState`` as plain dicts of tensors (the generator as its
    state), loadable with ``torch.load(weights_only=True)``."""
    d = {f.name: getattr(rs, f.name) for f in dataclasses.fields(rs)}
    d["env_state"] = {f.name: getattr(rs.env_state, f.name) for f in dataclasses.fields(rs.env_state)}
    d["generator"] = rs.generator.get_state()
    return d


def _rollout_state_from_dict(d: Dict, dev: torch.device) -> RolloutState:
    gen = torch.Generator(device=dev)
    gen.set_state(d["generator"])
    fields = {k: _to(v, dev) for k, v in d.items() if k not in ("env_state", "generator")}
    return RolloutState(env_state=EnvState(**_to(d["env_state"], dev)), generator=gen, **fields)


@registry.register_trainer(name="ppo")
class PPOTrainer:
    def __init__(
        self,
        env: BatchedEnv,
        policy: ActorCritic,
        ppo_cfg: PPOConfig = PPOConfig(),
        run_cfg: TrainerConfig = TrainerConfig(),
        measure_keys: Tuple[str, ...] = ("success", "spl", "distance_to_goal"),
    ):
        self.env = env
        self.policy = policy
        self.ppo_cfg = ppo_cfg
        self.run_cfg = run_cfg
        # a continuous action space (an ``action_dim`` and no
        # ``num_actions``) takes the Gaussian head, as the reference picks
        # its action distribution from the action space
        continuous = hasattr(env, "action_dim") and not hasattr(env, "num_actions")
        self.learner = PPOLearner(
            env, policy, ppo_cfg, measure_keys=measure_keys, action_type="gaussian" if continuous else "categorical"
        )
        self.num_steps_done = 0
        self.num_updates_done = 0
        self._windows: Dict[str, deque] = defaultdict(lambda: deque(maxlen=run_cfg.reward_window_size))
        self._ckpt_count = 0
        self.final_state = None

    # -- checkpoints -----------------------------------------------------
    def _ckpt_dir(self) -> str:
        d = os.path.abspath(self.run_cfg.checkpoint_folder)
        os.makedirs(d, exist_ok=True)
        return d

    def save_checkpoint(self, rs: RolloutState, name: str) -> None:
        counters = {
            "num_steps_done": self.num_steps_done,
            "num_updates_done": self.num_updates_done,
            "ckpt_count": self._ckpt_count,
        }
        path = os.path.join(self._ckpt_dir(), name)
        state = {
            "policy": self.policy.state_dict(),
            "optimizer": self.learner.optimizer.state_dict(),
            "rollout_state": _rollout_state_dict(rs),
            **counters,
        }
        # written whole, then renamed over the old one; through a file
        # object, since torch.save takes no file name that starts with "."
        with open(path + ".tmp", "wb") as f:
            torch.save(state, f)
        os.replace(path + ".tmp", path)
        with open(os.path.join(self._ckpt_dir(), name + ".meta.json"), "w") as f:
            json.dump(counters, f)

    def load_checkpoint(self, name: str) -> RolloutState:
        """Restore the policy, the optimizer and the counters; return the
        saved rollout state on the env's device."""
        with open(os.path.join(self._ckpt_dir(), name), "rb") as f:
            ck = torch.load(f, map_location="cpu", weights_only=True)
        self.policy.load_state_dict(ck["policy"])
        self.learner.optimizer.load_state_dict(ck["optimizer"])
        self.num_steps_done = ck["num_steps_done"]
        self.num_updates_done = ck["num_updates_done"]
        self._ckpt_count = ck["ckpt_count"]
        return _rollout_state_from_dict(ck["rollout_state"], self.env.device)

    def resume_state_exists(self) -> bool:
        return os.path.exists(os.path.join(self._ckpt_dir(), ".resume_state"))

    # -- progress (reference base_trainer.py:254-287) --------------------
    def percent_done(self) -> float:
        return self.num_steps_done / self.run_cfg.total_num_steps

    def is_done(self) -> bool:
        return self.percent_done() >= 1.0

    def should_checkpoint(self) -> bool:
        rc = self.run_cfg
        if rc.checkpoint_interval == -1:
            return self.percent_done() >= self._ckpt_count * (1 / rc.num_checkpoints)
        return self.num_updates_done % rc.checkpoint_interval == 0

    # -- training --------------------------------------------------------
    def train(self, seed: int = 0, resume: bool = True) -> Dict[str, float]:
        """Main loop (reference ppo_trainer.py:656-801); returns the last
        update's metrics with the windowed episode means."""
        rc = self.run_cfg
        stopper = EarlyStopper()
        rs = self.learner.init(seed)
        if resume and self.resume_state_exists():
            rs = self.load_checkpoint(".resume_state")
            logger.info("resumed at update %d, steps %d", self.num_updates_done, self.num_steps_done)
        writer = TensorboardWriter(rc.tensorboard_dir) if rc.tensorboard_dir else None
        steps_per_update = self.ppo_cfg.num_steps * self.env.num_envs
        t_start = time.time()
        last_metrics: Dict[str, float] = {}
        while not self.is_done():
            rs, metrics = self.learner.train_step(rs)
            self.num_updates_done += 1
            self.num_steps_done += steps_per_update

            m = {k: float(v) for k, v in metrics.items()}
            dc = max(m.pop("done_count", 0.0), 0.0)
            if dc > 0:
                self._windows["reward"].append(m.pop("reward_sum") / dc)
                self._windows["episode_length"].append(m.pop("len_sum") / dc)
                for k in list(m):
                    if k.startswith("m_"):
                        self._windows[k[2:]].append(m.pop(k) / dc)
            window_means = {k: sum(v) / len(v) for k, v in self._windows.items() if len(v)}
            last_metrics = {**m, **window_means}

            if self.num_updates_done % rc.log_interval == 0 and rc.verbose:
                fps = self.num_steps_done / (time.time() - t_start)
                logger.info(
                    f"update {self.num_updates_done} steps {self.num_steps_done} fps {fps:.0f} "
                    + " ".join(f"{k}={v:.3f}" for k, v in sorted(last_metrics.items()))
                )
            if writer is not None:
                for k, v in last_metrics.items():
                    writer.add_scalar(k if "/" in k else f"metrics/{k}", v, self.num_steps_done)
            if self.should_checkpoint():
                self.save_checkpoint(rs, f"ckpt.{self._ckpt_count}")
                self.save_checkpoint(rs, "latest")
                self._ckpt_count += 1
            if stopper.should_exit:
                self.save_checkpoint(rs, ".resume_state")
                if stopper.should_requeue:
                    requeue_job()
                break
        if writer is not None:
            writer.close()
        self.final_state = rs
        return last_metrics


def _not_ported(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"the {name!r} trainer is not ported to habitat_torch yet (ROADMAP Queue 1 item 5)")

    return build


for _name in ("ddppo", "ver"):
    registry.register_trainer(_not_ported(_name), name=_name)
