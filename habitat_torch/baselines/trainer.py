"""PPO and DD-PPO trainer (port of ``habitat_tpu/baselines/trainer.py``).

The host loop over ``PPOLearner.train_step`` with the reference trainer's
bookkeeping (common/base_trainer.py, rl/ppo/ppo_trainer.py):

- windowed episode metrics: each update's episode sums divided by its
  finished episodes, kept over the last ``reward_window_size`` updates
  (``reward``, ``episode_length`` and one key per measure);
- progress: ``percent_done``, ``is_done``, ``should_checkpoint``;
- checkpoints: ``ckpt.{i}`` and ``latest`` in ``checkpoint_folder``, each a
  ``torch.save`` of the policy's and the optimizer's state dicts (and an
  aux loss's), the rollout state (env state, observations, hidden state,
  the generator's state, log_alpha) and the counters, with
  ``{name}.meta.json`` beside it;
- preemption: SIGTERM / SIGUSR2 save ``.resume_state`` and stop, SIGUSR1
  also requeues the SLURM job; ``train(resume=True)`` continues from
  ``.resume_state``.
- TensorBoard: with ``tensorboard_dir`` set, each update's metrics go to
  ``utils/tb.TensorboardWriter`` at the step count (``metrics/<name>``
  unless the name has a ``/``).

A continuous-action env (``action_dim``, no ``num_actions``) trains the
Gaussian policy (``PPOLearner(action_type="gaussian")``).

Registered as ``ppo`` and ``ddppo``; ``VERTrainer`` as ``ver``. Under a
process group (``parallel/distributed.py``; ``use_mesh``, the default) it
is DD-PPO: each rank steps its ``rows`` of the envs (``distributed.env_rows``,
handed in with the env that was built from them) and the learner reduces
over the ranks. Logging, TensorBoard, checkpoint files and the requeue are
rank 0's; for a checkpoint the ranks gather their env rows, so a W-rank run
writes what a one-process run at the same N writes and resumes at any W. A
preemption signal on any rank stops every rank after the same update, and
an error drops the group so that no rank waits on the one that failed.
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
from typing import Dict, Optional, Tuple

import torch

from habitat_torch.baselines.ppo import ENV_FIELDS, PPOConfig, PPOLearner, RolloutState
from habitat_torch.core.batched_env import BatchedEnv
from habitat_torch.core.registry import registry
from habitat_torch.models.policy import ActorCritic
from habitat_torch.parallel import distributed
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
    use_mesh: bool = True  # shard the envs over the process group's ranks ('ddppo')
    verbose: bool = True


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
    if not job_id or not distributed.rank0_only():
        return False
    logger.info("requeueing SLURM job %s", job_id)
    subprocess.check_call(["scontrol", "requeue", job_id])
    return True


def _map(fn, obj):
    """``fn`` on every tensor of nested dicts."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    return obj


def _rollout_state_dict(rs: RolloutState) -> Dict:
    """A ``RolloutState`` as plain dicts of tensors (the generator as its
    state), loadable with ``torch.load(weights_only=True)``, its env-indexed
    leaves gathered over the ranks (a collective: every rank calls it)."""
    d = {f.name: getattr(rs, f.name) for f in dataclasses.fields(rs)}
    d["env_state"] = {f.name: getattr(rs.env_state, f.name) for f in dataclasses.fields(rs.env_state)}
    d["generator"] = rs.generator.get_state()
    for k in ENV_FIELDS:
        d[k] = _map(distributed.gather_rows, d[k])
    return d


def _rollout_state_from_dict(d: Dict, like: RolloutState, rows: distributed.EnvRows) -> RolloutState:
    """A saved rollout state on ``like``'s device, its env-indexed leaves
    cut to ``rows`` of the global env axis."""
    dev = like.not_done.device
    n_saved = d["not_done"].shape[0]
    if n_saved != rows.n_global:
        raise ValueError(f"the checkpoint holds {n_saved} envs, this run {rows.n_global}")
    gen = torch.Generator(device=like.generator.device)
    gen.set_state(d["generator"])
    fields = {}
    for k, v in d.items():
        if k != "generator":
            fields[k] = _map((lambda t: t[rows.slice].to(dev)) if k in ENV_FIELDS else (lambda t: t.to(dev)), v)
    fields["env_state"] = type(like.env_state)(**fields["env_state"])
    return RolloutState(generator=gen, **fields)


@registry.register_trainer(name="ppo")
@registry.register_trainer(name="ddppo")
class PPOTrainer:
    def __init__(
        self,
        env: BatchedEnv,
        policy: ActorCritic,
        ppo_cfg: PPOConfig = PPOConfig(),
        run_cfg: TrainerConfig = TrainerConfig(),
        measure_keys: Tuple[str, ...] = ("success", "spl", "distance_to_goal"),
        *,
        rows: Optional[distributed.EnvRows] = None,
    ):
        w = distributed.world()
        if w.size > 1 and not run_cfg.use_mesh:
            raise ValueError(f"a process group of {w.size} ranks trains DD-PPO: use_mesh must be True "
                             "(the 'ddppo' trainer)")
        self.env = env
        self.policy = policy
        self.ppo_cfg = ppo_cfg
        self.run_cfg = run_cfg
        # a continuous action space (an ``action_dim`` and no
        # ``num_actions``) takes the Gaussian head, as the reference picks
        # its action distribution from the action space
        continuous = hasattr(env, "action_dim") and not hasattr(env, "num_actions")
        self.learner = PPOLearner(
            env, policy, ppo_cfg, measure_keys=measure_keys, action_type="gaussian" if continuous else "categorical",
            rows=rows,
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
        """Every rank calls this (the env rows are gathered); rank 0 writes."""
        counters = {
            "num_steps_done": self.num_steps_done,
            "num_updates_done": self.num_updates_done,
            "ckpt_count": self._ckpt_count,
        }
        state = {
            "policy": self.policy.state_dict(),
            "optimizer": self.learner.optimizer.state_dict(),
            "rollout_state": _rollout_state_dict(rs),
            **counters,
        }
        if self.learner.aux_loss is not None:
            state["aux_loss"] = self.learner.aux_loss.state_dict()
        if not distributed.rank0_only():
            return
        path = os.path.join(self._ckpt_dir(), name)
        # written whole, then renamed over the old one; through a file
        # object, since torch.save takes no file name that starts with "."
        with open(path + ".tmp", "wb") as f:
            torch.save(state, f)
        os.replace(path + ".tmp", path)
        with open(os.path.join(self._ckpt_dir(), name + ".meta.json"), "w") as f:
            json.dump(counters, f)

    def load_checkpoint(self, name: str) -> Dict:
        """Restore the policy, the optimizer (and an aux loss) and the
        counters; return the saved rollout state as saved (all N envs, on
        the CPU)."""
        with open(os.path.join(self._ckpt_dir(), name), "rb") as f:
            ck = torch.load(f, map_location="cpu", weights_only=True)
        self.policy.load_state_dict(ck["policy"])
        self.learner.optimizer.load_state_dict(ck["optimizer"])
        if self.learner.aux_loss is not None:
            self.learner.aux_loss.load_state_dict(ck["aux_loss"])
        self.num_steps_done = ck["num_steps_done"]
        self.num_updates_done = ck["num_updates_done"]
        self._ckpt_count = ck["ckpt_count"]
        return ck["rollout_state"]

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
        update's metrics with the windowed episode means. An error drops
        the process group before it propagates."""
        try:
            return self._train(seed, resume)
        except BaseException:
            distributed.abort()
            raise

    def _train(self, seed: int, resume: bool) -> Dict[str, float]:
        rc = self.run_cfg
        rank0 = distributed.rank0_only()
        stopper = EarlyStopper()
        rs = self.learner.init(seed)
        if resume and self.resume_state_exists():
            rs = _rollout_state_from_dict(self.load_checkpoint(".resume_state"), rs, self.learner.rows)
            self.learner.sync_from_rank0()
            logger.info("resumed at update %d, steps %d", self.num_updates_done, self.num_steps_done)
        writer = TensorboardWriter(rc.tensorboard_dir) if rc.tensorboard_dir and rank0 else None
        steps_per_update = self.ppo_cfg.num_steps * self.learner.n_global
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

            if self.num_updates_done % rc.log_interval == 0 and rc.verbose and rank0:
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
            # every rank stops after the same update
            dev = self.env.device
            if distributed.any_rank(stopper.should_exit, dev):
                self.save_checkpoint(rs, ".resume_state")
                if distributed.any_rank(stopper.should_requeue, dev):
                    requeue_job()
                break
        if writer is not None:
            writer.close()
        self.final_state = rs
        return last_metrics


@registry.register_trainer(name="ver")
class VERTrainer(PPOTrainer):
    """The ``ver`` trainer's name (reference rl/ver/ver_trainer.py), as the
    JAX package keeps it: variable experience rollout overlaps env workers,
    inference and learning across process pools because the reference's
    simulator is host-bound; here the batched env and the learner share one
    process per card, so it is the synchronous PPO trainer."""
