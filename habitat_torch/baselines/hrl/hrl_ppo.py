"""HRL-PPO: a neural high-level policy that picks skills, trained with PPO
(port of ``habitat_tpu/baselines/hrl/hrl_ppo.py``; reference
hl/neural_policy.py:24 and the HRL wiring of hierarchical_policy.py with
HrlRolloutStorage).

The reference records a transition when a skill ends (macro steps of
varying length). As in the JAX package, the high-level policy here picks a
skill every ``hl_interval`` env steps instead: the window's rewards,
discounted by gamma^t and cut at the first done, form one macro reward, and
PPO runs on the (num_macro_steps, N) macro transitions with the discount
gamma^hl_interval. The skills act as in ``hierarchical.py``.

``HrlPPOLearner.train_step`` is one rollout and one update:

- the rollout: per macro step, the state features (the env's non-visual
  observations, flattened in sorted key order, and each skill's
  ``is_done``), the net's logits and value, a skill drawn per env from the
  learner's generator (or given), then ``hl_interval`` env steps; success
  and done are counted at the steps where an episode ends;
- the update: GAE (``ppo.compute_gae``), the advantage normalised with the
  population std (``jnp.std``'s), then ``ppo_epoch`` epochs of
  ``num_mini_batch`` contiguous minibatches of the flattened (T * N)
  transitions in order (the net is feed-forward, so any order will do; no
  permutation), each a clipped-surrogate loss without value clipping,
  clipping by global norm and Adam (eps 1e-5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.baselines.hrl.hierarchical import Skill, skill_actions, skill_dones
from habitat_torch.baselines.ppo import clip_by_global_norm_, compute_gae
from habitat_torch.core.logging import logger
from habitat_torch.core.registry import registry
from habitat_torch.models.policy import sample_action


@dataclasses.dataclass(frozen=True)
class HrlPPOConfig:
    """The high-level PPO's settings (the reference's ppo.yaml defaults;
    the hidden width of neural_policy.py's MLP)."""

    num_macro_steps: int = 16  # HL decisions per rollout
    hl_interval: int = 8  # env steps per HL decision
    hidden_size: int = 128
    lr: float = 2.5e-4
    gamma: float = 0.99
    tau: float = 0.95
    clip_param: float = 0.2
    ppo_epoch: int = 2
    num_mini_batch: int = 2
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    max_grad_norm: float = 0.2


def _dense(in_features: int, out_features: int) -> nn.Linear:
    """A Linear initialised as Flax's Dense: LeCun-normal weight (a normal
    truncated at 2 std, rescaled to unit variance per fan-in), zero bias."""
    layer = nn.Linear(in_features, out_features)
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


class HighLevelNet(nn.Module):
    """An MLP actor-critic over the state-feature vector (reference
    neural_policy.py:24): two tanh layers, then the logits and the value."""

    def __init__(self, in_features: int, num_skills: int, hidden_size: int = 128):
        super().__init__()
        self.fc0 = _dense(in_features, hidden_size)
        self.fc1 = _dense(hidden_size, hidden_size)
        self.actor = _dense(hidden_size, num_skills)
        self.critic = _dense(hidden_size, 1)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.tanh(self.fc1(torch.tanh(self.fc0(feat))))
        return self.actor(x), self.critic(x)[..., 0]


@dataclasses.dataclass
class HrlTrainState:
    env_state: Any
    generator: torch.Generator  # the skill draws
    update_idx: int = 0


def _state_keys(observation_shapes) -> Tuple[Tuple[str, int], ...]:
    """(key, width) of the observations the features take: those with at
    most one dimension per env and not uint8 (the frames), in sorted order."""
    return tuple((k, int(np.prod(shape))) for k, (shape, dtype) in sorted(observation_shapes.items())
                 if len(shape) <= 1 and dtype != torch.uint8)


class HrlPPOLearner:
    """The high-level rollout and its PPO update (``PPOLearner``'s shape for
    the skill level). The net lives on the env's device; its width is read
    from the env's ``observation_shapes``."""

    def __init__(self, env, skills: Sequence[Skill], config: HrlPPOConfig = HrlPPOConfig()):
        self.env = env
        self.skills = list(skills)
        self.cfg = config
        self._keys = _state_keys(env.observation_shapes)
        width = sum(w for _, w in self._keys) + len(self.skills)
        self.net = HighLevelNet(width, len(self.skills), config.hidden_size).to(env.device)
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=config.lr, eps=1e-5)

    def features(self, state) -> torch.Tensor:
        """(N, F): the non-visual observations, then which skills report
        done."""
        obs = self.env._observations(state)
        n = self.env.num_envs
        parts = [obs[k].reshape(n, -1).float() for k, _ in self._keys]
        parts.append(torch.stack(skill_dones(self.env, self.skills, state), dim=-1).float())
        return torch.cat(parts, dim=-1)

    def init(self, seed: int = 0) -> HrlTrainState:
        """Reset the envs; the generator of the skill draws."""
        env_state, _ = self.env.reset_fn()
        return HrlTrainState(env_state, torch.Generator(device=self.env.device).manual_seed(seed))

    @torch.no_grad()
    def collect_rollout(self, ts: HrlTrainState, skills: Optional[torch.Tensor] = None
                        ) -> Tuple[HrlTrainState, Dict[str, torch.Tensor]]:
        """``num_macro_steps`` macro steps of ``hl_interval`` env steps.
        ``skills`` (num_macro_steps, N) replaces the draws. Returns the new
        state and the batch: ``feats`` (T, N, F), ``skills``, ``log_probs``,
        ``values``, ``rewards`` (the discounted window sums), ``dones``
        (an episode ended in the window), ``success`` and ``done_count``
        (per env, summed over the windows' done steps), ``last_value``."""
        cfg, env = self.cfg, self.env
        n, dev = env.num_envs, env.device
        env_state = ts.env_state
        discounts = [float(np.float32(cfg.gamma) ** np.float32(t)) for t in range(cfg.hl_interval)]
        cols = {k: [] for k in ("feats", "skills", "log_probs", "values", "rewards", "dones")}
        succ = torch.zeros(n, device=dev)
        done_count = torch.zeros(n, device=dev)
        for t in range(cfg.num_macro_steps):
            feat = self.features(env_state)
            logits, value = self.net(feat)
            if skills is None:
                skill, logp = sample_action(logits, ts.generator)
                skill = skill.long()
            else:
                skill = skills[t].long()
                logp = F.log_softmax(logits.float(), dim=-1).gather(-1, skill[:, None])[:, 0]
            rew = torch.zeros(n, device=dev)
            done_any = torch.zeros(n, device=dev)
            for i in range(cfg.hl_interval):
                act = skill_actions(env, self.skills, env_state, skill)
                env_state, _, r, done, info = env.step_fn(env_state, act)
                df = done.float()
                rew = rew + discounts[i] * r * (1.0 - done_any)
                done_any = torch.maximum(done_any, df)
                succ += info["success"] * df
                done_count += df
            for k, v in zip(cols, (feat, skill, logp, value, rew, done_any)):
                cols[k].append(v)
        batch = {k: torch.stack(v) for k, v in cols.items()}
        batch.update(success=succ, done_count=done_count, last_value=self.net(self.features(env_state))[1])
        return dataclasses.replace(ts, env_state=env_state), batch

    def _loss(self, f, a, old_lp, adv, ret) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        logits, value = self.net(f)
        lp_all = F.log_softmax(logits, dim=-1)
        ratio = torch.exp(lp_all.gather(-1, a[:, None])[:, 0] - old_lp)
        surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        entropy = -(lp_all.exp() * lp_all).sum(-1).mean()
        v_loss = 0.5 * ((value - ret) ** 2).mean()
        return -surr.mean() + cfg.value_loss_coef * v_loss - cfg.entropy_coef * entropy, v_loss, entropy

    def update(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """GAE, then ``ppo_epoch`` x ``num_mini_batch`` Adam steps; returns
        the loss terms averaged over the steps, ``advantages`` and
        ``returns``."""
        cfg = self.cfg
        adv, ret = compute_gae(batch["rewards"], batch["values"], batch["dones"], batch["last_value"],
                               cfg.gamma ** cfg.hl_interval, cfg.tau)
        flat_adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)
        data = [batch["feats"].flatten(0, 1), batch["skills"].flatten(), batch["log_probs"].flatten(),
                flat_adv.flatten(), ret.flatten()]
        mb = data[0].shape[0] // cfg.num_mini_batch
        params = list(self.net.parameters())
        terms = []
        for _ in range(cfg.ppo_epoch):
            for i in range(cfg.num_mini_batch):
                loss, v_loss, entropy = self._loss(*(x[i * mb:(i + 1) * mb] for x in data))
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_([p.grad for p in params], cfg.max_grad_norm)
                self.optimizer.step()
                terms.append(torch.stack([loss, v_loss, entropy]).detach())
        mean = torch.stack(terms).mean(0)
        return {"losses/hl_loss": mean[0], "losses/hl_value_loss": mean[1], "losses/hl_entropy": mean[2],
                "advantages": adv, "returns": ret}

    def train_step(self, ts: HrlTrainState, skills: Optional[torch.Tensor] = None
                   ) -> Tuple[HrlTrainState, Dict[str, torch.Tensor]]:
        """One rollout (``skills``: given draws, (num_macro_steps, N)) and
        one update. Metrics (0-d tensors): the loss terms, ``reward`` (the
        macro rewards summed over the rollout, mean over envs), ``success``
        (the share of episodes that ended in the rollout with success) and
        ``done_count``."""
        ts, batch = self.collect_rollout(ts, skills)
        out = self.update(batch)
        done = batch["done_count"].sum()
        metrics = {k: v for k, v in out.items() if k.startswith("losses/")}
        metrics.update(reward=batch["rewards"].sum(0).mean(), success=batch["success"].sum() / done.clamp(min=1.0),
                       done_count=done)
        return dataclasses.replace(ts, update_idx=ts.update_idx + 1), metrics


registry.register_updater(HrlPPOLearner, name="hrl_ppo")


class HrlTrainer:
    """The trainer face of ``HrlPPOLearner`` (``train``, as ``PPOTrainer``
    has), so hierarchical experiment YAMLs (reference rl_hierarchical.yaml,
    updater_name HRLPPO) run through ``run.py`` / ``trainer_from_config``."""

    def __init__(self, learner: HrlPPOLearner, *, total_num_steps: float = 1e6, log_interval: int = 10):
        self.learner = learner
        self.env = learner.env
        self.total_num_steps = total_num_steps
        self.log_interval = log_interval
        self.num_updates_done = 0

    def train(self, seed: int = 0) -> Dict[str, float]:
        """Updates until ``total_num_steps`` env steps; returns the last
        update's metrics as floats."""
        cfg = self.learner.cfg
        steps_per_update = self.env.num_envs * cfg.num_macro_steps * cfg.hl_interval
        ts = self.learner.init(seed)
        steps, m = 0, {}
        while steps < self.total_num_steps:
            ts, m = self.learner.train_step(ts)
            steps += steps_per_update
            self.num_updates_done += 1
            if self.num_updates_done % self.log_interval == 0:
                logger.info(f"hrl update {self.num_updates_done} steps {steps}: "
                            + " ".join(f"{k}={v.item():.4f}" for k, v in sorted(m.items())))
        return {k: v.item() for k, v in m.items()}
