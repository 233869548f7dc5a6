"""Population play and two-agent PPO (port of
``habitat_tpu/baselines/multi_agent.py``; reference
habitat-baselines/habitat_baselines/rl/multi_agent/: MultiAgentAccessMgr
multi_agent_access_mgr.py:35, the pop_play_wrappers.py splitters and the
self-play wrappers).

A population is one stacked state dict: K parameter sets as tensors with a
leading population axis. Choosing an opponent per env lane is a gather over
that axis, and ``apply_population`` runs a function of (parameters, inputs)
with each lane's own set through ``torch.func.vmap``.

``TwoAgentPPOLearner`` trains two policies in one batched env whose
observations carry ``agent_0_`` / ``agent_1_`` prefixes and whose step takes
(N, 2) actions: both act at every step of one rollout, and each runs its own
GAE and PPO update on its own observations, log-probs and values against the
shared reward (reference RearrangeCooperateReward,
multi_agent_sensors.py:208). Each update is ``ppo_epoch`` Adam steps on the
whole (T, N) rollout, the value loss unclipped, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.baselines.ppo import PPOConfig, clip_by_global_norm_, compute_gae, make_optimizer
from habitat_torch.models.policy import evaluate_actions_stats, sample_action

StateDict = Dict[str, torch.Tensor]


def stack_params(param_sets: Sequence[StateDict]) -> StateDict:
    """K state dicts -> one with a leading population axis."""
    return {k: torch.stack([p[k].detach() for p in param_sets]) for k in param_sets[0]}


def select_params(stacked: StateDict, idx) -> StateDict:
    """A set by index (an int or a 0-d tensor), or (N,) indices -> each
    lane's set stacked along a leading lane axis."""
    return {k: v[idx] for k, v in stacked.items()}


def population_size(stacked: StateDict) -> int:
    return int(next(iter(stacked.values())).shape[0])


def apply_population(policy_apply: Callable, stacked: StateDict, lane_idx: torch.Tensor, *args):
    """``policy_apply(params, *lane_args)`` for each env lane with the lane's
    own parameter set (the reference's MultiPolicy batch split, here one
    vmapped call); ``args`` carry a leading lane axis."""
    return torch.func.vmap(policy_apply)(select_params(stacked, lane_idx), *args)


@dataclasses.dataclass
class AgentSpec:
    name: str
    learner: bool = True


class MultiAgentAccessMgr:
    """Per-agent access (reference multi_agent_access_mgr.py:35): the agents
    and a frozen opponent population of the learner's snapshots, sampled
    per lane from ``default_rng(seed)`` (population play, fictitious
    self-play)."""

    def __init__(self, agents: Sequence[AgentSpec], num_pool_agents_per_type: Sequence[int] = (1, 1), seed: int = 0):
        self.agents = list(agents)
        self.num_pool = list(num_pool_agents_per_type)
        self._rng = np.random.default_rng(seed)
        self._population: List[StateDict] = []
        self._stacked: Optional[StateDict] = None

    @property
    def nagents(self) -> int:
        return len(self.agents)

    def push_snapshot(self, params: StateDict, max_size: int = 8) -> None:
        """Add a frozen copy of ``params`` to the pool, dropping the oldest
        beyond ``max_size``."""
        self._population.append({k: v.detach().clone() for k, v in params.items()})
        if len(self._population) > max_size:
            self._population.pop(0)
        self._stacked = stack_params(self._population)

    @property
    def population(self) -> Optional[StateDict]:
        return self._stacked

    def sample_opponents(self, num_envs: int) -> np.ndarray:
        """Each lane's opponent index for the next rollout."""
        if not self._population:
            raise ValueError("push_snapshot first")
        return self._rng.integers(0, len(self._population), size=num_envs)

    def on_update_done(self, update_idx: int, params: StateDict, snapshot_every: int = 50) -> None:
        if update_idx % snapshot_every == 0:
            self.push_snapshot(params)


class SelfPlayWrapper:
    """Both sides play the learner's parameters (reference
    self_play_wrappers.py)."""

    def __init__(self, access_mgr: MultiAgentAccessMgr):
        self.mgr = access_mgr

    def opponent_params(self, learner_params: StateDict, num_envs: int) -> Tuple[StateDict, torch.Tensor]:
        dev = next(iter(learner_params.values())).device
        return learner_params, torch.zeros(num_envs, dtype=torch.int64, device=dev)


def agent_obs(obs: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Agent i's observations without their ``agent_{i}_`` prefix."""
    pre = f"agent_{i}_"
    return {k[len(pre):]: v for k, v in obs.items() if k.startswith(pre)}


@dataclasses.dataclass
class TwoAgentState:
    """What carries from one two-agent rollout to the next (the weights live
    in the policies)."""

    env_state: Any
    obs: Dict[str, torch.Tensor]
    hidden: List[torch.Tensor]  # per agent (N, L, S, H)
    prev_action: List[torch.Tensor]  # per agent (N,)
    not_done: torch.Tensor  # (N,)
    generator: torch.Generator
    update_idx: int = 0


@dataclasses.dataclass
class TwoAgentBatch:
    """One rollout: per agent (T, N) actions, log-probs, values and previous
    actions, the shared rewards, dones and masks, the observations."""

    obs: Dict[str, torch.Tensor]  # (T, N, ...) with the agents' prefixes
    actions: List[torch.Tensor]
    log_probs: List[torch.Tensor]
    values: List[torch.Tensor]
    prev_actions: List[torch.Tensor]
    rewards: torch.Tensor
    dones: torch.Tensor
    masks: torch.Tensor


class TwoAgentPPOLearner:
    """Joint PPO of two learned agents in one batched env (the reference's
    MultiAgentAccessMgr with MultiPolicy / MultiStorage / MultiUpdater).

    ``train_step(ts)`` is one rollout and one update; ``actions`` (T, N, 2)
    replays given actions instead of sampling (their log-probs are scored as
    the sampled ones would be)."""

    def __init__(self, env, policies: Sequence[torch.nn.Module], cfg: Optional[PPOConfig] = None):
        self.env = env
        self.policies = list(policies)
        if len(self.policies) != 2:
            raise ValueError(f"{len(self.policies)} policies; two agents need two")
        self.cfg = cfg or PPOConfig(num_steps=32, num_mini_batch=2, ppo_epoch=2)
        self.optimizers = [make_optimizer(p.parameters(), self.cfg) for p in self.policies]

    def init(self, seed: int = 0) -> TwoAgentState:
        env_state, obs = self.env.reset_fn()
        n, dev = self.env.num_envs, self.env.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return TwoAgentState(
            env_state=env_state, obs=obs, hidden=[p.initial_hidden(n) for p in self.policies],
            prev_action=[torch.zeros(n, dtype=torch.int64, device=dev) for _ in self.policies],
            not_done=torch.zeros(n, device=dev), generator=gen)

    @torch.no_grad()
    def collect_rollout(self, ts: TwoAgentState, actions: Optional[torch.Tensor] = None):
        """T steps of both policies -> sample -> ``env.step_fn(state, (N,
        2))``. Returns (new state, batch, bootstrap values per agent, the
        rollout's initial hidden states, rollout metrics)."""
        T, n, dev = self.cfg.num_steps, self.env.num_envs, self.env.device
        env_state, obs, not_done = ts.env_state, ts.obs, ts.not_done
        hidden, prev = list(ts.hidden), list(ts.prev_action)
        steps = []
        done_count, m_success = torch.zeros((), device=dev), torch.zeros((), device=dev)
        for t in range(T):
            acts, logps, vals, new_hidden = [], [], [], []
            for i, pol in enumerate(self.policies):
                logits, v, nh = pol(agent_obs(obs, i), hidden[i], prev[i], not_done)
                if actions is None:
                    a, lp = sample_action(logits, ts.generator)
                else:
                    a = actions[t, :, i].to(dev).long()
                    lp = evaluate_actions_stats(logits, a)[0]
                acts.append(a)
                logps.append(lp)
                vals.append(v)
                new_hidden.append(nh)
            env_state, new_obs, reward, done, info = self.env.step_fn(env_state, torch.stack(acts, dim=1))
            done_f = done.float()
            done_count += done_f.sum()
            m_success += (info.get("success", torch.zeros_like(done_f)) * done_f).sum()
            steps.append((obs, acts, logps, vals, prev, reward, done_f, not_done))
            obs, hidden, prev, not_done = new_obs, new_hidden, acts, 1.0 - done_f
        cols = list(zip(*steps))

        def per_agent(col):
            return [torch.stack([s[i] for s in col]) for i in range(2)]

        batch = TwoAgentBatch(
            obs={k: torch.stack([o[k] for o in cols[0]]) for k in cols[0][0]},
            actions=per_agent(cols[1]), log_probs=per_agent(cols[2]), values=per_agent(cols[3]),
            prev_actions=per_agent(cols[4]), rewards=torch.stack(cols[5]), dones=torch.stack(cols[6]),
            masks=torch.stack(cols[7]))
        last_values = [pol(agent_obs(obs, i), hidden[i], prev[i], not_done)[1] for i, pol in enumerate(self.policies)]
        new_ts = dataclasses.replace(ts, env_state=env_state, obs=obs, hidden=hidden, prev_action=prev,
                                     not_done=not_done)
        metrics = {"done_count": done_count, "m_success": m_success,
                   "reward_step_mean": batch.rewards.mean()}
        return new_ts, batch, last_values, list(ts.hidden), metrics

    def update(self, batch: TwoAgentBatch, last_values: List[torch.Tensor],
               h_starts: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per agent: GAE on the shared rewards and its own values, then
        ``ppo_epoch`` Adam steps of the clipped-surrogate loss over the whole
        rollout from its initial hidden state. Returns each agent's loss at
        its last step (``losses/agent{i}_loss``)."""
        cfg = self.cfg
        metrics = {}
        for i, (pol, opt) in enumerate(zip(self.policies, self.optimizers)):
            adv, ret = compute_gae(batch.rewards, batch.values[i], batch.dones, last_values[i], cfg.gamma, cfg.tau)
            obs_i = agent_obs(batch.obs, i)
            params = [p for p in pol.parameters() if p.requires_grad]
            for _ in range(cfg.ppo_epoch):
                logits, values, _ = pol(obs_i, h_starts[i], batch.prev_actions[i], batch.masks)
                logp, ent = evaluate_actions_stats(logits, batch.actions[i])
                ratio = torch.exp(logp - batch.log_probs[i])
                surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
                loss = (-surr.mean() + cfg.value_loss_coef * (0.5 * ((values - ret) ** 2).mean())
                        - cfg.entropy_coef * ent.mean())
                opt.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_([p.grad for p in params], cfg.max_grad_norm)
                opt.step()
            metrics[f"losses/agent{i}_loss"] = loss.detach()
        return metrics

    def train_step(self, ts: TwoAgentState, actions: Optional[torch.Tensor] = None):
        """One rollout and one update: (new state, metrics as 0-d tensors on
        the env's device)."""
        ts, batch, last_values, h_starts, metrics = self.collect_rollout(ts, actions)
        metrics.update(self.update(batch, last_values, h_starts))
        return dataclasses.replace(ts, update_idx=ts.update_idx + 1), metrics
