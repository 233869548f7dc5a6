"""PPO rollout collection (port of the rollout half of
``habitat_tpu/baselines/ppo.py``): T steps of policy act -> sample ->
``env.step_fn``, stored as one ``RolloutBatch``, plus the bootstrap value.
The update (GAE, clipped-surrogate epochs, optimizer) consumes the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from habitat_torch.core.batched_env import BatchedEnv, EnvState
from habitat_torch.models.policy import ActorCritic, sample_action


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The rollout's settings (reference rl.ppo defaults); the update's
    (epochs, minibatches, clipping, optimizer, GAE) join with the update."""

    num_steps: int = 128


class RolloutBatch(NamedTuple):
    obs: Dict[str, torch.Tensor]  # (T, N, ...)
    actions: torch.Tensor  # (T, N)
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor  # (T, N)
    rewards: torch.Tensor  # (T, N)
    dones: torch.Tensor  # (T, N) — done AFTER step t
    masks: torch.Tensor  # (T, N) — 1 - done BEFORE step t ("not done" input mask)
    prev_actions: torch.Tensor  # (T, N)


@dataclasses.dataclass
class RolloutState:
    """What carries from one rollout to the next (the policy's weights live
    in the policy module)."""

    env_state: EnvState
    obs: Dict[str, torch.Tensor]
    hidden: torch.Tensor  # (N, L, 2, H)
    prev_action: torch.Tensor  # (N,) int32
    not_done: torch.Tensor  # (N,) float 1.0 = episode continues
    generator: torch.Generator
    ep_return_acc: torch.Tensor  # (N,) running return of the current episode
    ep_len_acc: torch.Tensor  # (N,)


class PPOLearner:
    def __init__(
        self,
        env: BatchedEnv,
        policy: ActorCritic,
        cfg: PPOConfig = PPOConfig(),
        *,
        measure_keys: Tuple[str, ...] = ("success", "spl", "distance_to_goal"),
    ):
        self.env = env
        self.policy = policy
        self.cfg = cfg
        self.measure_keys = measure_keys

    def init(self, seed: int = 0) -> RolloutState:
        """Reset the envs; zero hidden state, previous action and not_done."""
        env_state, obs = self.env.reset_fn()
        n, dev = self.env.num_envs, self.env.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return RolloutState(
            env_state=env_state,
            obs=obs,
            hidden=self.policy.initial_hidden(n),
            prev_action=torch.zeros(n, dtype=torch.int32, device=dev),
            not_done=torch.zeros(n, device=dev),
            generator=gen,
            ep_return_acc=torch.zeros(n, device=dev),
            ep_len_acc=torch.zeros(n, device=dev),
        )

    @torch.no_grad()
    def collect_rollout(
        self, rs: RolloutState
    ) -> Tuple[RolloutState, RolloutBatch, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """T steps of act -> sample -> env step. Returns (new state, batch,
        bootstrap value (N,), the rollout's initial hidden state, episode
        stats summed over the rollout)."""
        cfg = self.cfg
        env_state, obs, hidden = rs.env_state, rs.obs, rs.hidden
        prev_action, not_done = rs.prev_action, rs.not_done
        ep_ret, ep_len = rs.ep_return_acc, rs.ep_len_acc
        steps = []
        dev = self.env.device
        stats = {"reward_sum": torch.zeros((), device=dev), "len_sum": torch.zeros((), device=dev),
                 "done_count": torch.zeros((), device=dev)}
        for k in self.measure_keys:
            stats[f"m_{k}"] = torch.zeros((), device=dev)
        for _ in range(cfg.num_steps):
            logits, value, new_hidden = self.policy(obs, hidden, prev_action, not_done)
            action, logp = sample_action(logits, rs.generator)
            env_state, new_obs, reward, done, info = self.env.step_fn(env_state, action)
            done_f = done.float()
            ep_ret = ep_ret + reward
            ep_len = ep_len + 1.0
            stats["reward_sum"] += (ep_ret * done_f).sum()
            stats["len_sum"] += (ep_len * done_f).sum()
            stats["done_count"] += done_f.sum()
            for k in self.measure_keys:
                if k in info:
                    stats[f"m_{k}"] += (info[k] * done_f).sum()
            # float visual observations are stored as bfloat16: the policy
            # consumes them in bf16 and depth dominates the rollout's memory
            store = {
                k: v.to(torch.bfloat16) if v.dtype == torch.float32 and v.dim() >= 4 else v
                for k, v in obs.items()
            }
            steps.append((store, action, logp, value, reward, done_f, not_done, prev_action))
            ep_ret = ep_ret * (1.0 - done_f)
            ep_len = ep_len * (1.0 - done_f)
            obs, hidden, prev_action, not_done = new_obs, new_hidden, action, 1.0 - done_f
        cols = list(zip(*steps))
        batch = RolloutBatch(
            obs={k: torch.stack([o[k] for o in cols[0]]) for k in cols[0][0]},
            actions=torch.stack(cols[1]),
            log_probs=torch.stack(cols[2]),
            values=torch.stack(cols[3]),
            rewards=torch.stack(cols[4]),
            dones=torch.stack(cols[5]),
            masks=torch.stack(cols[6]),
            prev_actions=torch.stack(cols[7]),
        )
        # bootstrap value at the rollout's end
        _, last_value, _ = self.policy(obs, hidden, prev_action, not_done)
        new_rs = dataclasses.replace(
            rs,
            env_state=env_state,
            obs=obs,
            hidden=hidden,
            prev_action=prev_action,
            not_done=not_done,
            ep_return_acc=ep_ret,
            ep_len_acc=ep_len,
        )
        return new_rs, batch, last_value, rs.hidden, stats
