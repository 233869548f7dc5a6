"""PPO for the categorical and the Gaussian policy (port of
``habitat_tpu/baselines/ppo.py``).

``PPOLearner.train_step`` is one rollout and one update:

- the rollout: T steps of policy act -> sample -> ``env.step_fn``, stored
  as one ``RolloutBatch``, plus the bootstrap value;
- the update: GAE, then ``ppo_epoch`` epochs, each over a fresh permutation
  of the env index drawn from the rollout state's generator, of
  ``num_mini_batch`` minibatch steps: the clipped-surrogate loss over the
  minibatch's (T, N/num_mini_batch) sequences from the rollout's initial
  hidden state, its gradient (the stem max pool's backward is the CUDA
  kernel of ``ops/pool.py`` on the card), clipping by global norm, Adam.

The env is any batched env of the port with ``reset_fn()``, ``step_fn(state,
actions)``, ``num_envs`` and ``device``: the PointNav ``BatchedEnv`` or the
rearrangement ``RearrangeBatchedEnv`` (whose Pick users pass
``measure_keys=("success", "pick_success")``). Float image observations are
stored in bfloat16; state sensors stay float32.

``action_type="gaussian"`` (a ``GaussianActorCritic`` on an env with a
continuous ``action_dim``) stores (T, N, A) float32 actions and previous
actions, samples mu + std * N(0, 1) from the rollout state's generator and
scores stored actions by the diagonal Gaussian's log prob and entropy; the
previous action at an episode's start is zeros (N, A).

Math (reference rl/ppo/ppo.py, common/rollout_storage.py):
- GAE: delta = r + gamma*V'*nd - V;  A = delta + gamma*tau*nd*A'
- policy loss: -mean(min(ratio*A, clip(ratio, 1-c, 1+c)*A))
- value loss: 0.5*mean(max((v-R)^2, (v_clip-R)^2)) when clipped
- total: policy + value_loss_coef*value - entropy_coef*entropy
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Protocol, Tuple

import torch

from habitat_torch.models.policy import (
    ActorCritic,
    evaluate_actions_stats,
    evaluate_gaussian_actions,
    sample_action,
    sample_gaussian_action,
)


class BatchedEnvLike(Protocol):
    """What the learner uses of a batched env."""

    num_envs: int
    device: torch.device

    def reset_fn(self) -> Tuple[Any, Dict[str, torch.Tensor]]: ...

    def step_fn(self, state: Any, actions: torch.Tensor) -> tuple: ...


# PPOConfig switches of the JAX package that the port does not have yet
_NOT_PORTED = (
    "use_linear_lr_decay", "use_linear_clip_decay", "use_normalized_advantage", "use_adaptive_entropy_pen",
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Defaults of the reference's rl.ppo config, as in the JAX package.
    The switches in ``_NOT_PORTED`` raise ``NotImplementedError`` when set."""

    clip_param: float = 0.2
    ppo_epoch: int = 4
    num_mini_batch: int = 2
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 2.5e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.2
    num_steps: int = 128
    gamma: float = 0.99
    tau: float = 0.95
    use_clipped_value_loss: bool = True
    use_linear_lr_decay: bool = False
    use_linear_clip_decay: bool = False
    use_normalized_advantage: bool = False
    use_adaptive_entropy_pen: bool = False

    def __post_init__(self):
        for name in _NOT_PORTED:
            if getattr(self, name):
                raise NotImplementedError(f"PPOConfig.{name} is not ported to habitat_torch yet")


class RolloutBatch(NamedTuple):
    obs: Dict[str, torch.Tensor]  # (T, N, ...)
    actions: torch.Tensor  # (T, N), or (T, N, A) float32 for a Gaussian policy
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor  # (T, N)
    rewards: torch.Tensor  # (T, N)
    dones: torch.Tensor  # (T, N) — done AFTER step t
    masks: torch.Tensor  # (T, N) — 1 - done BEFORE step t ("not done" input mask)
    prev_actions: torch.Tensor  # (T, N), or (T, N, A)


@dataclasses.dataclass
class RolloutState:
    """What carries from one rollout to the next (the policy's weights live
    in the policy module)."""

    env_state: Any  # the env's state: EnvState or RearrangeState
    obs: Dict[str, torch.Tensor]
    hidden: torch.Tensor  # (N, L, 2, H)
    prev_action: torch.Tensor  # (N,) int32, or (N, A) float32
    not_done: torch.Tensor  # (N,) float 1.0 = episode continues
    generator: torch.Generator
    ep_return_acc: torch.Tensor  # (N,) running return of the current episode
    ep_len_acc: torch.Tensor  # (N,)


def compute_gae(
    rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor, last_value: torch.Tensor,
    gamma: float, tau: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, N) rewards, values, dones (done after step t) and the bootstrap
    value (N,) -> (advantages, returns), reference rollout_storage.py:174."""
    nd = 1.0 - dones.float()
    advs = torch.empty_like(values)
    adv, v_next = torch.zeros_like(last_value), last_value
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + gamma * v_next * nd[t] - values[t]
        adv = delta + gamma * tau * nd[t] * adv
        advs[t] = adv
        v_next = values[t]
    return advs, advs + values


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / max(norm, max_norm), norm being
    their global L2 norm (optax.clip_by_global_norm; unlike
    ``clip_grad_norm_``, no epsilon is added to the norm). Returns the norm
    before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


class PPOLearner:
    def __init__(
        self,
        env: BatchedEnvLike,
        policy: ActorCritic,
        cfg: PPOConfig = PPOConfig(),
        *,
        measure_keys: Tuple[str, ...] = ("success", "spl", "distance_to_goal"),
        action_type: str = "categorical",
    ):
        if env.num_envs % cfg.num_mini_batch:
            raise ValueError(f"{env.num_envs} envs do not split into {cfg.num_mini_batch} minibatches")
        if action_type not in ("categorical", "gaussian"):
            raise ValueError(f"action_type {action_type!r}: categorical or gaussian")
        self.env = env
        self.policy = policy
        self.cfg = cfg
        self.measure_keys = measure_keys
        self.action_type = action_type
        # the JAX package's optax chain: clip by global norm, then Adam;
        # ``update`` clips with ``clip_by_global_norm_`` before each step
        self.optimizer = torch.optim.Adam(policy.parameters(), lr=cfg.lr, eps=cfg.eps)

    def _zero_action(self, n: int, dev) -> torch.Tensor:
        if self.action_type == "gaussian":
            return torch.zeros((n, self.env.action_dim), device=dev)
        return torch.zeros(n, dtype=torch.int32, device=dev)

    def _sample(self, dist, generator):
        if self.action_type == "gaussian":
            return sample_gaussian_action(*dist, generator)
        return sample_action(dist, generator)

    def _evaluate(self, dist, actions):
        if self.action_type == "gaussian":
            return evaluate_gaussian_actions(*dist, actions)
        return evaluate_actions_stats(dist, actions)

    def init(self, seed: int = 0) -> RolloutState:
        """Reset the envs; zero hidden state, previous action and not_done;
        the generator that samples actions and permutes minibatches."""
        env_state, obs = self.env.reset_fn()
        n, dev = self.env.num_envs, self.env.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return RolloutState(
            env_state=env_state,
            obs=obs,
            hidden=self.policy.initial_hidden(n),
            prev_action=self._zero_action(n, dev),
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
            dist, value, new_hidden = self.policy(obs, hidden, prev_action, not_done)
            action, logp = self._sample(dist, rs.generator)
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

    def _loss_fn(self, mb: Dict, h0_mb: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Clipped-surrogate loss of one minibatch: ``mb`` holds (T, n)
        leaves (obs leaves (T, n, ...)), ``h0_mb`` (n, L, 2, H)."""
        cfg = self.cfg
        dist, values, _ = self.policy(mb["obs"], h0_mb, mb["prev_actions"], mb["masks"])
        logp, entropy = self._evaluate(dist, mb["actions"])
        ratio = torch.exp(logp - mb["log_probs"])
        adv = mb["advantages"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv
        action_loss = -torch.minimum(surr1, surr2).mean()
        ret = mb["returns"]
        if cfg.use_clipped_value_loss:
            v_clip = mb["values"] + torch.clamp(values - mb["values"], -cfg.clip_param, cfg.clip_param)
            value_loss = 0.5 * torch.maximum((values - ret) ** 2, (v_clip - ret) ** 2).mean()
        else:
            value_loss = 0.5 * ((values - ret) ** 2).mean()
        ent = entropy.mean()
        total = action_loss + cfg.value_loss_coef * value_loss - cfg.entropy_coef * ent
        aux = {
            "losses/learner_loss": total,
            "losses/action_loss": action_loss,
            "losses/value_loss": value_loss,
            "losses/entropy": ent,
        }
        return total, {k: v.detach() for k, v in aux.items()}

    def update(
        self, generator: torch.Generator, batch: RolloutBatch, last_value: torch.Tensor, h0: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """GAE, then ``ppo_epoch`` epochs of ``num_mini_batch`` Adam steps on
        the policy's parameters. Each epoch permutes the env index with
        ``torch.randperm`` on ``generator``; minibatch i takes envs
        perm[i*n:(i+1)*n] with ``index_select``. Returns the loss terms and
        the pre-clip gradient norm, averaged over all minibatch steps."""
        cfg = self.cfg
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones, last_value, cfg.gamma, cfg.tau)
        data = {
            "actions": batch.actions, "log_probs": batch.log_probs, "values": batch.values,
            "prev_actions": batch.prev_actions, "masks": batch.masks,
            "advantages": advantages, "returns": returns,
        }
        n = self.env.num_envs
        mb_size = n // cfg.num_mini_batch
        params = [p for p in self.policy.parameters() if p.requires_grad]
        steps = []
        for _ in range(cfg.ppo_epoch):
            perm = torch.randperm(n, generator=generator, device=generator.device)
            for i in range(cfg.num_mini_batch):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = {k: v.index_select(1, idx) for k, v in data.items()}
                mb["obs"] = {k: v.index_select(1, idx) for k, v in batch.obs.items()}
                self.optimizer.zero_grad(set_to_none=True)
                loss, aux = self._loss_fn(mb, h0.index_select(0, idx))
                loss.backward()
                aux["grad_norm"] = clip_by_global_norm_([p.grad for p in params], cfg.max_grad_norm)
                self.optimizer.step()
                steps.append(aux)
        return {k: torch.stack([s[k] for s in steps]).mean() for k in steps[0]}

    def train_step(self, rs: RolloutState) -> Tuple[RolloutState, Dict[str, torch.Tensor]]:
        """One rollout and one update. Metrics: the update's loss terms and
        ``grad_norm``, the rollout's episode sums (``reward_sum``,
        ``len_sum``, ``done_count``, ``m_<measure>``) and
        ``reward_step_mean``, as 0-d tensors on the env's device."""
        rs, batch, last_value, h0, stats = self.collect_rollout(rs)
        metrics = self.update(rs.generator, batch, last_value, h0)
        metrics.update(stats)
        metrics["reward_step_mean"] = batch.rewards.mean()
        return rs, metrics
