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
stored in bfloat16 (``obs_store_bf16``); state sensors stay float32.

``PPOConfig``'s switches act as in the JAX package (normalized advantage,
linear LR decay, the Gaussian policy's adaptive entropy coefficient; the
clip-decay switch is inert there and here); CPC|A rides along as
``aux_loss``; under a process group the learner is DD-PPO (``PPOLearner``).

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
import math
from typing import Any, Dict, List, NamedTuple, Optional, Protocol, Tuple

import torch

from habitat_torch.models.policy import (
    ActorCritic,
    evaluate_actions_stats,
    evaluate_gaussian_actions,
    sample_action,
    sample_gaussian_action,
)
from habitat_torch.parallel import distributed
from habitat_torch.utils.common import LagrangeInequalityCoefficient


class BatchedEnvLike(Protocol):
    """What the learner uses of a batched env."""

    num_envs: int
    device: torch.device

    def reset_fn(self) -> Tuple[Any, Dict[str, torch.Tensor]]: ...

    def step_fn(self, state: Any, actions: torch.Tensor) -> tuple: ...


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Defaults of the reference's rl.ppo config, as in the JAX package.

    As there: ``use_gae`` and ``use_linear_clip_decay`` are accepted and
    read by nothing (GAE always runs, the clip never decays);
    ``reward_window_size`` is the trainer's; ``use_linear_lr_decay`` decays
    the learning rate linearly to 0 over ``total_updates * ppo_epoch *
    num_mini_batch`` optimizer steps only when the learner is given
    ``total_updates`` (the trainer and the YAML never give it);
    ``use_adaptive_entropy_pen`` applies to the Gaussian policy only;
    ``obs_store_bf16`` stores float visual observations in bfloat16."""

    clip_param: float = 0.2
    ppo_epoch: int = 4
    num_mini_batch: int = 2
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 2.5e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.2
    num_steps: int = 128
    use_gae: bool = True
    gamma: float = 0.99
    tau: float = 0.95
    use_linear_lr_decay: bool = False
    use_linear_clip_decay: bool = False
    use_clipped_value_loss: bool = True
    use_normalized_advantage: bool = False
    reward_window_size: int = 50
    # Lagrangian-adaptive entropy coefficient (reference rl/ppo/ppo.py:87-101):
    # alpha keeps the mean entropy above -entropy_target_factor * action_dim,
    # clamped to [1e-4, 1]
    use_adaptive_entropy_pen: bool = False
    entropy_target_factor: float = 0.0
    obs_store_bf16: bool = True


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
    in the policy module). Under a process group the env-indexed fields
    hold this rank's rows; the generator and ``log_alpha`` are the same on
    every rank."""

    env_state: Any  # the env's state: EnvState or RearrangeState
    obs: Dict[str, torch.Tensor]
    hidden: torch.Tensor  # (N, L, S, H)
    prev_action: torch.Tensor  # (N,) int32, or (N, A) float32
    not_done: torch.Tensor  # (N,) float 1.0 = episode continues
    generator: torch.Generator
    ep_return_acc: torch.Tensor  # (N,) running return of the current episode
    ep_len_acc: torch.Tensor  # (N,)
    # log of the adaptive entropy coefficient, 0-d float32 (read only with
    # use_adaptive_entropy_pen on a Gaussian policy)
    log_alpha: torch.Tensor = None


# the env-indexed fields of a RolloutState (the rest is replicated)
ENV_FIELDS = ("env_state", "obs", "hidden", "prev_action", "not_done", "ep_return_acc", "ep_len_acc")


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


def make_optimizer(params, cfg: PPOConfig) -> torch.optim.Adam:
    """The JAX package's optax chain without its clip: Adam at ``cfg.lr``
    and ``cfg.eps`` over ``params`` (tensors or param groups); callers clip
    the gradients with ``clip_by_global_norm_`` before each step."""
    return torch.optim.Adam(params, lr=cfg.lr, eps=cfg.eps)


class PPOLearner:
    """One rollout and one update at a time (``train_step``).

    Under a process group (``parallel/distributed.py``) it is DD-PPO: the
    env holds this rank's ``rows`` (a ``distributed.EnvRows``, the caller's
    ``env_rows(N)``, which also built the env) of the N global envs, and the
    step equals the one-process step at the same N and seed up to the
    rounding of cross-rank sums:
    - every random draw (action noise, the categorical draw, the epoch
      permutation, CPC|A's time permutation) is made at the global shape
      from the generator every rank holds, and the rank keeps its rows;
    - minibatch i is ``perm[i*mb:(i+1)*mb]`` over the global env index; a
      rank computes the loss over the members it holds (maybe none), each
      term summed and divided by the global count T*mb (CPC|A's denominator
      all-reduced first), and the gradients are summed over the ranks
      before the clip and Adam, so every rank takes the same step;
    - the rollout's episode sums and ``reward_step_mean`` are global;
    - ``init`` broadcasts rank 0's parameters and Adam state.

    ``total_updates`` with ``use_linear_lr_decay`` decays the learning rate
    (``make_optimizer`` of the JAX package). ``aux_loss`` (a
    ``baselines/aux_losses.CPCA``) adds ``aux_loss_coef`` times its loss;
    its parameters are the optimizer's second group."""

    def __init__(
        self,
        env: BatchedEnvLike,
        policy: ActorCritic,
        cfg: PPOConfig = PPOConfig(),
        *,
        measure_keys: Tuple[str, ...] = ("success", "spl", "distance_to_goal"),
        action_type: str = "categorical",
        total_updates: Optional[int] = None,
        aux_loss: Optional[torch.nn.Module] = None,
        aux_loss_coef: float = 1.0,
        rows: Optional[distributed.EnvRows] = None,
    ):
        self.world = distributed.world()
        self.rows = rows or distributed.EnvRows.all(env.num_envs)
        if self.rows.stop - self.rows.start != env.num_envs:
            raise ValueError(f"rows {self.rows} do not match the env's {env.num_envs} envs")
        if self.world.active and self.rows != distributed.env_rows(self.rows.n_global):
            raise ValueError(f"rank {self.world.rank} of {self.world.size} holds rows "
                             f"{distributed.env_rows(self.rows.n_global)}, not {self.rows}: build the env and "
                             "the learner from parallel.distributed.env_rows(N)")
        self.n_global = self.rows.n_global
        if self.n_global % cfg.num_mini_batch:
            raise ValueError(f"{self.n_global} envs do not split into {cfg.num_mini_batch} minibatches")
        if action_type not in ("categorical", "gaussian"):
            raise ValueError(f"action_type {action_type!r}: categorical or gaussian")
        self.env = env
        self.policy = policy
        self.cfg = cfg
        self.measure_keys = measure_keys
        self.action_type = action_type
        self.aux_loss = aux_loss
        self.aux_loss_coef = aux_loss_coef
        # ``update`` clips with ``clip_by_global_norm_`` before each step
        groups = [{"params": list(policy.parameters())}]
        if aux_loss is not None:
            groups.append({"params": list(aux_loss.parameters())})
        self.optimizer = make_optimizer(groups, cfg)
        self.lr_decay_steps = (
            total_updates * cfg.ppo_epoch * cfg.num_mini_batch if cfg.use_linear_lr_decay and total_updates else None
        )
        # adaptive entropy: Gaussian only, as the reference gates it
        self.adaptive_ent = cfg.use_adaptive_entropy_pen and action_type == "gaussian"
        if self.adaptive_ent:
            self.ent_threshold = -float(cfg.entropy_target_factor) * env.action_dim
            self.ent_coef = LagrangeInequalityCoefficient(self.ent_threshold, alpha_min=1e-4, alpha_max=1.0)

    def _zero_action(self, n: int, dev) -> torch.Tensor:
        if self.action_type == "gaussian":
            return torch.zeros((n, self.env.action_dim), device=dev)
        return torch.zeros(n, dtype=torch.int32, device=dev)

    def _sample(self, dist, generator):
        """Draw at the global batch from the replicated generator, keep this
        rank's rows."""
        dev = generator.device
        if self.action_type == "gaussian":
            noise = torch.randn((self.n_global, self.env.action_dim), generator=generator, device=dev)
            return sample_gaussian_action(*dist, generator, normal=noise[self.rows.slice])
        noise = torch.empty((self.n_global, dist.shape[-1]), device=dev).exponential_(1, generator=generator)
        return sample_action(dist, generator, exponential=noise[self.rows.slice])

    def _evaluate(self, dist, actions):
        if self.action_type == "gaussian":
            return evaluate_gaussian_actions(*dist, actions)
        return evaluate_actions_stats(dist, actions)

    def trained_parameters(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"] if p.requires_grad]

    def sync_from_rank0(self) -> None:
        """Broadcast rank 0's parameters and Adam state (no-op without a
        group)."""
        tensors = [p.data for g in self.optimizer.param_groups for p in g["params"]]
        for st in self.optimizer.state.values():  # Adam's moments (its step count is on the host)
            tensors += [v for k, v in st.items() if k != "step"]
        distributed.broadcast_(tensors)

    def init(self, seed: int = 0) -> RolloutState:
        """Reset the envs; zero hidden state, previous action and not_done;
        the generator that samples actions and permutes minibatches;
        log_alpha = log(entropy_coef). Broadcasts rank 0's weights."""
        env_state, obs = self.env.reset_fn()
        n, dev = self.env.num_envs, self.env.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.sync_from_rank0()
        return RolloutState(
            env_state=env_state,
            obs=obs,
            hidden=self.policy.initial_hidden(n),
            prev_action=self._zero_action(n, dev),
            not_done=torch.zeros(n, device=dev),
            generator=gen,
            ep_return_acc=torch.zeros(n, device=dev),
            ep_len_acc=torch.zeros(n, device=dev),
            log_alpha=torch.full((), math.log(self.cfg.entropy_coef), device=dev),
        )

    @torch.no_grad()
    def collect_rollout(
        self, rs: RolloutState
    ) -> Tuple[RolloutState, RolloutBatch, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """T steps of act -> sample -> env step. Returns (new state, batch,
        bootstrap value (N,), the rollout's initial hidden state, this
        rank's episode stats summed over the rollout)."""
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
            store = obs
            if cfg.obs_store_bf16:
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

    def _loss_fn(
        self, mb: Dict, h0_mb: torch.Tensor, *, count: Optional[int] = None, ent_coef=None,
        time_perm: Optional[torch.Tensor] = None, aux_count: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Clipped-surrogate loss of one minibatch: ``mb`` holds (T, n)
        leaves (obs leaves (T, n, ...)), ``h0_mb`` (n, L, S, H). Each term is
        summed and divided by ``count`` (the global minibatch's T*mb; None:
        the mean over ``mb``); ``ent_coef`` replaces ``entropy_coef``; with
        an aux loss, ``time_perm`` (T,) orders CPC|A's negatives and
        ``aux_count`` is its denominator (None: ``mb``'s own)."""
        cfg = self.cfg

        def mean(x):
            return x.mean() if count is None else x.sum() / count

        if self.aux_loss is not None:
            dist, values, _, visual, beliefs = self.policy(
                mb["obs"], h0_mb, mb["prev_actions"], mb["masks"], with_feats=True)
        else:
            dist, values, _ = self.policy(mb["obs"], h0_mb, mb["prev_actions"], mb["masks"])
        logp, entropy = self._evaluate(dist, mb["actions"])
        ratio = torch.exp(logp - mb["log_probs"])
        adv = mb["advantages"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv
        action_loss = -mean(torch.minimum(surr1, surr2))
        ret = mb["returns"]
        if cfg.use_clipped_value_loss:
            v_clip = mb["values"] + torch.clamp(values - mb["values"], -cfg.clip_param, cfg.clip_param)
            value_loss = 0.5 * mean(torch.maximum((values - ret) ** 2, (v_clip - ret) ** 2))
        else:
            value_loss = 0.5 * mean((values - ret) ** 2)
        ent = mean(entropy)
        coef = cfg.entropy_coef if ent_coef is None else ent_coef
        total = action_loss + cfg.value_loss_coef * value_loss - coef * ent
        aux = {
            "losses/learner_loss": total,
            "losses/action_loss": action_loss,
            "losses/value_loss": value_loss,
            "losses/entropy": ent,
        }
        if self.aux_loss is not None:
            # CPC|A: the beliefs (RNN output) predict the future visual
            # embedding; a Gaussian policy's actions enter as zeros
            T, n = mb["masks"].shape
            acts = mb["actions"] if mb["actions"].dim() == 2 else torch.zeros((T, n), dtype=torch.long,
                                                                                 device=values.device)
            num, den = self.aux_loss(beliefs, visual.reshape(T, n, -1), acts, mb["masks"], time_perm)
            cpca = num / torch.clamp(den if aux_count is None else aux_count, min=1.0)
            total = total + self.aux_loss_coef * cpca
            aux["losses/learner_loss"] = total
            aux["losses/cpca"] = cpca
        return total, {k: v.detach() for k, v in aux.items()}

    def _normalize(self, adv: torch.Tensor) -> torch.Tensor:
        """(adv - mean) / (std + 1e-5) over the global (T, N) advantages,
        the population std (jnp.std), mean and variance in two passes."""
        count = adv.shape[0] * self.n_global
        s = adv.sum().reshape(1)
        distributed.all_reduce_sum_([s])
        mean = s[0] / count
        sq = ((adv - mean) ** 2).sum().reshape(1)
        distributed.all_reduce_sum_([sq])
        return (adv - mean) / (torch.sqrt(sq[0] / count) + 1e-5)

    def _set_lr(self, params: List[torch.Tensor]) -> None:
        """optax.linear_schedule(lr, 0, steps) at the optimizer's step count
        (Adam's own, so it survives a checkpoint)."""
        st = self.optimizer.state.get(params[0])
        step = int(st["step"]) if st else 0
        lr = self.cfg.lr * (1.0 - min(step, self.lr_decay_steps) / self.lr_decay_steps)
        for g in self.optimizer.param_groups:
            g["lr"] = lr

    def update(
        self, generator: torch.Generator, batch: RolloutBatch, last_value: torch.Tensor, h0: torch.Tensor,
        log_alpha: Optional[torch.Tensor] = None, perms: Optional[torch.Tensor] = None,
        time_perms: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """GAE (normalized if asked), then ``ppo_epoch`` epochs of
        ``num_mini_batch`` Adam steps. Each epoch permutes the global env
        index with ``torch.randperm`` on ``generator`` (or takes row e of
        ``perms`` (ppo_epoch, N)); minibatch i takes envs
        perm[i*mb:(i+1)*mb] that this rank holds. With an aux loss each
        step draws a time permutation (T,) after its env permutation (or
        takes ``time_perms[e, i]``). With the adaptive entropy, the loss
        uses exp(log_alpha) and ``log_alpha`` (0-d) is updated in place
        after each step. Returns the loss terms and the pre-clip gradient
        norm, averaged over all minibatch steps."""
        cfg = self.cfg
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones, last_value, cfg.gamma, cfg.tau)
        if cfg.use_normalized_advantage:
            advantages = self._normalize(advantages)
        data = {
            "actions": batch.actions, "log_probs": batch.log_probs, "values": batch.values,
            "prev_actions": batch.prev_actions, "masks": batch.masks,
            "advantages": advantages, "returns": returns,
        }
        T = batch.rewards.shape[0]
        mb_size = self.n_global // cfg.num_mini_batch
        params = self.trained_parameters()
        dev = generator.device
        steps = []
        for e in range(cfg.ppo_epoch):
            perm = perms[e] if perms is not None else torch.randperm(self.n_global, generator=generator, device=dev)
            for i in range(cfg.num_mini_batch):
                time_perm = None
                if self.aux_loss is not None:
                    time_perm = time_perms[e, i] if time_perms is not None else torch.randperm(
                        T, generator=generator, device=dev)
                idx = perm[i * mb_size:(i + 1) * mb_size].to(batch.rewards.device)
                if self.world.active:
                    # the members this rank holds, in minibatch order
                    idx = idx[(idx >= self.rows.start) & (idx < self.rows.stop)] - self.rows.start
                mb = {k: v.index_select(1, idx) for k, v in data.items()}
                mb["obs"] = {k: v.index_select(1, idx) for k, v in batch.obs.items()}
                kw = dict(count=T * mb_size)
                if self.adaptive_ent:
                    kw["ent_coef"] = torch.exp(log_alpha)
                if self.aux_loss is not None:
                    kw["time_perm"] = time_perm
                    if self.world.active:
                        c = self.aux_loss.count(mb["masks"]).reshape(1)
                        distributed.all_reduce_sum_([c])
                        kw["aux_count"] = c[0]
                self.optimizer.zero_grad(set_to_none=True)
                if len(idx):
                    loss, aux = self._loss_fn(mb, h0.index_select(0, idx), **kw)
                    loss.backward()
                else:
                    aux = {}  # a rank that holds no member of this minibatch
                if self.world.active:
                    for p in params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    names = self._metric_names()
                    vals = torch.stack([aux.get(k, torch.zeros((), device=dev)) for k in names])
                    distributed.all_reduce_sum_([p.grad for p in params] + [vals])
                    aux = dict(zip(names, vals))
                aux["grad_norm"] = clip_by_global_norm_([p.grad for p in params], cfg.max_grad_norm)
                if self.lr_decay_steps:
                    self._set_lr(params)
                self.optimizer.step()
                if self.adaptive_ent:
                    # dual ascent at the main lr, alpha clamped to [1e-4, 1]
                    aux["losses/entropy_coef"] = kw["ent_coef"]
                    log_alpha.copy_(self.ent_coef.ascend(log_alpha, aux["losses/entropy"], cfg.lr))
                steps.append(aux)
        return {k: torch.stack([s[k] for s in steps]).mean() for k in steps[0]}

    def _metric_names(self) -> List[str]:
        names = ["losses/learner_loss", "losses/action_loss", "losses/value_loss", "losses/entropy"]
        return names + (["losses/cpca"] if self.aux_loss is not None else [])

    def train_step(self, rs: RolloutState) -> Tuple[RolloutState, Dict[str, torch.Tensor]]:
        """One rollout and one update. Metrics: the update's loss terms and
        ``grad_norm``, the rollout's episode sums (``reward_sum``,
        ``len_sum``, ``done_count``, ``m_<measure>``) and
        ``reward_step_mean``, as 0-d tensors on the env's device, over all
        ranks."""
        rs, batch, last_value, h0, stats = self.collect_rollout(rs)
        metrics = self.update(rs.generator, batch, last_value, h0, rs.log_alpha)
        stats["reward_step_mean"] = batch.rewards.sum() / (batch.rewards.shape[0] * self.n_global)
        sums = torch.stack(list(stats.values()))
        distributed.all_reduce_sum_([sums])
        metrics.update(zip(stats, sums))
        return rs, metrics
