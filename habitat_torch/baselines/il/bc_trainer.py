"""Behavior cloning of the geodesic follower (port of
``habitat_tpu/baselines/il/bc_trainer.py``; reference il/ trainers).

The demonstrator runs on the device: the greedy geodesic follower over the
episode's distance field (``ops/navgrid.greedy_follower_step``) gives the
teacher action, the env steps with it, and the policy is trained by
cross-entropy to predict it (online DAgger-style cloning, no offline
dataset). Registered as trainer ``bc``.

The env steps with the teacher's actions, which do not depend on the
policy's weights, so ``train_step`` splits the JAX package's scan in two:

- the rollout: T env steps under ``torch.no_grad()``, keeping each step's
  observations, teacher action, previous action (the previous teacher, 0 at
  the start) and not-done mask (0 at the first step after ``init``, then
  1 - done);
- the update: one sequence-mode forward of the policy over (T, N) from the
  rollout's initial hidden state with those masks, the mean cross-entropy,
  one backward, clipping by global norm and Adam (eps 1e-8, optax's).

This is the loss and the gradient of JAX's ``value_and_grad`` through the
scan. The final hidden state of the sequence forward, detached, carries to
the next rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from habitat_torch.baselines.ppo import clip_by_global_norm_
from habitat_torch.core.registry import registry
from habitat_torch.models.policy import ActorCritic
from habitat_torch.ops.navgrid import greedy_follower_step

FOLLOWER_ACTIONS = ("stop", "move_forward", "turn_left", "turn_right")


@dataclasses.dataclass(frozen=True)
class BCConfig:
    lr: float = 1e-3
    num_steps: int = 32
    max_grad_norm: float = 1.0
    goal_radius: float = 0.2


@dataclasses.dataclass
class BCState:
    """What carries from one train step to the next (the weights live in the
    policy module, Adam's moments in the learner's optimizer)."""

    env_state: Any
    obs: Dict[str, torch.Tensor]
    hidden: torch.Tensor  # (N, L, S, H)
    prev_action: torch.Tensor  # (N,) the last teacher action
    not_done: torch.Tensor  # (N,) float


@registry.register_trainer(name="bc")
class BCLearner:
    """Online behavior cloning of the shortest-path follower. The env is a
    nav ``BatchedEnv`` whose first four actions are stop, move_forward,
    turn_left, turn_right: the follower's action indices."""

    def __init__(self, env, policy: ActorCritic, cfg: BCConfig = BCConfig()):
        if tuple(env.action_names[:4]) != FOLLOWER_ACTIONS:
            raise ValueError(f"the env's first actions are {env.action_names[:4]}, want {FOLLOWER_ACTIONS}")
        self.env = env
        self.policy = policy
        self.cfg = cfg
        self.params = [p for p in policy.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=cfg.lr, eps=1e-8)
        # the follower's step and turn, from the env's action tables
        self._fwd_step = float(env._move_amt[1])
        self._turn = float(env._turn_amt[2])

    def teacher(self, env_state) -> torch.Tensor:
        """(N,) the follower's action for every env, each on its episode's
        field."""
        env = self.env
        ep = env_state.ep_idx
        return greedy_follower_step(
            env.pack, env.table.scene_idx[ep].long(), env.table.dist_field, ep, env_state.pos, env_state.yaw,
            goal_radius=self.cfg.goal_radius, forward_step=self._fwd_step, turn_angle=self._turn,
        )

    def init(self) -> BCState:
        """Reset the envs; zero hidden state, previous action and not-done."""
        env_state, obs = self.env.reset_fn()
        n, dev = self.env.num_envs, self.env.device
        return BCState(env_state, obs, self.policy.initial_hidden(n), torch.zeros(n, dtype=torch.int64, device=dev),
                       torch.zeros(n, device=dev))

    @torch.no_grad()
    def collect_rollout(self, st: BCState) -> Tuple[BCState, Dict[str, Any]]:
        """T env steps driven by the teacher. Returns the new state and the
        batch: ``obs`` leaves (T, N, ...), ``teacher``, ``prev_actions``,
        ``masks`` and ``success`` (T, N), and ``h0`` (the hidden state the
        sequence starts from)."""
        env_state, obs, prev, not_done = st.env_state, st.obs, st.prev_action, st.not_done
        steps = []
        for _ in range(self.cfg.num_steps):
            teacher = self.teacher(env_state)
            env_state, new_obs, _, done, info = self.env.step_fn(env_state, teacher)
            success = info.get("success", torch.zeros_like(not_done))
            steps.append((obs, teacher, prev, not_done, success))
            obs, prev, not_done = new_obs, teacher, 1.0 - done.float()
        cols = list(zip(*steps))
        batch = dict(
            obs={k: torch.stack([o[k] for o in cols[0]]) for k in cols[0][0]},
            teacher=torch.stack(cols[1]), prev_actions=torch.stack(cols[2]), masks=torch.stack(cols[3]),
            success=torch.stack(cols[4]).float(), h0=st.hidden,
        )
        return dataclasses.replace(st, env_state=env_state, obs=obs, prev_action=prev, not_done=not_done), batch

    def update(self, batch: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One Adam step on the mean cross-entropy of the sequence. Returns
        (loss and teacher match, the final hidden state, detached)."""
        logits, _, hidden = self.policy(batch["obs"], batch["h0"], batch["prev_actions"], batch["masks"])
        logp = F.log_softmax(logits.float(), dim=-1)
        teacher = batch["teacher"]
        loss = -logp.gather(-1, teacher[..., None])[..., 0].mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # the critic gets no gradient: Adam leaves it, as optax does with its zeros
        clip_by_global_norm_([p.grad for p in self.params if p.grad is not None], self.cfg.max_grad_norm)
        self.optimizer.step()
        match = (logits.argmax(-1) == teacher).float().mean()
        return {"losses/bc_loss": loss.detach(), "teacher_match": match}, hidden.detach()

    def train_step(self, st: BCState) -> Tuple[BCState, Dict[str, torch.Tensor]]:
        """One rollout and one update. Metrics (0-d tensors): ``losses/bc_loss``,
        ``teacher_match`` (the share of (step, env) whose argmax is the
        teacher's action) and ``teacher_success_rate`` (the mean of the
        ``success`` measure over the rollout's steps and envs)."""
        st, batch = self.collect_rollout(st)
        metrics, hidden = self.update(batch)
        metrics["teacher_success_rate"] = batch["success"].mean()
        return dataclasses.replace(st, hidden=hidden), metrics
