"""Hierarchical policy: a high-level policy picks a skill per env, the skills
act (port of ``habitat_tpu/baselines/hrl/hierarchical.py``; reference
rl/hrl/: hierarchical_policy.py:31, hl/fixed_policy.py, skills/).

Every skill is a batched function of the rearrangement env's state: each
env carries a skill index, every skill computes its action for all N envs,
and a gather picks each env's. The skills here are the oracle variants
(reference skills/oracle_nav.py and the others); a trained policy plugs in
as ``NnSkill`` through the same (act, is_done) protocol.

The skills read these attributes of the env (``RearrangeBatchedEnv``):
``table`` (``nav.scene_idx``, ``nav.dist_field``, ``pick_target``,
``target_pos``, ``art_target``, ``art_goal_q``), ``pack``, ``num_envs``,
``device``, ``_env_ids``, ``_obj_world``, ``_ee_pos``, ``_handle_pos``,
``fwd``, ``turn``, ``grasp_distance`` and ``at_goal_thresh``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.ops.navgrid import greedy_follower_step
from habitat_torch.tasks.rearrange.multi_task.pddl import _target, _target_goal, _target_obj
from habitat_torch.tasks.rearrange.rearrange_env import A_FWD, A_GRAB, A_LEFT, A_RIGHT, A_STOP, _xz_norm
from habitat_torch.tasks.rearrange.rigid_body import norm
from habitat_torch.utils import threefry
from habitat_torch.utils.geometry import rotate_world_to_agent

# the steering cone, float32 as jnp.deg2rad(12.0) computes it
STEER_CONE = float(np.float32(12.0) * np.float32(np.pi / 180))


class Skill:
    """The low-level skill protocol (reference skills/skill.py:334)."""

    name: str = "skill"

    def act(self, env, state) -> torch.Tensor:
        """(N,) actions."""
        raise NotImplementedError

    def is_done(self, env, state) -> torch.Tensor:
        """(N,) bool: the skill has finished."""
        raise NotImplementedError


def _rel_to(state, world_pos: torch.Tensor) -> torch.Tensor:
    return rotate_world_to_agent(world_pos - state.pos, state.yaw)


def _steer(rel: torch.Tensor, near_thresh: float, near_action: int) -> torch.Tensor:
    """Greedy euclidean steering toward an agent-frame position:
    ``near_action`` within ``near_thresh``, else forward inside the cone,
    else turn toward it."""
    ang = torch.atan2(-rel[:, 0], -rel[:, 2])
    turn = torch.where(ang > 0, A_LEFT, A_RIGHT)
    return torch.where(_xz_norm(rel) < near_thresh, near_action,
                       torch.where(ang.abs() < STEER_CONE, A_FWD, turn))


class OracleNavSkill(Skill):
    """To the pick target on the episode's geodesic field (reference
    skills/oracle_nav.py, a navmesh path follower); never stops by itself,
    the high-level policy decides when it ends."""

    name = "nav_to_obj"

    def __init__(self, stop_dist: float = 0.8):
        self.stop_dist = stop_dist

    def act(self, env, state):
        nav = env.table.nav
        act = greedy_follower_step(
            env.pack, nav.scene_idx[state.ep_idx].long(), nav.dist_field, state.ep_idx, state.pos, state.yaw,
            goal_radius=self.stop_dist, forward_step=env.fwd, turn_angle=env.turn,
        )
        return torch.where(act == A_STOP, A_FWD, act)

    def is_done(self, env, state):
        return _xz_norm(_target_obj(env, state) - state.pos) <= self.stop_dist


class PickSkill(Skill):
    """Approach and grasp (reference skills/pick.py with the oracle grasp)."""

    name = "pick"

    def __init__(self, grab_dist: float = 0.7):
        self.grab_dist = grab_dist

    def act(self, env, state):
        return _steer(_rel_to(state, _target_obj(env, state)), self.grab_dist, A_GRAB)

    def is_done(self, env, state):
        return state.held == _target(env, state)


class NavToGoalSkill(Skill):
    """Carry the target toward its goal; placing is ``PlaceSkill``'s."""

    name = "nav_to_goal"

    def __init__(self, stop_dist: float = 0.5):
        self.stop_dist = stop_dist

    def act(self, env, state):
        return _steer(_rel_to(state, _target_goal(env, state)), self.stop_dist, A_FWD)

    def is_done(self, env, state):
        return _xz_norm(_target_goal(env, state) - state.pos) <= self.stop_dist + 0.2


class PlaceSkill(Skill):
    """Release at the goal (reference skills/place.py): steer while holding
    until the end-effector is over the goal, then release; an object dropped
    early is picked again."""

    name = "place"

    def __init__(self, ee_release_dist: float = 0.1):
        self.ee_release_dist = ee_release_dist

    def act(self, env, state):
        goal, obj = _target_goal(env, state), _target_obj(env, state)
        holding = state.held == _target(env, state)
        ee_goal = _xz_norm(env._ee_pos(state) - goal)
        act_hold = torch.where(ee_goal < self.ee_release_dist, A_GRAB, _steer(_rel_to(state, goal), 0.0, A_FWD))
        act_recover = _steer(_rel_to(state, obj), 0.7, A_GRAB)
        act = torch.where(holding, act_hold, act_recover)
        return torch.where(self.is_done(env, state), A_LEFT, act)

    def is_done(self, env, state):
        placed = norm(_target_obj(env, state) - _target_goal(env, state)) < env.at_goal_thresh
        return placed & (state.held < 0)


class ArtObjSkill(Skill):
    """Open or close the articulated target (reference skills/art_obj.py):
    steer to the handle, then GRAB moves the joint toward its goal state;
    done within 0.05 of the episode's ``art_goal_q``. For task "open" or
    "close" envs, where GRAB acts on the joint."""

    name = "art_obj"

    def act(self, env, state):
        return _steer(_rel_to(state, env._handle_pos(state)), env.grasp_distance * 0.9, A_GRAB)

    def is_done(self, env, state):
        ep = state.ep_idx
        q = state.art_q[env._env_ids, env.table.art_target[ep]]
        return (q - env.table.art_goal_q[ep]).abs() < 0.05


class WaitSkill(Skill):
    """reference skills/wait.py."""

    name = "wait"

    def act(self, env, state):
        return torch.full((env.num_envs,), A_LEFT, dtype=torch.int64, device=env.device)

    def is_done(self, env, state):
        return torch.ones(env.num_envs, dtype=torch.bool, device=env.device)


@dataclasses.dataclass
class HLState:
    skill_idx: torch.Tensor  # (N,) i64 the current position in the plan


def _select(values: List[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """Each env's entry of (K,) per-skill (N,) tensors at its skill index."""
    return torch.stack(values).gather(0, idx[None])[0]


def skill_actions(env, skills: Sequence[Skill], state, idx: torch.Tensor) -> torch.Tensor:
    """(N,) actions: every skill acts, each env takes its skill's action."""
    return _select([s.act(env, state) for s in skills], idx)


def skill_dones(env, skills: Sequence[Skill], state) -> List[torch.Tensor]:
    return [s.is_done(env, state) for s in skills]


class FixedHighLevelPolicy:
    """A fixed skill sequence (reference hl/fixed_policy.py:158, the PDDL
    plan's skill list)."""

    def __init__(self, env, plan: Sequence[Skill]):
        self.env = env
        self.plan = list(plan)

    def init_state(self) -> HLState:
        return HLState(torch.zeros(self.env.num_envs, dtype=torch.int64, device=self.env.device))

    def act(self, hl: HLState, env_state) -> Tuple[torch.Tensor, HLState]:
        """Advance each env's pointer past the skills that report done (K
        passes: the fixed point), then act."""
        k = len(self.plan)
        dones = skill_dones(self.env, self.plan, env_state)
        idx = hl.skill_idx
        for _ in range(k):
            idx = torch.where(_select(dones, idx) & (idx < k - 1), idx + 1, idx)
        return skill_actions(self.env, self.plan, env_state, idx), HLState(idx)


class HierarchicalPolicy:
    """A high-level policy and its skills as one batched controller
    (reference hierarchical_policy.py:31)."""

    def __init__(self, env, hl_policy):
        self.env = env
        self.hl = hl_policy

    def init_state(self) -> HLState:
        return self.hl.init_state()

    def act(self, hl_state, env_state):
        return self.hl.act(hl_state, env_state)

    @torch.no_grad()
    def rollout(self, env_state, hl_state: HLState, num_steps: int):
        """``num_steps`` env steps; an env whose episode ends restarts its
        plan. Returns (env state, HL state, rewards, dones, success), the
        last three (T, N)."""
        rs, dones, succ = [], [], []
        for _ in range(num_steps):
            act, hl_state = self.act(hl_state, env_state)
            env_state, _, r, done, info = self.env.step_fn(env_state, act)
            hl_state = HLState(torch.where(done, 0, hl_state.skill_idx))
            rs.append(r)
            dones.append(done)
            succ.append(info["success"])
        return env_state, hl_state, torch.stack(rs), torch.stack(dones), torch.stack(succ)


def default_rearrange_plan() -> List[Skill]:
    """nav -> pick -> nav -> place (the reference's canonical PDDL plan)."""
    return [OracleNavSkill(), PickSkill(), NavToGoalSkill(), PlaceSkill()]


class NnSkill(Skill):
    """A trained policy behind the skill protocol (reference
    skills/nn_skill.py), stateless: its hidden state is zeroed at every
    step, so it suits feed-forward or memoryless policies. ``obs_fn(env,
    state)`` gives its observations (the env's own by default).

    Deterministic acts by argmax. Otherwise it samples as the JAX skill
    does, ``categorical(PRNGKey(0), logits)`` at every call: the key never
    changes, so the Gumbel noise is one (N, A) table, drawn once per batch
    size on the host and kept on the env's device."""

    name = "nn_skill"

    def __init__(self, policy, done_fn, obs_fn=None, deterministic: bool = True, name: str = "nn_skill"):
        self.policy = policy
        self._done_fn = done_fn
        self._obs_fn = obs_fn
        self.deterministic = deterministic
        self.name = name
        self._noise = {}

    def _gumbel(self, n: int, a: int, dev) -> torch.Tensor:
        key = (n, a, str(dev))
        if key not in self._noise:
            self._noise[key] = torch.as_tensor(threefry.gumbel(threefry.prng_key(0), (n, a)), device=dev)
        return self._noise[key]

    @torch.no_grad()
    def act(self, env, state):
        obs = self._obs_fn(env, state) if self._obs_fn else env._observations(state)
        n, dev = env.num_envs, env.device
        logits, _, _ = self.policy(obs, self.policy.initial_hidden(n), torch.zeros(n, dtype=torch.int64, device=dev),
                                   torch.ones(n, device=dev))
        logits = logits.float()
        if not self.deterministic:
            logits = logits + self._gumbel(n, logits.shape[-1], dev)
        return logits.argmax(-1)

    def is_done(self, env, state):
        return self._done_fn(env, state)
