"""PlannerHighLevelPolicy: PDDL forward search as a precomputed plan table
(port of ``habitat_tpu/baselines/hrl/planner.py``; reference
hl/planner_policy.py:33, which searches the predicate space on the host
each time an env needs a plan, ``_get_solution_nodes`` :118-207).

The symbolic search depends only on which predicates hold. With P domain
predicates there are 2^P symbolic states, so ``build_plan_table``
enumerates them once (a numpy BFS) into a (2^P,) next-skill table, and at
run time the planner is

    key   = sum_i 2^i * predicate_i(env_state)   (batched, on the device)
    skill = table[key]                           (one gather)

which replans every step (reference ``is_reactive``, planner_policy.py
:103-108) with no host round trip and no per-env plan to reset.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.baselines.hrl.hierarchical import HLState, Skill, WaitSkill, _select, skill_actions, skill_dones
from habitat_torch.tasks.rearrange.multi_task.pddl import LogicalExpr, PddlAction, PddlDomain

# predicates that cannot hold together (the reference handles the
# holding/not_holding pair in its search, planner_policy.py:172-191, and
# strips robot_at on nav actions, :162-168)
DEFAULT_MUTEX_GROUPS: Tuple[Tuple[str, ...], ...] = (
    ("holding", "not_holding"),
    ("robot_at_obj", "robot_at_goal"),
)


def _expr_names(expr: Optional[LogicalExpr]) -> List[str]:
    """The predicate names of an AND expression tree."""
    if expr is None:
        return []
    names: List[str] = []
    for sub in expr.sub_exprs:
        names.extend(_expr_names(sub) if isinstance(sub, LogicalExpr) else [sub.name])
    return names


def build_plan_table(
    domain: PddlDomain,
    goal: Sequence[str] = ("at",),
    mutex_groups: Sequence[Sequence[str]] = DEFAULT_MUTEX_GROUPS,
    max_depth: int = 16,
) -> Tuple[np.ndarray, List[str], List[PddlAction]]:
    """Shortest plans from every symbolic state to ``goal``: (the (2^P,)
    int32 table of the first action of a shortest plan, -1 where the goal
    holds already or cannot be reached; the predicate order of the bits;
    the action list the table indexes)."""
    pred_names = list(domain.predicates.keys())
    bit = {n: 1 << i for i, n in enumerate(pred_names)}
    actions = domain.get_ordered_actions()
    goal_mask = 0
    for g in goal:
        goal_mask |= bit[g]

    def apply(state: int, action: PddlAction) -> Optional[int]:
        pre = 0
        for n in _expr_names(action.precond):
            pre |= bit[n]
        if (state & pre) != pre:
            return None
        nxt = state
        for n in _expr_names(action.postcond):
            for grp in mutex_groups:
                if n in grp:
                    for other in grp:
                        if other != n:
                            nxt &= ~bit[other]
            nxt |= bit[n]
        return nxt

    table = np.full((1 << len(pred_names),), -1, np.int32)
    for start in range(len(table)):
        if (start & goal_mask) == goal_mask:
            continue
        # BFS over symbolic states, remembering the first action taken
        seen = {start}
        q = deque([(start, -1, 0)])  # (state, first action, depth)
        while q:
            st, first, depth = q.popleft()
            if depth >= max_depth:
                continue
            for ai, a in enumerate(actions):
                nxt = apply(st, a)
                if nxt is None or nxt in seen:
                    continue
                f = ai if first < 0 else first
                if (nxt & goal_mask) == goal_mask:
                    table[start] = f
                    q.clear()
                    break
                seen.add(nxt)
                q.append((nxt, f, depth + 1))
            else:
                continue
            break
    return table, pred_names, actions


class PlannerHighLevelPolicy:
    """A drop-in for ``FixedHighLevelPolicy`` that picks the next skill by
    the plan table from the predicates' current values: every step
    (``reactive``) or when the running skill reports done. Where no action
    is needed (the goal holds) or none reaches the goal, the env waits."""

    def __init__(self, env, domain: Optional[PddlDomain] = None, goal: Sequence[str] = ("at",),
                 reactive: bool = True, max_search_depth: int = 16):
        self.env = env
        self.domain = domain or PddlDomain()
        self.reactive = reactive
        table, pred_names, actions = build_plan_table(self.domain, goal=goal, max_depth=max_search_depth)
        self._table = torch.as_tensor(table, dtype=torch.int64, device=env.device)
        self._pred_names = pred_names
        self._actions = actions
        skills = self.domain.compile_plan_to_skills(actions)
        self.plan: List[Skill] = skills + [WaitSkill()]  # -1 -> wait
        self._wait_idx = len(skills)

    def init_state(self) -> HLState:
        return HLState(torch.zeros(self.env.num_envs, dtype=torch.int64, device=self.env.device))

    def _plan_step(self, env_state) -> torch.Tensor:
        """(N,) the skill each env's predicate values select."""
        key = torch.zeros(self.env.num_envs, dtype=torch.int64, device=self.env.device)
        for i, name in enumerate(self._pred_names):
            key = key | (self.domain.predicates[name].is_true(self.env, env_state).long() << i)
        nxt = self._table[key]
        return torch.where(nxt < 0, self._wait_idx, nxt)

    def act(self, hl: HLState, env_state) -> Tuple[torch.Tensor, HLState]:
        idx = self._plan_step(env_state)
        if not self.reactive:
            idx = torch.where(_select(skill_dones(self.env, self.plan, env_state), hl.skill_idx), idx, hl.skill_idx)
        return skill_actions(self.env, self.plan, env_state, idx), HLState(idx)
