"""PDDL-style task logic grounded in the batched rearrangement state (port
of ``habitat_tpu/tasks/rearrange/multi_task/pddl.py``; reference
multi_task/pddl_domain.py:48, pddl_logical_expr.py,
pddl_defined_predicates.py).

Predicates evaluate on the ``RearrangeState`` of all N envs at once, (N,)
bool; logical expressions combine them; an action schema pairs a
precondition and a postcondition with the HRL skill that achieves it, and a
plan compiles to the skills of ``baselines/hrl/hierarchical.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from habitat_torch.tasks.rearrange.rearrange_env import _xz_norm
from habitat_torch.tasks.rearrange.rigid_body import norm


class LogicalExprType:
    AND = "and"
    OR = "or"
    NAND = "nand"
    NOR = "nor"


@dataclasses.dataclass
class Predicate:
    """A named predicate with a truth function (env, state) -> (N,) bool
    (reference pddl_predicate.py)."""

    name: str
    fn: Callable

    def is_true(self, env, state) -> torch.Tensor:
        return self.fn(env, state)

    def __repr__(self):
        return f"Predicate({self.name})"


@dataclasses.dataclass
class LogicalExpr:
    expr_type: str
    sub_exprs: List

    def is_true(self, env, state) -> torch.Tensor:
        stacked = torch.stack([e.is_true(env, state) for e in self.sub_exprs])
        if self.expr_type == LogicalExprType.AND:
            return stacked.all(dim=0)
        if self.expr_type == LogicalExprType.OR:
            return stacked.any(dim=0)
        if self.expr_type == LogicalExprType.NAND:
            return ~stacked.all(dim=0)
        if self.expr_type == LogicalExprType.NOR:
            return ~stacked.any(dim=0)
        raise ValueError(self.expr_type)


@dataclasses.dataclass
class PddlAction:
    """An action schema: precondition, postcondition and the HRL skill that
    executes it (reference pddl_action.py; the skill's ``is_done`` asserts
    the postcondition)."""

    name: str
    precond: Optional[LogicalExpr]
    postcond: Optional[LogicalExpr]
    skill_name: str

    def is_applicable(self, env, state) -> torch.Tensor:
        if self.precond is None:
            return torch.ones(env.num_envs, dtype=torch.bool, device=env.device)
        return self.precond.is_true(env, state)

    def is_satisfied(self, env, state) -> torch.Tensor:
        if self.postcond is None:
            return torch.ones(env.num_envs, dtype=torch.bool, device=env.device)
        return self.postcond.is_true(env, state)


# -- grounded predicates (reference pddl_defined_predicates.py) ---------------


def _target(env, state) -> torch.Tensor:
    return env.table.pick_target[state.ep_idx]


def _target_obj(env, state) -> torch.Tensor:
    """(N, 3) the pick target's world position (at the EE when held)."""
    return env._obj_world(state)[env._env_ids, _target(env, state)]


def _target_goal(env, state) -> torch.Tensor:
    return env.table.target_pos[state.ep_idx, _target(env, state)]


def p_holding(env, state):
    """holding(target_obj)."""
    return state.held == _target(env, state)


def p_not_holding(env, state):
    return state.held < 0


def p_obj_at_goal(env, state, thresh: float = 0.3):
    return norm(_target_obj(env, state) - _target_goal(env, state)) < thresh


def p_robot_at_obj(env, state, dist: float = 1.0):
    return _xz_norm(_target_obj(env, state) - state.pos) < dist


def p_robot_at_goal(env, state, dist: float = 1.0):
    return _xz_norm(_target_goal(env, state) - state.pos) < dist


DEFAULT_PREDICATES: Dict[str, Predicate] = {
    "holding": Predicate("holding", p_holding),
    "not_holding": Predicate("not_holding", p_not_holding),
    "at": Predicate("at", p_obj_at_goal),
    "robot_at_obj": Predicate("robot_at_obj", p_robot_at_obj),
    "robot_at_goal": Predicate("robot_at_goal", p_robot_at_goal),
}


class PddlDomain:
    """Predicates + action schemas (reference pddl_domain.py:48, which
    loads them from YAML; built in code here)."""

    def __init__(self, predicates: Optional[Dict[str, Predicate]] = None,
                 actions: Optional[Dict[str, PddlAction]] = None):
        self.predicates = dict(predicates or DEFAULT_PREDICATES)
        self.actions = dict(actions or {})
        if not self.actions:
            self._default_actions()

    def _default_actions(self):
        P = self.predicates

        def AND(*names):
            return LogicalExpr(LogicalExprType.AND, [P[n] for n in names])

        self.actions = {
            "nav_to_obj": PddlAction("nav_to_obj", AND("not_holding"), AND("robot_at_obj"), "nav_to_obj"),
            "pick": PddlAction("pick", AND("robot_at_obj", "not_holding"), AND("holding"), "pick"),
            "nav_to_goal": PddlAction("nav_to_goal", AND("holding"), AND("robot_at_goal"), "nav_to_goal"),
            # placing needs the robot at the goal, as the reference domain's
            # place does; without it a symbolic planner would place from
            # anywhere in one step
            "place": PddlAction("place", AND("holding", "robot_at_goal"), AND("at", "not_holding"), "place"),
        }

    def parse_predicate(self, name: str) -> Predicate:
        return self.predicates[name]

    def get_ordered_actions(self) -> List[PddlAction]:
        return list(self.actions.values())

    def plan_for_goal(self, goal: str = "at") -> List[PddlAction]:
        """The single-object domain's fixed plan: nav -> pick -> nav -> place."""
        return [self.actions[n] for n in ("nav_to_obj", "pick", "nav_to_goal", "place")]

    def compile_plan_to_skills(self, plan: Sequence[PddlAction]):
        """PddlAction list -> HRL skill instances (reference hl/fixed_policy
        consumes the solution's skill list the same way)."""
        from habitat_torch.baselines.hrl.hierarchical import (
            NavToGoalSkill,
            OracleNavSkill,
            PickSkill,
            PlaceSkill,
            WaitSkill,
        )

        mapping = {"nav_to_obj": OracleNavSkill, "pick": PickSkill, "nav_to_goal": NavToGoalSkill,
                   "place": PlaceSkill, "wait": WaitSkill}
        return [mapping[a.skill_name]() for a in plan]
