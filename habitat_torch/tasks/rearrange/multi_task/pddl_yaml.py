"""YAML PDDL domains and problems grounded on the batched rearrangement env
(port of ``habitat_tpu/tasks/rearrange/multi_task/pddl_yaml.py``; reference
multi_task/pddl_domain.py:48 PddlDomain, :558 PddlProblem,
rearrange_pddl.py's entities, pddl_defined_predicates.py).

A domain file has the reference's sections (types, constants, predicates,
actions) and a problem file its own (objects, init, goal, stage_goals,
solution). A predicate's ``_target_`` resolves by its last path component
into ``PREDICATE_FACTORIES``; the grounded predicate's truth is a function
(env, state) -> (N,) bool over all envs at once, tensor work on the state's
device with no host sync, and its ``set_state`` returns a new state.

Entities bind to the env's tensors by name:
- ``<x>|k`` (a movable entity) is the k-th target object of each episode,
  targets first in stable order of ``target_mask``;
- a goal entity ``TARGET_<x>|k`` is that object's goal position;
- a constant of an articulated type is an articulated slot, in declaration
  order (``art_slots``);
- a robot entity whose name ends in ``_1`` (``robot_1``) is the humanoid
  lane of the two-agent env (``human_pos``, ``human_held``), any other the
  robot.

As in the JAX package, ``robot_at`` reads the robot's base whichever robot
entity it is given.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import yaml

from habitat_torch.tasks.rearrange.multi_task.pddl import LogicalExpr, LogicalExprType, PddlAction

ROBOT_TYPE = "robot_entity_type"
GOAL_TYPE = "goal_entity_type"
MOVABLE_TYPE = "movable_entity_type"
DOMAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "domain_configs")


def domain_path(name: str) -> str:
    """A domain by name: ``<name>.yaml`` under ``domain_configs``, falling
    back to ``fp.yaml``; a name ending in ``.yaml`` is a path."""
    name = str(name or "fp")
    if name.endswith(".yaml"):
        return name
    path = os.path.join(DOMAIN_DIR, f"{name}.yaml")
    return path if os.path.exists(path) else os.path.join(DOMAIN_DIR, "fp.yaml")


@dataclasses.dataclass(frozen=True)
class PddlEntity:
    """A named, typed entity (reference rearrange_pddl.py::PddlEntity)."""

    name: str
    expr_type: str


class ExprTypes:
    """The domain's type hierarchy, child -> parent."""

    def __init__(self, parents: Dict[str, str]):
        self.parents = dict(parents)

    def is_subtype(self, t: Optional[str], of: str) -> bool:
        while t is not None:
            if t == of:
                return True
            t = self.parents.get(t)
        return False

    @classmethod
    def from_yaml(cls, types_node: Optional[dict]) -> "ExprTypes":
        return cls({c: parent for parent, children in (types_node or {}).items() for c in children or ()})


# -- entities on the batched state ---------------------------------------------


def _entity_index(name: str) -> int:
    """``any_targets|3`` -> 3; an unnumbered entity -> 0."""
    return int(name.rsplit("|", 1)[1]) if "|" in name else 0


def target_order(target_mask: torch.Tensor) -> torch.Tensor:
    """(E, O) each episode's objects, its targets first, in stable order:
    column k is the object the movable entity ``<x>|k`` names."""
    return torch.argsort((~target_mask).to(torch.int32), dim=1, stable=True)


def _kth_target_obj(env, state, k: int) -> torch.Tensor:
    """(N,) the object index of each episode's k-th target (from the env's
    ``target_order`` when it keeps one)."""
    order = getattr(env, "target_order", None)
    if order is None:
        order = target_order(env.table.target_mask)
    return order[state.ep_idx, min(k, order.shape[1] - 1)]


def entity_object_index(env, state, ent: PddlEntity) -> torch.Tensor:
    return _kth_target_obj(env, state, _entity_index(ent.name))


def _is_second_agent(ent: PddlEntity) -> bool:
    return ent.name.rsplit("_", 1)[-1] == "1"


def _held_field(ent: PddlEntity) -> str:
    return "human_held" if _is_second_agent(ent) else "held"


def entity_position(env, state, ent: PddlEntity, art_slots: Dict[str, int]) -> torch.Tensor:
    """(N, 3) world position of an entity in each env."""
    if ent.expr_type == ROBOT_TYPE:
        return state.human_pos if _is_second_agent(ent) else state.pos
    if ent.expr_type == GOAL_TYPE:
        k = _kth_target_obj(env, state, _entity_index(ent.name))
        return env.table.target_pos[state.ep_idx, k]
    if ent.name in art_slots:
        return env.table.art_pos[state.ep_idx, _art_slot(env, ent, art_slots)]
    return env._obj_world(state)[env._env_ids, entity_object_index(env, state, ent)]


def _art_slot(env, ent: PddlEntity, art_slots: Dict[str, int]) -> int:
    return art_slots.get(ent.name, 0) % max(1, env.table.art_pos.shape[1])


def _horiz_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2)


def _obj_pos(env, state, obj: PddlEntity) -> torch.Tensor:
    return env._obj_world(state)[env._env_ids, entity_object_index(env, state, obj)]


# -- predicate factories (reference pddl_defined_predicates.py) ----------------
# Each returns (is_valid, set_state or None) closed over the bound entities:
# is_valid(env, state) -> (N,) bool; set_state(env, state) -> a new state
# (how an ``init:`` predicate is applied).


def _fac_is_robot_hold_match(args, art_slots, hold_state=True, **_):
    objs = [a for a in args if a.expr_type != ROBOT_TYPE]
    robots = [a for a in args if a.expr_type == ROBOT_TYPE]
    robot = robots[0] if robots else PddlEntity("robot_0", ROBOT_TYPE)
    field = _held_field(robot)

    def valid(env, state):
        held = getattr(state, field)
        if hold_state and objs:
            return held == entity_object_index(env, state, objs[0])
        return held >= 0 if hold_state else held < 0

    def set_state(env, state):
        held = getattr(state, field)
        if hold_state and objs:
            return dataclasses.replace(state, **{field: entity_object_index(env, state, objs[0]).to(held.dtype)})
        return dataclasses.replace(state, **{field: torch.full_like(held, -1)})

    return valid, set_state


def _fac_is_object_at(args, art_slots, dist_thresh=0.3, **_):
    obj, at = args[0], args[1]

    def valid(env, state):
        return torch.linalg.vector_norm(_obj_pos(env, state, obj) - entity_position(env, state, at, art_slots),
                                        dim=-1) < dist_thresh

    def set_state(env, state):
        obj_pos = state.obj_pos.clone()
        obj_pos[env._env_ids, entity_object_index(env, state, obj)] = entity_position(env, state, at, art_slots)
        return dataclasses.replace(state, obj_pos=obj_pos)

    return valid, set_state


def _fac_is_robot_at_position(args, art_slots, dist_thresh=2.0, **_):
    at = args[0]

    def valid(env, state):
        return _horiz_dist(state.pos, entity_position(env, state, at, art_slots)) < dist_thresh

    def set_state(env, state):
        tgt = entity_position(env, state, at, art_slots)
        return dataclasses.replace(state, pos=torch.stack([tgt[:, 0], state.pos[:, 1], tgt[:, 2]], dim=-1))

    return valid, set_state


def _fac_is_articulated_object_at_state(args, art_slots, target_val=0.0, cmp="close", joint_dist_thresh=0.15, **_):
    ent = args[0]

    def valid(env, state):
        q = state.art_q[:, _art_slot(env, ent, art_slots)]
        if cmp == "greater":
            return q > target_val - joint_dist_thresh
        if cmp == "less":
            return q < target_val + joint_dist_thresh
        return (q - target_val).abs() < joint_dist_thresh

    def set_state(env, state):
        art_q = state.art_q.clone()
        art_q[:, _art_slot(env, ent, art_slots)] = target_val
        return dataclasses.replace(state, art_q=art_q)

    return valid, set_state


def _fac_is_inside(args, art_slots, dist_thresh=0.8, **_):
    obj, recep = args[0], args[1]

    def valid(env, state):
        return _horiz_dist(_obj_pos(env, state, obj), entity_position(env, state, recep, art_slots)) < dist_thresh

    return valid, None


PREDICATE_FACTORIES: Dict[str, Callable] = {
    "is_robot_hold_match": _fac_is_robot_hold_match,
    "set_robot_holding": _fac_is_robot_hold_match,
    "is_object_at": _fac_is_object_at,
    "set_object_at": _fac_is_object_at,
    "is_robot_at_position": _fac_is_robot_at_position,
    "set_robot_position": _fac_is_robot_at_position,
    "is_articulated_object_at_state": _fac_is_articulated_object_at_state,
    "set_articulated_object_at_state": _fac_is_articulated_object_at_state,
    "is_inside": _fac_is_inside,
}


@dataclasses.dataclass
class GroundedPredicate:
    """A predicate bound to entities; it stands in a ``LogicalExpr`` as
    ``pddl.Predicate`` does (the same ``is_true``)."""

    name: str
    args: List[PddlEntity]
    valid_fn: Callable
    set_state_fn: Optional[Callable] = None

    def is_true(self, env, state) -> torch.Tensor:
        return self.valid_fn(env, state)

    def set_state(self, env, state):
        if self.set_state_fn is None:
            raise ValueError(f"{self.name} has no set_state")
        return self.set_state_fn(env, state)

    def __repr__(self):
        return f"{self.name}({', '.join(a.name for a in self.args)})"

    @property
    def compact_str(self) -> str:
        """The reference's Predicate.compact_str (pddl_predicate.py:145-147):
        the order of the GlobalPredicatesSensor's lanes."""
        return f"{self.name}({','.join(a.name for a in self.args)})"


@dataclasses.dataclass
class PredicateSchema:
    name: str
    param_types: List[str]
    factory: Callable
    kwargs: Dict[str, Any]
    set_kwargs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ActionSchema:
    name: str
    params: List[PddlEntity]
    precondition: Any  # the YAML node, grounded when the action is bound
    postcondition: List[str]  # predicate calls


_CALL_RE = re.compile(r"^\s*([A-Za-z_][\w]*)\s*\((.*)\)\s*$")


def parse_predicate_call(s: str):
    """``"holding(obj, robot)"`` -> ("holding", ["obj", "robot"])."""
    m = _CALL_RE.match(s)
    if not m:
        raise ValueError(f"bad predicate call: {s!r}")
    return m.group(1), [a.strip() for a in m.group(2).split(",") if a.strip()]


def _without_target(node: dict) -> Dict[str, Any]:
    return {k: v for k, v in node.items() if k != "_target_"}


_EXPR_TYPES = {"AND": LogicalExprType.AND, "OR": LogicalExprType.OR, "NAND": LogicalExprType.NAND,
               "NOR": LogicalExprType.NOR}


class YamlPddlDomain:
    """A domain from the reference's domain-config schema."""

    def __init__(self, node: dict):
        self.types = ExprTypes.from_yaml(node.get("types"))
        self.constants: Dict[str, PddlEntity] = {}
        self.art_slots: Dict[str, int] = {}
        for i, c in enumerate(node.get("constants") or ()):
            ent = PddlEntity(c["name"], c["expr_type"])
            self.constants[ent.name] = ent
            self.art_slots[ent.name] = i
        self.predicates: Dict[str, PredicateSchema] = {}
        for p in node.get("predicates") or ():
            fn_node = p.get("is_valid_fn") or {}
            fac_name = str(fn_node.get("_target_", "")).rsplit(".", 1)[-1]
            if fac_name not in PREDICATE_FACTORIES:
                raise KeyError(f"unknown predicate fn {fac_name!r}; have {sorted(PREDICATE_FACTORIES)}")
            set_node = p.get("set_state_fn") or None
            self.predicates[p["name"]] = PredicateSchema(
                p["name"], [a["expr_type"] for a in p.get("args") or ()], PREDICATE_FACTORIES[fac_name],
                _without_target(fn_node), _without_target(set_node) if set_node else None)
        self.actions: Dict[str, ActionSchema] = {
            a["name"]: ActionSchema(a["name"], [PddlEntity(x["name"], x["expr_type"]) for x in a.get("parameters") or ()],
                                    a.get("precondition"), list(a.get("postcondition") or ()))
            for a in node.get("actions") or ()
        }

    @classmethod
    def from_yaml(cls, path: str) -> "YamlPddlDomain":
        with open(path) as f:
            return cls(yaml.safe_load(f))

    def ground_predicate(self, name: str, args: Sequence[PddlEntity]) -> GroundedPredicate:
        schema = self.predicates[name]
        valid, set_state = schema.factory(list(args), self.art_slots, **schema.kwargs)
        if schema.set_kwargs is not None:
            _, set_state = schema.factory(list(args), self.art_slots, **schema.set_kwargs)
        return GroundedPredicate(name, list(args), valid, set_state)

    def _entities_of_type(self, t: str, extra: Dict[str, PddlEntity]) -> List[PddlEntity]:
        return [e for e in {**self.constants, **extra}.values() if self.types.is_subtype(e.expr_type, t)]

    def get_possible_predicates(self, extra: Dict[str, PddlEntity]) -> List[GroundedPredicate]:
        """Every type-compatible grounding of every predicate over the
        constants and ``extra``, sorted by ``compact_str``: the reference's
        GlobalPredicatesSensor universe (pddl_domain.py:420-439). The
        groundings are combinations in insertion order, not permutations, so
        pass objects, goals and receptacles before robots."""
        ents = list({**self.constants, **extra}.values())
        out = []
        for schema in self.predicates.values():
            for combo in itertools.combinations(ents, len(schema.param_types)):
                if all(self.types.is_subtype(e.expr_type, t) for e, t in zip(combo, schema.param_types)):
                    out.append(self.ground_predicate(schema.name, list(combo)))
        return sorted(out, key=lambda p: p.compact_str)

    def parse_expr(self, node, scope: Dict[str, PddlEntity]):
        """A YAML expression -> a ``LogicalExpr`` or ``GroundedPredicate``:
        AND / OR / NAND / NOR nest; a single-variable FORALL expands over the
        in-scope entities of its type (reference pddl_logical_expr.py)."""
        if isinstance(node, str):
            name, arg_names = parse_predicate_call(node)
            return self.ground_predicate(name, [scope[a] for a in arg_names])
        expr_type = _EXPR_TYPES[node.get("expr_type", "AND")]
        if node.get("quantifier") == "FORALL":
            inputs = [PddlEntity(x["name"], x["expr_type"]) for x in node["inputs"]]
            if len(inputs) != 1:
                raise ValueError("only a single-variable FORALL is supported")
            var = inputs[0]
            expansions = [
                LogicalExpr(expr_type, [self.parse_expr(s, {**scope, var.name: ent}) for s in node["sub_exprs"]])
                for ent in self._entities_of_type(var.expr_type, scope)
            ]
            return LogicalExpr(LogicalExprType.AND, expansions)
        return LogicalExpr(expr_type, [self.parse_expr(s, scope) for s in node["sub_exprs"]])

    def bind_action(self, name: str, args: Sequence[PddlEntity]) -> PddlAction:
        schema = self.actions[name]
        scope = {**self.constants, **{p.name: e for p, e in zip(schema.params, args)}}
        pre = self.parse_expr(schema.precondition, scope) if schema.precondition else None
        post = (LogicalExpr(LogicalExprType.AND, [self.parse_expr(p, scope) for p in schema.postcondition])
                if schema.postcondition else None)
        return PddlAction(name, precond=pre, postcond=post, skill_name=name)


class PddlProblem:
    """A task spec: objects, init, goal, stage_goals and solution (reference
    pddl_domain.py:558 and pddl_task.py:22-36)."""

    def __init__(self, domain: YamlPddlDomain, node: dict):
        self.domain = domain
        self.objects = {o["name"]: PddlEntity(o["name"], o["expr_type"]) for o in node.get("objects") or ()}
        scope = {**domain.constants, **self.objects}
        self.init: List[GroundedPredicate] = []
        for call in node.get("init") or ():
            name, arg_names = parse_predicate_call(call)
            self.init.append(domain.ground_predicate(name, [scope[a] for a in arg_names]))
        self.goal = domain.parse_expr(node["goal"], scope) if node.get("goal") else None
        self.stage_goals = {k: domain.parse_expr(v, scope) for k, v in (node.get("stage_goals") or {}).items()}
        self.solution: List[PddlAction] = []
        self._solution_calls = []
        for call in node.get("solution") or ():
            name, arg_names = parse_predicate_call(call)
            args = [scope[a] for a in arg_names]
            self.solution.append(domain.bind_action(name, args))
            self._solution_calls.append((name, args))

    @classmethod
    def from_yaml(cls, domain: YamlPddlDomain, path: str) -> "PddlProblem":
        with open(path) as f:
            return cls(domain, yaml.safe_load(f))

    def apply_init(self, env, state):
        """The ``init:`` predicates applied to ``state`` in order, each
        through its set_state."""
        for pred in self.init:
            if pred.set_state_fn is not None:
                state = pred.set_state(env, state)
        return state

    def goal_satisfied(self, env, state) -> torch.Tensor:
        if self.goal is None:
            raise ValueError("the problem has no goal")
        return self.goal.is_true(env, state)

    def solution_to_skills(self):
        """The solution's actions as HRL skills: nav to a goal entity ->
        NavToGoalSkill, other nav -> OracleNavSkill, pick, place, open/close
        -> ArtObjSkill, anything else -> WaitSkill."""
        from habitat_torch.baselines.hrl.hierarchical import (
            ArtObjSkill,
            NavToGoalSkill,
            OracleNavSkill,
            PickSkill,
            PlaceSkill,
            WaitSkill,
        )

        skills = []
        for name, args in self._solution_calls:
            if name.startswith("nav"):
                skills.append(NavToGoalSkill() if any(a.expr_type == GOAL_TYPE for a in args) else OracleNavSkill())
            elif name == "pick":
                skills.append(PickSkill())
            elif name == "place":
                skills.append(PlaceSkill())
            elif name.startswith(("open", "close")):
                skills.append(ArtObjSkill())
            else:
                skills.append(WaitSkill())
        return skills
