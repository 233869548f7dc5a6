"""Registry-resolved, agent-invocable task actions for the batched rearrange
env (port of ``habitat_tpu/tasks/rearrange/task_actions.py``).

The reference resolves every YAML ``habitat.task.actions`` ``type:`` string
through its registry into TaskAction objects whose action spaces the gym
wrapper flattens in declaration order
(habitat-lab/habitat/core/embodied_task.py:275-292 +
habitat-lab/habitat/gym/gym_wrapper.py:102-161). Here a ``type:`` resolves
to a *batched action spec*: it declares its slice of the flat action vector
(``dims``) and contributes commands for the step (``contribute(env, state,
x, cmd)`` writes into a cmd dict that the env's ``step_fn`` consumes). The
composed layout for the standard ``fetch_suction_arm_base`` group, [J joint
deltas | grip | lin | ang], is the fixed-menu ``control="arm"`` layout.
Every ``contribute`` is tensor work on the state's device with no host
sync.

Reference behaviors implemented:
- ArmAction composite (actions.py:102): ArmRelPos(Kinematic) joint-delta
  or ArmEEAction IK control + Magic/Suction grip slice.
- BaseVelAction (actions.py:434) (+ NonCylinder variant): lin/ang base
  velocities.
- RearrangeStopAction (actions.py): >0 calls stop.
- SelectBaseOrArmAction (actions.py:74-99): > 0 selects the arm.
- OracleNavAction (actions/oracle_nav_action.py:22): 1-based PDDL-entity
  index -> greedy collision-resolved steering toward that entity
  (dist_thresh/turn_thresh/velocities from config); 0 = no-op.
- OracleNavCoordinateAction (oracle_nav_action.py:255): explicit (x,y,z)
  target instead of an entity index.
- PddlApplyAction (actions/pddl_actions.py:12): per-schema 1-based entity
  args; the env applies the action's postcondition when its precondition
  holds (nav teleports next to the entity, pick snaps the object to the EE,
  place releases at the goal).

- HumanoidJointAction (actions.py:801): (4*num_joints + 32) pose and
  transforms; a nonzero base transform teleports the acting agent's root
  (snapped to the navgrid), all-zero keeps the pose.
- HumanoidPickAction (humanoid_actions.py:24): an (x, y, z) target; the
  acting agent grasps the valid object nearest it when the target is within
  0.4 m of that object and 1.5 m of the agent, all-zero is a no-op.

A spec named ``agent_<i>_...`` acts for agent i: the env gives the specs of
agent 1 (the humanoid lane of the two-agent env) their own command dict and
the humanoid's (pos, yaw) as ``pose``, which the steering actions steer. As
in the JAX package, that lane reads the base velocity, stop, PDDL and pick
commands; a base transform given to agent 1 moves nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from habitat_torch.core.registry import registry
from habitat_torch.ops import navgrid as ng

class BatchedTaskAction:
    """Base spec: a named slice of the flat action vector + a contribution
    to the step command dict.

    Multi-agent configs declare per-agent prefixed action names
    (``agent_1_oracle_nav_action``, reference ArticulatedAgentAction's
    ``_action_arg_prefix``); ``agent_idx`` is parsed from the name."""

    def __init__(self, cfg=None, name: str = ""):
        self.cfg = cfg
        self.name = name
        self.agent_idx = 0
        if name.startswith("agent_"):
            try:
                self.agent_idx = int(name.split("_")[1])
            except ValueError:
                pass

    def dims(self, env) -> int:
        raise NotImplementedError

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        """x: (N, dims) float32 slice; ``pose`` the acting agent's (pos,
        yaw), the robot's when None. Mutates cmd in place."""
        raise NotImplementedError

    def _get(self, key, default):
        if self.cfg is not None and hasattr(self.cfg, "get"):
            v = self.cfg.get(key, default)
            return default if v is None else v
        return default


def _angle_to(vec_xz: torch.Tensor) -> torch.Tensor:
    """Heading (yaw) that faces a forward = -z convention direction."""
    return torch.atan2(-vec_xz[..., 0], -vec_xz[..., 1])


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


@registry.register_task_action(name="ArmAction")
class ArmAction(BatchedTaskAction):
    """Composite arm + grip (reference actions.py:102-166). The arm slice
    is J joint deltas (ArmRelPos*) or 3 EE deltas (ArmEEAction); the grip
    slice is 1 scalar unless grip_controller is null or disable_grip."""

    def _is_ee(self) -> bool:
        return "EE" in str(self._get("arm_controller", "ArmRelPosAction"))

    def _has_grip(self) -> bool:
        grip = self._get("grip_controller", "MagicGraspAction")
        return bool(grip) and not bool(self._get("disable_grip", False))

    def dims(self, env) -> int:
        arm = 3 if self._is_ee() else env.n_joints
        return arm + (1 if self._has_grip() else 0)

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        x = x.clamp(-1.0, 1.0)
        if self._is_ee():
            cmd["ee_delta"] = x[:, 0:3] * env.ee_delta
        else:
            cmd["dq"] = x[:, : env.n_joints] * env.max_joint_delta
        if self._has_grip():
            cmd["grip"] = x[:, -1] > 0.0


@registry.register_task_action(name="BaseVelAction")
class BaseVelAction(BatchedTaskAction):
    """Base velocity (reference actions.py:434): [lin, ang] in [-1,1]."""

    def dims(self, env) -> int:
        return 2

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        x = x.clamp(-1.0, 1.0)
        lin = x[:, 0] if bool(self._get("allow_back", True)) else x[:, 0].clamp_min(0.0)
        cmd["lin"] = cmd.get("lin", 0.0) + lin
        cmd["ang"] = cmd.get("ang", 0.0) + x[:, 1]


@registry.register_task_action(name="BaseVelNonCylinderAction")
class BaseVelNonCylinderAction(BaseVelAction):
    """Non-cylinder collision variant (reference actions.py:541); the
    batched base collider is a disc, so this is behaviorally BaseVel."""


@registry.register_task_action(name="RearrangeStopAction")
class RearrangeStopAction(BatchedTaskAction):
    """>0 calls stop (reference actions.py RearrangeStopAction)."""

    def dims(self, env) -> int:
        return 1

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        stop = x[:, 0] > 0.0
        cmd["stop"] = cmd["stop"] | stop if "stop" in cmd else stop


@registry.register_task_action(name="SelectBaseOrArmAction")
class SelectBaseOrArmAction(BatchedTaskAction):
    """Base-xor-arm selection (reference actions.py:74-99): one scalar
    ``a_selection_of_base_or_arm``; > 0 selects the arm, otherwise the base.
    The env gates the deselected group's commands for this step."""

    def dims(self, env) -> int:
        return 1

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        cmd["sel_arm"] = x[:, 0] > 0.0


@registry.register_task_action(name="EmptyAction")
class EmptyAction(BatchedTaskAction):
    """No-op with an EmptySpace action space (0 flat dims)."""

    def dims(self, env) -> int:
        return 0

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        return None


def entity_positions(env, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ordered PDDL entity positions, (N, NE, 3) + validity (N, NE).

    Entity order = all objects (current positions), then all goals,
    mirroring the reference's get_ordered_entities_list over the episode's
    objects and target receptacles."""
    objs = env._obj_world(state)  # (N, O, 3)
    goals = env.table.target_pos[state.ep_idx]  # (N, O, 3)
    valid = env.table.obj_valid[state.ep_idx]
    return torch.cat([objs, goals], dim=1), torch.cat([valid, valid], dim=1)


def _steer_to_target(env, state, target, active, cfg_get, pose=None):
    """Greedy collision-resolved steering toward target (N, 3).

    Batched equivalent of the reference's navmesh-path follower
    (oracle_nav_action.py:157-254): evaluate a ring of candidate headings
    one resolved step ahead (``ops/navgrid.try_step`` sliding), steer toward
    the heading that most reduces straight-line distance; near the goal,
    turn in place to face the target. Returns (lin, ang, at_goal)."""
    dist_thresh = float(cfg_get("dist_thresh", 0.2))
    turn_thresh = float(cfg_get("turn_thresh", 0.1))
    fwd_v = float(cfg_get("forward_velocity", 1.0))
    turn_v = float(cfg_get("turn_velocity", 1.0))

    sid = env._sid(state)
    a_pos, a_yaw = pose if pose is not None else (state.pos, state.yaw)
    rel_xz = (target - a_pos)[:, 0::2]
    dist = torch.linalg.vector_norm(rel_xz, dim=-1)
    ang_to_obj = _wrap(_angle_to(rel_xz) - a_yaw)

    # candidate ring: resolved one-step-lookahead euclidean descent, the
    # N x n_dirs candidates as one batch of try_step
    n_dirs = 8
    offs = torch.arange(n_dirs, device=a_pos.device) * (2 * torch.pi / n_dirs)
    cyaw = a_yaw[:, None] + offs  # (N, D)
    fwd = torch.stack([-torch.sin(cyaw), torch.zeros_like(cyaw), -torch.cos(cyaw)], dim=-1)
    tgts = a_pos[:, None, :] + fwd * env.fwd
    n = a_pos.shape[0]
    p2, _ = ng.try_step(env.pack, sid.repeat_interleave(n_dirs), a_pos.repeat_interleave(n_dirs, 0),
                        tgts.reshape(n * n_dirs, 3))
    d_cands = torch.linalg.vector_norm((p2.reshape(n, n_dirs, 3) - target[:, None, :])[..., 0::2], dim=-1)
    best = (d_cands - torch.where(offs == 0, 1e-4, 0.0)).argmin(-1)
    ang_err = _wrap(offs[best])

    at_goal = (dist < dist_thresh) & (ang_to_obj.abs() < turn_thresh)
    # near goal: turn in place toward the entity; else follow the ring
    near = dist < dist_thresh
    turn_cmd = torch.where(near, ang_to_obj, ang_err)
    do_fwd = ~near & (ang_err.abs() < max(turn_thresh, 0.3))
    moving = active & ~at_goal
    lin = torch.where(moving & do_fwd, fwd_v, 0.0)
    ang = torch.where(moving, (turn_cmd / max(env.turn, 1e-6)).clamp(-1.0, 1.0) * turn_v, 0.0)
    return lin, ang, at_goal & active


def _add_steering(cmd, lin, ang, at_goal) -> None:
    cmd["lin"] = cmd.get("lin", 0.0) + lin
    cmd["ang"] = cmd.get("ang", 0.0) + ang
    cmd["oracle_nav_at_goal"] = at_goal


@registry.register_task_action(name="OracleNavAction")
class OracleNavAction(BatchedTaskAction):
    """1-based entity index -> steer toward that entity; <=0 is a no-op
    (reference oracle_nav_action.py:157-183)."""

    def dims(self, env) -> int:
        return 1

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        idx = torch.round(x[:, 0]).to(torch.int64)
        ents, valid = entity_positions(env, state)
        ne = ents.shape[1]
        safe = (idx - 1).clamp(0, ne - 1)
        n_idx = torch.arange(ents.shape[0], device=ents.device)
        active = (idx >= 1) & (idx <= ne) & valid[n_idx, safe]
        _add_steering(cmd, *_steer_to_target(env, state, ents[n_idx, safe], active, self._get, pose))


@registry.register_task_action(name="OracleNavCoordinateAction")
class OracleNavCoordinateAction(BatchedTaskAction):
    """(x,y,z) world target -> steer toward it; all-zero is a no-op
    (reference oracle_nav_action.py:255)."""

    def dims(self, env) -> int:
        return 3

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        target = x[:, 0:3]
        active = (target.abs() > 1e-6).any(-1)
        _add_steering(cmd, *_steer_to_target(env, state, target, active, self._get, pose))


@registry.register_task_action(name="OracleNavWithBackingUpAction")
class OracleNavWithBackingUpAction(OracleNavAction):
    """Backing-up variant collapses to the same steering (disc collider)."""


@registry.register_task_action(name="PddlApplyAction")
class PddlApplyAction(BatchedTaskAction):
    """Grounded PDDL action application (reference pddl_actions.py:12).

    The flat slice is [nav_arg | pick_arg | place_arg] (one 1-based entity
    arg per schema in PddlDomain.get_ordered_actions order; n_args == 1 for
    every schema in the rearrange domain). A nonzero block applies that
    schema's postcondition when its precondition holds:
      nav(e):   teleport the base to within ~1 m of entity e, facing it
      pick(o):  snap object o to the EE (sets held) if no object held
      place(g): drop the held object at goal g
    """

    N_SCHEMAS = 3  # nav, pick, place

    def dims(self, env) -> int:
        return self.N_SCHEMAS

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        cmd["pddl_apply"] = torch.round(x).to(torch.int64)  # (N, 3)


@registry.register_task_action(name="HumanoidJointAction")
class HumanoidJointAction(BatchedTaskAction):
    """(4*num_joints + 32) joint quaternions, then the offset and base
    transforms as column-major 4x4 matrices (reference actions.py:801-880).
    A base transform with any nonzero entry in the last 32 sets the root:
    its translation is the position, its rotated x axis the forward
    (``base_pos_override``); all-zero keeps the pose."""

    def dims(self, env) -> int:
        return 4 * int(self._get("num_joints", 17)) + 32

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        base_t = x[:, -16:].reshape(-1, 4, 4)
        is_set = (x[:, -32:].abs() > 1e-8).any(-1)
        fwd = base_t[:, 0, 0:3]
        cmd["base_pos_override"] = (is_set, base_t[:, 3, 0:3], torch.atan2(-fwd[:, 0], -fwd[:, 2]))
        cmd["humanoid_joints"] = x[:, :-32]


@registry.register_task_action(name="HumanoidPickAction")
class HumanoidPickAction(BatchedTaskAction):
    """(x, y, z) pick target (reference humanoid_actions.py:24): the acting
    agent grasps the object nearest the target when it is within reach;
    all-zero is a no-op."""

    def dims(self, env) -> int:
        return 3

    def contribute(self, env, state, x, cmd, pose=None) -> None:
        target = x[:, 0:3]
        cmd["humanoid_pick"] = ((target.abs() > 1e-6).any(-1), target)


def resolve_task_actions(actions_cfg):
    """YAML actions dict -> ordered spec list (declaration order, matching
    the reference gym flattening). Unknown ``type:`` raises KeyError."""
    specs = []
    for name, a_cfg in actions_cfg.items():
        if not hasattr(a_cfg, "get"):
            continue
        t = a_cfg.get("type", None)
        if t is None:
            # action groups name their type by convention (arm_action ->
            # ArmAction) when the YAML relies on the structured default
            t = {
                "arm_action": "ArmAction",
                "base_velocity": "BaseVelAction",
                "base_velocity_non_cylinder": "BaseVelNonCylinderAction",
                "rearrange_stop": "RearrangeStopAction",
                "oracle_nav_action": "OracleNavAction",
                "oracle_nav_with_backing_up_action": "OracleNavWithBackingUpAction",
                "empty": "EmptyAction",
                "pddl_apply_action": "PddlApplyAction",
                "humanoid_joint_action": "HumanoidJointAction",
                "humanoid_pick_obj_id_action": "HumanoidPickAction",
            }.get(name)
        if t is None:
            raise KeyError(f"action {name!r} declares no type")
        cls = registry.get_task_action(str(t))  # raises on unknown
        specs.append(cls(a_cfg, name=name))
    return specs
