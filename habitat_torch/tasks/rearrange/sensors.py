"""Registry-resolved sensor/measure specs for the batched rearrange envs
(port of ``habitat_tpu/tasks/rearrange/sensors.py``).

The reference resolves every YAML ``lab_sensors``/``measurements`` ``type:``
string through its registry into live Sensor/Measure objects
(habitat-lab/habitat/core/embodied_task.py:275-292). The batched env
computes a SUPERSET of observation/measure tensors in one step, so here a
``type:`` resolves to a *spec*: the keys that type contributes, plus a
capability check against the env. Construction
(core/construct.rearrange_env_from_config) resolves the declared lists,
raises on unknown types (KeyError from the registry) or unsupported ones
(ValueError from ``check`` or the env), and the env then emits exactly the
declared keys. Every reference type is registered. The multi-agent and
social-navigation types take their values from the envs that own those
layouts: the two-agent rearrangement env (``agent_1_*`` actions; its
observations are prefixed per agent and not filtered by key) emits
``other_agent_gps``, ``agents_within_threshold``, the predicate vectors and
``did_agents_collide`` / ``num_agents_collide``; the social-nav env
(``tasks/rearrange/social_nav.py``) emits ``humanoid_detector_sensor``,
``other_agent_gps``, ``nav_seek_success``, ``did_agents_collide`` and
SocialNavStats as ``social_nav_stats.<field>``. On a single-agent
rearrangement env ``GlobalPredicatesSensor`` and
``MultiAgentGlobalPredicatesSensor`` are emitted when declared; the other
multi-agent keys are not there and raise ``ValueError``. As in the JAX
package no env emits ``humanoid_joint_sensor`` or
``has_finished_human_pick``: the humanoid lane keeps no joint pose.

Reference type names + uuids: habitat-lab/habitat/tasks/rearrange/
rearrange_sensors.py (cls_uuid declarations), sub_tasks/pick_sensors.py,
place_sensors.py, art_obj_sensors.py, nav_to_obj_sensors.py,
multi_task/composite_sensors.py.
"""

from __future__ import annotations

from typing import Tuple

from habitat_torch.core.registry import registry


class BatchedSpec:
    """Base spec: ``keys`` are the env obs/measure keys this type emits."""

    keys: Tuple[str, ...] = ()
    #: substring requirements on env capability tags (see env.capabilities)
    requires: Tuple[str, ...] = ()

    def __init__(self, cfg=None):
        self.cfg = cfg

    def check(self, env) -> None:
        caps = getattr(env, "capabilities", ())
        for r in self.requires:
            if r not in caps:
                raise ValueError(
                    f"{type(self).__name__} requires env capability {r!r} "
                    f"(task={getattr(env, 'task', '?')}, caps={caps})"
                )


def _spec(kind: str, name: str, keys, requires=()):
    """Stamp out + register a spec class for a reference type name."""
    cls = type(
        name,
        (BatchedSpec,),
        {"keys": tuple(keys), "requires": tuple(requires)},
    )
    if kind == "sensor":
        registry.register_sensor(cls, name=name)
    else:
        registry.register_measure(cls, name=name)
    return cls


# --- lab sensors (rearrange_sensors.py) ------------------------------------
_spec("sensor", "TargetStartSensor", ["obj_start_sensor"])
_spec("sensor", "GoalSensor", ["obj_goal_sensor"])
_spec("sensor", "AbsTargetStartSensor", ["abs_obj_start_sensor"])
_spec("sensor", "AbsGoalSensor", ["abs_obj_goal_sensor"])
_spec("sensor", "JointSensor", ["joint"])
_spec("sensor", "JointVelocitySensor", ["joint_vel"])
_spec("sensor", "EEPositionSensor", ["ee_pos"])
_spec("sensor", "RelativeRestingPositionSensor", ["relative_resting_position"])
_spec("sensor", "IsHoldingSensor", ["is_holding"])
_spec("sensor", "LocalizationSensor", ["localization_sensor"])
_spec("sensor", "TargetStartGpsCompassSensor", ["obj_start_gps_compass"])
_spec("sensor", "TargetGoalGpsCompassSensor", ["obj_goal_gps_compass"])

# --- measures: core (rearrange_sensors.py) ---------------------------------
_spec("measure", "ObjectToGoalDistance", ["object_to_goal_distance"])
_spec("measure", "EndEffectorToObjectDistance", ["ee_to_object_distance"])
_spec("measure", "EndEffectorToGoalDistance", ["ee_to_goal_distance"])
_spec("measure", "EndEffectorToRestDistance", ["ee_to_rest_distance"])
_spec("measure", "BaseToObjectDistance", ["base_to_object_distance"])
_spec("measure", "DidPickObjectMeasure", ["did_pick_object"])
_spec("measure", "ObjAtGoal", ["obj_at_goal"])
_spec("measure", "RobotForce", ["articulated_agent_force"])
_spec("measure", "ForceTerminate", ["force_terminate"])
_spec("measure", "RobotCollisions", ["robot_collisions"])
_spec("measure", "NumStepsMeasure", ["num_steps"])
_spec("measure", "ZeroMeasure", ["zero"])
_spec("measure", "DoesWantTerminate", ["does_want_terminate"])
_spec("measure", "BadCalledTerminate", ["bad_called_terminate"])
_spec(
    "measure",
    "DidViolateHoldConstraintMeasure",
    ["did_violate_hold_constraint"],
)

# --- measures: pick / place (sub_tasks/{pick,place}_sensors.py) ------------
_spec("measure", "RearrangePickSuccess", ["pick_success"], ["pick"])
_spec("measure", "RearrangePickReward", ["pick_reward"], ["pick"])
_spec("measure", "PlaceSuccess", ["place_success"], ["place"])
_spec("measure", "PlaceReward", ["place_reward"], ["place"])

# --- measures: reach (sub_tasks/reach_sensors.py) --------------------------
_spec(
    "measure", "RearrangeReachSuccess", ["rearrange_reach_success"], ["reach"]
)
_spec("measure", "RearrangeReachReward", ["rearrange_reach_reward"], ["reach"])

# --- measures: articulated object (sub_tasks/art_obj_sensors.py) -----------
_ART = ["open", "close"]


class _ArtSpec(BatchedSpec):
    def check(self, env):
        caps = getattr(env, "capabilities", ())
        if not any(a in caps for a in _ART):
            raise ValueError(
                f"{type(self).__name__} needs an articulated-object task "
                f"(open/close), got task={getattr(env, 'task', '?')}"
            )


def _art_spec(name, keys):
    cls = type(name, (_ArtSpec,), {"keys": tuple(keys)})
    registry.register_measure(cls, name=name)


_art_spec("ArtObjState", ["art_obj_state"])
_art_spec("ArtObjAtDesiredState", ["art_obj_at_desired_state"])
_art_spec("ArtObjSuccess", ["art_obj_success"])
_art_spec("ArtObjReward", ["art_obj_reward"])
_art_spec("EndEffectorDistToMarker", ["ee_dist_to_marker"])

# --- measures: nav-to-obj (sub_tasks/nav_to_obj_sensors.py) ----------------
_spec("measure", "RotDistToGoal", ["rot_dist_to_goal"], ["nav_to_obj"])
_spec("measure", "DistToGoal", ["dist_to_goal"], ["nav_to_obj"])
_spec("measure", "NavToObjSuccess", ["nav_to_obj_success"], ["nav_to_obj"])
_spec("measure", "NavToObjReward", ["nav_to_obj_reward"], ["nav_to_obj"])
_spec("measure", "NavToPosSucc", ["nav_to_pos_success"], ["nav_to_obj"])

# --- measures: composite/PDDL (multi_task/composite_sensors.py) ------------
_spec("measure", "PddlSuccess", ["pddl_success"], ["rearrange"])
_spec("measure", "PddlStageGoals", ["pddl_stage_goals"], ["rearrange"])
_spec("measure", "PddlSubgoalReward", ["pddl_subgoal_reward"], ["rearrange"])
_spec("measure", "MoveObjectsReward", ["move_objects_reward"], ["rearrange"])
_spec("measure", "CompositeSuccess", ["pddl_success"], ["rearrange"])

# --- hab3 / multi-agent types (social_nav_sensors.py, multi_agent_sensors.py,
# humanoid sensors). The multi-agent envs emit them in their own fixed
# layouts (construct.rearrange_env_from_config declares no key filter for a
# multi-agent config).
_spec("sensor", "AreAgentsWithinThreshold", ["agents_within_threshold"])
_spec("sensor", "OtherAgentGps", ["other_agent_gps"])
_spec("sensor", "HumanoidJointSensor", ["humanoid_joint_sensor"])
_spec("sensor", "HumanoidDetectorSensor", ["humanoid_detector_sensor"])
_spec("sensor", "HasFinishedOracleNavSensor", ["has_finished_oracle_nav"])
_spec("sensor", "HasFinishedHumanoidPickSensor", ["has_finished_human_pick"])
_spec("sensor", "NavGoalPointGoalSensor", ["goal_to_agent_gps_compass"])
_spec("sensor", "SpotHeadStereoDepthSensor", ["spot_head_stereo_depth_sensor"])
_spec("sensor", "ArmDepthBBoxSensor", ["arm_depth_bbox_sensor"])
_spec("sensor", "TargetCurrentSensor", ["obj_goal_pos_sensor"])
_spec("sensor", "InitialGpsCompassSensor", ["initial_gps_compass_sensor"])
_spec("sensor", "NavToSkillSensor", ["nav_to_skill_sensor"])
# PDDL predicate truth vectors (multi_task/pddl_sensors.py:25-57 and
# multi_agent_sensors.py:121-156): every predicate of the env's domain
# grounded once by multi_task/pddl_yaml.py, evaluated in the step
_spec("sensor", "GlobalPredicatesSensor", ["all_predicates"])
_spec(
    "sensor",
    "MultiAgentGlobalPredicatesSensor",
    ["multi_agent_all_predicates"],
)
_spec("measure", "DidAgentsCollide", ["did_agents_collide"])
_spec("measure", "NumAgentsCollide", ["num_agents_collide"])
_spec("measure", "RearrangeCooperateReward", ["rearrange_cooperate_reward"])
_spec("measure", "SocialNavReward", ["social_nav_reward"])
_spec("measure", "SocialNavSeekSuccess", ["nav_seek_success"])
_spec("measure", "SocialNavStats", ["social_nav_stats"])
_spec("measure", "PddlSubgoalSensor", ["pddl_subgoal"])
