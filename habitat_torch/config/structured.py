"""Structured config store: default schemas for every registered component
(a copy of ``habitat_tpu/config/structured.py``, data as is).

Counterpart of the reference's attrs-dataclass schema + Hydra ConfigStore
(habitat-lab/habitat/config/default_structured_configs.py: actions :133-395,
lab sensors :398-756, measures :760+, agent/sim/task/dataset roots; baselines
side habitat-baselines/habitat_baselines/config/default_structured_configs.py).
Field names match the reference so reference YAML overrides merge cleanly.

Store entries: (group, name) -> (node dict, package). Defaults-list resolution
consults the store first, then YAML files under habitat_tpu/config/.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple



class ConfigStore:
    def __init__(self):
        self._store: Dict[Tuple[str, str], Tuple[dict, Optional[str]]] = {}

    def store(self, group: str, name: str, node: dict, package: Optional[str] = None):
        self._store[(group.strip("/"), name)] = (node, package)

    def get(self, group: str, name: str):
        return self._store.get((group.strip("/"), name))


cs = ConfigStore()

# ---------------------------------------------------------------------------
# habitat.* (lab side)
# ---------------------------------------------------------------------------

ENVIRONMENT = dict(
    max_episode_steps=1000,
    max_episode_seconds=10000000,
    iterator_options=dict(
        cycle=True,
        shuffle=True,
        group_by_scene=True,
        num_episode_sample=-1,
        max_scene_repeat_episodes=-1,
        max_scene_repeat_steps=int(1e4),
        step_repetition_range=0.2,
    ),
)

# sim sensors (reference default_structured_configs.py sim sensor configs)
RGB_SENSOR = dict(
    type="HabitatSimRGBSensor",
    height=480,
    width=640,
    hfov=90,
    position=[0.0, 1.25, 0.0],
    orientation=[0.0, 0.0, 0.0],
)
DEPTH_SENSOR = dict(
    type="HabitatSimDepthSensor",
    height=480,
    width=640,
    hfov=90,
    position=[0.0, 1.25, 0.0],
    orientation=[0.0, 0.0, 0.0],
    min_depth=0.0,
    max_depth=10.0,
    normalize_depth=True,
)
SEMANTIC_SENSOR = dict(
    type="HabitatSimSemanticSensor",
    height=480,
    width=640,
    hfov=90,
    position=[0.0, 1.25, 0.0],
    orientation=[0.0, 0.0, 0.0],
)

AGENT = dict(
    height=1.5,
    radius=0.1,
    sim_sensors={},
    is_set_start_state=False,
    start_position=[0.0, 0.0, 0.0],
    start_rotation=[0.0, 0.0, 0.0, 1.0],
)

SIMULATOR = dict(
    type="Sim-v0",
    forward_step_size=0.25,
    turn_angle=10,
    tilt_angle=15,
    create_renderer=False,
    requires_textures=True,
    lag_observations=0,
    auto_sleep=False,
    step_physics=True,
    concur_render=False,
    needs_markers=True,
    update_articulated_agent=True,
    scene="procedural",
    scene_dataset="default",
    additional_object_paths=[],
    seed="${habitat.seed}",
    default_agent_id=0,
    debug_render=False,
    kinematic_mode=False,
    allow_sliding=True,
    navmesh_settings=dict(
        cell_size=0.1,  # our navgrid resolution
        cell_height=0.2,
        agent_max_climb=0.2,
        agent_max_slope=45.0,
    ),
    habitat_sim_v0=dict(
        gpu_device_id=0,
        gpu_gpu=True,  # frames are device arrays natively
        allow_sliding=True,
        enable_physics=False,
        physics_config_file="./data/default.physics_config.json",
        leave_context_with_background_renderer=False,
        enable_gfx_replay_save=False,
    ),
    agents=dict(),
    agents_order=[],
    # TPU-engine knobs (no reference counterpart)
    tpu=dict(
        tri_chunk=128,
        slide_substeps=4,
        render_backend="auto",  # auto | xla | pallas
    ),
)

TASK_BASE = dict(
    type="Nav-v0",
    reward_measure=None,
    success_measure=None,
    success_reward=2.5,
    slack_reward=-0.01,
    end_on_success=False,
    goal_sensor_uuid="pointgoal",
    count_obj_collisions=True,
    lab_sensors=dict(),
    measurements=dict(),
    actions=dict(),
    physics_target_sps=60.0,
)

DATASET_BASE = dict(
    type="PointNav-v1",
    split="train",
    scenes_dir="data/scene_datasets",
    content_scenes=["*"],
    data_path="",
    # procedural generation knobs (TPU-native builtin dataset; no reference
    # counterpart — reference downloads episode archives)
    procedural=dict(
        enabled=True,
        num_scenes=4,
        episodes_per_scene=32,
        seed=0,
        extent=10.0,
        nav_res=0.1,
        closest_dist_limit=1.0,
        furthest_dist_limit=30.0,
        geodesic_to_euclid_ratio=1.1,
    ),
)

HABITAT = dict(
    seed=100,
    env_task="GymHabitatEnv",
    env_task_gym_dependencies=[],
    env_task_gym_id="",
    environment=ENVIRONMENT,
    simulator=SIMULATOR,
    task=TASK_BASE,
    dataset=DATASET_BASE,
    gym=dict(
        auto_name="",
        obs_keys=None,
        action_keys=None,
        achieved_goal_keys=[],
        desired_goal_keys=[],
    ),
)

cs.store(group="habitat", name="habitat_config_base", node=HABITAT, package="habitat")
cs.store(
    group="habitat/task",
    name="task_config_base",
    node=TASK_BASE,
    package="habitat.task",
)

# actions (reference :1964-2040)
for _name, _node in {
    "stop": dict(type="StopAction"),
    "move_forward": dict(type="MoveForwardAction"),
    "turn_left": dict(type="TurnLeftAction"),
    "turn_right": dict(type="TurnRightAction"),
    "look_up": dict(type="LookUpAction"),
    "look_down": dict(type="LookDownAction"),
    "teleport": dict(type="TeleportAction"),
    "velocity_control": dict(
        type="VelocityAction",
        lin_vel_range=[0.0, 0.25],
        ang_vel_range=[-10.0, 10.0],
        min_abs_lin_speed=0.025,
        min_abs_ang_speed=1.0,
        time_step=1.0,
    ),
    # rearrange / multi-agent actions (reference default_structured_configs
    # .py:241-380, store names :1999-2070)
    "arm_action": dict(
        type="ArmAction",
        arm_controller="ArmRelPosAction",
        grip_controller=None,
        arm_joint_mask=None,
        arm_joint_dimensionality=7,
        grasp_thresh_dist=0.15,
        disable_grip=False,
        delta_pos_limit=0.0125,
        ee_ctrl_lim=0.015,
        should_clip=False,
        render_ee_target=False,
    ),
    "base_velocity": dict(
        type="BaseVelAction",
        lin_speed=10.0,
        ang_speed=10.0,
        allow_dyn_slide=True,
        allow_back=True,
    ),
    "base_velocity_non_cylinder": dict(
        type="BaseVelNonCylinderAction",
        lin_speed=10.0,
        ang_speed=10.0,
        allow_dyn_slide=True,
        allow_back=True,
    ),
    "humanoidjoint_action": dict(type="HumanoidJointAction", num_joints=17),
    "humanoid_pick_action": dict(type="HumanoidPickAction", dist_move_per_step=0.04),
    "empty": dict(type="EmptyAction"),
    "rearrange_stop": dict(type="RearrangeStopAction"),
    "a_selection_of_base_or_arm": dict(type="SelectBaseOrArmAction"),
    "answer": dict(type="AnswerAction"),
    "oracle_nav_action": dict(
        type="OracleNavAction",
        motion_control="base_velocity",
        num_joints=17,
        turn_velocity=1.0,
        forward_velocity=1.0,
        turn_thresh=0.1,
        dist_thresh=0.2,
        lin_speed=10.0,
        ang_speed=10.0,
        allow_dyn_slide=True,
        allow_back=True,
        spawn_max_dist_to_obj=2.0,
        num_spawn_attempts=200,
    ),
    "pddl_apply_action": dict(type="PddlApplyAction"),
}.items():
    cs.store(
        group="habitat/task/actions",
        name=_name,
        node=_node,
        package=f"habitat.task.actions.{_name}",
    )

# lab sensors (reference :398-756)
for _name, _key, _node in [
    ("pointgoal_sensor", "pointgoal", dict(type="PointGoalSensor", goal_format="POLAR", dimensionality=2)),
    (
        "pointgoal_with_gps_compass_sensor",
        "pointgoal_with_gps_compass",
        dict(type="PointGoalWithGPSCompassSensor", goal_format="POLAR", dimensionality=2),
    ),
    ("objectgoal_sensor", "objectgoal", dict(
        type="ObjectGoalSensor",
        goal_spec="TASK_CATEGORY_ID",
        goal_spec_max_val=50,
    )),
    ("compass_sensor", "compass", dict(type="CompassSensor")),
    ("gps_sensor", "gps", dict(type="GPSSensor", dimensionality=2)),
    ("heading_sensor", "heading", dict(type="HeadingSensor")),
    ("proximity_sensor", "proximity", dict(type="ProximitySensor", max_detection_radius=2.0)),
    ("imagegoal_sensor", "imagegoal", dict(type="ImageGoalSensor")),
    # rearrange / multi-agent / EQA / VLN lab sensors (reference store
    # names :398-756 and :2230-2320; packaged under the store name like the
    # reference does for these)
    ("instance_imagegoal_sensor", "instance_imagegoal_sensor", dict(type="InstanceImageGoalSensor")),
    ("instance_imagegoal_hfov_sensor", "instance_imagegoal_hfov_sensor", dict(type="InstanceImageGoalHFOVSensor")),
    ("localization_sensor", "localization_sensor", dict(type="LocalizationSensor")),
    ("target_start_sensor", "target_start_sensor", dict(type="TargetStartSensor", goal_format="CARTESIAN", dimensionality=3)),
    ("goal_sensor", "goal_sensor", dict(type="GoalSensor", goal_format="CARTESIAN", dimensionality=3)),
    ("abs_target_start_sensor", "abs_target_start_sensor", dict(type="AbsTargetStartSensor", goal_format="CARTESIAN", dimensionality=3)),
    ("abs_goal_sensor", "abs_goal_sensor", dict(type="AbsGoalSensor", goal_format="CARTESIAN", dimensionality=3)),
    ("joint_sensor", "joint_sensor", dict(type="JointSensor", dimensionality=7)),
    ("joint_velocity_sensor", "joint_velocity_sensor", dict(type="JointVelocitySensor", dimensionality=7)),
    ("humanoid_joint_sensor", "humanoid_joint_sensor", dict(type="HumanoidJointSensor")),
    ("end_effector_sensor", "end_effector_sensor", dict(type="EEPositionSensor")),
    ("is_holding_sensor", "is_holding_sensor", dict(type="IsHoldingSensor")),
    ("relative_resting_pos_sensor", "relative_resting_pos_sensor", dict(type="RelativeRestingPositionSensor")),
    ("instruction_sensor", "instruction_sensor", dict(type="InstructionSensor")),
    ("question_sensor", "question_sensor", dict(type="QuestionSensor")),
    ("object_sensor", "object_sensor", dict(type="TargetCurrentSensor", goal_format="CARTESIAN", dimensionality=3)),
    ("target_start_gps_compass_sensor", "target_start_gps_compass_sensor", dict(type="TargetStartGpsCompassSensor")),
    ("target_goal_gps_compass_sensor", "target_goal_gps_compass_sensor", dict(type="TargetGoalGpsCompassSensor")),
    ("initial_gps_compass_sensor", "initial_gps_compass_sensor", dict(type="InitialGpsCompassSensor")),
    ("humanoid_detector_sensor", "humanoid_detector_sensor", dict(type="HumanoidDetectorSensor", human_id=100, human_pixel_threshold=1000, return_image=False, is_return_image_bbox=False)),
    ("arm_depth_bbox_sensor", "arm_depth_bbox_sensor", dict(type="ArmDepthBBoxSensor", height=480, width=640)),
    ("spot_head_stereo_depth_sensor", "spot_head_stereo_depth_sensor", dict(type="SpotHeadStereoDepthSensor")),
    ("multi_agent_all_predicates", "multi_agent_all_predicates", dict(type="MultiAgentGlobalPredicatesSensor")),
    ("agents_within_threshold", "agents_within_threshold", dict(type="AreAgentsWithinThreshold", x_len=None, y_len=None, agent_idx=0)),
    ("has_finished_oracle_nav", "has_finished_oracle_nav", dict(type="HasFinishedOracleNavSensor")),
    ("has_finished_humanoid_pick", "has_finished_humanoid_pick", dict(type="HasFinishedHumanoidPickSensor")),
    ("other_agent_gps", "other_agent_gps", dict(type="OtherAgentGps")),
    ("nav_to_skill_sensor", "nav_to_skill_sensor", dict(type="NavToSkillSensor", num_skills=8)),
    ("nav_goal_sensor", "nav_goal_sensor", dict(type="NavGoalPointGoalSensor")),
    ("all_predicates", "all_predicates", dict(type="GlobalPredicatesSensor")),
]:
    cs.store(
        group="habitat/task/lab_sensors",
        name=_name,
        node=_node,
        package=f"habitat.task.lab_sensors.{_key}",
    )

# measurements (reference :760+)
for _name, _node in {
    "num_steps": dict(type="NumSteps"),
    "distance_to_goal": dict(type="DistanceToGoal", distance_to="POINT"),
    "success": dict(type="Success", success_distance=0.2),
    "spl": dict(type="SPL"),
    "soft_spl": dict(type="SoftSPL"),
    "collisions": dict(type="Collisions"),
    "distance_to_goal_reward": dict(type="DistanceToGoalReward"),
    "top_down_map": dict(
        type="TopDownMap",
        max_episode_steps="${habitat.environment.max_episode_steps}",
        map_padding=3,
        map_resolution=1024,
        draw_source=True,
        draw_border=True,
        draw_shortest_path=True,
        draw_view_points=True,
        draw_goal_positions=True,
        draw_goal_aabbs=True,
        fog_of_war=dict(draw=True, visibility_dist=5.0, fov=90),
    ),
    # rearrange / pddl / social-nav measurements (reference
    # default_structured_configs.py store names; minimal type nodes — the
    # batched engine computes these in tasks/rearrange/)
    "answer_accuracy": dict(type="AnswerAccuracy"),
    "art_obj_at_desired_state": dict(type="ArtObjAtDesiredState", use_absolute_distance=True, success_dist_threshold=0.05),
    "art_obj_reward": dict(type="ArtObjReward"),
    "art_obj_state": dict(type="ArtObjState"),
    "art_obj_success": dict(type="ArtObjSuccess", rest_dist_threshold=0.15, must_call_stop=True),
    "articulated_agent_colls": dict(type="RobotCollisions"),
    "articulated_agent_force": dict(type="RobotForce", min_force=20.0),
    "bad_called_terminate": dict(type="BadCalledTerminate", bad_term_pen=0.0, decay_bad_term=False),
    "base_to_object_distance": dict(type="BaseToObjectDistance"),
    "composite_stage_goals": dict(type="PddlStageGoals"),
    "did_agents_collide": dict(type="DidAgentsCollide"),
    "did_pick_object": dict(type="DidPickObjectMeasure"),
    "did_violate_hold_constraint": dict(type="DidViolateHoldConstraintMeasure"),
    "dist_to_goal": dict(type="DistToGoal"),
    "does_want_terminate": dict(type="DoesWantTerminate"),
    "ee_dist_to_marker": dict(type="EndEffectorDistToMarker"),
    "end_effector_to_goal_distance": dict(type="EndEffectorToGoalDistance"),
    "end_effector_to_object_distance": dict(type="EndEffectorToObjectDistance"),
    "end_effector_to_rest_distance": dict(type="EndEffectorToRestDistance"),
    "episode_info": dict(type="EpisodeInfo"),
    "force_terminate": dict(type="ForceTerminate", max_accum_force=-1.0, max_instant_force=-1.0),
    "gfx_replay_measure": dict(type="GfxReplayMeasure"),
    "habitat_perf": dict(type="RuntimePerfStats"),
    "move_objects_reward": dict(type="MoveObjectsReward"),
    "nav_to_pos_succ": dict(type="NavToPosSucc", success_distance=1.5),
    "num_agents_collide": dict(type="NumAgentsCollide"),
    "obj_at_goal": dict(type="ObjAtGoal", succ_thresh=0.15),
    "object_to_goal_distance": dict(type="ObjectToGoalDistance"),
    "pddl_subgoal_reward": dict(type="PddlSubgoalReward"),
    "pddl_success": dict(type="PddlSuccess", must_call_stop=True),
    "pick_reward": dict(type="RearrangePickReward", dist_reward=2.0),
    "pick_success": dict(type="RearrangePickSuccess", ee_resting_success_threshold=0.15),
    "place_reward": dict(type="PlaceReward", dist_reward=2.0),
    "place_success": dict(type="PlaceSuccess", ee_resting_success_threshold=0.15),
    "rearrange_cooperate_reward": dict(type="RearrangeCooperateReward"),
    "rearrange_nav_to_obj_reward": dict(type="NavToObjReward"),
    "rearrange_nav_to_obj_success": dict(type="NavToObjSuccess", must_look_at_targ=True, must_call_stop=True),
    "rearrange_reach_reward": dict(type="RearrangeReachReward"),
    "rearrange_reach_success": dict(type="RearrangeReachSuccess", succ_thresh=0.2),
    "rot_dist_to_goal": dict(type="RotDistToGoal"),
    "social_nav_reward": dict(type="SocialNavReward"),
    "social_nav_seek_success": dict(type="SocialNavSeekSuccess"),
    "social_nav_stats": dict(type="SocialNavStats"),
    "top_down_map": dict(type="TopDownMap", map_resolution=1024, draw_shortest_path=True),
    "zero": dict(type="ZeroMeasure"),
}.items():
    cs.store(
        group="habitat/task/measurements",
        name=_name,
        node=_node,
        package=f"habitat.task.measurements.{_name}",
    )

# sim sensor group entries
def _derived_sensor(base: dict, uuid: str, size: int) -> dict:
    d = dict(base)
    d.update(uuid=uuid, width=size, height=size)
    return d


# agent-mounted camera variants (reference default_structured_configs.py:
# Head/Arm/Jaw/Third *SensorConfig:1643-1726 — base sensors with a uuid
# prefix and square resolutions)
_AGENT_CAMERAS = {
    "head_rgb_sensor": _derived_sensor(RGB_SENSOR, "head_rgb", 256),
    "head_depth_sensor": _derived_sensor(DEPTH_SENSOR, "head_depth", 256),
    "head_panoptic_sensor": _derived_sensor(SEMANTIC_SENSOR, "head_panoptic", 256),
    "head_stereo_left_depth_sensor": _derived_sensor(
        DEPTH_SENSOR, "head_stereo_left_depth", 256
    ),
    "head_stereo_right_depth_sensor": _derived_sensor(
        DEPTH_SENSOR, "head_stereo_right_depth", 256
    ),
    "arm_rgb_sensor": _derived_sensor(RGB_SENSOR, "articulated_agent_arm_rgb", 256),
    "arm_depth_sensor": _derived_sensor(
        DEPTH_SENSOR, "articulated_agent_arm_depth", 256
    ),
    "arm_panoptic_sensor": _derived_sensor(
        SEMANTIC_SENSOR, "articulated_agent_arm_panoptic", 256
    ),
    "jaw_rgb_sensor": _derived_sensor(RGB_SENSOR, "articulated_agent_jaw_rgb", 256),
    "jaw_depth_sensor": _derived_sensor(
        DEPTH_SENSOR, "articulated_agent_jaw_depth", 256
    ),
    "jaw_panoptic_sensor": _derived_sensor(
        SEMANTIC_SENSOR, "articulated_agent_jaw_panoptic", 256
    ),
    "third_rgb_sensor": _derived_sensor(RGB_SENSOR, "third_rgb", 512),
    "third_depth_sensor": _derived_sensor(DEPTH_SENSOR, "third_depth", 512),
}
for _name, _node in {
    "rgb_sensor": RGB_SENSOR,
    "depth_sensor": DEPTH_SENSOR,
    "semantic_sensor": SEMANTIC_SENSOR,
    **_AGENT_CAMERAS,
}.items():
    cs.store(group="habitat/simulator/sim_sensors", name=_name, node=_node)

cs.store(group="habitat/simulator/agents", name="agent_base", node=AGENT)

# dataset schema
cs.store(
    group="habitat/dataset",
    name="dataset_config_schema",
    node=DATASET_BASE,
    package="habitat.dataset",
)

# ---------------------------------------------------------------------------
# habitat_baselines.*
# ---------------------------------------------------------------------------

PPO_DEFAULTS = dict(
    clip_param=0.2,
    ppo_epoch=4,
    num_mini_batch=2,
    value_loss_coef=0.5,
    entropy_coef=0.01,
    lr=2.5e-4,
    eps=1.0e-5,
    max_grad_norm=0.2,
    num_steps=128,
    use_gae=True,
    use_linear_lr_decay=False,
    use_linear_clip_decay=False,
    gamma=0.99,
    tau=0.95,
    reward_window_size=50,
    use_normalized_advantage=False,
    hidden_size=512,
    use_clipped_value_loss=True,
    use_double_buffered_sampler=False,  # moot on TPU: rollout is one scan
)

DDPPO_DEFAULTS = dict(
    sync_frac=0.6,  # moot on TPU (lock-step SPMD); kept for config compat
    distrib_backend="ICI",  # reference: GLOO/NCCL; here: JAX collectives
    rnn_type="LSTM",
    num_recurrent_layers=1,
    backbone="resnet18",
    pretrained_weights="",
    pretrained=False,
    pretrained_encoder=False,
    train_encoder=True,
    reset_critic=True,
    force_distributed=False,
)

POLICY = dict(
    name="PointNavResNetPolicy",
    action_distribution_type="categorical",
    action_dist=dict(use_log_std=True, use_softplus=False, std_init=0.0),
    obs_transforms=dict(),
    hierarchical_policy=None,
    normalize_visual_inputs=False,
)

HABITAT_BASELINES = dict(
    trainer_name="ppo",
    updater_name="PPO",
    distrib_updater_name="DDPPO",
    torch_gpu_id=0,
    video_render_views=[],
    tensorboard_dir="tb",
    writer_type="tb",
    video_dir="video_dir",
    video_fps=10,
    test_episode_count=-1,
    eval_ckpt_path_dir="data/checkpoints",
    num_environments=16,
    num_processes=-1,  # deprecated alias in reference
    checkpoint_folder="data/checkpoints",
    num_updates=-1,
    num_checkpoints=10,
    checkpoint_interval=-1,
    total_num_steps=-1.0,
    log_interval=10,
    log_file="train.log",
    force_blind_policy=False,
    verbose=True,
    eval_keys_to_include_in_name=[],
    force_torch_single_threaded=True,  # moot on TPU; config compat
    load_resume_state_config=True,
    eval=dict(
        split="val",
        use_ckpt_config=True,
        should_load_ckpt=True,
        evals_per_ep=1,
        video_option=[],
        extra_sim_sensors=dict(),
    ),
    profiling=dict(capture_start_step=-1, num_steps_to_capture=-1),
    rl=dict(
        preemption=dict(
            append_slurm_job_id=False,
            save_resume_state_interval=100,
            save_state_batch_only=False,
        ),
        policy=dict(main_agent=POLICY),
        ppo=PPO_DEFAULTS,
        ddppo=DDPPO_DEFAULTS,
        ver=dict(
            variable_experience=True,
            num_inference_workers=2,
            overlap_rollouts_and_learn=False,
        ),
        auxiliary_losses=dict(),
        agent=dict(type="SingleAgentAccessMgr", num_pool_agents_per_type=[1]),
    ),
)

cs.store(
    group="habitat_baselines",
    name="habitat_baselines_rl_config_base",
    node=HABITAT_BASELINES,
    package="habitat_baselines",
)

# IL variant (reference habitat-baselines default_structured_configs.py:510):
# same base config with an `il` dict instead of `rl`
_HB_IL = {k: v for k, v in HABITAT_BASELINES.items() if k != "rl"}
_HB_IL["il"] = dict()
cs.store(
    group="habitat_baselines",
    name="habitat_baselines_il_config_base",
    node=_HB_IL,
    package="habitat_baselines",
)

# obs-transform store entries (reference :108-215)
for _name, _node in {
    "center_cropper_base": dict(type="CenterCropper", height=256, width=256, channels_last=True),
    "resize_shortest_edge_base": dict(type="ResizeShortestEdge", size=256, channels_last=True, trans_keys=["rgb", "depth", "semantic"], semantic_key="semantic"),
    "cube_2_eq_base": dict(type="CubeMap2Equirect", height=256, width=512),
    "cube_2_fish_base": dict(type="CubeMap2Fisheye", height=256, width=256, fov=180, params=[0.2, 0.2, 0.2]),
    "add_virtual_keys_base": dict(type="AddVirtualKeys", virtual_keys=dict()),
    "eq_2_cube_base": dict(type="Equirect2CubeMap", height=256, width=256),
}.items():
    _key = _name.replace("_base", "")
    cs.store(
        group="habitat_baselines/rl/policy/obs_transforms",
        name=_name,
        node=_node,
        package=f"habitat_baselines.rl.policy.obs_transforms.{_key}",
    )
