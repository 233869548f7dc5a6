"""Config -> engine construction (port of ``habitat_tpu/core/construct.py``).

Counterpart of the reference wiring: Env.__init__ (make_dataset/make_sim/
make_task, core/env.py:70-137), EmbodiedTask._init_entities (registry-driven
type resolution, core/embodied_task.py:275-292) and the baselines env factory
(common/habitat_env_factory.py:19). Every ``type:`` string resolves through
the registry under the JAX package's names, so the in-repo YAML composes
into the port's envs, policy and trainer. Everything is built on ``device``
(``None`` = cuda).

``trainer_name`` "ppo", "ddppo" (DD-PPO over the process group that
``baselines/run.py`` forms) and "ver" build the port's trainers;
``rl.ddppo.rnn_type`` (LSTM or GRU) and ``rl.ddppo.backbone`` (every
backbone of ``models/resnet.py``) build the policy. A hierarchical
experiment (``updater_name`` HRL..., or a ``hierarchical_policy`` block)
builds HRL-PPO over the oracle skills (``baselines/hrl``) on a
rearrangement env in discrete control without the head camera. The EQA
imitation trainers (``eqa-cnn-pretrain``, ``vqa``, ``pacman``) build over
their procedural envs (``il_trainer_from_config``).

Image-goal observations feed the policy's goal encoders and are never put
in ``goal_keys``: the JAX package's ``policy_from_config`` passes
``goal_sensor_uuid`` "imagegoal" there, where its net feeds the raw goal
image through a Dense layer and fails to initialise.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

import habitat_torch.baselines.il.eqa_trainers  # noqa: F401  (registers the EQA trainers)
import habitat_torch.baselines.il.pacman  # noqa: F401  (registers the PACMAN trainer)
import habitat_torch.models.policy  # noqa: F401  (registers the policies)
import habitat_torch.tasks.eqa  # noqa: F401  (registers the EQA components)
import habitat_torch.tasks.nav  # noqa: F401  (registers the nav components)
import habitat_torch.tasks.vln  # noqa: F401  (registers the VLN components)
from habitat_torch.baselines.ppo import PPOConfig
from habitat_torch.baselines.trainer import TrainerConfig
from habitat_torch.config.omega import Config
from habitat_torch.core.batched_env import BatchedEnv, RewardSpec
from habitat_torch.core.dataset import build_env_episode_order, build_episode_table
from habitat_torch.core.logging import logger
from habitat_torch.core.registry import registry
from habitat_torch.device import resolve_device
from habitat_torch.models.policy import IMAGE_GOAL_KEYS, obs_inputs_of
from habitat_torch.parallel import distributed
from habitat_torch.sims.scene import pack_scenes

# the image-goal lab sensors of ImageNav (datasets/image_nav.py)
IMAGE_GOAL_SENSORS = ("imagegoal", "instance_imagegoal", "instance_imagegoal_sensor")


def load_dataset(ds_cfg: Config):
    """Returns (scenes, episodes, precomputed_fields or None).

    "PointNav-v1" or "ObjectNav*" whose ``data_path`` is on disk: the
    reference-format episode file and the scene meshes its episodes name
    (found as given or under ``scenes_dir``), each scene under the id its
    episodes use. "PointNav-v1-Procedural" (or "PointNav-v1" whose
    ``data_path`` is not on disk, with a warning, as the JAX package falls
    back): the built-in procedural generator. "ObjectNav*" without a file:
    the procedural ObjectNav generator."""
    from habitat_torch.datasets.pointnav import PointNavDatasetV1, make_procedural_pointnav

    ds_type = ds_cfg.get("type", "PointNav-v1")
    proc = ds_cfg.get("procedural", Config())
    data_path = (ds_cfg.get("data_path") or "").format(split=ds_cfg.get("split", "train"))
    on_disk = bool(data_path) and os.path.exists(data_path)

    if ds_type.startswith("ObjectNav"):
        from habitat_torch.datasets.object_nav import ObjectNavDatasetV1, make_procedural_objectnav

        if on_disk:
            return _with_scenes(ObjectNavDatasetV1(ds_cfg), ds_cfg)
        return make_procedural_objectnav(
            num_scenes=int(proc.get("num_scenes", 4)),
            episodes_per_scene=int(proc.get("episodes_per_scene", 32)),
            seed=int(proc.get("seed", 0)),
            extent=float(proc.get("extent", 10.0)),
            nav_res=float(proc.get("nav_res", 0.1)),
        )
    if ds_type == "PointNav-v1" and on_disk:
        return _with_scenes(PointNavDatasetV1(ds_cfg), ds_cfg)
    if ds_type == "PointNav-v1" and data_path:
        logger.warning(f"dataset file {data_path!r} not found: falling back to the built-in procedural dataset")

    return make_procedural_pointnav(
        num_scenes=int(proc.get("num_scenes", 4)),
        episodes_per_scene=int(proc.get("episodes_per_scene", 32)),
        seed=int(proc.get("seed", 0)),
        extent=float(proc.get("extent", 10.0)),
        nav_res=float(proc.get("nav_res", 0.1)),
        closest_dist_limit=float(proc.get("closest_dist_limit", 1.0)),
        furthest_dist_limit=float(proc.get("furthest_dist_limit", 30.0)),
        geodesic_to_euclid_ratio=float(proc.get("geodesic_to_euclid_ratio", 1.1)),
    )


def _with_scenes(dataset, ds_cfg: Config):
    """(scenes, episodes, None) of an episode file: each scene its episodes
    name, loaded from disk and keyed by that name. (The JAX package keys a
    loaded scene by its file name, which differs from the path its episodes
    name, so its episode table cannot find it.)"""
    from habitat_torch.sims.loaders import load_scene

    scenes = []
    for sid in dataset.scene_ids:
        scene = load_scene(sid, scenes_dir=ds_cfg.get("scenes_dir", ""))
        scene.scene_id = sid
        scenes.append(scene)
    return scenes, dataset.episodes, None


def _sensor_instances(config: Config) -> List:
    """Visual sensors from sim_sensors + lab sensors from task.lab_sensors."""
    sensors = []
    agents = config.habitat.simulator.get("agents", Config())
    for agent_name in config.habitat.simulator.get("agents_order") or sorted(agents):
        agent = agents[agent_name]
        for _, s_cfg in sorted(agent.get("sim_sensors", Config()).items()):
            sensors.append(registry.get_sensor(s_cfg["type"])(s_cfg))
    for _, s_cfg in sorted(config.habitat.task.get("lab_sensors", Config()).items()):
        sensors.append(registry.get_sensor(s_cfg["type"])(s_cfg))
    return sensors


def _measure_instances(config: Config) -> List:
    """Declared measurement types resolve through the registry; an unknown
    type raises (reference embodied_task.py:275-292)."""
    return [registry.get_measure(m_cfg["type"])(m_cfg)
            for _, m_cfg in sorted(config.habitat.task.get("measurements", Config()).items())]


def _action_instances(config: Config) -> List:
    sim = config.habitat.simulator
    actions = []
    for _, a_cfg in config.habitat.task.get("actions", Config()).items():
        cls = registry.get_task_action(a_cfg["type"])
        merged = Config(a_cfg.to_dict())
        # nav actions read movement amounts from the simulator config
        # (reference MoveForwardAction calls sim defaults)
        merged["forward_step_size"] = sim.get("forward_step_size", 0.25)
        merged["turn_angle"] = sim.get("turn_angle", 10)
        merged["tilt_angle"] = sim.get("tilt_angle", 15)
        actions.append(cls(merged))
    # stable, reference-like ordering: stop first if present, then insertion
    actions.sort(key=lambda a: not a.is_stop())
    return actions


def env_from_config(config: Config, num_envs: Optional[int] = None, device=None, rows: slice = slice(None)):
    """The PointNav ``BatchedEnv``, or for ``Rearrange*`` task types the
    ``RearrangeBatchedEnv``, that ``config`` describes, on ``device``:
    ``rows`` of its ``num_envs`` envs (a DD-PPO rank's; all by default)."""
    task_type = config.habitat.task.get("type", "Nav-v0")
    if task_type.startswith("Rearrange"):
        return rearrange_env_from_config(config, num_envs, device=device, rows=rows)
    dev = resolve_device(device)
    scenes, episodes, fields = load_dataset(config.habitat.dataset)
    if num_envs is None:
        num_envs = int(config.get_path("habitat_baselines.num_environments", 16))

    scene_index = {s.scene_id: i for i, s in enumerate(scenes)}
    table = build_episode_table(list(episodes), {s.scene_id: s for s in scenes}, scene_index,
                                precomputed_fields=fields, goal_image_size=goal_image_size(config.habitat.task),
                                device=dev)
    it_opts = config.habitat.environment.get("iterator_options", Config())
    order = build_env_episode_order(
        list(episodes),
        num_envs,
        group_by_scene=bool(it_opts.get("group_by_scene", True)),
        shuffle=bool(it_opts.get("shuffle", True)),
        seed=int(config.habitat.get("seed", 0)),
    )
    return BatchedEnv(
        pack_scenes(list(scenes)),
        table,
        order,
        _sensor_instances(config),
        _measure_instances(config),
        _action_instances(config),
        device=dev,
        rows=rows,
        max_episode_steps=int(config.habitat.environment.get("max_episode_steps", 500)),
        reward_spec=reward_spec_of(config.habitat.task),
        slide_substeps=int(config.habitat.simulator.get_path("tpu.slide_substeps", 4)),
    )


def reward_spec_of(task: Config) -> RewardSpec:
    """The RLTaskEnv reward composition a task config names."""
    return RewardSpec(
        reward_measure=task.get("reward_measure") or "distance_to_goal_reward",
        success_measure=task.get("success_measure") or "success",
        slack_reward=float(task.get("slack_reward", -0.01)),
        success_reward=float(task.get("success_reward", 2.5)),
        end_on_success=bool(task.get("end_on_success", False)),
    )


def goal_image_size(task: Config) -> Optional[int]:
    """The width of the task's image-goal sensor (its goal views are
    rendered once at that size), or None without one."""
    lab_sensors = task.get("lab_sensors", Config())
    return next((int(lab_sensors[k].get("width", 128)) for k in IMAGE_GOAL_SENSORS if k in lab_sensors), None)


def policy_from_config(config: Config, env):
    """The policy ``habitat_baselines.rl.policy.main_agent`` names, built for
    ``env``'s actions, observations, frame size and device; a
    continuous-action env (``action_dim``, no ``num_actions``) gets
    ``GaussianResNetPolicy``. Blind (no rgb or depth, or
    ``force_blind_policy``) builds no visual encoder."""
    def hb(path, default):
        return config.get_path(f"habitat_baselines.{path}", default)

    shapes = env.observation_shapes
    visual = tuple(k for k in ("rgb", "depth") if k in shapes or f"robot_head_{k}" in shapes)
    has_visual = bool(visual) and not hb("force_blind_policy", False)
    goal_uuid = config.habitat.task.get("goal_sensor_uuid", "pointgoal_with_gps_compass")
    # image goals go through the goal encoders, never through goal_fc
    goal_keys = (goal_uuid,) if goal_uuid in shapes and goal_uuid not in IMAGE_GOAL_KEYS else ()
    kw = dict(
        backbone=hb("rl.ddppo.backbone", "resnet18"),
        hidden_size=int(hb("rl.ppo.hidden_size", 512)),
        rnn_type=hb("rl.ddppo.rnn_type", "LSTM"),
        num_recurrent_layers=int(hb("rl.ddppo.num_recurrent_layers", 1)),
        has_visual=has_visual,
        goal_keys=goal_keys,
        device=env.device,
        **obs_inputs_of(shapes),
    )
    if has_visual:
        frame = next(shapes[k] for k in ("depth", "rgb", "robot_head_depth", "robot_head_rgb") if k in shapes)
        kw.update(visual_inputs=visual, input_hw=tuple(frame[0][:2]))
    if not hasattr(env, "num_actions"):
        # a Box action space (rearrange arm/base control): the Gaussian head
        return registry.get_policy("GaussianResNetPolicy")(env.action_dim, **kw)
    builder = registry.get_policy(hb("rl.policy.main_agent.name", "PointNavResNetPolicy"))
    return builder(
        env.num_actions, normalize_visual_inputs=bool(hb("rl.policy.main_agent.normalize_visual_inputs", False)),
        **kw,
    )


def _skill_for(name: str):
    """The oracle skill a ``defined_skills`` entry grounds to, by its name."""
    from habitat_torch.baselines.hrl import hierarchical as h

    n = name.lower()
    if "pick" in n:
        return h.PickSkill()
    if "place" in n:
        return h.PlaceSkill()
    if "nav_to_obj" in n or n == "nav":
        return h.OracleNavSkill()
    if "nav" in n:
        return h.NavToGoalSkill()
    if "open" in n or "close" in n or "art" in n:
        return h.ArtObjSkill()
    return h.WaitSkill()


def hrl_trainer_from_config(config: Config, env):
    """Hierarchical experiments (reference rl_hierarchical.yaml: updater_name
    HRLPPO and a ``hierarchical_policy`` block with ``defined_skills``):
    HRL-PPO over the skills on ``env``. Each defined skill grounds by name
    to an oracle skill, one per skill class (open_cab, open_fridge,
    close_cab... all ground to ``ArtObjSkill``, and repeats would only
    dilute the high level's exploration); no defined skill gives the
    default plan's four. ``HrlPPOConfig`` comes from ``rl.ppo``, its hidden
    width capped at 256."""
    from habitat_torch.baselines.hrl.hierarchical import default_rearrange_plan
    from habitat_torch.baselines.hrl.hrl_ppo import HrlPPOConfig, HrlPPOLearner, HrlTrainer

    hb = config.habitat_baselines
    pol = hb.rl.policy.get("main_agent", Config()) or Config()
    defined = (pol.get("hierarchical_policy", Config()) or Config()).get("defined_skills", Config()) or Config()
    skills, seen = [], set()
    for name in defined.keys():
        s = _skill_for(name)
        if type(s) not in seen:
            seen.add(type(s))
            skills.append(s)
    p = hb.rl.ppo
    cfg = HrlPPOConfig(
        hidden_size=min(int(p.get("hidden_size", 128)), 256),
        lr=float(p.lr),
        gamma=float(p.gamma),
        tau=float(p.tau),
        clip_param=float(p.clip_param),
        ppo_epoch=max(1, int(p.ppo_epoch)),
        num_mini_batch=int(p.num_mini_batch),
        value_loss_coef=float(p.value_loss_coef),
        entropy_coef=float(p.entropy_coef),
        max_grad_norm=float(p.max_grad_norm),
    )
    return HrlTrainer(HrlPPOLearner(env, skills or default_rearrange_plan(), cfg),
                      total_num_steps=float(hb.get("total_num_steps", 1e6)),
                      log_interval=int(hb.get("log_interval", 10)))


IL_TRAINERS = ("eqa-cnn-pretrain", "vqa", "pacman")


class _ILFacade:
    """``train(seed)`` of an imitation learner for ``run.py``: updates until
    ``total_num_steps`` env steps (``steps_per_update`` each), a log line
    every ``log_interval`` updates; returns the last metrics as floats."""

    def __init__(self, learner, hb: Config, steps_per_update: int, update):
        self.learner, self.env = learner, learner.env
        self._hb, self._steps, self._update = hb, steps_per_update, update

    def train(self, seed: int = 0):
        total = float(self._hb.get("total_num_steps", 2e4))
        log_every = int(self._hb.get("log_interval", 10))
        step = self._update(seed)
        done, u, m = 0, 0, {}
        while done < total:
            m = {k: v.item() for k, v in step().items()}
            done += self._steps
            u += 1
            if u % log_every == 0:
                logger.info(f"il update {u} steps {done}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        return m


def il_trainer_from_config(config: Config, trainer_name: str, device=None):
    """The EQA imitation experiments (reference il_eqa_cnn_pretrain.yaml,
    il_vqa.yaml, il_pacman_nav.yaml): the learner over its procedural env
    on ``device``, behind a ``train(seed)`` facade. ``eqa-cnn-pretrain``:
    ``make_nav_env`` on 2 x 8 procedural PointNav episodes with 64x64 RGB,
    depth and semantics and the pointgoal; ``vqa`` and ``pacman``:
    ``make_eqa_env(visual_size=64)``. ``num_environments`` (default 8),
    ``habitat.seed``, ``total_num_steps``, ``log_interval`` and
    ``il.num_epochs`` (PACMAN, default 10) are read as the JAX package
    reads them."""
    from habitat_torch.baselines.il.eqa_trainers import EQACNNPretrainLearner, VQALearner
    from habitat_torch.baselines.il.pacman import PacmanTrainer
    from habitat_torch.tasks.eqa import make_eqa_env

    hb = config.habitat_baselines
    num_envs = int(hb.get("num_environments", 8))
    seed = int(config.habitat.get("seed", 0))
    dev = resolve_device(device)
    if trainer_name == "eqa-cnn-pretrain":
        from habitat_torch.core.env_factory import make_nav_env
        from habitat_torch.datasets.pointnav import make_procedural_pointnav

        scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=8, seed=seed)
        frame = {"height": 64, "width": 64}
        env = make_nav_env(
            scenes, episodes, num_envs=num_envs, precomputed_fields=fields, max_episode_steps=100, device=dev,
            sensor_specs=(("HabitatSimRGBSensor", frame), ("HabitatSimDepthSensor", frame),
                          ("HabitatSimSemanticSensor", frame), ("PointGoalWithGPSCompassSensor", None)))
        learner = EQACNNPretrainLearner(env)

        def pretrain(seed):
            box = [learner.init(seed)]

            def step():
                box[0], m = learner.train_step(box[0])
                return m
            return step

        return _ILFacade(learner, hb, num_envs, pretrain)
    env = make_eqa_env(num_envs=num_envs, seed=seed, visual_size=64, device=dev)
    if trainer_name == "vqa":
        learner = VQALearner(env)

        def vqa(seed):
            # walk the envs for frame and episode variety (the reference
            # samples its disk dataset per batch), actions in {0, 1, 2}; the
            # step's frames are the next batch's
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + 2)
            box = list(env.reset_fn())

            def step():
                m = learner.train_step(*box)
                acts = torch.randint(0, 3, (env.num_envs,), generator=gen, device=dev)
                with torch.no_grad():
                    box[:] = env.step_fn(box[0], acts)[:2]
                return m
            return step

        return _ILFacade(learner, hb, num_envs, vqa)
    if trainer_name == "pacman":
        trainer = PacmanTrainer(env)

        class _PacmanFacade:
            def __init__(self):
                self.learner, self.env = trainer, env

            def train(self, seed: int = 0):
                return trainer.train(num_epochs=int(hb.get("il", Config()).get("num_epochs", 10) or 10), seed=seed)

        return _PacmanFacade()
    raise KeyError(trainer_name)


def trainer_from_config(config: Config, device=None):
    """The trainer ``habitat_baselines.trainer_name`` names, with its env and
    policy, on ``device``. Under a process group the env is this rank's
    rows of the global N (``parallel/distributed.py::env_rows``), decided
    here and handed to the env and the trainer."""
    hb = config.habitat_baselines
    trainer_name = str(hb.get("trainer_name", "ppo"))
    if trainer_name in IL_TRAINERS:
        return il_trainer_from_config(config, trainer_name, device=device)
    rows = distributed.env_rows(int(hb.get("num_environments", 16)))
    pol_main = hb.rl.policy.get("main_agent", Config()) or Config()
    if str(hb.get("updater_name", "")).upper().startswith("HRL") or pol_main.get("hierarchical_policy", None):
        if distributed.world().size > 1:
            raise ValueError("HRL-PPO trains in one process: run it without a process group")
        # the oracle skills drive the discrete action set and read state
        # sensors only, so the env is built in discrete control (whatever
        # arm_action the YAML declares for neural skills) without the camera
        env = rearrange_env_from_config(config, rows.n_global, force_control="discrete", with_visual=False,
                                        device=device, rows=rows.slice)
        return hrl_trainer_from_config(config, env)
    trainer_cls = registry.get_trainer(trainer_name)
    p = hb.rl.ppo
    ppo_cfg = PPOConfig(
        clip_param=float(p.clip_param),
        ppo_epoch=int(p.ppo_epoch),
        num_mini_batch=int(p.num_mini_batch),
        value_loss_coef=float(p.value_loss_coef),
        entropy_coef=float(p.entropy_coef),
        lr=float(p.lr),
        eps=float(p.eps),
        max_grad_norm=float(p.max_grad_norm),
        num_steps=int(p.num_steps),
        gamma=float(p.gamma),
        tau=float(p.tau),
        use_clipped_value_loss=bool(p.get("use_clipped_value_loss", True)),
        use_normalized_advantage=bool(p.get("use_normalized_advantage", False)),
        reward_window_size=int(p.get("reward_window_size", 50)),
        use_adaptive_entropy_pen=bool(p.get("use_adaptive_entropy_pen", False)),
        entropy_target_factor=float(p.get("entropy_target_factor", 0.0)),
    )
    run_cfg = TrainerConfig(
        total_num_steps=float(hb.get("total_num_steps", 1e6)),
        checkpoint_folder=hb.get("checkpoint_folder", "data/checkpoints"),
        tensorboard_dir=hb.get("tensorboard_dir", ""),
        num_checkpoints=int(hb.get("num_checkpoints", 10)),
        checkpoint_interval=int(hb.get("checkpoint_interval", -1)),
        log_interval=int(hb.get("log_interval", 10)),
        reward_window_size=int(p.get("reward_window_size", 50)),
        use_mesh=trainer_name == "ddppo",
        verbose=bool(hb.get("verbose", True)),
    )
    env = env_from_config(config, rows.n_global, device=device, rows=rows.slice)
    return trainer_cls(env, policy_from_config(config, env), ppo_cfg, run_cfg, rows=rows)


# rearrange task type -> the env's task (reference rearrange_task.py:32 + sub_tasks/)
REARRANGE_TASKS = {
    "RearrangePickTask-v0": "pick",
    "RearrangePlaceTask-v0": "place",
    "RearrangeEmptyTask-v0": "empty",
    "RearrangeReachTask-v0": "reach",
    "RearrangeCompositeTask-v0": "rearrange",
    "RearrangePddlTask-v0": "rearrange",
    "NavToObjTask-v0": "nav_to_obj",
    "RearrangeOpenDrawerTask-v0": "open",
    "RearrangeOpenFridgeTask-v0": "open",
    "RearrangeCloseDrawerTask-v0": "close",
    "RearrangeCloseFridgeTask-v0": "close",
}


def rearrange_env_from_config(
    config: Config,
    num_envs: Optional[int] = None,
    force_control: Optional[str] = None,
    with_visual: bool = True,
    device=None,
    rows: slice = slice(None),
):
    """Rearrange task types -> ``RearrangeBatchedEnv`` on ``device``
    (``rows`` of its envs, as in ``env_from_config``). ``force_control``
    sets the control mode and keeps the fixed action menu, whatever actions
    the config declares (HRL's oracle skills take "discrete").

    Registry contract (reference core/embodied_task.py:275-292): every
    declared ``lab_sensors``/``measurements``/``actions`` ``type:`` resolves
    through the registry into the env's observations, measures and action
    specs: an unknown type raises KeyError here, an unsupported one
    ValueError at env construction, an unported one NotImplementedError."""
    import habitat_torch.tasks.rearrange.sensors  # noqa: F401  (registrations)
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env
    from habitat_torch.tasks.rearrange.task_actions import resolve_task_actions

    if num_envs is None:
        num_envs = int(config.get_path("habitat_baselines.num_environments", 16))
    task_type = config.habitat.task.get("type", "RearrangePickTask-v0")
    task = REARRANGE_TASKS.get(task_type, "pick")
    # fridge tasks articulate a revolute door, drawer tasks a prismatic slide
    art_joint = "revolute" if "Fridge" in task_type else "prismatic"
    proc = config.habitat.dataset.get("procedural", Config())
    # a declared arm_action maps onto the arm controller (reference ArmAction
    # composite, actions.py:102: ArmRelPos* -> joint deltas, ArmEEAction ->
    # IK)
    actions_cfg = config.get_path("habitat.task.actions", Config()) or Config()
    control = None
    arm_cfg = actions_cfg.get("arm_action", None)
    if arm_cfg is not None:
        control = "arm_ee" if "EE" in str(arm_cfg.get("arm_controller", "ArmRelPosAction")) else "arm"
    action_specs = None
    if force_control is not None:
        control = force_control
    elif len(actions_cfg):
        action_specs = resolve_task_actions(actions_cfg) or None
    # count real agent entries: the composer flattens the default agent's
    # fields (height/radius/...) into the agents dict; real agents are
    # main_agent / agent_<i> nodes holding a config dict
    agents = config.get_path("habitat.simulator.agents", Config()) or Config()
    n_agents = sum(1 for k, v in agents.items() if hasattr(v, "get") and (k == "main_agent" or k.startswith("agent_")))
    multi_agent = n_agents > 1
    sensor_keys = None
    lab_sensors = config.get_path("habitat.task.lab_sensors", None)
    if lab_sensors is not None:
        sensor_keys = []
        for _, s_cfg in sorted(lab_sensors.items()):
            sensor_keys.extend(getattr(registry.get_sensor(s_cfg["type"])(s_cfg), "keys", ()))
        if with_visual:
            sensor_keys.extend(["robot_head_depth", "robot_head_rgb"])
        sensor_keys = None if multi_agent else tuple(dict.fromkeys(sensor_keys))
    measure_keys = None
    max_accum_force = -1.0
    measurements = config.get_path("habitat.task.measurements", None)
    if measurements is not None:
        measure_keys = []
        for _, m_cfg in sorted(measurements.items()):
            measure_keys.extend(getattr(registry.get_measure(m_cfg["type"])(m_cfg), "keys", ()))
            if m_cfg.get("type") == "ForceTerminate":
                # live force semantics from the declared threshold
                max_accum_force = float(m_cfg.get("max_accum_force", -1.0) or -1.0)
        # the env's own bookkeeping keys stay available to wrappers
        measure_keys.extend(["success", "num_steps"])
        measure_keys = None if multi_agent else tuple(dict.fromkeys(measure_keys))
    # the reference's default is Bullet dynamics (rearrange_sim.py:1017-1028):
    # contacts unless habitat.simulator.tpu.dynamics says otherwise
    dynamics = str(config.get_path("habitat.simulator.tpu.dynamics", None) or "contacts")
    robot = "FetchRobot"
    for _, ag in agents.items():
        if not hasattr(ag, "get"):
            continue
        urdf = str(ag.get("articulated_agent_urdf", "") or "")
        typ = str(ag.get("articulated_agent_type", "") or "")
        for name in ("Spot", "Stretch", "Franka", "Fetch"):
            if name.lower() in urdf.lower() or name in typ:
                robot = f"{name}Robot"
                break
    return make_rearrange_env(
        num_envs=num_envs,
        task=task,
        art_joint=art_joint,
        num_scenes=int(proc.get("num_scenes", 2)),
        episodes_per_scene=int(proc.get("episodes_per_scene", 16)),
        n_rooms_per_axis=int(proc.get("n_rooms_per_axis", 2)),
        n_clutter=int(proc.get("n_clutter", 3)),
        num_objects=int(proc.get("num_objects", 3)),
        seed=int(config.habitat.get("seed", 0)),
        with_visual=with_visual,
        render_size=(128, 128),
        max_episode_steps=int(config.habitat.environment.get("max_episode_steps", 300)),
        success_reward=float(config.habitat.task.get("success_reward", 10.0)),
        slack_reward=float(config.habitat.task.get("slack_reward", -0.01)),
        control=control,
        robot=robot,
        # reference RearrangeTask grasp-constraint flags
        # (default_structured_configs.py:1489-1490)
        constraint_violation_ends_episode=bool(config.habitat.task.get("constraint_violation_ends_episode", False)),
        constraint_violation_drops_object=bool(config.habitat.task.get("constraint_violation_drops_object", False)),
        sensor_keys=sensor_keys,
        measure_keys=measure_keys,
        action_specs=action_specs,
        dynamics=dynamics,
        max_accum_force=max_accum_force,
        pddl_domain=str(config.get_path("habitat.task.pddl_domain_def", None) or "fp"),
        device=device,
        rows=rows,
    )
