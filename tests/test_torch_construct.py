"""habitat_torch's config-driven construction (``core/construct.py``) and
``run`` entry point (``baselines/run.py``) against habitat_tpu's on the CPU.

- ``env_from_config`` of ``pointnav_procgen.yaml`` at 32x32, N=2: action
  names, ``num_actions``, observation shapes and dtypes equal the JAX env's
  action and observation spaces; the reset and 4 steps of pose, pointgoal,
  reward and done within 1e-5.
- ``rearrange_env_from_config``: with a recorder in place of each package's
  ``make_rearrange_env``, the keyword arguments each hands over are equal
  (the port's ``device`` aside; action specs by type, name and width) for
  the four rearrangement ``*_procgen.yaml`` files and for configs that
  declare lab sensors, measurements (ForceTerminate), actions and a Spot
  URDF. No env is built.
- Unknown types raise ``KeyError`` (the JAX package's message), unsupported
  ones ``ValueError`` (also each spec's ``check`` against the env's
  capabilities), unported ones ``NotImplementedError``.
- ``run.main`` trains 2 updates from ``ppo_pointnav_example`` at
  tests/test_trainer.py's size and writes ``latest``; ``--run-type eval``
  loads it (parameters equal) and counts ``test_episode_count // N`` episodes
  per env. ``trainer_from_config``'s PPO and run settings equal the JAX
  trainer's for the fields both have.
"""

import dataclasses
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import habitat_tpu.core.construct as jcons
import habitat_tpu.tasks.rearrange.generator as jgen
from habitat_tpu.config.default import get_config as jax_get_config

import habitat_torch.core.construct as tcons
import habitat_torch.tasks.rearrange.generator as tgen
from habitat_torch.articulated_agents.params import ROBOTS
from habitat_torch.baselines import run
from habitat_torch.config.default import get_config
from habitat_torch.config.omega import read_write
from tests.test_trainer import OVERRIDES
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL = 1e-5
NAV_32 = [
    "habitat.simulator.agents.main_agent.sim_sensors.depth_sensor.width=32",
    "habitat.simulator.agents.main_agent.sim_sensors.depth_sensor.height=32",
    "habitat.dataset.procedural.num_scenes=1",
    "habitat.dataset.procedural.episodes_per_scene=4",
]
REARRANGE_ROOTS = ("pick_procgen", "place_procgen", "open_cab_procgen", "close_cab_procgen")
# overrides that declare what the procgen files leave to the defaults
DECLARED = {
    "lab_sensors+measurements": [
        "habitat.task.lab_sensors.joint.type=JointSensor",
        "habitat.task.lab_sensors.ee.type=EEPositionSensor",
        "habitat.task.lab_sensors.target_start.type=TargetStartSensor",
        "habitat.task.measurements.pick_success.type=RearrangePickSuccess",
        "habitat.task.measurements.force_terminate.type=ForceTerminate",
        "habitat.task.measurements.force_terminate.max_accum_force=5000.0",
    ],
    "arm_ee+base+stop+spot": [
        "habitat.task.actions.arm_action.type=ArmAction",
        "habitat.task.actions.arm_action.arm_controller=ArmEEAction",
        "habitat.task.actions.arm_action.grip_controller=SuctionGraspAction",
        "habitat.task.actions.base_velocity.type=BaseVelAction",
        "habitat.task.actions.rearrange_stop.type=RearrangeStopAction",
        "habitat.simulator.agents.main_agent.articulated_agent_urdf=data/robots/hab_spot_arm/urdf/hab_spot_arm.urdf",
        "habitat.simulator.tpu.dynamics=gravity",
    ],
    "oracle_nav+pddl+kinematic": [
        "habitat.task.actions.oracle_nav_action.type=OracleNavAction",
        "habitat.task.actions.pddl_apply_action.type=PddlApplyAction",
        "habitat.task.pddl_domain_def=tpu_rearrange",
        "habitat.simulator.tpu.dynamics=kinematic",
        "habitat.task.constraint_violation_drops_object=True",
    ],
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _both(path, overrides=()):
    return jax_get_config(path, list(overrides)), get_config(path, list(overrides))


# -- PointNav env from config --------------------------------------------------


def test_pointnav_env_from_config_matches():
    jcfg, tcfg = _both("benchmark/nav/pointnav/pointnav_procgen.yaml", NAV_32)
    je = jcons.env_from_config(jcfg, num_envs=2)
    te = tcons.env_from_config(tcfg, num_envs=2, device="cpu")
    assert te.action_names == je.action_names == ("stop", "move_forward", "turn_left", "turn_right")
    assert te.num_actions == je.action_space.n == 4
    spaces = je.observation_space.spaces
    assert set(te.observation_shapes) == set(spaces) == {"depth", "pointgoal_with_gps_compass"}
    for k, (shape, dtype) in te.observation_shapes.items():
        assert shape == spaces[k].shape and str(dtype).split(".")[-1] == str(spaces[k].dtype), k
    js, jobs = je.reset(seed=0)
    ts, tobs = te.reset_fn()
    assert {k: tuple(v.shape[1:]) for k, v in tobs.items()} == {k: s for k, (s, _) in te.observation_shapes.items()}
    acts = np.array([[1, 2], [1, 1], [3, 1], [0, 1]], np.int32)
    for k in range(5):
        for name in ("pos", "yaw"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=ATOL,
                                       err_msg=f"{name}@{k}")
        np.testing.assert_allclose(tobs["pointgoal_with_gps_compass"].numpy(),
                                   np.asarray(jobs["pointgoal_with_gps_compass"]), atol=ATOL, err_msg=f"goal@{k}")
        assert np.array_equal(ts.ep_idx.numpy(), np.asarray(js.ep_idx))
        if k == 4:
            break
        js, jobs, jr, jd, _ = je.step(js, jnp.asarray(acts[k]))
        ts, tobs, tr, td, _ = te.step_fn(ts, torch.as_tensor(acts[k]))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, err_msg=f"reward@{k}")
        assert np.array_equal(td.numpy(), np.asarray(jd)), k
    assert td.any()  # env 0 called stop


# -- rearrangement env arguments -------------------------------------------------


def _recorded(monkeypatch, module, cons, cfg, **kw):
    calls = []
    monkeypatch.setattr(module, "make_rearrange_env", lambda **k: calls.append(k))
    cons.rearrange_env_from_config(cfg, **kw)
    (got,) = calls
    robot = types.SimpleNamespace(n_joints=ROBOTS[got["robot"]].arm_joints)
    if got["action_specs"] is not None:
        got["action_specs"] = [(type(s).__name__, s.name, s.dims(robot)) for s in got["action_specs"]]
    return got


@pytest.mark.parametrize("root,declared", [(r, None) for r in REARRANGE_ROOTS] + [
    ("pick_procgen", d) for d in DECLARED])
def test_rearrange_env_arguments_match(monkeypatch, root, declared):
    jcfg, tcfg = _both(f"benchmark/rearrange/{root}.yaml", DECLARED.get(declared, ()))
    want = _recorded(monkeypatch, jgen, jcons, jcfg, num_envs=8)
    got = _recorded(monkeypatch, tgen, tcons, tcfg, num_envs=8, device="cpu")
    assert got.pop("device") == "cpu"
    assert got.pop("rows") == slice(None)  # all envs: no process group
    assert got == want
    if declared:
        assert any(want[k] is not None for k in ("sensor_keys", "measure_keys", "action_specs"))


# -- what raises ---------------------------------------------------------------


@pytest.mark.parametrize("path,overrides", [
    ("benchmark/rearrange/pick_procgen.yaml", ["habitat.task.lab_sensors.x.type=NoSuchSensor"]),
    ("benchmark/rearrange/pick_procgen.yaml", ["habitat.task.measurements.x.type=NoSuchMeasure"]),
    ("benchmark/rearrange/pick_procgen.yaml", ["habitat.task.actions.x.type=NoSuchAction"]),
    ("benchmark/nav/pointnav/pointnav_procgen.yaml", ["habitat.task.measurements.x.type=NoSuchMeasure"]),
])
def test_unknown_types_raise_key_error(path, overrides):
    jcfg, tcfg = _both(path, overrides + NAV_32)
    with pytest.raises(KeyError) as want:
        jcons.env_from_config(jcfg, num_envs=2)
    with pytest.raises(KeyError) as got:
        tcons.env_from_config(tcfg, num_envs=2, device="cpu")
    assert str(got.value).split(". Available")[0] == str(want.value).split(". Available")[0]


@pytest.mark.parametrize("overrides,match", [
    (["habitat.task.lab_sensors.x.type=AreAgentsWithinThreshold"], "declared sensors"),
    (["habitat.task.measurements.x.type=PlaceSuccess"], "declared measures"),
])
def test_unsupported_types_raise_value_error(overrides, match):
    cfg = get_config("benchmark/rearrange/pick_procgen.yaml", overrides + [
        "habitat.dataset.procedural.num_scenes=1", "habitat.dataset.procedural.episodes_per_scene=2",
        "habitat.simulator.tpu.dynamics=kinematic"])
    with pytest.raises(ValueError, match=match):
        tcons.env_from_config(cfg, num_envs=2, device="cpu")


def test_spec_checks_read_the_env_capabilities():
    import habitat_torch.tasks.rearrange.sensors  # noqa: F401  (registrations)
    from habitat_torch.core.registry import registry

    env = tcons.env_from_config(_small_pick(), device="cpu")
    assert env.capabilities == ("pick", "discrete", "kinematic")
    registry.get_measure("RearrangePickSuccess")().check(env)
    registry.get_sensor("JointSensor")().check(env)
    for name in ("PlaceSuccess", "ArtObjState", "NavToObjSuccess"):
        with pytest.raises(ValueError, match=name):
            registry.get_measure(name)().check(env)


def _small_pick(extra=()):
    return get_config("benchmark/rearrange/pick_procgen.yaml", [
        "habitat.dataset.procedural.num_scenes=1", "habitat.dataset.procedural.episodes_per_scene=2",
        "habitat.simulator.tpu.dynamics=kinematic", "habitat_baselines.num_environments=2", *extra])


ARM_PICK = ["habitat.task.actions.arm_action.type=ArmAction", "habitat.task.actions.base_velocity.type=BaseVelAction"]


@pytest.mark.parametrize("case", ["gym_env", "gym_registry_env", "remote_evaluate", "eval_video"])
def test_unported_raise_not_implemented(case, tmp_path):
    if case in ("gym_env", "gym_registry_env"):
        # the gym wrappers wait for gym/ and core/spaces.py (gymnasium)
        from habitat_torch.core.environments import get_env_class

        name = "GymHabitatEnv" if case == "gym_env" else "GymRegistryEnv"
        call, match = lambda: get_env_class(name)(None), "core/spaces.py"
    elif case == "remote_evaluate":
        # the evalai protocol waits for core/evalai_remote.py (grpc)
        from habitat_torch.core.benchmark import Benchmark

        call, match = lambda: Benchmark(eval_remote=True).evaluate(None), "evalai_remote.py"
    else:
        # eval videos are ported; of their helpers only the text overlay
        # waits, for a port of OpenCV's Hershey font
        from habitat_torch.utils.visualizations.utils import append_text_to_image

        call, match = lambda: append_text_to_image(np.zeros((8, 8, 3), np.uint8), "text"), "cv2"
    with pytest.raises(NotImplementedError, match=match):
        call()


# -- ObjectNav, ImageNav and the Gaussian policy from config -------------------


def test_objectnav_and_imagenav_policies_from_config():
    """The policy each package's ``policy_from_config`` builds for the two
    YAMLs (the JAX one with its policy settings from the example
    experiment): ObjectNav's keeps goal_fc_objectgoal and objectgoal_embed;
    ImageNav's feeds the goal image to a second encoder, where the JAX
    package's passes "imagegoal" into goal_keys and its net fails to
    initialise (ROADMAP Queue 3)."""
    from tests.test_torch_nav_tasks import IMAGENAV_32, OBJECTNAV_32

    hb = get_config("pointnav/ppo_pointnav_example.yaml").habitat_baselines
    for path, ov in (("benchmark/nav/objectnav/objectnav_procgen.yaml", OBJECTNAV_32),
                     ("benchmark/nav/imagenav/imagenav_procgen.yaml", IMAGENAV_32)):
        cfg = get_config(path, ov)
        with read_write(cfg):
            cfg["habitat_baselines"] = hb
        env = tcons.env_from_config(cfg, num_envs=2, device="cpu")
        pol = tcons.policy_from_config(cfg, env)
        net = pol.net
        names = {k.split(".")[1] for k in pol.state_dict() if k.startswith("net.")}
        if "objectnav" in path:
            assert net.goal_keys == ("objectgoal",) and net.objectgoal_embed is not None
            assert net.state_keys == ("gps", "compass") and net.encoder.visual_inputs == ("rgb", "depth")
            assert pol.action_head.out_features == 6 and not net.image_goal_keys
        else:
            assert net.goal_keys == () and net.image_goal_keys == ("imagegoal",)
            assert {"goal_encoder", "goal_visual_fc"} <= names and net.encoder.visual_inputs == ("rgb",)
        st, obs = env.reset_fn()
        with torch.no_grad():
            logits, value, _ = pol(obs, pol.initial_hidden(2), torch.zeros(2, dtype=torch.int32), torch.zeros(2))
        assert logits.shape == (2, env.num_actions) and torch.isfinite(value).all()


def test_gaussian_policy_from_config():
    """pick_procgen.yaml with ArmAction and BaseVelAction: a 10-wide
    continuous action space gets GaussianResNetPolicy (visual: the head
    cameras), as the JAX package builds it; blind with
    force_blind_policy; PPOTrainer trains it with the Gaussian learner."""
    from habitat_torch.models.policy import GaussianActorCritic

    cfg = _small_pick(ARM_PICK + ["habitat_baselines.rl.ddppo.backbone=resnet9",
                                  "habitat_baselines.rl.ppo.hidden_size=64"])
    env = tcons.env_from_config(cfg, device="cpu")
    assert env.action_dim == 7 + 1 + 2 and not hasattr(env, "num_actions")
    pol = tcons.policy_from_config(cfg, env)
    assert isinstance(pol, GaussianActorCritic) and pol.num_outputs == 10 and pol.net.encoder is not None
    assert pol.net.hidden_size == 64 and pol.net.encoder.output_dim > 0
    with read_write(cfg):
        cfg.habitat_baselines["force_blind_policy"] = True
    blind = tcons.policy_from_config(cfg, env)
    assert blind.net.encoder is None and "net.visual_fc.weight" not in blind.state_dict()
    # the trainer picks the Gaussian learner from the action space
    from habitat_torch.baselines.ppo import PPOConfig
    from habitat_torch.baselines.trainer import PPOTrainer

    assert PPOTrainer(env, blind, PPOConfig(num_steps=2, num_mini_batch=1)).learner.action_type == "gaussian"


# -- run.main --------------------------------------------------------------------


def test_run_main_trains_then_evaluates(tmp_path, monkeypatch):
    args = ["--config-name=pointnav/ppo_pointnav_example", "--device", "cpu", *OVERRIDES,
            f"habitat_baselines.checkpoint_folder={tmp_path}/ckpt", f"habitat_baselines.tensorboard_dir={tmp_path}/tb",
            "habitat_baselines.total_num_steps=64",  # 2 updates of 4 envs x 8 steps
            "habitat_baselines.num_checkpoints=2", "habitat_baselines.test_episode_count=8"]
    trainers = []
    build = tcons.trainer_from_config
    monkeypatch.setattr(tcons, "trainer_from_config", lambda *a, **k: trainers.append(build(*a, **k)) or trainers[-1])
    metrics = run.main(args)
    trained = trainers[0]
    assert trained.num_updates_done == 2 and np.isfinite(metrics["losses/learner_loss"])
    assert {"latest", "ckpt.0", "ckpt.1"} <= set(os.listdir(tmp_path / "ckpt"))
    final = {k: v.clone() for k, v in trained.policy.state_dict().items()}
    # each update's metrics in the TensorBoard events file, at the step count
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(str(tmp_path / "tb")).Reload()
    loss = events.Scalars("losses/learner_loss")
    assert [e.step for e in loss] == [32, 64]
    assert loss[-1].value == pytest.approx(metrics["losses/learner_loss"], rel=1e-6)

    metrics = run.main(args + ["--run-type", "eval"])
    evaluated = trainers[1].policy.state_dict()
    assert all(torch.equal(final[k], evaluated[k]) for k in final)
    assert metrics["num_episodes"] == (8 // 4) * 4 and 0.0 <= metrics["success"] <= 1.0

    # the settings the JAX trainer takes from the same config
    jtrainer = jcons.trainer_from_config(jax_get_config("pointnav/ppo_pointnav_example.yaml", args[3:]))
    for ours, theirs in ((trained.ppo_cfg, jtrainer.ppo_cfg), (trained.run_cfg, jtrainer.run_cfg)):
        shared = {f.name for f in dataclasses.fields(ours)} & {f.name for f in dataclasses.fields(theirs)}
        assert len(shared) >= 9
        assert {k: getattr(ours, k) for k in shared} == {k: getattr(theirs, k) for k in shared}


# -- the DD-PPO recipe ----------------------------------------------------------

DDPPO_SMALL = ["habitat_baselines.num_environments=4", "habitat_baselines.rl.ppo.num_steps=4",
               "habitat_baselines.tensorboard_dir=", *NAV_32]


@pytest.mark.parametrize("variant", ["recipe", "gru", "ver", "adaptive_entropy"])
def test_ddppo_pointnav_builds(variant, tmp_path):
    """``pointnav/ddppo_pointnav.yaml`` (at 32x32 and N=4): the ``ddppo``
    trainer (``use_mesh``) with the resnet50 encoder (16 bottleneck blocks,
    base 32, 16 groups, 1024 final channels) and an LSTM-512 of 2 layers, its PPO
    settings those of the JAX trainer from the same config; with
    ``rnn_type=GRU`` a GRU of 2 layers and (N, 2, 1, 512) hidden states;
    with ``trainer_name=ver`` the ``VERTrainer``. The arm-Pick config with
    ``use_adaptive_entropy_pen`` and ``entropy_target_factor`` builds the
    Gaussian learner with the JAX threshold."""
    from habitat_torch.baselines.trainer import PPOTrainer, VERTrainer
    from habitat_torch.models.resnet import Bottleneck

    if variant == "adaptive_entropy":
        cfg = _small_pick(ARM_PICK + ["habitat_baselines.rl.ddppo.backbone=resnet9",
                                      "habitat_baselines.rl.ppo.hidden_size=64"])
        with read_write(cfg):
            cfg["habitat_baselines"] = get_config("pointnav/ppo_pointnav_example.yaml", [
                "habitat_baselines.rl.ppo.use_adaptive_entropy_pen=True",
                "habitat_baselines.rl.ppo.entropy_target_factor=0.5",
                "habitat_baselines.rl.ppo.num_mini_batch=1"]).habitat_baselines
        trainer = tcons.trainer_from_config(cfg, device="cpu")
        assert trainer.learner.adaptive_ent and trainer.learner.ent_threshold == -0.5 * 10
        assert trainer.ppo_cfg.entropy_target_factor == 0.5
        return
    extra = {"recipe": [], "gru": ["habitat_baselines.rl.ddppo.rnn_type=GRU"],
             "ver": ["habitat_baselines.trainer_name=ver"]}[variant]
    args = [*DDPPO_SMALL, f"habitat_baselines.checkpoint_folder={tmp_path}", *extra]
    trainer = tcons.trainer_from_config(get_config("pointnav/ddppo_pointnav.yaml", args), device="cpu")
    # use_mesh as the JAX package sets it: for the ddppo name
    assert type(trainer) is (VERTrainer if variant == "ver" else PPOTrainer)
    assert trainer.run_cfg.use_mesh == (variant != "ver")
    net = trainer.policy.net
    blocks = net.encoder.backbone.blocks
    assert len(blocks) == 16 and all(isinstance(b, Bottleneck) for b in blocks)
    assert net.encoder.backbone.out_channels == 32 * 8 * 4 and net.encoder.backbone.stem.weight.shape[0] == 32
    assert blocks[0].norm1.num_groups == 16
    assert net.hidden_size == 512 and net.num_recurrent_layers == 2 and len(net.rnn.cells) == 2
    assert net.rnn_type == ("GRU" if variant == "gru" else "LSTM")
    assert tuple(trainer.policy.initial_hidden(4).shape) == (4, 2, 1 if variant == "gru" else 2, 512)
    if variant == "recipe":
        jtrainer = jcons.trainer_from_config(jax_get_config("pointnav/ddppo_pointnav.yaml", args))
        assert jtrainer.policy.net.backbone == "resnet50" and jtrainer.policy.net.num_recurrent_layers == 2
        ours, theirs = trainer.ppo_cfg, jtrainer.ppo_cfg
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        shared = {f.name for f in dataclasses.fields(trainer.run_cfg)} & {f.name for f in
                                                                         dataclasses.fields(jtrainer.run_cfg)}
        assert {k: getattr(trainer.run_cfg, k) for k in shared} == {k: getattr(jtrainer.run_cfg, k) for k in shared}


def test_run_main_trains_the_ddppo_recipe(tmp_path):
    """``run.main`` on ``ddppo_pointnav.yaml`` in one process (no group):
    one update of resnet50 + LSTM-512x2 at 32x32, N=4, T=4, finite losses,
    ``latest`` written."""
    args = ["--config-name=pointnav/ddppo_pointnav.yaml", "--device", "cpu", *DDPPO_SMALL,
            f"habitat_baselines.checkpoint_folder={tmp_path}", "habitat_baselines.total_num_steps=16"]
    metrics = run.main(args)
    assert np.isfinite(metrics["losses/learner_loss"]) and np.isfinite(metrics["grad_norm"])
    assert "latest" in os.listdir(tmp_path)
