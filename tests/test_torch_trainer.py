"""habitat_torch's single-card ``PPOTrainer`` on the CPU with a tiny env
(N=4, T=4, 32x32, resnet9 + LSTM-64, episodes of 3 steps):

- a run preempted by SIGUSR2 after update 2 writes ``ckpt.0``, ``ckpt.1``,
  ``latest`` and ``.resume_state``; a fresh trainer, with other starting
  weights, resumes from ``.resume_state`` and reaches after update 3 the
  same parameters, bit for bit, as an uninterrupted run;
- the windowed metric keys are those of habitat_tpu's ``PPOTrainer``, read
  from its own loop with its train step traced for its metric names only.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from habitat_tpu.baselines.ppo import PPOConfig as JaxPPOConfig
from habitat_tpu.baselines.trainer import PPOTrainer as JaxPPOTrainer
from habitat_tpu.baselines.trainer import TrainerConfig as JaxTrainerConfig
from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy

from habitat_torch.baselines.ppo import PPOConfig
from habitat_torch.baselines.trainer import PPOTrainer, TrainerConfig
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.core.registry import registry
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.models.policy import make_pointnav_resnet_policy
from tests.torch_jax_native import _jax_native  # noqa: F401

N, T, HW, MAX_STEPS = 4, 4, 32, 3
STEPS_PER_UPDATE = N * T
SENSORS = (
    ("HabitatSimDepthSensor", {"height": HW, "width": HW}),
    ("HabitatSimRGBSensor", {"height": HW, "width": HW}),
    ("PointGoalWithGPSCompassSensor", None),
)
PPO = dict(num_steps=T, ppo_epoch=2, num_mini_batch=2, lr=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores:
    PyTorch's CPU kernels, one thread per core in each of them, then spend
    their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trainer(folder, updates, weights_seed=0, **run):
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)
    env = make_nav_env(
        scenes, episodes, num_envs=N, device="cpu", precomputed_fields=fields,
        max_episode_steps=MAX_STEPS, sensor_specs=SENSORS,
    )
    torch.manual_seed(weights_seed)
    policy = make_pointnav_resnet_policy(4, input_hw=(HW, HW), backbone="resnet9", hidden_size=64, device="cpu")
    cfg = TrainerConfig(total_num_steps=updates * STEPS_PER_UPDATE, checkpoint_folder=str(folder), verbose=False, **run)
    return PPOTrainer(env, policy, PPOConfig(**PPO), cfg)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    trainer = _trainer(tmp_path_factory.mktemp("uninterrupted"), 3, checkpoint_interval=100)
    metrics = trainer.train(seed=0, resume=False)
    assert trainer.num_updates_done == 3
    return trainer, metrics


def test_preempted_run_resumes_to_the_same_parameters(tmp_path, uninterrupted):
    ref, _ = uninterrupted
    trainer = _trainer(tmp_path, 3, checkpoint_interval=1)
    step = trainer.learner.train_step

    def preempt_after_two(rs):
        rs, metrics = step(rs)
        if trainer.num_updates_done == 1:  # the update being finished is the second
            os.kill(os.getpid(), signal.SIGUSR2)
        return rs, metrics

    trainer.learner.train_step = preempt_after_two
    previous = signal.getsignal(signal.SIGUSR2)
    try:
        trainer.train(seed=0, resume=False)
    finally:
        signal.signal(signal.SIGUSR2, previous)
    assert trainer.num_updates_done == 2
    files = set(os.listdir(tmp_path))
    for name in ("ckpt.0", "ckpt.1", "latest", ".resume_state"):
        assert {name, f"{name}.meta.json"} <= files
    assert "ckpt.2" not in files

    resumed = _trainer(tmp_path, 3, weights_seed=1, checkpoint_interval=100)
    assert resumed.resume_state_exists()
    resumed.train(seed=0, resume=True)
    assert resumed.num_updates_done == 3 and resumed.num_steps_done == 3 * STEPS_PER_UPDATE
    want = ref.policy.state_dict()
    for k, v in resumed.policy.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(resumed.final_state.generator.get_state(), ref.final_state.generator.get_state())
    assert torch.equal(resumed.final_state.env_state.pos, ref.final_state.env_state.pos)


def test_windowed_metric_keys_match_jax(uninterrupted):
    _, metrics = uninterrupted
    assert all(np.isfinite(v) for v in metrics.values())
    sj, ej, fj = jax_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)
    env = jax_make_nav_env(sj, ej, num_envs=N, precomputed_fields=fj, max_episode_steps=MAX_STEPS)
    jtrainer = JaxPPOTrainer(
        env, jax_policy(4, backbone="resnet9", hidden_size=64, has_visual=False), JaxPPOConfig(**PPO),
        JaxTrainerConfig(total_num_steps=STEPS_PER_UPDATE, use_mesh=False, checkpoint_interval=100, verbose=False),
    )
    # the JAX loop as it runs, on the names of its train step's metrics
    ts = jax.eval_shape(jtrainer.learner.init_fn, jax.random.PRNGKey(0), jtrainer._env_data)
    names = jax.eval_shape(jtrainer.learner.train_step, ts, jtrainer._env_data)[1]
    jtrainer._init = lambda key, data: ts
    jtrainer._train_step = lambda ts, data: (ts, {k: np.float32(1.0) for k in names})
    want = jtrainer.train(seed=0, resume=False)
    assert set(metrics) == set(want)
    assert {"reward", "episode_length", "success", "spl", "distance_to_goal"} <= set(metrics)


def test_checkpoint_schedule(tmp_path):
    trainer = _trainer(tmp_path, 10)
    assert trainer.should_checkpoint()  # checkpoint_interval=-1: the first at 0% done
    trainer._ckpt_count, trainer.num_steps_done = 1, 0
    assert not trainer.should_checkpoint()
    trainer.num_steps_done = STEPS_PER_UPDATE  # 10% done, num_checkpoints=10
    assert trainer.should_checkpoint() and trainer.percent_done() == pytest.approx(0.1)


def test_trainer_names_and_use_mesh(tmp_path):
    """``ddppo`` names the PPO trainer and ``ver`` its subclass, as in the
    JAX package; ``use_mesh`` defaults to True as there, and either value
    trains in one process (no group: one rank)."""
    from habitat_torch.baselines.trainer import VERTrainer

    assert registry.get_trainer("ddppo") is PPOTrainer and registry.get_trainer("ppo") is PPOTrainer
    assert issubclass(registry.get_trainer("ver"), PPOTrainer) and registry.get_trainer("ver") is VERTrainer
    assert TrainerConfig().use_mesh and JaxTrainerConfig().use_mesh
    assert TrainerConfig(tensorboard_dir="tb").tensorboard_dir == "tb"  # writes through utils/tb.py
    trainer = _trainer(tmp_path, 1, use_mesh=False)
    trainer.train(seed=0, resume=False)
    assert trainer.num_updates_done == 1 and trainer.learner.n_global == N
