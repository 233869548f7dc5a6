"""One rank of the DD-PPO runs of ``tests/test_torch_ddppo.py`` (imports no
JAX). Run from the repository root:

    python tests/torch_ddppo_worker.py MODE FOLDER RANK WORLD

It joins a gloo group of WORLD ranks through a file store in FOLDER, then:

- ``step``: a learner handed an env of all N envs under the group must
  raise; then for the blind and the visual policy, (1) the update on
  FOLDER/batch.pt (a global (T, N) rollout batch, its h0 and bootstrap
  value) with the epoch permutations given there, on this rank's rows,
  from the weights FOLDER/weights.{blind,visual}.pt; (2) from the same
  weights, ``init`` and one ``train_step`` on the env. Writes
  FOLDER/step.{RANK}.pt: each update's parameters and metrics.
- ``train``: ``PPOTrainer`` for 3 updates; rank 1 gets SIGUSR2 after the
  second, so every rank stops there and rank 0 writes ``.resume_state``
  (the ranks' env rows gathered) into FOLDER/ckpt. Writes
  FOLDER/train.{RANK}.pt: the updates done.
- ``fail``: ``PPOTrainer`` whose rank 1 raises in its first rollout; rank 0
  must fail too (its collective loses the group), not wait.
"""

import os
import signal
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from habitat_torch.baselines.ppo import PPOConfig, PPOLearner, RolloutBatch  # noqa: E402
from habitat_torch.baselines.trainer import PPOTrainer, TrainerConfig  # noqa: E402
from habitat_torch.core.env_factory import make_nav_env  # noqa: E402
from habitat_torch.datasets.pointnav import make_procedural_pointnav  # noqa: E402
from habitat_torch.models.policy import make_pointnav_resnet_policy  # noqa: E402
from habitat_torch.parallel import distributed  # noqa: E402

N, T, HW, A, HIDDEN, MAX_STEPS = 4, 4, 32, 4, 64, 3
PPO = dict(num_steps=T, ppo_epoch=2, num_mini_batch=2, use_normalized_advantage=True)
TRAIN_PPO = dict(num_steps=T, ppo_epoch=2, num_mini_batch=2, lr=1e-3)
STEPS_PER_UPDATE = N * T
SENSORS = (("HabitatSimDepthSensor", {"height": HW, "width": HW}), ("PointGoalWithGPSCompassSensor", None))
TIMEOUT_S = 120.0


def make_env():
    """The N envs of the runs; under a group this rank's rows."""
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)
    return make_nav_env(scenes, episodes, num_envs=N, device="cpu", precomputed_fields=fields,
                        max_episode_steps=MAX_STEPS, sensor_specs=SENSORS, rows=distributed.env_rows(N).slice)


def make_policy(state_dict=None, weights_seed=0, visual=False):
    """The blind net, or the resnet9 one over depth, in float32."""
    torch.manual_seed(weights_seed)
    pol = make_pointnav_resnet_policy(A, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                                      hidden_size=HIDDEN, has_visual=visual, dtype=torch.float32, device="cpu")
    if state_dict is not None:
        pol.load_state_dict(state_dict)
    return pol


def make_trainer(folder, updates, weights_seed=0, **run):
    cfg = TrainerConfig(total_num_steps=updates * STEPS_PER_UPDATE, checkpoint_folder=str(folder), verbose=False,
                        checkpoint_interval=100, **run)
    return PPOTrainer(make_env(), make_policy(weights_seed=weights_seed), PPOConfig(**TRAIN_PPO), cfg,
                      rows=distributed.env_rows(N))


def rows_of(b, rows):
    """A global batch dict's rows of the env axis (axis 1; h0 axis 0)."""
    return RolloutBatch(obs={k: v[:, rows] for k, v in b["obs"].items()},
                        **{k: v[:, rows] for k, v in b.items() if k not in ("obs", "h0", "last_value", "perms")})


def params(policy):
    return {k: v.detach().clone() for k, v in policy.state_dict().items()}


def one_step(env, sd, visual, b=None):
    """The update on ``b``'s rows of this rank with its permutations, or
    with ``b`` None ``init`` and one ``train_step``: (parameters, metrics,
    the rollout state or None)."""
    lrn = PPOLearner(env, make_policy(sd, visual=visual), PPOConfig(**PPO), rows=distributed.env_rows(N))
    rs, rows = None, lrn.rows.slice
    if b is None:
        rs, m = lrn.train_step(lrn.init(seed=0))
    else:
        m = lrn.update(torch.Generator().manual_seed(0), rows_of(b, rows), b["last_value"][rows], b["h0"][rows],
                       perms=b["perms"])
    return params(lrn.policy), {k: v.item() for k, v in m.items()}, rs


def step(folder, rank):
    b = torch.load(os.path.join(folder, "batch.pt"), weights_only=True)
    try:  # all N envs on every rank: not this rank's rows
        PPOLearner(SimpleNamespace(num_envs=N), make_policy(), PPOConfig(**PPO))
        out = {"all_rows_raise": False}
    except ValueError:
        out = {"all_rows_raise": True}
    env = make_env()
    for kind in ("blind", "visual"):
        sd = torch.load(os.path.join(folder, f"weights.{kind}.pt"), weights_only=True)
        out[kind, "update"] = one_step(env, sd, kind == "visual", b)[:2]
        p, m, rs = one_step(env, sd, kind == "visual")
        out[kind, "train_step"] = p, m
        out[kind, "rollout"] = distributed.gather_rows(rs.env_state.pos), rs.generator.get_state()
    torch.save(out, os.path.join(folder, f"step.{rank}.pt"))


def train(folder, rank):
    trainer = make_trainer(os.path.join(folder, "ckpt"), 3)
    run_step = trainer.learner.train_step

    def preempt_rank1_after_two(rs):
        rs, metrics = run_step(rs)
        if rank == 1 and trainer.num_updates_done == 1:  # the update being finished is the second
            os.kill(os.getpid(), signal.SIGUSR2)
        return rs, metrics

    trainer.learner.train_step = preempt_rank1_after_two
    trainer.train(seed=0, resume=False)
    torch.save({"updates": trainer.num_updates_done}, os.path.join(folder, f"train.{rank}.pt"))


def fail(folder, rank):
    trainer = make_trainer(os.path.join(folder, "ckpt"), 3)
    if rank == 1:
        def broken(state, actions):
            raise RuntimeError("rank 1 fails in its env step")

        trainer.env.step_fn = broken
    trainer.train(seed=0, resume=False)


if __name__ == "__main__":
    mode, folder, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(2)
    distributed.init_distributed(f"file://{os.path.join(folder, 'store')}", world, rank, device="cpu",
                                 timeout_s=TIMEOUT_S)
    {"step": step, "train": train, "fail": fail}[mode](folder, rank)
