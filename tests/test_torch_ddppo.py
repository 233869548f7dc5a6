"""DD-PPO in habitat_torch on the CPU: ``parallel/distributed.py`` and the
learner and trainer under a gloo process group of 2 ranks, against the
one-process port and habitat_tpu's update.

Each rank is a subprocess (``tests/torch_ddppo_worker.py``, no JAX) that
meets the others through a file store in ``tmp_path`` (no TCP port, so the
tier-1 run's workers cannot collide) and whose collectives time out after
120 s; the test waits at most ``WAIT_S`` for them. N=4 envs (2 per rank),
T=4, 32x32 depth + pointgoal, the blind net or resnet9 over depth, LSTM-64,
float32, 2 epochs of 2 minibatches.

- The update on one rollout batch (normalized advantage), with the JAX
  package's epoch permutations passed in: the ranks bit-equal; 2 ranks
  against 1 at rtol 2e-4, atol 2e-5 on every element (JAX's own
  sharded-vs-single tolerance, tests/test_ppo.py:129), for the blind and
  the resnet9 net; the blind net's also against JAX's ``_update`` (the
  resnet update is held to JAX's in ``tests/test_torch_ppo.py``).
- One ``train_step`` from ``init`` (rollout draws at the global shape,
  then the update): 2 ranks against 1 likewise, the rollout's final
  positions and the generator equal.
- A learner handed an env of all N envs under the group raises: each rank
  must be built from its own ``distributed.env_rows(N)``.
- A 2-rank trainer (blind net) preempted by SIGUSR2 on rank 1 only after
  update 2 of 3: both ranks stop there, rank 0 writes ``.resume_state`` in
  the one-process layout, and one process resumes it to the uninterrupted
  one-process run's parameters at rtol 2e-4, atol 2e-5.
- A rank that raises drops the group: the other fails at its next
  collective, well before the timeout.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.baselines.ppo import PPOConfig as JaxPPOConfig
from habitat_tpu.baselines.ppo import PPOLearner as JaxPPOLearner
from habitat_tpu.baselines.ppo import TrainState
from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy

from habitat_torch.models.convert import params_from_jax
from habitat_torch.parallel import distributed
from tests import torch_ddppo_worker as W
from tests.test_torch_models import _perturb_affine
from tests.test_torch_ppo import _check_update, _flat, _jax_batch, _torch_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_ddppo_worker.py")
RTOL, ATOL = 2e-4, 2e-5
WAIT_S = 300


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run_ranks(folder, mode, world=2):
    """Run ``mode`` on ``world`` ranks; returns [(returncode, stderr)]."""
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(folder), str(r), str(world)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WAIT_S)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            p.kill()
    return out


def _close(got, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")


def _equal(a, b, what):
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


# ---- the process group's helpers, without a group ---------------------------------


def test_no_group_is_one_rank():
    assert distributed.world() == distributed.World(0, 1, False)
    assert distributed.rank0_only() and distributed.env_rows(6) == distributed.EnvRows(0, 6, 6)
    t = torch.arange(3.0)
    distributed.all_reduce_sum_([t])
    assert torch.equal(t, torch.arange(3.0)) and distributed.gather_rows(t) is t
    assert distributed.any_rank(True, "cpu") and not distributed.any_rank(False, "cpu")


@pytest.mark.parametrize("variables,want", [
    ({}, None),
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h", "MASTER_PORT": "1"},
     dict(init_method="env://", world_size=4, rank=1, local_rank=1)),
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1"},
     dict(init_method="tcp://127.0.0.1:8738", world_size=8, rank=5, local_rank=1)),
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, None),
], ids=["plain", "torchrun", "slurm", "slurm-one-task"])
def test_group_comes_from_the_launcher(monkeypatch, variables, want):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID",
              "SLURM_LOCALID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in variables.items():
        monkeypatch.setenv(k, v)
    assert distributed._from_environment() == want
    if want is None:  # a plain process forms no group
        assert distributed.init_distributed(device="cpu") == torch.device("cpu")
        assert not distributed.world().active


# ---- the update and the train step on 2 ranks --------------------------------------


def _batch(seed):
    """A global (T, N) rollout batch with episode ends, h0, bootstrap value."""
    rng = np.random.default_rng(seed)
    T, N = W.T, W.N
    dones = np.zeros((T, N), np.float32)
    dones[1, 0] = dones[2, 3] = 1.0
    actions = rng.integers(0, W.A, (T, N)).astype(np.int32)
    b = dict(
        obs=dict(
            depth=torch.from_numpy(rng.uniform(0, 1, (T, N, W.HW, W.HW, 1)).astype(np.float32)).to(
                torch.bfloat16).float().numpy(),
            pointgoal_with_gps_compass=np.stack(
                [rng.uniform(0.5, 8, (T, N)), rng.uniform(-np.pi, np.pi, (T, N))], -1).astype(np.float32),
        ),
        actions=actions,
        log_probs=(np.log(0.25) + rng.normal(0, 0.05, (T, N))).astype(np.float32),
        values=rng.normal(0, 1, (T, N)).astype(np.float32),
        rewards=rng.normal(0, 0.3, (T, N)).astype(np.float32),
        dones=dones,
        masks=np.concatenate([rng.integers(0, 2, (1, N)), 1.0 - dones[:-1]]).astype(np.float32),
        prev_actions=np.concatenate([rng.integers(0, W.A, (1, N)), actions[:-1]]).astype(np.int32),
    )
    h0 = rng.normal(0, 0.5, (N, 1, 2, W.HIDDEN)).astype(np.float32)
    return b, h0, rng.normal(0, 1, N).astype(np.float32)


def _jax_update(b, h0, lv):
    """The perturbed JAX init of the blind policy, its update on the batch,
    and JAX's epoch permutations."""
    jpol = jax_policy(W.A, backbone="resnet9", hidden_size=W.HIDDEN, has_visual=False)
    obs0 = {k: jnp.asarray(v[0]) for k, v in b["obs"].items() if k != "depth"}
    key = jax.random.PRNGKey(0)
    params = jax.jit(jpol.init)(key, obs0, jnp.asarray(h0), jnp.zeros(W.N, jnp.int32), jnp.zeros(W.N))
    params = {"params": _perturb_affine(params["params"], np.random.default_rng(1))}
    jl = JaxPPOLearner(SimpleNamespace(num_envs=W.N), jpol, JaxPPOConfig(**W.PPO))
    ts = TrainState(params=params, opt_state=jl.optimizer.init(params), env_state=None, obs=None, hidden=None,
                    prev_action=None, not_done=None, key=key, update_idx=jnp.int32(0), ep_return_acc=None,
                    ep_len_acc=None, log_alpha=jnp.float32(np.log(0.01)))
    new_ts, jm = jax.jit(jl._update)(ts, _jax_batch(b), jnp.asarray(lv), jnp.asarray(h0))
    # fold_in(fold_in(key, update_idx), epoch), as JAX's update draws them
    perms = np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(jax.random.fold_in(key, 0), e), W.N))
                      for e in range(W.PPO["ppo_epoch"])])
    return (params_from_jax(_flat(params["params"])), params_from_jax(_flat(new_ts.params["params"])),
            {k: float(v) for k, v in jm.items()}, perms)


@pytest.fixture(scope="module")
def two_rank_step(tmp_path_factory):
    """For the blind and the resnet9 policy: the one-process port's and the
    2-rank port's update on one batch, JAX's for the blind one (the resnet9
    update is held to JAX's in tests/test_torch_ppo.py); the 2-rank and
    one-process train steps. {(kind, what): ...}"""
    folder = tmp_path_factory.mktemp("ddppo_step")
    b, h0, lv = _batch(0)
    tb = _torch_batch(b)
    sd, jax_p, jax_m, perms = _jax_update(b, h0, lv)
    out = {("blind", "start"): sd, ("blind", "jax"): (jax_p, jax_m),
           ("visual", "start"): W.params(W.make_policy(visual=True))}
    for kind in ("blind", "visual"):
        torch.save(out[kind, "start"], folder / f"weights.{kind}.pt")
    torch.save({"obs": tb.obs, **{k: v for k, v in tb._asdict().items() if k != "obs"}, "h0": torch.from_numpy(h0),
                "last_value": torch.from_numpy(lv), "perms": torch.from_numpy(perms).long()}, folder / "batch.pt")
    t0 = time.perf_counter()
    ranks = _run_ranks(folder, "step")
    assert all(rc == 0 for rc, _ in ranks), [err[-3000:] for _, err in ranks]
    print(f"2-rank step workers: {time.perf_counter() - t0:.1f} s")
    out["two"] = [torch.load(folder / f"step.{r}.pt", weights_only=True) for r in range(2)]
    env = W.make_env()
    batch = torch.load(folder / "batch.pt", weights_only=True)
    for kind in ("blind", "visual"):
        out[kind, "one_update"] = W.one_step(env, out[kind, "start"], kind == "visual", batch)[:2]
        out[kind, "one_train_step"] = W.one_step(env, out[kind, "start"], kind == "visual")
    return out


def _held_to_one_rank(got, want):
    """Metrics and every parameter element at RTOL / ATOL."""
    (p, m), (p1, m1) = got, want
    for k, v in m1.items():
        assert m[k] == pytest.approx(v, rel=RTOL, abs=ATOL), k
    _close(p, p1, "2 ranks vs 1")


@pytest.mark.parametrize("kind", ["blind", "visual"])
def test_two_rank_update_matches_one_rank_and_jax(two_rank_step, kind):
    out, two = two_rank_step, two_rank_step["two"]
    _equal(two[0][kind, "update"][0], two[1][kind, "update"][0], "rank 0 vs rank 1")
    _held_to_one_rank(two[0][kind, "update"], out[kind, "one_update"])
    if kind == "blind":
        jax_p, jax_m = out[kind, "jax"]
        for got_p, got_m in (out[kind, "one_update"], two[0][kind, "update"]):
            _close(got_p, jax_p, "port vs JAX")
            _check_update(out[kind, "start"], got_p, jax_p, got_m, jax_m)


@pytest.mark.parametrize("kind", ["blind", "visual"])
def test_two_rank_train_step_matches_one_rank(two_rank_step, kind):
    out, two = two_rank_step, two_rank_step["two"]
    _equal(two[0][kind, "train_step"][0], two[1][kind, "train_step"][0], "rank 0 vs rank 1")
    p1, m1, rs = out[kind, "one_train_step"]
    _held_to_one_rank(two[0][kind, "train_step"], (p1, m1))
    assert m1["done_count"] > 0  # episodes of 3 steps end inside the rollout
    pos, gen = two[0][kind, "rollout"]
    assert torch.equal(gen, rs.generator.get_state())
    np.testing.assert_allclose(pos.numpy(), rs.env_state.pos.numpy(), atol=1e-6)


def test_learner_takes_only_its_own_rows(two_rank_step):
    assert all(t["all_rows_raise"] for t in two_rank_step["two"])  # under the group
    env = SimpleNamespace(num_envs=2)
    with pytest.raises(ValueError, match="do not match"):
        W.PPOLearner(env, W.make_policy(), W.PPOConfig(**W.PPO), rows=distributed.EnvRows(0, 4, 4))


# ---- preemption and resume across world sizes; a failing rank -------------------------


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    trainer = W.make_trainer(tmp_path_factory.mktemp("ddppo_uninterrupted"), 3)
    trainer.train(seed=0, resume=False)
    assert trainer.num_updates_done == 3
    return trainer


def test_two_rank_run_preempted_resumes_at_one_rank(tmp_path, uninterrupted):
    ranks = _run_ranks(tmp_path, "train")
    assert all(rc == 0 for rc, _ in ranks), [err[-3000:] for _, err in ranks]
    # rank 1 alone was signalled; both stopped after update 2
    assert [torch.load(tmp_path / f"train.{r}.pt")["updates"] for r in range(2)] == [2, 2]
    saved = torch.load(tmp_path / "ckpt" / ".resume_state", weights_only=True)["rollout_state"]
    assert saved["not_done"].shape == (W.N,) and saved["hidden"].shape[0] == W.N  # the one-process layout

    resumed = W.make_trainer(tmp_path / "ckpt", 3, weights_seed=1)
    assert resumed.resume_state_exists()
    resumed.train(seed=0, resume=True)
    assert resumed.num_updates_done == 3 and resumed.num_steps_done == 3 * W.STEPS_PER_UPDATE
    _close(W.params(resumed.policy), W.params(uninterrupted.policy), "resumed at 1 rank vs uninterrupted")
    assert torch.equal(resumed.final_state.generator.get_state(), uninterrupted.final_state.generator.get_state())


def test_a_failing_rank_does_not_hang_the_other(tmp_path):
    t0 = time.perf_counter()
    ranks = _run_ranks(tmp_path, "fail")
    waited = time.perf_counter() - t0
    assert ranks[1][0] != 0 and "rank 1 fails in its env step" in ranks[1][1]
    assert ranks[0][0] != 0, ranks[0][1][-2000:]
    assert waited < W.TIMEOUT_S, waited
