"""habitat_torch's reach task against habitat_tpu's on the CPU.

- ``utils/threefry.py``: ``PRNGKey``, ``fold_in`` and float32 ``uniform``
  bit for bit against ``jax.random`` (JAX 0.9's partitionable Threefry), and
  the reach goal offsets of 4,096 episode indices bit for bit against the
  JAX env's draw, ``uniform(fold_in(PRNGKey(4321), e), (3,), -1, 1) * 0.2``.
- The reach env (tests/test_evaluator.py's configuration, N=4, arm control,
  blind): the goal table against JAX's jitted ``_reach_target`` within 1e-6
  (XLA may fuse its multiply-add), the reset, and 16 random-action steps
  teacher-forced against JAX's jitted step: observations, measures, reward
  and state within 1e-5, discrete fields equal.
- ``evaluate_agent`` with the Gaussian policy (JAX weights converted, greedy
  actions) on that env: the same counted episodes, success, and reward
  within 1e-4.
- ``rearrange_env_from_config`` builds ``RearrangeReachTask-v0`` where the
  JAX package's does: the same task, control, keys, table and order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from habitat_tpu.baselines.evaluator import evaluate_agent as jax_evaluate
from habitat_tpu.models.policy import make_gaussian_resnet_policy as jax_gaussian
from habitat_tpu.models.rnn_state_encoder import initial_hidden_state
from habitat_tpu.tasks.rearrange import generator as jgen

from habitat_torch.baselines.evaluator import evaluate_agent
from habitat_torch.models.convert import params_from_jax
from habitat_torch.models.policy import make_gaussian_resnet_policy, state_keys_of
from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.utils import threefry as tf
from tests.test_torch_rearrange_env import _assert_tables_equal, _compare, to_port_state
from tests.torch_jax_native import _jax_native  # noqa: F401

N = 4
REACH = dict(num_envs=N, task="reach", with_visual=False, control="arm", n_rooms_per_axis=1, n_clutter=0,
             max_episode_steps=20, seed=0)
STEPS = 16
GOAL_ATOL = 1e-6
REWARD_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 4321, 2**31 - 1, -7])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(tf.prng_key(seed), np.asarray(key))
    data = np.array([0, 1, 2, 77, 4095, 2**31 - 1, 2**32 - 1], np.uint32)
    folded = jax.vmap(lambda d: jax.random.fold_in(key, d))(jnp.asarray(data))
    assert np.array_equal(tf.fold_in(tf.prng_key(seed), data), np.asarray(folded))
    for n, lo, hi in ((1, 0.0, 1.0), (3, -1.0, 1.0), (5, -2.0, 3.0), (16, 0.25, 0.5)):
        ref = jax.random.uniform(key, (n,), minval=lo, maxval=hi)
        assert np.array_equal(_bits(tf.uniform(tf.prng_key(seed), n, lo, hi)), _bits(ref)), (n, lo, hi)


def test_reach_goals_bit_for_bit():
    """4,096 episode indices: the offsets equal the JAX env's draw to the bit."""
    E = 4096
    keys = jax.vmap(lambda e: jax.random.fold_in(jax.random.PRNGKey(4321), e))(jnp.arange(E, dtype=jnp.int32))
    off = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))(keys)
    ref = off * jnp.array([0.2, 0.2, 0.2])
    got = tf.reach_goal_offsets(E)
    assert got.shape == (E, 3) and got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(ref))
    assert np.abs(got).max() <= 0.2 and np.unique(got[:, 0]).size > 4000


@pytest.fixture(scope="module")
def reach_envs():
    """(JAX env, port env, JAX's jitted step, JAX's jitted reset's (state, obs))."""
    je = jgen.make_rearrange_env(**REACH)
    te = tgen.make_rearrange_env(device="cpu", **REACH)
    return je, te, jax.jit(je.step_fn), jax.jit(je.reset_fn)(jax.random.PRNGKey(0))


def test_reach_goal_table(reach_envs):
    """Every episode's goal: the port's table against JAX's jitted
    ``_reach_target`` with ep_idx = every episode."""
    je, te, _, (js, _) = reach_envs
    E = int(te.table.obj_init.shape[0])
    ref = jax.jit(lambda s: je._reach_target(dataclasses.replace(s, ep_idx=jnp.arange(E, dtype=jnp.int32))))(js)
    got = (te._resting_ee_local + te._reach_offsets).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=GOAL_ATOL, rtol=0)
    assert np.array_equal(te._reach_offsets.numpy(), tf.reach_goal_offsets(E))


def test_reach_steps_match_jax(reach_envs):
    """The reset, then 16 steps of random arm and base actions from the JAX
    states; every step's success and reward keys are there."""
    je, te, jstep, (js, jo) = reach_envs
    ts, to = te.reset_fn()
    assert set(jo) == set(to) and to["relative_resting_position"].shape == (N, 3)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=1e-5, err_msg=k)
    rng = np.random.default_rng(0)
    D = je.action_space.shape[0]
    assert te.action_dim == D
    for t in range(STEPS):
        a = rng.uniform(-1, 1, (N, D)).astype(np.float32)
        a[:, -2:] *= 0.2  # a slow base, so the arm does the reaching
        jout = jstep(js, jnp.asarray(a))
        tout = te.step_fn(to_port_state(js), torch.as_tensor(a))
        _compare(jout, tout)
        assert {"rearrange_reach_success", "rearrange_reach_reward", "ee_to_resting_distance"} <= set(tout[4])
        js = jout[0]


def test_evaluate_agent_gaussian_policy(reach_envs):
    """tests/test_evaluator.py::test_evaluate_agent_gaussian_policy's
    configuration in both packages, one set of weights, greedy actions."""
    je, te, _, (_, obs) = reach_envs
    D = je.action_space.shape[0]
    jpol = jax_gaussian(D, backbone="resnet9", has_visual=False, hidden_size=32)
    net = jpol.net
    params = jax.jit(jpol.init)(jax.random.PRNGKey(1), obs, initial_hidden_state(
        N, net.hidden_size, net.num_recurrent_layers, net.rnn_type), jnp.zeros((N, D)), jnp.zeros((N,)))
    flat = {k: np.asarray(v, np.float32) for k, v in traverse_util.flatten_dict(params["params"], sep="/").items()}
    pol = make_gaussian_resnet_policy(D, backbone="resnet9", has_visual=False, hidden_size=32,
                                      state_keys=state_keys_of(te.observation_shapes), dtype=torch.float32,
                                      device="cpu")
    pol.load_state_dict(params_from_jax(flat))
    keys = ("rearrange_reach_success",)
    ref = jax_evaluate(je, jpol, params, episodes_per_env=1, deterministic=True, measure_keys=keys, seed=3)
    got = evaluate_agent(te, pol, episodes_per_env=1, deterministic=True, measure_keys=keys, seed=3)
    assert got["num_episodes"] == ref["num_episodes"] >= N
    assert got["rearrange_reach_success"] == ref["rearrange_reach_success"]
    assert got["reward"] == pytest.approx(ref["reward"], abs=REWARD_ATOL)


def test_reach_task_from_config():
    from habitat_tpu.config.default import get_config as jax_config
    from habitat_tpu.core.construct import rearrange_env_from_config as jax_from_config

    from habitat_torch.config.default import get_config
    from habitat_torch.core.construct import rearrange_env_from_config

    overrides = ["habitat.task.type=RearrangeReachTask-v0", "habitat.task.measurements={}",
                 "habitat.dataset.procedural.num_scenes=1", "habitat.dataset.procedural.episodes_per_scene=4",
                 "habitat.simulator.tpu.dynamics=kinematic", "habitat.task.actions.arm_action.type=ArmAction",
                 "habitat.task.actions.base_velocity.type=BaseVelAction"]
    je = jax_from_config(jax_config("benchmark/rearrange/pick_procgen.yaml", overrides), num_envs=2,
                         with_visual=False)
    te = rearrange_env_from_config(get_config("benchmark/rearrange/pick_procgen.yaml", overrides), num_envs=2,
                                   with_visual=False, device="cpu")
    assert (je.task, je.control, je.action_space.shape[0]) == (te.task, te.control, te.action_dim)
    assert je.task == "reach" and je.control == "arm"
    assert (set(je.sensor_keys or ()), set(je.measure_keys or ())) == (set(te.sensor_keys or ()),
                                                                      set(te.measure_keys or ()))
    _assert_tables_equal(je.table, te.table)
    assert np.array_equal(np.asarray(je.order), te.order.numpy())
