"""habitat_torch's population play and two-agent PPO
(``baselines/multi_agent.py``) against habitat_tpu's on the CPU.

- The population helpers on numpy-drawn parameter sets: ``stack_params``,
  ``select_params`` (a set, and one per lane), ``population_size`` and
  ``apply_population`` (each lane with its own set) equal to JAX's within
  1e-6.
- ``MultiAgentAccessMgr``: snapshots (the oldest dropped past
  ``max_size``), the stacked population and the sampled opponents (both
  draw from ``default_rng(seed)``) equal to JAX's; ``on_update_done`` and
  ``SelfPlayWrapper``.
- ``population_params_from_jax`` and ``two_agent_params_from_jax`` against
  ``params_from_jax`` set by set.
- One ``TwoAgentPPOLearner.train_step`` on the two-agent social-nav env (N=4,
  T=8, two blind resnet9 + LSTM-32 policies, ``ppo_epoch=2``) from the same
  weights (drawn with numpy into the Flax trees' shapes, converted): the JAX
  step runs jitted with its sampled actions recorded by
  ``jax.debug.callback`` (test only), the port's replays them (the two
  packages' generators differ). Rollout metrics within 1e-5, each agent's
  loss within 1e-4 of max(1, |loss|), and each agent's parameters by
  tests/test_torch_ppo.py's rule scaled to the two Adam steps: every
  element within 2 * ppo_epoch * lr of JAX's, >= 99% within lr/10, every
  tensor moved on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from habitat_tpu.baselines import multi_agent as jma
from habitat_tpu.baselines.ppo import PPOConfig as JPPOConfig
from habitat_tpu.models import policy as jpolicy
from habitat_tpu.models.rnn_state_encoder import initial_hidden_state
from habitat_tpu.tasks.rearrange import social_nav as jsn

from habitat_torch.baselines import multi_agent as tma
from habitat_torch.baselines.ppo import PPOConfig
from habitat_torch.models.convert import params_from_jax, population_params_from_jax, two_agent_params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy, state_keys_of
from habitat_torch.tasks.rearrange import social_nav as tsn
from tests.torch_jax_native import _jax_native  # noqa: F401

N, T, HIDDEN = 4, 8, 32
PPO = dict(num_steps=T, num_mini_batch=1, ppo_epoch=2)
ENV = dict(num_envs=N, num_scenes=1, episodes_per_scene=4, seed=2, two_agent=True)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sets(k, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(4, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
            for _ in range(k)]


def _torch(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def test_population_helpers_match_jax():
    sets = _sets(4)
    js = jma.stack_params([{k: jnp.asarray(v) for k, v in p.items()} for p in sets])
    ts = tma.stack_params([_torch(p) for p in sets])
    assert tma.population_size(ts) == jma.population_size(js) == 4
    for idx in (1, [2, 0, 3, 3]):
        ref = jma.select_params(js, jnp.asarray(idx))
        got = tma.select_params(ts, torch.as_tensor(idx))
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    lanes = np.array([3, 0, 2, 2, 1])
    xs = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    ref = jma.apply_population(lambda p, x: p["w"] @ x + p["b"], js, jnp.asarray(lanes), jnp.asarray(xs))
    got = tma.apply_population(lambda p, x: p["w"] @ x + p["b"], ts, torch.as_tensor(lanes), torch.as_tensor(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    for lane, i in enumerate(lanes):  # each lane with its own set
        np.testing.assert_allclose(got[lane].numpy(), sets[i]["w"] @ xs[lane] + sets[i]["b"], atol=1e-5)


def test_access_manager_matches_jax():
    specs_j = [jma.AgentSpec("robot"), jma.AgentSpec("humanoid", learner=False)]
    specs_t = [tma.AgentSpec("robot"), tma.AgentSpec("humanoid", learner=False)]
    jm, tm = jma.MultiAgentAccessMgr(specs_j, seed=5), tma.MultiAgentAccessMgr(specs_t, seed=5)
    assert jm.nagents == tm.nagents == 2
    with pytest.raises(ValueError, match="push_snapshot"):
        tm.sample_opponents(3)
    for i, p in enumerate(_sets(5, seed=2)):
        jm.push_snapshot({k: jnp.asarray(v) for k, v in p.items()}, max_size=3)
        tm.push_snapshot(_torch(p), max_size=3)
        assert tma.population_size(tm.population) == jma.population_size(jm.population) == min(i + 1, 3)
        for k in p:
            np.testing.assert_array_equal(tm.population[k].numpy(), np.asarray(jm.population[k]))
        np.testing.assert_array_equal(tm.sample_opponents(16), jm.sample_opponents(16))
    tm.on_update_done(3, _torch(_sets(1)[0]), snapshot_every=2)  # not a snapshot step
    assert tma.population_size(tm.population) == 3
    params, idx = tma.SelfPlayWrapper(tm).opponent_params(tm.population, 6)
    assert params is tm.population and idx.tolist() == [0] * 6


def _random_params(module, *args, seed=0):
    """tests/test_torch_eqa_il.py's draw: kernels of variance 1 / fan_in,
    biases N(0, 0.1), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name = str(path[-1].key)
        scale = {"kernel": 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), "embedding": 1.0, "bias": 0.1}[name]
        return jnp.asarray(rng.normal(0.0, scale, leaf.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def test_population_converters():
    sets = [{"params": {"critic": {"Dense_0": {"kernel": np.full((3, 1), float(i), np.float32),
                                                "bias": np.full((1,), -float(i), np.float32)}}}}
            for i in range(3)]
    flats = [_flat(s) for s in sets]
    stacked = {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    pop = population_params_from_jax(stacked)
    for i, one in enumerate(two_agent_params_from_jax(flats)):
        ref = params_from_jax(flats[i])
        assert set(one) == set(ref) == set(pop)
        for k in ref:
            assert torch.equal(one[k], ref[k]) and torch.equal(pop[k][i], ref[k])


@pytest.fixture(scope="module")
def jax_step(request):
    """The JAX learner's state from numpy-drawn weights, and one jitted
    train_step with its sampled actions recorded."""
    je = jsn.make_social_nav_env(**ENV)
    cfg = JPPOConfig(**PPO)
    pols = [jpolicy.make_pointnav_resnet_policy(je.action_space.n, has_visual=False, hidden_size=HIDDEN,
                                                goal_keys=(), backbone="resnet9") for _ in range(2)]
    lrn = jma.TwoAgentPPOLearner(je, pols, cfg)
    env_state, obs = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    h = initial_hidden_state(N, HIDDEN, 1, "LSTM")
    pa, nd = jnp.zeros((N,), jnp.int32), jnp.zeros((N,), jnp.float32)
    params = [_random_params(p, lrn._agent_obs(obs, i), h, pa, nd, seed=10 + i) for i, p in enumerate(pols)]
    ts = dict(params=params, opt_states=[o.init(p) for o, p in zip(lrn.optimizers, params)], env_state=env_state,
              obs=obs, hidden=[h, h], prev_a=[pa, pa], not_done=nd, key=jax.random.PRNGKey(3),
              update_idx=jnp.int32(0))
    recorded, sample = [], jpolicy.sample_action

    def recording(logits, key, deterministic=False):
        a, lp = sample(logits, key, deterministic)
        jax.debug.callback(lambda x: recorded.append(np.asarray(x)), a, ordered=True)
        return a, lp

    mp = pytest.MonkeyPatch()
    mp.setattr(jpolicy, "sample_action", recording)
    try:
        ts2, m = jax.jit(lrn.train_step)(ts)
        jax.block_until_ready(ts2)
    finally:
        mp.undo()
    actions = np.stack(recorded).reshape(T, 2, N).transpose(0, 2, 1)  # (T, N, agent)
    return ts, ts2, {k: float(v) for k, v in m.items()}, actions


def test_two_agent_update_matches_jax(jax_step):
    ts, ts2, jm, actions = jax_step
    te = tsn.make_social_nav_env(device="cpu", **ENV)
    cfg = PPOConfig(**PPO)
    starts = two_agent_params_from_jax([_flat(p["params"]) for p in ts["params"]])
    refs = two_agent_params_from_jax([_flat(p["params"]) for p in ts2["params"]])
    pols = []
    for i, start in enumerate(starts):
        pol = make_pointnav_resnet_policy(te.num_actions, has_visual=False, hidden_size=HIDDEN, goal_keys=(),
                                          backbone="resnet9", state_keys=state_keys_of(te.agent_observation_shapes(i)),
                                          device="cpu")
        pol.load_state_dict(start)
        pols.append(pol)
    lrn = tma.TwoAgentPPOLearner(te, pols, cfg)
    tts, tm = lrn.train_step(lrn.init(seed=0), actions=torch.as_tensor(actions))
    assert tts.update_idx == 1
    for k in ("done_count", "m_success", "reward_step_mean"):
        np.testing.assert_allclose(tm[k].item(), jm[k], atol=1e-5, err_msg=k)
    assert jm["done_count"] > 0  # episodes end inside the rollout
    for i in range(2):
        k = f"losses/agent{i}_loss"
        assert abs(tm[k].item() - jm[k]) <= 1e-4 * max(1.0, abs(jm[k])), (k, tm[k].item(), jm[k])
        got, ref, start = pols[i].state_dict(), refs[i], starts[i]
        close, total = 0, 0
        for name, p in got.items():
            if name.endswith("bias_ih"):  # the LSTM's untrained input bias
                continue
            moved_ref, moved_got = (ref[name] - start[name]).abs().max(), (p - start[name]).abs().max()
            assert moved_ref > 0 and moved_got > 0, (i, name)
            diff = (p - ref[name]).abs()
            assert diff.max() <= 2 * cfg.ppo_epoch * cfg.lr, (i, name, diff.max().item())
            close += int((diff <= cfg.lr / 10).sum())
            total += diff.numel()
        assert close / total >= 0.99, (i, close / total)
