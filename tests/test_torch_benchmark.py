"""habitat_torch's ``Benchmark.local_evaluate`` against habitat_tpu's on the
CPU, at tests/test_env_api.py's small overrides, over 3 episodes each.

- ``GoalFollower``: the aggregated metrics equal JAX's within 1e-5 (the
  same keys; success, SPL, distance to goal, ...).
- ``PPOAgent`` (greedy) from random weights: resnet9 over 32x32 depth +
  pointgoal, LSTM-32, float32; the JAX twin built as
  tests/test_torch_agents.py builds it (its encoder in float32, its max pool
  crediting every tie, parameters drawn with numpy and carried across by
  ``params_from_jax``; with these weights the agent moves forward, turns
  and stops: 58 actions, two episodes to the step limit and one stopped).
  Every action and the aggregated metrics (within 1e-5) equal JAX's.
- ``evaluate`` without ``eval_remote`` is ``local_evaluate``; asking for
  more episodes than the env has is an error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.baselines.agents import ppo_agents as jppo
from habitat_tpu.baselines.agents import simple_agents as jsimple
from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.core import benchmark as jbench
from habitat_tpu.core import env as jenv

from habitat_torch.baselines.agents import simple_agents as tsimple
from habitat_torch.baselines.agents.ppo_agents import PPOAgent
from habitat_torch.core.benchmark import Benchmark
from habitat_torch.models.convert import params_from_jax

from tests.test_torch_agents import HIDDEN, HW
from tests.test_torch_env_api import CFG, SMALL
from tests.test_torch_eqa_il import _random_params
from tests.test_torch_ppo import _flat, _jax_as
from tests.torch_jax_native import _jax_native  # noqa: F401

EPISODES = 3


class _JaxBenchmark(jbench.Benchmark):
    """The JAX Benchmark on SMALL's config (its constructor takes no
    overrides; tests/test_env_api.py builds it the same way)."""

    def __init__(self):
        self._eval_remote = False
        self._env = jenv.Env(jax_get_config(CFG, SMALL))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    assert set(got) == set(want) and {"success", "spl", "distance_to_goal"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def _recorded(agent):
    """The actions ``agent`` returns from now on, in a list."""
    acts, act = [], agent.act
    agent.act = lambda obs: acts.append(act(obs)) or acts[-1]
    return acts


def test_goal_follower_matches_jax():
    bench = Benchmark(CFG, overrides=SMALL, device="cpu")
    got = bench.evaluate(tsimple.GoalFollower(), num_episodes=EPISODES)
    _same(got, _JaxBenchmark().evaluate(jsimple.GoalFollower(), num_episodes=EPISODES))
    with pytest.raises(AssertionError, match="larger than number of episodes"):
        bench.local_evaluate(tsimple.GoalFollower(), num_episodes=7)


def test_ppo_agent_matches_jax():
    jb = _JaxBenchmark()
    with _jax_as("float32", all_ties=True):
        ja = jppo.PPOAgent(num_actions=4, backbone="resnet9", hidden_size=HIDDEN, deterministic=True)
        obs0 = {k: jnp.asarray(v)[None] for k, v in jb._env.reset().items()}
        ja.params = _random_params(ja.policy, obs0, ja.hidden, ja.prev_action, ja.mask, seed=1)
        jacts = _recorded(ja)
        want = _JaxBenchmark().local_evaluate(ja, num_episodes=EPISODES)
    ta = PPOAgent(num_actions=4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                  hidden_size=HIDDEN, deterministic=True, dtype=torch.float32, device="cpu")
    ta.policy.load_state_dict(params_from_jax(_flat(ja.params["params"])))
    tacts = _recorded(ta)
    got = Benchmark(CFG, overrides=SMALL, device="cpu").local_evaluate(ta, num_episodes=EPISODES)
    _same(got, want)
    assert tacts == jacts and len(tacts) == 58 and set(tacts) == {0, 1, 2}
