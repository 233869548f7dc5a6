"""habitat_torch's deployable agents and TensorDict against habitat_tpu's on
the CPU.

- ``RandomAgent``, ``ForwardOnlyAgent``, ``RandomForwardAgent`` and
  ``GoalFollower`` on the same 200 pointgoal observations (numpy, seeded;
  every eighth within the stop distance, angles over [-4, 4]) give the same
  actions as the JAX package's, the random ones from the same
  ``default_rng(0)`` draws; the port's also take tensors.
- ``PPOAgent`` with weights carried by ``convert.py`` (resnet9 over 32x32
  depth + pointgoal, LSTM-32, both in float32 with the JAX encoder's max
  pool crediting every tie, deterministic) gives the JAX ``PPOAgent``'s
  action at each of 10 observations, a reset between the fifth and sixth;
  its carry within 1e-5 of the JAX agent's at the end.
- ``PPOAgent`` not deterministic, from the same weights and seed: JAX's
  key is split at every act and its action drawn by ``categorical``; the
  port draws the same Gumbel noise (``utils/threefry.py``) and so picks
  JAX's action at every step of 30 env steps on a procedural scene (32x32
  depth through the port's env, episodes ending by stop reset both
  agents). Margin rule: a step may part only where the port's top two
  noisy logits lie within 1e-5 (the float32 logit gap); none did.
- ``load_checkpoint``: the flagship export (rebuilt from its JSON), a port
  trainer checkpoint (``{"policy": state_dict}``), and an orbax-style
  directory, which raises and names the export script.
- ``TensorDict`` over the same nested numpy tree: indexing by slice, by
  integer array and by key, ``slice_keys``, ``set`` (in place, and its
  strict KeyError) and ``map`` equal to the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.baselines.agents import ppo_agents as jppo
from habitat_tpu.baselines.agents import simple_agents as jsimple
from habitat_tpu.baselines.tensor_dict import TensorDict as JaxTensorDict

from habitat_torch.baselines.agents import simple_agents as tsimple
from habitat_torch.baselines.agents.ppo_agents import PPOAgent
from habitat_torch.baselines.tensor_dict import TensorDict
from habitat_torch.models.convert import load_policy_file, params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy

from tests.test_torch_eqa_il import _random_params
from tests.test_torch_ppo import _flat, _jax_as
from tests.torch_jax_native import _jax_native  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "habitat_torch", "weights", "flagship_pointnav.pt")
HW, HIDDEN = 32, 32


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pointgoals(n=200, seed=0):
    rng = np.random.default_rng(seed)
    pg = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-4.0, 4.0, n)], -1).astype(np.float32)
    pg[::8, 0] = rng.uniform(0.0, 0.2, len(pg[::8]))
    return pg


@pytest.mark.parametrize("name", ["RandomAgent", "ForwardOnlyAgent", "RandomForwardAgent", "GoalFollower"])
def test_simple_agents_match_jax(name):
    ja, ta, tb = getattr(jsimple, name)(), getattr(tsimple, name)(), getattr(tsimple, name)()
    got, want, as_tensor = [], [], []
    for pg in _pointgoals():
        want.append(ja.act({"pointgoal_with_gps_compass": pg}))
        got.append(ta.act({"pointgoal_with_gps_compass": pg}))
        as_tensor.append(tb.act({"pointgoal_with_gps_compass": torch.from_numpy(pg)}))
    assert got == want == as_tensor
    assert set(want) >= ({0, 1, 2, 3} if name != "ForwardOnlyAgent" else {0, 1})


def _obs(rng):
    return {"depth": rng.uniform(0, 1, (HW, HW, 1)).astype(np.float32),
            "pointgoal_with_gps_compass": np.array([rng.uniform(0.5, 5), rng.uniform(-3, 3)], np.float32)}


def test_ppo_agent_matches_jax():
    rng = np.random.default_rng(4)
    seq = [_obs(rng) for _ in range(10)]
    with _jax_as("float32", all_ties=True):
        ja = jppo.PPOAgent(num_actions=4, backbone="resnet9", hidden_size=HIDDEN, deterministic=True)
        obs0 = {k: jnp.asarray(v)[None] for k, v in seq[0].items()}
        ja.params = _random_params(ja.policy, obs0, ja.hidden, ja.prev_action, ja.mask, seed=4)
        want = []
        for i, o in enumerate(seq):
            if i == 5:
                ja.reset()
            want.append(ja.act(o))
        jhidden = np.asarray(ja.hidden)
    ta = PPOAgent(num_actions=4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                  hidden_size=HIDDEN, deterministic=True, dtype=torch.float32, device="cpu")
    ta.policy.load_state_dict(params_from_jax(_flat(ja.params["params"])))
    got = []
    for i, o in enumerate(seq):
        if i == 5:
            ta.reset()
        got.append(ta.act(o))
    assert got == want and len(set(want)) > 1, (got, want)
    np.testing.assert_allclose(ta.hidden.numpy(), jhidden, atol=1e-5)


def test_ppo_agent_samples_jax_draws():
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.utils import threefry

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=1, episodes_per_scene=4, seed=0)
    env = make_nav_env(scenes, episodes, num_envs=1, precomputed_fields=fields, max_episode_steps=40, device="cpu",
                       sensor_specs=(("HabitatSimDepthSensor", {"height": HW, "width": HW}),
                                     ("PointGoalWithGPSCompassSensor", None)))
    st, obs = env.reset_fn()
    parted, actions = [], []
    with _jax_as("float32", all_ties=True):
        ja = jppo.PPOAgent(num_actions=4, backbone="resnet9", hidden_size=HIDDEN, deterministic=False, seed=3)
        obs0 = {k: jnp.asarray(v[0].numpy())[None] for k, v in obs.items()}
        ja.params = _random_params(ja.policy, obs0, ja.hidden, ja.prev_action, ja.mask, seed=5)
        ta = PPOAgent(num_actions=4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                      hidden_size=HIDDEN, deterministic=False, seed=3, dtype=torch.float32, device="cpu")
        ta.policy.load_state_dict(params_from_jax(_flat(ja.params["params"])))
        for _ in range(30):
            o = {k: v[0].numpy() for k, v in obs.items()}
            # the port's noisy logits for this act, for the margin rule
            with torch.no_grad():
                logits = ta.policy({k: torch.from_numpy(v)[None] for k, v in o.items()}, ta.hidden,
                                   ta.prev_action, ta.mask)[0][0]
            noisy = np.sort(logits.numpy() + threefry.gumbel(threefry.split(ta._key)[1], (1, 4))[0])
            a_j, a_t = ja.act(o), ta.act(o)
            actions.append(a_j)
            if a_j != a_t:
                parted.append(noisy[-1] - noisy[-2])
            st, obs, _, done, _ = env.step_fn(st, torch.tensor([a_j]))
            if done[0]:
                ja.reset()
                ta.reset()
    assert all(m <= 1e-5 for m in parted), parted
    assert not parted and len(set(actions)) == 4, (parted, actions)


def test_ppo_agent_loads_exports_and_trainer_checkpoints(tmp_path):
    agent = PPOAgent(num_actions=4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                     hidden_size=HIDDEN, deterministic=True, device="cpu")
    agent.load_checkpoint(FLAGSHIP)
    want = load_policy_file(FLAGSHIP, device="cpu").state_dict()
    assert all(torch.equal(v, want[k]) for k, v in agent.policy.state_dict().items())
    assert agent.hidden.shape == (1, 1, 2, 512)
    # a port trainer's checkpoint: {"policy": state_dict, ...}
    torch.manual_seed(1)
    pol = make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                                      hidden_size=HIDDEN, device="cpu")
    torch.save({"policy": pol.state_dict(), "num_steps_done": 0}, tmp_path / "latest")
    agent = PPOAgent(num_actions=4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                     hidden_size=HIDDEN, device="cpu")
    agent.load_checkpoint(str(tmp_path))
    assert all(torch.equal(v, pol.state_dict()[k]) for k, v in agent.policy.state_dict().items())
    (tmp_path / "orbax" / "latest").mkdir(parents=True)
    with pytest.raises(ValueError, match="export_flagship_torch"):
        agent.load_checkpoint(str(tmp_path / "orbax"))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"obs": {"depth": rng.normal(size=(6, 3, 2)).astype(np.float32),
                    "goal": rng.normal(size=(6, 2)).astype(np.float32)},
            "actions": rng.integers(0, 4, (6,)), "rewards": rng.normal(size=(6,)).astype(np.float32)}


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _same(got[k], w)
        else:
            g = got[k]
            np.testing.assert_array_equal(g.numpy() if torch.is_tensor(g) else g, np.asarray(w), err_msg=k)


def test_tensor_dict_matches_jax():
    jt, tt = JaxTensorDict.from_tree(_tree(0)), TensorDict.from_tree(_tree(0))
    assert isinstance(tt["obs"], TensorDict) and torch.is_tensor(tt["obs"]["depth"])
    for index in (slice(1, 4), np.array([5, 0, 2]), 3):
        _same(tt[index], jt[index])
    _same(tt.slice_keys("actions", "obs"), jt.slice_keys("actions", "obs"))
    new = _tree(1)
    part = {"obs": {k: v[:2] for k, v in new["obs"].items()}, "actions": new["actions"][:2],
            "rewards": new["rewards"][:2]}
    jt[slice(2, 4)] = part
    tt[slice(2, 4)] = part
    _same(tt, jt)
    jt.set(np.array([0, 5]), {"rewards": np.array([7.0, 8.0], np.float32), "extra": 1}, strict=False)
    tt.set(np.array([0, 5]), {"rewards": np.array([7.0, 8.0], np.float32), "extra": 1}, strict=False)
    _same(tt, jt)
    with pytest.raises(KeyError):
        tt.set(0, {"extra": 1})
    _same(tt.map(lambda v: v * 2), jt.map(lambda v: v * 2))
    _same(tt.numpy(), jt.numpy())
