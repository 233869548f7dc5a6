"""The port's rollout slice on the CPU: ``PPOLearner.collect_rollout`` over
the rendered env with the bf16 policy, checked for the batch's bookkeeping
and replayed through habitat_tpu's env (sampled actions cannot be
reproduced across frameworks, so the port's own actions are replayed):
dones and episode ids equal, rewards within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav

from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.models.policy import make_pointnav_resnet_policy, sample_action
from tests.torch_jax_native import _jax_native  # noqa: F401

N_ENVS, T, HW, MAX_STEPS = 4, 8, 32, 6
SENSORS = (
    ("HabitatSimDepthSensor", {"height": HW, "width": HW}),
    ("HabitatSimRGBSensor", {"height": HW, "width": HW}),
    ("PointGoalWithGPSCompassSensor", None),
)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rollout():
    torch.manual_seed(0)
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)
    env = make_nav_env(
        scenes, episodes, num_envs=N_ENVS, device="cpu", precomputed_fields=fields,
        max_episode_steps=MAX_STEPS, sensor_specs=SENSORS,
    )
    policy = make_pointnav_resnet_policy(len(env.actions), input_hw=(HW, HW), device="cpu")
    learner = PPOLearner(env, policy, PPOConfig(num_steps=T))
    rs0 = learner.init(seed=0)
    rs1, batch, last_value, h0, stats = learner.collect_rollout(rs0)
    rs2, batch2, _, h0_2, _ = learner.collect_rollout(rs1)
    return learner, rs0, rs1, batch, last_value, h0, stats, batch2, h0_2


def test_batch_bookkeeping(rollout):
    learner, rs0, rs1, batch, last_value, h0, stats, batch2, h0_2 = rollout
    assert batch.obs["depth"].shape == (T, N_ENVS, HW, HW, 1)
    assert batch.obs["depth"].dtype == torch.bfloat16
    assert batch.obs["rgb"].dtype == torch.uint8
    assert batch.obs["pointgoal_with_gps_compass"].dtype == torch.float32
    for x in (batch.actions, batch.log_probs, batch.values, batch.rewards, batch.dones, batch.masks):
        assert x.shape == (T, N_ENVS)
    assert torch.isfinite(batch.values).all() and torch.isfinite(last_value).all()
    assert (batch.masks[0] == 0).all() and (batch.prev_actions[0] == 0).all()
    torch.testing.assert_close(batch.masks[1:], 1.0 - batch.dones[:-1])
    torch.testing.assert_close(batch.prev_actions[1:], batch.actions[:-1])
    assert (h0 == 0).all()
    torch.testing.assert_close(h0_2, rs1.hidden)
    torch.testing.assert_close(batch2.masks[0], rs1.not_done)
    assert int(stats["done_count"]) == int(batch.dones.sum())
    # stored log probs are the policy's at the stored inputs
    with torch.no_grad():
        logits, values, _ = learner.policy(
            {k: v[0] for k, v in batch.obs.items()}, h0, batch.prev_actions[0], batch.masks[0]
        )
    lp = torch.log_softmax(logits, -1).gather(-1, batch.actions[0, :, None].long())[:, 0]
    torch.testing.assert_close(lp, batch.log_probs[0], rtol=0, atol=1e-2)
    torch.testing.assert_close(values, batch.values[0], rtol=0, atol=1e-2)


def test_sample_action_greedy_is_argmax():
    logits = torch.tensor([[0.1, 2.0, -1.0, 0.5], [3.0, 0.0, 0.0, 0.0]])
    act, logp = sample_action(logits, torch.Generator(), deterministic=True)
    assert act.tolist() == [1, 0]
    torch.testing.assert_close(logp, torch.log_softmax(logits, -1)[[0, 1], [1, 0]])


def test_sample_action_is_multinomials_draw():
    """The categorical draw is ``torch.multinomial``'s for one sample (argmax
    of p / q, q ~ Exp(1)): the same actions from the same generator state,
    the generator left where multinomial leaves it; never a
    zero-probability action; a row's action depends on its own q only
    (DD-PPO ranks keep their rows of the global draw)."""
    probs = torch.tensor([0.2, 0.0, 0.5, 0.3])
    logits = torch.log(probs).expand(2000, 4) + torch.randn(2000, 4, generator=torch.Generator().manual_seed(1))
    logits[:, 1] = -float("inf")
    g, g_ref = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    act, logp = sample_action(logits, g)
    ref = torch.multinomial(torch.softmax(logits, -1), 1, generator=g_ref)[:, 0]
    assert torch.equal(act.long(), ref) and torch.equal(g.get_state(), g_ref.get_state())
    assert not (act == 1).any()
    torch.testing.assert_close(logp, torch.log_softmax(logits, -1).gather(-1, act[:, None].long())[:, 0])
    q = torch.empty(2000, 4).exponential_(1, generator=torch.Generator().manual_seed(2))
    whole = sample_action(logits, None, exponential=q)[0]
    assert torch.equal(sample_action(logits[5:9], None, exponential=q[5:9])[0], whole[5:9])


def test_rollout_stores_float32_when_asked(rollout):
    """``obs_store_bf16=False`` keeps float visual observations in float32."""
    learner = rollout[0]
    lrn = PPOLearner(learner.env, learner.policy, PPOConfig(num_steps=2, obs_store_bf16=False))
    _, batch, *_ = lrn.collect_rollout(lrn.init(seed=0))
    assert batch.obs["depth"].dtype == torch.float32 and batch.obs["rgb"].dtype == torch.uint8


def test_rollout_replays_through_jax_env(rollout):
    learner, rs0, rs1, batch, *_ = rollout
    sj, ej, fj = jax_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)
    je = jax_make_nav_env(sj, ej, num_envs=N_ENVS, precomputed_fields=fj, max_episode_steps=MAX_STEPS)
    js, _ = je.reset(seed=0)
    np.testing.assert_array_equal(np.asarray(js.ep_idx), rs0.env_state.ep_idx.numpy())
    for t in range(T):
        js, _, r, d, _ = je.step(js, jnp.asarray(batch.actions[t].numpy()))
        np.testing.assert_array_equal(np.asarray(d), batch.dones[t].numpy() > 0, err_msg=f"done@{t}")
        np.testing.assert_allclose(np.asarray(r), batch.rewards[t].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(js.ep_idx), rs1.env_state.ep_idx.numpy())
    np.testing.assert_allclose(np.asarray(js.pos), rs1.env_state.pos.numpy(), rtol=0, atol=1e-5)
