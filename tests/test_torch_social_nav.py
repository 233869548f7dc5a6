"""habitat_torch's social-navigation env against habitat_tpu's on the CPU.

Both packages build ``make_social_nav_env`` from the same seed (one
procedural apartment of four episodes): the tables must be equal bit for
bit. Then the JAX env's reset and step, each jitted, and the port's on CPU
tensors run 32 steps free from the same reset under the same seeded actions
(forward-heavy, no stop): blind at N=4, two-agent at N=4 (both agents
acting), and visual at N=2 with a 32x32 head camera. The step draws no
random number, so the two runs stay together.

- Observations, reward and measures within 1e-5 + 1e-6 relative (the
  distance sums accumulate float32 rounding over the steps); dones and the
  discrete state fields equal; the float state within the same bounds.
- The visual frames: the JAX env renders with its plain XLA route on the
  CPU, the port with #3's plain version (the index route, the humanoid's 24
  triangles as the dynamic pass): semantics and hit/miss equal on >= 99.9%
  of pixels, normalized depth within 1e-4 on common hits, RGB within one
  level on >= 99.9%. The humanoid's 24 triangles equal the JAX env's within
  1e-6, and one frame with it 1.2 m ahead is also held to
  the JAX ``render_batch(..., backend="pallas")`` under
  ``pltpu.force_tpu_interpret_mode()`` (kernel #3 of the JAX package) at
  the same bounds, and the humanoid covers pixels of it.
- ``PPOLearner`` with the recipe's measure keys trains on the single-agent
  env unchanged (one step at N=4, finite metrics, the three measure sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.ops import raycast as jrc
from habitat_tpu.tasks.rearrange import social_nav as jsn

from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
from habitat_torch.models.policy import make_pointnav_resnet_policy, state_keys_of
from habitat_torch.tasks.rearrange import social_nav as tsn
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL, RTOL = 1e-5, 1e-6
STEPS = 32
GEN = dict(num_scenes=1, episodes_per_scene=4, seed=2)
CASES = {"blind": dict(num_envs=4), "two_agent": dict(num_envs=4, two_agent=True),
         "visual": dict(num_envs=2, with_visual=True, render_size=(32, 32))}
DISCRETE = ("ep_ptr", "ep_idx", "step", "human_wp", "follow_steps", "found_steps", "found_ever", "found_step",
            "after_found_times", "step_after_found", "backup_count", "yield_count", "stop_called", "collided",
            "agents_collide", "episode_over", "episode_count")
MEASURE_KEYS = ("nav_seek_success", "did_agents_collide", "found_human_rate")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _envs(case):
    kw = {**GEN, **CASES[case]}
    return jsn.make_social_nav_env(**kw), tsn.make_social_nav_env(device="cpu", **kw)


def _actions(rng, env):
    shape = (env.num_envs, 2) if env.two_agent else (env.num_envs,)
    a = rng.integers(1, 4, shape)
    return np.where(rng.random(shape) < 0.5, 1, a).astype(np.int32)


def _frames_agree(got, ref):
    """The env frames' bounds: hit/miss >= 99.9%, depth within 1e-4 on common
    hits, RGB within one level on >= 99.9%."""
    d0, d1 = ref["depth"], got["depth"]
    hit0, hit1 = d0 < 1.0, d1 < 1.0
    assert (hit0 == hit1).mean() >= 0.999
    both = hit0 & hit1
    assert np.abs(d0 - d1)[both].max(initial=0.0) <= 1e-4
    rgb = np.abs(ref["rgb"].astype(np.int32) - got["rgb"].astype(np.int32)).max(-1)
    assert (rgb <= 1).mean() >= 0.999


def test_tables_equal():
    je, te = _envs("blind")
    for f in dataclasses.fields(je.table):
        ref, got = _np(getattr(je.table, f.name)), getattr(te.table, f.name).numpy()
        assert np.array_equal(got, ref.astype(got.dtype)), f.name
    assert np.array_equal(_np(je.order), te.order.numpy())
    assert set(je.observation_space.spaces) == set(te.observation_shapes)
    for k, sp in je.observation_space.spaces.items():
        assert te.observation_shapes[k][0] == sp.shape, k


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_matches_jax(case):
    je, te = _envs(case)
    assert set(je.observation_space.spaces) == set(te.observation_shapes)
    js, jo = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    ts, to = te.reset_fn()
    jstep = jax.jit(je.step_fn)
    rng = np.random.default_rng(7)
    dones = 0
    for t in range(STEPS + 1):
        assert set(jo) == set(to)
        for k in jo:
            ref, got = _np(jo[k]), to[k].numpy()
            if k.endswith("robot_head_rgb"):
                continue  # with the depth below
            if k.endswith("robot_head_depth"):
                _frames_agree({"depth": got, "rgb": to[k.replace("depth", "rgb")].numpy()},
                              {"depth": ref, "rgb": _np(jo[k.replace("depth", "rgb")])})
                continue
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=f"step {t} obs {k}")
        for f in dataclasses.fields(ts):
            ref, got = _np(getattr(js, f.name)), getattr(ts, f.name).numpy()
            if f.name in DISCRETE:
                assert np.array_equal(got, ref.astype(got.dtype)), (t, f.name)
            else:
                np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=f"step {t} state {f.name}")
        if t == STEPS:
            break
        a = _actions(rng, te)
        js, jo, jr, jd, ji = jstep(js, jnp.asarray(a))
        ts, to, tr, td, ti = te.step_fn(ts, torch.as_tensor(a))
        assert np.array_equal(td.numpy(), _np(jd)), t
        np.testing.assert_allclose(tr.numpy(), _np(jr), atol=ATOL, rtol=RTOL, err_msg=f"step {t} reward")
        assert set(ji) == set(ti)
        for k in ji:
            np.testing.assert_allclose(ti[k].numpy(), _np(ji[k]), atol=ATOL, rtol=RTOL, err_msg=f"step {t} {k}")
        dones += int(td.sum())
    moved = np.linalg.norm(_np(js.human_pos) - te.table.human_start[ts.ep_idx].numpy(), axis=-1)
    assert (moved > 0.1).any(), "the humanoid never moved"


def test_humanoid_frame_matches_pallas_index_route():
    """The head frame with the humanoid 1.2 m ahead: the port's body
    triangles equal the JAX env's, and the port's render (#3's plain
    version, the scene and the dynamic pass) matches the JAX package's
    Pallas route in interpret mode on the JAX body."""
    je, te = _envs("visual")
    ts, _ = te.reset_fn()
    ahead = ts.pos + torch.stack([-torch.sin(ts.yaw), torch.zeros_like(ts.yaw), -torch.cos(ts.yaw)], -1) * 1.2
    ts = dataclasses.replace(ts, human_pos=ahead)
    got = {k: v.numpy() for k, v in te.render(ts).items()}
    js = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))[0]
    dyn = je._humanoid_geometry(dataclasses.replace(js, human_pos=jnp.asarray(ahead.numpy())))
    for k, v in te.humanoid_geometry(ts).items():  # the same body, triangle by triangle
        np.testing.assert_allclose(v.numpy(), _np(dyn[k]), atol=1e-6, err_msg=k)
    cam = ts.pos.numpy() + np.array([0.0, 1.25, 0.0], np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jrc.render_batch(je.pack, jnp.asarray(te._sid(ts).numpy(), jnp.int32), jnp.asarray(cam),
                               jnp.asarray(ts.yaw.numpy()), jnp.full((2,), -0.25), height=32, width=32,
                               dynamic=dyn, backend="pallas")
    ref = {k: _np(v) for k, v in ref.items()}
    assert (ref["semantic"] == got["semantic"]).mean() >= 0.999
    _frames_agree(got, ref)
    humanoid = got["semantic"] == tsn.HUMANOID_SEM
    assert humanoid.reshape(2, -1).mean(-1).min() > 0.01, "the humanoid covers no pixel"


def test_ppo_learner_drives_the_social_env():
    """scripts/train_social_tpu.py's single mode on the port's learner, at
    N=4: the recipe's measure keys are summed and everything is finite."""
    te = tsn.make_social_nav_env(num_envs=4, device="cpu", **{k: v for k, v in GEN.items() if k != "num_envs"})
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(te.num_actions, has_visual=False, hidden_size=32, goal_keys=(),
                                         backbone="resnet9", state_keys=state_keys_of(te.observation_shapes),
                                         device="cpu")
    assert policy.net.state_keys == ("gps", "compass")
    lrn = PPOLearner(te, policy, PPOConfig(num_steps=8, num_mini_batch=2, ppo_epoch=2), measure_keys=MEASURE_KEYS)
    rs, m = lrn.train_step(lrn.init(seed=0))
    assert all(np.isfinite(v.item()) for v in m.values())
    assert all(f"m_{k}" in m for k in MEASURE_KEYS) and m["done_count"].item() > 0
