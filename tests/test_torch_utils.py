"""habitat_torch's baselines utilities (``utils/info_dict.py``,
``utils/common.py``, ``utils/profiling_wrapper.py``) against habitat_tpu's
on the CPU.

- ``extract_scalars_from_info(s)`` on nested infos of numbers, numpy arrays
  and tensors (one-element ones become floats, the non-scalar metrics are
  left out) equal JAX's on the same infos with JAX arrays.
- ``batch_obs`` stacks as JAX's does (float64 and int64 narrowed to 32
  bits), from numpy and from tensors; ``get_num_actions`` and
  ``is_continuous_action_space`` read the port's envs' descriptors as JAX's
  read the matching gymnasium spaces.
- ``LagrangeInequalityCoefficient`` over 50 steps of both directions: loss,
  alpha and log-alpha equal JAX's at every step; ``ascend`` on a tensor
  equals it on floats (the PPO update's form).
- A profiling range shows by name in a CPU ``torch.profiler`` trace, and a
  configured capture window writes a Chrome trace that holds it.
"""

import json
import os
from contextlib import nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from gymnasium import spaces

from habitat_tpu.utils import common as jcommon
from habitat_tpu.utils import info_dict as jinfo

from habitat_torch.utils import common as tcommon
from habitat_torch.utils import info_dict as tinfo
from habitat_torch.utils import profiling_wrapper as prof
from tests.torch_jax_native import _jax_native  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _info(rng, arr):
    return {"spl": float(rng.uniform()), "success": arr(np.array([1.0], np.float32)),
            "collisions": {"count": arr(np.float32(rng.integers(5))), "is_collision": True},
            "top_down_map": arr(np.zeros((4, 4), np.float32)), "distance_to_goal": arr(np.float32(rng.uniform(0, 5))),
            "frames": arr(np.zeros((2,), np.float32)), "name": "episode", 3: 1.0,
            "nested": {"a": {"b": int(rng.integers(9))}, "c": arr(np.ones((1, 1), np.float32))}}


def test_extract_scalars_match_jax():
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    infos_j = [_info(rng_j, jnp.asarray) for _ in range(5)]
    infos_t = [_info(rng_t, torch.as_tensor) for _ in range(5)]
    want = jinfo.extract_scalars_from_info(infos_j[0])
    got = tinfo.extract_scalars_from_info(infos_t[0])
    assert got == want and "top_down_map" not in got and "collisions.is_collision" not in got
    assert set(got) == {"spl", "success", "collisions.count", "distance_to_goal", "nested.a.b", "nested.c"}
    assert tinfo.extract_scalars_from_infos(infos_t) == jinfo.extract_scalars_from_infos(infos_j)
    # numpy leaves too
    rng = np.random.default_rng(0)
    assert tinfo.extract_scalars_from_info(_info(rng, np.asarray)) == want


def test_batch_obs_matches_jax():
    rng = np.random.default_rng(1)
    obs = [{"depth": rng.uniform(size=(4, 4, 1)), "ids": rng.integers(0, 9, (3,)),
            "rgb": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)} for _ in range(3)]
    want = jcommon.batch_obs(obs)
    for source in (obs, [{k: torch.as_tensor(v) for k, v in o.items()} for o in obs]):
        got = tcommon.batch_obs(source, device="cpu")
        for k, w in want.items():
            assert got[k].numpy().dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
    with pytest.raises(RuntimeError, match="device='cpu'") if not torch.cuda.is_available() else nullcontext():
        tcommon.batch_obs(obs)


def test_action_space_helpers(tmp_path):
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=1, episodes_per_scene=2, seed=0)
    nav = make_nav_env(scenes, episodes, num_envs=2, precomputed_fields=fields, device="cpu",
                       sensor_specs=(("PointGoalWithGPSCompassSensor", None),))
    arm = make_rearrange_env(num_envs=2, task="pick", num_scenes=1, episodes_per_scene=2, with_visual=False,
                             control="arm", device="cpu")
    assert tcommon.get_num_actions(nav) == jcommon.get_num_actions(spaces.Discrete(nav.num_actions)) == 4
    assert tcommon.get_num_actions(arm) == jcommon.get_num_actions(spaces.Box(-1, 1, (arm.action_dim,)))
    assert tcommon.get_num_actions({"a": nav, "b": arm}) == jcommon.get_num_actions(
        spaces.Dict({"a": spaces.Discrete(4), "b": spaces.Box(-1, 1, (arm.action_dim,))}))
    assert not tcommon.is_continuous_action_space(nav) and tcommon.is_continuous_action_space(arm)
    assert jcommon.is_continuous_action_space(spaces.Box(-1, 1, (3,)))
    with pytest.raises(NotImplementedError):
        tcommon.get_num_actions(object())
    with tcommon.inference_mode():
        assert torch.is_inference_mode_enabled()
    tcommon.generate_video(["disk"], str(tmp_path), [np.zeros((4, 4, 3), np.uint8)], "0", 0, {"spl": 1.0})
    assert os.listdir(tmp_path) == ["episode=0-ckpt=0-spl=1.00.gif"]


@pytest.mark.parametrize("greater_than", [True, False])
def test_lagrange_coefficient_matches_jax(greater_than):
    kw = dict(threshold=0.3, init_alpha=0.5, alpha_min=1e-3, alpha_max=0.9, greater_than=greater_than)
    j, t = jcommon.LagrangeInequalityCoefficient(**kw), tcommon.LagrangeInequalityCoefficient(**kw)
    values = np.random.default_rng(2).normal(0.3, 2.0, 50)
    for v in values:
        assert t.lagrangian_loss_and_update(float(v), lr=0.05) == j.lagrangian_loss_and_update(float(v), lr=0.05)
        assert t.log_alpha == j.log_alpha and t.alpha() == j.alpha()
    assert t.log_alpha in (t.log_alpha_min, t.log_alpha_max) or t.log_alpha_min < t.log_alpha < t.log_alpha_max
    la = torch.tensor(float(np.log(0.5)), dtype=torch.float64)
    f = float(np.log(0.5))
    for v in values:
        la, f = t.ascend(la, torch.tensor(float(v), dtype=torch.float64), 0.05), t.ascend(f, float(v), 0.05)
        assert la.item() == f


def test_profiling_ranges_in_a_trace(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with prof.RangeContext("habitat_range_ctx"):
            torch.ones(4).sum()
        prof.range_push("habitat_range_push")
        torch.ones(4).sum()
        prof.range_pop()
    names = {e.key for e in p.key_averages()}
    assert {"habitat_range_ctx", "habitat_range_push"} <= names
    prof.range_pop()  # nothing open: no effect
    # a capture window of steps 2-3
    prof.configure(capture_start_step=prof._step + 2, num_steps_to_capture=2, trace_dir=str(tmp_path))
    try:
        for _ in range(5):
            prof.on_start_step()
            with prof.RangeContext("habitat_step"):
                torch.ones(8).sum()
    finally:
        prof.configure()
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "habitat_step" for e in events) == 2
