"""habitat_torch's CLIP-RN50 encoder, SimpleCNN, running mean and variance,
``build_rnn_state_encoder``, ``Challenge`` and the top-level names against
habitat_tpu on the CPU.

- ``clip_preprocess`` equals JAX's within 5e-5 on 128x128 frames (upscaled
  to 224) and on 256x256 ones (shrunk to 224: JAX's bilinear resize
  antialiases, and so does the port's; without ``antialias`` the port parts
  from JAX by more than 0.05 there).
- ``ResNetCLIPEncoder`` on random weights carried from the Flax tree by
  ``convert.params_from_jax``: attnpool and avgpool, rgb only, depth only and
  both, at 128x128 and 256x256, at a narrow width (width 8, layers (1, 1, 1,
  1), 224 input; both packages' trunks narrowed so in this test only). The
  trunk runs in bfloat16 in both: every feature is held within 2**-6 of the
  largest |feature| (2 bf16 ulps; measured up to 0.0042 at a largest
  |feature| of 0.98, attnpool, and 7.7e-4 at 2.0, rgb + depth).
- The full RN50 trunk (layers (3, 4, 6, 3), width 64, 32 heads, embed 1024)
  at N=1: a random OpenAI-layout ``visual.*`` state dict written as ``.pt``
  and ``.npz`` and read by both packages' ``load_clip_rn50_weights`` gives
  the same attnpool features within the same rule (measured 0.0093 at a
  largest |feature| of 1.88).
- A PPO update of a ``resnet50_clip_attnpool`` policy leaves every trunk
  weight bit-unchanged (no gradient reaches it) while visual_fc moves.
- ``SimpleCNN`` (bf16 convs) within 2**-6 of its largest output;
  ``update_running_stats`` / ``normalize`` within 1e-6;
  ``build_rnn_state_encoder`` (LSTM and GRU, sequence mode with resets)
  within 1e-5.
- ``Challenge.submit`` on a small config file named by
  ``CHALLENGE_CONFIG_FILE`` equals JAX's metrics within 1e-5; ``import
  habitat_torch`` imports no torch, and every top-level name loads without
  initialising CUDA.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import habitat_tpu.models.clip_resnet as jclip
from habitat_tpu.models import running_mean_and_var as jrmv
from habitat_tpu.models.policy import SimpleCNN as JaxSimpleCNN
from habitat_tpu.models.rnn_state_encoder import build_rnn_state_encoder as jax_build_rnn

from habitat_torch.models import clip_resnet as tclip
from habitat_torch.models import running_mean_and_var as trmv
from habitat_torch.models.convert import params_from_jax, simple_cnn_params_from_jax
from habitat_torch.models.policy import SimpleCNN
from habitat_torch.models.rnn_state_encoder import build_rnn_state_encoder
from tests.torch_jax_native import _jax_native  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(layers=(1, 1, 1, 1), width=8)
BF16_SPAN = 2.0 ** -6  # features held within this share of the largest |feature|


class _NarrowJaxTrunk(jclip.CLIPResNet):
    layers: tuple = NARROW["layers"]
    width: int = NARROW["width"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draw(shapes, seed=0):
    """Flax parameters for ``shapes`` drawn with numpy: kernels of variance
    1 / fan_in, batch-norm scales 1 + N(0, 0.1), variances 1 + |N(0, 0.1)|,
    the positional embedding N(0, 1 / C), everything else N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape)
        elif name == "scale":
            v = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        elif name == "var":
            v = 1.0 + np.abs(rng.normal(0.0, 0.1, leaf.shape))
        elif name == "positional_embedding":
            v = rng.normal(0.0, 1.0 / np.sqrt(leaf.shape[-1]), leaf.shape)
        else:
            v = rng.normal(0.0, 0.1, leaf.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _within_bf16(got, ref):
    span = BF16_SPAN * np.abs(ref).max()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= span, (np.abs(got - ref).max(), span)


def _frames(size, n=2, seed=1):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "depth": rng.random((n, size, size, 1), dtype=np.float32)}


@pytest.mark.parametrize("size", [128, 256])
def test_preprocess_matches_jax(size):
    obs = _frames(size)
    depth3 = np.repeat(obs["depth"], 3, axis=-1)
    for x in (obs["rgb"], depth3):
        ref = np.asarray(jax.jit(jclip.clip_preprocess)(jnp.asarray(x)))
        got = tclip.clip_preprocess(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)
    if size == 256:  # the shrink needs the antialiased filter
        x = torch.from_numpy(obs["rgb"]).float().permute(0, 3, 1, 2) / 255.0
        plain = torch.nn.functional.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False)
        mean = torch.tensor(tclip.CLIP_MEAN).view(1, 3, 1, 1)
        std = torch.tensor(tclip.CLIP_STD).view(1, 3, 1, 1)
        ref = np.asarray(jclip.clip_preprocess(jnp.asarray(obs["rgb"])))
        assert np.abs(((plain - mean) / std).permute(0, 2, 3, 1).numpy() - ref).max() > 0.05


CASES = [(128, ("rgb",), "attnpool"), (128, ("rgb",), "avgpool"), (128, ("depth",), "attnpool"),
         (128, ("depth",), "avgpool"), (128, ("rgb", "depth"), "attnpool"), (256, ("rgb",), "attnpool"),
         (256, ("rgb", "depth"), "avgpool")]


@pytest.mark.parametrize("size,keys,pooling", CASES, ids=lambda c: str(c).replace("'", ""))
def test_encoder_matches_jax(size, keys, pooling):
    obs = {k: v for k, v in _frames(size).items() if k in keys}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jclip, "CLIPResNet", _NarrowJaxTrunk)
        jm = jclip.ResNetCLIPEncoder(pooling=pooling)
        params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), obs))
        ref = np.asarray(jax.jit(jm.apply)(params, obs))
    flat = {f"net/clip_encoder/{k}": np.asarray(v) for k, v in flatten_dict(params["params"], sep="/").items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tclip, "CLIPResNet", functools.partial(tclip.CLIPResNet, **NARROW))
        enc = tclip.ResNetCLIPEncoder(pooling, keys)
    enc.load_state_dict({k[len("net.encoder."):]: v for k, v in params_from_jax(flat).items()})
    got = enc({k: torch.from_numpy(v) for k, v in obs.items()})
    assert got.dtype == torch.float32 and not got.requires_grad
    _within_bf16(got.numpy(), ref)


def _openai_state_dict(seed=0):
    """A random RN50 ``visual.*`` state dict in OpenAI's names (the port's
    own module names), with BatchNorm's ``num_batches_tracked``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tclip.CLIPResNet().state_dict().items():
        if k.endswith("running_var"):
            a = 1.0 + np.abs(rng.normal(0.0, 0.1, v.shape))
        elif k.endswith("positional_embedding"):
            a = rng.normal(0.0, 1.0 / np.sqrt(v.shape[-1]), v.shape)
        elif v.dim() >= 2:
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(v.shape[1:])), v.shape)
        elif "bn" in k and k.endswith("weight") or k.endswith("downsample.1.weight"):
            a = 1.0 + rng.normal(0.0, 0.1, v.shape)
        else:
            a = rng.normal(0.0, 0.1, v.shape)
        sd[f"visual.{k}"] = a.astype(np.float32)
        if k.endswith("running_var"):
            sd[f"visual.{k[:-len('running_var')]}num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def test_rn50_weights_load_like_jax(tmp_path):
    sd = _openai_state_dict()
    npz, pt = str(tmp_path / "rn50.npz"), str(tmp_path / "rn50.pt")
    np.savez(npz, **sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    img = _frames(128, n=1)["rgb"]
    jm = jclip.CLIPResNet()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    params = jclip.load_clip_rn50_weights(jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), npz)
    ref = np.asarray(jax.jit(jm.apply)(params, jclip.clip_preprocess(jnp.asarray(img))))
    x = tclip.clip_preprocess(torch.from_numpy(img))
    for path in (pt, npz):
        trunk = tclip.load_clip_rn50_weights(tclip.CLIPResNet(), path)
        assert not any(p.requires_grad for p in trunk.parameters())
        with torch.no_grad():
            _within_bf16(trunk(x).numpy(), ref)
    with pytest.raises(FileNotFoundError):
        tclip.load_clip_rn50_weights(tclip.CLIPResNet(), str(tmp_path / "missing.pt"))
    assert tclip.ResNetCLIPEncoder.output_dim({"rgb"}, "attnpool") == 1024
    assert tclip.ResNetCLIPEncoder.output_dim({"rgb", "depth"}) == 2048


def test_ppo_update_leaves_the_trunk_unchanged():
    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.models.policy import make_pointnav_resnet_policy

    scenes, eps, fields = make_procedural_pointnav(num_scenes=1, episodes_per_scene=2, seed=0)
    env = make_nav_env(scenes, eps, 2, precomputed_fields=fields, device="cpu",
                       sensor_specs=(("HabitatSimDepthSensor", {"height": 32, "width": 32}),
                                     ("PointGoalWithGPSCompassSensor", None)))
    policy = make_pointnav_resnet_policy(env.num_actions, visual_inputs=("depth",), backbone="resnet50_clip_attnpool",
                                         hidden_size=32, device="cpu")
    trunk = policy.net.encoder.backbone
    assert isinstance(trunk, tclip.CLIPResNet) and policy.net.visual_fc.in_features == 1024
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    learner = PPOLearner(env, policy, PPOConfig(num_steps=2, ppo_epoch=1, num_mini_batch=1))
    learner.train_step(learner.init(seed=0))
    after = policy.state_dict()
    for k, v in trunk.state_dict().items():
        assert torch.equal(after[f"net.encoder.backbone.{k}"], before[f"net.encoder.backbone.{k}"]), k
    assert all(p.grad is None and not p.requires_grad for p in trunk.parameters())
    assert not torch.equal(after["net.visual_fc.weight"], before["net.visual_fc.weight"])


def test_simple_cnn_matches_jax():
    obs = {k: v[..., :3] for k, v in _frames(32).items()}
    jm = JaxSimpleCNN(output_size=64)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), obs))
    ref = np.asarray(jax.jit(jm.apply)(params, obs))
    m = SimpleCNN(("rgb", "depth"), (32, 32), output_size=64)
    m.load_state_dict(simple_cnn_params_from_jax({k: np.asarray(v) for k, v in
                                                  flatten_dict(params["params"], sep="/").items()}))
    with torch.no_grad():
        _within_bf16(m({k: torch.from_numpy(v) for k, v in obs.items()}).numpy(), ref)


def test_running_stats_match_jax():
    rng = np.random.default_rng(3)
    js, ts = jrmv.init_running_stats(5), trmv.init_running_stats(5, device="cpu")
    for shape in ((4, 7, 5), (3, 5)):
        x = (rng.normal(size=shape) * 2 + 1).astype(np.float32)
        js, ts = jrmv.update_running_stats(js, jnp.asarray(x)), trmv.update_running_stats(ts, torch.from_numpy(x))
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trmv.normalize(ts, torch.from_numpy(x)).numpy(),
                               np.asarray(jrmv.normalize(js, jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rnn_type", ["LSTM", "gru"])
def test_build_rnn_state_encoder_matches_jax(rnn_type):
    rng = np.random.default_rng(4)
    T, N, D, H, L = 3, 2, 6, 8, 2
    x = rng.normal(size=(T, N, D)).astype(np.float32)
    masks = np.array([[1, 1], [0, 1], [1, 0]], np.float32)
    jm = jax_build_rnn(D, H, rnn_type, num_layers=L)
    S = 2 if rnn_type.upper() == "LSTM" else 1
    hidden = rng.normal(size=(N, L, S, H)).astype(np.float32)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, hidden, masks))
    ref_out, ref_h = jax.jit(jm.apply)(params, x, hidden, masks)
    flat = {f"net/RNNStateEncoder_0/{k}": np.asarray(v) for k, v in flatten_dict(params["params"], sep="/").items()}
    m = build_rnn_state_encoder(D, H, rnn_type, num_layers=L)
    m.load_state_dict({k[len("net.rnn."):]: v for k, v in params_from_jax(flat).items()})
    with torch.no_grad():
        out, h = m(torch.from_numpy(x), torch.from_numpy(hidden), torch.from_numpy(masks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=0, atol=1e-5)


CHALLENGE_YAML = """# @package _global_
defaults:
  - /habitat: habitat_config_base
  - /habitat/task: pointnav
  - /habitat/simulator/sensor_setups@habitat.simulator.agents.main_agent: depth_agent
  - /habitat/dataset/pointnav: procedural
  - _self_

habitat:
  environment:
    max_episode_steps: 20
  dataset:
    procedural:
      num_scenes: 1
      episodes_per_scene: 2
  simulator:
    agents:
      main_agent:
        sim_sensors:
          depth_sensor:
            width: 32
            height: 32
"""


def test_challenge_matches_jax(tmp_path, monkeypatch):
    from habitat_tpu.baselines.agents import simple_agents as jsimple
    from habitat_tpu.core.benchmark import Challenge as JaxChallenge

    from habitat_torch.baselines.agents import simple_agents as tsimple
    from habitat_torch.core.benchmark import Challenge

    path = tmp_path / "challenge.yaml"
    path.write_text(CHALLENGE_YAML)
    monkeypatch.setenv("CHALLENGE_CONFIG_FILE", str(path))
    got = Challenge(device="cpu").submit(tsimple.GoalFollower())
    want = JaxChallenge().submit(jsimple.GoalFollower())
    assert set(got) == set(want) and "spl" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


_TOP_LEVEL = """
import sys
import habitat_torch
cheap = "torch" not in sys.modules
names = {n: getattr(habitat_torch, n) for n in habitat_torch.__all__}
import torch
from habitat_torch.core.vector_env import ThreadedVectorEnv
from habitat_torch.core.benchmark import Challenge
ok = names["ThreadedVectorEnv"] is ThreadedVectorEnv and names["Challenge"] is Challenge
print(cheap, ok, torch.cuda.is_initialized(), sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "habitat_tpu")))
"""


def test_top_level_names():
    out = subprocess.run([sys.executable, "-c", _TOP_LEVEL], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["True", "True", "False", "[]"], out.stdout
