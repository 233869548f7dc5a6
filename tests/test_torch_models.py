"""habitat_torch policy against habitat_tpu's Flax modules, with the Flax
parameters converted by ``habitat_torch.models.convert.params_from_jax``.

- ``ResNetEncoder`` in float32 on both sides: relative error 1e-4 of the
  output's scale (float32 convolutions summed in different orders).
- The bf16 ``ActorCritic`` (convs and block GroupNorms in bfloat16 with
  float32 statistics, as the JAX package runs it): bf16 rounds activations
  to 8 mantissa bits at every conv and norm, and the two frameworks round at
  the same places but accumulate in different orders, so logits and values
  agree to 3e-2 absolute (their spread is O(1)); the LSTM state to 3e-2.
- The trained flagship checkpoint (depth-only, 128x128), restored with
  orbax as scripts/eval_flagship_ckpt.py does, under the same bf16 bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
from habitat_tpu.models.resnet import ResNetEncoder as JaxEncoder
from habitat_tpu.models.rnn_state_encoder import initial_hidden_state

from habitat_torch.models.convert import params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy
from habitat_torch.models.resnet import ResNetEncoder

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ckpts", "flagship_params")
BF16_ATOL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _obs(rng, n, hw, keys=("rgb", "depth", "pointgoal_with_gps_compass")):
    obs = {}
    if "rgb" in keys:
        obs["rgb"] = rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8)
    if "depth" in keys:
        obs["depth"] = rng.uniform(0, 1, (n, *hw, 1)).astype(np.float32)
    if "pointgoal_with_gps_compass" in keys:
        obs["pointgoal_with_gps_compass"] = np.stack(
            [rng.uniform(0.5, 8, n), rng.uniform(-np.pi, np.pi, n)], -1
        ).astype(np.float32)
    return obs


def _perturb_affine(params, rng):
    """Flax inits biases to 0 and GroupNorm scales to 1: perturb them so the
    conversion of every leaf is exercised."""
    flat = traverse_util.flatten_dict(params, sep="/")
    for k, v in flat.items():
        if k.endswith("bias") or k.endswith("scale"):
            flat[k] = v + jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
    return traverse_util.unflatten_dict(flat, sep="/")


def _flat_np(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _torch_obs(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


def test_resnet_encoder_f32_matches():
    rng = np.random.default_rng(0)
    obs = _obs(rng, 2, (64, 64), keys=("rgb", "depth"))
    enc = JaxEncoder(dtype=jnp.float32)
    params = _perturb_affine(enc.init(jax.random.PRNGKey(0), obs)["params"], rng)
    ref = np.asarray(enc.apply({"params": params}, obs))
    flat = {f"net/ResNetEncoder_0/{k}": v for k, v in _flat_np(params).items()}
    sd = {k[len("net.encoder."):]: v for k, v in params_from_jax(flat).items()}
    port = ResNetEncoder(("rgb", "depth"), (64, 64), dtype=torch.float32)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(_torch_obs(obs)).numpy()
    assert got.shape == ref.shape == (2, 2 * 2 * 512)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _compare_policy(jpol, params, tpol, obs, hidden, prev, masks):
    ref_logits, ref_values, ref_hidden = jpol.apply(params, obs, hidden, prev, masks)
    tpol.load_state_dict(params_from_jax(_flat_np(params["params"])))
    with torch.no_grad():
        logits, values, new_hidden = tpol(
            _torch_obs(obs), torch.from_numpy(np.array(hidden)),
            torch.from_numpy(prev), torch.from_numpy(masks),
        )
    assert np.abs(logits.numpy() - np.asarray(ref_logits)).max() < BF16_ATOL
    assert np.abs(values.numpy() - np.asarray(ref_values)).max() < BF16_ATOL
    assert np.abs(new_hidden.numpy() - np.asarray(ref_hidden)).max() < BF16_ATOL
    assert np.ptp(np.asarray(ref_logits)) > 10 * BF16_ATOL or np.ptp(np.asarray(ref_values)) > 10 * BF16_ATOL


def test_actor_critic_bf16_matches():
    rng = np.random.default_rng(1)
    n, hw = 4, (64, 64)
    obs = _obs(rng, n, hw)
    hidden = jnp.asarray(rng.normal(0, 0.5, (n, 1, 2, 512)).astype(np.float32))
    prev = np.array([0, 1, 2, 3], np.int32)
    masks = np.array([1, 0, 1, 1], np.float32)
    jpol = jax_policy(4, backbone="resnet18", hidden_size=512)
    params = jpol.init(jax.random.PRNGKey(2), obs, hidden, jnp.asarray(prev), jnp.asarray(masks))
    params = {"params": _perturb_affine(params["params"], rng)}
    tpol = make_pointnav_resnet_policy(4, input_hw=hw, device="cpu")
    _compare_policy(jpol, params, tpol, obs, hidden, prev, masks)


def test_rearrange_policy_bf16_matches():
    """Vision Pick's policy (resnet9, LSTM-128, no goal sensor): the head
    cameras as rgb/depth and the six rearrangement state sensors, each
    through its own Dense(32) in the JAX package's key order; keys the net
    does not read ride along in the observations."""
    from habitat_torch.models.policy import STATE_KEYS

    rng = np.random.default_rng(3)
    n, hw = 4, (64, 64)
    img = _obs(rng, n, hw, keys=("rgb", "depth"))
    obs = {"robot_head_rgb": img["rgb"], "robot_head_depth": img["depth"]}
    widths = dict(obj_start_sensor=3, obj_goal_sensor=3, joint=7, is_holding=1, ee_pos=3,
                  relative_resting_position=3, abs_obj_start_sensor=3, localization_sensor=4)
    for k, w in widths.items():
        obs[k] = rng.normal(0, 1, (n, w)).astype(np.float32)
    hidden = jnp.asarray(rng.normal(0, 0.5, (n, 1, 2, 128)).astype(np.float32))
    prev = np.array([0, 4, 2, 3], np.int32)
    masks = np.array([1, 0, 1, 1], np.float32)
    jpol = jax_policy(5, backbone="resnet9", hidden_size=128, goal_keys=())
    params = jpol.init(jax.random.PRNGKey(4), obs, hidden, jnp.asarray(prev), jnp.asarray(masks))
    params = {"params": _perturb_affine(params["params"], rng)}
    state_keys = {k: widths[k] for k in reversed(STATE_KEYS)}  # declared in any order
    tpol = make_pointnav_resnet_policy(5, backbone="resnet9", hidden_size=128, goal_keys=(), input_hw=hw,
                                       state_keys=state_keys, device="cpu")
    assert tpol.net.state_keys == STATE_KEYS
    _compare_policy(jpol, params, tpol, obs, hidden, prev, masks)


def test_flagship_checkpoint_converts():
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(2)
    n, hw = 2, (128, 128)
    obs = _obs(rng, n, hw, keys=("depth", "pointgoal_with_gps_compass"))
    hidden = initial_hidden_state(n, 512)
    prev = np.zeros(n, np.int32)
    masks = np.zeros(n, np.float32)
    jpol = jax_policy(4, backbone="resnet18", hidden_size=512)
    abstract = jax.eval_shape(
        lambda k: jpol.init(k, obs, hidden, jnp.asarray(prev), jnp.asarray(masks)),
        jax.random.PRNGKey(1),
    )
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=cpu), abstract)
    params = ocp.StandardCheckpointer().restore(CKPT, abstract)
    tpol = make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=hw, device="cpu")
    _compare_policy(jpol, params, tpol, obs, hidden, prev, masks)


# -- ObjectNav, ImageNav and the Gaussian actor-critic -----------------------


def _state_obs(rng, n, widths):
    return {k: rng.normal(0, 1, (n, w)).astype(np.float32) for k, w in widths.items()}


def _compare_gaussian(jpol, params, tpol, obs, hidden, prev, masks, atol):
    """mu, log_std, value and hidden state within ``atol``."""
    (ref_mu, ref_log_std), ref_values, ref_hidden = jpol.apply(params, obs, hidden, prev, masks)
    tpol.load_state_dict(params_from_jax(_flat_np(params["params"])))
    with torch.no_grad():
        (mu, log_std), values, new_hidden = tpol(
            _torch_obs(obs), torch.from_numpy(np.array(hidden)), torch.from_numpy(prev), torch.from_numpy(masks),
        )
    for name, got, ref in (("mu", mu, ref_mu), ("log_std", log_std, ref_log_std), ("value", values, ref_values),
                           ("hidden", new_hidden, ref_hidden)):
        assert tuple(got.shape) == np.asarray(ref).shape, name
        assert np.abs(got.numpy() - np.asarray(ref)).max() < atol, name
    return np.asarray(ref_mu), np.asarray(ref_log_std)


def _perturbed(jpol, obs, hidden, prev, masks, rng, seed):
    params = jpol.init(jax.random.PRNGKey(seed), obs, hidden, jnp.asarray(prev), jnp.asarray(masks))
    return {"params": _perturb_affine(params["params"], rng)}


def test_objectnav_policy_bf16_matches():
    """ObjectNav's net: rgb + depth, the objectgoal id through goal_fc (its
    one float) and through objectgoal_embed, gps and compass through
    state_fc ahead of the rearrangement keys, 6 actions."""
    rng = np.random.default_rng(5)
    n, hw = 4, (64, 64)
    obs = _obs(rng, n, hw, keys=("rgb", "depth"))
    obs.update(_state_obs(rng, n, dict(gps=2, compass=1)))
    obs["objectgoal"] = np.array([[0], [5], [21], [7]], np.int32)
    hidden = jnp.asarray(rng.normal(0, 0.5, (n, 1, 2, 128)).astype(np.float32))
    prev, masks = np.array([0, 5, 4, 3], np.int32), np.array([1, 1, 0, 1], np.float32)
    jpol = jax_policy(6, backbone="resnet9", hidden_size=128, goal_keys=("objectgoal",))
    params = _perturbed(jpol, obs, hidden, prev, masks, rng, 6)
    assert {"goal_fc_objectgoal", "objectgoal_embed", "state_fc_gps", "state_fc_compass"} <= set(params["params"]["net"])
    tpol = make_pointnav_resnet_policy(6, backbone="resnet9", hidden_size=128, goal_keys=("objectgoal",), input_hw=hw,
                                       state_keys={"compass": 1, "gps": 2}, objectgoal_embed=True, device="cpu")
    assert tpol.net.state_keys == ("gps", "compass")
    _compare_policy(jpol, params, tpol, obs, hidden, prev, masks)


def test_imagenav_policy_bf16_matches():
    """ImageNav's net: the rgb encoder and a second encoder over the goal
    image (goal_encoder_imagegoal + goal_visual_fc_imagegoal), no goal_fc
    (the recipe's goal_keys=()), gps and compass."""
    rng = np.random.default_rng(6)
    n, hw = 4, (64, 64)
    obs = _obs(rng, n, hw, keys=("rgb",))
    obs["imagegoal"] = rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8)
    obs.update(_state_obs(rng, n, dict(gps=2, compass=1)))
    hidden = jnp.asarray(rng.normal(0, 0.5, (n, 1, 2, 128)).astype(np.float32))
    prev, masks = np.array([3, 0, 2, 1], np.int32), np.array([0, 1, 1, 1], np.float32)
    jpol = jax_policy(4, backbone="resnet9", hidden_size=128, goal_keys=())
    params = _perturbed(jpol, obs, hidden, prev, masks, rng, 7)
    assert {"goal_encoder_imagegoal", "goal_visual_fc_imagegoal"} <= set(params["params"]["net"])
    tpol = make_pointnav_resnet_policy(4, backbone="resnet9", hidden_size=128, goal_keys=(), input_hw=hw,
                                       visual_inputs=("rgb",), image_goals={"imagegoal": hw},
                                       state_keys={"gps": 2, "compass": 1}, device="cpu")
    _compare_policy(jpol, params, tpol, obs, hidden, prev, masks)


ARM_WIDTHS = dict(joint=7, ee_pos=3, is_holding=1, obj_start_sensor=3, relative_resting_position=3)


@pytest.mark.parametrize("visual", [False, True], ids=["blind", "visual"])
def test_gaussian_policy_matches(visual):
    """The Gaussian actor-critic: the blind arm-Pick net (state sensors
    only; no bf16 layer, so within 1e-5) and the visual one (head cameras;
    BF16_ATOL); the previous (N, 10) action through prev_action_fc,
    unmasked; log_std perturbed beyond the clip, mu's kernel scaled up 100x
    so that mu spreads as logits do."""
    from habitat_tpu.models.policy import make_gaussian_resnet_policy as jax_gaussian

    from habitat_torch.models.policy import GaussianActorCritic, make_gaussian_resnet_policy

    rng = np.random.default_rng(7 + visual)
    n, hw, A = 4, (32, 32), 10
    obs = _state_obs(rng, n, ARM_WIDTHS)
    if visual:
        img = _obs(rng, n, hw, keys=("rgb", "depth"))
        obs.update(robot_head_rgb=img["rgb"], robot_head_depth=img["depth"])
    hidden = jnp.asarray(rng.normal(0, 0.5, (n, 1, 2, 128)).astype(np.float32))
    prev = rng.uniform(-1, 1, (n, A)).astype(np.float32)
    masks = np.array([1, 0, 1, 1], np.float32)
    jpol = jax_gaussian(A, backbone="resnet9", hidden_size=128, has_visual=visual)
    params = _perturbed(jpol, obs, hidden, prev, masks, rng, 8)
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    flat["action_head/log_std"] = jnp.asarray(np.linspace(-6.0, 2.5, A).astype(np.float32))
    flat["action_head/Dense_0/kernel"] = flat["action_head/Dense_0/kernel"] * 100.0
    params = {"params": traverse_util.unflatten_dict(flat, sep="/")}
    assert ("net/Dense_0/kernel" in flat) == visual and "net/prev_action_fc/kernel" in flat
    tpol = make_gaussian_resnet_policy(A, backbone="resnet9", hidden_size=128, has_visual=visual, input_hw=hw,
                                       state_keys=ARM_WIDTHS, device="cpu")
    assert isinstance(tpol, GaussianActorCritic) and (tpol.net.encoder is not None) == visual
    mu, log_std = _compare_gaussian(jpol, params, tpol, obs, hidden, prev, masks, BF16_ATOL if visual else 1e-5)
    assert log_std.min() == -5.0 and log_std.max() == 2.0 and np.ptp(mu) > 10 * BF16_ATOL


def test_normalize_visual_inputs_f32_matches():
    """Per-image standardisation before the ResNet, float32 on both sides."""
    rng = np.random.default_rng(9)
    obs = _obs(rng, 2, (64, 64), keys=("rgb", "depth"))
    enc = JaxEncoder(backbone="resnet9", normalize_visual_inputs=True, dtype=jnp.float32)
    params = _perturb_affine(enc.init(jax.random.PRNGKey(0), obs)["params"], rng)
    ref = np.asarray(enc.apply({"params": params}, obs))
    flat = {f"net/ResNetEncoder_0/{k}": v for k, v in _flat_np(params).items()}
    sd = {k[len("net.encoder."):]: v for k, v in params_from_jax(flat).items()}
    port = ResNetEncoder(("rgb", "depth"), (64, 64), backbone="resnet9", dtype=torch.float32,
                         normalize_visual_inputs=True)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(_torch_obs(obs)).numpy()
    plain = ResNetEncoder(("rgb", "depth"), (64, 64), backbone="resnet9", dtype=torch.float32)
    plain.load_state_dict(sd)
    with torch.no_grad():
        assert np.abs(plain(_torch_obs(obs)).numpy() - got).max() > 1e-2 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_gaussian_log_prob_and_entropy_match():
    """float32 at atol 1e-5: evaluate_gaussian_actions, and the log prob of
    sample_gaussian_action's own draw (and of mu when deterministic)."""
    from habitat_tpu.models.policy import evaluate_gaussian_actions as jax_evaluate
    from habitat_tpu.models.policy import sample_gaussian_action as jax_sample

    from habitat_torch.models.policy import evaluate_gaussian_actions, sample_gaussian_action

    rng = np.random.default_rng(10)
    mu = rng.normal(0, 1, (2, 8, 10)).astype(np.float32)
    log_std = np.broadcast_to(rng.uniform(-5, 2, 10).astype(np.float32), mu.shape).copy()
    actions = (mu + rng.normal(0, 2, mu.shape)).astype(np.float32)
    ref = jax_evaluate(jnp.asarray(mu), jnp.asarray(log_std), jnp.asarray(actions))
    got = evaluate_gaussian_actions(*(torch.from_numpy(a) for a in (mu, log_std, actions)))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (2, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    for det in (False, True):
        act, logp = sample_gaussian_action(torch.from_numpy(mu[0]), torch.from_numpy(log_std[0]), gen, det)
        assert act.dtype == torch.float32 and torch.equal(act, torch.from_numpy(mu[0])) == det
        _, ref_logp = jax_sample(jnp.asarray(mu[0]), jnp.asarray(log_std[0]), jax.random.PRNGKey(0), True)
        want = np.asarray(jax_evaluate(jnp.asarray(mu[0]), jnp.asarray(log_std[0]), jnp.asarray(act.numpy()))[0])
        np.testing.assert_allclose(logp.numpy(), want, rtol=1e-6, atol=1e-5)
        if det:
            np.testing.assert_allclose(logp.numpy(), np.asarray(ref_logp), rtol=1e-6, atol=1e-5)


# -- bottleneck backbones, the GRU state encoder, the sown features ---------------


def _random_tree(shapes, rng):
    """Values for a Flax parameter tree of ``shapes`` (from
    ``jax.eval_shape`` of the module's init; compiling every bottleneck
    backbone's init would cost a minute): kernels normal with variance
    1/fan_in, GroupNorm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    flat = traverse_util.flatten_dict(shapes, sep="/")
    out = {}
    for k, s in flat.items():
        if k.endswith("kernel"):
            out[k] = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif k.endswith("scale"):
            out[k] = 1 + rng.normal(0, 0.1, s.shape)
        else:
            out[k] = rng.normal(0, 0.1, s.shape)
    return traverse_util.unflatten_dict({k: jnp.asarray(v, jnp.float32) for k, v in out.items()}, sep="/")


@pytest.mark.parametrize("backbone", ["resnet50", "resneXt50", "se_resnet50", "se_resneXt50", "se_resneXt101"])
def test_bottleneck_backbone_f32_matches(backbone):
    """Every bottleneck spec of the JAX package (Bottleneck blocks, 32-way
    grouped 3x3 convs, squeeze-excitation), its parameter tree converted,
    in float32 on both sides at 32x32: relative error 1e-4 of the output's
    scale, as the basic-block encoder's."""
    from habitat_tpu.models.resnet import SPECS as JAX_SPECS

    from habitat_torch.models.resnet import SPECS

    rng = np.random.default_rng(9)
    obs = _obs(rng, 2, (32, 32), keys=("depth",))
    enc = JaxEncoder(backbone=backbone, base_planes=32, ngroups=8, dtype=jnp.float32)
    params = _random_tree(jax.eval_shape(enc.init, jax.random.PRNGKey(0), obs)["params"], rng)
    ref = np.asarray(jax.jit(enc.apply)({"params": params}, obs))
    flat = {f"net/ResNetEncoder_0/{k}": v for k, v in _flat_np(params).items()}
    sd = {k[len("net.encoder."):]: v for k, v in params_from_jax(flat).items()}
    port = ResNetEncoder(("depth",), (32, 32), backbone=backbone, base_planes=32, ngroups=8, dtype=torch.float32)
    port.load_state_dict(sd)  # strict: every port parameter has its Flax counterpart
    spec = JAX_SPECS[backbone]
    assert SPECS[backbone].layers == spec.layers and port.backbone.out_channels == 256 * spec.expansion
    with torch.no_grad():
        got = port(_torch_obs(obs)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_policy_matches(layers):
    """rnn_type="GRU": Flax's GRUCell (biases on ir, iz, in and hn) per
    layer, hidden state (N, L, 1, H), in the act step and in sequence mode
    with episode starts inside the sequence; blind, so float32 throughout
    (within 1e-5)."""
    from habitat_tpu.models.rnn_state_encoder import initial_hidden_state as jax_hidden

    rng = np.random.default_rng(10 + layers)
    n, T, H = 4, 5, 64
    jpol = jax_policy(4, backbone="resnet9", hidden_size=H, rnn_type="GRU", num_recurrent_layers=layers,
                      has_visual=False)
    obs1 = _obs(rng, n, (8, 8), keys=("pointgoal_with_gps_compass",))
    hidden = jnp.asarray(rng.normal(0, 0.5, (n, layers, 1, H)).astype(np.float32))
    assert jax_hidden(n, H, layers, "GRU").shape == hidden.shape
    prev, masks = np.array([0, 1, 2, 3], np.int32), np.array([1, 0, 1, 1], np.float32)
    params = _perturbed(jpol, obs1, hidden, prev, masks, rng, 11)
    assert {f"gru_{l}" for l in range(layers)} == set(params["params"]["net"]["RNNStateEncoder_0"])
    tpol = make_pointnav_resnet_policy(4, backbone="resnet9", hidden_size=H, rnn_type="GRU",
                                       num_recurrent_layers=layers, has_visual=False, device="cpu")
    assert tuple(tpol.initial_hidden(n).shape) == (n, layers, 1, H)
    compare = _compare_policy_f32(jpol, params, tpol)
    compare(obs1, hidden, prev, masks)
    seq = {k: np.stack([_obs(rng, n, (8, 8), keys=(k,))[k] for _ in range(T)]) for k in obs1}
    prev_s = rng.integers(0, 4, (T, n)).astype(np.int32)
    masks_s = (rng.random((T, n)) > 0.3).astype(np.float32)
    compare(seq, hidden, prev_s, masks_s)


def _compare_policy_f32(jpol, params, tpol):
    """A comparer of logits, values and hidden state within 1e-5."""
    tpol.load_state_dict(params_from_jax(_flat_np(params["params"])))

    def compare(obs, hidden, prev, masks):
        ref = jpol.apply(params, obs, hidden, jnp.asarray(prev), jnp.asarray(masks))
        with torch.no_grad():
            got = tpol(_torch_obs(obs), torch.from_numpy(np.array(hidden)), torch.from_numpy(prev),
                       torch.from_numpy(masks))
        for name, g, r in zip(("logits", "values", "hidden"), got, ref):
            assert tuple(g.shape) == np.asarray(r).shape, name
            assert np.abs(g.numpy() - np.asarray(r)).max() < 1e-5, name

    return compare


def test_policy_returns_the_sown_features():
    """``with_feats``: the visual embedding (Flax's sown ``visual_feats``,
    (T*N, H) in sequence mode) and the RNN output (``rnn_feats``), each
    equal to JAX's intermediates within the bf16 bound."""
    from habitat_tpu.baselines.ppo import _find_sow

    rng = np.random.default_rng(13)
    T, n, hw, H = 3, 2, (32, 32), 128
    obs = {k: np.stack([v] * T) for k, v in _obs(rng, n, hw).items()}
    hidden = jnp.asarray(rng.normal(0, 0.5, (n, 1, 2, H)).astype(np.float32))
    prev, masks = rng.integers(0, 4, (T, n)).astype(np.int32), np.ones((T, n), np.float32)
    jpol = jax_policy(4, backbone="resnet9", hidden_size=H)
    # initialised on one step (Flax cannot create parameters inside the sequence's scan)
    params = jax.jit(jpol.init)(jax.random.PRNGKey(14), {k: v[0] for k, v in obs.items()}, hidden,
                                jnp.asarray(prev[0]), jnp.asarray(masks[0]))
    params = {"params": _perturb_affine(params["params"], rng)}
    _, inter = jax.jit(lambda *a: jpol.apply(*a, mutable=["intermediates"]))(
        params, obs, hidden, jnp.asarray(prev), jnp.asarray(masks))
    tpol = make_pointnav_resnet_policy(4, backbone="resnet9", hidden_size=H, input_hw=hw, device="cpu")
    tpol.load_state_dict(params_from_jax(_flat_np(params["params"])))
    with torch.no_grad():
        out = tpol(_torch_obs(obs), torch.from_numpy(np.array(hidden)), torch.from_numpy(prev),
                   torch.from_numpy(masks), with_feats=True)
    assert len(out) == 5
    for got, name in ((out[3], "visual_feats"), (out[4], "rnn_feats")):
        ref = np.asarray(_find_sow(inter, name))
        assert tuple(got.shape) == ref.shape, name
        assert np.abs(got.numpy() - ref).max() < BF16_ATOL, name
