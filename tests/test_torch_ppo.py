"""habitat_torch's PPO update against habitat_tpu's on the same numpy inputs,
the policy's weights converted from Flax with ``params_from_jax``.

The port's stem max pool credits every tied input (``ops/pool.py``); the JAX
policy keeps ``flax.linen.max_pool``, whose gradient credits one. So the
JAX reference of the loss's gradient and of the update is the JAX loss with
``flax.linen.max_pool`` swapped, in this test only, for
``habitat_tpu.ops.pool.max_pool_3x3s2(x, True)`` (``_all_ties``); the
gradient of the unpatched JAX loss is compared too, and differs only in the
stem convolution and the stem GroupNorm.

Tolerances (T=4, N=4, 32x32 inputs, resnet18 + LSTM-512; the policy runs
in bf16 as deployed, or in float32 where the point is the algorithm; the
JAX policy's encoder is switched to float32 in this test only):
- GAE: the same float32 operations in order; equal to 1e-6 of the largest
  advantage (XLA may contract a multiply and an add into one rounding,
  which moves an element that cancels to near zero by an ulp).
- bf16 logits, values, hidden state and loss terms: ``BF16_ATOL`` (3e-2)
  of ``tests/test_torch_models.py``: both frameworks round to bf16 at every
  conv and norm, and accumulate in different orders; float32 loss terms
  within 1e-4.
- gradients in float32: every tensor within ``F32_GRAD_RTOL`` relative L2
  norm of the all-ties JAX gradient, the stem's included.
- gradients in bf16: the visual path's (encoder, visual_fc) differ from the
  float32 ones by 20-35% relative L2 norm in either framework on these
  inputs, so the port's must lie within ``BF16_NOISE_FACTOR`` times JAX's
  own bf16-to-float32 gap; the other parameters within ``GRAD_RTOL``.
  Against the unpatched JAX gradient: the same for every tensor outside
  the stem; the stem's gap is reported and bounded by ``STEM_GAP_RTOL``.
- one update (Adam), in float32 on both sides: each element within 2*lr per
  Adam step of the JAX parameters, and >= 99% of elements within lr/10
  (Adam's first steps move an element by about lr times the sign of its
  gradient; in bf16 the sign of the smallest gradients is noise: 0.956 of
  elements lie within lr/10 between the port and JAX, and 0.958 between
  JAX's own bf16 and float32 updates, on the rollout batch below).
- the PPOConfig switches (normalized advantage, linear LR decay, the inert
  clip decay) and the Gaussian policy's adaptive entropy on blind nets in
  float32, 2 epochs of 2 minibatches with JAX's permutations passed in:
  parameters at rtol 2e-4 / atol 2e-5 of JAX's update (no conv, so no
  tie for Adam to amplify); CPC|A alone (loss within 1e-6, gradients 1e-5
  relative L2) and in the update of a GRU policy (the update rule above).
"""

import contextlib
import functools
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from habitat_tpu.baselines.ppo import PPOConfig as JaxPPOConfig
from habitat_tpu.baselines.ppo import PPOLearner as JaxPPOLearner
from habitat_tpu.baselines.ppo import RolloutBatch as JaxRolloutBatch
from habitat_tpu.baselines.ppo import TrainState
from habitat_tpu.baselines.ppo import compute_gae as jax_compute_gae
import habitat_tpu.models.policy as jax_policy_module
from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
from habitat_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from habitat_tpu.ops.pool import max_pool_3x3s2 as jax_max_pool_3x3s2

from habitat_torch.baselines.ppo import PPOConfig, PPOLearner, RolloutBatch, compute_gae
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.models.convert import params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy
from habitat_torch.models.rnn_state_encoder import initial_hidden_state

from tests.test_torch_models import BF16_ATOL, _perturb_affine
from tests.torch_jax_native import _jax_native  # noqa: F401

T, N, HW, A, HIDDEN = 4, 4, 32, 4, 512
ATOL = {"float32": 1e-4, "bfloat16": BF16_ATOL}
F32_GRAD_RTOL = 1e-4
GRAD_RTOL = 5e-2
BF16_NOISE_FACTOR = 1.5
STEM_GAP_RTOL = 0.6
VISUAL = ("net.encoder.", "net.visual_fc.")
STEM = ("net.encoder.backbone.stem.", "net.encoder.backbone.stem_norm.")
# the LSTM's input bias: zero and untrained in the port, absent in Flax
FROZEN = "bias_ih"
SENSORS = (
    ("HabitatSimDepthSensor", {"height": HW, "width": HW}),
    ("HabitatSimRGBSensor", {"height": HW, "width": HW}),
    ("PointGoalWithGPSCompassSensor", None),
)


def _all_ties(x, window_shape, strides=None, padding="VALID"):
    assert tuple(window_shape) == (3, 3) and tuple(strides) == (2, 2) and padding == "SAME"
    return jax_max_pool_3x3s2(x, True)


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores:
    PyTorch's CPU kernels, one thread per core in each of them, then spend
    their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



# ---- inputs ----------------------------------------------------------------


def _bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _batch(seed):
    """A (T, N) rollout batch as numpy, with episode ends mid-sequence, the
    rollout's initial hidden state and the bootstrap value."""
    rng = np.random.default_rng(seed)
    dones = np.zeros((T, N), np.float32)
    dones[1, 0] = dones[2, 2] = dones[0, 3] = 1.0
    actions = rng.integers(0, A, (T, N)).astype(np.int32)
    masks = np.concatenate([rng.integers(0, 2, (1, N)), 1.0 - dones[:-1]]).astype(np.float32)
    prev = np.concatenate([rng.integers(0, A, (1, N)), actions[:-1]]).astype(np.int32)
    b = dict(
        obs=dict(
            rgb=rng.integers(0, 256, (T, N, HW, HW, 3)).astype(np.uint8),
            depth=_bf16_values(rng.uniform(0, 1, (T, N, HW, HW, 1)).astype(np.float32)),
            pointgoal_with_gps_compass=np.stack(
                [rng.uniform(0.5, 8, (T, N)), rng.uniform(-np.pi, np.pi, (T, N))], -1
            ).astype(np.float32),
        ),
        actions=actions,
        log_probs=(np.log(0.25) + rng.normal(0, 0.05, (T, N))).astype(np.float32),
        values=rng.normal(0, 1, (T, N)).astype(np.float32),
        rewards=rng.normal(0, 0.3, (T, N)).astype(np.float32),
        dones=dones,
        masks=masks,
        prev_actions=prev,
    )
    h0 = rng.normal(0, 0.5, (N, 1, 2, HIDDEN)).astype(np.float32)
    last_value = rng.normal(0, 1, N).astype(np.float32)
    return b, h0, last_value


def _jax_obs(obs):
    return {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "depth" else jnp.asarray(v) for k, v in obs.items()}


def _torch_obs(obs):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if k == "depth" else torch.from_numpy(v) for k, v in obs.items()}


def _jax_batch(b):
    return JaxRolloutBatch(obs=_jax_obs(b["obs"]), **{k: jnp.asarray(v) for k, v in b.items() if k != "obs"})


def _torch_batch(b):
    return RolloutBatch(obs=_torch_obs(b["obs"]), **{k: torch.from_numpy(v) for k, v in b.items() if k != "obs"})


def _minibatch(b, seed):
    """The loss's minibatch: the batch plus advantages and returns."""
    rng = np.random.default_rng(seed)
    mb = {k: v for k, v in b.items() if k not in ("rewards", "dones")}
    mb["advantages"] = rng.normal(0, 1, (T, N)).astype(np.float32)
    mb["returns"] = (b["values"] + rng.normal(0, 0.5, (T, N))).astype(np.float32)
    return mb


# ---- the two policies ------------------------------------------------------------


@contextlib.contextmanager
def _jax_as(dtype, all_ties):
    """The JAX policy in ``dtype`` (its encoder is bf16 unless patched
    here), with ``flax.linen.max_pool`` swapped for the all-ties pool or
    not; in this test only."""
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            mp.setattr(jax_policy_module, "ResNetEncoder", functools.partial(JaxResNetEncoder, dtype=jnp.float32))
        if all_ties:
            mp.setattr(flax.linen, "max_pool", _all_ties)
        yield


@pytest.fixture(scope="module")
def model():
    """The JAX policy with perturbed affine parameters and the port's
    state dict converted from them."""
    rng = np.random.default_rng(0)
    b, h0, _ = _batch(0)
    jpol = jax_policy(A, backbone="resnet18", hidden_size=HIDDEN)
    obs0 = {k: v[0] for k, v in _jax_obs(b["obs"]).items()}
    params = jax.jit(jpol.init)(jax.random.PRNGKey(0), obs0, jnp.asarray(h0), jnp.zeros(N, jnp.int32), jnp.zeros(N))
    params = {"params": _perturb_affine(params["params"], rng)}
    return jpol, params, params_from_jax(_flat(params["params"]))


def _port_policy(state_dict, dtype="bfloat16"):
    pol = make_pointnav_resnet_policy(
        A, input_hw=(HW, HW), hidden_size=HIDDEN, dtype=getattr(torch, dtype), device="cpu"
    )
    pol.load_state_dict(state_dict)
    return pol


def _port_learner(state_dict, cfg, env=None, dtype="bfloat16"):
    return PPOLearner(env or SimpleNamespace(num_envs=N), _port_policy(state_dict, dtype), cfg)


def _jax_learner(jpol, cfg):
    return JaxPPOLearner(SimpleNamespace(num_envs=N), jpol, cfg)


# ---- GAE ---------------------------------------------------------------------------


def test_gae_matches_jax():
    rng = np.random.default_rng(5)
    t, n = 16, 8
    r, v = rng.normal(size=(2, t, n)).astype(np.float32)
    d = (rng.random((t, n)) > 0.8).astype(np.float32)
    assert d[1:-1].any()  # episodes end mid-sequence
    last_v = rng.normal(size=n).astype(np.float32)
    ref = jax_compute_gae(*(jnp.asarray(a) for a in (r, v, d, last_v)), 0.99, 0.95)
    got = compute_gae(*(torch.from_numpy(a) for a in (r, v, d, last_v)), 0.99, 0.95)
    for g, e in zip(got, ref):
        e = np.asarray(e)
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-6, atol=1e-6 * np.abs(e).max())


# ---- sequence mode ---------------------------------------------------------------


def test_sequence_policy_matches_jax(model):
    jpol, params, sd = model
    b, h0, _ = _batch(1)
    ref = jax.jit(jpol.apply)(
        params, _jax_obs(b["obs"]), jnp.asarray(h0), jnp.asarray(b["prev_actions"]), jnp.asarray(b["masks"])
    )
    with torch.no_grad():
        got = _port_policy(sd)(
            _torch_obs(b["obs"]), torch.from_numpy(h0), torch.from_numpy(b["prev_actions"]), torch.from_numpy(b["masks"])
        )
    for name, g, e in zip(("logits", "values", "hidden"), got, ref):
        assert g.shape == e.shape, name
        assert np.abs(g.numpy() - np.asarray(e)).max() < BF16_ATOL, name
    assert np.ptp(np.asarray(ref[0])) > 10 * BF16_ATOL or np.ptp(np.asarray(ref[1])) > 10 * BF16_ATOL


# ---- loss and gradients on one minibatch ------------------------------------------


@pytest.fixture(scope="module")
def grads(model):
    """Loss terms and gradients on one minibatch: {(side, dtype, pool):
    (loss terms, {port parameter name: gradient})}, side "port" or "jax",
    pool "all_ties" or "one_tie" (JAX unpatched)."""
    jpol, params, sd = model
    b, h0, _ = _batch(2)
    mb = _minibatch(b, 3)
    jlearner = _jax_learner(jpol, JaxPPOConfig(num_steps=T))
    mb_j = {k: _jax_obs(v) if k == "obs" else jnp.asarray(v) for k, v in mb.items()}
    out = {}
    for dtype, all_ties in (("bfloat16", True), ("bfloat16", False), ("float32", True)):
        # a fresh function per setting, so each jit traces under its own patches
        fn = jax.value_and_grad(
            lambda p: jlearner._loss_fn(p, mb_j, jnp.asarray(h0), 0.2, jax.random.PRNGKey(0)), has_aux=True
        )
        with _jax_as(dtype, all_ties):
            (_, aux), g = jax.jit(fn)(params)
        pool = "all_ties" if all_ties else "one_tie"
        out["jax", dtype, pool] = {k: float(v) for k, v in aux.items()}, params_from_jax(_flat(g["params"]))
    mb_t = {k: _torch_obs(v) if k == "obs" else torch.from_numpy(v) for k, v in mb.items()}
    for dtype in ("bfloat16", "float32"):
        learner = _port_learner(sd, PPOConfig(num_steps=T), dtype=dtype)
        loss, aux = learner._loss_fn(mb_t, torch.from_numpy(h0))
        loss.backward()
        got = {k: p.grad for k, p in learner.policy.named_parameters() if p.grad is not None}
        assert set(got) == {k for k in sd if not k.endswith(FROZEN)}
        out["port", dtype, "all_ties"] = {k: float(v) for k, v in aux.items()}, got
    return out


def _rel_err(got, ref):
    return {k: (torch.linalg.vector_norm(g - ref[k]) / torch.linalg.vector_norm(ref[k])).item() for k, g in got.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_terms_match_jax(grads, dtype):
    aux, _ = grads["port", dtype, "all_ties"]
    ref, _ = grads["jax", dtype, "all_ties"]
    assert set(aux) == set(ref)
    for k in aux:
        assert abs(aux[k] - ref[k]) < ATOL[dtype], k
    if dtype == "bfloat16":
        assert grads["jax", dtype, "one_tie"][0] == ref  # the pool's gradient rule leaves the forward alone


def test_gradients_match_jax_float32(grads):
    """The algorithm: in float32 every gradient tensor, the stem's included,
    agrees with the all-ties JAX gradient to F32_GRAD_RTOL."""
    err = _rel_err(grads["port", "float32", "all_ties"][1], grads["jax", "float32", "all_ties"][1])
    worst = max(err, key=err.get)
    assert err[worst] < F32_GRAD_RTOL, (worst, err[worst])


def test_gradients_match_jax_bfloat16(grads):
    """In bf16 the visual path's gradient (encoder and visual_fc) differs
    from the float32 one by tens of percent in either framework on these
    inputs: each bf16 rounding of a cotangent or an activation, summed with
    heavy cancellation over 16 small images. The port's bf16 gradient there
    must lie as close to JAX's as JAX's own bf16 gradient lies to its
    float32 one (times BF16_NOISE_FACTOR); the other parameters (goal,
    action embedding, LSTM, heads) within GRAD_RTOL."""
    got = grads["port", "bfloat16", "all_ties"][1]
    ref = grads["jax", "bfloat16", "all_ties"][1]
    err = _rel_err(got, ref)
    noise = _rel_err({k: ref[k] for k in got}, grads["jax", "float32", "all_ties"][1])
    visual = [k for k in err if k.startswith(VISUAL)]
    rest = [k for k in err if k not in visual]
    print("bf16 gradient rel. L2 norm, port vs JAX: visual path max", round(max(err[k] for k in visual), 4),
          "other max", round(max(err[k] for k in rest), 4),
          "| JAX bf16 vs JAX f32: visual path max", round(max(noise[k] for k in visual), 4))
    assert max(err[k] for k in visual) < BF16_NOISE_FACTOR * max(noise[k] for k in visual)
    assert max(err[k] for k in rest) < GRAD_RTOL


def test_gradients_against_unpatched_jax(grads):
    """XLA's select-and-scatter credits one of several tied maxima, so only
    the gradients upstream of the pool (stem conv, stem GroupNorm) move:
    JAX's two rules agree everywhere else, and the port lies as close to
    the unpatched gradient outside the stem as to the patched one."""
    got = grads["port", "bfloat16", "all_ties"][1]
    ref_p = grads["jax", "bfloat16", "all_ties"][1]
    ref_u = grads["jax", "bfloat16", "one_tie"][1]
    rule_gap = _rel_err({k: ref_p[k] for k in got}, ref_u)
    assert max(e for k, e in rule_gap.items() if not k.startswith(STEM)) < 1e-6
    assert all(rule_gap[k] > 0 for k in got if k.startswith(STEM))  # bf16 ties do occur here
    err_u, err_p = _rel_err(got, ref_u), _rel_err(got, ref_p)
    for k in got:
        if not k.startswith(STEM):
            assert abs(err_u[k] - err_p[k]) < 1e-5, k
    stem = {k: round(err_u[k], 4) for k in got if k.startswith(STEM)}
    print("stem: port vs unpatched JAX", stem, "| JAX all-ties vs one-tie",
          {k: round(rule_gap[k], 4) for k in stem})
    assert max(stem.values()) < STEM_GAP_RTOL


# ---- the update --------------------------------------------------------------------


UPDATE_CFG = dict(num_steps=T, ppo_epoch=2, num_mini_batch=1)


@pytest.fixture(scope="module")
def jax_update(model):
    """The all-ties JAX update at UPDATE_CFG in float32, compiled once; call
    with (numpy batch, h0, bootstrap value) -> (port-keyed params,
    metrics)."""
    jpol, params, _ = model
    jlearner = _jax_learner(jpol, JaxPPOConfig(**UPDATE_CFG))
    ts = TrainState(
        params=params, opt_state=jlearner.optimizer.init(params), env_state=None, obs=None, hidden=None,
        prev_action=None, not_done=None, key=jax.random.PRNGKey(0), update_idx=jnp.int32(0),
        ep_return_acc=None, ep_len_acc=None, log_alpha=jnp.float32(np.log(0.01)),
    )
    b, h0, lv = _batch(0)
    with _jax_as("float32", all_ties=True):
        compiled = jax.jit(jlearner._update).lower(ts, _jax_batch(b), jnp.asarray(lv), jnp.asarray(h0)).compile()

    def run(b, h0, lv):
        new_ts, metrics = compiled(ts, _jax_batch(b), jnp.asarray(lv), jnp.asarray(h0))
        return params_from_jax(_flat(new_ts.params["params"])), {k: float(v) for k, v in metrics.items()}

    return run


def _port_update(sd, b, h0, lv, env=None):
    learner = _port_learner(sd, PPOConfig(**UPDATE_CFG), env, "float32")
    metrics = learner.update(torch.Generator().manual_seed(0), _torch_batch(b), torch.from_numpy(lv), torch.from_numpy(h0))
    return learner.policy.state_dict(), {k: v.item() for k, v in metrics.items()}


def _check_update(start, got, ref, got_m, ref_m, moved=lambda k: True):
    """Metrics to ATOL["float32"]; every element within 2*lr per Adam step of
    JAX's, >= 99% within lr/10; every trained tensor (those ``moved``
    names) moved, bias_ih not."""
    assert set(got_m) == set(ref_m)
    for k in got_m:
        assert abs(got_m[k] - ref_m[k]) < ATOL["float32"] * max(1.0, abs(ref_m[k])), k
    lr = PPOConfig().lr
    close, total = 0, 0
    for k, p in got.items():
        if k.endswith(FROZEN):
            assert torch.equal(p, start[k])
            continue
        assert not moved(k) or (ref[k] - start[k]).abs().max() > lr / 2, k
        diff = (p - ref[k]).abs()
        assert diff.max() <= 2 * lr * UPDATE_CFG["ppo_epoch"], k
        close += int((diff <= lr / 10).sum())
        total += diff.numel()
    assert close / total >= 0.99, close / total


def test_one_update_matches_jax(model, jax_update):
    """ppo_epoch=2, num_mini_batch=1 (the loss does not depend on the
    permutation), in float32 on both sides, so that the comparison sees the
    update and not bf16 noise (which the gradient tests above bound)."""
    _, _, sd = model
    b, h0, lv = _batch(0)
    ref, ref_m = jax_update(b, h0, lv)
    got, got_m = _port_update(sd, b, h0, lv)
    _check_update(sd, got, ref, got_m, ref_m)


def test_rollout_then_update_matches_jax(model, jax_update):
    """The slice as a whole: a rollout of the port's env and bf16 policy
    (N=4, T=4, 32x32), as numpy, through JAX's update and the port's, from
    the same weights, compared as above."""
    _, _, sd = model
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)
    env = make_nav_env(
        scenes, episodes, num_envs=N, device="cpu", precomputed_fields=fields, max_episode_steps=3,
        sensor_specs=SENSORS,
    )
    learner = _port_learner(sd, PPOConfig(**UPDATE_CFG), env)
    rs = learner.init(seed=0)
    rs, *_ = learner.collect_rollout(rs)  # episodes of 3 steps end inside the next rollout
    _, batch, lv, h0, _ = learner.collect_rollout(rs)
    assert batch.dones.any() and (h0 != 0).any()
    b = {k: v.numpy() for k, v in batch._asdict().items() if k != "obs"}
    b["obs"] = {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy() for k, v in batch.obs.items()}
    ref, ref_m = jax_update(b, h0.numpy(), lv.numpy())
    got, got_m = _port_update(sd, b, h0.numpy(), lv.numpy(), env=env)
    _check_update(sd, got, ref, got_m, ref_m)


def test_minibatches_follow_the_generator(model):
    """num_mini_batch=2: each epoch draws torch.randperm(N) from the
    generator and minibatch i takes envs perm[i*N/2:(i+1)*N/2] of every
    leaf and of h0."""
    _, _, sd = model
    b, h0, lv = _batch(4)
    learner = _port_learner(sd, PPOConfig(num_steps=T, ppo_epoch=2, num_mini_batch=2))
    seen = []
    loss_fn = learner._loss_fn

    def spy(mb, h0_mb, **kw):
        seen.append((mb, h0_mb))
        return loss_fn(mb, h0_mb, **kw)

    learner._loss_fn = spy
    tb = _torch_batch(b)
    learner.update(torch.Generator().manual_seed(7), tb, torch.from_numpy(lv), torch.from_numpy(h0))
    replay = torch.Generator().manual_seed(7)
    perms = [torch.randperm(N, generator=replay) for _ in range(2)]
    want = [p[i * 2:(i + 1) * 2] for p in perms for i in range(2)]
    assert len(seen) == 4
    for (mb, h0_mb), idx in zip(seen, want):
        assert torch.equal(h0_mb, torch.from_numpy(h0)[idx])
        assert torch.equal(mb["actions"], tb.actions[:, idx])
        assert torch.equal(mb["obs"]["rgb"], tb.obs["rgb"][:, idx])
        assert torch.equal(mb["masks"], tb.masks[:, idx])


def test_minibatch_split_is_checked():
    with pytest.raises(ValueError, match="minibatches"):
        PPOLearner(SimpleNamespace(num_envs=5), None, PPOConfig(num_mini_batch=2))


def test_initial_hidden_state_follows_the_device_rule():
    h = initial_hidden_state(2, 8, device="cpu")
    assert h.shape == (2, 1, 2, 8) and h.device.type == "cpu" and not h.any()
    if torch.cuda.is_available():
        assert initial_hidden_state(2, 8).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            initial_hidden_state(2, 8)


# ---- the Gaussian update -----------------------------------------------------------


def test_gaussian_update_matches_jax():
    """One float32 update of the blind arm-Pick Gaussian policy (resnet9
    net without an encoder, LSTM-128, the five arm state sensors, 10
    continuous actions) on a rollout of the port's arm-control Pick env at
    N=4, T=4, through JAX's update and the port's from the same converted
    weights, compared as the discrete update is. The rollout's (T, N, 10)
    actions and previous actions are float32; log_std trains too."""
    from habitat_tpu.models.policy import make_gaussian_resnet_policy as jax_gaussian

    from habitat_torch.models.policy import make_gaussian_resnet_policy, state_keys_of
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    env = make_rearrange_env(num_envs=N, task="pick", num_scenes=1, episodes_per_scene=4, seed=0, with_visual=False,
                             n_rooms_per_axis=1, n_clutter=0, max_episode_steps=3, control="arm", device="cpu")
    A_ = env.action_dim
    assert A_ == 10 and not hasattr(env, "num_actions")
    state_keys = state_keys_of(env.observation_shapes)
    jpol = jax_gaussian(A_, backbone="resnet9", hidden_size=128, has_visual=False)
    obs0 = {k: jnp.zeros((N, w)) for k, w in state_keys.items()}
    params = jax.jit(jpol.init)(jax.random.PRNGKey(3), obs0, jnp.zeros((N, 1, 2, 128)), jnp.zeros((N, A_)),
                                jnp.zeros(N))
    params = {"params": _perturb_affine(params["params"], np.random.default_rng(3))}
    sd = params_from_jax(_flat(params["params"]))

    def port_learner():
        pol = make_gaussian_resnet_policy(A_, backbone="resnet9", hidden_size=128, has_visual=False,
                                          state_keys=state_keys, dtype=torch.float32, device="cpu")
        pol.load_state_dict(sd)
        return PPOLearner(env, pol, PPOConfig(**UPDATE_CFG), action_type="gaussian", measure_keys=("success",))

    learner = port_learner()
    rs = learner.init(seed=0)
    rs, *_ = learner.collect_rollout(rs)  # episodes of 3 steps end inside the next rollout
    _, batch, lv, h0, _ = learner.collect_rollout(rs)
    assert batch.actions.shape == batch.prev_actions.shape == (T, N, A_) and batch.actions.dtype == torch.float32
    assert batch.dones.any() and (batch.prev_actions[0] != 0).any()
    b = {k: v.numpy() for k, v in batch._asdict().items() if k != "obs"}
    b["obs"] = {k: v.numpy().copy() for k, v in batch.obs.items() if k in state_keys}
    # nothing is held within 8 random steps: mark some steps holding, so
    # that state_fc_is_holding gets a gradient to compare as well
    assert not b["obs"]["is_holding"].any()
    b["obs"]["is_holding"][1:3, :2] = 1.0

    jlearner = JaxPPOLearner(SimpleNamespace(num_envs=N), jpol, JaxPPOConfig(**UPDATE_CFG), action_type="gaussian")
    ts = TrainState(
        params=params, opt_state=jlearner.optimizer.init(params), env_state=None, obs=None, hidden=None,
        prev_action=None, not_done=None, key=jax.random.PRNGKey(0), update_idx=jnp.int32(0),
        ep_return_acc=None, ep_len_acc=None, log_alpha=jnp.float32(np.log(0.01)),
    )
    new_ts, ref_m = jax.jit(jlearner._update)(ts, _jax_batch(b), jnp.asarray(lv.numpy()), jnp.asarray(h0.numpy()))
    ref = params_from_jax(_flat(new_ts.params["params"]))
    port = port_learner()
    got_m = port.update(torch.Generator().manual_seed(0), _torch_batch(b), lv, h0)
    _check_update(sd, port.policy.state_dict(), ref, {k: v.item() for k, v in got_m.items()},
                  {k: float(v) for k, v in ref_m.items()})
    assert "action_head.log_std" in sd


# ---- the PPOConfig switches and CPC|A ---------------------------------------------

SW_N, SW_H = 4, 64
SW_RTOL, SW_ATOL = 2e-4, 2e-5  # the blind update's parameters, port vs JAX


def _jax_perms(key, n, epochs, update_idx=0):
    """JAX's epoch permutations: fold_in(fold_in(key, update_idx), epoch)."""
    return np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(key, update_idx), e), n)) for e in range(epochs)])


def _train_state(params, jlearner, key, log_alpha=np.log(0.01)):
    return TrainState(params=params, opt_state=jlearner.optimizer.init(params), env_state=None, obs=None,
                      hidden=None, prev_action=None, not_done=None, key=key, update_idx=jnp.int32(0),
                      ep_return_acc=None, ep_len_acc=None, log_alpha=jnp.float32(log_alpha))


def _blind_batch(seed, gaussian_dim=None):
    """A (T, N) batch of the blind nav net (pointgoal only), or with
    ``gaussian_dim`` of the blind arm net (its five state sensors, float
    actions)."""
    b, h0, lv = _batch(seed)
    rng = np.random.default_rng(seed + 100)
    b["obs"] = {"pointgoal_with_gps_compass": b["obs"]["pointgoal_with_gps_compass"]}
    if gaussian_dim:
        from tests.test_torch_models import ARM_WIDTHS

        b["obs"] = {k: rng.normal(0, 1, (T, N, w)).astype(np.float32) for k, w in ARM_WIDTHS.items()}
        b["actions"] = rng.normal(0, 1, (T, N, gaussian_dim)).astype(np.float32)
        b["prev_actions"] = np.concatenate([np.zeros((1, N, gaussian_dim)), b["actions"][:-1]]).astype(np.float32)
        b["log_probs"] = (-14.0 + rng.normal(0, 1, (T, N))).astype(np.float32)
    return b, rng.normal(0, 0.5, (N, 1, 2, SW_H)).astype(np.float32), lv


def _close_params(got, ref):
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=SW_RTOL, atol=SW_ATOL, err_msg=k)


SWITCHES = {
    "normalized_advantage": dict(use_normalized_advantage=True),
    "linear_lr_decay": dict(use_linear_lr_decay=True),
    "linear_clip_decay": dict(use_linear_clip_decay=True),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switched_update_matches_jax(switch):
    """One update of the blind net (LSTM-64, float32) with a switch on, 2
    epochs of 2 minibatches, JAX's permutations passed in: parameters at
    rtol 2e-4 / atol 2e-5 and loss terms at 1e-5 of JAX's ``_update``.
    Linear LR decay takes ``total_updates=2`` on both sides (8 Adam steps
    to lr 0; JAX's trainer and YAML never pass it); the clip decay is
    inert in JAX and in the port: the update equals the one without it."""
    cfg = dict(num_steps=T, ppo_epoch=2, num_mini_batch=2, **SWITCHES[switch])
    total = 2 if switch == "linear_lr_decay" else None
    b, h0, lv = _blind_batch(20)
    jpol = jax_policy(A, backbone="resnet9", hidden_size=SW_H, has_visual=False)
    key = jax.random.PRNGKey(3)
    obs0 = {k: jnp.asarray(v[0]) for k, v in b["obs"].items()}
    params = jax.jit(jpol.init)(key, obs0, jnp.asarray(h0), jnp.zeros(N, jnp.int32), jnp.zeros(N))
    params = {"params": _perturb_affine(params["params"], np.random.default_rng(21))}
    jl = JaxPPOLearner(SimpleNamespace(num_envs=N), jpol, JaxPPOConfig(**cfg), total_updates=total)
    new_ts, ref_m = jax.jit(jl._update)(_train_state(params, jl, key), _jax_batch(b), jnp.asarray(lv),
                                        jnp.asarray(h0))
    ref = params_from_jax(_flat(new_ts.params["params"]))
    sd = params_from_jax(_flat(params["params"]))
    perms = torch.from_numpy(_jax_perms(key, N, 2)).long()

    def port(**over):
        pol = make_pointnav_resnet_policy(A, hidden_size=SW_H, has_visual=False, dtype=torch.float32, device="cpu")
        pol.load_state_dict(sd)
        lrn = PPOLearner(SimpleNamespace(num_envs=N), pol, PPOConfig(**{**cfg, **over}), total_updates=total)
        m = lrn.update(torch.Generator().manual_seed(0), _torch_batch(b), torch.from_numpy(lv), torch.from_numpy(h0),
                       perms=perms)
        return pol.state_dict(), {k: v.item() for k, v in m.items()}, lrn

    got, got_m, lrn = port()
    _close_params(got, ref)
    for k, v in ref_m.items():
        assert got_m[k] == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    if switch == "linear_lr_decay":
        assert lrn.optimizer.param_groups[0]["lr"] == pytest.approx(PPOConfig().lr * (1 - 3 / 8))  # the 4th step's
    if switch == "linear_clip_decay":
        plain, plain_m, _ = port(use_linear_clip_decay=False)
        assert plain_m == got_m and all(torch.equal(plain[k], got[k]) for k in got)


@pytest.mark.parametrize("case", ["moves", "clamped", "categorical"])
def test_adaptive_entropy_matches_jax(case):
    """use_adaptive_entropy_pen: the Gaussian blind arm net (10 actions),
    log_alpha from log(entropy_coef), dual ascent with lr after each of the
    4 minibatch steps toward the entropy threshold -factor * 10, clamped
    to [log 1e-4, 0], the loss with exp(log_alpha) from before the step,
    ``losses/entropy_coef`` in the metrics: parameters, loss terms and the
    final log_alpha against JAX's. "moves": threshold above the entropy;
    "clamped": entropy_coef 1e-4 and a threshold below it, so the first
    step hits the lower bound. A categorical learner ignores the switch,
    as JAX's does."""
    A_ = 10
    coef, factor = {"moves": (0.01, -2.0), "clamped": (1.00001e-4, 0.0), "categorical": (0.01, -2.0)}[case]
    cfg = dict(num_steps=T, ppo_epoch=2, num_mini_batch=2, use_adaptive_entropy_pen=True, entropy_coef=coef,
               entropy_target_factor=factor)
    if case == "categorical":
        b, h0, lv = _blind_batch(30)
        pol = make_pointnav_resnet_policy(A, hidden_size=SW_H, has_visual=False, dtype=torch.float32, device="cpu")
        lrn = PPOLearner(SimpleNamespace(num_envs=N), pol, PPOConfig(**cfg))
        log_alpha = torch.tensor(np.log(coef), dtype=torch.float32)
        m = lrn.update(torch.Generator().manual_seed(0), _torch_batch(b), torch.from_numpy(lv), torch.from_numpy(h0),
                       log_alpha=log_alpha)
        assert not lrn.adaptive_ent and "losses/entropy_coef" not in m
        assert log_alpha.item() == torch.tensor(np.log(coef), dtype=torch.float32).item()  # untouched
        return
    from habitat_tpu.models.policy import make_gaussian_resnet_policy as jax_gaussian

    from habitat_torch.models.policy import make_gaussian_resnet_policy
    from tests.test_torch_models import ARM_WIDTHS

    b, h0, lv = _blind_batch(31, gaussian_dim=A_)
    jpol = jax_gaussian(A_, backbone="resnet9", hidden_size=SW_H, has_visual=False)
    key = jax.random.PRNGKey(4)
    obs0 = {k: jnp.asarray(v[0]) for k, v in b["obs"].items()}
    params = jax.jit(jpol.init)(key, obs0, jnp.asarray(h0), jnp.zeros((N, A_)), jnp.zeros(N))
    params = {"params": _perturb_affine(params["params"], np.random.default_rng(32))}
    env_j = SimpleNamespace(num_envs=N, action_space=SimpleNamespace(shape=(A_,)))
    jl = JaxPPOLearner(env_j, jpol, JaxPPOConfig(**cfg), action_type="gaussian")
    new_ts, ref_m = jax.jit(jl._update)(_train_state(params, jl, key, np.log(coef)), _jax_batch(b),
                                        jnp.asarray(lv), jnp.asarray(h0))
    pol = make_gaussian_resnet_policy(A_, backbone="resnet9", hidden_size=SW_H, has_visual=False,
                                      state_keys=ARM_WIDTHS, dtype=torch.float32, device="cpu")
    pol.load_state_dict(params_from_jax(_flat(params["params"])))
    lrn = PPOLearner(SimpleNamespace(num_envs=N, action_dim=A_), pol, PPOConfig(**cfg), action_type="gaussian")
    assert lrn.ent_threshold == -factor * A_
    log_alpha = torch.tensor(np.log(coef), dtype=torch.float32)
    got_m = lrn.update(torch.Generator().manual_seed(0), _torch_batch(b), torch.from_numpy(lv), torch.from_numpy(h0),
                       log_alpha=log_alpha, perms=torch.from_numpy(_jax_perms(key, N, 2)).long())
    _close_params(pol.state_dict(), params_from_jax(_flat(new_ts.params["params"])))
    assert set(got_m) == set(ref_m) and "losses/entropy_coef" in got_m
    for k, v in ref_m.items():
        assert got_m[k].item() == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    assert log_alpha.item() == pytest.approx(float(new_ts.log_alpha), abs=1e-6)
    if case == "clamped":
        assert log_alpha.item() == pytest.approx(np.log(1e-4), abs=1e-6)
    else:
        assert abs(log_alpha.item() - np.log(coef)) > 1e-4


# ---- CPC|A ---------------------------------------------------------------------------


def _cpca_pair(T_, n, H, F, seed):
    """The JAX CPCA module, its init, and the port's module converted."""
    from habitat_tpu.baselines.aux_losses import CPCA as JaxCPCA

    from habitat_torch.baselines.aux_losses import CPCA
    from habitat_torch.models.convert import cpca_params_from_jax

    jc = JaxCPCA(num_actions=A)
    key = jax.random.PRNGKey(seed)
    ps = jax.jit(jc.init)(key, jnp.zeros((T_, n, H)), jnp.zeros((T_, n, F)), jnp.zeros((T_, n), jnp.int32),
                          jnp.ones((T_, n)), key)
    ps = {"params": _perturb_affine(ps["params"], np.random.default_rng(seed))}
    port = CPCA(H, F, num_actions=A)
    port.load_state_dict(cpca_params_from_jax(_flat(ps["params"])))
    return jc, ps, port


def test_cpca_loss_and_gradients_match_jax():
    """CPC|A alone on random beliefs (T=8, N=4, 64), visual embeddings (64),
    actions and masks with episode starts, JAX's time permutation passed
    in: the loss within 1e-6 relative; the gradients of every CPC|A
    parameter and of the beliefs (the target side is detached in both)
    within 1e-5 relative L2 norm."""
    T_, n, H = 8, 4, 64
    rng = np.random.default_rng(40)
    beliefs = rng.normal(0, 1, (T_, n, H)).astype(np.float32)
    visual = np.maximum(rng.normal(0, 1, (T_, n, H)), 0).astype(np.float32)
    actions = rng.integers(0, A, (T_, n)).astype(np.int32)
    masks = (rng.random((T_, n)) > 0.2).astype(np.float32)
    jc, ps, port = _cpca_pair(T_, n, H, H, 41)
    key = jax.random.PRNGKey(42)

    def jloss(p, b):
        return jc.apply(p, b, jnp.asarray(visual), jnp.asarray(actions), jnp.asarray(masks), key)

    ref, (g_p, g_b) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(ps, jnp.asarray(beliefs))
    perm = torch.from_numpy(np.array(jax.random.permutation(key, T_))).long()
    bt = torch.from_numpy(beliefs).requires_grad_(True)
    num, den = port(bt, torch.from_numpy(visual), torch.from_numpy(actions), torch.from_numpy(masks), perm)
    loss = num / torch.clamp(den, min=1.0)
    loss.backward()
    assert den.item() == port.count(torch.from_numpy(masks)).item() > 0
    assert loss.item() == pytest.approx(float(ref), rel=1e-6)
    from habitat_torch.models.convert import cpca_params_from_jax

    want = cpca_params_from_jax(_flat(g_p["params"]))
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    errs = _rel_err(got, want)
    errs["beliefs"] = (torch.linalg.vector_norm(bt.grad - torch.from_numpy(np.array(g_b)))
                       / torch.linalg.vector_norm(torch.from_numpy(np.array(g_b)))).item()
    assert max(errs.values()) < 1e-5, errs


def test_cpca_update_matches_jax():
    """The update with CPC|A (coefficient 0.5) on a GRU policy (resnet9 over
    depth, GRU-64, float32 with the all-ties pool): the visual embedding
    and the beliefs from ``with_feats``, the aux parameters in the
    optimizer's second group, JAX's epoch and time permutations passed in.
    Loss terms (``losses/cpca`` included) within 1e-4 and every parameter,
    policy and CPC|A, by ``_check_update``'s rule."""
    from habitat_tpu.baselines.aux_losses import CPCA as JaxCPCA

    from habitat_torch.baselines.aux_losses import CPCA
    from habitat_torch.models.convert import cpca_params_from_jax

    H = SW_H
    b, _, lv = _batch(50)
    b["obs"] = {"depth": b["obs"]["depth"], "pointgoal_with_gps_compass": b["obs"]["pointgoal_with_gps_compass"]}
    h0 = np.random.default_rng(51).normal(0, 0.5, (N, 1, 1, H)).astype(np.float32)
    cfg = dict(num_steps=T, ppo_epoch=2, num_mini_batch=2)
    jpol = jax_policy(A, backbone="resnet9", hidden_size=H, rnn_type="GRU")
    key = jax.random.PRNGKey(5)
    obs0 = {k: v[0] for k, v in _jax_obs(b["obs"]).items()}
    jc = JaxCPCA(num_actions=A)
    with _jax_as("float32", all_ties=True):
        pp = jax.jit(jpol.init)(key, obs0, jnp.asarray(h0), jnp.zeros(N, jnp.int32), jnp.zeros(N))
        ap = jax.jit(jc.init)(key, jnp.zeros((T, N, H)), jnp.zeros((T, N, H)), jnp.zeros((T, N), jnp.int32),
                              jnp.ones((T, N)), key)
        params = {"policy": {"params": _perturb_affine(pp["params"], np.random.default_rng(52))},
                  "aux": {"params": _perturb_affine(ap["params"], np.random.default_rng(53))}}
        jl = JaxPPOLearner(SimpleNamespace(num_envs=N), jpol, JaxPPOConfig(**cfg), aux_loss=jc, aux_loss_coef=0.5)
        new_ts, ref_m = jax.jit(jl._update)(_train_state(params, jl, key), _jax_batch(b), jnp.asarray(lv),
                                            jnp.asarray(h0))

    def both(p):
        out = params_from_jax(_flat(p["policy"]["params"]))
        out.update({f"aux.{k}": v for k, v in cpca_params_from_jax(_flat(p["aux"]["params"])).items()})
        return out

    start, ref = both(params), both(new_ts.params)
    pol = make_pointnav_resnet_policy(A, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                                      hidden_size=H, rnn_type="GRU", dtype=torch.float32, device="cpu")
    pol.load_state_dict({k: v for k, v in start.items() if not k.startswith("aux.")})
    aux = CPCA(H, H, num_actions=A)
    aux.load_state_dict({k[4:]: v for k, v in start.items() if k.startswith("aux.")})
    lrn = PPOLearner(SimpleNamespace(num_envs=N), pol, PPOConfig(**cfg), aux_loss=aux, aux_loss_coef=0.5)
    assert len(lrn.optimizer.param_groups) == 2
    kperm = [jax.random.fold_in(jax.random.fold_in(key, 0), e) for e in range(2)]
    time_perms = torch.from_numpy(np.stack([[np.asarray(jax.random.permutation(jax.random.fold_in(k, i), T))
                                             for i in range(2)] for k in kperm])).long()
    got_m = lrn.update(torch.Generator().manual_seed(0), _torch_batch(b), torch.from_numpy(lv), torch.from_numpy(h0),
                       perms=torch.from_numpy(_jax_perms(key, N, 2)).long(), time_perms=time_perms)
    got = {**pol.state_dict(), **{f"aux.{k}": v for k, v in aux.state_dict().items()}}
    got_m = {k: v.item() for k, v in got_m.items()}
    assert "losses/cpca" in got_m and got_m["losses/cpca"] > 0
    # on this batch the critic's bias ends within lr/2 of its start in JAX's
    # update too (its gradient changes sign between steps): the CPC|A
    # tensors must move
    _check_update(start, got, ref, got_m, {k: float(v) for k, v in ref_m.items()},
                  moved=lambda k: k.startswith("aux."))
