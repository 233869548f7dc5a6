"""habitat_torch's EQA imitation trainers against habitat_tpu's on the CPU,
from the same weights (converted by ``models/convert.py``) and inputs.

Weights are drawn with numpy into the Flax trees' shapes (``_random_params``)
and converted.

- ``MultitaskCNN`` (decoders and encoder) on 64x64, 32x32 and 36x36 inputs
  (36 reaches odd sides, 9 and 5, where "SAME" pads differ): outputs within
  1e-5 + 1e-4 relative (both convolve in float32 the input rounded to
  bfloat16; the summation orders differ).
- ``VqaModel`` and ``PacmanModel`` logits on padded questions (an all-pad
  row, and rows with a pad inside, which VQA's masked carry skips and
  PACMAN's last-position rule reads) within the same bounds.
- The goal-image resize against ``jax.image.resize(..., "bilinear")`` on an
  upscale and two downscales (antialiased): within 1e-6.
- One step of each learner, in float32 as both packages run them, from the
  same weights and batch: the CNN pretrain step with the JAX step's walk
  (its ``randint`` replayed) on the same env state, VQA on the JAX
  package's own frames, PACMAN on the JAX package's expert batch. Losses
  within 1e-4 of max(1, |loss|); parameters by tests/test_torch_il.py's
  rule at the learner's lr (every element within 2 lr of JAX's after the one
  Adam step, >= 99% within lr/10, every trained tensor moved, the LSTMs'
  ``bias_ih`` not).
- ``build_pacman_supervision`` equal to JAX's on random runs;
  ``collect_expert``'s questions, actions and valid mask equal to JAX's
  (N=8, T=24; the JAX reset and step jitted).
- ``trainer_from_config`` builds each of the three trainers on the CPU and
  runs one update through its facade.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.baselines.il import eqa_trainers as jil
from habitat_tpu.baselines.il import pacman as jpac
from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.tasks.eqa import make_eqa_env as jax_make_eqa_env

from habitat_torch.baselines.il import eqa_trainers as til
from habitat_torch.baselines.il import pacman as tpac
from habitat_torch.config.default import get_config
from habitat_torch.core import construct as tcons
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.core.registry import registry
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.models.convert import (
    multitask_cnn_params_from_jax,
    pacman_params_from_jax,
    vqa_params_from_jax,
)
from habitat_torch.tasks.eqa import make_eqa_env

from tests.test_torch_ppo import FROZEN, _flat
from tests.torch_jax_native import _jax_native  # noqa: F401

# float32 in both; 12 convolutions and GroupNorms summed in different
# orders leave up to ~1.2e-5 on logits of size ~0.3
ATOL, RTOL, LOSS_RTOL = 1e-5, 1e-4, 1e-4
N, HW = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _load(model, sd):
    assert set(sd) == set(model.state_dict()), set(sd) ^ set(model.state_dict())
    model.load_state_dict(sd)
    return model


def _random_params(module, *args, seed=0):
    """Parameters of the Flax ``module`` for ``args``, drawn with numpy
    (``module.init`` costs seconds of compilation per model): kernels of
    variance 1 / fan_in, embeddings N(0, 1), biases N(0, 0.1), GroupNorm
    scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name = str(path[-1].key)
        scale = {"kernel": 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), "embedding": 1.0, "bias": 0.1,
                 "scale": 0.1}[name]
        v = rng.normal(0.0, scale, leaf.shape) + (name == "scale")
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _check_update(start, got, ref, lr):
    """tests/test_torch_il.py's rule for one Adam step at ``lr``."""
    close, total = 0, 0
    for k, p in got.items():
        if k.endswith((FROZEN, "bias_ih_l0")):
            assert torch.equal(p, start[k]), k
            continue
        assert (ref[k] - start[k]).abs().max() > lr / 2, k
        diff = (p - ref[k]).abs()
        assert diff.max() <= 2 * lr, (k, diff.max().item())
        close += int((diff <= lr / 10).sum())
        total += diff.numel()
    assert close / total >= 0.99, close / total


def _loss_close(got, want):
    assert abs(got - want) < LOSS_RTOL * max(1.0, abs(want)), (got, want)


# -- the models ------------------------------------------------------------------


@pytest.mark.parametrize("hw", [64, 32, 36])
def test_multitask_cnn_matches_jax(hw):
    x = np.random.default_rng(hw).uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)
    jm = jil.MultitaskCNN(num_classes=10)
    params = _random_params(jm, jnp.asarray(x), seed=hw)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    want_enc = jax.jit(jil.MultitaskCNN(num_classes=10, only_encoder=True).apply)(params, jnp.asarray(x))
    sd = multitask_cnn_params_from_jax(_flat(params["params"]))
    tm = _load(til.MultitaskCNN(num_classes=10), sd)
    enc = til.MultitaskCNN(num_classes=10, only_encoder=True)
    enc.load_state_dict({k: v for k, v in sd.items() if k.startswith("enc")})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        got_enc = enc(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    assert tuple(got_enc.shape) == want_enc.shape == (1, til.encoder_hw(hw, hw)[0] ** 2 * 32)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), atol=ATOL, rtol=RTOL)


def _padded_questions(rng, n, length, vocab, gaps=False):
    """Rows of random lengths, one all pad; with ``gaps`` some rows pad in
    the middle too."""
    q = np.zeros((n, length), np.int32)
    for i in range(n - 1):
        k = int(rng.integers(1, length))
        q[i, :k] = rng.integers(1, vocab, k)
        if gaps and i % 2:
            q[i, k // 2] = 0
    return q


def test_vqa_model_matches_jax():
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 1, (5, 2, HW, HW, 3)).astype(np.float32)
    q = _padded_questions(rng, 5, 8, 32, gaps=True)
    jm = jil.VqaModel(vocab_size=32, num_answers=6)
    params = _random_params(jm, jnp.asarray(frames), jnp.asarray(q), seed=1)
    want = jax.jit(jm.apply)(params, jnp.asarray(frames), jnp.asarray(q))
    tm = _load(til.VqaModel(32, 6, input_hw=(HW, HW)), vqa_params_from_jax(_flat(params["params"])))
    with torch.no_grad():
        got = tm(torch.from_numpy(frames), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_pacman_model_matches_jax():
    rng = np.random.default_rng(2)
    B, T, L = 5, 7, 9
    q = _padded_questions(rng, B, L, 256, gaps=True)
    feats = rng.normal(size=(B, T, 64)).astype(np.float32)
    a_in = rng.integers(-1, 3, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    jm = jpac.PacmanModel(num_actions=3, image_feat_dim=128, planner_hidden=256)
    args = tuple(jnp.asarray(v) for v in (q, feats, a_in, mask))
    params = _random_params(jm, *args, seed=2)
    want = jax.jit(jm.apply)(params, *args)
    tm = _load(tpac.PacmanModel(num_actions=3, image_feat_dim=128, planner_hidden=256),
               pacman_params_from_jax(_flat(params["params"])))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(v) for v in (q, feats, a_in, mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("src,dst", [(32, 64), (64, 32), (48, 32)])
def test_goal_resize_matches_jax(src, dst):
    img = np.random.default_rng(src).uniform(0, 1, (2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (2, dst, dst, 3), "bilinear")
    got = til.resize_like_jax(torch.from_numpy(img), (dst, dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- one step of each learner ------------------------------------------------------


def _nav_pair():
    kw = dict(num_scenes=2, episodes_per_scene=4, seed=0, extent=6.0)
    frame = {"height": HW, "width": HW}
    sensors = (("HabitatSimRGBSensor", frame), ("HabitatSimDepthSensor", frame),
               ("HabitatSimSemanticSensor", frame), ("PointGoalWithGPSCompassSensor", None))
    env_kw = dict(num_envs=N, max_episode_steps=50, sensor_specs=sensors)
    sj, ej, fj = jax_pointnav(**kw)
    st, et, ft = make_procedural_pointnav(**kw)
    return (jax_make_nav_env(sj, ej, precomputed_fields=fj, **env_kw),
            make_nav_env(st, et, precomputed_fields=ft, device="cpu", **env_kw))


def test_cnn_pretrain_step_matches_jax():
    je, te = _nav_pair()
    jl = jil.EQACNNPretrainLearner(je, num_classes=16)
    params = _random_params(jl.model, jnp.zeros((N, HW, HW, 3)))
    js, _ = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    ts = jil.EQACNNPretrainState(params, jl.optim.init(params), js, jax.random.PRNGKey(0), jnp.zeros((), jnp.int32))
    ts2, jm = jax.jit(jl.train_step)(ts)
    # the JAX step's walk: split(key, 3)[1] -> randint(1, 4)
    acts = jax.random.randint(jax.random.split(ts.key, 3)[1], (N,), 1, 4)
    tl = til.EQACNNPretrainLearner(te, num_classes=16)
    start = _load(tl.model, multitask_cnn_params_from_jax(_flat(ts.params["params"]))).state_dict()
    start = {k: v.clone() for k, v in start.items()}
    st, tm = tl.train_step(tl.init(), actions=torch.tensor(np.asarray(acts)))
    np.testing.assert_allclose(st.env_state.pos.numpy(), np.asarray(ts2.env_state.pos), atol=1e-5)
    assert st.update_idx == 1 == int(ts2.update_idx)
    for k in ("losses/total", "losses/rgb", "losses/depth", "losses/seg"):
        _loss_close(tm[k].item(), float(jm[k]))
    _check_update(start, tl.model.state_dict(), multitask_cnn_params_from_jax(_flat(ts2.params["params"])), 1e-3)


def test_vqa_step_matches_jax():
    je = jax_make_eqa_env(num_envs=N, num_scenes=1, episodes_per_scene=4, visual_size=HW)
    te = make_eqa_env(num_envs=N, num_scenes=1, episodes_per_scene=4, visual_size=HW, device="cpu")
    # the same goal views in both tables (the renders are held elsewhere)
    goal = np.asarray(je.table.goal_image)
    te.table = dataclasses.replace(te.table, goal_image=torch.tensor(goal))
    jl = jil.VQALearner(je, vocab_size=64, num_answers=10)
    params = _random_params(jl.model, jnp.zeros((N, 2, HW, HW, 3)), jnp.ones((N, 16), jnp.int32))
    ts = jil.VQAState(params, jl.optim.init(params), jax.random.PRNGKey(0), jnp.zeros((), jnp.int32))
    js, _ = jax.jit(je.reset_fn)(jax.random.PRNGKey(1))
    ts2, jm = jax.jit(jl.train_step)(ts, js)
    rgb = jax.jit(je._observations)(js)["rgb"]
    tl = til.VQALearner(te, vocab_size=64, num_answers=10)
    start = _load(tl.model, vqa_params_from_jax(_flat(ts.params["params"]))).state_dict()
    start = {k: v.clone() for k, v in start.items()}
    tst, _ = te.reset_fn()
    tm = tl.train_step(tst, {"rgb": torch.tensor(np.asarray(rgb))})
    _loss_close(tm["losses/vqa"].item(), float(jm["losses/vqa"]))
    assert tm["metrics/answer_accuracy"].item() == pytest.approx(float(jm["metrics/answer_accuracy"]))
    _check_update(start, tl.model.state_dict(), vqa_params_from_jax(_flat(ts2.params["params"])), 3e-4)


@pytest.fixture(scope="module")
def expert():
    """The JAX and port PACMAN trainers over the same EQA env (N=8, one
    scene x 4 episodes, T=24) and the JAX expert batch (reset and step
    jitted)."""
    je = jax_make_eqa_env(num_envs=8, num_scenes=1, episodes_per_scene=4, seed=0, max_episode_steps=40)
    je.reset_fn, je.step_fn = jax.jit(je.reset_fn), jax.jit(je.step_fn)
    te = make_eqa_env(num_envs=8, num_scenes=1, episodes_per_scene=4, seed=0, max_episode_steps=40, device="cpu")
    jt, tt = jpac.PacmanTrainer(je, max_T=24), tpac.PacmanTrainer(te, max_T=24)
    return jt, tt, jt.collect_expert(0)


def test_collect_expert_matches_jax(expert):
    jt, tt, jb = expert
    tb = tt.collect_expert(0)
    for name, g, w in zip(("questions", "feats", "actions", "valid"), tb, jb):
        if name == "feats":
            np.testing.assert_allclose(g, w, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the follower turns both ways and, stopping at the goal, moves forward
    assert set(np.unique(jb[2][jb[3] > 0])) == {0, 1, 2}


def test_pacman_step_matches_jax(expert):
    jt, tt, jb = expert
    qs, feats, acts, valid = (jnp.asarray(x) for x in jb)
    params = _random_params(jt.model, qs, feats, acts, valid)
    ts = jpac.PacmanState(params, jt.optimizer.init(params), jax.random.PRNGKey(0))
    ts2, jm = jax.jit(jt.train_step)(ts, jt.prepare_batch(jb))
    tt.init_fn(0, jb)
    start = _load(tt.model, pacman_params_from_jax(_flat(ts.params["params"]))).state_dict()
    start = {k: v.clone() for k, v in start.items()}
    tm = tt.train_step(tt.prepare_batch(jb))
    for k in ("planner_nll", "controller_nll", "loss"):
        _loss_close(tm[k].item(), float(jm[k]))
    _check_update(start, tt.model.state_dict(), pacman_params_from_jax(_flat(ts2.params["params"])), 1e-3)


def test_pacman_supervision_matches_jax():
    rng = np.random.default_rng(3)
    for mca in (2, 3, 5):
        acts = rng.integers(0, 3, (16, 20))
        acts[::3] = np.repeat(acts[::3, :1], 20, axis=1)  # long runs
        valid = (np.arange(20)[None] < rng.integers(1, 21, 16)[:, None]).astype(np.float32)
        for g, w in zip(tpac.build_pacman_supervision(acts, valid, mca),
                        jpac.build_pacman_supervision(acts, valid, mca)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("name", ["eqa-cnn-pretrain", "vqa", "pacman"])
def test_trainer_from_config_builds_and_updates(name):
    cfg = get_config("pointnav/ppo_pointnav_example.yaml", [
        f"habitat_baselines.trainer_name={name}", "habitat_baselines.num_environments=2",
        "habitat_baselines.total_num_steps=2", "habitat_baselines.il.num_epochs=1"])
    trainer = tcons.trainer_from_config(cfg, device="cpu")
    learner_cls = {"eqa-cnn-pretrain": til.EQACNNPretrainLearner, "vqa": til.VQALearner,
                   "pacman": tpac.PacmanTrainer}[name]
    assert registry.get_trainer(name) is learner_cls and isinstance(trainer.learner, learner_cls)
    assert trainer.env.num_envs == 2 and trainer.env.observation_shapes["rgb"][0] == (64, 64, 3)
    metrics = trainer.train(seed=0)
    assert metrics and all(np.isfinite(v) for v in metrics.values()), metrics
