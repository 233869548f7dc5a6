"""habitat_torch's evaluator and flagship weights against habitat_tpu on the
CPU.

- The export: ``habitat_torch/weights/flagship_pointnav.pt`` equals
  ``params_from_jax`` of the orbax restore of ``ckpts/flagship_params``,
  tensor for tensor and bit for bit; its sha256 is the one in the JSON
  beside it; ``load_policy_file`` loads it with ``strict=True``.
- ``evaluate_agent`` against ``habitat_tpu.baselines.evaluator.
  evaluate_agent`` on one tiny configuration (2 bench scenes, N=4, 32x32
  depth, episodes of at most 40 steps, quota 2), greedy, with the same
  policy on both sides: a pointgoal controller (``stub``: turns toward the
  goal, walks, stops near it; one of the 8 episodes succeeds, walls stop
  the rest) and the resnet9 +
  LSTM-32 policy from a seeded JAX init carried across with
  ``params_from_jax`` (``policy``, both encoders in float32: in bf16 the
  two frameworks round at other places and a flipped argmax changes the
  rest of an episode). The counted episodes (each env's ``ep_idx`` at its
  first ``quota`` dones), their success and SPL must be equal, and the
  aggregates within 1e-5 (float32 measures summed on the host).
- The contracts of the port's evaluator: the quota counted exactly once
  (with ``evals_per_ep`` 1 and 2), ``poll_checkpoint_folder``,
  ``eval_checkpoint_loop`` resuming from ``.eval_resume_state`` over
  checkpoints the port's trainer saved, the options that once raised
  (``video_option``, ``tb_writer``, ``map_tracker``: the frames of env
  ``video_env`` while its quota is open, the map tracker following its pose
  and reset at its dones; tests/test_torch_video.py holds them against
  JAX), and ``device=None`` needing the card.
"""

import contextlib
import functools
import hashlib
import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch import nn

import habitat_tpu.models.policy as jax_policy_module
from habitat_tpu.baselines.evaluator import evaluate_agent as jax_evaluate_agent
from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
from habitat_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from habitat_tpu.models.rnn_state_encoder import initial_hidden_state as jax_hidden

from habitat_torch.baselines import evaluator as tev
from habitat_torch.baselines.flagship import flagship_eval
from habitat_torch.baselines.ppo import PPOConfig
from habitat_torch.baselines.trainer import PPOTrainer, TrainerConfig
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.models.convert import load_policy_file, params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy
from tests.torch_jax_native import _jax_native  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "habitat_torch", "weights", "flagship_pointnav.pt")
CKPT = os.path.join(ROOT, "ckpts", "flagship_params")
N, HW, MAX_EP_STEPS, QUOTA = 4, 32, 40, 2
SENSORS = (("HabitatSimDepthSensor", {"height": HW, "width": HW}), ("PointGoalWithGPSCompassSensor", None))
# the stub controller: stop within this distance, else walk when the goal
# lies within this angle of the heading, else turn toward it
STOP_RHO, WALK_PHI = 0.15, 0.2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



# ---- the export -------------------------------------------------------------------


def test_flagship_export_matches_the_orbax_restore():
    import orbax.checkpoint as ocp

    with open(os.path.splitext(WEIGHTS)[0] + ".json") as f:
        meta = json.load(f)
    with open(WEIGHTS, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == meta["sha256"]
    assert meta["source"] == "ckpts/flagship_params"
    n, (h, w) = 2, meta["policy"]["input_hw"]
    obs = {"depth": jnp.zeros((n, h, w, 1)), "pointgoal_with_gps_compass": jnp.zeros((n, 2))}
    jpol = jax_policy(4, backbone="resnet18", hidden_size=512)
    abstract = jax.eval_shape(
        lambda k: jpol.init(k, obs, jax_hidden(n, 512), jnp.zeros(n, jnp.int32), jnp.zeros(n)), jax.random.PRNGKey(1))
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=cpu), abstract)
    params = ocp.StandardCheckpointer().restore(CKPT, abstract)
    ref = params_from_jax({k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()})
    saved = torch.load(WEIGHTS, map_location="cpu", weights_only=True)
    assert saved.keys() == ref.keys()
    for k, v in ref.items():
        assert saved[k].dtype == torch.float32 and torch.equal(saved[k], v), k
    policy = load_policy_file(WEIGHTS, device="cpu")  # strict=True
    assert all(torch.equal(v, ref[k]) for k, v in policy.state_dict().items())


def test_load_policy_file_checks_the_sha256(tmp_path):
    path = tmp_path / "flagship_pointnav.pt"
    shutil.copy(WEIGHTS, path)
    with open(os.path.splitext(WEIGHTS)[0] + ".json") as f:
        meta = json.load(f)
    meta["sha256"] = "0" * 64
    (tmp_path / "flagship_pointnav.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="sha256"):
        load_policy_file(str(path), device="cpu")


# ---- the evaluator against the JAX package's ----------------------------------------


def _stub_action(rho, phi, xp):
    """Stop near the goal, walk toward it, else turn (left when the goal
    lies to the left): action ids of DEFAULT_NAV_ACTIONS."""
    return xp.where(rho < STOP_RHO, 0, xp.where(xp.abs(phi) < WALK_PHI, 1, xp.where(phi > 0, 2, 3)))


def _jax_stub():
    def apply(params, obs, hidden, prev_action, not_done):
        g = obs["pointgoal_with_gps_compass"]
        logits = 10.0 * jax.nn.one_hot(_stub_action(g[:, 0], g[:, 1], jnp), 4)
        return logits, jnp.zeros(g.shape[0]), hidden

    return SimpleNamespace(net=SimpleNamespace(hidden_size=4, num_recurrent_layers=1, rnn_type="LSTM"), apply=apply)


class _TorchStub(nn.Module):
    """The same controller as the port's policies are called."""

    def __init__(self):
        super().__init__()
        self.net = SimpleNamespace()

    def initial_hidden(self, n):
        return torch.zeros(n, 1, 2, 4)

    def forward(self, obs, hidden, prev_action, masks):
        g = obs["pointgoal_with_gps_compass"]
        logits = 10.0 * nn.functional.one_hot(_stub_action(g[:, 0], g[:, 1], torch).long(), 4).float()
        return logits, torch.zeros(g.shape[0]), hidden


@contextlib.contextmanager
def _jax_float32():
    """The JAX policy's encoder in float32 (bf16 unless patched), in this
    test only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_policy_module, "ResNetEncoder", functools.partial(JaxResNetEncoder, dtype=jnp.float32))
        yield


def _record(env, step_name, log):
    """Wrap ``env.<step_name>`` to log, per step, the episode each env was
    in (read before the step, which may take over the state's buffers), its
    done and its success and SPL."""
    step = getattr(env, step_name)

    def run(state, action):
        ep = np.array(state.ep_idx)
        out = step(state, action)
        _, _, _, d, info = out
        log.append((ep, *(np.array(x) for x in (d, info["success"], info["spl"]))))
        return out

    setattr(env, step_name, run)


def _counted(log, quota):
    """Each env's first ``quota`` finished episodes: [(env, ep_idx, success,
    spl)], in the order they finished."""
    seen = np.zeros(N, np.int64)
    out = []
    for ep, done, succ, spl in log:
        for i in np.flatnonzero(done):
            if seen[i] < quota:
                out.append((int(i), int(ep[i]), float(succ[i]), float(spl[i])))
                seen[i] += 1
    return out


@pytest.fixture(scope="module")
def envs():
    sj, ej, fj = jax_pointnav(num_scenes=2, episodes_per_scene=4, seed=4)
    st, et, ft = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=4)
    kw = dict(num_envs=N, sensor_specs=SENSORS, max_episode_steps=MAX_EP_STEPS)
    return (lambda: jax_make_nav_env(sj, ej, precomputed_fields=fj, **kw),
            lambda: make_nav_env(st, et, precomputed_fields=ft, device="cpu", **kw))


@pytest.mark.parametrize("which", ["stub", "policy"])
def test_evaluate_agent_matches_jax(envs, which):
    jenv, tenv = envs[0](), envs[1]()
    jlog, tlog = [], []
    _record(jenv, "step", jlog)
    _record(tenv, "step_fn", tlog)
    with _jax_float32():
        if which == "stub":
            jpol, params, tpol = _jax_stub(), None, _TorchStub()
        else:
            jpol = jax_policy(4, backbone="resnet9", hidden_size=32)
            obs = {"depth": jnp.zeros((N, HW, HW, 1)), "pointgoal_with_gps_compass": jnp.zeros((N, 2))}
            params = jpol.init(jax.random.PRNGKey(3), obs, jax_hidden(N, 32), jnp.zeros(N, jnp.int32), jnp.ones(N))
            sd = params_from_jax({k: np.asarray(v) for k, v in flatten_dict(params["params"], sep="/").items()})
            tpol = make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                                               hidden_size=32, dtype=torch.float32, device="cpu")
            tpol.load_state_dict(sd, strict=True)
        ref = jax_evaluate_agent(jenv, jpol, params, episodes_per_env=QUOTA, deterministic=True, seed=7)
    got = tev.evaluate_agent(tenv, tpol, episodes_per_env=QUOTA, deterministic=True, seed=7)
    assert got.keys() == ref.keys()
    assert got["num_episodes"] == ref["num_episodes"] == N * QUOTA
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    counted_j, counted_t = _counted(jlog, QUOTA), _counted(tlog, QUOTA)
    assert len(counted_t) == N * QUOTA
    assert [c[:3] for c in counted_t] == [c[:3] for c in counted_j]
    np.testing.assert_allclose([c[3] for c in counted_t], [c[3] for c in counted_j], rtol=0, atol=0)
    if which == "stub":  # walls stop a straight walk to most goals
        assert 0.0 < got["success"] < 1.0, "the counted episodes should hold successes and failures"


# ---- contracts of the port's evaluator -------------------------------------------------


@pytest.mark.parametrize("evals_per_ep", [1, 2])
def test_quota_is_counted_exactly_once(envs, evals_per_ep):
    """Each env counts its first quota x evals_per_ep episodes; with two
    passes over a quota that is the env's whole list, every episode of the
    list twice."""
    env = envs[1]()
    log = []
    _record(env, "step_fn", log)
    per_env = env.order.shape[1]
    got = tev.evaluate_agent(env, _TorchStub(), episodes_per_env=per_env, evals_per_ep=evals_per_ep,
                             deterministic=True)
    quota = per_env * evals_per_ep
    assert got["num_episodes"] == N * quota
    counted = _counted(log, quota)
    for i in range(N):
        eps = sorted(ep for e, ep, _, _ in counted if e == i)
        assert eps == sorted(env.order[i].tolist() * evals_per_ep)
    assert sum(np.asarray(d).sum() for _, d, _, _ in log) >= N * quota  # dones past a quota are not counted
    np.testing.assert_allclose(got["success"], np.mean([c[2] for c in counted]), rtol=1e-6)


def test_poll_checkpoint_folder(tmp_path):
    assert tev.poll_checkpoint_folder(str(tmp_path / "missing"), -1) is None
    for name in ("ckpt.0", "ckpt.2", "ckpt.10", "latest", "ckpt.2.meta.json", ".resume_state"):
        (tmp_path / name).write_text("")
    seen, prev = [], -1
    while (nxt := tev.poll_checkpoint_folder(str(tmp_path), prev)) is not None:
        seen.append(os.path.basename(nxt))
        prev = int(nxt.rsplit(".", 1)[1])
    assert seen == ["ckpt.0", "ckpt.2", "ckpt.10"]


def _trainer(folder, envs, updates=2):
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(HW, HW), backbone="resnet9",
                                         hidden_size=32, device="cpu")
    cfg = TrainerConfig(total_num_steps=updates * 4 * N, checkpoint_folder=str(folder), checkpoint_interval=1,
                        verbose=False)
    return PPOTrainer(envs[1](), policy, PPOConfig(num_steps=4, ppo_epoch=1, num_mini_batch=1), cfg)


def test_eval_checkpoint_loop_resumes(tmp_path, envs):
    """The port's trainer saves ckpt.0 and ckpt.1; an eval over a folder with
    ckpt.0 alone evaluates it and times out waiting; once ckpt.1 is there, a
    fresh eval resumes after ckpt.0, evaluates ckpt.1 alone and stops, the
    trainer being done at it."""
    train_dir, eval_dir = tmp_path / "train", tmp_path / "eval"
    _trainer(train_dir, envs).train(seed=0, resume=False)
    assert {"ckpt.0", "ckpt.1"} <= set(os.listdir(train_dir))
    eval_dir.mkdir()
    shutil.copy(train_dir / "ckpt.0", eval_dir / "ckpt.0")
    first = tev.eval_checkpoint_loop(_trainer(eval_dir, envs), seed=1, poll_interval_s=0.05, timeout_s=1.0)
    assert list(first) == [0] and first[0]["num_episodes"] > 0
    assert json.loads((eval_dir / ".eval_resume_state").read_text()) == {"prev_ckpt_ind": 0}
    shutil.copy(train_dir / "ckpt.1", eval_dir / "ckpt.1")
    second = tev.eval_checkpoint_loop(_trainer(eval_dir, envs), seed=1, poll_interval_s=0.05, timeout_s=60.0)
    assert list(second) == [1]
    assert json.loads((eval_dir / ".eval_resume_state").read_text()) == {"prev_ckpt_ind": 1}


class _Recorder:
    """A TensorBoard writer and a map tracker that log their calls."""

    def __init__(self):
        self.calls = []

    def add_video_from_np_images(self, name, step, images, fps=10):
        self.calls.append(("video", name, step, len(images), images[0].shape))

    def update(self, pos, yaw):
        self.calls.append(("update", tuple(np.round(pos, 3)), round(yaw, 3)))

    def frame(self):
        return np.full((16, 16, 3), 7, np.uint8)

    def reset(self):
        self.calls.append(("reset",))


@pytest.mark.parametrize("option", ["video_option", "tb_writer", "map_tracker"])
def test_unported_options_raise(envs, option, tmp_path):
    """Named for when these options raised: each now does its part."""
    env, policy, rec = envs[1](), _TorchStub(), _Recorder()
    kw = {"video_option": dict(video_option=("disk",), video_dir=str(tmp_path), video_env=1),
          "tb_writer": dict(video_option=("tensorboard",), tb_writer=rec, checkpoint_idx=4),
          "map_tracker": dict(video_option=("disk",), video_dir=str(tmp_path), map_tracker=rec)}[option]
    dones = []
    step = env.step_fn
    env.step_fn = lambda s, a: (lambda out: dones.append(out[3].numpy().copy()) or out)(step(s, a))
    tev.evaluate_agent(env, policy, episodes_per_env=QUOTA, deterministic=True, seed=7, **kw)
    d = np.array(dones)
    video_env = kw.get("video_env", 0)
    # frames while the video env's quota is open: up to its QUOTA-th done
    recorded = int(np.flatnonzero(d[:, video_env])[QUOTA - 1]) + 1
    if option == "tb_writer":
        assert rec.calls == [("video", "episodeenv0", 4, recorded, (HW, HW, 3))]
        return
    (name,) = os.listdir(tmp_path)
    assert name.startswith(f"episode=env{video_env}-ckpt=0-success=") and name.endswith(".gif")
    if option == "map_tracker":
        kinds = [c[0] for c in rec.calls]
        assert kinds.count("update") == recorded and kinds.count("reset") == QUOTA
        assert [k for k, c in enumerate(kinds[:-1]) if c == "reset"] == [
            k + i for i, k in enumerate(np.flatnonzero(d[:recorded, 0])[:QUOTA - 1] + 1)]


class _GaussianStub(nn.Module):
    """A continuous controller called as GaussianActorCritic is: mu from
    the joints and the previous action, a fixed log_std."""

    def __init__(self, num_outputs):
        super().__init__()
        self.net = SimpleNamespace(discrete_actions=False)
        self.num_outputs = num_outputs
        self.seen = []

    def initial_hidden(self, n):
        return torch.zeros(n, 1, 2, 4)

    def forward(self, obs, hidden, prev_action, masks):
        self.seen.append(prev_action.clone())
        mu = 0.1 * torch.tanh(obs["joint"].sum(-1, keepdim=True) + prev_action)
        return (mu, torch.full_like(mu, -1.0)), torch.zeros(mu.shape[0]), hidden


def test_gaussian_policy_evaluates():
    """The Gaussian branch on the blind arm-Pick env (N=2, 3-step episodes,
    2 per env): the first previous action is zeros (N, num_outputs), each
    next one the action taken; deterministic acts with mu, sampling draws
    from the generator; the quota counts 4 episodes."""
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    env = make_rearrange_env(num_envs=2, task="pick", num_scenes=1, episodes_per_scene=4, seed=0, with_visual=False,
                             n_rooms_per_axis=1, n_clutter=0, max_episode_steps=3, control="arm", device="cpu")
    acted = []
    step = env.step_fn

    def spy(state, action):
        acted.append(action.clone())
        return step(state, action)

    env.step_fn = spy
    policy = _GaussianStub(env.action_dim)
    out = tev.evaluate_agent(env, policy, episodes_per_env=2, deterministic=True, measure_keys=("success",))
    assert out["num_episodes"] == 4.0 and 0.0 <= out["success"] <= 1.0
    assert len(acted) == 6 and all(a.shape == (2, 10) and a.dtype == torch.float32 for a in acted)
    assert torch.equal(policy.seen[0], torch.zeros(2, 10))
    for prev, a in zip(policy.seen[1:], acted):
        assert torch.equal(prev, a)
    # deterministic: the action is mu, within the stub's 0.1 * tanh
    assert acted[0].abs().max() > 0 and (acted[0].abs() <= 0.1).all()
    env.step_fn = step
    sampled = tev.evaluate_agent(env, _GaussianStub(env.action_dim), episodes_per_env=2, seed=1)
    assert sampled["num_episodes"] == 4.0


def test_device_none_needs_the_card(envs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_policy_file(WEIGHTS)
    sc, ep, fields = make_procedural_pointnav(num_scenes=1, episodes_per_scene=1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_nav_env(sc, ep, num_envs=1, precomputed_fields=fields)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_eval()
