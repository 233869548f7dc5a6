"""habitat_torch's EQA and VLN tasks and the policy's language inputs against
habitat_tpu's on the CPU, on the same numpy-seeded scenes and episodes.

- The four envs (``make_eqa_env``, ``make_referent_eqa_env``,
  ``make_vln_env`` plain and referent; N=4, small scene sets, a nonzero
  ``episode_seed`` where the generator takes one) over a reset and 20 steps
  (EQA) or 40 (VLN, goals 1-2.5 m away) with the same actions in both: nav
  actions drawn from a numpy seed, then answer actions chosen on purpose
  (right in some envs, wrong in others) for EQA, the port's geodesic
  follower (stop included) for VLN. ``question``,
  ``instruction`` and ``eqa_objects`` equal, ``vln_candidates``, GPS and
  compass within 1e-5, episode ids, dones and ``correct_answer`` equal,
  ``answer_accuracy``, success, SPL, distances and rewards within 1e-5
  (the JAX reset and step both jitted: the port's cell index is the
  compiled one, ``ops/navgrid.world_to_cell_f``); some answers right, some
  wrong, some VLN episodes successful.
- Both loaders read the JAX tests' inline JSON into the same fields.
- ``episode_seed=0``: the port's referent draws come from
  ``default_rng(0 + 31)`` (EQA) and ``default_rng(0 + 777)`` (VLN), the JAX
  package's from ``seed``'s, the fault the port does not copy.
- The policy with ``instruction`` (and ``vln_candidates``) and with
  ``question`` + ``eqa_objects``, blind and over 32x32 depth (resnet9, both
  in float32), on padded tokens (an all-pad row included) from converted
  weights: logits, values and the new hidden state within 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
from habitat_tpu.models.rnn_state_encoder import initial_hidden_state as jax_hidden
from habitat_tpu.tasks import eqa as jeqa
from habitat_tpu.tasks import vln as jvln

from habitat_torch.core.registry import registry
from habitat_torch.models.convert import params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy, obs_inputs_of
from habitat_torch.ops.navgrid import greedy_follower_step
from habitat_torch.tasks import eqa as teqa
from habitat_torch.tasks import vln as tvln

from tests.test_torch_ppo import _flat, _jax_as
from tests.torch_jax_native import _jax_native  # noqa: F401

N, ATOL = 4, 1e-5
STEPS = {"eqa": 20, "referent_eqa": 20, "vln": 40, "referent_vln": 40}
EXACT = ("question", "instruction", "eqa_objects")
CLOSE = ("vln_candidates", "gps", "compass", "pointgoal_with_gps_compass")
MEASURES = ("answer_accuracy", "correct_answer", "success", "spl", "distance_to_goal", "num_steps")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ENVS = {
    "eqa": lambda m, **d: m.make_eqa_env(num_envs=N, num_scenes=1, episodes_per_scene=6, seed=0,
                                         max_episode_steps=8, **d),
    "referent_eqa": lambda m, **d: m.make_referent_eqa_env(num_envs=N, num_scenes=2, episodes_per_scene=4, seed=0,
                                                           episode_seed=3, max_episode_steps=8, **d),
    "vln": lambda m, **d: m.make_vln_env(num_envs=N, num_scenes=1, episodes_per_scene=6, seed=0, episode_seed=2,
                                         max_episode_steps=30, **SHORT, **d),
    "referent_vln": lambda m, **d: m.make_vln_env(num_envs=N, num_scenes=2, episodes_per_scene=4, seed=0,
                                                  episode_seed=5, referent=True, max_episode_steps=30, **SHORT, **d),
}
# VLN episodes the follower ends within the run: one room, goals 1-2.5 m away
SHORT = dict(scene_kw={"n_rooms_per_axis": 1}, closest_dist_limit=1.0, furthest_dist_limit=2.5)


def _pair(name):
    jmod, tmod = (jeqa, teqa) if "eqa" in name else (jvln, tvln)
    return ENVS[name](jmod), ENVS[name](tmod, device="cpu")


def _actions(name, te, st, t, rng):
    """The step's actions: VLN follows the port's follower (goal radius
    0.2, stop at the goal); EQA walks at random, then at steps 5 and 12
    answers, right in envs 0 and 2 and wrong in env 1."""
    if "vln" in name:
        ep = st.ep_idx
        return greedy_follower_step(te.pack, te.table.scene_idx[ep].long(), te.table.dist_field, ep, st.pos, st.yaw,
                                    goal_radius=0.2, forward_step=0.25, turn_angle=float(np.deg2rad(10.0)))
    a = torch.from_numpy(rng.integers(0, 3, N))
    if t in (5, 12):
        gt = te.table.extras["answer"][st.ep_idx].long()
        k = te.num_actions - te.answer_base
        a[0], a[1], a[2] = te.answer_base + gt[0], te.answer_base + (gt[1] + 1) % k, te.answer_base + gt[2]
    return a


@pytest.mark.parametrize("name", list(ENVS))
def test_env_matches_jax(name):
    je, te = _pair(name)
    jstep = jax.jit(je.step_fn)
    js, jo = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    ts, to = te.reset_fn()
    rng = np.random.default_rng(1)
    seen = {"right": 0, "wrong": 0, "success": 0}

    def same(jo, to, step):
        assert set(to) == set(jo), step
        for k in EXACT:
            if k in to:
                np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=f"{k}@{step}")
        for k in CLOSE:
            if k in to:
                np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=ATOL, err_msg=f"{k}@{step}")

    same(jo, to, "reset")
    for t in range(STEPS[name]):
        a = _actions(name, te, ts, t, rng)
        js, jo, jr, jd, ji = jstep(js, jnp.asarray(a.numpy(), jnp.int32))
        ts, to, tr, td, ti = te.step_fn(ts, a)
        same(jo, to, t)
        np.testing.assert_array_equal(ts.ep_idx.numpy(), np.asarray(js.ep_idx), err_msg=f"ep@{t}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done@{t}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, err_msg=f"reward@{t}")
        for k in MEASURES:
            if k in ti:
                np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]), atol=ATOL, err_msg=f"{k}@{t}")
        if "answer_accuracy" in ti:
            answered = (a >= te.answer_base).numpy()
            seen["right"] += int((ti["answer_accuracy"].numpy() > 0).sum())
            seen["wrong"] += int((answered & (ti["answer_accuracy"].numpy() == 0)).sum())
        else:
            seen["success"] += int((ti["success"] > 0).sum())
    if "eqa" in name:
        assert seen["right"] >= 2 and seen["wrong"] >= 1, seen
    else:
        assert seen["success"] >= 1, seen


def test_registry_resolves_eqa_and_vln():
    import habitat_torch.core.construct  # noqa: F401  (registers everything the configs name)

    assert registry.get_sensor("QuestionSensor") is teqa.QuestionSensor
    assert registry.get_sensor("InstructionSensor") is tvln.InstructionSensor
    assert registry.get_task_action("AnswerAction") is teqa.AnswerAction
    for name, cls in (("EpisodeInfo", teqa.EpisodeInfo), ("CorrectAnswer", teqa.CorrectAnswer),
                      ("AnswerAccuracy", teqa.AnswerAccuracy)):
        assert registry.get_measure(name) is cls
    assert registry.get_dataset("MP3DEQA-v1") is teqa.Mp3dEQADatasetV1
    assert registry.get_dataset("R2RVLN-v1") is tvln.VLNDatasetV1
    assert teqa.AnswerAction(None, answer_id=3).is_stop() and teqa.AnswerAction(None, 3).name == "answer_3"


# the JAX tests' inline JSON (tests/test_eqa_vln.py)
R2R = {"instruction_vocab": {"walk": 1}, "episodes": [{
    "episode_id": 1, "scene_id": "sc", "start_position": [0, 0, 0], "start_rotation": [0, 0, 0, 1],
    "goals": [{"position": [1, 0, 1], "radius": 3.0}], "path": [[0, 0, 0], [1, 0, 1]], "trajectory_id": 7,
    "instruction": {"instruction_text": "walk", "instruction_tokens": [1]}}]}
MP3D_EQA = {"question_vocab": {"word2idx_dict": {"what": 1}}, "answer_vocab": {"word2idx_dict": {"red": 0}},
            "episodes": [{"episode_id": 0, "scene_id": "sc", "start_position": [0, 0, 0],
                          "start_rotation": [0, 0, 0, 1], "goals": [{"position": [1, 0, 1]}],
                          "question": {"question_text": "what colour is the sofa ?", "answer_text": "red",
                                       "question_tokens": [1, 2, 3, 4, 5, 6], "answer_token": 0}}]}


@pytest.mark.parametrize("kind", ["r2r", "mp3d_eqa"])
def test_loaders_read_the_jax_tests_json(kind):
    data, jcls, tcls = ((R2R, jvln.VLNDatasetV1, tvln.VLNDatasetV1) if kind == "r2r"
                        else (MP3D_EQA, jeqa.Mp3dEQADatasetV1, teqa.Mp3dEQADatasetV1))
    jd, td = jcls(), tcls()
    jd.from_json(json.dumps(data))
    td.from_json(json.dumps(data))
    assert len(td.episodes) == len(jd.episodes) == 1
    # the JAX episode also carries its sims' path cache, which the port's has not
    jfields = {k: v for k, v in dataclasses.asdict(jd.episodes[0]).items() if k != "_shortest_path_cache"}
    assert dataclasses.asdict(td.episodes[0]) == jfields
    for vocab in ("instruction_vocab", "question_vocab", "answer_vocab"):
        if hasattr(jd, vocab):
            assert getattr(td, vocab) == getattr(jd, vocab)
    if kind == "r2r":
        assert td.episodes[0].instruction.instruction_tokens == [1] and td.episodes[0].goals[0].radius == 3.0
    else:
        assert td.episodes[0].question.answer_token == 0


def _referent_eqa_answers(seed, n):
    """The referent EQA generator's answers for n episodes, its draws from
    ``default_rng(seed)`` replayed."""
    rng, out = np.random.default_rng(seed), []
    for _ in range(n):
        rng.choice(10, 4, replace=False)
        cols = rng.permutation(4)[:4]
        out.append(int(cols[int(rng.integers(0, 4))]))
    return out


def test_episode_seed_zero_is_a_seed():
    """``episode_seed=0`` seeds the referent draws with 0 in the port; the
    JAX package's ``(episode_seed or seed)`` falls back to ``seed``."""
    kw = dict(num_scenes=1, episodes_per_scene=6, seed=5)
    _, teps, _, _ = teqa.make_referent_eqa(episode_seed=0, **kw)
    _, jeps, _, _ = jeqa.make_referent_eqa(episode_seed=0, **kw)
    _, t_none, _, _ = teqa.make_referent_eqa(episode_seed=None, **kw)
    answers = lambda eps: [e.question.answer_token for e in eps]  # noqa: E731
    assert len(teps) == len(jeps)
    assert answers(teps) == _referent_eqa_answers(0 + 31, len(teps))
    assert answers(jeps) == _referent_eqa_answers(5 + 31, len(jeps))
    assert answers(t_none) == _referent_eqa_answers(5 + 31, len(t_none))
    assert answers(teps) != answers(jeps)
    # VLN: the same start/goal pairs, the decoys and colours from rng(0 + 777)
    vkw = dict(num_scenes=1, episodes_per_scene=6, seed=5, scene_kw={"n_rooms_per_axis": 1})
    _, tv0, _, rows0 = tvln.make_referent_vln(episode_seed=0, **vkw)
    _, jv0, _, jrows0 = jvln.make_referent_vln(episode_seed=0, **vkw)
    _, tv5, _, rows5 = tvln.make_referent_vln(episode_seed=5, **vkw)
    _, jv5, _, jrows5 = jvln.make_referent_vln(episode_seed=5, **vkw)
    assert [e.start_position for e in tv0] == [e.start_position for e in jv0]
    assert all(np.array_equal(rows5[k], jrows5[k]) for k in rows5)  # a nonzero episode_seed: equal
    assert not all(np.array_equal(rows0[k], jrows0[k]) for k in rows0)  # 0: the port's own draws


# -- the policy's language inputs ------------------------------------------------

L_INSTR, L_QUESTION = 64, 16


def _tokens(rng, n, length):
    """Padded token rows: random lengths in [1, length - 1], one row all pad."""
    toks = np.zeros((n, length), np.int32)
    for i in range(n - 1):
        k = int(rng.integers(1, length))
        toks[i, :k] = rng.integers(1, 128, k)
    return toks


POLICY_CASES = {
    "instruction-blind": dict(lang="instruction", table=None, visual=False),
    "instruction-candidates-depth": dict(lang="instruction", table=("vln_candidates", 8), visual=True),
    "question-objects-blind": dict(lang="question", table=("eqa_objects", 56), visual=False),
    "question-depth": dict(lang="question", table=None, visual=True),
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_language_policy_matches_jax(case):
    c = POLICY_CASES[case]
    rng = np.random.default_rng(7)
    n, hidden, hw = 5, 32, 32
    obs = {c["lang"]: _tokens(rng, n, L_INSTR if c["lang"] == "instruction" else L_QUESTION),
           "gps": rng.normal(size=(n, 2)).astype(np.float32),
           "compass": rng.uniform(-3, 3, (n, 1)).astype(np.float32)}
    if c["table"]:
        obs[c["table"][0]] = rng.normal(size=(n, c["table"][1])).astype(np.float32)
    if c["visual"]:
        obs["depth"] = rng.uniform(0, 1, (n, hw, hw, 1)).astype(np.float32)
    shapes = {k: (v.shape[1:], None) for k, v in obs.items()}
    kw = dict(backbone="resnet9", hidden_size=hidden, has_visual=c["visual"], goal_keys=())
    prev = rng.integers(0, 4, n).astype(np.int32)
    masks = np.array([0, 1, 1, 0, 1], np.float32)
    h0 = rng.normal(size=(n, 1, 2, hidden)).astype(np.float32)
    with _jax_as("float32", all_ties=True):
        jpol = jax_policy(4, **kw)
        jobs = {k: jnp.asarray(v) for k, v in obs.items()}
        params = jax.jit(jpol.init)(jax.random.PRNGKey(3), jobs, jax_hidden(n, hidden, 1, "LSTM"),
                                    jnp.zeros(n, jnp.int32), jnp.zeros(n))
        jl, jv, jh = jax.jit(jpol.apply)(params, jobs, jnp.asarray(h0), jnp.asarray(prev), jnp.asarray(masks))
    inputs = obs_inputs_of(shapes)
    assert inputs["instruction_encoder"] and set(inputs["state_keys"]) == {"gps", "compass"} | (
        {c["table"][0]} if c["table"] else set())
    tpol = make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(hw, hw), dtype=torch.float32,
                                       device="cpu", **kw, **inputs)
    sd = params_from_jax(_flat(params["params"]))
    assert set(sd) == set(tpol.state_dict())
    tpol.load_state_dict(sd)
    with torch.no_grad():
        tl, tv, th = tpol({k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(h0),
                          torch.from_numpy(prev), torch.from_numpy(masks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=1e-4)
