"""Embodied Question Answering (port of ``habitat_tpu/tasks/eqa.py``, under
the same registered names; reference habitat-lab/habitat/tasks/eqa/eqa.py).

- ``QuestionSensor``: the episode's question tokens, from the episode
  table's ``extras["question_tokens"]``, (N, L) int32.
- ``AnswerAction``: answering ends the episode (the reference EQATask's
  answer-once rule), one terminal action per answer id appended after the
  nav actions.
- Measures ``EpisodeInfo``, ``CorrectAnswer`` and ``AnswerAccuracy``.
- ``Mp3dEQADatasetV1`` (registered "MP3DEQA-v1") reads the reference's
  MP3D-EQA JSON schema; ``make_procedural_eqa`` asks "what is the category
  of the target object ?" over the annotated procedural scenes.
- The referent variant (``make_referent_eqa``, ``EQAObjectsSensor``,
  ``make_referent_eqa_env``): each episode shows a table of (category,
  colour) rows and asks the colour of one named category.

One rule differs from the JAX package on purpose: the referent draws seed
from ``episode_seed`` whenever it is given, 0 included (the JAX package's
``(episode_seed or seed)`` reads ``episode_seed=0`` as "not given").
"""

from __future__ import annotations

import dataclasses
import gzip
import json
from typing import Dict, List, Optional

import numpy as np
import torch

import habitat_torch.tasks.nav  # noqa: F401  (registers the nav components)
from habitat_torch.core.dataset import Episode, NavigationGoal
from habitat_torch.core.embodied_task import (
    FunctionalAction,
    FunctionalMeasure,
    FunctionalSensor,
    StepContext,
)
from habitat_torch.core.registry import registry
from habitat_torch.tasks.nav import _cfg

MAX_QUESTION_LEN = 16
NAV_ACTIONS = ("MoveForwardAction", "TurnLeftAction", "TurnRightAction")


@dataclasses.dataclass
class QuestionData:
    question_text: str = ""
    answer_text: str = ""
    question_tokens: Optional[List[int]] = None
    answer_token: Optional[int] = None
    question_type: Optional[str] = None


@dataclasses.dataclass
class EQAEpisode(Episode):
    goals: list = dataclasses.field(default_factory=list)
    question: QuestionData = dataclasses.field(default_factory=QuestionData)


@registry.register_dataset(name="MP3DEQA-v1")
class Mp3dEQADatasetV1:
    """Episodes of a reference MP3D-EQA JSON(.gz) file (``config.data_path``
    with ``{split}`` filled from ``config.split``), or of ``from_json``."""

    def __init__(self, config=None) -> None:
        self.episodes: List[EQAEpisode] = []
        self.question_vocab: Dict[str, int] = {}
        self.answer_vocab: Dict[str, int] = {}
        if config is None:
            return
        data_path = config.data_path.format(split=config.split)
        opener = gzip.open if data_path.endswith(".gz") else open
        with opener(data_path, "rt") as f:
            self.from_json(f.read())

    def from_json(self, json_str: str, scenes_dir=None) -> None:
        data = json.loads(json_str)
        self.question_vocab = data.get("question_vocab", {}).get("word2idx_dict", data.get("question_vocab", {}))
        self.answer_vocab = data.get("answer_vocab", {}).get("word2idx_dict", data.get("answer_vocab", {}))
        for ep in data.get("episodes", []):
            q = ep.get("question", {})
            self.episodes.append(
                EQAEpisode(
                    episode_id=str(ep["episode_id"]),
                    scene_id=ep["scene_id"],
                    start_position=list(ep["start_position"]),
                    start_rotation=list(ep["start_rotation"]),
                    info=ep.get("info", {}),
                    goals=[NavigationGoal(position=list(g["position"])) for g in ep.get("goals", [])],
                    question=QuestionData(
                        question_text=q.get("question_text", ""),
                        answer_text=q.get("answer_text", ""),
                        question_tokens=q.get("question_tokens"),
                        answer_token=q.get("answer_token"),
                        question_type=q.get("question_type"),
                    ),
                )
            )


@registry.register_sensor(name="QuestionSensor")
class QuestionSensor(FunctionalSensor):
    """The episode's question tokens, (N, max_question_len) int32."""

    uuid = "question"

    def __init__(self, config=None):
        super().__init__(config)
        self.max_len = _cfg(config, "max_question_len", MAX_QUESTION_LEN)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return ctx.table.extras["question_tokens"][ctx.ep_idx].to(torch.int32)


@registry.register_task_action(name="AnswerAction")
class AnswerAction(FunctionalAction):
    """Terminal answer: choosing any answer id stops the episode; accuracy
    is measured against the episode's answer."""

    name = "answer"

    def __init__(self, config=None, answer_id: int = 0):
        super().__init__(config)
        self.answer_id = answer_id
        self.name = f"answer_{answer_id}"

    def is_stop(self) -> bool:
        return True


@registry.register_measure(name="EpisodeInfo")
class EpisodeInfo(FunctionalMeasure):
    """The episode index, as float32."""

    uuid = "episode_info"

    def reset(self, ctx):
        return {}, ctx.ep_idx.float()

    def update(self, state, ctx, measures):
        return {}, ctx.ep_idx.float()


@registry.register_measure(name="CorrectAnswer")
class CorrectAnswer(FunctionalMeasure):
    """The ground-truth answer id, as float32 (-1 without one)."""

    uuid = "correct_answer"

    def reset(self, ctx):
        return {}, ctx.table.extras["answer"][ctx.ep_idx].float()

    def update(self, state, ctx, measures):
        return {}, ctx.table.extras["answer"][ctx.ep_idx].float()


@registry.register_measure(name="AnswerAccuracy")
class AnswerAccuracy(FunctionalMeasure):
    """1 when the action just taken is the answer action of the ground-truth
    answer. ``answer_base`` (config, default 3) is the index of answer_0 in
    the action list."""

    uuid = "answer_accuracy"
    deps = ("correct_answer",)

    def __init__(self, config=None):
        super().__init__(config)
        self.answer_base = _cfg(config, "answer_base", 3)

    def reset(self, ctx):
        return {}, torch.zeros(ctx.pos.shape[0], device=ctx.pos.device)

    def update(self, state, ctx, measures):
        chosen = ctx.action - self.answer_base
        answered = ctx.stop_called & (chosen >= 0)
        return {}, (answered & (chosen.float() == measures["correct_answer"])).float()


def make_procedural_eqa(num_scenes: int = 2, episodes_per_scene: int = 8, seed: int = 0, **kw):
    """EQA over the procedural ObjectNav episodes: 'what is the category of
    the target object ?', answered from ``OBJECT_CATEGORIES``. Returns
    (scenes, episodes, fields, vocab, answers)."""
    from habitat_torch.datasets.object_nav import make_procedural_objectnav
    from habitat_torch.sims.procedural import OBJECT_CATEGORIES

    scenes, on_eps, fields = make_procedural_objectnav(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed, **kw)
    vocab = {"<pad>": 0, "what": 1, "is": 2, "the": 3, "category": 4, "of": 5, "target": 6, "object": 7, "?": 8}
    episodes = []
    for ep in on_eps:
        q = QuestionData(
            question_text="what is the category of the target object ?",
            question_tokens=[1, 2, 3, 4, 5, 3, 6, 7, 8],
            answer_text=ep.object_category,
            answer_token=int(ep.info["object_category_id"]),
            question_type="category",
        )
        episodes.append(EQAEpisode(
            episode_id="eqa_" + ep.episode_id, scene_id=ep.scene_id, start_position=ep.start_position,
            start_rotation=ep.start_rotation, info=dict(ep.info), goals=ep.goals, question=q))
        fields["eqa_" + ep.episode_id] = fields.pop(ep.episode_id)
    return scenes, episodes, fields, vocab, list(OBJECT_CATEGORIES)


def eqa_extras(episodes: List[EQAEpisode], max_len: int = MAX_QUESTION_LEN) -> Dict[str, torch.Tensor]:
    """Questions and answers as episode-table extras: ``question_tokens``
    (E, max_len) int32 (zero-padded), ``answer`` (E,) int32 (-1 without
    one) and ``answer_token`` (the answer clipped at 0, VQA's target)."""
    E = len(episodes)
    toks = np.zeros((E, max_len), np.int32)
    ans = np.full((E,), -1, np.int32)
    for i, ep in enumerate(episodes):
        t = (ep.question.question_tokens or [])[:max_len]
        toks[i, : len(t)] = t
        if ep.question.answer_token is not None:
            ans[i] = ep.question.answer_token
    return {"question_tokens": torch.from_numpy(toks), "answer": torch.from_numpy(ans),
            "answer_token": torch.from_numpy(np.maximum(ans, 0))}


def _answer_env(scenes, episodes, fields, extras, sensors, num_envs, num_answers, seed, max_episode_steps, dev,
                goal_image_size=None):
    """The EQA BatchedEnv: forward, left and right, then ``num_answers``
    answer actions; reward and success are ``answer_accuracy`` (success
    reward 10, slack -0.01, the episode ends on success)."""
    from habitat_torch.core.batched_env import BatchedEnv, RewardSpec
    from habitat_torch.core.dataset import build_env_episode_order, build_episode_table
    from habitat_torch.sims.scene import pack_scenes

    scene_index = {s.scene_id: i for i, s in enumerate(scenes)}
    table = build_episode_table(episodes, {s.scene_id: s for s in scenes}, scene_index, precomputed_fields=fields,
                                goal_image_size=goal_image_size, device=dev)
    table = dataclasses.replace(table, extras=extras)
    order = build_env_episode_order(episodes, num_envs, seed=seed)
    nav = [registry.get_task_action(n)(None) for n in NAV_ACTIONS]
    actions = nav + [AnswerAction(None, answer_id=k) for k in range(num_answers)]
    answer_base = len(nav)
    measures = [
        registry.get_measure("DistanceToGoal")(None),
        EpisodeInfo(None),
        CorrectAnswer(None),
        AnswerAccuracy({"answer_base": answer_base}),
        registry.get_measure("NumSteps")(None),
    ]
    env = BatchedEnv(
        pack_scenes(scenes), table, order, sensors, measures, actions, device=dev,
        max_episode_steps=max_episode_steps,
        reward_spec=RewardSpec(reward_measure="answer_accuracy", success_measure="answer_accuracy",
                               slack_reward=-0.01, success_reward=10.0, end_on_success=True),
    )
    env.answer_base = answer_base
    return env


def make_eqa_env(
    num_envs: int = 4,
    num_answers: int = 10,
    num_scenes: int = 2,
    episodes_per_scene: int = 8,
    seed: int = 0,
    max_episode_steps: int = 100,
    visual_size: Optional[int] = None,
    device=None,
):
    """The EQA batched env on ``device`` (``None`` = cuda): question,
    pointgoal and objectgoal sensors; ``visual_size`` adds an RGB sensor and
    the table's goal views at that size (what the VQA and PACMAN trainers
    read), rendered once at table build."""
    from habitat_torch.device import resolve_device

    dev = resolve_device(device)
    scenes, episodes, fields, _, _ = make_procedural_eqa(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed)
    sensors = [QuestionSensor(None), registry.get_sensor("PointGoalWithGPSCompassSensor")(None),
               registry.get_sensor("ObjectGoalSensor")(None)]
    if visual_size is not None:
        sensors.append(registry.get_sensor("HabitatSimRGBSensor")({"height": visual_size, "width": visual_size}))
    return _answer_env(scenes, episodes, fields, eqa_extras(episodes), sensors, num_envs, num_answers, seed,
                       max_episode_steps, dev, goal_image_size=visual_size)


# ---------------------------------------------------------------------------
# Referent-grounding EQA
# ---------------------------------------------------------------------------

EQA_COLORS = ("red", "blue", "green", "yellow")


def referent_eqa_vocab() -> Dict[str, int]:
    """Base words, then the categories, then the colours (0 = pad)."""
    from habitat_torch.sims.procedural import OBJECT_CATEGORIES

    words = ["what", "is", "the", "color", "of", "?"] + list(OBJECT_CATEGORIES) + list(EQA_COLORS)
    return {w: i + 1 for i, w in enumerate(words)}


def make_referent_eqa(num_scenes: int = 4, episodes_per_scene: int = 64, seed: int = 0, n_objects: int = 4,
                      episode_seed: Optional[int] = None):
    """Referent EQA: each episode carries ``n_objects`` (category, colour)
    rows (categories distinct, colours a permutation) in an order the
    question does not decide; the question names one category ("what is
    the color of the sofa ?") and the answer is its colour, so an agent
    that ignores the words answers at 1 / ``n_objects``. The draws come from
    ``default_rng(e + 31)``, e = ``seed`` when ``episode_seed`` is None,
    else ``episode_seed``. Returns (scenes, episodes, fields, obj_rows)."""
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.sims.procedural import OBJECT_CATEGORIES

    vocab = referent_eqa_vocab()
    scenes, pn_eps, fields = make_procedural_pointnav(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed, episode_seed=episode_seed)
    rng = np.random.default_rng((seed if episode_seed is None else episode_seed) + 31)
    C, K = len(OBJECT_CATEGORIES), n_objects
    episodes, obj_rows = [], {}
    for ep in pn_eps:
        cats = rng.choice(C, K, replace=False)
        # colours without repeats: "answer row 0's colour" then scores 1/K
        cols = rng.permutation(len(EQA_COLORS))[:K]
        k = int(rng.integers(0, K))
        text = f"what is the color of the {OBJECT_CATEGORIES[cats[k]]} ?"
        eid = "eqar_" + ep.episode_id
        episodes.append(EQAEpisode(
            episode_id=eid, scene_id=ep.scene_id, start_position=ep.start_position,
            start_rotation=ep.start_rotation, info=dict(ep.info), goals=ep.goals,
            question=QuestionData(question_text=text, question_tokens=[vocab[w] for w in text.split()],
                                  answer_text=EQA_COLORS[cols[k]], answer_token=int(cols[k]),
                                  question_type="color")))
        row = np.zeros((K, C + len(EQA_COLORS)), np.float32)
        for j in range(K):
            row[j, cats[j]] = 1.0
            row[j, C + cols[j]] = 1.0
        obj_rows[eid] = row.reshape(-1)
        fields[eid] = fields.pop(ep.episode_id)
    return scenes, episodes, fields, obj_rows


class EQAObjectsSensor(FunctionalSensor):
    """The flattened (K, n_categories + n_colours) one-hot object table,
    the same for every object: only the question says which row matters."""

    uuid = "eqa_objects"

    def __init__(self, config=None, dim: int = 0):
        super().__init__(config)
        self.dim = dim

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return ctx.table.extras["eqa_objects"][ctx.ep_idx]


def make_referent_eqa_env(num_envs: int = 64, num_scenes: int = 4, episodes_per_scene: int = 64, seed: int = 0,
                          episode_seed: Optional[int] = None, max_episode_steps: int = 10, device=None):
    """The referent-EQA env on ``device`` (``None`` = cuda): the question
    and the object table only (no goal sensor), the nav actions and one
    answer per colour."""
    from habitat_torch.device import resolve_device

    dev = resolve_device(device)
    scenes, episodes, fields, obj_rows = make_referent_eqa(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed, episode_seed=episode_seed)
    extras = eqa_extras(episodes)
    extras["eqa_objects"] = torch.from_numpy(np.stack([obj_rows[ep.episode_id] for ep in episodes]))
    sensors = [QuestionSensor(None), EQAObjectsSensor(None, dim=int(extras["eqa_objects"].shape[-1]))]
    return _answer_env(scenes, episodes, fields, extras, sensors, num_envs, len(EQA_COLORS), seed,
                       max_episode_steps, dev)
