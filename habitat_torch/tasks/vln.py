"""Vision-and-Language Navigation (port of ``habitat_tpu/tasks/vln.py``;
reference habitat-lab/habitat/tasks/vln/vln.py and
datasets/vln/r2r_vln_dataset.py).

VLN is PointNav with an instruction observation: the success and SPL
measures and the stop action are the nav stack's, and the instruction
tokens ride in the episode table's extras.

- ``VLNDatasetV1`` (registered "R2RVLN-v1") reads the reference's R2R JSON
  schema; ``InstructionSensor`` gives the tokens, (N, L) int32.
- ``make_procedural_vln``: templated displacement instructions ("walk two
  point five meters forward then ...") in the episode-start frame, which
  fix the goal to 5 cm for an agent that reads its GPS.
- ``make_referent_vln`` / ``VLNCandidatesSensor``: two candidate goals in
  the observation, the true one named only by colour in the instruction.

The referent draws seed from ``episode_seed`` whenever it is given, 0
included (the JAX package's ``kw.get("episode_seed") or seed`` reads 0 as
"not given").
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
from habitat_torch.core.embodied_task import FunctionalSensor, StepContext
from habitat_torch.core.registry import registry
from habitat_torch.tasks.nav import _cfg
from habitat_torch.utils.geometry import rotate_world_to_agent

MAX_INSTRUCTION_LEN = 64

NUMBER_WORDS = (
    "zero one two three four five six seven eight nine ten "
    "eleven twelve thirteen fourteen fifteen"
).split()

# the procedural instructions' fixed vocabulary (0 = pad / unknown)
VLN_VOCAB = {
    w: i + 1
    for i, w in enumerate(
        NUMBER_WORDS
        + "point walk meters forward back left right then to reach the "
          "goal west east north south and until you "
          "go red blue box".split()
    )
}


@dataclasses.dataclass
class InstructionData:
    instruction_text: str = ""
    instruction_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class VLNEpisode(Episode):
    goals: list = dataclasses.field(default_factory=list)
    path: list = dataclasses.field(default_factory=list)
    instruction: InstructionData = dataclasses.field(default_factory=InstructionData)
    trajectory_id: str = ""


@registry.register_dataset(name="R2RVLN-v1")
class VLNDatasetV1:
    """Episodes of a reference R2R JSON(.gz) file (``config.data_path`` with
    ``{split}`` filled from ``config.split``), or of ``from_json``."""

    def __init__(self, config=None) -> None:
        self.episodes: List[VLNEpisode] = []
        self.instruction_vocab: Dict[str, int] = {}
        if config is None:
            return
        data_path = config.data_path.format(split=config.split)
        opener = gzip.open if data_path.endswith(".gz") else open
        with opener(data_path, "rt") as f:
            self.from_json(f.read())

    def from_json(self, json_str: str, scenes_dir=None) -> None:
        data = json.loads(json_str)
        self.instruction_vocab = data.get("instruction_vocab", {})
        for ep in data.get("episodes", []):
            ins = ep.get("instruction", {})
            self.episodes.append(
                VLNEpisode(
                    episode_id=str(ep["episode_id"]),
                    scene_id=ep["scene_id"],
                    start_position=list(ep["start_position"]),
                    start_rotation=list(ep["start_rotation"]),
                    info=ep.get("info", {}),
                    goals=[NavigationGoal(position=list(g["position"]), radius=g.get("radius"))
                           for g in ep.get("goals", [])],
                    path=ep.get("path", []),
                    trajectory_id=str(ep.get("trajectory_id", "")),
                    instruction=InstructionData(instruction_text=ins.get("instruction_text", ""),
                                                instruction_tokens=ins.get("instruction_tokens")),
                )
            )


@registry.register_sensor(name="InstructionSensor")
class InstructionSensor(FunctionalSensor):
    """The episode's instruction tokens, (N, max_instruction_len) int32."""

    uuid = "instruction"

    def __init__(self, config=None):
        super().__init__(config)
        self.max_len = _cfg(config, "max_instruction_len", MAX_INSTRUCTION_LEN)

    def compute(self, ctx: StepContext) -> torch.Tensor:
        return ctx.table.extras["instruction_tokens"][ctx.ep_idx].to(torch.int32)


def vln_extras(episodes: List[VLNEpisode], max_len: int = MAX_INSTRUCTION_LEN) -> Dict[str, torch.Tensor]:
    """``instruction_tokens`` (E, max_len) int32, zero-padded."""
    toks = np.zeros((len(episodes), max_len), np.int32)
    for i, ep in enumerate(episodes):
        t = (ep.instruction.instruction_tokens or [])[:max_len]
        toks[i, : len(t)] = t
    return {"instruction_tokens": torch.from_numpy(toks)}


def _number_words(v: float) -> str:
    m = min(int(abs(v)), len(NUMBER_WORDS) - 1)
    dm = min(int(round((abs(v) - int(abs(v))) * 10)), 9)
    return f"{NUMBER_WORDS[m]} point {NUMBER_WORDS[dm]}"


def make_procedural_vln(num_scenes: int = 2, episodes_per_scene: int = 8, seed: int = 0, **kw):
    """Procedural VLN over the PointNav episodes: the goal's displacement
    in the episode-start frame (the episodic GPS sensor's frame) in
    decimetre words. Returns (scenes, episodes, fields)."""
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    scenes, pn_eps, fields = make_procedural_pointnav(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed, **kw)
    episodes = []
    for ep in pn_eps:
        d = np.asarray(ep.goals[0].position) - np.asarray(ep.start_position)
        cy, sy = np.cos(-ep.start_yaw), np.sin(-ep.start_yaw)
        rel_x = cy * d[0] - sy * d[2]  # start-frame x (right)
        rel_z = sy * d[0] + cy * d[2]  # start-frame z (forward = -z)
        fwd, right = -float(rel_z), float(rel_x)
        text = (f"walk {_number_words(fwd)} meters {'forward' if fwd >= 0 else 'back'} then "
                f"{_number_words(right)} meters {'right' if right >= 0 else 'left'} to reach the goal")
        toks = [VLN_VOCAB.get(w, 0) for w in text.replace(",", "").split()]
        episodes.append(VLNEpisode(
            episode_id="vln_" + ep.episode_id, scene_id=ep.scene_id, start_position=ep.start_position,
            start_rotation=ep.start_rotation, info=dict(ep.info), goals=ep.goals,
            instruction=InstructionData(text, toks)))
        fields["vln_" + ep.episode_id] = fields.pop(ep.episode_id)
    return scenes, episodes, fields


def make_referent_vln(num_scenes: int = 2, episodes_per_scene: int = 8, seed: int = 0, **kw):
    """Referent VLN: two candidate goals per episode, the true goal and a
    navigable decoy more than 2 m from it, coloured red and blue in an order
    drawn per episode; the instruction ("go to the red box") names the true
    one's colour only, so a policy that ignores the words succeeds about
    half the time. Candidate rows hold world (x, z) and the colour one-hot;
    the draws come from ``default_rng(e + 777)``, e = ``episode_seed`` when
    given, else ``seed``. Returns (scenes, episodes, fields, cand_rows)."""
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    scenes, pn_eps, fields = make_procedural_pointnav(
        num_scenes=num_scenes, episodes_per_scene=episodes_per_scene, seed=seed, **kw)
    scene_map = {s.scene_id: s for s in scenes}
    episode_seed = kw.get("episode_seed")
    rng = np.random.default_rng((seed if episode_seed is None else episode_seed) + 777)
    episodes, cand_rows = [], {}
    for ep in pn_eps:
        scene = scene_map[ep.scene_id]
        g = np.asarray(ep.goals[0].position, np.float64)
        for _ in range(64):
            d = np.asarray(scene.sample_navigable_point(rng), np.float64)
            if np.linalg.norm((d - g)[[0, 2]]) > 2.0:
                break
        k_true = int(rng.integers(0, 2))
        cands = [None, None]
        cands[k_true], cands[1 - k_true] = g, d
        colors = ["red", "blue"] if rng.random() < 0.5 else ["blue", "red"]
        text = f"go to the {colors[k_true]} box"
        row = []
        for ci, col in zip(cands, colors):
            row += [float(ci[0]), float(ci[2]), 1.0 if col == "red" else 0.0, 1.0 if col == "blue" else 0.0]
        eid = "vlnr_" + ep.episode_id
        episodes.append(VLNEpisode(
            episode_id=eid, scene_id=ep.scene_id, start_position=ep.start_position,
            start_rotation=ep.start_rotation, info=dict(ep.info), goals=ep.goals,
            instruction=InstructionData(text, [VLN_VOCAB.get(w, 0) for w in text.split()])))
        cand_rows[eid] = np.asarray(row, np.float32)
        fields[eid] = fields.pop(ep.episode_id)
    return scenes, episodes, fields, cand_rows


def referent_extras(episodes, cand_rows, max_len: int = MAX_INSTRUCTION_LEN) -> Dict[str, torch.Tensor]:
    ex = vln_extras(episodes, max_len)
    ex["vln_candidates"] = torch.from_numpy(np.stack([cand_rows[ep.episode_id] for ep in episodes]))
    return ex


class VLNCandidatesSensor(FunctionalSensor):
    """(N, 8) = [fwd, right, is_red, is_blue] of both candidates in the
    current agent frame, the same form for each, so that only the
    instruction says which one is the target."""

    uuid = "vln_candidates"

    def compute(self, ctx: StepContext) -> torch.Tensor:
        rows = ctx.table.extras["vln_candidates"][ctx.ep_idx]  # (N, 8)
        outs = []
        for k in range(2):
            cw = rows[:, 4 * k: 4 * k + 2]  # world (x, z)
            rel = torch.stack([cw[:, 0] - ctx.pos[:, 0], torch.zeros_like(cw[:, 0]), cw[:, 1] - ctx.pos[:, 2]], dim=-1)
            ego = rotate_world_to_agent(rel, ctx.yaw)
            outs.append(torch.stack([-ego[:, 2], ego[:, 0]], dim=-1))
            outs.append(rows[:, 4 * k + 2: 4 * k + 4])
        return torch.cat(outs, dim=-1).float()


def make_vln_env(num_envs: int = 4, seed: int = 0, max_episode_steps: int = 200, with_pointgoal: bool = True,
                 visual_specs: tuple = (), referent: bool = False, device=None, **kw):
    """The VLN batched env on ``device`` (``None`` = cuda): stop, forward,
    left, right; instruction, GPS and compass (a VLN agent gets no goal
    sensor), the candidates with ``referent``, the cameras of
    ``visual_specs`` ((registry name, config) pairs) and, with
    ``with_pointgoal``, the oracle pointgoal. ``kw`` goes to the episode
    generator (num_scenes, episodes_per_scene, episode_seed, scene_kw)."""
    from habitat_torch.core.batched_env import BatchedEnv, RewardSpec
    from habitat_torch.core.dataset import build_env_episode_order, build_episode_table
    from habitat_torch.device import resolve_device
    from habitat_torch.sims.scene import pack_scenes

    dev = resolve_device(device)
    if referent:
        scenes, episodes, fields, cand_rows = make_referent_vln(seed=seed, **kw)
        extras = referent_extras(episodes, cand_rows)
    else:
        scenes, episodes, fields = make_procedural_vln(seed=seed, **kw)
        extras = vln_extras(episodes)
    scene_index = {s.scene_id: i for i, s in enumerate(scenes)}
    table = build_episode_table(episodes, {s.scene_id: s for s in scenes}, scene_index, precomputed_fields=fields)
    table = dataclasses.replace(table, extras=extras)
    order = build_env_episode_order(episodes, num_envs, seed=seed)
    actions = [registry.get_task_action(n)(None)
               for n in ("StopAction", "MoveForwardAction", "TurnLeftAction", "TurnRightAction")]
    sensors = [InstructionSensor(None), registry.get_sensor("GPSSensor")(None),
               registry.get_sensor("CompassSensor")(None)]
    if referent:
        sensors.append(VLNCandidatesSensor(None))
    sensors += [registry.get_sensor(name)(cfg) for name, cfg in visual_specs]
    if with_pointgoal:
        sensors.append(registry.get_sensor("PointGoalWithGPSCompassSensor")(None))
    measures = [registry.get_measure(n)(None)
                for n in ("DistanceToGoal", "Success", "SPL", "DistanceToGoalReward", "NumSteps")]
    return BatchedEnv(pack_scenes(scenes), table, order, sensors, measures, actions, device=dev,
                      max_episode_steps=max_episode_steps, reward_spec=RewardSpec(end_on_success=True))
