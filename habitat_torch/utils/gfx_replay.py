"""gfx-replay keyframes (port of ``habitat_tpu/utils/gfx_replay.py``;
reference tasks/rearrange/utils.py write_gfx_replay and GfxReplayMeasure):
an env state converted to the JSON keyframe wire format (agent pose, rigid
object positions, articulated joint states), written and read back
(gzipped when the path ends in .gz), and a keyframe rendered again through
``render_batch`` (on the card, the pinhole route's kernel)."""

from __future__ import annotations

import gzip
import json
import os
from typing import Any, Dict, List

import torch


def _floats(t: torch.Tensor) -> List[float]:
    return [float(x) for x in t.tolist()]


def state_to_keyframe(state, env, env_idx: int = 0, step: int = 0) -> Dict[str, Any]:
    """One env of a nav or rearrange env state as a keyframe dict."""
    kf: Dict[str, Any] = {
        "step": int(step),
        "agent": {"position": _floats(state.pos[env_idx]), "yaw": float(state.yaw[env_idx])},
    }
    if hasattr(state, "obj_pos"):
        objs = env._obj_world(state)[env_idx]
        valid = env.table.obj_valid[state.ep_idx[env_idx]].tolist()
        kf["rigid_objects"] = [{"name": f"obj_{i}", "position": _floats(p)}
                               for i, (p, v) in enumerate(zip(objs, valid)) if v]
        kf["held"] = int(state.held[env_idx])
    if hasattr(state, "art_q"):
        kf["articulated_states"] = _floats(state.art_q[env_idx])
    return kf


class GfxReplayRecorder:
    """Collects keyframes of one env during a host-driven rollout."""

    def __init__(self, env, env_idx: int = 0):
        self.env = env
        self.env_idx = env_idx
        self.keyframes: List[Dict[str, Any]] = []

    def record(self, state) -> None:
        self.keyframes.append(state_to_keyframe(state, self.env, self.env_idx, len(self.keyframes)))

    def write(self, path: str) -> None:
        write_gfx_replay(json.dumps({"keyframes": self.keyframes}), path)

    def clear(self) -> None:
        self.keyframes = []


def write_gfx_replay(replay_json: str, path: str) -> None:
    """Write a replay string to ``path`` (gzipped when it ends in .gz)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(replay_json)


def load_gfx_replay(path: str) -> List[Dict[str, Any]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["keyframes"]


def render_keyframe(env, keyframe: Dict[str, Any], height: int = 256, width: int = 256,
                    scene_idx: int = 0) -> Dict[str, torch.Tensor]:
    """The frames (rgb, depth, semantic; no batch axis) seen from a
    keyframe's agent pose, the camera 1.25 m above it at pitch 0, in scene
    ``scene_idx`` of ``env.pack`` (0, as the JAX package renders), on the
    pack's device."""
    from habitat_torch.ops.raycast import render_batch

    dev = env.pack.nav_lo.device
    pos = torch.tensor(keyframe["agent"]["position"], dtype=torch.float32, device=dev)[None]
    yaw = torch.tensor([keyframe["agent"]["yaw"]], dtype=torch.float32, device=dev)
    cam = pos + torch.tensor([0.0, 1.25, 0.0], device=dev)
    out = render_batch(env.pack, torch.full((1,), scene_idx, dtype=torch.long, device=dev), cam, yaw,
                       torch.zeros(1, device=dev), height=height, width=width)
    return {k: v[0] for k, v in out.items()}
