"""Unity/VR client wire protocol (port of ``habitat_tpu/hitl/unity_protocol.py``,
the port's own copy; reference habitat-hitl
_internal/networking/keyframe_utils.py + networking_process.py:301 +
core/remote_client_state.py).

The reference's Unity client speaks the habitat-sim gfx-replay JSON schema:
the server sends ``{"keyframes": [kf, ...]}`` where each keyframe carries
``loads`` / ``creations`` / ``stateUpdates`` / ``deletions`` / ``rigUpdates``
/ ``message`` entries keyed by ``instanceKey``, and the client replies with
client-state dicts carrying ``recentServerKeyframeId`` (flow-control ack),
``avatar`` (VR head/hand poses) and ``input`` (button events). This module
implements that schema over this engine's batched state:

- :func:`to_gfx_keyframe` converts the driver's internal keyframe
  (``hitl_main.make_keyframe``) into the Unity schema — object poses become
  ``stateUpdates`` with ``absTransform`` {translation, rotation(wxyz)}, the
  first frame carries ``creations`` so a client can instantiate prefabs.
- :func:`update_consolidated_keyframe` reproduces the reference's
  consolidation semantics (keyframe_utils.py:12-131): creations append,
  stateUpdates merge by instanceKey, a deletion cancels a pending creation
  and scrubs that key's stateUpdates/metadata.
- :class:`UnitySession` handles the late-joiner rule
  (networking_process.py:276-288): the first send to a new client is the
  consolidated keyframe capturing everything since the server started.
- :func:`parse_client_state` extracts ack / avatar / input from a client
  message (remote_client_state.py:138-220,274).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Keyframe = Dict[str, Any]

AVATAR_KEY = 0  # instanceKey of the (agent) avatar
OBJECT_KEY_BASE = 100  # rigid object i -> instanceKey 100+i
HUMANOID_KEY = 50


def _yaw_quat_wxyz(yaw: float) -> List[float]:
    """Rotation about +y as [w, x, y, z] (habitat-sim quaternion order)."""
    return [float(np.cos(yaw / 2.0)), 0.0, float(np.sin(yaw / 2.0)), 0.0]


def _wire_quat(rot) -> List[float]:
    """Normalize a driver rotation lane to wire order [w, x, y, z].

    Accepts a 1-element yaw scalar (batched-engine state lane) or a
    4-element [x, y, z, w] quaternion (the habitat-lab convention used for
    the agent, tpu_sim.py). Both the agent and object lanes route through
    this one normalization so component order can't diverge per lane."""
    if rot is None:
        return [1.0, 0.0, 0.0, 0.0]
    rot = [float(v) for v in rot]
    if len(rot) == 1:
        return _yaw_quat_wxyz(rot[0])
    x, y, z, w = rot
    return [w, x, y, z]


def get_empty_keyframe() -> Keyframe:
    return {
        "loads": [],
        "creations": [],
        "rigCreations": [],
        "stateUpdates": [],
        "metadata": [],
        "rigUpdates": [],
        "deletions": [],
        "lightsChanged": False,
        "lights": [],
    }


def _state_update(key: int, translation, rotation) -> Dict[str, Any]:
    return {
        "instanceKey": int(key),
        "state": {
            "absTransform": {
                "translation": [float(x) for x in translation],
                "rotation": [float(x) for x in rotation],
            },
            "semanticId": int(key),
        },
    }


def to_gfx_keyframe(
    internal_kf: Dict[str, Any], first: bool = False
) -> Keyframe:
    """Driver keyframe (hitl_main.make_keyframe) -> Unity gfx-replay schema.

    ``first=True`` emits creations (client instantiates a prefab per key;
    the reference ships render-asset filepaths from habitat-sim — here the
    engine's procedural/GLB assets are addressed by instanceKey)."""
    kf: Keyframe = {}
    if "id" in internal_kf:
        # wire id the client echoes back as recentServerKeyframeId; the
        # server gates sends on it (reference is_okay_to_send_keyframes)
        kf["id"] = int(internal_kf["id"])
    creations: List[Dict[str, Any]] = []
    updates: List[Dict[str, Any]] = []

    agent = internal_kf.get("agent")
    if agent is not None:
        quat = _wire_quat(agent.get("rotation", [0.0]))
        if first:
            creations.append(
                {
                    "instanceKey": AVATAR_KEY,
                    "creation": {"filepath": "avatar", "scale": [1, 1, 1]},
                }
            )
        updates.append(_state_update(AVATAR_KEY, agent["position"], quat))

    for i, obj in enumerate(internal_kf.get("objects", [])):
        key = OBJECT_KEY_BASE + int(obj.get("id", i))
        if first:
            creations.append(
                {
                    "instanceKey": key,
                    "creation": {
                        "filepath": obj.get("name", f"obj_{i}"),
                        "scale": [1, 1, 1],
                    },
                }
            )
        updates.append(
            _state_update(key, obj["position"], _wire_quat(obj.get("rotation")))
        )

    hum = internal_kf.get("humanoid")
    if hum is not None:
        if first:
            creations.append(
                {
                    "instanceKey": HUMANOID_KEY,
                    "creation": {"filepath": "humanoid", "scale": [1, 1, 1]},
                }
            )
        updates.append(
            _state_update(
                HUMANOID_KEY,
                hum["position"],
                _yaw_quat_wxyz(float(hum.get("rotation", [0.0])[0])),
            )
        )
        # articulated pose rides the rig channel (reference rigUpdates)
        joints = internal_kf.get("joints")
        if joints:
            kf["rigUpdates"] = [{"id": HUMANOID_KEY, "pose": list(joints)}]

    if creations:
        kf["creations"] = creations
    if updates:
        kf["stateUpdates"] = updates
    if "message" in internal_kf:
        # per-keyframe UI/text channel (the non-unity branch ships it inside
        # {"keyframes": kfs}; Unity clients read kf["message"])
        kf["message"] = internal_kf["message"]
    if "articulations" in internal_kf:
        kf.setdefault("metadata", []).append(
            {
                "instanceKey": AVATAR_KEY,
                "metadata": {"articulations": internal_kf["articulations"]},
            }
        )
    return kf


def update_consolidated_keyframe(con: Keyframe, inc: Keyframe) -> None:
    """Merge an incremental keyframe into a consolidated one
    (reference keyframe_utils.update_consolidated_keyframe semantics)."""
    assert con is not None and inc is not None

    if "id" in inc:
        con["id"] = inc["id"]

    if "loads" in inc:
        con.setdefault("loads", [])
        con["loads"] += inc["loads"]

    if "stateUpdates" in inc:
        con.setdefault("stateUpdates", [])
        for su in inc["stateUpdates"]:
            for con_su in con["stateUpdates"]:
                if con_su["instanceKey"] == su["instanceKey"]:
                    con_su["state"] = su["state"]
                    break
            else:
                con["stateUpdates"].append(su)

    if "metadata" in inc:
        con.setdefault("metadata", [])
        for md in inc["metadata"]:
            for con_md in con["metadata"]:
                if con_md["instanceKey"] == md["instanceKey"]:
                    con_md["metadata"] = md["metadata"]
                    break
            else:
                con["metadata"].append(md)

    if "rigUpdates" in inc:
        con.setdefault("rigUpdates", [])
        for ru in inc["rigUpdates"]:
            for con_ru in con["rigUpdates"]:
                if con_ru["id"] == ru["id"]:
                    con_ru["pose"] = ru["pose"]
                    break
            else:
                con["rigUpdates"].append(ru)

    for list_key in ("creations", "rigCreations"):
        if list_key in inc:
            con.setdefault(list_key, [])
            con[list_key] += inc[list_key]

    if "deletions" in inc:
        inc_deletions = inc["deletions"]
        for key in inc_deletions:
            # a matching pending creation cancels out with the deletion
            found = False
            for entry in con.get("creations", []):
                if entry["instanceKey"] == key:
                    con["creations"].remove(entry)
                    found = True
                    break
            if not found:
                con.setdefault("deletions", []).append(key)
        if "stateUpdates" in con:
            con["stateUpdates"] = [
                e for e in con["stateUpdates"]
                if e["instanceKey"] not in inc_deletions
            ]
        if "metadata" in con:
            con["metadata"] = [
                e for e in con["metadata"]
                if e["instanceKey"] not in inc_deletions
            ]


def get_user_keyframe(kf: Keyframe, message: Optional[Dict[str, Any]]) -> Keyframe:
    """Final per-user keyframe: keyframe + that user's message dict
    (reference keyframe_utils.get_user_keyframe)."""
    out = dict(kf)
    if message:
        out["message"] = message
    return out


def wrap_keyframes(kfs: List[Keyframe]) -> Dict[str, Any]:
    """The websocket payload (networking_process.py:301)."""
    return {"keyframes": kfs}


def parse_client_state(
    client_state: Dict[str, Any],
) -> Tuple[Optional[int], Optional[Dict[str, Any]], Optional[Dict[str, Any]]]:
    """-> (recentServerKeyframeId, avatar pose dict, input dict).

    Avatar: {"root": {"position": [3], "rotation": [4 wxyz]},
    "hands": [{"position", "rotation"}, ...]} (remote_client_state.py:175-220);
    input: {"buttonDown": [...], "buttonUp": [...], "buttonHeld": [...]}."""
    ack = client_state.get("recentServerKeyframeId")
    ack = int(ack) if ack is not None else None
    avatar = None
    if "avatar" in client_state:
        av = client_state["avatar"]
        avatar = {"root": av.get("root")}
        if "hands" in av:
            avatar["hands"] = av["hands"]
    return ack, avatar, client_state.get("input")


class UnitySession:
    """Per-connection keyframe stream with the reference's late-joiner and
    consolidation behavior (networking_process.py send_keyframes loop)."""

    def __init__(self) -> None:
        self.consolidated: Keyframe = get_empty_keyframe()
        self.needs_consolidated_keyframe = True
        self._first_emitted = False

    def ingest(self, internal_kf: Dict[str, Any]) -> Keyframe:
        """Convert + fold one driver keyframe into the consolidated state."""
        kf = to_gfx_keyframe(internal_kf, first=not self._first_emitted)
        self._first_emitted = True
        update_consolidated_keyframe(self.consolidated, kf)
        return kf

    def payload_for_send(
        self, inc_keyframes: List[Keyframe],
        message: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Wire payload: late joiners get the consolidated keyframe ONLY.

        ``ingest`` folds every incremental into the consolidated keyframe
        *before* this is called, so on the consolidated send the incrementals
        are already inside it — emitting them again would double-apply
        creations and rewind stateUpdates on the client (the reference avoids
        the overlap by building the payload before folding,
        networking_process.py send loop). We take the equivalent
        drop-the-incrementals form; any ``message`` still rides the
        consolidated keyframe so the text HUD isn't lost."""
        if self.needs_consolidated_keyframe:
            self.needs_consolidated_keyframe = False
            if message is None and inc_keyframes:
                message = inc_keyframes[-1].get("message")
            return wrap_keyframes([get_user_keyframe(self.consolidated, message)])
        to_send = [
            get_user_keyframe(
                kf,
                (message if i == len(inc_keyframes) - 1 else None)
                or kf.get("message"),
            )
            for i, kf in enumerate(inc_keyframes)
        ]
        return wrap_keyframes(to_send)
