"""ShortestPathFollower: the greedy geodesic action oracle (port of
``habitat_tpu/tasks/shortest_path_follower.py``; reference
tasks/nav/shortest_path_follower.py:24-95, which wraps the C++
GreedyGeodesicFollower). It descends a geodesic distance field to the goal
with ``ops/navgrid.greedy_follower_step``.

The simulator is duck-typed; the follower reads these attributes of it:

- ``_scene``: the ``SceneData`` (``nav_occ``, ``nav_res``, ``world_to_cell``);
- ``pack``: that one scene as a ``ScenePack`` (its tensors' device is the
  follower's);
- ``_pos`` (3,) world position and ``_yaw`` (radians) of the agent;
- ``_fwd_step`` (metres) and ``_turn`` (radians) of its move and turn actions.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from habitat_torch.ops.navgrid import greedy_follower_step
from habitat_torch.sims.scene import geodesic_field


class ShortestPathFollower:
    def __init__(self, sim, goal_radius: float, return_one_hot: bool = True, stop_on_error: bool = True):
        self._sim = sim
        self._goal_radius = goal_radius
        self._return_one_hot = return_one_hot
        self._field = None
        self._goal = None

    def _maybe_field(self, goal_pos):
        """The (1, NX, NZ) float32 field to ``goal_pos``, computed once per
        goal (rounded to the millimetre)."""
        g = tuple(np.round(np.asarray(goal_pos), 3))
        if self._goal != g:
            scene = self._sim._scene
            cell = scene.world_to_cell(np.asarray(goal_pos)[[0, 2]])
            field = geodesic_field(scene.nav_occ, cell[None], scene.nav_res)
            self._field = torch.as_tensor(field[None], device=self._sim.pack.nav_lo.device)
            self._goal = g

    def get_next_action(self, goal_pos) -> Union[int, np.ndarray]:
        """0=stop 1=fwd 2=left 3=right (HabitatSimActions order); a
        one-hot float32 (4,) with ``return_one_hot``."""
        self._maybe_field(goal_pos)
        sim = self._sim
        dev = self._field.device
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        act = greedy_follower_step(
            sim.pack, zero, self._field, zero,
            torch.as_tensor(np.asarray(sim._pos, np.float32)[None], device=dev),
            torch.full((1,), float(sim._yaw), dtype=torch.float32, device=dev),
            goal_radius=self._goal_radius, forward_step=sim._fwd_step, turn_angle=float(sim._turn),
        )
        act = int(act.item())
        if self._return_one_hot:
            out = np.zeros(4, np.float32)
            out[act] = 1.0
            return out
        return act

    @property
    def mode(self) -> str:
        return "geodesic_path"

    @mode.setter
    def mode(self, new_mode: str):
        if new_mode not in ("geodesic_path", "greedy"):
            raise ValueError(f"mode {new_mode!r}: geodesic_path or greedy")
