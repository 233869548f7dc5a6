"""Functional task framework: sensors, measures and actions as functions over
a batched ``StepContext`` (port of ``habitat_tpu/core/embodied_task.py``).

Every component computes for all N envs at once from tensors; measure state
lives in the env state, so a step updates every env's metrics together.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from habitat_torch.core.dataset import EpisodeTable
from habitat_torch.sims.scene import ScenePack


@dataclasses.dataclass
class StepContext:
    """Everything a sensor/measure can see at one step, batched over N envs."""

    pack: ScenePack
    table: EpisodeTable
    ep_idx: torch.Tensor  # (N,)
    sid: torch.Tensor  # (N,) scene index
    pos: torch.Tensor  # (N,3)
    yaw: torch.Tensor  # (N,)
    pitch: torch.Tensor  # (N,)
    prev_pos: torch.Tensor  # (N,3)
    start_pos: torch.Tensor  # (N,3) — episode start
    start_yaw: torch.Tensor  # (N,)
    step: torch.Tensor  # (N,) int32 — steps taken this episode
    action: torch.Tensor  # (N,) int32 — action just taken (-1 at reset)
    stop_called: torch.Tensor  # (N,) bool
    collided: torch.Tensor  # (N,) bool — this step
    collision_count: torch.Tensor  # (N,) int32 — cumulative

    @property
    def goal_pos(self) -> torch.Tensor:
        """(N,G,3) current episode goal positions."""
        return self.table.goal_pos[self.ep_idx]

    @property
    def goal_valid(self) -> torch.Tensor:
        return self.table.goal_valid[self.ep_idx]

    @property
    def geodesic_start(self) -> torch.Tensor:
        return self.table.geodesic_start[self.ep_idx]


class FunctionalSensor:
    """A sensor = uuid + batched compute(ctx) -> (N, ...)."""

    uuid: str = ""

    def __init__(self, config: Any = None):
        self.config = config

    def compute(self, ctx: StepContext) -> torch.Tensor:
        raise NotImplementedError


class FunctionalMeasure:
    """A measure = uuid + deps + batched state machine.

    ``reset(ctx)`` -> (state, value); ``update(state, ctx, measures)`` ->
    (state, value), where ``measures`` maps dep uuid -> the value already
    updated this step. State is a dict of (N, ...) tensors (possibly empty).
    """

    uuid: str = ""
    deps: Tuple[str, ...] = ()

    def __init__(self, config: Any = None):
        self.config = config

    def reset(self, ctx: StepContext):
        raise NotImplementedError

    def update(self, state, ctx: StepContext, measures: Dict[str, torch.Tensor]):
        raise NotImplementedError


class FunctionalAction:
    """A discrete action reduced to (forward, turn, tilt, stop) amounts that
    the env stacks into per-action tables."""

    name: str = ""

    def __init__(self, config: Any = None):
        self.config = config

    def move_amount(self) -> float:
        return 0.0

    def turn_amount(self) -> float:
        return 0.0

    def tilt_amount(self) -> float:
        return 0.0

    def is_stop(self) -> bool:
        return False


class Metrics(dict):
    """Flat dict of measure values (reference embodied_task.py:129)."""


def order_measures(measures: Sequence[FunctionalMeasure]) -> Tuple[FunctionalMeasure, ...]:
    """Topological sort by declared deps."""
    by_uuid = {m.uuid: m for m in measures}
    for m in measures:
        for d in m.deps:
            if d not in by_uuid:
                raise ValueError(
                    f"Measure {m.uuid!r} requires dependency {d!r} which is not "
                    f"among the enabled measures {sorted(by_uuid)}"
                )
    ordered = []
    visited: Dict[str, int] = {}

    def visit(uuid: str):
        st = visited.get(uuid, 0)
        if st == 1:
            raise ValueError(f"Measure dependency cycle at {uuid!r}")
        if st == 2:
            return
        visited[uuid] = 1
        for d in by_uuid[uuid].deps:
            visit(d)
        visited[uuid] = 2
        ordered.append(by_uuid[uuid])

    for m in measures:
        visit(m.uuid)
    return tuple(ordered)
