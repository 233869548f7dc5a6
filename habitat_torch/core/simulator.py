"""Simulator and sensor abstractions, the host-facing API (port of
``habitat_tpu/core/simulator.py``; reference habitat-lab/habitat/core/
simulator.py): ``SensorTypes`` (:55), ``Sensor`` (:74), ``Observations``
(:113), ``SensorSuite`` (:215), ``AgentState`` (:252),
``ShortestPathPoint`` (:264) and the ``Simulator`` base (:278).

The batched envs never touch these classes: they call the functional sensors
of ``habitat_torch/tasks`` directly. These exist for code written against the
reference API (agents, benchmarks, examples) and for ``sims/tpu_sim.py``.
The port has no gymnasium: an observation space is the shape descriptor the
port's envs give in ``observation_shapes``, a ``(shape, dtype)`` pair, and a
suite's ``observation_spaces`` is a dict of them.
"""

from __future__ import annotations

import abc
import dataclasses
from collections import OrderedDict
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# (shape, dtype): the port's observation descriptor
Space = Tuple[Tuple[int, ...], Any]


class SensorTypes(Enum):
    NULL = 0
    COLOR = 1
    DEPTH = 2
    NORMAL = 3
    SEMANTIC = 4
    PATH = 5
    POSITION = 6
    FORCE = 7
    TENSOR = 8
    TEXT = 9
    MEASUREMENT = 10
    HEADING = 11
    TACTILE = 12
    TOKEN_IDS = 13


class Sensor(metaclass=abc.ABCMeta):
    """Host-facing sensor: a uuid, a type, an observation descriptor
    ``(shape, dtype)`` and the reference's per-instance
    ``get_observation``."""

    uuid: str
    config: Any
    sensor_type: SensorTypes
    observation_space: Space

    def __init__(self, config: Any = None, *args, **kwargs) -> None:
        self.config = config
        self.uuid = self._get_uuid(*args, **kwargs)
        self.sensor_type = self._get_sensor_type(*args, **kwargs)
        self.observation_space = self._get_observation_space(*args, **kwargs)

    def _get_uuid(self, *args, **kwargs) -> str:
        raise NotImplementedError

    def _get_sensor_type(self, *args, **kwargs) -> SensorTypes:
        raise NotImplementedError

    def _get_observation_space(self, *args, **kwargs) -> Space:
        raise NotImplementedError

    def get_observation(self, *args, **kwargs) -> Any:
        raise NotImplementedError


class Observations(Dict[str, Any]):
    """Dict of sensor observations (reference simulator.py:113)."""

    def __init__(self, sensors: Dict[str, Sensor], *args, **kwargs) -> None:
        data = [(uuid, s.get_observation(*args, **kwargs)) for uuid, s in sensors.items()]
        super().__init__(data)


class SensorSuite:
    """Named collection of sensors (reference simulator.py:215)."""

    sensors: Dict[str, Sensor]
    observation_spaces: Dict[str, Space]

    def __init__(self, sensors: Iterable[Sensor]) -> None:
        self.sensors = OrderedDict()
        spaces: "OrderedDict[str, Space]" = OrderedDict()
        for sensor in sensors:
            assert sensor.uuid not in self.sensors, f"duplicate sensor uuid {sensor.uuid}"
            self.sensors[sensor.uuid] = sensor
            spaces[sensor.uuid] = sensor.observation_space
        self.observation_spaces = spaces

    def get(self, uuid: str) -> Sensor:
        return self.sensors[uuid]

    def get_observations(self, *args, **kwargs) -> Observations:
        return Observations(self.sensors, *args, **kwargs)


@dataclasses.dataclass
class AgentState:
    position: np.ndarray
    rotation: Optional[np.ndarray]  # quaternion coeffs [x,y,z,w]


@dataclasses.dataclass
class ShortestPathPoint:
    position: List[Any]
    rotation: List[Any]
    action: Optional[int] = None


class Simulator:
    """The simulator base (reference core/simulator.py:278-450)."""

    habitat_config: Any

    def __init__(self, *args, **kwargs) -> None:
        pass

    @property
    def sensor_suite(self) -> SensorSuite:
        raise NotImplementedError

    @property
    def action_space(self) -> Any:
        raise NotImplementedError

    def reset(self) -> Observations:
        raise NotImplementedError

    def step(self, action, *args, **kwargs) -> Observations:
        raise NotImplementedError

    def seed(self, seed: int) -> None:
        raise NotImplementedError

    def reconfigure(self, config: Any) -> None:
        raise NotImplementedError

    def geodesic_distance(
        self,
        position_a: Sequence[float],
        position_b: Sequence[Sequence[float]],
        episode: Optional[Episode] = None,  # noqa: F821
    ) -> float:
        raise NotImplementedError

    def get_agent_state(self, agent_id: int = 0) -> AgentState:
        raise NotImplementedError

    def get_observations_at(
        self,
        position: List[float],
        rotation: List[float],
        keep_agent_at_new_pose: bool = False,
    ) -> Optional[Observations]:
        raise NotImplementedError

    def sample_navigable_point(self) -> List[float]:
        raise NotImplementedError

    def is_navigable(self, point: List[float]) -> bool:
        raise NotImplementedError

    def action_space_shortest_path(
        self, source: AgentState, targets: Sequence[AgentState], agent_id: int = 0
    ) -> List[ShortestPathPoint]:
        raise NotImplementedError

    def get_straight_shortest_path_points(
        self, position_a: Sequence[float], position_b: Sequence[float]
    ) -> List[List[float]]:
        raise NotImplementedError

    @property
    def up_vector(self) -> np.ndarray:
        return np.array([0.0, 1.0, 0.0])

    @property
    def forward_vector(self) -> np.ndarray:
        return np.array([0.0, 0.0, -1.0])

    def render(self, mode: str = "rgb") -> Any:
        raise NotImplementedError

    def close(self, destroy: bool = True) -> None:
        pass

    def previous_step_collided(self) -> bool:
        raise NotImplementedError

    def __enter__(self) -> "Simulator":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()
