"""Heuristic agents (port of ``habitat_tpu/baselines/agents/simple_agents.py``;
reference habitat-baselines/habitat_baselines/agents/simple_agents.py).

Each reads one observation (no batch axis) whose pointgoal is (distance,
angle), as numpy arrays or tensors on any device. ``RandomAgent`` and its
kin draw from ``numpy.random.default_rng(0)``, as the JAX package's do, so
both packages give the same sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from habitat_torch.core.agent import Agent

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class RandomAgent(Agent):
    """Stops within ``success_distance`` of the goal, else moves or turns
    uniformly at random."""

    def __init__(self, success_distance: float = 0.2, goal_sensor_uuid: str = "pointgoal_with_gps_compass"):
        self.dist_threshold_to_stop = success_distance
        self.goal_sensor_uuid = goal_sensor_uuid
        self._rng = np.random.default_rng(0)

    def reset(self) -> None:
        pass

    def is_goal_reached(self, observations) -> bool:
        return bool(_host(observations[self.goal_sensor_uuid])[0] <= self.dist_threshold_to_stop)

    def act(self, observations):
        if self.is_goal_reached(observations):
            return STOP
        return int(self._rng.choice([MOVE_FORWARD, TURN_LEFT, TURN_RIGHT]))


class ForwardOnlyAgent(RandomAgent):
    def act(self, observations):
        if self.is_goal_reached(observations):
            return STOP
        return MOVE_FORWARD


class RandomForwardAgent(RandomAgent):
    FORWARD_PROBABILITY = 0.8

    def act(self, observations):
        if self.is_goal_reached(observations):
            return STOP
        if self._rng.uniform(0, 1, 1) < self.FORWARD_PROBABILITY:
            return MOVE_FORWARD
        return int(self._rng.choice([TURN_LEFT, TURN_RIGHT]))


class GoalFollower(RandomAgent):
    """Forward when the goal lies within 15 degrees of the heading, else
    turns toward it."""

    def __init__(self, success_distance: float = 0.2, goal_sensor_uuid: str = "pointgoal_with_gps_compass"):
        super().__init__(success_distance, goal_sensor_uuid)
        self.pos_th = self.dist_threshold_to_stop
        self.angle_th = float(np.deg2rad(15))

    def normalize_angle(self, angle):
        if angle < -np.pi:
            angle = 2.0 * np.pi + angle
        if angle > np.pi:
            angle = -2.0 * np.pi + angle
        return angle

    def turn_towards_goal(self, angle_to_goal):
        if angle_to_goal > np.pi or (-np.pi < angle_to_goal < 0):
            return TURN_RIGHT
        return TURN_LEFT

    def act(self, observations):
        if self.is_goal_reached(observations):
            return STOP
        angle_to_goal = self.normalize_angle(_host(observations[self.goal_sensor_uuid])[1])
        if abs(angle_to_goal) < self.angle_th:
            return MOVE_FORWARD
        return self.turn_towards_goal(angle_to_goal)
