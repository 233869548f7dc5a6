"""Agent ABC (port of ``habitat_tpu/core/agent.py``; reference
habitat-lab/habitat/core/agent.py): ``reset()`` at an episode's start, then
``act(observations)`` once per step."""

from __future__ import annotations

from typing import Any, Dict, Union


class Agent:
    def reset(self) -> None:
        raise NotImplementedError

    def act(self, observations) -> Union[int, str, Dict[str, Any]]:
        raise NotImplementedError
