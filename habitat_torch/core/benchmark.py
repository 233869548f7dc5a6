"""Benchmark: the agent-against-env evaluation loop (port of
``habitat_tpu/core/benchmark.py``; reference habitat-lab/habitat/core/
benchmark.py).

``Benchmark(config_path).local_evaluate(agent, num_episodes)`` runs the
reference's local loop on a single-env ``Env`` on ``device`` (``None`` =
cuda): ``agent.reset()``, then ``agent.act(observations)`` until the
episode is over, and the mean over episodes of each numeric metric (a
dict-valued metric's numeric entries as "name/key"; arrays and strings,
such as the top-down map or a replay, are not averaged).
``remote_evaluate`` (the evalai gRPC protocol) raises
``NotImplementedError``: it waits for the port of ``core/evalai_remote.py``,
which needs grpc.

``Challenge`` (reference core/challenge.py) is a ``Benchmark`` of the config
named by the ``CHALLENGE_CONFIG_FILE`` environment variable (default
``benchmark/nav/pointnav/pointnav_procgen.yaml``); ``submit(agent)``
evaluates and logs each metric.
"""

from __future__ import annotations

import numbers
import os
from collections import defaultdict
from typing import Dict, Optional, Sequence

from habitat_torch.core.agent import Agent
from habitat_torch.core.env import Env
from habitat_torch.core.logging import logger

DEFAULT_CONFIG = "benchmark/nav/pointnav/pointnav_procgen.yaml"


def _numbers(metrics):
    """(name, value) of each numeric metric, a dict's entries as name/key."""
    for m, v in metrics.items():
        if isinstance(v, dict):
            for sub_m, sub_v in v.items():
                if isinstance(sub_v, numbers.Number):
                    yield f"{m}/{sub_m}", float(sub_v)
        elif isinstance(v, numbers.Number):
            yield m, float(v)


class Benchmark:
    def __init__(self, config_path: Optional[str] = None, eval_remote: bool = False,
                 overrides: Sequence[str] = (), device=None):
        from habitat_torch.config.default import get_config

        self._eval_remote = eval_remote
        # the remote path builds no local env: the challenge server owns it
        self._env = None if eval_remote else Env(get_config(config_path or DEFAULT_CONFIG, list(overrides)),
                                                 device=device)

    def remote_evaluate(self, agent: Agent, num_episodes: Optional[int] = None) -> Dict[str, float]:
        raise NotImplementedError(
            "Benchmark.remote_evaluate is not ported to habitat_torch yet: it waits for the port of "
            "core/evalai_remote.py (grpc, which the card's machine does not have)")

    def local_evaluate(self, agent: Agent, num_episodes: Optional[int] = None) -> Dict[str, float]:
        if num_episodes is None:
            num_episodes = len(self._env.episodes)
        assert num_episodes <= len(self._env.episodes), (
            f"num_episodes({num_episodes}) is larger than number of episodes in environment "
            f"({len(self._env.episodes)})")
        assert num_episodes > 0

        agg_metrics: Dict[str, float] = defaultdict(float)
        for _ in range(num_episodes):
            agent.reset()
            observations = self._env.reset()
            while not self._env.episode_over:
                observations = self._env.step(agent.act(observations))
            for name, value in _numbers(self._env.get_metrics()):
                agg_metrics[name] += value
        return {k: v / num_episodes for k, v in agg_metrics.items()}

    def evaluate(self, agent: Agent, num_episodes: Optional[int] = None) -> Dict[str, float]:
        if self._eval_remote:
            return self.remote_evaluate(agent, num_episodes)
        return self.local_evaluate(agent, num_episodes)


class Challenge(Benchmark):
    """reference core/challenge.py."""

    def __init__(self, eval_remote: bool = False, device=None):
        super().__init__(os.environ.get("CHALLENGE_CONFIG_FILE", DEFAULT_CONFIG), eval_remote=eval_remote,
                         device=device)

    def submit(self, agent: Agent) -> Dict[str, float]:
        metrics = self.evaluate(agent)
        for k, v in metrics.items():
            logger.info(f"{k}: {v}")
        return metrics
