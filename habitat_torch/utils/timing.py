"""Windowed wall timers (port of ``habitat_tpu/utils/timing.py``; reference
habitat-baselines/habitat_baselines/utils/timing.py g_timer/Timing):
``RuntimePerfStats`` reports ``g_timer``'s means."""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from typing import Dict


class AverageMeter:
    """Mean of the last ``window`` values added."""

    def __init__(self, window: int = 50):
        self._vals = deque(maxlen=window)

    def add(self, v: float) -> None:
        self._vals.append(v)

    @property
    def mean(self) -> float:
        return sum(self._vals) / max(len(self._vals), 1)

    def __repr__(self):
        return f"{self.mean:.4f}"


class Timing(Dict[str, AverageMeter]):
    """Named meters of seconds: ``with timing.avg_time(name): ...``."""

    @contextmanager
    def avg_time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.setdefault(name, AverageMeter()).add(time.perf_counter() - t0)

    def add_time(self, name: str, seconds: float) -> None:
        self.setdefault(name, AverageMeter()).add(seconds)

    def todict(self) -> Dict[str, float]:
        return {k: v.mean for k, v in self.items()}


g_timer = Timing()
