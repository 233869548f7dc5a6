"""Profiling ranges (port of ``habitat_tpu/utils/profiling_wrapper.py``;
reference habitat/utils/profiling_wrapper.py:16-62): ``configure``,
``on_start_step``, ``range_push``, ``range_pop`` and ``RangeContext``.

A named range is a ``torch.profiler.record_function`` span, and an NVTX
range as well when a card is present. The capture window, steps
``capture_start_step`` to ``capture_start_step + num_steps_to_capture``,
runs under ``torch.profiler.profile`` and writes its Chrome trace into
``trace_dir``. With no capture configured a range only marks the host's
timeline: nothing waits on the card.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, List, Optional

import torch

_capture_start_step: int = -1
_num_steps_to_capture: int = -1
_step: int = 0
_trace_dir: Optional[str] = None
_profiler: Optional[Any] = None
_ranges: List[Any] = []


def configure(capture_start_step: int = -1, num_steps_to_capture: int = -1, trace_dir: Optional[str] = None) -> None:
    """Capture steps [capture_start_step, capture_start_step +
    num_steps_to_capture) of ``on_start_step``'s count; ``trace_dir``
    defaults to ``habitat_torch_trace`` under the temporary directory."""
    global _capture_start_step, _num_steps_to_capture, _trace_dir
    _capture_start_step = capture_start_step
    _num_steps_to_capture = num_steps_to_capture
    _trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "habitat_torch_trace")


def _nvtx() -> bool:
    return torch.cuda.is_available()


def on_start_step() -> None:
    """Count a step; start or stop the capture at the window's edges."""
    global _step, _profiler
    _step += 1
    if _capture_start_step < 0 or _num_steps_to_capture < 0:
        return
    if _step == _capture_start_step and _profiler is None:
        os.makedirs(_trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if _nvtx() else [])
        _profiler = torch.profiler.profile(activities=acts)
        _profiler.__enter__()
    elif _profiler is not None and _step >= _capture_start_step + _num_steps_to_capture:
        prof, _profiler = _profiler, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(_trace_dir, f"trace_step{_capture_start_step}.json"))


def range_push(msg: str) -> None:
    ctx = torch.profiler.record_function(msg)
    ctx.__enter__()
    _ranges.append(ctx)
    if _nvtx():
        torch.cuda.nvtx.range_push(msg)


def range_pop() -> None:
    if _ranges:
        _ranges.pop().__exit__(None, None, None)
        if _nvtx():
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def RangeContext(msg: str):
    range_push(msg)
    try:
        yield
    finally:
        range_pop()
