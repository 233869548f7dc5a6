"""HITL application framework (port of ``habitat_tpu/hitl/app_states.py``;
reference habitat-hitl/habitat_hitl/):

- AppState ABC (app_states/app_state_abc.py:10): user apps implement
  sim_update(dt, post_sim_update_dict) and get lifecycle callbacks.
- AppService (app_states/app_service.py): the capability bundle handed to an
  AppState — env access, GUI input, line/text drawers, episode helpers.
- GuiInput (core/gui_input.py): key/mouse state abstraction; in this headless
  engine inputs arrive from scripts or the remote client.

Host-side and numpy only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np


class GuiInput:
    """Key/button state (reference habitat_hitl/core/gui_input.py)."""

    class KeyNS:
        def __getattr__(self, name):  # KeyNS.W -> "w"
            return name.lower()

    KeyNS = KeyNS()

    def __init__(self):
        self._held: Set[str] = set()
        self._pressed: Set[str] = set()
        self.mouse_position = np.zeros(2)
        self.mouse_scroll_offset = 0.0

    def press(self, key: str) -> None:
        key = key.lower()
        self._pressed.add(key)
        self._held.add(key)

    def release(self, key: str) -> None:
        self._held.discard(key.lower())

    def get_key(self, key: str) -> bool:
        return key.lower() in self._held

    def get_key_down(self, key: str) -> bool:
        return key.lower() in self._pressed

    def on_frame_end(self) -> None:
        self._pressed.clear()


class DebugLineRender:
    """Line drawer (reference core/debug_line_render) — accumulates segments
    for the keyframe/video overlay instead of GL calls."""

    def __init__(self):
        self.lines: List[Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]] = []

    def draw_transformed_line(self, a, b, color=(255, 0, 0), *args) -> None:
        self.lines.append((np.asarray(a), np.asarray(b), tuple(color)))

    def draw_circle(self, center, radius, color=(255, 0, 0), *args, **kw) -> None:
        c = np.asarray(center)
        for k in range(12):
            a0 = 2 * np.pi * k / 12
            a1 = 2 * np.pi * (k + 1) / 12
            p0 = c + radius * np.array([np.cos(a0), 0, np.sin(a0)])
            p1 = c + radius * np.array([np.cos(a1), 0, np.sin(a1)])
            self.lines.append((p0, p1, tuple(color)))

    def clear(self) -> None:
        self.lines = []


class TextDrawer:
    def __init__(self):
        self.texts: List[Tuple[str, str]] = []

    def add_text(self, text: str, position: str = "top_left", *args, **kw) -> None:
        self.texts.append((text, position))

    def clear(self) -> None:
        self.texts = []


@dataclasses.dataclass
class AppService:
    """What an AppState gets to work with (reference app_service.py)."""

    config: Any
    env: Any  # host Env or a batched env adapter
    sim: Any
    gui_input: GuiInput
    line_render: DebugLineRender
    text_drawer: TextDrawer
    get_observations: Callable[[], Dict[str, np.ndarray]]
    video_frames: List[np.ndarray] = dataclasses.field(default_factory=list)

    def end_episode(self, do_reset: bool = False):
        if do_reset:
            self.env.reset()


class AppState:
    """User app callback surface (reference app_state_abc.py:10)."""

    def on_environment_reset(self, episode_recorder_dict) -> None:
        pass

    def sim_update(self, dt: float, post_sim_update_dict: Dict[str, Any]) -> None:
        raise NotImplementedError

    def record_state(self) -> None:
        pass
