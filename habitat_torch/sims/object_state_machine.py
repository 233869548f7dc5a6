"""Discrete object states (port of ``habitat_tpu/sims/object_state_machine.py``;
reference habitat-lab/habitat/sims/habitat_simulator/object_state_machine.py:
extensible states such as clean/dirty or powered on/off, kept in object
metadata and flipped by actions).

Batched form: each state spec is a named boolean channel over every object
of every env, one (N, O) tensor per spec in a dict, set on the device
(``init_state_channels``, ``set_state``). ``ObjectStateMachine`` keeps the
reference's single-env API on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from habitat_torch.device import resolve_device

@dataclasses.dataclass
class ObjectStateSpec:
    """reference ObjectStateSpec (object_state_machine.py:70): a unique
    name, the semantic classes it applies to (all when empty), a default
    value and the update hooks."""

    name: str
    default_value: bool = False
    accepted_semantic_classes: tuple = ()

    def is_affordance_of(self, semantic_class: int) -> bool:
        return not self.accepted_semantic_classes or semantic_class in self.accepted_semantic_classes

    def update_state_context(self, sim) -> None:
        """Per-frame global context hook (reference :108)."""

    def update_state(self, sim, handle: str, value, dt: float):
        """Time-driven dynamics hook (reference :115): the new value
        (unchanged by default)."""
        return value

    def draw_state(self, value):
        """An RGB colour for the state's highlight (reference :148)."""
        return (0, 255, 0) if value else (255, 0, 0)


class BooleanObjectState(ObjectStateSpec):
    """reference BooleanObjectState (:163): a boolean spec with a toggle."""

    def toggle(self, machine: "ObjectStateMachine", handle: str) -> bool:
        new = not machine.get_state(handle, self.name)
        machine.set_state(handle, self.name, new)
        return new


class ObjectIsClean(BooleanObjectState):
    """reference ObjectIsClean (:223): clean or dirty."""

    def __init__(self):
        super().__init__(name="is_clean", default_value=False)


class ObjectIsPoweredOn(BooleanObjectState):
    """reference ObjectIsPoweredOn (:238): off by default."""

    def __init__(self):
        super().__init__(name="is_powered_on", default_value=False)


def get_state_of_obj(machine: "ObjectStateMachine", handle: str, state_name: str):
    """reference get_state_of_obj (:27): None for an unknown object or state."""
    return machine.objects_with_states.get(handle, {}).get(state_name)


def set_state_of_obj(machine: "ObjectStateMachine", handle: str, state_name: str, value) -> None:
    """reference set_state_of_obj (:46)."""
    machine.objects_with_states.setdefault(handle, {})[state_name] = value


def init_state_channels(specs: List[ObjectStateSpec], num_envs: int, num_objects: int,
                        device=None) -> Dict[str, torch.Tensor]:
    """The batched states: name -> (N, O) bool at each spec's default, on
    ``device`` (``None`` = cuda)."""
    device = resolve_device(device)
    return {s.name: torch.full((num_envs, num_objects), bool(s.default_value), dtype=torch.bool, device=device)
            for s in specs}


def set_state(channels: Dict[str, torch.Tensor], name: str, env_mask: torch.Tensor, obj_idx: torch.Tensor,
              value: bool) -> Dict[str, torch.Tensor]:
    """Spec ``name`` set to ``value`` at (env, obj_idx[env]) where
    ``env_mask`` holds; a new dict, the other channels shared."""
    ch = channels[name]
    rows = torch.arange(ch.shape[0], device=ch.device)
    updated = ch.clone()
    updated[rows, obj_idx] = torch.where(env_mask, value, ch[rows, obj_idx])
    return {**channels, name: updated}


class ObjectStateMachine:
    """The reference class's single-env API on the host."""

    def __init__(self, specs: Optional[List[ObjectStateSpec]] = None):
        self.active_states: List[ObjectStateSpec] = list(specs or [])
        self.objects_with_states: Dict[str, Dict[str, bool]] = {}

    def register_object(self, handle: str, semantic_class: int = 0) -> None:
        self.objects_with_states[handle] = {s.name: s.default_value for s in self.active_states
                                            if s.is_affordance_of(semantic_class)}

    def set_state(self, handle: str, name: str, value: bool) -> None:
        self.objects_with_states[handle][name] = value

    def get_state(self, handle: str, name: str) -> bool:
        return self.objects_with_states[handle][name]

    def initialize_object_state_map(self, handles_with_classes) -> None:
        """Register every (handle, semantic_class) pair (reference :273)."""
        self.objects_with_states = {}
        for handle, sem in handles_with_classes:
            self.register_object(handle, sem)

    def update_states(self, sim=None, dt: float = 0.0) -> None:
        """The per-frame update (reference update_states:302): each spec's
        context once, then its update hook on every object that has it."""
        for spec in self.active_states:
            spec.update_state_context(sim)
        for spec in self.active_states:
            for handle, states in self.objects_with_states.items():
                if spec.name in states:
                    states[spec.name] = spec.update_state(sim, handle, states[spec.name], dt)

    def get_snapshot_dict(self) -> Dict[str, Dict[str, bool]]:
        """state -> {handle: value} (reference get_snapshot_dict:320)."""
        out: Dict[str, Dict[str, bool]] = {}
        for handle, states in self.objects_with_states.items():
            for name, value in states.items():
                out.setdefault(name, {})[handle] = value
        return out
