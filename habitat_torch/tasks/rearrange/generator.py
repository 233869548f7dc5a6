"""Rearrangement episode generation (port of
``habitat_tpu/tasks/rearrange/generator.py``): the stability settling so
far; the episode samplers and the table packing follow with the env."""

from __future__ import annotations

import numpy as np
import torch

from habitat_torch.device import resolve_device
from habitat_torch.tasks.rearrange.rearrange_env import contact_step


def settle_objects(
    obj_init: np.ndarray,  # (E, O, 3) box bottoms
    obj_valid: np.ndarray,  # (E, O)
    floor_y: np.ndarray,  # (E,)
    steps: int = 30,
    device=None,
) -> np.ndarray:
    """Stability settling at episode-generation time (reference settle_sim,
    datasets/rearrange/rearrange_generator.py:938): ``steps`` contacts-v3
    steps with the robot far away, so overlapping spawns separate and
    floating spawns drop. Numpy in, numpy out; the steps run on ``device``
    (``None`` is the card)."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(obj_init, np.float32), device=dev)
    v = torch.zeros_like(p)
    free = torch.as_tensor(np.asarray(obj_valid, bool), device=dev)
    fy = torch.as_tensor(np.asarray(floor_y, np.float32), device=dev)
    agent_far = torch.full((p.shape[0], 3), 1e6, dtype=torch.float32, device=dev)
    for _ in range(steps):
        p, v, _ = contact_step(p, v, free, fy, agent_far)
    return p.cpu().numpy()
