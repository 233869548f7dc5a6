"""Baselines helpers (port of ``habitat_tpu/utils/common.py``; reference
habitat-baselines/habitat_baselines/utils/common.py: batch_obs:315,
generate_video:380, get_num_actions:729, LagrangeInequalityCoefficient:749).

The port has no gymnasium spaces: the action-space helpers read the action
descriptors the port's envs expose, ``num_actions`` for discrete actions and
``action_dim`` for continuous ones (``core/batched_env.py``,
``tasks/rearrange/rearrange_env.py``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from habitat_torch.device import resolve_device

# JAX keeps 32-bit arrays unless 64-bit mode is on; the batch does the same
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def batch_obs(observations: List[Dict[str, Any]], device=None) -> Dict[str, torch.Tensor]:
    """Per-env observation dicts (numpy or tensors) -> one dict of stacked
    (N, ...) tensors on ``device`` (``None`` = cuda), 64-bit floats and
    integers narrowed to 32 bits as ``jnp.asarray`` narrows them."""
    assert len(observations) > 0
    dev = resolve_device(device)
    out = {}
    for k in observations[0].keys():
        x = torch.stack([o[k] if torch.is_tensor(o[k]) else torch.as_tensor(np.asarray(o[k])) for o in observations])
        out[k] = x.to(dev, _NARROW.get(x.dtype, x.dtype))
    return out


def get_num_actions(action_space) -> int:
    """The policy's output width: ``num_actions`` of a discrete env,
    ``action_dim`` of a continuous one; a dict of such descriptors sums."""
    if isinstance(action_space, dict):
        return sum(get_num_actions(v) for v in action_space.values())
    if getattr(action_space, "num_actions", None) is not None:
        return int(action_space.num_actions)
    if getattr(action_space, "action_dim", None) is not None:
        return int(action_space.action_dim)
    raise NotImplementedError(type(action_space))


def is_continuous_action_space(action_space) -> bool:
    """Whether the env takes continuous actions (an ``action_dim`` and no
    ``num_actions``)."""
    return getattr(action_space, "num_actions", None) is None and getattr(action_space, "action_dim", None) is not None


@contextlib.contextmanager
def inference_mode():
    """``torch.inference_mode`` (the JAX package's counterpart is a no-op)."""
    with torch.inference_mode():
        yield


def generate_video(
    video_option: List[str],
    video_dir: Optional[str],
    images: List[np.ndarray],
    episode_id: str,
    checkpoint_idx: int,
    metrics: Dict[str, float],
    tb_writer=None,
    fps: int = 10,
    verbose: bool = True,
) -> None:
    """Not ported yet: it writes through the video helpers of
    ``habitat_tpu/utils/visualizations/utils.py``, which the port lacks."""
    raise NotImplementedError(
        "generate_video waits for the port of habitat_tpu/utils/visualizations/utils.py (eval videos)")


class LagrangeInequalityCoefficient:
    """Adaptive coefficient for an inequality constraint (reference
    common.py:749; PPO's Lagrangian entropy coefficient): log-alpha ascends
    on the constraint's violation and is clamped to [log alpha_min, log
    alpha_max]. ``ascend`` is that step on a float or a tensor, so the PPO
    update takes it on its 0-d device tensor without a host copy."""

    def __init__(self, threshold: float, init_alpha: float = 1.0, alpha_min: float = 1e-4,
                 alpha_max: float = 1.0, greater_than: bool = True):
        self.threshold = threshold
        self.log_alpha = float(np.log(init_alpha))
        self.log_alpha_min = float(np.log(alpha_min))
        self.log_alpha_max = float(np.log(alpha_max))
        self._greater_than = greater_than

    def alpha(self) -> float:
        return float(np.exp(self.log_alpha))

    def violation(self, value):
        return (self.threshold - value) if self._greater_than else (value - self.threshold)

    def ascend(self, log_alpha, value, lr: float):
        """log_alpha + lr * violation(value), clamped to the bounds."""
        new = log_alpha + lr * self.violation(value)
        if torch.is_tensor(new):
            return torch.clamp(new, self.log_alpha_min, self.log_alpha_max)
        return min(max(new, self.log_alpha_min), self.log_alpha_max)

    def lagrangian_loss_and_update(self, value: float, lr: float = 1e-3) -> float:
        """The penalty alpha * violation(value); then one ascent step."""
        loss = self.alpha() * self.violation(value)
        self.log_alpha = self.ascend(self.log_alpha, value, lr)
        return loss

    def project_into_bounds(self) -> None:
        self.log_alpha = min(max(self.log_alpha, self.log_alpha_min), self.log_alpha_max)
