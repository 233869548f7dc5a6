"""Running per-channel mean and variance (port of
``habitat_tpu/models/running_mean_and_var.py``; reference
habitat-baselines/habitat_baselines/rl/ddppo/policy/running_mean_and_var.py).

Plain functions on tensors: the statistics are a small named tuple that the
caller carries, and ``update_running_stats`` merges a batch's moments with
Chan's parallel-variance formula. No module of either package builds it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningStats(NamedTuple):
    mean: torch.Tensor  # (C,)
    var: torch.Tensor  # (C,)
    count: torch.Tensor  # scalar


def init_running_stats(num_channels: int, device=None) -> RunningStats:
    """Mean 0, variance 1 and a count of 1e-4, float32 on ``device``
    (``None`` = cuda)."""
    from habitat_torch.device import resolve_device

    dev = resolve_device(device)
    return RunningStats(
        mean=torch.zeros(num_channels, device=dev),
        var=torch.ones(num_channels, device=dev),
        count=torch.tensor(1e-4, device=dev),
    )


def update_running_stats(stats: RunningStats, x: torch.Tensor) -> RunningStats:
    """x: (..., C) batch; its moments over all leading axes merged in."""
    axes = tuple(range(x.dim() - 1))
    b_mean = x.mean(dim=axes)
    b_var = x.var(dim=axes, unbiased=False)
    b_count = torch.tensor(x.numel() / x.shape[-1], dtype=torch.float32, device=x.device)

    delta = b_mean - stats.mean
    tot = stats.count + b_count
    new_mean = stats.mean + delta * (b_count / tot)
    m2 = stats.var * stats.count + b_var * b_count + delta ** 2 * (stats.count * b_count / tot)
    return RunningStats(mean=new_mean, var=m2 / tot, count=tot)


def normalize(stats: RunningStats, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return (x - stats.mean) / torch.sqrt(stats.var + eps)
