"""Flatten metric dicts to scalars (port of ``habitat_tpu/utils/info_dict.py``;
reference habitat-baselines/habitat_baselines/utils/info_dict.py).

Nested dicts flatten to dotted keys; numbers, numpy arrays and tensors of one
element become floats (a card tensor is copied to the host); other values and
the non-scalar metrics are left out."""

from __future__ import annotations

import numbers
from typing import Any, Dict, List

import numpy as np

NON_SCALAR_METRICS = {"top_down_map", "collisions.is_collision"}


def _one_float(v: Any):
    """float(v) for a one-element array or tensor, else None."""
    if hasattr(v, "numel") and hasattr(v, "item"):  # a torch tensor, on any device
        return float(v.item()) if v.numel() == 1 else None
    try:
        arr = np.asarray(v)
    except Exception:
        return None
    if arr.size != 1:
        return None
    try:
        return float(arr.reshape(()))
    except (TypeError, ValueError):
        return None


def extract_scalars_from_info(info: Dict[str, Any]) -> Dict[str, float]:
    result: Dict[str, float] = {}
    for k, v in info.items():
        if not isinstance(k, str) or k in NON_SCALAR_METRICS:
            continue
        if isinstance(v, dict):
            result.update({
                k + "." + subk: subv
                for subk, subv in extract_scalars_from_info(v).items()
                if isinstance(subk, str) and k + "." + subk not in NON_SCALAR_METRICS
            })
        elif isinstance(v, numbers.Number):
            result[k] = float(v)
        else:
            f = _one_float(v)
            if f is not None:
                result[k] = f
    return result


def extract_scalars_from_infos(infos: List[Dict[str, Any]]) -> Dict[str, List[float]]:
    results: Dict[str, List[float]] = {}
    for info in infos:
        for k, v in extract_scalars_from_info(info).items():
            results.setdefault(k, []).append(v)
    return results
