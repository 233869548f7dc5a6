"""make_dataset (port of ``habitat_tpu/datasets/registration.py``; reference
habitat/datasets/registration.py): a dataset class by its registered name."""

from __future__ import annotations

import habitat_torch.datasets.object_nav  # noqa: F401  (registers ObjectNav-v1)
import habitat_torch.datasets.pointnav  # noqa: F401  (registers PointNav-v1)
from habitat_torch.core.dataset import Dataset
from habitat_torch.core.registry import registry


def make_dataset(id_dataset: str, **kwargs) -> Dataset:
    return registry.get_dataset(id_dataset)(**kwargs)
