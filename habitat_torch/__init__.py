"""PyTorch/CUDA port of habitat_tpu.

The module layout mirrors ``habitat_tpu/`` so each counterpart is found under
the same path. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see ``habitat_torch.device``). Kernels live in
``habitat_torch/csrc`` and are built at first use into ``habitat_torch/build``.

The top-level names are those of ``habitat_tpu/__init__.py`` (the reference
``habitat`` package's exports). Each is imported when first asked for, so
``import habitat_torch`` imports no torch module beyond the logger and
registry, builds nothing and does not touch the card.
"""

__version__ = "0.1.0"

from habitat_torch.core.logging import logger
from habitat_torch.core.registry import registry

__all__ = [
    "registry",
    "logger",
    "__version__",
    "Env",
    "RLEnv",
    "Agent",
    "Benchmark",
    "Challenge",
    "Dataset",
    "Episode",
    "EpisodeIterator",
    "VectorEnv",
    "ThreadedVectorEnv",
    "Simulator",
    "SensorTypes",
    "get_config",
    "read_write",
    "make_dataset",
]

# top-level name -> the module that holds it
_LAZY = {
    **dict.fromkeys(("Env", "RLEnv"), "habitat_torch.core.env"),
    "Agent": "habitat_torch.core.agent",
    **dict.fromkeys(("Benchmark", "Challenge"), "habitat_torch.core.benchmark"),
    **dict.fromkeys(("Dataset", "Episode", "EpisodeIterator"), "habitat_torch.core.dataset"),
    **dict.fromkeys(("VectorEnv", "ThreadedVectorEnv"), "habitat_torch.core.vector_env"),
    **dict.fromkeys(("Simulator", "SensorTypes", "Sensor", "SensorSuite", "AgentState"),
                    "habitat_torch.core.simulator"),
    "get_config": "habitat_torch.config.default",
    "read_write": "habitat_torch.config.omega",
    "make_dataset": "habitat_torch.datasets.registration",
}


def __getattr__(name):  # lazy exports, as habitat_tpu has them
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(_LAZY[name]), name)
