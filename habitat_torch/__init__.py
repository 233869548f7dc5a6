"""PyTorch/CUDA port of habitat_tpu.

The module layout mirrors ``habitat_tpu/`` so each counterpart is found under
the same path. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see ``habitat_torch.device``). Kernels live in
``habitat_torch/csrc`` and are built at first use into ``habitat_torch/build``.
"""


def __getattr__(name):  # lazy exports, as habitat_tpu has them
    if name in ("Simulator", "SensorTypes", "Sensor", "SensorSuite", "AgentState"):
        from habitat_torch.core import simulator as _s

        return getattr(_s, name)
    raise AttributeError(name)
