"""Device resolution and the port's numeric flags.

Every entry point takes ``device=None`` and resolves it here: ``None`` means
``cuda``; a missing card raises rather than continuing on the CPU. Tests pass
``device="cpu"`` explicitly.

Numeric flags, set once on first resolution: float32 matmuls and cuDNN
convolutions run in full float32 (no TF32), so float32 parity with the JAX
reference holds on the card as on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_flags_set = False


def set_numeric_flags() -> None:
    global _flags_set
    if not _flags_set:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _flags_set = True


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is requested but unavailable."""
    set_numeric_flags()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "habitat_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' explicitly to run the plain path"
        )
    return dev
