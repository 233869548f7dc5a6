"""TensorDict (port of ``habitat_tpu/baselines/tensor_dict.py``; reference
habitat-baselines/habitat_baselines/common/tensor_dict.py): a nested dict
of tensors indexed, set and mapped as one. ``from_tree`` takes numpy leaves
as tensors sharing their memory; setting writes into the tensors in
place."""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch


class TensorDict(dict):
    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "TensorDict":
        out = cls()
        for k, v in tree.items():
            out[k] = cls.from_tree(v) if isinstance(v, dict) else torch.as_tensor(v)
        return out

    def slice_keys(self, *keys) -> "TensorDict":
        return TensorDict({k: dict.__getitem__(self, k) for k in keys})

    def __getitem__(self, index):
        if isinstance(index, str):
            return dict.__getitem__(self, index)
        return TensorDict({k: v[index] for k, v in self.items()})

    def set(self, index, value: Union["TensorDict", Dict], strict: bool = True) -> None:
        if isinstance(index, str):
            dict.__setitem__(self, index, value)
            return
        for k, v in value.items():
            if k not in self:
                if strict:
                    raise KeyError(k)
                continue
            dst = dict.__getitem__(self, k)
            if isinstance(dst, TensorDict):
                dst.set(index, v, strict=strict)
            else:
                dst[index] = torch.as_tensor(v, dtype=dst.dtype, device=dst.device)

    def __setitem__(self, index, value):
        if isinstance(index, str):
            dict.__setitem__(self, index, value)
        else:
            self.set(index, value)

    def map(self, func: Callable) -> "TensorDict":
        return TensorDict({k: v.map(func) if isinstance(v, TensorDict) else func(v) for k, v in self.items()})

    def numpy(self) -> "TensorDict":
        return self.map(lambda v: v.detach().cpu().numpy())
