"""Minimal OmegaConf-style config container (port of
``habitat_tpu/config/omega.py``).

The subset of OmegaConf the framework needs, without Hydra or OmegaConf:
nested attribute access, deep merge, readonly enforcement (reference
config/default.py:104 OmegaConf.set_readonly), dotted get/set, and ${a.b.c}
interpolation.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Config(dict):
    """Nested attr-dict. ``_readonly`` is propagated to children."""

    def __init__(self, data: Optional[Dict] = None):
        super().__init__()
        self.__dict__["_readonly"] = False
        if data:
            for k, v in data.items():
                dict.__setitem__(self, k, _wrap(v))

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, k: str) -> Any:
        if k.startswith("_"):
            try:
                return self.__dict__[k]
            except KeyError:
                raise AttributeError(k)
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k: str, v: Any) -> None:
        if k.startswith("_"):
            self.__dict__[k] = v
            return
        self[k] = v

    def __setitem__(self, k: str, v: Any) -> None:
        if self.__dict__.get("_readonly", False):
            raise RuntimeError(
                f"Config is readonly (use habitat_torch.config.omega.read_write to "
                f"modify); attempted to set {k!r}"
            )
        dict.__setitem__(self, k, _wrap(v))

    def __delattr__(self, k: str) -> None:
        if self.__dict__.get("_readonly", False):
            raise RuntimeError("Config is readonly")
        del self[k]

    # -- helpers -------------------------------------------------------------
    def set_readonly(self, flag: bool) -> None:
        self.__dict__["_readonly"] = flag
        for v in self.values():
            if isinstance(v, Config):
                v.set_readonly(flag)

    def is_readonly(self) -> bool:
        return self.__dict__.get("_readonly", False)

    def to_dict(self) -> Dict:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = value

    def merge_with(self, other: Any) -> None:
        """Deep merge ``other`` into self (other wins)."""
        if isinstance(other, Config):
            other = other.to_dict()
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], Config)
                and isinstance(v, dict)
            ):
                self[k].merge_with(v)
            else:
                self[k] = v


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def merge(*configs: Any) -> Config:
    out = Config()
    for c in configs:
        out.merge_with(c)
    return out


def resolve_interpolations(cfg: Config) -> None:
    """Resolve ${a.b.c} string interpolations in place (single pass, repeated
    to a fixed point)."""
    import re

    pat = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")

    def visit(node: Config, root: Config) -> bool:
        changed = False
        for k, v in list(node.items()):
            if isinstance(v, Config):
                changed |= visit(v, root)
            elif isinstance(v, str):
                m = pat.match(v)
                if m:
                    val = root.get_path(m.group(1), v)
                    if not (isinstance(val, str) and pat.match(val)):
                        dict.__setitem__(node, k, _wrap(val))
                        changed = True
        return changed

    for _ in range(10):
        if not visit(cfg, cfg):
            break


class read_write:
    """Context manager flipping readonly (reference config/read_write.py)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.was_readonly = cfg.is_readonly()

    def __enter__(self) -> Config:
        self.cfg.set_readonly(False)
        return self.cfg

    def __exit__(self, *args) -> None:
        self.cfg.set_readonly(self.was_readonly)
