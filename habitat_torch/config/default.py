"""Config composition: get_config(path, overrides) without Hydra (port of
``habitat_tpu/config/default.py``).

Implements the subset of Hydra semantics the reference configs rely on
(reference habitat-lab/habitat/config/default.py:113 get_config via
hydra compose; YAML layout under habitat-lab/habitat/config/):

- ``defaults:`` lists, processed in order, ``_self_`` merge point (appended
  last when absent)
- group entries: ``- name`` (same group), ``- /abs/group: name``,
  ``- group@package.path: name``, nested multi-select
  ``- actions: [stop, move_forward]``
- ``# @package`` headers (``_global_`` or a dotted path); store-registered
  packages for structured nodes
- dotted CLI overrides ``a.b.c=value`` (yaml-parsed values)
- ${a.b.c} interpolation
- readonly after compose (reference default.py:104), read_write escape hatch

The YAML tree is the JAX package's, read in place as data (no import of
that package): ``habitat_tpu/config/`` of the same checkout, then the
directory named by ``HABITAT_TPU_CONFIG_PATH``, so both packages compose the
same tree.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml

from habitat_torch.config.omega import Config, read_write, resolve_interpolations
from habitat_torch.config.structured import cs

# the JAX package's YAML tree, beside this package in the checkout
CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                           "habitat_tpu", "config")

# Additional config roots searched AFTER ours: lets another YAML tree
# compose through this loader (reference get_config's search path behaves
# the same way via hydra's searchpath plugin, default.py:49-77).
SEARCH_ROOTS: List[str] = [CONFIG_ROOT]


def add_search_root(root: str) -> None:
    root = os.path.abspath(root)
    if root not in SEARCH_ROOTS and os.path.isdir(root):
        SEARCH_ROOTS.append(root)


if os.environ.get("HABITAT_TPU_CONFIG_PATH"):
    add_search_root(os.environ["HABITAT_TPU_CONFIG_PATH"])

_PKG_RE = re.compile(r"^#\s*@package\s+(\S+)")


def _read_yaml(path: str) -> Tuple[dict, Optional[str]]:
    """Returns (data, package) where package is from the @package header."""
    with open(path) as f:
        text = f.read()
    pkg = None
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue
        m = _PKG_RE.match(stripped)
        if m:
            pkg = m.group(1)
        if not stripped.startswith("#"):
            break
    data = yaml.safe_load(text) or {}
    return _coerce_numbers(data), pkg


_SCI_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_numbers(v: Any) -> Any:
    """yaml 1.1 parses '1e6' as a string; OmegaConf (the reference) coerces
    such values to float — match that."""
    if isinstance(v, dict):
        return {k: _coerce_numbers(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_coerce_numbers(x) for x in v]
    if isinstance(v, str) and _SCI_RE.match(v):
        return float(v)
    return v


def _find_group_file(group: str, name: str) -> Optional[str]:
    for root in SEARCH_ROOTS:
        p = os.path.join(root, group.strip("/"), name + ".yaml")
        if os.path.exists(p):
            return p
    return None


def _nest(package: str, data: dict) -> dict:
    """Nest data under a dotted package path ('' or '_global_' = as-is)."""
    if not package or package == "_global_":
        return data
    out: dict = data
    for part in reversed(package.split(".")):
        out = {part: out}
    return out


def _join_pkg(base: str, rel: str) -> str:
    if rel in ("", "_global_"):
        return base
    if base in ("", "_global_"):
        return rel
    return f"{base}.{rel}"


class _Composer:
    def __init__(self):
        self.result = Config()

    # -- defaults-entry handling ----------------------------------------
    def compose_file(
        self, path: str, group: str, file_pkg_override: Optional[str], base_pkg: str
    ) -> None:
        """Load one config file (+ its defaults tree) into self.result.

        group: the config group dir of this file ('' for top-level configs).
        file_pkg_override: package forced by the parent defaults entry's @.
        base_pkg: package context of the PARENT config (for relative @).
        """
        data, header_pkg = _read_yaml(path)
        self._compose_node(data, header_pkg, group, file_pkg_override, base_pkg)

    def compose_store(
        self, group: str, name: str, file_pkg_override: Optional[str], base_pkg: str
    ) -> bool:
        entry = cs.get(group, name)
        if entry is None:
            return False
        node, pkg = entry
        self._compose_node(dict(node), pkg, group, file_pkg_override, base_pkg)
        return True

    def _compose_node(
        self,
        data: dict,
        own_pkg: Optional[str],
        group: str,
        pkg_override: Optional[str],
        base_pkg: str,
    ) -> None:
        # effective package: @override > header/store pkg > group-derived
        if pkg_override is not None:
            package = _join_pkg(base_pkg, pkg_override)
        elif own_pkg is not None:
            package = "" if own_pkg == "_global_" else own_pkg
        else:
            package = group.strip("/").replace("/", ".")

        defaults = data.pop("defaults", None)
        body = _nest(package, data)

        if defaults is None:
            self.result.merge_with(body)
            return

        entries = list(defaults)
        if "_self_" not in entries:
            entries.append("_self_")
        for entry in entries:
            if entry == "_self_":
                self.result.merge_with(body)
                continue
            self._process_default(entry, group, package)

    def _process_default(self, entry: Any, cur_group: str, cur_pkg: str) -> None:
        if isinstance(entry, str):
            # sibling config in the same group; "name@pkg" retargets the
            # package ("_here_" = the current config's package — hydra's
            # keyword, used by e.g. reference agents/fetch_suction.yaml:3)
            if "@" in entry:
                name, rel_pkg = entry.split("@", 1)
                rel_pkg = "" if rel_pkg == "_here_" else rel_pkg
                self._load(cur_group, name, rel_pkg, cur_pkg)
                return
            self._load(cur_group, entry, None, cur_pkg)
            return
        if isinstance(entry, dict):
            for key, val in entry.items():
                if key.startswith("override ") or key.startswith("/override"):
                    key = key.split(" ", 1)[1]
                # group[@pkg]
                if "@" in key:
                    gpart, pkg_part = key.split("@", 1)
                else:
                    gpart, pkg_part = key, None
                group = (
                    gpart.strip("/")
                    if gpart.startswith("/")
                    else os.path.join(cur_group, gpart).strip("/")
                )
                names = val if isinstance(val, list) else [val]
                for name in names:
                    if name is None:
                        continue
                    self._load(group, str(name), pkg_part, cur_pkg)
            return
        raise ValueError(f"Unsupported defaults entry: {entry!r}")

    def _load(
        self, group: str, name: str, pkg_override: Optional[str], base_pkg: str
    ) -> None:
        path = _find_group_file(group, name)
        if path is not None:
            self.compose_file(path, group, pkg_override, base_pkg)
            return
        if self.compose_store(group, name, pkg_override, base_pkg):
            return
        raise FileNotFoundError(
            f"Config group entry not found: group={group!r} name={name!r} "
            f"(searched {os.path.join(CONFIG_ROOT, group)} and the config store)"
        )


def _parse_override_value(v: str) -> Any:
    try:
        return _coerce_numbers(yaml.safe_load(v))
    except Exception:
        return v


def get_config(config_path: str, overrides: Optional[Sequence[str]] = None) -> Config:
    """Compose a config (reference habitat/config/default.py:113).

    config_path: filesystem path OR a path relative to the config root
    (e.g. "benchmark/nav/pointnav/pointnav_procgen.yaml" or
    "pointnav/ppo_pointnav_example.yaml" under experiments/).
    """
    candidates = [config_path]
    for root in SEARCH_ROOTS:
        candidates += [
            os.path.join(root, config_path),
            os.path.join(root, "experiments", config_path),
            os.path.join(root, "benchmark", config_path),
        ]
    path = next((p for p in candidates if os.path.isfile(p)), None)
    if path is None:
        raise FileNotFoundError(f"config not found: {config_path} (tried {candidates})")

    composer = _Composer()
    # top-level experiment configs are global-package; their group is their
    # directory relative to CONFIG_ROOT if inside it
    group = ""
    for root in SEARCH_ROOTS:
        rel = os.path.relpath(path, root)
        if not rel.startswith(".."):
            group = os.path.dirname(rel)
            break
    composer.compose_file(path, group, None, "")
    cfg = composer.result

    for ov in overrides or []:
        ov = ov.lstrip("+~")
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        cfg.set_path(k.strip(), _parse_override_value(v.strip()))

    resolve_interpolations(cfg)
    cfg = patch_config(cfg)
    cfg.set_readonly(True)
    return cfg


def patch_config(cfg: Config) -> Config:
    """Normalize composed config (reference default.py:83 patch_config:
    agents_order inference, sensor defaults)."""
    sim = cfg.get_path("habitat.simulator")
    if sim is not None:
        agents = sim.get("agents", Config())
        if not sim.get("agents_order"):
            with read_write(cfg):
                sim["agents_order"] = sorted(agents.keys())
    # propagate num_processes alias (reference deprecation)
    hb = cfg.get_path("habitat_baselines")
    if hb is not None and hb.get("num_processes", -1) not in (-1, None):
        with read_write(cfg):
            hb["num_environments"] = hb["num_processes"]
    return cfg


__all__ = ["get_config", "patch_config", "read_write", "Config"]
