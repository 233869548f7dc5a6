"""Global component registry (port of ``habitat_tpu/core/registry.py``).

String-named component tables that let YAML ``type:`` fields resolve to
classes and builders, under the JAX package's registered names so the same
config strings resolve in both. The kinds are the reference's habitat-lab
ones (task / simulator / sensor / measure / task_action / dataset / env /
action_space_configuration, habitat-lab/habitat/core/registry.py:72-196) and
its habitat-baselines ones (trainer / policy / obs_transformer / storage /
updater / auxiliary_loss / agent_access_mgr / episode_generator,
habitat-baselines/habitat_baselines/common/baseline_registry.py:28-193).

Each ``register_<kind>`` works as ``register_x(component, name=...)``, as the
decorator ``@register_x`` or ``@register_x(name="...")``, and, as the port's
earlier registry did, ``@register_x("Name")``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class Registry:
    """Process-global name -> component tables: state is shared at class
    level, so every ``Registry()`` sees the same mapping."""

    _tables: Dict[str, Dict[str, Any]] = {}

    # (public suffix, internal kind): the public API is register_<suffix>
    # and get_<suffix>
    _KINDS = (
        ("task", "task"),
        ("simulator", "sim"),
        ("sensor", "sensor"),
        ("measure", "measure"),
        ("task_action", "task_action"),
        ("dataset", "dataset"),
        ("env", "env"),
        ("action_space_configuration", "asc"),
        ("trainer", "trainer"),
        ("policy", "policy"),
        ("obs_transformer", "obs_transformer"),
        ("storage", "storage"),
        ("updater", "updater"),
        ("auxiliary_loss", "aux_loss"),
        ("agent_access_mgr", "agent_access_mgr"),
        ("episode_generator", "episode_generator"),
    )

    @classmethod
    def table(cls, kind: str) -> Dict[str, Any]:
        return cls._tables.setdefault(kind, {})

    @classmethod
    def add(cls, kind: str, component: Any, name: Optional[str] = None) -> Any:
        """Insert ``component`` into the ``kind`` table under ``name`` (the
        component's ``__name__`` by default) and return it unchanged."""
        cls.table(kind)[name or component.__name__] = component
        return component

    @classmethod
    def lookup(cls, kind: str, name: str) -> Any:
        tbl = cls.table(kind)
        try:
            return tbl[name]
        except KeyError:
            raise KeyError(f"No {kind} registered under name {name!r}. Available: {sorted(tbl)}") from None

    @classmethod
    def names(cls, kind: str) -> List[str]:
        return sorted(cls.table(kind))

    @property
    def mapping(self) -> Dict[str, Dict[str, Any]]:
        return self._tables


def _registrar(kind: str) -> Callable:
    def register(component: Any = None, *, name: Optional[str] = None):
        if isinstance(component, str):  # @register_x("Name")
            component, name = None, component
        if component is None:
            return lambda c: Registry.add(kind, c, name)
        return Registry.add(kind, component, name)

    return register


def _getter(kind: str) -> Callable:
    def get(name: str) -> Any:
        return Registry.lookup(kind, name)

    return get


for _suffix, _kind in Registry._KINDS:
    setattr(Registry, f"register_{_suffix}", staticmethod(_registrar(_kind)))
    setattr(Registry, f"get_{_suffix}", staticmethod(_getter(_kind)))

registry = Registry()

# habitat-baselines' import surface
baseline_registry = registry
