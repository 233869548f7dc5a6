"""Name -> component tables for the kinds the nav env factory resolves
(sensor, measure, task_action), under the JAX package's registered names so
the same config strings resolve in both."""

from __future__ import annotations

from typing import Any, Callable, Dict

_KINDS = ("sensor", "measure", "task_action")


class Registry:
    def __init__(self) -> None:
        self._tables: Dict[str, Dict[str, Any]] = {k: {} for k in _KINDS}

    def _register(self, kind: str, name: str) -> Callable[[Any], Any]:
        def add(component: Any) -> Any:
            self._tables[kind][name] = component
            return component

        return add

    def _get(self, kind: str, name: str) -> Any:
        table = self._tables[kind]
        if name not in table:
            raise KeyError(f"No {kind} registered under name {name!r}. Available: {sorted(table)}")
        return table[name]

    def register_sensor(self, name: str):
        return self._register("sensor", name)

    def register_measure(self, name: str):
        return self._register("measure", name)

    def register_task_action(self, name: str):
        return self._register("task_action", name)

    def get_sensor(self, name: str):
        return self._get("sensor", name)

    def get_measure(self, name: str):
        return self._get("measure", name)

    def get_task_action(self, name: str):
        return self._get("task_action", name)


registry = Registry()
