"""Registered env classes (port of ``habitat_tpu/core/environments.py``;
reference habitat-lab/habitat/core/environments.py).

``RLTaskEnv``'s reward and done (slack + reward measure (+ success reward),
done on episode over or on success when ``end_on_success``) are computed by
the batched env (``core/batched_env.py::RewardSpec``); the class here is the
registered host wrapper. ``GymRegistryEnv`` and ``GymHabitatEnv`` are
registered under their names and raise ``NotImplementedError``: they wait
for the port of ``gym/`` and ``core/spaces.py``, which rest on gymnasium.
"""

from __future__ import annotations

from habitat_torch.core.env import RLEnv
from habitat_torch.core.registry import registry


def get_env_class(env_name: str):
    """reference environments.py:25 get_env_class."""
    return registry.get_env(env_name)


@registry.register_env(name="RLTaskEnv")
class RLTaskEnv(RLEnv):
    pass


def _waits_for_gym(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to habitat_torch yet: it waits for the port of gym/ and core/spaces.py "
            "(gymnasium, which the card's machine does not have)")

    return build


for _name in ("GymRegistryEnv", "GymHabitatEnv"):
    registry.register_env(_waits_for_gym(_name), name=_name)
