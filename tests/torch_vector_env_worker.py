"""Env makers for the worker processes of ``tests/test_torch_vector_env.py``
(imported by reference in each forkserver child; imports no JAX).

- ``make_rl_env(overrides)``: the port's ``RLTaskEnv`` on
  ``pointnav_procgen.yaml`` with ``overrides``, on the CPU, two PyTorch
  threads.
- ``make_stub(fail)``: a small env without a simulator whose construction
  raises when ``fail == "make"``; its ``step("boom")`` raises, and its
  ``exit(code)`` ends the worker without a reply (``os._exit`` in a worker
  process, ``SystemExit`` in a worker thread).
"""

import os
import threading

import torch

CFG = "benchmark/nav/pointnav/pointnav_procgen.yaml"


def make_rl_env(overrides):
    from habitat_torch.config.default import get_config
    from habitat_torch.core.environments import RLTaskEnv

    torch.set_num_threads(2)
    return RLTaskEnv(get_config(CFG, list(overrides)), device="cpu")


class StubEnv:
    observation_shapes = {"x": ((2,), torch.float32)}
    action_names = ("stop", "go")
    number_of_episodes = 1
    episodes = [0]

    def __init__(self):
        self._t = 0

    def reset(self):
        self._t = 0
        return {"x": torch.zeros(2)}

    def step(self, action):
        if action == "boom":
            raise ValueError("the stub env was asked to fail")
        self._t += 1
        return {"x": torch.full((2,), float(self._t))}, 1.0, action == 0, {}

    def render(self, mode="rgb"):
        return torch.full((4, 4, 3), self._t, dtype=torch.uint8).numpy()

    def exit(self, code: int):
        if threading.current_thread() is threading.main_thread():
            os._exit(code)
        raise SystemExit(code)

    def close(self):
        pass


def make_stub(fail=None):
    if fail == "make":
        raise ValueError("the stub env could not be built")
    return StubEnv()
