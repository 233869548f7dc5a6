#!/usr/bin/env python3
"""chip_smoke.py's [hitl] phase alone on the card, and where a session's
frame time goes.

    python3 scripts/hitl_probe.py           # build the kernels, run hitl_phase with main's kernel_counters()
    python3 scripts/hitl_probe.py --bare    # first: the session's env and controller in HitlDriver.run
                                            # with no server, no clients, no recording, unpaced

Run from the repository root on a machine with one NVIDIA GPU. Prints the
phase's log lines and, with ``--bare``, one "bare" line: frames per second
unpaced and ms per act and per env step, to set beside the session's split.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from habitat_torch.ops import cuda_build  # noqa: E402


def bare(dev, frames=120, warmup=20):
    """The session's Env and BaselinesController in HitlDriver.run, alone."""
    from habitat_torch.baselines.flagship import WEIGHTS
    from habitat_torch.config.default import get_config
    from habitat_torch.core.env import Env
    from habitat_torch.hitl.app_states import AppState
    from habitat_torch.hitl.hitl_main import BaselinesController, HitlDriver
    from habitat_torch.models.convert import load_policy_file

    env = Env(get_config(cs.HITL_CONFIG, overrides=list(cs.HITL_RGB)), device=dev)
    controller = BaselinesController(load_policy_file(WEIGHTS, device=dev))
    act_ms, step_ms = [], []
    env_step = env.step

    def timed_step(a):
        t = time.perf_counter()
        out = env_step(a)
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    env.step = timed_step

    class App(AppState):
        def sim_update(self, dt, post):
            obs = driver.service.get_observations()
            if env.episode_over:
                obs = env.reset()
                controller.on_environment_reset()
            t = time.perf_counter()
            post["action"] = controller.act(obs)
            act_ms.append((time.perf_counter() - t) * 1e3)

    driver = HitlDriver(App(), env=env, target_sps=1e9, record_video=False)
    driver.run(max_steps=warmup)
    act_ms.clear(), step_ms.clear()
    t0 = time.perf_counter()
    driver.run(max_steps=frames)
    wall = time.perf_counter() - t0
    print(f"[hitl-probe] bare: {frames / wall:.2f} frames/s unpaced, act {cs.ms_text(act_ms)}, env step "
          f"{cs.ms_text(step_ms)}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("hitl_probe: no CUDA device", file=sys.stderr)
        return 2
    cuda_build.build()
    gpu = cs.gpu_name_and_power()
    dev = torch.device("cuda")
    zero_counts, path_counts, plain_watch, plain_on_card = cs.kernel_counters()
    print(gpu, flush=True)
    if "--bare" in sys.argv[1:]:
        bare(dev)
    cs.hitl_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
