#!/usr/bin/env python3
"""The share of envs in which the oracle hierarchies complete a successful
episode, in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/hrl_success_shares.py

For tests/test_hrl_planner.py's plan-table planner (400 steps) and
tests/test_hrl_pddl.py's fixed plan (300 steps), on those tests' env (task
rearrange, one room, no clutter, seed 3, episodes of up to 400 steps) at
its N=4 and at N=128, and on scripts/train_hrl_tpu.py's env (8 scenes x 16
episodes, seed 0) at N=128 with episodes of up to 400 steps: the share in
each package and the envs whose outcome differs between them. Prints one
JSON line. About a minute.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = {
    "tests N=4": dict(num_envs=4, task="rearrange", with_visual=False, seed=3, max_episode_steps=400,
                      n_rooms_per_axis=1, n_clutter=0),
    "tests N=128": dict(num_envs=128, task="rearrange", with_visual=False, seed=3, max_episode_steps=400,
                        n_rooms_per_axis=1, n_clutter=0),
    "train_hrl N=128": dict(num_envs=128, task="rearrange", num_scenes=8, episodes_per_scene=16, seed=0,
                            with_visual=False, n_rooms_per_axis=1, n_clutter=0, max_episode_steps=400),
}
STEPS = {"planner": 400, "fixed": 300}


def main():
    sys.path.insert(0, ROOT)
    import jax
    import numpy as np

    from habitat_tpu.baselines.hrl import hierarchical as jh
    from habitat_tpu.baselines.hrl import planner as jpl
    from habitat_tpu.tasks.rearrange.generator import make_rearrange_env as jax_env
    from habitat_torch.baselines.hrl import hierarchical as th
    from habitat_torch.baselines.hrl import planner as tpl
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    out = {}
    for name, kw in ENVS.items():
        je, te = jax_env(**kw), make_rearrange_env(device="cpu", **kw)
        for pol, steps in STEPS.items():
            jhl = jpl.PlannerHighLevelPolicy(je) if pol == "planner" else jh.FixedHighLevelPolicy(
                je, jh.default_rearrange_plan())
            thl = tpl.PlannerHighLevelPolicy(te) if pol == "planner" else th.FixedHighLevelPolicy(
                te, th.default_rearrange_plan())
            jp, tp = jh.HierarchicalPolicy(je, jhl), th.HierarchicalPolicy(te, thl)
            js, _ = je.reset_fn(jax.random.PRNGKey(0))
            *_, jsucc = jax.jit(lambda s, h: jp.rollout(s, h, steps))(js, jp.init_state())
            ts, _ = te.reset_fn()
            *_, tsucc = tp.rollout(ts, tp.init_state(), steps)
            j_solved = np.asarray(jsucc).max(0) > 0
            t_solved = (tsucc.max(0).values > 0).numpy()
            out[f"{name} {pol} {steps} steps"] = dict(jax=float(j_solved.mean()), port=float(t_solved.mean()),
                                                      envs_that_differ=int((j_solved != t_solved).sum()))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
