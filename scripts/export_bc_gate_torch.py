#!/usr/bin/env python3
"""Exports the starting weights of the behavior-cloning learning gate for
the PyTorch port.

``tests/test_il.py::test_bc_learns_to_imitate_follower`` trains a blind
clone (4 actions, pointgoal, LSTM-64) for 30 updates from the JAX
package's initial parameters (``BCLearner.init_fn(PRNGKey(0))``) and asks
that its ``teacher_match`` rise by more than 0.15 and end above 0.5. The
rise clears 0.15 by 0.004 from those parameters; from torch's default
initialisation the port's clone rises by 0.06-0.09 (seeds 0-3, on the
CPU), so the gate is held on the port from these same parameters. This
runs on the CPU with JAX, from the root of a checkout:

    JAX_PLATFORMS=cpu python scripts/export_bc_gate_torch.py [OUT]

and writes OUT (default ``habitat_torch/weights/bc_gate_init.pt``) with its
JSON, as ``scripts/export_flagship_torch.py`` does;
``habitat_torch.models.convert.load_policy_file`` reads it back without
JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = "habitat_torch/weights/bc_gate_init.pt"
SOURCE = "tests/test_il.py::test_bc_learns_to_imitate_follower: BCLearner.init_fn(PRNGKey(0))"
# the gate's env (tests/test_il.py:14-24) and policy
SCENES = dict(num_scenes=2, episodes_per_scene=6, seed=5, extent=8.0)
ENV = dict(num_envs=8, max_episode_steps=100)
POLICY = dict(num_actions=4, visual_inputs=["rgb", "depth"], input_hw=[128, 128], has_visual=False, hidden_size=64,
              goal_keys=["pointgoal_with_gps_compass"])


def jax_initial_params():
    """The gate's initial Flax parameters, flattened to numpy arrays under
    "/"-joined paths."""
    import jax
    import numpy as np
    from flax.traverse_util import flatten_dict

    from habitat_tpu.baselines.il.bc_trainer import BCConfig, BCLearner
    from habitat_tpu.core.env_factory import make_nav_env
    from habitat_tpu.datasets.pointnav import make_procedural_pointnav
    from habitat_tpu.models.policy import make_pointnav_resnet_policy

    scenes, episodes, fields = make_procedural_pointnav(**SCENES)
    env = make_nav_env(scenes, episodes, precomputed_fields=fields, **ENV)
    policy = make_pointnav_resnet_policy(POLICY["num_actions"], has_visual=False, hidden_size=POLICY["hidden_size"])
    ts = jax.jit(BCLearner(env, policy, BCConfig(num_steps=32, lr=2e-3)).init_fn)(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in flatten_dict(ts.params, sep="/").items()}


def export(out=OUT):
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from export_flagship_torch import write_export

    from habitat_torch.models.convert import params_from_jax

    return write_export(params_from_jax(jax_initial_params()), out, SOURCE, POLICY)


if __name__ == "__main__":
    meta = export(*sys.argv[1:2])
    print(json.dumps(meta))
