#!/usr/bin/env python3
"""Exports the flagship PointNav checkpoint for the PyTorch port.

The checkpoint ``ckpts/flagship_params`` is an orbax store that only JAX can
read, so this runs on the CPU with JAX and orbax installed, from the root of
a checkout:

    JAX_PLATFORMS=cpu python scripts/export_flagship_torch.py [CKPT] [OUT]

It restores the parameters of the depth-only resnet18 + LSTM-512 PointNav
policy (4 actions, 128x128 depth) as ``tests/test_torch_models.py`` does,
converts them with ``habitat_torch.models.convert.params_from_jax`` (values
unchanged, float32) and writes OUT (default
``habitat_torch/weights/flagship_pointnav.pt``) with ``torch.save``, and
beside it OUT with the suffix ``.json``: the file's sha256, the source path
and the policy's build arguments, which
``habitat_torch.models.convert.load_policy_file`` reads back without JAX.
"""

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = "ckpts/flagship_params"
OUT = "habitat_torch/weights/flagship_pointnav.pt"
# the policy the flagship was trained with (scripts/train_generalization_tpu.py)
POLICY = dict(num_actions=4, visual_inputs=["depth"], input_hw=[128, 128], backbone="resnet18", hidden_size=512,
              num_recurrent_layers=1, goal_keys=["pointgoal_with_gps_compass"])


def restore_flat(ckpt):
    """The orbax checkpoint's parameters on the CPU, flattened to numpy
    arrays under "/"-joined paths."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import orbax.checkpoint as ocp
    from flax.traverse_util import flatten_dict

    from habitat_tpu.models.policy import make_pointnav_resnet_policy
    from habitat_tpu.models.rnn_state_encoder import initial_hidden_state

    n, (h, w) = 2, POLICY["input_hw"]
    obs = {"depth": jnp.zeros((n, h, w, 1), jnp.float32), "pointgoal_with_gps_compass": jnp.zeros((n, 2), jnp.float32)}
    jpol = make_pointnav_resnet_policy(POLICY["num_actions"], backbone=POLICY["backbone"],
                                       hidden_size=POLICY["hidden_size"])
    hidden = initial_hidden_state(n, POLICY["hidden_size"])
    abstract = jax.eval_shape(
        lambda k: jpol.init(k, obs, hidden, jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.float32)), jax.random.PRNGKey(1))
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=cpu), abstract)
    params = ocp.StandardCheckpointer().restore(os.path.abspath(ckpt), abstract)
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def write_export(state, out, source, policy):
    """``torch.save`` the state dict to ``out`` and write its JSON (sha256,
    source, the policy's build arguments) beside it; returns the JSON's
    content."""
    import torch

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(state, out)
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    meta = dict(sha256=digest, source=source, policy=policy)
    with open(os.path.splitext(out)[0] + ".json", "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return meta


def export(ckpt=CKPT, out=OUT):
    """Write the state dict and its JSON; returns the JSON's content."""
    sys.path.insert(0, ROOT)
    from habitat_torch.models.convert import params_from_jax

    return write_export(params_from_jax(restore_flat(ckpt)), out, ckpt, POLICY)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    meta = export(*sys.argv[1:3])
    print(json.dumps(meta))
