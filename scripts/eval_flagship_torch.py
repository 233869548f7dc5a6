#!/usr/bin/env python3
"""Evaluates the flagship PointNav checkpoint with the PyTorch port, on the
card unless asked for the CPU, without JAX.

Runs ``habitat_torch.baselines.flagship.flagship_eval``: the protocol of
``scripts/eval_flagship_ckpt.py`` (64 held-out procedural scenes, 64 envs,
128x128 depth + pointgoal, greedy, the first 4 episodes of each env within
850 env steps; see that module).

    python scripts/eval_flagship_torch.py [--weights W] [--device cuda|cpu]

``--weights`` defaults to ``habitat_torch/weights/flagship_pointnav.pt``
(``scripts/export_flagship_torch.py`` writes it). Prints one JSON line:
episodes, success, SPL, env steps run, env-steps/s, wall seconds and the
device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from habitat_torch.baselines.flagship import WEIGHTS, flagship_eval  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights", default=WEIGHTS)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = ap.parse_args()
    print(json.dumps(flagship_eval(a.weights, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
