"""CLI entry point (port of ``habitat_tpu/baselines/run.py``; reference
habitat-baselines/habitat_baselines/run.py).

Usage:
    python -m habitat_torch.baselines.run --config-name=pointnav/ppo_pointnav_example \\
        [habitat_baselines.total_num_steps=1e5 ...] [--run-type eval] [--device cpu]
    torchrun --nproc_per_node=W -m habitat_torch.baselines.run --config-name=pointnav/ddppo_pointnav.yaml

Trains (or, with ``--run-type eval`` or ``habitat_baselines.evaluate=true``,
evaluates the ``latest`` checkpoint) on the card; ``--device cpu`` runs on
the CPU. Under torchrun or SLURM the process group is formed before
anything is built (``parallel/distributed.init_distributed``: NCCL, a card
per rank; gloo with ``--device cpu``) and the ``ddppo`` trainer trains over
it; evaluation runs in one process.
"""

from __future__ import annotations

import argparse
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from habitat_torch.config.default import get_config
from habitat_torch.core.logging import logger
from habitat_torch.parallel import distributed


def execute_exp(config, run_type: str, device=None) -> Dict[str, float]:
    """reference run.py:34; the policy's initial weights come from
    ``torch.manual_seed(habitat.seed)``."""
    seed = int(config.habitat.get("seed", 100))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    from habitat_torch.core.construct import trainer_from_config

    if run_type == "eval" and distributed.world().size > 1:
        raise ValueError("evaluate in one process, not under a process group")
    trainer = trainer_from_config(config, device=device)
    if run_type == "train":
        return trainer.train(seed=seed)
    if run_type == "eval":
        from habitat_torch.baselines.evaluator import evaluate_from_config

        return evaluate_from_config(config, trainer)
    raise ValueError(run_type)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", "--exp-config", dest="config_name", required=True,
                        help="experiment config (e.g. pointnav/ppo_pointnav_example)")
    parser.add_argument("--run-type", choices=["train", "eval"], default="train")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("overrides", nargs="*", help="dotted overrides a.b.c=value")
    args = parser.parse_args(argv)

    name = args.config_name
    if not name.endswith(".yaml"):
        name += ".yaml"
    config = get_config(name, args.overrides)
    run_type = args.run_type
    if config.get_path("habitat_baselines.evaluate", False):
        run_type = "eval"
    device = distributed.init_distributed(device=args.device)
    metrics = execute_exp(config, run_type, device=device)
    if distributed.rank0_only():
        logger.info(f"done: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
