"""HRL: the hierarchical policy, its skills and high-level policies, and
HRL-PPO (port of ``habitat_tpu/baselines/hrl``; reference rl/hrl/). The
high-level policies: ``FixedHighLevelPolicy`` (a fixed PDDL plan),
``PlannerHighLevelPolicy`` (symbolic search precomputed into a 2^P plan
table, ``planner.py``) and the neural one trained by ``hrl_ppo.py``."""

from habitat_torch.baselines.hrl.hierarchical import (  # noqa: F401
    FixedHighLevelPolicy,
    HierarchicalPolicy,
    NnSkill,
    Skill,
    default_rearrange_plan,
)
from habitat_torch.baselines.hrl.planner import (  # noqa: F401
    PlannerHighLevelPolicy,
    build_plan_table,
)
