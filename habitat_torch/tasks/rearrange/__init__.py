"""Rearrangement (port of ``habitat_tpu/tasks/rearrange``): rigid-body boxes
and their contact step so far; the env, its sensors, actions and samplers
follow."""
