"""Articulated agents (port of ``habitat_tpu/articulated_agents``): robot
tables, batched kinematics and arm dynamics, URDF chains, the manipulator
host classes, the legged base and the humanoid (``humanoid.py``)."""
