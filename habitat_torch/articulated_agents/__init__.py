"""Articulated agents (port of ``habitat_tpu/articulated_agents``): robot
tables, batched kinematics and arm dynamics, URDF chains, the manipulator
host classes and the legged base. The humanoid is not ported yet."""
