"""Greedy geodesic follower demo + top-down-map video (port of the JAX
repository's ``examples/shortest_path_follower_example.py``; reference
examples/shortest_path_follower_example.py).

The port's ``TpuSim`` on ``device`` (``None`` = cuda), its
``ShortestPathFollower``, ``TopDownMapTracker`` and ``images_to_video``
(a GIF). Returns the follower's actions.

Run: python -m habitat_torch.examples.shortest_path_follower_example
"""

import os

import numpy as np

from habitat_torch.sims.tpu_sim import TpuSim
from habitat_torch.tasks.shortest_path_follower import ShortestPathFollower
from habitat_torch.utils.visualizations.maps import TopDownMapTracker
from habitat_torch.utils.visualizations.utils import (
    images_to_video,
    observations_to_image,
)

IMAGE_DIR = os.path.join("examples", "images")


def shortest_path_example(max_steps: int = 120, make_video: bool = True, device=None, output_dir: str = IMAGE_DIR):
    sim = TpuSim(None, device=device)
    sim.seed(7)
    obs = sim.reset()
    goal = np.asarray(sim.sample_navigable_point())
    follower = ShortestPathFollower(sim, goal_radius=0.3, return_one_hot=False)
    tracker = TopDownMapTracker(sim._scene)
    tracker.reset(goal_positions=goal[None])

    frames, actions = [], []
    for step in range(max_steps):
        action = follower.get_next_action(goal)
        actions.append(action)
        if action == 0:
            print(f"reached goal in {step} steps")
            break
        obs = sim.step(action)
        tracker.update(sim.get_agent_state().position, sim._yaw)
        if make_video:
            frames.append(
                observations_to_image(obs, {"top_down_map": tracker.frame()})
            )
    if make_video and frames:
        images_to_video(frames, output_dir, "shortest_path_example", fps=10)
    return actions


if __name__ == "__main__":
    shortest_path_example()
