"""Interactive arm-control play tool (port of the JAX repository's
``examples/interactive_play.py``; reference examples/interactive_play.py
— keyboard teleop of the full ArmAction composite: per-joint deltas, base
velocity, grip, with optional on-screen render).

Keys (reference key map, interactive_play.py get_input_vel_ctlr):
  w/s       base forward / back
  a/d       base turn left / right
  1..7      select arm joint            q/e  move selected joint - / +
  space     toggle grip (suction grasp)
  r         reset episode               x    quit

Headless demo mode (no TTY): a scripted sequence raises joints, drives the
base, and toggles the grip on the port's rearrangement env on ``device``
(``None`` = cuda); one host copy of the status observations per step.

Run: python -m habitat_torch.examples.interactive_play
"""

import sys

import numpy as np
import torch


def build_env(num_envs: int = 1, with_visual: bool = False, device=None):
    """Continuous arm env: action = [joint deltas (7), grip, base lin, base
    ang] (reference ArmAction composite, tasks/rearrange/actions/actions.py)."""
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    return make_rearrange_env(
        num_envs=num_envs,
        task="pick",
        with_visual=with_visual,
        control="arm",
        n_rooms_per_axis=1,
        n_clutter=0,
        seed=0,
        device=device,
    )


class PlaySession:
    """Maps key state -> one env action per frame and steps the env."""

    def __init__(self, env):
        self.env = env
        self.n_joints = env.n_joints
        self.state, self.obs = env.reset_fn()
        self.selected_joint = 0
        self.grip = -1.0
        self.frames = 0

    def action_from_keys(self, keys) -> np.ndarray:
        a = np.zeros((self.env.num_envs, self.n_joints + 3), np.float32)
        for k in keys:
            if k in "1234567":
                self.selected_joint = min(int(k) - 1, self.n_joints - 1)
            elif k == "q":
                a[:, self.selected_joint] = -1.0
            elif k == "e":
                a[:, self.selected_joint] = 1.0
            elif k == "w":
                a[:, self.n_joints + 1] = 1.0  # base lin
            elif k == "s":
                a[:, self.n_joints + 1] = -1.0
            elif k == "a":
                a[:, self.n_joints + 2] = 1.0  # base ang
            elif k == "d":
                a[:, self.n_joints + 2] = -1.0
            elif k == " ":
                self.grip = -self.grip
        a[:, self.n_joints] = self.grip
        return a

    def step(self, keys) -> dict:
        a = self.action_from_keys(keys)
        self.state, self.obs, r, d, info = self.env.step_fn(
            self.state, torch.as_tensor(a, device=self.env.device)
        )
        self.frames += 1
        return info

    def status(self) -> str:
        host = torch.cat([self.obs[k][0].reshape(-1).float() for k in ("joint", "ee_pos", "is_holding")]).cpu()
        j, ee, hold = host[: self.n_joints].numpy(), host[self.n_joints:self.n_joints + 3].numpy(), float(host[-1])
        return (
            f"frame {self.frames} joint[{self.selected_joint}] "
            f"q={j[self.selected_joint]:+.2f} ee=({ee[0]:+.2f},{ee[1]:+.2f},"
            f"{ee[2]:+.2f}) grip={'ON' if hold > 0 else 'off'}"
        )


SCRIPTED = (
    ["w"] * 5 + ["1", "e"] * 4 + ["3", "e"] * 4 + [" "] + ["w"] * 3
    + [" "] + ["a"] * 3
)


def main(max_steps: int = 0, interactive: bool | None = None, device=None):
    env = build_env(device=device)
    sess = PlaySession(env)
    if interactive is None:
        interactive = sys.stdin.isatty() and max_steps == 0
    if not interactive:
        steps = SCRIPTED if max_steps == 0 else SCRIPTED[:max_steps]
        for keys in steps:
            sess.step([keys])
        print(sess.status())
        return sess
    # TTY mode: raw single-key reads (no GL window in this image — status
    # line only; the reference uses pygame for the same loop)
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            k = sys.stdin.read(1)
            if k == "x":
                break
            if k == "r":
                sess.state, sess.obs = env.reset_fn()
                continue
            sess.step([k])
            print("\r" + sess.status(), end="", flush=True)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return sess


if __name__ == "__main__":
    main()
