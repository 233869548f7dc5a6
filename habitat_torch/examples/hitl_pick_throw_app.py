"""HITL pick_throw_vr analog (port of the JAX repository's
``examples/hitl_pick_throw_app.py``): a VR-style remote avatar whose HANDS
grab and throw rearrange objects (reference examples/hitl/pick_throw_vr/
pick_throw_vr.py: per-hand grasp keys `get_grasp_keys_by_hand`, remote
grasp `_try_grasp_remote`, and `_update_held_and_try_throw_remote` — on
release the held object launches with the hand's velocity).

The avatar pose arrives in the unity wire format (habitat_torch/hitl/
unity_protocol.parse_client_state: {"avatar": {"root", "hands": [...]}});
while held the object is kinematically parented to the hand, and the
release hands it to the contact stepper of the port's rearrangement env
with the hand's instantaneous velocity — thrown boxes fly, tumble, and
settle. Headless: ``main`` scripts a grab-carry-throw session on ``device``
(``None`` = cuda) and checks the object flew.

Run: python -m habitat_torch.examples.hitl_pick_throw_app
"""

import dataclasses

import numpy as np
import torch

from habitat_torch.hitl.app_states import AppState
from habitat_torch.hitl.hitl_main import HitlDriver
from habitat_torch.hitl.unity_protocol import parse_client_state

GRASP_DIST = 0.35  # reference pick_throw_vr grasp proximity


class AppStatePickThrow(AppState):
    """Hand-driven pick & throw over a batched rearrange env (env index 0).
    The host edits of the held object's lane (parenting, the throw's
    velocity) copy one row to the device each."""

    def __init__(self, env):
        self.env = env
        self.service = None
        self.state = None
        self.held_by_hand = [-1, -1]  # object index held per hand, -1 free
        self._prev_hands = None
        self.events = []

    def bind(self, service):
        self.service = service

    def on_environment_reset(self, _):
        self.held_by_hand = [-1, -1]
        self._prev_hands = None

    # -- client-state ingestion (wire format) ------------------------------
    def apply_client_state(self, client_state, dt):
        _ack, avatar, inputs = parse_client_state(client_state)
        if avatar is None or "hands" in (None,):
            return
        hands = avatar.get("hands") or []
        grips = (inputs or {}).get("buttonHeld", [])
        hand_vel = [np.zeros(3, np.float32)] * len(hands)
        if self._prev_hands is not None and dt > 0:
            hand_vel = [
                (np.asarray(h["position"]) - np.asarray(p["position"])) / dt
                for h, p in zip(hands, self._prev_hands)
            ]
        for hi, hand in enumerate(hands[:2]):
            hp = np.asarray(hand["position"], np.float32)
            gripped = f"grip{hi}" in grips
            if gripped and self.held_by_hand[hi] < 0:
                self._try_grasp(hi, hp)
            elif not gripped and self.held_by_hand[hi] >= 0:
                self._throw(hi, np.asarray(hand_vel[hi], np.float32))
            elif self.held_by_hand[hi] >= 0:
                self._carry(hi, hp)
        self._prev_hands = hands

    def _obj_world(self):
        return self.env._obj_world(self.state)[0].cpu().numpy()

    def _try_grasp(self, hi, hand_pos):
        objs = self._obj_world()
        valid = self.env.table.obj_valid[self.state.ep_idx][0].cpu().numpy()
        d = np.linalg.norm(objs - hand_pos[None], axis=-1)
        d = np.where(valid, d, np.inf)
        j = int(np.argmin(d))
        if d[j] <= GRASP_DIST:
            self.held_by_hand[hi] = j
            self.events.append(("grasp", hi, j))
            self._carry(hi, hand_pos)

    def _set_row(self, field, j, value):
        """``state.<field>[0, j] = value`` on a copy, on the state's device."""
        t = getattr(self.state, field).clone()
        t[0, j] = torch.as_tensor(np.asarray(value, np.float32), device=t.device)
        self.state = dataclasses.replace(self.state, **{field: t})

    def _carry(self, hi, hand_pos):
        j = self.held_by_hand[hi]
        half_y = float(self.env.table.obj_half[self.state.ep_idx][0, j, 1])
        self._set_row("obj_pos", j, hand_pos - [0.0, half_y, 0.0])  # bottom-ref under hand
        self._set_row("obj_vel", j, np.zeros(3))

    def _throw(self, hi, hand_vel):
        j = self.held_by_hand[hi]
        self.held_by_hand[hi] = -1
        self._set_row("obj_vel", j, hand_vel)
        self.events.append(("throw", hi, j, tuple(np.round(hand_vel, 2))))

    def sim_update(self, dt, post):
        # physics advances through the env step; the robot idles on a
        # turn-in-place action (action 0 is STOP and would end the episode)
        act = torch.full((self.env.num_envs,), 2, dtype=torch.int32, device=self.env.device)
        self.state, obs, r, d, info = self.env.step_fn(self.state, act)
        td = self.service.text_drawer
        td.clear()
        td.add_text(f"held: {self.held_by_hand}")
        # target highlight rings (reference _add_target_object_highlight_ring)
        for j, p in enumerate(self._obj_world()):
            self.service.line_render.draw_circle(p, 0.25)


def main(device=None):
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    env = make_rearrange_env(
        num_envs=1, task="empty", with_visual=False, dynamics="contacts",
        num_objects=2, n_rooms_per_axis=1, n_clutter=0, seed=2, device=device,
    )
    app = AppStatePickThrow(env)

    class EnvAdapter:
        def reset(self):
            app.state, obs = env.reset_fn()
            return {k: v[0] for k, v in obs.items()}

        def step(self, action):
            return {}

    driver = HitlDriver(app, env=EnvAdapter(), record_video=False, target_sps=1e9)
    app.bind(driver.service)
    driver.reset()

    objs0 = app._obj_world()
    target = objs0[0]
    dt = 1 / 30

    def hand_at(p):
        return {
            "avatar": {
                "root": {"position": [0, 0, 0], "rotation": [1, 0, 0, 0]},
                "hands": [
                    {"position": list(map(float, p)), "rotation": [1, 0, 0, 0]},
                    {"position": [0, 0, 0], "rotation": [1, 0, 0, 0]},
                ],
            },
        }

    # approach -> grip -> carry up -> swing forward -> release mid-swing
    traj = []
    approach = target + [0.0, 0.1, 0.0]
    for k in range(5):  # reach toward the object
        traj.append((approach + [0, 0.02 * (4 - k), 0], False))
    for k in range(8):  # gripped carry upward
        traj.append((approach + [0, 0.07 * k, 0], True))
    for k in range(6):  # forward swing, still gripped
        traj.append((approach + [0.12 * k, 0.56, 0], True))
    traj.append((approach + [0.85, 0.56, 0], False))  # release -> throw

    for p, grip in traj:
        cs = hand_at(p)
        if grip:
            cs["input"] = {"buttonHeld": ["grip0"]}
        app.apply_client_state(cs, dt)
        driver.step(dt)
    for _ in range(60):  # ballistic flight + tumble + settle
        driver.step(dt)

    objs1 = app._obj_world()
    flight = np.linalg.norm((objs1[0] - target)[[0, 2]])
    kinds = [e[0] for e in app.events]
    print("events:", app.events)
    print("thrown object moved %.2f m (xz); final y %.3f" % (flight, objs1[0][1]))
    assert "grasp" in kinds and "throw" in kinds
    assert flight > 0.5, "object did not fly"
    assert abs(objs1[0][1] - objs0[0][1]) < 0.6  # came back down to support
    return app


if __name__ == "__main__":
    main()
