"""habitat_torch's kinematic humanoid and controllers
(``articulated_agents/humanoid.py``) against habitat_tpu's on the CPU.

Both packages run the same host numpy code paths; every pose, root
transform, frame index and blend must agree within 1e-6 (float32 poses,
float64 roots):
- ``Motion`` and ``load_motion`` from an ``.npz`` and from a pickle in the
  reference's walk-pose layout (flat joint arrays reshaped, the displacement
  defaulting to the root's arc length), made in the test from a seed;
- ``_nlerp`` on random quaternion sets, ``ReachPoseGrid.synthetic`` and its
  trilinear ``blend`` at targets inside and outside the grid;
- ``HumanoidRearrangeController``: the procedural walk (40 frames toward
  changing directions), a stop, turns, reaches with either hand, walking
  while reaching; the same with a mocap clip;
- ``HumanoidSeqPoseController`` cycling and holding, from an array and
  from a file; ``KinematicHumanoid.update``; ``get_pose``.
"""

import pickle

import numpy as np
import pytest

from habitat_tpu.articulated_agents import humanoid as jh

from habitat_torch.articulated_agents import humanoid as th

ATOL = 1e-6


def _clip(seed=0, frames=24, flat=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(frames, th.NUM_JOINTS, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    T = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
    T[:, 0, 3] = np.cumsum(rng.uniform(0.01, 0.05, frames))
    T[:, 2, 3] = rng.normal(0.0, 0.01, frames).cumsum()
    return {"joints_quat_array": q.reshape(frames, -1) if flat else q, "transform_array": T, "fps": 30.0}


def _same(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=ATOL, err_msg=what)


def _same_ctrl(jc, tc, what):
    _same(jc.joint_pose, tc.joint_pose, what + " pose")
    _same(jc.obj_transform_base, tc.obj_transform_base, what + " root")
    _same(jc.get_pose(), tc.get_pose(), what + " get_pose")


@pytest.mark.parametrize("kind", ["npz", "pickle", "pickle_flat"])
def test_load_motion(tmp_path, kind):
    data = _clip(flat=kind == "pickle_flat")
    if kind == "npz":
        path = str(tmp_path / "walk.npz")
        np.savez(path, **data)
    else:
        path = str(tmp_path / "walk.pkl")
        with open(path, "wb") as f:
            pickle.dump({"walk_motion": data}, f)
    jm, tm = jh.load_motion(path), th.load_motion(path)
    assert tm.num_poses == jm.num_poses == 24 and tm.poses.shape == (24, th.NUM_JOINTS, 4)
    for f in ("poses", "transforms", "displacement"):
        _same(getattr(jm, f), getattr(tm, f), f)
    assert tm.fps == jm.fps and abs(tm.dist_per_step_size - jm.dist_per_step_size) <= ATOL


def test_nlerp_and_reach_grid():
    rng = np.random.default_rng(1)
    for k in (2, 8):
        q = rng.normal(size=(k, th.NUM_JOINTS, 4)).astype(np.float32)
        w = rng.uniform(size=k)
        _same(jh._nlerp(q, w), th._nlerp(q, w), "nlerp")
    for hand in (0, 1):
        jg, tg = jh.ReachPoseGrid.synthetic(hand), th.ReachPoseGrid.synthetic(hand)
        for f in ("xs", "ys", "zs", "poses"):
            _same(getattr(jg, f), getattr(tg, f), f)
        for target in rng.uniform([-0.9, 0.0, -1.1], [0.9, 1.9, 0.3], (12, 3)):
            _same(jg.blend(target), tg.blend(target), f"blend {target}")


@pytest.mark.parametrize("with_clip", [False, True])
def test_rearrange_controller(tmp_path, with_clip):
    path = None
    if with_clip:
        path = str(tmp_path / "walk.npz")
        np.savez(path, **_clip(seed=3))
    jc, tc = jh.HumanoidRearrangeController(path), th.HumanoidRearrangeController(path)
    assert tc.walk_speed == pytest.approx(jc.walk_speed, abs=ATOL)
    T0 = np.eye(4)
    T0[:3, 3] = [1.0, 0.0, 2.0]
    jc.reset(T0)
    tc.reset(T0)
    rng = np.random.default_rng(4)
    for t in range(40):
        d = rng.normal(size=3) * (t % 7 != 6)  # a zero direction now and then: the stop pose
        jc.calculate_walk_pose(d, distance_multiplier=1.0 + 0.1 * (t % 3))
        tc.calculate_walk_pose(d, distance_multiplier=1.0 + 0.1 * (t % 3))
        _same_ctrl(jc, tc, f"walk {t}")
    for t in range(6):
        target = rng.uniform([-1, 0.3, -1], [1, 1.7, 1]) + jc.obj_transform_base[:3, 3]
        d = rng.normal(size=3)
        if t % 3 == 0:
            jc.calculate_turn_pose(d)
            tc.calculate_turn_pose(d)
        elif t % 3 == 1:
            jc.calculate_reach_pose(target, index_hand=t % 2)
            tc.calculate_reach_pose(target, index_hand=t % 2)
        else:
            jc.calculate_walk_and_reach_pose(d, target, index_hand=1)
            tc.calculate_walk_and_reach_pose(d, target, index_hand=1)
        _same_ctrl(jc, tc, f"move {t}")
    jc.calculate_stop_pose()
    tc.calculate_stop_pose()
    _same_ctrl(jc, tc, "stop")
    assert np.abs(tc.obj_transform_base[:3, 3] - T0[:3, 3]).max() > 0.1  # it walked


def test_seq_pose_controller_and_kinematic_humanoid(tmp_path):
    path = str(tmp_path / "seq.npz")
    np.savez(path, **_clip(seed=5, frames=5))
    for make in (lambda m: m.HumanoidSeqPoseController(_clip(seed=6, frames=4)["joints_quat_array"]),
                 lambda m: m.HumanoidSeqPoseController.from_file(path)):
        jc, tc = make(jh), make(th)
        jc.reset(np.eye(4))
        tc.reset(np.eye(4))
        for t in range(9):
            cycle = t < 6
            jc.next_pose(cycle=cycle)
            tc.next_pose(cycle=cycle)
            assert jc._t == tc._t
            _same_ctrl(jc, tc, f"seq {t}")
    jk, tk = jh.KinematicHumanoid(), th.KinematicHumanoid()
    for k in (jk, tk):
        k.reconfigure()
        k.controller.reset(np.eye(4))
        k.controller.calculate_walk_pose(np.array([0.3, 0.0, -1.0]))
        k.update()
    _same(jk.base_pos, tk.base_pos, "base_pos")
    assert np.linalg.norm(tk.base_pos) > 0
