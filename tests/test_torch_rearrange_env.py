"""habitat_torch's batched rearrangement env against habitat_tpu's on the CPU.

The same procedural generator (seeded numpy) feeds both packages, at N=4
envs over one scene of four episodes. The JAX side steps through one
``jax.jit`` of ``step_fn`` per configuration; the port steps on CPU tensors.

- Generator: the port's scenes, episodes and tables equal the JAX ones bit
  for bit; settled positions (contacts) within 1e-5.
- Config path: ``rearrange_env_from_config`` on the JAX side from
  ``benchmark/rearrange/pick_procgen.yaml`` (contacts, settled spawns) and the
  port's ``make_rearrange_env`` built from that env's attributes: the same
  tables and reset.
- Teacher-forced steps: a scripted greedy controller runs the JAX env (drive to
  the target, grasp, carry to the goal, release; to the handle and pull for
  open/close) and records its states; each recorded JAX state, converted to
  the port's, goes through one port ``step_fn`` with the same action. The
  configurations cover every control (discrete, continuous, arm kinematic
  and under motor dynamics, arm_ee), every dynamics mode (kinematic,
  gravity, contacts) and the tasks pick, place, rearrange, open (prismatic),
  close (revolute), nav_to_obj and empty, with Fetch and Spot. Tolerances:
  observations, reward, info and float state within 1e-5, discrete fields
  equal. Under contacts a box the robot touches is ill-conditioned in both
  packages (tests/test_torch_contacts.py): the boxes within the robot's
  reach are held to that file's bounds, the robot force to its 1e-4
  relative bound.
- Free-running kinematic episode: the port run from its own reset under the
  JAX controller's actions gives the same held object, success and done at
  every step.
- Dynamic geometry (Spot's legs, the arm links) and one 32x32 head render
  (JAX on the CPU, as tests/test_rearrange.py renders): semantics and
  hit/miss equal on >= 99.9% of pixels, normalized depth within 1e-4 on
  common hits, RGB within one level on >= 99.9% of pixels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.ops import navgrid as jng
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.tasks.rearrange import generator as jgen
from habitat_tpu.tasks.rearrange import rearrange_env as jre

from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
from habitat_torch.models.policy import STATE_KEYS, make_pointnav_resnet_policy, state_keys_of
from habitat_torch.ops import navgrid as tng
from habitat_torch.ops import raycast as trc
from habitat_torch.sims.scene import pack_scenes
from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.tasks.rearrange import rearrange_env as tre
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL = 1e-5
N = 4
GEN = dict(num_scenes=1, episodes_per_scene=4, seed=0)
# the bounds of tests/test_torch_contacts.py: boxes the robot reaches, and
# the robot force (100 N per metre of penetration)
REACHED_BOUND = dict(obj_pos=6e-5, obj_vel=6e-4, obj_quat=1.2e-4, obj_omega=3e-3)
FORCE_RTOL, FORCE_ATOL = 1e-4, 1e-3
DISCRETE_FIELDS = ("ep_ptr", "ep_idx", "step", "held", "human_held", "ever_held", "stop_called", "collided", "collision_count",
                   "last_action", "episode_over", "episode_count")
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(tre.RearrangeState))

# name -> (make_rearrange_env keywords, controller, recorded steps)
CONFIGS = {
    "pick-discrete-kinematic": (dict(task="pick"), "discrete", 100),
    "place-continuous-contacts": (dict(task="place", control="continuous", dynamics="contacts",
                                       constraint_violation_drops_object=True, max_accum_force=40.0),
                                  "continuous", 90),
    "rearrange-arm_dynamics-gravity": (dict(task="rearrange", control="arm", arm_dynamics=True, dynamics="gravity",
                                            constraint_violation_ends_episode=True), "arm", 40),
    "open-discrete-gravity": (dict(task="open", art_joint="prismatic", dynamics="gravity"), "handle", 60),
    "close-discrete-kinematic": (dict(task="close", art_joint="revolute"), "handle", 60),
    "nav_to_obj-arm-spot": (dict(task="nav_to_obj", control="arm", robot="SpotRobot"), "arm", 40),
    "empty-arm_ee": (dict(task="empty", control="arm_ee", sensor_keys=("obj_start_sensor", "joint", "ee_pos",
                                                                      "nav_to_skill_sensor",
                                                                      "initial_gps_compass_sensor",
                                                                      "obj_goal_pos_sensor")),
                     "arm_ee", 30),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _envs(with_visual=False, **kw):
    kw = {**GEN, "num_envs": N, "with_visual": with_visual, "render_size": (32, 32), **kw}
    return jgen.make_rearrange_env(**kw), tgen.make_rearrange_env(device="cpu", **kw)


def _np(x):
    return np.asarray(x)


def to_port_state(js) -> tre.RearrangeState:
    """A JAX RearrangeState as the port's (its key dropped)."""
    out = {}
    for name in STATE_FIELDS:
        x = torch.as_tensor(np.array(getattr(js, name)))
        out[name] = x.long() if name in ("ep_ptr", "ep_idx", "held", "human_held") else x
    return tre.RearrangeState(**out)


# -- the scripted controller --------------------------------------------------------


def _steer(rel, near, stop_dist):
    """Discrete greedy step toward an agent-frame position (tests/test_rearrange.py:53-73)."""
    dist = np.linalg.norm(rel[:, [0, 2]], axis=-1)
    ang = np.arctan2(-rel[:, 0], -rel[:, 2])
    act = np.where(np.abs(ang) < np.deg2rad(12), jre.A_FWD, np.where(ang > 0, jre.A_LEFT, jre.A_RIGHT))
    return np.where(dist < stop_dist, near, act), dist, ang


def _controller_inputs(je):
    """One jit of what the controller reads from a JAX state."""
    def f(js):
        tgt = je._target_obj(js)
        rows = jnp.arange(N)
        handle = je._handle_pos(js)

        def rel(p):
            return jre.rotate_world_to_agent(p - js.pos, js.yaw)

        return dict(start_rel=rel(je._obj_world(js)[rows, tgt]), goal_rel=rel(je.table.target_pos[js.ep_idx, tgt]),
                    handle_rel=rel(handle), handle=handle, ee=je._ee_pos(js), target=tgt)
    return jax.jit(f)


def drive(je, feats, js, kind, t):
    """The JAX controller's action for state ``js`` at step ``t``; ``feats``
    (jitted) reads the agent-frame target, goal and handle."""
    f = {k: _np(v) for k, v in feats(js).items()}
    held = _np(js.held) >= 0
    if kind == "handle":
        act, _, _ = _steer(f["handle_rel"], jre.A_FWD, 0.0)
        near = np.linalg.norm((f["handle"] - f["ee"])[:, [0, 2]], axis=-1) < 0.9
        return np.where(near, jre.A_GRAB, act).astype(np.int32)
    carrying = held & (_np(js.held) == f["target"])
    rel = np.where(carrying[:, None], f["goal_rel"], f["start_rel"])
    near_act = np.where(carrying, jre.A_GRAB, jre.A_GRAB if kind == "discrete" else jre.A_STOP)
    act, dist, ang = _steer(rel, near_act, np.where(carrying, 0.4, 0.7))
    if kind == "discrete":
        return act.astype(np.int32)
    lin = np.where(np.abs(ang) < np.deg2rad(12), 1.0, 0.0)
    turn = np.clip(ang / je.turn, -1.0, 1.0)
    grip = np.where(carrying, np.where(dist < 0.6, -1.0, 1.0), np.where(dist < 0.7, 1.0, -1.0))
    if kind == "continuous":
        return np.stack([lin, turn, grip], -1).astype(np.float32)
    if kind == "arm":
        J = je.n_joints
        dq = 0.6 * np.sin(0.3 * t + np.arange(J))[None].repeat(N, 0)
        return np.concatenate([dq, grip[:, None], lin[:, None], turn[:, None]], -1).astype(np.float32)
    ee = np.broadcast_to([0.5 * np.sin(0.4 * t), -0.5, 0.5 * np.cos(0.4 * t)], (N, 3))  # down, circling
    return np.concatenate([ee, grip[:, None], lin[:, None], turn[:, None]], -1).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """name -> (JAX env, port env, recorded [(state, action, outputs)])."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, kind, steps = CONFIGS[name]
            je, te = _envs(**kw)
            jstep, feats = jax.jit(je.step_fn), _controller_inputs(je)
            js, _ = je.reset_fn(jax.random.PRNGKey(0))
            if kind == "handle":  # start beside the handle, so the first episodes pull it
                h = _np(feats(js)["handle"])
                js = dataclasses.replace(js, pos=jnp.asarray(np.c_[h[:, 0] + 0.4, _np(js.pos)[:, 1], h[:, 2]]))
            rec = []
            for t in range(steps):
                a = drive(je, feats, js, kind, t)
                out = jstep(js, jnp.asarray(a))
                rec.append((js, a, out))
                js = out[0]
            cache[name] = (je, te, rec, jstep)
        return cache[name][:3]

    get.jstep = lambda name: cache[name][3]

    return get


# -- generator and config path -------------------------------------------------

TABLE_FIELDS = [f.name for f in dataclasses.fields(tre.RearrangeTable) if f.name != "nav"]
NAV_FIELDS = ("scene_idx", "start_pos", "start_yaw", "goal_pos", "goal_valid", "geodesic_start", "dist_field")


def _assert_tables_equal(jt, tt, settled_atol=None):
    for f in TABLE_FIELDS:
        a, b = _np(getattr(jt, f)), getattr(tt, f).cpu().numpy()
        if f == "obj_init" and settled_atol is not None:
            np.testing.assert_allclose(b, a, atol=settled_atol, err_msg=f)
        else:
            assert np.array_equal(a, b.astype(a.dtype)), f
    for f in NAV_FIELDS:
        a, b = _np(getattr(jt.nav, f)), getattr(tt.nav, f).cpu().float().numpy()
        assert np.array_equal(a.astype(np.float32), b), f"nav.{f}"


def test_generator_matches_bit_for_bit():
    sj, ej = jgen.make_procedural_rearrange(num_scenes=2, episodes_per_scene=3, seed=5, n_clutter=2)
    st, et = tgen.make_procedural_rearrange(num_scenes=2, episodes_per_scene=3, seed=5, n_clutter=2)
    assert [s.scene_id for s in sj] == [s.scene_id for s in st] and len(ej) == len(et) == 6
    for a, b in zip(ej, et):
        assert (a.episode_id, a.start_position, a.start_rotation, a.rigid_objs, a.targets) == (
            b.episode_id, b.start_position, b.start_rotation, b.rigid_objs, b.targets)
    index = {s.scene_id: i for i, s in enumerate(sj)}
    for art_joint, settle in (("prismatic", False), ("revolute", True)):
        jt = jgen.build_rearrange_table(ej, {s.scene_id: s for s in sj}, index, settle=settle, art_joint=art_joint)
        tt = tgen.build_rearrange_table(et, {s.scene_id: s for s in st}, index, settle=settle, art_joint=art_joint,
                                        device="cpu")
        _assert_tables_equal(jt, tt, settled_atol=ATOL if settle else None)


def test_config_path_matches():
    from habitat_tpu.config.default import get_config
    from habitat_tpu.core.construct import rearrange_env_from_config

    cfg = get_config("benchmark/rearrange/pick_procgen.yaml",
                     ["habitat.dataset.procedural.num_scenes=1", "habitat.dataset.procedural.episodes_per_scene=4"])
    je = rearrange_env_from_config(cfg, num_envs=2, with_visual=False)
    proc = cfg.habitat.dataset.procedural
    # the generator's settings as rearrange_env_from_config reads them
    gen = {k: int(proc.get(k, d)) for k, d in (("num_scenes", 2), ("episodes_per_scene", 16),
                                               ("n_rooms_per_axis", 2), ("n_clutter", 3), ("num_objects", 3))}
    robot = next(k for k, v in tre.ROBOTS.items() if v.name == je.rparams.name)
    te = tgen.make_rearrange_env(
        num_envs=2, task=je.task, seed=int(cfg.habitat.get("seed", 0)), with_visual=False, **gen,
        max_episode_steps=je.max_episode_steps, success_reward=je.success_reward, slack_reward=je.slack_reward,
        control=je.control, robot=robot, dynamics=je.dynamics,
        max_accum_force=je.max_accum_force, sensor_keys=je.sensor_keys, measure_keys=je.measure_keys,
        constraint_violation_ends_episode=je.cv_ends_episode,
        constraint_violation_drops_object=je.cv_drops_object, device="cpu",
    )
    assert (je.task, je.dynamics, te.dynamics) == ("pick", "contacts", "contacts")
    _assert_tables_equal(je.table, te.table, settled_atol=ATOL)
    assert np.array_equal(_np(je.order), te.order.numpy())
    js, jo = je.reset_fn(jax.random.PRNGKey(0))
    ts, to = te.reset_fn()
    assert set(jo) == set(to) == set(te.observation_shapes) == set()  # the yaml declares no lab sensors
    for name in STATE_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(), _np(getattr(js, name)), atol=ATOL, err_msg=name)


# -- teacher-forced steps ----------------------------------------------------


def _reached(je, js):
    """(N, O) boxes the v6 robot contact can touch this step: within the
    robot's radius plus the box's half diagonal of the base, before or
    after its move."""
    pos = _np(js.pos)[:, None, :]
    obj = _np(js.obj_pos)
    half = _np(je.table.obj_half)[_np(js.ep_idx)]
    d = np.linalg.norm((obj - pos)[..., [0, 2]], axis=-1)
    return d < jre.AGENT_RADIUS + np.linalg.norm(half, axis=-1) + je.fwd + 0.05


def _compare(jout, tout, reached=None):
    """One step's outputs and next state. ``reached`` (contacts): the
    (N, O) boxes held to tests/test_torch_contacts.py's bounds, and the robot force to its
    relative bound."""
    (js, jo, jr, jd, ji), (ts, to, tr, td, ti) = jout, tout
    assert set(jo) == set(to) and set(ji) == set(ti)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), _np(jo[k]), atol=ATOL, err_msg=f"obs {k}")
    assert np.array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tr.numpy(), _np(jr), atol=ATOL)
    for k in ji:
        force = reached is not None and k in ("robot_force", "articulated_agent_force")
        np.testing.assert_allclose(ti[k].numpy(), _np(ji[k]), atol=FORCE_ATOL if force else ATOL,
                                   rtol=FORCE_RTOL if force else 0.0, err_msg=f"info {k}")
    for name in STATE_FIELDS:
        got, ref = getattr(ts, name).numpy(), _np(getattr(js, name))
        if name in DISCRETE_FIELDS:
            assert np.array_equal(got, ref.astype(got.dtype)), name
        elif name in REACHED_BOUND and reached is not None:
            gap = np.abs(got - ref).max(-1)
            allow = ATOL + (1e-5 * np.abs(ref).max(-1) if name == "obj_omega" else 0.0)
            assert (gap <= allow)[~reached].all(), name
            assert gap[reached].max(initial=0.0) <= REACHED_BOUND[name], name
        elif name == "accum_force" and reached is not None:
            np.testing.assert_allclose(got, ref, rtol=FORCE_RTOL, atol=FORCE_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_teacher_forced_steps(runs, name):
    je, te, rec = runs(name)
    contacts = te.dynamics == "contacts"
    for js, a, jout in rec:
        tout = te.step_fn(to_port_state(js), torch.as_tensor(a))
        _compare(jout, tout, reached=_reached(je, js) if contacts else None)
    held = np.stack([_np(r[0].held) for r in rec])
    if name.startswith("pick"):  # a grasp ends the episode
        assert (np.stack([_np(r[2][4]["pick_success"]) for r in rec]) > 0).any(), "the controller never grasped"
    if name.startswith("place"):
        # grasp, carry and release all happened
        assert ((held[:-1] >= 0) & (held[1:] < 0)).any(), "the controller never carried and released"
    if name.startswith(("open", "close")):
        q = np.stack([_np(r[0].art_q) for r in rec])
        assert np.abs(q - q[0]).max() > 0.05, "the controller never moved the articulated object"


@pytest.mark.parametrize("name,flag", [("place-continuous-contacts", "drops the object"),
                                       ("rearrange-arm_dynamics-gravity", "ends the episode")])
def test_grasp_constraint_violation(runs, name, flag):
    """A held box penetrating another box: the violation measure, its force,
    and the task flag (the held box dropped at the EE, or the episode
    ended), from a recorded state with object 0 held and object 1 moved
    onto the EE."""
    je, te, rec = runs(name)
    js = rec[0][0]
    ee = _np(je._ee_pos(js))
    obj = _np(js.obj_pos).copy()
    obj[:, 1] = ee - np.array([0.0, 0.05, 0.0], np.float32)
    js = dataclasses.replace(js, held=jnp.zeros((N,), jnp.int32), obj_pos=jnp.asarray(obj))
    grip_only = np.zeros_like(rec[0][1])
    grip_only[:, {"continuous": 2, "arm": je.n_joints}[te.control]] = 1.0  # keep holding, stand still
    jout = runs.jstep(name)(js, jnp.asarray(grip_only))
    tout = te.step_fn(to_port_state(js), torch.as_tensor(grip_only))
    _compare(jout, tout, reached=_reached(je, js) if te.dynamics == "contacts" else None)
    violated = _np(jout[4]["constraint_violation"]) > 0
    assert violated.any()
    if te.cv_drops_object:
        assert (_np(jout[0].held)[violated] < 0).all()
    if te.cv_ends_episode:
        assert _np(jout[3])[violated].all()


def test_free_running_kinematic_episode(runs):
    je, te, rec = runs("pick-discrete-kinematic")
    ts, _ = te.reset_fn()
    for js, a, (_, _, _, jd, ji) in rec:
        assert np.array_equal(ts.held.numpy(), _np(js.held))
        ts, _, _, td, ti = te.step_fn(ts, torch.as_tensor(a))
        assert np.array_equal(td.numpy(), _np(jd)) and np.array_equal(ti["success"].numpy(), _np(ji["success"]))
    assert (np.stack([_np(r[2][4]["pick_success"]) for r in rec]) > 0).any()


# -- geometry and render ----------------------------------------------------


@pytest.mark.parametrize("run,robot,control", [("nav_to_obj-arm-spot", "SpotRobot", "arm"),
                                               ("empty-arm_ee", "FetchRobot", "arm_ee"),
                                               ("close-discrete-kinematic", "FetchRobot", "discrete")])
def test_dynamic_geometry_matches(runs, run, robot, control):
    """Boxes posed by their quaternions, the articulated boxes, Spot's legs
    and the arm links, from the last recorded state of a run."""
    je, te = _envs(task="open", robot=robot, control=control)
    js = runs(run)[2][-1][0]
    ref = je._dynamic_geometry(js)
    got = te._dynamic_geometry(to_port_state(js))
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), _np(ref[k]), atol=ATOL, err_msg=k)


def _facing_state(je, js):
    """The state with each agent 1.2 m from its target, facing it."""
    tgt = _np(je._obj_world(js))[np.arange(N), _np(je._target_obj(js))]
    yaw = np.arange(N) * (np.pi / 2) + 0.3
    fwd = np.stack([-np.sin(yaw), 0 * yaw, -np.cos(yaw)], -1)
    pos = (tgt - 1.2 * fwd) * np.array([1, 0, 1]) + _np(js.pos) * np.array([0, 1, 0])
    return dataclasses.replace(js, pos=jnp.asarray(pos, jnp.float32), yaw=jnp.asarray(yaw, jnp.float32),
                               joints=js.joints + 0.3)


def _render_pair(je, te, js):
    """The head camera's frames of the JAX state in both packages, with each
    package's dynamic geometry (the JAX render on the CPU, as its env runs
    it there)."""
    cam = js.pos + jnp.array([0.0, 1.25, 0.0])
    pitch = jnp.full((N,), -0.45)
    ref = jrc.render_batch(je.pack, je._sid(js), cam, js.yaw, pitch, height=32, width=32,
                           dynamic=je._dynamic_geometry(js))
    ts = to_port_state(js)
    got = trc.render_batch(te.pack, te._sid(ts), torch.as_tensor(np.array(cam)), ts.yaw,
                           torch.full((N,), -0.45), height=32, width=32, dynamic=te._dynamic_geometry(ts))
    return {k: _np(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


def test_head_render_matches():
    """Spot's legs and the arm links render beside the boxes and the drawer:
    at the reset and with every agent facing its target."""
    je, te = _envs(with_visual=True, task="pick", control="arm", robot="SpotRobot")
    js, jo = je.reset_fn(jax.random.PRNGKey(0))
    ts, to = te.reset_fn()
    for k in jo:  # the env's own observations at the reset
        if k.startswith("robot_head"):
            assert to[k].shape == jo[k].shape and to[k].dtype == (torch.uint8 if k.endswith("rgb") else torch.float32)
        else:
            np.testing.assert_allclose(to[k].numpy(), _np(jo[k]), atol=ATOL, err_msg=k)
    dyn_pixels = 0.0
    for state in (js, _facing_state(je, js)):
        ref, got = _render_pair(je, te, state)
        hit_r, hit_g = ref["depth"][..., 0] < 1.0, got["depth"][..., 0] < 1.0
        assert (hit_r == hit_g).mean() >= 0.999
        assert (ref["semantic"] == got["semantic"]).mean() >= 0.999
        both = hit_r & hit_g
        assert np.abs(ref["depth"] - got["depth"])[..., 0][both].max() <= 1e-4
        assert (np.abs(ref["rgb"].astype(int) - got["rgb"].astype(int)) <= 1).all(-1).mean() >= 0.999
        dyn_pixels = max(dyn_pixels, float((got["semantic"] >= tre.OBJ_SEM_BASE - 1).mean()))
    assert dyn_pixels > 0.01, "the dynamic pass shows in no frame"
    # the env's frames are the render's
    fo = te._observations(to_port_state(js))
    np.testing.assert_array_equal(fo["robot_head_depth"].numpy(), _render_pair(je, te, js)[1]["depth"])


# -- navgrid ----------------------------------------------------------------


def test_snap_to_navigable_matches():
    scenes, _ = tgen.make_procedural_rearrange(num_scenes=2, episodes_per_scene=1, seed=3)
    jscenes, _ = jgen.make_procedural_rearrange(num_scenes=2, episodes_per_scene=1, seed=3)
    from habitat_tpu.sims.scene import pack_scenes as jax_pack

    tp, jp = pack_scenes(scenes), jax_pack(jscenes)
    rng = np.random.default_rng(0)
    n = 64
    sid = (np.arange(n) % 2).astype(np.int32)
    pos = np.c_[rng.uniform(0, 8, n), np.zeros(n), rng.uniform(0, 8, n)].astype(np.float32)
    pos[:8, 0] += 40.0  # far off the grid
    ref = jax.jit(jax.vmap(lambda s, p: jng.snap_to_navigable(jp, s, p)))(jnp.asarray(sid), jnp.asarray(pos))
    got = tng.snap_to_navigable(tp, torch.as_tensor(sid).long(), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-6)
    assert tng.is_navigable(tp, torch.as_tensor(sid).long(), got)[8:].all()


# -- the policy and the train step --------------------------------------------


def test_pick_train_step_on_cpu():
    _, te = _envs(with_visual=True, task="pick")
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(te.num_actions, backbone="resnet9", hidden_size=32, goal_keys=(),
                                         input_hw=(32, 32), state_keys=state_keys_of(te.observation_shapes),
                                         device="cpu")
    assert policy.net.state_keys == STATE_KEYS
    lrn = PPOLearner(te, policy, PPOConfig(num_steps=4, num_mini_batch=2, ppo_epoch=1),
                     measure_keys=("success", "pick_success"))
    rs = lrn.init(seed=0)
    rs, metrics = lrn.train_step(rs)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert "m_pick_success" in metrics and rs.obs["joint"].dtype == torch.float32


# -- what the slice leaves out ------------------------------------------------


@pytest.mark.parametrize("kw,exc,match", [
    (dict(task="reach", measure_keys=("rearrange_reach_success", "pick_success")), ValueError, "declared measures"),
    (dict(art_urdf="some.urdf"), FileNotFoundError, "some.urdf"),
    (dict(sensor_keys=("robot_head_depth",)), ValueError, "declared sensors"),
    (dict(sensor_keys=("no_such_sensor",)), ValueError, "declared sensors"),
    (dict(measure_keys=("pick_success", "no_such_measure")), ValueError, "declared measures"),
    (dict(task="place", measure_keys=("pick_success",)), ValueError, "declared measures"),
    (dict(task="unknown"), ValueError, "task"),
    (dict(dynamics="bullet"), ValueError, "dynamics"),
])
def test_left_out_branches_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        tgen.make_rearrange_env(**{**GEN, "num_envs": 2, "with_visual": False, "device": "cpu", **kw})


# the humanoid lane and the predicate sensors: name -> (action specs as
# (type, name), sensor keys)
HUMANOID_CASES = {
    "humanoid_joint_action": ((("HumanoidJointAction", "humanoid_joint_action"),), None),
    "agent_0_and_agent_1": ((("BaseVelAction", "agent_0_base_velocity"), ("BaseVelAction", "agent_1_base_velocity")),
                            None),
    "all_predicates": (None, ("all_predicates",)),
    "multi_agent_all_predicates": (None, ("multi_agent_all_predicates",)),
}


def _case_actions(te, js, t):
    """Step t's actions for a humanoid case: discrete without specs; with
    them, base velocities, and for HumanoidJointAction a root 0.3 m along +x
    at step 1 (all-zero, the pose kept, otherwise)."""
    if te.action_specs is None:
        return np.full((2,), (tre.A_FWD, tre.A_LEFT, tre.A_FWD)[t], np.int32)
    a = np.zeros((2, te.action_dim), np.float32)
    if te.action_names == ("humanoid_joint_action",):
        if t == 1:
            T = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
            T[:, 3, 0:3] = _np(js.pos) + np.array([0.3, 0.0, 0.0], np.float32)
            a[:, -16:] = T.reshape(2, 16)
            a[:, -32:-16] = np.eye(4, dtype=np.float32).reshape(16)
    else:
        a[:] = [[1.0, 0.5, 0.8, -0.3], [0.6, -0.2, 1.0, 0.4]][:2]
    return a


@pytest.mark.parametrize("case", list(HUMANOID_CASES))
def test_humanoid_lane_and_predicates_match_jax(case):
    """The humanoid lane (a spec acting for agent 1, or HumanoidJointAction
    on the robot) and the predicate sensors against the JAX env at N=2: the
    reset's observations and state, then three teacher-forced steps."""
    from habitat_tpu.config.omega import Config as JConfig
    from habitat_tpu.tasks.rearrange import task_actions as jta

    from habitat_torch.config.omega import Config as TConfig
    from habitat_torch.tasks.rearrange import task_actions as tta

    specs, sensor_keys = HUMANOID_CASES[case]
    kw = {**GEN, "num_envs": 2, "with_visual": False, "sensor_keys": sensor_keys}
    jkw, tkw = dict(kw), dict(kw)
    if specs:
        decl = {name: {"type": typ} for typ, name in specs}
        jkw["action_specs"] = jta.resolve_task_actions(JConfig(decl))
        tkw["action_specs"] = tta.resolve_task_actions(TConfig(decl))
    je, te = jgen.make_rearrange_env(**jkw), tgen.make_rearrange_env(device="cpu", **tkw)
    assert te.with_humanoid == je.with_humanoid == (case == "agent_0_and_agent_1")
    js, jo = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    ts, to = te.reset_fn()
    assert set(jo) == set(to) == set(te.observation_shapes)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), _np(jo[k]), atol=ATOL, err_msg=k)
    for name in STATE_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(), _np(getattr(js, name)), atol=ATOL, err_msg=name)
    if sensor_keys:
        assert _np(jo[sensor_keys[0]]).shape[1] == len(te._grounded_preds) > 0
    jstep = jax.jit(je.step_fn)
    states = [js]
    for t in range(3):
        a = _case_actions(te, js, t)
        jout = jstep(js, jnp.asarray(a))
        _compare(jout, te.step_fn(to_port_state(js), torch.as_tensor(a)))
        js = jout[0]
        states.append(js)
    if case == "humanoid_joint_action":  # an all-zero action keeps the root, the transform moves it
        assert np.array_equal(_np(states[1].pos), _np(states[0].pos))
        assert (np.linalg.norm(_np(states[2].pos - states[1].pos), axis=-1) > 0.1).all()
    if case == "agent_0_and_agent_1":  # the humanoid walked
        assert (np.linalg.norm(_np(js.human_pos) - _np(ts.human_pos), axis=-1) > 0.1).all()


def test_declared_keys_select_what_the_env_emits():
    _, te = _envs(task="pick", sensor_keys=("joint", "is_holding"), measure_keys=("pick_success", "pick_reward"))
    ts, obs = te.reset_fn()
    assert set(obs) == {"joint", "is_holding"} == set(te.observation_shapes)
    assert te.observation_shapes["joint"] == ((7,), torch.float32)
    _, obs, _, _, info = te.step_fn(ts, torch.full((N,), tre.A_FWD, dtype=torch.int32))
    assert set(obs) == {"joint", "is_holding"} and set(info) == {"pick_success", "pick_reward"}


def test_env_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.make_rearrange_env(**{**GEN, "num_envs": 2, "with_visual": False})
