"""habitat_torch's registry-resolved task actions (``tasks/rearrange/
task_actions.py`` and the env's ``action_specs`` path) against habitat_tpu's
on the CPU.

The same procedural generator feeds both packages (N=4 envs, one scene of
four episodes, kinematic, no head camera); each package resolves the same
YAML-style action configs through its own registry.

- Each spec's ``dims`` and ``contribute`` on one shared state (the JAX
  reset, two envs holding their target): ArmAction in joint and EE mode,
  with and without a grip, BaseVel (also with ``allow_back: False``),
  BaseVelNonCylinder, RearrangeStop, SelectBaseOrArm, Empty, OracleNav,
  OracleNavCoordinate, OracleNavWithBackingUp and PddlApply. Commands
  within 1e-6, flags equal.
- Teacher-forced episodes: 6 steps of the JAX env for four spec sets
  ([arm_action, base_velocity, rearrange_stop] with a suction grip,
  [arm_action with the EE controller, base_velocity], [oracle_nav_action,
  pddl_apply_action], and [select_base_or_arm, arm_action, base_velocity]
  for the base-or-arm gate); each recorded JAX state, converted to the port's,
  goes through one port step with the same action. State, observations,
  reward, done and info within 1e-5 (tests/test_torch_rearrange_env.py's
  comparison), discrete fields equal.
- The humanoid specs: HumanoidJointAction's and HumanoidPickAction's
  commands with the others above; teacher-forced steps of three spec sets
  (a root teleport on the robot, a pick target beside a base velocity, a
  base velocity acting for agent 1, which turns on the humanoid lane) at
  the same tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.config.omega import Config as JConfig
from habitat_tpu.tasks.rearrange import generator as jgen
from habitat_tpu.tasks.rearrange import task_actions as jta

from habitat_torch.config.omega import Config as TConfig
from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.tasks.rearrange import task_actions as tta
from tests.test_torch_rearrange_env import _compare, _np, to_port_state
from tests.torch_jax_native import _jax_native  # noqa: F401

N = 4
GEN = dict(num_envs=N, task="place", num_scenes=1, episodes_per_scene=4, seed=0, with_visual=False,
           dynamics="kinematic")
CMD_ATOL = 1e-6
STEPS = 6

# spec name -> (type, extra config)
SPECS = {
    "arm_joint": ("ArmAction", dict(arm_controller="ArmRelPosAction", grip_controller=None)),
    "arm_joint_grip": ("ArmAction", dict(arm_controller="ArmRelPosAction", grip_controller="SuctionGraspAction")),
    "arm_ee": ("ArmAction", dict(arm_controller="ArmEEAction", grip_controller=None)),
    "arm_ee_grip": ("ArmAction", dict(arm_controller="ArmEEAction", grip_controller="MagicGraspAction")),
    "base_velocity": ("BaseVelAction", {}),
    "base_velocity_no_back": ("BaseVelAction", dict(allow_back=False)),
    "base_velocity_non_cylinder": ("BaseVelNonCylinderAction", {}),
    "rearrange_stop": ("RearrangeStopAction", {}),
    "select_base_or_arm": ("SelectBaseOrArmAction", {}),
    "empty": ("EmptyAction", {}),
    "oracle_nav_action": ("OracleNavAction", dict(dist_thresh=0.5, turn_thresh=0.2)),
    "oracle_nav_coordinate": ("OracleNavCoordinateAction", {}),
    "oracle_nav_with_backing_up_action": ("OracleNavWithBackingUpAction", {}),
    "pddl_apply_action": ("PddlApplyAction", {}),
    "humanoid_joint_action": ("HumanoidJointAction", dict(num_joints=17)),
    "humanoid_pick_obj_id_action": ("HumanoidPickAction", {}),
}

# teacher-forced spec sets: name -> (spec names, the control construct.py derives)
EPISODES = {
    "arm-base-stop": (("arm_joint_grip", "base_velocity", "rearrange_stop"), "arm"),
    "arm_ee-base": (("arm_ee", "base_velocity"), "arm_ee"),
    "oracle_nav-pddl_apply": (("oracle_nav_action", "pddl_apply_action"), None),
    "select-arm-base": (("select_base_or_arm", "arm_joint", "base_velocity"), "arm"),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _specs(names):
    """The same declared actions resolved by each package's registry."""
    decl = {n: dict(type=SPECS[n][0], **SPECS[n][1]) for n in names}
    return jta.resolve_task_actions(JConfig(decl)), tta.resolve_task_actions(TConfig(decl))


@pytest.fixture(scope="module")
def shared():
    """One JAX/port env pair (fixed-menu arm layout, the specs' host) and
    the shared state: the reset with envs 0 and 1 holding their target, and
    the boxes moved off the navgrid's cell centres, where the generator puts
    them: pddl nav(e) faces the entity from the cell centre nearest it, a
    heading atan2 leaves undefined (to rounding) when the two coincide."""
    je = jgen.make_rearrange_env(control="arm", **GEN)
    te = tgen.make_rearrange_env(control="arm", device="cpu", **GEN)
    js, _ = je.reset_fn(jax.random.PRNGKey(0))
    tgt = _np(je.table.pick_target)[_np(js.ep_idx)]
    held = np.where(np.arange(N) < 2, tgt, -1)
    js = dataclasses.replace(js, held=jnp.asarray(held, js.held.dtype), ever_held=jnp.asarray(held >= 0),
                             obj_pos=js.obj_pos + jnp.asarray([0.03, 0.0, -0.04], jnp.float32))
    return je, te, js, tgt


def _inputs(name, je, js, tgt, dims):
    """(N, dims) slice values that reach each branch of the spec."""
    x = np.random.default_rng(len(name)).uniform(-1.0, 1.0, (N, dims)).astype(np.float32)
    O = je.num_objects
    if name.startswith("oracle_nav_action") or name.startswith("oracle_nav_with"):
        x[:, 0] = [tgt[0] + 1, O + tgt[1] + 1, 0, 2 * O + 1]  # an object, a goal, a no-op, out of range
    elif name == "oracle_nav_coordinate":
        ents = np.concatenate([_np(je._obj_world(js)), _np(je.table.target_pos)[_np(js.ep_idx)]], 1)
        pos = _np(js.pos)
        x[:] = [ents[0, tgt[0]], pos[1] + [0.1, 0.0, 0.0], [0.0, 0.0, 0.0], ents[3, O]]  # far, at goal, no-op
    elif name == "pddl_apply_action":
        x[:] = [[tgt[0] + 1, 0, 0], [0, tgt[1] + 1, 0], [0, 0, O + tgt[2] + 1], [0.4, 1.6, 2 * O + 1]]
    elif name == "humanoid_joint_action":
        x[2:, -32:] = 0.0  # an all-zero transform keeps the pose
    elif name == "humanoid_pick_obj_id_action":
        x[:] = np.concatenate([_np(je._obj_world(js))[np.arange(N), tgt], np.zeros((N, 3), np.float32)])[
            [0, 1, 4, 5]]  # two targets at an object, two no-ops
    return x


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_dims_and_contribute(shared, name):
    je, te, js, tgt = shared
    (jspec,), (tspec,) = _specs([name])
    assert type(jspec).__name__ == type(tspec).__name__ and jspec.name == tspec.name == name
    dims = jspec.dims(je)
    assert tspec.dims(te) == dims
    x = _inputs(name, je, js, tgt, dims)
    jcmd, tcmd = {}, {}
    jspec.contribute(je, js, jnp.asarray(x), jcmd)
    tspec.contribute(te, to_port_state(js), torch.as_tensor(x), tcmd)
    assert set(jcmd) == set(tcmd)
    for k in jcmd:
        # a command is a tensor or a tuple of them
        refs, gots = (jcmd[k], tcmd[k]) if isinstance(jcmd[k], tuple) else ((jcmd[k],), (tcmd[k],))
        assert len(refs) == len(gots), k
        for ref, got in zip(refs, gots):
            ref, got = _np(ref), got.numpy()
            assert got.shape == ref.shape, k
            if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
                assert np.array_equal(got, ref.astype(got.dtype)), k
            else:
                np.testing.assert_allclose(got, ref, atol=CMD_ATOL, err_msg=k)
    if name.startswith("oracle_nav"):
        # the steering moved or turned some env and left the no-op still
        assert np.abs(_np(jcmd["ang"])).max() > 0 and _np(jcmd["lin"])[2] == 0 and _np(jcmd["ang"])[2] == 0


def _episode_actions(name, je, js, t, dims):
    """Step t's flat actions for a spec set."""
    rng = np.random.default_rng(100 + t)
    x = rng.uniform(-1.0, 1.0, (N, dims)).astype(np.float32)
    if name == "arm-base-stop":
        x[:, -1] = np.where(rng.uniform(size=N) < 0.2, 1.0, -1.0)  # stop now and then
    if name == "oracle_nav-pddl_apply":
        O = je.num_objects
        tgt = _np(je.table.pick_target)[_np(js.ep_idx)]
        x[:] = 0.0
        x[:2, 0] = [tgt[0] + 1, O + tgt[1] + 1]  # oracle nav to an object and to a goal
        # the PDDL plan (nav to an object, pick it, place it at its goal) on
        # env 2's target and on another object of env 3
        for env, o in ((2, tgt[2]), (3, 0 if tgt[3] else 1)):
            x[env, 1:] = ([o + 1, 0, 0], [0, o + 1, 0], [0, 0, O + o + 1], [0, 0, 0])[min(t, 3)]
        if t == 4:
            x[0, 2] = tgt[0] + 1  # env 0 holds its target: a second pick is refused
    return x


@pytest.mark.parametrize("name", list(EPISODES))
def test_teacher_forced_episode(shared, name):
    je0, _, js0, _ = shared
    names, control = EPISODES[name]
    jspecs, tspecs = _specs(names)
    je = jgen.make_rearrange_env(control=control, action_specs=jspecs, **GEN)
    te = tgen.make_rearrange_env(control=control, action_specs=tspecs, device="cpu", **GEN)
    assert je.action_names == te.action_names == names
    dims = te.action_dim
    assert je.action_space.shape == (dims,)
    jstep = jax.jit(je.step_fn)
    js = js0
    held = []
    for t in range(STEPS):
        a = _episode_actions(name, je, js, t, dims)
        jout = jstep(js, jnp.asarray(a))
        _compare(jout, te.step_fn(to_port_state(js), torch.as_tensor(a)))
        held.append(_np(js.held))
        js = jout[0]
    held = np.stack(held)
    if name == "arm-base-stop":  # a suction release
        assert ((held[:-1] >= 0) & (held[1:] < 0)).any()
    if name == "oracle_nav-pddl_apply":  # envs 2 and 3 picked through pddl pick, then placed
        assert (held[2, 2:] >= 0).all() and (held[3, 2:] < 0).all() and (held[:, 0] >= 0).all()


HUMANOID_SETS = {
    "joint": (("HumanoidJointAction", "humanoid_joint_action"),),
    "pick": (("BaseVelAction", "base_velocity"), ("HumanoidPickAction", "humanoid_pick_obj_id_action")),
    "agent_1": (("BaseVelAction", "agent_1_base_velocity"),),
}


def _humanoid_actions(name, je, js, t, dims):
    """Step t's flat actions for a humanoid spec set: a root 0.4 m along +x
    at step 1 (the pose kept otherwise); a pick target at each env's target
    object while the base turns; the humanoid driven forward and turning."""
    a = np.zeros((N, dims), np.float32)
    if name == "joint" and t == 1:
        T = np.tile(np.eye(4, dtype=np.float32)[None], (N, 1, 1))
        T[:, 3, 0:3] = _np(js.pos) + np.array([0.4, 0.0, 0.0], np.float32)
        a[:, -16:] = T.reshape(N, 16)
        a[:, -32:-16] = np.eye(4, dtype=np.float32).reshape(16)
    elif name == "pick":
        tgt = _np(je.table.pick_target)[_np(js.ep_idx)]
        a[:, 1] = 0.5
        a[:, 2:] = _np(je._obj_world(js))[np.arange(N), tgt]
    elif name == "agent_1":
        a[:] = [[1.0, 0.3], [1.0, -0.3], [0.5, 0.0], [0.0, 1.0]]
    return a


@pytest.mark.parametrize("specs", list(HUMANOID_SETS))
def test_humanoid_specs_raise(shared, specs):
    """The humanoid specs step as the JAX package's: each recorded JAX
    state, converted, through one port step with the same action."""
    from habitat_tpu.config.omega import Config as JC

    decl = {name: {"type": typ} for typ, name in HUMANOID_SETS[specs]}
    jspecs, tspecs = jta.resolve_task_actions(JC(decl)), tta.resolve_task_actions(TConfig(decl))
    je = jgen.make_rearrange_env(action_specs=jspecs, **GEN)
    te = tgen.make_rearrange_env(action_specs=tspecs, device="cpu", **GEN)
    assert te.with_humanoid == je.with_humanoid == (specs == "agent_1")
    dims = te.action_dim
    js, _ = je.reset_fn(jax.random.PRNGKey(0))
    if specs == "pick":  # each robot 1 m from its target object, within reach
        tgt = _np(je.table.pick_target)[_np(js.ep_idx)]
        near = _np(je._obj_world(js))[np.arange(N), tgt] + np.array([1.0, 0.0, 0.0], np.float32)
        js = dataclasses.replace(js, pos=js.pos.at[:, jnp.array([0, 2])].set(jnp.asarray(near[:, [0, 2]])))
    jstep = jax.jit(je.step_fn)
    first = js
    for t in range(3):
        a = _humanoid_actions(specs, je, js, t, dims)
        jout = jstep(js, jnp.asarray(a))
        _compare(jout, te.step_fn(to_port_state(js), torch.as_tensor(a)))
        js = jout[0]
    if specs == "joint":
        assert (np.linalg.norm(_np(js.pos - first.pos), axis=-1) > 0.1).all()
    elif specs == "pick":
        assert (_np(js.held) >= 0).all()
    else:
        assert (np.linalg.norm(_np(js.human_pos - first.human_pos), axis=-1) > 0.1).any()
