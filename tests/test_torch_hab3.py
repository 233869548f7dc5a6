"""Habitat 3.0's two-agent rearrangement through the config path
(``core/construct.rearrange_env_from_config``) in habitat_torch against
habitat_tpu on the CPU.

The config is ``benchmark/rearrange/pick_procgen.yaml`` with two agents
(``main_agent`` a Spot, ``agent_1`` a kinematic humanoid), per-agent
prefixed actions (the robot's arm and base; the humanoid's oracle
navigation, PDDL apply, joint action and pick) and the multi-agent predicate
sensor declared: the pattern of tests/test_task_actions.py:138-166 (the
reference's hssd_spot_human.yaml is not in the repo). One scene of four
episodes, N=2. The parity cases run under gravity dynamics (the JAX
package's contacts step takes some 20 s to compile on the CPU; the
humanoid's hold frees the same boxes from both); the JAX rules run on the
port under the config's default, contacts.

- Both packages build the same env: action names and widths, the humanoid
  lane, robot, control and dynamics, the grounded predicates, the prefixed
  observation keys; the reset's observations and state within 1e-5.
- Teacher-forced steps through each agent-1 action (oracle navigation to an
  entity, PDDL nav, pick and place, a pick target, a joint action, which the
  JAX package's humanoid lane does not read) beside the robot's arm and base:
  each recorded JAX state, converted, through one port step, held by
  tests/test_torch_rearrange_env.py's comparison.
- The assertions of tests/test_task_actions.py::
  test_hab3_two_agent_declared_actions and ::test_humanoid_joint_action_sets_root
  on the port's env; its oracle navigation goes to entity 2 (on the way to
  entity 1 the greedy steering stalls at a wall in env 0 of this scene, in
  both packages).
- With the head camera, which only the port builds (the JAX package's
  prefixed space refuses the uint8 RGB, ROADMAP Queue 3): the robot's 128x128
  depth equals the JAX ``render_batch`` of the same state and dynamic
  geometry (hit/miss >= 99.9%, depth within 1e-4 on common hits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.config.default import get_config as jget
from habitat_tpu.core.construct import rearrange_env_from_config as jfrom
from habitat_tpu.ops import raycast as jrc

from habitat_torch.config.default import get_config as tget
from habitat_torch.core.construct import rearrange_env_from_config as tfrom
from tests.test_torch_rearrange_env import ATOL, STATE_FIELDS, _compare, to_port_state
from tests.torch_jax_native import _jax_native  # noqa: F401

N = 2
HAB3 = ["habitat.simulator.agents.main_agent.articulated_agent_type=SpotRobot",
        "habitat.simulator.agents.agent_1.articulated_agent_type=KinematicHumanoid",
        "habitat.task.actions.agent_0_arm_action.type=ArmAction",
        "habitat.task.actions.agent_0_base_velocity.type=BaseVelAction",
        "habitat.task.actions.agent_1_oracle_nav_action.type=OracleNavAction",
        "habitat.task.actions.agent_1_pddl_apply_action.type=PddlApplyAction",
        "habitat.task.actions.agent_1_humanoidjoint_action.type=HumanoidJointAction",
        "habitat.task.actions.agent_1_humanoid_pick_action.type=HumanoidPickAction",
        "habitat.task.lab_sensors.multi_agent_all_predicates.type=MultiAgentGlobalPredicatesSensor",
        "habitat.dataset.procedural.num_scenes=1", "habitat.dataset.procedural.episodes_per_scene=4"]
CONFIG = "benchmark/rearrange/pick_procgen.yaml"
GRAVITY = HAB3 + ["habitat.simulator.tpu.dynamics=gravity"]
STEPS = 10
ORACLE_ENTITY = 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def envs():
    """The two envs, the JAX reset and STEPS jitted JAX steps of
    ``_schedule``: [(state, action, outputs)]."""
    je = jfrom(jget(CONFIG, GRAVITY), num_envs=N, with_visual=False)
    te = tfrom(tget(CONFIG, GRAVITY), num_envs=N, with_visual=False, device="cpu")
    js, jo = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    jstep = jax.jit(je.step_fn)
    rec = []
    for t in range(STEPS):
        a = _schedule(te, js, t)
        out = jstep(js, jnp.asarray(a))
        rec.append((js, a, out))
        js = out[0]
    return je, te, (rec[0][0], jo), rec


def _offsets(env):
    offs, off = {}, 0
    for spec in env.action_specs:
        offs[spec.name] = off
        off += spec.dims(env)
    return offs, off


def test_config_builds_as_jax(envs):
    je, te, (js, jo), _ = envs
    assert te.action_names == je.action_names and te.action_names[0].startswith("agent_0_")
    offs, dims = _offsets(te)
    assert te.action_dim == dims == je.action_space.shape[0] and offs == _offsets(je)[0]
    assert te.with_humanoid and je.with_humanoid
    assert (te.rparams.name, te.control, te.dynamics) == (je.rparams.name, je.control, je.dynamics)
    assert [p.compact_str for p in te._grounded_preds] == [p.compact_str for p in je._grounded_preds]
    assert set(te.observation_shapes) == set(je.observation_space.spaces)
    for k, sp in je.observation_space.spaces.items():
        assert te.observation_shapes[k][0] == sp.shape, k
    ts, to = te.reset_fn()
    assert set(jo) == set(to) == set(te.observation_shapes)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), _np(jo[k]), atol=ATOL, err_msg=k)
    for name in STATE_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(), _np(getattr(js, name)), atol=ATOL, err_msg=name)


def _schedule(te, js, t):
    """Step t: the robot drives and moves its arm throughout; the humanoid
    oracle-navigates to entity 1, then PDDL nav(object 1), pick(object 1),
    nav(goal 1), place(at goal 2, away from where it stands), a pick target
    at object 2, a joint action."""
    offs, dims = _offsets(te)
    O = te.num_objects
    a = np.zeros((N, dims), np.float32)
    a[:, offs["agent_0_base_velocity"]:offs["agent_0_base_velocity"] + 2] = [0.6, 0.3]
    a[:, offs["agent_0_arm_action"]] = 0.5
    op, oh = offs["agent_1_pddl_apply_action"], offs["agent_1_humanoid_pick_action"]
    if t < 4:
        a[:, offs["agent_1_oracle_nav_action"]] = 1.0
    elif t < 8:
        a[:, op:op + 3] = ([1, 0, 0], [0, 1, 0], [O + 1, 0, 0], [0, 0, O + 2])[t - 4]
    elif t == 8:
        a[:, oh:oh + 3] = _np(js.obj_pos)[:, 2] + np.float32([0.0, 0.1, 0.0])
    else:
        a[:, offs["agent_1_humanoidjoint_action"]:offs["agent_1_humanoid_pick_action"]] = 0.25
    return a


def test_steps_through_each_agent_1_action(envs):
    je, te, _, rec = envs
    for js, a, jout in rec:
        _compare(jout, te.step_fn(to_port_state(js), torch.as_tensor(a)))
    human_held = np.stack([_np(jout[0].human_held) for _, _, jout in rec])
    assert (human_held[5] == 0).all() and (human_held[7] < 0).all()  # picked object 1, placed it


def _navigable_offset(env, st, d):
    """(N, 3) per env the first of +x, -x, +z, -z at ``d`` m whose point is
    navigable (the JAX rule's +x lands off the grid in env 1 of this
    scene)."""
    from habitat_torch.ops import navgrid as ng

    dirs = np.float32([[1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1]]) * d
    ok = np.stack([ng.is_navigable(env.pack, env._sid(st), st.pos + torch.as_tensor(v)).numpy() for v in dirs], 1)
    return dirs[ok.argmax(1)]


def test_jax_rules_on_the_port(envs):
    """tests/test_task_actions.py::test_hab3_two_agent_declared_actions'
    assertions on the port's env, then ::test_humanoid_joint_action_sets_root's
    on a single-agent config with only the joint action, its root set 0.5 m
    away on a navigable point."""
    te = tfrom(tget(CONFIG, HAB3), num_envs=N, with_visual=False, device="cpu")
    assert te.dynamics == "contacts" and any(n.startswith("agent_1_") for n in te.action_names)
    offs, dims = _offsets(te)
    st, obs = te.reset_fn()
    assert "agent_0_joint" in obs and "agent_1_localization_sensor" in obs
    assert "agent_0_other_agent_gps" in obs and "agent_1_other_agent_gps" in obs
    assert set(obs) == set(te.observation_shapes)
    hp0, rp0 = st.human_pos.clone(), st.pos.clone()
    a = torch.zeros((N, dims))
    a[:, offs["agent_1_oracle_nav_action"]] = float(ORACLE_ENTITY)
    for _ in range(20):
        st, obs, r, d, info = te.step_fn(st, a)
    assert torch.linalg.vector_norm(st.human_pos - hp0, dim=-1).min() > 0.3
    assert torch.allclose(st.pos, rp0)
    assert "did_agents_collide" in info
    op = offs["agent_1_pddl_apply_action"]
    a = torch.zeros((N, dims))
    a[:, op] = 1.0
    st, *_ = te.step_fn(st, a)
    a = torch.zeros((N, dims))
    a[:, op + 1] = 1.0
    st, obs, *_ = te.step_fn(st, a)
    assert (st.human_held == 0).all() and (obs["agent_1_is_holding"] > 0).all()
    rp1, hp1 = st.pos.clone(), st.human_pos.clone()
    a = torch.zeros((N, dims))
    a[:, offs["agent_0_base_velocity"]] = 1.0
    st, *_ = te.step_fn(st, a)
    assert torch.linalg.vector_norm(st.pos - rp1, dim=-1).min() > 0.05
    assert torch.equal(st.human_pos, hp1)

    single = tget(CONFIG, ["habitat.task.actions.humanoid_joint_action.type=HumanoidJointAction",
                           "habitat.task.actions.humanoid_joint_action.num_joints=17"])
    env = tfrom(single, num_envs=N, with_visual=False, device="cpu")
    assert env.action_dim == 4 * 17 + 32 and not env.with_humanoid
    st, _ = env.reset_fn()
    p0 = st.pos.clone()
    st, *_ = env.step_fn(st, torch.zeros((N, 100)))
    assert torch.allclose(st.pos, p0)
    T = np.tile(np.eye(4, dtype=np.float32)[None], (N, 1, 1))
    T[:, 3, 0:3] = p0.numpy() + _navigable_offset(env, st, 0.5)
    a = np.zeros((N, 100), np.float32)
    a[:, -16:] = T.reshape(N, 16)
    a[:, -32:-16] = np.eye(4, dtype=np.float32).reshape(16)
    st, *_ = env.step_fn(st, torch.as_tensor(a))
    assert (torch.linalg.vector_norm((st.pos - p0)[:, ::2], dim=-1) > 0.1).all()


def test_head_render_matches_jax_render(envs):
    je, _, _, rec = envs
    te = tfrom(tget(CONFIG, GRAVITY), num_envs=N, with_visual=True, device="cpu")
    assert te.observation_shapes["agent_0_robot_head_depth"][0] == (128, 128, 1)
    js = rec[5][0]  # the humanoid holds object 1
    depth = te._observations(to_port_state(js))["agent_0_robot_head_depth"].numpy()
    render = jax.jit(lambda s: jrc.render_batch(je.pack, je._sid(s), s.pos + jnp.array([0.0, 1.25, 0.0]), s.yaw,
                                                jnp.full((N,), -0.45), height=128, width=128,
                                                dynamic=je._dynamic_geometry(s))["depth"])
    d0 = _np(render(js))
    assert ((d0 < 1.0) == (depth < 1.0)).mean() >= 0.999
    both = (d0 < 1.0) & (depth < 1.0)
    assert np.abs(d0 - depth)[both].max() <= 1e-4 and both.mean() > 0.5
