"""habitat_torch's YAML PDDL domains and problems
(``tasks/rearrange/multi_task/pddl_yaml.py``) against habitat_tpu's on the
CPU.

- The port's own copies of the domain files load to the JAX package's
  domains: types, constants, articulated slots, predicate schemas (their
  factory by the ``_target_``'s last component, arguments and keyword
  arguments) and action schemas; ``domain_path`` keeps the JAX env's lookup
  (``<name>.yaml``, else ``fp.yaml``, or a path).
- The grounded universe of both domains over the rearrangement env's
  entities (``fp`` on the two-agent env with ``robot_1``; ``tpu_rearrange``
  with its drawer constants on a single-agent env declaring
  ``all_predicates``): the same compact strings in the same order, and the
  truth of every grounded predicate equal to JAX's on the same states, the
  JAX state converted: the reset, three teacher-forced steps, and crafted
  states (each agent holding, objects moved onto goals and receptacles, the
  robot and the humanoid moved onto entities, drawers opened). The env's
  ``all_predicates`` vector equals the per-predicate truths.
- Every ``set_state`` of those groundings applied to the same state: the
  resulting fields within 1e-6.
- A problem file (objects, init, goal with AND / OR / NAND / NOR and a
  FORALL, stage goals, solution): ``apply_init``, the goal and stage goals,
  the bound actions' pre- and postconditions equal on the crafted states;
  ``solution_to_skills`` names the same skills.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from habitat_tpu.config.omega import Config as JConfig
from habitat_tpu.tasks.rearrange import generator as jgen
from habitat_tpu.tasks.rearrange import task_actions as jta
from habitat_tpu.tasks.rearrange.multi_task import pddl_yaml as jpy

from habitat_torch.config.omega import Config as TConfig
from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.tasks.rearrange import task_actions as tta
from habitat_torch.tasks.rearrange.multi_task import pddl_yaml as tpy
from tests.test_torch_rearrange_env import STATE_FIELDS, to_port_state
from tests.torch_jax_native import _jax_native  # noqa: F401

N = 4
GEN = dict(num_envs=N, num_scenes=1, episodes_per_scene=4, seed=0, with_visual=False)
DOMAINS = ("fp", "tpu_rearrange")
PROBLEM = {
    "objects": [{"name": "any_targets|0", "expr_type": "movable_entity_type"},
                {"name": "any_targets|1", "expr_type": "movable_entity_type"},
                {"name": "TARGET_any_targets|0", "expr_type": "goal_entity_type"},
                {"name": "robot_0", "expr_type": "robot_entity_type"}],
    "init": ["not_holding(robot_0)", "object_at(any_targets|1, TARGET_any_targets|0)"],
    "goal": {"expr_type": "AND", "sub_exprs": [
        "object_at(any_targets|0, TARGET_any_targets|0)",
        {"expr_type": "OR", "sub_exprs": ["not_holding(robot_0)", "holding(any_targets|1, robot_0)"]},
        {"quantifier": "FORALL", "inputs": [{"name": "o", "expr_type": "movable_entity_type"}],
         "expr_type": "NAND", "sub_exprs": ["holding(o, robot_0)", "robot_at(o, robot_0)"]}]},
    "stage_goals": {"picked": "holding(any_targets|0, robot_0)",
                    "clear": {"expr_type": "NOR", "sub_exprs": ["holding(any_targets|0, robot_0)",
                                                                "holding(any_targets|1, robot_0)"]}},
    "solution": ["nav(any_targets|0, robot_0)", "pick(any_targets|0, robot_0)",
                 "nav(TARGET_any_targets|0, robot_0)", "place(any_targets|0, TARGET_any_targets|0, robot_0)"],
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", DOMAINS)
def test_domain_loads_as_jax(name):
    path = tpy.domain_path(name)
    assert path.endswith(f"domain_configs/{name}.yaml")
    jd = jpy.YamlPddlDomain.from_yaml(path.replace("habitat_torch", "habitat_tpu"))
    td = tpy.YamlPddlDomain.from_yaml(path)
    assert td.types.parents == jd.types.parents
    assert [(e.name, e.expr_type) for e in td.constants.values()] == [(e.name, e.expr_type)
                                                                       for e in jd.constants.values()]
    assert td.art_slots == jd.art_slots
    assert list(td.predicates) == list(jd.predicates)
    for k, ps in td.predicates.items():
        pj = jd.predicates[k]
        assert (ps.param_types, ps.kwargs, ps.set_kwargs) == (pj.param_types, pj.kwargs, pj.set_kwargs), k
        assert ps.factory.__name__ == pj.factory.__name__, k
    assert list(td.actions) == list(jd.actions)
    for k, a in td.actions.items():
        b = jd.actions[k]
        assert ([(p.name, p.expr_type) for p in a.params], a.precondition, a.postcondition) == (
            [(p.name, p.expr_type) for p in b.params], b.precondition, b.postcondition), k
    assert tpy.domain_path("no_such_domain").endswith("domain_configs/fp.yaml")
    assert tpy.domain_path("/some/where/d.yaml") == "/some/where/d.yaml"


def _envs(domain):
    """The JAX and port envs whose universe the domain grounds: fp on the
    two-agent env, tpu_rearrange on a single-agent env declaring the
    predicate sensor."""
    if domain == "fp":
        decl = {"agent_0_base_velocity": {"type": "BaseVelAction"},
                "agent_1_base_velocity": {"type": "BaseVelAction"}}
        kw = dict(task="rearrange")
        jkw = dict(kw, action_specs=jta.resolve_task_actions(JConfig(decl)))
        tkw = dict(kw, action_specs=tta.resolve_task_actions(TConfig(decl)))
    else:
        jkw = tkw = dict(task="open", art_joint="prismatic", sensor_keys=("all_predicates",),
                         pddl_domain="tpu_rearrange")
    return jgen.make_rearrange_env(**GEN, **jkw), tgen.make_rearrange_env(device="cpu", **GEN, **tkw)


def _states(je):
    """The reset, three teacher-forced steps, and crafted states."""
    js, _ = jax.jit(je.reset_fn)(jax.random.PRNGKey(0))
    step = jax.jit(je.step_fn)
    out = [js]
    dims = je.action_space.shape[0] if je.action_specs else None
    for t in range(3):
        a = np.tile(np.float32([1.0, 0.4, 0.8, -0.5]), (N, 1)) if dims else np.full((N,), (1, 2, 1)[t], np.int32)
        js = step(js, jnp.asarray(a))[0]
        out.append(js)
    js = out[0]
    tgt = np.argsort(~_np(je.table.target_mask)[_np(js.ep_idx)], axis=1, kind="stable")  # (N, O)
    goals = _np(je.table.target_pos)[_np(js.ep_idx)]
    objs = _np(js.obj_pos).copy()
    objs[np.arange(N), tgt[:, 0]] = goals[np.arange(N), tgt[:, 0]]  # target 0 at its goal
    arts = _np(je.table.art_pos)[_np(js.ep_idx)]
    objs[np.arange(N), tgt[:, 1]] = arts[:, 0] + np.float32([0.3, 0.0, 0.2])  # target 1 by receptacle 0
    pos = _np(js.pos).copy()
    pos[:2, ::2] = objs[np.arange(2), tgt[:2, 1]][:, ::2] + 0.5  # robots next to target 1
    human = _np(js.human_pos).copy()
    human[2:, ::2] = goals[np.arange(2, 4), tgt[2:, 0]][:, ::2] + 0.4  # humanoids next to a goal
    art_q = _np(js.art_q).copy()
    art_q[1::2] = 0.45  # drawers opened
    crafted = dataclasses.replace(
        js, obj_pos=jnp.asarray(objs), pos=jnp.asarray(pos), human_pos=jnp.asarray(human),
        art_q=jnp.asarray(art_q), held=jnp.asarray(np.where(np.arange(N) % 2 == 0, tgt[:, 2], -1), js.held.dtype),
        human_held=jnp.asarray(np.where(np.arange(N) == 3, tgt[:, 1], -1), js.human_held.dtype))
    return out + [crafted]


@pytest.fixture(scope="module", params=DOMAINS)
def grounded(request):
    je, te = _envs(request.param)
    return request.param, je, te, _states(je)


def test_grounded_universe_and_truth_match_jax(grounded):
    domain, je, te, states = grounded
    jp, tp = je._grounded_preds, te._grounded_preds
    assert [p.compact_str for p in tp] == [p.compact_str for p in jp]
    assert len(tp) > 20 and any("robot_1" in p.compact_str for p in tp) == (domain == "fp")
    truths = []
    for js in states:
        ts = to_port_state(js)
        ref = np.stack([_np(p.is_true(je, js)) for p in jp], -1)
        got = np.stack([p.is_true(te, ts).numpy() for p in tp], -1)
        assert np.array_equal(got, ref)
        np.testing.assert_array_equal(te._predicate_vector(ts).numpy(), got.astype(np.float32))
        truths.append(got)
    truths = np.concatenate(truths)
    assert truths.any(0).sum() >= 5 and (~truths).any(0).all()  # the states reach true and false lanes


def test_set_state_matches_jax(grounded):
    _, je, te, states = grounded
    js = states[-1]
    n_set = 0
    for pj, pt in zip(je._grounded_preds, te._grounded_preds):
        if pt.set_state_fn is None:
            assert pj.set_state_fn is None
            continue
        n_set += 1
        ref, got = pj.set_state(je, js), pt.set_state(te, to_port_state(js))
        for name in STATE_FIELDS:
            np.testing.assert_allclose(getattr(got, name).numpy(), _np(getattr(ref, name)).astype(np.float64),
                                       atol=1e-6, err_msg=f"{pt.compact_str} {name}")
    assert n_set > 10


def test_problem_matches_jax(grounded, tmp_path):
    domain, je, te, states = grounded
    path = tmp_path / "problem.yaml"
    path.write_text(yaml.safe_dump(PROBLEM))
    jdom = jpy.YamlPddlDomain.from_yaml(tpy.domain_path(domain).replace("habitat_torch", "habitat_tpu"))
    tdom = tpy.YamlPddlDomain.from_yaml(tpy.domain_path(domain))
    jprob, tprob = jpy.PddlProblem.from_yaml(jdom, str(path)), tpy.PddlProblem.from_yaml(tdom, str(path))
    assert [a.name for a in tprob.solution] == [a.name for a in jprob.solution]
    assert [type(s).__name__ for s in tprob.solution_to_skills()] == [
        type(s).__name__ for s in jprob.solution_to_skills()] == ["OracleNavSkill", "PickSkill", "NavToGoalSkill",
                                                                  "PlaceSkill"]
    for js in states:
        ts = to_port_state(js)
        ji, ti = jprob.apply_init(je, js), tprob.apply_init(te, ts)
        for name in STATE_FIELDS:
            np.testing.assert_allclose(getattr(ti, name).numpy(), _np(getattr(ji, name)).astype(np.float64),
                                       atol=1e-6, err_msg=name)
        for jx, tx in [(jprob.goal, tprob.goal)] + [(jprob.stage_goals[k], tprob.stage_goals[k])
                                                    for k in ("picked", "clear")]:
            assert np.array_equal(tx.is_true(te, ts).numpy(), _np(jx.is_true(je, js)))
        np.testing.assert_array_equal(tprob.goal_satisfied(te, ti).numpy(), _np(jprob.goal_satisfied(je, ji)))
        for ja, ta in zip(jprob.solution, tprob.solution):
            assert np.array_equal(ta.is_applicable(te, ts).numpy(), _np(ja.is_applicable(je, js))), ta.name
            assert np.array_equal(ta.is_satisfied(te, ts).numpy(), _np(ja.is_satisfied(je, js))), ta.name
