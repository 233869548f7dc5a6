"""habitat_torch's hierarchical trainers (PDDL, the oracle skills, the fixed
and plan-table high-level policies, HRL-PPO, the config path) against
habitat_tpu's on the CPU, on the same procedural rearrangement episodes
(tests/test_hrl_pddl.py's composite env: N=4, task rearrange, one room, no
clutter, no camera, seed 3).

- PDDL: each predicate and AND/OR/NAND/NOR of two on every state of a
  planner rollout equal to JAX's; ``plan_for_goal`` = nav_to_obj, pick,
  nav_to_goal, place; ``build_plan_table`` equal to JAX's table, predicate
  order and action order.
- Rollouts step by step (one jit of the JAX controller step each): the
  fixed plan and the plan-table planner for 100 steps each, the port
  running free from its own reset: each step's skill index, action, done
  and success equal, reward and pose within 1e-5; on each recorded JAX state
  (converted to the port's), every skill's ``act`` and ``is_done`` and every
  predicate equal. ArtObjSkill likewise on an "open" env (prismatic), 60
  steps. ``NnSkill`` (deterministic, a blind policy whose weights come from
  the JAX init through ``convert.py``, its action head scaled so that no
  two logits tie) in place of the pick skill, 30 steps.
- One ``HrlPPOLearner.train_step`` (4 macro steps of 4 env steps, hidden
  32, episodes of 7 steps), the JAX draws replayed: the features, macro
  rewards, dones, values, success and done counts (recorded from JAX's
  step by debug callbacks) equal or within 1e-5; GAE within 1e-5; the loss
  terms within 1e-5 relative; every parameter within 1e-5 of JAX's (float32,
  weights carried by ``convert.high_level_params_from_jax``).
- The registry resolves updater ``hrl_ppo`` and trainer ``bc``.
- ``hrl_trainer_from_config`` on an HRL experiment YAML composed in
  ``tmp_path`` (pick_procgen.yaml + updater_name HRLPPO + defined_skills):
  the same skills, in order, and the same HrlPPOConfig as JAX's; the env
  in discrete control without the camera, as JAX's; ``train()`` takes 2
  updates (N=2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import habitat_tpu.core.construct as jcons
from habitat_tpu.baselines.hrl import hierarchical as jh
from habitat_tpu.baselines.hrl import hrl_ppo as jhp
from habitat_tpu.baselines.hrl import planner as jpl
from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
from habitat_tpu.models.rnn_state_encoder import initial_hidden_state
from habitat_tpu.tasks.rearrange import generator as jgen
from habitat_tpu.tasks.rearrange.multi_task import pddl as jpddl

import habitat_torch.core.construct as tcons
from habitat_torch.baselines.hrl import hierarchical as th
from habitat_torch.baselines.hrl import hrl_ppo as thp
from habitat_torch.baselines.hrl import planner as tpl
from habitat_torch.baselines.il.bc_trainer import BCLearner
from habitat_torch.config.default import get_config
from habitat_torch.core.registry import registry
from habitat_torch.models.convert import high_level_params_from_jax, params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy, state_keys_of
from habitat_torch.tasks.rearrange import generator as tgen
from habitat_torch.tasks.rearrange.multi_task import pddl as tpddl

from tests.test_torch_rearrange_env import to_port_state
from tests.torch_jax_native import _jax_native  # noqa: F401

ATOL = 1e-5
COMPOSITE = dict(num_envs=4, task="rearrange", with_visual=False, max_episode_steps=400, n_rooms_per_axis=1,
                 n_clutter=0, seed=3)
OPEN = dict(num_envs=4, task="open", with_visual=False, n_rooms_per_axis=1, n_clutter=0, seed=1)
PRED = ("holding", "not_holding", "at", "robot_at_obj", "robot_at_goal")
SKILLS = ("OracleNavSkill", "PickSkill", "NavToGoalSkill", "PlaceSkill", "ArtObjSkill", "WaitSkill")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _envs(**kw):
    return jgen.make_rearrange_env(**kw), tgen.make_rearrange_env(device="cpu", **kw)


@pytest.fixture(scope="module")
def composite():
    return _envs(**COMPOSITE)


def _skills(pkg, names):
    return [getattr(pkg, n)() for n in names]


def _exprs(pkg, env, state):
    """Every predicate, then AND/OR/NAND/NOR of not_holding and robot_at_obj."""
    P = pkg.DEFAULT_PREDICATES
    out = [P[n].is_true(env, state) for n in PRED]
    for t in ("AND", "OR", "NAND", "NOR"):
        out.append(pkg.LogicalExpr(getattr(pkg.LogicalExprType, t), [P["not_holding"], P["robot_at_obj"]])
                   .is_true(env, state))
    return out


def _probe(pkg, env, state, names):
    """(acts (K, N), dones (K, N), predicates and expressions (9, N)) of one
    state."""
    skills = _skills(pkg, names)
    stack = jnp.stack if pkg is jh else torch.stack
    return (stack([s.act(env, state) for s in skills]), stack([s.is_done(env, state) for s in skills]),
            stack(_exprs(jpddl if pkg is jh else tpddl, env, state)))


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _run(je, te, jpol, tpol, steps, names):
    """Both hierarchies from their own resets for ``steps`` steps, compared
    at every step (the port on the JAX state too); returns the per-step
    successes and skill indices."""
    @jax.jit
    def jstep(s, hl):
        probe = _probe(jh, je, s, names)
        act, hl = jpol.act(hl, s)
        s2, _, r, done, info = je.step_fn(s, act)
        return act, hl.skill_idx, s2, r, done, info["success"], probe

    js, _ = je.reset_fn(jax.random.PRNGKey(0))
    ts, _ = te.reset_fn()
    jhl, thl = jpol.init_state(), tpol.init_state()
    succ, idx = [], []
    for t in range(steps):
        act, jidx, js2, jr, jd, jsucc, jprobe = jstep(js, jhl)
        for what, got, ref in zip(("acts", "dones", "predicates"), _probe(th, te, to_port_state(js), names), jprobe):
            np.testing.assert_array_equal(got.numpy(), _np(ref).astype(got.numpy().dtype), err_msg=f"{what}@{t}")
        tact, thl = tpol.act(thl, ts)
        np.testing.assert_array_equal(tact.numpy(), _np(act), err_msg=f"action@{t}")
        np.testing.assert_array_equal(thl.skill_idx.numpy(), _np(jidx), err_msg=f"skill@{t}")
        ts, _, tr, td, tinfo = te.step_fn(ts, tact)
        np.testing.assert_array_equal(td.numpy(), _np(jd), err_msg=f"done@{t}")
        np.testing.assert_array_equal(tinfo["success"].numpy(), _np(jsucc), err_msg=f"success@{t}")
        np.testing.assert_allclose(tr.numpy(), _np(jr), atol=ATOL, err_msg=f"reward@{t}")
        np.testing.assert_allclose(ts.pos.numpy(), _np(js2.pos), atol=ATOL, err_msg=f"pos@{t}")
        thl = th.HLState(torch.where(td, 0, thl.skill_idx))
        jhl = jh.HLState(skill_idx=jnp.where(jd, 0, jidx))
        js = js2
        succ.append(_np(jsucc))
        idx.append(_np(jidx))
    return np.stack(succ), np.stack(idx)


def test_pddl_plan_and_table():
    dom_j, dom_t = jpddl.PddlDomain(), tpddl.PddlDomain()
    assert [a.name for a in dom_t.plan_for_goal()] == ["nav_to_obj", "pick", "nav_to_goal", "place"]
    assert [type(s).__name__ for s in dom_t.compile_plan_to_skills(dom_t.plan_for_goal())] == list(SKILLS[:4])
    table_j, names_j, acts_j = jpl.build_plan_table(dom_j)
    table_t, names_t, acts_t = tpl.build_plan_table(dom_t)
    assert names_t == names_j == list(PRED)
    assert [a.name for a in acts_t] == [a.name for a in acts_j]
    np.testing.assert_array_equal(table_t, table_j)
    bit = {n: 1 << i for i, n in enumerate(names_t)}
    a_idx = {a.name: i for i, a in enumerate(acts_t)}
    assert table_t[bit["not_holding"]] == a_idx["nav_to_obj"]
    assert table_t[bit["holding"] | bit["robot_at_goal"]] == a_idx["place"]
    assert table_t[bit["at"] | bit["not_holding"]] == -1


def test_fixed_plan_rollout_matches_jax(composite):
    je, te = composite
    jpol = jh.HierarchicalPolicy(je, jh.FixedHighLevelPolicy(je, jh.default_rearrange_plan()))
    tpol = th.HierarchicalPolicy(te, th.FixedHighLevelPolicy(te, th.default_rearrange_plan()))
    succ, idx = _run(je, te, jpol, tpol, 100, SKILLS[:4] + SKILLS[5:])
    assert len(np.unique(idx)) == 4  # every skill of the plan ran
    # the port's own rollout utility, from its reset
    ts, _ = te.reset_fn()
    _, _, rs, dones, s = tpol.rollout(ts, tpol.init_state(), 40)
    np.testing.assert_array_equal(s.numpy(), succ[:40])
    assert rs.shape == (40, 4)


def test_planner_rollout_matches_jax(composite):
    je, te = composite
    jpol = jh.HierarchicalPolicy(je, jpl.PlannerHighLevelPolicy(je))
    tpol = th.HierarchicalPolicy(te, tpl.PlannerHighLevelPolicy(te))
    succ, idx = _run(je, te, jpol, tpol, 100, SKILLS[:4] + SKILLS[5:])
    assert succ.max(0).sum() >= 1 and len(np.unique(idx)) >= 4


def test_art_obj_skill_matches_jax():
    je, te = _envs(**OPEN)
    jpol = jh.HierarchicalPolicy(je, jh.FixedHighLevelPolicy(je, [jh.ArtObjSkill()]))
    tpol = th.HierarchicalPolicy(te, th.FixedHighLevelPolicy(te, [th.ArtObjSkill()]))
    _run(je, te, jpol, tpol, 60, SKILLS[4:5])


def test_nn_skill_in_hierarchy(composite):
    """A deterministic neural pick skill (blind, hidden 32, state sensors)
    in the fixed plan."""
    je, te = composite
    js, jobs = je.reset_fn(jax.random.PRNGKey(0))
    jpol = jax_policy(je.action_space.n, has_visual=False, hidden_size=32, goal_keys=())
    n = je.num_envs
    params = jax.jit(jpol.init)(jax.random.PRNGKey(1), jobs, initial_hidden_state(n, 32), jnp.zeros(n, jnp.int32),
                                jnp.ones(n))
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    flat["action_head/Dense_0/kernel"] = flat["action_head/Dense_0/kernel"] * 300.0
    params = {"params": traverse_util.unflatten_dict(flat, sep="/")}
    tnet = make_pointnav_resnet_policy(te.num_actions, has_visual=False, hidden_size=32, goal_keys=(),
                                       state_keys=state_keys_of(te.observation_shapes), dtype=torch.float32,
                                       device="cpu")
    tnet.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    jplan = [jh.OracleNavSkill(), jh.NnSkill(jpol, params, done_fn=jh.PickSkill().is_done), jh.NavToGoalSkill(),
             jh.PlaceSkill()]
    tplan = [th.OracleNavSkill(), th.NnSkill(tnet, done_fn=th.PickSkill().is_done), th.NavToGoalSkill(),
             th.PlaceSkill()]
    j_nn = jax.jit(lambda s: jplan[1].act(je, s))
    jh_pol = jh.HierarchicalPolicy(je, jh.FixedHighLevelPolicy(je, jplan))
    th_pol = th.HierarchicalPolicy(te, th.FixedHighLevelPolicy(te, tplan))
    _run(je, te, jh_pol, th_pol, 30, SKILLS[:4])
    got = tplan[1].act(te, to_port_state(js))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_nn(js)))


# -- HRL-PPO --------------------------------------------------------------------


HRL_CFG = dict(num_macro_steps=4, hl_interval=4, hidden_size=32)


def test_hrl_ppo_train_step_matches_jax(monkeypatch):
    je, te = _envs(**{**COMPOSITE, "max_episode_steps": 7})
    jl = jhp.HrlPPOLearner(je, _skills(jh, SKILLS[:4]), jhp.HrlPPOConfig(**HRL_CFG))
    rec = {"draws": [], "gae": []}
    categorical, gae = jax.random.categorical, jhp.compute_gae

    def draw(key, logits, *a, **k):
        s = categorical(key, logits, *a, **k)
        jax.debug.callback(lambda x: rec["draws"].append(np.asarray(x)), s, ordered=True)
        return s

    def recorded_gae(*args):
        out = gae(*args)
        jax.debug.callback(lambda *xs: rec["gae"].append([np.asarray(x) for x in xs]), *args[:4], *out,
                           ordered=True)
        return out

    monkeypatch.setattr(jax.random, "categorical", draw)
    monkeypatch.setattr(jhp, "compute_gae", recorded_gae)
    ts = jax.jit(jl.init_fn)(jax.random.PRNGKey(0))
    ts2, jm = jax.jit(jl.train_step)(ts)
    jm = {k: float(v) for k, v in jm.items()}
    skills = torch.as_tensor(np.stack(rec["draws"]))
    (rews, values, dones, last_value, adv_j, ret_j), = rec["gae"]

    tl = thp.HrlPPOLearner(te, _skills(th, SKILLS[:4]), thp.HrlPPOConfig(**HRL_CFG))
    start = high_level_params_from_jax({k: np.asarray(v) for k, v in
                                        traverse_util.flatten_dict(ts.params["params"], sep="/").items()})
    tl.net.load_state_dict(start)
    st, batch = tl.collect_rollout(tl.init(), skills=skills)
    np.testing.assert_array_equal(batch["skills"].numpy(), skills.numpy())
    np.testing.assert_array_equal(batch["dones"].numpy(), dones)
    assert dones.any() and batch["done_count"].sum().item() == jm["done_count"]
    for name, got, ref in (("rewards", batch["rewards"], rews), ("values", batch["values"], values),
                           ("last_value", batch["last_value"], last_value)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=ATOL, atol=ATOL, err_msg=name)
    out = tl.update(batch)
    np.testing.assert_allclose(out["advantages"].numpy(), adv_j, atol=ATOL)
    np.testing.assert_allclose(out["returns"].numpy(), ret_j, atol=ATOL)
    tm = {k: v.item() for k, v in out.items() if k.startswith("losses/")}
    assert set(tm) == {"losses/hl_loss", "losses/hl_value_loss", "losses/hl_entropy"}
    for k, v in tm.items():
        assert abs(v - jm[k]) <= ATOL * max(1.0, abs(jm[k])), (k, v, jm[k])
    ref = high_level_params_from_jax({k: np.asarray(v) for k, v in
                                      traverse_util.flatten_dict(ts2.params["params"], sep="/").items()})
    for k, p in tl.net.state_dict().items():
        assert (p - start[k]).abs().max() > 0, k
        np.testing.assert_allclose(p.numpy(), ref[k].numpy(), atol=ATOL, err_msg=k)
    # the whole step through train_step with the same draws: the same metrics
    tl.net.load_state_dict(start)
    tl.optimizer = torch.optim.Adam(tl.net.parameters(), lr=tl.cfg.lr, eps=1e-5)
    _, m = tl.train_step(tl.init(), skills=skills)
    for k in ("reward", "success", "done_count"):
        assert m[k].item() == pytest.approx(jm[k], abs=ATOL), k


def test_registry_resolves_the_trainers():
    assert registry.get_updater("hrl_ppo") is thp.HrlPPOLearner
    assert registry.get_trainer("bc") is BCLearner


def test_hrl_trainer_from_config(tmp_path):
    """An HRL experiment (the reference's rl_hierarchical.yaml is not in this
    repository): pick_procgen.yaml with an HRL-PPO habitat_baselines block."""
    path = tmp_path / "rl_hierarchical.yaml"
    path.write_text(
        "# @package _global_\ndefaults:\n  - /benchmark/rearrange: pick_procgen\n"
        "  - /habitat_baselines: habitat_baselines_rl_config_base\n  - _self_\n"
        "habitat_baselines:\n  trainer_name: ppo\n  updater_name: HRLPPO\n  num_environments: 2\n"
        "  total_num_steps: 512\n  log_interval: 1\n"
        "  rl:\n    ppo:\n      hidden_size: 512\n      lr: 3.0e-4\n      ppo_epoch: 1\n      num_mini_batch: 2\n"
        "    policy:\n      main_agent:\n        hierarchical_policy:\n          defined_skills:\n"
        + "".join(f"            {s}: {{}}\n" for s in ("open_cab", "nav_to_obj", "pick", "nav_to_goal",
                                                        "place", "open_fridge", "wait"))
    )
    overrides = ["habitat.dataset.procedural.num_scenes=1", "habitat.dataset.procedural.episodes_per_scene=2",
                 "habitat.simulator.tpu.dynamics=kinematic"]
    jcfg, tcfg = jax_get_config(str(path), overrides), get_config(str(path), overrides)
    jtrainer = jcons.trainer_from_config(jcfg)
    trainer = tcons.trainer_from_config(tcfg, device="cpu")
    assert isinstance(trainer, thp.HrlTrainer)
    names = [type(s).__name__ for s in trainer.learner.skills]
    assert names == [type(s).__name__ for s in jtrainer.learner.skills]
    assert names == ["ArtObjSkill", "OracleNavSkill", "PickSkill", "NavToGoalSkill", "PlaceSkill", "WaitSkill"]
    assert dataclasses.asdict(trainer.learner.cfg) == jtrainer.learner.cfg._asdict()
    assert trainer.learner.cfg.hidden_size == 256 and trainer.learner.cfg.lr == 3.0e-4
    env, jenv = trainer.env, jtrainer.env
    assert env.control == jenv.control == "discrete" and env.action_specs is None
    assert not env.with_visual and not jenv.with_visual and env.num_envs == jenv.num_envs == 2
    metrics = trainer.train()
    assert trainer.num_updates_done == 2 and np.isfinite(metrics["losses/hl_loss"])
