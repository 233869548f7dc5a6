"""habitat_torch's geodesic follower and behavior cloning against
habitat_tpu's on the CPU, on the same numpy-seeded scenes and episodes.

- ``ops/navgrid.greedy_follower_step`` on 512 random navigable poses of the
  bench scenes (4 procedural scenes x 16 episodes), a third of them on cells
  next to a wall and a sixth within ``goal_radius`` of the goal, against
  the JAX function vmapped under one jit: every action equal.
- ``ShortestPathFollower`` driven against the JAX ``TpuSim``'s state (the
  port's sim given as the documented attributes): every action equal to
  the JAX follower's, and the walk ends with stop within ``goal_radius``.
- The teacher-driven rollout (N=4, 32x32 depth + RGB + pointgoal, T=8,
  episodes of 6 steps): teachers, dones and episode ids equal at every
  step; poses and pointgoal within 1e-5, depth within 1e-4, RGB and
  semantics equal on >= 99.9% of pixels (tests/test_torch_raycast.py's
  render bounds).
- One ``train_step`` from the same weights (converted by ``convert.py``)
  and env state, in float32 on both sides: the blind net (hidden 64) and
  resnet9 at 32x32 (the JAX encoder in float32 and its max pool crediting
  every tie, as tests/test_torch_ppo.py patches them, test only). The loss
  and ``teacher_match`` within 1e-4 of max(1, |x|), ``teacher_success_rate``
  equal; parameters by tests/test_torch_ppo.py's update rule at BC's lr
  (each element within 2 lr of JAX's after the one Adam step, >= 99% within
  lr/10, every trained tensor moved, the LSTM's ``bias_ih`` not).
- tests/test_il.py's learning gate on the port, from the JAX test's initial
  parameters (committed as ``habitat_torch/weights/bc_gate_init.pt``, held
  bit for bit to their conversion): the blind clone's ``teacher_match`` over
  its last 5 of 30 updates exceeds its first 5 by more than 0.15 and ends
  above 0.5. (The JAX test clears the rise by 0.004 from these parameters;
  from torch's default initialisation the port's clone rises by only
  0.06-0.09.)
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from habitat_tpu.baselines.il.bc_trainer import BCConfig as JaxBCConfig
from habitat_tpu.baselines.il.bc_trainer import BCLearner as JaxBCLearner
from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
from habitat_tpu.ops import navgrid as jng
from habitat_tpu.sims.tpu_sim import TpuSim
from habitat_tpu.tasks.shortest_path_follower import ShortestPathFollower as JaxFollower

from habitat_torch.baselines.il.bc_trainer import BCConfig, BCLearner
from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.core.registry import registry
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.models.convert import load_policy_file, params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy
from habitat_torch.ops import navgrid as tng
from habitat_torch.sims.scene import geodesic_field, pack_scenes
from habitat_torch.tasks.shortest_path_follower import ShortestPathFollower

from tests.test_torch_ppo import FROZEN, _flat, _jax_as
from tests.torch_jax_native import _jax_native  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
TURN = float(np.deg2rad(10.0))
FOLLOW = dict(goal_radius=0.2, forward_step=0.25, turn_angle=TURN)
ATOL = 1e-4
N, T, HW = 4, 8, 32
SENSORS = (("HabitatSimDepthSensor", {"height": HW, "width": HW}),
           ("HabitatSimRGBSensor", {"height": HW, "width": HW}),
           ("PointGoalWithGPSCompassSensor", None))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



# -- the follower --------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_envs():
    kw = dict(num_scenes=4, episodes_per_scene=16, seed=0)
    sj, ej, fj = jax_pointnav(**kw)
    st, et, ft = make_procedural_pointnav(**kw)
    return (jax_make_nav_env(sj, ej, 8, precomputed_fields=fj), make_nav_env(st, et, 8, precomputed_fields=ft, device="cpu"),
            sj[0], st[0])


def _poses(te, m, seed):
    """(episode, scene, pos, yaw) of m poses on navigable cells: a third on
    cells with a blocked 4-neighbour, a sixth within 0.15 m of the goal,
    the rest anywhere navigable; offsets uniform within the cell."""
    rng = np.random.default_rng(seed)
    occ, lo, res = te.pack.nav_occ.numpy(), te.pack.nav_lo.numpy(), te.pack.nav_res
    ep = rng.integers(0, te.table.num_episodes, m)
    sid = te.table.scene_idx[ep].numpy().astype(np.int64)
    pos = np.zeros((m, 3), np.float32)
    for i in range(m):
        o = occ[sid[i]]
        cells = np.argwhere(o)
        if i % 6 == 0:
            goal = te.table.goal_pos[ep[i], 0].numpy()
            xz = goal[[0, 2]] + rng.uniform(-0.1, 0.1, 2)
        else:
            if i % 3 == 1:
                pad = np.pad(o, 1)
                near_wall = ~(pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:])
                cells = np.argwhere(o & near_wall)
            c = cells[rng.integers(len(cells))]
            xz = lo[sid[i]] + (c + rng.uniform(-0.5, 0.5, 2)) * res
        pos[i] = [xz[0], te.pack.floor_y[sid[i]].item(), xz[1]]
    return ep, sid, pos, rng.uniform(-np.pi, np.pi, m).astype(np.float32)


def test_greedy_follower_matches_jax(bench_envs):
    je, te, _, _ = bench_envs
    ep, sid, pos, yaw = _poses(te, 512, 0)
    step = functools.partial(jng.greedy_follower_step, **FOLLOW)

    @jax.jit
    def ref_fn(sid, ep, pos, yaw):
        fields = je.table.dist_field[ep].astype(jnp.float32)
        return jax.vmap(lambda s_, f, p, y: step(je.pack, s_, f, p, y))(sid, fields, pos, yaw)

    ref = np.asarray(ref_fn(jnp.asarray(sid, jnp.int32), jnp.asarray(ep), jnp.asarray(pos), jnp.asarray(yaw)))
    got = tng.greedy_follower_step(te.pack, torch.from_numpy(sid), te.table.dist_field, torch.from_numpy(ep),
                                   torch.from_numpy(pos), torch.from_numpy(yaw), **FOLLOW)
    assert got.shape == (512,)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref)) == {0, 1, 2, 3}  # stops near the goals, moves and both turns


def test_shortest_path_follower_matches_jax(bench_envs):
    """The JAX TpuSim walks in the first bench scene; at every step both
    followers read its state."""
    *_, jax_scene, port_scene = bench_envs
    sim = TpuSim(scene=jax_scene)
    jf = JaxFollower(sim, goal_radius=0.2, return_one_hot=False)
    port_sim = types.SimpleNamespace(_scene=port_scene, _fwd_step=sim._fwd_step, _turn=sim._turn)
    port_sim.pack = pack_scenes([port_sim._scene])
    assert np.array_equal(port_sim._scene.nav_occ, sim._scene.nav_occ)
    tf = ShortestPathFollower(port_sim, goal_radius=0.2, return_one_hot=False)
    one_hot = ShortestPathFollower(port_sim, goal_radius=0.2)
    # a goal 0.4-0.6 m from the start on the same floor, by geodesic distance
    occ, res = sim._scene.nav_occ, sim._scene.nav_res
    start = sim._scene.world_to_cell(np.asarray(sim._pos)[[0, 2]])
    dist = geodesic_field(occ, start[None], res)
    cells = np.argwhere((dist > 0.4) & (dist < 0.6))
    goal_cell = cells[np.random.default_rng(1).integers(len(cells))]
    goal = np.array([*sim._scene.cell_to_world(goal_cell)], np.float32)
    goal = np.array([goal[0], float(sim._pos[1]), goal[1]], np.float32)
    actions = []
    for _ in range(40):
        port_sim._pos, port_sim._yaw = np.array(sim._pos), sim._yaw
        a = jf.get_next_action(goal)
        assert tf.get_next_action(goal) == a, len(actions)
        assert np.array_equal(one_hot.get_next_action(goal), np.eye(4, dtype=np.float32)[a])
        actions.append(a)
        if a == 0:
            break
        sim.step(a)
    assert actions[-1] == 0 and {1, 2, 3} & set(actions), actions
    assert np.linalg.norm((np.asarray(sim._pos) - goal)[[0, 2]]) < 0.2 + res


# -- behavior cloning ------------------------------------------------------------


def _env_pair(sensors=SENSORS, **kw):
    kw = dict(num_scenes=2, episodes_per_scene=4, seed=0, **kw)
    sj, ej, fj = jax_pointnav(**kw)
    st, et, ft = make_procedural_pointnav(**kw)
    env_kw = dict(num_envs=N, max_episode_steps=6, sensor_specs=sensors)
    return (jax_make_nav_env(sj, ej, precomputed_fields=fj, **env_kw),
            make_nav_env(st, et, precomputed_fields=ft, device="cpu", **env_kw))


@pytest.fixture(scope="module")
def jax_runs():
    """net -> one JAX ``train_step`` from ``init_fn(PRNGKey(0))`` (one jit
    each, float32, all ties): (the env pair, the policy's arguments, the
    start and end train states, the metrics, and on resnet9 each env step's
    teacher, observations and done, recorded by debug callbacks)."""
    cache = {}

    def run(net):
        if net in cache:
            return cache[net]
        visual = net == "resnet9"
        je, te = _env_pair(SENSORS if visual else SENSORS[2:])
        kw = dict(backbone="resnet9", hidden_size=64) if visual else dict(has_visual=False, hidden_size=64)
        rec = []
        with _jax_as("float32", all_ties=True):
            jl = JaxBCLearner(je, jax_policy(4, **kw), JaxBCConfig(num_steps=T))
            if visual:
                teacher_fn, step_fn = jl._teacher, je.step_fn

                def teacher(s):
                    a = teacher_fn(s)
                    jax.debug.callback(lambda a: rec.append(dict(teacher=np.asarray(a))), a, ordered=True)
                    return a

                def step(s, a):
                    out = step_fn(s, a)
                    jax.debug.callback(lambda o, d: rec[-1].update(obs={k: np.asarray(v) for k, v in o.items()},
                                                                   done=np.asarray(d)), out[1], out[3], ordered=True)
                    return out

                jl._teacher, je.step_fn = teacher, step
            ts = jax.jit(jl.init_fn)(jax.random.PRNGKey(0))
            ts2, jm = jax.jit(jl.train_step)(ts)
        cache[net] = (je, te, kw, ts, ts2, jm, rec)
        return cache[net]

    return run


def test_teacher_rollout_matches_jax(jax_runs):
    """The port's teacher-driven rollout against the JAX train step's own
    (recorded at each of its T env steps)."""
    *_, te, _, _, _, _, rec = jax_runs("resnet9")
    tl = BCLearner(te, make_pointnav_resnet_policy(4, has_visual=False, hidden_size=16, device="cpu"),
                   BCConfig(num_steps=T))
    st, batch = tl.collect_rollout(tl.init())
    assert len(rec) == T
    n_done = 0
    for t, r in enumerate(rec):
        np.testing.assert_array_equal(batch["teacher"][t].numpy(), r["teacher"], err_msg=f"teacher@{t}")
        tobs = {k: v[t + 1] for k, v in batch["obs"].items()} if t + 1 < T else st.obs
        not_done = batch["masks"][t + 1] if t + 1 < T else st.not_done
        np.testing.assert_array_equal(not_done.numpy(), 1.0 - r["done"].astype(np.float32), err_msg=f"done@{t}")
        np.testing.assert_allclose(tobs["pointgoal_with_gps_compass"].numpy(), r["obs"]["pointgoal_with_gps_compass"],
                                   atol=1e-5, err_msg=f"goal@{t}")
        assert np.abs(tobs["depth"].numpy() - r["obs"]["depth"]).max() <= 1e-4, t
        assert (tobs["rgb"].numpy() == r["obs"]["rgb"]).all(-1).mean() >= 0.999, t
        n_done += int(r["done"].sum())
    np.testing.assert_array_equal(batch["prev_actions"][1:].numpy(), batch["teacher"][:-1].numpy())
    assert n_done >= N and batch["masks"][0].sum() == 0  # episodes end inside; the first step starts them
    assert set(batch["teacher"].unique().tolist()) >= {1, 2, 3}


def _check_bc_update(start, got, ref, lr):
    """tests/test_torch_ppo.py::_check_update's parameter rule for one Adam
    step at ``lr``; the critic, which the loss does not reach, unchanged on
    both sides."""
    close, total = 0, 0
    for k, p in got.items():
        if k.endswith(FROZEN) or k.startswith("critic."):
            assert torch.equal(p, start[k]) and torch.equal(ref[k], start[k]), k
            continue
        assert (ref[k] - start[k]).abs().max() > lr / 2, k
        diff = (p - ref[k]).abs()
        assert diff.max() <= 2 * lr, (k, diff.max().item())
        close += int((diff <= lr / 10).sum())
        total += diff.numel()
    assert close / total >= 0.99, close / total


@pytest.mark.parametrize("net", ["blind", "resnet9"])
def test_train_step_matches_jax(jax_runs, net):
    je, te, kw, ts, ts2, jm, _ = jax_runs(net)
    start = params_from_jax(_flat(ts.params["params"]))
    ref = params_from_jax(_flat(ts2.params["params"]))
    pol = make_pointnav_resnet_policy(4, input_hw=(HW, HW), dtype=torch.float32, device="cpu", **kw)
    pol.load_state_dict(start)
    tl = BCLearner(te, pol, BCConfig(num_steps=T))
    st, tm = tl.train_step(tl.init())
    for k in ("losses/bc_loss", "teacher_match"):
        assert abs(tm[k].item() - float(jm[k])) < ATOL * max(1.0, abs(float(jm[k]))), (k, tm[k], jm[k])
    assert tm["teacher_success_rate"].item() == pytest.approx(float(jm["teacher_success_rate"]), abs=1e-7)
    assert 0.0 < tm["losses/bc_loss"].item()
    _check_bc_update(start, pol.state_dict(), ref, BCConfig().lr)
    # the carried state: the env and the hidden state after the T steps
    np.testing.assert_allclose(st.env_state.pos.numpy(), np.asarray(ts2.env_state.pos), atol=1e-5)
    np.testing.assert_allclose(st.hidden.numpy(), np.asarray(ts2.hidden), atol=ATOL)
    np.testing.assert_array_equal(st.prev_action.numpy(), np.asarray(ts2.prev_action))


def test_bc_learns_to_imitate_follower(jax_runs):
    """tests/test_il.py::test_bc_learns_to_imitate_follower on the port,
    from the JAX test's initial parameters: the committed
    ``habitat_torch/weights/bc_gate_init.pt`` (scripts/export_bc_gate_torch.py)
    equals ``params_from_jax`` of ``BCLearner.init_fn(PRNGKey(0))`` bit for
    bit (the blind net of ``jax_runs``: the same key, policy and
    observation keys)."""
    spec = importlib.util.spec_from_file_location("export_bc_gate_torch", os.path.join(SCRIPTS, "export_bc_gate_torch.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    policy = load_policy_file(os.path.join(ROOT, gate.OUT), device="cpu")
    want = params_from_jax(_flat(jax_runs("blind")[3].params["params"]))
    got = policy.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    scenes, episodes, fields = make_procedural_pointnav(**gate.SCENES)
    env = make_nav_env(scenes, episodes, precomputed_fields=fields, device="cpu", **gate.ENV)
    learner = BCLearner(env, policy, BCConfig(num_steps=32, lr=2e-3))
    assert registry.get_trainer("bc") is BCLearner
    st = learner.init()
    match = []
    for _ in range(30):
        st, m = learner.train_step(st)
        match.append(m["teacher_match"].item())
    first, last = np.mean(match[:5]), np.mean(match[-5:])
    assert last > first + 0.15 and last > 0.5, (first, last)
