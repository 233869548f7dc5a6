"""habitat_torch's general render route (equirect, fisheye and untiled
pinhole cameras) against habitat_tpu on the CPU.

The JAX side runs its Pallas kernels under
``pltpu.force_tpu_interpret_mode()``; the port runs its kernels' plain
PyTorch versions, which is what its wrappers take for CPU tensors.

Tolerances:
- rays and ray features: 1e-6 (float32 trigonometry, rounded differently);
- the index kernel's plain version against ``raycast_pallas_index_t``: hit
  equal, winner ids equal on >= 99.9% of hits (shared-edge near-ties),
  |dt| < 1e-4 m on equal winners (float32 determinants summed in another
  order);
- the culled kernel's plain version against ``raycast_pallas_culled_t`` on
  the same chunk ids: the same, and the 8 attributes equal where the winner
  is;
- whole renders against ``render_batch(..., backend="pallas")``: hit equal,
  normalized depth 1e-4, rgb within one level, semantic equal;
- on a pack of 256-triangle chunks, the culled render against a brute-force
  float64 raycast over exactly the listed chunks: hit/miss on >= 99.9% of
  rays, |dt| < 1e-3 m on common hits (the JAX route reads those ids as
  128-triangle blocks, ROADMAP Queue 3, so it is not the reference there);
- the policy at 128x256: logits and values 1e-4 in float32;
- a 32-step fixed-action rollout of 8 envs with the equirect depth+RGB
  pair: dones equal, poses and rewards 1e-5, depth 1e-4, rgb within one
  level.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.models import policy as jax_policy_module
from habitat_tpu.models.policy import make_pointnav_resnet_policy as jax_policy
from habitat_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.ops import raycast_pallas as jrp
from habitat_tpu.sims import procedural as jproc
from habitat_tpu.sims.scene import pack_scenes as jax_pack
from habitat_tpu.utils import geometry as jgeo

from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.models.convert import params_from_jax
from habitat_torch.models.policy import make_pointnav_resnet_policy
from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from habitat_torch.sims import procedural as tproc
from habitat_torch.sims.scene import pack_scenes as torch_pack
from habitat_torch.utils import geometry as tgeo
from tests.torch_jax_native import _jax_native  # noqa: F401

SCAN_KW = dict(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
MID_KW = dict(num_scenes=1, episodes_per_scene=1, seed=0, extent=30.0, scene_kw=dict(n_clutter=420))
CULL_K = 8  # parent chunks per tile: small enough that the scan apartment is a large scene


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _poses(n, seed, centre=(5.0, 1.25, 5.0), spread=2.0):
    rng = np.random.RandomState(seed)
    pos = (np.array([centre]) + rng.uniform(-spread, spread, (n, 3)) * [1, 0, 1]).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    pitch = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    return pos, yaw, pitch


@pytest.fixture(scope="module")
def packs():
    """JAX and port packs: the bench scenes (T=128), the mid-size scene
    (T=4352), the scan apartment in 128-triangle chunks and in 256."""
    out = {}
    sj, _, _ = jax_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    st, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    out["bench"] = (jax_pack(sj), torch_pack(st))
    sj, _, _ = jax_pointnav(**MID_KW)
    st, _, _ = make_procedural_pointnav(**MID_KW)
    out["mid"] = (jax_pack(sj), torch_pack(st))
    sj, st = jproc.generate_scan_apartment(**SCAN_KW), tproc.generate_scan_apartment(**SCAN_KW)
    out["scan128"] = (jax_pack([sj]), torch_pack([st]))
    out["scan256"] = (jax_pack([sj], force_scan_tables=True), torch_pack([st], force_scan_tables=True))
    assert out["mid"][1].tri_mat.shape[3] == 4352
    for name, C in (("scan128", 128), ("scan256", 256)):
        pt = out[name][1]
        assert pt.tri_mat.shape[3] // pt.chunk_bounds.shape[1] == C
        assert trc.is_large_scene(pt, CULL_K)
    return out


def _jax_rays(projection, yaw, pitch, H, W, hfov=90.0):
    """(N, H*W, 3) world rays from the JAX package, as its render_batch makes them."""
    if projection == "equirect":
        fn = lambda y, p: jgeo.equirect_rays(y, p, H, W)
    elif projection == "fisheye":
        fn = lambda y, p: jgeo.fisheye_rays(y, p, jnp.deg2rad(hfov * 2), H, W)
    else:
        fn = lambda y, p: jgeo.camera_rays(y, p, jnp.deg2rad(hfov), H, W)
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(yaw), jnp.asarray(pitch))).reshape(len(yaw), -1, 3)


# ---- rays and features -----------------------------------------------------


@pytest.mark.parametrize("projection,H,W", [("equirect", 32, 64), ("fisheye", 24, 40), ("pinhole", 20, 30)])
def test_world_rays_match(projection, H, W):
    _, yaw, pitch = _poses(3, 0)
    ref = _jax_rays(projection, yaw, pitch, H, W)
    got = trc.world_rays(_t(yaw), _t(pitch), 90.0, H, W, projection).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rt", [2048, 4096])
def test_ray_features_t_match(rt):
    pos, yaw, pitch = _poses(2, 1)
    d = _jax_rays("equirect", yaw, pitch, 64, 64)
    o = np.broadcast_to(pos[:, None, :], d.shape).copy()
    ref = np.asarray(jax.jit(jrc.ray_features_t, static_argnums=2)(jnp.asarray(o), jnp.asarray(d), rt))
    got = trc.ray_features_t(_t(o), _t(d), rt).numpy()
    assert got.shape == ref.shape == (2, 4096 // rt, 16, rt)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert not got[:, :, 10:].any()


# ---- the kernels' plain versions against the Pallas kernels ------------------


def _assert_hits_agree(t_ref, i_ref, t_got, i_got, dt=1e-4):
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    t_got, i_got = t_got.numpy(), i_got.numpy()
    hit_ref, hit_got = i_ref >= 0, i_got >= 0
    np.testing.assert_array_equal(hit_ref, hit_got)
    assert hit_ref.mean() > 0.3, "cameras should see geometry"
    assert (i_ref[hit_ref] == i_got[hit_ref]).mean() >= 0.999
    same = hit_ref & (i_ref == i_got)
    assert np.abs(t_ref[same] - t_got[same]).max() < dt
    np.testing.assert_array_equal(t_got[~hit_got], 1e6)


@pytest.mark.parametrize(
    "scene,projection,H,W,rt",
    [("bench", "equirect", 64, 64, 2048), ("bench", "pinhole", 20, 30, 600),
     ("mid", "equirect", 32, 64, 2048), ("mid", "fisheye", 24, 40, 960)],
)
def test_index_plain_matches_pallas(packs, scene, projection, H, W, rt):
    pj, pt = packs[scene]
    n = 2
    pos, yaw, pitch = _poses(n, 2)
    sids = (np.arange(n) % pt.num_scenes).astype(np.int32)
    d = _jax_rays(projection, yaw, pitch, H, W)
    o = np.broadcast_to(pos[:, None, :], d.shape).copy()
    feat = jrc.ray_features_t(jnp.asarray(o), jnp.asarray(d), rt)
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = jax.jit(jrp.raycast_pallas_index_t, static_argnames="ray_tile")(
            pj.tri_mat, jnp.asarray(sids), feat, ray_tile=rt)
    before = trk.raycast_index_t.launches
    t_p, i_p = trk.raycast_index_t(pt.tri_mat, _t(sids), _t(feat), ray_tile=rt)
    assert trk.raycast_index_t.launches == before  # CPU tensors: the plain version
    assert t_p.shape == i_p.shape == (n, H * W) and i_p.dtype == torch.int32
    _assert_hits_agree(t_j, i_j, t_p, i_p)


def _culled_inputs(pj, n, seed, H=32, W=64, projection="equirect"):
    """JAX-side inputs of the culled kernel: the occlusion-bounded top-K ids
    of raster-order 1024-ray tiles, and the transposed ray features."""
    pos, yaw, pitch = _poses(n, seed, centre=(3.0, 1.25, 3.0), spread=1.0)
    sids = np.zeros(n, np.int32)
    d = _jax_rays(projection, yaw, pitch, H, W)
    o = np.broadcast_to(pos[:, None, :], d.shape).copy()
    ids = jrc.select_chunks_occluded(
        pj.tri_mat, pj.chunk_bounds[jnp.asarray(sids)], jnp.asarray(sids), jnp.asarray(o), jnp.asarray(d),
        1024, CULL_K,
    )
    return dict(pos=pos, yaw=yaw, pitch=pitch, sids=sids, d=d, o=o, ids=np.asarray(ids),
                feat=np.asarray(jrc.ray_features_t(jnp.asarray(o), jnp.asarray(d), 1024)))


@pytest.mark.parametrize("scene,chunk", [("scan128", 128), ("scan256", 256)])
def test_culled_plain_matches_pallas(packs, scene, chunk):
    """On the same chunk ids; the chunk-256 pack passes tri_chunk=256 to the
    JAX kernel explicitly (its render route does not)."""
    pj, pt = packs[scene]
    x = _culled_inputs(pj, 2, 3)
    attr_t = jnp.swapaxes(pj.tri_attr, 1, 2)
    with pltpu.force_tpu_interpret_mode():
        t_j, a_j = jax.jit(jrp.raycast_pallas_culled_t, static_argnames=("ray_tile", "tri_chunk"))(
            pj.tri_mat, attr_t, jnp.asarray(x["ids"]), jnp.asarray(x["sids"]), jnp.asarray(x["feat"]),
            ray_tile=1024, tri_chunk=chunk)
    t_p, a_p = trk.raycast_culled_t(
        pt.tri_mat, _t(attr_t), _t(x["ids"]), _t(x["sids"]), _t(x["feat"]), ray_tile=1024, tri_chunk=chunk)
    t_j, a_j, a_p = np.asarray(t_j), np.asarray(a_j), a_p.numpy()
    assert a_p.shape == a_j.shape == (2, 8, 2048)
    hit_j, hit_p = a_j[:, 7] > 0.5, a_p[:, 7] > 0.5
    np.testing.assert_array_equal(hit_j, hit_p)
    assert hit_j.mean() > 0.3
    np.testing.assert_array_equal(t_p.numpy()[~hit_p], 1e6)
    assert not a_p.transpose(0, 2, 1)[~hit_p].any()
    # the winner is the triangle whose attributes come out: equal attributes
    # on >= 99.9% of hits, and where they are equal, t within 1e-4
    same = hit_j & (a_j == a_p).all(axis=1)
    assert same[hit_j].mean() >= 0.999
    assert np.abs(t_j[same] - t_p.numpy()[same]).max() < 1e-4


# ---- whole renders ----------------------------------------------------------


def _render_both(pj, pt, sids, pos, yaw, pitch, **kw):
    with pltpu.force_tpu_interpret_mode():
        fj = jax.jit(lambda s, p, y, q: jrc.render_batch(pj, s, p, y, q, backend="pallas", **kw))(
            jnp.asarray(sids), jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch))
    ft = trc.render_batch(pt, _t(sids), _t(pos), _t(yaw), _t(pitch), **kw)
    return {k: np.asarray(v) for k, v in fj.items()}, {k: v.numpy() for k, v in ft.items()}


def _assert_frames_agree(fj, ft):
    hit_j, hit_t = fj["depth"] < 1.0, ft["depth"] < 1.0
    np.testing.assert_array_equal(hit_j, hit_t)
    assert 0.2 < hit_j.mean()
    np.testing.assert_allclose(ft["depth"], fj["depth"], rtol=0, atol=1e-4)
    assert np.abs(ft["rgb"].astype(int) - fj["rgb"].astype(int)).max() <= 1
    np.testing.assert_array_equal(ft["semantic"], fj["semantic"])


@pytest.mark.parametrize(
    "scene,projection,H,W,route",
    [("bench", "equirect", 32, 64, "index"), ("bench", "fisheye", 32, 32, "index"),
     ("bench", "pinhole", 20, 30, "index"), ("scan128", "equirect", 32, 64, "culled"),
     ("scan128", "pinhole", 80, 128, "culled")],
)
def test_render_matches(packs, scene, projection, H, W, route):
    pj, pt = packs[scene]
    n = 3
    if scene == "bench":
        pos, yaw, pitch = _poses(n, 4)
        sids = (np.arange(n) % 2).astype(np.int32)
        cull_k = None
    else:
        pos, yaw, pitch = _poses(n, 5, centre=(3.0, 1.25, 3.0), spread=1.0)
        sids = np.zeros(n, np.int32)
        cull_k = CULL_K
    assert trc.render_route(pt, H, W, projection, cull_k) == route
    fj, ft = _render_both(pj, pt, sids, pos, yaw, pitch, height=H, width=W, projection=projection, cull_k=cull_k)
    _assert_frames_agree(fj, ft)


def _brute_force_listed(pt, sids, pos, dirs, ids, C, rt=1024):
    """float64 Möller–Trumbore closest hit of each ray over the triangles of
    its tile's listed chunks of C triangles: (t (N, R), 1e6 on a miss)."""
    N, R, _ = dirs.shape
    v0, e1, e2 = (x.double().numpy() for x in (pt.tri_v0, pt.tri_e1, pt.tri_e2))
    valid = pt.tri_valid.numpy()
    t_out = np.full((N, R), 1e6)
    for n in range(N):
        s = sids[n]
        for j in range(R // rt):
            tris = (ids[n, j][:, None] * C + np.arange(C)).ravel()
            tris = tris[valid[s, tris]]
            d = dirs[n, j * rt:(j + 1) * rt].astype(np.float64)[:, None, :]  # (rt, 1, 3)
            a, b, c = v0[s, tris][None], e1[s, tris][None], e2[s, tris][None]
            p = np.cross(d, c)
            det = (b * p).sum(-1)
            ok = np.abs(det) > 1e-12
            inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            s_ = pos[n].astype(np.float64)[None, None, :] - a
            u = (s_ * p).sum(-1) * inv
            q = np.cross(s_, b)
            v = (d * q).sum(-1) * inv
            t = (c * q).sum(-1) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-3)
            t_out[n, j * rt:(j + 1) * rt] = np.where(hit, t, 1e6).min(-1)
    return t_out


def test_chunk256_render_matches_listed_chunks(packs):
    """The port's equirect render of a 256-triangle-chunk pack tests exactly
    the triangles of the chunks its selection lists: the kernel reads chunk
    ids in the pack's unit. The same ids read as 128-triangle blocks (the
    JAX route's reading) disagree with the brute force."""
    pj, pt = packs["scan256"]
    n, H, W = 2, 32, 64
    pos, yaw, pitch = _poses(n, 6, centre=(3.0, 1.25, 3.0), spread=1.0)
    sids = np.zeros(n, np.int32)
    kernel, args, kwargs, dirs = trc.closest_hit_call(
        pt, _t(sids), _t(pos), _t(yaw), _t(pitch), height=H, width=W, projection="equirect", cull_k=CULL_K)
    assert kernel is trk.raycast_culled_t and kwargs["tri_chunk"] == 256
    ids = args[2].numpy()
    ref = _brute_force_listed(pt, sids, pos, dirs.numpy(), ids, 256)
    hit_ref = ref < 1e5
    assert 0.2 < hit_ref.mean()
    frames = trc.render_batch(
        pt, _t(sids), _t(pos), _t(yaw), _t(pitch), height=H, width=W, projection="equirect", cull_k=CULL_K,
        normalize_depth=False, max_depth=1e6)
    t_r = frames["depth"].reshape(n, -1).double().numpy()
    hit_r = t_r < 1e5
    assert (hit_r == hit_ref).mean() >= 0.999
    both = hit_r & hit_ref
    assert np.abs(t_r[both] - ref[both]).max() < 1e-3
    # the same ids read as 128-triangle blocks
    t128, a128 = trk.raycast_culled_t(*args, ray_tile=1024, tri_chunk=128)
    hit128 = a128[:, 7].numpy() > 0.5
    assert (hit128 != hit_ref).mean() > 0.05 or np.abs(t128.numpy()[hit128 & hit_ref] - ref[hit128 & hit_ref]).max() > 0.1


# ---- dispatch and the env ----------------------------------------------------


def test_routes_and_dynamic_raises(packs):
    pb, ps = packs["bench"][1], packs["scan256"][1]
    assert trc.render_route(pb, 128, 128) == "pinhole"
    assert trc.render_route(pb, 32, 32) == "pinhole"  # one 1024-ray tile
    assert trc.render_route(pb, 48, 64, "pinhole") == "index"  # 3072 rays above 2048 do not tile
    assert trc.render_route(pb, 128, 256, "equirect") == "index"
    assert trc.render_route(ps, 128, 128, cull_k=CULL_K) == "block"
    assert trc.render_route(ps, 80, 128, cull_k=CULL_K) == "culled"
    assert trc.render_route(ps, 128, 256, "fisheye", cull_k=CULL_K) == "culled"
    assert trc.render_route(ps, 20, 30, cull_k=CULL_K) == "index"
    with pytest.raises(ValueError, match="projection"):
        trc.render_route(pb, 32, 32, "cubemap")
    # dynamic geometry no longer raises: it leaves the panoramic routes as
    # they are and takes small-scene pinhole images off the fast path
    assert trc.render_route(pb, 128, 256, "equirect", dynamic=True) == "index"
    assert trc.render_route(ps, 128, 256, "fisheye", cull_k=CULL_K, dynamic=True) == "culled"
    assert trc.render_route(pb, 32, 32, dynamic=True) == "index"


def test_policy_128x256_matches(monkeypatch):
    """A JAX policy initialised on 128x256 observations converts to the
    port's policy built for that size; float32 on both sides (the JAX
    encoder is switched to float32 in this test only)."""
    monkeypatch.setattr(jax_policy_module, "ResNetEncoder", functools.partial(JaxResNetEncoder, dtype=jnp.float32))
    rng = np.random.default_rng(3)
    n, hw = 2, (128, 256)
    obs = {
        "rgb": rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8),
        "depth": rng.uniform(0, 1, (n, *hw, 1)).astype(np.float32),
        "pointgoal_with_gps_compass": np.stack([rng.uniform(0.5, 8, n), rng.uniform(-3, 3, n)], -1).astype(np.float32),
    }
    hidden = rng.normal(0, 0.5, (n, 1, 2, 512)).astype(np.float32)
    prev, masks = np.array([1, 2], np.int32), np.array([1.0, 0.0], np.float32)
    jpol = jax_policy(4, backbone="resnet18", hidden_size=512)
    args = (obs, jnp.asarray(hidden), jnp.asarray(prev), jnp.asarray(masks))
    params = jax.jit(jpol.init)(jax.random.PRNGKey(0), *args)
    ref_logits, ref_values, _ = jax.jit(jpol.apply)(params, *args)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params["params"], sep="/").items()}
    tpol = make_pointnav_resnet_policy(4, input_hw=hw, dtype=torch.float32, device="cpu")
    assert tpol.net.encoder.output_dim == 4 * 8 * 64
    tpol.load_state_dict(params_from_jax(flat))
    with torch.no_grad():
        logits, values, _ = tpol({k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(hidden),
                                 torch.from_numpy(prev), torch.from_numpy(masks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(values.numpy(), np.asarray(ref_values), rtol=0, atol=1e-4)


PANO_SENSORS = (
    ("HabitatSimEquirectangularDepthSensor", {"height": 32, "width": 64}),
    ("HabitatSimEquirectangularRGBSensor", {"height": 32, "width": 64}),
    ("PointGoalWithGPSCompassSensor", None),
)


def test_render_groups_split_by_projection():
    """Sensors of one size but another projection render separately: the
    depth of an equirect sensor beside a pinhole semantic one is the
    equirect render."""
    st, et, ft = make_procedural_pointnav(num_scenes=1, episodes_per_scene=2, seed=0)
    env = make_nav_env(st, et, num_envs=2, device="cpu", precomputed_fields=ft, sensor_specs=(
        ("HabitatSimEquirectangularDepthSensor", {"height": 32, "width": 64}),
        ("HabitatSimSemanticSensor", {"height": 32, "width": 64}),
    ))
    assert sorted(g["proj"] for g in env._render_groups) == ["equirect", "pinhole"]
    state, obs = env.reset_fn()
    assert obs["depth"].shape == (2, 32, 64, 1) and obs["semantic"].shape == (2, 32, 64, 1)
    ctx = env._make_ctx(state)
    cam = state.pos + torch.tensor([0.0, 1.25, 0.0])
    ref = trc.render_batch(env.pack, ctx.sid, cam, state.yaw, state.pitch, height=32, width=64, projection="equirect")
    torch.testing.assert_close(obs["depth"], ref["depth"], rtol=0, atol=0)
    ref = trc.render_batch(env.pack, ctx.sid, cam, state.yaw, state.pitch, height=32, width=64)
    torch.testing.assert_close(obs["semantic"], ref["semantic"], rtol=0, atol=0)


def test_equirect_rollout_matches():
    n_envs, n_steps = 8, 32
    kw = dict(num_scenes=2, episodes_per_scene=4, seed=0)
    sj, ej, fj = jax_pointnav(**kw)
    st, et, ft = make_procedural_pointnav(**kw)
    env_kw = dict(num_envs=n_envs, max_episode_steps=12, seed=3, sensor_specs=PANO_SENSORS)
    je = jax_make_nav_env(sj, ej, precomputed_fields=fj, **env_kw)
    te = make_nav_env(st, et, precomputed_fields=ft, device="cpu", **env_kw)
    rng = np.random.default_rng(0)
    actions = rng.choice(4, size=(n_steps, n_envs), p=[0.04, 0.56, 0.2, 0.2]).astype(np.int32)
    js, jobs = je.reset(seed=0)
    ts, tobs = te.reset_fn()
    step = jax.jit(je.step)
    n_done = 0
    for k in range(n_steps + 1):
        for key in ("depth", "rgb"):
            assert tobs[key].shape == (n_envs, 32, 64, 1 if key == "depth" else 3)
        np.testing.assert_allclose(tobs["depth"].numpy(), np.asarray(jobs["depth"]), rtol=0, atol=1e-4,
                                   err_msg=f"depth@{k}")
        assert np.abs(tobs["rgb"].numpy().astype(int) - np.asarray(jobs["rgb"]).astype(int)).max() <= 1
        if k == n_steps:
            break
        js, jobs, jr, jd, _ = step(js, jnp.asarray(actions[k]))
        ts, tobs, tr, td, _ = te.step_fn(ts, torch.from_numpy(actions[k]))
        np.testing.assert_array_equal(np.asarray(jd), td.numpy(), err_msg=f"done@{k}")
        for name in ("pos", "yaw"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
        n_done += int(td.sum())
    assert n_done >= n_envs // 2
