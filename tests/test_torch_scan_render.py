"""habitat_torch scan-scale render route against habitat_tpu on the CPU.

The fixture is the forced-scan pack of tests/test_v14_epilogue.py (small
scan apartment, ``force_scan_tables=True``, N = 2, 32x32). The JAX side runs
its Pallas kernels under ``pltpu.force_tpu_interpret_mode()``; the port runs
its kernels' plain PyTorch versions, which is what its wrappers take for CPU
tensors.

Tolerances: the stream kernels' plain versions against the Pallas kernels on
the same packed lists: hit/miss identical, winner ids equal on >= 99.9% of
hits (shared-edge near-ties), |dt| < 5e-3 m where the winner is the same
(float32 determinants summed in another order). Whole renders: hit mask
equal, normalized depth within 1e-4 (both recover t from the winner's
plane), rgb within one level, semantic equal. The 16-step env rollout:
dones equal; poses and rewards within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.core.env_factory import make_nav_env as jax_make_nav_env
from habitat_tpu.datasets.pointnav import generate_pointnav_episode as jax_episode
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.ops import raycast_pallas as jrp
from habitat_tpu.sims import procedural as jproc
from habitat_tpu.sims.scene import pack_scenes as jax_pack
from habitat_tpu.utils.geometry import camera_rays as jax_camera_rays

from habitat_torch.core.env_factory import make_nav_env
from habitat_torch.datasets.pointnav import generate_pointnav_episode
from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from habitat_torch.sims import procedural as tproc
from habitat_torch.sims.scene import pack_scenes as torch_pack
from tests.torch_jax_native import _jax_native  # noqa: F401

SCAN_KW = dict(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
N, H, W = 2, 32, 32


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    sj, st = jproc.generate_scan_apartment(**SCAN_KW), tproc.generate_scan_apartment(**SCAN_KW)
    pj, pt = jax_pack([sj], force_scan_tables=True), torch_pack([st], force_scan_tables=True)
    assert pt.tri_attr16 is not None and pt.tri_mat.shape[3] // pt.chunk_bounds.shape[1] == 256
    rng = np.random.RandomState(11)
    pos = (np.array([[3.0, 1.25, 3.0]]) + rng.uniform(-1, 1, (N, 3)) * [1, 0, 1]).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    return dict(sj=sj, st=st, pj=pj, pt=pt, pos=pos, yaw=yaw, pitch=np.zeros(N, np.float32),
                sids=np.zeros(N, np.int32))


def _kernel_inputs(s):
    """Block-order kernel inputs (one 32x32 block per image), from the JAX
    package: [d, 1] tiles, B^T, and the world rays for the selections."""
    d_cam = jax_camera_rays(jnp.float32(0), jnp.float32(0), jnp.deg2rad(90.0), H, W).reshape(-1, 3)
    d_aug = jnp.concatenate([d_cam, jnp.ones((H * W, 1), jnp.float32)], -1)
    d_t = jnp.pad(d_aug.reshape(1, 1024, 4).transpose(0, 2, 1), ((0, 0), (0, 4), (0, 0)))
    B = jrc.ray_feature_matrix(jnp.asarray(s["pos"]), jnp.asarray(s["yaw"]), jnp.asarray(s["pitch"]))
    Bt = jnp.pad(B.transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))
    d = np.stack([
        np.asarray(jax_camera_rays(jnp.float32(y), jnp.float32(0.0), jnp.deg2rad(90.0), H, W)).reshape(-1, 3)
        for y in s["yaw"]
    ])
    o = np.broadcast_to(s["pos"][:, None, :], d.shape).copy()
    return np.asarray(d_t), np.asarray(Bt), o, d


def _assert_hits_agree(t_ref, i_ref, t_got, i_got):
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    t_got, i_got = t_got.numpy(), i_got.numpy()
    assert t_got.dtype == np.float32 and i_got.dtype == np.int32
    hit_ref, hit_got = i_ref >= 0, i_got >= 0
    np.testing.assert_array_equal(hit_ref, hit_got)
    assert hit_ref.mean() > 0.5, "cameras should see geometry"
    assert (i_ref[hit_ref] == i_got[hit_ref]).mean() >= 0.999
    same = hit_ref & (i_ref == i_got)
    assert np.abs(t_ref[same] - t_got[same]).max() < 5e-3
    np.testing.assert_array_equal(t_got[~hit_got], 1e6)


# ---- (d) the stream kernels' plain versions against the Pallas kernels ---------


def test_exactsel_plain_matches_pallas(setup):
    s = setup
    pj, pt = s["pj"], s["pt"]
    d_t, Bt, o, d = _kernel_inputs(s)
    sids = jnp.asarray(s["sids"])
    ids0, cnt0 = jrc.select_chunks(pj.chunk_bounds[sids], jnp.asarray(o), jnp.asarray(d), 1024, 64, with_cnt=True)
    planes = jnp.asarray(jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, 32, 32))
    ids, cnt = jrc.select_chunklets_exact(
        pj.tri_v0, pj.tri_e1, pj.tri_e2, pj.tri_valid, pj.chunklet_ab32, sids, jnp.asarray(s["pos"]),
        jnp.asarray(s["yaw"]), jnp.asarray(s["pitch"]), planes, ids0, cnt0, parent_c=256, c=32,
        verts16=pj.tri_verts16,
    )
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = jrp.raycast_pallas_exactsel_t(
            pj.tri_mat_g32, sids, ids, cnt, jnp.asarray(d_t), jnp.asarray(Bt), ray_tile=1024, tri_chunk=32
        )
    before = trk.raycast_exactsel_t.launches
    t_p, i_p = trk.raycast_exactsel_t(
        pt.tri_mat_g32, _t(s["sids"]), _t(ids), _t(cnt), _t(d_t), _t(Bt), ray_tile=1024, tri_chunk=32
    )
    assert trk.raycast_exactsel_t.launches == before  # CPU tensors: plain version
    _assert_hits_agree(t_j, i_j, t_p, i_p)


@pytest.mark.parametrize("chunk", [128, 256])
def test_stream_plain_matches_pallas(setup, chunk):
    s = setup
    d_t, Bt, o, d = _kernel_inputs(s)
    sids = jnp.asarray(s["sids"])
    # chunk 256 is the forced-scan pack, chunk 128 the same scene packed plainly
    pj = s["pj"] if chunk == 256 else jax_pack([s["sj"]])
    assert pj.tri_mat.shape[3] // pj.chunk_bounds.shape[1] == chunk
    ids, cnt = jrc.select_chunks_occluded(
        pj.tri_mat, pj.chunk_bounds[sids], sids, jnp.asarray(o), jnp.asarray(d), 1024, 12, with_cnt=True
    )
    gm = np.asarray(jrp.group_tri_mat_pad16(pj.tri_mat, chunk))
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = jrp.raycast_pallas_stream_t(
            jnp.asarray(gm), sids, ids, cnt, jnp.asarray(d_t), jnp.asarray(Bt), ray_tile=1024, tri_chunk=chunk
        )
    gm10 = trc.group_tri_mat(_t(pj.tri_mat), chunk).contiguous()
    np.testing.assert_array_equal(gm[:, :10], gm10.numpy())
    t_p, i_p = trk.raycast_stream_t(
        gm10, _t(s["sids"]), _t(ids), _t(cnt), _t(d_t), _t(Bt), ray_tile=1024, tri_chunk=chunk
    )
    _assert_hits_agree(t_j, i_j, t_p, i_p)


def test_stream_plain_honours_cnt(setup):
    """Slots at or beyond cnt are padding: garbage there changes nothing, and
    cnt == 0 gives all misses."""
    s = setup
    pt = s["pt"]
    d_t, Bt, _, _ = _kernel_inputs(s)
    n_chunklets = pt.tri_mat.shape[3] // 32
    ids = torch.arange(8, dtype=torch.int32).repeat(N, 1, 1) * (n_chunklets // 8)
    cnt = torch.tensor([[5], [0]], dtype=torch.int32)
    args = (pt.tri_mat_g32, _t(s["sids"]))
    t_a, i_a = trk.raycast_exactsel_t(*args, ids, cnt, _t(d_t), _t(Bt))
    junk = ids.clone()
    junk[:, :, 5:] = n_chunklets - 1
    t_b, i_b = trk.raycast_exactsel_t(*args, junk, cnt, _t(d_t), _t(Bt))
    assert torch.equal(t_a, t_b) and torch.equal(i_a, i_b)
    assert (i_a[1] == -1).all() and (t_a[1] == 1e6).all()


# ---- (f) whole renders -----------------------------------------------------------


@pytest.mark.parametrize(
    "backend,tables",
    [("auto", "attr16"), ("stream", "attr16"), ("auto", "row_gather"), ("stream", "row_gather"),
     ("auto", "no_tables")],
)
def test_render_batch_matches_pallas_path(setup, backend, tables):
    """``attr16``: the forced-scan pack (channel-major epilogue);
    ``row_gather``: the same without tri_attr16; ``no_tables``: the scene
    packed plainly (chunk 128, the boxes and the grouped matrix derived per
    render, level-1 culling only), as scenes of 12,289 to 262,143 triangles
    are."""
    s = setup
    pj, pt = s["pj"], s["pt"]
    if tables == "row_gather":
        pj, pt = dataclasses.replace(pj, tri_attr16=None), dataclasses.replace(pt, tri_attr16=None)
    elif tables == "no_tables":
        pj, pt = jax_pack([s["sj"]]), torch_pack([s["st"]])
        assert pt.tri_verts16 is None and pt.tri_mat.shape[3] // pt.chunk_bounds.shape[1] == 128
    # small enough that T // 128 > 2 * cull_k takes the large-scene branch
    cull_k = max(4, pt.tri_mat.shape[3] // 128 // 4)
    assert trc.is_large_scene(pt, cull_k) and not trc.is_large_scene(pt)
    with pltpu.force_tpu_interpret_mode():
        ref = jrc.render_batch(
            pj, jnp.asarray(s["sids"]), jnp.asarray(s["pos"]), jnp.asarray(s["yaw"]), jnp.asarray(s["pitch"]),
            height=H, width=W, backend="stream" if backend == "stream" else "pallas", cull_k=cull_k,
        )
    before = {k: getattr(trk, k).launches for k in ("raycast_exactsel_t", "raycast_stream_t")}
    got = trc.render_batch(
        pt, _t(s["sids"]), _t(s["pos"]), _t(s["yaw"]), _t(s["pitch"]),
        height=H, width=W, backend=backend, cull_k=cull_k,
    )
    assert before == {k: getattr(trk, k).launches for k in before}
    assert got["rgb"].dtype == torch.uint8 and got["depth"].dtype == torch.float32
    assert got["semantic"].dtype == torch.int32
    for k in ("rgb", "depth", "semantic"):
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
    d_ref, d_got = np.asarray(ref["depth"]), got["depth"].numpy()
    assert (d_ref < 0.999).mean() > 0.5, "camera should see geometry"
    np.testing.assert_array_equal(d_ref < 0.999, d_got < 0.999)
    assert np.abs(d_ref - d_got).max() < 1e-4
    assert np.abs(np.asarray(ref["rgb"], np.int32) - got["rgb"].numpy().astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(np.asarray(ref["semantic"]), got["semantic"].numpy())


@pytest.mark.parametrize("backend", ["auto", "stream"])
def test_two_scene_pack_indexes_by_scene(setup, backend):
    """Envs of one pack in different scenes: every per-scene table (chunk
    bounds, chunklet boxes, the grouped matrix, the vertex and attribute
    rows) is indexed by the env's scene, so the frames equal those of each
    scene packed alone (hit mask equal, depth within 1e-6)."""
    s = setup
    other = tproc.generate_scan_apartment(seed=6, extent=6.0, n_rooms_per_axis=2, n_clutter=4, tess=0.4)
    both = torch_pack([s["st"], other], force_scan_tables=True)
    assert both.num_scenes == 2 and both.tri_verts16.shape[0] == 2
    kw = dict(height=H, width=W, cull_k=8, backend=backend)
    pose = (_t(s["pos"]), _t(s["yaw"]), _t(s["pitch"]))
    got = trc.render_batch(both, torch.tensor([0, 1], dtype=torch.int32), *pose, **kw)
    zeros = torch.zeros(N, dtype=torch.int32)
    alone = [trc.render_batch(torch_pack([sc], force_scan_tables=True), zeros, *pose, **kw) for sc in (s["st"], other)]
    for env in range(N):
        ref = alone[env]
        assert torch.equal(got["depth"][env] < 0.999, ref["depth"][env] < 0.999)
        assert (got["depth"][env] - ref["depth"][env]).abs().max() < 1e-6
        assert torch.equal(got["semantic"][env], ref["semantic"][env])
        assert torch.equal(got["rgb"][env], ref["rgb"][env])
    assert not torch.equal(got["depth"][1], alone[0]["depth"][1])  # the scenes differ


def test_render_on_cpu_counts_no_launch(setup):
    """CPU tensors take every wrapper's plain version, the cull mask's too:
    a render on the scan route counts no kernel launch."""
    s = setup
    names = ("raycast_exactsel_t", "raycast_stream_t", "cullmask_t")
    before = {k: getattr(trk, k).launches for k in names}
    out = trc.render_batch(
        s["pt"], _t(s["sids"]), _t(s["pos"]), _t(s["yaw"]), _t(s["pitch"]), height=H, width=W, cull_k=8
    )
    assert before == {k: getattr(trk, k).launches for k in names}
    assert (out["depth"] < 0.999).float().mean() > 0.5


def test_scan_unported_branches_raise(setup):
    """On a large scene, unknown backends still raise; dynamic geometry
    merges on the block route (tests/test_torch_dynamic.py holds it against
    the JAX package); an image that is not 32x32-blockable and a fisheye
    camera render through the general route (tests/test_torch_panoramic.py
    holds it against the JAX package)."""
    s = setup
    args = (s["pt"], _t(s["sids"]), _t(s["pos"]), _t(s["yaw"]), _t(s["pitch"]))
    no_objects = dict(v0=torch.zeros(N, 12, 3), e1=torch.zeros(N, 12, 3), e2=torch.zeros(N, 12, 3),
                      valid=torch.zeros(N, 12, dtype=torch.bool), color=torch.zeros(N, 12, 3),
                      sem=torch.zeros(N, 12, dtype=torch.int32))
    assert trc.render_route(s["pt"], H, W, cull_k=8, dynamic=True) == "block"
    out = trc.render_batch(*args, height=H, width=W, cull_k=8, dynamic=no_objects)
    static = trc.render_batch(*args, height=H, width=W, cull_k=8)
    for k in out:
        assert torch.equal(out[k], static[k]), k
    with pytest.raises(ValueError, match="backend"):
        trc.render_batch(*args, height=H, width=W, cull_k=8, backend="pallas")
    for kw, route in ((dict(height=48, width=48), "index"), (dict(height=H, width=W, projection="fisheye"), "culled")):
        assert trc.render_route(s["pt"], kw["height"], kw["width"], kw.get("projection", "pinhole"), 8) == route
        out = trc.render_batch(*args, cull_k=8, **kw)
        assert (out["depth"] < 0.999).float().mean() > 0.5


# ---- (g) the env on a scan pack ---------------------------------------------------


def test_env_rollout_on_scan_pack_matches(setup, monkeypatch):
    """16 fixed actions over 4 envs on the forced-scan pack: the port's env
    renders 32x32 depth through the scan route on every step (cull_k small
    enough for this pack) while poses, rewards and dones follow the JAX env.
    The JAX factory packs this small scene plainly, so the port's depth
    frames are held against the JAX package's render of its forced-scan pack
    through the same route at the JAX env's poses, on every fourth step: hit
    mask equal, normalized depth within 1e-4."""
    import jax

    from habitat_torch.sims import scene as tscene

    s = setup
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    pj = [jax_episode(s["sj"], str(i), rj) for i in range(4)]
    ptt = [generate_pointnav_episode(s["st"], str(i), rt) for i in range(4)]
    assert all(p is not None for p in pj + ptt)
    # the port's factory packs with the scan layout
    monkeypatch.setattr(tscene, "_SCAN_SCALE_TRIS", 0)
    kw = dict(num_envs=4, max_episode_steps=6, seed=1)
    je = jax_make_nav_env([s["sj"]], [p[0] for p in pj], precomputed_fields={e.episode_id: f for e, f in pj}, **kw)
    te = make_nav_env(
        [s["st"]], [p[0] for p in ptt], precomputed_fields={e.episode_id: f for e, f in ptt}, device="cpu",
        sensor_specs=(
            ("HabitatSimDepthSensor", {"height": 32, "width": 32}),
            ("HabitatSimRGBSensor", {"height": 32, "width": 32}),
            ("PointGoalWithGPSCompassSensor", None),
        ),
        **kw,
    )
    assert te.pack.tri_verts16 is not None and te.pack.tri_mat.shape[3] // te.pack.chunk_bounds.shape[1] == 256
    monkeypatch.setattr(trc, "_FAST_CULL_K", 4)  # this small pack then counts as a large scene
    assert trc.is_large_scene(te.pack)
    actions = np.random.default_rng(2).choice(4, size=(16, 4), p=[0.05, 0.55, 0.2, 0.2]).astype(np.int32)
    js, jobs = je.reset(seed=0)
    ts, tobs = te.reset_fn()
    close = dict(rtol=0, atol=1e-5)
    n_done = 0
    cam_offset = jnp.array([0.0, 1.25, 0.0])
    jax_scan_render = jax.jit(lambda pos, yaw, pitch: jrc.render_batch(
        s["pj"], jnp.zeros(4, jnp.int32), pos + cam_offset, yaw, pitch, height=32, width=32,
        backend="pallas", cull_k=4,
    )["depth"])
    for k in range(16):
        js, jobs, jr, jd, _ = je.step(js, jnp.asarray(actions[k]))
        ts, tobs, tr, td, _ = te.step_fn(ts, torch.from_numpy(actions[k]))
        np.testing.assert_array_equal(np.asarray(jd), td.numpy(), err_msg=f"done@{k}")
        np.testing.assert_allclose(np.asarray(js.pos), ts.pos.numpy(), err_msg=f"pos@{k}", **close)
        np.testing.assert_allclose(np.asarray(js.yaw), ts.yaw.numpy(), err_msg=f"yaw@{k}", **close)
        np.testing.assert_allclose(np.asarray(jr), tr.numpy(), err_msg=f"reward@{k}", **close)
        np.testing.assert_allclose(
            np.asarray(jobs["pointgoal_with_gps_compass"]), tobs["pointgoal_with_gps_compass"].numpy(), **close
        )
        assert tobs["depth"].shape == (4, 32, 32, 1) and torch.isfinite(tobs["depth"]).all()
        assert (tobs["depth"] < 0.999).float().mean() > 0.3, "the scan route should see geometry"
        assert tobs["rgb"].shape == (4, 32, 32, 3)
        if k % 4 == 3:
            with pltpu.force_tpu_interpret_mode():
                d_ref = np.asarray(jax_scan_render(js.pos, js.yaw, js.pitch))
            d_got = tobs["depth"].numpy()
            np.testing.assert_array_equal(d_ref < 0.999, d_got < 0.999, err_msg=f"hit mask@{k}")
            assert np.abs(d_ref - d_got).max() < 1e-4, k
        n_done += int(td.sum())
    assert n_done >= 4  # auto-reset exercised
