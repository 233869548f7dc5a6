"""habitat_torch's ray-batch kernels against habitat_tpu on the CPU.

The JAX side runs ``raycast_pallas_batch`` (the v3 index kernel and its
attribute gather), ``raycast_pallas_culled`` and ``raycast_pallas_tilecull_t``
under ``pltpu.force_tpu_interpret_mode()``; the port runs ``raycast_batch``,
``raycast_culled`` and ``raycast_tilecull_t``, whose wrappers take their plain
PyTorch versions for CPU tensors.

Tolerances (the same for every kernel):
- hit/miss equal, and the winner (its id, or for the attribute kernels its 8
  attributes, or #10's gid row) equal on >= 99.9% of hits: float32
  determinants are summed in another order, so a shared-edge near-tie may
  go the other way (equality is expected on these inputs);
- t within 1e-4 m where the winner is the same;
- attribute rows within 1e-6 (exact copies on both sides, the JAX one-hot
  products being exact on the CPU), #10's row 12 (0.35 on a miss) and its
  plane-exact t included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.ops import raycast_pallas as jrp
from habitat_tpu.sims import procedural as jproc
from habitat_tpu.sims.scene import pack_scenes as jax_pack
from habitat_tpu.utils import geometry as jgeo

from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from habitat_torch.sims import procedural as tproc
from habitat_torch.sims.scene import pack_scenes as torch_pack
from tests.torch_jax_native import _jax_native  # noqa: F401

SCAN_KW = dict(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
CULL_K = 8


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """One jit per JAX reference."""
    return dict(
        batch=jax.jit(jrp.raycast_pallas_batch, static_argnames=("ray_tile", "tri_chunk")),
        culled=jax.jit(jrp.raycast_pallas_culled, static_argnames=("ray_tile", "tri_chunk")),
        tilecull=jax.jit(jrp.raycast_pallas_tilecull_t, static_argnames=("ray_tile", "tri_chunk")),
        attr16=jax.jit(jrp.attr16_table, static_argnames="tri_chunk"),
        features=jax.jit(jrc.ray_features),
    )


@pytest.fixture(scope="module")
def packs():
    """JAX and port packs: two bench scenes (T=128) and the scan apartment
    in chunks of 128 and of 256."""
    sj, _, _ = jax_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    st, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    out = {"bench": (jax_pack(sj), torch_pack(st))}
    sj, st = jproc.generate_scan_apartment(**SCAN_KW), tproc.generate_scan_apartment(**SCAN_KW)
    out["scan128"] = (jax_pack([sj]), torch_pack([st]))
    out["scan256"] = (jax_pack([sj], force_scan_tables=True), torch_pack([st], force_scan_tables=True))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _poses(n, seed, centre=(5.0, 1.25, 5.0), spread=2.0, pitch=0.2):
    rng = np.random.RandomState(seed)
    pos = (np.array([centre]) + rng.uniform(-spread, spread, (n, 3)) * [1, 0, 1]).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return pos, yaw, rng.uniform(-pitch, pitch, n).astype(np.float32)


def _rays(projection, yaw, pitch, H, W, pos):
    """JAX world rays (N, H*W, 3) and their origins."""
    if projection == "equirect":
        fn = lambda y, p: jgeo.equirect_rays(y, p, H, W)
    else:
        fn = lambda y, p: jgeo.camera_rays(y, p, jnp.deg2rad(90.0), H, W)
    d = np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(yaw), jnp.asarray(pitch))).reshape(len(yaw), -1, 3)
    return np.broadcast_to(pos[:, None, :], d.shape).copy(), d


def _assert_same_winner(hit_j, hit_p, same, t_j, t_p):
    np.testing.assert_array_equal(hit_j, hit_p)
    assert 0.2 < hit_j.mean() < 1.0, "cameras should see geometry and sky"
    assert same[hit_j].mean() >= 0.999
    assert np.abs(t_j[same] - t_p[same]).max() < 1e-4


# ---- #8: raycast_batch ------------------------------------------------------


@pytest.mark.parametrize(
    "projection,H,W,ray_tile,tri_chunk",
    [("equirect", 32, 128, 2048, 128),  # two ray tiles
     ("pinhole", 20, 30, 2048, 128),  # untiled: R = 600 < 2048
     ("equirect", 32, 64, 1024, 64)],  # chunks of 64
)
def test_raycast_batch_matches_pallas(packs, jref, projection, H, W, ray_tile, tri_chunk):
    pj, pt = packs["bench"]
    n = 2
    pos, yaw, pitch = _poses(n, 1, pitch=0.6)
    sids = np.arange(n, dtype=np.int32) % 2
    o, d = _rays(projection, yaw, pitch, H, W, pos)
    with pltpu.force_tpu_interpret_mode():
        t_j, a_j = jref["batch"](pj.tri_mat, pj.tri_attr, jnp.asarray(sids), jnp.asarray(o), jnp.asarray(d),
                                 ray_tile=ray_tile, tri_chunk=tri_chunk)
    feat_j = np.asarray(jref["features"](jnp.asarray(o), jnp.asarray(d)))
    feat = trc.ray_features(_t(o), _t(d))
    np.testing.assert_allclose(feat.numpy(), feat_j, rtol=0, atol=1e-6)
    before = trk.raycast_index.launches
    t_p, a_p = trk.raycast_batch(pt.tri_mat, pt.tri_attr, _t(sids), _t(o), _t(d), ray_tile=ray_tile,
                                 tri_chunk=tri_chunk)
    assert trk.raycast_index.launches == before  # CPU tensors: the plain version
    t_j, a_j, t_p, a_p = np.asarray(t_j), np.asarray(a_j), t_p.numpy(), a_p.numpy()
    assert t_p.shape == (n, H * W) and a_p.shape == (n, H * W, 8)
    hit_j, hit_p = a_j[..., 7] > 0.5, a_p[..., 7] > 0.5
    same = hit_j & hit_p & (np.abs(a_j - a_p) <= 1e-6).all(-1)
    _assert_same_winner(hit_j, hit_p, same, t_j, t_p)
    np.testing.assert_array_equal(t_p[~hit_p], 1e6)
    assert not a_p[~hit_p].any()
    # the index kernel's own output: idx equal where the attributes are
    t_i, i_p = trk.raycast_index(pt.tri_mat, _t(sids), feat, ray_tile=ray_tile, tri_chunk=tri_chunk)
    np.testing.assert_array_equal(t_i.numpy(), t_p)
    assert i_p.dtype == torch.int32 and ((i_p.numpy() >= 0) == hit_p).all()


def test_raycast_index_rejects_untileable_rays(packs):
    """ray_tile = min(ray_tile, R) must divide R, as the JAX function asserts."""
    pt = packs["bench"][1]
    feat = torch.zeros(1, 3072, 10)
    with pytest.raises(ValueError, match="ray tile"):
        trk.raycast_index(pt.tri_mat, torch.zeros(1, dtype=torch.int32), feat)
    with pytest.raises(ValueError, match="tri_mat"):  # chunks of 96 do not split 128 triangles
        trk.raycast_index(pt.tri_mat, torch.zeros(1, dtype=torch.int32), torch.zeros(1, 1024, 10), tri_chunk=96)


# ---- #9: raycast_culled -------------------------------------------------------


def _culled_case(pj, n, seed, H=32, W=64):
    pos, yaw, pitch = _poses(n, seed, centre=(3.0, 1.25, 3.0), spread=1.0, pitch=0.6)
    sids = np.zeros(n, np.int32)
    o, d = _rays("equirect", yaw, pitch, H, W, pos)
    ids = np.asarray(jrc.select_chunks_occluded(
        pj.tri_mat, pj.chunk_bounds[jnp.asarray(sids)], jnp.asarray(sids), jnp.asarray(o), jnp.asarray(d), 1024,
        CULL_K))
    return sids, o, d, ids


def _split_ids(ids, parts):
    """Chunk ids of C triangles as ids of C / parts: c -> parts*c, ..., parts*c + parts - 1."""
    return (ids[..., None] * parts + np.arange(parts)).reshape(*ids.shape[:2], -1).astype(np.int32)


@pytest.mark.parametrize(
    "scene,tri_chunk,parts",
    [("scan128", 128, 1),  # the pack's own chunk
     ("scan256", 128, 2),  # 128-triangle ids on a 256-triangle pack
     ("scan128", 64, 2)],  # chunks of 64 on a 128-triangle pack
)
def test_raycast_culled_matches_pallas(packs, jref, scene, tri_chunk, parts):
    pj, pt = packs[scene]
    n = 2
    sids, o, d, ids = _culled_case(pj, n, 3)
    ids = _split_ids(ids, parts)
    with pltpu.force_tpu_interpret_mode():
        t_j, a_j = jref["culled"](pj.tri_mat, pj.tri_attr, jnp.asarray(ids), jnp.asarray(sids), jnp.asarray(o),
                                  jnp.asarray(d), ray_tile=1024, tri_chunk=tri_chunk)
    before = trk.raycast_culled.launches
    t_p, a_p = trk.raycast_culled(pt.tri_mat, pt.tri_attr, _t(ids), _t(sids), _t(o), _t(d), ray_tile=1024,
                                  tri_chunk=tri_chunk)
    assert trk.raycast_culled.launches == before
    t_j, a_j, t_p, a_p = np.asarray(t_j), np.asarray(a_j), t_p.numpy(), a_p.numpy()
    assert a_p.shape == a_j.shape == (n, 2048, 8)
    hit_j, hit_p = a_j[..., 7] > 0.5, a_p[..., 7] > 0.5
    same = hit_j & hit_p & (np.abs(a_j - a_p) <= 1e-6).all(-1)
    _assert_same_winner(hit_j, hit_p, same, t_j, t_p)
    np.testing.assert_array_equal(t_p[~hit_p], 1e6)
    assert not a_p[~hit_p].any()


def test_culled_split_ids_equal_culled_t(packs):
    """A pack's 256-triangle ids split into 128-triangle ones (c -> 2c, 2c+1)
    test the same triangles in the same order: #9 gives #7's t and
    attributes on every ray."""
    pj, pt = packs["scan256"]
    sids, o, d, ids = _culled_case(pj, 2, 4)
    t7, a7 = trk.raycast_culled_t(pt.tri_mat, pt.tri_attr.transpose(1, 2).contiguous(), _t(ids), _t(sids),
                                  trc.ray_features_t(_t(o), _t(d), 1024), ray_tile=1024, tri_chunk=256)
    t9, a9 = trk.raycast_culled(pt.tri_mat, pt.tri_attr, _t(_split_ids(ids, 2)), _t(sids), _t(o), _t(d),
                                ray_tile=1024, tri_chunk=128)
    assert (a7[:, 7] > 0.5).float().mean() > 0.2
    torch.testing.assert_close(t9, t7, rtol=0, atol=0)
    torch.testing.assert_close(a9, a7.transpose(1, 2), rtol=0, atol=0)


# ---- #10: raycast_tilecull_t ------------------------------------------------


def _pinhole_inputs(pj, sids, pos, yaw, pitch, H, W, C):
    """The pinhole kernel inputs as the JAX package builds them."""
    d_cam = jgeo.camera_rays(jnp.float32(0), jnp.float32(0), jnp.deg2rad(90.0), H, W).reshape(-1, 3)
    d_aug = jnp.concatenate([d_cam, jnp.ones((H * W, 1), jnp.float32)], -1)
    rt = min(2048, H * W)
    nt = H * W // rt
    d_t = jnp.pad(d_aug.reshape(nt, rt, 4).transpose(0, 2, 1), ((0, 0), (0, 4), (0, 0)))
    B = jrc.ray_feature_matrix(jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch))
    Bt = jnp.pad(B.transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))
    planes = jnp.asarray(jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, rt // W, W))
    ids, cnt = jrc.select_chunks_frustum(
        pj.tri_v0, pj.tri_e1, pj.tri_e2, pj.tri_valid, jnp.asarray(sids), jnp.asarray(pos), jnp.asarray(yaw),
        jnp.asarray(pitch), planes, tri_chunk=C)
    gm = jrp.group_tri_mat(pj.tri_mat, tri_chunk=C)
    return [np.asarray(x) for x in (gm, ids, cnt, d_t, Bt)] + [rt]


@pytest.mark.parametrize("C", [32, 64])
def test_tilecull_matches_pallas(packs, jref, C):
    pj, pt = packs["bench"]
    n, H, W = 3, 64, 64
    pos, yaw, pitch = _poses(n, 5, pitch=0.7)
    sids = np.arange(n, dtype=np.int32) % 2
    gm, ids, cnt, d_t, Bt, rt = _pinhole_inputs(pj, sids, pos, yaw, pitch, H, W, C)
    K = ids.shape[2]
    assert (cnt > 0).all() and ((cnt < K).any() or C != 32), "a tile with cnt < K and a duplicate-padded tail"
    tail = np.arange(K) >= cnt[..., None]
    assert (ids[tail] == np.take_along_axis(ids, (cnt[..., None] - 1).clip(0), -1).repeat(K, -1)[tail]).all()
    with pltpu.force_tpu_interpret_mode():
        a16_j = jref["attr16"](pj.tri_attr, pj.tri_v0, tri_chunk=C)
        t_j, a_j = jref["tilecull"](jnp.asarray(gm), a16_j, jnp.asarray(ids), jnp.asarray(cnt), jnp.asarray(sids),
                                    jnp.asarray(d_t), jnp.asarray(Bt), ray_tile=rt, tri_chunk=C)
    a16 = trk.attr16_table(pt.tri_attr, pt.tri_v0, tri_chunk=C)
    np.testing.assert_array_equal(a16.numpy(), np.asarray(a16_j))
    before = trk.raycast_tilecull_t.launches
    t_p, a_p = trk.raycast_tilecull_t(_t(gm), a16, _t(ids), _t(cnt), _t(sids), _t(d_t), _t(Bt), ray_tile=rt,
                                      tri_chunk=C)
    assert trk.raycast_tilecull_t.launches == before
    t_j, a_j, t_p, a_p = np.asarray(t_j), np.asarray(a_j), t_p.numpy(), a_p.numpy()
    assert a_p.shape == a_j.shape == (n, H * W // rt, 16, rt)
    hit_j, hit_p = a_j[:, :, 11] > 0.5, a_p[:, :, 11] > 0.5
    same = hit_j & hit_p & (a_j[:, :, 6] == a_p[:, :, 6])  # gid
    _assert_same_winner(hit_j.reshape(n, -1), hit_p.reshape(n, -1), same.reshape(n, -1), t_j, t_p)
    # every row, row 12 (the shade, 0.35 on a miss) included, where the winner is the same
    rows_j, rows_p = a_j.transpose(0, 1, 3, 2), a_p.transpose(0, 1, 3, 2)  # (n, nt, rt, 16)
    assert np.abs(rows_j[same] - rows_p[same]).max() <= 1e-6
    miss = ~hit_p
    assert miss.any()
    np.testing.assert_allclose(rows_p[miss][:, 12], 0.35, rtol=0, atol=1e-6)
    assert not np.delete(rows_p[miss], 12, axis=1).any()
    np.testing.assert_array_equal(t_p.reshape(n, -1)[miss.reshape(n, -1)], 1e6)
    # the same winner as the frustum-selected kernel on the same inputs
    t1, i1 = trk.raycast_fused_sel_t(_t(gm), _t(sids), _t(ids), _t(cnt), _t(d_t), _t(Bt), ray_tile=rt, tri_chunk=C)
    gid = np.where(hit_p, a_p[:, :, 6], -1).reshape(n, -1)
    np.testing.assert_array_equal(gid, i1.numpy())
