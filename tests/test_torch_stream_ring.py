"""The stream kernels (#4 ``raycast_exactsel_t``, #5 ``raycast_stream_t``)
and the culled kernel (#7 ``raycast_culled_t``) at the edges of their rings,
on the CPU: the port's plain versions (what the wrappers take for CPU
tensors) against the JAX package's Pallas kernels under
``pltpu.force_tpu_interpret_mode()``, on the same inputs.

- #4 and #5: the lists of a small scan apartment cut to ``cnt`` slots, for
  ``cnt`` in {0, 1, S - 1, S, S + 1, K}, S the stream kernel's ring depth
  (``STREAM_STAGES``) and K the list's length. Tolerance: hit/miss equal,
  winner ids equal on >= 99.9% of hits (shared-edge near-ties), |dt| < 5e-3
  m on equal winners (float32 determinants summed in another order).
- #7: a list of odd length (not a multiple of the ring depth
  ``RING_STAGES``) with invalid ids (-1 and T / C) inserted. The kernels
  skip such ids; the Pallas kernel has no rule for them, so its reference
  list repeats the previous valid id in their place, which cannot change a
  strict-< winner. The same tolerance, with the 8 attributes equal where the
  winner is; a list of invalid ids only misses on every ray.
- The early-stop counters of the stream kernels' plain versions, on a
  two-tile list with known dmins, against a count by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.ops import raycast as jrc
from habitat_tpu.ops import raycast_pallas as jrp
from habitat_tpu.sims import procedural as jproc
from habitat_tpu.sims.scene import pack_scenes as jax_pack
from habitat_tpu.utils import geometry as jgeo
from habitat_tpu.utils.geometry import camera_rays as jax_camera_rays

from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from habitat_torch.sims import procedural as tproc
from habitat_torch.sims.scene import pack_scenes as torch_pack
from tests.torch_jax_native import _jax_native  # noqa: F401

SCAN_KW = dict(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
N, H, W = 2, 32, 32
S = trk.STREAM_STAGES


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
def scan():
    """The scan apartment packed with the scan layout (chunks of 256) and in
    plain chunks of 128 by both packages, N = 2 poses of one 32x32 tile,
    and the stream kernels' ray inputs (from the JAX package)."""
    sj, st = jproc.generate_scan_apartment(**SCAN_KW), tproc.generate_scan_apartment(**SCAN_KW)
    rng = np.random.RandomState(11)
    pos = (np.array([[3.0, 1.25, 3.0]]) + rng.uniform(-1, 1, (N, 3)) * [1, 0, 1]).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    d_cam = jax_camera_rays(jnp.float32(0), jnp.float32(0), jnp.deg2rad(90.0), H, W).reshape(-1, 3)
    d_aug = jnp.concatenate([d_cam, jnp.ones((H * W, 1), jnp.float32)], -1)
    d_t = jnp.pad(d_aug.reshape(1, 1024, 4).transpose(0, 2, 1), ((0, 0), (0, 4), (0, 0)))
    B = jrc.ray_feature_matrix(jnp.asarray(pos), jnp.asarray(yaw), jnp.zeros(N, jnp.float32))
    d = np.stack([
        np.asarray(jax_camera_rays(jnp.float32(y), jnp.float32(0.0), jnp.deg2rad(90.0), H, W)).reshape(-1, 3)
        for y in yaw
    ])
    return dict(
        p256=(jax_pack([sj], force_scan_tables=True), torch_pack([st], force_scan_tables=True)),
        p128=(jax_pack([sj]), torch_pack([st])),
        pos=pos, yaw=yaw, sids=np.zeros(N, np.int32), d_t=np.asarray(d_t),
        Bt=np.asarray(jnp.pad(B.transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))),
        o=np.broadcast_to(pos[:, None, :], d.shape).copy(), d=d,
    )


@pytest.fixture(scope="module")
def exactsel_ref(scan):
    """#4's inputs (the exact-culled chunklet lists) and its Pallas kernel,
    jitted once."""
    pj = scan["p256"][0]
    sids = jnp.asarray(scan["sids"])
    ids0, cnt0 = jrc.select_chunks(pj.chunk_bounds[sids], jnp.asarray(scan["o"]), jnp.asarray(scan["d"]), 1024, 64,
                                   with_cnt=True)
    planes = jnp.asarray(jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, 32, 32))
    ids, cnt = jrc.select_chunklets_exact(
        pj.tri_v0, pj.tri_e1, pj.tri_e2, pj.tri_valid, pj.chunklet_ab32, sids, jnp.asarray(scan["pos"]),
        jnp.asarray(scan["yaw"]), jnp.zeros(N, jnp.float32), planes, ids0, cnt0, parent_c=256, c=32,
        verts16=pj.tri_verts16,
    )
    fn = jax.jit(lambda ch, c: jrp.raycast_pallas_exactsel_t(
        pj.tri_mat_g32, sids, ch, c, jnp.asarray(scan["d_t"]), jnp.asarray(scan["Bt"]), ray_tile=1024,
        tri_chunk=32))
    return dict(ids=np.asarray(ids), cnt=np.asarray(cnt), fn=fn, mat=scan["p256"][1].tri_mat_g32, C=32)


@pytest.fixture(scope="module")
def stream_ref(scan):
    """#5's inputs (the occlusion-bounded parent chunks of 256, nearest
    first) and its Pallas kernel, jitted once."""
    pj = scan["p256"][0]
    sids = jnp.asarray(scan["sids"])
    ids, cnt = jrc.select_chunks_occluded(pj.tri_mat, pj.chunk_bounds[sids], sids, jnp.asarray(scan["o"]),
                                          jnp.asarray(scan["d"]), 1024, 12, with_cnt=True)
    gm = jrp.group_tri_mat_pad16(pj.tri_mat, 256)
    fn = jax.jit(lambda ch, c: jrp.raycast_pallas_stream_t(
        gm, sids, ch, c, jnp.asarray(scan["d_t"]), jnp.asarray(scan["Bt"]), ray_tile=1024, tri_chunk=256))
    mat = trc.group_tri_mat(scan["p256"][1].tri_mat, 256).contiguous()
    return dict(ids=np.asarray(ids), cnt=np.asarray(cnt), fn=fn, mat=mat, C=256)


def _cnt_cases():
    """{0, 1, S - 1, S, S + 1, K} as labels; K is the list's length."""
    return sorted({0, 1, S - 1, S, S + 1}) + ["K"]


def _stream_case(ref, scan, wrapper, cnt_case):
    """The list cut to ``cnt_case`` slots and padded as the selections pad
    it (the tail repeats the last survivor: the Pallas kernels test slots in
    groups and may read a few beyond cnt)."""
    K = ref["ids"].shape[2]
    n = K if cnt_case == "K" else cnt_case
    assert n <= K
    cnt = np.full_like(ref["cnt"], n)
    ids = ref["ids"].copy()
    if 0 < n < K:
        ids[..., n:] = ids[..., n - 1:n]
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = (np.asarray(x) for x in ref["fn"](jnp.asarray(ids), jnp.asarray(cnt)))
    before = wrapper.launches
    t_p, i_p = wrapper(ref["mat"], _t(scan["sids"]), _t(ids), _t(cnt), _t(scan["d_t"]), _t(scan["Bt"]),
                       ray_tile=1024, tri_chunk=ref["C"])
    assert wrapper.launches == before  # CPU tensors: the plain version
    t_p, i_p = t_p.numpy(), i_p.numpy()
    hit_j, hit_p = i_j >= 0, i_p >= 0
    np.testing.assert_array_equal(hit_j, hit_p)
    np.testing.assert_array_equal(t_p[~hit_p], 1e6)
    if n == 0:
        assert not hit_p.any()
        return
    assert hit_p.any()
    assert (i_j[hit_j] == i_p[hit_j]).mean() >= 0.999
    same = hit_j & (i_j == i_p)
    assert np.abs(t_j[same] - t_p[same]).max() < 5e-3


@pytest.mark.parametrize("cnt_case", _cnt_cases())
def test_exactsel_plain_matches_pallas_at_ring_edges(exactsel_ref, scan, cnt_case):
    assert exactsel_ref["ids"].shape[2] > S + 1
    _stream_case(exactsel_ref, scan, trk.raycast_exactsel_t, cnt_case)


@pytest.mark.parametrize("cnt_case", _cnt_cases())
def test_stream_plain_matches_pallas_at_ring_edges(stream_ref, scan, cnt_case):
    assert stream_ref["ids"].shape[2] > S + 1
    _stream_case(stream_ref, scan, trk.raycast_stream_t, cnt_case)


@pytest.fixture(scope="module")
def culled_ref(scan):
    """#7's inputs on the chunk-128 pack: each raster-order 1024-ray tile's 7
    occlusion-bounded chunks and the transposed ray features of 32x64
    equirect images, and its Pallas kernel, jitted once."""
    pj = scan["p128"][0]
    sids = jnp.asarray(scan["sids"])
    d = np.asarray(jax.vmap(lambda y: jgeo.equirect_rays(y, jnp.float32(0.0), 32, 64))(jnp.asarray(scan["yaw"])))
    d = d.reshape(N, -1, 3)
    o = np.broadcast_to(scan["pos"][:, None, :], d.shape).copy()
    ids = jrc.select_chunks_occluded(pj.tri_mat, pj.chunk_bounds[sids], sids, jnp.asarray(o), jnp.asarray(d), 1024, 7)
    feat = jrc.ray_features_t(jnp.asarray(o), jnp.asarray(d), 1024)
    attr_t = jnp.swapaxes(pj.tri_attr, 1, 2)
    fn = jax.jit(lambda ch: jrp.raycast_pallas_culled_t(pj.tri_mat, attr_t, ch, sids, feat, ray_tile=1024,
                                                        tri_chunk=128))
    return dict(ids=np.asarray(ids), feat=np.asarray(feat), attr_t=np.asarray(attr_t), fn=fn,
                n_chunks=pj.tri_mat.shape[3] // 128)


def _with_invalid(ids, where, n_chunks):
    """``ids`` (N, nt, K) with invalid ids inserted: (the port's list, the
    reference list with each invalid id replaced by the previous valid one)."""
    N_, nt, K = ids.shape
    if where == "all":
        bad = np.where(np.arange(K) % 2 == 0, -1, n_chunks)
        return np.broadcast_to(bad, (N_, nt, K)).astype(np.int32).copy(), None
    pos = {"mid": (1, 4), "ends": (0, K + 1)}[where]
    out = list(np.moveaxis(ids, 2, 0))
    out.insert(pos[0], np.full((N_, nt), -1, np.int32))
    out.insert(pos[1], np.full((N_, nt), n_chunks, np.int32))
    got = np.stack(out, 2).astype(np.int32)
    ref = got.copy()
    for k in range(ref.shape[2]):
        bad = (ref[..., k] < 0) | (ref[..., k] >= n_chunks)
        ref[..., k] = np.where(bad, ref[..., k - 1] if k else ref[..., 1], ref[..., k])
    return got, ref


@pytest.mark.parametrize("where", ["mid", "ends", "all"])
def test_culled_plain_skips_invalid_ids(culled_ref, scan, where):
    c = culled_ref
    ids, ref_ids = _with_invalid(c["ids"], where, c["n_chunks"])
    K = ids.shape[2]
    assert K % trk.RING_STAGES != 0 and ((ids < 0) | (ids >= c["n_chunks"])).any()
    before = trk.raycast_culled_t.launches
    t_p, a_p = trk.raycast_culled_t(scan["p128"][1].tri_mat, _t(c["attr_t"]), _t(ids), _t(scan["sids"]),
                                    _t(c["feat"]), ray_tile=1024, tri_chunk=128)
    assert trk.raycast_culled_t.launches == before
    t_p, a_p = t_p.numpy(), a_p.numpy()
    hit_p = a_p[:, 7] > 0.5
    np.testing.assert_array_equal(t_p[~hit_p], 1e6)
    assert not a_p.transpose(0, 2, 1)[~hit_p].any()
    if ref_ids is None:
        assert not hit_p.any()
        return
    with pltpu.force_tpu_interpret_mode():
        t_j, a_j = (np.asarray(x) for x in c["fn"](jnp.asarray(ref_ids)))
    hit_j = a_j[:, 7] > 0.5
    np.testing.assert_array_equal(hit_j, hit_p)
    assert hit_j.mean() > 0.3
    same = hit_j & (a_j == a_p).all(axis=1)
    assert same[hit_j].mean() >= 0.999
    assert np.abs(t_j[same] - t_p[same]).max() < 5e-3


def test_early_stop_counters_match_hand_count():
    """Two tiles of 32x32 rays d = (x, y, -1) from the origin (row-major in
    the tile, y > 0 on rows 0-15) and three 32-triangle chunklets: chunk 0
    holds a plane at z = -1 under every ray, chunk 1 one at z = -2 under the
    rows y > 0, chunk 2 nothing.

    tile 0 lists (chunk 0, dmin 0.5), (1, 1.5), (2, 2.5), cnt 3: slot 0 is
    open everywhere; then every ray holds t = 1 < 1.5. Blocks 4, warps 1024 /
    STREAM_WARP_RAYS, rays 1024.
    tile 1 lists (1, 0.5), (2, 3.0), (0, 3.5), cnt 2: slot 0 is open
    everywhere; rows 0-15 then hold t = 2 < 3.0 and rows 16-31 miss, so slot
    1 is open on rays 512-1023 only: 2 of the 4 blocks, 512 /
    STREAM_WARP_RAYS warps; slot 2 lies beyond cnt. The inside pairs (the
    ray's line meets a triangle) of open rays: 1024 + 512."""
    assert trk.STREAM_BLOCK_RAYS == 256 and 512 % trk.STREAM_WARP_RAYS == 0
    C, n_tri = 32, 96
    v0 = np.zeros((n_tri, 3), np.float32)
    e1 = np.zeros((n_tri, 3), np.float32)
    e2 = np.zeros((n_tri, 3), np.float32)
    valid = np.zeros(n_tri, bool)
    v0[0], e1[0], e2[0] = (-1000, -1000, -1), (3000, 0, 0), (0, 3000, 0)
    v0[C], e1[C], e2[C] = (-1000, 0, -2), (2000, 0, 0), (0, 1000, 0)
    valid[[0, C]] = True
    mat = trc.group_tri_mat(torch.from_numpy(trc.build_tri_matrix(v0, e1, e2, valid))[None], C).contiguous()
    row, col = np.divmod(np.arange(1024), 32)
    d = np.stack([(col - 15.5) / 16, (15.5 - row) / 16, -np.ones(1024), np.ones(1024)]).astype(np.float32)
    d_t = torch.from_numpy(np.pad(np.stack([d, d]), ((0, 0), (0, 4), (0, 0))))  # (2, 8, 1024)
    Bt = torch.zeros(1, 16, 4)
    Bt[0, 0, 0] = Bt[0, 1, 1] = Bt[0, 2, 2] = Bt[0, 9, 3] = 1.0  # F = [d, 0, 0, 1]

    def slot(cid, dmin_cm):
        return (dmin_cm << 18) | cid

    ids = torch.tensor([[[slot(0, 50), slot(1, 150), slot(2, 250)],
                         [slot(1, 50), slot(2, 300), slot(0, 350)]]], dtype=torch.int32)
    cnt = torch.tensor([[3, 2]], dtype=torch.int32)
    tested = dict(block=0, warp=0)
    t, idx = trk.raycast_exactsel_t.plain(mat, torch.zeros(1, dtype=torch.int32), ids, cnt, d_t, Bt, 1024, C,
                                          tested=tested)
    wr = trk.STREAM_WARP_RAYS
    # inside pairs of open rays: tile 0 slot 0, every ray with triangle 0;
    # tile 1 slot 0, rows 0-15 with triangle 32 (padding triangles never)
    assert tested == dict(block=4 + 4 + 2, warp=1024 // wr + 1024 // wr + 512 // wr, inside=1024 + 512)
    t, idx = t.reshape(2, 1024), idx.reshape(2, 1024)
    assert torch.equal(t[0], torch.ones(1024)) and (idx[0] == 0).all()
    assert torch.equal(t[1, :512], torch.full((512,), 2.0)) and (idx[1, :512] == C).all()
    assert (t[1, 512:] == 1e6).all() and (idx[1, 512:] == -1).all()
