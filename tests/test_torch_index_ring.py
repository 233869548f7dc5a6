"""The frustum-selected kernel (#1 ``raycast_fused_sel_t``) and the index
kernel (#3 ``raycast_index_t``) at the edges of their ring design, on the
CPU: the port's plain versions (what the wrappers take for CPU tensors)
against the JAX package's Pallas kernels under
``pltpu.force_tpu_interpret_mode()``, on the same numpy-seeded inputs.

- #1: each tile lists every chunk of the bench scene in a seeded order, cut
  to ``cnt`` slots for ``cnt`` in {0, 1, 2, 3, K} (K the list's length, the
  scene's four chunks of 32; the tail repeats the last listed chunk, as the
  selection pads it): fewer, as many and more chunks than the ring's depth
  ``RING_STAGES``, and the whole list.
- #3: the bench room with a seeded triangle soup inside, T in {128, 256,
  384} (one, two and three chunks of 128: an odd count against the ring's
  depth), and untiled slabs of 600 and 1600 rays (20x30 and 40x40
  equirect), which are not multiples of the kernels' 1024-ray blocks.

Tolerance (that of tests/test_torch_stream_ring.py): hit/miss equal, winner
ids equal on >= 99.9% of hits (shared-edge near-ties), |dt| < 5e-3 m on
equal winners (float32 determinants summed in another order), t = 1e6 on
every miss.

- The inside-pair counters of the plain versions (the pairs whose ray's line
  meets a triangle, for which the ring kernels sum tnum), on a two-tile
  input, against a count by hand.
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
from habitat_tpu.sims.scene import pack_scenes as jax_pack
from habitat_tpu.utils import geometry as jgeo
from habitat_tpu.utils.geometry import camera_rays as jax_camera_rays

from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from tests.torch_jax_native import _jax_native  # noqa: F401

N = 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_agree(t_j, i_j, t_p, i_p, min_hit):
    t_j, i_j = np.asarray(t_j), np.asarray(i_j)
    t_p, i_p = t_p.numpy(), i_p.numpy()
    hit_j, hit_p = i_j >= 0, i_p >= 0
    np.testing.assert_array_equal(hit_j, hit_p)
    np.testing.assert_array_equal(t_p[~hit_p], 1e6)
    if min_hit == 0:
        assert not hit_p.any()
        return
    assert hit_p.mean() > min_hit, "the cameras should see geometry"
    assert (i_j[hit_j] == i_p[hit_j]).mean() >= 0.999
    same = hit_j & (i_j == i_p)
    assert np.abs(t_j[same] - t_p[same]).max() < 5e-3


@pytest.fixture(scope="module")
def bench():
    """The JAX pack of two bench scenes (86 triangles each, T = 128) and
    N = 2 poses inside their rooms."""
    scenes, episodes, _ = jax_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    rng = np.random.RandomState(3)
    pos = np.stack([e.start_position for e in episodes]).astype(np.float32)
    pos[:, 1] += 1.25
    return dict(pack=jax_pack(scenes), pos=pos, yaw=rng.uniform(-np.pi, np.pi, N).astype(np.float32),
                sids=np.arange(N, dtype=np.int32))


# ---- #1: the listed chunks at the ring's edges --------------------------------


@pytest.fixture(scope="module")
def fused_sel_ref(bench):
    """#1's inputs at 64x64 (two tiles of 2048 rays): every tile lists the
    scene's K chunks of 32 in a seeded order; the Pallas kernel, jitted once."""
    H = W = 64
    d_cam = jax_camera_rays(jnp.float32(0), jnp.float32(0), jnp.deg2rad(90.0), H, W).reshape(-1, 3)
    d_aug = jnp.concatenate([d_cam, jnp.ones((H * W, 1), jnp.float32)], -1)
    d_t = jnp.pad(d_aug.reshape(2, 2048, 4).transpose(0, 2, 1), ((0, 0), (0, 4), (0, 0)))
    B = jrc.ray_feature_matrix(jnp.asarray(bench["pos"]), jnp.asarray(bench["yaw"]), jnp.zeros(N, jnp.float32))
    Bt = jnp.pad(B.transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))
    gm = jrp.group_tri_mat(bench["pack"].tri_mat, tri_chunk=32)
    K = gm.shape[2] // 4 // 32
    rng = np.random.RandomState(5)
    ids = np.stack([np.stack([rng.permutation(K) for _ in range(2)]) for _ in range(N)]).astype(np.int32)
    sids = jnp.asarray(bench["sids"])
    fn = jax.jit(lambda ch, c: jrp.raycast_pallas_fused_sel_t(gm, sids, ch, c, d_t, Bt, ray_tile=2048, tri_chunk=32))
    return dict(fn=fn, ids=ids, K=K, gm=np.asarray(gm), d_t=np.asarray(d_t), Bt=np.asarray(Bt))


def _cnt_cases():
    """{0, 1, 2, 3} and the whole list ("K")."""
    return [0, 1, 2, 3, "K"]


@pytest.mark.parametrize("cnt_case", _cnt_cases())
def test_fused_sel_plain_matches_pallas_at_ring_edges(fused_sel_ref, bench, cnt_case):
    r = fused_sel_ref
    assert r["K"] == 4 and trk.RING_STAGES == 2
    n = r["K"] if cnt_case == "K" else cnt_case
    ids = r["ids"].copy()
    if 0 < n < r["K"]:
        ids[..., n:] = ids[..., n - 1:n]
    cnt = np.full(ids.shape[:2], n, np.int32)
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = r["fn"](jnp.asarray(ids), jnp.asarray(cnt))
    before = trk.raycast_fused_sel_t.launches
    t_p, i_p = trk.raycast_fused_sel_t(_t(r["gm"]), _t(bench["sids"]), _t(ids), _t(cnt), _t(r["d_t"]),
                                       _t(r["Bt"]), ray_tile=2048, tri_chunk=32)
    assert trk.raycast_fused_sel_t.launches == before  # CPU tensors: the plain version
    # one of the room's four chunks of 32 covers a few per cent of the view
    _assert_agree(t_j, i_j, t_p, i_p, min_hit=0.0 if n == 0 else 0.3 if n == r["K"] else 0.01)


# ---- #3: every chunk, one to three of them, and ragged slabs --------------------


def _room_with_soup(bench, T, seed):
    """(S, 10, 4, T): each bench room (its 128 triangles, the padding
    included) and T - 128 seeded triangles of 0.1-0.6 m around the camera of
    the env that renders it."""
    tm = np.asarray(bench["pack"].tri_mat)
    k = T - tm.shape[3]
    if k == 0:
        return tm
    rng = np.random.RandomState(seed)
    soup = []
    for cam in bench["pos"]:  # env s renders scene s
        v0 = (cam + rng.uniform(-2.0, 2.0, (k, 3)) * [1.0, 0.5, 1.0]).astype(np.float32)
        e1, e2 = (rng.normal(0, 0.3, (k, 3)).astype(np.float32) for _ in range(2))
        soup.append(jrc.build_tri_matrix(v0, e1, e2, np.ones(k, bool)))
    return np.concatenate([tm, np.stack(soup)], axis=3)


def _equirect_features(bench, H, W, rt):
    d = np.asarray(jax.vmap(lambda y: jgeo.equirect_rays(y, jnp.float32(0.0), H, W))(jnp.asarray(bench["yaw"])))
    d = d.reshape(N, -1, 3)
    o = np.broadcast_to(bench["pos"][:, None, :], d.shape).copy()
    return np.asarray(jax.jit(jrc.ray_features_t, static_argnums=2)(jnp.asarray(o), jnp.asarray(d), rt))


def _index_case(bench, tri_mat, feat, rt):
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = jax.jit(jrp.raycast_pallas_index_t, static_argnames="ray_tile")(
            jnp.asarray(tri_mat), jnp.asarray(bench["sids"]), jnp.asarray(feat), ray_tile=rt)
    before = trk.raycast_index_t.launches
    t_p, i_p = trk.raycast_index_t(_t(tri_mat), _t(bench["sids"]), _t(feat), ray_tile=rt)
    assert trk.raycast_index_t.launches == before  # CPU tensors: the plain version
    assert t_p.shape == (N, feat.shape[1] * rt)
    _assert_agree(t_j, i_j, t_p, i_p, min_hit=0.5)  # the rooms have no ceiling
    return i_p


@pytest.mark.parametrize("T", [128, 256, 384])
def test_index_plain_matches_pallas_over_chunk_counts(bench, T):
    tri_mat = _room_with_soup(bench, T, seed=T)
    i_p = _index_case(bench, tri_mat, _equirect_features(bench, 32, 64, 2048), 2048)
    if T > 128:  # the soup wins somewhere, so the later chunks are walked
        assert (i_p >= 128).any()


@pytest.mark.parametrize("H,W", [(20, 30), (40, 40)])
def test_index_plain_matches_pallas_on_ragged_slabs(bench, H, W):
    R = H * W
    assert R % trk.RING_BLOCK_RAYS and R % 2048
    _index_case(bench, np.asarray(bench["pack"].tri_mat), _equirect_features(bench, H, W, R), R)


# ---- the inside-pair counters --------------------------------------------------


def _counter_scene():
    """Two tiles of 32x32 rays d = (x, y, -1) from the origin (row-major in
    the tile, y > 0 on rows 0-15) and 64 triangles: 0 a plane at z = -1 under
    every ray, 1 a plane at z = +1 behind every ray, 32 a plane at z = -2
    under the rows y > 0, the rest zero padding. Returns (tri_mat (1, 10, 4,
    64), d (1024, 3))."""
    v0 = np.zeros((64, 3), np.float32)
    e1 = np.zeros((64, 3), np.float32)
    e2 = np.zeros((64, 3), np.float32)
    valid = np.zeros(64, bool)
    big = ((3000, 0, 0), (0, 3000, 0))
    v0[0], (e1[0], e2[0]) = (-1000, -1000, -1), big
    v0[1], (e1[1], e2[1]) = (-1000, -1000, 1), big
    v0[32], e1[32], e2[32] = (-1000, 0, -2), (2000, 0, 0), (0, 1000, 0)
    valid[[0, 1, 32]] = True
    row, col = np.divmod(np.arange(1024), 32)
    d = np.stack([(col - 15.5) / 16, (15.5 - row) / 16, -np.ones(1024)], -1).astype(np.float32)
    return trc.build_tri_matrix(v0, e1, e2, valid)[None], d


@pytest.mark.parametrize("kernel", ["raycast_fused_sel_t", "raycast_fused_t", "raycast_index_t", "raycast_index"])
def test_inside_counters_match_hand_count(kernel):
    """Tile 0 lists chunks (0, 1) of 32, tile 1 lists (1, 0) with cnt 1 (#1);
    the other kernels walk both chunks for both tiles. Inside pairs (the
    line, not the ray, meets a non-degenerate triangle): triangles 0 and 1
    for every ray, triangle 32 for rows 0-15, padding never: 2560 per tile
    and chunk list, 512 for tile 1 of #1. Hits: t = 1 on triangle 0 (the
    plane behind is inside but fails t > TMIN); tile 1 of #1, t = 2 on
    triangle 32 on rows 0-15 and a miss below."""
    tm, d = _counter_scene()
    tri_mat = torch.from_numpy(tm)
    sids = torch.zeros(1, dtype=torch.int32)
    dd = torch.from_numpy(np.concatenate([d, d]))  # (2048, 3): two tiles
    tested = {}
    if kernel in ("raycast_fused_sel_t", "raycast_fused_t"):
        d_t = torch.nn.functional.pad(torch.cat([dd, torch.ones(2048, 1)], 1).reshape(2, 1024, 4).transpose(1, 2),
                                      (0, 0, 0, 4)).contiguous()  # (2, 8, 1024)
        Bt = torch.zeros(1, 16, 4)
        Bt[0, 0, 0] = Bt[0, 1, 1] = Bt[0, 2, 2] = Bt[0, 9, 3] = 1.0  # F = [d, 0, 0, 1]
        gm = trc.group_tri_mat(tri_mat, 32).contiguous()
        if kernel == "raycast_fused_sel_t":
            ids = torch.tensor([[[0, 1], [1, 0]]], dtype=torch.int32)
            cnt = torch.tensor([[2, 1]], dtype=torch.int32)
            t, idx = trk.raycast_fused_sel_t.plain(gm, sids, ids, cnt, d_t, Bt, 1024, 32, tested=tested)
        else:
            t, idx = trk.raycast_fused_t.plain(gm, sids, d_t, Bt, 1024, 32, tested=tested)
    else:
        feat = trc.ray_features(torch.zeros(1, 2048, 3), dd[None])  # (1, 2048, 10)
        if kernel == "raycast_index_t":
            feat_t = torch.nn.functional.pad(feat.reshape(1, 2, 1024, 10).transpose(2, 3), (0, 0, 0, 6))
            t, idx = trk.raycast_index_t.plain(tri_mat, sids, feat_t.contiguous(), 1024, tested=tested)
        else:
            t, idx = trk.raycast_index.plain(tri_mat, sids, feat, 2048, tested=tested)
    t, idx = t.reshape(2, 1024), idx.reshape(2, 1024)
    assert torch.equal(t[0], torch.ones(1024)) and (idx[0] == 0).all()
    if kernel == "raycast_fused_sel_t":
        assert tested == dict(inside=2560 + 512)
        assert torch.equal(t[1, :512], torch.full((512,), 2.0)) and (idx[1, :512] == 32).all()
        assert (t[1, 512:] == 1e6).all() and (idx[1, 512:] == -1).all()
    else:
        assert tested == dict(inside=2 * 2560)
        assert torch.equal(t[1], torch.ones(1024)) and (idx[1] == 0).all()
