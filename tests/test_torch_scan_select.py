"""habitat_torch scan-scale data and selection against habitat_tpu on the CPU.

The fixture is the small scan apartment of tests/test_v14_epilogue.py
(``generate_scan_apartment(seed=5, extent=6.0, n_rooms_per_axis=2,
n_clutter=6, tess=0.35)``), packed with ``force_scan_tables=True`` so that
the scan-only layout (chunk 256, render tables) is reached at a CPU size,
and its LOD build (``build_lod_scene``) for the distance bands. Inputs are
numpy arrays made from seeds and handed to both packages.

Tolerances: host generators bit-equal; pack tables within 1e-6 (float32
sums of three products taken in another order); selections agree in their
counts and in the SET of survivor ids over the first ``cnt`` slots, with
the packed distance within one centimetre step. Orders are not compared: a
top-k or sort tie, and a last-bit difference in arccos, may reorder equal
keys between the two frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.ops import raycast as jrc
from habitat_tpu.ops import raycast_pallas as jrp
from habitat_tpu.sims import procedural as jproc
from habitat_tpu.sims.scene import pack_scenes as jax_pack
from habitat_tpu.utils.geometry import camera_rays as jax_camera_rays
from habitat_tpu.utils.geometry import view_rotation_matrix as jax_view_rotation

from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from habitat_torch.sims import procedural as tproc
from habitat_torch.sims.scene import pack_scenes as torch_pack
from tests.torch_jax_native import _jax_native  # noqa: F401

SCAN_KW = dict(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
LOD_KW = dict(cells=(0.3, 0.8), bands=(1.5, 3.5))
N, H, W = 2, 32, 32
MASK = (1 << 18) - 1
# more than the packs' parent chunks: a camera inside several bounding spheres
# scores them all 0, and which of the tied chunks a smaller K keeps is not
# defined across frameworks
K_ALL = 64
SCENE_FIELDS = ("vertices", "colors", "semantic_ids", "nav_occ", "obst_dist", "nav_lo")


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
def scenes():
    sj, st = jproc.generate_scan_apartment(**SCAN_KW), tproc.generate_scan_apartment(**SCAN_KW)
    return dict(
        scan=(sj, st),
        lod=(jproc.build_lod_scene(sj, **LOD_KW), tproc.build_lod_scene(st, **LOD_KW)),
    )


@pytest.fixture(scope="module")
def packs(scenes):
    return {
        k: (jax_pack([a], force_scan_tables=True), torch_pack([b], force_scan_tables=True))
        for k, (a, b) in scenes.items()
    }


@pytest.fixture(scope="module")
def poses():
    rng = np.random.RandomState(11)
    pos = (np.array([[3.0, 1.25, 3.0]]) + rng.uniform(-1, 1, (N, 3)) * [1, 0, 1]).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    return pos, yaw, np.zeros(N, np.float32), np.zeros(N, np.int32)


def _scene_equal(a, b):
    assert a.scene_id == b.scene_id
    for name in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.nav_res, a.floor_y, a.objects) == (b.nav_res, b.floor_y, b.objects)
    if a.tri_lod is None:
        assert b.tri_lod is None
    else:
        np.testing.assert_array_equal(a.tri_lod, b.tri_lod)
        assert a.lod_ranges == b.lod_ranges


# ---- (a) host generators ---------------------------------------------------


@pytest.mark.parametrize("what", ["scanify", "decimate", "build_lod_scene"])
def test_scan_generators_bit_equal(scenes, what):
    sj, st = scenes["scan"]
    if what == "scanify":
        assert sj.num_triangles > 2000
        _scene_equal(sj, st)
    elif what == "decimate":
        dj, dt = jproc.decimate(sj, 0.3), tproc.decimate(st, 0.3)
        assert 0 < dj.num_triangles < sj.num_triangles
        _scene_equal(dj, dt)
    else:
        _scene_equal(*scenes["lod"])


def test_sample_navigable_point_bit_equal(scenes):
    sj, st = scenes["scan"]
    for island in (False, True):
        a = sj.sample_navigable_point(np.random.default_rng(3), largest_island_only=island)
        b = st.sample_navigable_point(np.random.default_rng(3), largest_island_only=island)
        np.testing.assert_array_equal(a, b)


# ---- (b) pack tables ---------------------------------------------------------


@pytest.mark.parametrize(
    "field",
    ["tri_v0", "tri_e1", "tri_e2", "tri_valid", "tri_mat", "tri_attr", "chunk_bounds",
     "chunklet_ab32", "tri_attr16", "tri_verts16", "tri_mat_g32"],
)
def test_scan_pack_tables(packs, field):
    """The LOD pack: chunk 256, band columns 4:6 of chunk_bounds, and the
    render tables. tri_mat_g32 keeps the 10 real rows of the JAX table,
    whose rows 10:16 are zero padding for the TPU's DMA slices."""
    pj, pt = packs["lod"]
    a, b = np.asarray(getattr(pj, field)), getattr(pt, field).numpy()
    if field == "tri_mat_g32":
        assert a.shape[1] == 16 and b.shape[1] == 10 and not a[:, 10:].any()
        a = a[:, 0:10]
    if field == "chunk_bounds":
        assert pt.tri_mat.shape[3] // b.shape[1] == 256
        assert (b[..., 4] > 0).any() and (b[..., 5] < 1e8).any()  # bands present
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_pack_without_scan_tables(scenes):
    """Below the scan scale and unforced: chunk 128, no tables."""
    pt = torch_pack([scenes["scan"][1]])
    pj = jax_pack([scenes["scan"][0]])
    assert pt.tri_mat_g32 is None and pt.chunklet_ab32 is None
    assert pt.tri_attr16 is None and pt.tri_verts16 is None
    assert pt.tri_mat.shape[3] // pt.chunk_bounds.shape[1] == 128
    np.testing.assert_array_equal(np.asarray(pj.chunk_bounds), pt.chunk_bounds.numpy())
    assert trc.ATTR16_NV0 == jrc.ATTR16_NV0 and trc.VERTS16_VALID == jrc.VERTS16_VALID


def test_chunklet_aabbs_matches(packs):
    pj, pt = packs["scan"]
    for c in (16, 32):
        a = jrc.chunklet_aabbs(pj.tri_v0, pj.tri_e1, pj.tri_e2, pj.tri_valid, c=c)
        b = trc.chunklet_aabbs(pt.tri_v0, pt.tri_e1, pt.tri_e2, pt.tri_valid, c=c)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-6)


# ---- (c) selection -----------------------------------------------------------


def _rays(yaw, pos):
    """World rays in 32x32 block order (one block at 32x32), both packages."""
    d = np.stack([
        np.asarray(jax_camera_rays(jnp.float32(y), jnp.float32(0.0), jnp.deg2rad(90.0), H, W)).reshape(-1, 3)
        for y in yaw
    ])
    o = np.broadcast_to(pos[:, None, :], d.shape).copy()
    return o, d


def _sets_agree(ids_j, cnt_j, ids_t, cnt_t, packed):
    ids_j, cnt_j = np.asarray(ids_j), np.asarray(cnt_j)
    ids_t, cnt_t = ids_t.numpy(), cnt_t.numpy()
    assert ids_j.shape == ids_t.shape and ids_t.dtype == np.int32 and cnt_t.dtype == np.int32
    np.testing.assert_array_equal(cnt_j, cnt_t)
    assert cnt_j.sum() > 0
    for n in range(ids_j.shape[0]):
        for k in range(ids_j.shape[1]):
            a, b = ids_j[n, k, : cnt_j[n, k]], ids_t[n, k, : cnt_t[n, k]]
            if not packed:
                assert set(a.tolist()) == set(b.tolist()), (n, k)
                continue
            da, db = dict(zip((a & MASK).tolist(), (a >> 18).tolist())), dict(zip((b & MASK).tolist(), (b >> 18).tolist()))
            assert da.keys() == db.keys(), (n, k)
            assert all(abs(da[i] - db[i]) <= 1 for i in da), (n, k)  # dmin_cm within one step
            assert (np.diff(b >> 18) >= 0).all(), "survivors ascend in dmin"
            # the tail holds the last survivor's id
            if 0 < cnt_t[n, k] < ids_t.shape[2]:
                assert ((ids_t[n, k, cnt_t[n, k]:] & MASK) == (b[-1] & MASK)).all()


@pytest.mark.parametrize("which", ["scan", "lod"])
def test_select_chunks_matches(packs, poses, which):
    pj, pt = packs[which]
    pos, yaw, pitch, sids = poses
    o, d = _rays(yaw, pos)
    ids_j, cnt_j = jrc.select_chunks(pj.chunk_bounds[sids], jnp.asarray(o), jnp.asarray(d), 1024, K_ALL, with_cnt=True)
    ids_t, cnt_t = trc.select_chunks(pt.chunk_bounds[_t(sids).long()], _t(o), _t(d), 1024, K_ALL, with_cnt=True)
    assert 0 < cnt_t.max() < ids_t.shape[2]  # the cone and the bands cull
    _sets_agree(ids_j, cnt_j, ids_t, cnt_t, packed=False)
    assert trc.select_chunks(pt.chunk_bounds[_t(sids).long()], _t(o), _t(d), 1024, 8).shape == (N, 1, 8)


@pytest.mark.parametrize("which", ["scan", "lod"])
def test_select_chunks_occluded_matches(packs, poses, which):
    """The packed stream list and the depth bound of the low-resolution
    prepass (dmax within 1e-4 m: float32 matrix products summed in another
    order)."""
    pj, pt = packs[which]
    pos, yaw, pitch, sids = poses
    o, d = _rays(yaw, pos)
    pk_j, cnt_j, dmax_j = jrc.select_chunks_occluded(
        pj.tri_mat, pj.chunk_bounds[sids], jnp.asarray(sids), jnp.asarray(o), jnp.asarray(d), 1024, K_ALL,
        with_cnt=True, with_dmax=True,
    )
    pk_t, cnt_t, dmax_t = trc.select_chunks_occluded(
        pt.tri_mat, pt.chunk_bounds[_t(sids).long()], _t(sids), _t(o), _t(d), 1024, K_ALL,
        with_cnt=True, with_dmax=True,
    )
    np.testing.assert_allclose(np.asarray(dmax_j), dmax_t.numpy(), rtol=0, atol=1e-4)
    _sets_agree(pk_j, cnt_j, pk_t, cnt_t, packed=True)
    ids_only = trc.select_chunks_occluded(
        pt.tri_mat, pt.chunk_bounds[_t(sids).long()], _t(sids), _t(o), _t(d), 1024, K_ALL
    )
    for n in range(N):
        c = int(cnt_t[n, 0])
        assert set((pk_t[n, 0, :c] & MASK).tolist()) == set(ids_only[n, 0, :c].tolist())


def _select_inputs(pj, pt, poses, k0=64):
    pos, yaw, pitch, sids = poses
    o, d = _rays(yaw, pos)
    planes = jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, 32, 32)
    ids0, cnt0 = jrc.select_chunks(pj.chunk_bounds[sids], jnp.asarray(o), jnp.asarray(d), 1024, k0, with_cnt=True)
    ids0, cnt0 = np.asarray(ids0), np.asarray(cnt0)
    parent_c = pj.tri_mat.shape[3] // pj.chunk_bounds.shape[1]
    jargs = (pj.tri_v0, pj.tri_e1, pj.tri_e2, pj.tri_valid, pj.chunklet_ab32, jnp.asarray(sids),
             jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch), jnp.asarray(planes),
             jnp.asarray(ids0), jnp.asarray(cnt0))
    targs = (pt.tri_v0, pt.tri_e1, pt.tri_e2, pt.tri_valid, pt.chunklet_ab32, _t(sids),
             _t(pos), _t(yaw), _t(pitch), _t(planes), _t(ids0), _t(cnt0))
    return jargs, targs, parent_c


FLOWS = {
    "packed_exact": dict(verts16=True, k_exact=384),
    "packed_exact_small_cap": dict(verts16=True, k_exact=8),
    "packed_exact_k_final": dict(verts16=True, k_exact=384, k_final=200),
    "l1_only": dict(skip_exact=True),
    "l1_only_k_final": dict(skip_exact=True, k_final=100),
    "capped_l2": dict(skip_exact=False, k_aabb=256, k_final=192),
    "capped_l2_tight": dict(skip_exact=False, k_aabb=48, k_final=32),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_select_chunklets_exact_matches(packs, poses, flow):
    pj, pt = packs["lod"]
    jargs, targs, parent_c = _select_inputs(pj, pt, poses)
    kw = dict(FLOWS[flow], parent_c=parent_c, c=32)
    has_v16 = kw.pop("verts16", False)
    ids_j, cnt_j = jrc.select_chunklets_exact(*jargs, verts16=pj.tri_verts16 if has_v16 else None, **kw)
    ids_t, cnt_t = trc.select_chunklets_exact(*targs, verts16=pt.tri_verts16 if has_v16 else None, **kw)
    _sets_agree(ids_j, cnt_j, ids_t, cnt_t, packed=True)
    if "capped" not in flow:
        assert ids_t.shape[2] % 128 == 0  # the JAX function's shape, kept


def test_packed_exact_flow_on_cpu_takes_plain_mask(packs, poses):
    """On CPU tensors the cull-mask wrapper computes its plain version: the
    packed-exact flow counts no launch, and its list is the one built from
    ``cull_mask_torch`` by hand."""
    pj, pt = packs["lod"]
    _, targs, parent_c = _select_inputs(pj, pt, poses)
    kw = dict(parent_c=parent_c, c=32)
    before = trk.cullmask_t.launches
    ids_a, cnt_a = trc.select_chunklets_exact(*targs, verts16=pt.tri_verts16, k_exact=128, **kw)
    assert trk.cullmask_t.launches == before
    # by hand: the level-1 list, its nearest 128 tested, the rest passed through
    l1, cnt1 = trc.select_chunklets_exact(*targs, skip_exact=True, **kw)
    pos, yaw, pitch, sids = poses
    planes = _t(jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, 32, 32))
    nw = torch.einsum("nij,kpj->nkpi", trc.view_rotation_matrix(_t(yaw), _t(pitch)), planes).contiguous()
    head, cntk = l1[..., :128].contiguous(), cnt1.clamp(max=128)
    mask = trk.cull_mask_torch(pt.tri_verts16, _t(sids), head, cntk, nw, _t(pos))
    keep = (mask > 0.5).any(-1) & (torch.arange(128) < cntk[..., None])
    for n in range(N):
        want = set((head[n, 0][keep[n, 0]] & MASK).tolist()) | set((l1[n, 0, 128:cnt1[n, 0]] & MASK).tolist())
        assert set((ids_a[n, 0, : cnt_a[n, 0]] & MASK).tolist()) == want, n
        assert int(cnt_a[n, 0]) == len(want)


# ---- (e) the cull mask's plain version against the Pallas kernel ---------------


def test_cullmask_plain_matches_pallas(packs, poses):
    """Gated slots (below the head count) agree on >= 99.9% of triangles:
    the TPU form tests v.n against eps + cam.n, rounded differently from the
    direct n.(v - cam) < eps."""
    pj, pt = packs["lod"]
    pos, yaw, pitch, sids = poses
    jargs, targs, parent_c = _select_inputs(pj, pt, poses)
    # a head of the 128 nearest level-1 survivors, from the L1-only flow
    head_j, cnt_j = jrc.select_chunklets_exact(*jargs, parent_c=parent_c, c=32, skip_exact=True, k_final=128)
    head, cntk = np.asarray(head_j), np.asarray(cnt_j)
    assert head.shape[2] == 128 and cntk.max() > 16
    planes = jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, 32, 32)
    nw = np.asarray(jnp.einsum(
        "nij,kpj->nkpi", jax_view_rotation(jnp.asarray(yaw), jnp.asarray(pitch)), jnp.asarray(planes),
        precision="highest",
    ))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrp.cullmask_pallas_t(
            pj.tri_verts16, jnp.asarray(sids), jnp.asarray(head), jnp.asarray(cntk), jnp.asarray(nw), jnp.asarray(pos)
        ))
    before = trk.cullmask_t.launches
    got = trk.cullmask_t(pt.tri_verts16, _t(sids), _t(head), _t(cntk), _t(nw), _t(pos)).numpy()
    assert trk.cullmask_t.launches == before  # CPU tensors: plain version
    assert got.shape == ref.shape == (N, 1, 128, 32) and got.dtype == np.float32
    gate = np.arange(128)[None, None, :] < cntk[..., None]
    assert ((ref > 0.5) == (got > 0.5))[gate].mean() >= 0.999
    assert 0.05 < (got > 0.5)[gate].mean() < 0.95  # the test culls and keeps


def test_cullmask_plain_matches_pallas_at_head_edges(packs, poses):
    """A tile with no gated slot (cntk = 0) and one with every slot gated
    (cntk = ka, the head's tail refilled with its own ids), against the
    Pallas kernel, gated by position as above."""
    pj, pt = packs["lod"]
    pos, yaw, pitch, sids = poses
    jargs, _, parent_c = _select_inputs(pj, pt, poses)
    head_j, cnt_j = jrc.select_chunklets_exact(*jargs, parent_c=parent_c, c=32, skip_exact=True, k_final=128)
    head, cnt = np.array(head_j), np.asarray(cnt_j)
    ka = head.shape[2]
    assert ka == 128 and cnt[1, 0] > 0
    k = np.arange(ka)
    head[1, 0] = head[1, 0, k % cnt[1, 0]]  # every slot a real survivor
    cntk = np.array([[0], [ka]], dtype=np.int32)
    planes = jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, 32, 32)
    nw = np.asarray(jnp.einsum(
        "nij,kpj->nkpi", jax_view_rotation(jnp.asarray(yaw), jnp.asarray(pitch)), jnp.asarray(planes),
        precision="highest",
    ))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrp.cullmask_pallas_t(
            pj.tri_verts16, jnp.asarray(sids), jnp.asarray(head), jnp.asarray(cntk), jnp.asarray(nw), jnp.asarray(pos)
        ))
    got = trk.cullmask_t(pt.tri_verts16, _t(sids), _t(head), _t(cntk), _t(nw), _t(pos)).numpy()
    assert got.shape == ref.shape == (N, 1, ka, 32)
    gate = k[None, None, :] < cntk[..., None]
    assert gate.sum() == ka  # env 0 gates nothing, env 1 everything
    assert ((ref > 0.5) == (got > 0.5))[gate].mean() >= 0.999
    assert 0.05 < (got > 0.5)[gate].mean() < 0.95


# ---- (h) overflow passes through untested ---------------------------------------


def test_packed_exact_select_overflow_passthrough(packs, poses):
    """The k_exact cap only bypasses the exact test for survivors beyond it,
    never drops them: with a tiny cap the survivor set still contains every
    uncapped-exact survivor and stays within the level-1 set."""
    pj, pt = packs["lod"]
    _, targs, parent_c = _select_inputs(pj, pt, poses)
    common = dict(parent_c=parent_c, c=32)
    ids_l1, cnt_l1 = trc.select_chunklets_exact(*targs, skip_exact=True, **common)
    ids_full, cnt_full = trc.select_chunklets_exact(*targs, verts16=pt.tri_verts16, k_exact=4096, **common)
    ids_cap, cnt_cap = trc.select_chunklets_exact(*targs, verts16=pt.tri_verts16, k_exact=8, **common)
    for n in range(N):
        s_l1 = set((ids_l1[n, 0, : cnt_l1[n, 0]] & MASK).tolist())
        s_full = set((ids_full[n, 0, : cnt_full[n, 0]] & MASK).tolist())
        s_cap = set((ids_cap[n, 0, : cnt_cap[n, 0]] & MASK).tolist())
        assert s_full <= s_cap <= s_l1, n
    assert int(cnt_full.sum()) < int(cnt_cap.sum()) <= int(cnt_l1.sum())
