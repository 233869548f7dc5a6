"""CUDA kernels of habitat_torch against their plain PyTorch versions, on the
card. These need an NVIDIA GPU and nvcc and skip elsewhere. The repo's
conftest imports JAX, which the card's machine lacks, so run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

This file imports no JAX.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from habitat_torch.articulated_agents import dynamics as arm_dyn
from habitat_torch.articulated_agents import kinematics as kin
from habitat_torch.articulated_agents import legs, urdf
from habitat_torch.articulated_agents.params import FETCH
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.ops import cuda_build, pool
from habitat_torch.ops import raycast as rc
from habitat_torch.ops import raycast_kernels as rk
from habitat_torch.sims.procedural import generate_scan_apartment
from habitat_torch.sims.scene import pack_scenes
from habitat_torch.tasks.rearrange import generator as rgen
from habitat_torch.tasks.rearrange import rearrange_env as renv
from habitat_torch.tasks.rearrange import rigid_body as rigid
from habitat_torch.utils.geometry import camera_rays

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cuda_build.build()  # every source, in parallel
    return torch.device("cuda")


def _inputs(pack, n, hw, seed):
    rng = np.random.RandomState(seed)
    H = W = hw
    sids = torch.as_tensor(np.arange(n) % pack.num_scenes, dtype=torch.int32)
    pos = torch.as_tensor(np.c_[rng.uniform(2, 8, n), np.full(n, 1.25), rng.uniform(2, 8, n)], dtype=torch.float32)
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32)
    pitch = torch.zeros(n)
    _, d_t, planes, _, rt = rc.pinhole_constants(90.0, H, W, torch.device("cpu"))
    B = rc.ray_feature_matrix(pos, yaw, pitch)
    Bt = torch.nn.functional.pad(B.transpose(1, 2), (0, 0, 0, 6)).contiguous()
    ids, cnt = rc.select_chunks_frustum(
        pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid, sids.long(), pos, yaw, pitch, planes
    )
    return sids, pos, yaw, pitch, d_t, Bt, ids, cnt, rt


def _agree(ref, got):
    (t0, i0), (t1, i1) = [(t.cpu().numpy(), i.cpu().numpy()) for t, i in (ref, got)]
    assert ((i0 >= 0) == (i1 >= 0)).mean() >= 0.9999
    both = (i0 >= 0) & (i1 >= 0)
    assert (i0[both] == i1[both]).mean() >= 0.999
    same = both & (i0 == i1)
    assert np.abs(t0[same] - t1[same]).max() < 5e-3


def test_fused_sel_kernel_matches_plain(cuda):
    scenes, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    pack = pack_scenes(scenes)
    sids, pos, yaw, pitch, d_t, Bt, ids, cnt, rt = _inputs(pack, 8, 128, 0)
    gm = rc.group_tri_mat(pack.tri_mat, 32).contiguous()
    args = [gm, sids, ids, cnt, d_t, Bt]
    ref = rk.raycast_fused_sel_t(*args, ray_tile=rt, tri_chunk=32)
    before = rk.raycast_fused_sel_t.launches
    got = rk.raycast_fused_sel_t(*[a.to(cuda) for a in args], ray_tile=rt, tri_chunk=32)
    torch.cuda.synchronize()
    assert rk.raycast_fused_sel_t.launches == before + 1
    _agree(ref, got)


def test_fused_kernel_matches_plain(cuda):
    scenes, _, _ = make_procedural_pointnav(num_scenes=1, episodes_per_scene=1, seed=0)
    pack = pack_scenes(scenes)
    sids, pos, yaw, pitch, d_t, Bt, _, _, rt = _inputs(pack, 4, 64, 1)
    gm = rc.group_tri_mat(pack.tri_mat, 128).contiguous()
    ref = rk.raycast_fused_t(gm, sids, d_t, Bt, ray_tile=rt, tri_chunk=128)
    got = rk.raycast_fused_t(gm.to(cuda), sids.to(cuda), d_t.to(cuda), Bt.to(cuda), ray_tile=rt, tri_chunk=128)
    torch.cuda.synchronize()
    _agree(ref, got)


def test_wrapper_rejects_bad_inputs(cuda):
    gm = torch.zeros(1, 10, 512, device=cuda)
    sids = torch.zeros(1, dtype=torch.int64, device=cuda)
    d_t = torch.zeros(1, 8, 1024, device=cuda)
    Bt = torch.zeros(1, 16, 4, device=cuda)
    with pytest.raises(ValueError):
        rk.raycast_fused_t(gm, sids, d_t, Bt, ray_tile=1024, tri_chunk=128)


# ---- the scan-scale route's kernels, on a forced-scan small pack -----------------


@pytest.fixture(scope="module")
def scan():
    """A small scan apartment packed with the scan layout, 4 poses, 64x64
    (four 32x32 tiles), and the route's kernel inputs built on the CPU."""
    scene = generate_scan_apartment(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
    pack = pack_scenes([scene], force_scan_tables=True)
    rng = np.random.RandomState(11)
    n = 4
    pos = torch.as_tensor(np.array([[3.0, 1.25, 3.0]]) + rng.uniform(-1, 1, (n, 3)) * [1, 0, 1], dtype=torch.float32)
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32)
    sids = torch.zeros(n, dtype=torch.int32)
    return pack, sids, pos, yaw, torch.zeros(n)


def _route_call(scan, backend, device="cpu"):
    pack, sids, pos, yaw, pitch = scan
    return rc.closest_hit_call(
        pack.to(device), sids.to(device), pos.to(device), yaw.to(device), pitch.to(device),
        height=64, width=64, cull_k=8, backend=backend,
    )


@pytest.mark.parametrize("backend", ["auto", "stream"])
def test_stream_kernels_match_plain(cuda, scan, backend):
    """The chunklet stream (C = 32) and the chunk stream (C = 256) against
    their plain versions on the same packed lists: the early stop may only
    skip chunks that cannot win."""
    kernel, args, kwargs, _ = _route_call(scan, backend)
    assert kernel is (rk.raycast_stream_t if backend == "stream" else rk.raycast_exactsel_t)
    assert kwargs["tri_chunk"] == (256 if backend == "stream" else 32)
    ref = kernel(*args, **kwargs)  # CPU tensors: plain version
    before = kernel.launches
    got = kernel(*[a.to(cuda) for a in args], **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert (ref[1] >= 0).float().mean() > 0.3
    _agree(ref, got)


def test_stream_kernel_chunk_128(cuda, scan):
    pack = pack_scenes([generate_scan_apartment(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)])
    kernel, args, kwargs, _ = _route_call((pack, *scan[1:]), "stream")
    assert kernel is rk.raycast_stream_t and kwargs["tri_chunk"] == 128
    _agree(kernel(*args, **kwargs), kernel(*[a.to(cuda) for a in args], **kwargs))


def _ring_edge_cases():
    """{0, 1, S - 1, S, S + 1, K} list slots, S the stream kernel's ring depth."""
    S = rk.STREAM_STAGES
    return sorted({0, 1, S - 1, S, S + 1}) + ["K"]


@pytest.mark.parametrize("cnt_case", _ring_edge_cases())
@pytest.mark.parametrize("backend", ["auto", "stream"])
def test_stream_kernels_at_ring_edges(cuda, scan, backend, cnt_case):
    """The lists cut to cnt slots (the tail repeating the last survivor, as
    the selections pad it): the kernel equals its plain version on the card
    on every ray, except where the plain version, testing every slot, finds
    a nearer hit (a float32 t below its own chunk's floored dmin), which is
    counted."""
    kernel, args, kwargs, _ = _route_call(scan, backend, cuda)
    gm, sids, ids, cnt, d_t, Bt = args
    K = ids.shape[2]
    n = K if cnt_case == "K" else cnt_case
    ids = ids.clone()
    if 0 < n < K:
        ids[..., n:] = ids[..., n - 1:n]
    args = (gm, sids, ids.contiguous(), torch.full_like(cnt, n), d_t, Bt)
    before = kernel.launches
    t_k, i_k = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    t_p, i_p = kernel.plain(*args, **kwargs)
    differ = (t_k != t_p) | (i_k != i_p)
    nearer_in_plain = differ & (t_p < t_k)
    assert not (differ & ~nearer_in_plain).any(), f"{int(differ.sum())} rays differ"
    assert int(nearer_in_plain.sum()) <= 1e-3 * t_k.numel()
    assert (i_k >= 0).any() == (n > 0)


@pytest.mark.parametrize("where", ["mid", "ends"])
def test_culled_kernels_skip_invalid_ids(cuda, where):
    """#7 on a list of odd length with invalid ids (-1 and T / C) inserted,
    and #9 on the same list split into 128-triangle ids: t and the 8
    attributes equal to the plain version's on the card on every ray."""
    scene = generate_scan_apartment(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
    pack = pack_scenes([scene], force_scan_tables=True)
    kernel, args, kwargs, dirs = _general_call(pack, "equirect", 32, 128, cull_k=7)
    tri_mat, attr_t, ids, sids, feat_t, dirs = (x.to(cuda) for x in (*args, dirs))
    n_chunks = tri_mat.shape[3] // kwargs["tri_chunk"]
    cols = list(ids.unbind(2))
    at = {"mid": (1, 4), "ends": (0, len(cols) + 1)}[where]
    cols.insert(at[0], torch.full_like(cols[0], -1))
    cols.insert(at[1], torch.full_like(cols[0], n_chunks))
    ids = torch.stack(cols, 2).contiguous()
    assert ids.shape[2] % rk.RING_STAGES
    args = (tri_mat, attr_t, ids, sids, feat_t)
    before = kernel.launches
    t_k, a_k = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    t_p, a_p = kernel.plain(*args, **kwargs)
    assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)
    assert (a_k[:, 7] > 0.5).float().mean() > 0.3
    # #9: the same triangles in the same order, from row-major features
    split = kwargs["tri_chunk"] // 128
    ids128 = torch.where(ids[..., None] >= 0, ids[..., None] * split + torch.arange(split, device=cuda), -1)
    feat = rc.ray_features(feat_t[:, :, 3:6].transpose(2, 3).reshape(dirs.shape), dirs)
    t9, a9 = rk.raycast_culled(tri_mat, pack.tri_attr.to(cuda), ids128.reshape(*ids.shape[:2], -1).contiguous(), sids,
                               features=feat, ray_tile=1024, tri_chunk=128)
    assert torch.equal(t9, t_k) and torch.equal(a9, a_k.transpose(1, 2))


def test_kernel_designs_match_the_wrappers(cuda):
    """The ring depths and early-stop granularity the wrappers and the plain
    versions' counters assume are the kernels' own, without spills."""
    d = rk.stream_design()
    assert (d["rays_per_block"], d["rays_per_warp"], d["ring_stages"]) == (
        rk.STREAM_BLOCK_RAYS, rk.STREAM_WARP_RAYS, rk.STREAM_STAGES)
    assert d["spill_bytes"] == 0 and d["blocks_per_sm"] >= 1
    for row_major, C in ((False, 256), (False, 128), (True, 128)):
        d = rk.culled_design(C, 160, row_major=row_major)
        assert d["ring_stages"] == rk.RING_STAGES and d["rays_per_block"] == 1024
        assert d["spill_bytes"] == 0 and d["blocks_per_sm"] >= 1


def test_cullmask_kernel_matches_plain(cuda, scan):
    """Bit-equal pass masks on the gated slots, zeros beyond them, and the
    same chunklet list from select_chunklets_exact on the card (kernel) as on
    the CPU (plain version)."""
    pack, sids, pos, yaw, pitch = scan
    _, _, d_t, planes, _ = rc.block_constants(90.0, 64, 64, torch.device("cpu"))
    dirs = rc.to_blocks(rc.world_rays(yaw, pitch, 90.0, 64, 64), 64, 64)
    ids0, cnt0 = rc.select_chunks(
        pack.chunk_bounds[sids.long()], pos[:, None, :].expand(-1, 4096, -1), dirs, 1024, 64, with_cnt=True
    )
    sel = (pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid, pack.chunklet_ab32, sids, pos, yaw, pitch,
           planes, ids0, cnt0)
    head, cntk = rc.select_chunklets_exact(*sel, parent_c=256, c=32, k_final=128)  # level-1 survivors
    nw = torch.einsum("nij,kpj->nkpi", rc.view_rotation_matrix(yaw, pitch), planes).contiguous()
    ref = rk.cullmask_t(pack.tri_verts16, sids, head, cntk, nw, pos)
    before = rk.cullmask_t.launches
    got = rk.cullmask_t(*[x.to(cuda) for x in (pack.tri_verts16, sids, head, cntk, nw, pos)]).cpu()
    torch.cuda.synchronize()
    assert rk.cullmask_t.launches == before + 1
    gate = torch.arange(128)[None, None, :] < cntk[..., None]
    assert torch.equal(ref[gate], got[gate]) and not got[~gate].any()
    assert 0.05 < ref[gate].mean() < 0.95
    kw = dict(parent_c=256, c=32, verts16=pack.tri_verts16, k_exact=128)
    a = rc.select_chunklets_exact(*sel, **kw)
    before = rk.cullmask_t.launches
    b = rc.select_chunklets_exact(*[x.to(cuda) for x in sel], **dict(kw, verts16=pack.tri_verts16.to(cuda)))
    assert rk.cullmask_t.launches == before + 1  # card tensors: the kernel, by device alone
    assert torch.equal(a[0], b[0].cpu()) and torch.equal(a[1], b[1].cpu())


def test_scan_render_on_card_matches_cpu(cuda, scan):
    """The default (exact-cull) route keeps every candidate chunk at this
    size, so the card's frames equal the CPU's."""
    pack, sids, pos, yaw, pitch = scan
    kw = dict(height=64, width=64, cull_k=8)
    ref = rc.render_batch(pack, sids, pos, yaw, pitch, **kw)
    got = rc.render_batch(pack.to(cuda), *[x.to(cuda) for x in (sids, pos, yaw, pitch)], **kw)
    assert ((ref["depth"] - got["depth"].cpu()).abs() > 1e-4).float().mean() < 1e-3
    assert (ref["semantic"] != got["semantic"].cpu()).float().mean() < 1e-3


# ---- the general route's kernels (any camera, any image size) --------------------


def _general_call(pack, projection, H, W, n=4, seed=3, cull_k=None):
    rng = np.random.RandomState(seed)
    sids = torch.as_tensor(np.arange(n) % pack.num_scenes, dtype=torch.int32)
    c = pack.chunk_bounds[0, :, :3].mean(0).numpy()
    pos = torch.as_tensor(np.c_[c[0] + rng.uniform(-1, 1, n), np.full(n, 1.25), c[2] + rng.uniform(-1, 1, n)],
                          dtype=torch.float32)
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32)
    return rc.closest_hit_call(pack, sids, pos, yaw, torch.zeros(n), height=H, width=W, projection=projection,
                               cull_k=cull_k)


@pytest.mark.parametrize("projection,H,W,rt", [("equirect", 64, 128, 2048), ("fisheye", 64, 64, 2048),
                                              ("pinhole", 20, 30, 600)])
def test_index_kernel_matches_plain(cuda, projection, H, W, rt):
    """Every chunk of the bench scenes; the untiled 20x30 image is one tile
    of 600 rays, not a multiple of the 256-thread block."""
    scenes, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    kernel, args, kwargs, _ = _general_call(pack_scenes(scenes), projection, H, W)
    assert kernel is rk.raycast_index_t and kwargs["ray_tile"] == rt
    ref = kernel(*args, **kwargs)
    before = kernel.launches
    got = kernel(*[a.to(cuda) for a in args], **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert (ref[1] >= 0).float().mean() > 0.3
    _agree(ref, got)


@pytest.mark.parametrize("force_scan_tables,chunk", [(False, 128), (True, 256)])
def test_culled_kernel_matches_plain(cuda, force_scan_tables, chunk):
    """The candidate chunks of the scan apartment's equirect tiles, in the
    pack's chunk size; the 8 attributes equal wherever the winner is."""
    scene = generate_scan_apartment(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
    pack = pack_scenes([scene], force_scan_tables=force_scan_tables)
    kernel, args, kwargs, _ = _general_call(pack, "equirect", 32, 128, cull_k=8)
    assert kernel is rk.raycast_culled_t and kwargs["tri_chunk"] == chunk
    t0, a0 = kernel(*args, **kwargs)
    before = kernel.launches
    t1, a1 = (x.cpu() for x in kernel(*[a.to(cuda) for a in args], **kwargs))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    h0, h1 = a0[:, 7] > 0.5, a1[:, 7] > 0.5
    assert (h0 == h1).float().mean() >= 0.9999 and h0.float().mean() > 0.3
    same = h0 & h1 & (a0 == a1).all(1)
    assert same.sum() >= 0.999 * (h0 & h1).sum()
    assert (t0[same] - t1[same]).abs().max() < 5e-3
    assert not a1.transpose(1, 2)[~h1].any() and (t1[~h1] == 1e6).all()


def test_general_kernels_reject_bad_layouts(cuda):
    """A card tensor the kernels do not read as given (a strided view, a
    wrong type) raises instead of launching."""
    scenes, _, _ = make_procedural_pointnav(num_scenes=1, episodes_per_scene=1, seed=0)
    kernel, args, kwargs, _ = _general_call(pack_scenes(scenes), "equirect", 32, 64)
    tri_mat, sids, feat = (a.to(cuda) for a in args)
    before = rk.raycast_index_t.launches
    with pytest.raises(ValueError, match="contiguous"):
        rk.raycast_index_t(tri_mat, sids, feat.transpose(2, 3).contiguous().transpose(2, 3), **kwargs)
    with pytest.raises(ValueError):
        rk.raycast_index_t(tri_mat, sids.long(), feat, **kwargs)
    attr_t = torch.zeros(1, 8, tri_mat.shape[3], device=cuda)
    ids = torch.zeros(sids.shape[0], 2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rk.raycast_culled_t(tri_mat, attr_t.transpose(1, 2).contiguous().transpose(1, 2), ids, sids,
                            feat.reshape(sids.shape[0], 2, 16, 1024), ray_tile=1024)
    assert rk.raycast_index_t.launches == before


# ---- the ray-batch kernels (#8 - #10) and the dynamic merge ---------------------


def _equirect_rays(n, H, W, seed, centre=5.0, spread=3.0):
    rng = np.random.RandomState(seed)
    pos = torch.as_tensor(np.c_[rng.uniform(centre - spread, centre + spread, n), np.full(n, 1.25),
                                rng.uniform(centre - spread, centre + spread, n)], dtype=torch.float32)
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32)
    dirs = rc.world_rays(yaw, torch.zeros(n), 90.0, H, W, "equirect")
    return pos, yaw, pos[:, None, :].expand(-1, H * W, -1).contiguous(), dirs


@pytest.mark.parametrize("H,W,ray_tile", [(64, 128, 2048), (20, 30, 2048)])
def test_raycast_index_kernel_matches_plain(cuda, H, W, ray_tile):
    """#8 under raycast_batch on the bench scenes; 20x30 is one untiled 600-ray slab."""
    scenes, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    pack = pack_scenes(scenes)
    _, _, o, d = _equirect_rays(4, H, W, 3)
    sids = torch.arange(4, dtype=torch.int32) % 2
    ref = rk.raycast_batch(pack.tri_mat, pack.tri_attr, sids, o, d, ray_tile=ray_tile)
    before = rk.raycast_index.launches
    got = [x.cpu() for x in rk.raycast_batch(pack.tri_mat.to(cuda), pack.tri_attr.to(cuda), sids.to(cuda),
                                             o.to(cuda), d.to(cuda), ray_tile=ray_tile)]
    torch.cuda.synchronize()
    assert rk.raycast_index.launches == before + 1
    h0, h1 = ref[1][..., 7] > 0.5, got[1][..., 7] > 0.5
    assert (h0 == h1).float().mean() >= 0.9999 and h0.float().mean() > 0.3
    same = h0 & h1 & (ref[1] == got[1]).all(-1)
    assert same.sum() >= 0.999 * (h0 & h1).sum()
    assert (ref[0][same] - got[0][same]).abs().max() < 5e-3


def test_raycast_culled_kernel_matches_plain(cuda):
    """#9 on the scan apartment's equirect tiles, its 256-triangle ids split
    into 128-triangle ones; the same as #7 on the unsplit ids."""
    scene = generate_scan_apartment(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
    pack = pack_scenes([scene], force_scan_tables=True)
    kernel, args, kwargs, dirs = _general_call(pack, "equirect", 32, 128, cull_k=8)
    assert kernel is rk.raycast_culled_t and kwargs["tri_chunk"] == 256
    tri_mat, attr_t, ids, sids, feat_t = args
    ids128 = (ids[..., None] * 2 + torch.arange(2, dtype=torch.int32)).reshape(*ids.shape[:2], -1)
    feat = rc.ray_features(feat_t[:, :, 3:6].transpose(2, 3).reshape(dirs.shape), dirs)
    cargs = (tri_mat, pack.tri_attr, ids128, sids, None, None)
    ref = rk.raycast_culled(*cargs, features=feat)
    before = rk.raycast_culled.launches
    got = [x.cpu() for x in rk.raycast_culled(*[a.to(cuda) if a is not None else None for a in cargs],
                                              features=feat.to(cuda))]
    t7, a7 = (x.cpu() for x in kernel(*[a.to(cuda) for a in args], **kwargs))
    torch.cuda.synchronize()
    assert rk.raycast_culled.launches == before + 1
    h0, h1 = ref[1][..., 7] > 0.5, got[1][..., 7] > 0.5
    assert (h0 == h1).float().mean() >= 0.9999 and h0.float().mean() > 0.3
    same = h0 & h1 & (ref[1] == got[1]).all(-1)
    assert same.sum() >= 0.999 * (h0 & h1).sum()
    assert (ref[0][same] - got[0][same]).abs().max() < 5e-3
    # the same triangles in the same order as #7: the same bits
    assert torch.equal(got[0], t7) and torch.equal(got[1], a7.transpose(1, 2))


def test_tilecull_kernel_matches_plain(cuda):
    """#10 on the bench scenes' frustum-selected inputs: all 16 rows, and the
    gid row equal to #1's winner."""
    scenes, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    pack = pack_scenes(scenes)
    sids, pos, yaw, pitch, d_t, Bt, ids, cnt, rt = _inputs(pack, 8, 64, 4)
    gm = rc.group_tri_mat(pack.tri_mat, 32).contiguous()
    a16 = rk.attr16_table(pack.tri_attr, pack.tri_v0)
    args = [gm, a16, ids, cnt, sids, d_t, Bt]
    t0, a0 = rk.raycast_tilecull_t(*args, ray_tile=rt)
    before = rk.raycast_tilecull_t.launches
    t1, a1 = (x.cpu() for x in rk.raycast_tilecull_t(*[a.to(cuda) for a in args], ray_tile=rt))
    t_sel, i_sel = (x.cpu() for x in rk.raycast_fused_sel_t(
        *[a.to(cuda) for a in (gm, sids, ids, cnt, d_t, Bt)], ray_tile=rt, tri_chunk=32))
    torch.cuda.synchronize()
    assert rk.raycast_tilecull_t.launches == before + 1
    h0, h1 = a0[:, :, 11] > 0.5, a1[:, :, 11] > 0.5
    assert (h0 == h1).float().mean() >= 0.9999 and 0.3 < h0.float().mean() < 1.0
    same = h0 & h1 & (a0[:, :, 6] == a1[:, :, 6])
    assert same.sum() >= 0.999 * (h0 & h1).sum()
    assert (a0 - a1).transpose(2, 3)[same].abs().max() < 1e-5
    assert (a1[:, :, 12].transpose(1, 2)[~h1.transpose(1, 2)] == 0.35).all()
    gid = torch.where(h1, a1[:, :, 6], -1.0).reshape(8, -1)
    assert (gid == i_sel.float()).float().mean() >= 0.999


def test_dynamic_render_on_card_matches_cpu(cuda):
    """The merge on the index route (bench scenes, 64x64 pinhole, three boxes
    per env): the card's frames against the CPU's."""
    scenes, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    pack = pack_scenes(scenes)
    n = 4
    pos, yaw, _, _ = _equirect_rays(n, 4, 4, 5, spread=2.0)
    fwd = torch.stack([-torch.sin(yaw), torch.zeros(n), -torch.cos(yaw)], -1)
    g = torch.Generator().manual_seed(0)
    centre = pos[:, None] + fwd[:, None] * (0.6 + torch.rand(n, 3, 1, generator=g)) - torch.tensor([0.0, 0.5, 0.0])
    corners = torch.tensor([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], dtype=torch.float32)
    faces = torch.tensor([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                          [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    v = (centre[:, :, None] + 0.2 * corners)[:, :, faces].reshape(n, 36, 3, 3)
    dyn = dict(v0=v[:, :, 0], e1=v[:, :, 1] - v[:, :, 0], e2=v[:, :, 2] - v[:, :, 0],
               valid=torch.ones(n, 36, dtype=torch.bool), color=torch.rand(n, 36, 3, generator=g),
               sem=torch.full((n, 36), 100, dtype=torch.int32))
    sids = torch.arange(n, dtype=torch.int32) % 2
    pitch = torch.full((n,), -0.45)
    kw = dict(height=64, width=64)
    ref = rc.render_batch(pack, sids, pos, yaw, pitch, dynamic=dyn, **kw)
    before = rk.raycast_index_t.launches
    got = rc.render_batch(pack.to(cuda), sids.to(cuda), pos.to(cuda), yaw.to(cuda), pitch.to(cuda),
                          dynamic={k: x.to(cuda) for k, x in dyn.items()}, **kw)
    torch.cuda.synchronize()
    assert rk.raycast_index_t.launches == before + 2  # the static scene and the boxes
    assert (ref["semantic"] == 100).float().mean() > 0.05
    assert (ref["semantic"] == got["semantic"].cpu()).float().mean() >= 0.999
    assert ((ref["depth"] - got["depth"].cpu()).abs() < 1e-4).float().mean() >= 0.999


# ---- the ring kernels #1, #2, #3 and #8 at their edges ---------------------------


def _equal(got, ref):
    """t and winner equal on every ray."""
    (t0, i0), (t1, i1) = ref, got
    assert torch.equal(t0, t1) and torch.equal(i0, i1), f"{int(((t0 != t1) | (i0 != i1)).sum())} rays differ"


def _launch(wrapper, *args, **kwargs):
    """The wrapper on card tensors: it must launch its kernel once."""
    before = wrapper.launches
    out = wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.fixture(scope="module")
def ring_packs():
    """The bench scenes (T = 128) and the mid-size scene (4352 triangles, 34
    chunks of 128)."""
    scenes, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    mid, _, _ = make_procedural_pointnav(num_scenes=1, episodes_per_scene=1, seed=0, extent=30.0,
                                         scene_kw=dict(n_clutter=420))
    return dict(bench=pack_scenes(scenes), mid=pack_scenes(mid))


@pytest.mark.parametrize("cnt_case", [0, 1, 2, 3, "K"])
def test_fused_sel_kernel_at_ring_edges(cuda, ring_packs, cnt_case):
    """#1 on 2048-ray tiles, each listing the scene's K = 4 chunks of 32 in a
    seeded order cut to cnt slots (the tail repeating the last): t and idx
    equal to the plain version's on the card on every ray."""
    pack = ring_packs["bench"]
    sids, _, _, _, d_t, Bt, _, _, rt = _inputs(pack, 8, 64, 6)
    assert rt == 2048
    gm = rc.group_tri_mat(pack.tri_mat, 32).contiguous()
    K, nt = gm.shape[2] // 4 // 32, d_t.shape[0]
    g = torch.Generator().manual_seed(5)
    ids = torch.stack([torch.randperm(K, generator=g) for _ in range(8 * nt)]).reshape(8, nt, K).to(torch.int32)
    n = K if cnt_case == "K" else cnt_case
    if 0 < n < K:
        ids[..., n:] = ids[..., n - 1:n]
    cnt = torch.full((8, nt), n, dtype=torch.int32)
    args = [x.to(cuda) for x in (gm, sids, ids.contiguous(), cnt, d_t, Bt)]
    got = _launch(rk.raycast_fused_sel_t, *args, ray_tile=rt, tri_chunk=32)
    _equal(got, rk.raycast_fused_sel_t.plain(*args, ray_tile=rt, tri_chunk=32))
    assert bool((got[1] >= 0).any()) == (n > 0)


def test_fused_kernel_on_the_mid_size_scene(cuda, ring_packs):
    """#2 over the mid-size scene's 34 chunks of 128 on 2048-ray tiles."""
    pack = ring_packs["mid"]
    sids, _, _, _, d_t, Bt, _, _, rt = _inputs(pack, 4, 64, 7)
    args = [x.to(cuda) for x in (rc.group_tri_mat(pack.tri_mat, 128).contiguous(), sids, d_t, Bt)]
    assert args[0].shape[2] // 4 // 128 == 34
    got = _launch(rk.raycast_fused_t, *args, ray_tile=rt, tri_chunk=128)
    _equal(got, rk.raycast_fused_t.plain(*args, ray_tile=rt, tri_chunk=128))
    assert (got[1] >= 0).float().mean() > 0.3


def _index_rays(pack, n, H, W, seed):
    """Equirect rays of n poses around the centre of the pack's first scene."""
    rng = np.random.RandomState(seed)
    c = pack.chunk_bounds[0, :, :3].mean(0).numpy()
    pos = torch.as_tensor(np.c_[c[0] + rng.uniform(-1, 1, n), np.full(n, 1.25), c[2] + rng.uniform(-1, 1, n)],
                          dtype=torch.float32)
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32)
    dirs = rc.world_rays(yaw, torch.zeros(n), 90.0, H, W, "equirect")
    return pos[:, None, :].expand(-1, H * W, -1).contiguous(), dirs


def _with_soup(tri_mat, T, seed):
    """The pack's matrix (S, 10, 4, 128) and T - 128 seeded triangles of
    0.1-0.6 m around each scene's rooms."""
    k = T - tri_mat.shape[3]
    if k == 0:
        return tri_mat
    rng = np.random.RandomState(seed)
    soup = []
    for _ in range(tri_mat.shape[0]):
        v0 = rng.uniform([2, 0.3, 2], [8, 2.5, 8], (k, 3)).astype(np.float32)
        e1, e2 = (rng.normal(0, 0.3, (k, 3)).astype(np.float32) for _ in range(2))
        soup.append(torch.from_numpy(rc.build_tri_matrix(v0, e1, e2, np.ones(k, bool))))
    return torch.cat([tri_mat, torch.stack(soup)], dim=3).contiguous()


@pytest.mark.parametrize("case", ["T128", "T256", "T384", "slab600", "slab1600", "mid"])
def test_index_kernels_at_ring_edges(cuda, ring_packs, case):
    """#3 over one, two and three chunks of 128 (the bench room and a seeded
    soup), on untiled slabs of 600 and 1600 rays, and over the mid-size
    scene's 34 chunks; #8 on the same rays from row-major features. Each
    equals its plain version on the card on every ray, and #8 agrees with #3
    (their margins differ on boundaries only)."""
    pack = ring_packs["mid" if case == "mid" else "bench"]
    n, (H, W) = 4, {"slab600": (20, 30), "slab1600": (40, 40)}.get(case, (64, 64))
    tri_mat = _with_soup(pack.tri_mat, int(case[1:]), 3) if case[0] == "T" else pack.tri_mat
    o, d = _index_rays(pack, n, H, W, 9)
    R = H * W
    rt = 2048 if R % 2048 == 0 else R
    sids = (torch.arange(n, dtype=torch.int32) % pack.num_scenes).to(cuda)
    tri_mat, o, d = tri_mat.to(cuda), o.to(cuda), d.to(cuda)
    feat_t = rc.ray_features_t(o, d, rt)
    t3, i3 = _launch(rk.raycast_index_t, tri_mat, sids, feat_t, ray_tile=rt)
    _equal((t3, i3), rk.raycast_index_t.plain(tri_mat, sids, feat_t, ray_tile=rt))
    assert (i3 >= 0).float().mean() > 0.3
    if case[0] == "T" and case != "T128":
        assert (i3 >= 128).any()  # the later chunks are walked
    feat = rc.ray_features(o, d)
    t8, i8 = _launch(rk.raycast_index, tri_mat, sids, feat, ray_tile=rt)
    _equal((t8, i8), rk.raycast_index.plain(tri_mat, sids, feat, ray_tile=rt))
    _agree((t3, i3), (t8, i8))


def test_ring_wrappers_reject_bad_layouts(cuda):
    """A misaligned or T % 4 != 0 matrix, or a chunk the fused kernel does not
    take, raises on the card and launches nothing."""
    dev = cuda
    sids = torch.zeros(1, dtype=torch.int32, device=dev)
    feat_t = torch.zeros(1, 1, 16, 1024, device=dev)
    feat = torch.zeros(1, 1024, 10, device=dev)
    bad = torch.zeros(40 * 128 + 1, device=dev)[1:].view(1, 10, 4, 128)  # 4 bytes past a 16-byte boundary
    odd = torch.zeros(1, 10, 4, 126, device=dev)  # one chunk of 126
    counts = (rk.raycast_index_t.launches, rk.raycast_index.launches, rk.raycast_fused_t.launches)
    for tm in (bad, odd):
        with pytest.raises(ValueError):
            rk.raycast_index_t(tm, sids, feat_t, ray_tile=1024)
        with pytest.raises(ValueError):
            rk.raycast_index(tm, sids, feat, ray_tile=1024)
    d_t = torch.zeros(1, 8, 1024, device=dev)
    Bt = torch.zeros(1, 16, 4, device=dev)
    gm_bad = torch.zeros(40 * 128 + 1, device=dev)[1:].view(1, 10, 512)
    with pytest.raises(ValueError):
        rk.raycast_fused_t(gm_bad, sids, d_t, Bt, ray_tile=1024, tri_chunk=128)
    with pytest.raises(ValueError):
        rk.raycast_fused_t(torch.zeros(1, 10, 512, device=dev), sids, d_t, Bt, ray_tile=1024, tri_chunk=64)
    assert counts == (rk.raycast_index_t.launches, rk.raycast_index.launches, rk.raycast_fused_t.launches)


def _tilecull_case(ring_packs, case, dev):
    """#10's inputs on the card: 90-degree pinhole tiles of rt rays (1000,
    1536 or 2048) on the bench scenes with each tile's K = 4 chunks of 32 in
    a seeded order cut to a seeded count in 0..K ("cnt0": none, "cntK":
    all), or on the mid-size scene with its frustum-selected chunks of 128
    ("C128")."""
    pack = ring_packs["mid" if case == "C128" else "bench"]
    C = 128 if case == "C128" else 32
    H, W, rt = {"rt1000": (40, 50, 1000), "rt1536": (48, 64, 1536)}.get(case, (64, 64, 2048))
    n = 8
    sids, pos, yaw, pitch, _, Bt, _, _, _ = _inputs(pack, n, 64, 12)
    zero = torch.zeros(())
    d_cam = camera_rays(zero, zero, np.deg2rad(90.0), H, W).reshape(-1, 3)
    d_aug = torch.cat([d_cam, torch.ones(H * W, 1)], dim=-1)
    nt = H * W // rt
    d_t = torch.nn.functional.pad(d_aug.reshape(nt, rt, 4).transpose(1, 2), (0, 0, 0, 4)).contiguous()
    gm = rc.group_tri_mat(pack.tri_mat, C).contiguous()
    K = gm.shape[2] // 4 // C
    if case == "C128":
        planes = torch.as_tensor(rc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, rt // W, W))
        ids, cnt = rc.select_chunks_frustum(pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid, sids.long(), pos,
                                            yaw, pitch, planes, tri_chunk=C)
    else:
        g = torch.Generator().manual_seed(13)
        ids = torch.stack([torch.randperm(K, generator=g) for _ in range(n * nt)]).reshape(n, nt, K).to(torch.int32)
        cnt = {"cnt0": torch.zeros(n, nt), "cntK": torch.full((n, nt), K)}.get(
            case, torch.randint(0, K + 1, (n, nt), generator=g)).to(torch.int32)
    a16 = rk.attr16_table(pack.tri_attr, pack.tri_v0, tri_chunk=C)
    args = [x.to(dev) for x in (gm, a16, ids.contiguous(), cnt.contiguous(), sids, d_t, Bt)]
    return args, dict(ray_tile=rt, tri_chunk=C)


@pytest.mark.parametrize("case", ["rt1000", "rt1536", "rt2048", "cnt0", "cntK", "C128"])
def test_tilecull_kernel_at_ring_edges(cuda, ring_packs, case):
    """#10 on the ring loop: t and all 16 rows equal to the plain version's on
    the card on every ray, for ray tiles that are not multiples of the
    1024-ray block, empty and full lists and chunks of 128; its gid row is
    #1's winner on the same inputs."""
    args, kw = _tilecull_case(ring_packs, case, cuda)
    t_k, a_k = _launch(rk.raycast_tilecull_t, *args, **kw)
    t_p, a_p = rk.raycast_tilecull_t.plain(*args, **kw)
    assert torch.equal(t_k, t_p), f"{int((t_k != t_p).sum())} rays differ in t"
    assert torch.equal(a_k, a_p), f"{int((a_k != a_p).any(2).sum())} rays differ in a row"
    hit = a_k[:, :, 11] > 0.5  # (N, nt, rt)
    assert hit.any() == (case != "cnt0")
    assert (a_k[:, :, 12][~hit] == 0.35).all()
    gm, _, ids, cnt, sids, d_t, Bt = args
    _, i1 = _launch(rk.raycast_fused_sel_t, gm, sids, ids, cnt, d_t, Bt, **kw)
    assert torch.equal(torch.where(hit, a_k[:, :, 6], -1.0).reshape(i1.shape), i1.float())


def test_tilecull_wrapper_rejects_what_the_kernel_does_not_take(cuda, ring_packs):
    """A misaligned matrix, or chunks of 64, raise on the card and launch
    nothing."""
    args, kw = _tilecull_case(ring_packs, "cntK", cuda)
    before = rk.raycast_tilecull_t.launches
    gm = args[0]
    bad = torch.zeros(gm.numel() + 1, device=cuda)[1:].view(gm.shape)  # 4 bytes past a 16-byte boundary
    bad.copy_(gm)
    with pytest.raises(ValueError):
        rk.raycast_tilecull_t(bad, *args[1:], **kw)
    pack = ring_packs["bench"]
    a64 = rk.attr16_table(pack.tri_attr, pack.tri_v0, tri_chunk=64).to(cuda)
    with pytest.raises(ValueError):
        rk.raycast_tilecull_t(gm, a64, args[2][..., :2].contiguous(), args[3], *args[4:], ray_tile=kw["ray_tile"],
                              tri_chunk=64)
    assert rk.raycast_tilecull_t.launches == before


@pytest.mark.parametrize("wrapper", ["raycast_fused_sel_t", "raycast_tilecull_t"])
def test_check_ids_raises_before_a_launch(cuda, ring_packs, wrapper):
    """The kernels read every listed id unchecked; with ``check_ids`` a
    listed id past the scene's chunks (or below 0) raises and launches
    nothing, one past ``cnt`` is not looked at, and ids in range give the
    same result as without the check."""
    args, kw = _tilecull_case(ring_packs, "cntK", cuda)
    if wrapper == "raycast_fused_sel_t":
        gm, _, ids, cnt, sids, d_t, Bt = args
        args = [gm, sids, ids, cnt, d_t, Bt]
    fn = getattr(rk, wrapper)
    ids, cnt = args[2], args[3]  # both wrappers take them third and fourth
    K = ids.shape[2]
    ref = _launch(fn, *args, **kw)
    checked = _launch(fn, *args, **kw, check_ids=True)
    assert all(torch.equal(a, b) for a, b in zip(ref, checked))
    before = fn.launches
    for bad_id in (K, -1):
        bad = ids.clone()
        bad[0, 0, K - 1] = bad_id
        with pytest.raises(ValueError, match="outside"):
            fn(*args[:2], bad, *args[3:], **kw, check_ids=True)
    assert fn.launches == before
    short = cnt.clone()
    short[0, 0] = K - 1
    bad = ids.clone()
    bad[0, 0, K - 1] = K  # not listed
    fn(*args[:2], bad, short, *args[4:], **kw, check_ids=True)
    torch.cuda.synchronize()
    assert fn.launches == before + 1


def test_evaluate_agent_takes_a_policy_on_cuda0(cuda):
    """The env resolves ``device=None`` to ``cuda`` and the loader puts a
    policy on ``cuda:0``: the evaluator runs them together on the card."""
    from habitat_torch.baselines.evaluator import evaluate_agent
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.models.policy import make_pointnav_resnet_policy

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=2, seed=4)
    env = make_nav_env(scenes, episodes, num_envs=2, precomputed_fields=fields, max_episode_steps=20,
                       sensor_specs=(("HabitatSimDepthSensor", {"height": 64, "width": 64}),
                                     ("PointGoalWithGPSCompassSensor", None)))
    policy = make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(64, 64), backbone="resnet9",
                                         hidden_size=32, device="cuda:0")
    assert env.device != next(policy.parameters()).device  # torch.device("cuda") != "cuda:0"
    got = evaluate_agent(env, policy, episodes_per_env=1, deterministic=True, max_steps=60)
    assert got["num_episodes"] == 2


def test_ring_designs_match_the_wrappers(cuda):
    """The index, fused and tile-cull kernels' block and ring depth are the
    wrappers' constants, with no spills and two blocks per SM."""
    for d in (rk.index_design(128), rk.index_design(64), rk.index_design(128, row_major=True),
              rk.fused_design(32), rk.fused_design(128), rk.tilecull_design(32), rk.tilecull_design(128)):
        assert (d["rays_per_block"], d["ring_stages"]) == (rk.RING_BLOCK_RAYS, rk.RING_STAGES)
        assert d["spill_bytes"] == 0 and d["blocks_per_sm"] >= 2
    assert rk.tilecull_design(32)["rays_per_thread"] == 4


# ---- the stem max pool's backward -----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_bwd_kernel_matches_plain(cuda, dtype):
    """Bit-equal to the plain version (same float32 sums in the same order),
    on a channels-last input with many positive ties; an NCHW-contiguous
    card tensor raises."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randint(0, 6, (8, 16, 32, 32), generator=g) * 0.25).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.nn.functional.max_pool2d(torch.nn.functional.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    y = y.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(y.shape, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
    ref = pool.max_pool_3x3s2_bwd(x, y, dy)
    before = pool.max_pool_3x3s2_bwd.launches
    got = pool.max_pool_3x3s2_bwd(*(t.to(cuda) for t in (x, y, dy)))
    torch.cuda.synchronize()
    assert pool.max_pool_3x3s2_bwd.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.cpu(), ref)
    with pytest.raises(ValueError, match="channels-last"):
        pool.max_pool_3x3s2_bwd(*(t.to(cuda).contiguous() for t in (x, y, dy)))


def test_maxpool_autograd_launches_kernel(cuda):
    x = torch.relu(torch.randn(4, 16, 16, 8, device=cuda)).to(torch.bfloat16).permute(0, 3, 1, 2).requires_grad_(True)
    before = pool.max_pool_3x3s2_bwd.launches
    pool.max_pool_3x3s2(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert pool.max_pool_3x3s2_bwd.launches == before + 1 and torch.isfinite(x.grad.float()).all()
    with pytest.raises(ValueError):
        pool.max_pool_3x3s2(torch.zeros(1, 1, 5, 6, device=cuda))


def _pool_args(shape, dtype, seed, ties=True):
    """Channels-last (x, y, dy) of an (N, C, H, W) max pool: x on a grid of
    1/4 (many positive ties) or a ReLU of normal noise."""
    g = torch.Generator().manual_seed(seed)
    if ties:
        x = torch.randint(0, 6, shape, generator=g) * 0.25
    else:
        x = torch.relu(torch.randn(shape, generator=g))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    y = torch.nn.functional.max_pool2d(torch.nn.functional.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    y = y.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(y.shape, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
    return x, y, dy


@pytest.mark.parametrize("dtype,shape,ties", [
    (torch.bfloat16, (1, 8, 2, 2), True), (torch.bfloat16, (3, 16, 32, 64), True),
    (torch.bfloat16, (5, 32, 16, 16), False), (torch.bfloat16, (2, 64, 32, 32), True),
    (torch.float32, (1, 4, 2, 2), True), (torch.float32, (3, 8, 32, 64), True),
])
def test_maxpool_bwd_kernel_at_edge_shapes(cuda, dtype, shape, ties):
    """One window (H = W = 2), H != W, N = 1 and odd N, every vector width's
    channel counts: bit-equal to the plain version."""
    args = _pool_args(shape, dtype, sum(shape))
    ref = pool.max_pool_3x3s2_bwd(*args)
    got = pool.max_pool_3x3s2_bwd(*(t.to(cuda) for t in args))
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.cpu(), ref)


def test_maxpool_bwd_rejects_what_the_kernel_does_not_take(cuda):
    """C not a multiple of the vector width, and a view whose base is not
    16-byte aligned, raise on the card (the plain version takes both)."""
    x, y, dy = (t.to(cuda) for t in _pool_args((2, 12, 8, 8), torch.bfloat16, 0))
    before = pool.max_pool_3x3s2_bwd.launches
    with pytest.raises(ValueError, match="groups of 8"):
        pool.max_pool_3x3s2_bwd(x, y, dy)
    x, y, dy = _pool_args((2, 8, 8, 8), torch.bfloat16, 1)
    # the same values one element into a larger buffer: channels-last, 2 bytes off
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xs = buf[1:].view(2, 8, 8, 8).permute(0, 3, 1, 2)
    xs.copy_(x)
    assert xs.is_contiguous(memory_format=torch.channels_last) and xs.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        pool.max_pool_3x3s2_bwd(xs, y.to(cuda), dy.to(cuda))
    assert pool.max_pool_3x3s2_bwd.launches == before
    cpu12 = _pool_args((2, 12, 8, 8), torch.bfloat16, 0)
    assert torch.equal(pool.max_pool_3x3s2_bwd(*cpu12), pool.max_pool_3x3s2_bwd_plain(*cpu12))


@pytest.mark.parametrize("ka", [37, 128, 3000])
def test_cullmask_kernel_at_head_edges(cuda, ka):
    """Tiles at cntk = 0, 1, ka and in between (ka = 37 is no multiple of the
    warps per block, ka = 3000 a long head), chunklet ids at and beyond the
    clamp to nch - 1: gated slots bit-equal to the plain version, the rest
    exact zeros."""
    g = torch.Generator().manual_seed(ka)
    S, nch, N, nt = 2, 6, 3, 4
    verts16 = torch.randn(S, nch * 32, 16, generator=g)
    verts16[..., rk.VERTS16_VALID] = (torch.rand(S, nch * 32, generator=g) > 0.2).float()
    sids = torch.tensor([1, 0, 1], dtype=torch.int32)
    cid = torch.randint(0, nch + 4, (N, nt, ka), generator=g, dtype=torch.int32)  # nch - 1 and beyond
    cid[0, 0, :4] = torch.tensor([nch - 1, nch, nch + 3, 2 ** 18 - 1], dtype=torch.int32)
    head = (torch.randint(0, 5000, (N, nt, ka), generator=g, dtype=torch.int32) << 18) | cid
    cntk = torch.tensor([[ka, 0, 1, ka // 2], [ka, ka - 1, 2, 0], [ka + 5, 17, ka, 3]], dtype=torch.int32)
    nw = torch.nn.functional.normalize(torch.randn(N, nt, 4, 3, generator=g), dim=-1)
    cam = torch.randn(N, 3, generator=g) * 0.5
    args = (verts16, sids, head, cntk, nw, cam)
    ref = rk.cullmask_t(*args)
    before = rk.cullmask_t.launches
    got = rk.cullmask_t(*(a.to(cuda) for a in args)).cpu()
    torch.cuda.synchronize()
    assert rk.cullmask_t.launches == before + 1
    gate = torch.arange(ka)[None, None, :] < cntk[..., None]
    assert torch.equal(got[gate], ref[gate]) and not got[~gate].any()
    assert 0.05 < ref[gate].mean() < 0.95


def test_pool_and_cull_designs_match_the_wrappers(cuda):
    """The max-pool backward's vector width is the wrapper's channel rule,
    the cull mask's slot width the wrapper's c; neither spills and both fit
    an SM."""
    for dtype in (torch.bfloat16, torch.float32):
        d = pool.maxpool_bwd_design(dtype)
        assert d["channels_per_thread"] == pool.VEC[dtype]
        assert d["spill_bytes"] == 0 and d["blocks_per_sm"] >= 1
    d = rk.cullmask_design()
    assert d["triangles_per_slot"] == 32 and d["threads_per_block"] == 32 * d["warps_per_block"]
    assert d["spill_bytes"] == 0 and d["blocks_per_sm"] >= 1


# -- rearrangement physics and the arm (no kernels: PyTorch ops on the card) --


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _box_state(n, o, seed, robot_away=True):
    """Random boxes (tipped, spinning, floating, some held), float32 on the
    CPU: bottoms, velocities, quats, omegas, free, floor, agent, halves."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, o, 4))
    agent = np.c_[rng.uniform(-0.3, 0.3, n), np.zeros(n), rng.uniform(-0.3, 0.3, n)] + [5.0 * robot_away, 0, 0]
    xs = (np.c_[rng.uniform(-0.3, 0.3, (n * o, 1)), rng.uniform(0.0, 0.4, (n * o, 1)),
                rng.uniform(-0.3, 0.3, (n * o, 1))].reshape(n, o, 3),
          rng.normal(0, 0.5, (n, o, 3)), q / np.linalg.norm(q, axis=-1, keepdims=True), rng.normal(0, 1, (n, o, 3)),
          rng.uniform(size=(n, o)) > 0.15, rng.uniform(-0.1, 0.1, n), agent, rng.uniform(0.05, 0.2, (n, o, 3)))
    return [torch.as_tensor(x if x.dtype == bool else np.asarray(x, np.float32)) for x in xs]


def _close(got, ref, atol=1e-5, rtol=0.0):
    torch.testing.assert_close(got.cpu(), ref, atol=atol, rtol=rtol)


def test_contact_step_v6_on_card_matches_cpu(card):
    """One env step (dt 0.1, 4 substeps) at N=128, O=3 on the card against
    the same code on the CPU, the robot away from the boxes (its contact is
    ill-conditioned where its axis crosses a box)."""
    p, v, q, w, free, floor, agent, half = _box_state(128, 3, 0)
    ref = renv.contact_step(p, v, free, floor, agent, half=half, quat=q, omega=w)
    got = renv.contact_step(*(x.to(card) for x in (p, v, free, floor, agent)), half=half.to(card),
                            quat=q.to(card), omega=w.to(card))
    for name, g, r in zip(("p", "v", "force", "q", "w"), got, ref):
        assert g.device.type == "cuda", name
        if name == "force":
            _close(g, r, atol=1e-3, rtol=1e-4)
        else:
            _close(g, r, rtol=1e-5 if name == "w" else 0.0)


def test_box_floor_substep_on_card_matches_cpu(card):
    p, v, q, w, free, floor, _, half = _box_state(128, 3, 1)
    ref = rigid.box_floor_substep(p, v, q, w, half, free, floor, 0.025)
    got = rigid.box_floor_substep(*(x.to(card) for x in (p, v, q, w, half, free, floor)), 0.025)
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-5)


def _arm_state(n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.array(FETCH.joint_limits_lower), np.array(FETCH.joint_limits_upper)
    q = np.clip(np.array(FETCH.resting_pose) + rng.normal(0, 0.4, (n, 7)), lo, hi)
    target = np.clip(q + rng.normal(0, 0.3, (n, 7)), lo, hi)
    return [torch.as_tensor(np.asarray(x, np.float32)) for x in (q, rng.normal(0, 1, (n, 7)), target)]


def test_step_arm_on_card_matches_cpu(card):
    """The env's arm step (kp 300, kd 30, dt 1/30, 4 substeps) at N=128."""
    q, qd, target = _arm_state(128, 2)
    ref = arm_dyn.step_arm(FETCH, arm_dyn.default_arm_dynamics(FETCH, kp=300.0, kd=30.0, device="cpu"),
                           q, qd, target, dt=1.0 / 30.0)
    dyn = arm_dyn.default_arm_dynamics(FETCH, kp=300.0, kd=30.0)
    got = arm_dyn.step_arm(FETCH, dyn, q.to(card), qd.to(card), target.to(card), dt=1.0 / 30.0)
    _close(got[0], ref[0])
    _close(got[1], ref[1], rtol=1e-5)


def test_step_arm_and_ik_make_no_host_sync(card):
    """Neither step_arm nor ik_solve waits on the card: every constant is
    made on the device and the solves leave their status there."""
    q, qd, target = (x.to(card) for x in _arm_state(128, 3))
    dyn = arm_dyn.default_arm_dynamics(FETCH, kp=300.0, kd=30.0)
    arm_dyn.step_arm(FETCH, dyn, q, qd, target, dt=1.0 / 30.0)  # warm up allocators and libraries
    kin.ik_solve(FETCH, kin.ee_position(FETCH, target), q, iters=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        arm_dyn.step_arm(FETCH, dyn, q, qd, target, dt=1.0 / 30.0)
        kin.ik_solve(FETCH, kin.ee_position(FETCH, target), q, iters=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")


_CHAIN_URDF = """
<robot name="two_link_slider">
  <link name="base"/> <link name="l1"/> <link name="l2"/> <link name="tip"/>
  <joint name="j1" type="revolute">
    <parent link="base"/> <child link="l1"/> <origin xyz="0 0 0.3"/> <axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="2.0"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/> <child link="l2"/> <origin rpy="-1.5708 0 0" xyz="0.2 0 0"/> <axis xyz="0 0 1"/>
    <limit lower="-1.5" upper="1.5"/>
  </joint>
  <joint name="j3" type="prismatic">
    <parent link="l2"/> <child link="tip"/> <origin xyz="0.25 0 0"/> <axis xyz="1 0 0"/>
    <limit lower="0.0" upper="0.1"/>
  </joint>
</robot>
"""


def test_leg_boxes_and_chain_ik_make_no_host_sync(card):
    """After the first call on the card, which copies their tables there,
    neither Spot's leg boxes nor IK on a URDF chain waits on the card."""
    rng = np.random.default_rng(7)
    chain = urdf.parse_urdf(_CHAIN_URDF).extract_chain()
    q0 = torch.zeros((128, chain.num_joints), device=card)
    q_goal = rng.uniform(-0.5, 0.5, (128, chain.num_joints)).astype(np.float32)
    target = kin.ee_chain(chain, torch.as_tensor(q_goal, device=card))
    base = torch.as_tensor(rng.uniform(-2, 2, (128, 3)).astype(np.float32), device=card)
    yaw = torch.as_tensor(rng.uniform(-3, 3, 128).astype(np.float32), device=card)
    leg_q = torch.as_tensor(np.tile(legs.LEG_INIT, (128, 1)), device=card)
    kin.ik_solve_chain(chain, target, q0, iters=8)
    legs.leg_segment_boxes(base, yaw, leg_q)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kin.ik_solve_chain(chain, target, q0, iters=8)
        legs.leg_segment_boxes(base, yaw, leg_q)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_contact_step_makes_no_host_sync(card):
    p, v, q, w, free, floor, agent, half = (x.to(card) for x in _box_state(128, 3, 6, robot_away=False))
    renv.contact_step(p, v, free, floor, agent, half=half, quat=q, omega=w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        renv.contact_step(p, v, free, floor, agent, half=half, quat=q, omega=w)
        renv.contact_step(p, v, free, floor, agent, half=half)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_contact_step_refuses_a_cpu_floor_with_card_tensors(card):
    p, v, q, w, free, floor, agent, half = _box_state(4, 3, 4)
    with pytest.raises(RuntimeError, match="same device"):
        renv.contact_step(p.to(card), v.to(card), free.to(card), floor, agent.to(card), half=half.to(card),
                          quat=q.to(card), omega=w.to(card))
    with pytest.raises(RuntimeError, match="same device"):
        rigid.box_floor_substep(*(x.to(card) for x in (p, v, q, w, half, free)), floor, 0.025)


def test_settle_objects_runs_on_the_card_by_default(card):
    rng = np.random.default_rng(5)
    init = np.c_[rng.uniform(-0.25, 0.25, (64 * 3, 1)), rng.uniform(0.0, 0.6, (64 * 3, 1)),
                 rng.uniform(-0.25, 0.25, (64 * 3, 1))].reshape(64, 3, 3).astype(np.float32)
    valid = rng.uniform(size=(64, 3)) > 0.2
    floor = rng.uniform(-0.1, 0.1, 64).astype(np.float32)
    got = rgen.settle_objects(init, valid, floor)
    assert isinstance(got, np.ndarray) and got.shape == init.shape and np.isfinite(got).all()
    assert (got[..., 1] >= floor[:, None] - 1e-6)[valid].all()


# -- the rearrangement env on the card ---------------------------------------


def _rearrange_envs(dynamics, with_visual=False, n=8):
    """The same envs on the CPU and on the card, on the CPU env's table."""
    env_c = rgen.make_rearrange_env(device="cpu", num_envs=n, task="pick", num_scenes=1, episodes_per_scene=8,
                                    seed=0, with_visual=with_visual, render_size=(32, 32), dynamics=dynamics)
    env_g = renv.RearrangeBatchedEnv(env_c.pack, env_c.table, env_c.order.numpy(), task="pick",
                                     with_visual=with_visual, render_size=(32, 32), dynamics=dynamics,
                                     device=torch.device("cuda"))
    return env_c, env_g


def _greedy(obs):
    """Discrete greedy action toward the pick target (tests/test_rearrange.py:53-73)."""
    rel = obs["obj_start_sensor"]
    dist = torch.sqrt(rel[:, 0] ** 2 + rel[:, 2] ** 2)
    ang = torch.atan2(-rel[:, 0], -rel[:, 2])
    act = torch.where(ang.abs() < np.deg2rad(12), renv.A_FWD, torch.where(ang > 0, renv.A_LEFT, renv.A_RIGHT))
    return torch.where(dist < 0.7, renv.A_GRAB, act).to(torch.int32)


@pytest.mark.parametrize("dynamics", ["kinematic", "contacts"])
def test_rearrange_step_on_card_matches_cpu(card, dynamics):
    """One env step on the card from each state of a CPU greedy drive, on the
    CPU env's own table: the same done and held; boxes within 1e-5 (6e-5 m
    under contacts, the robot contact's own bound); observations, reward and
    measures within 1e-5, except in the envs whose boxes the contact step
    moved, where they follow the boxes (1e-5 plus twice the step's largest
    box gap; the robot force at the contact gates' 1e-3 + 1e-4 relative)."""
    env_c, env_g = _rearrange_envs(dynamics)
    real_step = renv.contact_step
    sc, oc = env_c.reset_fn()
    for _ in range(30):
        a = _greedy(oc)
        moved = torch.zeros(sc.held.shape, dtype=torch.bool)

        def contact_seen(*args, **kw):
            out = real_step(*args, **kw)
            moved.copy_(((out[0] != args[0]).any(-1) & args[2]).any(-1))
            return out

        with mock.patch.object(renv, "contact_step", contact_seen):
            s1, o1, r1, d1, i1 = env_c.step_fn(sc, a)
        sg, og, rg, dg, ig = env_g.step_fn(sc.to(card), a.to(card))
        assert torch.equal(dg.cpu(), d1) and torch.equal(sg.held.cpu(), s1.held)
        box_gap = (sg.obj_pos.cpu() - s1.obj_pos).abs().max().item()
        assert box_gap <= (1e-5 if dynamics == "kinematic" else 6e-5)
        tol = torch.where(moved, 1e-5 + 2 * box_gap, 1e-5)
        for k, g, c in [("reward", rg, r1)] + [(k, og[k], o1[k]) for k in o1] + [(k, ig[k], i1[k]) for k in i1]:
            d = (g.cpu() - c).abs().reshape(len(tol), -1).amax(-1)
            allowed = tol
            if k in ("robot_force", "articulated_agent_force"):
                allowed = torch.where(moved, 1e-3 + 1e-4 * c.abs(), tol)
            assert (d <= allowed).all(), (k, d, allowed)
        sc, oc = s1, o1


@pytest.mark.parametrize("dynamics", ["kinematic", "contacts"])
def test_rearrange_step_makes_no_host_sync(card, dynamics):
    """step_fn without the render never waits on the card: grasp, release,
    the drop's snap to the navgrid and the contact step included."""
    _, env = _rearrange_envs(dynamics, n=16)
    st, obs = env.reset_fn()
    for a in (_greedy(obs), torch.full((16,), renv.A_GRAB, dtype=torch.int32, device=card)):
        env.step_fn(st, a)  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st, obs, _, _, _ = env.step_fn(st, _greedy(obs))
        env.step_fn(st, torch.full((16,), renv.A_GRAB, dtype=torch.int32, device=card))
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_rearrange_step_with_the_render_makes_no_host_sync(card):
    """The head render too: its scene tables, the sky colour and the
    dynamic geometry's constants are made once per device."""
    _, env = _rearrange_envs("kinematic", with_visual=True, n=16)
    st, obs = env.reset_fn()
    env.step_fn(st, _greedy(obs))  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st, obs, _, _, _ = env.step_fn(st, _greedy(obs))
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_navgrid_makes_no_host_sync(card):
    from habitat_torch.ops import navgrid as ng

    scenes, _ = rgen.make_procedural_rearrange(num_scenes=2, episodes_per_scene=1)
    pack = pack_scenes(scenes).to(card)
    rng = np.random.default_rng(0)
    sid = torch.as_tensor(np.arange(64) % 2, device=card)
    pos = torch.as_tensor(np.c_[rng.uniform(0, 8, 64), np.zeros(64), rng.uniform(0, 8, 64)].astype(np.float32),
                          device=card)
    ng.snap_to_navigable(pack, sid, pos)
    ng.try_step(pack, sid, pos, pos + 0.25)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ng.snap_to_navigable(pack, sid, pos)
        ng.try_step(pack, sid, pos, pos + 0.25)
        ng.is_navigable(pack, sid, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_rearrange_render_launches_the_index_kernel_twice(card):
    """The head render with dynamic geometry: #3 on the static scene and on
    the per-env pass, once each; frames equal the CPU's on >= 99.9% of
    pixels."""
    env_c, env_g = _rearrange_envs("kinematic", with_visual=True)
    sc, oc = env_c.reset_fn()
    before = rk.raycast_index_t.launches
    og = env_g._observations(sc.to(card))
    torch.cuda.synchronize()
    assert rk.raycast_index_t.launches == before + 2
    hit_c, hit_g = oc["robot_head_depth"] < 1.0, og["robot_head_depth"].cpu() < 1.0
    assert (hit_c == hit_g).float().mean() >= 0.999
    assert ((og["robot_head_rgb"].cpu().int() - oc["robot_head_rgb"].int()).abs() <= 1).all(-1).float().mean() >= 0.999


# -- ObjectNav, ImageNav and the Gaussian policy on the card -------------------


def test_goal_images_on_card_match_plain(cuda):
    """ImageNav's goal views rendered at table build through #1 on the card
    against the same render on the CPU: RGB equal on >= 99.9% of pixels,
    one #1 launch for the whole table."""
    from habitat_torch.core import dataset as ds

    scenes, episodes, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)
    args = (episodes, {s.scene_id: s for s in scenes}, {s.scene_id: i for i, s in enumerate(scenes)}, 64)
    before = rk.raycast_fused_sel_t.launches
    got = ds._render_goal_images(*args, device=cuda)
    torch.cuda.synchronize()
    assert rk.raycast_fused_sel_t.launches == before + 1
    ref = ds._render_goal_images(*args, device="cpu")
    assert got.is_cuda and got.shape == ref.shape == (8, 64, 64, 3)
    assert (got.cpu() == ref).all(-1).float().mean().item() >= 0.999


def test_objectnav_step_at_pitch_matches_cpu(cuda):
    """One ObjectNav env step after a look_down (nonzero pitch), card
    against CPU: objectgoal, gps and compass within 1e-5, the frames by the
    frame rule."""
    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct

    cfg = get_config("benchmark/nav/objectnav/objectnav_procgen.yaml", [
        "habitat.dataset.procedural.num_scenes=2", "habitat.dataset.procedural.episodes_per_scene=4"])
    envs = [construct.env_from_config(cfg, num_envs=4, device=d) for d in ("cpu", cuda)]
    outs = []
    for env in envs:
        st, obs = env.reset_fn()
        for a in ([5, 5, 4, 1], [1, 5, 2, 3]):
            st, obs, *_ = env.step_fn(st, torch.tensor(a, dtype=torch.int32, device=env.device))
        outs.append((st, obs))
    (sc, oc), (sg, og) = outs
    assert (sg.pitch.abs() > 0.2).any()
    for k in ("objectgoal", "gps", "compass"):
        assert (og[k].cpu().double() - oc[k].double()).abs().max() <= 1e-5, k
    assert ((og["rgb"].cpu() == oc["rgb"]).all(-1).float().mean() >= 0.999).item()
    assert ((og["depth"].cpu() - oc["depth"]).abs() < 1e-4).float().mean().item() >= 0.999


def test_gaussian_sampling_with_a_cuda_generator(cuda):
    """sample_gaussian_action draws on the card from a CUDA generator: the
    same seed repeats, mu + std * noise has the std asked for, and the log
    prob agrees with evaluate_gaussian_actions."""
    from habitat_torch.models.policy import evaluate_gaussian_actions, sample_gaussian_action

    mu = torch.linspace(-1, 1, 10, device=cuda).expand(4096, 10).contiguous()
    log_std = torch.full_like(mu, -1.0)
    draws = [sample_gaussian_action(mu, log_std, torch.Generator(device=cuda).manual_seed(3)) for _ in range(2)]
    (a, logp), (b, _) = draws
    assert a.is_cuda and torch.equal(a, b)
    std = (a - mu).std(0)
    assert ((std - np.exp(-1.0)).abs() < 0.02).all()
    ref, _ = evaluate_gaussian_actions(mu, log_std, a)
    assert (logp - ref).abs().max().item() < 1e-4
    det, _ = sample_gaussian_action(mu, log_std, torch.Generator(device=cuda), deterministic=True)
    assert torch.equal(det, mu)


# -- the GRU, the bottleneck backbones and DD-PPO's collectives on the card ------


def test_gru_encoder_on_card_matches_cpu(card):
    """The GRU state encoder (2 layers, Flax's cell) in sequence mode with
    episode starts inside the sequence, float32: outputs and final state
    within 1e-5 of the CPU's."""
    from habitat_torch.models.rnn_state_encoder import RNNStateEncoder

    torch.manual_seed(0)
    enc = RNNStateEncoder(48, 64, num_layers=2, rnn_type="GRU")
    x, h = torch.randn(6, 8, 48), torch.randn(8, 2, 1, 64)
    masks = (torch.rand(6, 8) > 0.3).float()
    want = enc(x, h, masks)
    got = enc.to(card)(x.to(card), h.to(card), masks.to(card))
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() < 1e-5


@pytest.mark.parametrize("backbone", ["resnet50", "se_resneXt50"])
def test_bottleneck_stage_on_card_matches_cpu(card, backbone):
    """A bottleneck encoder on the card against the CPU, the same weights:
    in float32 (TF32 off, as the port sets it) the whole net and its first
    block within 1e-4 of the output's scale. In bf16 each of them no
    further from the CPU's bf16 output than 1.5 times that output's own
    distance from the float32 one (tests/test_torch_ppo.py's
    BF16_NOISE_FACTOR): bf16 rounds at every conv and norm, on both
    devices in different orders."""
    from habitat_torch.models.resnet import ResNetEncoder

    obs = {"depth": torch.rand(4, 64, 64, 1, generator=torch.Generator().manual_seed(0))}
    stage_in = torch.randn(4, 32, 16, 16, generator=torch.Generator().manual_seed(1))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        torch.manual_seed(0)  # the same weights in both dtypes
        enc = ResNetEncoder(("depth",), (64, 64), backbone=backbone, dtype=dtype)
        with torch.no_grad():
            cpu = enc(obs), enc.backbone.blocks[0](stage_in.to(dtype)).float()
            enc = enc.to(card)
            got = enc({"depth": obs["depth"].to(card)}).cpu(), enc.backbone.blocks[0](
                stage_in.to(dtype).to(card)).float().cpu()
        out[dtype] = cpu, got
    (want32, stage32), (got32, stage_got32) = out[torch.float32]
    assert (got32 - want32).abs().max() <= 1e-4 * want32.abs().max()
    assert (stage_got32 - stage32).abs().max() <= 1e-4 * stage32.abs().max()
    (want16, stage16), (got16, stage_got16) = out[torch.bfloat16]
    for got, want, ref in ((got16, want16, want32), (stage_got16, stage16, stage32)):
        noise = (want - ref).abs().max()
        assert (got - want).abs().max() <= 1.5 * noise, ((got - want).abs().max(), noise)


def test_categorical_draw_is_multinomials_on_card(card):
    """On the card too, ``sample_action`` draws what ``torch.multinomial``
    draws from the same generator state (one sample: argmax of p / q,
    q ~ Exp(1)), so one-process rollouts keep their actions."""
    from habitat_torch.models.policy import sample_action

    logits = torch.randn(256, 4, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    g_ref = torch.Generator(device=card).manual_seed(0)
    act, _ = sample_action(logits, g)
    ref = torch.multinomial(torch.softmax(logits, -1), 1, generator=g_ref)[:, 0]
    assert torch.equal(act.long(), ref) and torch.equal(g.get_state(), g_ref.get_state())


_GLOO_RANK = """
import sys, torch
sys.path.insert(0, {root!r})
from habitat_torch.parallel import distributed
r = int(sys.argv[1])
dev = distributed.init_distributed({store!r}, 2, r, device="cuda:0", backend="gloo", timeout_s=120)
lin = torch.nn.Linear(8, 4).to(dev)
torch.manual_seed(r)  # each rank its own data
lin(torch.randn(16, 8, device=dev)).square().sum().backward()
grads = [p.grad.clone() for p in lin.parameters()]
distributed.all_reduce_sum_([p.grad for p in lin.parameters()])
flags = distributed.gather_rows(torch.tensor([r == 1], device=dev))
torch.save(dict(local=[g.cpu() for g in grads], summed=[p.grad.cpu() for p in lin.parameters()],
                flags=flags.cpu(), device=str(lin.weight.grad.device)), {out!r}.format(r))
distributed.abort()
"""


def test_gloo_all_reduce_of_card_gradients(card, tmp_path):
    """Two processes on the one card over gloo: each rank's gradients of a
    Linear on cuda:0, summed by ``all_reduce_sum_`` in place, equal the sum
    of both ranks' local gradients on both; ``gather_rows`` joins a bool
    row."""
    import subprocess
    import sys

    root = __file__.rsplit("/tests/", 1)[0]
    code = _GLOO_RANK.format(root=root, store=f"file://{tmp_path}/store", out=str(tmp_path / "rank{}.pt"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)]) for r in range(2)]
    try:
        assert [p.wait(timeout=180) for p in procs] == [0, 0]
    finally:
        for p in procs:
            p.kill()
    out = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for o in out:
        assert o["device"].startswith("cuda") and o["flags"].tolist() == [False, True]
        for s, a, b in zip(o["summed"], out[0]["local"], out[1]["local"]):
            assert torch.allclose(s, a + b, rtol=1e-6, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(out[0]["summed"], out[1]["summed"]))


# -- the geodesic follower, behavior cloning and HRL-PPO (no kernel of their own) --


def _bench_nav_env(device, n, **kw):
    from habitat_torch.core.env_factory import make_nav_env

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    return make_nav_env(scenes, episodes, num_envs=n, precomputed_fields=fields, device=device, **kw)


def _tensor_shares(start, a, b, lr):
    """Per tensor, the share of elements whose changes from ``start`` on the
    two devices agree within lr/10 (chip_smoke.py's [check] rule)."""
    return {k: ((a[k] - b[k]).abs() <= lr / 10).double().mean().item() for k in start}


def test_greedy_follower_on_card_matches_cpu_without_host_sync(card):
    """``greedy_follower_step`` on 1024 poses of the bench scenes (random
    navigable cells, a sixth within 0.15 m of the goal): the card's actions
    equal the CPU's, and a call makes no host sync."""
    from habitat_torch.ops import navgrid as ng

    env = _bench_nav_env("cpu", 8)
    rng = np.random.default_rng(0)
    m = 1024
    ep = rng.integers(0, env.table.num_episodes, m)
    sid = env.table.scene_idx[ep].long()
    occ, lo, res = env.pack.nav_occ.numpy(), env.pack.nav_lo.numpy(), env.pack.nav_res
    pos = np.zeros((m, 3), np.float32)
    for i in range(m):
        if i % 6 == 0:
            xz = env.table.goal_pos[ep[i], 0].numpy()[[0, 2]] + rng.uniform(-0.1, 0.1, 2)
        else:
            cells = np.argwhere(occ[sid[i]])
            xz = lo[sid[i]] + (cells[rng.integers(len(cells))] + rng.uniform(-0.5, 0.5, 2)) * res
        pos[i] = [xz[0], env.pack.floor_y[sid[i]].item(), xz[1]]
    args = (sid, env.table.dist_field, torch.from_numpy(ep), torch.from_numpy(pos),
            torch.as_tensor(rng.uniform(-np.pi, np.pi, m), dtype=torch.float32))
    kw = dict(goal_radius=0.2, forward_step=0.25, turn_angle=float(np.deg2rad(10.0)))
    ref = ng.greedy_follower_step(env.pack, *args, **kw)
    pack, cargs = env.pack.to(card), [a.to(card) for a in args]
    ng.greedy_follower_step(pack, *cargs, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ng.greedy_follower_step(pack, *cargs, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    parted = (got.cpu() != ref).nonzero()[:, 0].tolist()
    assert not parted, f"{len(parted)} of {m} actions part: {parted[:10]}"
    assert set(ref.unique().tolist()) == {0, 1, 2, 3}


def test_bc_train_step_on_card_matches_cpu(card):
    """One BC train step (blind LSTM-512, pointgoal, N=8, T=32, float32)
    from the same weights and env state: teachers equal at every env and
    step, the loss within 1e-5 relative, each tensor's parameters by the
    share rule at BC's lr."""
    from habitat_torch.baselines.il.bc_trainer import BCConfig, BCLearner
    from habitat_torch.models.policy import make_pointnav_resnet_policy

    torch.manual_seed(0)
    start = make_pointnav_resnet_policy(4, has_visual=False, hidden_size=512, dtype=torch.float32,
                                        device="cpu").state_dict()
    out = {}
    for d in ("cpu", card):
        pol = make_pointnav_resnet_policy(4, has_visual=False, hidden_size=512, dtype=torch.float32, device=d)
        pol.load_state_dict(start)
        lrn = BCLearner(_bench_nav_env(d, 8, max_episode_steps=20), pol, BCConfig())
        _, batch = lrn.collect_rollout(lrn.init())
        m, _ = lrn.update(batch)
        out[str(d)] = batch["teacher"].cpu(), m["losses/bc_loss"].item(), {k: v.cpu() for k, v in pol.state_dict().items()}
    (t_cpu, l_cpu, p_cpu), (t_card, l_card, p_card) = out["cpu"], out[str(card)]
    assert torch.equal(t_card, t_cpu)
    assert abs(l_card - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu))
    shares = _tensor_shares(start, p_card, p_cpu, BCConfig().lr)
    assert min(shares.values()) >= 0.99, min(shares.items(), key=lambda kv: kv[1])


def test_hrl_ppo_train_step_on_card_matches_cpu(card):
    """One HRL-PPO train step (the four oracle skills, N=8, 4 macro steps of
    8 env steps, hidden 64) from the same weights and draws: macro rewards
    within 1e-5, dones equal, losses within 1e-5 relative, each tensor's
    parameters by the share rule."""
    from habitat_torch.baselines.hrl.hierarchical import default_rearrange_plan
    from habitat_torch.baselines.hrl.hrl_ppo import HrlPPOConfig, HrlPPOLearner

    cfg = HrlPPOConfig(num_macro_steps=4, hl_interval=8, hidden_size=64)
    kw = dict(num_envs=8, task="rearrange", num_scenes=2, episodes_per_scene=8, seed=0, with_visual=False,
              n_rooms_per_axis=1, n_clutter=0, max_episode_steps=12)
    draws = torch.randint(0, 4, (cfg.num_macro_steps, 8), generator=torch.Generator().manual_seed(0))
    torch.manual_seed(0)
    start = None
    out = {}
    for d in ("cpu", card):
        lrn = HrlPPOLearner(rgen.make_rearrange_env(device=d, **kw), default_rearrange_plan(), cfg)
        start = start or {k: v.clone() for k, v in lrn.net.state_dict().items()}
        lrn.net.load_state_dict(start)
        _, batch = lrn.collect_rollout(lrn.init(), skills=draws.to(d))
        m = lrn.update(batch)
        out[str(d)] = ({k: batch[k].cpu() for k in ("rewards", "dones")},
                       {k: v.item() for k, v in m.items() if k.startswith("losses/")},
                       {k: v.cpu() for k, v in lrn.net.state_dict().items()})
    (b_cpu, l_cpu, p_cpu), (b_card, l_card, p_card) = out["cpu"], out[str(card)]
    assert torch.equal(b_card["dones"], b_cpu["dones"]) and b_cpu["dones"].any()
    torch.testing.assert_close(b_card["rewards"], b_cpu["rewards"], atol=1e-5, rtol=1e-5)
    for k in l_cpu:
        assert abs(l_card[k] - l_cpu[k]) <= 1e-5 * max(1.0, abs(l_cpu[k])), k
    shares = _tensor_shares(start, p_card, p_cpu, cfg.lr)
    assert min(shares.values()) >= 0.99, min(shares.items(), key=lambda kv: kv[1])


def _vln_env(device, n=8, depth=32):
    from habitat_torch.tasks.vln import make_vln_env

    specs = (("HabitatSimDepthSensor", {"height": depth, "width": depth}),) if depth else ()
    return make_vln_env(num_envs=n, num_scenes=1, episodes_per_scene=8, seed=0, with_pointgoal=False,
                        max_episode_steps=40, visual_specs=specs, device=device)


def _language_policy(env, device, hidden=64):
    from habitat_torch.models.policy import make_pointnav_resnet_policy, obs_inputs_of

    shapes = env.observation_shapes
    kw = dict(visual_inputs=("depth",), input_hw=tuple(shapes["depth"][0][:2])) if "depth" in shapes else {}
    return make_pointnav_resnet_policy(env.num_actions, backbone="resnet9", hidden_size=hidden,
                                       has_visual="depth" in shapes, goal_keys=(), dtype=torch.float32, device=device,
                                       **obs_inputs_of(shapes), **kw)


def test_vln_bc_update_on_card_matches_cpu(card):
    """One VLN BC update (instruction + GPS + compass, blind as
    test_bc_train_step_on_card_matches_cpu's: a fresh Adam step is sign(g)
    * lr, and the stem's near-zero gradients part in sign between cuDNN's
    and the CPU's convolutions; LSTM-64, N=8, T=8, float32) from the same
    weights: teachers of each device's rollout equal, and on the card's
    batch the loss within 1e-5 relative and each tensor by the share rule
    at BC's lr."""
    from habitat_torch.baselines.il.bc_trainer import BCConfig, BCLearner

    torch.manual_seed(0)
    start = _language_policy(_vln_env("cpu", depth=None), "cpu").state_dict()
    out = {}
    for d in (card, "cpu"):
        env = _vln_env(d, depth=None)
        pol = _language_policy(env, d)
        pol.load_state_dict(start)
        lrn = BCLearner(env, pol, BCConfig(num_steps=8))
        _, batch = lrn.collect_rollout(lrn.init())
        out[str(d)] = lrn, pol, batch
    (l_card, p_card, b_card), (l_cpu, p_cpu, b_cpu) = out[str(card)], out["cpu"]
    assert torch.equal(b_card["teacher"].cpu(), b_cpu["teacher"])
    m_card, _ = l_card.update(b_card)
    on_cpu = {k: ({o: x.cpu() for o, x in v.items()} if isinstance(v, dict) else v.cpu()) for k, v in b_card.items()}
    m_cpu, _ = l_cpu.update(on_cpu)
    a, b = m_card["losses/bc_loss"].item(), m_cpu["losses/bc_loss"].item()
    assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
    shares = _tensor_shares(start, {k: v.cpu() for k, v in p_card.state_dict().items()}, p_cpu.state_dict(),
                            BCConfig().lr)
    assert min(shares.values()) >= 0.99, min(shares.items(), key=lambda kv: kv[1])


def test_language_policy_on_card_matches_cpu(card):
    """The policy with instruction tokens (padded, an all-pad row) and the
    referent candidates, blind, float32: logits, values and hidden state on
    the card within 1e-5 of the CPU's."""
    env = _vln_env("cpu", n=4, depth=None)
    torch.manual_seed(0)
    pol = _language_policy(env, "cpu")
    rng = np.random.default_rng(0)
    toks = np.zeros((5, 64), np.int32)
    for i in range(4):
        k = int(rng.integers(1, 64))
        toks[i, :k] = rng.integers(1, 128, k)
    obs = {"instruction": torch.as_tensor(toks), "gps": torch.randn(5, 2), "compass": torch.randn(5, 1)}
    args = (pol.initial_hidden(5), torch.tensor([0, 1, 2, 3, 0]), torch.tensor([0.0, 1, 1, 0, 1]))
    with torch.no_grad():
        ref = pol(obs, *args)
        card_pol = _language_policy(env, card)
        card_pol.load_state_dict(pol.state_dict())
        got = card_pol({k: v.to(card) for k, v in obs.items()}, *(a.to(card) for a in args))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("trainer", ["eqa-cnn-pretrain", "vqa", "pacman"])
def test_eqa_learner_step_on_card_matches_cpu(card, trainer):
    """One step of each EQA learner (float32 models) from the same weights on
    the card's inputs (the CNN pretrain walk's frames, VQA's frame and goal
    table, PACMAN's expert batch): losses within 1e-5 relative, each tensor
    by the share rule at the learner's lr."""
    from types import SimpleNamespace

    from habitat_torch.baselines.il.eqa_trainers import EQACNNPretrainLearner, VQALearner
    from habitat_torch.baselines.il.pacman import PacmanTrainer
    from habitat_torch.tasks.eqa import make_eqa_env

    cpu = torch.device("cpu")
    torch.manual_seed(0)
    if trainer == "eqa-cnn-pretrain":
        from habitat_torch.core.env_factory import make_nav_env

        scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0, extent=6.0)
        frame = {"height": 32, "width": 32}
        env = make_nav_env(scenes, episodes, num_envs=4, precomputed_fields=fields, device=card,
                           sensor_specs=(("HabitatSimRGBSensor", frame), ("HabitatSimDepthSensor", frame),
                                         ("HabitatSimSemanticSensor", frame)))
        g, c, lr = EQACNNPretrainLearner(env, 16), EQACNNPretrainLearner(SimpleNamespace(device=cpu), 16), 1e-3
        frames = g.frames(env.step_fn(env.reset_fn()[0], torch.tensor([1, 2, 3, 1], device=card))[1])
        step_g, step_c = (lambda: g.update(*frames)), (lambda: c.update(*(f.cpu() for f in frames)))
    elif trainer == "vqa":
        env = make_eqa_env(num_envs=4, num_scenes=1, episodes_per_scene=4, visual_size=32, device=card)
        g, lr = VQALearner(env, vocab_size=64, num_answers=10), 3e-4
        c = VQALearner(SimpleNamespace(device=cpu, observation_shapes=env.observation_shapes, table=env.table.to(cpu)),
                       vocab_size=64, num_answers=10)
        st, obs = env.reset_fn()
        cpu_st = type(st)(**{f: (v.cpu() if isinstance(v, torch.Tensor) else v) for f, v in vars(st).items()})
        step_g, step_c = (lambda: g.train_step(st, obs)), (lambda: c.train_step(cpu_st, {"rgb": obs["rgb"].cpu()}))
    else:
        env = make_eqa_env(num_envs=8, num_scenes=1, episodes_per_scene=4, max_episode_steps=40, device=card)
        g, c, lr = PacmanTrainer(env, max_T=24), PacmanTrainer(SimpleNamespace(device=cpu), max_T=24), 1e-3
        batch = g.collect_expert(0)
        g.init_fn(0, batch)
        c.init_fn(0, batch)
        step_g, step_c = (lambda: g.train_step(g.prepare_batch(batch))), (lambda: c.train_step(c.prepare_batch(batch)))
    start = {k: v.detach().cpu().clone() for k, v in g.model.state_dict().items()}
    c.model.load_state_dict(start)
    m_g, m_c = step_g(), step_c()
    for k in m_c:
        assert abs(m_g[k].item() - m_c[k].item()) <= 1e-5 * max(1.0, abs(m_c[k].item())), k
    shares = _tensor_shares(start, {k: v.cpu() for k, v in g.model.state_dict().items()}, c.model.state_dict(), lr)
    assert min(shares.values()) >= 0.99, min(shares.items(), key=lambda kv: kv[1])


SMALL_NAV = ["habitat.dataset.procedural.num_scenes=2", "habitat.dataset.procedural.episodes_per_scene=3",
             "habitat.environment.max_episode_steps=20"]


def test_env_step_at_128_launches_fused_sel_and_matches_plain(cuda):
    """The single-env Env at pointnav_procgen.yaml's 128x128 depth on the
    card: #1 launched once per render (the reset, each step, each
    render()), no plain version on a card tensor; its frames and metrics
    against the same Env on the CPU (plain versions): depth within 1e-4 on
    >= 99.9% of pixels, metrics within 1e-5."""
    from habitat_torch.config.default import get_config
    from habitat_torch.core.env import Env

    cfg = get_config("benchmark/nav/pointnav/pointnav_procgen.yaml", SMALL_NAV)
    ge, ce = Env(cfg, device=cuda), Env(cfg, device="cpu")
    plain, orig = [], rk.raycast_fused_sel_t_plain
    with mock.patch.object(rk, "raycast_fused_sel_t_plain", side_effect=lambda *a, **k: plain.append(a) or orig(*a, **k)):
        before = rk.raycast_fused_sel_t.launches
        go = ge.reset()
        for a in (1, 2, 1):
            go = ge.step(a)
        frame = ge.render()
        torch.cuda.synchronize()
        assert rk.raycast_fused_sel_t.launches == before + 5 and not plain
    co = ce.reset()
    for a in (1, 2, 1):
        co = ce.step(a)
    assert go["depth"].is_cuda and go["depth"].shape == (128, 128, 1)
    assert ((go["depth"].cpu() - co["depth"]).abs() < 1e-4).float().mean().item() >= 0.999
    gm, cm = ge.get_metrics(), ce.get_metrics()
    assert set(gm) == set(cm) and all(abs(float(gm[k]) - float(cm[k])) <= 1e-5 for k in cm)
    assert frame.shape == (128, 128, 3) and (np.abs(frame.astype(int) - ce.render().astype(int)) <= 1).mean() >= 0.999


def test_velocity_step_on_card_matches_cpu(card):
    """One velocity-control step at N=8 (4 sub-moves), card against CPU:
    positions and yaws within 1e-5, dones equal."""
    from habitat_torch.config.default import get_config
    from habitat_torch.config.omega import Config, read_write
    from habitat_torch.core.construct import env_from_config

    cfg = get_config("benchmark/nav/pointnav/pointnav_procgen.yaml", SMALL_NAV + [
        "habitat.simulator.agents.main_agent.sim_sensors.depth_sensor.width=32",
        "habitat.simulator.agents.main_agent.sim_sensors.depth_sensor.height=32"])
    with read_write(cfg) as c:
        c.habitat.task.actions = Config({"velocity_control": Config({"type": "VelocityAction"})})
    acts = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (8, 2)), dtype=torch.float32)
    acts[0] = torch.tensor([-1.0, 0.0])  # under both minimums: auto-stop
    outs = []
    for dev in ("cpu", card):
        env = env_from_config(cfg, num_envs=8, device=dev)
        st, _ = env.reset_fn()
        outs.append(env.step_fn(st, acts.to(dev)))
    (sc, _, _, dc, _), (sg, _, _, dg, _) = outs
    assert torch.equal(dg.cpu(), dc) and bool(dc[0])
    for name in ("pos", "yaw"):
        assert (getattr(sg, name).cpu() - getattr(sc, name)).abs().max() <= 1e-5, name


def test_render_keyframe_launches_fused_sel_and_matches_plain(cuda):
    """A gfx-replay keyframe rendered at 256x256 through #1 on the card
    against the plain version on the CPU: RGB equal on >= 99.9% of pixels,
    one launch."""
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.utils.gfx_replay import render_keyframe

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=1, episodes_per_scene=2, seed=0)
    kf = {"agent": {"position": [float(x) for x in episodes[0].start_position], "yaw": 0.7}}
    frames = []
    for dev in ("cpu", cuda):
        env = make_nav_env(scenes, episodes, 1, precomputed_fields=fields, device=dev)
        before = rk.raycast_fused_sel_t.launches
        frames.append(render_keyframe(env, kf))
        torch.cuda.synchronize()
        assert rk.raycast_fused_sel_t.launches == before + (dev != "cpu")
    ref, got = frames
    assert got["rgb"].is_cuda and got["rgb"].shape == (256, 256, 3)
    assert (got["rgb"].cpu() == ref["rgb"]).all(-1).float().mean().item() >= 0.999


def test_visual_social_step_on_card_matches_cpu(cuda):
    """A visual social-nav step at N=4, 32x32: the head render launches #3
    twice (the scene and the humanoid's dynamic pass) and runs no plain
    version; state and state sensors equal the CPU env's within 1e-5,
    frames' hit/miss on >= 99.9% of pixels."""
    from habitat_torch.tasks.rearrange.social_nav import make_social_nav_env

    kw = dict(num_envs=4, num_scenes=1, episodes_per_scene=4, seed=2, with_visual=True, render_size=(32, 32))
    acts = torch.tensor([1, 2, 3, 1])
    outs = []
    for dev in ("cpu", cuda):
        env = make_social_nav_env(device=dev, **kw)
        st, _ = env.reset_fn()
        before = rk.raycast_index_t.launches
        if dev == "cpu":
            outs.append(env.step_fn(st, acts))
        else:
            with mock.patch.object(rk.raycast_index_t, "plain", side_effect=AssertionError("plain on a card tensor")):
                outs.append(env.step_fn(st, acts.to(dev)))
        torch.cuda.synchronize()
        assert rk.raycast_index_t.launches == before + 2 * (dev != "cpu")
    (sc, oc, rc_, dc, _), (sg, og, rg, dg, _) = outs
    assert torch.equal(dg.cpu(), dc) and (rg.cpu() - rc_).abs().max() <= 1e-5
    for name in ("pos", "yaw", "human_pos"):
        assert (getattr(sg, name).cpu() - getattr(sc, name)).abs().max() <= 1e-5, name
    for k in ("gps", "compass", "humanoid_detector_sensor", "other_agent_gps"):
        assert (og[k].cpu() - oc[k]).abs().max() <= 1e-5, k
    assert ((og["robot_head_depth"].cpu() < 1.0) == (oc["robot_head_depth"] < 1.0)).float().mean() >= 0.999


def test_two_agent_update_on_card(cuda):
    """One TwoAgentPPOLearner train step on the card (N=4, T=4, two blind
    resnet9 policies): finite losses and both policies' weights moved."""
    from habitat_torch.baselines.multi_agent import TwoAgentPPOLearner
    from habitat_torch.baselines.ppo import PPOConfig
    from habitat_torch.models.policy import make_pointnav_resnet_policy, state_keys_of
    from habitat_torch.tasks.rearrange.social_nav import make_social_nav_env

    env = make_social_nav_env(num_envs=4, num_scenes=1, episodes_per_scene=4, seed=2, two_agent=True, device=cuda)
    pols = [make_pointnav_resnet_policy(env.num_actions, has_visual=False, hidden_size=32, goal_keys=(),
                                        backbone="resnet9", state_keys=state_keys_of(env.agent_observation_shapes(i)),
                                        device=cuda) for i in range(2)]
    before = [{k: v.clone() for k, v in p.state_dict().items()} for p in pols]
    lrn = TwoAgentPPOLearner(env, pols, PPOConfig(num_steps=4, num_mini_batch=1, ppo_epoch=2))
    ts, m = lrn.train_step(lrn.init(seed=0))
    assert all(np.isfinite(v.item()) for v in m.values())
    for p, b in zip(pols, before):
        assert any(not torch.equal(v, b[k]) for k, v in p.state_dict().items())


def test_hab3_step_on_card_matches_cpu(cuda):
    """The two-agent pick_procgen.yaml env (Spot + humanoid, contacts, the
    128x128 head render) one step on the card against the CPU: #3 launched
    twice, the agents' state sensors and predicates equal within 1e-5."""
    from habitat_torch.config.default import get_config
    from habitat_torch.core.construct import rearrange_env_from_config

    cfg = get_config("benchmark/rearrange/pick_procgen.yaml", [
        "habitat.simulator.agents.main_agent.articulated_agent_type=SpotRobot",
        "habitat.simulator.agents.agent_1.articulated_agent_type=KinematicHumanoid",
        "habitat.task.actions.agent_0_base_velocity.type=BaseVelAction",
        "habitat.task.actions.agent_1_oracle_nav_action.type=OracleNavAction",
        "habitat.task.actions.agent_1_pddl_apply_action.type=PddlApplyAction",
        "habitat.task.lab_sensors.multi_agent_all_predicates.type=MultiAgentGlobalPredicatesSensor"])
    outs = []
    for dev in ("cpu", cuda):
        env = rearrange_env_from_config(cfg, num_envs=4, device=dev)
        st, _ = env.reset_fn()
        a = torch.zeros((4, env.action_dim), device=dev)
        a[:, 0], a[:, 2], a[:, 4] = 1.0, 2.0, 1.0  # robot forward, humanoid to entity 2, pddl pick(object 1)
        before = rk.raycast_index_t.launches
        outs.append(env.step_fn(st, a))
        torch.cuda.synchronize()
        assert rk.raycast_index_t.launches == before + 2 * (dev != "cpu")
    (sc, oc, _, dc, _), (sg, og, _, dg, _) = outs
    assert torch.equal(dg.cpu(), dc) and torch.equal(sg.human_held.cpu(), sc.human_held)
    for k in ("agent_0_localization_sensor", "agent_1_localization_sensor", "all_predicates",
              "agent_1_other_agent_gps"):
        assert (og[k].cpu() - oc[k]).abs().max() <= 1e-5, k


# -- articulated scenes and the reach task on the card --------------------------


def test_art_scene_step_on_card_matches_cpu(cuda):
    """24 opener steps of the URDF cabinet env on the card from beside the
    handles, each also taken on the CPU from the card's state: done and discrete fields equal, state,
    state sensors, reward and measures within 1e-5 (+ 1e-5 relative); #3
    launched exactly twice per render (the reset and each step)."""
    import dataclasses

    from habitat_torch.tasks.rearrange.art_scene import art_scene_envs, opener_action

    # [art-scene]'s env at N=8: one scene of 8 episodes, 32x32 head render
    urdf = os.path.join(os.path.dirname(__file__), "assets", "mini_dataset", "urdf", "kitchen_cabinet.urdf")
    env_g, env_c, _, _ = art_scene_envs(urdf, cuda, num_envs=8, num_scenes=1, episodes_per_scene=8,
                                        render_size=(32, 32))
    before = rk.raycast_index_t.launches
    st, _ = env_g.reset_fn()
    h = env_g._handle_pos(st)  # start 0.4 m beside each handle, so that the opener pulls
    st = dataclasses.replace(st, pos=torch.stack([h[:, 0] + 0.4, st.pos[:, 1], h[:, 2]], dim=-1))
    moved = 0.0
    for _ in range(24):
        a = opener_action(env_g, st)
        out_g = env_g.step_fn(st, a)
        out_c = env_c.step_fn(st.to(torch.device("cpu")), a.cpu())
        (sg, og, rg, dg, ig), (sc, oc, rc_, dc, ic) = out_g, out_c
        assert torch.equal(dg.cpu(), dc)
        for name, g, c in ([(f.name, getattr(sg, f.name), getattr(sc, f.name)) for f in dataclasses.fields(sc)]
                           + [(k, og[k], oc[k]) for k in oc] + [("reward", rg, rc_)] + [(k, ig[k], ic[k]) for k in ic]):
            g = g.cpu()
            if c.is_floating_point():
                assert ((g - c).abs() <= 1e-5 + 1e-5 * c.abs()).all(), name
            else:
                assert torch.equal(g, c), name
        moved = max(moved, (sg.art_q - st.art_q).abs().max().item())
        st = sg
    torch.cuda.synchronize()
    assert rk.raycast_index_t.launches == before + 2 * 25
    assert moved > 0.01, "no drawer moved"


def test_reach_goal_table_on_card(card):
    """The reach env on the card: its goal offsets bit-equal to the CPU
    env's (host draws, moved once), the goals within 1e-6, and a step
    without host sync."""
    import types

    kw = dict(num_envs=8, task="reach", with_visual=False, control="arm", n_rooms_per_axis=1, n_clutter=0,
              num_scenes=2, episodes_per_scene=8, seed=0)
    env_c = rgen.make_rearrange_env(device="cpu", **kw)
    env_g = rgen.make_rearrange_env(device=card, **kw)
    assert torch.equal(env_g._reach_offsets.cpu(), env_c._reach_offsets)
    ep = torch.arange(env_c._reach_offsets.shape[0])
    goal_c = env_c._desired_rest(types.SimpleNamespace(ep_idx=ep))
    goal_g = env_g._desired_rest(types.SimpleNamespace(ep_idx=ep.to(card))).cpu()
    assert (goal_g - goal_c).abs().max() <= 1e-6
    st, _ = env_g.reset_fn()
    a = torch.full((8, env_g.action_dim), 0.3, device=card)
    env_g.step_fn(st, a)  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env_g.step_fn(st, a)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# -- the single-env simulator and the sampling agents on the card ----------------


def test_tpu_sim_frames_on_card_match_cpu(cuda):
    """TpuSim on the card beside one on the CPU through the same actions:
    poses and collision flags equal, frames by the frame rule (depth within
    1e-4, RGB equal on >= 99.9% of pixels); #1 once per step; its frame at
    the last pose held to #1's plain version on the same rays (``_agree``)."""
    from habitat_torch.sims.tpu_sim import TpuSim

    g, c = TpuSim(None, device=cuda), TpuSim(None, device="cpu")
    before = rk.raycast_fused_sel_t.launches
    acts = [1] * 6 + [2, 2, 1, 1, 4, 5, 3, 1]
    for a in acts:
        og, oc = g.step(a), c.step(a)
        np.testing.assert_array_equal(g._pos, c._pos)
        assert g._collided == c._collided
        assert np.abs(og["depth"] - oc["depth"]).max() <= 1e-4
        assert (og["rgb"] == oc["rgb"]).all(-1).mean() >= 0.999
    torch.cuda.synchronize()
    assert rk.raycast_fused_sel_t.launches == before + len(acts)
    cam = torch.tensor(g._pos + np.float32([0.0, 1.25, 0.0]), device=cuda)[None]
    yaw = torch.full((1,), g._yaw, dtype=torch.float32, device=cuda)
    pitch = torch.full((1,), g._pitch, dtype=torch.float32, device=cuda)
    kernel, args, kwargs, _ = rc.closest_hit_call(g.pack, torch.zeros(1, dtype=torch.int64, device=cuda), cam, yaw,
                                                  pitch, height=128, width=128)
    assert kernel is rk.raycast_fused_sel_t
    got = kernel(*args, **kwargs)
    _agree(rk.raycast_fused_sel_t_plain(*[a.cpu() for a in args], **kwargs), got)


def test_gumbel_noise_on_card(cuda):
    """The noise tables the agents draw on the host reach the card unchanged,
    and PPOAgent's card act samples from them: noise + logits argmax."""
    from habitat_torch.baselines.hrl.hierarchical import NnSkill
    from habitat_torch.utils import threefry

    skill = NnSkill(None, done_fn=None, deterministic=False)
    table = skill._gumbel(128, 4, cuda)
    assert table.device.type == "cuda"
    assert torch.equal(table.cpu(), torch.from_numpy(threefry.gumbel(threefry.prng_key(0), (128, 4))))
    assert skill._gumbel(128, 4, cuda) is table
    logits = torch.randn(128, 4, device=cuda)
    assert torch.equal((logits + table).argmax(-1).cpu(),
                       torch.from_numpy(np.argmax(threefry.gumbel(threefry.prng_key(0), (128, 4))
                                                  + logits.cpu().numpy(), -1)))
