"""The tile-cull kernel (#10 ``raycast_tilecull_t``) at the edges of the ring
design it shares with #1, on the CPU: the port's plain version (what the
wrapper takes for CPU tensors) against the JAX package's
``raycast_pallas_tilecull_t`` under ``pltpu.force_tpu_interpret_mode()``, on
the same numpy-seeded inputs.

- ``cnt0``: one tile of each env (the lower) lists no chunk (the rest list every chunk
  of the bench scene, K = 4 chunks of 32, in a seeded order): all 16 rows
  zero but the shade 0.35, t = 1e6 there;
- ``cnt_over_K``: counts above the list's length K, which both read as K;
- ``C128``: the mid-size scene (4,352 triangles, 34 chunks of 128) with its
  frustum-selected lists of 128-triangle chunks;
- ``tile1536``: 48x64 pinhole images in two ray tiles of 1536 rays, a tile
  the JAX kernel takes and not a multiple of the card kernel's 1024-ray
  blocks, with frustum-selected lists.

Tolerance (that of tests/test_torch_raybatch.py): hit/miss equal, the gid
row equal on >= 99.9% of hits (float32 determinants summed in another
order; equality is expected on these inputs), t within 1e-4 m and every
row within 1e-6 where the winner is the same (the JAX one-hot products are
exact on the CPU); the gid row equal to #1's winner (the plain
``raycast_fused_sel_t``) on every ray.
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
from habitat_tpu.utils.geometry import camera_rays as jax_camera_rays

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


@pytest.fixture(scope="module")
def packs():
    """JAX packs of the two bench scenes (T = 128) and of the mid-size scene
    (4,352 triangles), each with N = 2 poses at camera height inside."""
    out = {}
    for name, kw in (("bench", dict(num_scenes=2)),
                     ("mid", dict(num_scenes=1, extent=30.0, scene_kw=dict(n_clutter=420)))):
        scenes, episodes, _ = jax_pointnav(episodes_per_scene=N, seed=0, **kw)
        sids = np.arange(N, dtype=np.int32) % len(scenes)
        # env i at the start of an episode of its scene
        starts = [[e.start_position for e in episodes if e.scene_id == s.scene_id] for s in scenes]
        pos = np.stack([starts[s][i // len(scenes)] for i, s in enumerate(sids)]).astype(np.float32)
        pos[:, 1] += 1.25
        rng = np.random.RandomState(3)
        out[name] = dict(pack=jax_pack(scenes), pos=pos, yaw=rng.uniform(-np.pi, np.pi, N).astype(np.float32),
                         sids=sids)
    return out


def _pinhole(p, H, W, rt):
    """d_t (nt, 8, rt) and Bt (N, 16, 4) of 90-degree pinhole cameras."""
    d_cam = jax_camera_rays(jnp.float32(0), jnp.float32(0), jnp.deg2rad(90.0), H, W).reshape(-1, 3)
    d_aug = jnp.concatenate([d_cam, jnp.ones((H * W, 1), jnp.float32)], -1)
    d_t = jnp.pad(d_aug.reshape(H * W // rt, rt, 4).transpose(0, 2, 1), ((0, 0), (0, 4), (0, 0)))
    B = jrc.ray_feature_matrix(jnp.asarray(p["pos"]), jnp.asarray(p["yaw"]), jnp.zeros(N, jnp.float32))
    Bt = jnp.pad(B.transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))
    return d_t, Bt


def _case(packs, case):
    """(pack, C, rt, d_t, Bt, ids, cnt) of a case, numpy."""
    p = packs["mid" if case == "C128" else "bench"]
    C = 128 if case == "C128" else 32
    H, W = (48, 64) if case == "tile1536" else (64, 64)
    rt = 1536 if case == "tile1536" else 2048
    d_t, Bt = _pinhole(p, H, W, rt)
    nt = H * W // rt
    pj = p["pack"]
    if case in ("C128", "tile1536"):
        planes = jnp.asarray(jrc.tile_plane_normals_cam(np.deg2rad(90.0), H, W, rt // W, W))
        ids, cnt = jrc.select_chunks_frustum(
            pj.tri_v0, pj.tri_e1, pj.tri_e2, pj.tri_valid, jnp.asarray(p["sids"]), jnp.asarray(p["pos"]),
            jnp.asarray(p["yaw"]), jnp.zeros(N, jnp.float32), planes, tri_chunk=C)
        ids, cnt = np.asarray(ids), np.asarray(cnt)
    else:
        K = pj.tri_mat.shape[3] // C
        rng = np.random.RandomState(5)
        ids = np.stack([np.stack([rng.permutation(K) for _ in range(nt)]) for _ in range(N)]).astype(np.int32)
        cnt = np.full((N, nt), K, np.int32)
        if case == "cnt0":
            cnt[:, -1] = 0  # the lower tile, the floor
        else:
            cnt += 3
    return p, C, rt, np.asarray(d_t), np.asarray(Bt), ids, cnt


@pytest.mark.parametrize("case", ["cnt0", "cnt_over_K", "C128", "tile1536"])
def test_tilecull_plain_matches_pallas_at_ring_edges(packs, case):
    p, C, rt, d_t, Bt, ids, cnt = _case(packs, case)
    pj = p["pack"]
    K = ids.shape[2]
    if case == "C128":
        assert K > 2 * trk.RING_STAGES and (cnt > trk.RING_STAGES).any()
    if case == "cnt_over_K":
        assert (cnt > K).all()
    gm = jrp.group_tri_mat(pj.tri_mat, tri_chunk=C)
    with pltpu.force_tpu_interpret_mode():
        a16_j = jax.jit(jrp.attr16_table, static_argnames="tri_chunk")(pj.tri_attr, pj.tri_v0, tri_chunk=C)
        t_j, a_j = jax.jit(jrp.raycast_pallas_tilecull_t, static_argnames=("ray_tile", "tri_chunk"))(
            gm, a16_j, jnp.asarray(ids), jnp.asarray(cnt), jnp.asarray(p["sids"]), jnp.asarray(d_t),
            jnp.asarray(Bt), ray_tile=rt, tri_chunk=C)
    args = (_t(gm), _t(a16_j), _t(ids), _t(cnt), _t(p["sids"]), _t(d_t), _t(Bt))
    before = trk.raycast_tilecull_t.launches
    t_p, a_p = trk.raycast_tilecull_t(*args, ray_tile=rt, tri_chunk=C)
    assert trk.raycast_tilecull_t.launches == before  # CPU tensors: the plain version
    t_j, a_j, t_p, a_p = np.asarray(t_j).reshape(N, -1), np.asarray(a_j), t_p.numpy(), a_p.numpy()
    nt = d_t.shape[0]
    assert a_p.shape == a_j.shape == (N, nt, 16, rt) and t_p.shape == (N, nt * rt)
    hit_j, hit_p = a_j[:, :, 11] > 0.5, a_p[:, :, 11] > 0.5  # (N, nt, rt)
    np.testing.assert_array_equal(hit_j, hit_p)
    assert 0.2 < hit_p[cnt > 0].mean() < 1.0, "the cameras should see geometry and sky"
    same = hit_p & (a_j[:, :, 6] == a_p[:, :, 6])
    assert same[hit_p].mean() >= 0.999
    assert np.abs(t_j.reshape(N, nt, rt)[same] - t_p.reshape(N, nt, rt)[same]).max() < 1e-4
    rows_j, rows_p = a_j.transpose(0, 1, 3, 2), a_p.transpose(0, 1, 3, 2)  # (N, nt, rt, 16)
    assert np.abs(rows_j[same] - rows_p[same]).max() <= 1e-6
    miss = ~hit_p
    np.testing.assert_allclose(rows_p[miss][:, 12], 0.35, rtol=0, atol=1e-6)
    assert not np.delete(rows_p[miss], 12, axis=1).any()
    np.testing.assert_array_equal(t_p.reshape(N, nt, rt)[miss], 1e6)
    if case == "cnt0":
        assert miss[:, -1].all() and hit_p[:, 0].any()
    # the gid row is #1's winner on the same inputs
    _, i1 = trk.raycast_fused_sel_t(args[0], args[4], args[2], args[3], args[5], args[6], ray_tile=rt, tri_chunk=C)
    np.testing.assert_array_equal(np.where(hit_p, a_p[:, :, 6], -1).reshape(N, -1), i1.numpy())


@pytest.mark.parametrize("wrapper", ["raycast_fused_sel_t", "raycast_tilecull_t"])
@pytest.mark.parametrize("bad_id", [-1, 2])
def test_check_ids_rejects_listed_ids_out_of_range(wrapper, bad_id):
    """Neither the kernels nor the plain versions skip a listed id outside
    [0, T / C); the wrappers' ``check_ids`` raises on one (here T / C = 2)
    and passes one that lies past ``cnt``."""
    T, C, rt = 64, 32, 64
    gm = torch.zeros(1, 10, 4 * T)
    a16 = torch.zeros(1, T // C, 16, C)
    ids = torch.tensor([[[1, bad_id]]], dtype=torch.int32)
    sids = torch.zeros(1, dtype=torch.int32)
    d_t, Bt = torch.zeros(1, 8, rt), torch.zeros(1, 16, 4)
    fn = getattr(trk, wrapper)

    def call(cnt):
        cnt = torch.tensor([[cnt]], dtype=torch.int32)
        if wrapper == "raycast_fused_sel_t":
            return fn(gm, sids, ids, cnt, d_t, Bt, ray_tile=rt, tri_chunk=C, check_ids=True)
        return fn(gm, a16, ids, cnt, sids, d_t, Bt, ray_tile=rt, tri_chunk=C, check_ids=True)

    with pytest.raises(ValueError, match=r"1 listed chunk ids lie outside \[0, 2\)"):
        call(2)
    t, _ = call(1)  # the bad id is not listed
    assert t.shape == (1, rt)
