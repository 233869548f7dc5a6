"""habitat_torch renderer against habitat_tpu on the CPU.

The plain PyTorch versions of the two ported kernels are held against the
Pallas kernels run in interpret mode on the same inputs (as
tests/test_exactsel_kernel.py runs Pallas here), and the whole pinhole
render path against ``render_batch(..., backend="pallas")``.

Tolerances: hit/miss identical; winner ids agree on >= 99.9% of hits (the
TPU kernel's docstring records ~0.03% winner swaps on shared-edge near-ties,
raycast_pallas.py:521-523); |dt| < 5e-3 m where the winner is the same
(both compute G in float32, summed in different orders). The render's
depth is recovered plane-exactly from the winner in both, so it agrees to
1e-4 (normalized units); rgb/semantic agree on >= 99.9% of pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.datasets.pointnav import make_procedural_pointnav
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.ops import raycast_pallas as jrp
from habitat_tpu.sims.scene import pack_scenes
from habitat_tpu.utils.geometry import camera_rays

from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from habitat_torch.sims.scene import pack_scenes as torch_pack
from habitat_torch.datasets.pointnav import make_procedural_pointnav as torch_pointnav
from tests.torch_jax_native import _jax_native  # noqa: F401

HFOV = 90.0


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _poses(episodes, n, seed):
    rng = np.random.RandomState(seed)
    pos = np.stack([episodes[i % len(episodes)].start_position for i in range(n)]).astype(np.float32)
    pos[:, 1] += 1.25
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    pitch = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    return pos, yaw, pitch


def _kernel_inputs(pack, sids, pos, yaw, pitch, H, W):
    """The fast path's kernel inputs, built by the JAX package."""
    d_cam = camera_rays(jnp.float32(0), jnp.float32(0), jnp.deg2rad(HFOV), H, W).reshape(-1, 3)
    d_aug = jnp.concatenate([d_cam, jnp.ones((H * W, 1), jnp.float32)], -1)
    rt = min(2048, H * W)
    nt = H * W // rt
    d_t = jnp.pad(d_aug.reshape(nt, rt, 4).transpose(0, 2, 1), ((0, 0), (0, 4), (0, 0)))
    B = jrc.ray_feature_matrix(jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch))
    Bt = jnp.pad(B.transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))
    planes = jnp.asarray(jrc.tile_plane_normals_cam(np.deg2rad(HFOV), H, W, rt // W, W))
    ids, cnt = jrc.select_chunks_frustum(
        pack.tri_v0, pack.tri_e1, pack.tri_e2, pack.tri_valid, jnp.asarray(sids),
        jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch), planes, tri_chunk=32,
    )
    return dict(d_t=np.asarray(d_t), Bt=np.asarray(Bt), ids=np.asarray(ids),
                cnt=np.asarray(cnt), planes=np.asarray(planes), rt=rt)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_hits_agree(t_ref, i_ref, t_got, i_got, min_hit=0.5):
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    t_got, i_got = t_got.numpy(), i_got.numpy()
    hit_ref, hit_got = i_ref >= 0, i_got >= 0
    np.testing.assert_array_equal(hit_ref, hit_got)
    assert hit_ref.mean() > min_hit, "cameras should see geometry"
    both = hit_ref & hit_got
    assert (i_ref[both] == i_got[both]).mean() >= 0.999
    same = both & (i_ref == i_got)
    assert np.abs(t_ref[same] - t_got[same]).max() < 5e-3
    np.testing.assert_array_equal(t_got[~hit_got], 1e6)


@pytest.fixture(scope="module")
def scenes():
    return make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)


def test_frustum_selection_matches(scenes):
    sj, ej, _ = scenes
    pack = pack_scenes(sj)
    N, H, W = 4, 64, 64
    sids = (np.arange(N) % 2).astype(np.int32)
    pos, yaw, pitch = _poses(ej, N, 3)
    ki = _kernel_inputs(pack, sids, pos, yaw, pitch, H, W)
    tp = torch_pack(torch_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)[0])
    ids, cnt = trc.select_chunks_frustum(
        tp.tri_v0, tp.tri_e1, tp.tri_e2, tp.tri_valid, torch.from_numpy(sids).long(),
        _t(pos), _t(yaw), _t(pitch), _t(ki["planes"]), tri_chunk=32,
    )
    np.testing.assert_array_equal(cnt.numpy(), ki["cnt"])
    np.testing.assert_array_equal(ids.numpy(), ki["ids"])
    B = trc.ray_feature_matrix(_t(pos), _t(yaw), _t(pitch))
    Bj = np.asarray(jrc.ray_feature_matrix(jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch)))
    np.testing.assert_allclose(B.numpy(), Bj, rtol=0, atol=2e-6)


def test_fused_sel_plain_matches_pallas(scenes):
    sj, ej, _ = scenes
    pack = pack_scenes(sj)
    N, H, W = 4, 64, 64
    sids = (np.arange(N) % 2).astype(np.int32)
    pos, yaw, pitch = _poses(ej, N, 7)
    ki = _kernel_inputs(pack, sids, pos, yaw, pitch, H, W)
    gm = np.asarray(jrp.group_tri_mat(pack.tri_mat, tri_chunk=32))
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = jrp.raycast_pallas_fused_sel_t(
            jnp.asarray(gm), jnp.asarray(sids), jnp.asarray(ki["ids"]), jnp.asarray(ki["cnt"]),
            jnp.asarray(ki["d_t"]), jnp.asarray(ki["Bt"]), ray_tile=ki["rt"], tri_chunk=32,
        )
    before = trk.raycast_fused_sel_t.launches
    t_p, i_p = trk.raycast_fused_sel_t(
        _t(gm), _t(sids), _t(ki["ids"]), _t(ki["cnt"]), _t(ki["d_t"]), _t(ki["Bt"]),
        ray_tile=ki["rt"], tri_chunk=32,
    )
    assert trk.raycast_fused_sel_t.launches == before  # CPU tensors: plain version
    assert t_p.dtype == torch.float32 and i_p.dtype == torch.int32
    _assert_hits_agree(t_j, i_j, t_p, i_p)


def _random_soup(T, seed):
    """A synthetic triangle soup around the origin (a room-sized cloud)."""
    rng = np.random.RandomState(seed)
    v0 = rng.uniform(-4, 4, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (T, 3)).astype(np.float32)
    valid = np.ones(T, bool)
    valid[-5:] = False
    return jrc.build_tri_matrix(v0, e1, e2, valid)


def test_fused_t_plain_matches_pallas():
    T = 512
    tm = np.stack([_random_soup(T, 1), _random_soup(T, 2)])  # (S=2, 10, 4, T)
    gm = np.asarray(jrp.group_tri_mat(jnp.asarray(tm), tri_chunk=128))
    np.testing.assert_array_equal(gm, trc.group_tri_mat(_t(tm), 128).numpy())
    N, H, W = 2, 32, 32
    sids = np.array([0, 1], np.int32)
    rng = np.random.RandomState(0)
    pos = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    pitch = np.zeros(N, np.float32)
    d_cam = camera_rays(jnp.float32(0), jnp.float32(0), jnp.deg2rad(HFOV), H, W).reshape(-1, 3)
    d_t = np.asarray(jnp.pad(
        jnp.concatenate([d_cam, jnp.ones((H * W, 1))], -1).reshape(1, H * W, 4).transpose(0, 2, 1),
        ((0, 0), (0, 4), (0, 0)),
    ))
    Bt = np.asarray(jnp.pad(
        jrc.ray_feature_matrix(jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch)).transpose(0, 2, 1),
        ((0, 0), (0, 6), (0, 0)),
    ))
    with pltpu.force_tpu_interpret_mode():
        t_j, i_j = jrp.raycast_pallas_fused_t(
            jnp.asarray(gm), jnp.asarray(sids), jnp.asarray(d_t), jnp.asarray(Bt),
            ray_tile=H * W, tri_chunk=128,
        )
    t_p, i_p = trk.raycast_fused_t(_t(gm), _t(sids), _t(d_t), _t(Bt), ray_tile=H * W, tri_chunk=128)
    _assert_hits_agree(t_j, i_j, t_p, i_p, min_hit=0.2)


def test_render_batch_matches_pallas_path(scenes):
    sj, ej, _ = scenes
    pack = pack_scenes(sj)
    N, H, W = 2, 32, 32
    sids = np.array([0, 1], np.int32)
    pos, yaw, pitch = _poses(ej, N, 11)
    with pltpu.force_tpu_interpret_mode():
        ref = jrc.render_batch(
            pack, jnp.asarray(sids), jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch),
            height=H, width=W, backend="pallas",
        )
    tp = torch_pack(torch_pointnav(num_scenes=2, episodes_per_scene=4, seed=0)[0])
    got = trc.render_batch(
        tp, torch.from_numpy(sids), _t(pos), _t(yaw), _t(pitch), height=H, width=W
    )
    assert got["rgb"].dtype == torch.uint8 and got["depth"].dtype == torch.float32
    for k in ("rgb", "depth", "semantic"):
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
    d_ref, d_got = np.asarray(ref["depth"]), got["depth"].numpy()
    assert (d_ref < 0.999).mean() > 0.5
    assert np.abs(d_ref - d_got).max() <= 1e-4
    rgb_eq = (np.asarray(ref["rgb"]) == got["rgb"].numpy()).all(-1)
    assert rgb_eq.mean() >= 0.999
    assert (np.asarray(ref["semantic"]) == got["semantic"].numpy()).mean() >= 0.999


def test_unported_branches_raise(scenes):
    """No branch raises any more: dynamic geometry renders through the index
    route (tests/test_torch_dynamic.py holds the merge against the JAX
    package), and equirect cameras and images that do not tile into 1024-ray
    kernel tiles through the general route (tests/test_torch_panoramic.py)."""
    tp = torch_pack(torch_pointnav(num_scenes=1, episodes_per_scene=1, seed=0)[0])
    args = (tp, torch.zeros(1, dtype=torch.int32), torch.zeros(1, 3), torch.zeros(1), torch.zeros(1))
    no_objects = dict(v0=torch.zeros(1, 12, 3), e1=torch.zeros(1, 12, 3), e2=torch.zeros(1, 12, 3),
                      valid=torch.zeros(1, 12, dtype=torch.bool), color=torch.zeros(1, 12, 3),
                      sem=torch.zeros(1, 12, dtype=torch.int32))
    assert trc.render_route(tp, 32, 32, dynamic=True) == "index"
    out = trc.render_batch(*args, height=32, width=32, dynamic=no_objects)
    static = trc.render_batch(*args, height=32, width=32)
    assert torch.equal(out["semantic"], static["semantic"])
    for kw in (dict(height=32, width=32, projection="equirect"), dict(height=30, width=30)):
        assert trc.render_route(tp, kw["height"], kw["width"], kw.get("projection", "pinhole")) == "index"
        out = trc.render_batch(*args, **kw)
        assert out["depth"].shape == (1, kw["height"], kw["width"], 1)


def test_geometry_matches():
    from habitat_tpu.utils import geometry as jg
    from habitat_torch.utils import geometry as tg

    rng = np.random.RandomState(5)
    yaw = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    pitch = rng.uniform(-0.5, 0.5, 16).astype(np.float32)
    vec = rng.normal(0, 3, (16, 3)).astype(np.float32)
    close = dict(rtol=0, atol=2e-6)
    np.testing.assert_allclose(tg.yaw_to_forward(_t(yaw)).numpy(), np.asarray(jg.yaw_to_forward(yaw)), **close)
    np.testing.assert_allclose(
        tg.rotate_world_to_agent(_t(vec), _t(yaw)).numpy(), np.asarray(jg.rotate_world_to_agent(vec, yaw)), **close
    )
    for a, b in zip(tg.cartesian_to_polar(_t(vec[:, 0]), _t(vec[:, 2])), jg.cartesian_to_polar(vec[:, 0], vec[:, 2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)
    np.testing.assert_allclose(
        tg.view_rotation_matrix(_t(yaw), _t(pitch)).numpy(), np.asarray(jg.view_rotation_matrix(yaw, pitch)), **close
    )
    np.testing.assert_allclose(
        tg.camera_rays(_t(yaw[0]), _t(pitch[0]), np.deg2rad(90.0), 32, 48).numpy(),
        np.asarray(jg.camera_rays(yaw[0], pitch[0], np.deg2rad(90.0), 32, 48)), **close,
    )
