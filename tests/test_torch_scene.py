"""habitat_torch host data against habitat_tpu: procedural scenes, packs,
geodesic fields, episodes, episode tables and the per-env episode order
must be bit-equal on the same seeds."""

import numpy as np
import pytest
import torch

from habitat_tpu.core import dataset as jds
from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.ops import raycast_pallas as jrp
from habitat_tpu.sims.scene import pack_scenes as jax_pack

from habitat_torch.core import dataset as tds
from habitat_torch.datasets.pointnav import make_procedural_pointnav as torch_pointnav
from habitat_torch.ops import raycast as trc
from habitat_torch.sims.scene import pack_scenes as torch_pack
from tests.torch_jax_native import _jax_native  # noqa: F401

PACK_FIELDS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_color", "tri_sem", "tri_valid",
    "tri_mat", "tri_attr", "chunk_bounds", "nav_occ", "obst_dist", "nav_lo",
    "floor_y",
)
TABLE_FIELDS = (
    "scene_idx", "start_pos", "start_yaw", "goal_pos", "goal_valid",
    "geodesic_start", "dist_field", "object_category",
)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    kw = dict(num_scenes=2, episodes_per_scene=4, seed=0)
    return jax_pointnav(**kw), torch_pointnav(**kw)


def _episode_key(e):
    return (
        e.episode_id, e.scene_id, e.start_position, e.start_rotation, e.info,
        [(g.position, g.radius) for g in e.goals],
    )


def test_scenes_bit_equal(both):
    (sj, _, _), (st, _, _) = both
    assert len(sj) == len(st) == 2
    for a, b in zip(sj, st):
        assert a.scene_id == b.scene_id
        for name in ("vertices", "colors", "semantic_ids", "nav_occ", "obst_dist", "nav_lo"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert (a.nav_res, a.floor_y, a.objects, a.regions) == (b.nav_res, b.floor_y, b.objects, b.regions)


def test_episodes_and_fields_bit_equal(both):
    (_, ej, fj), (_, et, ft) = both
    assert [_episode_key(e) for e in ej] == [_episode_key(e) for e in et]
    assert sorted(fj) == sorted(ft)
    for k in fj:
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)


def test_pack_bit_equal(both):
    (sj, _, _), (st, _, _) = both
    pj, pt = jax_pack(sj), torch_pack(st)
    for name in PACK_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(pj, name)), getattr(pt, name).numpy(), err_msg=name
        )
    assert (pj.nav_res, pj.scene_ids) == (pt.nav_res, pt.scene_ids)


@pytest.mark.parametrize("chunk", [32, 128])
def test_group_tri_mat_bit_equal(both, chunk):
    (sj, _, _), _ = both
    tm = np.array(jax_pack(sj).tri_mat)
    np.testing.assert_array_equal(
        np.asarray(jrp.group_tri_mat(tm, chunk)),
        trc.group_tri_mat(torch.from_numpy(tm), chunk).numpy(),
    )


def test_tile_planes_bit_equal():
    for args in ((np.deg2rad(90.0), 128, 128, 16, 128), (1.2, 32, 32, 32, 32)):
        np.testing.assert_array_equal(
            jrc.tile_plane_normals_cam(*args), trc.tile_plane_normals_cam(*args)
        )


def test_episode_table_and_order_bit_equal(both):
    (sj, ej, fj), (st, et, ft) = both
    tj = jds.build_episode_table(
        ej, {s.scene_id: s for s in sj}, {s.scene_id: i for i, s in enumerate(sj)},
        precomputed_fields=fj,
    )
    tt = tds.build_episode_table(
        et, {s.scene_id: s for s in st}, {s.scene_id: i for i, s in enumerate(st)},
        precomputed_fields=ft,
    )
    for name in TABLE_FIELDS:
        a, b = np.asarray(getattr(tj, name)), getattr(tt, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # no precomputed fields: the table runs the geodesic solve itself
    tj2 = jds.build_episode_table(
        ej, {s.scene_id: s for s in sj}, {s.scene_id: i for i, s in enumerate(sj)}
    )
    tt2 = tds.build_episode_table(
        et, {s.scene_id: s for s in st}, {s.scene_id: i for i, s in enumerate(st)}
    )
    np.testing.assert_array_equal(np.asarray(tj2.dist_field), tt2.dist_field.numpy())
    for n_envs in (3, 8):
        np.testing.assert_array_equal(
            jds.build_env_episode_order(ej, n_envs, seed=5),
            tds.build_env_episode_order(et, n_envs, seed=5),
        )


def test_largest_island_bit_equal(both):
    from habitat_tpu.sims.scene import largest_island_mask as jax_island
    from habitat_torch.sims.scene import largest_island_mask as torch_island

    (sj, _, _), (st, _, _) = both
    for a, b in zip(sj, st):
        occ = a.nav_occ.copy()
        occ[:, occ.shape[1] // 2] = False  # split the grid into islands
        np.testing.assert_array_equal(jax_island(occ), torch_island(occ))
