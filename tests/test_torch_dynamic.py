"""habitat_torch's dynamic-geometry render merge against habitat_tpu on the
CPU.

Each env holds three boxes of 12 triangles (the procedural rearrangement
generator's default object count) in front of its camera. The JAX side is
``render_batch(..., dynamic=..., backend="pallas")`` with its Pallas kernels
under ``pltpu.force_tpu_interpret_mode()``; the port is
``render_batch(..., dynamic=...)``, whose kernels take their plain PyTorch
versions for CPU tensors. Routes: the index route (bench scenes: with
dynamic geometry the pinhole fast path is never taken), the block route
merged channel-major (a ``force_scan_tables=True`` pack) and through the
row-gather epilogue (a pack without ``tri_attr16``), and the culled route
(an equirect camera on a pack of 128-triangle chunks; the JAX culled route
misreads the ids of 256-triangle packs, ROADMAP Queue 3).

Tolerances: semantic and hit/miss equal on >= 99.9% of pixels (a
shared-edge near-tie, static or dynamic, may go the other way: float32
determinants summed in another order); normalized depth within 1e-4 on
common hits; rgb within one level on >= 99.9% of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from habitat_tpu.datasets.pointnav import make_procedural_pointnav as jax_pointnav
from habitat_tpu.ops import raycast as jrc
from habitat_tpu.sims import procedural as jproc
from habitat_tpu.sims.scene import pack_scenes as jax_pack

from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.ops import raycast as trc
from habitat_torch.ops import raycast_kernels as trk
from habitat_torch.sims import procedural as tproc
from habitat_torch.sims.scene import pack_scenes as torch_pack
from tests.torch_jax_native import _jax_native  # noqa: F401

SCAN_KW = dict(seed=5, extent=6.0, n_rooms_per_axis=2, n_clutter=6, tess=0.35)
CULL_K = 8
SEM_BASE = 100
_CORNERS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
_FACES = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                   [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]])


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tier-1 run puts several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packs():
    """JAX and port packs: two bench scenes (T=128); the scan apartment in
    chunks of 128 (no tri_attr16) and with the scan tables (chunks of 256)."""
    sj, _, _ = jax_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    st, _, _ = make_procedural_pointnav(num_scenes=2, episodes_per_scene=1, seed=0)
    out = {"bench": (jax_pack(sj), torch_pack(st))}
    sj, st = jproc.generate_scan_apartment(**SCAN_KW), tproc.generate_scan_apartment(**SCAN_KW)
    out["scan128"] = (jax_pack([sj]), torch_pack([st]))
    out["scan256"] = (jax_pack([sj], force_scan_tables=True), torch_pack([st], force_scan_tables=True))
    assert out["scan128"][1].tri_attr16 is None and out["scan256"][1].tri_attr16 is not None
    return out


@pytest.fixture(scope="module")
def jrender():
    """One jit for the JAX render (its keyword settings are static)."""
    return jax.jit(
        lambda pack, s, p, y, q, dyn, **kw: jrc.render_batch(pack, s, p, y, q, backend="pallas", dynamic=dyn, **kw),
        static_argnames=("height", "width", "projection", "cull_k"),
    )


def boxes(pos, yaw, seed, n_obj=3):
    """Per env, ``n_obj`` yawed boxes of 12 triangles 0.5-1.1 m in front of
    the camera, around its forward axis: v0, e1, e2 (N, 12 n_obj, 3), valid,
    color and sem (ids SEM_BASE + object) as numpy arrays."""
    rng = np.random.RandomState(seed)
    N = len(pos)
    fwd = np.stack([-np.sin(yaw), np.zeros_like(yaw), -np.cos(yaw)], -1)  # yaw 0 looks down -z
    side = np.stack([np.cos(yaw), np.zeros_like(yaw), -np.sin(yaw)], -1)
    dist = rng.uniform(0.5, 1.1, (N, n_obj))[..., None]
    lateral = rng.uniform(-0.4, 0.4, (N, n_obj))[..., None]
    centre = pos[:, None] + fwd[:, None] * dist + side[:, None] * lateral
    centre[..., 1] = pos[:, None, 1] + rng.uniform(-0.9, 0.1, (N, n_obj))
    half = rng.uniform(0.1, 0.25, (N, n_obj, 3))
    a = rng.uniform(-np.pi, np.pi, (N, n_obj))
    rot = np.zeros((N, n_obj, 3, 3))
    rot[..., 0, 0], rot[..., 0, 2], rot[..., 1, 1] = np.cos(a), np.sin(a), 1.0
    rot[..., 2, 0], rot[..., 2, 2] = -np.sin(a), np.cos(a)
    v = np.einsum("noij,nokj->noki", rot, _CORNERS[None, None] * half[:, :, None, :]) + centre[:, :, None, :]
    tri = v[:, :, _FACES].reshape(N, n_obj * 12, 3, 3).astype(np.float32)  # (N, Td, vertex, xyz)
    color = np.repeat(rng.uniform(0.3, 1.0, (N, n_obj, 3)), 12, axis=1).astype(np.float32)
    sem = np.repeat(SEM_BASE + np.arange(n_obj)[None].repeat(N, 0), 12, axis=1).astype(np.int32)
    valid = np.ones((N, n_obj * 12), bool)
    valid[-1, -12:] = False  # one absent object
    return dict(v0=tri[:, :, 0], e1=tri[:, :, 1] - tri[:, :, 0], e2=tri[:, :, 2] - tri[:, :, 0], valid=valid,
                color=color, sem=sem)


def _poses(n, seed, centre, spread):
    rng = np.random.RandomState(seed)
    pos = (np.array([centre]) + rng.uniform(-spread, spread, (n, 3)) * [1, 0, 1]).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return pos, yaw, np.full(n, -0.45, np.float32)  # the rearrangement head camera's pitch


def _t(x):
    return torch.from_numpy(np.array(x))


def test_build_tri_matrix_torch_matches():
    dyn = boxes(np.zeros((2, 3), np.float32), np.array([0.3, -2.0], np.float32), 0)
    ref = np.asarray(jrc.build_tri_matrix_jnp(*(jnp.asarray(dyn[k]) for k in ("v0", "e1", "e2", "valid"))))
    got = trc.build_tri_matrix_torch(*(_t(dyn[k]) for k in ("v0", "e1", "e2", "valid")))
    assert got.shape == ref.shape == (2, 10, 4, 36) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert not got[1, ..., -12:].any()


def test_dynamic_route_rule(packs):
    """Dynamic geometry never takes the pinhole fast path; the other routes
    keep their dispatch."""
    pb, ps = packs["bench"][1], packs["scan256"][1]
    assert trc.render_route(pb, 32, 32) == "pinhole"
    assert trc.render_route(pb, 32, 32, dynamic=True) == "index"
    assert trc.render_route(pb, 128, 128, dynamic=True) == "index"
    assert trc.render_route(pb, 32, 64, "equirect", dynamic=True) == "index"
    assert trc.render_route(ps, 32, 32, cull_k=CULL_K, dynamic=True) == "block"
    assert trc.render_route(ps, 32, 64, "equirect", cull_k=CULL_K, dynamic=True) == "culled"


@pytest.mark.parametrize(
    "scene,projection,H,W,route",
    [("bench", "pinhole", 32, 64, "index"), ("bench", "equirect", 32, 64, "index"),
     ("scan256", "pinhole", 32, 32, "block"), ("scan128", "pinhole", 32, 64, "block"),
     ("scan128", "equirect", 32, 64, "culled")],
)
def test_dynamic_render_matches_pallas(packs, jrender, scene, projection, H, W, route):
    pj, pt = packs[scene]
    n = 2
    if scene == "bench":
        pos, yaw, pitch = _poses(n, 1, (5.0, 1.25, 5.0), 2.0)
        sids, cull_k = np.arange(n, dtype=np.int32) % 2, None
    else:
        pos, yaw, pitch = _poses(n, 2, (3.0, 1.25, 3.0), 1.0)
        sids, cull_k = np.zeros(n, np.int32), CULL_K
    assert trc.render_route(pt, H, W, projection, cull_k, dynamic=True) == route
    dyn = boxes(pos, yaw, 3)
    kw = dict(height=H, width=W, projection=projection, cull_k=cull_k)
    with pltpu.force_tpu_interpret_mode():
        fj = jrender(pj, jnp.asarray(sids), jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(pitch),
                     {k: jnp.asarray(v) for k, v in dyn.items()}, **kw)
    before = trk.raycast_index_t.launches
    ft = trc.render_batch(pt, _t(sids), _t(pos), _t(yaw), _t(pitch), dynamic={k: _t(v) for k, v in dyn.items()},
                          **kw)
    assert trk.raycast_index_t.launches == before  # CPU tensors: the plain versions
    fj = {k: np.asarray(v) for k, v in fj.items()}
    ft = {k: v.numpy() for k, v in ft.items()}
    for k in fj:
        assert ft[k].shape == fj[k].shape and ft[k].dtype == fj[k].dtype, k
    merged = ft["semantic"] >= SEM_BASE
    # boxes within 1.1 m fill a share of a 90-degree image, less of a panorama
    assert merged.mean() > (0.05 if projection == "pinhole" else 0.005), "the boxes should be visible"
    assert (ft["semantic"] == fj["semantic"]).mean() >= 0.999
    hit_j, hit_t = fj["depth"] < 1.0, ft["depth"] < 1.0
    assert (hit_j == hit_t).mean() >= 0.999
    both = hit_j & hit_t
    assert np.abs(ft["depth"][both] - fj["depth"][both]).max() <= 1e-4
    assert (np.abs(ft["rgb"].astype(int) - fj["rgb"].astype(int)).max(-1) <= 1).mean() >= 0.999
    # the static frames differ where the boxes are
    static = trc.render_batch(pt, _t(sids), _t(pos), _t(yaw), _t(pitch), **kw)
    assert (static["semantic"].numpy() < SEM_BASE).all()
    assert not np.array_equal(static["depth"].numpy(), ft["depth"])
