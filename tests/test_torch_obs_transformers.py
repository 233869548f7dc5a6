"""habitat_torch's observation transforms (``baselines/obs_transformers.py``)
against habitat_tpu's on the CPU.

- Each of the six (``ResizeShortestEdge`` shrinking and growing,
  ``CenterCropper``, ``CubeMap2Equirect``, ``CubeMap2Fisheye``,
  ``Equirect2CubeMap``, ``AddVirtualKeys``) on the same seeded frames
  (uint8 RGB, float32 depth, int32 semantic ids; batched and unbatched):
  float within 1e-5; integers resampled bilinearly (uint8, and the ids
  that ResizeShortestEdge and Equirect2CubeMap resample so) within 1, a
  float32 rounding apart at a half; the ids the cube converters take by
  nearest sample equal. The transformed descriptors' shapes and keys
  equal the JAX spaces'.
- tests/test_projections.py's rules on the port's CPU render of the same
  scene: CubeMap2Equirect of six 64x64 pinhole faces against the native
  64x128 equirect (rows 16-48: median RGB gap < 8, > 0.9 of pixels under
  30), Equirect2CubeMap of the native 128x256 equirect depth against the
  native 32x32 front face (median gap < 0.03 inside a 4-pixel border), and
  the fisheye's valid centre and zeroed corners.
- ``get_active_obs_transforms`` from a composed config that names two
  transforms, and ``apply_obs_transforms_*`` as tests/test_tasks.py:67
  applies them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from gymnasium import spaces

from habitat_tpu.baselines import obs_transformers as J

from habitat_torch.baselines import obs_transformers as T
from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.ops.raycast import render_batch
from habitat_torch.sims.scene import pack_scenes
from tests.torch_jax_native import _jax_native  # noqa: F401

FACES = T.CUBE_FACES


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(rng, lead, h, w):
    return {"rgb": rng.integers(0, 256, lead + (h, w, 3), dtype=np.uint8),
            "depth": rng.uniform(0, 1, lead + (h, w, 1)).astype(np.float32),
            "semantic": rng.integers(0, 9, lead + (h, w, 1)).astype(np.int32)}


def _agree(want, got, int_gap=1.0):
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        gap = np.abs(g.astype(np.float64) - w.astype(np.float64)).max() if g.size else 0.0
        assert gap <= {np.uint8: 1.0, np.float32: 1e-5}.get(g.dtype.type, int_gap), (k, gap)


def _spaces(obs, lead):
    """(the gymnasium spaces of the JAX transform, the port's descriptors)."""
    box = {np.uint8: (0, 255), np.float32: (0.0, 1.0), np.int32: (0, 100)}
    js = spaces.Dict({k: spaces.Box(*box[v.dtype.type], v.shape[len(lead):], v.dtype) for k, v in obs.items()})
    ts = {k: (v.shape[len(lead):], torch.from_numpy(v).dtype) for k, v in obs.items()}
    return js, ts


def _cases():
    u = {k: [f"{k}_{f.lower()}" for f in FACES] for k in ("rgb", "depth", "semantic")}
    every = sum(u.values(), [])
    return {
        "shrink": (lambda m, **d: m.ResizeShortestEdge(size=24, **d), (30, 45)),
        "grow": (lambda m, **d: m.ResizeShortestEdge(size=56, **d), (30, 45)),
        "crop": (lambda m, **d: m.CenterCropper(16, 24, **d), (30, 45)),
        "cube2eq": (lambda m, **d: m.CubeMap2Equirect(every, (24, 48), **d), (16, 16)),
        "cube2fish": (lambda m, **d: m.CubeMap2Fisheye(every, (32, 40), **d), (16, 16)),
        "eq2cube": (lambda m, **d: m.Equirect2CubeMap(["rgb", "depth", "semantic"], (16, 16), **d), (32, 64)),
        "virtual": (lambda m, **d: m.AddVirtualKeys({"goal_to_agent_gps_compass": 2, "other": 3}, **d), (8, 8)),
    }


@pytest.mark.parametrize("case", list(_cases()))
@pytest.mark.parametrize("lead", [(3,), ()])
def test_transform_matches_jax(case, lead):
    make, (h, w) = _cases()[case]
    rng = np.random.default_rng(len(case) + len(lead))
    if case in ("cube2eq", "cube2fish"):
        obs = {f"{k}_{f.lower()}": v for f in FACES for k, v in _frames(rng, lead, h, w).items()}
    else:
        obs = _frames(rng, lead, h, w)
    jt, tt = make(J), make(T, device="cpu")
    js, ts = _spaces(obs, lead)
    jspace, tspace = jt.transform_observation_space(js), tt.transform_observation_space(ts)
    assert {k: tuple(v.shape) for k, v in jspace.spaces.items()} == {k: v[0] for k, v in tspace.items()}
    want = jt({k: jnp.asarray(v) for k, v in obs.items()})
    got = tt({k: torch.from_numpy(v) for k, v in obs.items()})
    _agree(want, got, int_gap=0.0 if case in ("cube2eq", "cube2fish") else 1.0)
    for k, (shape, dtype) in tspace.items():
        assert tuple(got[k].shape) == lead + shape and got[k].dtype == dtype, k


# -- tests/test_projections.py's rules on the port's render -----------------


@pytest.fixture(scope="module")
def pack():
    return pack_scenes(make_procedural_pointnav(num_scenes=1, episodes_per_scene=2, seed=0)[0])


def _render(pack, projection, yaw, pitch, h, w):
    return render_batch(pack, torch.zeros(1, dtype=torch.int64), torch.tensor([[1.0, 1.2, 1.0]]),
                        torch.tensor([yaw], dtype=torch.float32), torch.tensor([pitch], dtype=torch.float32),
                        height=h, width=w, projection=projection)


def _faces(pack, hw):
    return {f: _render(pack, "pinhole", *T._FACE_POSES[f], hw, hw) for f in FACES}


def test_cubemap2equirect_matches_native_equirect(pack):
    faces = _faces(pack, 64)
    native = _render(pack, "equirect", 0.0, 0.0, 64, 128)
    tr = T.CubeMap2Equirect([f"rgb_{f.lower()}" for f in FACES], (64, 128), device="cpu")
    out = tr({f"rgb_{f.lower()}": faces[f]["rgb"] for f in FACES})
    assert set(out) == {"rgb"} and out["rgb"].shape == (1, 64, 128, 3)
    a, b = out["rgb"][0].float().numpy(), native["rgb"][0].float().numpy()
    mid = np.abs(a[16:48] - b[16:48]).mean(axis=-1)
    assert np.median(mid) < 8.0, np.median(mid)
    assert (mid < 30.0).mean() > 0.9, (mid < 30.0).mean()


def test_equirect2cubemap_matches_native_pinhole(pack):
    native_eq = _render(pack, "equirect", 0.0, 0.0, 128, 256)
    front = _render(pack, "pinhole", 0.0, 0.0, 32, 32)
    out = T.Equirect2CubeMap(["depth"], (32, 32), device="cpu")({"depth": native_eq["depth"]})
    assert "depth" not in out and len(out) == 6
    err = np.abs(out["depth_front"][0, ..., 0].numpy()[4:28, 4:28] - front["depth"][0, ..., 0].numpy()[4:28, 4:28])
    assert np.median(err) < 0.03, np.median(err)


def test_cubemap2fisheye_shapes_and_mask(pack):
    faces = _faces(pack, 32)
    tr = T.CubeMap2Fisheye([f"rgb_{f.lower()}" for f in FACES], (64, 64), device="cpu")
    img = tr({f"rgb_{f.lower()}": faces[f]["rgb"] for f in FACES})["rgb"][0].numpy()
    assert img.shape == (64, 64, 3)
    assert img[31, 31].sum() > 0
    assert (img[~tr._valid_mask] == 0).all() and (~tr._valid_mask).any()


def test_active_obs_transforms_from_config():
    from habitat_tpu.config.default import get_config as jax_config

    from habitat_torch.config.default import get_config

    path = "habitat_baselines.rl.policy.main_agent.obs_transforms"
    ov = [f"+{path}.resize_shortest_edge.type=ResizeShortestEdge", f"+{path}.resize_shortest_edge.size=32",
          f"+{path}.center_cropper.type=CenterCropper", f"+{path}.center_cropper.height=32",
          f"+{path}.center_cropper.width=32"]
    tfs = T.get_active_obs_transforms(get_config("pointnav/ppo_pointnav_example.yaml", ov), device="cpu")
    jtfs = J.get_active_obs_transforms(jax_config("pointnav/ppo_pointnav_example.yaml", ov))
    assert [type(t).__name__ for t in tfs] == [type(t).__name__ for t in jtfs] == ["ResizeShortestEdge",
                                                                                     "CenterCropper"]
    # tests/test_tasks.py:67's rules
    rng = np.random.default_rng(0)
    obs = {"rgb": rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8),
           "depth": rng.uniform(0, 1, (4, 64, 96, 1)).astype(np.float32),
           "pointgoal_with_gps_compass": rng.normal(size=(4, 2)).astype(np.float32)}
    space = T.apply_obs_transforms_obs_space({k: (v.shape[1:], torch.from_numpy(v).dtype) for k, v in obs.items()},
                                             tfs)
    assert space["rgb"][0] == (32, 32, 3) and space["depth"][0] == (32, 32, 1)
    assert space["pointgoal_with_gps_compass"][0] == (2,)
    got = T.apply_obs_transforms_batch({k: torch.from_numpy(v) for k, v in obs.items()}, tfs)
    want = J.apply_obs_transforms_batch({k: jnp.asarray(v) for k, v in obs.items()}, jtfs)
    _agree(want, got)
    assert got["rgb"].shape == (4, 32, 32, 3) and got["rgb"].dtype == torch.uint8


def test_transforms_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.CenterCropper()
