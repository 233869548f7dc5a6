"""CUDA kernels of habitat_torch against their plain PyTorch versions, on the
card. These need an NVIDIA GPU and nvcc and skip elsewhere. The repo's
conftest imports JAX, which the card's machine lacks, so run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from habitat_torch.datasets.pointnav import make_procedural_pointnav
from habitat_torch.ops import raycast as rc
from habitat_torch.ops import raycast_kernels as rk
from habitat_torch.sims.scene import pack_scenes

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rk.build()
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
