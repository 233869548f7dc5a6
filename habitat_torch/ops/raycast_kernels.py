"""Ray casting kernels: CUDA for tensors on the card, their plain PyTorch
versions for tensors on the CPU.

Counterpart of ``habitat_tpu/ops/raycast_pallas.py`` for the kernels the
pinhole render paths run:

- ``raycast_fused_sel_t`` <- ``raycast_pallas_fused_sel_t``: per (env, ray
  tile) only the tile's frustum-surviving chunks (``select_chunks_frustum``).
- ``raycast_fused_t`` <- ``raycast_pallas_fused_t``: every chunk in order.
- ``raycast_exactsel_t`` <- ``raycast_pallas_exactsel_t``: per 32x32-pixel
  tile the exact-culled 32-triangle chunklets of ``select_chunklets_exact``,
  nearest first, stopping once no later chunklet can hold a nearer hit.
- ``raycast_stream_t`` <- ``raycast_pallas_stream_t``: the same stream over
  parent chunks of 128 or 256 triangles (``select_chunks_occluded``, or any
  nearest-first chunk list).
- ``cullmask_t`` <- ``cullmask_pallas_t``: the exact cull's per-triangle
  test, valid and not wholly outside one of the tile's four frustum planes.

and for the general render route (any camera model, any image size):

- ``raycast_index_t`` <- ``raycast_pallas_index_t``: every chunk of
  min(128, T) triangles in order, from precomputed transposed ray features.
- ``raycast_culled_t`` <- ``raycast_pallas_culled_t``: each (env, ray tile)'s
  K candidate chunks of the pack's chunk size in the order given, returning
  the winner's 8 attributes instead of its index.

and for the ray-batch entry points of the JAX module, which take row-major
ray features (N, R, 10) from ``ops/raycast.py::ray_features``:

- ``raycast_index`` <- ``raycast_pallas_index`` (the v3 kernel): every chunk
  of min(128, T) triangles in order, with the split hit margin;
  ``raycast_batch`` (<- ``raycast_pallas_batch``) adds the winner's 8
  attributes, gathered exactly, zero on a miss;
- ``raycast_culled`` <- ``raycast_pallas_culled`` (v3): each 1024-ray tile's
  K listed chunks of ``tri_chunk`` triangles in list order, returning the
  winner's 8 attribute rows (N, R, 8);
- ``raycast_tilecull_t`` <- ``raycast_pallas_tilecull_t``: each tile's first
  ``cnt`` listed chunks (features built from B as in the frustum-selected
  kernel), then for every ray the winner's 16 rows of ``attr16_table``,
  plane-exact t and the shade in row 12.

The pinhole closest-hit kernels take the JAX kernels' inputs: the
chunk-grouped scene matrix (S, 10, 4T) from ``group_tri_mat`` (the TPU layout
pads it to 16 rows for its DMA slices; here it keeps its 10), scene ids (N,),
the camera-frame [d, 1] tiles (nt, 8, Rt) and the ray-feature matrices B^T
(N, 16, 4). They return (t (N, R) f32, idx (N, R) i32) with t = 1e6, idx = -1
on a miss. The general route's kernels take the scene matrix as the pack
holds it (S, 10, 4, T) and the ray features of ``ray_features_t`` (N, nt, 16,
Rt).

The CUDA sources are ``habitat_torch/csrc/*.cu``, each compiled with nvcc
for sm_90a at first use into ``habitat_torch/build/`` (``ops/cuda_build.py``)
and called through ctypes on PyTorch's current stream. A CUDA tensor
launches the kernel or raises; only CPU tensors take the plain version. Each
wrapper counts its kernel launches in its ``launches`` attribute and names
its plain version (same signature) in ``plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from habitat_torch.ops import cuda_build

_TMAX = 1e6
_TMIN = 1e-3
_EPS = 1e-7
# packed list slot of the stream kernels: (dmin_cm << 18) | chunk id
_ID_MASK = (1 << 18) - 1
# tri_verts16 row [v0(3) | e1(3) | e2(3) | pad(6) | valid]
VERTS16_VALID = 15
# The stream kernels' launch (csrc/raycast_stream.cu refuses others): rays
# per block and per warp, the granularity of their early stop, which the
# plain versions' ``tested`` counters follow; the ring's stages, units of
# STREAM_UNIT lanes (a chunklet, or a part of a larger chunk). The ring
# kernels' design (csrc/closest_hit_ring.cuh: the fused #1/#2, index #3/#8
# and culled #7/#9 kernels): rays per block and the ring's depth in chunks.
STREAM_BLOCK_RAYS = 256
STREAM_WARP_RAYS = 64
STREAM_UNIT = 32
STREAM_STAGES = 2
RING_BLOCK_RAYS = 1024
RING_STAGES = 2


def _require(dev, items):
    """Raise unless each (name, tensor, dtype) is a contiguous tensor of that
    dtype on ``dev``."""
    for name, x, dt in items:
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {dt} tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )


def _check_inputs(tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk, extra=()):
    _require(d_t.device, (
        ("tri_mat_c", tri_mat_c, torch.float32),
        ("sids", sids, torch.int32),
        ("d_t", d_t, torch.float32),
        ("Bt", Bt, torch.float32),
        *extra,
    ))
    n_tiles, k8, rt = d_t.shape
    if k8 != 8 or rt != ray_tile or Bt.shape[1:] != (16, 4) or Bt.shape[0] != sids.shape[0]:
        raise ValueError(f"bad shapes d_t {tuple(d_t.shape)} Bt {tuple(Bt.shape)}")
    if (tri_mat_c.shape[2] // 4) % tri_chunk or tri_mat_c.shape[1] != 10:
        raise ValueError(f"tri_mat_c {tuple(tri_mat_c.shape)} vs chunk {tri_chunk}")
    return n_tiles


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _features(Bt: torch.Tensor, d_t: torch.Tensor) -> torch.Tensor:
    """F (N, nt, 10, Rt) = B^T [d, 1], summed over k in order like the
    kernel (separately rounded products and sums)."""
    b = Bt[:, None, :10, :, None]  # (N,1,10,4,1)
    d = d_t[None, :, None, :4, :]  # (1,nt,1,4,Rt)
    F = b[..., 0, :] * d[..., 0, :]
    for k in range(1, 4):
        F = F + b[..., k, :] * d[..., k, :]
    return F


def _fold(G, C, base, valid, best_t, best_i, strict=False, tested=None, rays=None):
    """Fold one chunk's determinants G (N, nt, 4C, Rt) into the running
    winner: sign-free margin, argmin-first within the chunk, strict < across.
    ``strict``: the culled kernel's rule, strict on the t/det side of the
    margin, instead of the fused margin >= 0. With a dict ``tested``, adds
    to ``tested["inside"]`` the (ray, triangle) pairs whose test needs tnum
    (the ray's line meets a non-degenerate triangle: p, q, aa - p - q >= 0
    and aa above EPS^2; the stream and ring kernels skip tnum for 4 lanes
    where no ray of a warp passes p, q and aa - p - q, the fused and index
    kernels also aa - EPS^2), over the rays ``rays`` (N, nt, Rt) of valid
    slots."""
    detA, tnum, unum, vnum = G[:, :, :C], G[:, :, C:2 * C], G[:, :, 2 * C:3 * C], G[:, :, 3 * C:]
    aa = detA * detA
    p = unum * detA
    q = vnum * detA
    w = tnum * detA
    m1 = torch.minimum(torch.minimum(p, q), aa - p - q)
    if tested is not None:
        counted = valid[..., None] if rays is None else rays & valid[..., None]
        solid = aa - _EPS * _EPS > 0.0 if strict else aa - _EPS * _EPS >= 0.0
        tested["inside"] = tested.get("inside", 0) + int(((m1 >= 0.0) & solid & counted[:, :, None, :]).sum())
    m2 = torch.minimum(w - _TMIN * aa, aa - _EPS * _EPS)
    hit = (m1 >= 0.0) & (m2 > 0.0) if strict else torch.minimum(m1, m2) >= 0.0
    t = torch.where(hit, tnum / torch.where(hit, detA, torch.ones_like(detA)), _TMAX)
    tmin, win = t.min(dim=2)  # (N, nt, Rt), first minimum
    better = (tmin < best_t) & valid[..., None]
    best_t = torch.where(better, tmin, best_t)
    best_i = torch.where(better, base[..., None] * C + win.to(torch.int32), best_i)
    return best_t, best_i


def _finish(best_t, best_i):
    miss = best_t >= _TMAX * 0.5
    N = best_t.shape[0]
    t = torch.where(miss, _TMAX, best_t).reshape(N, -1)
    idx = torch.where(miss, -1, best_i).reshape(N, -1)
    return t, idx


# the plain versions walk envs in batches that keep one chunk's determinants
# (batch, nt, 4C, Rt) under this many float32 values
_PLAIN_BUDGET = 1 << 27


def _env_batches(N, per_env):
    """Slices of envs that keep one chunk's determinants (``per_env`` float32
    values per env) under the plain versions' budget."""
    step = max(1, _PLAIN_BUDGET // per_env)
    return [slice(a, min(a + step, N)) for a in range(0, N, step)]


def _listed_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, C, dmin=None, tested=None, finish=True):
    """Closest hit over each (env, tile)'s first ``cnt`` listed chunks, in
    list order, every one tested (no early stop). ``finish=False`` returns
    the running (t, idx) as they are, without the miss threshold.

    With a dict ``tested``, counts (``tested["inside"]``, see ``_fold``)
    the inside pairs of the listed slots. With ``dmin`` (N, nt, K) as well,
    counts what the stream kernel's early stop leaves to do on these
    inputs: list slots at which a block of STREAM_BLOCK_RAYS rays
    (``tested["block"]``, chunks staged) or a warp of STREAM_WARP_RAYS
    (``tested["warp"]``, chunks computed) still holds a ray whose best hit
    is farther than the slot's ``dmin``, and the inside pairs of those rays
    only."""
    N = sids.shape[0]
    n_tiles, _, rt = d_t.shape
    dev = d_t.device
    cols = torch.arange(4 * C, device=dev)
    ts, idxs = [], []
    for sl in _env_batches(N, n_tiles * 4 * C * rt):
        n = sl.stop - sl.start
        F = _features(Bt[sl], d_t)
        Mg = tri_mat_c[sids[sl].long()]  # (n, 10, 4T)
        Mg = Mg[:, None].expand(n, n_tiles, *Mg.shape[1:])
        best_t = torch.full((n, n_tiles, rt), _TMAX, device=dev)
        best_i = torch.full((n, n_tiles, rt), -1, dtype=torch.int32, device=dev)
        for k in range(min(int(cnt[sl].max()), chunk_ids.shape[2])):
            cid = chunk_ids[sl, :, k]  # (n, nt)
            valid = k < cnt[sl]
            still = None
            if dmin is not None:
                still = (best_t > dmin[sl, :, k, None]) & valid[..., None]
                tested["block"] += int(still.reshape(n, n_tiles, -1, STREAM_BLOCK_RAYS).any(-1).sum())
                tested["warp"] += int(still.reshape(n, n_tiles, -1, STREAM_WARP_RAYS).any(-1).sum())
            idx = (cid.long()[..., None] * 4 * C + cols)[:, :, None, :].expand(n, n_tiles, 10, 4 * C)
            G = torch.einsum("ntfc,ntfr->ntcr", torch.gather(Mg, 3, idx), F)
            best_t, best_i = _fold(G, C, cid, valid, best_t, best_i, tested=tested, rays=still)
        t, i = _finish(best_t, best_i) if finish else (best_t.reshape(n, -1), best_i.reshape(n, -1))
        ts.append(t)
        idxs.append(i)
    return torch.cat(ts), torch.cat(idxs)


def raycast_fused_sel_t_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile=2048, tri_chunk=32, tested=None):
    """Plain version of the frustum-selected kernel. ``tested``: see
    ``_fold``."""
    return _listed_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, tri_chunk, tested=tested)


def raycast_stream_t_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile=1024, tri_chunk=128, tested=None):
    """Plain version of the nearest-first stream kernels: the packed list's
    ids (low 18 bits), every survivor tested. The early stop of the kernels
    skips only chunks that cannot hold a nearer hit, so the results agree.
    ``tested``: see ``_listed_plain``."""
    dmin = (chunk_ids >> 18).float() * 1e-2 if tested is not None else None
    return _listed_plain(tri_mat_c, sids, chunk_ids & _ID_MASK, cnt, d_t, Bt, tri_chunk, dmin, tested)


def raycast_exactsel_t_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile=1024, tri_chunk=32, tested=None):
    """Plain version of the exact-culled chunklet kernel."""
    return raycast_stream_t_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile, tri_chunk, tested)


def cull_mask_torch(verts16, sids, head, cntk, nw, cam_pos, eps=-1e-3, c=32):
    """The exact cull's triangle test in PyTorch: (N, nt, ka, c) f32, 1.0
    where the triangle of the head slot's chunklet is valid and does not
    have all three vertices outside one of the tile's four planes (margin
    ``eps``). It is the plain version of the ``cullmask_t`` kernel (the form
    of the JAX package's XLA branch) and serves CPU tensors only: products
    and sums are taken one by one in the kernel's order, so the two agree
    bit for bit. ``cntk`` is not read: every slot is computed, and the
    caller gates by position."""
    S, T, _ = verts16.shape
    nch = T // c
    N, nt, ka = head.shape
    cid = (head & _ID_MASK).clamp(max=nch - 1).long()
    rows = verts16.reshape(S * nch, c, 16)[sids.long()[:, None, None] * nch + cid]  # (N,nt,ka,c,16)
    comp = rows[..., 0:9].permute(4, 0, 1, 2, 3).contiguous()  # (9, N, nt, ka, c)
    cam = cam_pos[:, None, None, None, :]
    rel = [comp[k] - cam[..., k] for k in range(3)]

    def dot(x, y, z, n):
        return x * n[..., 0] + y * n[..., 1] + z * n[..., 2]

    out_any = None
    for p in range(4):
        n = nw[:, :, None, None, p, :]  # (N, nt, 1, 1, 3)
        d0 = dot(rel[0], rel[1], rel[2], n)
        d1 = d0 + dot(comp[3], comp[4], comp[5], n)
        d2 = d0 + dot(comp[6], comp[7], comp[8], n)
        out_p = (d0 < eps) & (d1 < eps) & (d2 < eps)
        out_any = out_p if out_any is None else (out_any | out_p)
    return (~out_any & (rows[..., VERTS16_VALID] > 0.5)).float()


def raycast_fused_t_plain(tri_mat_c, sids, d_t, Bt, ray_tile=2048, tri_chunk=128, tested=None):
    """Plain version of the every-chunk kernel. ``tested``: see ``_fold``."""
    N = sids.shape[0]
    n_tiles, _, rt = d_t.shape
    C = tri_chunk
    F = _features(Bt, d_t)
    Mg = tri_mat_c[sids.long()]  # (N, 10, 4T)
    best_t = torch.full((N, n_tiles, rt), _TMAX, device=d_t.device)
    best_i = torch.full((N, n_tiles, rt), -1, dtype=torch.int32, device=d_t.device)
    valid = torch.ones((N, n_tiles), dtype=torch.bool, device=d_t.device)
    for c in range(Mg.shape[2] // (4 * C)):
        G = torch.einsum("nfc,ntfr->ntcr", Mg[:, :, c * 4 * C:(c + 1) * 4 * C], F)
        base = torch.full((N, n_tiles), c, dtype=torch.int32, device=d_t.device)
        best_t, best_i = _fold(G, C, base, valid, best_t, best_i, tested=tested)
    return _finish(best_t, best_i)


def _index_plain(tri_mat, sids, F, C, strict, tested=None):
    """Every chunk of C triangles of the env's scene in order, for ray
    features F (N, nt, 10, rt): (t (N, R), idx (N, R)). ``tested``: see
    ``_fold``."""
    N, n_tiles, _, rt = F.shape
    T = tri_mat.shape[3]
    dev = F.device
    valid = torch.ones((1, n_tiles), dtype=torch.bool, device=dev)
    ts, idxs = [], []
    for sl in _env_batches(N, n_tiles * 4 * C * rt):
        Fs = F[sl]
        n = Fs.shape[0]
        Mg = tri_mat[sids[sl].long()]  # (n, 10, 4, T)
        best_t = torch.full((n, n_tiles, rt), _TMAX, device=dev)
        best_i = torch.full((n, n_tiles, rt), -1, dtype=torch.int32, device=dev)
        for c in range(T // C):
            G = torch.einsum("nfc,ntfr->ntcr", Mg[..., c * C:(c + 1) * C].reshape(n, 10, 4 * C), Fs)
            base = torch.full((n, n_tiles), c, dtype=torch.int32, device=dev)
            best_t, best_i = _fold(G, C, base, valid, best_t, best_i, strict=strict, tested=tested)
        t, i = _finish(best_t, best_i)
        ts.append(t)
        idxs.append(i)
    return torch.cat(ts), torch.cat(idxs)


def raycast_index_t_plain(tri_mat, sids, features_t, ray_tile=2048, tested=None):
    """Plain version of the index kernel: every chunk of min(128, T)
    triangles of the env's scene, in order. ``tested``: see ``_fold``."""
    return _index_plain(tri_mat, sids, features_t[:, :, :10], min(128, tri_mat.shape[3]), strict=False,
                        tested=tested)


def raycast_index_plain(tri_mat, sids, features, ray_tile=2048, tri_chunk=128, tested=None):
    """Plain version of the v3 index kernel: row-major features (N, R, 10),
    every chunk of min(tri_chunk, T) triangles in order, split margin.
    ``tested``: see ``_fold``."""
    F = features.transpose(1, 2)[:, None]  # (N, 1, 10, R)
    return _index_plain(tri_mat, sids, F, min(tri_chunk, tri_mat.shape[3]), strict=True, tested=tested)


def _culled_plain(tri_mat, tri_attr, chunk_ids, sids, F, C, tested=None):
    """Every listed chunk of C triangles in list order, for ray features F
    (N, nt, 10, rt), then the winner's attribute row of ``tri_attr`` (S, T,
    8), zero on a miss: (t (N, R), attrs (N, R, 8)). Ids outside [0, T / C)
    are skipped, as the kernels skip them. ``tested``: see ``_fold``."""
    N, n_tiles, _, rt = F.shape
    S, _, _, T = tri_mat.shape
    NC = T // C
    dev = F.device
    # chunk-major (S * NC, 10, 4C): chunk c as [detA(C)|tnum(C)|unum(C)|vnum(C)]
    chunks = tri_mat.reshape(S, 10, 4, NC, C).permute(0, 3, 1, 2, 4).reshape(S * NC, 10, 4 * C)
    ts, attrs = [], []
    for sl in _env_batches(N, n_tiles * 4 * C * rt):
        Fs = F[sl]
        n = Fs.shape[0]
        sid = sids[sl].long()
        best_t = torch.full((n, n_tiles, rt), _TMAX, device=dev)
        best_i = torch.full((n, n_tiles, rt), -1, dtype=torch.int32, device=dev)
        for k in range(chunk_ids.shape[2]):
            cid = chunk_ids[sl, :, k]  # (n, nt)
            valid = (cid >= 0) & (cid < NC)
            G = torch.einsum("ntfc,ntfr->ntcr", chunks[sid[:, None] * NC + cid.clamp(0, NC - 1).long()], Fs)
            best_t, best_i = _fold(G, C, cid, valid, best_t, best_i, strict=True, tested=tested)
        hit = best_t < _TMAX
        a = tri_attr[sid[:, None], best_i.reshape(n, -1).clamp(min=0).long()]  # (n, R, 8)
        ts.append(best_t.reshape(n, -1))
        attrs.append(a * hit.reshape(n, -1, 1))
    return torch.cat(ts), torch.cat(attrs)


def raycast_culled_t_plain(tri_mat, tri_attr_t, chunk_ids, sids, features_t, ray_tile=1024, tri_chunk=128,
                           tested=None):
    """Plain version of the culled kernel: every listed chunk of
    ``tri_chunk`` triangles in list order, then the winner's attributes.
    ``tested``: see ``_fold``."""
    t, attrs = _culled_plain(tri_mat, tri_attr_t.transpose(1, 2), chunk_ids, sids, features_t[:, :, :10], tri_chunk,
                             tested)
    return t, attrs.transpose(1, 2)


def _batch_features(origins, dirs, features):
    """The ray-batch entry points' features: ``features`` or those of
    (origins, dirs)."""
    if features is not None:
        return features
    from habitat_torch.ops.raycast import ray_features

    return ray_features(origins, dirs)


def raycast_culled_plain(tri_mat, tri_attr, chunk_ids, sids, origins=None, dirs=None, ray_tile=1024,
                         tri_chunk=128, features=None, tested=None):
    """Plain version of the v3 culled kernel: row-major features (N, R, 10)
    and attribute rows (S, T, 8); returns (t (N, R), attrs (N, R, 8)).
    ``tested``: see ``_fold``."""
    features = _batch_features(origins, dirs, features)
    N, R, _ = features.shape
    F = features.reshape(N, R // ray_tile, ray_tile, 10).transpose(2, 3)  # (N, nt, 10, rt)
    return _culled_plain(tri_mat, tri_attr, chunk_ids, sids, F, tri_chunk, tested)


def raycast_tilecull_t_plain(tri_mat_c, attr16, chunk_ids, cnt, sids, d_t, Bt, ray_tile=2048, tri_chunk=32):
    """Plain version of the tile-cull kernel: the frustum-selected loop over
    each tile's first ``cnt`` listed chunks, then for every ray the winner's
    16 ``attr16`` rows (zero without a winner), t = n.(v0 - o) / (n.d) on a
    hit unless |n.d| < 1e-6, t = 1e6 on a miss, and row 12 = 0.35 + 0.65
    |n.d|, each product and sum rounded in the kernel's order."""
    best_t, best_i = _listed_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, tri_chunk, finish=False)
    N, R = best_t.shape
    n_tiles, _, rt = d_t.shape
    C = tri_chunk
    g = best_i.clamp(min=0).long()
    A = attr16[sids.long()[:, None], g // C, :, g % C] * (best_i >= 0)[..., None]  # (N, R, 16)
    d = _features(Bt, d_t)[:, :, 0:3].transpose(1, 2).reshape(N, 3, R)  # world dirs
    o = Bt[:, 3:6, 3:4]  # (N, 3, 1)
    a = A.transpose(1, 2)  # (N, 16, R)
    nd = a[:, 0] * d[:, 0] + a[:, 1] * d[:, 1] + a[:, 2] * d[:, 2]
    num = a[:, 0] * (a[:, 3] - o[:, 0]) + a[:, 1] * (a[:, 4] - o[:, 1]) + a[:, 2] * (a[:, 5] - o[:, 2])
    hit = best_t < _TMAX * 0.5
    grazing = nd.abs() < 1e-6
    t_pl = num / torch.where(grazing, torch.ones_like(nd), nd)
    t = torch.where(hit, torch.where(grazing, best_t, t_pl), _TMAX)
    out = torch.cat([a[:, :12], (0.35 + 0.65 * nd.abs())[:, None], a[:, 13:]], dim=1)  # (N, 16, R)
    return t, out.reshape(N, 16, n_tiles, rt).transpose(1, 2).contiguous()


def attr16_table(tri_attr: torch.Tensor, tri_v0: torch.Tensor, tri_chunk: int = 32) -> torch.Tensor:
    """(S, T, 8) [n(3), rgb(3), sem, valid], (S, T, 3) -> the tile-cull
    kernel's chunked table (S, T // C, 16, C), rows [n(3), v0(3), gid, sem |
    rgb(3), valid, 4 zero]; gid is the global triangle index as float32
    (exact below 2**24)."""
    S, T, _ = tri_attr.shape
    C = tri_chunk
    at = tri_attr.transpose(1, 2)  # (S, 8, T)
    gid = torch.arange(T, dtype=torch.float32, device=tri_attr.device).expand(S, 1, T)
    flat = torch.cat(
        [at[:, 0:3], tri_v0.transpose(1, 2), gid, at[:, 6:7], at[:, 3:6], at[:, 7:8],
         torch.zeros(S, 4, T, device=tri_attr.device)],
        dim=1,
    )  # (S, 16, T)
    return flat.reshape(S, 16, T // C, C).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_fused_launch(tri_mat_c, tri_chunk):
    """The fused kernels copy and read four consecutive lanes of a chunk's
    rows as 16-byte words."""
    if tri_chunk not in (32, 128) or tri_mat_c.data_ptr() % 16:
        raise ValueError(f"the fused kernels take a 16-byte aligned tri_mat_c in chunks of 32 or 128, not "
                         f"{tri_chunk} (data_ptr % 16 = {tri_mat_c.data_ptr() % 16})")


def _check_listed_ids(chunk_ids, cnt, tri_mat_c, tri_chunk):
    """The listed fused kernels read a tile's first min(cnt, K) ids
    unchecked, as their plain versions do: an id outside [0, T / C) reads
    past the scene's slab. The wrappers' opt-in ``check_ids`` (one host
    sync) raises on one instead."""
    n_chunks = tri_mat_c.shape[2] // 4 // tri_chunk
    listed = torch.arange(chunk_ids.shape[2], device=chunk_ids.device) < cnt[..., None]
    bad = listed & ((chunk_ids < 0) | (chunk_ids >= n_chunks))
    if bool(bad.any()):
        raise ValueError(f"{int(bad.sum())} listed chunk ids lie outside [0, {n_chunks})")


def _check_ring_launch(tri_mat, tri_chunk):
    """The index and culled kernels copy 16-byte words of the scene
    matrix."""
    if tri_chunk % 4 or tri_mat.shape[3] % 4 or tri_mat.data_ptr() % 16:
        raise ValueError(f"the ring kernels take a 16-byte aligned tri_mat {tuple(tri_mat.shape)} and chunks of a "
                         f"multiple of 4 triangles, not {tri_chunk}")


def raycast_fused_sel_t(
    tri_mat_c: torch.Tensor,  # (S, 10, 4T) group_tri_mat(tri_mat, C)
    sids: torch.Tensor,  # (N,) int32
    chunk_ids: torch.Tensor,  # (N, nt, K) int32 survivors first
    cnt: torch.Tensor,  # (N, nt) int32 survivor counts
    d_t: torch.Tensor,  # (nt, 8, Rt) camera [d, 1] transposed
    Bt: torch.Tensor,  # (N, 16, 4) ray-feature matrices B^T
    ray_tile: int = 2048,
    tri_chunk: int = 32,
    check_ids: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frustum-selected closest hit: (t (N,R) f32, idx (N,R) i32). The
    listed ids must lie in [0, T / C); ``check_ids`` raises on one that
    does not (one host sync)."""
    n_tiles = _check_inputs(
        tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk,
        extra=(("chunk_ids", chunk_ids, torch.int32), ("cnt", cnt, torch.int32)),
    )
    N = sids.shape[0]
    if chunk_ids.shape[:2] != (N, n_tiles) or cnt.shape != (N, n_tiles):
        raise ValueError(f"chunk_ids {tuple(chunk_ids.shape)} / cnt {tuple(cnt.shape)}")
    if check_ids:
        _check_listed_ids(chunk_ids, cnt, tri_mat_c, tri_chunk)
    if d_t.device.type == "cpu":
        return raycast_fused_sel_t_plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile, tri_chunk)
    _check_fused_launch(tri_mat_c, tri_chunk)
    lib = cuda_build.load("raycast_fused")
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=d_t.device)
    idx = torch.empty((N, n_tiles * ray_tile), dtype=torch.int32, device=d_t.device)
    err = lib.raycast_fused_sel(
        tri_mat_c.data_ptr(), sids.data_ptr(), chunk_ids.data_ptr(), cnt.data_ptr(),
        d_t.data_ptr(), Bt.data_ptr(), t.data_ptr(), idx.data_ptr(),
        N, tri_mat_c.shape[2], n_tiles, chunk_ids.shape[2], ray_tile, tri_chunk,
        torch.cuda.current_stream(d_t.device).cuda_stream,
    )
    cuda_build.raise_on(err, "raycast_fused_sel")
    cuda_build.count_launch(raycast_fused_sel_t)
    return t, idx


raycast_fused_sel_t.launches = 0
raycast_fused_sel_t.plain = raycast_fused_sel_t_plain


def raycast_fused_t(
    tri_mat_c: torch.Tensor,  # (S, 10, 4T) group_tri_mat(tri_mat, C)
    sids: torch.Tensor,  # (N,) int32
    d_t: torch.Tensor,  # (nt, 8, Rt)
    Bt: torch.Tensor,  # (N, 16, 4)
    ray_tile: int = 2048,
    tri_chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every-chunk closest hit: (t (N,R) f32, idx (N,R) i32)."""
    n_tiles = _check_inputs(tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk)
    if d_t.device.type == "cpu":
        return raycast_fused_t_plain(tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk)
    _check_fused_launch(tri_mat_c, tri_chunk)
    lib = cuda_build.load("raycast_fused")
    N = sids.shape[0]
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=d_t.device)
    idx = torch.empty((N, n_tiles * ray_tile), dtype=torch.int32, device=d_t.device)
    err = lib.raycast_fused(
        tri_mat_c.data_ptr(), sids.data_ptr(), d_t.data_ptr(), Bt.data_ptr(),
        t.data_ptr(), idx.data_ptr(),
        N, tri_mat_c.shape[2], n_tiles, ray_tile, tri_chunk,
        torch.cuda.current_stream(d_t.device).cuda_stream,
    )
    cuda_build.raise_on(err, "raycast_fused")
    cuda_build.count_launch(raycast_fused_t)
    return t, idx


raycast_fused_t.launches = 0
raycast_fused_t.plain = raycast_fused_t_plain


def _stream_call(wrapper, name, tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile, tri_chunk):
    n_tiles = _check_inputs(
        tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk,
        extra=(("chunk_ids", chunk_ids, torch.int32), ("cnt", cnt, torch.int32)),
    )
    N = sids.shape[0]
    if chunk_ids.shape[:2] != (N, n_tiles) or cnt.shape != (N, n_tiles):
        raise ValueError(f"chunk_ids {tuple(chunk_ids.shape)} / cnt {tuple(cnt.shape)}")
    if (tri_mat_c.shape[2] // 4) // tri_chunk > _ID_MASK + 1:
        raise ValueError("a packed chunk id has 18 bits")
    if tri_mat_c.data_ptr() % 16:
        raise ValueError("tri_mat_c: the kernel reads it in 16-byte words, so it must be 16-byte aligned")
    if d_t.device.type == "cpu":
        return wrapper.plain(tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile, tri_chunk)
    if tri_chunk % STREAM_UNIT or ray_tile % STREAM_BLOCK_RAYS:
        raise ValueError(f"the kernel takes chunks of a multiple of {STREAM_UNIT} triangles and ray tiles of a "
                         f"multiple of {STREAM_BLOCK_RAYS}, not {tri_chunk}, {ray_tile}")
    lib = cuda_build.load("raycast_stream")
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=d_t.device)
    idx = torch.empty((N, n_tiles * ray_tile), dtype=torch.int32, device=d_t.device)
    err = lib.raycast_stream(
        tri_mat_c.data_ptr(), sids.data_ptr(), chunk_ids.data_ptr(), cnt.data_ptr(),
        d_t.data_ptr(), Bt.data_ptr(), t.data_ptr(), idx.data_ptr(),
        N, tri_mat_c.shape[2], n_tiles, chunk_ids.shape[2], ray_tile, tri_chunk, STREAM_BLOCK_RAYS,
        STREAM_WARP_RAYS, torch.cuda.current_stream(d_t.device).cuda_stream,
    )
    cuda_build.raise_on(err, name)
    cuda_build.count_launch(wrapper)
    return t, idx


def raycast_exactsel_t(
    tri_mat_c: torch.Tensor,  # (S, 10, 4T) group_tri_mat(tri_mat, 32)
    sids: torch.Tensor,  # (N,) int32
    chunk_ids: torch.Tensor,  # (N, nt, Kf) int32 packed (dmin_cm << 18) | chunklet id,
    #                           survivors first, ascending
    cnt: torch.Tensor,  # (N, nt) int32 survivor counts
    d_t: torch.Tensor,  # (nt, 8, Rt) camera [d, 1] transposed, 32x32-pixel tiles
    Bt: torch.Tensor,  # (N, 16, 4) ray-feature matrices B^T
    ray_tile: int = 1024,
    tri_chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-culled chunklet stream closest hit: (t (N,R) f32, idx (N,R)
    i32), rays in tile order; idx is a global triangle index."""
    return _stream_call(
        raycast_exactsel_t, "raycast_exactsel", tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile, tri_chunk
    )


raycast_exactsel_t.launches = 0
raycast_exactsel_t.plain = raycast_exactsel_t_plain


def raycast_stream_t(
    tri_mat_c: torch.Tensor,  # (S, 10, 4T) group_tri_mat(tri_mat, C), C = 128 or 256
    sids: torch.Tensor,  # (N,) int32
    chunk_ids: torch.Tensor,  # (N, nt, K) int32 packed (dmin_cm << 18) | chunk id
    cnt: torch.Tensor,  # (N, nt) int32
    d_t: torch.Tensor,  # (nt, 8, Rt)
    Bt: torch.Tensor,  # (N, 16, 4)
    ray_tile: int = 1024,
    tri_chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-first parent-chunk stream closest hit: (t, idx) as above."""
    return _stream_call(
        raycast_stream_t, "raycast_stream", tri_mat_c, sids, chunk_ids, cnt, d_t, Bt, ray_tile, tri_chunk
    )


raycast_stream_t.launches = 0
raycast_stream_t.plain = raycast_stream_t_plain


def cullmask_t(
    verts16: torch.Tensor,  # (S, T, 16) f32 rows [v0 | e1 | e2 | pad(6) | valid]
    sids: torch.Tensor,  # (N,) int32
    head: torch.Tensor,  # (N, nt, ka) int32 packed nearest-first head
    cntk: torch.Tensor,  # (N, nt) int32 head counts
    nw: torch.Tensor,  # (N, nt, 4, 3) world inward tile-plane normals
    cam_pos: torch.Tensor,  # (N, 3)
    eps: float = -1e-3,
    c: int = 32,
) -> torch.Tensor:
    """Per (head slot, triangle) pass mask of the exact cull, (N, nt, ka, c)
    f32. Slots at or beyond ``cntk`` hold no result (0 from the kernel);
    callers gate by head position."""
    dev = verts16.device
    for name, x, dt in (
        ("verts16", verts16, torch.float32), ("sids", sids, torch.int32),
        ("head", head, torch.int32), ("cntk", cntk, torch.int32),
        ("nw", nw, torch.float32), ("cam_pos", cam_pos, torch.float32),
    ):
        if x.device != dev or x.dtype != dt or not x.is_contiguous() or (x is verts16 and x.data_ptr() % 16):
            raise ValueError(
                f"{name}: expected a contiguous {dt} tensor on {dev} (verts16 16-byte aligned), got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    N, nt, ka = head.shape
    S, T, w = verts16.shape
    if (
        w != 16 or T % c or c != 32 or cntk.shape != (N, nt) or nw.shape != (N, nt, 4, 3)
        or cam_pos.shape != (N, 3) or sids.shape != (N,)
    ):
        raise ValueError(
            f"bad shapes verts16 {tuple(verts16.shape)} head {tuple(head.shape)} cntk "
            f"{tuple(cntk.shape)} nw {tuple(nw.shape)} cam_pos {tuple(cam_pos.shape)} c {c}"
        )
    if dev.type == "cpu":
        return cull_mask_torch(verts16, sids, head, cntk, nw, cam_pos, eps, c)
    lib = cuda_build.load("cullmask")
    out = torch.empty((N, nt, ka, c), dtype=torch.float32, device=dev)
    err = lib.cullmask(
        verts16.data_ptr(), sids.data_ptr(), head.data_ptr(), cntk.data_ptr(),
        nw.data_ptr(), cam_pos.data_ptr(), out.data_ptr(),
        N, nt, ka, T // c, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.raise_on(err, "cullmask")
    cuda_build.count_launch(cullmask_t)
    return out


cullmask_t.launches = 0
cullmask_t.plain = cull_mask_torch


def _check_general(tri_mat, sids, features_t, ray_tile, extra=()):
    _require(features_t.device, (
        ("tri_mat", tri_mat, torch.float32),
        ("sids", sids, torch.int32),
        ("features_t", features_t, torch.float32),
        *extra,
    ))
    N, n_tiles, k16, rt = features_t.shape
    if k16 != 16 or rt != ray_tile or sids.shape != (N,) or tri_mat.shape[1:3] != (10, 4):
        raise ValueError(
            f"bad shapes features_t {tuple(features_t.shape)} (ray_tile {ray_tile}) sids "
            f"{tuple(sids.shape)} tri_mat {tuple(tri_mat.shape)}"
        )
    return N, n_tiles


def raycast_index_t(
    tri_mat: torch.Tensor,  # (S, 10, 4, T)
    sids: torch.Tensor,  # (N,) int32
    features_t: torch.Tensor,  # (N, nt, 16, Rt) ray_features_t, rows 0:10 used
    ray_tile: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit against every chunk of min(128, T) triangles of the env's
    scene: (t (N, R) f32, idx (N, R) i32). ``ray_tile`` is any size (the
    whole image for an untiled one)."""
    N, n_tiles = _check_general(tri_mat, sids, features_t, ray_tile)
    T = tri_mat.shape[3]
    C = min(128, T)
    if T % C:
        raise ValueError(f"{T} triangles do not split into chunks of {C}")
    if features_t.device.type == "cpu":
        return raycast_index_t_plain(tri_mat, sids, features_t, ray_tile)
    _check_ring_launch(tri_mat, C)
    lib = cuda_build.load("raycast_general")
    dev = features_t.device
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=dev)
    idx = torch.empty((N, n_tiles * ray_tile), dtype=torch.int32, device=dev)
    err = lib.raycast_index(
        tri_mat.data_ptr(), sids.data_ptr(), features_t.data_ptr(), t.data_ptr(), idx.data_ptr(),
        N, T, C, n_tiles, ray_tile, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.raise_on(err, "raycast_index")
    cuda_build.count_launch(raycast_index_t)
    return t, idx


raycast_index_t.launches = 0
raycast_index_t.plain = raycast_index_t_plain


def raycast_culled_t(
    tri_mat: torch.Tensor,  # (S, 10, 4, T)
    tri_attr_t: torch.Tensor,  # (S, 8, T) transposed attribute tables
    chunk_ids: torch.Tensor,  # (N, nt, K) int32 candidate chunks, in the order to test
    sids: torch.Tensor,  # (N,) int32
    features_t: torch.Tensor,  # (N, nt, 16, Rt)
    ray_tile: int = 1024,
    tri_chunk: int = 128,  # the pack's chunk size T // NC, the unit of chunk_ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit over each (env, tile)'s K listed chunks with the winner's
    attributes: (t (N, R) f32, 1e6 on a miss; attrs_t (N, 8, R) f32, zero
    on a miss, so attrs_t[:, 7] (valid) marks the hits)."""
    N, n_tiles = _check_general(
        tri_mat, sids, features_t, ray_tile,
        extra=(("tri_attr_t", tri_attr_t, torch.float32), ("chunk_ids", chunk_ids, torch.int32)),
    )
    S, _, _, T = tri_mat.shape
    if (
        T % tri_chunk or tri_attr_t.shape != (S, 8, T) or chunk_ids.dim() != 3
        or chunk_ids.shape[:2] != (N, n_tiles)
    ):
        raise ValueError(
            f"bad shapes tri_attr_t {tuple(tri_attr_t.shape)} chunk_ids {tuple(chunk_ids.shape)} "
            f"for tri_mat {tuple(tri_mat.shape)} in chunks of {tri_chunk}"
        )
    if features_t.device.type == "cpu":
        return raycast_culled_t_plain(tri_mat, tri_attr_t, chunk_ids, sids, features_t, ray_tile, tri_chunk)
    _check_ring_launch(tri_mat, tri_chunk)
    lib = cuda_build.load("raycast_general")
    dev = features_t.device
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=dev)
    attrs = torch.empty((N, 8, n_tiles * ray_tile), dtype=torch.float32, device=dev)
    err = lib.raycast_culled(
        tri_mat.data_ptr(), tri_attr_t.data_ptr(), chunk_ids.data_ptr(), sids.data_ptr(),
        features_t.data_ptr(), t.data_ptr(), attrs.data_ptr(),
        N, T, tri_chunk, n_tiles, chunk_ids.shape[2], ray_tile, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.raise_on(err, "raycast_culled")
    cuda_build.count_launch(raycast_culled_t)
    return t, attrs


raycast_culled_t.launches = 0
raycast_culled_t.plain = raycast_culled_t_plain


def _as_int32(*xs):
    return [x.to(torch.int32).contiguous() for x in xs]


def raycast_index(
    tri_mat: torch.Tensor,  # (S, 10, 4, T)
    sids: torch.Tensor,  # (N,) int
    features: torch.Tensor,  # (N, R, 10) ray_features
    ray_tile: int = 2048,
    tri_chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """v3 closest hit against every chunk of min(tri_chunk, T) triangles of
    the env's scene, from row-major ray features, split margin: (t (N, R)
    f32, idx (N, R) i32; 1e6 and -1 on a miss). ``ray_tile`` is min(ray_tile,
    R) and must divide R, as the TPU kernel's grid needs; it changes no
    value."""
    (sids,) = _as_int32(sids)
    _require(features.device, (("tri_mat", tri_mat, torch.float32), ("sids", sids, torch.int32),
                               ("features", features, torch.float32)))
    N, R, k10 = features.shape
    S, ten, four, T = tri_mat.shape
    C = min(tri_chunk, T)
    rt = min(ray_tile, R)
    if k10 != 10 or sids.shape != (N,) or (ten, four) != (10, 4) or T % C or R % rt:
        raise ValueError(
            f"bad shapes features {tuple(features.shape)} sids {tuple(sids.shape)} tri_mat "
            f"{tuple(tri_mat.shape)} (chunks of {C}, ray tile {rt})"
        )
    if features.device.type == "cpu":
        return raycast_index_plain(tri_mat, sids, features, ray_tile, tri_chunk)
    _check_ring_launch(tri_mat, C)
    lib = cuda_build.load("raycast_general")
    dev = features.device
    t = torch.empty((N, R), dtype=torch.float32, device=dev)
    idx = torch.empty((N, R), dtype=torch.int32, device=dev)
    err = lib.raycast_index_rm(
        tri_mat.data_ptr(), sids.data_ptr(), features.data_ptr(), t.data_ptr(), idx.data_ptr(),
        N, T, C, R, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.raise_on(err, "raycast_index_rm")
    cuda_build.count_launch(raycast_index)
    return t, idx


raycast_index.launches = 0
raycast_index.plain = raycast_index_plain


def raycast_batch(
    tri_mat: torch.Tensor,  # (S, 10, 4, T)
    tri_attr: torch.Tensor,  # (S, T, 8) attribute tables
    sids: torch.Tensor,  # (N,)
    origins: Optional[torch.Tensor] = None,  # (N, R, 3)
    dirs: Optional[torch.Tensor] = None,  # (N, R, 3)
    ray_tile: int = 2048,
    tri_chunk: int = 128,
    features: Optional[torch.Tensor] = None,  # precomputed (N, R, 10)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit and attributes for all envs: ``raycast_index``, then the
    winner's row of ``tri_attr``, gathered exactly, zero on a miss. Returns
    (t (N, R) f32, attrs (N, R, 8) f32); attrs[..., 7] == 0 marks a miss."""
    features = _batch_features(origins, dirs, features)
    t, idx = raycast_index(tri_mat, sids, features, ray_tile=ray_tile, tri_chunk=tri_chunk)
    hit = idx >= 0
    attrs = tri_attr[sids.long()[:, None], idx.clamp(min=0).long()] * hit[..., None]
    return t, attrs


def raycast_culled(
    tri_mat: torch.Tensor,  # (S, 10, 4, T)
    tri_attr: torch.Tensor,  # (S, T, 8)
    chunk_ids: torch.Tensor,  # (N, nt, K) candidate chunk ids in units of tri_chunk
    sids: torch.Tensor,  # (N,)
    origins: Optional[torch.Tensor] = None,  # (N, R, 3)
    dirs: Optional[torch.Tensor] = None,  # (N, R, 3)
    ray_tile: int = 1024,
    tri_chunk: int = 128,
    features: Optional[torch.Tensor] = None,  # precomputed (N, R, 10)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """v3 culled closest hit with attributes: each ray tile tests its K
    listed chunks of ``tri_chunk`` triangles in list order (strict < across
    them, the lowest lane within), and keeps the winner's attribute row.
    Returns (t (N, R) f32, 1e6 on a miss; attrs (N, R, 8) f32, zero on a
    miss). The JAX wrapper splits N in halves when its id table passes 96 KB,
    a TPU scalar-memory budget that changes no value; it is not ported."""
    features = _batch_features(origins, dirs, features)
    sids, chunk_ids = _as_int32(sids, chunk_ids)
    _require(features.device, (
        ("tri_mat", tri_mat, torch.float32), ("tri_attr", tri_attr, torch.float32),
        ("chunk_ids", chunk_ids, torch.int32), ("sids", sids, torch.int32), ("features", features, torch.float32),
    ))
    N, R, k10 = features.shape
    S, _, _, T = tri_mat.shape
    if (
        k10 != 10 or R % ray_tile or T % tri_chunk or tri_attr.shape != (S, T, 8) or sids.shape != (N,)
        or chunk_ids.dim() != 3 or chunk_ids.shape[:2] != (N, R // ray_tile) or tri_mat.shape[1:3] != (10, 4)
    ):
        raise ValueError(
            f"bad shapes features {tuple(features.shape)} (ray tile {ray_tile}) tri_attr {tuple(tri_attr.shape)} "
            f"chunk_ids {tuple(chunk_ids.shape)} for tri_mat {tuple(tri_mat.shape)} in chunks of {tri_chunk}"
        )
    if features.device.type == "cpu":
        return raycast_culled_plain(tri_mat, tri_attr, chunk_ids, sids, ray_tile=ray_tile, tri_chunk=tri_chunk,
                                    features=features)
    _check_ring_launch(tri_mat, tri_chunk)
    lib = cuda_build.load("raycast_general")
    dev = features.device
    t = torch.empty((N, R), dtype=torch.float32, device=dev)
    attrs = torch.empty((N, R, 8), dtype=torch.float32, device=dev)
    err = lib.raycast_culled_rm(
        tri_mat.data_ptr(), tri_attr.data_ptr(), chunk_ids.data_ptr(), sids.data_ptr(), features.data_ptr(),
        t.data_ptr(), attrs.data_ptr(), N, T, tri_chunk, R // ray_tile, chunk_ids.shape[2], ray_tile,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.raise_on(err, "raycast_culled_rm")
    cuda_build.count_launch(raycast_culled)
    return t, attrs


raycast_culled.launches = 0
raycast_culled.plain = raycast_culled_plain

_DESIGN_KEYS = ("rays_per_thread", "rays_per_block", "rays_per_warp", "ring_stages", "registers", "spill_bytes",
                "static_smem_bytes", "dynamic_smem_bytes", "blocks_per_sm")


def _design(source, fn, *args):
    out = (ctypes.c_int * len(_DESIGN_KEYS))()
    cuda_build.raise_on(getattr(cuda_build.load(source), fn)(*args, ctypes.addressof(out)), fn)
    return dict(zip(_DESIGN_KEYS, out))


def stream_design() -> dict:
    """The stream kernel's design on the current card, as the library
    reports it (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor): rays per thread, block
    and warp, ring stages, registers and spilled bytes per thread, static
    and dynamic shared bytes, blocks per SM."""
    return _design("raycast_stream", "raycast_stream_design")


def culled_design(tri_chunk: int, k_max: int, row_major: bool = False) -> dict:
    """The same for the culled kernels (``row_major``: raycast_culled's) at
    chunk size ``tri_chunk`` and list length ``k_max``."""
    return _design("raycast_general", "raycast_culled_design", int(row_major), tri_chunk, k_max)


def index_design(tri_chunk: int = 128, row_major: bool = False) -> dict:
    """The same for the index kernels (``row_major``: raycast_index's) at
    chunk size ``tri_chunk``."""
    return _design("raycast_general", "raycast_index_design", int(row_major), tri_chunk)


def fused_design(tri_chunk: int = 32) -> dict:
    """The same for the frustum-selected and every-chunk kernel at chunk size
    ``tri_chunk`` (32 or 128)."""
    return _design("raycast_fused", "raycast_fused_design", tri_chunk, 0)


def tilecull_design(tri_chunk: int = 32) -> dict:
    """The same for the tile-cull kernel (that kernel with its epilogue) at
    chunk size ``tri_chunk`` (32 or 128)."""
    return _design("raycast_fused", "raycast_fused_design", tri_chunk, 1)


def cullmask_design() -> dict:
    """The cull-mask kernel's design on the current card: triangles per slot
    (the wrapper's ``c``), warps per block, slots a warp has in flight,
    threads per block, registers and spilled bytes per thread, static shared
    bytes, blocks per SM."""
    keys = ("triangles_per_slot", "warps_per_block", "slots_in_flight", "threads_per_block", "registers",
            "spill_bytes", "static_smem_bytes", "blocks_per_sm")
    out = (ctypes.c_int * len(keys))()
    cuda_build.raise_on(cuda_build.load("cullmask").cullmask_design(ctypes.addressof(out)), "cullmask_design")
    return dict(zip(keys, out))


def raycast_tilecull_t(
    tri_mat_c: torch.Tensor,  # (S, 10, 4T) group_tri_mat(tri_mat, C)
    attr16: torch.Tensor,  # (S, T // C, 16, C) attr16_table
    chunk_ids: torch.Tensor,  # (N, nt, K) survivors first, the tail repeating the last
    cnt: torch.Tensor,  # (N, nt) survivor counts
    sids: torch.Tensor,  # (N,)
    d_t: torch.Tensor,  # (nt, 8, Rt) camera [d, 1] transposed
    Bt: torch.Tensor,  # (N, 16, 4) ray-feature matrices B^T
    ray_tile: int = 2048,
    tri_chunk: int = 32,
    check_ids: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-culled closest hit with plane-exact t and shading: (t (N, R)
    f32, plane-exact on a hit, 1e6 on a miss; attrs (N, nt, 16, Rt) f32 rows
    [n(3), v0(3), gid, sem, rgb(3), valid, shade, 0, 0, 0]). Every ray gets
    the epilogue: on a miss the rows are zero but the shade reads 0.35. The
    winner is the frustum-selected kernel's on the same inputs, and, as
    there, the listed ids must lie in [0, T / C): neither the kernel nor
    the plain version skips others. ``check_ids`` raises on one that does
    not (one host sync)."""
    sids, chunk_ids, cnt = _as_int32(sids, chunk_ids, cnt)
    n_tiles = _check_inputs(
        tri_mat_c, sids, d_t, Bt, ray_tile, tri_chunk,
        extra=(("attr16", attr16, torch.float32), ("chunk_ids", chunk_ids, torch.int32), ("cnt", cnt, torch.int32)),
    )
    N = sids.shape[0]
    S, _, T4 = tri_mat_c.shape
    C = tri_chunk
    if (
        attr16.shape != (S, T4 // 4 // C, 16, C) or chunk_ids.dim() != 3 or chunk_ids.shape[:2] != (N, n_tiles)
        or chunk_ids.shape[2] < 1 or cnt.shape != (N, n_tiles)
    ):
        raise ValueError(
            f"bad shapes attr16 {tuple(attr16.shape)} chunk_ids {tuple(chunk_ids.shape)} cnt {tuple(cnt.shape)} "
            f"for tri_mat_c {tuple(tri_mat_c.shape)} in chunks of {C}"
        )
    if check_ids:
        _check_listed_ids(chunk_ids, cnt, tri_mat_c, C)
    if d_t.device.type == "cpu":
        return raycast_tilecull_t_plain(tri_mat_c, attr16, chunk_ids, cnt, sids, d_t, Bt, ray_tile, tri_chunk)
    _check_fused_launch(tri_mat_c, C)
    lib = cuda_build.load("raycast_fused")
    dev = d_t.device
    t = torch.empty((N, n_tiles * ray_tile), dtype=torch.float32, device=dev)
    attrs = torch.empty((N, n_tiles, 16, ray_tile), dtype=torch.float32, device=dev)
    err = lib.raycast_tilecull(
        tri_mat_c.data_ptr(), attr16.data_ptr(), sids.data_ptr(), chunk_ids.data_ptr(), cnt.data_ptr(),
        d_t.data_ptr(), Bt.data_ptr(), t.data_ptr(), attrs.data_ptr(),
        N, T4, n_tiles, chunk_ids.shape[2], ray_tile, C, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.raise_on(err, "raycast_tilecull")
    cuda_build.count_launch(raycast_tilecull_t)
    return t, attrs


raycast_tilecull_t.launches = 0
raycast_tilecull_t.plain = raycast_tilecull_t_plain
