"""Navigation-grid queries on tensors, batched over envs (port of
``habitat_tpu/ops/navgrid.py``): navigability tests, sliding collision for
agent motion, snapping to the nearest navigable cell, geodesic-distance
lookups on precomputed fields.

Nothing here copies from the host: the xz components are taken by slicing
(``pos[..., ::2]``), not by a Python index list, and masks are built from
the inputs on their device, so a call on card tensors never waits on the
card."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from habitat_torch.sims.scene import INF_DIST, ScenePack
from habitat_torch.utils import threefry


def world_to_cell_f(nav_lo: torch.Tensor, nav_res: float, xz: torch.Tensor) -> torch.Tensor:
    """Continuous cell coordinates (float). Multiplies by the float32
    reciprocal of ``nav_res``, which is what the JAX package's compiled step
    computes (XLA folds division by a constant into that product): agents
    start on cell centres, where the two forms round to opposite sides of a
    cell boundary."""
    return (xz - nav_lo) * float(np.float32(1.0) / np.float32(nav_res))


def is_navigable(pack: ScenePack, sid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """pos (N,3) world, sid (N,) -> (N,) bool. Nearest-cell test,
    out-of-grid = False."""
    nx, nz = pack.nav_occ.shape[-2], pack.nav_occ.shape[-1]
    cf = world_to_cell_f(pack.nav_lo[sid], pack.nav_res, pos[..., ::2])
    ci = torch.round(cf).to(torch.int64)
    inb = (ci[..., 0] >= 0) & (ci[..., 0] < nx) & (ci[..., 1] >= 0) & (ci[..., 1] < nz)
    return inb & pack.nav_occ[sid, ci[..., 0].clamp(0, nx - 1), ci[..., 1].clamp(0, nz - 1)]


def try_step(
    pack: ScenePack,
    sid: torch.Tensor,  # (N,)
    pos: torch.Tensor,  # (N,3)
    target: torch.Tensor,  # (N,3)
    n_substeps: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move agents toward target with wall sliding; returns (new_pos,
    collided). Each substep tries the full delta, then its x-only and z-only
    components; ``collided`` is True iff some substep could not take the
    full delta."""
    delta = (target - pos) / n_substeps
    dx = torch.stack([delta[:, 0], delta[:, 1] * 0.0, delta[:, 2] * 0.0], dim=-1)
    dz = torch.stack([delta[:, 0] * 0.0, delta[:, 1] * 0.0, delta[:, 2]], dim=-1)
    p = pos
    collided = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    for _ in range(n_substeps):
        cand, cand_x, cand_z = p + delta, p + dx, p + dz
        ok_full = is_navigable(pack, sid, cand)
        ok_x = is_navigable(pack, sid, cand_x)
        ok_z = is_navigable(pack, sid, cand_z)
        p = torch.where(
            ok_full[:, None],
            cand,
            torch.where(ok_x[:, None], cand_x, torch.where(ok_z[:, None], cand_z, p)),
        )
        collided = collided | ~ok_full
    return p, collided


def distance_at(
    fields: torch.Tensor,  # (E,NX,NZ) distance fields (meters)
    field_idx: torch.Tensor,  # (N,) which field each env reads
    nav_lo: torch.Tensor,  # (N,2)
    nav_res: float,
    pos: torch.Tensor,  # (N,3)
) -> torch.Tensor:
    """Geodesic distance at world positions: min over the 4 surrounding
    cells of field + euclidean offset to that cell (robust near walls where
    bilinear interpolation against INF neighbors would poison the value)."""
    nx, nz = fields.shape[-2], fields.shape[-1]
    cf = world_to_cell_f(nav_lo, nav_res, pos[:, ::2])  # (N,2)
    c0 = torch.floor(cf).to(torch.int64)
    best = torch.full(pos.shape[:1], float(INF_DIST), device=pos.device)
    for di in (0, 1):
        for dk in (0, 1):
            ci = (c0[:, 0] + di).clamp(0, nx - 1)
            ck = (c0[:, 1] + dk).clamp(0, nz - 1)
            d = fields[field_idx, ci, ck].float()
            off = torch.sqrt((cf[:, 0] - ci.float()) ** 2 + (cf[:, 1] - ck.float()) ** 2) * nav_res
            best = torch.minimum(best, d + off)
    return best


def snap_to_navigable(
    pack: ScenePack, sid: torch.Tensor, pos: torch.Tensor, max_radius_cells: int = 10
) -> torch.Tensor:
    """Snap world points (N,3) to the nearest navigable cell centre within a
    (2w+1)^2 window around their nearest cell (PathFinder.snap_point); y is
    the scene's floor. Ties go to the first cell in row-major window order,
    as ``jnp.argmin`` takes it; a window with no navigable cell gives its
    first cell."""
    nx, nz = pack.nav_occ.shape[-2], pack.nav_occ.shape[-1]
    lo = pack.nav_lo[sid]  # (N,2)
    cf = world_to_cell_f(lo, pack.nav_res, pos[:, ::2])
    c = torch.round(cf).to(torch.int64)
    w = max_radius_cells
    off = torch.arange(-w, w + 1, device=pos.device)
    ii = (c[:, 0:1] + off).clamp(0, nx - 1)  # (N, 2w+1)
    kk = (c[:, 1:2] + off).clamp(0, nz - 1)
    window = pack.nav_occ[sid[:, None, None], ii[:, :, None], kk[:, None, :]]  # (N, 2w+1, 2w+1)
    dist2 = (ii.float() - cf[:, 0:1])[:, :, None] ** 2 + (kk.float() - cf[:, 1:2])[:, None, :] ** 2
    dist2 = torch.where(window, dist2, torch.inf)
    flat = dist2.flatten(1).argmin(1)
    bi = torch.gather(ii, 1, (flat // (2 * w + 1))[:, None])[:, 0]
    bk = torch.gather(kk, 1, (flat % (2 * w + 1))[:, None])[:, 0]
    # the cell centre index * res + lo rounded once, as the fused multiply-add
    # of XLA's compiled step computes it: in float64 the product is exact
    res = float(np.float32(pack.nav_res))
    xz = (torch.stack([bi, bk], dim=-1).double() * res + lo.double()).float()
    return torch.stack([xz[:, 0], pack.floor_y[sid], xz[:, 1]], dim=-1)


def sample_navigable_point(pack: ScenePack, sid, key, n_tries: int = 32) -> torch.Tensor:
    """A uniform navigable point of scene ``sid`` by rejection over the
    grid (PathFinder.get_random_navigable_point), JAX's draw for the same
    Threefry key: ``n_tries`` cells from ``threefry.randint`` on the host,
    the first navigable one, else the first try snapped to the nearest
    navigable cell. ``key`` is (2,) -> (3,), or (..., 2) keys -> (..., 3)
    points (``sid`` an int or broadcast over the keys); the occupancy
    lookups and the snap run on the pack's device, after one copy there
    that does not wait on the card."""
    key = np.asarray(key, np.uint32)
    lead = key.shape[:-1]
    keys = key.reshape(-1, 2)
    nx, nz = pack.nav_occ.shape[-2], pack.nav_occ.shape[-1]
    k = threefry.split(keys)  # (K, 2, 2)
    cells = np.stack([threefry.randint(k[:, 0], (n_tries,), 0, nx), threefry.randint(k[:, 1], (n_tries,), 0, nz)],
                     axis=1).astype(np.int64)  # (K, 2, n_tries)
    dev = pack.nav_lo.device
    cells = torch.from_numpy(cells).to(dev, non_blocking=True)
    sids = torch.as_tensor(sid, dtype=torch.int64).reshape(-1)
    sids = sids.to(dev, non_blocking=True).expand(keys.shape[0])
    ii, kk = cells[:, 0], cells[:, 1]
    good = pack.nav_occ[sids[:, None], ii, kk]  # (K, n_tries)
    j = good.to(torch.uint8).argmax(dim=1, keepdim=True)  # the first navigable try (0 if none)
    cell = torch.stack([ii.gather(1, j)[:, 0], kk.gather(1, j)[:, 0]], dim=-1)
    # index * res + lo rounded once, as XLA's compiled draw fuses it
    res = float(np.float32(pack.nav_res))
    xz = (cell.double() * res + pack.nav_lo[sids].double()).float()
    p = torch.stack([xz[:, 0], pack.floor_y[sids], xz[:, 1]], dim=-1)
    p = torch.where(good.any(dim=1)[:, None], p, snap_to_navigable(pack, sids, p))
    return p.reshape(lead + (3,))


# candidate headings of the greedy follower: a ring of 16, slot 0 straight ahead
FOLLOWER_DIRS = 16


def greedy_follower_step(
    pack: ScenePack,
    sid: torch.Tensor,  # (N,)
    fields: torch.Tensor,  # (E,NX,NZ) distance-to-goal fields
    field_idx: torch.Tensor,  # (N,) which field each env follows
    pos: torch.Tensor,  # (N,3)
    yaw: torch.Tensor,  # (N,)
    *,
    goal_radius: float,
    forward_step: float,
    turn_angle: float,
) -> torch.Tensor:
    """Greedy geodesic follower, batched over envs: (N,) int64 actions
    {stop=0, fwd=1, left=2, right=3} (GreedyGeodesicFollower's role).

    Each env evaluates ``FOLLOWER_DIRS`` candidate headings one
    collision-resolved step ahead (``try_step`` on all N x 16 candidates at
    once, sliding as executing the move would) and steers toward the one
    with the lowest field value; slot 0 (straight ahead) gets a bias of half
    a cell, which breaks left/right chatter at walls and doorways. Ties go
    to the first candidate. The arithmetic is the JAX package's, in float32:
    offsets i * float32(2 pi / 16), the arctan2(sin, cos) wrap, a forward
    cone of max(0.99 * turn_angle, pi / 16), stop within ``goal_radius``."""
    n, k, dev = pos.shape[0], FOLLOWER_DIRS, pos.device
    nav_lo = pack.nav_lo[sid]
    d_here = distance_at(fields, field_idx, nav_lo, pack.nav_res, pos)
    offsets = torch.arange(k, dtype=torch.float32, device=dev) * float(np.float32(2 * np.pi / k))
    cand_yaw = yaw[:, None] + offsets  # (N, 16)
    fwd = torch.stack([-torch.sin(cand_yaw), torch.zeros_like(cand_yaw), -torch.cos(cand_yaw)], dim=-1)
    start = pos[:, None, :].expand(n, k, 3)
    targets = start + fwd * forward_step
    rep = lambda x: x.repeat_interleave(k, dim=0)  # noqa: E731  (env-major, as targets flatten)
    p2, _ = try_step(pack, rep(sid), start.reshape(-1, 3), targets.reshape(-1, 3))
    d_cands = distance_at(fields, rep(field_idx), rep(nav_lo), pack.nav_res, p2).reshape(n, k)
    bias = torch.where(torch.arange(k, device=dev) == 0, float(np.float32(-0.5 * pack.nav_res)), 0.0)
    err = offsets[torch.argmin(d_cands + bias, dim=1)]
    err = torch.atan2(torch.sin(err), torch.cos(err))
    cone = float(np.float32(max(0.99 * turn_angle, np.pi / k)))
    act = torch.where(err.abs() <= cone, 1, torch.where(err > 0, 2, 3))
    return torch.where(d_here <= float(np.float32(goal_radius)), 0, act)
