"""Navigation-grid queries on tensors, batched over envs (port of
``habitat_tpu/ops/navgrid.py``): navigability tests, sliding collision for
agent motion, geodesic-distance lookups on precomputed fields."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from habitat_torch.sims.scene import INF_DIST, ScenePack


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
    cf = world_to_cell_f(pack.nav_lo[sid], pack.nav_res, pos[..., [0, 2]])
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
    dx = delta * torch.tensor([1.0, 0.0, 0.0], device=pos.device)
    dz = delta * torch.tensor([0.0, 0.0, 1.0], device=pos.device)
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
    cf = world_to_cell_f(nav_lo, nav_res, pos[:, [0, 2]])  # (N,2)
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
