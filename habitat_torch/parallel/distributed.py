"""DD-PPO's process group (port of ``habitat_tpu/parallel/mesh.py``).

The JAX package runs DD-PPO as one SPMD program over a ``data`` mesh: env
state sharded over devices, parameters replicated, the gradient all-reduce
inserted by XLA. The port runs W processes, one per card (reference
rl/ddppo/ddp_utils.py): rank r builds its env from rows ``env_rows(N)`` of
the global episode order (what ``mesh.global_env_pytree`` does), every rank
holds the same parameters and the same generator, and the learner sums
gradients, loss terms and rollout statistics across ranks with the helpers
below. The rows are decided once, where the env and the learner are built
(``core/construct.py::trainer_from_config``), and handed to both.

``init_distributed`` forms the group (reference init_distrib_slurm,
ddp_utils.py:271): explicit arguments first, else the variables torchrun
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``,
``SLURM_LOCALID``; address and port from ``MASTER_ADDR`` / ``MASTER_PORT``
or 127.0.0.1:8738). A single process with none of them set is left alone.
NCCL serves ``cuda`` devices, gloo the CPU; a rank's card is
``cuda:LOCAL_RANK``. Every collective times out after ``timeout_s``, so a
rank that dies cannot block the others for good; ``abort`` drops the group
at once on the rank that failed.

``habitat_tpu/parallel/compile_opts.py`` (XLA TPU compiler flags) has no
counterpart.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from habitat_torch.device import resolve_device

# a collective that waits longer than this raises (reference DDP timeout)
DEFAULT_TIMEOUT_S = 600.0
SLURM_DEFAULT_PORT = 8738


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the group: ``active`` once a group is up
    (then every collective below runs, also at size 1)."""

    rank: int = 0
    size: int = 1
    active: bool = False


def world() -> World:
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size(), True)
    return World()


def rank0_only() -> bool:
    """reference ddp_utils.py:100."""
    return world().rank == 0


@dataclasses.dataclass(frozen=True)
class EnvRows:
    """Rows ``[start, stop)`` of the global env axis of ``n_global`` envs:
    the envs one rank builds and trains on."""

    start: int
    stop: int
    n_global: int

    @classmethod
    def all(cls, n: int) -> "EnvRows":
        return cls(0, n, n)

    @property
    def slice(self) -> slice:
        return slice(self.start, self.stop)


def env_rows(n_global: int) -> EnvRows:
    """This rank's rows ``[r*n, (r+1)*n)`` of the global env axis, n =
    n_global / W (all of them without a group)."""
    w = world()
    if n_global % w.size:
        raise ValueError(f"{n_global} envs do not split over {w.size} ranks")
    n = n_global // w.size
    return EnvRows(w.rank * n, (w.rank + 1) * n, n_global)


def _from_environment() -> Optional[Dict[str, Union[str, int]]]:
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:  # torchrun
        return dict(init_method="env://", world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]),
                    local_rank=int(env.get("LOCAL_RANK", 0)))
    if int(env.get("SLURM_NTASKS", "1")) > 1 and "SLURM_PROCID" in env:
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        port = int(env.get("MASTER_PORT", SLURM_DEFAULT_PORT))
        return dict(init_method=f"tcp://{addr}:{port}", world_size=int(env["SLURM_NTASKS"]),
                    rank=int(env["SLURM_PROCID"]), local_rank=int(env.get("SLURM_LOCALID", 0)))
    return None


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Form the process group and return this rank's device.

    With ``init_method`` (``file://...`` or ``tcp://host:port``),
    ``world_size`` and ``rank`` the group is formed from them; without, from
    torchrun's or SLURM's variables; with neither, nothing is formed. An
    existing group is kept. ``device`` ``None`` is the rank's card:
    ``cuda:LOCAL_RANK`` (``SLURM_LOCALID``) from the launcher, ``cuda:0``
    with explicit arguments; ``backend`` ``None`` is NCCL for a card and gloo
    for the CPU (gloo also all-reduces card tensors, through the host).
    Without a group, ``device`` resolves as everywhere (``None`` = cuda)."""
    if init_method is not None:
        spec = dict(init_method=init_method, world_size=int(world_size), rank=int(rank), local_rank=0)
    else:
        spec = _from_environment()
    if spec is None:
        return resolve_device(device)
    dev = resolve_device(device if device is not None else f"cuda:{spec['local_rank']}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", spec["local_rank"])
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=spec["init_method"],
        world_size=spec["world_size"], rank=spec["rank"], timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


def abort() -> None:
    """Drop the group at once (a rank that failed calls this, so that the
    others' pending collectives fail instead of waiting out the timeout)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- collectives (no-ops without a group) ---------------------------------


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, with one collective over a
    flat float32 buffer; every rank receives the same bits."""
    if not world().active or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite each tensor with rank 0's, in place."""
    if not world().active:
        return
    for t in tensors:
        dist.broadcast(t, 0)


def any_rank(flag: bool, device) -> bool:
    """True on every rank if ``flag`` is True on any."""
    if not world().active:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' (n, ...) slices of an env-sharded tensor joined into the
    global (W*n, ...) one, on every rank."""
    w = world()
    if not w.active or w.size == 1:
        return t
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(w.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(t.dtype)
