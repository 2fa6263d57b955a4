"""Rank layout of the sharded swarm engine (swarm_tpu/parallel/mesh.py).

The reference scales out with a `jax.sharding.Mesh` over an `agents` axis
(a 2-D `(rows, cols)` mesh for the tile decomposition). The port runs one
process per device over `torch.distributed`: a `RankLayout` says how many
ranks there are, which one this process is, how they tile the grid for the
"tiles" decomposition, and on which device this rank's state lives. The
collectives go through the default process group, which `init` starts:
NCCL on the card, gloo on the CPU, never one for the other. A one-rank
group still goes through `torch.distributed`.

On a host with N cards: `torchrun --nproc-per-node N -m
swarm_tpu_torch.parallel.dryrun` (`torchrun` sets `LOCAL_RANK`, whose card
the rank takes).
"""

from __future__ import annotations

import inspect
import os
import socket
from datetime import timedelta
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class RankLayout(NamedTuple):
    """This process's place in the sharded engine: `world` ranks, this one
    `rank`, laid out row-major on a `rows` x `cols` grid of ranks (the
    "tiles" decomposition's (R, C); (world, 1) otherwise), its state on
    `device`."""
    world: int
    rank: int
    rows: int
    cols: int
    device: torch.device

    @property
    def tile(self) -> Tuple[int, int]:
        """(tile row, tile column) of this rank on the rank grid."""
        return divmod(self.rank, self.cols)


def local_device(device=None) -> torch.device:
    """The rank's device: `device` when named, else `cuda:LOCAL_RANK` (0
    when the launcher sets none)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(init_method: str, world_size: int, rank: int, timeout: timedelta,
         device=None) -> torch.device:
    """Start the default process group for this rank and return its
    device: NCCL when the device is a card, gloo when it is the CPU. A
    collective that waits longer than `timeout` fails instead of hanging.
    A failed start raises; there is no other backend to fall back to."""
    device = local_device(device)
    kw = {}
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(device)
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = device      # start NCCL now, not lazily
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)
    return device


def make_layout(grid: Optional[Tuple[int, int]] = None,
                device=None) -> RankLayout:
    """The layout of this rank in the initialised default group. `grid`:
    the (R, C) rank grid of the "tiles" decomposition, R * C = world size
    ((world, 1) when None)."""
    if not dist.is_initialized():
        raise RuntimeError("make_layout needs an initialised process group "
                           "(parallel.mesh.init)")
    world, rank = dist.get_world_size(), dist.get_rank()
    r, c = (world, 1) if grid is None else grid
    if r * c != world:
        raise ValueError(f"rank grid {r}x{c} does not cover {world} ranks")
    return RankLayout(world=world, rank=rank, rows=r, cols=c,
                      device=local_device(device))
