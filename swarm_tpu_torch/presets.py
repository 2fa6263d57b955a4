"""The repository's preset worlds, built without jax.

Both return what `__graft_entry__._cfg_and_world(n, frontiers=...,
parity=False, raster_mode="beam", use_pallas=True, scan_rays=...,
tiled=True, room_kernel=...)` returns, for the tool that runs it:

`deployable` adds bench.py's replacements and defaults (`beam_groups`,
`kernel_endpoints=not exact_endpoints`, `beam_pack8=pack8`,
`raster_4way=(scan_rays == 0)`, `merge_every=16` when there is a sweep,
else 0, and the grid's `logodds_dtype=grid_dtype`), bench.py:114-128. Its
flags are bench.py's: `room_kernel=True` is `--room-kernel`
(`room_tile_per_row = per_row`, so the raster runs the room-tile kernel
instead of the per-agent window kernel); `frontiers=True` is `--frontiers`
(run it with `enable_targets=True`); `scan_rays=0` is `--scan-rays 0`, the
4-way ultrasonic fan alone; `pack8=False` is `--no-pack8`;
`exact_endpoints=True` is `--exact-endpoints`; `grid_dtype="bfloat16"` is
`--grid-dtype bfloat16`; `beam_groups=N` is `--beam-groups N`, the grouped
tier on every fan of more than N beams (0: per beam).
`deployable(32768, grid_dtype="bfloat16")` is the largest configuration the
repository publishes: a 23,296^2 bf16 grid, 16,384 rooms at 91 per tile
row.

`vertical_rooms` and `tile_blocks` are the sharded engine's worlds (the
reference's dryrun, __graft_entry__.py:245-343): one room per row band, or
every room tile of the grid in device-major order, with the deployable
engine.

`coverage` is the configuration of tools/bench_coverage.py: EngineConfig's
own raster defaults (`raster_4way=True`, `kernel_endpoints=False`,
`endpoint_hits=True`, `beam_pack8=False`, `beam_groups=0`), the merge off.
Its variants are wall-following (`frontiers=False`) and frontier targets
(`frontiers=True`, run with `enable_targets=True`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.config import (EngineConfig, GridConfig, SlamConfig,
                                    SwarmConfig)
from swarm_tpu_torch.engine.sim import make_agent_params
from swarm_tpu_torch.geom.world import (make_tiled_rooms,
                                        make_tiled_rooms_blocks,
                                        make_vertical_rooms, walls_by_group)


def _tiled_world(n_agents: int, device, frontiers: bool, scan_rays: int,
                 room_kernel: bool, grid_dtype: str = "float32", **engine):
    """Tiled-rooms world (two agents per room, each room on its own
    [128, 256]-cell grid tile) + config with the given engine fields."""
    n_rooms = max(1, n_agents // 2)
    per_row = max(1, round(math.sqrt(n_rooms / 2.0)))
    n_rows = math.ceil(n_rooms / per_row)
    size = max(per_row * 256, n_rows * 128)
    size = -(-size // 256) * 256
    walls, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    return _rooms_world(
        walls, origins, size, n_agents, device, frontiers, scan_rays,
        grid_dtype, room_tile_per_row=per_row if room_kernel else 0,
        **engine)


def _rooms_world(walls, origins, size: int, n_agents: int, device,
                 frontiers: bool, scan_rays: int, grid_dtype: str = "float32",
                 **engine):
    """Config, walls, params and rooms of a world of rooms `walls` [4R, 4]
    with origins [R, 2] on a [size, size] grid at origin (0, 0): agents 2k
    and 2k+1 in room k, at the reference's home offsets."""
    device = default_device(device)
    cfg = SwarmConfig(
        n_agents=n_agents,
        grid=GridConfig(size=size, origin_x=0.0, origin_y=0.0,
                        logodds_dtype=grid_dtype),
        engine=EngineConfig(
            parity_mode=False, compute_frontiers=frontiers,
            raster_mode="beam", use_pallas=True, scan_rays=scan_rays,
            **engine),
        # same-agent closures, anchor map, no closure snap, frame tracker on
        # (the reference preset's settings and reasons,
        # __graft_entry__.py:65-91)
        slam=SlamConfig(closure_same_agent_only=True, merge_anchor=True,
                        closure_correction=0.0, merge_frame_gain=0.35))
    params = make_agent_params(n_agents, separation=2.0, device=device)
    i = np.arange(n_agents)
    room = i // 2
    is_b2 = (i % 2) == 1
    home_x = origins[room, 0] + np.where(is_b2, 5.5, 0.5)
    home_y = origins[room, 1] + np.where(is_b2, 3.5, 0.5)
    params = params._replace(
        home_x=torch.tensor(home_x, dtype=torch.float32, device=device),
        home_y=torch.tensor(home_y, dtype=torch.float32, device=device),
        x_offset=torch.zeros((n_agents,), dtype=torch.float32,
                             device=device))
    rooms = (torch.tensor(walls_by_group(walls), device=device),
             torch.tensor(room, dtype=torch.int32, device=device))
    return cfg, torch.tensor(walls, device=device), params, rooms


def deployable(n_agents: int, device=None, merge_every: int = 16,
               room_kernel: bool = False, frontiers: bool = False,
               scan_rays: int = 181, pack8: bool = True,
               exact_endpoints: bool = False, grid_dtype: str = "float32",
               beam_groups: int = 0):
    """bench.py's world + config for an n-agent swarm. Returns (cfg, walls
    [S, 4], params, (walls_grouped [G, 4, 4], room_of_agent [N] int32)),
    tensors on `device` (the card when None). At 1024 agents: a 4096^2
    grid, 512 rooms (2048 wall segments), 181-beam sweeps. Without a sweep
    (`scan_rays=0`) the merge is off, as bench.py sets it."""
    return _tiled_world(
        n_agents, device, frontiers, scan_rays, room_kernel, grid_dtype,
        beam_groups=beam_groups, kernel_endpoints=not exact_endpoints,
        beam_pack8=pack8, raster_4way=scan_rays == 0,
        merge_every=merge_every if scan_rays > 0 else 0)


def coverage(n_agents: int, frontiers: bool = True, device=None):
    """tools/bench_coverage.py's world + config (the exploration path):
    the same tiled world, EngineConfig's raster defaults (the wrapped 4-way
    fan and the 181-beam sweep, each through the pack16 window table
    without the endpoint ring, then the exact endpoint scatter), the merge
    off, frontiers at the 3 s cadence when `frontiers`. Returns what
    `deployable` returns. At 64 agents: a 1024^2 grid; at 1024: 4096^2."""
    return _tiled_world(n_agents, device, frontiers, 181, False)


def _sharded_engine(merge_every: int):
    """The deployable engine fields (bench.py's defaults) for a sharded
    world: pack8 table (the sharded body runs pack16 whatever it says), the
    endpoint ring, the 181-beam sweep, the merge every `merge_every`."""
    return dict(beam_groups=0, kernel_endpoints=True, beam_pack8=True,
                raster_4way=False, merge_every=merge_every)


def vertical_rooms(n_rooms: int, device=None, merge_every: int = 16):
    """The "rows" decomposition's world (geom/world.make_vertical_rooms):
    one room per 128-row band, two agents per room, the deployable engine.
    Returns what `deployable` returns; n_rooms ranks own a band each."""
    walls, origins, size = make_vertical_rooms(n_rooms)
    return _rooms_world(walls, origins, size, 2 * n_rooms, device, False,
                        181, **_sharded_engine(merge_every))


def tile_blocks(dev_rows: int, dev_cols: int, size: int, device=None,
                merge_every: int = 16):
    """The "tiles" decomposition's world (geom/world.
    make_tiled_rooms_blocks): every room tile of a [size, size] grid, rooms
    in device-major order over a dev_rows x dev_cols rank grid, two agents
    per room, the deployable engine. Returns what `deployable` returns."""
    walls, origins = make_tiled_rooms_blocks(dev_rows, dev_cols, size)
    return _rooms_world(walls, origins, size, 2 * origins.shape[0], device,
                        False, 181, **_sharded_engine(merge_every))
