"""The repository's preset worlds, built without jax.

`deployable`, `coverage`, `vertical_rooms` and `tile_blocks` return what `__graft_entry__._cfg_and_world(n, frontiers=...,
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

`accuracy` is tools/bench_accuracy.py's configuration: the coverage
world and EngineConfig's raster defaults without frontiers, and one of the
tool's four variants (`raw`, `ref_closures`, `merge_anchored`,
`ref_closures+merge`) on top.

`untiled`, `swarm` and `dual_bot` are the untiled worlds: the bedroom
(`BEDROOM_WALLS`) tiled into a grid of rooms 2 m apart (`make_multi_room`,
grid origin (-3, -4)), or the bedroom alone. `untiled` is bench.py's
`--raster line` and `--no-pallas` rows (`_cfg_and_world(n, tiled=False,
use_pallas=False, ...)`, bench.py:105-128: the beam fields at
EngineConfig's defaults, so both beam fans run through the XLA tier);
`swarm` is `run_session --preset swarm` and `__graft_entry__.entry()`
(line raster, no sweep); `dual_bot` is `run_session --preset dual_bot`, the
reference's two-robot session in the default parity mode. Each returns
what `deployable` returns (`dual_bot`'s rooms are (None, None)).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.config import (EngineConfig, GridConfig, SlamConfig,
                                    SwarmConfig)
from swarm_tpu_torch.engine.sim import make_agent_params
from swarm_tpu_torch.geom.world import (BEDROOM_WALLS, make_multi_room,
                                        make_tiled_rooms,
                                        make_tiled_rooms_blocks,
                                        make_vertical_rooms, walls_by_group)


def tile_rooms_per_row(n_agents: int) -> int:
    """Rooms to a tile row of the tiled world of n agents (two to a room):
    the room kernel's `per_row`."""
    return max(1, round(math.sqrt(max(1, n_agents // 2) / 2.0)))


def _tiled_world(n_agents: int, device, frontiers: bool, scan_rays: int,
                 room_kernel: bool, grid_dtype: str = "float32", **engine):
    """Tiled-rooms world (two agents per room, each room on its own
    [128, 256]-cell grid tile) + config with the given engine fields."""
    n_rooms = max(1, n_agents // 2)
    per_row = tile_rooms_per_row(n_agents)
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


def coverage(n_agents: int, frontiers: bool = True, device=None,
             scan_rays: int = 181):
    """tools/bench_coverage.py's world + config (the exploration path):
    the same tiled world, EngineConfig's raster defaults (the wrapped 4-way
    fan and the 181-beam sweep, each through the pack16 window table
    without the endpoint ring, then the exact endpoint scatter), the merge
    off, frontiers at the 3 s cadence when `frontiers`. Returns what
    `deployable` returns. At 64 agents: a 1024^2 grid; at 1024: 4096^2.
    `scan_rays=61` at 4 agents is tools/quality_onchip.py's world."""
    return _tiled_world(n_agents, device, frontiers, scan_rays, False)


ACCURACY_VARIANTS = ("raw", "ref_closures", "merge_anchored",
                     "ref_closures+merge")


def accuracy(n_agents: int, variant: str, device=None, pair_budget: int = 8,
             distinct: float = 0.0, log_distinct: float = 0.0):
    """tools/bench_accuracy.py's world + config for one of its variants
    (`ACCURACY_VARIANTS`): `_cfg_and_world(n, frontiers=False,
    parity=False, raster_mode="beam", use_pallas=True, scan_rays=181,
    tiled=True)` (the tool asks for the accelerator tier on the
    accelerator, :259-262; both fans run through the window kernel's
    pack16 forms, then the endpoint scatter), with the variant's SLAM and
    engine replacements copied from the tool (:267-316):
      raw — no pose corrections, scan-matched closure edges at a
        per-agent revisit gap (100 * n nodes), the rendezvous radius
        1.2 m, a +-28-cell closure search and `pair_budget` proximity
        pairs per step; no merge;
      ref_closures — the reference's damped landmark snap (0.5), no merge;
      merge_anchored — the raw variant's closure detection plus the
        anchored merge every 16 steps, with the tracker's distinctness
        margin `distinct` and the logged fixes' `log_distinct`;
      ref_closures+merge — the snap and the merge.
    Returns what `deployable` returns. At 64 agents: a 1024^2 grid, 32
    rooms at 4 to a row."""
    if variant not in ACCURACY_VARIANTS:
        raise ValueError(f"unknown accuracy variant {variant!r}")
    cfg, walls, params, rooms = _tiled_world(n_agents, device, False, 181,
                                             False)
    measured = dict(closure_correction=0.0,
                    min_poses_between=100 * n_agents,
                    closure_scanmatch=True, closure_cross_radius_m=1.2,
                    closure_match_search=28,
                    closure_pair_budget=pair_budget)
    slam, merge_every = {
        "raw": (measured, 0),
        "ref_closures": (dict(closure_correction=0.5), 0),
        "merge_anchored": (dict(measured,
                                merge_distinct_margin=distinct,
                                merge_distinct_log_margin=log_distinct), 16),
        "ref_closures+merge": (dict(closure_correction=0.5), 16),
    }[variant]
    cfg = cfg.replace(
        slam=dataclasses.replace(cfg.slam, **slam),
        engine=dataclasses.replace(cfg.engine, merge_every=merge_every))
    return cfg, walls, params, rooms


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


def _untiled_world(n_agents: int, device, frontiers: bool, raster_mode: str,
                   scan_rays: int, grid_dtype: str = "float32",
                   merge_every: int = 0):
    """The untiled branch of `__graft_entry__._cfg_and_world` with
    use_pallas=False: ceil(sqrt(R)) rooms to a row (R = n_agents / 2), the
    grid covering them plus 4 m in 256-cell steps, origin (-3, -4), agents
    2k and 2k+1 both at room k's home (its bedroom's origin), the preset's
    SLAM settings; the merge every `merge_every` steps with a sweep."""
    device = default_device(device)
    n_rooms = max(1, n_agents // 2)
    per_row = max(1, math.ceil(math.sqrt(n_rooms)))
    n_rows = math.ceil(n_rooms / per_row)
    extent = max(per_row * 8.0, n_rows * 6.0) + 4.0
    size = math.ceil(extent / 0.05 / 256) * 256
    walls = make_multi_room(n_rooms, per_row=per_row)
    cfg = SwarmConfig(
        n_agents=n_agents,
        grid=GridConfig(size=size, origin_x=-3.0, origin_y=-4.0,
                        logodds_dtype=grid_dtype),
        engine=EngineConfig(
            parity_mode=False, compute_frontiers=frontiers,
            raster_mode=raster_mode, use_pallas=False, scan_rays=scan_rays,
            room_tile_per_row=0,
            merge_every=merge_every if scan_rays > 0 else 0),
        # the reference preset's SLAM settings (__graft_entry__.py:65-91)
        slam=SlamConfig(closure_same_agent_only=True, merge_anchor=True,
                        closure_correction=0.0, merge_frame_gain=0.35))
    params = make_agent_params(n_agents, separation=2.0, device=device)
    room = np.arange(n_agents) // 2
    params = params._replace(
        home_x=torch.tensor((room % per_row) * 8.0, dtype=torch.float32,
                            device=device),
        home_y=torch.tensor((room // per_row) * 6.0, dtype=torch.float32,
                            device=device),
        x_offset=torch.zeros((n_agents,), dtype=torch.float32,
                             device=device))
    rooms = (torch.tensor(walls_by_group(walls), device=device),
             torch.tensor(room, dtype=torch.int32, device=device))
    return cfg, torch.tensor(walls, device=device), params, rooms


def untiled(n_agents: int, raster_mode: str = "line", scan_rays: int = 181,
            frontiers: bool = False, merge_every: int = 16,
            grid_dtype: str = "float32", device=None):
    """bench.py's untiled rows: `--raster line` (raster_mode="line", the
    line raster of every ultrasonic and sweep ray) and `--no-pallas`
    (raster_mode="beam": both beam fans through the XLA tier; with
    grid_dtype="bfloat16" on a bf16 grid), each with bench.py's
    `--scan-rays`, `--frontiers` and `--merge-every` (the merge only with a
    sweep). raster_mode="off" is the profiling mode on the same world.
    Returns what `deployable` returns, on `device` (the card when None).
    At 1024 agents: a 3840^2 grid, 512 rooms at 23 to a row (188 m)."""
    return _untiled_world(n_agents, device, frontiers, raster_mode,
                          scan_rays, grid_dtype, merge_every)


def swarm(n_agents: int, device=None):
    """`run_session --preset swarm` (and, at 64 agents,
    `__graft_entry__.entry()`): `_cfg_and_world(n, frontiers=False,
    parity=False)` with its defaults, the line raster of the 4-way
    ultrasonics on the untiled world, no sweep, no merge. Returns what
    `deployable` returns."""
    return _untiled_world(n_agents, device, False, "line", 0)


def dual_bot(separation: float = 5.0, frontiers: bool = True, device=None):
    """`run_session --preset dual_bot`: the reference's two-robot session,
    EngineConfig's defaults (the parity mode: the line raster into the
    int8 tri-state grid, the sequential closure; no sweep, no merge) on the
    bedroom and its 200^2 grid, Bot2 `separation` metres along x in the
    server frame. Returns (cfg, walls [4, 4], params, (None, None))."""
    device = default_device(device)
    cfg = SwarmConfig(n_agents=2,
                      engine=EngineConfig(compute_frontiers=frontiers))
    params = make_agent_params(2, separation=separation, device=device)
    return cfg, torch.tensor(BEDROOM_WALLS, device=device), params, \
        (None, None)
