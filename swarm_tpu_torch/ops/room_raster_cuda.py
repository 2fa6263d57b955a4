"""The room-tile beam raster: a CUDA kernel for Hopper and its plain torch
version.

Replaces `swarm_tpu/ops/beam_raster_pallas.py::_room_kernel` (entry point
`room_raster_pallas`) in every form that `bench.py --room-kernel` reaches,
per-beam (`n_groups == n_beams`) and grouped (`n_groups < n_beams`,
`--beam-groups N`):
- the table: per beam pack16 (two beams per int32 word, padded to a
  multiple of 8 words; the engine passes this kernel no `pack8`,
  swarm_tpu/engine/sim.py:591-597, so the room path uses pack16 even where
  `EngineConfig.beam_pack8` is True; the port keeps that), or grouped (per
  group the carve, the trusted fraction and the tail range as float32s,
  `[BR, BC, 2, G_pad, 3]` with G_pad = round_up(G, 8), as
  room_raster_pallas scatters it);
- the in-kernel endpoint ring (`trusted` given: 15-bit 1/256-cell ranges +
  trusted bit 15, or the group's trusted fraction) or none (`trusted=None`,
  `--exact-endpoints`: 16-bit ranges, the endpoints scattered exactly after
  the kernel);
- the weak tail (grouped only, `tail_weight > 0`);
- the fan: the 181-beam scan or the wrapped 4-way fan (`--scan-rays 0`).
The grid is float32. A bfloat16 grid is refused with a ValueError, as the
reference's `sim_init` refuses it for the room kernel
(swarm_tpu/engine/sim.py:310-315).

The world is tiled rooms (`geom.world.make_tiled_rooms`): agents 2k and
2k+1 live in room k = grid tile (k // per_row, k % per_row) of [128, 256]
cells; a room off the tile grid is dropped with its agents, as the
reference's scatter drops it (ROADMAP C11). Each agent paints a win_rows x
256 window of its own tile only (win_rows = round_up(2 reach + 8, 8) = 64
at the 1.2 m reach), from the tile-local row r_loc of its aligned window
origin clipped into the tile; evidence that would fall outside the tile
is dropped, as on the TPU. Slot 0 then slot 1, each clipped to [-clamp,
clamp]; every slot of every tile is applied, an empty one with act 0. The
counter is one painted total per tile, [BR, BC] (the engine rounds it per
tile before its int32 sum).

What bounds it on the H100: at 1024 agents the windows cover 1024 x 64 x
256 cells, each read and written once (134 MB, ~40 us at 3.35 TB/s); the
evaluated cells' arithmetic is a long dependent chain. The design
(csrc/room_raster.cu): one block per tile, slot 0 then slot 1 in place
with a barrier between, each slot evaluating only its evaluation box
(`beam_raster_cuda.evaluation_box`) and giving the rest of its window the
+0.0 delta's clip in a cheap pass that writes only cells it changes; the
tables in shared memory.

`room_raster` dispatches on where the grid lies: a CPU tensor goes to
`room_raster_plain`; a CUDA tensor launches the kernel or raises.
`room_raster.launches` counts kernel launches and nothing else;
`room_raster.launches_by_form` splits that count by table, ring and fan
(`form_name`: `pack16-ring`, `pack16`, `grouped-ring`, `grouped`, each
with `-wrapped` on the 4-way fan).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from swarm_tpu_torch import trace
from swarm_tpu_torch._device import recip32
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.geom.world import TILE_COLS, TILE_ROWS
from swarm_tpu_torch.ops import cuda_build
from swarm_tpu_torch.ops.beam_raster import (REACH_CELLS, BeamSpec,
                                             _pack_range16, _unpack_range16,
                                             patch_origin)
from swarm_tpu_torch.ops.beam_raster_cuda import (_constants, _dense_fan,
                                                  _evidence, _lookup, _polar,
                                                  cells_of, grouped_table,
                                                  table_kind)

AGENTS_PER_ROOM = 2    # csrc SLOTS
META = 8               # csrc META: ax, ay, yaw, act, r_loc, 0, 0, 0
MAX_WORDS = 128        # csrc MAX_WORDS: pack16 tables up to 256 beams
MAX_GROUPS = 512       # csrc MAX_GROUPS: grouped tables up to 512 groups

_SOURCE = cuda_build.source("room_raster")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _Rooms(NamedTuple):
    """Per-tile launch data, as room_raster_pallas scatters it."""
    meta: torch.Tensor    # [BR, BC, 2, 8] f32
    table: torch.Tensor   # [BR, BC, 2, tab_rows] int32 pack16 words, or
    #                       [BR, BC, 2, G_pad, 3] f32 grouped
    win_rows: int
    ring: bool            # the table carries the trust; the ring runs
    kind: str             # "pack16" or "grouped"
    n_bins: int           # beams, or groups in the grouped tier
    tail_weight: float    # the grouped tier's weak tail; 0 per beam


def _check_supported(logodds, spec: BeamSpec, n_groups: int, reach: int):
    if min(n_groups, spec.n_beams) < spec.n_beams and n_groups > MAX_GROUPS:
        raise ValueError(f"{n_groups} beam groups exceed the kernel's "
                         f"{MAX_GROUPS}-group table")
    if logodds.dtype != torch.float32:
        # the reference's sim_init refuses a bf16 grid with the room kernel
        # (swarm_tpu/engine/sim.py:310-315); the port follows it
        raise ValueError(
            "logodds_dtype=bfloat16 is supported by the fused beam tiers "
            "(window kernel + XLA reference) only: the room kernel takes a "
            f"float32 grid, got {logodds.dtype}")
    if min(n_groups, spec.n_beams) == spec.n_beams and \
            -(-spec.n_beams // 2) > MAX_WORDS:
        raise ValueError(f"{spec.n_beams} beams exceed the kernel's "
                         f"{2 * MAX_WORDS}-beam table")
    if 2 * reach + 8 > TILE_ROWS:
        raise ValueError(
            f"beam reach {reach} cells does not fit a {TILE_ROWS}-row tile "
            "window; use the per-agent window kernel (free_raster) or a "
            "coarser grid")
    size = logodds.shape[0]
    if logodds.shape != (size, size) or size % TILE_COLS or size % TILE_ROWS:
        raise ValueError(f"grid must be square with a side divisible by "
                         f"{TILE_COLS}, got {tuple(logodds.shape)}")


def _rooms(logodds, agent_xy, yaw, dist_m, active, spec: BeamSpec,
           cfg: GridConfig, per_row, trusted, reach: int, n_groups=None,
           tail_weight: float = 0.25) -> _Rooms:
    n = agent_xy.shape[0]
    size = logodds.shape[0]
    dev = logodds.device
    br_n, bc_n = size // TILE_ROWS, size // TILE_COLS
    per_row = bc_n if per_row is None else per_row
    n_rooms = -(-n // AGENTS_PER_ROOM)
    i = torch.arange(n, device=dev)
    if per_row > bc_n or (n_rooms > 0 and (n_rooms - 1) // per_row >= br_n):
        # room_raster_pallas's scatter drops the agents of a room off the
        # tile grid (ROADMAP C11); the room of an agent is its index over
        # two, so the kept agents are known on the host
        rooms = [k // AGENTS_PER_ROOM for k in range(n)]
        i = torch.tensor([k for k, r in enumerate(rooms)
                          if r % per_row < bc_n and r // per_row < br_n],
                         dtype=torch.int64, device=dev)
        agent_xy, yaw, dist_m, active = (agent_xy[i], yaw[i], dist_m[i],
                                         active[i])
        trusted = None if trusted is None else trusted[i]
    room = torch.div(i, AGENTS_PER_ROOM, rounding_mode="floor")
    tile_r = torch.div(room, per_row, rounding_mode="floor")
    tile_c = room % per_row
    ax, ay = cells_of(agent_xy, cfg)
    cells = (dist_m * recip32(cfg.resolution)).to(torch.float32)
    kind = table_kind(spec, False, n_groups)
    if kind == "grouped":
        n_bins = min(n_groups, spec.n_beams)
        words = grouped_table(cells, trusted, spec, n_bins)
    else:
        # the per-beam carve is exact: no tail, as the reference
        n_bins, tail_weight = cells.shape[1], 0.0
        words = _pack_range16(cells, trusted)
    tab_rows = _round_up(words.shape[1], 8)

    slot = i % AGENTS_PER_ROOM
    win_rows = min(_round_up(2 * reach + 8, 8), TILE_ROWS)
    row0_g, _ = patch_origin(ax, ay, size, win_rows, size, reach)
    r_loc = torch.clamp(row0_g - tile_r.to(torch.int32) * TILE_ROWS, 0,
                        TILE_ROWS - win_rows).to(torch.float32)

    z = torch.zeros_like(ax)
    vals = torch.stack([ax, ay, yaw.to(torch.float32),
                        active.to(torch.float32), r_loc, z, z, z], dim=-1)
    meta = torch.zeros((br_n, bc_n, AGENTS_PER_ROOM, META),
                       dtype=torch.float32, device=dev)
    meta[tile_r, tile_c, slot] = vals
    table = torch.zeros((br_n, bc_n, AGENTS_PER_ROOM, tab_rows) +
                        tuple(words.shape[2:]), dtype=words.dtype, device=dev)
    table[tile_r, tile_c, slot, :words.shape[1]] = words
    return _Rooms(meta=meta, table=table, win_rows=win_rows,
                  ring=trusted is not None, kind=kind, n_bins=n_bins,
                  tail_weight=float(tail_weight))


def form_name(spec: BeamSpec, ring: bool, grouped: bool = False) -> str:
    """The launch-count key of a room form: `pack16` (or `grouped`),
    `-ring` with the endpoint ring, `-wrapped` on the 4-way fan."""
    return ("grouped" if grouped else "pack16") + \
        ("-ring" if ring else "") + ("-wrapped" if spec.wrap else "")


# --------------------------------------------------------------------------
# plain torch version


def _room_deltas(rm: _Rooms, spec: BeamSpec, cfg: GridConfig, dense: bool):
    """Evidence delta [BR, BC, 2, win_rows, 256] (before the act multiply)
    and painted count [BR, BC, 2] float64 of every slot's window — the
    kernel's per-cell math, op for op, and its exact sum in double."""
    k = _constants(spec, cfg, rm.n_bins, rm.tail_weight)
    br_n, bc_n = rm.meta.shape[:2]
    dev = rm.meta.device
    i32 = torch.int32

    def m(j):
        return rm.meta[..., j][..., None, None]

    br = torch.arange(br_n, dtype=i32, device=dev)[:, None, None, None, None]
    bc = torch.arange(bc_n, dtype=i32, device=dev)[None, :, None, None, None]
    rr = torch.arange(rm.win_rows, dtype=i32, device=dev)[:, None]
    cc = torch.arange(TILE_COLS, dtype=i32, device=dev)[None, :]
    cy = (br * TILE_ROWS + m(4).to(i32) + rr).to(torch.float32) + 0.5
    cx = (bc * TILE_COLS + cc).to(torch.float32) + 0.5
    r, cnt, g, base_ok = _polar(cx - m(0), cy - m(1), m(2), k, dense)
    tab = rm.table.reshape(br_n * bc_n * AGENTS_PER_ROOM, -1)
    rb, tf, rt = _lookup(tab, g, rm.kind, rm.ring)
    delta, painted = _evidence(r, cnt, base_ok, rb, tf, rt, k, rm.ring)
    return delta, painted.to(torch.float64).sum(dim=(-2, -1))


def room_raster_plain(logodds, agent_xy, yaw, dist_m, active,
                      spec: BeamSpec, cfg: GridConfig = GridConfig(),
                      n_groups: int = 16, per_row=None, trusted=None,
                      reach: int = REACH_CELLS, tail_weight: float = 0.25):
    """The room raster in plain torch: deltas vectorised over every (tile,
    slot) window, then applied slot 0 then slot 1, each clipped. Updates
    `logodds` IN PLACE and returns (logodds, counts [BR, BC] f32)."""
    _check_supported(logodds, spec, n_groups, reach)
    rm = _rooms(logodds, agent_xy, yaw, dist_m, active, spec, cfg, per_row,
                trusted, reach, n_groups, tail_weight)
    delta, painted = _room_deltas(rm, spec, cfg, _dense_fan(spec, reach))
    br_n, bc_n = rm.meta.shape[:2]
    dev = logodds.device
    act = rm.meta[..., 3]
    r_loc = rm.meta[..., 4].to(torch.int64)
    g4 = logodds.view(br_n, TILE_ROWS, bc_n, TILE_COLS)
    bi = torch.arange(br_n, device=dev)[:, None, None]
    ci = torch.arange(bc_n, device=dev)[None, :, None]
    rr = torch.arange(rm.win_rows, device=dev)
    c = cfg.logodds_clamp
    for s in range(AGENTS_PER_ROOM):
        rows = r_loc[:, :, s, None] + rr
        blk = g4[bi, rows, ci]
        g4[bi, rows, ci] = torch.clamp(
            blk + delta[:, :, s] * act[:, :, s, None, None], -c, c)
    counts = painted[..., 0] * act[..., 0] + painted[..., 1] * act[..., 1]
    return logodds, counts.to(torch.float32)


# --------------------------------------------------------------------------
# CUDA kernel


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.room_raster_launch.argtypes = [P] * 4 + [I] * 8 + [F] * 13 + [P]
    lib.room_raster_launch.restype = I
    lib.room_raster_blocks_per_sm.argtypes = [I, I, ctypes.POINTER(I)]
    lib.room_raster_blocks_per_sm.restype = I


def blocks_per_sm(grouped: bool, ring: bool) -> int:
    """Resident blocks per SM of the kernel instance of (table, ring), from
    CUDA's occupancy calculator (builds the kernel; needs a card)."""
    out = ctypes.c_int(0)
    err = cuda_build.load("room_raster", _bind).room_raster_blocks_per_sm(
        int(grouped), int(ring), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"room_raster occupancy query failed: CUDA error "
                           f"{err}")
    return out.value


def _launch(logodds, rm: _Rooms, spec: BeamSpec, cfg: GridConfig,
            dense: bool):
    if not logodds.is_contiguous():
        raise ValueError("the room kernel updates a contiguous grid")
    meta, table = rm.meta.contiguous(), rm.table.contiguous()
    if {meta.device, table.device} != {logodds.device}:
        raise ValueError("the agents' inputs and the grid must lie on one "
                         "device: the kernel reads them all")
    br_n, bc_n = meta.shape[:2]
    counts = torch.empty((br_n, bc_n), dtype=torch.float32,
                         device=logodds.device)
    grouped = rm.kind == "grouped"
    if grouped:
        # the float32 triples go in as their bits: the kernel loads every
        # table as 32-bit words
        table = table.view(torch.int32)
    c = _constants(spec, cfg, rm.n_bins, rm.tail_weight)
    lib = cuda_build.load("room_raster", _bind)
    stream = torch.cuda.current_stream(logodds.device).cuda_stream
    with trace.span("swarm.raster.launch"):
        err = lib.room_raster_launch(
            logodds.data_ptr(), meta.data_ptr(), table.data_ptr(),
            counts.data_ptr(), logodds.shape[0], rm.win_rows,
            table[0, 0, 0].numel(), int(grouped), int(rm.ring), rm.n_bins,
            int(dense), int(spec.wrap), c["theta0"], c["half_gdt"],
            c["half_dt"], c["gdt"], c["dt"], c["fan_lo"], c["fan_hi"],
            c["cover"], c["miss"], c["hit"], c["clampv"], c["tail_w"],
            c["miss_tail"], stream)
    if err != 0:
        raise RuntimeError(f"room_raster launch failed: CUDA error {err}")
    room_raster.launches += 1
    name = form_name(spec, rm.ring, grouped)
    room_raster.launches_by_form[name] = \
        room_raster.launches_by_form.get(name, 0) + 1
    return counts


def room_raster(logodds, agent_xy, yaw, dist_m, active, spec: BeamSpec,
                cfg: GridConfig = GridConfig(), n_groups: int = 16,
                per_row=None, trusted=None, reach: int = REACH_CELLS,
                tail_weight: float = 0.25):
    """The engine's room raster: (new_logodds, counts [BR, BC] f32) as
    `room_raster_pallas(..., n_groups=n_groups, trusted=...,
    tail_weight=...)` returns them. agent_xy [N, 2] world metres, yaw [N],
    dist_m / trusted [N, B] the range-limited readings and their trust mask
    (the endpoint ring) or trusted=None (no ring), active [N] bool;
    `n_groups` below B runs the grouped tier with the weak tail at
    `tail_weight`, else the per-beam pack16 table (the default, 16, is the
    reference's); `spec` is the scan's fan or the wrapped 4-way fan;
    per_row rooms per tile row (default: every tile column). `logodds`
    [S, S] float32 is updated IN PLACE.

    A CPU grid goes to `room_raster_plain`. A CUDA grid launches the
    kernel; a failed build or launch raises."""
    if logodds.device.type == "cpu":
        return room_raster_plain(logodds, agent_xy, yaw, dist_m, active,
                                 spec, cfg, n_groups=n_groups,
                                 per_row=per_row, trusted=trusted,
                                 reach=reach, tail_weight=tail_weight)
    if logodds.device.type != "cuda":
        raise ValueError(f"no raster for a grid on {logodds.device}")
    _check_supported(logodds, spec, n_groups, reach)
    rm = _rooms(logodds, agent_xy, yaw, dist_m, active, spec, cfg, per_row,
                trusted, reach, n_groups, tail_weight)
    return logodds, _launch(logodds, rm, spec, cfg, _dense_fan(spec, reach))


room_raster.launches = 0
room_raster.launches_by_form = {}
