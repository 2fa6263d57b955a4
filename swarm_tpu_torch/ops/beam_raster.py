"""Polar beam-model raster helpers (swarm_tpu/ops/beam_raster.py): the
beam fan, the evidence reach, the per-agent window and its placement, the
fan's bounding box, the 8- and 16-bit range quantisations (the 16-bit pair
packing of swarm_tpu/ops/beam_raster_pallas.py:186-209), the beam tables
built from sensor readings and the endpoint rays of a fan. The rasters
themselves are ops/beam_raster_cuda.py (per-agent windows) and
ops/room_raster_cuda.py (room tiles).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from swarm_tpu_torch.utils.angles import jmod

REACH_CELLS = 26        # max beam reach: 1.2 m trust / 5 cm + ring margin

# 16-bit pair packing (the room kernel's per-beam table): 15-bit ranges in
# 1/256-cell fixed point + trusted flag in bit 15, two beams per int32 word.
RANGE_QUANT = 256.0
RANGE_MAX_CELLS = 127.0 + 255.0 / 256.0

# 8-bit quad packing: 7-bit ranges in 1/4-cell fixed point + trusted flag in
# bit 7, four beams per int32 word (EngineConfig.beam_pack8).
RANGE_QUANT8 = 4.0
RANGE_MAX_CELLS8 = 31.0 + 3.0 / 4.0


def quantize_ranges_cells8(ranges_cells):
    """Quantize beam ranges (cells) to the 8-bit quad-packed fixed point
    (1/4 cell, clipped to < 32 cells)."""
    return torch.round(torch.clamp(ranges_cells, 0.0, RANGE_MAX_CELLS8)
                       * RANGE_QUANT8) * (1.0 / RANGE_QUANT8)


def _pack_range16(dist_cells_raw, trusted):
    """[N, B] raw ranges in cells + trusted mask (or None: no trusted bit)
    -> [N, P] int32 pair words, beam 2p in bits 0-15 and beam 2p+1 in bits
    16-31 (15-bit 1/256-cell range, trusted bit 15)."""
    ints = torch.round(torch.clamp(dist_cells_raw, 0.0, RANGE_MAX_CELLS)
                       * RANGE_QUANT).to(torch.int32)
    if trusted is not None:
        ints = ints | (trusted.to(torch.int32) << 15)
    b_n = ints.shape[-1]
    n_pairs = -(-b_n // 2)
    ints = torch.nn.functional.pad(ints, (0, 2 * n_pairs - b_n))
    return ints[:, 0::2] | (ints[:, 1::2] << 16)


def _unpack_range16(v16, trusted_bit: bool = True):
    """Packed 16-bit field (int32 in [0, 65535]) -> (range cells f32,
    trusted flag f32). Bit 15 is the trusted flag when the table carries
    one (the endpoint ring); without it all 16 bits are range and the flag
    is 0 (`paint_hits` of the reference's `_unpack_range16`)."""
    if trusted_bit:
        return ((v16 & 0x7FFF).to(torch.float32) * (1.0 / RANGE_QUANT),
                (v16 >> 15).to(torch.float32))
    return (v16.to(torch.float32) * (1.0 / RANGE_QUANT),
            torch.zeros(v16.shape, dtype=torch.float32, device=v16.device))


@dataclasses.dataclass(frozen=True)
class BeamSpec:
    """A uniform fan of beams: world angle of beam b = yaw + theta0 +
    b * dtheta."""
    n_beams: int
    theta0: float          # first beam, relative to heading
    dtheta: float          # spacing
    wrap: bool             # True: fan covers the full circle (4-way)

    @staticmethod
    def four_way() -> "BeamSpec":
        return BeamSpec(n_beams=4, theta0=0.0, dtheta=math.pi / 2, wrap=True)

    @staticmethod
    def scan(n: int = 181) -> "BeamSpec":
        return BeamSpec(n_beams=n, theta0=-math.pi / 2,
                        dtheta=math.pi / (n - 1), wrap=False)


def reach_cells(cfg) -> int:
    """Evidence reach in cells for a SwarmConfig: sensor range + the
    endpoint-ring margin."""
    return int(math.ceil(cfg.sensors.max_range / cfg.grid.resolution)) + 2


def patch_dims(size: int, reach: int = REACH_CELLS,
               row_align: int = 8) -> Tuple[int, int]:
    """Agent-window shape with >= `reach` cells of margin on every side at
    aligned origins (rows `row_align`, cols 128): [64, 256] for the default
    1.2 m reach. Grids below 512 cells span the full width."""
    rows = min(-(-(2 * reach + row_align) // row_align) * row_align,
               (size // row_align) * row_align)
    if size < 512:
        cols = size
    else:
        cols = min(-(-(2 * reach + 128) // 128) * 128,
                   (size // 128) * 128)
    return rows, cols


def patch_origin(ax_cell, ay_cell, size: int, rows: int = 64,
                 cols: int = 256, reach: int = REACH_CELLS,
                 row_align: int = 8):
    """Aligned window origin (row0, col0) [N] int32: align_down(agent -
    reach), clamped to the grid. (The band / tile offsets of the reference
    belong to the sharded engine, not ported yet.)"""
    row0 = torch.div(torch.floor(ay_cell).to(torch.int32) - reach,
                     row_align, rounding_mode="floor") * row_align
    row0 = torch.clamp(row0, 0, size - rows)
    if cols >= size:
        col0 = torch.zeros_like(row0)
    else:
        col0 = torch.div(torch.floor(ax_cell).to(torch.int32) - reach,
                         128, rounding_mode="floor") * 128
        col0 = torch.clamp(col0, 0, size - cols)
    return row0.to(torch.int32), col0.to(torch.int32)


def fan_bbox_cells(yaw, spec: BeamSpec, reach_r: float):
    """Per-agent bounding box of every cell the fan can paint, relative to
    the agent, in cells: the bbox of the fan's direction arc at radius
    `reach_r`, united with the agent point. Returns (xmin, xmax, ymin,
    ymax), each [N] float32. The arc is `n_beams * dtheta` as in the
    reference (ROADMAP Queue C1 records why the grouped tier, not ported,
    needs the painted arc instead)."""
    if spec.wrap:
        r = torch.full_like(yaw, reach_r)
        return -r, r, -r, r
    lo = yaw + spec.theta0 - spec.dtheta / 2.0
    arc = spec.n_beams * spec.dtheta

    def has(a):
        return jmod(a - lo, 2.0 * math.pi) <= arc

    hi = lo + arc
    cl, ch = torch.cos(lo), torch.cos(hi)
    sl, sh = torch.sin(lo), torch.sin(hi)
    one = torch.ones_like(yaw)
    xmax = torch.where(has(0.0), one, torch.maximum(cl, ch))
    xmin = torch.where(has(math.pi), -one, torch.minimum(cl, ch))
    ymax = torch.where(has(math.pi / 2), one, torch.maximum(sl, sh))
    ymin = torch.where(has(-math.pi / 2), -one, torch.minimum(sl, sh))
    z = torch.zeros_like(yaw)
    return (torch.minimum(z, xmin * reach_r), torch.maximum(z, xmax * reach_r),
            torch.minimum(z, ymin * reach_r), torch.maximum(z, ymax * reach_r))


def endpoint_rays(agent_xy, yaw, dist_m, trusted, active, spec: BeamSpec):
    """Trusted beam endpoints as zero-length rays for the exact endpoint
    scatter (`ops.raster.endpoint_scatter`, or `logodds_delta` with
    k_max=1). agent_xy [N, 2], yaw [N], dist_m / trusted [N, B]."""
    from swarm_tpu_torch.ops.raster import RayBatch

    b = dist_m.shape[1]
    ang = yaw[:, None] + spec.theta0 + \
        torch.arange(b, dtype=dist_m.dtype,
                     device=dist_m.device)[None, :] * spec.dtheta
    hx = (agent_xy[:, 0:1] + dist_m * torch.cos(ang)).reshape(-1)
    hy = (agent_xy[:, 1:2] + dist_m * torch.sin(ang)).reshape(-1)
    ok = (trusted & active[:, None]).reshape(-1)
    return RayBatch(ox=hx, oy=hy, hx=hx, hy=hy, hit_valid=ok, active=ok)


def beams_from_4way(dist4_m, sens_max_range: float, sens_min_range: float):
    """4-way readings -> (range-limited distances, trusted mask)."""
    trusted = (dist4_m > sens_min_range) & (dist4_m <= sens_max_range)
    return torch.where(trusted, dist4_m,
                       torch.full_like(dist4_m, sens_max_range)), trusted


def beams_from_scan(scan_m, sens_max_range: float, sens_min_range: float):
    """Sweep readings -> (range-limited distances, trusted mask)."""
    trusted = (scan_m > sens_min_range) & (scan_m <= sens_max_range)
    return torch.where(trusted, scan_m,
                       torch.full_like(scan_m, sens_max_range)), trusted
