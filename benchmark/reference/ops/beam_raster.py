"""Polar beam-model raster helpers (swarm_tpu/ops/beam_raster.py): the
beam fan, the evidence reach, the per-agent window and its placement (on
the whole grid, or on a band or tile window of the sharded engine), the
fan's bounding box, the 8- and 16-bit range quantisations (the 16-bit pair
packing of swarm_tpu/ops/beam_raster_pallas.py:186-209), the grouped
tier's per-group range statistics (static and rotated) and trusted
fraction, the beam tables built from sensor readings and the endpoint rays
of a fan; the fused engine's XLA beam tier (`beam_raster_reference`,
`EngineConfig.use_pallas=False`): each agent's dense patch of nearest-beam
evidence, the patches added in agent order (`ops.raster.ordered_add`) and
the grid clipped once; and the sharded engine's XLA fast free-space tier
(`free_raster_reference`): the same patch scheme with group carve and
tail ranges and crossing-count weights, on the whole grid or a band or
tile window of it, in global float coordinates.
The kernel rasters are ops/beam_raster_cuda.py (per-agent windows),
ops/room_raster_cuda.py (room tiles) and ops/exact_raster_cuda.py (the r1
exact per-beam raster).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from benchmark.reference._device import recip32
from benchmark.reference.config import GridConfig
from benchmark.reference.utils.angles import jmod

PATCH_ROWS = 80         # the reference's legacy patch defaults (patch_dims
PATCH_COLS = 384        # sizes a patch from the reach)

REACH_CELLS = 26        # max beam reach: 1.2 m trust / 5 cm + ring margin

# 16-bit pair packing (the room kernel's per-beam table): 15-bit ranges in
# 1/256-cell fixed point + trusted flag in bit 15, two beams per int32 word.
RANGE_QUANT = 256.0
RANGE_MAX_CELLS = 127.0 + 255.0 / 256.0

# 8-bit quad packing: 7-bit ranges in 1/4-cell fixed point + trusted flag in
# bit 7, four beams per int32 word (EngineConfig.beam_pack8).
RANGE_QUANT8 = 4.0
RANGE_MAX_CELLS8 = 31.0 + 3.0 / 4.0


def quantize_ranges_cells(ranges_cells):
    """Quantize beam ranges (cells) to the grouped tier's fixed point (1/256
    cell, clipped to < 128 cells)."""
    return torch.round(torch.clamp(ranges_cells, 0.0, RANGE_MAX_CELLS)
                       * RANGE_QUANT) * (1.0 / RANGE_QUANT)


def quantize_ranges_cells8(ranges_cells):
    """Quantize beam ranges (cells) to the 8-bit quad-packed fixed point
    (1/4 cell, clipped to < 32 cells)."""
    return torch.round(torch.clamp(ranges_cells, 0.0, RANGE_MAX_CELLS8)
                       * RANGE_QUANT8) * (1.0 / RANGE_QUANT8)


def group_range_stats(ranges_cells, n_groups: int):
    """[N, B] per-beam ranges -> (carve [N, G], tail [N, G]): each group of
    ceil(B / G) consecutive beams (the last padded with the last beam's
    range) sorted; carve is its second-smallest range (one short outlier
    per group tolerated), tail its median `s[per // 2]`, the limit of the
    weak-evidence annulus."""
    n, b = ranges_cells.shape
    per = -(-b // n_groups)
    r = torch.cat([ranges_cells,
                   ranges_cells[:, -1:].expand(n, n_groups * per - b)], 1)
    s = torch.sort(r.reshape(n, n_groups, per), dim=-1).values
    return s[..., min(1, per - 1)], s[..., per // 2]


def group_range_stats_rotated(ranges_cells, n_groups: int, phase,
                              tail_margin: float = 1.5):
    """Group range statistics over a ROTATED partition: group g covers
    beams [phase + g * per, phase + (g + 1) * per) of the padded table
    (mod its length). Returns (carve [N, G], tail [N, G]): the group
    minimum and the minimum plus `tail_margin` cells. Cycling `phase`
    through [0, per) across steps makes the group carve converge to the
    per-beam carve. `phase` is an int (a tensor is read to the host)."""
    n, b = ranges_cells.shape
    per = -(-b // n_groups)
    r = torch.cat([ranges_cells,
                   ranges_cells[:, -1:].expand(n, n_groups * per - b)], 1)
    r = torch.roll(r, -int(phase), dims=1)
    mn = r.reshape(n, n_groups, per).amin(dim=-1)
    return mn, mn + tail_margin


ROT_TAIL_MARGIN = 1.5   # cells past the window min (~2 sigma of the
#                         3.5 cm ultrasonic noise at 5 cm resolution)


def group_trusted_frac(trusted, n_beams: int, n_groups: int):
    """[N, B] per-beam trust -> [N, G] each group's trusted fraction, the
    endpoint ring's weight in the grouped tier: zero-padded to G groups of
    ceil(B / G) beams (padding dilutes the last group), then the mean. JAX's
    `mean` multiplies the sum by the float32 reciprocal of `per`, so this
    does too (a division differs in the last bit at per = 23 and 12)."""
    n = trusted.shape[0]
    per = -(-n_beams // n_groups)
    tf = torch.nn.functional.pad(trusted.to(torch.float32),
                                 (0, n_groups * per - n_beams))
    return tf.reshape(n, n_groups, per).sum(-1) * recip32(per)


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
                 n_rows: int | None = None, n_cols: int | None = None,
                 row_align: int = 8, row_off: int = 0, col_off: int = 0):
    """Aligned window origin (row0, col0) [N] int32: align_down(agent -
    reach), clamped to the grid. On a row band or tile window of the
    sharded engine (`n_rows` / `n_cols` its height / width) the origin is
    clamped into [row_off, row_off + n_rows - rows] x [col_off, col_off +
    n_cols - cols]. The kernel wrappers pass window-local agent cells
    (shifted by the window's offsets, as free_raster_pallas shifts them)
    and offsets of 0; the XLA fast tier passes GLOBAL agent cells and the
    window's offsets, and gets a global origin back."""
    h = size if n_rows is None else n_rows
    w = size if n_cols is None else n_cols
    row0 = torch.div(torch.floor(ay_cell).to(torch.int32) - reach,
                     row_align, rounding_mode="floor") * row_align
    row0 = torch.clamp(row0, row_off, row_off + h - rows)
    if cols >= w:
        col0 = torch.full_like(row0, col_off)
    else:
        col0 = torch.div(torch.floor(ax_cell).to(torch.int32) - reach,
                         128, rounding_mode="floor") * 128
        col0 = torch.clamp(col0, col_off, col_off + w - cols)
    return row0.to(torch.int32), col0.to(torch.int32)


def fan_bbox_cells(yaw, spec: BeamSpec, reach_r: float):
    """Per-agent bounding box of every cell the fan can paint, relative to
    the agent, in cells: the bbox of the fan's direction arc at radius
    `reach_r`, united with the agent point. Returns (xmin, xmax, ymin,
    ymax), each [N] float32. The arc is `n_beams * dtheta`, as the
    reference computes it, in every tier. The grouped tier paints the arc
    `n_groups * group_dtheta` from `theta0 - dtheta / 2`, which is longer
    when `n_groups` does not divide `n_beams`, so the strip bounds built
    from this box can skip paintable cells there (ROADMAP Queue C1: none at
    181 beams in 8 groups, some at 181 in 16). The port follows the kernel,
    which computes what the TPU kernel computes."""
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
