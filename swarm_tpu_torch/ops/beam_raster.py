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

from swarm_tpu_torch._device import recip32
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.ops.raster import ordered_add
from swarm_tpu_torch.utils.angles import jmod

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


# patch cells computed at once by the XLA tier (its float temporaries are
# [agents, rows, cols]; 2^23 cells keep each near 32 MB)
PATCH_CHUNK_CELLS = 1 << 23


def _patch_delta(ax, ay, yaw, ranges_cells, trusted, row0, col0,
                 spec: BeamSpec, hit: float, miss: float, rows_n: int,
                 cols_n: int):
    """Evidence of each agent's [rows_n, cols_n] patch (the reference's
    `_patch_delta`, batched over agents): the nearest beam's free space
    and trusted endpoint, by the cell centre's polar coordinates. ax, ay
    [M] agent cells (fractional), yaw [M], ranges_cells / trusted [M, B].
    Returns (delta [M, rows_n, cols_n] float32, free, occ bool)."""
    dev = ax.device
    rows = torch.arange(rows_n, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(cols_n, dtype=torch.int32, device=dev)[None, None, :]
    cy = (row0[:, None, None] + rows).to(torch.float32) + 0.5
    cx = (col0[:, None, None] + cols).to(torch.float32) + 0.5
    dx = cx - ax[:, None, None]
    dy = cy - ay[:, None, None]
    r = torch.sqrt(dx * dx + dy * dy)
    theta = torch.atan2(dy, dx)
    rel = theta - yaw[:, None, None] - spec.theta0
    rel = jmod(rel + math.pi, 2 * math.pi) - math.pi
    # the jitted reference multiplies by the reciprocal (ROADMAP C15)
    b = torch.round(rel * recip32(spec.dtheta)).to(torch.int64)
    if spec.wrap:
        b = torch.remainder(b, spec.n_beams)
        in_fan = torch.ones_like(r, dtype=torch.bool)
    else:
        in_fan = (b >= 0) & (b < spec.n_beams)
        b = torch.clamp(b, 0, spec.n_beams - 1)
    m = b.shape[0]
    rb = torch.gather(ranges_cells, 1, b.reshape(m, -1)).reshape(b.shape)
    tb = torch.gather(trusted, 1, b.reshape(m, -1)).reshape(b.shape)
    resid = rel - b.to(torch.float32) * spec.dtheta
    on_beam = torch.abs(r * torch.sin(resid)) <= 0.6
    reach = ranges_cells.amax(dim=1)[:, None, None] + 1.0
    near = (r > 1e-3) & (r <= reach) & in_fan & on_beam
    free = near & (r < rb - 0.5)
    occ = near & tb & (torch.abs(r - rb) <= 0.71)
    zero = torch.zeros_like(r)
    return (torch.where(occ, zero + hit, torch.where(free, zero + miss,
                                                     zero)), free, occ)


def beam_raster_reference(logodds, agent_xy, yaw, dist_m, trusted,
                          spec: BeamSpec, cfg: GridConfig = GridConfig(),
                          reach: int = REACH_CELLS):
    """The fused engine's XLA beam tier (swarm_tpu/ops/beam_raster.py
    `beam_raster_reference`), IN PLACE on `logodds` (float32 or bfloat16):
    every agent's patch evidence (`_patch_delta`) added to the grid in
    agent index order, each add rounded to the grid's dtype, then one clip
    of the whole grid (not one per agent; ROADMAP C2). The reference adds
    every patch cell; a zero changes only a -0.0 cell (to +0.0), so each
    -0.0 cell under a patch is made +0.0 first and only the nonzero
    evidence goes through the ordered add. agent_xy [N, 2] world, yaw [N],
    dist_m / trusted [N, B]: the caller zeroes a dead agent's ranges and
    trust. Agents go through in chunks of PATCH_CHUNK_CELLS patch cells,
    each chunk one ordered add. Returns (logodds, writes): free plus
    occupied cells, unweighted (a cell both free and occupied counts
    twice; ROADMAP C18)."""
    inv = recip32(cfg.resolution)
    ax = (agent_xy[:, 0] - cfg.origin_x) * inv
    ay = (agent_xy[:, 1] - cfg.origin_y) * inv
    ranges_cells = dist_m * inv
    pr, pc = patch_dims(cfg.size, reach)
    row0, col0 = patch_origin(ax, ay, cfg.size, pr, pc, reach)
    flat = logodds.view(-1)
    writes = torch.zeros((), dtype=torch.int64, device=logodds.device)
    n = ax.shape[0]
    step = max(1, PATCH_CHUNK_CELLS // (pr * pc))
    rows = torch.arange(pr, dtype=torch.int64, device=logodds.device)
    cols = torch.arange(pc, dtype=torch.int64, device=logodds.device)
    for a in range(0, n, step):
        sl = slice(a, min(n, a + step))
        delta, free, occ = _patch_delta(
            ax[sl], ay[sl], yaw[sl], ranges_cells[sl], trusted[sl],
            row0[sl], col0[sl], spec, cfg.logodds_hit, cfg.logodds_miss,
            pr, pc)
        cells = ((row0[sl].to(torch.int64)[:, None, None] + rows[:, None])
                 * cfg.size + col0[sl].to(torch.int64)[:, None, None]
                 + cols)
        cells = cells.reshape(-1)
        v = flat[cells]
        flat[cells] = torch.where(v == 0, torch.zeros_like(v), v)
        ordered_add(flat, cells, delta, keep=delta != 0)
        writes = writes + free.sum() + occ.sum()
    c = cfg.logodds_clamp
    logodds.clamp_(-c, c)
    return logodds, writes.to(torch.int32)


def _free_patch(ax, ay, yaw, gm, gt, act, row0, col0, spec: BeamSpec,
                cfg: GridConfig, n_groups: int, per: int, group_dtheta: float,
                line_equivalent: bool, tail_weight: float, phase,
                ghost_guard: bool, rows_n: int, cols_n: int):
    """The fast free-space evidence of each agent's [rows_n, cols_n] patch
    (the reference's per-agent `one`, batched over agents): the group's
    carve (and the weak tail) by the cell's polar coordinates, weighted by
    the analytic beam-crossing count. ax, ay [M] GLOBAL agent cells, yaw
    [M], gm / gt [M, G] carve and tail ranges, act [M] float32, row0 /
    col0 [M] GLOBAL patch origins. Returns (delta [M, rows_n, cols_n]
    float32, per-agent painted count [M] float64: cells at their crossing
    count, tail cells at `tail_weight`)."""
    dev = ax.device
    f32 = torch.float32
    rows = torch.arange(rows_n, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(cols_n, dtype=torch.int32, device=dev)[None, None, :]
    cy = (row0[:, None, None] + rows).to(f32) + 0.5
    cx = (col0[:, None, None] + cols).to(f32) + 0.5
    dx = cx - ax[:, None, None]
    dy = cy - ay[:, None, None]
    r = torch.sqrt(dx * dx + dy * dy)
    theta = torch.atan2(dy, dx)
    y = yaw[:, None, None]
    if phase is not None:
        # rotated partition: the cell's own beam, then its rotated group
        relb = jmod(theta - y - spec.theta0 + math.pi, 2 * math.pi) - math.pi
        bi = torch.round(relb * recip32(spec.dtheta)).to(torch.int64)
        if spec.wrap:
            bi = torch.remainder(bi, spec.n_beams)
            in_fan = torch.ones_like(r, dtype=torch.bool)
        else:
            in_fan = (bi >= 0) & (bi < spec.n_beams)
            bi = torch.clamp(bi, 0, spec.n_beams - 1)
        slot = torch.remainder(bi - int(phase), n_groups * per)
        g = (slot.to(f32) * float(np.float32(1.0 / per))).to(torch.int64)
        resid = relb - bi.to(f32) * spec.dtheta
    else:
        # static partition: the group's centre is its mean beam angle
        rel = theta - y - spec.theta0 - group_dtheta / 2.0 + \
            spec.dtheta / 2.0
        rel = jmod(rel + math.pi, 2 * math.pi) - math.pi
        g = torch.floor(rel * recip32(group_dtheta) + 0.5).to(torch.int64)
        if spec.wrap:
            g = torch.remainder(g, n_groups)
            in_fan = torch.ones_like(r, dtype=torch.bool)
        else:
            in_fan = (rel >= -group_dtheta / 2.0) & \
                (rel < (n_groups - 0.5) * group_dtheta)
            g = torch.clamp(g, 0, n_groups - 1)
        resid = rel - g.to(f32) * group_dtheta
    m = g.shape[0]
    rb = torch.gather(gm, 1, g.reshape(m, -1)).reshape(g.shape)
    # crossing beams: 2 atan(0.5 / r) ~ 1 / r over the beam spacing (the
    # reference divides by the constant spacing: a multiplication by its
    # float32 reciprocal under jit, ROADMAP C15)
    rinv = torch.reciprocal(torch.clamp_min(r, 1e-3))
    covered = rinv >= spec.dtheta * 0.999
    cnt = (torch.clamp_min(torch.round(rinv * recip32(spec.dtheta)), 1.0)
           if line_equivalent else torch.ones_like(r))
    # a sparse fan (4-way) paints only within a beam's half-cell width
    on_any = covered | (torch.abs(r * resid) <= 0.6)
    base_ok = in_fan & on_any & (r > 1e-3)
    if ghost_guard:
        # a tile window may reach past the global grid; its ghost cells
        # are neither painted nor counted
        base_ok = base_ok & (cy >= 0.0) & (cy < cfg.size) & \
            (cx >= 0.0) & (cx < cfg.size)
    free = base_ok & (r < rb - 0.5)
    zero = torch.zeros_like(r)
    a = act[:, None, None]
    delta = torch.where(free, cfg.logodds_miss * cnt, zero) * a
    w = torch.where(free, cnt, zero).sum(dim=(1, 2), dtype=torch.float64)
    if tail_weight > 0:
        rt = torch.gather(gt, 1, g.reshape(m, -1)).reshape(g.shape)
        tail = base_ok & ~free & (r < rt - 0.5)
        delta = delta + torch.where(
            tail, cfg.logodds_miss * tail_weight * cnt, zero) * a
        w = w + tail_weight * torch.where(tail, cnt, zero).sum(
            dim=(1, 2), dtype=torch.float64)
    return delta, w


def free_raster_reference(logodds, agent_xy, yaw, dist_m, active,
                          spec: BeamSpec, cfg: GridConfig = GridConfig(),
                          n_groups: int = 16, line_equivalent: bool = True,
                          reach: int = REACH_CELLS, band=None,
                          band_cols=None, tail_weight: float = 0.25,
                          phase=None):
    """The XLA fast free-space tier (swarm_tpu/ops/beam_raster.py
    `free_raster_reference`), IN PLACE on `logodds` (the whole grid, or
    the row band `band=(row_off, n_rows)` / tile window `band_cols=(col_off,
    n_cols)` of it): free cells from each group's carve range (the
    second-smallest of its beams; with `phase` the rotated partition's
    minimum), weak tail evidence (`tail_weight`) out to the group's tail
    range, each scaled by the analytic beam-crossing count when
    `line_equivalent`. No endpoint is painted. agent_xy [N, 2] world, yaw
    [N], dist_m [N, B] (already range-limited), active [N] bool: a dead
    agent's evidence is multiplied by 0, its count is not.

    The float coordinates stay GLOBAL in every decomposition: the window's
    offsets enter only the integer clamps of the patch origin and the
    integer start of each patch in the window, so a band or tile paints
    the same cells, bit for bit, as the whole grid. Each agent's patch is
    added in agent index order, each add rounded to the grid's dtype, then
    the grid is clipped once (ROADMAP C2), as `beam_raster_reference`
    does: a -0.0 cell under a patch whose evidence there is not -0.0 is
    made +0.0 first, and only nonzero evidence goes through `ordered_add`.
    Returns (logodds, writes float32 0-d: crossing-count weighted, tail
    cells at `tail_weight`, summed exactly in float64 and rounded once)."""
    inv = recip32(cfg.resolution)
    ax = (agent_xy[:, 0] - cfg.origin_x) * inv
    ay = (agent_xy[:, 1] - cfg.origin_y) * inv
    row_off = 0 if band is None else band[0]
    col_off = 0 if band_cols is None else band_cols[0]
    ranges_cells = quantize_ranges_cells(dist_m * inv)
    per = -(-spec.n_beams // n_groups)
    if phase is not None and per > 1:
        gm, gt = group_range_stats_rotated(ranges_cells, n_groups, phase)
    else:
        phase = None
        gm, gt = group_range_stats(ranges_cells, n_groups)
    pr, pc = patch_dims(cfg.size, reach)
    row0, col0 = patch_origin(ax, ay, cfg.size, pr, pc, reach,
                              n_rows=None if band is None else band[1],
                              n_cols=None if band_cols is None
                              else band_cols[1],
                              row_off=row_off, col_off=col_off)
    group_dtheta = spec.dtheta * per
    act = active.to(torch.float32)
    dev = logodds.device
    w_cols = logodds.shape[1]
    flat = logodds.view(-1)
    # global origin -> the patch's integer start in the window
    lr0 = row0.to(torch.int64) - row_off
    lc0 = col0.to(torch.int64) - col_off
    rows = torch.arange(pr, dtype=torch.int64, device=dev)
    cols = torch.arange(pc, dtype=torch.int64, device=dev)
    writes = torch.zeros((), dtype=torch.float64, device=dev)
    n = ax.shape[0]
    step = max(1, PATCH_CHUNK_CELLS // (pr * pc))
    for a in range(0, n, step):
        sl = slice(a, min(n, a + step))
        delta, w = _free_patch(
            ax[sl], ay[sl], yaw[sl], gm[sl], gt[sl], act[sl], row0[sl],
            col0[sl], spec, cfg, n_groups, per, group_dtheta,
            line_equivalent, tail_weight, phase, band_cols is not None,
            pr, pc)
        cells = ((lr0[sl][:, None, None] + rows[:, None]) * w_cols
                 + lc0[sl][:, None, None] + cols).reshape(-1)
        delta = delta.reshape(-1)
        # -0.0 + -0.0 is -0.0: only evidence other than -0.0 lifts a -0.0
        # cell to +0.0
        lift = cells[~((delta == 0) & torch.signbit(delta))]
        v = flat[lift]
        flat[lift] = torch.where(v == 0, torch.zeros_like(v), v)
        ordered_add(flat, cells, delta, keep=delta != 0)
        writes = writes + w.sum()
    c = cfg.logodds_clamp
    logodds.clamp_(-c, c)
    return logodds, writes.to(torch.float32)
