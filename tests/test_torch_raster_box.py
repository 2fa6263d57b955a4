"""The evaluation box of the raster kernels (csrc/free_raster.cu,
csrc/room_raster.cu and csrc/exact_raster.cu evaluate only the cells of the
bounding box of the fan's sector of radius R + 1 around an agent, R the
largest range its own table holds, or for the exact raster its meta's
longest range, widened by a cell), proved on the CPU against the kernels'
plain torch versions: every cell to which the plain
version gives a nonzero delta or a nonzero painted count lies inside
`evaluation_box`. The painted count per cell is read as the delta of a
grid config whose miss and hit log-odds are 1 (then each evidence term of
the delta is the matching painted term, all of them >= 0) on active
agents; the exact raster has no count, and its unit-log-odds delta marks
every cell that takes evidence.

Covers the pack8 and pack16 tables with and without the ring, the grouped
table (181 beams in 8 and in 16 groups, the 0.25 tail), the wrapped 4-way
fan, ranges up to each field's clamp (31.75 cells pack8, 127.99 pack16 and
grouped), agents at the grid's and the window's edges, a row band and a
tile window of the sharded engine, and the room raster's slots; the exact
raster on the 181- and 37-beam scans and the wrapped fan, ranges from a
few cells to past its window, agents at the grid's edges and across the
64 x 128 tile edges, inactive agents, and yaws up to +-100 (beyond 64 the
box takes the whole disc). 512^2 grids, at most 48 agents.
"""

import dataclasses

import numpy as np
import pytest
import torch

from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.geom.world import make_tiled_rooms
from swarm_tpu_torch.ops import beam_raster_cuda as bc
from swarm_tpu_torch.ops import exact_raster_cuda as pe
from swarm_tpu_torch.ops import room_raster_cuda as rc
from swarm_tpu_torch.ops.beam_raster import BeamSpec

SIZE = 512
CFG = GridConfig(size=SIZE, origin_x=0.0, origin_y=0.0)
# every evidence term of the delta equals its painted term
UNIT = dataclasses.replace(CFG, logodds_miss=1.0, logodds_hit=1.0)

# (table, beams, groups, ring, grid window (band, band_cols)); the exact
# raster's: ("exact", beams, None, True, the largest |yaw|)
CASES = {
    "pack8-ring": ("pack8", 181, None, True, None),
    "pack8": ("pack8", 181, None, False, None),
    "pack16-ring": ("pack16", 181, None, True, None),
    "pack16": ("pack16", 181, None, False, None),
    "grouped-ring-181/8": ("grouped", 181, 8, True, None),
    "grouped-181/16": ("grouped", 181, 16, False, None),
    "pack8-ring-wrapped": ("pack8", 4, None, True, None),
    "grouped-ring-wrapped-4/2": ("grouped", 4, 2, True, None),
    "pack16-ring-band": ("pack16", 181, None, True, ((128, 128), None)),
    "grouped-ring-tile": ("grouped", 181, 8, True, ((-32, 320),
                                                    (-128, 512))),
    "room-pack16-ring": ("room", 181, None, True, None),
    "room-grouped-181/8": ("room", 181, 8, False, None),
    "exact-181": ("exact", 181, None, True, np.pi),
    "exact-37": ("exact", 37, None, True, np.pi),
    "exact-wrapped": ("exact", 4, None, True, np.pi),
    "exact-181-yaw100": ("exact", 181, None, True, 100.0),
}


def _ranges(rng, n, n_beams, clamp_m):
    """Readings in metres: per agent a scale up to the field's clamp (a few
    agents short-sighted, a few far beyond the reach)."""
    scale = rng.choice([0.3, 1.2, clamp_m], size=(n, 1))
    return rng.uniform(0.02, 1.0, (n, n_beams)) * scale


def _outside(nonzero, rows, cols, box):
    """Cells [M, h, w] nonzero outside each row's box: `rows` [M, h] and
    `cols` [M, w] are the cells' coordinates in the box's frame."""
    r_lo, r_hi, c_lo, c_hi = (b[:, None] for b in box)
    in_r = (rows + 0.0 >= r_lo) & (rows + 0.0 < r_hi)
    in_c = (cols + 0.0 >= c_lo) & (cols + 0.0 < c_hi)
    inside = in_r[:, :, None] & in_c[:, None, :]
    return int((nonzero & ~inside).sum()), int(inside.sum()), \
        int(nonzero.sum())


def _window_case(kind, n_beams, n_groups, ring, window, rng):
    band, band_cols = window or (None, None)
    shape = (SIZE if band is None else band[1],
             SIZE if band_cols is None else band_cols[1])
    lo_r = 0 if band is None else max(band[0], 0)
    lo_c = 0 if band_cols is None else max(band_cols[0], 0)
    hi_r = SIZE if band is None else min(band[0] + band[1], SIZE)
    hi_c = SIZE if band_cols is None else min(band_cols[0] + band_cols[1],
                                              SIZE)
    n = 48
    cells = np.stack([rng.uniform(lo_r, hi_r, n), rng.uniform(lo_c, hi_c, n)],
                     -1)
    # at the grid's (or the band's) corners and edges, where the window
    # is clamped and the agent sits at its edge
    cells[:6] = [[lo_r + 0.3, lo_c + 0.6], [hi_r - 0.4, hi_c - 0.2],
                 [lo_r + 1.5, hi_c - 2.0], [hi_r - 3.0, lo_c + 0.9],
                 [(lo_r + hi_r) / 2, lo_c + 0.1], [lo_r + 0.05,
                                                   (lo_c + hi_c) / 2]]
    xy = torch.tensor(cells[:, ::-1] * CFG.resolution, dtype=torch.float32)
    yaw = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32)
    clamp_m = (31.75 if kind == "pack8" else 127.99) * CFG.resolution
    dist = torch.tensor(_ranges(rng, n, n_beams, clamp_m + 0.5),
                        dtype=torch.float32)
    trusted = torch.tensor(rng.random((n, n_beams)) < 0.7) if ring else None
    active = torch.ones(n, dtype=torch.bool)
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    grid = torch.zeros(shape)
    kw = dict(pack8=kind == "pack8", n_groups=n_groups, tail_weight=0.25,
              band=band, band_cols=band_cols)
    deltas = []
    for cfg in (CFG, UNIT):
        w = bc._windows(grid, xy, yaw, dist, active, spec, cfg, trusted, 26,
                        **kw)
        assert w.kind == kind
        deltas.append(bc._window_deltas(w, spec, cfg,
                                        bc._dense_fan(spec, 26))[0])
    box = bc.evaluation_box(w.table, w.kind, w.ring, w.ax, w.ay, w.yaw,
                            spec, w.n_bins)
    rows = w.row0[:, None] + torch.arange(w.rows)[None, :]
    cols = w.col0[:, None] + torch.arange(w.cols)[None, :]
    return deltas, rows, cols, box


def _room_case(n_groups, ring, rng):
    per_row, n_rooms = 2, 7
    _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    n = 2 * n_rooms
    room = np.arange(n) // 2
    xy = origins[room] + rng.uniform([0.3, 0.3], [5.7, 3.7], (n, 2))
    xy[:2] = origins[0] + [[0.05, 0.05], [6.3, 6.3]]     # the tile's edges
    n_beams = 181
    dist = _ranges(rng, n, n_beams, 6.4)
    trusted = torch.tensor(rng.random((n, n_beams)) < 0.7) if ring else None
    args = (torch.tensor(xy, dtype=torch.float32),
            torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32),
            torch.tensor(dist, dtype=torch.float32),
            torch.ones(n, dtype=torch.bool))
    spec = BeamSpec.scan(n_beams)
    deltas = []
    for cfg in (CFG, UNIT):
        rm = rc._rooms(torch.zeros((SIZE, SIZE)), *args, spec, cfg, per_row,
                       trusted, 26, n_groups or n_beams, 0.25)
        d = rc._room_deltas(rm, spec, cfg, bc._dense_fan(spec, 26))[0]
        deltas.append(d.reshape(-1, rm.win_rows, 256))
    br_n, bc_n = rm.meta.shape[:2]
    m = rm.meta.reshape(-1, 8)
    tr = torch.arange(br_n)[:, None, None].expand(br_n, bc_n, 2).reshape(-1)
    tc = torch.arange(bc_n)[None, :, None].expand(br_n, bc_n, 2).reshape(-1)
    box = bc.evaluation_box(rm.table.reshape(m.shape[0], -1), rm.kind,
                            rm.ring, m[:, 0], m[:, 1], m[:, 2], spec,
                            rm.n_bins)
    rows = (tr * 128 + m[:, 4].long())[:, None] + \
        torch.arange(rm.win_rows)[None, :]
    cols = (tc * 256)[:, None] + torch.arange(256)[None, :]
    return deltas, rows, cols, box


def _exact_case(n_beams, yaw_max, rng):
    """The exact raster (`exact_raster_cuda._deltas`, beam_raster_plain's
    per-agent deltas) and its box, for 48 agents: 6 at the grid's corners
    and edges, 12 across the 64 x 128 tile edges, the rest anywhere; yaws
    up to +-yaw_max (a third of them within 1 of +-64 where it is larger);
    ranges of a few cells, about the reach, and 7 m (past the 64-row
    window); a sixth of the agents inactive. Agents 18-23 read 1.2 m on
    every beam, all trusted and active: their rings reach R + 0.71 in
    every direction of the fan, so the box's edges are tested where they
    are tightest."""
    n = 48
    cells = rng.uniform(0, SIZE, (n, 2))
    cells[:6] = [[0.3, 0.6], [SIZE - 0.4, SIZE - 0.2], [1.5, SIZE - 2.0],
                 [SIZE - 3.0, 0.9], [SIZE / 2, 0.1], [0.05, SIZE / 2]]
    cells[6:18] = np.stack([rng.integers(1, SIZE // 64, 12) * 64.0,
                            rng.integers(1, SIZE // 128, 12) * 128.0], -1) + \
        rng.uniform(-3, 3, (12, 2))
    yaw = rng.uniform(-yaw_max, yaw_max, n)
    if yaw_max > 64:
        yaw[::3] = rng.choice([-1, 1], 16) * rng.uniform(63, 65, 16)
    dist = _ranges(rng, n, n_beams, 7.0)
    trusted = rng.random((n, n_beams)) < 0.7
    active = rng.random(n) < 0.83
    dist[18:24], trusted[18:24], active[18:24] = 1.2, True, True
    args = (torch.tensor(cells[:, ::-1] * CFG.resolution,
                         dtype=torch.float32),
            torch.tensor(yaw, dtype=torch.float32),
            torch.tensor(dist, dtype=torch.float32), torch.tensor(trusted),
            torch.tensor(active))
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    grid = torch.zeros((SIZE, SIZE))
    deltas = []
    for cfg in (CFG, UNIT):
        w = pe._windows(grid, *args, cfg)
        deltas.append(pe._deltas(w, spec, cfg))
    rows = w.row0[:, None] + torch.arange(w.rows)[None, :]
    cols = w.col0[:, None] + torch.arange(w.cols)[None, :]
    return deltas, rows, cols, pe.evaluation_box(w, spec)


@pytest.mark.parametrize("case", list(CASES))
def test_evidence_lies_in_the_evaluation_box(case):
    kind, n_beams, n_groups, ring, window = CASES[case]
    rng = np.random.default_rng(len(case) * 31 + n_beams)
    if kind == "room":
        deltas, rows, cols, box = _room_case(n_groups, ring, rng)
    elif kind == "exact":
        deltas, rows, cols, box = _exact_case(n_beams, window, rng)
    else:
        deltas, rows, cols, box = _window_case(kind, n_beams, n_groups, ring,
                                               window, rng)
    (delta, painted) = deltas
    out_d, inside, n_d = _outside(delta != 0, rows, cols, box)
    out_p, _, n_p = _outside(painted != 0, rows, cols, box)
    assert out_d == 0 and out_p == 0, \
        f"{out_d} deltas and {out_p} painted cells outside the box"
    assert n_d > 0 and n_p > 0
    # the box is a real cut of the window for the short-sighted agents
    assert inside < rows.shape[1] * cols.shape[1] * rows.shape[0]
