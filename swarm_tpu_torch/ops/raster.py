"""Ray batches, the log-odds line raster and the tri-state view of the map
(swarm_tpu/ops/raster.py), in torch.

`logodds_delta` is the reference's unclamped scatter of one ray batch
(Bresenham cells, -miss along each path, +hit at a trusted endpoint) into
a fresh grid, or into a fresh row band or tile window of it (the sharded
engine's `band` / `band_cols`: evidence outside the window is dropped and
not counted).
`endpoint_scatter` is what the engine runs after each window raster that
has no endpoint ring (`EngineConfig.kernel_endpoints=False`): the exact
endpoint hits of one fan, `clip(logodds + logodds_delta(endpoint_rays,
k_max=1))`, applied IN PLACE at the endpoints' cells only.

`parity_raster` is the reference-parity path's tri-state update: a
scatter-max of each write's sequence id into a free plane and an occupied
plane, exact and order-free on any device. `logodds_raster` is the line
raster: `logodds_delta` summed in ray order by `ordered_add`, then one clip.

`ordered_add` adds (cell, delta) pairs to a flat buffer in the order they
are given, each add rounded to the buffer's dtype, as a sequential loop
would: it stable-sorts the pairs by cell, ranks each within its cell and
adds layer r (the r-th contribution of every cell) in one gather and
scatter. The kept count, the deepest layer and the layer bounds are read
to the host once per call (ROADMAP C25). On the card `index_add_` adds
with float atomics, in no fixed order, so a cell's sum of unlike addends
would change from run to run; `logodds_delta` sums through it too (C42).

Cell indices follow the reference's `int()`: `world_to_grid` truncates
toward zero (`.to(torch.int32)`), not floor, so a point up to one cell left
of or below the origin lands in cell 0; and it multiplies by the reciprocal
of the resolution, as the jitted reference does (ROADMAP Queue C).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from swarm_tpu_torch._device import recip32
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.ops.bresenham import bresenham_cells

OCC_THRESH = 0.3
FREE_THRESH = -0.3


def world_to_grid(wx, wy, cfg: GridConfig):
    """World -> int32 cell indices, truncated toward zero. The reference
    engine runs this under `jit`, where XLA turns the division by the
    resolution into a multiplication by its float32 reciprocal; the port
    multiplies likewise, so that a point on a cell boundary (agents start
    on one, with axis-aligned beams) lands in the same cell."""
    inv = recip32(cfg.resolution)
    gx = ((wx - cfg.origin_x) * inv).to(torch.int32)
    gy = ((wy - cfg.origin_y) * inv).to(torch.int32)
    return gx, gy


def grid_to_world(gx, gy, cfg: GridConfig):
    """Cell centre in world metres; takes fractional indices (centroids)."""
    wx = cfg.origin_x + (gx + 0.5) * cfg.resolution
    wy = cfg.origin_y + (gy + 0.5) * cfg.resolution
    return wx, wy


class RayBatch(NamedTuple):
    """An ordered batch of rays. ox, oy: [R] start (the robot) in world
    metres; hx, hy: [R] end (a hit or the max-range probe); hit_valid [R]
    bool: the end is a trusted hit; active [R] bool."""
    ox: torch.Tensor
    oy: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    hit_valid: torch.Tensor
    active: torch.Tensor


def _traced_cells(rays: RayBatch, cfg: GridConfig, k_max: int):
    x0, y0 = world_to_grid(rays.ox, rays.oy, cfg)
    x1, y1 = world_to_grid(rays.hx, rays.hy, cfg)
    cx, cy, valid, endpoint = bresenham_cells(x0, y0, x1, y1, k_max)
    in_bounds = (cx >= 0) & (cx < cfg.size) & (cy >= 0) & (cy < cfg.size)
    valid = valid & in_bounds & rays.active[..., None]
    free = valid & ~endpoint
    occ = valid & endpoint & rays.hit_valid[..., None]
    flat = cy * cfg.size + cx      # row-major (gy, gx)
    return flat, free, occ


def logodds_delta(rays: RayBatch, cfg: GridConfig = GridConfig(),
                  k_max: int = 32, dtype=torch.float32, band=None,
                  band_cols=None):
    """Unclamped log-odds evidence of one ray batch, added into a fresh
    [size, size] grid in ray order (`ordered_add`, each add rounded to
    `dtype`). Returns (delta, writes).

    band=(row_off, n_rows) returns the [n_rows, size] delta of that row
    band of the grid, band_cols=(col_off, n_cols) restricts the columns as
    well (a tile window, [n_rows, n_cols]); cells outside the window are
    dropped and left out of `writes`."""
    flat, free, occ = _traced_cells(rays, cfg, k_max)
    n_rows = n_cols = cfg.size
    if band is not None or band_cols is not None:
        row_off, n_rows = band if band is not None else (0, cfg.size)
        col_off, n_cols = band_cols if band_cols is not None \
            else (0, cfg.size)
        row = torch.div(flat, cfg.size, rounding_mode="floor")
        col = flat - row * cfg.size
        inb = (row >= row_off) & (row < row_off + n_rows) & \
            (col >= col_off) & (col < col_off + n_cols)
        free = free & inb
        occ = occ & inb
        flat = (row - row_off) * n_cols + (col - col_off)
    zero = torch.zeros(flat.shape, dtype=dtype, device=flat.device)
    delta = torch.where(occ, zero + cfg.logodds_hit,
                        torch.where(free, zero + cfg.logodds_miss, zero))
    # summed in ray order, as the reference's scatter-add sums on the CPU,
    # on any device (a float atomic add would sum -miss and +hit in no
    # fixed order; ROADMAP C42)
    out = torch.zeros((n_rows * n_cols,), dtype=dtype, device=flat.device)
    ordered_add(out, flat, delta, keep=free | occ)
    writes = free.sum() + occ.sum()
    return out.reshape(n_rows, n_cols), writes


def ordered_add(buf, cells, deltas, keep=None):
    """buf[cells[k]] = dtype(float32(buf[cells[k]]) + deltas[k]) for k in
    order (for each k with keep[k], when `keep` is given), IN PLACE, on a
    1-D buffer. `cells` int [K] (each kept one in range), `deltas` float32
    [K]. Bit-equal to the loop on any device, up to a NaN's payload (the
    card's arithmetic returns its canonical NaN): the adds of one cell
    happen in the given order, one layer at a time, each rounded to the
    buffer's dtype (so a -0.0 cell under any add becomes +0.0 and a NaN
    stays NaN, as under the loop). Host reads: the kept count (with
    `keep`), the deepest layer and the layer bounds. Returns the deepest
    layer (the most adds to one cell); the deepest since the last reset is
    kept in `ordered_add.deepest`."""
    cells, deltas = cells.reshape(-1), deltas.reshape(-1)
    if keep is not None:
        keep = keep.reshape(-1)
        cells, deltas = cells[keep], deltas[keep]
    k = cells.numel()
    if k == 0:
        return 0
    dev = cells.device
    key = torch.int32 if buf.numel() < 2 ** 31 and k < 2 ** 31 \
        else torch.int64
    sc, perm = torch.sort(cells.to(key), stable=True)
    sd = deltas[perm]
    pos = torch.arange(k, dtype=key, device=dev)
    first = torch.ones(k, dtype=torch.bool, device=dev)
    first[1:] = sc[1:] != sc[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    sr, order = torch.sort(rank, stable=True)
    depth = int(sr[-1]) + 1
    bounds = torch.searchsorted(
        sr, torch.arange(depth + 1, dtype=key, device=dev)).tolist()
    lc, ld = sc[order].to(torch.int64), sd[order]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        c, d = lc[lo:hi], ld[lo:hi]
        v = buf.index_select(0, c)
        buf.index_copy_(0, c, (v.to(torch.float32) + d).to(buf.dtype))
    ordered_add.deepest = max(ordered_add.deepest, depth)
    return depth


ordered_add.deepest = 0


def parity_raster(grid, rays: RayBatch, cfg: GridConfig = GridConfig(),
                  k_max: int = 32):
    """The ordered ray batch on the int8 tri-state grid, each cell in the
    state the reference's sequential last-write-wins update leaves it:
    every path cell FREE, a trusted endpoint OCCUPIED, the latest write
    winning (within a ray the endpoint is written last, so OCCUPIED wins at
    equal sequence ids). Each write's ray index is scatter-maxed into a
    free and an occupied plane (int32 `amax`: exact, in any order).
    Entries that write nothing (masked, or outside the grid, where the
    reference's flat index may alias a cell inside it) go to a spare cell
    past the grid. Returns (grid, writes)."""
    flat, free, occ = _traced_cells(rays, cfg, k_max)
    return parity_apply(grid, flat, free, occ, cfg), free.sum() + occ.sum()


def parity_apply(grid, flat, free, occ, cfg: GridConfig):
    """`parity_raster`'s update from traced cells (`_traced_cells`: flat
    [R, K] cell indices, free and occ [R, K] masks), ray r's writes
    ordered after every earlier ray's. Returns the new grid."""
    ncells = cfg.size * cfg.size
    seq = torch.arange(flat.shape[0], dtype=torch.int32,
                       device=flat.device)[:, None].expand(flat.shape)
    spare = torch.full_like(flat, ncells)

    def plane(mask):
        idx = torch.where(mask, flat, spare).reshape(-1).to(torch.int64)
        return torch.full((ncells + 1,), -1, dtype=torch.int32,
                          device=flat.device).scatter_reduce_(
            0, idx, seq.reshape(-1), "amax")[:ncells]

    free_seq, occ_seq = plane(free), plane(occ)
    touched = torch.maximum(free_seq, occ_seq) >= 0
    code = torch.where(occ_seq >= free_seq,
                       torch.tensor(cfg.occupied, dtype=torch.int8,
                                    device=flat.device),
                       torch.tensor(cfg.free, dtype=torch.int8,
                                    device=flat.device))
    new = torch.where(touched, code, grid.reshape(-1))
    return new.reshape(grid.shape)


def logodds_raster(logodds, rays: RayBatch, cfg: GridConfig = GridConfig(),
                   k_max: int = 32):
    """The line raster: `clip(logodds + logodds_delta(rays))`, the delta
    summed from zero in ray order (`ordered_add`, as the reference's
    scatter-add sums it on the CPU), the whole grid added and clipped IN
    PLACE. Returns (logodds, writes)."""
    flat, free, occ = _traced_cells(rays, cfg, k_max)
    zero = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
    delta = torch.where(occ, zero + cfg.logodds_hit,
                        torch.where(free, zero + cfg.logodds_miss, zero))
    buf = torch.zeros(cfg.size * cfg.size, dtype=torch.float32,
                      device=flat.device)
    ordered_add(buf, flat, delta, keep=free | occ)
    c = cfg.logodds_clamp
    logodds.add_(buf.view(logodds.shape)).clamp_(-c, c)
    return logodds, free.sum() + occ.sum()


_HIT_SUMS = {}


def _hit_sums(cfg: GridConfig, device) -> torch.Tensor:
    """[K + 1] float32: entry k is k hits added one after another from 0,
    as a scatter-add in ray order sums them; K is the first count whose sum
    reaches 2 * clamp, past which clip(l + sum) is clamp for every l in
    [-clamp, clamp]. Built once per device (no transfer in the step)."""
    key = (cfg.logodds_hit, cfg.logodds_clamp, str(device))
    if key not in _HIT_SUMS:
        hit = np.float32(cfg.logodds_hit)
        if not hit > 0:
            raise ValueError("the endpoint scatter needs logodds_hit > 0")
        sums = [np.float32(0.0)]
        while sums[-1] < 2 * np.float32(cfg.logodds_clamp):
            sums.append(np.float32(sums[-1] + hit))
        _HIT_SUMS[key] = torch.tensor(np.array(sums, np.float32),
                                      device=device)
    return _HIT_SUMS[key]


def endpoint_scatter(logodds, rays: RayBatch, cfg: GridConfig = GridConfig()):
    """`clip(logodds + logodds_delta(rays, cfg, k_max=1)[0])` IN PLACE, for
    zero-length rays (origin == end, as `beam_raster.endpoint_rays` builds
    them: each valid, trusted, in-bounds ray adds +hit to its cell).
    Returns (logodds, writes int). On a bfloat16 grid the sum and the clip
    are float32 and the cell is stored rounded to nearest even, once, as
    the reference engine computes it (swarm_tpu/engine/sim.py:613-616).

    Sparse and sync-free: each ray finds how many valid rays share its cell
    (a sort and two searches), takes the in-order sum of that many hits
    from a table, and writes clip(cell + sum) to its cell. Every ray of a
    cell writes the same value, so the order of the writes does not matter;
    a ray that is not valid adds 0 to its cell (or to cell 0 when it lies
    outside the grid), which leaves it unchanged."""
    size = cfg.size
    gx, gy = world_to_grid(rays.hx, rays.hy, cfg)
    inb = (gx >= 0) & (gx < size) & (gy >= 0) & (gy < size)
    ok = inb & rays.active & rays.hit_valid
    flat = torch.where(inb, gy.to(torch.int64) * size + gx,
                       torch.zeros_like(gx, dtype=torch.int64))
    keys = torch.sort(torch.where(ok, flat,
                                  torch.full_like(flat, size * size))).values
    cnt = torch.searchsorted(keys, flat, right=True) - \
        torch.searchsorted(keys, flat)
    sums = _hit_sums(cfg, logodds.device)
    add = sums[torch.clamp(cnt, max=sums.shape[0] - 1)]
    cells = logodds.view(-1)
    c = cfg.logodds_clamp
    cells.index_put_((flat,), torch.clamp(cells[flat].to(torch.float32)
                                          + add, -c, c).to(cells.dtype))
    return logodds, ok.sum()


def tri_state_view(logodds, cfg: GridConfig = GridConfig(),
                   occ_thresh: float = OCC_THRESH,
                   free_thresh: float = FREE_THRESH):
    """int8 map: cfg.free where log-odds <= free_thresh, cfg.occupied where
    >= occ_thresh, cfg.unknown elsewhere. On a bfloat16 grid each threshold
    rounds to bfloat16, as the reference's weakly typed float does."""
    out = torch.full(logodds.shape, cfg.unknown, dtype=torch.int8,
                     device=logodds.device)
    out = torch.where(logodds <= free_thresh,
                      torch.full_like(out, cfg.free), out)
    return torch.where(logodds >= occ_thresh,
                       torch.full_like(out, cfg.occupied), out)
