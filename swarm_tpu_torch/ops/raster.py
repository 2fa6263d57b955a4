"""Ray batches, the log-odds line raster and the tri-state view of the map
(swarm_tpu/ops/raster.py), in torch.

`logodds_delta` is the reference's unclamped scatter of one ray batch
(Bresenham cells, -miss along each path, +hit at a trusted endpoint) into
a fresh grid; the band forms of the sharded engine are not ported.
`endpoint_scatter` is what the engine runs after each window raster that
has no endpoint ring (`EngineConfig.kernel_endpoints=False`): the exact
endpoint hits of one fan, `clip(logodds + logodds_delta(endpoint_rays,
k_max=1))`, applied IN PLACE at the endpoints' cells only.

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
                  k_max: int = 32, dtype=torch.float32):
    """Unclamped log-odds evidence of one ray batch, scatter-added into a
    fresh [size, size] grid in ray order. Returns (delta, writes)."""
    flat, free, occ = _traced_cells(rays, cfg, k_max)
    zero = torch.zeros(flat.shape, dtype=dtype, device=flat.device)
    delta = torch.where(occ, zero + cfg.logodds_hit,
                        torch.where(free, zero + cfg.logodds_miss, zero))
    flat_r = torch.where(free | occ, flat, torch.zeros_like(flat))
    # index_add_ on the CPU adds in index order, as the reference's scatter
    # does (index_put_ with accumulate may not)
    out = torch.zeros((cfg.size * cfg.size,), dtype=dtype,
                      device=flat.device).index_add_(
        0, flat_r.reshape(-1).to(torch.int64), delta.reshape(-1))
    writes = free.sum() + occ.sum()
    return out.reshape(cfg.size, cfg.size), writes


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
