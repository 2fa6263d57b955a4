"""Frontier detection and clustering (swarm_tpu/ops/frontier.py), in torch.

A frontier cell is a FREE cell 4-adjacent to an UNKNOWN one (interior
cells only). Two routes, as in the reference engine:
- `frontier_clusters` (grids up to 512): exact 4-connected components by
  min-label propagation, each labelled by its lowest row-major index, so
  clusters come in the reference's discovery order;
- `frontier_targets_coarse` (swarm grids): frontier counts pooled over
  8 x 8 blocks, a block is a target when it is the unique maximum of
  (count, lowest index) in its (2 sep + 1)^2 neighbourhood with at least
  `frontier_min_cluster` cells, capped row-major at `max_frontiers`, with
  its centroid refined within the block.
Both return (centroids_world [K, 2] f32, sizes [K] int32, count [] int32),
zero-padded past `count`. The TPU mechanisms of the reference (int8 MXU
pooling, one-hot matmul compaction) become integer sums and a cumsum
compaction here; the values are the same. Nothing here reads a tensor on
the host except `label_components`, which tests for convergence once every
CHECK_EVERY iterations.
"""

from __future__ import annotations

import torch

from swarm_tpu_torch.config import CoordConfig, GridConfig
from swarm_tpu_torch.ops.raster import grid_to_world

BIG = 2 ** 30
# label propagation: iterations between convergence reads (one sync each)
CHECK_EVERY = 8


def frontier_mask(grid, cfg: GridConfig = GridConfig()):
    """[S, S] bool: FREE cells 4-adjacent to an UNKNOWN cell, with the
    border ring cleared."""
    free = grid == cfg.free
    unk = grid == cfg.unknown
    near_unknown = (torch.roll(unk, (0, -1), (0, 1)) |
                    torch.roll(unk, (0, 1), (0, 1)) |
                    torch.roll(unk, (-1, 0), (0, 1)) |
                    torch.roll(unk, (1, 0), (0, 1)))
    mask = free & near_unknown
    mask[0, :] = False
    mask[-1, :] = False
    mask[:, 0] = False
    mask[:, -1] = False
    return mask


def label_components(mask):
    """4-connected component labels of `mask` [S, S]: for masked cells the
    component's minimum row-major index, BIG elsewhere (int32).

    Each iteration takes two hops of min-propagation, as the reference's
    `while_loop` body does; the loop stops at the fixed point. Iterating
    past it changes nothing, so convergence is read on the host only once
    every CHECK_EVERY iterations (one sync each)."""
    s = mask.shape[0]
    big = torch.full_like(mask, BIG, dtype=torch.int32)
    flat_ids = torch.arange(s * s, dtype=torch.int32,
                            device=mask.device).reshape(s, s)
    lbl = torch.where(mask, flat_ids, big)

    def shift_min(lb):
        p = torch.nn.functional.pad(lb, (1, 1, 1, 1), value=BIG)
        nb = torch.minimum(torch.minimum(p[:-2, 1:-1], p[2:, 1:-1]),
                           torch.minimum(p[1:-1, :-2], p[1:-1, 2:]))
        return torch.where(mask, torch.minimum(lb, nb), big)

    it = 0
    while True:
        new = shift_min(shift_min(lbl))
        it += 1
        if it % CHECK_EVERY == 0 and torch.equal(new, lbl):
            return new
        lbl = new


def frontier_clusters(grid, cfg: GridConfig = GridConfig(),
                      coord: CoordConfig = CoordConfig()):
    """Exact pipeline: mask -> components -> clusters of at least
    `frontier_min_cluster` cells in discovery order, their centroids. Sizes
    and coordinate sums are integers (the reference's float32 sums are
    exact below 2^24, where the two agree)."""
    s = grid.shape[0]
    dev = grid.device
    k_max = coord.max_frontiers
    mask = frontier_mask(grid, cfg)
    lbl = label_components(mask).reshape(-1).to(torch.int64)
    on = mask.reshape(-1)
    safe = torch.where(on, lbl, torch.zeros_like(lbl))
    ids = torch.arange(s * s, dtype=torch.int64, device=dev)
    n = s * s
    sizes = torch.zeros((n,), dtype=torch.int64, device=dev).index_add_(
        0, safe, on.to(torch.int64))
    gx = torch.where(on, ids % s, torch.zeros_like(ids))
    gy = torch.where(on, ids // s, torch.zeros_like(ids))
    sum_x = torch.zeros((n,), dtype=torch.int64, device=dev).index_add_(
        0, safe, gx)
    sum_y = torch.zeros((n,), dtype=torch.int64, device=dev).index_add_(
        0, safe, gy)

    # roots in flat-id order (the reference's discovery order), capped
    is_root = sizes >= coord.frontier_min_cluster
    roots, found = _compact(is_root, ids, k_max)
    csize = torch.where(found, sizes[roots], torch.zeros_like(roots))
    den = torch.clamp_min(csize, 1).to(torch.float32)
    cx = sum_x[roots].to(torch.float32) / den
    cy = sum_y[roots].to(torch.float32) / den
    wx, wy = grid_to_world(cx, cy, cfg)
    zero = torch.zeros_like(wx)
    centroids = torch.stack([torch.where(found, wx, zero),
                             torch.where(found, wy, zero)], dim=-1)
    return (centroids, csize.to(torch.int32),
            found.sum().to(torch.int32))


def _compact(keep, vals, k_max: int):
    """The first `k_max` entries of `vals` [M] where `keep` [M], in order,
    without a host read: (vals_out [k_max] (0 past the end), found
    [k_max] bool)."""
    ki = keep.to(torch.int64)
    pos = torch.cumsum(ki, 0) - ki                  # exclusive prefix
    slot = torch.where(keep & (pos < k_max), pos,
                       torch.full_like(pos, k_max))
    out = torch.zeros((k_max + 1,), dtype=vals.dtype, device=vals.device)
    out.index_put_((slot,), torch.where(slot < k_max, vals,
                                        torch.zeros_like(vals)))
    n_found = torch.clamp(ki.sum(), max=k_max)
    found = torch.arange(k_max, device=vals.device) < n_found
    return out[:k_max], found


def frontier_targets_coarse(grid, cfg: GridConfig = GridConfig(),
                            coord: CoordConfig = CoordConfig(),
                            block: int = 8):
    """Swarm-scale frontier targets from 8 x 8 block-pooled frontier counts
    and a peak test instead of exact components (same contract as
    `frontier_clusters`)."""
    s = grid.shape[0]
    dev = grid.device
    nb = s // block
    k_max = coord.max_frontiers
    s_c = nb * block
    mask = frontier_mask(grid, cfg)[:s_c, :s_c].to(torch.int32)
    # [row block, row in block, col block, col in block]
    blocks = mask.reshape(nb, block, nb, block)
    off = torch.arange(block, dtype=torch.int32, device=dev)
    counts_i = blocks.sum(dim=(1, 3), dtype=torch.int32)         # [nb, nb]
    sdx = (blocks * off).sum(dim=(1, 3), dtype=torch.int32)
    sdy = (blocks * off[:, None, None]).sum(dim=(1, 3), dtype=torch.int32)
    counts = counts_i.to(torch.float32)
    base = torch.arange(nb, dtype=torch.float32, device=dev) * block
    sum_x = counts * base[None, :] + sdx.to(torch.float32)
    sum_y = counts * base[:, None] + sdy.to(torch.float32)

    sep = max(1, int(round(coord.frontier_separation_m /
                           (cfg.resolution * block))))
    # peak: the unique maximum of (count, lowest flat index) in its
    # (2 sep + 1)^2 window (a separable shifted max)
    flat = torch.arange(nb * nb, dtype=torch.int32,
                        device=dev).reshape(nb, nb)
    key = counts_i * (nb * nb) + (nb * nb - 1 - flat)
    lowest = -(2 ** 31) + 1
    padk = torch.nn.functional.pad(key, (sep, sep, sep, sep), value=lowest)
    rowm = padk[:, sep:sep + nb]
    for d in range(1, sep + 1):
        rowm = torch.maximum(rowm, torch.maximum(
            padk[:, sep - d:sep - d + nb], padk[:, sep + d:sep + d + nb]))
    neigh = rowm[sep:sep + nb, :]
    for d in range(1, sep + 1):
        neigh = torch.maximum(neigh, torch.maximum(
            rowm[sep - d:sep - d + nb, :], rowm[sep + d:sep + d + nb, :]))
    peak = (key == neigh) & (counts >= coord.frontier_min_cluster)

    # the first k_max peaks in row-major order
    src, oks = _compact(peak.reshape(-1),
                        torch.arange(nb * nb, dtype=torch.int64, device=dev),
                        k_max)
    zero = torch.zeros((k_max,), dtype=torch.float32, device=dev)
    cnts = torch.where(oks, counts.reshape(-1)[src], zero)
    sx = torch.where(oks, sum_x.reshape(-1)[src], zero)
    sy = torch.where(oks, sum_y.reshape(-1)[src], zero)
    den = torch.clamp_min(cnts, 1.0)
    wx, wy = grid_to_world(sx / den, sy / den, cfg)
    centroids = torch.stack([torch.where(oks, wx, zero),
                             torch.where(oks, wy, zero)], dim=-1)
    sizes = torch.where(oks, cnts, zero).to(torch.int32)
    return centroids, sizes, oks.sum().to(torch.int32)
