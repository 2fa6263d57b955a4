"""Cross-agent map merging (swarm_tpu/slam/merge.py): the offline
replacement of the reference's map_merger.py.

`merge_local_maps` aligns N same-frame log-odds grids by correlative grid
matching (`scanmatch.match_grids`) against the running global occupancy,
warps each accepted one into the global frame (`warp_grid`, bilinear) and
adds its evidence; the reference's `lax.scan` over the maps is a fold in
Python. `merge_submaps_dynamic` merges differently-sized, offset submaps
into a bounds-fitted grid: occupied points, a window rasterised from the
running global cloud, the point-set-to-window matcher
(`scanmatch.match_scan_window`), a fitness test against the dilated
window and a voxel downsample; its host parts are the reference's numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from swarm_tpu_torch.config import GridConfig, SlamConfig
from swarm_tpu_torch.slam.scanmatch import (MatchResult, _bilinear_sample,
                                            _rotated_coords, match_grids,
                                            match_scan_window)


def warp_grid(grid, dx_cells, dy_cells, theta, fill: float = 0.0):
    """Bilinear affine warp about the grid centre: output(p) =
    grid(R(-theta) (p - c - t) + c), the grid rotated by theta and then
    translated by (dx, dy) cells; taps outside read `fill`."""
    sx, sy = _rotated_coords(grid.shape[0], theta, dx_cells, dy_cells,
                             grid.dtype)
    return _bilinear_sample(grid, sx, sy, fill)


class MergeResult(NamedTuple):
    global_logodds: torch.Tensor   # [S, S]
    transforms: MatchResult        # per-agent ([N] leaves)
    merged: torch.Tensor           # [N] bool — passed the fitness gate


def merge_local_maps(local_logodds, cfg: GridConfig = GridConfig(),
                     slam: SlamConfig = SlamConfig(),
                     fitness_min: float = 0.6,
                     occ_thresh: float = 0.3) -> MergeResult:
    """Align + merge N per-agent log-odds grids [N, S, S]: agent 0's map is
    the anchor; each later map is matched against the running global
    occupancy and folded in (then clipped) when its fitness passes."""
    res = cfg.resolution
    f32 = torch.float32

    def occ_of(lo):
        return (lo >= occ_thresh).to(f32)

    glob = local_logodds[0]
    ms = []
    for lo in local_logodds[1:]:
        m = match_grids(occ_of(lo), occ_of(glob), cfg, slam, fitness_min)
        warped = warp_grid(lo, m.dx / res, m.dy / res, m.dtheta)
        glob = torch.where(m.ok, glob + warped, glob)
        glob = torch.clamp(glob, -cfg.logodds_clamp, cfg.logodds_clamp)
        ms.append(m)
    dev = local_logodds.device

    def pre(x0, field, dtype=f32):
        head = torch.tensor([x0], dtype=dtype, device=dev)
        return torch.cat([head] + [getattr(m, field)[None] for m in ms])

    transforms = MatchResult(
        dx=pre(0.0, "dx"), dy=pre(0.0, "dy"), dtheta=pre(0.0, "dtheta"),
        score=pre(float("inf"), "score"), fitness=pre(1.0, "fitness"),
        ok=pre(True, "ok", torch.bool))
    return MergeResult(global_logodds=glob, transforms=transforms,
                       merged=transforms.ok)


def submap_points(grid, origin_xy, resolution: float,
                  occ_thresh: float = 0.3):
    """Occupied cells of one submap -> world-frame points [P, 2] (int8
    tri-state: > 50; log-odds: >= occ_thresh), the cell's origin-anchored
    coordinate."""
    g = np.asarray(grid.cpu() if isinstance(grid, torch.Tensor) else grid)
    occ = g > 50 if g.dtype.kind in "iu" else g >= occ_thresh
    ys, xs = np.nonzero(occ)
    return np.stack([xs * resolution + origin_xy[0],
                     ys * resolution + origin_xy[1]], axis=-1)


def global_map_from_points(points, resolution: float):
    """Bounds-fitted global occupancy grid of a point cloud: extent
    ceil(bounds / res) + 1, UNKNOWN (-1) everywhere, occupied cells 100,
    origin the cloud's minimum. Returns (grid int8 [H, W], (origin_x,
    origin_y))."""
    pts = np.asarray(points, np.float64)
    if pts.size == 0:
        return np.full((1, 1), -1, np.int8), (0.0, 0.0)
    min_x, min_y = pts[:, 0].min(), pts[:, 1].min()
    max_x, max_y = pts[:, 0].max(), pts[:, 1].max()
    width = int(np.ceil((max_x - min_x) / resolution)) + 1
    height = int(np.ceil((max_y - min_y) / resolution)) + 1
    grid = np.full((height, width), -1, np.int8)
    xi = np.clip(((pts[:, 0] - min_x) / resolution).astype(int),
                 0, width - 1)
    yi = np.clip(((pts[:, 1] - min_y) / resolution).astype(int),
                 0, height - 1)
    grid[yi, xi] = 100
    return grid, (float(min_x), float(min_y))


def _voxel_downsample(points, resolution: float):
    """One point (the mean) per occupied voxel of side `resolution`."""
    if len(points) == 0:
        return points
    keys = np.floor(points / resolution).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 2), np.float64)
    np.add.at(sums, inv.reshape(-1), points)
    return (sums / counts[:, None]).astype(points.dtype)


def _shift(a, s: int, axis: int):
    """A non-wrapping shift of a 2-D array by s along axis."""
    out = np.zeros_like(a)
    src = [slice(None)] * 2
    dst = [slice(None)] * 2
    dst[axis] = slice(s, None) if s > 0 else slice(None, s)
    src[axis] = slice(None, -s) if s > 0 else slice(-s, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def merge_submaps_dynamic(submaps, resolution: float,
                          slam: SlamConfig = SlamConfig(),
                          fitness_min: float = 0.6,
                          occ_thresh: float = 0.3,
                          icp_threshold_m: float = 1.0, device=None):
    """Merge differently-sized, offset submaps [(grid, (origin_x,
    origin_y))] into a bounds-fitted global map. The first non-empty
    submap seeds the global cloud; each later one's occupied points are
    matched (a 2-cell scoring radius) against a window rasterised from the
    running cloud around their centroid, folded in when the fraction of
    aligned points within `icp_threshold_m` of the cloud clears
    `fitness_min`, and the cloud is voxel-downsampled. The matcher runs on
    `device` (the card when None). Returns (grid int8 [H, W], origin,
    per-submap dicts {ok, fitness, dx, dy, dtheta[, reason]})."""
    from swarm_tpu_torch._device import default_device
    device = default_device(device)
    search = slam.scanmatch_window_cells
    cloud = None
    reports = []
    for grid, origin in submaps:
        pts = submap_points(grid, origin, resolution, occ_thresh)
        if len(pts) == 0:
            reports.append({"ok": False, "fitness": 0.0, "dx": 0.0,
                            "dy": 0.0, "dtheta": 0.0, "reason": "empty"})
            continue
        if cloud is None:
            cloud = pts.astype(np.float64)
            reports.append({"ok": True, "fitness": 1.0, "dx": 0.0,
                            "dy": 0.0, "dtheta": 0.0})
            continue
        centroid = pts.mean(axis=0)
        ext = np.abs(pts - centroid).max() / resolution
        inner = int(np.ceil((2 * ext + 8) / 32)) * 32
        side = inner + 2 * search
        wx0 = centroid[0] - (side / 2.0) * resolution
        wy0 = centroid[1] - (side / 2.0) * resolution
        cx = ((cloud[:, 0] - wx0) / resolution).astype(int)
        cy = ((cloud[:, 1] - wy0) / resolution).astype(int)
        okc = (cx >= 0) & (cx < side) & (cy >= 0) & (cy < side)
        win = np.zeros((side, side), np.float32)
        win[cy[okc], cx[okc]] = 1.0

        p_cap = 1 << max(6, int(len(pts) - 1).bit_length())
        off = np.zeros((p_cap, 2), np.float32)
        off[:len(pts)] = pts - centroid
        valid = np.zeros((p_cap,), bool)
        valid[:len(pts)] = True
        m = _window_matcher(off, valid, win, inner, search, slam,
                            resolution, device)
        ddx, ddy, ddth = float(m.ddx[0]), float(m.ddy[0]), \
            float(m.ddtheta[0])
        ct, st = np.cos(ddth), np.sin(ddth)
        rel = pts - centroid
        moved = np.stack(
            [centroid[0] + rel[:, 0] * ct - rel[:, 1] * st + ddx,
             centroid[1] + rel[:, 0] * st + rel[:, 1] * ct + ddy], axis=-1)
        th_cells = max(1, int(round(icp_threshold_m / resolution)))
        dil = win.astype(bool)
        for axis in (0, 1):
            acc = dil.copy()
            for sdist in range(1, th_cells + 1):
                acc |= _shift(dil, sdist, axis)
                acc |= _shift(dil, -sdist, axis)
            dil = acc
        mx = ((moved[:, 0] - wx0) / resolution).astype(int)
        my = ((moved[:, 1] - wy0) / resolution).astype(int)
        okm = (mx >= 0) & (mx < side) & (my >= 0) & (my < side)
        inl = dil[np.clip(my, 0, side - 1), np.clip(mx, 0, side - 1)] & okm
        fit = float(inl.sum()) / max(len(pts), 1)
        if fit < fitness_min:
            reports.append({"ok": False, "fitness": fit, "dx": 0.0,
                            "dy": 0.0, "dtheta": 0.0, "reason": "fitness"})
            continue
        cloud = _voxel_downsample(np.concatenate([cloud, moved], axis=0),
                                  resolution)
        reports.append({"ok": True, "fitness": fit, "dx": ddx, "dy": ddy,
                        "dtheta": ddth})

    if cloud is None:
        return np.full((1, 1), -1, np.int8), (0.0, 0.0), reports
    grid, origin = global_map_from_points(cloud, resolution)
    return grid, origin, reports


def _window_matcher(off, valid, win, inner: int, search: int,
                    slam: SlamConfig, resolution: float, device):
    """One point set (offsets [P, 2] from the window's inner centre, valid
    [P]) matched into a window [side, side] with the reference merge's
    settings: a sharp 2-cell scoring radius (the 1 m ICP threshold is a
    correspondence gate, not an alignment tolerance), no fitness gate, one
    point enough, prior 0.02. Returns a WindowMatch of [1] tensors."""
    def t(a):
        return torch.as_tensor(a, device=device)[None]
    a = torch.full((1,), (inner - 1) / 2.0, device=device)
    return match_scan_window(
        t(off[:, 0]), t(off[:, 1]), t(valid), t(win), (a, a), inner, search,
        n_theta=slam.scanmatch_angles,
        theta_range=slam.scanmatch_angle_range, resolution=resolution,
        inlier_radius_cells=2, fitness_min=0.0, min_points=1,
        prior_weight=0.02)
