"""Scan-to-scan closure measurement (swarm_tpu/slam/closurematch.py,
`SlamConfig.closure_scanmatch`), batched over closure pairs.

When a closure fires, the landmark ring's stored sweep of the earlier
visit is splatted into a window centred on the stored pose, and the
current sweep is matched into it with the port's batched
`match_scan_window` (slam/scanmatch.py). Both sweeps project through their
agents' estimated yaw, so the rotation search covers only the relative
yaw drift. The match gives an SE(2) edge measurement in the stored node's
frame; the fitness gate sends low-overlap pairs back to the coincidence
edge.

The reference vmaps one pair's match over a chunk of pairs and `lax.map`s
over the chunks (its memory bound); here a chunk is the batch axis B of
one `match_scan_window` call, chunks of `slam.closure_match_chunk` pairs
padded with empty pairs as the reference pads them. Divisions by the
resolution are multiplications by its float32 reciprocal, as in the
jitted engine (ROADMAP C15).
"""

from __future__ import annotations

import torch

from swarm_tpu_torch._device import recip32
from swarm_tpu_torch.config import GridConfig, SensorConfig, SlamConfig
from swarm_tpu_torch.models.scan import scan_angles
from swarm_tpu_torch.slam.scanmatch import WindowMatch, match_scan_window
from swarm_tpu_torch.utils.angles import wrap_pi


def splat_points_window(px, py, valid, side: int):
    """Bilinear splat of points (cell coords in the window frame) [..., P]
    into [..., side, side] mass images: the one-hot matmul of the
    reference (out-of-window taps drop because the one-hot compare never
    fires)."""
    f32 = torch.float32
    vf = valid.to(f32)
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    ii = torch.arange(side, dtype=torch.int32, device=px.device)
    y0, x0 = y0[..., None], x0[..., None]
    yv = ((ii == y0) * (1.0 - fy) + (ii == y0 + 1) * fy) * vf[..., None]
    xv = (ii == x0) * (1.0 - fx) + (ii == x0 + 1) * fx
    return torch.matmul(yv.to(f32).transpose(-1, -2), xv.to(f32))


def match_scan_pair(cur_dist, cur_pose, stored_dist, stored_pose,
                    slam: SlamConfig, grid: GridConfig, sens: SensorConfig):
    """Closure pairs -> (WindowMatch, meas [..., 3]). cur_dist / stored_dist
    [B, R] (or [R] for one pair); cur_pose / stored_pose: (x, y, yaw)
    ESTIMATED poses, [B] each (or scalars). The window is centred on the
    stored pose; meas is the edge measurement for (i = stored node,
    j = current node): R(yaw_i)^T (p_j + (ddx, ddy) - p_i) and
    wrap(yaw_j + ddtheta - yaw_i)."""
    one = cur_dist.dim() == 1
    if one:
        cur_dist, stored_dist = cur_dist[None], stored_dist[None]
    dev = cur_dist.device
    f32 = torch.float32

    def vec(v):
        return torch.as_tensor(v, dtype=f32, device=dev).reshape(-1)

    cx, cy, cyaw = (vec(v) for v in cur_pose)
    sx, sy, syaw = (vec(v) for v in stored_pose)
    res = grid.resolution
    inv = recip32(res)
    inner = slam.closure_match_window
    search = slam.closure_match_search
    side = inner + 2 * search
    r_scan = stored_dist.shape[-1]
    rel = scan_angles(r_scan, f32, dev)

    # window: the STORED sweep's endpoints splatted around the stored pose
    # (-0.5 aligns the splat's integer-centred cells with the raster's
    # floor binning, as in livemerge), saturated like the map mass
    match_max = slam.closure_match_max_range
    s_valid = (stored_dist > sens.min_range) & (stored_dist <= match_max)
    s_ang = syaw[:, None] + rel
    spx = (sx[:, None] + stored_dist * torch.cos(s_ang) - grid.origin_x) * inv
    spy = (sy[:, None] + stored_dist * torch.sin(s_ang) - grid.origin_y) * inv
    sgx = (sx - grid.origin_x) * inv
    sgy = (sy - grid.origin_y) * inv
    ox = torch.floor(sgx).to(torch.int32) - side // 2
    oy = torch.floor(sgy).to(torch.int32) - side // 2
    win = splat_points_window(spx - ox[:, None] - 0.5,
                              spy - oy[:, None] - 0.5, s_valid, side)
    win = torch.clamp(win, 0.0, 1.0)

    # the current sweep as offsets about the current agent; points whose
    # zero-hypothesis cell falls outside the inner window are dropped
    # before they are counted
    c_valid = (cur_dist > sens.min_range) & (cur_dist <= match_max)
    c_ang = cyaw[:, None] + rel
    off_x = cur_dist * torch.cos(c_ang)
    off_y = cur_dist * torch.sin(c_ang)
    cgx = (cx - grid.origin_x) * inv
    cgy = (cy - grid.origin_y) * inv
    ax = cgx - ox - search - 0.5
    ay = cgy - oy - search - 0.5
    pxc = ax[:, None] + off_x * inv
    pyc = ay[:, None] + off_y * inv
    c_valid = c_valid & (pxc >= 0) & (pxc < inner - 1) & \
        (pyc >= 0) & (pyc < inner - 1)

    min_pts = min(slam.merge_min_points, max(6, r_scan // 4))
    m = match_scan_window(
        off_x, off_y, c_valid, win, (ax, ay), inner, search,
        n_theta=slam.closure_match_angles,
        theta_range=slam.closure_match_angle_range,
        resolution=res,
        inlier_radius_cells=slam.closure_match_inlier_radius,
        fitness_min=slam.merge_fitness_min,
        min_points=min_pts,
        prior_weight=slam.closure_match_prior_weight,
        distinct_margin=slam.merge_distinct_margin,
        distinct_radius=slam.merge_distinct_radius)

    dxw = (cx + m.ddx) - sx
    dyw = (cy + m.ddy) - sy
    ct, st = torch.cos(syaw), torch.sin(syaw)
    meas = torch.stack([ct * dxw + st * dyw, -st * dxw + ct * dyw,
                        wrap_pi((cyaw + m.ddtheta) - syaw)], dim=-1)
    if one:
        return WindowMatch(*(f[0] for f in m)), meas[0]
    return m, meas


def match_scan_pairs_batch(cur_dist, cur_poses, stored_dist, stored_poses,
                           slam: SlamConfig, grid: GridConfig,
                           sens: SensorConfig):
    """Batched pair matching: cur_dist [M, R], cur_poses ([M], [M], [M]),
    stored likewise. Returns (WindowMatch with [M] leaves, meas [M, 3]).
    Pairs go through in chunks of `slam.closure_match_chunk` (the
    reference's memory bound: one chunk's windows live at a time); above
    one chunk the pairs are padded to whole chunks with zeros, as the
    reference pads them."""
    m = cur_dist.shape[0]
    chunk = max(1, slam.closure_match_chunk)
    leaves = (cur_dist, *cur_poses, stored_dist, *stored_poses)
    if m <= chunk:
        return _match_leaves(leaves, slam, grid, sens)
    pad = (-m) % chunk
    if pad:
        leaves = tuple(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                       for x in leaves)
    outs = [_match_leaves(tuple(x[a:a + chunk] for x in leaves), slam, grid,
                          sens) for a in range(0, m + pad, chunk)]
    match = WindowMatch(*(torch.cat(f)[:m] for f in
                          zip(*(o[0] for o in outs))))
    return match, torch.cat([o[1] for o in outs])[:m]


def _match_leaves(leaves, slam, grid, sens):
    cd, cx, cy, cw, sd, sx, sy, sw = leaves
    return match_scan_pair(cd, (cx, cy, cw), sd, (sx, sy, sw), slam, grid,
                           sens)
