"""Correlative scan-to-window matching (swarm_tpu/slam/scanmatch.py
`WindowMatch`, `match_scan_window`), batched over agents.

The JAX function matches ONE agent and the merge vmaps it over agents
(slam/livemerge.py:151); here the agent axis is an explicit leading batch
dimension B of every input and output. Each agent's current scan is scored
against a window of the global map at every (rotation, translation)
hypothesis at once:
- the bilinear splat of the rotated scan points is one batched one-hot
  matmul, [B*A, S, P] @ [B*A, P, S] (A rotations, P scan points, S the inner
  window side);
- the separable max dilation by the inlier radius is two `max_pool2d`
  passes, (2r+1, 1) then (1, 2r+1), stride 1, padding r; their implicit
  -inf padding is `reduce_window`'s;
- the translation scores are a cross-correlation of each rotated splat
  with its agent's dilated window, one grouped `conv2d` with a group per
  agent (`_scores`). The JAX package's im2col form, a bmm over `unfold`ed
  patches (`_scores_im2col`), computes the same scores and measured about
  6x slower on an H100 at the merge chunk's shapes (PERF.md); it stays
  only as the reference the tests and chip_smoke.py hold `_scores` to;
- then the zero-motion prior, the first-max argmax, the parabolic
  refinement in translation and rotation, the inlier fitness, the raw-map
  rotation re-measurement and the peak-distinctness test.

The merge matcher is XLA code in the JAX package, not a Pallas kernel, so
it is torch ops here. TF32 is off (`_device`); matmul sums run in another
order than XLA's, so scores differ from the JAX CPU run in the last bits
(tests/test_torch_merge.py states the tolerances).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference._device import div
from benchmark.reference.config import GridConfig, SlamConfig
from benchmark.reference.utils.angles import linspace_f32

class WindowMatch(NamedTuple):
    """Result of the scan-to-window alignment, [B] per field (field
    meanings as in the reference's WindowMatch)."""
    ddx: torch.Tensor           # metres — add to the reported x
    ddy: torch.Tensor
    ddtheta: torch.Tensor       # radians — add to the reported yaw
    fitness: torch.Tensor       # matched fraction of scan points
    ok: torch.Tensor            # bool — fitness gate (ref: >= 0.6)
    ddtheta_meas: torch.Tensor  # raw-map rotation re-measurement
    distinct: torch.Tensor      # bool — peak-distinctness verdict
    distinct_gap: torch.Tensor  # raw normalised peak gap (+inf when off)


def _splat(px, py, vf, ax, ay, thetas, s_in: int):
    """Bilinear splat of every agent's scan points at every rotation:
    [B, A, s_in, s_in] = Yv^T @ X with Yv[p] = valid_p * y-stamp and X[p] =
    x-stamp (one-hot rows, so taps outside the window drop)."""
    ct = torch.cos(thetas)[None, :, None]
    st = torch.sin(thetas)[None, :, None]
    px, py = px[:, None, :], py[:, None, :]
    x = ax[:, None, None] + px * ct - py * st               # [B, A, P]
    y = ay[:, None, None] + px * st + py * ct
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    ii = torch.arange(s_in, dtype=torch.int32, device=x.device)
    y0, x0 = y0[..., None], x0[..., None]
    yv = ((ii == y0) * (1.0 - fy) + (ii == y0 + 1) * fy) * \
        vf[:, None, :, None]
    xv = (ii == x0) * (1.0 - fx) + (ii == x0 + 1) * fx
    return torch.matmul(yv.transpose(-1, -2), xv)


def _dilate(mass, r: int):
    """Separable max filter of side 2r+1 ('SAME', -inf padding)."""
    d = F.max_pool2d(mass[:, None], (2 * r + 1, 1), stride=1,
                     padding=(r, 0))
    return F.max_pool2d(d, (1, 2 * r + 1), stride=1, padding=(0, r))[:, 0]


def _scores(rot, dil):
    """Cross-correlation of each agent's rotated splats [B, A, s, s] with
    its dilated window [B, s + 2w, s + 2w] -> [B, A, 2w+1, 2w+1], as one
    grouped convolution (input [1, B, ...], a group of A filters per
    agent)."""
    b, a, s_in, _ = rot.shape
    side_s = dil.shape[-1] - s_in + 1
    out = F.conv2d(dil[None], rot.reshape(b * a, 1, s_in, s_in), groups=b)
    return out.reshape(b, a, side_s, side_s)


def _scores_im2col(rot, dil):
    """`_scores` in the JAX package's im2col form (scanmatch.py:322-335): a
    bmm of the splats against every shifted view of the window. The
    reference `_scores` is held to; not on the engine's path."""
    b, a, s_in, _ = rot.shape
    side_s = dil.shape[-1] - s_in + 1
    patches = F.unfold(dil[:, None], kernel_size=s_in)       # [B, s^2, L]
    out = torch.bmm(rot.reshape(b, a, -1), patches)
    return out.reshape(b, a, side_s, side_s)


def _refine(idx, line):
    """Parabolic sub-step offset around index idx [B] of line [B, L]; 0 on
    the boundary (no parabola there) or a flat neighbourhood."""
    n = line.shape[-1]

    def at(i):
        return line.gather(1, i[:, None])[:, 0]

    c = at(idx)
    lo = at(torch.clamp(idx - 1, 0, n - 1))
    hi = at(torch.clamp(idx + 1, 0, n - 1))
    denom = lo - 2 * c + hi
    off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (lo - hi) / denom,
                      torch.zeros_like(denom))
    off = torch.where((idx > 0) & (idx < n - 1), off, torch.zeros_like(off))
    return torch.clamp(off, -0.5, 0.5)


def _crop(img, r0, c0, side: int):
    """The [B, side, side] windows starting at (r0, c0) [B] of one image
    [H, W] or of each image of a batch [B, H, W]."""
    ar = torch.arange(side, device=img.device)
    rows = (r0.to(torch.int64)[:, None] + ar)[:, :, None]
    cols = (c0.to(torch.int64)[:, None] + ar)[:, None, :]
    if img.dim() == 2:
        return img[rows, cols]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[b, rows, cols]


def match_scan_window(off_x, off_y, valid, window_mass, agent_cell_xy,
                      inner: int, search: int,
                      n_theta: int = 9, theta_range: float = 0.15,
                      resolution: float = 0.05,
                      inlier_radius_cells: int = 2,
                      fitness_min: float = 0.6,
                      min_points: int = 16,
                      prior_weight: float = 0.05,
                      theta_prior_scale: float = 0.1,
                      distinct_margin: float = 0.0,
                      distinct_radius: int = 3) -> WindowMatch:
    """Correlative matching of B agents' current scans against their
    windows of the global map (reference semantics, batched).

    off_x, off_y: [B, R] world-frame offsets of the scan hits from each
      agent's reported position (metres); valid [B, R] trusted hits.
    window_mass: [B, inner + 2*search, inner + 2*search] occupancy mass.
    agent_cell_xy: (ax, ay), [B] each, float cell coords of the agent
      inside its window's inner region.

    Returns the residual corrections as a WindowMatch of [B] tensors.
    """
    f32 = torch.float32
    w = search
    s_in = inner
    dev = window_mass.device
    ax, ay = agent_cell_xy
    b = off_x.shape[0]
    bi = torch.arange(b, device=dev)
    vf = valid.to(f32)
    n_pts = vf.sum(dim=-1)

    thetas = linspace_f32(-theta_range, theta_range, n_theta, dev)
    px = div(off_x.to(f32), resolution)
    py = div(off_y.to(f32), resolution)
    rot = _splat(px, py, vf, ax, ay, thetas, s_in)       # [B, A, s, s]

    # score against the DILATED map mass (radius = the inlier radius)
    dil = _dilate(window_mass.to(f32), inlier_radius_cells)
    scores = _scores(rot, dil)                           # [B, A, 2w+1, 2w+1]

    # zero-motion prior (aperture fix), absolute-scale rotation prior
    side = 2 * w + 1
    ii = torch.arange(side, dtype=f32, device=dev) - w
    pen_xy = (ii[:, None] ** 2 + ii[None, :] ** 2) / max(w, 1) ** 2
    pen_t = div(thetas, theta_prior_scale) ** 2
    scores_raw = scores    # prior-free copy for the distinctness test
    scores = scores - (prior_weight * n_pts)[:, None, None, None] * (
        pen_xy[None, None] + pen_t[None, :, None, None])

    flat = scores.reshape(b, -1).argmax(dim=1)
    ai = torch.div(flat, side * side, rounding_mode="floor")
    rest = flat % (side * side)
    di = torch.div(rest, side, rounding_mode="floor")
    dj = rest % side

    off_j = _refine(dj, scores[bi, ai, di])
    off_i = _refine(di, scores[bi, ai, :, dj])
    dy_cells = di.to(f32) - w + off_i
    dx_cells = dj.to(f32) - w + off_j

    # parabolic sub-step refinement along theta as well
    dth_step = (thetas[1] - thetas[0] if n_theta > 1
                else torch.zeros((), dtype=f32, device=dev))
    ddtheta = thetas[ai] + _refine(ai, scores[bi, :, di, dj]) * dth_step

    # inlier fraction against the same threshold-dilated map
    rot_best = rot[bi, ai]
    win = _crop(dil, di, dj, s_in)
    inliers = (rot_best * torch.clamp_max(win, 1.0)).sum(dim=(-2, -1))
    fitness = torch.where(n_pts > 0, inliers / torch.clamp_min(n_pts, 1e-6),
                          torch.zeros_like(inliers))
    fitness = torch.clamp_max(fitness, 1.0)

    # rotation re-measurement on the RAW mass at the chosen translation
    win_raw = _crop(window_mass.to(f32), di, dj, s_in)
    t_line = torch.bmm(rot.reshape(b, n_theta, -1),
                       win_raw.reshape(b, -1, 1))[..., 0]
    ai_r = t_line.argmax(dim=1)
    ddtheta_meas = thetas[ai_r] + _refine(ai_r, t_line) * dth_step

    # peak distinctness on the prior-free scores
    if distinct_margin > 0.0:
        jj = torch.arange(side, device=dev)
        far = (torch.abs(jj[None, :, None] - di[:, None, None])
               >= distinct_radius) | \
            (torch.abs(jj[None, None, :] - dj[:, None, None])
             >= distinct_radius)
        ring_max = torch.where(far[:, None], scores_raw,
                               torch.full_like(scores_raw, float("-inf"))
                               ).amax(dim=(1, 2, 3))
        peak_raw = scores_raw[bi, ai, di, dj]
        gap = (peak_raw - ring_max) / torch.clamp_min(n_pts, 1.0)
        distinct = gap >= distinct_margin
    else:
        gap = torch.full((b,), float("inf"), dtype=f32, device=dev)
        distinct = torch.ones((b,), dtype=torch.bool, device=dev)

    return WindowMatch(
        ddx=dx_cells * resolution,
        ddy=dy_cells * resolution,
        ddtheta=ddtheta,
        fitness=fitness,
        ok=(fitness >= fitness_min) & (n_pts >= min_points),
        ddtheta_meas=ddtheta_meas,
        distinct=distinct,
        distinct_gap=gap)


# --------------------------------------------------------------------------
# grid-to-grid matching (swarm_tpu/slam/scanmatch.py:28-197): the offline
# merge's aligner (slam/merge.py), not on the engine's path


class MatchResult(NamedTuple):
    """Transform from a local map into the global one (field meanings as
    in the reference's MatchResult); [] per field, [N] batched."""
    dx: torch.Tensor        # metres
    dy: torch.Tensor
    dtheta: torch.Tensor    # radians
    score: torch.Tensor     # raw correlation peak
    fitness: torch.Tensor   # matched fraction of occupied mass
    ok: torch.Tensor        # bool — fitness gate (ref: >= 0.6)


def _top_k_stable(x, k: int):
    """`jax.lax.top_k` of a 1-D tensor: the k largest values, the lower
    index first among equal values (a stable descending sort;
    `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _rotated_mass_stack(local_occ, thetas, k_points: int):
    """Every rotation hypothesis of a sparse occupancy-mass image [S, S]:
    the top `k_points` cells (ties to the lower flat index, as `top_k`),
    their coordinates rotated about the centre and bilinear-splatted as a
    one-hot matmul -> [A, S, S]."""
    s = local_occ.shape[0]
    c = (s - 1) / 2.0
    dtype = local_occ.dtype
    k_points = min(k_points, local_occ.numel())
    vals, idx = _top_k_stable(local_occ.reshape(-1), k_points)
    py = torch.div(idx, s, rounding_mode="floor").to(dtype)
    px = (idx % s).to(dtype)
    ct = torch.cos(thetas)[:, None]
    st = torch.sin(thetas)[:, None]
    x = c + (px - c) * ct - (py - c) * st                    # [A, P]
    y = c + (px - c) * st + (py - c) * ct
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    ii = torch.arange(s, dtype=torch.int32, device=x.device)
    y0, x0 = y0[..., None], x0[..., None]
    yv = ((ii == y0) * (1.0 - fy) + (ii == y0 + 1) * fy) * vals[:, None]
    xv = (ii == x0) * (1.0 - fx) + (ii == x0 + 1) * fx
    return torch.matmul(yv.to(dtype).transpose(-1, -2), xv.to(dtype))


def _rotate_grid(occ, theta, cfg=None):
    """Rotate an occupancy-mass image [S, S] about its centre by theta,
    bilinear (a gather; out-of-image taps read 0). `cfg` is unused, as in
    the reference."""
    s = occ.shape[0]
    return _bilinear_sample(occ, *_rotated_coords(s, theta, 0.0, 0.0,
                                                  occ.dtype), 0.0)


def _rotated_coords(s: int, theta, dx_cells, dy_cells, dtype):
    """Source coordinates (sx, sy) [S, S] of the warp output(p) =
    src(R(-theta) (p - c - t) + c), c the image centre."""
    c = (s - 1) / 2.0
    dev = theta.device if isinstance(theta, torch.Tensor) else None
    ar = torch.arange(s, dtype=dtype, device=dev)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    px = xx - c - dx_cells
    py = yy - c - dy_cells
    th = torch.as_tensor(theta, dtype=dtype, device=dev)
    ct, st = torch.cos(-th), torch.sin(-th)
    return c + px * ct - py * st, c + px * st + py * ct


def _bilinear_sample(img, sx, sy, fill: float):
    """Bilinear read of img [S, S] at float coords; taps outside the image
    read `fill`."""
    s = img.shape[0]
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = sx - x0
    fy = sy - y0

    def at(yi, xi):
        ok = (xi >= 0) & (xi < s) & (yi >= 0) & (yi < s)
        v = img[torch.clamp(yi, 0, s - 1), torch.clamp(xi, 0, s - 1)]
        return torch.where(ok, v, torch.full_like(v, fill))

    return (at(y0, x0) * (1 - fx) * (1 - fy) +
            at(y0, x0 + 1) * fx * (1 - fy) +
            at(y0 + 1, x0) * (1 - fx) * fy +
            at(y0 + 1, x0 + 1) * fx * fy)


def match_grids(local_occ, global_occ, cfg=None, slam=None,
                fitness_min: float = 0.6,
                icp_threshold_m: float = 1.0) -> MatchResult:
    """The rigid transform aligning `local_occ` [S, S] into `global_occ`
    [S, S] (occupancy mass in [0, 1]): every rotation of
    `slam.scanmatch_angles` over +-`slam.scanmatch_angle_range` scored at
    every translation of +-`slam.scanmatch_window_cells` by one `conv2d`
    (the rotations as its output channels), the first maximum, parabolic
    sub-cell refinement, and ICP's inlier fraction against the global map
    dilated by `icp_threshold_m` as the fitness. Returns the transform
    FROM local TO global (p' = R(dtheta) (p - c) + c + (dx, dy))."""
    cfg = GridConfig() if cfg is None else cfg
    slam = SlamConfig() if slam is None else slam
    w = slam.scanmatch_window_cells
    side = 2 * w + 1
    f32 = torch.float32
    dev = local_occ.device
    local_occ = local_occ.to(f32)
    global_occ = global_occ.to(f32)
    thetas = linspace_f32(-slam.scanmatch_angle_range,
                          slam.scanmatch_angle_range, slam.scanmatch_angles,
                          dev)
    rot = _rotated_mass_stack(local_occ, thetas, slam.scanmatch_points)
    g = F.pad(global_occ, (w, w, w, w))
    scores = F.conv2d(g[None, None], rot[:, None])[0]    # [A, 2w+1, 2w+1]

    flat = torch.argmax(scores.reshape(-1))
    ai = torch.div(flat, side * side, rounding_mode="floor")
    rest = flat % (side * side)
    di = torch.div(rest, side, rounding_mode="floor")
    dj = rest % side
    score = scores.reshape(-1)[flat]
    off_j = _refine_free(dj, scores[ai, di, :])
    off_i = _refine_free(di, scores[ai, :, dj])
    dy_cells = di.to(f32) - w + off_i
    dx_cells = dj.to(f32) - w + off_j

    th_cells = max(1, int(round(icp_threshold_m / cfg.resolution)))
    dil = _dilate(global_occ[None], th_cells)[0]
    dil_p = F.pad(dil, (w, w, w, w))
    s = global_occ.shape[0]
    window = _crop(dil_p, di[None], dj[None], s)[0]
    inliers = (rot[ai] * window).sum()
    mass = rot[ai].sum()
    fitness = torch.where(mass > 0, inliers / torch.clamp_min(mass, 1e-6),
                          torch.zeros_like(mass))
    fitness = torch.clamp_max(fitness, 1.0)
    return MatchResult(
        dx=dx_cells * cfg.resolution, dy=dy_cells * cfg.resolution,
        dtheta=thetas[ai], score=score, fitness=fitness,
        ok=(fitness >= fitness_min) & (mass > 0))


def _refine_free(idx, line):
    """`match_grids`' parabolic offset around idx [] of line [L]: no
    boundary test (the reference's own refine there clips its taps)."""
    n = line.shape[-1]
    c = line[idx]
    lo = line[torch.clamp(idx - 1, 0, n - 1)]
    hi = line[torch.clamp(idx + 1, 0, n - 1)]
    denom = lo - 2 * c + hi
    off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (lo - hi) / denom,
                      torch.zeros_like(denom))
    return torch.clamp(off, -0.5, 0.5)


def match_grids_batch(local_occs, global_occ, cfg=None, slam=None,
                      fitness_min: float = 0.6) -> MatchResult:
    """`match_grids` of N local maps [N, S, S] against one global map,
    one call each (the reference vmaps it); [N] leaves."""
    out = [match_grids(lo, global_occ, cfg, slam, fitness_min)
           for lo in local_occs]
    return MatchResult(*(torch.stack(f) for f in zip(*out)))


def occupancy_mass(tri_grid, cfg: GridConfig = GridConfig()):
    """Tri-state grid -> occupancy mass in [0, 1]: OCCUPIED cells only
    (map_merger's > 50 threshold, map_merger.py:67), float32. The live
    merge's mass of log-odds cells is another function,
    `slam.livemerge.occupancy_mass`."""
    return (tri_grid == cfg.occupied).to(torch.float32)
