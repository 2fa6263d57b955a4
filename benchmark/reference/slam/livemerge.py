"""Continuous in-engine map merging and the per-agent frame tracker
(swarm_tpu/slam/livemerge.py), batched over agents.

At the merge cadence each agent's current scan is matched
(slam/scanmatch.match_scan_window) against a window of the global map as of
the previous step; the correction is applied to this step's raster pose
and, damped and clamped, accumulated into the agent's persistent
merge_dx/dy/dyaw (`merge_increments`). Events attempt one rotating chunk of
the fleet (`scan_merge_chunked`); agents failing repeatedly get a wide
re-acquisition pass (`scan_merge_recover`). Every step the frame tracker
de-rotates and re-scales each agent's raw reported displacement by its
frame estimates (`frame_advance`), and verified events innovate those
estimates (`frame_innovate`).

The cadence and the chunk are host integers here (the engine keeps the
step count on the host), so an off-cadence step runs none of this and a
merge step slices its chunk without a device sync. The wide recovery pass
needs one host read of "does any escalated agent need it"
(`slam.merge_recover_after > 0` only; the preset leaves it off). The
yaw-rate bias estimator (`merge_bias_ff` every step, `merge_bias_update` at
a verified event; `slam.merge_bias_alpha > 0`, off in every preset) feeds
a per-meter yaw rate forward into the raster yaw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference._device import div
from benchmark.reference.config import SwarmConfig
from benchmark.reference.models.scan import scan_angles
from benchmark.reference.slam.scanmatch import (WindowMatch, _crop,
                                            match_scan_window)
from benchmark.reference.utils.angles import wrap_pi


def merge_window_side(cfg: SwarmConfig) -> int:
    """Full side length of the cropped global-map window, in cells."""
    return cfg.slam.merge_window_cells + 2 * cfg.slam.merge_search_cells


def scan_merge(logodds, rx, ry, ryaw, scan_dist, alive, cfg: SwarmConfig,
               band_row0: int | None = None, band_col0: int | None = None,
               win_bounds=None, n_theta: int | None = None,
               theta_range: float | None = None,
               theta_prior_scale: float | None = None) -> WindowMatch:
    """Batched scan-to-map matching of every agent's current sweep against
    `logodds` (the map BEFORE this step's raster). rx, ry, ryaw [N]
    reported pose with every correction applied; scan_dist [N, R]. Window
    placement as the reference's: agent-centred, clamped to the array (and
    to `win_bounds` = (rmin, rmax, cmin, cmax) [N] int each, global cells,
    when given); band_row0 / band_col0 offset a band or tile of a sharded
    grid. Only the [N, side, side] windows are converted to mass."""
    slam = cfg.slam
    grid = cfg.grid
    sens = cfg.sensors
    inner = slam.merge_window_cells
    search = slam.merge_search_cells
    side = inner + 2 * search
    res = grid.resolution

    r_scan = scan_dist.shape[-1]
    rel = scan_angles(r_scan, rx.dtype, rx.device)
    valid = ((scan_dist > sens.min_range) & (scan_dist <= sens.max_range)
             & alive[:, None])
    ang = ryaw[:, None] + rel[None, :]
    off_x = scan_dist * torch.cos(ang)
    off_y = scan_dist * torch.sin(ang)

    n_rows, n_cols = logodds.shape
    gx = div(rx - grid.origin_x, res)                    # float cell coords
    gy = div(ry - grid.origin_y, res)
    r0 = 0 if band_row0 is None else band_row0
    c0 = 0 if band_col0 is None else band_col0
    sxg = torch.clamp(torch.floor(gx).to(torch.int32) - side // 2,
                      c0, c0 + (n_cols - side))
    syg = torch.clamp(torch.floor(gy).to(torch.int32) - side // 2,
                      r0, r0 + (n_rows - side))
    if win_bounds is not None:
        rmin, rmax, cmin, cmax = win_bounds
        lo_r = torch.clamp(rmin, r0, r0 + (n_rows - side))
        hi_r = torch.clamp(torch.maximum(rmax - side, lo_r), max=r0 + (
            n_rows - side))
        lo_c = torch.clamp(cmin, c0, c0 + (n_cols - side))
        hi_c = torch.clamp(torch.maximum(cmax - side, lo_c), max=c0 + (
            n_cols - side))
        syg = torch.minimum(torch.maximum(syg, lo_r), hi_r)
        sxg = torch.minimum(torch.maximum(sxg, lo_c), hi_c)
    min_pts = min(slam.merge_min_points, max(6, r_scan // 4))

    mass = occupancy_mass(_crop(logodds, syg - r0, sxg - c0, side), grid)
    # agent float coords inside the inner region; -0.5 aligns the splat's
    # integer-centred cells with the raster's floor() binning
    ax = gx - sxg - search - 0.5
    ay = gy - syg - search - 0.5
    return match_scan_window(
        off_x, off_y, valid, mass, (ax, ay), inner, search,
        n_theta=(slam.merge_angles if n_theta is None else n_theta),
        theta_range=(slam.merge_angle_range if theta_range is None
                     else theta_range),
        resolution=res,
        inlier_radius_cells=slam.merge_inlier_radius_cells,
        fitness_min=slam.merge_fitness_min,
        min_points=min_pts,
        prior_weight=slam.merge_prior_weight,
        theta_prior_scale=(slam.merge_theta_prior_scale
                           if theta_prior_scale is None
                           else theta_prior_scale),
        distinct_margin=slam.merge_distinct_margin,
        distinct_radius=slam.merge_distinct_radius)


def occupancy_mass(logodds, grid) -> torch.Tensor:
    """Occupancy mass in [0, 1] (~saturates at 2 endpoint hits) of log-odds
    cells, as float32. The quotient is taken in the grid's dtype: on a
    bfloat16 grid the jitted reference divides by bf16(2 hit) = 1.703125
    and rounds the quotient to bf16 before its float32 cast (ROADMAP C17),
    which `div` does with a bf16 divisor tensor."""
    return torch.clamp(div(logodds, 2.0 * grid.logodds_hit), 0.0,
                       1.0).to(torch.float32)


def chunk_attempt(cfg: SwarmConfig, event: int, n_global: int, n_loc: int,
                  id0: int | None = None, device=None):
    """Which local agents does merge event `event` attempt to match?
    Returns (full, lstart, sl, mask): `full` — chunking off, every agent
    is attempted; otherwise `mask` [n_loc] is the attempted set and
    [lstart, lstart + sl) its local slice (host ints)."""
    c = cfg.slam.merge_chunk
    full = (c <= 0 or c >= n_global or n_global % c != 0 or
            (n_loc < n_global and
             (c % n_loc != 0 if c > n_loc else n_loc % c != 0)))
    if full:
        return True, None, None, torch.ones((n_loc,), dtype=torch.bool,
                                            device=device)
    k = n_global // c
    g0 = (int(event) % k) * c
    sl = min(c, n_loc)
    base = 0 if id0 is None else int(id0)
    lstart = min(max(g0 - base, 0), n_loc - sl)
    gids = base + torch.arange(n_loc, dtype=torch.int32, device=device)
    mask = (gids >= g0) & (gids < g0 + c)
    return False, lstart, sl, mask


def scan_merge_chunked(logodds, rx, ry, ryaw, scan_dist, alive,
                       cfg: SwarmConfig, event: int, n_global: int,
                       id0=None, band_row0=None, band_col0=None,
                       win_bounds=None, n_theta=None, theta_range=None,
                       theta_prior_scale: float | None = None
                       ) -> WindowMatch:
    """Rotating-chunk scan merge: event `e` matches only the global-agent
    chunk [(e mod K)*c, ... + c), c = slam.merge_chunk, K = n_global / c.
    Returns a full-length WindowMatch with ok=False outside the chunk;
    falls back to the full fleet when chunking does not apply."""
    n_loc = rx.shape[0]
    full, lstart, sl, mask = chunk_attempt(cfg, event, n_global, n_loc,
                                           id0, rx.device)
    kw = dict(band_row0=band_row0, band_col0=band_col0, n_theta=n_theta,
              theta_range=theta_range, theta_prior_scale=theta_prior_scale)
    if full:
        return scan_merge(logodds, rx, ry, ryaw, scan_dist, alive, cfg,
                          win_bounds=win_bounds, **kw)

    def sub(a):
        return a[lstart:lstart + sl]

    wb = None if win_bounds is None else tuple(sub(b) for b in win_bounds)
    m = scan_merge(logodds, sub(rx), sub(ry), sub(ryaw), sub(scan_dist),
                   sub(alive), cfg, win_bounds=wb, **kw)

    def put(v):
        out = torch.zeros((n_loc,), dtype=v.dtype, device=v.device)
        out[lstart:lstart + sl] = v
        return out

    m = WindowMatch(*(put(v) for v in m))
    return m._replace(ok=m.ok & mask)


def merge_zero(n: int, device=None) -> WindowMatch:
    """The no-op result for agents and steps that are not matched."""
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    f = torch.zeros((n,), dtype=torch.bool, device=device)
    return WindowMatch(ddx=z, ddy=z, ddtheta=z, fitness=z, ok=f,
                       ddtheta_meas=z, distinct=f, distinct_gap=z)


def _rail(m: WindowMatch, slam):
    """Matched, but the persistent increment would hit its clamp."""
    return m.ok & ((torch.abs(m.ddx) > slam.merge_max_step_m) |
                   (torch.abs(m.ddy) > slam.merge_max_step_m) |
                   (torch.abs(m.ddtheta) > slam.merge_max_step_rad))


def scan_merge_recover(match_map, rx, ry, ryaw, scan_dist, alive,
                       cfg: SwarmConfig, event: int, n_global: int,
                       fail_count, id0=None, band_row0=None,
                       band_col0=None, win_bounds=None):
    """Chunked scan merge with escalating re-acquisition: agents whose
    consecutive-failure count reached slam.merge_recover_after get a wide
    second match (more rotations, a ring of translation offsets) when the
    normal one rejects them. Returns (m, attempted, recovered), [n_loc]
    each, as the reference's."""
    n_loc = rx.shape[0]
    slam = cfg.slam
    kw = dict(event=event, n_global=n_global, id0=id0, band_row0=band_row0,
              band_col0=band_col0, win_bounds=win_bounds)
    m = scan_merge_chunked(match_map, rx, ry, ryaw, scan_dist, alive, cfg,
                           **kw)
    _, _, _, attempted = chunk_attempt(cfg, event, n_global, n_loc, id0,
                                       rx.device)
    recovered = torch.zeros((n_loc,), dtype=torch.bool, device=rx.device)
    if slam.merge_recover_after <= 0:
        return m, attempted, recovered

    esc = fail_count >= slam.merge_recover_after
    need = bool(torch.any(esc & attempted & alive & ~m.ok))   # host read
    if need:
        offs = [(0.0, 0.0)]
        r_off = slam.merge_recover_offset_m
        if r_off > 0.0:
            offs += [(r_off, 0.0), (-r_off, 0.0), (0.0, r_off),
                     (0.0, -r_off), (r_off, r_off), (r_off, -r_off),
                     (-r_off, r_off), (-r_off, -r_off)]
        mw = None
        for ox, oy in offs:
            mk = scan_merge_chunked(
                match_map, rx + ox, ry + oy, ryaw, scan_dist, alive, cfg,
                n_theta=slam.merge_recover_angles,
                theta_range=slam.merge_recover_angle_range,
                theta_prior_scale=slam.merge_recover_theta_prior_scale,
                **kw)
            mk = mk._replace(ddx=mk.ddx + ox, ddy=mk.ddy + oy)
            if mw is None:
                mw = mk
            else:
                neg = torch.full_like(mw.fitness, -1.0)
                sel = torch.where(mk.ok, mk.fitness, neg) > \
                    torch.where(mw.ok, mw.fitness, neg)
                mw = WindowMatch(*(torch.where(sel, nk, nb)
                                   for nk, nb in zip(mk, mw)))
    else:
        mw = merge_zero(n_loc, rx.device)
    take = esc & ~m.ok & mw.ok & alive & \
        (mw.fitness >= slam.merge_recover_fit_min)
    recovered = take | (esc & _rail(m, slam) & alive)
    m = WindowMatch(*(torch.where(take, w, v) for w, v in zip(mw, m)))
    return m._replace(ok=m.ok | take), attempted, recovered


def merge_fail_update(fail_count, m: WindowMatch, attempted, recovered,
                      alive, cfg: SwarmConfig):
    """Consecutive-failure counter driving the escalation: an attempted
    live agent's event is bad when rejected, or applied but railing
    without the recovery claiming it; bad increments, good (or recovered)
    resets, unattempted agents carry their count."""
    bad = ~m.ok | (_rail(m, cfg.slam) & ~recovered)
    tried = attempted & alive
    return torch.where(tried,
                       torch.where(bad & ~recovered, fail_count + 1,
                                   torch.zeros_like(fail_count)),
                       fail_count)


class FrameState(NamedTuple):
    """Per-agent frame-tracker state, all [N] float32."""
    theta: torch.Tensor      # estimated frame rotation (rad)
    scale_dev: torch.Tensor  # estimated velocity scale - 1
    rate: torch.Tensor       # per-meter frame-yaw rate (rad/m)
    px: torch.Tensor         # last RAW reported position (velocity tap)
    py: torch.Tensor
    ax: torch.Tensor         # corrected path since last verified event
    ay: torch.Tensor
    lx: torch.Tensor         # leftover carry (un-persisted correction)
    ly: torch.Tensor
    qy: torch.Tensor         # projection-rotation quantum at last event
    nacc: torch.Tensor       # accumulated -cross(a, r) innovation numerator
    dacc: torch.Tensor       # accumulated |a|^2 lever arm
    sacc: torch.Tensor       # accumulated dot(a, r) scale numerator
    gskip: torch.Tensor      # consecutive turn-gate discards


def frame_init(n: int, px=None, py=None, device=None) -> FrameState:
    def z():
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return FrameState(
        theta=z(), scale_dev=z(), rate=z(),
        px=z() if px is None else px.to(torch.float32).clone(),
        py=z() if py is None else py.to(torch.float32).clone(),
        ax=z(), ay=z(), lx=z(), ly=z(), qy=z(), nacc=z(), dacc=z(),
        sacc=z(), gskip=z())


def frame_add(fs: FrameState, d: FrameState) -> FrameState:
    """leaf + delta, leafwise."""
    return FrameState(*(a + b for a, b in zip(fs, d)))


def frame_theta_q(theta, cfg: SwarmConfig):
    """Scan-projection de-rotation, quantized to merge_frame_derot_quant."""
    dq = cfg.slam.merge_frame_derot_quant
    if dq <= 0.0:
        return theta
    return torch.round(div(theta, dq)) * dq


def frame_advance(fs: FrameState, raw_x, raw_y, alive, cfg: SwarmConfig):
    """Per-step continuous frame correction: D_corr = (1 + scale_dev)
    R(-theta) D_rep, applied as a merge_dx/dy increment; theta advances by
    the learned per-meter rate. raw_x/y: this step's RAW reported position.
    Returns (add_x, add_y, deltas: FrameState) for `frame_add`."""
    slam = cfg.slam
    dpx = raw_x - fs.px
    dpy = raw_y - fs.py
    # teleport / first-packet guard: an oversized delta only rebases
    ok = alive & (dpx * dpx + dpy * dpy <= slam.merge_frame_max_step_m ** 2)
    c = torch.cos(fs.theta)
    s = torch.sin(fs.theta)
    sc = 1.0 + fs.scale_dev
    cdx = sc * (c * dpx + s * dpy)
    cdy = sc * (c * dpy - s * dpx)
    z = torch.zeros_like(dpx)
    add_x = torch.where(ok, cdx - dpx, z)
    add_y = torch.where(ok, cdy - dpy, z)
    deltas = FrameState(
        theta=torch.where(ok, fs.rate * torch.sqrt(cdx * cdx + cdy * cdy), z),
        scale_dev=z, rate=z, px=dpx, py=dpy,
        ax=torch.where(ok, cdx, z), ay=torch.where(ok, cdy, z),
        lx=z, ly=z, qy=z, nacc=z, dacc=z, sacc=z, gskip=z)
    return add_x, add_y, deltas


def frame_innovate(fs: FrameState, gate_yaw, m: WindowMatch, upd,
                   inc_dx, inc_dy, cfg: SwarmConfig,
                   recovered=None) -> FrameState:
    """Event-time innovation of the frame tracker; returns DELTAS for
    `frame_add`. With a = the corrected path since the last verified event
    and r = the residual over that window: delta_theta = -cross(a, r)/|a|^2
    and delta_scale = dot(a, r)/|a|^2, accumulated over windows until the
    lever reaches merge_frame_inno_path_m (reference docstring for the
    derivation and the gates: fitness, turn, sub-window lever)."""
    slam = cfg.slam
    rx = m.ddx - fs.lx
    ry = m.ddy - fs.ly
    a2 = fs.ax * fs.ax + fs.ay * fs.ay
    if slam.merge_frame_turn_gate > 0.0:
        straight_raw = (torch.abs(wrap_pi(gate_yaw - fs.qy)) <=
                        slam.merge_frame_turn_gate)
        if slam.merge_frame_turn_starve > 0:
            straight = straight_raw | (fs.gskip >=
                                       slam.merge_frame_turn_starve)
        else:
            straight = straight_raw
    else:
        straight = torch.ones_like(upd)
    sub_ok = upd & straight & m.distinct & \
        (a2 >= slam.merge_frame_min_path_m ** 2) & \
        (m.fitness >= slam.merge_frame_fit_min)
    if recovered is not None:
        sub_ok = sub_ok & ~recovered
    z = torch.zeros_like(fs.theta)
    nacc = fs.nacc + torch.where(sub_ok, -(fs.ax * ry - fs.ay * rx), z)
    sacc = fs.sacc + torch.where(sub_ok, fs.ax * rx + fs.ay * ry, z)
    dacc = fs.dacc + torch.where(sub_ok, a2, z)
    fire = dacc >= slam.merge_frame_inno_path_m ** 2
    inv = 1.0 / torch.clamp_min(dacc, 1e-9)
    # the reference's bound is float32(clamp) / float32(max(gain, 1e-6))
    lim = float(np.float32(slam.merge_frame_inno_clamp) /
                np.float32(max(slam.merge_frame_gain, 1e-6)))
    d_th = torch.clamp(nacc * inv, -lim, lim)
    th_step = torch.clamp(slam.merge_frame_gain * d_th,
                          -slam.merge_frame_inno_clamp,
                          slam.merge_frame_inno_clamp)
    new_theta = wrap_pi(fs.theta + th_step)
    new_scale = torch.clamp(
        fs.scale_dev + slam.merge_frame_scale_gain * sacc * inv,
        -slam.merge_frame_scale_clamp, slam.merge_frame_scale_clamp)
    new_rate = torch.clamp(
        fs.rate + slam.merge_frame_rate_gain * d_th / torch.sqrt(
            torch.clamp_min(dacc, slam.merge_frame_min_path_m ** 2)),
        -slam.merge_frame_rate_max, slam.merge_frame_rate_max)

    def on(cond, v, other=z):
        return torch.where(cond, v, other)

    return FrameState(
        theta=on(fire, new_theta - fs.theta),
        scale_dev=on(fire, new_scale - fs.scale_dev),
        rate=on(fire, new_rate - fs.rate),
        px=z, py=z,
        ax=on(upd, -fs.ax), ay=on(upd, -fs.ay),
        lx=on(upd, (m.ddx - inc_dx) - fs.lx),
        ly=on(upd, (m.ddy - inc_dy) - fs.ly),
        qy=on(upd, gate_yaw - fs.qy),
        nacc=on(fire, -fs.nacc, on(sub_ok, nacc - fs.nacc)),
        dacc=on(fire, -fs.dacc, on(sub_ok, dacc - fs.dacc)),
        sacc=on(fire, -fs.sacc, on(sub_ok, sacc - fs.sacc)),
        gskip=on(upd & ~straight, torch.ones_like(z),
                 on(upd & straight, -fs.gskip)))


def merge_increments(m: WindowMatch, upd, recovered, cfg: SwarmConfig):
    """Persistent correction increments (merge_dx/dy/dyaw deltas) with the
    recovery-aware clamps; `upd` = m.ok & alive. Returns (fdx, fdy, fdth,
    inc_dx, inc_dy, inc_dth): the full correction for this step's raster
    and the damped, clamped persistent part."""
    slam = cfg.slam
    z = torch.zeros_like(m.ddx)
    fdx = torch.where(upd, m.ddx, z)
    fdy = torch.where(upd, m.ddy, z)
    fdth = torch.where(upd, m.ddtheta, z)
    cmx = slam.merge_max_step_m
    cmr = slam.merge_max_step_rad
    if slam.merge_recover_after <= 0:
        inc_dx = slam.merge_damping * torch.clamp(fdx, -cmx, cmx)
        inc_dy = slam.merge_damping * torch.clamp(fdy, -cmx, cmx)
        inc_dth = slam.merge_yaw_damping * torch.clamp(fdth, -cmr, cmr)
        return fdx, fdy, fdth, inc_dx, inc_dy, inc_dth

    def pick(a, b):
        return torch.where(recovered, torch.full_like(z, a),
                           torch.full_like(z, b))

    cmx_a = pick(slam.merge_recover_max_step_m, cmx)
    cmr_a = pick(slam.merge_recover_max_step_rad, cmr)
    yaw_damp = pick(slam.merge_damping, slam.merge_yaw_damping)
    inc_dx = slam.merge_damping * torch.clamp(fdx, -cmx_a, cmx_a)
    inc_dy = slam.merge_damping * torch.clamp(fdy, -cmx_a, cmx_a)
    inc_dth = yaw_damp * torch.clamp(fdth, -cmr_a, cmr_a)
    return fdx, fdy, fdth, inc_dx, inc_dy, inc_dth


def merge_bias_ff(yaw_rate, dist_mark, total_dist, cfg: SwarmConfig):
    """The feed-forward yaw accrued since each agent's last rate rebase:
    the estimated per-meter yaw-rate bias times the distance travelled
    since the mark, that distance bounded by `merge_bias_ff_max_m`. Added
    to the raster yaw every step. Elementwise, so the fused and sharded
    engines compute the same values."""
    if cfg.slam.merge_bias_alpha <= 0.0:
        return torch.zeros_like(total_dist)
    led = torch.clamp_max(total_dist - dist_mark,
                          cfg.slam.merge_bias_ff_max_m)
    return yaw_rate * led


def merge_bias_update(yaw_rate, dist_mark, total_dist, m: WindowMatch, upd,
                      cfg: SwarmConfig, quant_resid=None):
    """The per-agent yaw-rate bias update at a verified merge event
    (swarm_tpu/slam/livemerge.py `merge_bias_update`, where the reasoning
    is). The observation is the matcher's raw-map rotation re-measurement
    `m.ddtheta_meas`, debiased by the reported yaw's quantisation residual
    `quant_resid` and clipped to `merge_bias_level_cap`; a verified event
    folds `merge_bias_level_damp` of it into the level, and where the
    agent travelled at least `merge_bias_min_dist` since its mark the rate
    takes `merge_bias_alpha` of the observed per-meter slope (clipped to
    +-merge_bias_max) and the mark rebases, the accrued feed-forward folded
    into the level. Returns deltas (fold, rate_delta, mark_delta) [N], to
    add to merge_dyaw, merge_yaw_rate and merge_dist_mark."""
    slam = cfg.slam
    if slam.merge_bias_alpha <= 0.0:
        z = torch.zeros_like(yaw_rate)
        return z, z, z
    led = total_dist - dist_mark
    led_ff = torch.clamp_max(led, slam.merge_bias_ff_max_m)
    dth = m.ddtheta_meas if quant_resid is None else \
        m.ddtheta_meas + quant_resid
    dth_c = torch.clamp(dth, -slam.merge_bias_level_cap,
                        slam.merge_bias_level_cap)
    level = slam.merge_bias_level_damp * dth_c
    rate_obs = dth_c / torch.clamp_min(led, slam.merge_bias_min_dist)
    new_rate = torch.clamp(yaw_rate + slam.merge_bias_alpha * rate_obs,
                           -slam.merge_bias_max, slam.merge_bias_max)
    gate = upd & (led >= slam.merge_bias_min_dist)
    zero = torch.zeros_like(yaw_rate)
    fold = torch.where(upd, level, zero) + \
        torch.where(gate, yaw_rate * led_ff, zero)
    return (fold, torch.where(gate, new_rate - yaw_rate, zero),
            torch.where(gate, led, zero))
