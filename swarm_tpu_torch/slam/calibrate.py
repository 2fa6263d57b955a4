"""Per-agent odometry drift calibration from absolute position fixes
(swarm_tpu/slam/calibrate.py).

The drift model's two parameters per agent, a yaw-rate bias (rad per
metre travelled) and a translation scale, are fitted offline against the
anchored merge's fitness-verified fixes: every candidate bias of a grid
re-integrates the odometry chain and is scored against the fixes
(Geman-McClure robustified when asked), the best gets a parabolic
refinement, the scale is the closed-form least squares of the bias-
corrected chain, and optional Cauchy IRLS rounds re-weight the fixes.
`relocalize_fixes` re-matches the logged sweeps against the frozen anchor
map from a calibrated chain (slam/livemerge.scan_merge), and
`calibrate_reloc` iterates the two.

The reference scores the candidates with a `lax.map`; here all candidates
are one [B, N, T] batch. Chains are float32 on the device; the results
come back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.utils.angles import linspace_f32


def _chain_parts(xy):
    """Segment deltas [N, T-1, 2], their lengths, and the distance
    travelled before each segment [N, T-1]."""
    d = torch.diff(xy, dim=1)
    seg = torch.linalg.vector_norm(d, dim=-1)
    dist = torch.cat([torch.zeros_like(seg[:, :1]),
                      torch.cumsum(seg[:, :-1], dim=1)], dim=1)
    return d, seg, dist


def _integrate(x0, rx):
    """x0 [..., 1] + the running sum of rx [..., T-1], a 0 first."""
    return x0 + torch.cat([torch.zeros_like(rx[..., :1]),
                           torch.cumsum(rx, dim=-1)], dim=-1)


def _score_biases(xy, w_obs, z_xy, bias_lo: float, bias_hi: float,
                  n_bias: int, inv_c2: float = 0.0):
    """Robustified SSE of every candidate yaw-rate bias per agent. xy
    [N, T, 2] logged positions, w_obs [N, T] fix weights (0 where no
    fix), z_xy [N, T, 2] fixes; inv_c2 the Geman-McClure 1/c^2 (0: plain
    SSE). Returns (biases [B], score [B, N])."""
    biases = linspace_f32(bias_lo, bias_hi, n_bias, xy.device)
    d, _, dist = _chain_parts(xy)
    a = biases[:, None, None] * dist                     # [B, N, T-1]
    ca, sa = torch.cos(a), torch.sin(a)
    rx = ca * d[..., 0] - sa * d[..., 1]
    ry = sa * d[..., 0] + ca * d[..., 1]
    px = _integrate(xy[:, :1, 0], rx)
    py = _integrate(xy[:, :1, 1], ry)
    e2 = (px - z_xy[..., 0]) ** 2 + (py - z_xy[..., 1]) ** 2
    rho = e2 / (1.0 + e2 * inv_c2)
    return biases, (w_obs * rho).sum(dim=-1)


def _reintegrate(xy, yaw, bias, scale):
    """The chain [N, T, ...] under per-agent (bias [N], scale [N]):
    (positions [N, T, 2], yaw [N, T], distance at each pose [N, T])."""
    d, seg, dist = _chain_parts(xy)
    a = bias[:, None] * dist
    ca, sa = torch.cos(a), torch.sin(a)
    rx = scale[:, None] * (ca * d[..., 0] - sa * d[..., 1])
    ry = scale[:, None] * (sa * d[..., 0] + ca * d[..., 1])
    px = _integrate(xy[:, :1, 0], rx)
    py = _integrate(xy[:, :1, 1], ry)
    dist_at = torch.cat([torch.zeros_like(seg[:, :1]),
                         torch.cumsum(seg, dim=1)], dim=1)
    return torch.stack([px, py], dim=-1), yaw + bias[:, None] * dist_at, \
        dist_at


def _fit_scale(xy_cal, w_obs, z_xy):
    """Closed-form per-agent scale of the bias-corrected chain: <z - p0,
    v> / <v, v> over the weighted fixes, v = p - p0."""
    p0 = xy_cal[:, :1, :]
    v = xy_cal - p0
    num = (w_obs[..., None] * v * (z_xy - p0)).sum(dim=(1, 2))
    den = (w_obs[..., None] * v * v).sum(dim=(1, 2))
    return num / torch.clamp_min(den, 1e-9)


def calibrate_chains(ex, ey, eyaw, obs_mask, zx, zy,
                     bias_range: float = 0.015, n_bias: int = 61,
                     scale_band: float = 0.01, min_obs: int = 5,
                     robust_c: float = 0.0, irls_rounds: int = 0,
                     device=None):
    """Fit (yaw-rate bias, translation scale) per agent and return the
    calibrated chains. ex, ey, eyaw [T, N] logged raw estimates
    (step-major); obs_mask [T, N] the steps with a verified fix; zx, zy
    [T, N] the fixes. robust_c (metres) and irls_rounds: the robust fit
    (0 / 0 = plain least squares). Agents with fewer than `min_obs` fixes
    keep bias 0 and scale 1. Returns a dict of numpy arrays: bias [N],
    scale [N], n_obs [N], x / y / yaw / dist [T, N]. Runs on `device` (the
    card when None)."""
    device = default_device(device)
    f32 = torch.float32

    def tn(a):
        return torch.as_tensor(np.asarray(a), device=device).T

    xy = torch.stack([tn(ex), tn(ey)], dim=-1).to(f32)
    yaw = tn(eyaw).to(f32)
    w0 = tn(obs_mask).to(f32)
    z = torch.stack([tn(zx), tn(zy)], dim=-1).to(f32)
    n_obs = w0.sum(dim=1)
    inv_c2 = (1.0 / (robust_c * robust_c)) if robust_c > 0.0 else 0.0
    enough = n_obs >= min_obs

    w = w0
    for irls in range(irls_rounds + 1):
        biases, sse = _score_biases(xy, w, z, -bias_range, bias_range,
                                    n_bias, inv_c2)       # [B], [B, N]
        k = torch.argmin(sse, dim=0)                      # [N]
        km = torch.clamp(k - 1, 0, n_bias - 1)
        kp = torch.clamp(k + 1, 0, n_bias - 1)
        ar = torch.arange(sse.shape[1], device=device)
        c0, cm, cp = sse[k, ar], sse[km, ar], sse[kp, ar]
        denom = cm - 2 * c0 + cp
        off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (cm - cp) / denom,
                          torch.zeros_like(denom))
        off = torch.where((k > 0) & (k < n_bias - 1),
                          torch.clamp(off, -0.5, 0.5), torch.zeros_like(off))
        step = biases[1] - biases[0]
        bias = biases[k] + off * step
        bias = torch.where(enough, bias, torch.zeros_like(bias))

        xy_b, _, _ = _reintegrate(xy, yaw, bias, torch.ones_like(bias))
        scale = torch.clamp(_fit_scale(xy_b, w, z), 1.0 - scale_band,
                            1.0 + scale_band)
        scale = torch.where(enough, scale, torch.ones_like(scale))
        xy_c, yaw_c, dist = _reintegrate(xy, yaw, bias, scale)
        if irls < irls_rounds:
            e2 = ((xy_c - z) ** 2).sum(dim=-1)
            w = w0 / (1.0 + e2 * inv_c2)

    def host(x):
        return x.cpu().numpy()

    return {"bias": host(bias), "scale": host(scale),
            "n_obs": host(n_obs).astype(np.int64),
            "x": host(xy_c[..., 0].T), "y": host(xy_c[..., 1].T),
            "yaw": host(yaw_c.T), "dist": host(dist.T)}


def relocalize_fixes(anchor_logodds, x, y, yaw, scans, cfg,
                     every: int = 16, n_theta: int = 15,
                     theta_range: float = 0.3,
                     theta_prior_scale: float = 0.3, device=None):
    """Offline re-localization against the frozen anchor map: every
    `every`-th step (from step every - 1), each agent's logged sweep at the
    (calibrated) pose matched against the anchor's confident cells
    (|log-odds| >= 0.5) by `livemerge.scan_merge`. anchor_logodds [S, S];
    x, y, yaw [T, N], scans [T, N, R]. Returns (mask [T, N] bool, zx, zy
    [T, N]): the fixes that pass the fitness gate (and the distinctness
    test where `cfg.slam.merge_distinct_margin > 0`)."""
    from swarm_tpu_torch.slam.livemerge import scan_merge

    device = default_device(device)
    anchor = torch.as_tensor(np.asarray(anchor_logodds), device=device)
    match_map = torch.where(torch.abs(anchor) >= 0.5, anchor,
                            torch.zeros_like(anchor))
    t_steps, n = np.shape(x)[:2]
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    mask = np.zeros((t_steps, n), bool)
    zx = np.zeros((t_steps, n), np.float32)
    zy = np.zeros((t_steps, n), np.float32)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    for t in range(every - 1, t_steps, every):
        rx, ry = dev(x[t]), dev(y[t])
        m = scan_merge(match_map, rx, ry, dev(yaw[t]), dev(scans[t]), alive,
                       cfg, n_theta=n_theta, theta_range=theta_range,
                       theta_prior_scale=theta_prior_scale)
        mask[t] = (m.ok & m.distinct).cpu().numpy()
        zx[t] = (rx + m.ddx).cpu().numpy()
        zy[t] = (ry + m.ddy).cpu().numpy()
    return mask, zx, zy


def calibrate_reloc(ex, ey, eyaw, obs_mask, zx, zy, anchor_logodds,
                    scans, cfg, rounds: int = 2, every: int = 16,
                    device=None, **cal_kw):
    """Calibrate, then `rounds` times re-localize the fixes from the
    calibrated chain and re-calibrate the RAW chain on them. Returns (cal
    dict, mask, zx, zy): the final calibration and fix set."""
    cal = calibrate_chains(ex, ey, eyaw, obs_mask, zx, zy, device=device,
                           **cal_kw)
    mask, fx, fy = obs_mask, zx, zy
    for _ in range(rounds):
        mask, fx, fy = relocalize_fixes(anchor_logodds, cal["x"], cal["y"],
                                        cal["yaw"], scans, cfg, every=every,
                                        device=device)
        cal = calibrate_chains(ex, ey, eyaw, mask, fx, fy, device=device,
                               **cal_kw)
    return cal, mask, fx, fy
