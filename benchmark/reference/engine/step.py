"""The reference step: one tick of the fused swarm engine in plain torch.

A frozen copy of the deployable path of swarm_tpu_torch/engine/sim.py (the
beam raster through the per-agent window table with the endpoint ring, no
room kernel, no frontiers, no parity mode, no fault schedule), with the
raster kernel replaced by its plain version (`ops/window_raster`) and the
merge-window boxes worked out again from the world (`merge_window_box`,
a copy of swarm_tpu_torch/parallel/sharded.py's). The state and noise
types mirror the program's field for field, so a program state converts
to a reference state by field names (`as_reference`).

`store_through` (a dtype or None) rounds every window the raster stores
through that dtype: the control's lower precision for the map.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference.config import SwarmConfig
from benchmark.reference.coord.heartbeat import heartbeat_update
from benchmark.reference.coord.zones import (ZoneState, zone_init,
                                             zone_observe_rows,
                                             zones_for_agents)
from benchmark.reference.geom.world import TILE_COLS, TILE_ROWS, cast_rays
from benchmark.reference.models import nav as navm
from benchmark.reference.models.ekf import EkfState, ekf_init, ekf_step_batch
from benchmark.reference.models.landmarks import detect_landmark_sim
from benchmark.reference.models.odometry import (DriftNoise, OdomState,
                                                 draw_drift_noise,
                                                 drift_integrate,
                                                 encoder_emit, odom_init,
                                                 quantize_yaw_deg)
from benchmark.reference.models.scan import sense_scan
from benchmark.reference.models.sensors import (SensorNoise,
                                                draw_sensor_noise,
                                                sense_4way, walls_for_rays)
from benchmark.reference.ops.beam_raster import (BeamSpec, beams_from_4way,
                                                 beams_from_scan, reach_cells)
from benchmark.reference.ops.window_raster import window_raster
from benchmark.reference.slam import closure as closure_mod
from benchmark.reference.slam.closure import (ClosureState,
                                              closure_add_poses_batch,
                                              closure_init)
from benchmark.reference.slam.livemerge import (FrameState, frame_add,
                                                frame_advance, frame_init,
                                                frame_innovate, frame_theta_q,
                                                merge_bias_ff,
                                                merge_bias_update,
                                                merge_fail_update,
                                                merge_increments,
                                                merge_window_side,
                                                scan_merge_recover)
from benchmark.reference.utils.angles import radians, wrap_pi


class AgentParams(NamedTuple):
    wall_side: torch.Tensor
    motor_pwm: torch.Tensor
    return_style: torch.Tensor
    home_x: torch.Tensor
    home_y: torch.Tensor
    yaw0: torch.Tensor
    trans_scale: torch.Tensor
    yaw_bias_per_m: torch.Tensor
    x_offset: torch.Tensor
    ekf_yaw: torch.Tensor
    v2v_count: torch.Tensor


def make_agent_params(n: int, separation: float = 5.0,
                      spacing: float = 0.6, device="cpu") -> AgentParams:
    """Alternating Bot1/Bot2 personalities; starts staggered along y by
    `spacing` within each personality."""
    i = torch.arange(n, device=device)
    is_b2 = (i % 2) == 1
    row = torch.div(i, 2, rounding_mode="floor").to(torch.float32)

    def pick(b2, b1, dtype):
        return torch.where(is_b2, torch.tensor(b2, dtype=dtype, device=device),
                           torch.tensor(b1, dtype=dtype, device=device))

    f32, i32 = torch.float32, torch.int32
    return AgentParams(
        wall_side=pick(-1, 1, i32), motor_pwm=pick(190, 205, i32),
        return_style=pick(navm.RETURN_STYLE_GOHOME,
                          navm.RETURN_STYLE_STRAIGHT, i32),
        home_x=torch.zeros((n,), dtype=f32, device=device),
        home_y=row * spacing,
        yaw0=pick(math.pi, 0.0, f32), trans_scale=pick(1.002, 0.998, f32),
        yaw_bias_per_m=pick(0.008, -0.008, f32),
        x_offset=pick(separation, 0.0, f32),
        ekf_yaw=torch.zeros((n,), dtype=torch.bool, device=device),
        v2v_count=torch.zeros((n,), dtype=torch.bool, device=device))


class MapState(NamedTuple):
    grid: torch.Tensor
    logodds: torch.Tensor
    closure: ClosureState
    zone: ZoneState
    last_packet_t: torch.Tensor
    pkt_counts: torch.Tensor
    zone_boxes: torch.Tensor
    zone_active: torch.Tensor
    frontier_centroids: torch.Tensor
    n_frontiers: torch.Tensor
    total_writes: torch.Tensor
    merge_dx: torch.Tensor
    merge_dy: torch.Tensor
    merge_dyaw: torch.Tensor
    anchor: torch.Tensor
    merge_fail: torch.Tensor
    merge_yaw_rate: torch.Tensor
    merge_dist_mark: torch.Tensor
    frame: FrameState


class SimState(NamedTuple):
    t: torch.Tensor
    step: torch.Tensor
    pose_true: torch.Tensor
    odom: OdomState
    ekf: EkfState
    nav: navm.NavState
    total_dist: torch.Tensor
    v2v_total: torch.Tensor
    srv: MapState


class StepNoise(NamedTuple):
    sense: SensorNoise
    scan: Optional[SensorNoise]
    drift: DriftNoise


class StepOut(NamedTuple):
    """What one step produced that the check compares, beside the new
    state: the sensed ranges, the raster pose, the writes, the V2V field
    and the merge's per-agent outcome."""
    dist4: torch.Tensor
    scan: Optional[torch.Tensor]
    srv_x: torch.Tensor
    srv_y: torch.Tensor
    srv_yaw: torch.Tensor
    writes: torch.Tensor
    v2v: torch.Tensor
    merge_ok: torch.Tensor
    merge_fit: torch.Tensor
    closures: torch.Tensor
    online: torch.Tensor


def draw_step_noise(generator: torch.Generator, n: int, n_rays: int,
                    device) -> StepNoise:
    """One step's noise from `generator`, drawn in the engine's order: the
    4-way sensing, the sweep (none without one), the drift."""
    return StepNoise(
        sense=draw_sensor_noise(generator, (n, 4), device),
        scan=(draw_sensor_noise(generator, (n, n_rays), device)
              if n_rays > 0 else None),
        drift=draw_drift_noise(generator, n, device))


WRITES_RADIX = 1 << 30


def writes_accumulate(tw, w):
    lo = tw[1] + w
    carry = torch.div(lo, WRITES_RADIX, rounding_mode="floor")
    return torch.stack([tw[0] + carry, lo - carry * WRITES_RADIX]).to(
        torch.int32)


def writes_delta(tw_new, tw_old):
    return (tw_new[0] - tw_old[0]) * WRITES_RADIX + (tw_new[1] - tw_old[1])


def check_supported(cfg: SwarmConfig):
    """The reference covers the deployable engine's window raster only."""
    e, s = cfg.engine, cfg.slam
    if (e.parity_mode or e.raster_mode != "beam" or not e.use_pallas
            or e.room_tile_per_row > 0 or e.compute_frontiers
            or not e.kernel_endpoints or s.closure_scanmatch):
        raise ValueError("the reference step covers the deployable window "
                         "raster with the endpoint ring, without frontiers, "
                         "room tiles or scan-matched closures")
    if e.merge_every > 0 and e.scan_rays <= 0:
        raise ValueError("the merge matches servo sweeps: merge_every > 0 "
                         "needs scan_rays > 0")


def sim_init(cfg: SwarmConfig, params: AgentParams) -> SimState:
    """Initial state on the device of `params`."""
    check_supported(cfg)
    n = cfg.n_agents
    s = cfg.grid.size
    dev = params.home_x.device
    f32 = torch.float32
    x0, y0, yaw0 = params.home_x, params.home_y, params.yaw0
    zeros = torch.zeros((n,), dtype=f32, device=dev)

    def zf(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    srv = MapState(
        grid=torch.full((s, s), cfg.grid.unknown, dtype=torch.int8,
                        device=dev),
        logodds=zf(s, s, dtype=cfg.grid.lo_dtype),
        closure=closure_init(n, cfg.slam, scan_rays=0, device=dev),
        zone=zone_init(n, device=dev),
        last_packet_t=zf(n), pkt_counts=zf(n, dtype=torch.int32),
        zone_boxes=torch.tensor([999.0, 999.0, -999.0, -999.0], dtype=f32,
                                device=dev).repeat(n, 1),
        zone_active=zf(n, dtype=torch.bool),
        frontier_centroids=zf(cfg.coord.max_frontiers, 2),
        n_frontiers=zf(dtype=torch.int32),
        total_writes=zf(2, dtype=torch.int32),
        merge_dx=zf(n), merge_dy=zf(n), merge_dyaw=zf(n),
        anchor=(zf(s, s, dtype=cfg.grid.lo_dtype) if cfg.slam.merge_anchor
                else zf(1, 1, dtype=cfg.grid.lo_dtype)),
        merge_fail=zf(n, dtype=torch.int32),
        merge_yaw_rate=zf(n), merge_dist_mark=zf(n),
        frame=frame_init(n, px=params.home_x + params.x_offset,
                         py=params.home_y, device=dev))
    return SimState(
        t=zf(), step=zf(dtype=torch.int32),
        pose_true=torch.stack([x0, y0, yaw0], dim=-1),
        odom=odom_init(x0, y0, yaw0),
        ekf=ekf_init(torch.stack([x0, y0, yaw0, zeros, zeros, zeros], -1)),
        nav=navm.nav_init(n, device=dev),
        total_dist=zf(n), v2v_total=zf(n, dtype=torch.int32), srv=srv)


def as_reference(tree, like):
    """A program NamedTuple tree rebuilt as the reference type `like`
    (a NamedTuple class), field by field by name; tensors are shared."""
    if not (isinstance(like, type) and hasattr(like, "_fields")):
        return tree
    hints = {f: _FIELD_TYPES.get((like.__name__, f)) for f in like._fields}
    return like(**{f: (as_reference(getattr(tree, f), hints[f])
                       if hints[f] is not None else getattr(tree, f))
                   for f in like._fields})


_FIELD_TYPES = {
    ("SimState", "odom"): OdomState, ("SimState", "ekf"): EkfState,
    ("SimState", "nav"): navm.NavState, ("SimState", "srv"): MapState,
    ("MapState", "closure"): ClosureState, ("MapState", "zone"): ZoneState,
    ("MapState", "frame"): FrameState,
    ("StepNoise", "sense"): SensorNoise, ("StepNoise", "scan"): SensorNoise,
    ("StepNoise", "drift"): DriftNoise,
}


def v2v_stats(txy, alive, radio_range_m: float = 10.0, chunk: int = 1024):
    """Pairwise V2V link statistics: (nearest_cm [N] int32, in_range [N]
    int32), one [chunk, N] block at a time above 2 * chunk agents."""
    n = txy.shape[0]
    r2 = radio_range_m * radio_range_m
    ids = torch.arange(n, device=txy.device)

    def block_stats(rows_xy, row_ids):
        d2 = ((rows_xy[:, None, :] - txy[None, :, :]) ** 2).sum(-1)
        self_or_dead = (ids[None, :] == row_ids[:, None]) | ~alive[None, :]
        d2 = torch.where(self_or_dead, torch.full_like(d2, float("inf")), d2)
        return d2.amin(dim=1), (d2 <= r2).sum(dim=1).to(torch.int32)

    if n <= 2 * chunk or n % chunk != 0:
        d2min, cnt = block_stats(txy, ids)
    else:
        parts = [block_stats(txy[i:i + chunk], ids[i:i + chunk])
                 for i in range(0, n, chunk)]
        d2min = torch.cat([p[0] for p in parts])
        cnt = torch.cat([p[1] for p in parts])
    cm = torch.where(torch.isfinite(d2min), torch.sqrt(d2min) * 100.0,
                     torch.zeros_like(d2min)).to(torch.int32)
    return cm, cnt


def merge_window_box(walls_grouped, room_of_agent, cfg: SwarmConfig):
    """Per-agent clamp box of the scan-merge window: the agent's room box
    in cells, padded by 3 cells, snapped outward to the raster-tile
    lattice and clipped to the grid. (rmin, rmax, cmin, cmax) [N] int."""
    wg = np.asarray(walls_grouped)
    roa = np.asarray(room_of_agent)
    ys = wg[..., [1, 3]].reshape(wg.shape[0], -1)
    xs = wg[..., [0, 2]].reshape(wg.shape[0], -1)
    res = cfg.grid.resolution
    pad = 3
    rmin = (np.floor((ys.min(1)[roa] - cfg.grid.origin_y) / res) -
            pad).astype(int)
    rmax = (np.ceil((ys.max(1)[roa] - cfg.grid.origin_y) / res) +
            pad).astype(int)
    cmin = (np.floor((xs.min(1)[roa] - cfg.grid.origin_x) / res) -
            pad).astype(int)
    cmax = (np.ceil((xs.max(1)[roa] - cfg.grid.origin_x) / res) +
            pad).astype(int)
    size = cfg.grid.size
    side = merge_window_side(cfg)
    rmin = np.maximum((rmin // TILE_ROWS) * TILE_ROWS, 0)
    rmax = np.minimum(-(-rmax // TILE_ROWS) * TILE_ROWS, size)
    cmin = np.maximum((cmin // TILE_COLS) * TILE_COLS, 0)
    cmax = np.minimum(-(-cmax // TILE_COLS) * TILE_COLS, size)
    if ((rmax - rmin) < side).any() or ((cmax - cmin) < side).any():
        raise ValueError("an agent's tile-snapped room box is smaller than "
                         "the scan-merge window")
    return rmin, rmax, cmin, cmax


def _merge_event(logodds, anchor, merge_fail, frame: FrameState, rx, ry,
                 ryaw, gate_yaw, scan_dist, alive, step_no: int,
                 cfg: SwarmConfig, merge_win_box, bias=None):
    """The anchored scan merge of one merge step."""
    slam = cfg.slam
    if slam.merge_anchor:
        match_map = torch.where(torch.abs(anchor) >= 0.5, anchor, logodds)
    else:
        match_map = logodds
    m, att, rec = scan_merge_recover(
        match_map, rx, ry, ryaw, scan_dist, alive, cfg,
        event=step_no // cfg.engine.merge_every, n_global=cfg.n_agents,
        fail_count=merge_fail, win_bounds=merge_win_box)
    upd = m.ok & alive
    fdx, fdy, fdth, inc_dx, inc_dy, inc_dth = merge_increments(m, upd, rec,
                                                               cfg)
    if slam.merge_frame_gain > 0.0:
        still = frame.ax * frame.ax + frame.ay * frame.ay < \
            slam.merge_frame_still_m ** 2
        sdamp = torch.where(still,
                            torch.full_like(rx, slam.merge_frame_still_damp),
                            torch.ones_like(rx))
        inc_dx = inc_dx * sdamp
        inc_dy = inc_dy * sdamp
        inc_dth = inc_dth * sdamp
    bias_d = None
    if bias is not None:
        yaw_rate, dist_mark, total_dist, quant_resid = bias
        bias_d = merge_bias_update(yaw_rate, dist_mark, total_dist, m, upd,
                                   cfg, quant_resid=quant_resid)
    merge_fail = merge_fail_update(merge_fail, m, att, rec, alive, cfg)
    innovation = None
    if slam.merge_frame_gain > 0.0:
        innovation = frame_innovate(frame, gate_yaw, m, upd, inc_dx, inc_dy,
                                    cfg, recovered=rec)
    n_merges = upd.sum().to(torch.int32)
    fit_agent = torch.where(upd, m.fitness, torch.zeros_like(m.fitness))
    if slam.merge_distinct_log_margin > 0.0:
        ok_agent = upd & (m.distinct_gap >= slam.merge_distinct_log_margin)
    else:
        ok_agent = upd
    return (rx + fdx, ry + fdy, ryaw + fdth, (inc_dx, inc_dy, inc_dth),
            merge_fail, innovation, (n_merges, ok_agent, fit_agent), bias_d)


def _raster_fans(logodds, axy, ryaw, dist4, scan_dist, alive,
                 cfg: SwarmConfig, store_through):
    """Every fan of the step through the window raster, the wrapped 4-way
    fan first, then the sweep. Returns (logodds, writes int32)."""
    sens, eng = cfg.sensors, cfg.engine
    fans = []
    if eng.raster_4way or scan_dist is None:
        fans.append((BeamSpec.four_way(),
                     beams_from_4way(dist4, sens.max_range, sens.min_range)))
    if scan_dist is not None:
        fans.append((BeamSpec.scan(scan_dist.shape[-1]),
                     beams_from_scan(scan_dist, sens.max_range,
                                     sens.min_range)))
    reach = reach_cells(cfg)
    writes = torch.zeros((), dtype=torch.int32, device=axy.device)
    for spec, (db, tb) in fans:
        n_groups = (spec.n_beams if eng.beam_groups <= 0
                    else min(eng.beam_groups, spec.n_beams))
        logodds, w_cnt = window_raster(
            logodds, axy, ryaw, db, alive, tb, spec, cfg.grid, reach,
            pack8=eng.beam_pack8, n_groups=n_groups,
            tail_weight=eng.beam_tail_weight, store_through=store_through)
        writes = writes + torch.round(w_cnt).to(torch.int32).sum()
    return logodds, writes.to(torch.int32)


def reference_step(state: SimState, noise: StepNoise, cfg: SwarmConfig,
                   params: AgentParams, walls_grouped, room_of_agent,
                   step_no: int, store_through=None):
    """One tick from `state` with `noise`. Updates `state.srv.logodds` in
    place. Returns (new state, StepOut)."""
    check_supported(cfg)
    closure_mod.RING_WRITES.clear()
    n = cfg.n_agents
    navc, sens, eng, slam = cfg.nav, cfg.sensors, cfg.engine, cfg.slam
    dt = navc.drive_tick_s + navc.settle_tick_s
    dev = state.pose_true.device
    i32, f32 = torch.int32, torch.float32
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    zeros = torch.zeros((n,), dtype=f32, device=dev)
    walls_agent = walls_grouped[room_of_agent.long()]
    win_box = None
    if eng.merge_every > 0:
        win_box = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                        for a in merge_window_box(
                            walls_grouped.cpu().numpy(),
                            room_of_agent.cpu().numpy(), cfg))

    # 1. sense from the true pose
    dist4 = sense_4way(noise.sense, state.pose_true, walls_agent, sens)
    scan_dist = None
    if eng.scan_rays > 0:
        scan_dist = sense_scan(noise.scan, state.pose_true, walls_agent,
                               eng.scan_rays, sens)
    # 2. landmark signature
    lm = detect_landmark_sim(dist4[:, 0], dist4[:, 1], dist4[:, 3],
                             navc.lm_sim_close_m, sens.max_range)
    lm = torch.where(alive, lm, torch.zeros_like(lm))
    # 3. telemetry from the drifted estimate
    odom, _ = encoder_emit(state.odom, cfg.noise)
    yaw_q = radians(quantize_yaw_deg(odom.yaw_est,
                                     cfg.noise.yaw_quantize_deg))
    est_x, est_y, est_yaw = odom.x_est, odom.y_est, yaw_q

    # 4. server ingest
    srv = state.srv
    merge_cadence = eng.merge_every > 0 and \
        step_no % eng.merge_every == eng.merge_every - 1
    merge_dx, merge_dy, merge_dyaw = srv.merge_dx, srv.merge_dy, \
        srv.merge_dyaw
    frame = srv.frame
    if slam.merge_frame_gain > 0.0:
        adx, ady, fd = frame_advance(frame, est_x + params.x_offset, est_y,
                                     alive, cfg)
        merge_dx = merge_dx + adx
        merge_dy = merge_dy + ady
        frame = frame_add(frame, fd)
    rx = est_x + params.x_offset + srv.closure.drift_dx + merge_dx
    ry = est_y + srv.closure.drift_dy + merge_dy
    ryaw = est_yaw + merge_dyaw
    if slam.merge_frame_gain > 0.0:
        ryaw = ryaw - frame_theta_q(frame.theta, cfg)
    bias = slam.merge_bias_alpha > 0.0
    if bias:
        ryaw = ryaw + merge_bias_ff(srv.merge_yaw_rate, srv.merge_dist_mark,
                                    state.total_dist, cfg)
    merge_fail = srv.merge_fail
    merge_yaw_rate, merge_dist_mark = srv.merge_yaw_rate, \
        srv.merge_dist_mark
    merge_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    merge_fit = torch.zeros((n,), dtype=f32, device=dev)
    if merge_cadence and scan_dist is not None:
        rx, ry, ryaw, (inc_dx, inc_dy, inc_dth), merge_fail, innovation, \
            (_, merge_ok, merge_fit), bias_d = _merge_event(
                srv.logodds, srv.anchor, srv.merge_fail, frame, rx, ry,
                ryaw, est_yaw, scan_dist, alive, step_no, cfg, win_box,
                bias=((srv.merge_yaw_rate, srv.merge_dist_mark,
                       state.total_dist, wrap_pi(yaw_q - odom.yaw_est))
                      if bias else None))
        if innovation is not None:
            frame = frame_add(frame, innovation)
        merge_dx = merge_dx + inc_dx
        merge_dy = merge_dy + inc_dy
        merge_dyaw = merge_dyaw + inc_dth
        if bias_d is not None:
            fold, rate_d, mark_d = bias_d
            merge_dyaw = merge_dyaw + fold
            merge_yaw_rate = merge_yaw_rate + rate_d
            merge_dist_mark = merge_dist_mark + mark_d

    last_packet_t = torch.where(alive, state.t, srv.last_packet_t)
    pkt_counts = srv.pkt_counts + alive.to(torch.int32)
    angles = ryaw[:, None] + torch.tensor(sens.angles, dtype=rx.dtype,
                                          device=dev)[None, :]
    hit_valid = (dist4 > sens.min_range) & (dist4 <= sens.max_range)
    rng = torch.where(hit_valid, dist4, torch.full_like(dist4,
                                                        sens.max_range))
    hx = rx[:, None] + rng * torch.cos(angles)
    hy = ry[:, None] + rng * torch.sin(angles)

    logodds, writes = _raster_fans(srv.logodds, torch.stack([rx, ry], -1),
                                   ryaw, dist4, scan_dist, alive, cfg,
                                   store_through)
    writes = writes.to(i32)

    agents = torch.arange(n, dtype=torch.int32, device=dev)
    zone = zone_observe_rows(
        srv.zone, torch.cat([rx[:, None], hx], dim=1),
        torch.cat([ry[:, None], hy], dim=1),
        torch.cat([alive[:, None], hit_valid & alive[:, None]], dim=1))
    closure, closed, _, _ = closure_add_poses_batch(
        srv.closure, rx, ry, agents, lm, slam, valid=alive, yaws=ryaw,
        scans=scan_dist, grid=cfg.grid, sens=sens)
    online = heartbeat_update(last_packet_t, state.t,
                              cfg.coord.heartbeat_timeout_s)
    zone_every = max(1, round(cfg.coord.zone_interval_s / dt))
    zone_boxes, zone_active = srv.zone_boxes, srv.zone_active
    if step_no % zone_every == 0:
        zone_boxes, zone_active = zones_for_agents(
            zone, torch.stack([rx, ry], dim=-1), online)
    anchor = srv.anchor
    if slam.merge_anchor and merge_cadence and (
            slam.merge_anchor_freeze_steps <= 0
            or step_no < slam.merge_anchor_freeze_steps):
        anchor = torch.where(
            (torch.abs(srv.anchor) < 0.5) &
            (torch.abs(logodds) >= slam.merge_anchor_thresh),
            logodds, srv.anchor)
    srv = srv._replace(
        logodds=logodds, closure=closure, zone=zone,
        last_packet_t=last_packet_t, pkt_counts=pkt_counts,
        zone_boxes=zone_boxes, zone_active=zone_active,
        total_writes=writes_accumulate(srv.total_writes, writes),
        merge_dx=merge_dx, merge_dy=merge_dy, merge_dyaw=merge_dyaw,
        anchor=anchor, merge_fail=merge_fail,
        merge_yaw_rate=merge_yaw_rate, merge_dist_mark=merge_dist_mark,
        frame=frame)

    # 5. navigate
    est_pose = torch.stack([odom.x_est, odom.y_est, odom.yaw_est], dim=-1)
    zone_local = srv.zone_boxes - torch.stack(
        [params.x_offset, zeros, params.x_offset, zeros], dim=-1)
    nav, cmd = navm.nav_step(state.nav, navm.NavParams(
        wall_side=params.wall_side, motor_pwm=params.motor_pwm,
        return_style=params.return_style,
        home_x=params.home_x, home_y=params.home_y),
        dist4, est_pose, state.total_dist, zone_local,
        srv.zone_active, dt, navc)
    drive = torch.where(alive, cmd.drive_m, zeros)
    turn = torch.where(alive, cmd.turn_cmd_rad, zeros)
    steer = torch.where(alive, cmd.steer_rad, zeros)

    # 6. physics with the wall clamp
    yaw_true = wrap_pi(state.pose_true[:, 2] + turn)
    move_dir = yaw_true + steer
    clear = cast_rays(state.pose_true[:, None, :2], move_dir[:, None],
                      walls_for_rays(walls_agent))[:, 0]
    drive = torch.minimum(drive, torch.clamp_min(clear - 0.08, 0.0))
    x_true = state.pose_true[:, 0] + drive * torch.cos(move_dir)
    y_true = state.pose_true[:, 1] + drive * torch.sin(move_dir)
    pose_true = torch.stack([x_true, y_true, yaw_true], dim=-1)
    total_dist = state.total_dist + drive

    # 7. drift + EKF
    odom = drift_integrate(noise.drift, odom, drive, turn,
                           params.trans_scale, params.yaw_bias_per_m,
                           cfg.noise)
    t_new = state.t + dt
    ekf = ekf_step_batch(state.ekf, turn / dt, drive / dt,
                         t_new.expand(n), cfg.ekf)
    odom = odom._replace(yaw_est=torch.where(
        params.ekf_yaw, wrap_pi(ekf.x[:, 2]), odom.yaw_est))

    # v2v from the pre-motion true poses
    txy = state.pose_true[:, :2] + torch.stack([params.x_offset, zeros], -1)
    v2v_cm, v2v_n = v2v_stats(txy, alive, sens.v2v_range_m)
    rx_per_tick = torch.round(
        v2v_n.to(torch.float32) * sens.v2v_broadcast_hz * dt).to(torch.int32)
    v2v_total = state.v2v_total + torch.where(alive, rx_per_tick,
                                              torch.zeros_like(rx_per_tick))
    v2v = torch.where(params.v2v_count, v2v_total, v2v_cm)

    new_state = SimState(
        t=t_new, step=state.step + 1, pose_true=pose_true, odom=odom,
        ekf=ekf, nav=nav, total_dist=total_dist, v2v_total=v2v_total,
        srv=srv)
    out = StepOut(dist4=dist4, scan=scan_dist, srv_x=rx, srv_y=ry,
                  srv_yaw=ryaw,
                  writes=writes_delta(srv.total_writes,
                                      state.srv.total_writes),
                  v2v=v2v, merge_ok=merge_ok, merge_fit=merge_fit,
                  closures=closed.sum().to(i32),
                  online=online.sum().to(i32))
    return new_state, out
