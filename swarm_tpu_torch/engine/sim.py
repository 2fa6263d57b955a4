"""The fused closed-loop swarm step (swarm_tpu/engine/sim.py), in torch.

One call advances every agent by one tick: sense (4-way + servo scan from
the TRUE pose), landmark, telemetry from the drifted estimate, server
ingest (frame tracker, beam raster through the CUDA kernel, zones, closure
ring, heartbeat), navigate, wall-clamped physics, drift integration, EKF,
V2V. State is NamedTuples of tensors on one device; the step is eager torch,
a Python loop replaces `lax.scan`, and noise comes in as tensors
(`StepNoise`) drawn from an explicit `torch.Generator`.

The raster updates `state.srv.logodds` IN PLACE: the grid of the state
passed in is the grid of the state returned.

Ported: the deployable preset's paths (presets.deployable, every
single-chip `bench.py` raster flag) — the per-agent window raster
(`free_raster`: pack8 or pack16 table per beam, or the grouped table with
the weak tail where `engine.beam_groups` is below a fan's beams; with the
endpoint ring or without it, on a float32 or bfloat16 grid) or the
room-tile raster (`engine.room_tile_per_row > 0`, `room_raster`: pack16 per
beam or grouped, with or without the ring, float32), each with the
anchored scan merge at
`engine.merge_every` and the anchor freeze — and the exploration path
(presets.coverage): the wrapped 4-way ultrasonic fan and the servo scan
each through a raster kernel, the exact endpoint scatter after each fan
without a ring, frontier detection at the 3 s cadence and frontier-target
assignment (`enable_targets`), delivered in each agent's odometry frame.
With `scan_rays == 0` the 4-way fan is the only raster and no sweep is
sensed. The merge, zone and frontier cadences are host `if`s on a
host-side step number: `make_sim_step` keeps it, `sim_step` takes it as
`step_no` (or reads `state.step` once). Every config path the port does not
run raises NotImplementedError naming its ROADMAP item, and the
combinations the reference refuses raise its ValueError
(`check_supported`). `StepMetrics.writes` is one step's int32 count; sum a
rollout's on the host in int64 (`rollout_writes`): at 32,768 agents a step
writes ~1e8 cells and a few dozen steps pass 2^31.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.coord.assign import (greedy_assign,
                                          greedy_assign_rooms, room_rounds)
from swarm_tpu_torch.coord.heartbeat import heartbeat_update
from swarm_tpu_torch.coord.zones import (ZoneState, zone_init,
                                         zone_observe_rows, zones_for_agents)
from swarm_tpu_torch.geom.world import agent_room_boxes, cast_rays
from swarm_tpu_torch.models import nav as navm
from swarm_tpu_torch.models.ekf import EkfState, ekf_init, ekf_step_batch
from swarm_tpu_torch.models.landmarks import detect_landmark_sim
from swarm_tpu_torch.models.odometry import (DriftNoise, OdomState,
                                             draw_drift_noise,
                                             drift_integrate, encoder_emit,
                                             odom_init, quantize_yaw_deg)
from swarm_tpu_torch.models.scan import sense_scan
from swarm_tpu_torch.models.sensors import (SensorNoise, walls_for_rays,
                                            draw_sensor_noise, sense_4way)
from swarm_tpu_torch.ops.beam_raster import (BeamSpec, beams_from_4way,
                                             beams_from_scan, endpoint_rays,
                                             reach_cells)
from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
from swarm_tpu_torch.ops.frontier import (frontier_clusters,
                                          frontier_targets_coarse)
from swarm_tpu_torch.ops.raster import endpoint_scatter, tri_state_view
from swarm_tpu_torch.ops.room_raster_cuda import room_raster
from swarm_tpu_torch.parallel.sharded import merge_window_box
from swarm_tpu_torch.slam.closure import (ClosureState,
                                          closure_add_poses_batch,
                                          closure_init)
from swarm_tpu_torch.slam.livemerge import (FrameState, frame_add,
                                            frame_advance, frame_init,
                                            frame_innovate, frame_theta_q,
                                            merge_fail_update,
                                            merge_increments,
                                            scan_merge_recover)
from swarm_tpu_torch.utils.angles import radians, wrap_pi


class AgentParams(NamedTuple):
    """Per-agent static parameters as batched [N] tensors."""
    wall_side: torch.Tensor       # +1 left-follower (Bot1) / -1 right (Bot2)
    motor_pwm: torch.Tensor
    return_style: torch.Tensor
    home_x: torch.Tensor
    home_y: torch.Tensor
    yaw0: torch.Tensor
    trans_scale: torch.Tensor
    yaw_bias_per_m: torch.Tensor
    x_offset: torch.Tensor
    ekf_yaw: torch.Tensor         # bool: EKF yaw drives the reported yaw
    v2v_count: torch.Tensor       # bool: v2v field is the broadcast count


def make_agent_params(n: int, separation: float = 5.0,
                      spacing: float = 0.6, device=None) -> AgentParams:
    """Alternating Bot1/Bot2 personalities; starts staggered along y by
    `spacing` within each personality. On the card unless `device` is
    named."""
    device = default_device(device)
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


class FaultSchedule(NamedTuple):
    """Deterministic agent-kill windows."""
    agent: torch.Tensor    # [F] int32 (-1 = unused slot)
    t_start: torch.Tensor  # [F] seconds
    t_end: torch.Tensor    # [F]


def no_faults(capacity: int = 4, device=None) -> FaultSchedule:
    """An empty schedule, on the card unless `device` is named."""
    device = default_device(device)
    return FaultSchedule(
        agent=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        t_start=torch.zeros((capacity,), dtype=torch.float32, device=device),
        t_end=torch.zeros((capacity,), dtype=torch.float32, device=device))


def alive_mask(faults: FaultSchedule, n: int, t) -> torch.Tensor:
    ids = torch.arange(n, device=faults.agent.device)
    hit = (faults.agent[None, :] == ids[:, None]) & \
        (t >= faults.t_start[None, :]) & (t < faults.t_end[None, :])
    return ~hit.any(dim=1)


def v2v_stats(txy, alive, radio_range_m: float = 10.0, chunk: int = 1024):
    """Pairwise V2V link statistics: (nearest_cm [N] int32, in_range [N]
    int32). Above 2*chunk agents (and when chunk divides N) one [chunk, N]
    block is live at a time, the reference's chunking rule."""
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


class MapState(NamedTuple):
    """Server-side mapping + coordination state."""
    grid: torch.Tensor             # [S, S] int8 tri-state (parity mode)
    logodds: torch.Tensor          # [S, S] float32
    closure: ClosureState
    zone: ZoneState
    last_packet_t: torch.Tensor    # [N]
    pkt_counts: torch.Tensor       # [N] int32
    zone_boxes: torch.Tensor       # [N, 4]
    zone_active: torch.Tensor      # [N] bool
    frontier_centroids: torch.Tensor  # [K, 2]
    n_frontiers: torch.Tensor      # [] int32
    total_writes: torch.Tensor     # [2] int32 (hi, lo), lo in [0, 2^30)
    merge_dx: torch.Tensor         # [N]
    merge_dy: torch.Tensor
    merge_dyaw: torch.Tensor
    anchor: torch.Tensor           # [S, S] (or [1, 1])
    merge_fail: torch.Tensor       # [N] int32
    merge_yaw_rate: torch.Tensor   # [N]
    merge_dist_mark: torch.Tensor  # [N]
    frame: FrameState


WRITES_RADIX = 1 << 30


def writes_accumulate(tw, w):
    """tw [2] int32 (hi, lo) + w (one step's writes, < 2^30) -> exact
    running total."""
    lo = tw[1] + w
    carry = torch.div(lo, WRITES_RADIX, rounding_mode="floor")
    return torch.stack([tw[0] + carry, lo - carry * WRITES_RADIX]).to(
        torch.int32)


def writes_delta(tw_new, tw_old):
    """One step's writes from two counter states."""
    return (tw_new[0] - tw_old[0]) * WRITES_RADIX + (tw_new[1] - tw_old[1])


def total_writes_value(tw) -> int:
    """Host-side exact value of the (hi, lo) counter."""
    a = np.asarray(tw.cpu() if isinstance(tw, torch.Tensor) else tw)
    a = a.astype(np.int64)
    return int(a[0]) * WRITES_RADIX + int(a[1])


class SimState(NamedTuple):
    """Complete swarm-world state. (The reference also carries its PRNG key;
    here noise comes from the caller's generator.)"""
    t: torch.Tensor                # [] seconds
    step: torch.Tensor             # [] int32
    pose_true: torch.Tensor        # [N, 3]
    odom: OdomState
    ekf: EkfState
    nav: navm.NavState
    total_dist: torch.Tensor       # [N]
    v2v_total: torch.Tensor        # [N] int32
    srv: MapState


class StepMetrics(NamedTuple):
    """Per-step observability + telemetry (field meanings as in the
    reference's StepMetrics)."""
    writes: torch.Tensor
    closures: torch.Tensor
    online: torch.Tensor
    n_frontiers: torch.Tensor
    pose_err: torch.Tensor
    mission_done: torch.Tensor
    merges: torch.Tensor
    merge_fitness: torch.Tensor
    band_escapes: torch.Tensor
    t: torch.Tensor
    srv_x: torch.Tensor
    srv_y: torch.Tensor
    srv_yaw: torch.Tensor
    yaw_q: torch.Tensor
    est_x: torch.Tensor
    est_y: torch.Tensor
    est_yaw: torch.Tensor
    merge_ok: torch.Tensor
    merge_fit: torch.Tensor
    encoder: torch.Tensor
    v2v: torch.Tensor
    dist_m: torch.Tensor
    landmark: torch.Tensor
    hits: torch.Tensor
    hit_valid: torch.Tensor
    alive: torch.Tensor


class StepNoise(NamedTuple):
    """Every random draw of one step: the 4-way sensing [N, 4], the servo
    sweep [N, R] (None without a sweep) and the odometry drift [N]."""
    sense: SensorNoise
    scan: Optional[SensorNoise]
    drift: DriftNoise


def draw_step_noise(generator: torch.Generator, n: int, n_rays: int,
                    device) -> StepNoise:
    """One step's noise from `generator` (which must live on `device`);
    no sweep noise is drawn when `n_rays == 0`."""
    return StepNoise(
        sense=draw_sensor_noise(generator, (n, 4), device),
        scan=(draw_sensor_noise(generator, (n, n_rays), device)
              if n_rays > 0 else None),
        drift=draw_drift_noise(generator, n, device))


def check_supported(cfg: SwarmConfig, sharded: bool = False):
    """Raise NotImplementedError for every config path the port does not run
    yet, naming its ROADMAP item — never a silently different path — and
    ValueError for the combinations the reference itself refuses. With
    `sharded` the rows are the sharded engine's
    (parallel/sharded.make_sharded_sim_step)."""
    e, s = cfg.engine, cfg.slam
    if sharded:
        # the reference's make_sharded_sim_step refuses these, in these
        # words (swarm_tpu/parallel/sharded.py:841-846)
        if cfg.grid.logodds_dtype != "float32":
            raise ValueError("sharded decompositions keep a float32 grid; "
                             "logodds_dtype=bfloat16 is a fused-engine knob")
        if e.parity_mode:
            raise ValueError("sharded step requires throughput mode "
                             "(cfg.engine.parity_mode=False)")
    elif cfg.grid.logodds_dtype != "float32" and (
            e.parity_mode or e.raster_mode != "beam"
            or e.room_tile_per_row > 0):
        # the reference's sim_init refuses these (swarm_tpu/engine/
        # sim.py:310-315), in these words
        raise ValueError(
            "logodds_dtype=bfloat16 is supported by the fused beam "
            "tiers (window kernel + XLA reference) only")
    todo = [
        (e.parity_mode, "parity_mode (tri-state line raster)",
         "Queue A3, the reference-parity path"),
        (e.raster_mode == "off", 'raster_mode="off" (the profiling mode)',
         "Queue A8, the profiling mode"),
        (e.raster_mode not in ("beam", "off"),
         f"raster_mode={e.raster_mode!r} (the line raster)",
         "Queue A8, the line raster"),
        (not e.use_pallas and sharded,
         "use_pallas=False on the sharded path (the XLA fast tier "
         "free_raster_reference)", "Queue A9, the sharded XLA fast tier"),
        (not e.use_pallas and not sharded,
         "use_pallas=False (the XLA beam tier)",
         "Queue A8, the XLA beam tier"),
        (s.merge_bias_alpha > 0.0, "merge_bias_alpha > 0",
         "Queue A1, anchored merge"),
        (s.closure_scanmatch, "closure_scanmatch",
         "Queue A5, offline SLAM"),
    ]
    for off_path, what, item in todo:
        if off_path:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})")
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
        closure=closure_init(n, cfg.slam, device=dev),
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
        # initial RAW reported positions, so the tracker's first step sees
        # a real delta
        frame=frame_init(n, px=params.home_x + params.x_offset,
                         py=params.home_y, device=dev))
    return SimState(
        t=zf(), step=zf(dtype=torch.int32),
        pose_true=torch.stack([x0, y0, yaw0], dim=-1),
        odom=odom_init(x0, y0, yaw0),
        ekf=ekf_init(torch.stack([x0, y0, yaw0, zeros, zeros, zeros], -1)),
        nav=navm.nav_init(n, device=dev),
        total_dist=zf(n), v2v_total=zf(n, dtype=torch.int32), srv=srv)


def _merge_event(logodds, anchor, merge_fail, frame: FrameState, rx, ry,
                 ryaw, gate_yaw, scan_dist, alive, step_no: int,
                 cfg: SwarmConfig, merge_win_box, id0=None, band_row0=None,
                 band_col0=None):
    """The anchored scan merge of one merge step (the merge block of the
    reference's _ingest_batched, and of its sharded body): match every
    attempted agent's scan against the map as of the previous step (the
    frozen anchor where anchored), apply the full correction to this step's
    raster pose and the damped, clamped increments to the persistent state.
    The sharded engine passes its rank's rows (agents from global id `id0`)
    and its band or tile of the map (`band_row0` / `band_col0`). Returns
    (rx, ry, ryaw, (inc_dx, inc_dy, inc_dth), merge_fail, the frame
    tracker's innovation (a FrameState delta, None without the tracker),
    (n_merges, merge_fit, merge_ok [N], merge_fit [N]))."""
    slam = cfg.slam
    if slam.merge_anchor:
        match_map = torch.where(torch.abs(anchor) >= 0.5, anchor, logodds)
    else:
        match_map = logodds
    m, att, rec = scan_merge_recover(
        match_map, rx, ry, ryaw, scan_dist, alive, cfg,
        event=step_no // cfg.engine.merge_every, n_global=cfg.n_agents,
        fail_count=merge_fail, id0=id0, band_row0=band_row0,
        band_col0=band_col0, win_bounds=merge_win_box)
    upd = m.ok & alive
    # FULL correction to this step's raster pose; only the persistent
    # increment is damped and clamped (reference rationale,
    # swarm_tpu/engine/sim.py:455-463)
    fdx, fdy, fdth, inc_dx, inc_dy, inc_dth = merge_increments(m, upd, rec,
                                                               cfg)
    if slam.merge_frame_gain > 0.0:
        # stationarity damping: a parked agent re-matching the same scan
        # carries near-zero new information
        still = frame.ax * frame.ax + frame.ay * frame.ay < \
            slam.merge_frame_still_m ** 2
        sdamp = torch.where(still,
                            torch.full_like(rx, slam.merge_frame_still_damp),
                            torch.ones_like(rx))
        inc_dx = inc_dx * sdamp
        inc_dy = inc_dy * sdamp
        inc_dth = inc_dth * sdamp
    merge_fail = merge_fail_update(merge_fail, m, att, rec, alive, cfg)
    innovation = None
    if slam.merge_frame_gain > 0.0:
        innovation = frame_innovate(frame, gate_yaw, m, upd, inc_dx, inc_dy,
                                    cfg, recovered=rec)
    n_merges = upd.sum().to(torch.int32)
    fit_agent = torch.where(upd, m.fitness, torch.zeros_like(m.fitness))
    merge_fit = fit_agent.sum() / torch.clamp_min(n_merges, 1).to(
        torch.float32)
    # the LOGGED fix stream thresholds the raw peak gap with its own margin
    # (merge_distinct_log_margin; 0 logs every verified event) — the fused
    # engine's rule (swarm_tpu/engine/sim.py:508-512), which the port
    # follows on both engines (ROADMAP C3)
    if slam.merge_distinct_log_margin > 0.0:
        ok_agent = upd & (m.distinct_gap >= slam.merge_distinct_log_margin)
    else:
        ok_agent = upd
    return (rx + fdx, ry + fdy, ryaw + fdth, (inc_dx, inc_dy, inc_dth),
            merge_fail, innovation, (n_merges, merge_fit, ok_agent,
                                     fit_agent))


class TargetRooms(NamedTuple):
    """Per-agent room boxes for frontier-target assignment, built once on
    the host (`agent_target_rooms`): boxes [N, 4] on the device, and the
    per-room rounds of `greedy_assign_rooms` where the swarm is large
    enough to take it (else None)."""
    boxes: torch.Tensor
    rounds: Optional[tuple]


def agent_target_rooms(cfg: SwarmConfig, walls_grouped, room_of_agent,
                       device) -> Optional[TargetRooms]:
    """The room boxes that restrict frontier-target assignment to each
    agent's own room (swarm_tpu/engine/sim.py:789-815), or None without
    room geometry. Reads the geometry on the host."""
    if walls_grouped is None or room_of_agent is None:
        return None
    boxes = agent_room_boxes(torch.as_tensor(walls_grouped).cpu().numpy(),
                             torch.as_tensor(room_of_agent).cpu().numpy())
    rounds = (room_rounds(boxes, device)
              if cfg.n_agents >= cfg.coord.assign_rooms_min_agents else None)
    return TargetRooms(boxes=torch.as_tensor(boxes, device=device),
                       rounds=rounds)


def _raster_fans(logodds, axy, ryaw, dist4, scan_dist, alive,
                 cfg: SwarmConfig):
    """Every fan of the step through its raster kernel, the wrapped 4-way
    fan first, then the sweep; after each fan without an endpoint ring, the
    exact endpoint scatter and a clip. Returns (logodds, writes int32):
    each fan's per-agent (or per-tile) kernel counts rounded to int32
    before the sum, plus its endpoint writes."""
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
        trusted = tb if eng.kernel_endpoints else None
        # the tier per fan, as the reference picks it (swarm_tpu/engine/
        # sim.py:587-589): grouped where beam_groups is below the fan's
        # beams, else per beam (the 4-way fan in 8 groups is per beam)
        n_groups = (spec.n_beams if eng.beam_groups <= 0
                    else min(eng.beam_groups, spec.n_beams))
        if eng.room_tile_per_row > 0:
            # the reference passes the room kernel no pack8: pack16 table
            logodds, w_cnt = room_raster(
                logodds, axy, ryaw, db, alive, spec, cfg.grid,
                n_groups=n_groups, per_row=eng.room_tile_per_row,
                trusted=trusted, reach=reach,
                tail_weight=eng.beam_tail_weight)
        else:
            logodds, w_cnt = free_raster(logodds, axy, ryaw, db, alive,
                                         trusted, spec, cfg.grid,
                                         reach=reach, pack8=eng.beam_pack8,
                                         n_groups=n_groups,
                                         tail_weight=eng.beam_tail_weight)
        writes = writes + torch.round(w_cnt).to(torch.int32).sum()
        if not eng.kernel_endpoints and eng.endpoint_hits:
            logodds, w_ep = endpoint_scatter(
                logodds, endpoint_rays(axy, ryaw, db, tb, alive, spec),
                cfg.grid)
            writes = writes + w_ep
    return logodds, writes.to(torch.int32)


def _frontier_event(logodds, rx, ry, online, cfg: SwarmConfig,
                    enable_targets: bool,
                    target_rooms: Optional[TargetRooms]):
    """One frontier event: the tri-state view of the map, frontier
    centroids (exact clusters up to a 512 grid, block-pooled beyond), and
    with `enable_targets` the greedy assignment (per room at swarm scale).
    Returns (centroids, count, targets [N, 2] or None, has [N] or None)."""
    ffn = (frontier_clusters if cfg.grid.size <= 512
           else frontier_targets_coarse)
    cents, _, n_fr = ffn(tri_state_view(logodds, cfg.grid), cfg.grid,
                         cfg.coord)
    if not enable_targets:
        return cents, n_fr, None, None
    agent_xy = torch.stack([rx, ry], dim=-1)
    if target_rooms is not None and target_rooms.rounds is not None:
        tg, has = greedy_assign_rooms(agent_xy, online, cents, n_fr,
                                      cfg.coord, target_rooms.rounds)
    else:
        tg, has = greedy_assign(
            agent_xy, online, cents, n_fr, cfg.coord,
            room_boxes=None if target_rooms is None else target_rooms.boxes)
    return cents, n_fr, tg, has


def _ingest_batched(srv: MapState, est_x, est_y, est_yaw, dist4, lm_types,
                    alive, t, step_no: int, cfg: SwarmConfig,
                    params: AgentParams, scan_dist, merge_win_box=None,
                    enable_targets: bool = False,
                    target_rooms: Optional[TargetRooms] = None):
    """One step's N packets into the mapping server (the beam + kernel
    branch of the reference's _ingest_batched): frame-tracker advance, the
    anchored merge on merge steps, the beam rasters of every fan (window or
    room kernel, then the endpoint scatter where the kernel has no ring),
    zones, the closure ring, heartbeat, frontiers and targets on frontier
    steps, and the anchor freeze. `scan_dist` is None without a sweep."""
    n = cfg.n_agents
    sens = cfg.sensors
    dev = est_x.device
    merge_every = cfg.engine.merge_every
    merge_step = merge_every > 0 and \
        step_no % merge_every == merge_every - 1

    merge_dx, merge_dy, merge_dyaw = srv.merge_dx, srv.merge_dy, \
        srv.merge_dyaw
    frame = srv.frame
    if cfg.slam.merge_frame_gain > 0.0:
        adx, ady, fd = frame_advance(frame, est_x + params.x_offset, est_y,
                                     alive, cfg)
        merge_dx = merge_dx + adx
        merge_dy = merge_dy + ady
        frame = frame_add(frame, fd)
    rx = est_x + params.x_offset + srv.closure.drift_dx + merge_dx
    ry = est_y + srv.closure.drift_dy + merge_dy
    ryaw = est_yaw + merge_dyaw
    if cfg.slam.merge_frame_gain > 0.0:
        # scans project at the de-rotated (quantized) yaw
        ryaw = ryaw - frame_theta_q(frame.theta, cfg)

    # the merge, on merge steps only (an off-cadence step's merge block is
    # a no-op in the reference: no agent attempted, zero increments)
    merge_fail = srv.merge_fail
    i32, f32 = torch.int32, torch.float32
    merge_m = (torch.zeros((), dtype=i32, device=dev),
               torch.zeros((), dtype=f32, device=dev),
               torch.zeros((n,), dtype=torch.bool, device=dev),
               torch.zeros((n,), dtype=f32, device=dev))
    if merge_step:
        rx, ry, ryaw, (inc_dx, inc_dy, inc_dth), merge_fail, innovation, \
            merge_m = _merge_event(srv.logodds, srv.anchor, srv.merge_fail,
                                   frame, rx, ry, ryaw, est_yaw, scan_dist,
                                   alive, step_no, cfg, merge_win_box)
        if innovation is not None:
            frame = frame_add(frame, innovation)
        merge_dx = merge_dx + inc_dx
        merge_dy = merge_dy + inc_dy
        merge_dyaw = merge_dyaw + inc_dth

    last_packet_t = torch.where(alive, t, srv.last_packet_t)
    pkt_counts = srv.pkt_counts + alive.to(torch.int32)

    # 4-ray world projection with the trust filter
    angles = ryaw[:, None] + torch.tensor(sens.angles, dtype=rx.dtype,
                                          device=dev)[None, :]
    hit_valid = (dist4 > sens.min_range) & (dist4 <= sens.max_range)
    rng = torch.where(hit_valid, dist4, torch.full_like(dist4,
                                                        sens.max_range))
    hx = rx[:, None] + rng * torch.cos(angles)
    hy = ry[:, None] + rng * torch.sin(angles)

    # beam rasters of the fans through a kernel (the reference also builds
    # tri_state_view(logodds) here; only a frontier event reads it, so the
    # port builds it there)
    logodds, writes = _raster_fans(srv.logodds, torch.stack([rx, ry], -1),
                                   ryaw, dist4, scan_dist, alive, cfg)

    # territory AABBs fold the path point + valid hits
    agents = torch.arange(n, dtype=torch.int32, device=dev)
    zone = zone_observe_rows(
        srv.zone, torch.cat([rx[:, None], hx], dim=1),
        torch.cat([ry[:, None], hy], dim=1),
        torch.cat([alive[:, None], hit_valid & alive[:, None]], dim=1))

    closure, closed, _, _ = closure_add_poses_batch(
        srv.closure, rx, ry, agents, lm_types, cfg.slam, valid=alive,
        yaws=ryaw)

    online = heartbeat_update(last_packet_t, t, cfg.coord.heartbeat_timeout_s)

    # zone snapshot cadence (2 s)
    dt = cfg.nav.drive_tick_s + cfg.nav.settle_tick_s
    zone_every = max(1, round(cfg.coord.zone_interval_s / dt))
    zone_boxes, zone_active = srv.zone_boxes, srv.zone_active
    if step_no % zone_every == 0:
        zone_boxes, zone_active = zones_for_agents(
            zone, torch.stack([rx, ry], dim=-1), online)

    # frontier cadence (3 s; step 0 included)
    target_every = max(1, round(cfg.coord.target_interval_s / dt))
    cents, n_fr = srv.frontier_centroids, srv.n_frontiers
    targets = None
    if cfg.engine.compute_frontiers and step_no % target_every == 0:
        cents, n_fr, tg, has = _frontier_event(logodds, rx, ry, online, cfg,
                                               enable_targets, target_rooms)
        if tg is not None:
            targets = (tg, has)

    # freeze newly confident cells into the anchor at the merge cadence
    anchor = srv.anchor
    if cfg.slam.merge_anchor and merge_step and (
            cfg.slam.merge_anchor_freeze_steps <= 0
            or step_no < cfg.slam.merge_anchor_freeze_steps):
        anchor = torch.where(
            (torch.abs(srv.anchor) < 0.5) &
            (torch.abs(logodds) >= cfg.slam.merge_anchor_thresh),
            logodds, srv.anchor)

    new_srv = srv._replace(
        logodds=logodds, closure=closure, zone=zone,
        last_packet_t=last_packet_t, pkt_counts=pkt_counts,
        zone_boxes=zone_boxes, zone_active=zone_active,
        frontier_centroids=cents, n_frontiers=n_fr,
        total_writes=writes_accumulate(srv.total_writes, writes),
        merge_dx=merge_dx, merge_dy=merge_dy, merge_dyaw=merge_dyaw,
        anchor=anchor, merge_fail=merge_fail, frame=frame)
    return new_srv, closed, online, targets, \
        (rx, ry, ryaw, hx, hy, hit_valid), merge_m


def agent_merge_box(cfg: SwarmConfig, walls_grouped, room_of_agent,
                    device):
    """Per-agent merge-window clamp boxes (rmin, rmax, cmin, cmax) [N]
    int32 on `device` (swarm_tpu/engine/sim.py:771-787), or None when the
    merge is off or the world has no room geometry. Reads the geometry on
    the host."""
    if cfg.engine.merge_every <= 0 or walls_grouped is None or \
            room_of_agent is None:
        return None
    box = merge_window_box(torch.as_tensor(walls_grouped).cpu().numpy(),
                           torch.as_tensor(room_of_agent).cpu().numpy(), cfg)
    return tuple(torch.as_tensor(a, dtype=torch.int32, device=device)
                 for a in box)


def sim_step(state: SimState, noise: StepNoise, cfg: SwarmConfig, walls,
             params: AgentParams, faults: Optional[FaultSchedule] = None,
             enable_targets: bool = False, walls_grouped=None,
             room_of_agent=None, step_no: Optional[int] = None,
             merge_win_box=None, target_rooms: Optional[TargetRooms] = None):
    """Advance the whole swarm by one tick. Returns (new_state, StepMetrics).

    walls [S, 4] tensor; walls_grouped [G, S_g, 4] + room_of_agent [N]:
    culled casting, each agent against its own room's segments, the
    per-agent merge-window boxes (`agent_merge_box`) and, with
    `enable_targets`, the room boxes of target assignment
    (`agent_target_rooms`), each built here when not given. step_no:
    `state.step` as a host int, which decides the merge, zone and frontier
    cadences; read from the state (one device sync) when None."""
    check_supported(cfg)
    if step_no is None:
        step_no = int(state.step)
    n = cfg.n_agents
    navc = cfg.nav
    dt = navc.drive_tick_s + navc.settle_tick_s
    dev = state.pose_true.device
    if faults is None:
        faults = no_faults(device=dev)
    if merge_win_box is None:
        merge_win_box = agent_merge_box(cfg, walls_grouped, room_of_agent,
                                        dev)
    if enable_targets and target_rooms is None:
        target_rooms = agent_target_rooms(cfg, walls_grouped, room_of_agent,
                                          dev)
    alive = alive_mask(faults, n, state.t)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)

    if walls_grouped is not None:
        walls_agent = walls_grouped[room_of_agent.long()]     # [N, S_g, 4]
    else:
        walls_agent = walls

    # 1. sense from the TRUE pose
    dist4 = sense_4way(noise.sense, state.pose_true, walls_agent,
                       cfg.sensors)
    scan_dist = None
    if cfg.engine.scan_rays > 0:
        scan_dist = sense_scan(noise.scan, state.pose_true, walls_agent,
                               cfg.engine.scan_rays, cfg.sensors)

    # 2. landmark signature
    lm = detect_landmark_sim(dist4[:, 0], dist4[:, 1], dist4[:, 3],
                             navc.lm_sim_close_m, cfg.sensors.max_range)
    lm = torch.where(alive, lm, torch.zeros_like(lm))

    # 3. telemetry from the DRIFTED estimate (pre-motion)
    odom, encoder_total = encoder_emit(state.odom, cfg.noise)
    yaw_q = radians(quantize_yaw_deg(odom.yaw_est,
                                     cfg.noise.yaw_quantize_deg))

    # 4. server ingest
    srv, closed, online, targets, proj, merge_m = _ingest_batched(
        state.srv, odom.x_est, odom.y_est, yaw_q, dist4, lm, alive,
        state.t, step_no, cfg, params, scan_dist, merge_win_box,
        enable_targets, target_rooms)
    rx_t, ry_t, ryaw_t, hx_t, hy_t, hv_t = proj
    n_merges, merge_fit, merge_ok_a, merge_fit_a = merge_m
    est_x_t = odom.x_est + params.x_offset
    est_y_t = odom.y_est
    est_yaw_t = odom.yaw_est

    # target delivery on frontier steps: targets arrive in the server frame,
    # agents navigate in their odometry frame
    nav = state.nav
    if targets is not None:
        tg, has = targets
        tgt_local = tg - torch.stack(
            [params.x_offset + srv.closure.drift_dx + srv.merge_dx,
             srv.closure.drift_dy + srv.merge_dy], dim=-1)
        nav = navm.assign_target(nav, tgt_local, has & alive)

    # 5. navigate (the estimate drives the FSM)
    est_pose = torch.stack([odom.x_est, odom.y_est, odom.yaw_est], dim=-1)
    zone_local = srv.zone_boxes - torch.stack(
        [params.x_offset, zeros, params.x_offset, zeros], dim=-1)
    nav, cmd = navm.nav_step(nav, navm.NavParams(
        wall_side=params.wall_side, motor_pwm=params.motor_pwm,
        return_style=params.return_style,
        home_x=params.home_x, home_y=params.home_y),
        dist4, est_pose, state.total_dist, zone_local,
        srv.zone_active, dt, navc)

    drive = torch.where(alive, cmd.drive_m, zeros)
    turn = torch.where(alive, cmd.turn_cmd_rad, zeros)
    steer = torch.where(alive, cmd.steer_rad, zeros)

    # 6. physics: turns rotate the heading, steering bends the burst;
    #    wall-collision clamp
    yaw_true = wrap_pi(state.pose_true[:, 2] + turn)
    move_dir = yaw_true + steer
    clear = cast_rays(state.pose_true[:, None, :2], move_dir[:, None],
                      walls_for_rays(walls_agent))[:, 0]
    drive = torch.minimum(drive, torch.clamp_min(clear - 0.08, 0.0))
    x_true = state.pose_true[:, 0] + drive * torch.cos(move_dir)
    y_true = state.pose_true[:, 1] + drive * torch.sin(move_dir)
    pose_true = torch.stack([x_true, y_true, yaw_true], dim=-1)
    total_dist = state.total_dist + drive

    # 7. odometry drift integrate + EKF
    odom = drift_integrate(noise.drift, odom, drive, turn,
                           params.trans_scale, params.yaw_bias_per_m,
                           cfg.noise)
    t_new = state.t + dt
    ekf = ekf_step_batch(state.ekf, turn / dt, drive / dt,
                         t_new.expand(n), cfg.ekf)
    odom = odom._replace(yaw_est=torch.where(
        params.ekf_yaw, wrap_pi(ekf.x[:, 2]), odom.yaw_est))

    corr_x = odom.x_est + params.x_offset + srv.closure.drift_dx + \
        srv.merge_dx
    corr_y = odom.y_est + srv.closure.drift_dy + srv.merge_dy
    true_x = pose_true[:, 0] + params.x_offset
    err = torch.sqrt((corr_x - true_x) ** 2 + (corr_y - pose_true[:, 1]) ** 2)

    # v2v: distance to the nearest live agent, or the broadcast counter
    txy = state.pose_true[:, :2] + torch.stack([params.x_offset, zeros], -1)
    v2v_cm, v2v_n = v2v_stats(txy, alive, cfg.sensors.v2v_range_m)
    rx_per_tick = torch.round(
        v2v_n.to(torch.float32) * cfg.sensors.v2v_broadcast_hz * dt
    ).to(torch.int32)
    v2v_total = state.v2v_total + torch.where(alive, rx_per_tick,
                                              torch.zeros_like(rx_per_tick))
    v2v = torch.where(params.v2v_count, v2v_total, v2v_cm)

    new_state = SimState(
        t=t_new, step=state.step + 1, pose_true=pose_true, odom=odom,
        ekf=ekf, nav=nav, total_dist=total_dist, v2v_total=v2v_total,
        srv=srv)
    i32 = torch.int32
    metrics = StepMetrics(
        writes=writes_delta(srv.total_writes, state.srv.total_writes),
        closures=closed.sum().to(i32),
        online=online.sum().to(i32),
        n_frontiers=srv.n_frontiers,
        pose_err=torch.where(alive, err, zeros).mean(),
        mission_done=nav.mission_complete.sum().to(i32),
        merges=n_merges,
        merge_fitness=merge_fit,
        band_escapes=torch.zeros((), dtype=i32, device=dev),
        t=state.t,
        srv_x=rx_t, srv_y=ry_t, srv_yaw=ryaw_t, yaw_q=yaw_q,
        est_x=est_x_t, est_y=est_y_t, est_yaw=est_yaw_t,
        merge_ok=merge_ok_a,
        merge_fit=merge_fit_a,
        encoder=encoder_total, v2v=v2v,
        dist_m=dist4, landmark=lm,
        hits=torch.stack([hx_t, hy_t], dim=-1),
        hit_valid=hv_t & alive[:, None],
        alive=alive)
    return new_state, metrics


def make_sim_step(cfg: SwarmConfig, walls, params: AgentParams,
                  generator: torch.Generator,
                  faults: Optional[FaultSchedule] = None,
                  enable_targets: bool = False, walls_grouped=None,
                  room_of_agent=None):
    """A single-argument step closure — the deployable engine. Noise comes
    from `generator` (on the params' device) unless a StepNoise is passed.

    The closure keeps the step number on the host, so the merge and
    frontier cadences cost no device sync: it reads `state.step` once, on
    the first call and whenever it is handed a state it did not return, and
    counts from there. The merge-window boxes and the target-assignment
    room boxes are built once."""
    check_supported(cfg)
    dev = params.home_x.device

    def as_t(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    walls_t, wg_t, roa_t = as_t(walls), as_t(walls_grouped), \
        as_t(room_of_agent)
    win_box = agent_merge_box(cfg, wg_t, roa_t, dev)
    rooms = (agent_target_rooms(cfg, wg_t, roa_t, dev) if enable_targets
             else None)
    host = {"state": None, "step": 0}

    def step(state: SimState, noise: Optional[StepNoise] = None):
        if noise is None:
            noise = draw_step_noise(generator, cfg.n_agents,
                                    cfg.engine.scan_rays, dev)
        if state is not host["state"]:
            host["step"] = int(state.step)
        out = sim_step(state, noise, cfg, walls_t, params, faults,
                       enable_targets, walls_grouped=wg_t,
                       room_of_agent=roa_t, step_no=host["step"],
                       merge_win_box=win_box, target_rooms=rooms)
        host["state"], host["step"] = out[0], host["step"] + 1
        return out

    return step


def rollout_writes(metrics: StepMetrics) -> int:
    """The applied writes of a rollout (`StepMetrics` stacked over steps,
    as `sim_rollout` returns them), summed in int64 on the host: each
    step's count fits int32, their sum need not (bench.py sums its chunks
    the same way)."""
    return int(metrics.writes.cpu().to(torch.int64).sum())


def sim_rollout(state: SimState, n_steps: int, cfg: SwarmConfig, walls,
                params: AgentParams, generator: torch.Generator,
                faults: Optional[FaultSchedule] = None,
                enable_targets: bool = False, walls_grouped=None,
                room_of_agent=None):
    """n_steps of the fused step in a Python loop. Returns (final state,
    StepMetrics with every field stacked over steps)."""
    step = make_sim_step(cfg, walls, params, generator, faults,
                         enable_targets, walls_grouped, room_of_agent)
    ms = []
    for _ in range(n_steps):
        state, m = step(state)
        ms.append(m)
    return state, StepMetrics(*(torch.stack(f) for f in zip(*ms)))
