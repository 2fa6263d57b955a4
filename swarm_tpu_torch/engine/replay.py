"""The mapping server over a packet stream (swarm_tpu/engine/replay.py).

Per packet the reference server applies the agent separation offset and
the accumulated SLAM drift correction, traces the four sensor rays into
the tri-state grid with the trust filter, folds hits and path into the
territory AABBs, adds the pose to the loop-closure graph, and on its 2 s /
3 s cadences snapshots zones and frontier targets. The JAX package runs
that as a `lax.scan` of `ingest_packet` over the packets.

`replay_session` computes the same result without a loop over packets:
  * the grid never feeds back into a pose, so each packet's rays depend
    only on the packet and on the drift corrections of the closures
    before it; the only sequential coupling is the closures. The closure
    test runs vectorised (`slam/closure.seq_match`) on a window of the
    remaining stream with the drift frozen. A closure moves only its own
    agent's drift and guard, so every packet is exact up to the first one
    whose agent closed earlier in the window, which ends the segment. The
    segment's corrections, guards and ring appends are applied
    (`seq_apply`) and the next window starts at that packet. One host read
    per window: where the segment ends (ROADMAP C33);
  * then one `parity_raster` update over all 4T rays in packet order:
    sequence ids decide each cell as the sequential writes would, and a
    packet's writes (its rays' traced cells) do not depend on the grid;
  * the zone and target cadences are a recurrence on the timestamps alone
    (one host read of t and valid); only the last snapshot of each reaches
    the state, so the running zone boxes, positions and heartbeat are
    taken at that packet by per-agent prefix reductions, and with
    `compute_frontiers` the grid is rastered in two parts split at the last
    target packet, whose grid `frontier_clusters` sees.

`ingest_packet` is the per-packet body, `ingest_frame` the serving form:
one frame of packets as a single batched update (frame-coarse closures and
cadences, the grid order-exact).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.coord.assign import greedy_assign
from swarm_tpu_torch.coord.heartbeat import heartbeat_update
from swarm_tpu_torch.coord.zones import (LIFT, ZoneState, zone_init,
                                         zone_observe, zone_observe_batch,
                                         zones_for_agents)
from swarm_tpu_torch.engine.sim import WRITES_RADIX, writes_accumulate
from swarm_tpu_torch.ops.frontier import frontier_clusters
from swarm_tpu_torch.ops.raster import (RayBatch, _traced_cells,
                                        parity_apply, parity_raster)
from swarm_tpu_torch.slam.closure import (ClosureState,
                                          closure_add_poses_batch,
                                          closure_init, seq_apply, seq_match)

# packets in each closure window of replay_session. Where a window ends
# changes no result, only the time: windows of 64-4096 packets were timed
# on the H100 (chip_smoke.py phase 23), and 256 was the fastest on
# bench_serve's ring with the dual session's landmarks (a window commits
# ~70 packets there); without landmarks larger windows win, since the
# stream then needs T / WINDOW host reads
WINDOW = 256


class PacketStream(NamedTuple):
    """Time-ordered telemetry packets as tensors [T] (QuasarPacket v2
    fields)."""
    t: torch.Tensor          # [T] seconds
    agent: torch.Tensor      # [T] int32, 0-based
    x: torch.Tensor          # [T] reported odometry
    y: torch.Tensor
    yaw: torch.Tensor        # [T] radians
    encoder: torch.Tensor    # [T] int32
    v2v: torch.Tensor        # [T] int32
    dist: torch.Tensor       # [T, 4] metres (front, left, back, right)
    landmark: torch.Tensor   # [T] int32
    valid: torch.Tensor      # [T] bool (padding mask)


class ServerState(NamedTuple):
    grid: torch.Tensor            # [S, S] int8 tri-state
    closure: ClosureState
    zone: ZoneState
    last_packet_t: torch.Tensor   # [N]
    pkt_counts: torch.Tensor      # [N] int32
    agent_xy: torch.Tensor        # [N, 2] last corrected position
    agent_yaw: torch.Tensor       # [N]
    zone_boxes: torch.Tensor      # [N, 4] latest snapshot
    zone_active: torch.Tensor     # [N] bool
    targets: torch.Tensor         # [N, 2]
    has_target: torch.Tensor      # [N] bool
    frontier_centroids: torch.Tensor  # [K, 2]
    n_frontiers: torch.Tensor     # [] int32
    last_zone_t: torch.Tensor     # []
    last_target_t: torch.Tensor   # []
    total_writes: torch.Tensor    # [2] int32 (hi, lo), engine.sim's counter


class ReplayOutputs(NamedTuple):
    """Per-packet outputs: what the reference logs to CSV and renders."""
    rx: torch.Tensor          # corrected pose (telemetry.csv columns)
    ry: torch.Tensor
    yaw: torch.Tensor
    hits: torch.Tensor        # [T, 4, 2] world hit points
    hit_valid: torch.Tensor   # [T, 4]
    closed: torch.Tensor      # [T] bool loop closure fired
    corr: torch.Tensor        # [T, 2] closure correction
    online: torch.Tensor      # [T, N] heartbeat snapshot
    writes: torch.Tensor      # [T] grid cell writes


class ReplayStats(NamedTuple):
    """How `replay_session` split its stream: closure windows (one host
    read each) and the closures in the stream."""
    windows: int
    closures: int


def server_init(cfg: SwarmConfig, t0: float = 0.0,
                device=None) -> ServerState:
    dev = default_device(device)
    n = cfg.n_agents
    s = cfg.grid.size
    k = cfg.coord.max_frontiers
    f32 = dict(dtype=torch.float32, device=dev)
    return ServerState(
        grid=torch.full((s, s), cfg.grid.unknown, dtype=torch.int8,
                        device=dev),
        closure=closure_init(
            n, cfg.slam,
            scan_rays=(cfg.engine.scan_rays
                       if cfg.slam.closure_scanmatch else 0), device=dev),
        zone=zone_init(n, device=dev),
        last_packet_t=torch.zeros((n,), **f32),
        pkt_counts=torch.zeros((n,), dtype=torch.int32, device=dev),
        agent_xy=torch.zeros((n, 2), **f32),
        agent_yaw=torch.zeros((n,), **f32),
        zone_boxes=torch.tensor(LIFT, **f32).repeat(n, 1),
        zone_active=torch.zeros((n,), dtype=torch.bool, device=dev),
        targets=torch.zeros((n, 2), **f32),
        has_target=torch.zeros((n,), dtype=torch.bool, device=dev),
        frontier_centroids=torch.zeros((k, 2), **f32),
        n_frontiers=torch.zeros((), dtype=torch.int32, device=dev),
        last_zone_t=torch.tensor(t0, **f32),
        last_target_t=torch.tensor(t0, **f32),
        total_writes=torch.zeros((2,), dtype=torch.int32, device=dev))


def _rays(rx, ry, yaw, dist, valid, cfg: SwarmConfig):
    """The four sensor rays of packets [T] with the trust filter: (hx, hy
    [T, 4], hit_valid [T, 4], RayBatch of the 4T rays in packet order)."""
    sens = cfg.sensors
    angles = yaw[:, None] + torch.tensor(sens.angles, dtype=rx.dtype,
                                         device=rx.device)
    hit_valid = (dist > sens.min_range) & (dist <= sens.max_range)
    rng = torch.where(hit_valid, dist, torch.full_like(dist,
                                                       sens.max_range))
    hx = rx[:, None] + rng * torch.cos(angles)
    hy = ry[:, None] + rng * torch.sin(angles)
    rays = RayBatch(ox=rx.repeat_interleave(4), oy=ry.repeat_interleave(4),
                    hx=hx.reshape(-1), hy=hy.reshape(-1),
                    hit_valid=hit_valid.reshape(-1),
                    active=valid.repeat_interleave(4))
    return hx, hy, hit_valid, rays


def _add_writes(tw, total):
    """The (hi, lo) counter plus `total` writes (any size)."""
    lo = tw[1].to(torch.int64) + total
    carry = torch.div(lo, WRITES_RADIX, rounding_mode="floor")
    return torch.stack([tw[0] + carry, lo - carry * WRITES_RADIX]).to(
        torch.int32)


def _drift_of(closure: ClosureState, agent):
    """The accumulated drift correction (dx, dy) of each packet's agent."""
    a = agent.long()
    return closure.drift_dx[a], closure.drift_dy[a]


def ingest_packet(state: ServerState, pkt, cfg: SwarmConfig, offsets,
                  enable_targets: bool = False,
                  compute_frontiers: bool = False):
    """Process ONE packet (a PacketStream row of 0-d tensors): the
    reference's per-packet body. With `compute_frontiers` a packet on the
    target cadence reads that flag on the host."""
    one = PacketStream(*(f.reshape((1,) + f.shape) for f in pkt))
    a = one.agent.long()
    valid = one.valid
    dx, dy = _drift_of(state.closure, one.agent)
    rx = one.x + offsets[a] + dx
    ry = one.y + dy
    t = one.t[0]

    def put(buf, vals):
        return buf.index_copy(0, a, torch.where(
            valid.reshape((1,) * buf.dim()), vals, buf[a]))
    last_packet_t = put(state.last_packet_t, one.t)
    pkt_counts = state.pkt_counts.index_add(0, a, valid.to(torch.int32))
    agent_xy = put(state.agent_xy, torch.stack([rx, ry], dim=-1))
    agent_yaw = put(state.agent_yaw, one.yaw)

    hx, hy, hit_valid, rays = _rays(rx, ry, one.yaw, one.dist, valid, cfg)
    grid, writes = parity_raster(state.grid, rays, cfg.grid)
    zone = zone_observe(state.zone, one.agent[0],
                        torch.cat([rx, hx[0]]), torch.cat([ry, hy[0]]),
                        torch.cat([valid, hit_valid[0] & valid]))

    m = seq_match(state.closure, rx, ry, one.agent, one.landmark, cfg.slam,
                  valid)
    closure = seq_apply(state.closure, m, rx, ry, one.agent, one.landmark,
                        valid)
    online = heartbeat_update(last_packet_t, t, cfg.coord.heartbeat_timeout_s)

    do_zone = valid[0] & ((t - state.last_zone_t) >
                          cfg.coord.zone_interval_s)
    boxes, active = zones_for_agents(zone, agent_xy, online)
    zone_boxes = torch.where(do_zone, boxes, state.zone_boxes)
    zone_active = torch.where(do_zone, active, state.zone_active)
    last_zone_t = torch.where(do_zone, t, state.last_zone_t)

    do_target = valid[0] & ((t - state.last_target_t) >
                            cfg.coord.target_interval_s)
    cents, n_fr = state.frontier_centroids, state.n_frontiers
    targets, has_target = state.targets, state.has_target
    if compute_frontiers and bool(do_target):
        cents, _, n_fr = frontier_clusters(grid, cfg.grid, cfg.coord)
        if enable_targets:
            targets, has_target = greedy_assign(agent_xy, online, cents,
                                                n_fr, cfg.coord)
        else:
            has_target = torch.zeros_like(state.has_target)
    last_target_t = torch.where(do_target, t, state.last_target_t)

    writes = writes.to(torch.int32)
    new_state = ServerState(
        grid=grid, closure=closure, zone=zone,
        last_packet_t=last_packet_t, pkt_counts=pkt_counts,
        agent_xy=agent_xy, agent_yaw=agent_yaw,
        zone_boxes=zone_boxes, zone_active=zone_active,
        targets=targets, has_target=has_target,
        frontier_centroids=cents, n_frontiers=n_fr,
        last_zone_t=last_zone_t, last_target_t=last_target_t,
        total_writes=writes_accumulate(state.total_writes, writes))
    out = ReplayOutputs(
        rx=rx[0], ry=ry[0], yaw=one.yaw[0],
        hits=torch.stack([hx[0], hy[0]], dim=-1),
        hit_valid=hit_valid[0] & valid[0], closed=m.closed[0],
        corr=torch.stack([m.cdx[0], m.cdy[0]]), online=online,
        writes=writes)
    return new_state, out


def _closure_segments(closure: ClosureState, stream: PacketStream,
                      base_x, cfg: SwarmConfig):
    """The closures of the whole stream in windows (module docstring).
    Returns (closure state, rx, ry, closed, cdx, cdy [T], ReplayStats)."""
    T = stream.t.shape[0]
    parts = []
    start, windows = 0, 0
    while start < T:
        sl = slice(start, min(T, start + WINDOW))
        ag, lm, valid = stream.agent[sl], stream.landmark[sl], \
            stream.valid[sl]
        dx, dy = _drift_of(closure, ag)
        xs, ys = base_x[sl] + dx, stream.y[sl] + dy
        m = seq_match(closure, xs, ys, ag, lm, cfg.slam, valid)
        n = xs.shape[0]
        # the host read: packets before the first one whose agent closed
        # earlier in the window (its drift and guard moved)
        pos = torch.arange(n, device=xs.device)
        first = torch.full_like(closure.last_closure_node, n,
                                dtype=torch.int64).scatter_reduce(
            0, ag.long(), torch.where(m.closed, pos, n), "amin")
        late = first[ag.long()] < pos
        end = int(torch.where(late.any(), torch.argmax(
            late.to(torch.int8)), n))
        windows += 1
        cut = slice(0, end)
        m = type(m)(*(f[cut] for f in m))
        closure = seq_apply(closure, m, xs[cut], ys[cut], ag[cut], lm[cut],
                            valid[cut])
        parts.append((xs[cut], ys[cut], m.closed, m.cdx, m.cdy))
        start += end
    if not parts:
        z = base_x[:0]
        parts = [(z, z, stream.valid[:0], z, z)]
    rx, ry, closed, cdx, cdy = (torch.cat(p) for p in zip(*parts))
    stats = ReplayStats(windows=windows, closures=int(closed.sum()))
    return closure, rx, ry, closed, cdx, cdy, stats


def _last_fire(t_h, valid_h, t0, interval: float):
    """The last packet at which the cadence `(t - last) > interval` fires
    (None if it never does), in float32 as the reference compares.

    One step per firing, in any packet order: `last` only grows, so no
    valid packet up to a firing passes the test against the new `last`,
    and the next firing is the first packet whose running maximum of the
    valid timestamps passes it (a binary search, the test being monotone
    in t); that packet's timestamp is the running maximum."""
    idx = np.flatnonzero(valid_h)
    top = np.maximum.accumulate(t_h[idx].astype(np.float32))
    last, iv, fired = np.float32(t0), np.float32(interval), None
    lo = 0
    while True:
        hi = top.shape[0]
        while lo < hi:
            mid = (lo + hi) // 2
            if (top[mid] - last) > iv:
                hi = mid
            else:
                lo = mid + 1
        if lo == top.shape[0]:
            return fired
        last, fired = top[lo], int(idx[lo])
        lo += 1


def replay_session(stream: PacketStream, cfg: SwarmConfig, offsets=None,
                   t0=None, enable_targets: bool = False,
                   compute_frontiers: bool = False, stats: bool = False):
    """Replay a whole time-ordered packet stream (module docstring).
    Returns (final ServerState, per-packet ReplayOutputs), and the
    ReplayStats of the closure windows as a third value with `stats`.
    Everything is computed on the stream's device."""
    dev = stream.t.device
    n = cfg.n_agents
    T = stream.t.shape[0]
    if offsets is None:
        offsets = torch.zeros((n,), dtype=torch.float32, device=dev)
    t_h = stream.t.cpu().numpy()
    valid_h = stream.valid.cpu().numpy()
    if t0 is None:
        t0 = t_h[0]
    t0 = np.float32(t0)
    state = server_init(cfg, t0=float(t0), device=dev)
    a = stream.agent.long()
    valid = stream.valid

    closure, rx, ry, closed, cdx, cdy, st = _closure_segments(
        state.closure, stream, stream.x + offsets[a], cfg)

    # per agent, the last valid packet at or before each packet [T, N]
    ar = torch.arange(T, device=dev)
    mine = (a[:, None] == torch.arange(n, device=dev)[None, :]) & \
        valid[:, None]
    last = torch.cummax(torch.where(mine, ar[:, None], -1), dim=0).values
    seen = last >= 0
    lc = torch.clamp_min(last, 0)
    lpt = torch.where(seen, stream.t[lc], torch.zeros_like(stream.t[lc]))
    online = heartbeat_update(lpt, stream.t[:, None],
                              cfg.coord.heartbeat_timeout_s)

    def agents_at(i):
        """(agent_xy [N, 2], agent_yaw [N]) after packet i."""
        xy = torch.where(seen[i, :, None],
                         torch.stack([rx[lc[i]], ry[lc[i]]], dim=-1),
                         state.agent_xy)
        return xy, torch.where(seen[i], stream.yaw[lc[i]], state.agent_yaw)

    hx, hy, hit_valid, rays = _rays(rx, ry, stream.yaw, stream.dist, valid,
                                    cfg)
    flat, free, occ = _traced_cells(rays, cfg.grid, 32)
    writes = (free.sum(dim=1) + occ.sum(dim=1)).reshape(T, 4).sum(dim=1) \
        .to(torch.int32)

    path_pts = (a, rx, ry, valid)
    hit_pts = (a.repeat_interleave(4), hx.reshape(-1), hy.reshape(-1),
               (hit_valid & valid[:, None]).reshape(-1))

    def zone_upto(i):
        """Territory boxes over packets [0, i]."""
        k = T if i is None else i + 1
        return zone_observe_batch(
            state.zone, *(torch.cat([p[:k], h[:4 * k]])
                          for p, h in zip(path_pts, hit_pts)))

    zone = zone_upto(None)
    zone_boxes, zone_active, last_zone_t = (state.zone_boxes,
                                            state.zone_active,
                                            state.last_zone_t)
    iz = _last_fire(t_h, valid_h, t0, cfg.coord.zone_interval_s)
    if iz is not None:
        xy, _ = agents_at(iz)
        zone_boxes, zone_active = zones_for_agents(zone_upto(iz), xy,
                                                   online[iz])
        last_zone_t = stream.t[iz]

    grid = state.grid
    cents, n_fr = state.frontier_centroids, state.n_frontiers
    targets, has_target = state.targets, state.has_target
    last_target_t = state.last_target_t
    ig = _last_fire(t_h, valid_h, t0, cfg.coord.target_interval_s)
    split = 0
    if ig is not None:
        last_target_t = stream.t[ig]
        if compute_frontiers:
            split = 4 * (ig + 1)
            grid = parity_apply(grid, flat[:split], free[:split],
                                occ[:split], cfg.grid)
            cents, _, n_fr = frontier_clusters(grid, cfg.grid, cfg.coord)
            if enable_targets:
                xy, _ = agents_at(ig)
                targets, has_target = greedy_assign(xy, online[ig], cents,
                                                    n_fr, cfg.coord)
            else:
                has_target = torch.zeros_like(has_target)
    grid = parity_apply(grid, flat[split:], free[split:], occ[split:],
                        cfg.grid)

    if T:
        agent_xy, agent_yaw = agents_at(T - 1)
        last_packet_t = lpt[-1]
    else:
        agent_xy, agent_yaw = state.agent_xy, state.agent_yaw
        last_packet_t = state.last_packet_t
    new_state = ServerState(
        grid=grid, closure=closure, zone=zone,
        last_packet_t=last_packet_t,
        pkt_counts=state.pkt_counts.index_add(0, a, valid.to(torch.int32)),
        agent_xy=agent_xy, agent_yaw=agent_yaw,
        zone_boxes=zone_boxes, zone_active=zone_active,
        targets=targets, has_target=has_target,
        frontier_centroids=cents, n_frontiers=n_fr,
        last_zone_t=last_zone_t, last_target_t=last_target_t,
        total_writes=_add_writes(state.total_writes,
                                 writes.to(torch.int64).sum()))
    out = ReplayOutputs(
        rx=rx, ry=ry, yaw=stream.yaw,
        hits=torch.stack([hx, hy], dim=-1),
        hit_valid=hit_valid & valid[:, None], closed=closed,
        corr=torch.stack([cdx, cdy], dim=-1), online=online, writes=writes)
    return (new_state, out, st) if stats else (new_state, out)


def ingest_frame(state: ServerState, batch: PacketStream,
                 cfg: SwarmConfig, offsets, enable_targets: bool = False,
                 compute_frontiers: bool = False, scans=None):
    """The serving form: one FRAME of packets [B] applied as a single
    batched update, with the reference's frame-coarse semantics:
      * the grid stays order-exact (`parity_raster` over the frame's rays
        in packet order);
      * closure drift corrections apply from the NEXT frame on;
      * closures, the zone snapshot and the frontier cadence evaluate once
        per frame at the frame's latest timestamp;
      * closure matching uses each agent's LAST packet of the frame
        (`closure_add_poses_batch`; with `scans` [N, R], each agent's
        latest sweep, the scan-matched closures).
    With `compute_frontiers` a frame on the target cadence reads that flag
    on the host. Returns (new_state, ReplayOutputs [B]): the frame-level
    closure results land on each agent's last packet row, `online` on
    every row, the frame's writes on row 0."""
    n = cfg.n_agents
    t, agent, valid = batch.t, batch.agent, batch.valid
    b = t.shape[0]
    dev = t.device
    a = agent.long()

    dx, dy = _drift_of(state.closure, agent)
    rx = batch.x + offsets[a] + dx
    ry = batch.y + dy
    ryaw = batch.yaw

    # per-agent LAST valid packet of the frame
    pos = torch.where(valid, torch.arange(b, device=dev),
                      torch.full_like(a, -1))
    pos_last = torch.full((n,), -1, dtype=torch.int64,
                          device=dev).scatter_reduce(0, a, pos, "amax")
    has = pos_last >= 0
    pl = torch.clamp(pos_last, 0, max(b - 1, 0))

    last_packet_t = torch.where(has, t[pl], state.last_packet_t)
    pkt_counts = state.pkt_counts.index_add(0, a, valid.to(torch.int32))
    agent_xy = torch.where(has[:, None],
                           torch.stack([rx[pl], ry[pl]], dim=-1),
                           state.agent_xy)
    agent_yaw = torch.where(has, ryaw[pl], state.agent_yaw)

    hx, hy, hit_valid, rays = _rays(rx, ry, ryaw, batch.dist, valid, cfg)
    grid, writes = parity_raster(state.grid, rays, cfg.grid)

    zone = zone_observe_batch(
        state.zone, torch.cat([agent, agent.repeat_interleave(4)]),
        torch.cat([rx, hx.reshape(-1)]), torch.cat([ry, hy.reshape(-1)]),
        torch.cat([valid, (hit_valid & valid[:, None]).reshape(-1)]))

    closure, closed_a, cdx_a, cdy_a = closure_add_poses_batch(
        state.closure, rx[pl], ry[pl],
        torch.arange(n, dtype=torch.int32, device=dev),
        batch.landmark[pl], cfg.slam, valid=has, yaws=agent_yaw,
        scans=scans, grid=cfg.grid, sens=cfg.sensors)

    t_frame = torch.where(valid, t, torch.full_like(t, float("-inf"))) \
        .amax() if b else torch.tensor(float("-inf"), device=dev)
    t_frame = torch.where(torch.isfinite(t_frame), t_frame,
                          state.last_zone_t)
    online = heartbeat_update(last_packet_t, t_frame,
                              cfg.coord.heartbeat_timeout_s)

    any_valid = valid.any()
    do_zone = any_valid & ((t_frame - state.last_zone_t) >
                           cfg.coord.zone_interval_s)
    boxes, active = zones_for_agents(zone, agent_xy, online)
    zone_boxes = torch.where(do_zone, boxes, state.zone_boxes)
    zone_active = torch.where(do_zone, active, state.zone_active)
    last_zone_t = torch.where(do_zone, t_frame, state.last_zone_t)

    do_target = any_valid & ((t_frame - state.last_target_t) >
                             cfg.coord.target_interval_s)
    cents, n_fr = state.frontier_centroids, state.n_frontiers
    targets, has_target = state.targets, state.has_target
    if compute_frontiers and bool(do_target):
        cents, _, n_fr = frontier_clusters(grid, cfg.grid, cfg.coord)
        if enable_targets:
            targets, has_target = greedy_assign(agent_xy, online, cents,
                                                n_fr, cfg.coord)
        else:
            has_target = torch.zeros_like(state.has_target)
    last_target_t = torch.where(do_target, t_frame, state.last_target_t)

    writes = writes.to(torch.int32)
    new_state = ServerState(
        grid=grid, closure=closure, zone=zone,
        last_packet_t=last_packet_t, pkt_counts=pkt_counts,
        agent_xy=agent_xy, agent_yaw=agent_yaw,
        zone_boxes=zone_boxes, zone_active=zone_active,
        targets=targets, has_target=has_target,
        frontier_centroids=cents, n_frontiers=n_fr,
        last_zone_t=last_zone_t, last_target_t=last_target_t,
        total_writes=writes_accumulate(state.total_writes, writes))

    # frame-level closure results on each agent's LAST packet row
    fired = closed_a & has
    rows = torch.where(has, pl, torch.full_like(pl, b))
    closed_b = torch.zeros((b + 1,), dtype=torch.bool,
                           device=dev).index_copy(0, rows, fired)[:b]
    corr_b = torch.zeros((b + 1, 2), dtype=torch.float32,
                         device=dev).index_copy(
        0, rows, torch.stack([cdx_a, cdy_a], dim=-1) *
        fired[:, None].to(torch.float32))[:b]
    out = ReplayOutputs(
        rx=rx, ry=ry, yaw=ryaw, hits=torch.stack([hx, hy], dim=-1),
        hit_valid=hit_valid & valid[:, None], closed=closed_b, corr=corr_b,
        online=online[None, :].expand(b, n),
        writes=torch.where(torch.arange(b, device=dev) == 0, writes,
                           torch.zeros_like(writes)))
    return new_state, out
