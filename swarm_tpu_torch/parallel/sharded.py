"""The fused swarm step sharded over ranks with `torch.distributed`
(swarm_tpu/parallel/sharded.py), one process per device.

Decomposition, as the reference's `shard_map` body has it:
  * Agent state (pose, odometry, EKF, nav FSM) is split by rank: rank r
    holds the rows of global agents [r * n_loc, (r + 1) * n_loc), and the
    per-agent sensing, physics, estimation and navigation need no
    communication.
  * The occupancy grid is one of three decompositions (`grid_sharding`):
    "replicated" (every rank rasters its agents into a full-grid delta and
    one `all_reduce` sums them), "rows" (rank r owns the r-th row band; its
    agents' evidence is proven band-contained, so the map needs no
    collective) or "tiles" (an R x C rank grid of tiles; each rank rasters
    into its tile plus a halo ring, and the ring goes to the neighbours that
    own it, row phase first, with `batch_isend_irecv`).
  * The small coordination state (closure ring, zones, heartbeat, merge
    corrections, frame tracker: all O(N)) is replicated: the ranks
    all-gather the step's per-agent packets, concatenated in rank order, and
    every rank computes the same server update.

The step's collectives are one all-gather of the packed per-agent rows (one
tensor per dtype), one all-reduce of the scalar metrics (one per dtype),
the map's all-reduce ("replicated") or halo exchange ("tiles"), and on
frontier steps the gather of the map. Each is a module-level function
(`_all_reduce_sum`, `_gather_rows`, `_halo_exchange`, `_gather_grid`), so a
profiler can wrap them by name.

Noise: the reference keys each agent's draws by its global id, so any mesh
gives the fused step's draws. Here every rank draws the whole step's
`StepNoise` (`engine.sim.draw_step_noise`, all N agents) from a generator
seeded alike on every rank and takes its rows: the same draws for any world
size, and the fused port's draws from the same seed.

The raster is the reference body's choice (`_raster`): in the beam mode
each fan through the window kernel (band and tile forms) or, with
use_pallas=False, the XLA fast tier (`ops.beam_raster.free_raster_reference`
plus the exact endpoint delta); in every other raster mode the line
scatter (`_line_scatter`: the 4-way and sweep rays through
`ops.raster.logodds_delta`, summed in ray order). The XLA tier and the line
scatter compute in global coordinates, so "rows" and "tiles" are bit-equal
to "replicated" on them.

Where the port follows the reference body rather than the fused step: the
sensing and the physics cast against ALL walls, not the agent's room
(sharded.py:269-270, :317-320, :741; at 1024 agents 185 rays x 2048
segments per agent, done in agent chunks so that no temporary reaches a
gigabyte); the window raster paints into a zeroed delta that is added to
the grid once, after the decompositions merge (:501-509, :584); it passes
no `pack8`, so the per-beam table is pack16; `pose_err` compares the
step's raster pose with the moved true pose (:763). The logged merge-fix
stream is the fused engine's (ROADMAP C3). With scan-matched closures
(`slam.closure_scanmatch`) every agent's sweep joins the gather, as the
reference gathers it (:594-606), and every rank runs the matcher on the
replicated closure ring.

Entry points: `make_sharded_sim_step` (the step, with the reference's
static proofs), `shard_state` / `gather_state` (a global `SimState` to this
rank's part and back), `agent_evidence_box`, `agent_evidence_rows` and
`merge_window_box` (the static per-agent boxes; the fused step uses
`merge_window_box` too).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.geom.world import TILE_COLS, TILE_ROWS
from swarm_tpu_torch.slam.livemerge import merge_window_side

GRID_SHARDINGS = ("replicated", "rows", "tiles")
# agents per chunk of the all-walls ray cast: a chunk's [agents, rays,
# segments] float32 temporaries stay near 128 MB each
CAST_CHUNK_ELEMS = 1 << 25


def agent_evidence_box(walls_grouped, room_of_agent, cfg: SwarmConfig,
                       margin_cells: int = 3,
                       drift_margin_m: float = 1.0):
    """Static per-agent grid (row, col) bounds of possible raster
    evidence: (rmin, rmax, cmin, cmax), each [N] int — the agent's room box
    in cells, padded by `margin_cells` plus `drift_margin_m` (the raster
    origin is the drift-corrected estimate, which walls do not bound).
    numpy; tensors are read through numpy."""
    wg = np.asarray(walls_grouped)
    roa = np.asarray(room_of_agent)
    ys = wg[..., [1, 3]].reshape(wg.shape[0], -1)
    xs = wg[..., [0, 2]].reshape(wg.shape[0], -1)
    res = cfg.grid.resolution
    pad = margin_cells + int(np.ceil(drift_margin_m / res))
    rmin = np.floor((ys.min(1)[roa] - cfg.grid.origin_y) / res) - pad
    rmax = np.ceil((ys.max(1)[roa] - cfg.grid.origin_y) / res) + pad
    cmin = np.floor((xs.min(1)[roa] - cfg.grid.origin_x) / res) - pad
    cmax = np.ceil((xs.max(1)[roa] - cfg.grid.origin_x) / res) + pad
    return (rmin.astype(int), rmax.astype(int),
            cmin.astype(int), cmax.astype(int))


def merge_window_box(walls_grouped, room_of_agent, cfg: SwarmConfig):
    """Static per-agent clamp box for scan-merge window placement: the
    room evidence box (no drift margin) snapped outward to the
    [TILE_ROWS, TILE_COLS] raster-tile lattice and clipped to the grid.
    (rmin, rmax, cmin, cmax), each [N] int. The window stays agent-centred;
    the box binds only within side//2 of a tile edge."""
    side = merge_window_side(cfg)
    rmin, rmax, cmin, cmax = agent_evidence_box(
        walls_grouped, room_of_agent, cfg, margin_cells=3,
        drift_margin_m=0.0)
    size = cfg.grid.size
    rmin = np.maximum((rmin // TILE_ROWS) * TILE_ROWS, 0)
    rmax = np.minimum(-(-rmax // TILE_ROWS) * TILE_ROWS, size)
    cmin = np.maximum((cmin // TILE_COLS) * TILE_COLS, 0)
    cmax = np.minimum(-(-cmax // TILE_COLS) * TILE_COLS, size)
    if ((rmax - rmin) < side).any() or ((cmax - cmin) < side).any():
        raise ValueError(
            f"an agent's tile-snapped room box is smaller than the "
            f"{side}-cell scan-merge window; shrink "
            "slam.merge_window_cells / merge_search_cells")
    return rmin, rmax, cmin, cmax


def agent_evidence_rows(walls_grouped, room_of_agent, cfg: SwarmConfig,
                        margin_cells: int = 3,
                        drift_margin_m: float = 1.0):
    """Row bounds only (the rows-band decomposition's static proof)."""
    rmin, rmax, _, _ = agent_evidence_box(
        walls_grouped, room_of_agent, cfg, margin_cells, drift_margin_m)
    return rmin, rmax


# --------------------------------------------------------------------------
# state placement


def grid_window(size: int, layout, grid_sharding: str):
    """(row0, n_rows, col0, n_cols): the part of the global [size, size]
    grid this rank holds — everything ("replicated"), its row band
    ("rows") or its core tile ("tiles")."""
    if grid_sharding == "rows":
        band = size // layout.world
        return layout.rank * band, band, 0, size
    if grid_sharding == "tiles":
        tr, tc = layout.tile
        wr, wc = size // layout.rows, size // layout.cols
        return tr * wr, wr, tc * wc, wc
    return 0, size, 0, size


def _agent_rows(layout, n_agents: int) -> slice:
    n_loc = n_agents // layout.world
    return slice(layout.rank * n_loc, (layout.rank + 1) * n_loc)


def shard_state(state, layout, grid_sharding: str = "replicated"):
    """This rank's part of a global SimState (any device), on the layout's
    device: the agent leaves' rows of this rank, the server state whole,
    and the log-odds grid and anchor cut to the rank's band or tile (an
    anchor of [1, 1], merge_anchor off, stays whole). Every tensor of the
    part is a copy, on the same device too: no step on the part writes
    into the state passed in."""
    from swarm_tpu_torch.engine.sim import SimState

    n = state.pose_true.shape[0]
    rows = _agent_rows(layout, n)
    r0, nr, c0, nc = grid_window(state.srv.logodds.shape[0], layout,
                                 grid_sharding)
    dev = layout.device

    def agent(x):
        return type(x)(*(agent(v) for v in x)) if isinstance(x, tuple) \
            else whole(x[rows])

    def whole(x):
        return type(x)(*(whole(v) for v in x)) if isinstance(x, tuple) \
            else x.to(dev).clone(memory_format=torch.contiguous_format)

    def cut(g):
        return g if g.shape[0] == 1 else g[r0:r0 + nr, c0:c0 + nc]

    srv = whole(state.srv._replace(logodds=cut(state.srv.logodds),
                                   anchor=cut(state.srv.anchor)))
    return SimState(
        t=whole(state.t), step=whole(state.step),
        pose_true=agent(state.pose_true), odom=agent(state.odom),
        ekf=agent(state.ekf), nav=agent(state.nav),
        total_dist=agent(state.total_dist),
        v2v_total=agent(state.v2v_total), srv=srv)


def gather_state(state, layout, grid_sharding: str = "replicated"):
    """The global SimState from every rank's part (a collective: every rank
    calls it), on the layout's device."""
    from swarm_tpu_torch.engine.sim import SimState

    def agent(x):
        return type(x)(*(agent(v) for v in x)) if isinstance(x, tuple) \
            else _all_gather_rows(x)

    def grid(g):
        if g.shape[0] == 1:
            return g
        return _gather_grid(g, layout, grid_sharding)

    srv = state.srv._replace(logodds=grid(state.srv.logodds),
                             anchor=grid(state.srv.anchor))
    return SimState(
        t=state.t, step=state.step, pose_true=agent(state.pose_true),
        odom=agent(state.odom), ekf=agent(state.ekf), nav=agent(state.nav),
        total_dist=agent(state.total_dist),
        v2v_total=agent(state.v2v_total), srv=srv)


# --------------------------------------------------------------------------
# collectives


def _wire(x):
    """A tensor as the collectives carry it: bool as uint8 (not every
    backend takes bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _all_gather_rows(x):
    """[n_loc, ...] on every rank -> [world * n_loc, ...], concatenated in
    rank order."""
    w = _wire(x).contiguous()
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(x.dtype)


def _gather_rows(cols: dict) -> dict:
    """All-gather a dict of per-agent tensors ([n_loc] or [n_loc, k]) with
    one collective per dtype: the columns of each dtype are packed side by
    side, gathered, and cut apart again. Returns {name: [N] or [N, k]}."""
    by_dtype = {}
    for name, x in cols.items():
        by_dtype.setdefault(_wire(x).dtype, []).append(name)
    out = {}
    for names in by_dtype.values():
        flat = [_wire(cols[nm]).reshape(cols[nm].shape[0], -1)
                for nm in names]
        whole = _all_gather_rows(torch.cat(flat, dim=1))
        i = 0
        for nm, f in zip(names, flat):
            k = f.shape[1]
            x = cols[nm]
            out[nm] = whole[:, i:i + k].reshape(
                (-1,) + tuple(x.shape[1:])).to(x.dtype)
            i += k
    return out


def _all_reduce_sum(x):
    """Sum over ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def _gather_grid(g, layout, grid_sharding: str):
    """The global grid from every rank's band or tile (rank order; the
    tiles row-major on the rank grid). "replicated" grids are whole."""
    if grid_sharding == "replicated":
        return g
    parts = [torch.empty_like(g) for _ in range(layout.world)]
    dist.all_gather(parts, g.contiguous())
    if grid_sharding == "rows":
        return torch.cat(parts)
    return torch.cat([torch.cat(parts[r * layout.cols:(r + 1) * layout.cols],
                                dim=1) for r in range(layout.rows)])


def _halo_exchange(ext, layout, halo_r: int, halo_c: int, core_r: int,
                   core_c: int):
    """Two-phase halo merge of an extended-tile delta over the (R, C) rank
    grid (sharded.py:187-221), returning the rank's CORE [core_r, core_c]
    delta. `ext` is [core_r + 2 halo_r, core_c + 2 halo_c]: evidence an
    agent painted past its tile's border lies in the halo ring and goes to
    the rank that owns it: first the row phase (full-width strips to ranks
    rank -/+ C), so that corner evidence travels on through the column
    phase (strips to ranks rank -/+ 1). A strip at the grid's edge has no
    partner, and its ghost evidence goes with the ring. Adds into `ext` in
    place, after every send of the phase has completed."""
    r_n, c_n = layout.rows, layout.cols
    tr, tc = layout.tile

    def swap(lo, hi, lo_peer, hi_peer):
        """Send `lo` to lo_peer and `hi` to hi_peer (None: no partner);
        returns (from hi_peer, from lo_peer) — what the peers sent."""
        got_hi = torch.empty_like(lo) if hi_peer is not None else None
        got_lo = torch.empty_like(hi) if lo_peer is not None else None
        ops = []
        if lo_peer is not None:
            ops += [dist.P2POp(dist.isend, lo, lo_peer),
                    dist.P2POp(dist.irecv, got_lo, lo_peer)]
        if hi_peer is not None:
            ops += [dist.P2POp(dist.isend, hi, hi_peer),
                    dist.P2POp(dist.irecv, got_hi, hi_peer)]
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return got_hi, got_lo

    rank = layout.rank
    if r_n > 1:
        top = ext[:halo_r].contiguous()
        bot = ext[core_r + halo_r:].contiguous()
        from_south, from_north = swap(
            top, bot, rank - c_n if tr > 0 else None,
            rank + c_n if tr < r_n - 1 else None)
        if from_south is not None:
            ext[core_r:core_r + halo_r] += from_south
        if from_north is not None:
            ext[halo_r:2 * halo_r] += from_north
    if c_n > 1:
        left = ext[:, :halo_c].contiguous()
        right = ext[:, core_c + halo_c:].contiguous()
        from_east, from_west = swap(
            left, right, rank - 1 if tc > 0 else None,
            rank + 1 if tc < c_n - 1 else None)
        if from_east is not None:
            ext[:, core_c:core_c + halo_c] += from_east
        if from_west is not None:
            ext[:, halo_c:2 * halo_c] += from_west
    return ext[halo_r:halo_r + core_r, halo_c:halo_c + core_c]


# --------------------------------------------------------------------------
# the step


class _Static(NamedTuple):
    """What the step closes over: built once by make_sharded_sim_step."""
    cfg: SwarmConfig
    walls: torch.Tensor
    params: object
    faults: object
    enable_targets: bool
    layout: object
    grid_sharding: str
    tiles: Optional[tuple]          # (halo_r, halo_c) for "tiles"
    guard_box: Optional[tuple]      # [N] f32 each: rows (rmin, rmax), tiles
    #                                 (rmin, rmax, cmin, cmax)
    win_box: Optional[tuple]        # [N] int32 each, merge_window_box
    target_rooms: object


def _sense(noise, pose_true, walls, cfg: SwarmConfig):
    """The 4-way readings [n, 4] and the sweep [n, R] (None without one)
    cast against every wall, in agent chunks."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import SensorNoise, sense_4way

    n = pose_true.shape[0]
    r = cfg.engine.scan_rays
    chunk = max(1, CAST_CHUNK_ELEMS // ((r + 4) * walls.shape[0]))
    d4, ds = [], []
    for i in range(0, n, chunk):
        j = slice(i, i + chunk)
        d4.append(sense_4way(SensorNoise(*(x[j] for x in noise.sense)),
                             pose_true[j], walls, cfg.sensors))
        if r > 0:
            ds.append(sense_scan(SensorNoise(*(x[j] for x in noise.scan)),
                                 pose_true[j], walls, r, cfg.sensors))
    return torch.cat(d4), (torch.cat(ds) if r > 0 else None)


def _line_scatter(axy, ryaw, hx, hy, hit_valid, alive, scan_dist,
                  cfg: SwarmConfig, band, band_cols):
    """The body's line scatter (sharded.py:405-432, :573): every 4-way ray
    (agent-major) and, after them, every sweep ray through
    `logodds_delta`'s Bresenham scatter at k_max=32 into a fresh delta of
    the rank's window, summed in ray order. Returns (delta, writes int32):
    free plus occupied cells."""
    from swarm_tpu_torch.models.scan import scan_angles
    from swarm_tpu_torch.ops.raster import RayBatch, logodds_delta

    sens = cfg.sensors
    rx, ry = axy[:, 0], axy[:, 1]
    rays = RayBatch(
        ox=torch.repeat_interleave(rx, 4), oy=torch.repeat_interleave(ry, 4),
        hx=hx.reshape(-1), hy=hy.reshape(-1),
        hit_valid=hit_valid.reshape(-1),
        active=torch.repeat_interleave(alive, 4))
    r_scan = cfg.engine.scan_rays
    if r_scan > 0:
        sa = ryaw[:, None] + scan_angles(r_scan, rx.dtype, rx.device)[None, :]
        sv = (scan_dist > sens.min_range) & (scan_dist <= sens.max_range)
        sr = torch.where(sv, scan_dist,
                         torch.full_like(scan_dist, sens.max_range))
        shx = rx[:, None] + sr * torch.cos(sa)
        shy = ry[:, None] + sr * torch.sin(sa)
        rays = RayBatch(
            ox=torch.cat([rays.ox, torch.repeat_interleave(rx, r_scan)]),
            oy=torch.cat([rays.oy, torch.repeat_interleave(ry, r_scan)]),
            hx=torch.cat([rays.hx, shx.reshape(-1)]),
            hy=torch.cat([rays.hy, shy.reshape(-1)]),
            hit_valid=torch.cat([rays.hit_valid, sv.reshape(-1)]),
            active=torch.cat([rays.active,
                              torch.repeat_interleave(alive, r_scan)]))
    delta, writes = logodds_delta(rays, cfg.grid, band=band,
                                  band_cols=band_cols)
    return delta, writes.to(torch.int32)


def _raster(shape, axy, ryaw, dist4, scan_dist, alive, hits,
            cfg: SwarmConfig, band, band_cols):
    """The step's raster into a fresh float32 delta of `shape` (the rank's
    grid, band or extended tile), as the reference body chooses it
    (sharded.py:312-313, :498-575). The beam mode (raster_mode "beam") runs
    every fan, the 4-way fan first: through the window kernel (pack16 per
    beam, as the body passes no pack8, or the grouped tier; the endpoint
    ring or, without it, the exact endpoint delta and a clip after the
    fan), or with use_pallas=False through the XLA fast tier
    (`free_raster_reference` on a fresh zero window, which clips its own
    output, plus the exact endpoint delta whatever kernel_endpoints says,
    added with no clip; its float count truncated to int32, ROADMAP C41).
    Every other raster mode ("line", "off", and "parity", which
    make_sharded_sim_step refuses) is the line scatter (`_line_scatter`;
    C40). `hits` is (hx, hy, hit_valid) of the 4-way rays. Returns
    (delta, writes int32)."""
    from swarm_tpu_torch.ops.beam_raster import (BeamSpec, beams_from_4way,
                                                 beams_from_scan,
                                                 endpoint_rays,
                                                 free_raster_reference,
                                                 reach_cells)
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.raster import logodds_delta

    sens, eng = cfg.sensors, cfg.engine
    if eng.raster_mode != "beam" or eng.parity_mode:
        return _line_scatter(axy, ryaw, *hits, alive, scan_dist, cfg, band,
                             band_cols)
    fans = []
    if eng.raster_4way or eng.scan_rays == 0:
        fans.append((BeamSpec.four_way(),
                     beams_from_4way(dist4, sens.max_range, sens.min_range)))
    if eng.scan_rays > 0:
        fans.append((BeamSpec.scan(eng.scan_rays),
                     beams_from_scan(scan_dist, sens.max_range,
                                     sens.min_range)))
    reach = reach_cells(cfg)
    clampv = cfg.grid.logodds_clamp
    dev = axy.device
    delta = torch.zeros(shape, dtype=torch.float32, device=dev)
    writes = torch.zeros((), dtype=torch.int32, device=dev)
    for spec, (db, tb) in fans:
        n_groups = (spec.n_beams if eng.beam_groups <= 0
                    else min(eng.beam_groups, spec.n_beams))
        dbm = torch.where(alive[:, None], db, torch.zeros_like(db))
        if not eng.use_pallas:
            d_free, w_free = free_raster_reference(
                torch.zeros(shape, dtype=torch.float32, device=dev), axy,
                ryaw, dbm, alive, spec, cfg.grid, n_groups=n_groups,
                reach=reach, band=band, band_cols=band_cols,
                tail_weight=eng.beam_tail_weight)
            ep, w_ep = logodds_delta(
                endpoint_rays(axy, ryaw, db, tb, alive, spec), cfg.grid,
                k_max=1, band=band, band_cols=band_cols)
            delta = delta + d_free + ep
            writes = writes + w_free.to(torch.int32) + w_ep.to(torch.int32)
            continue
        trusted = (tb & alive[:, None]) if eng.kernel_endpoints else None
        delta, w_cnt = free_raster(delta, axy, ryaw, dbm, alive, trusted,
                                   spec, cfg.grid, reach=reach, pack8=False,
                                   n_groups=n_groups,
                                   tail_weight=eng.beam_tail_weight,
                                   band=band, band_cols=band_cols)
        writes = writes + torch.round(w_cnt).to(torch.int32).sum()
        if not eng.kernel_endpoints:
            ep, w_ep = logodds_delta(
                endpoint_rays(axy, ryaw, db, tb, alive, spec), cfg.grid,
                k_max=1, band=band, band_cols=band_cols)
            delta = torch.clamp(delta + ep, -clampv, clampv)
            writes = writes + w_ep.to(torch.int32)
    return delta, writes.to(torch.int32)


def _step_body(state, noise, step_no: int, st: _Static):
    """One sharded step on this rank: the reference's `_sharded_step_body`
    stage for stage. `state` holds this rank's agent rows and grid part;
    `noise` the whole step's StepNoise (every agent). Returns (new_state,
    StepMetrics), the metrics global and alike on every rank."""
    from swarm_tpu_torch.coord.heartbeat import heartbeat_update
    from swarm_tpu_torch.coord.zones import zone_observe_rows, \
        zones_for_agents
    from swarm_tpu_torch.engine import sim
    from swarm_tpu_torch.geom.world import cast_rays
    from swarm_tpu_torch.models import nav as navm
    from swarm_tpu_torch.models.ekf import ekf_step_batch
    from swarm_tpu_torch.models.landmarks import detect_landmark_sim
    from swarm_tpu_torch.models.odometry import (DriftNoise,
                                                 drift_integrate,
                                                 encoder_emit,
                                                 quantize_yaw_deg)
    from swarm_tpu_torch.ops.beam_raster_cuda import cells_of
    from swarm_tpu_torch.slam.closure import closure_add_poses_batch
    from swarm_tpu_torch.slam.livemerge import (FrameState, frame_add,
                                                frame_advance, frame_init,
                                                frame_theta_q, merge_bias_ff)
    from swarm_tpu_torch.utils.angles import radians, wrap_pi

    cfg, lay = st.cfg, st.layout
    n = cfg.n_agents
    navc, sens, slam = cfg.nav, cfg.sensors, cfg.slam
    dt = navc.drive_tick_s + navc.settle_tick_s
    srv = state.srv
    dev = state.pose_true.device
    f32, i32 = torch.float32, torch.int32
    n_loc = state.pose_true.shape[0]
    id0 = lay.rank * n_loc
    rows = slice(id0, id0 + n_loc)
    zeros = torch.zeros((n_loc,), dtype=f32, device=dev)
    p = type(st.params)(*(a[rows] for a in st.params))

    ridx = torch.arange(id0, id0 + n_loc, dtype=i32, device=dev)
    faults = st.faults
    hit = (faults.agent[None, :] == ridx[:, None]) & \
        (state.t >= faults.t_start[None, :]) & (state.t < faults.t_end[None, :])
    alive = ~hit.any(dim=1)

    # 1-2. sense (against every wall) + landmark
    dist4, scan_dist = _sense(
        noise._replace(sense=type(noise.sense)(*(x[rows]
                                                 for x in noise.sense)),
                       scan=None if noise.scan is None else type(
                           noise.scan)(*(x[rows] for x in noise.scan))),
        state.pose_true, st.walls, cfg)
    lm = detect_landmark_sim(dist4[:, 0], dist4[:, 1], dist4[:, 3],
                             navc.lm_sim_close_m, sens.max_range)
    lm = torch.where(alive, lm, torch.zeros_like(lm))

    # 3. telemetry from the drifted estimate
    odom, enc_tot = encoder_emit(state.odom, cfg.noise)
    yaw_q = radians(quantize_yaw_deg(odom.yaw_est,
                                     cfg.noise.yaw_quantize_deg))

    # 4. server ingest: frame advance, merge, raster on this rank
    merge_dx_loc = srv.merge_dx[rows]
    merge_dy_loc = srv.merge_dy[rows]
    frame_loc = FrameState(*(x[rows] for x in srv.frame))
    adv_d = inno_d = frame_init(n_loc, device=dev)          # zero deltas
    adv_x = adv_y = zeros
    if slam.merge_frame_gain > 0.0:
        adv_x, adv_y, adv_d = frame_advance(
            frame_loc, odom.x_est + p.x_offset, odom.y_est, alive, cfg)
        merge_dx_loc = merge_dx_loc + adv_x
        merge_dy_loc = merge_dy_loc + adv_y
        frame_loc = frame_add(frame_loc, adv_d)
    rx = odom.x_est + p.x_offset + srv.closure.drift_dx[rows] + merge_dx_loc
    ry = odom.y_est + srv.closure.drift_dy[rows] + merge_dy_loc
    ryaw = yaw_q + srv.merge_dyaw[rows]
    if slam.merge_frame_gain > 0.0:
        ryaw = ryaw - frame_theta_q(frame_loc.theta, cfg)
    bias = slam.merge_bias_alpha > 0.0
    if bias:
        ryaw = ryaw + merge_bias_ff(srv.merge_yaw_rate[rows],
                                    srv.merge_dist_mark[rows],
                                    state.total_dist, cfg)

    rows_mode = st.grid_sharding == "rows"
    tiles_mode = st.grid_sharding == "tiles"
    core_r, core_c = srv.logodds.shape
    tr, tc = lay.tile
    if rows_mode:
        band_row0, band_col0 = lay.rank * core_r, None
    elif tiles_mode:
        band_row0, band_col0 = tr * core_r, tc * core_c
    else:
        band_row0 = band_col0 = None

    every = cfg.engine.merge_every
    n_merges = torch.zeros((), dtype=i32, device=dev)
    fitsum = torch.zeros((), dtype=f32, device=dev)
    merge_ok = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
    merge_fit = zeros
    cdx = cdy = cdth = rate_d = mark_d = zeros
    new_fail = srv.merge_fail[rows]
    if every > 0 and scan_dist is not None and step_no % every == every - 1:
        wb = None if st.win_box is None else tuple(b[rows]
                                                   for b in st.win_box)
        rx, ry, ryaw, (cdx, cdy, cdth), new_fail, innovation, \
            (n_merges, _, merge_ok, merge_fit), bias_d = sim._merge_event(
                srv.logodds, srv.anchor, srv.merge_fail[rows], frame_loc,
                rx, ry, ryaw, yaw_q, scan_dist, alive, step_no, cfg, wb,
                id0=id0, band_row0=band_row0, band_col0=band_col0,
                bias=((srv.merge_yaw_rate[rows], srv.merge_dist_mark[rows],
                       state.total_dist, wrap_pi(yaw_q - odom.yaw_est))
                      if bias else None))
        if innovation is not None:
            inno_d = innovation
        if bias_d is not None:
            # the level fold rides with the yaw increment; the rate and
            # mark deltas are gathered like it (sharded.py:382-387, :697)
            fold, rate_d, mark_d = bias_d
            cdth = cdth + fold
        fitsum = merge_fit.sum()

    angles = ryaw[:, None] + torch.tensor(sens.angles, dtype=f32,
                                          device=dev)[None, :]
    hit_valid = (dist4 > sens.min_range) & (dist4 <= sens.max_range)
    rng = torch.where(hit_valid, dist4,
                      torch.full_like(dist4, sens.max_range))
    hx = rx[:, None] + rng * torch.cos(angles)
    hy = ry[:, None] + rng * torch.sin(angles)

    # the grid window and the runtime escape guard: an agent whose
    # drift-corrected estimate left its static evidence box can paint
    # outside what its rank owns (sharded.py:441-497)
    band = band_cols = None
    band_esc = torch.zeros((), dtype=i32, device=dev)
    if rows_mode or tiles_mode:
        ax_cell, ay_cell = cells_of(torch.stack([rx, ry], -1), cfg.grid)
        gb = [b[rows] for b in st.guard_box]
        in_box = (ay_cell >= gb[0]) & (ay_cell <= gb[1])
        if tiles_mode:
            halo_r, halo_c = st.tiles
            band = (tr * core_r - halo_r, core_r + 2 * halo_r)
            band_cols = (tc * core_c - halo_c, core_c + 2 * halo_c)
            in_box = in_box & (ax_cell >= gb[2]) & (ax_cell <= gb[3])
        else:
            band = (lay.rank * core_r, core_r)
        band_esc = (~in_box & alive).sum().to(i32)
    shape = (band[1], band_cols[1]) if tiles_mode else srv.logodds.shape
    delta, writes = _raster(shape, torch.stack([rx, ry], -1), ryaw, dist4,
                            scan_dist, alive, (hx, hy, hit_valid), cfg,
                            band, band_cols)
    if tiles_mode:
        delta = _halo_exchange(delta, lay, halo_r, halo_c, core_r, core_c)
    elif not rows_mode:
        delta = _all_reduce_sum(delta)                     # the map merge
    clampv = cfg.grid.logodds_clamp
    logodds = torch.clamp(srv.logodds + delta, -clampv, clampv)

    # this step's packets from every rank (one gather per dtype)
    est_x = odom.x_est + p.x_offset
    # measured closures need every agent's sweep on every rank (the
    # reference's extra all_gather, swarm_tpu/parallel/sharded.py:594-606);
    # the matcher then runs replicated
    measured = slam.closure_scanmatch and scan_dist is not None
    a = _gather_rows(dict(
        (dict(scan=scan_dist) if measured else {}),
        rx=rx, ry=ry, ryaw=ryaw, yaw_q=yaw_q, hx=hx, hy=hy, dist4=dist4,
        est_x=est_x, est_y=odom.y_est, est_yaw=odom.yaw_est,
        merge_fit=merge_fit, adv_x=adv_x, adv_y=adv_y, cdx=cdx, cdy=cdy,
        cdth=cdth, rate_d=rate_d, mark_d=mark_d, tx=state.pose_true[:, 0] + p.x_offset,
        ty=state.pose_true[:, 1],
        adv_d=torch.stack(list(adv_d), -1),
        inno_d=torch.stack(list(inno_d), -1),
        lm=lm, fail=new_fail, enc=enc_tot, v2v_total=state.v2v_total,
        alive=alive, hit_valid=hit_valid, merge_ok=merge_ok))
    rx_a, ry_a, alive_a = a["rx"], a["ry"], a["alive"]

    agents_all = torch.arange(n, dtype=i32, device=dev)
    closure, closed_a, _, _ = closure_add_poses_batch(
        srv.closure, rx_a, ry_a, agents_all, a["lm"], slam, valid=alive_a,
        yaws=a["ryaw"] if measured else None,
        scans=a["scan"] if measured else None, grid=cfg.grid,
        sens=cfg.sensors)
    zone = zone_observe_rows(
        srv.zone, torch.cat([rx_a[:, None], a["hx"]], dim=1),
        torch.cat([ry_a[:, None], a["hy"]], dim=1),
        torch.cat([alive_a[:, None], a["hit_valid"] & alive_a[:, None]],
                  dim=1))
    last_packet_t = torch.where(alive_a, state.t, srv.last_packet_t)
    pkt_counts = srv.pkt_counts + alive_a.to(i32)
    online = heartbeat_update(last_packet_t, state.t,
                              cfg.coord.heartbeat_timeout_s)

    zone_every = max(1, round(cfg.coord.zone_interval_s / dt))
    zone_boxes, zone_active = srv.zone_boxes, srv.zone_active
    if step_no % zone_every == 0:
        zone_boxes, zone_active = zones_for_agents(
            zone, torch.stack([rx_a, ry_a], dim=-1), online)

    cents, n_fr = srv.frontier_centroids, srv.n_frontiers
    targets = None
    target_every = max(1, round(cfg.coord.target_interval_s / dt))
    if cfg.engine.compute_frontiers and step_no % target_every == 0:
        cents, n_fr, tg, has = sim._frontier_event(
            _gather_grid(logodds, lay, st.grid_sharding), rx_a, ry_a,
            online, cfg, st.enable_targets, st.target_rooms)
        if tg is not None:
            targets = (tg, has)

    anchor = srv.anchor
    if slam.merge_anchor and every > 0 and step_no % every == every - 1 \
            and (slam.merge_anchor_freeze_steps <= 0
                 or step_no < slam.merge_anchor_freeze_steps):
        anchor = torch.where(
            (torch.abs(srv.anchor) < 0.5) &
            (torch.abs(logodds) >= slam.merge_anchor_thresh),
            logodds, srv.anchor)

    def frame_of(x):
        return FrameState(*x.unbind(-1))

    merge_dx = (srv.merge_dx + a["adv_x"]) + a["cdx"]
    merge_dy = (srv.merge_dy + a["adv_y"]) + a["cdy"]
    new_srv = srv._replace(
        logodds=logodds, closure=closure, zone=zone,
        last_packet_t=last_packet_t, pkt_counts=pkt_counts,
        zone_boxes=zone_boxes, zone_active=zone_active,
        frontier_centroids=cents, n_frontiers=n_fr,
        merge_dx=merge_dx, merge_dy=merge_dy,
        merge_dyaw=srv.merge_dyaw + a["cdth"], anchor=anchor,
        merge_fail=a["fail"],
        merge_yaw_rate=srv.merge_yaw_rate + a["rate_d"],
        merge_dist_mark=srv.merge_dist_mark + a["mark_d"],
        frame=frame_add(frame_add(srv.frame, frame_of(a["adv_d"])),
                        frame_of(a["inno_d"])))

    # target delivery (this rank's rows of the replicated assignment),
    # server frame back into the odometry frame
    nav = state.nav
    if targets is not None:
        tg, has = targets
        tgt_local = tg[rows] - torch.stack(
            [p.x_offset + closure.drift_dx[rows] + merge_dx[rows],
             closure.drift_dy[rows] + merge_dy[rows]], dim=-1)
        nav = navm.assign_target(nav, tgt_local, has[rows] & alive)

    # 5. navigate (zone boxes back into the agent's odometry frame)
    est_pose = torch.stack([odom.x_est, odom.y_est, odom.yaw_est], dim=-1)
    zone_local = zone_boxes[rows] - torch.stack(
        [p.x_offset, zeros, p.x_offset, zeros], dim=-1)
    nav, cmd = navm.nav_step(nav, navm.NavParams(
        wall_side=p.wall_side, motor_pwm=p.motor_pwm,
        return_style=p.return_style, home_x=p.home_x, home_y=p.home_y),
        dist4, est_pose, state.total_dist, zone_local, zone_active[rows],
        dt, navc)
    drive = torch.where(alive, cmd.drive_m, zeros)
    turn = torch.where(alive, cmd.turn_cmd_rad, zeros)
    steer = torch.where(alive, cmd.steer_rad, zeros)

    # 6. physics against every wall
    yaw_true = wrap_pi(state.pose_true[:, 2] + turn)
    move_dir = yaw_true + steer
    clear = cast_rays(state.pose_true[:, None, :2], move_dir[:, None],
                      st.walls)[:, 0]
    drive = torch.minimum(drive, torch.clamp_min(clear - 0.08, 0.0))
    x_true = state.pose_true[:, 0] + drive * torch.cos(move_dir)
    y_true = state.pose_true[:, 1] + drive * torch.sin(move_dir)
    pose_true = torch.stack([x_true, y_true, yaw_true], dim=-1)
    total_dist = state.total_dist + drive

    # 7. odometry + EKF
    odom = drift_integrate(DriftNoise(*(x[rows] for x in noise.drift)),
                           odom, drive, turn, p.trans_scale,
                           p.yaw_bias_per_m, cfg.noise)
    t_new = state.t + dt
    ekf = ekf_step_batch(state.ekf, turn / dt, drive / dt,
                         t_new.expand(n_loc), cfg.ekf)
    odom = odom._replace(yaw_est=torch.where(
        p.ekf_yaw, wrap_pi(ekf.x[:, 2]), odom.yaw_est))
    err = torch.sqrt((rx - p.x_offset - x_true) ** 2 + (ry - y_true) ** 2)

    # v2v over the gathered pre-motion true positions; each rank computes
    # every agent's broadcast count, so the counter needs no second gather
    txy_a = torch.stack([a["tx"], a["ty"]], dim=-1)
    v2v_cm_a, v2v_n_a = sim.v2v_stats(txy_a, alive_a, sens.v2v_range_m)
    rx_tick_a = torch.round(v2v_n_a.to(f32) * sens.v2v_broadcast_hz *
                            dt).to(i32)
    v2v_total_a = a["v2v_total"] + torch.where(
        alive_a, rx_tick_a, torch.zeros_like(rx_tick_a))
    v2v = torch.where(st.params.v2v_count, v2v_total_a, v2v_cm_a)

    # the step's scalar sums over ranks, one collective per dtype
    ints = _all_reduce_sum(torch.stack([
        writes, nav.mission_complete.sum().to(i32), n_merges, band_esc]))
    floats = _all_reduce_sum(torch.stack([
        torch.where(alive, err, zeros).sum(), fitsum]))
    writes_g, mission_g, merges_g, esc_g = ints.unbind()
    new_srv = new_srv._replace(total_writes=sim.writes_accumulate(
        srv.total_writes, writes_g))

    new_state = state._replace(
        t=t_new, step=state.step + 1, pose_true=pose_true, odom=odom,
        ekf=ekf, nav=nav, total_dist=total_dist,
        v2v_total=v2v_total_a[rows], srv=new_srv)
    metrics = sim.StepMetrics(
        writes=writes_g, closures=closed_a.sum().to(i32),
        online=online.sum().to(i32), n_frontiers=n_fr,
        pose_err=floats[0] / n, mission_done=mission_g, merges=merges_g,
        merge_fitness=floats[1] / torch.clamp_min(merges_g, 1).to(f32),
        band_escapes=esc_g, t=state.t,
        srv_x=rx_a, srv_y=ry_a, srv_yaw=a["ryaw"], yaw_q=a["yaw_q"],
        est_x=a["est_x"], est_y=a["est_y"], est_yaw=a["est_yaw"],
        merge_ok=a["merge_ok"], merge_fit=a["merge_fit"],
        encoder=a["enc"], v2v=v2v, dist_m=a["dist4"], landmark=a["lm"],
        hits=torch.stack([a["hx"], a["hy"]], dim=-1),
        hit_valid=a["hit_valid"] & alive_a[:, None], alive=alive_a)
    return new_state, metrics


def _tile_halo(cfg: SwarmConfig, layout):
    """The "tiles" decomposition's static sizing (sharded.py:864-891):
    the tile [wr, wc] and its halo (halo_r, halo_c), or the reference's
    ValueError."""
    from swarm_tpu_torch.ops.beam_raster import patch_dims, reach_cells

    r_n, c_n = layout.rows, layout.cols
    size = cfg.grid.size
    if size % r_n or size % c_n:
        raise ValueError(f"grid size {size} not divisible by mesh "
                         f"({r_n}, {c_n})")
    wr, wc = size // r_n, size // c_n
    reach = reach_cells(cfg)
    pr, pc = patch_dims(size, reach)
    if pc >= size:
        raise ValueError("tiles sharding needs size >= 512 (windowed "
                         "raster patches; smaller grids fit one chip)")
    if wc % 128:
        raise ValueError(f"tile width {wc} not 128-aligned")
    halo_c = 128
    if reach > halo_c:
        raise ValueError(f"beam reach {reach} exceeds the {halo_c}-"
                         "column halo")
    # the smallest 8-aligned row halo whose extended tile provably holds
    # every in-tile agent's raster window (alignment included)
    halo_r = -(-reach // 8) * 8
    while 8 * ((halo_r - reach) // 8) + pr > 2 * halo_r:
        halo_r += 8
    if wr < max(halo_r, pr - 2 * halo_r) or wc < halo_c:
        raise ValueError(f"tile [{wr}, {wc}] too small for halo "
                         f"[{halo_r}, {halo_c}] / window {pr} rows")
    return wr, wc, halo_r, halo_c


def make_sharded_sim_step(cfg: SwarmConfig, walls, params, layout,
                          generator: Optional[torch.Generator] = None,
                          faults=None, enable_targets: bool = False,
                          donate: bool = True,
                          grid_sharding: str = "replicated",
                          walls_grouped=None, room_of_agent=None):
    """The sharded step for this rank: `step(state, noise=None) ->
    (state, metrics)` on the rank's part of the state (`shard_state`), the
    metrics global. `cfg.n_agents` must divide by the world size;
    `params` and `faults` are global (every agent), on the layout's
    device. Noise comes from `generator` (seeded alike on every rank, on
    the layout's device) unless a whole-step StepNoise is passed.

    `donate` is the reference's `donate_argnums` switch, and here either
    value keeps the state passed in: the sharded step writes no tensor of
    the state in place (its rasters paint a fresh delta, and the map is
    `clamp(logodds + delta)`, a new tensor), so a `donate=False` step
    copies nothing and is the donated step, bit for bit.

    grid_sharding "replicated", "rows" or "tiles" (see the module
    docstring). "rows" and "tiles" need `walls_grouped` / `room_of_agent`
    for the reference's static proofs: every agent's evidence box inside
    its rank's band, or inside its tile's exchangeable region (the tile
    plus its halo, less the window-alignment slack); raised as the
    reference raises them. The merge-window boxes (`merge_window_box`),
    the same global placement in every decomposition, must lie in the
    rank's band or core tile. The step keeps the step number on the host,
    as engine.sim.make_sim_step does."""
    from swarm_tpu_torch.engine import sim

    sim.check_supported(cfg, sharded=True)
    if grid_sharding not in GRID_SHARDINGS:
        raise ValueError(f"unknown grid_sharding {grid_sharding!r}")
    d = layout.world
    if cfg.n_agents % d != 0:
        raise ValueError(f"n_agents={cfg.n_agents} not divisible by "
                         f"mesh size {d}")
    dev = layout.device
    size = cfg.grid.size
    dev_of = np.arange(cfg.n_agents) // (cfg.n_agents // d)
    tiles = guard_box = None
    if grid_sharding == "tiles":
        wr, wc, halo_r, halo_c = _tile_halo(cfg, layout)
        if cfg.engine.merge_every > 0:
            side = merge_window_side(cfg)
            if wr < side or wc < side:
                raise ValueError(
                    f"tile [{wr}, {wc}] cannot hold the {side}-cell "
                    "scan-merge window (shrink slam.merge_window_cells "
                    "or use grid_sharding='replicated')")
        if walls_grouped is None or room_of_agent is None:
            raise ValueError("grid_sharding='tiles' needs walls_grouped "
                             "+ room_of_agent for the static containment "
                             "proof")
        box = agent_evidence_box(_host(walls_grouped), _host(room_of_agent),
                                 cfg)
        rmin, rmax, cmin, cmax = box
        dr, dc = dev_of // layout.cols, dev_of % layout.cols
        bad = ((rmin < dr * wr - halo_r) |
               (rmax > (dr + 1) * wr + halo_r - 8) |
               (cmin < dc * wc - halo_c) | (cmax > (dc + 1) * wc + halo_c))
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} agents' evidence boxes escape their "
                "device tile's exchangeable region — order agent blocks "
                "device-major over the (rows, cols) tile grid")
        tiles = (halo_r, halo_c)
        guard_box = tuple(torch.as_tensor(b, dtype=torch.float32,
                                          device=dev) for b in box)
    if grid_sharding == "rows":
        from swarm_tpu_torch.ops.beam_raster import patch_dims, reach_cells
        if size % d:
            raise ValueError(f"grid size {size} not divisible by "
                             f"mesh size {d}")
        band = size // d
        pr, _ = patch_dims(size, reach_cells(cfg))
        if band < pr:
            raise ValueError(f"band of {band} rows cannot hold the "
                             f"{pr}-row raster window")
        if cfg.engine.merge_every > 0:
            side = merge_window_side(cfg)
            if band < side:
                raise ValueError(
                    f"band of {band} rows cannot hold the {side}-row "
                    "scan-merge window (shrink slam.merge_window_cells "
                    "or use grid_sharding='replicated')")
        if walls_grouped is None or room_of_agent is None:
            raise ValueError("grid_sharding='rows' needs walls_grouped + "
                             "room_of_agent for the static band-"
                             "containment proof")
        rmin, rmax = agent_evidence_rows(_host(walls_grouped),
                                         _host(room_of_agent), cfg)
        lo = dev_of * band
        bad = (rmin < lo) | (rmax > lo + band)
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} agents' evidence rows escape their "
                "device's grid band — reorder agents/rooms so each "
                "device's rooms fill whole bands (tiled per_row layouts)")
        guard_box = tuple(torch.as_tensor(b, dtype=torch.float32,
                                          device=dev) for b in (rmin, rmax))

    # the merge window's static per-agent placement box, the same in every
    # decomposition; it must lie in the rank's band or core tile so that
    # the local crop never needs another rank's cells
    win_box = None
    if cfg.engine.merge_every > 0 and walls_grouped is not None \
            and room_of_agent is not None:
        brmin, brmax, bcmin, bcmax = merge_window_box(
            _host(walls_grouped), _host(room_of_agent), cfg)
        if grid_sharding == "rows":
            band = size // d
            bad = (brmin < dev_of * band) | (brmax > (dev_of + 1) * band)
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} agents' tile-snapped room boxes "
                    "cross their device's grid band — the merge window "
                    "cannot be placed decomposition-invariantly (bands "
                    "must own whole 128-row raster tiles)")
        if grid_sharding == "tiles":
            dr, dc = dev_of // layout.cols, dev_of % layout.cols
            bad = ((brmin < dr * wr) | (brmax > (dr + 1) * wr) |
                   (bcmin < dc * wc) | (bcmax > (dc + 1) * wc))
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} agents' tile-snapped room boxes "
                    "cross their device's CORE tile — the scan-merge "
                    "window can only read the core tile, so "
                    "decomposition-invariant placement needs each room's "
                    "raster tile inside one device tile")
        win_box = tuple(torch.as_tensor(b, dtype=torch.int32, device=dev)
                        for b in (brmin, brmax, bcmin, bcmax))

    if faults is None:
        faults = sim.no_faults(device=dev)
    target_rooms = (sim.agent_target_rooms(cfg, walls_grouped,
                                           room_of_agent, dev)
                    if enable_targets else None)
    st = _Static(cfg=cfg, walls=torch.as_tensor(walls, device=dev),
                 params=params, faults=faults, enable_targets=enable_targets,
                 layout=layout, grid_sharding=grid_sharding, tiles=tiles,
                 guard_box=guard_box, win_box=win_box,
                 target_rooms=target_rooms)
    host = {"state": None, "step": 0}

    def step(state, noise=None):
        if noise is None:
            noise = sim.draw_step_noise(generator, cfg.n_agents,
                                        cfg.engine.scan_rays, dev)
        if state is not host["state"]:
            host["step"] = int(state.step)
        out = _step_body(state, noise, host["step"], st)
        host["state"], host["step"] = out[0], host["step"] + 1
        return out

    return step


def _host(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

