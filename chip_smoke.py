"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure exits non-zero; nothing is caught and then passed):
  1. build both raster kernels (swarm_tpu_torch/csrc/free_raster.cu and
     room_raster.cu) from the checkout, one nvcc each, started together;
     print each build time;
  2. each kernel, in each form a path runs, vs its plain torch version at
     the main path's shapes: 1024 agents in the tiled 4096^2 world, preset
     start poses with random headings, noisy readings (181-beam sweeps, or
     the 4-way ultrasonics for the wrapped fan), plus an overlap case on a
     grid pre-filled near +-clamp (window kernel: 64 agents around one
     point; room kernel: both agents of every room within a few cells of
     each other), so the per-agent clip order decides cells. Window forms:
     pack8 + ring on the sweep (the deployable path), pack16 without the
     ring on the sweep and on the 4-way fan (the exploration path), pack8
     + ring on the 4-way fan (the ultrasonic-only path). Maps BIT-EQUAL,
     counts equal. Timed with CUDA events: the kernel launch alone on
     prepared operands, the wrapper with its preparation, the plain
     version; the bound is computed from this run's inputs;
  3. the window path: presets.deployable(1024) (merge every 16 steps) ->
     sim_init -> 1 warm-up step -> timed steps, with every kernel launch
     counter set to 0 just before and read just after: the window kernel
     launched once per step and the room kernel never, every step writes,
     merges > 0, all 1024 agents online, poses finite;
  4. the room path: presets.deployable(1024, room_kernel=True), the same
     checks with the roles of the two kernels swapped, and one merge
     event's time (a 128-agent chunk matched through scan_merge_recover),
     and the matcher on that chunk with its translation scoring as the
     port runs it (one grouped conv2d) and in the JAX package's im2col form
     (bmm over unfolded patches, the reference `_scores_im2col`);
  5. the exploration path: presets.coverage(1024, frontiers=True) with
     targets, 201 steps: the window kernel twice per step (pack16 on the
     4-way fan, then on the sweep) and the room kernel never, 26 frontier
     events with frontiers found from step 8 on, targets assigned, every
     step writes, all agents online, poses finite; steps/s, device step
     medians with and without a frontier event, the endpoint scatter's
     time per fan, peak memory, coverage of the reachable cells;
  6. the ultrasonic-only path: presets.deployable(1024, scan_rays=0), 101
     steps, one pack8 + ring launch on the 4-way fan per step;
  7. the coverage tool's own configuration (64 agents, 1024^2): 400 steps
     wall-following, then 400 with frontier targets; both coverages > 0;
     then each entry point of the exploration path through sim_rollout at
     1024 agents for 17 steps (coverage with and without frontier targets,
     bench.py --frontiers, bench.py --scan-rays 0), its launches per form
     checked;
  8. reference checks at 8 agents: both deployable paths over the same 34
     steps (two merge events) on the card and on the CPU (plain rasters)
     from the same state and noise (online equal, writes within 1%,
     tri-state maps on >= 99% of explored cells; merge counts of both
     sides printed, any merge decision that differs reported with the
     match fitness on both sides), and the exploration path over 17 steps
     (three frontier events; writes within 1%, maps on >= 99%, frontier
     counts equal).
The line before the last two is the per-kernel JSON record, then the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

N_AGENTS = 1024
TIMED_STEPS = 200
REF_AGENTS = 8
REF_STEPS = 34
EXPLORE_REF_STEPS = 17       # three frontier events (steps 0, 8, 16)
COVERAGE_AGENTS = 64         # tools/bench_coverage.py's default
COVERAGE_STEPS = 400
ULTRASONIC_STEPS = 101
ENTRY_STEPS = 17             # three frontier events (steps 0, 8, 16)
SEED = 0
# H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per cell evaluation of either raster kernel, counted from
# csrc/raster_common.cuh `polar` (~50: the radius, the atan2 polynomial,
# the bin, the crossing count) plus the table lookup, the carve, the ring,
# the painted count and the clipped apply (~30)
OPS_PER_CELL = 80


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _ab_ms(first, second, reps_first: int, reps_second: int):
    """Medians of two functions timed in turns first, second, second,
    first; returns (min of first's, min of second's, all four)."""
    first(), second()
    a1 = _median_ms(first, reps_first)
    b1 = _median_ms(second, reps_second)
    b2 = _median_ms(second, reps_second)
    a2 = _median_ms(first, reps_first)
    return min(a1, a2), min(b1, b2), (a1, b1, b2, a2)


def _bound(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) for the bytes a function must
    move and the operations it must do, at the card's published peaks."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_build():
    from swarm_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_all(["free_raster", "room_raster"])
    for name, (lib, secs) in built.items():
        print(f"kernel build [{name}]: {secs:.2f} s ({os.path.relpath(lib)})")
    print(f"kernel builds, together: {time.perf_counter() - t0:.2f} s")


def _raster_inputs(cfg, params, rooms, gen, dev, four_way=False):
    """Main-path raster inputs: preset start poses, random headings, noisy
    readings against each agent's room (the 181-beam sweep, or the 4-way
    ultrasonics)."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise, sense_4way
    from swarm_tpu_torch.ops.beam_raster import beams_from_scan

    n, r = cfg.n_agents, cfg.engine.scan_rays
    yaw = (torch.rand((n,), generator=gen, device=dev) * 2 - 1) * torch.pi
    pose = torch.stack([params.home_x, params.home_y, yaw], -1)
    walls_agent = rooms[0][rooms[1].long()]
    if four_way:
        dist = sense_4way(draw_sensor_noise(gen, (n, 4), dev), pose,
                          walls_agent, cfg.sensors)
    else:
        dist = sense_scan(draw_sensor_noise(gen, (n, r), dev), pose,
                          walls_agent, r, cfg.sensors)
    # beams_from_4way is the same function
    db, tb = beams_from_scan(dist, cfg.sensors.max_range,
                             cfg.sensors.min_range)
    return pose[:, :2].contiguous(), yaw, db, tb


def _prefilled(size, gen, dev):
    levels = torch.tensor([-9.9, 9.7, -9.6, 9.95], device=dev)
    return levels[torch.randint(0, 4, (size, size), generator=gen,
                                device=dev)]


def _hold_equal(name, kernel, plain, cases, size):
    """Run kernel and plain version on each case's copy of the grid; maps
    bit-equal, counts equal. Returns the largest |difference| (0.0)."""
    worst = 0.0
    for case, (grid0, args) in cases.items():
        g_k, g_p = grid0.clone(), grid0.clone()
        _, c_k = kernel(g_k, *args)
        torch.cuda.synchronize()
        _, c_p = plain(g_p, *args)
        torch.cuda.synchronize()
        n_diff = int((g_k != g_p).sum())
        err = float((g_k - g_p).abs().max())
        worst = max(worst, err)
        print(f"{name} kernel vs plain [{case}]: {n_diff} of {size * size} "
              f"cells differ (max |diff| {err}), "
              f"{int((g_k != grid0).sum())} cells changed, counts sum "
              f"{float(c_k.sum())} vs {float(c_p.sum())}")
        if n_diff:
            raise AssertionError(f"{name}: kernel and plain maps differ in "
                                 f"{n_diff} cells [{case}]")
        if not torch.equal(c_k, c_p):
            raise AssertionError(f"{name}: counts differ [{case}]")
        if float(c_k.sum()) <= 0:
            raise AssertionError(f"{name}: nothing painted [{case}]")
    return worst


def _window_form(card, dev, name, cfg, params, rooms, seed, four_way,
                 pack8):
    """One form of the window kernel at the main path's shapes: held
    bit-equal to its plain version at N_AGENTS agents and in an overlap
    case (64 agents around one point on a grid pre-filled near +-clamp),
    then timed: the launch on prepared operands, the wrapper with its
    preparation, the plain version; the bound from this run's inputs."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = (BeamSpec.four_way() if four_way
            else BeamSpec.scan(cfg.engine.scan_rays))
    reach = reach_cells(cfg)
    size = cfg.grid.size
    alive = torch.ones((N_AGENTS,), dtype=torch.bool, device=dev)
    xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev, four_way)
    tr = tb if pack8 else None

    def kernel(g, *a):
        return bc.free_raster(g, *a, pack8=pack8)

    def plain(g, *a):
        return bc.free_raster_plain(g, *a, pack8=pack8)

    # overlap case: 64 agents within +-4 cells of one point
    k = min(64, N_AGENTS)
    xy_o = xy[:1] + 0.2 + (torch.rand((k, 2), generator=gen, device=dev)
                           - 0.5) * 0.4
    cases = {
        "main": (torch.zeros((size, size), device=dev),
                 (xy, yaw, db, alive, tr, spec, cfg.grid, reach)),
        "overlap": (_prefilled(size, gen, dev),
                    (xy_o, yaw[:k], db[:k], alive[:k],
                     None if tr is None else tr[:k], spec, cfg.grid,
                     reach)),
    }
    worst = _hold_equal(name, kernel, plain, cases, size)

    g_t = torch.zeros((size, size), device=dev)
    w = bc._windows(g_t, xy, yaw, db, alive, spec, cfg.grid, tr, reach,
                    pack8)
    ln = bc._prepare(g_t, w, spec)
    dense = bc._dense_fan(spec, reach)
    t_kernel, t_plain, runs = _ab_ms(
        lambda: bc._launch(g_t, ln, spec, cfg.grid, dense),
        lambda: plain(g_t, xy, yaw, db, alive, tr, spec, cfg.grid, reach),
        20, 3)
    t_wrapper = _median_ms(lambda: kernel(
        g_t, xy, yaw, db, alive, tr, spec, cfg.grid, reach), 20)

    # bound: the union of the windows read and written once (windows are
    # 8-row and 128-column aligned, so an [S/8, S/128] mask counts it
    # exactly), the operands read once, the counts written once; every
    # cell of the fan-bbox strips the kernel evaluates
    blocks = torch.zeros((size // 8, size // 128), dtype=torch.bool,
                         device=dev)
    rb = (w.row0 // 8).long()[:, None] + torch.arange(w.rows // 8,
                                                      device=dev)
    cb = (w.col0 // 128).long()[:, None] + torch.arange(w.cols // 128,
                                                        device=dev)
    blocks[rb[:, :, None], cb[:, None, :]] = True
    cells = int(blocks.sum()) * 8 * 128
    n_bytes = 2 * 4 * cells + _nbytes(ln.origins, ln.meta, ln.table) + \
        4 * N_AGENTS
    evaluated = int(((w.t_ch - w.t_cl).clamp_min(0) * w.rows * 128).sum())
    bound, bound_by = _bound(n_bytes, evaluated * OPS_PER_CELL)
    print(f"{name} raster at {N_AGENTS} agents x {spec.n_beams} beams "
          f"({bc.form_name(spec, pack8)}) on {size}^2 [{card}]: kernel "
          f"{t_kernel:.4f} ms (runs {runs[0]:.4f}, {runs[3]:.4f}), wrapper "
          f"with its preparation {t_wrapper:.4f} ms, plain torch "
          f"{t_plain:.4f} ms (runs {runs[1]:.4f}, {runs[2]:.4f}); bound "
          f"{bound:.4f} ms by {bound_by} ({n_bytes} bytes, {evaluated} cell "
          f"evaluations)")
    return dict(max_abs_err=worst, ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=bound_by)


def phase_window_kernel(card, dev):
    """The deployable form (pack8 + ring, the 181-beam scan)."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev)
    return _window_form(card, dev, "window", cfg, params, rooms, SEED,
                        four_way=False, pack8=True)


def phase_form_kernels(card, dev):
    """The exploration path's forms (pack16 without the ring on the scan
    and on the wrapped 4-way fan, in the coverage world) and the
    ultrasonic-only path's (pack8 + ring on the wrapped fan)."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.coverage(N_AGENTS, device=dev)
    out = {"pack16": _window_form(card, dev, "window pack16 scan", cfg,
                                  params, rooms, SEED + 3, False, False),
           "pack16-wrapped": _window_form(card, dev, "window pack16 4-way",
                                          cfg, params, rooms, SEED + 4,
                                          True, False)}
    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                               scan_rays=0)
    out["pack8-ring-wrapped"] = _window_form(
        card, dev, "window pack8 4-way", cfg, params, rooms, SEED + 5, True,
        True)
    return out


def phase_room_kernel(card, dev):
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                               room_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    spec = BeamSpec.scan(cfg.engine.scan_rays)
    reach = reach_cells(cfg)
    size = cfg.grid.size
    per_row = cfg.engine.room_tile_per_row
    alive = torch.ones((N_AGENTS,), dtype=torch.bool, device=dev)
    xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev)
    alive[-3] = False                       # one inactive agent

    # overlap case: the second agent of every room within +-3 cells of the
    # first, on a grid pre-filled near +-clamp
    xy_o = xy.clone()
    xy_o[1::2] = xy[0::2] + (torch.rand((N_AGENTS // 2, 2), generator=gen,
                                        device=dev) - 0.5) * 0.3
    kw = dict(spec=spec, cfg=cfg.grid, n_groups=spec.n_beams,
              per_row=per_row, trusted=tb, reach=reach)

    def kernel(g, *a):
        return rc.room_raster(g, *a, **kw)

    def plain(g, *a):
        return rc.room_raster_plain(g, *a, **kw)

    cases = {
        "main": (torch.zeros((size, size), device=dev),
                 (xy, yaw, db, alive)),
        "overlap": (_prefilled(size, gen, dev), (xy_o, yaw, db, alive)),
    }
    worst = _hold_equal("room", kernel, plain, cases, size)

    g_t = torch.zeros((size, size), device=dev)
    rm = rc._rooms(g_t, xy, yaw, db, alive, cfg.grid, per_row, tb, reach)
    dense = rc._dense_fan(spec, reach)
    t_kernel, t_plain, runs = _ab_ms(
        lambda: rc._launch(g_t, rm, spec, cfg.grid, dense),
        lambda: plain(g_t, xy, yaw, db, alive), 20, 3)
    t_wrapper = _median_ms(lambda: kernel(g_t, xy, yaw, db, alive), 20)

    # bound: in every tile the union of its two slots' window rows (an
    # empty slot's too: the reference clips it) read and written once, the
    # operands read once, the counts written once; every slot's window
    # evaluated
    r_loc = rm.meta[..., 4]
    lo, hi = r_loc.amin(-1), r_loc.amax(-1)
    rows = torch.minimum(hi - lo, torch.full_like(lo, rm.win_rows)) + \
        rm.win_rows
    cells = int(rows.sum()) * 256
    n_tiles = rm.meta.shape[0] * rm.meta.shape[1]
    n_bytes = 2 * 4 * cells + _nbytes(rm.meta, rm.table) + 4 * n_tiles
    evaluated = n_tiles * rc.AGENTS_PER_ROOM * rm.win_rows * 256
    bound, bound_by = _bound(n_bytes, evaluated * OPS_PER_CELL)
    print(f"room raster at {N_AGENTS} agents ({n_tiles} tiles, {per_row} "
          f"rooms per row) x {spec.n_beams} beams on {size}^2 [{card}]: "
          f"kernel {t_kernel:.4f} ms (runs {runs[0]:.4f}, {runs[3]:.4f}), "
          f"wrapper with its preparation {t_wrapper:.4f} ms, plain torch "
          f"{t_plain:.4f} ms (runs {runs[1]:.4f}, {runs[2]:.4f}); bound "
          f"{bound:.4f} ms by {bound_by} ({n_bytes} bytes, {evaluated} "
          f"cell evaluations)")
    return dict(max_abs_err=worst, ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=bound_by)


def phase_path(card, dev, room_kernel: bool):
    """One main path at full width: reset the launch counters, one warm-up
    step and TIMED_STEPS timed steps, read the counters."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    name = "room" if room_kernel else "window"
    cfg, walls, params, rooms = presets.deployable(
        N_AGENTS, device=dev, room_kernel=room_kernel)
    every = cfg.engine.merge_every
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, walls_grouped=rooms[0],
                         room_of_agent=rooms[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()                          # the main path starts here
    state, m0 = step(state)                  # warm-up (online is 0 at t=0)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_STEPS + 1)]
    t0 = time.perf_counter()
    ms = []
    events[0].record()
    for k in range(TIMED_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    launches = {"free_raster": n_free, "room_raster": n_room}

    steps_run = TIMED_STEPS + 1
    own, other = (("room_raster", "free_raster") if room_kernel
                  else ("free_raster", "room_raster"))
    writes = torch.stack([m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    merges = torch.stack([m0.merges] + [m.merges for m in ms]).cpu()
    if launches[own] != steps_run or launches[other] != 0 or \
            (not room_kernel and by_form != {"pack8-ring": steps_run}):
        raise AssertionError(f"{name} path: launches {launches} in "
                             f"{steps_run} steps")
    if not bool((writes > 0).all()) or int(m0.writes) <= 0:
        raise AssertionError(f"{name} path: a step wrote no cells")
    if not bool((online == N_AGENTS).all()):
        raise AssertionError(f"{name} path: online {online.tolist()[:8]}")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"{name} path: non-finite poses")
    merge_steps = [k for k in range(steps_run) if k % every == every - 1]
    if int(merges.sum()) <= 0:
        raise AssertionError(f"{name} path: no merge in {steps_run} steps")

    # device-timeline step times (medians: the first merge step also pays
    # the matcher's one-time library set-up)
    step_ms = [events[k].elapsed_time(events[k + 1])
               for k in range(TIMED_STEPS)]
    on = [step_ms[k - 1] for k in merge_steps if k >= 1]
    off = sorted(t for k, t in enumerate(step_ms, 1) if k not in merge_steps)
    applied = int(writes.to(torch.int64).sum())
    peak = torch.cuda.max_memory_allocated()
    print(f"{name} path: {steps_run} steps, launches {launches}, online "
          f"{N_AGENTS}/{N_AGENTS} on every timed step, min writes "
          f"{int(writes.min())}, poses finite, merges "
          f"{[int(merges[k]) for k in merge_steps]} at steps {merge_steps}")
    print(f"{name} path at {N_AGENTS} agents [{card}]: "
          f"{TIMED_STEPS / wall:.2f} steps/s, {applied / wall:.6e} applied "
          f"cells/s ({applied} cells in {wall:.4f} s), peak memory {peak} "
          f"bytes; step median {off[len(off) // 2]:.4f} ms without a merge,"
          f" {sorted(on)[len(on) // 2]:.4f} ms with one ({len(on)} merge "
          f"steps, the first {on[0]:.4f} ms)")
    return launches[own], (cfg, rooms, state, ms[-1])


def phase_merge(card, dev, cfg, rooms, state, m):
    """One merge event at 1024 agents, on the room path's final state: the
    engine's call (scan_merge_recover, one 128-agent chunk) and the
    matcher's two translation-scoring routes on that chunk."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise
    from swarm_tpu_torch.slam import livemerge, scanmatch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, r = cfg.n_agents, cfg.engine.scan_rays
    scan = sense_scan(draw_sensor_noise(gen, (n, r), dev), state.pose_true,
                      rooms[0][rooms[1].long()], r, cfg.sensors)
    srv = state.srv
    match_map = torch.where(torch.abs(srv.anchor) >= 0.5, srv.anchor,
                            srv.logodds)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    rx, ry, ryaw = m.srv_x, m.srv_y, m.srv_yaw

    def event():
        return livemerge.scan_merge_recover(
            match_map, rx, ry, ryaw, scan, alive, cfg, event=3, n_global=n,
            fail_count=srv.merge_fail)

    event()
    t_event = _median_ms(event, 7)
    c = min(cfg.slam.merge_chunk, n)
    results = {}

    def match(scores):
        def run():
            port_scores = scanmatch._scores
            scanmatch._scores = scores
            try:
                results[scores] = livemerge.scan_merge(
                    match_map, rx[:c], ry[:c], ryaw[:c], scan[:c], alive[:c],
                    cfg)
            finally:
                scanmatch._scores = port_scores
        return run

    conv, im2col = scanmatch._scores, scanmatch._scores_im2col
    t_conv, t_im2col, runs = _ab_ms(match(conv), match(im2col), 7, 7)
    a, b = results[conv], results[im2col]
    same_ok = int((a.ok == b.ok).sum())
    d_max = float(torch.maximum((a.ddx - b.ddx).abs(),
                                (a.ddy - b.ddy).abs()).max())
    print(f"merge event at {n} agents [{card}]: scan_merge_recover on a "
          f"{c}-agent chunk {t_event:.4f} ms ({int(event()[0].ok.sum())} "
          f"verified); matcher on the chunk with translation scoring by "
          f"grouped conv2d (the port) {t_conv:.4f} ms (runs {runs[0]:.4f}, "
          f"{runs[3]:.4f}) vs by im2col bmm {t_im2col:.4f} ms (runs "
          f"{runs[1]:.4f}, {runs[2]:.4f}); the two agree on ok for "
          f"{same_ok}/{c} agents, max |d correction| {d_max:.3e} m")
    if same_ok < c - 2:
        raise AssertionError("conv and im2col scoring disagree")


def phase_reference(dev, room_kernel: bool):
    """The same REF_STEPS steps at REF_AGENTS agents on the card and on the
    CPU, from the same state and noise."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (agent_merge_box, draw_step_noise,
                                            sim_init, sim_step)
    from swarm_tpu_torch.ops.raster import tri_state_view

    name = "room" if room_kernel else "window"
    n = REF_AGENTS
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    worlds = {d: presets.deployable(n, device=d, room_kernel=room_kernel)
              for d in (cpu, dev)}
    states = {d: sim_init(w[0], w[2]) for d, w in worlds.items()}
    boxes = {d: agent_merge_box(w[0], w[3][0], w[3][1], d)
             for d, w in worlds.items()}
    writes = {cpu: [], dev: []}
    merges = {cpu: [], dev: []}
    last = {}
    for k in range(REF_STEPS):
        noise = draw_step_noise(gen, n, 181, cpu)
        ms = {}
        for d, (cfg, walls, params, rooms) in worlds.items():
            nz = type(noise)(*(type(f)(*(x.to(d) for x in f))
                               for f in noise))
            states[d], ms[d] = sim_step(
                states[d], nz, cfg, walls, params, walls_grouped=rooms[0],
                room_of_agent=rooms[1], step_no=k, merge_win_box=boxes[d])
            writes[d].append(int(ms[d].writes))
            merges[d].append(int(ms[d].merges))
        if merges[cpu][-1] or merges[dev][-1]:
            ok_c, ok_d = ms[cpu].merge_ok, ms[dev].merge_ok.cpu()
            for a in torch.nonzero(ok_c != ok_d).flatten().tolist():
                print(f"reference [{name}] step {k}: agent {a} merge "
                      f"{bool(ok_d[a])} on the card vs {bool(ok_c[a])} on "
                      f"the CPU (fitness {float(ms[dev].merge_fit[a])} vs "
                      f"{float(ms[cpu].merge_fit[a])})")
        last = ms
    cfg = worlds[cpu][0]
    if int(last[cpu].online) != int(last[dev].online):
        raise AssertionError(f"reference [{name}]: online differs")
    w_c, w_d = sum(writes[cpu]), sum(writes[dev])
    if abs(w_c - w_d) > 0.01 * w_c:
        raise AssertionError(f"reference [{name}]: writes {w_d} on the card "
                             f"vs {w_c} on the CPU")
    tri_c = tri_state_view(states[cpu].srv.logodds, cfg.grid)
    tri_d = tri_state_view(states[dev].srv.logodds, cfg.grid).cpu()
    explored = (tri_c != cfg.grid.unknown) | (tri_d != cfg.grid.unknown)
    agree = float(((tri_c == tri_d) & explored).sum()) / max(
        int(explored.sum()), 1)
    ev = [k for k in range(REF_STEPS) if merges[cpu][k] or merges[dev][k]]
    print(f"reference [{name}] at {n} agents, {REF_STEPS} steps: writes "
          f"{w_d} (card) vs {w_c} (CPU), tri-state agreement {agree:.6f} "
          f"over {int(explored.sum())} explored cells, merges at steps {ev}:"
          f" {[merges[dev][k] for k in ev]} (card) vs "
          f"{[merges[cpu][k] for k in ev]} (CPU)")
    if agree < 0.99:
        raise AssertionError(f"reference [{name}]: card and CPU maps "
                             f"disagree")
    if not ev:
        raise AssertionError(f"reference [{name}]: no merge event ran")


def reachable_mask(walls, grid_cfg, inset_cells: int = 1):
    """Ground-truth reachable free space (tools/bench_coverage.py
    `reachable_mask`): cells whose centres lie inside a room rectangle
    inset by `inset_cells`. Rooms are 4 consecutive wall segments."""
    import numpy as np

    res = grid_cfg.resolution
    s = grid_cfg.size
    mask = np.zeros((s, s), bool)
    rects = np.asarray(walls, np.float64).reshape(-1, 4, 4)
    for seg in rects:
        xs = np.concatenate([seg[:, 0], seg[:, 2]])
        ys = np.concatenate([seg[:, 1], seg[:, 3]])
        x0, x1 = xs.min(), xs.max()
        y0, y1 = ys.min(), ys.max()
        pad = inset_cells * res
        cx0 = int(np.ceil((x0 + pad - grid_cfg.origin_x) / res))
        cx1 = int(np.floor((x1 - pad - grid_cfg.origin_x) / res))
        cy0 = int(np.ceil((y0 + pad - grid_cfg.origin_y) / res))
        cy1 = int(np.floor((y1 - pad - grid_cfg.origin_y) / res))
        cx0, cy0 = max(cx0, 0), max(cy0, 0)
        cx1, cy1 = min(cx1, s - 1), min(cy1, s - 1)
        if cx1 >= cx0 and cy1 >= cy0:
            mask[cy0:cy1 + 1, cx0:cx1 + 1] = True
    return mask


def _coverage(logodds, reach) -> float:
    """Fraction of the reachable cells the map calls FREE (the coverage
    tool's count, tools/bench_coverage.py:93-95)."""
    from swarm_tpu_torch.ops.raster import FREE_THRESH

    covered = int(((logodds <= FREE_THRESH) & reach).sum())
    return covered / max(int(reach.sum()), 1)


def _reset_counts():
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    free_raster.launches = 0
    free_raster.launches_by_form.clear()
    room_raster.launches = 0


def _read_counts():
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    return (free_raster.launches, dict(free_raster.launches_by_form),
            room_raster.launches)


def phase_explore(card, dev):
    """The exploration path at full width: presets.coverage(N_AGENTS,
    frontiers=True) with targets, step 0 untimed, then TIMED_STEPS timed
    steps; both fans through the window kernel every step, frontier events
    every 8 steps (step 0 included)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    cfg, walls, params, rooms = presets.coverage(N_AGENTS, device=dev)
    dt = cfg.nav.drive_tick_s + cfg.nav.settle_tick_s
    every = max(1, round(cfg.coord.target_interval_s / dt))
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, enable_targets=True,
                         walls_grouped=rooms[0], room_of_agent=rooms[1])
    reach = torch.as_tensor(reachable_mask(walls.cpu().numpy(), cfg.grid),
                            device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()                          # the main path starts here
    state, m0 = step(state)                  # step 0: a frontier event
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_STEPS + 1)]
    t0 = time.perf_counter()
    ms, has = [m0], [state.nav.has_target.sum()]
    events[0].record()
    for k in range(TIMED_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
        has.append(state.nav.has_target.sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()

    steps_run = TIMED_STEPS + 1
    writes = torch.stack([m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    n_fr = torch.stack([m.n_frontiers for m in ms]).cpu()
    has = torch.stack(has).cpu()
    ev = [k for k in range(steps_run) if k % every == 0]
    want = {"pack16": steps_run, "pack16-wrapped": steps_run}
    if n_free != 2 * steps_run or by_form != want or n_room != 0:
        raise AssertionError(f"exploration path: launches {n_free} "
                             f"{by_form}, room {n_room}, in {steps_run} "
                             f"steps")
    if not bool((writes > 0).all()):
        raise AssertionError("exploration path: a step wrote no cells")
    if len(ev) != 26 or not all(int(n_fr[k]) > 0 for k in ev if k >= 8):
        raise AssertionError(f"exploration path: frontier counts "
                             f"{[int(n_fr[k]) for k in ev]} at steps {ev}")
    if int(has.max()) <= 0:
        raise AssertionError("exploration path: no agent got a target")
    if not bool((online[1:] == N_AGENTS).all()):
        raise AssertionError(f"exploration path: online "
                             f"{online.tolist()[:8]}")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError("exploration path: non-finite poses")

    step_ms = [events[k].elapsed_time(events[k + 1])
               for k in range(TIMED_STEPS)]
    on = sorted(t for k, t in enumerate(step_ms, 1) if k in ev)
    off = sorted(t for k, t in enumerate(step_ms, 1) if k not in ev)
    applied = int(writes[1:].to(torch.int64).sum())
    peak = torch.cuda.max_memory_allocated()
    cover = _coverage(state.srv.logodds, reach)
    print(f"exploration path: {steps_run} steps, launches {n_free} "
          f"{by_form}, room {n_room}, online {N_AGENTS}/{N_AGENTS}, min "
          f"writes {int(writes.min())}, poses finite; {len(ev)} frontier "
          f"events, frontiers {[int(n_fr[k]) for k in ev]}, agents with a "
          f"target {[int(has[k]) for k in ev]}")
    print(f"exploration path at {N_AGENTS} agents [{card}]: "
          f"{TIMED_STEPS / wall:.2f} steps/s, {applied / wall:.6e} applied "
          f"cells/s ({applied} cells in {wall:.4f} s), peak memory {peak} "
          f"bytes; step median {off[len(off) // 2]:.4f} ms without a "
          f"frontier event, {on[len(on) // 2]:.4f} ms with one ({len(on)} "
          f"timed events); coverage {cover:.6f} of {int(reach.sum())} "
          f"reachable cells at step {steps_run - 1}")
    phase_endpoint_scatter(card, dev, cfg, rooms, state)
    return by_form


def phase_endpoint_scatter(card, dev, cfg, rooms, state):
    """The exact endpoint scatter of each fan at full width (torch ops, no
    kernel of its own), on the exploration path's final state."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise, sense_4way
    from swarm_tpu_torch.ops.beam_raster import (BeamSpec, beams_from_scan,
                                                 endpoint_rays)
    from swarm_tpu_torch.ops.raster import endpoint_scatter

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n, r = cfg.n_agents, cfg.engine.scan_rays
    walls_agent = rooms[0][rooms[1].long()]
    pose = state.pose_true
    xy = pose[:, :2].contiguous()
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for name, spec, dist in (
            ("4-way", BeamSpec.four_way(),
             sense_4way(draw_sensor_noise(gen, (n, 4), dev), pose,
                        walls_agent, cfg.sensors)),
            ("scan", BeamSpec.scan(r),
             sense_scan(draw_sensor_noise(gen, (n, r), dev), pose,
                        walls_agent, r, cfg.sensors))):
        db, tb = beams_from_scan(dist, cfg.sensors.max_range,
                                 cfg.sensors.min_range)
        rays = endpoint_rays(xy, pose[:, 2], db, tb, alive, spec)
        grid = state.srv.logodds.clone()
        _, w = endpoint_scatter(grid, rays, cfg.grid)
        t_ms = _median_ms(lambda: endpoint_scatter(grid, rays, cfg.grid),
                          20)
        t_rays = _median_ms(lambda: endpoint_rays(xy, pose[:, 2], db, tb,
                                                  alive, spec), 20)
        print(f"endpoint scatter, {name} fan at {n} agents [{card}]: "
              f"{t_ms:.4f} ms for {int(w)} endpoints ({t_rays:.4f} ms to "
              f"build the rays)")


def phase_coverage_tool(card, dev):
    """tools/bench_coverage.py's own configuration (64 agents, 1024^2,
    greedy_assign): wall-following, then frontier targets, COVERAGE_STEPS
    steps each; the closed loop is chaotic, so only coverage > 0 is
    required."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    out = {}
    for name, frontiers in (("wall_follow", False),
                            ("frontier_targets", True)):
        cfg, walls, params, rooms = presets.coverage(COVERAGE_AGENTS,
                                                     frontiers, dev)
        reach = torch.as_tensor(reachable_mask(walls.cpu().numpy(),
                                               cfg.grid), device=dev)
        state = sim_init(cfg, params)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        step = make_sim_step(cfg, walls, params, gen,
                             enable_targets=frontiers,
                             walls_grouped=rooms[0], room_of_agent=rooms[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COVERAGE_STEPS):
            state, m = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = _coverage(state.srv.logodds, reach)
        print(f"coverage tool [{name}] at {COVERAGE_AGENTS} agents on "
              f"{cfg.grid.size}^2 [{card}]: coverage {out[name]:.6f} after "
              f"{COVERAGE_STEPS} steps, {COVERAGE_STEPS / wall:.2f} steps/s, "
              f"{int(m.n_frontiers)} frontiers at the last step")
        if out[name] <= 0:
            raise AssertionError(f"coverage tool [{name}]: nothing covered")
    return out


def phase_ultrasonic(card, dev):
    """bench.py --scan-rays 0 at full width: the wrapped 4-way fan through
    the pack8 + ring form, once per step, for ULTRASONIC_STEPS steps."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   scan_rays=0)
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, walls_grouped=rooms[0],
                         room_of_agent=rooms[1])
    torch.cuda.synchronize()
    _reset_counts()                          # the main path starts here
    t0 = time.perf_counter()
    ms = []
    for _ in range(ULTRASONIC_STEPS):
        state, m = step(state)
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    writes = torch.stack([m.writes for m in ms]).cpu()
    if by_form != {"pack8-ring-wrapped": ULTRASONIC_STEPS} or n_room:
        raise AssertionError(f"ultrasonic path: launches {by_form}, room "
                             f"{n_room}, in {ULTRASONIC_STEPS} steps")
    if not bool((writes > 0).all()):
        raise AssertionError("ultrasonic path: a step wrote no cells")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError("ultrasonic path: non-finite poses")
    applied = int(writes.to(torch.int64).sum())
    print(f"ultrasonic path at {N_AGENTS} agents [{card}]: "
          f"{ULTRASONIC_STEPS} steps, launches {by_form}, min writes "
          f"{int(writes.min())}, online {int(ms[-1].online)}; "
          f"{ULTRASONIC_STEPS / wall:.2f} steps/s, {applied / wall:.6e} "
          f"applied cells/s (the first step included)")
    return by_form


def phase_entry_points(card, dev):
    """Each entry point the exploration path opens, through sim_rollout at
    N_AGENTS agents for ENTRY_STEPS steps (frontier events at steps 0, 8,
    16): every step writes, each window form launched once per step as the
    configuration prescribes and the room kernel never, frontiers found on
    the events from step 8 where they are on, targets where asked for."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init, sim_rollout

    n, k = N_AGENTS, ENTRY_STEPS
    for name, make, targets, forms in (
            ("coverage, frontier targets",
             lambda: presets.coverage(n, True, dev), True,
             {"pack16-wrapped": k, "pack16": k}),
            ("coverage, wall-following",
             lambda: presets.coverage(n, False, dev), False,
             {"pack16-wrapped": k, "pack16": k}),
            ("bench --frontiers",
             lambda: presets.deployable(n, device=dev, frontiers=True), True,
             {"pack8-ring": k}),
            ("bench --scan-rays 0",
             lambda: presets.deployable(n, device=dev, scan_rays=0), False,
             {"pack8-ring-wrapped": k})):
        cfg, walls, params, rooms = make()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = sim_init(cfg, params)
        torch.cuda.synchronize()
        _reset_counts()                      # this path starts here
        t0 = time.perf_counter()
        state, m = sim_rollout(state, k, cfg, walls, params, gen,
                               enable_targets=targets,
                               walls_grouped=rooms[0],
                               room_of_agent=rooms[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, by_form, n_room = _read_counts()
        writes, n_fr = m.writes.cpu(), m.n_frontiers.cpu()
        has = int(state.nav.has_target.sum())
        print(f"entry point [{name}] at {n} agents [{card}]: {k} steps "
              f"through sim_rollout in {wall:.4f} s, launches {by_form}, "
              f"room {n_room}, min writes {int(writes.min())}, frontiers "
              f"{[int(n_fr[j]) for j in range(0, k, 8)]} at steps "
              f"{list(range(0, k, 8))}, {has} agents with a target, "
              f"{int(m.merges.sum())} merges")
        if by_form != forms or n_room:
            raise AssertionError(f"entry point [{name}]: launches "
                                 f"{by_form}, room {n_room}")
        if not bool((writes > 0).all()):
            raise AssertionError(f"entry point [{name}]: a step wrote no "
                                 f"cells")
        if cfg.engine.compute_frontiers != bool(
                (n_fr[8::8] > 0).all()) or (has > 0) != targets:
            raise AssertionError(f"entry point [{name}]: frontiers "
                                 f"{n_fr.tolist()}, targets {has}")
        if not bool(torch.isfinite(state.pose_true).all()):
            raise AssertionError(f"entry point [{name}]: non-finite poses")


def phase_reference_explore(dev):
    """The exploration path at REF_AGENTS agents, the same EXPLORE_REF_STEPS
    steps on the card and on the CPU from the same state and noise,
    targets on: writes within 1%, tri-state maps on >= 99% of explored
    cells, equal frontier counts."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (agent_target_rooms,
                                            draw_step_noise, sim_init,
                                            sim_step)
    from swarm_tpu_torch.ops.raster import tri_state_view

    n = REF_AGENTS
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    worlds = {d: presets.coverage(n, device=d) for d in (cpu, dev)}
    states = {d: sim_init(w[0], w[2]) for d, w in worlds.items()}
    rooms_t = {d: agent_target_rooms(w[0], w[3][0], w[3][1], d)
               for d, w in worlds.items()}
    writes = {cpu: [], dev: []}
    n_fr = {cpu: [], dev: []}
    for k in range(EXPLORE_REF_STEPS):
        noise = draw_step_noise(gen, n, 181, cpu)
        for d, (cfg, walls, params, rooms) in worlds.items():
            nz = type(noise)(*(type(f)(*(x.to(d) for x in f))
                               for f in noise))
            states[d], m = sim_step(
                states[d], nz, cfg, walls, params, enable_targets=True,
                walls_grouped=rooms[0], room_of_agent=rooms[1], step_no=k,
                target_rooms=rooms_t[d])
            writes[d].append(int(m.writes))
            n_fr[d].append(int(m.n_frontiers))
    cfg = worlds[cpu][0]
    w_c, w_d = sum(writes[cpu]), sum(writes[dev])
    tri_c = tri_state_view(states[cpu].srv.logodds, cfg.grid)
    tri_d = tri_state_view(states[dev].srv.logodds, cfg.grid).cpu()
    explored = (tri_c != cfg.grid.unknown) | (tri_d != cfg.grid.unknown)
    agree = float(((tri_c == tri_d) & explored).sum()) / max(
        int(explored.sum()), 1)
    ev = list(range(0, EXPLORE_REF_STEPS, 8))
    has = [int(states[d].nav.has_target.sum()) for d in (dev, cpu)]
    print(f"reference [exploration] at {n} agents, {EXPLORE_REF_STEPS} "
          f"steps: writes {w_d} (card) vs {w_c} (CPU), tri-state agreement "
          f"{agree:.6f} over {int(explored.sum())} explored cells, frontiers"
          f" at steps {ev}: {[n_fr[dev][k] for k in ev]} (card) vs "
          f"{[n_fr[cpu][k] for k in ev]} (CPU), agents with a target "
          f"{has[0]} vs {has[1]}")
    if abs(w_c - w_d) > 0.01 * w_c:
        raise AssertionError("reference [exploration]: writes differ")
    if agree < 0.99:
        raise AssertionError("reference [exploration]: maps disagree")
    if n_fr[cpu] != n_fr[dev]:
        raise AssertionError("reference [exploration]: frontier counts "
                             "differ")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False"
                         " -- this script runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import swarm_tpu_torch  # noqa: F401  (fails outside the checkout)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    k_window = phase_window_kernel(card, dev)
    k_forms = phase_form_kernels(card, dev)
    k_room = phase_room_kernel(card, dev)
    n_window, _ = phase_path(card, dev, room_kernel=False)
    n_room, (cfg, rooms, state, m) = phase_path(card, dev, room_kernel=True)
    phase_merge(card, dev, cfg, rooms, state, m)
    n_explore = phase_explore(card, dev)
    n_ultrasonic = phase_ultrasonic(card, dev)
    phase_coverage_tool(card, dev)
    phase_entry_points(card, dev)
    phase_reference(dev, room_kernel=False)
    phase_reference(dev, room_kernel=True)
    phase_reference_explore(dev)

    free = dict(route="cuda", source="swarm_tpu_torch/csrc/free_raster.cu",
                replaces="swarm_tpu/ops/beam_raster_pallas.py:305",
                library_ms=None)
    print(json.dumps({"kernels": [
        {"name": "free_raster_pack8", **free, "launches": n_window,
         **k_window},
        {"name": "free_raster_pack16_scan", **free,
         "launches": n_explore["pack16"], **k_forms["pack16"]},
        {"name": "free_raster_pack16_4way", **free,
         "launches": n_explore["pack16-wrapped"],
         **k_forms["pack16-wrapped"]},
        {"name": "free_raster_pack8_4way", **free,
         "launches": n_ultrasonic["pack8-ring-wrapped"],
         **k_forms["pack8-ring-wrapped"]},
        {"name": "room_raster_pack16", "route": "cuda",
         "source": "swarm_tpu_torch/csrc/room_raster.cu",
         "replaces": "swarm_tpu/ops/beam_raster_pallas.py:672",
         "launches": n_room, **k_room, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
