"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure exits non-zero; nothing is caught and then passed):
  1. build both raster kernels (swarm_tpu_torch/csrc/free_raster.cu and
     room_raster.cu) from the checkout, one nvcc each, started together;
     print each build time;
  2. each kernel vs its plain torch version at the main path's shapes:
     1024 agents in the tiled 4096^2 world, preset start poses with random
     headings, noisy 181-beam sweeps, plus an overlap case on a grid
     pre-filled near +-clamp (window kernel: 64 agents around one point;
     room kernel: both agents of every room within a few cells of each
     other), so the per-agent clip order decides cells. Maps BIT-EQUAL,
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
  5. a reference check at 8 agents on both paths: the same 34 steps (two
     merge events) on the card and on the CPU (plain rasters) from the
     same state and noise must agree (online equal, writes within 1%,
     tri-state maps on >= 99% of explored cells); merge counts of both
     sides are printed, and any merge decision that differs is reported
     with the match fitness on both sides.
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


def _raster_inputs(cfg, params, rooms, gen, dev):
    """Main-path raster inputs: preset start poses, random headings, noisy
    181-beam sweeps against each agent's room."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise
    from swarm_tpu_torch.ops.beam_raster import beams_from_scan

    n, r = cfg.n_agents, cfg.engine.scan_rays
    yaw = (torch.rand((n,), generator=gen, device=dev) * 2 - 1) * torch.pi
    pose = torch.stack([params.home_x, params.home_y, yaw], -1)
    walls_agent = rooms[0][rooms[1].long()]
    scan = sense_scan(draw_sensor_noise(gen, (n, r), dev), pose,
                      walls_agent, r, cfg.sensors)
    db, tb = beams_from_scan(scan, cfg.sensors.max_range,
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


def phase_window_kernel(card, dev):
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    spec = BeamSpec.scan(cfg.engine.scan_rays)
    reach = reach_cells(cfg)
    size = cfg.grid.size
    alive = torch.ones((N_AGENTS,), dtype=torch.bool, device=dev)
    xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev)

    # overlap case: 64 agents within +-4 cells of one point
    k = min(64, N_AGENTS)
    xy_o = xy[:1] + 0.2 + (torch.rand((k, 2), generator=gen, device=dev)
                           - 0.5) * 0.4
    cases = {
        "main": (torch.zeros((size, size), device=dev),
                 (xy, yaw, db, alive, tb, spec, cfg.grid, reach)),
        "overlap": (_prefilled(size, gen, dev),
                    (xy_o, yaw[:k], db[:k], alive[:k], tb[:k], spec,
                     cfg.grid, reach)),
    }
    worst = _hold_equal("window", bc.free_raster, bc.free_raster_plain,
                        cases, size)

    g_t = torch.zeros((size, size), device=dev)
    w = bc._windows(g_t, xy, yaw, db, alive, spec, cfg.grid, tb, reach)
    ln = bc._prepare(g_t, w, spec)
    dense = bc._dense_fan(spec, reach)
    t_kernel, t_plain, runs = _ab_ms(
        lambda: bc._launch(g_t, ln, spec, cfg.grid, dense),
        lambda: bc.free_raster_plain(g_t, xy, yaw, db, alive, tb, spec,
                                     cfg.grid, reach), 20, 3)
    t_wrapper = _median_ms(lambda: bc.free_raster(
        g_t, xy, yaw, db, alive, tb, spec, cfg.grid, reach), 20)

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
    print(f"window raster at {N_AGENTS} agents x {spec.n_beams} beams on "
          f"{size}^2 [{card}]: kernel {t_kernel:.4f} ms (runs "
          f"{runs[0]:.4f}, {runs[3]:.4f}), wrapper with its preparation "
          f"{t_wrapper:.4f} ms, plain torch {t_plain:.4f} ms (runs "
          f"{runs[1]:.4f}, {runs[2]:.4f}); bound {bound:.4f} ms by "
          f"{bound_by} ({n_bytes} bytes, {evaluated} cell evaluations)")
    return dict(max_abs_err=worst, ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=bound_by)


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
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

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

    free_raster.launches = 0                 # the main path starts here
    room_raster.launches = 0
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
    launches = {"free_raster": free_raster.launches,
                "room_raster": room_raster.launches}

    steps_run = TIMED_STEPS + 1
    own, other = (("room_raster", "free_raster") if room_kernel
                  else ("free_raster", "room_raster"))
    writes = torch.stack([m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    merges = torch.stack([m0.merges] + [m.merges for m in ms]).cpu()
    if launches[own] != steps_run or launches[other] != 0:
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
    k_room = phase_room_kernel(card, dev)
    n_window, _ = phase_path(card, dev, room_kernel=False)
    n_room, (cfg, rooms, state, m) = phase_path(card, dev, room_kernel=True)
    phase_merge(card, dev, cfg, rooms, state, m)
    phase_reference(dev, room_kernel=False)
    phase_reference(dev, room_kernel=True)

    print(json.dumps({"kernels": [
        {"name": "free_raster_pack8", "route": "cuda",
         "source": "swarm_tpu_torch/csrc/free_raster.cu",
         "replaces": "swarm_tpu/ops/beam_raster_pallas.py:305",
         "launches": n_window, **k_window, "library_ms": None},
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
