"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure exits non-zero; nothing is caught and then passed):
  1. build the three raster kernels (swarm_tpu_torch/csrc/free_raster.cu,
     room_raster.cu and exact_raster.cu) from the checkout, one nvcc each,
     started together; print each build time, and per instance of the
     window, room and exact-raster kernels its registers and spilled bytes
     (ptxas) and its resident blocks per SM (CUDA's occupancy calculator);
  2. each kernel, in each of its per-beam forms, vs its plain torch version
     at the shapes of the path that runs it: 1024 agents in the tiled
     4096^2 world, preset start poses with random headings, noisy readings
     (181-beam sweeps, or the 4-way ultrasonics for the wrapped fan), plus
     an overlap case on a grid pre-filled near +-clamp (window kernel: 64
     agents around one point; room kernel: both agents of every room within
     a few cells of each other), so the per-agent clip order (and on a bf16
     grid the per-agent rounding) decides cells, and a NaN case (the
     overlap case's agents on such a grid with 1% NaN and 1% -0.0 cells:
     the clip keeps a NaN, as jnp.clip does). The window kernel's 16
     instances: pack8 / pack16 table x with / without the endpoint ring x
     the 181-beam scan / the wrapped 4-way fan x a float32 / bfloat16 grid;
     the room kernel's four forms: with / without the ring x scan / wrapped
     fan. Maps BIT-EQUAL (bit for bit: a -0.0 against a +0.0 counts),
     counts equal. Timed: the launch call on prepared operands (CUDA
     events, median of 20: the record's `ms`, its measure from the first
     kernel on), the kernel alone on the device (the mean of 20 launches'
     CUDA kernel times from torch.profiler: `device_ms`), the wrapper with
     its preparation, the plain version. The bound (`bound_ms`) is the
     work this run's inputs need: the covered cells read once and the
     cells whose bits the call changes written once, plus the operands;
     beside it the covered bound (`covered_bound_ms`, the records' earlier
     bound: every covered cell read and written, every strip cell
     evaluated) and the cells the kernel evaluates (its evaluation boxes,
     beam_raster_cuda.evaluation_box). The slice's form (pack8 + ring on
     bf16) also at the slice's shapes (32,768 agents on 23,296^2, the
     plain version in agent chunks);
  3. the slice: bench.py --agents 32768 --grid-dtype bfloat16
     (presets.deployable(32768, grid_dtype="bfloat16")): one warm-up step,
     the counters set to 0, 65 steps (bench.py's 400 cut to fit the time
     limit), the counters read: pack8-ring-bf16 launched once per step and
     nothing else, every step writes, merges at steps 15, 31, 47 and 63,
     all agents online, poses finite; steps/s, applied cells/s (an int64
     sum), peak memory; then 17 more steps split on the device timeline
     into raster, merge, sensing and the rest;
  4. the window path: presets.deployable(1024) (merge every 16 steps) ->
     sim_init -> 1 warm-up step -> timed steps, with every kernel launch
     counter set to 0 just before and read just after: the window kernel
     launched once per step (pack8-ring) and the room kernel never, every
     step writes, merges > 0, all 1024 agents online, poses finite;
  5. the room path: presets.deployable(1024, room_kernel=True), the same
     checks with the roles of the two kernels swapped (pack16-ring), and one
     merge event's time (a 128-agent chunk matched through
     scan_merge_recover), and the matcher on that chunk with its
     translation scoring as the port runs it (one grouped conv2d) and in the
     JAX package's im2col form (bmm over unfolded patches, the reference
     `_scores_im2col`);
  6. the exploration path: presets.coverage(1024, frontiers=True) with
     targets, 201 steps: the window kernel twice per step (pack16 on the
     4-way fan, then on the sweep) and the room kernel never, 26 frontier
     events with frontiers found from step 8 on, targets assigned, every
     step writes, all agents online, poses finite; steps/s, device step
     medians with and without a frontier event, the endpoint scatter's
     time per fan, peak memory, coverage of the reachable cells;
  7. the ultrasonic-only path: presets.deployable(1024, scan_rays=0), 101
     steps, one pack8 + ring launch on the 4-way fan per step;
  8. the coverage tool's own configuration (64 agents, 1024^2): 400 steps
     wall-following, then 400 with frontier targets; both coverages > 0;
     then each entry point of the exploration path through sim_rollout at
     1024 agents for 17 steps (coverage with and without frontier targets,
     bench.py --frontiers, bench.py --scan-rays 0), its launches per form
     checked;
  9. every other single-chip bench.py raster flag row (--no-pack8,
     --exact-endpoints, --scan-rays 0, --grid-dtype bfloat16 and
     --room-kernel in the combinations WINDOW_ROWS and ROOM_ROWS list)
     through sim_rollout at 1024 agents for 17 steps: exactly its form
     launched once per step, the other kernel never, every step writes;
     --room-kernel --grid-dtype bfloat16 raises ValueError (sim_init, and
     the room wrapper on a card grid);
 10. bf16 against f32: the 1024-agent window path on each grid dtype, same
     seed, 33 steps: tri-state agreement over explored cells >= 0.98;
 11. reference checks at 8 agents: both deployable paths over the same 34
     steps (two merge events) and the bf16 window path over 17 (one merge
     event) on the card and on the CPU (plain rasters) from the same state
     and noise (online equal, writes within 1%, tri-state maps on >= 99% of
     explored cells; merge counts of both sides printed, and equal on bf16;
     any merge decision that differs reported with the match fitness on
     both sides), and the exploration path over 17 steps (three frontier
     events; writes within 1%, maps on >= 99%, frontier counts equal);
 12. the grouped tier (bench.py --beam-groups N): each of the window
     kernel's 8 grouped instances (ring x scan / wrapped fan x float32 /
     bfloat16 grid) and the room kernel's 4 grouped forms (ring x fan) vs
     its plain version at 1024 agents in the world of the flags that launch
     it, main, overlap and NaN case, as in phase 2 (maps BIT-EQUAL; the
     counts, sums of fractions that both sides sum exactly in double,
     equal), 181 beams in 16 groups too (ROADMAP C1); the r1 exact raster
     (csrc/exact_raster.cu, no engine path calls it) on the scan and the
     wrapped 4-way fan, maps BIT-EQUAL to its plain version (torch.sin on
     the card) on the main, overlap, dirty-tile (no tile clean: values
     beyond +-clamp, -0.0) and NaN cases, its evaluated cells (the boxes,
     exact_raster_cuda.evaluation_box) printed, the kernel's sinf
     against torch.sin on the main case's residuals, and its entry point
     driven over 17 sensed frames per fan; the grouped paths
     (presets.deployable(1024, beam_groups=8), with and without
     room_kernel=True), 201 steps each with the counters set to 0 just
     before: grouped-ring launched once per step on the path's own kernel
     and the other never, every step writes, merges > 0, all agents
     online, poses finite; then 17 steps split on the device timeline on
     each of the four 1024-agent paths, and the grouped paths' steps/s,
     applied cells/s, raster share of the device step and peak memory
     beside the per-beam paths'; every grouped bench.py flag row
     (GROUPED_WINDOW_ROWS, GROUPED_ROOM_ROWS, C1_ROW) through sim_rollout
     for 17 steps, each launching exactly its form; and card vs CPU at 8 agents
     on both grouped paths over 34 steps, as in phase 11;
 13. the sharded engine's band and tile forms of the window kernel (every
     f32 form its body reaches: pack16 or grouped table x ring on / off x
     scan / wrapped fan), each vs its plain version at 1024 agents on
     4096^2: the main path's one-rank windows (the band (0, 4096) and the
     [4160, 4352] tile window of a 1x1 rank grid, all 1024 agents), the
     four 1024-row bands of a 4-rank "rows" layout (256 agents each) and
     the four [2112, 2304] tile windows of a 2x2 "tiles" layout
     (presets.tile_blocks(2, 2, 4096)), all with negative offsets and the
     grid-edge guard where a tile meets the grid's edge, plus an overlap
     case; maps BIT-EQUAL, counts equal; timed and bounded as in phase 2
     at the one-rank windows;
 14. the sharded engine (parallel/sharded.py) on a one-rank NCCL group at
     1024 agents on presets.deployable's world: "replicated", "rows" and
     "tiles" (1x1), each a warm-up step and 65 timed steps with the
     counters set to 0 just before: one launch per step of the
     decomposition's form (pack16-ring, -band, -tile) and no other, every
     step writes, merges > 0, all agents online, no band escape, finite
     poses; steps/s, peak memory and a 17-step split on the device
     timeline (sensing, raster, merge, zones, collectives, rest); one
     more step's raster inputs through the kernel and its plain version at
     the path's window and on the whole grid (bit-equal; the cells the
     float shift moves counted, ROADMAP C22); "rows" BIT-EQUAL to
     "replicated" (maps, writes, poses), "tiles" compared with it (poses
     equal, decisions within 1e-4 of the explored cells, applied cells
     within 1e-5); then every
     other band and tile form through the sharded body's bench.py flag rows
     (BAND_ROWS), 17 steps each;
 15. parallel/dryrun.py at world size 1 on the card, as its own process.
The line before the last two is the per-kernel JSON record (one entry per
kernel form, `free_raster[<form>]` / `room_raster[<form>]` /
`exact_raster[<fan>]`), then the card's name and power limit; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from kernel_ab import device_ms

N_AGENTS = 1024
SLICE_AGENTS = 32768         # bench.py --agents 32768 --grid-dtype bfloat16
SLICE_STEPS = 65             # bench.py's 400 steps, cut to fit the limit
SPLIT_STEPS = 17             # the slice's step split (one merge step)
PLAIN_CHUNK = 1024           # the plain raster at the slice's size, per call
FLAG_STEPS = 17              # one merge event (step 15)
BF16_CMP_STEPS = 33
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
# the exact raster (csrc/exact_raster.cu): the radius and the atan2
# polynomial (~30), the floor-mod wrap and the beam bin (~10), the sine
# (~20), the on-beam, near, free and hit tests, the select and the clipped
# apply (~30)
OPS_PER_CELL_EXACT = 90
GROUPED_STEPS = TIMED_STEPS                  # the grouped paths' timed steps
EXACT_FRAMES = 17            # sensed frames through the exact raster's entry


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


def _changed_cells(launch, g) -> int:
    """The cells whose bits one call of `launch` changes on the grid `g`
    as it is now; `g` is restored after."""
    g0 = g.clone()
    launch()
    torch.cuda.synchronize()
    n = _n_differ(g, g0)
    g.copy_(g0)
    return n


def _bounds(elem: int, covered: int, changed: int, operand_bytes: int,
            ops_per_cell: int, evaluated: int):
    """The record's bounds for a raster on this run's inputs. `bound_ms`:
    the work the function needs, the covered cells (the union of the
    windows) read once, the cells whose bits it changes written once and
    evaluated, the operands read and the counts written once.
    `covered_bound_ms`: the records' earlier bound, kept for comparison:
    every covered cell read and written once, every cell of the fan-bbox
    strips (`evaluated`) evaluated. Returns (the bounds, the needed
    bytes)."""
    n_bytes = elem * (covered + changed) + operand_bytes
    bound, bound_by = _bound(n_bytes, changed * ops_per_cell)
    covered_bound = _bound(2 * elem * covered + operand_bytes,
                           evaluated * ops_per_cell)[0]
    return dict(bound_ms=bound, bound_by=bound_by,
                covered_bound_ms=covered_bound), n_bytes


def _timed(worst, t_kernel, t_plain, runs, t_wrapper, t_device, bounds,
           n_bytes, changed):
    """A timed raster form's record and the timing part of its line. `ms`
    is the launch call on prepared operands (CUDA events, median of 20:
    host gap, the wrapper's fill and sum, the kernel; the records' measure
    from the first kernel on), `device_ms` the kernel alone
    (`kernel_ab.device_ms`)."""
    text = (f"launch call {t_kernel:.4f} ms (runs {runs[0]:.4f}, "
            f"{runs[3]:.4f}), kernel alone {t_device:.4f} ms (profiler), "
            f"wrapper with its preparation {t_wrapper:.4f} ms, plain torch "
            f"{t_plain:.4f} ms (runs {runs[1]:.4f}, {runs[2]:.4f}); bound "
            f"{bounds['bound_ms']:.4f} ms by {bounds['bound_by']} "
            f"({n_bytes} bytes: the covered cells read, {changed} changed "
            f"cells written), the covered bound "
            f"{bounds['covered_bound_ms']:.4f} ms")
    return text, dict(max_abs_err=worst, ms=t_kernel, device_ms=t_device,
                      plain_ms=t_plain, **bounds)


def phase_build():
    from swarm_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_all(["free_raster", "room_raster",
                                  "exact_raster"])
    for name, (lib, secs) in built.items():
        print(f"kernel build [{name}]: {secs:.2f} s ({os.path.relpath(lib)};"
              f" ptxas: {cuda_build.ptxas.get(name, 'built before')})")
    print(f"kernel builds, together: {time.perf_counter() - t0:.2f} s")
    _print_instances()


def _print_instances():
    """Per instance of the window, room and exact-raster kernels: ptxas's
    registers and spilled bytes, and the resident blocks per SM that CUDA's
    occupancy calculator gives (128-thread window and exact-raster blocks,
    512-thread room blocks)."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops import cuda_build
    from swarm_tpu_torch.ops import exact_raster_cuda as er
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    reports = {label: (regs, spill)
               for name in ("free_raster", "room_raster", "exact_raster")
               for label, regs, spill in
               cuda_build.ptxas_instances.get(name, [])}
    rows = []
    for t, kind in enumerate(("pack8", "pack16", "grouped")):
        for ring in (True, False):
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                rows.append((f"free_raster_kernel<{t},{int(ring)},{tag}>",
                             bc.form_name(BeamSpec.scan(), kind == "pack8",
                                          ring, dtype, kind == "grouped"),
                             bc.blocks_per_sm(kind, ring, dtype)))
    for grouped in (False, True):
        for ring in (True, False):
            rows.append((f"room_raster_kernel<{int(grouped)},{int(ring)}>",
                         "room " + rc.form_name(BeamSpec.scan(), ring,
                                                grouped),
                         rc.blocks_per_sm(grouped, ring)))
    rows.append(("exact_raster_kernel", "exact scan, wrapped",
                 er.blocks_per_sm()))
    for label, form, blocks in rows:
        regs, spill = reports.get(label, ("built before", "-"))
        print(f"kernel instance {label} ({form}): {regs} registers, "
              f"{spill} bytes spilled, {blocks} blocks per SM")


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


def _prefilled(size, gen, dev, dtype=torch.float32):
    levels = torch.tensor([-9.9, 9.7, -9.6, 9.95], device=dev)
    return levels[torch.randint(0, 4, (size, size), generator=gen,
                                device=dev)].to(dtype)


def _dirty(size, gen, dev):
    """A grid that leaves no tile clean: values beyond +-clamp, -0.0 cells
    and values within, so that every window cell takes its clip."""
    levels = torch.tensor([-12.5, 11.0, -0.0, 9.7, -3.2, 0.0], device=dev)
    return levels[torch.randint(0, 6, (size, size), generator=gen,
                                device=dev)]


def _with_nan(grid, gen):
    """`grid` with 1% of its cells NaN and 1% -0.0: the clip after each
    agent keeps both, as the reference's jnp.clip does."""
    u = torch.rand(grid.shape, generator=gen, device=grid.device)
    grid = grid.masked_fill(u < 0.01, float("nan"))
    return grid.masked_fill((u >= 0.01) & (u < 0.02), -0.0)


# bench.py's single-chip raster flags beyond the paths with a phase of
# their own (presets.deployable's arguments), each launching one form of
# one kernel once per step (`_form_of`)
WINDOW_ROWS = [
    dict(pack8=False), dict(exact_endpoints=True),
    dict(scan_rays=0, pack8=False), dict(scan_rays=0, exact_endpoints=True),
    dict(grid_dtype="bfloat16", exact_endpoints=True),
    dict(grid_dtype="bfloat16", scan_rays=0),
    dict(grid_dtype="bfloat16", pack8=False),
    dict(grid_dtype="bfloat16", pack8=False, exact_endpoints=True),
    dict(grid_dtype="bfloat16", scan_rays=0, pack8=False),
    dict(grid_dtype="bfloat16", scan_rays=0, pack8=False,
         exact_endpoints=True),
    dict(grid_dtype="bfloat16", scan_rays=0, exact_endpoints=True)]
ROOM_ROWS = [
    dict(room_kernel=True, exact_endpoints=True),
    dict(room_kernel=True, scan_rays=0),
    dict(room_kernel=True, scan_rays=0, exact_endpoints=True)]
SLICE = dict(grid_dtype="bfloat16")
# the grouped tier (bench.py --beam-groups N): GROUPED is the grouped path
# (bench.py --beam-groups 8, grouped-ring); the rows below launch the other
# grouped forms. The 4-way fan is grouped only in fewer than 4 groups: in 2
# groups of 2 beams. C1_ROW is 181 beams in 16 groups (ROADMAP C1), the
# path's form again: held and run, not recorded.
GROUPED = dict(beam_groups=8)
GROUPED_WINDOW_ROWS = [
    dict(beam_groups=8, exact_endpoints=True),
    dict(beam_groups=8, grid_dtype="bfloat16"),
    dict(beam_groups=8, grid_dtype="bfloat16", exact_endpoints=True),
    dict(beam_groups=2, scan_rays=0),
    dict(beam_groups=2, scan_rays=0, exact_endpoints=True),
    dict(beam_groups=2, scan_rays=0, grid_dtype="bfloat16"),
    dict(beam_groups=2, scan_rays=0, grid_dtype="bfloat16",
         exact_endpoints=True)]
C1_ROW = dict(beam_groups=16)
GROUPED_ROOM_ROWS = [
    dict(room_kernel=True, beam_groups=8, exact_endpoints=True),
    dict(room_kernel=True, beam_groups=2, scan_rays=0),
    dict(room_kernel=True, beam_groups=2, scan_rays=0, exact_endpoints=True)]


def _flags(flags) -> str:
    """bench.py's command-line flags for presets.deployable's arguments."""
    words = {"pack8": "--no-pack8", "exact_endpoints": "--exact-endpoints",
             "room_kernel": "--room-kernel"}
    out = [words[k] for k in ("room_kernel", "pack8", "exact_endpoints")
           if k in flags]
    if "scan_rays" in flags:
        out.append(f"--scan-rays {flags['scan_rays']}")
    if "grid_dtype" in flags:
        out.append(f"--grid-dtype {flags['grid_dtype']}")
    if "beam_groups" in flags:
        out.append(f"--beam-groups {flags['beam_groups']}")
    return " ".join(out)


def _form_of(flags):
    """(four_way, pack8, ring, dtype, n_groups, form key) of the raster form
    a bench.py flag row launches: the room kernel's key from
    room_raster_cuda.form_name, the window kernel's from
    beam_raster_cuda.form_name. n_groups is None per beam, as the engine
    picks the tier (groups below the fan's beams: grouped)."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    four_way = flags.get("scan_rays", 181) == 0
    pack8 = flags.get("pack8", True)
    ring = not flags.get("exact_endpoints", False)
    dtype = (torch.bfloat16 if flags.get("grid_dtype") == "bfloat16"
             else torch.float32)
    spec = BeamSpec.four_way() if four_way else BeamSpec.scan()
    groups = flags.get("beam_groups", 0)
    grouped = 0 < groups < spec.n_beams
    n_groups = groups if grouped else None
    key = (rc.form_name(spec, ring, grouped) if flags.get("room_kernel")
           else bc.form_name(spec, pack8, ring, dtype, grouped))
    return four_way, pack8, ring, dtype, n_groups, key


def _n_differ(a, b) -> int:
    """Cells whose bits differ (a -0.0 against a +0.0 counts; a NaN against
    a NaN, whatever its payload, does not)."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return int(((a.view(bits) != b.view(bits)) &
                ~(torch.isnan(a) & torch.isnan(b))).sum())


def _max_abs_diff(a, b) -> float:
    """The largest |a - b| over the cells where neither is NaN."""
    d = (a.float() - b.float()).abs()
    return float(torch.where(torch.isnan(d), torch.zeros_like(d), d).max())


def _box_cells(w, spec) -> int:
    """The cells the window kernel evaluates on a clean grid: per agent its
    evaluation box (`beam_raster_cuda.evaluation_box`) within its window
    and its fan-bbox strips."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    r_lo, r_hi, c_lo, c_hi = bc.evaluation_box(w.table, w.kind, w.ring,
                                               w.ax, w.ay, w.yaw, spec,
                                               w.n_bins)
    row0, col0 = w.row0.to(torch.float32), w.col0.to(torch.float32)
    rows = torch.minimum(r_hi, row0 + w.rows) - torch.maximum(r_lo, row0)
    lo = torch.maximum(torch.maximum(c_lo, col0),
                       col0 + 128 * w.t_cl.to(torch.float32))
    hi = torch.minimum(torch.minimum(c_hi, col0 + w.cols),
                       col0 + 128 * w.t_ch.to(torch.float32))
    return int((rows.clamp_min(0).double() *
                (hi - lo).clamp_min(0).double()).sum())


def _room_box_cells(rm, spec) -> int:
    """The cells the room kernel evaluates: per slot (an empty one too) its
    evaluation box within its window."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops import room_raster_cuda as rc

    br_n, bc_n = rm.meta.shape[:2]
    m = rm.meta.reshape(-1, rc.META)
    r_lo, r_hi, c_lo, c_hi = bc.evaluation_box(
        rm.table.reshape(m.shape[0], -1), rm.kind, rm.ring, m[:, 0], m[:, 1],
        m[:, 2], spec, rm.n_bins)
    dev = m.device
    tr = torch.arange(br_n, device=dev).repeat_interleave(
        bc_n * rc.AGENTS_PER_ROOM).to(torch.float32)
    tc = torch.arange(bc_n, device=dev).repeat_interleave(
        rc.AGENTS_PER_ROOM).repeat(br_n).to(torch.float32)
    row0 = tr * rc.TILE_ROWS + m[:, 4]
    rows = torch.minimum(r_hi, row0 + rm.win_rows) - torch.maximum(r_lo, row0)
    cols = torch.minimum(c_hi, tc * rc.TILE_COLS + rc.TILE_COLS) - \
        torch.maximum(c_lo, tc * rc.TILE_COLS)
    return int((rows.clamp_min(0).double() *
                cols.clamp_min(0).double()).sum())


def _hold_equal(name, kernel, plain, cases, size):
    """Run kernel and plain version on each case's copy of the grid; maps
    bit-equal (NaN cells NaN on both sides), counts equal (both sum them
    exactly, in double: the grouped tier's fractional counts too). Returns
    the largest |difference| (0.0)."""
    worst = 0.0
    for case, (grid0, args) in cases.items():
        g_k, g_p = grid0.clone(), grid0.clone()
        _, c_k = kernel(g_k, *args)
        torch.cuda.synchronize()
        _, c_p = plain(g_p, *args)
        torch.cuda.synchronize()
        n_diff = _n_differ(g_k, g_p)
        err = _max_abs_diff(g_k, g_p)
        worst = max(worst, err)
        print(f"{name} kernel vs plain [{case}]: {n_diff} of {size * size} "
              f"cells differ (max |diff| {err}), "
              f"{_n_differ(g_k, grid0)} cells changed, "
              f"{int(torch.isnan(g_k).sum())} NaN cells, counts sum "
              f"{float(c_k.sum())} vs {float(c_p.sum())}")
        if n_diff:
            raise AssertionError(f"{name}: kernel and plain maps differ in "
                                 f"{n_diff} cells [{case}]")
        if not torch.equal(c_k, c_p):
            raise AssertionError(f"{name}: counts differ [{case}]")
        if float(c_k.sum()) <= 0:
            raise AssertionError(f"{name}: nothing painted [{case}]")
    return worst


def _covered_cells(w, size, dev, n_cols=None) -> int:
    """The cells of the union of the agents' windows (`w.row0`, `w.col0`,
    `w.rows`, `w.cols`) on a [size, n_cols or size] grid: windows are
    8-row (16 on bf16) and 128-column aligned, so an [S/8, S/128] mask
    counts them exactly."""
    blocks = torch.zeros((-(-size // 8), (n_cols or size) // 128),
                         dtype=torch.bool, device=dev)
    rb = (w.row0 // 8).long()[:, None] + torch.arange(w.rows // 8,
                                                      device=dev)
    cb = (w.col0 // 128).long()[:, None] + torch.arange(w.cols // 128,
                                                        device=dev)
    blocks[rb[:, :, None], cb[:, None, :]] = True
    return int(blocks.sum()) * 8 * 128


def _plain_in_chunks(plain):
    """The plain raster over agent chunks of PLAIN_CHUNK, in index order:
    each agent's window is applied after the previous agent's whatever
    the chunking, so this is the same function at a fraction of the
    memory (the slice's [32768, 80, 256] float32 deltas would be 2.7 GB
    per temporary)."""
    def run(g, xy, yaw, db, alive, tr, *rest):
        counts = []
        for i in range(0, xy.shape[0], PLAIN_CHUNK):
            j = slice(i, i + PLAIN_CHUNK)
            counts.append(plain(g, xy[j], yaw[j], db[j], alive[j],
                                None if tr is None else tr[j], *rest)[1])
        return g, torch.cat(counts)
    return run


def _window_form(card, dev, name, cfg, params, rooms, seed, four_way,
                 pack8, ring, n_groups=None):
    """One form of the window kernel at a path's shapes (the grid's dtype
    from `cfg`; `n_groups` below the fan's beams: the grouped tier with the
    engine's tail weight): held bit-equal to its plain version at the
    path's swarm size, in an overlap case (64 agents around one point on
    a grid pre-filled near +-clamp) and in a NaN case (the same agents, 1%
    NaN and 1% -0.0 cells), then timed: the launch on prepared
    operands, the wrapper with its preparation, the plain version (in agent
    chunks above PLAIN_CHUNK agents); the bound from this run's inputs.
    Returns (the form's launch-count key, its record)."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = (BeamSpec.four_way() if four_way
            else BeamSpec.scan(cfg.engine.scan_rays))
    reach = reach_cells(cfg)
    size = cfg.grid.size
    dtype = cfg.grid.lo_dtype
    n = cfg.n_agents
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev, four_way)
    tr = tb if ring else None
    grouped = bc.table_kind(spec, pack8, n_groups) == "grouped"
    tier = (dict(n_groups=n_groups, tail_weight=cfg.engine.beam_tail_weight)
            if grouped else {})

    def kernel(g, *a):
        return bc.free_raster(g, *a, pack8=pack8, **tier)

    def plain_one(g, *a):
        return bc.free_raster_plain(g, *a, pack8=pack8, **tier)

    plain = _plain_in_chunks(plain_one) if n > PLAIN_CHUNK else plain_one
    # overlap case: 64 agents within +-4 cells of one point
    k = min(64, n)
    xy_o = xy[:1] + 0.2 + (torch.rand((k, 2), generator=gen, device=dev)
                           - 0.5) * 0.4
    cases = {
        "main": (torch.zeros((size, size), device=dev, dtype=dtype),
                 (xy, yaw, db, alive, tr, spec, cfg.grid, reach)),
        "overlap": (_prefilled(size, gen, dev, dtype),
                    (xy_o, yaw[:k], db[:k], alive[:k],
                     None if tr is None else tr[:k], spec, cfg.grid,
                     reach)),
    }
    cases["nan"] = (_with_nan(_prefilled(size, gen, dev), gen).to(dtype),
                    cases["overlap"][1])
    worst = _hold_equal(name, kernel, plain, cases, size)
    del cases

    g_t = torch.zeros((size, size), device=dev, dtype=dtype)
    w = bc._windows(g_t, xy, yaw, db, alive, spec, cfg.grid, tr, reach,
                    pack8, **tier)
    ln = bc._prepare(g_t, w, spec)
    dense = bc._dense_fan(spec, reach)

    def launch():
        bc._launch(g_t, ln, spec, cfg.grid, dense)

    changed = _changed_cells(launch, g_t)
    t_kernel, t_plain, runs = _ab_ms(
        launch,
        lambda: plain(g_t, xy, yaw, db, alive, tr, spec, cfg.grid, reach),
        20, 3 if n <= PLAIN_CHUNK else 1)
    t_wrapper = _median_ms(lambda: kernel(
        g_t, xy, yaw, db, alive, tr, spec, cfg.grid, reach), 20)
    t_device = device_ms(launch, 20, "free_raster_kernel")

    # bounds: over the union of the windows; the operands read once, the
    # counts written once; the covered bound evaluates every cell of the
    # fan-bbox strips
    evaluated = int(((w.t_ch - w.t_cl).clamp_min(0) * w.rows * 128).sum())
    bounds, n_bytes = _bounds(
        g_t.element_size(), _covered_cells(w, size, dev), changed,
        _nbytes(ln.origins, ln.meta, ln.table) + 4 * n, OPS_PER_CELL,
        evaluated)
    text, rec = _timed(worst, t_kernel, t_plain, runs, t_wrapper, t_device,
                       bounds, n_bytes, changed)
    form = bc.form_name(spec, pack8, ring, dtype, grouped)
    groups = f" in {w.n_bins} groups" if grouped else ""
    print(f"{name} raster at {n} agents x {spec.n_beams} beams{groups} "
          f"({form}, [{w.rows}, {w.cols}] windows) on {size}^2 [{card}]: "
          f"{text}; the kernel evaluates {_box_cells(w, spec)} cells (its "
          f"boxes; the covered bound counts {evaluated})")
    return form, rec


def phase_window_kernel(card, dev):
    """The deployable form (pack8 + ring, the 181-beam scan)."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev)
    return dict([_window_form(card, dev, "window", cfg, params, rooms, SEED,
                              four_way=False, pack8=True, ring=True)])


def phase_form_kernels(card, dev):
    """The exploration path's forms (pack16 without the ring on the scan
    and on the wrapped 4-way fan, in the coverage world) and the
    ultrasonic-only path's (pack8 + ring on the wrapped fan)."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.coverage(N_AGENTS, device=dev)
    out = dict([_window_form(card, dev, "window pack16 scan", cfg, params,
                             rooms, SEED + 3, four_way=False, pack8=False,
                             ring=False),
                _window_form(card, dev, "window pack16 4-way", cfg, params,
                             rooms, SEED + 4, four_way=True, pack8=False,
                             ring=False)])
    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                               scan_rays=0)
    out.update([_window_form(card, dev, "window pack8 4-way", cfg, params,
                             rooms, SEED + 5, four_way=True, pack8=True,
                             ring=True)])
    # every other instance (table x ring x fan x storage), each in the
    # world of the bench.py flags that launch it; the slice's own
    # (pack8-ring-bf16) here at 1024 agents too
    for i, flags in enumerate(WINDOW_ROWS + [SLICE]):
        cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   **flags)
        four_way, pack8, ring, _, _, key = _form_of(flags)
        out.update([_window_form(card, dev, f"window {key}", cfg, params,
                                 rooms, SEED + 7 + i, four_way, pack8,
                                 ring)])
    return out


def phase_room_kernel(card, dev, flags=None, seed=SEED + 1):
    """One form of the room kernel (the ring on the scan, or the form a
    ROOM_ROWS or GROUPED_ROOM_ROWS row launches) at 1024 agents: held
    bit-equal to its plain version on the main case, an overlap case and
    a NaN case, then timed as the window forms are."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    flags = flags or dict(room_kernel=True)
    four_way, _, ring, _, n_groups, key = _form_of(flags)
    cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                               **flags)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = BeamSpec.four_way() if four_way else BeamSpec.scan(
        cfg.engine.scan_rays)
    reach = reach_cells(cfg)
    size = cfg.grid.size
    per_row = cfg.engine.room_tile_per_row
    alive = torch.ones((N_AGENTS,), dtype=torch.bool, device=dev)
    xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev, four_way)
    tb = tb if ring else None
    alive[-3] = False                       # one inactive agent

    # overlap case: the second agent of every room within +-3 cells of the
    # first, on a grid pre-filled near +-clamp
    xy_o = xy.clone()
    xy_o[1::2] = xy[0::2] + (torch.rand((N_AGENTS // 2, 2), generator=gen,
                                        device=dev) - 0.5) * 0.3
    tail = cfg.engine.beam_tail_weight
    kw = dict(spec=spec, cfg=cfg.grid, n_groups=n_groups or spec.n_beams,
              per_row=per_row, trusted=tb, reach=reach)
    if n_groups:
        kw["tail_weight"] = tail

    def kernel(g, *a):
        return rc.room_raster(g, *a, **kw)

    def plain(g, *a):
        return rc.room_raster_plain(g, *a, **kw)

    cases = {
        "main": (torch.zeros((size, size), device=dev),
                 (xy, yaw, db, alive)),
        "overlap": (_prefilled(size, gen, dev), (xy_o, yaw, db, alive)),
        "nan": (_with_nan(_prefilled(size, gen, dev), gen),
                (xy_o, yaw, db, alive)),
    }
    worst = _hold_equal(f"room {key}", kernel, plain, cases, size)

    g_t = torch.zeros((size, size), device=dev)
    rm = rc._rooms(g_t, xy, yaw, db, alive, spec, cfg.grid, per_row, tb,
                   reach, kw["n_groups"], tail)
    dense = rc._dense_fan(spec, reach)

    def launch():
        rc._launch(g_t, rm, spec, cfg.grid, dense)

    changed = _changed_cells(launch, g_t)
    t_kernel, t_plain, runs = _ab_ms(
        launch, lambda: plain(g_t, xy, yaw, db, alive), 20, 3)
    t_wrapper = _median_ms(lambda: kernel(g_t, xy, yaw, db, alive), 20)
    t_device = device_ms(launch, 20, "room_raster_kernel")

    # bounds: over, in every tile, the union of its two slots' window rows
    # (an empty slot's too: the reference clips it); the operands read
    # once, the counts written once; the covered bound evaluates every
    # slot's window
    r_loc = rm.meta[..., 4]
    lo, hi = r_loc.amin(-1), r_loc.amax(-1)
    rows = torch.minimum(hi - lo, torch.full_like(lo, rm.win_rows)) + \
        rm.win_rows
    n_tiles = rm.meta.shape[0] * rm.meta.shape[1]
    evaluated = n_tiles * rc.AGENTS_PER_ROOM * rm.win_rows * 256
    bounds, n_bytes = _bounds(
        4, int(rows.sum()) * 256, changed,
        _nbytes(rm.meta, rm.table) + 4 * n_tiles, OPS_PER_CELL, evaluated)
    text, rec = _timed(worst, t_kernel, t_plain, runs, t_wrapper, t_device,
                       bounds, n_bytes, changed)
    groups = f" in {rm.n_bins} groups" if n_groups else ""
    print(f"room raster at {N_AGENTS} agents ({n_tiles} tiles, {per_row} "
          f"rooms per row) x {spec.n_beams} beams{groups} ({key}) on "
          f"{size}^2 [{card}]: {text}; the kernel evaluates "
          f"{_room_box_cells(rm, spec)} cells (its boxes; the covered "
          f"bound counts {evaluated})")
    return rec


def phase_path(card, dev, room_kernel: bool, beam_groups: int = 0):
    """One main path at full width: reset the launch counters, one warm-up
    step and TIMED_STEPS timed steps, read the counters. beam_groups > 0:
    the grouped path (bench.py --beam-groups N), grouped-ring on its
    kernel. Returns (the launches of its form, (cfg, rooms, state, the last
    step's metrics), a summary: the step, steps/s, applied cells/s, peak
    memory)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    name = ("room" if room_kernel else "window") + (
        f" --beam-groups {beam_groups}" if beam_groups else "")
    cfg, walls, params, rooms = presets.deployable(
        N_AGENTS, device=dev, room_kernel=room_kernel,
        beam_groups=beam_groups)
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
    forms = _room_by_form() if room_kernel else by_form
    want = ("grouped-ring" if beam_groups else
            "pack16-ring" if room_kernel else "pack8-ring")
    if launches[own] != steps_run or launches[other] != 0 or \
            forms != {want: steps_run}:
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
    summary = dict(step=step, steps_s=TIMED_STEPS / wall,
                   cells_s=applied / wall, applied=applied, peak=peak)
    return launches[own], (cfg, rooms, state, ms[-1]), summary


def phase_path_split(card, name, state, summary):
    """SPLIT_STEPS more steps of a 1024-agent path split on the device
    timeline (`_step_split`); adds the raster's share of the device step
    (medians over the steps with neither a merge nor a zone snapshot) to
    the path's summary."""
    # the step goes: it holds its path's world, which later peaks would
    # count
    state, split = _step_split(summary.pop("step"), state, SPLIT_STEPS)
    summary["raster_share"] = split["raster"][0] / split["step"][0]
    print(f"{name} path step split [{card}], device-timeline medians over "
          f"{SPLIT_STEPS} more steps (ms): " + ", ".join(
              f"{p} {t:.4f} (n={k})" for p, (t, k, _) in split.items()) +
          f"; raster share of the device step "
          f"{summary['raster_share']:.4f}")
    return summary


def _compare_paths(card, paths):
    """The grouped paths beside the per-beam ones, from this run."""
    for kernel in ("window", "room"):
        rows = [(tier, paths[(kernel, tier)]) for tier in ("per-beam",
                                                             "grouped")]
        print(f"{kernel} path at {N_AGENTS} agents, per beam vs "
              f"--beam-groups 8 [{card}]: " + "; ".join(
                  f"{tier}: {s['steps_s']:.2f} steps/s, "
                  f"{s['cells_s']:.6e} applied cells/s ({s['applied']} "
                  f"cells), raster share {s['raster_share']:.4f}, peak "
                  f"memory {s['peak']} bytes" for tier, s in rows))


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


def phase_reference(dev, name: str, steps: int = REF_STEPS,
                    equal_merges: bool = False, **flags):
    """The same `steps` steps of presets.deployable(REF_AGENTS, **flags) on
    the card and on the CPU, from the same state and noise; with
    `equal_merges` the merge counts must be equal on both sides."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (agent_merge_box, draw_step_noise,
                                            sim_init, sim_step)
    from swarm_tpu_torch.ops.raster import tri_state_view

    n = REF_AGENTS
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    worlds = {d: presets.deployable(n, device=d, **flags)
              for d in (cpu, dev)}
    states = {d: sim_init(w[0], w[2]) for d, w in worlds.items()}
    boxes = {d: agent_merge_box(w[0], w[3][0], w[3][1], d)
             for d, w in worlds.items()}
    writes = {cpu: [], dev: []}
    merges = {cpu: [], dev: []}
    last = {}
    for k in range(steps):
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
    ev = [k for k in range(steps) if merges[cpu][k] or merges[dev][k]]
    print(f"reference [{name}] at {n} agents, {steps} steps: writes "
          f"{w_d} (card) vs {w_c} (CPU), tri-state agreement {agree:.6f} "
          f"over {int(explored.sum())} explored cells, merges at steps {ev}:"
          f" {[merges[dev][k] for k in ev]} (card) vs "
          f"{[merges[cpu][k] for k in ev]} (CPU)")
    if agree < 0.99:
        raise AssertionError(f"reference [{name}]: card and CPU maps "
                             f"disagree")
    if not ev:
        raise AssertionError(f"reference [{name}]: no merge event ran")
    if equal_merges and merges[cpu] != merges[dev]:
        raise AssertionError(f"reference [{name}]: merge counts differ")


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
    from swarm_tpu_torch.ops.exact_raster_cuda import beam_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    for wrapper in (free_raster, room_raster, beam_raster):
        wrapper.launches = 0
        wrapper.launches_by_form.clear()


def _read_counts():
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    return (free_raster.launches, dict(free_raster.launches_by_form),
            room_raster.launches)


def _room_by_form():
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    return dict(room_raster.launches_by_form)


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


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def _sim_parts():
    """The fused step's parts for `_step_split`: part -> (module, name)
    pairs of the functions engine.sim calls by name."""
    from swarm_tpu_torch.engine import sim

    names = {"sensing": ("sense_4way", "sense_scan"),
             "raster": ("_raster_fans",), "merge": ("_merge_event",),
             "zones": ("zones_for_agents",),
             "closure": ("closure_add_poses_batch",),
             "v2v": ("v2v_stats",)}
    return {part: tuple((sim, nm) for nm in nms)
            for part, nms in names.items()}


def _step_split(step, state, n_steps: int, parts=None):
    """n_steps more steps with CUDA events around the step and around each
    part the engine calls by name: engine.sim's `sense_4way` and
    `sense_scan` (sensing), `_raster_fans` (the raster, its preparation
    and any endpoint scatter), `_merge_event` (the merge, on merge steps),
    `zones_for_agents` (the zone snapshot, every 2 s of simulated time),
    `closure_add_poses_batch` (the closure ring's landmark match) and
    `v2v_stats` (the pairwise radio statistics). Returns (state, split):
    per part (device-timeline median ms over the steps that ran it, their
    count, the most device memory allocated while it ran); for the step
    and its rest (the step less its parts), medians over the steps with
    neither a merge nor a zone snapshot. `parts`: part -> (module, name)
    pairs to time (default `_sim_parts()`)."""
    parts = _sim_parts() if parts is None else parts
    marks = []
    originals = {(mod, nm): getattr(mod, nm)
                 for pairs in parts.values() for mod, nm in pairs}

    def timed(part, fn):
        def run(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.reset_peak_memory_stats()
            e0.record()
            out = fn(*a, **k)
            e1.record()
            marks[-1].append((part, e0, e1,
                              torch.cuda.max_memory_allocated()))
            return out
        return run

    steps = []
    try:
        for part, pairs in parts.items():
            for mod, nm in pairs:
                setattr(mod, nm, timed(part, originals[(mod, nm)]))
        for _ in range(n_steps):
            marks.append([])
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            state, _ = step(state)
            s1.record()
            steps.append((s0, s1))
        torch.cuda.synchronize()
    finally:
        for (mod, nm), fn in originals.items():
            setattr(mod, nm, fn)
    rows, peaks = [], dict.fromkeys(parts, 0)
    for (s0, s1), ms in zip(steps, marks):
        row = {"step": s0.elapsed_time(s1)}
        for part, e0, e1, peak in ms:
            row[part] = row.get(part, 0.0) + e0.elapsed_time(e1)
            peaks[part] = max(peaks[part], peak)
        row["rest"] = row["step"] - sum(row.get(p, 0.0) for p in parts)
        rows.append(row)
    split = {p: (_median([r[p] for r in rows if p in r]),
                 sum(p in r for r in rows), peaks[p]) for p in parts}
    plain = [r for r in rows if "merge" not in r and "zones" not in r]
    for p in ("step", "rest"):
        split[p] = (_median([r[p] for r in plain]), len(plain), None)
    return state, split


def phase_slice_kernel(card, dev):
    """The slice's kernel form (pack8 + ring on a bf16 grid) at the slice's
    shapes: presets.deployable(SLICE_AGENTS, grid_dtype="bfloat16"), its
    23,296^2 bf16 grid, held bit-equal to the plain version (run in agent
    chunks) and timed."""
    from swarm_tpu_torch import presets

    cfg, _, params, rooms = presets.deployable(SLICE_AGENTS, device=dev,
                                               **SLICE)
    out = dict([_window_form(card, dev, "window pack8-ring-bf16 (slice)",
                             cfg, params, rooms, SEED + 30, four_way=False,
                             pack8=True, ring=True)])
    torch.cuda.empty_cache()
    return out


def phase_slice(card, dev):
    """The slice: bench.py --agents 32768 --grid-dtype bfloat16, i.e.
    presets.deployable(SLICE_AGENTS, grid_dtype="bfloat16") -> sim_init ->
    one warm-up step (step 0) -> the counters set to 0 -> SLICE_STEPS
    timed steps (1..65; merges at 15, 31, 47 and 63) -> the counters read:
    pack8-ring-bf16 launched once per step and nothing else, every step
    writes, 4 merge events, all agents online, poses finite. Then
    SPLIT_STEPS more steps with the step split (`_step_split`)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init

    n = SLICE_AGENTS
    t_set = time.perf_counter()
    cfg, walls, params, rooms = presets.deployable(n, device=dev, **SLICE)
    every = cfg.engine.merge_every
    state = sim_init(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_sim_step(cfg, walls, params, gen, walls_grouped=rooms[0],
                         room_of_agent=rooms[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state)                   # warm-up: step 0
    torch.cuda.synchronize()
    t_set = time.perf_counter() - t_set

    _reset_counts()                          # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SLICE_STEPS + 1)]
    ms = []
    t0 = time.perf_counter()
    events[0].record()
    for k in range(SLICE_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()

    writes = torch.stack([m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    merges = torch.stack([m.merges for m in ms]).cpu()
    merge_steps = [k for k in range(1, SLICE_STEPS + 1)
                   if k % every == every - 1]
    on = [int(merges[k - 1]) for k in merge_steps]
    if by_form != {"pack8-ring-bf16": SLICE_STEPS} or n_room or \
            n_free != SLICE_STEPS:
        raise AssertionError(f"slice: launches {by_form}, room {n_room}, "
                             f"in {SLICE_STEPS} steps")
    if not bool((writes > 0).all()):
        raise AssertionError("slice: a step wrote no cells")
    if len(merge_steps) != 4 or not all(x > 0 for x in on) or \
            int(merges.sum()) != sum(on):
        raise AssertionError(f"slice: merges {merges.tolist()}")
    if not bool((online == n).all()):
        raise AssertionError(f"slice: online {online.tolist()[:8]}")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError("slice: non-finite poses")
    applied = int(writes.to(torch.int64).sum())
    peak = torch.cuda.max_memory_allocated()
    step_ms = [events[k].elapsed_time(events[k + 1])
               for k in range(SLICE_STEPS)]
    off = [t for k, t in enumerate(step_ms, 1) if k not in merge_steps]
    print(f"slice: bench.py --agents {n} --grid-dtype bfloat16 on "
          f"{cfg.grid.size}^2 ({n // 2} rooms), {SLICE_STEPS} steps after a "
          f"warm-up (set-up and warm-up "
          f"{t_set:.2f} s): launches {by_form}, room {n_room}, min writes "
          f"{int(writes.min())}, merges {on} at steps {merge_steps}, online "
          f"{n}/{n} on every step, poses finite")
    print(f"slice at {n} agents [{card}]: {SLICE_STEPS / wall:.4f} steps/s, "
          f"{applied / wall:.6e} applied cells/s ({applied} cells, int64 "
          f"sum, in {wall:.4f} s), peak memory {peak} bytes; device step "
          f"median {_median(off):.4f} ms without a merge, "
          f"{_median([step_ms[k - 1] for k in merge_steps]):.4f} ms with "
          f"one")
    state, split = _step_split(step, state, SPLIT_STEPS)
    print(f"slice step split [{card}], device-timeline medians over steps "
          f"{SLICE_STEPS + 1}-{SLICE_STEPS + SPLIT_STEPS} (ms, over the n "
          f"steps that ran each part, with the most device memory "
          f"allocated while it ran; step and rest over the steps with "
          f"neither a merge nor a zone snapshot): " + ", ".join(
              f"{p} {t:.4f} (n={k}" + ("" if peak is None else
                                       f", peak {peak} bytes") + ")"
              for p, (t, k, peak) in split.items()))
    del state, step, ms
    torch.cuda.empty_cache()
    return SLICE_STEPS


def _flag_row(card, dev, flags):
    """One bench.py flag row through sim_rollout at N_AGENTS agents for
    FLAG_STEPS steps: exactly the row's form launched once per step, the
    other kernel never, every step writes, poses finite. Returns ((kernel,
    form key), launches)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (rollout_writes, sim_init,
                                            sim_rollout)

    room = bool(flags.get("room_kernel"))
    key = _form_of(flags)[-1]
    cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   **flags)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = sim_init(cfg, params)
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    t0 = time.perf_counter()
    state, m = sim_rollout(state, FLAG_STEPS, cfg, walls, params, gen,
                           walls_grouped=rooms[0], room_of_agent=rooms[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    forms, other = ((_room_by_form(), n_free) if room
                    else (by_form, n_room))
    writes = m.writes.cpu()
    print(f"flags [{_flags(flags)}] at {N_AGENTS} agents [{card}]: "
          f"{FLAG_STEPS} steps through sim_rollout in {wall:.4f} s, "
          f"{'room' if room else 'window'} launches {forms}, other "
          f"kernel {other}, min writes {int(writes.min())}, applied "
          f"{rollout_writes(m)}, merges {int(m.merges.sum())}, online "
          f"{int(m.online[-1])}")
    if forms != {key: FLAG_STEPS} or other:
        raise AssertionError(f"flags [{_flags(flags)}]: launches "
                             f"{forms}, other kernel {other}")
    if not bool((writes > 0).all()):
        raise AssertionError(f"flags [{_flags(flags)}]: a step wrote no "
                             f"cells")
    if not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"flags [{_flags(flags)}]: non-finite "
                             f"poses")
    return ("room" if room else "window", key), forms[key]


def phase_flag_paths(card, dev):
    """Every remaining row of bench.py's single-chip raster flags (WINDOW_ROWS,
    ROOM_ROWS) through sim_rollout (`_flag_row`). Then bench.py
    --room-kernel --grid-dtype bfloat16 must raise ValueError, at sim_init
    and in the room wrapper on a card grid."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    out = dict(_flag_row(card, dev, flags)
               for flags in WINDOW_ROWS + ROOM_ROWS)

    cfg, walls, params, rooms = presets.deployable(
        N_AGENTS, device=dev, room_kernel=True, grid_dtype="bfloat16")
    refused = []
    for what, call in (
            ("sim_init", lambda: sim_init(cfg, params)),
            ("room_raster on the card", lambda: rc.room_raster(
                torch.zeros((cfg.grid.size,) * 2, dtype=torch.bfloat16,
                            device=dev), params.home_x[:, None].repeat(1, 2),
                params.yaw0, torch.ones((N_AGENTS, 181), device=dev),
                torch.ones((N_AGENTS,), dtype=torch.bool, device=dev),
                BeamSpec.scan(), cfg.grid, n_groups=181,
                per_row=cfg.engine.room_tile_per_row))):
        try:
            call()
        except ValueError as e:
            refused.append(f"{what}: ValueError({e})")
        else:
            raise AssertionError(f"--room-kernel --grid-dtype bfloat16: "
                                 f"{what} did not raise")
    print("flags [--room-kernel --grid-dtype bfloat16] refused: " +
          "; ".join(refused))
    return out


def phase_bf16_vs_f32(card, dev):
    """The 1024-agent window path on each grid dtype, same seed,
    BF16_CMP_STEPS steps: tri-state agreement over the explored cells
    >= 0.98 (the JAX package's own bar, tests/test_beam_raster.py)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import (rollout_writes, sim_init,
                                            sim_rollout)
    from swarm_tpu_torch.ops.raster import tri_state_view

    tri, writes = {}, {}
    for dt in ("float32", "bfloat16"):
        cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                       grid_dtype=dt)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state, m = sim_rollout(sim_init(cfg, params), BF16_CMP_STEPS, cfg,
                               walls, params, gen, walls_grouped=rooms[0],
                               room_of_agent=rooms[1])
        tri[dt] = tri_state_view(state.srv.logodds, cfg.grid)
        writes[dt] = rollout_writes(m)
    unknown = cfg.grid.unknown
    a, b = tri["float32"], tri["bfloat16"]
    explored = (a != unknown) | (b != unknown)
    agree = float(((a == b) & explored).sum()) / max(int(explored.sum()), 1)
    print(f"bf16 vs f32 grid, window path at {N_AGENTS} agents, "
          f"{BF16_CMP_STEPS} steps [{card}]: tri-state agreement "
          f"{agree:.6f} over {int(explored.sum())} explored cells; writes "
          f"{writes['bfloat16']} (bf16) vs {writes['float32']} (f32)")
    if agree < 0.98:
        raise AssertionError("bf16 and f32 grids disagree")


def phase_grouped_kernels(card, dev):
    """Each grouped form of both kernels at 1024 agents, in the world of the
    bench.py flags that launch it (`_window_form`, `phase_room_kernel`):
    the window kernel's 8 instances (GROUPED and the rows of
    GROUPED_WINDOW_ROWS; C1_ROW is the path's instance again, held and
    folded into its record) and the room kernel's 4 forms. Returns
    ({window form: record}, {room form: record})."""
    from swarm_tpu_torch import presets

    window = {}
    for i, flags in enumerate([GROUPED] + GROUPED_WINDOW_ROWS + [C1_ROW]):
        cfg, _, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   **flags)
        four_way, pack8, ring, _, n_groups, key = _form_of(flags)
        form, rec = _window_form(card, dev, f"window {key} "
                                 f"[{_flags(flags)}]", cfg, params, rooms,
                                 SEED + 40 + i, four_way, pack8, ring,
                                 n_groups)
        if form in window:
            window[form]["max_abs_err"] = max(window[form]["max_abs_err"],
                                              rec["max_abs_err"])
        else:
            window[form] = rec
    room = {}
    for i, flags in enumerate([dict(room_kernel=True, **GROUPED)] +
                              GROUPED_ROOM_ROWS):
        room[_form_of(flags)[-1]] = phase_room_kernel(card, dev, flags,
                                                      SEED + 50 + i)
    return window, room


def _exact_world(dev, four_way: bool):
    """The world and fan of the exact raster's cases: the deployable
    preset's 181-beam sweep, or its --scan-rays 0 world's 4-way fan."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops.beam_raster import BeamSpec

    cfg, _, params, rooms = presets.deployable(
        N_AGENTS, device=dev, scan_rays=0 if four_way else 181)
    spec = (BeamSpec.four_way() if four_way
            else BeamSpec.scan(cfg.engine.scan_rays))
    return cfg, params, rooms, spec


def _exact_box_cells(w, spec) -> int:
    """The cells the exact raster evaluates on a clean grid: per agent its
    evaluation box (`exact_raster_cuda.evaluation_box`) within its
    window."""
    from swarm_tpu_torch.ops import exact_raster_cuda as er

    r_lo, r_hi, c_lo, c_hi = er.evaluation_box(w, spec)
    row0, col0 = w.row0.to(torch.float32), w.col0.to(torch.float32)
    rows = torch.minimum(r_hi, row0 + w.rows) - torch.maximum(r_lo, row0)
    cols = torch.minimum(c_hi, col0 + w.cols) - torch.maximum(c_lo, col0)
    return int((rows.clamp_min(0).double() *
                cols.clamp_min(0).double()).sum())


def phase_exact_kernel(card, dev):
    """The r1 exact raster (csrc/exact_raster.cu, for beam_raster_pallas's
    _kernel) on the scan and on the wrapped 4-way fan at 1024 agents: the
    map held BIT-EQUAL to beam_raster_plain (torch.sin on the card) on the
    main case (one agent inactive), an overlap case (64 agents around one
    point on a grid pre-filled near +-clamp), a dirty-tile case (the main
    case's agents on a grid of values beyond +-clamp and -0.0 cells: no
    tile clean, every window cell clipped) and a NaN case (the overlap
    case's agents, 1% NaN and 1% -0.0 cells); the kernel's sinf against
    torch.sin on the main case's residual bearings; then timed as the
    window forms are, with its evaluated cells (its boxes). Returns {fan:
    record}."""
    from swarm_tpu_torch.ops import exact_raster_cuda as er

    out = {}
    for i, four_way in enumerate((False, True)):
        cfg, params, rooms, spec = _exact_world(dev, four_way)
        fan = er.form_name(spec)
        gen = torch.Generator(device=dev).manual_seed(SEED + 60 + i)
        size, n = cfg.grid.size, cfg.n_agents
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        alive[-3] = False
        xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen, dev,
                                         four_way)
        k = min(64, n)
        xy_o = xy[:1] + 0.2 + (torch.rand((k, 2), generator=gen, device=dev)
                               - 0.5) * 0.4
        main = (xy, yaw, db, tb, alive)
        overlap = (xy_o, yaw[:k], db[:k], tb[:k], alive[:k])
        cases = {"main": (torch.zeros((size, size), device=dev), main),
                 "overlap": (_prefilled(size, gen, dev), overlap),
                 "dirty": (_dirty(size, gen, dev), main),
                 "nan": (_with_nan(_prefilled(size, gen, dev), gen),
                         overlap)}
        worst = 0.0
        for case, (grid0, args) in cases.items():
            g_k, g_p = grid0.clone(), grid0.clone()
            er.beam_raster(g_k, *args, spec, cfg.grid)
            torch.cuda.synchronize()
            er.beam_raster_plain(g_p, *args, spec, cfg.grid)
            torch.cuda.synchronize()
            n_diff = _n_differ(g_k, g_p)
            err = _max_abs_diff(g_k, g_p)
            worst = max(worst, err)
            changed = _n_differ(g_k, grid0)
            n_nan = int(torch.isnan(g_k).sum())
            print(f"exact raster [{fan}] kernel vs plain [{case}]: {n_diff} "
                  f"of {size * size} cells differ (max |diff| {err}), "
                  f"{changed} cells changed, {n_nan} NaN cells")
            if n_diff or n_nan != int(torch.isnan(grid0).sum()):
                raise AssertionError(f"exact raster [{fan}]: kernel and "
                                     f"plain maps differ in {n_diff} cells, "
                                     f"{n_nan} NaN [{case}]")
            if changed <= 0:
                raise AssertionError(f"exact raster [{fan}]: nothing "
                                     f"painted [{case}]")
        del cases

        g_t = torch.zeros((size, size), device=dev)
        w = er._windows(g_t, xy, yaw, db, tb, alive, cfg.grid)
        resid = er._bins(w, spec)[3].reshape(-1).contiguous()
        s_k, s_t = er.device_sin(resid), torch.sin(resid)
        n_sin = int((s_k != s_t).sum())
        print(f"exact raster [{fan}]: the kernel's sinf vs torch.sin on the "
              f"main case's {resid.numel()} residual bearings: {n_sin} "
              f"differ (max |diff| {float((s_k - s_t).abs().max())})")
        del resid, s_k, s_t
        ln = er._prepare(g_t, w)

        def launch():
            er._launch(g_t, ln, spec, cfg.grid)

        changed = _changed_cells(launch, g_t)
        t_kernel, t_plain, runs = _ab_ms(
            launch, lambda: er.beam_raster_plain(g_t, xy, yaw, db, tb, alive,
                                                 spec, cfg.grid), 20, 3)
        t_wrapper = _median_ms(lambda: er.beam_raster(
            g_t, xy, yaw, db, tb, alive, spec, cfg.grid), 20)
        t_device = device_ms(launch, 20, "exact_raster_kernel")
        # bounds: over the union of the windows; the operands read once;
        # the covered bound evaluates every window cell (no strips)
        evaluated = n * w.rows * w.cols
        bounds, n_bytes = _bounds(
            4, _covered_cells(w, size, dev), changed,
            _nbytes(ln.origins, ln.meta, ln.table), OPS_PER_CELL_EXACT,
            evaluated)
        text, out[fan] = _timed(worst, t_kernel, t_plain, runs, t_wrapper,
                                t_device, bounds, n_bytes, changed)
        print(f"exact raster [{fan}] at {n} agents x {spec.n_beams} beams "
              f"([{w.rows}, {w.cols}] windows) on {size}^2 [{card}]: {text}"
              f"; the kernel evaluates {_exact_box_cells(w, spec)} cells "
              f"(its boxes; the covered bound counts {evaluated})")
    return out


def phase_exact_entry(card, dev):
    """The exact raster's entry point (exact_raster_cuda.beam_raster, the
    counterpart of beam_raster_pallas; no engine path calls it) over
    EXACT_FRAMES frames per fan at 1024 agents, each frame sensed anew from
    the preset's start poses with fresh headings, one grid per fan, the
    counters set to 0 just before: one launch per frame and fan, and each
    map after its frames bit-equal to the plain version's over the same
    frames. Returns {fan: launches}."""
    from swarm_tpu_torch.ops import exact_raster_cuda as er

    fans = {}
    for i, four_way in enumerate((False, True)):
        cfg, params, rooms, spec = _exact_world(dev, four_way)
        gen = torch.Generator(device=dev).manual_seed(SEED + 70 + i)
        alive = torch.ones((cfg.n_agents,), dtype=torch.bool, device=dev)
        frames = [_raster_inputs(cfg, params, rooms, gen, dev, four_way)
                  for _ in range(EXACT_FRAMES)]
        fans[er.form_name(spec)] = (cfg, spec, alive, frames)
    grids = {fan: torch.zeros((c.grid.size,) * 2, device=dev)
             for fan, (c, *_) in fans.items()}
    torch.cuda.synchronize()
    _reset_counts()                          # the entry point starts here
    t0 = time.perf_counter()
    for k in range(EXACT_FRAMES):
        for fan, (cfg, spec, alive, frames) in fans.items():
            xy, yaw, db, tb = frames[k]
            er.beam_raster(grids[fan], xy, yaw, db, tb, alive, spec,
                           cfg.grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_fan = dict(er.beam_raster.launches_by_form)
    n_free, _, n_room = _read_counts()
    if by_fan != {fan: EXACT_FRAMES for fan in fans} or n_free or n_room:
        raise AssertionError(f"exact raster entry: launches {by_fan}, "
                             f"window {n_free}, room {n_room}")
    for fan, (cfg, spec, alive, frames) in fans.items():
        g_p = torch.zeros_like(grids[fan])
        for xy, yaw, db, tb in frames:
            er.beam_raster_plain(g_p, xy, yaw, db, tb, alive, spec, cfg.grid)
        g = grids[fan]
        n_diff = int((g != g_p).sum())
        print(f"exact raster entry [{fan}] at {cfg.n_agents} agents "
              f"[{card}]: {EXACT_FRAMES} frames, launches {by_fan[fan]}, "
              f"{int((g < 0).sum())} free and {int((g > 0).sum())} occupied "
              f"cells; {n_diff} cells differ from the plain version over the "
              f"same frames; both fans' frames in {wall:.4f} s")
        if n_diff or not bool(torch.isfinite(g).all()) or \
                int((g != 0).sum()) == 0:
            raise AssertionError(f"exact raster entry [{fan}]: map wrong")
    return by_fan


def phase_grouped_flag_paths(card, dev):
    """Every grouped bench.py flag row (GROUPED_WINDOW_ROWS,
    GROUPED_ROOM_ROWS, then C1_ROW) through sim_rollout (`_flag_row`).
    Returns {(kernel, form key): launches} of the rows' own forms."""
    out = dict(_flag_row(card, dev, flags)
               for flags in GROUPED_WINDOW_ROWS + GROUPED_ROOM_ROWS)
    _flag_row(card, dev, C1_ROW)
    return out


# --------------------------------------------------------------------------
# the sharded engine (swarm_tpu_torch/parallel/) on one card

# the band and tile forms of the window kernel the sharded body reaches:
# (beams, groups, ring), as bench.py's flags reach them (BAND_ROWS)
BAND_FORMS = {"pack16-ring": (181, 181, True), "pack16": (181, 181, False),
              "pack16-ring-wrapped": (4, 4, True),
              "pack16-wrapped": (4, 4, False),
              "grouped-ring": (181, 8, True), "grouped": (181, 8, False),
              "grouped-ring-wrapped": (4, 2, True),
              "grouped-wrapped": (4, 2, False)}
# presets.deployable's arguments that make the sharded body launch each
# form (the body passes no pack8: pack16 per beam)
BAND_ROWS = {"pack16-ring": {}, "pack16": dict(exact_endpoints=True),
             "pack16-ring-wrapped": dict(scan_rays=0),
             "pack16-wrapped": dict(scan_rays=0, exact_endpoints=True),
             "grouped-ring": dict(beam_groups=8),
             "grouped": dict(beam_groups=8, exact_endpoints=True),
             "grouped-ring-wrapped": dict(beam_groups=2, scan_rays=0),
             "grouped-wrapped": dict(beam_groups=2, scan_rays=0,
                                     exact_endpoints=True)}
SHARDED_STEPS = 65           # four merge events (steps 15, 31, 47, 63)
SHARDED_FLAG_STEPS = 17
SHARDED_TIMEOUT_S = 600      # a collective waits at most this long


def _band_windows(dev):
    """The band and tile windows the sharded body gives its kernel, and
    their worlds. Returns ({kind: [(label, band, band_cols, agent slice,
    world name)]}, {world name: world}). First of each kind the main
    path's own window (one rank, presets.deployable(N_AGENTS): at 1024
    agents a 4096^2 grid, all agents): the band (0, size), and the tile
    window of a 1x1 rank grid, the whole grid plus its halo ring
    (negative offsets, the guard on every edge). Then each rank's window
    of a 4-rank "rows" layout (the 1024-row bands, 256 agents each) and of
    a 2x2 "tiles" layout on presets.tile_blocks(2, 2, size) (rooms in
    device-major order; [2112, 2304] windows, 256 agents each)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.parallel.mesh import RankLayout
    from swarm_tpu_torch.parallel.sharded import _tile_halo

    worlds = {"deployable": presets.deployable(N_AGENTS, device=dev)}
    size = worlds["deployable"][0].grid.size
    worlds["tile_blocks"] = presets.tile_blocks(2, 2, size, device=dev)

    def halo(world, r, c):
        return _tile_halo(worlds[world][0], RankLayout(
            world=r * c, rank=0, rows=r, cols=c, device=dev))

    _, _, h_r, h_c = halo("deployable", 1, 1)
    every = slice(0, N_AGENTS)
    n_loc = N_AGENTS // 4
    rows = [("1 rank", (0, size), None, every, "deployable")] + [
        (f"rank {r} of 4", (r * (size // 4), size // 4), None,
         slice(r * n_loc, (r + 1) * n_loc), "deployable") for r in range(4)]
    tiles = [("1 rank", (-h_r, size + 2 * h_r), (-h_c, size + 2 * h_c),
              every, "deployable")]
    wr, wc, h_r, h_c = halo("tile_blocks", 2, 2)
    t_loc = worlds["tile_blocks"][0].n_agents // 4
    tiles += [(f"rank {2 * tr + tc} of 2x2", (tr * wr - h_r, wr + 2 * h_r),
               (tc * wc - h_c, wc + 2 * h_c),
               slice((2 * tr + tc) * t_loc, (2 * tr + tc + 1) * t_loc),
               "tile_blocks") for tr in range(2) for tc in range(2)]
    return {"band": rows, "tile": tiles}, worlds


def phase_band_kernels(card, dev):
    """Each band and tile form (BAND_FORMS) of the window kernel against
    its plain version at the sharded body's shapes (`_band_windows`): the
    main path's one-rank windows (all 1024 agents on the band (0, 4096)
    and on the [4160, 4352] tile window of a 1x1 rank grid), each rank's
    window of a 4-rank "rows" and a 2x2 "tiles" layout (256 agents), noisy
    181-beam sweeps or 4-way readings, plus an overlap case (64 agents
    around one point of rank 1's window, pre-filled near +-clamp). Maps
    BIT-EQUAL, counts equal. Timed at the main path's one-rank windows:
    the launch on prepared operands, the wrapper, the plain version; the
    bound from this run's inputs. Returns {form key: record}."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    windows, worlds = _band_windows(dev)
    out = {}
    for kind in ("band", "tile"):
        for i, (form, (n_beams, n_groups, ring)) in enumerate(
                BAND_FORMS.items()):
            gen = torch.Generator(device=dev).manual_seed(SEED + 40 + i)
            four_way = n_beams == 4
            spec = BeamSpec.four_way() if four_way else BeamSpec.scan()
            inputs = {}
            for wn in sorted({w[-1] for w in windows[kind]}):
                cfg, _, params, rooms = worlds[wn]
                xy, yaw, db, tb = _raster_inputs(cfg, params, rooms, gen,
                                                 dev, four_way)
                inputs[wn] = (cfg, xy, yaw, db, tb if ring else None)
            tier = dict(pack8=False, n_groups=n_groups,
                        tail_weight=worlds["deployable"][0]
                        .engine.beam_tail_weight)

            def call(fn, g, wn, j, band, band_cols, xy=None):
                cfg, xy_w, yaw, db, tr = inputs[wn]
                xy = xy_w if xy is None else xy
                alive = torch.ones((yaw[j].shape[0],), dtype=torch.bool,
                                   device=dev)
                return fn(g, xy[j], yaw[j], db[j], alive,
                          None if tr is None else tr[j], spec, cfg.grid,
                          reach=reach_cells(cfg), band=band,
                          band_cols=band_cols, **tier)

            worst = 0.0
            for r, (label, band, band_cols, j, wn) in enumerate(
                    windows[kind]):
                cfg, xy = inputs[wn][:2]
                size = cfg.grid.size
                shape = (band[1], band_cols[1] if band_cols else size)
                cases = [(label, torch.zeros(shape, device=dev), j, None)]
                if r == 2:
                    # overlap: 64 of the rank's agents moved around the
                    # window's centre, in a window pre-filled near +-clamp
                    n_o = min(64, j.stop - j.start)
                    k = j.start + torch.arange(n_o, device=dev)
                    mid = [min(max(lo + n / 2.0, 0.0), size - 1.0)
                           for lo, n in (band_cols or (0, size), band)]
                    xy_o = xy.clone()
                    xy_o[k] = torch.tensor(mid, device=dev) * \
                        cfg.grid.resolution + 0.2 + (torch.rand(
                            (n_o, 2), generator=gen, device=dev) - 0.5) * 0.4
                    pre = _prefilled(max(shape), gen, dev)[:shape[0],
                                                           :shape[1]]
                    cases.append((f"{label}, overlap", pre.contiguous(), k,
                                  xy_o))
                for case, g0, jj, xs in cases:
                    g_k, g_p = g0.clone(), g0.clone()
                    _, c_k = call(bc.free_raster, g_k, wn, jj, band,
                                  band_cols, xs)
                    torch.cuda.synchronize()
                    _, c_p = call(bc.free_raster_plain, g_p, wn, jj, band,
                                  band_cols, xs)
                    torch.cuda.synchronize()
                    n_diff = _n_differ(g_k, g_p)
                    worst = max(worst, float((g_k - g_p).abs().max()))
                    n_ag = c_k.numel()
                    print(f"{form}-{kind} kernel vs plain [{case}, window "
                          f"{band}, {band_cols}, {n_ag} agents]: "
                          f"{n_diff} of {g0.numel()} cells differ, "
                          f"{int((g_k != g0).sum())} cells changed, counts "
                          f"sum {float(c_k.sum())} vs {float(c_p.sum())}")
                    if n_diff or not torch.equal(c_k, c_p):
                        raise AssertionError(f"{form}-{kind}: kernel and "
                                             f"plain differ [{case}]")
                    if float(c_k.sum()) <= 0:
                        raise AssertionError(f"{form}-{kind}: nothing "
                                             f"painted [{case}]")

            # timed at the main path's window (one rank, every agent)
            _, band, band_cols, j, wn = windows[kind][0]
            cfg, xy, yaw, db, tr = inputs[wn]
            shape = (band[1], band_cols[1] if band_cols else cfg.grid.size)
            g_t = torch.zeros(shape, device=dev)
            alive = torch.ones((j.stop - j.start,), dtype=torch.bool,
                               device=dev)
            reach = reach_cells(cfg)
            w = bc._windows(g_t, xy[j], yaw[j], db[j], alive, spec,
                            cfg.grid, None if tr is None else tr[j], reach,
                            band=band, band_cols=band_cols, **tier)
            ln = bc._prepare(g_t, w, spec)
            dense = bc._dense_fan(spec, reach)

            def launch():
                bc._launch(g_t, ln, spec, cfg.grid, dense)

            changed = _changed_cells(launch, g_t)
            t_kernel, t_plain, runs = _ab_ms(
                launch, lambda: call(bc.free_raster_plain, g_t, wn, j, band,
                                     band_cols), 20, 3)
            t_wrapper = _median_ms(
                lambda: call(bc.free_raster, g_t, wn, j, band, band_cols),
                20)
            t_device = device_ms(launch, 20, "free_raster_kernel")
            evaluated = int(((w.t_ch - w.t_cl).clamp_min(0) * w.rows *
                             128).sum())
            bounds, n_bytes = _bounds(
                4, _covered_cells(w, shape[0], dev, shape[1]), changed,
                _nbytes(ln.origins, ln.meta, ln.table) + 4 * w.row0.numel(),
                OPS_PER_CELL, evaluated)
            key = bc.form_name(spec, False, ring, grouped=w.kind ==
                               "grouped", window=kind)
            text, out[key] = _timed(worst, t_kernel, t_plain, runs,
                                    t_wrapper, t_device, bounds, n_bytes,
                                    changed)
            print(f"{key} raster at {w.row0.numel()} agents x "
                  f"{spec.n_beams} beams ([{w.rows}, {w.cols}] windows on "
                  f"a {list(shape)} {kind} window) [{card}]: {text}; the "
                  f"kernel evaluates {_box_cells(w, spec)} cells (its "
                  f"boxes; the covered bound counts {evaluated})")
    return out


def _sharded_run(dev, grid_sharding: str, flags=None):
    """(cfg, step, this rank's state) of the sharded engine on one rank at
    N_AGENTS agents (presets.deployable's world with `flags`)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init
    from swarm_tpu_torch.parallel import mesh, sharded

    cfg, walls, params, rooms = presets.deployable(N_AGENTS, device=dev,
                                                   **(flags or {}))
    lay = mesh.make_layout((1, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = sharded.make_sharded_sim_step(
        cfg, walls, params, lay, gen, grid_sharding=grid_sharding,
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    return cfg, step, sharded.shard_state(sim_init(cfg, params), lay,
                                          grid_sharding), lay


def _sharded_parts():
    """The sharded step's parts for `_step_split`."""
    from swarm_tpu_torch.coord import zones
    from swarm_tpu_torch.engine import sim
    from swarm_tpu_torch.parallel import sharded

    return {"sensing": ((sharded, "_sense"),),
            "raster": ((sharded, "_raster"),),
            "merge": ((sim, "_merge_event"),),
            "zones": ((zones, "zones_for_agents"),),
            "collectives": tuple((sharded, nm) for nm in (
                "_all_reduce_sum", "_gather_rows", "_halo_exchange",
                "_gather_grid"))}


def _captured_step(step, state):
    """One more sharded step with the window wrapper's calls recorded:
    (state, [(args, kwargs)]), each input cloned as it was passed."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    calls, real = [], bc.free_raster

    def record(*a, **kw):
        calls.append(([x.clone() if isinstance(x, torch.Tensor) else x
                       for x in a], dict(kw)))
        # the wrapper counts on its module's own name: put it back while
        # it runs
        bc.free_raster = real
        try:
            return real(*a, **kw)
        finally:
            bc.free_raster = record

    bc.free_raster = record
    try:
        state, _ = step(state)
    finally:
        bc.free_raster = real
    torch.cuda.synchronize()
    return state, calls


def _window_witness(name, calls, size):
    """The fans of one captured sharded step (`_captured_step`) raster
    again, in their band or tile window and on the whole [size, size] grid
    from the same inputs, by the kernel and by its plain version: the
    kernel BIT-EQUAL to the plain version in both, counts equal. Returns
    the cells in which the window's core and the whole grid differ (the
    same in the kernel and the plain version, or it raises): the float
    shift of ROADMAP C22 where the window's offsets are not 0."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    band, band_cols = calls[0][1]["band"], calls[0][1]["band_cols"]
    r0, c0 = -band[0], -(band_cols or (0, size))[0]
    res = {}
    for side, fn in (("kernel", bc.free_raster),
                     ("plain", bc.free_raster_plain)):
        win = torch.zeros_like(calls[0][0][0])
        whole = torch.zeros((size, size), device=win.device)
        c_win, c_whole = [], []
        for a, kw in calls:
            win, c = fn(win, *a[1:], **kw)
            c_win.append(c)
            whole, c = fn(whole, *a[1:], **dict(kw, band=None,
                                                band_cols=None))
            c_whole.append(c)
        torch.cuda.synchronize()
        res[side] = (win, whole, torch.stack(c_win), torch.stack(c_whole))
    (wk, ak, cwk, cak), (wp, ap, cwp, cap) = res["kernel"], res["plain"]
    n_win, n_whole = int((wk != wp).sum()), int((ak != ap).sum())
    core_k = wk[r0:r0 + size, c0:c0 + size]
    core_p = wp[r0:r0 + size, c0:c0 + size]
    shift_k, shift_p = core_k != ak, core_p != ap
    n_shift = int(shift_k.sum())
    print(f"{name}: one captured step's {len(calls)} fan(s) in the window "
          f"{band}, {band_cols}: kernel vs plain {n_win} of {wk.numel()} "
          f"cells differ (whole grid: {n_whole} of {ak.numel()}), counts "
          f"equal {torch.equal(cwk, cwp) and torch.equal(cak, cap)}; "
          f"window core vs whole grid: {n_shift} cells differ in the "
          f"kernel, {int(shift_p.sum())} in the plain version (same cells "
          f"{torch.equal(shift_k, shift_p)}), painted counts "
          f"{float(cwk.sum())} vs {float(cak.sum())}")
    if n_win or n_whole or not torch.equal(cwk, cwp) or \
            not torch.equal(cak, cap) or not torch.equal(shift_k, shift_p):
        raise AssertionError(f"{name}: the kernel and its plain version "
                             "differ at the sharded step's window")
    return n_shift


def phase_sharded_path(card, dev, grid_sharding: str):
    """The sharded engine at world size 1 on NCCL, at N_AGENTS agents on
    presets.deployable's world and config (f32 grid, ring on, merge every
    16; the body rasters pack16): the counters set to 0, one warm-up step
    and SHARDED_STEPS timed steps, the counters read: exactly one launch
    per step of the decomposition's form (`pack16-ring`, `-band` on "rows",
    `-tile` on "tiles") and no other, every step writes, merges > 0, all
    agents online, no band escape, poses finite; steps/s, peak memory.
    Then SPLIT_STEPS more steps split on the device timeline into
    sensing, raster, merge, zones, collectives and the rest, and on "rows"
    and "tiles" one more step whose raster inputs `_window_witness` runs
    again at the path's own window (kernel BIT-EQUAL to plain; the band
    (0, size) equal to the whole grid). Returns (launches, the global
    state after the timed steps, summary)."""
    from swarm_tpu_torch.engine.sim import total_writes_value
    from swarm_tpu_torch.parallel import sharded

    cfg, step, state, lay = _sharded_run(dev, grid_sharding)
    every = cfg.engine.merge_every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                          # the path starts here
    state, m0 = step(state)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SHARDED_STEPS + 1)]
    ms = []
    t0 = time.perf_counter()
    events[0].record()
    for k in range(SHARDED_STEPS):
        state, m = step(state)
        events[k + 1].record()
        ms.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_free, by_form, n_room = _read_counts()
    steps_run = SHARDED_STEPS + 1
    want = "pack16-ring" + {"replicated": "", "rows": "-band",
                            "tiles": "-tile"}[grid_sharding]
    name = f"sharded {grid_sharding}"
    writes = torch.stack([m0.writes] + [m.writes for m in ms]).cpu()
    online = torch.stack([m.online for m in ms]).cpu()
    merges = torch.stack([m0.merges] + [m.merges for m in ms]).cpu()
    escapes = torch.stack([m0.band_escapes] +
                          [m.band_escapes for m in ms]).cpu()
    if by_form != {want: steps_run} or n_free != steps_run or n_room:
        raise AssertionError(f"{name}: launches {by_form}, room {n_room} "
                             f"in {steps_run} steps")
    if not bool((writes > 0).all()):
        raise AssertionError(f"{name}: a step wrote no cells")
    if int(merges.sum()) <= 0 or not bool((online == N_AGENTS).all()):
        raise AssertionError(f"{name}: merges {merges.tolist()}, online "
                             f"{online.tolist()[:8]}")
    if int(escapes.sum()) or not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"{name}: band escapes {escapes.tolist()} or "
                             f"non-finite poses")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(events[k].elapsed_time(events[k + 1])
                     for k in range(SHARDED_STEPS))
    merge_steps = [k for k in range(steps_run) if k % every == every - 1]
    applied = int(writes.to(torch.int64).sum())
    print(f"{name} at {N_AGENTS} agents on one rank (NCCL) [{card}]: "
          f"{steps_run} steps, launches {by_form}, online {N_AGENTS} on "
          f"every timed step, min writes {int(writes.min())}, merges "
          f"{[int(merges[k]) for k in merge_steps]} at steps {merge_steps},"
          f" band escapes 0, poses finite; {SHARDED_STEPS / wall:.2f} "
          f"steps/s, {applied} applied cells, device step median "
          f"{step_ms[len(step_ms) // 2]:.4f} ms, peak memory {peak} bytes")
    full = sharded.gather_state(state, lay, grid_sharding)
    full = full._replace(srv=full.srv._replace(
        logodds=full.srv.logodds.clone()))
    state, split = _step_split(step, state, SPLIT_STEPS, _sharded_parts())
    print(f"{name} step split [{card}], device-timeline medians over "
          f"{SPLIT_STEPS} more steps (ms): " + ", ".join(
              f"{p} {t:.4f} (n={k})" for p, (t, k, _) in split.items()))
    summary = dict(steps_s=SHARDED_STEPS / wall, peak=peak,
                   writes=total_writes_value(full.srv.total_writes))
    if grid_sharding != "replicated":
        # the kernel at this path's own window, on one step's inputs
        state, calls = _captured_step(step, state)
        summary["shift_cells"] = _window_witness(name, calls,
                                                 cfg.grid.size)
        if grid_sharding == "rows" and summary["shift_cells"]:
            raise AssertionError("the band (0, size) differs from the "
                                 "whole grid")
        del calls
    return steps_run, full, summary


def phase_sharded(card, dev):
    """The sharded engine on one card: a one-rank NCCL group, the three
    decompositions (`phase_sharded_path`), "rows" held BIT-EQUAL to
    "replicated" (maps, writes, poses) and "tiles" compared with it
    (bit-equal, or the differing cells counted: poses equal, tri-state
    decisions differing in at most 1e-4 of the explored cells, applied
    cells within 1e-5; the float shift of ROADMAP C22); then every
    other band and tile form through the sharded body's flag rows
    (BAND_ROWS), SHARDED_FLAG_STEPS steps each, exactly its form launched
    once per step. Returns {form key: launches}."""
    from datetime import timedelta

    import torch.distributed as dist

    from swarm_tpu_torch.config import GridConfig
    from swarm_tpu_torch.ops.raster import tri_state_view
    from swarm_tpu_torch.parallel import mesh

    port = mesh.free_port()
    mesh.init(f"tcp://127.0.0.1:{port}", 1, 0,
              timedelta(seconds=SHARDED_TIMEOUT_S), device=dev)
    print(f"process group: {dist.get_backend()}, world size "
          f"{dist.get_world_size()}")
    if dist.get_backend() != "nccl":
        raise AssertionError("the card's process group is not NCCL")
    try:
        launches, full, summary = {}, {}, {}
        for gs in ("replicated", "rows", "tiles"):
            n, full[gs], summary[gs] = phase_sharded_path(card, dev, gs)
            if gs != "replicated":
                launches[f"pack16-ring-{'band' if gs == 'rows' else 'tile'}"
                         ] = n
            torch.cuda.empty_cache()
        ref = full["replicated"]
        for gs in ("rows", "tiles"):
            got = full[gs]
            n_diff = int((got.srv.logodds != ref.srv.logodds).sum())
            same_poses = torch.equal(got.pose_true, ref.pose_true)
            same_writes = torch.equal(got.srv.total_writes,
                                      ref.srv.total_writes)
            print(f"sharded {gs} vs replicated after "
                  f"{SHARDED_STEPS + 1} steps: {n_diff} of "
                  f"{ref.srv.logodds.numel()} cells differ, writes equal "
                  f"{same_writes}, poses equal {same_poses}")
            if gs == "rows" and (n_diff or not same_poses or
                                 not same_writes):
                raise AssertionError("sharded rows is not bit-equal to "
                                     "replicated")
            if gs == "tiles" and n_diff:
                # the float shift (ROADMAP C22), which the captured step
                # shows in the plain version as in the kernel: a few cells
                # on carve and ring edges, far below these bars
                cfg_g = GridConfig(size=ref.srv.logodds.shape[0])
                t_g = tri_state_view(got.srv.logodds, cfg_g)
                t_r = tri_state_view(ref.srv.logodds, cfg_g)
                explored = (t_g != cfg_g.unknown) | (t_r != cfg_g.unknown)
                n_dec = int((t_g != t_r).sum())
                n_exp = max(int(explored.sum()), 1)
                w_g, w_r = summary["tiles"]["writes"], \
                    summary["replicated"]["writes"]
                print(f"sharded tiles vs replicated: {n_dec} tri-state "
                      f"decisions differ of {n_exp} explored cells "
                      f"({n_dec / n_exp:.3e}), applied cells {w_g} vs "
                      f"{w_r} ({abs(w_g - w_r) / w_r:.3e}); the captured "
                      f"step's shift: {summary['tiles']['shift_cells']} "
                      f"cells")
                if n_dec > 1e-4 * n_exp or abs(w_g - w_r) > 1e-5 * w_r or \
                        not same_poses:
                    raise AssertionError("sharded tiles diverges from "
                                         "replicated")
        del full, ref
        for form, flags in BAND_ROWS.items():
            for gs, kind in (("rows", "band"), ("tiles", "tile")):
                key = f"{form}-{kind}"
                if key in launches:
                    continue
                launches[key] = _sharded_flag_row(card, dev, gs, key, flags)
    finally:
        dist.destroy_process_group()
    return launches


def _sharded_flag_row(card, dev, grid_sharding, key, flags):
    """SHARDED_FLAG_STEPS sharded steps on one rank with bench.py flags
    `flags`: exactly the form `key` launched once per step, every step
    writes, no band escape, poses finite. Returns its launches."""
    _, step, state, _ = _sharded_run(dev, grid_sharding, flags)
    torch.cuda.synchronize()
    _reset_counts()                          # this path starts here
    ms = []
    for _ in range(SHARDED_FLAG_STEPS):
        state, m = step(state)
        ms.append(m)
    torch.cuda.synchronize()
    n_free, by_form, n_room = _read_counts()
    writes = torch.stack([m.writes for m in ms]).cpu()
    esc = int(torch.stack([m.band_escapes for m in ms]).sum())
    print(f"sharded {grid_sharding} flags [{_flags(flags)}] at {N_AGENTS} "
          f"agents [{card}]: launches {by_form}, room {n_room}, min writes "
          f"{int(writes.min())}, band escapes {esc}")
    if by_form != {key: SHARDED_FLAG_STEPS} or n_room or esc or \
            not bool((writes > 0).all()) or \
            not bool(torch.isfinite(state.pose_true).all()):
        raise AssertionError(f"sharded {grid_sharding} [{_flags(flags)}]: "
                             f"launches {by_form}")
    return by_form[key]


def phase_dryrun(card):
    """parallel/dryrun.py at world size 1 on the card, as its own process
    (`python -m swarm_tpu_torch.parallel.dryrun`): two steps in each
    decomposition, rows bit-equal to replicated."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "swarm_tpu_torch.parallel.dryrun",
         "--timeout", "300"], cwd=here, capture_output=True, text=True,
        timeout=600)
    print(out.stdout.strip())
    if out.returncode != 0 or "dryrun ok (1 ranks)" not in out.stdout:
        raise AssertionError(f"parallel/dryrun.py failed:\n"
                             f"{out.stderr[-3000:]}")
    print(f"parallel/dryrun.py on the card [{card}]: "
          f"{time.perf_counter() - t0:.2f} s")

def run(card, dev) -> list:
    """Every phase after the build, in order; returns the per-kernel
    records of the JSON line."""
    k_window = phase_window_kernel(card, dev)
    k_forms = phase_form_kernels(card, dev)
    k_room = {"pack16-ring": phase_room_kernel(card, dev)}
    for i, flags in enumerate(ROOM_ROWS):
        k_room[_form_of(flags)[-1]] = phase_room_kernel(card, dev, flags,
                                                        SEED + 20 + i)
    k_slice = phase_slice_kernel(card, dev)
    n_slice = phase_slice(card, dev)
    paths = {}
    n_window, (_, _, state, _), summary = phase_path(card, dev,
                                                     room_kernel=False)
    paths[("window", "per-beam")] = phase_path_split(card, "window", state,
                                                     summary)
    del state, summary           # the room path's peak is its own (C19)
    n_room, (cfg, rooms, state, m), summary = phase_path(card, dev,
                                                         room_kernel=True)
    phase_merge(card, dev, cfg, rooms, state, m)
    paths[("room", "per-beam")] = phase_path_split(card, "room", state,
                                                   summary)
    del cfg, rooms, state, m, summary
    n_explore = phase_explore(card, dev)
    n_ultrasonic = phase_ultrasonic(card, dev)
    phase_coverage_tool(card, dev)
    phase_entry_points(card, dev)
    n_flags = phase_flag_paths(card, dev)
    phase_bf16_vs_f32(card, dev)
    phase_reference(dev, "window")
    phase_reference(dev, "room", room_kernel=True)
    phase_reference(dev, "window bf16", 17, equal_merges=True,
                    grid_dtype="bfloat16")
    phase_reference_explore(dev)

    # the grouped tier (bench.py --beam-groups N) and the exact raster
    k_grouped, k_grouped_room = phase_grouped_kernels(card, dev)
    k_exact = phase_exact_kernel(card, dev)
    n_exact = phase_exact_entry(card, dev)
    n_grouped = {}
    for kernel_name, room_kernel in (("window", False), ("room", True)):
        n_grouped[kernel_name], (_, _, state, _), summary = phase_path(
            card, dev, room_kernel=room_kernel, beam_groups=8)
        paths[(kernel_name, "grouped")] = phase_path_split(
            card, f"{kernel_name} --beam-groups 8", state, summary)
        del state, summary
    _compare_paths(card, paths)
    n_gflags = phase_grouped_flag_paths(card, dev)
    phase_reference(dev, "window --beam-groups 8", beam_groups=8)
    phase_reference(dev, "room --beam-groups 8", room_kernel=True,
                    beam_groups=8)

    # the sharded engine: the band and tile forms, the three
    # decompositions on a one-rank NCCL group, the dry run
    k_band = phase_band_kernels(card, dev)
    n_band = phase_sharded(card, dev)
    phase_dryrun(card)

    def kernel(name, form, launches, res):
        src, line = {"room_raster": ("room_raster.cu", 672),
                     "exact_raster": ("exact_raster.cu", 235)}.get(
                         name, ("free_raster.cu", 305))
        return {"name": f"{name}[{form}]", "route": "cuda",
                "source": f"swarm_tpu_torch/csrc/{src}",
                "replaces": f"swarm_tpu/ops/beam_raster_pallas.py:{line}",
                "launches": launches, **res, "library_ms": None}

    slice_res = dict(k_slice["pack8-ring-bf16"], max_abs_err=max(
        k_slice["pack8-ring-bf16"]["max_abs_err"],
        k_forms["pack8-ring-bf16"]["max_abs_err"]))
    kernels = [
        kernel("free_raster", "pack8-ring", n_window,
               k_window["pack8-ring"]),
        kernel("free_raster", "pack16", n_explore["pack16"],
               k_forms["pack16"]),
        kernel("free_raster", "pack16-wrapped", n_explore["pack16-wrapped"],
               k_forms["pack16-wrapped"]),
        kernel("free_raster", "pack8-ring-wrapped",
               n_ultrasonic["pack8-ring-wrapped"],
               k_forms["pack8-ring-wrapped"]),
        kernel("free_raster", "pack8-ring-bf16", n_slice, slice_res)]
    kernels += [kernel("free_raster", key, n, k_forms[key])
                for (which, key), n in n_flags.items() if which == "window"]
    kernels.append(kernel("room_raster", "pack16-ring", n_room,
                          k_room["pack16-ring"]))
    kernels += [kernel("room_raster", key, n, k_room[key])
                for (which, key), n in n_flags.items() if which == "room"]
    kernels.append(kernel("free_raster", "grouped-ring", n_grouped["window"],
                          k_grouped["grouped-ring"]))
    kernels += [kernel("free_raster", key, n, k_grouped[key])
                for (which, key), n in n_gflags.items() if which == "window"]
    kernels.append(kernel("room_raster", "grouped-ring", n_grouped["room"],
                          k_grouped_room["grouped-ring"]))
    kernels += [kernel("room_raster", key, n, k_grouped_room[key])
                for (which, key), n in n_gflags.items() if which == "room"]
    kernels += [kernel("exact_raster", fan, n_exact[fan], k_exact[fan])
                for fan in ("scan", "wrapped")]
    kernels += [kernel("free_raster", key, n_band[key], k_band[key])
                for key in k_band]
    names = {k["name"] for k in kernels}
    if len(names) != len(kernels) or \
            len(kernels) != 16 + 4 + 8 + 4 + 2 + 2 * len(BAND_FORMS):
        raise AssertionError(f"kernel records: {sorted(names)}")
    return kernels


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
    kernels = run(card, dev)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
