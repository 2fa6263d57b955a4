"""Headline benchmark of the port: grid-cell updates per second of the
fused swarm engine (bench.py on the card).

    python -m swarm_tpu_torch.bench [--agents 1024] [--steps 200]
        [--chunks 2] [--device cuda] [bench.py's raster flags]
    python -m swarm_tpu_torch.bench --device cpu --agents 16 --steps 5 \\
        --chunks 2                  # the plain rasters, the XLA tier

Runs the closed-loop step (sense -> nav FSM -> EKF -> odometry drift ->
occupancy raster -> loop closure -> zones -> heartbeat, with the anchored
scan merge every `--merge-every` steps when there is a sweep) and prints
ONE JSON line with bench.py's keys, plus `device` (the card's name) beside
`platform` ("gpu" or "cpu").

The configuration is bench.py's, flag by flag (:105-128; `configure`):
`presets.deployable` with the raster flags; `--raster line` or
`--no-pallas` the untiled world of `presets.untiled` (the line raster, or
both beam fans through the XLA tier). `--device cpu` implies
`--no-pallas`, as bench.py's `--platform cpu` does: the kernels run on the
card only.

The timed window: one untimed warm chunk, then `--chunks` chunks of
`--steps` steps through `engine.sim.sim_rollout`, each chunk ending in one
host read of its int64 write sum and its merge count; the host clock, with
`torch.cuda.synchronize()` at both ends. The headline counts what the
raster applied: the kernels' in-kernel applied counter; `--raster line`
counts the scatter's writes, and `--no-pallas` the XLA tier's cells, which
are not the kernels' applied count (ROADMAP C18: `writes_semantics`).

The counter reconciliation (bench.py:160-221), on a fresh map, with a
step of its own (`make_sim_step`, noise from a generator seeded
RATIO_SEED): per step the evidence the map shows, sum max(-d, 0) / |miss|
+ sum max(d, 0) / hit over the grid's change d, against the step's write
count (`step_evidence`), averaged over 3-step windows at map ages 2, 35
and 128 steps (`ratio_curve`). The rasters update the grid IN PLACE, so
the grid is cloned before each step. The run fails unless the age-2 ratio
exceeds RATIO_FLOOR.

The merge probe (bench.py:222-287): `slam.livemerge.scan_merge` on the
timed run's final map, for a sweep sensed from its final true poses, at
min(N, 1024) agents (`merge_latency_full_batch_ms`) and at
`slam.merge_chunk` agents (`merge_event_ms`, and per step
`merge_cost_per_step_ms`); the median of MERGE_REPS calls after one warm
call, CUDA events on the card (the host clock on the CPU). A failing probe
fails the run: there is no fallback.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from swarm_tpu_torch._device import default_device, describe

BASELINE_CELL_UPDATES_PER_S = 5.8e4
RATIO_FLOOR = 0.6
RATIO_SEED = 1           # the reconciliation's noise, apart from the run's
RUN_SEED = 0
MERGE_SEED = 2           # the merge probe's sweep noise
MERGE_REPS = 5
# the reconciliation's steps: 2 to age the map, 3 a window, 30 between
# the first two windows, 90 between the last two
RATIO_STEPS = 2 + 3 + 30 + 3 + 90 + 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200, help="steps per chunk")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card); cpu runs the "
                         "plain rasters and implies --no-pallas")
    ap.add_argument("--scan-rays", type=int, default=181,
                    help="servo-scan beams per agent per step (0 = 4-way "
                         "ultrasonics only)")
    ap.add_argument("--raster", default="beam", choices=["line", "beam"],
                    help="line = per-ray line scatter; beam = polar "
                         "inverse sensor model (the raster kernels)")
    ap.add_argument("--no-pallas", action="store_true",
                    help="beam mode through the XLA tier (torch ops)")
    ap.add_argument("--pack8", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="per-beam range table as 8-bit quads at a "
                         "1/4-cell step; --no-pack8: the 16-bit table")
    ap.add_argument("--exact-endpoints", action="store_true",
                    help="endpoint hits via the exact sparse scatter "
                         "instead of in-kernel ring painting")
    ap.add_argument("--beam-groups", type=int, default=0,
                    help="0 = per-beam carve; > 0 = the grouped tier")
    ap.add_argument("--room-kernel", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="the room-tile raster kernel instead of the "
                         "per-agent window kernel")
    ap.add_argument("--frontiers", action="store_true",
                    help="frontier detection + greedy target assignment "
                         "at the reference's 3 s cadence")
    ap.add_argument("--grid-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="log-odds grid storage dtype")
    ap.add_argument("--merge-every", type=int, default=16,
                    help="in-engine scan-merge cadence in steps; 0 = off")
    return ap.parse_args(argv)


def configure(args):
    """bench.py's configuration of `args` (:105-128): (cfg, walls, params,
    rooms, use_pallas), tensors on the device of `args.device`. On the
    CPU `args.no_pallas` is set, as bench.py's `--platform cpu` sets it."""
    dev = default_device(args.device)
    if dev.type == "cpu":
        args.no_pallas = True
    return world(args, dev)


def world(args, dev):
    """The world and configuration of `args`' flags on `dev`, whatever
    the device (`configure` without the CPU's `--no-pallas`)."""
    from swarm_tpu_torch import presets

    use_pallas = args.raster == "beam" and not args.no_pallas
    if use_pallas:
        w = presets.deployable(
            args.agents, device=dev, merge_every=args.merge_every,
            room_kernel=args.room_kernel, frontiers=args.frontiers,
            scan_rays=args.scan_rays, pack8=args.pack8,
            exact_endpoints=args.exact_endpoints, grid_dtype=args.grid_dtype,
            beam_groups=args.beam_groups)
    else:
        w = presets.untiled(
            args.agents, raster_mode=args.raster, scan_rays=args.scan_rays,
            frontiers=args.frontiers, merge_every=args.merge_every,
            grid_dtype=args.grid_dtype, device=dev)
    return (*w, use_pallas)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_evidence(step, state, grid_cfg):
    """One call of `step` (state -> (state, metrics)) from `state`:
    (the next state, the evidence the map shows in unit updates, the
    step's write count). The grid is cloned first, since the rasters update
    it in place; the change is taken in float32 (exact on a bf16 grid)."""
    lo0 = state.srv.logodds.clone()
    state, m = step(state)
    d = state.srv.logodds.float() - lo0.float()
    neg, pos = torch.stack([torch.clamp_min(-d, 0.0).sum(),
                            torch.clamp_min(d, 0.0).sum()]).tolist()
    applied = neg / abs(grid_cfg.logodds_miss) + pos / grid_cfg.logodds_hit
    return state, applied, int(m.writes)


def ratio_window(step, state, grid_cfg, k: int = 3):
    """The mean over k steps of evidence / writes (bench.py:182-191)."""
    rs = []
    for _ in range(k):
        state, applied, writes = step_evidence(step, state, grid_cfg)
        rs.append(applied / max(writes, 1))
    return state, sum(rs) / len(rs)


def ratio_curve(step, state, grid_cfg) -> dict:
    """The ratio in 3-step windows at map ages 2, 35 and 128 steps
    (bench.py:193-209), from a fresh `state`; RATIO_STEPS steps."""
    for _ in range(2):
        state, _ = step(state)
    curve = {}
    state, curve["step2"] = ratio_window(step, state, grid_cfg)
    for _ in range(30):
        state, _ = step(state)
    state, curve["step35"] = ratio_window(step, state, grid_cfg)
    for _ in range(90):
        state, _ = step(state)
    _, curve["step128"] = ratio_window(step, state, grid_cfg)
    return curve


def _median_call_ms(fn, dev, reps: int) -> float:
    """The median time of `reps` calls of fn after one warm call: CUDA
    events on the card, the host clock around a synchronised call on the
    CPU."""
    fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def merge_probe(cfg, state, rooms, dev):
    """(merge_latency_full_batch_ms at min(N, 1024) agents, that batch,
    merge_event_ms at slam.merge_chunk agents, that chunk):
    `scan_merge` of the first agents' sweeps, sensed from `state`'s true
    poses, against `state`'s map."""
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise
    from swarm_tpu_torch.slam.livemerge import scan_merge

    n = cfg.n_agents
    mla = min(n, 1024)
    chunk_n = min(cfg.slam.merge_chunk, n)
    rays = cfg.engine.scan_rays
    gen = torch.Generator(device=dev).manual_seed(MERGE_SEED)
    walls_agent = rooms[0][rooms[1][:mla].long()]
    scan = sense_scan(draw_sensor_noise(gen, (mla, rays), dev),
                      state.pose_true[:mla], walls_agent, rays, cfg.sensors)
    odom = state.odom

    def probe(m):
        alive = torch.ones((m,), dtype=torch.bool, device=dev)
        return lambda: scan_merge(state.srv.logodds, odom.x_est[:m],
                                  odom.y_est[:m], odom.yaw_est[:m],
                                  scan[:m], alive, cfg)

    latency = _median_call_ms(probe(mla), dev, MERGE_REPS)
    event = (latency if chunk_n == mla
             else _median_call_ms(probe(chunk_n), dev, MERGE_REPS))
    return latency, mla, event, chunk_n


def run(args) -> dict:
    """The benchmark of parsed `args`; returns the JSON record."""
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init, \
        sim_rollout

    dev = default_device(args.device)
    cfg, walls, params, rooms, use_pallas = configure(args)
    kw = dict(enable_targets=args.frontiers, walls_grouped=rooms[0],
              room_of_agent=rooms[1])
    gen = torch.Generator(device=dev).manual_seed(RUN_SEED)

    def chunk(state):
        state, ms = sim_rollout(state, args.steps, cfg, walls, params, gen,
                                **kw)
        w, nm = torch.stack([ms.writes.to(torch.int64).sum(),
                             ms.merges.to(torch.int64).sum()]).tolist()
        return state, w, nm

    state, _, _ = chunk(sim_init(cfg, params))          # warm
    _sync(dev)
    t0 = time.perf_counter()
    total_writes = total_merges = 0
    for _ in range(args.chunks):
        state, w, nm = chunk(state)                    # one host read
        total_writes += w
        total_merges += nm
    _sync(dev)
    dt = time.perf_counter() - t0
    steps = args.steps * args.chunks
    value = total_writes / dt

    ratio_gen = torch.Generator(device=dev).manual_seed(RATIO_SEED)
    single = make_sim_step(cfg, walls, params, ratio_gen, **kw)
    curve = ratio_curve(single, sim_init(cfg, params), cfg.grid)
    applied_ratio = curve["step2"]
    curve = {k: round(v, 4) for k, v in curve.items()}
    # bench.py:210-221: a fresh-window ratio this low cannot be clamp
    # saturation; the counter stopped tracking map-observable evidence
    if not applied_ratio > RATIO_FLOOR:
        raise AssertionError(f"fresh applied-counter ratio "
                             f"{applied_ratio:.3f} <= {RATIO_FLOOR}")

    latency = event = mla = chunk_n = cost = None
    if cfg.engine.merge_every > 0:
        latency, mla, event, chunk_n = merge_probe(cfg, state, rooms, dev)
        cost = event / cfg.engine.merge_every
    per_beam = args.beam_groups <= 0
    platform, device_name = describe(dev)
    return {
        "metric": "grid_cell_updates_per_s",
        "value": value,
        "unit": "cells/s",
        "vs_baseline": value / BASELINE_CELL_UPDATES_PER_S,
        "detail": {
            "agents": args.agents,
            "steps": steps,
            "elapsed_s": round(dt, 3),
            "steps_per_s": round(steps / dt, 2),
            "agent_steps_per_s": round(steps * args.agents / dt, 1),
            "writes_per_step": round(total_writes / max(steps, 1), 1),
            "grid": cfg.grid.size,
            "grid_dtype": cfg.grid.logodds_dtype,
            "platform": platform,
            "device": device_name,
            "raster": args.raster,
            "scan_rays": args.scan_rays,
            "beam_groups": args.beam_groups,
            "carve": (("per_beam_exact_pack8" if args.pack8 and use_pallas
                       else "per_beam_exact") if per_beam
                      else "group_min_turbo"),
            "pack8": args.pack8,
            "frontiers": args.frontiers,
            "room_kernel": bool(args.room_kernel and use_pallas),
            "writes_semantics": (
                "scatter" if args.raster == "line" else
                "in-kernel applied" if use_pallas else
                "xla-tier cells (ROADMAP C18)"),
            "delta_ratio_fresh": round(applied_ratio, 4),
            "delta_ratio_curve": curve,
            "writes_applied_per_s": round(value, 1),
            "merge_every": cfg.engine.merge_every,
            "merges_total": total_merges,
            "merge_latency_full_batch_ms": (
                None if latency is None else round(latency, 3)),
            "merge_latency_batch": mla,
            "merge_event_chunk": chunk_n,
            "merge_event_ms": None if event is None else round(event, 3),
            "merge_cost_per_step_ms": (
                None if cost is None else round(cost, 4)),
        },
    }


def main(argv=None):
    out = run(parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
