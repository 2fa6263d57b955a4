"""Per-component step profile of the port: where the fused step's time goes
at swarm scale (tools/profile_step.py on the card), and the device-timeline
step split that chip_smoke.py prints for every path.

    python -m swarm_tpu_torch.profile_step [--agents 1024] [--inner 128]
        [--reps 3] [--device cuda]

Each component of the deployable step (`presets.deployable(--agents)`
with `raster_4way=False`: the sweep alone rastered, per beam) is called
alone on the initial state's inputs, `--inner` times a round, and timed
two ways, each the best of `--reps` rounds:
  * device: CUDA events around the round's back-to-back calls, per call
    (the device timeline, host gaps included where the host is behind);
  * host: the host clock around the round with `torch.cuda.synchronize()`
    after every call, per call (what one call costs the caller).
At 1024 agents the host's launches set the step (PERF.md section 5), so
either number alone would mislead. On the CPU only the host column is
measured ("not measured" in the device column). The rows follow the
tool's; where the port has no such mechanism a row times what the port
does instead: "rng fold_in x3" is `draw_step_noise` (one step's draws
from a generator), the two "(retired)" rows are the per-robot EKF's
`ekf_predict` / `ekf_update` on a leading [N] axis and
`coord/zones.zone_observe_batch`. The raster rows run the window kernel
per beam with the configuration's table (pack8) and with 8 groups, and the
room kernel per beam (its pack16 table), each with the endpoint ring, on
the grid in place. FULL sim_step is one step of `make_sim_step`.

After the rows, on the card, SPLIT_STEPS more steps of the full step split
on the device timeline by the step's own spans (`step_split`: sensing,
raster, merge, zones, closure, V2V, rest); `sharded_parts` are the sharded
step's parts for the same split, timed by wrapping the functions it calls
by name. Then the launches of LAUNCH_STEPS more steps (`step_launches`): the
torch operations the steps dispatch (on any device) and the raster
kernels they launch, and on the card the device operations (kernels,
copies, fills) torch.profiler records.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from swarm_tpu_torch import trace
from swarm_tpu_torch._device import default_device, describe

SPLIT_STEPS = 17         # one merge step (step 15) among them
LAUNCH_STEPS = 4         # steps whose launches are counted
SEED = 0


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


# the fused step's parts for `step_split`: part -> the engine's span
# (swarm_tpu_torch/trace.py); "merge" sums the merge event and the anchor
# freeze, each a `swarm.merge` span
SIM_SPANS = {"sensing": "swarm.sensing", "raster": "swarm.raster",
             "merge": "swarm.merge", "zones": "swarm.zones",
             "closure": "swarm.closure", "v2v": "swarm.v2v"}


def sharded_parts():
    """The sharded step's parts for `step_split`: part -> (module, name)
    pairs of the functions the sharded engine calls by name, wrapped with
    CUDA events (that engine opens no spans yet; once it does, its split
    reads them as the fused step's does)."""
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


def step_split(step, state, n_steps: int, parts=None):
    """n_steps more steps split on the device timeline. With `parts` None,
    the fused step's own spans (`swarm_tpu_torch.trace`, `SIM_SPANS`):
    sensing (`sense_4way`, `sense_scan`), raster (the beam rasters of
    `_raster_fans` with their preparation and any endpoint scatter, the XLA
    tier, or the line or parity raster), merge (the merge event and the
    anchor freeze, on merge steps), zones (the zone snapshot, every 2 s of
    simulated time), closure (the landmark match, batched or sequential)
    and v2v (the pairwise radio statistics), each the device time between
    its span's CUDA events, and the step's own (`swarm.step`); no peak is
    read. With `parts` (part -> (module, name) pairs, `sharded_parts()`),
    CUDA events around each named function, with the allocator's peak
    while it ran. Returns (state, split): per part (device-timeline
    median ms over the steps that ran it, their count, the most device
    memory allocated while it ran or None); for the step and its rest (the
    step less its parts), medians over the steps with neither a merge nor
    a zone snapshot. Needs the card."""
    if parts is not None:
        return _wrapped_split(step, state, n_steps, parts)
    with trace.recording():
        for _ in range(n_steps):
            state, _ = step(state)
    spans = trace.take().spans
    part_of = {name: part for part, name in SIM_SPANS.items()}
    rows = {}
    for s in spans:
        if s.name == trace.STEP:
            rows[s.step] = {"step": s.device_ms}
    for s in spans:
        part = part_of.get(s.name)
        if part is not None and s.step in rows:
            row = rows[s.step]
            row[part] = row.get(part, 0.0) + s.device_ms
    return state, _split(list(rows.values()), SIM_SPANS,
                         dict.fromkeys(SIM_SPANS))


def _split(rows, parts, peaks):
    for row in rows:
        row["rest"] = row["step"] - sum(row.get(p, 0.0) for p in parts)
    split = {p: (median([r[p] for r in rows if p in r]),
                 sum(p in r for r in rows), peaks[p]) for p in parts}
    plain = [r for r in rows if "merge" not in r and "zones" not in r]
    for p in ("step", "rest"):
        split[p] = (median([r[p] for r in plain]), len(plain), None)
    return split


def _wrapped_split(step, state, n_steps: int, parts):
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
        rows.append(row)
    return state, _split(rows, parts, peaks)


def step_launches(step, state, n_steps: int):
    """(state, launches) over n_steps more steps of `step`: "ops", the
    torch operations dispatched (each a launch or a few on the card, none
    for a view); "raster", the window and room kernels' launches (their
    wrappers' counts); on the card "device", the kernels, copies and fills
    torch.profiler records (it can drop records under load), else None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def raster():
        return free_raster.launches + room_raster.launches

    r0, count = raster(), Count()
    with count:
        for _ in range(n_steps):
            state, _ = step(state)
    r1, device = raster(), None
    if state.pose_true.device.type == "cuda":
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                state, _ = step(state)
            torch.cuda.synchronize()
        device = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    return state, {"steps": n_steps, "ops": count.n,
                   "raster": r1 - r0,
                   "device": device}


def time_call(fn, inner: int, reps: int, dev):
    """(device ms a call or None off the card, host ms a call): the best
    of `reps` rounds of `inner` calls each, after one warm call."""
    fn()
    best_dev = best_host = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            torch.cuda.synchronize(dev)
            best_dev = min(best_dev, a.elapsed_time(b) / inner)
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        best_host = min(best_host, (time.perf_counter() - t0) / inner * 1e3)
    return (best_dev if dev.type == "cuda" else None), best_host


def rows(cfg, walls, params, rooms, dev, gen):
    """[(name, fn)]: the tool's components on the deployable world's
    initial state, each a call that does its work once."""
    from swarm_tpu_torch.coord.zones import (zone_observe_batch,
                                             zone_observe_rows)
    from swarm_tpu_torch.engine import sim
    from swarm_tpu_torch.geom.world import cast_rays
    from swarm_tpu_torch.models import nav as navm
    from swarm_tpu_torch.models.ekf import (ekf_predict, ekf_step_batch,
                                            ekf_update)
    from swarm_tpu_torch.models.odometry import drift_integrate
    from swarm_tpu_torch.models.scan import scan_angles, sense_scan
    from swarm_tpu_torch.models.sensors import sense_4way, walls_for_rays
    from swarm_tpu_torch.ops.beam_raster import (BeamSpec, beams_from_scan,
                                                 endpoint_rays, reach_cells)
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.raster import logodds_delta
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster
    from swarm_tpu_torch.presets import tile_rooms_per_row
    from swarm_tpu_torch.slam.closure import closure_add_poses_batch

    n = cfg.n_agents
    state = sim.sim_init(cfg, params)
    walls_agent = rooms[0][rooms[1].long()]
    pose = state.pose_true
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    agents_ix = torch.arange(n, dtype=torch.int32, device=dev)
    zeros = torch.zeros((n,), device=dev)
    noise = sim.draw_step_noise(gen, n, 181, dev)
    out = [("rng fold_in x3 (per step): draw_step_noise",
            lambda: sim.draw_step_noise(gen, n, 181, dev)),
           ("sense_4way", lambda: sense_4way(noise.sense, pose, walls_agent,
                                             cfg.sensors)),
           ("sense_scan 181", lambda: sense_scan(noise.scan, pose,
                                                 walls_agent, 181,
                                                 cfg.sensors))]

    def proj():
        sd = torch.ones((n, 181), device=dev)
        sa = pose[:, 2:3] + scan_angles(181, pose.dtype, dev)[None, :]
        return pose[:, 0:1] + sd * torch.cos(sa), \
            pose[:, 1:2] + sd * torch.sin(sa)
    out.append(("scan projection trig", proj))

    lm = torch.zeros((n,), dtype=torch.int32, device=dev)
    lm[::7] = 2
    out.append((f"closure batch (L={cfg.slam.landmark_capacity})",
                lambda: closure_add_poses_batch(
                    state.srv.closure, pose[:, 0], pose[:, 1], agents_ix,
                    lm, cfg.slam, valid=alive)))
    navp = navm.NavParams(wall_side=params.wall_side,
                          motor_pwm=params.motor_pwm,
                          return_style=params.return_style,
                          home_x=params.home_x, home_y=params.home_y)
    zb = torch.zeros((n, 4), device=dev)
    hz = torch.zeros((n,), dtype=torch.bool, device=dev)
    dist4 = torch.full((n, 4), 1.0, device=dev)
    out.append(("nav_step", lambda: navm.nav_step(
        state.nav, navp, dist4, pose, zeros, zb, hz, 0.4, cfg.nav)))
    e = state.ekf
    w = e.x[:, 3] * 1e-9
    out.append(("ekf per-robot on [N] (retired): ekf_predict + ekf_update",
                lambda: ekf_update(ekf_predict(e, w, 1.0, cfg.ekf),
                                   torch.full((n,), 0.1, device=dev), w,
                                   cfg.ekf)))
    out.append(("ekf SoA batch (engine)", lambda: ekf_step_batch(
        e, w, torch.full((n,), 0.1, device=dev), e.last_t + 1.0, cfg.ekf)))
    drive = torch.full((n,), 0.07, device=dev)
    out.append(("drift+encoder", lambda: drift_integrate(
        noise.drift, state.odom, drive, zeros, params.trans_scale,
        params.yaw_bias_per_m, cfg.noise)))
    out.append(("v2v O(N^2): v2v_stats", lambda: sim.v2v_stats(
        pose[:, :2], alive, cfg.sensors.v2v_range_m)))
    x, y = pose[:, 0], pose[:, 1]
    rep = lambda v: torch.cat([v, v.repeat_interleave(4)])  # noqa: E731
    out.append(("zone fold scatter (retired): zone_observe_batch",
                lambda: zone_observe_batch(
                    state.srv.zone, rep(agents_ix), rep(x), rep(y),
                    torch.ones((5 * n,), dtype=torch.bool, device=dev))))
    xs = x[:, None].expand(n, 5).contiguous()
    ys = y[:, None].expand(n, 5).contiguous()
    out.append(("zone fold rows (engine)", lambda: zone_observe_rows(
        state.srv.zone, xs, ys, torch.ones((n, 5), dtype=torch.bool,
                                           device=dev))))
    out.append(("collision cast", lambda: cast_rays(
        pose[:, None, :2], pose[:, 2:3], walls_for_rays(walls_agent))))

    spec = BeamSpec.scan(181)
    reach = reach_cells(cfg)
    db, tb = beams_from_scan(torch.full((n, 181), 1.0, device=dev),
                             cfg.sensors.max_range, cfg.sensors.min_range)
    xy, yaw = pose[:, :2].contiguous(), pose[:, 2].contiguous()
    lo = state.srv.logodds
    out.append(("raster window kernel groups=8", lambda: free_raster(
        lo, xy, yaw, db, alive, tb, spec, cfg.grid, reach=reach,
        n_groups=8, tail_weight=cfg.engine.beam_tail_weight)))
    out.append(("raster window kernel per-beam", lambda: free_raster(
        lo, xy, yaw, db, alive, tb, spec, cfg.grid, reach=reach,
        pack8=cfg.engine.beam_pack8)))
    out.append(("raster room kernel per-beam", lambda: room_raster(
        lo, xy, yaw, db, alive, spec, cfg.grid, n_groups=181,
        per_row=tile_rooms_per_row(n), trusted=tb, reach=reach)))
    out.append(("endpoint scatter 181/agent", lambda: logodds_delta(
        endpoint_rays(xy, yaw, db, tb, alive, spec), cfg.grid, k_max=1)))

    step = sim.make_sim_step(cfg, walls, params, gen,
                             walls_grouped=rooms[0], room_of_agent=rooms[1])
    full = {"state": state}

    def full_step():
        full["state"], _ = step(full["state"])
    out.append(("FULL sim_step", full_step))
    return out, step, full


def main(argv=None):
    from swarm_tpu_torch import presets

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--inner", type=int, default=128,
                    help="calls per timed round")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    cfg, walls, params, rooms = presets.deployable(args.agents, device=dev)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 raster_4way=False))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    platform, device_name = describe(dev)
    print(f"platform={platform} device={device_name} agents={args.agents} "
          f"grid={cfg.grid.size} "
          f"inner={args.inner}")
    print(f"{'component':52s} {'device ms':>10s} {'host ms':>10s}")
    table, step, full = rows(cfg, walls, params, rooms, dev, gen)
    out = {}
    for row, fn in table:
        t_dev, t_host = time_call(fn, args.inner, args.reps, dev)
        out[row] = {"device_ms": t_dev, "host_ms": t_host}
        shown = "not measured" if t_dev is None else f"{t_dev:10.3f}"
        print(f"{row:52s} {shown:>10s} {t_host:10.3f}", flush=True)
    split = None
    if dev.type == "cuda":
        _, split = step_split(step, full["state"], SPLIT_STEPS)
        print(f"step split over {SPLIT_STEPS} steps (device-timeline "
              f"medians, ms; steps that ran the part): " + ", ".join(
                  f"{p} {v[0]:.3f} ({v[1]})" for p, v in split.items()))
    else:
        print("step split: not measured (the device timeline needs the "
              "card)")
    full["state"], launches = step_launches(step, full["state"],
                                            LAUNCH_STEPS)
    print(f"launches over {LAUNCH_STEPS} steps: {launches['ops']} torch "
          f"ops dispatched, {launches['raster']} raster kernels, device "
          f"operations "
          + ("not measured" if launches["device"] is None
             else str(launches["device"])))
    return {"rows": out, "split": split, "launches": launches,
            "device": device_name}


if __name__ == "__main__":
    main()
