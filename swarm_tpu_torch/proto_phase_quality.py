"""Does phase-rotated group carving close the grouped tier's gap to the
exact per-beam model? (tools/proto_phase_quality.py on the port.)

    python -m swarm_tpu_torch.proto_phase_quality [--rays 61] [--groups 8]
        [--steps 120] [--agents 4] [--seed 42] [--tail 0.25]
        [--device cuda]

Accumulates maps over a random walk in the bedroom world (BEDROOM_WALLS,
a 256^2 grid at origin (-3, -4)) with three rasters of the same sweeps:
  exact  — `beam_raster_reference` (per-beam free + endpoint);
  static — `free_raster_reference` (group minimum + weak tail) plus the
           exact endpoint delta, clipped;
  rot    — the same with the groups rotated by `phase = step % per`
and reports each fast tier's quality against the exact map
(`quality_onchip.map_quality`): free-space IoU, wall p90, the occupied
counts and the FREE cells of one map only. The XLA tiers only (torch ops,
no kernel), on `--device`. The walk's draws come from a torch generator
seeded `--seed` on the device: the agents start uniform in [-1.5, 1.0) m
facing 0, turn by U(-0.4, 0.4) rad a step and advance min(U(0, 0.12),
max(the middle beam's range - 0.3, 0)) m, clipped to [-2.3, 1.8] m.
Prints the tool's lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from swarm_tpu_torch._device import default_device, describe


def _uniform(gen, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)


def main(argv=None):
    from swarm_tpu_torch.config import GridConfig, SensorConfig
    from swarm_tpu_torch.geom.world import BEDROOM_WALLS
    from swarm_tpu_torch.models.scan import sense_scan
    from swarm_tpu_torch.models.sensors import draw_sensor_noise
    from swarm_tpu_torch.ops.beam_raster import (BeamSpec,
                                                 beam_raster_reference,
                                                 beams_from_scan,
                                                 endpoint_rays,
                                                 free_raster_reference)
    from swarm_tpu_torch.ops.raster import logodds_delta, tri_state_view
    from swarm_tpu_torch.quality_onchip import map_quality

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=61)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tail", type=float, default=0.25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    grid = GridConfig(size=256, origin_x=-3.0, origin_y=-4.0)
    sens = SensorConfig()
    walls = torch.tensor(BEDROOM_WALLS, device=dev)
    spec = BeamSpec.scan(args.rays)
    per = -(-args.rays // args.groups)
    reach = int(np.ceil(sens.max_range / grid.resolution)) + 2
    c = grid.logodds_clamp

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.agents
    pos = _uniform(gen, (n, 2), -1.5, 1.0, dev)
    yaw = torch.zeros((n,), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    lo_exact = torch.zeros((grid.size, grid.size), device=dev)
    lo_static = torch.zeros_like(lo_exact)
    lo_rot = torch.zeros_like(lo_exact)

    t0 = time.perf_counter()
    for s in range(args.steps):
        scan = sense_scan(draw_sensor_noise(gen, (n, args.rays), dev),
                          torch.cat([pos, yaw[:, None]], -1), walls,
                          args.rays, sens)
        db, tb = beams_from_scan(scan, sens.max_range, sens.min_range)
        beam_raster_reference(lo_exact, pos, yaw, db, tb, spec, grid,
                              reach=reach)
        ep, _ = logodds_delta(endpoint_rays(pos, yaw, db, tb, active, spec),
                              grid, k_max=1)
        free_raster_reference(lo_static, pos, yaw, db, active, spec, grid,
                              n_groups=args.groups, reach=reach,
                              tail_weight=args.tail)
        lo_static = torch.clamp(lo_static + ep, -c, c)
        free_raster_reference(lo_rot, pos, yaw, db, active, spec, grid,
                              n_groups=args.groups, reach=reach,
                              tail_weight=args.tail, phase=s % per)
        lo_rot = torch.clamp(lo_rot + ep, -c, c)
        # random walk: small forward step along a jittered heading
        yaw = yaw + _uniform(gen, yaw.shape, -0.4, 0.4, dev)
        d = torch.minimum(_uniform(gen, yaw.shape, 0.0, 0.12, dev),
                          torch.clamp_min(scan[:, args.rays // 2] - 0.3,
                                          0.0))
        pos = pos + d[:, None] * torch.stack([torch.cos(yaw),
                                              torch.sin(yaw)], -1)
        pos = torch.clamp(pos, -2.3, 1.8)
    tri_e = tri_state_view(lo_exact, grid).cpu().numpy()
    platform, device_name = describe(dev)
    out = {"rays": args.rays, "groups": args.groups, "per": per,
           "steps": args.steps, "agents": n, "platform": platform,
           "device": device_name, "tiers": {}}
    for name, lo in (("static", lo_static), ("rot", lo_rot)):
        q = map_quality(tri_e, tri_state_view(lo, grid).cpu().numpy(), grid)
        out["tiers"][name] = q
        print(f"{name}: IoU {q['iou']:.3f} wall-p90 {q['p90']:.1f} "
              f"occ_e {q['occ_e']} occ_f {q['occ_f']} "
              f"| exact-only {q['miss']} (unk {q['miss_unknown']} occ "
              f"{q['miss_occ']}) fast-only {q['extra']} of "
              f"{q['exact_free']} exact-free")
    out["seconds"] = time.perf_counter() - t0
    print(f"({out['seconds']:.0f}s, rays={args.rays} groups={args.groups} "
          f"per={per} steps={args.steps})")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
