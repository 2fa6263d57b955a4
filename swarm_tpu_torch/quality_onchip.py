"""Quality of the fast raster tiers on the card against the exact tier
(tools/quality_onchip.py on the port).

    python -m swarm_tpu_torch.quality_onchip [--steps 300] [--turbo]
        [--device cuda]

Runs the closed-loop engine with 4 agents and 61-ray sweeps on the tiled
world (`presets.coverage(4, frontiers=False, scan_rays=61)`, the sweep
alone rastered: `raster_4way=False`) once per tier, every run from the
same noise seed: first the exact tier (`use_pallas=False`: the sweep
through `ops/beam_raster.beam_raster_reference`), then the window
kernel per beam with the pack16 table, per beam with the pack8 table and,
with `--turbo`, the grouped tier in 8 groups with the endpoint ring. Each
tier's map is compared with the exact map (`map_quality`): IoU of the FREE
cells, and the 90th percentile of the Chebyshev distance, in cells, from
each OCCUPIED cell of the tier's map to the nearest OCCUPIED cell of the
exact map (wall p90). The trajectories do not depend on the map (the
merge is off and closures correct nothing), so the tiers see the same
poses and readings. Prints the tool's lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from swarm_tpu_torch._device import default_device, describe

AGENTS = 4
RAYS = 61
SEED = 0
TIERS = (("per-beam", {"raster_4way": False, "beam_groups": 0}),
         ("per-beam-pack8", {"raster_4way": False, "beam_groups": 0,
                             "beam_pack8": True}))
TURBO = ("turbo-g8", {"raster_4way": False, "beam_groups": 8,
                      "kernel_endpoints": True})
ROW_BLOCK = 1024         # occupied cells of one map compared at a time


def _wall_p90(occ_f, occ_e) -> float:
    """The 90th percentile over occ_f [F, 2] of the Chebyshev distance to
    the nearest cell of occ_e [E, 2] (NaN when either is empty)."""
    if not len(occ_f) or not len(occ_e):
        return float("nan")
    d = np.empty(len(occ_f), np.int64)
    for i in range(0, len(occ_f), ROW_BLOCK):
        blk = occ_f[i:i + ROW_BLOCK]
        d[i:i + ROW_BLOCK] = np.abs(blk[:, None, :] - occ_e[None, :, :]
                                    ).max(-1).min(-1)
    return float(np.quantile(d, 0.9))


def map_quality(exact, fast, grid_cfg) -> dict:
    """A tier's tri-state map `fast` against the exact tier's `exact` (int8
    [S, S] numpy, codes of `grid_cfg`): IoU of the FREE cells, wall p90,
    the OCCUPIED counts, and the FREE cells of one map only (`miss`: exact
    FREE, fast not; of those `miss_unknown` and `miss_occ`; `extra`: fast
    FREE, exact not) out of `exact_free`. The tool's expressions
    (tools/quality_onchip.py:64-70, tools/proto_phase_quality.py:106-123);
    the distances go by blocks of ROW_BLOCK rows."""
    fe = exact == grid_cfg.free
    ff = fast == grid_cfg.free
    occ_e = np.argwhere(exact == grid_cfg.occupied)
    occ_f = np.argwhere(fast == grid_cfg.occupied)
    return {"iou": float((fe & ff).sum() / max((fe | ff).sum(), 1)),
            "p90": _wall_p90(occ_f, occ_e),
            "occ_e": len(occ_e), "occ_f": len(occ_f),
            "miss": int((fe & ~ff).sum()), "extra": int((ff & ~fe).sum()),
            "miss_unknown": int((fe & (fast == grid_cfg.unknown)).sum()),
            "miss_occ": int((fe & (fast == grid_cfg.occupied)).sum()),
            "exact_free": int(fe.sum())}


def run(patch: dict, steps: int, use_pallas: bool, device, seed=SEED):
    """One tier's rollout: (its tri-state map as numpy, cfg, seconds)."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init, sim_rollout
    from swarm_tpu_torch.ops.raster import tri_state_view

    dev = default_device(device)
    cfg, walls, params, rooms = presets.coverage(AGENTS, False, dev,
                                                 scan_rays=RAYS)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, use_pallas=use_pallas, **patch))
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    final, _ = sim_rollout(sim_init(cfg, params), steps, cfg, walls, params,
                           gen, walls_grouped=rooms[0],
                           room_of_agent=rooms[1])
    tri = tri_state_view(final.srv.logodds, cfg.grid).cpu().numpy()
    return tri, cfg, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--turbo", action="store_true",
                    help="also measure the grouped tier")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    exact, cfg, te = run({"raster_4way": False}, args.steps, False, dev)
    print(f"exact tier: {te:.0f}s", flush=True)
    platform, device_name = describe(dev)
    out = {"steps": args.steps, "agents": AGENTS, "rays": RAYS,
           "platform": platform, "device": device_name, "exact_s": te,
           "tiers": {}}
    for name, patch in TIERS + ((TURBO,) if args.turbo else ()):
        fast, _, tf = run(patch, args.steps, True, dev)
        q = map_quality(exact, fast, cfg.grid)
        print(f"{name}: IoU {q['iou']:.3f} wall-p90 {q['p90']:.1f} "
              f"({tf:.0f}s)", flush=True)
        out["tiers"][name] = dict(q, seconds=tf)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
