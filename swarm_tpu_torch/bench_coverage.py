"""Exploration efficiency of the port: coverage of reachable free space
over time, wall-following against frontier targets (tools/bench_coverage.py
on the card).

    python -m swarm_tpu_torch.bench_coverage [--agents 64] [--steps 1500]
        [--chunk 100] [--seeds 1] [--device cuda] [--json out.json]

The same closed-loop engine runs twice per seed on `presets.coverage` (the
tool's world: both fans through the window kernel's pack16 forms on the
card, then the exact endpoint scatter): wall-following alone, then with
frontier detection, greedy assignment and target delivery. Per step

    coverage(t) = |cells FREE at t  and  reachable| / |reachable|

where `reachable` (`reachable_mask`) holds the cells whose centres lie
inside a room, inset by a cell (the rooms are closed rectangles, so the
reachable free space is the union of their interiors), and FREE is the
engine's own threshold (ops/raster.FREE_THRESH). The count stays on the
device, one reduction a step; each chunk of `--chunk` steps ends in one
host read. Seed k (`42 + 1000 k`) seeds each variant's noise generator
(the tool seeds each variant's `sim_init` key with it). Prints the tool's
progress lines and its JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from swarm_tpu_torch._device import default_device, describe


def reachable_mask(walls, grid_cfg, inset_cells: int = 1):
    """Ground-truth reachable free space: cells whose centers lie inside a
    room rectangle inset by `inset_cells` (wall-line cells excluded).
    Rooms are 4 consecutive segments from make_rect_room."""
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


def run_variant(cfg, walls, params, rooms, steps, chunk, reach,
                enable_targets, seed: int = 42):
    """Chunked rollout returning the per-step coverage fraction [steps]
    and frontier count [steps] (numpy)."""
    from swarm_tpu_torch.engine.sim import make_sim_step, sim_init
    from swarm_tpu_torch.ops.raster import FREE_THRESH

    if steps % chunk != 0:
        raise ValueError(
            f"--steps {steps} must be a multiple of --chunk {chunk} "
            "(range(steps // chunk) would silently drop the remainder "
            "and report a step count that did not run)")
    dev = params.home_x.device
    reach_t = torch.as_tensor(reach, device=dev)
    denom = float(reach.sum())
    gen = torch.Generator(device=dev).manual_seed(seed)
    step = make_sim_step(cfg, walls, params, gen,
                         enable_targets=enable_targets,
                         walls_grouped=rooms[0], room_of_agent=rooms[1])
    state = sim_init(cfg, params)
    cov, nfr = [], []
    for _ in range(steps // chunk):
        rows = []
        for _ in range(chunk):
            state, m = step(state)
            covered = ((state.srv.logodds <= FREE_THRESH) & reach_t).sum(
                dtype=torch.int64)
            rows.append(torch.stack([covered, m.n_frontiers.to(
                torch.int64)]))
        rows = torch.stack(rows).cpu().numpy()        # one host read
        cov.append(rows[:, 0])
        nfr.append(rows[:, 1])
    cov = np.concatenate(cov).astype(np.float64) / denom
    return cov, np.concatenate(nfr)


def steps_to(cov, frac):
    idx = np.nonzero(cov >= frac)[0]
    return int(idx[0]) + 1 if idx.size else None


def _agg(vals):
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return {"mean": round(float(np.mean(vals)), 1),
            "min": int(np.min(vals)), "max": int(np.max(vals)),
            "n": len(vals)}


def main(argv=None):
    from swarm_tpu_torch import presets

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--seeds", type=int, default=1,
                    help="independent replicates (distinct noise seeds): "
                         "the closed loop is chaotic, so one run cannot "
                         "rank the variants; report mean +/- range over "
                         "N >= 5 for claims")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    seeds = [42 + 1000 * k for k in range(args.seeds)]
    results = {}
    curves = {}          # name -> [n_seeds, steps]
    for name, frontiers in (("wall_follow", False),
                            ("frontier_targets", True)):
        cfg, walls, params, rooms = presets.coverage(args.agents, frontiers,
                                                     dev)
        reach = reachable_mask(walls.cpu().numpy(), cfg.grid)
        covs, nfr = [], None
        for seed in seeds:
            cov, nfr = run_variant(cfg, walls, params, rooms, args.steps,
                                   args.chunk, reach, frontiers, seed=seed)
            covs.append(cov)
            print(f"[{name} seed={seed}] final={cov[-1]:.3f}", flush=True)
        covs = np.stack(covs)
        curves[name] = covs
        finals = covs[:, -1]
        results[name] = {
            "coverage_final_mean": round(float(finals.mean()), 4),
            "coverage_final_min": round(float(finals.min()), 4),
            "coverage_final_max": round(float(finals.max()), 4),
            "steps_to_50pct": _agg([steps_to(c, 0.5) for c in covs]),
            "steps_to_70pct": _agg([steps_to(c, 0.7) for c in covs]),
            "steps_to_90pct": _agg([steps_to(c, 0.9) for c in covs]),
            "frontiers_final": int(nfr[-1]),
        }
        print(f"[{name}] final={finals.mean():.3f} "
              f"[{finals.min():.3f}, {finals.max():.3f}] over "
              f"{len(seeds)} seed(s)", flush=True)

    platform, device_name = describe(dev)
    wf = curves["wall_follow"][:, -1]
    ft = curves["frontier_targets"][:, -1]
    out = {
        "metric": "coverage_final_frontier_targets",
        "value": round(float(ft.mean()), 4),
        "unit": "fraction of reachable free space",
        "vs_wall_follow": round(float(ft.mean() / max(wf.mean(), 1e-9)),
                                3),
        "detail": {
            "agents": args.agents, "steps": args.steps,
            "platform": platform, "device": device_name,
            "seeds": seeds,
            "vs_wall_follow_per_seed": [
                round(float(f / max(w, 1e-9)), 3)
                for f, w in zip(ft, wf)],
            "reachable_cells": int(reach.sum()),
            "curve_every": args.chunk,
            "curves": {k: [round(float(v), 4)
                           for v in c.mean(0)[args.chunk - 1::args.chunk]]
                       for k, c in curves.items()},
            "finals_per_seed": {k: [round(float(v), 4) for v in c[:, -1]]
                                for k, c in curves.items()},
            **results,
        },
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
