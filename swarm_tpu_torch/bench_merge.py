"""Map-merge solve latency of the port (tools/bench_merge.py on the card):
correlative grid-to-grid scan matching (`slam.scanmatch.match_grids`) and
pose-graph Gauss-Newton, dense (`slam.posegraph.gauss_newton`) and
structured (`slam.tridiag.structured_gn`, block cyclic reduction +
Woodbury), each 10 iterations.

    python -m swarm_tpu_torch.bench_merge [--inner 16] [--device cuda]

The inputs are the tool's, from the same numpy generator (`inputs`): a
256^2 occupancy pair (2% of cells occupied, the local map the global one
rolled by (3, -4)) and a 1024-node noisy spiral trajectory with 64 closure
edges (zero measurements), as `graph_from_trajectory` builds it. Each
figure is the best of REPS synchronised rounds of `--inner` calls (host
clock around the round, `torch.cuda.synchronize()` at both ends), per
call. Prints one JSON line with the tool's keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from swarm_tpu_torch._device import default_device, describe

NODES = 1024
CLOSURES = 64
ITERATIONS = 10
REPS = 3


def inputs(n: int = NODES, device=None):
    """(local [256, 256], global [256, 256], graph) as the tool draws them
    (tools/bench_merge.py:58-83) from numpy's default_rng(0): at n = 1024
    the closures start at nodes in [0, n - 200) and span 100 to 198 nodes;
    below that the span scales to n / 5 (a 128-node graph's closures start
    in [0, 103) and span 12 to 23 nodes)."""
    from swarm_tpu_torch.slam.posegraph import graph_from_trajectory

    dev = default_device(device)
    rng = np.random.default_rng(0)
    occ = (rng.random((256, 256)) < 0.02).astype(np.float32)
    local = torch.tensor(np.roll(occ, (3, -4), axis=(0, 1)), device=dev)
    glob = torch.tensor(occ, device=dev)

    span = min(200, n // 5)
    t = np.linspace(0, 20 * np.pi, n)
    poses = np.stack([np.cos(t) * 3, np.sin(t) * 3, t % (2 * np.pi)], -1)
    poses += rng.normal(0, 0.05, poses.shape)
    ci = rng.integers(0, n - span, CLOSURES)
    cj = ci + rng.integers(span // 2, span - 1, CLOSURES)
    g = graph_from_trajectory(
        torch.tensor(poses, dtype=torch.float32, device=dev), n,
        torch.tensor(ci, dtype=torch.int32, device=dev),
        torch.tensor(cj, dtype=torch.int32, device=dev),
        torch.zeros((CLOSURES, 3), dtype=torch.float32, device=dev),
        CLOSURES)
    return local, glob, g


def solve_dense(g):
    from swarm_tpu_torch.slam.posegraph import gauss_newton

    return gauss_newton(g, iterations=ITERATIONS)


def solve_structured(g):
    from swarm_tpu_torch.slam.tridiag import structured_gn

    return structured_gn(g, n_chain=g.poses.shape[0] - 1,
                         iterations=ITERATIONS)


def timed(fn, inner: int, dev, reps: int = REPS) -> float:
    """Seconds a call: the best of `reps` synchronised rounds of `inner`
    calls, after one warm call."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best / inner


def main(argv=None):
    from swarm_tpu_torch.config import GridConfig, SlamConfig
    from swarm_tpu_torch.slam.scanmatch import match_grids

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inner", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    local, glob, g = inputs(NODES, dev)
    grid, slam = GridConfig(size=256), SlamConfig()
    t_match = timed(lambda: match_grids(local, glob, grid, slam),
                    args.inner, dev)
    t_gn = timed(lambda: solve_dense(g), args.inner, dev)
    t_sgn = timed(lambda: solve_structured(g), args.inner, dev)
    platform, device_name = describe(dev)
    out = {
        "scanmatch_ms": round(t_match * 1e3, 3),
        "posegraph_gn_1024n_10it_ms": round(t_gn * 1e3, 3),
        "posegraph_structured_gn_1024n_10it_ms": round(t_sgn * 1e3, 3),
        "platform": platform,
        "device": device_name,
        "detail": {"scanmatch": "256^2 pair, 17 rotations, +/-16 cells",
                   "gn": "1024 nodes, 1023 odom + 64 closure edges; "
                         "structured = block cyclic reduction + Woodbury"},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
