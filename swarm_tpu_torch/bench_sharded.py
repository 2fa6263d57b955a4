"""Sharded-engine scaling check (tools/bench_sharded.py on the port): the
swarm preset (`presets.swarm(--agents)`: the line scatter of the 4-way
rays, "replicated") stepped by `parallel.sharded.make_sharded_sim_step` at
each world size of `--worlds`, each world its own `torchrun --standalone`
of this module's rank entry. Per world it prints the host clock around
`--steps` synchronised steps (ms/step; one warm-up step first) and the
total writes, and it fails unless the writes are identical across worlds
(the tool's assertion: the sharded result does not depend on the mesh).

    python -m swarm_tpu_torch.bench_sharded --agents 1024 --steps 20
    python -m swarm_tpu_torch.bench_sharded --agents 8 --steps 2 \\
        --worlds 1,2 --device cpu            # gloo ranks on the CPU

Each rank takes the card `cuda:LOCAL_RANK` (NCCL) unless `--device cpu`
(gloo); a world of W ranks needs W cards. Noise comes from one generator
seeded alike on every rank.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0                     # the noise generator's seed, alike on every rank
TIMEOUT_S = 300              # a collective waits at most this long
JOIN_LIMIT_S = 900           # a world's torchrun ends within this long


def rank_main(args):
    """One rank of one world (under torchrun): the timed steps; rank 0
    writes {"world", "ms_per_step", "writes"} to `args.out`."""
    import torch
    import torch.distributed as dist

    from swarm_tpu_torch import presets
    from swarm_tpu_torch.engine.sim import sim_init, total_writes_value
    from swarm_tpu_torch.parallel import mesh, sharded

    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dev = mesh.init("env://", world, rank, timedelta(seconds=TIMEOUT_S),
                    device=args.device)
    try:
        cfg, walls, params, _ = presets.swarm(args.agents, device=dev)
        lay = mesh.make_layout(device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        step = sharded.make_sharded_sim_step(cfg, walls, params, lay, gen)
        state = sharded.shard_state(sim_init(cfg, params), lay)
        state, m = step(state)                 # warm-up
        float(m.pose_err)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state)
            float(m.pose_err)                  # host sync every step
        dt = (time.perf_counter() - t0) / args.steps
        writes = total_writes_value(state.srv.total_writes)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(args.out, "w") as f:
            json.dump({"world": world, "ms_per_step": dt * 1e3,
                       "writes": writes}, f)


def run_world(world: int, args, out: str) -> dict:
    """One world of `world` ranks through torchrun; returns rank 0's
    record."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    if args.device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc-per-node={world}", "--standalone", "-m",
           "swarm_tpu_torch.bench_sharded", "--rank-entry", "--out", out,
           "--agents", str(args.agents), "--steps", str(args.steps)]
    if args.device is not None:
        cmd += ["--device", args.device]
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=JOIN_LIMIT_S)
    if res.returncode != 0:
        raise SystemExit(f"bench_sharded: world {world} failed (exit "
                         f"{res.returncode}):\n{res.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--worlds", default="1",
                    help="comma-separated world sizes (ranks)")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks; default cuda:LOCAL_RANK")
    ap.add_argument("--rank-entry", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_entry:
        rank_main(args)
        return
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for w in (int(x) for x in args.worlds.split(",")):
            if args.agents % w:
                continue
            r = run_world(w, args, os.path.join(tmp, f"world{w}.json"))
            results[w] = r
            print(f"world={w:2d}  {r['ms_per_step']:8.2f} ms/step  "
                  f"writes={r['writes']}", flush=True)
    writes = {r["writes"] for r in results.values()}
    if len(writes) != 1:
        raise SystemExit(f"bench_sharded: sharded runs diverge: {results}")
    print(f"OK: identical writes across world sizes {writes.pop()}")


if __name__ == "__main__":
    main()
