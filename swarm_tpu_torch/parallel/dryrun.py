"""Multi-device dry run of the sharded engine (the counterpart of
`__graft_entry__._dryrun_impl`): a few sharded steps in each grid
decomposition on the process group it is launched in.

    torchrun --nproc-per-node N -m swarm_tpu_torch.parallel.dryrun
    python -m swarm_tpu_torch.parallel.dryrun            # one rank, one card
    torchrun --nproc-per-node 4 -m swarm_tpu_torch.parallel.dryrun \\
        --device cpu                                     # gloo ranks

Each rank takes the card `cuda:LOCAL_RANK` (NCCL) unless `--device cpu`
(gloo). Two worlds, each run in "replicated" and in its own decomposition,
from the same state and the same noise (one generator seeded alike on every
rank):
  * "rows": `presets.vertical_rooms(world)`, one room per rank's band;
  * "tiles": `presets.tile_blocks(R, C, size)` on an R x C rank grid (1 x 1
    on one rank, world/2 x 2 on an even world; an odd world above one has
    no tile layout here, as in the reference's dryrun).
Checks, after `--steps` steps: every agent online, cells written, no band
escape, finite poses, and "rows" bit-equal to "replicated" (maps, poses,
writes). For "tiles" it prints how many cells differ from "replicated".
`--out PATH` makes rank 0 write each run's final map, poses and writes to
an .npz (the tests read it). Every rank prints its lines; rank 0 ends with
`dryrun ok (<world> ranks)`.
"""

from __future__ import annotations

import argparse
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from swarm_tpu_torch import presets
from swarm_tpu_torch.engine.sim import sim_init, total_writes_value
from swarm_tpu_torch.parallel import mesh, sharded

# the noise generator's seed, alike on every rank
SEED = 0


def tile_grid(world: int):
    """The dry run's (R, C) rank grid for "tiles", or None."""
    if world == 1:
        return 1, 1
    return (world // 2, 2) if world % 2 == 0 else None


def _run(world_fn, grid_sharding: str, grid, steps: int, device):
    """`steps` sharded steps of one world in one decomposition; returns the
    gathered global state and the last step's metrics."""
    cfg, walls, params, rooms = world_fn(device)
    layout = mesh.make_layout(grid, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    step = sharded.make_sharded_sim_step(
        cfg, walls, params, layout, gen, grid_sharding=grid_sharding,
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    state = sharded.shard_state(sim_init(cfg, params), layout, grid_sharding)
    for _ in range(steps):
        state, m = step(state)
    full = sharded.gather_state(state, layout, grid_sharding)
    n = cfg.n_agents
    writes = total_writes_value(full.srv.total_writes)
    if int(m.online) != n or writes <= 0 or int(m.band_escapes) != 0 or \
            not bool(torch.isfinite(full.pose_true).all()):
        raise AssertionError(
            f"{grid_sharding}: online {int(m.online)}/{n}, writes {writes}, "
            f"band escapes {int(m.band_escapes)}")
    return full, m, writes


def run(steps: int = 2, merge_every: int = 16, device=None,
        out: str | None = None) -> dict:
    """The dry run on the initialised default group; returns {name:
    (global state, last metrics, writes)}."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    runs = {}
    cases = [("rows", lambda d: presets.vertical_rooms(
        world, device=d, merge_every=merge_every), None)]
    grid = tile_grid(world)
    if grid is not None:
        size = max(512, -(-max(grid[1] * 256, grid[0] * 128) // 256) * 256)
        cases.append(("tiles", lambda d: presets.tile_blocks(
            *grid, size, device=d, merge_every=merge_every), grid))
    for decomp, world_fn, g in cases:
        ref = _run(world_fn, "replicated", g, steps, device)
        got = _run(world_fn, decomp, g, steps, device)
        runs[f"{decomp}-world replicated"] = ref
        runs[decomp] = got
        lo_r, lo = ref[0].srv.logodds, got[0].srv.logodds
        n_diff = int((lo != lo_r).sum())
        same_poses = torch.equal(got[0].pose_true, ref[0].pose_true)
        print(f"rank {rank}/{world}: {decomp} vs replicated after {steps} "
              f"steps: {n_diff} of {lo.numel()} cells differ, writes "
              f"{got[2]} vs {ref[2]}, poses equal {same_poses}, merges "
              f"{int(got[1].merges)}, band escapes "
              f"{int(got[1].band_escapes)}", flush=True)
        if decomp == "rows" and (n_diff or not same_poses or
                                 got[2] != ref[2]):
            raise AssertionError("rows is not bit-equal to replicated")
    if out is not None and rank == 0:
        np.savez(out, **{
            f"{name}/{key}": val for name, (st, _, w) in runs.items()
            for key, val in (("logodds", st.srv.logodds.cpu().numpy()),
                             ("pose_true", st.pose_true.cpu().numpy()),
                             ("writes", np.int64(w)))})
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks; default cuda:LOCAL_RANK")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--merge-every", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:           # launched by torchrun
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init_method = f"tcp://127.0.0.1:{mesh.free_port()}"
        world, rank = 1, 0
    device = mesh.init(init_method, world, rank,
                       timedelta(seconds=args.timeout), device=args.device)
    try:
        run(args.steps, args.merge_every, device, args.out)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"dryrun ok ({world} ranks)", flush=True)


if __name__ == "__main__":
    main()
