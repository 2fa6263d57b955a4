"""Multi-device dry run of the sharded engine (the counterpart of
`__graft_entry__._dryrun_impl`): a few sharded steps of each raster tier
in each grid decomposition on the process group it is launched in.

    torchrun --nproc-per-node N -m swarm_tpu_torch.parallel.dryrun
    python -m swarm_tpu_torch.parallel.dryrun            # one rank, one card
    torchrun --nproc-per-node 4 -m swarm_tpu_torch.parallel.dryrun \\
        --device cpu                                     # gloo ranks

Each rank takes the card `cuda:LOCAL_RANK` (NCCL) unless `--device cpu`
(gloo). Sections, each from the same state and the same noise (one
generator seeded alike on every rank):
  * the swarm preset (`presets.swarm(2 * world)`, the reference's
    `_cfg_and_world` defaults: the line scatter of the 4-way rays),
    "replicated";
  * two worlds, each run in "replicated" and in its own decomposition:
    "rows" on `presets.vertical_rooms(world)` (one room per rank's band)
    and "tiles" on `presets.tile_blocks(R, C, size)` (an R x C rank grid:
    1 x 1 on one rank, world/2 x 2 on an even world; an odd world above
    one has no tile layout here, as in the reference's dryrun). In each
    world three tiers: the window kernel ("kernel", the preset's engine),
    the XLA fast tier ("xla": use_pallas=False) and the line scatter
    ("line": raster_mode="line"), and the kernel once more without the
    endpoint ring ("kernel-exact": kernel_endpoints=False, the pairing the
    XLA tier is held to, __graft_entry__.py:298-318, :405-428).
Checks, after `--steps` steps: every agent online, cells written, no band
escape, finite poses; "rows" bit-equal to "replicated" (maps, poses,
writes) in every tier, and "tiles" so in the XLA tier and the line scatter
(their float coordinates are global); the kernel's "tiles" prints how
many cells differ from "replicated" (ROADMAP C22). The XLA tier against
"kernel-exact" in the same decomposition: writes within (0.9, 1.1) of each
other and at most 64 cells with |diff| > 1e-3 (the reference's bars; on
gloo ranks the kernel's plain version stands in for it).
`--out PATH` makes rank 0 write each run's final map, poses and writes to
an .npz (the tests read it). Every rank prints its lines; rank 0 ends with
`dryrun ok (<world> ranks)`.
"""

from __future__ import annotations

import argparse
import dataclasses
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


# the tiers of each decomposition world: EngineConfig fields replaced on
# the preset's engine
TIERS = {"kernel": {}, "xla": dict(use_pallas=False),
         "line": dict(raster_mode="line"),
         "kernel-exact": dict(kernel_endpoints=False)}
# the XLA tier against the kernel without the ring (__graft_entry__.py:
# 314-318, :425-428)
WRITES_RATIO = (0.9, 1.1)
MAX_CELLS_APART = 64


def _tier(world_fn, eng):
    """`world_fn` with the engine fields `eng` replaced."""
    if not eng:
        return world_fn

    def fn(d):
        cfg, *rest = world_fn(d)
        return (cfg.replace(engine=dataclasses.replace(cfg.engine, **eng)),
                *rest)
    return fn


def run(steps: int = 2, merge_every: int = 16, device=None,
        out: str | None = None) -> dict:
    """The dry run on the initialised default group; returns {name:
    (global state, last metrics, writes)}."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    runs = {}
    runs["swarm replicated"] = _run(
        lambda d: presets.swarm(2 * world, device=d), "replicated", None,
        steps, device)
    print(f"rank {rank}/{world}: swarm ({2 * world} agents, line scatter) "
          f"replicated: writes {runs['swarm replicated'][2]}", flush=True)
    cases = [("rows", lambda d: presets.vertical_rooms(
        world, device=d, merge_every=merge_every), None)]
    grid = tile_grid(world)
    if grid is not None:
        size = max(512, -(-max(grid[1] * 256, grid[0] * 128) // 256) * 256)
        cases.append(("tiles", lambda d: presets.tile_blocks(
            *grid, size, device=d, merge_every=merge_every), grid))
    for decomp, world_fn, g in cases:
        for tier, eng in TIERS.items():
            prefix = "" if tier == "kernel" else f"{tier} "
            fn = _tier(world_fn, eng)
            if tier != "kernel-exact":
                runs[f"{prefix}{decomp}-world replicated"] = _run(
                    fn, "replicated", g, steps, device)
            runs[f"{prefix}{decomp}"] = _run(fn, decomp, g, steps, device)
            if tier == "kernel-exact":
                continue
            ref = runs[f"{prefix}{decomp}-world replicated"]
            got = runs[f"{prefix}{decomp}"]
            lo_r, lo = ref[0].srv.logodds, got[0].srv.logodds
            n_diff = int((lo != lo_r).sum())
            same_poses = torch.equal(got[0].pose_true, ref[0].pose_true)
            what = decomp if tier == "kernel" else f"{decomp} [{tier}]"
            print(f"rank {rank}/{world}: {what} vs replicated after {steps} "
                  f"steps: {n_diff} of {lo.numel()} cells differ, writes "
                  f"{got[2]} vs {ref[2]}, poses equal {same_poses}, merges "
                  f"{int(got[1].merges)}, band escapes "
                  f"{int(got[1].band_escapes)}", flush=True)
            if (decomp == "rows" or tier != "kernel") and (
                    n_diff or not same_poses or got[2] != ref[2]):
                raise AssertionError(f"{what} is not bit-equal to "
                                     "replicated")
        xla, kern = runs[f"xla {decomp}"], runs[f"kernel-exact {decomp}"]
        ratio = kern[2] / max(xla[2], 1)
        apart = int((torch.abs(kern[0].srv.logodds - xla[0].srv.logodds)
                     > 1e-3).sum())
        print(f"rank {rank}/{world}: {decomp} XLA tier vs kernel without "
              f"the ring: writes {xla[2]} vs {kern[2]} (ratio {ratio:.6f}),"
              f" {apart} cells apart by > 1e-3", flush=True)
        if not WRITES_RATIO[0] < ratio < WRITES_RATIO[1] or \
                apart > MAX_CELLS_APART:
            raise AssertionError(f"{decomp}: the XLA tier and the kernel "
                                 "disagree")
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
