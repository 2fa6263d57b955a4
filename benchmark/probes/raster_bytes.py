"""The window raster's work and its kernel's time over a stretch of steps:
torch.profiler (device activity only) for the device time of every
`free_raster_kernel` launch, and a wrapper around the program's
`swarm_tpu_torch.engine.sim._raster_fans` that copies the grid before
each call, counts the cells whose bits the call changed, and works out
with the frozen plain arithmetic (`benchmark/reference/ops/
window_raster`) the cells that take nonzero evidence. The need of each
launch follows `benchmark/harness/roofline.py`. Needs the card: off
it the record is empty.

Record: {"launches", "recorded", "kernel_s", "bytes", "ops", "changed",
"evidence", "card"}: the launches the calls made, those the profiler
recorded and their device seconds, the bytes and operations the calls'
work needs, the cells changed and the cells that take evidence, the
card's name and power limit."""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import roofline
from benchmark.harness.check import cells_differ
from benchmark.reference.ops import window_raster as wr
from benchmark.reference.ops.beam_raster import (BeamSpec, beams_from_4way,
                                                 beams_from_scan,
                                                 reach_cells)

KERNEL = "free_raster_kernel"


def _fans(cfg, dist4, scan_dist):
    """The fans `_raster_fans` rasters for `cfg`: (spec, (ranges,
    trusted)) each."""
    sens = cfg.sensors
    fans = []
    if cfg.engine.raster_4way or scan_dist is None:
        fans.append((BeamSpec.four_way(),
                     beams_from_4way(dist4, sens.max_range, sens.min_range)))
    if scan_dist is not None:
        fans.append((BeamSpec.scan(scan_dist.shape[-1]),
                     beams_from_scan(scan_dist, sens.max_range,
                                     sens.min_range)))
    return fans


def evidence_cells(logodds, axy, ryaw, alive, fans, cfg) -> int:
    """The grid cells that take nonzero evidence from any fan's window,
    by the plain arithmetic, in blocks of agents."""
    eng = cfg.engine
    size = logodds.shape[1]
    mask = torch.zeros(logodds.numel(), dtype=torch.bool,
                       device=logodds.device)
    reach = reach_cells(cfg)
    for spec, (db, tb) in fans:
        n_groups = (spec.n_beams if eng.beam_groups <= 0
                    else min(eng.beam_groups, spec.n_beams))
        w = wr._windows(logodds, axy, ryaw, db, alive, spec, cfg.grid,
                        tb if eng.kernel_endpoints else None, reach,
                        eng.beam_pack8, n_groups, eng.beam_tail_weight)
        dense = wr._dense_fan(spec, reach)
        n = w.ax.shape[0]
        for a in range(0, n, wr.BLOCK_AGENTS):
            b = min(n, a + wr.BLOCK_AGENTS)
            delta, _ = wr._window_deltas(wr._block(w, a, b), spec,
                                         cfg.grid, dense)
            i, r, c = torch.nonzero(delta, as_tuple=True)
            del delta
            rows = w.row0[a:b].to(torch.int64)[i] + r
            cols = w.col0[a:b].to(torch.int64)[i] + c
            mask[rows * size + cols] = True
    return int(mask.sum())


def run(ctx, state, metrics):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if ctx.dev.type != "cuda":
        return state, {}
    sim = importlib.import_module("swarm_tpu_torch.engine.sim")
    orig = sim._raster_fans
    work = {"launches": 0, "bytes": 0, "ops": 0, "changed": 0,
            "evidence": 0}

    def counted(logodds, axy, ryaw, dist4, scan_dist, alive, cfg):
        fans = _fans(cfg, dist4, scan_dist)
        evidence = evidence_cells(logodds, axy, ryaw, alive, fans, cfg)
        before = logodds.clone()
        out = orig(logodds, axy, ryaw, dist4, scan_dist, alive, cfg)
        changed = cells_differ(before, out[0])
        del before
        n = axy.shape[0]
        operands = sum(n * (roofline.table_bytes(spec.n_beams,
                                                 cfg.engine.beam_pack8)
                            + roofline.AGENT_OPERAND_BYTES)
                       for spec, _ in fans)
        work["launches"] += len(fans)
        work["bytes"] += roofline.needed_bytes(out[0].element_size(),
                                               evidence, changed, operands)
        work["ops"] += roofline.OPS_PER_CELL * evidence
        work["changed"] += changed
        work["evidence"] += evidence
        return out

    torch.cuda.synchronize(ctx.dev)
    sim._raster_fans = counted
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ctx.steps("raster_bytes")):
                state, _ = ctx.program.step(state)
            torch.cuda.synchronize(ctx.dev)
    finally:
        sim._raster_fans = orig
    kernel_s, recorded = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and KERNEL in e.name:
            kernel_s += (e.time_range.end - e.time_range.start) * 1e-6
            recorded += 1
    return state, dict(work, recorded=recorded, kernel_s=kernel_s,
                       card=roofline.card())
