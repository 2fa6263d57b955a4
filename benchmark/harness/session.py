"""Set-up, warm-up and the measured window of a cell.

The window drives the program's deployable step, `swarm_tpu_torch.engine.
sim.make_sim_step(cfg, walls, params, generator, donate=True,
walls_grouped=..., room_of_agent=...)`, one call a step, from the state
that warm-up left: whole steps from a synchronised start until the first
step boundary at or after `seconds`, then a synchronise. A CUDA event is
recorded at every step boundary (no host read inside the window); the
periods between them are read once the window has closed.
"""

from __future__ import annotations

import gc
import math
import time
from typing import NamedTuple

import torch

EVENT_POOL = 2048


def step_kinds(cfg, n_steps: int):
    """The kind (zone snapshot?, merge?) of steps 0..n_steps-1 under the
    engine's cadences."""
    nav, eng = cfg.nav, cfg.engine
    dt = nav.drive_tick_s + nav.settle_tick_s
    zone_every = max(1, round(cfg.coord.zone_interval_s / dt))
    m = eng.merge_every if eng.merge_every > 0 and eng.scan_rays > 0 else 0
    return [(s % zone_every == 0, m > 0 and s % m == m - 1)
            for s in range(n_steps)]


def warmup_steps(cfg) -> int:
    """Steps from step 0 until every kind of step the cadences give (plain,
    zone, merge, zone and merge) has run once."""
    nav, eng = cfg.nav, cfg.engine
    dt = nav.drive_tick_s + nav.settle_tick_s
    zone_every = max(1, round(cfg.coord.zone_interval_s / dt))
    period = zone_every * max(1, eng.merge_every) // math.gcd(
        zone_every, max(1, eng.merge_every))
    kinds = step_kinds(cfg, period)
    want = set(kinds)
    seen = set()
    for i, k in enumerate(kinds):
        seen.add(k)
        if seen == want:
            return i + 1
    return period


class Program(NamedTuple):
    step: object          # the step closure
    cfg: object           # the program's SwarmConfig
    params: object
    sim: object           # the module swarm_tpu_torch.engine.sim


def make_program(sides, generator) -> Program:
    """The program's step closure on the cell's world."""
    from swarm_tpu_torch.engine import sim

    from benchmark.harness.world import program_params

    w = sides.world
    params = program_params(w.params)
    step = sim.make_sim_step(sides.program_cfg, w.walls, params, generator,
                             donate=True, walls_grouped=w.walls_grouped,
                             room_of_agent=w.room_of_agent)
    return Program(step=step, cfg=sides.program_cfg, params=params, sim=sim)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Totals:
    """The simulated statistics of a run of steps, read after it: each
    step's metrics are 0-d tensors the step made anyway."""

    FIELDS = ("writes", "closures", "merges", "online")

    def __init__(self):
        self.rows = []

    def add(self, m):
        self.rows.append(tuple(getattr(m, f) for f in self.FIELDS))

    def read(self) -> dict:
        if not self.rows:
            return {"steps": 0}
        cols = [torch.stack(c).to(torch.int64) for c in zip(*self.rows)]
        out = {"steps": len(self.rows)}
        for f, c in zip(self.FIELDS, cols):
            out[f] = int(c.sum())
        out["online_min"] = int(cols[3].min())
        return out


def warm_up(program: Program, state, n_steps: int):
    """n_steps through the step closure from `state` (set-up)."""
    totals = Totals()
    for _ in range(n_steps):
        state, m = program.step(state)
        totals.add(m)
    return state, totals


class Window(NamedTuple):
    steps: int
    seconds: float            # host clock, synchronised start to end
    step_ms: list             # each step's period on the device timeline
    totals: Totals


def run_window(program: Program, state, seconds: float, dev):
    """Whole steps from a synchronised start until the first step boundary
    at or after `seconds`, then a synchronise. Python's garbage collector
    is paused over the window (collected before it), so that no collection
    of the benchmark's own objects lands in one run's window and not in
    another's. Returns (state, Window)."""
    cuda = dev.type == "cuda"
    events = ([torch.cuda.Event(enable_timing=True)
               for _ in range(EVENT_POOL)] if cuda else None)
    host_marks = []
    totals = Totals()
    gc.collect()
    gc.disable()
    sync(dev)
    t0 = time.perf_counter()
    if cuda:
        events[0].record()
    else:
        host_marks.append(t0)
    n = 0
    while True:
        state, m = program.step(state)
        totals.add(m)
        n += 1
        if cuda:
            if n >= len(events):
                events.append(torch.cuda.Event(enable_timing=True))
            events[n].record()
        else:
            host_marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    dt = time.perf_counter() - t0
    gc.enable()
    if cuda:
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n)]
    else:
        step_ms = [(host_marks[i + 1] - host_marks[i]) * 1e3
                   for i in range(n)]
    return state, Window(steps=n, seconds=dt, step_ms=step_ms,
                         totals=totals)
