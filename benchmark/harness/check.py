"""What decides `correct`: the program's steps against the reference step.

Once the window has closed, the program runs on from the state the window
left, through the same step closure, to the first step of each kind the
check names (a merge step, a zone snapshot), and each of those steps is
held against `benchmark/reference/engine/step.py` run from a copy of the
same state with the same noise. The reference can only follow the program
step by step from the program's own state (the simulation's trajectory
forks on the last bit of any float); so the start is checked by itself as
well: step 0 of the program from its own initial state against step 0 of
the reference from the reference's own.

Each number compared is the largest difference over the checked steps of
a group of leaves (the check file's `numbers`): the largest absolute
difference of a float leaf (NaN equal to NaN), of an integer or boolean
leaf as a number; for a `cells` group the count of cells whose bits
differ; for a ring buffer of the closure that the step wrote, the count
of slots that hold neither the value of a row that targets them (the
winner among rows that share a slot is unspecified, in the reference's
scatter as on the card) nor, untargeted, their value from before. Every
number has its limit in the check file.

The control (`control_step`) is the reference computed one precision
below the configuration's: every float32 leaf of the state and of the
step's outputs rounded through bfloat16, and the map stored through the
next precision below its own (float32 -> bfloat16, bfloat16 -> float8).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.engine import step as ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}


def tree_leaves(tree, prefix: str):
    """(path, tensor) of every tensor leaf of a NamedTuple tree."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for f in tree._fields:
        yield from tree_leaves(getattr(tree, f), f"{prefix}.{f}")


def tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(tree_map(fn, getattr(tree, f))
                        for f in tree._fields))


def clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def leaf_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute difference of two leaves (inf where their
    shapes or kinds differ, or a NaN meets a number)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return math.inf
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.bool:
        return float((a != b).sum())
    if not a.is_floating_point():
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    a32, b32 = a.float(), b.float()
    nan_a, nan_b = torch.isnan(a32), torch.isnan(b32)
    if bool((nan_a != nan_b).any()):
        return math.inf
    d = torch.where(nan_a, torch.zeros_like(a32), (a32 - b32).abs())
    return float(d.max())


def cells_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Cells whose bits differ (every cell where the shapes differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    if a.element_size() == 2:
        return int((a.view(torch.int16) != b.view(torch.int16)).sum())
    if a.element_size() == 4:
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return int((a != b).sum())


def ring_differ(got: torch.Tensor, write) -> float:
    """Slots of a ring buffer the program left other than the reference's
    write allows: a slot that rows of the step target must hold the value
    of one of them (the winner among rows that share a slot is
    unspecified), any other slot its value from before the step."""
    res, idx, vals, buf = write
    n = res.shape[0]
    if got.shape != res.shape or got.dtype != res.dtype:
        return math.inf
    at = got[idx.clamp_max(n - 1)]
    same = (at == vals) | (torch.isnan(at) & torch.isnan(vals)) \
        if at.is_floating_point() else at == vals
    same = same.reshape(same.shape[0], -1).all(dim=1) & (idx < n)
    hit = torch.zeros(n + 1, dtype=torch.int64, device=got.device) \
        .index_add_(0, idx, torch.ones_like(idx))[:n]
    held = torch.zeros(n + 1, dtype=torch.int64, device=got.device) \
        .scatter_reduce(0, idx, same.to(torch.int64), "amax")[:n]
    untouched = (got == buf) | (torch.isnan(got) & torch.isnan(buf)) \
        if got.is_floating_point() else got == buf
    untouched = untouched.reshape(n, -1).all(dim=1)
    bad = torch.where(hit > 0, held == 0, ~untouched)
    return float(bad.sum())


def compare(numbers: dict, got, want, where=None) -> dict:
    """{number: reading} of one checked step: `got` and `want` are
    (state, out) pairs of the reference's types. `where`, a dict, gets
    the leaf that gave each number's reading where it is above 0."""
    ga = dict(tree_leaves(got[0], "state"))
    ga.update(tree_leaves(got[1], "out"))
    wa = dict(tree_leaves(want[0], "state"))
    wa.update(tree_leaves(want[1], "out"))
    if set(ga) != set(wa):
        missing = sorted(set(ga) ^ set(wa))
        raise ValueError(f"the two sides' leaves differ: {missing}")
    owner = {}
    for path in ga:
        for name, spec in numbers.items():
            for pre in spec.get("leaves", []) + spec.get("cells", []):
                if path == pre or path.startswith(pre + "."):
                    owner.setdefault(path, name)
        owner.setdefault(path, "rest")
    out = dict.fromkeys(numbers, 0.0)
    for path, name in owner.items():
        if "cells" in numbers[name]:
            r = cells_differ(ga[path], wa[path])
        elif id(wa[path]) in ref.closure_mod.RING_WRITES:
            r = ring_differ(ga[path], ref.closure_mod.RING_WRITES[
                id(wa[path])])
        else:
            r = leaf_diff(ga[path], wa[path])
        if r > out[name]:
            out[name] = r
            if where is not None:
                where[name] = path
    return out


def program_out(m, scan) -> ref.StepOut:
    """The program's StepMetrics as the reference's StepOut."""
    return ref.StepOut(dist4=m.dist_m, scan=scan, srv_x=m.srv_x,
                       srv_y=m.srv_y, srv_yaw=m.srv_yaw, writes=m.writes,
                       v2v=m.v2v, merge_ok=m.merge_ok, merge_fit=m.merge_fit,
                       closures=m.closures, online=m.online)


def program_noise(noise: ref.StepNoise):
    """The reference's StepNoise as the program's type (same tensors)."""
    from swarm_tpu_torch.engine.sim import StepNoise
    from swarm_tpu_torch.models.odometry import DriftNoise
    from swarm_tpu_torch.models.sensors import SensorNoise

    return StepNoise(
        sense=SensorNoise(*noise.sense),
        scan=None if noise.scan is None else SensorNoise(*noise.scan),
        drift=DriftNoise(*noise.drift))


def run_program_step(program, state, noise):
    """One call of the program's step closure with `noise`, the sweep it
    sensed captured. Returns (state, StepOut)."""
    sim = program.sim
    orig = sim.sense_scan
    cap = {}

    def capture(*a, **k):
        cap["scan"] = orig(*a, **k)
        return cap["scan"]

    sim.sense_scan = capture
    try:
        state, m = program.step(state, program_noise(noise))
    finally:
        sim.sense_scan = orig
    return state, program_out(m, cap.get("scan"))


def reference_step(pre, noise, sides, step_no: int, store_through=None):
    w = sides.world
    return ref.reference_step(ref.as_reference(pre, ref.SimState), noise,
                              sides.reference_cfg, w.params,
                              w.walls_grouped, w.room_of_agent, step_no,
                              store_through=store_through)


def lower(dtype: torch.dtype, control: dict):
    name = str(dtype).replace("torch.", "")
    return DTYPES[control[name]] if name in control else None


def control_step(pre, noise, sides, step_no: int, control: dict):
    """The control: the reference one precision below the configuration's
    (float32 leaves through bfloat16, the map through the next precision
    below its own)."""
    f_low = DTYPES[control["float32"]]
    grid_low = lower(sides.reference_cfg.grid.lo_dtype, control)

    def round_leaf(t):
        if t.dtype == torch.float32:
            return t.to(f_low).to(torch.float32)
        if grid_low is not None and t.is_floating_point():
            return t.to(grid_low).to(t.dtype)
        return t

    state, out = reference_step(tree_map(round_leaf, pre), noise, sides,
                                step_no, store_through=grid_low)
    return tree_map(round_leaf, state), tree_map(round_leaf, out)


def next_step_of(kind: str, step_no: int, cfg) -> int:
    """The first step at or after `step_no` of `kind` ("merge" or
    "zone")."""
    from benchmark.harness.session import step_kinds

    s = step_no
    while True:
        zone, merge = step_kinds(cfg, s + 1)[s]
        if (kind == "zone" and zone) or (kind == "merge" and merge):
            return s
        s += 1


def noise_generator(seed: int, dev) -> torch.Generator:
    """The checked steps' noise, apart from the run's own draws."""
    return torch.Generator(device=dev).manual_seed(
        (2 * int(seed) + 1) % (1 << 63))


def run_check(program, state, sides, seed: int, check: dict, dev,
              against=("program",), where=None):
    """The check after the window, from `state` (the program's state, its
    step number read once). `against`: what is held against the
    reference, "program" and / or "control" (the control in the program's
    place). Returns {side: {number: reading}}, each the largest over the
    checked steps. `where`, a dict, gets {side: {number: the leaf of its
    largest reading}}."""
    numbers = check["numbers"]
    cfg = sides.reference_cfg
    gen = noise_generator(seed, dev)
    n, rays = cfg.n_agents, cfg.engine.scan_rays
    readings = {s: dict.fromkeys(numbers, 0.0) for s in against}

    def held(side, got, want):
        at = {}
        for k, v in compare(numbers, got, want, at).items():
            if v > readings[side][k]:
                readings[side][k] = v
                if where is not None:
                    where.setdefault(side, {})[k] = at[k]

    def checked(pre, noise, step_no, program_step):
        got = {}
        if "control" in against:
            got["control"] = control_step(clone(pre), noise, sides, step_no,
                                          check["control"])
        s1, out = program_step()
        if "program" in against:
            got["program"] = (ref.as_reference(s1, ref.SimState), out)
        want = reference_step(pre, noise, sides, step_no)
        for side, g in got.items():
            held(side, g, want)
        return s1

    step_no = int(state.step)
    for kind in check.get("after_window", []):
        target = next_step_of(kind, step_no, cfg)
        while step_no < target:
            state, _ = program.step(state)
            step_no += 1
        noise = ref.draw_step_noise(gen, n, rays, dev)
        state = checked(clone(state), noise, step_no,
                        lambda: run_program_step(program, state, noise))
        step_no += 1
    if check.get("start"):
        noise = ref.draw_step_noise(gen, n, rays, dev)
        s0 = program.sim.sim_init(program.cfg, program.params)
        checked(ref.as_reference(clone(s0), ref.SimState), noise, 0,
                lambda: run_program_step(program, s0, noise))
    return readings


def judge(readings: dict, limits: dict):
    """(correct, [(name, reading, limit)]): every reading at or under its
    limit (a NaN is over any)."""
    rows = [(k, readings[k], limits[k]) for k in readings]
    return all(v <= lim for _, v, lim in rows), rows
