"""Spans from the benchmark's side: CUDA events around functions the
program calls by module-global name (as swarm_tpu_torch/profile_step.py's
`step_split` wraps them), over a stretch of steps. Each metric of this
probe declares `SPANS`, {part: ((module, function), ...)}; with `PEAK =
True` the allocator's peak is reset before each wrapped call and read
after it. The wrappers are removed when the stretch ends. Needs the card:
off it the record is empty.

Record: {"steps": n, "calls": {part: [(step, ms, peak_bytes)]}}, each
call's device-timeline ms read after the stretch."""

from __future__ import annotations

import importlib

import torch


def run(ctx, state, metrics):
    if ctx.dev.type != "cuda":
        return state, {}
    parts = {}
    for m in metrics:
        for part, targets in m.SPANS.items():
            parts.setdefault(part, set()).update(targets)
    peak = any(getattr(m, "PEAK", False) for m in metrics)
    originals = {}
    marks = []
    step_no = [0]

    def timed(part, fn):
        def run_part(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            if peak:
                torch.cuda.reset_peak_memory_stats(ctx.dev)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            marks.append((part, step_no[0], e0, e1,
                          torch.cuda.max_memory_allocated(ctx.dev)
                          if peak else None))
            return out
        return run_part

    try:
        for part, targets in parts.items():
            for mod_name, fn_name in sorted(targets):
                mod = importlib.import_module(mod_name)
                if (mod, fn_name) not in originals:
                    originals[(mod, fn_name)] = getattr(mod, fn_name)
                    setattr(mod, fn_name,
                            timed(part, originals[(mod, fn_name)]))
        for i in range(ctx.steps("spans")):
            step_no[0] = i
            state, _ = ctx.program.step(state)
        torch.cuda.synchronize(ctx.dev)
    finally:
        for (mod, fn_name), fn in originals.items():
            setattr(mod, fn_name, fn)
    calls = {p: [] for p in parts}
    for part, i, e0, e1, pk in marks:
        calls[part].append((i, e0.elapsed_time(e1), pk))
    return state, {"steps": ctx.steps("spans"), "calls": calls}
