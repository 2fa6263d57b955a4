"""The device's busy and idle time, over three stretches of steps with
nothing else installed. The first two are `trace_steps["profile"]` steps
long (a whole period of the step cadences, so each holds every kind of
step in its share).

1. No profiler: the stretch's length by the host clock (`plain_s`).
2. torch.profiler recording the device alone: its busy time (the union
   of its kernels, copies and fills), the stretch's length by the host
   clock (`window_s`, longer than `plain_s`: recording each launch slows
   the host), and the device operations that took most time.
3. `trace_steps["profile_gaps"]` steps under torch.profiler recording
   the host's operations too, which slows the host further: only the
   longest idle gaps, each named by the innermost
   host operation that was running at its middle.
Needs the card: off it the record is empty."""

from __future__ import annotations

import time

import torch

TOP = 10


def _union(intervals):
    """Merged [start, end) intervals of a list, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(cpu, t: float) -> str:
    best = None
    for a, b, name in cpu:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host outside torch operations"


def _stretch(ctx, state, activities, steps):
    """(state, host seconds, events) of a stretch of `steps` steps,
    profiled unless `activities` is empty."""
    from torch.profiler import profile

    torch.cuda.synchronize(ctx.dev)
    if not activities:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = ctx.program.step(state)
        torch.cuda.synchronize(ctx.dev)
        return state, time.perf_counter() - t0, []
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = ctx.program.step(state)
        torch.cuda.synchronize(ctx.dev)
        window_s = time.perf_counter() - t0
    return state, window_s, prof.events()


def _split(events):
    from torch.autograd import DeviceType

    dev_ev, cpu = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev_ev.append((a, b, e.name))
        elif e.device_type == DeviceType.CPU:
            cpu.append((a, b, e.name))
    return dev_ev, cpu


def run(ctx, state, metrics):
    from torch.profiler import ProfilerActivity

    if ctx.dev.type != "cuda":
        return state, {}
    n = ctx.steps("profile")
    state, plain_s, _ = _stretch(ctx, state, [], n)
    state, window_s, events = _stretch(ctx, state, [ProfilerActivity.CUDA],
                                       n)
    dev_ev, _ = _split(events)
    busy_s = sum(b - a for a, b in _union([(a, b) for a, b, _ in dev_ev]))
    by_name = {}
    for a, b, name in dev_ev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    state, _, events = _stretch(ctx, state, [ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA],
                                ctx.steps("profile_gaps"))
    dev_ev, cpu = _split(events)
    busy = _union([(a, b) for a, b, _ in dev_ev])
    gaps = sorted(((busy[i + 1][0] - busy[i][1],
                    (busy[i + 1][0] + busy[i][1]) / 2)
                   for i in range(len(busy) - 1)), reverse=True)[:TOP]
    idle = [[_host_label(cpu, mid), g * 1e-6] for g, mid in gaps]
    return state, {"busy_s": busy_s * 1e-6, "window_s": window_s,
                   "plain_s": plain_s,
                   "steps": n,
                   "device_ops": [[n, s] for n, s in ops],
                   "idle_gaps": idle}


def result_keys(record) -> dict:
    """What the result line carries of this record: device.busy_s and
    window_s, and the breakdown."""
    if not record:
        return {}
    return {"device": {"busy_s": record["busy_s"],
                       "window_s": record["window_s"]},
            "breakdown": {"device_ops": record["device_ops"],
                          "idle_gaps": record["idle_gaps"]}}
