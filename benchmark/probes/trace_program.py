"""The program's own spans and counters (`swarm_tpu_torch/trace.py`), over
two stretches of `trace_steps["profile"]` steps each (a whole period of the
merge and zone cadences):

(a) tracing on, no profiler: each span's host ms and device ms (its CUDA
    events), and each step's counters (the allocator's device allocations,
    frees and retries; the raster kernels' launches by form);
(b) tracing on under torch.profiler recording the host and the device, on
    one clock: the device-to-host syncs (`SYNCS`) the host called inside a
    `swarm.step` range, each counted under the innermost program span open
    around it; and each idle gap between the device's busy intervals put
    down to the innermost program span open on the host at its middle.
    The device events of the profiler's own annotations (`is_user_
    annotation`: the device-side shadow of every span) are dropped before
    the busy time is made.

Needs the card, and a program that has the tracer: otherwise the record is
empty, and the metrics that read it are left out of the line.

Record: {"steps": n,
         "spans": [[name, parent index, step, host ms, device ms], ...],
         "counters": {step: {"num_device_alloc": k, ..., "launches": ...}},
         "syncs": {span: {call: n}}, "idle_ms": {span: ms}}
(spans and counters from (a), syncs and idle from (b), each over n steps).
"""

from __future__ import annotations

import bisect

import torch

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
STEP = "swarm.step"
PREFIX = "swarm."
OUTSIDE = "outside swarm.step"


def _union(intervals):
    """Merged [start, end) intervals of a list, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def innermost(ranges):
    """t -> the name of the innermost of `ranges` ([(start, end, name)],
    nested as the ranges of one host thread are) open at t, or None."""
    bounds, labels, stack = [], [], []

    def mark(t):
        label = stack[-1][1] if stack else None
        if bounds and bounds[-1] == t:
            labels[-1] = label
        else:
            bounds.append(t)
            labels.append(label)

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            mark(stack.pop()[0])
        stack.append((b, name))
        mark(a)
    while stack:
        mark(stack.pop()[0])

    def at(t):
        i = bisect.bisect_right(bounds, t) - 1
        return labels[i] if i >= 0 else None
    return at


def split_events(events):
    """(device busy [(start, end)], host [(name, start, end)]) of profiler
    events (name, start, end, on_device, is_user_annotation): the device's
    kernels, copies and fills, its annotation events dropped; every host
    event."""
    device, host = [], []
    for name, a, b, on_device, annotation in events:
        if on_device:
            if not annotation:
                device.append((a, b))
        else:
            host.append((name, a, b))
    return device, host


def count_syncs(host) -> dict:
    """{span: {call: n}}: the `SYNCS` calls among host events [(name,
    start, end)] that fall inside a `swarm.step` range, each under the
    innermost program span open at its start."""
    spans = [(a, b, name) for name, a, b in host if name.startswith(PREFIX)]
    in_step = innermost([r for r in spans if r[2] == STEP])
    label = innermost(spans)
    out = {}
    for name, a, _ in host:
        if name in SYNCS and in_step(a) is not None:
            calls = out.setdefault(label(a), {})
            calls[name] = calls.get(name, 0) + 1
    return out


def idle_by_span(device, host) -> dict:
    """{span: ms}: each gap between the device's busy intervals (device
    [(start, end)] in ns) put down to the innermost program span open on
    the host at its middle (`OUTSIDE` where none is)."""
    label = innermost([(a, b, name) for name, a, b in host
                       if name.startswith(PREFIX)])
    busy = _union(device)
    out = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        where = label((start + end) / 2) or OUTSIDE
        out[where] = out.get(where, 0.0) + (start - end) * 1e-6
    return out


def _events(prof):
    """(name, start ns, end ns, on the device, is a user annotation) of
    every event torch.profiler recorded, from its raw results (building
    its FunctionEvents takes minutes at these sizes)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        yield (e.name(), a, a + e.duration_ns(),
               e.device_type() == DeviceType.CUDA,
               bool(getattr(e, "is_user_annotation", lambda: False)()))


def _tracer():
    try:
        from swarm_tpu_torch import trace
    except ImportError:
        return None
    return trace if hasattr(trace, "recording") else None


def run(ctx, state, metrics):
    from torch.profiler import ProfilerActivity, profile

    trace = _tracer()
    if ctx.dev.type != "cuda" or trace is None:
        return state, {}
    n = ctx.steps("profile")
    torch.cuda.synchronize(ctx.dev)
    trace.take()
    with trace.recording():
        for _ in range(n):
            state, _ = ctx.program.step(state)
    rec = trace.take()
    spans = [[s.name, s.parent, s.step, s.host_ms, s.device_ms]
             for s in rec.spans]

    torch.cuda.synchronize(ctx.dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording():
            for _ in range(n):
                state, _ = ctx.program.step(state)
        torch.cuda.synchronize(ctx.dev)
    trace.take()
    device, host = split_events(_events(prof))
    return state, {"steps": n, "spans": spans, "counters": rec.counters,
                   "syncs": count_syncs(host),
                   "idle_ms": idle_by_span(device, host)}
