"""Spans and counters inside the swarm step: off unless switched on.

    from swarm_tpu_torch import trace

    with trace.recording():
        for _ in range(80):
            state, m = step(state)
    rec = trace.take()      # Trace(spans, counters); the records are cleared

Off (the default), `span(name)` checks one module global and returns a
shared null context: no CUDA event, no profiler range, no allocation, no
torch operation. On, each span records its name, its parent, the step it
belongs to, its host start and end (`time.perf_counter_ns`), on the card a
pair of CUDA events (read by `take()`, never inside a step), and a
`torch.profiler.record_function` range, so that a torch.profiler trace
taken meanwhile carries the span on the profiler's clock, beside the
kernels it enqueued. The step's root span (`step_span`) also keeps the
step's counters: on the card the caching allocator's device allocations,
frees and retries (`torch.cuda.memory_stats`' `num_device_alloc`,
`num_device_free`, `num_alloc_retries`, deltas across the step), and the
kernels' launches by form (deltas of the wrappers' `launches_by_form`:
the three rasters' and V2V's, `v2v_stats`). Tracing on or off, the step
computes the same result bit for bit.

Spans of the deployable step (`engine/sim.make_sim_step`):
  swarm.step              the step closure, from the noise draw to the return
    swarm.sensing         the 4-way fan and the servo sweep
    swarm.merge           merge steps only: the merge event; the anchor freeze
      swarm.merge.match   the scan matcher (`livemerge.scan_merge_recover`)
      swarm.merge.anchor  the anchor freeze
    swarm.raster          the map's raster of the configured mode
      swarm.raster.launch a raster kernel's launch (`ops/*_cuda._launch`)
    swarm.zones           the zone snapshot, on its cadence
    swarm.closure         the closure's landmark match
    swarm.v2v             the pairwise radio statistics
Navigation, physics, odometry and the EKF are `swarm.step`'s self time: its
duration less what its child spans cover. The sharded engine opens no step
span; the matcher and the kernels it shares with this engine record theirs
without a parent.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

STEP = "swarm.step"
ALLOCATOR = ("num_device_alloc", "num_device_free", "num_alloc_retries")

_NULL = contextlib.nullcontext()
_on = False          # spans record
_cuda = False        # spans carry CUDA events, steps the allocator's counts
_open = []           # indices of the open spans, innermost last
_rows = []           # [name, parent, step, t0, t1, e0, e1] in opening order
_counters = {}       # step -> counters of that step


class Span(NamedTuple):
    name: str
    parent: Optional[int]     # index in Trace.spans of the enclosing span
    step: Optional[int]       # the engine's step number, shared by its spans
    start_ns: int             # host clock (time.perf_counter_ns)
    end_ns: int
    device_ms: Optional[float]  # between the span's CUDA events; None off
    #                             the card

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Trace(NamedTuple):
    spans: list               # Span, in the order they opened
    counters: dict            # step -> {"num_device_alloc": n, ... (on the
    #                           card), "launches": {kernel: {form: n}}}


def _launch_counts() -> dict:
    from swarm_tpu_torch.ops.beam_raster_cuda import free_raster
    from swarm_tpu_torch.ops.exact_raster_cuda import beam_raster
    from swarm_tpu_torch.ops.room_raster_cuda import room_raster
    from swarm_tpu_torch.ops.v2v_cuda import v2v_stats

    return {fn.__name__: dict(fn.launches_by_form)
            for fn in (free_raster, room_raster, beam_raster, v2v_stats)}


def _counts() -> dict:
    out = {"launches": _launch_counts()}
    if _cuda:
        stats = torch.cuda.memory_stats_as_nested_dict()
        out.update((k, stats.get(k, 0)) for k in ALLOCATOR)
    return out


def _delta(before: dict, after: dict) -> dict:
    out = {k: after[k] - before[k] for k in ALLOCATOR if k in after}
    out["launches"] = {}
    for kernel, forms in after["launches"].items():
        was = before["launches"][kernel]
        moved = {f: n - was.get(f, 0) for f, n in forms.items()
                 if n != was.get(f, 0)}
        if moved:
            out["launches"][kernel] = moved
    return out


class _Span:
    __slots__ = ("name", "step", "counts", "index", "range", "before")

    def __init__(self, name: str, step: Optional[int], counts: bool):
        self.name, self.step, self.counts = name, step, counts

    def __enter__(self):
        parent = _open[-1] if _open else None
        step = self.step
        if step is None and parent is not None:
            step = _rows[parent][2]
        self.index = len(_rows)
        row = [self.name, parent, step, 0, 0, None, None]
        _rows.append(row)
        _open.append(self.index)
        if self.counts:
            self.before = _counts()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if _cuda:
            row[5] = torch.cuda.Event(enable_timing=True)
            row[5].record()
        row[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        row = _rows[self.index]
        row[4] = time.perf_counter_ns()
        if _cuda:
            row[6] = torch.cuda.Event(enable_timing=True)
            row[6].record()
        self.range.__exit__(*exc)
        if self.counts:
            _counters[row[2]] = _delta(self.before, _counts())
        _open.pop()
        return False


def span(name: str):
    """A span named `name` around a block: a shared null context while
    tracing is off."""
    if not _on:
        return _NULL
    return _Span(name, None, False)


def step_span(step: int):
    """The root span of step `step` (`swarm.step`), which also keeps the
    step's counters: a shared null context while tracing is off."""
    if not _on:
        return _NULL
    return _Span(STEP, step, True)


@contextlib.contextmanager
def recording():
    """Tracing on for the block. Where this process has initialised CUDA,
    as a program stepping on the card has, spans carry CUDA events and
    steps the allocator's counts."""
    global _on, _cuda
    was = _on, _cuda
    _on = True
    _cuda = torch.cuda.is_initialized()
    try:
        yield
    finally:
        _on, _cuda = was


def take() -> Trace:
    """The spans and counters recorded so far, each span's device time
    read from its events (this waits for the card), and the records
    cleared. Called outside every span."""
    if _open:
        raise RuntimeError(f"take() inside the open span "
                           f"{_rows[_open[-1]][0]}")
    rows, counters = list(_rows), dict(_counters)
    _rows.clear()
    _counters.clear()
    if any(r[5] is not None for r in rows):
        torch.cuda.synchronize()
    spans = [Span(name, parent, step, t0, t1,
                  None if e0 is None else e0.elapsed_time(e1))
             for name, parent, step, t0, t1, e0, e1 in rows]
    return Trace(spans=spans, counters=counters)
