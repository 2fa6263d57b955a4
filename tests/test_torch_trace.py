"""The step's spans and counters (`swarm_tpu_torch/trace.py`) on the CPU.

Six steps of the deployable step at 8 agents, merge every 4 steps (step 3
merges and freezes the anchor), zones every 5 (steps 0 and 5), run twice
from one initial state on one seed: tracing off, with
`torch.profiler.record_function` patched to count its calls, and tracing
on. Off, nothing is recorded and no profiler range opens; on, the state
and the step metrics are bit-equal to the untraced run's, each step has
one `swarm.step` root, every span sits under the span it belongs to and
carries its step's number, the merge's spans appear on merge steps only
and the zones' on zone steps only, and `take()` clears the records.
"""

import dataclasses

import pytest
import torch

from swarm_tpu_torch import presets, trace
from swarm_tpu_torch.engine import sim

N = 8
STEPS = 6
MERGE_EVERY = 4
ZONE_EVERY = 5          # zone_interval_s 2.0 over a 0.4 s tick
SEED = 11

PARENT = {"swarm.step": None,
          "swarm.sensing": "swarm.step", "swarm.merge": "swarm.step",
          "swarm.raster": "swarm.step", "swarm.zones": "swarm.step",
          "swarm.closure": "swarm.step", "swarm.v2v": "swarm.step",
          "swarm.merge.match": "swarm.merge",
          "swarm.merge.anchor": "swarm.merge",
          "swarm.raster.launch": "swarm.raster"}


def _leaves(tree, path=""):
    if isinstance(tree, tuple):
        for name, x in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from _leaves(x, f"{path}.{name}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _run(record: bool):
    cfg, walls, params, rooms = presets.deployable(N, device="cpu")
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 merge_every=MERGE_EVERY))
    assert round(cfg.coord.zone_interval_s / (cfg.nav.drive_tick_s +
                                              cfg.nav.settle_tick_s)) == \
        ZONE_EVERY
    step = sim.make_sim_step(cfg, walls, params,
                             torch.Generator().manual_seed(SEED),
                             walls_grouped=rooms[0], room_of_agent=rooms[1])
    state, ms = sim.sim_init(cfg, params), []
    if record:
        with trace.recording():
            for _ in range(STEPS):
                state, m = step(state)
                ms.append(m)
    else:
        for _ in range(STEPS):
            state, m = step(state)
            ms.append(m)
    return state, ms


@pytest.fixture(scope="module")
def runs():
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    torch.profiler.record_function = counting
    try:
        trace.take()
        off = _run(record=False)
        off_rec = trace.take()
        off_calls = len(calls)
        on = _run(record=True)
        on_rec = trace.take()
        again = trace.take()
    finally:
        torch.profiler.record_function = real
    return dict(off=off, off_rec=off_rec, off_calls=off_calls, on=on,
                on_rec=on_rec, on_calls=len(calls) - off_calls, again=again)


def test_tracing_off_records_nothing_and_opens_no_range(runs):
    assert runs["off_rec"].spans == [] and runs["off_rec"].counters == {}
    assert runs["off_calls"] == 0
    assert trace.span("swarm.v2v") is trace.span("swarm.zones")
    assert trace.step_span(0) is trace.span("swarm.step")


def test_tracing_on_keeps_the_result_bit_for_bit(runs):
    (s_off, m_off), (s_on, m_on) = runs["off"], runs["on"]
    a, b = list(_leaves((s_off, m_off))), list(_leaves((s_on, m_on)))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x.reshape(-1).contiguous().view(torch.uint8),
                           y.reshape(-1).contiguous().view(torch.uint8)), p
    # one profiler range a span
    assert runs["on_calls"] == len(runs["on_rec"].spans)


def test_span_tree_steps_and_cadences(runs):
    spans = runs["on_rec"].spans
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["swarm.step"] * STEPS
    assert [s.step for s in roots] == list(range(STEPS))
    for i, s in enumerate(spans):
        assert s.name in PARENT, s.name
        want = PARENT[s.name]
        if want is None:
            continue
        parent = spans[s.parent]
        assert s.parent < i and parent.name == want, (s.name, parent.name)
        assert s.step == parent.step
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.device_ms is None          # no card: host times only
    by_step = {k: {s.name for s in spans if s.step == k}
               for k in range(STEPS)}
    for k, names in by_step.items():
        merge = k % MERGE_EVERY == MERGE_EVERY - 1
        assert {"swarm.merge", "swarm.merge.match",
                "swarm.merge.anchor"} <= names if merge else \
            not any(n.startswith("swarm.merge") for n in names), k
        assert ("swarm.zones" in names) == (k % ZONE_EVERY == 0), k
        assert {"swarm.sensing", "swarm.raster", "swarm.closure",
                "swarm.v2v"} <= names
    # two merge spans on a merge step: the merge event and the anchor
    # freeze, each with its child
    assert sum(s.name == "swarm.merge" and s.step == 3 for s in spans) == 2
    # counters once a step; the allocator's are the card's alone
    assert sorted(runs["on_rec"].counters) == list(range(STEPS))
    for c in runs["on_rec"].counters.values():
        assert c == {"launches": {}}


def test_take_clears_the_records(runs):
    assert runs["on_rec"].spans
    assert runs["again"].spans == [] and runs["again"].counters == {}
