"""The readers of the program's spans and counters (probes/trace_program.py
and its five metrics), on synthetic records and synthetic profiler
events: each metric's number from a record, None from an empty one; the
sync counter keeps to `swarm.step` ranges; the idle attribution drops the
device-side shadows of the program's annotations."""

from __future__ import annotations

import pytest

from benchmark.harness import spec

def _record():
    # two steps; step 1 merges; each step's raster launches one kernel
    spans = [
        ["swarm.step", None, 0, 30.0, 40.0],          # 0
        ["swarm.raster", 0, 0, 2.0, 4.0],             # 1
        ["swarm.raster.launch", 1, 0, 0.01, 1.0],     # 2
        ["swarm.v2v", 0, 0, 1.0, 12.0],               # 3
        ["swarm.step", None, 1, 34.0, 55.0],          # 4
        ["swarm.merge", 4, 1, 3.0, 14.0],             # 5
        ["swarm.merge.match", 5, 1, 2.5, 11.5],       # 6
        ["swarm.raster", 4, 1, 2.0, 5.0],             # 7
        ["swarm.raster.launch", 7, 1, 0.01, 1.5],     # 8
        ["swarm.merge", 4, 1, 0.1, 0.5],              # 9
        ["swarm.merge.anchor", 9, 1, 0.1, 0.5],       # 10
    ]
    alloc = {"num_device_alloc": 1, "num_device_free": 0,
             "num_alloc_retries": 0, "launches": {}}
    none = dict(alloc, num_device_alloc=0)
    return {"steps": 2, "spans": spans, "counters": {0: alloc, 1: none},
            "syncs": {"swarm.step": {"cudaStreamSynchronize": 1},
                      "swarm.merge.match": {"cudaMemcpy": 1,
                                            "cudaStreamSynchronize": 1}},
            "idle_ms": {"swarm.step": 3.0}}


@pytest.mark.parametrize("name,want", [
    ("host_step_ms", 32.0),
    ("host_syncs_per_step", 1.5),
    ("raster_prepare_ms", 3.25),
    ("merge_match_ms", 11.5),
    ("device_allocs_per_step", 0.5)])
def test_each_metric_reads_its_number(name, want):
    mod = spec.load_metric(name)
    assert mod.PROBE == "trace_program"
    assert mod.read(_record(), None) == pytest.approx(want)
    assert mod.read({}, None) is None


def test_device_readings_need_the_card():
    rec = _record()
    rec["counters"] = {0: {"launches": {}}, 1: {"launches": {}}}
    rec["spans"] = [s[:4] + [None] for s in rec["spans"]]
    for name in ("device_allocs_per_step", "raster_prepare_ms",
                 "merge_match_ms"):
        assert spec.load_metric(name).read(rec, None) is None, name


def _probe():
    return spec.load_probe("trace_program")


def test_syncs_count_only_inside_a_step():
    p = _probe()
    host = [("swarm.step", 100, 200), ("swarm.merge", 120, 160),
            ("swarm.merge.match", 130, 150),
            ("cudaStreamSynchronize", 140, 141),     # in the matcher
            ("cudaMemcpy", 170, 171),                # in the step's self
            ("cudaLaunchKernel", 172, 173),          # not a sync
            ("cudaDeviceSynchronize", 300, 310),     # after the step
            ("swarm.raster.launch", 400, 410),       # a span with no step
            ("cudaEventSynchronize", 405, 406),
            ("swarm.step", 500, 600),
            ("cudaEventSynchronize", 550, 551)]
    assert p.count_syncs(host) == {
        "swarm.merge.match": {"cudaStreamSynchronize": 1},
        "swarm.step": {"cudaMemcpy": 1, "cudaEventSynchronize": 1}}


def test_idle_attribution_drops_the_annotations_shadows():
    p = _probe()
    events = [
        ("swarm.step", 0, 1000, False, True),
        ("swarm.v2v", 600, 900, False, True),
        ("aten::add", 610, 620, False, False),
        # the device: two kernels with a gap in the step's self time, and
        # one with a gap inside the V2V span
        ("kernel_a", 100, 300, True, False),
        ("kernel_b", 400, 700, True, False),
        ("kernel_c", 800, 850, True, False),
        # the annotation's device-side shadow covers both gaps
        ("swarm.step", 100, 850, True, True),
        ("kernel_d", 1200, 1300, True, False),
    ]
    device, host = p.split_events(events)
    assert (100, 850) not in device and len(device) == 4
    idle = p.idle_by_span(device, host)
    assert idle == pytest.approx({"swarm.step": 100e-6,
                                  "swarm.v2v": 100e-6,
                                  p.OUTSIDE: 350e-6})


def test_innermost_follows_nesting():
    at = _probe().innermost([(0, 100, "a"), (10, 20, "b"), (12, 15, "c"),
                             (30, 40, "d"), (200, 300, "e")])
    assert [at(t) for t in (-1, 5, 11, 13, 16, 25, 35, 50, 150, 250,
                            400)] == [None, "a", "b", "c", "b", "a", "d",
                                      "a", None, "e", None]


def test_off_the_card_the_record_is_empty():
    import torch

    from benchmark.harness.trace import Context

    ctx = Context(cell=None, program=None, sides=None,
                  dev=torch.device("cpu"))
    assert _probe().run(ctx, "state", []) == ("state", {})
