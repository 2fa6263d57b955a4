"""The traced run (`--trace 1`): one stretch of steps under each probe
that the cell's per-layer metrics name, then each metric's reader.

A probe (`benchmark/probes/<name>.py`) drives its stretch of steps through
the program's step closure with its instrument on, and returns a record;
a metric (`benchmark/metrics/<name>.py`) reads its number from its
probe's record, or None when the record holds nothing for it (the metric
is then left out of the line). Stretches run one after another, in the
order of the probes' names, each on the state the last one left; the
untraced run installs none of them.
"""

from __future__ import annotations

from typing import NamedTuple

from benchmark.harness import spec


class Context(NamedTuple):
    cell: object
    program: object
    sides: object
    dev: object

    def steps(self, probe: str) -> int:
        return int(self.cell.traffic["trace_steps"][probe])


def run_traced(cell, program, state, sides, dev):
    """(state, {metric: {"value", "unit"}}, extra): extra holds what the
    probes give the result line (`device`: busy_s, window_s; `breakdown`)."""
    mods = {m["name"]: (m, spec.load_metric(m["name"], cell.root))
            for m in cell.per_layer}
    by_probe = {}
    for name, (_, mod) in mods.items():
        by_probe.setdefault(mod.PROBE, []).append(mod)
    ctx = Context(cell=cell, program=program, sides=sides, dev=dev)
    records, extra = {}, {}
    for probe_name in sorted(by_probe):
        probe = spec.load_probe(probe_name, cell.root)
        state, records[probe_name] = probe.run(ctx, state,
                                               by_probe[probe_name])
        for key, value in getattr(probe, "result_keys",
                                  lambda r: {})(records[probe_name]).items():
            extra.setdefault(key, {}).update(value)
    metrics = {}
    for name, (entry, mod) in mods.items():
        value = mod.read(records[mod.PROBE], ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    return state, metrics, extra
