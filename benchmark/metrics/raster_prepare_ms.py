"""raster_prepare_ms: device-timeline ms a step spends in the raster
wrapper outside its kernel launches: the program's `swarm.raster` span
less its `swarm.raster.launch` children (the windows, the tables, the
tile pairs' sort and the count reduction), the median over the steps of a
whole period of the step cadences (probes/trace_program.py's stretch
(a))."""

import statistics

PROBE = "trace_program"


def read(record, ctx):
    spans = (record or {}).get("spans", ())
    per_step = {}
    for name, parent, step, _, dev_ms in spans:
        if dev_ms is None:          # recorded off the card
            return None
        if name == "swarm.raster":
            per_step[step] = per_step.get(step, 0.0) + dev_ms
        elif name == "swarm.raster.launch" and parent is not None and \
                spans[parent][0] == "swarm.raster":
            per_step[step] = per_step.get(step, 0.0) - dev_ms
    return statistics.median(per_step.values()) if per_step else None
