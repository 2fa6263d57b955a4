"""host_step_ms: host-clock ms the program takes to enqueue one step, the
median over a whole period of the step cadences of its own `swarm.step`
span (swarm_tpu_torch/trace.py; probes/trace_program.py's stretch (a),
tracing on, no profiler). Beside the step's period on the device timeline,
it says how far the host paces the step."""

import statistics

PROBE = "trace_program"


def read(record, ctx):
    ms = [s[3] for s in (record or {}).get("spans", ())
          if s[0] == "swarm.step"]
    return statistics.median(ms) if ms else None
