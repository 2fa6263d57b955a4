"""merge_ms: device-timeline ms of one merge event (engine/sim._merge_event:
slam/livemerge and slam/scanmatch), the median over the merge steps of
the traced stretch."""

from benchmark.harness import readers

PROBE = "spans"
SPANS = {"merge": (("swarm_tpu_torch.engine.sim", "_merge_event"),)}


def read(record, ctx):
    return readers.call_ms(record, "merge")
