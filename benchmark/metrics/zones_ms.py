"""zones_ms: device-timeline ms of one zone snapshot (coord/zones.
zones_for_agents), the median over the zone steps of the traced stretch."""

from benchmark.harness import readers

PROBE = "spans"
SPANS = {"zones": (("swarm_tpu_torch.engine.sim", "zones_for_agents"),)}


def read(record, ctx):
    return readers.call_ms(record, "zones")
