"""v2v_ms: device-timeline ms of one call of the pairwise V2V statistics
(engine/sim.v2v_stats), the median over the traced stretch's steps."""

from benchmark.harness import readers

PROBE = "spans"
SPANS = {"v2v": (("swarm_tpu_torch.engine.sim", "v2v_stats"),)}


def read(record, ctx):
    return readers.call_ms(record, "v2v")
