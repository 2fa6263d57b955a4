"""closure_ms: device-timeline ms of one call of the closure's batched
landmark match (slam/closure.closure_add_poses_batch), the median over
the traced stretch's steps."""

from benchmark.harness import readers

PROBE = "spans"
SPANS = {"closure": (("swarm_tpu_torch.engine.sim", "closure_add_poses_batch"),)}


def read(record, ctx):
    return readers.call_ms(record, "closure")
