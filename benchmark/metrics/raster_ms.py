"""raster_ms: device-timeline ms a step spends in the raster wrapper
(engine/sim._raster_fans: the tables, the window placement and the
free_raster kernel), the median over the traced stretch's steps."""

from benchmark.harness import readers

PROBE = "spans"
SPANS = {"raster": (("swarm_tpu_torch.engine.sim", "_raster_fans"),)}


def read(record, ctx):
    return readers.step_ms(record, "raster")
