"""sensing_ms: device-timeline ms a step spends sensing (models/sensors.
sense_4way and models/scan.sense_scan, as engine/sim calls them), the
median over the traced stretch's steps."""

from benchmark.harness import readers

PROBE = "spans"
SPANS = {"sensing": (("swarm_tpu_torch.engine.sim", "sense_4way"), ("swarm_tpu_torch.engine.sim", "sense_scan"))}


def read(record, ctx):
    return readers.step_ms(record, "sensing")
