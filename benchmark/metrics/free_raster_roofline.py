"""free_raster_roofline: the window raster kernel's share of its roofline,
in %: the least time its launches' work needs at the card's published
peaks (benchmark/harness/roofline.py: the cells that take evidence read
once, the changed cells written once and the agents' operands, at 3.35
TB/s; 116 float operations a cell that takes evidence at 67 TFLOP/s; the
larger), over their device time from torch.profiler, per launch. None when the profiler recorded no launch."""

from benchmark.harness import roofline

PROBE = "raster_bytes"


def read(record, ctx):
    if not record or not record["recorded"] or not record["launches"]:
        return None
    least, _ = roofline.least_seconds(record["bytes"] / record["launches"],
                                      record["ops"] / record["launches"])
    return 100.0 * least / (record["kernel_s"] / record["recorded"])
