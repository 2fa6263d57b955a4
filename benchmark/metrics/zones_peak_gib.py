"""zones_peak_gib: the most device memory allocated while a zone snapshot
(coord/zones.zones_for_agents) runs, in GiB, over the traced stretch (the
allocator's peak reset before each wrapped call, as profile_step.
step_split reads it)."""

from benchmark.harness import readers

PROBE = "spans"
SPANS = {"zones": (("swarm_tpu_torch.engine.sim", "zones_for_agents"),)}
PEAK = True


def read(record, ctx):
    peak = readers.peak_bytes(record, "zones")
    return None if peak is None else peak / 2 ** 30
