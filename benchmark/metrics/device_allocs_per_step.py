"""device_allocs_per_step: the times the caching allocator went to the
device (its `num_device_alloc` plus `num_device_free`, deltas across each
of the program's `swarm.step` spans) per step, over a whole period of the
step cadences (probes/trace_program.py's stretch (a))."""

PROBE = "trace_program"
KEYS = ("num_device_alloc", "num_device_free")


def read(record, ctx):
    counters = (record or {}).get("counters", {})
    if not counters or any(k not in c for c in counters.values()
                           for k in KEYS):
        return None
    return sum(c[k] for c in counters.values() for k in KEYS) / \
        len(counters)
