"""device_idle_pct: the share of a stretch of steps in which no kernel,
copy or fill runs on the card: 1 - the device's busy time (torch.profiler
recording the device alone) over the host-clock length of a stretch of as
many steps with no profiler, which recording slows. Both stretches span a
whole period of the step cadences (probes/profile.py)."""

PROBE = "profile"


def read(record, ctx):
    if not record or record["plain_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["plain_s"])
