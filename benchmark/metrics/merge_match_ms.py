"""merge_match_ms: device-timeline ms of the scan matcher in one merge
event (the program's `swarm.merge.match` span around slam/livemerge.
scan_merge_recover), the median over the merge events of a whole period of
the step cadences (probes/trace_program.py's stretch (a))."""

import statistics

PROBE = "trace_program"


def read(record, ctx):
    ms = [s[4] for s in (record or {}).get("spans", ())
          if s[0] == "swarm.merge.match" and s[4] is not None]
    return statistics.median(ms) if ms else None
