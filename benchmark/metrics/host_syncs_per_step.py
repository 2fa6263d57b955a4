"""host_syncs_per_step: device-to-host syncs (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy) the host calls
inside the program's `swarm.step` range, per step, from torch.profiler's
host events over a whole period of the step cadences (probes/
trace_program.py's stretch (b)); the record says under which span each
call was made."""

PROBE = "trace_program"


def read(record, ctx):
    if not record or "syncs" not in record:
        return None
    return sum(n for calls in record["syncs"].values()
               for n in calls.values()) / record["steps"]
