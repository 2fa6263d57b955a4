"""torch_ops_per_step: the torch operations one step dispatches (each a
launch or a few on the card), counted over the traced stretch (an 80-step
stretch holds every step kind in its share), divided by its steps."""

PROBE = "dispatch"


def read(record, ctx):
    return record["ops"] / record["steps"]
