# The JAX package's `make_mesh` and `state_specs` (a device mesh and the
# state's PartitionSpecs) have these counterparts: `make_layout` (the rank
# layout of one process per device) and `shard_state` / `gather_state`
# (each rank's rows of the state, and the whole state back).
from swarm_tpu_torch.parallel.mesh import RankLayout, make_layout  # noqa: F401
from swarm_tpu_torch.parallel.sharded import (  # noqa: F401
    agent_evidence_rows,
    gather_state,
    make_sharded_sim_step,
    shard_state,
)
