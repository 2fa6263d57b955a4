from swarm_tpu_torch.coord.zones import ZoneState, zone_init, zone_observe, zones_for_agents  # noqa: F401
from swarm_tpu_torch.coord.heartbeat import heartbeat_update  # noqa: F401
from swarm_tpu_torch.coord.assign import greedy_assign  # noqa: F401
