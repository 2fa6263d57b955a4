from swarm_tpu_torch.engine.replay import (  # noqa: F401
    PacketStream,
    ReplayOutputs,
    ServerState,
    replay_session,
    server_init,
)
from swarm_tpu_torch.engine.sim import (  # noqa: F401
    AgentParams,
    FaultSchedule,
    MapState,
    SimState,
    StepMetrics,
    make_agent_params,
    make_sim_step,
    no_faults,
    sim_init,
    sim_rollout,
    sim_step,
)
