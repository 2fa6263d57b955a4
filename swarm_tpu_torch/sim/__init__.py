from swarm_tpu_torch.sim.scenario import (  # noqa: F401
    ScenarioResult,
    generate_dual_session,
    generate_session,
    interpolate_waypoints,
    perimeter_sweep_waypoints,
)
