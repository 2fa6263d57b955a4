"""The sharded engine under the kill schedule, the port against the JAX
package on the CPU (the fused paths are in tests/test_torch_faults.py).

`make_sharded_sim_step(..., faults=)` on one gloo rank, "replicated" and
"tiles" (a 1x1 rank grid; "tiles" needs the 512^2 grid of 8 agents), for
FAULT_STEPS steps of the deployable preset under tests/torch_parity.py's
`KILLS` (agent 0 and agent 3 dead past the 5 s heartbeat timeout, across
the merge step 15, both back by step 17), against the JAX package's
sharded step ("replicated", a 1-device mesh) on the same schedule and the
same noise, its Pallas raster in interpret mode, compiled once for the
module. On one rank "tiles" paints the map "replicated" paints, up to the
float shift of ROADMAP C22, so both are held to the one JAX run.

Bars (ROADMAP's North star): online counts, closures, merges and every
integer exact; the map decision-equal (cells differing by > 1e-6 in at
most 0.01% of the painted cells); writes rtol 1e-5 (the running total:
the merge step moves one cell on a C9 edge, with or without faults);
poses, the closure ring's floats and the other metrics atol = rtol =
1e-5.
"""

import functools
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from swarm_tpu.engine import sim as js
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step
from swarm_tpu.parallel import shard_state as jax_shard_state
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.parallel import mesh, sharded
from tests.torch_parity import (FAULT_STEPS, assert_close, assert_exact,
                                assert_failover, assert_metrics_equal,
                                decision_equal, jax_deployable, jax_step_noise,
                                kill_schedules, pallas_interpret, step_keys)

N = 8
R = 181


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group for the module."""
    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0,
              timedelta(seconds=120), device="cpu")
    yield
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _jax_sharded():
    """FAULT_STEPS steps of the JAX package's sharded step ("replicated",
    a 1-device mesh) under the kill schedule: (initial state, each step's
    noise as the port takes it, stacked metrics, final state), numpy."""
    cfg, walls, params, rooms = jax_deployable(N)
    m = make_mesh(1)
    step = make_sharded_sim_step(
        cfg, walls, params, m, faults=kill_schedules()[0], donate=False,
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    st0 = js.sim_init(cfg, params)
    st = jax_shard_state(st0, m)
    key, noises, metrics = st0.key, [], []
    with pallas_interpret():
        for _ in range(FAULT_STEPS):
            noises.append(jax_step_noise(key, N, R))
            key = step_keys(key, N)[0]
            st, mj = step(st)
            metrics.append(jax.tree.map(np.asarray, mj))
    ms = jax.tree.map(lambda *x: np.stack(x), *metrics)
    return st0, noises, ms, jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("grid_sharding", ["replicated", "tiles"])
def test_sharded_step_under_the_schedule_matches_jax(group, grid_sharding):
    st0_j, noises, ms_j, final_j = _jax_sharded()
    cfg, walls, params, rooms = presets.deployable(N, device="cpu")
    lay = mesh.make_layout((1, 1), device="cpu")
    step = sharded.make_sharded_sim_step(
        cfg, walls, params, lay, faults=kill_schedules()[1],
        grid_sharding=grid_sharding, walls_grouped=rooms[0],
        room_of_agent=rooms[1])
    st = sharded.shard_state(convert.to_torch(st0_j, ps.SimState), lay,
                             grid_sharding)
    ms = []
    for k in range(FAULT_STEPS):
        st, m = step(st, noises[k])
        ms.append(m)
    ms = ps.StepMetrics(*(torch.stack(f) for f in zip(*ms)))
    assert_metrics_equal(ms, ms_j, grid_sharding)
    assert_failover(ms, N)
    assert int(ms.merges[15]) > 0
    decision_equal(st.srv.logodds, final_j.srv.logodds,
                   f"{grid_sharding} map")
    assert_close(st.pose_true, final_j.pose_true, what="poses")
    for f in st.srv.closure._fields:
        a, b = getattr(st.srv.closure, f), getattr(final_j.srv.closure, f)
        if a.dtype.is_floating_point:
            assert_close(a, b, what=f"closure {f}")
        else:
            assert_exact(a, b, what=f"closure {f}")
    for f in ("last_packet_t", "pkt_counts", "zone_active"):
        assert_exact(getattr(st.srv, f), getattr(final_j.srv, f), what=f)
    np.testing.assert_allclose(ps.total_writes_value(st.srv.total_writes),
                               int(ms_j.writes.sum()), rtol=1e-5)
