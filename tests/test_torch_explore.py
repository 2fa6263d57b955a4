"""The exploration path of the port (presets.coverage + enable_targets)
against the JAX engine at 8 agents on the 512^2 grid, which takes the
exact `frontier_clusters` route, and the other entry points this path
opens (presets.deployable with frontiers, and without a sweep).

The JAX step runs jitted with its Pallas rasters under
`torch_parity.pallas_interpret()`; the port runs its plain rasters on the
CPU.
Both start from the same state and consume the same noise (the JAX step's
own draws). Checked on frontier steps (step 0, and step 8 after eight port
steps), with `greedy_assign` and, with `assign_rooms_min_agents` lowered
to 4, with `greedy_assign_rooms`: frontier centroids and counts, targets,
`has_target` and the nav state exact; the other step metrics exact
(integers) or at atol = rtol = 1e-5 (floats); maps decision-equal (cells
differing by more than 1e-6 at most 0.01% of painted cells); writes at
rtol 1e-5. The same path under a kill schedule (agents dead past the
heartbeat timeout across frontier steps, then back) rolls out against
the JAX package's `sim_rollout` at 8 agents.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.engine import sim as js
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.engine import sim as ps
from tests.torch_parity import (assert_close, assert_exact, assert_failover,
                                assert_metrics_equal, assert_state_equal,
                                decision_equal, jax_deployable,
                                jax_fault_rollout, jax_step_noise,
                                pallas_interpret, port_fault_rollout,
                                step_keys)

N = 8
R = 181


def jax_coverage(n, frontiers=True):
    """tools/bench_coverage.py's configuration (the JAX side)."""
    from __graft_entry__ import _cfg_and_world

    return _cfg_and_world(n, frontiers=frontiers, parity=False,
                          raster_mode="beam", use_pallas=True, scan_rays=181,
                          tiled=True)


@pytest.fixture(scope="module")
def world():
    cfg_j, walls, params, rooms = jax_coverage(N)
    cfg_p, walls_p, params_p, rooms_p = presets.coverage(N, device="cpu")
    return cfg_j, walls, params, rooms, cfg_p, walls_p, params_p, rooms_p


@pytest.fixture(scope="module")
def jax_steps(world):
    """The jitted JAX step per config, compiled once for the module."""
    _, walls, params, rooms, *_ = world
    steps = {}

    def get(cfg_j):
        if cfg_j not in steps:
            steps[cfg_j] = js.make_sim_step(
                cfg_j, jnp.asarray(walls), params, enable_targets=True,
                donate=False, walls_grouped=rooms[0],
                room_of_agent=rooms[1])
        return steps[cfg_j]
    return get


@pytest.fixture(scope="module")
def state_at_8(world):
    """The state after 8 port steps (frontier event at step 0, targets
    on) from the JAX initial state, with the JAX key after those steps."""
    cfg_j, _, params, _, cfg_p, walls_p, params_p, rooms_p = world
    st0 = js.sim_init(cfg_j, params)
    st_p, key = convert.to_torch(st0, ps.SimState), st0.key
    for k in range(8):
        st_p, m = ps.sim_step(st_p, jax_step_noise(key, N, R), cfg_p,
                              walls_p, params_p, enable_targets=True,
                              walls_grouped=rooms_p[0],
                              room_of_agent=rooms_p[1], step_no=k)
        key = step_keys(key, N)[0]
    return st0, st_p, key


def test_presets_are_the_reference_configurations():
    for frontiers in (True, False):
        cfg_j, walls, params, rooms = jax_coverage(N, frontiers)
        cfg_p, walls_p, params_p, rooms_p = presets.coverage(
            N, frontiers=frontiers, device="cpu")
        assert cfg_p == convert.config_from(cfg_j)
        assert_exact(walls_p, walls)
        assert_exact(rooms_p[0], rooms[0])
        for f in ps.AgentParams._fields:
            assert_exact(getattr(params_p, f), getattr(params, f), what=f)
    e = cfg_p.engine
    assert (e.raster_4way, e.kernel_endpoints, e.endpoint_hits,
            e.beam_pack8, e.beam_groups, e.merge_every) == \
        (True, False, True, False, 0, 0)
    for kw in (dict(frontiers=True), dict(scan_rays=0)):
        assert presets.deployable(N, device="cpu", **kw)[0] == \
            convert.config_from(jax_deployable(N, **kw)[0])
    # the card run's shapes (no grid is allocated): 1024 agents, 4096^2,
    # block-pooled frontiers and per-room assignment; the coverage tool's
    # default 64 agents on 1024^2
    assert presets.coverage(1024, device="cpu")[0].grid.size == 4096
    assert presets.coverage(64, device="cpu")[0].grid.size == 1024


def _step_parity(st_j, st_p_src, key, step, cfg_p, world, step_no):
    """One step from the same state on both sides (`step` the jitted JAX
    step); returns the port's metrics and next state after the checks."""
    *_, walls_p, params_p, rooms_p = world
    with pallas_interpret():
        nxt_j, m_j = step(st_j)
    nxt_p, m_p = ps.sim_step(st_p_src, jax_step_noise(key, N, R), cfg_p,
                             walls_p, params_p, enable_targets=True,
                             walls_grouped=rooms_p[0],
                             room_of_agent=rooms_p[1], step_no=step_no)
    for f in ps.StepMetrics._fields:
        a, b = getattr(m_p, f), getattr(m_j, f)
        if f == "writes":
            np.testing.assert_allclose(int(a), int(b), rtol=1e-5)
        elif a.dtype.is_floating_point:
            assert_close(a, b, what=f"step {step_no} {f}")
        else:
            assert_exact(a, b, what=f"step {step_no} {f}")
    assert int(m_p.writes) > 0
    assert_exact(nxt_p.srv.n_frontiers, nxt_j.srv.n_frontiers)
    assert_exact(nxt_p.srv.frontier_centroids, nxt_j.srv.frontier_centroids)
    for f in ("state", "has_target", "target_x", "target_y",
              "target_age_s", "returning_home", "mission_complete"):
        assert_exact(getattr(nxt_p.nav, f), getattr(nxt_j.nav, f),
                     what=f"nav {f}")
    decision_equal(nxt_p.srv.logodds, nxt_j.srv.logodds,
                   f"step {step_no} map")
    assert_close(nxt_p.pose_true, nxt_j.pose_true)
    return m_p, nxt_p


def test_frontier_step_0_parity(world, jax_steps):
    cfg_j, _, params, _, cfg_p, *_ = world
    st_j = js.sim_init(cfg_j, params)
    m_p, nxt_p = _step_parity(st_j, convert.to_torch(st_j, ps.SimState),
                              st_j.key, jax_steps(cfg_j), cfg_p, world, 0)
    print(f"step 0: {int(m_p.n_frontiers)} frontiers, "
          f"{int(nxt_p.nav.has_target.sum())} agents with a target")


@pytest.mark.parametrize("by_room", [False, True])
def test_frontier_step_8_parity(world, state_at_8, jax_steps, by_room):
    cfg_j, *_ = world
    cfg_p = world[4]
    if by_room:     # greedy_assign_rooms in the engine (two rounds)
        cfg_j = cfg_j.replace(coord=dataclasses.replace(
            cfg_j.coord, assign_rooms_min_agents=4))
        cfg_p = cfg_p.replace(coord=dataclasses.replace(
            cfg_p.coord, assign_rooms_min_agents=4))
    st0, st_p, key = state_at_8
    st_j = jax.tree.map(jnp.asarray,
                        convert.to_numpy_like(st_p, st0)._replace(key=key))
    m_p, nxt_p = _step_parity(st_j, convert.to_torch(st_j, ps.SimState),
                              key, jax_steps(cfg_j), cfg_p, world, 8)
    assert int(m_p.n_frontiers) > 0
    assert int(nxt_p.nav.has_target.sum()) > 0
    print(f"step 8 (by room: {by_room}): {int(m_p.n_frontiers)} frontiers, "
          f"{int(nxt_p.nav.has_target.sum())} agents with a target")


@pytest.mark.parametrize("entry", ["coverage-frontiers", "coverage-walls",
                                   "bench-frontiers", "bench-ultrasonic"])
def test_entry_points_roll_out(entry):
    """Each entry point this path opens, through sim_rollout on the CPU:
    every step writes, frontiers on their cadence where they are on,
    targets assigned where asked for, no sweep noise without a sweep."""
    make, targets = {
        "coverage-frontiers": (lambda: presets.coverage(N, device="cpu"),
                               True),
        "coverage-walls": (lambda: presets.coverage(N, False, "cpu"), False),
        "bench-frontiers": (lambda: presets.deployable(
            N, device="cpu", frontiers=True), True),
        "bench-ultrasonic": (lambda: presets.deployable(
            N, device="cpu", scan_rays=0), False),
    }[entry]
    cfg, walls, params, rooms = make()
    gen = torch.Generator().manual_seed(1)
    st, m = ps.sim_rollout(ps.sim_init(cfg, params), 9, cfg, walls, params,
                           gen, enable_targets=targets,
                           walls_grouped=rooms[0], room_of_agent=rooms[1])
    assert bool((m.writes > 0).all()) and int(m.online[-1]) == N
    assert bool(torch.isfinite(st.pose_true).all())
    if cfg.engine.compute_frontiers:
        assert int(m.n_frontiers[0]) > 0 and int(m.n_frontiers[8]) > 0
    else:
        assert int(m.n_frontiers.abs().sum()) == 0
    assert (int(st.nav.has_target.sum()) > 0) == targets
    if cfg.engine.scan_rays == 0:
        noise = ps.draw_step_noise(gen, N, 0, "cpu")
        assert noise.scan is None


def test_kill_schedule_rollout_matches_jax(monkeypatch):
    """The exploration path with targets at 8 agents under
    tests/torch_parity.py's kill schedule (agent 0 and agent 3 dead past
    the heartbeat timeout, the frontier steps 8 and 16 inside the kill
    windows), FAULT_STEPS steps of the port's `sim_rollout` against the
    JAX package's on the same noise: every step metric (online counts,
    frontier counts exact; writes as the running total at rtol 1e-5), the
    failover itself, and the final state (maps decision-equal, the nav
    state's targets exact)."""
    jax_run = jax_fault_rollout(jax_coverage(N), enable_targets=True)
    final, ms = port_fault_rollout(monkeypatch, jax_run,
                                   presets.coverage(N, device="cpu"),
                                   enable_targets=True)
    final_j, ms_j = jax_run[2:]
    assert_metrics_equal(ms, ms_j, "exploration")
    assert_failover(ms, N)
    assert int(ms.n_frontiers[8]) > 0 and int(ms.n_frontiers[16]) > 0
    assert_state_equal(final, final_j, "exploration")
    assert bool(final.nav.has_target.any())
