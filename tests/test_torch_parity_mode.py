"""The reference-parity path (EngineConfig's default `parity_mode=True`),
port against the JAX package on the CPU.

1. `presets.dual_bot` against `run_session --preset dual_bot`'s config,
   walls and agents (swarm_tpu/cli/run_session.py:114-118).
2. `ops/raster.parity_raster` against the jitted JAX function on the same
   RayBatch: rays leaving the grid (where the reference's flat index may
   alias a cell inside it), inactive rays, untrusted ends, cells written by
   many rays. The int8 grid and the writes exactly equal.
3. `slam/closure.closure_add_poses_seq` against JAX's `lax.scan` of
   `closure_add_pose` over 70 packets (the parity step's closure), 5 steps,
   dense landmark codes (sparse ones for same-agent matching on the small
   ring), dead packets, a 16-slot ring (it wraps several
   times inside a step) with an 8-node closure gap (packets of one step
   close on each other) and a 128-slot ring with the default 30, both
   `closure_same_agent_only` settings. Every field of the state and the
   closed flags exactly equal.
4. One-step sim parity over 4 consecutive steps in parity mode: the
   untiled world without a sweep (`_cfg_and_world(n, parity=True)`) and
   `dual_bot` (frontiers on the int8 grid): StepMetrics integers exact,
   floats at atol = rtol = 1e-5, the int8 grid exactly equal.
5. A free-running `dual_bot` rollout of 200 steps, each side stepping its
   own state on the JAX step's noise: tri-state agreement >= 99% over the
   explored cells, closures equal, both agents online.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import EngineConfig, SlamConfig, SwarmConfig
from swarm_tpu.engine import sim as js
from swarm_tpu.geom.world import BEDROOM_WALLS
from swarm_tpu.ops import raster as jraster
from swarm_tpu.slam import closure as jcl
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.config import SlamConfig as PortSlamConfig
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.ops import raster as praster
from swarm_tpu_torch.slam import closure as pcl
from tests.torch_parity import (assert_close, assert_exact, jax_step_noise,
                                jax_untiled, step_keys, t)

N = 8
GRID = GridConfig()                       # the reference's 200^2 at (-5, -5)


def _jax_dual_bot(separation=5.0, frontiers=True):
    cfg = SwarmConfig(n_agents=2, engine=EngineConfig(
        compute_frontiers=frontiers))
    return cfg, BEDROOM_WALLS, js.make_agent_params(2, separation, cfg=cfg)


def test_dual_bot_is_the_reference_session():
    for sep, fr in ((5.0, True), (3.0, False)):
        cfg_p, walls_p, params_p, rooms_p = presets.dual_bot(
            sep, fr, device="cpu")
        cfg_j, walls_j, params_j = _jax_dual_bot(sep, fr)
        assert cfg_p == convert.config_from(cfg_j)
        assert cfg_p.engine.parity_mode and cfg_p.engine.raster_mode == "line"
        assert_exact(walls_p, walls_j)
        for f in ps.AgentParams._fields:
            assert_exact(getattr(params_p, f), getattr(params_j, f), what=f)
        assert rooms_p == (None, None)
    # _cfg_and_world(1024, parity=True)'s counterpart on the untiled world
    cfg_k = presets.untiled(1024, raster_mode="line", scan_rays=0,
                            device="cpu")[0]
    cfg_k = cfg_k.replace(engine=dataclasses.replace(cfg_k.engine,
                                                     parity_mode=True))
    assert cfg_k == convert.config_from(jax_untiled(
        1024, "line", scan_rays=0, parity=True)[0])


@functools.lru_cache(maxsize=None)
def _jax_parity():
    cfg = jraster.GridConfig()
    return jax.jit(lambda g, rays: jraster.parity_raster(g, rays, cfg))


def test_parity_raster_matches_jax(rng):
    n = 900
    ox = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    oy = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    ox[:300], oy[:300] = 0.3, -0.2        # many rays through the same cells
    ang = rng.uniform(-math.pi, math.pi, n)
    rr = rng.uniform(0.0, 1.6, n)
    hx = (ox + rr * np.cos(ang)).astype(np.float32)
    hy = (oy + rr * np.sin(ang)).astype(np.float32)
    # rays leaving the grid on every side, and starting outside it
    hx[300:340] = rng.uniform(-6.5, -4.9, 40)
    hy[340:380] = rng.uniform(4.9, 6.5, 40)
    hx[380:420] = rng.uniform(4.9, 6.5, 40)
    ox[420:440], oy[420:440] = -5.4, rng.uniform(-4.0, 4.0, 20)
    hv = rng.uniform(size=n) > 0.3
    act = rng.uniform(size=n) > 0.1
    g = rng.choice(np.array([-1, 0, 100], np.int8), (200, 200))
    ref, w_j = _jax_parity()(jnp.asarray(g), jraster.RayBatch(
        *(jnp.asarray(x) for x in (ox, oy, hx, hy, hv, act))))
    got, w_p = praster.parity_raster(torch.from_numpy(g.copy()),
                                     praster.RayBatch(*(t(x) for x in (
                                         ox, oy, hx, hy, hv, act))), GRID)
    assert got.dtype == torch.int8
    assert_exact(got, ref)
    assert int(w_p) == int(w_j) > 0
    assert int((np.asarray(ref) != g).sum()) > 100


M = 70
STEPS = 5


@functools.lru_cache(maxsize=None)
def _jax_closure_scan(same_agent: bool, ring: int, gap: int):
    cfg = SlamConfig(landmark_capacity=ring, min_poses_between=gap,
                     closure_same_agent_only=same_agent)

    def scan(cl, xs, ys, agents, lm, valid):
        def one(c, pkt):
            px, py, pa, plm, pv = pkt
            c, closed, _, _ = jcl.closure_add_pose(c, px, py, pa, plm, cfg,
                                                   valid=pv)
            return c, closed
        return jax.lax.scan(one, cl, (xs, ys, agents, lm, valid))
    return cfg, jax.jit(scan)


@pytest.mark.parametrize("ring,gap", [(16, 8), (128, 30)])
@pytest.mark.parametrize("same_agent", [False, True])
def test_sequential_closure_matches_the_scan(rng, same_agent, ring, gap):
    cfg_j, scan = _jax_closure_scan(same_agent, ring, gap)
    cfg = convert.config_from(cfg_j, PortSlamConfig)
    st_j = jcl.closure_init(M, cfg_j)
    st_p = convert.to_torch(st_j, pcl.ClosureState)
    home = rng.uniform(-1.0, 1.0, (M, 2))
    home[M // 2:] = home[:M - M // 2]     # pairs of agents share a spot
    agents = np.arange(M, dtype=np.int32)
    # an agent closes on its own landmark of an earlier step only if fewer
    # stores than the ring holds came between: sparse codes of one type on
    # the small ring with same-agent matching
    codes = ([0.8, 0.2, 0.0, 0.0, 0.0] if same_agent and ring == 16
             else [0.1, 0.3, 0.3, 0.2, 0.1])
    n_closed = 0
    for k in range(STEPS):
        xy = (home + rng.normal(0, 0.15, (M, 2))).astype(np.float32)
        lm = rng.choice(np.array([0, 1, 2, 3, 4], np.int32), M,
                        p=codes)
        valid = rng.uniform(size=M) > 0.1
        st_j, closed_j = scan(st_j, jnp.asarray(xy[:, 0]),
                              jnp.asarray(xy[:, 1]), jnp.asarray(agents),
                              jnp.asarray(lm), jnp.asarray(valid))
        st_p, closed_p, _, _ = pcl.closure_add_poses_seq(
            st_p, t(xy[:, 0]), t(xy[:, 1]), t(agents), t(lm), cfg,
            valid=t(valid))
        assert_exact(closed_p, closed_j, what=f"step {k} closed")
        for f in pcl.ClosureState._fields:
            assert_exact(getattr(st_p, f), getattr(st_j, f),
                         what=f"step {k} {f}")
        n_closed += int(np.asarray(closed_j).sum())
    print(f"closures over {STEPS} steps: {n_closed}; landmarks stored "
          f"{int(st_p.lm_count)} on a ring of {ring}")
    assert n_closed >= 5 and int(st_p.lm_count) > ring


PARITY_WORLDS = ("untiled", "dual_bot")


def _world(which):
    if which == "dual_bot":
        cfg_j, walls, params = _jax_dual_bot()
        rooms = (None, None)
        port = presets.dual_bot(device="cpu")
    else:
        cfg_j, walls, params, rooms = jax_untiled(N, "line", scan_rays=0,
                                                  parity=True)
        port = presets.untiled(N, raster_mode="line", scan_rays=0,
                               device="cpu")
        port = (port[0].replace(engine=dataclasses.replace(
            port[0].engine, parity_mode=True)),) + port[1:]
    return cfg_j, walls, params, rooms, port


@functools.lru_cache(maxsize=None)
def _jax_step(which):
    cfg_j, walls, params, rooms, _ = _world(which)
    return js.make_sim_step(cfg_j, jnp.asarray(walls), params, donate=False,
                            walls_grouped=rooms[0], room_of_agent=rooms[1])


@pytest.mark.parametrize("which", PARITY_WORLDS)
def test_one_step_parity(which):
    cfg_j, walls, params, rooms, port = _world(which)
    cfg, walls_p, params_p, rooms_p = port
    assert cfg == convert.config_from(cfg_j)
    step = _jax_step(which)
    st_j = js.sim_init(cfg_j, params)
    n = cfg.n_agents
    for k in range(4):
        st_p = convert.to_torch(st_j, ps.SimState)
        nxt_p, m_p = ps.sim_step(st_p, jax_step_noise(st_j.key, n, 0), cfg,
                                 walls_p, params_p, walls_grouped=rooms_p[0],
                                 room_of_agent=rooms_p[1])
        st_j, m_j = step(st_j)
        for f in ps.StepMetrics._fields:
            a, b = getattr(m_p, f), getattr(m_j, f)
            if a.dtype.is_floating_point:
                assert_close(a, b, what=f"step {k} {f}")
            else:
                assert_exact(a, b, what=f"step {k} {f}")
        assert int(m_p.writes) > 0
        assert_exact(nxt_p.srv.grid, st_j.srv.grid, what=f"step {k} grid")
        assert torch.equal(nxt_p.srv.logodds, st_p.srv.logodds)
        for f in pcl.ClosureState._fields:
            assert_exact(getattr(nxt_p.srv.closure, f),
                         getattr(st_j.srv.closure, f), what=f)
        assert_close(nxt_p.pose_true, st_j.pose_true)
    assert int(m_j.online) == n


def test_dual_bot_free_running_rollout():
    cfg_j, walls, params, rooms, port = _world("dual_bot")
    cfg, walls_p, params_p, _ = port
    step = _jax_step("dual_bot")
    st_j = js.sim_init(cfg_j, params)
    st_p = convert.to_torch(st_j, ps.SimState)
    key = st_j.key
    closed_j = closed_p = 0
    for k in range(200):
        st_p, m_p = ps.sim_step(st_p, jax_step_noise(key, 2, 0), cfg,
                                walls_p, params_p, step_no=k)
        key = step_keys(key, 2)[0]
        st_j, m_j = step(st_j)
        closed_j += int(m_j.closures)
        closed_p += int(m_p.closures)
    g = cfg.grid
    tri_j, tri_p = np.asarray(st_j.srv.grid), st_p.srv.grid.numpy()
    explored = (tri_j != g.unknown) | (tri_p != g.unknown)
    agree = ((tri_j == tri_p) & explored).sum() / max(explored.sum(), 1)
    print(f"dual_bot 200 steps: tri-state agreement {agree:.5f} over "
          f"{int(explored.sum())} explored cells; free "
          f"{int((tri_p == g.free).sum())} / {int((tri_j == g.free).sum())},"
          f" occupied {int((tri_p == g.occupied).sum())} / "
          f"{int((tri_j == g.occupied).sum())}; closures {closed_p} / "
          f"{closed_j}")
    assert agree >= 0.99
    assert closed_p == closed_j
    assert int(m_p.online) == int(m_j.online) == 2
    assert int((tri_p == g.free).sum()) > 500
    assert int((tri_p == g.occupied).sum()) > 20
