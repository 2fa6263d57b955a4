"""The untiled world's rasters (bench.py --raster line, --no-pallas) and the
profiling mode, port against the JAX package on the CPU.

1. The presets: `presets.untiled` (line raster, XLA beam tier, bf16) and
   `presets.swarm` field for field against `_cfg_and_world(..., tiled=False)`
   with bench.py's changes, up to 1024 agents (a 3840^2 grid; config only);
   `make_multi_room` and `BEDROOM_WALLS` exactly equal.
2. The XLA beam tier (`ops/beam_raster.beam_raster_reference`) against the
   jitted JAX function on both fans, float32 and bfloat16: 8 agents spread
   over a 512^2 grid, and 16 agents on one point over a grid pre-filled
   near +-clamp with -0.0 and NaN cells. Maps decision-equal (cells
   differing by > 1e-6 at most 0.01% of the changed cells), NaN cells and
   the sign of every zero cell equal, writes within the same bar.
3. `ops/raster.ordered_add`: bit-equal to an agent-by-agent loop of patch
   adds, float32 and bfloat16, with overlapping patches, -0.0 and NaN cells.
4. `ops/raster.logodds_raster` against the jitted JAX function: writes
   exact, maps decision-equal.
5. One-step sim parity over 4 consecutive steps (8 agents, 512^2 untiled
   world, 181-beam sweep) on the line raster (with and without the
   sweep), the XLA tier on float32 and bfloat16, and the profiling mode
   (with frontiers, read from the int8 grid): StepMetrics integers exact
   (the XLA tier's writes within the decision bar), floats at atol = rtol
   = 1e-5, maps decision-equal; with the sweep's line rays at most 1% of
   the painted cells differ (ROADMAP C9, C14: see the test).

The JAX functions run under `jax.jit` (ROADMAP C15), each compiled once per
module.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.engine import sim as js
from swarm_tpu.geom import world as jworld
from swarm_tpu.ops import beam_raster as jbr
from swarm_tpu.ops import raster as jraster
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.geom import world as pworld
from swarm_tpu_torch.ops import beam_raster as pbr
from swarm_tpu_torch.ops import raster as praster
from tests.torch_parity import (assert_close, assert_exact, decision_equal,
                                f32, jax_step_noise, jax_untiled, t)
from tests.torch_parity import torch_one_thread  # noqa: F401

N = 8
R = 181
GRID = GridConfig(size=512, origin_x=-3.0, origin_y=-4.0)


def test_presets_are_the_reference_presets():
    for kw in (dict(raster_mode="line"), dict(raster_mode="beam"),
               dict(raster_mode="beam", grid_dtype="bfloat16"),
               dict(raster_mode="line", scan_rays=0),
               dict(raster_mode="beam", frontiers=True, merge_every=0)):
        cfg_p, walls_p, params_p, rooms_p = presets.untiled(N, device="cpu",
                                                            **kw)
        cfg_j, walls_j, params_j, rooms_j = jax_untiled(N, **kw)
        assert cfg_p == convert.config_from(cfg_j), kw
        assert_exact(walls_p, walls_j)
        for f in ps.AgentParams._fields:
            assert_exact(getattr(params_p, f), getattr(params_j, f), what=f)
        assert_exact(rooms_p[0], rooms_j[0])
        assert_exact(rooms_p[1], rooms_j[1])
    cfg_s = presets.swarm(64, device="cpu")[0]
    from __graft_entry__ import _cfg_and_world
    assert cfg_s == convert.config_from(
        _cfg_and_world(64, frontiers=False, parity=False)[0])
    assert cfg_s.engine.raster_mode == "line" and cfg_s.engine.scan_rays == 0
    # the 1024-agent shapes the chip run drives (no grid is allocated)
    big = presets.untiled(1024, raster_mode="beam", device="cpu")
    assert big[0] == convert.config_from(jax_untiled(1024, "beam")[0])
    assert big[0].grid.size == 3840 and big[0].engine.merge_every == 16
    assert big[0].engine.raster_4way and not big[0].engine.use_pallas
    assert tuple(big[1].shape) == (2048, 4)
    assert_exact(pworld.BEDROOM_WALLS, jworld.BEDROOM_WALLS)
    for n_rooms, per_row in ((1, 1), (7, 3), (512, 23)):
        assert_exact(pworld.make_multi_room(n_rooms, per_row=per_row),
                     jworld.make_multi_room(n_rooms, per_row=per_row))


@functools.lru_cache(maxsize=None)
def _jax_tier(n_beams: int, dtype: str):
    spec = (jbr.BeamSpec.four_way() if n_beams == 4
            else jbr.BeamSpec.scan(n_beams))
    cfg = jraster.GridConfig(size=GRID.size, origin_x=GRID.origin_x,
                             origin_y=GRID.origin_y, logodds_dtype=dtype)
    return jax.jit(lambda g, a, y, d, tr: jbr.beam_raster_reference(
        g, a, y, d, tr, spec, cfg, reach=26))


def _port_spec(n_beams):
    return (pbr.BeamSpec.four_way() if n_beams == 4
            else pbr.BeamSpec.scan(n_beams))


def _tier_inputs(rng, case, n_beams):
    if case == "spread":
        n = 8
        xy = rng.uniform([0.0, -1.0], [19.0, 19.0], (n, 2))
        grid = np.zeros((GRID.size, GRID.size), np.float32)
    else:
        n = 16
        xy = np.tile([[6.3, 5.2]], (n, 1)) + rng.normal(0, 0.01, (n, 2))
        grid = rng.uniform(-10.0, 10.0, (GRID.size, GRID.size))
        grid = np.sign(grid) * np.minimum(np.abs(grid) + 9.0, 10.0)
        grid = grid.astype(np.float32)
        flat = grid.reshape(-1)
        flat[rng.choice(flat.size, flat.size // 50, replace=False)] = -0.0
        flat[rng.choice(flat.size, flat.size // 100, replace=False)] = np.nan
    yaw = rng.uniform(-math.pi, math.pi, n)
    dist = rng.uniform(0.1, 1.4, (n, n_beams))
    trusted = (dist > 0.02) & (dist <= 1.2) & (rng.uniform(size=(n, n_beams))
                                              > 0.2)
    dist = np.where(trusted, dist, 1.2)
    if case == "dense":
        dist[3] = 0.0                 # a dead agent: ranges and trust zeroed
        trusted[3] = False
    return (grid, xy.astype(np.float32), yaw.astype(np.float32),
            dist.astype(np.float32), trusted)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_beams", [4, 181])
@pytest.mark.parametrize("case", ["spread", "dense"])
def test_xla_tier_matches_jax(rng, case, n_beams, dtype):
    grid, xy, yaw, dist, trusted = _tier_inputs(rng, case, n_beams)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    g_j = jnp.asarray(grid).astype(jdt)
    ref, w_j = _jax_tier(n_beams, dtype)(g_j, jnp.asarray(xy),
                                         jnp.asarray(yaw), jnp.asarray(dist),
                                         jnp.asarray(trusted))
    g_p = convert._leaf_to_torch(np.asarray(g_j)).clone()
    out, w_p = pbr.beam_raster_reference(
        g_p, t(xy), t(yaw), t(dist), t(trusted), _port_spec(n_beams),
        dataclasses.replace(GRID, logodds_dtype=dtype), reach=26)
    assert out.data_ptr() == g_p.data_ptr()        # in place
    got, want, before = f32(out), f32(ref), f32(g_j)
    assert_exact(np.isnan(got), np.isnan(want), what="NaN cells")
    zero = (got == 0) & (want == 0)
    assert_exact(np.signbit(got[zero]), np.signbit(want[zero]),
                 what="signed zeros")
    changed = ~np.isnan(want) & ((want != before) | (np.signbit(want)
                                                    != np.signbit(before)))
    decision_equal(np.nan_to_num(got), np.nan_to_num(want),
                   f"{case} {n_beams} beams {dtype}",
                   painted=int(changed.sum()))
    print(f"writes {int(w_p)} vs {int(w_j)}")
    assert abs(int(w_p) - int(w_j)) <= 1e-4 * int(w_j)
    assert int(w_j) > 0 and changed.sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ordered_add_equals_the_agent_loop(rng, dtype):
    """Random patch deltas of 24 agents, many on one point, added by
    ordered_add and by a loop over agents: bit-equal, -0.0 and NaN cells
    included."""
    size, pr, pc, n = 96, 16, 40, 24
    g0 = torch.from_numpy(rng.uniform(-9.9, 9.9, (size, size)).astype(
        np.float32)).to(dtype)
    g0.view(-1)[torch.from_numpy(rng.choice(size * size, 300))] = -0.0
    g0.view(-1)[torch.from_numpy(rng.choice(size * size, 100))] = float(
        "nan")
    r0 = torch.from_numpy(np.where(np.arange(n) < 12, 40,
                                   rng.integers(0, size - pr, n)))
    c0 = torch.from_numpy(np.where(np.arange(n) < 12, 30,
                                   rng.integers(0, size - pc, n)))
    d = torch.from_numpy(rng.choice([0.0, 0.85, -0.4, 1e-3], (n, pr, pc),
                                    p=[0.7, 0.1, 0.15, 0.05]).astype(
        np.float32))
    want = g0.clone()
    for a in range(n):
        win = want[r0[a]:r0[a] + pr, c0[a]:c0[a] + pc]
        win.copy_((win.to(torch.float32) + d[a]).to(dtype))
    got = g0.clone()
    cells = ((r0[:, None, None] + torch.arange(pr)[:, None]) * size
             + c0[:, None, None] + torch.arange(pc))
    depth = praster.ordered_add(got.view(-1), cells, d)
    assert depth >= 12
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def _rays(rng, n_rays, lo=-4.0, hi=24.0):
    ox = rng.uniform(0.0, 20.0, n_rays).astype(np.float32)
    oy = rng.uniform(-1.0, 20.0, n_rays).astype(np.float32)
    ang = rng.uniform(-math.pi, math.pi, n_rays)
    rr = rng.uniform(0.0, 1.5, n_rays)
    hx = (ox + rr * np.cos(ang)).astype(np.float32)
    hy = (oy + rr * np.sin(ang)).astype(np.float32)
    # some rays start or end outside the grid; many share an origin
    hx[:20] = rng.uniform(lo, hi, 20)
    ox[20:40] = -3.5
    ox[40:200], oy[40:200] = ox[40], oy[40]
    hv = rng.uniform(size=n_rays) > 0.3
    act = rng.uniform(size=n_rays) > 0.1
    return hx, hy, ox, oy, hv, act


@functools.lru_cache(maxsize=None)
def _jax_line():
    cfg = jraster.GridConfig(size=GRID.size, origin_x=GRID.origin_x,
                             origin_y=GRID.origin_y)
    return jax.jit(lambda g, rays: jraster.logodds_raster(g, rays, cfg))


def test_logodds_raster_matches_jax(rng):
    hx, hy, ox, oy, hv, act = _rays(rng, 600)
    g = rng.uniform(-2.0, 2.0, (GRID.size, GRID.size)).astype(np.float32)
    ref, w_j = _jax_line()(jnp.asarray(g), jraster.RayBatch(
        *(jnp.asarray(x) for x in (ox, oy, hx, hy, hv, act))))
    got, w_p = praster.logodds_raster(torch.from_numpy(g.copy()),
                                      praster.RayBatch(*(t(x) for x in (
                                          ox, oy, hx, hy, hv, act))), GRID)
    assert int(w_p) == int(w_j) > 0
    decision_equal(got, ref, "line raster",
                   painted=int((np.asarray(ref) != g).sum()))


UNTILED_MODES = {
    "line": dict(raster_mode="line"),
    "line-no-sweep": dict(raster_mode="line", scan_rays=0),
    "xla-f32": dict(raster_mode="beam"),
    "xla-bf16": dict(raster_mode="beam", grid_dtype="bfloat16"),
    "off": dict(raster_mode="off", frontiers=True),
}


@pytest.mark.parametrize("mode", list(UNTILED_MODES))
def test_one_step_parity(mode):
    kw = UNTILED_MODES[mode]
    cfg_j, walls, params, rooms = jax_untiled(N, **kw)
    cfg, walls_p, params_p, rooms_p = presets.untiled(N, device="cpu", **kw)
    r = cfg.engine.scan_rays
    assert cfg == convert.config_from(cfg_j)
    step = js.make_sim_step(cfg_j, jnp.asarray(walls), params, donate=False,
                            walls_grouped=rooms[0], room_of_agent=rooms[1])
    st_j = js.sim_init(cfg_j, params)
    xla = mode.startswith("xla")
    for k in range(4):
        st_p = convert.to_torch(st_j, ps.SimState)
        nxt_p, m_p = ps.sim_step(st_p, jax_step_noise(st_j.key, N, r), cfg,
                                 walls_p, params_p,
                                 walls_grouped=rooms_p[0],
                                 room_of_agent=rooms_p[1])
        st_j, m_j = step(st_j)
        for f in ps.StepMetrics._fields:
            a, b = getattr(m_p, f), getattr(m_j, f)
            if f == "writes" and xla:
                assert abs(int(a) - int(b)) <= 1e-4 * int(b), (k, a, b)
            elif a.dtype.is_floating_point:
                assert_close(a, b, what=f"step {k} {f}")
            else:
                assert_exact(a, b, what=f"step {k} {f}")
        if mode == "off":
            assert int(m_p.writes) == 0
            assert torch.equal(nxt_p.srv.logodds, st_p.srv.logodds)
            assert_exact(nxt_p.srv.grid, st_j.srv.grid)
        else:
            assert int(m_p.writes) > 0
        if mode == "line":
            # the sweep's endpoints are XLA's FMA and cos against torch's
            # (ROADMAP C9): an ulp moves an endpoint on a wall, and the
            # untiled world's walls lie on cell edges (C14), across the
            # edge, and the Bresenham path with it; the same rays give the
            # same map (test_logodds_raster_matches_jax, line-no-sweep)
            got, ref = f32(nxt_p.srv.logodds), f32(st_j.srv.logodds)
            n_diff = int((np.abs(got - ref) > 1e-6).sum())
            painted = int((ref != 0).sum())
            print(f"line step {k}: {n_diff} of {painted} painted cells "
                  f"differ")
            assert n_diff <= 0.01 * painted
        else:
            decision_equal(nxt_p.srv.logodds, st_j.srv.logodds,
                           f"{mode} step {k} map")
        assert_close(nxt_p.pose_true, st_j.pose_true)
        assert_exact(nxt_p.nav.state, st_j.nav.state)
        if not xla:
            assert_exact(nxt_p.srv.total_writes, st_j.srv.total_writes)
    assert int(m_j.online) == N


def _rollout_world(mode):
    if mode == "dual_bot":
        return presets.dual_bot(device="cpu")
    if mode == "swarm":
        return presets.swarm(N, device="cpu")
    if mode == "bias":
        cfg, walls, params, rooms = presets.deployable(N, device="cpu")
        return (cfg.replace(slam=dataclasses.replace(
            cfg.slam, merge_bias_alpha=0.1)), walls, params, rooms)
    if mode == "parity":
        cfg, walls, params, rooms = presets.untiled(
            N, raster_mode="line", scan_rays=0, device="cpu")
        return (cfg.replace(engine=dataclasses.replace(
            cfg.engine, parity_mode=True)), walls, params, rooms)
    return presets.untiled(N, device="cpu", **UNTILED_MODES[mode])


@pytest.mark.parametrize("mode", list(UNTILED_MODES) + [
    "swarm", "parity", "dual_bot", "bias"])
def test_every_mode_rolls_out(mode):
    """17 steps of `sim_rollout` (a merge event at step 15 where the merge
    runs, on a map) on each newly ported path: every step writes (none in the
    profiling mode), all agents online, poses finite; the parity paths
    write the int8 grid and leave the log-odds at zero, the profiling mode
    leaves both as they were; with the bias the yaw-rate state moves."""
    cfg, walls, params, rooms = _rollout_world(mode)
    st0 = ps.sim_init(cfg, params)
    st, m = ps.sim_rollout(st0, 17, cfg, walls, params,
                           torch.Generator().manual_seed(0),
                           walls_grouped=rooms[0], room_of_agent=rooms[1])
    n = cfg.n_agents
    assert bool((m.online[1:] == n).all())
    assert bool(torch.isfinite(st.pose_true).all())
    if mode == "off":
        assert int(m.writes.abs().sum()) == 0
        assert not bool(st.srv.logodds.any())
    else:
        assert bool((m.writes > 0).all())
    if cfg.engine.parity_mode or mode == "off":
        assert not bool(st.srv.logodds.any())
        assert bool((st.srv.grid != cfg.grid.unknown).any()) == \
            cfg.engine.parity_mode
    else:
        assert bool(st.srv.logodds.any())
    if cfg.engine.merge_every > 0 and not cfg.engine.parity_mode and \
            mode != "off":                  # nothing to match on an empty map
        assert int(m.merges.sum()) > 0
    if mode == "bias":
        assert bool(st.srv.merge_dist_mark.any())
    else:
        # ROADMAP C14: no ray point lies left of or below the grid origin,
        # so world_to_grid's truncation toward zero is the floor on the
        # untiled worlds (their walls begin 2.5 m and 2 m inside it)
        g = cfg.grid
        assert float(m.hits[..., 0].min()) > g.origin_x + 1.0
        assert float(m.hits[..., 1].min()) > g.origin_y + 1.0
