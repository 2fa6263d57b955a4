"""The sharded engine's XLA tiers on one gloo rank against the JAX package's
`make_sharded_sim_step` on a 1-device mesh: the XLA fast free-space tier
(`use_pallas=False`: `free_raster_reference` per fan on a fresh window plus
the exact endpoint delta) and the line scatter (every raster mode but the
beam mode: the 4-way rays, then the sweep's, through `logodds_delta`).

Cases, each 3 steps from the same state on the JAX step's own noise, with
one merge event at step 2 where the world has a sweep:
  * "xla-replicated": the deployable preset at 8 agents, XLA tier, whole
    grid;
  * "xla-tiles-grouped": the same with the grouped tier (181 beams in 8
    groups, the weak tail) on a 1x1 rank grid of tiles (the extended tile
    with its ghost cells past the grid);
  * "line-rows": raster_mode="line" with the 181-beam sweep on the row
    band;
  * "swarm-line": `presets.swarm(8)`, the 4-way line scatter without a
    sweep, on the whole grid.
Bars (tests/test_torch_sharded.py's one-rank bars): StepMetrics integers
exact, floats at 1e-5; maps and anchors decision-equal (cells differing by
> 1e-6 in at most 0.01% of the painted cells), except the sweep's line rays,
which differ in at most 1% of the painted cells (ROADMAP C26, the bar of
test_torch_untiled.py::test_one_step_parity[line]); poses at 1e-5.

Then, on one rank, the three configurations the port refused before (the
XLA tier, raster_mode "line" and "off") build and step in every
decomposition, bit-equal across decompositions.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from swarm_tpu.engine import sim as js
from swarm_tpu.parallel import make_mesh, make_sharded_sim_step
from swarm_tpu.parallel import shard_state as jax_shard_state
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.parallel import mesh, sharded
from tests.torch_parity import (assert_close, assert_exact, decision_equal,
                                f32, jax_deployable, jax_step_noise,
                                jax_untiled, step_keys)
from tests.torch_parity import torch_one_thread  # noqa: F401
from datetime import timedelta

N = 8
STEPS = 3
MERGE_EVERY = 3
TIMEOUT = timedelta(seconds=120)

# (world, decomposition, engine fields replaced on both sides, line rays
# with a sweep)
CASES = {
    "xla-replicated": ("deployable", "replicated", dict(use_pallas=False),
                       False),
    "xla-tiles-grouped": ("deployable", "tiles",
                          dict(use_pallas=False, beam_groups=8), False),
    "line-rows": ("deployable", "rows", dict(raster_mode="line"), True),
    "swarm-line": ("swarm", "replicated", {}, False),
}


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group for the module."""
    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0, TIMEOUT,
              device="cpu")
    yield
    dist.destroy_process_group()


def _with(cfg, eng):
    return cfg.replace(engine=dataclasses.replace(cfg.engine, **eng)) \
        if eng else cfg


def _worlds(world):
    if world == "swarm":
        return jax_untiled(N, raster_mode="line", scan_rays=0), \
            presets.swarm(N, device="cpu")
    return jax_deployable(N, merge_every=MERGE_EVERY), \
        presets.deployable(N, device="cpu", merge_every=MERGE_EVERY)


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """STEPS sharded JAX steps on a 1-device mesh (compiled once per case):
    (initial state, [noise per step], [metrics per step], final state)."""
    world, gs, eng, _ = CASES[case]
    (cfg, walls, params, rooms), _ = _worlds(world)
    cfg = _with(cfg, eng)
    m = (Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("gr", "gc"))
         if gs == "tiles" else make_mesh(1))
    step = make_sharded_sim_step(
        cfg, walls, params, m, donate=False, grid_sharding=gs,
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    st0 = js.sim_init(cfg, params)
    st = jax_shard_state(st0, m, grid_rows_sharded=gs == "rows",
                         grid_tiles_sharded=gs == "tiles")
    key, noises, metrics = st0.key, [], []
    for _ in range(STEPS):
        noises.append(jax_step_noise(key, N, cfg.engine.scan_rays))
        key = step_keys(key, N)[0]
        st, mj = step(st)
        metrics.append(jax.tree.map(np.asarray, mj))
    return st0, noises, metrics, jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_tier_matches_jax(group, case):
    world, gs, eng, sweep_lines = CASES[case]
    st0, noises, metrics_j, final_j = _jax_run(case)
    _, (cfg, walls, params, rooms) = _worlds(world)
    cfg = _with(cfg, eng)
    lay = mesh.make_layout((1, 1), device="cpu")
    step = sharded.make_sharded_sim_step(
        cfg, walls, params, lay, grid_sharding=gs, walls_grouped=rooms[0],
        room_of_agent=rooms[1])
    st = sharded.shard_state(convert.to_torch(st0, ps.SimState), lay, gs)
    for k in range(STEPS):
        st, m = step(st, noises[k])
        for f in ps.StepMetrics._fields:
            a, b = getattr(m, f), getattr(metrics_j[k], f)
            if a.dtype.is_floating_point:
                assert_close(a, b, what=f"step {k} metric {f}")
            else:
                assert_exact(a, b, what=f"step {k} metric {f}")
        assert int(m.writes) > 0
    assert int(m.online) == N and int(m.band_escapes) == 0
    if cfg.engine.merge_every > 0:
        assert int(metrics_j[MERGE_EVERY - 1].merges) > 0
    if sweep_lines:
        got, ref = f32(st.srv.logodds), f32(final_j.srv.logodds)
        n_diff = int((np.abs(got - ref) > 1e-6).sum())
        painted = int((ref != 0).sum())
        print(f"{case}: {n_diff} of {painted} painted cells differ")
        assert n_diff <= 0.01 * painted
    else:
        decision_equal(st.srv.logodds, final_j.srv.logodds, f"{case} map")
    decision_equal(st.srv.anchor, final_j.srv.anchor, f"{case} anchor")
    assert_close(st.pose_true, final_j.pose_true, what="poses")
    assert_exact(st.srv.total_writes, final_j.srv.total_writes)


@pytest.mark.parametrize("eng", [dict(use_pallas=False),
                                 dict(raster_mode="line"),
                                 dict(raster_mode="off")],
                         ids=["xla-tier", "line", "off"])
def test_former_refusals_step_in_every_decomposition(group, eng):
    """The sharded configurations the port refused before (the XLA fast
    tier, and the line and profiling modes, which the sharded body rasters
    as the line scatter, ROADMAP C40) build and step on one rank in every
    decomposition: cells written, and "rows" and "tiles" bit-equal to
    "replicated" (maps, writes, poses) after 3 steps."""
    cfg, walls, params, rooms = presets.deployable(N, device="cpu",
                                                   merge_every=MERGE_EVERY)
    cfg = _with(cfg, eng)
    lay = mesh.make_layout((1, 1), device="cpu")
    out = {}
    for gs in sharded.GRID_SHARDINGS:
        step = sharded.make_sharded_sim_step(
            cfg, walls, params, lay, torch.Generator().manual_seed(5),
            grid_sharding=gs, walls_grouped=rooms[0],
            room_of_agent=rooms[1])
        st = sharded.shard_state(ps.sim_init(cfg, params), lay, gs)
        for _ in range(STEPS):
            st, m = step(st)
            assert int(m.writes) > 0
        out[gs] = sharded.gather_state(st, lay, gs)
    ref = out["replicated"]
    for gs in ("rows", "tiles"):
        assert torch.equal(out[gs].srv.logodds, ref.srv.logodds), gs
        assert torch.equal(out[gs].srv.total_writes, ref.srv.total_writes)
        assert torch.equal(out[gs].pose_true, ref.pose_true), gs
