"""The sharded engine (swarm_tpu_torch/parallel/) on gloo ranks on the CPU.

1. One rank against the JAX package's `make_sharded_sim_step` on a
   1-device mesh, in each decomposition ("replicated", "rows", "tiles" on a
   1x1 rank grid): the deployable preset at 8 agents with the merge every 3
   steps, 3 steps (one merge event at step 2), the JAX Pallas raster in
   interpret mode, the same noise on both sides (the JAX step's own draws
   through the port's seam). On one device the reference's three
   decompositions give this world the same metrics and states bit for
   bit, so the port's three are held to its one "replicated" run; and "tiles" once more with the grouped tier
   (181 beams in 8 groups) and no endpoint ring, where the body scatters
   the endpoints into the extended tile with `logodds_delta`'s tile form
   (bench.py --beam-groups 8 --exact-endpoints); and "replicated" with the
   yaw-rate bias on (merge_bias_alpha=0.1: the feed-forward in the raster
   yaw, the event's deltas gathered like the merge increments); and
   "replicated" with the scan-matched closures (the sweeps gathered to
   every rank, pairs attempted from step 0). StepMetrics
   integers exact, floats at atol = rtol = 1e-5; maps and anchors decision-equal (cells differing by
   > 1e-6 at most 0.01% of the painted cells); poses at 1e-5; every
   closure-ring leaf (integers exact, floats within 1e-4).
2. Four gloo ranks, one `torchrun` of `parallel/dryrun.py` (a join limit
   and a collective timeout): "rows" and "replicated" on
   `presets.vertical_rooms(4)`, "tiles" (2x2) and "replicated" on
   `presets.tile_blocks(2, 2, 512)`, 4 steps with a merge event, each in
   the kernel tier, the XLA fast tier and the line scatter, and the swarm
   preset's line scatter. "rows" is bit-equal to "replicated" in every
   tier; so is "tiles" (what the run shows in the kernel tier, ROADMAP
   C22 for the card's size; by construction in the XLA tier and the line
   scatter); the XLA tier within the reference's bars of the kernel
   without the ring; poses bit-equal to a one-rank run of the same world
   and seed; no band escape (the dry run checks it).
3. The static proofs and refusals raise what the JAX builder raises (the
   JAX builds raise before any step runs, so no multi-device interpret-mode
   collective runs, ROADMAP C10).
4. `parallel/dryrun.py` on 2 gloo ranks.
5. `_halo_exchange` on 4 gloo ranks (2x2, 4x1, 1x4) with every strip of
   every extended tile nonzero, against the replicated assembly.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from datetime import timedelta

import jax
import jax.numpy as jnp
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
from swarm_tpu_torch.parallel import dryrun, mesh, sharded
from tests.torch_parity import (assert_close, assert_exact, decision_equal,
                                jax_deployable, jax_step_noise,
                                pallas_interpret, step_keys)

N = 8
R = 181
STEPS = 3
MERGE_EVERY = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every process group here waits at most this long in a collective, and
# every spawn of ranks is joined within SPAWN_LIMIT seconds
TIMEOUT = timedelta(seconds=120)
SPAWN_LIMIT = 300


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group for the module."""
    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0, TIMEOUT,
              device="cpu")
    yield
    dist.destroy_process_group()


def _jax_mesh(grid_sharding):
    if grid_sharding == "tiles":
        return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("gr", "gc"))
    return make_mesh(1)


# the scan-matched closures with the rendezvous radius wide enough that
# the two agents of a room (5.8 m apart at home) pair from step 0, and a
# 48 + 2 x 8 closure window (XLA's CPU compile of the tool's 128 + 2 x 28
# takes minutes)
SCANMATCH = dict(closure_scanmatch=True, closure_cross_radius_m=6.5,
                 closure_pair_budget=8, closure_pair_cooldown=16,
                 closure_match_window=48, closure_match_search=8)

# (decomposition, bench.py flags as presets.deployable's arguments,
# SlamConfig fields replaced on both sides)
ONE_RANK = {"replicated": ("replicated", {}, {}), "rows": ("rows", {}, {}),
            "tiles": ("tiles", {}, {}),
            "tiles-grouped-exact": ("tiles", dict(beam_groups=8,
                                                  exact_endpoints=True), {}),
            "replicated-bias": ("replicated", {},
                                dict(merge_bias_alpha=0.1)),
            "replicated-scanmatch": ("replicated", {}, SCANMATCH)}


# the JAX run each case is held to: the reference's "rows" and "tiles"
# steps equal its "replicated" step bit for bit on one device
JAX_CASE = {"rows": "replicated", "tiles": "replicated"}


def _with_slam(cfg, slam):
    return cfg.replace(slam=dataclasses.replace(cfg.slam, **slam)) \
        if slam else cfg


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """STEPS sharded JAX steps on a 1-device mesh (compiled once per
    case): (initial state, [noise per step], [metrics per step], final
    state), numpy."""
    grid_sharding, flags, slam = ONE_RANK[case]
    cfg, walls, params, rooms = jax_deployable(N, merge_every=MERGE_EVERY,
                                               **flags)
    cfg = _with_slam(cfg, slam)
    m = _jax_mesh(grid_sharding)
    step = make_sharded_sim_step(
        cfg, walls, params, m, donate=False, grid_sharding=grid_sharding,
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    st0 = js.sim_init(cfg, params)
    st = jax_shard_state(st0, m, grid_rows_sharded=grid_sharding == "rows",
                         grid_tiles_sharded=grid_sharding == "tiles")
    key, noises, metrics = st0.key, [], []
    with pallas_interpret():
        for _ in range(STEPS):
            noises.append(jax_step_noise(key, N, R))
            key = step_keys(key, N)[0]
            st, mj = step(st)
            metrics.append(jax.tree.map(np.asarray, mj))
    return st0, noises, metrics, jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("case", list(ONE_RANK))
def test_one_rank_matches_jax_sharded_step(group, case):
    grid_sharding, flags, slam = ONE_RANK[case]
    st0, noises, metrics_j, final_j = _jax_run(JAX_CASE.get(case, case))
    cfg, walls, params, rooms = presets.deployable(
        N, device="cpu", merge_every=MERGE_EVERY, **flags)
    cfg = _with_slam(cfg, slam)
    lay = mesh.make_layout((1, 1), device="cpu")
    step = sharded.make_sharded_sim_step(
        cfg, walls, params, lay, grid_sharding=grid_sharding,
        walls_grouped=rooms[0], room_of_agent=rooms[1])
    st = sharded.shard_state(convert.to_torch(st0, ps.SimState), lay,
                             grid_sharding)
    for k in range(STEPS):
        st, m = step(st, noises[k])
        for f in ps.StepMetrics._fields:
            a, b = getattr(m, f), getattr(metrics_j[k], f)
            if a.dtype.is_floating_point:
                assert_close(a, b, what=f"step {k} metric {f}")
            else:
                assert_exact(a, b, what=f"step {k} metric {f}")
    assert int(metrics_j[MERGE_EVERY - 1].merges) > 0
    assert int(m.online) == N and int(m.band_escapes) == 0
    decision_equal(st.srv.logodds, final_j.srv.logodds, f"{case} map")
    decision_equal(st.srv.anchor, final_j.srv.anchor, f"{case} anchor")
    assert_close(st.pose_true, final_j.pose_true, what="poses")
    for f in ("merge_dx", "merge_dy", "merge_dyaw", "merge_yaw_rate",
              "merge_dist_mark"):
        assert_close(getattr(st.srv, f), getattr(final_j.srv, f), what=f)
    assert_exact(st.srv.merge_fail, final_j.srv.merge_fail)
    assert_exact(st.srv.total_writes, final_j.srv.total_writes)
    for f in st.srv.closure._fields:
        a, b = getattr(st.srv.closure, f), getattr(final_j.srv.closure, f)
        if a.dtype.is_floating_point:
            assert_close(a, b, rtol=1e-4, atol=1e-4, what=f"closure {f}")
        else:
            assert_exact(a, b, what=f"closure {f}")
    if slam.get("closure_scanmatch"):
        assert tuple(st.srv.closure.lm_scan.shape)[1] == R
        assert bool((st.srv.closure.last_pair_node >= 0).all())
    # the gathered state is the rank's state on one rank
    full = sharded.gather_state(st, lay, grid_sharding)
    assert torch.equal(full.srv.logodds, st.srv.logodds)


def _torchrun(nproc, *args, target=("-m", "swarm_tpu_torch.parallel.dryrun",
                                      "--device", "cpu"),
              timeout=SPAWN_LIMIT):
    """`target` (by default `parallel/dryrun.py`) on `nproc` gloo ranks,
    joined within `timeout` seconds; returns its standard output.
    `--standalone`: the launcher binds its own rendezvous port and holds
    it, so no other process can take it between choosing and binding."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         f"--nproc-per-node={nproc}", "--standalone", *target,
         "--timeout", str(TIMEOUT.total_seconds()), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# One gloo rank of the halo-exchange test: every rank fills its whole
# extended tile (core, halo ring and corners) with values tagged by its rank
# and by position, runs `_halo_exchange`, and holds its core against the
# replicated assembly (every rank's extended tile added at its global place,
# what falls outside the grid dropped). Integer values, so float32 sums are
# exact and a strip added at a wrong offset or sent to a wrong peer shows.
HALO_RANK = """
import argparse, os
from datetime import timedelta
import torch
import torch.distributed as dist
from swarm_tpu_torch.parallel import mesh, sharded

SIZE, HALO_R, HALO_C = 512, 24, 128


def ext_of(rank, n_r, n_c):
    i = torch.arange(n_r, dtype=torch.float32)[:, None]
    j = torch.arange(n_c, dtype=torch.float32)[None, :]
    return (rank + 1) + 8 * torch.remainder(31 * i + 17 * j, 101)


ap = argparse.ArgumentParser()
ap.add_argument("--timeout", type=float)
timeout = timedelta(seconds=ap.parse_args().timeout)
world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
mesh.init("env://", world, rank, timeout, device="cpu")
try:
    for grid in ((2, 2), (4, 1), (1, 4)):
        lay = mesh.make_layout(grid, device="cpu")
        core_r, core_c = SIZE // grid[0], SIZE // grid[1]
        n_r, n_c = core_r + 2 * HALO_R, core_c + 2 * HALO_C
        full = torch.zeros((SIZE + 2 * HALO_R, SIZE + 2 * HALO_C))
        for r in range(world):
            tr, tc = divmod(r, grid[1])
            full[tr * core_r:tr * core_r + n_r,
                 tc * core_c:tc * core_c + n_c] += ext_of(r, n_r, n_c)
        tr, tc = lay.tile
        want = full[HALO_R + tr * core_r:HALO_R + (tr + 1) * core_r,
                    HALO_C + tc * core_c:HALO_C + (tc + 1) * core_c]
        got = sharded._halo_exchange(ext_of(rank, n_r, n_c), lay, HALO_R,
                                     HALO_C, core_r, core_c)
        n_bad = int((got != want).sum())
        assert n_bad == 0, f"{grid} rank {rank}: {n_bad} core cells wrong"
        print(f"halo ok {grid[0]}x{grid[1]} rank {rank}", flush=True)
finally:
    dist.destroy_process_group()
"""


def test_halo_exchange_sums_every_strip(tmp_path):
    """`_halo_exchange` on 4 gloo ranks as a 2x2, a 4x1 and a 1x4 rank
    grid: every core equals the replicated assembly of all ranks' extended
    tiles, the corners (carried through the row phase into the column
    phase) included."""
    script = tmp_path / "halo_rank.py"
    script.write_text(HALO_RANK)
    text = _torchrun(4, target=(str(script),))
    for grid in ("2x2", "4x1", "1x4"):
        for r in range(4):
            assert f"halo ok {grid} rank {r}" in text


def test_four_gloo_ranks_decompositions(group, tmp_path):
    npz = tmp_path / "four.npz"
    text = _torchrun(4, "--steps", "4", "--merge-every", "4", "--out",
                     str(npz))
    assert "dryrun ok (4 ranks)" in text
    assert text.count("XLA tier vs kernel without the ring") == 8
    four = np.load(npz)
    assert int(four["swarm replicated/writes"]) > 0
    lay = mesh.make_layout(device="cpu")
    for decomp, world_fn in (
            ("rows", lambda: presets.vertical_rooms(4, device="cpu",
                                                    merge_every=4)),
            ("tiles", lambda: presets.tile_blocks(2, 2, 512, device="cpu",
                                                  merge_every=4))):
        # decompositions on 4 ranks: bit-equal to the replicated one, in
        # the kernel tier, the XLA fast tier and the line scatter
        for tier in ("", "xla ", "line "):
            ref = f"{tier}{decomp}-world replicated"
            got = four[f"{tier}{decomp}/logodds"]
            np.testing.assert_array_equal(got, four[f"{ref}/logodds"])
            np.testing.assert_array_equal(four[f"{tier}{decomp}/pose_true"],
                                          four[f"{ref}/pose_true"])
            assert int(four[f"{tier}{decomp}/writes"]) == \
                int(four[f"{ref}/writes"])
            assert (got != 0).sum() > 1000
        # the XLA tier and the kernel without the ring paint differently
        # (the dry run holds them to the reference's bars)
        assert not np.array_equal(four[f"xla {decomp}/logodds"],
                                  four[f"{decomp}/logodds"])
        ref = f"{decomp}-world replicated"
        # the same world and seed on one rank
        cfg, walls, params, rooms = world_fn()
        step = sharded.make_sharded_sim_step(
            cfg, walls, params, lay,
            torch.Generator().manual_seed(dryrun.SEED),
            walls_grouped=rooms[0], room_of_agent=rooms[1])
        st = sharded.shard_state(ps.sim_init(cfg, params), lay)
        for _ in range(4):
            st, m = step(st)
        assert int(m.merges) > 0
        np.testing.assert_array_equal(st.pose_true.numpy(),
                                      four[f"{decomp}/pose_true"])
        np.testing.assert_array_equal(st.srv.logodds.numpy(),
                                      four[f"{ref}/logodds"])


def test_dryrun_two_gloo_ranks():
    text = _torchrun(2)
    assert "dryrun ok (2 ranks)" in text
    assert text.count("rows vs replicated") == 2
    assert text.count("tiles vs replicated") == 2


def _with(cfg, eng=None, grid=None):
    return cfg.replace(
        engine=dataclasses.replace(cfg.engine, **(eng or {})),
        grid=dataclasses.replace(cfg.grid, **(grid or {})))


# (case, world, ranks (R, C), grid_sharding, engine / grid replacements,
# rooms given): each a static proof or refusal of the reference's builder
PROOFS = {
    "bf16": ("deployable8", (1, 1), "replicated",
             dict(grid=dict(logodds_dtype="bfloat16")), True),
    "parity": ("deployable8", (1, 1), "rows",
               dict(eng=dict(parity_mode=True)), True),
    "unknown": ("deployable8", (1, 1), "diagonal", {}, True),
    "indivisible": ("deployable8", (3, 1), "replicated", {}, True),
    "rows-no-rooms": ("deployable8", (1, 1), "rows", {}, False),
    "tiles-no-rooms": ("deployable8", (1, 1), "tiles", {}, False),
    "band-merge-window": ("deployable8", (8, 1), "rows", {}, True),
    "rows-escape": ("blocks", (4, 1), "rows", {}, True),
    "tiles-escape": ("deployable8", (2, 2), "tiles", {}, True),
    "tiles-small-grid": ("deployable2", (1, 1), "tiles", {}, True),
}


@functools.lru_cache(maxsize=None)
def _worlds(name):
    """(JAX world, port world) of a proof case."""
    if name == "blocks":
        from swarm_tpu.geom.world import make_tiled_rooms_blocks
        jcfg, _, _, _ = jax_deployable(N)
        cfg, walls, params, rooms = presets.tile_blocks(2, 2, 512,
                                                        device="cpu")
        walls_np, _ = make_tiled_rooms_blocks(2, 2, 512)
        jcfg = jcfg.replace(n_agents=cfg.n_agents)
        jworld = (jcfg, walls_np, None, (rooms[0].numpy(),
                                          rooms[1].numpy()))
        return jworld, (cfg, walls, params, rooms)
    n = {"deployable8": 8, "deployable2": 2}[name]
    return jax_deployable(n), presets.deployable(n, device="cpu")


@pytest.mark.parametrize("case", list(PROOFS))
def test_static_proofs_raise_as_jax(case):
    world, (r, c), gs, repl, with_rooms = PROOFS[case]
    (jcfg, jwalls, jparams, jrooms), (cfg, walls, params, rooms) = \
        _worlds(world)
    jcfg, cfg = _with(jcfg, **repl), _with(cfg, **repl)
    if jparams is None:
        from swarm_tpu.engine.sim import make_agent_params
        jparams = make_agent_params(cfg.n_agents, cfg=jcfg)
    jmesh = (Mesh(np.asarray(jax.devices()[:r * c]).reshape(r, c),
                  ("gr", "gc")) if gs == "tiles" else make_mesh(r * c))
    kw = (dict(walls_grouped=jrooms[0], room_of_agent=jrooms[1])
          if with_rooms else {})
    with pytest.raises(ValueError) as ref:
        make_sharded_sim_step(jcfg, jnp.asarray(jwalls), jparams, jmesh,
                              donate=False, grid_sharding=gs, **kw)
    lay = mesh.RankLayout(world=r * c, rank=0, rows=r, cols=c,
                          device=torch.device("cpu"))
    kw = (dict(walls_grouped=rooms[0], room_of_agent=rooms[1])
          if with_rooms else {})
    with pytest.raises(ValueError) as got:
        sharded.make_sharded_sim_step(cfg, walls, params, lay,
                                      grid_sharding=gs, **kw)
    assert str(got.value) == str(ref.value)


def test_unported_sharded_paths_name_their_item(group):
    """The sharded paths the port once refused with NotImplementedError
    naming ROADMAP A9 (the XLA fast tier, use_pallas=False, and the line
    and profiling modes, which the sharded body rasters as the line
    scatter) now build and step on one rank: two steps each, cells
    written, every agent online. The scan-matched closures (A5) build. A
    rank grid must cover the group."""
    cfg, walls, params, rooms = presets.deployable(N, device="cpu")
    lay = mesh.RankLayout(world=1, rank=0, rows=1, cols=1,
                          device=torch.device("cpu"))
    for eng in (dict(use_pallas=False), dict(raster_mode="line"),
                dict(raster_mode="off")):
        c = _with(cfg, eng)
        ps.check_supported(c, sharded=True)
        step = sharded.make_sharded_sim_step(
            c, walls, params, lay, torch.Generator().manual_seed(1))
        st = sharded.shard_state(ps.sim_init(c, params), lay)
        for _ in range(2):      # the heartbeat sees the second step's stamp
            st, m = step(st)
            assert int(m.writes) > 0, eng
        assert int(m.online) == N, eng
    sharded.make_sharded_sim_step(
        cfg.replace(slam=dataclasses.replace(cfg.slam,
                                             closure_scanmatch=True)),
        walls, params, lay)
    with pytest.raises(ValueError, match="does not cover"):
        mesh.make_layout((2, 2), device="cpu")


def test_frontier_targets_agree_across_decompositions(group):
    """With frontiers and targets (bench.py --frontiers), the frontier step
    gathers the map (a band, or the 2-D tiles) and delivers each rank's
    rows of the assignment: on one rank every decomposition gives the same
    frontiers, targets, maps and poses over 9 steps (two frontier events),
    and agents get targets."""
    cfg, walls, params, rooms = presets.deployable(
        N, device="cpu", merge_every=MERGE_EVERY, frontiers=True)
    lay = mesh.make_layout((1, 1), device="cpu")
    out = {}
    for gs in sharded.GRID_SHARDINGS:
        step = sharded.make_sharded_sim_step(
            cfg, walls, params, lay, torch.Generator().manual_seed(3),
            enable_targets=True, grid_sharding=gs, walls_grouped=rooms[0],
            room_of_agent=rooms[1])
        st = sharded.shard_state(ps.sim_init(cfg, params), lay, gs)
        for _ in range(9):
            st, m = step(st)
        out[gs] = sharded.gather_state(st, lay, gs)
    ref = out["replicated"]
    assert int(ref.srv.n_frontiers) > 0 and bool(ref.nav.has_target.any())
    for gs in ("rows", "tiles"):
        got = out[gs]
        for a, b in ((got.srv.frontier_centroids, ref.srv.frontier_centroids),
                     (got.nav.target_x, ref.nav.target_x),
                     (got.nav.has_target, ref.nav.has_target),
                     (got.pose_true, ref.pose_true)):
            assert torch.equal(a, b), gs
        decision_equal(got.srv.logodds, ref.srv.logodds, f"{gs} map")
