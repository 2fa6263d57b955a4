"""The grouped tier (`beam_groups > 0`, bench.py --beam-groups) of both
raster kernels against the Pallas kernels, on the CPU.

- The group statistics (second-min carve, median tail), the trusted
  fraction (JAX's `mean` multiplies by the float32 reciprocal of the group
  width: at 23 and 12 beams a group a division differs) and the range
  quantization: bit-exact against the jitted JAX functions.
- The window kernel's grouped forms (ring x fan x float32 / bfloat16 grid,
  tail 0.25 and 0) against the jitted `free_raster_pallas(..., n_groups=,
  tail_weight=, interpret=True)`, and the room kernel's (ring x fan)
  against `room_raster_pallas`: maps decision-equal
  (`torch_parity.decision_equal`: cells differing by more than 1e-6 at
  most 0.01% of the painted cells), counts rtol 1e-5; overlap cases on a
  grid pre-filled near +-clamp, where the per-agent clip order decides
  cells.
- ROADMAP C1: the cells the grouped per-cell math paints outside the
  fan-bbox strip bounds (which the kernels skip, as the reference's does),
  at 181 beams in 16 groups and in 8.
- One step of the deployable preset with beam_groups=8 (merge off), port
  against the JAX engine, on the window and the room path.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swarm_tpu.config import GridConfig
from swarm_tpu.engine import sim as js
from swarm_tpu.ops import beam_raster as jb
from swarm_tpu.ops import beam_raster_pallas as jp
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.config import GridConfig as PGrid
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.geom.world import make_tiled_rooms
from swarm_tpu_torch.ops import beam_raster as pb
from swarm_tpu_torch.ops import beam_raster_cuda as pc
from swarm_tpu_torch.ops import room_raster_cuda as pr
from tests.torch_parity import (assert_close, assert_exact, decision_equal,
                                f32, jax_deployable, jax_step_noise, t)
from tests.torch_parity import torch_one_thread  # noqa: F401

GRID = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
PGRID = convert.config_from(GRID, PGrid)
BF16 = torch.bfloat16


def _specs(n_beams):
    if n_beams == 4:
        return jb.BeamSpec.four_way(), pb.BeamSpec.four_way()
    return jb.BeamSpec.scan(n_beams), pb.BeamSpec.scan(n_beams)


@pytest.mark.parametrize("n_beams,n_groups", [(181, 8), (181, 16), (4, 2),
                                              (37, 5)])
def test_group_tables_exact(rng, n_beams, n_groups):
    """quantize_ranges_cells, group_range_stats and the trusted fraction,
    bit-exact against the jitted JAX functions (per = 23, 12, 2 and 8)."""
    d = rng.uniform(-1.0, 140.0, (9, n_beams)).astype(np.float32)
    d[0, :4] = [127.99, 128.5, 3.0 + 1 / 512, 3.0 + 3 / 512]
    trusted = rng.random((9, n_beams)) < 0.6
    trusted[1] = True
    q_ref = jax.jit(jb.quantize_ranges_cells)(jnp.asarray(d))
    q = pb.quantize_ranges_cells(t(d))
    assert_exact(q, q_ref)
    carve_ref, tail_ref = jax.jit(
        lambda r: jb.group_range_stats(r, n_groups))(q_ref)
    carve, tail = pb.group_range_stats(q, n_groups)
    assert_exact(carve, carve_ref)
    assert_exact(tail, tail_ref)
    spec_j, _ = _specs(n_beams)
    tf_ref = jax.jit(lambda tr: jp._group_trusted_frac(tr, spec_j, n_groups))(
        jnp.asarray(trusted))
    tf = pb.group_trusted_frac(t(trusted), n_beams, n_groups)
    assert_exact(tf, tf_ref)
    per = -(-n_beams // n_groups)
    if per in (23, 12):
        # the reference multiplies by float32(1 / per); a division differs
        k = t(trusted).to(torch.float32)
        k = torch.nn.functional.pad(k, (0, n_groups * per - n_beams))
        divided = k.reshape(9, n_groups, per).sum(-1) / per
        assert int((divided != tf).sum()) > 0


def _agents(rng, n_beams, pos, seed):
    xy = np.asarray(pos, np.float32)[:, ::-1] * GRID.resolution
    n = xy.shape[0]
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    yaw[:3] = [0.0, np.pi, -2.5]
    r = np.random.default_rng(seed)
    dist = r.uniform(0.15, 1.19, (n, n_beams)).astype(np.float32)
    trusted = r.random((n, n_beams)) < 0.7
    return xy, yaw, dist, trusted


SPREAD = [[250.0, 120.0], [253.0, 253.0], [40.0, 300.0], [500.0, 10.0],
          [120.0, 400.0], [300.0, 60.0]]

# the window kernel's grouped forms: (beams, groups, ring, grid dtype, tail);
# every kernel instance (ring x fan x storage), 16 groups, and the tail off
WINDOW_FORMS = {
    "scan-ring": (181, 8, True, "float32", 0.25),
    "scan": (181, 8, False, "float32", 0.25),
    "scan16-ring": (181, 16, True, "float32", 0.25),
    "4way-ring": (4, 2, True, "float32", 0.25),
    "4way": (4, 2, False, "float32", 0.25),
    "scan-ring-bf16": (181, 8, True, "bfloat16", 0.25),
    "scan-bf16-notail": (181, 8, False, "bfloat16", 0.0),
    "4way-ring-bf16": (4, 2, True, "bfloat16", 0.25),
    "4way-bf16": (4, 2, False, "bfloat16", 0.25),
}


@functools.lru_cache(maxsize=None)
def _window_ref(form):
    """The jitted free_raster_pallas of a form, compiled once per module
    (both cases of a form have the same shapes)."""
    n_beams, n_groups, _, dtype, tail = WINDOW_FORMS[form]
    spec_j, _ = _specs(n_beams)
    cfg_j = dataclasses.replace(GRID, logodds_dtype=dtype)
    return jax.jit(lambda g, xy, yaw, d, act, tr: jp.free_raster_pallas(
        g, xy, yaw, d, act, spec_j, cfg_j, n_groups=n_groups, reach=26,
        trusted=tr, tail_weight=tail, interpret=True, pack8=True))


@pytest.mark.parametrize("case", ["spread", "overlap"])
@pytest.mark.parametrize("form", list(WINDOW_FORMS))
def test_grouped_window_forms_match_pallas(rng, form, case):
    n_beams, n_groups, ring, dtype, tail = WINDOW_FORMS[form]
    _, spec_p = _specs(n_beams)
    if case == "overlap":
        pos = np.array([200.0, 260.0]) + rng.uniform(-4, 4, (6, 2))
        grid = rng.choice([-9.9, 9.7, -9.6, 9.95, -0.3, 0.31], (512, 512))
    else:
        pos, grid = SPREAD, np.zeros((512, 512))
    xy, yaw, dist, trusted = _agents(rng, n_beams, pos, n_groups + len(pos))
    act = np.ones(len(pos), bool)
    act[3] = False
    grid = grid.astype(np.float32)
    grid_j = jnp.asarray(grid).astype(dtype)
    grid_p = torch.from_numpy(grid).to(getattr(torch, dtype))
    cfg_p = convert.config_from(dataclasses.replace(
        GRID, logodds_dtype=dtype), PGrid)
    ref, rc = _window_ref(form)(
        grid_j, jnp.asarray(xy), jnp.asarray(yaw), jnp.asarray(dist),
        jnp.asarray(act), jnp.asarray(trusted) if ring else None)
    before = pc.free_raster.launches
    got, gc = pc.free_raster(grid_p.clone(), t(xy), t(yaw), t(dist), t(act),
                             t(trusted) if ring else None, spec_p, cfg_p,
                             reach=26, n_groups=n_groups, tail_weight=tail)
    assert pc.free_raster.launches == before     # CPU: the plain version
    assert got.dtype == grid_p.dtype
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert float(gc.sum()) > 0 and float(gc[3]) == 0.0
    changed = int((f32(ref) != f32(grid_j)).sum())
    decision_equal(got, ref, f"grouped {form} {case} map", painted=changed)
    assert changed > 40


def test_grouped_forms_and_their_names():
    """The tier per fan follows the reference (n_groups below the fan's
    beams: grouped; the 4-way fan in 8 groups stays per beam), and each
    grouped form has its launch-count key."""
    scan, four = pb.BeamSpec.scan(181), pb.BeamSpec.four_way()
    assert pc.table_kind(scan, True, 8) == "grouped"
    assert pc.table_kind(four, True, 8) == "pack8"
    assert pc.table_kind(four, False, 2) == "grouped"
    assert pc.table_kind(scan, False, None) == "pack16"
    assert pc.form_name(scan, True, True, grouped=True) == "grouped-ring"
    assert pc.form_name(four, True, False, BF16, grouped=True) == \
        "grouped-wrapped-bf16"
    assert pr.form_name(four, True, grouped=True) == "grouped-ring-wrapped"
    w = pc._windows(torch.zeros(512, 512), torch.tensor([[5.0, 5.0]]),
                    torch.zeros(1), torch.ones(1, 181),
                    torch.ones(1, dtype=bool), scan, PGRID,
                    torch.ones(1, 181, dtype=bool), 26, n_groups=8)
    assert w.kind == "grouped" and w.n_bins == 8
    assert tuple(w.table.shape) == (1, 8, 3) and w.tail_weight == 0.25


# the room kernel's grouped forms: (beams, groups, ring, tail)
ROOM_FORMS = {"scan-ring": (181, 8, True, 0.25), "scan": (181, 8, False, 0.25),
              "4way-ring": (4, 2, True, 0.25), "4way": (4, 2, False, 0.0)}


@functools.lru_cache(maxsize=None)
def _room_ref(form):
    """The jitted room_raster_pallas of a form, compiled once per module."""
    n_beams, n_groups, _, tail = ROOM_FORMS[form]
    spec_j, _ = _specs(n_beams)
    return jax.jit(lambda g, xy, yaw, d, act, tr: jp.room_raster_pallas(
        g, xy, yaw, d, act, spec_j, GRID, n_groups=n_groups, per_row=2,
        trusted=tr, reach=26, tail_weight=tail, interpret=True))


def _rooms_case(rng, n_rooms, overlap, n_beams):
    _, origins = make_tiled_rooms(n_rooms, per_row=2)
    n = 2 * n_rooms
    room = np.arange(n) // 2
    if overlap:
        c = origins[room] + rng.uniform([1.0, 1.0], [5.0, 3.0],
                                        (n_rooms, 2))[room]
        xy = c + rng.uniform(-0.15, 0.15, (n, 2))
        grid = rng.choice([-9.9, 9.7, -9.6, 9.95], (512, 512))
    else:
        xy = origins[room] + rng.uniform([0.3, 0.3], [5.7, 3.7], (n, 2))
        grid = np.zeros((512, 512))
    yaw = rng.uniform(-np.pi, np.pi, n)
    yaw[:3] = [0.0, np.pi, -2.5]
    db, tb = pb.beams_from_scan(t(rng.uniform(0.02, 1.6, (n, n_beams)).astype(
        np.float32)), 1.2, 0.05)
    act = np.ones(n, bool)
    act[-1] = False
    return (grid.astype(np.float32), xy.astype(np.float32),
            yaw.astype(np.float32), db.numpy(), tb.numpy(), act)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("form", list(ROOM_FORMS))
def test_grouped_room_forms_match_pallas(rng, form, overlap):
    n_beams, n_groups, ring, tail = ROOM_FORMS[form]
    _, spec_p = _specs(n_beams)
    grid, xy, yaw, db, tb, act = _rooms_case(rng, 4, overlap, n_beams)
    ref, rc = _room_ref(form)(
        jnp.asarray(grid), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(db), jnp.asarray(act), jnp.asarray(tb) if ring else None)
    before = pr.room_raster.launches
    got, gc = pr.room_raster(torch.from_numpy(grid.copy()), t(xy), t(yaw),
                             t(db), t(act), spec_p, PGRID, n_groups=n_groups,
                             per_row=2, trusted=t(tb) if ring else None,
                             reach=26, tail_weight=tail)
    assert pr.room_raster.launches == before      # CPU: the plain version
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert bool((gc.reshape(-1)[:4] > 0).all())
    changed = int((np.asarray(ref) != grid).sum())
    decision_equal(got, ref, f"grouped room {form} map", painted=changed)
    assert changed > 100


def _dropped_cells(n_groups, cols, rows, yaw):
    """Cells the grouped per-cell math paints in the window strips outside
    the fan-bbox strip bounds [t_cl, t_ch): the plain version's deltas
    with and without the strip mask, for agents at (cols, rows) cells and
    headings `yaw` with every beam at the 1.2 m reach (the longest carve).
    Returns (dropped cells, agents that drop any, paintable cells)."""
    n = len(cols)
    spec = pb.BeamSpec.scan(181)
    xy = t(np.stack([cols, rows], -1).astype(np.float32) * 0.05)
    w = pc._windows(torch.zeros(512, 512), xy, t(yaw.astype(np.float32)),
                    torch.full((n, 181), 1.2), torch.ones(n, dtype=torch.bool),
                    spec, PGRID, torch.ones((n, 181), dtype=torch.bool), 26,
                    n_groups=n_groups)
    strips, _ = pc._window_deltas(w, spec, PGRID, True)
    every = w._replace(t_cl=torch.zeros_like(w.t_cl),
                       t_ch=torch.full_like(w.t_ch, w.cols // 128))
    full, _ = pc._window_deltas(every, spec, PGRID, True)
    per_agent = ((full != 0) & (strips == 0)).reshape(n, -1).sum(1)
    return (int(per_agent.sum()), int((per_agent > 0).sum()),
            int((full != 0).sum()))


def test_c1_strip_bounds_drop_cells():
    """ROADMAP C1: the strip bounds come from the beam arc (181 dtheta
    from theta0 - dtheta / 2); the grouped kernels paint from the same
    start to the group-centred bearing's (-pi, pi] wrap, 185.5 degrees at
    181/16 (5 degrees past the beam arc) and 183.5 at 181/8 (3 past). A
    carve of 23.5 cells then reaches 2.25 cells (181/16) or 1.23 (181/8)
    past the arc's end, against 1.5 cells of slack in the bounds: at 181/8
    nothing is dropped; at 181/16 a skipped 128-column strip holds painted
    cells for agents within about 0.1 cell of one offset from a strip edge
    heading along the rows (yaw 0 or pi), and for none of a uniform sweep.
    The port skips them as the reference's kernel does (its maps match
    free_raster_pallas)."""
    edge = np.linspace(257.70, 257.80, 11)           # strip edge at col 256
    edge_cols = np.concatenate([edge, 512.0 - edge])
    edge_rows = np.full(22, 200.0)
    edge_yaw = np.repeat([0.0, np.pi], 11)
    rng = np.random.default_rng(1)
    sweep = (rng.uniform(250.0, 262.0, 48), rng.uniform(60.0, 450.0, 48),
             rng.uniform(-np.pi, np.pi, 48))
    # one torch thread: this test is elementwise work on small tensors, and
    # the pool's threads only contend with the other test workers' for the
    # cores (0.45 s on one thread against 1.4 s on eight, alone)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = {g: (_dropped_cells(g, edge_cols, edge_rows, edge_yaw),
                   _dropped_cells(g, *sweep)) for g in (16, 8)}
    finally:
        torch.set_num_threads(threads)
    for g, ((d_e, a_e, p_e), (d_s, a_s, p_s)) in got.items():
        print(f"C1 181/{g}: {d_e} of {p_e} paintable cells dropped by "
              f"{a_e} of {len(edge_cols)} agents at the strip-edge offset; "
              f"{d_s} of {p_s} by {a_s} of {len(sweep[0])} agents of the "
              f"sweep")
    assert got[16][0][0] > 0
    assert got[8][0][0] == 0 and got[8][1][0] == 0


@pytest.mark.parametrize("room_kernel", [False, True],
                         ids=["window", "room"])
def test_one_step_parity_grouped(room_kernel):
    """`deployable(8, beam_groups=8, merge_every=0)`: the grouped tier with
    the ring and the tail on the 181-beam sweep, through the window or the
    room kernel; one step, port against the jitted JAX step (Pallas in
    interpret mode), from the same state and noise."""
    n = 8
    cfg_j, walls, params, rooms = jax_deployable(
        n, merge_every=0, room_kernel=room_kernel, beam_groups=8)
    cfg, walls_p, params_p, rooms_p = presets.deployable(
        n, device="cpu", merge_every=0, room_kernel=room_kernel,
        beam_groups=8)
    assert convert.config_from(cfg_j) == cfg
    step = js.make_sim_step(cfg_j, jnp.asarray(walls), params, donate=False,
                            walls_grouped=rooms[0], room_of_agent=rooms[1])
    st_j = js.sim_init(cfg_j, params)
    nxt_p, m_p = ps.sim_step(convert.to_torch(st_j, ps.SimState),
                             jax_step_noise(st_j.key, n, 181), cfg, walls_p,
                             params_p, walls_grouped=rooms_p[0],
                             room_of_agent=rooms_p[1])
    with pltpu.force_tpu_interpret_mode():
        nxt_j, m_j = step(st_j)
    for f in ps.StepMetrics._fields:
        a, b = getattr(m_p, f), getattr(m_j, f)
        if a.dtype.is_floating_point:
            assert_close(a, b, what=f)
        else:
            assert_exact(a, b, what=f)
    assert int(m_p.writes) > 0
    decision_equal(nxt_p.srv.logodds, nxt_j.srv.logodds, "grouped step map")
    assert_close(nxt_p.pose_true, nxt_j.pose_true)
    assert_exact(nxt_p.srv.total_writes, nxt_j.srv.total_writes)
