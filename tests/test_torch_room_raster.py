"""The port's room-tile raster against the Pallas room kernel, on the CPU.

The plain torch version (`room_raster_plain`, the function the CUDA kernel
is held bit-equal to on the card) runs against
`room_raster_pallas(..., n_groups=n_beams, trusted=..., interpret=True)`,
with the endpoint ring and without it (`trusted=None`), on the 181-beam
scan and on the wrapped 4-way fan.
The pack16 table is bit-exact. The map is decision-equal within a bound:
XLA on the CPU fuses dx*dx + dy*dy into an FMA and its `lax.rsqrt` is not
IEEE 1/sqrt (ROADMAP C9), so a cell on the `r < rb - 0.5` or
`|r - rb| <= 0.71` edge can flip. Bound: cells differing by more than 1e-6
are at most 0.01% of the painted cells; per-tile counts agree to rtol 1e-5.
The engine's room path is held over a merge step at the end
(tests/torch_parity.py `merge_step_parity`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.ops import beam_raster as jb
from swarm_tpu.ops import beam_raster_pallas as jp
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.geom.world import make_tiled_rooms
from swarm_tpu_torch.ops import beam_raster as pb
from swarm_tpu_torch.ops import room_raster_cuda as pr
from tests.torch_parity import (assert_exact, decision_equal,
                                merge_step_parity, t)
from tests.torch_parity import torch_one_thread  # noqa: F401

GRID = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
PER_ROW = 2


def test_pack_range16_exact(rng):
    for n_beams in (37, 181):
        d = rng.uniform(-1.0, 140.0, (7, n_beams)).astype(np.float32)
        trusted = rng.random((7, n_beams)) < 0.6
        ref = jp._pack_range16(jnp.asarray(d), jnp.asarray(trusted))
        got = pb._pack_range16(t(d), t(trusted))
        assert got.dtype == torch.int32
        assert_exact(got, ref)
        for half in range(2):
            v16 = (got >> (16 * half)) & 0xFFFF
            rb, tf = pb._unpack_range16(v16)
            jrb, jtf = jp._unpack_range16(
                jax.lax.shift_right_logical(jnp.asarray(ref), 16 * half)
                & 0xFFFF, True, v16.shape)
            assert_exact(rb, jrb)
            assert_exact(tf, jtf)
    assert pb.RANGE_QUANT == jb.RANGE_QUANT
    assert pb.RANGE_MAX_CELLS == jb.RANGE_MAX_CELLS


def _rooms_case(rng, n_rooms, overlap, n_beams=181):
    """Agents 2k, 2k+1 in room k of a tiled world (PER_ROW rooms per tile
    row on a 512^2 grid: tiles past the last room stay empty); the last
    agent inactive. overlap: both agents of a room within +-3 cells of one
    point, on a grid pre-filled near +-clamp, so the slot order decides
    cells."""
    _, origins = make_tiled_rooms(n_rooms, per_row=PER_ROW)
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
    dist = rng.uniform(0.02, 1.6, (n, n_beams))
    db, tb = pb.beams_from_scan(t(dist.astype(np.float32)), 1.2, 0.05)
    act = np.ones(n, bool)
    act[-1] = False
    return (grid.astype(np.float32), xy.astype(np.float32),
            yaw.astype(np.float32), db.numpy(), tb.numpy(), act)


@pytest.mark.parametrize("n_rooms,overlap", [(3, False), (4, True)])
def test_plain_matches_pallas_room_kernel(rng, n_rooms, overlap):
    grid, xy, yaw, db, tb, act = _rooms_case(rng, n_rooms, overlap)
    spec_j, spec_p = jb.BeamSpec.scan(181), pb.BeamSpec.scan(181)
    ref, rc = jp.room_raster_pallas(
        jnp.asarray(grid), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(db), jnp.asarray(act), spec_j, GRID, n_groups=181,
        per_row=PER_ROW, trusted=jnp.asarray(tb), reach=26, interpret=True)
    before = pr.room_raster.launches
    got, gc = pr.room_raster(torch.from_numpy(grid.copy()), t(xy), t(yaw),
                             t(db), t(act), spec_p, GRID, n_groups=181,
                             per_row=PER_ROW, trusted=t(tb), reach=26)
    assert pr.room_raster.launches == before      # CPU: the plain version
    assert tuple(gc.shape) == (4, 2)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert float(gc.sum()) > 0
    # every room paints (the last one holds one live agent and one
    # inactive one); the tiles past the last room are empty
    assert bool((gc.reshape(-1)[:n_rooms] > 0).all())
    assert float(gc.reshape(-1)[n_rooms:].abs().sum()) == 0.0
    changed = (np.asarray(ref) != grid).sum()
    decision_equal(got, ref, "room map", painted=changed)
    assert int((got.numpy() != grid).sum()) > 1000


# the room kernel's forms besides the ring on the scan: (beams, ring) —
# bench.py --room-kernel with --exact-endpoints, --scan-rays 0, or both
ROOM_FORMS = {"scan": (181, False), "4way-ring": (4, True), "4way": (4, False)}


@pytest.mark.parametrize("form,n_rooms,overlap", [
    ("scan", 3, False), ("scan", 4, True), ("4way-ring", 3, False),
    ("4way-ring", 4, True), ("4way", 4, True)])
def test_room_forms_match_pallas(rng, form, n_rooms, overlap):
    """The room kernel without the ring (every bit of the pack16 field is
    range) and on the wrapped 4-way fan, with and without the ring, against
    the jitted `room_raster_pallas(..., trusted=None | tb,
    interpret=True)`; headings include 0, pi and -2.5 rad, where the
    wrapped fan's bin is negative before its floor-mod."""
    n_beams, ring = ROOM_FORMS[form]
    grid, xy, yaw, db, tb, act = _rooms_case(rng, n_rooms, overlap, n_beams)
    yaw[:3] = [0.0, np.pi, -2.5]
    if n_beams == 4:
        spec_j, spec_p = jb.BeamSpec.four_way(), pb.BeamSpec.four_way()
    else:
        spec_j, spec_p = jb.BeamSpec.scan(181), pb.BeamSpec.scan(181)
    # under jit, as the engine runs it (ROADMAP C15)
    ref, rc = jax.jit(lambda *a: jp.room_raster_pallas(
        *a[:5], spec_j, GRID, n_groups=n_beams, per_row=PER_ROW,
        trusted=a[5], reach=26, interpret=True))(
        jnp.asarray(grid), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(db), jnp.asarray(act), jnp.asarray(tb) if ring else None)
    before = pr.room_raster.launches
    got, gc = pr.room_raster(torch.from_numpy(grid.copy()), t(xy), t(yaw),
                             t(db), t(act), spec_p, GRID, n_groups=n_beams,
                             per_row=PER_ROW, trusted=t(tb) if ring else None,
                             reach=26)
    assert pr.room_raster.launches == before      # CPU: the plain version
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert bool((gc.reshape(-1)[:n_rooms] > 0).all())
    changed = int((np.asarray(ref) != grid).sum())
    decision_equal(got, ref, f"room {form} map", painted=changed)
    assert changed > 100


def test_inactive_room_is_a_noop():
    """All agents inactive on a zero grid: the map and counts stay zero
    (the act multiply), on both sides."""
    _, origins = make_tiled_rooms(2, per_row=PER_ROW)
    xy = np.repeat(origins, 2, axis=0) + 2.0
    act = np.zeros(4, bool)
    db = np.full((4, 37), 1.0, np.float32)
    tb = np.ones((4, 37), bool)
    got, gc = pr.room_raster_plain(torch.zeros(512, 512), t(xy), t(
        np.zeros(4, np.float32)), t(db), t(act), pb.BeamSpec.scan(37), GRID,
        n_groups=37, per_row=PER_ROW, trusted=t(tb), reach=26)
    ref, rc = jp.room_raster_pallas(
        jnp.zeros((512, 512)), jnp.asarray(xy, jnp.float32),
        jnp.zeros((4,)), jnp.asarray(db), jnp.asarray(act),
        jb.BeamSpec.scan(37), GRID, n_groups=37, per_row=PER_ROW,
        trusted=jnp.asarray(tb), reach=26, interpret=True)
    assert float(got.abs().max()) == 0.0 == float(jnp.abs(ref).max())
    assert float(gc.abs().max()) == 0.0 == float(jnp.abs(rc).max())


def test_refusals():
    """The reach that does not fit a tile is refused on both sides; a
    grouped table past the kernel's 512 groups, a bfloat16 grid (the
    reference's sim_init refuses it with the room kernel) and a grid on
    neither the CPU nor the card are refused by the port."""
    spec = pb.BeamSpec.scan(181)
    args = (torch.zeros(1, 2), torch.zeros(1), torch.ones(1, 181),
            torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="does not fit"):
        pr.room_raster(torch.zeros(512, 512), *args, spec, GRID,
                       n_groups=181, trusted=torch.ones(1, 181, dtype=bool),
                       reach=61)
    with pytest.raises(ValueError, match="does not fit"):
        jp.room_raster_pallas(jnp.zeros((512, 512)), jnp.zeros((1, 2)),
                              jnp.zeros((1,)), jnp.ones((1, 181)),
                              jnp.ones((1,), bool), jb.BeamSpec.scan(181),
                              GRID, n_groups=181,
                              trusted=jnp.ones((1, 181), bool), reach=61,
                              interpret=True)
    wide = (torch.zeros(1, 2), torch.zeros(1), torch.ones(1, 1200),
            torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="512-group"):
        pr.room_raster(torch.zeros(512, 512), *wide, pb.BeamSpec.scan(1200),
                       GRID, n_groups=600, reach=26)
    with pytest.raises(ValueError, match="bfloat16"):
        pr.room_raster(torch.zeros(512, 512, dtype=torch.bfloat16), *args,
                       spec, GRID, n_groups=181, reach=26)
    with pytest.raises(ValueError):
        pr.room_raster(torch.zeros(512, 512, device="meta"), *args, spec,
                       GRID, n_groups=181,
                       trusted=torch.ones(1, 181, dtype=bool), reach=26)


def test_room_merge_step_parity():
    """`deployable(8, room_kernel=True, merge_every=4)`: step 3 (a merge
    step) through the room raster, port against JAX."""
    merge_step_parity(room_kernel=True)
