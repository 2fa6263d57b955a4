"""The window raster's band and tile forms (the sharded engine's
`free_raster_pallas(..., band=, band_cols=)`) and the band forms of
`logodds_delta`, against the JAX functions on the CPU.

- The plain band and tile forms against the jitted
  `free_raster_pallas(..., band=, band_cols=, interpret=True)`, called
  directly (no shard_map), on a 512^2 grid with 8 agents (one dead): every
  form the sharded body reaches (pack16 or grouped table, ring on / off,
  the scan / the wrapped 4-way fan), on a mid-grid row band (rank 1 of a
  4-rank "rows" layout) and on a corner tile window (rank 0 of a 2x2
  "tiles" layout: negative offsets, the grid-edge guard on). Maps
  decision-equal (cells differing by > 1e-6 at most 0.01% of the painted
  cells), counts rtol 1e-5.
- `logodds_delta` on a band and a tile window, exact against the jitted
  JAX function; `patch_origin` with the window's rows and columns, exact.
- The launch-count names of the windows, the bf16 refusal, and the tile
  pairs of a grid whose last tile row is ragged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import GridConfig
from swarm_tpu.ops import beam_raster as jb
from swarm_tpu.ops import beam_raster_pallas as jp
from swarm_tpu.ops import raster as jr
from swarm_tpu_torch import convert
from swarm_tpu_torch.config import GridConfig as PGrid
from swarm_tpu_torch.ops import beam_raster as pb
from swarm_tpu_torch.ops import beam_raster_cuda as pc
from swarm_tpu_torch.ops import raster as pr
from tests.torch_parity import assert_exact, decision_equal, t
from tests.torch_parity import torch_one_thread  # noqa: F401

SIZE = 512
GRID = GridConfig(size=SIZE, origin_x=0.0, origin_y=0.0)
PGRID = convert.config_from(GRID, PGrid)
# (band, band_cols): rank 1 of a 4-rank rows layout; rank 0 of a 2x2 tiles
# layout (a 256^2 core tile, halo 32 rows x 128 columns at the 26-cell
# reach, parallel/sharded._tile_halo)
WINDOWS = {"band": ((128, 128), None),
           "tile": ((-32, 256 + 64), (-128, 256 + 256))}
# agent cells (row, col) inside each window: spread, near its edges and, on
# the tile, at the global grid's corner (the guard drops the ghost cells)
CELLS = {"band": [[150.0, 30.0], [200.0, 260.0], [240.0, 500.0],
                  [170.0, 130.0], [230.0, 380.0], [135.0, 450.0],
                  [205.0, 262.0], [160.0, 10.0]],
         "tile": [[3.0, 4.0], [20.0, 200.0], [250.0, 250.0],
                  [100.0, 100.0], [240.0, 10.0], [8.0, 254.0],
                  [128.0, 2.0], [60.0, 60.0]]}
# (beams, groups, ring): every f32 form the sharded body reaches
FORMS = {"pack16-ring": (181, 181, True), "pack16": (181, 181, False),
         "pack16-ring-wrapped": (4, 4, True), "pack16-wrapped": (4, 4, False),
         "grouped-ring": (181, 8, True), "grouped": (181, 8, False),
         "grouped-ring-wrapped": (4, 2, True),
         "grouped-wrapped": (4, 2, False)}


def _specs(n_beams):
    if n_beams == 4:
        return jb.BeamSpec.four_way(), pb.BeamSpec.four_way()
    return jb.BeamSpec.scan(n_beams), pb.BeamSpec.scan(n_beams)


@functools.lru_cache(maxsize=None)
def _ref(form, window):
    """The jitted free_raster_pallas of a form on a window, compiled once
    per module."""
    n_beams, n_groups, _ = FORMS[form]
    spec_j, _ = _specs(n_beams)
    band, band_cols = WINDOWS[window]
    return jax.jit(lambda g, xy, yaw, d, act, tr: jp.free_raster_pallas(
        g, xy, yaw, d, act, spec_j, GRID, n_groups=n_groups, reach=26,
        trusted=tr, tail_weight=0.25, interpret=True, band=band,
        band_cols=band_cols))


def _agents(window, n_beams, seed):
    r = np.random.default_rng(seed)
    xy = np.asarray(CELLS[window], np.float32)[:, ::-1] * GRID.resolution
    n = xy.shape[0]
    yaw = r.uniform(-np.pi, np.pi, n).astype(np.float32)
    yaw[:3] = [0.0, np.pi, -2.5]
    dist = r.uniform(0.15, 1.19, (n, n_beams)).astype(np.float32)
    trusted = r.random((n, n_beams)) < 0.7
    act = np.ones(n, bool)
    act[3] = False
    return xy, yaw, dist, trusted, act


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("form", list(FORMS))
def test_band_forms_match_pallas(form, window):
    n_beams, n_groups, ring = FORMS[form]
    _, spec_p = _specs(n_beams)
    band, band_cols = WINDOWS[window]
    shape = (band[1], SIZE if band_cols is None else band_cols[1])
    xy, yaw, dist, trusted, act = _agents(window, n_beams, n_groups)
    tr = trusted if ring else None
    ref, rc = _ref(form, window)(
        jnp.zeros(shape, jnp.float32), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(dist), jnp.asarray(act),
        None if tr is None else jnp.asarray(tr))
    before = pc.free_raster.launches
    got, gc = pc.free_raster(torch.zeros(shape), t(xy), t(yaw), t(dist),
                             t(act), None if tr is None else t(tr), spec_p,
                             PGRID, reach=26, pack8=False, n_groups=n_groups,
                             tail_weight=0.25, band=band,
                             band_cols=band_cols)
    assert pc.free_raster.launches == before     # CPU: the plain version
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert float(gc.sum()) > 0 and float(gc[3]) == 0.0
    changed = int((np.asarray(ref) != 0).sum())
    assert changed > 100
    decision_equal(got, ref, f"{form} on the {window} map", painted=changed)
    if window == "tile":
        # the guard: nothing lands outside the global grid (the halo's
        # rows above row 0 and columns left of column 0)
        assert float(got[:32].abs().sum()) == 0.0
        assert float(got[:, :128].abs().sum()) == 0.0


def test_band_window_names_and_refusals():
    """The launch-count keys name the window; bf16 is refused on a band,
    as the sharded engine refuses it; a window of the wrong shape too."""
    scan, four = pb.BeamSpec.scan(181), pb.BeamSpec.four_way()
    assert pc.form_name(scan, False, True, window="tile") == \
        "pack16-ring-tile"
    assert pc.form_name(four, False, False, grouped=True,
                        window="band") == "grouped-wrapped-band"
    assert pc.window_kind((0, 512), None) == "band"
    assert pc.window_kind((0, 512), (-128, 768)) == "tile"
    assert pc.window_kind(None, None) == ""
    xy, yaw = torch.tensor([[7.5, 9.0]]), torch.zeros(1)
    d, act = torch.ones(1, 181), torch.ones(1, dtype=torch.bool)
    with pytest.raises(ValueError, match="float32"):
        pc.free_raster(torch.zeros(128, SIZE, dtype=torch.bfloat16), xy, yaw,
                       d, act, None, scan, PGRID, reach=26, band=(128, 128))
    with pytest.raises(ValueError, match="band / tile window"):
        pc.free_raster(torch.zeros(100, SIZE), xy, yaw, d, act, None, scan,
                       PGRID, reach=26, band=(128, 128))


def test_patch_origin_windows_exact(rng):
    """Window origins on a band and on a tile window, with the cells
    shifted by the offsets as both entry points shift them."""
    ax = rng.uniform(-140.0, 700.0, 300).astype(np.float32)
    ay = rng.uniform(-40.0, 400.0, 300).astype(np.float32)
    for (row_off, n_rows), cols in ((WINDOWS["band"][0], None),
                                    WINDOWS["tile"]):
        n_cols = None if cols is None else cols[1]
        sx = ax if cols is None else ax - np.float32(cols[0])
        sy = ay - np.float32(row_off)
        ref = jb.patch_origin(jnp.asarray(sx), jnp.asarray(sy), SIZE, 64,
                              256, 26, n_rows=n_rows, n_cols=n_cols)
        got = pb.patch_origin(t(sx), t(sy), SIZE, 64, 256, 26,
                              n_rows=n_rows, n_cols=n_cols)
        assert_exact(got[0], ref[0])
        assert_exact(got[1], ref[1])


@pytest.mark.parametrize("window", list(WINDOWS))
def test_logodds_delta_band_exact(rng, window):
    """`logodds_delta`'s band and tile forms (the sharded body's ring-less
    endpoint scatter, and its line rays), exact against the jitted JAX
    function: delta and writes."""
    band, band_cols = WINDOWS[window]
    n = 400
    o = rng.uniform(0.0, SIZE * 0.05, (n, 2)).astype(np.float32)
    h = (o + rng.uniform(-1.3, 1.3, (n, 2))).astype(np.float32)
    hv = rng.random(n) < 0.7
    act = rng.random(n) < 0.9
    for k_max, (ox, oy) in ((32, (o[:, 0], o[:, 1])),
                            (1, (h[:, 0], h[:, 1]))):
        ref_fn = jax.jit(lambda ox, oy, hx, hy, v, a, k=k_max:
                         jr.logodds_delta(jr.RayBatch(ox, oy, hx, hy, v, a),
                                          GRID, k_max=k, band=band,
                                          band_cols=band_cols))
        d_ref, w_ref = ref_fn(*(jnp.asarray(a) for a in (
            ox, oy, h[:, 0], h[:, 1], hv, act)))
        d, w = pr.logodds_delta(pr.RayBatch(*(t(a) for a in (
            ox, oy, h[:, 0], h[:, 1], hv, act))), PGRID, k_max=k_max,
            band=band, band_cols=band_cols)
        assert_exact(d, d_ref)
        assert int(w) == int(w_ref)
        assert int(w) > 0


def test_tile_pairs_ragged_last_row():
    """On a band whose height is not a multiple of the 64-row CUDA tile,
    the tile pairs list every tile a window meets, the ragged last row's
    too, and none past the grid."""
    h, w = 200, 512
    wins = pc._windows(
        torch.zeros(h, w), torch.tensor([[3.0, 13.5], [20.0, 8.0],
                                          [12.0, 2.0]]),
        torch.zeros(3), torch.ones(3, 181), torch.ones(3, dtype=torch.bool),
        pb.BeamSpec.scan(181), PGRID, None, 26, pack8=False,
        band=(80, h))
    assert int(wins.row0.max()) + wins.rows == h      # one at the bottom
    start, agent, slot, k, n = pc._tile_pairs(wins, h, w)
    n_tc = w // pc.TILE_C
    assert start.shape[0] == -(-h // pc.TILE_R) * n_tc + 1
    for a in range(n):
        tiles = {int(tile) for tile in range(start.shape[0] - 1)
                 for q in range(int(start[tile]), int(start[tile + 1]))
                 if int(agent[q]) == a}
        r0, c0 = int(wins.row0[a]), int(wins.col0[a])
        want = {(r // pc.TILE_R) * n_tc + c // pc.TILE_C
                for r in range(r0, r0 + wins.rows)
                for c in range(c0, c0 + wins.cols)}
        assert tiles == want
