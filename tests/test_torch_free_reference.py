"""The XLA fast free-space tier (`ops.beam_raster.free_raster_reference`,
the sharded engine's use_pallas=False raster) against the jitted JAX
function on the same numpy inputs, and `logodds_delta`'s ordered sum.

1. Every form, as cases of one test: the 181-beam scan per beam and
   grouped (181 in 8 groups, the weak tail at 0.25), the wrapped 4-way fan
   per beam and in 2 groups; the whole grid, a row band and an edge tile
   whose window reaches past the grid (ghost cells); dead agents (their
   evidence times 0, their count kept); a grid pre-filled near +-clamp with
   NaN and -0.0 cells; the rotated partition (`phase`) and
   `line_equivalent=False`. Bar: cells differing by > 1e-6 in at most
   0.01% of the painted cells (atan2 against XLA's, ROADMAP C9 / C21),
   writes within rtol 1e-5; what each form gives here is 0 cells.
2. Decomposition invariance: the band and tile windows paint, bit for
   bit, the cells the whole-grid call paints there (the float coordinates
   stay global), and count the same writes; a tile's ghost cells stay 0.
3. `logodds_delta` (now summed by `ordered_add`) bit-equal to the former
   CPU `index_add_` sum, on the whole grid, a band and a tile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import GridConfig as JGrid
from swarm_tpu.ops import beam_raster as jb
from swarm_tpu_torch.config import GridConfig as PGrid
from swarm_tpu_torch.ops import beam_raster as pb
from swarm_tpu_torch.ops import raster as pr
from tests.torch_parity import f32, t
from tests.torch_parity import torch_one_thread  # noqa: F401

SIZE = 512                             # a 25.6 m grid at origin (0, 0)
N = 8
TILE = ((-24, 304), (-128, 384))       # the corner tile of a 2x2 rank grid
BAND = ((128, 192), None)

# name: (fan, n_groups, tail_weight, window, dead, prefill, phase,
# line_equivalent)
FORMS = {
    "scan-per-beam": ("scan", 181, 0.25, None, False, False, None, True),
    "scan-grouped8": ("scan", 8, 0.25, None, False, False, None, True),
    "wrapped": ("wrap", 4, 0.25, None, False, False, None, True),
    "wrapped-grouped2": ("wrap", 2, 0.25, None, False, False, None, True),
    "band-grouped8": ("scan", 8, 0.25, BAND, False, False, None, True),
    "tile-edge": ("scan", 181, 0.25, TILE, False, False, None, True),
    "tile-edge-wrapped": ("wrap", 4, 0.25, TILE, False, False, None, True),
    "dead": ("scan", 181, 0.0, None, True, True, None, True),
    "dead-grouped-tile": ("scan", 8, 0.25, TILE, True, True, None, True),
    "prefilled": ("scan", 8, 0.25, None, False, True, None, True),
    "prefilled-wrapped": ("wrap", 4, 0.0, None, False, True, None, True),
    "phase": ("scan", 8, 0.25, None, False, False, 5, True),
    "not-line-equivalent": ("scan", 181, 0.25, None, False, False, None,
                            False),
}


def _spec(fan):
    return (jb.BeamSpec.four_way(), pb.BeamSpec.four_way()) if fan == "wrap" \
        else (jb.BeamSpec.scan(181), pb.BeamSpec.scan(181))


def _inputs(fan, window, dead, prefill, seed):
    """Agents (inside the window when there is one, some next to the
    grid's corner for the edge tile), readings and a grid of the window's
    shape."""
    rng = np.random.default_rng(seed)
    if window is TILE:
        lo, hi = np.array([0.3, 0.3]), np.array([10.0, 10.0])
    elif window is BAND:
        lo, hi = np.array([1.5, 8.2]), np.array([24.0, 14.0])
    else:
        lo, hi = np.array([0.3, 0.3]), np.array([25.3, 25.3])
    xy = rng.uniform(lo, hi, (N, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    b = 4 if fan == "wrap" else 181
    dist = rng.uniform(0.05, 1.25, (N, b)).astype(np.float32)
    act = np.ones(N, bool)
    if dead:
        act[::3] = False
    shape = (SIZE, SIZE) if window is None else (
        window[0][1], SIZE if window[1] is None else window[1][1])
    if prefill:
        grid = rng.choice([-9.9, 9.95, -0.0, 0.0, 3.1, -10.0],
                          shape).astype(np.float32)
        grid[rng.random(shape) < 0.01] = np.nan
    else:
        grid = np.zeros(shape, np.float32)
    return grid, xy, yaw, dist, act


@functools.lru_cache(maxsize=None)
def _jax_fn(fan, n_groups, tail, window, line_equivalent, phased):
    """The jitted JAX fast tier of one form (compiled once)."""
    spec = _spec(fan)[0]
    band, band_cols = (None, None) if window is None else window

    def f(grid, xy, yaw, dist, act, phase):
        return jb.free_raster_reference(
            grid, xy, yaw, dist, act, spec,
            JGrid(size=SIZE, origin_x=0.0, origin_y=0.0),
            n_groups=n_groups, line_equivalent=line_equivalent, reach=26,
            band=band, band_cols=band_cols, tail_weight=tail,
            phase=phase if phased else None)
    return jax.jit(f)


def _port(grid, xy, yaw, dist, act, fan, n_groups, tail, window, phase,
          line_equivalent):
    band, band_cols = (None, None) if window is None else window
    return pb.free_raster_reference(
        t(grid), t(xy), t(yaw), t(dist), t(act), _spec(fan)[1],
        PGrid(size=SIZE, origin_x=0.0, origin_y=0.0), n_groups=n_groups,
        line_equivalent=line_equivalent, reach=26, band=band,
        band_cols=band_cols, tail_weight=tail, phase=phase)


@pytest.mark.parametrize("form", list(FORMS))
def test_free_raster_reference_matches_jax(form):
    fan, n_groups, tail, window, dead, prefill, phase, le = FORMS[form]
    grid, xy, yaw, dist, act = _inputs(fan, window, dead, prefill,
                                       seed=len(form))
    ref, w_ref = _jax_fn(fan, n_groups, tail, window, le, phase is not None)(
        jnp.asarray(grid), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(dist), jnp.asarray(act), jnp.int32(phase or 0))
    got, w_got = _port(grid, xy, yaw, dist, act, fan, n_groups, tail, window,
                       phase, le)
    ref, got = np.asarray(ref), f32(got)
    nan_r, nan_g = np.isnan(ref), np.isnan(got)
    np.testing.assert_array_equal(nan_g, nan_r)
    diff = (np.abs(np.where(nan_r, 0, got) - np.where(nan_r, 0, ref))
            > 1e-6)
    painted = max(int((ref != grid)[~nan_r].sum()), 1)
    print(f"{form}: {int(diff.sum())} of {painted} painted cells differ, "
          f"writes {float(w_got)} vs {float(w_ref)}")
    assert painted > 50
    assert diff.sum() <= 1e-4 * painted
    np.testing.assert_allclose(float(w_got), float(w_ref), rtol=1e-5)
    if prefill:
        # a -0.0 cell keeps its sign where only -0.0 evidence reached it,
        # as in the reference's patch adds
        neg_r = (ref == 0) & np.signbit(ref)
        np.testing.assert_array_equal((got == 0) & np.signbit(got), neg_r)
    if dead:
        # dead agents paint nothing but keep their count
        alive_only = _port(grid, xy, yaw, dist * act[:, None], act, fan,
                           n_groups, tail, window, phase, le)[1]
        assert float(w_got) > float(alive_only)


@pytest.mark.parametrize("fan,n_groups", [("scan", 181), ("scan", 8),
                                          ("wrap", 4)])
@pytest.mark.parametrize("window", ["band", "tile"])
def test_windows_bit_equal_to_whole_grid(fan, n_groups, window):
    """The reference's decomposition invariance: a band or tile window
    holds, bit for bit, the whole-grid call's cells at its global place,
    the tile's ghost cells stay 0, and the writes are equal."""
    win = BAND if window == "band" else TILE
    _, xy, yaw, dist, act = _inputs(fan, win, False, False, seed=3)
    whole, w_whole = _port(np.zeros((SIZE, SIZE), np.float32), xy, yaw,
                           dist, act, fan, n_groups, 0.25, None, None, True)
    (r0, nr), cols = win
    c0, nc = cols if cols is not None else (0, SIZE)
    part, w_part = _port(np.zeros((nr, nc), np.float32), xy, yaw, dist, act,
                         fan, n_groups, 0.25, win, None, True)
    gr0, gc0 = max(r0, 0), max(c0, 0)
    gr1, gc1 = min(r0 + nr, SIZE), min(c0 + nc, SIZE)
    inner = part[gr0 - r0:gr1 - r0, gc0 - c0:gc1 - c0]
    assert torch.equal(inner, whole[gr0:gr1, gc0:gc1])
    ghost = torch.ones_like(part, dtype=torch.bool)
    ghost[gr0 - r0:gr1 - r0, gc0 - c0:gc1 - c0] = False
    assert int((part[ghost] != 0).sum()) == 0
    # every agent's evidence lies in the window
    assert int((whole != 0).sum()) == int((inner != 0).sum()) > 50
    assert float(w_part) == float(w_whole)


def _index_add_delta(rays, cfg, k_max, band=None, band_cols=None):
    """`logodds_delta` as the port summed it before: `index_add_` on the
    CPU (index order)."""
    flat, free, occ = pr._traced_cells(rays, cfg, k_max)
    n_rows = n_cols = cfg.size
    if band is not None or band_cols is not None:
        row_off, n_rows = band if band is not None else (0, cfg.size)
        col_off, n_cols = band_cols if band_cols is not None \
            else (0, cfg.size)
        row = torch.div(flat, cfg.size, rounding_mode="floor")
        col = flat - row * cfg.size
        inb = (row >= row_off) & (row < row_off + n_rows) & \
            (col >= col_off) & (col < col_off + n_cols)
        free, occ = free & inb, occ & inb
        flat = (row - row_off) * n_cols + (col - col_off)
    zero = torch.zeros(flat.shape)
    delta = torch.where(occ, zero + cfg.logodds_hit,
                        torch.where(free, zero + cfg.logodds_miss, zero))
    flat_r = torch.where(free | occ, flat, torch.zeros_like(flat))
    out = torch.zeros(n_rows * n_cols).index_add_(
        0, flat_r.reshape(-1).to(torch.int64), delta.reshape(-1))
    return out.reshape(n_rows, n_cols), free.sum() + occ.sum()


@pytest.mark.parametrize("window", [None, BAND, TILE],
                         ids=["whole", "band", "tile"])
@pytest.mark.parametrize("k_max", [1, 32])
def test_ordered_logodds_delta_equals_index_add(window, k_max):
    """`logodds_delta` through `ordered_add` gives the former CPU sum bit
    for bit: 3000 rays crowded into a 6 m square, so that cells take both
    -miss and +hit many times."""
    rng = np.random.default_rng(k_max)
    n = 3000
    ox, oy = rng.uniform(0.0, 6.0, n), rng.uniform(0.0, 6.0, n)
    ang, d = rng.uniform(-np.pi, np.pi, n), rng.uniform(0.0, 1.5, n)
    if k_max == 1:
        ox, oy, d = rng.uniform(0.0, 2.0, n), rng.uniform(0.0, 2.0, n), 0.0
    rays = pr.RayBatch(*(t(np.asarray(a, np.float32)) for a in (
        ox, oy, ox + d * np.cos(ang), oy + d * np.sin(ang))),
        t(rng.random(n) < 0.7), t(rng.random(n) < 0.95))
    cfg = PGrid(size=SIZE)
    band, band_cols = (None, None) if window is None else window
    got, w_got = pr.logodds_delta(rays, cfg, k_max=k_max, band=band,
                                  band_cols=band_cols)
    ref, w_ref = _index_add_delta(rays, cfg, k_max, band, band_cols)
    assert int((ref != 0).sum()) > 100
    assert torch.equal(got, ref) and int(w_got) == int(w_ref)
