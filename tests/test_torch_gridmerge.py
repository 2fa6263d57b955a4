"""Grid matching and the offline map merge (swarm_tpu_torch/slam/
scanmatch.py `match_grids`, slam/merge.py) against the JAX package's, on
the CPU, at 96^2 maps with a +-8-cell search and 5 rotations.

Maps are made from a seed with numpy: a room's walls painted into a
log-odds grid, and a copy shifted by a few cells with its own noise. Bars:
the stable top-k's indices exact against `jax.lax.top_k` on tied values
(the lower index first); rotated stacks, warps and merged maps at 1e-4
(XLA fuses the rotation of a cell coordinate into FMAs, ROADMAP C9: an ulp
of a coordinate near 48 cells, 4e-6, times a log-odds step of 2-4 moves a
bilinear sample by up to ~3e-5);
`ok` exact, fitness and rotations within 1e-4, translations within 5e-4 m
(a hundredth of a cell: the parabolic sub-cell refinement of a flat peak
amplifies the sums' last bits, tests/test_torch_closurematch.py). The
dynamic-extent merge's reports and bounds-fitted grid against the JAX
function on two differently-sized, offset submaps of one room.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import GridConfig as JGrid
from swarm_tpu.config import SlamConfig as JSlam
from swarm_tpu.slam import merge as jmg
from swarm_tpu.slam import scanmatch as jsm
from swarm_tpu_torch import convert
from swarm_tpu_torch.config import GridConfig as PGrid
from swarm_tpu_torch.config import SlamConfig as PSlam
from swarm_tpu_torch.slam import merge as pmg
from swarm_tpu_torch.slam import scanmatch as psm
from tests.torch_parity import assert_close, assert_exact, t
from tests.torch_parity import torch_one_thread  # noqa: F401

S = 96
SLAM_J = JSlam(scanmatch_window_cells=8, scanmatch_angles=5,
               scanmatch_angle_range=0.1, scanmatch_points=300)
GRID_J = JGrid(size=S)
SLAM_P = convert.config_from(SLAM_J, PSlam)
GRID_P = convert.config_from(GRID_J, PGrid)
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_T = dict(rtol=0.0, atol=5e-4)


def _room_map(seed, shift=(0, 0)):
    """Log-odds [S, S]: a room's walls at +2 (with an inner wall), the rest
    weak noise; `shift` rolls it by (rows, cols)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0.0, 0.05, (S, S)).astype(np.float32)
    g[20, 15:80] = g[75, 15:80] = 2.0
    g[20:76, 15] = g[20:76, 80] = 2.0
    g[20:50, 45] = 2.0
    g[60:76, 30] = 2.0
    return np.roll(g, shift, axis=(0, 1))


def test_top_k_stable_takes_the_lower_index_among_ties():
    x = np.zeros(400, np.float32)
    x[::7] = 1.0
    x[[3, 50, 51]] = 2.0
    v_j, i_j = jax.lax.top_k(jnp.asarray(x), 80)
    v_p, i_p = psm._top_k_stable(t(x), 80)
    assert_exact(i_p, i_j)
    assert_exact(v_p, v_j)


def test_rotated_mass_stack_and_rotate_grid():
    occ = (_room_map(0) >= 0.3).astype(np.float32)      # tied ones
    thetas = np.linspace(-0.1, 0.1, 5).astype(np.float32)
    ref = jax.jit(jsm._rotated_mass_stack, static_argnums=2)(
        occ, thetas, 300)
    got = psm._rotated_mass_stack(t(occ), t(thetas), 300)
    assert_close(got, ref, rtol=1e-4, atol=1e-4)
    ref = jax.jit(lambda o, th: jsm._rotate_grid(o, th, GRID_J))(occ, 0.2)
    assert_close(psm._rotate_grid(t(occ), torch.tensor(0.2)), ref,
                 rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("warp", [(0.0, 0.0, 0.0), (3.5, -2.25, 0.2),
                                  (-7.0, 4.0, -0.4)])
def test_warp_grid(warp):
    g = _room_map(1)
    ref = jax.jit(jmg.warp_grid, static_argnames="fill")(g, *warp,
                                                         fill=-1.0)
    got = pmg.warp_grid(t(g), torch.tensor(warp[0]), torch.tensor(warp[1]),
                        torch.tensor(warp[2]), fill=-1.0)
    assert_close(got, ref, rtol=1e-4, atol=1e-4)


def _same_match(got, ref):
    assert_exact(got.ok, ref.ok, "ok")
    assert_close(got.fitness, ref.fitness, **TOL, what="fitness")
    assert_close(got.dtheta, ref.dtheta, **TOL, what="dtheta")
    assert_close(got.dx, ref.dx, **TOL_T, what="dx")
    assert_close(got.dy, ref.dy, **TOL_T, what="dy")
    assert_close(got.score, ref.score, rtol=1e-5, atol=1e-4, what="score")


@functools.lru_cache(maxsize=None)
def _jax_match_batch():
    return jax.jit(lambda lo, g: jsm.match_grids_batch(lo, g, GRID_J,
                                                       SLAM_J))


def test_match_grids_and_batch():
    glob = (_room_map(2) >= 0.3).astype(np.float32)
    locs = np.stack([(_room_map(3 + k, sh) >= 0.3).astype(np.float32)
                     for k, sh in enumerate([(3, -2), (-5, 4), (0, 0)])])
    ref = _jax_match_batch()(locs, glob)
    got = psm.match_grids_batch(t(locs), t(glob), GRID_P, SLAM_P)
    _same_match(got, ref)
    assert bool(got.ok.all())
    one = psm.match_grids(t(locs[0]), t(glob), GRID_P, SLAM_P)
    _same_match(one, jsm.MatchResult(*(np.asarray(f)[0] for f in ref)))


def test_merge_local_maps():
    maps = np.stack([_room_map(4), _room_map(5, (2, -3)),
                     _room_map(6, (-4, 1)),
                     np.random.default_rng(7).normal(0, 1, (S, S)).astype(
                         np.float32)])
    ref = jax.jit(lambda m: jmg.merge_local_maps(m, GRID_J, SLAM_J))(maps)
    got = pmg.merge_local_maps(t(maps), GRID_P, SLAM_P)
    _same_match(got.transforms, ref.transforms)
    assert_exact(got.merged, ref.merged)
    assert_close(got.global_logodds, ref.global_logodds, rtol=1e-4,
                 atol=1e-4)
    assert bool(got.merged[1]) and bool(got.merged[2])


def _wall_submap(origin, width, height, drift_x=0.0, res=0.05):
    """A 4 x 2 m room perimeter with an interior wall, cropped to the
    submap's extent; drift_x shifts the reported origin."""
    grid = np.zeros((height, width), np.int8)
    ox, oy = origin

    def mark(x, y):
        cx = int(np.floor((x - ox) / res))
        cy = int(np.floor((y - oy) / res))
        if 0 <= cx < width and 0 <= cy < height:
            grid[cy, cx] = 100

    for s in np.arange(0.0, 4.0, res / 2):
        mark(s, 1.0)
        mark(s, 3.0)
    for s in np.arange(1.0, 3.0, res / 2):
        mark(0.0, s)
        mark(4.0, s)
    for s in np.arange(1.0, 2.0, res / 2):
        mark(2.0, s)
    return grid, (ox + drift_x, oy)


def test_merge_submaps_dynamic():
    a = _wall_submap((-0.25, 0.75), 92, 50)
    b = _wall_submap((1.25, 0.75), 62, 52, drift_x=0.15)
    empty = (np.zeros((10, 10), np.int8), (0.0, 0.0))
    grid_j, origin_j, rep_j = jmg.merge_submaps_dynamic([a, empty, b], 0.05,
                                                        SLAM_J)
    grid_p, origin_p, rep_p = pmg.merge_submaps_dynamic(
        [a, empty, b], 0.05, SLAM_P, device="cpu")
    assert [r["ok"] for r in rep_p] == [r["ok"] for r in rep_j]
    for rp, rj in zip(rep_p, rep_j):
        assert rp.get("reason") == rj.get("reason")
        assert abs(rp["fitness"] - rj["fitness"]) < 1e-4
        for k in ("dx", "dy"):
            assert abs(rp[k] - rj[k]) < 5e-4, (k, rp, rj)
        assert abs(rp["dtheta"] - rj["dtheta"]) < 1e-4
    assert rep_p[2]["ok"] and abs(rep_p[2]["dx"] + 0.15) < 0.06
    assert grid_p.shape == grid_j.shape
    assert_close(np.asarray(origin_p), np.asarray(origin_j), rtol=0,
                 atol=1e-3)
    assert int((grid_p != grid_j).sum()) <= 0.01 * int((grid_j == 100).sum())
    pts = pmg.submap_points(*a, 0.05)
    assert_exact(pts, jmg.submap_points(*a, 0.05))
    assert_exact(pmg._voxel_downsample(pts, 0.05),
                 jmg._voxel_downsample(pts, 0.05))
    g_p, o_p = pmg.global_map_from_points(pts, 0.05)
    g_j, o_j = jmg.global_map_from_points(pts, 0.05)
    assert_exact(g_p, g_j)
    assert o_p == o_j
