"""The port's frontier detection and target assignment (ops/frontier.py,
coord/assign.py, models/nav.assign_target, geom/world.agent_room_boxes)
against the JAX functions, on the CPU.

Everything here is exact: masks, labels, sizes, counts, targets and
has_target bit for bit; centroids exact too, except the block-pooled
route at atol 1e-5 (its centroid divides the same float32 sums, but XLA
may contract `counts * base + sdx` into a fused multiply-add; the products
are small integers, so in practice the two agree exactly as well).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarm_tpu.config import CoordConfig, GridConfig
from swarm_tpu.coord import assign as ja
from swarm_tpu.geom import world as jw
from swarm_tpu.models import nav as jn
from swarm_tpu.ops import frontier as jf
from swarm_tpu_torch import convert
from swarm_tpu_torch.config import CoordConfig as PCoord
from swarm_tpu_torch.config import GridConfig as PGrid
from swarm_tpu_torch.coord import assign as pa
from swarm_tpu_torch.geom import world as pw
from swarm_tpu_torch.models import nav as pn
from swarm_tpu_torch.ops import frontier as pf
from tests.torch_parity import assert_close, assert_exact, t


def _tri_grid(rng, size, free_frac):
    """A random tri-state map with blob-shaped free, occupied and unknown
    regions (a smoothed noise field, thresholded): frontiers of many
    lengths, some components far longer than a block."""
    g = rng.standard_normal((size // 8 + 2, size // 8 + 2))
    field = np.kron(g, np.ones((8, 8)))[:size, :size]
    field += 0.6 * rng.standard_normal((size, size))
    cfg = GridConfig(size=size)
    out = np.full((size, size), cfg.unknown, np.int8)
    lo, hi = np.quantile(field, [free_frac, free_frac + 0.08])
    out[field < lo] = cfg.free
    out[field > hi + 1.0] = cfg.occupied
    return out


@pytest.mark.parametrize("size,free_frac,min_cluster,k_max", [
    (64, 0.3, 3, 64), (256, 0.5, 1, 4096), (512, 0.4, 3, 64),
    (512, 0.15, 1, 4096)])
def test_frontier_clusters_exact(rng, size, free_frac, min_cluster, k_max):
    grid = _tri_grid(rng, size, free_frac)
    gj = GridConfig(size=size, origin_x=-3.0, origin_y=0.0)
    gp = convert.config_from(gj, PGrid)
    mask_j = jf.frontier_mask(jnp.asarray(grid), gj)
    mask_p = pf.frontier_mask(t(grid), gp)
    assert_exact(mask_p, mask_j)
    cj = CoordConfig(frontier_min_cluster=min_cluster, max_frontiers=k_max)
    ref = jf.frontier_clusters(jnp.asarray(grid), gj, cj)
    got = pf.frontier_clusters(t(grid), gp, convert.config_from(cj, PCoord))
    assert_exact(got[2], ref[2])
    assert_exact(got[1], ref[1])
    assert_exact(got[0], ref[0])
    assert int(got[2]) > 0
    print(f"{size}^2, min cluster {min_cluster}, cap {k_max}: "
          f"{int(got[2])} clusters")


def test_label_components_exact(rng):
    """The labels themselves (the minimum flat index of each component) of
    a frontier mask, whose components are long thin curves."""
    mask = pf.frontier_mask(t(_tri_grid(rng, 256, 0.5)), PGrid(size=256))
    lbl = pf.label_components(mask)
    assert_exact(lbl, jf.label_components(jnp.asarray(mask.numpy())))
    assert int((lbl < pf.BIG).sum()) == int(mask.sum()) > 0


@pytest.mark.parametrize("free_frac", [0.15, 0.45])
def test_frontier_targets_coarse(rng, free_frac):
    size = 1024
    grid = _tri_grid(rng, size, free_frac)
    gj = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    gp = convert.config_from(gj, PGrid)
    for k_max in (64, 4096):
        cj = CoordConfig(max_frontiers=k_max)
        ref = jf.frontier_targets_coarse(jnp.asarray(grid), gj, cj)
        got = pf.frontier_targets_coarse(t(grid), gp,
                                         convert.config_from(cj, PCoord))
        assert_exact(got[2], ref[2])
        assert_exact(got[1], ref[1])
        assert_close(got[0], ref[0], atol=1e-5, rtol=0)
        assert 0 < int(got[2]) <= k_max
        print(f"coarse, cap {k_max}: {int(got[2])} targets")


def _assign_case(rng, n, k=64):
    """n agents, two per tiled room; centroids mostly inside rooms, some
    on room edges and outside every room; n_centroids < k."""
    n_rooms = n // 2
    walls, origins = pw.make_tiled_rooms(n_rooms, per_row=4)
    wg = pw.walls_by_group(walls)
    roa = np.arange(n) // 2
    boxes = pw.agent_room_boxes(wg, roa)
    room = rng.integers(0, n_rooms, k)
    cents = origins[room] + rng.uniform([-0.5, -0.5], [6.5, 4.5], (k, 2))
    cents[:4] = boxes[2 * room[:4], :2]                   # on a corner
    xy = origins[roa] + rng.uniform([0.2, 0.2], [5.8, 3.8], (n, 2))
    online = rng.random(n) < 0.9
    return (xy.astype(np.float32), online, cents.astype(np.float32),
            wg, roa, boxes)


@pytest.mark.parametrize("n", [16, 160])
def test_greedy_assign_exact(rng, n):
    xy, online, cents, wg, roa, boxes = _assign_case(rng, n)
    assert_exact(pw.agent_room_boxes(t(wg), t(roa)),
                 jw.agent_room_boxes(wg, roa))
    cj = CoordConfig()
    cp = convert.config_from(cj, PCoord)
    for n_c in (0, 5, 50):
        args_j = (jnp.asarray(xy), jnp.asarray(online), jnp.asarray(cents),
                  jnp.int32(n_c))
        args_p = (t(xy), t(online), t(cents), torch.tensor(n_c))
        for boxes_j, boxes_p in ((None, None), (boxes, t(boxes))):
            ref = ja.greedy_assign(*args_j, cj, room_boxes=boxes_j)
            got = pa.greedy_assign(*args_p, cp, room_boxes=boxes_p)
            assert_exact(got[1], ref[1])
            assert_exact(got[0], ref[0])
        ref = ja.greedy_assign_rooms(*args_j, cj, room_boxes=boxes)
        rounds = pa.room_rounds(boxes, "cpu")
        assert len(rounds[0]) == 2
        got = pa.greedy_assign_rooms(*args_p, cp, rounds)
        assert_exact(got[1], ref[1])
        assert_exact(got[0], ref[0])
        if n_c == 50:
            assert int(got[1].sum()) > 0


def test_assign_target(rng):
    n = 64
    nav_j = jn.nav_init(n)
    st = rng.integers(0, 6, n).astype(np.int32)
    done = rng.random(n) < 0.2
    nav_j = nav_j._replace(state=jnp.asarray(st),
                           mission_complete=jnp.asarray(done),
                           target_age_s=jnp.asarray(rng.uniform(0, 9, n),
                                                    jnp.float32))
    tgt = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    mask = rng.random(n) < 0.6
    ref = jn.assign_target(nav_j, jnp.asarray(tgt), jnp.asarray(mask))
    got = pn.assign_target(convert.to_torch(nav_j, pn.NavState), t(tgt),
                           t(mask))
    for f in pn.NavState._fields:
        assert_exact(getattr(got, f), getattr(ref, f), what=f)
    assert int(got.has_target.sum()) > 0
