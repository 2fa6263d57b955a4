"""The port's ray ops (ops/bresenham.py, ops/raster.py) and the exact
endpoint scatter the engine runs after a window raster without an endpoint
ring, against the JAX functions, on the CPU.

Integer work (Bresenham cells, grid indices, write counts) is exact. The
log-odds delta is exact too: both sides add the same float32 values per
cell in ray order. The JAX side runs under `jit`, as the engine runs it:
XLA then turns `world_to_grid`'s division by the resolution into a
multiplication by its float32 reciprocal, which the port follows (a point
on a cell boundary otherwise lands in the neighbouring cell). The endpoint scatter is compared with the reference's
`clip(logodds + logodds_delta(endpoint_rays(...), k_max=1))`: exact, on a
grid pre-filled near +-clamp and with many endpoints in one cell. The
endpoint rays themselves go through cos/sin, which XLA and torch may round
differently in the last bit, so their coordinates agree at atol 1e-5 and
the maps are compared on rays both sides build the same.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import GridConfig
from swarm_tpu.ops import beam_raster as jb
from swarm_tpu.ops import bresenham as jbr
from swarm_tpu.ops import raster as jr
from swarm_tpu_torch import convert
from swarm_tpu_torch.config import GridConfig as PGrid
from swarm_tpu_torch.ops import beam_raster as pb
from swarm_tpu_torch.ops import bresenham as pbr
from swarm_tpu_torch.ops import raster as pr
from tests.torch_parity import assert_close, assert_exact, t
from tests.torch_parity import torch_one_thread  # noqa: F401

GJ = GridConfig(size=128, origin_x=-1.0, origin_y=-2.0)
GP = convert.config_from(GJ, PGrid)


def test_bresenham_exact(rng):
    x0, y0 = rng.integers(-5, 60, (2, 4096)).astype(np.int32)
    x1 = (x0 + rng.integers(-40, 41, 4096)).astype(np.int32)
    y1 = (y0 + rng.integers(-40, 41, 4096)).astype(np.int32)
    x1[:64], y1[:64] = x0[:64], y0[:64]                # zero-length rays
    for k_max in (1, 32):
        ref = jbr.bresenham_cells(*(jnp.asarray(a) for a in (x0, y0, x1,
                                                              y1)), k_max)
        got = pbr.bresenham_cells(t(x0), t(y0), t(x1), t(y1), k_max)
        for a, b in zip(got, ref):
            assert_exact(a, b)
    assert_exact(pbr.chebyshev_cells(t(x0), t(y0), t(x1), t(y1)),
                 jbr.chebyshev_cells(x0, y0, x1, y1))


def _rays(rng, r, zero_frac=0.2):
    """Rays around the grid origin: starts and ends on both sides of it
    (negative world-cell coordinates: int() truncation, not floor), some
    zero-length, some outside the grid, some inactive."""
    ox = rng.uniform(-1.3, 5.0, r).astype(np.float32)
    oy = rng.uniform(-2.3, 4.0, r).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, r)
    d = rng.uniform(0.0, 1.5, r)
    d[rng.random(r) < zero_frac] = 0.0
    hx = (ox + d * np.cos(ang)).astype(np.float32)
    hy = (oy + d * np.sin(ang)).astype(np.float32)
    hv = rng.random(r) < 0.7
    act = rng.random(r) < 0.9
    return ox, oy, hx, hy, hv, act


def test_world_to_grid_truncates(rng):
    wx = np.array([-1.04, -0.96, -1.0, -1.06, 0.0, 5.3], np.float32)
    wy = np.array([-2.01, -1.99, -2.0, -2.07, 0.0, -0.3], np.float32)
    w2g = jax.jit(functools.partial(jr.world_to_grid, cfg=GJ))
    ref = w2g(jnp.asarray(wx), jnp.asarray(wy))
    got = pr.world_to_grid(t(wx), t(wy), GP)
    assert_exact(got[0], ref[0])
    assert_exact(got[1], ref[1])
    # within one cell left of / below the origin: cell 0, not -1
    assert got[0][0] == 0 and got[1][0] == 0
    ox, oy, *_ = _rays(rng, 4096)
    # every multiple of the resolution and its float32 neighbours
    edge = np.arange(-20, 120, dtype=np.float32) * np.float32(0.05)
    edge = np.concatenate([edge, np.nextafter(edge, np.float32(-9)),
                           np.nextafter(edge, np.float32(9))])
    for x in (ox, edge):
        for a, b in zip(pr.world_to_grid(t(x), t(x), GP),
                        w2g(jnp.asarray(x), jnp.asarray(x))):
            assert_exact(a, b)
    assert_exact(pr.grid_to_world(t(ox), t(oy), GP)[0],
                 jr.grid_to_world(jnp.asarray(ox), jnp.asarray(oy), GJ)[0])


@pytest.mark.parametrize("k_max", [1, 32])
def test_logodds_delta_exact(rng, k_max):
    ox, oy, hx, hy, hv, act = _rays(rng, 3000)
    ref, wr = jax.jit(functools.partial(jr.logodds_delta, cfg=GJ,
                                        k_max=k_max))(
        jr.RayBatch(*(jnp.asarray(a) for a in (ox, oy, hx, hy, hv, act))))
    got, wg = pr.logodds_delta(pr.RayBatch(*(t(a) for a in (
        ox, oy, hx, hy, hv, act))), GP, k_max=k_max)
    assert_exact(got, ref)
    assert int(wg) == int(wr) > 0


def test_endpoint_scatter_exact(rng):
    """The sparse in-place scatter against the reference's dense delta +
    clip, for the endpoint rays of a 4-way and a 181-beam fan and for a
    batch with 40 endpoints in one cell (beyond the clamp)."""
    n = 48
    xy = np.stack([rng.uniform(-0.5, 5.0, n),
                   rng.uniform(-1.5, 4.0, n)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    alive = rng.random(n) < 0.9
    grid0 = rng.choice([-9.9, 9.7, 0.0, -3.2, 9.95],
                       (128, 128)).astype(np.float32)
    for spec_j, spec_p in ((jb.BeamSpec.four_way(), pb.BeamSpec.four_way()),
                           (jb.BeamSpec.scan(181), pb.BeamSpec.scan(181))):
        b = spec_j.n_beams
        dist = rng.uniform(0.02, 1.6, (n, b)).astype(np.float32)
        beams = jb.beams_from_4way if spec_j.wrap else jb.beams_from_scan
        db, tb = beams(jnp.asarray(dist), 1.2, 0.05)
        rays_j = jb.endpoint_rays(jnp.asarray(xy), jnp.asarray(yaw), db, tb,
                                  jnp.asarray(alive), spec_j)
        rays_p = pb.endpoint_rays(t(xy), t(yaw), t(db), t(tb), t(alive),
                                  spec_p)
        for a, c in zip(rays_p, rays_j):
            assert_close(a, c, atol=1e-5, rtol=0) if a.is_floating_point() \
                else assert_exact(a, c)
        # both sides on the same (JAX-made) rays
        rays_p = pr.RayBatch(*(t(a) for a in rays_j))
        cases = [(rays_j, rays_p)]
        # 40 trusted endpoints in one cell, plus the fan's
        same = [np.concatenate([np.asarray(a), np.full(40, v, a.dtype)])
                for a, v in zip(rays_j, (0.52, 0.53, 0.52, 0.53, True,
                                         True))]
        cases.append((jr.RayBatch(*(jnp.asarray(a) for a in same)),
                      pr.RayBatch(*(t(a) for a in same))))
        for rj, rp in cases:
            delta, w_ref = jax.jit(functools.partial(
                jr.logodds_delta, cfg=GJ, k_max=1))(rj)
            ref = jnp.clip(jnp.asarray(grid0) + delta, -GJ.logodds_clamp,
                           GJ.logodds_clamp)
            got, w_got = pr.endpoint_scatter(torch.from_numpy(grid0.copy()),
                                             rp, GP)
            assert_exact(got, ref)
            assert int(w_got) == int(w_ref) > 0
