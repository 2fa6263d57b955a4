"""The untiled world's rasters and the parity raster on the card against the
same calls on the CPU: `ops/raster.parity_raster` (integer traces and an
int32 scatter-max), `ops/raster.logodds_raster` (the line raster, its
evidence summed in ray order by `ordered_add`) and `ordered_add` itself on
given deltas are held BIT-EQUAL to their CPU results (a NaN equal to a
NaN, whatever its payload); the XLA beam tier
(`ops/beam_raster.beam_raster_reference`: the card's atan2 and sine are not
the CPU's) decision-equal; and the line raster and the XLA tier, run twice
on the card from the same grid, bit-identical (no float atomics decide a
sum).

Needs an NVIDIA GPU; every test skips without one. This file imports no
jax, so on a card it runs on its own with
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_untiled_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.ops.beam_raster import BeamSpec, beam_raster_reference
from swarm_tpu_torch.ops.raster import (RayBatch, logodds_raster,
                                        ordered_add, parity_raster)

GRID = GridConfig(size=512, origin_x=-3.0, origin_y=-4.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _bits(x):
    """The bits of a float map, every NaN as one pattern: the card's
    arithmetic returns its canonical NaN, the CPU keeps the payload."""
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return x.view(torch.int16 if x.element_size() == 2 else
                  torch.int32 if x.element_size() == 4 else torch.int8)


def _rays(seed, n=4000):
    """Rays over the grid: a third from one point (hundreds through its
    cells), some leaving the grid, some starting outside it, untrusted
    ends, inactive rays."""
    rng = np.random.default_rng(seed)
    ox = rng.uniform(0.0, 20.0, n).astype(np.float32)
    oy = rng.uniform(-1.0, 20.0, n).astype(np.float32)
    ox[: n // 3], oy[: n // 3] = 5.0, 3.0
    ang = rng.uniform(-math.pi, math.pi, n)
    rr = rng.uniform(0.0, 1.5, n)
    hx = (ox + rr * np.cos(ang)).astype(np.float32)
    hy = (oy + rr * np.sin(ang)).astype(np.float32)
    hx[-100:] = rng.uniform(-4.5, -2.0, 100)
    ox[-150:-100] = -3.6
    hv = rng.uniform(size=n) > 0.3
    act = rng.uniform(size=n) > 0.05
    return RayBatch(*(torch.from_numpy(x) for x in (ox, oy, hx, hy, hv,
                                                     act)))


def _to(rays, dev):
    return RayBatch(*(x.to(dev) for x in rays))


@pytest.mark.cuda
def test_parity_raster_card_equals_cpu(cuda):
    rays = _rays(1)
    g = torch.from_numpy(np.random.default_rng(2).choice(
        np.array([-1, 0, 100], np.int8), (GRID.size, GRID.size)))
    want, w_c = parity_raster(g.clone(), rays, GRID)
    got, w_d = parity_raster(g.clone().to(cuda), _to(rays, cuda), GRID)
    assert torch.equal(got.cpu(), want) and int(w_d) == int(w_c) > 0


@pytest.mark.cuda
def test_line_raster_card_equals_cpu_and_repeats(cuda):
    rays = _rays(3)
    g = torch.from_numpy(np.random.default_rng(4).uniform(
        -9.9, 9.9, (GRID.size, GRID.size)).astype(np.float32))
    want, w_c = logodds_raster(g.clone(), rays, GRID)
    outs = [logodds_raster(g.clone().to(cuda), _to(rays, cuda), GRID)
            for _ in range(2)]
    for got, w_d in outs:
        assert torch.equal(_bits(got.cpu()), _bits(want))
        assert int(w_d) == int(w_c) > 0
    assert ordered_add.deepest >= 1000 // 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ordered_add_card_equals_cpu(cuda, dtype):
    rng = np.random.default_rng(5)
    size, pr, pc, n = 256, 64, 128, 64
    g = torch.from_numpy(rng.uniform(-9.9, 9.9, (size, size)).astype(
        np.float32)).to(dtype)
    g.view(-1)[torch.from_numpy(rng.choice(size * size, 500))] = -0.0
    g.view(-1)[torch.from_numpy(rng.choice(size * size, 200))] = float("nan")
    r0 = torch.from_numpy(rng.integers(0, size - pr, n))
    c0 = torch.from_numpy(rng.integers(0, size - pc, n))
    r0[: n // 2], c0[: n // 2] = 90, 60      # half the patches on one spot
    d = torch.from_numpy(rng.choice([0.0, 0.85, -0.4, 1e-3], (n, pr, pc),
                                    p=[0.6, 0.15, 0.2, 0.05]).astype(
        np.float32))
    cells = ((r0[:, None, None] + torch.arange(pr)[:, None]) * size
             + c0[:, None, None] + torch.arange(pc))
    want = g.clone()
    ordered_add(want.view(-1), cells, d)
    got = g.clone().to(cuda)
    ordered_add(got.view(-1), cells.to(cuda), d.to(cuda))
    assert torch.equal(_bits(got.cpu()), _bits(want))


def _tier_inputs(seed, n, n_beams):
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0.0, -1.0], [19.0, 19.0], (n, 2))
    xy[: n // 2] = [6.3, 5.2]
    yaw = rng.uniform(-math.pi, math.pi, n)
    dist = rng.uniform(0.1, 1.4, (n, n_beams))
    trusted = (dist <= 1.2) & (rng.uniform(size=(n, n_beams)) > 0.2)
    dist = np.where(trusted, dist, 1.2)
    return [torch.from_numpy(a) for a in (
        xy.astype(np.float32), yaw.astype(np.float32),
        dist.astype(np.float32), trusted)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_beams", [4, 181])
def test_xla_tier_card_vs_cpu_and_repeats(cuda, n_beams, dtype):
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    cfg = dataclasses.replace(GRID, logodds_dtype=str(dtype)[6:])
    args = _tier_inputs(6, 32, n_beams)
    g = torch.zeros((GRID.size, GRID.size), dtype=dtype)
    want, w_c = beam_raster_reference(g.clone(), *args, spec, cfg, reach=26)
    outs = [beam_raster_reference(g.clone().to(cuda),
                                  *(a.to(cuda) for a in args), spec, cfg,
                                  reach=26) for _ in range(2)]
    assert torch.equal(_bits(outs[0][0]), _bits(outs[1][0]))
    assert int(outs[0][1]) == int(outs[1][1])
    got = outs[0][0].cpu().to(torch.float32)
    diff = int(((got - want.to(torch.float32)).abs() > 1e-6).sum())
    painted = int((want != 0).sum())
    assert diff <= 1e-4 * painted and painted > 0
    assert abs(int(outs[0][1]) - int(w_c)) <= 1e-4 * int(w_c)
