"""The hand-written CUDA raster kernels (the per-agent window raster in
each of its 16 per-beam instances: table x ring x fan x float32/bfloat16
grid, and the room-tile raster in its four per-beam forms) against their
plain torch versions, on the card, at small sizes; and the endpoint scatter
on the card against the CPU, on float32 and bfloat16 grids.

Needs an NVIDIA GPU with the CUDA toolkit; every test skips without one.
This file imports no jax, so on a card (whose machine need not have jax,
which tests/conftest.py imports) it runs on its own with
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernel_cuda.py

Kernel and plain version issue the same float32 operation sequence (the
kernel is built with --fmad=false, IEEE division and 1/sqrtf), and on a
bf16 grid both round each agent's window to bf16 after that agent, so the
map is held BIT-EQUAL and the counts (integer-valued sums) to rtol 1e-6.
"""

import itertools

import numpy as np
import pytest
import torch

from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.geom.world import make_tiled_rooms
from swarm_tpu_torch.ops.beam_raster import BeamSpec
from swarm_tpu_torch.ops.beam_raster_cuda import (free_raster,
                                                  free_raster_plain)
from swarm_tpu_torch.ops.raster import RayBatch, endpoint_scatter
from swarm_tpu_torch.ops.room_raster_cuda import (room_raster,
                                                  room_raster_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _case(seed, n, n_beams, size, overlap, prefill):
    rng = np.random.default_rng(seed)
    res = 0.05
    if overlap:
        # all agents within a few cells of one point: every window overlaps
        c = rng.uniform(60, size - 60, size=2)
        cells = c + rng.uniform(-3, 3, size=(n, 2))
    else:
        cells = rng.uniform(30, size - 30, size=(n, 2))
    xy = (cells * res).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, size=n).astype(np.float32)
    dist = rng.uniform(0.02, 1.6, size=(n, n_beams)).astype(np.float32)
    trusted = rng.random((n, n_beams)) < 0.7
    active = rng.random(n) < 0.9
    if prefill:
        # near +-clamp: the per-agent clip order decides the result
        grid = rng.choice([-9.9, 9.7, 0.0, -3.2], size=(size, size))
    else:
        grid = np.zeros((size, size))
    return (grid.astype(np.float32), xy, yaw, dist, trusted, active)


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams,overlap,prefill", [
    (181, False, False),
    (181, True, True),
    (61, False, True),
    (61, True, False),
])
def test_kernel_bit_equal_plain(cuda, n_beams, overlap, prefill):
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.scan(n_beams)
    grid, xy, yaw, dist, trusted, active = _case(
        n_beams, 48, n_beams, size, overlap, prefill)
    args = [torch.from_numpy(a).to(cuda) for a in (xy, yaw, dist)]
    act = torch.from_numpy(active).to(cuda)
    tr = torch.from_numpy(trusted).to(cuda)
    g_k = torch.from_numpy(grid).to(cuda)
    g_p = g_k.clone()

    before = free_raster.launches
    out_k, cnt_k = free_raster(g_k, *args, act, tr, spec, cfg, reach=26)
    torch.cuda.synchronize()
    assert free_raster.launches == before + 1
    out_p, cnt_p = free_raster_plain(g_p, *args, act, tr, spec, cfg,
                                     reach=26)
    assert free_raster.launches == before + 1
    diff = int((out_k != out_p).sum())
    assert diff == 0, f"{diff} cells differ"
    np.testing.assert_allclose(cnt_k.cpu().numpy(), cnt_p.cpu().numpy(),
                               rtol=1e-6)
    assert float(cnt_k.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams,pack8,overlap,prefill", [
    (181, False, False, False),
    (181, False, True, True),
    (4, False, False, True),
    (4, False, True, False),
    (4, True, False, False),
    (4, True, True, True),
])
def test_kernel_forms_bit_equal_plain(cuda, n_beams, pack8, overlap,
                                      prefill):
    """The exploration path's forms: the pack16 table without the ring on
    the scan and on the wrapped 4-way fan, the pack8 table with the ring on
    the wrapped fan."""
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    grid, xy, yaw, dist, trusted, active = _case(
        n_beams + 7, 48, n_beams, size, overlap, prefill)
    args = [torch.from_numpy(a).to(cuda) for a in (xy, yaw, dist)]
    act = torch.from_numpy(active).to(cuda)
    tr = torch.from_numpy(trusted).to(cuda) if pack8 else None
    g_k = torch.from_numpy(grid).to(cuda)
    g_p = g_k.clone()

    before = free_raster.launches
    _, cnt_k = free_raster(g_k, *args, act, tr, spec, cfg, reach=26,
                           pack8=pack8)
    torch.cuda.synchronize()
    assert free_raster.launches == before + 1
    _, cnt_p = free_raster_plain(g_p, *args, act, tr, spec, cfg, reach=26,
                                 pack8=pack8)
    assert free_raster.launches == before + 1
    diff = int((g_k != g_p).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


@pytest.mark.cuda
def test_endpoint_scatter_card_equals_cpu(cuda):
    """The endpoint scatter (torch ops: a sort, searches, one indexed
    write) gives the same map on the card as on the CPU, with many
    endpoints in some cells and some outside the grid."""
    rng = np.random.default_rng(5)
    cfg = GridConfig(size=256, origin_x=-1.0, origin_y=-1.0)
    r = 20000
    hx = rng.uniform(-1.5, 12.0, r).astype(np.float32)
    hy = rng.uniform(-1.5, 12.0, r).astype(np.float32)
    hx[:5000] = hx[:50].repeat(100)
    hy[:5000] = hy[:50].repeat(100)
    ok = rng.random(r) < 0.8
    grid = rng.choice([-9.9, 9.7, 0.0, -3.2], (256, 256)).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        rays = RayBatch(*(torch.from_numpy(a).to(dev)
                          for a in (hx, hy, hx, hy, ok, ok)))
        # a copy: the scatter updates the grid in place
        g, w = endpoint_scatter(torch.tensor(grid, device=dev), rays, cfg)
        outs.append((g.cpu(), int(w)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_rooms,overlap", [(3, False), (4, True),
                                             (7, False)])
def test_room_kernel_bit_equal_plain(cuda, n_rooms, overlap):
    """Rooms on a 512^2 grid, 2 per tile row (tiles past the last room
    empty, the last agent inactive); overlap: both agents of a room within
    +-3 cells of one point on a grid pre-filled near +-clamp."""
    size, per_row = 512, 2
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    rng = np.random.default_rng(n_rooms)
    _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    n = 2 * n_rooms
    room = np.arange(n) // 2
    if overlap:
        c = origins[room] + rng.uniform([1.0, 1.0], [5.0, 3.0],
                                        (n_rooms, 2))[room]
        xy = c + rng.uniform(-0.15, 0.15, (n, 2))
        grid = rng.choice([-9.9, 9.7, -9.6, 9.95], (size, size))
    else:
        xy = origins[room] + rng.uniform([0.3, 0.3], [5.7, 3.7], (n, 2))
        grid = np.zeros((size, size))
    dist = rng.uniform(0.02, 1.6, (n, 181))
    trusted = (dist > 0.05) & (dist <= 1.2)
    act = np.ones(n, bool)
    act[-1] = False

    def dev(a, dtype=None):
        x = torch.from_numpy(np.asarray(a)).to(cuda)
        return x if dtype is None else x.to(dtype)

    f32 = torch.float32
    args = (dev(xy, f32), dev(rng.uniform(-np.pi, np.pi, n), f32),
            dev(np.minimum(dist, 1.2), f32), dev(act))
    g_k = dev(grid, f32)
    g_p = g_k.clone()
    before = room_raster.launches
    _, cnt_k = room_raster(g_k, *args, BeamSpec.scan(181), cfg, n_groups=181,
                           per_row=per_row, trusted=dev(trusted), reach=26)
    torch.cuda.synchronize()
    assert room_raster.launches == before + 1
    _, cnt_p = room_raster_plain(g_p, *args, BeamSpec.scan(181), cfg,
                                 n_groups=181, per_row=per_row,
                                 trusted=dev(trusted), reach=26)
    assert room_raster.launches == before + 1
    diff = int((g_k != g_p).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


# every window instance: (beams, pack8, ring, dtype)
WINDOW_INSTANCES = list(itertools.product(
    (181, 4), (True, False), (True, False), (torch.float32, torch.bfloat16)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams,pack8,ring,dtype", WINDOW_INSTANCES)
@pytest.mark.parametrize("overlap", [False, True])
def test_window_instances_bit_equal_plain(cuda, n_beams, pack8, ring, dtype,
                                          overlap):
    """All 16 instances of the window kernel, agents spread out on a zero
    grid or overlapping on a grid pre-filled near +-clamp (where the
    per-agent clip, and on bf16 the per-agent rounding, decides cells)."""
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0,
                     logodds_dtype="bfloat16" if dtype == torch.bfloat16
                     else "float32")
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    grid, xy, yaw, dist, trusted, active = _case(
        n_beams + 2 * pack8 + ring, 48, n_beams, size, overlap, overlap)
    args = [torch.from_numpy(a).to(cuda) for a in (xy, yaw, dist)]
    act = torch.from_numpy(active).to(cuda)
    tr = torch.from_numpy(trusted).to(cuda) if ring else None
    g_k = torch.from_numpy(grid).to(cuda).to(dtype)
    g_p = g_k.clone()

    before = free_raster.launches
    _, cnt_k = free_raster(g_k, *args, act, tr, spec, cfg, reach=26,
                           pack8=pack8)
    torch.cuda.synchronize()
    assert free_raster.launches == before + 1
    _, cnt_p = free_raster_plain(g_p, *args, act, tr, spec, cfg, reach=26,
                                 pack8=pack8)
    assert free_raster.launches == before + 1
    assert g_k.dtype == dtype
    diff = int((g_k != g_p).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("four_way,ring", [(False, False), (True, True),
                                           (True, False)])
@pytest.mark.parametrize("overlap", [False, True])
def test_room_forms_bit_equal_plain(cuda, four_way, ring, overlap):
    """The room kernel without its ring, and on the wrapped 4-way fan with
    and without it."""
    size, per_row, n_rooms = 512, 2, 4
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    rng = np.random.default_rng(11 + 2 * four_way + ring)
    _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    n = 2 * n_rooms
    n_beams = 4 if four_way else 181
    room = np.arange(n) // 2
    if overlap:
        c = origins[room] + rng.uniform([1.0, 1.0], [5.0, 3.0],
                                        (n_rooms, 2))[room]
        xy = c + rng.uniform(-0.15, 0.15, (n, 2))
        grid = rng.choice([-9.9, 9.7, -9.6, 9.95], (size, size))
    else:
        xy = origins[room] + rng.uniform([0.3, 0.3], [5.7, 3.7], (n, 2))
        grid = np.zeros((size, size))
    dist = rng.uniform(0.02, 1.6, (n, n_beams))
    trusted = (dist > 0.05) & (dist <= 1.2)

    def dev(a, dtype=None):
        x = torch.from_numpy(np.asarray(a)).to(cuda)
        return x if dtype is None else x.to(dtype)

    f32 = torch.float32
    spec = BeamSpec.four_way() if four_way else BeamSpec.scan(181)
    args = (dev(xy, f32), dev(rng.uniform(-np.pi, np.pi, n), f32),
            dev(np.minimum(dist, 1.2), f32), dev(np.ones(n, bool)))
    kw = dict(n_groups=n_beams, per_row=per_row,
              trusted=dev(trusted) if ring else None, reach=26)
    g_k = dev(grid, f32)
    g_p = g_k.clone()
    before = room_raster.launches
    _, cnt_k = room_raster(g_k, *args, spec, cfg, **kw)
    torch.cuda.synchronize()
    assert room_raster.launches == before + 1
    _, cnt_p = room_raster_plain(g_p, *args, spec, cfg, **kw)
    diff = int((g_k != g_p).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


@pytest.mark.cuda
def test_endpoint_scatter_bf16_card_equals_cpu(cuda):
    """The endpoint scatter on a bf16 grid: the same map on the card as on
    the CPU, with many endpoints in some cells."""
    rng = np.random.default_rng(6)
    cfg = GridConfig(size=256, origin_x=-1.0, origin_y=-1.0,
                     logodds_dtype="bfloat16")
    r = 20000
    hx = rng.uniform(-1.5, 12.0, r).astype(np.float32)
    hy = rng.uniform(-1.5, 12.0, r).astype(np.float32)
    hx[:5000] = hx[:50].repeat(100)
    hy[:5000] = hy[:50].repeat(100)
    ok = rng.random(r) < 0.8
    grid = rng.choice([-9.9, 9.7, 0.0, -3.2], (256, 256)).astype(np.float32)
    outs = []
    for d in ("cpu", cuda):
        rays = RayBatch(*(torch.from_numpy(a).to(d)
                          for a in (hx, hy, hx, hy, ok, ok)))
        g, w = endpoint_scatter(torch.tensor(grid, device=d).to(
            torch.bfloat16), rays, cfg)
        outs.append((g.cpu(), int(w)))
    assert outs[0][0].dtype == torch.bfloat16
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] > 0
