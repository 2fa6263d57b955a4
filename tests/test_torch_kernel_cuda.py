"""The hand-written CUDA raster kernels (the per-agent window raster in
each of its 16 per-beam instances: table x ring x fan x float32/bfloat16
grid, and its 8 grouped ones: ring x fan x storage, and the sharded
engine's band and tile windows of its float32 forms; the room-tile raster in
its four per-beam and four grouped forms; the r1 exact raster on the scan
and the wrapped 4-way fan, with its evaluation box and clean-tile rule)
against their plain torch versions, on the card, at small sizes; NaN grid
cells, which every kernel's clip keeps as NaN, as the plain versions'
torch.clamp and the reference's jnp.clip do; and the endpoint scatter on
the card against the CPU, on float32 and bfloat16 grids.

Needs an NVIDIA GPU with the CUDA toolkit; every test skips without one.
This file imports no jax, so on a card (whose machine need not have jax,
which tests/conftest.py imports) it runs on its own with
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernel_cuda.py

Kernel and plain version issue the same float32 operation sequence (the
kernel is built with --fmad=false, IEEE division and 1/sqrtf), and on a
bf16 grid both round each agent's window to bf16 after that agent, so the
map is held BIT-EQUAL and the counts to rtol 1e-6 or equal. The grouped
counts are sums of fractions (the trusted fraction, the tail weight), and
often half-integers that the engine rounds: kernel and plain version both
sum them exactly, in double, so they are held EQUAL.
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
from swarm_tpu_torch.ops.exact_raster_cuda import (beam_raster,
                                                   beam_raster_plain)
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


@pytest.mark.cuda
@pytest.mark.parametrize("fan", [(181, 8), (181, 16), (4, 2)],
                         ids=["181/8", "181/16", "4/2"])
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("overlap", [False, True])
def test_grouped_window_instances_bit_equal_plain(cuda, fan, ring, dtype,
                                                  overlap):
    """The 8 grouped instances of the window kernel (ring x fan x storage,
    the tail at 0.25), and 16 groups on the scan (the last group padded)."""
    n_beams, n_groups = fan
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0,
                     logodds_dtype="bfloat16" if dtype == torch.bfloat16
                     else "float32")
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    grid, xy, yaw, dist, trusted, active = _case(
        n_beams + n_groups + ring, 48, n_beams, size, overlap, overlap)
    args = [torch.from_numpy(a).to(cuda) for a in (xy, yaw, dist)]
    act = torch.from_numpy(active).to(cuda)
    tr = torch.from_numpy(trusted).to(cuda) if ring else None
    kw = dict(reach=26, n_groups=n_groups, tail_weight=0.25)
    g_k = torch.from_numpy(grid).to(cuda).to(dtype)
    g_p = g_k.clone()

    before = dict(free_raster.launches_by_form)
    _, cnt_k = free_raster(g_k, *args, act, tr, spec, cfg, **kw)
    torch.cuda.synchronize()
    name = "grouped" + ("-ring" if ring else "") + \
        ("-wrapped" if n_beams == 4 else "") + \
        ("-bf16" if dtype == torch.bfloat16 else "")
    assert free_raster.launches_by_form[name] == before.get(name, 0) + 1
    _, cnt_p = free_raster_plain(g_p, *args, act, tr, spec, cfg, **kw)
    assert g_k.dtype == dtype
    diff = int((g_k != g_p).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("four_way", [False, True])
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("overlap", [False, True])
def test_room_grouped_forms_bit_equal_plain(cuda, four_way, ring, overlap):
    """The room kernel's 4 grouped forms (ring x fan; 181 beams in 8
    groups, the 4-way fan in 2), the tail at 0.25."""
    size, per_row, n_rooms = 512, 2, 4
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    rng = np.random.default_rng(31 + 2 * four_way + ring)
    _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    n = 2 * n_rooms
    n_beams, n_groups = (4, 2) if four_way else (181, 8)
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
    act = np.ones(n, bool)
    act[-1] = False

    def dev(a, dtype=None):
        x = torch.from_numpy(np.asarray(a)).to(cuda)
        return x if dtype is None else x.to(dtype)

    f32 = torch.float32
    spec = BeamSpec.four_way() if four_way else BeamSpec.scan(181)
    args = (dev(xy, f32), dev(rng.uniform(-np.pi, np.pi, n), f32),
            dev(np.minimum(dist, 1.2), f32), dev(act))
    kw = dict(n_groups=n_groups, per_row=per_row, tail_weight=0.25,
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
@pytest.mark.parametrize("n_beams", [181, 37, 4])
@pytest.mark.parametrize("overlap", [False, True])
def test_exact_raster_bit_equal_plain(cuda, n_beams, overlap):
    """The r1 exact raster on the scan (181 and 37 beams) and the wrapped
    4-way fan, agents spread out on a zero grid or overlapping on a grid
    pre-filled near +-clamp. The plain version's torch.sin and the
    kernel's sinf are both libdevice's."""
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    grid, xy, yaw, dist, trusted, active = _case(
        n_beams + 50, 48, n_beams, size, overlap, overlap)
    args = [torch.from_numpy(a).to(cuda)
            for a in (xy, yaw, np.minimum(dist, 1.2), trusted, active)]
    g_k = torch.from_numpy(grid).to(cuda)
    g_p = g_k.clone()
    before = beam_raster.launches
    beam_raster(g_k, *args, spec, cfg)
    torch.cuda.synchronize()
    assert beam_raster.launches == before + 1
    beam_raster_plain(g_p, *args, spec, cfg)
    assert beam_raster.launches == before + 1
    diff = int((g_k != g_p).sum())
    assert diff == 0, f"{diff} cells differ"
    assert int((g_k != torch.from_numpy(grid).to(cuda)).sum()) > 0


# the sharded engine's grid windows on a 512^2 grid: (band, band_cols) of
# rank 1 of a 4-rank rows layout, rank 0 and rank 3 of a 2x2 tiles layout
# (the halo 32 rows x 128 columns at the 26-cell reach), and a tile window
# with a 40-row halo, whose last 64-row CUDA tile row is ragged
BAND_WINDOWS = {"band": ((128, 128), None),
                "tile-corner": ((-32, 320), (-128, 512)),
                "tile-far": ((224, 320), (128, 512)),
                "tile-ragged": ((-40, 336), (-128, 512))}


@pytest.mark.cuda
@pytest.mark.parametrize("window", list(BAND_WINDOWS))
@pytest.mark.parametrize("n_beams,n_groups", [(181, 181), (4, 4), (181, 8),
                                              (4, 2), (61, 61)])
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("prefill", [False, True])
def test_band_tile_forms_bit_equal_plain(cuda, window, n_beams, n_groups,
                                         ring, prefill):
    """The band and tile forms (the sharded body's pack16 and grouped
    tables, ring on and off, scan and wrapped fans; a 61-beam fan for the
    on-beam test of a sparse fan) on windows with negative offsets, the
    grid-edge guard and a ragged last tile row; a window pre-filled near
    +-clamp and overlapping agents, where the per-agent clip decides."""
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    band, band_cols = BAND_WINDOWS[window]
    shape = (band[1], size if band_cols is None else band_cols[1])
    rng = np.random.default_rng(n_beams * 7 + n_groups)
    n = 40
    lo_r, lo_c = max(band[0], 0), 0 if band_cols is None else max(
        band_cols[0], 0)
    hi_r = min(band[0] + band[1], size)
    hi_c = size if band_cols is None else min(band_cols[0] + band_cols[1],
                                              size)
    cells = np.stack([rng.uniform(lo_r, hi_r, n), rng.uniform(lo_c, hi_c, n)],
                     -1)
    cells[:10] = cells[0] + rng.uniform(-3, 3, (10, 2))    # overlapping
    cells[10:14] = [[lo_r + 0.7, lo_c + 0.4], [hi_r - 1.2, hi_c - 0.6],
                    [lo_r + 2.0, hi_c - 3.0], [hi_r - 5.0, lo_c + 1.0]]
    xy = torch.tensor(cells[:, ::-1] * cfg.resolution, dtype=torch.float32,
                      device=cuda)
    yaw = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32,
                       device=cuda)
    dist = torch.tensor(rng.uniform(0.02, 1.6, (n, n_beams)),
                        dtype=torch.float32, device=cuda)
    trusted = torch.tensor(rng.random((n, n_beams)) < 0.7, device=cuda)
    act = torch.tensor(rng.random(n) < 0.9, device=cuda)
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    grid = (rng.choice([-9.9, 9.7, 0.0, -3.2], shape) if prefill
            else np.zeros(shape))
    g_k = torch.tensor(grid, dtype=torch.float32, device=cuda)
    g_p = g_k.clone()
    kw = dict(reach=26, pack8=False, n_groups=n_groups, tail_weight=0.25,
              band=band, band_cols=band_cols)
    tr = trusted if ring else None
    before = dict(free_raster.launches_by_form)
    _, cnt_k = free_raster(g_k, xy, yaw, dist, act, tr, spec, cfg, **kw)
    torch.cuda.synchronize()
    _, cnt_p = free_raster_plain(g_p, xy, yaw, dist, act, tr, spec, cfg,
                                 **kw)
    new = {k: v - before.get(k, 0)
           for k, v in free_raster.launches_by_form.items()
           if v != before.get(k, 0)}
    suffix = "-tile" if band_cols is not None else "-band"
    assert list(new.values()) == [1] and next(iter(new)).endswith(suffix)
    diff = int((g_k != g_p).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


def _dirty_grid(rng, shape, prefill):
    """A grid for the evaluation box's clean-tile test: zeros, values
    beyond +-clamp and -0.0 everywhere ("beyond"), or such values in 1% of
    the cells of a zero grid ("sparse": clean and dirty tiles side by
    side, dirty cells outside the agents' boxes)."""
    dirty = rng.choice([-12.5, 11.0, -0.0, 9.7, -3.2, 0.0], shape)
    if prefill == "zero":
        return np.zeros(shape)
    if prefill == "beyond":
        return dirty
    return np.where(rng.random(shape) < 0.01, dirty, 0.0)


def _bits_differ(a, b) -> int:
    """Cells whose bits differ (a -0.0 against a +0.0 counts; a NaN against
    a NaN, whatever its payload, does not)."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return int(((a.view(bits) != b.view(bits)) &
                ~(torch.isnan(a) & torch.isnan(b))).sum())


def _edge_agents(rng, n, size, n_beams, res, cuda):
    """n agents on the 64 x 128 tile edges (the first 8 overlapping), their
    headings, readings of a few cells, about the reach or 7 m (past the
    exact raster's window), trusted flags and a fifth of them inactive."""
    edges = np.stack([rng.integers(1, size // 64, n) * 64.0,
                      rng.integers(1, size // 128, n) * 128.0], -1)
    cells = edges + rng.uniform(-4, 4, (n, 2))
    cells[:8] = cells[0] + rng.uniform(-3, 3, (8, 2))
    scale = rng.choice([0.3, 1.2, 7.0], (n, 1))
    return [torch.tensor(a, device=cuda) for a in (
        (cells[:, ::-1] * res).astype(np.float32),
        rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        (rng.uniform(0.02, 1.0, (n, n_beams)) * scale).astype(np.float32),
        rng.random((n, n_beams)) < 0.7, rng.random(n) < 0.8)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams", [181, 37, 4])
@pytest.mark.parametrize("prefill", ["zero", "beyond", "sparse", "nan"])
def test_exact_box_cases_bit_equal_plain(cuda, n_beams, prefill):
    """The exact raster's evaluation box and clean-tile rule: agents on the
    64 x 128 tile edges so that the boxes cross them, ranges from a few
    cells to past the window, inactive agents (skipped whole on a clean
    tile, evaluated on a dirty one), and grids holding values beyond
    +-clamp, -0.0 cells and NaN cells, which every window's clip must still
    change (a NaN stays NaN). Bit for bit; the NaN cells equal."""
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    rng = np.random.default_rng(n_beams + 11)
    args = _edge_agents(rng, 40, size, n_beams, cfg.resolution, cuda)
    grid = _dirty_grid(rng, (size, size),
                       "sparse" if prefill == "nan" else prefill)
    if prefill == "nan":
        grid[rng.random((size, size)) < 0.01] = np.nan
    g0 = torch.tensor(grid, dtype=torch.float32, device=cuda)
    g_k, g_p = g0.clone(), g0.clone()
    before = beam_raster.launches
    beam_raster(g_k, *args, spec, cfg)
    torch.cuda.synchronize()
    assert beam_raster.launches == before + 1
    beam_raster_plain(g_p, *args, spec, cfg)
    assert torch.equal(torch.isnan(g_k), torch.isnan(g0))
    diff = _bits_differ(g_k, g_p)
    assert diff == 0, f"{diff} cells differ"
    assert _bits_differ(g_k, g0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["window", "window-bf16", "room",
                                    "exact-scan", "exact-wrapped"])
def test_nan_cells_stay_nan(cuda, kernel):
    """Each kernel's clip keeps a NaN grid cell NaN, as its plain version's
    torch.clamp and the reference's jnp.clip do (CUDA's fmaxf(NaN, -c)
    alone would store -clamp): a grid pre-filled near +-clamp with -0.0
    cells and 2% NaN cells under overlapping agents; the NaN masks equal
    and every other cell bit-equal."""
    size, per_row, n_rooms = 512, 2, 7
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    rng = np.random.default_rng(len(kernel))
    grid = rng.choice([-9.9, 9.7, -0.0, -3.2, 0.0], (size, size))
    grid[rng.random((size, size)) < 0.02] = np.nan
    dtype = torch.bfloat16 if kernel.endswith("bf16") else torch.float32
    g0 = torch.tensor(grid, dtype=torch.float32, device=cuda).to(dtype)
    g_k, g_p = g0.clone(), g0.clone()
    kernels = (free_raster, room_raster, beam_raster)
    before = [f.launches for f in kernels]
    if kernel.startswith("room"):
        _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
        n = 2 * n_rooms
        xy = origins[np.arange(n) // 2] + rng.uniform([0.3, 0.3],
                                                      [5.7, 3.7], (n, 2))
        xy[1::2] = xy[0::2] + rng.uniform(-0.1, 0.1, (n_rooms, 2))
        args = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in
                (xy, rng.uniform(-np.pi, np.pi, n),
                 rng.uniform(0.02, 1.6, (n, 181)))]
        act = torch.ones(n, dtype=torch.bool, device=cuda)
        tr = torch.tensor(rng.random((n, 181)) < 0.7, device=cuda)
        kw = dict(per_row=per_row, reach=26, trusted=tr)
        room_raster(g_k, *args, act, BeamSpec.scan(181), cfg, **kw)
        torch.cuda.synchronize()
        room_raster_plain(g_p, *args, act, BeamSpec.scan(181), cfg, **kw)
    else:
        n_beams = 4 if kernel.endswith("wrapped") else 181
        spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(181)
        grid0, xy, yaw, dist, trusted, active = _case(
            n_beams + 5, 24, n_beams, size, True, False)
        args = [torch.from_numpy(a).to(cuda) for a in (xy, yaw, dist)]
        act = torch.from_numpy(active).to(cuda)
        tr = torch.from_numpy(trusted).to(cuda)
        if kernel.startswith("exact"):
            beam_raster(g_k, *args, tr, act, spec, cfg)
            torch.cuda.synchronize()
            beam_raster_plain(g_p, *args, tr, act, spec, cfg)
        else:
            kw = dict(reach=26, pack8=dtype == torch.float32)
            free_raster(g_k, *args, act, tr, spec, cfg, **kw)
            torch.cuda.synchronize()
            free_raster_plain(g_p, *args, act, tr, spec, cfg, **kw)
    assert sum(f.launches for f in kernels) == sum(before) + 1
    nan0 = torch.isnan(g0)
    assert torch.equal(torch.isnan(g_k), nan0)
    assert torch.equal(torch.isnan(g_p), nan0)
    diff = _bits_differ(g_k, g_p)
    assert diff == 0, f"{diff} cells differ"
    assert _bits_differ(g_k, g0) > 0


# window forms for the box cases: (beams, groups, pack8, ring, dtype)
BOX_WINDOW_FORMS = [(181, 181, True, True, torch.float32),
                    (181, 181, False, False, torch.bfloat16),
                    (181, 8, False, True, torch.float32),
                    (4, 2, False, False, torch.bfloat16),
                    (4, 4, True, True, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", BOX_WINDOW_FORMS,
                         ids=lambda f: "-".join(map(str, f[:4])))
@pytest.mark.parametrize("prefill", ["zero", "beyond", "sparse"])
def test_window_box_cases_bit_equal_plain(cuda, form, prefill):
    """The window kernel's evaluation box: ranges far beyond the reach (up
    to each field's clamp), agents on the 64 x 128 tile edges so that the
    boxes cross them, inactive agents, and grids holding values beyond
    +-clamp and -0.0 cells, which every window's clip must still change."""
    n_beams, n_groups, pack8, ring, dtype = form
    size = 512
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0,
                     logodds_dtype="bfloat16" if dtype == torch.bfloat16
                     else "float32")
    rng = np.random.default_rng(n_beams + 3 * n_groups + pack8)
    n = 40
    edges = np.stack([rng.integers(1, size // 64, n) * 64.0,
                      rng.integers(1, size // 128, n) * 128.0], -1)
    cells = edges + rng.uniform(-4, 4, (n, 2))
    cells[:8] = cells[0] + rng.uniform(-3, 3, (8, 2))     # overlapping
    xy = torch.tensor(cells[:, ::-1] * cfg.resolution, dtype=torch.float32,
                      device=cuda)
    yaw = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32,
                       device=cuda)
    scale = rng.choice([0.3, 1.2, 7.0], (n, 1))
    dist = torch.tensor(rng.uniform(0.02, 1.0, (n, n_beams)) * scale,
                        dtype=torch.float32, device=cuda)
    tr = torch.tensor(rng.random((n, n_beams)) < 0.7,
                      device=cuda) if ring else None
    act = torch.tensor(rng.random(n) < 0.8, device=cuda)
    spec = BeamSpec.four_way() if n_beams == 4 else BeamSpec.scan(n_beams)
    g_k = torch.tensor(_dirty_grid(rng, (size, size), prefill),
                       dtype=torch.float32, device=cuda).to(dtype)
    g_p = g_k.clone()
    kw = dict(reach=26, pack8=pack8, n_groups=n_groups, tail_weight=0.25)
    before = free_raster.launches
    _, cnt_k = free_raster(g_k, xy, yaw, dist, act, tr, spec, cfg, **kw)
    torch.cuda.synchronize()
    assert free_raster.launches == before + 1
    _, cnt_p = free_raster_plain(g_p, xy, yaw, dist, act, tr, spec, cfg,
                                 **kw)
    # bitwise: -0.0 == 0.0 would hide a skipped clip
    diff = int((g_k.view(torch.int16 if dtype == torch.bfloat16 else
                         torch.int32) !=
                g_p.view(torch.int16 if dtype == torch.bfloat16 else
                         torch.int32)).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups,ring", [(181, True), (181, False),
                                           (8, True)])
@pytest.mark.parametrize("prefill", ["zero", "beyond", "sparse"])
def test_room_box_cases_bit_equal_plain(cuda, n_groups, ring, prefill):
    """The room kernel's evaluation box: ranges far beyond the reach,
    agents at their tile's edges, inactive agents, empty tiles, and grids
    holding values beyond +-clamp and -0.0 cells."""
    size, per_row, n_rooms = 512, 2, 7
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    rng = np.random.default_rng(n_groups + 2 * ring)
    _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    n = 2 * n_rooms
    room = np.arange(n) // 2
    xy = origins[room] + rng.uniform([0.3, 0.3], [5.7, 3.7], (n, 2))
    xy[:4] = origins[[0, 0, 1, 1]] + [[0.05, 0.05], [6.35, 6.35],
                                      [6.3, 0.1], [0.1, 6.3]]
    dist = rng.uniform(0.02, 1.0, (n, 181)) * rng.choice([0.3, 1.2, 7.0],
                                                         (n, 1))
    act = rng.random(n) < 0.8

    def dev(a, dtype=None):
        x = torch.from_numpy(np.asarray(a)).to(cuda)
        return x if dtype is None else x.to(dtype)

    f32 = torch.float32
    args = (dev(xy, f32), dev(rng.uniform(-np.pi, np.pi, n), f32),
            dev(dist, f32), dev(act))
    kw = dict(n_groups=n_groups, per_row=per_row, reach=26,
              trusted=dev(rng.random((n, 181)) < 0.7) if ring else None,
              tail_weight=0.25)
    g_k = dev(_dirty_grid(rng, (size, size), prefill), f32)
    g_p = g_k.clone()
    before = room_raster.launches
    _, cnt_k = room_raster(g_k, *args, BeamSpec.scan(181), cfg, **kw)
    torch.cuda.synchronize()
    assert room_raster.launches == before + 1
    _, cnt_p = room_raster_plain(g_p, *args, BeamSpec.scan(181), cfg, **kw)
    diff = int((g_k.view(torch.int32) != g_p.view(torch.int32)).sum())
    assert diff == 0, f"{diff} cells differ"
    assert torch.equal(cnt_k, cnt_p)
    assert float(cnt_k.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["window", "room", "exact"])
def test_misaligned_grid_raises(cuda, kernel):
    """The kernels read the grid in 16-byte vectors, so a contiguous grid
    view 4 bytes past a 16-byte boundary is refused at the launch entry
    (cudaErrorInvalidValue, raised by the wrapper) with nothing launched
    or written; the card stays usable, and the same call on an aligned
    grid paints."""
    size, per_row, n_rooms = 512, 2, 4
    cfg = GridConfig(size=size, origin_x=0.0, origin_y=0.0)
    rng = np.random.default_rng(7)
    _, origins = make_tiled_rooms(n_rooms, per_row=per_row)
    n = 2 * n_rooms
    xy = origins[np.arange(n) // 2] + rng.uniform([0.5, 0.5], [5.5, 3.5],
                                                  (n, 2))
    args = (torch.tensor(xy, dtype=torch.float32, device=cuda),
            torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32,
                         device=cuda),
            torch.tensor(rng.uniform(0.1, 1.0, (n, 181)),
                         dtype=torch.float32, device=cuda),
            torch.ones(n, dtype=torch.bool, device=cuda))
    spec = BeamSpec.scan(181)
    if kernel == "window":
        fn = free_raster

        def call(g):
            return free_raster(g, *args, None, spec, cfg, reach=26)
    elif kernel == "room":
        fn = room_raster

        def call(g):
            return room_raster(g, *args, spec, cfg, per_row=per_row,
                               reach=26)
    else:
        fn = beam_raster
        tr = torch.ones((n, 181), dtype=torch.bool, device=cuda)

        def call(g):
            beam_raster(g, *args[:3], tr, args[3], spec, cfg)
            return g, (g != 0).sum().to(torch.float32)
    buf = torch.zeros(size * size + 4, device=cuda)
    g = buf[1:1 + size * size].view(size, size)
    assert g.is_contiguous() and g.data_ptr() % 16 == 4
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        call(g)
    torch.cuda.synchronize()
    assert fn.launches == before
    assert not bool(buf.any())
    _, cnt = call(torch.zeros((size, size), device=cuda))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert float(cnt.sum()) > 0
