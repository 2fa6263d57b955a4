"""The port's beam raster against the Pallas kernel it replaces, on the CPU.

The plain torch version (`free_raster_plain`, the function the CUDA kernel
is held bit-equal to on the card) runs against
`free_raster_pallas(..., pack8=True, trusted=..., interpret=True)`, and in
the exploration path's forms against `pack8=False, trusted=None` (the
scan and the wrapped 4-way fan) and `pack8=True, trusted=...` on the
wrapped fan.
Integer work (pack8 packing, window origins, fan-bbox strip bounds) is
bit-exact. The map is decision-equal within a bound: XLA on the CPU fuses
dx*dx + dy*dy into an FMA and its `lax.rsqrt` is not IEEE 1/sqrt, so a cell
whose radius sits on the `r < rb - 0.5` or `|r - rb| <= 0.71` edge can flip.
Bound: cells differing by more than 1e-6 are at most 0.01% of the painted
cells; counts agree to rtol 1e-5.
"""

import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import GridConfig
from swarm_tpu.ops import beam_raster as jb
from swarm_tpu.ops import beam_raster_pallas as jp
from swarm_tpu_torch.ops import beam_raster as pb
from swarm_tpu_torch.ops import beam_raster_cuda as pc
from tests.torch_parity import assert_close, assert_exact, decision_equal, t

GRID = GridConfig(size=512, origin_x=0.0, origin_y=0.0)


@pytest.mark.parametrize("ring", [True, False])
def test_pack_range8_exact(rng, ring):
    """The pack8 table with the trusted bit (the ring) and without it
    (every bit range), and its unpack, bit-exact."""
    for n_beams in (61, 181):
        d = rng.uniform(-1.0, 40.0, (7, n_beams)).astype(np.float32)
        trusted = rng.random((7, n_beams)) < 0.6
        ref = jp._pack_range8(jnp.asarray(d),
                              jnp.asarray(trusted) if ring else None)
        got = pc._pack_range8(t(d), t(trusted) if ring else None)
        assert got.dtype == torch.int32
        assert_exact(got, ref)
        # the unpack of every lane gives the reference's fields back
        for lane in range(4):
            v8 = (got >> (8 * lane)) & 0xFF
            rb, tf = pc._unpack_range8(v8, ring)
            jrb, jtf = jp._unpack_range8(
                jax.lax.shift_right_logical(jnp.asarray(ref), 8 * lane)
                & 0xFF, ring, v8.shape)
            assert_exact(rb, jrb)
            assert_exact(tf, jtf)


def test_patch_origin_exact(rng):
    for size in (512, 4096):
        rows, cols = pb.patch_dims(size, 26)
        ax, ay = rng.uniform(-5, size + 5, (2, 512)).astype(np.float32)
        ref = jb.patch_origin(jnp.asarray(ax), jnp.asarray(ay), size, rows,
                              cols, 26)
        got = pb.patch_origin(t(ax), t(ay), size, rows, cols, 26)
        assert_exact(got[0], ref[0])
        assert_exact(got[1], ref[1])


def test_fan_bbox_and_strip_bounds(rng):
    """The bbox floats agree to float32 rounding of cos/sin; the 128-col
    strip bounds the kernel reads from them are exact."""
    spec_j, spec_p = jb.BeamSpec.scan(181), pb.BeamSpec.scan(181)
    yaw = rng.uniform(-2 * np.pi, 2 * np.pi, 2048).astype(np.float32)
    yaw[:4] = [0.0, np.pi / 2, -np.pi, np.pi]
    ref = jb.fan_bbox_cells(jnp.asarray(yaw), spec_j, 27.5)
    got = pb.fan_bbox_cells(t(yaw), spec_p, 27.5)
    for a, b in zip(got, ref):
        assert_close(a, b, atol=1e-5, rtol=0)

    size = 4096
    xy = rng.uniform(1.0, 203.0, (2048, 2)).astype(np.float32)
    w = pc._windows(torch.zeros(size, size), t(xy), t(yaw),
                    torch.ones(2048, 181), torch.ones(2048, dtype=bool),
                    spec_p, GridConfig(size=size, origin_x=0.0,
                                       origin_y=0.0),
                    torch.ones(2048, 181, dtype=bool), 26)
    # the reference's strip bounds, as free_raster_pallas computes them
    ax = jnp.asarray(xy[:, 0]) / 0.05
    col0 = jnp.asarray(w.col0.numpy())
    bxmin, bxmax, _, _ = ref
    t_cl = jnp.clip(jnp.floor((ax + bxmin - 1.5 - col0.astype(jnp.float32))
                              / 128.0), 0, 2).astype(jnp.int32)
    t_ch = jnp.clip(jnp.ceil((ax + bxmax + 1.5 - col0.astype(jnp.float32))
                             / 128.0), 0, 2).astype(jnp.int32)
    assert_exact(w.t_cl, t_cl)
    assert_exact(w.t_ch, t_ch)


def test_atan2_and_wrap_semantics(rng):
    y, x = rng.normal(0, 30, (2, 8192)).astype(np.float32)
    x[:4] = [0.0, -1.0, 0.0, -2.0]
    y[:4] = [1.0, 0.0, -3.0, -2.0]
    assert_close(pc._atan2_poly(t(y), t(x)),
                 jp._atan2_poly(jnp.asarray(y), jnp.asarray(x)), atol=1e-6)
    r = rng.uniform(-12.0, 12.0, 8192).astype(np.float32)
    assert_close(pc._wrap_pi_cheap(t(r)), jp._wrap_pi_cheap(jnp.asarray(r)),
                 atol=1e-6)


def _agents(rng, n_beams, pos_cells, seed):
    xy = (np.asarray(pos_cells, np.float32)[:, ::-1] * GRID.resolution)
    n = xy.shape[0]
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    dist = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                         (n, n_beams), minval=0.15,
                                         maxval=1.19))
    trusted = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed + 1),
                                              0.7, (n, n_beams)))
    return xy, yaw, dist, trusted


SPREAD = [[250.0, 120.0], [253.0, 253.0], [40.0, 300.0], [500.0, 10.0]]
EDGES = [[3.0, 508.0], [509.0, 2.0], [260.0, 511.0], [1.0, 1.0]]


@pytest.mark.parametrize("n_beams,pos", [(61, SPREAD), (181, SPREAD),
                                         (181, EDGES)])
def test_plain_matches_pallas_full_grid(rng, n_beams, pos):
    """The cases of tests/test_beam_raster.py:226-294 on the full grid,
    plus agents on the grid's edges (clamped windows); agent 3 inactive."""
    xy, yaw, dist, trusted = _agents(rng, n_beams, pos, n_beams)
    act = np.array([True, True, True, False])
    spec_j, spec_p = jb.BeamSpec.scan(n_beams), pb.BeamSpec.scan(n_beams)
    ref, rc = jp.free_raster_pallas(
        jnp.zeros((512, 512)), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(dist), jnp.asarray(act), spec_j, GRID,
        n_groups=n_beams, reach=26, trusted=jnp.asarray(trusted),
        interpret=True, pack8=True)
    before = pc.free_raster.launches
    got, gc = pc.free_raster(torch.zeros(512, 512), t(xy), t(yaw), t(dist),
                             t(act), t(trusted), spec_p, GRID, reach=26)
    assert pc.free_raster.launches == before     # CPU: the plain version
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert float(gc.sum()) > 0 and float(gc[3]) == 0.0
    decision_equal(got, ref, "window map")


def test_overlap_saturation_clip_order(rng):
    """Agents whose windows overlap on a grid pre-filled near +-clamp: the
    kernel clips after EACH agent in index order (ROADMAP Queue C2), which
    differs from one clip after the sum wherever windows saturate."""
    n = 6
    center = np.array([200.0, 260.0])
    pos = center + rng.uniform(-4, 4, (n, 2))
    xy, yaw, dist, trusted = _agents(rng, 181, pos, 3)
    act = np.ones(n, bool)
    grid = rng.choice([-9.9, 9.7, -9.6, 9.95], (512, 512)).astype(np.float32)
    spec_j, spec_p = jb.BeamSpec.scan(181), pb.BeamSpec.scan(181)
    ref, rc = jp.free_raster_pallas(
        jnp.asarray(grid), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(dist), jnp.asarray(act), spec_j, GRID, n_groups=181,
        reach=26, trusted=jnp.asarray(trusted), interpret=True, pack8=True)
    got, gc = pc.free_raster_plain(torch.from_numpy(grid.copy()), t(xy),
                                   t(yaw), t(dist), t(act), t(trusted),
                                   spec_p, GRID, reach=26)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    changed = (np.asarray(ref) != grid).sum()
    decision_equal(got, ref, "window map", painted=changed)
    # the order matters here: one clip after the summed deltas differs
    sum_then_clip = grid.copy()
    w = pc._windows(torch.from_numpy(grid), t(xy), t(yaw), t(dist), t(act),
                    spec_p, GRID, t(trusted), 26)
    delta, _ = pc._window_deltas(w, spec_p, GRID, True)
    for a in range(n):
        r0, c0 = int(w.row0[a]), int(w.col0[a])
        sum_then_clip[r0:r0 + w.rows, c0:c0 + w.cols] += delta[a].numpy()
    sum_then_clip = np.clip(sum_then_clip, -10.0, 10.0)
    assert (np.abs(sum_then_clip - np.asarray(ref)) > 1e-3).sum() > 20


# the window raster's per-beam forms besides the deployable one (pack8 +
# ring on the scan, above): (beams, pack8, ring). The exploration path's
# pack16 without the ring, bench.py --scan-rays 0's pack8 + ring on the
# wrapped fan, --no-pack8's pack16 + ring, --exact-endpoints' pack8
# without the ring, each on the scan and the wrapped fan.
FORMS = {"scan-pack16": (181, False, False), "4way-pack16": (4, False, False),
         "4way-pack8-ring": (4, True, True),
         "scan-pack16-ring": (181, False, True),
         "4way-pack16-ring": (4, False, True),
         "scan-pack8": (181, True, False), "4way-pack8": (4, True, False)}


def _specs(n_beams):
    if n_beams == 4:
        return jb.BeamSpec.four_way(), pb.BeamSpec.four_way()
    return jb.BeamSpec.scan(n_beams), pb.BeamSpec.scan(n_beams)


@functools.lru_cache(maxsize=None)
def _jit_pallas(n_beams, pack8):
    """`free_raster_pallas` in interpret mode under jit, as the engine runs
    it (XLA folds its divisions by constants into multiplications, which
    the port follows), built once per form: its cases share the compile
    wherever their shapes agree."""
    spec_j, _ = _specs(n_beams)
    return jax.jit(lambda *a: jp.free_raster_pallas(
        *a[:5], spec_j, GRID, n_groups=n_beams, reach=26, trusted=a[5],
        interpret=True, pack8=pack8))


@pytest.mark.parametrize("case", ["spread", "edges", "overlap"])
@pytest.mark.parametrize("form", list(FORMS))
def test_forms_match_pallas(rng, form, case):
    """Each form of FORMS against
    `free_raster_pallas(..., trusted=None | tb, pack8=..., interpret=True)`:
    agents spread out, on the grid's edges, or overlapping on a grid
    pre-filled near +-clamp. Headings include 0, pi and -2.5 rad, where
    the wrapped fan's bin is negative before its floor-mod."""
    n_beams, pack8, ring = FORMS[form]
    _, spec_p = _specs(n_beams)
    if case == "overlap":
        pos = np.array([200.0, 260.0]) + rng.uniform(-4, 4, (6, 2))
        grid = rng.choice([-9.9, 9.7, -9.6, 9.95],
                          (512, 512)).astype(np.float32)
    else:
        pos = SPREAD if case == "spread" else EDGES
        grid = np.zeros((512, 512), np.float32)
    xy, yaw, dist, trusted = _agents(rng, n_beams, pos, n_beams + len(pos))
    yaw[:3] = [0.0, np.pi, -2.5]
    act = np.ones(len(pos), bool)
    act[3] = False
    ref, rc = _jit_pallas(n_beams, pack8)(
        jnp.asarray(grid), jnp.asarray(xy), jnp.asarray(yaw),
        jnp.asarray(dist), jnp.asarray(act),
        jnp.asarray(trusted) if ring else None)
    before = pc.free_raster.launches
    got, gc = pc.free_raster(torch.from_numpy(grid.copy()), t(xy), t(yaw),
                             t(dist), t(act), t(trusted) if ring else None,
                             spec_p, GRID, reach=26, pack8=pack8)
    assert pc.free_raster.launches == before     # CPU: the plain version
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert float(gc.sum()) > 0 and float(gc[3]) == 0.0
    decision_equal(got, ref, f"{form} map",
                   painted=int((np.asarray(ref) != grid).sum()))


def test_wrapped_fan_sectors():
    """The reference's wrapped 4-way fan takes the on-beam residual from
    the WRAPPED bin, so cells whose bin is negative before the floor-mod
    (the right beam and the lower half of the back beam) are painted only
    within ~0.6 cells of the agent; the port does the same (ROADMAP Queue
    C)."""
    _, spec_p = _specs(4)
    xy = np.array([[10.0, 10.0]], np.float32)        # cell centre 200, 200
    for yaw in (0.0, 0.7):
        args = (np.array([yaw], np.float32), np.full((1, 4), 1.0, np.float32),
                np.ones(1, bool), np.ones((1, 4), bool))
        ref, _ = _jit_pallas(4, True)(
            jnp.zeros((512, 512)), jnp.asarray(xy),
            *(jnp.asarray(a) for a in args))
        got, _ = pc.free_raster(torch.zeros(512, 512), t(xy),
                                *(t(a) for a in args), spec_p, GRID,
                                reach=26, pack8=True)
        assert_exact(got, ref)
        ys, xs = np.nonzero(got.numpy())
        rel = np.arctan2(ys + 0.5 - 200, xs + 0.5 - 200) - yaw
        rel = (rel + np.pi) % (2 * np.pi) - np.pi
        assert ((rel > -np.pi / 4) & (rel < np.pi)).sum() > 60
        assert ((rel < -np.pi / 4) & (rel > -np.pi + 1e-3)).sum() == 0


def test_kernel_constants_are_the_reference_literals():
    """The CUDA sources write the reference's float literals as exact hex
    floats (in the header both raster kernels include); each must be
    float32 of the Python literal."""
    src = (Path(pc._SOURCE).parent / "raster_common.cuh").read_text()
    assert '#include "raster_common.cuh"' in Path(pc._SOURCE).read_text()
    want = {"EPS_R2": 1e-6, "EPS_HI": 1e-20, "C0": 0.99997726,
            "C1": -0.33262347, "C2": 0.19354346, "C3": -0.11643287,
            "C4": 0.05265332, "C5": -0.01172120, "HALF_PI": math.pi / 2,
            "PI_F": math.pi, "TWO_PI": 2 * math.pi,
            "INV_TWO_PI": 1 / (2 * math.pi), "RING": 0.71, "ON_BEAM": 0.6}
    for name, value in want.items():
        m = re.search(rf"constexpr float {name} = (-?0x[0-9a-fp.+-]+)f;",
                      src)
        assert m, name
        assert np.float32(float.fromhex(m.group(1))) == np.float32(value), \
            name


def test_cuda_tensor_never_takes_the_plain_path():
    """On a CUDA grid the wrapper launches the kernel or raises; only a
    CPU grid reaches the plain version (checked without a card: a 'meta'
    grid is neither and is refused)."""
    g = torch.zeros(512, 512, device="meta")
    with pytest.raises(ValueError):
        pc.free_raster(g, torch.zeros(1, 2), torch.zeros(1),
                       torch.zeros(1, 181), torch.ones(1, dtype=bool),
                       torch.ones(1, 181, dtype=bool), pb.BeamSpec.scan(181),
                       GRID, reach=26)
