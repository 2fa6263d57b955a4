"""The port's r1 exact raster (`ops/exact_raster_cuda.py`, replacing
`_kernel` / `beam_raster_pallas`) against the JAX package, on the CPU.

- `beam_raster_plain` (the function the CUDA kernel is held bit-equal to on
  the card) against the jitted `beam_raster_pallas(..., interpret=True)`
  on the wrapped 4-way fan and a 37-beam and the 181-beam scan, agents
  spread out or overlapping on a grid pre-filled near +-clamp: maps
  decision-equal (`torch_parity.decision_equal`: cells differing by more
  than 1e-6 at most 0.01% of the painted cells). The interpreted kernel
  multiplies `rel` by float32(1 / dtheta) (its compiled HLO holds the
  reciprocal and no division by dtheta), as the port does (ROADMAP C15).
- Against `beam_raster_reference` (the XLA tier, one clip after the sum),
  the JAX package's own bar (tests/test_beam_raster.py:69-71): at most 8
  cells differ by more than 1e-4.
- The wrapped fan's right and back beams are painted (the sine is
  periodic, so the residual from the wrapped bin is harmless here, unlike
  the window kernel's, ROADMAP C16).
- A NaN grid cell stays NaN, inside a window and outside, as under the
  reference's `jnp.clip` (`torch.clamp` keeps it too; the CUDA kernels'
  clip is held to the same in tests/test_torch_kernel_cuda.py).
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
from swarm_tpu_torch import convert
from swarm_tpu_torch.config import GridConfig as PGrid
from swarm_tpu_torch.ops import beam_raster as pb
from swarm_tpu_torch.ops import exact_raster_cuda as pe
from tests.torch_parity import decision_equal, t

GRID = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
PGRID = convert.config_from(GRID, PGrid)


def _specs(n_beams):
    if n_beams == 4:
        return jb.BeamSpec.four_way(), pb.BeamSpec.four_way()
    return jb.BeamSpec.scan(n_beams), pb.BeamSpec.scan(n_beams)


@functools.lru_cache(maxsize=None)
def _pallas_fn(n_beams):
    """The jitted beam_raster_pallas of a fan, compiled once per module for
    each shape of its inputs."""
    spec_j, _ = _specs(n_beams)
    return jax.jit(lambda *a: jp.beam_raster_pallas(*a, spec_j, GRID,
                                                    interpret=True))


def _pallas(grid, xy, yaw, d, tr, act, n_beams):
    return _pallas_fn(n_beams)(
        jnp.asarray(grid), jnp.asarray(xy), jnp.asarray(yaw), jnp.asarray(d),
        jnp.asarray(tr), jnp.asarray(act))


@pytest.mark.parametrize("n_beams,case", [
    (4, "spread"), (4, "overlap"), (37, "spread"), (37, "overlap"),
    (181, "spread"), (181, "overlap")])
def test_plain_matches_pallas(rng, n_beams, case):
    _, spec_p = _specs(n_beams)
    if case == "overlap":
        cells = np.array([200.0, 260.0]) + rng.uniform(-4, 4, (6, 2))
        grid = rng.choice([-9.9, 9.7, -9.6, 9.95, -0.3], (512, 512))
    else:
        cells = rng.uniform(3.0, 509.0, (6, 2))
        grid = np.zeros((512, 512))
    xy = (cells * 0.05).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    yaw[:3] = [0.0, np.pi, -2.5]
    d, tr = jb.beams_from_4way(jnp.asarray(rng.uniform(
        0.1, 2.0, (6, n_beams)), jnp.float32), 1.2, 0.05)
    d, tr = np.asarray(d), np.asarray(tr)
    act = np.array([True] * 5 + [False])
    grid = grid.astype(np.float32)
    ref = _pallas(grid, xy, yaw, d, tr, act, n_beams)
    before = pe.beam_raster.launches
    got = pe.beam_raster(torch.from_numpy(grid.copy()), t(xy), t(yaw), t(d),
                         t(tr), t(act), spec_p, PGRID)
    assert pe.beam_raster.launches == before     # CPU: the plain version
    changed = int((np.asarray(ref) != grid).sum())
    decision_equal(got, ref, f"exact {n_beams} {case} map", painted=changed)
    assert changed > 200


@pytest.mark.parametrize("n_beams", [4, 181])
def test_plain_keeps_nan_as_pallas(rng, n_beams):
    """Overlapping agents on a grid pre-filled near +-clamp with a -0.0 and
    1% NaN cells: the NaN cells equal in both maps (inside the windows and
    outside), every other cell decision-equal as in
    test_plain_matches_pallas."""
    _, spec_p = _specs(n_beams)
    cells = np.array([200.0, 260.0]) + rng.uniform(-4, 4, (6, 2))
    grid = rng.choice([-9.9, 9.7, -0.0, -0.3], (512, 512)).astype(np.float32)
    grid[rng.random((512, 512)) < 0.01] = np.nan
    xy = (cells * 0.05).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    d, tr = jb.beams_from_4way(jnp.asarray(rng.uniform(
        0.1, 2.0, (6, n_beams)), jnp.float32), 1.2, 0.05)
    d, tr = np.asarray(d), np.asarray(tr)
    act = np.array([True] * 5 + [False])
    ref = np.asarray(_pallas(grid, xy, yaw, d, tr, act, n_beams))
    got = pe.beam_raster(torch.from_numpy(grid.copy()), t(xy), t(yaw), t(d),
                         t(tr), t(act), spec_p, PGRID).numpy()
    nan = np.isnan(grid)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(np.isnan(ref), nan)
    # NaN cells on both sides of the windows' edges
    w = pe._windows(torch.from_numpy(grid), t(xy), t(yaw), t(d), t(tr),
                    t(act), PGRID)
    inside = np.zeros_like(nan)
    for r0, c0 in zip(w.row0.tolist(), w.col0.tolist()):
        inside[r0:r0 + w.rows, c0:c0 + w.cols] = True
    assert (nan & inside).sum() > 100 and (nan & ~inside).sum() > 100
    changed = int(((ref != grid) & ~nan).sum())
    decision_equal(np.where(nan, 0.0, got), np.where(nan, 0.0, ref),
                   f"exact {n_beams} NaN map", painted=changed)
    assert changed > 200


def test_plain_matches_reference():
    """tests/test_beam_raster.py's own case (a 640^2 grid of N(0, 0.2)
    log-odds, 6 agents, the last inactive) against the XLA tier, at that
    test's bar."""
    cfg_j = GridConfig(size=640)
    cfg_p = convert.config_from(cfg_j, PGrid)
    rng = np.random.default_rng(1)
    n = 6
    lo = rng.normal(0, 0.2, (640, 640)).astype(np.float32)
    xy = rng.uniform(-3, 20, (n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    active = np.array([True] * (n - 1) + [False])
    for n_beams, dist in ((4, rng.uniform(0.1, 2.0, (n, 4))),
                          (37, rng.uniform(0.1, 2.0, (n, 37)))):
        spec_j, spec_p = _specs(n_beams)
        d, tr = jb.beams_from_4way(jnp.asarray(dist, jnp.float32), 1.2, 0.05)
        d_m = jnp.where(jnp.asarray(active)[:, None], d, 0.0)
        ref, _ = jax.jit(lambda *a: jb.beam_raster_reference(
            *a, spec_j, cfg_j))(jnp.asarray(lo), jnp.asarray(xy),
                                jnp.asarray(yaw), d_m,
                                tr & jnp.asarray(active)[:, None])
        got = pe.beam_raster_plain(torch.from_numpy(lo.copy()), t(xy),
                                   t(yaw), t(d), t(tr), t(active), spec_p,
                                   cfg_p)
        diff = np.abs(got.numpy() - np.asarray(ref))
        print(f"exact {n_beams} vs reference: {(diff > 1e-4).sum()} cells "
              f"differ by > 1e-4")
        assert (diff > 1e-4).sum() <= 8


def test_wrapped_fan_paints_every_beam():
    """One agent, the wrapped 4-way fan, every range 1 m: the right beam
    and both halves of the back beam are painted out to the range, as are
    the front and left (the window kernel paints the right beam and the
    lower back half only within ~0.6 cells, ROADMAP C16)."""
    _, spec_p = _specs(4)
    xy = np.array([[10.0, 10.0]], np.float32)        # cell centre 200, 200
    for yaw in (0.0, 0.7):
        args = (np.array([yaw], np.float32), np.full((1, 4), 1.0, np.float32),
                np.ones((1, 4), bool), np.ones(1, bool))
        ref = _pallas(np.zeros((512, 512), np.float32), xy, *args, 4)
        got = pe.beam_raster(torch.zeros(512, 512), t(xy),
                             *(t(a) for a in args), spec_p, PGRID)
        decision_equal(got, ref, f"exact 4-way yaw {yaw}")
        ys, xs = np.nonzero(got.numpy())
        r = np.hypot(ys + 0.5 - 200, xs + 0.5 - 200)
        rel = np.arctan2(ys + 0.5 - 200, xs + 0.5 - 200) - yaw
        rel = (rel + np.pi) % (2 * np.pi) - np.pi
        far = r > 5.0
        for lo, hi in ((-0.3, 0.3), (np.pi / 2 - 0.3, np.pi / 2 + 0.3),
                       (-np.pi / 2 - 0.3, -np.pi / 2 + 0.3)):
            assert (far & (rel > lo) & (rel < hi)).sum() >= 10, (yaw, lo)
        assert (far & (rel > np.pi - 0.3)).sum() >= 5
        assert (far & (rel < -np.pi + 0.3)).sum() >= 5


def test_refusals():
    """A bfloat16 grid (the reference's window is float32) and a grid on
    neither the CPU nor the card are refused."""
    args = (torch.zeros(1, 2), torch.zeros(1), torch.ones(1, 37),
            torch.ones(1, 37, dtype=torch.bool),
            torch.ones(1, dtype=torch.bool), pb.BeamSpec.scan(37), PGRID)
    with pytest.raises(ValueError, match="float32"):
        pe.beam_raster(torch.zeros(512, 512, dtype=torch.bfloat16), *args)
    with pytest.raises(ValueError):
        pe.beam_raster(torch.zeros(512, 512, device="meta"), *args)
