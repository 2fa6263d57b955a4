"""The port on a bfloat16 grid (`GridConfig.logodds_dtype="bfloat16"`,
bench.py --grid-dtype bfloat16) against the JAX functions, on the CPU.

- The window raster in its forms on a bf16 grid against the jitted
  `free_raster_pallas(..., interpret=True)` on the same bf16 grid: windows
  16-row aligned ([80, 256] at the 26-cell reach, bit-exact origins), maps
  decision-equal (`torch_parity.decision_equal`: cells differing by more
  than 1e-6 at most 0.01% of the painted cells; a differing bf16 cell is a
  different bf16 value), counts rtol 1e-5. On a grid pre-filled near
  +-clamp with overlapping windows the reference rounds each agent's window
  to bf16 before the next agent reads it; the test shows that rounding once
  at the end differs.
- The endpoint scatter and the tri-state view on bf16: exact.
- The merge's occupancy mass on bf16: exact against the jitted reference,
  which divides by bf16(2 hit) and rounds the quotient to bf16 (ROADMAP
  C17); the Python-scalar division differs.
- One merge step of the bf16 window preset, port against JAX
  (`torch_parity.merge_step_parity`).
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
from swarm_tpu_torch.slam.livemerge import occupancy_mass
from tests.torch_parity import (assert_exact, decision_equal, f32,
                                merge_step_parity, t)

GRID = GridConfig(size=512, origin_x=0.0, origin_y=0.0)
BF16 = torch.bfloat16


def bf16_grid(values) -> tuple:
    """The same bf16 grid on both sides, from float32 values (both round
    to nearest even)."""
    g = np.asarray(values, np.float32)
    return jnp.asarray(g).astype(jnp.bfloat16), torch.from_numpy(g).to(BF16)


def test_bf16_windows_are_16_row_aligned(rng):
    """Window shape and origins on a bf16 grid: [80, 256], origins
    16-aligned, bit-exact against the reference's row_align=16."""
    for size in (512, 4096):
        assert pb.patch_dims(size, 26, row_align=16) == \
            jb.patch_dims(size, 26, row_align=16)
        rows, cols = pb.patch_dims(size, 26, row_align=16)
        ax, ay = rng.uniform(-5, size + 5, (2, 512)).astype(np.float32)
        ref = jb.patch_origin(jnp.asarray(ax), jnp.asarray(ay), size, rows,
                              cols, 26, row_align=16)
        got = pb.patch_origin(t(ax), t(ay), size, rows, cols, 26,
                              row_align=16)
        assert_exact(got[0], ref[0])
        assert_exact(got[1], ref[1])
    assert pb.patch_dims(4096, 26, row_align=16) == (80, 256)
    w = pc._windows(torch.zeros(512, 512, dtype=BF16),
                    torch.tensor([[5.0, 5.0]]), torch.zeros(1),
                    torch.ones(1, 181), torch.ones(1, dtype=bool),
                    pb.BeamSpec.scan(181), convert.config_from(GRID, PGrid),
                    torch.ones(1, 181, dtype=bool), 26)
    assert (w.rows, w.cols) == (80, 256) and int(w.row0[0]) % 16 == 0
    assert pc.form_name(pb.BeamSpec.scan(181), True, True, BF16) == \
        "pack8-ring-bf16"
    assert pc.form_name(pb.BeamSpec.four_way(), True, True, BF16) == \
        "pack8-ring-wrapped-bf16"


def _agents(rng, n_beams, pos, seed):
    xy = np.asarray(pos, np.float32)[:, ::-1] * GRID.resolution
    n = xy.shape[0]
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    yaw[:3] = [0.0, np.pi, -2.5]
    r = np.random.default_rng(seed)
    dist = r.uniform(0.15, 1.19, (n, n_beams)).astype(np.float32)
    trusted = r.random((n, n_beams)) < 0.7
    return xy, yaw, dist, trusted


SPREAD = [[250.0, 120.0], [253.0, 253.0], [40.0, 300.0], [500.0, 10.0]]

# (beams, pack8, ring): the slice's pack8 + ring on the scan, and the other
# per-beam forms the bf16 grid reaches
BF16_FORMS = {"scan-pack8-ring": (181, True, True),
              "scan-pack8": (181, True, False),
              "scan-pack16-ring": (181, False, True),
              "scan-pack16": (181, False, False),
              "4way-pack8-ring": (4, True, True),
              "4way-pack16": (4, False, False)}


def _overlap_case(rng, n_beams, seed, n=6):
    pos = np.array([200.0, 260.0]) + rng.uniform(-4, 4, (n, 2))
    grid = rng.choice([-9.9, 9.7, -9.6, 9.95, -0.3, 0.31], (512, 512))
    return grid, _agents(rng, n_beams, pos, seed)


def _pallas_bf16(grid_j, xy, yaw, dist, act, trusted, n_beams, pack8, ring):
    spec = jb.BeamSpec.four_way() if n_beams == 4 else jb.BeamSpec.scan(
        n_beams)
    return jax.jit(lambda *a: jp.free_raster_pallas(
        *a[:5], spec, GRID, n_groups=n_beams, reach=26, trusted=a[5],
        interpret=True, pack8=pack8))(
        grid_j, jnp.asarray(xy), jnp.asarray(yaw), jnp.asarray(dist),
        jnp.asarray(act), jnp.asarray(trusted) if ring else None)


@pytest.mark.parametrize("form,case", [
    ("scan-pack8-ring", "spread"), ("scan-pack8-ring", "overlap"),
    ("scan-pack8", "overlap"), ("scan-pack16-ring", "overlap"),
    ("scan-pack16", "spread"), ("4way-pack8-ring", "spread"),
    ("4way-pack8-ring", "overlap"), ("4way-pack16", "overlap")])
def test_window_forms_bf16_match_pallas(rng, form, case):
    n_beams, pack8, ring = BF16_FORMS[form]
    if case == "overlap":
        grid, (xy, yaw, dist, trusted) = _overlap_case(rng, n_beams, 7)
    else:
        grid = np.zeros((512, 512))
        xy, yaw, dist, trusted = _agents(rng, n_beams, SPREAD, 11)
    act = np.ones(len(xy), bool)
    act[3] = False
    grid_j, grid_p = bf16_grid(grid)
    ref, rc = _pallas_bf16(grid_j, xy, yaw, dist, act, trusted, n_beams,
                           pack8, ring)
    assert ref.dtype == jnp.bfloat16
    spec = pb.BeamSpec.four_way() if n_beams == 4 else pb.BeamSpec.scan(
        n_beams)
    got, gc = pc.free_raster(grid_p.clone(), t(xy), t(yaw), t(dist), t(act),
                             t(trusted) if ring else None, spec,
                             convert.config_from(GRID, PGrid), reach=26,
                             pack8=pack8)
    assert got.dtype == BF16
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5)
    assert float(gc.sum()) > 0 and float(gc[3]) == 0.0
    decision_equal(got, ref, f"bf16 {form} map",
                   painted=int((f32(ref) != f32(grid_j)).sum()))


def test_bf16_rounds_after_each_agent(rng):
    """Overlapping windows on a bf16 grid pre-filled near +-clamp: the
    reference stores each agent's window as bf16 before the next agent
    adds to it; the port does the same, and rounding once after all agents
    (each still clipped after its agent) differs in many cells."""
    grid, (xy, yaw, dist, trusted) = _overlap_case(rng, 181, 3, n=8)
    act = np.ones(len(xy), bool)
    grid_j, grid_p = bf16_grid(grid)
    ref, _ = _pallas_bf16(grid_j, xy, yaw, dist, act, trusted, 181, True,
                          True)
    cfg = convert.config_from(GRID, PGrid)
    spec = pb.BeamSpec.scan(181)
    got, _ = pc.free_raster_plain(grid_p.clone(), t(xy), t(yaw), t(dist),
                                  t(act), t(trusted), spec, cfg, reach=26)
    decision_equal(got, ref, "bf16 overlap map",
                   painted=int((f32(ref) != f32(grid_j)).sum()))
    w = pc._windows(grid_p, t(xy), t(yaw), t(dist), t(act), spec, cfg,
                    t(trusted), 26)
    delta, _ = pc._window_deltas(w, spec, cfg, True)
    once = grid_p.to(torch.float32)
    for a in range(len(xy)):
        r0, c0 = int(w.row0[a]), int(w.col0[a])
        win = once[r0:r0 + w.rows, c0:c0 + w.cols]
        win.copy_(torch.clamp(win + delta[a], -10.0, 10.0))
    once = once.to(BF16)
    n_diff = int((once != got).sum())
    print(f"round once at the end: {n_diff} cells differ")
    assert n_diff > 20


def test_endpoint_scatter_bf16(rng):
    """The exact endpoint scatter on a bf16 grid against the reference's
    `clip(lo.astype(f32) + logodds_delta(rays, k_max=1)).astype(bf16)`
    (swarm_tpu/engine/sim.py:613-616), jitted: exact, with 40 and 3
    endpoints in two cells."""
    gj = GridConfig(size=128, origin_x=-1.0, origin_y=-2.0)
    gp = convert.config_from(gj, PGrid)
    r = 3000
    hx = rng.uniform(-1.3, 5.4, r).astype(np.float32)
    hy = rng.uniform(-2.3, 4.4, r).astype(np.float32)
    hx[:40], hy[:40] = 0.52, 0.53
    hx[40:43], hy[40:43] = 1.02, -1.23
    ok = rng.random(r) < 0.8
    ok[:43] = True
    grid_j, grid_p = bf16_grid(rng.choice([-9.9, 9.7, 0.0, -3.2, 9.95, 0.3],
                                          (128, 128)))

    @jax.jit
    def ref_fn(lo, rays):
        d, w = jr.logodds_delta(rays, gj, k_max=1)
        return jnp.clip(lo.astype(jnp.float32) + d, -gj.logodds_clamp,
                        gj.logodds_clamp).astype(lo.dtype), w

    ref, w_ref = ref_fn(grid_j, jr.RayBatch(*(jnp.asarray(a) for a in (
        hx, hy, hx, hy, ok, ok))))
    got, w_got = pr.endpoint_scatter(grid_p.clone(), pr.RayBatch(*(
        t(a) for a in (hx, hy, hx, hy, ok, ok))), gp)
    assert got.dtype == BF16
    assert_exact(f32(got), f32(ref))
    assert int(w_got) == int(w_ref) > 0


def test_tri_state_view_bf16():
    """Every bf16 value in [-4, 4] (each bit pattern), and both thresholds'
    neighbours, through the tri-state view on both sides: exact."""
    bits = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    vals = torch.from_numpy(bits).view(BF16).to(torch.float32).numpy()
    vals = vals[np.isfinite(vals) & (np.abs(vals) <= 4.0)]
    vals = np.concatenate([vals, np.float32([0.3, -0.3, 0.30078125,
                                             -0.30078125, 0.29882812])])
    side = int(np.ceil(np.sqrt(vals.size)))
    grid = np.zeros(side * side, np.float32)
    grid[:vals.size] = vals
    grid_j, grid_p = bf16_grid(grid.reshape(side, side))
    cfg = GridConfig(size=side)
    ref = jax.jit(functools.partial(jr.tri_state_view, cfg=cfg))(grid_j)
    got = pr.tri_state_view(grid_p, convert.config_from(cfg, PGrid))
    assert_exact(got, ref)
    assert int((got == cfg.free).sum()) > 400
    assert int((got == cfg.occupied).sum()) > 400


def test_merge_mass_bf16(rng):
    """The merge's occupancy mass on a bf16 map: exact against the jitted
    reference expression (swarm_tpu/slam/livemerge.py:96, then the
    window's float32 cast), which divides by bf16(1.7) = 1.703125 and
    rounds the quotient to bf16 (ROADMAP C17); dividing the bf16 map by the
    Python scalar 1.7 (float32 arithmetic, one rounding) differs."""
    g = rng.uniform(-10, 10, (256, 256)).astype(np.float32)
    g[:64] = rng.uniform(0.0, 3.5, (64, 256))
    grid_j, grid_p = bf16_grid(g)
    hit = GridConfig().logodds_hit

    @jax.jit
    def ref_fn(lo):
        return jnp.clip(lo / (2.0 * hit), 0.0, 1.0).astype(jnp.float32)

    ref = np.asarray(ref_fn(grid_j))
    got = occupancy_mass(grid_p, PGrid())
    assert got.dtype == torch.float32
    assert_exact(got, ref)
    other = torch.clamp(grid_p / (2.0 * hit), 0.0, 1.0).to(torch.float32)
    n_diff = int((other.numpy() != ref).sum())
    print(f"Python-scalar division: {n_diff} of {ref.size} cells differ")
    assert n_diff > 100
    # a float32 map goes through the same function unchanged
    assert_exact(occupancy_mass(torch.from_numpy(g), PGrid()),
                 np.clip(torch.from_numpy(g).numpy()
                         / np.float32(2.0 * hit), 0, 1))


def test_bf16_state_round_trip():
    """A bf16 JAX state crosses to the port and back bit for bit."""
    from swarm_tpu.engine import sim as js
    from swarm_tpu_torch.engine import sim as ps
    from tests.torch_parity import jax_deployable

    cfg, _, params, _ = jax_deployable(8, grid_dtype="bfloat16")
    st = js.sim_init(cfg, params)
    st = st._replace(srv=st.srv._replace(
        logodds=st.srv.logodds.at[3, :7].set(
            jnp.asarray([0.3, -0.4, 9.7, 1.7, -10.0, 0.1, 2.3],
                        jnp.bfloat16))))
    port = convert.to_torch(st, ps.SimState)
    assert port.srv.logodds.dtype == BF16 and port.srv.anchor.dtype == BF16
    back = convert.to_numpy_like(port, st)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert_exact(np.atleast_1d(a).view(np.uint8),
                     np.atleast_1d(b).view(np.uint8))


def test_bf16_merge_step_parity():
    """`deployable(8, grid_dtype="bfloat16", merge_every=4)`: step 3 (a
    merge step) through the bf16 window raster, the merge on the bf16 map
    and the bf16 anchor freeze, port against JAX."""
    merge_step_parity(room_kernel=False, grid_dtype="bfloat16")
