"""The port's counterparts of tools/ (bench_coverage, bench_merge,
profile_step, roofline, quality_onchip, proto_phase_quality) against the
tools, on the CPU.

Where a tool has code to hold, the port is held against it: the tool's
`reachable_mask` and `steps_to` (tools/bench_coverage.py imports only numpy
at its top and is loaded by path), the merge bench's inputs and solves
against JAX's, the quality tools' IoU and wall p90 against their inline
expressions, quality_onchip's world against the tool's. The CLIs run at
tiny sizes on the CPU (the plain rasters); roofline needs the card.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.slam import posegraph as jpg
from swarm_tpu.slam import tridiag as jtd
from swarm_tpu_torch import (bench_coverage, bench_merge, convert, presets,
                             profile_step, proto_phase_quality,
                             quality_onchip, roofline)
from swarm_tpu_torch.config import GridConfig
from tests.torch_parity import assert_close, assert_exact, jax_deployable

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _tool_coverage():
    spec = importlib.util.spec_from_file_location(
        "tool_bench_coverage", ROOT / "tools" / "bench_coverage.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("world", ["coverage-64", "deployable-8"])
def test_reachable_mask_equals_the_tool(world):
    if world == "coverage-64":
        from __graft_entry__ import _cfg_and_world
        cfg_j, walls_j = _cfg_and_world(
            64, frontiers=False, parity=False, raster_mode="beam",
            use_pallas=True, scan_rays=181, tiled=True)[:2]
        cfg_p, walls_p = presets.coverage(64, False, "cpu")[:2]
    else:
        cfg_j, walls_j = jax_deployable(8)[:2]
        cfg_p, walls_p = presets.deployable(8, device="cpu")[:2]
    want = _tool_coverage().reachable_mask(np.asarray(walls_j), cfg_j.grid)
    got = bench_coverage.reachable_mask(walls_p.numpy(), cfg_p.grid)
    assert want.sum() > 0
    assert_exact(got, want)


@pytest.mark.parametrize("curve", [
    [0.1, 0.5, 0.7, 0.95], [0.0, 0.2, 0.49999], [0.5], [0.9, 0.1, 0.95],
    [0.3, 0.7, 0.7, 0.9]])
def test_steps_to_equals_the_tool(curve):
    cov = np.asarray(curve)
    for frac in (0.5, 0.7, 0.9):
        assert bench_coverage.steps_to(cov, frac) == \
            _tool_coverage().steps_to(cov, frac)


def test_run_variant_refuses_a_ragged_chunk():
    cfg, walls, params, rooms = presets.coverage(8, False, "cpu")
    reach = bench_coverage.reachable_mask(walls.numpy(), cfg.grid)
    with pytest.raises(ValueError, match="multiple of --chunk"):
        bench_coverage.run_variant(cfg, walls, params, rooms, 5, 2, reach,
                                   False)
    cov, nfr = bench_coverage.run_variant(cfg, walls, params, rooms, 4, 2,
                                          reach, False)
    assert cov.shape == (4,) and nfr.shape == (4,)
    assert 0 < cov[-1] <= 1 and np.all(nfr >= 0)


def _reference_merge_inputs(n):
    """tools/bench_merge.py:60-83's draws and JAX graph, as written there."""
    rng = np.random.default_rng(0)
    occ = (rng.random((256, 256)) < 0.02).astype(np.float32)
    local = np.roll(occ, (3, -4), axis=(0, 1))
    t = np.linspace(0, 20 * np.pi, n)
    poses = np.stack([np.cos(t) * 3, np.sin(t) * 3, t % (2 * np.pi)], -1)
    poses += rng.normal(0, 0.05, poses.shape)
    ci = rng.integers(0, n - 200, 64)
    cj = ci + rng.integers(100, 199, 64)
    g = jpg.graph_from_trajectory(
        jnp.asarray(poses, jnp.float32), n,
        jnp.asarray(ci, jnp.int32), jnp.asarray(cj, jnp.int32),
        jnp.asarray(np.zeros((64, 3)), jnp.float32), 64)
    return local, occ, g


def _assert_graph(gp, gj):
    for f in gp._fields:
        a, b = getattr(gp, f), getattr(gj, f)
        if a.dtype.is_floating_point:
            assert_close(a, b, what=f)
        else:
            assert_exact(a, b, what=f)


def test_bench_merge_inputs_are_the_tools():
    local, glob, g = bench_merge.inputs(1024, "cpu")
    local_r, occ_r, g_r = _reference_merge_inputs(1024)
    assert_exact(local, local_r)
    assert_exact(glob, occ_r)
    _assert_graph(g, g_r)
    assert int(g.e_valid.sum()) == 1023 + 64


def _to_jax_graph(gp):
    return jpg.PoseGraph(*(jnp.asarray(f.numpy()) for f in gp))


def _pose_diff(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    yaw = np.remainder(d[:, 2] + np.pi, 2 * np.pi) - np.pi
    return max(np.abs(d[:, :2]).max(), np.abs(yaw).max())


# the merge bench's graph (closures of zero measurement across a noisy
# spiral, a 1e6 anchor, 10 iterations in float32) is ill-conditioned
# (ROADMAP C44). At 128 nodes a change of 1e-6 in the inputs moves JAX's
# own structured solution by 0.017 m and 0.020 rad, and JAX's dense and
# structured solves differ by 0.028 m: the structured poses are set by
# float32 rounding, so that solver is held by its final cost alone. The
# dense poses are held at the pose-graph tests' 1e-3
# (tests/test_torch_posegraph.py), the final costs of both at rtol 1e-3.
DENSE_POSE_ATOL = 1e-3
SOLVE_COST_RTOL = 1e-3


@pytest.mark.parametrize("solver", ["dense", "structured"])
def test_bench_merge_solves_match_jax(solver):
    """The merge bench's solves on a 128-node graph of its inputs against
    JAX's gauss_newton / structured_gn (10 iterations): final costs, and
    the dense poses (yaws as angles)."""
    g = bench_merge.inputs(128, "cpu")[2]
    gj = _to_jax_graph(g)
    if solver == "dense":
        got, costs = bench_merge.solve_dense(g)
        want, costs_j = jax.jit(lambda x: jpg.gauss_newton(
            x, iterations=10))(gj)
        assert _pose_diff(got.poses, want.poses) <= DENSE_POSE_ATOL
    else:
        got, costs = bench_merge.solve_structured(g)
        want, costs_j = jax.jit(lambda x: jtd.structured_gn(
            x, n_chain=127, iterations=10))(gj)
    np.testing.assert_allclose(float(costs[-1]), float(costs_j[-1]),
                               rtol=SOLVE_COST_RTOL)
    assert float(costs[-1]) < 0.05 * float(costs[0])
    assert _pose_diff(got.poses, g.poses) > 1e-1     # the solve moved them


def _quality_reference(exact, fast, grid):
    """tools/quality_onchip.py:65-70 and tools/proto_phase_quality.py:
    106-123, as written there (the distances in one [F, E] block)."""
    fe = exact == grid.free
    ff = fast == grid.free
    iou = (fe & ff).sum() / max((fe | ff).sum(), 1)
    occ_e = np.argwhere(exact == grid.occupied)
    occ_f = np.argwhere(fast == grid.occupied)
    d = np.abs(occ_f[:, None, :] - occ_e[None, :, :]).max(-1).min(-1)
    return dict(iou=iou, p90=np.quantile(d, 0.9), occ_e=len(occ_e),
                occ_f=len(occ_f), miss=(fe & ~ff).sum(),
                extra=(ff & ~fe).sum(),
                miss_unknown=(fe & (fast == grid.unknown)).sum(),
                miss_occ=(fe & (fast == grid.occupied)).sum(),
                exact_free=fe.sum())


@pytest.mark.parametrize("p_occ", [0.002, 0.03])
def test_map_quality_is_the_tools_expression(p_occ):
    """`quality_onchip.map_quality` equals the tools' inline expressions on
    random tri-state maps (at 3% occupied the fast map has ~2,000
    occupied cells: two blocks of ROW_BLOCK rows)."""
    grid = GridConfig(size=256)
    rng = np.random.default_rng(7)
    codes = np.array([grid.free, grid.occupied, grid.unknown], np.int8)

    def tri():
        u = rng.random((256, 256))
        return codes[np.where(u < p_occ, 1, np.where(u < 0.5, 0, 2))]
    exact, fast = tri(), tri()
    got = quality_onchip.map_quality(exact, fast, grid)
    want = _quality_reference(exact, fast, grid)
    assert got["occ_f"] > (quality_onchip.ROW_BLOCK if p_occ > 0.01 else 0)
    assert got == {k: (float(v) if k in ("iou", "p90") else int(v))
                   for k, v in want.items()}


def test_quality_tools_run_on_the_cpu(capsys):
    q = quality_onchip.main(["--device", "cpu", "--steps", "4", "--turbo"])
    assert set(q["tiers"]) == {"per-beam", "per-beam-pack8", "turbo-g8"}
    p = proto_phase_quality.main(["--device", "cpu", "--steps", "4",
                                  "--agents", "2"])
    assert set(p["tiers"]) == {"static", "rot"}
    for v in list(q["tiers"].values()) + list(p["tiers"].values()):
        assert 0 < v["iou"] <= 1 and v["exact_free"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("exact tier:")
    assert sum(x.startswith(("static:", "rot:")) for x in lines) == 2


def test_profile_step_prints_every_row(capsys):
    res = profile_step.main(["--device", "cpu", "--agents", "8", "--inner",
                             "2", "--reps", "1"])
    out = capsys.readouterr().out
    assert len(res["rows"]) == 18 and res["split"] is None
    for row, v in res["rows"].items():
        assert row in out and v["device_ms"] is None and v["host_ms"] > 0
    assert "FULL sim_step" in res["rows"]
    n = res["launches"]
    assert n["steps"] == profile_step.LAUNCH_STEPS and n["ops"] > 0 and \
        n["device"] is None and "torch ops dispatched" in out


def test_roofline_refuses_the_cpu():
    with pytest.raises(ValueError, match="measures the card"):
        roofline.main(["--device", "cpu"])


def test_roofline_bound_arithmetic():
    """The bound of chip_smoke.py's records: bytes at 3.35 TB/s against
    operations at 67 TFLOP/s; the needed bytes; the probe's plain chain
    on the CPU is its own version."""
    assert roofline.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
    assert roofline.needed_bytes(4, 100, 10, 7) == 447
    x = torch.linspace(0.0, 1.0, 64).reshape(8, roofline.CHAINS)
    y = roofline.probe_chain(x, 50)
    want = x.clone()
    for _ in range(50):
        want = torch.where(want > 0.5, want * 0.99999, want + 1e-6)
    assert torch.equal(y, want) and roofline.probe_chain.launches == 0


def test_quality_world_is_the_tools():
    """quality_onchip's world (presets.coverage(4, scan_rays=61)) with each
    tier's replacements equals tools/quality_onchip.py's `run` config."""
    from __graft_entry__ import _cfg_and_world
    for use_pallas, patch in [(False, {"raster_4way": False})] + [
            (True, p) for _, p in quality_onchip.TIERS +
            (quality_onchip.TURBO,)]:
        cfg_j = _cfg_and_world(4, frontiers=False, parity=False,
                               raster_mode="beam", use_pallas=use_pallas,
                               scan_rays=61, tiled=True)[0]
        cfg_j = cfg_j.replace(engine=dataclasses.replace(cfg_j.engine,
                                                         **patch))
        cfg = presets.coverage(4, False, "cpu", scan_rays=61)[0]
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, use_pallas=use_pallas, **patch))
        assert cfg == convert.config_from(cfg_j)
