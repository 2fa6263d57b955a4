"""The scan-matched closures (swarm_tpu_torch/slam/closurematch.py and the
`closure_scanmatch` branches of slam/closure.py) against the JAX package's,
on the CPU, at small windows (48 inner cells, a search of 8) and 61-beam
sweeps of a 3 m room. At 61 beams the endpoints are too sparse for the
engine's fitness gate of 0.6 (a lone endpoint's bilinear splat caps its own
inlier fraction near 0.4), so the gate here is 0.45: some pairs pass it and
some do not.

Inputs are made from a seed with numpy (sweeps cast by the JAX
`sense_scan_true`) and fed to the jitted JAX function and to the port, each
JAX function compiled once per module. Bars: the splat exact (its inputs on
a 1/8-cell lattice, so every sum is exact in any order); `ok` and
`distinct` exact; fitness, rotations and everything else within 1e-4;
translations (ddx, ddy and the measurement's x, y) within 5e-4 m, a
hundredth of a cell: the matmul and convolution sums run in another order
than XLA's, and on a near-symmetric score peak the parabolic sub-cell
refinement divides their last-bit difference by a small curvature
(measured: 1.7e-4 m on one pair of the "measured" case, rotations and
fitness within 4e-6); the chunked batch equal to the one-call batch.
`closure_add_poses_batch` with scan matching, the rendezvous radius and a
pair budget, over a sequence of batches from the same state on both sides:
every `ClosureState` leaf, integers exact and floats within 1e-4, in cases
with tied pair distances (the reference's `top_k` takes the lower index
first), with fewer pair candidates than the budget, with no closure and
with no pair.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import GridConfig as JGrid
from swarm_tpu.config import SensorConfig as JSens
from swarm_tpu.config import SlamConfig as JSlam
from swarm_tpu.models.scan import sense_scan_true
from swarm_tpu.slam import closure as jcl
from swarm_tpu.slam import closurematch as jcm
from swarm_tpu_torch import convert
from swarm_tpu_torch.slam import closure as pcl
from swarm_tpu_torch.slam import closurematch as pcm
from tests.torch_parity import assert_close, assert_exact, t

R = 61
ROOM = np.asarray([[0.0, 0.0, 3.0, 0.0], [3.0, 0.0, 3.0, 3.0],
                   [3.0, 3.0, 0.0, 3.0], [0.0, 3.0, 0.0, 0.0],
                   [1.8, 0.0, 1.8, 1.0], [0.0, 2.2, 0.9, 2.2]], np.float32)
GRID = dict(size=256, origin_x=-3.0, origin_y=-3.0)
SLAM = dict(closure_scanmatch=True, closure_match_window=48,
            closure_match_search=8, closure_match_angles=7,
            closure_match_chunk=2, closure_match_budget=3,
            closure_same_agent_only=True, min_poses_between=2,
            closure_cross_radius_m=1.2, closure_pair_budget=3,
            closure_pair_cooldown=4, merge_fitness_min=0.45)
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_T = dict(rtol=0.0, atol=5e-4)      # translations, metres


def _cfgs(**slam):
    """(JAX slam, grid, sens), (port slam, grid, sens)."""
    kw = dict(SLAM, **slam)
    j = (JSlam(**kw), JGrid(**GRID), JSens())
    return j, tuple(convert.config_from(c, type_) for c, type_ in zip(
        j, (pcl.SlamConfig, pcm.GridConfig, pcm.SensorConfig)))


@functools.lru_cache(maxsize=None)
def _scan_fn():
    return jax.jit(jax.vmap(lambda p: sense_scan_true(p, jnp.asarray(ROOM),
                                                      R)))


def scans_at(poses):
    """Noise-free sweeps [N, R] at true poses [N, 3] (numpy)."""
    return np.asarray(_scan_fn()(jnp.asarray(poses, jnp.float32)))


@functools.lru_cache(maxsize=None)
def _jax_pairs(margin: float, chunk: int):
    (slam, grid, sens), _ = _cfgs(merge_distinct_margin=margin,
                                  closure_match_chunk=chunk)

    def run(cd, cp, sd, sp):
        return jcm.match_scan_pairs_batch(cd, cp, sd, sp, slam, grid, sens)
    return jax.jit(run)


def _pairs(seed, m):
    """m (current, stored) pairs in the room: current estimates carry an
    injected pose error; numpy (cur_dist, cur_pose, stored_dist,
    stored_pose)."""
    rng = np.random.default_rng(seed)
    stored = np.stack([rng.uniform(0.6, 2.4, m), rng.uniform(0.4, 2.0, m),
                       rng.uniform(-np.pi, np.pi, m)], -1).astype(np.float32)
    cur = stored + np.stack([rng.uniform(-0.1, 0.1, m),
                             rng.uniform(-0.1, 0.1, m),
                             rng.uniform(-0.05, 0.05, m)], -1)
    err = np.stack([rng.uniform(-0.1, 0.1, m), rng.uniform(-0.1, 0.1, m),
                    rng.uniform(-0.03, 0.03, m)], -1)
    cur_est = (cur + err).astype(np.float32)
    return (scans_at(cur), tuple(cur_est.T), scans_at(stored),
            tuple(stored.T))


def test_splat_points_window_exact():
    rng = np.random.default_rng(0)
    side, p = 24, 50
    px = (rng.integers(-16, 8 * side + 16, (3, p)) / 8.0).astype(np.float32)
    py = (rng.integers(-16, 8 * side + 16, (3, p)) / 8.0).astype(np.float32)
    valid = rng.random((3, p)) < 0.8
    ref = jax.jit(jax.vmap(functools.partial(jcm.splat_points_window,
                                             side=side)))(px, py, valid)
    got = pcm.splat_points_window(t(px), t(py), t(valid), side)
    assert_exact(got, ref)
    assert_exact(pcm.splat_points_window(t(px[0]), t(py[0]), t(valid[0]),
                                         side), np.asarray(ref)[0])
    assert float(got.sum()) > 0


@pytest.mark.parametrize("margin", [0.0, 0.05])
def test_match_scan_pairs_match_jax(margin):
    cd, cp, sd, sp = _pairs(1, 6)
    mj, meas_j = _jax_pairs(margin, 8)(cd, cp, sd, sp)
    _, (slam, grid, sens) = _cfgs(merge_distinct_margin=margin,
                                  closure_match_chunk=8)
    mp, meas_p = pcm.match_scan_pairs_batch(
        t(cd), tuple(t(x) for x in cp), t(sd), tuple(t(x) for x in sp),
        slam, grid, sens)
    assert_exact(mp.ok, mj.ok, "ok")
    assert_exact(mp.distinct, mj.distinct, "distinct")
    for f in ("fitness", "ddtheta"):
        assert_close(getattr(mp, f), getattr(mj, f), **TOL, what=f)
    for f in ("ddx", "ddy"):
        assert_close(getattr(mp, f), getattr(mj, f), **TOL_T, what=f)
    assert_close(meas_p[:, :2], np.asarray(meas_j)[:, :2], **TOL_T)
    assert_close(meas_p[:, 2], np.asarray(meas_j)[:, 2], **TOL)
    assert bool(mp.ok.any())
    # one pair through match_scan_pair equals its batch row
    m1, meas1 = pcm.match_scan_pair(t(cd[2]), tuple(float(x[2]) for x in cp),
                                    t(sd[2]), tuple(float(x[2]) for x in sp),
                                    slam, grid, sens)
    assert_close(meas1, meas_p[2], rtol=0, atol=1e-6)
    assert bool(m1.ok) == bool(mp.ok[2])


def test_chunked_batch_equals_one_call():
    """M = 5 pairs in chunks of 2 (one padded chunk) against the same
    pairs in one call, and against the JAX chunked batch."""
    cd, cp, sd, sp = _pairs(2, 5)
    args = (t(cd), tuple(t(x) for x in cp), t(sd), tuple(t(x) for x in sp))
    _, (slam, grid, sens) = _cfgs()
    m2, meas2 = pcm.match_scan_pairs_batch(*args, slam, grid, sens)
    m8, meas8 = pcm.match_scan_pairs_batch(
        *args, dataclasses.replace(slam, closure_match_chunk=8), grid, sens)
    for a, b in zip(m2, m8):
        assert_close(a, b, rtol=0, atol=1e-6)
    assert_close(meas2, meas8, rtol=0, atol=1e-6)
    mj, meas_j = _jax_pairs(0.0, 2)(cd, cp, sd, sp)
    assert_exact(m2.ok, mj.ok)
    assert_close(meas2[:, :2], np.asarray(meas_j)[:, :2], **TOL_T)
    assert_close(meas2[:, 2], np.asarray(meas_j)[:, 2], **TOL)


# --------------------------------------------------------------------------
# closure_add_poses_batch with scan matching


def _jax_batch(case):
    """The jitted JAX closure batch of a case, compiled once per
    configuration (cases with the same SlamConfig share it)."""
    return _jax_batch_of(tuple(sorted(CASES[case][1].items())))


@functools.lru_cache(maxsize=None)
def _jax_batch_of(slam_kw):
    (slam, grid, sens), _ = _cfgs(**dict(slam_kw))

    def run(st, x, y, a, lm, v, yw, sc):
        return jcl.closure_add_poses_batch(st, x, y, a, lm, slam, valid=v,
                                           yaws=yw, scans=sc, grid=grid,
                                           sens=sens)
    return jax.jit(run)


def _batches_default():
    """Six agents over four batches: landmarks stored, then revisits near
    their own (intra closures, measured) and other agents' landmarks
    (rendezvous), agents 0-2 within the cross radius of each other (pairs),
    agent 5 dead in the last batch."""
    rng = np.random.default_rng(7)
    base = np.array([[0.7, 0.6], [1.1, 0.8], [0.9, 1.3], [2.4, 2.5],
                     [2.5, 0.5], [0.5, 2.6]], np.float32)
    out = []
    for k in range(4):
        jit = rng.uniform(-0.08, 0.08, base.shape).astype(np.float32)
        xy = base + jit
        yaw = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
        lm = np.array([5, 3, 0, 5, 2, 3], np.int32) if k in (0, 2, 3) \
            else np.zeros(6, np.int32)
        valid = np.ones(6, bool)
        if k == 3:
            valid[5] = False
        out.append((xy, yaw, lm, valid))
    return out


def _batches_ties():
    """Agent 0 at the centre of agents 1-4, all 0.5 m away (exactly
    representable): ten candidate pairs, six tied at 0.25 m^2, budget 3."""
    xy = np.array([[1.0, 1.0], [1.5, 1.0], [1.0, 1.5], [0.5, 1.0],
                   [1.0, 0.5], [2.5, 2.5]], np.float32)
    yaw = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 2.5], np.float32)
    return [(xy, yaw, np.zeros(6, np.int32), np.ones(6, bool))] * 2


def _batches_few():
    """One pair within the radius (fewer candidates than the budget)."""
    xy = np.array([[0.6, 0.6], [1.2, 0.7], [2.5, 2.5], [2.5, 0.4],
                   [0.4, 2.6], [1.6, 2.6]], np.float32)
    yaw = np.linspace(-2, 2, 6).astype(np.float32)
    lm = np.array([5, 0, 0, 0, 0, 0], np.int32)
    return [(xy, yaw, lm, np.ones(6, bool))] * 3


def _batches_far():
    """Agents far apart with nothing in reach: no closure, no pair."""
    xy = np.array([[0.4, 0.4], [2.6, 0.4], [0.4, 2.6], [2.6, 2.6],
                   [1.5, 1.5], [2.0, 1.6]], np.float32) * \
        np.array([1.0, 1.0], np.float32)
    xy[4:] += np.array([[8.0, 8.0], [14.0, 2.0]], np.float32)
    yaw = np.zeros(6, np.float32)
    lm = np.array([5, 3, 2, 4, 1, 6], np.int32)
    return [(xy, yaw, lm, np.ones(6, bool))] * 3


# name -> (batches, SlamConfig replacements, expected (closures, pairs))
CASES = {
    "measured": (_batches_default, {}, (True, True)),
    "ties": (_batches_ties, {}, (False, True)),
    "few-candidates": (_batches_few, dict(min_poses_between=4),
                       (True, True)),
    "no-closure-no-pair": (_batches_far, dict(min_poses_between=100),
                           (False, False)),
    "no-pair-budget": (_batches_default, dict(closure_pair_budget=0),
                       (True, False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_closure_batch_with_scanmatch_matches_jax(case):
    batches, slam_kw, (want_cl, want_pair) = CASES[case]
    _, (slam, grid, sens) = _cfgs(**slam_kw)
    n = 6
    st_j = jcl.closure_init(n, _cfgs(**slam_kw)[0][0], scan_rays=R)
    st_p = convert.to_torch(st_j, pcl.ClosureState)
    fn = _jax_batch(case)
    agents = np.arange(n, dtype=np.int32)
    closed_any = False
    for k, (xy, yaw, lm, valid) in enumerate(batches()):
        sc = scans_at(np.concatenate([xy, yaw[:, None]], -1))
        st_j, cj, dxj, dyj = fn(st_j, xy[:, 0], xy[:, 1], agents, lm, valid,
                                yaw, sc)
        st_p, cp, dxp, dyp = pcl.closure_add_poses_batch(
            st_p, t(xy[:, 0]), t(xy[:, 1]), t(agents), t(lm), slam,
            valid=t(valid), yaws=t(yaw), scans=t(sc), grid=grid, sens=sens)
        assert_exact(cp, cj, f"batch {k} closed")
        assert_close(dxp, dxj, **TOL_T)
        assert_close(dyp, dyj, **TOL_T)
        closed_any |= bool(np.asarray(cj).any())
        for f in pcl.ClosureState._fields:
            a, b = getattr(st_p, f), getattr(st_j, f)
            if a.dtype.is_floating_point:
                assert_close(a, b, **(TOL_T if f in ("cl_mx", "cl_my")
                                      else TOL), what=f"batch {k} {f}")
            else:
                assert_exact(a, b, what=f"batch {k} {f}")
    c = int(st_p.cl_count)
    attempted = bool((st_p.last_pair_node >= 0).any())
    assert closed_any == want_cl, case
    assert attempted == want_pair, case
    if case == "measured":
        assert int((st_p.cl_fit[:c] >= 0).sum()) > 0
        assert int((st_p.lm_scan != 0).any(dim=1).sum()) > 0


def test_closure_ring_sized_and_seq_form_takes_the_flag():
    """closure_init sizes lm_scan [L, R] with scan matching; the sequential
    (parity) form accepts the flag and stores no sweep, as the reference's
    parity step passes none."""
    _, (slam, grid, sens) = _cfgs()
    st = pcl.closure_init(4, slam, scan_rays=R, device="cpu")
    assert tuple(st.lm_scan.shape) == (slam.landmark_capacity, R)
    xs = torch.tensor([0.5, 1.0, 1.5, 2.0])
    st2, closed, _, _ = pcl.closure_add_poses_seq(
        st, xs, xs, torch.arange(4, dtype=torch.int32),
        torch.tensor([5, 0, 3, 0], dtype=torch.int32), slam)
    assert int(st2.lm_count) == 2 and not bool(closed.any())
    assert torch.equal(st2.lm_scan, st.lm_scan)
    assert torch.equal(st2.lm_yaw, torch.zeros_like(st2.lm_yaw))


@pytest.mark.parametrize("missing", ["grid", "sens"])
def test_closure_batch_with_scans_needs_grid_and_sens(missing):
    """Sweeps given with scan matching on but no grid or sensor config:
    the batch raises rather than log the closures unmeasured."""
    _, (slam, grid, sens) = _cfgs()
    st = pcl.closure_init(2, slam, scan_rays=R, device="cpu")
    xs = torch.tensor([0.5, 1.0])
    kw = dict(grid=grid, sens=sens)
    kw[missing] = None
    with pytest.raises(ValueError, match="grid and sens"):
        pcl.closure_add_poses_batch(
            st, xs, xs, torch.arange(2, dtype=torch.int32),
            torch.tensor([5, 0], dtype=torch.int32), slam,
            yaws=torch.zeros(2), scans=torch.ones((2, R)), **kw)
