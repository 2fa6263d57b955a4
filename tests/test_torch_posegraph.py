"""The pose-graph solvers (swarm_tpu_torch/slam/posegraph.py, tridiag.py)
against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and fed to the jitted JAX function
and to the port. Graph leaves, residuals and Jacobians at 1e-5; the
solvers' poses at atol 1e-3 and their costs at rtol 1e-3 (the JAX package's
own structured-against-dense bar, tests/test_tridiag.py:62-64: the anchor
weight 1e6 and the damping 1e-3 in float32 let LAPACK's last bits grow over
the iterations; the costs of the middle iterations, after the first step's
overshoot, differ by up to ~1%). A graph whose solves fail (an unanchored
padding block at zero damping: a singular block, a non-PD Hessian) gives
NaN on both sides where JAX gives it, and the structured solver's step
guard rejects the same steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.slam import posegraph as jpg
from swarm_tpu.slam import tridiag as jtd
from swarm_tpu_torch.slam import posegraph as ppg
from swarm_tpu_torch.slam import tridiag as ptd
from tests.torch_parity import assert_close, t
from tests.torch_parity import torch_one_thread  # noqa: F401

POSE_ATOL = 1e-3
COST_RTOL = 1e-3


def _loop(seed, m, n_poses=None, n_closures=3, cap=4, zero_theta=False):
    """A noisy loop trajectory of m nodes (n_poses live) with closure
    edges: numpy arrays (poses, n_poses, ci, cj, cmeas, n_closures)."""
    rng = np.random.default_rng(seed)
    n_poses = m if n_poses is None else n_poses
    s = np.linspace(0, 4 * np.pi, m)
    truth = np.stack([np.cos(s), np.sin(s), s + np.pi / 2], -1)
    noisy = (truth + 0.05 * rng.normal(size=truth.shape)).astype(np.float32)
    noisy[0] = truth[0]
    ci = np.zeros(cap, np.int32)
    cj = np.zeros(cap, np.int32)
    ci[:n_closures] = rng.integers(n_poses // 2, n_poses - 1, n_closures)
    cj[:n_closures] = rng.integers(1, max(2, n_poses // 4), n_closures)
    cmeas = (0.02 * rng.normal(size=(cap, 3))).astype(np.float32)
    return noisy, n_poses, ci, cj, cmeas, n_closures


def _graphs(args, closure_weight=(10.0, 10.0, 10.0)):
    poses, n_poses, ci, cj, cmeas, nc = args
    gj = jpg.graph_from_trajectory(jnp.asarray(poses), n_poses,
                                   jnp.asarray(ci), jnp.asarray(cj),
                                   jnp.asarray(cmeas), nc,
                                   closure_weight=closure_weight)
    gp = ppg.graph_from_trajectory(t(poses), n_poses, t(ci), t(cj), t(cmeas),
                                   nc, closure_weight=closure_weight)
    return gj, gp


def _unary(seed, m, q=6):
    rng = np.random.default_rng(seed + 100)
    nodes = rng.integers(0, m, q).astype(np.int32)
    nodes[-1] = nodes[0]                  # a repeated node
    meas = rng.normal(size=(q, 3)).astype(np.float32)
    w = np.tile(np.array([25.0, 25.0, 4.0], np.float32), (q, 1))
    w[1] = 0.0                            # a disabled slot
    return nodes, meas, w


@functools.lru_cache(maxsize=None)
def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


def test_graph_residuals_and_unary_terms():
    gj, gp = _graphs(_loop(0, 24, n_poses=20))
    for f in jpg.PoseGraph._fields:
        assert_close(getattr(gp, f), getattr(gj, f), what=f)
    for a, b in zip(ppg._residuals_and_jac(gp),
                    jax.jit(jpg._residuals_and_jac)(gj)):
        assert_close(a, b)
    un = _unary(0, 24)
    for a, b in zip(ppg.unary_terms(gp.poses, tuple(t(x) for x in un)),
                    jax.jit(jpg.unary_terms)(gj.poses, un)):
        assert_close(a, b)


@pytest.mark.parametrize("unary", [False, True])
def test_gauss_newton_matches_jax(unary):
    gj, gp = _graphs(_loop(1, 40, n_poses=33))
    un = _unary(1, 40) if unary else None
    oj, cj = _jit(jpg.gauss_newton, iterations=8)(gj, unary=un)
    op, cp = ppg.gauss_newton(gp, iterations=8, unary=None if un is None
                              else tuple(t(x) for x in un))
    assert_close(op.poses, oj.poses, rtol=0, atol=POSE_ATOL)
    assert_close(cp[..., -1], cj[..., -1], rtol=COST_RTOL, atol=1e-6)


def test_optimize_graphs_batch_matches_jax():
    pairs = [_graphs(_loop(s, 16)) for s in range(3)]
    gj = jax.tree.map(lambda *x: jnp.stack(x), *[p[0] for p in pairs])
    gp = ppg.PoseGraph(*(torch.stack(f) for f in
                         zip(*[p[1] for p in pairs])))
    oj, cj = jax.jit(functools.partial(jpg.optimize_graphs_batch,
                                       iterations=5))(gj)
    op, cp = ppg.optimize_graphs_batch(gp, iterations=5)
    assert_close(op.poses, oj.poses, rtol=0, atol=POSE_ATOL)
    assert_close(cp[..., -1], cj[..., -1], rtol=COST_RTOL, atol=1e-6)


@pytest.mark.parametrize("m", [3, 8, 17, 64])
def test_block_tridiag_solve_matches_jax(m):
    rng = np.random.default_rng(m)
    D = rng.normal(size=(m, 3, 3)).astype(np.float32)
    D = np.einsum("mab,mcb->mac", D, D) + 3 * np.eye(3, dtype=np.float32)
    O = (0.3 * rng.normal(size=(m - 1, 3, 3))).astype(np.float32)
    F = rng.normal(size=(m, 3, 5)).astype(np.float32)
    xj = jax.jit(jtd.block_tridiag_solve)(D, O, F)
    xp = ptd.block_tridiag_solve(t(D), t(O), t(F))
    assert_close(xp, xj, rtol=1e-4, atol=1e-5)
    # the Woodbury fold against the JAX one
    U = rng.normal(size=(m, 3, 6)).astype(np.float32)
    s_inv = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    b = rng.normal(size=(m, 3)).astype(np.float32)
    dj = jax.jit(jtd.solve_chain_plus_closures)(D, O, b, U, s_inv)
    dp = ptd.solve_chain_plus_closures(t(D), t(O), t(b), t(U), t(s_inv))
    assert_close(dp, dj, rtol=1e-4, atol=1e-5)


# (closure weight, anchor nodes, unary) per case
STRUCTURED = {
    "closures": ((10.0, 10.0, 10.0), None, False),
    "zero-theta-weight": ((4.0, 4.0, 0.0), None, False),
    "anchors-unary": ((4.0, 4.0, 0.0), (0, 16), True),
}


@pytest.mark.parametrize("case", list(STRUCTURED))
def test_structured_gn_matches_jax(case):
    cw, anchors, unary = STRUCTURED[case]
    gj, gp = _graphs(_loop(2, 32, n_poses=29), closure_weight=cw)
    un = _unary(2, 32) if unary else None
    oj, cj = _jit(jtd.structured_gn, n_chain=31, iterations=8,
                  anchor_nodes=anchors)(gj, unary=un)
    op, cp = ptd.structured_gn(gp, n_chain=31, iterations=8,
                               anchor_nodes=anchors,
                               unary=None if un is None
                               else tuple(t(x) for x in un))
    assert_close(op.poses, oj.poses, rtol=0, atol=POSE_ATOL)
    assert_close(cp[..., -1], cj[..., -1], rtol=COST_RTOL, atol=1e-6)


def test_structured_gn_batch_matches_jax():
    pairs = [_graphs(_loop(s, 16, n_closures=2)) for s in range(3)]
    gj = jax.tree.map(lambda *x: jnp.stack(x), *[p[0] for p in pairs])
    gp = ppg.PoseGraph(*(torch.stack(f) for f in
                         zip(*[p[1] for p in pairs])))
    oj, cj = jax.jit(functools.partial(jtd.structured_gn_batch, n_chain=15,
                                       iterations=5))(gj)
    op, cp = ptd.structured_gn_batch(gp, n_chain=15, iterations=5)
    assert_close(op.poses, oj.poses, rtol=0, atol=POSE_ATOL)
    assert_close(cp[..., -1], cj[..., -1], rtol=COST_RTOL, atol=1e-6)


def test_failing_solves_flow_nan_and_guard_rejects_as_jax():
    """Zero damping and an unanchored, edge-free padding tail: the dense
    Hessian is not positive definite and a padding block is singular.
    The dense solver's poses go NaN on both sides (`cholesky_ex`, not a
    raise); every structured step is non-finite and rejected on both
    sides, so the poses stay the input's and the costs agree."""
    gj, gp = _graphs(_loop(3, 16, n_poses=12))
    oj, cj = _jit(jpg.gauss_newton, iterations=3, damping=0.0)(gj)
    op, cp = ppg.gauss_newton(gp, iterations=3, damping=0.0)
    assert np.isnan(np.asarray(oj.poses)).any()
    np.testing.assert_array_equal(np.isnan(op.poses.numpy()),
                                  np.isnan(np.asarray(oj.poses)))
    sj, scj = _jit(jtd.structured_gn, n_chain=15, iterations=4,
                   damping=0.0)(gj)
    sp, scp = ptd.structured_gn(gp, n_chain=15, iterations=4, damping=0.0)
    assert_close(sp.poses, sj.poses, rtol=0, atol=0)
    assert_close(sp.poses, gp.poses, rtol=0, atol=0)
    assert_close(scp, scj, rtol=COST_RTOL, atol=1e-6)
    # the singular block itself: NaN from the port, non-finite from JAX
    d = np.zeros((4, 3, 3), np.float32)
    o = np.zeros((3, 3, 3), np.float32)
    f = np.ones((4, 3, 1), np.float32)
    assert not np.isfinite(np.asarray(jtd.block_tridiag_solve(d, o, f))).all()
    assert torch.isnan(ptd.block_tridiag_solve(t(d), t(o), t(f))).all()
