"""2-D pose-graph optimisation by dense Gauss-Newton
(swarm_tpu/slam/posegraph.py).

A graph is fixed-capacity: poses [M, 3], odometry edges between consecutive
poses and closure edges, each with a relative measurement in frame i and
per-component weights, masked by `e_valid`. The normal equations are
assembled densely ([3M, 3M]) by index-accumulated blocks and solved by a
Cholesky factorisation; node 0 is anchored and a Levenberg damping term
pins the padding nodes. The reference's `lax.scan` over iterations is a
Python loop. Its vmap over graphs is a leading [B] axis: the solver runs
on a batch, one [B, 3M, 3M] Hessian and one batched factorisation per
iteration, and a single graph is a batch of one.

A factorisation that fails gives NaN, as JAX's does: `cholesky_ex` reports
the failure instead of raising, and that graph's update is NaN.

Residual model for edge (i, j) with measurement (dx, dy, dth) in frame i:
    r_t = R(th_i)^T (p_j - p_i) - (dx, dy)
    r_th = wrap(th_j - th_i - dth)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from swarm_tpu_torch.utils.angles import wrap_pi


class PoseGraph(NamedTuple):
    """Fixed-capacity graph. Poses [M, 3]; edges (i, j, meas, weight,
    valid)."""
    poses: torch.Tensor      # [M, 3] (x, y, theta) current estimates
    n_poses: torch.Tensor    # [] int32
    ei: torch.Tensor         # [E] int32 source node
    ej: torch.Tensor         # [E] int32 target node
    meas: torch.Tensor       # [E, 3] relative (dx, dy, dtheta) in frame i
    weight: torch.Tensor     # [E, 3] per-component information weights
    e_valid: torch.Tensor    # [E] bool


def graph_from_trajectory(poses, n_poses, closures_i, closures_j,
                          closure_meas, n_closures,
                          odom_weight=(1.0, 1.0, 1.0),
                          closure_weight=(10.0, 10.0, 10.0)) -> PoseGraph:
    """A trajectory's graph: consecutive odometry edges measured from the
    CURRENT estimates, then the closure edges with `closure_meas` [C, 3].
    The first M - 1 edges are the chain (the layout `tridiag.structured_gn`
    needs)."""
    dev = poses.device
    m = poses.shape[0]
    c = closures_i.shape[0]
    idx = torch.arange(m - 1, device=dev)
    n_poses = torch.as_tensor(n_poses, dtype=torch.int32, device=dev)
    odo_valid = idx + 1 < n_poses
    ri, rj = poses[:-1], poses[1:]
    ct, st = torch.cos(ri[:, 2]), torch.sin(ri[:, 2])
    dxw = rj[:, 0] - ri[:, 0]
    dyw = rj[:, 1] - ri[:, 1]
    odo_meas = torch.stack([ct * dxw + st * dyw, -st * dxw + ct * dyw,
                            wrap_pi(rj[:, 2] - ri[:, 2])], dim=-1)
    cl_valid = torch.arange(c, device=dev) < n_closures
    i32 = torch.int32
    ei = torch.cat([idx.to(i32), closures_i.to(i32)])
    ej = torch.cat([(idx + 1).to(i32), closures_j.to(i32)])
    meas = torch.cat([odo_meas, closure_meas.to(poses.dtype)])
    w = torch.cat([
        torch.tensor(odom_weight, dtype=poses.dtype,
                     device=dev).expand(m - 1, 3),
        torch.tensor(closure_weight, dtype=poses.dtype,
                     device=dev).expand(c, 3)])
    return PoseGraph(poses=poses, n_poses=n_poses, ei=ei, ej=ej, meas=meas,
                     weight=w, e_valid=torch.cat([odo_valid, cl_valid]))


def _take(p, idx):
    """Rows `idx` [..., E] of p [..., M, 3] -> [..., E, 3]."""
    return torch.take_along_dim(p, idx.long()[..., None], dim=-2)


def _scatter_rows(like, idx, src):
    """A zero [..., M, 3] like `like` with src [..., E, 3] added at rows
    idx [..., E] (in index order on the CPU)."""
    return torch.zeros_like(like).scatter_add_(
        -2, idx.long()[..., None].expand(src.shape), src)


def _residuals_and_jac(g: PoseGraph):
    """Per-edge residuals [..., E, 3] and the two Jacobian blocks
    [..., E, 3, 3]; leading batch axes on every leaf pass through."""
    pi = _take(g.poses, g.ei)
    pj = _take(g.poses, g.ej)
    ct, st = torch.cos(pi[..., 2]), torch.sin(pi[..., 2])
    dx = pj[..., 0] - pi[..., 0]
    dy = pj[..., 1] - pi[..., 1]
    r = torch.stack([ct * dx + st * dy - g.meas[..., 0],
                     -st * dx + ct * dy - g.meas[..., 1],
                     wrap_pi(pj[..., 2] - pi[..., 2] - g.meas[..., 2])],
                    dim=-1)
    zeros = torch.zeros_like(ct)
    ones = torch.ones_like(ct)
    Ji = torch.stack([
        torch.stack([-ct, -st, -st * dx + ct * dy], -1),
        torch.stack([st, -ct, -ct * dx - st * dy], -1),
        torch.stack([zeros, zeros, -ones], -1)], dim=-2)
    Jj = torch.stack([
        torch.stack([ct, st, zeros], -1),
        torch.stack([-st, ct, zeros], -1),
        torch.stack([zeros, zeros, ones], -1)], dim=-2)
    return r, Ji, Jj


def unary_terms(poses, unary):
    """Absolute pose factors (nodes [..., Q], meas [..., Q, 3], weight
    [..., Q, 3]): r = p_q - z_q, J = I. Returns (b_add [..., M, 3], d_add
    [..., M, 3] diagonal, cost [...]). Zero weight disables a slot."""
    nodes, meas, w = unary
    p = _take(poses, nodes)
    r = torch.stack([p[..., 0] - meas[..., 0], p[..., 1] - meas[..., 1],
                     wrap_pi(p[..., 2] - meas[..., 2])], dim=-1)
    wr = w * r
    return (_scatter_rows(poses, nodes, wr),
            _scatter_rows(poses, nodes, w.expand(wr.shape)),
            (wr * r).sum(dim=(-2, -1)))


def _gradient(g: PoseGraph, Ji, Jj, wr):
    """b = J^T W r, scattered per node [..., M, 3]."""
    bi = torch.einsum("...eab,...ea->...eb", Ji, wr)
    bj = torch.einsum("...eab,...ea->...eb", Jj, wr)
    return _scatter_rows(g.poses, g.ei, bi).scatter_add_(
        -2, g.ej.long()[..., None].expand(bj.shape), bj)


def _blk(Ja, Jb, w):
    """Per-edge Ja^T W Jb [..., E, 3, 3]."""
    return torch.einsum("...eab,...ea,...eac->...ebc", Ja, w, Jb)


def _add_blocks(H, a, b, blocks):
    """H [B, 3M, 3M] += each block [B, E, 3, 3] at rows 3a.., cols 3b..
    of its own graph."""
    k = torch.arange(3, device=H.device)
    rows = (3 * a.long()[..., None, None] + k[:, None]).expand_as(blocks)
    cols = (3 * b.long()[..., None, None] + k[None, :]).expand_as(blocks)
    bi = torch.arange(H.shape[0], device=H.device)[:, None, None, None]
    H.index_put_((bi.expand_as(blocks).reshape(-1), rows.reshape(-1),
                  cols.reshape(-1)), blocks.reshape(-1), accumulate=True)


def _cholesky_solve_nan(H, rhs):
    """Solve H x = rhs for SPD H [.., n, n], rhs [.., n, k] by Cholesky;
    where the factorisation of a matrix fails its result is NaN (JAX's
    `solve(..., assume_a="pos")` gives NaN there; `torch.linalg.cholesky`
    would raise)."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(rhs, L)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def batched(g: PoseGraph) -> PoseGraph:
    """One graph as a batch of one (a leading axis on every leaf)."""
    return PoseGraph(*(f[None] for f in g))


def unbatched(g: PoseGraph) -> PoseGraph:
    """The only graph of a batch of one."""
    return PoseGraph(*(f[0] for f in g))


def gauss_newton(g: PoseGraph, iterations: int = 10, damping: float = 1e-3,
                 anchor_weight: float = 1e6, unary=None):
    """Dense GN. Node 0 anchored with `anchor_weight`, Levenberg damping on
    every node; `unary` optional absolute pose factors (`unary_terms`).
    Returns (graph with the optimised poses, costs [iterations]: each
    iteration's cost before its update)."""
    if unary is not None:
        unary = tuple(u[None] for u in unary)
    out, costs = _gauss_newton_batch(batched(g), iterations, damping,
                                     anchor_weight, unary)
    return unbatched(out), costs[0]


def _gauss_newton_batch(g: PoseGraph, iterations: int, damping: float,
                        anchor_weight: float = 1e6, unary=None):
    """Dense GN over a batch of graphs [B, ...]: one [B, 3M, 3M] Hessian
    and one batched Cholesky per iteration. A graph whose factorisation
    fails gets NaN in its own update only."""
    nb, m = g.poses.shape[:2]
    dtype, dev = g.poses.dtype, g.poses.device
    wmask = torch.where(g.e_valid[..., None], g.weight,
                        torch.zeros_like(g.weight))
    diag = torch.full((3 * m,), damping, dtype=dtype, device=dev)
    diag[:3] += anchor_weight
    poses = g.poses
    costs = []
    for _ in range(iterations):
        gg = g._replace(poses=poses)
        r, Ji, Jj = _residuals_and_jac(gg)
        wr = wmask * r
        b = _gradient(gg, Ji, Jj, wr)
        u_cost = 0.0
        d = diag
        if unary is not None:
            b_add, d_add, u_cost = unary_terms(poses, unary)
            b = b + b_add
            d = diag + d_add.reshape(nb, -1)
        H = torch.zeros((nb, 3 * m, 3 * m), dtype=dtype, device=dev)
        Hij = _blk(Ji, Jj, wmask)
        _add_blocks(H, g.ei, g.ei, _blk(Ji, Ji, wmask))
        _add_blocks(H, g.ej, g.ej, _blk(Jj, Jj, wmask))
        _add_blocks(H, g.ei, g.ej, Hij)
        _add_blocks(H, g.ej, g.ei, Hij.transpose(-1, -2))
        H = H + torch.diag_embed(d.expand(nb, 3 * m))
        dx = _cholesky_solve_nan(H, -b.reshape(nb, -1, 1)).reshape(nb, m, 3)
        new = poses + dx
        poses = torch.cat([new[..., :2], wrap_pi(new[..., 2:])], dim=-1)
        costs.append((wr * r).sum(dim=(-2, -1)) + u_cost)
    return g._replace(poses=poses), torch.stack(costs, dim=-1)


def optimize_graphs_batch(graphs: PoseGraph, iterations: int = 10,
                          damping: float = 1e-3):
    """`gauss_newton` over a batch of graphs (leading axis on every leaf) as
    one batched program, as the reference's `jax.vmap` is. Returns
    (graphs, costs [B, iterations])."""
    return _gauss_newton_batch(graphs, iterations, damping)
