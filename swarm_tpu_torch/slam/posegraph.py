"""2-D pose-graph optimisation by dense Gauss-Newton
(swarm_tpu/slam/posegraph.py).

A graph is fixed-capacity: poses [M, 3], odometry edges between consecutive
poses and closure edges, each with a relative measurement in frame i and
per-component weights, masked by `e_valid`. The normal equations are
assembled densely ([3M, 3M]) by index-accumulated blocks and solved by a
Cholesky factorisation; node 0 is anchored and a Levenberg damping term
pins the padding nodes. The reference's `lax.scan` over iterations is a
Python loop, its vmap over graphs a loop over the batch.

A factorisation that fails gives NaN, as JAX's does: `cholesky_ex` reports
the failure instead of raising, and the step's update is NaN there.

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


def _residuals_and_jac(g: PoseGraph):
    """Per-edge residuals [E, 3] and the two Jacobian blocks [E, 3, 3]."""
    pi = g.poses[g.ei.long()]
    pj = g.poses[g.ej.long()]
    ct, st = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    r = torch.stack([ct * dx + st * dy - g.meas[:, 0],
                     -st * dx + ct * dy - g.meas[:, 1],
                     wrap_pi(pj[:, 2] - pi[:, 2] - g.meas[:, 2])], dim=-1)
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
    """Absolute pose factors (nodes [Q], meas [Q, 3], weight [Q, 3]):
    r = p_q - z_q, J = I. Returns (b_add [M, 3], d_add [M, 3] diagonal,
    cost). Zero weight disables a slot."""
    nodes, meas, w = unary
    nodes = nodes.long()
    p = poses[nodes]
    r = torch.stack([p[:, 0] - meas[:, 0], p[:, 1] - meas[:, 1],
                     wrap_pi(p[:, 2] - meas[:, 2])], dim=-1)
    wr = w * r
    b_add = torch.zeros_like(poses).index_add_(0, nodes, wr)
    d_add = torch.zeros_like(poses).index_add_(0, nodes, w)
    return b_add, d_add, (wr * r).sum()


def _gradient(g: PoseGraph, Ji, Jj, wr):
    """b = J^T W r, scattered per node [M, 3]."""
    bi = torch.einsum("eab,ea->eb", Ji, wr)
    bj = torch.einsum("eab,ea->eb", Jj, wr)
    return torch.zeros_like(g.poses).index_add_(0, g.ei.long(), bi) \
        .index_add_(0, g.ej.long(), bj)


def _blk(Ja, Jb, w):
    """Per-edge Ja^T W Jb [E, 3, 3]."""
    return torch.einsum("eab,ea,eac->ebc", Ja, w, Jb)


def _add_blocks(H, a, b, blocks):
    """H [3M, 3M] += each block [E, 3, 3] at rows 3a.., cols 3b.."""
    k = torch.arange(3, device=H.device)
    rows = (3 * a.long()[:, None, None] + k[None, :, None]).expand_as(blocks)
    cols = (3 * b.long()[:, None, None] + k[None, None, :]).expand_as(blocks)
    H.index_put_((rows.reshape(-1), cols.reshape(-1)), blocks.reshape(-1),
                 accumulate=True)


def _cholesky_solve_nan(H, rhs):
    """Solve H x = rhs for SPD H [.., n, n], rhs [.., n, k] by Cholesky;
    where the factorisation fails the result is NaN (JAX's `solve(...,
    assume_a="pos")` gives NaN there; `torch.linalg.cholesky` would
    raise)."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(rhs, L)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def gauss_newton(g: PoseGraph, iterations: int = 10, damping: float = 1e-3,
                 anchor_weight: float = 1e6, unary=None):
    """Dense GN. Node 0 anchored with `anchor_weight`, Levenberg damping on
    every node; `unary` optional absolute pose factors (`unary_terms`).
    Returns (graph with the optimised poses, costs [iterations]: each
    iteration's cost before its update)."""
    m = g.poses.shape[0]
    wmask = torch.where(g.e_valid[:, None], g.weight,
                        torch.zeros_like(g.weight))
    poses = g.poses
    costs = []
    for _ in range(iterations):
        gg = g._replace(poses=poses)
        r, Ji, Jj = _residuals_and_jac(gg)
        wr = wmask * r
        b = _gradient(gg, Ji, Jj, wr)
        u_cost = 0.0
        if unary is not None:
            b_add, d_add, u_cost = unary_terms(poses, unary)
            b = b + b_add
        H = torch.zeros((3 * m, 3 * m), dtype=poses.dtype,
                        device=poses.device)
        Hij = _blk(Ji, Jj, wmask)
        _add_blocks(H, g.ei, g.ei, _blk(Ji, Ji, wmask))
        _add_blocks(H, g.ej, g.ej, _blk(Jj, Jj, wmask))
        _add_blocks(H, g.ei, g.ej, Hij)
        _add_blocks(H, g.ej, g.ei, Hij.transpose(-1, -2))
        diag = torch.full((3 * m,), damping, dtype=poses.dtype,
                          device=poses.device)
        diag[:3] += anchor_weight
        if unary is not None:
            diag = diag + d_add.reshape(-1)
        H = H + torch.diag(diag)
        dx = _cholesky_solve_nan(H, -b.reshape(-1, 1)).reshape(m, 3)
        new = poses + dx
        poses = torch.cat([new[:, :2], wrap_pi(new[:, 2:])], dim=1)
        costs.append((wr * r).sum() + u_cost)
    return g._replace(poses=poses), torch.stack(costs)


def optimize_graphs_batch(graphs: PoseGraph, iterations: int = 10,
                          damping: float = 1e-3):
    """`gauss_newton` over a batch of graphs (leading axis on every leaf),
    one graph after another. Returns (graphs, costs [B, iterations])."""
    outs = [gauss_newton(PoseGraph(*(f[b] for f in graphs)), iterations,
                         damping) for b in range(graphs.poses.shape[0])]
    return (PoseGraph(*(torch.stack(f) for f in zip(*(o[0] for o in outs)))),
            torch.stack([o[1] for o in outs]))
