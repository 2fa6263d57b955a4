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

The normal equations are summed in a fixed order on every device: each
node's (or block's) contributions are added in edge order, as the CPU's
sequential scatter-add adds them, so a solve is the same from run to run
on the card and bit-equal to the CPU's assembly (a float atomic add would
sum a node's edges in no fixed order; ROADMAP C43). The order is an
`AddPlan`: the contributions sorted by target, then dealt into layers in
which no target repeats, so that each layer is one `index_add_` that adds
every target at most once. The edge indices do not change across
iterations, so a solve builds its plans once, with one host read for the
layer bounds, and reuses them in every iteration.

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


class AddPlan(NamedTuple):
    """The order in which `plan_add` sums contributions into rows: slot k
    adds contribution `src[k]` to row `dst[k]`; the slots of one layer,
    `layers[l]` = (lo, hi), name no row twice, and a row's contributions
    fall in successive layers in their given order."""
    src: torch.Tensor     # [K] int64 contribution index, layer by layer
    dst: torch.Tensor     # [K] int64 its row
    layers: tuple         # ((lo, hi), ...) host ints


def _layer_order(keys, max_depth: int):
    """(src, dst, bounds [max_depth + 1]) of the plan for row keys [K]."""
    dev = keys.device
    sk, perm = torch.sort(keys, stable=True)
    pos = torch.arange(keys.numel(), device=dev)
    first = torch.ones(keys.numel(), dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    sr, order = torch.sort(rank, stable=True)
    bounds = torch.searchsorted(sr, torch.arange(max_depth + 1, device=dev))
    return perm[order], sk[order], bounds


def add_plans(*specs):
    """One AddPlan per (keys [K] int64, max_depth): contribution k adds to
    row keys[k], in the given order per row; max_depth bounds the most
    contributions of one row. The layer bounds of all plans come to the
    host in one read."""
    parts = [_layer_order(keys, depth) for keys, depth in specs]
    bounds = torch.cat([b for _, _, b in parts]).tolist() if parts else []
    plans, at = [], 0
    for (src, dst, _), (keys, depth) in zip(parts, specs):
        b = bounds[at:at + depth + 1]
        at += depth + 1
        if b[-1] != keys.numel():
            raise ValueError(f"a row has more than {depth} contributions")
        plans.append(AddPlan(src, dst, tuple(
            (lo, hi) for lo, hi in zip(b[:-1], b[1:]) if hi > lo)))
    return plans


def plan_add(out, plan: AddPlan, src):
    """out [T, ...] with src [K, ...] added at its plan's rows, IN PLACE,
    layer by layer: each row's contributions in their given order, on any
    device (one add per row in a layer, so an atomic add is exact).
    Returns out."""
    for lo, hi in plan.layers:
        out.index_add_(0, plan.dst[lo:hi],
                       src.index_select(0, plan.src[lo:hi]))
    return out


def _row_keys(idx, m: int):
    """Rows idx [..., E] of graphs [..., M, .] as flat row keys of the
    batch: graph g's row i is g * M + i."""
    lead = idx.shape[:-1]
    base = torch.arange(idx[..., 0].numel(), device=idx.device)
    return base.reshape(lead + (1,)) * m + idx.long()


def _plan_rows(like, plan: AddPlan, src):
    """A zero [..., M, 3] like `like` with src [..., E, 3] added by `plan`
    (keys from `_row_keys`)."""
    out = torch.zeros((like[..., 0].numel(), 3), dtype=like.dtype,
                      device=like.device)
    return plan_add(out, plan, src.reshape(-1, 3)).reshape(like.shape)


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


def _unary_residuals(poses, unary):
    """(w r, r) [..., Q, 3] of the absolute pose factors."""
    nodes, meas, w = unary
    p = _take(poses, nodes)
    r = torch.stack([p[..., 0] - meas[..., 0], p[..., 1] - meas[..., 1],
                     wrap_pi(p[..., 2] - meas[..., 2])], dim=-1)
    return w * r, r


def _unary_cost(poses, unary):
    wr, r = _unary_residuals(poses, unary)
    return (wr * r).sum(dim=(-2, -1))


def _unary_keys(poses, unary):
    """`unary_terms`' plan spec: each factor's node, in slot order."""
    nodes = unary[0]
    return _row_keys(nodes, poses.shape[-2]).reshape(-1), nodes.shape[-1]


def unary_terms(poses, unary, plan: AddPlan | None = None):
    """Absolute pose factors (nodes [..., Q], meas [..., Q, 3], weight
    [..., Q, 3]): r = p_q - z_q, J = I. Returns (b_add [..., M, 3], d_add
    [..., M, 3] diagonal, cost [...]). Zero weight disables a slot. Each
    node's factors are summed in slot order by `plan` (`solve_plans`'
    "unary", built here when none is given)."""
    wr, r = _unary_residuals(poses, unary)
    if plan is None:
        plan = add_plans(_unary_keys(poses, unary))[0]
    return (_plan_rows(poses, plan, wr),
            _plan_rows(poses, plan, unary[2].expand(wr.shape)),
            (wr * r).sum(dim=(-2, -1)))


def _gradient_keys(g: PoseGraph):
    """`_gradient`'s plan spec: every edge's source node in edge order,
    then every edge's target node."""
    m, e = g.poses.shape[-2], g.ei.shape[-1]
    return torch.cat([_row_keys(g.ei, m).reshape(-1),
                      _row_keys(g.ej, m).reshape(-1)]), 2 * e


def _gradient(g: PoseGraph, Ji, Jj, wr, plan: AddPlan):
    """b = J^T W r, summed per node [..., M, 3] in `_gradient_keys`'
    order."""
    bi = torch.einsum("...eab,...ea->...eb", Ji, wr)
    bj = torch.einsum("...eab,...ea->...eb", Jj, wr)
    return _plan_rows(g.poses, plan, torch.cat([bi.reshape(-1, 3),
                                                bj.reshape(-1, 3)]))


def _blk(Ja, Jb, w):
    """Per-edge Ja^T W Jb [..., E, 3, 3]."""
    return torch.einsum("...eab,...ea,...eac->...ebc", Ja, w, Jb)


def _hessian_keys(g: PoseGraph):
    """`_hessian`'s plan spec over a batch [B] of graphs: the (i, i)
    blocks of every edge in edge order, then the (j, j), the (i, j) and
    the (j, i) blocks; block (a, c) of graph b is row (b M + a) M + c."""
    m, e = g.poses.shape[-2], g.ei.shape[-1]
    ki, kj = _row_keys(g.ei, m) * m, _row_keys(g.ej, m) * m
    ei, ej = g.ei.long(), g.ej.long()
    return torch.cat([k.reshape(-1) for k in (ki + ei, kj + ej, ki + ej,
                                              kj + ei)]), 4 * e


def _hessian(g: PoseGraph, Ji, Jj, wmask, plan: AddPlan):
    """H [B, 3M, 3M] = sum over edges of the blocks J^T W J at their node
    pairs, each block summed in `_hessian_keys`' order."""
    Hij = _blk(Ji, Jj, wmask)
    return _sum_blocks(g.poses, plan, (_blk(Ji, Ji, wmask),
                                       _blk(Jj, Jj, wmask), Hij,
                                       Hij.transpose(-1, -2)))


def _sum_blocks(poses, plan: AddPlan, blocks):
    """The [B, 3M, 3M] sum of the (i, i), (j, j), (i, j) and (j, i)
    blocks [B, E, 3, 3] of every edge, by `plan` (`_hessian_keys`)."""
    nb, m = poses.shape[:2]
    src = torch.cat([x.reshape(-1, 3, 3) for x in blocks])
    H = torch.zeros((nb * m * m, 3, 3), dtype=src.dtype, device=src.device)
    plan_add(H, plan, src)
    return H.reshape(nb, m, m, 3, 3).permute(0, 1, 3, 2, 4).reshape(
        nb, 3 * m, 3 * m)


def solve_plans(g: PoseGraph, unary=None, hessian: bool = False) -> dict:
    """The AddPlans of one solve, built together with one host read: "b"
    (`_gradient`), "H" with `hessian` (`_hessian`) and "unary" with unary
    factors (`unary_terms`)."""
    specs = {"b": _gradient_keys(g)}
    if hessian:
        specs["H"] = _hessian_keys(g)
    if unary is not None:
        specs["unary"] = _unary_keys(g.poses, unary)
    return dict(zip(specs, add_plans(*specs.values())))


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
    plans = solve_plans(g, unary, hessian=True)
    poses = g.poses
    costs = []
    for _ in range(iterations):
        gg = g._replace(poses=poses)
        r, Ji, Jj = _residuals_and_jac(gg)
        wr = wmask * r
        b = _gradient(gg, Ji, Jj, wr, plans["b"])
        u_cost = 0.0
        d = diag
        if unary is not None:
            b_add, d_add, u_cost = unary_terms(poses, unary, plans["unary"])
            b = b + b_add
            d = diag + d_add.reshape(nb, -1)
        H = _hessian(gg, Ji, Jj, wmask, plans["H"]) + \
            torch.diag_embed(d.expand(nb, 3 * m))
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
