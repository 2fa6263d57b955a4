"""Pose-graph solving over the ranks (swarm_tpu/parallel/solve.py) —
BASELINE configs[4]: a 1024-agent swarm with pose-graph optimisation.

Two decompositions:
  * `make_sharded_solver`: the per-agent graphs are independent solves, so
    each rank takes its contiguous rows of the [N] graphs (`shard_graphs`)
    and solves them as one batch (slam/posegraph's dense GN or
    slam/tridiag's structured GN); only the summed final costs cross the
    ranks, in one all-reduce (the reference's `psum`);
  * `make_trajectory_sharded_gn`: ONE long trajectory graph. Each rank
    builds the block-tridiagonal normal equations (D, O, b) of its
    contiguous chunk of chain edges, and one all-reduce completes them;
    the closures' low-rank term and the structured solve run replicated on
    every rank, with the reference's step guard and damping escalation.

The collectives go through the default process group (`parallel.mesh.init`),
whose size and rank say how the rows and the chain are split.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from swarm_tpu_torch.parallel.mesh import RankLayout
from swarm_tpu_torch.slam.posegraph import (PoseGraph, _blk,
                                            _gauss_newton_batch,
                                            _residuals_and_jac, add_plans,
                                            plan_add)
from swarm_tpu_torch.slam.tridiag import (_closure_factor,
                                          _structured_gn_batch,
                                          solve_chain_plus_closures)
from swarm_tpu_torch.utils.angles import wrap_pi


def _psum(x):
    """The sum of `x` over the ranks (a new tensor)."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def make_sharded_solver(layout: RankLayout, iterations: int = 10,
                        damping: float = 1e-3, structured: bool = False,
                        n_chain: int | None = None):
    """Returns solve(graphs) for this rank's rows of the [N] graphs
    (`shard_graphs`): (graphs with the optimised poses, costs [N / world,
    iterations], the final costs summed over every rank's graphs).

    structured=True uses the chain + closures solver (slam/tridiag.py)
    instead of the dense Cholesky; it needs `graph_from_trajectory`'s edge
    layout and `n_chain`."""
    del layout          # the default group carries the ranks

    def solve(graphs: PoseGraph):
        if structured:
            out, costs = _structured_gn_batch(graphs, n_chain, iterations,
                                              damping)
        else:
            out, costs = _gauss_newton_batch(graphs, iterations, damping)
        return out, costs, _psum(costs[:, -1].sum())

    return solve


def make_trajectory_sharded_gn(layout: RankLayout, n_chain: int,
                               iterations: int = 10, damping: float = 1e-3,
                               anchor_weight: float = 1e6):
    """Sequence-parallel Gauss-Newton over ONE trajectory graph
    (`graph_from_trajectory`'s layout, the same graph on every rank).
    Rank r builds the normal equations of chain edges [r * chunk, (r + 1) *
    chunk); one all-reduce of (D, O, b, cost) completes them each
    iteration, and one more sums the chain cost of the proposed step.
    Returns solve(graph) -> (graph, costs [iterations])."""
    world, rank = layout.world, layout.rank
    if n_chain % world:
        raise ValueError(f"n_chain={n_chain} not divisible by {world} ranks")
    chunk = n_chain // world
    e0 = rank * chunk

    def solve(g: PoseGraph):
        m = g.poses.shape[0]
        c = g.ei.shape[0] - n_chain
        dtype, dev = g.poses.dtype, g.poses.device
        eye = torch.eye(3, dtype=dtype, device=dev)

        def local(x):
            return torch.cat([x[e0:e0 + chunk], x[n_chain:]])

        g_loc = g._replace(ei=local(g.ei), ej=local(g.ej),
                           meas=local(g.meas), weight=local(g.weight),
                           e_valid=local(g.e_valid))
        wmask = torch.where(g_loc.e_valid[:, None], g_loc.weight,
                            torch.zeros_like(g_loc.weight))
        ei_c, ej_c = g_loc.ei[:chunk].long(), g_loc.ej[:chunk].long()
        ci, cj = g.ei[n_chain:].long(), g.ej[n_chain:].long()
        wc, wcl = wmask[:chunk], wmask[chunk:]
        if c > 0:
            # a valid closure's zero-weight component contributes nothing
            live = g.e_valid[n_chain:, None] & (wcl > 0)
            s_inv = torch.where(live, 1.0 / torch.clamp_min(wcl, 1e-12),
                                torch.ones_like(wcl)).reshape(-1)
            # the closures' gradient: each node's terms summed in closure
            # order on every device (ROADMAP C43), one plan for the solve
            cl_plan = add_plans((torch.cat([ci, cj]), 2 * c))[0]

        def cost_at(poses):
            r2, _, _ = _residuals_and_jac(g_loc._replace(poses=poses))
            wr2 = wmask * r2 * r2
            return _psum(wr2[:chunk].sum()) + wr2[chunk:].sum()

        poses = g.poses
        lam = torch.tensor(damping, dtype=dtype, device=dev)
        costs = []
        for _ in range(iterations):
            r, Ji, Jj = _residuals_and_jac(g_loc._replace(poses=poses))
            rc = r[:chunk]
            Jic, Jjc = Ji[:chunk], Jj[:chunk]
            wr = wc * rc
            b = torch.zeros((m, 3), dtype=dtype, device=dev).index_add_(
                0, ei_c, torch.einsum("eab,ea->eb", Jic, wr)).index_add_(
                0, ej_c, torch.einsum("eab,ea->eb", Jjc, wr))
            D = torch.zeros((m, 3, 3), dtype=dtype, device=dev).index_add_(
                0, ei_c, _blk(Jic, Jic, wc)).index_add_(
                0, ej_c, _blk(Jjc, Jjc, wc))
            O = torch.zeros((m - 1, 3, 3), dtype=dtype,
                            device=dev).index_add_(0, ei_c,
                                                   _blk(Jic, Jjc, wc))
            # one all-reduce completes the normal equations
            flat = _psum(torch.cat([D.reshape(-1), O.reshape(-1),
                                    b.reshape(-1), (wr * rc).sum()[None]]))
            D = flat[:9 * m].reshape(m, 3, 3)
            O = flat[9 * m:9 * (2 * m - 1)].reshape(m - 1, 3, 3)
            b = flat[9 * (2 * m - 1):-1].reshape(m, 3)
            cost = flat[-1]

            diag = torch.ones((m,), dtype=dtype, device=dev) * lam
            diag[0] += anchor_weight
            D = D + diag[:, None, None] * eye
            if c > 0:
                # closures: the replicated low-rank term and its gradient
                rcl, Jicl, Jjcl = r[chunk:], Ji[chunk:], Jj[chunk:]
                b = plan_add(b.clone(), cl_plan, torch.cat([
                    torch.einsum("eab,ea->eb", Jicl, wcl * rcl),
                    torch.einsum("eab,ea->eb", Jjcl, wcl * rcl)]))
                cost = cost + (wcl * rcl * rcl).sum()
                U = _closure_factor(Jicl[None], Jjcl[None], ci[None],
                                    cj[None], live[None], m)[0]
                dx = solve_chain_plus_closures(D, O, b, U, s_inv)
            else:
                dx = solve_chain_plus_closures(D, O, b)

            new = poses + dx
            new = torch.cat([new[:, :2], wrap_pi(new[:, 2:])], dim=1)
            # the step guard and damping escalation of slam/tridiag
            cost_new = cost_at(new)
            ok = torch.isfinite(cost_new) & (cost_new <= cost * 2.5 + 1e-6)
            poses = torch.where(ok, new, poses)
            lam = torch.where(ok, torch.full_like(lam, damping), lam * 10.0)
            costs.append(cost)
        return g._replace(poses=poses), torch.stack(costs)

    return solve


def shard_graphs(graphs: PoseGraph, layout: RankLayout) -> PoseGraph:
    """This rank's contiguous rows of the [N] graphs (N divisible by the
    world size), on its device."""
    n = graphs.poses.shape[0]
    if n % layout.world:
        raise ValueError(f"{n} graphs do not split over {layout.world} "
                         "ranks")
    k = n // layout.world
    lo = layout.rank * k
    return PoseGraph(*(f[lo:lo + k].to(layout.device) for f in graphs))
