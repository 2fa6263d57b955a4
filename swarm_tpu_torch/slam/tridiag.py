"""Structure-exploiting pose-graph Gauss-Newton (swarm_tpu/slam/tridiag.py).

A trajectory graph's Hessian is a block-tridiagonal chain (odometry edges
couple consecutive poses) plus a low-rank update from the closure edges:
  * the chain solves by block cyclic reduction: log2(M) levels, each a
    batched sweep of 3x3 inversions and [3, K] products over the remaining
    blocks (`block_tridiag_solve`);
  * the closures fold in by the Woodbury identity,
    (T + U S U^T)^-1 b = T^-1 b - T^-1 U (S^-1 + U^T T^-1 U)^-1 U^T T^-1 b,
    one chain solve with 3C + 1 right-hand sides and one dense (3C, 3C)
    solve (`solve_chain_plus_closures`).
The gradient is summed per node in edge order on every device
(`posegraph.solve_plans`, ROADMAP C43); the closure factor's writes name
no entry twice, and the chain blocks add each node once.
`structured_gn` rejects a step whose cost is not finite or rises past 2.5x
and escalates the damping 10x, as the reference does. The solver runs on a
batch of graphs (a leading [B] axis, the reference's `jax.vmap`), each with
its own damping and step guard; a single graph is a batch of one.

A singular block or capacitance matrix gives NaN, as JAX's `inv` and
`solve` give non-finite values there: `inv_ex` and `solve_ex` report the
failure instead of raising, and the result is NaN where they do, so the
step guard sees a non-finite cost.
"""

from __future__ import annotations

import torch

from swarm_tpu_torch.slam.posegraph import (PoseGraph, _blk, _gradient,
                                            _residuals_and_jac, _unary_cost,
                                            batched, solve_plans,
                                            unary_terms, unbatched)
from swarm_tpu_torch.utils.angles import wrap_pi


def _nan_where(x, info):
    """x with NaN in every matrix whose factorisation failed (info != 0)."""
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _inv(a):
    inv, info = torch.linalg.inv_ex(a)
    return _nan_where(inv, info)


def _solve(a, b):
    x, info = torch.linalg.solve_ex(a, b)
    return _nan_where(x, info)


def _pad_pow2(x, m_pad: int, fill):
    """x [..., m, a, b] padded along the block axis to m_pad with `fill`."""
    pad = m_pad - x.shape[-3]
    if pad == 0:
        return x
    return torch.cat([x, fill.expand(x.shape[:-3] + (pad,) + x.shape[-2:])],
                     dim=-3)


def _shift(x):
    """x [..., s, a, b] moved one block down, a zero block first: entry t
    holds block t - 1."""
    return torch.cat([torch.zeros_like(x[..., :1, :, :]), x[..., :-1, :, :]],
                     dim=-3)


def block_tridiag_solve(D, O, F):
    """Solve the symmetric block-tridiagonal system T X = F by cyclic
    reduction. D [..., M, 3, 3] diagonal blocks, O [..., M-1, 3, 3]
    super-diagonal blocks (sub-diagonal = O^T), F [..., M, 3, K]. Returns X
    [..., M, 3, K]; leading batch axes are independent systems. M is
    padded to a power of two with identity blocks (decoupled x = 0)."""
    m = D.shape[-3]
    dtype, dev = D.dtype, D.device
    m_pad = 1 << max(1, (m - 1).bit_length())
    z33 = torch.zeros((3, 3), dtype=dtype, device=dev)
    zb = torch.zeros_like(O[..., :1, :, :])
    D = _pad_pow2(D, m_pad, torch.eye(3, dtype=dtype, device=dev))
    L = _pad_pow2(torch.cat([zb, O.transpose(-1, -2)], dim=-3), m_pad, z33)
    U = _pad_pow2(torch.cat([O, zb], dim=-3), m_pad, z33)
    F = _pad_pow2(F, m_pad, F.new_zeros(F.shape[-2:]))

    levels = []
    while D.shape[-3] > 1:
        De, Do = D[..., 0::2, :, :], D[..., 1::2, :, :]
        Le, Lo = L[..., 0::2, :, :], L[..., 1::2, :, :]
        Ue, Uo = U[..., 0::2, :, :], U[..., 1::2, :, :]
        Fe, Fo = F[..., 0::2, :, :], F[..., 1::2, :, :]
        levels.append((Do, Lo, Uo, Fo))
        Do_inv = _inv(Do)
        # neighbours of even index 2t: odd 2t-1 = odds[t-1], odd 2t+1 =
        # odds[t]
        Dm_inv, Lm, Um, Fm = (_shift(v) for v in (Do_inv, Lo, Uo, Fo))
        a = Le @ Dm_inv
        c = Ue @ Do_inv
        D = De - a @ Um - c @ Lo
        L = -(a @ Lm)
        U = -(c @ Uo)
        F = Fe - a @ Fm - c @ Fo

    x = _solve(D, F)
    for Do, Lo, Uo, Fo in reversed(levels):
        x_next = torch.cat([x[..., 1:, :, :], torch.zeros_like(
            x[..., :1, :, :])], dim=-3)
        rhs = Fo - Lo @ x - Uo @ x_next
        x_odd = _solve(Do, rhs)
        x = torch.stack([x, x_odd], dim=-3).flatten(-4, -3)
    return x[..., :m, :, :]


def solve_chain_plus_closures(D, O, b, U=None, s_inv=None):
    """Solve (T + U S U^T) dx = -b: T block-tridiagonal (D, O), closures the
    low-rank term (U [..., M, 3, 3C] scattered closure Jacobians, s_inv
    [..., 3C] inverse weights). Returns dx [..., M, 3]."""
    if U is None:
        return block_tridiag_solve(D, O, -b[..., None])[..., 0]
    rhs = torch.cat([-b[..., None], U], dim=-1)
    Y = block_tridiag_solve(D, O, rhs)                   # [..., M, 3, 1+3C]
    y_b, Y_u = Y[..., 0], Y[..., 1:]
    cap = torch.diag_embed(s_inv) + torch.einsum("...mak,...mac->...kc",
                                                 U, Y_u)
    cap = 0.5 * (cap + cap.transpose(-1, -2))
    uty_b = torch.einsum("...mak,...ma->...k", U, y_b)
    corr = _solve(cap, uty_b[..., None])[..., 0]
    return y_b - torch.einsum("...mak,...k->...ma", Y_u, corr)


def structured_gn(g: PoseGraph, n_chain: int, iterations: int = 10,
                  damping: float = 1e-3, anchor_weight: float = 1e6,
                  anchor_nodes=None, unary=None):
    """Gauss-Newton on a trajectory graph (`graph_from_trajectory`'s
    layout: the first `n_chain` = M - 1 edges are the chain, the rest
    closures), the step guard of the reference (a step whose cost is not
    finite or exceeds 2.5x the old cost + 1e-6 is rejected and the damping
    escalated 10x; an accepted step resets it). anchor_nodes: nodes pinned
    with `anchor_weight` (default node 0). unary: optional absolute pose
    factors (`posegraph.unary_terms`), folded into the diagonal blocks.
    Returns (graph with the optimised poses, costs [iterations])."""
    if unary is not None:
        unary = tuple(u[None] for u in unary)
    out, costs = _structured_gn_batch(batched(g), n_chain, iterations,
                                      damping, anchor_weight, anchor_nodes,
                                      unary)
    return unbatched(out), costs[0]


def _chain_system(Ji, Jj, wc, m: int):
    """The chain edges' block-tridiagonal (D [B, M, 3, 3], O [B, M-1, 3,
    3]) from their Jacobians [B, M-1, 3, 3] and weights [B, M-1, 3]."""
    D = torch.zeros(Ji.shape[:-3] + (m, 3, 3), dtype=Ji.dtype,
                    device=Ji.device)
    D[..., :-1, :, :] += _blk(Ji, Ji, wc)
    D[..., 1:, :, :] += _blk(Jj, Jj, wc)
    return D, _blk(Ji, Jj, wc)


def _closure_factor(Ji, Jj, ci, cj, live, m: int):
    """The closures' low-rank factor U [B, M, 3, 3C]: each closure's
    Jacobian blocks, transposed, at its two nodes; a component that is not
    live (an invalid closure, a zero weight) is a zero column."""
    nb, c = ci.shape
    dev = Ji.device
    cm = live[..., None, :]
    zero = torch.zeros((), dtype=Ji.dtype, device=dev)
    JiT = torch.where(cm, Ji.transpose(-1, -2), zero)
    JjT = torch.where(cm, Jj.transpose(-1, -2), zero)
    U = torch.zeros((nb, m, 3, c, 3), dtype=Ji.dtype, device=dev)
    k3 = torch.arange(3, device=dev)
    bi = torch.arange(nb, device=dev)[:, None, None, None]
    ar_c = torch.arange(c, device=dev)[None, :, None, None]
    idx_a, idx_b = k3[None, None, :, None], k3[None, None, None, :]
    U.index_put_((bi, ci[..., None, None], idx_a, ar_c, idx_b), JiT,
                 accumulate=True)
    U.index_put_((bi, cj[..., None, None], idx_a, ar_c, idx_b), JjT,
                 accumulate=True)
    return U.reshape(nb, m, 3, 3 * c)


def _structured_gn_batch(g: PoseGraph, n_chain: int, iterations: int,
                         damping: float, anchor_weight: float = 1e6,
                         anchor_nodes=None, unary=None):
    """`structured_gn` over a batch of graphs [B, ...] as one program: each
    graph keeps its own damping, its own step guard and its own NaN."""
    nb, m = g.poses.shape[:2]
    assert n_chain == m - 1, "chain edges must be the first m-1 edges"
    c = g.ei.shape[-1] - n_chain
    dtype, dev = g.poses.dtype, g.poses.device
    wmask_all = torch.where(g.e_valid[..., None], g.weight,
                            torch.zeros_like(g.weight))
    eye = torch.eye(3, dtype=dtype, device=dev)
    anchors = (torch.zeros((1,), dtype=torch.int64, device=dev)
               if anchor_nodes is None
               else torch.as_tensor(anchor_nodes, device=dev).long())
    pin = torch.zeros((m,), dtype=dtype, device=dev).index_add(
        0, anchors, torch.full(anchors.shape, anchor_weight, dtype=dtype,
                               device=dev))
    ci, cj = g.ei[:, n_chain:].long(), g.ej[:, n_chain:].long()

    def cost_at(poses):
        r, _, _ = _residuals_and_jac(g._replace(poses=poses))
        cost = (wmask_all * r * r).sum(dim=(-2, -1))
        if unary is not None:
            cost = cost + _unary_cost(poses, unary)
        return cost

    if c > 0:
        cw = wmask_all[:, n_chain:]                            # [B, C, 3]
        # a valid closure's zero-weight component contributes nothing:
        # zero U column, unit s_inv
        live = g.e_valid[:, n_chain:, None] & (cw > 0)
        s_inv = torch.where(live, 1.0 / torch.clamp_min(cw, 1e-12),
                            torch.ones_like(cw)).reshape(nb, -1)

    plans = solve_plans(g, unary)
    poses = g.poses
    lam = torch.full((nb,), damping, dtype=dtype, device=dev)
    costs = []
    for _ in range(iterations):
        gg = g._replace(poses=poses)
        r, Ji, Jj = _residuals_and_jac(gg)
        wr = wmask_all * r
        b = _gradient(gg, Ji, Jj, wr, plans["b"])
        u_cost = 0.0
        if unary is not None:
            b_add, d_add, u_cost = unary_terms(poses, unary, plans["unary"])
            b = b + b_add

        D, O = _chain_system(Ji[:, :n_chain], Jj[:, :n_chain],
                             wmask_all[:, :n_chain], m)
        diag = torch.ones((nb, m), dtype=dtype, device=dev) * \
            lam[:, None] + pin
        D = D + diag[..., None, None] * eye
        if unary is not None:
            D = D + d_add[..., None] * eye

        if c > 0:
            U = _closure_factor(Ji[:, n_chain:], Jj[:, n_chain:], ci, cj,
                                live, m)
            dx = solve_chain_plus_closures(D, O, b, U, s_inv)
        else:
            dx = solve_chain_plus_closures(D, O, b)

        new = poses + dx
        new = torch.cat([new[..., :2], wrap_pi(new[..., 2:])], dim=-1)
        cost_old = (wr * r).sum(dim=(-2, -1)) + u_cost
        cost_new = cost_at(new)
        ok = torch.isfinite(cost_new) & (cost_new <= cost_old * 2.5 + 1e-6)
        poses = torch.where(ok[:, None, None], new, poses)
        lam = torch.where(ok, torch.full_like(lam, damping), lam * 10.0)
        costs.append(cost_old)
    return g._replace(poses=poses), torch.stack(costs, dim=-1)


def structured_gn_batch(graphs: PoseGraph, n_chain: int,
                        iterations: int = 10, damping: float = 1e-3):
    """`structured_gn` over a batch of graphs (leading axis on every leaf)
    as one batched program, as the reference's `jax.vmap` is. Returns
    (graphs, costs [B, iterations])."""
    return _structured_gn_batch(graphs, n_chain, iterations, damping)
