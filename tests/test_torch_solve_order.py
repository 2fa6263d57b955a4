"""The pose-graph solvers' normal equations summed in a fixed order
(swarm_tpu_torch/slam/posegraph.py `AddPlan`, ROADMAP C43), on the CPU.

The solvers used to assemble b, H and the unary terms with `scatter_add_`
and `index_put_(accumulate=True)`, which add in index order on the CPU and,
on a card, in no fixed order wherever a node carries several edges. The
plans add each node's contributions in that same index order on every
device. Here the plans' assembly is held BIT-EQUAL (a -0.0 against a +0.0
counts) to the former scatter-add assembly, reproduced below, on graphs
where one node carries many closures, one by one and as a batch; and the
solves on such a graph are held against the JAX package's at the solvers'
bars (tests/test_torch_posegraph.py: poses atol 1e-3, final costs rtol
1e-3).
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
M, C, Q = 32, 12, 8
PILE = 9          # the node that closes with many others


def _pileup(seed, m=M, c=C):
    """A noisy loop of m nodes whose closures mostly start at one node
    (PILE), two of them between the same pair, one invalid (beyond
    n_closures), and odometry edges past n_poses invalid: numpy
    (poses, n_poses, ci, cj, cmeas, n_closures)."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0, 4 * np.pi, m)
    truth = np.stack([np.cos(s), np.sin(s), s + np.pi / 2], -1)
    noisy = (truth + 0.05 * rng.normal(size=truth.shape)).astype(np.float32)
    noisy[0] = truth[0]
    n_poses = m - 2
    ci = np.full(c, PILE, np.int32)
    ci[-3:] = rng.integers(n_poses // 2, n_poses - 1, 3)
    cj = rng.integers(n_poses // 2, n_poses - 1, c).astype(np.int32)
    cj[1] = cj[0]                        # the same pair twice
    cj[4] = PILE + 1                     # a closure onto a chain neighbour
    cmeas = (0.02 * rng.normal(size=(c, 3))).astype(np.float32)
    return noisy, n_poses, ci, cj, cmeas, c - 1


def _unary(seed, m=M, q=Q):
    rng = np.random.default_rng(seed + 100)
    nodes = rng.integers(0, m, q).astype(np.int32)
    nodes[:3] = PILE                     # one node observed three times
    meas = rng.normal(size=(q, 3)).astype(np.float32)
    w = rng.uniform(1.0, 25.0, size=(q, 3)).astype(np.float32)
    w[4] = 0.0                           # a disabled slot
    return nodes, meas, w


def _port_graph(args):
    poses, n_poses, ci, cj, cmeas, nc = args
    return ppg.graph_from_trajectory(t(poses), n_poses, t(ci), t(cj),
                                     t(cmeas), nc)


def _batch(n):
    """n pile-up graphs stacked on a leading [B] axis, and their unary
    factors."""
    graphs = [_port_graph(_pileup(s)) for s in range(n)]
    g = ppg.PoseGraph(*(torch.stack(f) for f in zip(*graphs)))
    un = [_unary(s) for s in range(n)]
    return g, tuple(torch.stack([t(u[k]) for u in un]) for k in range(3))


# --- the former assembly (the scatter-add form the plans replaced) --------

def _former_rows(like, idx, src):
    return torch.zeros_like(like).scatter_add_(
        -2, idx.long()[..., None].expand(src.shape), src)


def _former_gradient(g, Ji, Jj, wr):
    bi = torch.einsum("...eab,...ea->...eb", Ji, wr)
    bj = torch.einsum("...eab,...ea->...eb", Jj, wr)
    return _former_rows(g.poses, g.ei, bi).scatter_add_(
        -2, g.ej.long()[..., None].expand(bj.shape), bj)


def _former_add_blocks(H, a, b, blocks):
    k = torch.arange(3)
    rows = (3 * a.long()[..., None, None] + k[:, None]).expand_as(blocks)
    cols = (3 * b.long()[..., None, None] + k[None, :]).expand_as(blocks)
    bi = torch.arange(H.shape[0])[:, None, None, None]
    H.index_put_((bi.expand_as(blocks).reshape(-1), rows.reshape(-1),
                  cols.reshape(-1)), blocks.reshape(-1), accumulate=True)


def _former_hessian(g, Ji, Jj, wmask):
    nb, m = g.poses.shape[:2]
    H = torch.zeros((nb, 3 * m, 3 * m))
    Hij = ppg._blk(Ji, Jj, wmask)
    _former_add_blocks(H, g.ei, g.ei, ppg._blk(Ji, Ji, wmask))
    _former_add_blocks(H, g.ej, g.ej, ppg._blk(Jj, Jj, wmask))
    _former_add_blocks(H, g.ei, g.ej, Hij)
    _former_add_blocks(H, g.ej, g.ei, Hij.transpose(-1, -2))
    return H


def _former_unary(poses, unary):
    wr, r = ppg._unary_residuals(poses, unary)
    return (_former_rows(poses, unary[0], wr),
            _former_rows(poses, unary[0], unary[2].expand(wr.shape)),
            (wr * r).sum(dim=(-2, -1)))


def _bits_equal(a, b, what):
    assert a.shape == b.shape, (what, a.shape, b.shape)
    diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
    assert diff == 0, f"{what}: {diff} of {a.numel()} entries differ"


def _terms(g):
    wmask = torch.where(g.e_valid[..., None], g.weight,
                        torch.zeros_like(g.weight))
    r, Ji, Jj = ppg._residuals_and_jac(g)
    return wmask, wmask * r, Ji, Jj


# --- the plans' assembly bit-equal to the former one ----------------------

@pytest.mark.parametrize("n_graphs", [1, 4])
@pytest.mark.parametrize("site", ["gradient", "hessian", "unary",
                                  "closure-gradient"])
def test_assembly_bit_equal_to_the_scatter_add(site, n_graphs):
    g, un = _batch(n_graphs)
    wmask, wr, Ji, Jj = _terms(g)
    plans = ppg.solve_plans(g, un, hessian=True)
    # the pile-up node really carries many edges: the plans are deep
    assert len(plans["b"].layers) >= C - 2
    assert len(plans["H"].layers) >= C - 2
    if site == "gradient":
        _bits_equal(ppg._gradient(g, Ji, Jj, wr, plans["b"]),
                    _former_gradient(g, Ji, Jj, wr), site)
    elif site == "hessian":
        _bits_equal(ppg._hessian(g, Ji, Jj, wmask, plans["H"]),
                    _former_hessian(g, Ji, Jj, wmask), site)
    elif site == "unary":
        for got, ref in zip(ppg.unary_terms(g.poses, un, plans["unary"]),
                            _former_unary(g.poses, un)):
            _bits_equal(got, ref, site)
        # a plan built on the spot gives the same, on one unbatched graph
        one = tuple(u[0] for u in un)
        for got, ref in zip(ppg.unary_terms(g.poses[0], one),
                            _former_unary(g.poses[0], one)):
            _bits_equal(got, ref, site + " unbatched")
    else:
        # the sharded trajectory solver's closure gradient
        # (parallel/solve.py): added to a nonzero b in closure order
        ci, cj = g.ei[0, M - 1:].long(), g.ej[0, M - 1:].long()
        xi = torch.einsum("eab,ea->eb", Ji[0, M - 1:], wr[0, M - 1:])
        xj = torch.einsum("eab,ea->eb", Jj[0, M - 1:], wr[0, M - 1:])
        b0 = ppg._gradient(g, Ji, Jj, wr, plans["b"])[0]
        plan = ppg.add_plans((torch.cat([ci, cj]), 2 * C))[0]
        _bits_equal(ppg.plan_add(b0.clone(), plan, torch.cat([xi, xj])),
                    b0.index_add(0, ci, xi).index_add(0, cj, xj), site)


def test_plans_edge_cases():
    """No contributions give no layer; a bound below the deepest row
    raises instead of dropping a layer; -0.0 and NaN rows behave as under
    the sequential add."""
    empty = ppg.add_plans((torch.zeros((0,), dtype=torch.int64), 0))[0]
    assert empty.layers == ()
    keys = torch.tensor([3, 1, 3, 3, 0, 1])
    with pytest.raises(ValueError):
        ppg.add_plans((keys, 2))
    plan = ppg.add_plans((keys, 6))[0]
    assert [hi - lo for lo, hi in plan.layers] == [3, 2, 1]
    src = torch.tensor([1e8, -0.0, 1.0, -1e8, float("nan"), -0.0])
    out = torch.tensor([-0.0, -0.0, 5.0, -0.0])
    ref = out.clone()
    for k, v in zip(keys.tolist(), src.tolist()):
        ref[k] = ref[k] + v
    got = ppg.plan_add(out, plan, src)
    assert torch.equal(got.isnan(), ref.isnan())
    _bits_equal(torch.nan_to_num(got), torch.nan_to_num(ref), "edge cases")


# --- the solves on a pile-up graph against the JAX package -----------------

@functools.lru_cache(maxsize=None)
def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


@pytest.mark.parametrize("solver", ["dense", "dense-unary", "structured",
                                    "structured-unary", "dense-batch",
                                    "structured-batch"])
def test_pileup_solves_match_jax(solver):
    args = _pileup(7)
    poses, n_poses, ci, cj, cmeas, nc = args
    gj = jpg.graph_from_trajectory(jnp.asarray(poses), n_poses,
                                   jnp.asarray(ci), jnp.asarray(cj),
                                   jnp.asarray(cmeas), nc)
    gp = _port_graph(args)
    un = _unary(7) if solver.endswith("unary") else None
    unp = None if un is None else tuple(t(x) for x in un)
    if solver.endswith("batch"):
        gjs = jax.tree_util.tree_map(lambda *x: jnp.stack(x), gj, gj)
        gps = ppg.PoseGraph(*(torch.stack([f, f]) for f in gp))
        if solver.startswith("dense"):
            oj, cj_ = _jit(jpg.optimize_graphs_batch, iterations=6)(gjs)
            op, cp = ppg.optimize_graphs_batch(gps, iterations=6)
        else:
            oj, cj_ = _jit(jtd.structured_gn_batch, n_chain=M - 1,
                           iterations=6)(gjs)
            op, cp = ptd.structured_gn_batch(gps, M - 1, iterations=6)
    elif solver.startswith("dense"):
        oj, cj_ = _jit(jpg.gauss_newton, iterations=6)(gj, unary=un)
        op, cp = ppg.gauss_newton(gp, iterations=6, unary=unp)
    else:
        oj, cj_ = _jit(jtd.structured_gn, n_chain=M - 1,
                       iterations=6)(gj, unary=un)
        op, cp = ptd.structured_gn(gp, M - 1, iterations=6, unary=unp)
    assert_close(op.poses, oj.poses, rtol=0, atol=POSE_ATOL)
    assert_close(cp[..., -1], cj_[..., -1], rtol=COST_RTOL, atol=1e-6)
    assert torch.isfinite(op.poses).all()
