"""The batched pose-graph solvers (swarm_tpu_torch/slam/posegraph.py
`optimize_graphs_batch`, slam/tridiag.py `structured_gn_batch`) and the
rank-sharded solvers (swarm_tpu_torch/parallel/solve.py) against the JAX
package's, on the CPU.

Graphs are made from a seed with numpy (the JAX tests' square loop of
tests/test_slam_upgrades.py, and the circular loop of tests/test_tridiag.py)
and fed to both sides. Bars: the batched solvers equal the per-graph loop
within 1e-5 and JAX's vmapped solvers within 1e-4 in the poses (final
costs rtol 1e-3); a graph whose factorisation fails is NaN in its own
poses only, on both sides. The sharded solvers run on 4 gloo ranks
(`torch.distributed.run`), held against JAX's on a 4-device CPU mesh with
the JAX tests' bars (tests/test_sharded_solve.py: poses 1e-4;
tests/test_tridiag.py: the trajectory solve's poses 1e-3, costs rtol
1e-3).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.parallel.mesh import make_mesh
from swarm_tpu.parallel.solve import make_sharded_solver as j_sharded
from swarm_tpu.parallel.solve import make_trajectory_sharded_gn as j_traj
from swarm_tpu.parallel.solve import shard_graphs as j_shard
from swarm_tpu.slam import posegraph as jpg
from swarm_tpu.slam import tridiag as jtd
from swarm_tpu_torch.slam import posegraph as ppg
from swarm_tpu_torch.slam import tridiag as ptd
from tests.test_slam_upgrades import noisy_loop_trajectory
from tests.torch_parity import assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_ATOL = 1e-5
POSE_ATOL = 1e-4
COST_RTOL = 1e-3
RANKS = 4
N_GRAPHS, M_NODES = 8, 32
CHAIN_NODES = 129
SPAWN_LIMIT = 300          # seconds for the 4-rank launch to join


def _square(seed, m=M_NODES, n_poses=None):
    """The JAX sharded-solver test's graph inputs (numpy): a noisy square
    loop with one closure from its last live node to its first."""
    _, noisy = noisy_loop_trajectory(m, seed=seed)
    n_poses = m if n_poses is None else n_poses
    return (noisy.astype(np.float32), n_poses,
            np.array([n_poses - 1], np.int32), np.array([0], np.int32),
            np.zeros((1, 3), np.float32), 1)


def _circle(seed, m, n_poses=None, cap=4, n_closures=2):
    """tests/test_tridiag.py's noisy circular loop (numpy), n_poses live."""
    rng = np.random.default_rng(seed)
    n_poses = m if n_poses is None else n_poses
    s = np.linspace(0, 4 * np.pi, m)
    truth = np.stack([np.cos(s), np.sin(s), s + np.pi / 2], -1)
    noisy = (truth + 0.05 * rng.normal(size=truth.shape)).astype(np.float32)
    noisy[0] = truth[0]
    ci = np.zeros(cap, np.int32)
    cj = np.zeros(cap, np.int32)
    ci[:n_closures] = rng.integers(n_poses // 2, n_poses - 1, n_closures)
    cj[:n_closures] = rng.integers(1, n_poses // 4, n_closures)
    return (noisy, n_poses, ci, cj, np.zeros((cap, 3), np.float32),
            n_closures)


def _graph_leaves(args, closure_weight):
    """The port's graph as numpy leaves (PoseGraph field order)."""
    poses, n_poses, ci, cj, cmeas, nc = args
    g = ppg.graph_from_trajectory(torch.from_numpy(poses), n_poses,
                                  torch.from_numpy(ci), torch.from_numpy(cj),
                                  torch.from_numpy(cmeas), nc,
                                  closure_weight=closure_weight)
    return [f.numpy() for f in g]


def _batch(arg_list, closure_weight=(50.0,) * 3):
    """(JAX PoseGraph, port PoseGraph) of the stacked graphs."""
    leaves = [np.stack(f) for f in zip(*[_graph_leaves(a, closure_weight)
                                         for a in arg_list])]
    return (jpg.PoseGraph(*(jnp.asarray(f) for f in leaves)),
            ppg.PoseGraph(*(torch.from_numpy(f) for f in leaves)))


def _row(g, i):
    return ppg.PoseGraph(*(f[i] for f in g))


@functools.lru_cache(maxsize=None)
def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


# (solver, batched port, per-graph port, JAX batch, keyword arguments)
SOLVERS = {
    "dense": (ppg.optimize_graphs_batch, ppg.gauss_newton,
              jpg.optimize_graphs_batch, {}),
    "structured": (ptd.structured_gn_batch,
                   functools.partial(ptd.structured_gn,
                                     n_chain=M_NODES - 1),
                   jtd.structured_gn_batch, {"n_chain": M_NODES - 1}),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("case", ["square", "failing"])
def test_batched_solver_equals_loop_and_jax(solver, case):
    """The batch as one program equals the loop over its graphs and JAX's
    vmap. "failing": zero damping and a graph with an unanchored padding
    tail, whose dense Cholesky fails (NaN in that graph's poses only) and
    whose structured steps are all rejected."""
    batch_fn, one_fn, jax_fn, kw = SOLVERS[solver]
    if case == "square":
        args, damping = [_square(s) for s in range(4)], 1e-3
    else:
        args = [_square(0), _square(2, n_poses=24), _square(1)]
        damping = 0.0
    gj, gp = _batch(args)
    op, cp = batch_fn(gp, iterations=6, damping=damping, **kw)
    loop = [one_fn(_row(gp, i), iterations=6, damping=damping)
            for i in range(len(args))]
    oj, cj = _jit(jax_fn, iterations=6, damping=damping, **kw)(gj)
    want_nan = np.isnan(np.asarray(oj.poses))
    np.testing.assert_array_equal(torch.isnan(op.poses).numpy(), want_nan)
    for i, (o, c) in enumerate(loop):
        assert_close(op.poses[i], o.poses, rtol=0, atol=LOOP_ATOL,
                     what=f"graph {i} against the loop")
        assert_close(cp[i], c, rtol=LOOP_ATOL, atol=LOOP_ATOL)
    assert_close(op.poses, oj.poses, rtol=0, atol=POSE_ATOL)
    assert_close(cp[:, -1], cj[:, -1], rtol=COST_RTOL, atol=1e-6)
    if case == "failing":
        bad = want_nan.reshape(len(args), -1).any(axis=1)
        if solver == "dense":
            assert bad.tolist() == [False, True, False]
        else:
            assert not bad.any()
            assert_close(op.poses[1], gp.poses[1], rtol=0, atol=0)


RANK_SCRIPT = """
import argparse
import os
from datetime import timedelta

import numpy as np
import torch

from swarm_tpu_torch.parallel import mesh, solve
from swarm_tpu_torch.slam.posegraph import PoseGraph

ap = argparse.ArgumentParser()
ap.add_argument("--timeout", type=float)
ap.add_argument("--data")
ap.add_argument("--out")
a = ap.parse_args()
torch.set_num_threads(1)
mesh.init("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
          timedelta(seconds=a.timeout), device="cpu")
lay = mesh.make_layout(device="cpu")
d = np.load(a.data)
graphs = PoseGraph(*(torch.from_numpy(d[f"batch/{f}"])
                     for f in PoseGraph._fields))
chain = PoseGraph(*(torch.from_numpy(d[f"chain/{f}"])
                    for f in PoseGraph._fields))
m = graphs.poses.shape[1]
out = {}
for name, kw in (("dense", {}), ("structured", {"structured": True,
                                                "n_chain": m - 1})):
    s = solve.make_sharded_solver(lay, iterations=8, **kw)
    g, costs, total = s(solve.shard_graphs(graphs, lay))
    out[name + "/poses"] = g.poses.numpy()
    out[name + "/costs"] = costs.numpy()
    out[name + "/total"] = total.numpy()
traj = solve.make_trajectory_sharded_gn(
    lay, n_chain=chain.poses.shape[0] - 1, iterations=8)
g, costs = traj(chain)
out["chain/poses"] = g.poses.numpy()
out["chain/costs"] = costs.numpy()
np.savez(a.out + f".{lay.rank}.npz", **out)
print(f"solve ok rank {lay.rank}")
# tear the group down before the interpreter exits, as the other rank
# scripts do (tests/test_torch_sharded.py, parallel/dryrun.py)
torch.distributed.destroy_process_group()
"""


def _torchrun(nproc, script, *args, timeout=SPAWN_LIMIT):
    """`script` on `nproc` gloo ranks, joined within `timeout` seconds;
    returns its standard output. `--standalone`: the launcher binds its
    own rendezvous port and holds it, so no other process can take it
    between choosing and binding."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         f"--nproc-per-node={nproc}", "--standalone", str(script),
         "--timeout", "120", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The sharded solvers on 4 gloo ranks: (inputs, each rank's
    outputs)."""
    tmp = tmp_path_factory.mktemp("solve")
    gj, gp = _batch([_square(s) for s in range(N_GRAPHS)])
    chain_j, chain_p = _batch([_circle(11, CHAIN_NODES)],
                              closure_weight=(10.0,) * 3)
    data = {f"batch/{f}": v.numpy() for f, v in zip(ppg.PoseGraph._fields,
                                                     gp)}
    data.update({f"chain/{f}": v[0].numpy()
                 for f, v in zip(ppg.PoseGraph._fields, chain_p)})
    np.savez(tmp / "in.npz", **data)
    script = tmp / "solve_rank.py"
    script.write_text(RANK_SCRIPT)
    text = _torchrun(RANKS, script, "--data", str(tmp / "in.npz"),
                     "--out", str(tmp / "out"))
    for r in range(RANKS):
        assert f"solve ok rank {r}" in text
    ranks = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(RANKS)]
    chain_j = jpg.PoseGraph(*(f[0] for f in chain_j))
    return gj, chain_j, ranks


@pytest.mark.parametrize("solver", ["dense", "structured"])
def test_sharded_solver_on_four_ranks(four_ranks, solver):
    gj, _, ranks = four_ranks
    kw = {"structured": True, "n_chain": M_NODES - 1} \
        if solver == "structured" else {}
    jm = make_mesh(RANKS)
    out_j, costs_j, total_j = j_sharded(jm, iterations=8, **kw)(
        j_shard(gj, jm))
    poses = np.concatenate([r[f"{solver}/poses"] for r in ranks])
    costs = np.concatenate([r[f"{solver}/costs"] for r in ranks])
    np.testing.assert_allclose(poses, np.asarray(out_j.poses), rtol=1e-4,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(costs[:, -1], np.asarray(costs_j)[:, -1],
                               rtol=COST_RTOL, atol=1e-6)
    assert (costs[:, -1] < costs[:, 0]).all()
    # every rank holds the one all-reduced total
    for r in ranks:
        np.testing.assert_allclose(r[f"{solver}/total"], costs[:, -1].sum(),
                                   rtol=1e-6)
    np.testing.assert_allclose(ranks[0][f"{solver}/total"],
                               float(total_j), rtol=COST_RTOL)


def test_trajectory_sharded_gn_on_four_ranks(four_ranks):
    _, chain_j, ranks = four_ranks
    solve = j_traj(make_mesh(RANKS), n_chain=CHAIN_NODES - 1, iterations=8)
    gp_j, cost_j = solve(chain_j)
    gs, _ = _jit(jtd.structured_gn, n_chain=CHAIN_NODES - 1,
                 iterations=8)(chain_j)
    for r in ranks:
        np.testing.assert_array_equal(r["chain/poses"],
                                      ranks[0]["chain/poses"])
        np.testing.assert_allclose(r["chain/poses"], np.asarray(gp_j.poses),
                                   atol=1e-3)
        np.testing.assert_allclose(r["chain/costs"], np.asarray(cost_j),
                                   rtol=COST_RTOL, atol=1e-5)
        np.testing.assert_allclose(r["chain/poses"], np.asarray(gs.poses),
                                   atol=1e-3)
