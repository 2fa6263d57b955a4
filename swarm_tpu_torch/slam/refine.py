"""Session refinement: pose-graph optimisation over logged trajectories
(swarm_tpu/slam/refine.py).

Each agent's logged estimates become an SE(2) pose graph (odometry edges
from the estimates, closure edges from the closure log or re-detected from
the telemetry), solved by Gauss-Newton: the dense solver up to 256 nodes,
the structured one (slam/tridiag.py) beyond. Trajectories, closure lists
and unary factors are padded to power-of-two capacities as the reference
pads them (there so that calls share compiled solvers); padding nodes are
pinned by the damping, so the real nodes' results are the reference's.
Host code is numpy, float64 where the session is; the solves are float32
on the device, as in JAX with x64 off. Agents are solved one after
another, as in the reference.

`reraster_session` re-projects every packet from the optimised poses
through `engine/replay.replay_session` (landmarks cleared, so nothing
closes twice) into a fresh tri-state grid.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.config import SlamConfig, SwarmConfig
from swarm_tpu_torch.slam.posegraph import gauss_newton, graph_from_trajectory
from swarm_tpu_torch.slam.tridiag import structured_gn

# above this capacity the structured solver takes over (refine.py:121)
DENSE_MAX_NODES = 256


def _next_pow2(n: int) -> int:
    m = 64
    while m < n:
        m *= 2
    return m


def _padded_unary(unary, device):
    """(nodes, meas [Q, 3], weight [Q, 3]) padded to a power-of-two
    capacity with zero weight, as tensors on `device`."""
    un, um, uw = unary
    q = _next_pow2(max(1, len(un)))
    n_pad = np.zeros((q,), np.int32)
    m_pad = np.zeros((q, 3), np.float32)
    w_pad = np.zeros((q, 3), np.float32)
    n_pad[:len(un)] = un
    m_pad[:len(un)] = um
    w_pad[:len(un)] = uw
    return tuple(torch.from_numpy(a).to(device) for a in (n_pad, m_pad,
                                                           w_pad))


def refine_agent_trajectory(xs, ys, yaws, closure_pairs,
                            iterations: int = 15,
                            closure_weight=(4.0, 4.0, 0.0),
                            closure_meas=None, meas_weight=None,
                            damping: float = 1e-3,
                            anchor_weight: float = 1e6,
                            unary=None, device=None):
    """One agent's logged estimates [T] + closure index pairs [(i, j)]
    (i the stored node, j the revisit) -> (optimised poses [T, 3] numpy,
    costs [iterations] numpy). closure_meas: optional list aligned to the
    pairs of (mx, my, mth) measurements in frame i or None (coincidence
    edges, `closure_weight`); measured edges get `meas_weight` (default
    SlamConfig.closure_meas_weight). unary: optional (nodes, meas [Q, 3],
    weight [Q, 3]) absolute pose observations. Solves on `device` (the
    card when None)."""
    device = default_device(device)
    t = len(xs)
    cap = _next_pow2(t)
    poses = np.zeros((cap, 3), np.float32)
    poses[:t, 0] = xs
    poses[:t, 1] = ys
    poses[:t, 2] = yaws
    unary_t = None if unary is None else _padded_unary(unary, device)
    c = _next_pow2(max(1, len(closure_pairs)))
    ci = np.zeros((c,), np.int32)
    cj = np.zeros((c,), np.int32)
    if np.isscalar(closure_weight):
        closure_weight = (closure_weight,) * 3
    if meas_weight is None:
        meas_weight = SlamConfig.closure_meas_weight
    meas = np.zeros((c, 3), np.float32)
    w = np.zeros((c, 3), np.float32)
    w[:len(closure_pairs)] = np.asarray(closure_weight, np.float32)
    for k, (i, j) in enumerate(closure_pairs):
        ci[k], cj[k] = i, j
        if closure_meas is not None and closure_meas[k] is not None:
            meas[k] = closure_meas[k]
            w[k] = np.asarray(meas_weight, np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    g = graph_from_trajectory(dev(poses), t, dev(ci), dev(cj), dev(meas),
                              len(closure_pairs),
                              closure_weight=tuple(closure_weight))
    weight = g.weight.clone()
    weight[cap - 1:] = dev(w)
    g = g._replace(weight=weight)
    if cap > DENSE_MAX_NODES:
        out, costs = structured_gn(g, n_chain=cap - 1,
                                   iterations=iterations, damping=damping,
                                   anchor_weight=anchor_weight,
                                   unary=unary_t)
    else:
        out, costs = gauss_newton(g, iterations=iterations, damping=damping,
                                  anchor_weight=anchor_weight, unary=unary_t)
    return out.poses[:t].cpu().numpy(), costs.cpu().numpy()


def agent_rows(session: Dict):
    """{agent: its rows of the session} and {agent: global row -> the
    agent's own index, -1 elsewhere}."""
    agents = np.unique(session["agent"])
    rows_of = {int(a): np.nonzero(session["agent"] == a)[0] for a in agents}
    inv = {}
    for a, rows in rows_of.items():
        m = np.full(len(session["t"]), -1, np.int64)
        m[rows] = np.arange(len(rows))
        inv[a] = m
    return rows_of, inv


def refine_session(session: Dict, closures: Optional[Tuple] = None,
                   cfg: SwarmConfig = SwarmConfig(),
                   iterations: int = 15,
                   closure_weight=(4.0, 4.0, 0.0),
                   unary: Optional[Dict] = None, device=None):
    """Refine every agent trajectory of a session dict (t, agent 1-based,
    x, y, yaw_deg, landmark). `closures`: (node_i, node_j, agent[, meas
    [C, 3], fit [C]]) in global packet-row indices, parsed by
    `joint.split_closures` (deduplicated, self-pairs dropped, measurements
    gated at `cfg.slam.merge_fitness_min`; cross-agent edges ignored here).
    None re-detects closures per agent from the telemetry with the
    reference's landmark rule. unary: {agent: (nodes, meas, weight)}.

    Returns {agent: {"poses": [T, 3] optimised, "orig": [T, 3], "idx": [T]
    global rows, "closures": pairs, "measured": measured pairs}}."""
    yaw_rad = np.radians(session["yaw_deg"])
    rows_of, _ = agent_rows(session)
    pairs = {a: [] for a in rows_of}
    pair_meas = {a: [] for a in rows_of}
    if closures is not None:
        from swarm_tpu_torch.slam.joint import split_closures
        intra, intra_meas, _inter, _ = split_closures(
            session, closures, fit_min=cfg.slam.merge_fitness_min)
        pairs.update(intra)
        pair_meas.update(intra_meas)
    else:
        slam = cfg.slam
        for a, rows in rows_of.items():
            lm = session["landmark"][rows]
            x = session["x"][rows]
            y = session["y"][rows]
            lm_rows = np.nonzero(lm != 0)[0]
            last = -slam.min_poses_between
            for i in lm_rows:
                if i - last < slam.min_poses_between:
                    continue
                cand = lm_rows[(lm_rows < i - slam.min_poses_between)]
                cand = cand[lm[cand] == lm[i]]
                if len(cand) == 0:
                    continue
                d2 = (x[cand] - x[i]) ** 2 + (y[cand] - y[i]) ** 2
                k = np.argmin(d2)
                if d2[k] < slam.closure_radius_m ** 2:
                    pairs[a].append((int(cand[k]), int(i)))
                    pair_meas[a].append(None)
                    last = i

    out = {}
    for a, rows in rows_of.items():
        orig = np.stack([session["x"][rows], session["y"][rows],
                         yaw_rad[rows]], axis=-1).astype(np.float32)
        if len(rows) < 2:
            out[a] = {"poses": orig, "orig": orig, "idx": rows,
                      "closures": pairs[a]}
            continue
        opt, _ = refine_agent_trajectory(
            orig[:, 0], orig[:, 1], orig[:, 2], pairs[a],
            iterations=iterations, closure_weight=closure_weight,
            closure_meas=pair_meas[a],
            meas_weight=cfg.slam.closure_meas_weight,
            unary=None if unary is None else unary.get(a), device=device)
        out[a] = {"poses": opt, "orig": orig, "idx": rows,
                  "closures": pairs[a],
                  "measured": sum(m is not None for m in pair_meas[a])}
    return out


def reraster_session(session, refined, cfg: SwarmConfig = SwarmConfig(),
                     device=None):
    """Re-project every packet's rays from the OPTIMISED poses and build a
    fresh parity grid on `device` (the card when None) — the refined map.
    Returns (grid [S, S] int8 numpy, the replayed PacketStream)."""
    from swarm_tpu_torch.engine.replay import PacketStream, replay_session

    dev = default_device(device)
    n = len(session["t"])
    x = np.array(session["x"], np.float32)
    y = np.array(session["y"], np.float32)
    yaw = np.radians(session["yaw_deg"]).astype(np.float32)
    for r in refined.values():
        x[r["idx"]] = r["poses"][:, 0]
        y[r["idx"]] = r["poses"][:, 1]
        yaw[r["idx"]] = r["poses"][:, 2]

    def col(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    stream = PacketStream(
        t=col(session["t"], np.float32),
        agent=col(session["agent"] - 1, np.int32), x=col(x), y=col(y),
        yaw=col(yaw), encoder=col(session["encoder"], np.int32),
        v2v=col(session["v2v"], np.int32),
        dist=col(session["dist_cm"] / 100.0, np.float32),
        landmark=torch.zeros((n,), dtype=torch.int32, device=dev),
        valid=torch.ones((n,), dtype=torch.bool, device=dev))
    state, _ = replay_session(
        stream, cfg, offsets=torch.zeros((cfg.n_agents,),
                                         dtype=torch.float32, device=dev))
    return state.grid.cpu().numpy(), stream
