"""Joint multi-agent pose-graph refinement (swarm_tpu/slam/joint.py).

Per-agent refinement (slam/refine.py) drops the cross-agent closure edges;
here agents connected by cross-agent closures are solved as one joint
SE(2) graph per connected component, shaped for the structured solver:
agent block s owns nodes [s*S, (s+1)*S) with one power-of-two block size
S, chain edges across a block boundary or into padding get zero weight,
every block's first node is anchored, and intra- and inter-agent closures
enter through the same Woodbury fold. Components of one agent, or without
an inter edge, take the per-agent path.

`split_closures` and `agent_components` are the reference's host code
(numpy), copied.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.slam.posegraph import graph_from_trajectory
from swarm_tpu_torch.slam.refine import (_next_pow2, _padded_unary,
                                         agent_rows, refine_agent_trajectory)
from swarm_tpu_torch.slam.tridiag import structured_gn


def split_closures(session: Dict, closures: Tuple, fit_min: float = 0.6):
    """Partition the closure log (node_i, node_j, agent_j[, meas [C, 3],
    fit [C]]), in global packet-row indices with node_i the stored node,
    into per-agent and cross-agent edges. Node ownership is read from
    session["agent"][row].

    Returns (intra, intra_meas, inter, rows_of): intra {agent: [(i, j)]}
    per-agent indices, deduplicated (the best-fitness duplicate wins),
    self-pairs dropped; intra_meas {agent: [meas or None]} aligned;
    inter [(agent_i, ii, agent_j, jj, meas or None)] deduplicated under
    edge symmetry. An unmeasured cross edge of a log with measurement
    columns (a failed rendezvous verification) is dropped."""
    agent_of_row = np.asarray(session["agent"])
    rows_of, inv = agent_rows(session)
    ni, nj, _ = closures[:3]
    meas_arr = closures[3] if len(closures) > 3 else None
    fit_arr = closures[4] if len(closures) > 4 else None
    best_intra = {a: {} for a in rows_of}     # (i, j) -> (fit, meas)
    best_inter = {}                           # sym key -> (fit, edge)
    n_rows = len(agent_of_row)
    for k, (i, j) in enumerate(zip(ni, nj)):
        i, j = int(i), int(j)
        if not (0 <= i < n_rows and 0 <= j < n_rows):
            continue
        ai = int(agent_of_row[i])
        aj = int(agent_of_row[j])
        ii = int(inv[ai][i])
        jj = int(inv[aj][j])
        if ii < 0 or jj < 0:
            continue
        f = float(fit_arr[k]) if fit_arr is not None else -1.0
        m = (np.asarray(meas_arr[k], np.float32)
             if meas_arr is not None and f >= fit_min else None)
        if ai != aj and fit_arr is not None and m is None:
            continue
        if ai == aj:
            if ii == jj:
                continue
            old = best_intra[ai].get((ii, jj))
            if old is None or f > old[0]:
                best_intra[ai][(ii, jj)] = (f, m)
        else:
            key = (ai, ii, aj, jj) if (ai, ii) < (aj, jj) \
                else (aj, jj, ai, ii)
            old = best_inter.get(key)
            if old is None or f > old[0]:
                best_inter[key] = (f, (ai, ii, aj, jj, m))
    intra = {a: list(d.keys()) for a, d in best_intra.items()}
    intra_meas = {a: [v[1] for v in d.values()]
                  for a, d in best_intra.items()}
    inter = [v[1] for v in best_inter.values()]
    return intra, intra_meas, inter, rows_of


def agent_components(agents, inter):
    """Union-find over agents joined by >= 1 cross-agent edge: a list of
    sorted agent-id tuples covering every agent."""
    parent = {int(a): int(a) for a in agents}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in inter:
        ra, rb = find(e[0]), find(e[2])
        if ra != rb:
            parent[ra] = rb
    groups: Dict[int, list] = {}
    for a in parent:
        groups.setdefault(find(a), []).append(a)
    return [tuple(sorted(g)) for g in groups.values()]


def _solve_joint_component(origs, intra, intra_meas, inter, iterations,
                           closure_weight, inter_weight, anchor_weight,
                           damping, meas_weight, unary=None, device=None):
    """One connected component -> ({agent: [T, 3] optimised poses}, costs).
    origs {agent: [T, 3] float32 logged estimates}; capacities (block
    size, block count, closure count, unary count) power-of-two bucketed
    as in the reference. unary: optional {agent: (nodes, meas, weight)}
    in the agent's own node indices."""
    device = default_device(device)
    order = sorted(origs)
    k = len(order)
    s_cap = _next_pow2(max(len(p) for p in origs.values()))
    k_cap = 1 << max(0, (k - 1).bit_length())
    m = k_cap * s_cap
    poses = np.zeros((m, 3), np.float32)
    for s, a in enumerate(order):
        p = origs[a]
        poses[s * s_cap:s * s_cap + len(p)] = p
    slot = {a: s for s, a in enumerate(order)}

    edges = []
    for a, ps in intra.items():
        base = slot[a] * s_cap
        for (i, j), mm in zip(ps, intra_meas[a]):
            edges.append((base + i, base + j, mm, closure_weight))
    for ai, ii, aj, jj, mm in inter:
        edges.append((slot[ai] * s_cap + ii, slot[aj] * s_cap + jj,
                      mm, inter_weight))
    c_cap = _next_pow2(max(1, len(edges)))
    ci = np.zeros((c_cap,), np.int32)
    cj = np.zeros((c_cap,), np.int32)
    meas = np.zeros((c_cap, 3), np.float32)
    wcl = np.zeros((c_cap, 3), np.float32)
    for e, (i, j, mm, bw) in enumerate(edges):
        ci[e], cj[e] = i, j
        if mm is not None:
            meas[e] = mm
            wcl[e] = np.asarray(meas_weight, np.float32)
        else:
            wcl[e] = np.asarray(bw, np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    g = graph_from_trajectory(dev(poses), m, dev(ci), dev(cj), dev(meas),
                              len(edges))
    # weight surgery: chain edges across a block boundary, inside padding
    # or in an empty block -> 0; closure rows -> the per-edge weights
    w = g.weight.cpu().numpy().copy()
    e_idx = np.arange(m - 1)
    blk = e_idx // s_cap
    within = e_idx % s_cap
    t_of_blk = np.zeros(k_cap, np.int64)
    for s, a in enumerate(order):
        t_of_blk[s] = len(origs[a])
    live = (within + 1 < t_of_blk[blk]) & (within + 1 < s_cap)
    w[:m - 1] *= live[:, None]
    w[m - 1:] = wcl
    g = g._replace(weight=dev(w))

    unary_t = None
    if unary:
        gn, gm, gw = [], [], []
        for a, (un, um, uw) in unary.items():
            if a not in slot or len(un) == 0:
                continue
            gn.append(np.asarray(un, np.int64) + slot[a] * s_cap)
            gm.append(np.asarray(um, np.float32))
            gw.append(np.asarray(uw, np.float32))
        if gn:
            unary_t = _padded_unary((np.concatenate(gn),
                                     np.concatenate(gm, axis=0),
                                     np.concatenate(gw, axis=0)), device)

    anchor_nodes = np.arange(k_cap, dtype=np.int64) * s_cap
    out, costs = structured_gn(g, n_chain=m - 1, iterations=iterations,
                               damping=damping, anchor_weight=anchor_weight,
                               anchor_nodes=anchor_nodes, unary=unary_t)
    opt = out.poses.cpu().numpy()
    return {a: opt[slot[a] * s_cap:slot[a] * s_cap + len(origs[a])]
            for a in order}, costs.cpu().numpy()


def joint_refine_session(session: Dict, closures: Optional[Tuple] = None,
                         cfg: SwarmConfig = SwarmConfig(),
                         iterations: int = 15,
                         closure_weight=(4.0, 4.0, 0.0),
                         inter_weight=(4.0, 4.0, 0.0),
                         anchor_weight: float = 1e6,
                         damping: float = 1e-3,
                         unary: Optional[Dict] = None, device=None):
    """`refine.refine_session` that KEEPS the cross-agent closure edges:
    each connected component of agents solves as one joint graph,
    single-agent components take the per-agent path. Returns the
    refine_session dict, each agent with its `component` and the number
    of `inter_edges` its component used. Solves on `device` (the card
    when None)."""
    if closures is None:
        raise ValueError("joint refinement needs the logged closure "
                         "edges (re-detection is per-agent only — use "
                         "slam.refine.refine_session)")
    yaw_rad = np.radians(session["yaw_deg"])
    intra, intra_meas, inter, rows_of = split_closures(
        session, closures, fit_min=cfg.slam.merge_fitness_min)
    meas_weight = cfg.slam.closure_meas_weight
    origs = {a: np.stack([session["x"][rows], session["y"][rows],
                          yaw_rad[rows]], axis=-1).astype(np.float32)
             for a, rows in rows_of.items()}

    out = {}
    for comp in agent_components(rows_of.keys(), inter):
        comp_inter = [e for e in inter if e[0] in comp]
        if len(comp) == 1 or not comp_inter:
            for a in comp:
                orig = origs[a]
                if len(rows_of[a]) < 2:
                    opt = orig
                else:
                    opt, _ = refine_agent_trajectory(
                        orig[:, 0], orig[:, 1], orig[:, 2], intra[a],
                        iterations=iterations,
                        closure_weight=closure_weight,
                        closure_meas=intra_meas[a],
                        meas_weight=meas_weight,
                        damping=damping, anchor_weight=anchor_weight,
                        unary=None if unary is None else unary.get(a),
                        device=device)
                out[a] = {"poses": opt, "orig": orig, "idx": rows_of[a],
                          "closures": intra[a], "component": comp,
                          "inter_edges": 0}
            continue
        solved, _ = _solve_joint_component(
            {a: origs[a] for a in comp},
            {a: intra[a] for a in comp},
            {a: intra_meas[a] for a in comp}, comp_inter,
            iterations, closure_weight, inter_weight, anchor_weight,
            damping, meas_weight,
            unary=None if unary is None else
            {a: unary[a] for a in comp if a in unary}, device=device)
        for a in comp:
            out[a] = {"poses": solved[a], "orig": origs[a],
                      "idx": rows_of[a], "closures": intra[a],
                      "component": comp,
                      "inter_edges": len(comp_inter)}
    return out
