"""Landmark-based loop closure as fixed-capacity ring buffers
(swarm_tpu/slam/closure.py `ClosureState`, `closure_init`,
`closure_add_poses_batch`).

The batched throughput form the engine runs: one step's packets (one per
agent) are matched against the landmarks stored BEFORE the batch, the first
match in insertion order wins, the closure log and the landmark ring append
in packet order. The scan-matched closure measurement and the proximity
pairs (`SlamConfig.closure_scanmatch`) are not ported yet; the engine
refuses configs that turn them on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from swarm_tpu_torch.config import SlamConfig


class ClosureState(NamedTuple):
    lm_x: torch.Tensor        # [L]
    lm_y: torch.Tensor        # [L]
    lm_type: torch.Tensor     # [L] int32, 0 = empty slot
    lm_node: torch.Tensor     # [L] int32 node index, -1 = empty
    lm_agent: torch.Tensor    # [L] int32 storing agent, -1 = empty
    lm_count: torch.Tensor    # [] int32 (total ever stored)
    n_nodes: torch.Tensor             # [] int32
    last_closure_node: torch.Tensor   # [N] int32
    drift_dx: torch.Tensor            # [N] cumulative correction
    drift_dy: torch.Tensor            # [N]
    cl_lm_node: torch.Tensor   # [C] int32
    cl_node: torch.Tensor      # [C] int32
    cl_dx: torch.Tensor        # [C]
    cl_dy: torch.Tensor        # [C]
    cl_agent: torch.Tensor     # [C] int32
    cl_count: torch.Tensor     # [] int32
    lm_yaw: torch.Tensor       # [L]
    lm_scan: torch.Tensor      # [L, R] (R = 1 when scan matching is off)
    cl_mx: torch.Tensor        # [C]
    cl_my: torch.Tensor        # [C]
    cl_mth: torch.Tensor       # [C]
    cl_fit: torch.Tensor       # [C] match fitness, -1 = unmeasured
    last_pair_node: torch.Tensor   # [N] int32


def closure_init(n_agents: int, cfg: SlamConfig = SlamConfig(),
                 closure_capacity: int = 1024, scan_rays: int = 0,
                 device=None) -> ClosureState:
    L, C = cfg.landmark_capacity, closure_capacity
    R = max(1, scan_rays)

    def zf(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def fi(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    return ClosureState(
        lm_x=zf(L), lm_y=zf(L), lm_type=fi((L,), 0), lm_node=fi((L,), -1),
        lm_agent=fi((L,), -1), lm_count=fi((), 0), n_nodes=fi((), 0),
        last_closure_node=fi((n_agents,), -cfg.min_poses_between),
        drift_dx=zf(n_agents), drift_dy=zf(n_agents),
        cl_lm_node=fi((C,), -1), cl_node=fi((C,), -1),
        cl_dx=zf(C), cl_dy=zf(C), cl_agent=fi((C,), -1), cl_count=fi((), 0),
        lm_yaw=zf(L), lm_scan=zf(L, R),
        cl_mx=zf(C), cl_my=zf(C), cl_mth=zf(C),
        cl_fit=torch.full((C,), -1.0, dtype=torch.float32, device=device),
        last_pair_node=fi((n_agents,), -(1 << 30)))


def _ring_put(buf, slot, vals, keep):
    """buf[slot[keep]] = vals[keep] on a copy — the reference's
    `.at[slot].set(vals, mode="drop")`. Dropped rows land on a spare row
    that is cut off again, so no boolean indexing (and no host sync)."""
    n = buf.shape[0]
    idx = torch.where(keep, slot.to(torch.int64),
                      torch.full_like(slot, n, dtype=torch.int64))
    out = torch.cat([buf, buf[:1]])
    out.index_copy_(0, idx, vals.to(buf.dtype))
    return out[:n]


def closure_add_poses_batch(state: ClosureState, xs, ys, agents, lm_types,
                            cfg: SlamConfig = SlamConfig(), valid=None,
                            yaws=None):
    """Throughput-mode closure for one step's packets [M] (distinct agents).
    Returns (new_state, closed [M] bool, cdx [M], cdy [M]).

    Rows with valid False leave the per-agent guards alone. (The reference
    scatters them onto agent 0 with its old values — ROADMAP Queue C7.)"""
    if cfg.closure_scanmatch:
        raise NotImplementedError(
            "scan-matched closures are not ported yet (ROADMAP Queue A, "
            "offline SLAM)")
    M = xs.shape[0]
    dev = xs.device
    if valid is None:
        valid = torch.ones((M,), dtype=torch.bool, device=dev)
    base = state.n_nodes
    vi = valid.to(torch.int32)
    idxs = base + torch.cumsum(vi, 0).to(torch.int32) - vi

    has_lm = (lm_types != 0) & valid
    L = state.lm_x.shape[0]
    slots = torch.arange(L, dtype=torch.int32, device=dev)
    occupied = slots < torch.clamp_max(state.lm_count, L)

    ag = agents.long()
    same_type = state.lm_type[None, :] == lm_types[:, None]
    far_in_seq = (idxs[:, None] - state.lm_node[None, :]) >= \
        cfg.min_poses_between
    agent_ok = (idxs - state.last_closure_node[ag]) >= cfg.min_poses_between
    d2 = (xs[:, None] - state.lm_x[None, :]) ** 2 + \
        (ys[:, None] - state.lm_y[None, :]) ** 2
    near = d2 < cfg.closure_radius_m ** 2
    match = occupied[None, :] & same_type & far_in_seq & near & \
        (agent_ok & has_lm)[:, None]
    if cfg.closure_same_agent_only:
        match = match & (state.lm_agent[None, :] == agents[:, None])

    closed = match.any(dim=1)
    first = torch.argmin(torch.where(match, slots[None, :],
                                     torch.full_like(match, L,
                                                     dtype=torch.int32)),
                         dim=1)
    mx = state.lm_x[first]
    my = state.lm_y[first]
    zero = torch.zeros_like(xs)
    cdx = torch.where(closed, (mx - xs) * cfg.closure_correction, zero)
    cdy = torch.where(closed, (my - ys) * cfg.closure_correction, zero)

    last_cl = _ring_put(state.last_closure_node, agents, idxs, closed)
    drift_dx = _ring_put(state.drift_dx, agents, state.drift_dx[ag] + cdx,
                         valid)
    drift_dy = _ring_put(state.drift_dy, agents, state.drift_dy[ag] + cdy,
                         valid)

    # closure log append (packet order within the batch)
    C = state.cl_lm_node.shape[0]
    ci = closed.to(torch.int32)
    cslot = torch.remainder(state.cl_count + torch.cumsum(ci, 0) - ci, C)
    cl_lm_node = _ring_put(state.cl_lm_node, cslot, state.lm_node[first],
                           closed)
    cl_node = _ring_put(state.cl_node, cslot, idxs, closed)
    cl_dx = _ring_put(state.cl_dx, cslot, cdx, closed)
    cl_dy = _ring_put(state.cl_dy, cslot, cdy, closed)
    cl_agent = _ring_put(state.cl_agent, cslot, agents, closed)
    cl_count = state.cl_count + ci.sum().to(torch.int32)
    # unmeasured edges (scan matching off): measurement 0, fitness -1
    cl_mx = _ring_put(state.cl_mx, cslot, zero, closed)
    cl_my = _ring_put(state.cl_my, cslot, zero, closed)
    cl_mth = _ring_put(state.cl_mth, cslot, zero, closed)
    cl_fit = _ring_put(state.cl_fit, cslot, zero - 1.0, closed)

    # landmark appends AFTER matching, packet order
    hi = has_lm.to(torch.int32)
    lslot = torch.remainder(state.lm_count + torch.cumsum(hi, 0) - hi, L)
    lm_x = _ring_put(state.lm_x, lslot, xs, has_lm)
    lm_y = _ring_put(state.lm_y, lslot, ys, has_lm)
    lm_t = _ring_put(state.lm_type, lslot, lm_types, has_lm)
    lm_n = _ring_put(state.lm_node, lslot, idxs, has_lm)
    lm_a = _ring_put(state.lm_agent, lslot, agents, has_lm)
    lm_yaw = _ring_put(state.lm_yaw, lslot,
                       zero if yaws is None else yaws, has_lm)
    lm_count = state.lm_count + hi.sum().to(torch.int32)

    new = ClosureState(
        lm_x=lm_x, lm_y=lm_y, lm_type=lm_t, lm_node=lm_n, lm_agent=lm_a,
        lm_count=lm_count, n_nodes=base + vi.sum().to(torch.int32),
        last_closure_node=last_cl, drift_dx=drift_dx, drift_dy=drift_dy,
        cl_lm_node=cl_lm_node, cl_node=cl_node, cl_dx=cl_dx, cl_dy=cl_dy,
        cl_agent=cl_agent, cl_count=cl_count,
        lm_yaw=lm_yaw, lm_scan=state.lm_scan,
        cl_mx=cl_mx, cl_my=cl_my, cl_mth=cl_mth, cl_fit=cl_fit,
        last_pair_node=state.last_pair_node)
    return new, closed, cdx, cdy
