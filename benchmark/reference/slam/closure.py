"""Landmark-based loop closure as fixed-capacity ring buffers
(swarm_tpu/slam/closure.py `ClosureState`, `closure_init`,
`closure_add_poses_batch`, `closure_add_pose`).

Three forms. `closure_add_pose` is the reference's one-packet check,
field for field (the parity replay's and the native oracle's unit).
`closure_add_poses_batch` is the throughput form: one step's
packets (one per agent) are matched against the landmarks stored BEFORE the
batch, the first match in insertion order wins, the closure log and the
landmark ring append in packet order. `closure_add_poses_seq` is the
reference-parity form, the reference's `lax.scan` of `closure_add_pose`
over the packets, computed without a loop: each packet is matched against
the ring as the packets before it left it. Only the landmark appends
change what a later packet sees (each packet's closure guard is its own
agent's, and agents are distinct), and the appends do not depend on the
matches, so the ring before packet j is known in closed form: each slot
holds the last of the earlier appends that landed on it, or its old
landmark. Its two halves, `seq_match` (the tests) and `seq_apply` (the
state after them), also serve the replay (engine/replay.py), whose
windows repeat agents.

With `SlamConfig.closure_scanmatch` the batch form remembers each stored
landmark's yaw and sweep, measures every fired closure by scan matching
(slam/closurematch.py), adds the rendezvous term (another agent's landmark
within `closure_cross_radius_m`: detection only, never a snap) and the
proximity pairs (up to `closure_pair_budget` closest co-located agents'
current sweeps matched against each other, verified edges logged). The
reference skips each matcher with a `lax.cond` on "any closure" and "any
pair"; eager torch needs those two flags on the host, so a step with scan
matching reads them once, together (ROADMAP C27). The sequential form
(parity mode) takes no sweep, as the reference's parity step passes none:
there the flag only sizes `lm_scan`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.config import SlamConfig

NEG_NODE = -(1 << 30)


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
        last_pair_node=fi((n_agents,), NEG_NODE))


def closure_add_pose(state: ClosureState, x, y, agent, lm_type,
                     cfg: SlamConfig = SlamConfig(), valid=True,
                     yaw=None, scan=None):
    """Add one pose (already drift-corrected) and run the closure check
    (ref dual_bot_mapper.py:261-338): the packet is matched against every
    stored landmark and the first hit in insertion order wins; its
    landmark is stored after matching, with `yaw` (0 when None) and, with
    `cfg.closure_scanmatch`, `scan` [R]; a closure is logged unmeasured
    (cl_fit = -1). x, y, agent, lm_type and valid are scalars or 0-d
    tensors; an invalid packet leaves the state untouched. No host read.
    Returns (new_state, closed, cdx, cdy)."""
    dev = state.lm_x.device
    f32, i32 = torch.float32, torch.int32

    def as_t(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    x, y = as_t(x, f32), as_t(y, f32)
    agent = as_t(agent, torch.int64)
    agent32 = agent.to(i32)
    lm_type = as_t(lm_type, i32)
    valid = as_t(valid, torch.bool)
    idx = state.n_nodes
    L = state.lm_x.shape[0]
    slots = torch.arange(L, dtype=i32, device=dev)
    has_lm = (lm_type != 0) & valid

    # the first-match closure test (ref :292-326)
    last_cl_agent = state.last_closure_node[agent]
    match = (slots < torch.clamp_max(state.lm_count, L)) & \
        (state.lm_type == lm_type) & \
        ((idx - state.lm_node) >= cfg.min_poses_between) & \
        (((x - state.lm_x) ** 2 + (y - state.lm_y) ** 2)
         < cfg.closure_radius_m ** 2) & \
        ((idx - last_cl_agent) >= cfg.min_poses_between) & has_lm
    if cfg.closure_same_agent_only:
        match = match & (state.lm_agent == agent32)
    closed = match.any()
    first = torch.argmin(torch.where(match, slots, torch.full_like(slots, L)))
    zero = torch.zeros((), dtype=f32, device=dev)
    cdx = torch.where(closed, (state.lm_x[first] - x)
                      * cfg.closure_correction, zero)
    cdy = torch.where(closed, (state.lm_y[first] - y)
                      * cfg.closure_correction, zero)

    def put(buf, slot, keep, val):
        """buf with buf[slot] = val where `keep` (a copy)."""
        out = buf.clone()
        out[slot] = torch.where(keep, torch.as_tensor(val, dtype=buf.dtype,
                                                      device=dev), buf[slot])
        return out

    last_cl = put(state.last_closure_node, agent, closed, idx)
    drift_dx = state.drift_dx.clone()
    drift_dx[agent] = state.drift_dx[agent] + torch.where(closed, cdx, zero)
    drift_dy = state.drift_dy.clone()
    drift_dy[agent] = state.drift_dy[agent] + torch.where(closed, cdy, zero)

    # the closure log (ring buffer)
    cslot = torch.remainder(state.cl_count, state.cl_node.shape[0]).long()
    log = {f: put(getattr(state, f), cslot, closed, v) for f, v in (
        ("cl_lm_node", state.lm_node[first]), ("cl_node", idx),
        ("cl_dx", cdx), ("cl_dy", cdy), ("cl_agent", agent32),
        ("cl_mx", 0.0), ("cl_my", 0.0), ("cl_mth", 0.0), ("cl_fit", -1.0))}

    # the landmark append AFTER matching (ref :288)
    lslot = torch.remainder(state.lm_count, L).long()
    ring = {f: put(getattr(state, f), lslot, has_lm, v) for f, v in (
        ("lm_x", x), ("lm_y", y), ("lm_type", lm_type), ("lm_node", idx),
        ("lm_agent", agent32), ("lm_yaw", 0.0 if yaw is None else yaw))}
    lm_scan = state.lm_scan
    if scan is not None and cfg.closure_scanmatch:
        lm_scan = put(lm_scan, lslot, has_lm, as_t(scan, lm_scan.dtype))

    new = state._replace(
        **ring, lm_scan=lm_scan, lm_count=state.lm_count + has_lm.to(i32),
        n_nodes=idx + valid.to(i32), last_closure_node=last_cl,
        drift_dx=drift_dx, drift_dy=drift_dy, **log,
        cl_count=state.cl_count + closed.to(i32))
    return new, closed, cdx, cdy


# id(result) -> (result, index [M] int64 (len(buf) where dropped), values,
# the buffer before) of every ring write since the last clear: the check
# reads them to accept any one of the rows that share a slot
RING_WRITES = {}


def _ring_put(buf, slot, vals, keep):
    """buf[slot[keep]] = vals[keep] on a copy — the reference's
    `.at[slot].set(vals, mode="drop")`, whose winner among rows that share
    a slot is unspecified. Here the last row wins (`_set_last_wins`), and
    the write is logged in RING_WRITES. Dropped rows land on a spare row
    that is cut off again."""
    n = buf.shape[0]
    idx = torch.where(keep, slot.to(torch.int64),
                      torch.full_like(slot, n, dtype=torch.int64))
    out = _set_last_wins(torch.cat([buf, buf[:1]]), idx, vals)[:n]
    RING_WRITES[id(out)] = (out, idx, vals.to(buf.dtype), buf)
    return out


def _set_last_wins(buf, idx, vals):
    """buf.at[idx].set(vals, mode="drop") on a copy, as XLA applies it on
    the CPU: where rows share an index, the last in row order wins. The
    winner of each index is the `amax` of the row numbers that target it
    (no host read; `index_copy_` leaves the winner of a repeated index
    unspecified on the card). An index equal to len(buf) lands on a spare
    slot that is cut off, so an empty buf takes index 0."""
    n = buf.shape[0]
    rows = torch.arange(idx.shape[0], device=buf.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=buf.device) \
        .scatter_reduce(0, idx.to(torch.int64), rows, "amax")[:n]
    won = (last >= 0).view((n,) + (1,) * (buf.dim() - 1))
    return torch.where(won, vals.to(buf.dtype)[last.clamp_min(0)], buf)


def closure_add_poses_batch(state: ClosureState, xs, ys, agents, lm_types,
                            cfg: SlamConfig = SlamConfig(), valid=None,
                            yaws=None, scans=None, grid=None, sens=None):
    """Throughput-mode closure for one step's packets [M] (distinct agents).
    Returns (new_state, closed [M] bool, cdx [M], cdy [M]).

    With `cfg.closure_scanmatch` and scans [M, R] given (grid and sens
    then required), stored landmarks remember yaw and sweep, fired
    closures are measured and the proximity pairs run (module docstring).

    The per-agent guards follow the reference's scatter
    (swarm_tpu/slam/closure.py:289-291): a valid row sets its agent's
    `last_closure_node` to its node where it closed and to the old value
    where it did not; a row with valid False sets agent 0's OLD value on
    agent 0; where rows meet on one agent, the last in row order wins. So
    a closure of agent 0 is undone by any later invalid row of the batch
    (ROADMAP Queue C7). Invalid rows add 0 to the drift."""
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
    snap = None
    if cfg.closure_cross_radius_m > 0 and cfg.closure_scanmatch:
        # rendezvous: another agent's landmark within the cross radius, no
        # type equality, no time gap; lower priority than the intra term,
        # and it never snaps (swarm_tpu/slam/closure.py:254-275)
        other = state.lm_agent[None, :] != agents[:, None]
        near_x = d2 < cfg.closure_cross_radius_m ** 2
        cross = occupied[None, :] & other & near_x & \
            (agent_ok & has_lm)[:, None]
        snap = match.any(dim=1)
        match = torch.where(snap[:, None], match, cross)

    closed = match.any(dim=1)
    if snap is None:
        snap = closed
    first = torch.argmin(torch.where(match, slots[None, :],
                                     torch.full_like(match, L,
                                                     dtype=torch.int32)),
                         dim=1)
    mx = state.lm_x[first]
    my = state.lm_y[first]
    zero = torch.zeros_like(xs)
    cdx = torch.where(snap, (mx - xs) * cfg.closure_correction, zero)
    cdy = torch.where(snap, (my - ys) * cfg.closure_correction, zero)

    safe = torch.where(valid, ag, torch.zeros_like(ag))
    last_cl = _set_last_wins(
        state.last_closure_node, safe,
        torch.where(closed, idxs, state.last_closure_node[safe]))
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

    measure_on = cfg.closure_scanmatch and scans is not None
    if measure_on and (grid is None or sens is None):
        raise ValueError("closure_scanmatch with scans needs grid and sens "
                         "to measure the closures")
    pair_on = (measure_on and cfg.closure_pair_budget > 0
               and cfg.closure_cross_radius_m > 0)
    last_pair = state.last_pair_node
    if pair_on:
        pi, pj, att2 = _pair_candidates(xs, ys, agents, idxs, valid,
                                        last_pair, cfg)
    # the reference's two lax.cond gates, read from the host together
    run_match, run_pair = (torch.stack([
        closed.any(), att2.any() if pair_on else closed.new_zeros(())
    ]).tolist() if measure_on else (False, False))

    # scan-matched edge measurement of the <= closure_match_budget closed
    # packets (stable argsort puts them first); unmeasured edges log
    # measurement 0 and fitness -1
    mx_v, my_v, mth_v, fit_v = zero, zero, zero, zero - 1.0
    if run_match:
        from benchmark.reference.slam.closurematch import match_scan_pairs_batch
        K = min(M, max(1, cfg.closure_match_budget))
        sel = torch.argsort((~closed).to(torch.uint8), stable=True)[:K]
        f_sel = torch.clamp_max(first, L - 1)[sel]
        m, meas = match_scan_pairs_batch(
            scans[sel], (xs[sel], ys[sel], yaws[sel]), state.lm_scan[f_sel],
            (state.lm_x[f_sel], state.lm_y[f_sel], state.lm_yaw[f_sel]),
            cfg, grid, sens)
        ok = m.ok & closed[sel]

        def put(fill, v):
            return torch.full_like(xs, fill).index_copy(
                0, sel, torch.where(ok, v, torch.full_like(v, fill)))
        mx_v = put(0.0, meas[:, 0])
        my_v = put(0.0, meas[:, 1])
        mth_v = put(0.0, meas[:, 2])
        fit_v = put(-1.0, m.fitness)
    cl_mx = _ring_put(state.cl_mx, cslot, mx_v, closed)
    cl_my = _ring_put(state.cl_my, cslot, my_v, closed)
    cl_mth = _ring_put(state.cl_mth, cslot, mth_v, closed)
    cl_fit = _ring_put(state.cl_fit, cslot, fit_v, closed)

    if pair_on:
        # proximity pairs: agent j's current sweep is the window, agent i's
        # is matched into it; verified edges append after this step's
        # regular edges, in pair order (swarm_tpu/slam/closure.py:357-420)
        k2 = pi.shape[0]
        ok2 = torch.zeros((k2,), dtype=torch.bool, device=dev)
        z2 = torch.zeros((k2,), dtype=xs.dtype, device=dev)
        pmx = pmy = pmth = pfit = z2
        if run_pair:
            from benchmark.reference.slam.closurematch import \
                match_scan_pairs_batch
            m2, meas2 = match_scan_pairs_batch(
                scans[pi], (xs[pi], ys[pi], yaws[pi]),
                scans[pj], (xs[pj], ys[pj], yaws[pj]), cfg, grid, sens)
            ok2 = m2.ok & m2.distinct & att2
            pmx, pmy, pmth, pfit = meas2[:, 0], meas2[:, 1], meas2[:, 2], \
                m2.fitness
        p_i = ok2.to(torch.int32)
        pslot = torch.remainder(cl_count + torch.cumsum(p_i, 0) - p_i, C)
        cl_lm_node = _ring_put(cl_lm_node, pslot, idxs[pj], ok2)
        cl_node = _ring_put(cl_node, pslot, idxs[pi], ok2)
        cl_dx = _ring_put(cl_dx, pslot, z2, ok2)
        cl_dy = _ring_put(cl_dy, pslot, z2, ok2)
        cl_agent = _ring_put(cl_agent, pslot, agents[pi], ok2)
        cl_mx = _ring_put(cl_mx, pslot, pmx, ok2)
        cl_my = _ring_put(cl_my, pslot, pmy, ok2)
        cl_mth = _ring_put(cl_mth, pslot, pmth, ok2)
        cl_fit = _ring_put(cl_fit, pslot, torch.where(ok2, pfit, z2 - 1.0),
                           ok2)
        cl_count = cl_count + p_i.sum().to(torch.int32)
        # the cooldown consumes on ATTEMPT; a scatter-max keeps the newest
        # (the reference's `.at[psl].max(pn, mode="drop")`, its dropped
        # rows on a spare row)
        n_ag = last_pair.shape[0]
        att = torch.cat([att2, att2])
        pa = torch.cat([agents[pi], agents[pj]]).to(torch.int64)
        pn = torch.cat([idxs[pi], idxs[pj]]).to(last_pair.dtype)
        psl = torch.where(att, pa, torch.full_like(pa, n_ag))
        pn = torch.where(att, pn, torch.full_like(pn, NEG_NODE))
        spare = torch.cat([last_pair, last_pair.new_full((1,), NEG_NODE)])
        last_pair = spare.scatter_reduce(0, psl, pn, "amax")[:n_ag]

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
    lm_scan = state.lm_scan
    if scans is not None and cfg.closure_scanmatch:
        lm_scan = _ring_put(lm_scan, lslot, scans, has_lm)
    lm_count = state.lm_count + hi.sum().to(torch.int32)

    new = ClosureState(
        lm_x=lm_x, lm_y=lm_y, lm_type=lm_t, lm_node=lm_n, lm_agent=lm_a,
        lm_count=lm_count, n_nodes=base + vi.sum().to(torch.int32),
        last_closure_node=last_cl, drift_dx=drift_dx, drift_dy=drift_dy,
        cl_lm_node=cl_lm_node, cl_node=cl_node, cl_dx=cl_dx, cl_dy=cl_dy,
        cl_agent=cl_agent, cl_count=cl_count,
        lm_yaw=lm_yaw, lm_scan=lm_scan,
        cl_mx=cl_mx, cl_my=cl_my, cl_mth=cl_mth, cl_fit=cl_fit,
        last_pair_node=last_pair)
    return new, closed, cdx, cdy


def _pair_candidates(xs, ys, agents, idxs, valid, last_pair,
                     cfg: SlamConfig):
    """The K2 closest pairs (i < j) of live, cooled-down agents within the
    cross radius: (pi [K2], pj [K2], att2 [K2] bool). The reference's
    `top_k` over the flat [M*M] negative squared distances takes the
    lower flat index first among equal values, and so does the stable
    descending sort here; -inf pads when fewer pairs qualify (att2
    False)."""
    M = xs.shape[0]
    k2 = min(cfg.closure_pair_budget, max(1, M // 2))
    d2p = (xs[:, None] - xs[None, :]) ** 2 + (ys[:, None] - ys[None, :]) ** 2
    cool = (idxs - last_pair[agents.long()]) >= cfg.closure_pair_cooldown
    ar = torch.arange(M, device=xs.device)
    cand = valid[:, None] & valid[None, :] & cool[:, None] & \
        cool[None, :] & (ar[:, None] < ar[None, :]) & \
        (d2p < cfg.closure_cross_radius_m ** 2)
    neg = torch.where(cand, -d2p, torch.full_like(d2p, float("-inf")))
    top_v, top_i = torch.sort(neg.reshape(-1), descending=True,
                              stable=True)
    top_v, top_i = top_v[:k2], top_i[:k2]
    return (torch.div(top_i, M, rounding_mode="floor"), top_i % M,
            top_v > float("-inf"))


# packet rows x landmark slots matched at once by closure_add_poses_seq
SEQ_CHUNK = 1 << 21


def _last_append(count0, n_before, cap: int, slots):
    """Ring appends numbered 0, 1, ... land at (count0 + q) mod cap. For
    each row's n_before [M] earlier appends and each slot [S]: the number
    of the last one that landed on the slot, or a negative value where
    none did. [M, S] int64."""
    n = n_before.to(torch.int64)[:, None]
    return n - 1 - torch.remainder(count0.to(torch.int64) + n - 1 - slots,
                                   cap)


def _ring_appends(count0, keep, cap: int):
    """Where appending the kept packets in order at (count0 + q) mod cap
    leaves each slot, the later append winning it (the reference's
    sequential `.set`): (written [cap] bool, the packet that wrote it
    [cap]). `put(buf, vals)` applies them to a buffer of `cap` rows."""
    incl = torch.cumsum(keep.to(torch.int64), 0)
    slots = torch.arange(cap, device=keep.device)
    q = _last_append(count0, incl[-1:], cap, slots)[0]
    src = torch.searchsorted(incl, torch.clamp_min(q, 0), right=True)
    written, src = q >= 0, torch.clamp_max(src, keep.shape[0] - 1)

    def put(buf, vals):
        return torch.where(written, vals.to(buf.dtype)[src], buf)
    return put


class SeqMatch(NamedTuple):
    """What `seq_match` finds for packets [M]: node index, landmark flag,
    closure, the matched landmark's node and the correction."""
    idxs: torch.Tensor      # [M] int32
    has_lm: torch.Tensor    # [M] bool
    closed: torch.Tensor    # [M] bool
    mnode: torch.Tensor     # [M] int32
    cdx: torch.Tensor       # [M]
    cdy: torch.Tensor       # [M]


def seq_match(state: ClosureState, xs, ys, agents, lm_types,
              cfg: SlamConfig = SlamConfig(), valid=None) -> SeqMatch:
    """The closure test of the reference's sequential `closure_add_pose`
    for packets [M], each against the ring as the packets before it left
    it, and each agent's guard and drift as `state` holds them. A closure
    changes only its agent's guard and drift, so the result is exact for
    every packet before the first one whose agent closed earlier in the
    batch; for packets of distinct agents, for all of them."""
    M = xs.shape[0]
    dev = xs.device
    if valid is None:
        valid = torch.ones((M,), dtype=torch.bool, device=dev)
    i32 = torch.int32
    vi = valid.to(i32)
    idxs = state.n_nodes + torch.cumsum(vi, 0).to(i32) - vi
    has_lm = (lm_types != 0) & valid
    hi = has_lm.to(torch.int64)
    incl = torch.cumsum(hi, 0)
    before = incl - hi                      # appends before each packet
    L = state.lm_x.shape[0]
    slots = torch.arange(L, device=dev)
    agent_ok = (idxs - state.last_closure_node[agents.long()]) >= \
        cfg.min_poses_between
    # the landmark each packet would append (read where it is the writer)
    new = dict(x=xs, y=ys, t=lm_types.to(i32), n=idxs,
               a=agents.to(i32))
    old = dict(x=state.lm_x, y=state.lm_y, t=state.lm_type,
               n=state.lm_node, a=state.lm_agent)
    closed = torch.zeros((M,), dtype=torch.bool, device=dev)
    mx, my, mnode = (torch.zeros_like(xs), torch.zeros_like(ys),
                     torch.zeros((M,), dtype=i32, device=dev))
    rows = max(1, SEQ_CHUNK // L)
    for a in range(0, M, rows):
        sl = slice(a, min(M, a + rows))
        q = _last_append(state.lm_count, before[sl], L, slots)
        src = torch.searchsorted(incl, torch.clamp_min(q, 0), right=True)
        src = torch.clamp_max(src, M - 1)
        mine = q >= 0
        ring = {f: torch.where(mine, new[f][src], old[f][None, :])
                for f in new}
        occupied = slots[None, :] < torch.clamp_max(
            state.lm_count.to(torch.int64) + before[sl], L)[:, None]
        d2 = (xs[sl, None] - ring["x"]) ** 2 + (ys[sl, None] - ring["y"]) ** 2
        match = occupied & (ring["t"] == lm_types[sl, None]) & \
            ((idxs[sl, None] - ring["n"]) >= cfg.min_poses_between) & \
            (d2 < cfg.closure_radius_m ** 2) & \
            (agent_ok[sl] & has_lm[sl])[:, None]
        if cfg.closure_same_agent_only:
            match = match & (ring["a"] == agents[sl, None])
        closed[sl] = match.any(dim=1)
        f = torch.argmin(torch.where(match, slots[None, :],
                                     torch.full_like(slots, L)[None, :]),
                         dim=1)
        pick = f[:, None]
        mx[sl] = ring["x"].gather(1, pick)[:, 0]
        my[sl] = ring["y"].gather(1, pick)[:, 0]
        mnode[sl] = ring["n"].gather(1, pick)[:, 0]
    zero = torch.zeros_like(xs)
    cdx = torch.where(closed, (mx - xs) * cfg.closure_correction, zero)
    cdy = torch.where(closed, (my - ys) * cfg.closure_correction, zero)
    return SeqMatch(idxs=idxs, has_lm=has_lm, closed=closed, mnode=mnode,
                    cdx=cdx, cdy=cdy)


def seq_apply(state: ClosureState, m: SeqMatch, xs, ys, agents, lm_types,
              valid) -> ClosureState:
    """The state after packets [M] whose tests `seq_match` made: guards
    and drift of the closing packets' agents, the closure log and the
    landmark ring appended in packet order (scalar path: unmeasured
    edges, no remembered yaw or sweep). Agents may repeat where no packet
    follows a closure of its own agent."""
    i32 = torch.int32
    ag = agents.long()
    closed = m.closed
    zero = torch.zeros_like(xs)
    last_cl = state.last_closure_node.scatter_reduce(
        0, ag, torch.where(closed, m.idxs,
                           torch.full_like(m.idxs, NEG_NODE)), "amax")
    drift_dx = state.drift_dx.index_add(0, ag, torch.where(closed, m.cdx,
                                                           zero))
    drift_dy = state.drift_dy.index_add(0, ag, torch.where(closed, m.cdy,
                                                           zero))
    L = state.lm_x.shape[0]
    log = _ring_appends(state.cl_count, closed, state.cl_node.shape[0])
    ring_put = _ring_appends(state.lm_count, m.has_lm, L)
    return ClosureState(
        lm_x=ring_put(state.lm_x, xs), lm_y=ring_put(state.lm_y, ys),
        lm_type=ring_put(state.lm_type, lm_types),
        lm_node=ring_put(state.lm_node, m.idxs),
        lm_agent=ring_put(state.lm_agent, agents),
        lm_count=state.lm_count + m.has_lm.sum().to(i32),
        n_nodes=state.n_nodes + valid.sum().to(i32),
        last_closure_node=last_cl, drift_dx=drift_dx, drift_dy=drift_dy,
        cl_lm_node=log(state.cl_lm_node, m.mnode),
        cl_node=log(state.cl_node, m.idxs), cl_dx=log(state.cl_dx, m.cdx),
        cl_dy=log(state.cl_dy, m.cdy), cl_agent=log(state.cl_agent, agents),
        cl_count=state.cl_count + closed.sum().to(i32),
        lm_yaw=ring_put(state.lm_yaw, zero), lm_scan=state.lm_scan,
        cl_mx=log(state.cl_mx, zero), cl_my=log(state.cl_my, zero),
        cl_mth=log(state.cl_mth, zero), cl_fit=log(state.cl_fit, zero - 1.0),
        last_pair_node=state.last_pair_node)


def closure_add_poses_seq(state: ClosureState, xs, ys, agents, lm_types,
                          cfg: SlamConfig = SlamConfig(), valid=None):
    """The reference's sequential closure, `closure_add_pose` applied to
    the packets [M] one after another (the parity step's `lax.scan`,
    swarm_tpu/engine/sim.py:652-659), for packets of distinct agents.
    Returns (new_state, closed [M] bool, cdx [M], cdy [M]); every field
    equals the scan's.

    Packet j sees the ring as the earlier packets left it: a slot last
    written by an earlier packet of the batch holds that packet's
    landmark, and slot s counts as occupied when s < min(lm_count_j, L).
    Rows are matched SEQ_CHUNK row-slot pairs at a time. With
    `cfg.closure_scanmatch` the edges stay unmeasured and no sweep is
    stored: the reference's parity step passes `closure_add_pose` no scan
    (swarm_tpu/engine/sim.py:652-657)."""
    if valid is None:
        valid = torch.ones(xs.shape, dtype=torch.bool, device=xs.device)
    m = seq_match(state, xs, ys, agents, lm_types, cfg, valid)
    new_state = seq_apply(state, m, xs, ys, agents, lm_types, valid)
    return new_state, m.closed, m.cdx, m.cdy
