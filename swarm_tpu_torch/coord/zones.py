"""Territory zones: per-agent running AABBs of mapped area
(swarm_tpu/coord/zones.py `zone_init`, `zone_observe`,
`zone_observe_batch`, `zone_observe_rows`, `zones_for_agents`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

# the reference's lifted (inactive) zone box (dual_bot_mapper.py:681)
LIFT = (999.0, 999.0, -999.0, -999.0)


class ZoneState(NamedTuple):
    """Running per-agent territory AABBs over hits + path, [N] leaves."""
    min_x: torch.Tensor
    min_y: torch.Tensor
    max_x: torch.Tensor
    max_y: torch.Tensor
    has_any: torch.Tensor  # bool


def zone_init(n_agents: int, device=None) -> ZoneState:
    big = torch.full((n_agents,), float("inf"), dtype=torch.float32,
                     device=device)
    return ZoneState(min_x=big, min_y=big.clone(), max_x=-big, max_y=-big,
                     has_any=torch.zeros((n_agents,), dtype=torch.bool,
                                         device=device))


def zone_observe(z: ZoneState, agent, xs, ys, valid) -> ZoneState:
    """Fold one agent's points (xs, ys, valid [...]) into its running
    AABB; `agent` is an int or a 0-d tensor."""
    inf = torch.full_like(xs, float("inf"))
    a = torch.as_tensor(agent, device=xs.device).long().reshape(1)

    def fold(buf, v, op):
        return buf.index_copy(0, a, op(buf[a], v.reshape(1)))
    return ZoneState(
        min_x=fold(z.min_x, torch.where(valid, xs, inf).amin(),
                   torch.minimum),
        min_y=fold(z.min_y, torch.where(valid, ys, inf).amin(),
                   torch.minimum),
        max_x=fold(z.max_x, torch.where(valid, xs, -inf).amax(),
                   torch.maximum),
        max_y=fold(z.max_y, torch.where(valid, ys, -inf).amax(),
                   torch.maximum),
        has_any=fold(z.has_any, valid.any(), torch.logical_or))


def zone_observe_batch(z: ZoneState, agents, xs, ys, valid) -> ZoneState:
    """Segment-reduce many agents' points at once; agents [...] int, rows
    that are not valid add nothing."""
    n = z.min_x.shape[0]
    a = torch.where(valid, agents, torch.zeros_like(agents)).reshape(-1) \
        .long()
    inf = torch.full_like(xs, float("inf")).reshape(-1)
    xs, ys, valid = xs.reshape(-1), ys.reshape(-1), valid.reshape(-1)

    def seg(vals, fill, how):
        return torch.full((n,), fill, dtype=vals.dtype,
                          device=vals.device).scatter_reduce(
            0, a, vals, how)
    return ZoneState(
        min_x=torch.minimum(z.min_x, seg(torch.where(valid, xs, inf),
                                         float("inf"), "amin")),
        min_y=torch.minimum(z.min_y, seg(torch.where(valid, ys, inf),
                                         float("inf"), "amin")),
        max_x=torch.maximum(z.max_x, seg(torch.where(valid, xs, -inf),
                                         float("-inf"), "amax")),
        max_y=torch.maximum(z.max_y, seg(torch.where(valid, ys, -inf),
                                         float("-inf"), "amax")),
        has_any=z.has_any | (seg(valid.to(torch.uint8), 0, "amax") > 0))


def zone_observe_rows(z: ZoneState, xs, ys, valid) -> ZoneState:
    """Row-structured fold: row i's points [N, K] all belong to agent i."""
    inf = torch.full_like(xs, float("inf"))
    mnx = torch.amin(torch.where(valid, xs, inf), dim=1)
    mny = torch.amin(torch.where(valid, ys, inf), dim=1)
    mxx = torch.amax(torch.where(valid, xs, -inf), dim=1)
    mxy = torch.amax(torch.where(valid, ys, -inf), dim=1)
    return ZoneState(
        min_x=torch.minimum(z.min_x, mnx), min_y=torch.minimum(z.min_y, mny),
        max_x=torch.maximum(z.max_x, mxx), max_y=torch.maximum(z.max_y, mxy),
        has_any=z.has_any | valid.any(dim=1))


def zones_for_agents(z: ZoneState, agent_xy, online):
    """The ZONE each agent would be sent: the territory of the nearest
    OTHER online agent with any territory; inactive boxes carry the
    reference's 999/-999 lift sentinel. The [N, N] distance block is 4 MiB
    at 1024 agents. Returns (boxes [N, 4], active [N] bool)."""
    n = z.min_x.shape[0]
    cx = (z.min_x + z.max_x) * 0.5
    cy = (z.min_y + z.max_y) * 0.5
    d2 = (agent_xy[:, 0:1] - cx[None, :]) ** 2 + \
        (agent_xy[:, 1:2] - cy[None, :]) ** 2
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    eligible = (online & z.has_any)[None, :] & ~eye
    d2 = torch.where(eligible, d2, torch.full_like(d2, float("inf")))
    other = torch.argmin(d2, dim=1)
    active = eligible.any(dim=1)
    boxes = torch.stack([z.min_x[other], z.min_y[other],
                         z.max_x[other], z.max_y[other]], dim=-1)
    lift = torch.tensor(LIFT, dtype=boxes.dtype, device=boxes.device)
    boxes = torch.where(active[:, None], boxes, lift[None, :])
    return boxes, active
