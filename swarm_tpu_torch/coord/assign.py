"""Greedy frontier-to-agent assignment (swarm_tpu/coord/assign.py), in torch.

The reference system ships the algorithm disabled; the engines run it
behind `enable_targets`: each online agent in index order takes its
nearest unused centroid, rejecting centroids within
`frontier_separation_m` of a target already assigned, and (with room
boxes) only centroids inside its own room's box, since an agent drives
straight at its target and cannot leave a closed room.

`greedy_assign` is the reference's sequential scan over agents, as a loop
of device operations with no host read. `greedy_assign_rooms` runs
R = max(agents per room) vectorised rounds instead (the engines take it at
swarm scale); its grouping of agents by room is host work on the room
boxes, done once per rollout by `room_rounds`.
"""

from __future__ import annotations

import numpy as np
import torch

from swarm_tpu_torch.config import CoordConfig

BOX_PAD = 1e-3


def _inside(centroids, boxes):
    """[N, K] bool: centroid k within agent i's box (+- BOX_PAD)."""
    cx, cy = centroids[None, :, 0], centroids[None, :, 1]
    return ((cx >= boxes[:, None, 0] - BOX_PAD) &
            (cx <= boxes[:, None, 2] + BOX_PAD) &
            (cy >= boxes[:, None, 1] - BOX_PAD) &
            (cy <= boxes[:, None, 3] + BOX_PAD))


def greedy_assign(agent_xy, online, centroids, n_centroids,
                  cfg: CoordConfig = CoordConfig(), room_boxes=None):
    """agent_xy [N, 2]; online [N] bool; centroids [K, 2]; n_centroids []
    int; room_boxes [N, 4] (x0, y0, x1, y1) or None. Returns (targets
    [N, 2], has_target [N] bool). Ties in distance go to the lowest
    centroid index, as `argmin` gives them on both sides."""
    n = agent_xy.shape[0]
    k = centroids.shape[0]
    dev = centroids.device
    exists = torch.arange(k, device=dev) < n_centroids
    inside = None
    if room_boxes is not None:
        inside = _inside(centroids, torch.as_tensor(
            room_boxes, dtype=centroids.dtype, device=dev))
    used = torch.zeros((k,), dtype=torch.bool, device=dev)
    tgts = torch.zeros((n, 2), dtype=centroids.dtype, device=dev)
    has = torch.zeros((n,), dtype=torch.bool, device=dev)
    inf = torch.full((k,), float("inf"), dtype=centroids.dtype, device=dev)
    sep2_lim = cfg.frontier_separation_m ** 2
    for i in range(n):
        # separation against the targets already assigned
        sep2 = ((centroids[:, None, :] - tgts[None, :, :]) ** 2).sum(-1)
        too_close = ((sep2 < sep2_lim) & has[None, :]).any(dim=1)
        cand = exists & ~used & ~too_close
        if inside is not None:
            cand = cand & inside[i]
        d2 = ((centroids - agent_xy[i][None, :]) ** 2).sum(-1)
        # a one-element index (a 0-d one would be read on the host)
        best = torch.argmin(torch.where(cand, d2, inf)).reshape(1)
        ok = online[i] & cand.any()
        used.index_put_((best,), used[best] | ok)
        tgts[i] = torch.where(ok, centroids.index_select(0, best)[0],
                              tgts[i])
        has[i] = ok
    return tgts, has


def room_rounds(room_boxes, device):
    """Host grouping for `greedy_assign_rooms`: each agent's rank among the
    agents of its room (rooms told apart by their boxes), as one [N] bool
    mask per round on `device`, and the boxes as a tensor."""
    rb = np.asarray(room_boxes)
    _, room_id = np.unique(rb, axis=0, return_inverse=True)
    room_id = np.asarray(room_id).reshape(-1)
    rank = np.zeros(len(room_id), np.int64)
    next_rank = {}
    for i, r in enumerate(room_id):
        rank[i] = next_rank.get(r, 0)
        next_rank[r] = int(rank[i]) + 1
    masks = [torch.as_tensor(rank == r, device=device)
             for r in range(int(rank.max()) + 1)]
    return masks, torch.as_tensor(rb, dtype=torch.float32, device=device)


def greedy_assign_rooms(agent_xy, online, centroids, n_centroids,
                        cfg: CoordConfig, rounds):
    """Room-parallel greedy assignment: round r assigns every agent of rank
    r in its room at once, the lowest agent index winning a centroid two
    agents claim in one round. Equal to `greedy_assign` with the same boxes
    except at the reference's documented near-wall corner cases
    (swarm_tpu/coord/assign.py:66-93). `rounds` = `room_rounds(room_boxes,
    device)`, the host grouping of the reference's call, made once."""
    dev = centroids.device
    masks, boxes = rounds
    n = agent_xy.shape[0]
    k = centroids.shape[0]
    exists = torch.arange(k, device=dev) < n_centroids
    inside = _inside(centroids, boxes.to(centroids.dtype))
    # targets are always centroids: the separation test is a [K, K] table
    c2 = ((centroids[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    near = c2 < cfg.frontier_separation_m ** 2
    d2_all = ((centroids[None, :, :] - agent_xy[:, None, :]) ** 2).sum(-1)

    used = torch.zeros((k,), dtype=torch.bool, device=dev)
    tgts = torch.zeros((n, 2), dtype=centroids.dtype, device=dev)
    has = torch.zeros((n,), dtype=torch.bool, device=dev)
    agent_ids = torch.arange(n, dtype=torch.int64, device=dev)
    inf = torch.full_like(d2_all, float("inf"))
    for act in masks:
        too_close = (near & used[None, :]).any(dim=1)
        cand = (exists & ~used & ~too_close)[None, :] & inside & \
            act[:, None]
        best = torch.argmin(torch.where(cand, d2_all, inf), dim=1)
        ok = online & act & cand.any(dim=1)
        claim = torch.where(ok, best, torch.full_like(best, k))
        winner = torch.full((k + 1,), n, dtype=torch.int64,
                            device=dev).scatter_reduce(
            0, claim, agent_ids, reduce="amin")
        win = ok & (winner[claim] == agent_ids)
        took = torch.zeros((k + 1,), dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, claim, win.to(torch.int64), reduce="amax")
        used = used | took[:k].to(torch.bool)
        tgts = torch.where(win[:, None], centroids[best], tgts)
        has = has | win
    return tgts, has
