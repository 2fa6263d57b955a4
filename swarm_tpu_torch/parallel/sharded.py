"""Static room geometry the fused step needs from the sharded engine
(swarm_tpu/parallel/sharded.py `agent_evidence_box`, `merge_window_box`).

Only these two numpy functions are ported: the fused step clamps each
agent's scan-merge window into its tile-snapped room box, the same
placement rule the sharded decompositions use (sim.py:771-787). The
sharded engine itself waits for ROADMAP Queue A7.
"""

from __future__ import annotations

import numpy as np

from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.geom.world import TILE_COLS, TILE_ROWS
from swarm_tpu_torch.slam.livemerge import merge_window_side


def agent_evidence_box(walls_grouped, room_of_agent, cfg: SwarmConfig,
                       margin_cells: int = 3,
                       drift_margin_m: float = 1.0):
    """Static per-agent grid (row, col) bounds of possible raster
    evidence: (rmin, rmax, cmin, cmax), each [N] int — the agent's room box
    in cells, padded by `margin_cells` plus `drift_margin_m` (the raster
    origin is the drift-corrected estimate, which walls do not bound).
    numpy; tensors are read through numpy."""
    wg = np.asarray(walls_grouped)
    roa = np.asarray(room_of_agent)
    ys = wg[..., [1, 3]].reshape(wg.shape[0], -1)
    xs = wg[..., [0, 2]].reshape(wg.shape[0], -1)
    res = cfg.grid.resolution
    pad = margin_cells + int(np.ceil(drift_margin_m / res))
    rmin = np.floor((ys.min(1)[roa] - cfg.grid.origin_y) / res) - pad
    rmax = np.ceil((ys.max(1)[roa] - cfg.grid.origin_y) / res) + pad
    cmin = np.floor((xs.min(1)[roa] - cfg.grid.origin_x) / res) - pad
    cmax = np.ceil((xs.max(1)[roa] - cfg.grid.origin_x) / res) + pad
    return (rmin.astype(int), rmax.astype(int),
            cmin.astype(int), cmax.astype(int))


def merge_window_box(walls_grouped, room_of_agent, cfg: SwarmConfig):
    """Static per-agent clamp box for scan-merge window placement: the
    room evidence box (no drift margin) snapped outward to the
    [TILE_ROWS, TILE_COLS] raster-tile lattice and clipped to the grid.
    (rmin, rmax, cmin, cmax), each [N] int. The window stays agent-centred;
    the box binds only within side//2 of a tile edge."""
    side = merge_window_side(cfg)
    rmin, rmax, cmin, cmax = agent_evidence_box(
        walls_grouped, room_of_agent, cfg, margin_cells=3,
        drift_margin_m=0.0)
    size = cfg.grid.size
    rmin = np.maximum((rmin // TILE_ROWS) * TILE_ROWS, 0)
    rmax = np.minimum(-(-rmax // TILE_ROWS) * TILE_ROWS, size)
    cmin = np.maximum((cmin // TILE_COLS) * TILE_COLS, 0)
    cmax = np.minimum(-(-cmax // TILE_COLS) * TILE_COLS, size)
    if ((rmax - rmin) < side).any() or ((cmax - cmin) < side).any():
        raise ValueError(
            f"an agent's tile-snapped room box is smaller than the "
            f"{side}-cell scan-merge window; shrink "
            "slam.merge_window_cells / merge_search_cells")
    return rmin, rmax, cmin, cmax
