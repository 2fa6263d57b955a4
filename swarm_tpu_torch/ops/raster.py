"""Tri-state view of the log-odds map (swarm_tpu/ops/raster.py
`tri_state_view`). The step does not build it (nothing on the ported path
reads it); tools and checks call it on demand."""

from __future__ import annotations

import torch

from swarm_tpu_torch.config import GridConfig

OCC_THRESH = 0.3
FREE_THRESH = -0.3


def tri_state_view(logodds, cfg: GridConfig = GridConfig(),
                   occ_thresh: float = OCC_THRESH,
                   free_thresh: float = FREE_THRESH):
    """int8 map: cfg.free where log-odds <= free_thresh, cfg.occupied where
    >= occ_thresh, cfg.unknown elsewhere."""
    out = torch.full(logodds.shape, cfg.unknown, dtype=torch.int8,
                     device=logodds.device)
    out = torch.where(logodds <= free_thresh,
                      torch.full_like(out, cfg.free), out)
    return torch.where(logodds >= occ_thresh,
                       torch.full_like(out, cfg.occupied), out)
