"""Integer Bresenham ray traversal (swarm_tpu/ops/bresenham.py), in torch.

Every ray of a batch walks in lockstep for K fixed steps: the reference's
`lax.scan` over K becomes a Python loop over K on batched int32 tensors,
producing [..., K] cell coordinates plus masks. The classic error-update
variant emits exactly chebyshev(dx, dy) + 1 cells per ray; rays longer
than K are truncated.
"""

from __future__ import annotations

import torch

DEFAULT_K = 32


def chebyshev_cells(x0, y0, x1, y1):
    """Number of cells Bresenham visits for each ray."""
    return torch.maximum(torch.abs(x1 - x0), torch.abs(y1 - y0)) + 1


def bresenham_cells(x0, y0, x1, y1, k_max: int = DEFAULT_K):
    """Trace all rays at once. x0..y1: int32 [...] start / end cells.
    Returns (cells_x [..., K], cells_y [..., K], valid [..., K],
    is_endpoint [..., K]): `valid` marks the cells really visited and
    `is_endpoint` the last cell of each ray."""
    dx = torch.abs(x1 - x0)
    dy = torch.abs(y1 - y0)
    one = torch.ones_like(x0)
    sx = torch.where(x0 < x1, one, -one)
    sy = torch.where(y0 < y1, one, -one)
    zero = torch.zeros_like(x0)
    x, y, err = x0, y0, dx - dy
    done = torch.zeros_like(x0, dtype=torch.bool)
    cx, cy, valid, endpoint = [], [], [], []
    for _ in range(k_max):
        at_end = (x == x1) & (y == y1)
        emit_valid = ~done
        cx.append(x)
        cy.append(y)
        valid.append(emit_valid)
        endpoint.append(at_end & emit_valid)
        e2 = 2 * err
        step_x = (e2 > -dy) & ~at_end
        step_y = (e2 < dx) & ~at_end
        err = err - torch.where(step_x, dy, zero) + \
            torch.where(step_y, dx, zero)
        x = x + torch.where(step_x, sx, zero)
        y = y + torch.where(step_y, sy, zero)
        done = done | at_end
    return (torch.stack(cx, -1), torch.stack(cy, -1), torch.stack(valid, -1),
            torch.stack(endpoint, -1))
