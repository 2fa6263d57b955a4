"""The r1 exact per-beam raster: a CUDA kernel for Hopper and its plain torch
version.

Replaces `swarm_tpu/ops/beam_raster_pallas.py::_kernel` (:235-302, entry
point `beam_raster_pallas` :900-959). No engine path calls it; it is the
exact hit/miss model the fast tiers were measured against
(`beam_raster_reference`, swarm_tpu/ops/beam_raster.py:237). Per agent,
over its aligned [64, 256] window (`patch_dims` at the default 26-cell
reach, no strips), every cell takes the evidence of its nearest beam:
`b = round(rel / dtheta)` (half to even; the jitted reference multiplies by
the float32 reciprocal), wrapped (4-way fan) or clipped (scan), the on-beam
test `|r sin(rel - b dtheta)| <= 0.6`, `near` within the agent's longest
range over all its beams plus one cell, then HIT (`|r - rb| <= 0.71` on a
trusted beam) over FREE (`r < rb - 0.5`), times `active`; the ranges are
unquantized float32 cells. The window is clipped to [-clamp, clamp] after
each agent (a NaN stays NaN, as under `jnp.clip`), agents in index order
(the TPU kernel's sequential grid; ROADMAP C2: `beam_raster_reference`
clips once after the sum). The grid is float32
only, as the TPU kernel's float32 scratch window implies; there is no
counter (the reference returns the grid alone).

The sine is periodic, so a cell of the wrapped fan whose bin was negative
before the floor-mod still tests its residual correctly here: the right and
back beams are painted, unlike the grouped and per-beam tiers (C16).

What bounds it on the H100: the bytes the function needs, the windows'
covered cells read once and the changed cells written once (~0.02 ms at
1024 agents on a 4096^2 grid), against a long dependent chain per
evaluated cell (the radius, the atan2 polynomial, a floor-mod, a sine).
The design (csrc/exact_raster.cu) is the window raster's since its
redesign: owner-computes 64 x 128 tiles updated in place in the grid, the
(agent, tile) pairs sorted by (tile, agent), each agent's [B, 2] table
prefetched into shared memory with cp.async (the TPU kernel's loop over
beams is a Mosaic workaround for a gather), only the cells of each agent's
evaluation box evaluated (`evaluation_box`, proved on the CPU in
tests/test_torch_raster_box.py), and on a tile whose values are all clean
only those cells visited.

`beam_raster` dispatches on where the grid lies: a CPU tensor goes to
`beam_raster_plain`; a CUDA tensor launches the kernel or raises.
`beam_raster.launches` counts kernel launches and nothing else;
`beam_raster.launches_by_form` splits them by fan (`scan`, `wrapped`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from swarm_tpu_torch import trace
from swarm_tpu_torch._device import recip32
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.ops import cuda_build
from swarm_tpu_torch.ops.beam_raster import BeamSpec, patch_dims, patch_origin
from swarm_tpu_torch.ops.beam_raster_cuda import (BOX_RADIUS, TILE_C,
                                                  _atan2_poly, _tile_pairs,
                                                  cells_of, sector_box)
from swarm_tpu_torch.utils.angles import jmod

MAX_BEAMS = 1024       # csrc MAX_BEAMS: beams per agent table

_SOURCE = cuda_build.source("exact_raster")


class _Exact(NamedTuple):
    """Per-agent launch data (what beam_raster_pallas packs into its
    origins / meta / table operands)."""
    row0: torch.Tensor       # [N] int32 window origin
    col0: torch.Tensor
    ax: torch.Tensor         # [N] f32 agent position in cells
    ay: torch.Tensor
    yaw: torch.Tensor
    act: torch.Tensor        # [N] f32 0/1
    max_reach: torch.Tensor  # [N] f32 longest range over all beams, cells
    table: torch.Tensor      # [N, B, 2] f32 (range in cells, trusted 0/1)
    rows: int
    cols: int


def form_name(spec: BeamSpec) -> str:
    """The launch-count key of a fan: `wrapped` (4-way) or `scan`."""
    return "wrapped" if spec.wrap else "scan"


def _check_supported(logodds, spec: BeamSpec):
    if logodds.dtype != torch.float32:
        raise ValueError(f"the exact raster takes a float32 grid (the "
                         f"reference's window is float32), got "
                         f"{logodds.dtype}")
    size = logodds.shape[0]
    if logodds.shape != (size, size) or size % TILE_C:
        raise ValueError(f"grid must be square with a side divisible by "
                         f"{TILE_C}, got {tuple(logodds.shape)}")
    if spec.n_beams > MAX_BEAMS:
        raise ValueError(f"{spec.n_beams} beams exceed the kernel's "
                         f"{MAX_BEAMS}-beam table")


def _windows(logodds, agent_xy, yaw, dist_m, trusted, active,
             cfg: GridConfig) -> _Exact:
    size = logodds.shape[0]
    rows, cols = patch_dims(size)
    ax, ay = cells_of(agent_xy, cfg)
    row0, col0 = patch_origin(ax, ay, size, rows, cols)
    cells = (dist_m * recip32(cfg.resolution)).to(torch.float32)
    table = torch.stack([cells, trusted.to(torch.float32)], dim=-1)
    return _Exact(row0=row0, col0=col0, ax=ax, ay=ay,
                  yaw=yaw.to(torch.float32), act=active.to(torch.float32),
                  max_reach=cells.amax(dim=-1), table=table, rows=rows,
                  cols=cols)


def evaluation_box(w: _Exact, spec: BeamSpec):
    """The cells the kernel evaluates for each agent, as
    csrc/exact_raster.cu computes them: raster_common.cuh `evaluation_box`
    for the radius `max_reach + 1` and one bin per beam
    (`beam_raster_cuda.sector_box`). No cell outside it takes evidence
    (the kernel's source note); the kernel intersects it with the window
    and the tile. Returns (row_lo, row_hi, col_lo, col_hi) [N] float32,
    upper bounds exclusive. Only tests and chip_smoke.py call it."""
    return sector_box(w.max_reach + BOX_RADIUS, w.ax, w.ay, w.yaw, spec,
                      spec.n_beams)


# --------------------------------------------------------------------------
# plain torch version


def _bins(w: _Exact, spec: BeamSpec):
    """Every window cell's distance r, nearest beam b (wrapped or clipped),
    fan test and residual bearing `rel - b dtheta`, each [N, rows, cols]:
    the kernel's steps 1-3 and 5, op for op."""
    dev = w.ax.device
    rr = torch.arange(w.rows, dtype=torch.int32, device=dev)[None, :, None]
    cc = torch.arange(w.cols, dtype=torch.int32, device=dev)[None, None, :]
    cy = (w.row0[:, None, None] + rr).to(torch.float32) + 0.5
    cx = (w.col0[:, None, None] + cc).to(torch.float32) + 0.5
    dx = cx - w.ax[:, None, None]
    dy = cy - w.ay[:, None, None]
    r = torch.sqrt(dx * dx + dy * dy)
    theta = _atan2_poly(dy, dx)
    rel = theta - w.yaw[:, None, None] - spec.theta0
    rel = jmod(rel + math.pi, 2 * math.pi) - math.pi
    b = torch.round(rel * recip32(spec.dtheta)).to(torch.int32)
    if spec.wrap:
        b = torch.remainder(b, spec.n_beams)
        in_fan = torch.ones_like(r, dtype=torch.bool)
    else:
        in_fan = (b >= 0) & (b < spec.n_beams)
        b = torch.clamp(b, 0, spec.n_beams - 1)
    return r, b, in_fan, rel - b.to(torch.float32) * spec.dtheta


def _deltas(w: _Exact, spec: BeamSpec, cfg: GridConfig):
    """Evidence delta [N, rows, cols] of every agent's window, vectorised
    over agents: the kernel's per-cell math, op for op."""
    n = w.ax.shape[0]
    r, b, in_fan, resid = _bins(w, spec)
    idx = b.reshape(n, -1).to(torch.int64)
    rb = torch.gather(w.table[..., 0], 1, idx).reshape(b.shape)
    tb = torch.gather(w.table[..., 1], 1, idx).reshape(b.shape)
    on_beam = torch.abs(r * torch.sin(resid)) <= 0.6
    near = (r > 1e-3) & (r <= w.max_reach[:, None, None] + 1.0) & in_fan & \
        on_beam
    free = near & (r < rb - 0.5)
    occ = near & (tb > 0.5) & (torch.abs(r - rb) <= 0.71)
    zero = torch.zeros_like(r)
    return torch.where(occ, torch.full_like(r, cfg.logodds_hit),
                       torch.where(free, torch.full_like(r, cfg.logodds_miss),
                                   zero)) * w.act[:, None, None]


def beam_raster_plain(logodds, agent_xy, yaw, dist_m, trusted, active,
                      spec: BeamSpec, cfg: GridConfig = GridConfig()):
    """The exact raster in plain torch: deltas vectorised over [N, rows,
    cols], then applied window by window in agent index order, each window
    clipped after its agent. Updates `logodds` IN PLACE and returns it."""
    _check_supported(logodds, spec)
    w = _windows(logodds, agent_xy, yaw, dist_m, trusted, active, cfg)
    delta = _deltas(w, spec, cfg)
    c = cfg.logodds_clamp
    for a, (r0, c0) in enumerate(zip(w.row0.tolist(), w.col0.tolist())):
        win = logodds[r0:r0 + w.rows, c0:c0 + w.cols]
        win.copy_(torch.clamp(win + delta[a], -c, c))
    return logodds


# --------------------------------------------------------------------------
# CUDA kernel


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.exact_raster_launch.argtypes = [P] * 6 + [I] * 7 + [F] * 6 + [P]
    lib.exact_raster_launch.restype = I
    lib.exact_raster_sin.argtypes = [P, P, I, P]
    lib.exact_raster_sin.restype = I
    lib.exact_raster_blocks_per_sm.argtypes = [ctypes.POINTER(I)]
    lib.exact_raster_blocks_per_sm.restype = I


def blocks_per_sm() -> int:
    """Resident blocks per SM of the kernel, from CUDA's occupancy
    calculator (builds the kernel; needs a card)."""
    out = ctypes.c_int(0)
    err = cuda_build.load("exact_raster", _bind).exact_raster_blocks_per_sm(
        ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"exact_raster occupancy query failed: CUDA "
                           f"error {err}")
    return out.value


class _Launch(NamedTuple):
    """The kernel's operands, prepared from the windows (`_prepare`)."""
    origins: torch.Tensor     # [N, 2] int32 row0, col0
    meta: torch.Tensor        # [N, 5] f32 ax, ay, yaw, act, max_reach
    table: torch.Tensor       # [N, B, 2] f32
    tile_start: torch.Tensor  # [T + 1] int32 CSR offsets per tile
    pair_agent: torch.Tensor  # [P] int32
    rows: int
    cols: int


def _prepare(logodds, w: _Exact) -> _Launch:
    if not logodds.is_contiguous():
        raise ValueError("the raster kernel updates a contiguous grid")
    origins = torch.stack([w.row0, w.col0], -1).to(torch.int32).contiguous()
    meta = torch.stack([w.ax, w.ay, w.yaw, w.act, w.max_reach], -1).to(
        torch.float32).contiguous()
    table = w.table.contiguous()
    if {x.device for x in (origins, meta, table)} != {logodds.device}:
        raise ValueError("the agents' inputs and the grid must lie on one "
                         "device: the kernel reads them all")
    tile_start, pair_agent, _, _, _ = _tile_pairs(w, *logodds.shape)
    return _Launch(origins, meta, table, tile_start, pair_agent, w.rows,
                   w.cols)


def _launch(logodds, ln: _Launch, spec: BeamSpec, cfg: GridConfig):
    """One kernel launch on prepared operands."""
    lib = cuda_build.load("exact_raster", _bind)
    stream = torch.cuda.current_stream(logodds.device).cuda_stream
    with trace.span("swarm.raster.launch"):
        err = lib.exact_raster_launch(
            logodds.data_ptr(), ln.origins.data_ptr(), ln.meta.data_ptr(),
            ln.table.data_ptr(), ln.tile_start.data_ptr(),
            ln.pair_agent.data_ptr(), ln.tile_start.shape[0] - 1,
            logodds.shape[0], ln.rows, ln.cols, spec.n_beams,
            int(spec.wrap), ln.table.shape[1], spec.theta0, spec.dtheta,
            recip32(spec.dtheta), cfg.logodds_miss, cfg.logodds_hit,
            cfg.logodds_clamp, stream)
    if err != 0:
        raise RuntimeError(f"exact_raster launch failed: CUDA error {err}")
    beam_raster.launches += 1
    name = form_name(spec)
    beam_raster.launches_by_form[name] = \
        beam_raster.launches_by_form.get(name, 0) + 1


def beam_raster(logodds, agent_xy, yaw, dist_m, trusted, active,
                spec: BeamSpec, cfg: GridConfig = GridConfig()):
    """The exact raster: new_logodds as `beam_raster_pallas(logodds,
    agent_xy, yaw, dist_m, trusted, active, spec, cfg)` returns it.
    agent_xy [N, 2] world metres, yaw [N], dist_m [N, B] the range-limited
    readings, trusted [N, B] bool (HIT evidence allowed), active [N] bool;
    `spec` the scan's fan or the wrapped 4-way fan. `logodds` [S, S]
    float32 is updated IN PLACE.

    A CPU grid goes to `beam_raster_plain`. A CUDA grid launches the
    kernel; a failed build or launch raises."""
    if logodds.device.type == "cpu":
        return beam_raster_plain(logodds, agent_xy, yaw, dist_m, trusted,
                                 active, spec, cfg)
    if logodds.device.type != "cuda":
        raise ValueError(f"no raster for a grid on {logodds.device}")
    _check_supported(logodds, spec)
    w = _windows(logodds, agent_xy, yaw, dist_m, trusted, active, cfg)
    _launch(logodds, _prepare(logodds, w), spec, cfg)
    return logodds


beam_raster.launches = 0
beam_raster.launches_by_form = {}


def device_sin(x):
    """`sinf` as the kernel evaluates it, on a CUDA tensor of float32
    (a probe for comparing the kernel's sine with `torch.sin`; no raster
    runs and no launch is counted)."""
    out = torch.empty_like(x)
    err = cuda_build.load("exact_raster", _bind).exact_raster_sin(
        x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exact_raster_sin failed: CUDA error {err}")
    return out
