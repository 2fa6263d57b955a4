"""The beam-model free-space raster over per-agent windows: a CUDA kernel
for Hopper and its plain torch version.

Replaces `swarm_tpu/ops/beam_raster_pallas.py::_free_kernel` (entry point
`free_raster_pallas`) in every form, per-beam (`n_groups == n_beams`) and
grouped (`n_groups < n_beams`):
- the table: pack8 (per-beam, `pack8=True`: 7-bit 1/4-cell ranges, four
  beams per int32 word), pack16 (per-beam, `pack8=False`: 15-bit
  1/256-cell ranges, two beams per word) or grouped (`n_groups` groups of
  ceil(n_beams / n_groups) consecutive beams; per group three float32s,
  as free_raster_pallas builds them: the carve, the second-smallest
  1/256-cell range; the trusted fraction; the tail, the median);
- the endpoint ring: with `trusted` given the table carries each beam's
  trusted bit (per-beam) or each group's trusted fraction (grouped) and
  the kernel paints the ring weighted by it; with `trusted=None` the kernel
  carves free space alone and the engine scatters the endpoints exactly
  after it (`ops/raster.endpoint_scatter`);
- the weak tail (grouped only, `tail_weight > 0`): free evidence at
  `tail_weight` between the carve and the tail range. The per-beam carve is
  exact, so the per-beam forms keep the tail off, as the reference does;
- the grid's storage: float32, or bfloat16 (`GridConfig.logodds_dtype`),
  whose windows are 16-row aligned ([80, 256] at the 26-cell reach); the
  evidence adds in float32 and each agent's window is stored as bf16 before
  the next agent reads it, as the reference does;
- the fan: the 181-beam scan, or the wrapped 4-way fan (`spec.wrap`: every
  direction is in the fan, the beam or group bin is a floor-mod);
- the grid window (the sharded engine's decompositions): the whole grid,
  a row band (`band=(row_off, n_rows)`: the grid is rows [row_off,
  row_off + n_rows) of the global grid) or a tile window (`band_cols=
  (col_off, n_cols)` as well: a tile plus its halo ring, whose offsets are
  negative at the global grid's low edges). The agents' cells are shifted
  by the offsets in float32, as free_raster_pallas shifts them, the window
  origins are clamped into the band, and with `band_cols` a guard drops the
  evidence of every cell outside the global grid (the cell's global
  coordinates rebuilt in float32 from the window-local centre and the
  offsets, beam_raster_pallas.py:440-447). Float32 grids only, as the
  sharded engine keeps them.
`bench.py`'s defaults run pack8 + ring on the scan; `--no-pack8`,
`--exact-endpoints`, `--grid-dtype bfloat16` and `--scan-rays 0` pick the
other per-beam forms, `--beam-groups N` the grouped ones, and the coverage
tool runs pack16 without the ring on both fans.
Per agent, over its aligned window, every cell gets the
inverse-sensor-model evidence of its beam or group (free carve
`r < rb - 0.5` weighted by the crossing count, the tail, and with the ring
`|r - rb| <= 0.71` weighted by the trusted bit or fraction), and the window
is clipped to [-clamp, clamp] after each agent, agents in index order. The
per-agent painted count is the engine's applied-write counter.

What bounds it on the H100: at 1024 agents the windows cover the 4096^2
float32 grid (~128 MB read and written once, half that in bf16), and each
evaluated cell costs ~80 float operations in a long dependent chain (a
division, a square root, the atan2 polynomial, the bin and the table
lookup). The range table (at most 512 bytes per agent packed, 12 bytes a
group grouped) is not the bound. The design (csrc/free_raster.cu): each
block owns one 64 x 128 tile and applies its agents in index order, in
place, with a clip (and on a bf16 grid the bf16 rounding) after each; it
evaluates only each agent's evaluation box (`evaluation_box`: the
bounding box of the fan's sector of radius R + 1 around the agent, R the
largest range its own table holds, widened by a cell; no other cell can
take evidence), and skips the other window cells, whose +0.0 delta and
clip are the identity, wherever its tile holds only values in [-clamp,
clamp] and no -0.0. The agents' tables, origins and meta are copied into
shared memory one pair ahead.

`free_raster` dispatches on where the grid lies: a CPU tensor goes to
`free_raster_plain`; a CUDA tensor launches the kernel or raises.
`free_raster.launches` counts kernel launches and nothing else;
`free_raster.launches_by_form` splits that count by table, ring, fan,
storage and grid window (`form_name`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from swarm_tpu_torch import trace
from swarm_tpu_torch._device import div as _div
from swarm_tpu_torch._device import recip32
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.ops import cuda_build
from swarm_tpu_torch.ops.beam_raster import (RANGE_MAX_CELLS8, RANGE_QUANT,
                                             RANGE_QUANT8, REACH_CELLS,
                                             BeamSpec,
                                             _pack_range16, _unpack_range16,
                                             fan_bbox_cells,
                                             group_range_stats,
                                             group_trusted_frac, patch_dims,
                                             patch_origin,
                                             quantize_ranges_cells)

TILE_R = 64            # grid tile owned by one CUDA block (csrc TILE_R/C)
TILE_C = 128
MAX_WORDS = 128        # csrc MAX_WORDS: packed table words per agent
MAX_GROUPS = 512       # csrc MAX_GROUPS: groups per agent in the grouped table
# csrc/raster_common.cuh: the evaluation box's radius beyond R, its margin
# in cells, the slack of its arc and the largest |yaw| it takes a sector for
BOX_RADIUS = 1.0
BOX_MARGIN = 1.0
ARC_SLACK = 0.01
SECTOR_YAW_MAX = 64.0
# csrc Form: the launch's form code from (table, ring)
FORMS = {("pack8", True): 0, ("pack16", False): 1, ("pack16", True): 2,
         ("pack8", False): 3, ("grouped", True): 4, ("grouped", False): 5}
# csrc Storage: the launch's storage code from the grid's dtype
STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_SOURCE = cuda_build.source("free_raster")


# --------------------------------------------------------------------------
# semantics shared by the kernel and the plain version


def cells_of(agent_xy, cfg: GridConfig):
    """Agent positions [N, 2] in world metres -> (ax, ay) [N] in cells,
    multiplied by the float32 reciprocal of the resolution, as the jitted
    reference computes them."""
    inv = recip32(cfg.resolution)
    return ((agent_xy[:, 0] - cfg.origin_x) * inv,
            (agent_xy[:, 1] - cfg.origin_y) * inv)


def _dense_fan(spec: BeamSpec, reach_cells: float) -> bool:
    """True when every cell within reach is crossed by >= 1 beam, making the
    on-beam test constant TRUE wherever evidence can apply (181 beams
    qualify; a 61-beam fan at the 26-cell reach does not)."""
    return spec.dtheta * (reach_cells + 2.0) <= 0.999


def _pack_range8(dist_cells_raw, trusted):
    """[N, B] raw ranges in cells + trusted mask (or None: no trusted bit)
    -> [N, W] int32 words, beam 4w+j in bits 8j..8j+7 (7-bit 1/4-cell
    range, trusted bit 7)."""
    ints = torch.round(torch.clamp(dist_cells_raw, 0.0, RANGE_MAX_CELLS8)
                       * RANGE_QUANT8).to(torch.int32)
    if trusted is not None:
        ints = ints | (trusted.to(torch.int32) << 7)
    b_n = ints.shape[-1]
    n_words = -(-b_n // 4)
    ints = torch.nn.functional.pad(ints, (0, 4 * n_words - b_n))
    return (ints[:, 0::4] | (ints[:, 1::4] << 8) |
            (ints[:, 2::4] << 16) | (ints[:, 3::4] << 24))


def _unpack_range8(v8, trusted_bit: bool = True):
    """Packed 8-bit field -> (range cells f32, trusted flag f32). Without
    a trusted bit all 8 bits are range and the flag is 0, as the
    reference's `_unpack_range8(v8, paint_hits=False)` reads them."""
    if trusted_bit:
        return ((v8 & 0x7F).to(torch.float32) * (1.0 / RANGE_QUANT8),
                (v8 >> 7).to(torch.float32))
    return (v8.to(torch.float32) * (1.0 / RANGE_QUANT8),
            torch.zeros(v8.shape, dtype=torch.float32, device=v8.device))


def _wrap_pi_cheap(x):
    """(-pi, pi] wrap with one round (|x| < 4 pi here)."""
    return x - (2 * math.pi) * torch.round(x * (1 / (2 * math.pi)))


def _atan2_poly(y, x):
    """atan2 by octant reduction + the reference's odd minimax polynomial
    (~1e-5 rad; beam binning needs ~1e-3). Horner order and float32
    constants as in the reference."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.clamp_min(hi, 1e-20)
    s = z * z
    p = z * (0.99997726 + s * (-0.33262347 + s * (0.19354346 + s * (
        -0.11643287 + s * (0.05265332 + s * -0.01172120)))))
    r = torch.where(ay > ax, (math.pi / 2) - p, p)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


class _Windows(NamedTuple):
    """Per-agent launch data (what the Pallas entry point packs into its
    origins / meta / table operands)."""
    row0: torch.Tensor    # [N] int32 window origin
    col0: torch.Tensor
    t_cl: torch.Tensor    # [N] int32 fan-bbox strip bounds [t_cl, t_ch)
    t_ch: torch.Tensor
    ax: torch.Tensor      # [N] f32 agent position in window-local cells
    ay: torch.Tensor
    yaw: torch.Tensor
    act: torch.Tensor     # [N] f32 0/1
    goff_r: torch.Tensor  # [N] f32 the grid window's global offset (0, 0
    goff_c: torch.Tensor  #   on the whole grid): meta slots 4-5
    table: torch.Tensor   # [N, W] int32 pack8 or pack16 words, or [N, G, 3]
    #                       f32 grouped (carve, trusted fraction, tail)
    rows: int
    cols: int
    kind: str             # the table: "pack8", "pack16" or "grouped"
    ring: bool            # the table carries the trust; the ring runs
    n_bins: int           # beams, or groups in the grouped tier
    tail_weight: float    # the grouped tier's weak tail; 0 per beam
    guard: int            # global grid size of the tile windows' guard; 0
    window: str           # "", "band" or "tile" (window_kind)


def table_kind(spec: BeamSpec, pack8: bool, n_groups=None) -> str:
    """The table a call runs: `grouped` when `n_groups` (None: per beam)
    is below the fan's beam count, else `pack8` or `pack16`."""
    if n_groups is not None and min(n_groups, spec.n_beams) < spec.n_beams:
        return "grouped"
    return "pack8" if pack8 else "pack16"


def form_name(spec: BeamSpec, pack8: bool, ring: bool,
              dtype=torch.float32, grouped: bool = False,
              window: str = "") -> str:
    """The launch-count key of a form: table (`pack8` / `pack16`, or
    `grouped`), ring (`-ring`), fan (`-wrapped` for the 4-way fan),
    storage (`-bf16`) and grid window (`window`: "" for the whole grid,
    `band` for a row band, `tile` for a tile window), e.g. `pack8-ring`,
    `pack16-wrapped`, `grouped-ring-wrapped-bf16`, `pack16-ring-tile`."""
    table = "grouped" if grouped else ("pack8" if pack8 else "pack16")
    return table + ("-ring" if ring else "") + \
        ("-wrapped" if spec.wrap else "") + \
        ("-bf16" if dtype == torch.bfloat16 else "") + \
        (f"-{window}" if window else "")


def window_kind(band, band_cols) -> str:
    """The grid window of a call: "" (the whole grid), "band" or "tile"."""
    return "tile" if band_cols is not None else (
        "band" if band is not None else "")


def _check_supported(logodds, reach: int, pack8: bool, cfg: GridConfig,
                     band=None, band_cols=None):
    if logodds.dtype not in STORAGE:
        raise ValueError(f"the window raster takes a float32 or bfloat16 "
                         f"grid, got {logodds.dtype}")
    if pack8 and reach > 31:
        raise ValueError(
            f"pack8 range field (31.75 cells) cannot cover the beam reach "
            f"({reach} cells)")
    if band is None and band_cols is None:
        size = logodds.shape[0]
        if logodds.shape != (size, size) or size % TILE_C:
            raise ValueError(f"grid must be square with a side divisible "
                             f"by {TILE_C}, got {tuple(logodds.shape)}")
        return
    if logodds.dtype != torch.float32:
        # the sharded engine keeps a float32 grid (parallel/sharded.py)
        raise ValueError("band and tile windows take a float32 grid, got "
                         f"{logodds.dtype}")
    want = (cfg.size if band is None else band[1],
            cfg.size if band_cols is None else band_cols[1])
    rows, cols = patch_dims(cfg.size, reach)
    if tuple(logodds.shape) != want or want[1] % TILE_C or \
            want[0] < rows or want[1] < cols:
        raise ValueError(f"a band / tile window of {want} (columns "
                         f"divisible by {TILE_C}, at least the [{rows}, "
                         f"{cols}] agent window) cannot take a grid of "
                         f"{tuple(logodds.shape)}")


def grouped_table(dist_cells, trusted, spec: BeamSpec, n_groups: int):
    """The grouped table [N, G, 3] float32 as free_raster_pallas stacks it:
    per group the carve (second-smallest quantized range), the trusted
    fraction (zeros without the ring) and the tail (median)."""
    carve, tail = group_range_stats(quantize_ranges_cells(dist_cells),
                                    n_groups)
    tf = (torch.zeros_like(carve) if trusted is None
          else group_trusted_frac(trusted, spec.n_beams, n_groups))
    return torch.stack([carve, tf, tail], dim=-1)


def _windows(logodds, agent_xy, yaw, dist_m, active, spec: BeamSpec,
             cfg: GridConfig, trusted, reach: int, pack8: bool = True,
             n_groups=None, tail_weight: float = 0.25, band=None,
             band_cols=None) -> _Windows:
    window = window_kind(band, band_cols)
    size = cfg.size if window else logodds.shape[0]
    # bf16 windows are 16-row aligned, as free_raster_pallas aligns them
    # (beam_raster_pallas.py:541-543)
    align = 16 if logodds.dtype == torch.bfloat16 else 8
    rows, cols = patch_dims(size, reach, row_align=align)
    ax, ay = cells_of(agent_xy, cfg)
    # band / tile windows: window-local cells, the offsets subtracted in
    # float32 (beam_raster_pallas.py:552-558)
    row_off = 0 if band is None else int(band[0])
    col_off = 0 if band_cols is None else int(band_cols[0])
    if band is not None:
        ay = ay - float(row_off)
    if band_cols is not None:
        ax = ax - float(col_off)
    row0, col0 = patch_origin(
        ax, ay, size, rows, cols, reach,
        n_rows=None if band is None else band[1],
        n_cols=None if band_cols is None else band_cols[1], row_align=align)
    # fan-bbox column-strip bounds: reach + 1.5 covers the endpoint ring
    # and the half-cell centre offset; +-1.5 cells absorb fan-edge rounding
    bxmin, bxmax, _, _ = fan_bbox_cells(yaw, spec, reach + 1.5)
    n_cb = cols // 128
    c0f = col0.to(torch.float32)
    t_cl = torch.clamp(torch.floor(_div(ax + bxmin - 1.5 - c0f, 128.0)),
                       0, n_cb).to(torch.int32)
    t_ch = torch.clamp(torch.ceil(_div(ax + bxmax + 1.5 - c0f, 128.0)),
                       0, n_cb).to(torch.int32)
    cells = (dist_m * recip32(cfg.resolution)).to(torch.float32)
    kind = table_kind(spec, pack8, n_groups)
    if kind == "grouped":
        n_bins = min(n_groups, spec.n_beams)
        table = grouped_table(cells, trusted, spec, n_bins)
    else:
        # the per-beam carve is exact: no tail, as the reference
        n_bins, tail_weight = spec.n_beams, 0.0
        table = (_pack_range8 if pack8 else _pack_range16)(cells, trusted)
    return _Windows(row0=row0, col0=col0, t_cl=t_cl, t_ch=t_ch, ax=ax, ay=ay,
                    yaw=yaw.to(torch.float32),
                    act=active.to(torch.float32),
                    goff_r=torch.full_like(ax, float(row_off)),
                    goff_c=torch.full_like(ax, float(col_off)),
                    table=table, rows=rows, cols=cols, kind=kind,
                    ring=trusted is not None, n_bins=n_bins,
                    tail_weight=float(tail_weight),
                    guard=cfg.size if band_cols is not None else 0,
                    window=window)


def _constants(spec: BeamSpec, cfg: GridConfig, n_bins: int,
               tail_weight: float):
    """Python floats of the reference's per-call constants; each rounds to
    float32 where it meets a float32 operand, on both paths. `n_bins`: the
    beams, or the groups of the grouped tier, each ceil(n_beams / n_bins)
    beams wide."""
    gdt = spec.dtheta * (-(-spec.n_beams // n_bins))
    return dict(theta0=spec.theta0, half_gdt=gdt / 2.0,
                half_dt=spec.dtheta / 2.0, gdt=gdt, dt=spec.dtheta,
                inv_gdt=recip32(gdt), inv_dt=recip32(spec.dtheta),
                fan_lo=-gdt / 2.0, fan_hi=(n_bins - 0.5) * gdt,
                cover=spec.dtheta * 0.999, miss=cfg.logodds_miss,
                hit=cfg.logodds_hit, clampv=cfg.logodds_clamp,
                wrap=spec.wrap, n_bins=n_bins, tail_w=tail_weight,
                # `miss * tail_weight * cnt` multiplies the Python floats
                # first, as the reference does
                miss_tail=cfg.logodds_miss * tail_weight)


def table_reach(table, kind: str, ring: bool):
    """R [M] float32: the largest range each row of a beam table holds,
    decoded as the lookup decodes it, as the kernels take it (every field,
    padding included): `table` [M, W] int32 pack8 / pack16 words, or [M,
    G, 3] float32 grouped triples (the carve and the tail, not the trusted
    fraction; a NaN range is dropped, as the kernels' fmaxf drops it)."""
    m = table.shape[0]
    if kind == "grouped":
        t = table.reshape(m, -1, 3)[..., 0::2].reshape(m, -1)
        t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
        return torch.clamp_min(t, 0.0).amax(dim=1)
    bits, quant = (8, RANGE_QUANT8) if kind == "pack8" else (16, RANGE_QUANT)
    mask = (1 << (bits - 1 if ring else bits)) - 1
    t = table.reshape(m, -1).to(torch.int64) & 0xFFFFFFFF
    fields = torch.stack([(t >> s) & mask for s in range(0, 32, bits)], -1)
    return fields.reshape(m, -1).amax(dim=1).to(torch.float32) * \
        (1.0 / quant)


def evaluation_box(table, kind: str, ring: bool, ax, ay, yaw,
                   spec: BeamSpec, n_bins: int):
    """The cells the kernels evaluate for each agent (or room slot), as
    csrc/raster_common.cuh `evaluation_box` computes them: the bounding box
    of the sector of radius R + 1 (R = `table_reach`) around the agent's
    position (ax, ay) [M] in the kernel's cells, over the fan's arc from
    `yaw` [M] widened by 0.01 rad on each side (the whole disc on the
    wrapped fan, or where |yaw| > 64), with the agent, widened by one cell.
    No cell outside it can take evidence (csrc/free_raster.cu's note); the
    kernels intersect it with the window, the tile and, in the window
    kernel, the fan-bbox strips. `n_bins`: beams, or groups in the grouped
    tier. Returns (row_lo, row_hi, col_lo, col_hi) [M] float32, upper
    bounds exclusive. Only tests and chip_smoke.py call it: it mirrors the
    kernels' arithmetic (sines and cosines up to their last bits)."""
    return sector_box(table_reach(table, kind, ring) + BOX_RADIUS, ax, ay,
                      yaw, spec, n_bins)


def sector_box(rho, ax, ay, yaw, spec: BeamSpec, n_bins: int):
    """csrc/raster_common.cuh `evaluation_box` for a radius `rho` [M]: the
    bounding box of the sector of radius rho around (ax, ay) over the fan's
    arc from `yaw`, widened by 0.01 rad on each side (the whole disc on the
    wrapped fan, or where |yaw| > 64), with its apex, widened by one cell.
    Returns (row_lo, row_hi, col_lo, col_hi) [M] float32, upper bounds
    exclusive."""
    f32 = torch.float32
    k = _constants(spec, GridConfig(), n_bins, 0.0)
    one = torch.ones_like(ax)
    xmin, xmax, ymin, ymax = -one, one, -one, one
    arc = float(torch.tensor(float(n_bins), dtype=f32) *
                torch.tensor(k["gdt"], dtype=f32) + 2.0 * ARC_SLACK)
    two_pi = float(torch.tensor(2.0 * math.pi, dtype=f32))
    if not spec.wrap and arc < two_pi:
        lo = yaw.to(f32) + k["theta0"] - k["half_dt"] - ARC_SLACK
        hi = lo + arc

        def has(a):
            d = a - lo
            return d - two_pi * torch.floor(d * (1.0 / two_pi)) <= arc
        sector = torch.abs(yaw) <= SECTOR_YAW_MAX
        cl, ch, sl, sh = torch.cos(lo), torch.cos(hi), torch.sin(lo), \
            torch.sin(hi)
        xmax = torch.where(sector & ~has(0.0), torch.maximum(cl, ch), one)
        xmin = torch.where(sector & ~has(math.pi), torch.minimum(cl, ch),
                           -one)
        ymax = torch.where(sector & ~has(math.pi / 2),
                           torch.maximum(sl, sh), one)
        ymin = torch.where(sector & ~has(-math.pi / 2),
                           torch.minimum(sl, sh), -one)
    z = torch.zeros_like(ax)
    return (torch.floor(ay + rho * torch.minimum(ymin, z) - BOX_MARGIN),
            torch.ceil(ay + rho * torch.maximum(ymax, z) + BOX_MARGIN),
            torch.floor(ax + rho * torch.minimum(xmin, z) - BOX_MARGIN),
            torch.ceil(ax + rho * torch.maximum(xmax, z) + BOX_MARGIN))


# --------------------------------------------------------------------------
# plain torch version


def _polar(dx, dy, yaw, k: dict, dense: bool):
    """One cell's polar position relative to its agent, its beam (or group)
    bin and the evidence support, op for op as csrc/raster_common.cuh
    `polar`. Returns (r, cnt, g, base_ok)."""
    r2 = dx * dx + dy * dy
    rinv = torch.reciprocal(torch.sqrt(torch.clamp_min(r2, 1e-6)))
    r = r2 * rinv
    theta = _atan2_poly(dy, dx)
    rel = theta - yaw - k["theta0"] - k["half_gdt"] + k["half_dt"]
    rel = _wrap_pi_cheap(rel)
    g = torch.floor(rel * k["inv_gdt"] + 0.5).to(torch.int32)
    if k["wrap"]:
        # floor-mod, as jnp.mod; the residual below uses the wrapped bin
        in_fan = torch.ones_like(rel, dtype=torch.bool)
        g = torch.remainder(g, k["n_bins"])
    else:
        in_fan = (rel >= k["fan_lo"]) & (rel < k["fan_hi"])
        g = torch.clamp(g, 0, k["n_bins"] - 1)
    cnt = torch.clamp_min(torch.round(rinv * k["inv_dt"]), 1.0)
    if dense:
        base_ok = in_fan & (r2 > 1e-6)
    else:
        covered = rinv >= k["cover"]
        resid = rel - g.to(torch.float32) * k["gdt"]
        on_any = covered | (torch.abs(r * resid) <= 0.6)
        base_ok = in_fan & on_any & (r2 > 1e-6)
    return r, cnt, g, base_ok


def _lookup(table, g, kind: str, ring: bool):
    """The table entry of every cell's bin: (range rb, trusted weight tf,
    tail range rt), each shaped like `g` [M, ...]. `table` [M, W] holds
    each row's pack8 / pack16 int32 words or its grouped float32 triples
    (carve, trusted fraction, tail) flattened. The per-beam tables have
    no tail (rt = rb)."""
    m = table.shape[0]
    if kind == "grouped":
        idx = (3 * g).reshape(m, -1).to(torch.int64)

        def col(j):
            return torch.gather(table, 1, idx + j).reshape(g.shape)
        # without the ring the fraction column is zeros, as the reference
        return col(0), col(1), col(2)
    if kind == "pack8":
        words = torch.gather(table, 1, (g >> 2).reshape(m, -1).to(
            torch.int64))
        v8 = (words.reshape(g.shape) >> (8 * (g & 3))) & 0xFF
        rb, tf = _unpack_range8(v8, ring)
    else:
        words = torch.gather(table, 1, (g >> 1).reshape(m, -1).to(
            torch.int64))
        v16 = (words.reshape(g.shape) >> (16 * (g & 1))) & 0xFFFF
        rb, tf = _unpack_range16(v16, ring)
    return rb, tf, rb


def _evidence(r, cnt, base_ok, rb, tf, rt, k: dict, ring: bool, act=None):
    """One cell's evidence delta and painted count, op for op as the
    kernels compute them: the free carve, the weak tail (`k["tail_w"] > 0`,
    grouped only) and with the ring the endpoint ring. The window kernel
    multiplies each term by its agent's `act`; the room kernel (act=None)
    multiplies the sum when it applies it."""
    zero = torch.zeros_like(r)

    def a(x):
        return x if act is None else x * act

    free = base_ok & (r < rb - 0.5)
    delta = a(torch.where(free, k["miss"] * cnt, zero))
    painted = torch.where(free, cnt, zero)
    if k["tail_w"] > 0:
        tail = base_ok & ~free & (r < rt - 0.5)
        delta = delta + a(torch.where(tail, k["miss_tail"] * cnt, zero))
        painted = painted + torch.where(tail, k["tail_w"] * cnt, zero)
    if ring:
        on_ring = base_ok & (torch.abs(r - rb) <= 0.71)
        delta = delta + a(torch.where(on_ring, k["hit"] * cnt * tf, zero))
        painted = painted + torch.where(on_ring, cnt * tf, zero)
    return delta, painted


def _window_deltas(w: _Windows, spec: BeamSpec, cfg: GridConfig,
                   dense: bool):
    """Evidence delta [N, rows, cols] and painted count [N] of every agent's
    window, vectorised over agents — the kernel's per-cell math, op for
    op."""
    k = _constants(spec, cfg, w.n_bins, w.tail_weight)
    dev = w.ax.device
    n = w.ax.shape[0]
    rr = torch.arange(w.rows, dtype=torch.int32, device=dev)[None, :, None]
    cc = torch.arange(w.cols, dtype=torch.int32, device=dev)[None, None, :]
    cy = (w.row0[:, None, None] + rr).to(torch.float32) + 0.5
    cx = (w.col0[:, None, None] + cc).to(torch.float32) + 0.5
    r, cnt, g, base_ok = _polar(cx - w.ax[:, None, None],
                                cy - w.ay[:, None, None],
                                w.yaw[:, None, None], k, dense)
    if w.guard:
        # tile windows reach past the global grid at its edges: cells
        # outside it take no evidence (beam_raster_pallas.py:440-447)
        gy = cy + w.goff_r[:, None, None]
        gx = cx + w.goff_c[:, None, None]
        sz = float(w.guard)
        base_ok = base_ok & (gy >= 0.0) & (gy < sz) & (gx >= 0.0) & (gx < sz)
    rb, tf, rt = _lookup(w.table.reshape(n, -1), g, w.kind, w.ring)
    delta, painted = _evidence(r, cnt, base_ok, rb, tf, rt, k, w.ring,
                               act=w.act[:, None, None])
    zero = torch.zeros_like(r)
    strip = (cc // 128)
    on = (strip >= w.t_cl[:, None, None]) & (strip < w.t_ch[:, None, None])
    delta = torch.where(on, delta, zero)
    painted = torch.where(on, painted, zero)
    # summed in double, exactly, as the kernel sums it (csrc/free_raster.cu)
    return delta, painted.to(torch.float64).sum(dim=(1, 2)).to(
        torch.float32) * w.act


def free_raster_plain(logodds, agent_xy, yaw, dist_m, active, trusted,
                      spec: BeamSpec, cfg: GridConfig = GridConfig(),
                      reach: int = REACH_CELLS, pack8: bool = True,
                      n_groups=None, tail_weight: float = 0.25, band=None,
                      band_cols=None):
    """The raster in plain torch: deltas vectorised over [N, rows, cols],
    then applied window by window in agent index order, each window
    clipped (in float32) and stored in the grid's dtype after its agent.
    Updates `logodds` IN PLACE and returns (logodds, counts [N] f32)."""
    _check_supported(logodds, reach, pack8, cfg, band, band_cols)
    w = _windows(logodds, agent_xy, yaw, dist_m, active, spec, cfg, trusted,
                 reach, pack8, n_groups, tail_weight, band, band_cols)
    delta, counts = _window_deltas(w, spec, cfg, _dense_fan(spec, reach))
    c = cfg.logodds_clamp
    for a, (r0, c0) in enumerate(zip(w.row0.tolist(), w.col0.tolist())):
        win = logodds[r0:r0 + w.rows, c0:c0 + w.cols]
        # copy_ rounds to nearest even on a bf16 grid, as `astype` does
        win.copy_(torch.clamp(win.to(torch.float32) + delta[a], -c, c))
    return logodds, counts


# --------------------------------------------------------------------------
# CUDA kernel


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.free_raster_launch.argtypes = [P] * 8 + [I] * 12 + [F] * 13 + [P]
    lib.free_raster_launch.restype = I
    lib.free_raster_blocks_per_sm.argtypes = [I, I, ctypes.POINTER(I)]
    lib.free_raster_blocks_per_sm.restype = I


def blocks_per_sm(kind: str, ring: bool, dtype=torch.float32) -> int:
    """Resident blocks per SM of the kernel instance of (table, ring,
    storage), from CUDA's occupancy calculator (builds the kernel; needs a
    card)."""
    out = ctypes.c_int(0)
    err = cuda_build.load("free_raster", _bind).free_raster_blocks_per_sm(
        FORMS[kind, ring], STORAGE[dtype], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"free_raster occupancy query failed: CUDA error "
                           f"{err}")
    return out.value


def _tile_pairs(w, n_rows: int, n_cols: int):
    """Every (agent, grid tile) pair whose tile meets the agent's window,
    sorted stably by (tile, agent), as CSR offsets per tile, on an
    [n_rows, n_cols] grid (n_cols divisible by TILE_C; a band or tile
    window's last tile row may be ragged, and its tiles count). Returns
    (tile_start [T+1], pair_agent [P], pair_slot [P], K, N) where slot
    a*K + k is agent a's k-th candidate tile."""
    n = w.row0.shape[0]
    dev = w.row0.device
    n_tr, n_tc = -(-n_rows // TILE_R), n_cols // TILE_C
    n_tiles = n_tr * n_tc
    kr = -(-w.rows // TILE_R) + 1
    kc = -(-w.cols // TILE_C)
    tr = torch.div(w.row0, TILE_R, rounding_mode="floor")[:, None] + \
        torch.arange(kr, dtype=torch.int32, device=dev)[None, :]
    tc = torch.div(w.col0, TILE_C, rounding_mode="floor")[:, None] + \
        torch.arange(kc, dtype=torch.int32, device=dev)[None, :]
    ok_r = (tr * TILE_R < (w.row0 + w.rows)[:, None]) & (tr < n_tr)
    ok_c = (tc * TILE_C < (w.col0 + w.cols)[:, None]) & (tc < n_tc)
    ok = ok_r[:, :, None] & ok_c[:, None, :]
    tile = tr[:, :, None] * n_tc + tc[:, None, :]
    key = torch.where(ok, tile, torch.full_like(tile, n_tiles)).reshape(-1)
    k = kr * kc
    sorted_key, order = torch.sort(key, stable=True)
    # CSR offsets by search, not bincount: no device-to-host sync
    tile_start = torch.searchsorted(
        sorted_key, torch.arange(n_tiles + 1, dtype=key.dtype, device=dev),
        out_int32=True)
    pair_slot = order.to(torch.int32)
    pair_agent = torch.div(pair_slot, k, rounding_mode="floor")
    return tile_start, pair_agent.contiguous(), pair_slot.contiguous(), k, n


class _Launch(NamedTuple):
    """The kernel's operands, prepared from the windows (`_prepare`)."""
    origins: torch.Tensor     # [N, 4] int32 row0, col0, t_cl, t_ch
    meta: torch.Tensor        # [N, 6] f32 ax, ay, yaw, act, goff_r, goff_c
    table: torch.Tensor       # [N, W] int32 table words (grouped: the
    #                           float32 triples' bits)
    tile_start: torch.Tensor  # [T + 1] int32 CSR offsets per tile
    pair_agent: torch.Tensor  # [P] int32
    pair_slot: torch.Tensor   # [P] int32
    k: int                    # candidate tiles per agent
    rows: int
    cols: int
    kind: str
    ring: bool
    n_bins: int
    tail_weight: float
    guard: int
    window: str


def _prepare(logodds, w: _Windows, spec: BeamSpec) -> _Launch:
    if not logodds.is_contiguous():
        raise ValueError("the raster kernel updates a contiguous grid")
    n = w.table.shape[0]
    if w.kind == "grouped":
        if w.n_bins > MAX_GROUPS:
            raise ValueError(f"{w.n_bins} beam groups exceed the kernel's "
                             f"{MAX_GROUPS}-group table")
        # the float32 triples go in as their bits: the kernel loads every
        # table as 32-bit words
        table = w.table.reshape(n, -1).contiguous().view(torch.int32)
    else:
        if w.table.shape[1] > MAX_WORDS:
            raise ValueError(f"{spec.n_beams} beams exceed the kernel's "
                             f"{MAX_WORDS}-word table")
        table = w.table.to(torch.int32).contiguous()
    origins = torch.stack([w.row0, w.col0, w.t_cl, w.t_ch], -1).to(
        torch.int32).contiguous()
    meta = torch.stack([w.ax, w.ay, w.yaw, w.act, w.goff_r, w.goff_c],
                       -1).to(torch.float32).contiguous()
    if {x.device for x in (origins, meta, table)} != {logodds.device}:
        raise ValueError("the agents' inputs and the grid must lie on one "
                         "device: the kernel reads them all")
    tile_start, pair_agent, pair_slot, k, _ = _tile_pairs(w,
                                                          *logodds.shape)
    return _Launch(origins, meta, table, tile_start, pair_agent, pair_slot,
                   k, w.rows, w.cols, w.kind, w.ring, w.n_bins,
                   w.tail_weight, w.guard, w.window)


def _launch(logodds, ln: _Launch, spec: BeamSpec, cfg: GridConfig,
            dense: bool):
    """One kernel launch on prepared operands; returns counts [N]."""
    n = ln.meta.shape[0]
    partial = torch.zeros(n * ln.k, dtype=torch.float64,
                          device=logodds.device)
    c = _constants(spec, cfg, ln.n_bins, ln.tail_weight)
    lib = cuda_build.load("free_raster", _bind)
    stream = torch.cuda.current_stream(logodds.device).cuda_stream
    with trace.span("swarm.raster.launch"):
        err = lib.free_raster_launch(
            logodds.data_ptr(), ln.origins.data_ptr(), ln.meta.data_ptr(),
            ln.table.data_ptr(), ln.tile_start.data_ptr(),
            ln.pair_agent.data_ptr(), ln.pair_slot.data_ptr(),
            partial.data_ptr(), ln.tile_start.shape[0] - 1,
            logodds.shape[0], logodds.shape[1], ln.guard, ln.rows, ln.cols,
            ln.table.shape[1], FORMS[ln.kind, ln.ring],
            STORAGE[logodds.dtype], ln.n_bins, int(dense), int(spec.wrap),
            c["theta0"], c["half_gdt"], c["half_dt"], c["gdt"], c["dt"],
            c["fan_lo"], c["fan_hi"], c["cover"], c["miss"], c["hit"],
            c["clampv"], c["tail_w"], c["miss_tail"], stream)
    if err != 0:
        raise RuntimeError(f"free_raster launch failed: CUDA error {err}")
    free_raster.launches += 1
    name = form_name(spec, ln.kind == "pack8", ln.ring, logodds.dtype,
                     grouped=ln.kind == "grouped", window=ln.window)
    free_raster.launches_by_form[name] = \
        free_raster.launches_by_form.get(name, 0) + 1
    # pair slots reduced per agent (no float atomics), exactly in double
    return partial.reshape(n, ln.k).sum(dim=1).to(torch.float32) * \
        ln.meta[:, 3]


def free_raster(logodds, agent_xy, yaw, dist_m, active, trusted,
                spec: BeamSpec, cfg: GridConfig = GridConfig(),
                reach: int = REACH_CELLS, pack8: bool = True,
                n_groups=None, tail_weight: float = 0.25, band=None,
                band_cols=None):
    """The engine's raster: (new_logodds, counts [N] f32) as
    `free_raster_pallas(..., n_groups=n_groups or n_beams, pack8=pack8,
    trusted=trusted, tail_weight=tail_weight)` returns them; counts is the
    per-agent in-kernel applied-write counter. agent_xy [N, 2] world
    metres, yaw [N], dist_m [N, B] the range-limited readings, trusted
    [N, B] their trust mask (the table's trusted bit or fraction and the
    endpoint ring) or None (no ring), active [N] bool. `n_groups` below B
    runs the grouped tier (None: per beam), with the weak tail at
    `tail_weight`; per beam, `pack8` picks the pack8 or the pack16 table.
    `spec` is the scan's fan or the wrapped 4-way fan. `logodds` [S, S]
    float32 or bfloat16 is updated IN PLACE. With `band=(row_off, n_rows)`
    `logodds` is a float32 row band [n_rows, S] of the global grid, and
    with `band_cols=(col_off, n_cols)` as well a tile window [n_rows,
    n_cols] (offsets host ints, negative at the grid's low edges), as
    free_raster_pallas takes them.

    A CPU grid goes to `free_raster_plain`. A CUDA grid launches the
    kernel; a failed build or launch raises."""
    if logodds.device.type == "cpu":
        return free_raster_plain(logodds, agent_xy, yaw, dist_m, active,
                                 trusted, spec, cfg, reach=reach, pack8=pack8,
                                 n_groups=n_groups, tail_weight=tail_weight,
                                 band=band, band_cols=band_cols)
    if logodds.device.type != "cuda":
        raise ValueError(f"no raster for a grid on {logodds.device}")
    _check_supported(logodds, reach, pack8, cfg, band, band_cols)
    w = _windows(logodds, agent_xy, yaw, dist_m, active, spec, cfg, trusted,
                 reach, pack8, n_groups, tail_weight, band, band_cols)
    counts = _launch(logodds, _prepare(logodds, w, spec), spec, cfg,
                     _dense_fan(spec, reach))
    return logodds, counts


free_raster.launches = 0
free_raster.launches_by_form = {}
