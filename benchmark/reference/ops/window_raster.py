"""The window raster in plain torch: a frozen copy of the plain version of
swarm_tpu_torch/ops/beam_raster_cuda.py (the per-cell arithmetic of
csrc/free_raster.cu, op for op), with the evidence computed in blocks of
agents so that 32,768 agents fit beside the program's state, and an
option to store each window through a lower precision (the control).

Every agent's window evidence is worked out from its pose and its ranges,
then the windows are applied one by one in agent index order, each clipped
in float32 and stored in the grid's dtype before the next agent reads it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference._device import div as _div
from benchmark.reference._device import recip32
from benchmark.reference.config import GridConfig
from benchmark.reference.ops.beam_raster import (RANGE_MAX_CELLS8, RANGE_QUANT8,
                                                 BeamSpec, _pack_range16,
                                                 _unpack_range16,
                                                 fan_bbox_cells,
                                                 group_range_stats,
                                                 group_trusted_frac,
                                                 patch_dims, patch_origin,
                                                 quantize_ranges_cells)

# agents whose window evidence is computed at once: each [rows, cols]
# float32 temporary of a block is BLOCK_AGENTS * 80 KB
BLOCK_AGENTS = 2048


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


def window_kind(band, band_cols) -> str:
    """The grid window of a call: "" (the whole grid), "band" or "tile"."""
    return "tile" if band_cols is not None else (
        "band" if band is not None else "")


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


# --------------------------------------------------------------------------
# CUDA kernel


def _block(w: _Windows, a: int, b: int) -> _Windows:
    """The windows of agents [a, b)."""
    return w._replace(**{f: getattr(w, f)[a:b] for f in (
        "row0", "col0", "t_cl", "t_ch", "ax", "ay", "yaw", "act", "goff_r",
        "goff_c", "table")})


def window_raster(logodds, agent_xy, yaw, dist_m, active, trusted,
                  spec: BeamSpec, cfg: GridConfig, reach: int,
                  pack8: bool = True, n_groups=None,
                  tail_weight: float = 0.25, store_through=None):
    """The per-agent window raster on the whole grid: updates `logodds` IN
    PLACE and returns (logodds, counts [N] float32). `store_through`: a
    dtype each clipped window is rounded through before it is stored (the
    control's lower precision), or None."""
    w = _windows(logodds, agent_xy, yaw, dist_m, active, spec, cfg, trusted,
                 reach, pack8, n_groups, tail_weight)
    dense = _dense_fan(spec, reach)
    c = cfg.logodds_clamp
    n = w.ax.shape[0]
    rows0, cols0 = w.row0.tolist(), w.col0.tolist()
    counts = []
    for a in range(0, n, BLOCK_AGENTS):
        b = min(n, a + BLOCK_AGENTS)
        delta, cnt = _window_deltas(_block(w, a, b), spec, cfg, dense)
        counts.append(cnt)
        for i in range(b - a):
            r0, c0 = rows0[a + i], cols0[a + i]
            win = logodds[r0:r0 + w.rows, c0:c0 + w.cols]
            new = torch.clamp(win.to(torch.float32) + delta[i], -c, c)
            if store_through is not None:
                new = new.to(store_through).to(torch.float32)
            win.copy_(new)
        del delta
    return logodds, torch.cat(counts)
