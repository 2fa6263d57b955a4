"""The beam-model free-space raster over per-agent windows: a CUDA kernel
for Hopper and its plain torch version.

Replaces `swarm_tpu/ops/beam_raster_pallas.py::_free_kernel` (entry point
`free_raster_pallas`) in the per-beam forms (`n_groups == n_beams`) the
ported paths run, on a float32 grid without a band:
- pack8 + ring (`trusted` given, `pack8=True`): 7-bit 1/4-cell ranges +
  trusted bit 7, four beams per int32 word, and the in-kernel endpoint ring
  (the deployable step, `bench.py`'s defaults);
- pack16 without the ring (`trusted=None`, `pack8=False`): 16-bit 1/256-cell
  ranges, two beams per word, the free carve alone; the endpoints go to the
  exact scatter (`ops/raster.endpoint_scatter`) after the kernel
  (`EngineConfig`'s own defaults, the coverage tool's configuration).
Each table serves a fan (the 181-beam scan) and the wrapped 4-way fan
(`spec.wrap`: every direction is in the fan, the beam bin is a floor-mod).
Per agent, over its aligned [64, 256] window, every cell gets the
inverse-sensor-model evidence of its nearest beam (free carve
`r < rb - 0.5` weighted by the crossing count, and with the ring
`|r - rb| <= 0.71` weighted by the trusted bit), and the window is clipped
to [-clamp, clamp] after each agent, agents in index order. The per-agent
painted count is the engine's applied-write counter.

What bounds it on the H100: at 1024 agents x 64 x 256 cells per step the
kernel evaluates up to ~17 M cells, each ~40 float operations (a division,
a square root, the atan2 polynomial, the bin and the table lookup), and
reads and writes the tiles the windows cover once (~128 MB on the 4096^2
grid). The range table (at most 364 bytes per agent) is not the bound. The
design (csrc/free_raster.cu) gives each block one 64 x 128 tile held in
registers, so the read-modify-write of overlapping windows happens in
registers in agent order and the grid is read and written once per launch,
and each agent's table sits in shared memory. It is simple, not yet fast:
the per-cell work of inactive fan-bbox strips is skipped (the wrapped fan's
bbox is the full disc, so it skips nothing), but nothing else is pruned.

`free_raster` dispatches on where the grid lies: a CPU tensor goes to
`free_raster_plain`; a CUDA tensor launches the kernel or raises.
`free_raster.launches` counts kernel launches and nothing else;
`free_raster.launches_by_form` splits that count by table form and fan
(`form_name`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from swarm_tpu_torch._device import div as _div
from swarm_tpu_torch._device import recip32
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.ops import cuda_build
from swarm_tpu_torch.ops.beam_raster import (RANGE_MAX_CELLS8, RANGE_QUANT,
                                             RANGE_QUANT8, REACH_CELLS,
                                             BeamSpec, _pack_range16,
                                             fan_bbox_cells, patch_dims,
                                             patch_origin)

TILE_R = 64            # grid tile owned by one CUDA block (csrc TILE_R/C)
TILE_C = 128
MAX_WORDS = 128        # csrc MAX_WORDS: table words per agent
FORM_PACK8_RING = 0    # csrc Form
FORM_PACK16 = 1

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
    """[N, B] raw ranges in cells + trusted mask -> [N, W] int32 words,
    beam 4w+j in bits 8j..8j+7 (7-bit 1/4-cell range, trusted bit 7)."""
    ints = torch.round(torch.clamp(dist_cells_raw, 0.0, RANGE_MAX_CELLS8)
                       * RANGE_QUANT8).to(torch.int32)
    ints = ints | (trusted.to(torch.int32) << 7)
    b_n = ints.shape[-1]
    n_words = -(-b_n // 4)
    ints = torch.nn.functional.pad(ints, (0, 4 * n_words - b_n))
    return (ints[:, 0::4] | (ints[:, 1::4] << 8) |
            (ints[:, 2::4] << 16) | (ints[:, 3::4] << 24))


def _unpack_range8(v8):
    """Packed 8-bit field -> (range cells f32, trusted flag f32)."""
    return ((v8 & 0x7F).to(torch.float32) * (1.0 / RANGE_QUANT8),
            (v8 >> 7).to(torch.float32))


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
    ax: torch.Tensor      # [N] f32 agent position in cells
    ay: torch.Tensor
    yaw: torch.Tensor
    act: torch.Tensor     # [N] f32 0/1
    table: torch.Tensor   # [N, W] int32 pack8 or pack16 words
    rows: int
    cols: int
    form: int             # FORM_PACK8_RING or FORM_PACK16


def form_name(spec: BeamSpec, pack8: bool) -> str:
    """The launch-count key of a form: table (`pack8-ring` / `pack16`) and
    fan (`-wrapped` for the 4-way fan)."""
    return ("pack8-ring" if pack8 else "pack16") + \
        ("-wrapped" if spec.wrap else "")


def _check_supported(logodds, spec: BeamSpec, reach: int, trusted,
                     pack8: bool):
    if pack8 and trusted is None:
        raise NotImplementedError(
            "the pack8 window raster without its endpoint ring is not "
            "ported yet (ROADMAP Queue B1 variants)")
    if not pack8 and trusted is not None:
        raise NotImplementedError(
            "the pack16 window raster with the endpoint ring is not ported "
            "yet (ROADMAP Queue B1 variants)")
    if logodds.dtype != torch.float32:
        raise NotImplementedError(
            "bfloat16 grids are not ported yet (ROADMAP Queue B1 variants)")
    if pack8 and reach > 31:
        raise ValueError(
            f"pack8 range field (31.75 cells) cannot cover the beam reach "
            f"({reach} cells)")
    size = logodds.shape[0]
    if logodds.shape != (size, size) or size % TILE_C:
        raise ValueError(f"grid must be square with a side divisible by "
                         f"{TILE_C}, got {tuple(logodds.shape)}")


def _windows(logodds, agent_xy, yaw, dist_m, active, spec: BeamSpec,
             cfg: GridConfig, trusted, reach: int,
             pack8: bool = True) -> _Windows:
    size = logodds.shape[0]
    rows, cols = patch_dims(size, reach)
    ax, ay = cells_of(agent_xy, cfg)
    row0, col0 = patch_origin(ax, ay, size, rows, cols, reach)
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
    if pack8:
        table, form = _pack_range8(cells, trusted), FORM_PACK8_RING
    else:
        table, form = _pack_range16(cells, None), FORM_PACK16
    return _Windows(row0=row0, col0=col0, t_cl=t_cl, t_ch=t_ch, ax=ax, ay=ay,
                    yaw=yaw.to(torch.float32),
                    act=active.to(torch.float32), table=table,
                    rows=rows, cols=cols, form=form)


def _constants(spec: BeamSpec, cfg: GridConfig):
    """Python floats of the reference's per-call constants; each rounds to
    float32 where it meets a float32 operand, on both paths."""
    gdt = spec.dtheta                        # per-beam tier: one beam/group
    return dict(theta0=spec.theta0, half_gdt=gdt / 2.0,
                half_dt=spec.dtheta / 2.0, gdt=gdt, dt=spec.dtheta,
                inv_gdt=recip32(gdt), inv_dt=recip32(spec.dtheta),
                fan_lo=-gdt / 2.0, fan_hi=(spec.n_beams - 0.5) * gdt,
                cover=spec.dtheta * 0.999, miss=cfg.logodds_miss,
                hit=cfg.logodds_hit, clampv=cfg.logodds_clamp,
                wrap=spec.wrap)


# --------------------------------------------------------------------------
# plain torch version


def _polar(dx, dy, yaw, k: dict, n_beams: int, dense: bool):
    """One cell's polar position relative to its agent, its beam bin and
    the evidence support, op for op as csrc/raster_common.cuh `polar`.
    Returns (r, cnt, g, base_ok)."""
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
        g = torch.remainder(g, n_beams)
    else:
        in_fan = (rel >= k["fan_lo"]) & (rel < k["fan_hi"])
        g = torch.clamp(g, 0, n_beams - 1)
    cnt = torch.clamp_min(torch.round(rinv * k["inv_dt"]), 1.0)
    if dense:
        base_ok = in_fan & (r2 > 1e-6)
    else:
        covered = rinv >= k["cover"]
        resid = rel - g.to(torch.float32) * k["gdt"]
        on_any = covered | (torch.abs(r * resid) <= 0.6)
        base_ok = in_fan & on_any & (r2 > 1e-6)
    return r, cnt, g, base_ok


def _window_deltas(w: _Windows, spec: BeamSpec, cfg: GridConfig,
                   dense: bool):
    """Evidence delta [N, rows, cols] and painted count [N] of every agent's
    window, vectorised over agents — the kernel's per-cell math, op for
    op."""
    k = _constants(spec, cfg)
    dev = w.ax.device
    n = w.ax.shape[0]
    rr = torch.arange(w.rows, dtype=torch.int32, device=dev)[None, :, None]
    cc = torch.arange(w.cols, dtype=torch.int32, device=dev)[None, None, :]
    cy = (w.row0[:, None, None] + rr).to(torch.float32) + 0.5
    cx = (w.col0[:, None, None] + cc).to(torch.float32) + 0.5
    r, cnt, g, base_ok = _polar(cx - w.ax[:, None, None],
                                cy - w.ay[:, None, None],
                                w.yaw[:, None, None], k, spec.n_beams, dense)

    zero = torch.zeros_like(r)
    act = w.act[:, None, None]
    if w.form == FORM_PACK8_RING:
        words = torch.gather(w.table, 1,
                             (g >> 2).reshape(n, -1).to(torch.int64))
        v8 = (words.reshape(g.shape) >> (8 * (g & 3))) & 0xFF
        rb, tf = _unpack_range8(v8)
        free = base_ok & (r < rb - 0.5)
        delta = torch.where(free, k["miss"] * cnt, zero) * act
        on_ring = base_ok & (torch.abs(r - rb) <= 0.71)
        delta = delta + torch.where(on_ring, k["hit"] * cnt * tf, zero) * act
        painted = torch.where(free, cnt, zero) + \
            torch.where(on_ring, cnt * tf, zero)
    else:
        words = torch.gather(w.table, 1,
                             (g >> 1).reshape(n, -1).to(torch.int64))
        v16 = (words.reshape(g.shape) >> (16 * (g & 1))) & 0xFFFF
        # no trusted bit: all 16 bits are range (`_unpack_range16(v16,
        # False)` of the reference)
        rb = v16.to(torch.float32) * (1.0 / RANGE_QUANT)
        free = base_ok & (r < rb - 0.5)
        delta = torch.where(free, k["miss"] * cnt, zero) * act
        painted = torch.where(free, cnt, zero)
    strip = (cc // 128)
    on = (strip >= w.t_cl[:, None, None]) & (strip < w.t_ch[:, None, None])
    delta = torch.where(on, delta, zero)
    painted = torch.where(on, painted, zero)
    return delta, painted.sum(dim=(1, 2)) * w.act


def free_raster_plain(logodds, agent_xy, yaw, dist_m, active, trusted,
                      spec: BeamSpec, cfg: GridConfig = GridConfig(),
                      reach: int = REACH_CELLS, pack8: bool = True):
    """The raster in plain torch: deltas vectorised over [N, rows, cols],
    then applied window by window in agent index order, each window
    clipped after its agent. Updates `logodds` IN PLACE and returns
    (logodds, counts [N] f32)."""
    _check_supported(logodds, spec, reach, trusted, pack8)
    w = _windows(logodds, agent_xy, yaw, dist_m, active, spec, cfg, trusted,
                 reach, pack8)
    delta, counts = _window_deltas(w, spec, cfg, _dense_fan(spec, reach))
    c = cfg.logodds_clamp
    for a, (r0, c0) in enumerate(zip(w.row0.tolist(), w.col0.tolist())):
        win = logodds[r0:r0 + w.rows, c0:c0 + w.cols]
        win.copy_(torch.clamp(win + delta[a], -c, c))
    return logodds, counts


# --------------------------------------------------------------------------
# CUDA kernel


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.free_raster_launch.argtypes = [P] * 8 + [I] * 9 + [F] * 11 + [P]
    lib.free_raster_launch.restype = I


def _tile_pairs(w: _Windows, size: int):
    """Every (agent, grid tile) pair whose tile meets the agent's window,
    sorted stably by (tile, agent), as CSR offsets per tile. Returns
    (tile_start [T+1], pair_agent [P], pair_slot [P], K, N) where slot
    a*K + k is agent a's k-th candidate tile."""
    n = w.row0.shape[0]
    dev = w.row0.device
    n_tr, n_tc = size // TILE_R, size // TILE_C
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
    meta: torch.Tensor        # [N, 4] f32 ax, ay, yaw, act
    table: torch.Tensor       # [N, W] int32 table words
    tile_start: torch.Tensor  # [T + 1] int32 CSR offsets per tile
    pair_agent: torch.Tensor  # [P] int32
    pair_slot: torch.Tensor   # [P] int32
    k: int                    # candidate tiles per agent
    rows: int
    cols: int
    form: int                 # FORM_PACK8_RING or FORM_PACK16


def _prepare(logodds, w: _Windows, spec: BeamSpec) -> _Launch:
    if not logodds.is_contiguous():
        raise ValueError("the raster kernel updates a contiguous grid")
    if w.table.shape[1] > MAX_WORDS:
        raise ValueError(f"{spec.n_beams} beams exceed the kernel's "
                         f"{MAX_WORDS}-word table")
    origins = torch.stack([w.row0, w.col0, w.t_cl, w.t_ch], -1).to(
        torch.int32).contiguous()
    meta = torch.stack([w.ax, w.ay, w.yaw, w.act], -1).to(
        torch.float32).contiguous()
    table = w.table.to(torch.int32).contiguous()
    if {x.device for x in (origins, meta, table)} != {logodds.device}:
        raise ValueError("the agents' inputs and the grid must lie on one "
                         "device: the kernel reads them all")
    tile_start, pair_agent, pair_slot, k, _ = _tile_pairs(w,
                                                          logodds.shape[0])
    return _Launch(origins, meta, table, tile_start, pair_agent, pair_slot,
                   k, w.rows, w.cols, w.form)


def _launch(logodds, ln: _Launch, spec: BeamSpec, cfg: GridConfig,
            dense: bool):
    """One kernel launch on prepared operands; returns counts [N]."""
    n = ln.meta.shape[0]
    partial = torch.zeros(n * ln.k, dtype=torch.float32,
                          device=logodds.device)
    c = _constants(spec, cfg)
    err = cuda_build.load("free_raster", _bind).free_raster_launch(
        logodds.data_ptr(), ln.origins.data_ptr(), ln.meta.data_ptr(),
        ln.table.data_ptr(), ln.tile_start.data_ptr(),
        ln.pair_agent.data_ptr(), ln.pair_slot.data_ptr(),
        partial.data_ptr(), ln.tile_start.shape[0] - 1, logodds.shape[0],
        ln.rows, ln.cols, ln.table.shape[1], ln.form, spec.n_beams,
        int(dense), int(spec.wrap), c["theta0"], c["half_gdt"],
        c["half_dt"], c["gdt"], c["dt"], c["fan_lo"], c["fan_hi"],
        c["cover"], c["miss"], c["hit"], c["clampv"],
        torch.cuda.current_stream(logodds.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"free_raster launch failed: CUDA error {err}")
    free_raster.launches += 1
    name = form_name(spec, ln.form == FORM_PACK8_RING)
    free_raster.launches_by_form[name] = \
        free_raster.launches_by_form.get(name, 0) + 1
    # pair slots reduced per agent in a fixed order (no float atomics)
    return partial.reshape(n, ln.k).sum(dim=1) * ln.meta[:, 3]


def free_raster(logodds, agent_xy, yaw, dist_m, active, trusted,
                spec: BeamSpec, cfg: GridConfig = GridConfig(),
                reach: int = REACH_CELLS, pack8: bool = True):
    """The engine's raster: (new_logodds, counts [N] f32) as
    `free_raster_pallas(..., n_groups=n_beams, pack8=pack8,
    trusted=trusted)` returns them; counts is the per-agent in-kernel
    applied-write counter. agent_xy [N, 2] world metres, yaw [N], dist_m
    [N, B] the range-limited readings, trusted [N, B] their trust mask (the
    ring, with `pack8=True`) or None (no ring, with `pack8=False`), active
    [N] bool. `spec` is the scan's fan or the wrapped 4-way fan. `logodds`
    [S, S] float32 is updated IN PLACE.

    A CPU grid goes to `free_raster_plain`. A CUDA grid launches the
    kernel; a failed build or launch raises."""
    if logodds.device.type == "cpu":
        return free_raster_plain(logodds, agent_xy, yaw, dist_m, active,
                                 trusted, spec, cfg, reach=reach, pack8=pack8)
    if logodds.device.type != "cuda":
        raise ValueError(f"no raster for a grid on {logodds.device}")
    _check_supported(logodds, spec, reach, trusted, pack8)
    w = _windows(logodds, agent_xy, yaw, dist_m, active, spec, cfg, trusted,
                 reach, pack8)
    counts = _launch(logodds, _prepare(logodds, w, spec), spec, cfg,
                     _dense_fan(spec, reach))
    return logodds, counts


free_raster.launches = 0
free_raster.launches_by_form = {}
