"""The map renderer (swarm_tpu/render/raster2d.py) in torch ops on the
grid's device: grid colormap, path and point scatter, zone outlines,
frontier and robot markers composited into one RGB uint8 image [H, W, 3].
The image reaches the host once, in `save_png`, which encodes it with the
standard library (zlib, struct, CRC-32) and needs no imaging package.

Scatters follow the reference's `.at[flat].set(...)` as XLA runs it on the
CPU: where several entries land on one pixel the last one wins. Here that
is made explicit (each pixel takes the entry of highest index, an `amax`
scatter of the entry index), so the card and the CPU draw the same image.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from swarm_tpu_torch._device import div
from swarm_tpu_torch.config import GridConfig


class RenderTheme(NamedTuple):
    """RGB uint8 palette (defaults after dual_bot_mapper.py:350-377)."""
    background: tuple = (15, 18, 24)       # UNKNOWN
    free: tuple = (34, 40, 49)             # FREE cells
    occupied: tuple = (120, 200, 255)      # OCCUPIED cells
    agent_colors: tuple = ((255, 120, 90), (90, 200, 255), (170, 255, 120),
                           (255, 210, 80), (220, 130, 255), (130, 255, 220))
    path_dim: float = 0.45                 # path = dimmed agent color
    robot: tuple = (255, 255, 255)
    zone: tuple = (255, 80, 80)
    frontier: tuple = (255, 255, 0)


def _f32(x, device):
    """A float input (numpy, list or tensor) as float32 on `device`, as the
    reference's arrays reach its float32 ops."""
    return torch.as_tensor(np.asarray(x, np.float32)
                           if not isinstance(x, torch.Tensor) else x,
                           device=device).to(torch.float32)


def _idx(x, device):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=device).to(torch.int64)


def _bool(x, n, device):
    if x is None:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=device).to(torch.bool)


def _set_pixels(img, px, py, valid, colors):
    """img[py, px] = colors (per entry [P, 3], or one [3]) where valid and
    inside the image; the last entry wins on a shared pixel."""
    h, w, _ = img.shape
    ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = torch.where(ok, py * w + px, torch.full_like(px, h * w))
    order = torch.arange(flat.shape[0], device=img.device)
    last = torch.full((h * w + 1,), -1, dtype=torch.int64,
                      device=img.device).scatter_reduce(0, flat, order,
                                                        "amax")[:h * w]
    hit = last >= 0
    if colors.dim() == 1:
        src = colors.expand(h * w, 3)
    else:
        src = colors[torch.clamp_min(last, 0)]
    out = img.reshape(-1, 3)
    return torch.where(hit[:, None], src, out).reshape(h, w, 3)


def _scatter_color(img, gx, gy, valid, color, size_px: int = 1):
    """Scatter `color` at integer pixel coords into img [H, W, 3], a square
    of `size_px` per point."""
    col = torch.tensor(color, dtype=img.dtype, device=img.device)
    for dy in range(-(size_px // 2), size_px // 2 + 1):
        for dx in range(-(size_px // 2), size_px // 2 + 1):
            img = _set_pixels(img, gx + dx, gy + dy, valid, col)
    return img


def world_to_px(wx, wy, cfg: GridConfig, scale: int):
    """World metres (float32) -> image pixels. Row 0 = TOP of the image =
    max y (image convention; the grid itself is row=gy upward)."""
    gx = (div(wx - cfg.origin_x, cfg.resolution) * scale).to(torch.int64)
    gy = (div(wy - cfg.origin_y, cfg.resolution) * scale).to(torch.int64)
    return gx, (cfg.size * scale - 1) - gy


def _linspace01(n: int, device):
    """The reference's float32 `jnp.linspace(0, 1, n)`: i / (n - 1)."""
    return div(torch.arange(n, dtype=torch.float32, device=device),
               float(n - 1))


def render_map(grid, cfg: GridConfig = GridConfig(), scale: int = 2,
               points_xy=None, points_agent=None, points_valid=None,
               paths_xy=None, paths_agent=None, paths_valid=None,
               poses=None, poses_valid=None,
               zones=None, zones_active=None,
               frontiers=None, n_frontiers=None,
               theme: RenderTheme = RenderTheme()):
    """Composite one frame on the grid's device. All inputs beyond the
    grid are optional; each may be a tensor or a numpy array.

    grid: [S, S] tri-state int8 (grid[gy, gx], like the reference).
    points_xy: [P, 2] world hits; points_agent: [P] 0-based (colors).
    paths_xy / paths_agent: [Q, 2]/[Q] trajectory samples.
    poses: [N, 3] robot (x, y, yaw), drawn as a dot + heading tick.
    zones: [N, 4] AABBs, drawn as outlines where zones_active.
    frontiers: [K, 2] centroids, first n_frontiers drawn.
    Returns [S*scale, S*scale, 3] uint8 on the grid's device.
    """
    grid = torch.as_tensor(grid)
    dev = grid.device
    s = grid.shape[0]
    u8 = dict(dtype=torch.uint8, device=dev)
    img = torch.tensor(theme.background, **u8).expand(s, s, 3)
    img = torch.where((grid == 0)[..., None],
                      torch.tensor(theme.free, **u8), img)
    img = torch.where((grid == 100)[..., None],
                      torch.tensor(theme.occupied, **u8), img)
    img = img.flip(0)                          # row 0 = max y
    if scale != 1:
        img = img.repeat_interleave(scale, 0).repeat_interleave(scale, 1)
    img = img.contiguous()

    colors = torch.tensor(theme.agent_colors, **u8)
    nc = colors.shape[0]

    if paths_xy is not None:
        xy = _f32(paths_xy, dev)
        px, py = world_to_px(xy[:, 0], xy[:, 1], cfg, scale)
        c = (colors[_idx(paths_agent, dev) % nc].to(torch.float32)
             * theme.path_dim).to(torch.uint8)
        img = _set_pixels(img, px, py, _bool(paths_valid, xy.shape[0], dev),
                          c)

    if points_xy is not None:
        xy = _f32(points_xy, dev)
        px, py = world_to_px(xy[:, 0], xy[:, 1], cfg, scale)
        c = colors[_idx(points_agent, dev) % nc]
        img = _set_pixels(img, px, py,
                          _bool(points_valid, xy.shape[0], dev), c)

    if zones is not None:
        # AABB outlines as sampled edge points
        z = _f32(zones, dev)
        act = _bool(zones_active, z.shape[0], dev)
        t = _linspace01(64, dev)
        for i in range(z.shape[0]):
            x0, y0, x1, y1 = z[i, 0], z[i, 1], z[i, 2], z[i, 3]
            ex = torch.cat([x0 + t * (x1 - x0), x0 + t * (x1 - x0),
                            torch.full_like(t, 0) + x0,
                            torch.full_like(t, 0) + x1])
            ey = torch.cat([torch.full_like(t, 0) + y0,
                            torch.full_like(t, 0) + y1,
                            y0 + t * (y1 - y0), y0 + t * (y1 - y0)])
            gx, gy = world_to_px(ex, ey, cfg, scale)
            img = _scatter_color(img, gx, gy, act[i].expand(ex.shape),
                                 theme.zone)

    if frontiers is not None:
        fr = _f32(frontiers, dev)
        k = fr.shape[0]
        nf = k if n_frontiers is None else int(n_frontiers)
        gx, gy = world_to_px(fr[:, 0], fr[:, 1], cfg, scale)
        img = _scatter_color(img, gx, gy,
                             torch.arange(k, device=dev) < nf,
                             theme.frontier, size_px=3)

    if poses is not None:
        p = _f32(poses, dev)
        valid = _bool(poses_valid, p.shape[0], dev)
        gx, gy = world_to_px(p[:, 0], p[:, 1], cfg, scale)
        img = _scatter_color(img, gx, gy, valid, theme.robot, size_px=3)
        # heading tick (reference draws oriented triangles, :585-600)
        for r in (2, 3, 4):
            c = r * cfg.resolution / scale * scale
            tx = p[:, 0] + c * torch.cos(p[:, 2])
            ty = p[:, 1] + c * torch.sin(p[:, 2])
            hx, hy = world_to_px(tx, ty, cfg, scale)
            img = _scatter_color(img, hx, hy, valid, theme.robot)

    return img


def render_points(points_xy, points_agent, cfg: GridConfig = GridConfig(),
                  scale: int = 2, theme: RenderTheme = RenderTheme(),
                  device=None):
    """Point-cloud-only view (generate_topdown_map.py:41-69 style), on the
    points' device (or `device` for numpy inputs)."""
    dev = points_xy.device if isinstance(points_xy, torch.Tensor) else \
        torch.device("cuda" if device is None else device)
    s = cfg.size
    img = torch.tensor(theme.background, dtype=torch.uint8,
                       device=dev).expand(s * scale, s * scale, 3)
    xy = _f32(points_xy, dev)
    px, py = world_to_px(xy[:, 0], xy[:, 1], cfg, scale)
    colors = torch.tensor(theme.agent_colors, dtype=torch.uint8, device=dev)
    c = colors[_idx(points_agent, dev) % colors.shape[0]]
    return _set_pixels(img.contiguous(), px, py,
                       torch.ones_like(px, dtype=torch.bool), c)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """[H, W, 3] uint8 (tensor or numpy) -> PNG bytes: 8-bit RGB, no
    interlace, filter 0 on every row, one zlib stream."""
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else \
        np.asarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode_png needs [H, W, 3] uint8, got "
                         f"{a.dtype} {a.shape}")
    h, w, _ = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * 3)], 1)
    return (b"\x89PNG\r\n\x1a\n" +
            _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
            _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) +
            _chunk(b"IEND", b""))


def save_png(img, path: str) -> str:
    """Write [H, W, 3] uint8 as a PNG (one copy to the host)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def render_ascii(grid, x_slice=None, y_slice=None) -> str:
    """Terminal map view for quick diagnostics (chars: '.' unknown,
    ' ' free, '#' occupied)."""
    g = grid.cpu().numpy() if isinstance(grid, torch.Tensor) else \
        np.asarray(grid)
    if y_slice:
        g = g[y_slice]
    if x_slice:
        g = g[:, x_slice]
    chars = {-1: ".", 0: " ", 100: "#"}
    return "\n".join("".join(chars.get(int(v), "?") for v in row)
                     for row in g[::-1])
