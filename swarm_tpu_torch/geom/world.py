"""World geometry: wall segments and batched exact ray casting
(swarm_tpu/geom/world.py).

The builders are numpy, as in the reference module (which imports jax at
its top, so the port carries its own copies of the few it needs). Ray
casting is torch, batched over agents: a ray batch `[N, R]` is intersected
with per-agent walls `[N, S, 4]` (each agent's own room, sim.py:765-766) or
with one shared `[S, 4]` wall set.
"""

from __future__ import annotations

import numpy as np
import torch

# The reference's bedroom: a 6 m x 4 m hall, x in [-0.5, 5.5], y in
# [-2, 2] (the dual-bot session's world).
BEDROOM_WALLS = np.array(
    [
        [-0.5, -2.0, 5.5, -2.0],   # bottom
        [5.5, -2.0, 5.5, 2.0],     # right
        [5.5, 2.0, -0.5, 2.0],     # top
        [-0.5, 2.0, -0.5, -2.0],   # left
    ],
    dtype=np.float32,
)

RAY_MISS = 99.0        # sentinel for "no wall within 50 m"
RAY_MAX_VALID = 50.0

TILE_ROWS = 128          # grid-tile room pitch (cells): 6.4 m x 12.8 m
TILE_COLS = 256


def make_rect_room(x0: float, y0: float, x1: float, y1: float) -> np.ndarray:
    """Axis-aligned rectangular room as 4 wall segments [4, 4]."""
    return np.array(
        [
            [x0, y0, x1, y0],
            [x1, y0, x1, y1],
            [x1, y1, x0, y1],
            [x0, y1, x0, y0],
        ],
        dtype=np.float32,
    )


def make_multi_room(n_rooms: int, room_w: float = 6.0, room_h: float = 4.0,
                    gap: float = 2.0, per_row: int = 32) -> np.ndarray:
    """n_rooms copies of the bedroom on a grid of rooms, `per_row` to a
    row, `gap` metres apart: the untiled world of the large swarms. One
    flat [4 * n_rooms, 4] array of segments."""
    rooms = []
    for i in range(n_rooms):
        r, c = divmod(i, per_row)
        ox = c * (room_w + gap)
        oy = r * (room_h + gap)
        rooms.append(make_rect_room(ox - 0.5, oy - 2.0,
                                    ox + room_w - 0.5, oy + room_h - 2.0))
    return np.concatenate(rooms, axis=0)


def make_tiled_rooms(n_rooms: int, per_row: int, res: float = 0.05,
                     room_w: float = 6.0, room_h: float = 4.0):
    """Rooms laid out so each sits inside ONE [TILE_ROWS, TILE_COLS] grid
    tile (origin at world (0, 0)). Returns (walls [n_rooms*4, 4],
    room_origin_xy [n_rooms, 2])."""
    pitch_x = TILE_COLS * res
    pitch_y = TILE_ROWS * res
    mx = (pitch_x - room_w) / 2.0
    my = (pitch_y - room_h) / 2.0
    rooms = []
    origins = []
    for i in range(n_rooms):
        r, c = divmod(i, per_row)
        ox = c * pitch_x
        oy = r * pitch_y
        rooms.append(make_rect_room(ox + mx, oy + my,
                                    ox + mx + room_w, oy + my + room_h))
        origins.append((ox + mx, oy + my))
    return (np.concatenate(rooms, axis=0),
            np.asarray(origins, np.float32))


def make_tiled_rooms_blocks(dev_rows: int, dev_cols: int, size: int,
                            res: float = 0.05, room_w: float = 6.0,
                            room_h: float = 4.0):
    """Tiled rooms in DEVICE-MAJOR order for a (dev_rows x dev_cols) rank
    grid over a [size, size] grid: rank (dr, dc) owns the contiguous block
    of room tiles inside its grid tile, and rooms are listed rank by rank,
    so the natural agent order (agents 2k, 2k+1 in room k) puts each
    rank's agents inside its own tile, as the "tiles" decomposition's
    static containment proof needs. Returns (walls [n_rooms*4, 4],
    origins [n_rooms, 2]); n_rooms = (size/128) * (size/256)."""
    tiles_r, tiles_c = size // TILE_ROWS, size // TILE_COLS
    if tiles_r % dev_rows or tiles_c % dev_cols:
        raise ValueError(f"{tiles_r}x{tiles_c} room tiles do not split "
                         f"over a ({dev_rows}, {dev_cols}) device grid")
    k_r, k_c = tiles_r // dev_rows, tiles_c // dev_cols
    pitch_x, pitch_y = TILE_COLS * res, TILE_ROWS * res
    mx, my = (pitch_x - room_w) / 2.0, (pitch_y - room_h) / 2.0
    rooms, origins = [], []
    for dr in range(dev_rows):
        for dc in range(dev_cols):
            for jr in range(k_r):
                for jc in range(k_c):
                    tr, tc = dr * k_r + jr, dc * k_c + jc
                    ox, oy = tc * pitch_x, tr * pitch_y
                    rooms.append(make_rect_room(ox + mx, oy + my,
                                                ox + mx + room_w,
                                                oy + my + room_h))
                    origins.append((ox + mx, oy + my))
    return np.concatenate(rooms, axis=0), np.asarray(origins, np.float32)


def make_vertical_rooms(n_rooms: int):
    """One tiled room per grid-tile ROW (per_row=1): room r occupies tile
    row r, so n_rooms ranks can own one 128-row band each, the layout of
    the "rows" decomposition. Returns (walls [n_rooms*4, 4], origins
    [n_rooms, 2], grid_size)."""
    walls, origins = make_tiled_rooms(n_rooms, per_row=1)
    size = -(-max(256, n_rooms * TILE_ROWS) // 256) * 256
    return walls, origins, size


def walls_by_group(walls: np.ndarray, segs_per_group: int = 4) -> np.ndarray:
    """[S, 4] flat segments -> [G, segs_per_group, 4] grouped view."""
    s = walls.shape[0]
    if s % segs_per_group:
        raise ValueError(f"{s} segments do not split into groups of "
                         f"{segs_per_group}")
    return walls.reshape(s // segs_per_group, segs_per_group, 4)


def agent_room_boxes(walls_grouped, room_of_agent) -> np.ndarray:
    """Per-agent room box in world metres, [N, 4] float32 (x0, y0, x1, y1):
    the bounds of each agent's own room's segments. Host numpy; restricts
    frontier-target assignment to frontiers the agent can reach."""
    wg = np.asarray(walls_grouped)
    roa = np.asarray(room_of_agent)
    xs = wg[..., [0, 2]].reshape(wg.shape[0], -1)
    ys = wg[..., [1, 3]].reshape(wg.shape[0], -1)
    return np.stack([xs.min(1)[roa], ys.min(1)[roa],
                     xs.max(1)[roa], ys.max(1)[roa]], -1).astype(np.float32)


def cast_rays_grouped(origins, angles, walls_grouped, group_of_ray):
    """Culled ray casting: each ray meets only its own group's segments,
    exact where the groups are closed rooms (nothing is seen across rooms)
    and O(segments per group) instead of O(all segments).

    origins [..., 2]; angles [...]; walls_grouped [G, S_g, 4]; group_of_ray
    [...] int. Returns [...] distances, RAY_MISS beyond RAY_MAX_VALID."""
    walls = walls_grouped[group_of_ray.long()]          # [..., S_g, 4]
    t = ray_segment_t(origins[..., 0], origins[..., 1], torch.cos(angles),
                      torch.sin(angles), walls)
    d = torch.amin(t, dim=-1)
    return torch.where(d < RAY_MAX_VALID, d, torch.full_like(d, RAY_MISS))


def ray_segment_t(ox, oy, dx, dy, walls):
    """Parametric hit distances of rays against wall segments.

    ox, oy, dx, dy: [..., R] ray origins and unit directions.
    walls: [S, 4], or [..., 1, S, 4] with batch dims broadcasting against
    the rays' (x1, y1, x2, y2 per segment).
    Returns t [..., R, S], +inf where the ray misses that segment: rejects
    |denom| < 1e-10, requires t > 0.001 and 0 <= u <= 1.
    """
    sx1, sy1 = walls[..., 0], walls[..., 1]
    dsx = walls[..., 2] - sx1
    dsy = walls[..., 3] - sy1

    ox = ox[..., None]
    oy = oy[..., None]
    dx = dx[..., None]
    dy = dy[..., None]

    denom = dx * dsy - dy * dsx
    rx = sx1 - ox
    ry = sy1 - oy
    parallel = torch.abs(denom) < 1e-10
    safe = torch.where(parallel, torch.ones_like(denom), denom)
    t = (rx * dsy - ry * dsx) / safe
    u = (rx * dy - ry * dx) / safe

    valid = ~parallel & (t > 1e-3) & (u >= 0.0) & (u <= 1.0)
    return torch.where(valid, t, torch.full_like(t, float("inf")))


def cast_rays(origins, angles, walls):
    """Distance to the nearest wall for each ray.

    origins: [..., R, 2]; angles: [..., R] world headings; walls as in
    `ray_segment_t`. Returns [..., R], RAY_MISS where nothing is hit
    within 50 m.
    """
    t = ray_segment_t(origins[..., 0], origins[..., 1],
                      torch.cos(angles), torch.sin(angles), walls)
    d = torch.amin(t, dim=-1)
    return torch.where(d < RAY_MAX_VALID, d, torch.full_like(d, RAY_MISS))
