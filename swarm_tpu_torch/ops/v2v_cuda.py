"""Pairwise V2V statistics: a CUDA kernel for Hopper and its plain torch
version.

Replaces no TPU kernel: the JAX package computes V2V in plain jnp
(swarm_tpu/engine/sim.py `v2v_stats`). Per agent i: the distance in whole
centimetres to the nearest live agent j != i (0 where there is none) and
the number of pairs within the radio range, where a dead or self pair
reads +inf (so it counts only at an infinite range).

`v2v_stats_plain` is the reference's chunked computation in torch: one
[chunk, N] block of squared distances live at a time above 2 * chunk
agents (when chunk divides N), masked with `where` and reduced with
`amin` and a count. At 32,768 agents it writes and re-reads [1024, 32768]
blocks 32 times a call.

What bounds it on the H100: N^2 pairs of about eight float32 and integer
operations (~0.3 ms at 32,768 agents at the instruction rate); its inputs
fit in L2. The kernel (csrc/v2v.cu) keeps each row's minimum and count in
registers, stages the columns in shared memory and never builds a block:
grid (row blocks of BLOCK_ROWS rows, column splits), the split count from
`split_columns` (N and the card's SM count, so the grid fills the card at
any N), the splits' partial results in a [2, splits, N] scratch reduced
exactly by a finishing kernel. It equals the plain version bit for bit:
every subtract, multiply and add rounded on its own, the range compared
as float32, NaN propagated through the minimum, the epilogue
`trunc(sqrt(d2min) * 100)` with IEEE square root.

`v2v_stats` dispatches on where the positions lie: a CPU tensor goes to
`v2v_stats_plain`; a CUDA tensor launches the kernel or raises.
`v2v_stats.launches` counts calls that launched the kernel (its pair
kernel and its finishing kernel) and nothing else;
`v2v_stats.launches_by_form` splits that count by the column split
(`splits-<k>`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from swarm_tpu_torch.ops import cuda_build

THREADS = 256          # csrc THREADS
ROWS = 4               # csrc ROWS: rows a thread
BLOCK_ROWS = THREADS * ROWS
TILE = THREADS         # csrc TILE: columns a staged tile
BLOCKS_PER_SM = 8      # blocks the split aims at, per SM


def v2v_stats_plain(txy, alive, radio_range_m: float = 10.0,
                    chunk: int = 1024):
    """Pairwise V2V link statistics: (nearest_cm [N] int32, in_range [N]
    int32). Above 2*chunk agents (and when chunk divides N) one [chunk, N]
    block is live at a time, the reference's chunking rule."""
    n = txy.shape[0]
    r2 = radio_range_m * radio_range_m
    ids = torch.arange(n, device=txy.device)

    def block_stats(rows_xy, row_ids):
        d2 = ((rows_xy[:, None, :] - txy[None, :, :]) ** 2).sum(-1)
        self_or_dead = (ids[None, :] == row_ids[:, None]) | ~alive[None, :]
        d2 = torch.where(self_or_dead, torch.full_like(d2, float("inf")), d2)
        return d2.amin(dim=1), (d2 <= r2).sum(dim=1).to(torch.int32)

    if n <= 2 * chunk or n % chunk != 0:
        d2min, cnt = block_stats(txy, ids)
    else:
        parts = [block_stats(txy[i:i + chunk], ids[i:i + chunk])
                 for i in range(0, n, chunk)]
        d2min = torch.cat([p[0] for p in parts])
        cnt = torch.cat([p[1] for p in parts])
    cm = torch.where(torch.isfinite(d2min), torch.sqrt(d2min) * 100.0,
                     torch.zeros_like(d2min)).to(torch.int32)
    return cm, cnt


def split_columns(n: int, sms: int) -> tuple:
    """(columns a split, splits) for n agents on a card of `sms` SMs: the
    fewest whole tiles a split that keep the row blocks times the splits
    near BLOCKS_PER_SM blocks an SM (above half of it, at most one row of
    blocks over it), or one tile a split where even that gives fewer."""
    row_blocks = -(-n // BLOCK_ROWS)
    tiles = -(-n // TILE)
    per_split = max(1, -(-tiles * row_blocks // (BLOCKS_PER_SM * sms)))
    cols = per_split * TILE
    return cols, -(-n // cols)


def form_name(splits: int) -> str:
    """The launch-count key of a launch over `splits` column splits."""
    return f"splits-{splits}"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.v2v_launch.argtypes = [P, P, I, F, I, I, P, P, P, P]
    lib.v2v_launch.restype = I


def _launch(txy, alive, r2: float):
    if txy.dtype != torch.float32 or txy.dim() != 2 or txy.shape[1] != 2:
        raise ValueError(f"the V2V kernel takes [N, 2] float32 positions, "
                         f"got {tuple(txy.shape)} {txy.dtype}")
    if alive.dtype != torch.bool or alive.shape != txy.shape[:1]:
        raise ValueError(f"the V2V kernel takes an [N] bool mask, got "
                         f"{tuple(alive.shape)} {alive.dtype}")
    if alive.device != txy.device:
        raise ValueError("positions and mask must lie on one device")
    txy, alive = txy.contiguous(), alive.contiguous()
    n = txy.shape[0]
    dev = txy.device
    cm = torch.empty((n,), dtype=torch.int32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    cols, splits = split_columns(n, _sm_count(dev.index))
    part = torch.empty((2, splits, n), dtype=torch.int32, device=dev)
    lib = cuda_build.load("v2v", _bind)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.v2v_launch(txy.data_ptr(), alive.data_ptr(), n, r2, cols,
                         splits, part.data_ptr(), cm.data_ptr(),
                         cnt.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"v2v launch failed: CUDA error {err}")
    v2v_stats.launches += 1
    name = form_name(splits)
    v2v_stats.launches_by_form[name] = \
        v2v_stats.launches_by_form.get(name, 0) + 1
    return cm, cnt


def v2v_stats(txy, alive, radio_range_m: float = 10.0, chunk: int = 1024):
    """Pairwise V2V link statistics: (nearest_cm [N] int32, in_range [N]
    int32) of positions txy [N, 2] and the live mask alive [N] bool.

    A CPU tensor goes to `v2v_stats_plain` (`chunk` governs only that
    path). A CUDA tensor launches the kernel; a failed build or launch
    raises."""
    if txy.device.type == "cpu":
        return v2v_stats_plain(txy, alive, radio_range_m, chunk)
    if txy.device.type != "cuda":
        raise ValueError(f"no V2V kernel for positions on {txy.device}")
    return _launch(txy, alive, radio_range_m * radio_range_m)


v2v_stats.launches = 0
v2v_stats.launches_by_form = {}
