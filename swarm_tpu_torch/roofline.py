"""Roofline of the deployable window kernel on the card (tools/roofline.py
on the port), and the bound arithmetic of chip_smoke.py's kernel records.

    python -m swarm_tpu_torch.roofline [--agents 1024]

The ceilings. The bound is taken against the published peaks of one H100
SXM (NVIDIA's data sheet): HBM_BYTES_PER_S and FP32_OPS_PER_S (float32
outside the tensor cores, which counts a fused multiply-add as two
operations), with the card's name and power limit beside them. Beside
them, two rates measured on the card:
  * the streaming bandwidth of a chained in-place multiply over 256 MB
    (each pass reads and writes the array, five times the 50 MB L2), CUDA
    events around STREAM_PASSES passes: `measured_hbm_stream_gbps`;
  * a float32 rate from csrc/fp32_probe.cu (`probe_chain`): each thread
    runs CHAINS independent dependent chains of compare, multiply, add and
    select in registers, so nothing folds and nothing waits on memory;
    its output is held bit-equal to the same chain in torch
    (`probe_chain_plain`) on a small block. Eager torch cannot stand in
    for the reference's fused XLA chain: each eager op reads and writes
    its tensor, so a chain of them measures bandwidth, not arithmetic.

The kernel row places the deployable window kernel (pack8 table, endpoint
ring, the 181-beam scan; `presets.deployable(--agents)`'s grid) on the
reference's inputs (tools/roofline.py:113-147: poses uniform in [1, 7) m
and rad, every reading 1 m, all agents active, a zero grid, zeroed again
before each launch). The kernel alone is timed by torch.profiler
(`device_ms`). Its bytes are the count of chip_smoke.py's records
(`needed_bytes`: the covered cells read once, the cells it changes written
once, the operands read and the counts written once); its operations
OPS_PER_CELL per evaluated cell (`box_cells`: its evaluation boxes).
`bound(bytes, operations)` is the least time the card could take; the
kernel's share of it is `kernel_bound_frac`.

Prints one JSON line with the reference's keys (`measured_vpu_tops_f32`
is the probe's rate) and the card, the peaks and the bound. It needs the
card: `--device cpu` raises ValueError.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

# H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Operations per evaluated cell of the window kernel's pack8 + ring form on
# a dense fan (csrc/free_raster.cu, the loop over a pair's cells, with
# csrc/raster_common.cuh `polar` and `atan2_poly`), one for each float or
# integer add, multiply, divide, square root, compare, min / max, select,
# round, conversion, shift and mask the source writes (FMA contraction is
# off: --fmad=false):
#   the box test (4 compares, 3 ands), the cell centre (2 integer adds,
#     2 conversions, 2 adds), dx and dy (2)                          15
#   polar: r2 (3), rinv = 1 / sqrt(max(r2, eps)) (3), r (1)           7
#     atan2_poly: |x|, |y|, max, min, max(hi, eps), z, z^2 (7), the
#     Horner polynomial (11), three octant folds (compare, subtract,
#     select: 9)                                                     27
#     the bearing less yaw and the fan offsets (4), the one-round wrap
#     (multiply, round, multiply, subtract: 4)                        8
#     the bin (multiply, add, floor, conversion: 4), the fan test
#     (2 compares, and), the clamp (min, max)                         9
#     the crossing count (multiply, round, max: 3), base_ok (2)       5
#   the pack8 lookup (shift, mask, multiply, shift, mask, mask,
#     conversion, scale; the trusted bit's shift and conversion)     10
#   the carve (subtract, compare, and), its delta (multiply, select,
#     multiply) and painted count (select); the ring (subtract, abs,
#     compare, and), its delta (2 multiplies, select, multiply, add)
#     and count (select, add); the double sum (1)                    19
#   the apply (add, clip: max, min, NaN keep), the clean test (2)     6
#   the walk (2 adds, compare, wrap), the cell's address (4), the
#     loop test (2)                                                  10
#                                                           in all  116
OPS_PER_CELL = 116
# of which the table lookup (the Pallas kernel's 117 were its select-tree
# gather; here it is an index into the table in shared memory)
LOOKUP_OPS_PER_CELL = 10

STREAM_ELEMS = 64 * 1024 * 1024      # 256 MB of float32
STREAM_PASSES = 64
CHAINS = 8                           # csrc/fp32_probe.cu CHAINS
PROBE_THREADS = 132 * 2048 * 4       # four waves of the card's 132 SMs
PROBE_ITERS = 2048
PROBE_CHECK = (4096, 64)             # threads, iterations of the check
KERNEL_REPS = 20
SEED = 0


def bound(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) for the bytes a function must
    move and the operations it must do, at the card's published peaks."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def needed_bytes(elem: int, covered: int, changed: int,
                 operand_bytes: int) -> int:
    """The bytes a raster needs on its inputs: the covered cells (the union
    of the windows) read once, the cells whose bits it changes written
    once, the operands read and the counts written once (`operand_bytes`).
    `elem` is the grid's element size."""
    return elem * (covered + changed) + operand_bytes


def covered_cells(w, size: int, dev, n_cols=None) -> int:
    """The cells of the union of the agents' windows (`w.row0`, `w.col0`,
    `w.rows`, `w.cols`) on a [size, n_cols or size] grid: windows are
    8-row (16 on bf16) and 128-column aligned, so an [S/8, S/128] mask
    counts them exactly."""
    blocks = torch.zeros((-(-size // 8), (n_cols or size) // 128),
                         dtype=torch.bool, device=dev)
    rb = (w.row0 // 8).long()[:, None] + torch.arange(w.rows // 8,
                                                      device=dev)
    cb = (w.col0 // 128).long()[:, None] + torch.arange(w.cols // 128,
                                                        device=dev)
    blocks[rb[:, :, None], cb[:, None, :]] = True
    return int(blocks.sum()) * 8 * 128


def box_cells(w, spec) -> int:
    """The cells the window kernel evaluates on a clean grid: per agent its
    evaluation box (`beam_raster_cuda.evaluation_box`) within its window
    and its fan-bbox strips."""
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    r_lo, r_hi, c_lo, c_hi = bc.evaluation_box(w.table, w.kind, w.ring,
                                               w.ax, w.ay, w.yaw, spec,
                                               w.n_bins)
    row0, col0 = w.row0.to(torch.float32), w.col0.to(torch.float32)
    rows = torch.minimum(r_hi, row0 + w.rows) - torch.maximum(r_lo, row0)
    lo = torch.maximum(torch.maximum(c_lo, col0),
                       col0 + 128 * w.t_cl.to(torch.float32))
    hi = torch.minimum(torch.minimum(c_hi, col0 + w.cols),
                       col0 + 128 * w.t_ch.to(torch.float32))
    return int((rows.clamp_min(0).double() *
                (hi - lo).clamp_min(0).double()).sum())


def device_ms(fn, reps: int, kernel: str, sessions: int = 3) -> float:
    """The mean device time of the kernel whose name holds `kernel` over
    `reps` calls of `fn`, from torch.profiler's CUDA activity (the kernel
    alone: no host gap, no other kernel of the call), over the launches it
    recorded (it can drop some). A session that recorded under half of the
    launches is run again, up to `sessions` in all; then it raises."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for row in prof.key_averages():
            if kernel in row.key:
                total += getattr(row, "device_time_total",
                                 getattr(row, "cuda_time_total", 0.0))
                count += row.count
        if 2 * count >= reps and total > 0:
            return total / count / 1e3
        seen.append(count)
    raise RuntimeError(f"profiler saw {seen} launches of {kernel} in "
                       f"{sessions} sessions of {reps}")


def card() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def _bind(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fp32_probe_launch.argtypes = [P, P, I, I, P]
    lib.fp32_probe_launch.restype = I
    lib.fp32_probe_chains.argtypes = []
    lib.fp32_probe_chains.restype = I


def probe_chain_plain(x, iters: int):
    """The probe's chain in torch: `iters` times v = where(v > 0.5,
    v * 0.99999, v + 1e-6), elementwise on x (float32)."""
    v = x.clone()
    for _ in range(iters):
        v = torch.where(v > 0.5, v * 0.99999, v + 1e-6)
    return v


def probe_chain(x, iters: int):
    """`probe_chain_plain` of x [T, CHAINS] float32: on a CUDA tensor one
    launch of csrc/fp32_probe.cu (a thread a row, the chains in
    registers); a CPU tensor goes to the plain version. Returns y like
    x."""
    if x.device.type == "cpu":
        return probe_chain_plain(x, iters)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != CHAINS \
            or not x.is_contiguous():
        raise ValueError(f"the probe takes a contiguous [T, {CHAINS}] "
                         f"float32 tensor")
    from swarm_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fp32_probe", _bind)
    if lib.fp32_probe_chains() != CHAINS:
        raise RuntimeError("csrc/fp32_probe.cu and roofline.CHAINS differ")
    y = torch.empty_like(x)
    err = lib.fp32_probe_launch(
        x.data_ptr(), y.data_ptr(), x.shape[0], iters,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fp32 probe launch failed: CUDA error {err}")
    probe_chain.launches += 1
    return y


probe_chain.launches = 0


def _events_ms(fn, n: int) -> float:
    """CUDA events around n calls of fn, after one warm call: ms a call."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def measure_hbm_bw(dev):
    """Streaming read + write GB/s of x *= 0.9999999 over STREAM_ELEMS
    float32, STREAM_PASSES chained passes. Returns (GB/s, ms a pass)."""
    x = torch.full((STREAM_ELEMS,), 1.0, dtype=torch.float32, device=dev)
    t = _events_ms(lambda: x.mul_(0.9999999), STREAM_PASSES)
    return 2 * STREAM_ELEMS * 4 / (t * 1e-3) / 1e9, t


def check_probe(dev) -> float:
    """The probe against its plain chain on a small block of the same
    inputs; returns the largest |difference| (0.0: they are bit-equal)."""
    t, iters = PROBE_CHECK
    x = torch.linspace(0.0, 1.0, t * CHAINS, device=dev).reshape(t, CHAINS)
    y_k = probe_chain(x, iters)
    y_p = probe_chain_plain(x, iters)
    if not torch.equal(y_k.view(torch.int32), y_p.view(torch.int32)):
        n = int((y_k.view(torch.int32) != y_p.view(torch.int32)).sum())
        raise AssertionError(f"fp32 probe: {n} of {y_k.numel()} values "
                             f"differ from the torch chain")
    return float((y_k - y_p).abs().max())


def measure_fp32(dev):
    """The probe's float32 rate: 4 operations a step, CHAINS chains of
    PROBE_ITERS steps on PROBE_THREADS threads. Returns (TOP/s, ms)."""
    x = torch.linspace(0.0, 1.0, PROBE_THREADS * CHAINS,
                       device=dev).reshape(PROBE_THREADS, CHAINS)
    t = _events_ms(lambda: probe_chain(x, PROBE_ITERS), 3)
    ops = 4 * CHAINS * PROBE_ITERS * PROBE_THREADS
    return ops / (t * 1e-3) / 1e12, t


def measure_kernel(agents: int, dev):
    """The deployable window kernel (pack8 + ring, 181-beam scan) on the
    reference's inputs at `agents` agents: its time alone, its window and
    what its bound counts."""
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops.beam_raster import (BeamSpec, beams_from_scan,
                                                 reach_cells)

    cfg = presets.deployable(agents, device=dev)[0]
    spec = BeamSpec.scan(181)
    reach = reach_cells(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pose = 1.0 + 6.0 * torch.rand((agents, 3), generator=gen, device=dev)
    db, tb = beams_from_scan(torch.ones((agents, 181), device=dev),
                             cfg.sensors.max_range, cfg.sensors.min_range)
    alive = torch.ones((agents,), dtype=torch.bool, device=dev)
    size = cfg.grid.size
    g = torch.zeros((size, size), dtype=torch.float32, device=dev)
    w = bc._windows(g, pose[:, :2].contiguous(), pose[:, 2].contiguous(),
                    db, alive, spec, cfg.grid, tb, reach, True)
    ln = bc._prepare(g, w, spec)
    dense = bc._dense_fan(spec, reach)

    def launch():
        g.zero_()
        bc._launch(g, ln, spec, cfg.grid, dense)

    launch()
    torch.cuda.synchronize()
    changed = int((g.view(torch.int32) != 0).sum())
    t_k = device_ms(launch, KERNEL_REPS, "free_raster_kernel")
    operands = sum(t.numel() * t.element_size()
                   for t in (ln.origins, ln.meta, ln.table)) + 4 * agents
    return dict(kernel_ms=t_k, rows=w.rows, cols=w.cols, grid_size=size,
                covered=covered_cells(w, size, dev), changed=changed,
                evaluated=box_cells(w, spec), operand_bytes=operands)


def run(agents: int, device=None) -> dict:
    """Every measurement of the tool on `device` (the card); the JSON
    record."""
    from swarm_tpu_torch._device import default_device

    dev = default_device(device)
    if dev.type != "cuda":
        raise ValueError(f"roofline measures the card; it cannot run on "
                         f"{dev}")
    name = card()
    bw, t_bw = measure_hbm_bw(dev)
    probe_err = check_probe(dev)
    fp32, t_fp32 = measure_fp32(dev)
    k = measure_kernel(agents, dev)
    t_k = k["kernel_ms"] * 1e-3
    n_bytes = needed_bytes(4, k["covered"], k["changed"],
                           k["operand_bytes"])
    n_ops = k["evaluated"] * OPS_PER_CELL
    b_ms, b_by = bound(n_bytes, n_ops)
    return {
        "platform": "gpu",
        "device": torch.cuda.get_device_name(dev),
        "card": name,
        "peak_hbm_gbps": HBM_BYTES_PER_S / 1e9,
        "peak_fp32_tops": FP32_OPS_PER_S / 1e12,
        "measured_hbm_stream_gbps": bw,
        "stream_pass_ms": t_bw,
        "measured_vpu_tops_f32": fp32,
        "probe_ms": t_fp32,
        "probe_max_abs_err": probe_err,
        "kernel_ms": k["kernel_ms"],
        "window": [k["rows"], k["cols"]],
        "window_cells_per_launch": agents * k["rows"] * k["cols"],
        "covered_cells": k["covered"],
        "changed_cells": k["changed"],
        "evaluated_cells": k["evaluated"],
        "needed_bytes": n_bytes,
        "kernel_hbm_gbps": n_bytes / t_k / 1e9,
        "kernel_hbm_frac": n_bytes / t_k / 1e9 / bw,
        "kernel_vpu_tops": n_ops / t_k / 1e12,
        "kernel_vpu_frac": n_ops / t_k / 1e12 / fp32,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "kernel_bound_frac": b_ms / k["kernel_ms"],
        "ops_per_cell": OPS_PER_CELL,
        "gather_ops_per_cell": LOOKUP_OPS_PER_CELL,
        "grid_size": k["grid_size"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="the card (default cuda); the tool needs one")
    args = ap.parse_args(argv)
    out = run(args.agents, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
