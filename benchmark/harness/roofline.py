"""The yardstick of a kernel's roofline share: the card's published peaks
and the least bytes and operations the window raster's work needs.

Peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM
3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s. A share is stated
against them, with the card's power limit beside it (`card`).

The window raster's need, per launch: every grid cell that takes nonzero
evidence from some agent is read once, every cell whose bits change is
written once, and every agent's operands are read once and its count
written once (the arithmetic of chip_smoke.py's bounds, `needed_bytes`,
with the cells that take evidence in place of the covered windows: a cell
that takes no evidence need not be touched); and OPS_PER_CELL float
operations for each cell that takes evidence (csrc/free_raster.cu's count
per evaluated cell, swarm_tpu_torch/roofline.py; such a cell is one the
kernel must evaluate). Both count the work and not the form, so a kernel
that replaces it is held to the same need.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_CELL = 116
# per agent and fan: its window origin (2 int32), its pose and activity
# (x, y, yaw, active as float32) and its painted count (float32)
AGENT_OPERAND_BYTES = 8 + 16 + 4


def needed_bytes(elem: int, covered: int, changed: int,
                 operand_bytes: int) -> int:
    """The `covered` cells read once, the changed cells written once, the
    operands read and the counts written once."""
    return elem * (covered + changed) + operand_bytes


def table_bytes(n_beams: int, pack8: bool) -> int:
    """One agent's per-beam range table: 8-bit (pack8) or 16-bit fields
    packed into int32 words."""
    per_word = 4 if pack8 else 2
    return 4 * (-(-n_beams // per_word))


def least_seconds(n_bytes: float, n_ops: float):
    """(least time in s, what bounds it: "bytes" or "operations")."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_o = n_ops / FP32_OPS_PER_S
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def card() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"
