"""Geometric landmark signatures from 4-way range readings
(swarm_tpu/models/landmarks.py). The two variants of the reference differ
on purpose:

  * firmware (`detect_landmark_fw`, AgentFirmware_Bot1.ino:152-169):
    thresholds 40 cm / 80 cm, priority DEAD_END > CORNER_L > CORNER_R >
    CORRIDOR > OPEN;
  * simulator (`detect_landmark_sim`, the one the engine uses): threshold
    0.30 m, corners need the other side open, OPEN needs all three beyond
    the sensor's range, priority CORNER_L > CORNER_R > CORRIDOR > DEAD_END
    > OPEN.

Both are element-wise selects in which a later rule wins, as in the
reference's `where` chains. The codes are the server's table."""

from __future__ import annotations

import torch

LM_NONE = 0
LM_CORNER_L = 1
LM_CORNER_R = 2
LM_CORRIDOR = 3
LM_DEAD_END = 4
LM_OPEN = 5

LANDMARK_NAMES = {
    LM_NONE: "NONE", LM_CORNER_L: "CORNER_L", LM_CORNER_R: "CORNER_R",
    LM_CORRIDOR: "CORRIDOR", LM_DEAD_END: "DEAD_END", LM_OPEN: "OPEN",
}


def _select(shape, device, rules):
    """int32 codes: LM_NONE, then each (condition, code) in turn where its
    condition holds, so a later rule overrides an earlier one."""
    out = torch.full(shape, LM_NONE, dtype=torch.int32, device=device)
    for cond, code in rules:
        out = torch.where(cond, torch.full_like(out, code), out)
    return out


def detect_landmark_fw(front_m, left_m, right_m,
                       close_cm: float = 40.0, open_cm: float = 80.0):
    """Firmware-variant classifier (AgentFirmware_Bot1.ino:152-169) on
    readings in metres (the firmware converts to cm first; the back
    reading is not used). Returns int32 codes."""
    close, open_ = close_cm / 100.0, open_cm / 100.0
    f_c, l_c, r_c = front_m < close, left_m < close, right_m < close
    f_o, l_o, r_o = front_m > open_, left_m > open_, right_m > open_
    return _select(front_m.shape, front_m.device, [
        (f_o & l_o & r_o, LM_OPEN),
        (l_c & r_c & f_o, LM_CORRIDOR),
        (f_c & r_c, LM_CORNER_R),
        (f_c & l_c, LM_CORNER_L),
        (f_c & l_c & r_c, LM_DEAD_END),
    ])


def detect_landmark_sim(front_m, left_m, right_m,
                        close_m: float = 0.30, max_range_m: float = 1.20):
    """Simulator-variant classifier (generate_fake_dual_session.py:113-129).
    Returns int32 codes."""
    f, l, r = front_m, left_m, right_m
    c = close_m
    return _select(f.shape, f.device, [
        ((f > max_range_m) & (l > max_range_m) & (r > max_range_m), LM_OPEN),
        ((f < c) & (l < c) & (r < c), LM_DEAD_END),
        ((l < c) & (r < c) & (f > c), LM_CORRIDOR),
        ((f < c) & (r < c) & (l > c), LM_CORNER_R),
        ((f < c) & (l < c) & (r > c), LM_CORNER_L),
    ])
