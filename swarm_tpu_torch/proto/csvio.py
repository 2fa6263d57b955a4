"""Session CSV schemas — byte-level parity with the reference's log format
(the port's copy of swarm_tpu/proto/csvio.py; numpy, except the packet
stream it hands to the replay engine, which is torch tensors).

The reference's CSV logs ARE its checkpoint/resume and test-fixture
mechanism (SURVEY §5): the live server (dual_bot_mapper.py:723-742,
866-905, 1009-1044) and the synthetic generator
(generate_fake_dual_session.py:365-371, 470-523) write identical schemas,
and playback/render tools consume them. This module writes the same files
with the same column names and number formatting, so the REFERENCE viewers
(playback_dual_session.py, render_bedroom_map.py) run unmodified on our
output — and our replay engine can ingest reference sessions.

Files in a session dir:
  telemetry.csv          time,agent,x,y,yaw_deg,encoder,v2v,front_cm,
                         left_cm,back_cm,right_cm,landmark
  pointcloud.csv         time,agent,sensor,x,y
  pointcloud_merged.csv  x,y
  pointcloud_bot{K}.csv  x,y
  slam_closures.csv      node_i,node_j,corr_dx,corr_dy
"""

from __future__ import annotations

import csv
import math
import os
from typing import Optional

import numpy as np

TELEMETRY_COLUMNS = ["time", "agent", "x", "y", "yaw_deg", "encoder",
                     "v2v", "front_cm", "left_cm", "back_cm", "right_cm",
                     "landmark"]
POINTCLOUD_COLUMNS = ["time", "agent", "sensor", "x", "y"]
CLOSURE_COLUMNS = ["node_i", "node_j", "corr_dx", "corr_dy"]
SENSOR_NAMES = ("front", "left", "back", "right")


def write_session(out_dir: str, t, agent, x, y, yaw_rad, encoder, v2v,
                  dist4_m, landmark,
                  hits_xy=None, hit_valid=None,
                  closures=None) -> str:
    """Write a full reference-schema session directory.

    t..landmark: [P] packet arrays (agent 1-based on disk, like the wire).
    hits_xy: [P, 4, 2] world hit points; hit_valid: [P, 4] trust-filter
    mask — rows appear in pointcloud.csv exactly when valid, matching
    dual_bot_mapper.py:881-894. closures: (node_i, node_j, dx, dy) arrays.
    Number formatting matches the reference writers
    (dual_bot_mapper.py:866-875, 893-894, 1034-1038).
    """
    os.makedirs(out_dir, exist_ok=True)
    t = np.asarray(t)
    agent = np.asarray(agent)
    dist4_m = np.asarray(dist4_m)
    p = len(t)

    with open(os.path.join(out_dir, "telemetry.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TELEMETRY_COLUMNS)
        for i in range(p):
            w.writerow([
                f"{float(t[i]):.3f}", int(agent[i]),
                f"{float(x[i]):.4f}", f"{float(y[i]):.4f}",
                f"{math.degrees(float(yaw_rad[i])):.2f}",
                int(encoder[i]), int(v2v[i]),
                f"{float(dist4_m[i, 0]) * 100:.1f}",
                f"{float(dist4_m[i, 1]) * 100:.1f}",
                f"{float(dist4_m[i, 2]) * 100:.1f}",
                f"{float(dist4_m[i, 3]) * 100:.1f}",
                int(landmark[i]),
            ])

    all_pts = []
    per_bot = {}
    with open(os.path.join(out_dir, "pointcloud.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(POINTCLOUD_COLUMNS)
        if hits_xy is not None:
            hits_xy = np.asarray(hits_xy)
            hit_valid = np.asarray(hit_valid)
            for i in range(p):
                for s, name in enumerate(SENSOR_NAMES):
                    if hit_valid[i, s]:
                        wx, wy = hits_xy[i, s]
                        w.writerow([f"{float(t[i]):.3f}", int(agent[i]),
                                    name, f"{wx:.4f}", f"{wy:.4f}"])
                        all_pts.append((wx, wy))
                        per_bot.setdefault(int(agent[i]), []).append((wx, wy))

    # derived artifacts (dual_bot_mapper.py:1009-1031)
    merged = np.asarray(all_pts, np.float32).reshape(-1, 2)
    np.savetxt(os.path.join(out_dir, "pointcloud_merged.csv"), merged,
               delimiter=",", header="x,y", comments="", fmt="%.4f")
    for bot, pts in sorted(per_bot.items()):
        np.savetxt(os.path.join(out_dir, f"pointcloud_bot{bot}.csv"),
                   np.asarray(pts, np.float32).reshape(-1, 2),
                   delimiter=",", header="x,y", comments="", fmt="%.4f")

    with open(os.path.join(out_dir, "slam_closures.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(CLOSURE_COLUMNS)
        if closures is not None:
            ni, nj, dx, dy = closures
            for i in range(len(ni)):
                w.writerow([int(ni[i]), int(nj[i]),
                            f"{float(dx[i]):.4f}", f"{float(dy[i]):.4f}"])
    return out_dir


class SessionWriter:
    """Streaming per-packet session logger — the live server's
    flushed-append CSV behavior (dual_bot_mapper.py:866-905: telemetry row
    + valid hit rows per packet, flushed immediately so a crash loses
    nothing)."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.dir = out_dir
        self._ft = open(os.path.join(out_dir, "telemetry.csv"), "w",
                        newline="")
        self._fp = open(os.path.join(out_dir, "pointcloud.csv"), "w",
                        newline="")
        self._wt = csv.writer(self._ft)
        self._wp = csv.writer(self._fp)
        self._wt.writerow(TELEMETRY_COLUMNS)
        self._wp.writerow(POINTCLOUD_COLUMNS)
        self._pts = {}

    def telemetry(self, t, agent, x, y, yaw_rad, encoder, v2v, dist4_m,
                  landmark):
        self._wt.writerow([
            f"{t:.3f}", int(agent), f"{x:.4f}", f"{y:.4f}",
            f"{math.degrees(yaw_rad):.2f}", int(encoder), int(v2v),
            f"{dist4_m[0] * 100:.1f}", f"{dist4_m[1] * 100:.1f}",
            f"{dist4_m[2] * 100:.1f}", f"{dist4_m[3] * 100:.1f}",
            int(landmark)])
        self._ft.flush()

    def points(self, t, agent, hits_xy, hit_valid):
        for s, name in enumerate(SENSOR_NAMES):
            if hit_valid[s]:
                wx, wy = float(hits_xy[s][0]), float(hits_xy[s][1])
                self._wp.writerow([f"{t:.3f}", int(agent), name,
                                   f"{wx:.4f}", f"{wy:.4f}"])
                self._pts.setdefault(int(agent), []).append((wx, wy))
        self._fp.flush()

    def close(self, closures=None):
        self._ft.close()
        self._fp.close()
        all_pts = [p for pts in self._pts.values() for p in pts]
        np.savetxt(os.path.join(self.dir, "pointcloud_merged.csv"),
                   np.asarray(all_pts, np.float32).reshape(-1, 2),
                   delimiter=",", header="x,y", comments="", fmt="%.4f")
        for bot, pts in sorted(self._pts.items()):
            np.savetxt(os.path.join(self.dir, f"pointcloud_bot{bot}.csv"),
                       np.asarray(pts, np.float32).reshape(-1, 2),
                       delimiter=",", header="x,y", comments="", fmt="%.4f")
        with open(os.path.join(self.dir, "slam_closures.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(CLOSURE_COLUMNS)
            if closures is not None:
                ni, nj, dx, dy = closures
                for i in range(len(ni)):
                    w.writerow([int(ni[i]), int(nj[i]),
                                f"{float(dx[i]):.4f}",
                                f"{float(dy[i]):.4f}"])


def load_session(session_dir: str):
    """Load telemetry.csv (+ pointcloud.csv if present) the way
    playback_dual_session.load_session does (:58-105): rows time-sorted.

    Returns dict of numpy arrays: t, agent (1-based), x, y, yaw_deg,
    encoder, v2v, dist_cm [P, 4], landmark; and points (t, agent, sensor
    index, x, y) or None."""
    tele_path = os.path.join(session_dir, "telemetry.csv")
    rows = np.genfromtxt(tele_path, delimiter=",", names=True,
                         dtype=None, encoding="utf-8")
    order = np.argsort(rows["time"], kind="stable")
    rows = rows[order]
    out = {
        "t": rows["time"].astype(np.float32),
        "agent": rows["agent"].astype(np.int32),
        "x": rows["x"].astype(np.float32),
        "y": rows["y"].astype(np.float32),
        "yaw_deg": rows["yaw_deg"].astype(np.float32),
        "encoder": rows["encoder"].astype(np.int32),
        "v2v": rows["v2v"].astype(np.int32),
        "dist_cm": np.stack([rows["front_cm"], rows["left_cm"],
                             rows["back_cm"], rows["right_cm"]],
                            axis=-1).astype(np.float32),
        "landmark": rows["landmark"].astype(np.int32),
        "points": None,
    }
    pc_path = os.path.join(session_dir, "pointcloud.csv")
    if os.path.exists(pc_path) and os.path.getsize(pc_path) > 40:
        pc = np.genfromtxt(pc_path, delimiter=",", names=True, dtype=None,
                           encoding="utf-8")
        pc = np.atleast_1d(pc)
        if pc.size:
            sensor_idx = np.array([SENSOR_NAMES.index(s)
                                   for s in pc["sensor"]], np.int32)
            out["points"] = {
                "t": pc["time"].astype(np.float32),
                "agent": pc["agent"].astype(np.int32),
                "sensor": sensor_idx,
                "x": pc["x"].astype(np.float32),
                "y": pc["y"].astype(np.float32),
            }
    return out


def packet_stream_from_telemetry(session, n_agents: Optional[int] = None,
                                 device=None):
    """Reference-schema telemetry -> the replay engine's PacketStream
    (agent 0-based, yaw radians, distances metres) on `device` (the card
    when None)."""
    import torch

    from swarm_tpu_torch._device import default_device
    from swarm_tpu_torch.engine.replay import PacketStream

    dev = default_device(device)

    def col(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    p = len(session["t"])
    return PacketStream(
        t=col(session["t"], np.float32),
        agent=col(session["agent"] - 1, np.int32),
        x=col(session["x"], np.float32),
        y=col(session["y"], np.float32),
        yaw=col(np.radians(session["yaw_deg"]), np.float32),
        encoder=col(session["encoder"], np.int32),
        v2v=col(session["v2v"], np.int32),
        dist=col(session["dist_cm"] / 100.0, np.float32),
        landmark=col(session["landmark"], np.int32),
        valid=torch.ones((p,), dtype=torch.bool, device=dev))
