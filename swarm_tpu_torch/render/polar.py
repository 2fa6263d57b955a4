"""Polar scan views (swarm_tpu/render/polar.py) — the reference's live
polar radar
(server_nodes/room_mapper.py:47-110: 181 ranges on a polar axis, 0 deg at
top, clockwise, 4 m range rings, blue sweep line + red trusted dots and
the "Swarm Link" v2v HUD in the title) and the frame-by-frame polar scan
replay (playback_viewer.py:54-68, 10 fps), re-built headless on
matplotlib Agg so they run over SSH where the reference's interactive
TkAgg/Qt windows can't.

Faithful quirks kept/fixed:
  - the trust window is the reference's 0.01 < r <= 1.2 m for the radar
    (room_mapper.py:100) and r > 0.01 for the replay (playback_viewer
    .py:56) — both exposed as parameters;
  - the reference's `room_mapper.py` crashes with a NameError on
    UDP_PORT (:34) before ever plotting; the live radar here is the
    debugged equivalent (documented, not emulated — SURVEY §7 "emulate
    behavior, not bugs").
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np


def _polar_axes(plt, max_r: float):
    fig, ax = plt.subplots(subplot_kw={"projection": "polar"},
                           figsize=(6, 6), dpi=100)
    # reference orientation: 0 deg at top, clockwise (room_mapper.py:57-58)
    ax.set_theta_zero_location("N")
    ax.set_theta_direction(-1)
    ax.set_rlabel_position(45)
    ax.set_ylim(0, max_r)
    return fig, ax


def render_polar_frame(ranges, yaw: float = 0.0, v2v: int = 0,
                       title: Optional[str] = None,
                       trust_min: float = 0.01, trust_max: float = 1.2,
                       max_r: float = 4.0, out_path: Optional[str] = None):
    """One polar radar frame of a 181-ray scan (-90..+90 deg).

    Returns the rendered RGB array [H, W, 3]; writes a PNG when
    `out_path` is given. Readings outside (trust_min, trust_max] are
    blanked (NaN) exactly like the reference "doesn't ink them"
    (room_mapper.py:98-100)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r = np.asarray(ranges, np.float64).reshape(-1)
    angles = np.radians(np.linspace(-90.0, 90.0, r.shape[0]))
    clean = np.where((r > trust_min) & (r <= trust_max), r, np.nan)

    fig, ax = _polar_axes(plt, max_r)
    ax.plot(angles, np.nan_to_num(clean, nan=np.nan), "b-", linewidth=2)
    ok = ~np.isnan(clean)
    ax.scatter(angles[ok], clean[ok], c="red", s=20)
    if title is None:
        # the radar HUD line (room_mapper.py:107)
        title = (f"Map | Yaw: {math.degrees(float(yaw)):.1f}° | "
                 f"Swarm Link: {int(v2v)}")
    ax.set_title(title, fontsize=12)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if out_path:
        fig.savefig(out_path)
    plt.close(fig)
    return img


def playback_scan_frames(log, out_dir: str, every: int = 1,
                         limit: Optional[int] = None,
                         trust_min: float = 0.01,
                         trust_max: float = 4.0,
                         gif: Optional[str] = None,
                         fps: float = 10.0):
    """Frame-by-frame polar replay of a scan log
    (server.bridge.load_scan_log dict) — playback_viewer.py:54-68's loop
    as PNG frames (+ optional GIF at the reference's 10 fps cadence).
    Titles carry frame index / pose / encoder like the reference (:64).
    Returns the list of frame paths."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(log["t"])
    idx = range(0, n, every)
    if limit is not None:
        idx = list(idx)[:limit]
    paths = []
    for k, i in enumerate(idx):
        title = (f"Frame {i + 1}/{n} | Pos: ({float(log['x'][i]):.2f}, "
                 f"{float(log['y'][i]):.2f}) | "
                 f"Enc: {int(log['encoder'][i])}")
        p = os.path.join(out_dir, f"scan_{k:04d}.png")
        render_polar_frame(log["ranges"][i], yaw=float(log["yaw"][i]),
                           v2v=int(log["v2v"][i]), title=title,
                           trust_min=trust_min, trust_max=trust_max,
                           out_path=p)
        paths.append(p)
    if gif and paths:
        from PIL import Image
        imgs = [Image.open(p) for p in paths]
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=int(1000.0 / fps), loop=0)
    return paths


def live_polar_radar(port: int = 8888, out_path: str = "radar.png",
                     duration_s: Optional[float] = None,
                     trust_min: float = 0.01, trust_max: float = 1.2,
                     refresh_s: float = 0.1):
    """Live polar radar over UDP — the (debugged) room_mapper.py loop:
    bind, parse 751 B scan packets, re-render `out_path` on every scan
    with the yaw/Swarm-Link title, print the per-packet console line
    (:109). Returns the number of scans rendered."""
    import socket
    import time

    from swarm_tpu_torch.proto.packets import ScanPacket, parse_packet

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("0.0.0.0", port))
    sock.setblocking(False)
    print(f"[RADAR] listening on 0.0.0.0:{port}; rendering {out_path}")
    n_scans = 0
    t0 = time.time()
    last_render = 0.0
    try:
        while duration_s is None or time.time() - t0 < duration_s:
            try:
                data, _ = sock.recvfrom(65535)
            except BlockingIOError:
                time.sleep(0.01)
                continue
            pkt = parse_packet(data)
            if not isinstance(pkt, ScanPacket):
                continue
            n_scans += 1
            now = time.time()
            if now - last_render >= refresh_s:
                render_polar_frame(pkt.ranges, yaw=pkt.yaw, v2v=pkt.v2v,
                                   trust_min=trust_min,
                                   trust_max=trust_max, out_path=out_path)
                last_render = now
            ok = np.sum((pkt.ranges > trust_min) &
                        (pkt.ranges <= trust_max))
            print(f"Agent {pkt.agent} | Link: {pkt.v2v} | "
                  f"Enc: {pkt.encoder} | Points: {int(ok)}")
    except KeyboardInterrupt:
        pass
    finally:
        sock.close()
    return n_scans
