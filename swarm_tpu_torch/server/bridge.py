"""Scan bridge (swarm_tpu/server/bridge.py) — the ROS-2 UDP bridge +
standalone scan receiver rebuilt without DDS.

The reference's `udp_bridge.py` turns 751-byte scan packets into
`/agent_N/odom` + `/agent_N/scan` topics and relays `/agent_N/cmd_vel`
back as CMD1 datagrams (:89-148); `udp_receiver_standalone.py` appends
per-agent scan CSVs (:32-84). Here "topics" are plain Python callbacks
(no rclpy in the loop), the per-agent CSV schema matches the reference's
byte-for-byte, and scans can optionally stream into the beam-model
occupancy grid (the fused engine's beam tier, `ops/beam_raster
.beam_raster_reference`, on the device the bridge is given: the card when
None) — the mapping path the reference delegated to an external nav stack.
"""

from __future__ import annotations

import csv
import math
import os
import socket
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.proto.packets import (CommandPacket, ScanPacket,
                                           ScanPacketBridge, parse_packet)

SCAN_CSV_HEADER = (["timestamp", "idx", "x", "y", "yaw", "encoder",
                    "v2v_link"] + [f"r_{i}" for i in range(181)])


class ScanBridge:
    """Bidirectional scan-packet endpoint.

    on_odom(agent, x, y, yaw, quat_zw) and on_scan(agent, ranges[181])
    callbacks replace the bridge's publishers; `send_cmd_vel` replaces the
    cmd_vel subscription (dead-man behavior lives on the robot,
    esp32_firmware/src/main.cpp:153-155)."""

    # LaserScan constants the bridge publishes (udp_bridge.py:123-133)
    ANGLE_MIN = -math.pi / 2
    ANGLE_INC = math.pi / 180.0
    RANGE_MIN = 0.05
    RANGE_MAX = 2.0

    def __init__(self, port: int = 8888, log_dir: Optional[str] = None,
                 on_odom: Optional[Callable] = None,
                 on_scan: Optional[Callable] = None,
                 map_cfg=None, device=None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 4 * 1024 * 1024)
        except OSError:
            pass
        self.sock.bind(("0.0.0.0", port))
        self.sock.setblocking(False)
        self.clients: Dict[int, Tuple[str, int]] = {}
        self.on_odom = on_odom
        self.on_scan = on_scan
        self.log_dir = log_dir
        self.latest: Dict[int, ScanPacket] = {}
        self.pkt_total = 0
        self._csv_files = {}

        # optional live mapping of scans via the beam model
        self._map_cfg = map_cfg
        self._logodds = None
        if map_cfg is not None:
            from swarm_tpu_torch.ops.beam_raster import BeamSpec

            self._device = default_device(device)
            self._logodds = torch.zeros((map_cfg.size, map_cfg.size),
                                        dtype=torch.float32,
                                        device=self._device)
            self._spec = BeamSpec.scan(181)
            # VL53L0X reach is 2.0 m (RANGE_MAX) -> wider agent windows
            self._reach = int(self.RANGE_MAX / map_cfg.resolution) + 2

    def poll(self, max_packets: int = 100) -> int:
        """Drain + dispatch up to max_packets datagrams (the bridge's
        100 Hz udp_callback, udp_bridge.py:41-51). Returns count."""
        n = 0
        for _ in range(max_packets):
            try:
                data, addr = self.sock.recvfrom(65535)
            except BlockingIOError:
                break
            # Both scan layouts: 751 B (standalone receiver) and the 743 B
            # bridge variant the PlatformIO firmware transmits
            # (udp_bridge.py:34; esp32_firmware/src/main.cpp:30-41).
            pkt = parse_packet(data)
            if not isinstance(pkt, (ScanPacket, ScanPacketBridge)):
                continue
            n += 1
            self.pkt_total += 1
            agent = pkt.agent
            if agent not in self.clients:
                self.clients[agent] = addr
                print(f"[NEW] Agent {agent} connected from {addr}")
            self.latest[agent] = pkt
            if self.on_odom:
                half = pkt.yaw / 2.0
                self.on_odom(agent, pkt.x, pkt.y, pkt.yaw,
                             (math.sin(half), math.cos(half)))
            if self.on_scan:
                self.on_scan(agent, pkt.ranges)
            if self.log_dir:
                self._log_csv(pkt)
            if self._logodds is not None:
                self._apply_scan(pkt)
        return n

    def _apply_scan(self, pkt):
        """One scan into the live log-odds grid (in place)."""
        from swarm_tpu_torch.ops.beam_raster import (beam_raster_reference,
                                                     beams_from_scan)

        dev = self._device
        scan = torch.as_tensor(np.asarray(pkt.ranges, np.float32),
                               device=dev)[None]
        d, tr = beams_from_scan(scan, self.RANGE_MAX, self.RANGE_MIN)
        beam_raster_reference(
            self._logodds,
            torch.tensor([[pkt.x, pkt.y]], dtype=torch.float32, device=dev),
            torch.tensor([pkt.yaw], dtype=torch.float32, device=dev),
            d, tr, self._spec, self._map_cfg, reach=self._reach)

    def _log_csv(self, pkt: ScanPacket):
        """Per-agent scan CSV, reference schema
        (udp_receiver_standalone.py:69-84)."""
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"agent_{pkt.agent}_log.csv")
        new = not os.path.isfile(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(SCAN_CSV_HEADER)
            valid = [r for r in pkt.ranges if 0.01 < r < 3.9]
            w.writerow([time.time(), len(valid), pkt.x, pkt.y, pkt.yaw,
                        pkt.encoder, pkt.v2v] + list(pkt.ranges))

    def send_cmd_vel(self, agent: int, linear_x: float,
                     angular_z: float) -> bool:
        """cmd_vel -> CMD1 relay (udp_bridge.py:140-148)."""
        addr = self.clients.get(agent)
        if addr is None:
            return False
        try:
            self.sock.sendto(CommandPacket(linear_x, angular_z).pack(), addr)
            return True
        except OSError as e:
            print(f"[CMD] send to agent {agent} failed: {e}")
            return False

    @property
    def logodds(self):
        return self._logodds

    def close(self):
        self.sock.close()


def load_scan_log(path: str):
    """Load a per-agent scan CSV (ours or the reference's) -> dict of
    arrays, for the top-down/polar viewers (generate_topdown_map.py:13-40)."""
    rows = np.genfromtxt(path, delimiter=",", names=True, dtype=None,
                         encoding="utf-8")
    rows = np.atleast_1d(rows)
    ranges = np.stack([rows[f"r_{i}"] for i in range(181)],
                      axis=-1).astype(np.float32)
    return {
        "t": rows["timestamp"].astype(np.float64),
        "x": rows["x"].astype(np.float32),
        "y": rows["y"].astype(np.float32),
        "yaw": rows["yaw"].astype(np.float32),
        "encoder": rows["encoder"].astype(np.int64),
        "v2v": rows["v2v_link"].astype(np.int64),
        "ranges": ranges,
    }


def scan_log_points(log, trust_max: float = 1.2, trust_min: float = 0.05):
    """Scan log -> world-frame hit points (the top-down map projection,
    generate_topdown_map.py:41-60). Returns [P, 2]."""
    angles = (log["yaw"][:, None] + ScanBridge.ANGLE_MIN
              + np.arange(181)[None, :] * ScanBridge.ANGLE_INC)
    r = log["ranges"]
    ok = (r > trust_min) & (r <= trust_max)
    px = log["x"][:, None] + r * np.cos(angles)
    py = log["y"][:, None] + r * np.sin(angles)
    return np.stack([px[ok], py[ok]], axis=-1)
