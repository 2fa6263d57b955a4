"""Live UDP mapping server (swarm_tpu/server/live.py) — the reference's
`dual_bot_mapper.py` main loop (:713-1048) on the port's replay engine.

The socket drains up to `max_packets_per_frame` datagrams per frame (ref
:816), the native batch codec (native/src/codec.cpp) turns them into
column arrays, and the frame is applied on the device: in "parity" mode
packet by packet through `engine.replay.ingest_packet` (the reference's
order and cadences exactly), in "throughput" mode as one
`engine.replay.ingest_frame` (the grid order-exact, closures and cadences
once per frame). A frame's outputs reach the host with one copy per array.
ZONE/TARG packets go back over UDP on the reference's cadences; session
CSVs stream through proto.csvio.SessionWriter.

Generalises the reference's two hardcoded bots (ports 8888/8889) to N
agents with a bot-address registry learned from the packets' source
addresses. The wire names at most 255 agents (one byte); an agent number
past `n_agents` is dropped.
"""

from __future__ import annotations

import socket
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swarm_tpu_torch._device import default_device
from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.proto.csvio import SessionWriter
from swarm_tpu_torch.proto.packets import (QuasarPacketV1, QuasarPacketV2,
                                           TargetPacket, ZonePacket,
                                           parse_packet)


class ViewTrails:
    """Bounded live point-cloud + path rings for the operator view — the
    reference dashboard's per-sensor clouds (dual_bot_mapper.py:560-572)
    and paths (:583), fixed-size numpy rings so a long run cannot grow host
    memory. Kept only while a view is attached."""

    def __init__(self, cloud_cap: int = 20000, path_cap: int = 10000):
        self.cloud_xy = np.zeros((cloud_cap, 2), np.float32)
        self.cloud_agent = np.zeros(cloud_cap, np.int32)
        self.cloud_sensor = np.zeros(cloud_cap, np.int8)
        self.cloud_n = 0
        self.cloud_cur = 0
        self.path_xy = np.zeros((path_cap, 2), np.float32)
        self.path_agent = np.zeros(path_cap, np.int32)
        self.path_n = 0
        self.path_cur = 0

    def _push(self, buf_xy, buf_a, cur, n, xy, agent, buf_s=None, sens=None):
        cap = len(buf_xy)
        k = min(len(xy), cap)
        idx = (cur + np.arange(k)) % cap
        buf_xy[idx] = xy[-k:]
        buf_a[idx] = agent[-k:]
        if buf_s is not None:
            buf_s[idx] = sens[-k:]
        return (cur + k) % cap, min(n + k, cap)

    def observe(self, agents0, rx, ry, hits, hv):
        """One ingested frame's world-projected hits + poses (numpy)."""
        n_real = len(agents0)
        if n_real == 0:
            return
        a4 = np.repeat(np.asarray(agents0, np.int32), 4)
        s4 = np.tile(np.arange(4, dtype=np.int8), n_real)
        ok = np.asarray(hv[:n_real]).reshape(-1)
        pts = np.asarray(hits[:n_real], np.float32).reshape(-1, 2)
        if ok.any():
            self.cloud_cur, self.cloud_n = self._push(
                self.cloud_xy, self.cloud_agent, self.cloud_cur,
                self.cloud_n, pts[ok], a4[ok],
                self.cloud_sensor, s4[ok])
        pxy = np.stack([np.asarray(rx[:n_real], np.float32),
                        np.asarray(ry[:n_real], np.float32)], -1)
        self.path_cur, self.path_n = self._push(
            self.path_xy, self.path_agent, self.path_cur, self.path_n,
            pxy, np.asarray(agents0, np.int32))

    def snapshot_layers(self):
        c, p = self.cloud_n, self.path_n
        return {
            "points": (self.cloud_xy[:c], self.cloud_agent[:c]),
            "points_sensor": self.cloud_sensor[:c],
            "paths": (self.path_xy[:p], self.path_agent[:p]),
        }


class LiveServer:
    """Bind, ingest, coordinate: the counterpart of dual_bot_mapper.py's
    loop, its state on `device` (the card when None).

    native_codec=True parses datagrams with the native batch codec and
    raises when the library cannot be built or loaded; native_codec=False
    is the explicit choice of the per-packet Python struct codec."""

    def __init__(self, cfg: SwarmConfig = SwarmConfig(), port: int = 8888,
                 separation: float = 5.0, log_dir: Optional[str] = None,
                 enable_targets: bool = False,
                 bot_tx_port_base: int = 8888,
                 native_codec: bool = True,
                 ingest_mode: str = "parity", device=None):
        from swarm_tpu_torch.engine.replay import server_init

        if ingest_mode not in ("parity", "throughput"):
            raise ValueError(f"unknown ingest_mode {ingest_mode!r}")
        self.ingest_mode = ingest_mode
        self.native_codec = native_codec
        if native_codec:
            from swarm_tpu_torch.native import parse_telemetry_columns
            parse_telemetry_columns([b"QSRL"])     # build + load now
        self.device = default_device(device)
        self.cfg = cfg
        self.enable_targets = enable_targets
        self.n = cfg.n_agents
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # Burst headroom: the reference drains only 20 pkts/frame (:816);
        # a deep kernel buffer absorbs bot bursts between frames.
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 4 * 1024 * 1024)
        except OSError:
            pass
        self.sock.bind(("0.0.0.0", port))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        # agent -> (ip, port); learned from RX. The reference sends to
        # fixed per-bot ports 8888/8889 (:758-759).
        self.bot_addrs: Dict[int, Tuple[str, int]] = {}
        self.bot_tx_port_base = bot_tx_port_base
        self.t0 = time.time()
        self.state = server_init(cfg, t0=0.0, device=self.device)
        self.offsets = torch.tensor(
            [0.0 if a % 2 == 0 else separation for a in range(self.n)],
            dtype=torch.float32, device=self.device)
        self.writer = SessionWriter(log_dir) if log_dir else None
        self.online_prev = np.zeros(self.n, bool)
        self.pkt_total = 0
        self._trails: Optional[ViewTrails] = None
        self._batch_size = cfg.engine.max_packets_per_frame

        # scan-matched closures while serving (SlamConfig
        # .closure_scanmatch, throughput ingest only): scan payloads update
        # a host-side latest-sweep table that rides into the frame
        # application, so the closure log carries measured SE(2) edges
        self.latest_scans = None
        if (cfg.slam.closure_scanmatch and cfg.engine.scan_rays > 0
                and ingest_mode == "throughput"):
            self.latest_scans = np.zeros(
                (self.n, cfg.engine.scan_rays), np.float32)

    def now(self) -> float:
        return time.time() - self.t0

    # -- RX ------------------------------------------------------------------

    def drain_socket(self):
        """<= max_packets_per_frame datagrams -> parsed telemetry list
        (the Python struct codec)."""
        out = []
        for _ in range(self._batch_size):
            try:
                data, addr = self.sock.recvfrom(2048)
            except BlockingIOError:
                break
            pkt = parse_packet(data)
            if isinstance(pkt, (QuasarPacketV2, QuasarPacketV1)):
                agent0 = pkt.agent - 1
                if 0 <= agent0 < self.n:
                    self.bot_addrs.setdefault(
                        agent0, (addr[0], self.bot_tx_port_base + agent0))
                    out.append((agent0, pkt))
            elif self.latest_scans is not None and hasattr(pkt, "ranges"):
                # 751/743 B scan payloads feed the measured-closure table
                agent0 = pkt.agent - 1
                if 0 <= agent0 < self.n:
                    r = np.asarray(pkt.ranges, np.float32)
                    k = min(len(r), self.latest_scans.shape[1])
                    self.latest_scans[agent0, :k] = r[:k]
        return out

    def ingest(self, pkts) -> None:
        """Apply one frame of typed packets."""
        agents, cols = self._columns_from_pkts(pkts)
        if len(agents):
            self.ingest_columns(agents, cols)

    def _columns_from_pkts(self, pkts):
        """Typed packets -> the column arrays ingest_columns consumes."""
        n_real = min(len(pkts), self._batch_size)
        pk = [p for _, p in pkts[:n_real]]
        agents = np.asarray([a for a, _ in pkts[:n_real]], np.int32)
        cols = {
            "x": np.asarray([p.x for p in pk], np.float32),
            "y": np.asarray([p.y for p in pk], np.float32),
            "yaw": np.asarray([p.yaw for p in pk], np.float32),
            "encoder": np.asarray([p.encoder for p in pk], np.int32),
            "v2v": np.asarray([p.v2v for p in pk], np.int32),
            "dist4": np.asarray([[p.front, p.left, p.back, p.right]
                                 for p in pk], np.float32).reshape(n_real, 4),
            "landmark": np.asarray([getattr(p, "landmark", 0) for p in pk],
                                   np.int32),
        }
        return agents, cols

    def _apply(self, batch):
        """One frame on the device -> (new state, ReplayOutputs)."""
        from swarm_tpu_torch.engine.replay import (PacketStream,
                                                   ReplayOutputs,
                                                   ingest_frame,
                                                   ingest_packet)

        kw = dict(enable_targets=self.enable_targets,
                  compute_frontiers=True)
        if self.ingest_mode == "throughput":
            scans = (None if self.latest_scans is None else
                     torch.as_tensor(self.latest_scans, device=self.device))
            return ingest_frame(self.state, batch, self.cfg, self.offsets,
                                scans=scans, **kw)
        st, outs = self.state, []
        for i in range(batch.t.shape[0]):
            st, o = ingest_packet(st, PacketStream(*(f[i] for f in batch)),
                                  self.cfg, self.offsets, **kw)
            outs.append(o)
        return st, ReplayOutputs(*(torch.stack(f) for f in zip(*outs)))

    def ingest_columns(self, agents0, cols, now: Optional[float] = None):
        """Apply one frame's telemetry given as column arrays (what the
        native codec produces), stamped `now` (the server clock when
        None). The new state replaces `self.state`; the old one is never
        written, so a reader holding it sees a consistent snapshot."""
        from swarm_tpu_torch.engine.replay import PacketStream

        now = self.now() if now is None else now
        n_real = min(len(agents0), self._batch_size)
        if n_real == 0:
            return
        dev = self.device

        def col(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a[:n_real], dtype),
                                   device=dev)

        batch = PacketStream(
            t=torch.full((n_real,), float(np.float32(now)),
                         dtype=torch.float32, device=dev),
            agent=col(agents0, np.int32),
            x=col(cols["x"], np.float32),
            y=col(cols["y"], np.float32),
            yaw=col(cols["yaw"], np.float32),
            encoder=col(cols["encoder"], np.int32),
            v2v=col(cols["v2v"], np.int32),
            dist=col(cols["dist4"], np.float32),
            landmark=col(cols["landmark"], np.int32),
            valid=torch.ones((n_real,), dtype=torch.bool, device=dev))
        self.state, outs = self._apply(batch)
        self.pkt_total += n_real

        if self._trails is None and not self.writer:
            return
        rx, ry, yaw, hits, hv = (outs.rx.cpu().numpy(), outs.ry.cpu().numpy(),
                                 outs.yaw.cpu().numpy(),
                                 outs.hits.cpu().numpy(),
                                 outs.hit_valid.cpu().numpy())
        if self._trails is not None:
            self._trails.observe(agents0[:n_real], rx, ry, hits, hv)
        if self.writer:
            for i in range(n_real):
                self.writer.telemetry(
                    now, int(agents0[i]) + 1, rx[i], ry[i], yaw[i],
                    int(cols["encoder"][i]), int(cols["v2v"][i]),
                    list(cols["dist4"][i]), int(cols["landmark"][i]))
                self.writer.points(now, int(agents0[i]) + 1, hits[i], hv[i])

    def drain_ingest(self) -> int:
        """One frame: drain the socket and ingest. Returns the number of
        telemetry packets applied."""
        agents0, cols = self.drain_columns()
        if len(agents0):
            self.ingest_columns(agents0, cols)
        return int(len(agents0))

    def drain_columns(self):
        """Drain the socket into ONE frame's column arrays without applying
        them (host-side bookkeeping, bot-address learning and the
        measured-closure sweep table, still happens here), so that
        `run(pipeline=...)` can overlap the next frame's drain with the
        device work of the one before. With the native codec the datagrams
        go straight to column arrays (recvmmsg drain, no per-packet Python
        objects)."""
        if not self.native_codec:
            return self._columns_from_pkts(self.drain_socket())
        from swarm_tpu_torch.native import (drain_udp_socket,
                                            parse_telemetry_buffer)

        buf, lens, ip4, _ports, n = drain_udp_socket(
            self.sock.fileno(), max_msgs=self._batch_size)
        empty = (np.zeros((0,), np.int32), {})
        if n == 0:
            return empty
        cols = parse_telemetry_buffer(buf, lens, n)
        agent0 = cols["agent"] - 1
        if self.latest_scans is not None:
            # scan payloads (kinds 3/4) feed the measured-closure table
            sk = ((cols["kind"] == 3) | (cols["kind"] == 4)) & \
                (agent0 >= 0) & (agent0 < self.n)
            for i in np.nonzero(sk)[0]:
                r = cols["scans"][i]
                k = min(len(r), self.latest_scans.shape[1])
                self.latest_scans[int(agent0[i]), :k] = r[:k]
        # 4-way telemetry only (kinds 1/2), as drain_socket's isinstance
        # filter; scan payloads otherwise belong to the ScanBridge
        keep = ((cols["kind"] == 1) | (cols["kind"] == 2)) & \
            (agent0 >= 0) & (agent0 < self.n)
        idx = np.nonzero(keep)[0]
        for i in idx:
            a = int(agent0[i])
            if a not in self.bot_addrs:
                ip = socket.inet_ntoa(int(ip4[i]).to_bytes(4, "big"))
                self.bot_addrs[a] = (ip, self.bot_tx_port_base + a)
        if not len(idx):
            return empty
        return agent0[idx], {k: v[idx] for k, v in cols.items()
                             if k not in ("kind", "agent", "n_good",
                                          "scans")}

    # -- TX ------------------------------------------------------------------

    def send_zones(self) -> int:
        """Latest zone snapshot -> ZONE packets (lift sentinel for
        inactive), ref :921-945."""
        st = self.state
        boxes = st.zone_boxes.cpu().numpy()
        active = st.zone_active.cpu().numpy()
        sent = 0
        for a, addr in list(self.bot_addrs.items()):
            z = (ZonePacket(*boxes[a]) if active[a]
                 else ZonePacket(*ZonePacket.LIFT))
            try:
                self.sock.sendto(z.pack(), addr)
                sent += 1
            except OSError as e:        # ref logs and continues (:687)
                print(f"[ZONE] send to bot {a + 1} failed: {e}")
        return sent

    def send_targets(self) -> int:
        """TARG packets for agents with assignments (the reference's
        commented-out path, :959-996, behind enable_targets)."""
        if not self.enable_targets:
            return 0
        st = self.state
        tg = st.targets.cpu().numpy()
        has = st.has_target.cpu().numpy()
        sent = 0
        for a, addr in list(self.bot_addrs.items()):
            if has[a]:
                try:
                    self.sock.sendto(TargetPacket(*tg[a]).pack(), addr)
                    sent += 1
                except OSError as e:
                    print(f"[TARGET] send to bot {a + 1} failed: {e}")
        return sent

    # -- loop ----------------------------------------------------------------

    def heartbeat_transitions(self):
        """Print OFFLINE/ONLINE transitions (ref :804-812)."""
        from swarm_tpu_torch.coord.heartbeat import heartbeat_update

        online = heartbeat_update(self.state.last_packet_t, self.now(),
                                  self.cfg.coord.heartbeat_timeout_s) \
            .cpu().numpy()
        for a in range(self.n):
            if self.online_prev[a] and not online[a]:
                print(f"[HEARTBEAT] Bot {a + 1} OFFLINE "
                      f"(no packets for "
                      f"{self.cfg.coord.heartbeat_timeout_s:.0f}s)")
            elif not self.online_prev[a] and online[a]:
                print(f"[HEARTBEAT] Bot {a + 1} ONLINE")
        self.online_prev = online
        return online

    def run(self, duration_s: Optional[float] = None, fps: float = 30.0,
            render_png: Optional[str] = None, render_every_s: float = 5.0,
            pipeline: int = 0):
        """The main loop. Ctrl-C or `duration_s` ends it; closes the logs.

        pipeline > 0: frames are applied on a worker thread fed by a
        bounded queue of that depth, so the socket drain of frame k+1
        overlaps the device work of frame k. When the device falls behind,
        `put` blocks and the 4 MB kernel receive buffer absorbs the burst.
        TX (zones, targets, heartbeat) stays on this thread and reads
        `self.state`, which the worker only rebinds to a new state."""
        frame_dt = 1.0 / fps if fps > 0 else 0.0   # fps <= 0 = uncapped
        last_render = 0.0
        apply_q = apply_thread = None
        errors = []
        if pipeline > 0:
            import queue
            import threading
            apply_q = queue.Queue(maxsize=pipeline)

            def apply_loop():
                while True:
                    item = apply_q.get()
                    if item is None:
                        return
                    try:
                        self.ingest_columns(*item)
                    except BaseException as e:    # re-raised by run()
                        errors.append(e)
                        return

            apply_thread = threading.Thread(target=apply_loop, daemon=True)
            apply_thread.start()
        # ZONE every 2 s (dual_bot_mapper.py:921-945), TARG every 3 s (the
        # commented-out block :959-996)
        last_zone_send = -1e30
        last_target_send = -1e30
        run_t0 = time.time()
        pkt_at_start = self.pkt_total
        try:
            while duration_s is None or time.time() - run_t0 < duration_s:
                if errors:
                    break
                start = time.time()
                if apply_q is not None:
                    agents0, cols = self.drain_columns()
                    if len(agents0):
                        apply_q.put((agents0, cols))
                else:
                    self.drain_ingest()
                self.heartbeat_transitions()
                now = self.now()
                if now - last_zone_send >= self.cfg.coord.zone_interval_s:
                    self.send_zones()
                    last_zone_send = now
                if (self.enable_targets and now - last_target_send
                        >= self.cfg.coord.target_interval_s):
                    self.send_targets()
                    last_target_send = now
                if render_png and self.now() - last_render > render_every_s:
                    self.render(render_png)
                    last_render = self.now()
                lag = frame_dt - (time.time() - start)
                if lag > 0:
                    time.sleep(lag)
        except KeyboardInterrupt:
            pass
        finally:
            if apply_q is not None:
                apply_q.put(None)          # apply queued frames, then stop
                apply_thread.join()
            el = max(time.time() - run_t0, 1e-9)
            got = self.pkt_total - pkt_at_start
            print(f"[SERVER] {got} packets in {el:.1f}s "
                  f"({got / el:.0f} pkt/s)")
            self.close()
        if errors:
            raise errors[0]

    # -- interactive view ----------------------------------------------------

    def view_snapshot(self):
        """Numpy state snapshot for server.view.MapView (the reference's
        live dashboard state, dual_bot_mapper.py:380-668)."""
        from swarm_tpu_torch.coord.heartbeat import heartbeat_update

        st = self.state
        online = heartbeat_update(st.last_packet_t, self.now(),
                                  self.cfg.coord.heartbeat_timeout_s)
        poses = torch.cat([st.agent_xy, st.agent_yaw[:, None]], dim=1)
        snap = {
            "grid": st.grid.cpu().numpy(),
            "resolution": self.cfg.grid.resolution,
            "origin": (self.cfg.grid.origin_x, self.cfg.grid.origin_y),
            "poses": poses.cpu().numpy(),
            "online": online.cpu().numpy(),
            "pkt_counts": st.pkt_counts.cpu().numpy(),
            "zones": st.zone_boxes.cpu().numpy(),
            "zone_active": st.zone_active.cpu().numpy(),
            "frontiers": st.frontier_centroids.cpu().numpy(),
            "n_frontiers": int(st.n_frontiers),
            "closures": int(st.closure.cl_count),
            "pkt_total": self.pkt_total,
            "t": self.now(),
        }
        if self._trails is not None:
            snap.update(self._trails.snapshot_layers())
        return snap

    def start_view(self, port: int = 8800, bind: str = "127.0.0.1"):
        """Launch the HTTP operator view on a daemon thread; the ingest
        loop is untouched."""
        from swarm_tpu_torch.server.view import MapView

        self._trails = ViewTrails()
        self._view = MapView(self.view_snapshot, port=port,
                             bind=bind).start()
        return self._view

    def render(self, path: str) -> str:
        from swarm_tpu_torch.render import render_map, save_png

        st = self.state
        img = render_map(st.grid, self.cfg.grid, scale=4,
                         zones=st.zone_boxes, zones_active=st.zone_active,
                         frontiers=st.frontier_centroids,
                         n_frontiers=st.n_frontiers)
        return save_png(img, path)

    def close(self):
        if self.writer:
            cl = self.state.closure
            n_cl = int(cl.cl_count)
            self.writer.close(closures=tuple(
                f[:n_cl].cpu().numpy()
                for f in (cl.cl_lm_node, cl.cl_node, cl.cl_dx, cl.cl_dy)))
            self.writer = None
        self.sock.close()


def main(argv=None):
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser(
        description="Live UDP swarm mapping server "
                    "(dual_bot_mapper.py equivalent)")
    ap.add_argument("--port", type=int, default=8888)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--separation", type=float, default=5.0)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--enable-targets", action="store_true")
    ap.add_argument("--render-png", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the server state (default: the "
                         "card, cuda)")
    ap.add_argument("--max-packets", type=int, default=None,
                    help="datagrams drained per frame (reference budget: 20, "
                         "dual_bot_mapper.py:816)")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="frame-rate cap (reference renders at 30 FPS, "
                         ":474); ingest ceiling = fps x max-packets")
    ap.add_argument("--ingest-mode", default="parity",
                    choices=["parity", "throughput"],
                    help="parity = per-packet ordered application "
                         "(reference drop-in); throughput = one application "
                         "per frame (order-exact grid, frame-coarse "
                         "closure timing) for swarm packet rates")
    ap.add_argument("--no-native-codec", action="store_true",
                    help="parse datagrams with the per-packet Python "
                         "struct codec instead of the native C++ batch "
                         "codec (native/src/codec.cpp)")
    ap.add_argument("--view", type=int, nargs="?", const=8800, default=None,
                    metavar="PORT",
                    help="serve the interactive operator view (zoom/pan/"
                         "HUD) at this HTTP port")
    ap.add_argument("--view-bind", default="127.0.0.1",
                    help="view bind address (loopback by default; set "
                         "0.0.0.0 to expose deliberately)")
    ap.add_argument("--pipeline", type=int, default=0, metavar="DEPTH",
                    help="apply frames on a worker thread behind a "
                         "bounded queue of this depth, overlapping the "
                         "next frame's socket drain with the device work; "
                         "0 = sequential")
    ap.add_argument("--closure-scanmatch", action="store_true",
                    help="scan-match fired closures against the stored "
                         "landmark sweeps (throughput mode; 751/743 B "
                         "scan payloads feed the sweep table)")
    args = ap.parse_args(argv)

    cfg = SwarmConfig(n_agents=args.agents)
    if args.max_packets:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, max_packets_per_frame=args.max_packets))
    if args.closure_scanmatch:
        cfg = cfg.replace(
            engine=dataclasses.replace(cfg.engine, scan_rays=181),
            slam=dataclasses.replace(cfg.slam, closure_scanmatch=True))
    srv = LiveServer(cfg, port=args.port, separation=args.separation,
                     log_dir=args.log_dir, enable_targets=args.enable_targets,
                     native_codec=not args.no_native_codec,
                     ingest_mode=args.ingest_mode, device=args.device)
    print(f"[SERVER] listening on 0.0.0.0:{srv.port} "
          f"({args.agents} agents, separation {args.separation}, "
          f"{srv.device})")
    if args.view is not None:
        srv.start_view(args.view, bind=args.view_bind)
    srv.run(duration_s=args.duration, fps=args.fps,
            render_png=args.render_png, pipeline=args.pipeline)


if __name__ == "__main__":
    main()
