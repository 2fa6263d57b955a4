"""Protocol probes + injectors (swarm_tpu/cli/tools.py) — the reference's
little ops tools in one CLI:
debug_receiver.py (30 s UDP reachability probe), send_test_zone.py (mock
ZONE injection), and the simulation_tools/README.md:10 flow of firing a
logged session at a live server over UDP.

  python -m swarm_tpu_torch.cli.tools debug-receive --port 8888
  python -m swarm_tpu_torch.cli.tools send-zone --host 10.0.0.5 --box 1 2 3 4
  python -m swarm_tpu_torch.cli.tools send-target --host 10.0.0.5 --xy 1.5 0.5
  python -m swarm_tpu_torch.cli.tools send-cmd --host 10.0.0.5 --vel 0.2 -0.1
  python -m swarm_tpu_torch.cli.tools replay-udp --session DIR --host 127.0.0.1
"""

from __future__ import annotations

import argparse
import socket
import time

from swarm_tpu_torch.proto.packets import (CommandPacket, QuasarPacketV2,
                                     TargetPacket, ZonePacket, parse_packet)


def debug_receive(args):
    """30 s raw probe (server_nodes/debug_receiver.py:11-41)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("0.0.0.0", args.port))
    sock.settimeout(args.timeout)
    print(f"[DEBUG] listening on 0.0.0.0:{args.port} "
          f"for {args.timeout:.0f}s ...")
    t0 = time.time()
    n = 0
    try:
        while time.time() - t0 < args.timeout:
            try:
                data, addr = sock.recvfrom(2048)
            except socket.timeout:
                break
            n += 1
            pkt = parse_packet(data)
            print(f"[DEBUG] {len(data)} B from {addr[0]}:{addr[1]} -> "
                  f"{type(pkt).__name__ if pkt else 'unrecognised'}")
    finally:
        sock.close()
    if n == 0:
        print("[DEBUG] no packets received. Check: same WiFi/subnet, "
              "server IP in firmware, firewall allows UDP "
              f"{args.port} inbound.")
    return n


def _sendto(payload: bytes, host: str, port: int):
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.sendto(payload, (host, port))
    finally:
        sock.close()


def send_zone(args):
    """Mock ZONE at a bot (simulation_tools/send_test_zone.py:9-16)."""
    z = (ZonePacket(*ZonePacket.LIFT) if args.lift
         else ZonePacket(*args.box))
    _sendto(z.pack(), args.host, args.port)
    print(f"[ZONE] sent {z} -> {args.host}:{args.port}")


def send_target(args):
    _sendto(TargetPacket(*args.xy).pack(), args.host, args.port)
    print(f"[TARGET] sent {tuple(args.xy)} -> {args.host}:{args.port}")


def send_cmd(args):
    _sendto(CommandPacket(*args.vel).pack(), args.host, args.port)
    print(f"[CMD] sent {tuple(args.vel)} -> {args.host}:{args.port}")


def replay_udp(args):
    """Fire a logged session's telemetry at a live server as real wire
    packets, at `speed` x real time (simulation_tools/README.md:10)."""
    import numpy as np

    from swarm_tpu_torch.proto.csvio import load_session

    sess = load_session(args.session)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t = sess["t"]
    n = len(t)
    t_prev = float(t[0])
    sent = 0
    try:
        for i in range(n):
            if args.speed > 0:
                dt = (float(t[i]) - t_prev) / args.speed
                if dt > 0:
                    time.sleep(min(dt, 1.0))
            t_prev = float(t[i])
            pkt = QuasarPacketV2(
                agent=int(sess["agent"][i]),
                x=float(sess["x"][i]), y=float(sess["y"][i]),
                yaw=float(np.radians(sess["yaw_deg"][i])),
                encoder=int(sess["encoder"][i]), v2v=int(sess["v2v"][i]),
                front=float(sess["dist_cm"][i, 0]) / 100.0,
                left=float(sess["dist_cm"][i, 1]) / 100.0,
                back=float(sess["dist_cm"][i, 2]) / 100.0,
                right=float(sess["dist_cm"][i, 3]) / 100.0,
                landmark=int(sess["landmark"][i]))
            sock.sendto(pkt.pack(), (args.host, args.port))
            sent += 1
    finally:
        sock.close()
    print(f"[REPLAY] sent {sent} packets to {args.host}:{args.port}")
    return sent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("debug-receive")
    d.add_argument("--port", type=int, default=8888)
    d.add_argument("--timeout", type=float, default=30.0)
    d.set_defaults(fn=debug_receive)

    z = sub.add_parser("send-zone")
    z.add_argument("--host", required=True)
    z.add_argument("--port", type=int, default=8888)
    z.add_argument("--box", type=float, nargs=4, default=[1.0, 2.0, 3.0, 4.0])
    z.add_argument("--lift", action="store_true")
    z.set_defaults(fn=send_zone)

    tg = sub.add_parser("send-target")
    tg.add_argument("--host", required=True)
    tg.add_argument("--port", type=int, default=8888)
    tg.add_argument("--xy", type=float, nargs=2, required=True)
    tg.set_defaults(fn=send_target)

    c = sub.add_parser("send-cmd")
    c.add_argument("--host", required=True)
    c.add_argument("--port", type=int, default=8888)
    c.add_argument("--vel", type=float, nargs=2, required=True)
    c.set_defaults(fn=send_cmd)

    r = sub.add_parser("replay-udp")
    r.add_argument("--session", required=True)
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, default=8888)
    r.add_argument("--speed", type=float, default=0.0,
                   help="x real time; 0 = as fast as possible")
    r.set_defaults(fn=replay_udp)

    pr = sub.add_parser(
        "polar-radar",
        help="live polar scan radar over UDP — the reference's "
             "room_mapper.py view (debugged: the original crashes on an "
             "undefined UDP_PORT, :34), rendered headless to a PNG")
    pr.add_argument("--port", type=int, default=8888)
    pr.add_argument("--out", default="radar.png")
    pr.add_argument("--duration", type=float, default=None)
    pr.set_defaults(fn=lambda a: __import__(
        "swarm_tpu_torch.render.polar", fromlist=["live_polar_radar"]
    ).live_polar_radar(port=a.port, out_path=a.out,
                       duration_s=a.duration))

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
