"""Live-serving throughput (tools/bench_serve.py on the port): packets per
second through the real server loop — UDP socket -> recvmmsg drain ->
native batch codec -> one frame application per frame on the server's
device (the card unless --device names another).

A blaster thread offers QuasarPacket v2 telemetry (42 B,
dual_bot_mapper.py:41-42) from synthetic agents walking noisy circles on
loopback, with the native sendmmsg loop (`native.blast_udp_ring`) paced by
--blast-burst / --blast-sleep-us; the server runs its normal `run()` loop
uncapped (fps=0). Reference design budget: <= 20 pkts/frame x 30 FPS = 600
pkt/s (dual_bot_mapper.py:816, :474). The JSON line is the tool's, with
the applied/offered ratio (packets applied over packets the blaster
handed to the kernel) in `detail`.

Usage: python -m swarm_tpu_torch.bench_serve [--duration 10] [--agents 64]
       [--ingest-mode throughput] [--device cuda]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import socket
import struct
import threading
import time

import numpy as np


def _packet_ring(n_agents: int):
    """4096 pre-packed v2 telemetry packets from synthetic agents walking
    noisy circles."""
    rng = np.random.default_rng(0)
    fmt = struct.Struct("<4sBfffiIffffB")
    ring = []
    for k in range(4096):
        a = int(k % n_agents)
        t = k * 0.05
        x = 2.0 + np.cos(t + a) * 1.5
        y = 1.5 + np.sin(t + a) * 1.0
        ring.append(fmt.pack(
            b"QSRL", a + 1, np.float32(x), np.float32(y),
            np.float32((t + a) % 6.28 - 3.14), k, 0,
            np.float32(rng.uniform(0.1, 1.1)),
            np.float32(rng.uniform(0.1, 1.1)),
            np.float32(rng.uniform(0.1, 1.1)),
            np.float32(rng.uniform(0.1, 1.1)), 0))
    return ring


def python_blaster(port: int, ring, stop: threading.Event, sent_box: list):
    """The Python sendto loop (--python-blaster): ~5-10 us of interpreter
    time per packet, taken from the server under test."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = ("127.0.0.1", port)
    sent = 0
    i = 0
    while not stop.is_set():
        try:
            s.sendto(ring[i & 4095], addr)
            sent += 1
        except OSError:
            time.sleep(0.001)
        i += 1
    sent_box.append(sent)
    s.close()


def native_blaster(port: int, ring, stop_flag, sent_box: list,
                   errors: list, burst: int, sleep_us: int):
    """sendmmsg blaster: ~1 us per packet, and the sleep between bursts
    leaves the core to the server. A socket failure is an error of the
    run, not a reason to measure something else."""
    from swarm_tpu_torch import native
    try:
        sent_box.append(native.blast_udp_ring(port, ring, stop_flag,
                                              burst=burst,
                                              sleep_us=sleep_us))
    except Exception as e:          # re-raised by serve()
        errors.append(e)


def serve(agents: int = 64, duration: float = 10.0,
          ingest_mode: str = "throughput", max_packets: int = 2048,
          native_codec: bool = True, python_sendto: bool = False,
          blast_burst: int = 64, blast_sleep_us: int = 500,
          pipeline: int = 0, device=None, server_cls=None):
    """One benchmark run. Returns (the JSON record, the closed server).
    `server_cls`: a LiveServer subclass to serve with (LiveServer when
    None)."""
    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.server.live import LiveServer

    cfg = SwarmConfig(n_agents=agents)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, max_packets_per_frame=max_packets))
    srv = (server_cls or LiveServer)(
        cfg, port=0, separation=2.0, ingest_mode=ingest_mode,
        native_codec=native_codec, device=device)
    port = srv.port
    print(f"[BENCH] serving on 127.0.0.1:{port} device={srv.device} "
          f"mode={ingest_mode} codec="
          f"{'native' if native_codec else 'python'}", flush=True)

    ring = _packet_ring(agents)
    sent_box: list = []
    errors: list = []
    stop = threading.Event()
    stop_flag = ctypes.c_int32(0)
    if python_sendto:
        tx = threading.Thread(target=python_blaster,
                              args=(port, ring, stop, sent_box), daemon=True)
    else:
        from swarm_tpu_torch import native
        native.get_lib()            # build before the timed window
        tx = threading.Thread(
            target=native_blaster,
            args=(port, ring, stop_flag, sent_box, errors, blast_burst,
                  blast_sleep_us), daemon=True)
    tx.start()
    t0 = time.time()
    try:
        srv.run(duration_s=duration, fps=0.0, pipeline=pipeline)
    finally:
        dt = time.time() - t0
        stop.set()
        stop_flag.value = 1
        tx.join(timeout=10.0)
    if errors:
        raise errors[0]
    got = srv.pkt_total
    sent = sent_box[0] if sent_box else None
    rec = {
        "metric": "serve_pkt_per_s",
        "value": round(got / dt, 1),
        "unit": "pkt/s",
        "vs_reference_budget": round(got / dt / 600.0, 1),
        "detail": {
            "device": str(srv.device),
            "ingest_mode": ingest_mode,
            "native_codec": native_codec,
            "agents": agents,
            "duration_s": round(dt, 2),
            "packets_applied": got,
            "packets_sent": sent,
            "applied_over_offered": (round(got / sent, 4) if sent else None),
            "blaster": ("python_sendto" if python_sendto
                        else "native_sendmmsg"),
            "max_packets_per_frame": max_packets,
            "pipeline": pipeline,
        },
    }
    return rec, srv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device of the server (default: the card)")
    ap.add_argument("--ingest-mode", default="throughput",
                    choices=["parity", "throughput"])
    ap.add_argument("--max-packets", type=int, default=2048)
    ap.add_argument("--no-native-codec", action="store_true")
    ap.add_argument("--python-blaster", action="store_true",
                    help="offer load with the Python sendto loop instead "
                         "of the native sendmmsg one")
    ap.add_argument("--blast-burst", type=int, default=64)
    ap.add_argument("--blast-sleep-us", type=int, default=500,
                    help="native blaster sleep between bursts; paces the "
                         "offered load and yields the core to the server")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="frame-application pipeline depth (see "
                         "server.live.LiveServer.run)")
    args = ap.parse_args(argv)
    rec, _ = serve(args.agents, args.duration, args.ingest_mode,
                   args.max_packets, not args.no_native_codec,
                   args.python_blaster, args.blast_burst,
                   args.blast_sleep_us, args.pipeline, args.device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
