"""Codec throughput (tools/bench_codec.py on the port): the Python struct
parse against the native batch codec (native/src/codec.cpp) on a mixed
frame of v1 / v2 / scan payloads — the live server's datagram hot path.
Host only.

Usage: python -m swarm_tpu_torch.bench_codec [--frames 200] [--batch 512]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from swarm_tpu_torch.native import parse_telemetry_columns
from swarm_tpu_torch.proto.packets import (QuasarPacketV1, QuasarPacketV2,
                                           ScanPacket, parse_packet)


def mixed_frame(batch: int):
    """`batch` datagrams: 6 in 10 v2, 3 v1, 1 scan (the tool's mix)."""
    rng = np.random.default_rng(0)
    frame = []
    for i in range(batch):
        k = i % 10
        if k < 6:
            frame.append(QuasarPacketV2(
                i % 8 + 1, *rng.normal(size=3), i, 42,
                *rng.uniform(0.1, 3.0, 4), i % 5).pack())
        elif k < 9:
            frame.append(QuasarPacketV1(
                i % 8 + 1, *rng.normal(size=3), i, 7,
                *rng.uniform(0.1, 3.0, 4)).pack())
        else:
            frame.append(ScanPacket(
                i % 8 + 1, *rng.normal(size=3), i, 3,
                rng.uniform(0.1, 2.0, 181).astype(np.float32)).pack())
    return frame


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--batch", type=int, default=512)
    args = ap.parse_args(argv)

    frame = mixed_frame(args.batch)
    parse_telemetry_columns(frame)     # build + warm
    n = args.frames * args.batch

    t0 = time.perf_counter()
    for _ in range(args.frames):
        for d in frame:
            parse_packet(d)
    t_py = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.frames):
        parse_telemetry_columns(frame)
    t_nat = time.perf_counter() - t0

    print(f"python struct codec: {n / t_py:,.0f} pkt/s")
    print(f"native batch codec:  {n / t_nat:,.0f} pkt/s "
          f"({t_py / t_nat:.1f}x)")
    return n / t_py, n / t_nat


if __name__ == "__main__":
    main()
