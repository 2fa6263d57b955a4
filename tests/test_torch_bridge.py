"""The scan bridge, its ROS 2 message fields and the protocol CLI tools
(swarm_tpu_torch/server/bridge.py, server/ros2.py, cli/tools.py) against
the JAX package's, on the CPU.

Scan packets (the 751 B standalone layout and the 743 B firmware layout,
ranges made from a seed) go over loopback to a JAX and a port ScanBridge:
both call back with the same odometry and ranges, write the same scan CSV
(the wall-clock timestamp column aside), relay cmd_vel as the same CMD1
bytes and build the same live beam-model grid (the fused engine's XLA
tier, within 1e-6). The scan-log readers, the ROS 2 message fields and
the CLI tools' datagrams equal JAX's; `replay-udp` feeds a port live
server.
"""

import csv
import math
import socket
import threading
import time

import numpy as np
import pytest

from swarm_tpu.config import GridConfig as JGrid
from swarm_tpu.server import bridge as jbridge
from swarm_tpu.server import ros2 as jros2
from swarm_tpu_torch.config import GridConfig
from swarm_tpu_torch.proto.packets import (CommandPacket, ScanPacket,
                                           ScanPacketBridge, parse_packet)
from swarm_tpu_torch.server import bridge as pbridge
from swarm_tpu_torch.server import ros2 as pros2

LOCAL = "127.0.0.1"


def _scans(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ranges = np.full(181, 4.0, np.float32)
        lo = rng.integers(40, 120)
        ranges[lo:lo + 30] = rng.uniform(0.3, 1.8, 30).astype(np.float32)
        ranges[rng.integers(0, 181, 5)] = 0.01          # untrusted
        pose = rng.uniform(-1, 1, 3).astype(np.float32)
        if k % 2:
            out.append(ScanPacketBridge(1 + k % 3, *pose, ranges))
        else:
            out.append(ScanPacket(1 + k % 3, *pose, k, 7, ranges))
    return out


def _bridges(tmp_path, **kw):
    rec = {"jax": ([], []), "port": ([], [])}

    def cbs(name):
        odo, sc = rec[name]
        return dict(on_odom=lambda *a: odo.append(a),
                    on_scan=lambda a, r: sc.append((a, np.array(r))))
    return rec, (
        jbridge.ScanBridge(port=0, log_dir=str(tmp_path / "jax"),
                           map_cfg=JGrid(size=384), **cbs("jax"), **kw),
        pbridge.ScanBridge(port=0, log_dir=str(tmp_path / "port"),
                           map_cfg=GridConfig(size=384), device="cpu",
                           **cbs("port"), **kw))


def _rows(path):
    with open(path) as f:
        return [r[1:] for r in csv.reader(f)][1:]     # timestamp aside


def test_bridge_roundtrip_equals_jax(tmp_path):
    pkts = _scans(0)
    rec, (bj, bp) = _bridges(tmp_path)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    bot = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    bot.bind((LOCAL, 0))
    bot.settimeout(2.0)
    try:
        for br in (bj, bp):
            for p in pkts:
                tx.sendto(p.pack(), (LOCAL, br.sock.getsockname()[1]))
            tx.sendto(b"garbage", (LOCAL, br.sock.getsockname()[1]))
            tx.sendto(CommandPacket(1.0, 1.0).pack(),
                      (LOCAL, br.sock.getsockname()[1]))
        time.sleep(0.05)
        assert bj.poll() == bp.poll() == len(pkts)
        assert bp.pkt_total == len(pkts) and set(bp.clients) == {1, 2, 3}
        (oj, sj), (op, sp) = rec["jax"], rec["port"]
        assert op == oj
        assert [a for a, _ in sp] == [a for a, _ in sj]
        for (_, a), (_, b) in zip(sp, sj):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(bp.logodds.numpy(),
                                   np.asarray(bj.logodds), rtol=0,
                                   atol=1e-6)
        assert int((bp.logodds < 0).sum()) > 100
        assert int((bp.logodds > 0).sum()) > 3
        # the cmd_vel relay's bytes
        cmds = []
        for br in (bj, bp):
            br.clients[1] = bot.getsockname()
            assert br.send_cmd_vel(1, 0.25, -0.125)
            assert not br.send_cmd_vel(9, 0.0, 0.0)
            cmds.append(bot.recv(64))
        assert cmds[0] == cmds[1]
        assert parse_packet(cmds[1]) == CommandPacket(0.25, -0.125)
    finally:
        tx.close()
        bot.close()
        bj.close()
        bp.close()
    for a in (1, 2, 3):
        fj = tmp_path / "jax" / f"agent_{a}_log.csv"
        fp = tmp_path / "port" / f"agent_{a}_log.csv"
        assert fp.read_text().splitlines()[0] == \
            ",".join(pbridge.SCAN_CSV_HEADER)
        assert _rows(fp) == _rows(fj)
        # the readers on the port's log equal JAX's
        lp, lj = pbridge.load_scan_log(str(fp)), jbridge.load_scan_log(
            str(fj))
        for k in lj:
            if k != "t":
                np.testing.assert_array_equal(lp[k], lj[k], err_msg=k)
        np.testing.assert_array_equal(pbridge.scan_log_points(lp),
                                      jbridge.scan_log_points(lj))


def test_743_and_751_byte_layouts():
    """Both scan layouts parse to the same fields on both sides."""
    for p in _scans(1, n=2):
        d = p.pack()
        assert len(d) == (751 if isinstance(p, ScanPacket) else 743)
        from swarm_tpu.proto.packets import parse_packet as j_parse
        got, want = parse_packet(d), j_parse(d)
        assert type(got).__name__ == type(want).__name__
        for f in got._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))


def test_ros2_message_fields_equal_jax():
    rng = np.random.default_rng(2)
    for agent in (1, 7):
        x, y, yaw = (float(v) for v in rng.uniform(-3, 3, 3))
        assert pros2.odom_msg_fields(agent, x, y, yaw) == \
            jros2.odom_msg_fields(agent, x, y, yaw)
        r = rng.uniform(0.05, 2.0, 181).astype(np.float32)
        assert pros2.scan_msg_fields(agent, r) == \
            jros2.scan_msg_fields(agent, r)
    f = pros2.scan_msg_fields(1, np.zeros(181))
    assert math.isclose(f["angle_max"], math.pi / 2)
    assert pros2.have_rclpy() == jros2.have_rclpy()
    if not pros2.have_rclpy():
        br = pbridge.ScanBridge(port=0)
        try:
            with pytest.raises(RuntimeError, match="rclpy"):
                pros2.Ros2Bridge(br, agents=[1])
        finally:
            br.close()


def _capture(run):
    """Datagrams `run(port)` sends to a fresh local socket."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind((LOCAL, 0))
    rx.settimeout(2.0)
    try:
        run(rx.getsockname()[1])
        return rx.recv(2048)
    finally:
        rx.close()


@pytest.mark.parametrize("argv", [
    ["send-zone", "--box", "1.5", "-2", "3.25", "4"],
    ["send-zone", "--lift"],
    ["send-target", "--xy", "1.5", "0.5"],
    ["send-cmd", "--vel", "0.2", "-0.1"]])
def test_tools_send_the_bytes_jax_sends(argv):
    from swarm_tpu.cli.tools import main as j_tools
    from swarm_tpu_torch.cli.tools import main as p_tools

    def run(main):
        return lambda port: main(argv + ["--host", LOCAL, "--port",
                                         str(port)])
    assert _capture(run(p_tools)) == _capture(run(j_tools))


class _Prebound(socket.socket):
    """A socket bound before it is handed out; `bind` does nothing."""

    def bind(self, addr):
        pass


def test_debug_receive_and_replay_udp(tmp_path, monkeypatch):
    """replay-udp fires a logged session at a port live server, which maps
    it (loopback may drop datagrams under load: the JAX test's 80%);
    debug-receive counts what reaches it."""
    from swarm_tpu_torch.cli.tools import main as p_tools
    from swarm_tpu_torch.config import SwarmConfig
    from swarm_tpu_torch.proto.csvio import write_session
    from swarm_tpu_torch.server.live import LiveServer
    from swarm_tpu_torch.sim.scenario import generate_dual_session

    res = generate_dual_session(seed=42, device="cpu")
    out = write_session(str(tmp_path / "s"), res.t, res.agent, res.x,
                        res.y, res.yaw_q, res.encoder, res.v2v, res.dist4,
                        res.landmark)
    cfg = SwarmConfig(n_agents=2)
    srv = LiveServer(cfg, port=0, separation=0.0, device="cpu")
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            if not srv.drain_ingest():
                time.sleep(0.002)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        sent = p_tools(["replay-udp", "--session", out, "--host", LOCAL,
                        "--port", str(srv.port), "--speed", "0"])
        deadline = time.time() + 20
        while srv.pkt_total < sent and time.time() < deadline:
            time.sleep(0.05)
    finally:
        stop.set()
        th.join(timeout=5)
    assert sent == len(res.t) and srv.pkt_total > 0.8 * sent
    assert int((srv.state.grid == cfg.grid.free).sum()) > 1000
    srv.close()

    probe = _Prebound(socket.AF_INET, socket.SOCK_DGRAM)
    socket.socket.bind(probe, (LOCAL, 0))
    port = probe.getsockname()[1]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    from swarm_tpu_torch.cli import tools as ptools
    monkeypatch.setattr(ptools.socket, "socket", lambda *a, **k: probe)
    box = []
    th = threading.Thread(target=lambda: box.append(p_tools(
        ["debug-receive", "--port", str(port), "--timeout", "1.5"])))
    th.start()
    for d in (b"garbage", CommandPacket(1.0, 2.0).pack()):
        tx.sendto(d, (LOCAL, port))
    tx.close()
    th.join()
    assert box == [2]
