"""The live UDP mapping server (swarm_tpu_torch/server/live.py) and the
native recvmmsg / sendmmsg loops against the JAX package's server, on the
CPU.

The dual session (`sim/scenario.generate_dual_session(42)`, 698 packets
with landmarks, so closures fire) is packed into QuasarPacket v2
datagrams and sent over loopback to a JAX `LiveServer` and a port
`LiveServer`, 20 to a frame (the reference's budget), each server
draining its own socket with the native codec and stamping the frame with
the same clock value (the frame's last packet time). In both ingest modes
the grids and the closure logs' integers are equal, and so are the session
CSVs; the ZONE / TARG datagrams each server sends go to the same bots with
the same tags, their floats (and the closure, zone and target floats of
the state) within 1e-5: XLA's CPU cos/sin and its fused multiply-adds
differ from torch's by an ulp (ROADMAP C26, C36).
Garbage and out-of-range agents are dropped; a server whose native codec
cannot load raises; the pipelined run loop (a worker thread) leaves the
state the sequential application of the same frames leaves, and never
writes a state it has replaced.
"""

import ctypes
import dataclasses
import filecmp
import functools
import os
import shutil
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from swarm_tpu.config import SwarmConfig as JConfig
from swarm_tpu.server.live import LiveServer as JServer
from swarm_tpu_torch import native as pnat
from swarm_tpu_torch.bench_serve import _packet_ring
from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.proto.packets import (QuasarPacketV2, TargetPacket,
                                           ZonePacket, pack_quasar_v2_batch,
                                           parse_packet)
from swarm_tpu_torch.server.live import LiveServer
from swarm_tpu_torch.sim.scenario import generate_dual_session

pytestmark = pytest.mark.skipif(not shutil.which("g++"),
                                reason="no g++ toolchain")
FRAME = 20
LOCAL = "127.0.0.1"
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _session():
    """(datagrams [P], stamps [P]) of the dual session."""
    r = generate_dual_session(42, device="cpu")
    buf = pack_quasar_v2_batch(r.agent, r.x, r.y, r.yaw_q, r.encoder,
                               r.v2v, r.dist4, r.landmark)
    n = len(r.t)
    size = len(buf) // n
    return [buf[i * size:(i + 1) * size] for i in range(n)], \
        np.asarray(r.t, np.float64)


def _drain_frame(srv, k, limit_s=5.0):
    """`srv.drain_columns()` until `k` packets have come in, as one frame."""
    agents, cols = [], []
    got, deadline = 0, time.time() + limit_s
    while got < k:
        a, c = srv.drain_columns()
        if len(a):
            agents.append(np.asarray(a))
            cols.append(c)
            got += len(a)
        elif time.time() > deadline:
            raise AssertionError(f"{got} of {k} datagrams arrived")
    return (np.concatenate(agents),
            {f: np.concatenate([c[f] for c in cols]) for f in cols[0]})


class _Clock:
    """A settable stand-in for `srv.now`."""
    value = 0.0

    def __call__(self):
        return self.value


def _bots(servers):
    """Two bot sockets; every server sends agent a's ZONE/TARG to bot a."""
    bots = []
    for _ in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind((LOCAL, 0))
        s.settimeout(2.0)
        bots.append(s)
    for srv in servers:
        srv.bot_addrs = {a: (LOCAL, b.getsockname()[1])
                         for a, b in enumerate(bots)}
    return bots


def _pending(bot, wait_s=0.05):
    """Every datagram that reaches `bot` within `wait_s` of the last."""
    out = []
    bot.settimeout(wait_s)
    try:
        while True:
            out.append(bot.recv(64))
    except socket.timeout:
        return out


def _serve_session(mode, tmp_path, enable_targets=True):
    """Both servers through the whole session; returns (JAX server, port
    server, ZONE/TARG bytes each sent)."""
    dgrams, stamps = _session()
    jcfg, pcfg = JConfig(n_agents=2), SwarmConfig(n_agents=2)
    js = JServer(jcfg, port=0, log_dir=str(tmp_path / "jax"),
                 enable_targets=enable_targets, ingest_mode=mode)
    ps = LiveServer(pcfg, port=0, log_dir=str(tmp_path / "port"),
                    enable_targets=enable_targets, ingest_mode=mode,
                    device="cpu")
    clock = _Clock()
    js.now = ps.now = clock
    bots = _bots([js, ps])
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = {"jax": [], "port": []}
    try:
        for i in range(0, len(dgrams), FRAME):
            for srv in (js, ps):
                for d in dgrams[i:i + FRAME]:
                    tx.sendto(d, (LOCAL, srv.sock.getsockname()[1]))
            k = len(dgrams[i:i + FRAME])
            clock.value = float(stamps[i + k - 1])
            for name, srv in (("jax", js), ("port", ps)):
                agents, cols = _drain_frame(srv, k)
                srv.ingest_columns(agents, cols)
                # the reference's TX cadences, driven every fifth frame
                if (i // FRAME) % 5 == 4:
                    srv.send_zones()
                    srv.send_targets()
                    sent[name].append([_pending(b) for b in bots])
    finally:
        tx.close()
        for b in bots:
            b.close()
    return js, ps, sent


def _assert_states_equal(js, ps):
    jst, pst = js.state, ps.state
    np.testing.assert_array_equal(pst.grid.numpy(), np.asarray(jst.grid))
    for f in pst.closure._fields:
        a, b = getattr(pst.closure, f).numpy(), \
            np.asarray(getattr(jst.closure, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                       err_msg=f"closure {f}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"closure {f}")
    for f in ("zone_active", "pkt_counts", "has_target", "n_frontiers",
              "total_writes"):
        np.testing.assert_array_equal(getattr(pst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)
    for f in ("agent_xy", "agent_yaw", "zone_boxes", "targets",
              "frontier_centroids", "last_packet_t"):
        np.testing.assert_allclose(getattr(pst, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   rtol=0, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("mode", ["parity", "throughput"])
def test_session_over_udp_matches_jax(mode, tmp_path):
    js, ps, sent = _serve_session(mode, tmp_path)
    try:
        assert ps.pkt_total == js.pkt_total == len(_session()[0])
        assert set(ps.bot_addrs) == {0, 1}
        _assert_states_equal(js, ps)
        # frame-coarse closures (each agent's last packet of a frame)
        # fire none on this session; the per-packet ones do
        assert (int(ps.state.closure.cl_count) > 0) == (mode == "parity")
        assert bool(ps.state.zone_active.any())
        # ZONE / TARG datagrams: the same packets to the same bots, tags
        # and lengths equal, the float fields within ATOL (an ulp of the
        # hit projections' cos/sin and XLA's fused multiply-adds, ROADMAP
        # C26 and C36)
        assert [[len(b) for b in f] for f in sent["port"]] == \
            [[len(b) for b in f] for f in sent["jax"]]
        for fp, fj in zip(sent["port"], sent["jax"]):
            for bp, bj in zip(fp, fj):
                for dp, dj in zip(bp, bj):
                    assert dp[:4] == dj[:4] and len(dp) == len(dj)
                    np.testing.assert_allclose(
                        np.frombuffer(dp[4:], "<f4"),
                        np.frombuffer(dj[4:], "<f4"), rtol=0, atol=ATOL)
        kinds = [type(parse_packet(d)).__name__
                 for frame in sent["port"] for bot in frame for d in bot]
        assert "ZonePacket" in kinds and "TargetPacket" in kinds
    finally:
        js.close()
        ps.close()
    # session CSVs (written on close) byte for byte
    for fn in sorted(os.listdir(tmp_path / "jax")):
        assert filecmp.cmp(tmp_path / "jax" / fn, tmp_path / "port" / fn,
                           shallow=False), fn
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "port"))


def test_zone_and_target_packets():
    """send_zones: LIFT for an inactive zone, the box for an active one;
    send_targets: only agents with a target, nothing without targets."""
    srv = LiveServer(SwarmConfig(n_agents=2), port=0, device="cpu",
                     enable_targets=True)
    bots = _bots([srv])
    try:
        st = srv.state
        srv.state = st._replace(
            zone_boxes=torch.tensor([[1.0, 2.0, 3.0, 4.0],
                                     [5.0, 6.0, 7.0, 8.0]]),
            zone_active=torch.tensor([True, False]),
            targets=torch.tensor([[0.5, 1.5], [2.5, 3.5]]),
            has_target=torch.tensor([False, True]))
        assert srv.send_zones() == 2
        assert parse_packet(bots[0].recv(64)) == ZonePacket(1, 2, 3, 4)
        assert parse_packet(bots[1].recv(64)) == \
            ZonePacket(*ZonePacket.LIFT)
        assert srv.send_targets() == 1
        assert parse_packet(bots[1].recv(64)) == TargetPacket(2.5, 3.5)
        srv.enable_targets = False
        assert srv.send_targets() == 0
    finally:
        for b in bots:
            b.close()
        srv.close()


@pytest.mark.parametrize("native_codec", [True, False])
def test_garbage_is_rejected(native_codec):
    """Garbage, a zeroed datagram and agent 9 of 2 are dropped by both
    codecs (and by the JAX server)."""
    srv = LiveServer(SwarmConfig(n_agents=2), port=0, device="cpu",
                     native_codec=native_codec)
    jsrv = JServer(JConfig(n_agents=2), port=0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        good = QuasarPacketV2(2, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0).pack()
        for s in (srv, jsrv):
            for d in (b"not a packet", b"\x00" * 42,
                      QuasarPacketV2(9, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                     0).pack(), good):
                tx.sendto(d, (LOCAL, s.sock.getsockname()[1]))
        time.sleep(0.05)
        agents, cols = srv.drain_columns()
        ja, _ = jsrv.drain_columns()
        assert list(agents) == list(ja) == [1]
        assert float(cols["x"][0]) == 1.0
        assert srv.bot_addrs == {1: (LOCAL, 8888 + 1)}
    finally:
        tx.close()
        srv.close()
        jsrv.close()


def test_native_codec_failure_raises(monkeypatch):
    """No quiet fallback: native_codec=True raises when the library cannot
    be built or loaded."""
    def broken(_):
        raise OSError("cannot build the native library")
    monkeypatch.setattr(pnat, "parse_telemetry_columns", broken)
    with pytest.raises(OSError, match="native"):
        LiveServer(SwarmConfig(n_agents=2), port=0, device="cpu")
    srv = LiveServer(SwarmConfig(n_agents=2), port=0, device="cpu",
                     native_codec=False)
    srv.close()


def test_native_drain_and_blast():
    """blast_udp_ring hands the ring to the kernel in order;
    drain_udp_socket reads the datagrams back with their source."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind((LOCAL, 0))
    rx.setblocking(False)
    ring = _packet_ring(4)[:8]
    stop = ctypes.c_int32(0)
    box = []
    th = threading.Thread(target=lambda: box.append(pnat.blast_udp_ring(
        rx.getsockname()[1], ring, stop, burst=8, sleep_us=20000)))
    th.start()
    try:
        time.sleep(0.01)
        buf, lens, ip4, ports, n = pnat.drain_udp_socket(rx.fileno(),
                                                         max_msgs=64)
    finally:
        stop.value = 1
        th.join()
        rx.close()
    assert n >= 8 and box[0] >= n
    assert (lens == 42).all()
    assert socket.inet_ntoa(int(ip4[0]).to_bytes(4, "big")) == LOCAL
    for i in range(8):
        assert bytes(buf[i, :42]) == ring[i]
    with pytest.raises(ValueError):
        pnat.blast_udp_ring(1, [b"ab", b"abc"], stop)


class _Recording(LiveServer):
    """Records every applied frame with its stamp; checks that the state
    it replaces is never written."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.frames = []
        self.untouched = True

    def ingest_columns(self, agents0, cols, now=None):
        now = self.now() if now is None else now
        self.frames.append((now, np.array(agents0), dict(cols)))
        old = self.state
        before = [f.clone() for f in _leaves(old)]
        super().ingest_columns(agents0, cols, now)
        self.untouched &= all(torch.equal(a, b)
                              for a, b in zip(before, _leaves(old)))


def _leaves(st):
    out = []
    for f in st:
        out += _leaves(f) if hasattr(f, "_fields") else [f]
    return out


@pytest.mark.parametrize("mode", ["throughput", "parity"])
def test_pipelined_run_equals_sequential(mode):
    """run(pipeline=2) under the native blaster: the worker thread's state
    equals the recorded frames applied one after another, and no replaced
    state was written while the main thread could read it."""
    cfg = SwarmConfig(n_agents=8)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, max_packets_per_frame=256 if mode == "throughput"
        else 20))
    srv = _Recording(cfg, port=0, device="cpu", ingest_mode=mode)
    stop = ctypes.c_int32(0)
    th = threading.Thread(target=pnat.blast_udp_ring, args=(
        srv.port, _packet_ring(8), stop), kwargs=dict(burst=32,
                                                      sleep_us=5000))
    th.start()
    try:
        srv.run(duration_s=1.0, fps=0.0, pipeline=2)
    finally:
        stop.value = 1
        th.join()
    assert srv.untouched
    assert len(srv.frames) > 1 and srv.pkt_total > 100
    seq = LiveServer(cfg, port=0, device="cpu", ingest_mode=mode)
    for now, agents, cols in srv.frames:
        seq.ingest_columns(agents, cols, now)
    seq.close()
    assert seq.pkt_total == srv.pkt_total
    for a, b in zip(_leaves(seq.state), _leaves(srv.state)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _scans():
    """Two sweeps of a box room from nearby poses (the JAX test's
    scene), by the JAX sweep model."""
    import jax.numpy as jnp

    from swarm_tpu.models.scan import sense_scan_true
    jax.config.update("jax_platforms", "cpu")
    walls = jnp.asarray([[0.0, 0.0, 3.0, 0.0], [3.0, 0.0, 3.0, 3.0],
                         [3.0, 3.0, 0.0, 3.0], [0.0, 3.0, 0.0, 0.0],
                         [1.8, 0.0, 1.8, 1.0]], jnp.float32)
    pa, pb = (1.3, 0.7, -0.2), (1.5, 0.6, -0.5)
    return pa, pb, (np.asarray(sense_scan_true(jnp.asarray(pa), walls)),
                    np.asarray(sense_scan_true(jnp.asarray(pb), walls)))


def test_measured_closures_while_serving():
    """--closure-scanmatch: the sweep table rides into ingest_frame; the
    fitness-gated SE(2) edge equals the JAX server's."""
    pa, pb, (scan_a, scan_b) = _scans()

    def cfg_of(cls):
        c = cls(n_agents=1)
        return c.replace(
            engine=dataclasses.replace(c.engine, scan_rays=181),
            slam=dataclasses.replace(c.slam, closure_scanmatch=True,
                                     min_poses_between=2,
                                     closure_same_agent_only=True))
    servers = [JServer(cfg_of(JConfig), port=0, separation=0.0,
                       ingest_mode="throughput", native_codec=False),
               LiveServer(cfg_of(SwarmConfig), port=0, separation=0.0,
                          ingest_mode="throughput", native_codec=False,
                          device="cpu")]
    try:
        for srv in servers:
            srv.now = _Clock()
            steps = [(scan_a, pa, 5), (None, pa, 0), (None, pa, 0),
                     (scan_b, (pb[0] + 0.1, pb[1] - 0.06, pb[2] + 0.05), 5)]
            for k, (scan, pose, lm) in enumerate(steps):
                if scan is not None:
                    srv.latest_scans[0] = scan
                srv.now.value = 0.1 * k
                srv.ingest([(0, QuasarPacketV2(1, *pose, 0, 0, 1.0, 0.5,
                                               4.0, 0.5, lm))])
        js, ps = servers
        assert int(ps.state.closure.cl_count) == 1
        _assert_states_equal(js, ps)
    finally:
        for srv in servers:
            srv.close()
