"""The port's wire protocol and session CSVs (swarm_tpu_torch/proto)
against the JAX package's (swarm_tpu/proto), on the CPU.

Packets are made from a seed with numpy. The batch codec is byte-equal
both ways: the port's `pack_quasar_v2_batch` gives the JAX package's bytes,
and each side's `unpack_quasar_batch` / `parse_packet` reads the other's
bytes to the same fields. The CSV round trip (`write_session`, then
`load_session`) gives equal files and equal columns, and
`packet_stream_from_telemetry` equals the JAX package's stream field for
field.
"""

import os

import numpy as np
import pytest
import torch

from swarm_tpu.proto import csvio as jcsv
from swarm_tpu.proto import packets as jpk
from swarm_tpu_torch.proto import csvio as pcsv
from swarm_tpu_torch.proto import packets as ppk

B = 64


def _columns(seed, b=B):
    rng = np.random.default_rng(seed)
    return dict(
        agent=rng.integers(1, 9, b),
        x=rng.uniform(-5, 5, b).astype(np.float32),
        y=rng.uniform(-5, 5, b).astype(np.float32),
        yaw=rng.uniform(-np.pi, np.pi, b).astype(np.float32),
        encoder=rng.integers(0, 1 << 20, b),
        v2v=rng.integers(0, 900, b),
        dist4=rng.uniform(0.0, 4.0, (b, 4)).astype(np.float32),
        landmark=rng.integers(0, 6, b))


def test_batch_codec_byte_equal_both_ways():
    cols = _columns(0)
    wire_p = ppk.pack_quasar_v2_batch(**cols)
    wire_j = jpk.pack_quasar_v2_batch(**cols)
    assert wire_p == wire_j and len(wire_p) == B * ppk.PACKET_SIZE_V2
    for unpack, wire in ((ppk.unpack_quasar_batch, wire_j),
                         (jpk.unpack_quasar_batch, wire_p)):
        got = unpack(wire)
        ref = jpk.unpack_quasar_batch(wire_j)
        assert got.dtype.descr == ref.dtype.descr
        assert got.tobytes() == ref.tobytes()
    for k in range(0, B, 7):
        one = wire_p[k * 42:(k + 1) * 42]
        assert tuple(ppk.parse_packet(one)) == tuple(jpk.parse_packet(one))
        assert ppk.parse_packet(one).pack() == one


@pytest.mark.parametrize("kind", ["v1", "scan", "scan-bridge", "zone",
                                  "target", "command", "garbage"])
def test_scalar_packets_parse_alike(kind):
    r = np.linspace(0.1, 4.0, 181).astype(np.float32)
    make = {
        "v1": lambda m: m.QuasarPacketV1(2, -1.0, 0.5, -0.25, 50, 0, 0.25,
                                         0.5, 0.75, 1.5),
        "scan": lambda m: m.ScanPacket(1, 0.5, 1.0, 0.25, 5, 2, r),
        "scan-bridge": lambda m: m.ScanPacketBridge(2, 0.5, 1.0, 0.25, r),
        "zone": lambda m: m.ZonePacket(1.0, 2.0, 3.0, 4.0),
        "target": lambda m: m.TargetPacket(1.5, 2.5),
        "command": lambda m: m.CommandPacket(0.25, -0.125),
    }
    if kind == "garbage":
        for wire in (b"", b"QSRL", b"NOPE" * 11, bytes(42)):
            assert ppk.parse_packet(wire) is None
            assert jpk.parse_packet(wire) is None
        return
    wire = make[kind](ppk).pack()
    assert wire == make[kind](jpk).pack()
    got, ref = ppk.parse_packet(wire), jpk.parse_packet(wire)
    assert type(got).__name__ == type(ref).__name__
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_csv_round_trip_equals_the_jax_package(tmp_path):
    cols = _columns(1, 48)
    rng = np.random.default_rng(2)
    t = np.cumsum(rng.uniform(0.05, 0.1, 48)).astype(np.float32)
    hits = rng.uniform(-3, 3, (48, 4, 2)).astype(np.float32)
    hv = rng.random((48, 4)) < 0.6
    closures = (np.array([3, 9]), np.array([30, 41]),
                np.array([0.01, -0.02]), np.array([0.0, 0.03]))
    args = (t, cols["agent"], cols["x"], cols["y"], cols["yaw"],
            cols["encoder"], cols["v2v"], cols["dist4"], cols["landmark"])
    dp, dj = tmp_path / "port", tmp_path / "jax"
    pcsv.write_session(str(dp), *args, hits_xy=hits, hit_valid=hv,
                       closures=closures)
    jcsv.write_session(str(dj), *args, hits_xy=hits, hit_valid=hv,
                       closures=closures)
    names = sorted(os.listdir(dj))
    assert sorted(os.listdir(dp)) == names and "telemetry.csv" in names
    for name in names:
        assert (dp / name).read_bytes() == (dj / name).read_bytes(), name
    sp, sj = pcsv.load_session(str(dp)), jcsv.load_session(str(dj))
    for k in sj:
        if k == "points":
            for f in sj[k]:
                np.testing.assert_array_equal(sp[k][f], sj[k][f])
        else:
            np.testing.assert_array_equal(sp[k], sj[k])
    stream = pcsv.packet_stream_from_telemetry(sp, device="cpu")
    ref = jcsv.packet_stream_from_telemetry(sj)
    for f in ref._fields:
        got = getattr(stream, f)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        want = np.asarray(getattr(ref, f))
        assert got.numpy().dtype == want.dtype, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
