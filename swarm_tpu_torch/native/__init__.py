"""ctypes bindings for the port's native C++ library: the scalar CPU
oracle (EKF, Bresenham, `update_ray`, the closure check), the batch
codec of the wire protocol, and the recvmmsg / sendmmsg loops of the live
server and its benchmark (swarm_tpu/native).

The sources are the port's own copies (`src/oracle.cpp`, `src/codec.cpp`).
`get_lib` builds them with `g++ -O2` at first use into
`swarm_tpu_torch/build/native/` (git-ignored) and rebuilds when a source is
newer than the library. The build writes a name of its own and renames it
into place, so processes that build at the same time never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "oracle.cpp")
_SRC_CODEC = os.path.join(_DIR, "src", "codec.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "build", "native")
_SO = os.path.join(_BUILD, "liboracle.so")
_lock = threading.Lock()
_lib = None


def _build() -> str:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".liboracle-", suffix=".so",
                               dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        _SRC, _SRC_CODEC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    return any(built < os.path.getmtime(p) for p in (_SRC, _SRC_CODEC))


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(_SO)

        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)

        lib.ekf_oracle_init.argtypes = [f32p, f32p]
        lib.ekf_oracle_predict.argtypes = [f32p, f32p, ctypes.c_float,
                                           ctypes.c_float, f32p]
        lib.ekf_oracle_update.argtypes = [f32p, f32p, ctypes.c_float,
                                          ctypes.c_float, f32p]
        lib.bresenham_oracle.restype = ctypes.c_int
        lib.bresenham_oracle.argtypes = [ctypes.c_int] * 4 + [i32p,
                                                              ctypes.c_int]
        lib.update_ray_oracle.restype = ctypes.c_int
        lib.update_ray_oracle.argtypes = [i8p, ctypes.c_int] + \
            [ctypes.c_float] * 7 + [ctypes.c_int]
        lib.closure_check_oracle.restype = ctypes.c_int
        lib.closure_check_oracle.argtypes = [
            f32p, f32p, i32p, i32p, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, f32p, f32p]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.codec_is_little_endian.restype = ctypes.c_int
        lib.parse_telemetry_batch.restype = ctypes.c_int
        lib.parse_telemetry_batch.argtypes = [
            u8p, i32p, i32p, ctypes.c_int,
            i32p, i32p, f32p, f32p, f32p, i32p, i32p, f32p, i32p, f32p]
        lib.drain_udp.restype = ctypes.c_int
        lib.drain_udp.argtypes = [ctypes.c_int, u8p, ctypes.c_int,
                                  ctypes.c_int, i32p, u32p, i32p]
        lib.blast_udp.restype = ctypes.c_longlong
        lib.blast_udp.argtypes = [ctypes.c_int, u8p, ctypes.c_int,
                                  ctypes.c_int, i32p, ctypes.c_int,
                                  ctypes.c_int]
        _lib = lib
        return _lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class EkfOracle:
    """Scalar float32 EKF mirroring AgentFirmware_Bot1/ekf.cpp."""

    def __init__(self, q_diag, r_diag):
        self.lib = get_lib()
        self.x = np.zeros(6, np.float32)
        self.P = np.zeros((6, 6), np.float32)
        self.q = np.asarray(q_diag, np.float32)
        self.r = np.asarray(r_diag, np.float32)
        self.lib.ekf_oracle_init(_fp(self.x), _fp(self.P))
        self.last_t = 0.0

    def predict(self, omega, t):
        dt = t - self.last_t
        self.lib.ekf_oracle_predict(_fp(self.x), _fp(self.P),
                                    ctypes.c_float(omega),
                                    ctypes.c_float(dt), _fp(self.q))
        if dt > 0:
            self.last_t = t

    def update(self, v, omega):
        self.lib.ekf_oracle_update(_fp(self.x), _fp(self.P),
                                   ctypes.c_float(v), ctypes.c_float(omega),
                                   _fp(self.r))


def bresenham(x0, y0, x1, y1, max_n: int = 4096) -> np.ndarray:
    """[(x, y)] cells, reference order."""
    lib = get_lib()
    out = np.empty((max_n, 2), np.int32)
    n = lib.bresenham_oracle(
        int(x0), int(y0), int(x1), int(y1),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_n)
    return out[:n]


def update_ray(grid: np.ndarray, res, ox, oy, rx, ry, wx, wy,
               hit: bool) -> int:
    """In-place reference update_ray on an int8 [S, S] grid; returns
    writes."""
    lib = get_lib()
    assert grid.dtype == np.int8 and grid.flags.c_contiguous
    return lib.update_ray_oracle(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        grid.shape[0], ctypes.c_float(res), ctypes.c_float(ox),
        ctypes.c_float(oy), ctypes.c_float(rx), ctypes.c_float(ry),
        ctypes.c_float(wx), ctypes.c_float(wy), int(hit))


def closure_check(lm_x, lm_y, lm_type, lm_node, x, y, lm, node_idx,
                  last_closure_node, min_gap=30, radius=0.6, damping=0.5):
    """Returns (slot or -1, dx, dy)."""
    lib = get_lib()
    lm_x = np.ascontiguousarray(lm_x, np.float32)
    lm_y = np.ascontiguousarray(lm_y, np.float32)
    lm_type = np.ascontiguousarray(lm_type, np.int32)
    lm_node = np.ascontiguousarray(lm_node, np.int32)
    dx = ctypes.c_float()
    dy = ctypes.c_float()
    slot = lib.closure_check_oracle(
        _fp(lm_x), _fp(lm_y),
        lm_type.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lm_node.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(lm_x), ctypes.c_float(x), ctypes.c_float(y), int(lm),
        int(node_idx), int(last_closure_node), int(min_gap),
        ctypes.c_float(radius), ctypes.c_float(damping),
        ctypes.byref(dx), ctypes.byref(dy))
    return slot, dx.value, dy.value


def parse_telemetry_columns(datagrams):
    """Native batch parse of raw UDP payloads -> column arrays.

    datagrams: list of bytes. Returns a dict of [n]-arrays (scans
    [n, 181], dist4 [n, 4]) plus 'kind' (0 unrecognised / 1 v1 / 2 v2 /
    3 scan / 4 scan-bridge) — the server runtime's hot-path codec
    (proto/packets.py layouts; see src/codec.cpp). Raises RuntimeError
    on big-endian hosts (the wire format is little-endian)."""
    import ctypes as ct

    lib = get_lib()
    if not lib.codec_is_little_endian():
        raise RuntimeError("native codec requires a little-endian host")
    n = len(datagrams)
    lens = np.asarray([len(d) for d in datagrams], np.int32)
    off = np.zeros(n, np.int32)
    if n:
        off[1:] = np.cumsum(lens[:-1])
    buf = np.frombuffer(b"".join(datagrams), np.uint8) if n else \
        np.zeros(1, np.uint8)
    out = {
        "kind": np.zeros(n, np.int32),
        "agent": np.zeros(n, np.int32),
        "x": np.zeros(n, np.float32),
        "y": np.zeros(n, np.float32),
        "yaw": np.zeros(n, np.float32),
        "encoder": np.zeros(n, np.int32),
        "v2v": np.zeros(n, np.int32),
        "dist4": np.zeros((n, 4), np.float32),
        "landmark": np.zeros(n, np.int32),
        "scans": np.zeros((n, 181), np.float32),
    }
    if n:
        i32 = ctypes.POINTER(ctypes.c_int32)
        good = lib.parse_telemetry_batch(
            buf.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            off.ctypes.data_as(i32), lens.ctypes.data_as(i32), n,
            out["kind"].ctypes.data_as(i32),
            out["agent"].ctypes.data_as(i32),
            _fp(out["x"]), _fp(out["y"]), _fp(out["yaw"]),
            out["encoder"].ctypes.data_as(i32),
            out["v2v"].ctypes.data_as(i32),
            _fp(out["dist4"]),
            out["landmark"].ctypes.data_as(i32),
            _fp(out["scans"]))
        out["n_good"] = int(good)
    else:
        out["n_good"] = 0
    return out


def parse_telemetry_buffer(buf: np.ndarray, lens: np.ndarray, n: int):
    """parse_telemetry_columns over a strided drain buffer (zero-copy:
    offsets are row strides of `buf`)."""
    import ctypes as ct

    lib = get_lib()
    if not lib.codec_is_little_endian():
        raise RuntimeError("native codec requires a little-endian host")
    stride = buf.shape[1]
    off = (np.arange(n, dtype=np.int32) * stride)
    lens = np.ascontiguousarray(lens[:n], np.int32)
    out = {
        "kind": np.zeros(n, np.int32),
        "agent": np.zeros(n, np.int32),
        "x": np.zeros(n, np.float32),
        "y": np.zeros(n, np.float32),
        "yaw": np.zeros(n, np.float32),
        "encoder": np.zeros(n, np.int32),
        "v2v": np.zeros(n, np.int32),
        "dist4": np.zeros((n, 4), np.float32),
        "landmark": np.zeros(n, np.int32),
        "scans": np.zeros((n, 181), np.float32),
    }
    if n:
        i32 = ct.POINTER(ct.c_int32)
        good = lib.parse_telemetry_batch(
            buf.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            off.ctypes.data_as(i32), lens.ctypes.data_as(i32), n,
            out["kind"].ctypes.data_as(i32),
            out["agent"].ctypes.data_as(i32),
            _fp(out["x"]), _fp(out["y"]), _fp(out["yaw"]),
            out["encoder"].ctypes.data_as(i32),
            out["v2v"].ctypes.data_as(i32),
            _fp(out["dist4"]),
            out["landmark"].ctypes.data_as(i32),
            _fp(out["scans"]))
        out["n_good"] = int(good)
    else:
        out["n_good"] = 0
    return out


def drain_udp_socket(fd: int, max_msgs: int = 1024, stride: int = 2048):
    """Drain a non-blocking UDP socket with recvmmsg(2), one syscall per
    <= 256 datagrams (src/codec.cpp `drain_udp`). Returns (buf
    [max_msgs, stride] uint8, lens [n], ip4 [n] uint32 in host order,
    port [n], n)."""
    lib = get_lib()
    buf = np.empty((max_msgs, stride), np.uint8)
    lens = np.empty(max_msgs, np.int32)
    ip4 = np.empty(max_msgs, np.uint32)
    port = np.empty(max_msgs, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    n = lib.drain_udp(fd, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      stride, max_msgs, lens.ctypes.data_as(i32),
                      ip4.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                      port.ctypes.data_as(i32))
    return buf, lens[:n], ip4[:n], port[:n], n


def blast_udp_ring(port: int, packets, stop_flag: ctypes.c_int32,
                   burst: int = 64, sleep_us: int = 0) -> int:
    """Cycle a ring of equal-length packets into 127.0.0.1:`port` with
    sendmmsg(2), `burst` at a time with `sleep_us` between bursts, until
    `stop_flag.value` becomes nonzero (src/codec.cpp `blast_udp`).
    Returns the packets handed to the kernel. Blocks: run it in a thread
    (ctypes releases the GIL for the call). Raises OSError when the
    sending socket cannot be opened or connected."""
    lib = get_lib()
    pkt_len = len(packets[0])
    if any(len(p) != pkt_len for p in packets):
        raise ValueError("blast ring packets must be of equal length")
    ring = np.frombuffer(b"".join(packets), np.uint8)
    sent = int(lib.blast_udp(
        int(port), ring.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pkt_len, len(packets),
        ctypes.cast(ctypes.byref(stop_flag), ctypes.POINTER(ctypes.c_int32)),
        int(burst), int(sleep_us)))
    if sent < 0:
        raise OSError(f"blast_udp: socket or connect to port {port} failed")
    return sent
