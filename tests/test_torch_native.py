"""The port's native library (swarm_tpu_torch/native: its own copies of
the C++ oracle and codec, built with g++ at first use) against the JAX
package's (swarm_tpu/native), and its EKF oracle against the port's
`models/ekf`, on the CPU.

Inputs are made from a seed with numpy. The library is built from the
port's sources into the port's build directory, never loaded from the JAX
package. Bresenham cells, `update_ray` grids, closure decisions and the
parsed telemetry columns are exact against the JAX package's library; the
EKF within the JAX package's own oracle bars (tests/test_native_oracle.py:
mean rtol 1e-4 / atol 1e-5, covariance rtol 1e-3 / atol 1e-5).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from swarm_tpu import native as jnat
from swarm_tpu_torch import native as pnat
from swarm_tpu_torch.config import EkfConfig, GridConfig, SlamConfig
from swarm_tpu_torch.models import ekf as pekf
from swarm_tpu_torch.proto.packets import pack_quasar_v2_batch
from tests.torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not shutil.which("g++"),
                                reason="no g++ toolchain")


def test_library_is_built_from_the_ports_sources():
    lib = pnat.get_lib()
    port_dir = os.path.dirname(os.path.abspath(pnat.__file__))
    assert os.path.samefile(lib._name, pnat._SO)
    assert os.path.commonpath([pnat._SO, os.path.dirname(port_dir)]) == \
        os.path.dirname(port_dir)
    for src in (pnat._SRC, pnat._SRC_CODEC):
        assert os.path.dirname(os.path.dirname(src)) == port_dir
        assert os.path.getmtime(pnat._SO) >= os.path.getmtime(src)
    assert "swarm_tpu" + os.sep + "native" not in pnat._SO


@pytest.mark.parametrize("seg", [(0, 0, 10, 3), (5, 5, -7, 2), (3, 3, 3, 3),
                                 (0, 0, 0, 9), (9, 1, 0, 0), (-4, 7, 31, -2)])
def test_bresenham_equal(seg):
    np.testing.assert_array_equal(pnat.bresenham(*seg), jnat.bresenham(*seg))


def test_update_ray_grids_equal():
    cfg = GridConfig()
    rng = np.random.default_rng(11)
    gp = np.full((cfg.size, cfg.size), -1, np.int8)
    gj = gp.copy()
    for _ in range(300):
        rx, ry = rng.uniform(-5.5, 5.5, 2)
        ang = rng.uniform(-np.pi, np.pi)
        d = rng.uniform(0.0, 2.0)
        hit = bool(rng.random() < 0.7)
        args = (cfg.resolution, cfg.origin_x, cfg.origin_y, rx, ry,
                rx + d * np.cos(ang), ry + d * np.sin(ang), hit)
        assert pnat.update_ray(gp, *args) == jnat.update_ray(gj, *args)
    np.testing.assert_array_equal(gp, gj)
    assert (gp != -1).sum() > 1000


def test_closure_check_equal():
    slam = SlamConfig()
    rng = np.random.default_rng(5)
    lm_x, lm_y, lm_t, lm_n = [], [], [], []
    last, fired = -slam.min_poses_between, 0
    for i in range(400):
        x, y = rng.uniform(0, 3, 2)
        lm = int(rng.integers(0, 6)) if rng.random() < 0.4 else 0
        args = (np.asarray(lm_x, np.float32), np.asarray(lm_y, np.float32),
                np.asarray(lm_t, np.int32), np.asarray(lm_n, np.int32),
                float(x), float(y), lm, i, last, slam.min_poses_between,
                slam.closure_radius_m, slam.closure_correction)
        got = pnat.closure_check(*args)
        assert got == jnat.closure_check(*args)
        if got[0] >= 0:
            last, fired = i, fired + 1
        if lm:
            lm_x.append(x)
            lm_y.append(y)
            lm_t.append(lm)
            lm_n.append(i)
    assert fired > 3


def test_parse_telemetry_buffer_equal():
    """A drain-style buffer of v2 packets, a scan, junk and a short row."""
    rng = np.random.default_rng(3)
    b, stride = 40, 2048
    wire = pack_quasar_v2_batch(
        rng.integers(1, 9, b), rng.uniform(-5, 5, b), rng.uniform(-5, 5, b),
        rng.uniform(-3, 3, b), rng.integers(0, 9999, b),
        rng.integers(0, 500, b), rng.uniform(0, 4, (b, 4)),
        rng.integers(0, 6, b))
    rows = [wire[k * 42:(k + 1) * 42] for k in range(b)]
    from swarm_tpu_torch.proto.packets import ScanPacket
    rows[5] = ScanPacket(3, 0.5, 1.0, 0.25, 5, 2, np.linspace(
        0.1, 4.0, 181).astype(np.float32)).pack()
    rows[9] = b"JUNK" * 10
    rows[13] = rows[13][:30]
    buf = np.zeros((b, stride), np.uint8)
    lens = np.zeros(b, np.int32)
    for k, r in enumerate(rows):
        buf[k, :len(r)] = np.frombuffer(r, np.uint8)
        lens[k] = len(r)
    got = pnat.parse_telemetry_buffer(buf, lens, b)
    ref = jnat.parse_telemetry_buffer(buf, lens, b)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["n_good"] == b - 2
    cols = pnat.parse_telemetry_columns(rows)
    for k in ref:
        np.testing.assert_array_equal(cols[k], ref[k], err_msg=k)


def test_ekf_oracle_matches_the_ports_ekf():
    cfg = EkfConfig()
    oracle = pnat.EkfOracle(cfg.q_diag, cfg.r_odom_diag)
    st = pekf.ekf_init(torch.zeros((1, 6), dtype=torch.float32))
    rng = np.random.default_rng(3)
    t = 0.0
    for _ in range(50):
        t += float(rng.uniform(0.05, 0.2))
        omega = float(rng.normal(0, 0.5))
        v = float(rng.uniform(0, 0.3))
        oracle.predict(omega, t)
        st = pekf.ekf_predict_batch(
            st, torch.tensor([omega], dtype=torch.float32),
            torch.tensor([t], dtype=torch.float32), cfg)
        oracle.update(v, omega)
        st = pekf.ekf_update_batch(
            st, torch.tensor([v], dtype=torch.float32),
            torch.tensor([omega], dtype=torch.float32), cfg)
    np.testing.assert_allclose(st.x[0].numpy(), oracle.x, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(st.P[0].numpy(), oracle.P, rtol=1e-3,
                               atol=1e-5)
