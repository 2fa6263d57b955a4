"""The port's synthetic session generator (swarm_tpu_torch/sim/scenario.py)
against the JAX package's (swarm_tpu/sim/scenario.py), on the CPU.

The scripted, host-side numpy parts (waypoints, the wiggle controller, the
stuck fault, the drift chain, the channel model) are exact. The sensor
casts run through the port's `models/sensors.sense_true` in torch, so
`dist4` is held within 1e-5 m; a landmark or a `v2v` decided from a cast
that moved across its threshold would flip, and the test counts such
flips and states them (0 on these sessions). Then the reference pipeline,
session -> CSV -> `load_session` -> `packet_stream_from_telemetry` ->
`replay_session`, on both sides: grids equal.
"""

import math

import numpy as np
import pytest

from swarm_tpu.config import SwarmConfig as JSwarm
from swarm_tpu.proto import csvio as jcsv
from swarm_tpu.sim import scenario as jsc
from swarm_tpu_torch import convert
from swarm_tpu_torch.engine import replay as prp
from swarm_tpu_torch.proto import csvio as pcsv
from swarm_tpu_torch.sim import scenario as psc
from tests.torch_parity import torch_one_thread  # noqa: F401

CAST_ATOL = 1e-5
EXACT = ("t", "agent", "x", "y", "yaw_q", "encoder", "true_pose", "est_pose")


@pytest.fixture(scope="module")
def dual():
    return (jsc.generate_dual_session(seed=42),
            psc.generate_dual_session(seed=42, device="cpu"))


def _flips(got, ref):
    """{field: rows that differ} for the cast-decided fields."""
    return {f: int((getattr(got, f) != getattr(ref, f)).sum())
            for f in ("landmark", "v2v")}


def test_dual_session_equals_the_jax_package(dual):
    ref, got = dual
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(ref, f).dtype
    np.testing.assert_allclose(got.dist4, ref.dist4, rtol=0, atol=CAST_ATOL)
    assert _flips(got, ref) == {"landmark": 0, "v2v": 0}
    assert len(got.t) > 600 and (got.landmark > 0).sum() > 20


@pytest.mark.parametrize("part", ["waypoints", "interpolate", "stuck",
                                  "drift"])
def test_scripted_parts_exact(part):
    if part == "waypoints":
        for side, start in ((+1, (0.0, 0.0)), (-1, (5.0, 0.0))):
            assert psc.perimeter_sweep_waypoints(side, start=start) == \
                jsc.perimeter_sweep_waypoints(side, start=start)
        return
    wps = jsc.perimeter_sweep_waypoints(-1, start=(5.0, 0.0))
    ref = jsc.interpolate_waypoints(wps, np.random.default_rng(4))
    got = psc.interpolate_waypoints(wps, np.random.default_rng(4))
    if part == "stuck":
        ref = jsc.inject_stuck(ref, np.random.default_rng(5), (5.2, 1.7),
                               math.pi)
        got = psc.inject_stuck(got, np.random.default_rng(5), (5.2, 1.7),
                               math.pi)
    if part == "drift":
        noise = JSwarm().noise
        ref = jsc._drift_chain(ref, len(ref) - 20, 1.02, 0.03,
                               np.random.default_rng(6), noise)
        got = psc._drift_chain(got, len(got) - 20, 1.02, 0.03,
                               np.random.default_rng(6), noise)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype and len(got) > 100


def test_three_agent_session_without_fault():
    rng = np.random.default_rng(8)
    trajs = [jsc.interpolate_waypoints(jsc.perimeter_sweep_waypoints(
        s, start=st), rng) for s, st in ((+1, (0.0, 0.0)), (-1, (5.0, 0.0)),
                                          (+1, (1.0, -1.0)))]
    trajs[2] = trajs[2][:150]
    ref = jsc.generate_session(trajs, seed=3, jitter_agents=(2, 3))
    got = psc.generate_session(trajs, seed=3, jitter_agents=(2, 3),
                               device="cpu")
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.dist4, ref.dist4, rtol=0, atol=CAST_ATOL)
    assert _flips(got, ref) == {"landmark": 0, "v2v": 0}


def test_session_csv_replay_pipeline(dual, tmp_path):
    """run_session's scripted sequence without the render: the same grid
    on both sides."""
    ref, got = dual
    cfg_j = JSwarm(n_agents=2)
    cfg_p = convert.config_from(cfg_j)
    dirs = []
    for mod, s in ((jcsv, ref), (pcsv, got)):
        d = str(tmp_path / mod.__name__.split(".")[0])
        mod.write_session(d, s.t, s.agent, s.x, s.y, s.yaw_q, s.encoder,
                          s.v2v, s.dist4, s.landmark)
        dirs.append(d)
    sess_j, sess_p = jcsv.load_session(dirs[0]), pcsv.load_session(dirs[1])
    for k in ("t", "agent", "x", "y", "yaw_deg", "dist_cm", "landmark"):
        np.testing.assert_array_equal(sess_p[k], sess_j[k], err_msg=k)
    import jax
    import jax.numpy as jnp

    from swarm_tpu.engine.replay import replay_session as j_replay
    st_j, _ = jax.jit(lambda s: j_replay(
        s, cfg_j, offsets=jnp.zeros(2)))(
        jcsv.packet_stream_from_telemetry(sess_j))
    stream = pcsv.packet_stream_from_telemetry(sess_p, device="cpu")
    st_p, _ = prp.replay_session(stream, cfg_p)
    np.testing.assert_array_equal(st_p.grid.numpy(), np.asarray(st_j.grid))
    assert int(st_p.closure.cl_count) == int(st_j.closure.cl_count)
    g = st_p.grid.numpy()
    assert (g == cfg_p.grid.free).sum() > 2000
    assert (g == cfg_p.grid.occupied).sum() > 100
