"""The offline tiers (swarm_tpu_torch/slam/refine.py, joint.py,
calibrate.py) against the JAX package's, on the CPU.

Sessions are made from a seed with numpy: agents walking noisy loops
around their own centres with a drifted estimate (a yaw-rate bias and a
scale, as the reference's drift model), landmarks where a loop passes its
start, step-major rows with 1-based agents (tools/bench_accuracy.py's
layout). The same dicts go to the JAX functions and to the port.

Bars: closure lists, `split_closures` and `agent_components` exact;
refined and joint poses at atol 1e-3 (the solvers' bar,
tests/test_torch_posegraph.py); bias and scale within 1e-4, the
calibrated chains within 1e-3 m; the re-localized fixes' decisions exact
and their positions within 5e-4 m (the matcher's sub-cell bar,
tests/test_torch_closurematch.py). Chains of 48 nodes (the dense solver)
and one of 300 (above 256 nodes: the structured solver).
"""

import dataclasses

import numpy as np
import pytest

from swarm_tpu.config import SwarmConfig as JSwarm
from swarm_tpu.slam import calibrate as jcal
from swarm_tpu.slam import joint as jjo
from swarm_tpu.slam import refine as jre
from swarm_tpu_torch import convert
from swarm_tpu_torch.slam import calibrate as pcal
from swarm_tpu_torch.slam import joint as pjo
from swarm_tpu_torch.slam import refine as pre
from tests.torch_parity import assert_close, assert_exact
from tests.torch_parity import torch_one_thread  # noqa: F401

POSE_ATOL = 1e-3
CFG_J = JSwarm()
CFG_P = convert.config_from(CFG_J)


def _session(seed, n, t, loops=2.0):
    """(session dict, true xy [T, N, 2]) of n agents looping t steps."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0, 2 * np.pi * loops, t)
    centres = np.stack([np.arange(n) * 1.5, np.zeros(n)], -1)
    true = centres[None] + np.stack([np.cos(s), np.sin(s)], -1)[:, None]
    true = true + 0.01 * rng.normal(size=true.shape)
    bias = rng.choice([-0.02, 0.02], n)
    scale = rng.choice([0.99, 1.01], n)
    est = np.zeros_like(true)
    est[0] = true[0]
    dist = np.zeros(n)
    yaw = np.zeros((t, n))
    for i in range(1, t):
        d = true[i] - true[i - 1]
        a = bias * dist
        est[i, :, 0] = est[i - 1, :, 0] + scale * (np.cos(a) * d[:, 0] -
                                                   np.sin(a) * d[:, 1])
        est[i, :, 1] = est[i - 1, :, 1] + scale * (np.sin(a) * d[:, 0] +
                                                   np.cos(a) * d[:, 1])
        dist += np.hypot(d[:, 0], d[:, 1])
        yaw[i] = s[i] + np.pi / 2 + a
    lm = np.zeros((t, n), np.int64)
    lm[(np.abs(np.sin(s / 2)) < 0.12)] = 5    # near each loop's start
    session = {"t": np.repeat(np.arange(t, dtype=np.float64) * 0.4, n),
               "agent": np.tile(np.arange(1, n + 1), t),
               "x": est[..., 0].reshape(-1), "y": est[..., 1].reshape(-1),
               "yaw_deg": np.degrees(yaw.reshape(-1)),
               "landmark": lm.reshape(-1)}
    return session, true


def _closure_log(seed, n, t, true, cross=True):
    """A closure log in global rows (node_i, node_j, agent 1-based, meas,
    fit): measured intra edges (the true relative pose), unmeasured ones
    (fit < 0.6), a duplicate, a self-pair, verified and failed cross
    edges between agents 1 and 2."""
    rng = np.random.default_rng(seed + 50)
    ni, nj, ag, meas, fit = [], [], [], [], []

    def add(a_i, i, a_j, j, f):
        d = true[j, a_j] - true[i, a_i]
        ni.append(i * n + a_i)
        nj.append(j * n + a_j)
        ag.append(a_j + 1)
        meas.append([d[0], d[1], 0.01 * rng.normal()])
        fit.append(f)

    for a in range(n):
        for _ in range(5):
            i = int(rng.integers(0, t // 3))
            j = int(rng.integers(t // 2, t))
            add(a, i, a, j, float(rng.uniform(0.3, 0.95)))
        add(a, 3, a, t - 2, 0.9)
        add(a, 3, a, t - 2, 0.95)        # duplicate, better fit
        add(a, 5, a, 5, 0.9)             # self-pair
    if cross:
        add(0, t // 2, 1, t // 2 + 1, 0.9)
        add(1, t - 3, 0, t - 1, 0.8)
        add(0, 4, 1, 6, 0.2)             # failed verification
    return (np.asarray(ni), np.asarray(nj), np.asarray(ag),
            np.asarray(meas, np.float32), np.asarray(fit, np.float32))


def _unary(n, t, seed=9):
    rng = np.random.default_rng(seed)
    out = {}
    for a in range(1, n + 1):
        idx = np.sort(rng.choice(t, 6, replace=False)).astype(np.int64)
        z = rng.normal(size=(6, 3)).astype(np.float32) * 0.05
        out[a] = (idx, z, np.tile(np.array([25.0, 25.0, 4.0], np.float32),
                                  (6, 1)))
    return out


def _same_refined(got, ref, keys=("closures",)):
    assert sorted(got) == sorted(ref)
    for a in ref:
        assert_close(got[a]["poses"], ref[a]["poses"], rtol=0,
                     atol=POSE_ATOL, what=f"agent {a}")
        assert_exact(got[a]["idx"], ref[a]["idx"])
        for k in keys:
            assert got[a][k] == ref[a][k], (a, k)


@pytest.fixture(scope="module")
def loops():
    session, true = _session(0, 3, 48)
    return session, true, _closure_log(0, 3, 48, true)


def test_refine_session_redetected_closures(loops):
    session, _, _ = loops
    ref = jre.refine_session(session, cfg=CFG_J)
    got = pre.refine_session(session, cfg=CFG_P, device="cpu")
    _same_refined(got, ref)
    assert any(len(r["closures"]) > 0 for r in got.values())


@pytest.mark.parametrize("unary", [False, True])
def test_refine_session_measured_closures(loops, unary):
    session, _, closures = loops
    un = _unary(3, 48) if unary else None
    ref = jre.refine_session(session, closures=closures, cfg=CFG_J,
                             unary=un)
    got = pre.refine_session(session, closures=closures, cfg=CFG_P,
                             unary=un, device="cpu")
    _same_refined(got, ref, keys=("closures", "measured"))
    assert sum(r["measured"] for r in got.values()) > 0


def test_split_closures_and_components_exact(loops):
    session, _, closures = loops
    ref = jjo.split_closures(session, closures, fit_min=0.6)
    got = pjo.split_closures(session, closures, fit_min=0.6)
    assert got[0] == ref[0]
    for a in ref[1]:
        assert len(got[1][a]) == len(ref[1][a])
        for x, y in zip(got[1][a], ref[1][a]):
            assert (x is None) == (y is None)
            if x is not None:
                assert_exact(x, y)
    assert [e[:4] for e in got[2]] == [e[:4] for e in ref[2]]
    assert len(got[2]) == 2
    for a in ref[3]:
        assert_exact(got[3][a], ref[3][a])
    inter = got[2] + [(3, 0, 4, 0, None)]
    assert pjo.agent_components([1, 2, 3, 4, 5], inter) == \
        jjo.agent_components([1, 2, 3, 4, 5], inter)
    # a legacy log (no fit column) keeps its cross edges as coincidence
    legacy = closures[:3]
    assert [e[:4] for e in pjo.split_closures(session, legacy)[2]] == \
        [e[:4] for e in jjo.split_closures(session, legacy)[2]]


@pytest.mark.parametrize("unary", [False, True])
def test_joint_refine_session(loops, unary):
    session, _, closures = loops
    un = _unary(3, 48) if unary else None
    ref = jjo.joint_refine_session(session, closures=closures, cfg=CFG_J,
                                   unary=un)
    got = pjo.joint_refine_session(session, closures=closures, cfg=CFG_P,
                                   unary=un, device="cpu")
    _same_refined(got, ref, keys=("closures", "component", "inter_edges"))
    assert {r["component"] for r in got.values()} == {(1, 2), (3,)}


def test_refine_structured_branch():
    """A 300-node chain (capacity 512 > 256): the structured solver."""
    session, true = _session(1, 1, 300, loops=3.0)
    closures = _closure_log(1, 1, 300, true, cross=False)
    ref = jre.refine_session(session, closures=closures, cfg=CFG_J)
    got = pre.refine_session(session, closures=closures, cfg=CFG_P,
                             device="cpu")
    _same_refined(got, ref, keys=("closures", "measured"))
    assert pre._next_pow2(300) > pre.DENSE_MAX_NODES


def test_reraster_session_names_a6(loops):
    """`reraster_session` raised naming A6 until the replay was ported;
    now it runs and its grid equals JAX's on the refined loops session
    (the session given the sensor columns a replay reads)."""
    session = dict(loops[0])
    p = len(session["t"])
    rng = np.random.default_rng(9)
    session.update(dist_cm=rng.uniform(10.0, 160.0, (p, 4)).astype(
        np.float32), encoder=np.zeros(p, np.int32), v2v=np.zeros(p, np.int32))
    cfg_j = dataclasses.replace(CFG_J, n_agents=3)
    cfg_p = convert.config_from(cfg_j)
    refined = pre.refine_session(session, cfg=cfg_p, device="cpu")
    ref, _ = jre.reraster_session(session, refined, cfg_j)
    got, stream = pre.reraster_session(session, refined, cfg_p,
                                       device="cpu")
    assert_exact(got, ref, what="reraster grid")
    assert (got != cfg_p.grid.unknown).sum() > 500
    assert int(stream.landmark.abs().sum()) == 0


def _drifted(n, t, seed=3, false_frac=0.0):
    """Drifted chains [T, N] with fixes every 8 steps (5 cm noise; a
    fraction replaced by 0.5-1.5 m false offsets)."""
    session, true = _session(seed, n, t, loops=1.5)
    ex = session["x"].reshape(t, n)
    ey = session["y"].reshape(t, n)
    eyaw = np.radians(session["yaw_deg"].reshape(t, n))
    rng = np.random.default_rng(seed + 7)
    mask = np.zeros((t, n), bool)
    mask[7::8] = True
    zx = true[..., 0] + 0.05 * rng.normal(size=(t, n))
    zy = true[..., 1] + 0.05 * rng.normal(size=(t, n))
    bad = mask & (rng.random((t, n)) < false_frac)
    zx[bad] += rng.uniform(0.5, 1.5, bad.sum())
    return ex, ey, eyaw, mask, zx, zy


@pytest.mark.parametrize("robust", [False, True])
def test_calibrate_chains(robust):
    args = _drifted(3, 200, false_frac=0.3 if robust else 0.0)
    kw = dict(robust_c=0.25, irls_rounds=2) if robust else {}
    ref = jcal.calibrate_chains(*args, **kw)
    got = pcal.calibrate_chains(*args, device="cpu", **kw)
    assert_close(got["bias"], ref["bias"], rtol=0, atol=1e-4)
    assert_close(got["scale"], ref["scale"], rtol=0, atol=1e-4)
    assert_exact(got["n_obs"], ref["n_obs"])
    for k in ("x", "y", "yaw", "dist"):
        assert_close(got[k], ref[k], rtol=0, atol=1e-3, what=k)
    assert float(np.abs(got["bias"]).min()) > 0


def _reloc_world():
    """The 4-agent accuracy world's anchor: true walls painted at log-odds
    2.0; noise-free sweeps of agents walking 2-3 m from their homes into
    the room, and their chains drifting off the truth."""
    import jax
    import jax.numpy as jnp

    from swarm_tpu.models.scan import sense_scan_true
    from swarm_tpu_torch.accuracy import true_wall_mask
    from tests.torch_parity import jax_accuracy

    cfg, walls, params, rooms = jax_accuracy(4, "merge_anchored")
    anchor = np.where(true_wall_mask(np.asarray(walls), cfg.grid), 2.0,
                      0.0).astype(np.float32)
    t, n = 48, 4
    rng = np.random.default_rng(11)
    hx, hy = np.asarray(params.home_x), np.asarray(params.home_y)
    inward = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)   # toward the room
    tx = hx[None] + inward * np.cumsum(rng.uniform(0.02, 0.06, (t, n)), 0)
    ty = hy[None] + inward * np.cumsum(rng.uniform(0.0, 0.04, (t, n)), 0)
    tyaw = np.asarray(params.yaw0)[None] + 0.02 * np.arange(t)[:, None]
    wa = np.asarray(rooms[0])[np.asarray(rooms[1])]
    cast = jax.jit(jax.vmap(lambda p, w: sense_scan_true(p[None], w)[0]))
    scans = np.stack([np.asarray(cast(jnp.asarray(np.stack(
        [tx[i], ty[i], tyaw[i]], -1), jnp.float32), jnp.asarray(wa)))
        for i in range(t)])
    ex = tx + 0.03 * np.arange(t)[:, None] / t
    ey = ty - 0.02 * np.arange(t)[:, None] / t
    mask = np.zeros((t, n), bool)
    mask[::4] = True
    return cfg, anchor, (ex, ey, tyaw, mask, tx, ty), scans


def test_calibrate_reloc():
    cfg_j, anchor, args, scans = _reloc_world()
    cfg_p = convert.config_from(cfg_j)
    cal_kw = dict(min_obs=2)
    ref = jcal.calibrate_reloc(*args, anchor, scans, cfg_j, rounds=1,
                               every=8, **cal_kw)
    got = pcal.calibrate_reloc(*args, anchor, scans, cfg_p, rounds=1,
                               every=8, device="cpu", **cal_kw)
    assert_exact(got[1], ref[1])
    assert int(got[1].sum()) > 0
    assert_close(got[2][got[1]], ref[2][ref[1]], rtol=0, atol=5e-4)
    assert_close(got[3][got[1]], ref[3][ref[1]], rtol=0, atol=5e-4)
    assert_close(got[0]["bias"], ref[0]["bias"], rtol=0, atol=1e-4)
    assert_close(got[0]["scale"], ref[0]["scale"], rtol=0, atol=1e-4)
