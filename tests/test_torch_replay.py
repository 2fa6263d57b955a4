"""The mapping server (swarm_tpu_torch/engine/replay.py) against the JAX
package's (swarm_tpu/engine/replay.py), on the CPU.

`replay_session` is a closed form in the port (closure windows, one raster
over all rays, cadences from the timestamps); the JAX package scans
`ingest_packet` over the packets. Both replay the 600-packet, 2-agent
stream of tests/test_replay_parity.py, on which closures fire. Bars: the
grid's cells equal (ROADMAP C26 would allow 0.1% of the painted cells
where an ulp of `cos` moves an endpoint across a cell edge; none does
here), and equal to the port's native oracle (`update_ray` on the same
corrected rays in order); closure decisions, `cl_*` nodes and per-packet
writes exact; corrections, drift, corrected poses and zone boxes within
1e-5. A mutation (the drift not fed forward) must fail those bars.
`ingest_frame` runs a few 16-packet frames at 8 agents, with and without
`compute_frontiers` / `enable_targets`, and with sweeps (scan-matched
closures with the 48 + 2 x 8 window of tests/test_torch_closure_engine.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import SwarmConfig as JSwarm
from swarm_tpu.engine import replay as jrp
from swarm_tpu.proto import csvio as jcsv
from swarm_tpu.sim import scenario as jsc
from swarm_tpu.slam import refine as jre
from swarm_tpu_torch import convert, native
from swarm_tpu_torch.engine import replay as prp
from swarm_tpu_torch.geom.world import BEDROOM_WALLS
from swarm_tpu_torch.models.scan import sense_scan_true
from swarm_tpu_torch.slam import refine as pre
from tests.test_replay_parity import make_stream

ATOL = 1e-5
C26_SHARE = 1e-3
N_FRAME_AGENTS = 8
FRAME = 16
WIDE = dict(closure_scanmatch=True, closure_cross_radius_m=6.5,
            closure_pair_cooldown=16, closure_match_window=48,
            closure_match_search=8)


def _jstream(cols, valid=None):
    t, agent, x, y, yaw, dist, lm = cols
    n = len(t)
    return jrp.PacketStream(
        t=jnp.asarray(t), agent=jnp.asarray(agent), x=jnp.asarray(x),
        y=jnp.asarray(y), yaw=jnp.asarray(yaw),
        encoder=jnp.zeros(n, jnp.int32), v2v=jnp.zeros(n, jnp.int32),
        dist=jnp.asarray(dist), landmark=jnp.asarray(lm),
        valid=jnp.ones(n, bool) if valid is None else jnp.asarray(valid))


def _pstream(js):
    return prp.PacketStream(*(torch.from_numpy(np.array(f)) for f in js))


def _padded(cols, pad=57):
    """The stream with `pad` zero rows marked not valid."""
    out = [np.concatenate([c, np.zeros((pad,) + c.shape[1:], c.dtype)])
           for c in cols]
    valid = np.concatenate([np.ones(len(cols[0]), bool),
                            np.zeros(pad, bool)])
    return out, valid


@functools.lru_cache(maxsize=None)
def _jit_replay(cfg, **kw):
    return jax.jit(lambda s: jrp.replay_session(s, cfg, **kw))


@pytest.fixture(scope="module")
def parity():
    cols = make_stream(np.random.default_rng(7))
    cfg_j = JSwarm(n_agents=2)
    cfg_p = convert.config_from(cfg_j)
    js = _jstream(cols)
    st_j, out_j = _jit_replay(cfg_j)(js)
    return cols, cfg_j, cfg_p, js, (st_j, out_j)


def _mismatches(st_p, out_p, st_j, out_j, cfg_p):
    """The bars of the module docstring, as a list of what broke."""
    bad = []
    g_p, g_j = st_p.grid.numpy(), np.asarray(st_j.grid)
    painted = max(1, int((g_j != cfg_p.grid.unknown).sum()))
    if (g_p != g_j).sum() > C26_SHARE * painted:
        bad.append(f"grid: {(g_p != g_j).sum()} of {painted} cells")
    cl = int(st_j.closure.cl_count)
    exact = {"cl_count": (st_p.closure.cl_count, st_j.closure.cl_count),
             "closed": (out_p.closed, out_j.closed),
             "writes": (out_p.writes, out_j.writes),
             "total_writes": (st_p.total_writes, st_j.total_writes),
             "hit_valid": (out_p.hit_valid, out_j.hit_valid),
             "online": (out_p.online, out_j.online),
             "pkt_counts": (st_p.pkt_counts, st_j.pkt_counts),
             "zone_active": (st_p.zone_active, st_j.zone_active),
             "n_nodes": (st_p.closure.n_nodes, st_j.closure.n_nodes),
             "lm_count": (st_p.closure.lm_count, st_j.closure.lm_count),
             "last_closure_node": (st_p.closure.last_closure_node,
                                   st_j.closure.last_closure_node)}
    for f in ("cl_lm_node", "cl_node", "cl_agent"):
        exact[f] = (getattr(st_p.closure, f)[:cl],
                    np.asarray(getattr(st_j.closure, f))[:cl])
    for k, (a, b) in exact.items():
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            bad.append(k)
    close = {"rx": (out_p.rx, out_j.rx), "ry": (out_p.ry, out_j.ry),
             "corr": (out_p.corr, out_j.corr),
             "hits": (out_p.hits, out_j.hits),
             "drift_dx": (st_p.closure.drift_dx, st_j.closure.drift_dx),
             "drift_dy": (st_p.closure.drift_dy, st_j.closure.drift_dy),
             "agent_xy": (st_p.agent_xy, st_j.agent_xy),
             "zone_boxes": (st_p.zone_boxes, st_j.zone_boxes),
             "last_packet_t": (st_p.last_packet_t, st_j.last_packet_t),
             "last_zone_t": (st_p.last_zone_t, st_j.last_zone_t),
             "cl_dx": (st_p.closure.cl_dx[:cl],
                       np.asarray(st_j.closure.cl_dx)[:cl]),
             "lm_x": (st_p.closure.lm_x, st_j.closure.lm_x)}
    for f in ("min_x", "min_y", "max_x", "max_y"):
        close["zone." + f] = (getattr(st_p.zone, f), getattr(st_j.zone, f))
    for k, (a, b) in close.items():
        if not np.allclose(np.asarray(a), np.asarray(b), rtol=0, atol=ATOL):
            bad.append(k)
    return bad


def test_replay_session_equals_the_jax_scan(parity):
    cols, _, cfg_p, js, (st_j, out_j) = parity
    st_p, out_p, stats = prp.replay_session(_pstream(js), cfg_p, stats=True)
    assert _mismatches(st_p, out_p, st_j, out_j, cfg_p) == []
    n_cl = int(st_p.closure.cl_count)
    assert n_cl > 0, "no closure fired: a weak test"
    # at most one window per closure, plus the closure-free tail
    assert stats.closures == n_cl and 1 <= stats.windows <= n_cl + 1
    # the grid against the port's native oracle: update_ray, ray by ray in
    # packet order, from the same corrected rays
    g = cfg_p.grid
    oracle = np.full((g.size, g.size), g.unknown, np.int8)
    rx, ry = out_p.rx.numpy(), out_p.ry.numpy()
    hits, hv = out_p.hits.numpy(), out_p.hit_valid.numpy()
    writes = []
    for i in range(len(rx)):
        writes.append(sum(native.update_ray(
            oracle, g.resolution, g.origin_x, g.origin_y, rx[i], ry[i],
            hits[i, k, 0], hits[i, k, 1], bool(hv[i, k])) for k in range(4)))
    np.testing.assert_array_equal(st_p.grid.numpy(), oracle)
    np.testing.assert_array_equal(out_p.writes.numpy(), writes)


@pytest.fixture(scope="module")
def eight():
    cols = make_stream(np.random.default_rng(5), n_packets=600, n_agents=8)
    cfg_j = JSwarm(n_agents=8)
    cfg_p = convert.config_from(cfg_j)
    js = _jstream(cols)
    return cfg_p, js, _jit_replay(cfg_j)(js)


def test_replay_eight_agents_commits_several_closures_a_window(eight):
    """8 agents: a window commits every closure up to the first packet
    whose agent closed earlier in it, so windows are fewer than closures;
    the result is still the scan's."""
    cfg_p, js, (st_j, out_j) = eight
    st_p, out_p, stats = prp.replay_session(_pstream(js), cfg_p, stats=True)
    assert _mismatches(st_p, out_p, st_j, out_j, cfg_p) == []
    assert stats.closures == int(st_j.closure.cl_count) > 0
    assert stats.windows < stats.closures


@pytest.mark.parametrize("window", [8, 64, 4096])
def test_window_size_changes_nothing(eight, window, monkeypatch):
    """Where a closure window ends (its size, or a closure cut) changes no
    result: every size meets the scan's bars."""
    cfg_p, js, (st_j, out_j) = eight
    monkeypatch.setattr(prp, "WINDOW", window)
    st_p, out_p, stats = prp.replay_session(_pstream(js), cfg_p, stats=True)
    assert _mismatches(st_p, out_p, st_j, out_j, cfg_p) == []
    assert stats.windows >= -(-600 // window)


def _fires_loop(t, valid, t0, interval):
    """The cadence as the reference scans it, packet by packet."""
    last, iv, fired = np.float32(t0), np.float32(interval), None
    for i in range(t.shape[0]):
        if valid[i] and (t[i] - last) > iv:
            last, fired = t[i], i
    return fired


@pytest.mark.parametrize("order", ["sorted", "shuffled", "ties", "jitter"])
def test_cadence_jumps_equal_the_packet_loop(order):
    """`_last_fire` (one step per firing) against the per-packet loop, on
    time-ordered, shuffled, tied (quarter-second) and jittered stamps."""
    rng = np.random.default_rng(11)
    for trial in range(200):
        n = int(rng.integers(0, 200))
        t = np.cumsum(rng.uniform(0.0, 0.5, n))
        if order == "shuffled":
            t = rng.permutation(t)
        elif order == "ties":
            t = np.round(t * 4) / 4
        elif order == "jitter":
            t = t + rng.normal(0.0, 1.0, n)
        t = t.astype(np.float32)
        valid = rng.random(n) < 0.8
        t0 = np.float32(rng.uniform(-1.0, 2.0))
        for interval in (0.1, 0.5, 2.0, 3.0):
            assert prp._last_fire(t, valid, t0, interval) == \
                _fires_loop(t, valid, t0, interval), (trial, interval)


def test_replay_out_of_time_order_equals_the_jax_scan(parity):
    """Stamps jittered out of order (a reordered radio link): the cadences,
    heartbeat and closures still match the scan."""
    cols, cfg_j, cfg_p, _, _ = parity
    t = cols[0] + np.random.default_rng(3).normal(0.0, 1.5, len(cols[0]))
    js = _jstream((t.astype(np.float32),) + tuple(cols[1:]))
    assert (np.diff(np.asarray(js.t)) < 0).any()
    st_j, out_j = _jit_replay(cfg_j)(js)
    st_p, out_p = prp.replay_session(_pstream(js), cfg_p)
    assert _mismatches(st_p, out_p, st_j, out_j, cfg_p) == []


def test_mutation_drift_not_fed_forward_fails(parity, monkeypatch):
    _, _, cfg_p, js, (st_j, out_j) = parity
    monkeypatch.setattr(prp, "_drift_of",
                        lambda closure, agent: (torch.zeros(agent.shape),
                                                torch.zeros(agent.shape)))
    st_p, out_p = prp.replay_session(_pstream(js), cfg_p)
    bad = _mismatches(st_p, out_p, st_j, out_j, cfg_p)
    assert "rx" in bad and "hits" in bad


def test_padding_rows_change_nothing(parity):
    cols, _, cfg_p, js, _ = parity
    st_p, _ = prp.replay_session(_pstream(js), cfg_p)
    padded, valid = _padded(cols)
    st2, out2 = prp.replay_session(_pstream(_jstream(padded, valid)), cfg_p)
    for f in ("grid", "pkt_counts", "last_packet_t", "agent_xy",
              "total_writes", "zone_boxes"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      getattr(st_p, f).numpy(), err_msg=f)
    for f in st_p.closure._fields:
        np.testing.assert_array_equal(getattr(st2.closure, f).numpy(),
                                      getattr(st_p.closure, f).numpy(),
                                      err_msg=f)
    assert int(out2.writes[len(cols[0]):].abs().sum()) == 0


def test_ingest_packet_loop_equals_the_closed_form(parity):
    """The per-packet body, looped over the first 160 packets with the
    cadences and frontiers on, against the closed form on them."""
    cols, cfg_j, cfg_p, _, _ = parity
    head = [c[:160] for c in cols]
    js = _jstream(head)
    ps = _pstream(js)
    kw = dict(compute_frontiers=True, enable_targets=True)
    st_c, out_c = prp.replay_session(ps, cfg_p, **kw)
    st = prp.server_init(cfg_p, device="cpu")._replace(
        last_zone_t=ps.t[0].clone(), last_target_t=ps.t[0].clone())
    offsets = torch.zeros(2)
    for i in range(160):
        st, out = prp.ingest_packet(st, prp.PacketStream(*(f[i] for f in ps)),
                                    cfg_p, offsets, **kw)
        assert bool(out.closed) == bool(out_c.closed[i])
        assert float(out.rx) == float(out_c.rx[i])
        assert int(out.writes) == int(out_c.writes[i])
    for f in st._fields:
        a, b = getattr(st, f), getattr(st_c, f)
        for x, y in (zip(a, b) if hasattr(a, "_fields") else [(a, b)]):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=ATOL, err_msg=f)
    # and the JAX scan with the same cadences
    st_j, out_j = _jit_replay(cfg_j, **kw)(js)
    assert _mismatches(st_c, out_c, st_j, out_j, cfg_p) == []
    for f in ("frontier_centroids", "n_frontiers", "targets", "has_target",
              "last_target_t"):
        np.testing.assert_allclose(getattr(st_c, f).numpy(),
                                   np.asarray(getattr(st_j, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    assert int(st_c.n_frontiers) > 0


def _frames(seed, n_frames):
    """[n_frames] frames of 16 packets: every one of 8 agents twice, in a
    shuffled order, wandering the bedroom with landmark revisits. Also
    each frame's [N, 181] sweeps from the true poses."""
    rng = np.random.default_rng(seed)
    n = N_FRAME_AGENTS
    t = 0.0
    frames = []
    ph = rng.uniform(0, 2 * np.pi, n)
    for f in range(n_frames):
        agent = rng.permutation(np.repeat(np.arange(n), 2)).astype(np.int32)
        t = t + np.sort(rng.uniform(0.001, 0.4, FRAME))
        s = f / 3.0 + np.arange(FRAME) * 0.01
        x = 2.5 + 2.0 * np.sin(s + ph[agent]) + rng.normal(0, 0.03, FRAME)
        y = 1.2 * np.sin(2.3 * s + ph[agent]) + rng.normal(0, 0.03, FRAME)
        yaw = rng.uniform(-np.pi, np.pi, FRAME)
        dist = rng.uniform(0.0, 1.6, (FRAME, 4))
        dist[rng.random((FRAME, 4)) < 0.1] = 4.0
        lm = np.where(rng.random(FRAME) < 0.3, rng.integers(1, 4, FRAME),
                      0).astype(np.int32)
        cols = (t.astype(np.float32), agent, x.astype(np.float32),
                y.astype(np.float32), yaw.astype(np.float32),
                dist.astype(np.float32), lm)
        t = float(t[-1])
        last = np.array([np.nonzero(agent == a)[0].max() for a in range(n)])
        pose = torch.from_numpy(np.stack([x[last], y[last], yaw[last]], -1)
                                .astype(np.float32))
        scans = sense_scan_true(pose, torch.from_numpy(BEDROOM_WALLS))
        frames.append((cols, scans.numpy()))
    return frames


FRAME_CASES = {
    "plain": (False, False, False),
    "frontiers-targets": (True, True, False),
    "scanmatch": (False, False, True),
}


@functools.lru_cache(maxsize=None)
def _jit_frame(cfg, compute_frontiers, enable_targets, with_scans):
    def f(st, batch, scans):
        return jrp.ingest_frame(st, batch, cfg, jnp.zeros(cfg.n_agents),
                                enable_targets=enable_targets,
                                compute_frontiers=compute_frontiers,
                                scans=scans if with_scans else None)
    return jax.jit(f)


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_ingest_frame_equals_the_jax_frame(case):
    frontiers, targets, scans_on = FRAME_CASES[case]
    cfg_j = JSwarm(n_agents=N_FRAME_AGENTS)
    if scans_on:
        cfg_j = cfg_j.replace(
            slam=dataclasses.replace(cfg_j.slam, **WIDE),
            engine=dataclasses.replace(cfg_j.engine, scan_rays=181))
    cfg_p = convert.config_from(cfg_j)
    frames = _frames(3, 10)
    st_j = jrp.server_init(cfg_j, t0=float(frames[0][0][0][0]))
    st_p = convert.to_torch(st_j, prp.ServerState, "cpu")
    step = _jit_frame(cfg_j, frontiers, targets, scans_on)
    offsets = torch.zeros(N_FRAME_AGENTS)
    fired = 0
    for cols, scans in frames:
        js = _jstream(cols)
        st_j, out_j = step(st_j, js, jnp.asarray(scans))
        st_p, out_p = prp.ingest_frame(
            st_p, _pstream(js), cfg_p, offsets, enable_targets=targets,
            compute_frontiers=frontiers,
            scans=torch.from_numpy(scans) if scans_on else None)
        np.testing.assert_array_equal(st_p.grid.numpy(),
                                      np.asarray(st_j.grid))
        for f in ("closed", "writes", "online", "hit_valid"):
            np.testing.assert_array_equal(getattr(out_p, f).numpy(),
                                          np.asarray(getattr(out_j, f)),
                                          err_msg=f)
        for f in ("rx", "ry", "hits", "corr"):
            np.testing.assert_allclose(getattr(out_p, f).numpy(),
                                       np.asarray(getattr(out_j, f)),
                                       rtol=0, atol=ATOL, err_msg=f)
        fired += int(out_p.closed.sum())
    ref = jax.tree.map(np.asarray, st_j)
    for f in st_j._fields:
        a, b = getattr(st_p, f), getattr(ref, f)
        pairs = [(getattr(a, g), getattr(b, g), f"{f}.{g}")
                 for g in b._fields] if hasattr(b, "_fields") \
            else [(a, b, f)]
        for x, y, what in pairs:
            if x.dtype.is_floating_point:
                np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=5e-4
                                           if what.startswith("closure.cl_m")
                                           else ATOL, err_msg=what)
            else:
                np.testing.assert_array_equal(x.numpy(), y, err_msg=what)
    assert fired > 0
    if frontiers:
        assert int(st_p.n_frontiers) > 0 and bool(st_p.has_target.any())
    if scans_on:
        assert (st_p.closure.cl_fit.numpy() >= 0).any()


def test_reraster_dual_session_equals_the_jax_package(tmp_path):
    """The dual session refined by the port, re-rastered by both sides."""
    s = jsc.generate_dual_session(seed=42)
    jcsv.write_session(str(tmp_path), s.t, s.agent, s.x, s.y, s.yaw_q,
                       s.encoder, s.v2v, s.dist4, s.landmark)
    session = jcsv.load_session(str(tmp_path))
    cfg_j = JSwarm(n_agents=2)
    cfg_p = convert.config_from(cfg_j)
    refined = pre.refine_session(session, cfg=cfg_p, device="cpu")
    ref, _ = jre.reraster_session(session, refined, cfg_j)
    got, _ = pre.reraster_session(session, refined, cfg_p, device="cpu")
    np.testing.assert_array_equal(got, ref)
    assert (got == cfg_p.grid.occupied).sum() > 100


def test_convert_round_trips_a_server_state(parity):
    _, _, _, _, (st_j, _) = parity
    ref = jax.tree.map(np.asarray, st_j)
    st_p = convert.to_torch(st_j, prp.ServerState, "cpu")
    back = convert.to_numpy_like(st_p, ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    js = _jstream(make_stream(np.random.default_rng(1), 40))
    ps = convert.to_torch(js, prp.PacketStream, "cpu")
    for f in js._fields:
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(js, f)))
