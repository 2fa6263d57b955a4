"""The fault-injection path and frames that lack agents, the port against
the JAX package on the CPU.

The reference's failure injection (swarm_tpu/engine/sim.py:108-127: the
scripted stuck-bot fault and the heartbeat failover of SURVEY §5): an
agent inside a `FaultSchedule` window is dead. It stops moving, paints
nothing and sends no closure row; once its last packet is older than the
heartbeat timeout (5 s, 13 steps of 0.4 s) it is OFFLINE and its zone is
lifted; when the window ends it comes back. A serving frame that lacks an
agent is the same case on the mapping server (`engine/replay.ingest_frame`,
and through it `server/live`).

1. Two of the port's three former departures from the reference, each
   against the JAX function (each test fails on a port that keeps the
   departure):
   - C7: `closure_add_poses_batch` over 40 batches of 4 agents at one
     landmark, agent 3 absent from every other batch. The reference's
     invalid row sets agent 0's old guard back over its closure, so agent
     0 closes again sooner; every state leaf and agent 0's closure count
     equal the JAX package's.
   - C34: `ingest_frame` on frames that lack agents and carry padding
     rows, against the jitted JAX frame: the per-row outputs (an absent
     agent's False on row 0, the last in agent order winning) and the
     state.
   - C11 (the room raster's rooms off the tile grid) is held in
     tests/test_torch_room_raster.py.
2. The kill schedule (tests/torch_parity.py `KILLS`: agent 0 and agent 3
   dead past the timeout, across the merge step 15, staggered so that
   agent 0 is alive while agent 3 is dead) through `sim_rollout` for
   FAULT_STEPS steps at 8 agents, against the JAX package's `sim_rollout`
   on the same schedule and the same noise (the JAX step's own draws
   through the port's seam): the window path (`presets.deployable`, the
   pack8-ring window kernel's plain version) and the room path
   (`room_kernel=True`, pack16-ring). The exploration path under the same
   schedule is in tests/test_torch_explore.py, the sharded step in
   tests/test_torch_faults_sharded.py.
3. The live server in throughput mode on frames that lack agents: the JAX
   server pads each frame to its budget with invalid rows, the port's takes
   the real rows; the states equal after every frame.

Bars (ROADMAP's North star): online counts, closures, merges and every
integer exact; maps decision-equal (cells differing by > 1e-6 in at most
0.01% of the painted cells); writes rtol 1e-5 (the running total);
poses and other floats atol = rtol = 1e-5. The JAX Pallas rasters run in
interpret mode (`torch_parity.pallas_interpret`), each JAX rollout
compiled once for the module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import SlamConfig as JSlam
from swarm_tpu.config import SwarmConfig as JSwarm
from swarm_tpu.engine import replay as jrp
from swarm_tpu.slam import closure as jc
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.engine import replay as prp
from swarm_tpu_torch.slam import closure as pc
from tests.torch_parity import (assert_close, assert_exact,
                                assert_failover, assert_metrics_equal,
                                assert_state_equal,
                                jax_deployable, jax_fault_rollout,
                                port_fault_rollout, t)

N = 8


# --------------------------------------------------------------------------
# 1. the three repairs


def test_c7_closure_guard_follows_the_reference_scatter():
    """4 agents at one landmark, min_poses_between 8, 40 batches, agent 3
    absent from every other batch: each batch's decisions and every state
    leaf equal the JAX package's, and agent 0 fires as many closures."""
    cfg = JSlam(min_poses_between=8, landmark_capacity=64)
    cfg_p = convert.config_from(JSwarm(slam=cfg)).slam
    n = 4
    st_j = jc.closure_init(n, cfg, closure_capacity=64)
    st_p = convert.to_torch(st_j, pc.ClosureState)
    agents = np.arange(n, dtype=np.int32)
    xs = np.zeros(n, np.float32)
    lm = np.ones(n, np.int32)
    batch = jax.jit(lambda st, v: jc.closure_add_poses_batch(
        st, jnp.asarray(xs), jnp.asarray(xs), jnp.asarray(agents),
        jnp.asarray(lm), cfg, valid=v))
    fired_j = fired_p = 0
    for k in range(40):
        valid = np.array([True, True, True, k % 2 == 0])
        st_j, cj, dxj, dyj = batch(st_j, jnp.asarray(valid))
        st_p, cp, dxp, dyp = pc.closure_add_poses_batch(
            st_p, t(xs), t(xs), t(agents), t(lm), cfg_p, valid=t(valid))
        assert_exact(cp, cj, what=f"batch {k} closed")
        assert_close(dxp, dxj)
        assert_close(dyp, dyj)
        for f in pc.ClosureState._fields:
            assert_exact(getattr(st_p, f), getattr(st_j, f),
                         what=f"batch {k} {f}")
        fired_j += int(np.asarray(cj)[0])
        fired_p += int(cp[0])
    print(f"agent 0 closures: JAX {fired_j}, port {fired_p}")
    assert fired_p == fired_j > 0


N_FRAME = 8
FRAME_PAD = 20          # the JAX live server's frame budget


def _partial_frames(seed, n_frames):
    """Frames of the 8 agents in which 1-3 agents are absent and the rest
    send one or two packets, agent 0's first; each padded to FRAME_PAD
    rows with invalid rows of agent 0, as the JAX live server pads. Agents
    walk around three landmark spots, so closures fire. Returns
    [(cols, valid)]."""
    rng = np.random.default_rng(seed)
    spots = np.array([[1.0, 0.5], [3.5, 1.0], [2.0, 2.5]], np.float32)
    frames, tt = [], 1.0
    for _ in range(n_frames):
        absent = rng.choice(np.arange(1, N_FRAME), rng.integers(1, 4),
                            replace=False)
        present = [a for a in range(N_FRAME) if a not in absent]
        agent = np.array(present + list(rng.choice(present, 3)), np.int32)
        agent[1:] = rng.permutation(agent[1:])
        agent = np.concatenate([[0], agent[agent != 0]]) \
            if 0 in present else agent
        b = len(agent)
        tt += 0.2
        ts = np.full(b, tt, np.float32) + np.arange(b, dtype=np.float32) \
            * np.float32(1e-3)
        xy = spots[rng.integers(0, 3, b)] + rng.normal(0, 0.1, (b, 2))
        yaw = rng.uniform(-np.pi, np.pi, b)
        dist = rng.uniform(0.2, 1.5, (b, 4))
        lm = np.where(rng.random(b) < 0.6, 1 + rng.integers(0, 2, b), 0)
        cols = [ts, agent, xy[:, 0], xy[:, 1], yaw, dist, lm]
        cols = [np.concatenate([np.asarray(c, d), np.zeros(
            (FRAME_PAD - b,) + np.shape(c)[1:], d)]) for c, d in zip(
            cols, (np.float32, np.int32, np.float32, np.float32,
                   np.float32, np.float32, np.int32))]
        valid = np.arange(FRAME_PAD) < b
        frames.append((cols, valid))
    return frames


def _jframe(cols, valid):
    ts, agent, x, y, yaw, dist, lm = cols
    n = len(ts)
    return jrp.PacketStream(
        t=jnp.asarray(ts), agent=jnp.asarray(agent), x=jnp.asarray(x),
        y=jnp.asarray(y), yaw=jnp.asarray(yaw),
        encoder=jnp.zeros(n, jnp.int32), v2v=jnp.zeros(n, jnp.int32),
        dist=jnp.asarray(dist), landmark=jnp.asarray(lm),
        valid=jnp.asarray(valid))


def _frame_cfg():
    """8 agents, closures after 8 poses (so they fire within a few
    frames), the frame's landmarks at two types."""
    cfg_j = JSwarm(n_agents=N_FRAME)
    return cfg_j.replace(slam=dataclasses.replace(
        cfg_j.slam, min_poses_between=8))


def _assert_server_states_equal(st_p, st_j, what):
    ref = jax.tree.map(np.asarray, st_j)
    for f in ref._fields:
        a, b = getattr(st_p, f), getattr(ref, f)
        pairs = [(getattr(a, g), getattr(b, g), f"{f}.{g}")
                 for g in b._fields] if hasattr(b, "_fields") \
            else [(a, b, f)]
        for x, y, name in pairs:
            if x.dtype.is_floating_point:
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=f"{what} {name}")
            else:
                np.testing.assert_array_equal(x.numpy(), y,
                                              err_msg=f"{what} {name}")


def test_c34_ingest_frame_on_frames_that_lack_agents():
    """Frames lacking 1-3 agents and padded with invalid rows, through
    the jitted JAX `ingest_frame` and the port's: per-row outputs and the
    state equal after every frame; on some frame an absent agent's False
    overwrote row 0's closure, as the reference scatters it."""
    cfg_j = _frame_cfg()
    cfg_p = convert.config_from(cfg_j)
    frames = _partial_frames(11, 16)
    st_j = jrp.server_init(cfg_j, t0=1.0)
    st_p = convert.to_torch(st_j, prp.ServerState, "cpu")
    step = jax.jit(lambda s, b: jrp.ingest_frame(
        s, b, cfg_j, jnp.zeros(N_FRAME)))
    offsets = torch.zeros(N_FRAME)
    fired = row0_dropped = 0
    for k, (cols, valid) in enumerate(frames):
        jb_ = _jframe(cols, valid)
        pbatch = prp.PacketStream(*(torch.from_numpy(np.array(f))
                                    for f in jb_))
        before = st_p
        st_j, out_j = step(st_j, jb_)
        st_p, out_p = prp.ingest_frame(st_p, pbatch, cfg_p, offsets)
        for f in ("closed", "writes", "online", "hit_valid"):
            assert_exact(getattr(out_p, f), getattr(out_j, f),
                         what=f"frame {k} {f}")
        for f in ("rx", "ry", "hits", "corr"):
            assert_close(getattr(out_p, f), getattr(out_j, f),
                         what=f"frame {k} {f}")
        _assert_server_states_equal(st_p, st_j, f"frame {k}")
        fired += int(out_p.closed.sum())
        # row 0 is agent 0's only packet; did agent 0 close there and an
        # absent agent's False win the row?
        ag = cols[1][valid]
        if (ag == 0).sum() == 1:
            n_cl = int(st_p.closure.cl_count - before.closure.cl_count)
            log = st_p.closure.cl_agent[
                (int(before.closure.cl_count) + torch.arange(n_cl)) %
                st_p.closure.cl_agent.shape[0]]
            if bool((log == 0).any()) and not bool(out_p.closed[0]):
                row0_dropped += 1
    print(f"closures {fired}, row-0 closures overwritten {row0_dropped}")
    assert fired > 0 and row0_dropped > 0


# --------------------------------------------------------------------------
# 2. the kill schedule through the fused engines


WORLDS = {
    # (port preset, JAX preset), the deployable preset at N agents
    "window": (lambda: presets.deployable(N, device="cpu"),
               lambda: jax_deployable(N)),
    "room": (lambda: presets.deployable(N, device="cpu", room_kernel=True),
             lambda: jax_deployable(N, room_kernel=True)),
}


@functools.lru_cache(maxsize=None)
def _jax_rollout(case):
    return jax_fault_rollout(WORLDS[case][1]())


@pytest.mark.parametrize("case", list(WORLDS))
def test_kill_schedule_rollout_matches_jax(monkeypatch, case):
    jax_run = _jax_rollout(case)
    final, ms = port_fault_rollout(monkeypatch, jax_run, WORLDS[case][0]())
    final_j, ms_j = jax_run[2:]
    assert_metrics_equal(ms, ms_j, case)
    assert_failover(ms, N)
    assert int(ms.merges[15]) > 0
    assert_state_equal(final, final_j, case)


# --------------------------------------------------------------------------
# 3. the live server on frames that lack agents


def test_live_server_on_frames_that_lack_agents():
    """The JAX `LiveServer` (frames padded to its budget with invalid
    rows) and the port's (the real rows) in throughput mode, fed the same
    partial frames at the same clock: the states equal after each."""
    from swarm_tpu.server.live import LiveServer as JServer
    from swarm_tpu_torch.server.live import LiveServer

    cfg_j = _frame_cfg()
    jsrv = JServer(cfg_j, port=0, ingest_mode="throughput",
                   native_codec=False)
    psrv = LiveServer(convert.config_from(cfg_j), port=0,
                      ingest_mode="throughput", native_codec=False,
                      device="cpu")
    try:
        assert jsrv._batch_size == FRAME_PAD
        fired = 0
        for k, (cols, valid) in enumerate(_partial_frames(5, 12)):
            b = int(valid.sum())
            ts, agent, x, y, yaw, dist, lm = (c[:b] for c in cols)
            cc = {"x": x, "y": y, "yaw": yaw,
                  "encoder": np.zeros(b, np.int32),
                  "v2v": np.zeros(b, np.int32), "dist4": dist,
                  "landmark": lm}
            jsrv.now = psrv.now = (lambda v=float(ts[-1]): v)
            jsrv.ingest_columns(agent, cc)
            psrv.ingest_columns(agent, cc)
            _assert_server_states_equal(psrv.state, jsrv.state,
                                        f"frame {k}")
        fired = int(psrv.state.closure.cl_count)
        assert fired > 0
        assert int(psrv.state.pkt_counts.sum()) == psrv.pkt_total
    finally:
        jsrv.close()
        psrv.close()
