"""The port's anchored scan merge (slam/scanmatch.py, slam/livemerge.py,
parallel/sharded.py) against the JAX package, on the CPU.

Inputs come from a seed with numpy: a synthetic room map (walls and two
boxes as occupancy mass) and agents whose reported pose carries an injected
2-4 cell translation and 0.05-0.1 rad rotation error; their scans are cast
from the true pose. The JAX matcher is vmapped per agent (as
livemerge.scan_merge does); the port's is batched.

Tolerances:
- decisions (`ok`, the chosen hypothesis, `distinct`, attempted/recovered
  sets, fail counts) are equal;
- continuous outputs (corrections, fitness, peak gap, frame-tracker
  deltas) at atol = rtol = 1e-5. The rotation hypotheses come from
  `jnp.linspace`, which XLA computes with an FMA, one ulp away from the
  port's two roundings (ROADMAP C9); the chosen theta and its refinement
  stay inside 1e-5, so no test loosens it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import SwarmConfig as JSwarmConfig
from swarm_tpu.parallel import sharded as jsh
from swarm_tpu.slam import livemerge as jl
from swarm_tpu.slam import scanmatch as jm
from swarm_tpu_torch import convert
from swarm_tpu_torch.geom.world import cast_rays, make_rect_room
from swarm_tpu_torch.parallel import sharded as psh
from swarm_tpu_torch.slam import livemerge as pl
from swarm_tpu_torch.slam import scanmatch as pm
from tests.torch_parity import assert_close, assert_exact, jax_deployable, t

RES = 0.05
INNER, SEARCH = 64, 8
SIDE = INNER + 2 * SEARCH
S = 96                                    # synthetic map side (4.8 m)
MAX_RANGE = 1.5                           # matching range (m)
WALLS = np.concatenate([make_rect_room(1.0, 1.0, 3.6, 3.0),
                        make_rect_room(1.3, 2.4, 1.7, 2.7)])
REL = np.linspace(-np.pi / 2, np.pi / 2, 181)


def _mass_map():
    mass = np.zeros((S, S), np.float32)
    for x0, y0, x1, y1 in WALLS:
        u = np.linspace(0.0, 1.0, 2000)
        x, y = x0 + u * (x1 - x0), y0 + u * (y1 - y0)
        mass[(y / RES).astype(int), (x / RES).astype(int)] = 1.0
    return mass


def _agents(rng, n):
    """True poses in the room, the injected reported-pose errors, and the
    scans cast from the true poses (offsets from the REPORTED position)."""
    true = np.stack([rng.uniform(2.0, 2.6, n), rng.uniform(1.7, 2.2, n),
                     rng.uniform(-np.pi, np.pi, n)], -1)
    mag = rng.uniform(2.0, 4.0, n) * RES
    ang = rng.uniform(-np.pi, np.pi, n)
    err = np.stack([mag * np.cos(ang), mag * np.sin(ang),
                    rng.choice([-1, 1], n) * rng.uniform(0.05, 0.1, n)], -1)
    rep = true + err
    dirs = true[:, 2:3] + REL[None, :]
    r = cast_rays(t(np.repeat(true[:, None, :2], len(REL), 1)).float(),
                  t(dirs).float(), t(WALLS)).numpy()
    valid = (r > 0.05) & (r <= MAX_RANGE)
    return true, rep, r.astype(np.float32), valid, err


def _windows(mass, rep):
    gx, gy = rep[:, 0] / RES, rep[:, 1] / RES
    sx = np.clip(np.floor(gx).astype(int) - SIDE // 2, 0, S - SIDE)
    sy = np.clip(np.floor(gy).astype(int) - SIDE // 2, 0, S - SIDE)
    win = np.stack([mass[a:a + SIDE, b:b + SIDE] for a, b in zip(sy, sx)])
    ax = (gx - sx - SEARCH - 0.5).astype(np.float32)
    ay = (gy - sy - SEARCH - 0.5).astype(np.float32)
    return win, ax, ay


def _assert_match(got: pm.WindowMatch, ref, what=""):
    for f in pm.WindowMatch._fields:
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        if a.dtype == torch.bool:
            assert_exact(a, b, what=f"{what} {f}")
        else:
            assert_close(a, b, what=f"{what} {f}")


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("margin", [0.0, 0.05])
def test_match_scan_window_injected_offsets(rng, wide, margin):
    """The normal pass (11 rotations over +-0.2 rad) and the recovery
    pass's rotation search (33 over +-0.6 rad), each with the
    distinctness test on and off."""
    n = 6
    mass = _mass_map()
    true, rep, r, valid, err = _agents(rng, n)
    ang = rep[:, 2:3] + REL[None, :]
    off_x = np.where(valid, r * np.cos(ang), 0.0).astype(np.float32)
    off_y = np.where(valid, r * np.sin(ang), 0.0).astype(np.float32)
    win, ax, ay = _windows(mass, rep)
    kw = dict(n_theta=33 if wide else 11, theta_range=0.6 if wide else 0.2,
              resolution=RES, inlier_radius_cells=2, fitness_min=0.6,
              min_points=16, prior_weight=0.15, theta_prior_scale=0.3,
              distinct_margin=margin, distinct_radius=3)

    ref = jax.jit(jax.vmap(lambda a, b, v, w, x, y: jm.match_scan_window(
        a, b, v, w, (x, y), INNER, SEARCH, **kw)))(
        jnp.asarray(off_x), jnp.asarray(off_y), jnp.asarray(valid),
        jnp.asarray(win), jnp.asarray(ax), jnp.asarray(ay))
    got = pm.match_scan_window(t(off_x), t(off_y), t(valid), t(win),
                               (t(ax), t(ay)), INNER, SEARCH, **kw)
    _assert_match(got, ref, f"wide {wide} margin {margin}")
    # the matches verify and point back toward the truth
    assert bool(got.ok.all())
    assert np.all(np.abs(got.ddx.numpy() + err[:, 0]) < 0.12)
    assert np.all(np.abs(got.ddy.numpy() + err[:, 1]) < 0.12)
    if margin == 0.0:
        assert bool(got.distinct.all())
        assert bool(torch.isinf(got.distinct_gap).all())


def test_scores_conv_equals_im2col(rng):
    """The grouped-conv translation scoring against the JAX im2col form
    (bmm over unfolded patches) on sparse splats: the same sums in another
    order, atol = rtol = 1e-5."""
    rot = rng.random((3, 5, 16, 16)) * (rng.random((3, 5, 16, 16)) < 0.2)
    dil = rng.random((3, 24, 24))
    got = pm._scores(t(rot.astype(np.float32)), t(dil.astype(np.float32)))
    ref = pm._scores_im2col(t(rot.astype(np.float32)),
                            t(dil.astype(np.float32)))
    assert tuple(got.shape) == (3, 5, 9, 9)
    assert_close(got, ref)
    assert_close(got[1, 2, 4, 3], (rot[1, 2] * dil[1, 4:20, 3:19]).sum())


def _map_cfg(**slam):
    """A JAX config on the synthetic map (1.5 m matching range) and the
    port's copy of it, through convert.config_from."""
    cfg = JSwarmConfig(n_agents=8)
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, size=S, origin_x=0.0,
                                 origin_y=0.0),
        sensors=dataclasses.replace(cfg.sensors, max_range=MAX_RANGE),
        slam=dataclasses.replace(cfg.slam, **slam))
    return cfg, convert.config_from(cfg)


def _merge_inputs(rng, n, cfg):
    logodds = _mass_map() * (2.0 * cfg.grid.logodds_hit)
    true, rep, r, valid, err = _agents(rng, n)
    alive = np.ones(n, bool)
    alive[-1] = False
    return logodds.astype(np.float32), rep.astype(np.float32), r, alive


def test_scan_merge_and_chunks(rng):
    """scan_merge on the full map, then scan_merge_chunked at
    merge_chunk=4 over 8 agents: events 0 and 1 attempt the two halves."""
    cfg_j, cfg_p = _map_cfg(merge_chunk=4)
    logodds, rep, r, alive = _merge_inputs(rng, 8, cfg_j)
    ref = jax.jit(jl.scan_merge, static_argnums=6)(
        jnp.asarray(logodds), *(jnp.asarray(x) for x in (
            rep[:, 0], rep[:, 1], rep[:, 2], r, alive)), cfg_j)
    got = pl.scan_merge(t(logodds), t(rep[:, 0]), t(rep[:, 1]),
                        t(rep[:, 2]), t(r), t(alive), cfg_p)
    _assert_match(got, ref, "scan_merge")
    assert int(got.ok.sum()) >= 6 and not bool(got.ok[-1])
    # (jitted: the JAX matcher's 289 window slices are slow op by op)
    chunked = jax.jit(jl.scan_merge_chunked, static_argnums=6,
                      static_argnames=("n_global",))
    for event in (0, 1, 2):
        ref = chunked(
            jnp.asarray(logodds), *(jnp.asarray(x) for x in (
                rep[:, 0], rep[:, 1], rep[:, 2], r, alive)), cfg_j,
            event=event, n_global=8)
        got = pl.scan_merge_chunked(
            t(logodds), t(rep[:, 0]), t(rep[:, 1]), t(rep[:, 2]), t(r),
            t(alive), cfg_p, event=event, n_global=8)
        _assert_match(got, ref, f"chunk event {event}")
        half = slice(0, 4) if event % 2 == 0 else slice(4, 8)
        other = slice(4, 8) if event % 2 == 0 else slice(0, 4)
        assert not bool(got.ok[other].any())
        assert bool(got.ok[half][:3].all())
        jc = jl.chunk_attempt(cfg_j, event, 8, 8)
        pc = pl.chunk_attempt(cfg_p, event, 8, 8)
        assert pc[0] == bool(jc[0]) and pc[1] == int(jc[1])
        assert pc[2] == jc[2]
        assert_exact(pc[3], jc[3])


def test_scan_merge_recover(rng):
    """merge_recover_after=1: agents with a failure on record whose normal
    match is rejected (a 0.35 rad error, outside the +-0.2 rad normal
    capture) get the wide pass; attempted, recovered and the adopted
    matches equal the reference's."""
    cfg_j, cfg_p = _map_cfg(merge_recover_after=1, merge_chunk=0)
    logodds, rep, r, alive = _merge_inputs(rng, 8, cfg_j)
    rep = rep.copy()
    rep[:4, 2] += np.float32(0.35)
    fail = np.array([1, 1, 0, 2, 0, 1, 0, 1], np.int32)
    args = [rep[:, 0], rep[:, 1], rep[:, 2], r, alive]
    ref = jax.jit(jl.scan_merge_recover, static_argnums=6,
                  static_argnames=("event", "n_global"))(
        jnp.asarray(logodds), *(jnp.asarray(x) for x in args), cfg_j,
        event=3, n_global=8, fail_count=jnp.asarray(fail))
    got = pl.scan_merge_recover(t(logodds), *(t(x) for x in args), cfg_p,
                                event=3, n_global=8, fail_count=t(fail))
    _assert_match(got[0], ref[0], "recover")
    assert_exact(got[1], ref[1], what="attempted")
    assert_exact(got[2], ref[2], what="recovered")
    assert bool(got[2].any()), "no agent took the wide pass"


def _random_match(rng, n):
    return dict(ddx=rng.normal(0, 0.12, n), ddy=rng.normal(0, 0.12, n),
                ddtheta=rng.normal(0, 0.06, n),
                fitness=rng.uniform(0.5, 1.0, n), ok=rng.random(n) < 0.7,
                ddtheta_meas=rng.normal(0, 0.05, n),
                distinct=rng.random(n) < 0.8,
                distinct_gap=rng.uniform(0.0, 0.2, n))


def _pair(d, cls_j, cls_p):
    def cast(v):
        return v.astype(np.float32) if v.dtype == np.float64 else v
    return (cls_j(**{k: jnp.asarray(cast(v)) for k, v in d.items()}),
            cls_p(**{k: t(cast(v)) for k, v in d.items()}))


@pytest.mark.parametrize("recover_after", [0, 1])
def test_fail_update_increments_and_frame_innovate(rng, recover_after):
    n = 64
    cfg_j = jax_deployable(8, merge_every=4)[0]
    cfg_j = cfg_j.replace(slam=dataclasses.replace(
        cfg_j.slam, merge_recover_after=recover_after,
        merge_frame_turn_starve=2, merge_distinct_margin=0.05))
    cfg_p = convert.config_from(cfg_j)
    mj, mp = _pair(_random_match(rng, n), jm.WindowMatch, pm.WindowMatch)
    alive = rng.random(n) < 0.9
    att = rng.random(n) < 0.6
    rec = rng.random(n) < 0.2
    fail = rng.integers(0, 4, n).astype(np.int32)
    upd = np.asarray(mj.ok) & alive

    assert_exact(pl.merge_fail_update(t(fail), mp, t(att), t(rec), t(alive),
                                      cfg_p),
                 jl.merge_fail_update(jnp.asarray(fail), mj,
                                      jnp.asarray(att), jnp.asarray(rec),
                                      jnp.asarray(alive), cfg_j))
    inc_p = pl.merge_increments(mp, t(upd), t(rec), cfg_p)
    inc_j = jl.merge_increments(mj, jnp.asarray(upd), jnp.asarray(rec),
                                cfg_j)
    for a, b in zip(inc_p, inc_j):
        assert_close(a, b)

    fs = {f: rng.normal(0, 0.5, n).astype(np.float32)
          for f in jl.FrameState._fields}
    fs["dacc"] = rng.uniform(0.0, 4.5, n).astype(np.float32)
    fs["gskip"] = rng.integers(0, 4, n).astype(np.float32)
    fj, fp = _pair(fs, jl.FrameState, pl.FrameState)
    gate_yaw = fs["qy"] + rng.choice([0.0, 0.005, 0.3], n).astype(np.float32)
    dj = jl.frame_innovate(fj, jnp.asarray(gate_yaw), mj, jnp.asarray(upd),
                           inc_j[3], inc_j[4], cfg_j,
                           recovered=jnp.asarray(rec))
    dp = pl.frame_innovate(fp, t(gate_yaw), mp, t(upd), inc_p[3], inc_p[4],
                           cfg_p, recovered=t(rec))
    for f in pl.FrameState._fields:
        assert_close(getattr(dp, f), getattr(dj, f), what=f)
    assert float(dp.theta.abs().sum()) > 0        # some windows fired


def test_merge_window_box_exact():
    cfg, walls, params, rooms = jax_deployable(32, merge_every=16)
    cfg_p = convert.config_from(cfg)
    for j, p in zip(jsh.merge_window_box(rooms[0], rooms[1], cfg),
                    psh.merge_window_box(np.asarray(rooms[0]),
                                         np.asarray(rooms[1]), cfg_p)):
        assert_exact(p, j)
    for j, p in zip(jsh.agent_evidence_box(rooms[0], rooms[1], cfg),
                    psh.agent_evidence_box(np.asarray(rooms[0]),
                                           np.asarray(rooms[1]), cfg_p)):
        assert_exact(p, j)
    assert pl.merge_window_side(cfg_p) == jl.merge_window_side(cfg) == SIDE


def test_merge_bias_against_jax(rng):
    """merge_bias_ff and merge_bias_update (the yaw-rate bias, A1) against
    the JAX functions on random inputs: distances on both sides of
    merge_bias_min_dist and merge_bias_ff_max_m, rotations past the level
    cap, events verified or not. Equal at atol = rtol = 1e-6."""
    n = 64
    cfg_j = JSwarmConfig()
    cfg_j = cfg_j.replace(slam=dataclasses.replace(cfg_j.slam,
                                                   merge_bias_alpha=0.1))
    cfg = convert.config_from(cfg_j)
    rate = rng.uniform(-0.03, 0.03, n).astype(np.float32)
    mark = rng.uniform(0.0, 5.0, n).astype(np.float32)
    total = (mark + rng.choice([0.0, 0.1, 0.3, 2.0, 6.0], n)).astype(
        np.float32)
    dth = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    qres = rng.uniform(-0.13, 0.13, n).astype(np.float32)
    upd = rng.uniform(size=n) > 0.4
    ff_j = jl.merge_bias_ff(jnp.asarray(rate), jnp.asarray(mark),
                            jnp.asarray(total), cfg_j)
    assert_close(pl.merge_bias_ff(t(rate), t(mark), t(total), cfg), ff_j,
                 rtol=1e-6, atol=1e-6)
    assert np.abs(np.asarray(ff_j)).max() > 0
    m_j = jm.WindowMatch(*[jnp.zeros((n,))] * len(jm.WindowMatch._fields))
    m_j = m_j._replace(ddtheta_meas=jnp.asarray(dth))
    m_p = pm.WindowMatch(*[torch.zeros((n,))] * len(pm.WindowMatch._fields))
    m_p = m_p._replace(ddtheta_meas=t(dth))
    for q in (None, qres):
        ref = jl.merge_bias_update(
            jnp.asarray(rate), jnp.asarray(mark), jnp.asarray(total), m_j,
            jnp.asarray(upd), cfg_j,
            quant_resid=None if q is None else jnp.asarray(q))
        got = pl.merge_bias_update(t(rate), t(mark), t(total), m_p, t(upd),
                                   cfg, quant_resid=None if q is None
                                   else t(q))
        for a, b, what in zip(got, ref, ("fold", "rate", "mark")):
            assert_close(a, b, rtol=1e-6, atol=1e-6, what=what)
            assert np.abs(np.asarray(b)).max() > 0, what
    off = convert.config_from(JSwarmConfig())
    assert not bool(pl.merge_bias_ff(t(rate), t(mark), t(total), off).any())
    assert all(not bool(x.any()) for x in pl.merge_bias_update(
        t(rate), t(mark), t(total), m_p, t(upd), off))


def test_merge_step_parity_with_the_bias():
    """One merge step of the deployable preset with the yaw-rate bias on
    (merge_bias_alpha=0.1), port against JAX (torch_parity
    `merge_step_parity`) at step 7 of merge_every=8, where agents have
    travelled merge_bias_min_dist and the rate rebases: the bias state,
    maps and corrections agree."""
    from tests.torch_parity import merge_step_parity

    merge_step_parity(room_kernel=False, merge_every=8,
                      slam=dict(merge_bias_alpha=0.1))
