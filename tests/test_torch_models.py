"""The port's per-agent models, coordination, raster helpers, closure ring
and frame tracker against the JAX functions they replace.

Inputs are drawn with numpy from a seed and fed to both sides; noise is
JAX's own draws fed through the port's noise seam. Tolerances: continuous
outputs atol = rtol = 1e-5 (XLA on the CPU contracts a*b + c into an FMA
and its transcendentals differ from torch's in the last bits); integers and
flags exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import (EkfConfig, NavConfig, NoiseConfig,
                              SensorConfig, SlamConfig, SwarmConfig)
from tests.torch_parity import (assert_close, assert_exact,
                                drift_noise_from_keys, jax_deployable,
                                sensor_noise_from_keys, t)
from tests.torch_parity import torch_one_thread  # noqa: F401

N = 16


def _keys(seed, n=N):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def test_wrap_pi(rng):
    from swarm_tpu.utils.angles import wrap_pi as j_wrap
    from swarm_tpu_torch.utils.angles import wrap_pi

    x = rng.uniform(-20, 20, 4096).astype(np.float32)
    x[:4] = [math.pi, -math.pi, 0.0, 3 * math.pi]
    assert_close(wrap_pi(t(x)), j_wrap(jnp.asarray(x)), atol=1e-6)


def _room_walls_and_poses(rng, n=N):
    """Per-agent room walls [N, 4, 4] of the tiled world and poses inside
    the rooms."""
    cfg, walls, params, rooms = jax_deployable(n)
    wg = np.asarray(rooms[0])[np.asarray(rooms[1])]
    lo = wg[..., [0, 1]].reshape(n, -1, 2).min(1)
    hi = wg[..., [0, 1]].reshape(n, -1, 2).max(1)
    xy = lo + rng.uniform(0.1, 0.9, (n, 2)) * (hi - lo)
    yaw = rng.uniform(-np.pi, np.pi, n)
    pose = np.concatenate([xy, yaw[:, None]], 1).astype(np.float32)
    return wg.astype(np.float32), pose


def test_cast_rays_per_agent_walls(rng):
    from swarm_tpu.geom.world import cast_rays as j_cast
    from swarm_tpu.geom.world import ray_segment_t as j_rst
    from swarm_tpu_torch.geom.world import cast_rays, ray_segment_t

    wg, pose = _room_walls_and_poses(rng)
    ang = rng.uniform(-np.pi, np.pi, (N, 7)).astype(np.float32)
    org = np.broadcast_to(pose[:, None, :2], (N, 7, 2)).copy()
    ref = jax.vmap(j_cast)(jnp.asarray(org), jnp.asarray(ang),
                           jnp.asarray(wg))
    got = cast_rays(t(org), t(ang), t(wg)[:, None])
    assert_close(got, ref)
    # one ray against a shared wall set: the [S, 4] form
    d = np.stack([np.cos(ang[0]), np.sin(ang[0])]).astype(np.float32)
    ref_t = j_rst(jnp.asarray(org[0, :, 0]), jnp.asarray(org[0, :, 1]),
                  jnp.asarray(d[0]), jnp.asarray(d[1]), jnp.asarray(wg[0]))
    got_t = ray_segment_t(t(org[0, :, 0]), t(org[0, :, 1]), t(d[0]),
                          t(d[1]), t(wg[0]))
    assert_exact(torch.isinf(got_t), np.isinf(np.asarray(ref_t)))
    fin = np.isfinite(np.asarray(ref_t))
    assert_close(np.asarray(got_t)[fin], np.asarray(ref_t)[fin])


def test_sensors_and_scan_with_jax_noise(rng):
    from swarm_tpu.models.scan import scan_angles as j_angles
    from swarm_tpu.models.scan import sense_scan as j_scan
    from swarm_tpu.models.sensors import sense_4way as j_4way
    from swarm_tpu.models.sensors import sense_true as j_true
    from swarm_tpu_torch.models.scan import scan_angles, sense_scan
    from swarm_tpu_torch.models.sensors import sense_4way, sense_true

    sens = SensorConfig()
    wg, pose = _room_walls_and_poses(rng)
    jw, jp = jnp.asarray(wg), jnp.asarray(pose)
    assert_close(sense_true(t(pose), t(wg), sens),
                 jax.vmap(lambda p, w: j_true(p, w, sens))(jp, jw))

    k4, ks = _keys(1), _keys(2)
    ref4 = jax.vmap(lambda k, p, w: j_4way(k, p, w, sens))(k4, jp, jw)
    got4 = sense_4way(sensor_noise_from_keys(k4, 4), t(pose), t(wg), sens)
    assert_close(got4, ref4)

    for r in (61, 181):
        # XLA contracts start*(1-step) + stop*step into an FMA: ~1 ulp
        assert_close(scan_angles(r), j_angles(r), atol=1e-6, rtol=0)
    refs = jax.vmap(lambda k, p, w: j_scan(k, p, w, 181, sens))(ks, jp, jw)
    gots = sense_scan(sensor_noise_from_keys(ks, 181), t(pose), t(wg), 181,
                      sens)
    assert_close(gots, refs)


def test_landmarks(rng):
    from swarm_tpu.models.landmarks import detect_landmark_sim as j_lm
    from swarm_tpu_torch.models.landmarks import detect_landmark_sim

    f, l, r = rng.uniform(0.0, 1.6, (3, 4096)).astype(np.float32)
    ref = j_lm(jnp.asarray(f), jnp.asarray(l), jnp.asarray(r), 0.30, 1.20)
    got = detect_landmark_sim(t(f), t(l), t(r), 0.30, 1.20)
    assert got.dtype == torch.int32
    assert_exact(got, ref)
    assert len(np.unique(np.asarray(ref))) == 6     # every code exercised


def test_odometry_with_jax_noise(rng):
    from swarm_tpu.models import odometry as jo
    from swarm_tpu_torch.models import odometry as po

    noise = NoiseConfig()
    x0, y0, yaw0 = rng.uniform(-3, 3, (3, N)).astype(np.float32)
    js = jo.odom_init(jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(yaw0))
    ps = po.odom_init(t(x0), t(y0), t(yaw0))
    # moving, turning in place, and still agents
    d_trans = np.where(np.arange(N) % 3 == 0, 0.0,
                       rng.uniform(0, 0.1, N)).astype(np.float32)
    d_rot = np.where(np.arange(N) % 3 == 1, 0.38, 0.0).astype(np.float32)
    scale = rng.choice([0.998, 1.002], N).astype(np.float32)
    bias = rng.choice([-0.008, 0.008], N).astype(np.float32)
    keys = _keys(5)
    js2 = jax.vmap(lambda k, o, d, r, s, b: jo.drift_integrate(
        k, o, d, r, s, b, noise))(keys, js, jnp.asarray(d_trans),
                                  jnp.asarray(d_rot), jnp.asarray(scale),
                                  jnp.asarray(bias))
    ps2 = po.drift_integrate(drift_noise_from_keys(keys), ps, t(d_trans),
                             t(d_rot), t(scale), t(bias), noise)
    for f in ("x_est", "y_est", "yaw_est"):
        assert_close(getattr(ps2, f), getattr(js2, f), what=f)

    js3, jtot = jo.encoder_emit(js2, noise)
    ps3, ptot = po.encoder_emit(ps2, noise)
    # tick counts truncate d / 0.0107: exact unless d lands within 1e-5
    # of a tick boundary (checked: not for this seed)
    assert_exact(ptot, jtot)
    assert_exact(ps3.prev_x_est, np.asarray(ps2.x_est))

    yaw = rng.uniform(-4, 4, 4096).astype(np.float32)
    yaw[:3] = np.radians([7.5, 22.5, -37.5])          # half-way: to even
    assert_close(po.quantize_yaw_deg(t(yaw), 15.0),
                 jo.quantize_yaw_deg(jnp.asarray(yaw), 15.0), atol=1e-4)


def test_ekf_step_batch(rng):
    from swarm_tpu.models import ekf as je
    from swarm_tpu_torch.models import ekf as pe

    cfg = EkfConfig()
    x = rng.normal(0, 1, (N, 6)).astype(np.float32)
    a = rng.normal(0, 0.3, (N, 6, 6)).astype(np.float32)
    P = (a @ a.transpose(0, 2, 1) + np.eye(6)).astype(np.float32)
    last_t = rng.uniform(0, 2, N).astype(np.float32)
    last_t[:3] = 5.0                                  # dt <= 0: no-op rows
    om, v = rng.normal(0, 0.5, (2, N)).astype(np.float32)
    tt = np.full(N, 2.4, np.float32)
    js = je.EkfState(jnp.asarray(x), jnp.asarray(P), jnp.asarray(last_t))
    ps = pe.EkfState(t(x), t(P), t(last_t))
    ref = je.ekf_step_batch(js, jnp.asarray(om), jnp.asarray(v),
                            jnp.asarray(tt), cfg)
    got = pe.ekf_step_batch(ps, t(om), t(v), t(tt), cfg)
    for f in ("x", "P", "last_t"):
        assert_close(getattr(got, f), getattr(ref, f), what=f)
    init = pe.ekf_init(t(x))
    assert_exact(init.P, np.broadcast_to(np.eye(6, dtype=np.float32),
                                         (N, 6, 6)))


def test_nav_step(rng):
    from swarm_tpu.models import nav as jn
    from swarm_tpu_torch.models import nav as pn

    cfg = NavConfig()
    n = 64
    st = rng.integers(0, 6, n).astype(np.int32)
    f32 = np.float32
    fields = dict(
        state=st, corner_elapsed_s=rng.choice([0.0, 0.6, 1.2], n).astype(f32),
        returning_home=rng.random(n) < 0.3, has_target=rng.random(n) < 0.5,
        target_x=rng.uniform(-2, 2, n).astype(f32),
        target_y=rng.uniform(-2, 2, n).astype(f32),
        target_age_s=rng.uniform(0, 12, n).astype(f32),
        mission_complete=rng.random(n) < 0.1)
    prm = dict(wall_side=rng.choice([-1, 1], n).astype(np.int32),
               motor_pwm=rng.choice([190, 205], n).astype(np.int32),
               return_style=rng.integers(0, 3, n).astype(np.int32),
               home_x=rng.uniform(-0.3, 0.3, n).astype(f32),
               home_y=rng.uniform(-0.3, 0.3, n).astype(f32))
    ranges = rng.uniform(0.05, 1.4, (n, 4)).astype(f32)
    pose = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(f32)
    dist = rng.uniform(0, 4, n).astype(f32)
    zb = np.concatenate([rng.uniform(-2, 0, (n, 2)),
                         rng.uniform(0, 2, (n, 2))], 1).astype(f32)
    hz = rng.random(n) < 0.5
    jnav, jcmd = jn.nav_step(
        jn.NavState(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jn.NavParams(**{k: jnp.asarray(v) for k, v in prm.items()}),
        jnp.asarray(ranges), jnp.asarray(pose), jnp.asarray(dist),
        jnp.asarray(zb), jnp.asarray(hz), 0.4, cfg)
    pnav, pcmd = pn.nav_step(
        pn.NavState(**{k: t(v) for k, v in fields.items()}),
        pn.NavParams(**{k: t(v) for k, v in prm.items()}),
        t(ranges), t(pose), t(dist), t(zb), t(hz), 0.4, cfg)
    for f in pn.NavState._fields:
        a, b = getattr(pnav, f), getattr(jnav, f)
        if a.dtype.is_floating_point:
            assert_close(a, b, what=f)
        else:
            assert_exact(a, b, what=f)
    for f in pn.NavCommand._fields:
        assert_close(getattr(pcmd, f), getattr(jcmd, f), what=f)
    assert len(np.unique(np.asarray(jnav.state))) >= 4


def test_heartbeat_and_zones(rng):
    from swarm_tpu.coord import heartbeat as jh
    from swarm_tpu.coord import zones as jz
    from swarm_tpu_torch.coord import heartbeat as ph
    from swarm_tpu_torch.coord import zones as pz

    last = rng.choice([0.0, 1.0, 3.0, 8.0], N).astype(np.float32)
    assert_exact(ph.heartbeat_update(t(last), 8.4, 5.0),
                 jh.heartbeat_update(jnp.asarray(last), 8.4, 5.0))

    jzs, pzs = jz.zone_init(N), pz.zone_init(N)
    for k in range(3):
        xs, ys = rng.uniform(-5, 5, (2, N, 5)).astype(np.float32)
        valid = rng.random((N, 5)) < 0.6
        valid[0] = False                     # one agent never observed
        jzs = jz.zone_observe_rows(jzs, jnp.asarray(xs), jnp.asarray(ys),
                                   jnp.asarray(valid))
        pzs = pz.zone_observe_rows(pzs, t(xs), t(ys), t(valid))
    for f in pz.ZoneState._fields:
        assert_exact(getattr(pzs, f), getattr(jzs, f), what=f)
    xy = rng.uniform(-5, 5, (N, 2)).astype(np.float32)
    online = rng.random(N) < 0.8
    jb, ja = jz.zones_for_agents(jzs, jnp.asarray(xy), jnp.asarray(online))
    pb, pa = pz.zones_for_agents(pzs, t(xy), t(online))
    assert_exact(pa, ja)
    assert_exact(pb, jb)


def test_beam_helpers(rng):
    from swarm_tpu.ops import beam_raster as jb
    from swarm_tpu_torch.ops import beam_raster as pb

    for n in (4, 61, 181):
        js = jb.BeamSpec.scan(n) if n > 4 else jb.BeamSpec.four_way()
        ps = pb.BeamSpec.scan(n) if n > 4 else pb.BeamSpec.four_way()
        assert dataclasses.astuple(js) == dataclasses.astuple(ps)
    cfg = SwarmConfig()
    assert pb.reach_cells(cfg) == jb.reach_cells(cfg) == 26
    for size in (200, 256, 512, 4096):
        for reach in (10, 26):
            assert pb.patch_dims(size, reach) == jb.patch_dims(size, reach)
    x = rng.uniform(-2, 40, 4096).astype(np.float32)
    assert_exact(pb.quantize_ranges_cells8(t(x)),
                 jb.quantize_ranges_cells8(jnp.asarray(x)))
    d = rng.uniform(0.0, 1.6, (N, 181)).astype(np.float32)
    for p_fn, j_fn in ((pb.beams_from_scan, jb.beams_from_scan),
                       (pb.beams_from_4way, jb.beams_from_4way)):
        pr, pt = p_fn(t(d), 1.2, 0.05)
        jr, jt = j_fn(jnp.asarray(d), 1.2, 0.05)
        assert_exact(pr, jr)
        assert_exact(pt, jt)


def _closure_inputs(rng, n, step):
    """Poses clustered on a few spots so revisits fire, landmarks often."""
    spots = np.array([[0.0, 0.0], [1.0, 0.5], [-1.0, 2.0]], np.float32)
    xy = spots[rng.integers(0, 3, n)] + rng.normal(0, 0.2, (n, 2))
    lm = rng.choice([0, 1, 2, 3], n, p=[0.3, 0.3, 0.2, 0.2])
    # dead agents only in the last batch: the reference's invalid rows
    # overwrite agent 0's guard (ROADMAP Queue C7), which would make the
    # two sides' later closure decisions diverge by design
    valid = rng.random(n) < (0.7 if step == 23 else 1.1)
    return (xy[:, 0].astype(np.float32), xy[:, 1].astype(np.float32),
            lm.astype(np.int32), valid)


@pytest.mark.parametrize("same_agent,corr", [(True, 0.0), (False, 0.5)])
def test_closure_ring(rng, same_agent, corr):
    from swarm_tpu.slam import closure as jc
    from swarm_tpu_torch.slam import closure as pc

    cfg = SlamConfig(closure_same_agent_only=same_agent,
                     closure_correction=corr, min_poses_between=8,
                     landmark_capacity=64)
    n = 8
    js = jc.closure_init(n, cfg, closure_capacity=32)
    ps = pc.closure_init(n, cfg, closure_capacity=32)
    for f in pc.ClosureState._fields:
        assert_exact(getattr(ps, f), getattr(js, f), what=f)
    agents = np.arange(n, dtype=np.int32)
    fired = 0
    for step in range(24):
        xs, ys, lm, valid = _closure_inputs(rng, n, step)
        yaws = rng.uniform(-3, 3, n).astype(np.float32)
        js, jcl, jdx, jdy = jc.closure_add_poses_batch(
            js, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(agents),
            jnp.asarray(lm), cfg, valid=jnp.asarray(valid),
            yaws=jnp.asarray(yaws))
        ps, pcl, pdx, pdy = pc.closure_add_poses_batch(
            ps, t(xs), t(ys), t(agents), t(lm), cfg, valid=t(valid),
            yaws=t(yaws))
        assert_exact(pcl, jcl, what=f"closed at {step}")
        assert_close(pdx, jdx)
        assert_close(pdy, jdy)
        fired += int(np.asarray(jcl).sum())
        for f in pc.ClosureState._fields:
            a, b = getattr(ps, f), getattr(js, f)
            if f in ("last_closure_node",) and not valid.all():
                # ROADMAP Queue C7: the reference scatters invalid rows onto
                # agent 0 with its OLD value; the port leaves them out
                b = np.asarray(b).copy()
                b[0] = np.asarray(a)[0]
            if a.dtype.is_floating_point:
                assert_close(a, b, what=f)
            else:
                assert_exact(a, b, what=f)
    assert fired > 0                  # the ring wrapped and closures fired


def test_frame_tracker(rng):
    from swarm_tpu.slam import livemerge as jl
    from swarm_tpu_torch.slam import livemerge as pl

    cfg = SwarmConfig(slam=SlamConfig(merge_frame_gain=0.35))
    px, py = rng.uniform(0, 20, (2, N)).astype(np.float32)
    assert_exact(pl.frame_init(N, t(px), t(py)).px,
                 jl.frame_init(N, jnp.asarray(px), jnp.asarray(py)).px)
    vals = {f: rng.normal(0, 0.05, N).astype(np.float32)
            for f in jl.FrameState._fields}
    vals["px"], vals["py"] = px, py
    jf = jl.FrameState(**{k: jnp.asarray(v) for k, v in vals.items()})
    pf = pl.FrameState(**{k: t(v) for k, v in vals.items()})
    raw_x = px + rng.normal(0, 0.05, N).astype(np.float32)
    raw_y = py + rng.normal(0, 0.05, N).astype(np.float32)
    raw_x[0] += 3.0                                  # teleport guard
    alive = rng.random(N) < 0.9
    jax_out = jl.frame_advance(jf, jnp.asarray(raw_x), jnp.asarray(raw_y),
                               jnp.asarray(alive), cfg)
    got = pl.frame_advance(pf, t(raw_x), t(raw_y), t(alive), cfg)
    assert_close(got[0], jax_out[0])
    assert_close(got[1], jax_out[1])
    for f in pl.FrameState._fields:
        assert_close(getattr(got[2], f), getattr(jax_out[2], f), what=f)
    added = pl.frame_add(pf, got[2])
    ref_added = jl.frame_add(jf, jax_out[2])
    for f in pl.FrameState._fields:
        assert_close(getattr(added, f), getattr(ref_added, f), what=f)
    th = rng.uniform(-1, 1, 256).astype(np.float32)
    assert_close(pl.frame_theta_q(t(th), cfg),
                 jl.frame_theta_q(jnp.asarray(th), cfg), atol=1e-6)
