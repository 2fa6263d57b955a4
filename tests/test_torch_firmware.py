"""The firmware-faithful per-robot API of the port against the JAX
package's, on the CPU: the single-robot EKF (`ekf_predict`, `ekf_update`,
`ekf_pose`, `ekf_quaternion_z_w`, `ekf_init`), the firmware's dead
reckoning, landmark classifier, velocity-command receiver and three-ping
sensing, room-culled ray casting, the one-packet closure check and the
constants the reference names.

Inputs are made from a numpy seed; the sensing noise is drawn in JAX with
the reference's own key splits and handed to the port (the port takes its
noise as an input). Bars: the EKF at atol = rtol = 1e-5 (a 50-step chain
also against the port's native oracle at tests/test_native_oracle.py's
bars), the dt <= 0 guard exact; odometry 1e-6; codes, PWM and closure
decisions exact; sensing and casting 1e-5 with the sentinel and RAY_MISS
exact; the closure state's integers exact and its floats 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu import config as jcfg
from swarm_tpu.geom import world as jworld
from swarm_tpu.models import ekf as jekf
from swarm_tpu.models import landmarks as jlm
from swarm_tpu.models import nav as jnav
from swarm_tpu.models import odometry as jodo
from swarm_tpu.models import scan as jscan
from swarm_tpu.models import sensors as jsens
from swarm_tpu.ops import beam_raster as jbeam
from swarm_tpu.slam import closure as jcl
from swarm_tpu.slam import scanmatch as jsm
from swarm_tpu_torch import config as pcfg
from swarm_tpu_torch import native as pnat
from swarm_tpu_torch.geom import world as pworld
from swarm_tpu_torch.models import ekf as pekf
from swarm_tpu_torch.models import landmarks as plm
from swarm_tpu_torch.models import nav as pnav
from swarm_tpu_torch.models import odometry as podo
from swarm_tpu_torch.models import scan as pscan
from swarm_tpu_torch.models import sensors as psens
from swarm_tpu_torch.ops import beam_raster as pbeam
from swarm_tpu_torch.slam import closure as pcl
from swarm_tpu_torch.slam import scanmatch as psm
from tests.torch_parity import assert_close, assert_exact, t
from tests.torch_parity import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _jit(fn, vmap=False, **kw):
    f = functools.partial(fn, **kw)
    return jax.jit(jax.vmap(f) if vmap else f)


def _ekf_state(rng, lead=()):
    """A random filter state: mean, SPD covariance, last time."""
    x = rng.normal(size=lead + (6,)).astype(np.float32)
    a = rng.normal(size=lead + (6, 6)).astype(np.float32)
    P = (np.einsum("...ij,...kj->...ik", a, a) / 6
         + np.eye(6, dtype=np.float32)).astype(np.float32)
    last_t = rng.uniform(0.0, 1.0, size=lead).astype(np.float32)
    return x, P, last_t


def _close_state(got, ref, what, atol=1e-5):
    for f, a, b in zip(pekf.EkfState._fields, got, ref):
        assert_close(a, b, atol=atol, rtol=atol, what=f"{what} {f}")


# --- the per-robot EKF -----------------------------------------------------

@pytest.mark.parametrize("case", ["one", "eight", "chain", "dt-guard",
                                  "init"])
def test_ekf(case):
    cfg_j, cfg_p = jcfg.EkfConfig(), pcfg.EkfConfig()
    rng = np.random.default_rng(11)
    if case in ("one", "eight"):
        lead = () if case == "one" else (8,)
        x, P, last_t = _ekf_state(rng, lead)
        omega = rng.normal(size=lead).astype(np.float32)
        v = rng.uniform(0, 0.3, size=lead).astype(np.float32)
        tt = (last_t + rng.uniform(0.05, 0.2, size=lead)).astype(np.float32)
        vm = case == "eight"
        sj = jekf.EkfState(jnp.asarray(x), jnp.asarray(P), jnp.asarray(last_t))
        sp = pekf.EkfState(t(x), t(P), t(last_t))
        pj = _jit(jekf.ekf_predict, vmap=vm, cfg=cfg_j)(sj, omega, tt)
        pp = pekf.ekf_predict(sp, t(omega), t(tt), cfg_p)
        _close_state(pp, pj, "predict")
        uj = _jit(jekf.ekf_update, vmap=vm, cfg=cfg_j)(pj, v, omega)
        up = pekf.ekf_update(pp, t(v), t(omega), cfg_p)
        _close_state(up, uj, "update")
        for a, b in zip(pekf.ekf_pose(up), _jit(jekf.ekf_pose, vmap=vm)(uj)):
            assert_close(a, b, what="pose")
        for a, b in zip(pekf.ekf_quaternion_z_w(up),
                        _jit(jekf.ekf_quaternion_z_w, vmap=vm)(uj)):
            assert_close(a, b, what="quaternion")
    elif case == "chain":
        # tests/test_native_oracle.py:20-40's 50 steps, one robot
        oracle = pnat.EkfOracle(cfg_p.q_diag, cfg_p.r_odom_diag)
        sj, sp = jekf.ekf_init(), pekf.ekf_init(device=CPU)
        tm = 0.0
        for _ in range(50):
            tm += float(rng.uniform(0.05, 0.2))
            omega = float(rng.normal(0, 0.5))
            v = float(rng.uniform(0, 0.3))
            oracle.predict(omega, tm)
            oracle.update(v, omega)
            sj = _jit(jekf.ekf_update, cfg=cfg_j)(
                _jit(jekf.ekf_predict, cfg=cfg_j)(sj, omega, tm), v, omega)
            sp = pekf.ekf_update(pekf.ekf_predict(sp, omega, tm, cfg_p), v,
                                 omega, cfg_p)
        _close_state(sp, sj, "chain vs JAX", atol=1e-4)
        np.testing.assert_allclose(sp.x.numpy(), oracle.x, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(sp.P.numpy(), oracle.P, rtol=1e-3,
                                   atol=1e-5)
    elif case == "dt-guard":
        x, P, last_t = _ekf_state(rng, (8,))
        sp = pekf.EkfState(t(x), t(P), t(last_t))
        tt = last_t.copy()
        tt[::2] -= 0.25                          # dt < 0
        out = pekf.ekf_predict(sp, t(np.ones(8, np.float32)), t(tt), cfg_p)
        for f in pekf.EkfState._fields:          # dt == 0 and dt < 0: exact
            assert_exact(getattr(out, f), getattr(sp, f), f)
        sj = jekf.EkfState(jnp.asarray(x), jnp.asarray(P),
                           jnp.asarray(last_t))
        out_j = _jit(jekf.ekf_predict, vmap=True, cfg=cfg_j)(
            sj, np.ones(8, np.float32), tt)
        for f in pekf.EkfState._fields:
            assert_exact(getattr(out, f), getattr(out_j, f), f)
    else:
        one = pekf.ekf_init(device=CPU)
        ref = jekf.ekf_init()
        for f in pekf.EkfState._fields:
            assert_exact(getattr(one, f), getattr(ref, f), f)
        x0 = rng.normal(size=6).astype(np.float32)
        got, ref = pekf.ekf_init(t(x0), 0.5), jekf.ekf_init(x0, 0.5)
        for f in pekf.EkfState._fields:
            assert_exact(getattr(got, f), getattr(ref, f), f)
        batch = pekf.ekf_init(torch.zeros((5, 6)))
        assert batch.P.shape == (5, 6, 6) and batch.last_t.shape == (5,)
        assert batch.x.device == CPU


# --- odometry, landmarks, the command receiver, constants ------------------

_FW_RANGES = np.sort(np.concatenate([
    np.array([0.05, 0.2, 0.6, 1.0, 3.9], np.float32),
    *[np.array([np.nextafter(np.float32(c), np.float32(-1)), np.float32(c),
                np.nextafter(np.float32(c), np.float32(9))], np.float32)
      for c in (0.4, 0.8)]]))


@pytest.mark.parametrize("case", ["odometry", "landmark-fw", "cmd-vel",
                                  "constants", "occupancy-mass"])
def test_firmware_model(case):
    rng = np.random.default_rng(5)
    if case == "odometry":
        n = 256
        x, y = (rng.normal(size=n).astype(np.float32) for _ in range(2))
        yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        counts = rng.integers(-40, 400, n).astype(np.int32)
        counts[:3] = (-1, 0, 1)
        ref = jodo.firmware_odometry_step(x, y, yaw, counts)
        got = podo.firmware_odometry_step(t(x), t(y), t(yaw), t(counts))
        for a, b, w in zip(got, ref, ("x", "y", "m")):
            assert_close(a, b, rtol=1e-6, atol=1e-6, what=w)
        assert_exact(got[2][counts <= 0], np.zeros((counts <= 0).sum()))
    elif case == "landmark-fw":
        f, l, r = (a.reshape(-1) for a in np.meshgrid(
            _FW_RANGES, _FW_RANGES, _FW_RANGES, indexing="ij"))
        ref = jlm.detect_landmark_fw(f, l, r)
        got = plm.detect_landmark_fw(t(f), t(l), t(r))
        assert got.dtype == torch.int32
        assert_exact(got, ref, "codes")
        assert set(np.unique(np.asarray(ref))) == set(range(6))
    elif case == "cmd-vel":
        lin = rng.uniform(-1.0, 1.0, 200).astype(np.float32)
        ang = rng.uniform(-3.0, 3.0, 200).astype(np.float32)
        age = rng.uniform(0.0, 1.0, 200).astype(np.float32)
        lin[:4], ang[:4] = (1.0, -1.0, 0.2, -0.0123), (0.0, 0.0, 4.0, 0.0)
        age[:8] = (0.0, 0.5, 0.5, 0.1, np.nextafter(np.float32(0.5), 1),
                   0.5, 0.49, 0.51)
        ref = jscan.cmd_vel_drive(lin, ang, age)
        got = pscan.cmd_vel_drive(t(lin), t(ang), t(age))
        for a, b in zip(got, ref):
            assert a.dtype == torch.int32
            assert_exact(a, b, "pwm")
        left = np.asarray(ref[0])
        assert left[0] == 255 and left[1] == -255 and left[3] == -6
        assert (np.abs(left) == 255).sum() > 4
        assert np.asarray(ref[0])[4] == 0 != int(lin[4] * 510)  # > 0.5 s
    elif case == "constants":
        assert plm.LANDMARK_NAMES == jlm.LANDMARK_NAMES
        assert pnav.NAV_STATE_NAMES == jnav.NAV_STATE_NAMES
        assert pscan.SCAN_FOV == jscan.SCAN_FOV
        assert (pbeam.PATCH_ROWS, pbeam.PATCH_COLS) == \
            (jbeam.PATCH_ROWS, jbeam.PATCH_COLS)
    else:
        tri = rng.choice(np.array([-1, 0, 100], np.int8), size=(64, 64))
        assert_exact(psm.occupancy_mass(t(tri)), jsm.occupancy_mass(tri))


# --- sensing: the three-ping median, room-culled casting -------------------

def _jax_noise(k, shape):
    """The draws `apply_ultrasonic_noise(k, [shape] readings)` makes."""
    k_gauss, k_spur_p, k_spur_v = jax.random.split(k, 3)
    return psens.SensorNoise(
        gauss=t(jax.random.normal(k_gauss, shape, jnp.float32)),
        spur_u=t(jax.random.uniform(k_spur_v, shape, jnp.float32)),
        spur_p=t(jax.random.uniform(k_spur_p, shape)))


def _multi_room(n_rooms, n, rng):
    """Closed rooms side by side, n agents inside them: walls [S, 4],
    grouped walls [G, 4, 4], each agent's room and pose [n, 3]."""
    walls = jworld.make_multi_room(n_rooms, per_row=2)
    room = rng.integers(0, n_rooms, n).astype(np.int32)
    lo = walls.reshape(n_rooms, 4, 4)[:, :, :2].min(1)
    pose = np.stack([lo[room, 0] + rng.uniform(0.3, 5.7, n),
                     lo[room, 1] + rng.uniform(0.3, 3.7, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    return walls, jworld.walls_by_group(walls), room, pose


@pytest.mark.parametrize("case", ["median3", "median3-stacked",
                                  "grouped-cast"])
def test_sensing(case):
    rng = np.random.default_rng(9)
    walls, grouped, room, pose = _multi_room(4, 96, rng)
    if case.startswith("median3"):
        key = jax.random.PRNGKey(3)
        ref = np.asarray(_jit(jsens.sense_4way_median3)(key, pose, walls))
        pings = [_jax_noise(k, (96, 4)) for k in jax.random.split(key, 3)]
        noise = pings if case == "median3" else psens.SensorNoise(
            *(torch.stack(leaf) for leaf in zip(*pings)))
        got = psens.sense_4way_median3(noise, t(pose), t(walls))
        assert_close(got, ref, what="median3")
        sentinel = ref == jcfg.SensorConfig().timeout_sentinel
        assert 0 < sentinel.sum() < sentinel.size
        assert_exact(got.numpy()[sentinel], ref[sentinel], "sentinel")
        drawn = psens.draw_median3_noise(torch.Generator().manual_seed(0),
                                         (96, 4), CPU)
        assert drawn.gauss.shape == (3, 96, 4)
    else:
        n_rays = 16
        angles = rng.uniform(-np.pi, np.pi, (96, n_rays)).astype(np.float32)
        origins = np.broadcast_to(pose[:, None, :2], (96, n_rays, 2)).copy()
        group = np.broadcast_to(room[:, None], (96, n_rays)).copy()
        # a few rays start outside their room and look away from it: misses
        origins[:4, 0] = (-50.0, -50.0)
        angles[:4, 0] = np.float32(np.pi + np.pi / 4)
        ref = np.asarray(_jit(jworld.cast_rays_grouped)(
            origins, angles, grouped, group))
        got = pworld.cast_rays_grouped(t(origins), t(angles), t(grouped),
                                       t(group))
        assert_close(got, ref, what="grouped cast")
        miss = ref == jworld.RAY_MISS
        assert miss[:4, 0].all()
        assert_exact(got.numpy()[miss], ref[miss], "RAY_MISS")
        # rooms are closed: culling changes no reading inside them
        every = pworld.cast_rays(t(origins), t(angles), t(walls))
        assert torch.equal(got[4:], every[4:])


# --- the one-packet closure check ------------------------------------------

_CLOSURE_CASES = {
    "reference": {},
    "same-agent-only": dict(closure_same_agent_only=True),
    "scanmatch": dict(closure_scanmatch=True),
}
N_PACKETS = 200
N_AGENTS = 4
SCAN_RAYS = 5


def _packets(seed):
    """N_PACKETS packets that revisit a few landmark spots: positions,
    agents, landmark types, validity, yaws and scans (numpy)."""
    rng = np.random.default_rng(seed)
    spots = rng.uniform(-3, 3, (6, 2)).astype(np.float32)
    pick = rng.integers(0, 6, N_PACKETS)
    xy = (spots[pick] + rng.normal(0, 0.25, (N_PACKETS, 2))).astype(
        np.float32)
    lm = np.where(rng.random(N_PACKETS) < 0.6, 1 + pick % 5, 0).astype(
        np.int32)
    agent = rng.integers(0, N_AGENTS, N_PACKETS).astype(np.int32)
    valid = rng.random(N_PACKETS) > 0.1
    yaw = rng.uniform(-np.pi, np.pi, N_PACKETS).astype(np.float32)
    scan = rng.uniform(0.1, 2.0, (N_PACKETS, SCAN_RAYS)).astype(np.float32)
    return xy, agent, lm, valid, yaw, scan


def _slam(kind, pkg):
    kw = dict(landmark_capacity=48, **_CLOSURE_CASES[kind])
    return dataclasses.replace(pkg.SlamConfig(), **kw)


@pytest.mark.parametrize("kind", list(_CLOSURE_CASES))
def test_closure_add_pose(kind):
    cfg_j, cfg_p = _slam(kind, jcfg), _slam(kind, pcfg)
    scans = kind == "scanmatch"
    xy, agent, lm, valid, yaw, scan = _packets(4)
    kw = dict(closure_capacity=24, scan_rays=SCAN_RAYS if scans else 0)
    sj = jcl.closure_init(N_AGENTS, cfg_j, **kw)
    sp = pcl.closure_init(N_AGENTS, cfg_p, device=CPU, **kw)
    step = _jit(jcl.closure_add_pose, cfg=cfg_j)
    n_closed = 0
    for k in range(N_PACKETS):
        extra_j = dict(yaw=yaw[k], scan=scan[k]) if scans else {}
        extra_p = dict(yaw=t(yaw[k]), scan=t(scan[k])) if scans else {}
        sj, cj, dxj, dyj = step(sj, xy[k, 0], xy[k, 1], agent[k], lm[k],
                                valid=valid[k], **extra_j)
        sp, cp, dxp, dyp = pcl.closure_add_pose(
            sp, t(xy[k, 0]), t(xy[k, 1]), int(agent[k]), int(lm[k]), cfg_p,
            valid=bool(valid[k]), **extra_p)
        assert bool(cp) == bool(cj), f"packet {k}"
        assert_close(dxp, dxj, rtol=0, atol=1e-6, what=f"cdx {k}")
        assert_close(dyp, dyj, rtol=0, atol=1e-6, what=f"cdy {k}")
        n_closed += bool(cj)
    assert n_closed >= 5
    assert int(sp.lm_count) > 48 and int(sp.cl_count) > 0   # rings wrap
    for f in pcl.ClosureState._fields:
        a, b = getattr(sp, f), np.asarray(getattr(sj, f))
        if a.dtype.is_floating_point:
            assert_close(a, b, rtol=0, atol=1e-6, what=f)
        else:
            assert_exact(a, b, f)
    if scans:
        assert float(sp.lm_scan.abs().sum()) > 0
        assert float(sp.lm_yaw.abs().sum()) > 0


def test_closure_add_pose_equals_the_sequential_form():
    """Packets of distinct agents through `closure_add_pose` one by one and
    through `closure_add_poses_seq` as batches: every field, closed, cdx
    and cdy equal."""
    cfg = dataclasses.replace(pcfg.SlamConfig(), landmark_capacity=48)
    xy, _, lm, valid, _, _ = _packets(6)
    agent = np.tile(np.arange(N_AGENTS, dtype=np.int32),
                    N_PACKETS // N_AGENTS)
    s1 = pcl.closure_init(N_AGENTS, cfg, closure_capacity=24, device=CPU)
    s2 = s1
    for a in range(0, N_PACKETS, N_AGENTS):
        sl = slice(a, a + N_AGENTS)
        s2, closed, cdx, cdy = pcl.closure_add_poses_seq(
            s2, t(xy[sl, 0]), t(xy[sl, 1]), t(agent[sl]), t(lm[sl]), cfg,
            t(valid[sl]))
        for k in range(a, a + N_AGENTS):
            s1, c, dx, dy = pcl.closure_add_pose(
                s1, t(xy[k, 0]), t(xy[k, 1]), int(agent[k]), int(lm[k]),
                cfg, valid=bool(valid[k]))
            assert bool(c) == bool(closed[k - a])
            assert float(dx) == float(cdx[k - a])
            assert float(dy) == float(cdy[k - a])
    for f in pcl.ClosureState._fields:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    assert int(s1.cl_count) > 0
