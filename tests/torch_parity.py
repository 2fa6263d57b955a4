"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

The JAX step draws its noise from `jax.random` inside the models; the port
takes the same draws as tensors. These helpers redo the JAX step's key
splits (swarm_tpu/engine/sim.py:820-836, models/sensors.py:37-44,
models/odometry.py:63-74) and return the very normals and uniforms the JAX
step consumes, as the port's `StepNoise`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu_torch.engine.sim import StepNoise
from swarm_tpu_torch.models.odometry import DriftNoise
from swarm_tpu_torch.models.sensors import SensorNoise


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One torch thread for the importing test module, the old count back
    after it: the tier-1 run puts 6 workers on the CPU, and small ops on a
    thread pool each then spin against each other (a 6 s test took 120 s).
    Import it into a test module to use it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x, dtype=None):
    """numpy / JAX array -> CPU torch tensor (copied)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def sensor_noise_from_keys(keys, n_readings: int) -> SensorNoise:
    """The draws `apply_ultrasonic_noise(key, [R] readings)` makes, for a
    batch of per-agent keys [N, 2] -> SensorNoise of [N, R] tensors.
    `uniform(k, shape, lo, hi)` scales the same [0, 1) floats that
    `uniform(k, shape)` returns, so the port gets the unit draws."""
    def one(k):
        k_gauss, k_spur_p, k_spur_v = jax.random.split(k, 3)
        shape = (n_readings,)
        return (jax.random.normal(k_gauss, shape, jnp.float32),
                jax.random.uniform(k_spur_v, shape, jnp.float32),
                jax.random.uniform(k_spur_p, shape))
    g, u, p = jax.vmap(one)(keys)
    return SensorNoise(gauss=t(g), spur_u=t(u), spur_p=t(p))


def drift_noise_from_keys(keys) -> DriftNoise:
    """The three normals `drift_integrate(key, ...)` draws per agent."""
    def one(k):
        k_t, k_r, k_s = jax.random.split(k, 3)
        return (jax.random.normal(k_t, ()), jax.random.normal(k_r, ()),
                jax.random.normal(k_s, ()))
    a, b, c = jax.vmap(one)(keys)
    return DriftNoise(n_t=t(a), n_r=t(b), n_s=t(c))


def step_keys(key, n: int):
    """(next state key, k_sense [N], k_drift [N], k_scan [N]) exactly as
    sim_step splits them."""
    key, k_step = jax.random.split(key)
    ids = jnp.arange(n, dtype=jnp.uint32)
    k_agents = jax.vmap(lambda i: jax.random.fold_in(k_step, i))(ids)
    fold = [jax.vmap(lambda k, j=j: jax.random.fold_in(k, j))(k_agents)
            for j in range(3)]
    return key, fold[0], fold[1], fold[2]


def jax_step_noise(key, n: int, n_rays: int, cfg=None) -> StepNoise:
    """The noise the JAX sim_step draws from state key `key`, as the port's
    StepNoise (cfg is accepted for symmetry; the unit draws need none)."""
    _, k_sense, k_drift, k_scan = step_keys(key, n)
    return StepNoise(
        sense=sensor_noise_from_keys(k_sense, 4),
        scan=sensor_noise_from_keys(k_scan, n_rays),
        drift=drift_noise_from_keys(k_drift))


def jax_deployable(n: int, merge_every: int = 16, room_kernel=False,
                   frontiers=False, scan_rays=181, pack8=True,
                   exact_endpoints=False, grid_dtype="float32",
                   beam_groups=0):
    """The JAX preset the port's presets.deployable mirrors, built as
    bench.py builds it (bench.py:107-128): _cfg_and_world(tiled=True, ...),
    the grid dtype, then bench.py's engine replacements (--beam-groups,
    --no-pack8, --exact-endpoints, the 4-way raster without a sweep, the
    merge only with one)."""
    from __graft_entry__ import _cfg_and_world

    cfg, walls, params, rooms = _cfg_and_world(
        n, frontiers=frontiers, parity=False, raster_mode="beam",
        use_pallas=True, scan_rays=scan_rays, tiled=True,
        room_kernel=room_kernel)
    if grid_dtype != "float32":
        cfg = cfg.replace(grid=dataclasses.replace(
            cfg.grid, logodds_dtype=grid_dtype))
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, beam_groups=beam_groups,
        kernel_endpoints=not exact_endpoints,
        beam_pack8=pack8, raster_4way=scan_rays == 0))
    if merge_every > 0 and scan_rays > 0:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, merge_every=merge_every))
    return cfg, walls, params, rooms


def jax_accuracy(n: int, variant: str, pair_budget: int = 8,
                 distinct: float = 0.0, log_distinct: float = 0.0):
    """tools/bench_accuracy.py's configuration of one variant, built as the
    tool builds it on an accelerator (:259-316: `_cfg_and_world(n,
    frontiers=False, parity=False, raster_mode="beam", use_pallas=True,
    scan_rays=181, tiled=True)`, then the variant's replacements): the JAX
    side of the port's `presets.accuracy`."""
    from __graft_entry__ import _cfg_and_world

    cfg, walls, params, rooms = _cfg_and_world(
        n, frontiers=False, parity=False, raster_mode="beam",
        use_pallas=True, scan_rays=181, tiled=True)
    measured = dict(closure_correction=0.0, min_poses_between=100 * n,
                    closure_scanmatch=True, closure_cross_radius_m=1.2,
                    closure_match_search=28, closure_pair_budget=pair_budget)
    slam, merge_every = {
        "raw": (measured, 0),
        "ref_closures": (dict(closure_correction=0.5), 0),
        "merge_anchored": (dict(measured, merge_distinct_margin=distinct,
                                merge_distinct_log_margin=log_distinct), 16),
        "ref_closures+merge": (dict(closure_correction=0.5), 16),
    }[variant]
    return cfg.replace(
        slam=dataclasses.replace(cfg.slam, **slam),
        engine=dataclasses.replace(cfg.engine,
                                   merge_every=merge_every)), walls, params, \
        rooms


def jax_untiled(n: int, raster_mode: str = "line", scan_rays: int = 181,
                frontiers: bool = False, merge_every: int = 16,
                grid_dtype: str = "float32", parity: bool = False):
    """The JAX preset the port's presets.untiled mirrors: bench.py's
    untiled rows (`--raster line`, `--no-pallas`), built as bench.py
    builds them (bench.py:105-128): _cfg_and_world(tiled=False,
    use_pallas=False, ...), the grid dtype, the merge only with a sweep
    (the beam fields stay at EngineConfig's defaults without Pallas).
    `parity=True` is `_cfg_and_world(n, parity=True)`'s parity mode."""
    from __graft_entry__ import _cfg_and_world

    cfg, walls, params, rooms = _cfg_and_world(
        n, frontiers=frontiers, parity=parity, raster_mode=raster_mode,
        use_pallas=False, scan_rays=scan_rays, tiled=False)
    if grid_dtype != "float32":
        cfg = cfg.replace(grid=dataclasses.replace(
            cfg.grid, logodds_dtype=grid_dtype))
    if merge_every > 0 and scan_rays > 0:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, merge_every=merge_every))
    return cfg, walls, params, rooms


def assert_close(a, b, rtol=1e-5, atol=1e-5, what=""):
    """Port tensor vs JAX array at the stated float tolerance (the XLA CPU
    side contracts a*b + c into an FMA; torch rounds twice)."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


def assert_exact(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=what)


def f32(x) -> np.ndarray:
    """A map (port tensor or JAX array, float32 or bfloat16) as a float32
    numpy array; bf16 values are exact in float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def decision_equal(got, ref, what, painted=None):
    """Maps differ by > 1e-6 in at most 0.01% of the painted cells (the
    reference's nonzero cells unless `painted` is given)."""
    got, ref = f32(got), f32(ref)
    diff = np.abs(got - ref) > 1e-6
    painted = max(int((ref != 0).sum() if painted is None else painted), 1)
    print(f"{what}: {int(diff.sum())} of {painted} painted cells differ")
    assert diff.sum() <= 1e-4 * painted, (what, int(diff.sum()), painted)


def merge_step_parity(room_kernel: bool, n: int = 8, merge_every: int = 4,
                      grid_dtype: str = "float32",
                      exact_endpoints: bool = False, scan_rays: int = 181,
                      slam=None):
    """One step of the deployable preset on a merge step (step 3 at
    merge_every=4), port against JAX from the same state and noise, with
    bench.py's --grid-dtype, --exact-endpoints and --scan-rays as given
    and the SlamConfig fields `slam` replaced on both sides.

    The state at step 3 is made by the port (three CPU steps from the JAX
    initial state, the JAX step's own noise) and handed to both sides; the
    JAX step runs jitted with its Pallas raster in interpret mode. Checks:
    merge decisions and integer metrics exact, floats at atol = rtol =
    1e-5, maps and the anchor decision-equal, writes rtol 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    from swarm_tpu.engine import sim as js
    from swarm_tpu_torch import convert, presets
    from swarm_tpu_torch.engine import sim as ps

    flags = dict(grid_dtype=grid_dtype, exact_endpoints=exact_endpoints,
                 scan_rays=scan_rays)
    cfg_j, walls, params, rooms = jax_deployable(n, merge_every, room_kernel,
                                                 **flags)
    cfg, walls_p, params_p, rooms_p = presets.deployable(
        n, device="cpu", merge_every=merge_every, room_kernel=room_kernel,
        **flags)
    if slam:
        cfg_j = cfg_j.replace(slam=dataclasses.replace(cfg_j.slam, **slam))
        cfg = cfg.replace(slam=dataclasses.replace(cfg.slam, **slam))
    assert convert.config_from(cfg_j) == cfg
    st0 = js.sim_init(cfg_j, params)
    st_p, key = convert.to_torch(st0, ps.SimState), st0.key
    kw = dict(walls_grouped=rooms_p[0], room_of_agent=rooms_p[1])
    for _ in range(merge_every - 1):
        st_p, _ = ps.sim_step(st_p, jax_step_noise(key, n, scan_rays), cfg,
                              walls_p, params_p, **kw)
        key = step_keys(key, n)[0]
    st_j = jax.tree.map(jnp.asarray,
                        convert.to_numpy_like(st_p, st0)._replace(key=key))
    step = js.make_sim_step(cfg_j, jnp.asarray(walls), params, donate=False,
                            walls_grouped=rooms[0], room_of_agent=rooms[1])
    with pltpu.force_tpu_interpret_mode():
        nxt_j, m_j = step(st_j)
    nxt_p, m_p = ps.sim_step(convert.to_torch(st_j, ps.SimState),
                             jax_step_noise(key, n, scan_rays), cfg, walls_p,
                             params_p, **kw)
    assert int(st_p.step) == merge_every - 1 and int(m_j.merges) > 0
    for f in ps.StepMetrics._fields:
        a, b = getattr(m_p, f), getattr(m_j, f)
        if f == "writes":
            np.testing.assert_allclose(int(a), int(b), rtol=1e-5)
        elif a.dtype.is_floating_point:
            assert_close(a, b, what=f"metric {f}")
        else:
            assert_exact(a, b, what=f"metric {f}")
    decision_equal(nxt_p.srv.logodds, nxt_j.srv.logodds, "map")
    decision_equal(nxt_p.srv.anchor, nxt_j.srv.anchor, "anchor")
    assert int((nxt_p.srv.anchor != 0).sum()) > 0
    for f in ("merge_dx", "merge_dy", "merge_dyaw", "merge_yaw_rate",
              "merge_dist_mark"):
        assert_close(getattr(nxt_p.srv, f), getattr(nxt_j.srv, f), what=f)
    if slam and slam.get("merge_bias_alpha", 0.0) > 0.0:
        assert float(np.abs(np.asarray(nxt_j.srv.merge_dist_mark)).max()) > 0
    assert_exact(nxt_p.srv.merge_fail, nxt_j.srv.merge_fail)
    for f in nxt_p.srv.frame._fields:
        assert_close(getattr(nxt_p.srv.frame, f),
                     getattr(nxt_j.srv.frame, f), what=f"frame {f}")
    assert_close(nxt_p.pose_true, nxt_j.pose_true)
    return m_p
