"""The port's fused step (engine/sim.py) against the JAX engine on the
deployable preset at 8 agents: merge off (`merge_every=0`) for 1. and 2.,
and one merge step on the window-kernel path for 3.

The JAX step runs jitted with its Pallas raster under
`torch_parity.pallas_interpret()`; the port runs its plain raster on the
CPU.
Both start from the same state (converted through numpy) and consume the
same noise (the JAX step's own draws, fed through the port's seam).

1. One-step parity, 4 consecutive steps: StepMetrics integers exact,
   floats at atol = rtol = 1e-5, maps decision-equal (cells differing by
   more than 1e-6 at most 0.01% of painted cells).
2. A free-running 8-step rollout on each side: tri-state maps agree on
   >= 99% of explored cells, total writes within 1%, `online` equal.
3. A merge step (step 3 at merge_every=4), tests/torch_parity.py
   `merge_step_parity`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.engine import sim as js
from swarm_tpu.ops.raster import tri_state_view
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.ops.raster import tri_state_view as p_tri_state_view
from swarm_tpu_torch.ops.v2v_cuda import v2v_stats
from tests.torch_parity import (assert_close, assert_exact, decision_equal,
                                jax_deployable, jax_step_noise,
                                merge_step_parity, pallas_interpret, step_keys)

N = 8
R = 181


@pytest.fixture(scope="module")
def world():
    cfg, walls, params, rooms = jax_deployable(N, merge_every=0)
    step = js.make_sim_step(cfg, jnp.asarray(walls), params, donate=False,
                            walls_grouped=rooms[0], room_of_agent=rooms[1])
    port = dict(walls=torch.from_numpy(np.array(walls)),
                params=convert.to_torch(params, ps.AgentParams),
                rooms=(torch.from_numpy(np.array(rooms[0])),
                       torch.from_numpy(np.array(rooms[1]))))
    return cfg, params, step, port


def test_preset_is_the_reference_preset(world):
    cfg, params, _, port = world
    cfg_p, walls_p, params_p, rooms_p = presets.deployable(
        N, device="cpu", merge_every=0)
    assert cfg_p == convert.config_from(cfg)
    assert walls_p.device.type == "cpu"
    for room_kernel in (False, True):
        assert presets.deployable(N, device="cpu", room_kernel=room_kernel
                                  )[0] == convert.config_from(jax_deployable(
                                      N, room_kernel=room_kernel)[0])
    assert_exact(walls_p, port["walls"])
    for f in ps.AgentParams._fields:
        assert_exact(getattr(params_p, f), getattr(params, f), what=f)
    assert_exact(rooms_p[0], port["rooms"][0])
    assert_exact(rooms_p[1], port["rooms"][1])
    # the 1024-agent shapes the chip run drives (no grid is allocated)
    cfg_k, walls_k, params_k, rooms_k = presets.deployable(1024, device="cpu")
    assert cfg_k.grid.size == 4096 and cfg_k.engine.merge_every == 16
    assert cfg_k.engine.room_tile_per_row == 0
    assert presets.deployable(1024, device="cpu", room_kernel=True)[
        0].engine.room_tile_per_row == 16
    assert tuple(walls_k.shape) == (2048, 4)
    assert tuple(rooms_k[0].shape) == (512, 4, 4)


def test_convert_round_trip(world):
    cfg, params, _, _ = world
    st = js.sim_init(cfg, params)
    back = convert.to_numpy_like(convert.to_torch(st, ps.SimState), st)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st)):
        assert_exact(a, b)


def _port_step(st_j, cfg, port):
    st_p = convert.to_torch(st_j, ps.SimState)
    noise = jax_step_noise(st_j.key, N, R)
    return ps.sim_step(st_p, noise, cfg, port["walls"], port["params"],
                       walls_grouped=port["rooms"][0],
                       room_of_agent=port["rooms"][1])


def test_one_step_parity(world):
    cfg, params, step, port = world
    st_j = js.sim_init(cfg, params)
    with pallas_interpret():
        for k in range(4):
            nxt_p, m_p = _port_step(st_j, cfg, port)
            st_j, m_j = step(st_j)
            for f in ps.StepMetrics._fields:
                a, b = getattr(m_p, f), getattr(m_j, f)
                if a.dtype.is_floating_point:
                    assert_close(a, b, what=f"step {k} {f}")
                else:
                    assert_exact(a, b, what=f"step {k} {f}")
            assert int(m_p.writes) > 0
            decision_equal(nxt_p.srv.logodds, st_j.srv.logodds,
                            f"step {k} map")
            assert_close(nxt_p.pose_true, st_j.pose_true)
            assert_exact(nxt_p.nav.state, st_j.nav.state)
            assert_close(nxt_p.ekf.P, st_j.ekf.P)
            assert_exact(nxt_p.srv.total_writes, st_j.srv.total_writes)
    assert int(m_j.online) == N


def test_free_running_rollout(world):
    cfg, params, step, port = world
    st_j = js.sim_init(cfg, params)
    st_p = convert.to_torch(st_j, ps.SimState)
    key = st_j.key
    w_j, w_p = [], []
    with pallas_interpret():
        for _ in range(8):
            st_p, m_p = ps.sim_step(st_p, jax_step_noise(key, N, R), cfg,
                                    port["walls"], port["params"],
                                    walls_grouped=port["rooms"][0],
                                    room_of_agent=port["rooms"][1])
            key = step_keys(key, N)[0]
            st_j, m_j = step(st_j)
            assert int(m_p.online) == int(m_j.online)
            w_j.append(int(m_j.writes))
            w_p.append(int(m_p.writes))
    assert_exact(np.asarray(key), np.asarray(st_j.key))
    tri_j = np.asarray(tri_state_view(st_j.srv.logodds, cfg.grid))
    tri_p = p_tri_state_view(st_p.srv.logodds, cfg.grid).numpy()
    # the port's view, on the JAX map, is the JAX view
    assert_exact(p_tri_state_view(torch.from_numpy(
        np.array(st_j.srv.logodds)), cfg.grid), tri_j)
    explored = (tri_j != cfg.grid.unknown) | (tri_p != cfg.grid.unknown)
    agree = ((tri_j == tri_p) & explored).sum() / max(explored.sum(), 1)
    print(f"tri-state agreement {agree:.5f} over {int(explored.sum())} "
          f"explored cells; writes {sum(w_p)} vs {sum(w_j)}")
    assert agree >= 0.99
    assert abs(sum(w_p) - sum(w_j)) <= 0.01 * sum(w_j)
    assert int(m_p.online) == N


def test_unported_paths_refuse(world):
    cfg, params, _, port = world
    cfg = convert.config_from(cfg)

    def with_(eng=None, slam=None, grid=None):
        return cfg.replace(
            engine=dataclasses.replace(cfg.engine, **(eng or {})),
            slam=dataclasses.replace(cfg.slam, **(slam or {})),
            grid=dataclasses.replace(cfg.grid, **(grid or {})))

    # the scan-matched closures (A5) run now: the closure ring is sized
    # for the sweeps, as the reference sizes it
    st = ps.sim_init(with_({}, dict(closure_scanmatch=True)), port["params"])
    assert tuple(st.srv.closure.lm_scan.shape) == (
        cfg.slam.landmark_capacity, cfg.engine.scan_rays)
    assert tuple(ps.sim_init(cfg, port["params"]).srv.closure.lm_scan.shape
                 ) == (cfg.slam.landmark_capacity, 1)
    # the merge matches sweeps: refused without one
    with pytest.raises(ValueError, match="scan_rays"):
        ps.check_supported(with_(dict(merge_every=16, scan_rays=0)))
    # a bf16 grid with the room kernel, the parity path or a non-beam
    # raster: the reference's sim_init refuses these, and so does the port
    bf16 = dict(logodds_dtype="bfloat16")
    for eng in (dict(room_tile_per_row=1), dict(parity_mode=True),
                dict(raster_mode="line")):
        with pytest.raises(ValueError, match="bfloat16"):
            ps.sim_init(with_(eng, grid=bf16), port["params"])
    jcfg, jparams = world[0], world[1]
    with pytest.raises(ValueError, match="bfloat16"):
        js.sim_init(jcfg.replace(
            engine=dataclasses.replace(jcfg.engine, room_tile_per_row=1),
            grid=dataclasses.replace(jcfg.grid, **bf16)), jparams)
    # these run: the merge, the room kernel (pack16, whatever beam_pack8
    # says) with and without its ring and on the wrapped 4-way fan, the
    # wrapped fan (with and without a sweep), frontiers, the window table
    # in all four forms (pack8 / pack16, with / without the ring), the
    # grouped tier on both kernels (bench.py --beam-groups), a bf16 grid on
    # the window kernel, and the coverage tool's configuration
    for eng, grid in (
            (dict(beam_groups=8), {}),
            (dict(beam_groups=8, room_tile_per_row=1), {}),
            (dict(beam_groups=2, raster_4way=True, scan_rays=0,
                  merge_every=0), bf16),
            (dict(merge_every=16), {}), (dict(room_tile_per_row=1), {}),
            (dict(room_tile_per_row=1, beam_pack8=False), {}),
            (dict(room_tile_per_row=1, kernel_endpoints=False), {}),
            (dict(room_tile_per_row=1, raster_4way=True), {}),
            (dict(room_tile_per_row=1, raster_4way=True, scan_rays=0,
                  merge_every=0, kernel_endpoints=False), {}),
            (dict(raster_4way=True), {}), (dict(compute_frontiers=True), {}),
            (dict(raster_4way=True, scan_rays=0, merge_every=0), {}),
            (dict(beam_pack8=False), {}), (dict(kernel_endpoints=False), {}),
            (dict(beam_pack8=False, kernel_endpoints=False), {}),
            (dict(beam_pack8=False, kernel_endpoints=False,
                  raster_4way=True, compute_frontiers=True,
                  merge_every=0), {}),
            ({}, bf16), (dict(kernel_endpoints=False), bf16),
            (dict(raster_4way=True, scan_rays=0, merge_every=0), bf16),
            # every raster mode of the fused engine: the parity path, the
            # line raster, the profiling mode, the XLA beam tier (f32 and
            # bf16), and the yaw-rate bias
            (dict(parity_mode=True), {}), (dict(raster_mode="line"), {}),
            (dict(raster_mode="off"), {}), (dict(use_pallas=False), {}),
            (dict(use_pallas=False), bf16)):
        ps.check_supported(with_(eng, grid=grid))
    ps.sim_init(with_(dict(merge_every=16), dict(merge_bias_alpha=0.1)),
                port["params"])


# bench.py's single-chip raster flags (plus --agents): presets.deployable's
# arguments, each a path chip_smoke.py drives
BENCH_ROWS = [
    dict(grid_dtype="bfloat16"), dict(pack8=False),
    dict(exact_endpoints=True), dict(scan_rays=0, pack8=False),
    dict(scan_rays=0, exact_endpoints=True),
    dict(grid_dtype="bfloat16", exact_endpoints=True),
    dict(grid_dtype="bfloat16", scan_rays=0),
    dict(room_kernel=True, exact_endpoints=True),
    dict(room_kernel=True, scan_rays=0),
    dict(room_kernel=True, scan_rays=0, exact_endpoints=True),
    dict(room_kernel=True, grid_dtype="bfloat16")]


@pytest.mark.parametrize("flags", BENCH_ROWS,
                         ids=["-".join(f"{k}={v}" for k, v in r.items())
                              for r in BENCH_ROWS])
def test_bench_flags_preset_is_the_reference_preset(flags):
    """presets.deployable with bench.py's flags equals the JAX config built
    the way bench.py builds it (torch_parity.jax_deployable); at 32,768
    agents with a bf16 grid that is a 23,296^2 grid at 91 rooms per row."""
    cfg_p = presets.deployable(N, device="cpu", **flags)[0]
    assert cfg_p == convert.config_from(jax_deployable(N, **flags)[0])
    if flags == dict(grid_dtype="bfloat16"):
        big = presets.deployable(32768, device="cpu", **flags)[0]
        assert big.grid.size == 23296 and big.grid.lo_dtype == torch.bfloat16
        assert big.engine.merge_every == 16 and big == convert.config_from(
            jax_deployable(32768, **flags)[0])
        assert presets.deployable(32768, device="cpu", room_kernel=True)[
            0].engine.room_tile_per_row == 91


def test_rollout_writes_sum_in_int64():
    """A rollout's per-step int32 writes summed on the host in int64, past
    2^31 (65 steps of 1e8, the 32,768-agent step's order)."""
    m = ps.StepMetrics(*([torch.zeros(65, dtype=torch.int32)]
                         * len(ps.StepMetrics._fields)))
    m = m._replace(writes=torch.full((65,), 10 ** 8, dtype=torch.int32))
    assert ps.rollout_writes(m) == 65 * 10 ** 8


def test_merge_step_parity_window_kernel():
    merge_step_parity(room_kernel=False)


def test_entry_points_default_to_the_card():
    """With no device named, the entry points allocate on `cuda`: on the
    card their tensors lie there, and without one they fail at the first
    allocation (no silent CPU fallback)."""
    calls = (lambda: presets.deployable(8)[2].home_x,
             lambda: ps.make_agent_params(8).home_x,
             lambda: ps.no_faults().agent)
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()


def test_agents_faults_v2v_and_write_counter(rng):
    """engine/sim's small pieces: agent params, the fault mask, V2V stats
    on both sides of the chunking rule, and the (hi, lo) write counter."""
    jp, pp = js.make_agent_params(8, separation=2.0), \
        ps.make_agent_params(8, separation=2.0, device="cpu")
    for f in ps.AgentParams._fields:
        assert_exact(getattr(pp, f), getattr(jp, f), what=f)

    jf = js.FaultSchedule(agent=jnp.asarray([2, 5, -1, -1], jnp.int32),
                          t_start=jnp.asarray([0.0, 1.0, 0.0, 0.0]),
                          t_end=jnp.asarray([2.0, 3.0, 0.0, 0.0]))
    pf = ps.FaultSchedule(*(torch.from_numpy(np.array(x)) for x in jf))
    for tt in (0.0, 1.5, 2.5, 4.0):
        assert_exact(ps.alive_mask(pf, 8, torch.tensor(tt)),
                     js.alive_mask(jf, 8, jnp.float32(tt)))

    txy = rng.uniform(0, 30, (8, 2)).astype(np.float32)
    alive = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    # 16 agents: 2-4 coincident (d2 = 0), 5 and 6 exactly at the range
    # (d2 == r2 counts), and the same with agent 9 at a NaN position (amin
    # propagates NaN into every row: cm 0 everywhere)
    txy16 = rng.uniform(0, 30, (16, 2)).astype(np.float32)
    txy16[3:5] = txy16[2]
    txy16[5], txy16[6] = (10.0, 10.0), (16.0, 18.0)
    nan16 = txy16.copy()
    nan16[9, 0] = np.nan
    live16 = np.ones(16, bool)
    launches = v2v_stats.launches
    for xy, live in ((txy, alive), (txy16, live16), (nan16, live16)):
        for chunk in (1024, 2):              # 2: the chunked path
            ref = js.v2v_stats(jnp.asarray(xy), jnp.asarray(live), 10.0,
                               chunk=chunk)
            got = ps.v2v_stats(torch.from_numpy(xy), torch.from_numpy(live),
                               10.0, chunk=chunk)
            assert_exact(got[0], ref[0])
            assert_exact(got[1], ref[1])
    assert v2v_stats.launches == launches    # the CPU takes the plain path
    assert got[0].abs().sum() == 0
    assert ps.v2v_stats(torch.from_numpy(txy16), torch.from_numpy(live16),
                        10.0)[0][2:5].tolist() == [0, 0, 0]

    tw_j = jnp.zeros((2,), jnp.int32)
    tw_p = torch.zeros((2,), dtype=torch.int32)
    for w in (5, (1 << 30) - 3, 7, (1 << 29)):     # crosses the radix
        tw_j2 = js.writes_accumulate(tw_j, jnp.int32(w))
        tw_p2 = ps.writes_accumulate(tw_p, torch.tensor(w, dtype=torch.int32))
        assert_exact(tw_p2, tw_j2)
        assert int(ps.writes_delta(tw_p2, tw_p)) == w
        tw_j, tw_p = tw_j2, tw_p2
    assert ps.total_writes_value(tw_p) == js.total_writes_value(tw_j) == \
        5 + (1 << 30) - 3 + 7 + (1 << 29)
