"""The fused engine with scan-matched closures (`closure_scanmatch`)
against the JAX engine, on the CPU, on tools/bench_accuracy.py's
configuration (`presets.accuracy`) at 8 agents.

The raw variant with the rendezvous radius widened to 6.5 m and the pair
cooldown at 16 nodes (two steps), so that the proximity-pair matcher runs
from step 0 between the two agents of every room (5.8 m apart at home):
the sweeps reach the closure ring, the ring stores them with the
landmarks, the pair attempts consume the cooldown. The closure window is
cut to 48 inner cells and a search of 8 (the tool's 128 + 2 x 28 makes
XLA's CPU compile of the JAX step take ~3 minutes; 48 + 2 x 8, ~18 s).
The JAX step runs jitted (compiled once for the module) with its Pallas
raster in interpret mode; both sides consume the JAX step's own noise.

1. The presets equal the tool's configurations (all four variants at 8
   agents; the 64-agent world: 1024^2, 32 rooms at 4 to a row).
2. One-step parity from the JAX state, twice: StepMetrics integers exact,
   floats at 1e-5, every ClosureState leaf (integers exact, floats within
   1e-4), maps decision-equal.
3. An 8-step rollout on each side: the same, step by step, and poses at
   1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swarm_tpu.engine import sim as js
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.engine import sim as ps
from tests.torch_parity import (assert_close, assert_exact, decision_equal,
                                jax_accuracy, jax_step_noise)
from tests.torch_parity import torch_one_thread  # noqa: F401

N = 8
R = 181
WIDE = dict(closure_cross_radius_m=6.5, closure_pair_cooldown=16,
            closure_match_window=48, closure_match_search=8)


@pytest.fixture(scope="module")
def world():
    cfg, walls, params, rooms = jax_accuracy(N, "raw")
    cfg = cfg.replace(slam=dataclasses.replace(cfg.slam, **WIDE))
    step = js.make_sim_step(cfg, jnp.asarray(walls), params, donate=False,
                            walls_grouped=rooms[0], room_of_agent=rooms[1])
    cfg_p, walls_p, params_p, rooms_p = presets.accuracy(N, "raw",
                                                         device="cpu")
    cfg_p = cfg_p.replace(slam=dataclasses.replace(cfg_p.slam, **WIDE))
    assert cfg_p == convert.config_from(cfg)
    return cfg, params, step, (cfg_p, walls_p, params_p, rooms_p)


@pytest.mark.parametrize("variant", presets.ACCURACY_VARIANTS)
def test_accuracy_presets_are_the_tools(variant):
    cfg_p, walls_p, params_p, rooms_p = presets.accuracy(N, variant,
                                                         device="cpu")
    cfg_j, walls, params, rooms = jax_accuracy(N, variant)
    assert cfg_p == convert.config_from(cfg_j)
    assert_exact(walls_p, np.asarray(walls))
    for f in ps.AgentParams._fields:
        assert_exact(getattr(params_p, f), getattr(params, f), what=f)
    assert_exact(rooms_p[0], rooms[0])
    assert_exact(rooms_p[1], rooms[1])
    big = presets.accuracy(64, variant, device="cpu")
    assert big[0].grid.size == 1024 and tuple(big[3][0].shape) == (32, 4, 4)
    assert big[0] == convert.config_from(jax_accuracy(64, variant)[0])
    assert big[0].engine.use_pallas and big[0].engine.raster_4way
    assert not big[0].engine.beam_pack8 and not big[0].engine.kernel_endpoints


def _check(m_p, m_j, st_p, st_j, what):
    for f in ps.StepMetrics._fields:
        a, b = getattr(m_p, f), getattr(m_j, f)
        if a.dtype.is_floating_point:
            assert_close(a, b, what=f"{what} metric {f}")
        else:
            assert_exact(a, b, what=f"{what} metric {f}")
    cl_p, cl_j = st_p.srv.closure, st_j.srv.closure
    for f in cl_p._fields:
        a, b = getattr(cl_p, f), getattr(cl_j, f)
        if a.dtype.is_floating_point:
            assert_close(a, b, rtol=1e-4, atol=1e-4, what=f"{what} {f}")
        else:
            assert_exact(a, b, what=f"{what} {f}")
    decision_equal(st_p.srv.logodds, st_j.srv.logodds, f"{what} map")


def _port_step(st_p, key, port):
    cfg_p, walls_p, params_p, rooms_p = port
    return ps.sim_step(st_p, jax_step_noise(key, N, R), cfg_p, walls_p,
                       params_p, walls_grouped=rooms_p[0],
                       room_of_agent=rooms_p[1])


def test_one_step_parity(world):
    cfg, params, step, port = world
    st_j = js.sim_init(cfg, params)
    assert st_j.srv.closure.lm_scan.shape == (cfg.slam.landmark_capacity, R)
    with pltpu.force_tpu_interpret_mode():
        for k in range(2):
            nxt_p, m_p = _port_step(convert.to_torch(st_j, ps.SimState),
                                    st_j.key, port)
            st_j, m_j = step(st_j)
            _check(m_p, m_j, nxt_p, st_j, f"step {k}")
    assert int((np.asarray(st_j.srv.closure.last_pair_node) >= 0).sum()) == N


def test_eight_step_rollout_parity(world):
    cfg, params, step, port = world
    st_j = js.sim_init(cfg, params)
    st_p = convert.to_torch(st_j, ps.SimState)
    with pltpu.force_tpu_interpret_mode():
        for k in range(8):
            st_p, m_p = _port_step(st_p, st_j.key, port)
            st_j, m_j = step(st_j)
            _check(m_p, m_j, st_p, st_j, f"step {k}")
            assert_close(st_p.pose_true, st_j.pose_true)
    cl = st_p.srv.closure
    assert int(cl.lm_count) > 0
    assert bool((cl.lm_scan[:int(cl.lm_count)] != 0).any())
