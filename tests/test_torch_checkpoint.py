"""Checkpoints (swarm_tpu_torch/engine/checkpoint.py) against the JAX
package's (swarm_tpu/engine/checkpoint.py), on the CPU.

A checkpoint written by one package loads into the other leaf for leaf:
the dual session's `ServerState` both ways, a `SimState` (with a bfloat16
grid, stored as its 16-bit pattern) from JAX into the port. The port
writes the very keys and bytes the JAX package writes for the same state.
The schema migration shims give what the JAX loader gives; strict mode,
a missing leaf and a shape mismatch raise. A port rollout resumed from a
checkpoint (state and noise generator) is bit-exact against the
uninterrupted one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.config import SwarmConfig as JConfig
from swarm_tpu.engine import checkpoint as jck
from swarm_tpu.engine import sim as js
from swarm_tpu.engine.replay import replay_session as j_replay
from swarm_tpu.engine.replay import server_init as j_server_init
from swarm_tpu.proto.csvio import packet_stream_from_telemetry as j_stream
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.config import SwarmConfig
from swarm_tpu_torch.engine import checkpoint as pck
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.engine.replay import replay_session, server_init
from swarm_tpu_torch.proto.csvio import (load_session,
                                         packet_stream_from_telemetry,
                                         write_session)
from swarm_tpu_torch.sim.scenario import generate_dual_session
from tests.torch_parity import jax_deployable
from tests.torch_parity import torch_one_thread  # noqa: F401


def _leaves(tree):
    return [v for _, v in pck._paths(tree)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return pck._to_numpy(x)
    a = np.asarray(x)
    return a.view("V2") if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(a, b):
    ka, kb = [k for k, _ in pck._paths(a)], [k for k, _ in pck._paths(b)]
    assert ka == kb
    for k, x, y in zip(ka, _leaves(a), _leaves(b)):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@functools.lru_cache(maxsize=None)
def _servers(tmp):
    """The dual session replayed by both packages: (JAX ServerState, port
    ServerState)."""
    r = generate_dual_session(42, device="cpu")
    write_session(tmp, r.t, r.agent, r.x, r.y, r.yaw_q, r.encoder, r.v2v,
                  r.dist4, r.landmark)
    sess = load_session(tmp)
    sj, _ = jax.jit(lambda s: j_replay(s, JConfig(n_agents=2)))(
        j_stream(sess))
    sp, _ = replay_session(packet_stream_from_telemetry(sess, device="cpu"),
                           SwarmConfig(n_agents=2))
    return sj, sp


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    return _servers(str(tmp_path_factory.mktemp("sess")))


def test_server_state_both_ways(servers, tmp_path):
    sj, sp = servers
    assert int(sp.closure.cl_count) > 0
    # JAX -> port
    jck.save_pytree(str(tmp_path / "j.npz"), sj)
    got = pck.load_pytree(str(tmp_path / "j.npz"),
                          server_init(SwarmConfig(n_agents=2), device="cpu"))
    _assert_trees_equal(got, convert.to_torch(sj, type(sp)))
    # port -> JAX
    pck.save_pytree(str(tmp_path / "p.npz"), got)
    back = jck.load_pytree(str(tmp_path / "p.npz"),
                           j_server_init(JConfig(n_agents=2)))
    _assert_trees_equal(back, sj)
    # the same keys and bytes in both files
    dj, dp = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert sorted(dj.files) == sorted(dp.files)
    assert ".closure.lm_scan" in dp.files
    for k in dj.files:
        assert dj[k].dtype == dp[k].dtype and \
            dj[k].tobytes() == dp[k].tobytes(), k


def test_bf16_sim_state_from_jax(tmp_path):
    """A JAX SimState with a bfloat16 grid loads into the port's (its
    `.key` unread); the port writes the grid's bytes as JAX does."""
    cfg_j, _, params_j, _ = jax_deployable(8, grid_dtype="bfloat16")
    st_j = js.sim_init(cfg_j, params_j)
    rng = np.random.default_rng(0)
    lo = jnp.asarray(rng.normal(size=st_j.srv.logodds.shape)
                     .astype(np.float32)).astype(jnp.bfloat16)
    st_j = st_j._replace(srv=st_j.srv._replace(logodds=lo),
                         t=jnp.float32(3.5))
    jck.save_pytree(str(tmp_path / "j.npz"), st_j)
    cfg, _, params, _ = presets.deployable(8, device="cpu",
                                           grid_dtype="bfloat16")
    got = pck.load_pytree(str(tmp_path / "j.npz"), ps.sim_init(cfg, params))
    assert got.srv.logodds.dtype == torch.bfloat16
    want = convert.to_torch(st_j, ps.SimState)
    _assert_trees_equal(got, want)
    assert float(got.t) == 3.5
    pck.save_pytree(str(tmp_path / "p.npz"), got)
    dj, dp = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert set(dj.files) - set(dp.files) == {".key"}
    k = ".srv.logodds"
    assert dp[k].dtype == dj[k].dtype == np.dtype("V2")
    assert dp[k].tobytes() == dj[k].tobytes()


def _old_schema(path):
    """Rewrite a checkpoint as the r1-era schema: a scalar float32 write
    counter, no merge_dx/dy/dyaw, no v2v_total, no closure fit."""
    data = dict(np.load(path))
    k_tw = [k for k in data if k.endswith(".srv.total_writes")][0]
    data[k_tw] = np.float32(3.0 * (1 << 30))
    for k in list(data):
        if any(k.endswith(s) for s in (".srv.merge_dx", ".srv.merge_dy",
                                       ".srv.merge_dyaw", ".v2v_total",
                                       ".srv.closure.cl_fit",
                                       ".srv.closure.last_pair_node")):
            del data[k]
    np.savez_compressed(path, **data)


def test_migration_shims_match_jax(tmp_path):
    cfg_j = JConfig(n_agents=2)
    st_j = js.sim_init(cfg_j, js.make_agent_params(2, cfg=cfg_j))
    cfg, _, params, _ = presets.dual_bot(device="cpu")
    st_p = ps.sim_init(cfg, params)
    p = str(tmp_path / "old.npz")
    jck.save_pytree(p, st_j)
    _old_schema(p)
    got_j = jck.load_pytree(p, st_j)
    got_p = pck.load_pytree(p, st_p)
    assert ps.total_writes_value(got_p.srv.total_writes) == 3 * (1 << 30)
    _assert_trees_equal(got_p, convert.to_torch(got_j, ps.SimState))
    assert float(got_p.srv.closure.cl_fit.min()) == -1.0
    with pytest.raises(ValueError):
        jck.load_pytree(p, st_j, migrate=False)
    with pytest.raises(ValueError, match="missing"):
        pck.load_pytree(p, st_p, migrate=False)


def test_mismatches_raise(tmp_path):
    cfg2, _, params2, _ = presets.dual_bot(device="cpu")
    p = str(tmp_path / "ck.npz")
    pck.save_pytree(p, ps.sim_init(cfg2, params2))
    cfg4 = SwarmConfig(n_agents=4)
    st4 = ps.sim_init(cfg4, ps.make_agent_params(4, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        pck.load_pytree(p, st4)
    data = dict(np.load(p))
    data[".srv.grid"] = data[".srv.grid"].astype(np.int16)
    np.savez(p, **data)
    with pytest.raises(ValueError, match="dtype"):
        pck.load_pytree(p, ps.sim_init(cfg2, params2))
    del data[".pose_true"]
    np.savez(p, **data)
    with pytest.raises(ValueError, match="missing"):
        pck.load_pytree(p, ps.sim_init(cfg2, params2))
    with pytest.raises(ValueError, match="generator"):
        pck.load_generator(p, torch.Generator())


def test_resume_is_bit_exact(tmp_path):
    """40 steps straight == 20, checkpoint (state + generator), load into
    a fresh state and generator, 20 more."""
    cfg, walls, params, _ = presets.dual_bot(device="cpu")
    full, _ = ps.sim_rollout(ps.sim_init(cfg, params), 40, cfg, walls,
                             params, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    half, _ = ps.sim_rollout(ps.sim_init(cfg, params), 20, cfg, walls,
                             params, g)
    p = str(tmp_path / "ck.npz")
    pck.save_pytree(p, half, generator=g)
    resumed = pck.load_pytree(p, ps.sim_init(cfg, params))
    g2 = pck.load_generator(p, torch.Generator().manual_seed(123))
    done, _ = ps.sim_rollout(resumed, 20, cfg, walls, params, g2)
    _assert_trees_equal(done, full)
    assert int(done.step) == 40
    assert int((done.srv.grid == cfg.grid.free).sum()) > 500
