"""Donation at the engines' boundary: the port's counterpart of
tests/test_donation.py (fused, sharded replicated, tiles).

The reference's `sim_step` and `sim_rollout` are pure, and its builders
take `donate` (`make_sim_step`, `make_sharded_sim_step`): a donated state
may be reused, an undonated one survives the step, and both give the same
result. In the port the donated step runs on the state it is given (the
rasters update its grid in place); every other entry point keeps its
caller's state.

1. `make_sim_step(donate=False)` against `donate=True` and the public
   `sim_step`, from clones of one state, on the same noise, 5 steps at 8
   agents (2 on the parity path): states and StepMetrics bit-identical,
   and each state handed to a `donate=False` step or to `sim_step` equal,
   in every byte, to a clone taken before the call. The window path, the
   room path, a bf16 grid, the XLA tier, the line raster, the parity
   raster and a merge step (merge every 4 steps, the anchor frozen).
2. Two `sim_rollout`s from one state object: bit-identical, and the state
   kept (on a grid the first rollout painted, the second would start from
   that map).
3. The same from one converted JAX state on the JAX step's own noise, both
   rollouts decision-equal to the JAX package's `sim_rollout` (maps: cells
   differing by > 1e-6 in at most 0.01% of the painted cells; integer
   metrics exact, writes rtol 1e-5, poses atol = rtol = 1e-5).
4. The sharded step on one gloo rank, "replicated" and "tiles": (1)'s
   checks between `donate=False` and `donate=True`, and the unsharded
   state handed to `shard_state` kept.
"""

import functools
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from swarm_tpu.engine import sim as js
from swarm_tpu_torch import convert, presets
from swarm_tpu_torch.engine import sim as ps
from swarm_tpu_torch.parallel import mesh, sharded
from tests.torch_parity import (assert_close, assert_exact, decision_equal,
                                jax_deployable, jax_step_noise,
                                pallas_interpret, step_keys)

N = 8
STEPS = 5
MERGE_EVERY = 4


def _leaves(tree, path=""):
    """(path, tensor) of every tensor leaf of a NamedTuple tree."""
    if isinstance(tree, tuple):
        for name, x in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from _leaves(x, f"{path}.{name}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _bytes(x):
    return x.detach().reshape(-1).contiguous().view(torch.uint8)


def _clone(tree):
    """A copy of every tensor of a NamedTuple tree."""
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(x) for x in tree))
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def assert_bits_equal(a, b, what):
    """Two trees equal leaf for leaf in every byte (a -0.0 is not a +0.0,
    a NaN equals only its own bits)."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}{p}"
        assert torch.equal(_bytes(x), _bytes(y)), f"{what}{p} differs"


def _world(case):
    """(cfg, walls, params, rooms) of a case on the CPU."""
    if case == "window":
        return presets.deployable(N, device="cpu")
    if case == "room":
        return presets.deployable(N, device="cpu", room_kernel=True)
    if case == "bf16":
        return presets.deployable(N, device="cpu", grid_dtype="bfloat16")
    if case == "merge":
        return presets.deployable(N, device="cpu", merge_every=MERGE_EVERY)
    if case == "xla":
        return presets.untiled(N, raster_mode="beam", device="cpu")
    if case == "line":
        return presets.untiled(N, raster_mode="line", device="cpu")
    cfg, walls, params, _ = presets.dual_bot(device="cpu")
    return cfg, walls, params, (None, None)


CASES = ["window", "room", "bf16", "xla", "line", "parity", "merge"]


@pytest.mark.parametrize("case", CASES)
def test_undonated_step_is_the_donated_step(case):
    cfg, walls, params, rooms = _world(case)
    n, rays = cfg.n_agents, cfg.engine.scan_rays
    kw = dict(walls_grouped=rooms[0], room_of_agent=rooms[1])
    gen = torch.Generator().manual_seed(5)
    step_d = ps.make_sim_step(cfg, walls, params, gen, donate=True, **kw)
    step_u = ps.make_sim_step(cfg, walls, params, gen, donate=False, **kw)
    st0 = ps.sim_init(cfg, params)
    st_d, st_u, st_s = _clone(st0), _clone(st0), _clone(st0)
    merges = 0
    for k in range(STEPS):
        noise = ps.draw_step_noise(gen, n, rays, "cpu")
        before = _clone(st_u)
        nxt_u, m_u = step_u(st_u, noise)
        assert_bits_equal(st_u, before, f"step {k}: donate=False input")
        before = _clone(st_s)
        nxt_s, m_s = ps.sim_step(st_s, noise, cfg, walls, params, **kw)
        assert_bits_equal(st_s, before, f"step {k}: sim_step input")
        st_d, m_d = step_d(st_d, noise)
        for got, m, what in ((nxt_u, m_u, "donate=False"),
                             (nxt_s, m_s, "sim_step")):
            assert_bits_equal(got, st_d, f"step {k}: {what} state")
            assert_bits_equal(m, m_d, f"step {k}: {what} metrics")
        assert int(m_d.writes) > 0
        merges += int(m_d.merges)
        st_u, st_s = nxt_u, nxt_s
    if case == "merge":
        assert merges > 0 and bool(st_d.srv.anchor.any())
    if case != "parity":
        # the donated step painted the very grid it was given
        assert st_d.srv.logodds.any() and \
            st_u.srv.logodds.data_ptr() != st_d.srv.logodds.data_ptr()


def test_two_rollouts_from_one_state():
    cfg, walls, params, rooms = presets.deployable(
        N, device="cpu", merge_every=MERGE_EVERY)
    st0 = ps.sim_init(cfg, params)
    kept = _clone(st0)
    runs = [ps.sim_rollout(st0, STEPS, cfg, walls, params,
                           torch.Generator().manual_seed(3),
                           walls_grouped=rooms[0], room_of_agent=rooms[1])
            for _ in range(2)]
    assert_bits_equal(st0, kept, "the state passed to sim_rollout")
    assert_bits_equal(runs[0], runs[1], "the second rollout")
    assert int(runs[0][1].merges.sum()) > 0
    assert runs[0][0].srv.logodds.data_ptr() != st0.srv.logodds.data_ptr()


@functools.lru_cache(maxsize=None)
def _jax_rollout():
    """The JAX package's sim_rollout of the deployable preset (merge every
    4 steps), its Pallas raster in interpret mode: (initial state, each
    step's noise as the port takes it, final state, metrics), numpy."""
    cfg, walls, params, rooms = jax_deployable(N, merge_every=MERGE_EVERY)
    st0 = js.sim_init(cfg, params)
    noises, key = [], st0.key
    for _ in range(STEPS):
        noises.append(jax_step_noise(key, N, cfg.engine.scan_rays))
        key = step_keys(key, N)[0]
    with pallas_interpret():
        final, ms = js.sim_rollout(st0, STEPS, cfg, jnp.asarray(walls),
                                   params, walls_grouped=rooms[0],
                                   room_of_agent=rooms[1])
    return (st0, noises, jax.tree.map(np.asarray, final),
            jax.tree.map(np.asarray, ms))


def test_rollouts_from_a_jax_state_match_jax(monkeypatch):
    st0_j, noises, final_j, ms_j = _jax_rollout()
    cfg, walls, params, rooms = presets.deployable(
        N, device="cpu", merge_every=MERGE_EVERY)
    st0 = convert.to_torch(st0_j, ps.SimState)
    kept = _clone(st0)
    runs = []
    for _ in range(2):
        # the port's rollout draws each step's noise through this seam;
        # it hands out the JAX step's own draws, in order
        it = iter(noises)
        monkeypatch.setattr(ps, "draw_step_noise", lambda *a: next(it))
        runs.append(ps.sim_rollout(st0, STEPS, cfg, walls, params,
                                   torch.Generator(),
                                   walls_grouped=rooms[0],
                                   room_of_agent=rooms[1]))
    assert_bits_equal(st0, kept, "the converted JAX state")
    assert_bits_equal(runs[0], runs[1], "the second rollout")
    final, ms = runs[0]
    assert int(ms_j.merges.sum()) > 0
    np.testing.assert_allclose(ms.writes.numpy(), ms_j.writes, rtol=1e-5)
    for f in ("merges", "closures", "online"):
        assert_exact(getattr(ms, f), getattr(ms_j, f), what=f)
    decision_equal(final.srv.logodds, final_j.srv.logodds, "rollout map")
    decision_equal(final.srv.anchor, final_j.srv.anchor, "rollout anchor")
    assert_close(final.pose_true, final_j.pose_true, what="poses")
    assert_exact(final.srv.total_writes, final_j.srv.total_writes)


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group for the module."""
    mesh.init(f"tcp://127.0.0.1:{mesh.free_port()}", 1, 0,
              timedelta(seconds=120), device="cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("grid_sharding", ["replicated", "tiles"])
def test_sharded_undonated_step_is_the_donated_step(group, grid_sharding):
    cfg, walls, params, rooms = presets.deployable(N, device="cpu",
                                                   merge_every=3)
    lay = mesh.make_layout((1, 1), device="cpu")
    gen = torch.Generator().manual_seed(7)
    step_d, step_u = (sharded.make_sharded_sim_step(
        cfg, walls, params, lay, gen, donate=donate,
        grid_sharding=grid_sharding, walls_grouped=rooms[0],
        room_of_agent=rooms[1]) for donate in (True, False))
    st0 = ps.sim_init(cfg, params)
    kept = _clone(st0)
    st_d = sharded.shard_state(st0, lay, grid_sharding)
    st_u = sharded.shard_state(st0, lay, grid_sharding)
    merges = 0
    for k in range(STEPS):
        noise = ps.draw_step_noise(gen, N, cfg.engine.scan_rays, "cpu")
        before = _clone(st_u)
        nxt_u, m_u = step_u(st_u, noise)
        assert_bits_equal(st_u, before, f"step {k}: donate=False input")
        st_d, m_d = step_d(st_d, noise)
        assert_bits_equal(nxt_u, st_d, f"step {k}: state")
        assert_bits_equal(m_u, m_d, f"step {k}: metrics")
        assert int(m_d.writes) > 0
        merges += int(m_d.merges)
        st_u = nxt_u
    assert merges > 0
    assert_bits_equal(st0, kept, "the state handed to shard_state")
