"""The V2V kernel (`csrc/v2v.cu`, `ops/v2v_cuda.py`) against its plain
torch version, bit for bit: random and world positions at sizes from one
agent to 32,768, dead agents, every agent dead, coincident agents, pairs
exactly at the range (an integral and a non-integral one), an infinite
range, NaN positions; one launch a call and no device-to-host sync; one
launch a step in a traced step's counters.

Needs an NVIDIA GPU with the CUDA toolkit; skips without one. Imports no
jax, so on a card it runs on its own with
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_v2v_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

SIZES = (1, 2, 3, 8, 1000, 2049, 16384, 32768)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _random(n, seed, dead_share=0.0):
    rng = np.random.default_rng(seed)
    side = max(20.0, 3.0 * np.sqrt(n))        # ~10 neighbours in 10 m
    txy = rng.uniform(0.0, side, (n, 2)).astype(np.float32)
    alive = rng.uniform(size=n) >= dead_share
    return torch.from_numpy(txy), torch.from_numpy(alive)


def _world(n, dev):
    """The deployable world's home positions (two agents a room: an odd n
    takes the first n of n + 1)."""
    from swarm_tpu_torch import presets

    _, _, params, _ = presets.deployable(n + n % 2, device=dev)
    txy = torch.stack([params.home_x + params.x_offset, params.home_y], -1)
    return txy[:n].contiguous(), torch.ones((n,), dtype=torch.bool,
                                            device=dev)


def _compare(txy, alive, dev, radio_range_m=10.0):
    """The kernel on the card against the plain version on the card (and
    on the CPU below 4,096 agents), each output bit for bit."""
    from swarm_tpu_torch.ops import v2v_cuda

    txy, alive = txy.to(dev), alive.to(dev)
    got = v2v_cuda.v2v_stats(txy, alive, radio_range_m)
    want = v2v_cuda.v2v_stats_plain(txy, alive, radio_range_m)
    sides = [want]
    if txy.shape[0] < 4096:
        sides.append(v2v_cuda.v2v_stats_plain(txy.cpu(), alive.cpu(),
                                               radio_range_m))
    for ref in sides:
        for g, w, what in zip(got, ref, ("nearest_cm", "in_range")):
            assert g.dtype == w.dtype == torch.int32, what
            diff = (g.cpu() != w.cpu()).sum().item()
            assert diff == 0, (what, txy.shape[0], diff)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_random_positions_with_and_without_dead(n):
    dev = _card()
    for seed, dead in ((n, 0.0), (n + 1, 0.2)):
        _compare(*_random(n, seed, dead), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_world_positions(n):
    dev = _card()
    txy, alive = _world(n, dev)
    _compare(txy, alive, dev)
    alive[::7] = False
    _compare(txy, alive, dev)


@pytest.mark.cuda
def test_every_agent_dead_and_coincident_agents():
    dev = _card()
    txy, alive = _random(3000, 3)
    cm, cnt = _compare(txy, torch.zeros_like(alive), dev)
    assert int(cm.abs().sum()) == 0 and int(cnt.sum()) == 0
    txy[100:140] = txy[99]                    # 41 agents on one point
    txy[2000:2002] = txy[1999]
    cm, cnt = _compare(txy, alive, dev)
    assert int(cm[99:140].abs().sum()) == 0
    assert (cnt[99:140].cpu() >= 40).all()


def _at_range(r: float, n_pairs: int = 600):
    """Pairs (0, y), (r, y) exactly r apart along x, rows 100 m apart."""
    rf = np.float32(r)
    txy = np.zeros((2 * n_pairs, 2), np.float32)
    txy[1::2, 0] = rf
    txy[:, 1] = np.repeat(np.arange(n_pairs, dtype=np.float32) * 100.0, 2)
    return torch.from_numpy(txy), torch.ones((2 * n_pairs,), dtype=torch.bool)


def _rounds_up(r: np.float32) -> bool:
    """fl(r * r) above the exact square: d2 equals r2 as float32 but not
    as double, so the compare's precision decides the count."""
    return float(np.float32(float(r) * float(r))) > float(r) * float(r)


@pytest.mark.cuda
def test_pairs_exactly_at_the_range():
    dev = _card()
    rng = np.random.default_rng(11)
    up = next(r for r in rng.uniform(1.0, 20.0, 1000).astype(np.float32)
              if _rounds_up(r))
    for r in (10.0, 7.0, float(up), float(np.float32(2.5)) + 1e-9):
        txy, alive = _at_range(r)
        _, cnt = _compare(txy, alive, dev, radio_range_m=r)
        if r in (10.0, 7.0, float(up)):
            assert (cnt.cpu() == 1).all(), r  # d2 == r2 counts


@pytest.mark.cuda
def test_an_infinite_range_counts_dead_and_self_pairs():
    dev = _card()
    txy, alive = _random(1500, 5, dead_share=0.3)
    _, cnt = _compare(txy, alive, dev, radio_range_m=float("inf"))
    assert (cnt.cpu() == 1500).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", (8, 2049, 16384))
def test_nan_positions(n):
    dev = _card()
    txy, alive = _random(n, 7)
    txy[n // 2, 0] = float("nan")             # a live agent: every row's
    cm, _ = _compare(txy, alive, dev)         # minimum is NaN, cm 0
    assert int(cm.abs().sum()) == 0
    alive[n // 2] = False                     # dead: masked out
    txy[n // 3, 1] = float("nan")
    alive[n // 3] = False
    cm, _ = _compare(txy, alive, dev)
    if n > 8:
        assert int((cm.cpu() != 0).sum()) > 0


@pytest.mark.cuda
def test_one_launch_a_call_and_no_sync():
    from swarm_tpu_torch.ops import v2v_cuda

    dev = _card()
    txy, alive = (x.to(dev) for x in _random(16384, 9))
    v2v_cuda.v2v_stats(txy, alive)            # builds the kernel
    torch.cuda.synchronize()
    before = v2v_cuda.v2v_stats.launches
    forms = dict(v2v_cuda.v2v_stats.launches_by_form)
    torch.cuda.set_sync_debug_mode("error")
    try:
        v2v_cuda.v2v_stats(txy, alive)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert v2v_cuda.v2v_stats.launches == before + 1
    _, splits = v2v_cuda.split_columns(
        16384, torch.cuda.get_device_properties(dev).multi_processor_count)
    name = v2v_cuda.form_name(splits)
    assert v2v_cuda.v2v_stats.launches_by_form[name] == \
        forms.get(name, 0) + 1


@pytest.mark.cuda
def test_a_traced_step_counts_one_v2v_launch():
    from swarm_tpu_torch import presets, trace
    from swarm_tpu_torch.engine import sim

    dev = _card()
    cfg, walls, params, rooms = presets.deployable(64, device=dev)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, merge_every=4))
    step = sim.make_sim_step(cfg, walls, params,
                             torch.Generator(device=dev).manual_seed(3),
                             walls_grouped=rooms[0], room_of_agent=rooms[1])
    state = sim.sim_init(cfg, params)
    state, _ = step(state)
    trace.take()
    with trace.recording():
        for _ in range(4):
            state, _ = step(state)
    counters = trace.take().counters
    assert len(counters) == 4
    for c in counters.values():
        assert sum(c["launches"]["v2v_stats"].values()) == 1, c
