"""The step's spans on the card (`swarm_tpu_torch/trace.py`): each child
span's device time lies within its parent's, and tracing adds no
device-to-host sync to the step.

Needs an NVIDIA GPU with the CUDA toolkit; skips without one. Imports no
jax, so on a card it runs on its own with
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_trace_cuda.py
"""

import dataclasses
import warnings

import pytest
import torch

N = 64
MERGE_EVERY = 4


def _world(dev):
    from swarm_tpu_torch import presets

    cfg, walls, params, rooms = presets.deployable(N, device=dev)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 merge_every=MERGE_EVERY))
    return cfg, walls, params, rooms


def _steps(world, n, seed=5):
    """(final state, syncs the sync debug mode warned of) over n steps of
    a fresh step closure from the initial state."""
    from swarm_tpu_torch.engine import sim

    cfg, walls, params, rooms = world
    step = sim.make_sim_step(cfg, walls, params,
                             torch.Generator(device=params.home_x.device)
                             .manual_seed(seed),
                             walls_grouped=rooms[0], room_of_agent=rooms[1])
    state = sim.sim_init(cfg, params)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                state, _ = step(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return state, sum("synchroniz" in str(w.message) for w in seen)


@pytest.mark.cuda
def test_spans_nest_on_the_device_and_add_no_sync():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from swarm_tpu_torch import trace

    world = _world(torch.device("cuda"))
    _steps(world, 2 * MERGE_EVERY)                 # builds the kernel
    trace.take()
    with trace.recording():
        _steps(world, 2 * MERGE_EVERY)
    spans = trace.take().spans
    names = {s.name for s in spans}
    assert {"swarm.step", "swarm.merge.match", "swarm.raster.launch",
            "swarm.zones"} <= names
    for s in spans:
        assert s.device_ms is not None and s.device_ms >= 0.0, s
        if s.parent is not None:
            parent = spans[s.parent]
            assert s.device_ms <= parent.device_ms + 0.05, (s, parent)

    _, off = _steps(world, 3)
    with trace.recording():
        _, on = _steps(world, 3)
    trace.take()
    assert on <= off, (on, off)
