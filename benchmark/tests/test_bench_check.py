"""What decides `correct`, on the tiny cell on the CPU: the program
passes; the control (the reference one precision down) fails; and a run
of the harness with the timed path broken underneath comes out not
correct, once for each fault the cell can have: a step that returns its
state unchanged, half of the swarm left out of the raster, and an answer
altered where it is produced (one agent's V2V distance). The cell runs on
one chip, so no exchange between chips can be left out."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import check, session, spec, world
from benchmark.tests.tiny import TINY_CELL, make_root, run_module


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 2 ** 32 + 77])
def test_program_passes_and_control_fails(root, seed):
    cell = spec.load_cell(TINY_CELL, root)
    dev = torch.device("cpu")
    sides = world.build(cell, dev)
    program = session.make_program(sides,
                                   torch.Generator().manual_seed(seed))
    state = program.sim.sim_init(program.cfg, program.params)
    state, _ = session.warm_up(program, state,
                               session.warmup_steps(sides.reference_cfg))
    state, _ = session.run_window(program, state, 0.3, dev)
    got = check.run_check(program, state, sides, seed, cell.check, dev,
                          against=("program", "control"))
    ok, _ = check.judge(got["program"], cell.check["limits"])
    assert ok, got["program"]
    ok, rows = check.judge(got["control"], cell.check["limits"])
    assert not ok
    # the control moves every number the check compares
    assert all(v > lim for _, v, lim in rows), rows


def _unchanged(sim):
    orig = sim._step_in_place

    def step(state, *a, **k):
        before = check.clone(state)
        _, m = orig(state, *a, **k)
        return before, m
    return "_step_in_place", step


def _half_raster(sim):
    orig = sim._raster_fans

    def raster(logodds, axy, ryaw, dist4, scan_dist, alive, cfg):
        half = alive.clone()
        half[alive.shape[0] // 2:] = False
        return orig(logodds, axy, ryaw, dist4, scan_dist, half, cfg)
    return "_raster_fans", raster


def _v2v_altered(sim):
    orig = sim.v2v_stats

    def v2v(*a, **k):
        cm, cnt = orig(*a, **k)
        cm = cm.clone()
        cm[0] += 1
        return cm, cnt
    return "v2v_stats", v2v


@pytest.mark.parametrize("fault", [_unchanged, _half_raster, _v2v_altered])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    from swarm_tpu_torch.engine import sim

    name, broken = fault(sim)
    monkeypatch.setattr(sim, name, broken)
    run = run_module()
    out = run.run(run.parse_args(["--workload", TINY_CELL, "--seed", "11",
                                  "--seconds", "0.3", "--trace", "0"]),
                  root=root, device="cpu")
    assert out["result"]["correct"] is False
    assert out["result"]["failed"] >= 1
