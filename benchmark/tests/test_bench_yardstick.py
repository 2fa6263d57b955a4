"""The frozen copies under benchmark/ equal the program at small sizes:
the world geometry against `swarm_tpu_torch.presets.deployable`, the
window arithmetic and the table's bytes against
`swarm_tpu_torch.ops.beam_raster_cuda`, the byte count against
`swarm_tpu_torch.roofline`, and the reference step against the program's
step (one step, bit for bit)."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch

from benchmark.harness import check, roofline, session, spec, world
from benchmark.reference.engine import step as ref
from benchmark.reference.ops import window_raster as wr
from benchmark.reference.ops.beam_raster import BeamSpec, beams_from_scan


def _config(n_agents: int, per_row: int, size: int, name="swarm16384"):
    src = json.load(open(os.path.join(spec.ROOT, "benchmark", "configs",
                                      f"{name}.json")))
    src["world"].update(n_rooms=n_agents // 2, rooms_per_row=per_row)
    src["swarm"]["n_agents"] = n_agents
    src["swarm"]["grid"]["size"] = size
    return src


@pytest.mark.parametrize("n,name", [(16, "swarm16384"), (64, "swarm16384"),
                                    (16, "swarm32768_bf16")])
def test_world_equals_the_presets(n, name):
    from swarm_tpu_torch import presets

    dtype = json.load(open(os.path.join(
        spec.ROOT, "benchmark", "configs",
        f"{name}.json")))["swarm"]["grid"]["logodds_dtype"]
    cfg, walls, params, rooms = presets.deployable(n, device="cpu",
                                                   grid_dtype=dtype)
    per_row = presets.tile_rooms_per_row(n)
    conf = _config(n, per_row, cfg.grid.size, name)
    cell = spec.Cell(name="t", chips=1, config=conf,
                     traffic=json.load(open(os.path.join(
                         spec.ROOT, "benchmark", "traffic", "sweep.json"))),
                     check={}, end_to_end=[], per_layer=[], root=spec.ROOT)
    sides = world.build(cell, torch.device("cpu"))
    assert sides.program_cfg == cfg
    assert dataclasses.asdict(sides.reference_cfg) == dataclasses.asdict(cfg)
    assert torch.equal(sides.world.walls, walls)
    assert torch.equal(sides.world.walls_grouped, rooms[0])
    assert torch.equal(sides.world.room_of_agent, rooms[1])
    for f in params._fields:
        assert torch.equal(getattr(sides.world.params, f),
                           getattr(params, f)), f


def test_published_sizes_fit_their_grids():
    for name, n, size in (("swarm16384", 16384, 16384),
                          ("swarm32768_bf16", 32768, 23296)):
        conf = json.load(open(os.path.join(spec.ROOT, "benchmark",
                                           "configs", f"{name}.json")))
        w = conf["world"]
        assert conf["swarm"]["n_agents"] == n == 2 * w["n_rooms"]
        assert conf["swarm"]["grid"]["size"] == size == world.grid_size(
            w["n_rooms"], w["rooms_per_row"])
        assert conf["reduced"] == []


def test_byte_counts_equal_the_programs():
    from swarm_tpu_torch import roofline as program_roofline
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    for args in ((2, 10, 7, 100), (4, 123456, 2345, 999)):
        assert roofline.needed_bytes(*args) == \
            program_roofline.needed_bytes(*args)
    assert roofline.HBM_BYTES_PER_S == program_roofline.HBM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == program_roofline.FP32_OPS_PER_S
    assert roofline.OPS_PER_CELL == program_roofline.OPS_PER_CELL
    g = torch.Generator().manual_seed(3)
    n = 8
    cfg = _grid(512)
    xy = torch.rand((n, 2), generator=g) * 20 + 2
    yaw = torch.rand((n,), generator=g) * 6.2 - 3.1
    db, tb = beams_from_scan(torch.rand((n, 181), generator=g) * 1.3,
                             1.2, 0.05)
    alive = torch.ones((n,), dtype=torch.bool)
    grid = torch.zeros((512, 512))
    for pack8 in (True, False):
        ours = wr._windows(grid, xy, yaw, db, alive, BeamSpec.scan(181), cfg,
                           tb, 26, pack8)
        theirs = bc._windows(grid, xy, yaw, db, alive, BeamSpec.scan(181),
                             cfg, tb, 26, pack8)
        for f in ("row0", "col0", "t_cl", "t_ch", "ax", "ay", "table"):
            assert torch.equal(getattr(ours, f), getattr(theirs, f)), f
        assert roofline.table_bytes(181, pack8) == \
            theirs.table.shape[1] * 4


def _grid(size):
    from benchmark.reference.config import GridConfig

    return GridConfig(size=size, origin_x=0.0, origin_y=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_raster_equals_the_programs_plain_version(dtype):
    from swarm_tpu_torch.ops import beam_raster_cuda as bc

    g = torch.Generator().manual_seed(5)
    n, cfg = 12, _grid(512)
    xy = torch.rand((n, 2), generator=g) * 6 + 3
    yaw = torch.rand((n,), generator=g) * 6.2 - 3.1
    db, tb = beams_from_scan(torch.rand((n, 181), generator=g) * 1.3,
                             1.2, 0.05)
    alive = torch.rand((n,), generator=g) > 0.2
    lo = (torch.rand((512, 512), generator=g) * 4 - 2).to(getattr(torch,
                                                                 dtype))
    a, ca = wr.window_raster(lo.clone(), xy, yaw, db, alive, tb,
                             BeamSpec.scan(181), cfg, 26)
    b, cb = bc.free_raster_plain(lo.clone(), xy, yaw, db, alive, tb,
                                 BeamSpec.scan(181), cfg, 26)
    assert check.cells_differ(a, b) == 0
    assert torch.equal(ca, cb)


def test_reference_step_equals_the_programs_step(tmp_path):
    from benchmark.tests.tiny import TINY_CELL, make_root

    root = make_root(str(tmp_path))
    cell = spec.load_cell(TINY_CELL, root)
    dev = torch.device("cpu")
    sides = world.build(cell, dev)
    program = session.make_program(sides, torch.Generator().manual_seed(9))
    state = program.sim.sim_init(program.cfg, program.params)
    state, _ = session.warm_up(program, state, 20)
    got = check.run_check(program, state, sides, 9, cell.check, dev,
                          against=("program",))["program"]
    assert all(v == 0 for v in got.values()), got
    w = sides.world
    s0 = ref.sim_init(sides.reference_cfg, w.params)
    p0 = program.sim.sim_init(program.cfg, program.params)
    numbers = check.compare(cell.check["numbers"],
                            (ref.as_reference(p0, ref.SimState), None),
                            (s0, None))
    assert all(v == 0 for v in numbers.values()), numbers
