"""The world, the agents and both sides' configurations of a cell, built
from its configuration file and its traffic mix.

The geometry is the frozen copy in `benchmark/reference/geom/world.py`
(the tiled rooms: one 6 m x 4 m room in each [128, 256]-cell tile of a
grid at 5 cm, `rooms_per_row` rooms to a tile row) and the agents are two
to a room at the reference's home offsets, Bot1 at (0.5, 0.5) m and Bot2
at (5.5, 3.5) m from the room's corner. Every field of the swarm's
configuration is spelled out in the file; the traffic mix then sets the
engine fields it owns. Both sides get the same arrays: the program its
config types (`swarm_tpu_torch.config`), the reference its frozen copies.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import config as ref_config
from benchmark.reference.engine import step as ref_step
from benchmark.reference.geom.world import (TILE_COLS, TILE_ROWS,
                                            make_tiled_rooms, walls_by_group)

_SUB = ("grid", "sensors", "nav", "slam", "coord", "noise", "ekf", "engine")


class World(NamedTuple):
    walls: torch.Tensor          # [S, 4]
    walls_grouped: torch.Tensor  # [G, 4, 4]
    room_of_agent: torch.Tensor  # [N] int32
    params: ref_step.AgentParams


def swarm_fields(config: dict, traffic: dict) -> dict:
    """The configuration's fields with the traffic mix's engine fields set
    over them: {"n_agents": n, "grid": {...}, ...}."""
    fields = {k: dict(v) if isinstance(v, dict) else v
              for k, v in config["swarm"].items()}
    fields["engine"].update(traffic.get("engine", {}))
    return fields


def build_config(module, fields: dict):
    """`module.SwarmConfig` (the program's `swarm_tpu_torch.config` or the
    reference's copy) with every field of `fields`. Lists become tuples,
    as the dataclasses declare them."""
    classes = {f.name: f.default_factory for f in
               dataclasses.fields(module.SwarmConfig) if f.name in _SUB}
    sub = {}
    for name in _SUB:
        cls = classes[name]
        known = {f.name for f in dataclasses.fields(cls)}
        given = fields[name]
        if set(given) != known:
            raise ValueError(f"configuration group {name!r}: missing "
                             f"{sorted(known - set(given))}, unknown "
                             f"{sorted(set(given) - known)}")
        sub[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in given.items()})
    return module.SwarmConfig(n_agents=int(fields["n_agents"]), **sub)


def grid_size(n_rooms: int, per_row: int) -> int:
    """The side of the square grid that holds the room tiles, in whole
    256-cell steps."""
    n_rows = -(-n_rooms // per_row)
    size = max(per_row * TILE_COLS, n_rows * TILE_ROWS)
    return -(-size // 256) * 256


def build_world(config: dict, n_agents: int, device) -> World:
    """The tiled-rooms world and its agents on `device`."""
    w = config["world"]
    n_rooms, per_row = int(w["n_rooms"]), int(w["rooms_per_row"])
    if n_agents != 2 * n_rooms:
        raise ValueError(f"{n_agents} agents do not fill {n_rooms} rooms "
                         f"two to a room")
    walls, origins = make_tiled_rooms(n_rooms, per_row=per_row,
                                      room_w=float(w["room_w_m"]),
                                      room_h=float(w["room_h_m"]))
    params = ref_step.make_agent_params(
        n_agents, separation=float(w["separation_m"]), device=device)
    i = np.arange(n_agents)
    room = i // 2
    is_b2 = (i % 2) == 1
    b1, b2 = w["home_bot1_m"], w["home_bot2_m"]
    home_x = origins[room, 0] + np.where(is_b2, b2[0], b1[0])
    home_y = origins[room, 1] + np.where(is_b2, b2[1], b1[1])
    params = params._replace(
        home_x=torch.tensor(home_x, dtype=torch.float32, device=device),
        home_y=torch.tensor(home_y, dtype=torch.float32, device=device),
        x_offset=torch.zeros((n_agents,), dtype=torch.float32,
                             device=device))
    return World(walls=torch.tensor(walls, device=device),
                 walls_grouped=torch.tensor(walls_by_group(walls),
                                            device=device),
                 room_of_agent=torch.tensor(room, dtype=torch.int32,
                                            device=device),
                 params=params)


class Sides(NamedTuple):
    """A cell's two configurations and its world."""
    program_cfg: object
    reference_cfg: ref_config.SwarmConfig
    world: World


def build(cell, device) -> Sides:
    """Both configurations of `cell` (a `spec.Cell`) and its world."""
    from swarm_tpu_torch import config as program_config

    fields = swarm_fields(cell.config, cell.traffic)
    rcfg = build_config(ref_config, fields)
    w = cell.config["world"]
    want = grid_size(int(w["n_rooms"]), int(w["rooms_per_row"]))
    if rcfg.grid.size != want:
        raise ValueError(f"grid.size {rcfg.grid.size} is not the tiled "
                         f"world's {want}")
    return Sides(program_cfg=build_config(program_config, fields),
                 reference_cfg=rcfg,
                 world=build_world(cell.config, rcfg.n_agents, device))


def program_params(params: ref_step.AgentParams):
    """The agents' parameters as the program's type (same tensors)."""
    from swarm_tpu_torch.engine.sim import AgentParams

    return AgentParams(**params._asdict())
