"""State and parameter conversion between the JAX package and the port,
through numpy, so that both sides can start from the same numbers.

`to_torch(src, cls, device)` builds the port's NamedTuple `cls` from any
object with the same field names whose leaves numpy can read (JAX arrays,
numpy arrays). `to_numpy_like(port, template)` goes back: it rebuilds
`type(template)` — a JAX NamedTuple — with numpy leaves, taking the fields
the port does not carry (the JAX PRNG key) from `template`. Covers
AgentParams, SimState, MapState, ClosureState, ZoneState, FrameState,
OdomState, EkfState and NavState. `config_from(obj)` rebuilds the port's
`SwarmConfig` from any config tree with the same fields (a JAX-package
config), field by field, without importing it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swarm_tpu_torch import config as pcfg
from swarm_tpu_torch.coord.zones import ZoneState
from swarm_tpu_torch.engine.sim import AgentParams, MapState, SimState
from swarm_tpu_torch.models.ekf import EkfState
from swarm_tpu_torch.models.nav import NavState
from swarm_tpu_torch.models.odometry import OdomState
from swarm_tpu_torch.slam.closure import ClosureState
from swarm_tpu_torch.slam.livemerge import FrameState

# nested NamedTuple fields of the port's state types
_NESTED = {
    SimState: {"odom": OdomState, "ekf": EkfState, "nav": NavState,
               "srv": MapState},
    MapState: {"closure": ClosureState, "zone": ZoneState,
               "frame": FrameState},
}

CONVERTIBLE = (AgentParams, SimState, MapState, ClosureState, ZoneState,
               FrameState, OdomState, EkfState, NavState)


def to_torch(src, cls, device=None):
    """JAX (or numpy) NamedTuple -> the port's NamedTuple `cls`, leaf by
    leaf through numpy (dtype kept)."""
    if cls not in CONVERTIBLE:
        raise TypeError(f"no conversion to {cls.__name__}")
    nested = _NESTED.get(cls, {})
    kw = {}
    for f in cls._fields:
        v = getattr(src, f)
        kw[f] = (to_torch(v, nested[f], device) if f in nested
                 else torch.from_numpy(np.array(v)).to(device))
    return cls(**kw)


def to_numpy_like(port, template):
    """Port NamedTuple -> `type(template)` with numpy leaves. Fields the
    port does not carry come from `template` unchanged."""
    out = {}
    for f in template._fields:
        t = getattr(template, f)
        if not hasattr(port, f):
            out[f] = t
        elif hasattr(t, "_fields"):
            out[f] = to_numpy_like(getattr(port, f), t)
        else:
            out[f] = getattr(port, f).detach().cpu().numpy()
    return type(template)(**out)


def config_from(obj, cls=pcfg.SwarmConfig):
    """The port's config dataclass `cls` (SwarmConfig by default) with every
    field taken from `obj` by name, nested config dataclasses recursively.
    Duck typed: `obj` is any object with those attributes."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        sub = getattr(pcfg, str(f.type), None)   # annotations are strings
        kw[f.name] = config_from(v, sub) if dataclasses.is_dataclass(sub) \
            else v
    return cls(**kw)
