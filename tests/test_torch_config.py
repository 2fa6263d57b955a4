"""The port's own config tree (swarm_tpu_torch/config.py) against the JAX
package's (swarm_tpu/config.py): the same dataclasses with the same field
names, order and defaults, recursively; `replace`; `GridConfig.lo_dtype`
as a torch dtype; and `convert.config_from` carrying any JAX config across
field by field."""

import dataclasses

import jax.numpy as jnp
import torch

from swarm_tpu import config as jc
from swarm_tpu_torch import config as pc
from swarm_tpu_torch import convert
from tests.torch_parity import jax_deployable
from tests.torch_parity import torch_one_thread  # noqa: F401

CLASSES = ("GridConfig", "SensorConfig", "NavConfig", "NoiseConfig",
           "EkfConfig", "SlamConfig", "CoordConfig", "EngineConfig",
           "SwarmConfig")


def _same_tree(p, j, path="SwarmConfig"):
    assert [f.name for f in dataclasses.fields(p)] == \
        [f.name for f in dataclasses.fields(j)], path
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(a):
            assert type(a).__name__ == type(b).__name__, f"{path}.{f.name}"
            _same_tree(a, b, f"{path}.{f.name}")
        else:
            assert type(a) is type(b) and a == b, (f"{path}.{f.name}", a, b)


def test_fields_and_defaults_match_the_reference():
    for name in CLASSES:
        p, j = getattr(pc, name), getattr(jc, name)
        assert dataclasses.is_dataclass(p) and p.__module__ == pc.__name__
        assert p.__dataclass_params__.frozen
        _same_tree(p(), j(), name)


def test_lo_dtype_and_replace():
    assert pc.GridConfig().lo_dtype == torch.float32
    assert pc.GridConfig(logodds_dtype="bfloat16").lo_dtype == torch.bfloat16
    assert jc.GridConfig().lo_dtype == jnp.float32
    c = pc.SwarmConfig().replace(n_agents=9)
    assert c.n_agents == 9 and isinstance(c, pc.SwarmConfig)


def test_config_from_carries_a_jax_config():
    for room_kernel in (False, True):
        cfg = jax_deployable(8, merge_every=4, room_kernel=room_kernel)[0]
        got = convert.config_from(cfg)
        assert isinstance(got, pc.SwarmConfig)
        assert isinstance(got.slam, pc.SlamConfig)
        _same_tree(got, cfg)
