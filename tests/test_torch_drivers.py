"""The port's headline benchmark (swarm_tpu_torch/bench.py) against
bench.py, on the CPU.

bench.py is read with `ast`: its printed keys are the port's, plus
`device`. Each flag row's configuration equals the JAX config bench.py
builds (`torch_parity.jax_deployable` / `jax_untiled`). One reconciliation
step's evidence is held against bench.py's expression on JAX's step from
one state and one step's noise, on the configuration bench builds for
`--device cpu` (the untiled world and the XLA tier, as `bench.py
--platform cpu`). The CLI runs at 16 agents on the CPU.
"""

import ast
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.engine import sim as js
from swarm_tpu_torch import bench, convert
from swarm_tpu_torch.engine import sim as ps
from tests.test_torch_sim import BENCH_ROWS
from tests.torch_parity import (jax_deployable, jax_step_noise, jax_untiled,
                                step_keys)
from tests.torch_parity import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _dict_keys(node: ast.Dict, prefix=""):
    keys = set()
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant):
            keys.add(prefix + k.value)
            if isinstance(v, ast.Dict):
                keys |= _dict_keys(v, prefix + k.value + ".")
    return keys


def _json_keys(obj, prefix=""):
    keys = set()
    for k, v in obj.items():
        keys.add(prefix + k)
        if k == "detail":
            keys |= _json_keys(v, prefix + k + ".")
    return keys


@pytest.fixture(scope="module")
def bench_cli():
    """`python -m swarm_tpu_torch.bench --device cpu --agents 16 --steps 5
    --chunks 2` (the verify skill's bench smoke): its output lines."""
    out = subprocess.run(
        [sys.executable, "-m", "swarm_tpu_torch.bench", "--device", "cpu",
         "--agents", "16", "--steps", "5", "--chunks", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


def test_bench_cli_prints_one_json_line(bench_cli):
    assert len(bench_cli) == 1
    res = json.loads(bench_cli[0])
    d = res["detail"]
    assert res["vs_baseline"] > 1 and d["delta_ratio_fresh"] > 0.6
    assert d["platform"] == "cpu" and d["steps"] == 10
    assert d["writes_semantics"].startswith("xla-tier")
    assert math.isfinite(d["merge_event_ms"]) and d["merge_event_chunk"] == 16


def test_bench_keys_are_bench_py_keys(bench_cli):
    """Every key of bench.py's printed dict (:288-349, nested `detail`
    too), read with ast, and `device` beside `platform`."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps"]
    assert len(dumps) == 1 and isinstance(dumps[0].args[0], ast.Dict)
    want = _dict_keys(dumps[0].args[0]) | {"detail.device"}
    got = _json_keys(json.loads(bench_cli[0]))
    assert got == want


def _argv(flags: dict):
    argv = []
    for k, v in flags.items():
        opt = "--" + k.replace("_", "-")
        if v is True:
            argv.append(opt)
        elif v is False:
            argv.append("--no-" + k.replace("_", "-"))
        else:
            argv += [opt, str(v)]
    return argv


@pytest.mark.parametrize("flags", [{}] + BENCH_ROWS + [
    dict(beam_groups=8), dict(frontiers=True), dict(merge_every=0)],
    ids=lambda r: "-".join(f"{k}={v}" for k, v in r.items()) or "defaults")
def test_bench_flag_rows_configure_as_bench_py(flags):
    """bench.py's kernel rows (:108-128): `bench.world` of each row's flags
    equals the JAX config bench.py builds."""
    args = bench.parse_args(["--agents", "8"] + _argv(flags))
    cfg, _, _, _, use_pallas = bench.world(args, torch.device("cpu"))
    assert use_pallas
    assert cfg == convert.config_from(jax_deployable(8, **flags)[0])


@pytest.mark.parametrize("argv,kw", [
    (["--raster", "line"], dict(raster_mode="line")),
    (["--no-pallas"], dict(raster_mode="beam")),
    (["--no-pallas", "--grid-dtype", "bfloat16"],
     dict(raster_mode="beam", grid_dtype="bfloat16")),
    (["--device", "cpu", "--scan-rays", "0"],
     dict(raster_mode="beam", scan_rays=0)),
    (["--device", "cpu", "--frontiers"],
     dict(raster_mode="beam", frontiers=True))])
def test_bench_untiled_rows_configure_as_bench_py(argv, kw):
    """bench.py's untiled rows (:105-128 with tiled=use_pallas=False);
    `--device cpu` implies `--no-pallas`, as `--platform cpu` does."""
    args = bench.parse_args(["--agents", "8"] + argv)
    dev = torch.device("cpu")
    if "--device" in argv:
        cfg, _, _, _, use_pallas = bench.configure(args)
        assert args.no_pallas
    else:
        cfg, _, _, _, use_pallas = bench.world(args, dev)
    assert not use_pallas
    assert cfg == convert.config_from(jax_untiled(8, **kw)[0])


N_RATIO = 8
WARM = 2


@functools.lru_cache(maxsize=None)
def _jax_cpu_bench():
    """JAX's jitted step of bench.py's CPU configuration (the untiled world,
    the XLA tier) at 8 agents."""
    cfg_j, walls, params, rooms = jax_untiled(N_RATIO, "beam")
    step = js.make_sim_step(cfg_j, jnp.asarray(walls), params, donate=False,
                            walls_grouped=rooms[0], room_of_agent=rooms[1])
    return cfg_j, params, step


def test_ratio_window_evidence_matches_jax():
    """One reconciliation step's `applied` (bench.step_evidence) from one
    state and one step's noise: equal to bench.py's expression (:184-189)
    on JAX's step within rtol 1e-5, the writes too. The state is the
    port's after WARM steps on the JAX step's own noise; the step is
    bench.run's, `make_sim_step(..., donate=False)`, which keeps the grid
    it is given. A donating step there (the rasters update the grid in
    place) leaves step_evidence a zero change and fails here."""
    cfg_j, params_j, step_j = _jax_cpu_bench()
    args = bench.parse_args(["--device", "cpu", "--agents", str(N_RATIO)])
    cfg, walls, params, rooms, _ = bench.configure(args)
    assert cfg == convert.config_from(cfg_j)
    kw = dict(walls_grouped=rooms[0], room_of_agent=rooms[1])
    st0 = js.sim_init(cfg_j, params_j)
    st_p, key = convert.to_torch(st0, ps.SimState), st0.key
    for _ in range(WARM):
        st_p, _ = ps.sim_step(st_p, jax_step_noise(key, N_RATIO, 181), cfg,
                              walls, params, **kw)
        key = step_keys(key, N_RATIO)[0]
    st_j = jax.tree.map(jnp.asarray,
                        convert.to_numpy_like(st_p, st0)._replace(key=key))

    lo0 = st_j.srv.logodds
    nxt_j, m_j = step_j(st_j)
    d = nxt_j.srv.logodds - lo0
    applied_j = float(jnp.sum(jnp.maximum(-d, 0.0)) /
                      abs(cfg_j.grid.logodds_miss) +
                      jnp.sum(jnp.maximum(d, 0.0)) / cfg_j.grid.logodds_hit)

    noise = jax_step_noise(key, N_RATIO, 181)
    single = ps.make_sim_step(cfg, walls, params, torch.Generator(),
                              donate=False, **kw)
    _, applied, writes = bench.step_evidence(
        lambda s: single(s, noise), convert.to_torch(st_j, ps.SimState),
        cfg.grid)
    assert applied_j > 0
    np.testing.assert_allclose(applied, applied_j, rtol=1e-5)
    np.testing.assert_allclose(writes, int(m_j.writes), rtol=1e-5)
