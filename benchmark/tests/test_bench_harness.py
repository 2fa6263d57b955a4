"""The benchmark's harness on the CPU: every piece found by name, a tiny
cell end to end through the plain rasters, the result line's shape, and
the imports (no jax, no swarm_tpu, and no program in the reference)."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec
from benchmark.tests.tiny import TINY_CELL, make_root, run_module

BENCH = spec.bench_dir(spec.ROOT)


def test_every_piece_is_found_by_name():
    bench = spec.load_bench()
    assert bench["paths"] == ["benchmark"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.check["limits"]) == set(cell.check["numbers"])
        for m in cell.per_layer:
            mod = spec.load_metric(m["name"])
            assert callable(mod.read)
            assert callable(spec.load_probe(mod.PROBE).run)
        names = {m["name"] for m in cell.end_to_end}
        assert names == {"agent_steps_per_s", "step_ms_p95", "peak_mem_gib",
                         "setup_s"}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))


def test_a_test_only_entry_is_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    cell = spec.load_cell(TINY_CELL, root)
    assert cell.config["name"] == "tiny16"
    assert cell.traffic["trace_steps"]["spans"] == 3
    assert "tiny_steps_counted" in {m["name"] for m in cell.per_layer}
    assert spec.load_metric("tiny_steps_counted", root).PROBE == "dispatch"
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", root)


def _result_shape(result: dict, names: set):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    for v in result["checked"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_end_to_end(tmp_path, trace):
    root = make_root(str(tmp_path))
    run = run_module()
    out = run.run(run.parse_args(["--workload", TINY_CELL, "--seed",
                                  str(2 ** 31 + 12345), "--seconds", "0.5",
                                  "--trace", str(trace)]),
                  root=root, device="cpu")
    r = out["result"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == len(spec.load_cell(TINY_CELL, root).check[
        "limits"])
    if trace:
        # off the card only the program's counters read; the device
        # metrics are left out, never written from a CPU run
        _result_shape(r, {"torch_ops_per_step", "tiny_steps_counted"})
        assert r["metrics"]["tiny_steps_counted"]["value"] == 3.0
    else:
        _result_shape(r, {"agent_steps_per_s", "step_ms_p95",
                          "peak_mem_gib", "setup_s"})
        assert out["stats"]["window"]["steps"] >= 1
    assert out["stats"]["warmup"]["steps"] == 32


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "swarm16384.sweep", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=spec.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def _imports(path: str):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


FORBIDDEN = {"jax", "jaxlib", "flax", "swarm_tpu"}


def test_no_source_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_the_reference_imports_nothing_of_the_program():
    for f in glob.glob(os.path.join(BENCH, "reference", "**", "*.py"),
                       recursive=True):
        for name in _imports(f):
            assert name.split(".")[0] != "swarm_tpu_torch", (f, name)


def test_no_loaded_module_is_jax_or_the_jax_package():
    code = (
        "import sys, glob, importlib, os\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark.harness import check, session, spec, trace, world\n"
        "from benchmark.reference.engine import step\n"
        "import swarm_tpu_torch.engine.sim\n"
        "for kind in ('metrics', 'probes'):\n"
        "    for f in sorted(glob.glob(os.path.join(%r, kind, '*.py'))):\n"
        "        spec._load_module(kind, os.path.basename(f)[:-3], %r)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (spec.ROOT, BENCH, spec.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().replace("'", '"')))
    assert not loaded & FORBIDDEN
    assert "swarm_tpu_torch" in loaded


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the window raster kernel runs on "
                    "the card only")
    root = make_root(str(tmp_path))
    run = run_module()
    out = run.run(run.parse_args(["--workload", TINY_CELL, "--seed", "7",
                                  "--seconds", "1", "--trace", "1"]),
                  root=root)
    assert out["result"]["correct"] is True
    assert out["result"]["device"]["platform"] == "gpu"
