"""A tiny copy of the benchmark for the CPU tests: a root in a temporary
directory whose BENCHMARK.json names one test-only cell, `tiny16.sweep`
(16 agents, 8 rooms at 2 to a tile row on a 512^2 float32 grid), with a
test-only configuration, traffic mix and per-layer metric beside copies
of the benchmark's own files."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil

from benchmark.harness import spec

TINY_CELL = "tiny16.sweep"


def make_root(tmp: str, cell_why: str = "test-only cell") -> str:
    """A root under `tmp` holding the benchmark's files and the test-only
    entries; returns its path."""
    root = os.path.join(tmp, "root")
    shutil.copytree(spec.bench_dir(spec.ROOT), os.path.join(root,
                                                            "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_bench()
    src = json.load(open(os.path.join(spec.ROOT, "benchmark", "configs",
                                      "swarm16384.json")))
    src["name"] = "tiny16"
    src["world"].update(n_rooms=8, rooms_per_row=2)
    src["swarm"]["n_agents"] = 16
    src["swarm"]["grid"]["size"] = 512
    src["reduced"] = ["n_agents", "grid"]
    with open(os.path.join(root, "benchmark", "configs", "tiny16.json"),
              "w") as f:
        json.dump(src, f)
    traffic = json.load(open(os.path.join(spec.ROOT, "benchmark", "traffic",
                                          "sweep.json")))
    traffic["trace_steps"] = {k: 3 for k in traffic["trace_steps"]}
    with open(os.path.join(root, "benchmark", "traffic", "tiny_sweep.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "benchmark", "metrics",
                           "tiny_steps_counted.py"), "w") as f:
        f.write('PROBE = "dispatch"\n\n\ndef read(record, ctx):\n'
                '    return float(record["steps"])\n')
    bench["configs"].append({"name": "tiny16", "source": "test",
                             "file": "benchmark/configs/tiny16.json",
                             "reduced": ["n_agents", "grid"],
                             "why": "test"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny16",
                               "traffic": "tiny_sweep", "chips": 1,
                               "why": cell_why})
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + [TINY_CELL]
    bench["per_layer"].append({
        "name": "tiny_steps_counted", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "test", "moves":
        "agent_steps_per_s", "workloads": [TINY_CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_module():
    """benchmark/run.py as a module (it is a script, not a package
    member)."""
    path = os.path.join(spec.bench_dir(spec.ROOT), "run.py")
    sp = importlib.util.spec_from_file_location("benchmark_run", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod
