"""Finding a cell's pieces by name.

`BENCHMARK.json` at the root names the cells, configurations and metrics;
each piece lives in a file of its own that is found by its name:
  benchmark/configs/<config>.json   a configuration (`file` in BENCHMARK.json)
  benchmark/traffic/<traffic>.json  a traffic mix
  benchmark/checks/<check>.json     the limits of a comparison (the mix
                                    names its check)
  benchmark/metrics/<metric>.py     a per-layer metric's reader
  benchmark/probes/<probe>.py       an instrument of the traced run (a
                                    metric names its probe)
so a later change adds a configuration, a mix or a metric as new files
and new entries, and edits none that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration's file, as read
    traffic: dict         # the traffic mix's file, as read
    check: dict           # the comparison's limits, as read
    end_to_end: list      # BENCHMARK.json's end-to-end entries of the cell
    per_layer: list       # BENCHMARK.json's per-layer entries of the cell
    root: str


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str) -> str:
    return os.path.join(root, "benchmark")


def load_bench(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its files read."""
    bench = load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(bench_dir(root), "traffic",
                                      f"{w['traffic']}.json"))
    check = _read_json(os.path.join(bench_dir(root), "checks",
                                    f"{traffic['check']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, check=check,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                root=root)


def _load_module(kind: str, name: str, root: str):
    path = os.path.join(bench_dir(root), kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: str = ROOT):
    """The reader of the per-layer metric `name`
    (benchmark/metrics/<name>.py): its `PROBE` names the instrument it
    reads, `read(record, ctx)` returns its number or None."""
    return _load_module("metrics", name, root)


def load_probe(name: str, root: str = ROOT):
    """The instrument `name` of the traced run
    (benchmark/probes/<name>.py): `run(ctx, state, metrics)` drives steps
    under it and returns (state, record)."""
    return _load_module("probes", name, root)
