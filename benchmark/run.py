"""The benchmark of swarm_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell, its configuration, its traffic mix, its check and its per-layer
metrics are found by name from BENCHMARK.json (`benchmark/harness/spec`).
Set-up builds the world and the state on the card, the program's step
closure with a generator seeded from `--seed`, and warms up every kind of
step the mix has. Then:
  --trace 0: the measured window (`harness/session.run_window`); the
    cell's end-to-end metrics;
  --trace 1: the traced stretches, one per probe the cell's per-layer
    metrics name (`benchmark/probes/`); the per-layer metrics.
Once the window has closed the peak memory is read and the program's
steps are held against the plain reference (`harness/check`). The last
line of standard output is the result; the line before it the simulated
statistics; the last lines of standard error each number compared with
its limit.

Exits 1 with no result when there is no CUDA card (or fewer than the cell
asks for), and when jax, jaxlib, flax or swarm_tpu is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "swarm_tpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (swarm_tpu_torch is not swarm_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def require_cuda(chips: int):
    """The card the cell needs, or SystemExit(1)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        raise SystemExit(1)
    return torch.device("cuda", 0)


def device_record(dev, peak: int, chips: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": dev.type, "kind": dev.type, "count": chips,
            "memory_peak_bytes": int(peak)}


def run(args, root=ROOT, device=None) -> dict:
    """One run; returns the result's record. `device`: where to run when
    the look for a card is skipped (the CPU tests)."""
    import torch

    from benchmark.harness import check as checkm
    from benchmark.harness import session, spec, world

    cell = spec.load_cell(args.workload, root)
    dev = require_cuda(cell.chips) if device is None else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sides = world.build(cell, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    program = session.make_program(sides, gen)
    state = program.sim.sim_init(program.cfg, program.params)
    state, warm = session.warm_up(program, state,
                                  session.warmup_steps(sides.reference_cfg))
    session.sync(dev)
    setup_s = time.perf_counter() - T_START
    stats = {"warmup": warm.read()}

    metrics, extra = {}, {}
    if args.trace:
        from benchmark.harness import trace

        # the spans probe resets the allocator's peak: read it before
        peak_setup = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0)
        state, metrics, extra = trace.run_traced(cell, program, state,
                                                 sides, dev)
    else:
        state, win = session.run_window(program, state, args.seconds, dev)
        stats["window"] = dict(win.totals.read(), seconds=win.seconds,
                               step_ms_median=percentile(win.step_ms, 50.0),
                               step_ms_mean=sum(win.step_ms) / win.steps)
        values = {
            "agent_steps_per_s": program.cfg.n_agents * win.steps
            / win.seconds,
            "step_ms_p95": percentile(win.step_ms, 95.0),
            "setup_s": setup_s,
        }
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if args.trace:
        peak = max(peak, peak_setup)
    else:
        values["peak_mem_gib"] = peak / 2 ** 30
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    where = {}
    readings = checkm.run_check(program, state, sides, args.seed,
                                cell.check, dev, where=where)["program"]
    del state
    correct, rows = checkm.judge(readings, cell.check["limits"])
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        raise SystemExit(1)
    result = {"correct": bool(correct), "attempted": len(rows),
              "failed": sum(not v <= lim for _, v, lim in rows),
              "metrics": metrics,
              "device": dict(device_record(dev, peak, cell.chips), **extra.get(
                  "device", {}))}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return {"stats": stats, "result": result, "rows": rows,
            "where": where.get("program", {})}


def percentile(xs, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's
    default)."""
    s = sorted(xs)
    if not s:
        return float("nan")
    k = (len(s) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def main(argv=None):
    args = parse_args(argv)
    out = run(args)
    print(json.dumps({"stats": out["stats"]}))
    for name, v, lim in out["rows"]:
        at = f" at {out['where'][name]}" if name in out["where"] else ""
        print(f"check {name}: {v!r} (limit {lim!r}){at}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)


if __name__ == "__main__":
    main()
