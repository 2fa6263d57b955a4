"""The readings the check's limits are set from, for one cell over many
seeds in one process: per seed a run as the benchmark makes it (set-up,
warm-up, a window of `--seconds`), then the check with the program and
with the control (`harness/check.control_step`) each held against the
reference. Not part of a benchmark run.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3
        [--seconds 5] [--out chiprun_out/readings.jsonl]

Prints one JSON line a seed: {"seed", "program": {number: reading},
"control": {...}, "steps", "seconds"}; with --out also appends it there.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def main(argv=None):
    import torch

    from benchmark.harness import check, session, spec, world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = torch.device(args.device)
    sides = world.build(cell, dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        program = session.make_program(
            sides, torch.Generator(device=dev).manual_seed(seed))
        state = program.sim.sim_init(program.cfg, program.params)
        state, _ = session.warm_up(program, state,
                                   session.warmup_steps(sides.reference_cfg))
        state, win = session.run_window(program, state, args.seconds, dev)
        got = check.run_check(program, state, sides, seed, cell.check, dev,
                              against=("program", "control"))
        del state
        rec = {"seed": seed, "workload": args.workload, **got,
               "steps": win.steps, "seconds": time.perf_counter() - t0}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
