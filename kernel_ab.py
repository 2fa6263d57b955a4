"""Back-to-back timing of the window, room and exact-raster kernels
(csrc/free_raster.cu, csrc/room_raster.cu, csrc/exact_raster.cu) of two or
more checkouts on one CUDA card.

    python3 kernel_ab.py OTHER [OTHER ...] [--rounds 1]

The checkouts (this one, then each OTHER: a directory holding a
`swarm_tpu_torch/` and a `chip_smoke.py`) run in turn, each in a process of
its own, in the order OTHER..., this, this, ...OTHER (reversed in every
second half, `--rounds` times), so that a drift of the card's clock over
the run falls on both sides alike. Each process builds its checkout's
three kernels into that checkout's build directory (once: later
processes of the same checkout find them built) and times the kernel
launch alone on prepared operands, with CUDA events, median of REPS
launches, for

  * pack8-ring at 1024 agents on the 4096^2 float32 grid (bench.py's
    deployable path, `presets.deployable(1024)`),
  * pack8-ring-bf16 at 32,768 agents on the 23,296^2 bfloat16 grid (the
    slice, `presets.deployable(32768, grid_dtype="bfloat16")`),
  * the room kernel's pack16-ring at 1024 agents on the 4096^2 grid
    (bench.py --room-kernel, `presets.deployable(1024, room_kernel=True)`),
    and
  * the exact raster (`exact_raster_cuda.beam_raster`'s kernel) at 1024
    agents on the 4096^2 grid, on the 181-beam scan
    (`presets.deployable(1024)`) and on the wrapped 4-way fan
    (`presets.deployable(1024, scan_rays=0)`), one agent inactive, as
    chip_smoke.py's exact-raster phase,

from the same seed in every checkout (`chip_smoke._raster_inputs`: preset
start poses, random headings, noisy 181-beam or 4-way readings; a
checksum of the inputs is printed so that equal inputs can be seen). Each
form is timed twice: the launch call on prepared operands between two
CUDA events (the wrapper's `_launch`: host work, the window wrapper's
zero-fill and sum, the kernel), and the kernel alone on the device, the
mean of torch.profiler's CUDA kernel times ("<form> (device)"). Prints one
line per process, then the card's name and power limit, then one JSON
object {checkout: {form: [ms per process]}}. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (form name, presets.deployable arguments)
FORMS = (("pack8-ring", dict(n=1024)),
         ("pack8-ring-bf16", dict(n=32768, grid_dtype="bfloat16")),
         ("room pack16-ring", dict(n=1024, room_kernel=True)),
         ("exact scan", dict(n=1024)),
         ("exact wrapped", dict(n=1024, scan_rays=0)))
SEED = 0
REPS = 50
# the kernels' names in a profiler trace
KERNELS = {"window": "free_raster_kernel", "room": "room_raster_kernel",
           "exact": "exact_raster_kernel"}


def _device_ms():
    """`roofline.device_ms` of THIS checkout, loaded from its file: the
    timing instrument stays the same whichever checkout's kernels it
    times (a child imports the other checkout's `swarm_tpu_torch`)."""
    import importlib.util

    path = os.path.join(HERE, "swarm_tpu_torch", "roofline.py")
    spec = importlib.util.spec_from_file_location("_ab_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def child(root: str) -> dict:
    """In this process: build `root`'s kernels and time their forms.
    Returns {form: ms}."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from swarm_tpu_torch import presets
    from swarm_tpu_torch.ops import beam_raster_cuda as bc
    from swarm_tpu_torch.ops import cuda_build
    from swarm_tpu_torch.ops import exact_raster_cuda as er
    from swarm_tpu_torch.ops import room_raster_cuda as rc
    from swarm_tpu_torch.ops.beam_raster import BeamSpec, reach_cells

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    names = ["free_raster", "room_raster", "exact_raster"]
    cuda_build.build_all(names)
    for name in names:
        print(f"  ptxas [{name}]: "
              f"{getattr(cuda_build, 'ptxas', {}).get(name)}", flush=True)
    device_ms = _device_ms()
    out = {}
    for form, kw in FORMS:
        kw = dict(kw)
        cfg, _, params, rooms = presets.deployable(kw.pop("n"), device=dev,
                                                   **kw)
        kind = ("exact" if form.startswith("exact") else
                "room" if cfg.engine.room_tile_per_row > 0 else "window")
        four_way = cfg.engine.scan_rays == 0
        gen = torch.Generator(device=dev).manual_seed(SEED)
        xy, yaw, db, tb = cs._raster_inputs(cfg, params, rooms, gen, dev,
                                            four_way)
        spec = (BeamSpec.four_way() if four_way
                else BeamSpec.scan(cfg.engine.scan_rays))
        reach = reach_cells(cfg)
        n = cfg.n_agents
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        g = torch.zeros((cfg.grid.size,) * 2, device=dev,
                        dtype=cfg.grid.lo_dtype)
        dense = bc._dense_fan(spec, reach)
        if kind == "exact":
            alive[-3] = False
            ln = er._prepare(g, er._windows(g, xy, yaw, db, tb, alive,
                                            cfg.grid))

            def launch():
                er._launch(g, ln, spec, cfg.grid)
        elif kind == "room":
            ln = rc._rooms(g, xy, yaw, db, alive, spec, cfg.grid,
                           cfg.engine.room_tile_per_row, tb, reach,
                           spec.n_beams)

            def launch():
                rc._launch(g, ln, spec, cfg.grid, dense)
        else:
            w = bc._windows(g, xy, yaw, db, alive, spec, cfg.grid, tb, reach,
                            True)
            ln = bc._prepare(g, w, spec)

            def launch():
                bc._launch(g, ln, spec, cfg.grid, dense)
        check = float(xy.double().sum() + db.double().sum())
        launch()
        out[form] = cs._median_ms(launch, REPS)
        out[f"{form} (device)"] = device_ms(launch, REPS, KERNELS[kind])
        print(f"  {form}: {n} agents, inputs checksum {check!r}, launch "
              f"{out[form]:.4f} ms, kernel on the device "
              f"{out[f'{form} (device)']:.4f} ms", flush=True)
        del g, ln, launch
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print("RESULT " + json.dumps(child(args.child)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py: no CUDA card")
    if not args.others:
        raise SystemExit("kernel_ab.py: name at least one other checkout")
    roots = [os.path.abspath(r) for r in args.others]
    half = roots + [HERE]
    order = []
    for _ in range(args.rounds):
        order += half + half[::-1]
    times = {r: {} for r in [HERE] + roots}
    failed = []
    for root in order:
        name = os.path.relpath(root, HERE)
        print(f"{name}:", flush=True)
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            cwd=root, capture_output=True, text=True, timeout=900)
        lines = run.stdout.splitlines()
        print("\n".join(x for x in lines if not x.startswith("RESULT ")),
              flush=True)
        res = [x for x in lines if x.startswith("RESULT ")]
        if run.returncode != 0 or not res:
            print(run.stderr[-3000:], flush=True)
            failed.append(name)
            continue
        for f, ms in json.loads(res[0][len("RESULT "):]).items():
            times[root].setdefault(f, []).append(ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({os.path.relpath(r, HERE): t for r, t in
                      times.items()}))
    if failed:
        raise SystemExit(f"kernel_ab.py: failed in {sorted(set(failed))}")


if __name__ == "__main__":
    main()
