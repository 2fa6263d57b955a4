"""The benchmark of swarm_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds 30
        --trace <0|1>

BENCHMARK.json at the repository's root names the cells; `harness/spec`
finds each cell's configuration (`configs/`), traffic mix (`traffic/`),
check (`checks/`) and per-layer metrics (`metrics/`, read from the traced
run's probes in `probes/`) by name. `reference/` is the plain reference
that decides `correct`; `readings.py` reads the program and the control
over many seeds, from which the check's limits are set. The tests
(`tests/`) run on the CPU: `python -m pytest benchmark/tests`; the one
marked `cuda` runs on the card.

Nothing here imports jax or the JAX package, and nothing under
`reference/` imports the program.
"""
