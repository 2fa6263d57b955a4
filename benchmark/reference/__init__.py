"""The plain reference of the benchmark's check: frozen copies, in plain
torch, of the modules of swarm_tpu_torch that one step of the deployable
engine runs, so that a later change to the program does not move the
yardstick. The copies are verbatim but for their imports and three
departures: `ops/beam_raster.py` keeps only the window helpers;
`ops/window_raster.py` is the plain version of the window raster kernel
(swarm_tpu_torch/ops/beam_raster_cuda.py's `free_raster_plain`), its
evidence computed in blocks of agents, with the control's lower-precision
store; `slam/closure.py`'s `_ring_put` lets the last row win a shared slot
and logs each ring write for the check. `engine/step.py` is the
deployable path of swarm_tpu_torch/engine/sim.py as one function.
"""
